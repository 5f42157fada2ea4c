"""Fine stage: non-causal block refinement of the coarse codes.

The counterpart of `bark_tpu.pipeline.fine` (bark_eval_fine_encoder,
bark.cpp:1961-2059, with suno's in-place fill): channels
n_coarse..n_fine-1 start at the pad id codebook_size, the sequence is
right-padded to >= one block, and blocks of block_size positions with a
block_size/2 hop are refined codebook by codebook (one full non-causal
forward per codebook, every position sampled at fine_temp from its first
codebook_size logits, positions before the block's fill start kept).

A voice preset's fine history (`pipeline.voice.fine_history`, up to 512
frames) prepends the input and conditions the first block(s); the fill
schedule skips it (start_fill_idx = n_hist + n*hop) and the result is
shifted past it (suno's generate_fine). The stage program loops the
blocks on the device; the stepped path is the same program with a
`progress_cb`, called after every block with the JAX package's
percentage (`bark_tpu.pipeline.fine.generate_fine`).

Plain PyTorch: the JAX package has no Pallas kernel in this stage. A qpack
is densified once per stage call (bit-equal to dequantize-at-load), so the
forwards are exactly the dense ones; a batch densifies once and passes
the dense copy to every lane's call (`BarkContext._generate_batch`).
"""

from __future__ import annotations

import torch

from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.ops import sampling
from bark_tpu_torch.params import BarkContextParams
from bark_tpu_torch.pipeline.forward import KERNELS


def fine_schedule(n_frames: int, block: int):
    """(padded_len, n_loops) of the block schedule (bark.cpp:1983-1996)."""
    padded_len = max(n_frames, block)
    hop = block // 2
    return padded_len, max(0, -(-(padded_len - block) // hop)) + 1


def make_fine_block_program(cfg: GPTConfig, bparams: BarkContextParams,
                            forward=KERNELS):
    """fn(params (dense), buf (block, n_fine) int tensor, rel_start, noise
    (n_fine - n_coarse, block, codebook_size) f32 or None at fine_temp 0)
    -> the refined block: codebook by codebook, every position sampled and
    the positions from rel_start on kept (`bark_tpu.pipeline.fine.
    make_fine_block_program`). Each forward is `forward.fine`
    (`pipeline.forward`; `gpt.fine_forward` by default)."""
    block = cfg.block_size
    n_coarse, n_fine = bparams.n_coarse_codebooks, bparams.n_fine_codebooks
    cbs, fine_temp = bparams.codebook_size, bparams.fine_temp

    def run(params, buf, rel_start: int, noise):
        keep = torch.arange(block, device=buf.device) >= rel_start
        buf = buf.clone()
        for i, nn in enumerate(range(n_coarse, n_fine)):
            logits = forward.fine(cfg, params, buf, nn)
            toks = sampling.sample_rows(
                logits[:, :cbs], fine_temp,
                None if fine_temp == 0.0 else noise[i],
            )
            buf[:, nn] = torch.where(keep, toks.to(torch.int32), buf[:, nn])
        return buf

    return run


def make_fine_stage_program(cfg: GPTConfig, bparams: BarkContextParams,
                            forward=KERNELS):
    """fn(params, codes (>= n_frames, n_coarse) int tensor, n_frames,
    noise (n_loops, n_fine - n_coarse, block_size, codebook_size) f32 or
    None at fine_temp 0, fine_hist=None: (n_hist <= 512, n_fine) history
    rows, progress_cb=None) -> (padded_len - n_hist, n_fine) int32; rows
    [:n_frames] are the result. n_loops is `fine_schedule(n_hist +
    n_frames, block)`'s. `progress_cb(percent)` is called after each block
    is queued, with the share of the blocks done. `forward`: as for
    `make_fine_block_program`; its `weights` makes the dense copy."""
    block = cfg.block_size
    hop = block // 2
    n_coarse, n_fine = bparams.n_coarse_codebooks, bparams.n_fine_codebooks
    refine = make_fine_block_program(cfg, bparams, forward)

    def run(params, codes, n_frames: int, noise, fine_hist=None,
            progress_cb=None):
        params = forward.weights(cfg, params)[0]
        device = params["wpe"].device
        n_hist = 0 if fine_hist is None else int(fine_hist.shape[0])
        padded_len, n_loops = fine_schedule(n_hist + n_frames, block)
        in_arr = torch.full((padded_len, n_fine), bparams.codebook_size,
                            dtype=torch.int32, device=device)
        if n_hist:
            in_arr[:n_hist] = torch.as_tensor(fine_hist, device=device)
        in_arr[n_hist:n_hist + n_frames, :n_coarse] = \
            codes[:n_frames].to(device)
        for n in range(n_loops):
            start = min(n * hop, padded_len - block)
            fill = min(n_hist + n * hop, padded_len - hop)
            # rows before the fill and the coarse columns come back as they
            # went in, so the whole block is written back
            in_arr[start:start + block] = refine(
                params, in_arr[start:start + block], fill - start,
                None if noise is None else noise[n])
            if progress_cb is not None:
                progress_cb(100 * (n + 1) // n_loops)
        return in_arr[n_hist:]

    return run
