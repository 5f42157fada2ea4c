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

Plain PyTorch: the JAX package has no Pallas kernel in this stage. The
stage program takes a list of lanes, the counterpart of the JAX package's
`jax.vmap` of its stage program: each block's forwards run once for every
lane still refining, each lane with its own schedule, keep mask and
noise; a single request, the stream and warmup are lists of one lane. A
qpack is densified once per stage call (bit-equal to dequantize-at-load),
so the forwards are exactly the dense ones.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.kernels import _build
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
    """fn(params (dense), buf (B, block, n_fine) int tensor, rel_start (B
    ints), noise (B tensors, or a (B, ...) tensor, of (n_fine - n_coarse,
    block, codebook_size) f32; None at fine_temp 0)) -> the B refined
    blocks: codebook by codebook, every position sampled and the
    positions from a lane's rel_start on kept
    (`bark_tpu.pipeline.fine.make_fine_block_program`), each lane as
    alone, with its own keep mask and noise; each codebook is one forward
    of every lane, `forward.fine` (`pipeline.forward`; `gpt.fine_forward`
    by default)."""
    block = cfg.block_size
    n_coarse, n_fine = bparams.n_coarse_codebooks, bparams.n_fine_codebooks
    cbs, fine_temp = bparams.codebook_size, bparams.fine_temp

    def run(params, buf, rel_start, noise):
        keep = (torch.arange(block, device=buf.device)[None, :]
                >= _build.device_ints(rel_start, buf.device)[:, None])
        buf = buf.clone()
        for i, nn in enumerate(range(n_coarse, n_fine)):
            logits = forward.fine(cfg, params, buf, nn)
            toks = sampling.sample_rows(
                logits[..., :cbs], fine_temp,
                None if fine_temp == 0.0 else
                torch.stack([z[i] for z in noise]),
            )
            buf[..., nn] = torch.where(keep, toks.to(torch.int32),
                                       buf[..., nn])
        return buf

    return run


def make_fine_stage_program(cfg: GPTConfig, bparams: BarkContextParams,
                            forward=KERNELS):
    """fn(params, codes, n_frames, noise=None, fine_hist=None,
    progress_cb=None) over B lanes, each argument a list with one entry a
    lane (the JAX package's `jax.vmap` of its stage program): codes (>=
    n_frames, n_coarse) int tensors; n_frames ints; noise (n_loops,
    n_fine - n_coarse, block_size, codebook_size) f32 tensors, or None
    (every lane) at fine_temp 0; fine_hist (n_hist <= 512, n_fine)
    history rows or None. n_loops is `fine_schedule(n_hist + n_frames,
    block)`'s, a lane's own, and so are its block starts and fills.
    Returns a list of (padded_len - n_hist, n_fine) int32, a lane's rows
    [:n_frames] its result. Block n refines, as one batch, the lanes with
    more than n blocks; the others keep their rows, as a finished lane of
    JAX's vmapped while_loop keeps its carry. `progress_cb(percent)` is
    called after each block is queued, with the share of the blocks done.
    `forward`: as for `make_fine_block_program`; its `weights` makes the
    dense copy, once a call."""
    block = cfg.block_size
    hop = block // 2
    n_coarse, n_fine = bparams.n_coarse_codebooks, bparams.n_fine_codebooks
    refine = make_fine_block_program(cfg, bparams, forward)

    def run(params, codes, n_frames, noise=None, fine_hist=None,
            progress_cb=None):
        params = forward.weights(cfg, params)[0]
        device = params["wpe"].device
        B = len(codes)
        lanes = []  # (in_arr, n_hist, padded_len, n_loops) a lane
        for b, fh in enumerate(fine_hist or [None] * B):
            n_hist = 0 if fh is None else int(fh.shape[0])
            padded_len, n_loops = fine_schedule(n_hist + n_frames[b], block)
            in_arr = torch.full((padded_len, n_fine), bparams.codebook_size,
                                dtype=torch.int32, device=device)
            if n_hist:
                in_arr[:n_hist] = torch.as_tensor(fh, device=device)
            in_arr[n_hist:n_hist + n_frames[b], :n_coarse] = \
                codes[b][:n_frames[b]].to(device)
            lanes.append((in_arr, n_hist, padded_len, n_loops))
        n_blocks = max((lane[3] for lane in lanes), default=0)
        for n in range(n_blocks):
            running = [b for b in range(B) if n < lanes[b][3]]
            starts, fills = [], []
            for b in running:
                _, n_hist, padded_len, _ = lanes[b]
                starts.append(min(n * hop, padded_len - block))
                fills.append(min(n_hist + n * hop, padded_len - hop))
            out = refine(
                params,
                torch.stack([lanes[b][0][s:s + block]
                             for b, s in zip(running, starts)]),
                [f - s for f, s in zip(fills, starts)],
                None if bparams.fine_temp == 0.0 else
                [noise[b][n] for b in running])
            # rows before the fill and the coarse columns come back as they
            # went in, so the whole block is written back
            for i, (b, s) in enumerate(zip(running, starts)):
                lanes[b][0][s:s + block] = out[i]
            if progress_cb is not None:
                progress_cb(100 * (n + 1) // n_blocks)
        return [in_arr[n_hist:] for in_arr, n_hist, _, _ in lanes]

    return run
