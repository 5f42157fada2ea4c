"""Fine stage: non-causal block refinement of the coarse codes.

The counterpart of `bark_tpu.pipeline.fine.make_fine_stage_program`
(bark_eval_fine_encoder, bark.cpp:1961-2059, with suno's in-place fill),
for the empty voice history of the reference: channels n_coarse..n_fine-1
start at the pad id codebook_size, the sequence is right-padded to >= one
block, and blocks of block_size positions with a block_size/2 hop are
refined codebook by codebook (one full non-causal forward per codebook,
every position sampled at fine_temp from its first codebook_size logits,
positions before the block's fill start kept).

Plain PyTorch: the JAX package has no Pallas kernel in this stage. A qpack
is densified once per stage call (bit-equal to dequantize-at-load), so the
forwards are exactly the dense ones; a batch densifies once and passes
the dense copy to every lane's call (`BarkContext._generate_batch`).
"""

from __future__ import annotations

import torch

from bark_tpu_torch.io import loader
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.ops import sampling
from bark_tpu_torch.params import BarkContextParams


def fine_schedule(n_frames: int, block: int):
    """(padded_len, n_loops) of the block schedule (bark.cpp:1983-1996)."""
    padded_len = max(n_frames, block)
    hop = block // 2
    return padded_len, max(0, -(-(padded_len - block) // hop)) + 1


def make_fine_stage_program(cfg: GPTConfig, bparams: BarkContextParams):
    """fn(params, codes (>= n_frames, n_coarse) int tensor, n_frames,
    noise (n_loops, n_fine - n_coarse, block_size, codebook_size) f32 or
    None at fine_temp 0) -> (padded_len, n_fine) int32; rows [:n_frames]
    are the result."""
    block = cfg.block_size
    hop = block // 2
    n_coarse, n_fine = bparams.n_coarse_codebooks, bparams.n_fine_codebooks
    cbs, fine_temp = bparams.codebook_size, bparams.fine_temp

    def run(params, codes, n_frames: int, noise):
        params = loader.densify(cfg, params)
        device = params["wpe"].device
        padded_len, n_loops = fine_schedule(n_frames, block)
        in_arr = torch.full((padded_len, n_fine), cbs, dtype=torch.int32,
                            device=device)
        in_arr[:n_frames, :n_coarse] = codes[:n_frames].to(device)
        rows = torch.arange(block, device=device)
        for n in range(n_loops):
            start = min(n * hop, padded_len - block)
            fill = min(n * hop, padded_len - hop)
            keep = rows >= fill - start
            buf = in_arr[start:start + block].clone()
            for i, nn in enumerate(range(n_coarse, n_fine)):
                logits = gpt.fine_forward(cfg, params, buf, nn)
                toks = sampling.sample_rows(
                    logits[:, :cbs], fine_temp,
                    None if fine_temp == 0.0 else noise[n, i],
                )
                buf[:, nn] = torch.where(keep, toks.to(torch.int32),
                                         buf[:, nn])
            in_arr[start:start + block] = buf
        return in_arr

    return run
