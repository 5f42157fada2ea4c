"""K9: K semantic decode steps of B lanes in lockstep, with full-vocab
sampling and the EOS test.

The counterpart of `bark_tpu.kernels.semantic.semantic_chunk_fused_batched`
(noise rows: `make_gumbel_rows_batched`). Step j of lane b samples
`argmax(logits[b]/temp + noise[b, g])` over the full vocab (g = count0 + j,
the step's global index, clamped to the last noise row), sets the lane's
stop flag `tok == semantic_vocab_size or eos_p >= min_eos_p`, and decodes
the token at the SHARED slot `n_past = min(ctx_len + g, block_size - 1)`:
semantic prompts are all 257 rows, and a running lane's count equals g.
Lanes that have stopped keep decoding (their rewrites of their own cache
rows are never read); the caller freezes their tokens and count, exactly
as the JAX package's batched loop does.

On CUDA tensors the chunk is ONE cooperative launch
(`kernels.bdecode.decode_lane_steps`, csrc/bloop.cuh
`lane_steps_kernel`): K7's persistent step in a loop of K steps, each
step's tokens and stop flags sampled inside the launch from the logits
before it (`chunk_lane_loop`) and written to device memory, each step at
its row of a (K, B) slot table uploaded once per chunk. Nothing waits on
the host inside the chunk. A qpack runs the loop on K5-batched's packed
read (`kernels.qbdecode`); int8 caches are taken as they are (K6a inside,
`kernels.kv8`). On CPU tensors the plain version runs: K3's plain version
on each lane.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.kernels.bdecode import decode_lane_steps
from bark_tpu_torch.kernels.semantic import semantic_chunk_plain
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig

launches = 0  # chunks run through `semantic_chunk_fused_batched`


def chunk_lane_loop(cfg: GPTConfig, ctx_len: int, count0: int, K: int,
                    temp: float, semantic_vocab_size: int,
                    min_eos_p: float, B: int):
    """(slots, LoopSample) of a K9 chunk of B lanes as one launch of the
    batched step loop: every lane of step j (global step count0 + j, its
    noise row) decodes at the shared slot min(ctx_len + count0 + j,
    block_size - 1) and samples the full vocab with the stop flag."""
    slots = [[min(ctx_len + count0 + j, cfg.block_size - 1)] * B
             for j in range(K)]
    return slots, kdec.LoopSample(temp=temp, stop_token=semantic_vocab_size,
                                  min_eos_p=min_eos_p, noise_row0=count0)


def semantic_chunk_batched_plain(cfg: GPTConfig, params, logits, k_cache,
                                 v_cache, ctx_len: int, count0: int, noise,
                                 min_eos_p: float, *, K: int, temp: float,
                                 semantic_vocab_size: int):
    """The plain PyTorch version of K9: K3's plain version on each lane's
    logits, cache view and noise."""
    outs = [
        semantic_chunk_plain(
            cfg, params, logits[b], gpt.kv_lane(k_cache, b),
            gpt.kv_lane(v_cache, b), ctx_len, count0,
            None if temp == 0.0 else noise[b], min_eos_p, K=K, temp=temp,
            semantic_vocab_size=semantic_vocab_size)
        for b in range(logits.shape[0])
    ]
    return tuple(torch.stack(x) for x in zip(*outs))


def semantic_chunk_fused_batched(cfg: GPTConfig, params, logits, k_cache,
                                 v_cache, ctx_len: int, count0: int, noise,
                                 min_eos_p: float, *, K: int, temp: float,
                                 semantic_vocab_size: int):
    """Run K steps of B lanes from `logits` ((B, n_out_vocab) f32, the
    previous step's or the prefill's). `noise` is (B, max_steps,
    n_out_vocab) f32 Gumbel rows, one (max_steps, V) block per lane (None
    at temp 0). Returns (toks (B, K) i32, flags (B, K) i32
    stop-at-step-j, logits (B, n_out_vocab) f32 after the last step); the
    (L, B, S, D) caches are updated in place."""
    global launches
    if gpt.kv_device(k_cache).type == "cpu":
        return semantic_chunk_batched_plain(
            cfg, params, logits, k_cache, v_cache, ctx_len, count0, noise,
            min_eos_p, K=K, temp=temp,
            semantic_vocab_size=semantic_vocab_size,
        )
    dev, V = gpt.kv_device(k_cache), cfg.n_out_vocab
    B = logits.shape[0]
    if logits.dim() != 2 or logits.shape[1] != V:
        raise ValueError(f"logits: want (B, {V}), got {tuple(logits.shape)}")
    if temp != 0.0 and (noise.dim() != 3 or noise.shape[0] != B
                        or noise.shape[2] != V):
        raise ValueError(f"noise: want ({B}, max_steps, {V}), got "
                         f"{tuple(noise.shape)}")
    buf = _build.f32_on(logits, dev, B * V, "logits").clone()
    toks = torch.empty((K, B), dtype=torch.int32, device=dev)
    flags = torch.empty((K, B), dtype=torch.int32, device=dev)
    slots, sample = chunk_lane_loop(cfg, ctx_len, count0, K, temp,
                                    semantic_vocab_size, min_eos_p, B)
    decode_lane_steps(cfg, params, buf, k_cache, v_cache, slots, sample,
                      noise, toks, flags, noise_lane_dim=0)
    launches += 1
    return toks.t(), flags.t(), buf
