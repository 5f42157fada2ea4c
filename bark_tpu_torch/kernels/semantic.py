"""K3: K semantic decode steps with full-vocab sampling and the EOS test.

The counterpart of `bark_tpu.kernels.semantic.semantic_chunk_fused`. Each
step samples `argmax(logits/temp + noise[g])` over the full vocab (g =
count0 + j is the step's global index and its noise row), sets the stop
flag `tok == semantic_vocab_size or eos_p >= min_eos_p`, and decodes the
token at `n_past = min(ctx_len + g, block_size - 1)` (the explicit clamp of
`bark_tpu.pipeline.semantic`). Post-stop steps keep decoding; the caller
masks their tokens, exactly as the stepped loop never sees them.

On CUDA tensors the chunk is ONE cooperative launch
(`kernels.decode.decode_steps_fused`, csrc/decode.cu
`decode_steps_kernel`): K1's persistent step in a loop of K steps, each
step's token and stop flag sampled inside the launch from the logits
before it (`chunk_loop`) and written to device memory. Nothing waits on
the host inside the chunk; the caller reads the K flags once. On CPU
tensors the plain version runs (`ops.sampling.sample` +
`gpt.decode_step`). A qpack is taken as it is: the loop then runs K5's
packed read (`kernels.qdecode`), and the plain version decodes from the
qpack as K5 does. Int8 caches (`gpt.init_kv_cache(quant=True)`) are taken
too: each step's attention is then K6a's (`kernels.kv8`).
"""

from __future__ import annotations

import torch

from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.ops import sampling

launches = 0  # chunks launched through `semantic_chunk_fused`


def chunk_loop(cfg: GPTConfig, ctx_len: int, count0: int, temp: float,
               semantic_vocab_size: int, min_eos_p: float):
    """(n_past0, clamp, LoopSample) of a K3 chunk as one step-loop launch:
    step j (global step count0 + j, its noise row) decodes at
    min(ctx_len + count0 + j, block_size - 1) and samples the full vocab
    with the stop flag."""
    return (ctx_len + count0, cfg.block_size - 1,
            kdec.LoopSample(temp=temp, stop_token=semantic_vocab_size,
                            min_eos_p=min_eos_p, noise_row0=count0))


def semantic_chunk_plain(cfg: GPTConfig, params, logits, k_cache, v_cache,
                         ctx_len: int, count0: int, noise, min_eos_p: float,
                         *, K: int, temp: float, semantic_vocab_size: int):
    """The plain PyTorch version of `semantic_chunk_fused`."""
    toks, flags = [], []
    for j in range(K):
        g = count0 + j
        row = None if temp == 0.0 else noise[min(g, noise.shape[0] - 1)]
        tok, eos_p = sampling.sample(logits, temp, row)
        toks.append(tok)
        flags.append((tok == semantic_vocab_size) | (eos_p >= min_eos_p))
        n_past = min(ctx_len + g, cfg.block_size - 1)
        logits = kdec.decode_step_plain(cfg, params, tok, k_cache, v_cache,
                                        n_past)
    return (torch.stack(toks).to(torch.int32),
            torch.stack(flags).to(torch.int32), logits)


def semantic_chunk_fused(cfg: GPTConfig, params, logits, k_cache, v_cache,
                         ctx_len: int, count0: int, noise, min_eos_p: float,
                         *, K: int, temp: float, semantic_vocab_size: int):
    """Run K steps from `logits` (the previous step's or the prefill's).
    `noise` is the stage's (max_steps, n_out_vocab) f32 Gumbel rows (None
    at temp 0). Returns (toks (K,) i32, flags (K,) i32 stop-at-step-j,
    logits (n_out_vocab,) f32 after the last step); the caches are updated
    in place."""
    global launches
    if gpt.kv_device(k_cache).type == "cpu":
        return semantic_chunk_plain(
            cfg, params, logits, k_cache, v_cache, ctx_len, count0, noise,
            min_eos_p, K=K, temp=temp,
            semantic_vocab_size=semantic_vocab_size,
        )
    dev, V = gpt.kv_device(k_cache), cfg.n_out_vocab
    if temp != 0.0 and (noise.dim() != 2 or noise.shape[1] != V):
        raise ValueError(f"noise: want (max_steps, {V}), got {noise.shape}")
    buf = _build.f32_on(logits, dev, V, "logits").clone()
    toks = torch.empty((K,), dtype=torch.int32, device=dev)
    flags = torch.empty((K,), dtype=torch.int32, device=dev)
    n_past0, clamp, sample = chunk_loop(cfg, ctx_len, count0, temp,
                                        semantic_vocab_size, min_eos_p)
    kdec.decode_steps_fused(cfg, params, buf, k_cache, v_cache, n_past0,
                            clamp, K, sample, noise, toks, flags)
    launches += 1
    return toks, flags, buf
