"""K3: K semantic decode steps with full-vocab sampling and the EOS test.

The counterpart of `bark_tpu.kernels.semantic.semantic_chunk_fused`. Each
step samples `argmax(logits/temp + noise[g])` over the full vocab (g =
count0 + j is the step's global index and its noise row), sets the stop
flag `tok == semantic_vocab_size or eos_p >= min_eos_p`, and decodes the
token at `n_past = min(ctx_len + g, block_size - 1)` (the explicit clamp of
`bark_tpu.pipeline.semantic`). Post-stop steps keep decoding; the caller
masks their tokens, exactly as the stepped loop never sees them.

On CUDA tensors a step is two launches: `sample_window` of
`csrc/sample.cu` (`kernels.sample`), which writes the token and flag to
device memory, and K1 (`kernels.decode.decode_step_fused`), which embeds
that token from device memory. Nothing waits on the host inside the
chunk; the caller reads the K flags once. On CPU tensors the plain version
runs (`ops.sampling.sample` + `gpt.decode_step`). A qpack is taken as it
is: its K1 steps are then the packed kernel K5 (`kernels.qdecode`), and
the plain version decodes from the qpack as K5 does. Int8 caches
(`gpt.init_kv_cache(quant=True)`) are taken too: the K1/K5 steps then run
K6a (`kernels.kv8`).
"""

from __future__ import annotations

import torch

from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels.decode import decode_step_fused, decode_step_plain
from bark_tpu_torch.kernels.sample import sample_window
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.ops import sampling

launches = 0  # launches of the chunk kernels through `semantic_chunk_fused`


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
        logits = decode_step_plain(cfg, params, tok, k_cache, v_cache, n_past)
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
    for j in range(K):
        g = count0 + j
        row = None if temp == 0.0 else noise[min(g, noise.shape[0] - 1)]
        sample_window(buf, 0, V, row, temp, toks[j:j + 1], flags[j:j + 1],
                      stop_token=semantic_vocab_size, min_eos_p=min_eos_p)
        decode_step_fused(cfg, params, toks[j:j + 1], k_cache, v_cache,
                          min(ctx_len + g, cfg.block_size - 1), out=buf)
    launches += 1
    return toks, flags, buf
