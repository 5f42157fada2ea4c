"""K4: one sliding window of the coarse stage, `sws` decode steps.

The counterpart of `bark_tpu.kernels.window.coarse_window_fused`. Step j
samples `argmax(rel/temp + noise[j])` in the codebook window
`[base, base+cbs)` of the previous logits, where base = svs + cbs when the
global step `step_idx0 + j` is odd and svs when it is even, writes the
offset-carrying token `base + argmax`, and decodes it at slot
`ctx_len + j` with the LM head restricted to `lm_window`.

On CUDA tensors the window is ONE cooperative launch of K1's step in a
loop (`kernels.decode.decode_steps_fused`, csrc/decode.cu
`decode_steps_kernel`), each step sampling its codebook window inside the
launch (`window_loop`), with no host read inside the window; on CPU
tensors the plain version runs (`ops.sampling.sample` +
`gpt.decode_step`). A qpack is taken as it is, as in K3: the loop then
runs K5's packed read. Int8 caches are taken as in K3.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.ops import sampling

launches = 0  # windows launched through `coarse_window_fused`


def codebook_base(step: int, svs: int, cbs: int) -> int:
    """The first logit of global step `step`'s codebook window."""
    return svs + (0 if step % 2 == 0 else cbs)


def window_loop(cfg: GPTConfig, ctx_len: int, step_idx0: int, temp: float,
                semantic_vocab_size: int, codebook_size: int):
    """(n_past0, clamp, LoopSample) of a K4 window as one step-loop launch:
    step j decodes at ctx_len + j and samples the codebook window of
    global step step_idx0 + j with noise row j."""
    return (ctx_len, cfg.block_size - 1, kdec.LoopSample(
        temp=temp, codebook=(semantic_vocab_size, codebook_size, step_idx0)))


def coarse_window_plain(cfg: GPTConfig, params, logits0, k_cache, v_cache,
                        ctx_len: int, step_idx0: int, noise, *, sws: int,
                        temp: float, semantic_vocab_size: int,
                        codebook_size: int, lm_window):
    """The plain PyTorch version of `coarse_window_fused`."""
    svs, cbs = semantic_vocab_size, codebook_size
    logits, toks = logits0, []
    for j in range(sws):
        base = codebook_base(step_idx0 + j, svs, cbs)
        rel_tok, _ = sampling.sample(
            logits[base:base + cbs], temp, None if temp == 0.0 else noise[j]
        )
        tok = base + rel_tok
        toks.append(tok)
        logits = kdec.decode_step_plain(cfg, params, tok, k_cache, v_cache,
                                        ctx_len + j, lm_window)
    return torch.stack(toks).to(torch.int32)


def coarse_window_fused(cfg: GPTConfig, params, logits0, k_cache, v_cache,
                        ctx_len: int, step_idx0: int, noise, *, sws: int,
                        temp: float, semantic_vocab_size: int,
                        codebook_size: int, lm_window):
    """Run one window from the prefill's `logits0`. `noise` is the
    window's (sws, codebook_size) f32 Gumbel rows (None at temp 0).
    Returns the (sws,) i32 offset-carrying tokens; the caches are updated
    in place at rows [ctx_len, ctx_len + sws)."""
    global launches
    if gpt.kv_device(k_cache).type == "cpu":
        return coarse_window_plain(
            cfg, params, logits0, k_cache, v_cache, ctx_len, step_idx0,
            noise, sws=sws, temp=temp,
            semantic_vocab_size=semantic_vocab_size,
            codebook_size=codebook_size, lm_window=lm_window,
        )
    dev, V = gpt.kv_device(k_cache), cfg.n_out_vocab
    svs, cbs = semantic_vocab_size, codebook_size
    if svs + 2 * cbs > V or ctx_len + sws > cfg.block_size:
        raise ValueError(
            f"window [{svs}, {svs + 2 * cbs}) or slots up to "
            f"{ctx_len + sws} outside the stage ({V} logits, "
            f"{cfg.block_size} slots)"
        )
    if temp != 0.0 and tuple(noise.shape) != (sws, cbs):
        raise ValueError(f"noise: want ({sws}, {cbs}), got {noise.shape}")
    buf = _build.f32_on(logits0, dev, V, "logits0").clone()
    toks = torch.empty((sws,), dtype=torch.int32, device=dev)
    n_past0, clamp, sample = window_loop(cfg, ctx_len, step_idx0, temp, svs,
                                         cbs)
    kdec.decode_steps_fused(cfg, params, buf, k_cache, v_cache, n_past0,
                            clamp, sws, sample, noise, toks,
                            lm_window=lm_window)
    launches += 1
    return toks
