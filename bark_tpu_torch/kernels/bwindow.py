"""K10: one sliding window of the coarse stage for B lanes, `sws` steps.

The counterpart of `bark_tpu.kernels.window.coarse_window_fused_batched`.
The lanes share the window schedule: step j samples every lane in the
codebook window `[base, base+cbs)` of its previous logits, base = svs +
cbs when the shared global step `step_idx0 + j` is odd and svs when it is
even, writes the offset-carrying token `base + argmax`, and decodes it at
the lane's own slot `ctx_len[b] + j` with the LM head restricted to
`lm_window`.

On CUDA tensors a step is one `sample_window` launch over the B rows
(`kernels.sample`) and one K7 step (`kernels.bdecode`), whose per-lane
slots are the step's row of a (sws, B) table uploaded once per window; no
host read inside the window. On CPU tensors the plain version runs: K4's
plain version on each lane. Int8 caches are taken as in K9.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels.bdecode import decode_step_fused_batched
from bark_tpu_torch.kernels.sample import sample_window
from bark_tpu_torch.kernels.window import codebook_base, coarse_window_plain
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig

launches = 0  # windows run through `coarse_window_fused_batched`


def coarse_window_batched_plain(cfg: GPTConfig, params, logits0, k_cache,
                                v_cache, ctx_len, step_idx0: int, noise, *,
                                sws: int, temp: float,
                                semantic_vocab_size: int, codebook_size: int,
                                lm_window):
    """The plain PyTorch version of K10: K4's plain version on each lane's
    logits, cache view, context length and noise."""
    return torch.stack([
        coarse_window_plain(
            cfg, params, logits0[b], gpt.kv_lane(k_cache, b),
            gpt.kv_lane(v_cache, b), int(ctx_len[b]), step_idx0,
            None if temp == 0.0 else noise[:, b], sws=sws, temp=temp,
            semantic_vocab_size=semantic_vocab_size,
            codebook_size=codebook_size, lm_window=lm_window)
        for b in range(logits0.shape[0])
    ])


def coarse_window_fused_batched(cfg: GPTConfig, params, logits0, k_cache,
                                v_cache, ctx_len, step_idx0: int, noise, *,
                                sws: int, temp: float,
                                semantic_vocab_size: int, codebook_size: int,
                                lm_window):
    """Run one window of B lanes from the prefill's (B, n_out_vocab)
    `logits0`. `ctx_len` is B ints; `noise` the window's (sws, B,
    codebook_size) f32 Gumbel rows (None at temp 0). Returns the (B, sws)
    i32 offset-carrying tokens; lane b's caches are updated in place at
    rows [ctx_len[b], ctx_len[b] + sws)."""
    global launches
    ctx_len = [int(c) for c in ctx_len]
    if gpt.kv_device(k_cache).type == "cpu":
        return coarse_window_batched_plain(
            cfg, params, logits0, k_cache, v_cache, ctx_len, step_idx0,
            noise, sws=sws, temp=temp,
            semantic_vocab_size=semantic_vocab_size,
            codebook_size=codebook_size, lm_window=lm_window,
        )
    dev, V = gpt.kv_device(k_cache), cfg.n_out_vocab
    svs, cbs = semantic_vocab_size, codebook_size
    B = logits0.shape[0]
    if logits0.dim() != 2 or logits0.shape[1] != V or len(ctx_len) != B:
        raise ValueError(f"logits0: want (B, {V}) and B context lengths, "
                         f"got {tuple(logits0.shape)} and {ctx_len}")
    if (svs + 2 * cbs > V or min(ctx_len) < 0
            or max(ctx_len) + sws > cfg.block_size):
        raise ValueError(
            f"window [{svs}, {svs + 2 * cbs}) or slots up to "
            f"{max(ctx_len) + sws} outside the stage ({V} logits, "
            f"{cfg.block_size} slots)"
        )
    if temp != 0.0 and tuple(noise.shape) != (sws, B, cbs):
        raise ValueError(f"noise: want ({sws}, {B}, {cbs}), got "
                         f"{tuple(noise.shape)}")
    buf = _build.f32_on(logits0, dev, B * V, "logits0").clone()
    toks = torch.empty((sws, B), dtype=torch.int32, device=dev)
    slots = _build.device_ints([[c + j for c in ctx_len] for j in range(sws)],
                               dev)
    for j in range(sws):
        sample_window(buf, codebook_base(step_idx0 + j, svs, cbs), cbs,
                      None if temp == 0.0 else noise[j], temp, toks[j])
        decode_step_fused_batched(cfg, params, toks[j], k_cache, v_cache,
                                  slots[j], lm_window=lm_window, out=buf)
    launches += 1
    return toks.t()
