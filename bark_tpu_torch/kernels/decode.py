"""K1: one token through every layer of a GPT stage, batch 1.

The counterpart of `bark_tpu.kernels.decode.decode_step_fused`. On a CUDA
tensor the wrapper launches the hand-written kernel of `csrc/decode.cu`
(embed, L x [LN-GEMV QKV, attention with the K/V row written in place,
GEMV proj + residual, LN-GEMV fc + GELU, GEMV out + residual], ln_f + LM
head) through one C call; on a CPU tensor it runs the plain version, the
reference `models.gpt.decode_step`. There is no other path: a CUDA tensor
the kernel does not take raises. Packed-quantized params (a qpack) go to
the packed kernel K5 (`kernels.qdecode`) on CUDA tensors, and to the same
reference on CPU tensors, which then computes what K5 computes.

`lm_window=(lo, hi)`: only those logit columns are computed, the rest are
0 (the coarse sampler reads only its two codebook windows).

The caches may be the int8 caches of `gpt.init_kv_cache(quant=True)`: the
same C call then runs K6a (csrc/decode.cu `attn_decode_i8_kernel`) as
each layer's attention, in K1 and in K5 alike.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.kernels import _build, kv8, qdecode
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig

launches = 0  # kernel launches through `decode_step_fused`


def window_logits(logits, lm_window):
    """Zero the logits outside [lo, hi) (no-op for lm_window None)."""
    if lm_window is None:
        return logits
    lo, hi = lm_window
    out = torch.zeros_like(logits)
    out[lo:hi] = logits[lo:hi]
    return out


def decode_step_plain(cfg: GPTConfig, params, token, k_cache, v_cache,
                      n_past: int, lm_window=None):
    """The plain PyTorch version of K1, and of K5 for a qpack:
    `gpt.decode_step` (caches updated in place at row n_past), logits
    zeroed outside lm_window."""
    logits = gpt.decode_step(cfg, params, token, k_cache, v_cache, n_past)
    return window_logits(logits, lm_window)


def _token_on(token, device):
    """A 1-element int32 device tensor holding the token (kept on the
    device so a sampled token never round-trips through the host)."""
    if not torch.is_tensor(token):
        return torch.tensor([int(token)], dtype=torch.int32, device=device)
    if token.numel() != 1 or token.device != device:
        raise ValueError(
            f"token: want one element on {device}, got {tuple(token.shape)} "
            f"on {token.device}"
        )
    if token.dtype != torch.int32:
        token = token.to(torch.int32)
    return token.reshape(1).contiguous()


def decode_step_fused(cfg: GPTConfig, params, token, k_cache, v_cache,
                      n_past: int, *, lm_window=None, out=None):
    """One decode step: writes K/V row `n_past` of every layer of the
    (L, S, D) caches (dense or int8) in place and returns the
    (n_out_vocab,) f32 logits (into `out` when given). `token` is an int
    or a one-element int tensor; `n_past` a Python int in
    [0, block_size)."""
    global launches
    if gpt.kv_device(k_cache).type == "cpu":
        return decode_step_plain(cfg, params, token, k_cache, v_cache,
                                 n_past, lm_window)
    packed = gpt.is_qpack(params)
    w = (_build.stage_qweights if packed else _build.stage_weights)(
        cfg, params)
    caches = w.check_cache(k_cache, v_cache)
    if not 0 <= n_past < cfg.block_size:
        raise ValueError(f"n_past {n_past} outside [0, {cfg.block_size})")
    V, D = cfg.n_out_vocab, cfg.n_embd
    lo, hi = lm_window if lm_window is not None else (0, V)
    if not 0 <= lo <= hi <= V:
        raise ValueError(f"lm_window {lm_window} outside [0, {V}]")
    tok = _token_on(token, w.device)
    if out is None:
        out = torch.empty((V,), dtype=torch.float32, device=w.device)
    _build.f32_on(out, w.device, V, "logits")
    args = (
        w.ref, tok.data_ptr(), n_past, *caches, w.scratch("x", D).data_ptr(),
        w.scratch("qkv", 3 * D).data_ptr(), w.scratch("ctx", D).data_ptr(),
        w.scratch("h", 4 * D).data_ptr(),
        w.scratch("partial", 1 << 16, dtype=torch.float32).data_ptr(),
        w.scratch("tickets", 1024, dtype=torch.int32).data_ptr(),
        out.data_ptr(), lo, hi, _build.stream_ptr(w.device),
    )
    if packed:
        qdecode.decode_step_packed(args, out)
    else:
        rc = _build.lib().bark_decode_step(*args)
        _build.check("decode_step_fused", rc)
        launches += 1
    kv8.count(caches)
    return out
