"""K7: one token through every layer of a GPT stage for B lanes at once.

The counterpart of `bark_tpu.kernels.decode.decode_step_fused_batched`. On
CUDA tensors the wrapper launches the hand-written kernels of
`csrc/bdecode.cu` through one C call per step: each weight streams once
for all B lanes, every lane decodes at its own slot `n_past[b]` and writes
its K/V row at `[l, b, n_past[b]]` of the flat (L, B, S, D) caches.
Packed-quantized params (a qpack) go to the packed batched kernel
K5-batched (`kernels.qbdecode`) on CUDA tensors. On CPU tensors the plain
version runs, for dense params and qpacks alike: `gpt.decode_step` on
each lane's (L, S, D) view at its own slot, which is what the JAX
package's off-TPU `vmap` computes. A CUDA tensor the kernel
does not take raises a ValueError (head_dim != 64, n_embd % 64, more than
MAX_LANES lanes; for a qpack also scales other than f16/f32, tensors not
16-byte aligned, more than one LM head); there is no other path. Int8
caches (`gpt.init_kv_cache(quant=True, batch=B)`) run K6a as each layer's
attention (`kernels.kv8`).
"""

from __future__ import annotations

import torch

from bark_tpu_torch.kernels import _build, kv8, qbdecode
from bark_tpu_torch.kernels.decode import decode_step_plain
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig

MAX_LANES = 32  # lanes one batched step takes (csrc/bdecode.cu MAX_LANES)

launches = 0  # dense kernel launches through `decode_step_fused_batched`


def _host_ints(v):
    return v.tolist() if torch.is_tensor(v) else [int(x) for x in v]


def decode_step_batched_plain(cfg: GPTConfig, params, tokens, k_cache,
                              v_cache, n_past, lm_window=None):
    """The plain PyTorch version of K7, and of K5-batched for a qpack:
    `decode_step_plain` (K1's and K5's) on each lane's (L, S, D) cache view
    at its own slot; (B, n_out_vocab) f32."""
    return torch.stack([
        decode_step_plain(cfg, params, t, gpt.kv_lane(k_cache, b),
                          gpt.kv_lane(v_cache, b), n, lm_window)
        for b, (t, n) in enumerate(zip(_host_ints(tokens),
                                       _host_ints(n_past)))
    ])


def lane_ints(v, B: int, device, name: str, hi: int):
    """A (B,) int32 tensor on `device` for a kernel to read: a tensor there
    is taken as it is (its values are not checked on the host: the kernels
    turn an out-of-range token or slot into NaN, never into a stray
    write); B Python ints are checked against [0, hi) and uploaded."""
    if torch.is_tensor(v) and v.device == device:
        if v.numel() != B:
            raise ValueError(f"{name}: want {B} values, got {v.numel()}")
        return v.reshape(B).to(torch.int32).contiguous()
    vals = _host_ints(v)
    if len(vals) != B or not all(0 <= x < hi for x in vals):
        raise ValueError(f"{name}: want {B} values in [0, {hi}), got {vals}")
    return _build.device_ints(vals, device)


def decode_step_fused_batched(cfg: GPTConfig, params, tokens, k_cache,
                              v_cache, n_past, *, lm_window=None, out=None):
    """One decode step of B lanes. `tokens` and `n_past` are (B,) int
    tensors on the caches' device (read there by the kernel) or B ints;
    lane b decodes tokens[b] at slot n_past[b] and writes K/V row
    n_past[b] of lane b of every layer of the (L, B, S, D) caches in
    place. Returns the (B, n_out_vocab) f32 logits (into `out` when
    given), zero outside lm_window."""
    global launches
    if gpt.kv_device(k_cache).type == "cpu":
        return decode_step_batched_plain(cfg, params, tokens, k_cache,
                                         v_cache, n_past, lm_window)
    packed = gpt.is_qpack(params)
    w = (_build.stage_qweights if packed else _build.stage_weights)(
        cfg, params)
    B = lane_count(k_cache)
    caches = w.check_cache(k_cache, v_cache, batch=B)
    V, D = cfg.n_out_vocab, cfg.n_embd
    lo, hi = lm_window if lm_window is not None else (0, V)
    if not 0 <= lo <= hi <= V:
        raise ValueError(f"lm_window {lm_window} outside [0, {V}]")
    tok = lane_ints(tokens, B, w.device, "tokens", cfg.n_in_vocab)
    npt = lane_ints(n_past, B, w.device, "n_past", cfg.block_size)
    if out is None:
        out = torch.empty((B, V), dtype=torch.float32, device=w.device)
    if tuple(out.shape) != (B, V):
        raise ValueError(f"out: want ({B}, {V}), got {tuple(out.shape)}")
    _build.f32_on(out, w.device, B * V, "logits")
    args = (
        w.ref, B, tok.data_ptr(), npt.data_ptr(), *caches,
        w.scratch("x", B, D).data_ptr(),
        w.scratch("qkv", B, 3 * D).data_ptr(),
        w.scratch("ctx", B, D).data_ptr(),
        w.scratch("h", B, 4 * D).data_ptr(),
        w.scratch("partial", B << 16, dtype=torch.float32).data_ptr(),
        w.scratch("tickets", 1024, dtype=torch.int32).data_ptr(),
        out.data_ptr(), lo, hi, _build.stream_ptr(w.device),
    )
    if packed:
        qbdecode.decode_step_packed_batched(args, out)
    else:
        _build.check("decode_step_fused_batched",
                     _build.lib().bark_decode_step_batched(*args))
        launches += 1
    kv8.count(caches)
    return out


def lane_count(k_cache) -> int:
    """B of (L, B, S, D) batched caches (dense or int8); raise unless
    1 <= B <= MAX_LANES."""
    t = k_cache["q"] if isinstance(k_cache, dict) else k_cache
    B = t.shape[1] if t.dim() == 4 else 0
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"batched caches: want (L, B, S, D) with 1 <= B <= "
                         f"{MAX_LANES}, got {tuple(t.shape)}")
    return B
