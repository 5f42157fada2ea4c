"""K6: the int8 KV cache (`gpt.init_kv_cache(quant=True)`) on the card.

The counterpart of the JAX package's kv_quant branches of its decode
kernels (`bark_tpu.kernels.decode`: `_quant_qseg`, `_quant_row`,
`_attend_lane(_scr)`, `_stage_kv_rows`), which its prefill leaves to XLA.
Three hand-written kernels, launched inside the C calls of their hosts
when those are given int8 caches:

- K6a (csrc/decode.cu `attend_int8`): each layer's attention of K1 and
  K5 inside their persistent step, and of K7 and K5-batched as
  `attn_decode_i8_kernel`, one launch a layer. It quantizes the fresh K/V
  rows (scale over all D, computed alike by every head's block), writes
  them at slot n_past, quantizes the query per head, scores with integer
  `__dp4a` dots scaled by both scales, and accumulates V dequantized to
  the params dtype.
- K6b, `quant_rows_kernel` (csrc/prefill.cu): in K2 and K8 the QKV
  GEMM's epilogue writes the K/V rows in the params dtype to scratch, and
  K6b quantizes each row into its cache slot, one launch a layer.
- K6c, `attn_prefill_i8_kernel` (csrc/prefill.cu): K2/K8's causal
  attention over the int8 cache.

Their plain versions are their hosts' (`gpt.decode_step` and
`gpt.prefill` on the int8 caches). `launches` counts the C calls that ran
them (each runs K6a, or K6b and K6c, once a layer); the hosts' own counts
go on counting those calls too.

`attn_decode` launches one layer's decode attention alone (K6a, or K1's
dense attention kernel for dense caches) on given qkv rows, beside its
plain version `attn_decode_plain`: both then quantize the same fresh rows
and queries, so they agree bit for bit on the cache and to rounding on
the context. It is there to hold the kernel against its plain version and
to time it; the decode steps never call it, and it counts no launch.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.kernels import _build
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig

launches = 0  # host C calls given int8 caches


def count(caches) -> None:
    """Count one host launch if `caches` (the pointers
    `StageWeights.check_cache` returned for it) are int8."""
    global launches
    if caches[2] is not None:
        launches += 1


def attn_decode_plain(cfg: GPTConfig, qkv, k_cache, v_cache, n_past):
    """The plain version of one layer's decode attention for B lanes, as
    `gpt._block` computes it: lane b's fresh K/V rows (qkv[b]'s second and
    third D-blocks) written at row n_past[b] of its (S, D) layer cache
    (`k_cache[b]`, dense or int8, in place), then its query's attention
    over rows [0, n_past[b]]. Returns the (B, D) context in qkv's dtype."""
    D = cfg.n_embd
    out = []
    for b, n in enumerate(int(n) for n in n_past):
        kc, vc = gpt.kv_view(k_cache, b), gpt.kv_view(v_cache, b)
        row = qkv[b:b + 1]
        gpt._kv_update(kc, row[:, D:2 * D], n)
        gpt._kv_update(vc, row[:, 2 * D:], n)
        mask = (torch.arange(cfg.block_size, device=qkv.device) <= n)[None]
        if isinstance(kc, dict):
            out.append(gpt._attention_int8(cfg, row[:, :D], kc, vc, mask))
        else:
            out.append(gpt._attention(row[:, :D], kc, vc, mask, cfg))
    return torch.cat(out)


def attn_decode(cfg: GPTConfig, qkv, k_cache, v_cache, n_past):
    """One layer's decode attention of B lanes through the kernel the
    decode steps run (csrc/decode.cu `bark_launch_attn_decode_batched`):
    K6a for int8 caches ({"q": (B, S, D) int8, "s": (B, S) f32}), the
    dense kernel for (B, S, D) caches in qkv's dtype. qkv is (B, 3D);
    n_past B ints in [0, S), or a (B,) int tensor on the card (taken as it
    is, as K7 takes it). Writes each lane's fresh row in place and returns
    the (B, D) context; on CPU tensors the plain version."""
    from bark_tpu_torch.kernels.bdecode import lane_ints

    if qkv.device.type == "cpu":
        return attn_decode_plain(cfg, qkv, k_cache, v_cache, n_past)
    B, D, S = qkv.shape[0], cfg.n_embd, cfg.block_size
    if (qkv.shape != (B, 3 * D) or qkv.dtype not in _build.DTYPE_CODES
            or not qkv.is_contiguous() or D // cfg.n_head != 64):
        raise ValueError(f"qkv: want contiguous (B, {3 * D}) float32 or "
                         f"bfloat16 rows with head_dim 64, got "
                         f"{tuple(qkv.shape)} {qkv.dtype} and {cfg}")
    slots = lane_ints(n_past, B, qkv.device, "n_past", S)
    quant = isinstance(k_cache, dict)
    want = ([("q", (B, S, D), torch.int8), ("s", (B, S), torch.float32)]
            if quant else [(None, (B, S, D), qkv.dtype)])
    ptrs = []
    for key, shape, dtype in want:
        for c in (k_cache, v_cache):
            t = c.get(key) if quant and isinstance(c, dict) else c
            if (not torch.is_tensor(t) or tuple(t.shape) != shape
                    or t.dtype != dtype or t.device != qkv.device
                    or not t.is_contiguous()):
                raise ValueError(f"layer cache {key or ''}: want contiguous "
                                 f"{shape} {dtype} on {qkv.device}")
            ptrs.append(t.data_ptr())
    kv = _build.BarkKV(*ptrs, *([None, None] if not quant else []))
    ctx = torch.empty((B, D), dtype=qkv.dtype, device=qkv.device)
    rc = _build.lib().bark_launch_attn_decode_batched(
        _build.DTYPE_CODES[qkv.dtype], qkv.data_ptr(), kv, slots.data_ptr(),
        B, S, D, cfg.n_head, ctx.data_ptr(), _build.stream_ptr(qkv.device))
    _build.check("attn_decode", rc)
    return ctx
