"""K6: the int8 KV cache (`gpt.init_kv_cache(quant=True)`) on the card.

The counterpart of the JAX package's kv_quant branches of its decode
kernels (`bark_tpu.kernels.decode`: `_quant_qseg`, `_quant_row`,
`_attend_lane(_scr)`, `_stage_kv_rows`), which its prefill leaves to XLA.
Three hand-written kernels, launched inside the C calls of their hosts
when those are given int8 caches:

- K6a (csrc/step.cuh `attend_int8`): each layer's attention of K1 and
  K5 inside their persistent step, and of K7 and K5-batched inside theirs
  (csrc/bdecode.cu, a (head, lane) unit at a time); alone, one launch a
  layer, as `attn_decode_i8_kernel` (csrc/decode.cu, `attn_decode`
  below). It quantizes the fresh K/V rows (scale over all D), writes them
  at slot n_past, quantizes the query per head, scores with integer
  `__dp4a` dots scaled by both scales, and accumulates V dequantized to
  the params dtype.
- K6b, `quant_rows_kernel` (csrc/prefill.cu): in K2 and K8 the QKV
  GEMM's epilogue writes the K/V rows in the params dtype to scratch, and
  K6b quantizes each row into its cache slot, one launch a layer.
- K6c (csrc/prefill.cu): K2/K8's causal attention over the int8 cache;
  in bf16 the prefills' tensor-core attention reading int8 tiles
  (`attn_prefill_tc_kernel<Int8Tiles>`: the query tile quantized per row
  and head, scores by mma m16n8k32 s8, both row scales folded in after
  the exact integer sum, value tiles dequantized to bf16 as they are
  staged), in f32 the scalar `attn_prefill_i8_kernel`.

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
`attn_prefill` does the same for K6c: one layer's prefill attention alone
on given query rows and an int8 cache (one lane, or K8's stacked lanes;
the prefills' dense attention on a dense cache), beside
`attn_prefill_plain`; the prefills never call it either.
"""

from __future__ import annotations

import numpy as np
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
    """One layer's decode attention of B lanes through K6a's arithmetic
    alone, one launch (csrc/decode.cu `bark_launch_attn_decode_batched`,
    the standalone kernels over the decode steps' `attend_int8` and
    `attend_dense`): K6a for int8 caches ({"q": (B, S, D) int8, "s": (B,
    S) f32}), the dense kernel for (B, S, D) caches in qkv's dtype. qkv is
    (B, 3D); n_past B ints in [0, S), or a (B,) int tensor on the card
    (taken as it is, as the batched step takes it). Writes each lane's
    fresh row in place and returns the (B, D) context; on CPU tensors the
    plain version."""
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


def _lanes(n_valid):
    """(one lane?, the lanes' n_valid as a list) of an int or B ints."""
    if isinstance(n_valid, (int, np.integer)):
        return True, [int(n_valid)]
    return False, [int(n) for n in n_valid]


def attn_prefill_plain(cfg: GPTConfig, q, k_cache, v_cache, n_valid):
    """The plain version of one layer's causal attention of a prefill, as
    `gpt.prefill` computes it (`gpt._attention_int8` on an int8 cache,
    `gpt._attention` on a dense one, under the causal mask over the lane's
    slots), lane by lane: q holds each lane's live query rows stacked,
    (sum(n_valid), D); the caches are one layer's, lane b's rows [0,
    n_valid[b]) written: int8 ({"q": (S, D) int8, "s": (S,) f32}) or dense
    ((S, D) in q's dtype) with n_valid an int, or (B, S, D) and (B, S) with
    n_valid B ints. Returns the (sum(n_valid), D) context in q's dtype."""
    one, lanes = _lanes(n_valid)
    slot = torch.arange(cfg.block_size, device=q.device)
    out, first = [], 0
    for b, n in enumerate(lanes):
        kc = k_cache if one else gpt.kv_view(k_cache, b)
        vc = v_cache if one else gpt.kv_view(v_cache, b)
        mask = slot[None, :] <= torch.arange(n, device=q.device)[:, None]
        rows = q[first:first + n]
        out.append(gpt._attention_int8(cfg, rows, kc, vc, mask)
                   if isinstance(kc, dict)
                   else gpt._attention(rows, kc, vc, mask, cfg))
        first += n
    return torch.cat(out)


def attn_prefill_tables(n_valid, S: int, device):
    """The int32 tables `attn_prefill` reads for stacked lanes of
    n_valid[b] rows over S cache slots (K8's rows and its 16- and 64-row
    query tiles), uploaded to `device`: built once, they serve every
    launch on the same lanes."""
    from bark_tpu_torch.kernels.bprefill import (TC_QUERY_TILE, query_tiles,
                                                 row_tables)

    lanes = [int(n) for n in n_valid]
    rows = row_tables(lanes, max(lanes), S)[0]
    tiles64 = query_tiles(lanes, TC_QUERY_TILE).reshape(-1)
    return _build.device_ints(np.concatenate([rows, tiles64]), device)


def attn_prefill(cfg: GPTConfig, q, k_cache, v_cache, n_valid, *,
                 tables=None):
    """One layer's causal attention of a prefill alone, one launch
    (csrc/prefill.cu `bark_launch_attn_prefill`, the prefills' own launch):
    on int8 caches K6c, in bf16 the tensor-core kernel, in f32 the scalar
    one; on dense caches the prefills' dense attention, its yardstick.
    Arguments and result as `attn_prefill_plain`'s; for stacked lanes,
    `tables` may hold `attn_prefill_tables(n_valid, ...)` on q's device,
    else they are built and uploaded here. On CPU tensors the plain
    version. Raises ValueError, before any launch, for what the kernels do
    not take."""
    from bark_tpu_torch.kernels.bprefill import TC_QUERY_TILE, QUERY_TILE

    if q.device.type == "cpu":
        return attn_prefill_plain(cfg, q, k_cache, v_cache, n_valid)
    one, lanes = _lanes(n_valid)
    B, D, S, M = len(lanes), cfg.n_embd, cfg.block_size, sum(lanes)
    if (q.dtype not in _build.DTYPE_CODES or D != cfg.n_head * 64
            or q.shape != (M, D) or not q.is_contiguous()
            or q.data_ptr() % 16):
        raise ValueError(f"q: want contiguous, 16-byte aligned (sum(n_valid) "
                         f"= {M}, {D}) float32 or bfloat16 rows with head_dim "
                         f"64, got {tuple(q.shape)} {q.dtype} and {cfg}")
    if S > 1024 or B < 1 or not all(1 <= n <= S for n in lanes):
        raise ValueError(f"n_valid {n_valid}: want 1 to {S} rows a lane, "
                         f"at most 1024 cache slots")
    quant = isinstance(k_cache, dict)
    if isinstance(v_cache, dict) != quant:
        raise ValueError("layer cache: k and v must both be int8 or dense")
    lead = () if one else (B,)
    want = ([("q", lead + (S, D), torch.int8),
             ("s", lead + (S,), torch.float32)] if quant
            else [(None, lead + (S, D), q.dtype)])
    ptrs = []
    for key, shape, dtype in want:
        for c in (k_cache, v_cache):
            t = c.get(key) if quant else c
            if (not torch.is_tensor(t) or tuple(t.shape) != shape
                    or t.dtype != dtype or t.device != q.device
                    or not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(
                    f"{'int8 ' if quant else ''}layer cache"
                    f"{f' {key!r}' if quant else ''}: want contiguous, "
                    f"16-byte aligned {shape} {dtype} on {q.device}")
            ptrs.append(t.data_ptr())
    n_tiles, n_tiles64 = (sum(-(-n // t) for n in lanes)
                          for t in (QUERY_TILE, TC_QUERY_TILE))
    if one:
        if tables is not None:
            raise ValueError("tables: for stacked lanes only")
    elif tables is None:
        tables = attn_prefill_tables(lanes, S, q.device)
    elif (tables.dtype != torch.int32 or tables.device != q.device
          or not tables.is_contiguous()
          or tables.numel() != 3 * M + 3 * n_tiles + 2 * B + 3 * n_tiles64):
        raise ValueError(f"tables: want attn_prefill_tables({lanes}, {S}) "
                         f"on {q.device}")
    kv = _build.BarkKV(*ptrs, *([None, None] if not quant else []))
    ctx = torch.empty((M, D), dtype=q.dtype, device=q.device)
    rc = _build.lib().bark_launch_attn_prefill(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), kv, B, M, max(lanes),
        n_tiles, n_tiles64, None if tables is None else tables.data_ptr(), S,
        D, cfg.n_head, ctx.data_ptr(), _build.stream_ptr(q.device))
    _build.check("attn_prefill", rc)
    return ctx
