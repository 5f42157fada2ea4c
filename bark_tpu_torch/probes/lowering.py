"""P1-P9: what the constructs of a whole-stage decode kernel cost on Hopper.

The counterpart of `tools/tpu_mosaic_probe.py`, whose ten Pallas kernels
asked whether Mosaic lowers each construct a whole-stage decode kernel
needs. Here they are hand-written kernels in one source,
`csrc/lowering_probe.cu`, and each asks what the Hopper counterpart of its
construct costs. One function per probe, with the reference's name, takes
the reference's inputs as tensors and returns its output: on a CUDA tensor
it launches the kernel and counts the launch in `launches[name]`; on a
CPU tensor it runs `<name>_plain`, the same function in plain PyTorch, in
the reference's order of sums. A shape, dtype or device the kernel does
not take raises a ValueError before any launch; nothing falls back.

- P1 `probe_while_loop(x, method)`: a loop whose condition reads a counter
  its body updates; out = the iterations (x[0, 0], or 0). `block`: the
  reference's one block; `grid`: a persistent grid (one block an SM,
  cooperative launch), a grid-wide barrier an iteration and a stop flag
  block 0 sets on the device, the EOS stop of a decode loop that stays on
  the card; `host`: one launch an iteration, the chain the host drives
  today. Answers: µs per dependent iteration each way.
- P2 `probe_vector_to_smem_scalar(v)`: the first lane holding the max of a
  (1, n) f32 row, as a scalar: out = 2 tok + 1. Answers: a block argmax
  over the semantic logits (n 10048).
- P2b `probe_scalar_dma_row(v, tbl, group, method)`: that token's row of
  tbl, loaded as the aligned group of `group` rows holding it (the
  reference's 8; 1 on Hopper). `fused`: argmax and a bulk copy in one
  block; `two_launch`: P2's kernel writes the token, a second kernel reads
  it. Answers: what sampling and the next token's embedding in one kernel
  save (the semantic wte, (129600, 768) bf16).
- P3 `probe_dynamic_leading_dma(g, prefetch, method)`: out = the rows of
  g summed in order. `block`: one block, each row a bulk copy at the
  loop's index; `prefetch` keeps the next row's copy in flight. Answers:
  the latency of a noise row read per step in a persistent kernel ((60,
  10048) f32). `strips` (the default): a block for each strip of 64
  columns, every row's strip in flight at once, each column summed in row
  order (bit-equal to the plain version): the function at the card's
  rate.
- P4 `probe_dynamic_vmem_read(p, unroll)`: out = sum_l p[l, 0] + 2 p[l, 3]
  from shared memory at a run-time layer index, the layer loop unrolled or
  not. P5 `probe_dynamic_vmem_write(x, layers, unroll)`: out[l] = x + l,
  staged in shared memory at a run-time index, then bulk stores. Answers:
  registers, spills, program size and µs of a layer loop that is not
  unrolled (12 layers of width 768).
- P6 `probe_dyn_ring_stream(w, ring, blocks, prefetch)`: out = sum over
  layers and tiles of row 0 of each tile of w (L, T, R, W), streamed
  through a bulk-copy ring with full and empty mbarriers; `blocks` > 1 is a
  persistent grid with a grid-wide barrier a layer, each block taking every
  blocks-th tile of a layer; `prefetch` keeps the next layer's first tiles
  in flight across the barrier, else the ring drains there. Answers: the
  share of 3.35 TB/s a layer-synchronous weight stream keeps (bark-small's
  12 decode layers, 14.2 MB each).
- P7 `probe_dynamic_hbm_write(x, layers, method)`: out[l] = x (or x[l]),
  each layer's rows a store at a run-time layer index. P8
  `probe_dynamic_hbm_write_rowoff(x, off, out, ...)`: the same into rows
  [base, base + R) of each layer, base = (off // align) align, only that
  window written into the caller's buffer; with x (L, B, R, W) and off (B,)
  each lane at its own row. `bulk`: bulk stores from shared memory, a
  block a chunk of rows through every layer in turn; `st16`: 16-byte
  stores. Answers: K/V row write-back at per-lane n_past, and its
  alignment rule: a bulk copy wants 16-byte addresses and sizes, which any
  row of a 768-wide bf16 cache meets, so no 8-row window is needed.
  `ring` (P7's default; P8's stays `bulk`): a block an SM, each a
  contiguous run of the (lane, layer, row) range, a ring of 4 stages of
  32 KB loading while earlier stages' bulk stores drain: a prefill's K/V
  slabs at the card's rate.
- P9 `probe_transposed_group_dot(x, wt, method)`: out = x (M, K) against
  the g slots of wt (g, N, K) read as one (g N, K) operand, both
  contracted on K (the fused qkv or fc dot). `simt`: f32 FMAs, f32 or
  bf16 inputs (the reference's atol 1e-4 needs f32); `wgmma`: bf16, x's M
  <= 64 rows as the M of wgmma.mma_async. Answers: lanes as M rows in the
  batched decode step (qkv: 3 slots of (768, 768)).

`main` is the CLI: the reference's ten probes at its shapes, printed as
the reference prints them (`PASS name: ...`, `n/10 probes passed`), exit 1
unless all pass; `--sweep` (the card only) adds the questions at
bark-small sizes as one JSON line:

    python -m bark_tpu_torch.probes.lowering            # on the card
    python -m bark_tpu_torch.probes.lowering --sweep
    python -m bark_tpu_torch.probes.lowering --device cpu
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import numpy as np
import torch

from bark_tpu_torch.kernels import _build
from bark_tpu_torch.probes._timing import (copies_for, evict_l2, mean_ms,
                                           profiled_us)
from bark_tpu_torch.probes.cache import _cuobjdump

SOURCE = "lowering_probe.cu"
NAMES = ("probe_while_loop", "probe_vector_to_smem_scalar",
         "probe_scalar_dma_row", "probe_dynamic_leading_dma",
         "probe_dynamic_vmem_read", "probe_dynamic_vmem_write",
         "probe_dyn_ring_stream", "probe_dynamic_hbm_write",
         "probe_dynamic_hbm_write_rowoff", "probe_transposed_group_dot")
# the reference's labels (tools/tpu_mosaic_probe.py `main`)
LABELS = dict(zip(NAMES, (
    "P1 while_loop in kernel", "P2 vector->SMEM scalar",
    "P2b scalar-indexed HBM DMA", "P3 dynamic leading DMA",
    "P4 dynamic leading VMEM read", "P5 dynamic leading VMEM write",
    "P6 dynamic ring stream", "P7 dynamic HBM write target",
    "P8 dynamic HBM write + row offset", "P9 transposed group dot")))
WHILE_METHODS = ("block", "grid", "host")
ROW_METHODS = ("fused", "two_launch")
LEADING_METHODS = ("strips", "block")
WRITE_METHODS = ("bulk", "st16", "ring")
DOT_METHODS = ("simt", "wgmma")

NO_TOKEN = 1 << 30  # the reference's argmax where no lane equals the max
MAX_LAYERS = 16     # P4, P5: the layer loop's bound when unrolled
P4_ROWS, P5_ROWS, LP_COLS = 16, 8, 128
ROWSUM_MAX = 16 * 1024     # P3's widest row
RING_MAX, RING_MAX_W = 4, 1024
WRITE_MAX_ROW = 32 * 1024  # P7/P8's widest row, in bytes
# P7/P8 `ring`: stages a block (2 to 16), the bytes a stage holds (whole
# rows, one at least), blocks an SM
WRING_STAGES, WRING_STAGE_BYTES, WRING_BLOCKS_PER_SM = 4, 32 * 1024, 1
# the sweep's other ring configurations: (blocks an SM, stages, KB a stage)
WRING_CONFIGS = ((1, 4, 16), (1, 4, 32), (1, 6, 32), (1, 8, 16), (2, 4, 16),
                 (2, 3, 32))
WGMMA_MAX_M = 64
# dynamic shared memory a block may take: 227 KB less the static barriers
SMEM_BYTES = 227 * 1024 - 1024
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory

launches = dict.fromkeys(NAMES, 0)  # kernel launches through the wrappers

_scratch = {}  # device index -> reused zeroed scratch


# ------------------------------------------------------------ checks


def _on_cuda(*ts) -> bool:
    """Whether the tensors lie on a CUDA device (all on one device), or on
    the CPU; raises for another device or a mix."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the lowering probes run on cpu or cuda, got {dev}")
    return dev.type == "cuda"


def _want(name, t, dtypes, ndim=None, shape=None):
    if not torch.is_tensor(t):
        raise ValueError(f"{name}: want a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes or (ndim is not None and t.dim() != ndim) or (
            shape is not None and tuple(t.shape) != tuple(shape)):
        want = shape if shape is not None else f"{ndim}-d"
        raise ValueError(f"{name}: want {want} {'/'.join(map(str, dtypes))}, "
                         f"got {tuple(t.shape)} {t.dtype}")


def _aligned(name, *ts):
    """The kernels' rule for CUDA tensors: contiguous, 16-byte aligned."""
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes contiguous, 16-byte "
                             f"aligned tensors")


def _scratch_for(device):
    s = _scratch.get(device.index)
    if s is None:
        s = torch.zeros(16, dtype=torch.int32, device=device)
        _scratch[device.index] = s
    return s


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name, rc):
    _build.check(f"lowering_probe[{name}]", rc)


# ------------------------------------------------------------ P1


def probe_while_loop_plain(x):
    """P1: the iterations of `while cnt < x[0, 0]: cnt += 1`."""
    n, cnt, c = int(x.reshape(-1)[0]), 0, 0
    while cnt < n:
        cnt, c = cnt + 1, c + 1
    return torch.full((1, 1), c, dtype=torch.int32, device=x.device)


def probe_while_loop(x, method: str = "block"):
    """P1: x (1, 1) int32 -> (1, 1) int32, the iterations run. `grid`
    runs one block an SM, all resident; `host` reads x on the host for the
    chain's length (a sync), as a host loop does."""
    _want("x", x, (torch.int32,), shape=(1, 1))
    if method not in WHILE_METHODS:
        raise ValueError(f"method {method!r}: want one of {WHILE_METHODS}")
    if not _on_cuda(x):
        return probe_while_loop_plain(x)
    return _while(x, method, max(0, int(x.item())) if method == "host" else 0)


def _while(x, method, n_launch):
    """P1's kernel on the CUDA tensor x; `host` launches n_launch times."""
    _aligned("x", x)
    out = torch.empty((1, 1), dtype=torch.int32, device=x.device)
    rc = _build.lib().bark_lp_while(
        WHILE_METHODS.index(method), x.data_ptr(), out.data_ptr(),
        _scratch_for(x.device).data_ptr(),
        _sm_count(x.device) if method == "grid" else 1, n_launch,
        _build.stream_ptr(x.device))
    _check("probe_while_loop", rc)
    launches["probe_while_loop"] += n_launch if method == "host" else 1
    return out


# ------------------------------------------------------------ P2, P2b


def _argmax_first(v):
    """The first lane holding the max of v (f32, NaN-propagating max as the
    reference's jnp.max), or NO_TOKEN when no lane equals it."""
    flat = v.reshape(-1)
    lane = torch.arange(flat.numel(), device=v.device)
    return int(torch.where(flat == flat.max(), lane, NO_TOKEN).min())


def _wrap_i32(n: int) -> int:
    return (n + (1 << 31)) % (1 << 32) - (1 << 31)


def _want_v(v):
    _want("v", v, (torch.float32,), ndim=2)
    if v.shape[0] != 1 or v.shape[1] < 1:
        raise ValueError(f"v: want (1, n >= 1), got {tuple(v.shape)}")


def probe_vector_to_smem_scalar_plain(v):
    """P2: 2 tok + 1 for tok the first lane of the max, as int32."""
    return torch.full((1, 1), _wrap_i32(2 * _argmax_first(v) + 1),
                      dtype=torch.int32, device=v.device)


def probe_vector_to_smem_scalar(v):
    """P2: v (1, n) f32 -> (1, 1) int32."""
    _want_v(v)
    if not _on_cuda(v):
        return probe_vector_to_smem_scalar_plain(v)
    _aligned("v", v)
    out = torch.empty((1, 1), dtype=torch.int32, device=v.device)
    rc = _build.lib().bark_lp_argmax(v.data_ptr(), v.numel(), None,
                                     out.data_ptr(),
                                     _build.stream_ptr(v.device))
    _check("probe_vector_to_smem_scalar", rc)
    launches["probe_vector_to_smem_scalar"] += 1
    return out


def probe_scalar_dma_row_plain(v, tbl, group: int = 8):
    """P2b: tbl[tok] as (1, D), read from the aligned group of `group` rows
    holding it; zeros when that group leaves the table (no token)."""
    tok = _argmax_first(v)
    base = tok // group * group
    if base + group > tbl.shape[0]:
        return torch.zeros((1, tbl.shape[1]), dtype=tbl.dtype,
                           device=tbl.device)
    return tbl[base:base + group][tok - base].reshape(1, -1).clone()


def probe_scalar_dma_row(v, tbl, group: int = 8, method: str = "fused"):
    """P2b: v (1, n) f32, tbl (rows, D) -> (1, D) in tbl's dtype."""
    _want_v(v)
    _want("tbl", tbl, tuple(DTYPE_CODES), ndim=2)
    if group < 1 or method not in ROW_METHODS:
        raise ValueError(f"group {group} (want >= 1), method {method!r} "
                         f"(want one of {ROW_METHODS})")
    if not _on_cuda(v, tbl):
        return probe_scalar_dma_row_plain(v, tbl, group)
    row_bytes = tbl.shape[1] * tbl.element_size()
    if row_bytes % 16 or group * row_bytes > SMEM_BYTES:
        raise ValueError(f"tbl rows of {row_bytes} bytes, group {group}: "
                         f"want a multiple of 16 bytes, the group within "
                         f"{SMEM_BYTES} bytes of shared memory")
    _aligned("v, tbl", v, tbl)
    out = torch.empty((1, tbl.shape[1]), dtype=tbl.dtype, device=tbl.device)
    rc = _build.lib().bark_lp_row(
        ROW_METHODS.index(method), v.data_ptr(), v.numel(), tbl.data_ptr(),
        tbl.shape[0], row_bytes, group, out.data_ptr(),
        _scratch_for(v.device).data_ptr(), _build.stream_ptr(v.device))
    _check("probe_scalar_dma_row", rc)
    launches["probe_scalar_dma_row"] += 1 if method == "fused" else 2
    return out


# ------------------------------------------------------------ P3


def probe_dynamic_leading_dma_plain(g):
    """P3: acc = acc + g[j] for j in order, from zeros; (1, W)."""
    acc = torch.zeros(g.shape[1], dtype=torch.float32, device=g.device)
    for j in range(g.shape[0]):
        acc = acc + g[j]
    return acc.reshape(1, -1)


def probe_dynamic_leading_dma(g, prefetch: bool = False,
                              method: str = "strips"):
    """P3: g (N, W) f32 -> (1, W) f32. `prefetch` is the `block` method's
    (`strips` has every row in flight)."""
    _want("g", g, (torch.float32,), ndim=2)
    if g.shape[0] < 1 or not 1 <= g.shape[1] <= ROWSUM_MAX or g.shape[1] % 4:
        raise ValueError(f"g: want (N >= 1, W) with W a multiple of 4 up to "
                         f"{ROWSUM_MAX}, got {tuple(g.shape)}")
    if method not in LEADING_METHODS:
        raise ValueError(f"method {method!r}: want one of {LEADING_METHODS}")
    if prefetch and method != "block":
        raise ValueError(f"prefetch is the block method's, not {method!r}'s")
    if not _on_cuda(g):
        return probe_dynamic_leading_dma_plain(g)
    _aligned("g", g)
    out = torch.empty((1, g.shape[1]), dtype=torch.float32, device=g.device)
    code = 2 if method == "strips" else int(prefetch)
    rc = _build.lib().bark_lp_rows_sum(g.data_ptr(), g.shape[0], g.shape[1],
                                       code, out.data_ptr(),
                                       _build.stream_ptr(g.device))
    _check("probe_dynamic_leading_dma", rc)
    launches["probe_dynamic_leading_dma"] += 1
    return out


# ------------------------------------------------------------ P4, P5


def _want_layers(L, W):
    if not 1 <= L <= MAX_LAYERS or W < LP_COLS or W % LP_COLS:
        raise ValueError(f"{L} layers of width {W}: want 1 to {MAX_LAYERS} "
                         f"layers and a width that is a multiple of "
                         f"{LP_COLS}")


def probe_dynamic_vmem_read_plain(p):
    """P4: acc = acc + p[l, 0] + p[l, 3] * 2 for l in order; (1, W)."""
    acc = torch.zeros(p.shape[2], dtype=torch.float32, device=p.device)
    for l in range(p.shape[0]):
        acc = acc + p[l, 0] + p[l, 3] * 2.0
    return acc.reshape(1, -1)


def probe_dynamic_vmem_read(p, unroll: bool = False):
    """P4: p (L, 16, W) f32 -> (1, W) f32."""
    _want("p", p, (torch.float32,), ndim=3)
    if p.shape[1] != P4_ROWS:
        raise ValueError(f"p: want (L, {P4_ROWS}, W), got {tuple(p.shape)}")
    _want_layers(p.shape[0], p.shape[2])
    if not _on_cuda(p):
        return probe_dynamic_vmem_read_plain(p)
    return _layers(0, unroll, p, p.shape[0], p.shape[2], (1, p.shape[2]),
                   "probe_dynamic_vmem_read")


def probe_dynamic_vmem_write_plain(x, layers: int = 6):
    """P5: out[l] = x + l; (layers, 8, W)."""
    lv = torch.arange(layers, dtype=torch.float32, device=x.device)
    return x[None] + lv[:, None, None]


def probe_dynamic_vmem_write(x, layers: int = 6, unroll: bool = False):
    """P5: x (8, W) f32 -> (layers, 8, W) f32."""
    _want("x", x, (torch.float32,), ndim=2)
    if x.shape[0] != P5_ROWS:
        raise ValueError(f"x: want ({P5_ROWS}, W), got {tuple(x.shape)}")
    _want_layers(layers, x.shape[1])
    if not _on_cuda(x):
        return probe_dynamic_vmem_write_plain(x, layers)
    return _layers(1, unroll, x, layers, x.shape[1],
                   (layers, P5_ROWS, x.shape[1]), "probe_dynamic_vmem_write")


def _layers(write, unroll, t, L, W, out_shape, name):
    _aligned(name, t)
    out = torch.empty(out_shape, dtype=torch.float32, device=t.device)
    rc = _build.lib().bark_lp_layers(write, int(unroll), t.data_ptr(), L, W,
                                     out.data_ptr(),
                                     _build.stream_ptr(t.device))
    _check(name, rc)
    launches[name] += 1
    return out


# ------------------------------------------------------------ P6


def probe_dyn_ring_stream_plain(w, blocks: int = 1):
    """P6: block b sums row 0 of tiles b, b + blocks, ... of each layer in
    order; out = the blocks' sums added in block order; (1, W)."""
    L, T, _, W = w.shape
    rows = w[:, :, 0].float()  # (L, T, W)
    acc = torch.zeros((blocks, W), dtype=torch.float32, device=w.device)
    for l in range(L):
        for t0 in range(0, T, blocks):
            n = min(blocks, T - t0)  # tiles t0 .. t0 + n - 1, blocks 0 .. n-1
            acc[:n] = acc[:n] + rows[l, t0:t0 + n]
    out = acc[0]
    for b in range(1, blocks):
        out = out + acc[b]
    return out.reshape(1, W)


def probe_dyn_ring_stream(w, ring: int = 2, blocks: int = 1,
                          prefetch: bool = True):
    """P6: w (L, T, R, W) f32 or bf16 -> (1, W) f32. `blocks` > 1 must all
    be resident at once (at most one an SM)."""
    _want("w", w, tuple(DTYPE_CODES), ndim=4)
    L, T, R, W = w.shape
    tile = R * W * w.element_size()
    if (min(L, T, R) < 1 or not 1 <= W <= RING_MAX_W
            or not 1 <= ring <= RING_MAX or blocks < 1 or tile % 16
            or tile * ring > SMEM_BYTES):
        raise ValueError(
            f"ring stream: w {tuple(w.shape)} {w.dtype}, ring {ring}, blocks "
            f"{blocks}: want W <= {RING_MAX_W}, ring 1 to {RING_MAX}, tiles "
            f"of a multiple of 16 bytes, ring x tile within {SMEM_BYTES} "
            f"bytes")
    if not _on_cuda(w):
        return probe_dyn_ring_stream_plain(w, blocks)
    if blocks > _sm_count(w.device):
        raise ValueError(f"ring stream: {blocks} blocks, want at most one "
                         f"an SM ({_sm_count(w.device)})")
    _aligned("w", w)
    out = torch.empty((1, W), dtype=torch.float32, device=w.device)
    partial = torch.empty((blocks, W), dtype=torch.float32, device=w.device)
    rc = _build.lib().bark_lp_ring(
        DTYPE_CODES[w.dtype], w.data_ptr(), L, T, R, W, ring, int(prefetch),
        blocks, _scratch_for(w.device)[4:].data_ptr(), partial.data_ptr(),
        out.data_ptr(), _build.stream_ptr(w.device))
    _check("probe_dyn_ring_stream", rc)
    launches["probe_dyn_ring_stream"] += 1
    return out


# ------------------------------------------------------------ P7, P8


def _row_write(name, method, src, src_ls, src_bs, dst, offs, L, B, rows, S,
               align, ring=None, stamps=None):
    """Launch P7/P8's kernel: rows of src into dst (L, B, S, W); src's
    strides in elements. `ring`: the ring method's (blocks, stages, stage
    bytes), by default a block an SM, WRING_STAGES of WRING_STAGE_BYTES;
    `stamps`: a (blocks, 4) int64 tensor for the ring's stamps."""
    row_bytes = dst.shape[-1] * dst.element_size()
    if row_bytes % 16 or row_bytes > WRITE_MAX_ROW:
        raise ValueError(f"rows of {row_bytes} bytes: a bulk copy takes a "
                         f"multiple of 16 bytes (at most {WRITE_MAX_ROW})")
    _aligned(name, src, dst)
    if offs is not None and not offs.is_contiguous():
        raise ValueError(f"{name}: off must be contiguous")
    item = dst.element_size()
    blocks, stages, stage_bytes = ring or (
        WRING_BLOCKS_PER_SM * _sm_count(dst.device), WRING_STAGES,
        WRING_STAGE_BYTES)
    rc = _build.lib().bark_lp_row_write(
        WRITE_METHODS.index(method), src.data_ptr(), src_ls * item,
        src_bs * item, dst.data_ptr(), B * S * row_bytes, S * row_bytes,
        None if offs is None else offs.data_ptr(), L, B, rows, row_bytes, S,
        align, blocks, stages, stage_bytes,
        None if stamps is None else stamps.data_ptr(),
        _build.stream_ptr(dst.device))
    _check(name, rc)
    launches[name] += 1


def _want_method(method):
    if method not in WRITE_METHODS:
        raise ValueError(f"method {method!r}: want one of {WRITE_METHODS}")


def probe_dynamic_hbm_write_plain(x, layers: int = 6):
    """P7: out[l] = x (x (R, W), for `layers` layers) or x[l] (x (L, R, W))."""
    if x.dim() == 2:
        return x[None].expand(layers, *x.shape).clone()
    return x.clone()


def probe_dynamic_hbm_write(x, layers: int = 6, method: str = "ring"):
    """P7: x (R, W) -> (layers, R, W), every layer x; or x (L, R, W) ->
    (L, R, W), layer l x[l] (one slab a layer: a prefill's K/V rows)."""
    _want("x", x, tuple(DTYPE_CODES))
    _want_method(method)
    if x.dim() not in (2, 3) or (x.dim() == 2 and layers < 1):
        raise ValueError(f"x: want (R, W) with layers >= 1 or (L, R, W), got "
                         f"{tuple(x.shape)}, layers {layers}")
    L = layers if x.dim() == 2 else x.shape[0]
    R, W = x.shape[-2:]
    if min(L, R, W) < 1:
        raise ValueError(f"x: empty {tuple(x.shape)}")
    if not _on_cuda(x):
        return probe_dynamic_hbm_write_plain(x, layers)
    return _hbm_write(x, L, method)


def _hbm_write(x, L, method, ring=None, stamps=None):
    """P7's kernel on the CUDA tensor x into L layers (`_row_write`'s
    `ring` and `stamps`)."""
    R, W = x.shape[-2:]
    out = torch.empty((L, R, W), dtype=x.dtype, device=x.device)
    _row_write("probe_dynamic_hbm_write", method, x,
               0 if x.dim() == 2 else R * W, 0, out, None, L, 1, R, R, 1,
               ring, stamps)
    return out


def ring_stamps_us(x) -> dict:
    """P7's ring on the CUDA slabs x (L, R, W), stamped, after the L2 is
    evicted: each block's start, first and last piece landed, and stores
    complete, in µs from the first block's start; the median and the
    slowest block of each."""
    blocks = WRING_BLOCKS_PER_SM * _sm_count(x.device)
    stamps = torch.zeros((blocks, 4), dtype=torch.int64, device=x.device)
    evict_l2(x.device)
    _hbm_write(x, x.shape[0], "ring", stamps=stamps)
    t = stamps[stamps[:, 0] > 0].double()
    t = (t - t[:, 0].min()) / 1e3
    names = ("start", "first_landed", "last_landed", "stored")
    return {name: dict(median=float(t[:, i].median()),
                       slowest=float(t[:, i].max()))
            for i, name in enumerate(names)}


def _rowoff_form(x, off, out, layers, seq):
    """(L, B, R, W, S, reference form) of P8's arguments, or raise."""
    _want("x", x, tuple(DTYPE_CODES))
    _want("off", off, (torch.int32,))
    if x.dim() == 2 and tuple(off.shape) == (1, 1):
        (R, W), L, B, S, ref = x.shape, layers, 1, seq, True
        want = (L, S, W)
    elif x.dim() == 4 and off.dim() == 1 and off.shape[0] == x.shape[1]:
        (L, B, R, W), ref = x.shape, False
        if out is None or out.dim() != 4:
            raise ValueError("rowoff: the per-lane form writes into a given "
                             "out (L, B, S, W)")
        S = out.shape[2]
        want = (L, B, S, W)
    else:
        raise ValueError(f"rowoff: want x (R, W) with off (1, 1), or x "
                         f"(L, B, R, W) with off (B,); got {tuple(x.shape)}, "
                         f"{tuple(off.shape)}")
    if min(L, B, R, W) < 1 or R > S:
        raise ValueError(f"rowoff: {R} rows into {S}, {L} layers, {B} lanes")
    if out is not None:
        _want("out", out, (x.dtype,), shape=want)
    return L, B, R, W, S, ref


def _window(off: int, align: int, R: int, S: int):
    """The first row P8 writes, or None when the window leaves [0, S)."""
    base = off // align * align if off >= 0 else -1
    return base if 0 <= base and base + R <= S else None


def probe_dynamic_hbm_write_rowoff_plain(x, off, out=None, layers: int = 4,
                                         seq: int = 32, align: int = 8):
    """P8: rows [base, base + R) of every layer (of every lane) = x; the
    rest of out untouched (NaN when out is not given)."""
    L, B, R, W, S, ref = _rowoff_form(x, off, out, layers, seq)
    if out is None:
        out = torch.full((L, S, W), float("nan"), dtype=x.dtype,
                         device=x.device)
    rows = x[None, None].expand(L, 1, R, W) if ref else x
    view = out.view(L, B, S, W)
    for b, o in enumerate(off.reshape(-1).tolist()):
        base = _window(o, align, R, S)
        if base is not None:
            view[:, b, base:base + R] = rows[:, b]
    return out


def probe_dynamic_hbm_write_rowoff(x, off, out=None, layers: int = 4,
                                   seq: int = 32, align: int = 8,
                                   method: str = "bulk"):
    """P8: x (R, W) and off (1, 1) int32 -> out (layers, seq, W) with rows
    [base, base + R) of each layer x, base = (off // align) align (out
    allocated full of NaN when not given: only the window is defined); or
    x (L, B, R, W), off (B,) int32 and out (L, B, S, W), lane b at its own
    base. A window that leaves [0, S) is not written."""
    L, B, R, W, S, ref = _rowoff_form(x, off, out, layers, seq)
    _want_method(method)
    if align < 1:
        raise ValueError(f"align {align}: want >= 1")
    if not _on_cuda(x, off, *(() if out is None else (out,))):
        return probe_dynamic_hbm_write_rowoff_plain(x, off, out, layers, seq,
                                                    align)
    if out is None:
        out = torch.full((L, S, W), float("nan"), dtype=x.dtype,
                         device=x.device)
    _row_write("probe_dynamic_hbm_write_rowoff", method, x,
               0 if ref else B * R * W, 0 if ref else R * W, out,
               off.reshape(-1), L, B, R, S, align)
    return out


# ------------------------------------------------------------ P9


def probe_transposed_group_dot_plain(x, wt):
    """P9: x (M, K) @ wt.reshape(g N, K).T in f32; (M, g N)."""
    g, N, K = wt.shape
    return x.float() @ wt.reshape(g * N, K).float().T


def probe_transposed_group_dot(x, wt, method: str = "simt"):
    """P9: x (M, K), wt (g, N, K), one dtype -> (M, g N) f32. `wgmma`
    takes bf16, M <= 64 and K a multiple of 16."""
    _want("x", x, tuple(DTYPE_CODES), ndim=2)
    _want("wt", wt, (x.dtype,), ndim=3)
    (M, K), (g, N, K2) = x.shape, wt.shape
    if K2 != K or min(M, K, g, N) < 1 or method not in DOT_METHODS:
        raise ValueError(f"group dot: x {tuple(x.shape)}, wt "
                         f"{tuple(wt.shape)}, method {method!r}: want a "
                         f"shared K and one of {DOT_METHODS}")
    if method == "wgmma" and (x.dtype != torch.bfloat16 or M > WGMMA_MAX_M
                              or K % 16):
        raise ValueError(f"wgmma takes bf16, M <= {WGMMA_MAX_M} and K a "
                         f"multiple of 16; got {x.dtype}, M {M}, K {K}")
    if method == "simt" and M * K * x.element_size() > SMEM_BYTES:
        raise ValueError(f"simt holds x in shared memory: {M} x {K} exceeds "
                         f"{SMEM_BYTES} bytes")
    if not _on_cuda(x, wt):
        return probe_transposed_group_dot_plain(x, wt)
    _aligned("x, wt", x, wt)
    out = torch.empty((M, g * N), dtype=torch.float32, device=x.device)
    rc = _build.lib().bark_lp_group_dot(
        DOT_METHODS.index(method), DTYPE_CODES[x.dtype], x.data_ptr(),
        wt.data_ptr(), M, g * N, K, out.data_ptr(),
        _build.stream_ptr(x.device))
    _check("probe_transposed_group_dot", rc)
    launches["probe_transposed_group_dot"] += 1
    return out


# ------------------------------------------------------------ the CLI


def reference_inputs(device) -> dict:
    """Each probe's inputs as the reference builds them (P9's from a torch
    generator seeded 0: the reference draws from jax.random)."""
    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    v = torch.zeros((1, 256), **f32)
    v[0, 93] = 5.0
    x8 = torch.arange(8 * 128, **f32).reshape(8, 128)
    gen = torch.Generator().manual_seed(0)
    return {
        "probe_while_loop": (torch.full((1, 1), 7, dtype=torch.int32,
                                        device=dev),),
        "probe_vector_to_smem_scalar": (v,),
        "probe_scalar_dma_row": (v, torch.arange(256 * 128, **f32)
                                 .reshape(256, 128)),
        "probe_dynamic_leading_dma": (torch.arange(4 * 128, **f32)
                                      .reshape(4, 128),),
        "probe_dynamic_vmem_read": (torch.arange(6 * 16 * 128, **f32)
                                    .reshape(6, 16, 128),),
        "probe_dynamic_vmem_write": (x8,),
        "probe_dyn_ring_stream": (torch.arange(6 * 2 * 8 * 128, **f32)
                                  .reshape(6, 2, 8, 128),),
        "probe_dynamic_hbm_write": (x8,),
        "probe_dynamic_hbm_write_rowoff": (x8, torch.full(
            (1, 1), 19, dtype=torch.int32, device=dev)),
        "probe_transposed_group_dot": (
            torch.randn((1, 128), generator=gen).to(dev),
            torch.randn((3, 128, 128), generator=gen).to(dev)),
    }


def _expect(ok: bool, what):
    if not ok:
        raise AssertionError(what)


def _close(got, want, **kw) -> bool:
    return bool(np.allclose(got.cpu().numpy(), want, **kw))


def run_reference_probe(name: str, inputs: tuple) -> str:
    """One probe at the reference's call and check (its assert as an
    AssertionError); the reference's PASS message."""
    fn = globals()[name]
    a = [t.cpu().numpy() for t in inputs]
    if name == "probe_while_loop":
        got = int(fn(*inputs)[0, 0])
        _expect(got == 7, got)
        return f"while_loop ran 7 iters -> {got}"
    if name == "probe_vector_to_smem_scalar":
        got = int(fn(*inputs)[0, 0])
        _expect(got == 187, got)
        return "argmax lane -> SMEM scalar -> scalar arithmetic OK"
    if name == "probe_scalar_dma_row":
        got = fn(*inputs)
        _expect(_close(got, a[1][93]), got[0, :4])
        return "vector argmax -> SMEM scalar -> dynamic HBM row DMA OK"
    if name == "probe_dynamic_leading_dma":
        got = fn(*inputs)
        _expect(_close(got[0], a[0].sum(axis=0)), got[0, :4])
        return "fori_loop dynamic leading-index HBM row DMA OK"
    if name == "probe_dynamic_vmem_read":
        got = fn(*inputs)[0]
        want = a[0][:, 0].sum(axis=0) + 2.0 * a[0][:, 3].sum(axis=0)
        _expect(_close(got, want), got[:4])
        return "fori_loop dynamic leading-index VMEM reads OK"
    if name == "probe_dynamic_vmem_write":
        got = fn(*inputs)
        want = a[0][None] + np.arange(6, dtype=np.float32)[:, None, None]
        _expect(_close(got, want), got[0, 0, :4])
        return "fori_loop dynamic leading-index VMEM stores OK"
    if name == "probe_dyn_ring_stream":
        got = fn(*inputs)[0]
        _expect(_close(got, a[0][:, :, 0].sum(axis=(0, 1))), got[:4])
        return "block-unrolled dynamic ring stream OK"
    if name == "probe_dynamic_hbm_write":
        got = fn(*inputs)
        _expect(_close(got, np.broadcast_to(a[0][None], (6, 8, 128))),
                got[0, 0, :4])
        return "fori_loop dynamic leading-index HBM write target OK"
    if name == "probe_dynamic_hbm_write_rowoff":
        got = fn(*inputs)[:, 16:24]
        _expect(_close(got, np.broadcast_to(a[0][None], (4, 8, 128))),
                got[0, 0, :4])
        return "traced leading index + traced row offset HBM write OK"
    got = fn(*inputs)
    want = np.concatenate([a[0].astype(np.float64) @ a[1][t].T.astype(
        np.float64) for t in range(3)], axis=1)
    err = float(np.abs(got.cpu().numpy() - want).max())
    _expect(_close(got, want, atol=1e-4), err)
    return "x(1,D) . W'(gD,D) dim1xdim1 on a multi-slot view OK"


def run_reference(device="cuda") -> list:
    """The reference's ten probes, printed as it prints them; a FAIL prints
    the error's first lines and the run goes on (its exit code says so).
    Returns the names that passed."""
    passed = []
    for name, inputs in reference_inputs(device).items():
        label = LABELS[name]
        try:
            msg = run_reference_probe(name, inputs)
        except (AssertionError, RuntimeError, ValueError) as e:
            head = "\n  ".join(str(e).splitlines()[:6])
            print(f"FAIL {label}:\n  {type(e).__name__}: {head}", flush=True)
            continue
        print(f"PASS {label}: {msg}", flush=True)
        passed.append(name)
    print(f"{len(passed)}/{len(NAMES)} probes passed", flush=True)
    return passed


# ------------------------------------------------------------ the sweep

# bark-small: width 768, 12 layers, block 1024; the semantic vocabularies
D, LAYERS, SEQ = 768, 12, 1024
SEM_LOGITS, SEM_WTE = 10048, 129600
LAYER_WEIGHTS = 7_077_888  # qkv + proj + fc + fc-proj values of a layer
RING_TILE_ROWS, RING_TILE_W = 16, 1024  # 32 KB bf16 tiles
WHILE_NS = (60, 1024)
DOT_MS = (1, 8, 32, 64)
KV_BATCHES = (1, 8, 32)
PREFILL_ROWS = 257  # the semantic prompt: P7's per-layer slab


def ptxas_info(pattern: str) -> dict:
    """Registers and spill bytes of each kernel whose mangled name matches
    `pattern` (a regex with one group naming the instance), from the
    library's `-Xptxas -v` report."""
    info, entry = {}, None
    for line in _build.report_path().read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$.]+)'?", line)
        if m:
            entry = m.group(1)
            continue
        k = entry and re.search(pattern, entry)
        if not k:
            continue
        rec = info.setdefault(k.group(1), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rec.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
    return info


def sass_lines(pattern: str) -> dict:
    """Instructions in the SASS of each kernel whose name matches
    `pattern` (as `ptxas_info`), from `cuobjdump -sass` of the library's
    object of lowering_probe.cu."""
    obj = _build._object_path(_build.SRC_DIR / SOURCE)
    dump = subprocess.run([_cuobjdump(), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    counts, key = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(pattern, m.group(1))
            key = k.group(1) if k else None
            if key is not None:
                counts[key] = 0
        elif key is not None and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            counts[key] += 1
    return counts


def _randn(shape, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def sweep_inputs(dev) -> dict:
    """The bark-small-sized inputs of the sweep, seeded."""
    bf = torch.bfloat16
    return dict(
        v=_randn((1, SEM_LOGITS), torch.float32, dev, 1),
        wte=_randn((SEM_WTE, D), bf, dev, 2),
        noise=_randn((60, SEM_LOGITS), torch.float32, dev, 3),
        p=_randn((LAYERS, P4_ROWS, D), torch.float32, dev, 4),
        x=_randn((P5_ROWS, D), torch.float32, dev, 5),
        w=_randn((LAYERS, LAYER_WEIGHTS // (RING_TILE_ROWS * RING_TILE_W),
                  RING_TILE_ROWS, RING_TILE_W), bf, dev, 6),
        slab=_randn((2 * LAYERS, PREFILL_ROWS, D), bf, dev, 7),
        qkv=_randn((3, D, D), bf, dev, 8),
    )


def kv_inputs(B: int, dev, seed: int = 9):
    """P8's sweep case: fresh K and V rows of 12 layers (as 24 layers) for
    B lanes, a (24, B, 1024, 768) bf16 cache and per-lane n_past in
    [0, 1023] from `seed`."""
    rows = _randn((2 * LAYERS, B, 1, D), torch.bfloat16, dev, seed)
    cache = torch.zeros((2 * LAYERS, B, SEQ, D), dtype=torch.bfloat16,
                        device=dev)
    rng = np.random.default_rng(seed + B)
    off = torch.from_numpy(rng.integers(0, SEQ, size=B).astype(np.int32))
    return rows, off.to(dev), cache


def _copies(t, k: int) -> list:
    """t and k - 1 clones of it: copies of an input for `mean_ms`."""
    return [t] + [t.clone() for _ in range(k - 1)]


def sweep(device="cuda") -> dict:
    """The questions at bark-small sizes, on the card: each probe timed by
    `mean_ms` over copies of its inputs, so that every call reads them from
    device memory (device µs a launch from torch.profiler where launch gaps
    matter), and each row of the kernel table (`rows`) with its
    configuration, ms, plain ms, library ms where one PyTorch call computes
    the same function, and the bytes and operations its function needs."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the sweep times the card: device must be cuda")
    inp = sweep_inputs(dev)
    rec, rows = dict(card=torch.cuda.get_device_name(dev)), {}

    def row(name, config, make, bytes_=0, flops=0, dtype="float32", n=20):
        """make(i) -> (kernel, plain, library or None), each a call on copy
        i of the inputs; `bytes_` is what the function moves."""
        sets = [make(i) for i in range(copies_for(bytes_, n))]
        rows[name] = dict(
            config=config, ms=mean_ms([s[0] for s in sets], n),
            plain_ms=mean_ms([s[1] for s in sets[:copies_for(bytes_, 3)]],
                             3, queue=False),
            library_ms=None if sets[0][2] is None
            else mean_ms([s[2] for s in sets], n),
            bytes=bytes_, flops=flops, dtype=dtype, copies=len(sets))

    # P1: µs a dependent iteration, three ways
    p1 = {}
    for n in WHILE_NS:
        xs = [torch.full((1, 1), n, dtype=torch.int32, device=dev)
              for _ in range(copies_for(8, 5))]
        for method in WHILE_METHODS:
            ms = mean_ms([lambda x=x, m=method: _while(x, m, n) for x in xs],
                         5)
            p1[f"{method} n={n}"] = dict(ms=ms, us_per_iter=ms * 1e3 / n)
        p1[f"host n={n}"]["device_us_per_launch"] = profiled_us(
            lambda: _while(xs[0], "host", n), "while_step", 2)
    rec["P1"] = p1
    row("probe_while_loop", f"block, x = {WHILE_NS[-1]}", lambda i: (
        lambda x=xs[i]: _while(x, "block", 0),
        lambda x=xs[i]: probe_while_loop_plain(x), None),
        bytes_=8, dtype="int32", n=5)

    # P2, P2b: the argmax over the semantic logits, the wte row; each copy
    # of v rolled, so that each reads another row of the table
    wte, b2 = inp["wte"], SEM_LOGITS * 4 + 2 * D * 2
    vs = [torch.roll(inp["v"], 37 * i, 1) for i in range(copies_for(b2, 20))]
    p2 = dict(argmax_us=mean_ms(
        [lambda v=v: probe_vector_to_smem_scalar(v) for v in vs]) * 1e3)
    for method in ROW_METHODS:
        p2[f"{method}_us"] = mean_ms(
            [lambda v=v, m=method: probe_scalar_dma_row(v, wte, 1, m)
             for v in vs]) * 1e3
    rec["P2"] = p2
    row("probe_vector_to_smem_scalar", f"v (1, {SEM_LOGITS}) f32",
        lambda i: (lambda v=vs[i]: probe_vector_to_smem_scalar(v),
                   lambda v=vs[i]: probe_vector_to_smem_scalar_plain(v),
                   None), bytes_=SEM_LOGITS * 4 + 4)
    row("probe_scalar_dma_row",
        f"fused, group 1, v (1, {SEM_LOGITS}) f32, tbl ({SEM_WTE}, {D}) bf16",
        lambda i: (lambda v=vs[i]: probe_scalar_dma_row(v, wte, 1),
                   lambda v=vs[i]: probe_scalar_dma_row_plain(v, wte, 1),
                   None), bytes_=b2, dtype="bfloat16")

    # P3: one block's 60 dependent row reads, the next in flight or not;
    # the strips with every row in flight
    g = inp["noise"]
    b3 = (g.numel() + g.shape[1]) * 4
    gs = _copies(g, copies_for(b3, 20))
    rec["P3"] = {("prefetch" if pf else "serial"): dict(us_per_iter=mean_ms(
        [lambda g=g, pf=pf: probe_dynamic_leading_dma(g, pf, "block")
         for g in gs]) * 1e3 / g.shape[0]) for pf in (False, True)}
    rec["P3"]["strips"] = dict(us=mean_ms(
        [lambda g=g: probe_dynamic_leading_dma(g) for g in gs]) * 1e3)
    row("probe_dynamic_leading_dma", f"strips, g {tuple(g.shape)} f32",
        lambda i: (lambda g=gs[i]: probe_dynamic_leading_dma(g),
                   lambda g=gs[i]: probe_dynamic_leading_dma_plain(g),
                   lambda g=gs[i]: g.sum(0)), bytes_=b3)
    rows["probe_dynamic_leading_dma"]["methods_ms"] = {
        "block serial": rec["P3"]["serial"]["us_per_iter"] * g.shape[0] / 1e3,
        "block prefetch":
            rec["P3"]["prefetch"]["us_per_iter"] * g.shape[0] / 1e3,
        "strips": rec["P3"]["strips"]["us"] / 1e3}

    # P4, P5: the layer loop unrolled or not
    b4, b5 = (2 * LAYERS + 1) * D * 4, (1 + LAYERS) * P5_ROWS * D * 4
    ps = _copies(inp["p"], copies_for(b4, 20))
    xws = _copies(inp["x"], copies_for(b5, 20))
    regs4 = ptxas_info(r"layer_read_kernelILb([01])E")
    regs5 = ptxas_info(r"layer_write_kernelILb([01])E")
    sass4 = sass_lines(r"layer_read_kernelILb([01])E")
    sass5 = sass_lines(r"layer_write_kernelILb([01])E")
    for key, calls, regs, sass in (
            ("P4", lambda u: [lambda p=p: probe_dynamic_vmem_read(p, u)
                              for p in ps], regs4, sass4),
            ("P5", lambda u: [lambda x=x: probe_dynamic_vmem_write(
                x, LAYERS, u) for x in xws], regs5, sass5)):
        rec[key] = {("unrolled" if u else "loop"): dict(
            us=mean_ms(calls(u)) * 1e3, **regs.get(str(int(u)), {}),
            sass_lines=sass.get(str(int(u)))) for u in (False, True)}
    row("probe_dynamic_vmem_read", f"loop, p {tuple(ps[0].shape)} f32",
        lambda i: (lambda p=ps[i]: probe_dynamic_vmem_read(p),
                   lambda p=ps[i]: probe_dynamic_vmem_read_plain(p), None),
        bytes_=b4)
    row("probe_dynamic_vmem_write", f"loop, x {tuple(xws[0].shape)} f32, "
        f"{LAYERS} layers",
        lambda i: (lambda x=xws[i]: probe_dynamic_vmem_write(x, LAYERS),
                   lambda x=xws[i]: probe_dynamic_vmem_write_plain(x, LAYERS),
                   None), bytes_=b5)

    # P6: bark-small's decode weights through a ring, 132 blocks
    w = inp["w"]
    L, T, _, W = w.shape
    blocks, nbytes, b6 = _sm_count(dev), w.numel() * 2, L * T * W * 2 + W * 4
    ws = _copies(w, copies_for(b6, 10))
    p6 = {}
    for ring in (2, 3, 4):
        for pf in (False, True):
            ms = mean_ms([lambda w=w, r=ring, f=pf: probe_dyn_ring_stream(
                w, r, blocks, f) for w in ws], 10)
            gbs = nbytes / (ms * 1e-3) / 1e9
            p6[f"ring {ring} {'prefetch' if pf else 'drain'}"] = dict(
                ms=ms, gbs=gbs, share=gbs * 1e9 / HBM_BYTES_PER_S)
    rec["P6"] = dict(bytes=nbytes, blocks=blocks, tile_kb=32, configs=p6)
    best = max(p6, key=lambda k: p6[k]["gbs"])
    ring, pf = int(best.split()[1]), "prefetch" in best
    row("probe_dyn_ring_stream",
        f"{best}, {blocks} blocks, w {tuple(w.shape)} bf16",
        lambda i: (lambda w=ws[i]: probe_dyn_ring_stream(w, ring, blocks, pf),
                   lambda w=ws[i]: probe_dyn_ring_stream_plain(w, blocks),
                   lambda w=ws[i]: w[:, :, 0].sum(dim=(0, 1),
                                                  dtype=torch.float32)),
        bytes_=b6, dtype="bfloat16", n=10)
    # the like-for-like yardstick: one reduction that reads all of w
    rows["probe_dyn_ring_stream"].update(
        library_full_ms=mean_ms([lambda w=w: w.sum(dtype=torch.float32)
                                 for w in ws], 10),
        library_full_bytes=nbytes)
    del ws

    # P7: a prefill's K/V slab a layer, each copy with its own library out;
    # the ring also at other grids and stage sizes
    slab = inp["slab"]
    b7 = 2 * slab.numel() * 2
    slabs = _copies(slab, copies_for(b7, 20))
    outs = [torch.empty_like(slab) for _ in slabs]
    rec["P7"] = {m: dict(us=mean_ms(
        [lambda s=s, m=m: probe_dynamic_hbm_write(s, method=m)
         for s in slabs]) * 1e3) for m in WRITE_METHODS}
    sms = _sm_count(dev)
    rec["P7"]["ring configs"] = {
        f"{k * sms} blocks, {st} x {kb} KB": dict(us=mean_ms(
            [lambda s=s, c=(k * sms, st, kb * 1024):
             _hbm_write(s, s.shape[0], "ring", c) for s in slabs]) * 1e3)
        for k, st, kb in WRING_CONFIGS}
    rec["P7"]["ring stamps"] = [ring_stamps_us(slabs[i]) for i in range(3)]
    row("probe_dynamic_hbm_write", f"ring, x {tuple(slab.shape)} bf16",
        lambda i: (lambda s=slabs[i]: probe_dynamic_hbm_write(s),
                   lambda s=slabs[i]: probe_dynamic_hbm_write_plain(s),
                   lambda s=slabs[i], o=outs[i]: o.copy_(s)),
        bytes_=b7, dtype="bfloat16")
    rows["probe_dynamic_hbm_write"]["methods_ms"] = {
        m: rec["P7"][m]["us"] / 1e3 for m in WRITE_METHODS}
    del slabs, outs

    # P8: fresh K/V rows at n_past; copy i has its own rows and each lane's
    # n_past moved on by i, so that it writes other rows of the cache
    p8 = {}
    for B in KV_BATCHES:
        rows_, off, cache = kv_inputs(B, dev)
        b8 = 2 * rows_.numel() * 2 + B * 4
        sets = [(r, (off + i) % SEQ) for i, r in
                enumerate(_copies(rows_, copies_for(b8, 20)))]
        p8[f"B={B}"] = {m: dict(us=mean_ms(
            [lambda r=r, o=o, m=m: probe_dynamic_hbm_write_rowoff(
                r, o, cache, align=1, method=m) for r, o in sets]) * 1e3)
            for m in WRITE_METHODS}
        if B == 8:
            li = torch.arange(2 * LAYERS, device=dev)[:, None].expand(-1, B)
            bi = torch.arange(B, device=dev)[None, :].expand(2 * LAYERS, -1)

            def calls8(i):
                r, o = sets[i]
                idx = (li, bi, o.long()[None, :].expand(2 * LAYERS, -1))
                return (lambda: probe_dynamic_hbm_write_rowoff(
                            r, o, cache, align=1),
                        lambda: probe_dynamic_hbm_write_rowoff_plain(
                            r, o, cache, align=1),
                        lambda: cache.index_put_(idx, r[:, :, 0]))

            row("probe_dynamic_hbm_write_rowoff",
                f"bulk, align 1, x {tuple(rows_.shape)} bf16 into "
                f"{tuple(cache.shape)}", calls8, bytes_=b8, dtype="bfloat16")
        del cache
    rec["P8"] = p8

    # P9: qkv as 3 slots, lanes as M
    wt = inp["qkv"]
    p9 = {}
    for M in DOT_MS:
        xm = _randn((M, D), torch.bfloat16, dev, 10 + M)
        flops = 2 * M * 3 * D * D
        b9 = (xm.numel() + wt.numel()) * 2 + M * 3 * D * 4
        k9 = copies_for(b9, 20)
        pairs = list(zip(_copies(xm, k9), _copies(wt, k9)))
        r = {}
        for method in DOT_METHODS:
            us = mean_ms([lambda x=x, w=w, m=method:
                          probe_transposed_group_dot(x, w, m)
                          for x, w in pairs]) * 1e3
            r[method] = dict(us=us, tflops=flops / (us * 1e-6) / 1e12)
        us = mean_ms([lambda x=x, w=w: torch.matmul(x, w.view(3 * D, D).T)
                      for x, w in pairs]) * 1e3
        r["torch.matmul"] = dict(us=us, tflops=flops / (us * 1e-6) / 1e12)
        p9[f"M={M}"] = r
        if M == 8:
            row("probe_transposed_group_dot",
                f"wgmma, x ({M}, {D}) bf16, wt (3, {D}, {D}) bf16",
                lambda i: (lambda x=pairs[i][0], w=pairs[i][1]:
                           probe_transposed_group_dot(x, w, "wgmma"),
                           lambda x=pairs[i][0], w=pairs[i][1]:
                           probe_transposed_group_dot_plain(x, w),
                           lambda x=pairs[i][0], w=pairs[i][1]:
                           torch.matmul(x, w.view(3 * D, D).T)),
                bytes_=b9, flops=flops, dtype="bfloat16")
    rec["P9"] = p9
    rec["rows"] = rows
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bark_tpu_torch.probes.lowering",
        description="P1-P9: the lowering probes of tools/tpu_mosaic_probe.py "
        "as hand-written Hopper kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the questions at bark-small sizes (the "
                    "card only) and print them as one JSON line")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("probes.lowering: no CUDA device", file=sys.stderr)
        return 1
    if args.sweep and dev.type != "cuda":
        print("probes.lowering: --sweep times the card; give --device cuda",
              file=sys.stderr)
        return 1
    print(f"backend: {dev.type}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else ""), flush=True)
    ok = len(run_reference(dev)) == len(NAMES)
    if args.sweep:
        print(json.dumps({"lowering_sweep": sweep(dev)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
