"""K2: causal prefill of a stage's context into its decode caches.

The counterpart of `bark_tpu.kernels.prefill.prefill_fused`. On a CUDA
tensor the wrapper launches the hand-written kernels of `csrc/prefill.cu`
(row LayerNorms; GEMMs with the bias/GELU/residual/K-V-write epilogues,
bf16 on TMA + wgmma, f32 on the CUDA cores; causal attention, bf16 on the
tensor cores; and K1's LM head on the last live row); on a CPU tensor it
runs the plain version, the reference `models.gpt.prefill`.

Only the `n_valid` live rows are computed and written: cache rows past
n_valid keep whatever they held, which the decode contract allows (a row
is admitted by the mask only after a decode step wrote it).

The bf16 GEMMs follow `gemm_plan` (plain Python, so the CPU tests hold
it): each projection's N tile and how many ways its K is split, with the
split partials folded in split order; `planned_matmul` is that arithmetic
in plain PyTorch. The weights' tensor maps are made once per stage and
kept with its weights (`weight_maps`).

Int8 caches (`gpt.init_kv_cache(quant=True)`): the QKV epilogue writes the
K/V rows in the params dtype to scratch, K6b quantizes each into its cache
row, and K6c is the attention (`kernels.kv8`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bark_tpu_torch.kernels import _build, kv8
from bark_tpu_torch.kernels.decode import window_logits
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig

launches = 0  # kernel launches through `prefill_fused`

HEAD_DIM = 64      # the attention kernels' head dim
GEMM_DEPTH = 64    # K of a pipeline stage (csrc/prefill.cu WG_BK)
# the GEMM's output tiles (rows, columns), largest first: a 128 x 128 tile
# runs two consumer warpgroups over shared B boxes, so the operands stream
# from the L2 half as often as in 64 x 64 tiles
GEMM_TILES = ((128, 128), (64, 64))
MAX_SPLITS = 4
H100_SMS = 132
MAP_BYTES = 128    # one CUtensorMap
PROJECTIONS = ("qkv", "proj", "fc", "out")  # the plan's order (P_*)


class GemmPlan(NamedTuple):
    """How the bf16 GEMM covers C (M, N) = A (M, K) @ B (K, N): work
    items (column tile, row tile, split), the column tile fastest; item
    (bx, by, bz) computes rows [bm by, bm by + bm) x columns [bn bx, bn bx
    + bn) over the K range of split bz, and a tile's partials are folded
    in split order 0, 1, ..., splits - 1. The kernel's persistent blocks
    take the items in turn."""

    M: int
    N: int
    K: int
    bm: int       # output rows a tile: 64 or 128
    bn: int       # output columns a tile: as many
    splits: int   # K ranges a tile: 1, 2 or 4
    tiles: int    # output tiles
    blocks: int   # work items: tiles x splits

    def grid(self):
        return (self.N // self.bn, -(-self.M // self.bm), self.splits)

    def block(self, bx: int, by: int, bz: int):
        """(rows, columns, K range) of item (bx, by, bz), as ranges; rows
        are cut at M."""
        k_tiles = self.K // GEMM_DEPTH // self.splits
        m0, n0 = by * self.bm, bx * self.bn
        return (range(m0, min(m0 + self.bm, self.M)),
                range(n0, n0 + self.bn),
                range(bz * k_tiles * GEMM_DEPTH,
                      (bz + 1) * k_tiles * GEMM_DEPTH))


def gemm_plan(M: int, N: int, K: int, sms: int = H100_SMS) -> GemmPlan:
    """The plan of one bf16 projection at M rows on a card of `sms` SMs.
    The GEMM streams its operands from the L2 once per tile, so it takes
    the largest tile (GEMM_TILES) that still gives at least half as many
    tiles as SMs (the smallest, 64 x 64, when none does); then it splits K
    2 or 4 ways while the work items stay within one a SM and each split
    keeps whole 64-deep stages (a split costs its partials' round trip
    through the L2 and the fold: on the card more splits than that were
    slower)."""
    if N % 64 or K % GEMM_DEPTH or M < 1:
        raise ValueError(f"the GEMM takes N and K multiples of 64, got M {M}, "
                         f"N {N}, K {K}")
    for bm, bn in GEMM_TILES:
        tiles = -(-M // bm) * (N // bn)
        if N % bn == 0 and 2 * tiles >= sms:
            break
    splits = 1
    while (2 * splits <= MAX_SPLITS and (K // GEMM_DEPTH) % (2 * splits) == 0
           and tiles * 2 * splits <= sms):
        splits *= 2
    return GemmPlan(M, N, K, bm, bn, splits, tiles, tiles * splits)


def layer_plans(D: int, M: int, sms: int = H100_SMS):
    """The plans of a layer's four projections at M rows, in PROJECTIONS
    order: qkv (N 3D, K D), proj (D, D), fc (4D, D), out (D, 4D)."""
    return [gemm_plan(M, N, K, sms) for N, K in
            ((3 * D, D), (D, D), (4 * D, D), (D, 4 * D))]


def planned_matmul(a, w, plan: GemmPlan):
    """a (M, K) @ w (K, N) in f32 as the planned GEMM sums it: each split's
    K range in f32, the partials added in split order. Returns f32."""
    k = plan.K // plan.splits
    a, w = a.float(), w.float()
    out = torch.matmul(a[:, :k], w[:k])
    for s in range(1, plan.splits):
        out = out + torch.matmul(a[:, s * k:(s + 1) * k], w[s * k:(s + 1) * k])
    return out


def prefill_plain(cfg: GPTConfig, params, x_emb, k_cache, v_cache,
                  n_valid: int, lm_window=None):
    """The plain PyTorch version: `gpt.prefill` over the live rows
    (the causal mask makes later rows invisible to them)."""
    logits = gpt.prefill(cfg, params, x_emb[:n_valid], k_cache, v_cache,
                         n_valid)
    return window_logits(logits, lm_window)


def check_prefill(cfg: GPTConfig, params, x_emb, n_valid, lm_window, *,
                  lanes: int | None = None):
    """Raise ValueError for what the prefill kernels do not take, before
    any launch: params neither f32 nor bf16, head dim != 64, width not a
    multiple of 64, more than 1024 cache slots, x_emb not contiguous
    (T, D) ((lanes, T, D) for K8) in the params dtype on their device,
    n_valid outside [1, min(T, block_size)], lm_window outside the vocab,
    bf16 projection weights not 16-byte aligned (TMA reads them in place).
    Returns (lo, hi)."""
    D, S, V = cfg.n_embd, cfg.block_size, cfg.n_out_vocab
    dtype, device = params["wpe"].dtype, params["wpe"].device
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"the prefill kernels take float32/bfloat16 "
                         f"params, got {dtype}")
    if D % GEMM_DEPTH or D != cfg.n_head * HEAD_DIM:
        raise ValueError(f"the prefill kernels take width % {GEMM_DEPTH} == "
                         f"0 and head dim {HEAD_DIM}, got n_embd {D}, n_head "
                         f"{cfg.n_head}")
    if S > 1024:
        raise ValueError(f"the prefill kernels take <= 1024 cache slots, got "
                         f"{S}")
    dims = 2 if lanes is None else 3
    if (x_emb.dim() != dims or x_emb.shape[-1] != D or x_emb.dtype != dtype
            or x_emb.device != device or not x_emb.is_contiguous()
            or (lanes is not None and x_emb.shape[0] != lanes)):
        want = "(T, D)" if lanes is None else f"({lanes}, T, D)"
        raise ValueError(
            f"x_emb: want contiguous {want} with D {D}, {dtype} on {device}, "
            f"got {tuple(x_emb.shape)} {x_emb.dtype} on {x_emb.device}")
    top = min(x_emb.shape[-2], S)
    if not all(1 <= n <= top for n in n_valid):
        raise ValueError(f"n_valid {n_valid} outside [1, {top}]")
    lo, hi = lm_window if lm_window is not None else (0, V)
    if not 0 <= lo <= hi <= V:
        raise ValueError(f"lm_window {lm_window} outside [0, {V}]")
    if dtype == torch.bfloat16:
        for key in PROJECTIONS:
            if params["blocks"][key + "_w"].data_ptr() % 16:
                raise ValueError(f"{key}_w: the GEMM's tensor maps want it "
                                 f"16-byte aligned")
    return lo, hi


def weight_maps(w):
    """The stage's four projection weights' tensor maps (4 x 128 bytes of
    host memory, `bark_prefill_weight_maps`), made once per stage and kept
    with its weights; None for f32 weights."""
    if w.dtype != torch.bfloat16:
        return None

    def make():
        maps = (ctypes.c_ubyte * (4 * MAP_BYTES))()
        _build.check("bark_prefill_weight_maps",
                     _build.lib().bark_prefill_weight_maps(w.ref, maps))
        return maps

    return w.memo("prefill_maps", make)


def gemm_args(w, M: int):
    """(maps, plan, partials, tickets): the bf16 GEMMs' C arguments at M
    rows (`gemm_plan` for this card, its split partials' f32 scratch and
    tile tickets); Nones for f32 weights."""
    maps = weight_maps(w)
    if maps is None:
        return None, None, None, None
    sms = w.memo("sms", lambda: torch.cuda.get_device_properties(
        w.device).multi_processor_count)
    plans = layer_plans(w.cfg.n_embd, M, sms)
    plan = (ctypes.c_int * 8)(*[v for p in plans for v in (p.bm, p.splits)])
    split = [p for p in plans if p.splits > 1]
    part = w.scratch("p_part", max([p.splits * M * p.N for p in split],
                                   default=1), dtype=torch.float32)
    tickets = w.scratch("p_tickets", max(p.tiles for p in plans),
                        dtype=torch.int32)
    return maps, plan, part.data_ptr(), tickets.data_ptr()


def prefill_fused(cfg: GPTConfig, params, x_emb, k_cache, v_cache,
                  n_valid: int, *, lm_window=None):
    """Prefill rows [0, n_valid) of `x_emb` ((T, D) token embeddings,
    positions not yet added) from n_past 0. Writes cache rows [0, n_valid)
    of every layer in place; returns the (n_out_vocab,) f32 logits of row
    n_valid-1, zero outside lm_window."""
    global launches
    if gpt.kv_device(k_cache).type == "cpu":
        return prefill_plain(cfg, params, x_emb, k_cache, v_cache, n_valid,
                             lm_window)
    lo, hi = check_prefill(cfg, params, x_emb, [n_valid], lm_window)
    caches = _build.check_kv(cfg, params["wpe"].dtype, params["wpe"].device,
                             k_cache, v_cache)
    w = _build.stage_weights(cfg, params)
    V, D, S = cfg.n_out_vocab, cfg.n_embd, cfg.block_size
    maps, plan, part, tickets = gemm_args(w, n_valid)
    logits = torch.empty((V,), dtype=torch.float32, device=w.device)
    rc = _build.lib().bark_prefill(
        w.ref, x_emb.data_ptr(), n_valid, *caches,
        w.scratch("p_x", S, D).data_ptr(),
        w.scratch("p_hb", S, D).data_ptr(), w.scratch("p_q", S, D).data_ptr(),
        w.scratch("p_ctx", S, D).data_ptr(),
        w.scratch("p_ff", S, 4 * D).data_ptr(), kv_rows(w, caches, S),
        maps, plan, part, tickets, logits.data_ptr(), lo, hi,
        _build.stream_ptr(w.device),
    )
    _build.check("prefill_fused", rc)
    launches += 1
    kv8.count(caches)
    return logits


def kv_rows(w, caches, M: int):
    """The (2, M, D) params-dtype scratch the QKV epilogue writes the K/V
    rows to before K6b quantizes them, for int8 caches; None (no scratch)
    for dense ones."""
    if caches[2] is None:
        return None
    return w.scratch("p_kv", 2, M, w.cfg.n_embd).data_ptr()
