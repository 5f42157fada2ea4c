"""K1: one token through every layer of a GPT stage, batch 1; and K5,
the same step on packed-quantized params (a qpack).

The counterpart of `bark_tpu.kernels.decode.decode_step_fused` (and of it
with quant=True). On a CUDA tensor the wrapper launches the hand-written
kernel of `csrc/decode.cu`: ONE cooperative launch a step, a persistent
kernel whose blocks (the card's co-resident count) run embed, L x
[LN1+QKV | attention+proj | LN2+fc | out], ln_f and the LM head, with a
grid-wide barrier between the phases. Which block takes which weight
tile, and the order in which each output's split-K partials are folded,
is `step_plan`'s table, computed here once per stage and window and kept
with the stage's weights, beside a tile-major copy of the weights from
which each block's weight chunks stream as single bulk copies: the four
projection weights in the params dtype (`step_tiles`), or, for a qpack,
the four projection weights and the LM head as records of one 32-row
quant block each, int8 values then scales then mins (`step_qtiles`). A
qpack's step is the same kernel on its packed weight read, launched
through `kernels.qdecode` (K5's launch count). On a CPU tensor the
wrapper runs the plain version, the reference `models.gpt.decode_step`
(which on a qpack computes what K5 computes). There is no other path: a
CUDA tensor the kernel does not take raises (`check_step`, before any
launch), and a launch the card refuses (its blocks must all be resident
at once, so another process holding SMs can refuse it) raises with the
CUDA error.

`lm_window=(lo, hi)`: only those logit columns are computed, the rest are
0 (the coarse sampler reads only its two codebook windows).

K3 and K4 (`kernels.semantic`, `kernels.window`) run the same step in a
loop: `decode_steps_fused` is ONE cooperative launch of a chunk or window
(csrc/decode.cu `decode_steps_kernel`, on the same plan and tiled
weights), step j sampling its token inside the launch (`LoopSample`) from
the logits before it and decoding it at `loop_n_past`. Each block samples
the logits it computed (`sample_slots`); `sample_partials` and
`fold_partials` are the CPU mirror of the kernel's split and fold.
Its launches count in `loop_launches` (a qpack's in
`qdecode.loop_launches`), not in K1's or K5's `launches`.

The caches may be the int8 caches of `gpt.init_kv_cache(quant=True)`: the
same launch then runs K6a's arithmetic (csrc/step.cuh `attend_int8`) as
each layer's attention, dense and packed alike.

The batched step (K7, K5-batched: `kernels.bdecode`, csrc/bdecode.cu)
takes its plan from here too: `lane_plan` (the five products' items and
fold orders, the attention's (head, lane) units; `lane_units` mirrors the
kernel's split of those by each lane's live rows), `lane_tiles` (the
weights in the layout its products read) and `device_lane_plan`; the
stamp splitters below read either plan. Its step loop (K9, K10:
`bdecode.decode_lane_steps`) samples inside the launch with partials keyed
by LM tile: `lane_sample_slots`, `lane_sample_partials` and
`lane_fold_partials` are the CPU mirror of that split and fold, and
`loop_stamps` / `loop_phases_us` serve its stamps too.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from bark_tpu_torch.kernels import _build, kv8, qdecode
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.ops import sampling

# launches of K1's step through `decode_step_fused`, and of the step loop
# (K3, K4) through `decode_steps_fused`, on dense weights (a qpack's counts
# are `qdecode`'s)
launches = 0
loop_launches = 0

HEAD_DIM = 64     # the kernel's head dim
PLAN_TILE = 64    # output columns of a work item
PLAN_ROWS = 8     # K ranges start on, and span, multiples of these rows
QBLOCK = 32       # ... of these rows in a packed plan: whole quant blocks
PLAN_HDR = 24     # ints of the table's header
PLAN_MAX = 8192   # ints of a table the kernel holds in shared memory
PHASES = ("qkv", "proj", "fc", "out")
PHASE_NAMES = ("ln1_qkv", "attention_proj", "ln2_fc", "out")  # their work
# The header's slots, as csrc/decode.cu's `PL_*` enum names them (keep the
# two alike): the grid, the barriers, then per phase (4 slots each, in
# PHASES order) the offsets of its items, block starts, fold offsets and
# fold lists, then of the LM section; the window's lo and hi; the layers;
# whether the LM section holds tiles of a packed head (1) or rows (0).
PL_BLOCKS, PL_BARRIERS, PL_ITEMS, PL_STARTS = 0, 1, 2, 6
PL_FOLD_OFF, PL_FOLD, PL_LM, PL_LO, PL_HI, PL_LAYERS = 10, 14, 18, 19, 20, 21
PL_LM_TILES = 22
WRITES_KV, WRITES_SCALES = 1, 2  # proj items' flags


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Who does what in the persistent decode step (`step_plan`).

    items[p]: phase p's work items (tile, k0, k1, flags) in block order:
      block b takes items[p][starts[p][b]:starts[p][b+1]], rows [k0, k1)
      of the 64 columns of `tile` of the phase's (K, N) weight; item i's
      split-K partial is row i of the phase's partial buffer. Proj items
      lie within one head's 64 rows; flags say which block writes the
      head's K/V cache row (WRITES_KV) and the int8 row scales
      (WRITES_SCALES).
    folds[p][t]: the items of tile t in K order, the order in which the
      next phase sums their partials.
    lm[b]: block b's LM work: the head rows [v0, v1) within lm_window, or
      when `packed`, the 64-column tiles [t0, t1) of the transposed
      packed head, each over all its rows, that cover lm_window.
    packed: a plan for packed weights: K ranges are whole 32-row quant
      blocks (QBLOCK), and the LM section holds tiles.
    """

    n_blocks: int
    n_layer: int
    n_barriers: int
    lm_window: tuple
    items: tuple
    starts: tuple
    folds: tuple
    lm: tuple
    packed: bool = False

    phase_names = PHASE_NAMES  # the work between its barriers, a layer

    @property
    def partial_floats(self) -> int:
        """f32 of one partial buffer: the most items of a phase, a row
        of PLAN_TILE each."""
        return PLAN_TILE * max(len(items) for items in self.items)

    def table(self) -> np.ndarray:
        """The int32 table csrc/decode.cu reads: the header (blocks,
        barriers, per phase the offsets of its items, block starts, fold
        offsets and fold lists, then of the LM section, lo, hi, layers,
        the LM section's kind), then the sections."""
        hdr = [0] * PLAN_HDR
        hdr[PL_BLOCKS], hdr[PL_BARRIERS] = self.n_blocks, self.n_barriers
        hdr[PL_LO], hdr[PL_HI] = self.lm_window
        hdr[PL_LAYERS] = self.n_layer
        hdr[PL_LM_TILES] = int(self.packed)
        body = []

        def put(slot, values):
            hdr[slot] = PLAN_HDR + len(body)
            body.extend(values)

        for p in range(len(PHASES)):
            put(PL_ITEMS + p, [v for it in self.items[p] for v in it])
            put(PL_STARTS + p, self.starts[p])
            offs = [0]
            for f in self.folds[p]:
                offs.append(offs[-1] + len(f))
            put(PL_FOLD_OFF + p, offs)
            put(PL_FOLD + p, [i for f in self.folds[p] for i in f])
        put(PL_LM, [v for r in self.lm for v in r])
        return np.asarray(hdr + body, dtype=np.int32)


def _split(n: int, parts: int) -> list:
    """parts + 1 bounds cutting range(n) into near-equal runs."""
    return [i * n // parts for i in range(parts + 1)]


def _runs(u0: int, u1: int, per_tile: int, rows: int, row0: int = 0):
    """Items (tile, k0, k1, 0) of the units [u0, u1) of a sequence that
    walks tile by tile, `rows` rows a unit, per_tile units a tile, its
    rows counted from row0."""
    out = []
    u = u0
    while u < u1:
        t, r = divmod(u, per_tile)
        end = min(u1, (t + 1) * per_tile)
        out.append((t, row0 + rows * r, row0 + rows * (end - t * per_tile),
                    0))
        u = end
    return out


def _generic_phase(K: int, N: int, G: int, rows: int, cap=None,
                   tile0: int = 0):
    """Blocks take near-equal runs of the (tile, `rows`-row unit)
    sequence; with `cap`, an item spans at most that many rows (a longer
    run is cut into several); tiles are numbered from tile0."""
    per = K // rows
    bounds = _split((N // PLAN_TILE) * per, G)
    items, starts = [], [0]
    for b in range(G):
        for t, k0, k1, f in _runs(bounds[b], bounds[b + 1], per, rows):
            step = cap or k1 - k0
            items += [(tile0 + t, k, min(k1, k + step), f)
                      for k in range(k0, k1, step)]
        starts.append(len(items))
    return items, starts


def _proj_phase(D: int, H: int, G: int, rows: int):
    """Proj items lie within one head's 64 rows, so that a block attends
    only the heads its items need: with G >= H blocks, head h gets its own
    near-equal share of the blocks; with fewer, blocks take near-equal
    runs of the (head, tile, `rows`-row unit) sequence."""
    T, per = D // PLAN_TILE, HEAD_DIM // rows
    units = T * per  # a head's
    items, starts = [], [0]

    def head_runs(h, u0, u1):
        return _runs(u0, u1, per, rows, row0=HEAD_DIM * h)

    if G >= H:
        groups = _split(G, H)
        for h in range(H):
            g = groups[h + 1] - groups[h]
            bounds = _split(units, g)
            for j in range(g):
                items += head_runs(h, bounds[j], bounds[j + 1])
                starts.append(len(items))
    else:
        bounds = _split(H * units, G)
        for b in range(G):
            u = bounds[b]
            while u < bounds[b + 1]:
                h = u // units
                end = min(bounds[b + 1], (h + 1) * units)
                items += head_runs(h, u - h * units, end - h * units)
                u = end
            starts.append(len(items))
    flagged = []
    for tile, k0, k1, _ in items:
        first = tile == 0 and k0 % HEAD_DIM == 0
        flags = (WRITES_KV | (WRITES_SCALES if k0 == 0 else 0)) if first \
            else 0
        flagged.append((tile, k0, k1, flags))
    return flagged, starts


def _folds(items, n_tiles: int):
    per_tile = [[] for _ in range(n_tiles)]
    for i, (tile, k0, _, _) in enumerate(items):
        per_tile[tile].append((k0, i))
    return tuple(tuple(i for _, i in sorted(f)) for f in per_tile)


def step_plan(cfg: GPTConfig, n_blocks: int, lm_window=None,
              packed: bool = False) -> StepPlan:
    """The persistent step's plan for `n_blocks` blocks: for each phase of
    a layer (LN1+QKV, attention+proj, LN2+fc, out; the same every layer)
    and for the LM head over lm_window (default: all n_out_vocab rows),
    which block takes which (column tile, K range) work item, each tile's
    fold order, and the barriers a step takes (4 a layer). Blocks take
    near-equal runs of 8-row units, so each phase's bytes are balanced.

    packed: the plan of K5's packed read. Its units are whole 32-row
    quant blocks, so that an item's min term pairs whole blocks of its
    rows with whole rows of the mins; its LM work is the 64-column tiles
    of the transposed packed head that cover lm_window, whole, in
    near-equal runs of tiles (an item writes its logits, so nothing is
    folded)."""
    D, H = cfg.n_embd, cfg.n_head
    if D % PLAN_TILE or D != H * HEAD_DIM or n_blocks < 1:
        raise ValueError(f"step_plan takes width % {PLAN_TILE} == 0, head "
                         f"dim {HEAD_DIM} and >= 1 block, got {cfg}, "
                         f"{n_blocks} blocks")
    lo, hi = lm_window if lm_window is not None else (0, cfg.n_out_vocab)
    if not 0 <= lo <= hi <= cfg.n_out_vocab:
        raise ValueError(f"lm_window {lm_window} outside "
                         f"[0, {cfg.n_out_vocab}]")
    rows = QBLOCK if packed else PLAN_ROWS
    shapes = {"qkv": (D, 3 * D), "fc": (D, 4 * D), "out": (4 * D, D)}
    items, starts, folds = [], [], []
    for name in PHASES:
        if name == "proj":
            it, st = _proj_phase(D, H, n_blocks, rows)
            n_tiles = D // PLAN_TILE
        else:
            K, N = shapes[name]
            it, st = _generic_phase(K, N, n_blocks, rows)
            n_tiles = N // PLAN_TILE
        items.append(tuple(it))
        starts.append(tuple(st))
        folds.append(_folds(it, n_tiles))
    # the LM section: vocab rows, or the packed head's column tiles
    first = lo // PLAN_TILE if packed else lo
    bounds = _split((-(-hi // PLAN_TILE) if packed else hi) - first,
                    n_blocks)
    lm = tuple((first + bounds[b], first + bounds[b + 1])
               for b in range(n_blocks))
    return StepPlan(n_blocks=n_blocks, n_layer=cfg.n_layer,
                    n_barriers=len(PHASES) * cfg.n_layer,
                    lm_window=(lo, hi), items=tuple(items),
                    starts=tuple(starts), folds=tuple(folds), lm=lm,
                    packed=packed)


# ------------------------------------------------------------ the lane plan

MAX_LANES = 32   # lanes the batched step takes (csrc/lane.cuh MAX_LANES)
LANE_UNIT = 16   # a dense lane plan's K ranges: multiples of mma's k16
LANE_ROWS = 512  # most rows an item spans: its inputs' room in shared
                 # memory (csrc/lane.cuh LANE_ROWS)
ATT_COST = 128   # a (head, lane) unit's cost beside its live rows
MAX_OWN = 16     # items of a product a block of the kernel holds
MAX_UNITS = 512  # (head, lane) units a step takes: one a thread
LANE_PHASES = PHASES + ("lm",)  # the products of the batched step
# its stamped work between barriers, a layer (the embed's barrier aside)
LANE_PHASE_NAMES = ("ln1_qkv", "attention", "proj", "ln2_fc", "out")
# The lane plan table's header slots, as csrc/lane.cuh's `LP_*` enum
# names them (keep the two alike): the grid, the barriers, the layers, the
# lanes, lo, hi, whether the plan is packed, the offset and count of its
# (head, lane) pairs, then per product (5 slots each, in LANE_PHASES
# order) the offsets of its items, block starts, fold offsets and fold
# lists, its first tile and its tiles.
LP_BLOCKS, LP_BARRIERS, LP_LAYERS, LP_LANES, LP_LO, LP_HI = 0, 1, 2, 3, 4, 5
LP_PACKED, LP_PAIRS, LP_NPAIRS, LP_ITEMS, LP_STARTS = 6, 7, 8, 9, 14
LP_FOLD_OFF, LP_FOLD, LP_TILE0, LP_NTILES, LP_HDR = 19, 24, 29, 34, 40


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """Who does what in the batched step (`lane_plan`), for n_lanes lanes.

    items[p], starts[p], folds[p]: as StepPlan's, for the five products of
      LANE_PHASES (qkv, proj, fc, out of each layer, then the LM head
      over lm_window); tile0[p] is the first tile of product p (the LM
      head's: the 64-column tile of its transposed copy that holds lo),
      folds[p] are indexed from it. An item's partial is n_lanes rows of
      64 (lane-major), and the last block to write one of a tile folds
      the tile in the fold order.
    pairs: the (head, lane) units of each layer's attention, in the order
      the blocks split them by cost (`lane_units`).
    packed: K ranges are whole 32-row quant blocks, else multiples of 16
      rows (mma's k16).
    """

    n_blocks: int
    n_layer: int
    n_lanes: int
    lm_window: tuple
    items: tuple
    starts: tuple
    folds: tuple
    tile0: tuple
    pairs: tuple
    packed: bool = False

    phase_names = LANE_PHASE_NAMES

    @property
    def n_barriers(self) -> int:
        """Grid barriers a step: the embed's, then 5 a layer."""
        return len(LANE_PHASE_NAMES) * self.n_layer + 1

    @property
    def partial_floats(self) -> int:
        """f32 of the partials: the most items of a product, n_lanes rows
        of PLAN_TILE each."""
        return PLAN_TILE * self.n_lanes * max(len(it) for it in self.items)

    @property
    def max_own(self) -> int:
        """The most items of a product one block takes."""
        return max(b - a for st in self.starts for a, b in zip(st, st[1:]))

    @property
    def n_tickets(self) -> int:
        """Tickets the step's folds take: the most tiles of a product."""
        return max(1, max(len(f) for f in self.folds))

    def table(self) -> np.ndarray:
        """The int32 table csrc/lane.cuh reads: the header (`LP_*`),
        then the sections."""
        hdr = [0] * LP_HDR
        hdr[LP_BLOCKS], hdr[LP_BARRIERS] = self.n_blocks, self.n_barriers
        hdr[LP_LAYERS], hdr[LP_LANES] = self.n_layer, self.n_lanes
        hdr[LP_LO], hdr[LP_HI] = self.lm_window
        hdr[LP_PACKED], hdr[LP_NPAIRS] = int(self.packed), len(self.pairs)
        body = []

        def put(slot, values):
            hdr[slot] = LP_HDR + len(body)
            body.extend(values)

        put(LP_PAIRS, [v for pair in self.pairs for v in pair])
        for p in range(len(LANE_PHASES)):
            put(LP_ITEMS + p, [v for it in self.items[p] for v in it])
            put(LP_STARTS + p, self.starts[p])
            offs = [0]
            for f in self.folds[p]:
                offs.append(offs[-1] + len(f))
            put(LP_FOLD_OFF + p, offs)
            put(LP_FOLD + p, [i for f in self.folds[p] for i in f])
            hdr[LP_TILE0 + p] = self.tile0[p]
            hdr[LP_NTILES + p] = len(self.folds[p])
        return np.asarray(hdr + body, dtype=np.int32)


def lane_plan(cfg: GPTConfig, n_blocks: int, n_lanes: int, lm_window=None,
              packed: bool = False) -> LanePlan:
    """The batched step's plan for `n_blocks` blocks and `n_lanes` lanes:
    for each product (qkv, proj, fc, out of a layer, the same every layer,
    then the LM head over the 64-column tiles that cover lm_window) which
    block takes which (column tile, K range) item, in near-equal runs of
    16-row units (whole 32-row quant blocks when `packed`), no item over
    LANE_ROWS rows, and each tile's fold order; the (head, lane) units of
    the attention, lane by lane. Raises for what the kernel does not take:
    a width not a multiple of 64, head dim != 64, no block, lanes outside
    [1, 32], more than 512 units, a window outside the vocab."""
    D, H = cfg.n_embd, cfg.n_head
    if D % PLAN_TILE or D != H * HEAD_DIM or n_blocks < 1:
        raise ValueError(f"lane_plan takes width % {PLAN_TILE} == 0, head "
                         f"dim {HEAD_DIM} and >= 1 block, got {cfg}, "
                         f"{n_blocks} blocks")
    if not 1 <= n_lanes <= MAX_LANES or H * n_lanes > MAX_UNITS:
        raise ValueError(f"lane_plan takes 1 to {MAX_LANES} lanes and at "
                         f"most {MAX_UNITS} (head, lane) units, got "
                         f"{n_lanes} lanes of {H} heads")
    lo, hi = lm_window if lm_window is not None else (0, cfg.n_out_vocab)
    if not 0 <= lo <= hi <= cfg.n_out_vocab:
        raise ValueError(f"lm_window {lm_window} outside "
                         f"[0, {cfg.n_out_vocab}]")
    rows = QBLOCK if packed else LANE_UNIT
    t0 = lo // PLAN_TILE
    shapes = {"qkv": (D, 3 * D), "proj": (D, D), "fc": (D, 4 * D),
              "out": (4 * D, D),
              "lm": (D, (-(-hi // PLAN_TILE) - t0) * PLAN_TILE)}
    items, starts, folds, tile0 = [], [], [], []
    for name in LANE_PHASES:
        K, N = shapes[name]
        first = t0 if name == "lm" else 0
        it, st = _generic_phase(K, N, n_blocks, rows, LANE_ROWS, first)
        items.append(tuple(it))
        starts.append(tuple(st))
        folds.append(_folds([(t - first, *rest) for t, *rest in it],
                            N // PLAN_TILE))
        tile0.append(first)
    pairs = tuple((h, b) for b in range(n_lanes) for h in range(H))
    return LanePlan(n_blocks=n_blocks, n_layer=cfg.n_layer,
                    n_lanes=n_lanes, lm_window=(lo, hi), items=tuple(items),
                    starts=tuple(starts), folds=tuple(folds),
                    tile0=tuple(tile0), pairs=pairs, packed=packed)


def lane_units(plan: LanePlan, n_past, block_size: int) -> list:
    """The (head, lane) units each block attends, as the kernel splits
    them from each lane's slot (csrc/lane.cuh `assign_units`): the
    plan's pairs in order, pair i costing its lane's live rows n_past + 1
    (0 for a slot outside the cache) + ATT_COST, go to the block that
    holds the midpoint of its cost. Returns each block's [p0, p1)."""
    cost = [(n + 1 if 0 <= n < block_size else 0) + ATT_COST
            for n in (int(n_past[b]) for _, b in plan.pairs)]
    total, before, owners = sum(cost), 0, []
    for c in cost:
        owners.append((2 * before + c) * plan.n_blocks // (2 * total))
        before += c
    return [(sum(o < g for o in owners), sum(o <= g for o in owners))
            for g in range(plan.n_blocks)]


def lane_work_floats(cfg: GPTConfig, plan: LanePlan) -> int:
    """f32 of the batched step's work buffer (csrc/lane.cuh
    `lane_rows_floats` + the partials): x (B, D), qkv (B, 3D), ctx (B, D),
    h (B, 4D), the residual's tile statistics (D/64, B, 2), the K and V
    tiles' amax (2D/64, B), then the partials."""
    B, D = plan.n_lanes, cfg.n_embd
    return (B * 9 * D + (D // PLAN_TILE) * B * 2 + (2 * D // PLAN_TILE) * B
            + plan.partial_floats)


def check_step(cfg: GPTConfig, params, k_cache, v_cache, n_past: int,
               lm_window=None):
    """Raise ValueError for what the step's kernels do not take: head
    dim != 64, width not a multiple of 64, more than 1024 cache slots,
    n_past outside the cache, lm_window outside the vocab, caches that
    are not the stage's (dense in the params dtype, or both int8 with
    their row scales), or a qpack in a form the packed read does not take
    (scales neither f16 nor f32, no single transposed LM head). Returns
    the caches' pointers (`_build.check_kv`)."""
    D = cfg.n_embd
    if D % PLAN_TILE or D != cfg.n_head * HEAD_DIM:
        raise ValueError(f"the decode kernels take width % {PLAN_TILE} == 0 "
                         f"and head dim {HEAD_DIM}, got n_embd {D}, n_head "
                         f"{cfg.n_head}")
    if cfg.block_size > 1024:
        raise ValueError(f"the decode kernels take <= 1024 cache slots, got "
                         f"{cfg.block_size}")
    if not 0 <= n_past < cfg.block_size:
        raise ValueError(f"n_past {n_past} outside [0, {cfg.block_size})")
    V = cfg.n_out_vocab
    lo, hi = lm_window if lm_window is not None else (0, V)
    if not 0 <= lo <= hi <= V:
        raise ValueError(f"lm_window {lm_window} outside [0, {V}]")
    if gpt.is_qpack(params):
        _build.check_qpack_form(cfg, params)
    return _build.check_kv(cfg, params["wpe"].dtype, params["wpe"].device,
                           k_cache, v_cache)


def step_blocks(w) -> int:
    """The persistent step's grid for the stage weights `w` (dense, or the
    packed read of its qpack's format): its blocks the card holds at once
    (asked once per stage)."""
    cfg = w.cfg

    def ask():
        n = _build.lib().bark_decode_step_blocks(
            _build.DTYPE_CODES[w.dtype],
            w.struct.scale_dtype if w.packed else -1,
            w.struct.has_min if w.packed else 0, cfg.n_embd, cfg.block_size)
        if n <= 0:
            raise RuntimeError(
                f"decode_step_fused: the card takes no cooperative grid of "
                f"the step's kernel for {cfg} (code {n})")
        return n

    return w.memo("step_blocks", ask)


def step_tiles(w, params):
    """The stage's four projection weights laid out tile-major for the
    persistent step, (L, N / 64, K, 64) each, so that a chunk of a work
    item's rows is one contiguous bulk copy: a second copy of the weights
    on the card, kept with the stage weights `w` and made again when a
    weight was changed in place (its version counter moved). Returns the
    ctypes array of their four pointers (qkv, proj, fc, out). (2-D TMA
    boxes read in place from the row-major weights were measured instead
    and made the step 43% slower on an H100: PERF.md.)"""
    weights = [params["blocks"][key + "_w"] for key in PHASES]
    versions = tuple(W._version for W in weights)
    held = w.memo("step_tiles", dict)
    if held.get("versions") != versions:
        tiled = []
        for W in weights:
            L, K, N = W.shape
            tiled.append(W.view(L, K, N // PLAN_TILE, PLAN_TILE)
                         .permute(0, 2, 1, 3).contiguous())
        held.update(versions=versions, tiled=tiled, ptrs=(
            ctypes.c_void_p * len(tiled))(*(t.data_ptr() for t in tiled)))
    return held["ptrs"]


QTILED = PHASES + ("lm",)  # the qpack weights `step_qtiles` lays out


def qtile_records(q, s, m=None, frag: bool = False):
    """A packed (..., K, N) weight (int8 values q, (..., K/32, N) scales s
    and mins m or None) as K5's records, (..., N/64, K/32, rec) uint8: a
    record is one 32-row quant block of a 64-column tile, its 32 x 64
    values row by row, then its 64 scales, then its 64 mins, rec = 2048 +
    64 x the scale's bytes (x 2 with mins), a multiple of 16. So any run
    of whole quant blocks of a tile is one contiguous, 16-byte-aligned run
    of bytes. `frag`: the batched step's bf16 records, whose values are in
    mma's A-fragment order instead (`frag_order`: per m16 tile of 16
    columns, each of the 32 threads' 16 values of the block's two k16
    steps, one 16-byte load)."""
    *lead, K, N = q.shape
    nb, nt = K // QBLOCK, N // PLAN_TILE
    vals = (frag_order(q, QBLOCK) if frag else
            q.reshape(*lead, nb, QBLOCK, nt, PLAN_TILE).movedim(-2, -4))
    parts = [vals.reshape(*lead, nt, nb, QBLOCK * PLAN_TILE)
             .view(torch.uint8)]
    for t in (s,) if m is None else (s, m):
        parts.append(t.reshape(*lead, nb, nt, PLAN_TILE).movedim(-2, -3)
                     .contiguous().view(torch.uint8))
    return torch.cat(parts, dim=-1)


def step_qtiles(w, params):
    """`step_tiles` for a qpack: its four projection weights and its
    transposed (D, v_pad) LM head as K5's records (`qtile_records`),
    (L, N/64, K/32, rec) and (v_pad/64, D/32, rec) bytes, so that a chunk
    of up to 8 quant blocks of a work item is one bulk copy: a second
    copy of the packed weights on the card, kept with the stage weights
    `w` and made again when one of them was changed in place. Returns the
    ctypes array of the five pointers (qkv, proj, fc, out, lm)."""
    blocks = params["blocks"]
    src = [tuple((blocks if key in PHASES else params).get(f"{key}_{part}")
                 for part in "qsm") for key in QTILED]
    versions = tuple(t._version for trio in src for t in trio
                     if t is not None)
    held = w.memo("step_qtiles", dict)
    if held.get("versions") != versions:
        tiled = [qtile_records(*trio) for trio in src]
        held.update(versions=versions, tiled=tiled, ptrs=(
            ctypes.c_void_p * len(tiled))(*(t.data_ptr() for t in tiled)))
    return held["ptrs"]


def frag_order(W, rows: int):
    """A (..., K, N) weight's values in the order the batched step's
    mma.sync m16n8k16 reads them as its A operand (A = the tile's
    transpose: columns as rows, K rows as its K side), per 64-column tile
    and `rows`-row group (16: a dense tile's k16 step; 32: a packed
    record's two): 4 m16 tiles, then thread 4 g + t of the warp, then its
    values (k16 step s, K half kh, column half mh, pair kl): column 16 mt +
    8 mh + g, row 16 s + 8 kh + 2 t + kl of the group. Returns (..., N/64,
    K/rows, 4, 32, rows / 2) in W's dtype, contiguous."""
    *lead, K, N = W.shape
    ks = rows // 16
    x = W.reshape(-1, K // rows, ks, 2, 4, 2, N // PLAN_TILE, 4, 2, 8)
    # (P, grp, s, kh, t, kl, nt, mt, mh, g) -> (P, nt, grp, mt, g, t, s,
    # kh, mh, kl)
    x = x.permute(0, 6, 1, 7, 9, 4, 2, 3, 8, 5).contiguous()
    return x.reshape(*lead, N // PLAN_TILE, K // rows, 4, 32, rows // 2)


def lane_blocks(w) -> int:
    """The batched step's grid for the stage weights `w` (dense, or the
    packed read of its qpack's format): the blocks the card holds at once
    of both its kernels, the single step (K7) and the step loop (K9, K10),
    which share its lane plans (asked once per stage)."""
    cfg = w.cfg

    def ask():
        lib = _build.lib()
        n = min(fn(_build.DTYPE_CODES[w.dtype],
                   w.struct.scale_dtype if w.packed else -1,
                   w.struct.has_min if w.packed else 0, cfg.n_embd,
                   cfg.block_size)
                for fn in (lib.bark_decode_lanes_blocks,
                           lib.bark_decode_lane_steps_blocks))
        if n <= 0:
            raise RuntimeError(
                f"decode_step_fused_batched: the card takes no cooperative "
                f"grid of the batched step's kernel for {cfg} (code {n})")
        return n

    return w.memo("lane_blocks", ask)


def lane_tiles(w, params):
    """The weights as the batched step streams them, kept with the stage
    weights `w` and made again when one was changed in place: the four
    projection weights and the LM head's transpose (D, v_pad), tile-major,
    (L, N/64, K, 64) and (v_pad/64, D, 64). In bf16 each 16-row group of a
    tile is in mma's fragment order (`frag_order`), and a qpack's records
    too (`qtile_records(frag=True)`); in f32 (CUDA-core FMAs) a dense
    tile's rows are K1's (`step_tiles`' layout) and a qpack's records are
    K5's, shared with it (`step_qtiles`). A dense LM head is padded with
    zero columns to a multiple of 64. Returns the ctypes array of the five
    pointers (qkv, proj, fc, out, lm)."""
    frag = w.dtype == torch.bfloat16
    if w.packed and not frag:
        return step_qtiles(w, params)
    if w.packed:
        blocks = params["blocks"]
        src = [tuple((blocks if key in PHASES else params).get(
            f"{key}_{part}") for part in "qsm") for key in QTILED]
    else:
        src = [(params["blocks"][key + "_w"],) for key in PHASES]
        src.append((params["lm_head"],))
    versions = tuple(t._version for trio in src for t in trio
                     if t is not None)
    held = w.memo("lane_tiles", dict)
    if held.get("versions") != versions:
        if w.packed:
            tiled = [qtile_records(*trio, frag=True) for trio in src]
        else:
            head = params["lm_head"][0]
            V, D = head.shape
            head_t = head.new_zeros(D, -(-V // PLAN_TILE) * PLAN_TILE)
            head_t[:, :V] = head.t()
            tiled = [frag_order(W, LANE_UNIT) if frag else
                     W.unflatten(-1, (-1, PLAN_TILE)).transpose(-3, -2)
                     .contiguous() for W in [t for t, in src[:4]] + [head_t]]
        held.update(versions=versions, tiled=tiled, ptrs=(
            ctypes.c_void_p * len(tiled))(*(t.data_ptr() for t in tiled)))
    return held["ptrs"]


def device_lane_plan(w, n_lanes: int, lm_window):
    """(LanePlan, its int32 table on the card) for the stage weights `w`
    (the packed plan for a qpack's), n_lanes lanes and lm_window, made
    once and kept with the weights."""
    lo, hi = lm_window if lm_window is not None else (0, w.cfg.n_out_vocab)

    def make():
        plan = lane_plan(w.cfg, lane_blocks(w), n_lanes, (lo, hi),
                         packed=w.packed)
        if plan.max_own > MAX_OWN:
            raise ValueError(f"lane plan for {w.cfg} on {plan.n_blocks} "
                             f"blocks: a block takes {plan.max_own} items "
                             f"of a product, the kernel holds {MAX_OWN}")
        return plan, _build.device_ints(plan.table().tolist(), w.device)

    return w.memo(("lane_plan", n_lanes, lo, hi), make)


def device_plan(w, lm_window):
    """(StepPlan, its int32 table on the card) for the stage weights `w`
    (the packed plan for a qpack's) and lm_window, made once and kept with
    the weights."""
    lo, hi = lm_window if lm_window is not None else (0, w.cfg.n_out_vocab)

    def make():
        plan = step_plan(w.cfg, step_blocks(w), (lo, hi), packed=w.packed)
        table = plan.table()
        if len(table) > PLAN_MAX:
            raise ValueError(f"step plan of {len(table)} ints for {w.cfg}: "
                             f"the kernel holds at most {PLAN_MAX}")
        return plan, _build.device_ints(table.tolist(), w.device)

    return w.memo(("step_plan", lo, hi), make)


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


def _stage_launch(cfg: GPTConfig, params, logits, lm_window):
    """What a launch of the persistent step (K1, K5) and one of its loop
    (K3, K4) share, for the stage of `params` (dense, or a qpack's packed
    read) on the card: (packed, stage weights, plan, head, scratch). head:
    the weights, the tiles' pointers, the plan's table, its ints and the
    grid; scratch: the partials' buffers, their floats and the barrier
    count. The f32 output `logits` and the LM head's alignment are checked
    before the plan is made (which asks the card for the grid)."""
    packed = gpt.is_qpack(params)
    w = (_build.stage_qweights if packed else _build.stage_weights)(
        cfg, params)
    _build.f32_on(logits, w.device, cfg.n_out_vocab, "logits")
    if not packed and params["lm_head"].data_ptr() % 16:
        raise ValueError("lm_head: the step's bulk copies want it 16-byte "
                         "aligned")
    plan, table = device_plan(w, lm_window)
    cap = plan.partial_floats
    tiles = (step_qtiles if packed else step_tiles)(w, params)
    head = (w.ref, ctypes.addressof(tiles), table.data_ptr(), table.numel(),
            plan.n_blocks)
    scratch = (w.scratch("step_partial", 2 * cap,
                         dtype=torch.float32).data_ptr(), cap,
               w.scratch("step_count", 1, dtype=torch.int32).data_ptr())
    return packed, w, plan, head, scratch


def decode_step_fused(cfg: GPTConfig, params, token, k_cache, v_cache,
                      n_past: int, *, lm_window=None, out=None, stamps=None):
    """One decode step: writes K/V row `n_past` of every layer of the
    (L, S, D) caches (dense or int8) in place and returns the
    (n_out_vocab,) f32 logits (into `out` when given). `token` is an int
    or a one-element int tensor; `n_past` a Python int in
    [0, block_size). `stamps`: an int64 CUDA tensor (`step_stamps`) that
    the kernel (dense or packed) fills with every block's ns clock
    (`step_phases_us` and `step_critical_us` split them), or None."""
    global launches
    if gpt.kv_device(k_cache).type == "cpu":
        return decode_step_plain(cfg, params, token, k_cache, v_cache,
                                 n_past, lm_window)
    caches = check_step(cfg, params, k_cache, v_cache, n_past, lm_window)
    if out is None:
        out = torch.empty((cfg.n_out_vocab,), dtype=torch.float32,
                          device=params["wpe"].device)
    packed, w, plan, head, scratch = _stage_launch(cfg, params, out,
                                                   lm_window)
    tok = _token_on(token, w.device)
    want = plan.n_blocks * (2 * plan.n_barriers + 3)
    if stamps is not None and (
            stamps.dtype != torch.int64 or stamps.device != w.device
            or not stamps.is_contiguous() or stamps.numel() < want):
        raise ValueError(f"stamps: want a contiguous int64 tensor of >= "
                         f"{want} on {w.device} (`step_stamps`)")
    args = (*head, tok.data_ptr(), n_past, *caches, *scratch,
            None if stamps is None else stamps.data_ptr(), out.data_ptr(),
            _build.stream_ptr(w.device))
    if packed:
        qdecode.decode_step_packed(args)
    else:
        _build.check("decode_step_fused", _build.lib().bark_decode_step(*args))
        launches += 1
    kv8.count(caches)
    return out


def _stamped(plan) -> int:
    """The barriers a step of `plan` stamps: its layers' (every barrier of
    K1's plan; all but the embed's of a lane plan)."""
    return len(plan.phase_names) * plan.n_layer


def step_stamps(plan, device) -> torch.Tensor:
    """Zeroed stamps for a step of `plan` (K1's StepPlan or the batched
    step's LanePlan): a row a block, its ns clock at the start, after the
    embed, at each layer barrier's arrival and release, and at the end
    (2 x those barriers + 3)."""
    return torch.zeros((plan.n_blocks, 2 * _stamped(plan) + 3),
                       dtype=torch.int64, device=device)


def _stamp_rows(plan, stamps, blocks: int):
    """(start, embed, arrivals (blocks, barriers), releases, end) of the
    first `blocks` rows of the stamps, as int64 CPU tensors."""
    per = 2 * _stamped(plan) + 3
    t = torch.as_tensor(stamps).reshape(-1)[:blocks * per]
    t = t.reshape(blocks, per).to("cpu", torch.int64)
    return t[:, 0], t[:, 1], t[:, 2:-1:2], t[:, 3::2], t[:, -1]


def step_phases_us(plan, stamps) -> dict:
    """Where one stamped step's time went, in µs, from block 0's clock
    (its row of `stamps` as `decode_step_fused` filled them): the embed;
    each phase's own work (from its barrier's release, or the embed, to its
    arrival), as the mean over layers; the barrier waits (arrival to
    release), the mean over all; the LM head (the last release to the
    end); and the whole step."""
    start, embed, arrive, release, end = (
        x[0] for x in _stamp_rows(plan, stamps, 1))
    begin = torch.cat([embed[None], release[:-1]])
    work = (arrive - begin).double().reshape(plan.n_layer,
                                             len(plan.phase_names))
    out = {"embed": float(embed - start) / 1e3}
    for name, us in zip(plan.phase_names, work.mean(0) / 1e3):
        out[name] = float(us)
    out["barrier_wait"] = float((release - arrive).double().mean()) / 1e3
    out["lm_head"] = float(end - release[-1]) / 1e3
    out["step"] = float(end - start) / 1e3
    return out


def step_critical_us(plan, stamps) -> dict:
    """Where one stamped step's time went on its slowest blocks, in µs,
    from every block's row of `stamps`: for each phase, as the mean over
    layers, the slowest block's work (its release, or embed, to its
    arrival), the blocks' mean work, and the spread of their arrivals (the
    last's less the first's); the slowest embed and LM head; and the step
    (the last end less the first start)."""
    start, embed, arrive, release, end = _stamp_rows(plan, stamps,
                                                     plan.n_blocks)
    begin = torch.cat([embed[:, None], release[:, :-1]], dim=1)
    L, P = plan.n_layer, len(plan.phase_names)
    work = (arrive - begin).double().reshape(-1, L, P) / 1e3
    spread = (arrive.amax(0) - arrive.amin(0)).double().reshape(L, P) / 1e3
    out = {}
    for p, name in enumerate(plan.phase_names):
        out[name] = dict(slowest=float(work[:, :, p].amax(0).mean()),
                         mean=float(work[:, :, p].mean()),
                         arrival_spread=float(spread[:, p].mean()))
    out["embed_slowest"] = float((embed - start).amax()) / 1e3
    out["lm_head_slowest"] = float((end - release[:, -1]).amax()) / 1e3
    out["step"] = float(end.amax() - start.amin()) / 1e3
    return out


# ------------------------------------------------------------ the step loop

LOOP_STAMP_STEPS = 64  # steps a stamped launch records (csrc/decode.cu)


@dataclasses.dataclass(frozen=True)
class LoopSample:
    """What step j of a step-loop launch (`decode_steps_fused`) samples
    from the logits before it, as `ops.sampling.sample` would.

    temp: 0 takes the argmax of the logits, else of logits/temp + noise.
    codebook: None for the full vocab [0, n_out_vocab) and the stop flag
      (K3: tok == stop_token or eos_p >= min_eos_p); or (svs, cbs,
      step_idx0) for the coarse window [svs + (cbs if step_idx0 + j is odd
      else 0), + cbs) and no flag (K4).
    noise_row0: step j reads noise row min(noise_row0 + j, rows - 1).
    """

    temp: float
    codebook: tuple = None
    stop_token: int = -1
    min_eos_p: float = 2.0
    noise_row0: int = 0

    def window(self, j: int, n_out_vocab: int) -> tuple:
        """(base, n): step j's sample window [base, base + n)."""
        if self.codebook is None:
            return 0, n_out_vocab
        svs, cbs, step0 = self.codebook
        return svs + (cbs if (step0 + j) % 2 else 0), cbs

    def noise_row(self, j: int, rows: int) -> int:
        return min(self.noise_row0 + j, rows - 1)


def loop_n_past(n_past0: int, clamp: int, j: int) -> int:
    """The slot step j of a step-loop launch decodes at."""
    return min(n_past0 + j, clamp)


def sample_slots(plan: StepPlan, base: int, n: int) -> list:
    """Each block's slots [s0, s1) of the sample window [base, base + n)
    in the step loop: those of the logits it computes, its vocab rows or
    its packed tiles' columns within lm_window (an empty run is (s0, s0)),
    as csrc/decode.cu `sample_partial` cuts them."""
    lo, hi = plan.lm_window
    out = []
    for v0, v1 in plan.lm:
        if plan.packed:
            v0, v1 = max(v0 * PLAN_TILE, lo), min(v1 * PLAN_TILE, hi)
        s0, s1 = max(v0, base), min(v1, base + n)
        out.append((s0, max(s0, s1)))
    return out


def _take(best, other):
    """The larger of two (value, index) pairs (index None: nothing seen) by
    the sampler's total order: NaN above every number, then the value, then
    the lower index (csrc/step.cuh `argmax_take`)."""
    (v, i), (ov, oi) = best, other
    if oi is None:
        return best
    if i is None:
        return other
    if math.isnan(ov):
        return other if not math.isnan(v) or oi < i else best
    if math.isnan(v):
        return best
    return other if ov > v or (ov == v and oi < i) else best


def _eos_scale(logits, temp: float):
    return sampling.divide(logits, temp if temp != 0.0 else 0.7)


def _partial(logits, s0: int, s1: int, base: int, temp: float, row):
    """The sampler's partial over slots [s0, s1) of the (V,) f32 logits
    (csrc/step.cuh `take_slot`): the best (value, index) of logits/temp +
    row[slot - base] (of the logits at temp 0, row None), and the max m of
    the EOS scale (NaN aside, as fmaxf) with the sum of exp(e - m);
    (-inf, None, -inf, 0) for no slot."""
    if s0 == s1:
        return (-math.inf, None, -math.inf, 0.0)
    e = _eos_scale(logits[s0:s1], temp)
    c = logits[s0:s1] if row is None else e + row[s0 - base:s1 - base]
    nan = torch.isnan(c)
    k = int(nan.nonzero()[0]) if nan.any() else int(torch.argmax(c))
    live = e[~torch.isnan(e)]
    m = float(live.max()) if live.numel() else -math.inf
    return (float(c[k]), s0 + k, m, float(torch.exp(e - m).sum()))


def sample_partials(plan: StepPlan, logits, sample: LoopSample, j: int,
                    noise=None) -> list:
    """Every block's partial of step j's sample from the (n_out_vocab,) f32
    logits, as the kernel forms it over the block's `sample_slots`
    (`_partial`, with noise row `sample.noise_row(j)`)."""
    logits = logits.float()
    base, n = sample.window(j, logits.shape[0])
    row = (None if sample.temp == 0.0 else
           noise[sample.noise_row(j, noise.shape[0])].float())
    return [_partial(logits, s0, s1, base, sample.temp, row)
            for s0, s1 in sample_slots(plan, base, n)]


def fold_partials(parts, logits, sample: LoopSample, j: int) -> tuple:
    """(token, eos_p) of step j from the partials (K3/K4's: the blocks'; a
    lane's of K9/K10: its LM tiles'), as the kernels fold them: the best
    pair by the sampler's order (the window's base if none), and for the
    full window eos_p = exp(e_last - M) / S, M the largest m, S the sum of
    s exp(m - M) over the partials with slots (in order here; in the
    kernels by a butterfly over a warp), else None."""
    base, n = sample.window(j, logits.shape[0])
    best = (-math.inf, None)
    for v, i, _, _ in parts:
        best = _take(best, (v, i))
    tok = base if best[1] is None else best[1]
    if sample.codebook is not None:
        return tok, None
    M = max(m for _, _, m, _ in parts)
    S = sum(s * math.exp(m - M) for _, i, m, s in parts if i is not None)
    e_last = float(_eos_scale(logits[base + n - 1:base + n].float(),
                              sample.temp)[0])
    return tok, math.exp(e_last - M) / S


def lane_sample_slots(plan: LanePlan, base: int, n: int) -> list:
    """Each LM tile's slots [s0, s1) of the sample window [base, base + n)
    in the batched step loop (K9/K10), in the plan's tile order (its first
    tile holds lm_window's lo): the tile's 64 columns within the window,
    which the block that folds the tile samples for every lane (an empty
    run is (s0, s0)), as csrc/lane.cuh `LaneSampler::put` cuts them."""
    t0 = plan.tile0[LANE_PHASES.index("lm")]
    out = []
    for t in range(t0, t0 + len(plan.folds[LANE_PHASES.index("lm")])):
        s0 = max(t * PLAN_TILE, base)
        out.append((s0, max(s0, min((t + 1) * PLAN_TILE, base + n))))
    return out


def lane_sample_partials(plan: LanePlan, logits, sample: LoopSample, j: int,
                         rows=None) -> list:
    """The partials of step j's sample in the batched step loop, a list
    per LM tile of one per lane, from the (B, n_out_vocab) f32 logits and
    each lane's noise row of the step (`rows`, (B, >= window), None at
    temp 0), as the tiles' folds form them (`lane_sample_slots`,
    `_partial`)."""
    logits = logits.float()
    base, n = sample.window(j, logits.shape[1])
    return [[_partial(logits[b], s0, s1, base, sample.temp,
                      None if rows is None else rows[b].float())
             for b in range(logits.shape[0])]
            for s0, s1 in lane_sample_slots(plan, base, n)]


def lane_fold_partials(parts, logits, sample: LoopSample, j: int) -> list:
    """(token, eos_p) of each lane at step j from `lane_sample_partials`,
    folding the lane's partials in tile order (`fold_partials`), as the
    blocks that embed the lane do in csrc/lane.cuh `LaneSampler::fold`."""
    return [fold_partials([tile[b] for tile in parts], logits[b], sample, j)
            for b in range(logits.shape[0])]


def check_loop(cfg: GPTConfig, sample: LoopSample, n_steps: int,
               lm_window=None) -> None:
    """Raise ValueError for a loop the step loop does not sample: no step,
    or a sample window outside lm_window (the full vocab's window needs
    the full head)."""
    V = cfg.n_out_vocab
    lo, hi = lm_window if lm_window is not None else (0, V)
    if n_steps < 1:
        raise ValueError(f"the step loop takes >= 1 step, got {n_steps}")
    for j in range(min(n_steps, 2)):
        base, n = sample.window(j, V)
        if sample.codebook is None and (lo, hi) != (0, V) or not (
                lo <= base and base + n <= hi):
            raise ValueError(f"sample window [{base}, {base + n}) of step "
                             f"{j} outside lm_window ({lo}, {hi})")


def _loop_tensor(t, dev, dtype, n: int, name: str):
    if (t is None or t.dtype != dtype or t.device != dev
            or not t.is_contiguous() or t.numel() < n):
        raise ValueError(f"{name}: want a contiguous {dtype} tensor of >= "
                         f"{n} elements on {dev}")


def decode_steps_fused(cfg: GPTConfig, params, logits, k_cache, v_cache,
                       n_past0: int, clamp: int, n_steps: int,
                       sample: LoopSample, noise, tok_out, flag_out=None, *,
                       lm_window=None, stamps=None):
    """K3/K4's step loop on CUDA tensors: ONE cooperative launch of
    n_steps steps (csrc/decode.cu `decode_steps_kernel`, dense or on a
    qpack's packed read), step j sampling its token as `sample` says from
    the logits before it (`logits`, (n_out_vocab,) f32, holds the input
    logits and is left holding the last step's), writing it to tok_out[j]
    (and for the full window its stop flag to flag_out[j]), then decoding
    it at `loop_n_past(n_past0, clamp, j)` with the LM head over
    lm_window. `noise`: (rows, >= window) f32 rows with unit column
    stride, None at temp 0. `stamps`: an int64 tensor (`loop_stamps`), or
    None. Raises ValueError before any launch for what the kernel does
    not take; nothing falls back."""
    global loop_launches
    check_loop(cfg, sample, n_steps, lm_window)
    for j in (0, n_steps - 1):
        caches = check_step(cfg, params, k_cache, v_cache,
                            loop_n_past(n_past0, clamp, j), lm_window)
    if not 0 <= clamp < cfg.block_size:
        raise ValueError(f"clamp {clamp} outside [0, {cfg.block_size})")
    dev = params["wpe"].device
    _loop_tensor(tok_out, dev, torch.int32, n_steps, "tok_out")
    if sample.codebook is None:
        _loop_tensor(flag_out, dev, torch.int32, n_steps, "flag_out")
    width = sample.window(0, cfg.n_out_vocab)[1]
    if sample.temp != 0.0 and (
            noise is None or noise.dim() != 2 or noise.dtype != torch.float32
            or noise.device != dev or noise.shape[0] < 1
            or noise.shape[1] < width or noise.stride(1) != 1):
        raise ValueError(f"noise: want (rows, >= {width}) float32 rows on "
                         f"{dev} with unit column stride, got "
                         f"{None if noise is None else tuple(noise.shape)}")
    packed, w, plan, head, scratch = _stage_launch(cfg, params, logits,
                                                   lm_window)
    if stamps is not None:
        if n_steps > LOOP_STAMP_STEPS:
            raise ValueError(f"stamps: a stamped launch takes at most "
                             f"{LOOP_STAMP_STEPS} steps, got {n_steps}")
        _loop_tensor(stamps, dev, torch.int64,
                     plan.n_blocks * (2 + 3 * n_steps), "stamps")
    svs, cbs, step0 = sample.codebook or (0, 0, 0)
    hot = sample.temp != 0.0
    loop = _build.StepLoop(
        n_steps=n_steps, n_past0=n_past0, clamp=clamp, temp=sample.temp,
        noise=noise.data_ptr() if hot else None,
        noise_ld=noise.stride(0) if hot else 0,
        noise_row0=sample.noise_row0,
        noise_rows=noise.shape[0] if hot else 1,
        codebook=int(sample.codebook is not None), svs=svs, cbs=cbs,
        step_idx0=step0, stop_token=sample.stop_token,
        min_eos_p=sample.min_eos_p, tok_out=tok_out.data_ptr(),
        flag_out=None if flag_out is None else flag_out.data_ptr(),
        part=w.scratch("loop_part", 4 * plan.n_blocks,
                       dtype=torch.float32).data_ptr(),
        stamps=None if stamps is None else stamps.data_ptr())
    args = (*head, ctypes.addressof(loop), *caches, *scratch,
            logits.data_ptr(), _build.stream_ptr(w.device))
    if packed:
        qdecode.decode_steps_packed(args)
    else:
        _build.check("decode_steps_fused",
                     _build.lib().bark_decode_steps(*args))
        loop_launches += 1
    kv8.count(caches)
    return logits


def loop_stamps(plan, n_steps: int, device) -> torch.Tensor:
    """Zeroed stamps for a step-loop launch of n_steps on `plan` (K3/K4's
    StepPlan, at most LOOP_STAMP_STEPS steps; or K9/K10's LanePlan): a row
    a block, its thread 0's ns clock at the start, then per step j its
    token folded (1 + 3 j), its LM head's start (2 + 3 j) and end with the
    next sample's partials (3 + 3 j), and at the end (1 + 3 n_steps)."""
    return torch.zeros((plan.n_blocks, 2 + 3 * n_steps), dtype=torch.int64,
                       device=device)


def loop_phases_us(plan, stamps, n_steps: int) -> dict:
    """Where a stamped step-loop launch's time went, in µs (either loop's:
    the rows are alike): for block 0 and, taking each part's slowest
    block, for every block: the opening sample (the start to step 0's
    token), a step's layers (its token to its LM head), its LM head with
    the next sample's partial, the next sample's barrier wait and fold
    (each the mean over steps), the mean step (token to token) and the
    whole launch."""
    t = torch.as_tensor(stamps).reshape(-1)[:plan.n_blocks * (2 + 3 * n_steps)]
    t = t.reshape(plan.n_blocks, 2 + 3 * n_steps).to("cpu", torch.float64)
    tok = t[:, 1:2 + 3 * (n_steps - 1):3]  # step j's token folded
    parts = {
        "opening_sample": t[:, 1] - t[:, 0],
        "layers": (t[:, 2::3][:, :n_steps] - tok).mean(1),
        "lm_head": (t[:, 3::3][:, :n_steps] - t[:, 2::3][:, :n_steps])
        .mean(1),
    }
    if n_steps > 1:
        parts["sample_fold"] = (tok[:, 1:] - t[:, 3:3 * n_steps - 2:3]).mean(1)
        parts["step"] = (tok[:, -1] - tok[:, 0]) / (n_steps - 1)
    parts["launch"] = t[:, -1] - t[:, 0]
    out = dict(block0={k: float(v[0]) / 1e3 for k, v in parts.items()},
               slowest={k: float(v.max()) / 1e3 for k, v in parts.items()})
    out["launch_us"] = float(t[:, -1].max() - t[:, 0].min()) / 1e3
    return out
