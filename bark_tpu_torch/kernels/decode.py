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

The caches may be the int8 caches of `gpt.init_kv_cache(quant=True)`: the
same launch then runs K6a's arithmetic (csrc/decode.cu `attend_int8`) as
each layer's attention, dense and packed alike.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from bark_tpu_torch.kernels import _build, kv8, qdecode
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig

launches = 0  # kernel launches through `decode_step_fused`

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


def _generic_phase(K: int, N: int, G: int, rows: int):
    """Blocks take near-equal runs of the (tile, `rows`-row unit)
    sequence."""
    per = K // rows
    bounds = _split((N // PLAN_TILE) * per, G)
    items, starts = [], [0]
    for b in range(G):
        items += _runs(bounds[b], bounds[b + 1], per, rows)
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


def qtile_records(q, s, m=None):
    """A packed (..., K, N) weight (int8 values q, (..., K/32, N) scales s
    and mins m or None) as K5's records, (..., N/64, K/32, rec) uint8: a
    record is one 32-row quant block of a 64-column tile, its 32 x 64
    values row by row, then its 64 scales, then its 64 mins, rec = 2048 +
    64 x the scale's bytes (x 2 with mins), a multiple of 16. So any run
    of whole quant blocks of a tile is one contiguous, 16-byte-aligned run
    of bytes."""
    *lead, K, N = q.shape
    nb, nt = K // QBLOCK, N // PLAN_TILE
    parts = [q.reshape(*lead, nb, QBLOCK, nt, PLAN_TILE).movedim(-2, -4)
             .reshape(*lead, nt, nb, QBLOCK * PLAN_TILE).view(torch.uint8)]
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
    packed = gpt.is_qpack(params)
    w = (_build.stage_qweights if packed else _build.stage_weights)(
        cfg, params)
    V = cfg.n_out_vocab
    lo, hi = lm_window if lm_window is not None else (0, V)
    tok = _token_on(token, w.device)
    if out is None:
        out = torch.empty((V,), dtype=torch.float32, device=w.device)
    _build.f32_on(out, w.device, V, "logits")
    if not packed and params["lm_head"].data_ptr() % 16:
        raise ValueError("lm_head: the step's bulk copies want it 16-byte "
                         "aligned")
    plan, table = device_plan(w, (lo, hi))
    want = plan.n_blocks * (2 * plan.n_barriers + 3)
    if stamps is not None and (
            stamps.dtype != torch.int64 or stamps.device != w.device
            or not stamps.is_contiguous() or stamps.numel() < want):
        raise ValueError(f"stamps: want a contiguous int64 tensor of >= "
                         f"{want} on {w.device} (`step_stamps`)")
    cap = plan.partial_floats
    tiles = (step_qtiles if packed else step_tiles)(w, params)
    args = (w.ref, ctypes.addressof(tiles), table.data_ptr(), table.numel(),
            plan.n_blocks, tok.data_ptr(), n_past, *caches,
            w.scratch("step_partial", 2 * cap,
                      dtype=torch.float32).data_ptr(), cap,
            w.scratch("step_count", 1, dtype=torch.int32).data_ptr(),
            None if stamps is None else stamps.data_ptr(), out.data_ptr(),
            _build.stream_ptr(w.device))
    if packed:
        qdecode.decode_step_packed(args)
    else:
        _build.check("decode_step_fused", _build.lib().bark_decode_step(*args))
        launches += 1
    kv8.count(caches)
    return out


def step_stamps(plan: StepPlan, device) -> torch.Tensor:
    """Zeroed stamps for a step of `plan`: a row a block, its ns clock at
    the start, after the embed, at each barrier's arrival and release, and
    at the end (2 x barriers + 3)."""
    return torch.zeros((plan.n_blocks, 2 * plan.n_barriers + 3),
                       dtype=torch.int64, device=device)


def _stamp_rows(plan: StepPlan, stamps, blocks: int):
    """(start, embed, arrivals (blocks, barriers), releases, end) of the
    first `blocks` rows of the stamps, as int64 CPU tensors."""
    per = 2 * plan.n_barriers + 3
    t = torch.as_tensor(stamps).reshape(-1)[:blocks * per]
    t = t.reshape(blocks, per).to("cpu", torch.int64)
    return t[:, 0], t[:, 1], t[:, 2:-1:2], t[:, 3::2], t[:, -1]


def step_phases_us(plan: StepPlan, stamps) -> dict:
    """Where one stamped step's time went, in µs, from block 0's clock
    (its row of `stamps` as `decode_step_fused` filled them): the embed;
    each phase's own work (from its barrier's release, or the embed, to its
    arrival), as the mean over layers; the barrier waits (arrival to
    release), the mean over all; the LM head (the last release to the
    end); and the whole step."""
    start, embed, arrive, release, end = (
        x[0] for x in _stamp_rows(plan, stamps, 1))
    begin = torch.cat([embed[None], release[:-1]])
    work = (arrive - begin).double().reshape(plan.n_layer, len(PHASES))
    out = {"embed": float(embed - start) / 1e3}
    for name, us in zip(PHASE_NAMES, work.mean(0) / 1e3):
        out[name] = float(us)
    out["barrier_wait"] = float((release - arrive).double().mean()) / 1e3
    out["lm_head"] = float(end - release[-1]) / 1e3
    out["step"] = float(end - start) / 1e3
    return out


def step_critical_us(plan: StepPlan, stamps) -> dict:
    """Where one stamped step's time went on its slowest blocks, in µs,
    from every block's row of `stamps`: for each phase, as the mean over
    layers, the slowest block's work (its release, or embed, to its
    arrival), the blocks' mean work, and the spread of their arrivals (the
    last's less the first's); the slowest embed and LM head; and the step
    (the last end less the first start)."""
    start, embed, arrive, release, end = _stamp_rows(plan, stamps,
                                                     plan.n_blocks)
    begin = torch.cat([embed[:, None], release[:, :-1]], dim=1)
    L, P = plan.n_layer, len(PHASES)
    work = (arrive - begin).double().reshape(-1, L, P) / 1e3
    spread = (arrive.amax(0) - arrive.amin(0)).double().reshape(L, P) / 1e3
    out = {}
    for p, name in enumerate(PHASE_NAMES):
        out[name] = dict(slowest=float(work[:, :, p].amax(0).mean()),
                         mean=float(work[:, :, p].mean()),
                         arrival_spread=float(spread[:, p].mean()))
    out["embed_slowest"] = float((embed - start).amax()) / 1e3
    out["lm_head_slowest"] = float((end - release[:, -1]).amax()) / 1e3
    out["step"] = float(end.amax() - start.amin()) / 1e3
    return out
