"""The persistent decode step's plan (`bark_tpu_torch.kernels.decode.
step_plan`), dense (K1) and packed (K5), K5's weight records, and the
wrapper's refusals, on the CPU.

The plan says which block of the one cooperative launch takes which
(64-column tile, K range) of each phase's weight, and in which order each
column's split-K partials are folded. Here, for bark-small's three stages
(with their LM windows), the small model of chip_smoke.py's phase 3,
bark-large, and 132, 114, 7 and 1 blocks, dense and packed: every column
of every phase is covered exactly once per K range, the K ranges are
8-row aligned (whole 32-row quant blocks when packed, proj's within a
head), the LM section covers the window once (vocab rows, or the packed
head's 64-column tiles), the fold order is fixed, bark-small's busiest
block streams at most 10% over the mean at 132 blocks (packed: proj's and
the full LM head's at the least their unit allows), and a step takes at
most 5 barriers a layer plus 2. The plan executed in plain PyTorch (each
item's partial, folded in the plan's order, as csrc/decode.cu runs it)
gives the JAX package's Pallas decode kernel's logits and cache rows, in
interpret mode, within 1e-5 (f32, another summation order); the packed
plan, on qpacks of q8_0, q5_1 (mins) and q4_k (f32 scales), its packed
kernel's (quant=True) within 2e-4, as tests/test_torch_quant.py holds the
packed step. `qtile_records` un-tiles to the qpack bit for bit, in
16-byte-aligned records. The wrapper refuses what the kernel does not
take before it builds or launches anything, dense and packed.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.io import ggml as jggml
from bark_tpu.io import loader as jloader
from bark_tpu.kernels import decode as jkdec
from bark_tpu.models import gpt as jgpt
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.kernels import qdecode
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.models.presets import BARK_LARGE, BARK_SMALL

from test_quant_decode import _section
from test_torch_e2e import one_torch_thread  # autouse
from test_torch_quant import TOL, _port_section

BLOCKS = (132, 114, 7, 1)
SVS, CBS = 10000, 1024  # bark's semantic vocab and codebook size


def _small(**kw):  # chip_smoke.py's phase-3 model (2 layers, width 128)
    return GPTConfig(n_layer=2, n_head=2, n_embd=128, bias=True, **kw)


# (name, cfg, the lm_windows its decode steps use)
STAGES = [
    ("small-semantic", _small(block_size=320, n_in_vocab=182,
                              n_out_vocab=16), [None]),
    ("small-coarse", _small(block_size=384, n_in_vocab=34, n_out_vocab=32),
     [None, (16, 32)]),
    ("bark-small-semantic", BARK_SMALL["semantic"], [None]),
    ("bark-small-coarse", BARK_SMALL["coarse"],
     [None, (SVS, SVS + 2 * CBS)]),
    ("bark-small-fine", BARK_SMALL["fine"], [None]),
    ("bark-large-semantic", BARK_LARGE["semantic"], [None]),
    ("bark-large-coarse", BARK_LARGE["coarse"], [(SVS, SVS + 2 * CBS)]),
]
CASES = [pytest.param(cfg, win, G, packed,
                      id=f"{name}-{win}-{G}" + ("-packed" if packed else ""))
         for packed in (False, True)
         for name, cfg, wins in STAGES for win in wins for G in BLOCKS]


def _phase_shapes(cfg):
    D = cfg.n_embd
    return {"qkv": (D, 3 * D), "proj": (D, D), "fc": (D, 4 * D),
            "out": (4 * D, D)}


@pytest.mark.parametrize("cfg,win,G,packed", CASES)
def test_plan_covers_each_column_once_per_k_range(cfg, win, G, packed):
    plan = kdec.step_plan(cfg, G, win, packed=packed)
    rows = kdec.QBLOCK if packed else kdec.PLAN_ROWS
    assert plan.n_blocks == G and plan.n_layer == cfg.n_layer
    assert plan.packed == packed
    for p, name in enumerate(kdec.PHASES):
        K, N = _phase_shapes(cfg)[name]
        items, starts, folds = plan.items[p], plan.starts[p], plan.folds[p]
        assert len(starts) == G + 1 and starts[0] == 0
        assert starts[-1] == len(items)
        assert all(a <= b for a, b in zip(starts, starts[1:]))
        assert len(folds) == N // kdec.PLAN_TILE
        for tile, fold in enumerate(folds):
            ranges = [items[i][1:3] for i in fold]
            assert all(items[i][0] == tile for i in fold)
            # the tile's K ranges, in fold order, tile [0, K) exactly
            assert ranges[0][0] == 0 and ranges[-1][1] == K
            assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))
            assert all(k0 < k1 for k0, k1 in ranges)
        assert sorted(i for f in folds for i in f) == list(range(len(items)))
        for _, k0, k1, _ in items:
            assert k0 % rows == 0 and k1 % rows == 0
            if name == "proj":  # one head's rows
                assert k0 // kdec.HEAD_DIM == (k1 - 1) // kdec.HEAD_DIM
    flags = [it[3] for it in plan.items[1]]
    writers = [it[1] // kdec.HEAD_DIM for it in plan.items[1]
               if it[3] & kdec.WRITES_KV]
    assert sorted(writers) == list(range(cfg.n_head))
    assert sum(bool(f & kdec.WRITES_SCALES) for f in flags) == 1
    lo, hi = win or (0, cfg.n_out_vocab)
    if packed:  # the 64-column tiles of the head that cover [lo, hi)
        lo, hi = lo // kdec.PLAN_TILE, -(-hi // kdec.PLAN_TILE)
    assert plan.lm[0][0] == lo and plan.lm[-1][1] == hi
    assert all(a[1] == b[0] for a, b in zip(plan.lm, plan.lm[1:]))
    assert plan.n_barriers <= 5 * cfg.n_layer + 2


@pytest.mark.parametrize("cfg,win,G,packed", CASES)
def test_plan_and_table_are_the_same_from_call_to_call(cfg, win, G, packed):
    a, b = (kdec.step_plan(cfg, G, win, packed=packed) for _ in range(2))
    assert a == b
    ta, tb = a.table(), b.table()
    assert ta.dtype == np.int32 and np.array_equal(ta, tb)
    # the header the kernel reads (kdec.PL_*, csrc/decode.cu's PL_*):
    # blocks, barriers, lo, hi, layers, the LM section's kind, and the
    # fold lists and LM section where it finds them
    assert list(ta[[kdec.PL_BLOCKS, kdec.PL_BARRIERS, kdec.PL_LO,
                    kdec.PL_HI, kdec.PL_LAYERS, kdec.PL_LM_TILES]]) == [
        G, a.n_barriers, *a.lm_window, cfg.n_layer, int(packed)]
    lm = ta[kdec.PL_LM]
    assert [tuple(r) for r in ta[lm:lm + 2 * G].reshape(G, 2)] == list(a.lm)
    for p in range(len(kdec.PHASES)):
        fo, fl = ta[kdec.PL_FOLD_OFF + p], ta[kdec.PL_FOLD + p]
        offs = ta[fo:fo + len(a.folds[p]) + 1]
        lists = ta[fl:fl + offs[-1]]
        for t, fold in enumerate(a.folds[p]):
            assert tuple(lists[offs[t]:offs[t + 1]]) == fold
        st = ta[kdec.PL_STARTS + p]
        assert list(ta[st:st + G + 1]) == list(a.starts[p])


def _block_bytes(plan, D, itemsize):
    """{phase: the weight bytes each block streams}, "lm" included (a
    packed plan's: its int8 values, to which the scales and mins of its
    records are proportional)."""
    out = {}
    for p, name in enumerate(kdec.PHASES):
        items, starts = plan.items[p], plan.starts[p]
        out[name] = [sum((k1 - k0) * kdec.PLAN_TILE * itemsize
                         for _, k0, k1, _ in items[starts[b]:starts[b + 1]])
                     for b in range(plan.n_blocks)]
    cols = kdec.PLAN_TILE if plan.packed else 1  # a tile, or a vocab row
    out["lm"] = [(v1 - v0) * cols * D * itemsize for v0, v1 in plan.lm]
    return out


@pytest.mark.parametrize("stage,win,packed", [
    ("semantic", None, False), ("coarse", (SVS, SVS + 2 * CBS), False),
    ("coarse", None, False), ("fine", None, False),
    ("semantic", None, True), ("coarse", (SVS, SVS + 2 * CBS), True),
    ("coarse", None, True)])
def test_bark_small_blocks_are_balanced_at_132(stage, win, packed):
    """At most 10% over the mean. A packed plan's unit is a whole quant
    block, so two of its sections cannot get there: proj has 288 units a
    layer (12 heads x 12 tiles x 2 blocks) for 132 blocks, and the LM
    head 157 (semantic), 189 (coarse) or 33 (the coarse window) whole-K
    tiles; there the busiest block takes ceil(units / 132) units, the
    least any split can give it."""
    cfg = BARK_SMALL[stage]
    plan = kdec.step_plan(cfg, 132, win, packed=packed)
    itemsize = 1 if packed else 2
    unit = {"proj": kdec.QBLOCK * kdec.PLAN_TILE,
            "lm": kdec.PLAN_TILE * cfg.n_embd}
    for phase, per in _block_bytes(plan, cfg.n_embd, itemsize).items():
        mean = sum(per) / len(per)
        if packed and phase in unit:
            assert max(per) == -(-sum(per) // (132 * unit[phase])) * unit[
                phase], phase
        else:
            assert max(per) <= 1.10 * mean, (phase, max(per) / mean)


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_plan_refuses_what_the_kernel_does_not_take(packed):
    with pytest.raises(ValueError):
        kdec.step_plan(dataclasses.replace(BARK_SMALL["coarse"], n_head=16),
                       132, packed=packed)
    with pytest.raises(ValueError):
        kdec.step_plan(BARK_SMALL["coarse"], 0, packed=packed)
    with pytest.raises(ValueError):
        kdec.step_plan(BARK_SMALL["coarse"], 132, (0, 12097), packed=packed)


# ------------------------------------------------------------ the plan run

# tests/test_decode_kernel.py's model (as tests/test_torch_kernels_plain.py)
JCFG = jgpt.GPTConfig(n_layer=2, n_head=2, n_embd=128, block_size=64,
                      n_in_vocab=300, n_out_vocab=200, bias=True)
TCFG = GPTConfig(**dataclasses.asdict(JCFG))


def _weight_part(layer, key):
    """part(x, k0, k1, cols): x[k0:k1] against rows [k0, k1) and columns
    `cols` of the layer's `key` weight, f32; a packed weight as
    `gpt.qdot` computes it, the min term of the item's own blocks."""
    if key + "_w" in layer:
        W = layer[key + "_w"]
        return lambda x, k0, k1, cols: x[k0:k1] @ W[k0:k1, cols]
    q, s, m = (layer.get(f"{key}_{part}") for part in "qsm")
    B = kdec.QBLOCK
    return lambda x, k0, k1, cols: gpt.qdot(
        x[None, k0:k1], q[k0:k1, cols], s[k0 // B:k1 // B, cols],
        None if m is None else m[k0 // B:k1 // B, cols])[0]


def _run_plan(cfg, plan, params, tok, kc, vc, n_past):
    """The persistent step's arithmetic in plain PyTorch, f32: each phase's
    items computed as partials and folded in the plan's order; the proj
    items from the context of their own head; out's items from the rows of
    h they cover; the LM rows block by block, or a packed plan's LM tiles
    tile by tile, each writing its columns within the window."""
    D, L, H = cfg.n_embd, cfg.n_layer, cfg.n_head
    T, hd = kdec.PLAN_TILE, kdec.HEAD_DIM
    blk = params["blocks"]

    def ln(x, g, b):
        return gpt.layer_norm(x, g, b)

    def project(p, vin, key, l, N, bias):
        part = _weight_part({k: v[l] for k, v in blk.items()}, key)
        parts = [part(vin, k0, k1, slice(t * T, (t + 1) * T))
                 for t, k0, k1, _ in plan.items[p]]
        out = torch.empty(N)
        for t, fold in enumerate(plan.folds[p]):
            acc = torch.zeros(T)
            for i in fold:
                acc = acc + parts[i]
            out[t * T:(t + 1) * T] = acc
        return out + bias

    x = gpt.embed_rows(params, torch.tensor([tok]))[0] + params["wpe"][n_past]
    for l in range(L):
        h1 = ln(x, blk["ln1_g"][l], blk["ln1_b"][l])
        qkv = project(0, h1, "qkv", l, 3 * D, blk["qkv_b"][l])
        q, k, v = qkv[:D], qkv[D:2 * D], qkv[2 * D:]
        kc[l, n_past], vc[l, n_past] = k, v
        ctx = torch.empty(D)
        for h in range(H):
            cols = slice(h * hd, (h + 1) * hd)
            s = kc[l, :n_past + 1, cols] @ q[cols] / hd ** 0.5
            ctx[cols] = torch.softmax(s, 0) @ vc[l, :n_past + 1, cols]
        assert all(k0 // hd == (k1 - 1) // hd for _, k0, k1, _ in
                   plan.items[1])
        x = x + project(1, ctx, "proj", l, D, blk["proj_b"][l])
        h2 = ln(x, blk["ln2_g"][l], blk["ln2_b"][l])
        f = gpt.gelu(project(2, h2, "fc", l, 4 * D, blk["fc_b"][l]))
        x = x + project(3, f, "out", l, D, blk["out_b"][l])
    xf = ln(x, params["ln_f_g"], params["ln_f_b"])
    logits = torch.zeros(cfg.n_out_vocab)
    lo, hi = plan.lm_window
    for v0, v1 in plan.lm:
        if not plan.packed:
            logits[v0:v1] = params["lm_head"][0][v0:v1] @ xf
        for t in range(v0, v1) if plan.packed else ():
            c0, c1 = max(lo, t * T), min(hi, (t + 1) * T)
            if c0 < c1:
                logits[c0:c1] = _weight_part(params, "lm")(
                    xf, 0, D, slice(c0, c1))
    return logits


@pytest.mark.parametrize("G", [1, 7, 132])
@pytest.mark.parametrize("win", [None, (32, 160)], ids=["head", "window"])
def test_plan_run_in_plain_torch_matches_pallas(G, win):
    host = jgpt.init_params_numpy(JCFG, 0)
    rng = np.random.RandomState(1)
    for k, v in host["blocks"].items():
        if k.endswith("_b"):
            host["blocks"][k] = (rng.randn(*v.shape) * 0.01).astype(
                np.float32)
    shape = (JCFG.n_layer, JCFG.block_size, JCFG.n_embd)
    kc, vc = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    n_past = 9
    kc[:, :n_past] = rng.randn(JCFG.n_layer, n_past, JCFG.n_embd) * 0.5
    vc[:, :n_past] = rng.randn(JCFG.n_layer, n_past, JCFG.n_embd) * 0.5
    jl, jk, jv = jkdec.decode_step_fused(
        JCFG, {k: (jnp.asarray(v) if not isinstance(v, dict) else
                   {kk: jnp.asarray(vv) for kk, vv in v.items()})
               for k, v in host.items()},
        jnp.int32(17), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(n_past),
        interpret=True)
    params = tloader.params_from_numpy(host, torch.float32, "cpu")
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    plan = kdec.step_plan(TCFG, G, win)
    got = _run_plan(TCFG, plan, params, 17, tk, tv, n_past)
    lo, hi = plan.lm_window
    np.testing.assert_allclose(got[lo:hi].numpy(), np.asarray(jl)[lo:hi],
                               rtol=0, atol=1e-5)
    assert not got[:lo].any() and not got[hi:].any()
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_step_phases_split_a_stamped_step():
    plan = kdec.step_plan(TCFG, 7)  # 2 layers: 8 barriers, 19 stamps
    # start 0, embed to 1000, then each phase 2000 ns and each wait 500
    t, stamps = 1000, [0, 1000]
    for _ in range(plan.n_barriers):
        t += 2000
        stamps.append(t)
        t += 500
        stamps.append(t)
    stamps.append(t + 3000)
    us = kdec.step_phases_us(plan, torch.tensor(stamps))
    assert us["embed"] == 1.0 and us["ln1_qkv"] == 2.0
    assert us["attention_proj"] == us["ln2_fc"] == us["out"] == 2.0
    assert us["barrier_wait"] == 0.5 and us["lm_head"] == 3.0
    assert us["step"] == stamps[-1] / 1e3


def test_step_critical_splits_every_blocks_stamps():
    """`step_critical_us` reads every block's row (`step_stamps`' layout):
    block 3 of 7 starts 200 ns late and takes 1000 ns more in each proj
    phase and its LM head; block 0's row alone (`step_phases_us`) is the
    one test_step_phases_split_a_stamped_step splits."""
    plan = kdec.step_plan(TCFG, 7)
    stamps = kdec.step_stamps(plan, "cpu")
    assert stamps.shape == (7, 2 * plan.n_barriers + 3)
    for b in range(7):
        late = 200 if b == 3 else 0
        t, row = 1000, [late, 1000]
        for k in range(plan.n_barriers):
            t += 2000 + (1000 if b == 3 and k % 4 == 1 else 0)
            row.append(t)
            t = 2500 * (k + 1) + 1000 + 1000 * ((k + 3) // 4)  # release
            row.append(t)
        row.append(t + 3000 + (1000 if b == 3 else 0))
        stamps[b] = torch.tensor(row)
    crit = kdec.step_critical_us(plan, stamps)
    assert crit["attention_proj"]["slowest"] == 3.0
    assert crit["attention_proj"]["arrival_spread"] == 1.0
    assert crit["ln1_qkv"]["slowest"] == crit["ln1_qkv"]["mean"] == 2.0
    assert crit["embed_slowest"] == 1.0 and crit["lm_head_slowest"] == 4.0
    assert crit["step"] == (int(stamps[3, -1]) - 0) / 1e3
    assert kdec.step_phases_us(plan, stamps)["attention_proj"] == 2.0


# ------------------------------------------------------------ K5's plan run

QTYPES = ["Q8_0", "Q5_1", "Q4_K"]  # f16 scales; f16 + mins; f32 + mins
N_PAST = 9


def _cache_rows(rng):
    """(k, v) f32 caches of JCFG's shape, rows [0, N_PAST) drawn."""
    shape = (JCFG.n_layer, JCFG.block_size, JCFG.n_embd)
    kc, vc = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    kc[:, :N_PAST] = rng.randn(JCFG.n_layer, N_PAST, JCFG.n_embd) * 0.5
    vc[:, :N_PAST] = rng.randn(JCFG.n_layer, N_PAST, JCFG.n_embd) * 0.5
    return kc, vc


@functools.lru_cache(maxsize=None)
def _pallas_packed_step(qt):
    """bark_tpu's packed Pallas step (quant=True, interpret mode) at
    n_past 9 on tests/test_quant_decode.py's section stored in `qt`: the
    caches it started from, its logits and caches (numpy), once per
    format."""
    sec = _section(jggml.GGMLType[qt])
    cfg, jq = jloader.gpt_qparams_from_section(sec, jnp.float32)
    kc, vc = _cache_rows(np.random.RandomState(2))
    jl, jk, jv = jkdec.decode_step_fused(
        cfg, jq, jnp.int32(17), jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(N_PAST), quant=True, interpret=True)
    return kc, vc, np.asarray(jl), np.asarray(jk), np.asarray(jv)


def _port_qpack(qt):
    return tloader.gpt_qparams_from_section(
        _port_section(_section(jggml.GGMLType[qt])), torch.float32, "cpu")


@pytest.mark.parametrize("G", [1, 7, 132])
@pytest.mark.parametrize("win", [None, (32, 160)], ids=["head", "window"])
@pytest.mark.parametrize("qt", QTYPES)
def test_packed_plan_run_in_plain_torch_matches_pallas(qt, win, G):
    """K5's plan: whole-quant-block items, each with its blocks' min term,
    folded in the plan's order, and whole-K LM tiles; within TOL (f32) of
    the JAX package's packed kernel."""
    kc, vc, jl, jk, jv = _pallas_packed_step(qt)
    cfg, qp = _port_qpack(qt)
    assert cfg == TCFG
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    plan = kdec.step_plan(cfg, G, win, packed=True)
    got = _run_plan(cfg, plan, qp, 17, tk, tv, N_PAST)
    lo, hi = plan.lm_window
    np.testing.assert_allclose(got[lo:hi].numpy(), jl[lo:hi], rtol=0,
                               atol=TOL)
    assert not got[:lo].any() and not got[hi:].any()
    np.testing.assert_allclose(tk.numpy(), jk, rtol=0, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=TOL)


@pytest.mark.parametrize("qt", QTYPES)
def test_qtile_records_untile_to_the_qpack(qt):
    """Every record is one quant block of one tile: its values, scales and
    mins un-tile to the qpack's bit for bit; records (so chunks) start
    16-byte aligned."""
    _, qp = _port_qpack(qt)
    for key in kdec.QTILED:
        src = qp if key == "lm" else qp["blocks"]
        q, s, m = (src.get(f"{key}_{part}") for part in "qsm")
        rec = kdec.qtile_records(q, s, m)
        *lead, K, N = q.shape
        nt, nb, isz = N // kdec.PLAN_TILE, K // kdec.QBLOCK, s.element_size()
        vals = kdec.QBLOCK * kdec.PLAN_TILE
        size = vals + kdec.PLAN_TILE * isz * (1 if m is None else 2)
        assert rec.shape == (*lead, nt, nb, size) and rec.dtype == torch.uint8
        assert rec.is_contiguous() and size % 16 == 0
        assert rec.data_ptr() % 16 == 0
        back = rec[..., :vals].contiguous().view(torch.int8).reshape(
            *lead, nt, nb, kdec.QBLOCK, kdec.PLAN_TILE).movedim(-4, -2)
        assert torch.equal(back.reshape(q.shape), q), key
        bits = {2: torch.int16, 4: torch.int32}[isz]
        for j, t in enumerate((s,) if m is None else (s, m)):
            b0 = vals + j * kdec.PLAN_TILE * isz
            got = rec[..., b0:b0 + kdec.PLAN_TILE * isz].contiguous().view(
                t.dtype).movedim(-3, -2).reshape(t.shape)
            assert torch.equal(got.view(bits), t.view(bits)), (key, j)


def test_step_qtiles_follow_the_weights():
    """`step_qtiles` keeps the five record tensors with the stage weights
    and makes them again once a weight was changed in place."""

    class Held:  # StageWeights' memo alone
        def __init__(self):
            self._memo = {}

        memo = _build.StageWeights.memo

    _, qp = _port_qpack("Q5_1")
    w = Held()
    ptrs = kdec.step_qtiles(w, qp)
    assert len(ptrs) == len(kdec.QTILED) == 5
    assert kdec.step_qtiles(w, qp) is ptrs
    held = w.memo("step_qtiles", dict)
    before = held["tiled"][2].clone()  # fc
    qp["blocks"]["fc_m"].mul_(2)
    assert kdec.step_qtiles(w, qp) is not ptrs
    assert not torch.equal(held["tiled"][2], before)
    assert torch.equal(held["tiled"][2], kdec.qtile_records(
        qp["blocks"]["fc_q"], qp["blocks"]["fc_s"], qp["blocks"]["fc_m"]))


# ------------------------------------------------------------ refusals


def _on_meta(params):
    return {k: ({kk: vv.to("meta") for kk, vv in v.items()}
                if isinstance(v, dict) else v.to("meta"))
            for k, v in params.items()}


def _meta(cfg, quant=False):
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    kc, vc = gpt.init_kv_cache(cfg, torch.float32, "meta", quant=quant)
    return _on_meta(params), kc, vc


SMALL = TCFG


@pytest.fixture
def no_launch(monkeypatch):
    """Fail the test if the wrapper reaches the kernel library."""

    def refuse():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(_build, "lib", refuse)
    before = kdec.launches, qdecode.launches
    yield
    assert (kdec.launches, qdecode.launches) == before


@pytest.mark.parametrize("cfg", [
    dataclasses.replace(SMALL, n_head=4),                  # head dim 32
    dataclasses.replace(SMALL, n_embd=96, n_head=1),       # width 96
    dataclasses.replace(SMALL, n_embd=32, n_head=2),       # the tiny model
], ids=["head-dim-32", "width-96", "width-32"])
def test_wrapper_refuses_a_shape_before_any_launch(no_launch, cfg):
    params, kc, vc = _meta(cfg)
    with pytest.raises(ValueError, match="head dim"):
        kdec.decode_step_fused(cfg, params, 1, kc, vc, 0)


@pytest.mark.parametrize("n_past", [-1, SMALL.block_size])
def test_wrapper_refuses_n_past_outside_the_cache(no_launch, n_past):
    params, kc, vc = _meta(SMALL)
    with pytest.raises(ValueError, match="n_past"):
        kdec.decode_step_fused(SMALL, params, 1, kc, vc, n_past)


@pytest.mark.parametrize("fault", ["scales-missing", "scales-f16",
                                   "values-f32", "k-int8-v-dense",
                                   "short-cache"])
def test_wrapper_refuses_a_malformed_int8_cache(no_launch, fault):
    params, kc, vc = _meta(SMALL, quant=True)
    if fault == "scales-missing":
        kc = {"q": kc["q"]}
    elif fault == "scales-f16":
        kc = {**kc, "s": kc["s"].half()}
    elif fault == "values-f32":
        vc = {**vc, "q": vc["q"].float()}
    elif fault == "k-int8-v-dense":
        _, _, vc = _meta(SMALL)
    else:
        kc = {k: t[:, :-1] for k, t in kc.items()}
    with pytest.raises(ValueError, match="KV cache"):
        kdec.decode_step_fused(SMALL, params, 1, kc, vc, 0)


def test_wrapper_refuses_a_window_outside_the_vocab(no_launch):
    params, kc, vc = _meta(SMALL)
    with pytest.raises(ValueError, match="lm_window"):
        kdec.decode_step_fused(SMALL, params, 1, kc, vc, 0,
                               lm_window=(0, SMALL.n_out_vocab + 1))


@pytest.mark.parametrize("fault,match", [
    ("head-dim-32", "head dim"), ("n_past", "n_past"),
    ("window", "lm_window"), ("int8-cache", "KV cache"),
    ("scales-bf16", "scales"), ("lm-heads", "LM head"),
    ("qkv-shape", "qkv_q"), ("fc-mins-f32", "fc_m")])
def test_packed_wrapper_refuses_before_any_launch(no_launch, fault, match):
    """K5's wrapper on a meta qpack: what the packed kernel does not take
    raises before the library is reached."""
    cfg, qp = _port_qpack("Q5_1")
    qp = _on_meta(qp)
    kc, vc = gpt.init_kv_cache(cfg, torch.float32, "meta")
    n_past, win = 0, None
    if fault == "head-dim-32":
        cfg = dataclasses.replace(cfg, n_head=4)
    elif fault == "n_past":
        n_past = cfg.block_size
    elif fault == "window":
        win = (0, cfg.n_out_vocab + 1)
    elif fault == "int8-cache":
        kc, vc = gpt.init_kv_cache(cfg, torch.float32, "meta", quant=True)
        kc = {"q": kc["q"]}
    elif fault == "scales-bf16":
        qp["wte_s"] = qp["wte_s"].to(torch.bfloat16)
    elif fault == "lm-heads":
        cfg = dataclasses.replace(cfg, n_lm_heads=7)
        qp = {k: v for k, v in qp.items() if not k.startswith("lm_")}
    elif fault == "qkv-shape":
        qp["blocks"]["qkv_q"] = qp["blocks"]["qkv_q"][:, :-32]
    else:
        qp["blocks"]["fc_m"] = qp["blocks"]["fc_m"].float()
    with pytest.raises(ValueError, match=match):
        kdec.decode_step_fused(cfg, qp, 1, kc, vc, n_past, lm_window=win)
