"""The batched decode step's plan (`bark_tpu_torch.kernels.decode.
lane_plan`), dense (K7) and packed (K5-batched), its weight layouts and
the wrapper's refusals, on the CPU.

The lane plan says which block of the one cooperative launch takes which
(64-column tile, K range) of each product (qkv, proj, fc and out of a
layer, then the LM head over the tiles of its window), in which order each
tile's split-K partials are folded (by the last block to write one), and
which (head, lane) units of the attention there are; the kernel splits
the units over its blocks from each lane's slot (`lane_units`). Here, for
bark-small's stages (with their LM windows) and bark-large at 1, 8 and 32
lanes on 132 and 7 blocks, dense and packed: every column of every product
is covered exactly once per K range, the K ranges are 16-row aligned
(whole 32-row quant blocks when packed) and span at most LANE_ROWS rows,
every (head, lane) pair is a unit once, the plan and table are the same
from call to call, and what the kernel does not take is refused. The plan
executed in plain PyTorch (each item's partial for every lane, folded in
the plan's order, LayerNorm from the residual's per-tile statistics
combined as the kernel combines them, attention per unit) gives the JAX
package's batched Pallas decode kernel's logits and cache rows in
interpret mode within 1e-5 (f32, another summation order; q4_k within
2e-5), dense and on q4_0 and q4_k qpacks, at 1, 3 and 8 lanes at
different slots, on the full head and a window. The weight copies the kernel streams un-tile to the
weights bit for bit, and the wrapper refuses before it builds or launches
anything.
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
from bark_tpu_torch.kernels import bdecode as kbdec
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.kernels import qbdecode
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.presets import BARK_LARGE, BARK_SMALL

from test_quant_decode import _section
from test_torch_decode_plan import (JCFG, SVS, CBS, TCFG, _meta, _on_meta,
                                    _port_qpack)
from test_torch_e2e import one_torch_thread  # autouse

LANES = (1, 8, 32)
STAGES = [
    ("bark-small-semantic", BARK_SMALL["semantic"], None),
    ("bark-small-coarse", BARK_SMALL["coarse"], (SVS, SVS + 2 * CBS)),
    ("bark-large-coarse", BARK_LARGE["coarse"], (SVS, SVS + 2 * CBS)),
    ("bark-large-semantic", BARK_LARGE["semantic"], None),
]
CASES = [pytest.param(cfg, win, B, G, packed,
                      id=f"{name}-B{B}-G{G}" + ("-packed" if packed else ""))
         for packed in (False, True) for name, cfg, win in STAGES
         for B in LANES for G in (132, 7)]


def _shapes(cfg, plan):
    D = cfg.n_embd
    lo, hi = plan.lm_window
    t0, t1 = lo // kdec.PLAN_TILE, -(-hi // kdec.PLAN_TILE)
    return {"qkv": (D, 3 * D), "proj": (D, D), "fc": (D, 4 * D),
            "out": (4 * D, D), "lm": (D, (t1 - t0) * kdec.PLAN_TILE)}


@pytest.mark.parametrize("cfg,win,B,G,packed", CASES)
def test_lane_plan_covers_each_column_and_unit_once(cfg, win, B, G, packed):
    plan = kdec.lane_plan(cfg, G, B, win, packed=packed)
    again = kdec.lane_plan(cfg, G, B, win, packed=packed)
    assert plan == again and np.array_equal(plan.table(), again.table())
    rows = kdec.QBLOCK if packed else kdec.LANE_UNIT
    assert (plan.n_blocks, plan.n_layer, plan.n_lanes) == (G, cfg.n_layer, B)
    assert plan.n_barriers == 5 * cfg.n_layer + 1
    for p, name in enumerate(kdec.LANE_PHASES):
        K, N = _shapes(cfg, plan)[name]
        items, starts, folds = plan.items[p], plan.starts[p], plan.folds[p]
        assert len(starts) == G + 1 and starts[0] == 0
        assert starts[-1] == len(items)
        assert all(a <= b for a, b in zip(starts, starts[1:]))
        assert len(folds) == N // kdec.PLAN_TILE
        t0 = plan.tile0[p]
        for lt, fold in enumerate(folds):
            ranges = [items[i][1:3] for i in fold]
            assert all(items[i][0] == t0 + lt for i in fold)
            assert ranges[0][0] == 0 and ranges[-1][1] == K
            assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))
        assert sorted(i for f in folds for i in f) == list(range(len(items)))
        for _, k0, k1, _ in items:
            assert k0 % rows == 0 and k1 % rows == 0
            assert 0 < k1 - k0 <= kdec.LANE_ROWS
    assert sorted(plan.pairs) == [(h, b) for h in range(cfg.n_head)
                                  for b in range(B)]
    # the table's header, where the kernel reads it (kdec.LP_*,
    # csrc/lane.cuh's LP_*)
    t = plan.table()
    assert list(t[[kdec.LP_BLOCKS, kdec.LP_BARRIERS, kdec.LP_LAYERS,
                   kdec.LP_LANES, kdec.LP_LO, kdec.LP_HI, kdec.LP_PACKED,
                   kdec.LP_NPAIRS]]) == [
        G, plan.n_barriers, cfg.n_layer, B, *plan.lm_window, int(packed),
        cfg.n_head * B]
    pairs = t[kdec.LP_PAIRS]
    assert [tuple(r) for r in t[pairs:pairs + 2 * len(plan.pairs)].reshape(
        -1, 2)] == list(plan.pairs)
    for p in range(len(kdec.LANE_PHASES)):
        assert t[kdec.LP_TILE0 + p] == plan.tile0[p]
        assert t[kdec.LP_NTILES + p] == len(plan.folds[p])
        fo, fl = t[kdec.LP_FOLD_OFF + p], t[kdec.LP_FOLD + p]
        offs = t[fo:fo + len(plan.folds[p]) + 1]
        for lt, fold in enumerate(plan.folds[p]):
            assert tuple(t[fl + offs[lt]:fl + offs[lt + 1]]) == fold
        st = t[kdec.LP_STARTS + p]
        assert list(t[st:st + G + 1]) == list(plan.starts[p])


@pytest.mark.parametrize("B", LANES)
def test_lane_units_split_every_pair_once_by_live_rows(B):
    """The kernel's split of the (head, lane) units (its mirror
    `lane_units`): contiguous runs that cover every pair once, each
    block's cost within one unit of its share, and lanes at n_past 1023
    costing more than lanes at 0."""
    cfg = BARK_SMALL["coarse"]
    plan = kdec.lane_plan(cfg, 132, B)
    n_past = [(0, 300, 1023, 887)[b % 4] for b in range(B)]
    runs = kdec.lane_units(plan, n_past, cfg.block_size)
    assert runs[0][0] == 0 and runs[-1][1] == len(plan.pairs)
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    cost = [n_past[b] + 1 + kdec.ATT_COST for _, b in plan.pairs]
    share = sum(cost) / 132
    for p0, p1 in runs:
        assert sum(cost[p0:p1]) <= share + max(cost)
    assert kdec.lane_units(plan, n_past, cfg.block_size) == runs


@pytest.mark.parametrize("fault", ["lanes-0", "lanes-33", "head-dim-32",
                                   "units-over-512", "window", "blocks-0"])
def test_lane_plan_refuses_what_the_kernel_does_not_take(fault):
    cfg, B, G, win = BARK_SMALL["coarse"], 8, 132, None
    if fault == "lanes-0":
        B = 0
    elif fault == "lanes-33":
        B = 33
    elif fault == "head-dim-32":
        cfg = dataclasses.replace(cfg, n_head=24)
    elif fault == "units-over-512":  # 32 lanes of 24 heads of 64
        cfg, B = dataclasses.replace(cfg, n_embd=1536, n_head=24), 32
    elif fault == "window":
        win = (0, cfg.n_out_vocab + 1)
    else:
        G = 0
    with pytest.raises(ValueError):
        kdec.lane_plan(cfg, G, B, win)


# ------------------------------------------------------------ the plan run


def _tile_stats(x):
    """(B, D/64, 2): each 64-column tile's mean and squared deviations,
    per lane (csrc/lane.cuh `tile_stats`)."""
    t = x.reshape(x.shape[0], -1, kdec.PLAN_TILE)
    mean = t.sum(-1) / kdec.PLAN_TILE
    return torch.stack([mean, ((t - mean[..., None]) ** 2).sum(-1)], -1)


def _ln(x, stats, g, b):
    """LayerNorm of each lane from its tile statistics, combined in tile
    order as the kernel does (csrc/lane.cuh `build_vin`): the mean of
    the tiles' means, and the sum of their squared deviations, each with
    64 x its mean's from the row's."""
    T = kdec.PLAN_TILE
    mean = stats[:, 0, 0].clone()
    for t in range(1, stats.shape[1]):
        mean = mean + stats[:, t, 0]
    mean = mean / stats.shape[1]
    m2 = torch.zeros_like(mean)
    for t in range(stats.shape[1]):
        d = stats[:, t, 0] - mean
        m2 = m2 + stats[:, t, 1] + T * d * d
    inv = 1.0 / torch.sqrt(m2 / x.shape[1] + 1e-5)
    return (x - mean[:, None]) * inv[:, None] * g + b


def _lane_part(layer, key):
    """part(x, k0, k1, cols): every lane's x[:, k0:k1] against rows [k0,
    k1) and columns `cols` of the layer's `key` weight, f32; a packed
    weight as `gpt.qdot` computes it, the min term of the item's own
    blocks."""
    if key + "_w" in layer:
        W = layer[key + "_w"]
        return lambda x, k0, k1, cols: x[:, k0:k1] @ W[k0:k1, cols]
    q, s, m = (layer.get(f"{key}_{part}") for part in "qsm")
    B = kdec.QBLOCK
    return lambda x, k0, k1, cols: gpt.qdot(
        x[:, k0:k1], q[k0:k1, cols], s[k0 // B:k1 // B, cols],
        None if m is None else m[k0 // B:k1 // B, cols])


def _run_lane_plan(cfg, plan, params, toks, kc, vc, n_past):
    """The batched step's arithmetic in plain PyTorch, f32: each product's
    items computed for every lane as partials and folded in the plan's
    order, plus bias, GELU or the residual; LayerNorm from the residual's
    tile statistics; each (head, lane) unit's attention over its lane's
    rows; the LM head's tiles of the window. The caches are (L, B, S, D)
    and updated in place."""
    D, L, H = cfg.n_embd, cfg.n_layer, cfg.n_head
    T, hd = kdec.PLAN_TILE, kdec.HEAD_DIM
    B = len(toks)
    blk = params["blocks"]
    if gpt.is_qpack(params):
        lm = {k: params[k] for k in ("lm_q", "lm_s", "lm_m") if k in params}
    else:
        head = params["lm_head"][0]
        head_t = torch.zeros(D, -(-cfg.n_out_vocab // T) * T)
        head_t[:, :cfg.n_out_vocab] = head.t()
        lm = {"lm_w": head_t}

    def project(p, vin, layer, key, bias):
        part = _lane_part(layer, key)
        parts = [part(vin, k0, k1, slice(t * T, (t + 1) * T))
                 for t, k0, k1, _ in plan.items[p]]
        out = torch.zeros(B, len(plan.folds[p]) * T)
        for lt, fold in enumerate(plan.folds[p]):
            acc = torch.zeros(B, T)
            for i in fold:
                acc = acc + parts[i]
            out[:, lt * T:(lt + 1) * T] = acc
        return out if bias is None else out + bias

    x = gpt.embed_rows(params, torch.tensor(toks)) + params["wpe"][n_past]
    for l in range(L):
        layer = {k: v[l] for k, v in blk.items()}
        h1 = _ln(x, _tile_stats(x), layer["ln1_g"], layer["ln1_b"])
        qkv = project(0, h1, layer, "qkv", layer["qkv_b"])
        ctx = torch.empty(B, D)
        for h, b in plan.pairs:
            n = n_past[b]
            cols = slice(h * hd, (h + 1) * hd)
            kc[l, b, n, cols] = qkv[b, D + h * hd:D + (h + 1) * hd]
            vc[l, b, n, cols] = qkv[b, 2 * D + h * hd:2 * D + (h + 1) * hd]
            s = kc[l, b, :n + 1, cols] @ qkv[b, cols] / hd ** 0.5
            ctx[b, cols] = torch.softmax(s, 0) @ vc[l, b, :n + 1, cols]
        x = x + project(1, ctx, layer, "proj", layer["proj_b"])
        h2 = _ln(x, _tile_stats(x), layer["ln2_g"], layer["ln2_b"])
        f = gpt.gelu(project(2, h2, layer, "fc", layer["fc_b"]))
        x = x + project(3, f, layer, "out", layer["out_b"])
    xf = _ln(x, _tile_stats(x), params["ln_f_g"], params["ln_f_b"])
    lo, hi = plan.lm_window
    t0 = plan.tile0[4]
    part = _lane_part(lm, "lm")
    logits = torch.zeros(B, cfg.n_out_vocab)
    parts = [part(xf, k0, k1, slice(t * T, (t + 1) * T))
             for t, k0, k1, _ in plan.items[4]]
    for lt, fold in enumerate(plan.folds[4]):
        acc = torch.zeros(B, T)
        for i in fold:
            acc = acc + parts[i]
        c0, c1 = max(lo, (t0 + lt) * T), min(hi, (t0 + lt + 1) * T)
        if c0 < c1:
            logits[:, c0:c1] = acc[:, c0 - (t0 + lt) * T:c1 - (t0 + lt) * T]
    return logits


# eight lanes' tokens and slots, at different n_past (one at the cache's
# last slot); B lanes are the first B of them
TOKENS = [17, 3, 250, 0, 299, 41, 128, 7]
SLOTS = [9, 0, 63, 30, 5, 17, 44, 1]
WINDOW = (40, 150)


def _caches(B, seed):
    """(L, B, S, D) f32 caches of JCFG's shape, every row drawn."""
    rng = np.random.RandomState(seed)
    shape = (JCFG.n_layer, B, JCFG.block_size, JCFG.n_embd)
    return ((rng.randn(*shape) * 0.5).astype(np.float32),
            (rng.randn(*shape) * 0.5).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _dense_host():
    host = jgpt.init_params_numpy(JCFG, 0)
    rng = np.random.RandomState(1)
    for k, v in host["blocks"].items():
        if k.endswith("_b"):
            host["blocks"][k] = (rng.randn(*v.shape) * 0.01).astype(
                np.float32)
    return host


@functools.lru_cache(maxsize=None)
def _pallas_batched(fmt: str):
    """bark_tpu's batched Pallas step (interpret mode) of the eight lanes
    on the dense model or a `fmt` qpack of tests/test_quant_decode.py's
    section: the caches it started from, its logits and caches (numpy),
    once per fmt. Its lanes are independent, so lanes [0, B) of it are
    the step of the first B lanes."""
    kc, vc = _caches(8, 48)
    if fmt == "dense":
        jp = {k: (jnp.asarray(v) if not isinstance(v, dict) else
                  {kk: jnp.asarray(vv) for kk, vv in v.items()})
              for k, v in _dense_host().items()}
        cfg, quant = JCFG, False
    else:
        cfg, jp = jloader.gpt_qparams_from_section(
            _section(jggml.GGMLType[fmt]), jnp.float32)
        quant = True
    jl, jk, jv = jkdec.decode_step_fused_batched(
        cfg, jp, jnp.asarray(TOKENS, jnp.int32), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(SLOTS, jnp.int32), quant=quant,
        interpret=True)
    return kc, vc, np.asarray(jl), np.asarray(jk), np.asarray(jv)


@pytest.mark.parametrize("win", [None, WINDOW], ids=["head", "window"])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("fmt", ["dense", "Q4_0", "Q4_K"])
def test_lane_plan_run_in_plain_torch_matches_pallas(fmt, B, win):
    """On 7 blocks (so every product's tiles split into several items), in
    f32: the window's logits are the full head's (JAX's batched kernel
    computes them alike), zeros outside it. Within 1e-5, q4_k within 2e-5:
    its f32 scales and mins give larger partial sums, and another
    summation order moves its logits (~1.5) by up to 1.1e-5 on 7 blocks
    and 1.6e-5 on one (LayerNorm's two-pass statistics in place of the
    tiles' combined ones change neither)."""
    kc, vc, jl, jk, jv = (t[:B] if t.ndim == 2 else t[:, :B]
                          for t in _pallas_batched(fmt))
    if fmt == "dense":
        params = tloader.params_from_numpy(_dense_host(), torch.float32,
                                           "cpu")
        cfg = TCFG
    else:
        cfg, params = _port_qpack(fmt)
        assert cfg == TCFG
    toks, n_past = TOKENS[:B], SLOTS[:B]
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    plan = kdec.lane_plan(cfg, 7, B, win, packed=fmt != "dense")
    got = _run_lane_plan(cfg, plan, params, toks, tk, tv, n_past).numpy()
    lo, hi = plan.lm_window
    tol = 2e-5 if fmt == "Q4_K" else 1e-5
    np.testing.assert_allclose(got[:, lo:hi], jl[:, lo:hi], rtol=0,
                               atol=tol)
    assert not got[:, :lo].any() and not got[:, hi:].any()
    np.testing.assert_allclose(tk.numpy(), jk, rtol=0, atol=tol)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=tol)


# ------------------------------------------------------------ weight copies


def test_frag_order_untiles_to_the_weight():
    """Thread 4 g + t's 8 values of a k16 step of an m16 tile are mma's A
    fragment of the tile's transpose: column 16 mt + g (+ 8), rows 2 t, 2 t
    + 1 (+ 8) of the step; every value once."""
    W = torch.arange(2 * 64 * 128, dtype=torch.float32).reshape(2, 64, 128)
    f = kdec.frag_order(W, kdec.LANE_UNIT)
    assert f.shape == (2, 2, 4, 4, 32, 8) and f.is_contiguous()
    assert torch.equal(f.flatten().sort().values, W.flatten())
    for l, nt, s, mt, lane in ((0, 0, 0, 0, 0), (1, 1, 3, 2, 13),
                               (1, 0, 2, 3, 31)):
        g, t = divmod(lane, 4)
        col = 64 * nt + 16 * mt + g
        row = 16 * s + 2 * t
        want = [W[l, row + 8 * kh + kl, col + 8 * mh]
                for kh in (0, 1) for mh in (0, 1) for kl in (0, 1)]
        assert f[l, nt, s, mt, lane].tolist() == [float(v) for v in want]


@pytest.mark.parametrize("qt", ["Q4_0", "Q4_K"])
def test_frag_records_hold_the_qpack(qt):
    """The bf16 step's records (`qtile_records(frag=True)`): each
    record's values are its quant block's in `frag_order`, its scales and
    mins K5's, bit for bit."""
    _, qp = _port_qpack(qt)
    q, s, m = (qp["blocks"].get(f"fc_{part}") for part in "qsm")
    plain = kdec.qtile_records(q, s, m)
    frag = kdec.qtile_records(q, s, m, frag=True)
    vals = kdec.QBLOCK * kdec.PLAN_TILE
    assert frag.shape == plain.shape and frag.data_ptr() % 16 == 0
    assert torch.equal(frag[..., vals:], plain[..., vals:])
    want = kdec.frag_order(q, kdec.QBLOCK).reshape(*frag.shape[:-1], vals)
    assert torch.equal(frag[..., :vals].view(torch.int8), want)


def test_lane_tiles_follow_the_weights():
    """`lane_tiles` keeps the five tiled tensors (the LM head's transpose
    padded with zeros to 64 columns) with the stage weights and makes them
    again once a weight was changed in place; in f32 the dense rows are
    K1's tile-major layout."""

    class Held:  # StageWeights' memo alone, as an f32 dense stage
        dtype, packed = torch.float32, False

        def __init__(self):
            self._memo = {}

        memo = _build.StageWeights.memo

    params = tloader.params_from_numpy(_dense_host(), torch.float32, "cpu")
    w = Held()
    ptrs = kdec.lane_tiles(w, params)
    assert len(ptrs) == 5 and kdec.lane_tiles(w, params) is ptrs
    tiled = w.memo("lane_tiles", dict)["tiled"]
    W = params["blocks"]["fc_w"]
    L, K, N = W.shape
    assert torch.equal(tiled[2], W.view(L, K, N // 64, 64).permute(0, 2, 1, 3))
    V, D = params["lm_head"][0].shape
    head = tiled[4].permute(1, 0, 2).reshape(D, -1)
    assert torch.equal(head[:, :V], params["lm_head"][0].t())
    assert not head[:, V:].any() and head.shape[1] % 64 == 0
    params["blocks"]["fc_w"].mul_(2)
    assert kdec.lane_tiles(w, params) is not ptrs


# ------------------------------------------------------------ refusals


@pytest.fixture
def no_launch(monkeypatch):
    """Fail the test if the wrapper reaches the kernel library."""

    def refuse():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(_build, "lib", refuse)
    before = kbdec.launches, qbdecode.launches
    yield
    assert (kbdec.launches, qbdecode.launches) == before


def _meta_lanes(cfg, B, quant=False):
    params, _, _ = _meta(cfg)
    kc, vc = gpt.init_kv_cache(cfg, torch.float32, "meta", quant=quant,
                               batch=B)
    return params, kc, vc


@pytest.mark.parametrize("fault,match", [
    ("head-dim-32", "head dim"), ("lanes-33", "batched caches"),
    ("units", "units"), ("window", "lm_window"),
    ("n_past", "n_past"), ("int8-cache", "KV cache"),
    ("cache-lanes", "KV cache")])
def test_batched_wrapper_refuses_before_any_launch(no_launch, fault, match):
    cfg, B, n_past, win = TCFG, 3, [0, 5, 9], None
    if fault == "head-dim-32":
        cfg = dataclasses.replace(cfg, n_head=4)
    elif fault == "lanes-33":
        B, n_past = 33, [0] * 33
    elif fault == "units":  # 32 lanes of 24 heads: 768 units
        cfg = dataclasses.replace(cfg, n_embd=1536, n_head=24)
        B, n_past = 32, [0] * 32
    elif fault == "window":
        win = (0, cfg.n_out_vocab + 1)
    elif fault == "n_past":
        n_past = [0, 5, cfg.block_size]
    params, kc, vc = _meta_lanes(cfg, B, quant=fault == "int8-cache")
    if fault == "int8-cache":
        kc = {"q": kc["q"]}
    elif fault == "cache-lanes":
        kc = kc[:, :2]
    with pytest.raises(ValueError, match=match):
        kbdec.decode_step_fused_batched(cfg, params, [1] * B, kc, vc,
                                        n_past, lm_window=win)


@pytest.mark.parametrize("fault,match", [
    ("scales-bf16", "scales"), ("lm-heads", "LM head"),
    ("qkv-shape", "qkv_q")])
def test_packed_batched_wrapper_refuses_before_any_launch(no_launch, fault,
                                                          match):
    cfg, qp = _port_qpack("Q4_K")
    qp = _on_meta(qp)
    kc, vc = gpt.init_kv_cache(cfg, torch.float32, "meta", batch=3)
    if fault == "scales-bf16":
        qp["wte_s"] = qp["wte_s"].to(torch.bfloat16)
    elif fault == "lm-heads":
        cfg = dataclasses.replace(cfg, n_lm_heads=7)
        qp = {k: v for k, v in qp.items() if not k.startswith("lm_")}
    else:
        qp["blocks"]["qkv_q"] = qp["blocks"]["qkv_q"][:, :-32]
    with pytest.raises(ValueError, match=match):
        kbdec.decode_step_fused_batched(cfg, qp, [1, 2, 3], kc, vc,
                                        [0, 5, 9])


def test_lane_stamps_split_a_stamped_step():
    """A lane plan's stamps: start, after the embed's barrier, each of the
    5 L layer barriers' arrival and release, the end; `step_phases_us`
    names its five phases."""
    plan = kdec.lane_plan(TCFG, 7, 3)  # 2 layers: 10 layer barriers
    stamps = kdec.step_stamps(plan, "cpu")
    assert stamps.shape == (7, 2 * 10 + 3)
    t, row = 1000, [0, 1000]
    for _ in range(10):
        t += 2000
        row.append(t)
        t += 500
        row.append(t)
    row.append(t + 3000)
    us = kdec.step_phases_us(plan, torch.tensor(row))
    assert us["embed"] == 1.0 and us["attention"] == us["proj"] == 2.0
    assert us["ln1_qkv"] == us["ln2_fc"] == us["out"] == 2.0
    assert us["barrier_wait"] == 0.5 and us["lm_head"] == 3.0
    for b in range(7):
        stamps[b] = torch.tensor(row)
    crit = kdec.step_critical_us(plan, stamps)
    assert crit["attention"]["slowest"] == 2.0
    assert crit["step"] == row[-1] / 1e3
