"""The persistent decode step's plan (`bark_tpu_torch.kernels.decode.
step_plan`) and the wrapper's refusals, on the CPU.

The plan says which block of the one cooperative launch takes which
(64-column tile, K range) of each phase's weight, and in which order each
column's split-K partials are folded. Here, for bark-small's three stages
(with their LM windows), the small model of chip_smoke.py's phase 3,
bark-large, and 132, 114, 7 and 1 blocks: every column of every phase is
covered exactly once per K range, the K ranges are 8-row aligned, the fold
order is fixed, bark-small's busiest block streams at most 10% over the
mean at 132 blocks, and a step takes at most 5 barriers a layer plus 2.
The plan executed in plain PyTorch (each item's partial, folded in the
plan's order, as csrc/decode.cu runs it) gives the JAX package's Pallas
decode kernel's logits and cache rows, in interpret mode, within 1e-5
(f32, another summation order). The wrapper refuses what the kernel does
not take before it builds or launches anything.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.kernels import decode as jkdec
from bark_tpu.models import gpt as jgpt
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.models.presets import BARK_LARGE, BARK_SMALL

from test_torch_e2e import one_torch_thread  # autouse

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
CASES = [pytest.param(cfg, win, G, id=f"{name}-{win}-{G}")
         for name, cfg, wins in STAGES for win in wins for G in BLOCKS]


def _phase_shapes(cfg):
    D = cfg.n_embd
    return {"qkv": (D, 3 * D), "proj": (D, D), "fc": (D, 4 * D),
            "out": (4 * D, D)}


@pytest.mark.parametrize("cfg,win,G", CASES)
def test_plan_covers_each_column_once_per_k_range(cfg, win, G):
    plan = kdec.step_plan(cfg, G, win)
    assert plan.n_blocks == G and plan.n_layer == cfg.n_layer
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
            assert k0 % kdec.PLAN_ROWS == 0 and k1 % kdec.PLAN_ROWS == 0
            if name == "proj":  # one head's rows
                assert k0 // kdec.HEAD_DIM == (k1 - 1) // kdec.HEAD_DIM
    flags = [it[3] for it in plan.items[1]]
    writers = [it[1] // kdec.HEAD_DIM for it in plan.items[1]
               if it[3] & kdec.WRITES_KV]
    assert sorted(writers) == list(range(cfg.n_head))
    assert sum(bool(f & kdec.WRITES_SCALES) for f in flags) == 1
    lo, hi = win or (0, cfg.n_out_vocab)
    assert plan.lm[0][0] == lo and plan.lm[-1][1] == hi
    assert all(a[1] == b[0] for a, b in zip(plan.lm, plan.lm[1:]))
    assert plan.n_barriers <= 5 * cfg.n_layer + 2


@pytest.mark.parametrize("cfg,win,G", CASES)
def test_plan_and_table_are_the_same_from_call_to_call(cfg, win, G):
    a, b = kdec.step_plan(cfg, G, win), kdec.step_plan(cfg, G, win)
    assert a == b
    ta, tb = a.table(), b.table()
    assert ta.dtype == np.int32 and np.array_equal(ta, tb)
    # the header the kernel reads (kdec.PL_*, csrc/decode.cu's PL_*):
    # blocks, barriers, lo, hi, layers, and the fold lists where it finds
    # them
    assert list(ta[[kdec.PL_BLOCKS, kdec.PL_BARRIERS, kdec.PL_LO,
                    kdec.PL_HI, kdec.PL_LAYERS]]) == [
        G, a.n_barriers, *a.lm_window, cfg.n_layer]
    for p in range(len(kdec.PHASES)):
        fo, fl = ta[kdec.PL_FOLD_OFF + p], ta[kdec.PL_FOLD + p]
        offs = ta[fo:fo + len(a.folds[p]) + 1]
        lists = ta[fl:fl + offs[-1]]
        for t, fold in enumerate(a.folds[p]):
            assert tuple(lists[offs[t]:offs[t + 1]]) == fold
        st = ta[kdec.PL_STARTS + p]
        assert list(ta[st:st + G + 1]) == list(a.starts[p])


def _block_bytes(plan, D, itemsize):
    """{phase: the weight bytes each block streams}, "lm" included."""
    out = {}
    for p, name in enumerate(kdec.PHASES):
        items, starts = plan.items[p], plan.starts[p]
        out[name] = [sum((k1 - k0) * kdec.PLAN_TILE * itemsize
                         for _, k0, k1, _ in items[starts[b]:starts[b + 1]])
                     for b in range(plan.n_blocks)]
    out["lm"] = [(v1 - v0) * D * itemsize for v0, v1 in plan.lm]
    return out


@pytest.mark.parametrize("stage,win", [("semantic", None),
                                       ("coarse", (SVS, SVS + 2 * CBS)),
                                       ("coarse", None), ("fine", None)])
def test_bark_small_blocks_are_balanced_at_132(stage, win):
    cfg = BARK_SMALL[stage]
    plan = kdec.step_plan(cfg, 132, win)
    for phase, per in _block_bytes(plan, cfg.n_embd, 2).items():
        mean = sum(per) / len(per)
        assert max(per) <= 1.10 * mean, (phase, max(per) / mean)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        kdec.step_plan(dataclasses.replace(BARK_SMALL["coarse"], n_head=16),
                       132)
    with pytest.raises(ValueError):
        kdec.step_plan(BARK_SMALL["coarse"], 0)
    with pytest.raises(ValueError):
        kdec.step_plan(BARK_SMALL["coarse"], 132, (0, 12097))


# ------------------------------------------------------------ the plan run

# tests/test_decode_kernel.py's model (as tests/test_torch_kernels_plain.py)
JCFG = jgpt.GPTConfig(n_layer=2, n_head=2, n_embd=128, block_size=64,
                      n_in_vocab=300, n_out_vocab=200, bias=True)
TCFG = GPTConfig(**dataclasses.asdict(JCFG))


def _run_plan(cfg, plan, params, tok, kc, vc, n_past):
    """The persistent step's arithmetic in plain PyTorch, f32: each phase's
    items computed as partials and folded in the plan's order; the proj
    items from the context of their own head; out's items from the rows of
    h they cover; the LM rows block by block."""
    D, L, H = cfg.n_embd, cfg.n_layer, cfg.n_head
    T, hd = kdec.PLAN_TILE, kdec.HEAD_DIM
    blk = params["blocks"]

    def ln(x, g, b):
        return gpt.layer_norm(x, g, b)

    def project(p, vin_of_item, W, N, bias):
        parts = [vin_of_item(k0, k1) @ W[k0:k1, t * T:(t + 1) * T]
                 for t, k0, k1, _ in plan.items[p]]
        out = torch.empty(N)
        for t, fold in enumerate(plan.folds[p]):
            acc = torch.zeros(T)
            for i in fold:
                acc = acc + parts[i]
            out[t * T:(t + 1) * T] = acc
        return out + bias

    x = params["wte"][0][tok] + params["wpe"][n_past]
    for l in range(L):
        h1 = ln(x, blk["ln1_g"][l], blk["ln1_b"][l])
        qkv = project(0, lambda k0, k1: h1[k0:k1], blk["qkv_w"][l], 3 * D,
                      blk["qkv_b"][l])
        q, k, v = qkv[:D], qkv[D:2 * D], qkv[2 * D:]
        kc[l, n_past], vc[l, n_past] = k, v
        ctx = torch.empty(D)
        for h in range(H):
            cols = slice(h * hd, (h + 1) * hd)
            s = kc[l, :n_past + 1, cols] @ q[cols] / hd ** 0.5
            ctx[cols] = torch.softmax(s, 0) @ vc[l, :n_past + 1, cols]

        def head_ctx(k0, k1):
            assert k0 // hd == (k1 - 1) // hd
            return ctx[k0:k1]

        x = x + project(1, head_ctx, blk["proj_w"][l], D, blk["proj_b"][l])
        h2 = ln(x, blk["ln2_g"][l], blk["ln2_b"][l])
        f = gpt.gelu(project(2, lambda k0, k1: h2[k0:k1], blk["fc_w"][l],
                             4 * D, blk["fc_b"][l]))
        x = x + project(3, lambda k0, k1: f[k0:k1], blk["out_w"][l], D,
                        blk["out_b"][l])
    xf = ln(x, params["ln_f_g"], params["ln_f_b"])
    logits = torch.zeros(cfg.n_out_vocab)
    for v0, v1 in plan.lm:
        logits[v0:v1] = params["lm_head"][0][v0:v1] @ xf
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


# ------------------------------------------------------------ refusals


def _meta(cfg, quant=False, **kv_kw):
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    params = {k: ({kk: vv.to("meta") for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to("meta"))
              for k, v in params.items()}
    kc, vc = gpt.init_kv_cache(cfg, torch.float32, "meta", quant=quant)
    return params, kc, vc


SMALL = TCFG


@pytest.fixture
def no_launch(monkeypatch):
    """Fail the test if the wrapper reaches the kernel library."""

    def refuse():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(_build, "lib", refuse)
    before = kdec.launches
    yield
    assert kdec.launches == before


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
