"""bark-large (24 layers, 16 heads, width 1024) on the CPU: the kernels'
limits and the port's plain functions at its layout.

Limits: the Python mirrors of the CUDA kernels' compiled limits equal the
`constexpr`s in `bark_tpu_torch/csrc/`, read from the sources (lanes,
(head, lane) units against the step's threads, the plan table's ints,
the items a block owns, the widths VPT and MAX_TILES hold), and
bark-large meets them: its 16 heads at 32 lanes are the 512 units, its
width the 1024 columns, its step plans at 132 and 7 blocks,
dense and packed, fit the plan table, and its lane plans at the 132 and
114 blocks of an H100 (SXM, PCIe) the items a block owns.

Parity: on bark-large's layout (16 heads of 64 at width 1024) at 2
layers, small vocabularies and a 256-slot cache, f32, weights from one
`init_params_numpy` seed carried across by `io.loader.params_from_numpy`:
the port's prefill (`kernels.prefill.prefill_fused`, its plain version
on CPU tensors), 8 decode steps (`kernels.decode.decode_step_fused`)
each sampling with bark_tpu's Gumbel noise, and a fine forward against
bark_tpu's plain XLA functions (`models.gpt.prefill`, `decode_step`,
`fine_forward`): logits within ATOL, tokens equal.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.models import gpt as jgpt
from bark_tpu.ops import sampling as jsampling
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.kernels import prefill as kpre
from bark_tpu_torch.models import config as tconfig
from bark_tpu_torch.models import gpt as tgpt
from bark_tpu_torch.models.presets import BARK_LARGE
from bark_tpu_torch.ops import sampling

from test_torch_e2e import AUDIO_ATOL, one_torch_thread  # noqa: F401

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "bark_tpu_torch",
                    "csrc")
# tests/test_torch_e2e.py's tolerance (its audio's): the two packages
# compute the same f32 ops in another summation order
ATOL = AUDIO_ATOL
SVS, CBS = 10000, 1024
LMW = (SVS, SVS + 2 * CBS)


def _constexpr(source: str, name: str) -> int:
    """`constexpr int name = <int>;` of csrc/<source>."""
    with open(os.path.join(CSRC, source)) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    assert len(found) == 1, (source, name, found)
    return int(found[0])


def test_python_limits_equal_the_kernels():
    threads = _constexpr("step.cuh", "PS_THREADS")
    assert kdec.MAX_LANES == _constexpr("lane.cuh", "MAX_LANES") == 32
    assert kdec.MAX_UNITS == threads == 512  # one (head, lane) unit a thread
    assert kdec.PLAN_MAX == _constexpr("decode.cu", "PLAN_MAX")
    assert kdec.MAX_OWN == _constexpr("lane.cuh", "MAX_OWN")
    assert kdec.HEAD_DIM == _constexpr("step.cuh", "HD") == 64
    tile = _constexpr("step.cuh", "TILE")
    assert kdec.PLAN_TILE == tile
    # a row's columns: VPT a thread of the step, MAX_TILES tiles of the
    # batched step
    assert (kdec.MAX_WIDTH == _constexpr("decode.cu", "VPT") * threads
            == _constexpr("lane.cuh", "MAX_TILES") * tile == 1024)


def test_bark_large_meets_the_limits_exactly():
    for cfg in BARK_LARGE.values():
        assert cfg.n_embd == kdec.MAX_WIDTH
        assert cfg.n_embd // cfg.n_head == kdec.HEAD_DIM
        assert cfg.n_head * kdec.MAX_LANES == kdec.MAX_UNITS
        assert cfg.block_size == 1024


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("G", [132, 7])
@pytest.mark.parametrize("stage,win", [("semantic", None), ("coarse", LMW)])
def test_bark_large_step_plans_fit_the_table(stage, win, G, packed):
    table = kdec.step_plan(BARK_LARGE[stage], G, win, packed=packed).table()
    assert len(table) <= kdec.PLAN_MAX


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("G", [132, 114])
@pytest.mark.parametrize("stage,win", [("semantic", None), ("coarse", LMW)])
def test_bark_large_lane_plans_fit_the_items_a_block_owns(stage, win, G,
                                                          packed):
    """At the grids of an H100 SXM (132 blocks) and PCIe (114). A lane
    plan's items a block owns grow as the grid shrinks, with either
    model: bark-small's semantic head too is past MAX_OWN below ~33
    blocks (46 items at 7), where the wrapper refuses the plan."""
    cfg = BARK_LARGE[stage]
    for B in (1, 8, 32):
        plan = kdec.lane_plan(cfg, G, B, win, packed=packed)
        assert 1 <= plan.max_own <= kdec.MAX_OWN
        assert len(plan.pairs) == cfg.n_head * B <= kdec.MAX_UNITS
    assert len(plan.pairs) == kdec.MAX_UNITS  # 32 lanes: every thread


@pytest.fixture
def meta_stage():
    """A bark-large-layout stage one head wider (17 x 64 = 1088 columns)
    on meta tensors: past the columns the steps hold."""
    cfg = tconfig.GPTConfig(n_layer=1, n_head=17, n_embd=1088,
                            block_size=64, n_in_vocab=80, n_out_vocab=80,
                            bias=True)
    p = tgpt.init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "meta")
    return cfg, p


def test_steps_refuse_a_wider_row_before_any_launch(meta_stage, monkeypatch):
    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.kernels import bdecode as kbdec

    def refuse():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(_build, "lib", refuse)
    cfg, p = meta_stage
    kc, vc = tgpt.init_kv_cache(cfg, torch.float32, "meta")
    with pytest.raises(ValueError, match="1024"):
        kdec.decode_step_fused(cfg, p, 3, kc, vc, 5)
    kc, vc = tgpt.init_kv_cache(cfg, torch.float32, "meta", batch=2)
    with pytest.raises(ValueError, match="1024"):
        kbdec.decode_step_fused_batched(
            cfg, p, torch.zeros(2, dtype=torch.int32, device="meta"), kc, vc,
            [5, 6])
    with pytest.raises(ValueError, match="1024"):
        kdec.step_plan(cfg, 7)
    with pytest.raises(ValueError, match="1024"):
        kdec.lane_plan(cfg, 7, 2)


# ------------------------------------------- parity at bark-large's layout

CFG = jgpt.GPTConfig(n_layer=2, n_head=16, n_embd=1024, block_size=256,
                     n_in_vocab=300, n_out_vocab=200, bias=True)
FINE = jgpt.GPTConfig(n_layer=2, n_head=16, n_embd=1024, block_size=256,
                      n_in_vocab=96, n_out_vocab=96, n_lm_heads=7, n_wtes=8,
                      bias=True)


def _pair(cfg, seed):
    """(config, bark_tpu's params, the port's config and params) from one
    `init_params_numpy` seed, with non-trivial biases and LN affines."""
    host = jgpt.init_params_numpy(cfg, seed)
    rng = np.random.RandomState(seed + 1)
    for k, v in host["blocks"].items():
        if k.endswith("_b") or k.endswith("_g"):
            host["blocks"][k] = v + rng.randn(*v.shape).astype(
                np.float32) * 0.05
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    tp = tloader.params_from_numpy(host, torch.float32, "cpu")
    return jp, tconfig.GPTConfig(**dataclasses.asdict(cfg)), tp


def test_prefill_and_sampled_steps_match_bark_tpu():
    jp, tcfg, tp = _pair(CFG, 0)
    T, steps, temp = 64, 8, 0.7
    toks = np.random.RandomState(2).randint(0, CFG.n_in_vocab, T)
    x = np.asarray(jp["wte"][0])[toks]
    shape = (CFG.n_layer, CFG.block_size, CFG.n_embd)
    jl, jk, jv = jgpt.prefill(CFG, jp, jnp.asarray(x), jnp.zeros(shape),
                              jnp.zeros(shape), jnp.int32(T))
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tl = kpre.prefill_fused(tcfg, tp, torch.from_numpy(x), tk, tv, T)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    key = jax.random.PRNGKey(3)
    for j in range(steps):
        key, sub = jax.random.split(key)
        jtok, _ = jsampling.sample(sub, jl, temp)
        # jax.random.categorical(sub, l) is argmax(l + gumbel(sub))
        noise = torch.from_numpy(np.array(jax.random.gumbel(
            sub, (CFG.n_out_vocab,), jnp.float32)))
        ttok, _ = sampling.sample(tl, temp, noise)
        assert int(ttok) == int(jtok), j
        jl, jk, jv = jgpt.decode_step(CFG, jp, jtok, jk, jv,
                                      jnp.int32(T + j))
        tl = kdec.decode_step_fused(tcfg, tp, int(ttok), tk, tv, T + j)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(tk[:, :T + steps].numpy(),
                               np.asarray(jk)[:, :T + steps], rtol=0,
                               atol=ATOL)


def test_fine_forward_matches_bark_tpu():
    jp, tcfg, tp = _pair(FINE, 4)
    toks = np.random.RandomState(5).randint(
        0, FINE.n_in_vocab, (64, FINE.n_wtes)).astype(np.int32)
    jl = jgpt.fine_forward(FINE, jp, jnp.asarray(toks), 3)
    tl = tgpt.fine_forward(tcfg, tp, torch.from_numpy(toks), 3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
