"""K2's and K8's bf16 GEMM plan (`bark_tpu_torch.kernels.prefill.gemm_plan`)
and the prefill wrappers' refusals, on the CPU.

- The plan covers every output tile once, each tile's K once over its
  splits, in whole 64-deep stages, split work items within one an SM; it
  is the same plan from call to call, and its fold (`planned_matmul`) is
  the same bits from call to call and equal to the partials added in
  split order.
- The plan's arithmetic in plain PyTorch (f32, every projection summed as
  the planned GEMM sums it, rounded at the reference's epilogue points by
  `gpt.prefill`) against `bark_tpu.kernels.prefill.prefill_fused` run as
  the JAX tests run it on the CPU (interpret mode) at a small model:
  logits of the last live row and live cache rows within 1e-5 absolute
  (f32 on both sides, another summation order).
- The K2 and K8 wrappers refuse an unsupported width, T, dtype, window or
  weight alignment before any launch (meta tensors; the kernel library is
  never reached).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.kernels import prefill as jkpre
from bark_tpu.models import gpt as jgpt
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import bprefill as tkbpre
from bark_tpu_torch.kernels import prefill as tkpre
from bark_tpu_torch.models import config as tconfig
from bark_tpu_torch.models import gpt as tgpt
from bark_tpu_torch.models.presets import BARK_LARGE, BARK_SMALL

from test_torch_e2e import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5
# tests/test_prefill_kernel.py's model (tests/test_torch_kernels_plain.py)
JCFG = jgpt.GPTConfig(n_layer=2, n_head=2, n_embd=128, block_size=512,
                      n_in_vocab=300, n_out_vocab=200, bias=True)
TCFG = tconfig.GPTConfig(**dataclasses.asdict(JCFG))

WIDTHS = {"bark-small": BARK_SMALL["coarse"].n_embd,
          "bark-large": BARK_LARGE["coarse"].n_embd, "small": 128}
ROWS = (1, 63, 64, 65, 257, 617, 887, 1024, 2 * 887)


def _shapes(D):
    return {"qkv": (3 * D, D), "proj": (D, D), "fc": (4 * D, D),
            "out": (D, 4 * D)}


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("width", WIDTHS)
def test_plan_covers_every_tile_and_k_once(width, M, sms):
    for name, (N, K) in _shapes(WIDTHS[width]).items():
        plan = tkpre.gemm_plan(M, N, K, sms)
        assert (plan.bm, plan.bn) in tkpre.GEMM_TILES, name
        assert N % plan.bn == 0, name
        assert plan.splits in (1, 2, 4), name
        assert (K // tkpre.GEMM_DEPTH) % plan.splits == 0, name
        assert plan.splits == 1 or plan.blocks <= sms, name
        gx, gy, gz = plan.grid()
        assert gx * gy == plan.tiles and plan.blocks == plan.tiles * gz
        cover = np.zeros((M, N), np.int32)
        for bx in range(gx):
            for by in range(gy):
                ks = []
                for bz in range(gz):
                    rows, cols, kr = plan.block(bx, by, bz)
                    assert len(kr) % tkpre.GEMM_DEPTH == 0 and len(kr) > 0
                    ks.extend(kr)
                    if bz == 0:
                        cover[rows.start:rows.stop, cols.start:cols.stop] += 1
                assert ks == list(range(K)), (name, bx, by)
        assert (cover == 1).all(), name


def test_plan_fills_the_card_at_a_request_rows():
    """bark-small at the semantic prompt's 257 rows and at 887: the largest
    tiles that still give half a card of them, K split where the tiles are
    few; (rows, columns, splits, work items) of qkv, proj, fc and out."""
    D = WIDTHS["bark-small"]
    got = {M: [(p.bm, p.bn, p.splits, p.blocks)
               for p in tkpre.layer_plans(D, M)] for M in (257, 887)}
    assert got[257] == [(64, 64, 1, 180), (64, 64, 2, 120),
                        (128, 128, 1, 72), (64, 64, 2, 120)]
    assert got[887] == [(128, 128, 1, 126), (64, 64, 1, 168),
                        (128, 128, 1, 168), (64, 64, 1, 168)]


@pytest.mark.parametrize("M,N,K", [(257, 768, 3072), (300, 128, 512),
                                   (65, 128, 128)])
def test_plan_fold_order_is_fixed(M, N, K):
    plan = tkpre.gemm_plan(M, N, K)
    assert plan == tkpre.gemm_plan(M, N, K)
    assert plan.splits > 1
    rng = np.random.RandomState(M)
    a = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    w = torch.from_numpy(rng.randn(K, N).astype(np.float32))
    out = tkpre.planned_matmul(a, w, plan)
    assert torch.equal(out, tkpre.planned_matmul(a, w, plan))
    k = K // plan.splits
    parts = [a[:, s * k:(s + 1) * k] @ w[s * k:(s + 1) * k]
             for s in range(plan.splits)]
    folded = parts[0]
    for p in parts[1:]:
        folded = folded + p
    assert torch.equal(out, folded)
    np.testing.assert_allclose(out.numpy(), (a @ w).numpy(), rtol=0,
                               atol=1e-3)


def _params(seed):
    host = jgpt.init_params_numpy(JCFG, seed)
    rng = np.random.RandomState(seed + 1)
    for k, v in host["blocks"].items():
        if k.endswith("_b"):
            host["blocks"][k] = (rng.randn(*v.shape) * 0.01).astype(
                np.float32)
    jp = jax.tree.map(jnp.asarray, host)
    return jp, tloader.params_from_numpy(host, torch.float32, "cpu")


@pytest.mark.parametrize("T,n_valid", [(384, 300), (128, 65)])
def test_planned_prefill_matches_pallas(monkeypatch, T, n_valid):
    """Every projection of gpt.prefill summed as the planned GEMM sums it
    (split K, partials in split order; the small model's plans split qkv,
    proj and fc 2 ways and out 4 ways at these rows), against the JAX
    package's Pallas prefill in interpret mode."""
    plans = tkpre.layer_plans(TCFG.n_embd, n_valid)
    assert [p.splits for p in plans] == [2, 2, 2, 4]

    def planned_proj(x, layer, key):
        w = layer[key + "_w"]
        return tkpre.planned_matmul(
            x, w, tkpre.gemm_plan(x.shape[0], w.shape[1], w.shape[0]))

    monkeypatch.setattr(tgpt, "_proj", planned_proj)
    jp, tp = _params(2)
    x = (np.random.RandomState(3).randn(T, TCFG.n_embd) * 0.02).astype(
        np.float32)
    shape = (JCFG.n_layer, JCFG.block_size, JCFG.n_embd)
    jl, jk, jv = jkpre.prefill_fused(
        JCFG, jkpre.prepare_prefill_params(JCFG, jp), jnp.asarray(x),
        jnp.zeros(shape), jnp.zeros(shape), jnp.int32(n_valid),
        interpret=True)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tl = tkpre.prefill_fused(TCFG, tp, torch.from_numpy(x), tk, tv, n_valid)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(t[:, :n_valid].numpy(),
                                   np.asarray(j)[:, :n_valid], rtol=0,
                                   atol=ATOL)


def test_query_tiles_of_64_rows():
    """The tensor-core attention's 64-row query tiles of K8 never straddle
    two lanes: (lane, first row, lane's first stacked row)."""
    tiles = tkbpre.query_tiles([65, 1, 130], tkbpre.TC_QUERY_TILE)
    assert tiles.tolist() == [[0, 0, 0], [0, 64, 0], [1, 0, 65],
                              [2, 0, 66], [2, 64, 66], [2, 128, 66]]


# ------------------------------------------------------------ refusals


def _meta_params(cfg, dtype):
    p = tgpt.init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")

    def meta(t):
        return torch.empty(t.shape, dtype=dtype, device="meta")

    return {k: ({kk: meta(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else meta(v))
            for k, v in p.items()}


@pytest.fixture
def no_launch(monkeypatch):
    """Fail the test if a wrapper reaches the kernel library."""

    def refuse():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(_build, "lib", refuse)
    before = tkpre.launches, tkbpre.launches
    yield
    assert (tkpre.launches, tkbpre.launches) == before


SMALL = dataclasses.replace(TCFG, block_size=64)


def _call(batched, cfg, params, T, n_valid, lm_window=None, x_dtype=None):
    dtype = params["wpe"].dtype
    x_dtype = x_dtype or dtype
    if batched:
        x = torch.empty((2, T, cfg.n_embd), dtype=x_dtype, device="meta")
        kc, vc = tgpt.init_kv_cache(cfg, dtype, "meta", batch=2)
        return tkbpre.prefill_fused_batched(cfg, params, x, kc, vc,
                                            [n_valid, 1],
                                            lm_window=lm_window)
    x = torch.empty((T, cfg.n_embd), dtype=x_dtype, device="meta")
    kc, vc = tgpt.init_kv_cache(cfg, dtype, "meta")
    return tkpre.prefill_fused(cfg, params, x, kc, vc, n_valid,
                               lm_window=lm_window)


def _misaligned(params):
    w = params["blocks"]["out_w"]
    moved = torch.empty(w.numel() + 1, dtype=w.dtype,
                        device="meta")[1:].view(w.shape)
    return {**params, "blocks": {**params["blocks"], "out_w": moved}}


@pytest.mark.parametrize("batched", [False, True], ids=["K2", "K8"])
@pytest.mark.parametrize("fault,match", [
    ("head-dim-32", "head dim"), ("width-96", "width"),
    ("float16", "float32/bfloat16"), ("slots-2048", "cache slots"),
    ("n_valid-0", "n_valid"), ("n_valid-past-T", "n_valid"),
    ("n_valid-past-slots", "n_valid"), ("x-dtype", "x_emb"),
    ("window", "lm_window"), ("misaligned-out_w", "16-byte aligned")])
def test_wrapper_refuses_before_any_launch(no_launch, batched, fault,
                                           match):
    cfg, dtype, T, n, win, x_dtype = SMALL, torch.bfloat16, 32, 16, None, None
    if fault == "head-dim-32":
        cfg = dataclasses.replace(cfg, n_head=4)
    elif fault == "width-96":
        cfg = dataclasses.replace(cfg, n_embd=96, n_head=1)
    elif fault == "float16":
        dtype = torch.float16
    elif fault == "slots-2048":
        cfg = dataclasses.replace(cfg, block_size=2048)
    elif fault == "n_valid-0":
        n = 0
    elif fault == "n_valid-past-T":
        n = T + 1
    elif fault == "n_valid-past-slots":
        T = n = cfg.block_size + 1
    elif fault == "x-dtype":
        x_dtype = torch.float32
    elif fault == "window":
        win = (0, cfg.n_out_vocab + 1)
    params = _meta_params(cfg, dtype)
    if fault.startswith("misaligned"):
        params = _misaligned(params)
    with pytest.raises(ValueError, match=match):
        _call(batched, cfg, params, T, n, win, x_dtype)


@pytest.mark.parametrize("batched", [False, True], ids=["K2", "K8"])
def test_wrapper_takes_misaligned_f32_weights_to_the_checks(no_launch,
                                                            batched):
    """f32 weights are not read by TMA: alignment is no refusal, so a
    well-formed f32 call on meta tensors gets past every prefill check (to
    the stage weights, which want a CUDA device)."""
    params = _misaligned(_meta_params(SMALL, torch.float32))
    with pytest.raises(ValueError, match="CUDA device"):
        _call(batched, SMALL, params, 32, 16)
