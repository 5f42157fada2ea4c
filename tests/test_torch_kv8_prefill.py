"""K6c alone (`bark_tpu_torch.kernels.kv8.attn_prefill`: one layer's causal
attention of a prefill on an int8 cache) against the JAX package on the
CPU, where the entry runs its plain version:

- one lane at T 1, 63, 64 and 65 (a 64-row query tile, one past it) and
  130, two heads of 64, f32 and bf16 query rows: the caches hold numpy
  rows quantized by each package's own `quantize_kv_rows`, and the context
  is held against `bark_tpu.models.gpt._attention_int8` (plain XLA, as
  `bark_tpu.models.gpt.prefill` runs it on an int8 cache) under the
  causal mask: f32 within 3e-3 (tests/test_torch_kv8.py's bound), bf16
  within 1e-1;
- K8's stacked form: three lanes of 130, 64 and 37 rows (two end inside a
  64-row tile) in one (B, S, D) cache, each lane against its own JAX call;
- the entry on dense caches (the prefills' dense attention, which the
  card times K6c beside) against `bark_tpu.models.gpt._attention`;
- the refusals (query shape, dtype, head dim, cache form, n_valid, cache
  slots) raise before any launch (meta tensors; the kernel library is
  never reached).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.models import gpt as jgpt
from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import kv8 as tkv8
from bark_tpu_torch.models import config as tconfig
from bark_tpu_torch.models import gpt as tgpt

from test_torch_e2e import one_torch_thread  # noqa: F401  (autouse)

CFG = jgpt.GPTConfig(n_layer=1, n_head=2, n_embd=128, block_size=160,
                     n_in_vocab=300, n_out_vocab=200, bias=True)
TCFG = tconfig.GPTConfig(**dataclasses.asdict(CFG))
ATOL = {"float32": 3e-3, "bfloat16": 1e-1}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
LANES = [130, 64, 37]


def _rows(rng, n):
    return (rng.randn(n, CFG.n_embd) * 0.5).astype(np.float32)


def _caches(rng, lanes):
    """(port, JAX) int8 K and V caches of one layer: lane b's rows [0,
    lanes[b]) are the same numpy rows quantized by each package's
    quantize_kv_rows, the rest zeros; (B, S, D) / (B, S) for a list,
    (S, D) / (S,) for an int."""
    one = isinstance(lanes, int)
    ns = [lanes] if one else lanes
    S, D = CFG.block_size, CFG.n_embd
    port, jax_ = [], []
    for _ in range(2):
        tq = torch.zeros((len(ns), S, D), dtype=torch.int8)
        ts = torch.zeros((len(ns), S))
        jq = np.zeros((len(ns), S, D), np.int8)
        js = np.zeros((len(ns), S), np.float32)
        for b, n in enumerate(ns):
            x = np.zeros((S, D), np.float32)  # zero rows quantize to zeros
            x[:n] = _rows(rng, n)
            tq[b], ts[b] = tgpt.quantize_kv_rows(torch.from_numpy(x))
            q, s = jgpt.quantize_kv_rows(jnp.asarray(x))
            jq[b], js[b] = np.asarray(q), np.asarray(s)
        if one:
            tq, ts, jq, js = tq[0], ts[0], jq[0], js[0]
        port.append({"q": tq, "s": ts})
        jax_.append({"q": jnp.asarray(jq), "s": jnp.asarray(js)})
    return port, jax_


def _jax_context(q, kc, vc, n, jdt):
    """bark_tpu's _attention_int8 of n query rows over a lane's int8 cache
    under the prefill's causal mask, as f32 numpy. The rows are padded to
    the S slots (a row attends only to its own keys, and one shape keeps
    XLA to one compile a dtype)."""
    S = CFG.block_size
    rows = np.zeros((S, CFG.n_embd), np.float32)
    rows[:n] = q
    slot = np.arange(S)
    mask = jnp.asarray(slot[None, :] <= slot[:, None])
    out = jgpt._attention_int8(CFG, jnp.asarray(rows).astype(jdt), kc, vc,
                               mask)
    return np.asarray(out.astype(jnp.float32))[:n]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T", [1, 63, 64, 65, 130])
def test_attn_prefill_one_lane_matches_bark_tpu(T, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(T)
    (kc, vc), (jkc, jvc) = _caches(rng, T)
    q = _rows(rng, T) * 4.0
    got = tkv8.attn_prefill(TCFG, torch.from_numpy(q).to(tdt), kc, vc, T)
    assert got.shape == (T, CFG.n_embd) and got.dtype == tdt
    want = _jax_context(q, jkc, jvc, T, jdt)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attn_prefill_stacked_lanes_match_bark_tpu(dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(7)
    (kc, vc), (jkc, jvc) = _caches(rng, LANES)
    q = _rows(rng, sum(LANES)) * 4.0
    got = tkv8.attn_prefill(TCFG, torch.from_numpy(q).to(tdt), kc, vc, LANES)
    assert got.shape == (sum(LANES), CFG.n_embd) and got.dtype == tdt
    first = 0
    for b, n in enumerate(LANES):
        want = _jax_context(q[first:first + n],
                            {k: v[b] for k, v in jkc.items()},
                            {k: v[b] for k, v in jvc.items()}, n, jdt)
        np.testing.assert_allclose(got[first:first + n].float().numpy(), want,
                                   rtol=0, atol=ATOL[dtype])
        first += n


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("lanes", [65, LANES], ids=["one-lane", "K8"])
def test_attn_prefill_dense_cache_matches_bark_tpu(lanes, dtype):
    """The entry on dense caches (the yardstick the card times K6c beside):
    bark_tpu's `_attention` on the same rows."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(11)
    one = isinstance(lanes, int)
    ns = [lanes] if one else lanes
    S, D = CFG.block_size, CFG.n_embd
    cache = np.zeros((2, len(ns), S, D), np.float32)
    for b, n in enumerate(ns):
        cache[:, b, :n] = rng.randn(2, n, D) * 0.5
    kc, vc = (torch.from_numpy(c[0] if one else c).to(tdt) for c in cache)
    q = _rows(rng, sum(ns)) * 4.0
    got = tkv8.attn_prefill(TCFG, torch.from_numpy(q).to(tdt), kc, vc,
                            lanes)
    slot = np.arange(S)
    mask = jnp.asarray(slot[None, :] <= slot[:, None])
    first = 0
    for b, n in enumerate(ns):
        rows = np.zeros((S, D), np.float32)
        rows[:n] = q[first:first + n]
        k, v = (jnp.asarray(c[b]).astype(jdt) for c in cache)
        want = jgpt._attention(jnp.asarray(rows).astype(jdt), k, v, mask, CFG)
        np.testing.assert_allclose(
            got[first:first + n].float().numpy(),
            np.asarray(want.astype(jnp.float32))[:n], rtol=0,
            atol=ATOL[dtype])
        first += n


@pytest.fixture
def no_launch(monkeypatch):
    """Fail the test if the entry reaches the kernel library."""

    def refuse():
        raise AssertionError("attn_prefill reached the kernel library")

    monkeypatch.setattr(_build, "lib", refuse)
    yield


def _meta_cache(cfg, lanes, dtype=torch.int8, scale_key="s"):
    lead = () if isinstance(lanes, int) else (len(lanes),)
    S, D = cfg.block_size, cfg.n_embd
    return {"q": torch.empty(lead + (S, D), dtype=dtype, device="meta"),
            scale_key: torch.empty(lead + (S,), device="meta")}


@pytest.mark.parametrize("stacked", [False, True], ids=["one-lane", "K8"])
@pytest.mark.parametrize("fault,match", [
    ("q-rows", "q: want"), ("q-float16", "q: want"),
    ("head-dim-32", "head_dim 64"), ("cache-bf16", "int8 layer cache 'q'"),
    ("cache-slots", "int8 layer cache 'q'"),
    ("no-scales", "int8 layer cache 's'"),
    ("v-dense", "both be int8 or dense"),
    ("dense-cache-dtype", "layer cache: want"), ("n_valid-0", "n_valid"),
    ("n_valid-past-slots", "n_valid"), ("slots-2048", "1024 cache slots")])
def test_attn_prefill_refuses_before_any_launch(no_launch, stacked, fault,
                                                match):
    cfg, lanes, qdt = TCFG, ([40, 17] if stacked else 40), torch.bfloat16
    if fault == "head-dim-32":
        cfg = dataclasses.replace(cfg, n_head=4)
    elif fault == "slots-2048":
        cfg = dataclasses.replace(cfg, block_size=2048)
    elif fault == "q-float16":
        qdt = torch.float16
    elif fault == "n_valid-0":
        lanes = [40, 0] if stacked else 0
    elif fault == "n_valid-past-slots":
        n = cfg.block_size + 1
        lanes = [40, n] if stacked else n
    M = sum(lanes) if stacked else lanes
    q = torch.empty((M + (fault == "q-rows"), cfg.n_embd), dtype=qdt,
                    device="meta")
    kc = _meta_cache(cfg, lanes)
    vc = _meta_cache(cfg, lanes, scale_key="x" if fault == "no-scales"
                     else "s")
    if fault == "cache-bf16":
        kc = _meta_cache(cfg, lanes, dtype=torch.bfloat16)
    elif fault == "cache-slots":
        kc = _meta_cache(dataclasses.replace(cfg, block_size=96), lanes)
    elif fault == "v-dense":
        vc = vc["q"].to(qdt)
    elif fault == "dense-cache-dtype":
        kc, vc = kc["q"].float(), vc["q"].float()
    with pytest.raises(ValueError, match=match):
        tkv8.attn_prefill(cfg, q, kc, vc, lanes)


@pytest.mark.parametrize("fault", ["one-lane", "short", "int64", "cpu"])
def test_attn_prefill_refuses_foreign_tables(no_launch, fault):
    """Prebuilt tables that are not `attn_prefill_tables` of the launch's
    lanes on q's device are refused before any launch."""
    lanes = 40 if fault == "one-lane" else [40, 17, 64]
    M = sum(lanes) if fault != "one-lane" else lanes
    q = torch.empty((M, TCFG.n_embd), dtype=torch.bfloat16, device="meta")
    kc, vc = _meta_cache(TCFG, lanes), _meta_cache(TCFG, lanes)
    tables = tkv8.attn_prefill_tables([40, 17, 64], TCFG.block_size,
                                      torch.device("cpu"))
    if fault == "short":
        tables = tables[:-1]
    elif fault == "int64":
        tables = tables.long()
    if fault != "cpu":
        tables = tables.to("meta")
    with pytest.raises(ValueError, match="tables"):
        tkv8.attn_prefill(TCFG, q, kc, vc, lanes, tables=tables)


def test_attn_prefill_tables_layout():
    """`attn_prefill_tables`: K8's row tables, then the 64-row query
    tiles, as one int32 vector."""
    from bark_tpu_torch.kernels import bprefill

    lanes, S = [40, 17, 64, 65], TCFG.block_size
    got = tkv8.attn_prefill_tables(lanes, S, torch.device("cpu"))
    rows = bprefill.row_tables(lanes, max(lanes), S)[0]
    tiles64 = bprefill.query_tiles(lanes, bprefill.TC_QUERY_TILE)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.concatenate([rows, tiles64.reshape(-1)]))
    assert len(tiles64) == 5
