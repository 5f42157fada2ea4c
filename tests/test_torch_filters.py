"""Top-k and top-p sampling in the port against bark_tpu, f32 on the CPU.

- The filters alone (`ops.sampling.apply_top_k`, `apply_top_p`) and the
  filtered sampler on seeded rows: the same kept sets and the same tokens
  as bark_tpu's given its Gumbel noise. Top-p sums the sorted softmax in
  PyTorch's order, XLA in its own, so a cumulative mass within a few f32
  ulps of top_p may keep or drop one more token: a difference in the kept
  sets is accepted only where the mass before the token is within
  TOP_P_ULPS ulps of top_p; such cases are counted and printed.
- Whole requests on the tiny model with the filters (top_k, top_p, both):
  `generate_audio` through the filtered single-step loops (K1's and K5's
  plain versions) and `generate_audio_batch` (K7's and K5-batched's), at
  temp 0.7 with bark_tpu's noise replayed and at temp 0, dense and from a
  q8_0 file loaded packed: semantic, coarse and fine tokens equal to
  bark_tpu's, audio within AUDIO_ATOL. A batch lane is held against
  bark_tpu's single request with that lane's noise (bark_tpu's batched
  programs are token-equal to its single ones per lane, by its own tests),
  and against the port's single request.

bark_tpu's runs come from tests/torch_jax_reference.py: one context,
whose programs are keyed by (temp, top_k, top_p), so a configuration
compiles only its semantic and coarse programs, and the q8_0 file's
requests run them on that file's arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu_torch
from bark_tpu.ops import sampling as jsamp
from bark_tpu_torch.kernels import bdecode as tkbdec
from bark_tpu_torch.kernels import decode as tkdec
from bark_tpu_torch.ops import sampling as tsamp

import torch_jax_reference as ref
from test_torch_e2e import (AUDIO_ATOL, gumbel_from_key, one_torch_thread,
                            replay_bark_tpu_noise)
from tiny_model import tiny_params

TOP_P_ULPS = 4
STAGES = ("semantic", "coarse", "fine")
FILTERS = {"top_k": dict(top_k=3), "top_p": dict(top_p=0.7),
           "both": dict(top_k=5, top_p=0.8)}
TEXTS = ["hello world", "the a hello", "world world the"]
SEED = 0


def _rows(seed: int, n: int = 48, V: int = 257):
    """Seeded logits rows at several scales (flat to peaked)."""
    rng = np.random.RandomState(seed)
    scales = np.geomspace(0.3, 8.0, n)[:, None]
    return (rng.randn(n, V) * scales).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 5, 17, 64, 300])
def test_top_k_equals_bark_tpu(k):
    """Bit-equal rows (-inf outside the top k, the logit inside); k past
    the width keeps everything (suno's clamp)."""
    x = _rows(k)
    j = np.array(jsamp.apply_top_k(jnp.asarray(x), k))
    t = tsamp.apply_top_k(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(t, j)
    assert (np.isfinite(t).sum(axis=1) == min(k, x.shape[1])).all()


@pytest.mark.parametrize("p", [0.05, 0.3, 0.5, 0.8, 0.9, 0.95, 0.999])
def test_top_p_kept_sets_equal_bark_tpu(p):
    """The kept sets equal bark_tpu's, but where the sorted cumulative mass
    before a token is within TOP_P_ULPS f32 ulps of p (counted, printed);
    every kept logit keeps its value."""
    x = _rows(int(p * 1000), n=64)
    j = np.array(jsamp.apply_top_p(jnp.asarray(x), p))
    t = tsamp.apply_top_p(torch.from_numpy(x), p).numpy()
    kept_t, kept_j = np.isfinite(t), np.isfinite(j)
    np.testing.assert_array_equal(t[kept_t], x[kept_t])
    order = np.argsort(-x, axis=1, kind="stable")
    xs = np.take_along_axis(x.astype(np.float64), order, axis=1)
    mass = np.exp(xs - xs[:, :1])
    before = np.cumsum(mass / mass.sum(axis=1, keepdims=True), axis=1)
    before = np.concatenate([np.zeros_like(before[:, :1]),
                             before[:, :-1]], axis=1)
    ulp = np.spacing(np.float32(p))
    boundary = 0
    for r, c in zip(*np.nonzero(kept_t != kept_j)):
        pos = int(np.nonzero(order[r] == c)[0][0])
        assert abs(before[r, pos] - p) <= TOP_P_ULPS * ulp, (r, c)
        boundary += 1
    print(f"top_p {p}: {boundary} token(s) kept by one and dropped by the "
          f"other at the ulp boundary, of {x.shape[0]} rows")
    assert kept_t[np.arange(x.shape[0]), order[:, 0]].all()


def test_top_p_splits_ties_in_sorted_order():
    """Equal logits straddling the cutoff are split as the stable
    descending sort orders them (lowest index first), as in bark_tpu."""
    x = np.array([[0.0, 2.0, 1.0, 2.0, 2.0, 1.0, 0.5]] * 3, np.float32)
    for p in (0.3, 0.5, 0.7):
        j = np.array(jsamp.apply_top_p(jnp.asarray(x[:1]), p))
        t = tsamp.apply_top_p(torch.from_numpy(x[:1]), p).numpy()
        np.testing.assert_array_equal(t, j)
    t = tsamp.apply_top_p(torch.from_numpy(x[:1]), 0.3).numpy()[0]
    assert np.isfinite(t).tolist() == [False, True, False, True, False,
                                       False, False]


@pytest.mark.parametrize("top_k,top_p,temp", [
    (5, 0.0, 0.7), (0, 0.8, 0.7), (5, 0.8, 0.7), (50, 0.95, 1.0),
    (2, 0.5, 0.5), (300, 0.3, 0.7)])
def test_filtered_sample_equals_bark_tpu(top_k, top_p, temp):
    """Tokens equal to jax.random.categorical over the filtered logits,
    given its Gumbel noise; eos_p over the unfiltered logits/temp."""
    x = _rows(7 + top_k, n=24)
    for i, row in enumerate(x):
        key = jax.random.PRNGKey(100 + i)
        jt, je = jsamp.sample(key, jnp.asarray(row), temp, top_k, top_p)
        noise = torch.from_numpy(np.array(jax.random.gumbel(
            key, row.shape, jnp.float32)))
        tt, te = tsamp.sample(torch.from_numpy(row), temp, noise, top_k,
                              top_p)
        assert int(tt) == int(jt), i
        np.testing.assert_allclose(float(te), float(je), rtol=1e-6)
        _, plain_e = tsamp.sample(torch.from_numpy(row), temp, noise)
        assert float(te) == float(plain_e)


def test_filters_do_nothing_at_temp0():
    x = torch.from_numpy(_rows(3, n=8))
    for row in x:
        assert tsamp.sample(row, 0.0, None, 2, 0.1) == tsamp.sample(row, 0.0)


def test_batched_rows_sample_as_single_rows():
    """(B, V) logits and noise sample each row as a single (V,) call."""
    x = torch.from_numpy(_rows(11, n=6))
    noise = tsamp.gumbel(x.shape, torch.Generator().manual_seed(1), "cpu")
    toks, eos = tsamp.sample(x, 0.7, noise, 7, 0.9)
    for b in range(x.shape[0]):
        t, e = tsamp.sample(x[b], 0.7, noise[b], 7, 0.9)
        assert int(toks[b]) == int(t) and float(eos[b]) == float(e)


# ------------------------------------------------------------ requests


def port_request(path, text, seed, noise=None, **params):
    ctx = bark_tpu_torch.bark_load_model(path, tiny_params(**params),
                                         seed=0, device="cpu")
    ctx.noise_source = noise or replay_bark_tpu_noise(seed)
    assert ctx.generate_audio(text)
    return ctx, dict(semantic=ctx.semantic_tokens, coarse=ctx.coarse_tokens,
                     fine=ctx.fine_tokens, audio=ctx.generated_audio)


def assert_same(t, j):
    for stage in STAGES:
        assert t[stage].shape == j[stage].shape and t[stage].size > 0, stage
        np.testing.assert_array_equal(t[stage], j[stage], err_msg=stage)
    np.testing.assert_allclose(t["audio"], j["audio"], rtol=0,
                               atol=AUDIO_ATOL)


@pytest.fixture(scope="module", params=list(FILTERS))
def filtered(request):
    """bark_tpu's and the port's single request with one filter set, temp
    0.7."""
    kw = FILTERS[request.param]
    j = ref.request(TEXTS[0], SEED, **kw)
    tctx, t = port_request(ref.weights(), TEXTS[0], SEED, **kw)
    return kw, j, t, tctx


@pytest.mark.parametrize("stage", STAGES + ("audio",))
def test_filtered_request_equals_bark_tpu(filtered, stage):
    _, j, t, _ = filtered
    if stage == "audio":
        np.testing.assert_allclose(t["audio"], j["audio"], rtol=0,
                                   atol=AUDIO_ATOL)
    else:
        assert t[stage].size > 0
        np.testing.assert_array_equal(t[stage], j[stage])


def test_filtered_request_runs_single_steps(monkeypatch):
    """With a filter every semantic and coarse token is one call of the
    single step (K1's wrapper) at the JAX loop's slot: 257 + the count
    after the token, then ctx_len + j in the window; the unfiltered
    request calls it never (its chunks and windows are K3 and K4)."""
    path = ref.weights()
    slots = []
    real = tkdec.decode_step_fused
    monkeypatch.setattr(tkdec, "decode_step_fused", lambda *a, **k: (
        slots.append(a[5]), real(*a, **k))[1])
    _, t = port_request(path, TEXTS[0], SEED, **FILTERS["both"])
    n_sem = t["semantic"].size
    assert slots == ([257 + i for i in range(n_sem)]
                     + [257 + j for j in range(60)])
    slots.clear()
    port_request(path, TEXTS[0], SEED)
    assert slots == []


def test_filtered_request_at_temp0_equals_bark_tpu():
    """At temp 0 the filters do nothing: argmax tokens, as bark_tpu's."""
    kw = dict(temp=0.0, **FILTERS["both"])
    j = ref.request(TEXTS[1], SEED, **kw)
    _, t = port_request(ref.weights(), TEXTS[1], SEED, **kw)
    assert_same(t, j)


@pytest.mark.parametrize("name", list(FILTERS))
def test_filtered_batch_equals_bark_tpu(name):
    """Each lane of a filtered `generate_audio_batch` (K7's plain steps)
    equals bark_tpu's request for that prompt and noise."""
    kw = FILTERS[name]
    ctx = bark_tpu_torch.bark_load_model(ref.weights(), tiny_params(**kw),
                                         seed=0, device="cpu")
    ctx.lane_noise_source = lambda stage, lane, shape: \
        replay_bark_tpu_noise(SEED + lane)(stage, shape)
    lanes = ctx._generate_batch(TEXTS)
    for b, text in enumerate(TEXTS):
        assert_same(lanes[b], ref.request(text, SEED + b, **kw))


def test_filtered_batch_steps_every_lane_each_call(monkeypatch):
    """The filtered batch decodes all its lanes in one batched step (K7's
    wrapper) a token: the 12 semantic steps, then the coarse window's 60,
    each lane at its own slot."""
    path = ref.weights()
    slots = []
    real = tkbdec.decode_step_fused_batched
    monkeypatch.setattr(tkbdec, "decode_step_fused_batched",
                        lambda *a, **k: (slots.append(list(a[5])),
                                         real(*a, **k))[1])
    ctx = bark_tpu_torch.bark_load_model(
        path, tiny_params(**FILTERS["top_p"]), seed=3, device="cpu")
    outs = ctx._generate_batch(TEXTS)
    assert all(o["audio"].size for o in outs)
    assert slots[:12] == [[257 + i] * 3 for i in range(12)]
    assert slots[12:] == [[257 + j] * 3 for j in range(60)]


@pytest.mark.parametrize("name", list(FILTERS))
def test_filtered_packed_q8_0_equals_bark_tpu(name):
    """The q8_0 file packed (K5's plain steps) against bark_tpu's dense
    load of it: single request, then each lane of a batch (K5-batched's
    plain steps)."""
    path = ref.weights("q8_0")
    kw = FILTERS[name]
    j = ref.request(TEXTS[0], SEED, "q8_0", **kw)
    tctx, t = port_request(path, TEXTS[0], SEED, dequantize_on_load=False,
                           **kw)
    assert "wte_q" in tctx.semantic_params
    assert_same(t, j)
    ctx = bark_tpu_torch.bark_load_model(
        path, tiny_params(dequantize_on_load=False, **kw), seed=0,
        device="cpu")
    ctx.lane_noise_source = lambda stage, lane, shape: \
        replay_bark_tpu_noise(SEED + lane)(stage, shape)
    lanes = ctx._generate_batch(TEXTS[:2])
    for b, text in enumerate(TEXTS[:2]):
        assert_same(lanes[b], ref.request(text, SEED + b, "q8_0", **kw))


def test_filtered_semantic_stops_at_the_stop_token():
    """A forced stop token ends the filtered semantic loop at its step,
    single and per batch lane (the stopped lanes' later tokens
    discarded). A top_k as wide as the vocab keeps the stop token in
    reach but still runs the filtered loop. (Past the end of the cache the
    filtered slot clamps as bark_tpu's does: tests/test_torch_stepped.py
    runs 70 filtered steps after 257 rows of 320.)"""
    path = ref.weights()
    p = dict(semantic_vocab_size=10, top_k=16)

    def forced(stop_at):
        def noise(stage, shape):
            g = gumbel_from_key(stage, jax.random.PRNGKey(0), shape)
            if stage == "semantic" and stop_at is not None:
                g[stop_at] = -1e4
                g[stop_at, 10] = 1e4
            return g
        return noise

    ctx = bark_tpu_torch.bark_load_model(path, tiny_params(**p), seed=0,
                                         device="cpu")
    ctx.noise_source = forced(4)
    assert ctx.generate_audio(TEXTS[0])
    assert ctx.semantic_tokens.size == 4
    ctx.lane_noise_source = lambda stage, lane, shape: forced(
        [4, None, 7][lane])(stage, shape)
    lanes = ctx._generate_batch(TEXTS)
    assert [o["semantic"].size for o in lanes] == [4, 12, 7]
    np.testing.assert_array_equal(lanes[0]["semantic"], ctx.semantic_tokens)
