"""`BarkContext.generate_audio_stream`, the port's streaming path, against
bark_tpu's, f32 on the CPU (the kernels K2 and K4 run their plain
versions), on the tiny model:

- semantic, coarse and fine tokens bit-equal to bark_tpu's stream with
  its noise replayed (`ReplayNoise`: its key chain, three keys a request,
  the fine key split once a window), at temp 0 and 0.7, with and without
  a voice whose fine history moves each window's fine block off row 0,
  over two coarse windows (sliding_window_size 20) and over one, dense
  and on the q8_0 file loaded packed;
- the chunks: as many as bark_tpu's, of the same lengths, within
  AUDIO_ATOL of its chunks; final (their concatenation is the port's own
  decode of its final fine tokens, and `get_audio_data()`); statistics
  and progress callbacks equal to bark_tpu's;
- within the port: the stream's coarse tokens are `generate_audio`'s, and
  a one-window stream is `generate_audio` itself; a packed context makes
  one dense copy of the coarse and of the fine stage per stream call; a
  request with no semantic token yields nothing.

bark_tpu's runs come from tests/torch_jax_reference.py."""

import jax
import numpy as np
import pytest
import torch

import bark_tpu_torch
from bark_tpu_torch.io import loader
from bark_tpu_torch.pipeline import voice as tvoice

import torch_jax_reference as ref
from test_torch_e2e import AUDIO_ATOL, gumbel_from_key, one_torch_thread
from tiny_model import tiny_params

STAGES = ("semantic", "coarse", "fine")
TEXT = "hello world the a"
SEED = 3


class ReplayNoise:
    """A `noise_source` for the port that replays bark_tpu's draws for a
    context seeded with `seed`, across requests: each request's semantic
    draw takes the next three keys of bark_tpu's chain (semantic, coarse,
    fine: `BarkContext._next_key`), and each fine draw continues the fine
    key's chain (one split a block), so a stream's per-window blocks and
    a long-form text's sentences line up with bark_tpu's."""

    def __init__(self, seed: int):
        self.key, self.keys = jax.random.PRNGKey(seed), {}

    def __call__(self, stage, shape):
        if stage == "semantic":
            for s in STAGES:
                self.key, self.keys[s] = jax.random.split(self.key)
        noise = gumbel_from_key(stage, self.keys[stage], shape)
        if stage == "fine":
            for _ in range(shape[0]):
                self.keys[stage], _ = jax.random.split(self.keys[stage])
        return noise


def make_voice(n_sem=40, n_frames=60, seed=7) -> tvoice.VoicePreset:
    """A preset whose 60-frame fine history, with the 10-frame windows of
    sliding_window_size 20, fills the tiny model's 64-row fine block."""
    rng = np.random.default_rng(seed)
    p = tiny_params()
    return tvoice.VoicePreset(
        semantic=rng.integers(0, p.semantic_vocab_size, n_sem).astype(
            np.int32),
        coarse=rng.integers(0, p.codebook_size,
                            (p.n_coarse_codebooks, n_frames)).astype(np.int32),
        fine=rng.integers(0, p.codebook_size,
                          (p.n_fine_codebooks, n_frames)).astype(np.int32))


# name -> (params, voice, weights kind)
CASES = {
    "temp0": (dict(temp=0.0, fine_temp=0.0, sliding_window_size=20), False,
              "f32"),
    "temp0.7": (dict(sliding_window_size=20), False, "f32"),
    "temp0.7-voice": (dict(sliding_window_size=20), True, "f32"),
    "temp0-voice": (dict(temp=0.0, fine_temp=0.0, sliding_window_size=20),
                    True, "f32"),
    "one-window": (dict(), False, "f32"),
    "q8_0-packed": (dict(sliding_window_size=20), False, "q8_0"),
}


def port_context(kind: str, **params):
    p = tiny_params(dequantize_on_load=kind == "f32", **params)
    return bark_tpu_torch.bark_load_model(ref.weights(kind), p, seed=SEED,
                                          device="cpu")


def port_stream(ctx, voice=None, text=TEXT):
    """(chunks, progress callbacks) of the port's stream on `ctx`."""
    calls = []
    ctx.params.progress_callback = (
        lambda c, step, pc, ud: calls.append((int(step), pc)))
    try:
        return list(ctx.generate_audio_stream(text, voice=voice)), calls
    finally:
        ctx.params.progress_callback = None


@pytest.fixture(scope="module", params=list(CASES))
def both(request):
    """(the case's name, bark_tpu's stream result, the port's context
    after its stream, the port's chunks, its progress calls)."""
    params, voiced, kind = CASES[request.param]
    voice = make_voice() if voiced else None
    j = ref.stream(TEXT, SEED, kind, voice=voice, **params)
    ctx = port_context(kind, **params)
    if kind != "f32":
        assert "wte_q" in ctx.coarse_params and "wte_q" in ctx.fine_params
    ctx.noise_source = ReplayNoise(SEED)
    chunks, calls = port_stream(ctx, voice)
    return request.param, j, ctx, chunks, calls


@pytest.mark.parametrize("stage", STAGES)
def test_stream_tokens_equal_bark_tpu(both, stage):
    _, j, ctx, _, _ = both
    t = getattr(ctx, f"{stage}_tokens")
    assert t.size > 0 and t.shape == j[stage].shape
    np.testing.assert_array_equal(t, j[stage])


def test_stream_chunks_match_bark_tpu(both):
    name, j, _, chunks, _ = both
    want = 1 if name == "one-window" else 2
    assert len(chunks) == len(j["chunks"]) == want
    for t, jc in zip(chunks, j["chunks"]):
        assert t.dtype == np.float32 and t.shape == jc.shape
        np.testing.assert_allclose(t, jc, rtol=0, atol=AUDIO_ATOL)


def test_stream_chunks_are_final(both):
    """The chunks are the samples of one decode of the final fine tokens,
    and `get_audio_data()` is their concatenation."""
    _, _, ctx, chunks, _ = both
    joined = np.concatenate(chunks)
    np.testing.assert_array_equal(ctx.get_audio_data(), joined)
    n = ctx.fine_tokens.shape[0]
    whole = ctx._decode_codec(torch.from_numpy(ctx.fine_tokens), n).numpy()
    assert whole.shape == joined.shape == (n * 320,)
    np.testing.assert_allclose(joined, whole, rtol=0, atol=1e-6)


def test_stream_statistics_and_progress_match_bark_tpu(both):
    _, j, ctx, _, calls = both
    for f in ("n_sample_semantic", "n_sample_coarse", "n_sample_fine"):
        assert getattr(ctx.stats, f) == getattr(j["stats"], f) > 0, f
    s = ctx.stats
    assert s.t_eval_us >= s.t_semantic_us + s.t_coarse_us + s.t_fine_us > 0
    assert calls == j["calls"] and {st for st, _ in calls} == {0, 1, 2}


def test_stream_coarse_tokens_are_generate_audios(both):
    """The stream's coarse tokens are the fused path's, for any number of
    windows; its fine tokens too when the utterance is one window."""
    name, _, ctx, _, _ = both
    params, voiced, kind = CASES[name]
    fused = port_context(kind, **params)
    fused.noise_source = ReplayNoise(SEED)
    assert fused.generate_audio(TEXT, voice=make_voice() if voiced
                                else None)
    np.testing.assert_array_equal(ctx.coarse_tokens, fused.coarse_tokens)
    np.testing.assert_array_equal(ctx.semantic_tokens,
                                  fused.semantic_tokens)
    if name == "one-window":
        np.testing.assert_array_equal(ctx.fine_tokens, fused.fine_tokens)
        np.testing.assert_array_equal(ctx.get_audio_data(),
                                      fused.get_audio_data())


def test_stream_densifies_once_per_call(monkeypatch):
    """A packed context makes one dense copy of the coarse stage and one
    of the fine stage per stream, however many windows it streams."""
    ctx = port_context("q8_0", **CASES["q8_0-packed"][0])
    real, seen = loader.densify, []

    def densify(cfg, params):
        seen.append(cfg)
        return real(cfg, params)

    monkeypatch.setattr(loader, "densify", densify)
    chunks, _ = port_stream(ctx)
    assert len(chunks) == 2
    for stage in STAGES:  # the semantic stage's prefills read one too
        cfg = getattr(ctx, f"{stage}_cfg")
        assert sum(c is cfg for c in seen) == 1, stage
    assert len(seen) == 3


def test_stream_without_semantic_tokens_yields_nothing():
    """A request whose semantic stage stops at step 0 (the stop token 10
    forced first) yields no chunk and leaves empty audio, as bark_tpu's
    stream does."""
    ctx = port_context("f32", semantic_vocab_size=10)

    def forced(stage, shape):
        noise = torch.zeros(shape)
        noise[0, 10] = 1e4
        return noise

    ctx.noise_source = forced
    chunks, calls = port_stream(ctx)
    assert chunks == [] and ctx.get_audio_data().shape == (0,)
    assert ctx.semantic_tokens.size == 0 and calls == [(0, 0), (0, 100)]
