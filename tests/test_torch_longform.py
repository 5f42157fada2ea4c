"""Long-form generation in the port against bark_tpu's, f32 on the CPU, on
the tiny model: `generate_audio_long` and `generate_audio_stream_long` on
a text of three sentences (`text.longform.split_sentences`), each
sentence conditioned on the previous one's generation, with bark_tpu's
noise replayed across the sentences (`ReplayNoise` continues its key
chain from one sentence's request to the next):

- each sentence's semantic, coarse and fine tokens bit-equal to
  bark_tpu's, at temp 0.7 and 0, the first sentence with and without a
  voice, the streamed form over two coarse windows a sentence;
- the audio (and the streamed chunks, silences included) within
  AUDIO_ATOL of bark_tpu's; the statistics summed over the sentences
  equal to bark_tpu's;
- within the port: the streamed form's audio is its chunks joined, and
  each streamed sentence's coarse tokens are the plain form's.

bark_tpu's runs come from tests/torch_jax_reference.py."""

import numpy as np
import pytest

import bark_tpu_torch

import torch_jax_reference as ref
from test_torch_e2e import AUDIO_ATOL, one_torch_thread
from test_torch_streaming import ReplayNoise, make_voice
from tiny_model import tiny_params

STAGES = ("semantic", "coarse", "fine")
TEXT = "hello world the a. world hello? a the hello world."
SEED = 8

# name -> (streamed, params, voice for the first sentence)
CASES = {
    "long-temp0.7": (False, dict(), False),
    "long-temp0-voice": (False, dict(temp=0.0, fine_temp=0.0), True),
    "stream-temp0.7-voice": (True, dict(sliding_window_size=20), True),
    "stream-temp0": (True, dict(temp=0.0, fine_temp=0.0,
                                sliding_window_size=20), False),
}


def port_long(streamed: bool, voice=None, **params):
    """The port's long-form run: (context, each sentence's tokens, the
    chunks when `streamed`)."""
    ctx = bark_tpu_torch.bark_load_model(
        ref.weights(), tiny_params(**params), seed=SEED, device="cpu")
    ctx.noise_source = ReplayNoise(SEED)
    sentences = []

    def keep():
        sentences.append({k: getattr(ctx, f"{k}_tokens") for k in STAGES})

    if streamed:
        inner = ctx.generate_audio_stream

        def each(*a, **kw):
            yield from inner(*a, **kw)
            keep()

        ctx.generate_audio_stream = each
        return ctx, sentences, list(ctx.generate_audio_stream_long(
            TEXT, voice=voice))
    inner = ctx.generate_audio

    def each(*a, **kw):
        ok = inner(*a, **kw)
        keep()
        return ok

    ctx.generate_audio = each
    assert ctx.generate_audio_long(TEXT, voice=voice)
    return ctx, sentences, None


@pytest.fixture(scope="module", params=list(CASES))
def both(request):
    streamed, params, voiced = CASES[request.param]
    voice = make_voice() if voiced else None
    j = ref.long_form(TEXT, SEED, streamed=streamed, voice=voice, **params)
    return (request.param, j) + port_long(streamed, voice, **params)


@pytest.mark.parametrize("stage", STAGES)
def test_long_tokens_equal_bark_tpu_per_sentence(both, stage):
    _, j, _, sentences, _ = both
    assert len(sentences) == len(j["sentences"]) == 3
    for i, (t, js) in enumerate(zip(sentences, j["sentences"])):
        assert t[stage].size > 0
        np.testing.assert_array_equal(t[stage], js[stage],
                                      err_msg=f"sentence {i}")


def test_long_audio_matches_bark_tpu(both):
    name, j, ctx, _, chunks = both
    audio = ctx.get_audio_data()
    silence = int(0.25 * 24000)
    frames = ctx.stats.n_sample_coarse // 2
    assert audio.shape == j["audio"].shape == (frames * 320 + 2 * silence,)
    np.testing.assert_allclose(audio, j["audio"], rtol=0, atol=AUDIO_ATOL)
    if CASES[name][0]:
        assert len(chunks) == len(j["chunks"]) == 3 * 2 + 2
        for t, jc in zip(chunks, j["chunks"]):
            np.testing.assert_allclose(t, jc, rtol=0, atol=AUDIO_ATOL)
        np.testing.assert_array_equal(np.concatenate(chunks), audio)
        assert not chunks[2].any() and chunks[2].size == silence


def test_long_statistics_sum_over_sentences(both):
    _, j, ctx, sentences, _ = both
    s = ctx.stats
    for f in ("n_sample_semantic", "n_sample_coarse", "n_sample_fine"):
        assert getattr(s, f) == getattr(j["stats"], f) > 0, f
    assert s.n_sample_semantic == sum(x["semantic"].size for x in sentences)
    assert s.n_sample_fine == sum(x["fine"].size for x in sentences)
    assert s.t_eval_us >= s.t_semantic_us + s.t_coarse_us + s.t_fine_us > 0
    assert s.t_load_us > 0


def test_streamed_long_coarse_tokens_are_the_plain_forms():
    """Sentence by sentence, the streamed form's coarse tokens are those
    of `generate_audio_long` with the same noise (the stream's fine tokens
    differ once a sentence spans two windows)."""
    _, plain, _ = port_long(False, sliding_window_size=20)
    _, streamed, _ = port_long(True, sliding_window_size=20)
    for a, b in zip(plain, streamed):
        for stage in ("semantic", "coarse"):
            np.testing.assert_array_equal(a[stage], b[stage])


def test_long_of_no_sentence_fails():
    ctx = bark_tpu_torch.bark_load_model(ref.weights(), tiny_params(),
                                         seed=SEED, device="cpu")
    assert not ctx.generate_audio_long("   ")
    assert list(ctx.generate_audio_stream_long("")) == []
    assert ctx.get_audio_data().shape == (0,)
