"""Voice presets in the port against bark_tpu, f32 on the CPU: the EnCodec
encoder, presets from a generation and from audio, and requests that a
preset conditions, single (fused and stepped) and batched.

- The encoder (`models.encodec.encoder_forward`) on the tiny model's
  codec: its latent within ENCODER_ATOL of bark_tpu's (f32 convolutions
  and LSTM summed in another order; the latent's values reach ~4), and
  `encode_audio`'s codes equal; `voice.preset_from_audio` equal to
  bark_tpu's, with and without a semantic donor.
- Presets: saved by either package and loaded by the other, array for
  array; `preset_from_generation` of the same buffers equal.
- Requests with a voice (a saved generation; an audio-only preset, which
  conditions only the fine stage; a long preset that every history cap
  trims): `generate_audio` fused and stepped, at temp 0.7 with bark_tpu's
  noise replayed and at temp 0, and with top-k/top-p; each lane of
  `generate_audio_batch(voices=...)` against bark_tpu's request for its
  prompt, voice and noise. Semantic, coarse and fine tokens equal, audio
  within AUDIO_ATOL.

bark_tpu's runs come from tests/torch_jax_reference.py (one context, its
programs shared with the other modules that use it)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu
import bark_tpu_torch
from bark_tpu.io import ggml as jggml
from bark_tpu.models import encodec as jenc
from bark_tpu.pipeline import voice as jvoice
from bark_tpu_torch.io import ggml as tggml
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.models import encodec as tenc
from bark_tpu_torch.pipeline import voice as tvoice

import torch_jax_reference as ref
from test_torch_e2e import AUDIO_ATOL, one_torch_thread, replay_bark_tpu_noise
from tiny_model import tiny_params

ENCODER_ATOL = 1e-4
STAGES = ("semantic", "coarse", "fine")
TEXTS = ["hello world", "the a hello", "world world the"]
SEED = 4


@pytest.fixture(scope="module")
def codecs():
    """The tiny model's codec as each package loads it (with encoder)."""
    model = tggml.read_model_file(ref.weights())
    jmodel = jggml.read_model_file(ref.weights())
    return (jenc.params_from_section(jmodel.codec),
            tloader.codec_params_from_section(model.codec, "cpu"))


def _audio(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 24000
    return (0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.randn(n)).astype(
        np.float32)


# 24 frames and 13 samples: the last frame is padded (ceil)
N_AUDIO = 320 * 24 + 13


@pytest.fixture(scope="module")
def encoded(codecs, monkeypatch_module):
    """bark_tpu's encoder on one waveform: (audio, latent, {n_q: codes}).
    Its encoder runs jitted here (eagerly it compiles its LSTM's scan at
    every call), also inside `voice.preset_from_audio`."""
    import jax

    jp, _ = codecs
    monkeypatch_module.setattr(jenc, "encode_audio", jax.jit(
        jenc.encode_audio, static_argnums=2))
    audio = _audio(N_AUDIO)
    latent = jax.jit(jenc.encoder_forward)(jp, jnp.asarray(audio))
    codes = {n_q: np.array(jenc.rvq_encode(jp["quantizer"], latent, n_q))
             for n_q in (2, 8)}
    return audio, np.array(latent), codes


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_encoder_latent_equals_bark_tpus(codecs, encoded):
    audio, j, _ = encoded
    t = tenc.encoder_forward(codecs[1], torch.from_numpy(audio)).numpy()
    assert t.shape == j.shape == (25, 16)
    np.testing.assert_allclose(t, j, rtol=0, atol=ENCODER_ATOL)


@pytest.mark.parametrize("n_q", [2, 8])
def test_encode_audio_codes_equal(codecs, encoded, n_q):
    audio, _, codes = encoded
    t = tenc.encode_audio(codecs[1], torch.from_numpy(audio), n_q).numpy()
    assert t.dtype == np.int32 and t.shape == (25, n_q)
    np.testing.assert_array_equal(t, codes[n_q])


def test_codec_params_hold_the_encoder(codecs):
    """The loader's encoder tree has bark_tpu's keys and shapes, and the
    numpy init draws bark_tpu's `init_params_host` arrays with it."""
    jp, tp = codecs
    jl = jax_leaves(jp["encoder"])
    tl = jax_leaves(tp["encoder"])
    assert [a.shape for a in tl] == [a.shape for a in jl]
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    from bark_tpu_torch.models.config import CodecConfig
    cfg = CodecConfig(hidden_dim=16, n_filters=2, n_bins=8, n_q_total=8)
    port = tloader.codec_init_params_numpy(cfg, 5, 0.1, with_encoder=True)
    jax_tree = jenc.init_params_host(
        jenc.CodecConfig(hidden_dim=16, n_filters=2, n_bins=8, n_q_total=8),
        5, scale=0.1, with_encoder=True)
    for a, b in zip(jax_leaves(port), jax_leaves(jax_tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="no encoder"):
        tenc.encode_audio({"quantizer": tp["quantizer"]},
                          torch.zeros(320), 2)


def jax_leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("donor", [False, True], ids=["no_donor", "donor"])
def test_preset_from_audio_equals_bark_tpus(codecs, encoded, donor):
    jp, tp = codecs
    p = tiny_params()
    audio = encoded[0]
    d = (tvoice.VoicePreset(semantic=np.arange(20, dtype=np.int32) % 16,
                            coarse=np.zeros((2, 1), np.int32),
                            fine=np.zeros((8, 1), np.int32))
         if donor else None)
    j = jvoice.preset_from_audio(jp, audio, p, d)
    t = tvoice.preset_from_audio(tp, audio, p, d)
    for name in ("semantic", "coarse", "fine"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.fine.shape == (8, 25)


# ------------------------------------------------------------- presets


@pytest.fixture(scope="module")
def generation():
    """A finished port generation (its token buffers)."""
    ctx = bark_tpu_torch.bark_load_model(ref.weights(), tiny_params(),
                                         seed=11, device="cpu")
    assert ctx.generate_audio("the a hello world")
    return ctx


def test_preset_from_generation_equals_bark_tpus(generation):
    g, p = generation, tiny_params()
    j = jvoice.preset_from_generation(g.semantic_tokens, g.coarse_tokens,
                                      g.fine_tokens, p)
    t = tvoice.preset_from_generation(g.semantic_tokens, g.coarse_tokens,
                                      g.fine_tokens, p)
    for name in ("semantic", "coarse", "fine"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        assert getattr(t, name).dtype == np.int32


def test_saved_voice_loads_in_both_packages(generation, tmp_path):
    """`bark_save_voice` writes suno's .npz; bark_tpu's loader and the
    port's read the same arrays, and a preset bark_tpu saves loads in the
    port."""
    path = str(tmp_path / "v.npz")
    bark_tpu_torch.bark_save_voice(generation, path)
    t = bark_tpu_torch.load_voice_preset(path)
    j = bark_tpu.load_voice_preset(path)
    np.testing.assert_array_equal(t.semantic, generation.semantic_tokens)
    np.testing.assert_array_equal(t.fine, generation.fine_tokens.T)
    back = str(tmp_path / "back.npz")
    bark_tpu.save_voice_preset(back, j)
    again = bark_tpu_torch.load_voice_preset(back)
    for name in ("semantic", "coarse", "fine"):
        np.testing.assert_array_equal(getattr(again, name), getattr(t, name))
    bark_tpu_torch.save_voice_preset(str(tmp_path / "c.npz"), again)
    assert isinstance(again, bark_tpu_torch.VoicePreset)
    assert os.path.getsize(str(tmp_path / "c.npz")) > 0


def test_save_voice_without_generation_raises():
    ctx = bark_tpu_torch.bark_load_model(ref.weights(), tiny_params(),
                                         device="cpu")
    with pytest.raises(ValueError, match="no finished generation"):
        ctx.save_voice("never.npz")


def _long_preset():
    """Longer than every cap: 300 semantic tokens (the prompt keeps 256,
    the coarse stage 18), 700 coarse frames, 600 fine frames (512 kept)."""
    rng = np.random.RandomState(9)
    return tvoice.VoicePreset(
        semantic=rng.randint(0, 16, 300).astype(np.int32),
        coarse=rng.randint(0, 8, (2, 700)).astype(np.int32),
        fine=rng.randint(0, 8, (8, 600)).astype(np.int32))


@pytest.fixture(scope="module")
def voices(generation, codecs, tmp_path_factory):
    """name -> a voice= value: a saved generation (.npz path), a preset
    from audio alone, and the long preset."""
    path = str(tmp_path_factory.mktemp("voice") / "g.npz")
    generation.save_voice(path)
    audio = tvoice.preset_from_audio(codecs[1], _audio(N_AUDIO, 5),
                                     tiny_params())
    return {"generation": path, "audio": audio, "long": _long_preset()}


def port_request(text, seed, voice, **kw):
    ctx = bark_tpu_torch.bark_load_model(ref.weights(), tiny_params(**kw),
                                         seed=0, device="cpu")
    ctx.noise_source = replay_bark_tpu_noise(seed)
    assert bark_tpu_torch.bark_generate_audio(ctx, text, voice=voice)
    return dict(semantic=ctx.semantic_tokens, coarse=ctx.coarse_tokens,
                fine=ctx.fine_tokens, audio=ctx.generated_audio,
                prompt=ctx.tokens)


def assert_same(t, j):
    for stage in STAGES:
        assert t[stage].shape == j[stage].shape and t[stage].size > 0, stage
        np.testing.assert_array_equal(t[stage], j[stage], err_msg=stage)
    np.testing.assert_allclose(t["audio"], j["audio"], rtol=0,
                               atol=AUDIO_ATOL)


@pytest.fixture(scope="module", params=["generation", "audio", "long"])
def voiced(request, voices):
    v = voices[request.param]
    return (ref.request(TEXTS[0], SEED, voice=v),
            port_request(TEXTS[0], SEED, v), request.param)


@pytest.mark.parametrize("stage", STAGES + ("audio",))
def test_voice_request_equals_bark_tpu(voiced, stage):
    j, t, _ = voiced
    if stage == "audio":
        np.testing.assert_allclose(t["audio"], j["audio"], rtol=0,
                                   atol=AUDIO_ATOL)
    else:
        assert t[stage].size > 0
        np.testing.assert_array_equal(t[stage], j[stage])


@pytest.fixture(scope="module")
def unvoiced():
    return port_request(TEXTS[0], SEED, None)


def test_voice_changes_the_request(voiced, voices, unvoiced):
    """The voice conditions the stages: its last <= 256 semantic tokens
    fill the prompt's history slots, and the coarse and fine tokens differ
    from the same request's without it (the audio-only preset has no
    semantic history, so no coarse history either: only its fine tokens
    must differ)."""
    _, t, name = voiced
    stages = ("fine",) if name == "audio" else ("coarse", "fine")
    for stage in stages:
        assert not np.array_equal(t[stage], unvoiced[stage]), stage
    v = voices[name]
    if isinstance(v, str):
        v = tvoice.load_voice_preset(v)
    hist = v.semantic[-256:]
    np.testing.assert_array_equal(t["prompt"][256:256 + hist.size], hist)
    assert (t["prompt"][256 + hist.size:512] == 16).all()


@pytest.mark.parametrize("name,kw", [
    ("long", dict(detailed_stats=True)),
    ("generation", dict(temp=0.0, top_k=5, top_p=0.8)),
    ("long", dict(top_k=5, top_p=0.8))], ids=["stepped", "temp0", "filters"])
def test_voice_variants_equal_bark_tpu(voices, name, kw):
    """The stepped path with a voice, temp 0, and the filters (the long
    preset, which every history cap trims, where the noise reaches the
    windows; a saved generation at temp 0)."""
    v = voices[name]
    assert_same(port_request(TEXTS[1], SEED, v, **kw),
                ref.request(TEXTS[1], SEED, voice=v, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(top_p=0.7)],
                         ids=["fused", "filters"])
def test_batch_voices_equal_bark_tpu(voices, kw):
    """`generate_audio_batch(voices=...)`: each lane conditioned by its
    own voice (or none), against bark_tpu's request for its prompt, voice
    and noise."""
    vs = [voices["generation"], None, voices["long"]]
    ctx = bark_tpu_torch.bark_load_model(ref.weights(), tiny_params(**kw),
                                         seed=0, device="cpu")
    ctx.lane_noise_source = lambda stage, lane, shape: \
        replay_bark_tpu_noise(SEED + lane)(stage, shape)
    lanes = ctx._generate_batch(TEXTS, voices=vs)
    for b, (text, v) in enumerate(zip(TEXTS, vs)):
        assert_same(lanes[b], ref.request(text, SEED + b, voice=v, **kw))


def test_batch_voices_packed_lanes_equal_single_requests(voices):
    """On the q8_0 file loaded packed (K5-batched's plain steps), each
    voiced lane equals a single packed request with its noise."""
    path = ref.weights("q8_0")
    vs = [voices["long"], voices["audio"]]
    p = tiny_params(dequantize_on_load=False)
    ctx = bark_tpu_torch.bark_load_model(path, p, seed=0, device="cpu")
    ctx.lane_noise_source = lambda stage, lane, shape: \
        replay_bark_tpu_noise(SEED + lane)(stage, shape)
    lanes = ctx._generate_batch(TEXTS[:2], voices=vs)
    for b, v in enumerate(vs):
        single = bark_tpu_torch.bark_load_model(path, p, seed=0,
                                                device="cpu")
        single.noise_source = replay_bark_tpu_noise(SEED + b)
        assert single.generate_audio(TEXTS[b], voice=v)
        for stage in STAGES:
            np.testing.assert_array_equal(
                lanes[b][stage], getattr(single, stage + "_tokens"))


def test_voices_are_validated(voices):
    ctx = bark_tpu_torch.bark_load_model(ref.weights(), tiny_params(),
                                         device="cpu")
    with pytest.raises(ValueError, match="one per prompt"):
        ctx.generate_audio_batch(TEXTS, voices=[None])
    bad = tvoice.VoicePreset(semantic=np.array([99], np.int32),
                             coarse=np.zeros((2, 1), np.int32),
                             fine=np.zeros((8, 1), np.int32))
    with pytest.raises(ValueError, match="semantic_prompt values"):
        ctx.generate_audio(TEXTS[0], voice=bad)
    with pytest.raises(ValueError, match="semantic_prompt values"):
        ctx.generate_audio_batch(TEXTS[:1], voices=[bad])
