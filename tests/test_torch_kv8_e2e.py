"""The int8 KV cache (`kv_cache_dtype="int8"`) end to end on the CPU,
through the public API, against bark_tpu with the same setting on one
tiny ggml_weights.bin, f32, the port fed bark_tpu's Gumbel noise:

- `bark_generate_audio` at temp 0 and 0.7: tokens equal in all three
  stages, audio within the dense e2e tolerance (1e-4);
- `generate_audio_batch` of 2 prompts at temp 0.7: audio within 1e-4 and
  the same sample counts;
- a q8_0 file loaded packed (`dequantize_on_load=False`; bark_tpu loads it
  dequantized), as tests/test_torch_quant_e2e.py compares q8_0: tokens
  equal, audio within 1e-4;
- the same file packed on the batched path (bark_tpu loads it packed
  too), 2 prompts at temp 0.7: each lane's tokens equal in all three
  stages, audio within 1e-4.
"""

import numpy as np
import pytest

import bark_tpu
import bark_tpu_torch
from bark_tpu.io import ggml

from test_torch_batched_e2e import replay_bark_tpu_lane_noise
from test_torch_e2e import (AUDIO_ATOL, TEXT, one_torch_thread,
                            replay_bark_tpu_noise)
from test_torch_quant_batched_e2e import bark_tpu_batch_lanes
from tiny_model import build_tiny_model, tiny_params

STAGES = ("semantic_tokens", "coarse_tokens", "fine_tokens")
PROMPTS = ["hello world", "the a hello"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "ggml_weights.bin")
    ggml.write_model_file(path, build_tiny_model())
    return path


def _kv8(**kw):
    return tiny_params(kv_cache_dtype="int8", **kw)


@pytest.fixture(scope="module", params=[0.0, 0.7], ids=["temp0", "temp0.7"])
def both(request, weights):
    temp = request.param
    p = _kv8(temp=temp, fine_temp=0.5 if temp else 0.0)
    jctx = bark_tpu.bark_load_model(weights, p, seed=0)
    assert bark_tpu.bark_generate_audio(jctx, TEXT)
    tctx = bark_tpu_torch.bark_load_model(weights, p, seed=0, device="cpu")
    tctx.noise_source = replay_bark_tpu_noise(0)
    assert bark_tpu_torch.bark_generate_audio(tctx, TEXT)
    return jctx, tctx


@pytest.mark.parametrize("stage", STAGES)
def test_kv8_tokens_equal(both, stage):
    jctx, tctx = both
    j, t = getattr(jctx, stage), getattr(tctx, stage)
    assert j.shape == t.shape and j.size > 0
    np.testing.assert_array_equal(t, j)


def test_kv8_audio_matches(both):
    jctx, tctx = both
    t = bark_tpu_torch.bark_get_audio_data(tctx)
    assert t.shape == (tctx.fine_tokens.shape[0] * 320,)
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, bark_tpu.bark_get_audio_data(jctx), rtol=0,
                               atol=AUDIO_ATOL)


def test_kv8_batch_matches_bark_tpu(weights):
    p = _kv8(temp=0.7, fine_temp=0.5)
    jout = bark_tpu.bark_load_model(weights, p, seed=5).generate_audio_batch(
        PROMPTS)
    tctx = bark_tpu_torch.bark_load_model(weights, p, seed=5, device="cpu")
    tctx.lane_noise_source = replay_bark_tpu_lane_noise(5, len(PROMPTS))
    tout = tctx.generate_audio_batch(PROMPTS)
    assert len(tout) == len(PROMPTS)
    for j, t in zip(jout, tout):
        assert t.shape == j.shape and t.size > 0 and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=AUDIO_ATOL)


@pytest.fixture(scope="module")
def q8_path(weights, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kv8q") / "q8.bin")
    assert bark_tpu_torch.bark_model_quantize(weights, path,
                                              ggml.GGMLFType.MOSTLY_Q8_0)
    return path


def test_kv8_q8_0_packed_matches_bark_tpu(q8_path):
    jctx = bark_tpu.bark_load_model(q8_path, _kv8(temp=0.7, fine_temp=0.5),
                                    seed=0)
    assert bark_tpu.bark_generate_audio(jctx, TEXT)
    tctx = bark_tpu_torch.bark_load_model(
        q8_path, _kv8(temp=0.7, fine_temp=0.5, dequantize_on_load=False),
        seed=0, device="cpu")
    assert "wte_q" in tctx.semantic_params and tctx.kv_quant
    tctx.noise_source = replay_bark_tpu_noise(0)
    assert bark_tpu_torch.bark_generate_audio(tctx, TEXT)
    for stage in STAGES:
        np.testing.assert_array_equal(getattr(tctx, stage),
                                      getattr(jctx, stage), err_msg=stage)
    np.testing.assert_allclose(bark_tpu_torch.bark_get_audio_data(tctx),
                               bark_tpu.bark_get_audio_data(jctx), rtol=0,
                               atol=AUDIO_ATOL)


def test_kv8_packed_batch_is_not_ported(q8_path):
    """Once the refusal of a packed batch, now its parity with bark_tpu:
    packed stages and the int8 cache on the batched path."""
    p = _kv8(temp=0.7, fine_temp=0.5, dequantize_on_load=False)
    jaudio, jlanes = bark_tpu_batch_lanes(
        bark_tpu.bark_load_model(q8_path, p, seed=5), PROMPTS)
    tctx = bark_tpu_torch.bark_load_model(q8_path, p, seed=5, device="cpu")
    assert "wte_q" in tctx.coarse_params and tctx.kv_quant
    tctx.lane_noise_source = replay_bark_tpu_lane_noise(5, len(PROMPTS))
    tlanes = tctx._generate_batch(PROMPTS)
    for b, (t, j) in enumerate(zip(tlanes, jlanes)):
        for key in ("semantic", "coarse", "fine"):
            assert t[key].size > 0
            np.testing.assert_array_equal(t[key], j[key],
                                          err_msg=f"lane {b} {key}")
    for j, t in zip(jaudio, tlanes):
        assert t["audio"].shape == j.shape and np.isfinite(t["audio"]).all()
        np.testing.assert_allclose(t["audio"], j, rtol=0, atol=AUDIO_ATOL)


def test_unknown_kv_cache_dtype_fails_fast(weights):
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        bark_tpu_torch.bark_load_model(
            weights, tiny_params(kv_cache_dtype="int4"), device="cpu")
