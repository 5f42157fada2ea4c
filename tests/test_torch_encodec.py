"""bark_tpu_torch.models.encodec (the codec decode path, plain PyTorch)
against bark_tpu.models.encodec at the tiny codec of tests/tiny_model.py,
f32 on the CPU, atol 1e-5 (another summation order in the convolutions
and the LSTM)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.models import encodec as jenc
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.models import encodec as tenc

from test_torch_e2e import one_torch_thread  # autouse
from tiny_model import build_tiny_model

ATOL = 1e-5


@pytest.fixture(scope="module")
def codec():
    sec = build_tiny_model().codec
    return (jenc.params_from_section(sec),
            tloader.codec_params_from_section(sec, "cpu"))


def _x(T, C, seed=0):
    return (np.random.RandomState(seed).randn(T, C) * 0.5).astype(np.float32)


@pytest.mark.parametrize("T,k,stride,dil", [(20, 7, 1, 1), (3, 7, 1, 1),
                                            (17, 4, 2, 1), (12, 3, 1, 3)])
def test_causal_conv1d_matches(T, k, stride, dil):
    x = _x(T, 5)
    w = (np.random.RandomState(1).randn(6, 5, k) * 0.3).astype(np.float32)
    b = np.linspace(-1, 1, 6).astype(np.float32)
    j = jenc.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           stride, dil)
    t = tenc.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), stride, dil)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("stride", [2, 5, 8])
def test_conv_transpose_matches(stride):
    x = _x(9, 4)
    w = (np.random.RandomState(2).randn(4, 3, 2 * stride) * 0.3).astype(
        np.float32)
    b = np.array([0.1, -0.2, 0.3], np.float32)
    j = jenc.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), stride)
    t = tenc.causal_conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), stride)
    assert tuple(t.shape) == (9 * stride, 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


def test_lstm_stack_matches(codec):
    jp, tp = codec
    x = _x(30, 32, seed=3)
    j = jenc.lstm_stack(jnp.asarray(x), jp["decoder"]["lstm"])
    t = tenc.lstm_stack(torch.from_numpy(x), tp["decoder"]["lstm"])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("T", [1, 5, 18, 40])
def test_decode_codes_matches(codec, T):
    jp, tp = codec
    codes = np.random.RandomState(T).randint(0, 8, size=(T, 8)).astype(
        np.int32)
    j = np.asarray(jenc.decode_codes(jp, jnp.asarray(codes)))
    t = tenc.decode_codes(tp, torch.from_numpy(codes)).numpy()
    assert t.shape == (T * 320,)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


def test_pad_rows_decode_to_a_zero_latent_and_stay_causal(codec):
    """Rows holding the pad id n_bins (the fine buffer past the last frame)
    select a zero codebook row instead of indexing out of range, and the
    causal decoder keeps them out of the earlier samples."""
    jp, tp = codec
    codes = np.random.RandomState(7).randint(0, 8, size=(20, 8)).astype(
        np.int32)
    padded = np.concatenate([codes, np.full((12, 8), 8, np.int32)])
    latent = tenc.rvq_decode(tp["quantizer"], torch.from_numpy(padded))
    assert not latent[20:].any()
    t = tenc.decode_codes(tp, torch.from_numpy(padded)).numpy()
    j = np.asarray(jenc.decode_codes(jp, jnp.asarray(codes)))
    np.testing.assert_allclose(t[: 20 * 320], j, rtol=0, atol=ATOL)
