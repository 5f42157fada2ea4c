"""bark_tpu_torch.ops.sampling, fed the noise bark_tpu draws from its keys,
against bark_tpu.ops.sampling: tokens equal to jax.random.categorical, the
temp-0 argmax and its /0.7 EOS mass, the per-row fine sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.ops import sampling as jsamp
from bark_tpu_torch.ops import sampling as tsamp

from test_torch_e2e import one_torch_thread  # autouse


@pytest.mark.parametrize("temp", [0.7, 0.5, 1.0])
def test_sample_matches_categorical(temp):
    rng = np.random.RandomState(0)
    for i in range(40):
        logits = (rng.randn(257) * 3).astype(np.float32)
        key = jax.random.PRNGKey(i)
        jt, je = jsamp.sample(key, jnp.asarray(logits), temp)
        noise = np.array(jax.random.gumbel(key, (257,), jnp.float32))
        tt, te = tsamp.sample(torch.from_numpy(logits), temp,
                              torch.from_numpy(noise))
        assert int(tt) == int(jt)
        np.testing.assert_allclose(float(te), float(je), rtol=1e-6)


def test_sample_temp0_argmax_and_eos():
    rng = np.random.RandomState(1)
    for _ in range(20):
        logits = (rng.randn(100) * 2).astype(np.float32)
        jt, je = jsamp.sample(jax.random.PRNGKey(0), jnp.asarray(logits), 0.0)
        tt, te = tsamp.sample(torch.from_numpy(logits), 0.0)
        assert int(tt) == int(jt)
        np.testing.assert_allclose(float(te), float(je), rtol=1e-6)


def test_ties_go_to_the_lowest_index():
    logits = torch.tensor([0.0, 2.0, 1.0, 2.0, 2.0])
    assert int(tsamp.sample(logits, 0.0)[0]) == 1
    assert int(tsamp.sample(logits, 0.5, torch.zeros(5))[0]) == 1
    assert int(jnp.argmax(jnp.asarray(logits.numpy()))) == 1


def test_sample_rows_matches():
    rng = np.random.RandomState(2)
    logits = (rng.randn(64, 8) * 2).astype(np.float32)
    key = jax.random.PRNGKey(3)
    for temp in (0.5, 0.0):
        j = np.asarray(jsamp.sample_rows(key, jnp.asarray(logits), temp))
        noise = torch.from_numpy(
            np.array(jax.random.gumbel(key, (64, 8), jnp.float32)))
        t = tsamp.sample_rows(torch.from_numpy(logits), temp, noise)
        np.testing.assert_array_equal(t.numpy(), j)


def test_gumbel_noise_statistics():
    """The port's own noise is standard Gumbel (mean = Euler's gamma,
    variance pi^2/6), finite, drawn reproducibly from the generator (up to
    the last ulp: PyTorch's CPU log takes a vector or a scalar path per
    element depending on how threads split the tensor)."""
    g = tsamp.gumbel((200_000,), torch.Generator().manual_seed(0), "cpu")
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03
    again = tsamp.gumbel((200_000,), torch.Generator().manual_seed(0), "cpu")
    torch.testing.assert_close(g, again, rtol=1e-6, atol=0)


def test_filters_not_ported_raise():
    """The filters are ported now: what raised before samples as bark_tpu
    does (tests/test_torch_filters.py holds them on many more rows)."""
    rng = np.random.RandomState(4)
    logits = (rng.randn(4) * 2).astype(np.float32)
    key = jax.random.PRNGKey(9)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (4,),
                                                        jnp.float32)))
    for kw in (dict(top_k=2), dict(top_p=0.9)):
        jt, je = jsamp.sample(key, jnp.asarray(logits), 0.7, **kw)
        tt, te = tsamp.sample(torch.from_numpy(logits), 0.7, noise, **kw)
        assert int(tt) == int(jt)
        np.testing.assert_allclose(float(te), float(je), rtol=1e-6)
