"""The port end to end against bark_tpu on one tiny ggml_weights.bin, both
through the public API (bark_load_model -> bark_generate_audio ->
bark_get_audio_data), seed 0, f32 on the CPU.

At temp 0 every stage is an argmax and the tokens must be equal. At
temp 0.7 the port is fed the Gumbel noise bark_tpu draws from its keys,
following its key schedule (context._next_key: semantic, coarse, fine;
the semantic loop's split(key, max_steps); the coarse stage's per-window
split then split(sub, sws); the fine stage's per-block and per-codebook
splits), and the tokens must again be equal. Audio within 1e-4. What the
two print to stderr is equal too: at Verbosity.LOW (every run here) the
prompt and its token count, at MEDIUM the three hparams lines at load."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu
import bark_tpu_torch
from bark_tpu.io import ggml
from bark_tpu.params import Verbosity

from tiny_model import build_tiny_model, tiny_params

AUDIO_ATOL = 1e-4
TEXT = "hello world"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while a module's tests run (autouse here
    and in every port test module that imports it): pytest-xdist runs
    several worker processes at once, and a default pool of one thread
    per core in each of them makes the port's tests several times slower.
    The count is restored after the module, so other tests see torch's
    default."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gumbel_from_key(stage: str, k, shape):
    """The Gumbel rows bark_tpu's `stage` draws from its stage key `k`
    (jax.random.categorical(k, l) is argmax(l + gumbel(k, l.shape)))."""

    def gumbel(k, shape):
        return jax.random.gumbel(k, shape, jnp.float32)

    if stage == "semantic":  # (max_steps, n_out)
        subs = jax.random.split(k, shape[0])
        g = jax.vmap(lambda s: gumbel(s, shape[1:]))(subs)
    elif stage == "coarse":  # (n_windows, sws, cbs)
        rows = []
        for _ in range(shape[0]):
            k, sub = jax.random.split(k)
            subs = jax.random.split(sub, shape[1])
            rows.append(jax.vmap(lambda s: gumbel(s, shape[2:]))(subs))
        g = jnp.stack(rows)
    else:  # (n_loops, n_fine - n_coarse, block, cbs)
        blocks = []
        for _ in range(shape[0]):
            k, sub = jax.random.split(k)
            books = []
            for _ in range(shape[1]):
                sub, s = jax.random.split(sub)
                books.append(gumbel(s, shape[2:]))
            blocks.append(jnp.stack(books))
        g = jnp.stack(blocks)
    return torch.from_numpy(np.array(g))


def replay_bark_tpu_noise(seed: int):
    """A `noise_source` for the port that returns exactly the Gumbel rows
    bark_tpu's generate draws for `seed`."""
    key = jax.random.PRNGKey(seed)
    keys = {}
    for stage in ("semantic", "coarse", "fine"):
        key, keys[stage] = jax.random.split(key)
    return lambda stage, shape: gumbel_from_key(stage, keys[stage], shape)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "ggml_weights.bin")
    ggml.write_model_file(path, build_tiny_model())
    return path


def stderr_of(fn):
    """(fn()'s result, what it printed to stderr)."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        out = fn()
    return out, buf.getvalue()


@pytest.fixture(scope="module", params=[0.0, 0.7], ids=["temp0", "temp0.7"])
def both(request, weights):
    """(bark_tpu's context, the port's, {package: its generate's stderr})
    after one generate each."""
    temp = request.param
    p = tiny_params(temp=temp, fine_temp=0.5 if temp else 0.0)
    jctx = bark_tpu.bark_load_model(weights, p, seed=0)
    ok, jerr = stderr_of(lambda: bark_tpu.bark_generate_audio(jctx, TEXT))
    assert ok
    tctx = bark_tpu_torch.bark_load_model(weights, p, seed=0, device="cpu")
    tctx.noise_source = replay_bark_tpu_noise(0)
    ok, terr = stderr_of(lambda: bark_tpu_torch.bark_generate_audio(tctx,
                                                                     TEXT))
    assert ok
    return jctx, tctx, {"bark_tpu": jerr, "port": terr}


@pytest.mark.parametrize("stage", ["semantic_tokens", "coarse_tokens",
                                   "fine_tokens"])
def test_tokens_equal(both, stage):
    jctx, tctx, _ = both
    j, t = getattr(jctx, stage), getattr(tctx, stage)
    assert j.shape == t.shape and j.size > 0
    np.testing.assert_array_equal(t, j)


def test_audio_matches(both):
    jctx, tctx, _ = both
    j = bark_tpu.bark_get_audio_data(jctx)
    t = bark_tpu_torch.bark_get_audio_data(tctx)
    assert bark_tpu_torch.bark_get_audio_data_size(tctx) == j.size
    assert t.shape == (tctx.fine_tokens.shape[0] * 320,)
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=AUDIO_ATOL)


def test_statistics_and_getters(both):
    _, tctx, _ = both
    s = tctx.stats
    assert s.n_sample_semantic == tctx.semantic_tokens.size
    assert s.n_sample_coarse == tctx.coarse_tokens.size
    assert s.n_sample_fine == tctx.fine_tokens.size
    assert bark_tpu_torch.bark_get_eval_time(tctx) > 0
    assert bark_tpu_torch.bark_get_load_time(tctx) > 0
    bark_tpu_torch.bark_reset_statistics(tctx)
    assert bark_tpu_torch.bark_get_eval_time(tctx) == 0
    assert bark_tpu_torch.bark_get_load_time(tctx) > 0


def test_stderr_equals_bark_tpus_at_low(both):
    """Verbosity.LOW, the default: the prompt, then its token count and
    first 8 tokens (bark_tpu/api/context.py generate_audio)."""
    jctx, tctx, err = both
    assert err["port"] == err["bark_tpu"]
    head = " ".join(str(t) for t in tctx.tokens[:8])
    assert err["port"].splitlines() == [
        f"bark_tokenize_input: prompt: '{TEXT}'",
        f"bark_tokenize_input: number of tokens in prompt = "
        f"{len(tctx.tokens)}, first 8 tokens: {head}",
    ]
    assert np.array_equal(tctx.tokens, jctx.tokens)


def test_stderr_equals_bark_tpus_at_medium(weights):
    """Verbosity.MEDIUM adds one hparams line per GPT stage at load."""
    p = tiny_params(verbosity=Verbosity.MEDIUM)
    _, jerr = stderr_of(lambda: bark_tpu.bark_load_model(weights, p, seed=0))
    _, terr = stderr_of(lambda: bark_tpu_torch.bark_load_model(
        weights, p, seed=0, device="cpu"))
    assert terr == jerr
    lines = terr.splitlines()
    assert [line.split(":")[0] for line in lines] == [
        f"bark_model_load ({name})" for name in ("semantic", "coarse",
                                                 "fine")]
    assert all("n_embd=32" in line for line in lines)


def test_own_noise_is_seeded(weights):
    """Without replay the port draws its noise from its own generator:
    the same seed gives the same tokens, another seed other tokens."""
    p = tiny_params()
    runs = []
    for seed in (3, 3, 4):
        ctx = bark_tpu_torch.bark_load_model(weights, p, seed=seed,
                                             device="cpu")
        assert bark_tpu_torch.bark_generate_audio(ctx, TEXT)
        runs.append(ctx.fine_tokens)
        bark_tpu_torch.bark_free(ctx)
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def test_mismatched_params_fail_fast(weights):
    with pytest.raises(ValueError, match="model/params mismatch"):
        bark_tpu_torch.bark_load_model(weights, tiny_params(
            semantic_vocab_size=10_000), device="cpu")
