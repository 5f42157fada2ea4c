"""`BarkContext.generate_audio_batch`, the port's batched serving path, on
one tiny ggml_weights.bin, f32 on the CPU (the batched kernels K7-K10 run
their plain versions):

- against bark_tpu's `generate_audio_batch` for 3 prompts, at temp 0 and
  at temp 0.7 with bark_tpu's per-lane noise replayed (it pads 3 lanes to
  4 and draws its keys stage-major, so lane b's are keys[b], keys[4 + b]
  and keys[8 + b]): audio within 1e-4 and the same sample counts;
- within the port: lane b of a batch is exactly a single
  `generate_audio` given the same noise, including lanes that forced noise
  stops at different semantic steps and a lane that stops at step 0;
- a batch over the batched kernels' lane cap (patched to 2 here) runs as
  groups of 2 and 1, each lane's tokens bit-equal to bark_tpu's and the
  statistics added up;
- what the path refuses (packed stages it takes: see
  tests/test_torch_quant_batched_e2e.py; voices: tests/test_torch_voice.py).
"""

import jax
import numpy as np
import pytest
import torch

import bark_tpu
import bark_tpu_torch
from bark_tpu.io import ggml

from bark_tpu_torch.kernels import bdecode as kbdec

from test_torch_e2e import gumbel_from_key, one_torch_thread
from tiny_model import build_tiny_model, tiny_params

AUDIO_ATOL = 1e-4
PROMPTS = ["hello world", "the a hello", "world world the"]
SEED = 5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "ggml_weights.bin")
    ggml.write_model_file(path, build_tiny_model())
    return path


def replay_bark_tpu_lane_noise(seed: int, B: int):
    """A `lane_noise_source` returning the Gumbel rows bark_tpu's
    generate_audio_batch draws for lane b of a B-prompt batch."""
    Bp = 1 << (B - 1).bit_length()
    key, keys = jax.random.PRNGKey(seed), []
    for _ in range(3 * Bp):
        key, sub = jax.random.split(key)
        keys.append(sub)
    first = {"semantic": 0, "coarse": Bp, "fine": 2 * Bp}
    return lambda stage, lane, shape: gumbel_from_key(
        stage, keys[first[stage] + lane], shape)


@pytest.fixture(scope="module", params=[0.0, 0.7], ids=["temp0", "temp0.7"])
def both(request, weights):
    temp = request.param
    p = tiny_params(temp=temp, fine_temp=0.5 if temp else 0.0)
    jctx = bark_tpu.bark_load_model(weights, p, seed=SEED)
    jout = jctx.generate_audio_batch(PROMPTS)
    tctx = bark_tpu_torch.bark_load_model(weights, p, seed=SEED,
                                          device="cpu")
    tctx.lane_noise_source = replay_bark_tpu_lane_noise(SEED, len(PROMPTS))
    tout = tctx.generate_audio_batch(PROMPTS)
    return jctx, jout, tctx, tout


def test_batch_audio_matches_bark_tpu(both):
    _, jout, _, tout = both
    assert len(tout) == len(PROMPTS)
    for j, t in zip(jout, tout):
        assert t.shape == j.shape and t.size > 0 and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=AUDIO_ATOL)


def test_batch_statistics_match_bark_tpu(both):
    jctx, _, tctx, _ = both
    for f in ("n_sample_semantic", "n_sample_coarse", "n_sample_fine"):
        assert getattr(tctx.stats, f) == getattr(jctx.stats, f) > 0, f
    s = tctx.stats
    assert s.t_eval_us >= s.t_semantic_us + s.t_coarse_us + s.t_fine_us > 0


# semantic_vocab_size 10 makes token 10 the stop token; forced noise picks
# it at each lane's stop step (None: the lane runs all 12 steps)
STOP_AT = [5, 0, None, 9]
FORCED = dict(semantic_vocab_size=10, temp=0.7, fine_temp=0.5)


def _forced_noise(stage, lane, shape):
    gen = torch.Generator().manual_seed(100 * lane + len(stage))
    noise = -torch.log(-torch.log(torch.rand(shape, generator=gen)))
    if stage == "semantic" and STOP_AT[lane] is not None:
        noise[STOP_AT[lane], FORCED["semantic_vocab_size"]] = 1e4
    return noise


def test_lanes_equal_single_requests(weights):
    """Lanes that stop after 5, 0, 12 and 9 semantic steps: each lane's
    tokens in all three stages equal a single request's given its noise,
    and its audio is bit-equal; the lane that stops at step 0 gets empty
    arrays, as a single request gets no audio."""
    p = tiny_params(**FORCED)
    ctx = bark_tpu_torch.bark_load_model(weights, p, seed=0, device="cpu")
    ctx.lane_noise_source = _forced_noise
    texts = PROMPTS + ["a the"]
    lanes = ctx._generate_batch(texts)
    counts = []
    for b, text in enumerate(texts):
        single = bark_tpu_torch.bark_load_model(weights, p, seed=0,
                                                device="cpu")
        single.noise_source = (lambda stage, shape, b=b:
                               _forced_noise(stage, b, shape))
        ok = single.generate_audio(text)
        counts.append(single.stats.n_sample_semantic)
        lane = lanes[b]
        if STOP_AT[b] == 0:
            assert not ok and lane["audio"].shape == (0,)
            assert lane["semantic"].size == lane["fine"].size == 0
            continue
        assert ok and lane["audio"].size > 0
        for key, want in (("semantic", single.semantic_tokens),
                          ("coarse", single.coarse_tokens),
                          ("fine", single.fine_tokens),
                          ("audio", single.generated_audio)):
            np.testing.assert_array_equal(lane[key], want, err_msg=key)
    assert counts == [5, 0, 12, 9]
    assert ctx.stats.n_sample_semantic == sum(counts)


def test_batch_refuses_what_is_not_ported(weights):
    """An empty batch gives an empty list (and no time); nothing else is
    refused, a batch over 32 prompts included
    (`test_grouped_batch_tokens_equal_bark_tpu`)."""
    ctx = bark_tpu_torch.bark_load_model(weights, tiny_params(), seed=0,
                                         device="cpu")
    assert ctx.generate_audio_batch([]) == []
    assert ctx.stats.t_eval_us == 0


@pytest.fixture(scope="module")
def grouped(both, weights):
    """bark_tpu's batch of the 3 prompts (padded to 4 lanes) again, now
    with each lane's tokens (`bark_tpu_batch_lanes`), and the port's batch
    of them at a lane cap of 2: groups of 2 and 1, each lane's noise
    replayed by its index in the whole batch."""
    # that module imports this one's helpers
    from test_torch_quant_batched_e2e import bark_tpu_batch_lanes

    jctx, _, _, _ = both
    jctx.rng_key = jax.random.PRNGKey(SEED)
    jctx.reset_statistics()
    jaudio, jlanes = bark_tpu_batch_lanes(jctx, PROMPTS)
    tctx = bark_tpu_torch.bark_load_model(weights, jctx.params, seed=SEED,
                                          device="cpu")
    groups, real = [], tctx._generate_group

    def group(texts, presets, first):
        groups.append((len(texts), first))
        return real(texts, presets, first)

    tctx._generate_group = group
    tctx.lane_noise_source = replay_bark_tpu_lane_noise(SEED, len(PROMPTS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kbdec, "MAX_LANES", 2)
        tlanes = tctx._generate_batch(PROMPTS)
    assert groups == [(2, 0), (1, 2)]
    return jctx, jaudio, jlanes, tctx, tlanes


@pytest.mark.parametrize("stage", ["semantic", "coarse", "fine"])
def test_grouped_batch_tokens_equal_bark_tpu(grouped, stage):
    """A batch over the lane cap, run as groups, gives each lane bark_tpu's
    tokens bit for bit."""
    _, _, jlanes, _, tlanes = grouped
    assert len(tlanes) == len(jlanes) == len(PROMPTS)
    for b, (t, j) in enumerate(zip(tlanes, jlanes)):
        assert t[stage].size > 0
        np.testing.assert_array_equal(t[stage], j[stage], err_msg=f"lane {b}")


def test_grouped_batch_audio_and_statistics_match(grouped):
    """The groups' audio is bark_tpu's in order, and their statistics add
    up to bark_tpu's batch's."""
    jctx, jaudio, _, tctx, tlanes = grouped
    for j, t in zip(jaudio, tlanes):
        assert t["audio"].shape == j.shape
        np.testing.assert_allclose(t["audio"], j, rtol=0, atol=AUDIO_ATOL)
    for f in ("n_sample_semantic", "n_sample_coarse", "n_sample_fine"):
        assert getattr(tctx.stats, f) == getattr(jctx.stats, f) > 0, f
    s = tctx.stats
    assert s.t_eval_us >= s.t_semantic_us + s.t_coarse_us + s.t_fine_us > 0
