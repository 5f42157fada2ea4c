"""Packed-quantized weights on the batched path end to end on the CPU:
`generate_audio_batch` with `dequantize_on_load=False`, every stage a
qpack, f32 (K9 and K10 step through K5-batched's plain version; the
prefills and the fine stage read a dense copy made once per batch):

- against bark_tpu's `generate_audio_batch` on the same q8_0 file (also
  loaded packed), 3 prompts at temp 0 and at temp 0.7 with bark_tpu's
  per-lane noise replayed: each lane's semantic, coarse and fine tokens
  equal to those bark_tpu's batched stage programs return, audio within
  1e-4 and equal sample counts (without mins the packed product is the
  dense one in f32);
- within the port: lane b of a packed batch equals a single packed
  `generate_audio` given the same noise, lanes that stop at different
  semantic steps included; a q4_1 file (an offset format: the per-lane
  min term) gives the same tokens and audio packed as dequantized at
  load;
- the dense copy is made once per stage and batch, not per coarse window
  or per lane.
"""

import jax
import numpy as np
import pytest
import torch

import bark_tpu
import bark_tpu_torch
from bark_tpu.io import ggml
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.pipeline import coarse as tcoarse

from test_torch_batched_e2e import (FORCED, STOP_AT, _forced_noise,
                                    replay_bark_tpu_lane_noise)
from test_torch_e2e import one_torch_thread  # autouse
from tiny_model import build_tiny_model, tiny_params

AUDIO_ATOL = 1e-4
PROMPTS = ["hello world", "the a hello", "world world the"]
SEED = 5
STAGES = ("semantic", "coarse", "fine")


def _quantized(tmp_path_factory, ftype):
    d = tmp_path_factory.mktemp("qbatch")
    src, dst = str(d / "w.bin"), str(d / "wq.bin")
    ggml.write_model_file(src, build_tiny_model())
    assert bark_tpu_torch.bark_model_quantize(src, dst, ftype)
    return dst


@pytest.fixture(scope="module")
def q8_path(tmp_path_factory):
    return _quantized(tmp_path_factory, ggml.GGMLFType.MOSTLY_Q8_0)


def bark_tpu_batch_lanes(jctx, texts):
    """bark_tpu's `generate_audio_batch(texts)` -> (audio per prompt, each
    lane's semantic, coarse and fine tokens, taken from what its batched
    stage programs return)."""
    build, out = jctx._batched_programs, {}

    def programs(batch):
        progs = build(batch)

        def keep(name, fn):
            def run(*args):
                res = fn(*args)
                out[name] = jax.device_get(res)
                return res
            return run

        return tuple(keep(n, f) for n, f in zip(STAGES, progs[:3])) + (
            progs[3],)

    jctx._batched_programs = programs
    try:
        audio = jctx.generate_audio_batch(texts)
    finally:
        del jctx._batched_programs
    (sem, counts), (codes, n_steps) = out["semantic"], out["coarse"]
    n_cc = jctx.params.n_coarse_codebooks
    lanes = [dict(semantic=sem[b, :counts[b]],
                  coarse=codes[b, :n_steps[b] // n_cc],
                  fine=out["fine"][b, :n_steps[b] // n_cc])
             for b in range(len(texts))]
    return audio, lanes


def _packed(**kw):
    return tiny_params(dequantize_on_load=False, **kw)


@pytest.fixture(scope="module", params=[0.0, 0.7], ids=["temp0", "temp0.7"])
def both(request, q8_path):
    temp = request.param
    p = _packed(temp=temp, fine_temp=0.5 if temp else 0.0)
    jaudio, jlanes = bark_tpu_batch_lanes(
        bark_tpu.bark_load_model(q8_path, p, seed=SEED), PROMPTS)
    tctx = bark_tpu_torch.bark_load_model(q8_path, p, seed=SEED,
                                          device="cpu")
    for stage in STAGES:
        assert "wte_q" in getattr(tctx, stage + "_params"), stage
    tctx.lane_noise_source = replay_bark_tpu_lane_noise(SEED, len(PROMPTS))
    return jaudio, jlanes, tctx._generate_batch(PROMPTS)


@pytest.mark.parametrize("stage", STAGES)
def test_packed_batch_tokens_equal_bark_tpu(both, stage):
    _, jlanes, tlanes = both
    assert len(tlanes) == len(PROMPTS)
    for b, (t, j) in enumerate(zip(tlanes, jlanes)):
        assert t[stage].size > 0
        np.testing.assert_array_equal(t[stage], j[stage], err_msg=f"lane {b}")


def test_packed_batch_audio_matches_bark_tpu(both):
    jaudio, _, tlanes = both
    for j, t in zip(jaudio, tlanes):
        a = t["audio"]
        assert a.shape == j.shape and a.size > 0 and np.isfinite(a).all()
        np.testing.assert_allclose(a, j, rtol=0, atol=AUDIO_ATOL)


def test_packed_lanes_equal_single_packed_requests(q8_path):
    """Lanes that stop after 5, 0 and 12 semantic steps: each lane of a
    packed batch equals a single packed request given its noise, tokens
    and audio exactly; the lane that stops at step 0 gets empty arrays."""
    p = _packed(**FORCED)
    ctx = bark_tpu_torch.bark_load_model(q8_path, p, seed=0, device="cpu")
    ctx.lane_noise_source = _forced_noise
    lanes = ctx._generate_batch(PROMPTS)
    for b, text in enumerate(PROMPTS):
        single = bark_tpu_torch.bark_load_model(q8_path, p, seed=0,
                                                device="cpu")
        single.noise_source = (lambda stage, shape, b=b:
                               _forced_noise(stage, b, shape))
        ok = single.generate_audio(text)
        if STOP_AT[b] == 0:
            assert not ok and lanes[b]["audio"].shape == (0,)
            continue
        assert ok and single.stats.n_sample_semantic == (STOP_AT[b] or 12)
        for key, want in (("semantic", single.semantic_tokens),
                          ("coarse", single.coarse_tokens),
                          ("fine", single.fine_tokens),
                          ("audio", single.generated_audio)):
            np.testing.assert_array_equal(lanes[b][key], want, err_msg=key)


def _lane_noise(stage, lane, shape):
    gen = torch.Generator().manual_seed(100 * lane + len(stage))
    return -torch.log(-torch.log(torch.rand(shape, generator=gen)))


def test_packed_batch_equals_dense_batch_q4_1(tmp_path_factory):
    """q4_1 carries mins: the packed batch adds each lane's exact min term
    after the product, the dense batch reads (q*s + m) rounded once; in
    f32 both give the same tokens, so the same audio."""
    path = _quantized(tmp_path_factory, ggml.GGMLFType.MOSTLY_Q4_1)
    runs = {}
    for packed in (True, False):
        ctx = bark_tpu_torch.bark_load_model(
            path, tiny_params(dequantize_on_load=not packed), seed=0,
            device="cpu")
        assert ("wte_m" in ctx.coarse_params) == packed
        ctx.lane_noise_source = _lane_noise
        runs[packed] = ctx._generate_batch(PROMPTS[:2])
    for b, (t, d) in enumerate(zip(runs[True], runs[False])):
        for key in STAGES + ("audio",):
            assert t[key].size > 0
            np.testing.assert_array_equal(t[key], d[key],
                                          err_msg=f"lane {b} {key}")


def test_packed_batch_densifies_once_per_stage(q8_path, monkeypatch):
    """A batch of 2 prompts over several coarse windows (sliding windows
    of 10 steps) makes one dense copy per stage: semantic, coarse, fine."""
    p = _packed(sliding_window_size=10)
    assert tcoarse.coarse_schedule(p.n_steps_text_encoder, p)[3] > 1
    ctx = bark_tpu_torch.bark_load_model(q8_path, p, seed=0, device="cpu")
    made = []
    dense_from_qpack = tloader.dense_from_qpack

    def counting(cfg, qp, dtype=None):
        made.append(cfg)
        return dense_from_qpack(cfg, qp, dtype)

    monkeypatch.setattr(tloader, "dense_from_qpack", counting)
    outs = ctx.generate_audio_batch(PROMPTS[:2])
    assert len(outs) == 2 and all(a.size > 0 for a in outs)
    assert made == [ctx.semantic_cfg, ctx.coarse_cfg, ctx.fine_cfg]
