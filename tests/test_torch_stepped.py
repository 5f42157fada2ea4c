"""The stepped path (`detailed_stats`, `progress_callback`) and
`profile_dir` of the port against bark_tpu's, f32 on the CPU.

The tiny model runs 70 semantic steps here (past the end of its 320-slot
semantic cache, so the slot clamps), which gives 4 coarse windows and 3
fine blocks: the stepped path runs the fused stage programs, which call
its progress callback after each window and each block.

- Against bark_tpu's stepped path, at temp 0.7 with its noise replayed,
  at temp 0, and with top-k/top-p: the semantic, coarse and fine tokens
  equal, audio within AUDIO_ATOL, and the callbacks' (step, percent)
  sequence equal.
- Within the port: the stepped path's tokens equal the fused path's for
  the same seed (its own noise, drawn in the same order), dense, packed
  q8_0, on the int8 KV cache, with filters and with a voice.
- `profile_dir` writes a torch.profiler trace of the request there.

bark_tpu's runs come from tests/torch_jax_reference.py (one context,
its programs keyed by temp, top_k, top_p and the step count)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

import bark_tpu_torch
from bark_tpu_torch.kernels import window as kwin
from bark_tpu_torch.pipeline import fine as tfine

import torch_jax_reference as ref
from test_torch_e2e import AUDIO_ATOL, one_torch_thread, replay_bark_tpu_noise
from tiny_model import tiny_params

STAGES = ("semantic_tokens", "coarse_tokens", "fine_tokens")
STEPS = 70
TEXT = "hello world the a"
SEED = 2


def params(**kw):
    return tiny_params(n_steps_text_encoder=STEPS, **kw)


def stepped_pair(steps=STEPS, **kw):
    """bark_tpu's and the port's stepped request at `steps` semantic steps
    and tiny_params(**kw), each with a recording progress callback:
    (bark_tpu's run, the port's context, its (step, percent) calls)."""
    j = ref.request(TEXT, SEED, detailed_stats=True,
                    n_steps_text_encoder=steps, **kw)
    calls = []
    t = bark_tpu_torch.bark_load_model(
        ref.weights(), tiny_params(
            n_steps_text_encoder=steps, progress_callback=lambda ctx, step,
            pc, ud: calls.append((int(step), pc)), **kw),
        seed=0, device="cpu")
    t.noise_source = replay_bark_tpu_noise(SEED)
    assert t.generate_audio(TEXT)
    return j, t, calls


@pytest.fixture(scope="module")
def default():
    return stepped_pair()


@pytest.mark.parametrize("stage", STAGES)
def test_stepped_tokens_equal_bark_tpu(default, stage):
    j, t, _ = default
    assert getattr(t, stage).size > 0
    np.testing.assert_array_equal(getattr(t, stage),
                                  j[stage.split("_")[0]])


def test_stepped_audio_matches_bark_tpu(default):
    j, t, _ = default
    assert t.generated_audio.shape == (t.fine_tokens.shape[0] * 320,)
    np.testing.assert_allclose(t.generated_audio, j["audio"], rtol=0,
                               atol=AUDIO_ATOL)


def test_stepped_callbacks_equal_bark_tpus(default):
    """(step, percent) after the semantic stage, each of the 4 windows and
    each of the 3 blocks, as bark_tpu calls them."""
    j, t, tcalls = default
    assert tcalls == j["calls"]
    assert tcalls == [(0, 0), (0, 100), (1, 28), (1, 57), (1, 85), (1, 100),
                      (2, 33), (2, 66), (2, 100)]
    assert t.semantic_tokens.size == STEPS


def test_stepped_statistics(default):
    """Per-stage times and counts, and print_statistics' three lines."""
    j, t, _ = default
    s = t.stats
    for f in ("n_sample_semantic", "n_sample_coarse", "n_sample_fine"):
        assert getattr(s, f) == getattr(j["stats"], f) > 0, f
    assert min(s.t_semantic_us, s.t_coarse_us, s.t_fine_us) > 0
    assert s.t_eval_us >= s.t_semantic_us + s.t_coarse_us + s.t_fine_us
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        t.print_statistics()
    lines = err.getvalue().splitlines()
    assert [line.split()[1] for line in lines] == ["semantic", "coarse",
                                                   "fine"]
    assert f"/ {s.n_sample_coarse} tokens" in lines[1]


@pytest.mark.parametrize("kw", [
    dict(steps=12, temp=0.0, top_k=5, top_p=0.8), dict(top_k=5, top_p=0.8)],
    ids=["temp0", "top_k+top_p"])
def test_stepped_variants_equal_bark_tpu(kw):
    """At temp 0 (the semantic and coarse stages, where the filters do
    nothing; the fine stage samples at 0.5; 12 steps, bark_tpu's programs
    shared with tests/test_torch_filters.py), and with the filters (every
    token one single step; the 70 semantic steps go past the cache's end,
    where the slot clamps)."""
    j, t, calls = stepped_pair(**kw)
    for stage in STAGES:
        np.testing.assert_array_equal(getattr(t, stage),
                                      j[stage.split("_")[0]], err_msg=stage)
    np.testing.assert_allclose(t.generated_audio, j["audio"], rtol=0,
                               atol=AUDIO_ATOL)
    assert calls == j["calls"]


@pytest.mark.parametrize("kw", [
    dict(), dict(temp=0.0, fine_temp=0.0), dict(kv_cache_dtype="int8"),
    dict(top_k=5, top_p=0.8), dict(dequantize_on_load=False), "voice"],
    ids=["dense", "temp0", "kv8", "filters", "q8_0", "voice"])
def test_stepped_equals_fused(kw, tmp_path):
    """The same seed through the fused and the stepped path: equal tokens
    in every stage and bit-equal audio (30 semantic steps: two coarse
    windows)."""
    path = ref.weights("q8_0" if kw == dict(dequantize_on_load=False)
                       else "f32")
    voice = None
    if kw == "voice":
        kw, voice = {}, str(tmp_path / "v.npz")
        ctx = bark_tpu_torch.bark_load_model(path, tiny_params(), seed=7,
                                             device="cpu")
        assert ctx.generate_audio("the a")
        ctx.save_voice(voice)
    runs = []
    for stepped in (False, True):
        ctx = bark_tpu_torch.bark_load_model(
            path, tiny_params(n_steps_text_encoder=30,
                              detailed_stats=stepped, **kw),
            seed=3, device="cpu")
        assert ctx.generate_audio(TEXT, voice=voice)
        runs.append(ctx)
    for stage in STAGES:
        np.testing.assert_array_equal(getattr(runs[1], stage),
                                      getattr(runs[0], stage), err_msg=stage)
    np.testing.assert_array_equal(runs[1].generated_audio,
                                  runs[0].generated_audio)


def test_stepped_path_calls_a_program_per_window_and_block(monkeypatch):
    """The stepped path calls the window kernel (K4) once per coarse
    window (2 at 30 semantic steps) and the block program once per fine
    block (1), each followed by a progress callback; the fused path runs
    the same windows and blocks without calling back."""
    events = []
    window = kwin.coarse_window_fused
    make_block = tfine.make_fine_block_program

    def counted_window(*a, **k):
        events.append("window")
        return window(*a, **k)

    def counted_block_program(*a, **k):
        refine = make_block(*a, **k)

        def run(*b, **c):
            events.append("block")
            return refine(*b, **c)
        return run

    monkeypatch.setattr(kwin, "coarse_window_fused", counted_window)
    monkeypatch.setattr(tfine, "make_fine_block_program",
                        counted_block_program)
    runs = {}
    for stepped in (False, True):
        events.clear()
        cb = (lambda ctx, step, pc, ud: events.append((int(step), pc))) \
            if stepped else None
        ctx = bark_tpu_torch.bark_load_model(
            ref.weights(), tiny_params(n_steps_text_encoder=30,
                                       progress_callback=cb),
            seed=3, device="cpu")
        assert ctx.generate_audio(TEXT)
        runs[stepped] = (list(events), ctx.fine_tokens)
    assert runs[False][0] == ["window"] * 2 + ["block"]
    assert runs[True][0] == [(0, 0), (0, 100), "window", (1, 66), "window",
                             (1, 100), "block", (2, 100)]
    np.testing.assert_array_equal(runs[True][1], runs[False][1])


def test_profile_dir_writes_a_trace(tmp_path):
    """A profile_dir request writes one Chrome trace under the directory,
    holding the request's host ops (the codec's convolutions and LSTM
    among them), and the same tokens as without it."""
    trace_dir = str(tmp_path / "trace")
    runs = []
    for pdir in (trace_dir, None):
        ctx = bark_tpu_torch.bark_load_model(
            ref.weights(), tiny_params(profile_dir=pdir,
                                       n_steps_text_encoder=4),
            seed=3, device="cpu")
        assert ctx.generate_audio(TEXT)
        runs.append(ctx)
    names = os.listdir(trace_dir)
    assert len(names) == 1 and names[0].endswith(".pt.trace.json")
    with open(os.path.join(trace_dir, names[0])) as f:
        events = json.load(f)["traceEvents"]
    ops = {e.get("name") for e in events}
    assert "aten::conv1d" in ops and "aten::lstm" in ops
    np.testing.assert_array_equal(runs[0].fine_tokens, runs[1].fine_tokens)
