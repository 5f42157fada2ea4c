"""Packed-quantized serving end to end on the CPU, through the public API.

The tiny model is quantized to q8_0 with the port's `bark_model_quantize`.
bark_tpu loads it dequantized at load; the port loads all three stages
packed (`dequantize_on_load=False`), so its causal stages decode through
K5's plain version and its prefills and fine stage through the per-call
dense copy. At temp 0.7, with bark_tpu's Gumbel noise replayed into the
port, the tokens of every stage are equal and the audio is within 1e-4:
without mins, the packed product x @ (q*s) is the dense product in f32.

q4_1 (an offset format: the min term is added after the product, not
folded into the weight) runs on the port alone, packed against dense at
temp 0: equal tokens in every stage, and the first semantic step's logits
within 2e-4."""

import numpy as np
import pytest
import torch

import bark_tpu
import bark_tpu_torch
from bark_tpu.io import ggml
from bark_tpu_torch.kernels import decode as tkdec
from bark_tpu_torch.kernels import prefill as tkpre
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.models import gpt as tgpt
from bark_tpu_torch.pipeline import semantic as tsem

from test_torch_e2e import (AUDIO_ATOL, TEXT, one_torch_thread,
                            replay_bark_tpu_noise)
from tiny_model import build_tiny_model, tiny_params

STAGES = ("semantic_tokens", "coarse_tokens", "fine_tokens")


def _quantized(tmp_path_factory, ftype):
    d = tmp_path_factory.mktemp("quant")
    src, dst = str(d / "w.bin"), str(d / "wq.bin")
    ggml.write_model_file(src, build_tiny_model())
    assert bark_tpu_torch.bark_model_quantize(src, dst, ftype)
    return dst


@pytest.fixture(scope="module")
def q8_runs(tmp_path_factory):
    path = _quantized(tmp_path_factory, ggml.GGMLFType.MOSTLY_Q8_0)
    p = tiny_params(temp=0.7, fine_temp=0.5)
    jctx = bark_tpu.bark_load_model(path, p, seed=0)
    assert bark_tpu.bark_generate_audio(jctx, TEXT)
    tctx = bark_tpu_torch.bark_load_model(
        path, tiny_params(temp=0.7, fine_temp=0.5, dequantize_on_load=False),
        seed=0, device="cpu")
    tctx.noise_source = replay_bark_tpu_noise(0)
    assert bark_tpu_torch.bark_generate_audio(tctx, TEXT)
    return jctx, tctx


def test_q8_0_stages_load_packed(q8_runs):
    _, tctx = q8_runs
    for stage in ("semantic", "coarse", "fine"):
        params = getattr(tctx, stage + "_params")
        assert "wte_q" in params and "wte" not in params, stage
        assert params["blocks"]["qkv_q"].dtype == torch.int8
        assert params["wte_s"].dtype == torch.float16
    assert "lm_heads_q" in tctx.fine_params and "lm_q" in tctx.coarse_params


@pytest.mark.parametrize("stage", STAGES)
def test_q8_0_tokens_equal_bark_tpu(q8_runs, stage):
    jctx, tctx = q8_runs
    j, t = getattr(jctx, stage), getattr(tctx, stage)
    assert j.shape == t.shape and j.size > 0
    np.testing.assert_array_equal(t, j)


def test_q8_0_audio_matches_bark_tpu(q8_runs):
    jctx, tctx = q8_runs
    t = bark_tpu_torch.bark_get_audio_data(tctx)
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, bark_tpu.bark_get_audio_data(jctx), rtol=0,
                               atol=AUDIO_ATOL)


@pytest.fixture(scope="module")
def q4_1_path(tmp_path_factory):
    return _quantized(tmp_path_factory, ggml.GGMLFType.MOSTLY_Q4_1)


def test_q4_1_packed_matches_dense(q4_1_path):
    runs = {}
    for packed in (True, False):
        ctx = bark_tpu_torch.bark_load_model(
            q4_1_path, tiny_params(temp=0.0, fine_temp=0.0,
                                   dequantize_on_load=not packed),
            seed=0, device="cpu")
        assert ("wte_q" in ctx.semantic_params) == packed
        assert bark_tpu_torch.bark_generate_audio(ctx, TEXT)
        runs[packed] = ctx
    for stage in STAGES:
        np.testing.assert_array_equal(getattr(runs[True], stage),
                                      getattr(runs[False], stage))

    # the semantic prefill and the first step that decodes from it
    logits = {}
    for packed, ctx in runs.items():
        cfg, params = ctx.semantic_cfg, ctx.semantic_params
        dense = tloader.densify(cfg, params)
        tokens = torch.as_tensor(ctx.tokens)
        kc, vc = tgpt.init_kv_cache(cfg, torch.float32, "cpu")
        x_emb = tgpt.embed_prompt_merged(cfg, dense, tokens)
        pre = tkpre.prefill_fused(cfg, dense, x_emb, kc, vc, tsem.PROMPT_ROWS)
        step = tkdec.decode_step_fused(cfg, params, int(pre.argmax()), kc, vc,
                                       tsem.PROMPT_ROWS)
        logits[packed] = (pre, step)
    for a, b in zip(logits[True], logits[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-4)
