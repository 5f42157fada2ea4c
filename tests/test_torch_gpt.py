"""bark_tpu_torch.models.gpt (the plain reference of every kernel) against
bark_tpu.models.gpt on the same numpy-seeded params and inputs, f32 on the
CPU. Tolerance 1e-5 absolute: the two compute the same f32 ops in another
summation order, on activations of order 1."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.io import ggml
from bark_tpu.io import loader as jloader
from bark_tpu.models import gpt as jgpt
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.models import config as tconfig
from bark_tpu_torch.models import gpt as tgpt

from test_torch_e2e import one_torch_thread  # autouse
from tiny_model import build_tiny_model

ATOL = 1e-5
CFG = jgpt.GPTConfig(n_layer=2, n_head=2, n_embd=32, block_size=320,
                     n_in_vocab=200, n_out_vocab=40, n_lm_heads=3, n_wtes=4,
                     bias=True)
TCFG = tconfig.GPTConfig(**dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def params():
    host = jgpt.init_params_numpy(CFG, 0, scale=0.08)
    rng = np.random.RandomState(1)
    for k, v in host["blocks"].items():  # non-trivial biases and LN affines
        if k.endswith("_b") or k.endswith("_g"):
            host["blocks"][k] = v + rng.randn(*v.shape).astype(np.float32) * 0.05
    jp = {k: (jnp.asarray(v) if k != "blocks" else
              {bk: jnp.asarray(bv) for bk, bv in v.items()})
          for k, v in host.items()}
    tp = tloader.params_from_numpy(host, torch.float32, "cpu")
    return jp, tp


def _np(x):
    return np.asarray(x)


def test_decode_step_matches(params):
    jp, tp = params
    rng = np.random.RandomState(2)
    kc = rng.randn(CFG.n_layer, CFG.block_size, CFG.n_embd).astype(np.float32)
    vc = rng.randn(*kc.shape).astype(np.float32)
    n_past, tok = 17, 123
    jl, jk, jv = jgpt.decode_step(CFG, jp, jnp.int32(tok), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.int32(n_past))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tl = tgpt.decode_step(TCFG, tp, torch.tensor(tok), tk, tv, n_past)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), _np(jk), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=0, atol=ATOL)


@pytest.mark.parametrize("T,n_valid", [(257, 257), (300, 211)])
def test_prefill_matches_live_rows(params, T, n_valid):
    jp, tp = params
    rng = np.random.RandomState(3)
    x = (rng.randn(T, CFG.n_embd) * 0.1).astype(np.float32)
    shape = (CFG.n_layer, CFG.block_size, CFG.n_embd)
    jl, jk, jv = jgpt.prefill(CFG, jp, jnp.asarray(x), jnp.zeros(shape),
                              jnp.zeros(shape), jnp.int32(n_valid))
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tl = tgpt.prefill(TCFG, tp, torch.from_numpy(x), tk, tv, n_valid)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)
    # rows past n_valid are dead (unspecified) after a prefill
    np.testing.assert_allclose(tk[:, :n_valid].numpy(),
                               _np(jk)[:, :n_valid], rtol=0, atol=ATOL)
    np.testing.assert_allclose(tv[:, :n_valid].numpy(),
                               _np(jv)[:, :n_valid], rtol=0, atol=ATOL)


@pytest.mark.parametrize("codebook_idx", [1, 3])
def test_fine_forward_matches(params, codebook_idx):
    jp, tp = params
    rng = np.random.RandomState(4)
    toks = rng.randint(0, CFG.n_in_vocab, size=(64, CFG.n_wtes)).astype(
        np.int32)
    jl = jgpt.fine_forward(CFG, jp, jnp.asarray(toks), codebook_idx)
    tl = tgpt.fine_forward(TCFG, tp, torch.from_numpy(toks), codebook_idx)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)


def test_embed_prompt_merged_matches(params):
    jp, tp = params
    toks = np.random.RandomState(5).randint(0, CFG.n_in_vocab, 513).astype(
        np.int32)
    j = jgpt.embed_prompt_merged(CFG, jp, jnp.asarray(toks))
    t = tgpt.embed_prompt_merged(TCFG, tp, torch.from_numpy(toks))
    assert tuple(t.shape) == (257, CFG.n_embd)
    np.testing.assert_array_equal(t.numpy(), _np(j))


def test_layer_norm_and_gelu_match():
    x = np.random.RandomState(6).randn(5, 48).astype(np.float32) * 3
    g = np.linspace(0.5, 1.5, 48).astype(np.float32)
    b = np.linspace(-0.2, 0.2, 48).astype(np.float32)
    np.testing.assert_allclose(
        tgpt.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b)).numpy(),
        _np(jgpt.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(tgpt.gelu(torch.from_numpy(x)).numpy(),
                               _np(jgpt.gelu(jnp.asarray(x))), rtol=0,
                               atol=ATOL)


def test_loader_matches_on_one_file(tmp_path):
    """Both packages read the same ggml_weights.bin: the port's dense GPT
    params (with the c_attn/c_proj/c_fc transposes) and codec params equal
    the JAX package's."""
    from bark_tpu.models import encodec as jenc

    path = str(tmp_path / "w.bin")
    ggml.write_model_file(path, build_tiny_model())
    model = ggml.read_model_file(path)
    for sec in (model.semantic, model.coarse, model.fine):
        jcfg, jp = jloader.gpt_params_from_section(sec)
        tcfg, tp = tloader.gpt_params_from_section(sec, torch.float32, "cpu")
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        for k in ("wte", "wpe", "lm_head", "ln_f_g", "ln_f_b"):
            np.testing.assert_array_equal(tp[k].numpy(), _np(jp[k]))
        for k, v in jp["blocks"].items():
            np.testing.assert_array_equal(tp["blocks"][k].numpy(), _np(v))
    jc = jenc.params_from_section(model.codec)
    tc = tloader.codec_params_from_section(model.codec, "cpu")
    np.testing.assert_array_equal(tc["quantizer"].numpy(), _np(jc["quantizer"]))
    jd, td = jc["decoder"], tc["decoder"]
    for k in ("conv_in_w", "conv_in_b", "conv_out_w", "conv_out_b"):
        np.testing.assert_array_equal(td[k].numpy(), _np(jd[k]))
    for js, ts in zip(jd["stages"] + jd["lstm"], td["stages"] + td["lstm"]):
        assert js.keys() == ts.keys()
        for k in js:
            np.testing.assert_array_equal(ts[k].numpy(), _np(js[k]))
