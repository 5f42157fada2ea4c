"""Packed-quantized serving in the port against bark_tpu, on the CPU:

- the loader: the port's qpack leaf for leaf equal to bark_tpu's (f16
  scales where bark_tpu ships their bit patterns as int16), the densified
  qpack bit-equal to dequantize-at-load, and a bark_tpu qpack carried over
  by `qparams_from_numpy`;
- K5's plain version (one packed decode step of `models.gpt` on a qpack,
  what `kernels.decode.decode_step_fused` runs on CPU tensors) against
  bark_tpu's packed Pallas kernel in interpret mode, f32, on the section of
  tests/test_quant_decode.py: logits within 2e-4, argmax and K/V rows
  equal to 2e-4; and K4 over a qpack (a 10-step coarse window whose steps
  are packed steps) against bark_tpu's packed window kernel: equal
  tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.io import ggml as jggml
from bark_tpu.io import loader as jloader
from bark_tpu.kernels import decode as jkdec
from bark_tpu.models import gpt as jgpt
from bark_tpu_torch.io import ggml as tggml
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.kernels import decode as tkdec

from test_quant_decode import _section
from test_torch_e2e import one_torch_thread  # autouse

TOL = 2e-4


def _port_section(jsec):
    """The same section as the port's ggml types hold it."""
    return tggml.GPTSection(
        hparams=tggml.GPTHParams(**jsec.hparams.__dict__),
        tensors={k: tggml.TensorRecord(r.name, r.shape, tggml.GGMLType(
            int(r.ttype)), bytes(r.data)) for k, r in jsec.tensors.items()},
    )


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _as_port_numpy(leaf):
    """A bark_tpu qpack leaf as the port holds it: int16 scales are f16
    bit patterns."""
    a = np.asarray(leaf)
    return a.view(np.float16) if a.dtype == np.int16 else a


@pytest.mark.parametrize("qt", ["Q8_0", "Q5_1", "Q4_K"])
def test_qpack_leaves_equal_bark_tpu(qt):
    sec = _section(jggml.GGMLType[qt])
    jcfg, jq = jloader.gpt_qparams_from_section(sec, jnp.float32)
    tcfg, tq = tloader.gpt_qparams_from_section(_port_section(sec),
                                                torch.float32, "cpu")
    assert tloader.section_is_quantized(_port_section(sec))
    assert tcfg.n_embd == jcfg.n_embd and tcfg.n_layer == jcfg.n_layer
    jf, tf = _flat(jq), _flat(tq)
    assert sorted(tf) == sorted(jf)
    for k, j in jf.items():
        j = _as_port_numpy(j)
        t = tf[k].numpy()
        assert t.dtype == j.dtype, (k, t.dtype, j.dtype)
        np.testing.assert_array_equal(t, j, err_msg=k)
    # mins only for the offset formats; scales f16 exactly when lossless
    assert ("wte_m" in tq) == (qt != "Q8_0")
    assert tq["blocks"]["qkv_s"].dtype == (
        torch.float32 if qt == "Q4_K" else torch.float16)


@pytest.mark.parametrize("qt,heads", [("Q5_1", 1), ("Q4_K", 1),
                                      ("Q8_0", 7), ("Q4_1", 7)])
def test_dense_from_qpack_equals_load_dequant(qt, heads):
    sec = _port_section(_section(jggml.GGMLType[qt], n_wtes=heads,
                                 n_lm_heads=heads))
    cfg, qp = tloader.gpt_qparams_from_section(sec, torch.float32, "cpu")
    assert ("lm_heads_q" in qp) == (heads > 1)
    _, dense = tloader.gpt_params_from_section(sec, torch.float32, "cpu")
    got = _flat(tloader.dense_from_qpack(cfg, qp))
    want = _flat(dense)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_qparams_from_numpy_carries_a_bark_tpu_qpack():
    sec = _section(jggml.GGMLType.Q5_1)
    _, jq = jloader.gpt_qparams_from_section(sec, jnp.float32)
    host = jax.tree.map(np.asarray, jq)
    assert host["blocks"]["fc_s"].dtype == np.int16  # f16 bit patterns
    got = _flat(tloader.qparams_from_numpy(host, torch.float32, "cpu"))
    _, want = tloader.gpt_qparams_from_section(_port_section(sec),
                                               torch.float32, "cpu")
    for k, v in _flat(want).items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("qt", ["Q8_0", "Q5_1", "Q4_0"])
def test_packed_step_matches_pallas(qt):
    """One packed decode step at n_past 5 after a 5-row prefill."""
    sec = _section(jggml.GGMLType[qt])
    cfg, jq = jloader.gpt_qparams_from_section(sec, jnp.float32)
    _, dense = jloader.gpt_params_from_section(sec, jnp.float32)
    kc, vc = jgpt.init_kv_cache(cfg, dtype=jnp.float32)
    x_emb = jnp.take(dense["wte"][0], jnp.arange(5), axis=0)
    _, kc, vc = jgpt.prefill(cfg, dense, x_emb, kc, vc, jnp.int32(5))
    jl, jk, jv = jkdec.decode_step_fused(
        cfg, jq, jnp.int32(17), kc, vc, jnp.int32(5), quant=True,
        interpret=True)
    tcfg, tq = tloader.gpt_qparams_from_section(_port_section(sec),
                                                torch.float32, "cpu")
    tk, tv = torch.from_numpy(np.array(kc)), torch.from_numpy(np.array(vc))
    tl = tkdec.decode_step_fused(tcfg, tq, 17, tk, tv, 5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    assert int(tl.argmax()) == int(jnp.argmax(jl))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=TOL)
    # the LM window: the same logits inside, exact zeros outside
    tk, tv = torch.from_numpy(np.array(kc)), torch.from_numpy(np.array(vc))
    tw = tkdec.decode_step_fused(tcfg, tq, 17, tk, tv, 5,
                                 lm_window=(40, 150))
    np.testing.assert_allclose(tw[40:150].numpy(), np.asarray(jl)[40:150],
                               rtol=0, atol=TOL)
    assert not tw[:40].any() and not tw[150:].any()


def test_packed_window_matches_pallas():
    """K4 over a q5_1 qpack: one 10-step coarse window at temp 0.7, odd
    step parity, from a 40-row context; noise = the JAX kernel's gumbel
    rows. Tokens equal, the window's K/V rows within 2e-4."""
    from bark_tpu.kernels import window as jkwin
    from bark_tpu_torch.kernels import window as tkwin

    sws, svs, cbs, ctx_len = 10, 32, 64, 40
    lmw = (svs, svs + 2 * cbs)
    sec = _section(jggml.GGMLType.Q5_1)
    cfg, jq = jloader.gpt_qparams_from_section(sec, jnp.float32)
    pp = jkwin.prepare_window_params(
        cfg, jkdec.prepare_decode_params(cfg, jq, quant=True, lm_window=lmw),
        svs=svs, cbs=cbs,
        dense_wte=jloader.dense_from_qpack(cfg, jq)["wte"][0])
    rng = np.random.RandomState(8)
    shape = (cfg.n_layer, cfg.block_size, cfg.n_embd)
    kc, vc = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    kc[:, :ctx_len] = rng.randn(cfg.n_layer, ctx_len, cfg.n_embd) * 0.5
    vc[:, :ctx_len] = rng.randn(cfg.n_layer, ctx_len, cfg.n_embd) * 0.5
    logits0 = (rng.randn(cfg.n_out_vocab) * 2).astype(np.float32)
    subs = jax.random.split(jax.random.PRNGKey(5), sws)
    jt, jk, jv = jkwin.coarse_window_fused(
        cfg, pp, jnp.asarray(logits0), jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(ctx_len), jnp.int32(1), subs, sws=sws, temp=0.7,
        semantic_vocab_size=svs, codebook_size=cbs, lm_window=lmw,
        quant=True, interpret=True,
    )
    noise = torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (cbs,), jnp.float32))(subs)))
    tcfg, tq = tloader.gpt_qparams_from_section(_port_section(sec),
                                                torch.float32, "cpu")
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tt = tkwin.coarse_window_fused(
        tcfg, tq, torch.from_numpy(logits0), tk, tv, ctx_len, 1, noise,
        sws=sws, temp=0.7, semantic_vocab_size=svs, codebook_size=cbs,
        lm_window=lmw,
    )
    assert tt.tolist() == np.asarray(jt).tolist()
    rows = slice(ctx_len, ctx_len + sws)
    np.testing.assert_allclose(tk[:, rows].numpy(), np.asarray(jk)[:, rows],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tv[:, rows].numpy(), np.asarray(jv)[:, rows],
                               rtol=0, atol=TOL)
