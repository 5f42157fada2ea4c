"""K5-batched's plain version (the batched decode step on a qpack: what
`kernels.bdecode.decode_step_fused_batched` runs on CPU tensors, and what
K9 and K10 step through) against bark_tpu's packed batched Pallas kernels
in interpret mode, f32, on the sections of tests/test_quant_decode.py:

- one step of B = 1 and 3 lanes at different slots, on q8_0, q4_0, q5_1
  and q4_k qpacks: logits and the K/V rows written within 2e-4 (f32 on
  both sides, another summation order), argmax equal; with the coarse
  LM window, the same logits inside and exact zeros outside;
- the same step of 3 lanes on int8 caches: logits within 2e-4, the int8
  rows equal but for one-step flips at no more than 0.01% of the values,
  their scales (a fresh row's amax / 127) within 2e-4 / 127;
- K9 (an 8-step semantic chunk of 3 lanes) and K10 (a 10-step coarse
  window of 3 lanes at different context lengths) on a q5_1 qpack,
  bark_tpu's Gumbel rows replayed into the port: tokens and flags equal.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.io import ggml as jggml
from bark_tpu.io import loader as jloader
from bark_tpu.kernels import decode as jkdec
from bark_tpu.kernels import semantic as jksem
from bark_tpu.kernels import window as jkwin
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.kernels import bdecode as tkbdec
from bark_tpu_torch.kernels import bsemantic as tkbsem
from bark_tpu_torch.kernels import bwindow as tkbwin

from test_quant_decode import _section
from test_torch_e2e import one_torch_thread  # autouse
from test_torch_kv8 import _jax, _kv8_cache, _torch
from test_torch_quant import _port_section

TOL = 2e-4
FORMATS = ["Q8_0", "Q4_0", "Q5_1", "Q4_K"]
LANES = {1: ([17], [5]), 3: ([17, 3, 250], [0, 5, 63])}  # tokens, slots
WINDOW = (40, 150)


def _kv8_close(t, j):
    """A port int8 cache against bark_tpu's: the fresh rows are computed in
    another summation order on the two sides (held within TOL where the
    cache is dense), so their scales agree within TOL / 127 and a value
    next to a rounding boundary may land one step apart."""
    np.testing.assert_allclose(t["s"].numpy(), np.asarray(j["s"]), rtol=0,
                               atol=TOL / 127)
    diff = np.abs(t["q"].numpy().astype(np.int32)
                  - np.asarray(j["q"], np.int32))
    assert diff.max() <= 1
    assert int((diff > 0).sum()) <= max(1, math.ceil(1e-4 * diff.size))


@functools.lru_cache(maxsize=None)
def _qpacks(qt: str):
    """(cfg, bark_tpu qpack, port cfg, port qpack) of one section."""
    sec = _section(jggml.GGMLType[qt])
    cfg, jq = jloader.gpt_qparams_from_section(sec, jnp.float32)
    tcfg, tq = tloader.gpt_qparams_from_section(_port_section(sec),
                                                torch.float32, "cpu")
    return cfg, jq, tcfg, tq


def _caches(cfg, B, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layer, B, cfg.block_size, cfg.n_embd)
    return ((rng.randn(*shape) * 0.5).astype(np.float32),
            (rng.randn(*shape) * 0.5).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _pallas_step(qt: str, B: int):
    """bark_tpu's packed batched step: (caches before, logits, caches
    after), numpy."""
    cfg, jq, _, _ = _qpacks(qt)
    toks, n_past = LANES[B]
    kc, vc = _caches(cfg, B, 30 + B)
    jl, jk, jv = jkdec.decode_step_fused_batched(
        cfg, jq, jnp.asarray(toks, jnp.int32), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(n_past, jnp.int32), quant=True,
        interpret=True)
    return (kc, vc), np.asarray(jl), (np.asarray(jk), np.asarray(jv))


@pytest.mark.parametrize("win", [None, WINDOW], ids=["head", "window"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("qt", FORMATS)
def test_packed_batched_step_matches_pallas(qt, B, win):
    (kc, vc), jl, (jk, jv) = _pallas_step(qt, B)
    _, _, tcfg, tq = _qpacks(qt)
    toks, n_past = LANES[B]
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tl = tkbdec.decode_step_fused_batched(tcfg, tq, toks, tk, tv, n_past,
                                          lm_window=win).numpy()
    lo, hi = win or (0, tcfg.n_out_vocab)
    np.testing.assert_allclose(tl[:, lo:hi], jl[:, lo:hi], rtol=0, atol=TOL)
    assert not tl[:, :lo].any() and not tl[:, hi:].any()
    if win is None:
        assert (tl.argmax(-1) == jl.argmax(-1)).all()
    np.testing.assert_allclose(tk.numpy(), jk, rtol=0, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=TOL)


@pytest.mark.parametrize("qt", FORMATS)
def test_packed_batched_step_int8_cache_matches_pallas(qt):
    """Three lanes on int8 caches whose rows [0, 63) hold quantized random
    rows; lane 0 decodes at slot 0, lanes 1 and 2 after 5 and 62 rows."""
    cfg, jq, tcfg, tq = _qpacks(qt)
    toks, n_past = [17, 3, 250], [0, 5, 62]
    kc, vc = _kv8_cache(cfg, 63, 40, batch=3)
    jl, jk, jv = jkdec.decode_step_fused_batched(
        cfg, jq, jnp.asarray(toks, jnp.int32), _jax(kc), _jax(vc),
        jnp.asarray(n_past, jnp.int32), quant=True, interpret=True)
    tk, tv = _torch(kc), _torch(vc)
    tl = tkbdec.decode_step_fused_batched(tcfg, tq, toks, tk, tv, n_past)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    assert (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).all()
    _kv8_close(tk, jk)
    _kv8_close(tv, jv)


def test_packed_batched_chunk_matches_pallas():
    """K9 over a q5_1 qpack: 8 steps of 3 lanes at temp 0.7 after 40 rows
    of context, the EOS test at min_eos_p 0.02 (so some flags are set)."""
    cfg, jq, tcfg, tq = _qpacks("Q5_1")
    B, K, ctx0, svs, temp, min_eos_p = 3, 8, 40, 150, 0.7, 0.02
    pp = jkdec.prepare_decode_params(cfg, jq, quant=True)
    pp = jksem.prepare_semantic_params(
        cfg, pp, dense_wte=jloader.dense_from_qpack(cfg, jq)["wte"][0])
    kc, vc = _caches(cfg, B, 50)
    kc[:, :, ctx0:] = vc[:, :, ctx0:] = 0
    logits0 = (np.random.RandomState(51).randn(B, cfg.n_out_vocab)
               * 2).astype(np.float32)
    subs = jax.vmap(lambda k: jax.random.split(k, 2 * K))(
        jax.vmap(jax.random.PRNGKey)(jnp.asarray([5, 12, 19])))
    gum = jksem.make_gumbel_rows_batched(subs, jnp.int32(0), K,
                                         cfg.n_out_vocab,
                                         jkdec._v_pad(cfg), temp)
    jt, jf, _, _, _ = jksem.semantic_chunk_fused_batched(
        cfg, pp, jnp.asarray(logits0), jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(ctx0), jnp.int32(0), gum, jnp.float32(min_eos_p), K=K,
        temp=temp, semantic_vocab_size=svs, quant=True, interpret=True)
    noise = torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.gumbel(k, (cfg.n_out_vocab,), jnp.float32)))(
        subs[:, :K])))
    tt, tf, _ = tkbsem.semantic_chunk_fused_batched(
        tcfg, tq, torch.from_numpy(logits0), torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), ctx0, 0, noise, min_eos_p, K=K,
        temp=temp, semantic_vocab_size=svs)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tf.tolist() == np.asarray(jf).tolist()
    assert 0 < int(tf.sum()) < B * K


def test_packed_batched_window_matches_pallas():
    """K10 over a q5_1 qpack: one 10-step window of 3 lanes at temp 0.7,
    odd step parity, from contexts of 40, 48 and 30 rows."""
    cfg, jq, tcfg, tq = _qpacks("Q5_1")
    sws, svs, cbs, ctx_len = 10, 32, 64, [40, 48, 30]
    B, lmw = len(ctx_len), (svs, svs + 2 * cbs)
    pp = jkwin.prepare_window_params(
        cfg, jkdec.prepare_decode_params(cfg, jq, quant=True, lm_window=lmw),
        svs=svs, cbs=cbs,
        dense_wte=jloader.dense_from_qpack(cfg, jq)["wte"][0])
    kc, vc = _caches(cfg, B, 60)
    for b, c in enumerate(ctx_len):
        kc[:, b, c:] = vc[:, b, c:] = 0
    logits0 = (np.random.RandomState(61).randn(B, cfg.n_out_vocab)
               * 2).astype(np.float32)
    subs = jnp.stack([jax.random.split(jax.random.PRNGKey(7 + b), sws)
                      for b in range(B)], axis=1)  # (sws, B, 2)
    jt, _, _ = jkwin.coarse_window_fused_batched(
        cfg, pp, jnp.asarray(logits0), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(ctx_len, jnp.int32), jnp.int32(1), subs, sws=sws,
        temp=0.7, semantic_vocab_size=svs, codebook_size=cbs, lm_window=lmw,
        quant=True, interpret=True)
    noise = torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.gumbel(k, (cbs,), jnp.float32)))(subs)))
    tt = tkbwin.coarse_window_fused_batched(
        tcfg, tq, torch.from_numpy(logits0), torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), ctx_len, 1, noise, sws=sws, temp=0.7,
        semantic_vocab_size=svs, codebook_size=cbs, lm_window=lmw)
    assert tt.tolist() == np.asarray(jt).tolist()
