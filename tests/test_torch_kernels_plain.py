"""The plain PyTorch versions of K1-K4 (the CPU side of every kernel
wrapper in bark_tpu_torch.kernels) against the JAX package's Pallas
kernels run as its own tests run them on the CPU: interpret mode, on the
configs of tests/test_{decode,prefill,semantic,window}_kernel.py, one
kernel call each, with the same numpy-seeded params, caches and noise.

Tokens and stop flags must be equal; logits and cache rows within 1e-5
absolute (f32 on both sides, another summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.kernels import decode as jkdec
from bark_tpu.kernels import prefill as jkpre
from bark_tpu.kernels import semantic as jksem
from bark_tpu.kernels import window as jkwin
from bark_tpu.models import gpt as jgpt
from bark_tpu_torch import kernels as tkernels
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.kernels import decode as tkdec
from bark_tpu_torch.kernels import prefill as tkpre
from bark_tpu_torch.kernels import semantic as tksem
from bark_tpu_torch.kernels import window as tkwin
from bark_tpu_torch.models import config as tconfig

from test_torch_e2e import one_torch_thread  # autouse

ATOL = 1e-5
# tests/test_decode_kernel.py:16 (K1); the prefill, semantic and window
# kernel tests use the same model with block_size 512
DECODE_CFG = jgpt.GPTConfig(n_layer=2, n_head=2, n_embd=128, block_size=64,
                            n_in_vocab=300, n_out_vocab=200, bias=True)
CHUNK_CFG = dataclasses.replace(DECODE_CFG, block_size=512)


def _tcfg(cfg):
    return tconfig.GPTConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed):
    """numpy params with non-zero biases, as (jax, torch) trees."""
    host = jgpt.init_params_numpy(cfg, seed)
    rng = np.random.RandomState(seed + 1)
    for k, v in host["blocks"].items():
        if k.endswith("_b"):
            host["blocks"][k] = (rng.randn(*v.shape) * 0.01).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, host)
    return jp, tloader.params_from_numpy(host, torch.float32, "cpu")


def _cache(cfg, rows, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layer, cfg.block_size, cfg.n_embd)
    kc, vc = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    kc[:, :rows] = rng.randn(cfg.n_layer, rows, cfg.n_embd) * 0.5
    vc[:, :rows] = rng.randn(cfg.n_layer, rows, cfg.n_embd) * 0.5
    return kc, vc


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


def test_decode_plain_matches_pallas():
    cfg = DECODE_CFG
    jp, tp = _params(cfg, 0)
    kc, vc = _cache(cfg, 5, 1)
    jl, jk, jv = jkdec.decode_step_fused(
        cfg, jp, jnp.int32(17), jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(5), interpret=True,
    )
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tl = tkdec.decode_step_fused(_tcfg(cfg), tp, 17, tk, tv, 5)
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
    # lm_window: the port computes [lo, hi) and zeroes the rest
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tw = tkdec.decode_step_fused(_tcfg(cfg), tp, 17, tk, tv, 5,
                                 lm_window=(32, 160))
    _close(tw[32:160], np.asarray(jl)[32:160])
    assert not tw[:32].any() and not tw[160:].any()


def test_prefill_plain_matches_pallas():
    """A 384-row context with 300 live rows (the wrapper pads): logits of
    row 299 and live cache rows agree."""
    cfg = CHUNK_CFG
    jp, tp = _params(cfg, 2)
    x = (np.random.RandomState(3).randn(384, cfg.n_embd) * 0.02).astype(
        np.float32)
    shape = (cfg.n_layer, cfg.block_size, cfg.n_embd)
    jl, jk, jv = jkpre.prefill_fused(
        cfg, jkpre.prepare_prefill_params(cfg, jp), jnp.asarray(x),
        jnp.zeros(shape), jnp.zeros(shape), jnp.int32(300), interpret=True,
    )
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tl = tkpre.prefill_fused(_tcfg(cfg), tp, torch.from_numpy(x), tk, tv, 300)
    _close(tl, jl)
    _close(tk[:, :300], np.asarray(jk)[:, :300])
    _close(tv[:, :300], np.asarray(jv)[:, :300])


def test_semantic_chunk_plain_matches_pallas():
    """One 8-step chunk at temp 0.7 from a 40-row prefill, stop token 150
    reachable; noise = the JAX kernel's gumbel rows."""
    cfg, K, svs, ctx0 = CHUNK_CFG, 8, 150, 40
    jp, tp = _params(cfg, 4)
    pp = jksem.prepare_semantic_params(cfg, jkdec.prepare_decode_params(cfg, jp))
    kc, vc = _cache(cfg, ctx0, 5)
    logits0 = (np.random.RandomState(6).randn(cfg.n_out_vocab) * 2).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    gum = jksem.make_gumbel_rows(key, K, cfg.n_out_vocab,
                                 jkdec._v_pad(cfg), 0.7)
    jt, jf, jl, jk, jv = jksem.semantic_chunk_fused(
        cfg, pp, jnp.asarray(logits0), jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(ctx0), jnp.int32(0), gum, jnp.float32(1.0), K=K, temp=0.7,
        semantic_vocab_size=svs, interpret=True,
    )
    noise = torch.from_numpy(np.array(gum)[:K, :cfg.n_out_vocab])
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tt, tf, tl = tksem.semantic_chunk_fused(
        _tcfg(cfg), tp, torch.from_numpy(logits0), tk, tv, ctx0, 0, noise,
        1.0, K=K, temp=0.7, semantic_vocab_size=svs,
    )
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tf.tolist() == np.asarray(jf).tolist()
    _close(tl, jl)
    rows = slice(ctx0, ctx0 + K)
    _close(tk[:, rows], np.asarray(jk)[:, rows])
    _close(tv[:, rows], np.asarray(jv)[:, rows])


def test_coarse_window_plain_matches_pallas():
    """One 10-step window at temp 0.7 with odd step parity, codebook
    windows [32, 96) / [96, 160); noise = gumbel(subs[j], (cbs,)), the
    rows the JAX kernel draws from the same keys."""
    cfg, sws, svs, cbs, ctx_len = CHUNK_CFG, 10, 32, 64, 40
    lmw = (svs, svs + 2 * cbs)
    jp, tp = _params(cfg, 7)
    pp = jkwin.prepare_window_params(
        cfg, jkdec.prepare_decode_params(cfg, jp, lm_window=lmw),
        svs=svs, cbs=cbs)
    kc, vc = _cache(cfg, ctx_len, 8)
    logits0 = (np.random.RandomState(9).randn(cfg.n_out_vocab) * 2).astype(
        np.float32)
    subs = jax.random.split(jax.random.PRNGKey(5), sws)
    jt, jk, jv = jkwin.coarse_window_fused(
        cfg, pp, jnp.asarray(logits0), jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(ctx_len), jnp.int32(1), subs, sws=sws, temp=0.7,
        semantic_vocab_size=svs, codebook_size=cbs, lm_window=lmw,
        interpret=True,
    )
    noise = torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (cbs,), jnp.float32))(subs)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tt = tkwin.coarse_window_fused(
        _tcfg(cfg), tp, torch.from_numpy(logits0), tk, tv, ctx_len, 1, noise,
        sws=sws, temp=0.7, semantic_vocab_size=svs, codebook_size=cbs,
        lm_window=lmw,
    )
    assert tt.tolist() == np.asarray(jt).tolist()
    rows = slice(ctx_len, ctx_len + sws)
    _close(tk[:, rows], np.asarray(jk)[:, rows])
    _close(tv[:, rows], np.asarray(jv)[:, rows])


def test_cpu_calls_count_no_launches():
    """On CPU tensors every wrapper runs its plain version and counts no
    kernel launch."""
    cfg = _tcfg(DECODE_CFG)
    _, tp = _params(DECODE_CFG, 0)
    tkernels.reset_launches()
    kc, vc = torch.zeros(2, 64, 128), torch.zeros(2, 64, 128)
    logits = tkpre.prefill_fused(cfg, tp, tp["wte"][0][:8], kc, vc, 8)
    tksem.semantic_chunk_fused(cfg, tp, logits, kc, vc, 8, 0, None, 2.0, K=2,
                               temp=0.0, semantic_vocab_size=150)
    tkwin.coarse_window_fused(cfg, tp, logits, kc, vc, 10, 0, None, sws=2,
                              temp=0.0, semantic_vocab_size=32,
                              codebook_size=64, lm_window=(32, 160))
    tkdec.decode_step_fused(cfg, tp, 3, kc, vc, 12)
    assert tkernels.launch_counts() == {
        "decode": 0, "qdecode": 0, "prefill": 0, "semantic": 0, "window": 0,
        "bdecode": 0, "qbdecode": 0, "bprefill": 0, "bsemantic": 0,
        "bwindow": 0, "kv8": 0}
