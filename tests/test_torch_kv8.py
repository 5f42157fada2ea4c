"""The int8 KV cache (K6's plain versions: `models.gpt` on the `{"q", "s"}`
caches of `init_kv_cache(quant=True)`) against the JAX package on the CPU,
f32, with the same numpy-seeded params, caches and noise:

- `quantize_kv_rows` bit-equal to bark_tpu's, zero rows and values that
  land exactly on k + 0.5 included;
- `decode_step` and `prefill` against `bark_tpu.models.gpt`'s on int8
  caches (the XLA path its own tests hold its Pallas int8 kernels to), one
  lane and B = 3 lanes against `jax.vmap`: scales within rtol 1e-6, the
  int8 bytes equal but for one-step flips at no more than 0.01% of the
  values (the two sides compute the fresh rows in another summation
  order), logits within 3e-3 (bark_tpu's own kernel-vs-XLA bound for this
  cache, tests/test_kv_quant.py) and argmax equal;
- the semantic and coarse stage programs with kv_quant, single and
  batched, against bark_tpu's: tokens equal at temp 0 and 0.7 (the port
  fed the Gumbel noise bark_tpu draws from the same keys).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.models import gpt as jgpt
from bark_tpu.pipeline import coarse as jcoarse
from bark_tpu.pipeline import semantic as jsem
from bark_tpu_torch import kernels as tkernels
from bark_tpu_torch.kernels import bdecode as tkbdec
from bark_tpu_torch.kernels import bprefill as tkbpre
from bark_tpu_torch.kernels import decode as tkdec
from bark_tpu_torch.kernels import kv8 as tkv8
from bark_tpu_torch.kernels import prefill as tkpre
from bark_tpu_torch.models import gpt as tgpt
from bark_tpu_torch.pipeline import coarse as tcoarse
from bark_tpu_torch.pipeline import semantic as tsem

from test_torch_batched import (COARSE_CFG, SEM_CFG, SEM_MAX_STEPS, SEM_SVS,
                                _coarse_params, _stage_noise)
from test_torch_e2e import gumbel_from_key, one_torch_thread
from test_torch_kernels_plain import CHUNK_CFG, DECODE_CFG, _params, _tcfg

LOGITS_ATOL = 3e-3
B = 3


def assert_kv8_close(t, j):
    """A port int8 cache `t` against bark_tpu's `j` (any matching shape):
    scales within rtol 1e-6; bytes equal but for one-step flips at no more
    than 0.01% of the values (at least one allowed); returns the flips."""
    tq, jq = t["q"].numpy().astype(np.int32), np.asarray(j["q"], np.int32)
    np.testing.assert_allclose(t["s"].numpy(), np.asarray(j["s"]), rtol=1e-6,
                               atol=0)
    diff = np.abs(tq - jq)
    flips = int((diff > 0).sum())
    assert diff.max() <= 1
    assert flips <= max(1, math.ceil(1e-4 * diff.size)), flips
    return flips


def _logits_close(t, j):
    t, j = t.numpy(), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=0, atol=LOGITS_ATOL)
    assert (t.argmax(-1) == j.argmax(-1)).all()


def _kv8_cache(cfg, rows, seed, batch=None):
    """int8 caches (numpy, for both sides) whose rows [0, rows) of every
    lane hold random rows quantized by bark_tpu's quantize_kv_rows."""
    rng = np.random.RandomState(seed)
    lead = (cfg.n_layer,) + (() if batch is None else (batch,))
    out = []
    for _ in range(2):
        q = np.zeros(lead + (cfg.block_size, cfg.n_embd), np.int8)
        s = np.zeros(lead + (cfg.block_size,), np.float32)
        x = (rng.randn(*lead, rows, cfg.n_embd) * 0.5).astype(np.float32)
        jq, js = jgpt.quantize_kv_rows(jnp.asarray(x.reshape(-1, cfg.n_embd)))
        q[..., :rows, :] = np.asarray(jq).reshape(x.shape)
        s[..., :rows] = np.asarray(js).reshape(x.shape[:-1])
        out.append({"q": q, "s": s})
    return out


def _jax(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def _torch(c):
    return {k: torch.from_numpy(v.copy()) for k, v in c.items()}


def _half_rows():
    """Rows whose x * inv lands exactly on k + 0.5: amax 127 (scale 1,
    inverse 1) and amax 63.5 (scale 0.5, inverse 2), both exact in f32 and
    bf16, and a zero row."""
    a = np.zeros((3, 64), np.float32)
    a[0, :8] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
    a[1, :8] = [63.5, 1.25, -1.75, 0.25, -0.25, 0.75, 63.25, -62.75]
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_bit_equal(dtype):
    rng = np.random.RandomState(0)
    x = np.concatenate([_half_rows(), rng.randn(13, 64).astype(np.float32),
                        rng.randn(4, 64).astype(np.float32) * 1e-30])
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jq, js = jgpt.quantize_kv_rows(jx)
    tq, ts = tgpt.quantize_kv_rows(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]
    assert tq[1, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]
    assert not tq[2].any() and ts[2] == 0


@pytest.mark.parametrize("win", [None, (32, 160)], ids=["head", "window"])
def test_decode_int8_matches_jax(win):
    cfg = DECODE_CFG
    jp, tp = _params(cfg, 30)
    kc, vc = _kv8_cache(cfg, 5, 31)
    jl, jk, jv = jgpt.decode_step(cfg, jp, jnp.int32(17), _jax(kc), _jax(vc),
                                  jnp.int32(5))
    tk, tv = _torch(kc), _torch(vc)
    tl = tkdec.decode_step_fused(_tcfg(cfg), tp, 17, tk, tv, 5,
                                 lm_window=win)
    lo, hi = win or (0, cfg.n_out_vocab)
    _logits_close(tl[lo:hi], np.asarray(jl)[lo:hi])
    assert not tl[:lo].any() and not tl[hi:].any()
    assert_kv8_close(tk, jk)
    assert_kv8_close(tv, jv)
    assert tk["s"][:, 5].all()  # the fresh row got its scales


@pytest.mark.parametrize("T,n_valid", [(257, 257), (300, 211)])
def test_prefill_int8_matches_jax(T, n_valid):
    """bark_tpu's prefill of T rows (its pad rows included) against the
    port's of the n_valid live rows: logits of row n_valid-1 and the live
    cache rows."""
    cfg = CHUNK_CFG
    jp, tp = _params(cfg, 32)
    x = (np.random.RandomState(33).randn(T, cfg.n_embd) * 0.02).astype(
        np.float32)
    jk, jv = jgpt.init_kv_cache(cfg, quant=True)
    jl, jk, jv = jgpt.prefill(cfg, jp, jnp.asarray(x), jk, jv,
                              jnp.int32(n_valid))
    tk, tv = tgpt.init_kv_cache(_tcfg(cfg), torch.float32, "cpu", quant=True)
    tl = tkpre.prefill_fused(_tcfg(cfg), tp, torch.from_numpy(x), tk, tv,
                             n_valid)
    _logits_close(tl, jl)
    for t, j in ((tk, jk), (tv, jv)):
        assert_kv8_close({k: v[:, :n_valid] for k, v in t.items()},
                         {k: v[:, :n_valid] for k, v in j.items()})
        assert not t["q"][:, n_valid:].any()
        assert not t["s"][:, n_valid:].any()


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "dense"])
def test_attn_decode_matches_jax(quant):
    """K6a's direct entry (`kv8.attn_decode`, its plain version on the
    CPU) on the same qkv rows as bark_tpu's `_kv_update` then
    `_attention_int8` (or `_attention` on a dense cache), lane by lane at
    n_past [5, 63, 0]: the written rows bit-equal, the context within
    1e-6."""
    cfg, n_past = DECODE_CFG, [5, 63, 0]
    D, S = cfg.n_embd, cfg.block_size
    rng = np.random.RandomState(38)
    qkv = (rng.randn(B, 3 * D) * 0.5).astype(np.float32)
    qkv[0, D:2 * D] = 0.0  # a zero K row: scale 0
    if quant:
        kc, vc = (jax.tree.map(lambda a: a[0], c)
                  for c in _kv8_cache(cfg, S, 39, batch=B))
    else:
        kc, vc = ((rng.randn(B, S, D) * 0.5).astype(np.float32)
                  for _ in range(2))
    conv = (lambda c: _torch(c)) if quant else torch.from_numpy
    tk, tv = conv(kc), conv(vc)
    ctx = tkv8.attn_decode(_tcfg(cfg), torch.from_numpy(qkv), tk, tv, n_past)
    for b, n in enumerate(n_past):
        lane = (lambda c: jax.tree.map(lambda a: jnp.asarray(a[b]), c))
        row = jnp.asarray(qkv[b:b + 1])
        jk = jgpt._kv_update(lane(kc), row[:, D:2 * D], jnp.int32(n))
        jv = jgpt._kv_update(lane(vc), row[:, 2 * D:], jnp.int32(n))
        mask = (jnp.arange(S) <= n)[None]
        if quant:
            want = jgpt._attention_int8(cfg, row[:, :D], jk, jv, mask)
        else:
            want = jgpt._attention(row[:, :D], jk, jv, mask, cfg)
        np.testing.assert_allclose(ctx[b:b + 1].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)
        for t, j in ((tk, jk), (tv, jv)):
            got = jax.tree.map(lambda a: np.asarray(a[b]),
                               {k: v.numpy() for k, v in t.items()}
                               if quant else t.numpy())
            jax.tree.map(np.testing.assert_array_equal, got,
                         jax.tree.map(np.asarray, j))


def _vmapped(fn, cfg):
    return jax.vmap(functools.partial(fn, cfg), in_axes=(None, 0, 1, 1, 0),
                    out_axes=(0, 1, 1))


def test_decode_batched_int8_matches_vmapped_jax():
    """B = 3 lanes at n_past [5, 6, 5], as tests/test_kv_quant.py does."""
    cfg, toks, n_past = DECODE_CFG, [17, 23, 5], [5, 6, 5]
    jp, tp = _params(cfg, 34)
    kc, vc = _kv8_cache(cfg, 6, 35, batch=B)
    jl, jk, jv = _vmapped(jgpt.decode_step, cfg)(
        jp, jnp.asarray(toks), _jax(kc), _jax(vc), jnp.asarray(n_past))
    tk, tv = _torch(kc), _torch(vc)
    tl = tkbdec.decode_step_fused_batched(_tcfg(cfg), tp, toks, tk, tv,
                                          n_past)
    _logits_close(tl, jl)
    assert_kv8_close(tk, jk)
    assert_kv8_close(tv, jv)


def test_prefill_batched_int8_matches_vmapped_jax():
    cfg, n_valid = CHUNK_CFG, [40, 1, 64]
    jp, tp = _params(cfg, 36)
    x = (np.random.RandomState(37).randn(B, 64, cfg.n_embd) * 0.02).astype(
        np.float32)
    jk, jv = jgpt.init_kv_cache(cfg, batch=B, quant=True)
    jl, jk, jv = _vmapped(jgpt.prefill, cfg)(
        jp, jnp.asarray(x), jk, jv, jnp.asarray(n_valid))
    tk, tv = tgpt.init_kv_cache(_tcfg(cfg), torch.float32, "cpu", batch=B,
                                quant=True)
    tl = tkbpre.prefill_fused_batched(_tcfg(cfg), tp, torch.from_numpy(x),
                                      tk, tv, n_valid)
    _logits_close(tl, jl)
    for b, n in enumerate(n_valid):
        for t, j in ((tk, jk), (tv, jv)):
            assert_kv8_close({k: v[:, b, :n] for k, v in t.items()},
                             {k: v[:, b, :n] for k, v in j.items()})
            assert not t["q"][:, b, n:].any()


# ------------------------------------------------------ the stage programs


@pytest.mark.parametrize("temp,min_eos_p", [(0.7, 0.009), (0.0, 2.0)])
def test_semantic_program_int8_matches_jax(temp, min_eos_p):
    """One lane, then the same prompts as a batch of 3: tokens and counts
    equal to bark_tpu's programs with kv_quant for the same keys."""
    cfg = SEM_CFG
    jp, tp = _params(cfg, 24)
    tokens = np.random.RandomState(25).randint(
        0, cfg.n_in_vocab, (B, 513)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(26), B)
    kw = dict(temp=temp, max_steps=SEM_MAX_STEPS, semantic_vocab_size=SEM_SVS,
              kv_quant=True)
    shape = (SEM_MAX_STEPS, cfg.n_out_vocab)
    jout, jcount = jsem.make_semantic_program(cfg, **kw)(
        jp, jnp.asarray(tokens[0]), keys[0], jnp.float32(min_eos_p))
    tout, tcount = tsem.make_semantic_program(_tcfg(cfg), **kw)(
        tp, torch.from_numpy(tokens[0]),
        None if temp == 0.0 else gumbel_from_key("semantic", keys[0], shape),
        min_eos_p)
    assert tcount == int(jcount) > 0
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))

    jout, jcount = jsem.make_semantic_program_batched(cfg, batch=B, **kw)(
        jp, jnp.asarray(tokens), keys, jnp.float32(min_eos_p))
    noise = None if temp == 0.0 else torch.stack(
        _stage_noise("semantic", keys, [shape] * B))
    tout, tcounts = tsem.make_semantic_program_batched(_tcfg(cfg), **kw)(
        tp, torch.from_numpy(tokens), noise, min_eos_p)
    assert tcounts == np.asarray(jcount).tolist()
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("temp", [0.7, 0.0])
def test_coarse_program_int8_matches_jax(temp):
    """Lanes of 12, 5 and 9 semantic tokens (4, 2 and 3 windows of 10
    steps): lane 0 alone, then all three as a batch; codes and n_steps
    equal to bark_tpu's programs with kv_quant for the same keys."""
    cfg, n_sem = COARSE_CFG, [12, 5, 9]
    jpar, tpar = _coarse_params(temp=temp)
    jp, tp = _params(cfg, 27)
    rng = np.random.RandomState(28)
    sems = [rng.randint(0, jpar.semantic_vocab_size, n).astype(np.int32)
            for n in n_sem]
    keys = jax.random.split(jax.random.PRNGKey(29), B)
    hist_cap = jpar.max_coarse_history
    num, den = jcoarse.stc_fraction(jpar)
    max_sem_hist = max(1, hist_cap * den // num)
    steps = [tcoarse.coarse_schedule(n, tpar) for n in n_sem]
    noises = None if temp == 0.0 else _stage_noise(
        "coarse", keys, [(s[3], 10, jpar.codebook_size) for s in steps])

    jcodes, jsteps = jcoarse.make_coarse_stage_program(
        cfg, jpar, ctx_size=384, max_semantic=n_sem[0], kv_quant=True,
    )(jp, jnp.asarray(sems[0]), jnp.int32(n_sem[0]), keys[0],
      jnp.zeros((max_sem_hist,), jnp.int32), jnp.int32(0),
      jnp.zeros((hist_cap,), jnp.int32), jnp.int32(0))
    tcodes, tsteps = tcoarse.make_coarse_stage_program(
        _tcfg(cfg), tpar, ctx_size=384, kv_quant=True,
    )(tp, torch.from_numpy(sems[0]), None if noises is None else noises[0])
    assert tsteps == int(jsteps) == 36
    np.testing.assert_array_equal(tcodes.numpy(),
                                  np.asarray(jcodes)[:tsteps // 2])

    sem_buf = np.zeros((B, max(n_sem)), np.int32)
    for b, s in enumerate(sems):
        sem_buf[b, :len(s)] = s
    zeros = jnp.zeros((B,), jnp.int32)
    jcodes, jsteps = jcoarse.make_coarse_stage_program_batched(
        cfg, jpar, batch=B, ctx_size=384, max_semantic=max(n_sem),
        kv_quant=True,
    )(jp, jnp.asarray(sem_buf), jnp.asarray(n_sem), keys,
      jnp.zeros((B, max_sem_hist), jnp.int32), zeros,
      jnp.zeros((B, hist_cap), jnp.int32), zeros)
    tcodes, tsteps = tcoarse.make_coarse_stage_program_batched(
        _tcfg(cfg), tpar, ctx_size=384, kv_quant=True,
    )(tp, [torch.from_numpy(s) for s in sems], noises)
    assert tsteps == np.asarray(jsteps).tolist()
    for b in range(B):
        np.testing.assert_array_equal(tcodes[b].numpy(),
                                      np.asarray(jcodes)[b, :tsteps[b] // 2])


def test_int8_cpu_calls_count_no_launches():
    """On CPU int8 caches every wrapper runs its plain version and counts
    no launch, K6's included."""
    cfg = _tcfg(DECODE_CFG)
    _, tp = _params(DECODE_CFG, 0)
    tkernels.reset_launches()
    kc, vc = tgpt.init_kv_cache(cfg, torch.float32, "cpu", quant=True)
    logits = tkpre.prefill_fused(cfg, tp, tp["wte"][0][:8], kc, vc, 8)
    tkdec.decode_step_fused(cfg, tp, int(logits.argmax()), kc, vc, 8)
    kc, vc = tgpt.init_kv_cache(cfg, torch.float32, "cpu", batch=2,
                                quant=True)
    x = tp["wte"][0][:16].reshape(2, 8, -1)
    logits = tkbpre.prefill_fused_batched(cfg, tp, x, kc, vc, [8, 5])
    tkbdec.decode_step_fused_batched(cfg, tp, [3, 4], kc, vc, [8, 5])
    assert kc["s"][:, 0, 8].all() and kc["s"][:, 1, 5].all()
    assert set(tkernels.launch_counts().values()) == {0}
