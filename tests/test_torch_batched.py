"""The plain PyTorch versions of the batched kernels K7-K10 (the CPU side
of every batched wrapper in bark_tpu_torch.kernels) against the JAX
package on the CPU, f32, with the same numpy-seeded params, caches and
noise:

- K7 against `jax.vmap(gpt.decode_step)` with per-lane n_past, and K8
  against the vmapped `gpt.prefill` with per-lane n_valid, which is what
  the JAX package's batched programs run off the TPU (logits and cache
  rows within 1e-5: f32 on both sides, another summation order);
- K9 and K10 through the port's batched semantic and coarse stage
  programs against the JAX package's (`make_semantic_program_batched`,
  `make_coarse_stage_program_batched`), whose vmapped stepped loops its
  own tests hold token-equal to its Pallas K9/K10: tokens and counts must
  be equal, with lanes that stop at different steps and lanes of
  different lengths.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.models import gpt as jgpt
from bark_tpu.pipeline import coarse as jcoarse
from bark_tpu.pipeline import semantic as jsem
from bark_tpu_torch import kernels as tkernels
from bark_tpu_torch import params as tparams
from bark_tpu_torch.kernels import bdecode as tkbdec
from bark_tpu_torch.kernels import bprefill as tkbpre
from bark_tpu_torch.kernels import bsemantic as tkbsem
from bark_tpu_torch.kernels import bwindow as tkbwin
from bark_tpu_torch.models import gpt as tgpt
from bark_tpu_torch.pipeline import coarse as tcoarse
from bark_tpu_torch.pipeline import semantic as tsem

from test_torch_e2e import gumbel_from_key, one_torch_thread
from test_torch_kernels_plain import CHUNK_CFG, DECODE_CFG, _params, _tcfg
from tiny_model import tiny_params

ATOL = 1e-5
B = 3


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


def _batched_cache(cfg, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layer, B, cfg.block_size, cfg.n_embd)
    return ((rng.randn(*shape) * 0.5).astype(np.float32),
            (rng.randn(*shape) * 0.5).astype(np.float32))


def _vmapped(fn, cfg):
    return jax.vmap(functools.partial(fn, cfg), in_axes=(None, 0, 1, 1, 0),
                    out_axes=(0, 1, 1))


@pytest.mark.parametrize("win", [None, (32, 160)], ids=["head", "window"])
def test_decode_batched_plain_matches_vmapped_jax(win):
    """Three lanes at n_past 0, 5 and 63 (the last slot)."""
    cfg, toks, n_past = DECODE_CFG, [17, 3, 250], [0, 5, 63]
    jp, tp = _params(cfg, 20)
    kc, vc = _batched_cache(cfg, 21)
    jl, jk, jv = _vmapped(jgpt.decode_step, cfg)(
        jp, jnp.asarray(toks), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(n_past))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tl = tkbdec.decode_step_fused_batched(_tcfg(cfg), tp, toks, tk, tv,
                                          n_past, lm_window=win)
    lo, hi = win or (0, cfg.n_out_vocab)
    _close(tl[:, lo:hi], np.asarray(jl)[:, lo:hi])
    assert not tl[:, :lo].any() and not tl[:, hi:].any()
    _close(tk, jk)
    _close(tv, jv)


def test_prefill_batched_plain_matches_vmapped_jax():
    """Three lanes of a 64-row context with 40, 1 and 64 live rows: each
    lane's logits of its last live row and its live cache rows agree; rows
    past n_valid are not written."""
    cfg, n_valid = CHUNK_CFG, [40, 1, 64]
    jp, tp = _params(cfg, 22)
    x = (np.random.RandomState(23).randn(B, 64, cfg.n_embd) * 0.02).astype(
        np.float32)
    shape = (cfg.n_layer, B, cfg.block_size, cfg.n_embd)
    jl, jk, jv = _vmapped(jgpt.prefill, cfg)(
        jp, jnp.asarray(x), jnp.zeros(shape), jnp.zeros(shape),
        jnp.asarray(n_valid))
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tl = tkbpre.prefill_fused_batched(_tcfg(cfg), tp, torch.from_numpy(x),
                                      tk, tv, n_valid)
    _close(tl, jl)
    for b, n in enumerate(n_valid):
        _close(tk[:, b, :n], np.asarray(jk)[:, b, :n])
        _close(tv[:, b, :n], np.asarray(jv)[:, b, :n])
        assert not tk[:, b, n:].any()


def test_prefill_row_tables():
    """The row tables the CUDA K8 reads: lanes of 20 and 3 live rows in a
    (2, 32, D) x_emb and (2, 64, D) cache slabs."""
    tables, M, n_tiles = tkbpre.row_tables([20, 3], T=32, S=64)
    assert (M, n_tiles) == (23, 3)
    src, pos, slot = tables[:M], tables[M:2 * M], tables[2 * M:3 * M]
    assert pos.tolist() == list(range(20)) + [0, 1, 2]
    assert src.tolist() == list(range(20)) + [32, 33, 34]
    assert slot.tolist() == list(range(20)) + [64, 65, 66]
    tiles = tables[3 * M:3 * M + 3 * n_tiles].reshape(-1, 3)
    assert tiles.tolist() == [[0, 0, 0], [0, 16, 0], [1, 0, 20]]
    assert tables[3 * M + 3 * n_tiles:].tolist() == [20, 3, 19, 22]


def _stage_noise(stage, keys, shapes):
    return [gumbel_from_key(stage, k, s) for k, s in zip(keys, shapes)]


# semantic: 200 output tokens, the stop token 150 and an EOS threshold of
# 0.009 (the uniform mass is 0.005): at temp 0.7 the three lanes stop after
# 33 steps, at max_steps (40) and after 4 steps
SEM_CFG = dataclasses.replace(CHUNK_CFG, block_size=320)
SEM_MAX_STEPS, SEM_SVS = 40, 150


@pytest.mark.parametrize("temp,min_eos_p", [(0.7, 0.009), (0.0, 2.0)])
def test_semantic_program_batched_matches_jax(temp, min_eos_p):
    """K9 (in its plain version) under the port's batched semantic stage:
    tokens and counts equal to the JAX package's batched program for the
    same per-lane keys."""
    cfg = SEM_CFG
    jp, tp = _params(cfg, 24)
    tokens = np.random.RandomState(25).randint(
        0, cfg.n_in_vocab, (B, 513)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(26), B)
    jout, jcount = jsem.make_semantic_program_batched(
        cfg, batch=B, temp=temp, max_steps=SEM_MAX_STEPS,
        semantic_vocab_size=SEM_SVS,
    )(jp, jnp.asarray(tokens), keys, jnp.float32(min_eos_p))
    noise = None if temp == 0.0 else torch.stack(_stage_noise(
        "semantic", keys, [(SEM_MAX_STEPS, cfg.n_out_vocab)] * B))
    tout, tcounts = tsem.make_semantic_program_batched(
        _tcfg(cfg), temp=temp, max_steps=SEM_MAX_STEPS,
        semantic_vocab_size=SEM_SVS,
    )(tp, torch.from_numpy(tokens), noise, min_eos_p)
    assert tcounts == np.asarray(jcount).tolist()
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    if min_eos_p < 1.0:  # the case this test is for
        assert tcounts == [33, 40, 4]


def _coarse_params(**kw):
    """bark_tpu's and the port's BarkContextParams for the tiny token
    space, 10-step windows."""
    jpar = tiny_params(sliding_window_size=10, **kw)
    fields = {f.name: getattr(jpar, f.name)
              for f in dataclasses.fields(jpar) if f.name != "progress_callback"}
    return jpar, tparams.BarkContextParams(**fields)


COARSE_CFG = dataclasses.replace(CHUNK_CFG, block_size=384, n_in_vocab=34,
                                 n_out_vocab=32)


@pytest.mark.parametrize("temp", [0.7, 0.0])
def test_coarse_program_batched_matches_jax(temp):
    """K8 and K10 (plain) under the port's batched coarse stage: lanes of
    12, 5 and 9 semantic tokens run 4, 2 and 3 shared windows; each lane's
    codes and n_steps equal the JAX package's batched program's for the
    same per-lane keys."""
    cfg, n_sem = COARSE_CFG, [12, 5, 9]
    jpar, tpar = _coarse_params(temp=temp)
    jp, tp = _params(cfg, 27)
    rng = np.random.RandomState(28)
    sems = [rng.randint(0, jpar.semantic_vocab_size, n).astype(np.int32)
            for n in n_sem]
    sem_buf = np.zeros((B, max(n_sem)), np.int32)
    for b, s in enumerate(sems):
        sem_buf[b, :len(s)] = s
    keys = jax.random.split(jax.random.PRNGKey(29), B)
    hist_cap = jpar.max_coarse_history
    num, den = jcoarse.stc_fraction(jpar)
    max_sem_hist = max(1, hist_cap * den // num)
    zeros = jnp.zeros((B,), jnp.int32)
    jcodes, jsteps = jcoarse.make_coarse_stage_program_batched(
        cfg, jpar, batch=B, ctx_size=384, max_semantic=max(n_sem),
    )(jp, jnp.asarray(sem_buf), jnp.asarray(n_sem), keys,
      jnp.zeros((B, max_sem_hist), jnp.int32), zeros,
      jnp.zeros((B, hist_cap), jnp.int32), zeros)
    steps = [tcoarse.coarse_schedule(n, tpar) for n in n_sem]
    assert [s[3] for s in steps] == [4, 2, 3]
    noises = None if temp == 0.0 else _stage_noise(
        "coarse", keys, [(s[3], 10, jpar.codebook_size) for s in steps])
    tcodes, tsteps = tcoarse.make_coarse_stage_program_batched(
        _tcfg(cfg), tpar, ctx_size=384,
    )(tp, [torch.from_numpy(s) for s in sems], noises)
    assert tsteps == np.asarray(jsteps).tolist()
    for b in range(B):
        n = tsteps[b] // 2
        np.testing.assert_array_equal(tcodes[b].numpy(),
                                      np.asarray(jcodes)[b, :n])


def test_batched_cpu_calls_count_no_launches():
    """On CPU tensors every batched wrapper runs its plain version, counts
    no kernel launch, and K9/K10 are their single-lane plain versions lane
    by lane."""
    cfg = _tcfg(DECODE_CFG)
    _, tp = _params(DECODE_CFG, 0)
    tkernels.reset_launches()
    kc, vc = tgpt.init_kv_cache(cfg, torch.float32, "cpu", batch=2)
    x = tp["wte"][0][:16].reshape(2, 8, -1)
    logits = tkbpre.prefill_fused_batched(cfg, tp, x, kc, vc, [8, 5])
    assert logits.shape == (2, cfg.n_out_vocab)
    toks, flags, _ = tkbsem.semantic_chunk_fused_batched(
        cfg, tp, logits, kc, vc, 8, 0, None, 2.0, K=2, temp=0.0,
        semantic_vocab_size=150)
    assert toks.shape == flags.shape == (2, 2)
    toks = tkbwin.coarse_window_fused_batched(
        cfg, tp, logits, kc, vc, [10, 12], 0, None, sws=2, temp=0.0,
        semantic_vocab_size=32, codebook_size=64, lm_window=(32, 160))
    assert toks.shape == (2, 2)
    tkbdec.decode_step_fused_batched(cfg, tp, [3, 4], kc, vc, [12, 20])
    assert set(tkernels.launch_counts().values()) == {0}
