"""K3 and K4 as one launch of the step loop (csrc/decode.cu
`decode_steps_kernel`): the CPU mirror of its sampler, on the CPU.

Inside the launch each block samples the logits it computed: its LM rows
of the step plan (dense), or its packed tiles' columns within the LM
window (`decode.sample_slots`); it reduces them to a partial (best value
and index, and for K3 the max and sum of exp of the EOS scale), and after
one grid barrier every block folds all the partials alike
(`decode.fold_partials`). Here, for bark-small's and bark-large's
semantic heads (10048 slots) and both coarse codebook windows inside the
LM window, at 132, 114, 7 and 1 blocks, dense and packed plans: every
slot of a window is sampled by exactly one block, within the logits it
computes; the fold of the
mirror's partials gives `ops.sampling.sample`'s token on seeded logits and
noise, on exact ties across blocks, at temp 0 and on rows with NaN (the
first NaN, as torch.argmax and jnp.argmax), and its EOS mass within 1e-5
(another summation order). The slots K3's chunks decode at (`chunk_loop`,
the clamp at block_size - 1) and K4's (`window_loop`) are the plain
loops', the loop's stamps split as the kernel writes them, and the
wrappers refuse what the step loop does not take before they reach the
kernel library.
"""

import math

import numpy as np
import pytest
import torch

from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.kernels import qdecode
from bark_tpu_torch.kernels import semantic as ksem
from bark_tpu_torch.kernels import window as kwin
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.models.presets import BARK_LARGE, BARK_SMALL
from bark_tpu_torch.ops import sampling

from test_torch_e2e import one_torch_thread  # autouse

BLOCKS = (132, 114, 7, 1)
SVS, CBS = 10000, 1024
LMW = (SVS, SVS + 2 * CBS)
SEM, COARSE = BARK_SMALL["semantic"], BARK_SMALL["coarse"]
LARGE_SEM, LARGE_COARSE = BARK_LARGE["semantic"], BARK_LARGE["coarse"]

# (id, stage, lm_window, the step's LoopSample): bark-small's, then
# bark-large's (width 1024: other LM tiles a block)
SAMPLES = [
    (f"{prefix}{name}", cfg, win, sample)
    for prefix, sem, coarse in (("", SEM, COARSE),
                                ("large-", LARGE_SEM, LARGE_COARSE))
    for name, cfg, win, sample in (
        ("semantic", sem, None, kdec.LoopSample(0.7, stop_token=SVS)),
        ("coarse-even", coarse, LMW,
         kdec.LoopSample(0.7, codebook=(SVS, CBS, 0))),
        ("coarse-odd", coarse, LMW,
         kdec.LoopSample(0.7, codebook=(SVS, CBS, 1))))
]


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("G", BLOCKS)
@pytest.mark.parametrize("name,cfg,win,sample", SAMPLES,
                         ids=[s[0] for s in SAMPLES])
def test_each_slot_of_the_window_is_sampled_once(name, cfg, win, sample, G,
                                                 packed):
    plan = kdec.step_plan(cfg, G, win, packed=packed)
    base, n = sample.window(0, cfg.n_out_vocab)
    slots = kdec.sample_slots(plan, base, n)
    assert len(slots) == G
    seen = np.zeros(cfg.n_out_vocab, dtype=np.int64)
    lo, hi = plan.lm_window
    for (s0, s1), (v0, v1) in zip(slots, plan.lm):
        assert s0 <= s1
        if packed:  # within the block's tiles and the window
            v0, v1 = max(v0 * kdec.PLAN_TILE, lo), min(v1 * kdec.PLAN_TILE, hi)
        assert s0 == s1 or v0 <= s0 and s1 <= v1
        seen[s0:s1] += 1
    assert (seen[base:base + n] == 1).all()
    assert seen.sum() == n


def _row(cfg, seed: int, kind: str):
    """(logits, noise rows) of the stage: seeded, or with exact ties in
    both (the best value at slots far apart, in other blocks), or with NaN
    logits."""
    rng = np.random.default_rng(seed)
    V = cfg.n_out_vocab
    logits = rng.normal(0, 2, V).astype(np.float32)
    noise = rng.gumbel(size=(3, V)).astype(np.float32)
    if kind == "ties":
        noise[:] = 0.0
        logits[:] = np.minimum(logits, 5.0)
        for v in (V - 3, 12000, 11030, 10500, 10100, 9000, 4000, 7):
            if v < V:
                logits[v] = 9.0
    elif kind == "nan":
        logits[[v for v in (3, 9500, 10300, 11000, 11500, 12000)
                if v < V]] = np.nan
    elif kind == "all-nan":
        logits[:] = np.nan
    return torch.from_numpy(logits), torch.from_numpy(noise)


def _plain(logits, sample, j, noise):
    """ops.sampling.sample on step j's window: (token, eos_p)."""
    base, n = sample.window(j, logits.shape[0])
    row = None if sample.temp == 0.0 else noise[sample.noise_row(
        j, noise.shape[0])][:n]
    tok, eos_p = sampling.sample(logits[base:base + n], sample.temp, row)
    return base + int(tok), float(eos_p)


@pytest.mark.parametrize("kind", ["seeded", "ties", "nan", "all-nan"])
@pytest.mark.parametrize("temp", [0.7, 0.0], ids=["temp0.7", "temp0"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("name,cfg,win,sample", SAMPLES,
                         ids=[s[0] for s in SAMPLES])
def test_fold_gives_the_plain_sample(name, cfg, win, sample, packed, temp,
                                     kind):
    logits, noise = _row(cfg, 5, kind)
    sample = kdec.LoopSample(temp, codebook=sample.codebook,
                             stop_token=sample.stop_token, noise_row0=1)
    if sample.codebook is not None:  # K4's noise: the window's width
        noise = noise[:, :CBS].contiguous()
    for G in (132, 7):
        plan = kdec.step_plan(cfg, G, win, packed=packed)
        parts = kdec.sample_partials(plan, logits, sample, 1, noise)
        tok, eos_p = kdec.fold_partials(parts, logits, sample, 1)
        want, want_p = _plain(logits, sample, 1, noise)
        assert tok == want, (G, tok, want)
        if sample.codebook is not None:
            assert eos_p is None
        elif kind in ("nan", "all-nan"):
            assert math.isnan(eos_p) and math.isnan(want_p)
        else:
            assert eos_p == pytest.approx(want_p, rel=1e-5, abs=1e-12)
    if kind == "ties":  # the lowest tied slot of the window wins
        base, n = sample.window(1, cfg.n_out_vocab)
        assert tok == base + int(torch.argmax(logits[base:base + n]))


def test_fold_reads_each_steps_noise_row_and_window():
    """Step j of a loop reads noise row min(noise_row0 + j, rows - 1), and
    the coarse window alternates with the global step's parity."""
    logits, noise = _row(COARSE, 8, "seeded")
    for sample, win in ((kdec.LoopSample(0.7, stop_token=SVS, noise_row0=1),
                         None),
                        (kdec.LoopSample(0.7, codebook=(SVS, CBS, 3)), LMW)):
        plan = kdec.step_plan(COARSE, 132, win)
        for j in range(4):
            parts = kdec.sample_partials(plan, logits, sample, j, noise)
            tok, _ = kdec.fold_partials(parts, logits, sample, j)
            assert tok == _plain(logits, sample, j, noise)[0]
        assert sample.noise_row(3, noise.shape[0]) == min(
            sample.noise_row0 + 3, 2)
    assert [kdec.LoopSample(1.0, codebook=(SVS, CBS, 3)).window(j, 1)[0]
            for j in range(3)] == [SVS + CBS, SVS, SVS + CBS]


@pytest.mark.parametrize("sem,coarse,ctx_len,count0,K", [
    pytest.param(sem, coarse, *case, id=prefix + "-".join(map(str, case)))
    for prefix, sem, coarse in (("", SEM, COARSE),
                                ("large-", LARGE_SEM, LARGE_COARSE))
    for case in ((257, 0, 16), (257, 752, 16), (257, 766, 16), (1023, 0, 4))])
def test_chunk_slots_clamp_as_the_plain_loop(sem, coarse, ctx_len, count0, K):
    """K3's step loop decodes step j at the plain chunk's slot
    min(ctx_len + count0 + j, block_size - 1), the clamp included; K4's at
    ctx_len + j."""
    n_past0, clamp, sample = ksem.chunk_loop(sem, ctx_len, count0, 0.7, SVS,
                                             2.0)
    got = [kdec.loop_n_past(n_past0, clamp, j) for j in range(K)]
    assert got == [min(ctx_len + count0 + j, sem.block_size - 1)
                   for j in range(K)]
    assert sample.noise_row0 == count0 and sample.codebook is None
    assert sample.stop_token == SVS
    n_past0, clamp, sample = kwin.window_loop(coarse, 887, 5, 0.7, SVS, CBS)
    assert [kdec.loop_n_past(n_past0, clamp, j) for j in range(60)] == [
        887 + j for j in range(60)]
    assert sample.codebook == (SVS, CBS, 5) and sample.noise_row0 == 0


def test_loop_stamps_split_a_launch():
    """`loop_phases_us` splits a row of the kernel's loop stamps: the
    start, per step its token, its LM head's start and end, the end."""
    plan = kdec.step_plan(SEM, 3, None)
    n = 4
    stamps = kdec.loop_stamps(plan, n, "cpu")
    for b in range(3):
        t, row = 1000 * b, [1000 * b]
        t += 500  # the opening sample
        row.append(t)
        for j in range(n):
            row += [t + 300, t + 340]  # layers 300 ns, LM head 40
            t += 340 + (20 if j + 1 < n else 0)  # the sample's fold 20
            row.append(t)
        stamps[b] = torch.tensor(row[:1 + 3 * n] + [t + 1], dtype=torch.int64)
    us = kdec.loop_phases_us(plan, stamps, n)
    assert us["block0"]["opening_sample"] == pytest.approx(0.5)
    assert us["block0"]["layers"] == pytest.approx(0.3)
    assert us["block0"]["lm_head"] == pytest.approx(0.04)
    assert us["block0"]["sample_fold"] == pytest.approx(0.02)
    assert us["block0"]["step"] == pytest.approx(0.36)
    assert us["launch_us"] == pytest.approx((2000 + 500 + 4 * 340 + 60 + 1)
                                            / 1e3)


# ------------------------------------------------------------ refusals

SMALL = GPTConfig(n_layer=2, n_head=2, n_embd=128, block_size=512,
                  n_in_vocab=300, n_out_vocab=200, bias=True)


@pytest.fixture
def no_launch(monkeypatch):
    """Fail the test if a wrapper reaches the kernel library."""

    def refuse():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(_build, "lib", refuse)
    def counts():
        return (kdec.launches, kdec.loop_launches, qdecode.launches,
                qdecode.loop_launches, ksem.launches, kwin.launches)

    before = counts()
    yield
    assert counts() == before


def _meta():
    params = gpt.init_params(SMALL, torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    params = {k: ({kk: vv.to("meta") for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to("meta"))
              for k, v in params.items()}
    kc, vc = gpt.init_kv_cache(SMALL, torch.float32, "meta")
    logits = torch.zeros(SMALL.n_out_vocab, device="meta")
    return params, kc, vc, logits


@pytest.mark.parametrize("fault,match", [
    ("no-step", "step"), ("window-outside", "sample window"),
    ("full-vocab-windowed", "sample window"), ("clamp", "n_past|clamp"),
    ("slots", "n_past")])
def test_step_loop_refuses_before_any_launch(no_launch, fault, match):
    params, kc, vc, logits = _meta()
    toks = torch.zeros(8, dtype=torch.int32, device="meta")
    args = dict(n_past0=40, clamp=SMALL.block_size - 1, n_steps=8,
                sample=kdec.LoopSample(0.0, stop_token=150), noise=None,
                tok_out=toks, flag_out=toks, lm_window=None)
    if fault == "no-step":
        args["n_steps"] = 0
    elif fault == "window-outside":
        args.update(sample=kdec.LoopSample(0.0, codebook=(32, 64, 0)),
                    lm_window=(32, 100))
    elif fault == "full-vocab-windowed":
        args["lm_window"] = (0, 100)
    elif fault == "clamp":
        args["clamp"] = SMALL.block_size
    else:
        args["n_past0"] = SMALL.block_size - 4
        args["clamp"] = 10 ** 6
    with pytest.raises(ValueError, match=match):
        kdec.decode_steps_fused(SMALL, params, logits, kc, vc, **args)


def test_chunk_and_window_wrappers_refuse_before_any_launch(no_launch):
    params, kc, vc, logits = _meta()
    with pytest.raises(ValueError, match="noise"):  # rows of another width
        ksem.semantic_chunk_fused(
            SMALL, params, logits, kc, vc, 40, 0,
            torch.zeros((4, 100), device="meta"), 2.0, K=4, temp=0.7,
            semantic_vocab_size=150)
    with pytest.raises(ValueError, match="window"):  # past the vocab
        kwin.coarse_window_fused(
            SMALL, params, logits, kc, vc, 40, 0, None, sws=4, temp=0.0,
            semantic_vocab_size=150, codebook_size=64, lm_window=(150, 200))
