"""K9 and K10 as one launch of the batched step loop (csrc/bloop.cuh
`lane_steps_kernel`): the CPU mirror of its sampler, on the CPU.

Inside the launch the sample's partials are keyed by LM tile: the block
that folds a tile of the LM head reduces each lane's columns of it within
the step's window to a partial (`decode.lane_sample_slots`,
`decode.lane_sample_partials`: best value and index, and for K9 the max
and sum of exp of the EOS scale), and after one grid barrier each block
folds the partials of the lanes it embeds in tile order
(`decode.lane_fold_partials`). Here, for bark-small's semantic head (10048
slots) and both coarse codebook windows inside the LM window, at 1, 3, 8
and 32 lanes and 132, 114, 7 and 1 blocks, dense and packed lane plans:
every slot of a window is sampled exactly once, by the tile that holds it;
the mirror's fold gives `ops.sampling.sample`'s token for each lane on
seeded logits and noise, on exact ties across tiles, at temp 0 and on rows
with NaN, and its EOS mass within 1e-5 (another summation order). K9's
slots are shared and clamp at block_size - 1, K10's are per lane
(`bsemantic.chunk_lane_loop`, `bwindow.window_lane_loop`). The mirror loop
(the plain batched step, `bdecode.decode_step_batched_plain`, with the
tile-keyed sampler) gives the tokens and flags of bark_tpu's
`semantic_chunk_fused_batched` and `coarse_window_fused_batched` in
interpret mode, bark_tpu's Gumbel rows replayed, at 3 lanes: K9 on a
q5_1 qpack, K10 on a dense f32 model at odd parity and uneven context
lengths (one layer each: an interpret-mode call takes ~4 s a layer on the
CPU, so one call of each). The loop's stamps split as the kernel writes
them, and the wrappers refuse what the loop does not take before they
reach the kernel library.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.kernels import decode as jkdec
from bark_tpu.kernels import semantic as jksem
from bark_tpu.kernels import window as jkwin
from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import bdecode as kbdec
from bark_tpu_torch.kernels import bsemantic as kbsem
from bark_tpu_torch.kernels import bwindow as kbwin
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.kernels import qbdecode
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.models.presets import BARK_SMALL
from bark_tpu_torch.ops import sampling

from test_torch_e2e import one_torch_thread  # autouse
from test_torch_kernels_plain import DECODE_CFG, _params, _tcfg

BLOCKS = (132, 114, 7, 1)
LANES = (1, 3, 8, 32)
SVS, CBS = 10000, 1024
LMW = (SVS, SVS + 2 * CBS)
SEM, COARSE = BARK_SMALL["semantic"], BARK_SMALL["coarse"]
LM = kdec.LANE_PHASES.index("lm")

# (id, stage, lm_window, the step's LoopSample)
SAMPLES = [
    ("semantic", SEM, None, kdec.LoopSample(0.7, stop_token=SVS)),
    ("coarse-even", COARSE, LMW, kdec.LoopSample(0.7, codebook=(SVS, CBS, 0))),
    ("coarse-odd", COARSE, LMW, kdec.LoopSample(0.7, codebook=(SVS, CBS, 1))),
]


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("G", BLOCKS)
@pytest.mark.parametrize("name,cfg,win,sample", SAMPLES,
                         ids=[s[0] for s in SAMPLES])
def test_each_slot_of_the_window_is_sampled_once(name, cfg, win, sample, G,
                                                 B, packed):
    plan = kdec.lane_plan(cfg, G, B, win, packed=packed)
    base, n = sample.window(0, cfg.n_out_vocab)
    slots = kdec.lane_sample_slots(plan, base, n)
    t0 = plan.tile0[LM]
    assert len(slots) == len(plan.folds[LM])
    seen = np.zeros(cfg.n_out_vocab, dtype=np.int64)
    for t, (s0, s1) in enumerate(slots, start=t0):
        assert s0 <= s1
        # within the tile's columns (the plan's LM head covers lm_window)
        assert s0 == s1 or (t * kdec.PLAN_TILE <= s0
                            and s1 <= (t + 1) * kdec.PLAN_TILE)
        seen[s0:s1] += 1
    lo, hi = plan.lm_window
    assert lo <= base and base + n <= hi
    assert (seen[base:base + n] == 1).all()
    assert seen.sum() == n


def _rows(cfg, B: int, seed: int, kind: str, width: int):
    """(B, V) logits and (B, width) noise rows: seeded lanes, with lane 0
    of kind `kind`: exact ties in both (the best value at slots far apart,
    in other tiles), NaN logits, or all NaN."""
    rng = np.random.default_rng(seed)
    V = cfg.n_out_vocab
    logits = rng.normal(0, 2, (B, V)).astype(np.float32)
    noise = rng.gumbel(size=(B, width)).astype(np.float32)
    if kind == "ties":
        noise[0] = 0.0
        logits[0] = np.minimum(logits[0], 5.0)
        for v in (V - 3, 12000, 11030, 10500, 10100, 9000, 4000, 7):
            if v < V:
                logits[0, v] = 9.0
    elif kind == "nan":
        logits[0, [v for v in (3, 9500, 10300, 11000, 11500, 12000)
                   if v < V]] = np.nan
    elif kind == "all-nan":
        logits[0] = np.nan
    return torch.from_numpy(logits), torch.from_numpy(noise)


def _plain(row, sample, j, noise_row):
    """ops.sampling.sample on step j's window of one lane: (token, eos_p)."""
    base, n = sample.window(j, row.shape[0])
    tok, eos_p = sampling.sample(row[base:base + n], sample.temp,
                                 None if sample.temp == 0.0 else noise_row[:n])
    return base + int(tok), float(eos_p)


@pytest.mark.parametrize("kind", ["seeded", "ties", "nan", "all-nan"])
@pytest.mark.parametrize("temp", [0.7, 0.0], ids=["temp0.7", "temp0"])
@pytest.mark.parametrize("name,cfg,win,sample", SAMPLES,
                         ids=[s[0] for s in SAMPLES])
def test_fold_gives_the_plain_sample(name, cfg, win, sample, temp, kind):
    B = 3
    sample = kdec.LoopSample(temp, codebook=sample.codebook,
                             stop_token=sample.stop_token)
    width = sample.window(1, cfg.n_out_vocab)[1]
    logits, noise = _rows(cfg, B, 5, kind, width)
    rows = None if temp == 0.0 else noise
    # the partials are keyed by LM tile: neither the grid nor a packed read
    # moves them
    plan = kdec.lane_plan(cfg, 7, B, win)
    parts = kdec.lane_sample_partials(plan, logits, sample, 1, rows)
    got = kdec.lane_fold_partials(parts, logits, sample, 1)
    for b, (tok, eos_p) in enumerate(got):
        want, want_p = _plain(logits[b], sample, 1, noise[b])
        assert tok == want, (b, tok, want)
        if sample.codebook is not None:
            assert eos_p is None
        elif b == 0 and kind in ("nan", "all-nan"):
            assert math.isnan(eos_p) and math.isnan(want_p)
        else:
            assert eos_p == pytest.approx(want_p, rel=1e-5, abs=1e-12)
    if kind == "ties":  # the lowest tied slot of the window wins
        base, n = sample.window(1, cfg.n_out_vocab)
        assert got[0][0] == base + int(torch.argmax(logits[0, base:base + n]))


@pytest.mark.parametrize("ctx_len,count0,K", [(257, 0, 16), (257, 752, 16),
                                              (257, 766, 16), (1023, 0, 4)])
def test_chunk_slots_clamp_and_window_slots_are_per_lane(ctx_len, count0, K):
    """K9's loop decodes step j of every lane at the shared slot
    min(ctx_len + count0 + j, block_size - 1), the clamp included; K10's
    lane b at ctx_len[b] + j."""
    slots, sample = kbsem.chunk_lane_loop(SEM, ctx_len, count0, K, 0.7, SVS,
                                          0.5, 3)
    assert slots == [[min(ctx_len + count0 + j, SEM.block_size - 1)] * 3
                     for j in range(K)]
    assert (sample.noise_row0, sample.codebook, sample.stop_token,
            sample.min_eos_p) == (count0, None, SVS, 0.5)
    ctx = [887, 700 - count0 // 8, 257]
    slots, sample = kbwin.window_lane_loop(ctx, 5, 60, 0.7, SVS, CBS)
    assert slots == [[c + j for c in ctx] for j in range(60)]
    assert sample.codebook == (SVS, CBS, 5) and sample.noise_row0 == 0


# ----------------------------------------- the mirror loop against bark_tpu


def _mirror(tcfg, tp, logits, kc, vc, slots, sample, rows, lm_window=None):
    """The batched step loop on the CPU: each step's tokens (and flags)
    from the tile-keyed sampler's partials and fold, then the plain
    batched step; (toks (B, steps), flags (B, steps) or None)."""
    B = logits.shape[0]
    plan = kdec.lane_plan(tcfg, 7, B, lm_window, packed=gpt.is_qpack(tp))
    toks, flags = [], []
    for j, row in enumerate(slots):
        got = kdec.lane_fold_partials(
            kdec.lane_sample_partials(plan, logits, sample, j, rows(j)),
            logits, sample, j)
        toks.append([t for t, _ in got])
        if sample.codebook is None:
            flags.append([int(t == sample.stop_token
                              or e >= sample.min_eos_p) for t, e in got])
        logits = kbdec.decode_step_batched_plain(tcfg, tp, toks[-1], kc, vc,
                                                 row, lm_window)
    return (np.asarray(toks).T.tolist(),
            np.asarray(flags).T.tolist() if flags else None)


def _one_layer(cfg):
    return dataclasses.replace(cfg, n_layer=1)


def _dense_model():
    # one layer and 64 slots: the interpret mode's cost is per layer
    cfg = _one_layer(DECODE_CFG)
    jp, tp = _params(cfg, 3)
    return cfg, jp, _tcfg(cfg), tp, jkdec.prepare_decode_params


def _packed_model():
    """A one-layer q5_1 qpack: tests/test_quant_decode.py's section without
    its second layer, loaded on both sides."""
    from bark_tpu.io import ggml as jggml
    from bark_tpu.io import loader as jloader
    from bark_tpu_torch.io import loader as tloader

    from test_quant_decode import _section
    from test_torch_quant import _port_section

    sec = _section(jggml.GGMLType.Q5_1)
    sec = jggml.GPTSection(
        hparams=dataclasses.replace(sec.hparams, n_layer=1),
        tensors={k: r for k, r in sec.tensors.items()
                 if not k.startswith("model/h1/")})
    cfg, jq = jloader.gpt_qparams_from_section(sec, jnp.float32)
    tcfg, tq = tloader.gpt_qparams_from_section(_port_section(sec),
                                                torch.float32, "cpu")

    def prepare(cfg, p, **kw):
        return jkdec.prepare_decode_params(cfg, p, quant=True, **kw)

    def blocks(key):  # a per-32-value scale or min, repeated to each value
        return np.repeat(np.asarray(jloader.scales_to_f32(jq[key])), 32,
                         axis=2)

    # the densified wte (q * s + m in f32, as `dense_from_qpack`)
    wte = np.asarray(jq["wte_q"]).astype(np.float32) * blocks("wte_s")
    prepare.dense_wte = jnp.asarray((wte + blocks("wte_m"))[0])
    return cfg, jq, tcfg, tq, prepare


def _caches(cfg, B, seed, ctx):
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layer, B, cfg.block_size, cfg.n_embd)
    kc = (rng.randn(*shape) * 0.5).astype(np.float32)
    vc = (rng.randn(*shape) * 0.5).astype(np.float32)
    for b, c in enumerate(ctx):
        kc[:, b, c:] = vc[:, b, c:] = 0
    return kc, vc


def test_mirror_chunk_matches_pallas():
    """K9 on the q5_1 qpack: 5 steps of 3 lanes at temp 0.7 after 40 rows,
    min_eos_p 0.02, lane 0's first logits weighted to the stop slot (its
    first flag set)."""
    cfg, jp, tcfg, tp, prepare = _packed_model()
    B, K, ctx0, svs, min_eos_p = 3, 5, 40, 150, 0.02
    pp = jksem.prepare_semantic_params(cfg, prepare(cfg, jp),
                                       dense_wte=prepare.dense_wte)
    kc, vc = _caches(cfg, B, 50, [ctx0] * B)
    logits0 = (np.random.RandomState(51).randn(B, cfg.n_out_vocab)
               * 2).astype(np.float32)
    logits0[0, -1] = 8.0
    subs = jax.vmap(lambda k: jax.random.split(k, 2 * K))(
        jax.vmap(jax.random.PRNGKey)(jnp.asarray([5, 12, 19])))
    gum = jksem.make_gumbel_rows_batched(subs, jnp.int32(0), K,
                                         cfg.n_out_vocab,
                                         jkdec._v_pad(cfg), 0.7)
    jt, jf, _, _, _ = jksem.semantic_chunk_fused_batched(
        cfg, pp, jnp.asarray(logits0), jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(ctx0), jnp.int32(0), gum, jnp.float32(min_eos_p), K=K,
        temp=0.7, semantic_vocab_size=svs, quant=True, interpret=True)
    noise = torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.gumbel(k, (cfg.n_out_vocab,), jnp.float32)))(
        subs[:, :K])))
    slots, sample = kbsem.chunk_lane_loop(tcfg, ctx0, 0, K, 0.7, svs,
                                          min_eos_p, B)
    toks, flags = _mirror(tcfg, tp, torch.from_numpy(logits0),
                          torch.from_numpy(kc), torch.from_numpy(vc), slots,
                          sample, lambda j: noise[:, sample.noise_row(j, K)])
    assert toks == np.asarray(jt).tolist()
    assert flags == np.asarray(jf).tolist()
    assert 0 < sum(map(sum, flags)) < B * K


def test_mirror_window_matches_pallas():
    """K10 on the dense model: one 5-step window of 3 lanes at temp 0.7,
    odd step parity, from contexts of 48, 30 and 40 rows."""
    cfg, jp, tcfg, tp, prepare = _dense_model()
    sws, svs, cbs, ctx = 5, 32, 64, [48, 30, 40]
    B, lmw = len(ctx), (svs, svs + 2 * cbs)
    pp = jkwin.prepare_window_params(
        cfg, prepare(cfg, jp, lm_window=lmw), svs=svs, cbs=cbs)
    kc, vc = _caches(cfg, B, 60, ctx)
    logits0 = (np.random.RandomState(61).randn(B, cfg.n_out_vocab)
               * 2).astype(np.float32)
    subs = jnp.stack([jax.random.split(jax.random.PRNGKey(7 + b), sws)
                      for b in range(B)], axis=1)  # (sws, B, 2)
    jt, _, _ = jkwin.coarse_window_fused_batched(
        cfg, pp, jnp.asarray(logits0), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(ctx, jnp.int32), jnp.int32(1), subs, sws=sws, temp=0.7,
        semantic_vocab_size=svs, codebook_size=cbs, lm_window=lmw,
        interpret=True)
    noise = torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.gumbel(k, (cbs,), jnp.float32)))(subs)))
    slots, sample = kbwin.window_lane_loop(ctx, 1, sws, 0.7, svs, cbs)
    toks, flags = _mirror(tcfg, tp, torch.from_numpy(logits0),
                          torch.from_numpy(kc), torch.from_numpy(vc), slots,
                          sample, lambda j: noise[j], lmw)
    assert flags is None
    assert toks == np.asarray(jt).tolist()


# ------------------------------------------------------------ stamps


def test_lane_loop_stamps_split_a_launch():
    """`loop_phases_us` splits a row of the batched loop's stamps as the
    kernel writes them: the start, per step its tokens, its LM head's start
    and end, the end."""
    plan = kdec.lane_plan(SEM, 3, 8)
    n = 4
    stamps = kdec.loop_stamps(plan, n, "cpu")
    assert tuple(stamps.shape) == (3, 2 + 3 * n)
    for b in range(3):
        t, row = 1000 * b, [1000 * b]
        t += 700  # the opening sample
        row.append(t)
        for j in range(n):
            row += [t + 500, t + 560]  # layers 500 ns, LM head 60
            t += 560 + (30 if j + 1 < n else 0)  # the sample's fold 30
            row.append(t)
        stamps[b] = torch.tensor(row[:1 + 3 * n] + [t + 1], dtype=torch.int64)
    us = kdec.loop_phases_us(plan, stamps, n)
    assert us["block0"]["opening_sample"] == pytest.approx(0.7)
    assert us["block0"]["layers"] == pytest.approx(0.5)
    assert us["block0"]["lm_head"] == pytest.approx(0.06)
    assert us["block0"]["sample_fold"] == pytest.approx(0.03)
    assert us["block0"]["step"] == pytest.approx(0.59)
    assert us["launch_us"] == pytest.approx((2000 + 700 + 4 * 560 + 90 + 1)
                                            / 1e3)


# ------------------------------------------------------------ SASS

_SASS = """
        Function : _ZN3_GLOBAL__N_116lane_step_kernelINS_10PackedReadI13__nv_bfloat166__halfLb0EEEEEvNS_8LaneArgsINT_7WeightsEEE
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0020*/               @P0 BRA 0x10 ;
        /*0030*/                   EXIT ;
        Function : _ZN3_GLOBAL__N_117lane_steps_kernelINS_10PackedReadI13__nv_bfloat166__halfLb0EEEEEvNS_8LaneArgsINT_7WeightsEEE
        /*0000*/                   LDS R2, [R3] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   LDS R5, [R3] ;
        /*0030*/              @!P1 BRA 0x20 ;
        /*0040*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0050*/               @P0 BRA 0x0 ;
        /*0060*/                   EXIT ;
"""
_PTXAS = """
ptxas info    : Compiling entry function '_ZN3_GLOBAL__N_117lane_steps_kernelINS_10PackedReadI13__nv_bfloat166__halfLb0EEEEEvNS_8LaneArgsINT_7WeightsEEE' for 'sm_90a'
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers
"""


def test_lane_sass_pairs_the_kernels_and_finds_their_loops():
    """probes/lane_sass.py: the two kernels of one read side by side, the
    innermost loops with HMMA (around a wait loop), the opcodes counted."""
    from bark_tpu_torch.probes import lane_sass

    rec = lane_sass.compare({"o": _SASS}, {"o": _PTXAS})
    assert list(rec) == ["PackedRead<bf16,f16,min0>"]
    one, loop = rec["PackedRead<bf16,f16,min0>"]["single_step"], \
        rec["PackedRead<bf16,f16,min0>"]["loop"]
    assert (one["instructions"], one["tid_reads"], one["HMMA"]) == (4, 1, 1)
    assert "registers" not in one
    assert (loop["registers"], loop["spill_stores"], loop["spill_loads"],
            loop["LDS"]) == (128, 12, 4, 2)
    # the HMMA loop holds the wait loop [0x20, 0x30]
    assert [(lp["start"], lp["instructions"], lp["HMMA"], lp["LDS"],
             lp["sass"][-1]) for lp in loop["hmma_loops"]] == [
        ("0x0", 6, 1, 2, "@P0 BRA 0x0")]
    assert one["hmma_loops"][0]["instructions"] == 2
    assert rec["PackedRead<bf16,f16,min0>"]["op_diff"] == {"LDS": 2, "BRA": 1}


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
        return (kbdec.launches, kbdec.loop_launches, qbdecode.launches,
                qbdecode.loop_launches, kbsem.launches, kbwin.launches)

    before = counts()
    yield
    assert counts() == before


def _meta(B: int):
    params = gpt.init_params(SMALL, torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    params = {k: ({kk: vv.to("meta") for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to("meta"))
              for k, v in params.items()}
    kc, vc = gpt.init_kv_cache(SMALL, torch.float32, "meta", batch=B)
    logits = torch.zeros((B, SMALL.n_out_vocab), device="meta")
    return params, kc, vc, logits


@pytest.mark.parametrize("fault,match", [
    ("lanes", "1 <= B"), ("slots", "slots"), ("flags", "flag_out"),
    ("noise", "noise"), ("window-outside", "sample window")])
def test_lane_loop_refuses_before_any_launch(no_launch, fault, match):
    B = 33 if fault == "lanes" else 4
    params, kc, vc, logits = _meta(B)
    toks = torch.zeros((4, B), dtype=torch.int32, device="meta")
    args = dict(slots=[[40] * B] * 4,
                sample=kdec.LoopSample(0.7, stop_token=150),
                noise=torch.zeros((B, 4, SMALL.n_out_vocab), device="meta"),
                tok_out=toks, flag_out=toks)
    if fault == "slots":
        args["slots"][2] = [40, 41, SMALL.block_size, 42]
    elif fault == "flags":
        args["flag_out"] = None
    elif fault == "noise":  # rows narrower than the window
        args["noise"] = torch.zeros((B, 4, 100), device="meta")
    elif fault == "window-outside":  # the odd step's codebook past the head
        args.update(sample=kdec.LoopSample(0.0, codebook=(32, 64, 0)),
                    noise=None, lm_window=(32, 100))
    with pytest.raises(ValueError, match=match):
        kbdec.decode_lane_steps(SMALL, params, logits, kc, vc, **args)


def test_chunk_and_window_wrappers_refuse_before_any_launch(no_launch):
    params, kc, vc, logits = _meta(4)
    with pytest.raises(ValueError, match="noise"):  # rows of another width
        kbsem.semantic_chunk_fused_batched(
            SMALL, params, logits, kc, vc, 40, 0,
            torch.zeros((4, 4, 100), device="meta"), 2.0, K=4, temp=0.7,
            semantic_vocab_size=150)
    with pytest.raises(ValueError, match="window"):  # slots past the cache
        kbwin.coarse_window_fused_batched(
            SMALL, params, logits, kc, vc, [40, 41, 500, 42], 0, None,
            sws=16, temp=0.0, semantic_vocab_size=32, codebook_size=64,
            lm_window=(32, 160))
