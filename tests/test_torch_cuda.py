"""bark_tpu_torch's CUDA kernels against their plain PyTorch versions on
the card, at a small model (2 layers, width 128, head dim 64) in f32 with
TF32 off: tokens and flags equal, logits and cache rows within 1e-4 (f32
sums in another order). K1, one cooperative launch a step, also at
bark-small's width (12 heads of 64) with 1024 slots: n_past 0/300/1023,
full head and coarse window, f32 and bf16, dense and int8 caches,
bit-equal from run to run, 60 queued steps equal to 60 synced ones, and
K3/K4 over it token-equal to their plain versions. K3 and K4, one launch
of K1's step in a loop with the sampler inside: against their plain
versions (f32 tokens and flags equal; dense, q8_0 and q4_0; bf16 and int8
caches; the K3 slot clamp; both K4 parities) and bit-equal to K1's steps
on the same tokens, one launch and one device kernel a call, bit-equal
from run to run in bf16 and stamped. K5, the packed step
(the same persistent kernel on its packed weight read), and K5-batched,
the packed batched step (with K9 and K10 over it), run on qpacks loaded
from sections quantized in q8_0, q4_0, q4_1, q5_1 and q4_k; K5 also at
bark-small's width on random qpacks of the four scale forms (f16, f16 +
mins, f32, f32 + mins), f32 and bf16, bf16 and int8 caches, bit-equal
from run to run and stamped. K6, the int8 KV
cache inside K1/K5/K7 and K2/K8, is held to its plain version (the same
functions on the int8 caches of `gpt.init_kv_cache(quant=True)`) within
3e-3 on the logits and one int8 step on rare cache values. D1-D5, the
weight-stream probe, run every form and load method at small sizes
(the grouped forms also at N > ring) within `probes.dma.excess`'s
tolerances of their plain versions. C1-C3, the cache probe: its kernel
bit-equal to x * 2, the scan of it equal to 1024 on ones, its source
shifted by 7 lines giving the same SASS and object key; and
`BarkContext.warmup` launching the kernels without moving the generator.
K7 and K5-batched, the batched step (one persistent launch a step, its
products on the tensor cores in bf16), also at bark-small's width for 1,
3, 8 and 32 lanes at n_past 0/300/1023/887: f32 and bf16, dense and int8
caches, dense weights and the four scale forms, within 2e-3 (f32) or 1e-1
(bf16) of the plain version, bit-equal from run to run and stamped, and
20 steps queued with slots on the card equal to 20 synced ones. K9 and
K10, one launch of that step in a loop with the sampler inside, at the
same width for 1, 3, 8 and 32 lanes (dense, q8_0 and q4_0; bf16 and int8
caches; the clamp; both parities): f32 tokens and flags equal to the plain
version's and bit-equal to K7's steps on the same tokens, one device
kernel a call, bf16 bit-equal from run to run, and stamped.
K2 and K8 in bf16 (the TMA + wgmma GEMM and the tensor-core attention)
at widths 768, 1024 and 128, T 1 to 1024, dense and int8 caches: within
1e-1 of the plain version, bit-equal from run to run, rows past n_valid
unwritten; a misaligned weight refused before any launch.
P1-P9, the lowering probe: each kernel against its plain version at the
reference's shapes and at bark-small's (P1 all three ways, P2b fused and
in two launches, P3 by one block and by strips (bit-equal; a narrow last
strip, one row, a ring of stages), P6 on 132 blocks, P7/P8 by bulk,
st16 and the ring, P8 leaving the rows outside its windows as they were,
P9 by simt and wgmma), bit-equal where they move data, and the refusals
launching nothing. Marked `cuda`;
without a GPU they skip. On the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(--noconftest: tests/conftest.py imports jax, which that machine lacks.)
"""

import dataclasses

import pytest
import torch

from bark_tpu_torch import kernels
from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.kernels import kv8
from bark_tpu_torch.kernels import prefill as kpre
from bark_tpu_torch.kernels import semantic as ksem
from bark_tpu_torch.kernels import window as kwin
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.ops import sampling

pytestmark = pytest.mark.cuda

ATOL = 1e-4
CFG = GPTConfig(n_layer=2, n_head=2, n_embd=128, block_size=512,
                n_in_vocab=300, n_out_vocab=200, bias=True)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    p = gpt.init_params(CFG, gen, torch.float32, dev)
    for k, v in p["blocks"].items():
        if k.endswith("_b"):
            v.add_(0.01 * torch.randn(v.shape, generator=gen, device=dev))
    return p


def _caches(dev, rows):
    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev)
    g = torch.Generator(device=dev).manual_seed(rows)
    kc[:, :rows] = torch.randn(kc[:, :rows].shape, generator=g, device=dev)
    vc[:, :rows] = torch.randn(vc[:, :rows].shape, generator=g, device=dev)
    return kc, vc


@pytest.mark.parametrize("n_past,win", [(0, None), (40, None), (511, None),
                                        (40, (32, 160))])
def test_decode_kernel(dev, params, n_past, win):
    kc, vc = _caches(dev, n_past)
    kc2, vc2 = kc.clone(), vc.clone()
    before = kdec.launches
    out = kdec.decode_step_fused(CFG, params, 17, kc, vc, n_past,
                                 lm_window=win)
    assert kdec.launches == before + 1
    ref = kdec.decode_step_plain(CFG, params, 17, kc2, vc2, n_past, win)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(kc, kc2, rtol=0, atol=ATOL)
    torch.testing.assert_close(vc, vc2, rtol=0, atol=ATOL)


@pytest.mark.parametrize("T,n_valid", [(257, 257), (384, 300), (512, 1)])
def test_prefill_kernel(dev, params, T, n_valid):
    x = params["wte"][0][:T].contiguous()
    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev)
    kc2, vc2 = kc.clone(), vc.clone()
    out = kpre.prefill_fused(CFG, params, x, kc, vc, n_valid)
    ref = kpre.prefill_plain(CFG, params, x, kc2, vc2, n_valid)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(kc[:, :n_valid], kc2[:, :n_valid], rtol=0,
                               atol=ATOL)
    assert not kc[:, n_valid:].any()  # dead rows are not written


@pytest.mark.parametrize("temp,min_eos_p", [(0.7, 2.0), (0.7, 0.006),
                                            (0.0, 2.0)])
def test_semantic_chunk_kernel(dev, params, temp, min_eos_p):
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = sampling.gumbel((16, CFG.n_out_vocab), gen, dev)
    kc, vc = _caches(dev, 40)
    kc2, vc2 = kc.clone(), vc.clone()
    logits0 = torch.randn(CFG.n_out_vocab, generator=gen, device=dev) * 2
    args = (40, 0, noise, min_eos_p)
    kw = dict(K=8, temp=temp, semantic_vocab_size=150)
    t, f, lg = ksem.semantic_chunk_fused(CFG, params, logits0, kc, vc, *args,
                                         **kw)
    rt, rf, rlg = ksem.semantic_chunk_plain(CFG, params, logits0, kc2, vc2,
                                            *args, **kw)
    assert t.tolist() == rt.tolist() and f.tolist() == rf.tolist()
    torch.testing.assert_close(lg, rlg, rtol=0, atol=ATOL)
    torch.testing.assert_close(kc[:, 40:48], kc2[:, 40:48], rtol=0, atol=ATOL)


@pytest.mark.parametrize("temp,step0", [(0.7, 0), (0.7, 1), (0.0, 0)])
def test_coarse_window_kernel(dev, params, temp, step0):
    gen = torch.Generator(device=dev).manual_seed(2)
    noise = sampling.gumbel((10, 64), gen, dev)
    kc, vc = _caches(dev, 40)
    kc2, vc2 = kc.clone(), vc.clone()
    logits0 = torch.randn(CFG.n_out_vocab, generator=gen, device=dev) * 2
    kw = dict(sws=10, temp=temp, semantic_vocab_size=32, codebook_size=64,
              lm_window=(32, 160))
    t = kwin.coarse_window_fused(CFG, params, logits0, kc, vc, 40, step0,
                                 noise, **kw)
    rt = kwin.coarse_window_plain(CFG, params, logits0, kc2, vc2, 40, step0,
                                  noise, **kw)
    assert t.tolist() == rt.tolist()
    torch.testing.assert_close(vc[:, 40:50], vc2[:, 40:50], rtol=0, atol=ATOL)


def test_kernels_follow_a_replaced_weight(dev, params):
    """A tensor replaced in the params dict after the first launch is the
    one the next launch reads; the dict gains no key."""
    p = {**params, "blocks": dict(params["blocks"])}
    keys = set(p)
    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev)
    kdec.decode_step_fused(CFG, p, 17, kc, vc, 0)
    p["blocks"]["fc_w"] = p["blocks"]["fc_w"] * 2
    p["lm_head"] = -p["lm_head"]
    kc2, vc2 = kc.clone(), vc.clone()
    out = kdec.decode_step_fused(CFG, p, 17, kc, vc, 0)
    ref = kdec.decode_step_plain(CFG, p, 17, kc2, vc2, 0)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    assert set(p) == keys


def test_wrappers_refuse_what_the_kernels_do_not_take(dev, params):
    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev)
    with pytest.raises(ValueError):  # caches of another dtype
        kdec.decode_step_fused(CFG, params, 1, kc.half(), vc.half(), 0)
    with pytest.raises(ValueError):  # n_past outside the cache
        kdec.decode_step_fused(CFG, params, 1, kc, vc, CFG.block_size)
    odd = dataclasses.replace(CFG, n_head=4)  # head dim 32
    with pytest.raises(ValueError):
        kdec.decode_step_fused(odd, dict(params), 1, kc, vc, 0)
    kernels.reset_launches()
    assert set(kernels.launch_counts().values()) == {0}


# ----------------------------------------- K1, one cooperative launch a step
# At bark-small's width (12 heads, 768) with 2 layers and 1024 slots: the
# persistent step against its plain version (f32 logits and K/V rows
# within 1e-4; bf16 within chip_smoke.py's 1e-1, one-ulp flips of another
# summation order compounding; int8 caches within KV8_ATOL, and 5e-2 at
# n_past 0, where a lane's context is its own fresh V row and one int8
# boundary value moves it, as chip_smoke.py's TOL_KV8_FIRST; in bf16 the
# int8 rows dequantized within 1e-1, since a one-ulp flip of a fresh value
# moves its int8 value a step), bit-equal
# from run to run (the plan's fixed fold order), steps queued with no host
# sync equal to synced ones (the barrier count re-armed), and K3/K4 over it
# token-equal to their plain versions in f32 (K3/K4 are now one launch of
# its step loop: their own section below).

K1_CFG = GPTConfig(n_layer=2, n_head=12, n_embd=768, block_size=1024,
                   n_in_vocab=12096, n_out_vocab=12096, bias=True)
K1_WIN = (10000, 12048)


@pytest.fixture(scope="module")
def k1_params(dev):
    gen = torch.Generator(device=dev).manual_seed(10)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        p = gpt.init_params(K1_CFG, gen, dtype, dev)
        for k, v in p["blocks"].items():
            if k.endswith("_b") or k.endswith("_g"):
                v.add_(0.02 * torch.randn(v.shape, generator=gen,
                                          device=dev).to(dtype))
        out[dtype] = p
    return out


def _k1_caches(dev, dtype, rows, quant):
    g = torch.Generator(device=dev).manual_seed(rows + 1)
    kc, vc = gpt.init_kv_cache(K1_CFG, dtype, dev, quant=quant)
    for c in (kc, vc):
        live = torch.randn((K1_CFG.n_layer, rows, K1_CFG.n_embd),
                           generator=g, device=dev)
        if quant:
            c["q"][:, :rows], c["s"][:, :rows] = gpt.quantize_kv_rows(live)
        else:
            c[:, :rows] = live.to(dtype)
    return kc, vc


def _clone(c):
    return {k: v.clone() for k, v in c.items()} if isinstance(c, dict) \
        else c.clone()


@pytest.mark.parametrize("win", [None, K1_WIN], ids=["head", "window"])
@pytest.mark.parametrize("n_past", [0, 300, 1023])
@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_persistent_decode_step(dev, k1_params, dtype, cache, n_past, win):
    p, quant = k1_params[dtype], cache == "int8"
    kc, vc = _k1_caches(dev, dtype, n_past, quant)
    kc2, vc2 = _clone(kc), _clone(vc)
    before = kdec.launches
    out = kdec.decode_step_fused(K1_CFG, p, 17, kc, vc, n_past,
                                 lm_window=win)
    torch.cuda.synchronize()
    assert kdec.launches == before + 1
    ref = kdec.decode_step_plain(K1_CFG, p, 17, kc2, vc2, n_past, win)
    if dtype == torch.bfloat16:
        tol = 1e-1
    else:
        tol = (5e-2 if n_past == 0 else KV8_ATOL) if quant else ATOL
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    if win is not None:
        assert not out[:win[0]].any() and not out[win[1]:].any()
    row = slice(n_past, n_past + 1)
    if quant and dtype == torch.float32:
        for a, b in ((kc, kc2), (vc, vc2)):
            _kv8_close({k: t[:, row] for k, t in a.items()},
                       {k: t[:, row] for k, t in b.items()})
    elif quant:  # one-ulp bf16 flips move int8 values a step: dequantized
        for a, b in ((kc, kc2), (vc, vc2)):
            torch.testing.assert_close(
                a["q"][:, row].float() * a["s"][:, row, None],
                b["q"][:, row].float() * b["s"][:, row, None],
                rtol=0, atol=tol)
    else:
        torch.testing.assert_close(kc[:, row].float(), kc2[:, row].float(),
                                   rtol=0, atol=tol)
        torch.testing.assert_close(vc[:, row].float(), vc2[:, row].float(),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("cache", ["dense", "int8"])
def test_persistent_step_is_bit_equal_run_to_run(dev, k1_params, cache):
    p, quant = k1_params[torch.bfloat16], cache == "int8"
    kc, vc = _k1_caches(dev, torch.bfloat16, 300, quant)
    runs = []
    for _ in range(2):
        k, v = _clone(kc), _clone(vc)
        runs.append((kdec.decode_step_fused(K1_CFG, p, 17, k, v, 300), k, v))
    (a, ka, va), (b, kb, vb) = runs
    assert torch.equal(a, b)
    for x, y in ((ka, kb), (va, vb)):
        for s, t in (zip(x.values(), y.values()) if quant else [(x, y)]):
            assert torch.equal(s, t)


def test_queued_steps_rearm_the_barrier(dev, k1_params):
    """60 steps, each taking its token on the card from the last logits
    (`torch.argmax` of the first 1000 into a device tensor), queued with
    no host sync, against the same 60 with a sync after each: the same
    tokens and logits (a count left armed would hang or run a step
    early)."""
    p = k1_params[torch.float32]
    runs = []
    for sync in (False, True):
        kc, vc = _k1_caches(dev, torch.float32, 300, False)
        buf = torch.zeros(K1_CFG.n_out_vocab, device=dev)
        buf[5] = 1.0
        toks = torch.empty(60, dtype=torch.int32, device=dev)
        for j in range(60):
            toks[j:j + 1] = torch.argmax(buf[:1000])
            kdec.decode_step_fused(K1_CFG, p, toks[j:j + 1], kc, vc, 300 + j,
                                   out=buf)
            if sync:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        runs.append((toks.tolist(), buf.clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


def test_persistent_step_stamps(dev, k1_params):
    """A stamped step gives the unstamped step's logits; every block's
    clock readings run forward and split into the phases."""
    p = k1_params[torch.bfloat16]
    kc, vc = _k1_caches(dev, torch.bfloat16, 300, False)
    plan, _ = kdec.device_plan(_build.stage_weights(K1_CFG, p), None)
    stamps = kdec.step_stamps(plan, dev)
    a = kdec.decode_step_fused(K1_CFG, p, 17, _clone(kc), _clone(vc), 300)
    b = kdec.decode_step_fused(K1_CFG, p, 17, _clone(kc), _clone(vc), 300,
                               stamps=stamps)
    assert torch.equal(a, b)
    for t in stamps.tolist():  # every block's row
        assert all(x <= y for x, y in zip(t, t[1:])) and t[-1] > t[0]
    us = kdec.step_phases_us(plan, stamps)
    assert us["step"] > 0 and plan.n_barriers == 4 * K1_CFG.n_layer
    assert kdec.step_critical_us(plan, stamps)["step"] >= us["step"]


def test_persistent_chunk_and_window_tokens(dev, k1_params):
    """K3's 16-step chunk and K4's 60-step window over the persistent step
    give the plain versions' tokens and flags in f32."""
    p = k1_params[torch.float32]
    gen = torch.Generator(device=dev).manual_seed(3)
    V = K1_CFG.n_out_vocab
    logits0 = torch.randn(V, generator=gen, device=dev) * 2
    noise = sampling.gumbel((32, V), gen, dev)
    kc, vc = _k1_caches(dev, torch.float32, 257, False)
    kc2, vc2 = kc.clone(), vc.clone()
    kw = dict(K=16, temp=0.7, semantic_vocab_size=10000)
    t, f, lg = ksem.semantic_chunk_fused(K1_CFG, p, logits0, kc, vc, 257, 3,
                                         noise, 2.0, **kw)
    rt, rf, rlg = ksem.semantic_chunk_plain(K1_CFG, p, logits0, kc2, vc2,
                                            257, 3, noise, 2.0, **kw)
    assert t.tolist() == rt.tolist() and f.tolist() == rf.tolist()
    torch.testing.assert_close(lg, rlg, rtol=0, atol=ATOL)
    noise = sampling.gumbel((60, 1024), gen, dev)
    kc, vc = _k1_caches(dev, torch.float32, 887, False)
    kc2, vc2 = kc.clone(), vc.clone()
    kw = dict(sws=60, temp=0.7, semantic_vocab_size=10000,
              codebook_size=1024, lm_window=K1_WIN)
    t = kwin.coarse_window_fused(K1_CFG, p, logits0, kc, vc, 887, 1, noise,
                                 **kw)
    rt = kwin.coarse_window_plain(K1_CFG, p, logits0, kc2, vc2, 887, 1,
                                  noise, **kw)
    assert t.tolist() == rt.tolist()
    torch.testing.assert_close(vc[:, 887:947], vc2[:, 887:947], rtol=0,
                               atol=ATOL)


# ------------------------------------------------------------ K5 (packed)

QCFG = dataclasses.replace(CFG, block_size=512)
QFORMATS = ("Q8_0", "Q4_0", "Q4_1", "Q5_1", "Q4_K")


def _qsection(qt: str):
    """A width-128 section whose projections, wte and LM head are stored
    in block type `qt` (the port's ggml writer and quantizers)."""
    import numpy as np

    from bark_tpu_torch.io import ggml

    rng = np.random.default_rng(3)
    D, t = QCFG.n_embd, {}

    def add(name, arr, ttype=ggml.GGMLType.F32):
        t[name] = ggml.TensorRecord.from_array(name, arr.astype(np.float32),
                                               ttype)

    def rnd(*shape):
        return rng.normal(0, 0.08, shape)

    q = ggml.GGMLType[qt]
    add("model/wte/0", rnd(QCFG.n_in_vocab, D), q)
    add("model/wpe", rnd(QCFG.block_size, D))
    add("model/lm_head/0", rnd(QCFG.n_out_vocab, D), q)
    add("model/ln_f/g", 1 + rnd(D))
    add("model/ln_f/b", rnd(D))
    for i in range(QCFG.n_layer):
        for n in ("ln_1", "ln_2"):
            add(f"model/h{i}/{n}/g", 1 + rnd(D))
            add(f"model/h{i}/{n}/b", rnd(D))
        for n, shape in (("attn/c_attn", (3 * D, D)), ("attn/c_proj", (D, D)),
                         ("mlp/c_fc", (4 * D, D)),
                         ("mlp/c_proj", (D, 4 * D))):
            add(f"model/h{i}/{n}/w", rnd(*shape), q)
            add(f"model/h{i}/{n}/b", rnd(shape[0]))
    hp = ggml.GPTHParams(
        n_layer=QCFG.n_layer, n_head=QCFG.n_head, n_embd=D,
        block_size=QCFG.block_size, bias=1, n_in_vocab=QCFG.n_in_vocab,
        n_out_vocab=QCFG.n_out_vocab, n_lm_heads=1, n_wtes=1, ftype=int(q))
    return ggml.GPTSection(hparams=hp, tensors=t)


@pytest.fixture(scope="module", params=QFORMATS)
def qpack(dev, request):
    from bark_tpu_torch.io import loader

    cfg, qp = loader.gpt_qparams_from_section(_qsection(request.param),
                                              torch.float32, dev)
    assert cfg == QCFG
    return qp


@pytest.mark.parametrize("n_past,win", [(0, None), (40, None), (511, None),
                                        (40, (32, 160))])
def test_packed_decode_kernel(dev, qpack, n_past, win):
    from bark_tpu_torch.kernels import qdecode

    kc, vc = _caches(dev, n_past)
    kc2, vc2 = kc.clone(), vc.clone()
    before, dense_before = qdecode.launches, kdec.launches
    out = kdec.decode_step_fused(QCFG, qpack, 17, kc, vc, n_past,
                                 lm_window=win)
    assert qdecode.launches == before + 1 and kdec.launches == dense_before
    ref = kdec.decode_step_plain(QCFG, qpack, 17, kc2, vc2, n_past, win)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(kc, kc2, rtol=0, atol=ATOL)
    torch.testing.assert_close(vc, vc2, rtol=0, atol=ATOL)


def test_packed_chunk_and_window_kernels(dev, qpack):
    gen = torch.Generator(device=dev).manual_seed(3)
    noise = sampling.gumbel((16, QCFG.n_out_vocab), gen, dev)
    logits0 = torch.randn(QCFG.n_out_vocab, generator=gen, device=dev) * 2
    kc, vc = _caches(dev, 40)
    kc2, vc2 = kc.clone(), vc.clone()
    kw = dict(K=8, temp=0.7, semantic_vocab_size=150)
    t, f, _ = ksem.semantic_chunk_fused(QCFG, qpack, logits0, kc, vc, 40, 0,
                                        noise, 2.0, **kw)
    rt, rf, _ = ksem.semantic_chunk_plain(QCFG, qpack, logits0, kc2, vc2, 40,
                                          0, noise, 2.0, **kw)
    assert t.tolist() == rt.tolist() and f.tolist() == rf.tolist()
    kw = dict(sws=10, temp=0.7, semantic_vocab_size=32, codebook_size=64,
              lm_window=(32, 160))
    t = kwin.coarse_window_fused(QCFG, qpack, logits0, kc, vc, 60, 1,
                                 noise[:10, :64], **kw)
    rt = kwin.coarse_window_plain(QCFG, qpack, logits0, kc2, vc2, 60, 1,
                                  noise[:10, :64], **kw)
    assert t.tolist() == rt.tolist()
    torch.testing.assert_close(vc[:, 60:70], vc2[:, 60:70], rtol=0,
                               atol=ATOL)


def test_packed_kernel_follows_a_replaced_tensor(dev, qpack):
    p = {**qpack, "blocks": dict(qpack["blocks"])}
    kc, vc = gpt.init_kv_cache(QCFG, torch.float32, dev)
    kdec.decode_step_fused(QCFG, p, 17, kc, vc, 0)
    p["blocks"]["fc_s"] = p["blocks"]["fc_s"] * 2
    p["lm_q"] = -p["lm_q"]
    kc2, vc2 = kc.clone(), vc.clone()
    out = kdec.decode_step_fused(QCFG, p, 17, kc, vc, 0)
    ref = kdec.decode_step_plain(QCFG, p, 17, kc2, vc2, 0)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)


# K5 at bark-small's width (K1_CFG): random qpacks of each scale form
QFORMS = {"f16": (torch.float16, False), "f16-mins": (torch.float16, True),
          "f32": (torch.float32, False), "f32-mins": (torch.float32, True)}


def _random_qpack(cfg, dtype, form, gen, qrange=None):
    """A qpack at cfg's widths drawn on the card, in the layout of
    io.loader's gpt_qparams_from_section: values in [-7, 7] ([0, 15] with
    mins centring each block; `qrange` if given, e.g. q8_0's [-127, 127]),
    per-block scales near 0.02 / std(values), so weights are ~N(0, 0.02);
    dense leaves in `dtype`, biases and LN affines off their defaults; the
    v_pad columns of the LM head zero."""
    sdt, has_min = QFORMS[form]
    dev = gen.device
    L, D, V = cfg.n_layer, cfg.n_embd, cfg.n_out_vocab
    qlo, qhi = qrange or ((0, 15) if has_min else (-7, 7))
    base = 0.02 / (((qhi - qlo + 1) ** 2 - 1) / 12) ** 0.5

    def randn(*shape, scale=0.02):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    def packed(tree, key, shape, sshape):
        tree[key + "_q"] = torch.randint(qlo, qhi + 1, shape, generator=gen,
                                         device=dev, dtype=torch.int32).to(
            torch.int8)
        s = base * (0.5 + torch.rand(sshape, generator=gen, device=dev))
        tree[key + "_s"] = s.to(sdt)
        if has_min:
            tree[key + "_m"] = (-0.5 * (qlo + qhi) * s).to(sdt)

    blocks = {}
    for k in ("ln1", "ln2"):
        blocks[k + "_g"] = 1.0 + randn(L, D)
        blocks[k + "_b"] = randn(L, D)
    for key, (k, n) in {"qkv": (D, 3 * D), "proj": (D, D),
                        "fc": (D, 4 * D), "out": (4 * D, D)}.items():
        packed(blocks, key, (L, k, n), (L, k // 32, n))
        blocks[key + "_b"] = randn(L, n)
    qp = {"wpe": randn(cfg.block_size, D), "ln_f_g": 1.0 + randn(D),
          "ln_f_b": randn(D), "blocks": blocks}
    packed(qp, "wte", (1, cfg.n_in_vocab, D), (1, cfg.n_in_vocab, D // 32))
    v_pad = -(-V // D) * D
    packed(qp, "lm", (D, v_pad), (D // 32, v_pad))
    for k in ("lm_q", "lm_s", "lm_m"):
        if k in qp:
            qp[k][:, V:] = 0
    return qp


@pytest.fixture(scope="module")
def k5_qpacks(dev):
    gen = torch.Generator(device=dev).manual_seed(11)
    return {(form, dtype): _random_qpack(K1_CFG, dtype, form, gen)
            for form in QFORMS for dtype in (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("win", [None, K1_WIN], ids=["head", "window"])
@pytest.mark.parametrize("n_past", [0, 300, 1023])
@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("form", list(QFORMS))
def test_packed_persistent_decode_step(dev, k5_qpacks, form, dtype, cache,
                                       n_past, win):
    """One launch of the persistent kernel on the packed read, against
    the plain version, with test_persistent_decode_step's tolerances."""
    from bark_tpu_torch.kernels import qdecode

    p, quant = k5_qpacks[(form, dtype)], cache == "int8"
    kc, vc = _k1_caches(dev, dtype, n_past, quant)
    kc2, vc2 = _clone(kc), _clone(vc)
    before, dense_before = qdecode.launches, kdec.launches
    out = kdec.decode_step_fused(K1_CFG, p, 17, kc, vc, n_past,
                                 lm_window=win)
    torch.cuda.synchronize()
    assert qdecode.launches == before + 1 and kdec.launches == dense_before
    ref = kdec.decode_step_plain(K1_CFG, p, 17, kc2, vc2, n_past, win)
    if dtype == torch.bfloat16:
        tol = 1e-1
    else:
        tol = (5e-2 if n_past == 0 else KV8_ATOL) if quant else ATOL
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    if win is not None:
        assert not out[:win[0]].any() and not out[win[1]:].any()
    row = slice(n_past, n_past + 1)
    for a, b in ((kc, kc2), (vc, vc2)):
        if quant and dtype == torch.float32:
            _kv8_close({k: t[:, row] for k, t in a.items()},
                       {k: t[:, row] for k, t in b.items()})
        elif quant:  # dequantized, as test_persistent_decode_step
            torch.testing.assert_close(
                a["q"][:, row].float() * a["s"][:, row, None],
                b["q"][:, row].float() * b["s"][:, row, None],
                rtol=0, atol=tol)
        else:
            torch.testing.assert_close(a[:, row].float(), b[:, row].float(),
                                       rtol=0, atol=tol)


@pytest.mark.parametrize("form", list(QFORMS))
def test_packed_step_is_bit_equal_run_to_run_and_stamped(dev, k5_qpacks,
                                                         form):
    """The packed plan's fixed fold order gives the same bits twice; a
    stamped step gives the same logits, its clock running forward."""
    p = k5_qpacks[(form, torch.bfloat16)]
    kc, vc = _k1_caches(dev, torch.bfloat16, 300, False)
    plan, _ = kdec.device_plan(_build.stage_qweights(K1_CFG, p), None)
    assert plan.packed and plan.n_barriers == 4 * K1_CFG.n_layer
    stamps = kdec.step_stamps(plan, dev)
    runs = [kdec.decode_step_fused(K1_CFG, p, 17, _clone(kc), _clone(vc),
                                   300, stamps=st)
            for st in (None, None, stamps)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    for t in stamps.tolist():
        assert all(x <= y for x, y in zip(t, t[1:])) and t[-1] > t[0]
    assert kdec.step_critical_us(plan, stamps)["step"] > 0


# ----------------------------- K3/K4, one launch of the step loop a call
# At K1_CFG (bark-small's width, 2 layers): K3's 16-step chunk after 257
# rows, and one whose slots reach the clamp at block_size - 1; K4's
# 60-step window after 887 rows at both step parities; dense weights and
# q8_0 / q4_0 qpacks, bf16 and int8 caches. In f32 the tokens and flags
# equal the plain versions' and the K/V rows lie within their tolerances
# (dense ATOL; int8 `_kv8_close`); and the launch is bit-equal to K1's
# (K5's) steps run one launch each on the same tokens, its logits and
# every cache row it writes (the same plan and arithmetic, a step at a
# time). One launch a call (K1's or K5's count, K3's or K4's, and no
# sampler launch), one device kernel a call (torch.profiler), two bf16
# runs bit-equal, and a stamped launch gives the same tokens.

LOOP_QRANGES = {"q8_0": (-127, 127), "q4_0": (-8, 7)}
# case -> (K3: (ctx_len, count0); K4: (ctx_len, step parity))
LOOP_CASES = {"chunk": (257, 3), "chunk-clamp": (257, 760),
              "window-odd": (887, 1), "window-even": (887, 0)}


@pytest.fixture(scope="module")
def loop_weights(dev, k1_params):
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {"dense": k1_params}
    for fmt, qr in LOOP_QRANGES.items():
        out[fmt] = {dt: _random_qpack(K1_CFG, dt, "f16", gen, qrange=qr)
                    for dt in (torch.float32, torch.bfloat16)}
    return out


def _loop_inputs(dev, case, dtype, quant):
    """(logits0, noise, caches, K3 or K4 keyword args, ctx_len, arg) of a
    case."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    V = K1_CFG.n_out_vocab
    logits0 = torch.randn(V, generator=gen, device=dev) * 2
    ctx_len, arg = LOOP_CASES[case]
    chunk = case.startswith("chunk")
    kc, vc = _k1_caches(dev, dtype, ctx_len + (arg if chunk else 0), quant)
    if chunk:
        noise = sampling.gumbel((32, V), gen, dev)
        kw = dict(K=16, temp=0.7, semantic_vocab_size=10000)
    else:
        noise = sampling.gumbel((60, 1024), gen, dev)
        kw = dict(sws=60, temp=0.7, semantic_vocab_size=10000,
                  codebook_size=1024, lm_window=K1_WIN)
    return logits0, noise, kc, vc, kw, ctx_len, arg


def _loop_call(case, p, logits0, noise, kc, vc, kw, ctx_len, arg,
               plain=False):
    """K3 or K4 (or its plain version): (tokens, flags or None, logits or
    None)."""
    if case.startswith("chunk"):
        fn = ksem.semantic_chunk_plain if plain else ksem.semantic_chunk_fused
        return fn(K1_CFG, p, logits0, kc, vc, ctx_len, arg, noise, 2.0, **kw)
    fn = kwin.coarse_window_plain if plain else kwin.coarse_window_fused
    return (fn(K1_CFG, p, logits0, kc, vc, ctx_len, arg, noise, **kw), None,
            None)


def _written(case, ctx_len, arg):
    """The cache rows a case's launch writes."""
    if case.startswith("chunk"):
        first = min(ctx_len + arg, K1_CFG.block_size - 1)
        return slice(first, min(ctx_len + arg + 16, K1_CFG.block_size))
    return slice(ctx_len, ctx_len + 60)


@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("weights", ["dense", "q8_0", "q4_0"])
@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_step_loop_against_plain_and_k1(dev, loop_weights, case, weights,
                                        cache):
    from bark_tpu_torch.kernels import qdecode

    p, quant = loop_weights[weights][torch.float32], cache == "int8"
    logits0, noise, kc, vc, kw, ctx_len, arg = _loop_inputs(
        dev, case, torch.float32, quant)
    kc2, vc2, kc3, vc3 = _clone(kc), _clone(vc), _clone(kc), _clone(vc)
    mod = ksem if case.startswith("chunk") else kwin
    counters = ((kdec, "loop_launches"), (qdecode, "loop_launches"),
                (kdec, "launches"), (qdecode, "launches"), (mod, "launches"))
    before = [getattr(m, c) for m, c in counters]
    t, f, lg = _loop_call(case, p, logits0, noise, kc, vc, kw, ctx_len, arg)
    torch.cuda.synchronize()
    dense = int(weights == "dense")
    # one launch of the step loop on its read; none of K1's or K5's own
    # step
    assert [getattr(m, c) - b for (m, c), b in zip(counters, before)] == [
        dense, 1 - dense, 0, 0, 1]
    rt, rf, rlg = _loop_call(case, p, logits0, noise, kc2, vc2, kw, ctx_len,
                             arg, plain=True)
    assert t.tolist() == rt.tolist()
    if f is not None:
        assert f.tolist() == rf.tolist()
        torch.testing.assert_close(lg, rlg, rtol=0,
                                   atol=KV8_ATOL if quant else ATOL)
    rows = _written(case, ctx_len, arg)
    for a, b in ((kc, kc2), (vc, vc2)):
        if quant:  # rows of chained steps: held as the int8 logits are
            _kv8_close({k: x[:, rows] for k, x in a.items()},
                       {k: x[:, rows] for k, x in b.items()}, KV8_ATOL)
        else:
            torch.testing.assert_close(a[:, rows], b[:, rows], rtol=0,
                                       atol=ATOL)
    # K1's (K5's) steps, one launch each, on the launch's tokens
    buf = logits0.clone()
    win = kw.get("lm_window")
    for j, tok in enumerate(t.tolist()):
        n_past = (min(ctx_len + arg + j, K1_CFG.block_size - 1)
                  if f is not None else ctx_len + j)
        kdec.decode_step_fused(K1_CFG, p, tok, kc3, vc3, n_past,
                               lm_window=win, out=buf)
    if f is not None:
        assert torch.equal(lg, buf)
    for a, b in ((kc, kc3), (vc, vc3)):
        for x, y in (zip(a.values(), b.values()) if quant else [(a, b)]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("weights", ["dense", "q4_0"])
@pytest.mark.parametrize("case", ["chunk", "window-odd"])
def test_step_loop_is_one_device_kernel_and_bit_equal(dev, loop_weights,
                                                      case, weights):
    """One device kernel a call (torch.profiler), and two bf16 runs give
    the same bits: tokens, flags, logits and caches."""
    from bark_tpu_torch.probes import prefill_profile

    p = loop_weights[weights][torch.bfloat16]
    logits0, noise, kc, vc, kw, ctx_len, arg = _loop_inputs(
        dev, case, torch.bfloat16, False)
    runs = []
    for _ in range(2):
        k, v = _clone(kc), _clone(vc)
        runs.append((*_loop_call(case, p, logits0, noise, k, v, kw, ctx_len,
                                 arg), k, v))
    for x, y in zip(*runs):
        assert (x is None and y is None) or torch.equal(x, y)
    torch.cuda.synchronize()
    names = [e.name for e in prefill_profile.profiled_call(
        lambda: _loop_call(case, p, logits0, noise, _clone(kc), _clone(vc),
                           kw, ctx_len, arg))
        if not e.name.startswith(("Memcpy", "Memset"))]
    loops = [n for n in names if "decode_steps_kernel" in n]
    assert len(loops) == 1 and not any(
        "sample_rows" in n or "decode_step_kernel" in n for n in names), names


def test_step_loop_stamps(dev, loop_weights):
    """A stamped launch gives the unstamped launch's tokens; every block's
    clock readings run forward and split into the loop's parts."""
    p = loop_weights["dense"][torch.bfloat16]
    logits0, noise, kc, vc, kw, ctx_len, arg = _loop_inputs(
        dev, "chunk", torch.bfloat16, False)
    plan, _ = kdec.device_plan(_build.stage_weights(K1_CFG, p), None)
    stamps = kdec.loop_stamps(plan, 16, dev)
    n_past0, clamp, sample = ksem.chunk_loop(K1_CFG, ctx_len, arg, 0.7,
                                             10000, 2.0)
    toks = torch.empty(16, dtype=torch.int32, device=dev)
    flags = torch.empty(16, dtype=torch.int32, device=dev)
    kdec.decode_steps_fused(K1_CFG, p, logits0.clone(), _clone(kc),
                            _clone(vc), n_past0, clamp, 16, sample, noise,
                            toks, flags, stamps=stamps)
    t, f, _ = _loop_call("chunk", p, logits0, noise, _clone(kc), _clone(vc),
                         kw, ctx_len, arg)
    assert toks.tolist() == t.tolist() and flags.tolist() == f.tolist()
    for row in stamps.tolist():
        assert all(x <= y for x, y in zip(row, row[1:])) and row[-1] > row[0]
    us = kdec.loop_phases_us(plan, stamps, 16)
    assert us["block0"]["step"] > 0
    assert us["launch_us"] >= us["block0"]["launch"]


def test_step_loop_refuses_what_it_does_not_take(dev, k1_params):
    p = k1_params[torch.float32]
    kc, vc = _k1_caches(dev, torch.float32, 40, False)
    V = K1_CFG.n_out_vocab
    toks = torch.empty(4, dtype=torch.int32, device=dev)
    before = kdec.launches, kdec.loop_launches
    with pytest.raises(ValueError, match="noise"):  # rows too narrow
        kdec.decode_steps_fused(
            K1_CFG, p, torch.zeros(V, device=dev), kc, vc, 40, 1023, 4,
            kdec.LoopSample(0.7, stop_token=10000),
            torch.zeros((4, V - 1), device=dev), toks, toks)
    with pytest.raises(ValueError, match="flag_out"):  # K3 without flags
        kdec.decode_steps_fused(
            K1_CFG, p, torch.zeros(V, device=dev), kc, vc, 40, 1023, 4,
            kdec.LoopSample(0.0, stop_token=10000), None, toks)
    assert (kdec.launches, kdec.loop_launches) == before


def test_packed_wrapper_refuses_what_the_kernel_does_not_take(dev, qpack):
    kc, vc = gpt.init_kv_cache(QCFG, torch.float32, dev)
    bad = {**qpack, "wte_s": qpack["wte_s"].to(torch.bfloat16)}
    with pytest.raises(ValueError):  # scales neither f16 nor f32
        kdec.decode_step_fused(QCFG, bad, 1, kc, vc, 0)
    blocks = dict(qpack["blocks"])
    blocks["qkv_q"] = torch.empty(blocks["qkv_q"].numel() + 1,
                                  dtype=torch.int8, device=dev)[1:].view(
        blocks["qkv_q"].shape)
    with pytest.raises(ValueError):  # not 16-byte aligned
        kdec.decode_step_fused(QCFG, {**qpack, "blocks": blocks}, 1, kc, vc,
                               0)
    fine = {k: v for k, v in qpack.items() if not k.startswith("lm_")}
    with pytest.raises(ValueError):  # no single LM head tile
        kdec.decode_step_fused(QCFG, fine, 1, kc, vc, 0)


# ------------------------------------------------------- K7-K10 (batched)


def _bcaches(dev, B, rows):
    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev, batch=B)
    g = torch.Generator(device=dev).manual_seed(B)
    kc[:, :, :rows] = torch.randn(kc[:, :, :rows].shape, generator=g,
                                  device=dev)
    vc[:, :, :rows] = torch.randn(vc[:, :, :rows].shape, generator=g,
                                  device=dev)
    return kc, vc


@pytest.mark.parametrize("B", [1, 3, 8, 32])
@pytest.mark.parametrize("win", [None, (32, 160)], ids=["head", "window"])
def test_batched_decode_kernel(dev, params, B, win):
    from bark_tpu_torch.kernels import bdecode as kbdec

    n_past = [(0, 40, 511)[b % 3] for b in range(B)]
    toks = [(17 + 7 * b) % CFG.n_in_vocab for b in range(B)]
    kc, vc = _bcaches(dev, B, 511)
    kc2, vc2 = kc.clone(), vc.clone()
    before = kbdec.launches
    out = kbdec.decode_step_fused_batched(CFG, params, toks, kc, vc, n_past,
                                          lm_window=win)
    assert kbdec.launches == before + 1
    ref = kbdec.decode_step_batched_plain(CFG, params, toks, kc2, vc2,
                                          n_past, win)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(kc, kc2, rtol=0, atol=ATOL)
    torch.testing.assert_close(vc, vc2, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_valid,win", [([257, 300, 1, 512], None),
                                         ([64, 17], (32, 160)),
                                         ([(257, 300, 1, 512, 64)[b % 5]
                                           for b in range(32)], (32, 160))])
def test_batched_prefill_kernel(dev, params, n_valid, win):
    from bark_tpu_torch.kernels import bprefill as kbpre

    B, T = len(n_valid), max(n_valid)
    idx = torch.arange(B * T, device=dev) % CFG.n_in_vocab
    x = params["wte"][0][idx].reshape(B, T, CFG.n_embd)
    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev, batch=B)
    kc2, vc2 = kc.clone(), vc.clone()
    out = kbpre.prefill_fused_batched(CFG, params, x, kc, vc, n_valid,
                                      lm_window=win)
    ref = kbpre.prefill_batched_plain(CFG, params, x, kc2, vc2, n_valid, win)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    for b, n in enumerate(n_valid):
        torch.testing.assert_close(kc[:, b, :n], kc2[:, b, :n], rtol=0,
                                   atol=ATOL)
        torch.testing.assert_close(vc[:, b, :n], vc2[:, b, :n], rtol=0,
                                   atol=ATOL)
        assert not kc[:, b, n:].any()  # dead rows are not written


@pytest.mark.parametrize("B", [4, 32])
@pytest.mark.parametrize("temp,min_eos_p", [(0.7, 2.0), (0.7, 0.006),
                                            (0.0, 2.0)])
def test_batched_semantic_chunk_kernel(dev, params, temp, min_eos_p, B):
    from bark_tpu_torch.kernels import bsemantic as kbsem

    gen = torch.Generator(device=dev).manual_seed(4)
    noise = sampling.gumbel((B, 16, CFG.n_out_vocab), gen, dev)
    kc, vc = _bcaches(dev, B, 40)
    kc2, vc2 = kc.clone(), vc.clone()
    logits0 = torch.randn(B, CFG.n_out_vocab, generator=gen, device=dev) * 2
    args = (40, 3, noise, min_eos_p)
    kw = dict(K=8, temp=temp, semantic_vocab_size=150)
    t, f, lg = kbsem.semantic_chunk_fused_batched(CFG, params, logits0, kc,
                                                  vc, *args, **kw)
    rt, rf, rlg = kbsem.semantic_chunk_batched_plain(CFG, params, logits0,
                                                     kc2, vc2, *args, **kw)
    assert t.tolist() == rt.tolist() and f.tolist() == rf.tolist()
    torch.testing.assert_close(lg, rlg, rtol=0, atol=ATOL)
    torch.testing.assert_close(kc[:, :, 43:51], kc2[:, :, 43:51], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("B", [4, 32])
@pytest.mark.parametrize("temp,step0", [(0.7, 0), (0.7, 1), (0.0, 0)])
def test_batched_coarse_window_kernel(dev, params, temp, step0, B):
    from bark_tpu_torch.kernels import bwindow as kbwin

    ctx_len = [(40, 41, 100, 7)[b % 4] for b in range(B)]
    gen = torch.Generator(device=dev).manual_seed(5)
    noise = sampling.gumbel((10, B, 64), gen, dev)
    kc, vc = _bcaches(dev, B, 100)
    kc2, vc2 = kc.clone(), vc.clone()
    logits0 = torch.randn(B, CFG.n_out_vocab, generator=gen, device=dev) * 2
    kw = dict(sws=10, temp=temp, semantic_vocab_size=32, codebook_size=64,
              lm_window=(32, 160))
    t = kbwin.coarse_window_fused_batched(CFG, params, logits0, kc, vc,
                                          ctx_len, step0, noise, **kw)
    rt = kbwin.coarse_window_batched_plain(CFG, params, logits0, kc2, vc2,
                                           ctx_len, step0, noise, **kw)
    assert t.tolist() == rt.tolist()
    for b, c in enumerate(ctx_len):
        torch.testing.assert_close(vc[:, b, c:c + 10], vc2[:, b, c:c + 10],
                                   rtol=0, atol=ATOL)


def test_batched_wrappers_refuse_what_the_kernels_do_not_take(dev, params):
    from bark_tpu_torch.io import loader
    from bark_tpu_torch.kernels import bdecode as kbdec

    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev, batch=33)
    with pytest.raises(ValueError):  # more lanes than the kernel takes
        kbdec.decode_step_fused_batched(CFG, params, [1] * 33, kc, vc,
                                        [0] * 33)
    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev, batch=2)
    with pytest.raises(ValueError):  # n_past outside the cache
        kbdec.decode_step_fused_batched(CFG, params, [1, 2], kc, vc,
                                        [0, CFG.block_size])
    _, qp = loader.gpt_qparams_from_section(_qsection("Q8_0"), torch.float32,
                                            dev)
    # a qpack K5-batched does not take: the wrapper raises and nothing
    # launches, dense K7 included
    before = kernels.launch_counts()
    bad = {**qp, "wte_s": qp["wte_s"].to(torch.bfloat16)}
    with pytest.raises(ValueError, match="scales"):
        kbdec.decode_step_fused_batched(QCFG, bad, [1, 2], kc, vc, [0, 0])
    fine = dataclasses.replace(QCFG, n_lm_heads=7)
    with pytest.raises(ValueError, match="n_lm_heads"):
        kbdec.decode_step_fused_batched(fine, qp, [1, 2], kc, vc, [0, 0])
    assert kernels.launch_counts() == before


# --------------------------------------------------------- K6 (int8 KV)
# Kernel and plain version quantize fresh K/V rows computed in another
# summation order (values ATOL apart at most, as the dense tests hold
# them), so a value next to a rounding boundary may land one int8 step
# apart: the bytes may differ by 1 at no more than 0.1% of the values (at
# least one), the scales (a row's amax / 127) within ATOL / 127, and the
# logits within 3e-3, the JAX package's own kernel-vs-XLA bound for the
# int8 cache (tests/test_kv_quant.py); tokens equal.

KV8_ATOL = 3e-3


def _kv8_caches(dev, rows, batch=None):
    """Int8 caches whose rows [0, rows) (of every lane) hold random rows
    quantized by the plain `gpt.quantize_kv_rows`."""
    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev, batch=batch,
                               quant=True)
    g = torch.Generator(device=dev).manual_seed(rows + 7 * (batch or 0))
    for c in (kc, vc):
        live = c["q"][..., :rows, :]
        q, s = gpt.quantize_kv_rows(torch.randn(live.shape, generator=g,
                                                device=dev))
        c["q"][..., :rows, :], c["s"][..., :rows] = q, s
    return kc, vc


def _kv8_clone(c):
    return {k: v.clone() for k, v in c.items()}


def _kv8_close(a, b, atol=ATOL):
    """Int8 caches equal but for rare one-step flips; scales within
    atol / 127 (atol: the tolerance of the fresh rows they quantize)."""
    diff = (a["q"].int() - b["q"].int()).abs()
    assert int(diff.max()) <= 1
    assert int((diff > 0).sum()) <= max(1, int(1e-3 * diff.numel()))
    torch.testing.assert_close(a["s"], b["s"], rtol=0, atol=atol / 127)


@pytest.mark.parametrize("n_past,win", [(0, None), (40, None), (511, None),
                                        (40, (32, 160))])
def test_kv8_decode_kernel(dev, params, n_past, win):
    kc, vc = _kv8_caches(dev, n_past)
    kc2, vc2 = _kv8_clone(kc), _kv8_clone(vc)
    before, k6 = kdec.launches, kv8.launches
    out = kdec.decode_step_fused(CFG, params, 17, kc, vc, n_past,
                                 lm_window=win)
    assert kdec.launches == before + 1 and kv8.launches == k6 + 1
    ref = kdec.decode_step_plain(CFG, params, 17, kc2, vc2, n_past, win)
    torch.testing.assert_close(out, ref, rtol=0, atol=KV8_ATOL)
    assert int(out.argmax()) == int(ref.argmax())
    _kv8_close(kc, kc2)
    _kv8_close(vc, vc2)


def test_kv8_packed_decode_kernel(dev, qpack):
    from bark_tpu_torch.kernels import qdecode

    kc, vc = _kv8_caches(dev, 40)
    kc2, vc2 = _kv8_clone(kc), _kv8_clone(vc)
    before = qdecode.launches
    out = kdec.decode_step_fused(QCFG, qpack, 17, kc, vc, 40)
    assert qdecode.launches == before + 1
    ref = kdec.decode_step_plain(QCFG, qpack, 17, kc2, vc2, 40)
    torch.testing.assert_close(out, ref, rtol=0, atol=KV8_ATOL)
    _kv8_close(kc, kc2)
    _kv8_close(vc, vc2)


@pytest.mark.parametrize("T,n_valid", [(257, 257), (384, 300), (512, 1)])
def test_kv8_prefill_kernel(dev, params, T, n_valid):
    x = params["wte"][0][:T].contiguous()
    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev, quant=True)
    kc2, vc2 = _kv8_clone(kc), _kv8_clone(vc)
    before, k6 = kpre.launches, kv8.launches
    out = kpre.prefill_fused(CFG, params, x, kc, vc, n_valid)
    assert kpre.launches == before + 1 and kv8.launches == k6 + 1
    ref = kpre.prefill_plain(CFG, params, x, kc2, vc2, n_valid)
    torch.testing.assert_close(out, ref, rtol=0, atol=KV8_ATOL)
    _kv8_close(kc, kc2)
    _kv8_close(vc, vc2)
    assert not kc["q"][:, n_valid:].any()  # dead rows are not written
    assert not kc["s"][:, n_valid:].any()


def test_kv8_chunk_and_window_kernels(dev, params):
    gen = torch.Generator(device=dev).manual_seed(8)
    noise = sampling.gumbel((16, CFG.n_out_vocab), gen, dev)
    logits0 = torch.randn(CFG.n_out_vocab, generator=gen, device=dev) * 2
    kc, vc = _kv8_caches(dev, 40)
    kc2, vc2 = _kv8_clone(kc), _kv8_clone(vc)
    kw = dict(K=8, temp=0.7, semantic_vocab_size=150)
    t, f, lg = ksem.semantic_chunk_fused(CFG, params, logits0, kc, vc, 40, 0,
                                         noise, 2.0, **kw)
    rt, rf, rlg = ksem.semantic_chunk_plain(CFG, params, logits0, kc2, vc2,
                                            40, 0, noise, 2.0, **kw)
    assert t.tolist() == rt.tolist() and f.tolist() == rf.tolist()
    torch.testing.assert_close(lg, rlg, rtol=0, atol=KV8_ATOL)
    kw = dict(sws=10, temp=0.7, semantic_vocab_size=32, codebook_size=64,
              lm_window=(32, 160))
    t = kwin.coarse_window_fused(CFG, params, logits0, kc, vc, 60, 1,
                                 noise[:10, :64], **kw)
    rt = kwin.coarse_window_plain(CFG, params, logits0, kc2, vc2, 60, 1,
                                  noise[:10, :64], **kw)
    assert t.tolist() == rt.tolist()
    _kv8_close(kc, kc2)
    _kv8_close(vc, vc2)


@pytest.mark.parametrize("B", [1, 3, 8, 32])
@pytest.mark.parametrize("win", [None, (32, 160)], ids=["head", "window"])
def test_kv8_batched_decode_kernel(dev, params, B, win):
    from bark_tpu_torch.kernels import bdecode as kbdec

    n_past = [(0, 40, 511)[b % 3] for b in range(B)]
    toks = [(17 + 7 * b) % CFG.n_in_vocab for b in range(B)]
    kc, vc = _kv8_caches(dev, 511, batch=B)
    kc2, vc2 = _kv8_clone(kc), _kv8_clone(vc)
    k6 = kv8.launches
    out = kbdec.decode_step_fused_batched(CFG, params, toks, kc, vc, n_past,
                                          lm_window=win)
    assert kv8.launches == k6 + 1
    ref = kbdec.decode_step_batched_plain(CFG, params, toks, kc2, vc2,
                                          n_past, win)
    torch.testing.assert_close(out, ref, rtol=0, atol=KV8_ATOL)
    _kv8_close(kc, kc2)
    _kv8_close(vc, vc2)


@pytest.mark.parametrize("n_valid,win", [([257, 300, 1, 512], None),
                                         ([(257, 300, 1, 512, 64)[b % 5]
                                           for b in range(32)], (32, 160))])
def test_kv8_batched_prefill_kernel(dev, params, n_valid, win):
    from bark_tpu_torch.kernels import bprefill as kbpre

    B, T = len(n_valid), max(n_valid)
    idx = torch.arange(B * T, device=dev) % CFG.n_in_vocab
    x = params["wte"][0][idx].reshape(B, T, CFG.n_embd)
    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev, batch=B, quant=True)
    kc2, vc2 = _kv8_clone(kc), _kv8_clone(vc)
    out = kbpre.prefill_fused_batched(CFG, params, x, kc, vc, n_valid,
                                      lm_window=win)
    ref = kbpre.prefill_batched_plain(CFG, params, x, kc2, vc2, n_valid, win)
    torch.testing.assert_close(out, ref, rtol=0, atol=KV8_ATOL)
    _kv8_close(kc, kc2)
    _kv8_close(vc, vc2)
    for b, n in enumerate(n_valid):
        assert not kc["q"][:, b, n:].any()  # dead rows are not written


# K2 and K8 in bf16 on the TMA + wgmma GEMM and the tensor-core attention:
# at bark-small's width (K1_CFG: 12 heads of 64, width 768, 1024 slots),
# T / n_valid at and around the 64-row tiles and the request's rows, with
# bark-large's width (16 heads) and the small model's (2) beside it; dense
# and int8 caches (K6b and K6c over the new GEMM). Logits and live cache
# rows (int8 ones dequantized) within bf16's 1e-1 of the plain version,
# logits and caches bit-equal from run to run, rows past n_valid unwritten.

BF16_CFGS = {
    "w768": K1_CFG,
    "w1024": dataclasses.replace(K1_CFG, n_layer=1, n_head=16, n_embd=1024),
    "w128": dataclasses.replace(CFG, block_size=1024),
}
BF16_TOL = 1e-1


@pytest.fixture(scope="module")
def bf16_params(dev, k1_params):
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {"w768": k1_params[torch.bfloat16]}
    for name in ("w1024", "w128"):
        p = gpt.init_params(BF16_CFGS[name], gen, torch.bfloat16, dev)
        for k, v in p["blocks"].items():
            if k.endswith("_b") or k.endswith("_g"):
                v.add_(0.02 * torch.randn(v.shape, generator=gen,
                                          device=dev).to(torch.bfloat16))
        out[name] = p
    return out


def _live_rows(c, rows):
    """A cache's rows `rows` (a tuple of indices) in f32, int8 ones
    dequantized."""
    if isinstance(c, dict):
        return c["q"][rows].float() * c["s"][rows][..., None]
    return c[rows].float()


def _unwritten(c, rows):
    for t in (c.values() if isinstance(c, dict) else [c]):
        assert not t[rows].any()


def _bit_equal(a, b):
    if isinstance(a, dict):
        return all(torch.equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("name,T,n_valid", [
    *[("w768", t, t) for t in (1, 63, 64, 65, 129, 257, 617, 887, 1024)],
    ("w768", 700, 333), ("w1024", 384, 300), ("w1024", 257, 257),
    ("w128", 384, 300), ("w128", 65, 65)])
def test_bf16_prefill_kernel(dev, bf16_params, name, T, n_valid, cache):
    cfg, p = BF16_CFGS[name], bf16_params[name]
    quant = cache == "int8"
    win = (cfg.n_out_vocab // 2, cfg.n_out_vocab - 7) if n_valid % 2 else None
    g = torch.Generator(device=dev).manual_seed(T)
    x = p["wte"][0][torch.randint(0, cfg.n_in_vocab, (T,), generator=g,
                                  device=dev)]
    runs = []
    for _ in range(2):
        kc, vc = gpt.init_kv_cache(cfg, torch.bfloat16, dev, quant=quant)
        before, k6 = kpre.launches, kv8.launches
        out = kpre.prefill_fused(cfg, p, x, kc, vc, n_valid, lm_window=win)
        torch.cuda.synchronize()
        assert kpre.launches == before + 1
        assert kv8.launches == k6 + quant
        runs.append((out, kc, vc))
    (out, kc, vc), (out2, kc_2, vc_2) = runs
    assert torch.equal(out, out2)
    assert _bit_equal(kc, kc_2) and _bit_equal(vc, vc_2)
    kc2, vc2 = gpt.init_kv_cache(cfg, torch.bfloat16, dev, quant=quant)
    ref = kpre.prefill_plain(cfg, p, x, kc2, vc2, n_valid, win)
    torch.testing.assert_close(out, ref, rtol=0, atol=BF16_TOL)
    live = (slice(None), slice(0, n_valid))
    for a, b in ((kc, kc2), (vc, vc2)):
        torch.testing.assert_close(_live_rows(a, live), _live_rows(b, live),
                                   rtol=0, atol=BF16_TOL)
        _unwritten(a, (slice(None), slice(n_valid, None)))


@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("n_valid,win", [
    ([1, 65, 300, 887], None),
    ([64, 129, 1024, 63, 617, 257, 1, 128], K1_WIN)], ids=["4", "8"])
def test_bf16_batched_prefill_kernel(dev, bf16_params, n_valid, win, cache):
    from bark_tpu_torch.kernels import bprefill as kbpre

    p, quant = bf16_params["w768"], cache == "int8"
    B, T = len(n_valid), max(n_valid)
    g = torch.Generator(device=dev).manual_seed(B)
    x = p["wte"][0][torch.randint(0, K1_CFG.n_in_vocab, (B, T), generator=g,
                                  device=dev)]
    runs = []
    for _ in range(2):
        kc, vc = gpt.init_kv_cache(K1_CFG, torch.bfloat16, dev, batch=B,
                                   quant=quant)
        before = kbpre.launches
        out = kbpre.prefill_fused_batched(K1_CFG, p, x, kc, vc, n_valid,
                                          lm_window=win)
        torch.cuda.synchronize()
        assert kbpre.launches == before + 1
        runs.append((out, kc, vc))
    (out, kc, vc), (out2, kc_2, vc_2) = runs
    assert torch.equal(out, out2)
    assert _bit_equal(kc, kc_2) and _bit_equal(vc, vc_2)
    kc2, vc2 = gpt.init_kv_cache(K1_CFG, torch.bfloat16, dev, batch=B,
                                 quant=quant)
    ref = kbpre.prefill_batched_plain(K1_CFG, p, x, kc2, vc2, n_valid, win)
    torch.testing.assert_close(out, ref, rtol=0, atol=BF16_TOL)
    for b, n in enumerate(n_valid):
        live = (slice(None), b, slice(0, n))
        for a, c in ((kc, kc2), (vc, vc2)):
            torch.testing.assert_close(_live_rows(a, live),
                                       _live_rows(c, live), rtol=0,
                                       atol=BF16_TOL)
            _unwritten(a, (slice(None), b, slice(n, None)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lanes", [1, 63, 64, 65, 257, 887, 1024,
                                   [887, 257, 600, 431, 1, 64, 65, 1024]])
def test_kv8_attn_prefill_alone(dev, lanes, dtype):
    """K6c alone (`kv8.attn_prefill`, one layer at bark-small's width)
    against its plain version on the same rows: the context within
    KV8_ATOL (f32), or in bf16 element by element within 2^-6 |plain| +
    2e-3 (a couple of bf16 ulps: scores are bit-equal and weights and
    context round at the same points), bf16 bit-equal run to run; on the
    bf16 cache the dense attention against its plain version the same
    way."""
    cfg = dataclasses.replace(K1_CFG, n_layer=1)
    one = isinstance(lanes, int)
    ns = [lanes] if one else lanes
    S, D = cfg.block_size, cfg.n_embd
    g = torch.Generator(device=dev).manual_seed(len(ns) * 1000 + ns[0])
    kc, vc = ({"q": torch.zeros((len(ns), S, D), dtype=torch.int8,
                                device=dev),
               "s": torch.zeros((len(ns), S), device=dev)} for _ in range(2))
    for c in (kc, vc):
        for b, n in enumerate(ns):
            c["q"][b, :n], c["s"][b, :n] = gpt.quantize_kv_rows(
                torch.randn((n, D), generator=g, device=dev))
    if one:
        kc, vc = ({k: v[0] for k, v in c.items()} for c in (kc, vc))
    q = torch.randn((sum(ns), D), generator=g, device=dev).to(dtype)
    rtol, atol = (0, KV8_ATOL) if dtype == torch.float32 else (2 ** -6, 2e-3)
    for k, v in ((kc, vc), tuple((c["q"].float() * c["s"][..., None]).to(
            dtype) for c in (kc, vc))):
        out = kv8.attn_prefill(cfg, q, k, v, lanes)
        ref = kv8.attn_prefill_plain(cfg, q, k, v, lanes)
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                   atol=atol)
        if dtype == torch.bfloat16:
            assert torch.equal(out, kv8.attn_prefill(cfg, q, k, v, lanes))


def test_bf16_prefill_refuses_misaligned_weights(dev, bf16_params):
    """A projection weight the GEMM's tensor maps cannot read in place (not
    16-byte aligned) is refused before any launch."""
    cfg, p = BF16_CFGS["w128"], dict(bf16_params["w128"])
    w = p["blocks"]["fc_w"]
    buf = torch.empty(w.numel() + 1, dtype=w.dtype, device=dev)
    moved = buf[1:].view(w.shape)
    moved.copy_(w)
    p["blocks"] = {**p["blocks"], "fc_w": moved}
    kc, vc = gpt.init_kv_cache(cfg, torch.bfloat16, dev)
    before = kpre.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        kpre.prefill_fused(cfg, p, p["wte"][0][:8], kc, vc, 8)
    assert kpre.launches == before and not kc.any()


@pytest.mark.parametrize("B", [4, 32])
def test_kv8_batched_chunk_and_window_kernels(dev, params, B):
    from bark_tpu_torch.kernels import bsemantic as kbsem
    from bark_tpu_torch.kernels import bwindow as kbwin

    gen = torch.Generator(device=dev).manual_seed(9)
    noise = sampling.gumbel((B, 16, CFG.n_out_vocab), gen, dev)
    logits0 = torch.randn(B, CFG.n_out_vocab, generator=gen, device=dev) * 2
    kc, vc = _kv8_caches(dev, 100, batch=B)
    kc2, vc2 = _kv8_clone(kc), _kv8_clone(vc)
    kw = dict(K=8, temp=0.7, semantic_vocab_size=150)
    t, f, lg = kbsem.semantic_chunk_fused_batched(
        CFG, params, logits0, kc, vc, 40, 3, noise, 2.0, **kw)
    rt, rf, rlg = kbsem.semantic_chunk_batched_plain(
        CFG, params, logits0, kc2, vc2, 40, 3, noise, 2.0, **kw)
    assert t.tolist() == rt.tolist() and f.tolist() == rf.tolist()
    torch.testing.assert_close(lg, rlg, rtol=0, atol=KV8_ATOL)
    ctx_len = [(60, 61, 100, 7)[b % 4] for b in range(B)]
    wnoise = noise[:, :10, :64].transpose(0, 1).contiguous()
    kw = dict(sws=10, temp=0.7, semantic_vocab_size=32, codebook_size=64,
              lm_window=(32, 160))
    t = kbwin.coarse_window_fused_batched(CFG, params, logits0, kc, vc,
                                          ctx_len, 1, wnoise, **kw)
    rt = kbwin.coarse_window_batched_plain(CFG, params, logits0, kc2, vc2,
                                           ctx_len, 1, wnoise, **kw)
    assert t.tolist() == rt.tolist()
    _kv8_close(kc, kc2)
    _kv8_close(vc, vc2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "dense"])
def test_attn_decode_kernel_alone(dev, dtype, quant):
    """K6a (and the dense attention kernel) on the same qkv rows as the
    plain version: the fresh rows bit-equal, the context within ATOL (f32)
    or 2e-2 (bf16: the weights round to bf16 after another softmax sum)."""
    B, D = 5, CFG.n_embd
    n_past = [0, 40, 511, 7, 300]
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn((B, 3 * D), generator=g, device=dev).to(dtype)
    if quant:
        kc, vc = _kv8_caches(dev, 511, batch=B)
        kc, vc = gpt.kv_view(kc, 0), gpt.kv_view(vc, 0)
    else:
        kc, vc = (torch.randn((B, CFG.block_size, D), generator=g,
                              device=dev).to(dtype) for _ in range(2))
    clone = _kv8_clone if quant else torch.clone
    kc2, vc2 = clone(kc), clone(vc)
    ctx = kv8.attn_decode(CFG, qkv, kc, vc, n_past)
    ref = kv8.attn_decode_plain(CFG, qkv, kc2, vc2, n_past)
    atol = ATOL if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(ctx.float(), ref.float(), rtol=0, atol=atol)
    for a, b in ((kc, kc2), (vc, vc2)):
        for x, y in zip(*((t.values() if quant else [t]) for t in (a, b))):
            assert torch.equal(x, y)
    with pytest.raises(ValueError):  # n_past past the cache
        kv8.attn_decode(CFG, qkv, kc, vc, [0, 0, 0, 0, CFG.block_size])


def test_kv8_wrappers_refuse_a_malformed_int8_cache(dev, params):
    from bark_tpu_torch.kernels import bdecode as kbdec

    kc, vc = gpt.init_kv_cache(CFG, torch.float32, dev, quant=True)
    dense_k, _ = gpt.init_kv_cache(CFG, torch.float32, dev)
    bad = [
        ({**kc, "q": kc["q"].to(torch.uint8)}, vc),       # values not int8
        ({**kc, "q": kc["q"].float()}, vc),                # values not int8
        ({**kc, "q": kc["q"][:, :-1].contiguous()}, vc),   # rows short
        ({**kc, "s": kc["s"].half()}, vc),                 # scales not f32
        ({**kc, "s": kc["s"][:, :-1].contiguous()}, vc),   # scale shape
        ({**kc, "s": kc["s"].t().contiguous().t()}, vc),   # not contiguous
        ({"q": kc["q"]}, vc),                              # no scales
        (dense_k, vc),                                     # dense k, int8 v
    ]
    for k, v in bad:
        with pytest.raises(ValueError):
            kdec.decode_step_fused(CFG, params, 1, k, v, 0)
        with pytest.raises(ValueError):
            kpre.prefill_fused(CFG, params, params["wte"][0][:8], k, v, 8)
    kb, vb = gpt.init_kv_cache(CFG, torch.float32, dev, batch=2, quant=True)
    with pytest.raises(ValueError):  # lanes' scales of another batch
        kbdec.decode_step_fused_batched(
            CFG, params, [1, 2], {**kb, "s": kb["s"][:, :1].contiguous()},
            vb, [0, 0])


# ------------------------------------------------ K5-batched (packed K7)


@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("B", [1, 3, 8, 32])
@pytest.mark.parametrize("win", [None, (32, 160)], ids=["head", "window"])
def test_packed_batched_decode_kernel(dev, qpack, B, win, cache):
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import qbdecode

    n_past = [(0, 40, 511)[b % 3] for b in range(B)]
    toks = [(17 + 7 * b) % QCFG.n_in_vocab for b in range(B)]
    if cache == "int8":
        kc, vc = _kv8_caches(dev, 511, batch=B)
        kc2, vc2 = _kv8_clone(kc), _kv8_clone(vc)
    else:
        kc, vc = _bcaches(dev, B, 511)
        kc2, vc2 = kc.clone(), vc.clone()
    before, dense_before = qbdecode.launches, kbdec.launches
    k6 = kv8.launches
    out = kbdec.decode_step_fused_batched(QCFG, qpack, toks, kc, vc, n_past,
                                          lm_window=win)
    assert qbdecode.launches == before + 1 and kbdec.launches == dense_before
    assert kv8.launches == k6 + (cache == "int8")
    ref = kbdec.decode_step_batched_plain(QCFG, qpack, toks, kc2, vc2,
                                          n_past, win)
    if cache == "int8":
        torch.testing.assert_close(out, ref, rtol=0, atol=KV8_ATOL)
        _kv8_close(kc, kc2)
        _kv8_close(vc, vc2)
    else:
        torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
        torch.testing.assert_close(kc, kc2, rtol=0, atol=ATOL)
        torch.testing.assert_close(vc, vc2, rtol=0, atol=ATOL)
    if win is not None:
        assert not out[:, :win[0]].any() and not out[:, win[1]:].any()


@pytest.mark.parametrize("B", [4, 32])
def test_packed_batched_chunk_and_window_kernels(dev, qpack, B):
    from bark_tpu_torch.kernels import bsemantic as kbsem
    from bark_tpu_torch.kernels import bwindow as kbwin
    from bark_tpu_torch.kernels import qbdecode

    gen = torch.Generator(device=dev).manual_seed(11)
    noise = sampling.gumbel((B, 16, QCFG.n_out_vocab), gen, dev)
    logits0 = torch.randn(B, QCFG.n_out_vocab, generator=gen, device=dev) * 2
    kc, vc = _bcaches(dev, B, 100)
    kc2, vc2 = kc.clone(), vc.clone()
    before = qbdecode.loop_launches, qbdecode.launches
    kw = dict(K=8, temp=0.7, semantic_vocab_size=150)
    t, f, lg = kbsem.semantic_chunk_fused_batched(
        QCFG, qpack, logits0, kc, vc, 40, 3, noise, 2.0, **kw)
    rt, rf, rlg = kbsem.semantic_chunk_batched_plain(
        QCFG, qpack, logits0, kc2, vc2, 40, 3, noise, 2.0, **kw)
    assert t.tolist() == rt.tolist() and f.tolist() == rf.tolist()
    torch.testing.assert_close(lg, rlg, rtol=0, atol=ATOL)
    ctx_len = [(60, 61, 100, 7)[b % 4] for b in range(B)]
    wnoise = noise[:, :10, :64].transpose(0, 1).contiguous()
    kw = dict(sws=10, temp=0.7, semantic_vocab_size=32, codebook_size=64,
              lm_window=(32, 160))
    t = kbwin.coarse_window_fused_batched(QCFG, qpack, logits0, kc, vc,
                                          ctx_len, 1, wnoise, **kw)
    rt = kbwin.coarse_window_batched_plain(QCFG, qpack, logits0, kc2, vc2,
                                           ctx_len, 1, wnoise, **kw)
    assert t.tolist() == rt.tolist()
    # one launch of the packed step loop a chunk or window, none of the step
    assert (qbdecode.loop_launches, qbdecode.launches) == (before[0] + 2,
                                                           before[1])
    for b, c in enumerate(ctx_len):
        torch.testing.assert_close(vc[:, b, c:c + 10], vc2[:, b, c:c + 10],
                                   rtol=0, atol=ATOL)


# ------------------------------- K7 / K5-batched at bark-small's width

LANE_BS = (1, 3, 8, 32)


def _lane_caches(dev, dtype, B, quant):
    """(L, B, S, D) caches of K1_CFG, rows [0, 1023) of every lane drawn
    (int8 through the plain quantizer)."""
    g = torch.Generator(device=dev).manual_seed(100 + B)
    kc, vc = gpt.init_kv_cache(K1_CFG, dtype, dev, quant=quant, batch=B)
    for c in (kc, vc):
        live = torch.randn((K1_CFG.n_layer, B, 1023, K1_CFG.n_embd),
                           generator=g, device=dev)
        if quant:
            c["q"][:, :, :1023], c["s"][:, :, :1023] = \
                gpt.quantize_kv_rows(live)
        else:
            c[:, :, :1023] = live.to(dtype)
    return kc, vc


def _lane_row(c, b, n):
    """Lane b's row n of every layer of a batched cache (dense, or int8
    values and scales)."""
    if isinstance(c, dict):
        return {k: t[:, b, n:n + 1] for k, t in c.items()}
    return c[:, b, n:n + 1]


@pytest.mark.parametrize("B", LANE_BS)
@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("weights", ["dense", *QFORMS])
def test_lane_step(dev, k1_params, k5_qpacks, weights, dtype, cache, B):
    """One launch of the batched step (K7, or K5-batched on a qpack of
    each scale form) for lanes at n_past 0, 300, 1023 and 887 (B = 3 on
    the coarse window) against the plain version: f32 within 2e-3 (lanes
    at n_past 0 on the int8 cache within 5e-2, as K1's), bf16 within 1e-1;
    each lane's fresh cache rows likewise (int8 in f32: one-step flips,
    scales within 2e-3 / 127)."""
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import qbdecode

    p = (k1_params[dtype] if weights == "dense"
         else k5_qpacks[(weights, dtype)])
    quant = cache == "int8"
    n_past = [(0, 300, 1023, 887)[b % 4] for b in range(B)]
    toks = [(17 + 101 * b) % K1_CFG.n_in_vocab for b in range(B)]
    win = K1_WIN if B == 3 else None
    kc, vc = _lane_caches(dev, dtype, B, quant)
    kc2, vc2 = _clone(kc), _clone(vc)
    counts = kbdec.launches, qbdecode.launches
    out = kbdec.decode_step_fused_batched(K1_CFG, p, toks, kc, vc, n_past,
                                          lm_window=win)
    torch.cuda.synchronize()
    packed = weights != "dense"
    assert (kbdec.launches, qbdecode.launches) == (
        counts[0] + (not packed), counts[1] + packed)
    ref = kbdec.decode_step_batched_plain(K1_CFG, p, toks, kc2, vc2, n_past,
                                          win)
    for b, n in enumerate(n_past):
        if dtype == torch.bfloat16:
            tol = 1e-1
        else:
            tol = (5e-2 if n == 0 else KV8_ATOL) if quant else 2e-3
        torch.testing.assert_close(out[b], ref[b], rtol=0, atol=tol)
        for a, c in ((kc, kc2), (vc, vc2)):
            ra, rc = _lane_row(a, b, n), _lane_row(c, b, n)
            if quant and dtype == torch.bfloat16:  # dequantized, as K1's
                torch.testing.assert_close(
                    ra["q"].float() * ra["s"][..., None],
                    rc["q"].float() * rc["s"][..., None], rtol=0, atol=tol)
            elif not quant:
                torch.testing.assert_close(ra.float(), rc.float(), rtol=0,
                                           atol=tol)
    if quant and dtype == torch.float32:  # every lane's fresh rows at once
        for a, c in ((kc, kc2), (vc, vc2)):
            _kv8_close(*({k: torch.cat([_lane_row(x, b, n)[k]
                                        for b, n in enumerate(n_past)], 1)
                          for k in ("q", "s")} for x in (a, c)), atol=2e-3)
    if win is not None:
        assert not out[:, :win[0]].any() and not out[:, win[1]:].any()


@pytest.mark.parametrize("B", [8, 32])
@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("weights", ["dense", "f16", "f32-mins"])
def test_lane_step_is_bit_equal_run_to_run_and_stamped(dev, k1_params,
                                                       k5_qpacks, weights,
                                                       cache, B):
    """In bf16 the plan's fixed fold order gives the same logits and
    cache bits twice; a stamped step gives them too, every block's clock
    running forward, split into the five phases a layer."""
    from bark_tpu_torch.kernels import bdecode as kbdec

    p = (k1_params[torch.bfloat16] if weights == "dense"
         else k5_qpacks[(weights, torch.bfloat16)])
    w = (_build.stage_weights if weights == "dense"
         else _build.stage_qweights)(K1_CFG, p)
    plan, _ = kdec.device_lane_plan(w, B, None)
    assert plan.n_barriers == 5 * K1_CFG.n_layer + 1
    stamps = kdec.step_stamps(plan, dev)
    kc, vc = _lane_caches(dev, torch.bfloat16, B, cache == "int8")
    n_past = [(300, 1023, 0)[b % 3] for b in range(B)]
    runs = []
    for st in (None, None, stamps):
        k, v = _clone(kc), _clone(vc)
        runs.append((kbdec.decode_step_fused_batched(
            K1_CFG, p, list(range(B)), k, v, n_past, stamps=st), k, v))
    for other in runs[1:]:
        for x, y in zip(runs[0], other):
            for s, t in (zip(x.values(), y.values()) if isinstance(x, dict)
                         else [(x, y)]):
                assert torch.equal(s, t)
    for t in stamps.tolist():
        assert all(x <= y for x, y in zip(t, t[1:])) and t[-1] > t[0]
    us = kdec.step_phases_us(plan, stamps)
    assert us["attention"] > 0 and us["step"] > 0
    assert kdec.step_critical_us(plan, stamps)["step"] >= us["step"]


def test_lane_step_slots_on_the_card_and_queued(dev, k1_params):
    """Lanes' tokens and slots read from device tensors, 20 steps queued
    with no host sync against the same 20 synced: equal logits and
    caches (a ticket or count left armed would hang or fold early)."""
    from bark_tpu_torch.kernels import bdecode as kbdec

    p = k1_params[torch.float32]
    B = 8
    runs = []
    for sync in (False, True):
        kc, vc = _lane_caches(dev, torch.float32, B, False)
        toks = torch.arange(B, dtype=torch.int32, device=dev)
        for j in range(20):
            slots = torch.full((B,), 300 + j, dtype=torch.int32, device=dev)
            slots[::2] += 100
            out = kbdec.decode_step_fused_batched(K1_CFG, p, toks, kc, vc,
                                                  slots)
            toks = out.argmax(-1).to(torch.int32) % K1_CFG.n_in_vocab
            if sync:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        runs.append((out.clone(), kc, vc))
    for x, y in zip(*runs):
        assert torch.equal(x, y)


# ---------------------- K9 / K10 at bark-small's width: the batched loop
#
# A chunk or window is ONE launch of K7's (K5-batched's) step in a loop,
# the sampler inside (csrc/bloop.cuh `lane_steps_kernel`), for 1, 3, 8
# and 32 lanes: K9 16 steps after 257 rows (and a chunk whose shared slot
# reaches the clamp at block_size - 1), K10 24 steps at contexts 887 down
# to 596 across lanes, both parities. In f32, dense and q8_0/q4_0, bf16
# and int8 caches: the plain version's tokens and flags, and the bits of
# K7's (K5-batched's) steps launched one by one on the same tokens; one
# loop launch a call and none of the step's own. In bf16 two runs give
# the same bits, a call is one device kernel, and a stamped launch gives
# the same tokens.

LANE_LOOP_CASES = {"chunk": (257, 3), "chunk-clamp": (257, 760),
                   "window-odd": (887, 1), "window-even": (887, 0)}


def _lane_loop_inputs(dev, case, dtype, quant, B):
    """(logits0, noise, caches, K9 or K10 keyword args, context, arg, the
    (steps, B) slots) of a case: K9's shared context and count0, or K10's
    per-lane contexts and step parity."""
    gen = torch.Generator(device=dev).manual_seed(len(case) + B)
    V, S = K1_CFG.n_out_vocab, K1_CFG.block_size
    logits0 = torch.randn((B, V), generator=gen, device=dev) * 2
    kc, vc = _lane_caches(dev, dtype, B, quant)
    ctx, arg = LANE_LOOP_CASES[case]
    if case.startswith("chunk"):
        noise = sampling.gumbel((B, 32, V), gen, dev)
        kw = dict(K=16, temp=0.7, semantic_vocab_size=10000)
        slots = [[min(ctx + arg + j, S - 1)] * B for j in range(16)]
        return logits0, noise, kc, vc, kw, ctx, arg, slots
    ctx = [ctx - 97 * (b % 4) for b in range(B)]
    noise = sampling.gumbel((24, B, 1024), gen, dev)
    kw = dict(sws=24, temp=0.7, semantic_vocab_size=10000,
              codebook_size=1024, lm_window=K1_WIN)
    return logits0, noise, kc, vc, kw, ctx, arg, [[c + j for c in ctx]
                                                  for j in range(24)]


def _lane_loop_call(case, p, logits0, noise, kc, vc, kw, ctx, arg,
                    plain=False):
    """K9 or K10 (or its plain version): (tokens (B, steps), flags or
    None, logits or None)."""
    from bark_tpu_torch.kernels import bsemantic as kbsem
    from bark_tpu_torch.kernels import bwindow as kbwin

    if case.startswith("chunk"):
        fn = (kbsem.semantic_chunk_batched_plain if plain
              else kbsem.semantic_chunk_fused_batched)
        return fn(K1_CFG, p, logits0, kc, vc, ctx, arg, noise, 2.0, **kw)
    fn = (kbwin.coarse_window_batched_plain if plain
          else kbwin.coarse_window_fused_batched)
    return (fn(K1_CFG, p, logits0, kc, vc, ctx, arg, noise, **kw), None,
            None)


@pytest.mark.parametrize("B", LANE_BS)
@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("weights", ["dense", "q8_0", "q4_0"])
@pytest.mark.parametrize("case", list(LANE_LOOP_CASES))
def test_lane_loop_against_plain_and_k7(dev, loop_weights, case, weights,
                                        cache, B):
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import bsemantic as kbsem
    from bark_tpu_torch.kernels import bwindow as kbwin
    from bark_tpu_torch.kernels import qbdecode

    p, quant = loop_weights[weights][torch.float32], cache == "int8"
    logits0, noise, kc, vc, kw, ctx, arg, slots = _lane_loop_inputs(
        dev, case, torch.float32, quant, B)
    kc2, vc2, kc3, vc3 = _clone(kc), _clone(vc), _clone(kc), _clone(vc)
    mod = kbsem if case.startswith("chunk") else kbwin
    counters = ((kbdec, "loop_launches"), (qbdecode, "loop_launches"),
                (kbdec, "launches"), (qbdecode, "launches"),
                (mod, "launches"))
    before = [getattr(m, c) for m, c in counters]
    t, f, lg = _lane_loop_call(case, p, logits0, noise, kc, vc, kw, ctx,
                               arg)
    torch.cuda.synchronize()
    dense = int(weights == "dense")
    # one launch of the loop on its read; none of K7's or K5-batched's own
    # step
    assert [getattr(m, c) - b for (m, c), b in zip(counters, before)] == [
        dense, 1 - dense, 0, 0, 1]
    rt, rf, rlg = _lane_loop_call(case, p, logits0, noise, kc2, vc2, kw,
                                  ctx, arg, plain=True)
    assert t.tolist() == rt.tolist()
    if f is not None:
        assert f.tolist() == rf.tolist()
        torch.testing.assert_close(lg, rlg, rtol=0,
                                   atol=KV8_ATOL if quant else ATOL)
    for b in range(B):
        rows = sorted({r[b] for r in slots})
        for x, y in ((kc, kc2), (vc, vc2)):
            if quant:  # rows of chained steps, the clamp's rewritten ones
                # among them: one-step flips in at most 1% of the values,
                # the bound chip_smoke.py's `record_kv8_rows` sets for a
                # step's rows
                xq, yq = x["q"][:, b, rows].int(), y["q"][:, b, rows].int()
                flips = (xq - yq).abs()
                assert int(flips.max()) <= 1
                assert int((flips > 0).sum()) <= max(1, flips.numel() // 100)
                torch.testing.assert_close(x["s"][:, b, rows],
                                           y["s"][:, b, rows], rtol=0,
                                           atol=KV8_ATOL / 127)
            else:
                torch.testing.assert_close(x[:, b, rows], y[:, b, rows],
                                           rtol=0, atol=ATOL)
    # K7's (K5-batched's) steps, one launch each, on the loop's tokens
    buf = logits0.clone()
    toks = t.t().contiguous()
    for j, row in enumerate(slots):
        kbdec.decode_step_fused_batched(K1_CFG, p, toks[j], kc3, vc3, row,
                                        lm_window=kw.get("lm_window"),
                                        out=buf)
    if f is not None:
        assert torch.equal(lg, buf)
    for a, b in ((kc, kc3), (vc, vc3)):
        for x, y in (zip(a.values(), b.values()) if quant else [(a, b)]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("B", [3, 32])
@pytest.mark.parametrize("weights", ["dense", "q4_0"])
@pytest.mark.parametrize("case", ["chunk-clamp", "window-odd"])
def test_lane_loop_is_bit_equal_run_to_run(dev, loop_weights, case, weights,
                                           B, cache):
    """Two bf16 runs give the same bits: tokens, flags, logits and
    caches."""
    p = loop_weights[weights][torch.bfloat16]
    logits0, noise, kc, vc, kw, ctx, arg, _ = _lane_loop_inputs(
        dev, case, torch.bfloat16, cache == "int8", B)
    runs = []
    for _ in range(2):
        k, v = _clone(kc), _clone(vc)
        runs.append((*_lane_loop_call(case, p, logits0, noise, k, v, kw, ctx,
                                      arg), k, v))
    for x, y in zip(*runs):
        if isinstance(x, dict):
            assert all(torch.equal(x[k], y[k]) for k in x)
        else:
            assert (x is None and y is None) or torch.equal(x, y)


# a fresh process's torch.profiler sessions of one K9 and one K10 call at 8
# lanes in bf16, dense and q4_0: {"<weights> <case>": the device kernels}
_ONE_KERNEL = """
import json, sys, torch
sys.path[:0] = sys.argv[1:]
import test_torch_cuda as t
from bark_tpu_torch.models import gpt
from bark_tpu_torch.probes import prefill_profile
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(12)
weights = {"dense": gpt.init_params(t.K1_CFG, gen, torch.bfloat16, dev),
           "q4_0": t._random_qpack(t.K1_CFG, torch.bfloat16, "f16", gen,
                                   qrange=(-8, 7))}
out = {}
for w, p in weights.items():
    for case in ("chunk-clamp", "window-odd"):
        logits0, noise, kc, vc, kw, ctx, arg, _ = t._lane_loop_inputs(
            dev, case, torch.bfloat16, False, 8)
        def run():
            return t._lane_loop_call(case, p, logits0, noise, t._clone(kc),
                                     t._clone(vc), kw, ctx, arg)
        run()
        torch.cuda.synchronize()
        out[w + " " + case] = [
            e.name for e in prefill_profile.profiled_call(run)
            if not e.name.startswith(("Memcpy", "Memset"))]
print(json.dumps(out))
"""


def test_lane_loop_is_one_device_kernel(dev):
    """A K9 or K10 call is one device kernel, the loop's, dense and q4_0
    (torch.profiler in a fresh process: in a long-lived one its sessions
    at times record no device activity, as chip_smoke.py's `probe_record`
    notes)."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-c", _ONE_KERNEL, here, os.path.dirname(here)],
        stdout=subprocess.PIPE, text=True, timeout=600, check=True).stdout
    calls = json.loads(out.strip().splitlines()[-1])
    assert len(calls) == 4
    for what, names in calls.items():
        assert len(names) == 1 and "lane_steps_kernel" in names[0], (what,
                                                                     names)


def test_lane_loop_stamps(dev, loop_weights):
    """A stamped launch gives the unstamped launch's tokens and flags;
    every block's clock readings run forward and split into the loop's
    parts (`decode.loop_phases_us` on the lane plan)."""
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import bsemantic as kbsem

    B = 8
    p = loop_weights["dense"][torch.bfloat16]
    logits0, noise, kc, vc, kw, ctx, arg, _ = _lane_loop_inputs(
        dev, "chunk", torch.bfloat16, False, B)
    plan, _ = kdec.device_lane_plan(_build.stage_weights(K1_CFG, p), B,
                                    None)
    stamps = kdec.loop_stamps(plan, 16, dev)
    slots, sample = kbsem.chunk_lane_loop(K1_CFG, ctx, arg, 16, 0.7, 10000,
                                          2.0, B)
    toks = torch.empty((16, B), dtype=torch.int32, device=dev)
    flags = torch.empty((16, B), dtype=torch.int32, device=dev)
    kbdec.decode_lane_steps(K1_CFG, p, logits0.clone(), _clone(kc),
                            _clone(vc), slots, sample, noise, toks, flags,
                            stamps=stamps)
    t, f, _ = _lane_loop_call("chunk", p, logits0, noise, _clone(kc),
                              _clone(vc), kw, ctx, arg)
    assert toks.t().tolist() == t.tolist()
    assert flags.t().tolist() == f.tolist()
    for row in stamps.tolist():
        assert all(x <= y for x, y in zip(row, row[1:])) and row[-1] > row[0]
    us = kdec.loop_phases_us(plan, stamps, 16)
    assert us["block0"]["step"] > 0 and us["block0"]["sample_fold"] > 0
    assert us["launch_us"] >= us["block0"]["launch"]


def test_lane_loop_refuses_what_it_does_not_take(dev, k1_params):
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import bsemantic as kbsem
    from bark_tpu_torch.kernels import bwindow as kbwin

    p = k1_params[torch.float32]
    B, V = 4, K1_CFG.n_out_vocab
    kc, vc = _lane_caches(dev, torch.float32, B, False)
    logits = torch.zeros((B, V), device=dev)
    toks = torch.empty((4, B), dtype=torch.int32, device=dev)
    slots = [[40] * B for _ in range(4)]
    sample = kdec.LoopSample(0.7, stop_token=10000)
    before = kbdec.launches, kbdec.loop_launches
    with pytest.raises(ValueError, match="noise"):  # rows too narrow
        kbdec.decode_lane_steps(K1_CFG, p, logits, kc, vc, slots, sample,
                                torch.zeros((B, 4, V - 1), device=dev), toks,
                                toks)
    with pytest.raises(ValueError, match="flag_out"):  # K9 without flags
        kbdec.decode_lane_steps(K1_CFG, p, logits, kc, vc, slots,
                                kdec.LoopSample(0.0, stop_token=10000), None,
                                toks)
    with pytest.raises(ValueError, match="slots"):  # past the cache
        kbdec.decode_lane_steps(K1_CFG, p, logits, kc, vc,
                                [[K1_CFG.block_size] * B], sample,
                                torch.zeros((B, 4, V), device=dev), toks,
                                toks)
    with pytest.raises(ValueError, match="sample window"):  # full head
        kbwin.coarse_window_fused_batched(
            K1_CFG, p, logits, kc, vc, [40] * B, 0, None, sws=4, temp=0.0,
            semantic_vocab_size=10000, codebook_size=1024,
            lm_window=(10000, 11024))
    with pytest.raises(ValueError, match="noise"):  # another width
        kbsem.semantic_chunk_fused_batched(
            K1_CFG, p, logits, kc, vc, 40, 0,
            torch.zeros((B, 4, 100), device=dev), 2.0, K=4, temp=0.7,
            semantic_vocab_size=10000)
    assert (kbdec.launches, kbdec.loop_launches) == before


# ------------------------------------------------------------ D1-D5


def _dma_inputs(dev, form, N, R, G):
    from bark_tpu_torch.probes import dma

    g = torch.Generator(device=dev).manual_seed(N * 10 + G)
    src = torch.randn((N, R, dma.COLS), generator=g, device=dev).to(
        torch.bfloat16)
    xlen = dma.COLS if form == "chain" else G * R
    x = (None if form in ("stream", "dual") else
         torch.randn((1, xlen), generator=g, device=dev).to(torch.bfloat16))
    return src, x


DMA_CASES = [("stream", 8, 16, 1), ("dot", 8, 16, 1), ("dual", 8, 16, 1),
             ("dotgroup", 8, 16, 2), ("dotgroup", 8, 16, 4),
             ("chain", 4, 1024, 1), ("chain", 4, 1024, 4),
             ("chain", 8, 1024, 2)]  # N > ring 4 at G > 1: the hazard case


@pytest.mark.parametrize("method", ["ld4", "ld16", "cp_async", "bulk"])
@pytest.mark.parametrize("form,N,R,G", DMA_CASES)
def test_dma_probe_kernel(dev, form, N, R, G, method):
    from bark_tpu_torch.probes import dma

    src, x = _dma_inputs(dev, form, N, R, G)
    small = 2 if G <= 2 else 4
    for ring, kb in ((4, 16), (small, 8), (small, 32)):
        run = dma.make(form, N, R, ring, 2, G, method, kb)
        before = dma.launches[form]
        got = run(src, x)
        torch.cuda.synchronize()
        assert dma.launches[form] == before + (2 * N // G if form == "chain"
                                               else 1)
        want = dma.plain(form, src, x, 2, G)
        assert dma.excess(form, got, want, src, x, 2, G) <= 1.0


def test_dma_probe_refuses_what_the_kernel_does_not_take(dev):
    from bark_tpu_torch.probes import dma

    src, x = _dma_inputs(dev, "dot", 8, 16, 1)
    before = dict(dma.launches)
    odd = torch.zeros((5, 6, dma.COLS), dtype=torch.bfloat16, device=dev)
    bad = [
        (dma.make_stream(8, 16, 2, 2), (src.float(),)),       # dtype
        (dma.make_stream(5, 6, 2, 2, stage_kb=32), (odd,)),   # 30 rows / 16
        (dma.make_stream_dot(8, 16, 2, 2), (src, x[:, :8])),  # x shape
        (dma.make_stream(8, 16, 2, 2),                         # strides
         (src.transpose(0, 1).contiguous().transpose(0, 1),)),
    ]
    for run, args in bad:
        with pytest.raises(ValueError):
            run(*args)
    assert dma.launches == before


# ------------------------------------------------------------ C1-C3


@pytest.mark.parametrize("shape", [(8, 128), (1_000_003,), (3, 0)])
def test_cache_probe_kernel(dev, shape):
    """C1 bit-equal to its plain version (x * 2 is exact in f32), C2 on
    ones equal to the reference's 1024.0."""
    from bark_tpu_torch.probes import cache

    g = torch.Generator(device=dev).manual_seed(len(shape))
    x = torch.randn(shape, generator=g, device=dev)
    before = dict(cache.launches)
    got = cache.double(x)
    torch.cuda.synchronize()
    assert torch.equal(got, cache.double_plain(x))
    assert cache.launches["double"] == before["double"] + (x.numel() > 0)
    ones = torch.ones((8, 128), device=dev)
    assert cache.scan_double(ones).item() == 1024.0
    assert torch.equal(cache.scan_double(x), cache.scan_double_plain(x))
    with pytest.raises(ValueError):
        cache.double(x.double())
    with pytest.raises(ValueError):
        cache.double(torch.zeros((8, 128), device=dev).t())


def test_cache_probe_sass_survives_a_line_shift(dev, tmp_path):
    """C3: the kernel source shifted by 7 comment lines compiles to the
    same SASS and keys to the same object, and its library, loaded alone,
    doubles; a code edit changes the key."""
    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.probes import cache

    sass0, key0, _ = cache.shifted_sass(0)
    sass7, key7, shifted = cache.shifted_sass(7)
    assert sass0 == sass7 and "Function :" in sass0
    assert key0 == key7 == _build.object_key(_build.SRC_DIR / cache.SOURCE)
    x = torch.randn((8, 128), device=dev)
    before = cache.launches["shifted"]
    assert torch.equal(cache.shifted_double(shifted, x), x * 2.0)
    assert cache.launches["shifted"] == before + 1
    edited = tmp_path / cache.SOURCE
    edited.write_text((_build.SRC_DIR / cache.SOURCE).read_text().replace(
        "x[i] * 2.0f", "x[i] * 3.0f"))
    assert _build.object_key(edited) != key0


def _small_context(dev, seed):
    """A 2-layer width-128 model (the kernels' shapes) as a BarkContext."""
    from bark_tpu_torch.api.context import BarkContext
    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models.config import CodecConfig
    from bark_tpu_torch.params import BarkContextParams

    gen = torch.Generator(device=dev).manual_seed(0)

    def stage(**kw):
        cfg = GPTConfig(n_layer=2, n_head=2, n_embd=128, bias=True, **kw)
        return cfg, gpt.init_params(cfg, gen, torch.float32, dev)

    codec_cfg = CodecConfig(hidden_dim=16, n_filters=2, n_bins=8,
                            n_q_total=8)
    params = BarkContextParams(
        temp=0.7, fine_temp=0.5, min_eos_p=2.0, sliding_window_size=60,
        max_coarse_history=60, n_steps_text_encoder=12, text_pad_token=180,
        text_encoding_offset=100, semantic_pad_token=16,
        semantic_vocab_size=16, semantic_infer_token=181,
        coarse_infer_token=33, coarse_semantic_pad_token=32,
        codebook_size=8, compute_dtype="float32")
    return BarkContext.from_parts(
        vocab_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world"]
        + [f"tok{i}" for i in range(26)],
        semantic=stage(block_size=320, n_in_vocab=182, n_out_vocab=16),
        coarse=stage(block_size=384, n_in_vocab=34, n_out_vocab=32),
        fine=stage(block_size=64, n_in_vocab=9, n_out_vocab=9, n_lm_heads=7,
                   n_wtes=8),
        codec_cfg=codec_cfg,
        codec_params=loader.params_from_numpy(
            loader.codec_init_params_numpy(codec_cfg, 4, scale=0.15),
            torch.float32, dev),
        params=params, seed=seed, device=dev)


def test_warmup_launches_the_kernels_and_leaves_the_generator(dev):
    ctx = _small_context(dev, seed=3)
    state = ctx.generator.get_state().clone()
    kernels.reset_launches()
    assert ctx.warmup() >= 0
    counts = kernels.launch_counts()
    assert all(counts[m] > 0 for m in ("prefill", "semantic", "window"))
    # each chunk and window one launch of K1's step loop; no launch of K1's
    # own step
    assert kdec.loop_launches == counts["semantic"] + counts["window"]
    assert counts["decode"] == 0
    assert torch.equal(ctx.generator.get_state(), state)
    assert ctx.generate_audio("hello world")
    fresh = _small_context(dev, seed=3)
    assert fresh.generate_audio("hello world")
    for attr in ("semantic_tokens", "coarse_tokens", "fine_tokens"):
        assert (getattr(ctx, attr) == getattr(fresh, attr)).all()


def test_world_of_one_on_nccl_serves_batches(dev):
    """A world of 1 on NCCL in this process: `shard_context_dp` serves a
    batch of 3 through K8-K10 (no other kernel, no plain version), each
    lane bit-equal to the unsharded batch's under the same default noise;
    `shard_context` at tp 1 launches no kernel and gives the same tokens
    (f32, TF32 off)."""
    from bark_tpu_torch.parallel import launch, sharding

    texts = ["hello world", "the a", "world hello world"]
    base = _small_context(dev, seed=5)._generate_batch(texts)
    with launch.process_group(1, 0, "cuda"):
        dp = sharding.shard_context_dp(_small_context(dev, seed=5),
                                       sharding.make_dp_mesh())
        kernels.reset_launches()
        lanes = dp._generate_batch(texts)
        counts = kernels.launch_counts()
        tpc = sharding.shard_context(_small_context(dev, seed=5),
                                     sharding.make_mesh(1))
        kernels.reset_launches()
        tp_lanes = tpc._generate_batch(texts)
        tp_counts = kernels.launch_counts()
    assert all(counts[m] > 0 for m in ("bprefill", "bsemantic", "bwindow"))
    assert not any(counts[m] for m in ("decode", "qdecode", "prefill",
                                       "semantic", "window")), counts
    assert not any(tp_counts.values()), tp_counts
    for got, tpl, want in zip(lanes, tp_lanes, base):
        for key in ("semantic", "coarse", "fine", "audio"):
            assert (got[key] == want[key]).all(), key
        for key in ("semantic", "coarse", "fine"):
            assert (tpl[key] == want[key]).all(), key


# ------------------------------------------------------------ P1-P9


def _lp_randn(dev, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _lp_run(lp, name, fn, plain, count=1):
    """fn(), which must count `count` launches under `name`, and plain()'s
    result."""
    before = lp.launches[name]
    got = fn()
    torch.cuda.synchronize()
    assert lp.launches[name] == before + count
    return got, plain()


@pytest.mark.parametrize("method", ["block", "grid", "host"])
@pytest.mark.parametrize("n", [7, 0, 60, 1024])
def test_lowering_while_loop_kernel(dev, n, method):
    from bark_tpu_torch.probes import lowering as lp

    x = torch.full((1, 1), n, dtype=torch.int32, device=dev)
    got, want = _lp_run(lp, "probe_while_loop",
                        lambda: lp.probe_while_loop(x, method),
                        lambda: lp.probe_while_loop_plain(x),
                        n if method == "host" else 1)  # a launch an iteration
    assert torch.equal(got, want) and int(got[0, 0]) == n


@pytest.mark.parametrize("width", [256, 10048])
@pytest.mark.parametrize("method", ["fused", "two_launch"])
def test_lowering_argmax_and_row_kernels(dev, width, method):
    """P2 and P2b at the reference's width and the semantic logits', with
    the max tied at three lanes (the first wins); P2b at groups 1 and 8 on
    an f32 table and a bf16 one."""
    from bark_tpu_torch.probes import lowering as lp

    v = _lp_randn(dev, 1, width, seed=width)
    v[0, [width // 3, width // 2, width - 1]] = 50.0
    got, want = _lp_run(lp, "probe_vector_to_smem_scalar",
                        lambda: lp.probe_vector_to_smem_scalar(v),
                        lambda: lp.probe_vector_to_smem_scalar_plain(v))
    assert torch.equal(got, want) and int(got[0, 0]) == 2 * (width // 3) + 1
    for tbl in (_lp_randn(dev, width, 128, seed=1),
                _lp_randn(dev, width, 768, dtype=torch.bfloat16, seed=2)):
        for group in (1, 8):
            got, want = _lp_run(
                lp, "probe_scalar_dma_row",
                lambda: lp.probe_scalar_dma_row(v, tbl, group, method),
                lambda: lp.probe_scalar_dma_row_plain(v, tbl, group),
                1 if method == "fused" else 2)
            assert torch.equal(got, want)
            assert torch.equal(got[0], tbl[width // 3])


@pytest.mark.parametrize("shape", [
    (4, 128), (60, 10048),
    (60, 10052), (1, 10052), (600, 10052),  # a strip of 4 columns; a ring
])
@pytest.mark.parametrize("method,prefetch", [
    ("block", False), ("block", True), ("strips", False)])
def test_lowering_leading_dma_kernel(dev, shape, method, prefetch):
    """P3: `block` within rtol 1e-6 of the plain version, `strips`
    bit-equal (each column summed in row order)."""
    from bark_tpu_torch.probes import lowering as lp

    g = _lp_randn(dev, *shape, seed=3)
    got, want = _lp_run(
        lp, "probe_dynamic_leading_dma",
        lambda: lp.probe_dynamic_leading_dma(g, prefetch, method),
        lambda: lp.probe_dynamic_leading_dma_plain(g))
    if method == "strips":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("L,W", [(6, 128), (12, 768), (16, 256)])
@pytest.mark.parametrize("unroll", [False, True])
def test_lowering_layer_loop_kernels(dev, L, W, unroll):
    """P4 (f32 sums in the loop's order) and P5 (bit-equal)."""
    from bark_tpu_torch.probes import lowering as lp

    p = _lp_randn(dev, L, 16, W, seed=4)
    got, want = _lp_run(lp, "probe_dynamic_vmem_read",
                        lambda: lp.probe_dynamic_vmem_read(p, unroll),
                        lambda: lp.probe_dynamic_vmem_read_plain(p))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    x = _lp_randn(dev, 8, W, seed=5)
    got, want = _lp_run(lp, "probe_dynamic_vmem_write",
                        lambda: lp.probe_dynamic_vmem_write(x, L, unroll),
                        lambda: lp.probe_dynamic_vmem_write_plain(x, L))
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,dtype,blocks", [
    ((6, 2, 8, 128), torch.float32, 1),      # the reference's
    ((6, 7, 8, 128), torch.float32, 3),
    ((12, 432, 16, 1024), torch.bfloat16, 132),  # bark-small's weights
])
@pytest.mark.parametrize("ring,prefetch", [(2, True), (3, False), (4, True)])
def test_lowering_ring_stream_kernel(dev, shape, dtype, blocks, ring,
                                     prefetch):
    from bark_tpu_torch.probes import lowering as lp

    blocks = min(blocks, torch.cuda.get_device_properties(dev)
                 .multi_processor_count)
    w = _lp_randn(dev, *shape, dtype=dtype, seed=6)
    got, want = _lp_run(
        lp, "probe_dyn_ring_stream",
        lambda: lp.probe_dyn_ring_stream(w, ring, blocks, prefetch),
        lambda: lp.probe_dyn_ring_stream_plain(w, blocks))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("method", ["bulk", "st16", "ring"])
def test_lowering_hbm_write_kernels(dev, method):
    """P7 (every layer x; one slab a layer; one layer; 263 rows a layer,
    which the ring's grid does not divide) and P8 (the reference's
    offsets, and K/V rows of 8 lanes at n_past), bit-equal, the rows
    outside each window untouched."""
    from bark_tpu_torch.probes import lowering as lp

    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    slab = _lp_randn(dev, 24, 257, 768, dtype=torch.bfloat16, seed=7)
    odd = _lp_randn(dev, 24, 263, 768, dtype=torch.bfloat16, seed=10)
    for xx, L in ((x, 6), (slab, 0), (slab[:1], 0), (slab[0], 1), (odd, 0),
                  (slab[0], 24)):
        got, want = _lp_run(
            lp, "probe_dynamic_hbm_write",
            lambda: lp.probe_dynamic_hbm_write(xx, L, method=method),
            lambda: lp.probe_dynamic_hbm_write_plain(xx, L))
        assert torch.equal(got, want)
    sentinel = _lp_randn(dev, 4, 32, 128, seed=8)
    for o in (19, 0, 7, 24, 33, -1):
        off = torch.full((1, 1), o, dtype=torch.int32, device=dev)
        got, want = _lp_run(
            lp, "probe_dynamic_hbm_write_rowoff",
            lambda: lp.probe_dynamic_hbm_write_rowoff(
                x, off, sentinel.clone(), method=method),
            lambda: lp.probe_dynamic_hbm_write_rowoff_plain(
                x, off, sentinel.clone()))
        assert torch.equal(got, want)
    rows, off, cache = lp.kv_inputs(8, dev)
    cache.copy_(_lp_randn(dev, *cache.shape, dtype=torch.bfloat16, seed=9))
    for align in (1, 8):
        got, want = _lp_run(
            lp, "probe_dynamic_hbm_write_rowoff",
            lambda: lp.probe_dynamic_hbm_write_rowoff(
                rows, off, cache.clone(), align=align, method=method),
            lambda: lp.probe_dynamic_hbm_write_rowoff_plain(
                rows, off, cache.clone(), align=align))
        assert torch.equal(got, want)


@pytest.mark.parametrize("M", [1, 8, 32, 64])
@pytest.mark.parametrize("method", ["simt", "wgmma"])
def test_lowering_group_dot_kernel(dev, M, method):
    """P9 on bf16 qkv slots, both methods within 1e-5 of the products'
    magnitudes (exact bf16 products, f32 sums in another order); at 5 x 64
    against 3 slots of 48 rows, the wgmma blocks' 32 rows cross slot
    boundaries."""
    from bark_tpu_torch.probes import lowering as lp

    tol = 1e-5
    for x, wt in ((_lp_randn(dev, M, 768, dtype=torch.bfloat16, seed=M),
                   _lp_randn(dev, 3, 768, 768, dtype=torch.bfloat16, seed=1)),
                  (_lp_randn(dev, 5, 64, dtype=torch.bfloat16, seed=2),
                   _lp_randn(dev, 3, 48, 64, dtype=torch.bfloat16, seed=3))):
        got, want = _lp_run(
            lp, "probe_transposed_group_dot",
            lambda: lp.probe_transposed_group_dot(x, wt, method),
            lambda: lp.probe_transposed_group_dot_plain(x, wt))
        mag = lp.probe_transposed_group_dot_plain(x.abs(), wt.abs())
        assert ((got - want).abs() <= tol * mag).all()


def test_lowering_group_dot_kernel_at_the_reference_f32(dev):
    from bark_tpu_torch.probes import lowering as lp

    x, wt = lp.reference_inputs(dev)["probe_transposed_group_dot"]
    got, want = _lp_run(lp, "probe_transposed_group_dot",
                        lambda: lp.probe_transposed_group_dot(x, wt),
                        lambda: lp.probe_transposed_group_dot_plain(x, wt))
    assert float((got - want).abs().max()) <= 1e-4


def test_lowering_probes_refuse_what_the_kernels_do_not_take(dev):
    from bark_tpu_torch.probes import lowering as lp

    before = dict(lp.launches)
    f32 = dict(device=dev)
    bad = [
        lambda: lp.probe_while_loop(torch.zeros((1, 1), **f32)),
        lambda: lp.probe_while_loop(
            torch.zeros((1, 1), dtype=torch.int32, device=dev), "grid2"),
        lambda: lp.probe_vector_to_smem_scalar(torch.zeros((1, 16), **f32)[:, ::2]),
        lambda: lp.probe_scalar_dma_row(torch.zeros((1, 8), **f32),
                                        torch.zeros((8, 6), **f32)),  # 24 B rows
        lambda: lp.probe_dynamic_leading_dma(torch.zeros((4, 6), **f32)),
        lambda: lp.probe_dynamic_leading_dma(torch.zeros((4, 8), **f32),
                                             method="rows"),
        lambda: lp.probe_dynamic_leading_dma(torch.zeros((4, 8), **f32),
                                             True, "strips"),
        lambda: lp.probe_dynamic_vmem_read(torch.zeros((6, 16, 100), **f32)),
        lambda: lp.probe_dyn_ring_stream(torch.zeros((2, 2, 8, 128), **f32),
                                         blocks=10 ** 4),
        lambda: lp.probe_dynamic_hbm_write(torch.zeros((8, 6), **f32)),
        lambda: lp.probe_dynamic_hbm_write(torch.zeros((8, 128), **f32),
                                           method="st4"),
        lambda: lp.probe_dynamic_hbm_write_rowoff(
            torch.zeros((8, 128), **f32), torch.zeros((1, 1), dtype=torch.int32),
        ),  # off on the CPU
        lambda: lp.probe_transposed_group_dot(
            torch.zeros((1, 128), **f32), torch.zeros((3, 128, 128), **f32),
            "wgmma"),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert lp.launches == before
