"""The port's weight-stream probe (`bark_tpu_torch.probes.dma`, D1-D5) on
the CPU, where each form runs its plain version.

- Against `tools/tpu_dma_probe.py`, run in Pallas interpret mode, on the
  same numpy-seeded inputs, at sizes where the reference has no prefetch
  hazard (N <= ring for its grouped forms): `out` within 1e-5 relative for
  D1-D3 and D5 (f32 sums in another order), D4's x within 1.6e-2 (4 bf16
  ulps) of each value's magnitude plus the vector's rms (a one-ulp flip of
  a carried value moves the next link's values at the vector's scale).
- At N > ring the grouped forms (D3, D4) compute the intended function,
  checked against an explicit numpy einsum; the reference does not there.
- The checksums against numpy sums, and the reference's refusals.

The kernel itself runs only on the card (`tests/test_torch_cuda.py`).
"""

import dataclasses
import functools
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bark_tpu_torch
from bark_tpu_torch import params as tparams
from bark_tpu_torch.probes import dma

from test_torch_e2e import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_RTOL = 1e-5
CHAIN_RTOL = 1.6e-2


@pytest.fixture
def ref(monkeypatch):
    """tools/tpu_dma_probe.py, its pallas_call in interpret mode; the
    sys.path entry the file adds is undone after the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "tpu_dma_probe", os.path.join(ROOT, "tools", "tpu_dma_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(N, R, xlen, seed=0):
    """(src, x) as f32 numpy, rounded to bf16 values."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((N, R, 1024)).astype(np.float32)
    x = rng.standard_normal((1, xlen)).astype(np.float32)
    as_bf16 = lambda a: torch.tensor(a).to(torch.bfloat16).float().numpy()
    return as_bf16(src), as_bf16(x)


def torch_bf16(a):
    return torch.tensor(a).to(torch.bfloat16)


REF_CASES = [
    *[("stream", 8, 16, ring, 1) for ring in (2, 3)],
    *[("dot", 8, 16, ring, 1) for ring in (2, 3)],
    *[("dual", 8, 16, ring, 1) for ring in (2, 3)],
    *[("dotgroup", N, 16, ring, G) for N, ring, G in ((4, 4, 2), (4, 4, 4),
                                                      (2, 2, 2))],
    *[("chain", 4, 1024, 4, G) for G in (1, 2, 4)],
]


@pytest.mark.parametrize("form,N,R,ring,G", REF_CASES)
def test_plain_matches_reference(ref, form, N, R, ring, G):
    passes = 2
    xlen = 1024 if form == "chain" else G * R
    src, x = inputs(N, R, xlen)
    jsrc, jx = jnp.asarray(src, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    make = {"stream": ref.make_stream, "dot": ref.make_stream_dot,
            "dual": ref.make_stream2}
    if form in ("dotgroup", "chain"):
        fn = getattr(ref, f"make_stream_{form}")(N, R, ring, passes, G)
    else:
        fn = make[form](N, R, ring, passes)
    with_x = form not in ("stream", "dual")
    want = np.asarray(fn(jsrc, jx) if with_x else fn(jsrc))
    run = dma.make(form, N, R, ring, passes, G)
    out, _ = run(torch_bf16(src), torch_bf16(x)) if with_x else \
        run(torch_bf16(src))
    got = out.numpy()
    assert got.shape == want.shape == (1, 128)
    if form == "chain":
        assert_chain_close(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=OUT_RTOL, atol=0)


def assert_chain_close(got, want):
    """D4's x: each value within 1.6e-2 of its own magnitude plus the
    vector's rms (`dma.excess`): a value that cancels to near 0 carries the
    previous link's one-ulp flips at the vector's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = CHAIN_RTOL * (np.abs(want) + np.sqrt(np.mean(want ** 2)))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def intended(form, src, x, passes, G):
    """D3's and D4's intended functions, as numpy einsums over f64."""
    N, R, _ = src.shape
    w = src.astype(np.float64).reshape(N // G, G, R, 1024)
    if form == "dotgroup":
        xg = x.astype(np.float64).reshape(G, R)
        return passes * np.einsum("jk,gjkc->c", xg, w)[0]
    xx = x.astype(np.float64).reshape(1024)
    for _ in range(passes):
        for g in range(N // G):
            y = (np.einsum("k,kc->c", xx, w[g, 0]) if G == 1
                 else np.einsum("c,jrc->r", xx, w[g]))
            xx = torch.tensor(np.tanh(1e-3 * y)).to(
                torch.bfloat16).double().numpy()
    return xx[:128]


@pytest.mark.parametrize("form,N,ring,G", [("dotgroup", 8, 4, 2),
                                           ("dotgroup", 8, 4, 4),
                                           ("chain", 8, 4, 2)])
def test_grouped_forms_at_n_over_ring_compute_the_intended_function(
        form, N, ring, G):
    R = 1024 if form == "chain" else 16
    src, x = inputs(N, R, 1024 if form == "chain" else G * R, seed=1)
    out, _ = dma.make(form, N, R, ring, 2, G)(torch_bf16(src),
                                              torch_bf16(x))
    want = intended(form, src, x, 2, G)
    got = out.numpy()[0].astype(np.float64)
    if form == "chain":
        assert_chain_close(got, want)
    else:
        np.testing.assert_allclose(got, np.full(128, want), rtol=OUT_RTOL,
                                   atol=0)


def test_reference_dotgroup_misses_the_intended_function_at_n_over_ring(ref):
    """The hazard the port does not copy: the reference's D3 at N > ring
    (its prefetch overwrites a slot before the group's dot reads it)."""
    N, R, ring, G = 8, 16, 4, 2
    src, x = inputs(N, R, G * R, seed=1)
    got = np.asarray(ref.make_stream_dotgroup(N, R, ring, 2, G)(
        jnp.asarray(src, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)))
    want = intended("dotgroup", src, x, 2, G)
    assert abs(got[0, 0] - want) > 0.1 * abs(want)


@pytest.mark.parametrize("form", ["stream", "dot", "dotgroup", "dual"])
def test_checksum_is_the_sum_of_what_was_read(form):
    G = 2 if form == "dotgroup" else 1
    src, x = inputs(4, 16, 16 * G, seed=2)
    passes = 3
    before = dict(dma.launches)
    _, chk = dma.make(form, 4, 16, 2, passes, G)(torch_bf16(src),
                                                 torch_bf16(x))
    assert dma.launches == before  # the plain version launches nothing
    if form in ("stream", "dual"):
        terms = np.abs(src).sum() * passes
        want = src.astype(np.float64).sum() * passes
    else:
        w = src.astype(np.float64).reshape(4 // G, G * 16, 1024)
        prod = x.astype(np.float64).reshape(G * 16, 1)[None] * w
        want, terms = prod.sum() * passes, np.abs(prod).sum() * passes
    assert abs(float(chk) - want) <= OUT_RTOL * (abs(want) + terms)


@pytest.mark.parametrize("G", [1, 2])
def test_chain_checksum_and_a_vanished_x(G):
    """D4's checksum is the last link's y summed, x . s for its input x and
    its weights s summed over the axis x does not meet (numpy, f64, within
    x's 1.6e-2 against |s|); and a chain whose x ends in zeros is out of
    `dma.excess`'s tolerance."""
    N, passes = 4, 1
    src, x = inputs(N, 1024, 1024, seed=3)
    tsrc, tx = torch_bf16(src), torch_bf16(x)
    got = dma.make_stream_chain(N, 1024, 4, passes, G)(tsrc, tx)
    w = src.astype(np.float64).reshape(N // G, G, 1024, 1024)
    xx = x.astype(np.float64).reshape(1024)
    for g in range(N // G):
        prev = xx
        y = (np.einsum("k,kc->c", xx, w[g, 0]) if G == 1
             else np.einsum("c,jrc->r", xx, w[g]))
        xx = torch.tensor(np.tanh(1e-3 * y)).to(
            torch.bfloat16).double().numpy()
    s = w[-1, 0].sum(axis=1) if G == 1 else w[-1].sum(axis=(0, 1))
    tol = CHAIN_RTOL * (np.abs(prev) + np.sqrt(np.mean(prev ** 2))) @ \
        np.abs(s)
    assert abs(float(got[1]) - y.sum()) <= tol
    vanished = (torch.zeros_like(got[0]), torch.zeros(()))
    assert not dma.excess("chain", vanished, got, tsrc, tx, passes, G) <= 1.0


@pytest.mark.parametrize("call,match", [
    (lambda: dma.make_stream_dotgroup(8, 16, 3, 2, 2), "divide ring"),
    (lambda: dma.make_stream_dotgroup(6, 16, 4, 2, 4), "divide ring"),
    (lambda: dma.make_stream_chain(4, 512, 4, 2, 1), "R == 1024"),
    (lambda: dma.make_stream(8, 16, 2, 2, method="tma"), "method"),
    (lambda: dma.make_stream(8, 16, 2, 2, method="ld16", stage_kb=12),
     "register methods"),
    (lambda: dma.make_stream(8, 16, 5, 2, method="cp_async"), "ring 5"),
    (lambda: dma.make_stream2(8, 16, 4, 2, method="bulk", stage_kb=32),
     "shared memory"),
])
def test_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_sweep_keeps_the_reference_rules_and_marks_what_does_not_fit():
    got = list(dma.sweep("dual", 2, rings=(2, 3, 4), stage_kbs=(8, 12, 32)))
    for method, ring, kb, ok in got:
        assert ring % 2 == 0
        if method in dma.RING_METHODS:
            assert ok == dma.fits("dual", method, ring, kb)
        else:
            assert ring == 2 and kb in dma.REGISTER_STAGE_KB and ok
    assert ("bulk", 4, 32, False) in got and ("bulk", 2, 32, True) in got
    assert ("ld16", 2, 12, True) not in got and ("cp_async", 4, 12, True) in got


def test_bandwidth_needs_the_card():
    src, _ = inputs(2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        dma.bandwidth("stream", torch_bf16(src))


# ------------------------------------ options the port refused before


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """The tiny model's stages as `BarkContext.from_parts` takes them, and
    the port's params for its token space."""
    from bark_tpu.io import ggml
    from tiny_model import build_tiny_model, tiny_params

    path = str(tmp_path_factory.mktemp("tiny") / "w.bin")
    ggml.write_model_file(path, build_tiny_model())
    fields = {f.name: getattr(tiny_params(), f.name)
              for f in dataclasses.fields(tiny_params())
              if f.name != "progress_callback"}
    ctx = bark_tpu_torch.bark_load_model(
        path, tparams.BarkContextParams(**fields), seed=0, device="cpu")
    vocab = [ctx.vocab.id_to_token[i] for i in range(len(ctx.vocab))]
    return fields, dict(
        vocab_tokens=vocab, semantic=(ctx.semantic_cfg, ctx.semantic_params),
        coarse=(ctx.coarse_cfg, ctx.coarse_params),
        fine=(ctx.fine_cfg, ctx.fine_params), codec_cfg=ctx.codec_cfg,
        codec_params=ctx.codec_params)


@pytest.mark.parametrize("option,value", [
    ("progress_callback", lambda *a: None),
    ("detailed_stats", True),
    ("profile_dir", "trace"),
])
def test_context_refuses_the_stepped_path_options(parts, option, value,
                                                  tmp_path):
    """The context refuses none of the stepped path's options any more
    (bark_tpu refuses none of them): each makes a context whose request
    gives the tokens of the same request without it. A progress callback
    hears every stage from 0 (semantic) to 100 (fine); a profile_dir
    request writes its trace there."""
    fields, stages = parts
    calls = []
    if option == "progress_callback":
        def value(ctx, step, percent, user_data):  # noqa: F811
            calls.append((int(step), percent))
    elif option == "profile_dir":
        value = str(tmp_path / value)
    runs = []
    for params in (tparams.BarkContextParams(**{**fields, option: value}),
                   tparams.BarkContextParams(**fields)):
        ctx = bark_tpu_torch.BarkContext.from_parts(**stages, params=params,
                                                    device="cpu")
        assert ctx.generate_audio("hello world")
        runs.append(ctx)
    for name in ("semantic_tokens", "coarse_tokens", "fine_tokens"):
        np.testing.assert_array_equal(getattr(runs[0], name),
                                      getattr(runs[1], name), err_msg=name)
    if option == "progress_callback":
        assert calls[0] == (0, 0) and calls[-1] == (2, 100)
        assert {s for s, _ in calls} == {0, 1, 2}
    if option == "profile_dir":
        assert any(f.endswith(".pt.trace.json") for f in os.listdir(value))
