"""The port's lowering probe (`bark_tpu_torch.probes.lowering`, P1-P9) on
the CPU, where each probe runs its plain version.

- Against `tools/tpu_mosaic_probe.py` with its pallas_call in interpret
  mode: each probe's call is captured (inputs, output and the interpret-mode
  callable), the port's plain version must give the captured output on the
  captured inputs, and the callable's output on numpy-seeded inputs of the
  same shapes (P2 with tied maxima, P2b at tokens 0/93/255, P8 at offsets
  0/7/19/24). Tolerances: P2 and the data-movement probes (P2b, P5, P7, P8)
  exact; P3, P4 and P6, f32 sums in the reference's order, rtol 1e-6; P9
  the reference's atol 1e-4. P8 defines only its window (interpret mode
  leaves NaN elsewhere), so only the window is compared.
- P1 is held to the probe's own assertion (out == x[0, 0]). The reference
  is never called: in interpret mode its while_loop never returns (the
  condition reads an SMEM scratch value the body writes, a write the
  interpreter does not show the condition), and a hang would cost the
  whole suite its time limit.
- Every method of P3 (`strips`, `block`), P7 and P8 (`bulk`, `st16`,
  `ring`) on CPU tensors: the plain version, the captured output.
- The refusals, and the CLI at --device cpu.

The kernels themselves run only on the card (`tests/test_torch_cuda.py`).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bark_tpu_torch.probes import lowering as lp

from test_torch_e2e import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUM_RTOL = 1e-6
DOT_ATOL = 1e-4
EXACT = ("probe_vector_to_smem_scalar", "probe_scalar_dma_row",
         "probe_dynamic_vmem_write", "probe_dynamic_hbm_write",
         "probe_dynamic_hbm_write_rowoff")
CAPTURED = lp.NAMES[1:]  # never probe_while_loop (module docstring)


@pytest.fixture(scope="module")
def ref():
    """{probe name: (interpret-mode callable, [inputs], output)} of the
    reference's probes P2-P9, each run once as the reference runs it."""
    calls, current = {}, [None]
    orig = pl.pallas_call

    def capturing(kernel, **kw):
        call = orig(kernel, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            calls[current[0]] = (call, [np.asarray(a) for a in args],
                                 np.asarray(out))
            return out

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "path", list(sys.path))
        mp.setattr(pl, "pallas_call", capturing)
        spec = importlib.util.spec_from_file_location(
            "tpu_mosaic_probe",
            os.path.join(ROOT, "tools", "tpu_mosaic_probe.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for name in CAPTURED:
            current[0] = name
            getattr(mod, name)()
    return calls


def port(name, *arrays):
    """The port's probe `name` on CPU tensors of `arrays`, as numpy."""
    return getattr(lp, name)(*(torch.from_numpy(np.array(a))
                               for a in arrays)).numpy()


def assert_matches(name, got, want):
    if name == "probe_dynamic_hbm_write_rowoff":  # only its window
        got, want = got[:, 16:24], want[:, 16:24]
    assert got.shape == want.shape
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    elif name == "probe_transposed_group_dot":
        np.testing.assert_allclose(got, want, rtol=0, atol=DOT_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("name", CAPTURED)
def test_plain_matches_the_captured_reference(ref, name):
    _, inputs, want = ref[name]
    assert_matches(name, port(name, *inputs), want)


METHOD_CASES = [("probe_dynamic_leading_dma", dict(method=m))
                for m in lp.LEADING_METHODS]
METHOD_CASES += [("probe_dynamic_leading_dma",
                  dict(prefetch=True, method="block"))]
METHOD_CASES += [(name, dict(method=m)) for m in lp.WRITE_METHODS
                 for name in ("probe_dynamic_hbm_write",
                              "probe_dynamic_hbm_write_rowoff")]


@pytest.mark.parametrize("name,kw", METHOD_CASES,
                         ids=[f"{n}-{'-'.join(map(str, kw.values()))}"
                              for n, kw in METHOD_CASES])
def test_every_method_gives_the_captured_reference_on_the_cpu(ref, name,
                                                              kw):
    """On CPU tensors each method runs the plain version: the captured
    output at the reference's inputs (P3 rtol 1e-6, P7/P8 exact)."""
    _, inputs, want = ref[name]
    got = getattr(lp, name)(*(torch.from_numpy(np.array(a)) for a in inputs),
                            **kw).numpy()
    assert_matches(name, got, want)


def _seeded(name, inputs, rng):
    """Inputs of the captured shapes and dtypes, drawn from rng (the
    integer offset of P8 kept)."""
    out = []
    for a in inputs:
        if a.dtype == np.int32:
            out.append(a)
        else:
            out.append(rng.standard_normal(a.shape).astype(a.dtype))
    return out


def _tok_row(tok):
    v = np.zeros((1, 256), np.float32)
    v[0, tok] = 5.0
    return v


SEEDED = [(name, None) for name in CAPTURED]
SEEDED += [("probe_vector_to_smem_scalar", "tied")]
SEEDED += [("probe_scalar_dma_row", tok) for tok in (0, 93, 255)]
SEEDED += [("probe_dynamic_hbm_write_rowoff", off) for off in (0, 7, 19, 24)]


@pytest.mark.parametrize("name,case", SEEDED)
def test_plain_matches_the_reference_on_seeded_inputs(ref, name, case):
    call, inputs, _ = ref[name]
    rng = np.random.default_rng(SEEDED.index((name, case)))
    args = _seeded(name, inputs, rng)
    if case == "tied":  # the max at three lanes: the first one wins
        args[0][0, [40, 41, 200]] = 9.0
    elif name == "probe_scalar_dma_row" and case is not None:
        args[0] = _tok_row(case)
    elif name == "probe_dynamic_hbm_write_rowoff" and case is not None:
        args[1] = np.full((1, 1), case, np.int32)
    want = np.asarray(call(*args))
    assert_matches(name, port(name, *args), want)


@pytest.mark.parametrize("method", lp.WHILE_METHODS)
@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_while_loop_runs_x_iterations(n, method):
    x = torch.full((1, 1), n, dtype=torch.int32)
    out = lp.probe_while_loop(x, method)
    assert out.dtype == torch.int32 and out.shape == (1, 1)
    assert int(out[0, 0]) == n


def test_while_loop_runs_no_iteration_below_zero():
    assert int(lp.probe_while_loop(torch.full((1, 1), -3, dtype=torch.int32))
               [0, 0]) == 0


def test_argmax_without_a_token_gives_the_reference_values():
    """A NaN in v: no lane equals the max; tok is 2^30, out wraps as int32
    does, and the row probe returns zeros (its group leaves the table)."""
    v = torch.zeros((1, 256))
    v[0, 7] = float("nan")
    assert int(lp.probe_vector_to_smem_scalar(v)[0, 0]) == -(2 ** 31) + 1
    tbl = torch.ones((256, 128))
    assert not lp.probe_scalar_dma_row(v, tbl).any()


def test_rowoff_leaves_the_rest_of_a_given_buffer():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    sentinel = torch.randn((4, 32, 128), generator=torch.Generator()
                           .manual_seed(0))
    out = lp.probe_dynamic_hbm_write_rowoff(
        x, torch.full((1, 1), 19, dtype=torch.int32), sentinel.clone())
    assert torch.equal(out[:, 16:24], x.expand(4, 8, 128))
    assert torch.equal(out[:, :16], sentinel[:, :16])
    assert torch.equal(out[:, 24:], sentinel[:, 24:])
    # a window past the buffer's end writes nothing
    out = lp.probe_dynamic_hbm_write_rowoff(
        x, torch.full((1, 1), 33, dtype=torch.int32), sentinel.clone())
    assert torch.equal(out, sentinel)


@pytest.mark.parametrize("align", [1, 8])
def test_rowoff_per_lane_writes_each_lanes_window(align):
    rng = np.random.default_rng(align)
    L, B, S, W = 3, 4, 40, 16
    rows = rng.standard_normal((L, B, 1, W)).astype(np.float32)
    offs = np.array([0, 13, 39, 41], np.int32)  # the last leaves [0, S)
    cache = rng.standard_normal((L, B, S, W)).astype(np.float32)
    want = cache.copy()
    for b, o in enumerate(offs):
        base = o // align * align
        if base + 1 <= S:
            want[:, b, base] = rows[:, b, 0]
    got = lp.probe_dynamic_hbm_write_rowoff(
        torch.from_numpy(rows), torch.from_numpy(offs),
        torch.from_numpy(cache.copy()), align=align)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hbm_write_of_one_slab_a_layer():
    x = torch.randn((5, 3, 16), generator=torch.Generator().manual_seed(1))
    assert torch.equal(lp.probe_dynamic_hbm_write(x), x)
    assert torch.equal(lp.probe_dynamic_hbm_write(x[0], layers=5),
                       x[0].expand(5, 3, 16))


@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_ring_stream_blocks_fold_to_the_same_sum(blocks):
    w = torch.randn((4, 5, 2, 128), generator=torch.Generator()
                    .manual_seed(blocks))
    want = w[:, :, 0].double().sum(dim=(0, 1))
    got = lp.probe_dyn_ring_stream(w, blocks=blocks)[0].double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SUM_RTOL,
                               atol=1e-6)


def test_group_dot_on_bf16_is_the_f32_product_of_the_slots():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((5, 64), generator=gen).to(torch.bfloat16)
    wt = torch.randn((3, 48, 64), generator=gen).to(torch.bfloat16)
    got = lp.probe_transposed_group_dot(x, wt, "wgmma")
    want = np.concatenate([x.double().numpy() @ wt[t].double().numpy().T
                           for t in range(3)], axis=1)
    assert got.dtype == torch.float32 and got.shape == (5, 144)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DOT_ATOL)


i32, f32, bf16 = torch.int32, torch.float32, torch.bfloat16
REFUSALS = [
    (lambda: lp.probe_while_loop(torch.zeros((1, 1), dtype=f32)), "int32"),
    (lambda: lp.probe_while_loop(torch.zeros((1, 2), dtype=i32)), r"\(1, 1\)"),
    (lambda: lp.probe_while_loop(torch.zeros((1, 1), dtype=i32), "loop"),
     "method"),
    (lambda: lp.probe_vector_to_smem_scalar(torch.zeros((2, 8))), r"\(1, n"),
    (lambda: lp.probe_vector_to_smem_scalar(torch.zeros((1, 8), dtype=bf16)),
     "float32"),
    (lambda: lp.probe_scalar_dma_row(torch.zeros((1, 8)),
                                     torch.zeros((8, 4), dtype=i32)), "tbl"),
    (lambda: lp.probe_scalar_dma_row(torch.zeros((1, 8)), torch.zeros((8, 4)),
                                     group=0), "group"),
    (lambda: lp.probe_dynamic_leading_dma(torch.zeros((4, 6))), "multiple"),
    (lambda: lp.probe_dynamic_leading_dma(torch.zeros((4, 8)),
                                          method="rows"), "method"),
    (lambda: lp.probe_dynamic_leading_dma(torch.zeros((4, 8)), True),
     "prefetch"),
    (lambda: lp.probe_dynamic_vmem_read(torch.zeros((6, 8, 128))), "16"),
    (lambda: lp.probe_dynamic_vmem_read(torch.zeros((17, 16, 128))),
     "layers"),
    (lambda: lp.probe_dynamic_vmem_write(torch.zeros((8, 100))), "width"),
    (lambda: lp.probe_dyn_ring_stream(torch.zeros((2, 2, 8, 128)), ring=5),
     "ring"),
    (lambda: lp.probe_dyn_ring_stream(torch.zeros((2, 2, 8, 2048))), "W"),
    (lambda: lp.probe_dynamic_hbm_write(torch.zeros((8, 128)),
                                        method="st4"), "method"),
    (lambda: lp.probe_dynamic_hbm_write_rowoff(
        torch.zeros((8, 128)), torch.zeros((1, 1), dtype=torch.int64)),
     "off"),
    (lambda: lp.probe_dynamic_hbm_write_rowoff(
        torch.zeros((8, 128)), torch.zeros((1, 1), dtype=i32),
        method="strips"), "method"),
    (lambda: lp.probe_dynamic_hbm_write_rowoff(
        torch.zeros((2, 3, 1, 128)), torch.zeros(3, dtype=i32)), "given out"),
    (lambda: lp.probe_transposed_group_dot(torch.zeros((1, 128)),
                                           torch.zeros((3, 128, 64))),
     "shared K"),
    (lambda: lp.probe_transposed_group_dot(
        torch.zeros((1, 128)), torch.zeros((3, 128, 128)), "wgmma"), "bf16"),
    (lambda: lp.probe_transposed_group_dot(
        torch.zeros((65, 128), dtype=bf16),
        torch.zeros((3, 128, 128), dtype=bf16), "wgmma"), "M <= 64"),
]


@pytest.mark.parametrize("call,match", REFUSALS)
def test_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_cli_on_the_cpu_passes_all_ten(capsys):
    assert lp.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "10/10 probes passed"
    assert sum(line.startswith("PASS ") for line in out) == 10


def test_cli_sweep_needs_the_card(capsys):
    assert lp.main(["--device", "cpu", "--sweep"]) == 1
    assert "--sweep times the card" in capsys.readouterr().err
