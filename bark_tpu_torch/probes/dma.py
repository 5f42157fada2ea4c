"""D1-D5: how fast a weight stream reaches the SMs, and what consuming it
costs.

The counterpart of `tools/tpu_dma_probe.py`, whose five Pallas kernels
stream an (N, R, 1024) bf16 array from HBM through a VMEM ring `passes`
times and consume each tile in one of five ways. Here the five forms are
one hand-written kernel (`csrc/dma_probe.cu`), which streams the array
from device memory by one of four load methods:

- `ld4`: 4-byte loads into registers (K1's GEMV);
- `ld16`: 16-byte loads into registers;
- `cp_async`: 16-byte `cp.async` into a ring of `ring` stages;
- `bulk`: one bulk copy (the TMA engine) a stage, into a ring with full
  and empty mbarriers.

A stage is `stage_kb` KB of whole rows: what a block has in flight with the
register methods, one ring slot with the others. The forms, with `out`
(1, 128) f32 as the reference computes it and a checksum beside it:

- D1 `make_stream`: out = passes * sum_i sum(src[i, 0, :128]); checksum:
  the sum of every value read (passes * sum(src));
- D2 `make_stream_dot`: x (1, R); out = sum_passes sum_i (x @ src[i])[0];
  checksum: the sum of every column of every product;
- D3 `make_stream_dotgroup`: x (1, G R); out = sum_passes sum_g
  (x @ src[gG:(g+1)G].reshape(G R, 1024))[0]; checksum as D2;
- D4 `make_stream_chain`: R = 1024, x (1, 1024) carried through
  passes * N / G links, each one kernel launch: G = 1,
  x <- bf16(tanh(1e-3 x @ src[i])); G > 1, x <- bf16(tanh(1e-3 sum_j
  x @ src[gG + j].T)); out = x[0, :128]; checksum: the sum of the last
  link's y (before the tanh);
- D5 `make_stream2`: D1 with even and odd stages in two rings (two stages
  in flight with the register methods).

The reference's D3 and D4 have a prefetch hazard when group > 1: they
start the copy of tile i + ring - 1 (`:146`, `:209`) before the group's
dot has read its slots, so at N > ring that tile lands in a slot that still
holds a tile of the current group, and what the dot reads depends on when
the copy lands. At N <= ring their result is right. The port computes the
intended function at every N (each group's dot reads its own G tiles): its
kernel refills a slot only after every thread released it.

Every `make_*` takes the reference's arguments plus `method` and
`stage_kb`, and returns a callable of the tensors (`run(src)` or
`run(src, x)`) that returns (out, checksum). On CUDA tensors it launches
the kernel and counts the launch in `launches[form]` (D4: one a link); on
CPU tensors it runs the form's plain version (`stream_plain` for D1 and
D5, `dotgroup_plain` for D2 at G 1 and D3, `chain_plain`). A
shape the kernel does not take raises a ValueError; nothing falls back.
`bandwidth` times a probe on the card; `main` is the sweep:

    python -m bark_tpu_torch.probes.dma --dot --method ld4,bulk
"""

from __future__ import annotations

import argparse
import sys

import torch

from bark_tpu_torch.kernels import _build
from bark_tpu_torch.probes._timing import least_ms

FORMS = ("stream", "dot", "dotgroup", "chain", "dual")
METHODS = ("ld4", "ld16", "cp_async", "bulk")
RING_METHODS = ("cp_async", "bulk")
REGISTER_STAGE_KB = (8, 16, 32)  # stage sizes the register methods take
MAX_RING = 4
# dynamic shared memory a block's rings may take: the card's 227 KB less
# the kernel's static shared memory
RING_SMEM_BYTES = 227 * 1024 - 8192
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
COLS = 1024
ROW_BYTES = 2 * COLS
STRIDE_OUT = COLS + 64  # a block's partial row with D1/D5's row-0 sum
FOLD_GROUP = 16  # blocks whose partials the kernel folds in one group
N_TICKETS = 64   # > 1 + the groups of 2 blocks an SM
# tolerances of the kernel against its plain version: |a - b| <=
# SUM_RTOL * (|b| + the sum of the terms' magnitudes) for sums of f32
# values in another order; D4's x within 4 bf16 ulps: CHAIN_RTOL of each
# value plus of the vector's rms (a value near 0 from cancellation), and
# its checksum, x . s for the last link's input x, within x's tolerance
# against |s| plus SUM_RTOL of its terms' magnitudes.
# Each link scales x by ~0.03-0.06, so a chain of more than ~25 links ends
# in bf16 subnormals and zeros: hold D4 against plain on shorter chains.
SUM_RTOL = 1e-5
CHAIN_RTOL = 1.6e-2

launches = dict.fromkeys(FORMS, 0)  # kernel launches through the wrappers

_scratch = {}  # device index -> reused scratch tensors


# ------------------------------------------------------------ plain versions


def _filled(v):
    return v.reshape(1, 1).expand(1, 128).clone()


def stream_plain(src, passes: int):
    """D1, and D5 (the same function through two rings): (out, checksum)
    of `passes` passes over src."""
    t = src.float()
    row0, every = t[:, 0, :128].sum(), t.sum()
    out = chk = torch.zeros((), dtype=torch.float32, device=src.device)
    for _ in range(passes):
        out, chk = out + row0, chk + every
    return _filled(out), chk


def dotgroup_plain(src, x, passes: int, group: int):
    """D3 (D2 at group 1): each group of G tiles as one (G R, 1024) matrix
    against x (1, G R), f32 accumulation."""
    N, R, _ = src.shape
    w = src.float().reshape(N // group, group * R, COLS)
    total = (x.float().reshape(1, group * R) @ w).sum(dim=0)[0]
    out = chk = torch.zeros((), dtype=torch.float32, device=src.device)
    for _ in range(passes):
        out, chk = out + total[0], chk + total.sum()
    return _filled(out), chk


def _link(xx, src, g: int, group: int):
    """One D4 link's y (1, 1024) in f32: x (1, 1024) against tile g (G 1)
    or against tiles g G .. g G + G - 1 transposed (G > 1)."""
    if group == 1:
        return xx.float() @ src[g].float()
    w = src[g * group:(g + 1) * group].reshape(group * COLS, COLS)
    return (xx.float() @ w.float().T).reshape(group, COLS).sum(
        dim=0, keepdim=True)


def _chain(src, x, passes: int, group: int):
    """D4's passes * N / group links: (x into the last link, its y, x out
    of it)."""
    xx = x.reshape(1, COLS)
    prev = y = None
    for _ in range(passes):
        for g in range(src.shape[0] // group):
            prev, y = xx, _link(xx, src, g, group)
            xx = torch.tanh(y * 1e-3).to(torch.bfloat16)
    return prev, y, xx


def chain_plain(src, x, passes: int, group: int):
    """D4: x carried through passes * N / group links."""
    _, y, xx = _chain(src, x, passes, group)
    return xx[:, :128].float(), y.sum()


def plain(form: str, src, x=None, passes: int = 1, group: int = 1):
    """The plain version of `form` on these inputs: (out, checksum)."""
    if form in ("stream", "dual"):
        return stream_plain(src, passes)
    if form in ("dot", "dotgroup"):
        return dotgroup_plain(src, x, passes, group)
    return chain_plain(src, x, passes, group)


def excess(form: str, got, want, src, x=None, passes: int = 1,
           group: int = 1) -> float:
    """The largest |kernel - plain| over its tolerance, across out and the
    checksum: <= 1 is within tolerance (NaN or inf where plain D4's x is
    all zeros).
    `got` and `want` are (out, checksum) pairs."""
    if form == "chain":
        a, b = got[0].double(), want[0].double()
        tol = CHAIN_RTOL * (b.abs() + b.pow(2).mean().sqrt())
        # the checksum is x . s, x the last link's input and s its weights
        # summed over the axis x does not meet: within x's tolerance
        # against |s|, plus the f32 sum's order over its terms
        prev = _chain(src, x, passes, group)[0].float().abs()
        w = src[src.shape[0] - group:].float()
        s = w.sum(dim=2)[0] if group == 1 else w.sum(dim=(0, 1))
        chk_tol = (CHAIN_RTOL * float((prev + prev.pow(2).mean().sqrt())
                                      @ s.abs())
                   + SUM_RTOL * float(_link(prev, w.abs(), 0, group).sum()))
        return max(float(((a - b).abs() / tol).max()),
                   abs(float(got[1]) - float(want[1])) / chk_tol)
    mag = plain(form, src.abs(), None if x is None else x.abs(), passes,
                group)
    worst = 0.0
    for a, b, m in zip(got, want, mag):
        a, b, m = (float(v.reshape(-1)[0]) for v in (a, b, m))
        worst = max(worst, abs(a - b) / (SUM_RTOL * (abs(b) + m)))
    return worst


# ------------------------------------------------------------ the kernel


def stage_rows(stage_kb: int) -> int:
    return stage_kb * 1024 // ROW_BYTES


def fits(form: str, method: str, ring: int, stage_kb: int) -> bool:
    """Whether a block's rings fit in shared memory (always, for the
    register methods): the rule that skips a configuration before launch."""
    if method not in RING_METHODS:
        return True
    rings = 2 if form == "dual" else 1
    return rings * ring * stage_kb * 1024 <= RING_SMEM_BYTES


def sweep(form: str, group: int = 1, methods=METHODS, rings=(2, 3, 4),
          stage_kbs=REGISTER_STAGE_KB):
    """(method, ring, stage_kb, fits) of a sweep of `form` at `group`: each
    stage size, and each ring depth of the ring methods, where group | ring
    as the reference asks (the register methods have no ring: ring =
    group) and the method takes the stage size. Where `fits` is False the
    rings exceed shared memory: the caller skips it before launch, and says
    so."""
    for method in methods:
        for ring in (rings if method in RING_METHODS else (group,)):
            for kb in stage_kbs:
                if ring % group or (method not in RING_METHODS
                                    and kb not in REGISTER_STAGE_KB):
                    continue
                yield method, ring, kb, fits(form, method, ring, kb)


def _check_config(form, method, ring, stage_kb):
    if method not in METHODS:
        raise ValueError(f"method {method!r}: want one of {METHODS}")
    if method in RING_METHODS:
        if not 1 <= ring <= MAX_RING:
            raise ValueError(f"ring {ring}: the ring methods take 1 to "
                             f"{MAX_RING} stages")
        if stage_kb < 4 or stage_kb % 4:
            raise ValueError(f"stage_kb {stage_kb}: the ring methods take "
                             f"a multiple of 4 KB (two row groups of 2 KB "
                             f"rows)")
        if not fits(form, method, ring, stage_kb):
            raise ValueError(
                f"{form} by {method}: {ring} x {stage_kb} KB rings exceed "
                f"the {RING_SMEM_BYTES} bytes of shared memory a block may "
                f"take")
    elif stage_kb not in REGISTER_STAGE_KB:
        raise ValueError(f"stage_kb {stage_kb}: the register methods take "
                         f"{REGISTER_STAGE_KB}")


def _want(name, t, shape, device):
    if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
            or t.device != device or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(
            f"{name}: want a contiguous, 16-byte aligned bfloat16 tensor of "
            f"shape {shape} on {device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


def _scratch_for(device, floats: int):
    s = _scratch.get(device.index)
    if s is None or s["partial"].numel() < floats:
        s = dict(partial=torch.empty(floats, dtype=torch.float32,
                                     device=device),
                 tickets=torch.zeros(N_TICKETS, dtype=torch.int32,
                                     device=device),
                 total=torch.empty(COLS + 1, dtype=torch.float32,
                                   device=device),
                 xbuf=torch.empty(COLS, dtype=torch.bfloat16, device=device))
        _scratch[device.index] = s
    return s


def _launch(form, method, src, x, N, R, group, ring, stage_kb, passes):
    """Validate the CUDA tensors and launch the probe; (out, checksum)."""
    device = src.device
    _want("src", src, (N, R, COLS), device)
    if form in ("dot", "dotgroup"):
        _want("x", x, (1, group * R), device)
    elif form == "chain":
        _want("x", x, (1, COLS), device)
    rows = stage_rows(stage_kb)
    span = COLS if form == "chain" else N * R
    if span % rows:
        raise ValueError(f"{span} rows do not split into stages of {rows} "
                         f"rows ({stage_kb} KB)")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = 2 * sms  # the kernel's most blocks: its partial rows, then
    part_rows = blocks + -(-blocks // FOLD_GROUP)  # one a group of them
    s = _scratch_for(device, max(part_rows * STRIDE_OUT, group * COLS))
    out = torch.empty((1, 128), dtype=torch.float32, device=device)
    chk = torch.empty((), dtype=torch.float32, device=device)
    rc = _build.lib().bark_dma_probe(
        FORMS.index(form), METHODS.index(method), src.data_ptr(),
        None if x is None else x.data_ptr(), s["xbuf"].data_ptr(), N, R,
        group, ring if method in RING_METHODS else 1, rows, passes,
        s["partial"].data_ptr(), s["partial"].numel(),
        s["tickets"].data_ptr(), N_TICKETS, s["total"].data_ptr(),
        out.data_ptr(), chk.data_ptr(), _build.stream_ptr(device))
    _build.check(f"dma_probe[{form},{method}]", rc)
    launches[form] += passes * N // group if form == "chain" else 1
    return out, chk


def _probe(form, N, R, ring, passes, group=1, method="bulk", stage_kb=16):
    _check_config(form, method, ring, stage_kb)
    if N <= 0 or R <= 0 or passes <= 0:
        raise ValueError(f"N {N}, R {R}, passes {passes}: want > 0")

    def run(src, x=None):
        if src.device.type != "cuda":
            return plain(form, src, x, passes, group)
        return _launch(form, method, src, x, N, R, group, ring, stage_kb,
                       passes)

    return run


def make_stream(N, R, ring, passes, method="bulk", stage_kb=16):
    """D1: run(src) -> (out, checksum)."""
    return _probe("stream", N, R, ring, passes, 1, method, stage_kb)


def make_stream_dot(N, R, ring, passes, method="bulk", stage_kb=16):
    """D2: run(src, x) -> (out, checksum), x (1, R)."""
    return _probe("dot", N, R, ring, passes, 1, method, stage_kb)


def make_stream_dotgroup(N, R, ring, passes, group, method="bulk",
                         stage_kb=16):
    """D3: run(src, x) -> (out, checksum), x (1, group R). Needs group |
    ring and group | N, as the reference does."""
    if group <= 0 or ring % group or N % group:
        raise ValueError(f"dotgroup: group {group} must divide ring {ring} "
                         f"and N {N}")
    return _probe("dotgroup", N, R, ring, passes, group, method, stage_kb)


def make_stream_chain(N, R, ring, passes, group, method="bulk",
                      stage_kb=16):
    """D4: run(src, x) -> (out, checksum), x (1, 1024). Needs R == 1024,
    group | ring and group | N, as the reference does."""
    if R != COLS or group <= 0 or ring % group or N % group:
        raise ValueError(f"chain: want R == {COLS} (got {R}) and group "
                         f"{group} dividing ring {ring} and N {N}")
    return _probe("chain", N, R, ring, passes, group, method, stage_kb)


def make_stream2(N, R, ring, passes, method="bulk", stage_kb=16):
    """D5: run(src) -> (out, checksum)."""
    return _probe("dual", N, R, ring, passes, 1, method, stage_kb)


MAKERS = {"stream": make_stream, "dot": make_stream_dot,
          "dotgroup": make_stream_dotgroup, "chain": make_stream_chain,
          "dual": make_stream2}


def make(form: str, N, R, ring, passes, group=1, method="bulk",
         stage_kb=16):
    """The `make_*` of `form` (group only for dotgroup and chain)."""
    kw = dict(method=method, stage_kb=stage_kb)
    if form in ("dotgroup", "chain"):
        return MAKERS[form](N, R, ring, passes, group, **kw)
    return MAKERS[form](N, R, ring, passes, **kw)


# ------------------------------------------------------------ timing


def bandwidth(form: str, src, x=None, *, ring=2, group=1, method="bulk",
              stage_kb=16, p_lo=4, p_hi=24, reps=3) -> dict:
    """Time `form` on the card: the per-pass time is the difference between
    a p_hi- and a p_lo-pass launch over p_hi - p_lo (launch cost and the
    fold cancel), and the rate is N R 1024 x 2 bytes a pass over it.
    Returns gbs, share (of 3.35 TB/s), ms_per_pass, us_per_link (D4) and
    the two launches' ms. Raises unless src is on a CUDA device."""
    if src.device.type != "cuda":
        raise ValueError("bandwidth times the card: src must be on a CUDA "
                         "device")
    if p_hi <= p_lo:
        raise ValueError(f"p_hi {p_hi} must exceed p_lo {p_lo}")
    N, R, _ = src.shape
    args = (x,) if form != "stream" and form != "dual" else ()
    ms = [least_ms(lambda f=make(form, N, R, ring, p, group, method,
                                  stage_kb): f(src, *args), reps)
          for p in (p_lo, p_hi)]
    per_pass = (ms[1] - ms[0]) / (p_hi - p_lo)
    gbs = N * R * ROW_BYTES / (per_pass * 1e-3) / 1e9
    res = dict(gbs=gbs, share=gbs * 1e9 / HBM_BYTES_PER_S,
               ms_per_pass=per_pass, ms_lo=ms[0], ms_hi=ms[1])
    if form == "chain":
        res["us_per_link"] = per_pass * 1e3 / (N // group)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=int, default=256, help="array MB per pass")
    ap.add_argument("--rows", default="512,1024,2048,4096",
                    help="tile rows R (tile bytes = rows * 2 KB)")
    ap.add_argument("--rings", default="2,3,4",
                    help="ring depths of the ring methods")
    ap.add_argument("--p-lo", type=int, default=4)
    ap.add_argument("--p-hi", type=int, default=24)
    ap.add_argument("--dual", action="store_true",
                    help="two interleaved rings (D5)")
    ap.add_argument("--dot", action="store_true",
                    help="consume each tile with a (1,R)@(R,1024) GEMV (D2)")
    ap.add_argument("--dotgroup", type=int, default=0,
                    help="consume G tiles with one (1,G*R)@(G*R,1024) GEMV "
                    "(D3); needs G | ring")
    ap.add_argument("--chain", default="",
                    help="comma list of group sizes for the dependent chain "
                    "(D4), one launch a link; R must be 1024 and G | ring")
    ap.add_argument("--method", default=",".join(METHODS),
                    help="comma list of load methods")
    ap.add_argument("--stage-kb", default="8,16,32",
                    help="comma list of stage sizes in KB")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("probes.dma measures the card: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(device)}", file=sys.stderr)
    torch.backends.cuda.matmul.allow_tf32 = False
    methods = args.method.split(",")
    stage_kbs = [int(s) for s in args.stage_kb.split(",")]
    rings = [int(r) for r in args.rings.split(",")]
    total = args.mb * (1 << 20)
    gen = torch.Generator(device=device)
    for R in [int(r) for r in args.rows.split(",")]:
        N = total // (R * ROW_BYTES)
        gen.manual_seed(0)
        src = torch.randn((N, R, COLS), generator=gen, device=device).to(
            torch.bfloat16)
        if args.chain:
            if R != COLS:
                continue
            jobs = [("chain", int(g)) for g in args.chain.split(",")]
        elif args.dotgroup:
            jobs = [("dotgroup", args.dotgroup)]
        else:
            jobs = [("dot" if args.dot else "dual" if args.dual
                     else "stream", 1)]
        for form, G in jobs:
            if N % G:
                continue
            gen.manual_seed(1)
            xlen = COLS if form == "chain" else G * R
            x = torch.randn((1, xlen), generator=gen, device=device).to(
                torch.bfloat16)
            for method, ring, kb, ok in sweep(form, G, methods, rings,
                                              stage_kbs):
                tag = (f"{form}{G if G > 1 else ''} tile "
                       f"{R * ROW_BYTES / (1 << 20):>4.1f} MB {method}"
                       + (f" ring {ring}" if method in RING_METHODS else "")
                       + f" stage {kb} KB")
                if not ok:
                    print(f"{tag}: skipped, rings exceed shared memory",
                          flush=True)
                    continue
                r = bandwidth(form, src, x, ring=ring, group=G,
                              method=method, stage_kb=kb, p_lo=args.p_lo,
                              p_hi=args.p_hi)
                link = (f"  {r['us_per_link']:.2f} us/link"
                        if form == "chain" else "")
                print(f"{tag}: {r['gbs']:7.1f} GB/s  "
                      f"({100 * r['share']:.1f}% of 3.35 TB/s){link}",
                      flush=True)
        del src
    return 0


if __name__ == "__main__":
    sys.exit(main())
