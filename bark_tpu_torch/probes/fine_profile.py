"""Where the fine stage's device time goes: bark-small's fine stage in bf16
over B lanes, split by what launched each device kernel.

    python3 bark_tpu_torch/probes/fine_profile.py [--tree PATH] [--tag NAME]

Run it by path, as `prefill_profile.py`, whose `main` it shares (`--tree`:
the checkout whose port is timed; it needs a CUDA device). On random bf16
fine weights from seed 0 (`gpt.init_params`), random coarse codes of 207
frames a lane (the smoke's 138 semantic steps: one 1024-row block) and
seeded Gumbel noise at fine_temp 0.5, for B in LANES it runs the stage
program (`pipeline.fine.make_fine_stage_program`, one call over the B
lanes) and records:

- the call's wall seconds, synchronised (mean of REPS calls after a
  warm-up call), and the peak of `torch.cuda.max_memory_allocated` over
  the memory allocated before it;
- one call under torch.profiler (CPU and CUDA activities): each device
  kernel's µs under the scope it ran in, `products`
  (`gpt._dot`: the layers' projections and the head, operands cast to
  f32), `attention` (`gpt._attention`: scores, mask, softmax, context),
  `sampling` (`ops.sampling.sample_rows`) or `other` (embeddings,
  LayerNorms, GELU, residual adds, casts, the keep-mask writes); the
  call's span from its first kernel's start to its last kernel's end, its
  busy µs (the union of the kernels' intervals), the gaps (span - busy)
  and the device-busy share (busy / span, and busy over the unprofiled
  wall seconds: the profiler's own host work stretches a host-bound
  call's span). A session that records no device activity is run again
  (as `prefill_profile.profiled_call` does).

The scopes are `torch.profiler.record_function` ranges that this script
wraps around those three functions while it runs; the port itself records
none. A kernel's scope is the range whose device-side span (kineto's GPU
user annotation, named as the range) holds it: the stream runs the
kernels in launch order, so that span holds exactly the kernels launched
inside the range. Prints log lines on stderr and one `fine_profile` JSON
line on stdout, also written as fine_profile_<tag>.json under
chiprun_out/.
"""

from __future__ import annotations

import sys
import time

try:  # imported from the package
    from bark_tpu_torch.probes import prefill_profile as pp
except ImportError:  # run by path: the sibling, before the tree is known
    import prefill_profile as pp

LANES = (1, 32)
FRAMES = 207
REPS = 3
SCOPES = ("products", "attention", "sampling")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def scoped(module, name: str, scope: str):
    """Wrap module.name in a record_function range `scope`; returns the
    function to restore."""
    from torch.profiler import record_function

    fn = getattr(module, name)

    def wrapped(*a, **kw):
        with record_function(scope):
            return fn(*a, **kw)

    setattr(module, name, wrapped)
    return fn


def split(fn, wait_s: float = 30.0) -> dict:
    """One synchronised call of fn under torch.profiler: device µs by
    scope, busy (the union of the kernels' intervals), span, gaps and the
    busy share. The scopes' own ranges also come back as device events
    (kineto's GPU user annotations, named as the scope): they give each
    kernel its scope and are left out of the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    pause, end = 0.01, time.monotonic() + wait_s
    while True:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        dev = sorted((e for e in events
                      if e.device_type == cuda and e.name not in SCOPES),
                     key=lambda e: e.time_range.start)
        if dev:
            break
        if time.monotonic() + pause > end:
            raise AssertionError("torch.profiler saw no device activity "
                                 f"in {wait_s:.0f} s of sessions")
        time.sleep(pause)
        pause = min(2 * pause, 2.0)
    # the scopes' ranges on the device timeline span the kernels launched
    # inside them, and the three scopes never nest: each kernel goes to
    # the range that holds it
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events
                    if e.device_type == cuda and e.name in SCOPES)
    scopes = dict.fromkeys(SCOPES + ("other",), 0.0)
    i = 0
    for d in dev:
        start, stop = d.time_range.start, d.time_range.end
        while i < len(ranges) and ranges[i][1] < start:
            i += 1
        inside = i < len(ranges) and ranges[i][0] <= start and \
            stop <= ranges[i][1]
        scopes[ranges[i][2] if inside else "other"] += stop - start
    busy, last = 0.0, float("-inf")
    for e in dev:
        start, stop = e.time_range.start, e.time_range.end
        busy += max(0.0, stop - max(start, last))
        last = max(last, stop)
    span = dev[-1].time_range.end - dev[0].time_range.start
    return dict(kernels=len(dev), busy_us=busy, span_us=span,
                gaps_us=span - busy, busy_share=busy / span,
                kernel_sum_us=sum(e.time_range.end - e.time_range.start
                                  for e in dev),
                scopes_us=scopes, scope_ranges=len(ranges))


def profile(tag: str) -> dict:
    import torch

    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.models.presets import BARK_SMALL
    from bark_tpu_torch.ops import sampling
    from bark_tpu_torch.params import BarkContextParams
    from bark_tpu_torch.pipeline import fine

    dev = torch.device("cuda")
    cfg = BARK_SMALL["fine"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = gpt.init_params(cfg, gen, torch.bfloat16, dev)
    p = BarkContextParams(compute_dtype="bfloat16", fine_temp=0.5)
    n_coarse, n_fine = p.n_coarse_codebooks, p.n_fine_codebooks
    prog = fine.make_fine_stage_program(cfg, p)
    n_loops = fine.fine_schedule(FRAMES, cfg.block_size)[1]
    rec = dict(frames=FRAMES, blocks=n_loops, reps=REPS)
    for B in LANES:
        codes = [torch.randint(0, p.codebook_size, (FRAMES, n_coarse),
                               generator=gen, device=dev, dtype=torch.int32)
                 for _ in range(B)]
        noise = [sampling.gumbel((n_loops, n_fine - n_coarse,
                                  cfg.block_size, p.codebook_size), gen, dev)
                 for _ in range(B)]

        def run():
            return prog(params, codes, [FRAMES] * B, noise)

        run()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(REPS):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / REPS
        peak = torch.cuda.max_memory_allocated() - base
        saved = [(gpt, "_dot", scoped(gpt, "_dot", "products")),
                 (gpt, "_attention", scoped(gpt, "_attention",
                                            "attention")),
                 (sampling, "sample_rows",
                  scoped(sampling, "sample_rows", "sampling"))]
        try:
            s = split(run)
        finally:
            for module, name, fn in saved:
                setattr(module, name, fn)
        rec[f"B{B}"] = dict(wall_s=wall, s_a_lane=wall / B,
                            peak_bytes=peak,
                            busy_of_wall=s["busy_us"] / 1e6 / wall, **s)
        log(f"  {tag} fine stage B={B}: {wall:.6f} s ({wall / B:.6f} s a "
            f"lane), peak +{peak / 2**30:.3f} GiB; {s['kernels']} device "
            f"kernels, busy {s['busy_us']:.0f} us of span "
            f"{s['span_us']:.0f} us (share {s['busy_share']:.4f}; of the "
            f"unprofiled wall {s['busy_us'] / 1e6 / wall:.4f}), gaps "
            f"{s['gaps_us']:.0f} us; " + ", ".join(
                f"{k} {v:.0f} us" for k, v in s["scopes_us"].items()))
        del codes, noise
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    return pp.main(argv, profile=profile, name="fine_profile", doc=__doc__)


if __name__ == "__main__":
    sys.exit(main())
