"""How reliably torch.profiler records a call's device kernels on this card:
many short sessions in one process, each around one synchronised call.

    python3 -m bark_tpu_torch.probes.profiler_sessions [--sessions 3000]

Each call (a 1024 x 1024 bf16 matmul and an in-place scale, two device
kernels) goes through `prefill_profile.profiled_call`, which runs a session
again after a pause while it records no device activity. Prints one
`profiler_sessions` JSON line: the calls, the sessions they took, the
empty sessions, the runs of empty sessions before a call's kernels were
seen (their lengths and seconds, the longest first), the calls whose
session held another count of device events than two, and the seconds in
all. Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def sessions(n: int) -> dict:
    import torch

    from bark_tpu_torch.probes import prefill_profile as pp

    x = torch.randn(1024, 1024, device="cuda", dtype=torch.bfloat16)
    opened = [0]

    def fn():
        opened[0] += 1
        torch.matmul(x, x)
        x.mul_(0.5)

    fn()
    torch.cuda.synchronize()
    opened[0] = 0
    runs, other, t0 = [], {}, time.monotonic()
    for i in range(n):
        before, t = opened[0], time.monotonic()
        events = len(pp.profiled_call(fn))
        if opened[0] - before > 1:
            runs.append(dict(call=i, empty=opened[0] - before - 1,
                             s=time.monotonic() - t))
        if events != 2:
            other[events] = other.get(events, 0) + 1
    runs.sort(key=lambda r: (-r["empty"], -r["s"]))
    return dict(calls=n, sessions=opened[0], empty=opened[0] - n,
                runs=runs[:20], n_runs=len(runs),
                other_event_counts={str(k): v for k, v in other.items()},
                seconds=time.monotonic() - t0, torch=torch.__version__)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=3000)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profiler_sessions: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"profiler_sessions": sessions(args.sessions)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
