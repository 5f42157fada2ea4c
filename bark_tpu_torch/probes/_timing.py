"""How the probes time the card: one helper for each way, named by what it
returns.

- `least_ms`: the least time of one call between CUDA events, over a few
  calls one at a time (the weight-stream probe's passes, each hundreds of
  MB).
- `mean_ms`: the mean time of a call over calls queued behind a device
  sleep, each call's inputs read from device memory: the calls take turns
  over copies of their inputs (`copies_for`), the L2 is evicted before the
  run, and no call writes where an earlier call of the run wrote. A bound
  counted in bytes at the device memory's rate is then a floor.
- `profiled_us`: the device time of one launch of a named kernel, from
  `torch.profiler`, where the gaps between launches are to be told apart.
"""

from __future__ import annotations

import math

import torch

L2_BYTES = 50 * 2**20         # H100 SXM: what a repeated call's data stays in
COLD_BYTES = 4 * L2_BYTES     # traffic that leaves none of an earlier call's
SLEEP_CYCLES = 200_000_000    # ~0.1 s of device sleep: the host queues ahead

_evict = {}  # device index -> a COLD_BYTES buffer read to evict the L2


def least_ms(fn, reps: int = 3) -> float:
    """The least device time of fn() over `reps` calls, each between CUDA
    events, after one warm-up call."""
    fn()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def copies_for(nbytes: int, n: int) -> int:
    """How many copies of a call's inputs `mean_ms` needs for n calls that
    each move `nbytes`: enough that a copy comes round again only after
    COLD_BYTES of the others, and never more than the n calls and the
    warm-up use."""
    return max(1, min(n + 1, 1 + math.ceil(COLD_BYTES / max(1, nbytes))))


def evict_l2(device) -> None:
    """Read COLD_BYTES on `device`'s current stream, so that nothing read or
    written before stays in the L2."""
    buf = _evict.get(device.index)
    if buf is None:
        buf = torch.ones(COLD_BYTES // 4, dtype=torch.float32, device=device)
        _evict[device.index] = buf
    buf.amax()


def mean_ms(calls, n: int = 20, queue: bool = True) -> float:
    """Mean device ms of a call over n calls between one pair of CUDA
    events. `calls` is a callable, or a list of them taken in turn, each on
    its own copy of the inputs (`copies_for` says how many). The calls run
    once untimed (every callable at least once; PyTorch's allocator then
    holds the blocks the run asks for) and the L2 is evicted, so a call's
    inputs come from device memory; every result is held until the run
    ends, so that no call writes into a block an earlier call of the run
    wrote. `queue`: the calls wait behind a device sleep, so the host's
    work between them is not timed; a call that reads a value on the host
    waits for the device anyway: time it with queue=False."""
    calls = list(calls) if isinstance(calls, (list, tuple)) else [calls]
    device = torch.device("cuda", torch.cuda.current_device())
    held = [calls[i % len(calls)]() for i in range(max(n, len(calls)))]
    torch.cuda.synchronize()
    del held
    evict_l2(device)
    if queue:
        torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    held = [calls[i % len(calls)]() for i in range(n)]
    end.record()
    end.synchronize()
    del held
    return start.elapsed_time(end) / n


def profiled_us(fn, pattern: str, n: int = 1):
    """Device µs a launch of the kernels whose names hold `pattern`, from
    torch.profiler over n calls of fn after a warm-up call (their device
    time over their launches), or None when the profiler shows no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if pattern in e.key and e.count:
            t = getattr(e, "device_time_total", None)
            total += t if t is not None else getattr(e, "cuda_time_total", 0)
            count += e.count
    return total / count if total else None
