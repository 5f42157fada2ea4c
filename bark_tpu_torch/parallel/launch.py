"""Start the ranks of a multi-process run on one machine, with no network.

`spawn(fn, world, device, *args)` starts `world` processes with
`torch.multiprocessing` (the spawn method: each starts from a fresh
interpreter and imports the module that defines `fn`, so `fn` must be a
module-level function of an importable module, and its arguments and
result picklable). Each rank sets its device, joins a process group whose
rendezvous is a file store in a temporary directory, runs
`fn(device, *args)` and leaves the group. `spawn` returns the ranks'
results in rank order, or raises with the traceback of the first rank
that failed after stopping the others: a failing rank fails the run,
nothing carries on without it.

`device`: "cpu" (every rank on the CPU, gloo), "cuda" (rank r on cuda:r,
NCCL; with more ranks than GPUs, rank r on cuda:(r % GPUs) over gloo) or
"cuda:N" (every rank on that one GPU, gloo: NCCL refuses two ranks on one
device). "cuda" on a machine without a GPU raises. Each rank runs one
intra-op torch thread: the ranks share the machine's cores.

`process_group(world, rank, device)` is the same set-up for a process that
joins a group itself (a world of 1 in the caller's own process).

Users start the ranks with torchrun instead, one process per GPU, and
give `init_process_group` the rendezvous torchrun sets up:

    torchrun --standalone --nproc-per-node 4 serve.py

where serve.py calls `torch.cuda.set_device(local_rank)`,
`torch.distributed.init_process_group("nccl")`, loads the model on its
GPU, and calls `parallel.sharding.shard_context_dp(ctx, make_dp_mesh())`
or `shard_context(ctx, make_mesh(dp=2))` before `generate_audio_batch`.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _gpus() -> int:
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device 'cuda': no CUDA GPU is available")
    return n


def rank_device(device: str, rank: int) -> torch.device:
    """Rank `rank`'s device: "cuda" puts rank r on GPU r % the GPU count."""
    if device == "cuda":
        return torch.device(f"cuda:{rank % _gpus()}")
    return torch.device(device)


def default_backend(device: str, world: int) -> str:
    """NCCL for one GPU a rank, gloo otherwise."""
    return "nccl" if device == "cuda" and world <= _gpus() else "gloo"


@contextlib.contextmanager
def process_group(world: int, rank: int, device: str, init_method=None,
                  timeout_s: float = 600.0):
    """Join a `world`-rank process group as `rank` on `device` (a file
    store in a temporary directory of its own when `init_method` is None,
    which only a world of 1 can share) and leave it on exit. Yields the
    rank's torch.device."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="bark_pg_")
        init_method = f"file://{os.path.join(tmp, 'store')}"
    dist.init_process_group(
        default_backend(device, world), init_method=init_method,
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield dev
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(fn, rank, world, device, init_method, timeout_s, results,
               args):
    torch.set_num_threads(1)
    try:
        with process_group(world, rank, device, init_method,
                           timeout_s) as dev:
            out = fn(dev, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, device: str, *args, timeout_s: float = 600.0):
    """Run fn(rank's torch.device, *args) on `world` ranks; returns their
    results in rank order. Raises RuntimeError with the failing rank's
    traceback (or exit code) if any rank fails or the run takes longer
    than timeout_s."""
    rank_device(device, 0)  # "cuda" without a GPU fails here, not in a rank
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="bark_spawn_")
    init_method = f"file://{os.path.join(tmp, 'store')}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, rank, world, device, init_method, timeout_s, results, args),
        daemon=True) for rank in range(world)]
    for p in procs:
        p.start()
    outs, failure = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(outs) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in outs and p.exitcode not in (None, 0)]
                if dead and results.empty():
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    failure = f"the ranks took more than {timeout_s} s"
                continue
            if ok:
                outs[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
        if failure is not None:
            raise RuntimeError(f"spawn of {world} ranks on {device}: "
                               f"{failure}")
        return [outs[r] for r in range(world)]
    finally:
        for p in procs:  # a rank still running here is stuck or unwanted
            if len(outs) < world and p.is_alive():
                p.terminate()
            p.join(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
