"""Rank functions for `launch.spawn` that serve batches on a mesh and
report what every rank computed: what the multi-rank CPU tests
(tests/test_torch_sharding.py) drive. They live in the package because a
spawned rank imports the module that defines its function, and a test
module imports JAX; reference data comes in as numpy files.

- `serve(device, jobs)`: each job loads a model file, shards the context
  (`shard_context_dp` or `shard_context` on a mesh of every rank, or
  nothing) and runs `_generate_batch` on its prompts, with its lane noise
  replayed from a file when it names one;
- `mesh_report(device, spec)`: the mesh, the shards' shapes and the step
  factories' logits on given weights and inputs;
- `run(device, calls)`: several of them in one spawn.
"""

from __future__ import annotations

import contextlib
import sys
import time


def run(device, calls) -> list:
    """[fn(device, arg) for (name, arg) in calls], fn this module's
    function `name`."""
    return [getattr(sys.modules[__name__], name)(device, arg)
            for name, arg in calls]


@contextlib.contextmanager
def counted_plain_calls():
    """Count the calls of the plain references that every kernel's plain
    version runs inside (`gpt.decode_step`, `gpt.prefill`)."""
    from bark_tpu_torch.models import gpt

    calls = {"decode_step": 0, "prefill": 0}
    saved = {k: getattr(gpt, k) for k in calls}

    def counting(k):
        def fn(*a, **kw):
            calls[k] += 1
            return saved[k](*a, **kw)
        return fn

    for k in calls:
        setattr(gpt, k, counting(k))
    try:
        yield calls
    finally:
        for k, f in saved.items():
            setattr(gpt, k, f)


def noise_replay(path: str, device):
    """A `lane_noise_source` that returns, for (stage, lane, shape), the
    first shape[0] rows of the file's array "<stage>/<lane>" (rows of a
    stage's noise come out the same whatever their count: the coarse
    stage's a window at a time, the fine stage's a block at a time)."""
    import numpy as np
    import torch

    arrays = dict(np.load(path))

    def source(stage, lane, shape):
        a = arrays[f"{stage}/{lane}"]
        if a.shape[1:] != tuple(shape[1:]) or a.shape[0] < shape[0]:
            raise ValueError(f"{stage}/{lane}: recorded {a.shape}, asked "
                             f"for {tuple(shape)}")
        return torch.from_numpy(a[:shape[0]]).to(device)

    return source


def _context(device, job):
    import bark_tpu_torch as bt
    from bark_tpu_torch.parallel import sharding

    ctx = bt.bark_load_model(job["model"],
                             bt.BarkContextParams(**job["params"]),
                             seed=job.get("seed", 0), device=device)
    mode = job.get("mode")
    if mode == "dp":
        sharding.shard_context_dp(ctx, sharding.make_dp_mesh())
    elif mode == "tp":
        sharding.shard_context(ctx, sharding.make_mesh(dp=job["dp"]))
    elif mode is not None:
        raise ValueError(f"mode {mode!r}: want None, 'dp' or 'tp'")
    if job.get("noise"):
        ctx.lane_noise_source = noise_replay(job["noise"], device)
    return ctx


def serve(device, jobs) -> list:
    """For each job (dict: model, params (BarkContextParams fields), seed,
    texts, mode None | "dp" | "tp", dp (the tp mode's mesh rows), noise
    (an .npz for `noise_replay`, or None for the context's own noise)):
    dict(lanes=`_generate_batch(texts)`'s lanes, stats, launches (the
    kernels' counts over the batch), plain_calls (of the kernels' plain
    versions' references), seconds, mesh, forward)."""
    import dataclasses

    from bark_tpu_torch import kernels

    out = []
    for job in jobs:
        ctx = _context(device, job)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with counted_plain_calls() as plain:
            lanes = ctx._generate_batch(job["texts"])
        out.append(dict(
            lanes=lanes, stats=dataclasses.asdict(ctx.stats),
            launches=kernels.launch_counts(),
            plain_calls=sum(plain.values()),
            seconds=time.perf_counter() - t0,
            mesh=None if ctx._dp_mesh is None else ctx._dp_mesh.shape,
            forward=ctx._forward.name))
    return out


def mesh_report(device, spec) -> dict:
    """spec: dict(n, dp, cfg (GPTConfig fields), arrays (an .npz: the
    params' leaves as "wte", "blocks/qkv_w", ..., and "tokens", "n_past",
    "x_emb", "n_valid", "tokens2"), qpack_model (a model file whose coarse
    section is block-quantized)). Returns the mesh's shape and this rank's
    coord, the error of a mesh whose dp does not divide n, the dp mesh's
    shape, every shard's shape, this rank's qkv_w and qkv_b shards, the
    qpack shards' shapes, and the step factories' logits: a decode step
    of "tokens" at "n_past" on fresh caches, a prefill of "x_emb" to
    "n_valid", then a decode step of "tokens2" at the prefill's length; the
    last two again on int8 caches, with this rank's lanes and their caches'
    row scales."""
    import numpy as np
    import torch

    from bark_tpu_torch.io import ggml, loader
    from bark_tpu_torch.models.config import GPTConfig
    from bark_tpu_torch.parallel import sharding

    n, dp = spec["n"], spec["dp"]
    out = {}
    try:  # refused before any group is made, so every rank goes on alike
        sharding.make_mesh(n, dp=n - 1)
    except ValueError as exc:
        out["bad_dp"] = str(exc)
    mesh = sharding.make_mesh(n, dp=dp)
    out.update(mesh=mesh.shape, coord=mesh.coord,
               dp_mesh=sharding.make_dp_mesh().shape)
    cfg = GPTConfig(**spec["cfg"])
    arrays = dict(np.load(spec["arrays"]))
    tree = {"blocks": {}}
    for key, a in arrays.items():
        if key.startswith("blocks/"):
            tree["blocks"][key[7:]] = a
        elif key in ("wte", "wpe", "lm_head", "ln_f_g", "ln_f_b"):
            tree[key] = a
    params = loader.params_from_numpy(tree, torch.float32, device)
    sp = sharding.shard_gpt_params(mesh, cfg, params)
    out["shapes"] = {k: tuple(v.shape) for k, v in sp.items()
                     if k != "blocks"}
    out["shapes"].update({f"blocks/{k}": tuple(v.shape)
                          for k, v in sp["blocks"].items()})
    out["qkv_w"] = sp["blocks"]["qkv_w"].cpu().numpy()
    out["qkv_b"] = sp["blocks"]["qkv_b"].cpu().numpy()
    sec = ggml.read_model_file(spec["qpack_model"]).coarse
    _, qp = loader.gpt_qparams_from_section(sec, torch.float32, device)
    sq = sharding.shard_qpack_params(mesh, qp)
    out["qpack_shapes"] = {k: tuple(v.shape) for k, v in sq["blocks"].items()}
    out["qpack_shapes"].update({k: tuple(v.shape) for k, v in sq.items()
                                if k != "blocks"})

    tokens = torch.from_numpy(arrays["tokens"]).to(device)
    kc, vc = sharding.init_kv_cache(cfg, mesh, len(tokens), torch.float32,
                                    device)
    step = sharding.make_batched_decode_step(cfg, mesh)
    logits, _, _ = step(sp, tokens, kc, vc, int(arrays["n_past"]))
    out["decode"] = logits.cpu().numpy()
    x_emb = torch.from_numpy(arrays["x_emb"]).to(device)
    kc, vc = sharding.init_kv_cache(cfg, mesh, x_emb.shape[0],
                                    torch.float32, device)
    prefill = sharding.make_batched_prefill(cfg, mesh)
    n_valid = [int(v) for v in arrays["n_valid"]]
    logits, kc, vc = prefill(sp, x_emb, kc, vc, n_valid)
    out["prefill"] = logits.cpu().numpy()
    tokens2 = torch.from_numpy(arrays["tokens2"]).to(device)
    logits, _, _ = step(sp, tokens2, kc, vc, max(n_valid))
    out["decode2"] = logits.cpu().numpy()
    # the same prefill and step on int8 caches, with their row scales
    kc, vc = sharding.init_kv_cache(cfg, mesh, x_emb.shape[0],
                                    torch.float32, device, quant=True)
    logits, kc, vc = prefill(sp, x_emb, kc, vc, n_valid)
    out["prefill_int8"] = logits.cpu().numpy()
    logits, _, _ = step(sp, tokens2, kc, vc, max(n_valid))
    out["decode2_int8"] = logits.cpu().numpy()
    out["scales_int8"] = [c["s"].cpu().numpy() for c in (kc, vc)]
    out["lanes"] = mesh.lanes(x_emb.shape[0])
    return out
