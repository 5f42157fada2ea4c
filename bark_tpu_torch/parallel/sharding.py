"""Multi-GPU serving on torch.distributed: data parallel and tensor
parallel on a (dp, tp) mesh of ranks.

The counterpart of `bark_tpu.parallel.sharding`. The PyTorch idiom is one
process per rank (SPMD, as `torchrun` or `parallel.launch.spawn` start
them): every rank loads the same model, makes the same mesh, calls the
same API with the same arguments and gets the same result back. The
collectives run on the process group's backend, NCCL between GPUs and
gloo on the CPU; two ranks on one GPU take gloo (NCCL refuses them),
whose collectives on CUDA tensors go through host memory here.

Two serving modes, as in the JAX package:

- `shard_context_dp`, kernel-preserving data parallelism: every weight
  (dense or a qpack) stays whole on every rank, and `generate_audio_batch`
  runs this rank's contiguous slice of the lanes (`Mesh.lanes`) through
  the port's batched path (K8 prefills, K9 semantic chunks and K10 coarse
  windows, K5-batched on a qpack, K6 on the int8 cache; then the fine
  stage and the codec), and the ranks gather every lane. JAX
  `shard_map`s its four batched stage programs over the `dp` axis instead
  (`wrap_dp_programs`); the port keeps the stages in lockstep across the
  ranks, so every lane's noise is the unsharded batch's
  (`api.context.BarkContext._generate_group`).
- `shard_context`, tensor parallelism: the GPT stages' params are cut
  column- and row-parallel over `tp` (`gpt_param_specs`, the qpack tables
  `_QPACK_SPECS` / `_QPACK_BLOCK_SPECS`), the codec stays whole, the batch
  rides `dp` as above, and the batched stage programs run
  `parallel.tp.TensorParallelForward`, plain PyTorch with the collectives
  written out (JAX leaves this mode to GSPMD and XLA, abandoning its
  Pallas kernels; so does the port: a tp context launches no kernel).

Placement keeps this rank's shard of each tensor and the JAX fall-back
rules: an axis that does not divide tp stays whole, and a qpack plane
whose shard would split a 32-value quant block stays whole.

The fused QKV. JAX cuts `qkv_w`'s 3D output axis into tp contiguous
chunks and GSPMD reshards around the attention. A hand-written forward
needs each rank to hold the q, k and v columns (and bias entries) of the
same heads, so the port cuts each of q, k and v into tp chunks and keeps
chunk t of all three: rank t's columns are [t*D/tp, (t+1)*D/tp) of q,
then of k, then of v. The shard's shape is JAX's ((L, D, 3D/tp)); its
columns differ. Where tp divides D but not n_head, each chunk splits a
head: the forward gathers the q, k and v columns and runs every head on
every rank. Where tp does not divide D, the chunks are JAX's contiguous
ones, gathered the same way.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from bark_tpu_torch.models import gpt
from bark_tpu_torch.pipeline.forward import KERNELS


class Mesh:
    """A (dp, tp) grid of the process group's ranks: rank r sits at
    (r // tp, r % tp), as `np.reshape(dp, tp)` places devices. Holds
    `shape` ({"dp": dp, "tp": tp}, or {"dp": dp} for a 1-axis dp mesh),
    this rank's `coord` (its dp row, its tp column), `tp_group` (the ranks
    of its dp row, on the process group's backend: the forward's
    collectives) and `dp_group` (the ranks of its tp column, on gloo: the
    lanes' host objects)."""

    def __init__(self, dp: int, tp: int, axes, coord, dp_group, tp_group):
        self.dp, self.tp, self.axes = dp, tp, axes
        self.coord = coord
        self.dp_group, self.tp_group = dp_group, tp_group
        self._staged = dist.get_backend(tp_group) == "gloo"

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp} if "tp" in self.axes \
            else {"dp": self.dp}

    def lanes(self, B: int):
        """(lo, hi): this rank's contiguous slice of B lanes, the dp rows
        taking ceil(B / dp) lanes each in order (the last ones fewer, or
        none)."""
        per = -(-B // self.dp)
        lo = min(self.coord[0] * per, B)
        return lo, min(lo + per, B)

    def gather_lanes(self, mine: list) -> list:
        """Every dp row's `mine` (host objects: ints, numpy arrays, dicts of
        them), concatenated in dp order: for `mine` the items of this rank's
        `lanes`, every lane in order. Each tp column gathers on its own."""
        if self.dp == 1:
            return list(mine)
        parts = [None] * self.dp
        dist.all_gather_object(parts, list(mine), group=self.dp_group)
        return [x for part in parts for x in part]

    def _tensor(self, x):
        """x as the tp group's backend takes it: gloo's collectives stage
        CUDA tensors through host memory."""
        x = x.contiguous()
        return x.cpu() if self._staged and x.is_cuda else x

    def all_reduce(self, x, op=dist.ReduceOp.SUM):
        """The sum (or `op`) of x over the tp group, on every rank of it."""
        if self.tp == 1:
            return x
        buf = self._tensor(x)
        dist.all_reduce(buf, op=op, group=self.tp_group)
        return buf.to(x.device)

    def all_gather(self, x, dim: int = -1):
        """The tp group's x, concatenated along `dim` in rank order."""
        if self.tp == 1:
            return x
        buf = self._tensor(x)
        parts = [torch.empty_like(buf) for _ in range(self.tp)]
        dist.all_gather(parts, buf, group=self.tp_group)
        return torch.cat(parts, dim).to(x.device)


def _mesh(n_devices: Optional[int], dp: Optional[int], axes) -> Mesh:
    """The mesh of n_devices ranks, dp rows (all n for dp None)."""
    if dp is not None and n_devices is not None and n_devices % dp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by dp={dp}")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group: start the ranks "
                           "with torchrun or parallel.launch.spawn")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    dp = n if dp is None else dp
    if n % dp != 0:
        raise ValueError(f"n_devices={n} not divisible by dp={dp}")
    if n != world:
        raise ValueError(f"n_devices={n}: a mesh takes every rank of the "
                         f"process group ({world})")
    tp, rank = n // dp, dist.get_rank()
    coord = (rank // tp, rank % tp)
    # every rank makes every group, in the same order
    dp_group = tp_group = None
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)], backend="gloo")
        dp_group = g if t == coord[1] else dp_group
    for d in range(dp):
        g = dist.new_group([d * tp + t for t in range(tp)])
        tp_group = g if d == coord[0] else tp_group
    return Mesh(dp, tp, axes, coord, dp_group, tp_group)


def make_mesh(n_devices: Optional[int] = None, dp: int = 1) -> Mesh:
    """A (dp, tp) mesh over the process group's n_devices ranks (all of
    them), tp = n_devices // dp."""
    return _mesh(n_devices, dp, ("dp", "tp"))


def make_dp_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-axis data-parallel mesh for kernel-preserving dp serving."""
    return _mesh(n_devices, None, ("dp",))


# --------------------------------------------------------------- the specs
# A spec names, for each axis of a tensor, the mesh axis it is cut over
# (None: whole), as a JAX PartitionSpec does.


def gpt_param_specs(cfg) -> dict:
    """Specs for the GPT params dict (`models.gpt` layout)."""
    del cfg
    return {
        # embeddings: model-dim sharded
        "wte": (None, None, "tp"),
        "wpe": (None, "tp"),
        "lm_head": (None, "tp", None),  # vocab-sharded head
        "ln_f_g": (None,),
        "ln_f_b": (None,),
        "blocks": {
            "ln1_g": (None, None),
            "ln1_b": (None, None),
            "ln2_g": (None, None),
            "ln2_b": (None, None),
            # column-parallel: QKV (by heads, above) and MLP-in
            "qkv_w": (None, None, "tp"),
            "qkv_b": (None, "tp"),
            "fc_w": (None, None, "tp"),
            "fc_b": (None, "tp"),
            # row-parallel: attn-out and MLP-out, an all_reduce after each
            "proj_w": (None, "tp", None),
            "proj_b": (None, None),
            "out_w": (None, "tp", None),
            "out_b": (None, None),
        },
    }


def kv_cache_spec(batched: bool):
    """Caches (L, [B,] S, D): lanes over dp, the feature axis (this rank's
    heads) over tp."""
    return (None, "dp", None, "tp") if batched else (None, None, "tp")


# Packed-quantized (qpack) specs, layout `io.loader.gpt_qparams_from_section`:
# name -> (spec, blocked axis of the value plane or None). Scale and min
# planes follow their values' spec; their blocked axis is already /32.
_QPACK_SPECS = {
    "wte": ((None, None, "tp"), 2),      # (n_wtes, V, D); D is blocked
    "wpe": ((None, "tp"), None),
    "ln_f_g": ((None,), None),
    "ln_f_b": ((None,), None),
    "lm": ((None, "tp"), None),          # (D, v_pad); D (dim 0) is blocked
    "lm_heads": ((None, "tp", None), None),  # (n, V, D) vocab-sharded
}
_QPACK_BLOCK_SPECS = {
    "ln1_g": ((None, None), None),
    "ln1_b": ((None, None), None),
    "ln2_g": ((None, None), None),
    "ln2_b": ((None, None), None),
    "qkv": ((None, None, "tp"), None),   # (L, D, 3D) column-parallel
    "qkv_b": ((None, "tp"), None),
    "fc": ((None, None, "tp"), None),    # (L, D, 4D) column-parallel
    "fc_b": ((None, "tp"), None),
    "proj": ((None, "tp", None), 1),     # (L, D, D) row-parallel, in blocked
    "proj_b": ((None, None), None),
    "out": ((None, "tp", None), 1),      # (L, 4D, D) row-parallel, in blocked
    "out_b": ((None, None), None),
}


def _qpack_spec(name: str, in_blocks: bool):
    table = _QPACK_BLOCK_SPECS if in_blocks else _QPACK_SPECS
    if name in table:
        return table[name]
    for suffix in ("_q", "_s", "_m"):
        if name.endswith(suffix) and name[: -len(suffix)] in table:
            spec, blocked = table[name[: -len(suffix)]]
            return spec, (blocked if suffix == "_q" else None)
    return (), None


def _keep(mesh: Mesh, name: str, arr, spec, blocked=None):
    """This rank's shard of `arr` under `spec` (the whole tensor where the
    JAX rules keep it whole). A tensor of the fused QKV keeps its heads'
    q, k and v columns (the module docstring)."""
    tp, t = mesh.tp, mesh.coord[1]
    for dim, axis in enumerate(spec):
        if axis != "tp":
            continue
        n = arr.shape[dim]
        if tp == 1 or n % tp or (blocked == dim and (n // tp) % 32):
            return arr
        if name.startswith("qkv") and (n // 3) % tp == 0:
            w = n // 3 // tp
            return torch.cat([arr.narrow(dim, c * n // 3 + t * w, w)
                              for c in range(3)], dim)
        return arr.narrow(dim, t * (n // tp), n // tp).contiguous()
    return arr


def shard_gpt_params(mesh: Mesh, cfg, params):
    """This rank's shard of a GPT params dict (`gpt_param_specs`)."""
    specs = gpt_param_specs(cfg)
    out = {k: _keep(mesh, k, v, specs[k]) for k, v in params.items()
           if k != "blocks"}
    out["blocks"] = {k: _keep(mesh, k, v, specs["blocks"][k])
                     for k, v in params["blocks"].items()}
    return out


def shard_qpack_params(mesh: Mesh, qpack):
    """This rank's shard of a packed-quantized params dict: the int8
    value planes and their scale (and min) planes on the same logical
    axes, a row-parallel plane only where each rank keeps whole 32-value
    blocks. A tensor-parallel forward dequantizes the shard locally
    (`parallel.tp.TensorParallelForward.weights`)."""
    def place(tree, in_blocks):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = place(v, True)
            else:
                spec, blocked = _qpack_spec(k, in_blocks)
                out[k] = _keep(mesh, k, v, spec, blocked)
        return out

    return place(qpack, False)


def replicated(mesh: Mesh, tree):
    """A tree kept whole on every rank (the codec's weights etc.): every
    rank loaded it whole, and keeps it so."""
    del mesh
    return tree


def shard_context(ctx, mesh: Mesh):
    """Tensor-parallel serving: this rank keeps its shard of each GPT
    stage's params (dense or a qpack), the codec stays whole, and
    `generate_audio_batch` runs this rank's dp slice of the lanes through
    the batched stage programs on `parallel.tp.TensorParallelForward`
    (heads, MLP features and vocab over tp, an all_reduce after each
    row-parallel product). A single request (`generate_audio`, a stream,
    `warmup`) is refused on such a context."""
    from bark_tpu_torch.parallel.tp import TensorParallelForward

    for stage in ("semantic", "coarse", "fine"):
        params = getattr(ctx, f"{stage}_params")
        if gpt.is_qpack(params):
            params = shard_qpack_params(mesh, params)
        else:
            params = shard_gpt_params(mesh, getattr(ctx, f"{stage}_cfg"),
                                      params)
        setattr(ctx, f"{stage}_params", params)
    ctx.codec_params = replicated(mesh, ctx.codec_params)
    ctx._dp_mesh = mesh
    ctx._forward = TensorParallelForward(mesh)
    ctx._programs.clear()
    return ctx


def shard_context_dp(ctx, mesh: Mesh):
    """dp serving that keeps the batched kernel pipeline: every weight
    (dense or a qpack) whole on every rank, and `generate_audio_batch`
    runs this rank's slice of the lanes (`Mesh.lanes`) through K8-K10
    (K5-batched on a qpack, K6 on the int8 cache), the fine stage and the
    codec, then gathers every lane. Each lane is the unsharded batch's
    under the same noise source (the stages run in lockstep across the
    ranks). On a (dp, tp) mesh a dp row's ranks serve the same lanes."""
    if "dp" not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no 'dp' axis")
    for stage in ("semantic", "coarse", "fine"):
        setattr(ctx, f"{stage}_params",
                replicated(mesh, getattr(ctx, f"{stage}_params")))
    ctx.codec_params = replicated(mesh, ctx.codec_params)
    ctx._dp_mesh = mesh
    ctx._forward = KERNELS
    ctx._programs.clear()
    return ctx


# -------------------------------------------------- step factories


def init_kv_cache(cfg, mesh: Mesh, batch: int, dtype, device,
                  quant: bool = False):
    """This rank's (L, lanes, S, D_local) caches of a `batch`-lane batch
    (`kv_cache_spec(batched=True)`): its `Mesh.lanes` and its heads'
    features (all D where tp does not divide n_head); int8 caches when
    `quant`."""
    from bark_tpu_torch.parallel import tp

    lo, hi = mesh.lanes(batch)
    return tp.kv_cache(cfg, mesh, hi - lo, dtype, device, quant)


def make_batched_decode_step(cfg, mesh: Mesh):
    """Batched single-token decode over the mesh.

    fn(params (this rank's shard), tokens (B,), k_caches, v_caches (this
    rank's, `init_kv_cache`), n_past) -> (logits (B, n_out_vocab) f32 of
    every lane on every rank, k_caches, v_caches): the lanes ride dp and
    the heads, features and vocab tp; the caches are written in place."""
    from bark_tpu_torch.parallel.tp import TensorParallelForward

    fwd = TensorParallelForward(mesh)

    def step(params, tokens, k_caches, v_caches, n_past: int):
        lo, hi = mesh.lanes(len(tokens))
        rows = []
        if hi > lo:
            logits = fwd.step(cfg, fwd.weights(cfg, params)[1],
                              tokens[lo:hi], k_caches, v_caches,
                              [int(n_past)] * (hi - lo))
            rows = list(logits.cpu())
        return (torch.stack(mesh.gather_lanes(rows)).to(
            gpt.kv_device(k_caches)), k_caches, v_caches)

    return step


def make_batched_prefill(cfg, mesh: Mesh):
    """Batched right-padded prefill over the mesh.

    fn(params, x_emb (B, T, D), k_caches, v_caches (this rank's), n_valid
    (B,)) -> (logits (B, n_out_vocab) f32 of every lane, k_caches,
    v_caches)."""
    from bark_tpu_torch.parallel.tp import TensorParallelForward

    fwd = TensorParallelForward(mesh)

    def run(params, x_emb, k_caches, v_caches, n_valid):
        lo, hi = mesh.lanes(x_emb.shape[0])
        rows = []
        if hi > lo:
            logits = fwd.prefill(cfg, fwd.weights(cfg, params)[0],
                                 x_emb[lo:hi], k_caches, v_caches,
                                 [int(n) for n in n_valid[lo:hi]])
            rows = list(logits.cpu())
        return (torch.stack(mesh.gather_lanes(rows)).to(x_emb.device),
                k_caches, v_caches)

    return run
