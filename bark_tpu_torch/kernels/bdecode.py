"""K7: one token through every layer of a GPT stage for B lanes at once.

The counterpart of `bark_tpu.kernels.decode.decode_step_fused_batched`. On
CUDA tensors the wrapper launches the hand-written kernel of
`csrc/bdecode.cu`: ONE cooperative launch a step of a persistent kernel
(the card's co-resident block count, 512 threads, the layer loop inside)
for any B in 1..32, every lane decoding at its own slot `n_past[b]` (read
on the card) and writing its K/V row at `[l, b, n_past[b]]` of the flat
(L, B, S, D) caches. Its five products a layer (qkv, proj, fc, out, and
the LM head after the last) run with the lanes as the N side of the
tensor cores' mma.sync in bf16 (CUDA-core FMAs in f32), each weight read
once for every lane from the tile-major copy `decode.lane_tiles`, split
over the blocks by `decode.lane_plan` (kept with the stage's weights,
per B and window); each tile's partials are folded once, by the last
block to write one; the attention runs as (head, lane) units split by
each lane's live rows. On an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md,
`probes/bdecode_profile.py`): 0.505-0.509 / 0.524-0.535 / 0.955-0.968 ms
a bf16 step at n_past 300 for B 1 / 8 / 32 lanes, against 0.559-0.561 /
0.820 / 2.094-2.098 for the 62-launch chain it replaces; bound not by
bytes (11-17% of their bound) but by the latency of each phase's chain
of dependent steps (csrc/bdecode.cu). Packed-quantized params (a qpack) run the same kernel on its
packed read, counted by `kernels.qbdecode` (K5-batched). On CPU tensors
the plain version runs, for dense params and qpacks alike:
`gpt.decode_step` on each lane's (L, S, D) view at its own slot, which is
what the JAX package's off-TPU `vmap` computes. A CUDA tensor the kernel
does not take raises a ValueError before any launch (head_dim != 64,
n_embd % 64, more than 1024 cache slots, more than MAX_LANES lanes or 512
(head, lane) units; for a qpack also scales other than f16/f32, tensors
not 16-byte aligned, more than one LM head), and a launch the card
refuses raises with the CUDA error; there is no other path. Int8 caches
(`gpt.init_kv_cache(quant=True, batch=B)`) run K6a's arithmetic inside
the same launch (`kernels.kv8`).

K9 and K10 (`kernels.bsemantic`, `kernels.bwindow`) run the same step in
a loop: `decode_lane_steps` is ONE cooperative launch of a chunk or window
(csrc/bloop.cuh `lane_steps_kernel`, on the same lane plan and tiled
weights), step j sampling every lane's token inside the launch
(`decode.LoopSample`) from the lane's logits before it, each LM tile's
folding warps writing the tile's partial for every lane, then decoding the
tokens at row j of a slot table. Its launches count in `loop_launches` (a
qpack's in `qbdecode.loop_launches`), not in `launches`.
"""

from __future__ import annotations

import torch

import ctypes

from bark_tpu_torch.kernels import _build, kv8, qbdecode
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.kernels.decode import MAX_LANES, decode_step_plain
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig

# dense launches of K7's step through `decode_step_fused_batched`, and of
# the batched step loop (K9, K10) through `decode_lane_steps` (a qpack's
# counts are `qbdecode`'s)
launches = 0
loop_launches = 0


def _host_ints(v):
    return v.tolist() if torch.is_tensor(v) else [int(x) for x in v]


def decode_step_batched_plain(cfg: GPTConfig, params, tokens, k_cache,
                              v_cache, n_past, lm_window=None):
    """The plain PyTorch version of K7, and of K5-batched for a qpack:
    `decode_step_plain` (K1's and K5's) on each lane's (L, S, D) cache view
    at its own slot; (B, n_out_vocab) f32."""
    return torch.stack([
        decode_step_plain(cfg, params, t, gpt.kv_lane(k_cache, b),
                          gpt.kv_lane(v_cache, b), n, lm_window)
        for b, (t, n) in enumerate(zip(_host_ints(tokens),
                                       _host_ints(n_past)))
    ])


def lane_ints(v, B: int, device, name: str, hi: int):
    """A (B,) int32 tensor on `device` for a kernel to read: a tensor there
    is taken as it is (its values are not checked on the host: the kernels
    turn an out-of-range token or slot into NaN, never into a stray
    write); B Python ints are checked against [0, hi) and uploaded."""
    if torch.is_tensor(v) and v.device == device:
        if v.numel() != B:
            raise ValueError(f"{name}: want {B} values, got {v.numel()}")
        return v.reshape(B).to(torch.int32).contiguous()
    vals = _host_ints(v)
    if len(vals) != B or not all(0 <= x < hi for x in vals):
        raise ValueError(f"{name}: want {B} values in [0, {hi}), got {vals}")
    return _build.device_ints(vals, device)


def check_lanes(cfg: GPTConfig, params, B: int, lm_window=None):
    """Raise ValueError for what the batched step's kernel does not take
    (`decode.check_step`'s shapes and qpack forms, B lanes outside
    [1, MAX_LANES], more than 512 (head, lane) units, lm_window outside
    the vocab)."""
    D = cfg.n_embd
    if D % kdec.PLAN_TILE or D != cfg.n_head * kdec.HEAD_DIM:
        raise ValueError(f"the decode kernels take width % "
                         f"{kdec.PLAN_TILE} == 0 and head dim "
                         f"{kdec.HEAD_DIM}, got n_embd {D}, n_head "
                         f"{cfg.n_head}")
    if cfg.block_size > 1024:
        raise ValueError(f"the decode kernels take <= 1024 cache slots, got "
                         f"{cfg.block_size}")
    if not 1 <= B <= MAX_LANES or cfg.n_head * B > kdec.MAX_UNITS:
        raise ValueError(f"the batched step takes 1 to {MAX_LANES} lanes "
                         f"and at most {kdec.MAX_UNITS} (head, lane) units, "
                         f"got {B} lanes of {cfg.n_head} heads")
    V = cfg.n_out_vocab
    lo, hi = lm_window if lm_window is not None else (0, V)
    if not 0 <= lo <= hi <= V:
        raise ValueError(f"lm_window {lm_window} outside [0, {V}]")
    if gpt.is_qpack(params):
        _build.check_qpack_form(cfg, params)


def decode_step_fused_batched(cfg: GPTConfig, params, tokens, k_cache,
                              v_cache, n_past, *, lm_window=None, out=None,
                              stamps=None):
    """One decode step of B lanes. `tokens` and `n_past` are (B,) int
    tensors on the caches' device (read there by the kernel) or B ints;
    lane b decodes tokens[b] at slot n_past[b] and writes K/V row
    n_past[b] of lane b of every layer of the (L, B, S, D) caches in
    place. Returns the (B, n_out_vocab) f32 logits (into `out` when
    given), zero outside lm_window. `stamps`: an int64 CUDA tensor
    (`decode.step_stamps` of the step's `decode.device_lane_plan`) that
    the kernel fills with every block's ns clock, or None."""
    global launches
    if gpt.kv_device(k_cache).type == "cpu":
        return decode_step_batched_plain(cfg, params, tokens, k_cache,
                                         v_cache, n_past, lm_window)
    B = lane_count(k_cache)
    check_lanes(cfg, params, B, lm_window)
    dev = params["wpe"].device
    caches = _build.check_kv(cfg, params["wpe"].dtype, dev, k_cache,
                             v_cache, batch=B)
    tok = lane_ints(tokens, B, dev, "tokens", cfg.n_in_vocab)
    npt = lane_ints(n_past, B, dev, "n_past", cfg.block_size)
    packed = gpt.is_qpack(params)
    w = (_build.stage_qweights if packed else _build.stage_weights)(
        cfg, params)
    V = cfg.n_out_vocab
    lo, hi = lm_window if lm_window is not None else (0, V)
    if out is None:
        out = torch.empty((B, V), dtype=torch.float32, device=w.device)
    if tuple(out.shape) != (B, V):
        raise ValueError(f"out: want ({B}, {V}), got {tuple(out.shape)}")
    _build.f32_on(out, w.device, B * V, "logits")
    if not packed and params["lm_head"].data_ptr() % 16:
        raise ValueError("lm_head: the step's bulk copies want it 16-byte "
                         "aligned")
    plan, table = kdec.device_lane_plan(w, B, (lo, hi))
    want = plan.n_blocks * (2 * len(plan.phase_names) * plan.n_layer + 3)
    if stamps is not None and (
            stamps.dtype != torch.int64 or stamps.device != w.device
            or not stamps.is_contiguous() or stamps.numel() < want):
        raise ValueError(f"stamps: want a contiguous int64 tensor of >= "
                         f"{want} on {w.device} (`decode.step_stamps`)")
    tiles = kdec.lane_tiles(w, params)
    work = w.scratch("lane_work", kdec.lane_work_floats(cfg, plan),
                     dtype=torch.float32)
    args = (w.ref, ctypes.addressof(tiles), table.data_ptr(),
            plan.n_blocks, B, tok.data_ptr(), npt.data_ptr(), *caches,
            work.data_ptr(), work.numel(), plan.partial_floats,
            w.scratch("lane_sync", 1 + plan.n_tickets,
                      dtype=torch.int32).data_ptr(),
            None if stamps is None else stamps.data_ptr(), out.data_ptr(),
            _build.stream_ptr(w.device))
    if packed:
        qbdecode.decode_step_packed_batched(args)
    else:
        _build.check("decode_step_fused_batched",
                     _build.lib().bark_decode_lanes(*args))
        launches += 1
    kv8.count(caches)
    return out


def decode_lane_steps(cfg: GPTConfig, params, logits, k_cache, v_cache,
                      slots, sample: kdec.LoopSample, noise, tok_out,
                      flag_out=None, *, noise_lane_dim: int = 0,
                      lm_window=None, stamps=None):
    """K9/K10's batched step loop on CUDA tensors: ONE cooperative launch
    of len(slots) steps of B lanes (csrc/bloop.cuh `lane_steps_kernel`,
    dense or on a qpack's packed read), step j sampling every lane's token
    as `sample` says from the lane's logits before it (`logits`, (B,
    n_out_vocab) f32, holds the input logits and is left holding the last
    step's), writing it to tok_out[j, b] (and for the full window its stop
    flag to flag_out[j, b]), then decoding the tokens, lane b at slot
    slots[j][b] (host ints in [0, block_size), uploaded as one table),
    with the LM head over lm_window. `noise` (None at temp 0): f32 rows of
    the window's width with unit column stride, lane b's row of step j at
    index b of dim `noise_lane_dim` and row `sample.noise_row(j)` of the
    other leading dim (K9: (B, rows, V), dim 0; K10: (rows, B, cbs), dim
    1). `stamps`: an int64 tensor (`decode.loop_stamps` of the lane plan),
    or None. Raises ValueError before any launch for what the kernel does
    not take; nothing falls back."""
    global loop_launches
    B, n_steps = lane_count(k_cache), len(slots)
    check_lanes(cfg, params, B, lm_window)
    kdec.check_loop(cfg, sample, n_steps, lm_window)
    dev = params["wpe"].device
    caches = _build.check_kv(cfg, params["wpe"].dtype, dev, k_cache,
                             v_cache, batch=B)
    S, V = cfg.block_size, cfg.n_out_vocab
    if any(len(r) != B or not all(0 <= int(x) < S for x in r)
           for r in slots):
        raise ValueError(f"slots: want {n_steps} rows of {B} slots in "
                         f"[0, {S})")
    if tuple(logits.shape) != (B, V):
        raise ValueError(f"logits: want ({B}, {V}), got "
                         f"{tuple(logits.shape)}")
    _build.f32_on(logits, dev, B * V, "logits")
    kdec._loop_tensor(tok_out, dev, torch.int32, n_steps * B, "tok_out")
    if sample.codebook is None:
        kdec._loop_tensor(flag_out, dev, torch.int32, n_steps * B,
                          "flag_out")
    width = sample.window(0, V)[1]
    hot = sample.temp != 0.0
    if hot and (noise is None or noise.dim() != 3
                or noise.dtype != torch.float32 or noise.device != dev
                or noise.shape[noise_lane_dim] != B
                or noise.shape[1 - noise_lane_dim] < 1
                or noise.shape[2] < width or noise.stride(2) != 1):
        raise ValueError(
            f"noise: want float32 rows of >= {width} on {dev} with unit "
            f"column stride, {B} lanes in dim {noise_lane_dim}, got "
            f"{None if noise is None else tuple(noise.shape)}")
    packed = gpt.is_qpack(params)
    w = (_build.stage_qweights if packed else _build.stage_weights)(
        cfg, params)
    if not packed and params["lm_head"].data_ptr() % 16:
        raise ValueError("lm_head: the step's bulk copies want it 16-byte "
                         "aligned")
    plan, table = kdec.device_lane_plan(w, B, lm_window)
    if stamps is not None:
        kdec._loop_tensor(stamps, dev, torch.int64,
                          plan.n_blocks * (2 + 3 * n_steps), "stamps")
    tiles = kdec.lane_tiles(w, params)
    work = w.scratch("lane_work", kdec.lane_work_floats(cfg, plan),
                     dtype=torch.float32)
    table_slots = _build.device_ints([[int(x) for x in r] for r in slots],
                                     dev)
    n_tiles = len(plan.folds[kdec.LANE_PHASES.index("lm")])
    svs, cbs, step0 = sample.codebook or (0, 0, 0)
    loop = _build.LaneLoop(
        n_steps=n_steps, slots=table_slots.data_ptr(), temp=sample.temp,
        noise=noise.data_ptr() if hot else None,
        noise_lane_ld=noise.stride(noise_lane_dim) if hot else 0,
        noise_step_ld=noise.stride(1 - noise_lane_dim) if hot else 0,
        noise_row0=sample.noise_row0,
        noise_rows=noise.shape[1 - noise_lane_dim] if hot else 1,
        codebook=int(sample.codebook is not None), svs=svs, cbs=cbs,
        step_idx0=step0, stop_token=sample.stop_token,
        min_eos_p=sample.min_eos_p, tok_out=tok_out.data_ptr(),
        flag_out=None if flag_out is None else flag_out.data_ptr(),
        part=w.scratch("lane_loop_part", 4 * n_tiles * B,
                       dtype=torch.float32).data_ptr(),
        stamps=None if stamps is None else stamps.data_ptr())
    args = (w.ref, ctypes.addressof(tiles), table.data_ptr(),
            plan.n_blocks, B, ctypes.addressof(loop), *caches,
            work.data_ptr(), work.numel(), plan.partial_floats,
            w.scratch("lane_sync", 1 + plan.n_tickets,
                      dtype=torch.int32).data_ptr(),
            logits.data_ptr(), _build.stream_ptr(w.device))
    if packed:
        qbdecode.decode_lane_steps_packed(args)
    else:
        _build.check("decode_lane_steps",
                     _build.lib().bark_decode_lane_steps(*args))
        loop_launches += 1
    kv8.count(caches)
    return logits


def lane_count(k_cache) -> int:
    """B of (L, B, S, D) batched caches (dense or int8); raise unless
    1 <= B <= MAX_LANES."""
    t = k_cache["q"] if isinstance(k_cache, dict) else k_cache
    B = t.shape[1] if t.dim() == 4 else 0
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"batched caches: want (L, B, S, D) with 1 <= B <= "
                         f"{MAX_LANES}, got {tuple(t.shape)}")
    return B
