"""K5-batched: the batched decode step (K7) on packed-quantized weights.

The counterpart of `bark_tpu.kernels.decode.decode_step_fused_batched(
quant=True)` (`_tile_stream` dequant, `_qdot`, `_embed_token`, vmapped
over lanes). `bdecode.decode_step_fused_batched` comes here when its
params are a qpack (`io.loader.gpt_qparams_from_section`) on CUDA
tensors: ONE cooperative launch a step of K7's persistent kernel
(csrc/bdecode.cu `lane_step_kernel`) on its packed weight read, which
streams the quant-block records of `decode.lane_tiles` (in bf16, each
thread's values of an m16 tile in mma's fragment order), rounds each
weight to the params dtype from q * s once and feeds every lane's product
from it on the tensor cores (CUDA-core FMAs in f32), the min term of
q4_1/q4_k per lane on the CUDA cores (packed embed, L x [LN1+QKV |
attention | proj | LN2+fc | out], the packed LM head over `lm_window`).
K9 and K10 run the same step on a qpack in a loop, one launch a chunk or
window (`decode_lane_steps_packed`, csrc/bloop.cu). On an NVIDIA H100
80GB HBM3 at 700.00 W (PERF.md): q4_0 at n_past 300 0.484 / 0.491-0.498 /
0.909-0.914 ms at B 1 / 8 / 32, against 0.518-0.529 / 0.716-0.717 /
1.921-1.922 for the 62-launch chain; the latency of the step's dependent
phases bounds it, not its bytes (csrc/bdecode.cu). On CPU tensors
`bdecode.decode_step_batched_plain` runs the plain version,
`models.gpt.decode_step` on the qpack for each lane. A qpack the kernel
does not take raises before any launch; nothing falls back to dense.
"""

from __future__ import annotations

from bark_tpu_torch.kernels import _build

# launches of K5-batched's step through `decode_step_packed_batched`, and
# of the batched step loop on the packed read (K9, K10 on a qpack) through
# `decode_lane_steps_packed`
launches = 0
loop_launches = 0


def decode_step_packed_batched(args) -> None:
    """Launch the packed batched step. `args` are those of
    `bark_decode_lanes_packed` (csrc/bdecode.cu: the `GPTQWeights` struct,
    the records' pointers, the packed lane plan's table and grid, B, the
    tokens and slots, the caches, the step's work and sync scratch, stamps
    and the logits), as `bdecode.decode_step_fused_batched` builds and
    validates them for a qpack on CUDA tensors."""
    global launches
    _build.check("decode_step_packed_batched",
                 _build.lib().bark_decode_lanes_packed(*args))
    launches += 1


def decode_lane_steps_packed(args) -> None:
    """Launch the batched step loop on the packed read. `args` are those of
    `bark_decode_lane_steps_packed` (csrc/bloop.cu), as
    `bdecode.decode_lane_steps` builds and validates them for a qpack on
    CUDA tensors."""
    global loop_launches
    _build.check("decode_lane_steps_packed",
                 _build.lib().bark_decode_lane_steps_packed(*args))
    loop_launches += 1
