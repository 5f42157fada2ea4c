"""K5-batched: the batched decode step (K7) on packed-quantized weights.

The counterpart of `bark_tpu.kernels.decode.decode_step_fused_batched(
quant=True)` (`_tile_stream` dequant, `_qdot`, `_embed_token`, vmapped
over lanes). `bdecode.decode_step_fused_batched` comes here when its
params are a qpack (`io.loader.gpt_qparams_from_section`) on CUDA
tensors: the hand-written kernels of `csrc/qbdecode.cu` (per-lane packed
embed, L x [packed LN-GEMV QKV, K7's attention, packed GEMV proj +
residual, packed LN-GEMV fc + GELU, packed GEMV out + residual], packed
LM head over `lm_window`), through one C call; each packed weight is read
once per step for every lane. K9 and K10 reach it through their K7 steps.
On CPU tensors `bdecode.decode_step_batched_plain` runs the plain version,
`models.gpt.decode_step` on the qpack for each lane. A qpack the kernels
do not take raises; nothing falls back to dense.
"""

from __future__ import annotations

from bark_tpu_torch.kernels import _build

launches = 0  # kernel launches through `decode_step_packed_batched`


def decode_step_packed_batched(args, out):
    """Launch the packed batched step. `args` are those of
    `bark_decode_step_batched` (csrc/bdecode.cu) with the `GPTQWeights`
    struct in place of the dense one, as `bdecode.decode_step_fused_batched`
    builds and validates them for a qpack on CUDA tensors; returns `out`,
    the f32 logits they point to."""
    global launches
    _build.check("qdecode_step_batched",
                 _build.lib().bark_qdecode_step_batched(*args))
    launches += 1
    return out
