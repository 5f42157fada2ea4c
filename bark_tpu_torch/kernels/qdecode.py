"""K5: the decode step (K1) on packed-quantized weights.

The counterpart of `bark_tpu.kernels.decode.decode_step_fused(quant=True)`
(`_tile_stream` dequant, `_qdot`, `_embed_token`). `decode.decode_step_fused`
comes here when its params are a qpack (`io.loader.gpt_qparams_from_section`)
on CUDA tensors: the hand-written kernels of `csrc/qdecode.cu` (packed
embed, L x [packed LN-GEMV QKV, K1's attention, packed GEMV proj +
residual, packed LN-GEMV fc + GELU, packed GEMV out + residual], packed
LM head over `lm_window`), through one C call. K3 and K4 reach it through
their K1 steps. On CPU tensors `decode.decode_step_plain` runs the plain
version, `models.gpt.decode_step` on the qpack (`gpt.qdot`,
`gpt.embed_rows`). A qpack the kernels do not take raises; nothing falls
back to dense.
"""

from __future__ import annotations

from bark_tpu_torch.kernels import _build

launches = 0  # kernel launches through `decode_step_packed`


def decode_step_packed(args, out):
    """Launch the packed step. `args` are those of `bark_qdecode_step`
    (csrc/qdecode.cu: the `GPTQWeights` struct, the token, n_past, the
    caches, its scratch and the logits' window), as
    `decode.decode_step_fused` builds and validates them for a qpack on
    CUDA tensors; returns `out`, the f32 logits they point to."""
    global launches
    _build.check("qdecode_step", _build.lib().bark_qdecode_step(*args))
    launches += 1
    return out
