"""K5: the decode step (K1) on packed-quantized weights.

The counterpart of `bark_tpu.kernels.decode.decode_step_fused(quant=True)`
(`_tile_stream` dequant, `_qdot`, `_embed_token`). `decode.decode_step_fused`
comes here when its params are a qpack (`io.loader.gpt_qparams_from_section`)
on CUDA tensors: ONE cooperative launch a step of K1's persistent kernel
(csrc/decode.cu `decode_step_kernel`) on its packed weight read, which
streams the quant-block records of `decode.step_qtiles` and dequantizes
them in shared memory (packed embed, L x [LN1+QKV | attention+proj |
LN2+fc | out], the packed LM head over `lm_window`). K3 and K4 on a
qpack launch its step loop (csrc/decode.cu `decode_steps_kernel` on the
packed read: a chunk or a window in one launch, `decode_steps_packed`). On CPU tensors `decode.decode_step_plain` runs the
plain version, `models.gpt.decode_step` on the qpack (`gpt.qdot`,
`gpt.embed_rows`). A qpack the kernel does not take raises before any
launch; nothing falls back to dense.
"""

from __future__ import annotations

from bark_tpu_torch.kernels import _build

launches = 0  # K5's step launched through `decode_step_packed`
loop_launches = 0  # its step loop (K3, K4) through `decode_steps_packed`


def decode_step_packed(args) -> None:
    """Launch the packed step. `args` are those of
    `bark_decode_step_packed` (csrc/decode.cu: the `GPTQWeights` struct,
    the records' pointers, the packed plan's table and grid, the token,
    n_past, the caches, the step's scratch, stamps and the logits), as
    `decode.decode_step_fused` builds and validates them for a qpack on
    CUDA tensors."""
    global launches
    _build.check("decode_step_packed",
                 _build.lib().bark_decode_step_packed(*args))
    launches += 1


def decode_steps_packed(args) -> None:
    """Launch the packed step loop of K3/K4: `args` are those of
    `bark_decode_steps_packed` (csrc/decode.cu), as
    `decode.decode_steps_fused` builds and validates them for a qpack."""
    global loop_launches
    _build.check("decode_steps_packed",
                 _build.lib().bark_decode_steps_packed(*args))
    loop_launches += 1
