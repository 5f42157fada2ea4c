"""The sampler of K9/K10, the batched chunk and window, for B lanes in one
launch: `sample_rows` of `csrc/sample.cu`.

One launch reduces a window of each lane's logits to its sampled token
(and, for K9, the stop flag) and writes them to device memory, where the
next batched decode step (K7) reads the token, so a chunk or window never
waits on the host. The single-lane chunk and window (K3, K4) no longer
launch it: each is one launch with the sampler inside
(`decode.decode_steps_fused`). The plain version of what it computes is
`ops.sampling.sample`, which the chunk and window loops run on CPU
tensors.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.kernels import _build

launches = 0  # kernel launches through `sample_window`


def _rows(t, dev, n: int, name: str):
    """(lanes, row stride) of a (n,) or (lanes, >= n) f32 tensor on `dev`
    whose rows are contiguous."""
    t2 = t.reshape(1, -1) if t.dim() == 1 else t
    if (t2.dim() != 2 or t.dtype != torch.float32 or t.device != dev
            or t2.shape[1] < n or t2.stride(1) != 1):
        raise ValueError(
            f"{name}: want float32 rows of >= {n} contiguous elements on "
            f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}"
        )
    return t2.shape[0], t2.stride(0)


def sample_window(logits, base: int, n: int, noise, temp: float, tok_out,
                  flag_out=None, stop_token: int = -1,
                  min_eos_p: float = 2.0):
    """Launch `sample_rows` (csrc/sample.cu) on CUDA tensors. `logits` is
    one (V,) row or (B, V) rows, `noise` a row or (B, >= n) rows (row b
    may be strided from row b-1, as a step's rows of (B, steps, V) noise
    are), `tok_out` and `flag_out` (B,) int32. For each lane: tok_out[b] =
    base + argmax(logits[b, base:base+n]/temp + noise[b]) (of the logits at
    temp 0, where `noise` may be None); when `flag_out` is given,
    flag_out[b] = tok == stop_token or the EOS mass (softmax of the window
    over temp, or over 0.7 at temp 0, at its last slot) >= min_eos_p."""
    global launches
    dev = logits.device
    if dev.type != "cuda":
        raise ValueError(f"sample_window launches on CUDA tensors, got {dev}")
    B, ld_logits = _rows(logits, dev, base + n, "logits")
    ld_noise = 0
    if temp != 0.0:
        nb, ld_noise = _rows(noise, dev, n, "noise")
        if nb != B:
            raise ValueError(f"noise: {nb} rows for {B} lanes")
    for t in (tok_out, flag_out):
        if t is not None and (t.dtype != torch.int32 or t.device != dev
                              or t.numel() != B or not t.is_contiguous()):
            raise ValueError(f"tok_out/flag_out: want {B} contiguous int32 "
                             f"on {dev}")
    rc = _build.lib().bark_sample_rows(
        logits.data_ptr(), ld_logits, base, n,
        noise.data_ptr() if temp != 0.0 else None, ld_noise, temp,
        int(flag_out is not None), stop_token, min_eos_p, B,
        tok_out.data_ptr(),
        flag_out.data_ptr() if flag_out is not None else None,
        _build.stream_ptr(dev),
    )
    _build.check("sample_window", rc)
    launches += 1
