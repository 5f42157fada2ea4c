"""K2: causal prefill of a stage's context into its decode caches.

The counterpart of `bark_tpu.kernels.prefill.prefill_fused`. On a CUDA
tensor the wrapper launches the hand-written kernels of `csrc/prefill.cu`
(row LayerNorms, tiled GEMMs with the bias/GELU/residual/K-V-write
epilogues, causal attention, and K1's LM head on the last live row); on a
CPU tensor it runs the plain version, the reference `models.gpt.prefill`.

Only the `n_valid` live rows are computed and written: cache rows past
n_valid keep whatever they held, which the decode contract allows (a row
is admitted by the mask only after a decode step wrote it).

Int8 caches (`gpt.init_kv_cache(quant=True)`): the QKV epilogue writes the
K/V rows in the params dtype to scratch, K6b quantizes each into its cache
row, and K6c is the attention (`kernels.kv8`).
"""

from __future__ import annotations

import torch

from bark_tpu_torch.kernels import _build, kv8
from bark_tpu_torch.kernels.decode import window_logits
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig

launches = 0  # kernel launches through `prefill_fused`


def prefill_plain(cfg: GPTConfig, params, x_emb, k_cache, v_cache,
                  n_valid: int, lm_window=None):
    """The plain PyTorch version: `gpt.prefill` over the live rows
    (the causal mask makes later rows invisible to them)."""
    logits = gpt.prefill(cfg, params, x_emb[:n_valid], k_cache, v_cache,
                         n_valid)
    return window_logits(logits, lm_window)


def prefill_fused(cfg: GPTConfig, params, x_emb, k_cache, v_cache,
                  n_valid: int, *, lm_window=None):
    """Prefill rows [0, n_valid) of `x_emb` ((T, D) token embeddings,
    positions not yet added) from n_past 0. Writes cache rows [0, n_valid)
    of every layer in place; returns the (n_out_vocab,) f32 logits of row
    n_valid-1, zero outside lm_window."""
    global launches
    if gpt.kv_device(k_cache).type == "cpu":
        return prefill_plain(cfg, params, x_emb, k_cache, v_cache, n_valid,
                             lm_window)
    w = _build.stage_weights(cfg, params)
    caches = w.check_cache(k_cache, v_cache)
    V, D, S = cfg.n_out_vocab, cfg.n_embd, cfg.block_size
    if (x_emb.dim() != 2 or x_emb.shape[1] != D or x_emb.dtype != w.dtype
            or x_emb.device != w.device or not x_emb.is_contiguous()):
        raise ValueError(
            f"x_emb: want contiguous (T, {D}) {w.dtype} on {w.device}, got "
            f"{tuple(x_emb.shape)} {x_emb.dtype} on {x_emb.device}"
        )
    if not 1 <= n_valid <= min(x_emb.shape[0], S):
        raise ValueError(
            f"n_valid {n_valid} outside [1, {min(x_emb.shape[0], S)}]"
        )
    lo, hi = lm_window if lm_window is not None else (0, V)
    if not 0 <= lo <= hi <= V:
        raise ValueError(f"lm_window {lm_window} outside [0, {V}]")
    logits = torch.empty((V,), dtype=torch.float32, device=w.device)
    rc = _build.lib().bark_prefill(
        w.ref, x_emb.data_ptr(), n_valid, *caches,
        w.scratch("p_x", S, D).data_ptr(),
        w.scratch("p_hb", S, D).data_ptr(), w.scratch("p_q", S, D).data_ptr(),
        w.scratch("p_ctx", S, D).data_ptr(),
        w.scratch("p_ff", S, 4 * D).data_ptr(), kv_rows(w, caches, S),
        logits.data_ptr(), lo, hi, _build.stream_ptr(w.device),
    )
    _build.check("prefill_fused", rc)
    launches += 1
    kv8.count(caches)
    return logits


def kv_rows(w, caches, M: int):
    """The (2, M, D) params-dtype scratch the QKV epilogue writes the K/V
    rows to before K6b quantizes them, for int8 caches; None (no scratch)
    for dense ones."""
    if caches[2] is None:
        return None
    return w.scratch("p_kv", 2, M, w.cfg.n_embd).data_ptr()
