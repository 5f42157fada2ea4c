"""K8: causal prefill of B lanes' contexts into their decode caches.

The counterpart of `bark_tpu.kernels.prefill.prefill_fused_batched`. On
CUDA tensors the wrapper launches the hand-written kernels of
`csrc/prefill.cu` (K2's, `bark_prefill_batched`) through one C call: the
lanes' live rows are stacked into one block of M = sum(n_valid) rows, so
each projection is one GEMM whose weights stream once for all lanes, and
host-built row tables tell the embedding, the K/V write-back and the
causal attention which lane a row belongs to. On CPU tensors the plain
version runs: K2's plain version (`gpt.prefill`) per lane, on its (L, S, D)
cache view with its own n_valid.

Only each lane's n_valid live rows are computed and written; the logits
are those of each lane's row n_valid[b] - 1. Int8 caches run K2's int8
kernels (K6b, K6c: `kernels.kv8`), K6b writing each stacked row's K/V at
its lane's cache row.
"""

from __future__ import annotations

import numpy as np
import torch

from bark_tpu_torch.kernels import _build, kv8
from bark_tpu_torch.kernels.bdecode import MAX_LANES
from bark_tpu_torch.kernels.prefill import kv_rows, prefill_plain
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig

QUERY_TILE = 16  # query rows per attention block (csrc/prefill.cu QT)

launches = 0  # kernel launches through `prefill_fused_batched`


def prefill_batched_plain(cfg: GPTConfig, params, x_emb, k_cache, v_cache,
                          n_valid, lm_window=None):
    """The plain PyTorch version of K8: K2's plain version on each lane."""
    return torch.stack([
        prefill_plain(cfg, params, x_emb[b], gpt.kv_lane(k_cache, b),
                      gpt.kv_lane(v_cache, b), int(n), lm_window)
        for b, n in enumerate(n_valid)
    ])


def row_tables(n_valid, T: int, S: int):
    """(tables, M, n_tiles): the int32 tables of `bark_prefill_batched`
    for lanes of n_valid[b] live rows in a (B, T, D) x_emb and (B, S, D)
    cache slabs: src, pos and slot of each stacked row, the attention's
    (lane, first row, lane's first stacked row) query tiles, n_valid, and
    each lane's last stacked row."""
    n = np.asarray(n_valid, np.int64)
    B, M = len(n), int(n.sum())
    first = np.concatenate([[0], np.cumsum(n)[:-1]])
    lane = np.repeat(np.arange(B), n)
    pos = np.arange(M) - np.repeat(first, n)
    tiles = np.array([(b, r0, first[b]) for b in range(B)
                      for r0 in range(0, int(n[b]), QUERY_TILE)], np.int64)
    tables = np.concatenate([lane * T + pos, pos, lane * S + pos,
                             tiles.reshape(-1), n, first + n - 1])
    return tables.astype(np.int32), M, len(tiles)


def prefill_fused_batched(cfg: GPTConfig, params, x_emb, k_cache, v_cache,
                          n_valid, *, lm_window=None):
    """Prefill rows [0, n_valid[b]) of each lane's `x_emb[b]` ((B, T, D)
    token embeddings, positions not yet added) from n_past 0. Writes cache
    rows [0, n_valid[b]) of lane b of every layer of the (L, B, S, D)
    caches in place; returns the (B, n_out_vocab) f32 logits of each lane's
    row n_valid[b] - 1, zero outside lm_window. `n_valid` is B ints."""
    global launches
    n_valid = [int(n) for n in n_valid]
    if gpt.kv_device(k_cache).type == "cpu":
        return prefill_batched_plain(cfg, params, x_emb, k_cache, v_cache,
                                     n_valid, lm_window)
    w = _build.stage_weights(cfg, params)
    V, D, S = cfg.n_out_vocab, cfg.n_embd, cfg.block_size
    if (x_emb.dim() != 3 or x_emb.shape[2] != D or x_emb.dtype != w.dtype
            or x_emb.device != w.device or not x_emb.is_contiguous()):
        raise ValueError(
            f"x_emb: want contiguous (B, T, {D}) {w.dtype} on {w.device}, "
            f"got {tuple(x_emb.shape)} {x_emb.dtype} on {x_emb.device}"
        )
    B, T = x_emb.shape[:2]
    if not 1 <= B <= MAX_LANES or len(n_valid) != B:
        raise ValueError(f"want 1 <= B <= {MAX_LANES} lanes and B n_valid, "
                         f"got B {B} and {n_valid}")
    caches = w.check_cache(k_cache, v_cache, batch=B)
    if not all(1 <= n <= min(T, S) for n in n_valid):
        raise ValueError(f"n_valid {n_valid} outside [1, {min(T, S)}]")
    lo, hi = lm_window if lm_window is not None else (0, V)
    if not 0 <= lo <= hi <= V:
        raise ValueError(f"lm_window {lm_window} outside [0, {V}]")
    tables, M, n_tiles = row_tables(n_valid, T, S)
    tables = _build.device_ints(tables, w.device)
    logits = torch.empty((B, V), dtype=torch.float32, device=w.device)
    rc = _build.lib().bark_prefill_batched(
        w.ref, x_emb.data_ptr(), B, M, max(n_valid), n_tiles,
        tables.data_ptr(), *caches,
        w.scratch("p_x", M, D).data_ptr(), w.scratch("p_hb", M, D).data_ptr(),
        w.scratch("p_q", M, D).data_ptr(), w.scratch("p_ctx", M, D).data_ptr(),
        w.scratch("p_ff", M, 4 * D).data_ptr(), kv_rows(w, caches, M),
        logits.data_ptr(), lo, hi, _build.stream_ptr(w.device),
    )
    _build.check("prefill_fused_batched", rc)
    launches += 1
    kv8.count(caches)
    return logits
