"""K8: causal prefill of B lanes' contexts into their decode caches.

The counterpart of `bark_tpu.kernels.prefill.prefill_fused_batched`. On
CUDA tensors the wrapper launches the hand-written kernels of
`csrc/prefill.cu` (K2's, `bark_prefill_batched`) through one C call: the
lanes' live rows are stacked into one block of M = sum(n_valid) rows, so
each projection is one GEMM whose weights stream once for all lanes (in
bf16 K2's TMA + wgmma GEMM on K2's `gemm_plan` at that M), and host-built
row tables tell the embedding, the K/V write-back and the causal
attention which lane a row belongs to. On CPU tensors the plain
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
from bark_tpu_torch.kernels.prefill import (check_prefill, gemm_args,
                                            kv_rows, prefill_plain)
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig

QUERY_TILE = 16  # query rows per scalar attention block (csrc/prefill.cu QT)
TC_QUERY_TILE = 64  # ... per tensor-core attention block (TQ)

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
    tiles = query_tiles(n_valid, QUERY_TILE)
    tables = np.concatenate([lane * T + pos, pos, lane * S + pos,
                             tiles.reshape(-1), n, first + n - 1])
    return tables.astype(np.int32), M, len(tiles)


def query_tiles(n_valid, rows: int):
    """(n_tiles, 3) int64: the attention's query tiles of `rows` rows over
    lanes of n_valid[b] stacked live rows, each (lane, first query row,
    the lane's first stacked row); no tile straddles two lanes."""
    n = np.asarray(n_valid, np.int64)
    first = np.concatenate([[0], np.cumsum(n)[:-1]])
    return np.array([(b, r0, first[b]) for b in range(len(n))
                     for r0 in range(0, int(n[b]), rows)],
                    np.int64).reshape(-1, 3)


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
    B = x_emb.shape[0] if x_emb.dim() == 3 else 0
    if not 1 <= B <= MAX_LANES or len(n_valid) != B:
        raise ValueError(f"want 1 <= B <= {MAX_LANES} lanes and B n_valid, "
                         f"got x_emb {tuple(x_emb.shape)} and {n_valid}")
    lo, hi = check_prefill(cfg, params, x_emb, n_valid, lm_window, lanes=B)
    caches = _build.check_kv(cfg, params["wpe"].dtype, params["wpe"].device,
                             k_cache, v_cache, batch=B)
    w = _build.stage_weights(cfg, params)
    V, D, S = cfg.n_out_vocab, cfg.n_embd, cfg.block_size
    T = x_emb.shape[1]
    tables, M, n_tiles = row_tables(n_valid, T, S)
    tiles64 = query_tiles(n_valid, TC_QUERY_TILE)
    tables = _build.device_ints(
        np.concatenate([tables, tiles64.reshape(-1).astype(np.int32)]),
        w.device)
    maps, plan, part, tickets = gemm_args(w, M)
    logits = torch.empty((B, V), dtype=torch.float32, device=w.device)
    rc = _build.lib().bark_prefill_batched(
        w.ref, x_emb.data_ptr(), B, M, max(n_valid), n_tiles, len(tiles64),
        tables.data_ptr(), *caches,
        w.scratch("p_x", M, D).data_ptr(), w.scratch("p_hb", M, D).data_ptr(),
        w.scratch("p_q", M, D).data_ptr(), w.scratch("p_ctx", M, D).data_ptr(),
        w.scratch("p_ff", M, 4 * D).data_ptr(), kv_rows(w, caches, M),
        maps, plan, part, tickets, logits.data_ptr(), lo, hi,
        _build.stream_ptr(w.device),
    )
    _build.check("prefill_fused_batched", rc)
    launches += 1
    kv8.count(caches)
    return logits
