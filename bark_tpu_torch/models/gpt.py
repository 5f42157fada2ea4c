"""Bark's GPT-2-style stages as plain PyTorch functions.

The counterpart of `bark_tpu.models.gpt`, with its tensor layouts at every
public function (params dicts with the same keys, flat `(L, S, D)` KV
caches) and its numerics:

- LayerNorm in f32 with eps 1e-5 inside the rsqrt, cast back to the
  params dtype;
- every projection accumulates in f32, is cast to the params dtype, and
  only then gets its bias (`_dot(...).to(dtype) + b`);
- attention scores and softmax in f32, with a -1e9 mask (not -inf), and
  the attention weights cast to the V dtype before the context product;
- tanh-GELU; a residual stream in the params dtype; f32 logits.

Every function that runs the causal stages (`decode_step`,
`transformer` and what they call) also takes a qpack, the packed-quantized
params of `io.loader.gpt_qparams_from_section`, and then computes what the
JAX package's packed decode kernel computes (`_qdot`, `_embed_token` of
`bark_tpu.kernels.decode`): see `qdot` and `embed_rows`. Prefill and the
fine stage run on a dense copy (`io.loader.dense_from_qpack`).

Every function that takes KV caches also takes the int8 cache of
`init_kv_cache(quant=True)`, the JAX package's `{"q", "s"}` layout: fresh
K/V rows are quantized per row (`quantize_kv_rows`), the scores are the
exact integer dot of a per-(position, head) int8 query with the int8 keys,
scaled by both scales, and V is dequantized to the params dtype
(`_attention_int8`), as the JAX package's XLA path computes them.

This module is the plain reference every hand-written kernel of
`bark_tpu_torch.kernels` is compared with. KV caches are updated in place
(the JAX version returns new arrays): callers hand the same cache tensors
to every step, which is what the kernels do too.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bark_tpu_torch.models.config import EPS_NORM, GPTConfig

# Params dict layout (all tensors in the params dtype):
#   wte:     (n_wtes, n_in_vocab, n_embd)
#   wpe:     (block_size, n_embd)
#   lm_head: (n_lm_heads, n_out_vocab, n_embd)
#   ln_f_g, ln_f_b: (n_embd,)
#   blocks:
#     ln1_g, ln1_b, ln2_g, ln2_b: (L, D)
#     qkv_w: (L, D, 3D)   qkv_b: (L, 3D)
#     proj_w: (L, D, D)   proj_b: (L, D)
#     fc_w: (L, D, 4D)    fc_b: (L, 4D)
#     out_w: (L, 4D, D)   out_b: (L, D)
Params = Dict[str, object]


def init_kv_cache(cfg: GPTConfig, dtype, device, batch=None,
                  quant: bool = False):
    """(k, v) caches shaped (L, block_size, n_embd), or (L, batch,
    block_size, n_embd) for `batch` lanes (the flat layout of the JAX
    package's batched caches; lane b's (L, S, D) view is
    `kv_lane(cache, b)`), zero-filled.

    quant=True: each of k and v is the int8 cache {"q": int8 of that
    shape, "s": f32 row scales (L, [batch,] block_size)}, dequantized as
    q * s[..., None] (`dtype` is then unused)."""
    shape = (cfg.n_layer, cfg.block_size, cfg.n_embd)
    if batch is not None:
        shape = (cfg.n_layer, batch, *shape[1:])

    def one():
        if quant:
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=device)}
        return torch.zeros(shape, dtype=dtype, device=device)

    return one(), one()


def kv_view(cache, idx):
    """cache[idx] of a dense cache, or of both tensors of an int8 one (a
    view: writes through it land in `cache`)."""
    if isinstance(cache, dict):
        return {k: v[idx] for k, v in cache.items()}
    return cache[idx]


def kv_lane(cache, b: int):
    """Lane b's (L, S, D) view of (L, B, S, D) caches, dense or int8."""
    return kv_view(cache, (slice(None), b))


def kv_device(cache) -> torch.device:
    return (cache["q"] if isinstance(cache, dict) else cache).device


def quantize_kv_rows(x, amax=None):
    """Per-row symmetric int8 quantization of (..., D) rows -> (int8 of the
    same shape, f32 scales (...)), with dequant = q * s[..., None]: s =
    amax|x| / 127, q = clip(round_half_even(x / s), -127, 127), a zero row
    has scale 0. The divisions are true divisions by tensors (PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal).
    `amax`: the rows' amax when x holds only part of each row (a
    tensor-parallel rank's heads), else None."""
    x32 = x.float()
    if amax is None:
        amax = x32.abs().amax(dim=-1)
    s = amax / torch.full_like(amax, 127.0)
    one = torch.ones_like(s)
    inv = torch.where(s > 0, one / torch.where(s == 0, one, s),
                      torch.zeros_like(s))
    q = torch.clamp(torch.round(x32 * inv[..., None]), -127, 127)
    return q.to(torch.int8), s


def _kv_update(cache, rows, n_past: int):
    """Write (T, D) rows at row n_past of a layer's (S, D) cache, quantized
    when the cache is int8."""
    T = rows.shape[0]
    if isinstance(cache, dict):
        q, s = quantize_kv_rows(rows)
        cache["q"][n_past:n_past + T] = q
        cache["s"][n_past:n_past + T] = s
    else:
        cache[n_past:n_past + T] = rows


def _kv_read(cache, dtype):
    """A layer's whole (S, D) cache in `dtype`, dequantized in f32 first
    when it is int8."""
    if isinstance(cache, dict):
        return (cache["q"].float() * cache["s"][:, None]).to(dtype)
    return cache


def _dot(a, b):
    """a @ b with f32 accumulation of the exact products (the JAX
    package's `preferred_element_type=f32`); returns f32."""
    return torch.matmul(a.float(), b.float())


def is_qpack(params) -> bool:
    """True for packed-quantized params (int8 values + block scales)."""
    return "wte_q" in params


def _blocksums(x):
    """(..., K) -> (..., K/32) f32: the sum of each 32-value block."""
    x32 = x.float()
    return x32.reshape(*x32.shape[:-1], -1, 32).sum(dim=-1)


def qdot(x, q, s, m=None):
    """x @ W for a packed (K, N) weight, as the packed kernel computes it:
    the weight is (q * s) with each scale repeated over its 32 rows, in
    f32, rounded to x's dtype; the product accumulates in f32; where the
    format has mins, the exact min term blocksums(x) @ m is added in f32
    after the product (in bf16 this is not the same number as a dense
    (q*s + m) weight rounded once). Returns f32."""
    w = q.float() * torch.repeat_interleave(s.float(), 32, dim=-2)
    out = _dot(x, w.to(x.dtype))
    if m is not None:
        out = out + torch.matmul(_blocksums(x), m.float())
    return out


def _proj(x, layer, key: str):
    """x @ the layer's `key` projection (dense or packed), f32."""
    if key + "_w" in layer:
        return _dot(x, layer[key + "_w"])
    return qdot(x, layer[key + "_q"], layer[key + "_s"], layer.get(key + "_m"))


def embed_rows(params: Params, tokens, table: int = 0):
    """Rows `tokens` of wte table `table` in the params dtype. A packed row
    is (q * s [+ m]) in f32, then cast: bit-equal to the densified table."""
    if not is_qpack(params):
        return params["wte"][table][tokens]
    row = params["wte_q"][table][tokens].float() * torch.repeat_interleave(
        params["wte_s"][table][tokens].float(), 32, dim=-1)
    if "wte_m" in params:
        row = row + torch.repeat_interleave(
            params["wte_m"][table][tokens].float(), 32, dim=-1)
    return row.to(params["wpe"].dtype)


def layer_norm(x, g, b):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + EPS_NORM)
    return (y * g.float() + b.float()).to(x.dtype)


def gelu(x):
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def _attention(q, k_all, v_all, mask, cfg: GPTConfig):
    """q: ([B,] T, D); k_all/v_all: ([B,] S, D); mask: (T, S) bool ->
    ([B,] T, D). A leading lane dimension B runs every lane's attention
    as one einsum (the fine stage's lanes)."""
    H, hd = cfg.n_head, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(*q.shape[:-1], H, hd).float()
    kh = k_all.reshape(*k_all.shape[:-1], H, hd).float()
    vh = v_all.reshape(*v_all.shape[:-1], H, hd)
    scores = torch.einsum("...thd,...shd->...hts", qh, kh) * scale
    scores = scores.masked_fill(~mask, -1e9)
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum("...hts,...shd->...thd", att.to(vh.dtype).float(),
                       vh.float())
    return out.to(q.dtype).reshape(*out.shape[:-2], cfg.n_embd)


def _attention_int8(cfg: GPTConfig, q, k_cache, v_cache, mask):
    """Attention over an int8 layer cache ({"q": (S, D), "s": (S,)}), as
    `bark_tpu.models.gpt._attention_int8`: q * (1/sqrt(hd)) is quantized
    per (position, head) over hd; the score is the integer dot of the two
    int8 vectors (exact in f32: |dot| <= 127^2 * hd < 2^24 for hd <= 1024),
    then (score * s_q) * s_k; the -1e9 mask and the f32 softmax; weights
    cast to the params dtype against V dequantized to it."""
    H, hd = cfg.n_head, cfg.head_dim
    T = q.shape[0]
    qs = (q.float() * (1.0 / math.sqrt(hd))).reshape(T * H, hd)
    q_i8, s_q = quantize_kv_rows(qs)
    scores = torch.einsum("thd,shd->hts", q_i8.reshape(T, H, hd).float(),
                          k_cache["q"].reshape(-1, H, hd).float())
    scores = scores * s_q.reshape(T, H).T[:, :, None] * k_cache["s"][None,
                                                                     None, :]
    scores = scores.masked_fill(~mask[None, :, :], -1e9)
    att = torch.softmax(scores, dim=-1)
    vh = _kv_read(v_cache, q.dtype).reshape(-1, H, hd)
    out = torch.einsum("hts,shd->thd", att.to(vh.dtype).float(), vh.float())
    return out.to(q.dtype).reshape(T, cfg.n_embd)


def _layer(params: Params, l: int):
    return {k: v[l] for k, v in params["blocks"].items()}


def _block(cfg: GPTConfig, x, layer, k_cache, v_cache, n_past, mask):
    """One pre-LN block. x: (T, D), or (B, T, D) for B lanes of the
    cache-free fine stage; k_cache/v_cache: (S, D) views (or int8 layer
    caches) written in place at rows [n_past, n_past+T), or None for the
    fine stage."""
    D = cfg.n_embd
    dt = x.dtype
    h = layer_norm(x, layer["ln1_g"], layer["ln1_b"])
    qkv = _proj(h, layer, "qkv").to(dt) + layer["qkv_b"]
    q, k, v = qkv[..., :D], qkv[..., D : 2 * D], qkv[..., 2 * D :]
    if k_cache is not None:
        _kv_update(k_cache, k, n_past)
        _kv_update(v_cache, v, n_past)
        if isinstance(k_cache, dict):
            attn = _attention_int8(cfg, q, k_cache, v_cache, mask)
        else:
            attn = _attention(q, k_cache, v_cache, mask, cfg)
    else:
        attn = _attention(q, k, v, mask, cfg)
    x = x + (_proj(attn, layer, "proj").to(dt) + layer["proj_b"])
    h = layer_norm(x, layer["ln2_g"], layer["ln2_b"])
    h = gelu(_proj(h, layer, "fc").to(dt) + layer["fc_b"])
    return x + (_proj(h, layer, "out").to(dt) + layer["out_b"])


def transformer(cfg: GPTConfig, params: Params, x, k_caches, v_caches,
                n_past: int, mask):
    """All layers, then ln_f. Caches (L, S, D), int8 caches, or None;
    returns hidden (T, D), or (B, T, D) for the fine stage's (B, T, D)
    lanes (no caches)."""
    for l in range(cfg.n_layer):
        kc = None if k_caches is None else kv_view(k_caches, l)
        vc = None if v_caches is None else kv_view(v_caches, l)
        x = _block(cfg, x, _layer(params, l), kc, vc, n_past, mask)
    return layer_norm(x, params["ln_f_g"], params["ln_f_b"])


def logits_last(cfg: GPTConfig, params: Params, hidden_last):
    """LM head on one position: (D,) -> (n_out_vocab,) f32. A packed head
    is the transposed, zero-padded (D, v_pad) tile."""
    if is_qpack(params):
        logits = qdot(hidden_last[None], params["lm_q"], params["lm_s"],
                      params.get("lm_m"))
        return logits[0, :cfg.n_out_vocab]
    return _dot(params["lm_head"][0], hidden_last)


# ------------------------------------------------------------ entry points


def embed_prompt_merged(cfg: GPTConfig, params: Params, tokens513):
    """merge_ctx embedding of the 513-token semantic prompt -> (257, D);
    (B, 513) prompts give (B, 257, D)."""
    wte = params["wte"][0]
    t = tokens513.long()
    text = wte[t[..., :256]]
    hist = wte[t[..., 256:512]]
    infer = wte[t[..., 512:]]
    return torch.cat([text + hist, infer], dim=-2)


def prefill(cfg: GPTConfig, params: Params, x_emb, k_caches, v_caches,
            n_valid: int):
    """Causal prefill from n_past=0 of the (T, D) embeddings (no positions
    yet). Writes cache rows [0, T); returns the f32 logits of row
    n_valid-1."""
    T = x_emb.shape[0]
    x = x_emb + params["wpe"][:T]
    pos = torch.arange(T, device=x.device)[:, None]
    slot = torch.arange(cfg.block_size, device=x.device)[None, :]
    hidden = transformer(cfg, params, x, k_caches, v_caches, 0, slot <= pos)
    return logits_last(cfg, params, hidden[n_valid - 1])


def decode_step(cfg: GPTConfig, params: Params, token, k_caches, v_caches,
                n_past: int):
    """One token at slot `n_past`. `token` is an int or a one-element int
    tensor. Writes cache row n_past of every layer; returns f32 logits."""
    wpe = params["wpe"]
    tok = torch.as_tensor(token, device=wpe.device).reshape(1).long()
    x = embed_rows(params, tok) + wpe[n_past : n_past + 1]
    mask = (torch.arange(cfg.block_size, device=x.device) <= n_past)[None, :]
    hidden = transformer(cfg, params, x, k_caches, v_caches, n_past, mask)
    return logits_last(cfg, params, hidden[0])


def fine_forward(cfg: GPTConfig, params: Params, tokens, codebook_idx: int):
    """Non-causal fine-stage forward. tokens: (T, n_channels) int, or
    (B, T, n_channels) for B lanes, each computed as alone (the JAX
    package's `jax.vmap` of this function); the embedding sums
    wtes[0..codebook_idx] over channels 0..codebook_idx and the head for
    `codebook_idx - n_codes_given` is applied to every position. Returns
    (T, n_out_vocab), or (B, T, n_out_vocab), f32."""
    T = tokens.shape[-2]
    wte = params["wte"]
    t = tokens.long()
    embs = torch.stack(
        [wte[c][t[..., c]] for c in range(codebook_idx + 1)]
    )  # (cb+1, [B,] T, D)
    x = embs.sum(dim=0).to(wte.dtype) + params["wpe"][:T]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device)
    hidden = transformer(cfg, params, x, None, None, 0, mask)
    head = params["lm_head"][codebook_idx - cfg.n_codes_given]
    return _dot(hidden, head.T)


# ------------------------------------------------------------- random init


def init_params_numpy(cfg: GPTConfig, seed: int, scale: float = 0.02):
    """Host-side f32 random params, array for array the same draws as
    `bark_tpu.models.gpt.init_params_numpy` (numpy RandomState(seed))."""
    rng = np.random.RandomState(seed)
    L, D = cfg.n_layer, cfg.n_embd

    def rnd(*shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {
        "wte": rnd(cfg.n_wtes, cfg.n_in_vocab, D),
        "wpe": rnd(cfg.block_size, D),
        "lm_head": rnd(cfg.n_lm_heads, cfg.n_out_vocab, D),
        "ln_f_g": np.ones((D,), np.float32),
        "ln_f_b": np.zeros((D,), np.float32),
        "blocks": {
            "ln1_g": np.ones((L, D), np.float32),
            "ln1_b": np.zeros((L, D), np.float32),
            "ln2_g": np.ones((L, D), np.float32),
            "ln2_b": np.zeros((L, D), np.float32),
            "qkv_w": rnd(L, D, 3 * D),
            "qkv_b": np.zeros((L, 3 * D), np.float32),
            "proj_w": rnd(L, D, D),
            "proj_b": np.zeros((L, D), np.float32),
            "fc_w": rnd(L, D, 4 * D),
            "fc_b": np.zeros((L, 4 * D), np.float32),
            "out_w": rnd(L, 4 * D, D),
            "out_b": np.zeros((L, D), np.float32),
        },
    }


def init_params(cfg: GPTConfig, generator: torch.Generator, dtype, device,
                scale: float = 0.02) -> Params:
    """Random params drawn on `device` from `generator` (no host upload;
    the synthetic runs at published widths use this). Same shapes and
    init scheme as `init_params_numpy`, other values."""
    L, D = cfg.n_layer, cfg.n_embd

    def rnd(*shape):
        w = torch.randn(shape, generator=generator, device=device)
        return (w * scale).to(dtype)

    def const(v, *shape):
        return torch.full(shape, v, dtype=dtype, device=device)

    return {
        "wte": rnd(cfg.n_wtes, cfg.n_in_vocab, D),
        "wpe": rnd(cfg.block_size, D),
        "lm_head": rnd(cfg.n_lm_heads, cfg.n_out_vocab, D),
        "ln_f_g": const(1.0, D),
        "ln_f_b": const(0.0, D),
        "blocks": {
            "ln1_g": const(1.0, L, D),
            "ln1_b": const(0.0, L, D),
            "ln2_g": const(1.0, L, D),
            "ln2_b": const(0.0, L, D),
            "qkv_w": rnd(L, D, 3 * D),
            "qkv_b": const(0.0, L, 3 * D),
            "proj_w": rnd(L, D, D),
            "proj_b": const(0.0, L, D),
            "fc_w": rnd(L, D, 4 * D),
            "fc_b": const(0.0, L, 4 * D),
            "out_w": rnd(L, 4 * D, D),
            "out_b": const(0.0, L, D),
        },
    }
