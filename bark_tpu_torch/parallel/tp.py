"""The tensor-parallel forward of a `shard_context` context: plain PyTorch
on the CPU and on the GPU, with the collectives written out.

The JAX package leaves this mode to GSPMD, which partitions its
plain-XLA batched programs; the port runs the same arithmetic as
`models.gpt` (f32 accumulation, the params dtype between products, the
-1e9 mask, the int8 cache's `_attention_int8`) on this rank's shards
(`parallel.sharding`):

- embeddings: this rank's columns of wte and wpe, gathered over tp into
  the full width (every rank then holds the same residual stream);
- the fused QKV: this rank's heads' q, k and v columns, attention over its
  heads and its KV cache, which holds only those heads' features; where tp
  does not divide n_head (or D) the columns are gathered and every rank
  runs every head on a full-width cache;
- attention-out and MLP-out, row-parallel: this rank's rows times its
  chunk of the inputs, the partial sums added by an `all_reduce` over tp,
  then the bias; MLP-in is column-parallel;
- the LM heads: this rank's vocab rows, the logits gathered over tp;
- the int8 cache: a row's scale is the amax of the whole row, which spans
  every rank's heads, so the row amax is an `all_reduce(MAX)` over tp
  before the row is quantized (`gpt.quantize_kv_rows(x, amax)`).

Where placement left a tensor whole (an axis that tp does not divide, a
qpack plane that would split a quant block), the forward runs it whole:
`_cols` gathers what it needs in full, `_rows` reduces only a product whose
rows were cut. A qpack is dequantized shard by shard (`weights`). The
forward implements `pipeline.forward`'s methods, so the batched stage
programs run it unchanged; it launches no kernel and no kernel's plain
version.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from bark_tpu_torch.io import loader
from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels.window import codebook_base
from bark_tpu_torch.models import gpt
from bark_tpu_torch.ops import sampling


def heads_local(cfg, mesh) -> bool:
    """Whether each rank runs only its own heads (tp divides n_head)."""
    return mesh.tp > 1 and cfg.n_head % mesh.tp == 0


def kv_cache(cfg, mesh, batch: int, dtype, device, quant: bool):
    """(L, batch, S, W) caches, W this rank's heads' features (D / tp) or
    all D; int8 ({"q", "s"}) when `quant`."""
    width = cfg.n_embd // mesh.tp if heads_local(cfg, mesh) else cfg.n_embd
    return gpt.init_kv_cache(dataclasses.replace(cfg, n_embd=width), dtype,
                             device, batch=batch, quant=quant)


def _attention(q, k_all, v_all, mask, hd: int):
    """`gpt._attention` over N lanes: q (N, T, W), k/v (N, S, W), mask
    (N, T, S) -> (N, T, W)."""
    N, T, W = q.shape
    H = W // hd
    qh = q.reshape(N, T, H, hd).float()
    kh = k_all.reshape(N, -1, H, hd).float()
    vh = v_all.reshape(N, -1, H, hd)
    scores = torch.einsum("nthd,nshd->nhts", qh, kh) * (1.0 / math.sqrt(hd))
    scores = scores.masked_fill(~mask[:, None], -1e9)
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum("nhts,nshd->nthd", att.to(vh.dtype).float(),
                       vh.float())
    return out.to(q.dtype).reshape(N, T, W)


def _attention_int8(q, k_cache, v_cache, mask, hd: int):
    """`gpt._attention_int8` over N lanes on int8 layer caches
    ({"q": (N, S, W), "s": (N, S)})."""
    N, T, W = q.shape
    H = W // hd
    qs = (q.float() * (1.0 / math.sqrt(hd))).reshape(N, T, H, hd)
    q_i8, s_q = gpt.quantize_kv_rows(qs)
    scores = torch.einsum("nthd,nshd->nhts", q_i8.float(),
                          k_cache["q"].reshape(N, -1, H, hd).float())
    scores = (scores * s_q.permute(0, 2, 1)[..., None]
              * k_cache["s"][:, None, None, :])
    scores = scores.masked_fill(~mask[:, None], -1e9)
    att = torch.softmax(scores, dim=-1)
    vh = (v_cache["q"].float() * v_cache["s"][..., None]).to(q.dtype)
    vh = vh.reshape(N, -1, H, hd)
    out = torch.einsum("nhts,nshd->nthd", att.to(vh.dtype).float(),
                       vh.float())
    return out.to(q.dtype).reshape(N, T, W)


class TensorParallelForward:
    """`pipeline.forward`'s methods on this rank's shards (module
    docstring), over `mesh`'s tp group."""

    name = "tensor-parallel"

    def __init__(self, mesh):
        self.mesh = mesh

    # --------------------------------------------------------- the shards

    def weights(self, cfg, params):
        """(dense, dense): a qpack shard dequantized here (its LM head
        keeps this rank's vocab rows, padding included), a dense shard as
        it is; `head_rows` records the head's row count before sharding
        (`_logits` gathers the vocab when this rank holds fewer)."""
        if "head_rows" in params:
            return params, params
        if not gpt.is_qpack(params):
            dense = dict(params, head_rows=cfg.n_out_vocab)
            return dense, dense
        if "lm_q" in params:  # (D, v_pad): the vocab padded to whole tiles
            rows = -(-cfg.n_out_vocab // cfg.n_embd) * cfg.n_embd
            local = dataclasses.replace(
                cfg, n_out_vocab=params["lm_q"].shape[1])
        else:  # (n, V, D) multi-head stage
            rows, local = cfg.n_out_vocab, cfg
        dense = dict(loader.dense_from_qpack(local, params), head_rows=rows)
        return dense, dense

    def _cols(self, x, width: int):
        """x with all `width` features: gathered over tp when this rank
        holds its chunk of them."""
        return self.mesh.all_gather(x) if x.shape[-1] < width else x

    def _rows(self, x, w, width: int):
        """x @ w (f32) for a row-parallel (width, out) weight: when its
        rows are this rank's chunk, x's matching chunk times them, summed
        over tp; when whole, all of x times w."""
        R = w.shape[0]
        if R == width:
            return gpt._dot(self._cols(x, width), w)
        if x.shape[-1] == width:
            t = self.mesh.coord[1]
            x = x[..., t * R:(t + 1) * R]
        return self.mesh.all_reduce(gpt._dot(x, w))

    def _qkv(self, cfg, qkv):
        """(q, k, v) of the heads this rank runs, from its columns of the
        fused QKV (`parallel.sharding`'s layout)."""
        D, tp = cfg.n_embd, self.mesh.tp
        if qkv.shape[-1] < 3 * D:
            if heads_local(cfg, self.mesh):
                return qkv.split(qkv.shape[-1] // 3, dim=-1)
            qkv = self.mesh.all_gather(qkv)  # rank by rank
            if D % tp == 0:  # each rank's [q | k | v] chunk
                qkv = qkv.unflatten(-1, (tp, 3, D // tp)).transpose(
                    -3, -2).flatten(-3)
        return qkv.split(D, dim=-1)

    def _write(self, k_cache, v_cache, k, v, pos, cfg):
        """Write rows k, v (N, T, W) at cache rows pos (N, T), quantized
        on an int8 cache with each row's amax taken over the whole row."""
        lanes = torch.arange(k.shape[0], device=k.device)[:, None]
        if not isinstance(k_cache, dict):
            k_cache[lanes, pos] = k
            v_cache[lanes, pos] = v
            return
        amax = torch.stack([k.float().abs().amax(-1),
                            v.float().abs().amax(-1)])
        if heads_local(cfg, self.mesh):
            amax = self.mesh.all_reduce(amax, dist.ReduceOp.MAX)
        for cache, rows, a in ((k_cache, k, amax[0]), (v_cache, v, amax[1])):
            q, s = gpt.quantize_kv_rows(rows, a)
            cache["q"][lanes, pos] = q
            cache["s"][lanes, pos] = s

    def _block(self, cfg, x, layer, k_cache, v_cache, pos, mask):
        """One pre-LN block on x (N, T, D), every rank the same x; caches
        None for the fine stage."""
        D, dt, hd = cfg.n_embd, x.dtype, cfg.head_dim
        h = gpt.layer_norm(x, layer["ln1_g"], layer["ln1_b"])
        q, k, v = self._qkv(
            cfg, gpt._dot(h, layer["qkv_w"]).to(dt) + layer["qkv_b"])
        if k_cache is None:
            attn = _attention(q, k, v, mask, hd)
        else:
            self._write(k_cache, v_cache, k, v, pos, cfg)
            attn = (_attention_int8(q, k_cache, v_cache, mask, hd)
                    if isinstance(k_cache, dict) else
                    _attention(q, k_cache, v_cache, mask, hd))
        x = x + (self._rows(attn, layer["proj_w"], D).to(dt)
                 + layer["proj_b"])
        h = gpt.layer_norm(x, layer["ln2_g"], layer["ln2_b"])
        h = gpt.gelu(gpt._dot(h, layer["fc_w"]).to(dt) + layer["fc_b"])
        return x + (self._rows(h, layer["out_w"], 4 * D).to(dt)
                    + layer["out_b"])

    def _transformer(self, cfg, dense, x, k_caches, v_caches, pos, mask):
        for l in range(cfg.n_layer):
            layer = {k: v[l] for k, v in dense["blocks"].items()}
            kc = None if k_caches is None else gpt.kv_view(k_caches, l)
            vc = None if v_caches is None else gpt.kv_view(v_caches, l)
            x = self._block(cfg, x, layer, kc, vc, pos, mask)
        return gpt.layer_norm(x, dense["ln_f_g"], dense["ln_f_b"])

    def _logits(self, cfg, dense, hidden, head: int = 0, lm_window=None):
        """The f32 logits of hidden (..., D) through LM head `head`, every
        vocab entry on every rank, zero outside lm_window."""
        w = dense["lm_head"][head]
        logits = gpt._dot(hidden, w.T)
        if w.shape[0] < dense["head_rows"]:
            logits = self.mesh.all_gather(logits)
        logits = logits[..., :cfg.n_out_vocab]
        if lm_window is None:
            return logits
        lo, hi = lm_window
        out = torch.zeros_like(logits)
        out[..., lo:hi] = logits[..., lo:hi]
        return out

    # ----------------------------------------------- pipeline.forward's

    def embed_prompt(self, cfg, dense, tokens513):
        return self._cols(gpt.embed_prompt_merged(cfg, dense, tokens513),
                          cfg.n_embd)

    def embed(self, cfg, dense, ids):
        return self._cols(dense["wte"][0][ids.long()], cfg.n_embd)

    def kv_cache(self, cfg, dense, batch: int, quant: bool):
        wpe = dense["wpe"]
        return kv_cache(cfg, self.mesh, batch, wpe.dtype, wpe.device, quant)

    def prefill(self, cfg, dense, x_emb, k_cache, v_cache, n_valid,
                lm_window=None):
        """Every row of x_emb (N, T, D) from slot 0, as `gpt.prefill`
        computes them (rows past a lane's n_valid are written too, and
        stay masked until a decode step overwrites them); the logits of
        each lane's row n_valid[b] - 1."""
        n_valid = [int(n) for n in n_valid]
        N, T, dev = x_emb.shape[0], x_emb.shape[1], x_emb.device
        x = x_emb + self._cols(dense["wpe"][:T], cfg.n_embd)
        pos = torch.arange(T, device=dev)[None, :].expand(N, T)
        slot = torch.arange(cfg.block_size, device=dev)
        mask = slot[None, None, :] <= pos[:, :, None]
        hidden = self._transformer(cfg, dense, x, k_cache, v_cache, pos,
                                   mask)
        last = _build.device_ints([n - 1 for n in n_valid], dev).long()
        return self._logits(cfg, dense,
                            hidden[torch.arange(N, device=dev), last],
                            lm_window=lm_window)

    def step(self, cfg, params, tokens, k_cache, v_cache, n_past,
             lm_window=None):
        """One token a lane, lane b at slot n_past[b]; (N, n_out_vocab)
        f32 logits."""
        dense = params
        dev = dense["wpe"].device
        if not torch.is_tensor(tokens):
            tokens = _build.device_ints([int(t) for t in tokens], dev)
        pos = _build.device_ints([int(n) for n in n_past], dev).long()
        x = (self._cols(dense["wte"][0][tokens.long()], cfg.n_embd)
             + self._cols(dense["wpe"][pos], cfg.n_embd))[:, None]
        slot = torch.arange(cfg.block_size, device=dev)
        mask = (slot[None, :] <= pos[:, None])[:, None, :]
        hidden = self._transformer(cfg, dense, x, k_cache, v_cache,
                                   pos[:, None], mask)
        return self._logits(cfg, dense, hidden[:, 0], lm_window=lm_window)

    def chunk(self, cfg, params, logits, k_cache, v_cache, ctx_len: int,
              count0: int, noise, min_eos_p: float, *, K: int, temp: float,
              semantic_vocab_size: int):
        """K9's function: K steps of every lane, step j (global step g =
        count0 + j) sampling the full vocab with noise row g (clamped to
        the last) and the stop flag, then decoding at min(ctx_len + g,
        block_size - 1)."""
        N, toks, flags = logits.shape[0], [], []
        for j in range(K):
            g = count0 + j
            rows = None if temp == 0.0 else noise[:, min(g,
                                                         noise.shape[1] - 1)]
            tok, eos_p = sampling.sample(logits, temp, rows)
            toks.append(tok)
            flags.append((tok == semantic_vocab_size) | (eos_p >= min_eos_p))
            logits = self.step(cfg, params, tok, k_cache, v_cache,
                               [min(ctx_len + g, cfg.block_size - 1)] * N)
        return (torch.stack(toks, 1).to(torch.int32),
                torch.stack(flags, 1).to(torch.int32), logits)

    def window(self, cfg, params, logits0, k_cache, v_cache, ctx_len,
               step_idx0: int, noise, *, sws: int, temp: float,
               semantic_vocab_size: int, codebook_size: int, lm_window):
        """K10's function: sws steps of every lane, step j sampling the
        codebook window of global step step_idx0 + j with noise[j] and
        decoding the offset-carrying token at ctx_len[b] + j."""
        logits, toks = logits0, []
        for j in range(sws):
            base = codebook_base(step_idx0 + j, semantic_vocab_size,
                                 codebook_size)
            rel, _ = sampling.sample(logits[:, base:base + codebook_size],
                                     temp, None if temp == 0.0 else noise[j])
            toks.append(rel + base)
            logits = self.step(cfg, params, toks[-1], k_cache, v_cache,
                               [int(c) + j for c in ctx_len], lm_window)
        return torch.stack(toks, 1).to(torch.int32)

    def fine(self, cfg, params, tokens, codebook_idx: int):
        """`gpt.fine_forward` (non-causal, no cache) on the shards, over
        (B, T, C) lanes."""
        T, t, wte = tokens.shape[1], tokens.long(), params["wte"]
        embs = torch.stack([wte[c][t[..., c]]
                            for c in range(codebook_idx + 1)])
        x = (self._cols(embs.sum(dim=0).to(wte.dtype), cfg.n_embd)
             + self._cols(params["wpe"][:T], cfg.n_embd))
        mask = torch.ones((1, T, T), dtype=torch.bool, device=x.device)
        hidden = self._transformer(cfg, params, x, None, None, None, mask)
        return self._logits(cfg, params, hidden,
                            head=codebook_idx - cfg.n_codes_given)
