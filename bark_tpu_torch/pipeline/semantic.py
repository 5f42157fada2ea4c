"""Semantic stage: prefill of the 257-row merged prompt, then chunks of K
decode/sample steps until EOS or max_steps.

The counterpart of `bark_tpu.pipeline.semantic.make_semantic_program`, with
its reference semantics (bark.cpp:1645-1701): sampling over the FULL
n_out_vocab logits; eos_p is the softmax mass of the last logit slot; the
loop stops when `tok == semantic_vocab_size` or `eos_p >= min_eos_p`
WITHOUT appending the stopping token; at most max_steps tokens.

The prefill is K2 and each chunk is K3 (on CPU tensors, their plain
versions). Packed-quantized params (a qpack) are densified once per call
(`io.loader.densify`): the prompt embedding and K2 read the dense copy, K3
decodes from the qpack (its step loop then runs K5's packed read). The
host reads the K stop flags once per chunk and appends the tokens before
the first stop, exactly as the JAX package's chunked loop does; step g
uses noise row g, as the stepped JAX loop uses key subs[g].

With top-k or top-p filtering at temp > 0 the JAX package leaves its
chunk kernel for a loop of single steps with the sampler in XLA, and so
does the port: each token is sampled by `ops.sampling.sample` on the
device and decoded by one launch of the single step (K1, K5 on a qpack;
K7 and K5-batched for a batch), and the host reads one stop flag per step.
The stop step still decodes (its row is never read), at the clamped slot
min(257 + count - 1, block_size - 1) of the JAX loop. At temp 0 the
filters do nothing and the chunks run as above.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.io import loader
from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.kernels import prefill as kpre
from bark_tpu_torch.kernels import semantic as ksem
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.ops import sampling
from bark_tpu_torch.pipeline.forward import KERNELS

PROMPT_ROWS = 257  # merged 513-token prompt: 256 text+history rows + infer
CHUNK = 16  # steps per K3 call (bark_tpu.kernels.semantic.chunk_size)


def filtered(temp: float, top_k: int, top_p: float) -> bool:
    """Whether a stage samples through the filtered single-step loop."""
    return temp != 0.0 and bool(top_k or top_p)


def make_semantic_program(cfg: GPTConfig, *, temp: float, max_steps: int,
                          semantic_vocab_size: int, kv_quant: bool = False,
                          top_k: int = 0, top_p: float = 0.0):
    """fn(params, tokens513 (513,) int tensor, noise (max_steps,
    n_out_vocab) f32 or None at temp 0, min_eos_p) -> (tokens (max_steps,)
    int32 on the params' device, n_generated int). kv_quant: the int8 KV
    cache (`gpt.init_kv_cache(quant=True)`). top_k / top_p: the filters
    (0 turns either off)."""
    steps = filtered(temp, top_k, top_p)

    def run(params, tokens513, noise, min_eos_p: float):
        dtype, device = params["wpe"].dtype, params["wpe"].device
        dense = loader.densify(cfg, params)
        x_emb = gpt.embed_prompt_merged(cfg, dense, tokens513)
        kc, vc = gpt.init_kv_cache(cfg, dtype, device, quant=kv_quant)
        logits = kpre.prefill_fused(cfg, dense, x_emb, kc, vc, PROMPT_ROWS)
        out = torch.zeros((max_steps,), dtype=torch.int32, device=device)
        count = 0
        while steps and count < max_steps:
            tok, eos_p = sampling.sample(logits, temp, noise[count], top_k,
                                         top_p)
            stop = bool((tok == semantic_vocab_size)
                        | (eos_p >= min_eos_p))
            if not stop:
                out[count] = tok
                count += 1
            logits = kdec.decode_step_fused(
                cfg, params, tok, kc, vc,
                min(PROMPT_ROWS + count - 1, cfg.block_size - 1))
            if stop:
                return out, count
        while not steps and count < max_steps:
            toks, flags, logits = ksem.semantic_chunk_fused(
                cfg, params, logits, kc, vc, PROMPT_ROWS, count, noise,
                min_eos_p, K=CHUNK, temp=temp,
                semantic_vocab_size=semantic_vocab_size,
            )
            stops = [j for j, f in enumerate(flags.tolist()) if f]
            first_stop = stops[0] if stops else CHUNK
            appended = min(first_stop, max_steps - count)
            out[count:count + appended] = toks[:appended]
            count += appended
            if first_stop < CHUNK:
                break
        return out, count

    return run


def make_semantic_program_batched(cfg: GPTConfig, *, temp: float,
                                  max_steps: int, semantic_vocab_size: int,
                                  kv_quant: bool = False, top_k: int = 0,
                                  top_p: float = 0.0, forward=KERNELS):
    """The counterpart of `bark_tpu.pipeline.semantic.
    make_semantic_program_batched`: B lanes through one K8 prefill of
    B x 257 rows, then K9 chunks of CHUNK steps in lockstep until every
    lane has stopped or max_steps.

    fn(params, tokens513 (B, 513) int tensor, noise (B, max_steps,
    n_out_vocab) f32 or None at temp 0, min_eos_p) -> (tokens (B,
    max_steps) int32 on the params' device, counts: B ints). Lane b's
    tokens and count are those of `make_semantic_program` given noise[b]:
    a running lane's count is the chunk's global step, so the host reads
    each chunk's (B, CHUNK) stop flags once and freezes a lane at its first
    stop, appending nothing after it. A stopped lane keeps decoding in the
    kernel; its later tokens land past its count and are zeroed. A qpack
    is densified once per call, as in `make_semantic_program`: the prompt
    embedding and K8 read the dense copy, K9 decodes from the qpack (its
    K7 steps are then K5-batched).

    With the filters (`filtered`), every step samples the B lanes in one
    `ops.sampling.sample` call and decodes them in one launch of K7's
    step (K5-batched's on a qpack), as the JAX package's stepped batched
    loop does: the host reads the B stop flags of each step; a stopped
    lane keeps stepping in lockstep at its frozen count (its noise row and
    slot), and its later tokens are discarded.

    `forward`: what runs the prefill, the chunks and the steps
    (`pipeline.forward`; the kernels above by default)."""
    steps = filtered(temp, top_k, top_p)

    def run(params, tokens513, noise, min_eos_p: float):
        device = params["wpe"].device
        B = tokens513.shape[0]
        dense, params = forward.weights(cfg, params)
        x_emb = forward.embed_prompt(cfg, dense, tokens513)
        kc, vc = forward.kv_cache(cfg, dense, B, kv_quant)
        logits = forward.prefill(cfg, dense, x_emb.contiguous(), kc, vc,
                                 [PROMPT_ROWS] * B)
        chunks, counts, done, g0 = [], [0] * B, [max_steps == 0] * B, 0
        lanes = torch.arange(B, device=device)
        while steps and not all(done):
            rows = _build.device_ints([min(c, max_steps - 1)
                                       for c in counts], device)
            toks, eos_p = sampling.sample(logits, temp, noise[lanes, rows],
                                          top_k, top_p)
            stops = ((toks == semantic_vocab_size)
                     | (eos_p >= min_eos_p)).tolist()
            chunks.append(toks.to(torch.int32)[:, None])
            for b in range(B):
                if not done[b] and not stops[b]:
                    counts[b] += 1
                done[b] = done[b] or stops[b] or counts[b] >= max_steps
            logits = forward.step(
                cfg, params, toks, kc, vc,
                [min(PROMPT_ROWS + c - 1, cfg.block_size - 1)
                 for c in counts])
        while not steps and not all(done) and g0 < max_steps:
            toks, flags, logits = forward.chunk(
                cfg, params, logits, kc, vc, PROMPT_ROWS, g0, noise,
                min_eos_p, K=CHUNK, temp=temp,
                semantic_vocab_size=semantic_vocab_size,
            )
            chunks.append(toks)
            for b, lane_flags in enumerate(flags.tolist()):
                if done[b]:
                    continue
                first_stop = (lane_flags.index(1) if any(lane_flags)
                              else CHUNK)
                counts[b] += min(first_stop, max_steps - g0)
                done[b] = first_stop < CHUNK or counts[b] >= max_steps
            g0 += CHUNK
        out = torch.zeros((B, max_steps), dtype=torch.int32, device=device)
        if chunks:
            toks = torch.cat(chunks, dim=1)[:, :max_steps]
            keep = (torch.arange(toks.shape[1], device=device)[None, :]
                    < torch.tensor(counts, device=device)[:, None])
            out[:, :toks.shape[1]] = torch.where(keep, toks, 0)
        return out, counts

    return run
