"""Token sampling with the noise as an input.

The counterpart of `bark_tpu.ops.sampling` for the default sampler
(gpt_sample, bark.cpp:184-270):

- temp > 0: `tok = argmax(logits/temp + gumbel)`, which is what
  `jax.random.categorical(key, logits/temp)` computes with
  `gumbel = jax.random.gumbel(key, logits.shape)`; eos_p is the softmax
  mass of the LAST logit slot of logits/temp.
- temp == 0: argmax of the logits, and eos_p over logits/0.7 (the
  reference's hardcoded "testing" divide, bark.cpp:223-230).

Top-k and top-p (suno's filters, which the JAX package adds): top-p, then
top-k, on the raw logits; the draw is then over filtered/temp, and eos_p
stays over the unfiltered logits/temp. At temp 0 the filters do nothing.
The JAX package computes this step in XLA, outside any Pallas kernel; the
port computes it with PyTorch's sort, softmax and cumsum, on the device.

Ties go to the lowest index, as in `jnp.argmax`. Because the noise is an
input, a test can hand the port the noise `bark_tpu` draws from its keys
and compare tokens bit for bit. Every function takes (..., V) logits and
works on the last axis, so a batch of lanes samples in one call.
"""

from __future__ import annotations

import torch

_TINY = torch.finfo(torch.float32).tiny


def gumbel(shape, generator: torch.Generator, device):
    """Standard Gumbel noise, f32, drawn on `device`: -log(-log(U)) with U
    bounded away from 0, the formula of jax.random.gumbel."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_(min=_TINY)))


def divide(x, d: float):
    """x / d as an f32 division. The divisor is a tensor on purpose:
    PyTorch's CUDA kernel turns a division by a Python scalar into a
    multiplication by its reciprocal, which can differ in the last ulp from
    the division the JAX package and the CUDA sampler compute. It is filled
    on the device (`torch.full`), not copied from the host, so the host
    never waits for the stream here."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def apply_top_k(logits, top_k: int):
    """Keep the top_k largest logits of each row, -inf the rest; top_k is
    clamped to [1, V] (suno's min(top_k, size): the coarse sampler filters
    codebook-wide slices with the semantic stage's top_k)."""
    top_k = max(1, min(top_k, logits.shape[-1]))
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def apply_top_p(logits, top_p: float):
    """Nucleus filtering, suno's shifted-right form: in the descending
    order (stable, so ties keep their index order, as `jnp.argsort` does),
    a token is removed when the softmax mass before it already exceeds
    top_p; the most probable token always stays."""
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    cum = torch.cumsum(torch.softmax(logits.gather(-1, order), dim=-1),
                       dim=-1)
    remove_sorted = torch.zeros_like(cum, dtype=torch.bool)
    remove_sorted[..., 1:] = cum[..., :-1] > top_p
    remove = torch.empty_like(remove_sorted).scatter_(-1, order,
                                                      remove_sorted)
    return torch.where(remove, float("-inf"), logits)


def sample(logits, temp: float, noise=None, top_k: int = 0,
           top_p: float = 0.0):
    """(tok, eos_p) from (..., V) logits: int64 and f32 tensors of the
    leading shape (0-d for one row). `noise` is Gumbel rows of the logits'
    shape, unused at temp 0. top_p, then top_k, filter the raw logits
    before the draw (0 turns either off); eos_p is the last slot's mass
    of the unfiltered logits/temp."""
    logits = logits.float()
    if temp == 0.0:
        eos_p = torch.softmax(divide(logits, 0.7), dim=-1)[..., -1]
        return torch.argmax(logits, dim=-1), eos_p
    scaled = divide(logits, temp)
    eos_p = torch.softmax(scaled, dim=-1)[..., -1]
    if top_p:
        logits = apply_top_p(logits, top_p)
    if top_k:
        logits = apply_top_k(logits, top_k)
    if top_p or top_k:
        scaled = divide(logits, temp)
    return torch.argmax(scaled + noise, dim=-1), eos_p


def sample_rows(logits, temp: float, noise=None):
    """Independent per-row samples of (..., V) logits -> (...) int64;
    `noise` is f32 of the logits' shape, unused at temp 0."""
    logits = logits.float()
    if temp == 0.0:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(divide(logits, temp) + noise, dim=-1)
