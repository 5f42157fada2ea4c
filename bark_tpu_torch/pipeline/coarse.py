"""Coarse stage: sliding-window re-prime + 60-step windows.

The counterpart of `bark_tpu.pipeline.coarse` (bark_eval_coarse_encoder,
bark.cpp:1745-1863): every `sliding_window_size` steps the context is
rebuilt from the last ~209 semantic tokens (right-padded to 256 with
coarse_semantic_pad_token), coarse_infer_token and the last <= 630
generated coarse tokens; n_past restarts at 0 with a prefill (K2), and
the window's steps run as K4, alternating the two codebook logit windows
and keeping the offset on the emitted token. A qpack is densified once per
call, not per window: the context embedding and K2 read the dense copy,
K4 decodes from the qpack.

`stc_fraction`, `coarse_schedule` and `max_coarse_steps` are copies of the
JAX module's integer-exact schedule (that module imports jax);
tests/test_torch_config.py holds them equal. The whole window loop stays
on the device: the context is rebuilt from device tensors, so nothing is
read back between windows.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Tuple

import torch

from bark_tpu_torch.kernels import bprefill as kbpre
from bark_tpu_torch.kernels import bwindow as kbwin
from bark_tpu_torch.kernels import prefill as kpre
from bark_tpu_torch.kernels import window as kwin
from bark_tpu_torch.io import loader
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.params import BarkContextParams

# 256 semantic slots + 1 infer token + up to max_coarse_history coarse tokens
CTX_SEMANTIC = 256


def stc_fraction(params: BarkContextParams) -> Tuple[int, int]:
    """The semantic->coarse step ratio coarse_rate/semantic_rate *
    n_coarse_codebooks as an exact small fraction num/den (1500/499 for
    the default rates)."""
    stc = (
        params.coarse_rate_hz
        / params.semantic_rate_hz
        * params.n_coarse_codebooks
    )
    frac = Fraction(stc).limit_denominator(10_000)
    return frac.numerator, frac.denominator


def coarse_schedule(n_semantic: int, params: BarkContextParams):
    """(stc_ratio, max_semantic_history, n_steps, n_windows), the
    integer-exact form of the reference's float schedule
    (bark.cpp:1775-1787)."""
    num, den = stc_fraction(params)
    stc_ratio = num / den
    n_cc = params.n_coarse_codebooks
    max_semantic_history = params.max_coarse_history * den // num
    n_steps = (n_semantic * num) // (den * n_cc) * n_cc
    n_windows = -(-n_steps // params.sliding_window_size)
    return stc_ratio, max_semantic_history, n_steps, n_windows


def max_coarse_steps(max_semantic: int, params: BarkContextParams) -> int:
    """Static upper bound on n_steps for a given semantic-length bound."""
    num, den = stc_fraction(params)
    n_cc = params.n_coarse_codebooks
    return (max_semantic * num) // (den * n_cc) * n_cc


def make_coarse_stage_program(cfg: GPTConfig, bparams: BarkContextParams, *,
                              ctx_size: int, kv_quant: bool = False):
    """fn(params, sem (n_sem,) int tensor, noise (n_windows, sws,
    codebook_size) f32 or None at temp 0) -> (codes (n_steps // n_cc, n_cc)
    int32 de-offset, n_steps int), with the empty voice history of the
    reference (bark.cpp:640-651). kv_quant: the int8 KV cache."""
    p = bparams
    num, den = stc_fraction(p)
    n_cc, sws = p.n_coarse_codebooks, p.sliding_window_size
    hist_cap = p.max_coarse_history
    max_sem_hist = max(1, hist_cap * den // num)
    svs, cbs = p.semantic_vocab_size, p.codebook_size
    lm_window = (svs, svs + n_cc * cbs)
    if n_cc != 2:
        raise ValueError("the coarse window samples exactly 2 codebooks")

    def run(params, sem, noise):
        device = params["wpe"].device
        n_sem = int(sem.shape[0])
        _, _, n_steps, n_windows = coarse_schedule(n_sem, p)
        # [new tokens | pad...]: a 256-slot slice from any window start
        # (<= n_sem) stays inside
        sem_full = torch.full((n_sem + CTX_SEMANTIC,),
                              p.coarse_semantic_pad_token,
                              dtype=torch.int32, device=device)
        sem_full[:n_sem] = sem.to(device=device, dtype=torch.int32)
        infer = torch.full((1,), p.coarse_infer_token, dtype=torch.int32,
                           device=device)
        out = torch.zeros((hist_cap + n_steps + sws,), dtype=torch.int32,
                          device=device)
        dense = loader.densify(cfg, params)
        wte = dense["wte"][0]
        kc, vc = gpt.init_kv_cache(cfg, wte.dtype, device, quant=kv_quant)
        for w in range(n_windows):
            g = w * sws  # tokens generated so far
            # roundf(g / stc_ratio) in integers (bark.cpp:1789)
            semantic_idx = (2 * g * den + num) // (2 * num)
            lo = max(semantic_idx - max_sem_hist, 0)
            hist_start = max(g - hist_cap, 0)
            ctx = torch.cat([
                sem_full[lo:lo + CTX_SEMANTIC], infer,
                out[hist_start:hist_start + hist_cap],
            ])[:ctx_size]
            ctx_len = CTX_SEMANTIC + 1 + min(g, hist_cap)
            logits = kpre.prefill_fused(cfg, dense, wte[ctx.long()], kc, vc,
                                        ctx_len, lm_window=lm_window)
            toks = kwin.coarse_window_fused(
                cfg, params, logits, kc, vc, ctx_len, g,
                None if p.temp == 0.0 else noise[w], sws=sws, temp=p.temp,
                semantic_vocab_size=svs, codebook_size=cbs,
                lm_window=lm_window,
            )
            out[g:g + sws] = toks
        codes = out[:n_steps].reshape(-1, n_cc) - svs
        codes = codes - torch.arange(n_cc, dtype=torch.int32,
                                     device=device)[None, :] * cbs
        return codes, n_steps

    return run


def make_coarse_stage_program_batched(cfg: GPTConfig,
                                      bparams: BarkContextParams, *,
                                      ctx_size: int, kv_quant: bool = False):
    """The counterpart of `bark_tpu.pipeline.coarse.
    make_coarse_stage_program_batched`, with the empty voice history: the
    lanes share the window counter, and each window is one K8 prefill of
    the running lanes' contexts and one K10 window over them.

    fn(params, sems: B (n_sem_b,) int tensors, noises: B (n_windows_b,
    sws, codebook_size) f32 tensors or None at temp 0) -> (codes: B
    (n_steps_b // n_cc, n_cc) int32 de-offset tensors, n_steps: B ints).
    Lane b's codes are those of `make_coarse_stage_program` given
    noises[b]. Where the JAX program keeps decoding a lane past its own
    n_steps and masks what it writes, this one leaves such a lane out of
    the later windows: the lanes are ordered by n_steps, longest first, so
    a window's running lanes are a leading slice of every per-lane tensor
    (no gather, no host round trip). A qpack is densified once per call,
    not per window: the contexts' embedding and K8 read the dense copy,
    K10 decodes from the qpack (K5-batched). kv_quant: the int8 KV
    cache."""
    p = bparams
    num, den = stc_fraction(p)
    n_cc, sws = p.n_coarse_codebooks, p.sliding_window_size
    hist_cap = p.max_coarse_history
    max_sem_hist = max(1, hist_cap * den // num)
    svs, cbs = p.semantic_vocab_size, p.codebook_size
    lm_window = (svs, svs + n_cc * cbs)
    if n_cc != 2:
        raise ValueError("the coarse window samples exactly 2 codebooks")

    def run(params, sems, noises):
        device = params["wpe"].device
        n_steps = [coarse_schedule(int(s.shape[0]), p)[2] for s in sems]
        order = sorted(range(len(sems)), key=lambda b: -n_steps[b])
        B = len(order)
        steps = [n_steps[b] for b in order]  # descending
        width = max(int(s.shape[0]) for s in sems) + CTX_SEMANTIC
        # per lane, [new tokens | pad...] as in the single-lane program
        sem_full = torch.full((B, width), p.coarse_semantic_pad_token,
                              dtype=torch.int32, device=device)
        for i, b in enumerate(order):
            sem_full[i, :sems[b].shape[0]] = sems[b].to(device)
        infer = torch.full((B, 1), p.coarse_infer_token, dtype=torch.int32,
                           device=device)
        out = torch.zeros((B, hist_cap + steps[0] + sws), dtype=torch.int32,
                          device=device)
        dense = loader.densify(cfg, params)
        wte = dense["wte"][0]
        for w in range(-(-steps[0] // sws)):
            g = w * sws  # tokens generated so far, by every running lane
            Ba = sum(1 for s in steps if g < s)
            semantic_idx = (2 * g * den + num) // (2 * num)
            lo = max(semantic_idx - max_sem_hist, 0)
            hist_start = max(g - hist_cap, 0)
            ctx = torch.cat([
                sem_full[:Ba, lo:lo + CTX_SEMANTIC], infer[:Ba],
                out[:Ba, hist_start:hist_start + hist_cap],
            ], dim=1)[:, :ctx_size]
            ctx_len = CTX_SEMANTIC + 1 + min(g, hist_cap)
            kc, vc = gpt.init_kv_cache(cfg, wte.dtype, device, batch=Ba,
                                        quant=kv_quant)
            logits = kbpre.prefill_fused_batched(
                cfg, dense, wte[ctx.long()], kc, vc, [ctx_len] * Ba,
                lm_window=lm_window)
            noise = (None if p.temp == 0.0 else torch.stack(
                [noises[b][w] for b in order[:Ba]], dim=1))
            toks = kbwin.coarse_window_fused_batched(
                cfg, params, logits, kc, vc, [ctx_len] * Ba, g, noise,
                sws=sws, temp=p.temp, semantic_vocab_size=svs,
                codebook_size=cbs, lm_window=lm_window,
            )
            out[:Ba, g:g + sws] = toks
        offs = svs + torch.arange(n_cc, dtype=torch.int32,
                                  device=device)[None, :] * cbs
        codes = [None] * B
        for i, b in enumerate(order):
            codes[b] = out[i, :steps[i]].reshape(-1, n_cc) - offs
        return codes, n_steps

    return run
