"""Coarse stage: sliding-window re-prime + 60-step windows.

The counterpart of `bark_tpu.pipeline.coarse` (bark_eval_coarse_encoder,
bark.cpp:1745-1863): every `sliding_window_size` steps the context is
rebuilt from the last ~209 semantic tokens (right-padded to 256 with
coarse_semantic_pad_token), coarse_infer_token and the last <= 630
coarse tokens; n_past restarts at 0 with a prefill (K2), and the window's
steps run as K4, alternating the two codebook logit windows and keeping
the offset on the emitted token. A qpack is densified once per call, not
per window: the context embedding and K2 read the dense copy, K4 decodes
from the qpack.

Voice presets (`pipeline.voice.coarse_history`): the preset's semantic
history is prepended on the semantic axis (window indices offset by its
length, suno's base_semantic_idx) and its flattened offset-carrying coarse
history preloads the output, so the first window already re-primes up to
257 + max_coarse_history rows. Empty histories give the reference's.

With top-k or top-p at temp > 0 (`semantic.filtered`) a window is its
prefill and then one launch of the single step (K1, K5 on a qpack; K7 or
K5-batched for a batch) per token, each token sampled by
`ops.sampling.sample` over its codebook window on the device: the JAX
package's scan of single steps. Nothing is read back inside a window.

`stc_fraction`, `coarse_schedule` and `max_coarse_steps` are copies of the
JAX module's integer-exact schedule (that module imports jax);
tests/test_torch_config.py holds them equal. The stage keeps its window
loop on the device: the context is rebuilt from device tensors, so
nothing is read back between windows. That loop is one generator of
windows (`make_coarse_windows`): the stage program drains it, and the
stepped path is the same program with a `progress_cb`, called after every
window with the JAX package's percentage
(`bark_tpu.pipeline.coarse.generate_coarse`); a stream takes its windows
one by one (`BarkContext.generate_audio_stream`).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Tuple

import numpy as np
import torch

from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import decode as kdec
from bark_tpu_torch.kernels import prefill as kpre
from bark_tpu_torch.kernels import window as kwin
from bark_tpu_torch.io import loader
from bark_tpu_torch.models import gpt
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.ops import sampling
from bark_tpu_torch.params import BarkContextParams
from bark_tpu_torch.pipeline.forward import KERNELS
from bark_tpu_torch.pipeline.semantic import filtered

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


class _Window:
    """What every window of a coarse stage shares: the schedule's
    constants and the window itself (re-prime + steps)."""

    def __init__(self, cfg: GPTConfig, p: BarkContextParams, kv_quant: bool,
                 forward=KERNELS):
        if p.n_coarse_codebooks != 2:
            raise ValueError("the coarse window samples exactly 2 codebooks")
        self.cfg, self.p, self.kv_quant = cfg, p, kv_quant
        self.forward = forward
        self.num, self.den = stc_fraction(p)
        self.sws, self.hist_cap = p.sliding_window_size, p.max_coarse_history
        self.max_sem_hist = max(1, self.hist_cap * self.den // self.num)
        self.svs, self.cbs = p.semantic_vocab_size, p.codebook_size
        self.lm_window = (self.svs, self.svs + 2 * self.cbs)
        self.steps = filtered(p.temp, p.top_k, p.top_p)

    def sem_lo(self, n_sem_hist: int, g: int) -> int:
        """The first semantic slot of the context after g new tokens:
        base_semantic_idx + roundf(g / stc_ratio) (bark.cpp:1789), less
        the semantic history window."""
        semantic_idx = n_sem_hist + (2 * g * self.den + self.num) // (
            2 * self.num)
        return max(semantic_idx - self.max_sem_hist, 0)

    def ctx_len(self, tot: int) -> int:
        return CTX_SEMANTIC + 1 + min(tot, self.hist_cap)

    def run(self, params, dense, kc, vc, ctx, ctx_len: int, g: int, noise):
        """One window of a single lane into (kc, vc): the prefill of
        ctx[:ctx_len] (K2) and sws steps from slot ctx_len (K4, or the
        filtered single steps). Returns the (sws,) i32 offset-carrying
        tokens."""
        cfg, p, sws = self.cfg, self.p, self.sws
        wte = dense["wte"][0]
        logits = kpre.prefill_fused(cfg, dense, wte[ctx.long()], kc, vc,
                                    ctx_len, lm_window=self.lm_window)
        if not self.steps:
            return kwin.coarse_window_fused(
                cfg, params, logits, kc, vc, ctx_len, g,
                None if p.temp == 0.0 else noise, sws=sws, temp=p.temp,
                semantic_vocab_size=self.svs, codebook_size=self.cbs,
                lm_window=self.lm_window)
        toks = []
        for j in range(sws):
            base = kwin.codebook_base(g + j, self.svs, self.cbs)
            rel, _ = sampling.sample(logits[base:base + self.cbs], p.temp,
                                     noise[j], p.top_k, p.top_p)
            toks.append(rel + base)
            logits = kdec.decode_step_fused(cfg, params, toks[-1], kc, vc,
                                            ctx_len + j,
                                            lm_window=self.lm_window)
        return torch.stack(toks).to(torch.int32)

    def run_batched(self, params, dense, ctx, ctx_lens, g: int, noise):
        """One window of Ba lanes: K8 over the (Ba, ctx_size) contexts at
        their own lengths, then K10 (or the filtered batched steps) from
        each lane's ctx_len, through `self.forward`. `noise`: (sws, Ba,
        cbs) or None at temp 0. Returns the (Ba, sws) i32 offset-carrying
        tokens."""
        cfg, p, sws, fwd = self.cfg, self.p, self.sws, self.forward
        kc, vc = fwd.kv_cache(cfg, dense, len(ctx_lens), self.kv_quant)
        logits = fwd.prefill(cfg, dense, fwd.embed(cfg, dense, ctx), kc, vc,
                             ctx_lens, lm_window=self.lm_window)
        if not self.steps:
            return fwd.window(
                cfg, params, logits, kc, vc, ctx_lens, g, noise, sws=sws,
                temp=p.temp, semantic_vocab_size=self.svs,
                codebook_size=self.cbs, lm_window=self.lm_window)
        toks = []
        for j in range(sws):
            base = kwin.codebook_base(g + j, self.svs, self.cbs)
            rel, _ = sampling.sample(logits[:, base:base + self.cbs],
                                     p.temp, noise[j], p.top_k, p.top_p)
            toks.append(rel + base)
            logits = fwd.step(
                cfg, params, toks[-1], kc, vc, [n + j for n in ctx_lens],
                lm_window=self.lm_window)
        return torch.stack(toks, dim=1).to(torch.int32)


def _history(hist, device):
    """A history (array, tensor or None) as an int32 tensor on device."""
    if hist is None:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    if not torch.is_tensor(hist):
        hist = torch.from_numpy(np.asarray(hist, np.int32))
    return hist.to(device=device, dtype=torch.int32)


def make_coarse_windows(cfg: GPTConfig, bparams: BarkContextParams, *,
                        ctx_size: int, kv_quant: bool = False):
    """The coarse stage's window loop, one window at a time.

    fn(params, sem (n_sem,) int tensor, noise (n_windows, sws,
    codebook_size) f32 or None at temp 0, sem_hist=None, coarse_hist=None)
    -> a generator over the stage's windows. Each step runs one window on
    the device (its re-prime, K2, then its steps, K4 or the filtered single
    steps) and yields `(done, codes)`: `done` the tokens generated so far
    (at most n_steps), `codes` the (done // n_cc, n_cc) int32 de-offset
    codes of the whole frames generated so far, a view of the stage's
    buffer that later windows do not write. Nothing is read back.
    `sem_hist` / `coarse_hist` are a voice preset's trimmed histories
    (`pipeline.voice.coarse_history`; None or empty: the reference's empty
    history, bark.cpp:640-651). A qpack is densified once per call, before
    the first window. kv_quant: the int8 KV cache.

    `make_coarse_stage_program` drains it; `BarkContext.
    generate_audio_stream` refines and decodes after each window."""
    win = _Window(cfg, bparams, kv_quant)
    p, sws, hist_cap = bparams, win.sws, win.hist_cap

    def run(params, sem, noise, sem_hist=None, coarse_hist=None):
        device = params["wpe"].device
        n_sem = int(sem.shape[0])
        _, _, n_steps, n_windows = coarse_schedule(n_sem, p)
        sem_hist = _history(sem_hist, device)
        coarse_hist = _history(coarse_hist, device)
        n_h, n_ch = int(sem_hist.numel()), int(coarse_hist.numel())
        # [history | new tokens | pad...]: a 256-slot slice from any window
        # start (<= n_h + n_sem) stays inside
        sem_full = torch.full((n_h + n_sem + CTX_SEMANTIC,),
                              p.coarse_semantic_pad_token,
                              dtype=torch.int32, device=device)
        sem_full[:n_h] = sem_hist
        sem_full[n_h:n_h + n_sem] = sem.to(device=device, dtype=torch.int32)
        infer = torch.full((1,), p.coarse_infer_token, dtype=torch.int32,
                           device=device)
        # [coarse history | generated tokens | one window of overrun]
        out = torch.zeros((hist_cap + n_steps + sws,), dtype=torch.int32,
                          device=device)
        out[:n_ch] = coarse_hist
        offs = win.svs + torch.arange(2, dtype=torch.int32,
                                      device=device)[None, :] * win.cbs
        dense = loader.densify(cfg, params)
        wte = dense["wte"][0]
        kc, vc = gpt.init_kv_cache(cfg, wte.dtype, device, quant=kv_quant)
        for w in range(n_windows):
            g = w * sws  # tokens generated so far
            tot = n_ch + g  # position on the coarse axis, history included
            lo = win.sem_lo(n_h, g)
            hist_start = max(tot - hist_cap, 0)
            ctx = torch.cat([
                sem_full[lo:lo + CTX_SEMANTIC], infer,
                out[hist_start:hist_start + hist_cap],
            ])[:ctx_size]
            out[tot:tot + sws] = win.run(
                params, dense, kc, vc, ctx, win.ctx_len(tot), g,
                None if noise is None else noise[w])
            done = min(g + sws, n_steps)
            yield done, out[n_ch:n_ch + done // 2 * 2].reshape(-1, 2) - offs

    return run


def make_coarse_stage_program(cfg: GPTConfig, bparams: BarkContextParams, *,
                              ctx_size: int, kv_quant: bool = False):
    """fn(params, sem (n_sem,) int tensor, noise (n_windows, sws,
    codebook_size) f32 or None at temp 0, sem_hist=None, coarse_hist=None,
    progress_cb=None) -> (codes (n_steps // n_cc, n_cc) int32 de-offset,
    n_steps int): every window of `make_coarse_windows`, queued one after
    another. `progress_cb(percent)` is called after each window is queued,
    with the share of the n_steps tokens done."""
    windows = make_coarse_windows(cfg, bparams, ctx_size=ctx_size,
                                  kv_quant=kv_quant)

    def run(params, sem, noise, sem_hist=None, coarse_hist=None,
            progress_cb=None):
        n_steps = coarse_schedule(int(sem.shape[0]), bparams)[2]
        codes = torch.zeros((0, 2), dtype=torch.int32,
                            device=params["wpe"].device)
        for done, codes in windows(params, sem, noise, sem_hist,
                                   coarse_hist):
            if progress_cb is not None:
                progress_cb(100 * done // n_steps)
        return codes, n_steps

    return run


def make_coarse_stage_program_batched(cfg: GPTConfig,
                                      bparams: BarkContextParams, *,
                                      ctx_size: int, kv_quant: bool = False,
                                      forward=KERNELS):
    """The counterpart of `bark_tpu.pipeline.coarse.
    make_coarse_stage_program_batched`: the lanes share the window
    counter, and each window is one K8 prefill of the running lanes'
    contexts and one K10 window over them (the filtered batched steps
    with top-k or top-p).

    fn(params, sems: B (n_sem_b,) int tensors, noises: B (n_windows_b,
    sws, codebook_size) f32 tensors or None at temp 0, sem_hists=None,
    coarse_hists=None: B per-lane histories as `make_coarse_stage_program`
    takes them) -> (codes: B (n_steps_b // n_cc, n_cc) int32 de-offset
    tensors, n_steps: B ints). Lane b's codes are those of
    `make_coarse_stage_program` given noises[b] and its histories. Where
    the JAX program keeps decoding a lane past its own n_steps and masks
    what it writes, this one leaves such a lane out of the later windows:
    the lanes are ordered by n_steps, longest first, so a window's running
    lanes are a leading slice of every per-lane tensor; each lane's
    context is gathered from its own offsets (its history lengths move
    them), and the contexts' lengths differ when the coarse histories do.
    A qpack is densified once per call, not per window: the contexts'
    embedding and K8 read the dense copy, K10 decodes from the qpack
    (K5-batched). kv_quant: the int8 KV cache. `forward`: what runs the
    prefills, the windows and the steps (`pipeline.forward`; the kernels
    above by default)."""
    win = _Window(cfg, bparams, kv_quant, forward)
    p, sws, hist_cap = bparams, win.sws, win.hist_cap

    def run(params, sems, noises, sem_hists=None, coarse_hists=None):
        device = params["wpe"].device
        B = len(sems)
        n_steps = [coarse_schedule(int(s.shape[0]), p)[2] for s in sems]
        order = sorted(range(B), key=lambda b: -n_steps[b])
        steps = [n_steps[b] for b in order]  # descending
        sh = [_history(None if sem_hists is None else sem_hists[b], device)
              for b in order]
        ch = [_history(None if coarse_hists is None else coarse_hists[b],
                       device) for b in order]
        n_h = [int(h.numel()) for h in sh]
        n_ch = [int(h.numel()) for h in ch]
        width = max(n_h[i] + int(sems[b].shape[0])
                    for i, b in enumerate(order)) + CTX_SEMANTIC
        # per lane, [history | new tokens | pad...] as in the single-lane
        # program, and [coarse history | generated | overrun]
        sem_full = torch.full((B, width), p.coarse_semantic_pad_token,
                              dtype=torch.int32, device=device)
        out = torch.zeros((B, hist_cap + steps[0] + sws), dtype=torch.int32,
                          device=device)
        for i, b in enumerate(order):
            sem_full[i, :n_h[i]] = sh[i]
            sem_full[i, n_h[i]:n_h[i] + sems[b].shape[0]] = sems[b].to(
                device)
            out[i, :n_ch[i]] = ch[i]
        infer = torch.full((B, 1), p.coarse_infer_token, dtype=torch.int32,
                           device=device)
        sem_cols = torch.arange(CTX_SEMANTIC, device=device)[None, :]
        hist_cols = torch.arange(hist_cap, device=device)[None, :]
        win_cols = torch.arange(sws, device=device)[None, :]
        dense, params = forward.weights(cfg, params)
        for w in range(-(-steps[0] // sws)):
            g = w * sws  # tokens generated so far, by every running lane
            Ba = sum(1 for s in steps if g < s)
            tot = [n_ch[i] + g for i in range(Ba)]
            starts = _build.device_ints(
                [[win.sem_lo(n_h[i], g), max(tot[i] - hist_cap, 0), tot[i]]
                 for i in range(Ba)], device).long()
            ctx = torch.cat([
                sem_full[:Ba].gather(1, starts[:, :1] + sem_cols),
                infer[:Ba],
                out[:Ba].gather(1, starts[:, 1:2] + hist_cols),
            ], dim=1)[:, :ctx_size]
            noise = (None if p.temp == 0.0 else torch.stack(
                [noises[b][w] for b in order[:Ba]], dim=1))
            toks = win.run_batched(params, dense, ctx,
                                   [win.ctx_len(t) for t in tot], g, noise)
            out[:Ba].scatter_(1, starts[:, 2:] + win_cols, toks)
        offs = win.svs + torch.arange(2, dtype=torch.int32,
                                      device=device)[None, :] * win.cbs
        codes = [None] * B
        for i, b in enumerate(order):
            codes[b] = (out[i, n_ch[i]:n_ch[i] + steps[i]].reshape(-1, 2)
                        - offs)
        return codes, n_steps

    return run
