"""K9 and K10, the batched semantic chunk and coarse window, on bark-small
in bf16, dense and q4_0, at 8 and 32 lanes, beside the batched step they
loop over.

    python3 bark_tpu_torch/probes/k9k10_profile.py [--tree PATH] [--tag NAME]

Run it by path, as `prefill_profile.py`, whose `main` it shares: `--tree`
(default: the checkout this file lies in) goes first on sys.path before
anything is imported, so that one command can time the port of two
checkouts side by side (a `git archive` of an earlier commit against this
one). It needs a CUDA device, builds the tree's kernels at first use, and
takes the tree's `chip_smoke.py` helpers for its inputs.

It measures, on random bf16 weights from seed 7 (the qpacks:
`chip_smoke.py` `random_qpack`) and caches of random rows:

- K9 (`semantic_chunk_fused_batched`): one 16-step chunk of B lanes after
  the 257-row prompts (count0 3, temp 0.7); K10
  (`coarse_window_fused_batched`): one 60-step window of B lanes at
  context 887 over its LM window (step parity odd, temp 0.7); dense and
  q4_0, B 8 and 32: ms a call between CUDA events (mean of 5 and 3 after
  a warm-up call), one call's device kernels (torch.profiler; the copies
  of the input logits and the slot table aside) and its device busy time;
- the step they loop over, in the same process: K7 (K5-batched q4_0) at
  the same B, at the chunk's middle slot (268) on the full head and the
  window's (917) over the coarse LM window (mean of 20); then K9's and
  K10's µs a step over it: (call - steps x step) / steps;
- where the tree has `bdecode.decode_lane_steps` (the one-launch chunk
  and window), a stamped launch of each (mean of 3,
  `decode.loop_phases_us`): the opening sample, a step's layers, its LM
  head with the next sample's partials, the sample's barrier and fold,
  the step, on block 0 and on the slowest block.

Prints log lines on stderr and one `k9k10_profile` JSON line on stdout,
also written as k9k10_profile_<tag>.json to the output directory that
`prefill_profile.main` writes.
"""

from __future__ import annotations

import sys

try:  # imported by chip_smoke.py
    from bark_tpu_torch.probes import prefill_profile as pp
except ImportError:  # run by path: the sibling, before the tree is known
    import prefill_profile as pp

LM_WINDOW = pp.LM_WINDOW
SVS, CBS = 10000, 1024
LANES = (8, 32)
K9_CTX, K9_COUNT0, K9_STEPS = 257, 3, 16
K10_CTX, K10_STEP0, K10_STEPS = 887, 1, 60


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def chunk_and_window(cs, B, sem_cfg, sem_p, coarse_cfg, coarse_p, gen):
    """(K9 call, K10 call, their bounds, their inputs): one chunk and one
    window of B lanes on caches of random rows."""
    import torch

    from bark_tpu_torch.kernels import bsemantic as kbsem
    from bark_tpu_torch.kernels import bwindow as kbwin
    from bark_tpu_torch.ops import sampling

    dev = gen.device
    V = sem_cfg.n_out_vocab
    s_noise = sampling.gumbel((B, 32, V), gen, dev)
    s_logits = torch.randn((B, V), generator=gen, device=dev) * 2
    skc, svc = cs.filled_batched_cache(sem_cfg, B, K9_CTX + K9_COUNT0,
                                       torch.bfloat16, gen)
    c_noise = sampling.gumbel((K10_STEPS, B, CBS), gen, dev)
    c_logits = torch.randn((B, coarse_cfg.n_out_vocab), generator=gen,
                           device=dev) * 2
    ckc, cvc = cs.filled_batched_cache(coarse_cfg, B, K10_CTX,
                                       torch.bfloat16, gen)
    ctx = [K10_CTX] * B

    def k9():
        return kbsem.semantic_chunk_fused_batched(
            sem_cfg, sem_p, s_logits, skc, svc, K9_CTX, K9_COUNT0, s_noise,
            2.0, K=K9_STEPS, temp=0.7, semantic_vocab_size=SVS)

    def k10():
        return kbwin.coarse_window_fused_batched(
            coarse_cfg, coarse_p, c_logits, ckc, cvc, ctx, K10_STEP0,
            c_noise, sws=K10_STEPS, temp=0.7, semantic_vocab_size=SVS,
            codebook_size=CBS, lm_window=LM_WINDOW)

    nb, fl = cs.decode_cost(sem_cfg, sem_p, K9_CTX + K9_COUNT0,
                            steps=K9_STEPS, lanes=B)
    b9 = cs.bound((nb + K9_STEPS * B * V * 4, fl), "bfloat16")[0]
    nb, fl = cs.decode_cost(coarse_cfg, coarse_p, K10_CTX, LM_WINDOW,
                            steps=K10_STEPS, lanes=B)
    b10 = cs.bound((nb + K10_STEPS * B * CBS * 4, fl), "bfloat16")[0]
    return k9, k10, b9, b10, (skc, svc, ckc, cvc, s_logits, c_logits,
                              s_noise, c_noise, ctx)


def stamped_loop(kdec, w, B, lm_window, n_steps, run) -> dict:
    """A stamped launch's parts (mean of 3): block 0's and the slowest
    block's (`decode.loop_phases_us` on the lane plan)."""
    import torch

    plan, _ = kdec.device_lane_plan(w, B, lm_window)
    stamps = kdec.loop_stamps(plan, n_steps, "cuda")
    recs = []
    for _ in range(3):
        run(stamps)
        torch.cuda.synchronize()
        recs.append(kdec.loop_phases_us(plan, stamps, n_steps))

    def mean(xs):
        if isinstance(xs[0], dict):
            return {k: mean([x[k] for x in xs]) for k in xs[0]}
        return sum(xs) / len(xs)

    return mean(recs)


def profile(tag: str) -> dict:
    import torch

    import chip_smoke as cs
    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import bsemantic as kbsem
    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.models.presets import BARK_SMALL

    dev = torch.device("cuda")
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    sem_cfg, coarse_cfg = BARK_SMALL["semantic"], BARK_SMALL["coarse"]
    loop = hasattr(kbdec, "decode_lane_steps")
    rec = dict(tag=tag, torch=torch.__version__, cuda=torch.version.cuda,
               lane_loop=loop)
    for weights in ("dense", "q4_0"):
        if weights == "dense":
            sem_p = pp.random_params(sem_cfg, gen, dt)
            coarse_p = pp.random_params(coarse_cfg, gen, dt)
        else:
            sem_p = cs.random_qpack(sem_cfg, "q4_0", dt, gen, dev)
            coarse_p = cs.random_qpack(coarse_cfg, "q4_0", dt, gen, dev)
        rec[weights] = {}
        for B in LANES:
            k9, k10, b9, b10, held = chunk_and_window(
                cs, B, sem_cfg, sem_p, coarse_cfg, coarse_p, gen)
            skc, svc, ckc, cvc, s_logits, c_logits, s_noise, c_noise, ctx = \
                held
            toks = torch.arange(B, dtype=torch.int32, device=dev)
            s_out = torch.empty((B, sem_cfg.n_out_vocab), dtype=torch.float32,
                                device=dev)
            c_out = torch.empty((B, coarse_cfg.n_out_vocab),
                                dtype=torch.float32, device=dev)
            s_mid = _build.device_ints([K9_CTX + K9_COUNT0 + 8] * B, dev)
            c_mid = _build.device_ints([K10_CTX + 30] * B, dev)
            k7 = pp.event_ms(lambda: kbdec.decode_step_fused_batched(
                sem_cfg, sem_p, toks, skc, svc, s_mid, out=s_out), 20)
            k7c = pp.event_ms(lambda: kbdec.decode_step_fused_batched(
                coarse_cfg, coarse_p, toks, ckc, cvc, c_mid,
                lm_window=LM_WINDOW, out=c_out), 20)
            r = dict(k7_ms_268=k7, k7_coarse_ms_917=k7c)
            log(f"  {weights} B={B}: the step at 268 {k7:.4f} ms, coarse at "
                f"917 over the window {k7c:.4f} ms")
            for name, fn, n, steps, step_ms, b in (
                    ("k9", k9, 5, K9_STEPS, k7, b9),
                    ("k10", k10, 3, K10_STEPS, k7c, b10)):
                ms = pp.event_ms(fn, n)
                s = pp.device_split(fn, 1)
                kernels = sum(v["count"] for k, v in s["names"].items()
                              if not k.startswith(("Memcpy", "Memset")))
                r[name] = dict(ms=ms, bound_ms=b, device_kernels=kernels,
                               busy_us=s["busy_us"], names=s["names"],
                               us_a_step_over_step=(ms - steps * step_ms)
                               * 1e3 / steps)
                log(f"  {weights} B={B} {name.upper()} ({steps} steps): "
                    f"{ms:.4f} ms, {kernels:.0f} device kernels a call (busy "
                    f"{s['busy_us']:.1f} us), "
                    f"{r[name]['us_a_step_over_step']:+.2f} us a step over "
                    f"{steps} x the step ({steps * step_ms:.4f} ms); bound "
                    f"{b:.4f} ms")
            if loop:
                w = (_build.stage_qweights if weights == "q4_0"
                     else _build.stage_weights)
                from bark_tpu_torch.kernels import bwindow as kbwin

                for name, cfg, p, win, steps, args in (
                        ("k9", sem_cfg, sem_p, None, K9_STEPS,
                         (s_logits, skc, svc, s_noise, 0,
                          kbsem.chunk_lane_loop(sem_cfg, K9_CTX, K9_COUNT0,
                                                K9_STEPS, 0.7, SVS, 2.0,
                                                B))),
                        ("k10", coarse_cfg, coarse_p, LM_WINDOW, K10_STEPS,
                         (c_logits, ckc, cvc, c_noise, 1,
                          kbwin.window_lane_loop(ctx, K10_STEP0, K10_STEPS,
                                                 0.7, SVS, CBS)))):
                    logits, kc, vc, noise, lane_dim, (slots, sample) = args
                    tok_out = torch.empty((steps, B), dtype=torch.int32,
                                          device=dev)
                    flags = tok_out.clone() if name == "k9" else None

                    def run(st, cfg=cfg, p=p, win=win, logits=logits, kc=kc,
                            vc=vc, noise=noise, lane_dim=lane_dim,
                            slots=slots, sample=sample, tok_out=tok_out,
                            flags=flags):
                        kbdec.decode_lane_steps(
                            cfg, p, logits.clone(), kc, vc, slots, sample,
                            noise, tok_out, flags, noise_lane_dim=lane_dim,
                            lm_window=win, stamps=st)

                    ph = stamped_loop(kdec, w(cfg, p), B, win, steps, run)
                    r[name]["stamped_us"] = ph
                    log(f"  {weights} B={B} {name.upper()} stamped (us; "
                        f"block 0 / slowest block): " + ", ".join(
                            f"{k} {v:.2f}/{ph['slowest'][k]:.2f}"
                            for k, v in ph["block0"].items())
                        + f"; launch {ph['launch_us']:.1f}")
            rec[weights][f"B{B}"] = r
            del held, skc, svc, ckc, cvc, s_noise, c_noise
            torch.cuda.empty_cache()
        del sem_p, coarse_p
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    return pp.main(argv, profile=profile, name="k9k10_profile", doc=__doc__)


if __name__ == "__main__":
    sys.exit(main())
