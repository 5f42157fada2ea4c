"""K3 and K4, the semantic chunk and the coarse window, on bark-small in
bf16, dense and q4_0, beside the one-lane step they loop over.

    python3 bark_tpu_torch/probes/k3k4_profile.py [--tree PATH] [--tag NAME]

Run it by path, as `prefill_profile.py`, whose `main` it shares: `--tree`
(default: the checkout this file lies in) goes first on sys.path before
anything is imported, so that one command can time the port of two
checkouts side by side (a `git archive` of an earlier commit against this
one). It needs a CUDA device, builds the tree's kernels at first use, and
takes the tree's `chip_smoke.py` helpers for its inputs.

It measures, on random bf16 weights from seed 7 (the qpacks:
`chip_smoke.py` `random_qpack`) and caches of random rows:

- K3 (`semantic_chunk_fused`): one 16-step chunk after the 257-row
  prompt (count0 3, temp 0.7); K4 (`coarse_window_fused`): one 60-step
  window at context 887 over its LM window (step parity odd, temp 0.7);
  dense and q4_0: ms a call between CUDA events (mean of 10 and 5 after
  a warm-up call), one call's device kernels (torch.profiler; the copy of
  the input logits aside) and its device busy time;
- the step they loop over, in the same process: K1 (K5 q4_0) at n_past
  300 on the full head, and at 887 over the coarse LM window (mean of
  50); then K3's and K4's µs a step over it: (call - steps x step) /
  steps;
- where the tree has `decode.loop_stamps` (the one-launch chunk and
  window), a stamped launch of each (mean of 5, `decode.loop_phases_us`):
  the opening sample, a step's layers, its LM head with the next sample's
  partial, the sample's barrier and fold, the step, on block 0 and on the
  slowest block.

Prints log lines on stderr and one `k3k4_profile` JSON line on stdout,
also written to chiprun_out/k3k4_profile_<tag>.json.
"""

from __future__ import annotations

import sys

try:  # imported by chip_smoke.py
    from bark_tpu_torch.probes import prefill_profile as pp
except ImportError:  # run by path: the sibling, before the tree is known
    import prefill_profile as pp

LM_WINDOW = pp.LM_WINDOW
SVS, CBS = 10000, 1024
K3_CTX, K3_COUNT0, K3_STEPS = 257, 3, 16
K4_CTX, K4_STEP0, K4_STEPS = 887, 1, 60


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def chunk_and_window(cs, sem_cfg, sem_p, coarse_cfg, coarse_p, gen):
    """(K3 call, K4 call, their bounds): one chunk and one window on caches
    of random rows, as `chip_smoke.py` phase 2 times them."""
    import torch

    from bark_tpu_torch.kernels import semantic as ksem
    from bark_tpu_torch.kernels import window as kwin
    from bark_tpu_torch.ops import sampling

    dev = gen.device
    V = sem_cfg.n_out_vocab
    s_noise = sampling.gumbel((32, V), gen, dev)
    s_logits = torch.randn(V, generator=gen, device=dev) * 2
    skc, svc = cs.filled_cache(sem_cfg, K3_CTX + K3_COUNT0, torch.bfloat16,
                               gen)
    c_noise = sampling.gumbel((K4_STEPS, CBS), gen, dev)
    c_logits = torch.randn(coarse_cfg.n_out_vocab, generator=gen,
                           device=dev) * 2
    ckc, cvc = cs.filled_cache(coarse_cfg, K4_CTX, torch.bfloat16, gen)

    def k3():
        return ksem.semantic_chunk_fused(
            sem_cfg, sem_p, s_logits, skc, svc, K3_CTX, K3_COUNT0, s_noise,
            2.0, K=K3_STEPS, temp=0.7, semantic_vocab_size=SVS)

    def k4():
        return kwin.coarse_window_fused(
            coarse_cfg, coarse_p, c_logits, ckc, cvc, K4_CTX, K4_STEP0,
            c_noise, sws=K4_STEPS, temp=0.7, semantic_vocab_size=SVS,
            codebook_size=CBS, lm_window=LM_WINDOW)

    nb, fl = cs.decode_cost(sem_cfg, sem_p, K3_CTX + K3_COUNT0,
                            steps=K3_STEPS)
    b3 = cs.bound((nb + K3_STEPS * V * 4, fl), "bfloat16")[0]
    nb, fl = cs.decode_cost(coarse_cfg, coarse_p, K4_CTX, LM_WINDOW,
                            steps=K4_STEPS)
    b4 = cs.bound((nb + K4_STEPS * CBS * 4, fl), "bfloat16")[0]
    return k3, k4, b3, b4, (skc, svc, ckc, cvc, s_logits, c_logits, s_noise,
                            c_noise)


def stamped_loop(kdec, w, lm_window, n_steps, run) -> dict:
    """A stamped step-loop launch's parts (mean of 5): block 0's and the
    slowest block's (`decode.loop_phases_us`)."""
    import torch

    plan, _ = kdec.device_plan(w, lm_window)
    stamps = kdec.loop_stamps(plan, n_steps, "cuda")
    recs = []
    for _ in range(5):
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
    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.kernels import semantic as ksem
    from bark_tpu_torch.kernels import window as kwin
    from bark_tpu_torch.models.presets import BARK_SMALL

    dev = torch.device("cuda")
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    sem_cfg, coarse_cfg = BARK_SMALL["semantic"], BARK_SMALL["coarse"]
    loop = hasattr(kdec, "loop_stamps")
    rec = dict(tag=tag, torch=torch.__version__, cuda=torch.version.cuda,
               step_loop=loop)
    for weights in ("dense", "q4_0"):
        if weights == "dense":
            sem_p = pp.random_params(sem_cfg, gen, dt)
            coarse_p = pp.random_params(coarse_cfg, gen, dt)
        else:
            sem_p = cs.random_qpack(sem_cfg, "q4_0", dt, gen, dev)
            coarse_p = cs.random_qpack(coarse_cfg, "q4_0", dt, gen, dev)
        k3, k4, b3, b4, held = chunk_and_window(cs, sem_cfg, sem_p,
                                                coarse_cfg, coarse_p, gen)
        skc, svc, ckc, cvc, s_logits, c_logits, s_noise, c_noise = held
        tok = torch.tensor([1234], dtype=torch.int32, device=dev)
        s_out = torch.empty(sem_cfg.n_out_vocab, dtype=torch.float32,
                            device=dev)
        c_out = torch.empty(coarse_cfg.n_out_vocab, dtype=torch.float32,
                            device=dev)
        k1 = pp.event_ms(lambda: kdec.decode_step_fused(
            sem_cfg, sem_p, tok, skc, svc, 300, out=s_out), 50)
        k1c = pp.event_ms(lambda: kdec.decode_step_fused(
            coarse_cfg, coarse_p, tok, ckc, cvc, K4_CTX, lm_window=LM_WINDOW,
            out=c_out), 50)
        r = dict(k1_ms_300=k1, k1_coarse_ms_887=k1c)
        log(f"  {weights}: the step at n_past 300 {k1:.4f} ms, coarse at "
            f"887 over the window {k1c:.4f} ms")
        for name, fn, n, steps, step_ms, b in (
                ("k3", k3, 10, K3_STEPS, k1, b3),
                ("k4", k4, 5, K4_STEPS, k1c, b4)):
            ms = pp.event_ms(fn, n)
            s = pp.device_split(fn, 1)
            kernels = sum(v["count"] for k, v in s["names"].items()
                          if not k.startswith(("Memcpy", "Memset")))
            r[name] = dict(ms=ms, bound_ms=b, device_kernels=kernels,
                           busy_us=s["busy_us"], names=s["names"],
                           us_a_step_over_step=(ms - steps * step_ms) * 1e3
                           / steps)
            log(f"  {weights} {name.upper()} ({steps} steps): {ms:.4f} ms, "
                f"{kernels:.0f} device kernels a call (busy "
                f"{s['busy_us']:.1f} us), "
                f"{r[name]['us_a_step_over_step']:+.2f} us a step over "
                f"{steps} x the step ({steps * step_ms:.4f} ms); bound "
                f"{b:.4f} ms")
        if loop:
            w = (_build.stage_qweights if weights == "q4_0"
                 else _build.stage_weights)
            for name, cfg, p, win, steps, args in (
                    ("k3", sem_cfg, sem_p, None, K3_STEPS,
                     (s_logits, skc, svc, s_noise,
                      ksem.chunk_loop(sem_cfg, K3_CTX, K3_COUNT0, 0.7, SVS,
                                      2.0), True)),
                    ("k4", coarse_cfg, coarse_p, LM_WINDOW, K4_STEPS,
                     (c_logits, ckc, cvc, c_noise,
                      kwin.window_loop(coarse_cfg, K4_CTX, K4_STEP0, 0.7,
                                       SVS, CBS), False))):
                logits, kc, vc, noise, (n_past0, clamp, sample), eos = args
                toks, flags = torch.empty((2, steps), dtype=torch.int32,
                                          device=dev)

                def run(st, cfg=cfg, p=p, win=win, steps=steps,
                        logits=logits, kc=kc, vc=vc, noise=noise,
                        n_past0=n_past0, clamp=clamp, sample=sample,
                        eos=eos, toks=toks, flags=flags):
                    kdec.decode_steps_fused(
                        cfg, p, logits.clone(), kc, vc, n_past0, clamp,
                        steps, sample, noise, toks, flags if eos else None,
                        lm_window=win, stamps=st)

                ph = stamped_loop(kdec, w(cfg, p), win, steps, run)
                r[name]["stamped_us"] = ph
                log(f"  {weights} {name.upper()} stamped (us; block 0 / "
                    f"slowest block): " + ", ".join(
                        f"{k} {v:.2f}/{ph['slowest'][k]:.2f}"
                        for k, v in ph["block0"].items())
                    + f"; launch {ph['launch_us']:.1f}")
        rec[weights] = r
        del sem_p, coarse_p, held, skc, svc, ckc, cvc
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    return pp.main(argv, profile=profile, name="k3k4_profile", doc=__doc__)


if __name__ == "__main__":
    sys.exit(main())
