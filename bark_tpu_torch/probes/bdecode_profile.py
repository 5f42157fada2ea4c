"""The batched decode step on bark-small in bf16: K7 (dense weights) and
K5-batched (a q4_0 qpack) at 1, 8 and 32 lanes, beside the one-lane K1
and K5.

    python3 bark_tpu_torch/probes/bdecode_profile.py [--tree PATH] [--tag NAME]
        [--no-batches]

Run it by path, as `prefill_profile.py`, whose `main` it shares: `--tree`
(default: the checkout this file lies in) goes first on sys.path before
anything is imported, so that one command can time the port of two
checkouts side by side (a `git archive` of an earlier commit against this
one). It needs a CUDA device, builds the tree's kernels at first use, and
takes the tree's `chip_smoke.py` helpers for its inputs and batches.

It measures, on random weights from seed 7 (the qpack: `chip_smoke.py`
`random_qpack`):

- each step's ms between CUDA events (mean of 20 after a warm-up call):
  K7, K5-batched q4_0 and K6 in K7 (the int8 cache) at B 1, 8 and 32 and
  n_past 0, 300 and 1023, and K7's coarse step over its LM window at 887
  (8 lanes); at n_past 300 and on the coarse step also one call's device
  kernels (torch.profiler);
- K1 and K5 q4_0 at n_past 300, the one-lane steps K7 at B 1 stands by;
- where the tree has `decode.device_lane_plan`, a stamped step at n_past
  300 at B 1, 8 and 32 (K7, K5-batched, K6 in K7): block 0's phases and
  every block's (`decode.step_phases_us`, `step_critical_us`, mean of 5);
- the yardstick: `torch.matmul` on the step's 48 bf16 products (4 a layer
  x 12) and its LM head at M = B, their device time (torch.profiler; the
  port never calls it);
- unless `--no-batches`, `generate_audio_batch` of 8 and 32 prompts,
  dense and q4_0 (`chip_smoke.py` `bark_small_batch`, after a first batch
  of 2 that pays first-use costs): audio-s per wall-s and the stages'
  seconds.

Prints log lines on stderr and one `bdecode_profile` JSON line on stdout,
also written to chiprun_out/bdecode_profile_<tag>.json.
"""

from __future__ import annotations

import re
import subprocess
import sys

try:  # imported by chip_smoke.py
    from bark_tpu_torch.probes import prefill_profile as pp
except ImportError:  # run by path: the sibling, before the tree is known
    import prefill_profile as pp

LANES = (1, 8, 32)
N_PAST = (0, 300, 1023)
LM_WINDOW = pp.LM_WINDOW


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def matmul_ms(params, B: int, lm, gen):
    """torch.matmul on one step's bf16 products at M = B: each layer's x @
    qkv, ctx @ proj, x @ fc, h @ out, then x @ the LM head's rows `lm`
    transposed: (ms between CUDA events, the 49 kernels' device ms)."""
    import torch

    b = params["blocks"]
    L, D = b["qkv_w"].shape[0], b["qkv_w"].shape[1]
    a = torch.randn((B, D), generator=gen, device=gen.device).to(
        torch.bfloat16)
    h = torch.randn((B, 4 * D), generator=gen, device=gen.device).to(
        torch.bfloat16)
    head_t = lm.t()

    def run():
        for l in range(L):
            torch.matmul(a, b["qkv_w"][l])
            torch.matmul(a, b["proj_w"][l])
            torch.matmul(a, b["fc_w"][l])
            torch.matmul(h, b["out_w"][l])
        torch.matmul(a, head_t)

    return pp.event_ms(run), pp.device_split(run)["busy_us"] / 1e3


def step_record(run, profiled: bool = True, n: int = 20) -> dict:
    """ms of run() between CUDA events, and when `profiled` its device
    kernels a call (torch.profiler, `prefill_profile.device_split`)."""
    rec = dict(ms=pp.event_ms(run, n))
    if profiled:
        s = pp.device_split(run, 1)
        rec.update(device_kernels=s["events"], busy_us=s["busy_us"],
                   names=sorted(s["names"]))
    return rec


def stamped(kdec, w, B, run) -> dict:
    """A stamped step's phases (mean of 5): block 0's and every block's."""
    import torch

    plan, _ = kdec.device_lane_plan(w, B, None)
    stamps = kdec.step_stamps(plan, "cuda")
    recs = []
    for _ in range(5):
        run(stamps)
        torch.cuda.synchronize()
        recs.append((kdec.step_phases_us(plan, stamps),
                     kdec.step_critical_us(plan, stamps)))

    def mean(xs):
        if isinstance(xs[0], dict):
            return {k: mean([x[k] for x in xs]) for k in xs[0]}
        return sum(xs) / len(xs)

    return dict(blocks=plan.n_blocks, barriers=plan.n_barriers,
                block0=mean([r[0] for r in recs]),
                every_block=mean([r[1] for r in recs]))


def profile(tag: str, batches: bool = True) -> dict:
    import torch

    import chip_smoke as cs
    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.models.presets import BARK_SMALL

    dev = torch.device("cuda")
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    sem_cfg, coarse_cfg = BARK_SMALL["semantic"], BARK_SMALL["coarse"]
    sem_p = pp.random_params(sem_cfg, gen, dt)
    coarse_p = pp.random_params(coarse_cfg, gen, dt)
    sem_q = cs.random_qpack(sem_cfg, "q4_0", dt, gen, dev)
    lanes = hasattr(kdec, "device_lane_plan")
    rec = dict(tag=tag, torch=torch.__version__, cuda=torch.version.cuda,
               lane_kernel=lanes, k7={}, k5b={}, k6_k7={}, one_lane={},
               matmul_ms={}, matmul_device_ms={}, phases={}, batches={})

    def log_step(label, r, bound_ms=None):
        extra = "" if bound_ms is None else f", bound {bound_ms:.4f} ms"
        if "device_kernels" in r:
            extra += (f", {r['device_kernels']:.0f} device kernels a call "
                      f"(busy {r['busy_us']:.1f} us)")
        log(f"  {label}: {r['ms']:.4f} ms{extra}")

    for B in LANES:
        toks = torch.randint(0, sem_cfg.n_in_vocab, (B,), generator=gen,
                             device=dev, dtype=torch.int32)
        kc, vc = cs.filled_batched_cache(sem_cfg, B, 1023, dt, gen)
        for n_past in N_PAST:
            slots = _build.device_ints([n_past] * B, dev)
            r = step_record(lambda: kbdec.decode_step_fused_batched(
                sem_cfg, sem_p, toks, kc, vc, slots), n_past == 300)
            r["bound_ms"] = cs.bound(cs.decode_cost(
                sem_cfg, sem_p, n_past, lanes=B), "bfloat16")[0]
            rec["k7"][f"B={B} n_past {n_past}"] = r
            log_step(f"K7 B={B} n_past {n_past}", r, r["bound_ms"])
            r = step_record(lambda: kbdec.decode_step_fused_batched(
                sem_cfg, sem_q, toks, kc, vc, slots), n_past == 300)
            r["bound_ms"] = cs.bound(cs.decode_cost(
                sem_cfg, sem_q, n_past, lanes=B), "bfloat16")[0]
            rec["k5b"][f"B={B} n_past {n_past}"] = r
            log_step(f"K5-batched q4_0 B={B} n_past {n_past}", r,
                     r["bound_ms"])
        slots = _build.device_ints([300] * B, dev)
        if lanes:
            for name, p in (("k7", sem_p), ("k5b", sem_q)):
                w = (_build.stage_qweights if p is sem_q
                     else _build.stage_weights)(sem_cfg, p)
                ph = stamped(kdec, w, B, lambda st, p=p:
                             kbdec.decode_step_fused_batched(
                                 sem_cfg, p, toks, kc, vc, slots,
                                 stamps=st))
                rec["phases"][f"{name} B={B}"] = ph
                log(f"  {name} B={B} stamped (per layer, slowest block): "
                    + ", ".join(f"{k} {v['slowest']:.2f} us" for k, v in
                                ph["every_block"].items()
                                if isinstance(v, dict))
                    + f"; step {ph['every_block']['step']:.1f} us")
        del kc, vc
        k8, v8 = cs.kv8_cache(sem_cfg, 1023, gen, batch=B)
        for n_past in N_PAST:
            slots = _build.device_ints([n_past] * B, dev)
            r = step_record(lambda: kbdec.decode_step_fused_batched(
                sem_cfg, sem_p, toks, k8, v8, slots), n_past == 300)
            r["bound_ms"] = cs.bound(cs.decode_cost(
                sem_cfg, sem_p, n_past, lanes=B, kv8=True), "bfloat16")[0]
            rec["k6_k7"][f"B={B} n_past {n_past}"] = r
            log_step(f"K6 in K7 B={B} n_past {n_past}", r, r["bound_ms"])
        if lanes:
            slots = _build.device_ints([300] * B, dev)
            rec["phases"][f"k6 B={B}"] = stamped(
                kdec, _build.stage_weights(sem_cfg, sem_p), B,
                lambda st: kbdec.decode_step_fused_batched(
                    sem_cfg, sem_p, toks, k8, v8, slots, stamps=st))
        del k8, v8
        rec["matmul_ms"][str(B)], rec["matmul_device_ms"][str(B)] = \
            matmul_ms(sem_p, B, sem_p["lm_head"][0], gen)
        log(f"  torch.matmul, the step's 48 products and LM head at M {B}: "
            f"{rec['matmul_ms'][str(B)]:.4f} ms (events), "
            f"{rec['matmul_device_ms'][str(B)]:.4f} ms of device time")
        torch.cuda.empty_cache()
    B = 8
    toks = torch.randint(0, coarse_cfg.n_in_vocab, (B,), generator=gen,
                         device=dev, dtype=torch.int32)
    kc, vc = cs.filled_batched_cache(coarse_cfg, B, 887, dt, gen)
    slots = _build.device_ints([887] * B, dev)
    r = step_record(lambda: kbdec.decode_step_fused_batched(
        coarse_cfg, coarse_p, toks, kc, vc, slots, lm_window=LM_WINDOW))
    r["bound_ms"] = cs.bound(cs.decode_cost(coarse_cfg, coarse_p, 887,
                                            LM_WINDOW, lanes=B),
                             "bfloat16")[0]
    rec["k7"]["coarse B=8 n_past 887 lm_window"] = r
    log_step("K7 coarse B=8 n_past 887, window", r, r["bound_ms"])
    del kc, vc
    kc, vc = cs.filled_cache(sem_cfg, 300, dt, gen)
    tok = torch.tensor([1234], dtype=torch.int32, device=dev)
    for name, p in (("K1", sem_p), ("K5 q4_0", sem_q)):
        r = step_record(lambda: kdec.decode_step_fused(sem_cfg, p, tok, kc,
                                                       vc, 300))
        rec["one_lane"][name] = r
        log_step(f"{name} n_past 300", r)
    del kc, vc, sem_q
    torch.cuda.empty_cache()
    if batches:
        for fmt in (None, "q4_0"):
            stages = cs.bark_small_stages(fmt)
            cs.bark_small_batch(stages, 2, packed=fmt is not None)
            for B in (8, 32):
                r = cs.bark_small_batch(stages, B, packed=fmt is not None)
                r.pop("launches")
                rec["batches"][f"{fmt or 'dense'} B={B}"] = r
                log(f"  {fmt or 'dense'} batch of {B}: eval "
                    f"{r['eval_s']:.3f} s (semantic {r['semantic_s']:.3f}, "
                    f"coarse {r['coarse_s']:.3f}, fine {r['fine_s']:.3f}), "
                    f"{r['audio_s_per_wall_s']:.3f} audio-s per wall-s")
            del stages
            torch.cuda.empty_cache()
    return rec


def lane_sass() -> dict:
    """Each instance of the batched step's kernel (`lane_step_kernel<read>`)
    in the built bdecode object, from `cuobjdump -sass`: its SASS lines and
    its HMMA (mma.sync) instructions, with the first."""
    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.probes.cache import _cuobjdump

    obj = _build._object_path(_build.SRC_DIR / "bdecode.cu")
    dump = subprocess.run([_cuobjdump(), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    out, key = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"lane_step_kernelINS_(\d+)(DenseRead|PackedRead)"
                          r"I(\w+?)E", m.group(1))
            key = f"{k.group(2)}<{k.group(3)}>" if k else None
            if key is not None:
                out[key] = dict(lines=0, HMMA=0, HGMMA=0, first=None)
        elif key is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            rec = out[key]
            rec["lines"] += 1
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    rec[op] += 1
                    if rec["first"] is None:
                        rec["first"] = " ".join(line.split())
    return out


def main(argv=None) -> int:
    return pp.main(argv, profile=lambda tag, no_batches: profile(
        tag, batches=not no_batches), name="bdecode_profile", doc=__doc__,
        flags=(("--no-batches", "leave out generate_audio_batch"),))


if __name__ == "__main__":
    sys.exit(main())
