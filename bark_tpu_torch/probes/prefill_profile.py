"""Where a prefill's device time goes: K2 and K8 on bark-small in bf16,
split by device kernel.

    python3 bark_tpu_torch/probes/prefill_profile.py [--tree PATH] [--tag NAME]
        [--kv8]

Run it by path, not with `-m`: `--tree` (default: the checkout this file
lies in) is put first on sys.path before anything is imported, so that
one command can time the port of two checkouts side by side (a `git
archive` of an earlier commit against this one). It needs a CUDA device
and builds the tree's kernels at first use.

It measures, on random bf16 weights from seed 7:

- K2 (`prefill_fused`, the coarse stage with its LM window) at T 257,
  437, 617 and 887: ms a call between CUDA events (mean of 10), and one
  call's device kernels from torch.profiler (mean of 3 calls), summed by
  kind (GEMM, attention, LayerNorm, embed, LM head, int8 K/V quantize)
  and by kernel name, with the call's span from its first kernel's start
  to its last kernel's end and the gaps in it (span - busy);
- K8 (`prefill_fused_batched`) over 8 lanes of 257-887 rows (steps of
  90) and over 8 x 887 rows, the same way;
- the 8 prefills of one smoke request (the semantic prompt of 257 rows,
  then the coarse windows' re-primes of 257 + min(60 w, 630) rows, w =
  0..6, `pipeline/coarse.py`): their summed device time and event ms;
- the yardstick: `torch.matmul` on the same four bf16 products of each of
  the 12 layers (qkv, proj, fc, out) at each T and at M 8 x 887, ms
  between CUDA events and the 48 kernels' device time (torch.profiler;
  the port never calls it);
- where the tree has `kernels.prefill.gemm_plan`, each GEMM's plan
  (N tile, K splits, tiles) at M 257, 617 and 887.

With `--kv8` the caches are int8 (`gpt.init_kv_cache(quant=True)`, K6):
K2, K8 and the request's prefills as above, where the kinds split K6b
(`kv_quant`, the row quantizer) and K6c (`attention`) out of each call;
no yardstick and no plans.

Prints log lines on stderr and one `prefill_profile` JSON line on stdout,
also written to chiprun_out/prefill_profile_<tag>.json.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

KINDS = (("gemm", "gemm"), ("attn_prefill", "attention"),
         ("ln_rows", "layernorm"), ("embed_rows", "embed"),
         ("lm_head", "lm_head"), ("quant_rows", "kv_quant"))
K2_T = (257, 437, 617, 887)
K8_LANES = {"8 lanes 257-887": [257 + 90 * i for i in range(8)],
            "8 x 887": [887] * 8}
REQUEST_T = [257 + min(60 * w, 630) for w in range(7)]  # coarse re-primes
LM_WINDOW = (10000, 10000 + 2 * 1024)  # the coarse stage's two codebooks


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def kind(name: str) -> str:
    if name.startswith(("Memset", "Memcpy")):
        return "memset"
    for pattern, k in KINDS:
        if pattern in name:
            return k
    return "other"


def event_ms(fn, n: int = 10) -> float:
    """Mean device ms of fn() over n calls between CUDA events, after one
    warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profiled_call(fn, wait_s: float = 30.0) -> list:
    """The device events of one torch.profiler session around one
    synchronised call of fn, in start order. With torch 2.11 on an H100 a
    session now and then records no device activity for a call that did
    launch, and such sessions come in runs (`chip_smoke.py` once saw 12
    in a row; `probes/profiler_sessions.py` counts them). An empty session
    is run again after a pause that doubles from 10 ms (at most 2 s),
    until `wait_s` seconds have passed; then it raises."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    pause, end = 0.01, time.monotonic() + wait_s
    while True:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        call = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        if call:
            return call
        if time.monotonic() + pause > end:
            raise AssertionError("torch.profiler saw no device activity "
                                 f"in {wait_s:.0f} s of sessions")
        time.sleep(pause)
        pause = min(2 * pause, 2.0)


def device_split(fn, n: int = 3, tries: int = None) -> dict:
    """One call's device kernels, from torch.profiler, a session for each
    call (`profiled_call`) after a warm-up call: the kernels a call, their
    busy µs, the call's span from its first kernel's start to its last
    kernel's end and the gaps in it, µs by kind and by kernel name (the
    mean of n sessions). A session now and then also drops some kernels of
    a call that launched them all: the calls are the same, so only the
    sessions with the most device events seen are kept (up to `tries`, by
    default 4 n, sessions are run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    calls = []
    for _ in range(tries or 4 * n):
        call = profiled_call(fn)
        most = max([len(c) for c in calls] + [len(call)])
        calls = [c for c in calls + [call] if len(c) == most]
        if len(calls) == n:
            break
    events = busy = span = 0.0
    kinds, names = {}, {}
    for call in calls:
        k = len(calls)
        events += len(call) / k
        span += (call[-1].time_range.end - call[0].time_range.start) / k
        for e in call:
            us = (e.time_range.end - e.time_range.start) / k
            busy += us
            kd = kind(e.name)
            kinds[kd] = kinds.get(kd, 0.0) + us
            short = e.name.replace("(anonymous namespace)::", "").split(
                "(")[0].replace("void ", "")
            cnt, tot = names.get(short, (0.0, 0.0))
            names[short] = (cnt + 1 / k, tot + us)
    return dict(events=events, sessions=len(calls), busy_us=busy,
                span_us=span, gaps_us=span - busy, kinds=kinds,
                names={k: dict(count=c, us=t)
                       for k, (c, t) in sorted(names.items())})


def log_split(label: str, ms: float, s: dict) -> None:
    log(f"  {label}: {ms:.3f} ms (events); {s['events']:.1f} device events, "
        f"busy {s['busy_us']:.1f} us, span {s['span_us']:.1f} us, gaps "
        f"{s['gaps_us']:.1f} us; " + ", ".join(
            f"{k} {v:.1f} us" for k, v in sorted(s["kinds"].items())))


def random_params(cfg, gen, dtype):
    import torch

    from bark_tpu_torch.models import gpt

    p = gpt.init_params(cfg, gen, dtype, gen.device)
    for k, v in p["blocks"].items():
        if k.endswith("_b") or k.endswith("_g"):
            v.add_(0.02 * torch.randn(v.shape, generator=gen,
                                      device=gen.device).to(dtype))
    return p


def matmul_ms(params, T: int, gen):
    """torch.matmul on a layer's four bf16 products (x @ qkv, ctx @ proj,
    x @ fc, h @ out) for each of the stage's layers, at T rows: (ms between
    CUDA events, the 48 kernels' device ms from torch.profiler)."""
    import torch

    b = params["blocks"]
    L, D = b["qkv_w"].shape[0], b["qkv_w"].shape[1]
    a = torch.randn((T, D), generator=gen, device=gen.device).to(
        torch.bfloat16)
    h = torch.randn((T, 4 * D), generator=gen, device=gen.device).to(
        torch.bfloat16)

    def run():
        for l in range(L):
            torch.matmul(a, b["qkv_w"][l])
            torch.matmul(a, b["proj_w"][l])
            torch.matmul(a, b["fc_w"][l])
            torch.matmul(h, b["out_w"][l])

    return event_ms(run), device_split(run)["busy_us"] / 1e3


def profile(tag: str, kv8: bool = False) -> dict:
    import torch

    from bark_tpu_torch.kernels import bprefill as kbpre
    from bark_tpu_torch.kernels import prefill as kpre
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.models.presets import BARK_SMALL

    dev = torch.device("cuda")
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    sem_cfg, coarse_cfg = BARK_SMALL["semantic"], BARK_SMALL["coarse"]
    sem_p = random_params(sem_cfg, gen, dt)
    coarse_p = random_params(coarse_cfg, gen, dt)
    rec = dict(tag=tag, torch=torch.__version__, cuda=torch.version.cuda,
               kv8=kv8, k2={}, k8={}, matmul_ms={}, matmul_device_ms={},
               plan={})
    caches = functools.partial(gpt.init_kv_cache, dtype=dt, device=dev,
                               quant=kv8)

    def x_for(cfg, p, T, B=None):
        shape = (T,) if B is None else (B, T)
        idx = torch.randint(0, cfg.n_in_vocab, shape, generator=gen,
                            device=dev)
        return p["wte"][0][idx].contiguous()

    kc, vc = caches(coarse_cfg)
    for T in K2_T:
        x = x_for(coarse_cfg, coarse_p, T)

        def run():
            kpre.prefill_fused(coarse_cfg, coarse_p, x, kc, vc, T,
                               lm_window=LM_WINDOW)

        ms = event_ms(run)
        s = device_split(run)
        rec["k2"][str(T)] = dict(ms=ms, **s)
        log_split(f"K2 T {T}", ms, s)
        if not kv8:
            rec["matmul_ms"][str(T)], rec["matmul_device_ms"][str(T)] = \
                matmul_ms(coarse_p, T, gen)
    del kc, vc
    if not kv8:
        (rec["matmul_ms"]["8 x 887"],
         rec["matmul_device_ms"]["8 x 887"]) = matmul_ms(coarse_p, 8 * 887,
                                                         gen)
    for M, ms in rec["matmul_ms"].items():
        log(f"  torch.matmul, 4 products x 12 layers at M {M}: {ms:.3f} ms "
            f"(events), {rec['matmul_device_ms'][M]:.3f} ms of device time")
    for label, lanes in K8_LANES.items():
        B = len(lanes)
        kc, vc = caches(coarse_cfg, batch=B)
        x = x_for(coarse_cfg, coarse_p, max(lanes), B)

        def run():
            kbpre.prefill_fused_batched(coarse_cfg, coarse_p, x, kc, vc,
                                        lanes, lm_window=LM_WINDOW)

        ms = event_ms(run, 5)
        s = device_split(run)
        rec["k8"][label] = dict(ms=ms, lanes=lanes, **s)
        log_split(f"K8 {label}", ms, s)
        del kc, vc
    # one smoke request's prefills: the semantic prompt, 7 coarse re-primes
    skc, svc = caches(sem_cfg)
    ckc, cvc = caches(coarse_cfg)
    sx = x_for(sem_cfg, sem_p, 257)
    cx = x_for(coarse_cfg, coarse_p, max(REQUEST_T))
    calls = [lambda: kpre.prefill_fused(sem_cfg, sem_p, sx, skc, svc, 257)]
    calls += [lambda T=T: kpre.prefill_fused(
        coarse_cfg, coarse_p, cx, ckc, cvc, T, lm_window=LM_WINDOW)
        for T in REQUEST_T]
    parts = [(event_ms(c), device_split(c)) for c in calls]
    rec["request"] = dict(
        T=[257] + REQUEST_T, ms=sum(p[0] for p in parts),
        busy_us=sum(p[1]["busy_us"] for p in parts),
        span_us=sum(p[1]["span_us"] for p in parts),
        kinds={k: sum(p[1]["kinds"].get(k, 0.0) for p in parts)
               for k in {k for p in parts for k in p[1]["kinds"]}},
        each_ms=[p[0] for p in parts])
    r = rec["request"]
    log(f"  one request's 8 prefills (T {r['T']}): {r['ms']:.3f} ms "
        f"(events), device busy {r['busy_us']:.1f} us, span "
        f"{r['span_us']:.1f} us; " + ", ".join(
            f"{k} {v:.1f} us" for k, v in sorted(r["kinds"].items())))
    plan = getattr(kpre, "gemm_plan", None)
    if plan is not None and not kv8:
        D = coarse_cfg.n_embd
        for M in (257, 617, 887):
            rec["plan"][str(M)] = {
                name: plan(M, N, K)._asdict()
                for name, N, K in (("qkv", 3 * D, D), ("proj", D, D),
                                   ("fc", 4 * D, D), ("out", D, 4 * D))}
            log(f"  GEMM plan at M {M}: " + "; ".join(
                f"{k} N tile {v['bn']} splits {v['splits']} tiles "
                f"{v['tiles']} blocks {v['blocks']}"
                for k, v in rec["plan"][str(M)].items()))
    return rec


def gemm_sass() -> dict:
    """Each instance of the bf16 GEMM (`gemm_tma_kernel<epilogue, N
    tile>`) in the built prefill object, from `cuobjdump -sass`: its SASS
    lines, its HGMMA (wgmma) and UTMALDG (TMA load) instructions, and the
    first line of each."""
    import re

    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.probes.cache import _cuobjdump

    obj = _build._object_path(_build.SRC_DIR / "prefill.cu")
    dump = subprocess.run([_cuobjdump(), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    out, key = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"gemm_tma_kernelILi(\d)ELi(\d+)E", m.group(1))
            key = f"epilogue {k.group(1)}, N tile {k.group(2)}" if k else None
            if key is not None:
                out[key] = dict(lines=0, HGMMA=0, UTMALDG=0, first={})
        elif key is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            rec = out[key]
            rec["lines"] += 1
            for op in ("HGMMA", "UTMALDG"):
                if op in line:
                    rec[op] += 1
                    rec["first"].setdefault(op, " ".join(line.split()))
    return out


def main(argv=None, profile=profile, name="prefill_profile",
         doc=__doc__, flags=()) -> int:
    """The script's body, shared with `bdecode_profile.py`: put the tree
    first on sys.path, time it with `profile(tag, **switches)` and print
    and write its record as the JSON line `name`. `flags`: (flag, help)
    pairs of on/off switches passed to `profile` by their names."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)),
                    help="checkout whose bark_tpu_torch is timed")
    ap.add_argument("--tag", default="tree")
    for flag, help_ in flags:
        ap.add_argument(flag, action="store_true", help=help_)
    args = ap.parse_args(argv)
    switches = {k: v for k, v in vars(args).items()
                if k not in ("tree", "tag")}
    tree = os.path.abspath(args.tree)
    # run by path, this file's directory leads sys.path: only the tree may
    sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p) != HERE]
    import torch

    if not torch.cuda.is_available():
        log(f"{name}: no CUDA device")
        return 1
    import bark_tpu_torch

    if not os.path.abspath(bark_tpu_torch.__file__).startswith(tree):
        log(f"{name}: imported {bark_tpu_torch.__file__}, not the tree "
            f"{tree}")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"{name} {args.tag}: {tree} on {smi}")
    rec = dict(card=smi, tree=tree, **profile(args.tag, **switches))
    out = os.path.join(os.path.dirname(os.path.dirname(HERE)), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}_{args.tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({name: rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(flags=(("--kv8", "int8 KV caches (K6b, K6c)"),)))
