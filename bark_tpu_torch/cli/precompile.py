"""`precompile` CLI: warm a serving process and the kernel build cache.

A cold bark_tpu_torch process pays, before its first audio, the kernel
library's build (nvcc, from nothing; only the objects whose sources
changed once the cache holds the rest) or its load, each kernel's first
launch (PyTorch sets CUDA_MODULE_LOADING=LAZY, so a kernel loads at its
first launch), and the creation of cuBLAS's and cuDNN's handles and the
codec's per-shape cuDNN plans. The built library is keyed by its sources
and flags only (`kernels/_build.py`), not by weights, so running this
once per (machine, code version) at deploy time leaves every later
process the key lookup (hashing the sources and reading nvcc's release,
so the CUDA toolkit must be present), the load and the first launches,
which `BarkContext.warmup` takes before the first request. Per serving
configuration:

    python -m bark_tpu_torch.cli.precompile -m ggml_weights.bin
    python -m bark_tpu_torch.cli.precompile -m weights_q8.bin --packed
    python -m bark_tpu_torch.cli.precompile -m ggml_weights.bin --batch 8

It loads the model, runs `warmup` (without --batch), then one short
generate and a second one, and reports both wall times: the second is the
warm-process floor.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bark-tpu-torch-precompile",
        description="Build the kernel library and warm a process for a "
        "model + serving configuration",
    )
    ap.add_argument("-m", "--model", default="./ggml_weights.bin")
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--packed", action="store_true",
                    help="packed-quantized serving (requires a quantized "
                    "model file)")
    ap.add_argument("--kv", default="params", choices=["params", "int8"],
                    help="KV-cache dtype to warm")
    ap.add_argument("--batch", type=int, default=0,
                    help="warm the batched pipeline at this B instead")
    ap.add_argument("--prompt", default="warm up the cache",
                    help="short prompt of the warming generates")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                    "versions)")
    return ap


def _build_line(record) -> str:
    if record is None:
        return "no kernel library (the plain versions ran)"
    compiled = ", ".join(f"{n} {s:.1f}s" for n, s in
                         record["compiled"].items()) or "nothing"
    link = ("no link" if record["link_s"] is None
            else f"link {record['link_s']:.1f}s")
    return (f"kernel library {record['library']} (key lookup "
            f"{record['lookup_s']:.3f}s; compiled {compiled}; {link}; load "
            f"{record.get('load_s', 0.0):.3f}s)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from bark_tpu_torch.cli import device_error

    err = device_error(args.device)
    if err:
        print(f"precompile: {err}", file=sys.stderr)
        return 1

    import bark_tpu_torch
    from bark_tpu_torch import params as params_mod
    from bark_tpu_torch.kernels import _build

    params = params_mod.BarkContextParams(
        compute_dtype=args.dtype,
        dequantize_on_load=not args.packed,
        kv_cache_dtype=args.kv,
    )
    t0 = time.time()
    ctx = bark_tpu_torch.bark_load_model(args.model, params, seed=args.seed,
                                         device=args.device)
    print(f"model loaded in {time.time() - t0:.3f}s", flush=True)

    if args.batch <= 0:
        dt = ctx.warmup()
        print(f"warmup: {dt:.3f}s", flush=True)

    def once(label):
        t = time.time()
        if args.batch > 0:
            outs = ctx.generate_audio_batch([args.prompt] * args.batch)
            ok = all(o is not None and o.size for o in outs)
        else:
            ok = ctx.generate_audio(args.prompt)
        dt = time.time() - t
        print(f"{label}: {dt:.3f}s", flush=True)
        return ok, dt

    ok, cold = once("first generate (compiles)")
    if not ok:
        print("generate FAILED", file=sys.stderr)
        return 1
    ok, warm = once("second generate (all cached)")
    print(
        f"done: {_build_line(_build.last_build)}; the first generate took "
        f"{cold - warm:.3f}s longer than the second.",
        flush=True,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
