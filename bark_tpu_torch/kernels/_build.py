"""Build the hand-written CUDA kernels and bind them with ctypes.

The sources in `bark_tpu_torch/csrc/` compile with nvcc into ONE shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, under `bark_tpu_torch/_build/`. Nothing here runs
at import time: the CPU tests import every module on a machine with no
nvcc.

The build cache has one object per source (`_build/obj/`), keyed by
`object_key`: a hash of the source and every `.cuh`, each normalised
(blank lines and `//` comment lines dropped, so a moved line keeps the
key), the flags and nvcc's release. A source that names `__LINE__`,
`__FILE__` or `assert(` keys on its raw bytes instead, and every source
does once a header names one. The library's key hashes the object keys
and the flags (`library_path`). Finding nvcc's release (from the
toolkit's version.json, without a subprocess where the toolkit has one)
means that even a process that finds its library cached needs the CUDA
toolkit. `build` compiles only the missing objects (one nvcc per source,
all started together) and links only a missing library; every write is
a temporary file and an `os.replace`, so processes may build at once.
`last_build` records what the last `build` of this process did, the
seconds of the key lookup among it, and `lib` adds the seconds of its
dlopen.

Every C entry launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns cudaGetLastError() of its
launches; `check` raises on anything but 0.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import tempfile
import time
import weakref
from pathlib import Path

import torch

from bark_tpu_torch.models.gpt import is_qpack

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SCALE_CODES = {torch.float32: 0, torch.float16: 2}  # packed scales and mins

_lib = None
# what the last `build` of this process did: the library's name, the
# seconds of its key lookup (hashing the sources, finding nvcc's release),
# the seconds of each object compiled ({} when the library was found
# whole), the link seconds (None without a link), and, once `lib` loaded
# it, the seconds of its dlopen and symbol registration
last_build = None


class GPTWeights(ctypes.Structure):
    """Mirror of `BarkGPTWeights` in csrc/common.cuh."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "wte", "wpe", "ln1_g", "ln1_b", "ln2_g", "ln2_b",
            "qkv_w", "qkv_b", "proj_w", "proj_b", "fc_w", "fc_b",
            "out_w", "out_b", "ln_f_g", "ln_f_b", "lm_head",
        )
    ] + [
        (name, ctypes.c_int)
        for name in (
            "n_layer", "n_head", "n_embd", "block_size", "n_in_vocab",
            "n_out_vocab", "dtype",
        )
    ]


_QPTRS = (
    "wte_q", "wte_s", "wte_m", "wpe", "ln1_g", "ln1_b", "ln2_g", "ln2_b",
    "qkv_q", "qkv_s", "qkv_m", "qkv_b", "proj_q", "proj_s", "proj_m",
    "proj_b", "fc_q", "fc_s", "fc_m", "fc_b", "out_q", "out_s", "out_m",
    "out_b", "ln_f_g", "ln_f_b", "lm_q", "lm_s", "lm_m",
)


class GPTQWeights(ctypes.Structure):
    """Mirror of `BarkGPTQWeights` in csrc/common.cuh."""

    _fields_ = [(name, ctypes.c_void_p) for name in _QPTRS] + [
        (name, ctypes.c_int)
        for name in (
            "n_layer", "n_head", "n_embd", "block_size", "n_in_vocab",
            "n_out_vocab", "v_pad", "dtype", "scale_dtype", "has_min",
        )
    ]


class BarkKV(ctypes.Structure):
    """Mirror of `BarkKV` in csrc/common.cuh (passed by value)."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("k", "v", "ks", "vs")]


class StepLoop(ctypes.Structure):
    """Mirror of `BarkStepLoop` in csrc/decode.cu (passed by pointer): the
    step loop of K3/K4, its slots, sampler and outputs."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("n_steps", "n_past0", "clamp")] + [
        ("temp", ctypes.c_float), ("noise", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in
        ("noise_ld", "noise_row0", "noise_rows", "codebook", "svs", "cbs",
         "step_idx0", "stop_token")] + [
        ("min_eos_p", ctypes.c_float)] + [
        (name, ctypes.c_void_p) for name in
        ("tok_out", "flag_out", "part", "stamps")]


class LaneLoop(ctypes.Structure):
    """Mirror of `BarkLaneLoop` in csrc/lane.cuh (passed by pointer): the
    batched step loop of K9/K10, its slot table, sampler (each lane's noise
    rows `noise_lane_ld` apart, a step's `noise_step_ld`) and outputs."""

    _fields_ = [("n_steps", ctypes.c_int), ("slots", ctypes.c_void_p),
                ("temp", ctypes.c_float), ("noise", ctypes.c_void_p),
                ("noise_lane_ld", ctypes.c_longlong),
                ("noise_step_ld", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in
        ("noise_row0", "noise_rows", "codebook", "svs", "cbs", "step_idx0",
         "stop_token")] + [
        ("min_eos_p", ctypes.c_float)] + [
        (name, ctypes.c_void_p) for name in
        ("tok_out", "flag_out", "part", "stamps")]


_P, _I = ctypes.c_void_p, ctypes.c_int
# kc, vc, ks, vs: the caches as `StageWeights.check_cache` returns them (ks
# and vs, the row scales of an int8 cache, null for a dense one)
_SIGNATURES = {
    # K6a alone, one layer's decode attention of B lanes: (dtype, qkv, kv,
    #  n_past*, B, S, D, n_head, ctx, stream)
    "bark_launch_attn_decode_batched": [_I, _P, BarkKV, _P, _I, _I, _I, _I,
                                        _P, _P],
    # K6c alone, one layer's prefill attention of B lanes on an int8 (or a
    #  dense) cache: (dtype, q, kv, B, M, max_n, n_tiles, n_tiles64, tables
    #  or null, S, D, n_head, ctx, stream)
    "bark_launch_attn_prefill": [_I, _P, BarkKV, _I, _I, _I, _I, _I, _P, _I,
                                 _I, _I, _P, _P],
    # (dtype, scale dtype or -1 for dense weights, has_min, D, S) -> the
    #  persistent step's grid (blocks), or < 0
    "bark_decode_step_blocks": [_I, _I, _I, _I, _I],
    # (weights*, tiles*[4], plan*, plan_ints, blocks, tok*, n_past, kc, vc,
    #  ks, vs, partial, cap, count*, stamps*, logits, stream)
    "bark_decode_step": [_P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _I,
                         _P, _P, _P, _P],
    # (qweights*, tiles*[5], then as bark_decode_step)
    "bark_decode_step_packed": [_P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P,
                                _P, _I, _P, _P, _P, _P],
    # K3/K4's step loop: (weights*, tiles*[4], plan*, plan_ints, blocks,
    #  loop*, kc, vc, ks, vs, partial, cap, count*, logits, stream)
    "bark_decode_steps": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                          _P, _P, _P],
    # (qweights*, tiles*[5], then as bark_decode_steps)
    "bark_decode_steps_packed": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                                 _I, _P, _P, _P],
    # (weights*, x_emb, n_valid, kc, vc, ks, vs, x, hb, q, ctx, ff, kv,
    #  maps*, plan*, partial, tickets, logits, lo, hi, stream)
    "bark_prefill": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _P, _I, _I, _P],
    # (weights*, maps*)
    "bark_prefill_weight_maps": [_P, _P],
    # (dtype, scale dtype or -1 for dense weights, has_min, D, S) -> the
    #  batched step's grid (blocks), or < 0
    "bark_decode_lanes_blocks": [_I, _I, _I, _I, _I],
    # (weights*, tiles*[5], plan*, blocks, B, tok*, n_past*, kc, vc, ks, vs,
    #  work, work_floats, cap, sync*, stamps*, logits, stream)
    "bark_decode_lanes": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                          ctypes.c_longlong, _I, _P, _P, _P, _P],
    # (qweights*, then as bark_decode_lanes)
    "bark_decode_lanes_packed": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                                 _P, ctypes.c_longlong, _I, _P, _P, _P, _P],
    # (dtype, scale dtype or -1 for dense weights, has_min, D, S) -> the
    #  batched step loop's grid (blocks), or < 0
    "bark_decode_lane_steps_blocks": [_I, _I, _I, _I, _I],
    # K9/K10's batched step loop: (weights*, tiles*[5], plan*, blocks, B,
    #  loop*, kc, vc, ks, vs, work, work_floats, cap, sync*, logits, stream)
    "bark_decode_lane_steps": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                               ctypes.c_longlong, _I, _P, _P, _P],
    # (qweights*, then as bark_decode_lane_steps)
    "bark_decode_lane_steps_packed": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                                      _P, ctypes.c_longlong, _I, _P, _P, _P],
    # (weights*, x_emb, B, M, max_n, n_tiles, n_tiles64, tables, kc, vc,
    #  ks, vs, x, hb, q, ctx, ff, kv, maps*, plan*, partial, tickets,
    #  logits, lo, hi, stream)
    "bark_prefill_batched": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _P],
    # (form, method, src, x, xbuf, N, R, G, ring, stage_rows, passes,
    #  partial, cap, tickets, n_tickets, total, out, check, stream)
    "bark_dma_probe": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                       ctypes.c_longlong, _P, _I, _P, _P, _P, _P],
    # (x, out, n, stream)
    "bark_cache_probe_double": [_P, _P, ctypes.c_longlong, _P],
    # the lowering probe P1-P9 (csrc/lowering_probe.cu, probes/lowering.py)
    # (method, x, out, scratch, blocks, n_launch, stream)
    "bark_lp_while": [_I, _P, _P, _P, _I, _I, _P],
    # (v, n, tok, out, stream)
    "bark_lp_argmax": [_P, _I, _P, _P, _P],
    # (method, v, n, tbl, rows, row_bytes, group, out, tok, stream)
    "bark_lp_row": [_I, _P, _I, _P, _I, _I, _I, _P, _P, _P],
    # (g, n_rows, width, method, out, stream)
    "bark_lp_rows_sum": [_P, _I, _I, _I, _P, _P],
    # (write, unroll, in, L, W, out, stream)
    "bark_lp_layers": [_I, _I, _P, _I, _I, _P, _P],
    # (dtype, w, L, T, R, W, ring, prefetch, blocks, scratch, partial, out,
    #  stream)
    "bark_lp_ring": [_I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # (method, src, src_ls, src_bs, dst, dst_ls, dst_bs, offs, L, B, rows,
    #  row_bytes, S, align, blocks, stages, stage_bytes, stamps, stream)
    "bark_lp_row_write": [_I, _P, ctypes.c_longlong, ctypes.c_longlong, _P,
                          ctypes.c_longlong, ctypes.c_longlong, _P, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # (method, dtype, x, w, M, NG, K, out, stream)
    "bark_lp_group_dot": [_I, _I, _P, _P, _I, _I, _I, _P, _P],
}


# A source that names one of these depends on its own line numbers or file
# name (or, in a raw string, on its comment lines), so it keys on its raw
# bytes.
_LINE_BOUND = re.compile(rb'__LINE__|__FILE__|\bassert\(|R"')


def _cu_sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _headers():
    return sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of bark_tpu_torch "
        "are built from csrc/ at first use on the GPU"
    )


@functools.cache
def _nvcc_release() -> str:
    """nvcc's release, part of every key, found once per process: the
    `cuda_nvcc` version in the toolkit's version.json beside nvcc, or the
    release line of `nvcc --version` where the toolkit has no such file;
    "" where there is no card (such a machine never builds)."""
    if not torch.cuda.is_available():
        return ""
    nvcc = _nvcc()
    manifest = Path(nvcc).resolve().parent.parent / "version.json"
    if manifest.exists():
        version = json.loads(manifest.read_text()).get("cuda_nvcc", {})
        if "version" in version:
            return f"cuda_nvcc {version['version']}"
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout
    for line in out.splitlines():
        if "release" in line:
            return line.strip()
    raise RuntimeError(f"nvcc --version names no release:\n{out}")


def normalised(text: bytes) -> bytes:
    """`text` less its blank lines and `//` comment lines: what a compile
    depends on, line numbers aside. A line that ends with a backslash, and
    the line after it, always stay (a comment or macro runs on into the
    next line)."""
    kept, spliced = [], False
    for line in text.splitlines():
        s = line.strip()
        ends = s.endswith(b"\\")
        if spliced or ends or (s and not s.startswith(b"//")):
            kept.append(line)
        spliced = ends
    return b"\n".join(kept)


def key_text(path: Path, raw: bool = False) -> bytes:
    """What a source's key hashes: its normalised text, or its raw bytes
    when `raw` (a header names a line-bound macro, which may expand in any
    source) or when it names one itself (`_LINE_BOUND`)."""
    text = path.read_bytes()
    return text if raw or _LINE_BOUND.search(text) else normalised(text)


def _hash(*parts: bytes) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(len(part).to_bytes(8, "little"))
        h.update(part)
    return h.hexdigest()[:16]


def _flags() -> bytes:
    return " ".join(NVCC_FLAGS).encode()


def object_key(src: Path) -> str:
    """The build-cache key of `src`'s object (`src` may lie outside
    csrc/; it includes csrc/'s headers): a hash of its key text, every
    header's, the flags and nvcc's release. Once a header names a
    line-bound macro, every source keys on its raw bytes."""
    headers = _headers()
    raw = any(_LINE_BOUND.search(h.read_bytes()) for h in headers)
    parts = [key_text(src, raw)]
    for h in headers:
        parts += [h.name.encode(), key_text(h, raw)]
    return _hash(*parts, _flags(), _nvcc_release().encode())


def _object_path(src: Path) -> Path:
    return BUILD_DIR / "obj" / f"{src.stem}-{object_key(src)}.o"


def library_path() -> Path:
    """The library's path, keyed by its sources' names and object keys and
    the flags."""
    parts = []
    for src in _cu_sources():
        parts += [src.name.encode(), object_key(src).encode()]
    return BUILD_DIR / f"libbark_kernels_{_hash(*parts, _flags())}.so"


def report_path() -> Path:
    """nvcc's `-Xptxas -v` report of the library (registers, shared memory
    and spills of every kernel): its objects' reports joined."""
    return library_path().with_suffix(".ptxas.txt")


def _run(cmd):
    """Run one nvcc; (seconds, its output); raise with the output if it
    fails."""
    t0 = time.perf_counter()
    p = subprocess.run(cmd, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}"
                           f"\n{p.stdout}")
    return time.perf_counter() - t0, p.stdout


def compile_object(src, obj):
    """Compile the source `src` into the object `obj` with the library's
    flags, csrc/ on the include path; (seconds, the ptxas report)."""
    return _run([_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-Xptxas", "-v",
                 "-c", "-o", str(obj), str(src)])


def link(out, objs):
    """Link the objects `objs` into the shared library `out` with the
    library's flags; its seconds."""
    return _run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out),
                 *map(str, objs)])[0]


def _write(path: Path, text: str) -> None:
    """Write `text` to `path` through a temporary file and os.replace."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def build() -> Path:
    """The keyed library, built unless it exists: the objects missing from
    the cache compile, all at once, then one link. Returns its path; sets
    `last_build`."""
    global last_build
    t0 = time.perf_counter()
    out = library_path()
    record = dict(library=out.name, lookup_s=time.perf_counter() - t0,
                  compiled={}, link_s=None)
    if not out.exists():
        objs = {src: _object_path(src) for src in _cu_sources()}
        missing = [src for src, obj in objs.items() if not obj.exists()]
        (BUILD_DIR / "obj").mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:

            def compile_missing(src):
                tmp_obj = os.path.join(tmp, src.stem + ".o")
                seconds, report = compile_object(src, tmp_obj)
                _write(objs[src].with_suffix(".ptxas.txt"),
                       f"// {src.name}\n{report}")
                os.replace(tmp_obj, objs[src])
                return seconds

            with concurrent.futures.ThreadPoolExecutor(
                    max(1, len(missing))) as ex:
                seconds = list(ex.map(compile_missing, missing))
            record["compiled"] = {s.name: t for s, t in zip(missing, seconds)}
            lib_tmp = os.path.join(tmp, "lib.so")
            record["link_s"] = link(lib_tmp, objs.values())
            _write(out.with_suffix(".ptxas.txt"), "".join(
                o.with_suffix(".ptxas.txt").read_text()
                for o in objs.values()))
            os.replace(lib_tmp, out)
    last_build = record
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (`build` on first call)."""
    global _lib
    if _lib is None:
        path = build()
        t0 = time.perf_counter()
        handle = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        last_build["load_s"] = time.perf_counter() - t0
        _lib = handle
    return _lib


def check(name: str, rc: int) -> None:
    if rc < 0:
        raise RuntimeError(f"{name}: shape or argument refused by the kernel")
    if rc > 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {rc}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------ weights


_PROJ_KN = {"qkv": (1, 3), "proj": (1, 1), "fc": (1, 4), "out": (4, 1)}


def _layout(cfg, params):
    """{struct field: (tensor or None, shape, dtype)} of everything the
    kernels read from a dense params dict or a qpack (mins only when the
    qpack has them), with the shapes and dtypes the kernels take. Packed
    blocks of 32 run along each weight's input axis: the rows of a
    projection or of the LM head tile, the columns of a wte row."""
    L, D, S = cfg.n_layer, cfg.n_embd, cfg.block_size
    dtype = params["wpe"].dtype
    want = {"wpe": ((S, D), dtype), "ln_f_g": ((D,), dtype),
            "ln_f_b": ((D,), dtype)}
    for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b"):
        want[k] = ((L, D), dtype)
    for key, (k, n) in _PROJ_KN.items():
        want[key + "_b"] = ((L, n * D), dtype)
    wte = (cfg.n_wtes, cfg.n_in_vocab, D)
    if not is_qpack(params):
        want["wte"] = (wte, dtype)
        want["lm_head"] = ((cfg.n_lm_heads, cfg.n_out_vocab, D), dtype)
        for key, (k, n) in _PROJ_KN.items():
            want[key + "_w"] = ((L, k * D, n * D), dtype)
    else:
        sdt = params["wte_s"].dtype
        v_pad = -(-cfg.n_out_vocab // D) * D
        packed = {"wte": (wte, (*wte[:2], D // 32)),
                  "lm": ((D, v_pad), (D // 32, v_pad))}
        for key, (k, n) in _PROJ_KN.items():
            packed[key] = ((L, k * D, n * D), (L, k * D // 32, n * D))
        for key, (qshape, sshape) in packed.items():
            want[key + "_q"] = (qshape, torch.int8)
            want[key + "_s"] = (sshape, sdt)
            if "wte_m" in params:
                want[key + "_m"] = (sshape, sdt)
    blocks = params["blocks"]
    return {f: (params.get(f, blocks.get(f)), shape, dt)
            for f, (shape, dt) in want.items()}


class StageWeights:
    """The C view of one stage's params dict, dense or packed: the
    `GPTWeights` or `GPTQWeights` struct of its device pointers, plus the
    scratch tensors its kernels reuse from call to call (one stream, so
    reuse is ordered). It holds its tensors weakly, and `matches` tells
    whether the dict still holds the very tensors (and storages) the
    struct points into."""

    def __init__(self, cfg, params):
        L, D, S = cfg.n_layer, cfg.n_embd, cfg.block_size
        dtype, device = params["wpe"].dtype, params["wpe"].device
        if dtype not in DTYPE_CODES:
            raise ValueError(f"kernels take float32/bfloat16 params, got "
                             f"{dtype}")
        if D % 64 or D // cfg.n_head != 64 or S > 1024:
            raise ValueError(
                f"kernels take n_embd % 64 == 0, head_dim 64 and "
                f"block_size <= 1024, got {cfg}"
            )
        self.packed = is_qpack(params)
        if self.packed:
            check_qpack_form(cfg, params)
        layout = _layout(cfg, params)
        for name, (x, shape, want) in layout.items():
            if x is None:
                raise ValueError(f"param {name} is missing")
            # the packed kernels read 4 int8 values or scales at a time
            if (tuple(x.shape) != shape or x.dtype != want
                    or x.device != device or not x.is_contiguous()
                    or (self.packed and x.data_ptr() % 16)):
                raise ValueError(
                    f"param {name}: {tuple(x.shape)} {x.dtype} on "
                    f"{x.device}, want contiguous {shape} {want} on "
                    f"{device}" + (", 16-byte aligned" if self.packed else "")
                )
        if device.type != "cuda":
            raise ValueError(f"kernels take params on a CUDA device, got "
                             f"{device}")
        self.cfg, self.dtype, self.device = cfg, dtype, device
        self._refs = {k: weakref.ref(x) for k, (x, _, _) in layout.items()}
        self._ptrs = {k: x.data_ptr() for k, (x, _, _) in layout.items()}
        dims = dict(n_layer=L, n_head=cfg.n_head, n_embd=D, block_size=S,
                    n_in_vocab=cfg.n_in_vocab, n_out_vocab=cfg.n_out_vocab,
                    dtype=DTYPE_CODES[dtype])
        if self.packed:
            self.struct = GPTQWeights(
                **self._ptrs, **dims, v_pad=layout["lm_q"][1][1],
                scale_dtype=SCALE_CODES[params["wte_s"].dtype],
                has_min=int("wte_m" in params),
            )
        else:
            self.struct = GPTWeights(**self._ptrs, **dims)
        self.ref = ctypes.addressof(self.struct)
        self._scratch = {}
        self._memo = {}

    def matches(self, cfg, params) -> bool:
        if self.cfg != cfg or self.packed != is_qpack(params):
            return False
        layout = _layout(cfg, params)
        if layout.keys() != self._refs.keys():
            return False
        for k, (x, _, _) in layout.items():
            if (x is None or x is not self._refs[k]()
                    or x.data_ptr() != self._ptrs[k]):
                return False
        return True

    def alive(self) -> bool:
        return all(r() is not None for r in self._refs.values())

    def scratch(self, name: str, *shape, dtype=None):
        """A reused scratch tensor of `shape` (params dtype unless
        `dtype`), a view of a flat buffer that grows to the largest size
        asked for under `name`; int32 scratch starts zeroed (the kernels
        leave their tickets at 0)."""
        dtype = dtype or self.dtype
        numel = math.prod(shape)
        t = self._scratch.get(name)
        if t is None or t.numel() < numel or t.dtype != dtype:
            t = (torch.zeros if dtype == torch.int32 else torch.empty)(
                (numel,), dtype=dtype, device=self.device)
            self._scratch[name] = t
        return t[:numel].view(shape)

    def memo(self, key, make):
        """make(), computed once per key and kept with these weights (the
        decode step's grid and plans)."""
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def check_cache(self, k_cache, v_cache, batch=None):
        """`check_kv` on these weights' stage, dtype and device."""
        return check_kv(self.cfg, self.dtype, self.device, k_cache, v_cache,
                        batch)


def check_qpack_form(cfg, qpack):
    """Raise ValueError for a qpack the packed kernels do not take: a
    stage with more than one LM head (no transposed (D, v_pad) tile), or
    scales neither float16 nor float32."""
    if cfg.n_lm_heads != 1 or "lm_q" not in qpack:
        raise ValueError(
            f"packed kernels take a stage with one LM head (the (D, v_pad) "
            f"tile), got n_lm_heads {cfg.n_lm_heads}")
    if qpack["wte_s"].dtype not in SCALE_CODES:
        raise ValueError(f"packed scales: want float16 or float32, got "
                         f"{qpack['wte_s'].dtype}")


def check_kv(cfg, dtype, device, k_cache, v_cache, batch=None):
    """Raise unless the caches are contiguous (L, S, D), or (L, batch, S,
    D) when `batch` is given, in `dtype` on `device`; or both int8 caches
    of `gpt.init_kv_cache(quant=True)`: int8 values of that shape and
    contiguous f32 row scales of its leading dims. Returns the (k, v,
    k scales, v scales) pointers the C entry points take, the scales None
    for a dense cache."""
    shape = (cfg.n_layer, cfg.block_size, cfg.n_embd)
    if batch is not None:
        shape = (cfg.n_layer, batch, *shape[1:])
    quant = isinstance(k_cache, dict)
    if isinstance(v_cache, dict) != quant:
        raise ValueError("KV cache: k and v must both be int8 or dense")
    want = [(shape, torch.int8, "q"), (shape[:-1], torch.float32, "s")] \
        if quant else [(shape, dtype, None)]
    for want_shape, want_dtype, key in want:
        for c in (k_cache, v_cache):
            t = c if key is None else c.get(key)
            if t is None or not torch.is_tensor(t):
                raise ValueError(f"int8 KV cache: {key!r} is missing")
            if (tuple(t.shape) != want_shape or t.dtype != want_dtype
                    or t.device != device or not t.is_contiguous()):
                raise ValueError(
                    f"KV cache{'' if key is None else ' ' + key}: "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}, want "
                    f"contiguous {want_shape} {want_dtype} on {device}"
                )
    if quant:
        return (k_cache["q"].data_ptr(), v_cache["q"].data_ptr(),
                k_cache["s"].data_ptr(), v_cache["s"].data_ptr())
    return k_cache.data_ptr(), v_cache.data_ptr(), None, None


_stages = {}  # id(params dict) -> its StageWeights


def _stage(cfg, params) -> StageWeights:
    w = _stages.get(id(params))
    if w is None or not w.matches(cfg, params):
        for key in [k for k, v in _stages.items() if not v.alive()]:
            del _stages[key]
        w = StageWeights(cfg, params)
        _stages[id(params)] = w
    return w


def stage_weights(cfg, params) -> StageWeights:
    """The `StageWeights` of a dense params dict, built and validated when
    the dict is first seen and again whenever a tensor in it was replaced
    (so the kernels never read weights the dict no longer holds). Entries
    whose tensors were freed are dropped when a new one is built."""
    if is_qpack(params):
        raise ValueError("stage_weights takes dense params, got a qpack")
    return _stage(cfg, params)


def stage_qweights(cfg, qpack) -> StageWeights:
    """`stage_weights` for a packed-quantized params dict (a qpack of
    io/loader.py), with the same identity and data_ptr re-validation."""
    if not is_qpack(qpack):
        raise ValueError("stage_qweights takes a qpack, got dense params")
    return _stage(cfg, qpack)


def device_ints(values, device):
    """An int32 tensor of `values` on `device`, uploaded from pinned host
    memory without waiting for the stream: the kernels read it in stream
    order, so the host never stalls on the device for a slot table."""
    host = torch.tensor(values, dtype=torch.int32)
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def f32_on(t, device, n: int, name: str):
    """Check a float32 vector of >= n elements, contiguous on `device`."""
    if (t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous() or t.numel() < n):
        raise ValueError(
            f"{name}: want a contiguous float32 tensor of >= {n} elements "
            f"on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
        )
    return t
