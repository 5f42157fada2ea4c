"""Build the hand-written CUDA kernels and bind them with ctypes.

The sources in `bark_tpu_torch/csrc/` compile with nvcc into ONE shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds; one nvcc per source, all started together, then one link), at
first use, into `bark_tpu_torch/_build/`, keyed by a hash of the sources
and flags. Nothing here runs at import time: the CPU tests import every
module on a machine with no nvcc.

Every C entry launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns cudaGetLastError() of its
launches; `check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kc, vc, ks, vs: the caches as `StageWeights.check_cache` returns them (ks
# and vs, the row scales of an int8 cache, null for a dense one)
_SIGNATURES = {
    # one layer's decode attention of B lanes: (dtype, qkv, kv, n_past*, B,
    #  S, D, n_head, ctx, stream)
    "bark_launch_attn_decode_batched": [_I, _P, BarkKV, _P, _I, _I, _I, _I,
                                        _P, _P],
    # (weights*, tok*, n_past, kc, vc, ks, vs, x, qkv, ctx, h, partial,
    #  tickets, logits, lo, hi, stream)
    "bark_decode_step": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _P],
    # (qweights*, then as bark_decode_step)
    "bark_qdecode_step": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _I, _I, _P],
    # (weights*, x_emb, n_valid, kc, vc, ks, vs, x, hb, q, ctx, ff, kv,
    #  logits, lo, hi, stream)
    "bark_prefill": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _P],
    # (weights*, B, tok*, n_past*, kc, vc, ks, vs, x, qkv, ctx, h, partial,
    #  tickets, logits, lo, hi, stream)
    "bark_decode_step_batched": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _I, _I, _P],
    # (qweights*, then as bark_decode_step_batched)
    "bark_qdecode_step_batched": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _P, _P, _I, _I, _P],
    # (weights*, x_emb, B, M, max_n, n_tiles, tables, kc, vc, ks, vs, x, hb,
    #  q, ctx, ff, kv, logits, lo, hi, stream)
    "bark_prefill_batched": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # (logits, ld_logits, base, n, noise, ld_noise, temp, with_eos,
    #  stop_token, min_eos_p, B, tok_out, flag_out, stream)
    "bark_sample_rows": [_P, _I, _I, _I, _P, _I, _F, _I, _I, _F, _I, _P, _P,
                         _P],
    # (form, method, src, x, xbuf, N, R, G, ring, stage_rows, passes,
    #  partial, cap, tickets, n_tickets, total, out, check, stream)
    "bark_dma_probe": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                       ctypes.c_longlong, _P, _I, _P, _P, _P, _P],
}


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


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


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbark_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands at once; raise with the output of the first that
    fails. Returns their stdout + stderr, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{o}")
    return outs


def build() -> Path:
    """Compile csrc/*.cu into the keyed shared library unless it exists;
    returns its path. nvcc's `-Xptxas -v` report (registers, shared memory
    and spills of every kernel) is kept beside it (`report_path`)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objs, cmds = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            objs.append(os.path.join(tmp, src.stem + ".o"))
            cmds.append([nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-Xptxas",
                         "-v", "-c", "-o", objs[-1], str(src)])
        report = _run_all(cmds)
        lib_tmp = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs]])
        report_path().write_text("".join(report))
        os.replace(lib_tmp, out)
    return out


def report_path() -> Path:
    return library_path().with_suffix(".ptxas.txt")


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
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
        layout = _layout(cfg, params)
        L, D, S = cfg.n_layer, cfg.n_embd, cfg.block_size
        dtype, device = params["wpe"].dtype, params["wpe"].device
        if device.type != "cuda" or dtype not in DTYPE_CODES:
            raise ValueError(
                f"kernels take float32/bfloat16 params on a CUDA device, "
                f"got {dtype} on {device}"
            )
        if D % 64 or D // cfg.n_head != 64 or S > 1024:
            raise ValueError(
                f"kernels take n_embd % 64 == 0, head_dim 64 and "
                f"block_size <= 1024, got {cfg}"
            )
        self.packed = is_qpack(params)
        if self.packed and cfg.n_lm_heads != 1:
            raise ValueError(
                f"packed kernels take a stage with one LM head (the "
                f"(D, v_pad) tile), got n_lm_heads {cfg.n_lm_heads}")
        if self.packed and params["wte_s"].dtype not in SCALE_CODES:
            raise ValueError(f"packed scales: want float16 or float32, got "
                             f"{params['wte_s'].dtype}")
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

    def check_cache(self, k_cache, v_cache, batch=None):
        """Raise unless the caches are contiguous (L, S, D), or
        (L, batch, S, D) when `batch` is given, in the params dtype on the
        params' device; or both int8 caches of `gpt.init_kv_cache(quant=
        True)`: int8 values of that shape and contiguous f32 row scales of
        its leading dims. Returns the (k, v, k scales, v scales) pointers
        the C entry points take, the scales None for a dense cache."""
        cfg = self.cfg
        shape = (cfg.n_layer, cfg.block_size, cfg.n_embd)
        if batch is not None:
            shape = (cfg.n_layer, batch, *shape[1:])
        quant = isinstance(k_cache, dict)
        if isinstance(v_cache, dict) != quant:
            raise ValueError("KV cache: k and v must both be int8 or dense")
        want = [(shape, torch.int8, "q"), (shape[:-1], torch.float32, "s")] \
            if quant else [(shape, self.dtype, None)]
        for want_shape, want_dtype, key in want:
            for c in (k_cache, v_cache):
                t = c if key is None else c.get(key)
                if t is None or not torch.is_tensor(t):
                    raise ValueError(f"int8 KV cache: {key!r} is missing")
                if (tuple(t.shape) != want_shape or t.dtype != want_dtype
                        or t.device != self.device
                        or not t.is_contiguous()):
                    raise ValueError(
                        f"KV cache{'' if key is None else ' ' + key}: "
                        f"{tuple(t.shape)} {t.dtype} on {t.device}, want "
                        f"contiguous {want_shape} {want_dtype} on "
                        f"{self.device}"
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
