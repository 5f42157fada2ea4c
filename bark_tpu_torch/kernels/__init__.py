"""Hand-written Hopper kernels (csrc/, built by _build) behind wrappers
that run their plain PyTorch version on CPU tensors:

- decode: K1, one decode step through all layers
- qdecode: K5, the decode step on packed-quantized weights
- prefill: K2, causal prefill into the decode caches
- semantic: K3, a chunk of semantic steps with sampling and the EOS test,
  one launch of K1's (K5's) step loop (`decode.decode_steps_fused`)
- window: K4, one coarse sliding window, one launch of the same loop
- bdecode: K7, one decode step of B lanes (each weight read once for all)
- qbdecode: K5-batched, K7's step on packed-quantized weights
- bprefill: K8, B lanes' prefills stacked into one row block
- bsemantic: K9, a chunk of semantic steps of B lanes in lockstep, one
  launch of K7's (K5-batched's) step loop (`bdecode.decode_lane_steps`)
- bwindow: K10, one coarse sliding window of B lanes, one launch of the
  same loop
- kv8: K6, the int8 KV cache's kernels inside K1, K5, K7, K5-batched
  (decode attention) and K2, K8 (row quantizer and prefill attention)

Each module keeps `launches`, the count of kernel launches through its
wrapper (never of plain-version calls); `decode` and `qdecode` also keep
`loop_launches`, their step loop's (the launches of K3 and K4), apart from
K1's and K5's own, and `bdecode` and `qbdecode` theirs (the launches of K9
and K10), apart from K7's and K5-batched's own.
"""

from __future__ import annotations

import importlib

KERNEL_MODULES = ("decode", "qdecode", "prefill", "semantic", "window",
                  "bdecode", "qbdecode", "bprefill", "bsemantic", "bwindow",
                  "kv8")


def _modules():
    return [importlib.import_module(f"{__name__}.{m}") for m in KERNEL_MODULES]


def reset_launches() -> None:
    for mod in _modules():
        mod.launches = 0
        if hasattr(mod, "loop_launches"):
            mod.loop_launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in zip(KERNEL_MODULES, _modules())}
