"""Batched requests on bark-small end to end: `generate_audio_batch` of 8
and 32 prompts, dense bf16 and q4_0, timed as `chip_smoke.py` times its
batches.

    python3 bark_tpu_torch/probes/batch_throughput.py [--tree PATH] [--tag NAME]

Run it by path, as `prefill_profile.py`, whose `main` it shares: `--tree`
(default: the checkout this file lies in) goes first on sys.path before
anything is imported, so that one command can time the port of two
checkouts in turns (a `git archive` of an earlier commit against this one:
parent, tree, tree, parent). It needs a CUDA device, builds the tree's
kernels at first use, and runs the tree's own `chip_smoke.bark_small_batch`
(random weights from seed 0, 138 semantic steps with the EOS stop off,
PyTorch's default precision; the launch counts and plain calls checked as
in the smoke).

For each weight format, after one warm-up batch of 8 (the kernels' and the
batched steps' first use on these weights), it runs REPS batches of each
size in turn and records each one's eval seconds, audio-s per wall-s
(audio seconds over eval seconds) and its semantic, coarse, fine and codec
seconds. Prints log lines on stderr and one `batch_throughput` JSON line
on stdout, also written as batch_throughput_<tag>.json to the output
directory that `prefill_profile.main` writes.
"""

from __future__ import annotations

import sys

try:  # imported from the package
    from bark_tpu_torch.probes import prefill_profile as pp
except ImportError:  # run by path: the sibling, before the tree is known
    import prefill_profile as pp

LANES = (8, 32)
REPS = 3
KEYS = ("eval_s", "audio_s_per_wall_s", "semantic_s", "coarse_s", "fine_s",
        "codec_s")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def profile(tag: str) -> dict:
    import torch

    import chip_smoke as cs

    rec = {}
    for fmt in (None, "q4_0"):
        name = fmt or "dense"
        stages = cs.bark_small_stages(fmt)
        packed = fmt is not None
        cs.bark_small_batch(stages, 8, packed=packed)
        runs = {B: [] for B in LANES}
        for _ in range(REPS):
            for B in LANES:
                r = cs.bark_small_batch(stages, B, packed=packed)
                runs[B].append({k: r[k] for k in KEYS})
                log(f"  {tag} {name} B={B}: eval {r['eval_s']:.6f} s, "
                    f"{r['audio_s_per_wall_s']:.6f} audio-s per wall-s "
                    f"(semantic {r['semantic_s']:.6f}, coarse "
                    f"{r['coarse_s']:.6f}, fine {r['fine_s']:.6f}, codec "
                    f"{r['codec_s']:.6f})")
        rec[name] = {f"B{B}": runs[B] for B in LANES}
        del stages
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    return pp.main(argv, profile=profile, name="batch_throughput",
                   doc=__doc__)


if __name__ == "__main__":
    sys.exit(main())
