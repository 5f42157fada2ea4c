"""`quantize` CLI: file-to-file weight quantization.

The counterpart of `bark_tpu.cli.quantize` (examples/quantize/main.cpp:30-100
of the reference) over the port's `io.quantize`; usage:
  python -m bark_tpu_torch.cli.quantize model.bin model_q4.bin q4_0
"""

from __future__ import annotations

import argparse
import sys
import time

FTYPE_BY_NAME = {
    "q4_0": 2,
    "q4_1": 3,
    "q5_0": 8,
    "q5_1": 9,
    "q8_0": 7,
    # beyond the reference CLI (which only writes the five above): the
    # reference ENGINE reads k-quant files (bark.cpp:287-291), so we both
    # read and write them
    "q2_k": 10,
    "q3_k": 11,
    "q4_k": 12,
    "q5_k": 13,
    "q6_k": 14,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bark-tpu-torch-quantize")
    ap.add_argument("model_in")
    ap.add_argument("model_out")
    ap.add_argument("type", choices=sorted(FTYPE_BY_NAME))
    args = ap.parse_args(argv)

    from bark_tpu_torch.io.quantize import model_quantize

    t0 = time.perf_counter()
    try:
        model_quantize(args.model_in, args.model_out, FTYPE_BY_NAME[args.type])
    except (OSError, ValueError, EOFError) as e:
        print(f"quantize: failed: {e}", file=sys.stderr)
        return 1
    ms = (time.perf_counter() - t0) * 1000.0
    print(f"quantize time = {ms:8.2f} ms", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
