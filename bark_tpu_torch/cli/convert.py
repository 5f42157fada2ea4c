"""`convert` CLI: HF suno/bark snapshot dir -> ggml_weights.bin.

The counterpart of `bark_tpu.cli.convert` (the reference's convert.py CLI)
over the port's `io.convert`:
  python -m bark_tpu_torch.cli.convert --dir-model ./models/bark-small \
      --out-dir ./ggml_weights/ --use-f16
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bark-tpu-torch-convert")
    ap.add_argument("--dir-model", required=True,
                    help="HF snapshot dir (pytorch_model.bin, config.json, vocab.txt)")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--use-f16", action="store_true")
    args = ap.parse_args(argv)

    dir_model = Path(args.dir_model)
    if not dir_model.exists():
        print(f"convert: no such directory: {dir_model}", file=sys.stderr)
        return 1
    out_dir = Path(args.out_dir) if args.out_dir else dir_model
    out_dir.mkdir(parents=True, exist_ok=True)

    from bark_tpu_torch.io.convert import convert

    out = convert(str(dir_model), str(out_dir / "ggml_weights.bin"),
                  use_f16=args.use_f16)
    print(f"convert: wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
