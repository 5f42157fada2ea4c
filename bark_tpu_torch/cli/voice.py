"""`voice` CLI: inspect and create speaker presets (.npz history prompts).

The counterpart of `bark_tpu.cli.voice` over the port's `pipeline.voice`,
`models.encodec.encode_audio` and `utils.wav`. suno's history_prompt .npz
layout is the interchange format, so presets made here work with suno's
Python bark and bark_tpu, and theirs here.

Subcommands:
  info      print a preset's channel lengths/durations and validate it
  from-wav  build a preset's acoustic channels from a waveform via the
            EnCodec encoder on `--device` (default cuda; refused without a
            GPU unless --device cpu)

Creating a preset from a *generation* is `bark-tpu-torch ... --save-voice
out.npz` (cli/main.py) or BarkContext.save_voice.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bark-tpu-torch-voice",
        description="Inspect / create voice presets",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_info = sub.add_parser("info", help="describe and validate a preset")
    p_info.add_argument("preset", help="voice preset .npz")

    p_wav = sub.add_parser(
        "from-wav",
        help="encode a waveform into a preset's coarse/fine channels",
    )
    p_wav.add_argument("audio", help="input WAV (mono, 24 kHz)")
    p_wav.add_argument("-m", "--model", default="./ggml_weights.bin",
                       help="model file (provides the EnCodec encoder)")
    p_wav.add_argument("-o", "--out", required=True,
                       help="output preset .npz")
    p_wav.add_argument("--semantic-from", default=None, metavar="NPZ",
                       help="donate the semantic channel from an existing "
                       "preset (without it the preset conditions the fine "
                       "stage only — timbre-only cloning)")
    p_wav.add_argument("--device", default="cuda",
                       help="torch device of the encoder: cuda (the "
                       "default), or cpu")
    return ap


def _info(args) -> int:
    from bark_tpu_torch.params import BarkContextParams
    from bark_tpu_torch.pipeline import voice

    preset = voice.load_voice_preset(args.preset)
    p = BarkContextParams()
    preset.validate(p)
    sem_s = preset.semantic.size / p.semantic_rate_hz
    frames = preset.fine.shape[1]
    print(f"{args.preset}:")
    print(f"  semantic_prompt: {preset.semantic.size} tokens "
          f"(~{sem_s:.2f} s @ {p.semantic_rate_hz} Hz)"
          + ("  [empty: no semantic/coarse conditioning]"
             if preset.semantic.size == 0 else ""))
    print(f"  coarse_prompt:   {preset.coarse.shape[0]} codebooks x "
          f"{preset.coarse.shape[1]} frames "
          f"(~{preset.coarse.shape[1] / p.coarse_rate_hz:.2f} s @ "
          f"{p.coarse_rate_hz} Hz)")
    print(f"  fine_prompt:     {preset.fine.shape[0]} codebooks x "
          f"{frames} frames")
    print("  valid for the default bark token layout")
    return 0


def _from_wav(args) -> int:
    import numpy as np

    from bark_tpu_torch.cli import device_error
    from bark_tpu_torch.io import ggml, loader
    from bark_tpu_torch.params import BarkContextParams
    from bark_tpu_torch.pipeline import voice
    from bark_tpu_torch.utils.wav import read_wav

    err = device_error(args.device)
    if err:
        print(f"voice: {err}", file=sys.stderr)
        return 1
    p = BarkContextParams()
    audio, sr = read_wav(args.audio)
    if sr != p.sample_rate:
        print(f"{args.audio}: sample rate {sr} != {p.sample_rate} "
              "(resample first)", file=sys.stderr)
        return 1
    model = ggml.read_model_file(args.model)
    codec_params = loader.codec_params_from_section(model.codec, args.device)
    if "encoder" not in codec_params:
        print(f"{args.model}: no EnCodec encoder tensors in this file",
              file=sys.stderr)
        return 1
    donor = (voice.load_voice_preset(args.semantic_from)
             if args.semantic_from else None)
    preset = voice.preset_from_audio(
        codec_params, np.asarray(audio, np.float32), p, semantic_donor=donor
    )
    voice.save_voice_preset(args.out, preset)
    print(f"Wrote {args.out}: {preset.fine.shape[1]} frames"
          + (f", semantic from {args.semantic_from}"
             if args.semantic_from else ", no semantic channel"),
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "info":
        return _info(args)
    return _from_wav(args)


if __name__ == "__main__":
    sys.exit(main())
