"""`main` CLI: text -> WAV on the PyTorch port.

The counterpart of `bark_tpu.cli.main` (examples/main of the reference):
the same flags (-m model, -p prompt, -t threads, -s seed, -o wav out,
-v voice, --save-voice, --temp, --fine-temp, --dtype, --long,
--no-progress, --packed), the same per-stage progress lines, statistics
and load/eval/total timing lines, plus `--device` (default `cuda`; the
tool refuses to start without a GPU unless given `--device cpu`):

    python -m bark_tpu_torch.cli.main -m ggml_weights.bin -p "hello" \
        -o out.wav
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bark-tpu-torch", description="Generate speech from text"
    )
    ap.add_argument("-m", "--model", default="./ggml_weights.bin",
                    help="path to the ggml_weights.bin model")
    ap.add_argument("-p", "--prompt", default="this is an audio generated by bark.cpp",
                    help="text to synthesize")
    ap.add_argument("-t", "--threads", type=int, default=4,
                    help="accepted for compatibility; PyTorch and the "
                    "kernels own threading")
    ap.add_argument("-s", "--seed", type=int, default=0, help="RNG seed")
    ap.add_argument("-v", "--voice", default=None,
                    help="speaker preset .npz (suno history_prompt format: "
                    "semantic_prompt/coarse_prompt/fine_prompt)")
    ap.add_argument("-o", "--outwav", default="output.wav",
                    help="output WAV path")
    ap.add_argument("--save-voice", default=None, metavar="PATH",
                    help="after generating, save this generation as a "
                    "reusable voice preset .npz (pass it back later with "
                    "-v to keep the speaker)")
    ap.add_argument("--temp", type=float, default=0.7)
    ap.add_argument("--fine-temp", type=float, default=0.5)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="GPT compute dtype")
    ap.add_argument("--long", action="store_true",
                    help="long-form mode: split the prompt into sentences "
                    "and chain generations (each sentence conditioned on "
                    "the previous one's voice); the default single-utterance "
                    "mode truncates at ~13 s like the reference")
    ap.add_argument("--no-progress", action="store_true",
                    help="disable per-stage progress output; runs the "
                    "fused pipeline with no sync between windows (fastest)")
    ap.add_argument("--packed", action="store_true",
                    help="serve quantized weights packed on the card, "
                    "decoded by the packed kernels (requires a q4/q5/q8 "
                    "model)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default), or cpu for the "
                    "kernels' plain versions")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from bark_tpu_torch.cli import device_error

    err = device_error(args.device)
    if err:
        print(f"bark-tpu-torch: {err}", file=sys.stderr)
        return 1

    from bark_tpu_torch.api import context as api
    from bark_tpu_torch.params import BarkContextParams, EncodingStep
    from bark_tpu_torch.utils.wav import write_wav

    step_names = {
        EncodingStep.SEMANTIC: "Generating semantic tokens",
        EncodingStep.COARSE: "Generating coarse tokens",
        EncodingStep.FINE: "Generating fine tokens",
    }

    def on_progress(ctx, step, percent, user_data):
        print(f"\r{step_names[step]}: {percent}%", end="", file=sys.stderr)
        if percent >= 100:
            print(file=sys.stderr)

    params = BarkContextParams(
        temp=args.temp,
        fine_temp=args.fine_temp,
        compute_dtype=args.dtype,
        progress_callback=None if args.no_progress else on_progress,
        dequantize_on_load=not args.packed,
    )

    t0 = time.perf_counter()
    try:
        ctx = api.bark_load_model(args.model, params, args.seed,
                                  device=args.device)
    except (OSError, ValueError, EOFError) as e:
        print(f"{sys.argv[0]}: failed to load model '{args.model}': {e}",
              file=sys.stderr)
        return 1

    if args.long:
        ok = ctx.generate_audio_long(args.prompt, voice=args.voice)
    else:
        ok = api.bark_generate_audio(ctx, args.prompt, args.threads,
                                     voice=args.voice)
    if not ok:
        print("Could not generate audio", file=sys.stderr)
        return 1

    audio = api.bark_get_audio_data(ctx)
    write_wav(args.outwav, audio, ctx.params.sample_rate)
    print(f"Wrote {api.bark_get_audio_data_size(ctx)} frames to "
          f"{args.outwav}", file=sys.stderr)
    if args.save_voice:
        api.bark_save_voice(ctx, args.save_voice)
        print(f"Saved voice preset to {args.save_voice}", file=sys.stderr)

    ctx.print_statistics()
    t_total = time.perf_counter() - t0
    print(f"\n    load time = {api.bark_get_load_time(ctx) / 1000.0:9.2f} ms",
          file=sys.stderr)
    print(f"    eval time = {api.bark_get_eval_time(ctx) / 1000.0:9.2f} ms",
          file=sys.stderr)
    print(f"   total time = {t_total * 1000.0:9.2f} ms", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
