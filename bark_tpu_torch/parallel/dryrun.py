"""The multi-rank dry run: the counterpart of `__graft_entry__.
dryrun_multichip`.

    python -m bark_tpu_torch.parallel.dryrun N [--device cpu|cuda]

starts N ranks (`launch.spawn`; `--device cuda`, the default, puts one GPU
on a rank, or shares the GPUs over gloo when there are fewer than N) on a
(dp, tp) mesh by the JAX dry run's rules, dp = 2 when N is even and tp =
N // dp, and on every rank:

1. one batched prefill and one decode step (`make_batched_prefill`,
   `make_batched_decode_step`) of 2 * dp lanes on tiny random GPT
   weights (2 layers, max(4, tp) heads of 16, vocabs 64 * tp in and
   32 * tp out), tensor-parallel;
2. `shard_context` on a tiny random pipeline (two prompts through
   `generate_audio_batch`, every stage tensor-parallel, the codec whole);
3. `shard_context_dp` on the same pipeline over a dp mesh of all N ranks,
   N prompts, one lane a rank through the batched kernels (their plain
   versions on the CPU).

It prints `dryrun(N) OK` and exits 0, or exits 1 with the failing rank's
traceback. The pipeline's stages have head dim 64 (the JAX dry run's are
8), which the kernels take.
"""

from __future__ import annotations

import argparse
import sys

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world"]


def _pipeline(device, tp: int):
    """A tiny random BarkContext on `device` (the JAX dry run's token
    space and codec; head dim 64)."""
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.models.config import CodecConfig, GPTConfig

    heads = max(2, tp)
    tiny = GPTConfig(n_layer=2, n_head=heads, n_embd=heads * 64,
                     block_size=320, n_in_vocab=300, n_out_vocab=40,
                     bias=True)
    fine = GPTConfig(n_layer=2, n_head=2, n_embd=16, block_size=64,
                     n_in_vocab=9, n_out_vocab=9, n_lm_heads=7, n_wtes=8)
    codec = CodecConfig(in_channels=1, hidden_dim=16, n_filters=2,
                        kernel_size=7, residual_kernel_size=3, n_bins=8,
                        sample_rate=24000, n_q_total=8)

    def stage(cfg, seed):
        return cfg, loader.params_from_numpy(
            gpt.init_params_numpy(cfg, seed), torch.float32, device)

    return bt.BarkContext.from_parts(
        vocab_tokens=VOCAB, semantic=stage(tiny, 0), coarse=stage(tiny, 1),
        fine=stage(fine, 2), codec_cfg=codec,
        codec_params=loader.params_from_numpy(
            loader.codec_init_params_numpy(codec, 3), torch.float32, device),
        params=bt.BarkContextParams(
            temp=0.7, fine_temp=0.5, min_eos_p=2.0, n_steps_text_encoder=4,
            sliding_window_size=20, max_coarse_history=20,
            semantic_vocab_size=16, semantic_pad_token=16,
            semantic_infer_token=299, text_pad_token=290,
            text_encoding_offset=100, coarse_infer_token=35,
            coarse_semantic_pad_token=34, codebook_size=8,
            compute_dtype="float32"),
        seed=0, device=device)


def rank(device, n: int) -> dict:
    """One rank of the dry run; returns what it checked."""
    import numpy as np
    import torch

    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.models.config import GPTConfig
    from bark_tpu_torch.parallel import sharding

    dp = 2 if n % 2 == 0 and n > 1 else 1
    tp = n // dp
    mesh = sharding.make_mesh(n, dp=dp)
    heads = max(4, tp)
    cfg = GPTConfig(n_layer=2, n_head=heads, n_embd=heads * 16,
                    block_size=32, n_in_vocab=64 * tp, n_out_vocab=32 * tp,
                    bias=True)
    B, T = dp * 2, 8
    params = sharding.shard_gpt_params(mesh, cfg, loader.params_from_numpy(
        gpt.init_params_numpy(cfg, 0), torch.float32, device))
    kc, vc = sharding.init_kv_cache(cfg, mesh, B, torch.float32, device)
    prefill = sharding.make_batched_prefill(cfg, mesh)
    x_emb = torch.zeros((B, T, cfg.n_embd), device=device)
    logits, kc, vc = prefill(params, x_emb, kc, vc, [T] * B)
    step = sharding.make_batched_decode_step(cfg, mesh)
    logits, kc, vc = step(params, torch.arange(B, device=device), kc, vc, T)
    if tuple(logits.shape) != (B, cfg.n_out_vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"decode logits {tuple(logits.shape)}")

    # the whole batched pipeline, tensor-parallel over the same mesh
    ctx = sharding.shard_context(_pipeline(device, tp), mesh)
    outs = ctx.generate_audio_batch(["hello world", "world hello"])
    if len(outs) != 2 or not all(o.size and np.isfinite(o).all()
                                 for o in outs):
        raise AssertionError(f"tp batch: {[o.shape for o in outs]}")

    # kernel-preserving dp over every rank: one prompt a rank
    ctx = sharding.shard_context_dp(_pipeline(device, tp),
                                    sharding.make_dp_mesh(n))
    outs = ctx.generate_audio_batch(["hello world"] * n)
    if len(outs) != n or not all(o.size and np.isfinite(o).all()
                                 for o in outs):
        raise AssertionError(f"dp batch: {[o.shape for o in outs]}")
    return dict(mesh=mesh.shape, coord=mesh.coord,
                samples=[int(o.size) for o in outs])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="ranks (default 8)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="cuda (one GPU a rank; default) or cpu")
    args = ap.parse_args(argv)
    from bark_tpu_torch.parallel import launch

    try:
        results = launch.spawn(rank, args.n, args.device, args.n)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 1
    print(f"dryrun({args.n}) on {args.device}: mesh {results[0]['mesh']}, "
          f"dp lanes' samples {results[0]['samples']}")
    print(f"dryrun({args.n}) OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
