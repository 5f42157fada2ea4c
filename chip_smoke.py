#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bark_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --k1       # phase 1, then K1's and K5's records
    python3 chip_smoke.py --k7       # phase 1, then the batched step's record
    python3 chip_smoke.py --streaming  # phase 1, then phase 4g alone
    python3 chip_smoke.py --multigpu   # phase 1, then phase 4h alone
    python3 chip_smoke.py --fine-batch # phase 1, then phase 4i alone
    python3 chip_smoke.py --large      # phase 1, then phase 4j alone

Phases, each fatal on failure (exit code 1, and no result lines):
  1. build the CUDA kernels from bark_tpu_torch/csrc (nvcc, sm_90a, one
     process per source, each object cached under its own key) and load
     them, logging the build record (objects compiled with their seconds,
     the link, the load);
  2. compare each kernel K1-K4 with its plain PyTorch version at bark-small
     shapes, in bf16 and in f32 (TF32 off; the f32 pass at F32_LAYERS of
     bark-small's 12 layers), each error beside its tolerance; then K5
     (the packed decode step: the same persistent kernel on its packed
     weight read) the same way on random qpacks of
     five formats (q8_0, q4_0, q5_0: f16 scales; q4_1: f16 scales and
     mins; q4_k: f32 scales and mins), also on the int8 cache, and K3/K4
     over a q8_0 qpack; time each against its plain version. K3 and K4,
     one launch of K1's step loop a call and none of K1's step, also give
     in f32 the bits of K1's steps launched one by one on their tokens,
     each token the plain sampler's on its step's logits
     (`loop_steps_check`; a chunk whose slots reach the clamp, and both
     window parities among them), and in bf16 two runs the same bits.
     K1 and K5, each one cooperative launch a step, must give the same
     bits twice, run one device kernel a call (torch.profiler, bf16 and
     int8 caches),
     and are timed at n_past 0/300/1023 (and the coarse window at 887)
     beside their bounds and the 62-launch chains' 0.526 / 0.474 ms, with
     their grid, barriers and the per-phase µs of stamped steps (the
     `k1_step` JSON line; K5 on q4_0 under its `k5_q4_0`);
  2b. the prefill profile (`bark_tpu_torch/probes/prefill_profile.py`,
     run in a fresh process as 2c is): K2 in bf16 at T 257, 437, 617 and 887 (coarse, LM window) and K8 over
     8 lanes of 257-887 and 8 x 887 rows, each timed and split by device
     kernel (torch.profiler: GEMMs, attention, LayerNorms, embed, LM head,
     gaps), the device time of one request's 8 prefills, torch.matmul on
     the same 48 bf16 products (K2's and K8's `library_ms`, the GEMM
     phase's yardstick), and `cuobjdump -sass` of the bf16 GEMM, which
     must show HGMMA and UTMALDG in every instance; then the same prefills
     on int8 caches (`--kv8`, K6b and K6c split out), every bf16 call on
     the tensor-core K6c and none on the scalar int8 attention, which the
     library holds in f32 alone (`kv8_profile`; its `prefill_profile`
     JSON line). Phase 2 holds K2 and K8 (dense and int8 caches) bit-equal
     from run to run in bf16 and their cache rows past n_valid unwritten;
  2c. (run before 2b) the batched step's record (`probes/
     bdecode_profile.py --no-batches` in a fresh process, whose
     torch.profiler sees every kernel; `k7_step_record`): K7,
     K5-batched q4_0 and K6 in K7 (one persistent launch a step,
     csrc/bdecode.cu) at B 1/8/32 and n_past 0/300/1023 and K7's coarse
     step at 887 over its window, with their ms and bounds, at n_past 300
     one device kernel a call, and stamped phases (every block's:
     `decode.step_critical_us`), K1 and K5 beside them,
     `torch.matmul`'s device time on the step's products at M = B (the
     K7 rows' `library_ms`), and `cuobjdump -sass` of the kernel, whose
     bf16 instances must hold HMMA (its `k7_step` JSON line);
  2d. (run after 2b) the chunk and window record (`probes/k3k4_profile.py`
     in a fresh process, `k3k4_phase`): K3 (16 steps after 257 rows) and K4
     (60 steps at context 887, LM window), dense and q4_0, each one launch
     of K1's (K5's) step loop with the sampler inside (csrc/decode.cu
     `decode_steps_kernel`), asserted one device kernel a call
     (torch.profiler), timed beside K1's (K5's) step in the same process
     (µs a step over it) and split by stamps (its `k3k4` JSON line);
  2e. (run after 2d) the batched chunk and window record (`probes/
     k9k10_profile.py` in a fresh process, `k9k10_phase`): K9 (16 steps
     after 257 rows) and K10 (60 steps at context 887, LM window), dense
     and q4_0, at 8 and 32 lanes, each one launch of the batched step loop
     with the sampler inside (csrc/bloop.cuh `lane_steps_kernel`), asserted
     one device kernel a call with no sampler and no K7 step
     (torch.profiler), timed beside K7's (K5-batched's) step in the same
     process (µs a step over it) and split by stamps (its `k9k10` JSON
     line);
  3. check a small model end to end against the port's plain CPU run with
     the same noise (tokens exact, audio within tolerance), TF32 still off:
     dense weights given as parts, then the same model written to a
     ggml_weights.bin, quantized to q8_0 and loaded packed; then the
     options (`small_model_options_reference`): top-k/top-p requests
     (dense, the q8_0 file packed, the int8 cache) and a filtered batch,
     the stepped path, a voice request and a voiced batch, and the EnCodec
     encoder of a small codec (latent within 1e-4, codes equal);
  4. answer 3 bark_generate_audio requests on bark-small with random bf16
     weights, different prompts and seeds, at PyTorch's default precision
     settings; check the audio and that every kernel was launched by them,
     each semantic chunk and coarse window as one launch of the step loop
     and K1's own step never (so in 4b and 4d);
  4b. answer packed requests on bark-small qpacks built from a seed on the
     card (bf16 dense leaves): 2 in q4_0, then 1 each in q8_0, q4_1, q4_k
     and q5_0; check the audio, that K5 was launched by each and K1 by
     none;
  4c. answer batched requests on bark-small (`generate_audio_batch` of 1, 8
     and 32 prompts); check the audio, that K8-K10 were launched, each
     semantic chunk and coarse window as one launch of the batched step
     loop (K7's own step and the single-lane kernels never), and that no
     plain version ran (the plain references `gpt.decode_step` and
     `gpt.prefill` are counted while the batches run);
  4d. the int8 KV cache (kv_cache_dtype="int8") on bark-small: 2 dense
     requests, `generate_audio_batch` of 8 and 32 prompts, and 1 request
     on q4_0 qpacks; check that every host launch of K2-K4 and K8-K10
     ran K6 and that no plain version ran, and print the RTFs and batched
     throughput beside phases 4-4c's bf16-cache numbers;
  4e. batched requests on bark-small q4_0 qpacks (`generate_audio_batch`
     of 1, 8 and 32 prompts with the bf16 cache, 8 and 32 with the int8
     cache), then one batch of 8 each in q8_0, q4_1, q4_k and q5_0;
     check that every semantic chunk and coarse window was one launch of
     the batched step loop on the packed read, that the dense loop, K7's
     and K5-batched's own step and the single-lane K1/K5 did not launch
     and that no plain version ran, and print the throughput and RTF per
     request beside phase 4c's dense numbers;
  4f. the options of generate_audio and generate_audio_batch on
     bark-small (`options_phase`): top_k 50 / top_p 0.95 requests at temp
     0.7 (dense, on the int8 cache, on q4_0 qpacks), each sampled token
     one launch of the single step (K1, K6 in K1, K5) and no step loop;
     a filtered batch of 8, each step of its lanes one launch of K7's
     step; the stepped path with a progress callback (each stage rising
     to 100, each window one K2 and one K4 launch), bit-equal to the fused
     request with the same noise; a voice request from
     `preset_from_generation` of the first request and a batch of 8 with
     per-lane voices; `preset_from_audio` on its waveform through the
     encoder on the card and a request with that preset; a profile_dir
     request in a fresh process, whose trace must hold the request's
     device kernels. Every sampled step's logits and noise must lie on
     the card, and no plain version may run; the times print beside the
     card's name and power limit (the `options` entry of the results
     line);
  4g. streaming, long-form and the server on bark-small
     (`streaming_phase`): a `generate_audio_stream` request beside the
     fused request with the same seed (semantic and coarse tokens equal,
     one chunk a window, each window one K2 and one K4, the chunks
     joined within 1% of the peak of one decode of the final tokens;
     the time to the first chunk and to the last); `generate_audio_long`
     and `generate_audio_stream_long` of two sentences; the port's HTTP
     server in this process with `--batch 40` under 40 concurrent
     requests and one chunked stream request (one batch in groups of 32
     and 8 lanes, each chunk and window one launch of the batched loop,
     no fallback to single requests, every reply 200 with audio); the
     small model's stream in f32 on the GPU against the CPU (tokens
     equal, chunks within 1e-3); `python -m bark_tpu_torch.cli.main` in
     a subprocess on the small model's file. Its launches of K2-K4 and
     K8-K10 add to the kernel rows' (the `streaming` entry of the
     results line);
  4h. multi-GPU serving (`bark_tpu_torch.parallel`, `multigpu_phase`) on
     the one card: (a) a world of 1 on NCCL in this process, bark-small
     bf16, batches of 8: through `shard_context_dp` (K8-K10 alone, no
     plain version, every lane bit-equal to this process's unsharded
     batch under the same default noise), the same on q4_0 qpacks
     (K5-batched's read), and through `shard_context` at tp 1 (no kernel,
     no plain version; its token agreement with the kernel path), each
     timed beside phase 4c's batch of 8; (b) 2 ranks on cuda:0 over gloo
     (`launch.spawn`, `multigpu_rank`): the small model in f32 at dp 2
     and at tp 2 (dense and int8 cache) token-equal to the unsharded batch
     on the card, the tp 2 step factories' logits within 2e-5 of the
     single-device step, and bark-small bf16 at dp 2 over 8 lanes, each
     rank's 4 lanes bit-equal to an unsharded batch of those 4 at B 4;
     (c) `python -m bark_tpu_torch.parallel.dryrun 2 --device cuda` in a
     subprocess. Its K8-K10 launches add to the kernel rows' (the
     `multigpu` entry of the results line);
  4i. the batched fine stage and codec (`fine_batch_phase`) on bark-small
     bf16: dense batches of 8 and 32 and a q4_0 batch of 8, each with
     its fine forwards and codec calls counted (n_fine - n_coarse
     forwards a block of the longest lane, the first over every lane; one
     codec call a decode length: it fails if a per-lane loop is left),
     K8-K10 alone and no plain version; its fine and codec seconds beside
     the lane-by-lane stage's (quoted from PERF.md), the fine stage again
     over the same lanes (seconds, peak memory, the same codes), and in
     the dense batches each lane alone
     through the same program (the share of equal fine codes); the fine
     stage's torch.profiler split at B 1 and 32 in a fresh process
     (`probes/fine_profile.py`: products, attention, sampling, other,
     gaps, the device-busy share); with `--fine-batch` also the small
     model's f32 batch on the card against the CPU (phase 3 runs it in
     the full smoke). Its K8-K10 launches add to the kernel rows' (the
     `fine_batch` entry of the results line);
  4j. bark-large (24 layers, 16 heads, width 1024; `large_phase`), the
     port's counterpart of tools/tpu_check.py --large, on random weights
     from a seed: its kernels against their plain versions in f32 (TF32
     off) and bf16 (`large_kernel_checks`: K1 at n_past 0/300/1023 and
     the coarse step at 887, K2 at T 257/887/1024, K5 q8_0 and q4_0, K6
     in K1 and K2, K7 at B 1/8/32 (512 (head, lane) units at 32),
     K5-batched q8_0 at B 8, K6 in K7 at B 32, K8 over 8 lanes of 257-887
     and of 887 rows; in f32 K3 (16 steps, and at the clamp), K4 (60
     steps, both parities), K9 (8 x 16) and K10 (32 x 60) bit-equal to
     their own steps launched one by one, each token the plain sampler's,
     and K3 and K4 on the int8 cache token-equal to their plain versions;
     in bf16 the loops once beside their plain versions), ten of them
     timed in bf16 beside their bounds (the `kernels` line's
     "bark-large" rows); then bench.py's workload: 3 dense requests, 1 on
     the int8 cache, 1 on q8_0 qpacks and a batch of 8, each chunk and
     window one launch of its step loop and no plain version run; its
     RTFs, stage seconds, audio-s per wall-s and peak memory (the `large`
     entry of the results line);
  5. the weight-stream probe (`bark_tpu_torch.probes.dma`, D1-D5, the
     port of tools/tpu_dma_probe.py) at 256 MB a pass: D1, D2, D5 and D3
     (G 2, 4) over load method x stage size (8/16/32 KB) x ring (2/3/4,
     the ring methods), D4 for G 1, 2, 4, each timed (GB/s, share of
     3.35 TB/s, D4's us per link) and held against the plain version
     (D1-D3, D5 over one pass; D4 over the first 8 tiles, where x stays
     in bf16's normal range; these checks' launches are not counted),
     beside the yardsticks (src.sum, a cuBLAS GEMV, matmul + tanh per
     link); printed as one `dma_probe` JSON line;
  5b. cold start (`bark_tpu_torch.probes.cache`, C1-C3, the port of
     tools/tpu_cache_probe.py and tests/test_cache.py): C1 bit-equal to
     its plain version on a seeded (8, 128) and an odd n, C2 from ones
     equal to 1024.0, each timed beside its plain version and x * 2.0; C3,
     C1's source shifted by 0 and 7 comment lines, must give equal SASS
     and the library's object key (a code edit another key), and the
     shifted copy, linked and loaded alone, is held and timed as C1 is;
     then the probe's programs in this process with its launch counts set
     to 0, C1 through the shifted library among them; the probe's CLI in
     a second process, which must compile nothing (`--expect-cached`); a
     copy of the package with a code edit to C1's source, which must
     rebuild that one object and link; bark-small (random bf16) in two fresh
     processes, one calling `warmup()` before its two requests and one
     not, their tokens equal; the precompile CLI on the small model's
     files (dense, q8_0 packed, --batch 8; three processes at once);
     printed as one `cache_probe`
     JSON line;
  5c. the lowering probe (`bark_tpu_torch.probes.lowering`, P1-P9, the
     port of tools/tpu_mosaic_probe.py): its CLI in this process, whose
     ten probes at the reference's shapes must all pass (10/10), then its
     sweep at bark-small sizes with the launch counts set to 0 just before
     and read just after (P1's three ways of a dependent iteration, P2/P2b
     over the semantic logits and wte, P3's noise rows by one block and by
     strips, P4/P5's layer loop unrolled or not with registers, spills and
     SASS lines, P6's weight ring on every SM beside one reduction over all
     of its bytes, P7/P8's K/V row stores by bulk, st16 and the ring (P7's
     ring also at other grids and stage sizes), P9's qkv dot by simt, wgmma
     and torch.matmul), every call on a copy of its inputs that is not in
     the L2 (`probes/_timing.py` `mean_ms`), so that a bound in bytes at
     3.35 TB/s is a floor; printed as one `lowering_probe` JSON line;
  6. print the RTFs, the batched throughput and stage times, the kernel
     table as one JSON line (every kernel that reaches `pl.pallas_call` in
     the JAX package under "kernels"; "to_port" is empty), the card's
     name and power limit, and last the contract line {"ok": true,
     "device": {...}}.

Phase 2 also checks the batched kernels K7-K10 against their plain
versions at the lane counts phase 4c gives them (K7 at B 1/3/8/32 with
n_past 0/300/1023; K8 over 3, 8 and 32 lanes with n_valid 257 to 887; K9
over 16 steps of 1, 3, 8 and 32 lanes, a chunk reaching the clamp; K10
over 60 steps of 1, 3 (both parities) and 8 lanes and 12 of 32; in f32
K9/K10 also bit-equal to K7's steps launched one by one on their tokens,
each token the plain sampler's, in bf16 two runs bit-equal), and phase
3 the small model's batched generation on the GPU against the CPU
(tokens equal). For K5-batched (K7's step on packed
weights) phase 2 holds the step against its plain version on random
qpacks of the five formats at B 1/3/8/32 (n_past 0/300/1023; full head
and coarse window), K9 (8 lanes x 16 steps) and K10 (8 and 32 lanes x 60
steps) over a q4_0 qpack in f32 (tokens and flags equal), and the q4_0 step on
int8 caches at B 8 and 32; phase 3 runs the small model's q8_0 file
packed through `generate_audio_batch`, with both caches. For K6, the
int8 KV cache, phase 2 holds each kernel that reads or writes it against
its plain version on int8 caches filled by the plain quantizer (K1 at
n_past 0/300/1023 and windowed, K5 q4_0, K7 at B 1/8/32, K2 at T 257,
437, 617 and 887, K8 over 8 and 32 lanes, K3, K4, K9, K10), logits within
TOL, the cache bytes with their count of one-step flips and the scales
(`record_kv8_rows`), K6c alone (`kv8.attn_prefill`, one layer's prefill
attention on an int8 cache) at T 1 to 1024 and over 8 and 32 lanes (bf16
element by element within K6C_RTOL |plain| + K6C_ATOL), and times K1, K5, K7, K2 and K8 on int8 caches, and K6c alone at T 887 and
8 x 887 beside the bf16 cache's attention alone (the `kernels` line's
K6-in-K2 and K6-in-K8 rows, `k6c_alone`); phase 2b's int8-cache
profile must see the tensor-core K6c and no scalar int8 attention in
every bf16 call, and the library must hold the scalar one in f32 only;
phase 3 runs the small model with the int8 cache, single and batched,
tokens equal on GPU and CPU.

Phase 2 also holds D1-D5 against their plain versions for every load
method and stage size (8/16/32 KB) at small sizes, the reference's
prefetch-hazard cases (D3, D4 with G > 1 at N > ring) among them, and
P1-P9 at the reference's shapes, seeded inputs and bark-small sizes
(`lowering_kernel_checks`; data movement bit-equal, P8's rows outside
its window untouched).

Each path of phases 4, 4b, 4c, 4d, 4e, 4f, 4h, 4i, 4j, 5, 5b and 5c is
driven with the launch counts set to 0 just before it and read just
after. A kernel's bound is
the least time the card could take for the same work: the bytes it must
move (each input read once, each output written once) at 3.35 TB/s, or
its operations at the peak rate of its dtype, whichever is larger; an
int8 cache row counts its D bytes and its 4-byte scale.

Long outputs (nvcc's -Xptxas -v report) go to chiprun_out/. The script
exits non-zero without a GPU, and when run outside a checkout.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# max |kernel - plain| allowed, per params dtype. f32: both sides compute in
# f32 and differ only in summation order (a wrong index, mask or epilogue
# shows as O(0.1) on these ~0.5-scale logits). bf16: both round to bf16 at
# the same seven points a layer, but a different summation order can flip
# a rounding by one bf16 ulp (2^-8 relative) and flips compound over 12
# layers.
TOL = {"float32": 2e-3, "bfloat16": 1e-1}
# The int8 KV cache (K6) is held to TOL too. Kernel and plain version
# compute each fresh K/V value in another summation order, so a value next
# to a rounding boundary of its int8 grid lands one step (1/127 of its
# row's amax) apart, and later rows computed from it differ by more than an
# ulp; K6a alone, given the same fresh rows, writes bit-equal rows. One
# case is held to TOL_KV8_FIRST instead: a lane that decodes at n_past 0
# (which the stages never do: a prefill comes first), whose context is its
# own fresh V row, so one boundary value moves its f32 logits by up to
# ~2e-2 (measured at 32 lanes) where the dense path differs by an ulp.
TOL_KV8_FIRST = {"float32": 5e-2, "bfloat16": 1e-1}
# K6c alone in bf16 is held element by element to K6C_RTOL |plain| +
# K6C_ATOL, a couple of bf16 ulps of the plain version's value: its scores
# are the plain version's to the bit, and weights and context are rounded
# to bf16 at the same points, so a difference is a rounding flip. TOL's
# 1e-1 is as large as a context value of a long prefill (std ~0.05 at row
# 887 on these inputs) and would pass a wrong key scale or a lost tile.
K6C_RTOL, K6C_ATOL = 2 ** -6, 2e-3

# packed formats of K5: name -> (lowest value, highest value, scale dtype
# name, has mins), the ranges repack_to_int8 gives each format's values
QFORMATS = {
    "q8_0": (-127, 127, "float16", False),
    "q4_0": (-8, 7, "float16", False),
    "q4_1": (0, 15, "float16", True),
    "q4_k": (0, 15, "float32", True),
    "q5_0": (-16, 15, "float16", False),
}
K5 = "qdecode_step_fused"
K5B_FORMATS = ("q8_0", "q4_0", "q4_1", "q4_k", "q5_0")  # K5-batched's formats

K7 = "decode_step_fused_batched"
BATCHES = (1, 8, 32)  # phase 4c's batch sizes, and K7's timed ones

KERNELS = {  # name -> (source, TPU kernel it replaces, launch-count module)
    "decode_step_fused": ("bark_tpu_torch/csrc/decode.cu",
                          "bark_tpu/kernels/decode.py:2392", "decode"),
    "prefill_fused": ("bark_tpu_torch/csrc/prefill.cu",
                      "bark_tpu/kernels/prefill.py:683", "prefill"),
    "semantic_chunk_fused": ("bark_tpu_torch/csrc/decode.cu",
                             "bark_tpu/kernels/semantic.py:555", "semantic"),
    "coarse_window_fused": ("bark_tpu_torch/csrc/decode.cu",
                            "bark_tpu/kernels/window.py:419", "window"),
    **{f"{K5}[{fmt}]": ("bark_tpu_torch/csrc/decode.cu",
                        "bark_tpu/kernels/decode.py:1016", "qdecode")
       for fmt in QFORMATS},
    **{f"{K7}[B={b}]": ("bark_tpu_torch/csrc/bdecode.cu",
                        "bark_tpu/kernels/decode.py:2043", "bdecode")
       for b in BATCHES},
    "prefill_fused_batched": ("bark_tpu_torch/csrc/prefill.cu",
                              "bark_tpu/kernels/prefill.py:971", "bprefill"),
    "semantic_chunk_fused_batched": ("bark_tpu_torch/csrc/bloop.cuh",
                                     "bark_tpu/kernels/semantic.py:1239",
                                     "bsemantic"),
    "coarse_window_fused_batched": ("bark_tpu_torch/csrc/bloop.cuh",
                                    "bark_tpu/kernels/window.py:1117",
                                    "bwindow"),
}
# K6, the int8 KV cache, by the kernel it runs inside (K3, K4, K9 and K10
# run it through K1 and K7)
K6_K1, K6_K5 = "decode_step_fused[kv8]", "qdecode_step_fused[q4_0,kv8]"
K6_K7 = "decode_step_fused_batched[kv8]"
K6_K2, K6_K8 = "prefill_fused[kv8]", "prefill_fused_batched[kv8]"
K6_K3, K6_K4 = "semantic_chunk_fused[kv8]", "coarse_window_fused[kv8]"
K6_K9 = "semantic_chunk_fused_batched[kv8]"
K6_K10 = "coarse_window_fused_batched[kv8]"
KV8_BATCHES = (8, 32)  # phase 4d's batch sizes, and K7's timed ones at kv8
# one layer's decode attention on its own: K6a, and the dense kernel;
# one layer's prefill attention on an int8 cache on its own: K6c
K6A, ATTN = "attn_decode_i8 (K6a alone)", "attn_decode (dense, alone)"
K6C = "attn_prefill_i8 (K6c alone)"
KERNELS.update({  # K6a in K1, K5, K7; K6b + K6c in K2, K8
    K6_K1: ("bark_tpu_torch/csrc/decode.cu",
            "bark_tpu/kernels/decode.py:1603", "decode"),
    K6_K5: ("bark_tpu_torch/csrc/decode.cu",
            "bark_tpu/kernels/decode.py:1603", "qdecode"),
    **{f"{K6_K7}[B={b}]": ("bark_tpu_torch/csrc/bdecode.cu",
                           "bark_tpu/kernels/decode.py:1937", "bdecode")
       for b in KV8_BATCHES},
    K6_K2: ("bark_tpu_torch/csrc/prefill.cu",
            "bark_tpu/kernels/decode.py:1045", "prefill"),
    K6_K8: ("bark_tpu_torch/csrc/prefill.cu",
            "bark_tpu/kernels/decode.py:1045", "bprefill"),
})
# K5-batched, K7's step on packed weights: every format at B = 8 (one
# batch of 8 each in phase 4e), q4_0 also at B = 1 and 32
K5B = "qdecode_step_fused_batched"
K5B_ROWS = (("q8_0", 8), ("q4_0", 1), ("q4_0", 8), ("q4_0", 32),
            ("q4_1", 8), ("q4_k", 8), ("q5_0", 8))
KERNELS.update({
    f"{K5B}[{fmt},B={b}]": ("bark_tpu_torch/csrc/bdecode.cu",
                            "bark_tpu/kernels/decode.py:2043", "qbdecode")
    for fmt, b in K5B_ROWS})
K6_K5B = "qdecode_step_fused_batched[q4_0,kv8]"  # held in phase 2 only

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no TF32


_START = time.perf_counter()


def log(*a):
    """A line on stderr, after the seconds since the script started."""
    print(f"[{time.perf_counter() - _START:7.1f} s]", *a, file=sys.stderr,
          flush=True)


def once_ms(fn):
    """(fn()'s result, its device time in ms between CUDA events): one call,
    for a plain version already run at another size (K9's and K10's take
    2-9 s a call: timing the check's own call spares two more)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, n: int) -> float:
    """Mean device time of fn() over n calls, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and cuDNN inside; the settings found are
    restored after."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def kv_row_bytes(D: int, item: int, kv8: bool) -> int:
    """Bytes of one cache row of D values: in the params dtype, or int8
    and its f32 scale."""
    return D + 4 if kv8 else D * item


def decode_cost(cfg, params, n_past: int, lm_window=None, steps: int = 1,
                lanes: int = 1, kv8: bool = False):
    """(bytes, flops) of `steps` decode steps of `lanes` lanes, each from
    slot n_past: every weight read once for all of them (only the embedding
    rows and LM-head columns the steps use), each lane's live cache rows
    read and new ones written (int8 rows and their scales when kv8), its
    f32 logits written; 2 flops a weight and 4 a cache value per step and
    lane."""
    D, L, V = cfg.n_embd, cfg.n_layer, cfg.n_out_vocab
    lo, hi = lm_window or (0, V)
    blocks = params["blocks"]
    item = params["wpe"].element_size()
    total = sum(nbytes(t) for t in blocks.values())
    total += nbytes(params["ln_f_g"]) + nbytes(params["ln_f_b"])
    if "wte_q" in params:  # an int8 row and its scales [and mins]
        sc = sum(params[k].element_size() for k in ("wte_s", "wte_m")
                 if k in params)
        row, col = D + D // 32 * sc, D + D // 32 * sc
    else:
        row, col = D * item, D * item
    total += lanes * steps * (row + D * item) + (hi - lo) * col
    total += lanes * (2 * L * (n_past + steps) * kv_row_bytes(D, item, kv8)
                      + 4 * V)
    flops = lanes * sum(2 * L * 12 * D * D + 2 * (hi - lo) * D
                        + 4 * L * D * (n_past + j + 1) for j in range(steps))
    return total, flops


def prefill_cost(cfg, params, T, lm_window=None, kv8: bool = False):
    """(bytes, flops) of a T-row prefill, or of one lane per entry of a
    list T: the weights once, each lane's embedded rows and positions read,
    its cache rows (int8 rows and their scales when kv8) and logits
    written; the projections' and the causal attention's flops."""
    D, L, V = cfg.n_embd, cfg.n_layer, cfg.n_out_vocab
    lo, hi = lm_window or (0, V)
    item = params["wpe"].element_size()
    total = sum(nbytes(t) for t in params["blocks"].values())
    total += (hi - lo) * D * item
    flops = 0
    for t in (T if isinstance(T, (list, tuple)) else [T]):
        total += (2 * t * D * item + 2 * L * t * kv_row_bytes(D, item, kv8)
                  + 4 * V)
        flops += (2 * t * L * 12 * D * D + 2 * L * D * t * (t + 1)
                  + 2 * (hi - lo) * D)
    return total, flops


def bound(cost, dtype_name: str):
    """(bound_ms, bound_by) of a (bytes, flops) cost."""
    t_bytes = cost[0] / HBM_BYTES_PER_S * 1e3
    t_ops = cost[1] / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Checks:
    def __init__(self):
        self.errors = {}  # (kernel, dtype) -> max abs err
        self.times = {}   # kernel -> (ms, plain_ms, (bytes, flops))
        self.kv8_flips = {}  # (kernel, dtype) -> (int8 flips, values)
        self.k1_step = {}  # K1's persistent step: grid, timings, phases
        self.k5_step = {}  # K5's (q4_0), the same
        self.k6c = {}  # K6c alone, timed: rows -> ms, bound, dense beside
        self.excess = {}  # (kernel, dtype) -> max |err| / record_close limit

    def record(self, kernel, dtype_name, what, err, tol=None):
        tol = (tol or TOL)[dtype_name]
        key = (kernel, dtype_name)
        self.errors[key] = max(self.errors.get(key, 0.0), err)
        ok = err <= tol
        log(f"  {kernel:26s} {dtype_name:9s} {what:34s} max|err| "
            f"{err:.3e}  tol {tol:.0e}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} {dtype_name} {what}: {err} > {tol}")

    def record_close(self, kernel, dtype_name, what, out, ref, rtol, atol):
        """Fail unless every |out - ref| <= rtol |ref| + atol; records the
        max abs error, and the largest |out - ref| / (rtol |ref| + atol)
        (1 at the limit) under `self.excess`."""
        a, b = out.float(), ref.float()
        err, excess = max_err(a, b), float(
            ((a - b).abs() / (rtol * b.abs() + atol)).max())
        key = (kernel, dtype_name)
        self.errors[key] = max(self.errors.get(key, 0.0), err)
        self.excess[key] = max(self.excess.get(key, 0.0), excess)
        ok = excess <= 1.0
        log(f"  {kernel:26s} {dtype_name:9s} {what:34s} max|err| "
            f"{err:.3e}  {excess:.3f} of {rtol:.3g}|ref| + {atol:.0e}  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} {dtype_name} {what}: |err| "
                                 f"{excess} x ({rtol}|ref| + {atol})")


def filled_cache(cfg, rows: int, dtype, gen):
    """KV caches on the card with rows [0, rows) drawn from `gen`."""
    import torch

    from bark_tpu_torch.models import gpt

    kc, vc = gpt.init_kv_cache(cfg, dtype, gen.device)
    for c in (kc, vc):
        c[:, :rows] = torch.randn(c[:, :rows].shape, generator=gen,
                                  device=gen.device).to(dtype)
    return kc, vc


def random_stage_params(cfg, gen, dtype):
    """gpt.init_params on the card with non-zero biases and LN affines, so
    every epilogue term counts."""
    import torch

    from bark_tpu_torch.models import gpt

    p = gpt.init_params(cfg, gen, dtype, gen.device)
    for k, v in p["blocks"].items():
        if k.endswith("_b") or k.endswith("_g"):
            v.add_(0.02 * torch.randn(v.shape, generator=gen,
                                      device=gen.device).to(dtype))
    return p


# Phase 2's f32 pass (untimed: each kernel exact against its plain
# version) runs bark-small's widths at F32_LAYERS of its 12 layers: its
# plain versions' runs would keep the smoke past its time limit at full
# depth. The bf16 pass, which is timed, runs all 12, and phase 4j holds
# bark-large's 24 layers in f32.
F32_LAYERS = 4


def phase2_cfgs(dtype):
    """bark-small's semantic and coarse configs for phase 2's pass in
    `dtype`: all 12 layers in bf16, F32_LAYERS in f32."""
    import dataclasses

    import torch

    from bark_tpu_torch.models.presets import BARK_SMALL

    cfgs = BARK_SMALL["semantic"], BARK_SMALL["coarse"]
    if dtype == torch.float32:
        return tuple(dataclasses.replace(c, n_layer=F32_LAYERS) for c in cfgs)
    return cfgs


def kernel_checks(checks: Checks, dtype, timed: bool):
    """Phase 2 for one dtype: K1-K4 against their plain versions on
    bark-small shapes and random weights."""
    import torch

    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.kernels import prefill as kpre
    from bark_tpu_torch.kernels import semantic as ksem
    from bark_tpu_torch.kernels import window as kwin
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.ops import sampling

    dev = torch.device("cuda")
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    gen = torch.Generator(device=dev).manual_seed(7)
    sem_cfg, coarse_cfg = phase2_cfgs(dtype)
    svs, cbs = 10000, 1024
    lmw = (svs, svs + 2 * cbs)

    sem_p = random_stage_params(sem_cfg, gen, dtype)
    coarse_p = random_stage_params(coarse_cfg, gen, dtype)

    # K1 at n_past 0, 300, 1023 (full head) and 300 with the coarse window
    for cfg, p, n_past, win in ((sem_cfg, sem_p, 0, None),
                                (sem_cfg, sem_p, 300, None),
                                (sem_cfg, sem_p, 1023, None),
                                (coarse_cfg, coarse_p, 300, lmw)):
        kc, vc = filled_cache(cfg, n_past, dtype, gen)
        kc2, vc2 = kc.clone(), vc.clone()
        tok = 1234
        out = kdec.decode_step_fused(cfg, p, tok, kc, vc, n_past,
                                     lm_window=win)
        ref = kdec.decode_step_plain(cfg, p, torch.tensor(tok, device=dev),
                                     kc2, vc2, n_past, win)
        tag = f"n_past {n_past}" + (" lm_window" if win else "")
        checks.record("decode_step_fused", name, f"logits {tag}",
                      max_err(out, ref))
        checks.record("decode_step_fused", name, f"K/V row {tag}",
                      max(max_err(kc[:, n_past], kc2[:, n_past]),
                          max_err(vc[:, n_past], vc2[:, n_past])))
        if win is not None and float(out[: win[0]].abs().max()) != 0.0:
            raise AssertionError("logits outside lm_window are not zero")
    # the plan's fixed fold order: the same step twice gives the same bits
    kc, vc = filled_cache(sem_cfg, 300, dtype, gen)
    runs = [kdec.decode_step_fused(sem_cfg, sem_p, 1234, kc.clone(),
                                   vc.clone(), 300) for _ in range(2)]
    if not torch.equal(*runs):
        raise AssertionError(f"K1 {name}: two runs of a step differ")
    log(f"  decode_step_fused      {name:9s} two runs of a step at n_past "
        f"300: logits bit-equal")
    if timed:
        tok_t = torch.tensor([1234], dtype=torch.int32, device=dev)
        ms = cuda_ms(lambda: kdec.decode_step_fused(
            sem_cfg, sem_p, tok_t, kc, vc, 300), 50)
        plain = cuda_ms(lambda: kdec.decode_step_plain(
            sem_cfg, sem_p, tok_t, kc, vc, 300), 10)
        checks.times["decode_step_fused"] = (
            ms, plain, decode_cost(sem_cfg, sem_p, 300))
        checks.k1_step = k1_step_record(sem_cfg, sem_p, coarse_cfg,
                                        coarse_p, lmw, kc, vc, gen)

    # K2 at T = 257 (semantic prompt) and coarse re-primes of 437, 617
    # (bf16) and 887 rows (windowed); cache rows past T stay unwritten, and
    # in bf16 a second run gives the same bits
    shapes = [(sem_cfg, sem_p, 257, None)] + [
        (coarse_cfg, coarse_p, T, lmw)
        for T in ((437, 617, 887) if dtype == torch.bfloat16 else (887,))]
    for cfg, p, T, win in shapes:
        x_emb = p["wte"][0][torch.randint(0, cfg.n_in_vocab, (T,),
                                          generator=gen, device=dev)]
        kc, vc = gpt.init_kv_cache(cfg, dtype, dev)
        kc2, vc2 = gpt.init_kv_cache(cfg, dtype, dev)
        out = kpre.prefill_fused(cfg, p, x_emb, kc, vc, T, lm_window=win)
        ref = kpre.prefill_plain(cfg, p, x_emb, kc2, vc2, T, win)
        checks.record("prefill_fused", name, f"logits T {T}", max_err(out, ref))
        checks.record("prefill_fused", name, f"K/V rows T {T}",
                      max(max_err(kc[:, :T], kc2[:, :T]),
                          max_err(vc[:, :T], vc2[:, :T])))
        prefill_rows_kept(kc, vc, [T], f"K2 {name} T {T}", lanes=False)
        if dtype == torch.bfloat16:
            kc3, vc3 = gpt.init_kv_cache(cfg, dtype, dev)
            again = kpre.prefill_fused(cfg, p, x_emb, kc3, vc3, T,
                                       lm_window=win)
            same_bits(f"K2 bf16 T {T}", (out, kc, vc), (again, kc3, vc3))
    if timed:
        x_emb = coarse_p["wte"][0][:887].contiguous()
        kc, vc = gpt.init_kv_cache(coarse_cfg, dtype, dev)
        ms = cuda_ms(lambda: kpre.prefill_fused(
            coarse_cfg, coarse_p, x_emb, kc, vc, 887, lm_window=lmw), 10)
        plain = cuda_ms(lambda: kpre.prefill_plain(
            coarse_cfg, coarse_p, x_emb, kc, vc, 887, lmw), 3)
        checks.times["prefill_fused"] = (
            ms, plain, prefill_cost(coarse_cfg, coarse_p, 887, lmw))

    # K3: one 16-step chunk after the 257-row prompt, temp 0.7, and in f32
    # one whose slots reach the clamp at block_size - 1 (count0 760 after
    # 257 rows). In f32 the chunk must give the plain version's tokens and
    # flags exactly and K1's steps, one launch each on its tokens, its bits;
    # in bf16 a near-tie argmax may flip after a step, so the error is taken
    # over one step, whose token is sampled from identical logits, and two
    # runs of the chunk must give the same bits. Each call is one launch
    # of K1's step loop and none of K1's own step.
    noise = sampling.gumbel((32, sem_cfg.n_out_vocab), gen, dev)
    x_emb = sem_p["wte"][0][:257].contiguous()
    kc0, vc0 = gpt.init_kv_cache(sem_cfg, dtype, dev)
    logits0 = kpre.prefill_plain(sem_cfg, sem_p, x_emb, kc0, vc0, 257)
    cases = [(16, 3)] + ([(16, 760)] if dtype == torch.float32 else [(1, 3)])
    for K, count0 in cases:
        args = (257, count0, noise, 2.0)
        kw = dict(K=K, temp=0.7, semantic_vocab_size=svs)
        kc, vc, kc2, vc2 = kc0.clone(), vc0.clone(), kc0.clone(), vc0.clone()
        if count0 > 3:  # rows up to the chunk's first slot
            for c, c2 in ((kc, kc2), (vc, vc2)):
                c[:, 257:257 + count0] = c[:, :count0]
                c2.copy_(c)
        kc3, vc3 = kc.clone(), vc.clone()
        before = loop_counts()
        toks, flags, lg = ksem.semantic_chunk_fused(
            sem_cfg, sem_p, logits0, kc, vc, *args, **kw)
        if loop_counts(before) != (1, 0):
            raise AssertionError(f"K3 {name}: {loop_counts(before)} launches "
                                 f"of the step loop and of K1, want 1 and 0")
        rtoks, rflags, rlg = ksem.semantic_chunk_plain(
            sem_cfg, sem_p, logits0, kc2, vc2, *args, **kw)
        same = int((toks.cpu() == rtoks.cpu()).sum())
        flags_same = bool((flags.cpu() == rflags.cpu()).all())
        tag = f"K={K}" + (f" count0 {count0} (clamp)" if count0 > 3 else "")
        log(f"  semantic_chunk_fused   {name:9s} {tag}: tokens equal "
            f"{same}/{K}, flags equal {flags_same}")
        if dtype == torch.float32 or K == 1:
            if same != K or not flags_same:
                raise AssertionError(f"K3 {name} {tag}: tokens/flags differ")
            checks.record("semantic_chunk_fused", name,
                          f"logits after {K} steps" + (" (clamp)" if count0 > 3
                                                       else ""),
                          max_err(lg, rlg))
        if dtype == torch.float32:
            sample = ksem.chunk_loop(sem_cfg, 257, count0, 0.7, svs, 2.0)[2]
            loop_steps_check(
                f"K3 {name} {tag}", sem_cfg, sem_p, logits0, kc3, vc3, kc,
                vc, toks, flags, lg, [min(257 + count0 + j,
                                          sem_cfg.block_size - 1)
                                      for j in range(K)], None, sample,
                lambda j: noise[sample.noise_row(j, 32)][None])
        elif K == 16:
            k, v = kc0.clone(), vc0.clone()
            again = ksem.semantic_chunk_fused(sem_cfg, sem_p, logits0, k, v,
                                              *args, **kw)
            same_bits(f"K3 bf16 {tag}", (toks, flags, lg, kc, vc),
                      (*again, k, v))
    args = (257, 3, noise, 2.0)
    if timed:
        kw = dict(K=16, temp=0.7, semantic_vocab_size=svs)
        ms = cuda_ms(lambda: ksem.semantic_chunk_fused(
            sem_cfg, sem_p, logits0, kc0, vc0, *args, **kw), 3)
        plain = cuda_ms(lambda: ksem.semantic_chunk_plain(
            sem_cfg, sem_p, logits0, kc0, vc0, *args, **kw), 1)
        nb, fl = decode_cost(sem_cfg, sem_p, 257 + 3, steps=16)
        checks.times["semantic_chunk_fused"] = (
            ms, plain, (nb + 16 * sem_cfg.n_out_vocab * 4, fl))

    # K4: one 60-step window after an 887-row re-prime, temp 0.7, step
    # parity odd (and in f32 even too); the same exactness rules as K3, the
    # error taken on the K/V rows the window writes
    noise = sampling.gumbel((60, cbs), gen, dev)
    x_emb = coarse_p["wte"][0][:887].contiguous()
    kc0, vc0 = gpt.init_kv_cache(coarse_cfg, dtype, dev)
    logits0 = kpre.prefill_plain(coarse_cfg, coarse_p, x_emb, kc0, vc0, 887,
                                 lmw)
    for sws, step0 in (((60, 1), (60, 0)) if dtype == torch.float32
                       else ((60, 1), (1, 1))):
        kw = dict(sws=sws, temp=0.7, semantic_vocab_size=svs,
                  codebook_size=cbs, lm_window=lmw)
        kc, vc, kc2, vc2 = kc0.clone(), vc0.clone(), kc0.clone(), vc0.clone()
        kc3, vc3 = kc.clone(), vc.clone()
        before = loop_counts()
        toks = kwin.coarse_window_fused(coarse_cfg, coarse_p, logits0, kc,
                                        vc, 887, step0, noise[:sws], **kw)
        if loop_counts(before) != (1, 0):
            raise AssertionError(f"K4 {name}: not one launch of the step "
                                 f"loop and none of K1")
        rtoks = kwin.coarse_window_plain(coarse_cfg, coarse_p, logits0, kc2,
                                         vc2, 887, step0, noise[:sws], **kw)
        same = int((toks.cpu() == rtoks.cpu()).sum())
        tag = f"sws={sws} parity {'odd' if step0 else 'even'}"
        log(f"  coarse_window_fused    {name:9s} {tag}: tokens equal "
            f"{same}/{sws}")
        if dtype == torch.float32 or sws == 1:
            if same != sws:
                raise AssertionError(f"K4 {name} {tag}: tokens differ")
            rows = slice(887, 887 + sws)
            checks.record("coarse_window_fused", name,
                          f"K/V rows of a {sws}-step window",
                          max(max_err(kc[:, rows], kc2[:, rows]),
                              max_err(vc[:, rows], vc2[:, rows])))
        if dtype == torch.float32:
            sample = kwin.window_loop(coarse_cfg, 887, step0, 0.7, svs,
                                      cbs)[2]
            loop_steps_check(
                f"K4 {name} {tag}", coarse_cfg, coarse_p, logits0, kc3, vc3,
                kc, vc, toks, None, None, [887 + j for j in range(sws)], lmw,
                sample, lambda j: noise[j][None])
        elif sws == 60:
            k, v = kc0.clone(), vc0.clone()
            again = kwin.coarse_window_fused(coarse_cfg, coarse_p, logits0, k,
                                             v, 887, step0, noise, **kw)
            same_bits(f"K4 bf16 {tag}", (toks, kc, vc), (again, k, v))
    if timed:
        kw = dict(sws=60, temp=0.7, semantic_vocab_size=svs,
                  codebook_size=cbs, lm_window=lmw)
        ms = cuda_ms(lambda: kwin.coarse_window_fused(
            coarse_cfg, coarse_p, logits0, kc0, vc0, 887, 1, noise, **kw), 2)
        plain = cuda_ms(lambda: kwin.coarse_window_plain(
            coarse_cfg, coarse_p, logits0, kc0, vc0, 887, 1, noise, **kw), 1)
        nb, fl = decode_cost(coarse_cfg, coarse_p, 887, lmw, steps=60)
        checks.times["coarse_window_fused"] = (ms, plain,
                                               (nb + 60 * cbs * 4, fl))


def probe_record(script: str, *flags: str) -> dict:
    """The record of `bark_tpu_torch/probes/<script>.py`, run by path on
    this checkout in a fresh process (its log lines pass through to
    stderr). A fresh process, because with torch 2.11 on the H100 machine
    torch.profiler in this one, after phase 2's checks, at times records
    no device activity in any session, while a new process's sessions
    record every kernel."""
    import torch

    torch.cuda.empty_cache()
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bark_tpu_torch", "probes",
                                      f"{script}.py"), "--tag", "smoke",
         *flags], cwd=ROOT, stdout=subprocess.PIPE, text=True, timeout=600,
        check=True).stdout
    rec = json.loads(out.strip().splitlines()[-1])[script]
    for key in ("card", "tree", "tag"):
        rec.pop(key, None)
    return rec


def prefill_phase(smi: str) -> dict:
    """Phase 2b: `probes/prefill_profile.py`'s record (`probe_record`: K2
    at T 257/437/617/887 and K8 over 8 lanes of 257-887 and 8 x 887 rows,
    each split by device kernel; the 8 prefills of one request; the
    torch.matmul yardstick; the GEMM plans) and its int8-cache record
    under "kv8" (`kv8_profile`), and the bf16 GEMM's SASS, which must hold
    HGMMA (wgmma) and UTMALDG (TMA loads) in every instance."""
    from bark_tpu_torch.probes import prefill_profile

    rec = probe_record("prefill_profile")
    rec["kv8"] = kv8_profile()
    sass = prefill_profile.gemm_sass()
    for key, r in sass.items():
        log(f"  gemm_tma_kernel<{key}>: {r['lines']} SASS lines, HGMMA "
            f"{r['HGMMA']} ({r['first'].get('HGMMA')}), UTMALDG "
            f"{r['UTMALDG']} ({r['first'].get('UTMALDG')})")
    if len(sass) != 6 or not all(r["HGMMA"] and r["UTMALDG"]
                                 for r in sass.values()):
        raise AssertionError(f"the bf16 GEMM is not wgmma fed by TMA in "
                             f"every instance: {sass}")
    return dict(card=smi, sass=sass, **rec)


def kv8_profile() -> dict:
    """Phase 2b on int8 caches: `prefill_profile.py --kv8`'s record (K2,
    K8 and a request's prefills, K6b's `kv_quant` and K6c's `attention`
    split out). Every bf16 call must have run the tensor-core attention on
    int8 tiles and no scalar int8 attention (its kernels by name), and the
    library's ptxas report must hold the scalar int8 attention in f32
    alone: a bf16 prefill cannot reach it."""
    import re

    from bark_tpu_torch.kernels import _build

    rec = probe_record("prefill_profile", "--kv8")
    calls = {f"K2 T {T}": r for T, r in rec["k2"].items()}
    calls.update({f"K8 {k}": r for k, r in rec["k8"].items()})
    for what, r in calls.items():
        names = r["names"]
        tc = sum(v["count"] for k, v in names.items()
                 if "attn_prefill_tc_kernel" in k and "Int8Tiles" in k)
        scalar = [k for k in names if "attn_prefill_i8_kernel" in k]
        if tc <= 0 or scalar:
            raise AssertionError(f"kv8 {what}: {tc} tensor-core int8 "
                                 f"attention launches, scalar {scalar}")
    scalar = set(re.findall(r"attn_prefill_i8_kernelI(\w+?)E",
                            _build.report_path().read_text()))
    log(f"  kv8 profile: every bf16 call ran attn_prefill_tc_kernel"
        f"<Int8Tiles> and no scalar int8 attention; the library's scalar "
        f"int8 attention instances: {sorted(scalar)}")
    if scalar != {"f"}:
        raise AssertionError(f"the scalar int8 attention is built for "
                             f"{sorted(scalar)}, not f32 alone")
    return rec


def prefill_rows_kept(kc, vc, n_valid, what: str, lanes: bool = True):
    """Fail unless every cache row past each lane's n_valid is still the
    zeros `gpt.init_kv_cache` made: (L, B, S, D) lanes, dense or int8
    values and scales, or one lane's dense (L, S, D) caches (lanes
    False)."""
    for c in (kc, vc):
        for t in (c.values() if isinstance(c, dict) else [c]):
            for b, n in enumerate(n_valid):
                if (t[:, b, n:] if lanes else t[:, n:]).any():
                    raise AssertionError(f"{what}: cache rows past n_valid "
                                         f"{n} were written")


def same_bits(what: str, run, again) -> None:
    """Fail unless two runs' logits and caches (dense or int8) are equal
    bit for bit."""
    import torch

    flat = [[t for x in r for t in (x.values() if isinstance(x, dict)
                                   else [x])] for r in (run, again)]
    if not all(torch.equal(a, b) for a, b in zip(*flat)):
        raise AssertionError(f"{what}: two runs differ")
    log(f"  {what}: two runs bit-equal (logits and caches)")


K1_EARLIER_MS = 0.526  # the 62-launch chain's step at n_past 300 (PERF.md, H100)


def loop_counts(before=None, packed: bool = False) -> tuple:
    """(launches of the step loop on the dense or packed read, launches
    of any other single-lane decode kernel: K1's or K5's own step or the
    other read's loop), or what they grew by since `before`."""
    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.kernels import qdecode as kq

    loop, other = (kq, kdec) if packed else (kdec, kq)
    now = (loop.loop_launches,
           other.loop_launches + kdec.launches + kq.launches)
    return now if before is None else tuple(
        a - b for a, b in zip(now, before))


def lane_counts(before=None, packed: bool = False) -> tuple:
    """(launches of the batched step loop (K9, K10) on the dense or packed
    read, launches of any other batched decode kernel: K7's or
    K5-batched's own step or the other read's loop), or what they grew by
    since `before`."""
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import qbdecode as kqb

    loop, other = (kqb, kbdec) if packed else (kbdec, kqb)
    now = (loop.loop_launches,
           other.loop_launches + kbdec.launches + kqb.launches)
    return now if before is None else tuple(
        a - b for a, b in zip(now, before))


K5_EARLIER_MS = 0.474  # K5 q4_0's 62-launch chain, the same (PERF.md, H100)


def device_kernels(fn) -> list:
    """Names of the device kernels one call of fn runs (memcpy and memset
    aside), from one torch.profiler session after a warm-up call. A session
    that records no device activity (seen now and then with torch 2.11 on
    the H100 machine, for a call that did launch) is run again:
    `prefill_profile.profiled_call`."""
    import torch

    from bark_tpu_torch.probes import prefill_profile as pp

    fn()
    torch.cuda.synchronize()
    return [e.name for e in pp.profiled_call(fn)
            if not e.name.startswith(("Memcpy", "Memset"))]


def k1_step_record(sem_cfg, sem_p, coarse_cfg, coarse_p, lmw, kc, vc, gen):
    """K1's persistent step in bf16 at bark-small: its grid and barriers,
    the device kernels one decode_step_fused call runs (asserted 1, on the
    bf16 and the int8 cache), its ms at n_past 0/300/1023 beside the
    bound and the chain's earlier 0.526 ms, the coarse step over the
    window, and where a step's time goes (`stamped_phases`: block 0's
    clock and every block's, the mean of 10 stamped steps at n_past
    300)."""
    import torch

    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.kernels import decode as kdec

    dev = kc.device
    tok = torch.tensor([1234], dtype=torch.int32, device=dev)
    out = torch.empty(sem_cfg.n_out_vocab, dtype=torch.float32, device=dev)
    plan, _ = kdec.device_plan(_build.stage_weights(sem_cfg, sem_p), None)
    k8, v8 = kv8_cache(sem_cfg, 300, gen)
    kernels = {
        "bf16 cache": device_kernels(lambda: kdec.decode_step_fused(
            sem_cfg, sem_p, tok, kc, vc, 300, out=out)),
        "int8 cache": device_kernels(lambda: kdec.decode_step_fused(
            sem_cfg, sem_p, tok, k8, v8, 300, out=out)),
    }
    for what, names in kernels.items():
        log(f"  decode_step_fused      bf16 device kernels per call "
            f"({what}): {len(names)} {sorted(set(names))}")
        if len(names) != 1:
            raise AssertionError(f"K1 ran {len(names)} device kernels a "
                                 f"step ({what}), want 1: {names}")
    rec = dict(blocks=plan.n_blocks, barriers=plan.n_barriers,
               device_kernels_per_call=len(kernels["bf16 cache"]),
               kernel_name=kernels["bf16 cache"][0], steps={})
    log(f"  decode_step_fused      grid {plan.n_blocks} blocks (one "
        f"cooperative launch), {plan.n_barriers} grid barriers a step")
    del k8, v8
    for n_past in (0, 300, 1023):
        ms = cuda_ms(lambda: kdec.decode_step_fused(
            sem_cfg, sem_p, tok, kc, vc, n_past, out=out), 50)
        b_ms, _ = bound(decode_cost(sem_cfg, sem_p, n_past), "bfloat16")
        rec["steps"][f"semantic n_past {n_past}"] = dict(ms=ms, bound_ms=b_ms)
        log(f"  decode_step_fused      bf16 step at n_past {n_past:4d}: "
            f"{ms:.4f} ms, bound {b_ms:.4f} ms ({100 * b_ms / ms:.1f}%); "
            f"the 62-launch chain {K1_EARLIER_MS} ms at n_past 300")
    ck, cv = filled_cache(coarse_cfg, 887, torch.bfloat16, gen)
    cout = torch.empty(coarse_cfg.n_out_vocab, dtype=torch.float32,
                       device=dev)
    ms = cuda_ms(lambda: kdec.decode_step_fused(
        coarse_cfg, coarse_p, tok, ck, cv, 887, lm_window=lmw, out=cout), 50)
    b_ms, _ = bound(decode_cost(coarse_cfg, coarse_p, 887, lmw), "bfloat16")
    rec["steps"]["coarse n_past 887 lm_window"] = dict(ms=ms, bound_ms=b_ms)
    log(f"  decode_step_fused      bf16 coarse step at n_past 887, window: "
        f"{ms:.4f} ms, bound {b_ms:.4f} ms")
    del ck, cv
    rec["phases_us"] = stamped_phases(
        plan, lambda stamps: kdec.decode_step_fused(
            sem_cfg, sem_p, tok, kc, vc, 300, out=out, stamps=stamps))
    log_phases("decode_step_fused      bf16", rec["phases_us"])
    return rec


def k7_step_record() -> dict:
    """Phase 2c: the batched step's record, `probes/bdecode_profile.py`
    (`probe_record`, its batches aside): K7, K5-batched q4_0 and K6 in K7 at B
    1/8/32 and n_past 0/300/1023 and K7's coarse step at 887 over its
    window, each with its ms and bound, those at n_past 300 and the
    coarse step asserted one device kernel a call (torch.profiler); each one's stamped phases at n_past 300 and the
    slowest block; K1 and K5 q4_0 beside them; `torch.matmul`'s device
    time on the step's 48 products and LM head at M = B (the K7 rows'
    library_ms); and `cuobjdump -sass` of the batched step's kernel, whose
    bf16 instances must hold HMMA (mma.sync) or HGMMA."""
    from bark_tpu_torch.probes import bdecode_profile

    rec = probe_record("bdecode_profile", "--no-batches")
    for part in ("k7", "k5b", "k6_k7"):
        for key, r in rec[part].items():
            if r.get("device_kernels", 1) != 1:
                raise AssertionError(f"{part} {key} ran {r['device_kernels']} "
                                     f"device kernels a step, want 1: "
                                     f"{r['names']}")
    sass = bdecode_profile.lane_sass()
    for key, r in sass.items():
        log(f"  lane_step_kernel<{key}>: {r['lines']} SASS lines, HMMA "
            f"{r['HMMA']}, HGMMA {r['HGMMA']} ({r['first']})")
    bf16 = [r for k, r in sass.items() if "bfloat16" in k]
    if len(sass) != 10 or len(bf16) != 5 or not all(
            r["HMMA"] or r["HGMMA"] for r in bf16):
        raise AssertionError(f"the batched step's bf16 instances are not on "
                             f"the tensor cores: {sass}")
    rec["sass"] = sass
    return rec


def k3k4_phase() -> dict:
    """Phase 2d: `probes/k3k4_profile.py`'s record (`probe_record`): K3 and
    K4, dense and q4_0, each asserted one device kernel a call, the step
    loop's (`decode_steps_kernel`), with no sampler kernel."""
    rec = probe_record("k3k4_profile")
    for weights in ("dense", "q4_0"):
        for part in ("k3", "k4"):
            r = rec[weights][part]
            names = list(r["names"])
            if (r["device_kernels"] != 1
                    or not any("decode_steps_kernel" in n for n in names)
                    or any("sample_rows" in n for n in names)):
                raise AssertionError(f"{weights} {part}: {r['device_kernels']}"
                                     f" device kernels a call, want the step "
                                     f"loop's one: {names}")
    return rec


def k9k10_phase() -> dict:
    """Phase 2e: `probes/k9k10_profile.py`'s record (`probe_record`): K9
    and K10, dense and q4_0, at 8 and 32 lanes, each asserted one device
    kernel a call, the batched step loop's (`lane_steps_kernel`), with no
    sampler kernel and no launch of K7's own step; and `probes/lane_sass`'s
    SASS of the loop beside K7's step for the bf16 reads, dense and q4_0
    (registers, spills, opcodes, the products' chunk loops)."""
    from bark_tpu_torch.probes import lane_sass

    rec = probe_record("k9k10_profile")
    sass = lane_sass.record()
    rec["sass"] = {}
    for read in ("DenseRead<bf16>", "PackedRead<bf16,f16,min0>"):
        log(lane_sass.summary(read, sass[read]))
        rec["sass"][read] = lane_sass.brief(sass[read])
    for weights in ("dense", "q4_0"):
        for lanes, r2 in rec[weights].items():
            for part in ("k9", "k10"):
                r = r2[part]
                names = list(r["names"])
                if (r["device_kernels"] != 1
                        or not any("lane_steps_kernel" in n for n in names)
                        or any("sample_rows" in n or "lane_step_kernel" in n
                               for n in names)):
                    raise AssertionError(
                        f"{weights} {lanes} {part}: {r['device_kernels']} "
                        f"device kernels a call, want the batched loop's "
                        f"one: {names}")
    return rec


def k7_row(rec: dict, part: str, B: int) -> dict:
    """What a K7 / K5-batched / K6-in-K7 kernel row adds from the phase 2c
    record at B lanes: its ms at n_past 0/300/1023, device kernels a call,
    the stamped phases at n_past 300, the product phases' time on the
    slowest block (4 a layer x 12, and the LM head) beside torch.matmul's
    device time on the same products at M = B (library_ms)."""
    steps = {k.split(" n_past ")[1]: r["ms"] for k, r in rec[part].items()
             if k.startswith(f"B={B} ")}
    ph = rec["phases"].get({"k7": "k7", "k5b": "k5b", "k6_k7": "k6"}[part]
                           + f" B={B}")
    out = dict(ms_by_n_past=steps, device_kernels_per_call=rec[part][
        f"B={B} n_past 300"]["device_kernels"])
    if ph is not None:
        blocks = ph["every_block"]
        gemv_us = sum(blocks[k]["slowest"] for k in
                      ("ln1_qkv", "proj", "ln2_fc", "out")) * 12
        out.update(phases_us=ph, gemv_phases_ms=(
            gemv_us + blocks["lm_head_slowest"]) / 1e3)
    if part == "k7":
        out.update(library_ms=rec["matmul_device_ms"][str(B)],
                   library_call="torch.matmul on the step's 48 bf16 "
                                "products (4 a layer x 12) and its LM head "
                                "at M = B: their device time "
                                "(torch.profiler)")
    return out


def stamped_phases(plan, run) -> dict:
    """Where a persistent step's time goes: `run(stamps)` 10 times, each
    split by `decode.step_phases_us` (block 0's clock) and
    `decode.step_critical_us` (every block's: each phase's slowest block,
    the blocks' mean and their arrival spread), the mean of each over the
    10, in µs."""
    import torch

    from bark_tpu_torch.kernels import decode as kdec

    stamps = kdec.step_stamps(plan, "cuda")
    block0, blocks = [], []
    for _ in range(10):
        run(stamps)
        torch.cuda.synchronize()
        block0.append(kdec.step_phases_us(plan, stamps))
        blocks.append(kdec.step_critical_us(plan, stamps))

    def mean(recs):
        if isinstance(recs[0], dict):
            return {k: mean([r[k] for r in recs]) for k in recs[0]}
        return sum(recs) / len(recs)

    return dict(block0=mean(block0), blocks=mean(blocks))


def log_phases(name: str, phases: dict) -> None:
    """`stamped_phases`' record, as two log lines."""
    log(f"  {name} stamped step at n_past 300 (block 0, mean of 10; per "
        f"layer): " + ", ".join(f"{k} {v:.2f} us"
                                for k, v in phases["block0"].items()))
    log(f"  {name} every block (mean of 10; per layer, slowest / mean / "
        f"arrival spread): " + ", ".join(
            f"{k} {v['slowest']:.2f}/{v['mean']:.2f}/"
            f"{v['arrival_spread']:.2f} us" if isinstance(v, dict)
            else f"{k} {v:.2f} us" for k, v in phases["blocks"].items()))


def k1_only(smi) -> None:
    """`chip_smoke.py --k1`: K1 alone at bark-small in bf16, held against
    its plain version at n_past 300 (TOL), then `k1_step_record`; K5 on a
    q4_0 qpack the same way, then `k5_step_record`; both as one `k1_step`
    JSON line: to time two trees' persistent step side by side in one
    call."""
    import torch

    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.models.presets import BARK_SMALL

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    sem_cfg, coarse_cfg = BARK_SMALL["semantic"], BARK_SMALL["coarse"]
    lmw = (10000, 10000 + 2 * 1024)
    sem_p = random_stage_params(sem_cfg, gen, torch.bfloat16)
    coarse_p = random_stage_params(coarse_cfg, gen, torch.bfloat16)
    kc, vc = filled_cache(sem_cfg, 300, torch.bfloat16, gen)
    errs = {}
    for what, p in (("decode_step_fused", sem_p), (f"{K5}[q4_0]", None)):
        if p is None:
            sem_q = random_qpack(sem_cfg, "q4_0", torch.bfloat16, gen, dev)
            coarse_q = random_qpack(coarse_cfg, "q4_0", torch.bfloat16, gen,
                                    dev)
            p = sem_q
        out = kdec.decode_step_fused(sem_cfg, p, 1234, kc.clone(),
                                     vc.clone(), 300)
        ref = kdec.decode_step_plain(sem_cfg, p,
                                     torch.tensor(1234, device=dev),
                                     kc.clone(), vc.clone(), 300)
        errs[what] = max_err(out, ref)
        log(f"  {what:22s} bfloat16  logits n_past 300: max err "
            f"{errs[what]:.3e} (tol {TOL['bfloat16']})")
        if not errs[what] <= TOL["bfloat16"]:
            raise AssertionError(f"{what} bf16 disagrees with plain: "
                                 f"{errs[what]}")
    rec = k1_step_record(sem_cfg, sem_p, coarse_cfg, coarse_p, lmw, kc, vc,
                         gen)
    del sem_p, coarse_p
    torch.cuda.empty_cache()
    k5 = k5_step_record(sem_cfg, sem_q, coarse_cfg, coarse_q, lmw, kc, vc,
                        gen)
    print(json.dumps({"k1_step": dict(
        card=smi, max_abs_err=errs["decode_step_fused"], **rec,
        k5_q4_0=dict(max_abs_err=errs[f"{K5}[q4_0]"], **k5))}))


def random_qpack(cfg, fmt: str, dtype, gen, dev, full_range=False):
    """A qpack at cfg's widths (the layout of io.loader's
    gpt_qparams_from_section), built on the card from `gen`: values drawn
    in fmt's range, per-block scales around 0.02 / std(values), mins that
    centre each block, so every weight is ~N(0, 0.02) as in
    gpt.init_params; dense leaves in `dtype` with non-zero biases and LN
    affines. v_pad columns of a single LM head are zero. A format without
    mins draws from the symmetric part of its range ([-7, 7] for q4_0, as
    a centred weight quantizes) unless `full_range`: over q4_0's whole
    range [-8, 7] (mean -0.5) the weights' common mode, through the
    positive GELU outputs, drifts the residual stream layer by layer, and
    its bf16 rounding steps grow with it (`bf16_witness`)."""
    import torch

    qlo, qhi, sname, has_min = QFORMATS[fmt]
    if not has_min and not full_range:
        qlo = -qhi
    sdt = getattr(torch, sname)
    L, D, V = cfg.n_layer, cfg.n_embd, cfg.n_out_vocab
    base = 0.02 / (((qhi - qlo + 1) ** 2 - 1) / 12) ** 0.5

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def randn(*shape, scale=0.02):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    def packed(tree, key, shape, sshape):
        tree[key + "_q"] = torch.randint(
            qlo, qhi + 1, shape, generator=gen, device=dev,
            dtype=torch.int32).to(torch.int8)
        s = base * uniform(sshape, 0.5, 1.5)
        tree[key + "_s"] = s.to(sdt)
        if has_min:
            tree[key + "_m"] = (-0.5 * (qlo + qhi) * s
                                * uniform(sshape, 0.8, 1.2)).to(sdt)

    blocks = {}
    for k in ("ln1", "ln2"):
        blocks[k + "_g"] = (1.0 + randn(L, D)).to(dtype)
        blocks[k + "_b"] = randn(L, D)
    for key, (k, n) in {"qkv": (D, 3 * D), "proj": (D, D),
                        "fc": (D, 4 * D), "out": (4 * D, D)}.items():
        packed(blocks, key, (L, k, n), (L, k // 32, n))
        blocks[key + "_b"] = randn(L, n)
    qp = {"wpe": randn(cfg.block_size, D), "ln_f_g": (1.0 + randn(D)).to(dtype),
          "ln_f_b": randn(D), "blocks": blocks}
    packed(qp, "wte", (cfg.n_wtes, cfg.n_in_vocab, D),
           (cfg.n_wtes, cfg.n_in_vocab, D // 32))
    if cfg.n_lm_heads == 1:
        v_pad = -(-V // D) * D
        packed(qp, "lm", (D, v_pad), (D // 32, v_pad))
        for k in ("lm_q", "lm_s", "lm_m"):
            if k in qp:
                qp[k][:, V:] = 0
    else:
        packed(qp, "lm_heads", (cfg.n_lm_heads, V, D),
               (cfg.n_lm_heads, V, D // 32))
    return qp


def qkernel_checks(checks: Checks, dtype, timed: bool):
    """Phase 2 for K5 (the persistent step on its packed weight read), one
    dtype: the packed decode step against its plain version (models.gpt on
    the same qpack) for every format of QFORMATS at n_past 0/300/1023 on
    the full head and 300 on the coarse window, and at 300 on an int8
    cache (the rows by `record_kv8_rows`); each call must launch K5 once
    and not K1; two runs of a step give the same bits; K3 and K4 over a
    q8_0 qpack in f32, tokens and flags equal, each one launch of K5's
    step loop and none of K5's own step. Timed in bf16 at n_past
    300, and q4_0's step record (`k5_step_record`)."""
    import torch

    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.kernels import qdecode as kq
    from bark_tpu_torch.kernels import semantic as ksem
    from bark_tpu_torch.kernels import window as kwin
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.ops import sampling

    dev = torch.device("cuda")
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    gen = torch.Generator(device=dev).manual_seed(17)
    sem_cfg, coarse_cfg = phase2_cfgs(dtype)
    svs, cbs = 10000, 1024
    lmw = (svs, svs + 2 * cbs)

    def step(cfg, qp, kc, vc, n_past, win=None, tok=4321):
        before, dense = kq.launches, kdec.launches
        out = kdec.decode_step_fused(cfg, qp, tok, kc, vc, n_past,
                                     lm_window=win)
        if kq.launches != before + 1 or kdec.launches != dense:
            raise AssertionError(f"{fmt}: the packed step did not launch "
                                 f"K5 alone")
        return out

    for fmt in QFORMATS:
        kname = f"{K5}[{fmt}]"
        sem_q = random_qpack(sem_cfg, fmt, dtype, gen, dev)
        coarse_q = random_qpack(coarse_cfg, fmt, dtype, gen, dev)
        for cfg, qp, n_past, win, kv8 in ((sem_cfg, sem_q, 0, None, False),
                                          (sem_cfg, sem_q, 300, None, False),
                                          (sem_cfg, sem_q, 1023, None, False),
                                          (coarse_cfg, coarse_q, 300, lmw,
                                           False),
                                          (sem_cfg, sem_q, 300, None, True)):
            if kv8:
                kc, vc = kv8_cache(cfg, n_past, gen)
                kc2, vc2 = kv8_clone(kc), kv8_clone(vc)
            else:
                kc, vc = filled_cache(cfg, n_past, dtype, gen)
                kc2, vc2 = kc.clone(), vc.clone()
            out = step(cfg, qp, kc, vc, n_past, win)
            ref = kdec.decode_step_plain(cfg, qp, 4321, kc2, vc2, n_past,
                                         win)
            tag = (f"n_past {n_past}" + (" lm_window" if win else "")
                   + (" int8 cache" if kv8 else ""))
            checks.record(kname, name, f"logits {tag}", max_err(out, ref))
            rows = (slice(None), n_past)
            if kv8:
                record_kv8_rows(checks, kname, name, f"K/V row {tag}", [
                    (gpt.kv_view(kc, rows), gpt.kv_view(kc2, rows)),
                    (gpt.kv_view(vc, rows), gpt.kv_view(vc2, rows))])
            else:
                checks.record(kname, name, f"K/V row {tag}",
                              max(max_err(kc[rows], kc2[rows]),
                                  max_err(vc[rows], vc2[rows])))
            if win is not None and (float(out[:win[0]].abs().max()) != 0.0
                                    or float(out[win[1]:].abs().max())
                                    != 0.0):
                raise AssertionError("logits outside lm_window are not zero")
        # the packed plan's fixed fold order: the same step twice, same bits
        kc, vc = filled_cache(sem_cfg, 300, dtype, gen)
        runs = [step(sem_cfg, sem_q, kc.clone(), vc.clone(), 300)
                for _ in range(2)]
        if not torch.equal(*runs):
            raise AssertionError(f"{kname} {name}: two runs of a step differ")
        log(f"  {kname:26s} {name:9s} two runs of a step at n_past 300: "
            f"logits bit-equal")
        if timed:
            tok_t = torch.tensor([4321], dtype=torch.int32, device=dev)
            ms = cuda_ms(lambda: kdec.decode_step_fused(
                sem_cfg, sem_q, tok_t, kc, vc, 300), 50)
            plain = cuda_ms(lambda: kdec.decode_step_plain(
                sem_cfg, sem_q, tok_t, kc, vc, 300), 10)
            checks.times[kname] = (ms, plain,
                                   decode_cost(sem_cfg, sem_q, 300))
            if fmt == "q4_0":
                checks.k5_step = k5_step_record(sem_cfg, sem_q, coarse_cfg,
                                                coarse_q, lmw, kc, vc, gen)
        if fmt == "q8_0" and dtype == torch.float32:
            # K3: 16 steps after a 257-row context; K4: 60 steps after 887
            noise = sampling.gumbel((32, sem_cfg.n_out_vocab), gen, dev)
            logits0 = torch.randn(sem_cfg.n_out_vocab, generator=gen,
                                  device=dev)
            kc, vc = filled_cache(sem_cfg, 257, dtype, gen)
            kc2, vc2 = kc.clone(), vc.clone()
            kw = dict(K=16, temp=0.7, semantic_vocab_size=svs)
            args = (257, 3, noise, 2.0)
            before = loop_counts(packed=True)
            toks, flags, lg = ksem.semantic_chunk_fused(
                sem_cfg, sem_q, logits0, kc, vc, *args, **kw)
            rtoks, rflags, rlg = ksem.semantic_chunk_plain(
                sem_cfg, sem_q, logits0, kc2, vc2, *args, **kw)
            if (toks.tolist() != rtoks.tolist()
                    or flags.tolist() != rflags.tolist()):
                raise AssertionError("K3 over q8_0: tokens/flags differ")
            checks.record(kname, name, "K3 logits after 16 steps",
                          max_err(lg, rlg))
            noise = sampling.gumbel((60, cbs), gen, dev)
            logits0 = torch.randn(coarse_cfg.n_out_vocab, generator=gen,
                                  device=dev)
            kc, vc = filled_cache(coarse_cfg, 887, dtype, gen)
            kc2, vc2 = kc.clone(), vc.clone()
            kw = dict(sws=60, temp=0.7, semantic_vocab_size=svs,
                      codebook_size=cbs, lm_window=lmw)
            toks = kwin.coarse_window_fused(coarse_cfg, coarse_q, logits0,
                                            kc, vc, 887, 1, noise, **kw)
            rtoks = kwin.coarse_window_plain(coarse_cfg, coarse_q, logits0,
                                             kc2, vc2, 887, 1, noise, **kw)
            if toks.tolist() != rtoks.tolist():
                raise AssertionError("K4 over q8_0: tokens differ")
            got = loop_counts(before, packed=True)
            if got != (2, 0):
                raise AssertionError(f"K3/K4 over q8_0: {got} launches of "
                                     f"K5's step loop and of K1's or K5's "
                                     f"own step or a dense loop, want one a "
                                     f"call and 0")
            rows = slice(887, 947)
            checks.record(kname, name, "K4 K/V rows of 60 steps",
                          max(max_err(kc[:, rows], kc2[:, rows]),
                              max_err(vc[:, rows], vc2[:, rows])))
            log(f"  K3 (16 steps) and K4 (60 steps) over q8_0: tokens "
                f"and flags equal, one launch of K5's step loop a call, f32")
        del sem_q, coarse_q
        torch.cuda.empty_cache()


def k5_step_record(sem_cfg, sem_q, coarse_cfg, coarse_q, lmw, kc, vc, gen):
    """K5's persistent step on a bf16 q4_0 qpack at bark-small, as
    `k1_step_record` holds K1's: the device kernels one call runs
    (asserted 1, bf16 and int8 cache), its ms at n_past 0/300/1023 beside
    the bound and the 62-launch chain's earlier 0.474 ms, the coarse step
    over the window, where a stamped step's time goes (`stamped_phases`),
    and the bytes of its records."""
    import torch

    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.kernels import decode as kdec

    dev = kc.device
    tok = torch.tensor([4321], dtype=torch.int32, device=dev)
    out = torch.empty(sem_cfg.n_out_vocab, dtype=torch.float32, device=dev)
    w = _build.stage_qweights(sem_cfg, sem_q)
    plan, _ = kdec.device_plan(w, None)
    kdec.step_qtiles(w, sem_q)
    tiled = w.memo("step_qtiles", dict)["tiled"]
    k8, v8 = kv8_cache(sem_cfg, 300, gen)
    kernels = {
        "bf16 cache": device_kernels(lambda: kdec.decode_step_fused(
            sem_cfg, sem_q, tok, kc, vc, 300, out=out)),
        "int8 cache": device_kernels(lambda: kdec.decode_step_fused(
            sem_cfg, sem_q, tok, k8, v8, 300, out=out)),
    }
    for what, names in kernels.items():
        log(f"  {K5}[q4_0] bf16 device kernels per call ({what}): "
            f"{len(names)} {sorted(set(names))}")
        if len(names) != 1:
            raise AssertionError(f"K5 ran {len(names)} device kernels a "
                                 f"step ({what}), want 1: {names}")
    rec = dict(blocks=plan.n_blocks, barriers=plan.n_barriers,
               device_kernels_per_call=len(kernels["bf16 cache"]),
               kernel_name=kernels["bf16 cache"][0],
               records_bytes=sum(t.numel() for t in tiled),
               records_bytes_lm=tiled[-1].numel(), steps={})
    log(f"  {K5}[q4_0] grid {plan.n_blocks} blocks, {plan.n_barriers} "
        f"barriers; records {rec['records_bytes']} bytes (LM head "
        f"{rec['records_bytes_lm']})")
    del k8, v8
    for n_past in (0, 300, 1023):
        ms = cuda_ms(lambda: kdec.decode_step_fused(
            sem_cfg, sem_q, tok, kc, vc, n_past, out=out), 50)
        b_ms, _ = bound(decode_cost(sem_cfg, sem_q, n_past), "bfloat16")
        rec["steps"][f"semantic n_past {n_past}"] = dict(ms=ms, bound_ms=b_ms)
        log(f"  {K5}[q4_0] bf16 step at n_past {n_past:4d}: {ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({100 * b_ms / ms:.1f}%); the 62-launch "
            f"chain {K5_EARLIER_MS} ms at n_past 300")
    ck, cv = filled_cache(coarse_cfg, 887, torch.bfloat16, gen)
    cout = torch.empty(coarse_cfg.n_out_vocab, dtype=torch.float32,
                       device=dev)
    ms = cuda_ms(lambda: kdec.decode_step_fused(
        coarse_cfg, coarse_q, tok, ck, cv, 887, lm_window=lmw, out=cout), 50)
    b_ms, _ = bound(decode_cost(coarse_cfg, coarse_q, 887, lmw), "bfloat16")
    rec["steps"]["coarse n_past 887 lm_window"] = dict(ms=ms, bound_ms=b_ms)
    log(f"  {K5}[q4_0] bf16 coarse step at n_past 887, window: {ms:.4f} "
        f"ms, bound {b_ms:.4f} ms")
    del ck, cv
    rec["phases_us"] = stamped_phases(
        plan, lambda stamps: kdec.decode_step_fused(
            sem_cfg, sem_q, tok, kc, vc, 300, out=out, stamps=stamps))
    log_phases(f"{K5}[q4_0] bf16", rec["phases_us"])
    return rec


def filled_batched_cache(cfg, B: int, rows: int, dtype, gen):
    """(L, B, S, D) KV caches on the card with rows [0, rows) of every
    lane drawn from `gen`."""
    import torch

    from bark_tpu_torch.models import gpt

    kc, vc = gpt.init_kv_cache(cfg, dtype, gen.device, batch=B)
    for c in (kc, vc):
        c[:, :, :rows] = torch.randn(c[:, :, :rows].shape, generator=gen,
                                     device=gen.device).to(dtype)
    return kc, vc


def batched_kernel_checks(checks: Checks, dtype, timed: bool):
    """Phase 2 for K7-K10, one dtype: each batched kernel against its plain
    version (its single-lane plain version lane by lane) on bark-small
    shapes and random weights, up to the 32 lanes of phase 4c. K7 at B
    1/3/8/32 with n_past cycling 0/300/1023 on the full head, and at B 8 on
    the coarse window; K8 over 3 and 32 lanes of 257 rows and 4, 8 and 32
    lanes of 257 to 887 rows; K9 (16 steps) over 1, 3, 8 and 32 lanes and
    a chunk that reaches the clamp; K10 (60 steps) over 1, 3 (both
    parities in f32) and 8 lanes, and 32 in f32; tokens and flags
    equal in f32 and K9/K10 bit-equal to K7's steps on their tokens (in
    bf16 over one step, as for K3 and K4, the only step of 32 lanes there,
    and two runs bit-equal). Timed in bf16, on
    inputs checked first: K7 at B 1/8/32 at n_past 300, K8 over 8 lanes of
    887 rows, K9 and K10 over 8 lanes."""
    import torch

    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import bprefill as kbpre
    from bark_tpu_torch.kernels import bsemantic as kbsem
    from bark_tpu_torch.kernels import bwindow as kbwin
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.ops import sampling

    dev = torch.device("cuda")
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    gen = torch.Generator(device=dev).manual_seed(27)
    sem_cfg, coarse_cfg = phase2_cfgs(dtype)
    svs, cbs = 10000, 1024
    lmw = (svs, svs + 2 * cbs)
    sem_p = random_stage_params(sem_cfg, gen, dtype)
    coarse_p = random_stage_params(coarse_cfg, gen, dtype)

    def lane_tokens(cfg, B):
        return torch.randint(0, cfg.n_in_vocab, (B,), generator=gen,
                             device=dev, dtype=torch.int32)

    # K7
    for cfg, p, B, win in ((sem_cfg, sem_p, 1, None), (sem_cfg, sem_p, 3, None),
                           (sem_cfg, sem_p, 8, None),
                           (sem_cfg, sem_p, 32, None),
                           (coarse_cfg, coarse_p, 8, lmw)):
        n_past = [(0, 300, 1023)[b % 3] for b in range(B)]
        toks = lane_tokens(cfg, B)
        kc, vc = filled_batched_cache(cfg, B, 1023, dtype, gen)
        kc2, vc2 = kc.clone(), vc.clone()
        out = kbdec.decode_step_fused_batched(cfg, p, toks, kc, vc, n_past,
                                              lm_window=win)
        ref = kbdec.decode_step_batched_plain(cfg, p, toks, kc2, vc2, n_past,
                                              win)
        tag = f"B {B}" + (" lm_window" if win else "")
        checks.record(K7, name, f"logits {tag}", max_err(out, ref))
        checks.record(K7, name, f"K/V rows {tag}", max(
            max(max_err(kc[:, b, n], kc2[:, b, n]),
                max_err(vc[:, b, n], vc2[:, b, n]))
            for b, n in enumerate(n_past)))
        if win is not None and (float(out[:, :win[0]].abs().max()) != 0.0
                                or float(out[:, win[1]:].abs().max()) != 0.0):
            raise AssertionError("K7: logits outside lm_window are not zero")
        del kc, vc, kc2, vc2
    if timed:
        for B in BATCHES:
            kc, vc = filled_batched_cache(sem_cfg, B, 300, dtype, gen)
            toks = lane_tokens(sem_cfg, B)
            slots = _build.device_ints([300] * B, dev)
            ms = cuda_ms(lambda: kbdec.decode_step_fused_batched(
                sem_cfg, sem_p, toks, kc, vc, slots), 50)
            plain = cuda_ms(lambda: kbdec.decode_step_batched_plain(
                sem_cfg, sem_p, toks, kc, vc, [300] * B), 1 if B > 8 else 3)
            checks.times[f"{K7}[B={B}]"] = (
                ms, plain, decode_cost(sem_cfg, sem_p, 300, lanes=B))
            del kc, vc
        torch.cuda.empty_cache()

    # K8: per-lane contexts of different lengths, up to the 32 lanes the
    # batched path gives it: the semantic prompts (32 x 257 stacked rows)
    # and coarse re-primes of 257 to 887 rows; the timed case (8 x 887) is
    # checked on the inputs it is timed on
    mixed = (887, 257, 600, 431, 800, 350, 700, 500)
    for cfg, p, n_valid, win in (
            (sem_cfg, sem_p, [257] * 3, None),
            (sem_cfg, sem_p, [257] * 32, None),
            (coarse_cfg, coarse_p, [887, 257, 600, 431], lmw),
            (coarse_cfg, coarse_p, [887] * 8, lmw),
            (coarse_cfg, coarse_p, [mixed[b % 8] for b in range(32)], lmw)):
        B, T = len(n_valid), max(n_valid)
        x_emb = p["wte"][0][torch.randint(
            0, cfg.n_in_vocab, (B * T,), generator=gen, device=dev)].reshape(
            B, T, cfg.n_embd)
        kc, vc = gpt.init_kv_cache(cfg, dtype, dev, batch=B)
        kc2, vc2 = gpt.init_kv_cache(cfg, dtype, dev, batch=B)
        out = kbpre.prefill_fused_batched(cfg, p, x_emb, kc, vc, n_valid,
                                          lm_window=win)
        ref = kbpre.prefill_batched_plain(cfg, p, x_emb, kc2, vc2, n_valid,
                                          win)
        tag = (f"{B} lanes, n_valid {min(n_valid)}-{max(n_valid)}"
               + (" lm_window" if win else ""))
        checks.record("prefill_fused_batched", name, f"logits {tag}",
                      max_err(out, ref))
        checks.record("prefill_fused_batched", name, f"K/V rows {tag}", max(
            max(max_err(kc[:, b, :n], kc2[:, b, :n]),
                max_err(vc[:, b, :n], vc2[:, b, :n]))
            for b, n in enumerate(n_valid)))
        prefill_rows_kept(kc, vc, n_valid, f"K8 {name} {tag}")
        if dtype == torch.bfloat16:
            kc3, vc3 = gpt.init_kv_cache(cfg, dtype, dev, batch=B)
            again = kbpre.prefill_fused_batched(cfg, p, x_emb, kc3, vc3,
                                                n_valid, lm_window=win)
            same_bits(f"K8 bf16 {tag}", (out, kc, vc), (again, kc3, vc3))
            del kc3, vc3
        if timed and n_valid == [887] * 8:
            ms = cuda_ms(lambda: kbpre.prefill_fused_batched(
                cfg, p, x_emb, kc, vc, n_valid, lm_window=win), 5)
            plain = cuda_ms(lambda: kbpre.prefill_batched_plain(
                cfg, p, x_emb, kc2, vc2, n_valid, win), 1)
            checks.times["prefill_fused_batched"] = (
                ms, plain, prefill_cost(cfg, p, n_valid, win))
        del x_emb, kc, vc, kc2, vc2
    torch.cuda.empty_cache()

    # K9: 16 steps after 257-row prompts, temp 0.7, over 1, 3, 8 (timed)
    # and 32 lanes, and in f32 a chunk of 3 lanes whose shared slot reaches
    # the clamp at block_size - 1 (count0 760). Each call one launch of the
    # batched step loop and none of K7's step. In f32 the chunk must give
    # the plain version's tokens and flags exactly and K7's steps, one
    # launch each on its tokens, its bits; in bf16 a near-tie argmax may
    # flip after a step, so the error is taken over one step (the only
    # chunk of 32 lanes in bf16: its longer chunks run in phases 2e and
    # 4c), and two runs of the chunk must give the same bits.
    def sem_start(B):
        x_emb = sem_p["wte"][0][torch.randint(
            0, sem_cfg.n_in_vocab, (B * 257,), generator=gen,
            device=dev)].reshape(B, 257, -1)
        kc, vc = gpt.init_kv_cache(sem_cfg, dtype, dev, batch=B)
        logits = kbpre.prefill_batched_plain(sem_cfg, sem_p, x_emb, kc, vc,
                                             [257] * B)
        return logits, kc, vc

    f32 = dtype == torch.float32
    plain_ms = {}  # (lanes, steps): the checks' plain calls, timed
    sem_cases = [(1, 3), (3, 3), (8, 3), (32, 3)] + ([(3, 760)] if f32
                                                      else [])
    for B, count0 in sem_cases:
        noise = sampling.gumbel((B, 32, sem_cfg.n_out_vocab), gen, dev)
        logits0, kc0, vc0 = sem_start(B)
        if count0 > 3:  # rows up to the chunk's first slot
            for c in (kc0, vc0):
                c[:, :, 257:257 + count0] = c[:, :, :count0]
        args = (257, count0, noise, 2.0)
        slots = [[min(257 + count0 + j, sem_cfg.block_size - 1)] * B
                 for j in range(16)]
        tag = f"B={B}" + (f" count0 {count0} (clamp)" if count0 > 3 else "")
        for K in ((16,) if f32 else (16, 1) if B < 32 else (1,)):
            kw = dict(K=K, temp=0.7, semantic_vocab_size=svs)
            kc, vc = kc0.clone(), vc0.clone()
            kc2, vc2 = kc0.clone(), vc0.clone()
            before = lane_counts()
            toks, flags, lg = kbsem.semantic_chunk_fused_batched(
                sem_cfg, sem_p, logits0, kc, vc, *args, **kw)
            if lane_counts(before) != (1, 0):
                raise AssertionError(f"K9 {name} {tag}: {lane_counts(before)}"
                                     f" launches of the batched loop and of "
                                     f"K7's step, want 1 and 0")
            (rtoks, rflags, rlg), plain_ms[B, K] = once_ms(
                lambda: kbsem.semantic_chunk_batched_plain(
                    sem_cfg, sem_p, logits0, kc2, vc2, *args, **kw))
            same = int((toks.cpu() == rtoks.cpu()).sum())
            flags_same = bool((flags.cpu() == rflags.cpu()).all())
            log(f"  semantic_chunk_fused_batched {name:9s} {tag} K={K}: "
                f"tokens equal {same}/{B * K}, flags equal {flags_same}")
            if f32 or K == 1:
                if same != B * K or not flags_same:
                    raise AssertionError(
                        f"K9 {name} {tag} K={K}: tokens/flags differ")
                checks.record("semantic_chunk_fused_batched", name,
                              f"logits, {B} lanes, {K} steps"
                              + (" (clamp)" if count0 > 3 else ""),
                              max_err(lg, rlg))
            if f32:
                sample = kbsem.chunk_lane_loop(sem_cfg, 257, count0, K, 0.7,
                                               svs, 2.0, B)[1]
                loop_steps_check(
                    f"K9 {name} {tag}", sem_cfg, sem_p, logits0, kc0.clone(),
                    vc0.clone(), kc, vc, toks, flags, lg, slots[:K], None,
                    sample, lambda j: noise[:, sample.noise_row(j, 32)])
            elif K == 16 and B == 8:
                k, v = kc0.clone(), vc0.clone()
                again = kbsem.semantic_chunk_fused_batched(
                    sem_cfg, sem_p, logits0, k, v, *args, **kw)
                same_bits(f"K9 bf16 {tag}", (toks, flags, lg, kc, vc),
                          (*again, k, v))
            del kc, vc, kc2, vc2
        if timed and B == 8:  # the inputs checked just above
            kw = dict(K=16, temp=0.7, semantic_vocab_size=svs)
            ms = cuda_ms(lambda: kbsem.semantic_chunk_fused_batched(
                sem_cfg, sem_p, logits0, kc0, vc0, *args, **kw), 3)
            plain = plain_ms[8, 16]
            nb, fl = decode_cost(sem_cfg, sem_p, 257 + 3, steps=16, lanes=B)
            checks.times["semantic_chunk_fused_batched"] = (
                ms, plain, (nb + B * 16 * sem_cfg.n_out_vocab * 4, fl))
        del noise, kc0, vc0
        torch.cuda.empty_cache()

    # K10: one window: 60 steps of 3 lanes with contexts of 887, 700 and
    # 500 rows, step parity odd and (f32) even; 60 steps of 1 lane of 257
    # rows; 60 steps of 8 lanes of 887 (timed); 32 lanes cycling 887, 700,
    # 500, 257: in f32 60 steps (the main path's largest window, held to
    # the plain version and to K7's steps), in bf16 one. The rules of K9,
    # the error taken on the K/V rows the window writes.
    def coarse_start(ctx_len):
        B = len(ctx_len)
        x_emb = coarse_p["wte"][0][torch.randint(
            0, coarse_cfg.n_in_vocab, (B * 887,), generator=gen,
            device=dev)].reshape(B, 887, -1)
        kc, vc = gpt.init_kv_cache(coarse_cfg, dtype, dev, batch=B)
        logits = kbpre.prefill_batched_plain(coarse_cfg, coarse_p, x_emb, kc,
                                             vc, ctx_len, lmw)
        return logits, kc, vc

    cycle = [887, 700, 500, 257]
    win_cases = [(cycle[:3], 60, 1), ([257], 60, 1), ([887] * 8, 60, 1),
                 ([cycle[b % 4] for b in range(32)], 60 if f32 else 1, 1)]
    if f32:
        win_cases.insert(1, (cycle[:3], 60, 0))
    for ctx_len, steps, step0 in win_cases:
        B = len(ctx_len)
        noise = sampling.gumbel((steps, B, cbs), gen, dev)
        logits0, kc0, vc0 = coarse_start(ctx_len)
        tag = f"B={B} parity {'odd' if step0 else 'even'}"
        for sws in ((steps,) if f32 or steps == 1 else (steps, 1)):
            kw = dict(sws=sws, temp=0.7, semantic_vocab_size=svs,
                      codebook_size=cbs, lm_window=lmw)
            kc, vc = kc0.clone(), vc0.clone()
            kc2, vc2 = kc0.clone(), vc0.clone()
            before = lane_counts()
            toks = kbwin.coarse_window_fused_batched(
                coarse_cfg, coarse_p, logits0, kc, vc, ctx_len, step0,
                noise[:sws], **kw)
            if lane_counts(before) != (1, 0):
                raise AssertionError(f"K10 {name} {tag}: not one launch of "
                                     f"the batched loop and none of K7's "
                                     f"step")
            rtoks, plain_ms[B, sws] = once_ms(
                lambda: kbwin.coarse_window_batched_plain(
                    coarse_cfg, coarse_p, logits0, kc2, vc2, ctx_len, step0,
                    noise[:sws], **kw))
            same = int((toks.cpu() == rtoks.cpu()).sum())
            log(f"  coarse_window_fused_batched  {name:9s} {tag} sws={sws}: "
                f"tokens equal {same}/{B * sws}")
            if f32 or sws == 1:
                if same != B * sws:
                    raise AssertionError(
                        f"K10 {name} {tag} sws={sws}: tokens differ")
                checks.record("coarse_window_fused_batched", name,
                              f"K/V rows, {B} lanes, {sws} steps", max(
                                  max(max_err(kc[:, b, c:c + sws],
                                              kc2[:, b, c:c + sws]),
                                      max_err(vc[:, b, c:c + sws],
                                              vc2[:, b, c:c + sws]))
                                  for b, c in enumerate(ctx_len)))
            if f32:
                sample = kbwin.window_lane_loop(ctx_len, step0, sws, 0.7, svs,
                                                cbs)[1]
                loop_steps_check(
                    f"K10 {name} {tag}", coarse_cfg, coarse_p, logits0,
                    kc0.clone(), vc0.clone(), kc, vc, toks, None, None,
                    [[c + j for c in ctx_len] for j in range(sws)], lmw,
                    sample, lambda j: noise[j])
            elif sws == steps and B == 8:
                k, v = kc0.clone(), vc0.clone()
                again = kbwin.coarse_window_fused_batched(
                    coarse_cfg, coarse_p, logits0, k, v, ctx_len, step0,
                    noise, **kw)
                same_bits(f"K10 bf16 {tag}", (toks, kc, vc), (again, k, v))
            del kc, vc, kc2, vc2
        if timed and B == 8:  # the inputs checked just above
            kw = dict(sws=60, temp=0.7, semantic_vocab_size=svs,
                      codebook_size=cbs, lm_window=lmw)
            ms = cuda_ms(lambda: kbwin.coarse_window_fused_batched(
                coarse_cfg, coarse_p, logits0, kc0, vc0, ctx_len, 1, noise,
                **kw), 2)
            plain = plain_ms[8, 60]
            nb, fl = decode_cost(coarse_cfg, coarse_p, 887, lmw, steps=60,
                                 lanes=B)
            checks.times["coarse_window_fused_batched"] = (
                ms, plain, (nb + 60 * B * cbs * 4, fl))
        del noise, kc0, vc0
        torch.cuda.empty_cache()


def qbatched_kernel_checks(checks: Checks, dtype, timed: bool):
    """Phase 2 for K5-batched (K7's step on packed weights), one dtype:
    against its plain version (models.gpt on the same qpack, lane by lane)
    for every format of K5B_FORMATS at B 1/3/8/32 with n_past cycling
    0/300/1023, on the full head and on the coarse window; on a q4_0 qpack
    also K9 (16 steps of 8 lanes) and K10 (60 steps of 8 and of 32 lanes)
    in f32, tokens and flags equal, each one launch of the packed batched
    loop and bit-equal to K5-batched's steps on its tokens, and the step on
    int8 caches at B 8 and 32 (K6a inside; lanes at n_past 0 held to
    TOL_KV8_FIRST, the cache rows by `record_kv8_rows`). Timed in bf16 at n_past 300, each case
    checked first on the inputs it is timed on: every format at B 8, q4_0
    also at B 1 and 32."""
    import torch

    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import bsemantic as kbsem
    from bark_tpu_torch.kernels import bwindow as kbwin
    from bark_tpu_torch.kernels import qbdecode as kqb
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.ops import sampling

    dev = torch.device("cuda")
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    gen = torch.Generator(device=dev).manual_seed(47)
    sem_cfg, coarse_cfg = phase2_cfgs(dtype)
    svs, cbs = 10000, 1024
    lmw = (svs, svs + 2 * cbs)

    def lane_tokens(cfg, B):
        return torch.randint(0, cfg.n_in_vocab, (B,), generator=gen,
                             device=dev, dtype=torch.int32)

    def step(cfg, qp, toks, kc, vc, n_past, win=None):
        """The kernel's logits; fails unless it launched K5-batched once
        and dense K7 not at all."""
        before, dense = kqb.launches, kbdec.launches
        out = kbdec.decode_step_fused_batched(cfg, qp, toks, kc, vc, n_past,
                                              lm_window=win)
        if kqb.launches != before + 1 or kbdec.launches != dense:
            raise AssertionError("the packed batched step did not launch "
                                 "K5-batched alone")
        return out

    for fmt in K5B_FORMATS:
        kname = f"{K5B}[{fmt}]"
        sem_q = random_qpack(sem_cfg, fmt, dtype, gen, dev)
        coarse_q = random_qpack(coarse_cfg, fmt, dtype, gen, dev)
        for cfg, qp, B, win in (
                *((sem_cfg, sem_q, B, None) for B in (1, 3, 8, 32)),
                *((coarse_cfg, coarse_q, B, lmw) for B in (1, 3, 8, 32))):
            n_past = [(0, 300, 1023)[b % 3] for b in range(B)]
            toks = lane_tokens(cfg, B)
            kc, vc = filled_batched_cache(cfg, B, 1023, dtype, gen)
            kc2, vc2 = kc.clone(), vc.clone()
            out = step(cfg, qp, toks, kc, vc, n_past, win)
            ref = kbdec.decode_step_batched_plain(cfg, qp, toks, kc2, vc2,
                                                  n_past, win)
            tag = f"B {B}" + (" lm_window" if win else "")
            checks.record(kname, name, f"logits {tag}", max_err(out, ref))
            checks.record(kname, name, f"K/V rows {tag}", max(
                max(max_err(kc[:, b, n], kc2[:, b, n]),
                    max_err(vc[:, b, n], vc2[:, b, n]))
                for b, n in enumerate(n_past)))
            if win is not None and (float(out[:, :win[0]].abs().max()) != 0
                                    or float(out[:, win[1]:].abs().max())
                                    != 0):
                raise AssertionError(f"{kname}: logits outside lm_window "
                                     f"are not zero")
            del kc, vc, kc2, vc2
        if timed:  # each case checked first on the inputs it is timed on
            for B in (1, 8, 32) if fmt == "q4_0" else (8,):
                kc, vc = filled_batched_cache(sem_cfg, B, 300, dtype, gen)
                toks = lane_tokens(sem_cfg, B)
                slots = _build.device_ints([300] * B, dev)
                kc2, vc2 = kc.clone(), vc.clone()
                out = step(sem_cfg, sem_q, toks, kc2, vc2, slots)
                ref = kbdec.decode_step_batched_plain(sem_cfg, sem_q, toks,
                                                      kc, vc, [300] * B)
                checks.record(kname, name, f"logits B {B} timed, n_past 300",
                              max_err(out, ref))
                del kc2, vc2
                ms = cuda_ms(lambda: kbdec.decode_step_fused_batched(
                    sem_cfg, sem_q, toks, kc, vc, slots), 50)
                plain = cuda_ms(lambda: kbdec.decode_step_batched_plain(
                    sem_cfg, sem_q, toks, kc, vc, [300] * B),
                    1 if B > 8 else 3)
                checks.times[f"{K5B}[{fmt},B={B}]"] = (
                    ms, plain, decode_cost(sem_cfg, sem_q, 300, lanes=B))
                del kc, vc
        if fmt == "q4_0" and dtype == torch.float32:
            # K9: 16 steps of 8 lanes after 257 rows; K10: 60 steps of 8
            # and of 32 lanes after 887, 700, 500 and 257 rows
            B = 8
            noise = sampling.gumbel((B, 32, sem_cfg.n_out_vocab), gen, dev)
            logits0 = torch.randn((B, sem_cfg.n_out_vocab), generator=gen,
                                  device=dev)
            kc, vc = filled_batched_cache(sem_cfg, B, 257, dtype, gen)
            kc2, vc2 = kc.clone(), vc.clone()
            kc3, vc3 = kc.clone(), vc.clone()
            kw = dict(K=16, temp=0.7, semantic_vocab_size=svs)
            args = (257, 3, noise, 2.0)
            before = lane_counts(packed=True)
            got = kbsem.semantic_chunk_fused_batched(
                sem_cfg, sem_q, logits0, kc, vc, *args, **kw)
            if lane_counts(before, packed=True) != (1, 0):
                raise AssertionError("K9 over q4_0: not one launch of the "
                                     "packed batched loop")
            want = kbsem.semantic_chunk_batched_plain(
                sem_cfg, sem_q, logits0, kc2, vc2, *args, **kw)
            if (got[0].tolist() != want[0].tolist()
                    or got[1].tolist() != want[1].tolist()):
                raise AssertionError("K9 over q4_0: tokens/flags differ")
            checks.record(kname, name, "K9 logits, 8 lanes x 16 steps",
                          max_err(got[2], want[2]))
            sample = kbsem.chunk_lane_loop(sem_cfg, 257, 3, 16, 0.7, svs,
                                           2.0, B)[1]
            loop_steps_check(
                "K9 over q4_0", sem_cfg, sem_q, logits0, kc3, vc3, kc, vc,
                got[0], got[1], got[2], [[260 + j] * B for j in range(16)],
                None, sample, lambda j: noise[:, sample.noise_row(j, 32)])
            del kc, vc, kc2, vc2, kc3, vc3
            for B, sws in ((8, 60), (32, 60)):
                ctx_len = [(887, 700, 500, 257)[b % 4] for b in range(B)]
                noise = sampling.gumbel((sws, B, cbs), gen, dev)
                logits0 = torch.randn((B, coarse_cfg.n_out_vocab),
                                      generator=gen, device=dev)
                kc, vc = filled_batched_cache(coarse_cfg, B, 887, dtype, gen)
                kc2, vc2 = kc.clone(), vc.clone()
                kc3, vc3 = kc.clone(), vc.clone()
                kw = dict(sws=sws, temp=0.7, semantic_vocab_size=svs,
                          codebook_size=cbs, lm_window=lmw)
                before = lane_counts(packed=True)
                toks = kbwin.coarse_window_fused_batched(
                    coarse_cfg, coarse_q, logits0, kc, vc, ctx_len, 1, noise,
                    **kw)
                if lane_counts(before, packed=True) != (1, 0):
                    raise AssertionError(f"K10 over q4_0, {B} lanes: not one "
                                         f"launch of the packed batched loop")
                sample = kbwin.window_lane_loop(ctx_len, 1, sws, 0.7, svs,
                                                cbs)[1]
                loop_steps_check(
                    f"K10 over q4_0, {B} lanes", coarse_cfg, coarse_q,
                    logits0, kc3, vc3, kc, vc, toks, None, None,
                    [[c + j for c in ctx_len] for j in range(sws)], lmw,
                    sample, lambda j: noise[j])
                rtoks = kbwin.coarse_window_batched_plain(
                    coarse_cfg, coarse_q, logits0, kc2, vc2, ctx_len, 1,
                    noise, **kw)
                if toks.tolist() != rtoks.tolist():
                    raise AssertionError(f"K10 over q4_0, {B} lanes: tokens "
                                         f"differ")
                checks.record(kname, name,
                              f"K10 K/V rows, {B} lanes x {sws} steps",
                              max(max(max_err(kc[:, b, c:c + sws],
                                              kc2[:, b, c:c + sws]),
                                      max_err(vc[:, b, c:c + sws],
                                              vc2[:, b, c:c + sws]))
                                  for b, c in enumerate(ctx_len)))
                del kc, vc, kc2, vc2, kc3, vc3, noise
            log(f"  K9 (8 lanes x 16 steps) and K10 (8 and 32 lanes x 60 "
                f"steps) over q4_0: tokens and flags equal, f32, one launch "
                f"of the packed batched loop a call, bit-equal to K5-batched's "
                f"steps")
        if fmt == "q4_0":
            # the packed batched step on int8 caches (K6a inside)
            for B in KV8_BATCHES:
                n_past = [(0, 300, 1023)[b % 3] for b in range(B)]
                toks = lane_tokens(sem_cfg, B)
                kc, vc = kv8_cache(sem_cfg, 1023, gen, batch=B)
                kc2, vc2 = kv8_clone(kc), kv8_clone(vc)
                out = step(sem_cfg, sem_q, toks, kc, vc, n_past)
                ref = kbdec.decode_step_batched_plain(sem_cfg, sem_q, toks,
                                                      kc2, vc2, n_past)
                for first in (False, True):
                    lanes = [b for b, n in enumerate(n_past)
                             if (n == 0) == first]
                    what = f"B {B}, n_past {'0' if first else '> 0'} lanes"
                    checks.record(f"{K6_K5B} n_past 0" if first else K6_K5B,
                                  name, f"logits {what}",
                                  max_err(out[lanes], ref[lanes]),
                                  tol=TOL_KV8_FIRST if first else None)
                    pairs = [(gpt.kv_view(c, (slice(None), b, n_past[b])),
                              gpt.kv_view(c2, (slice(None), b, n_past[b])))
                             for b in lanes
                             for c, c2 in ((kc, kc2), (vc, vc2))]
                    record_kv8_rows(checks, K6_K5B, name, f"K/V rows {what}",
                                    pairs, chained=first)
                del kc, vc, kc2, vc2
        del sem_q, coarse_q
        torch.cuda.empty_cache()


def cast_dense(tree, dtype):
    """A copy of qpack `tree` with its dense leaves in `dtype`; its int8
    values, scales and mins are shared."""
    return {k: cast_dense(v, dtype) if isinstance(v, dict)
            else v if k.endswith(("_q", "_s", "_m")) else v.to(dtype)
            for k, v in tree.items()}


def bf16_witness():
    """Phase 2's witness for the bf16 tolerance of the packed steps on
    q4_0, over random_qpack's centred draw and over q4_0's whole range
    [-8, 7]: the kernel in bf16 and the plain version in bf16, each
    against the plain version in f32 on the same int8 values, scales,
    tokens and cache rows (the bf16 qpack is the f32 one with its dense
    leaves rounded; the f32 caches hold the bf16 rows). K5-batched at B 8
    on the coarse window and at B 32 on both heads, K5 at n_past 300.
    Logged, not checked: a kernel no farther from f32 than the plain bf16
    version is is rounding as bf16 rounds, not at fault."""
    import torch

    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.models.presets import BARK_SMALL

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(57)
    sem_cfg, coarse_cfg = BARK_SMALL["semantic"], BARK_SMALL["coarse"]
    lmw = (10000, 10000 + 2 * 1024)
    bf = torch.bfloat16

    def report(what, kern, plain, truth):
        errs = [(float((x.float() - truth).abs().max()),
                 float((x.float() - truth).abs().mean()))
                for x in (kern, plain)]
        log(f"  bf16 witness {what:36s} max|kernel-f32| {errs[0][0]:.3e} "
            f"max|plain-f32| {errs[1][0]:.3e} mean {errs[0][1]:.3e} / "
            f"{errs[1][1]:.3e}  max|kernel-plain| "
            f"{max_err(kern, plain):.3e}")

    for full in (False, True):
        draw = "[-8, 7]" if full else "[-7, 7]"
        sem_q, coarse_q = (random_qpack(cfg, "q4_0", torch.float32, gen,
                                        dev, full_range=full)
                           for cfg in (sem_cfg, coarse_cfg))
        for cfg, q32, B, win in ((coarse_cfg, coarse_q, 8, lmw),
                                 (sem_cfg, sem_q, 32, None),
                                 (coarse_cfg, coarse_q, 32, lmw)):
            q16 = cast_dense(q32, bf)
            n_past = [(0, 300, 1023)[b % 3] for b in range(B)]
            toks = torch.randint(0, cfg.n_in_vocab, (B,), generator=gen,
                                 device=dev, dtype=torch.int32)
            kc, vc = filled_batched_cache(cfg, B, 1023, bf, gen)
            truth = kbdec.decode_step_batched_plain(
                cfg, q32, toks, kc.float(), vc.float(), n_past, win)
            kern = kbdec.decode_step_fused_batched(
                cfg, q16, toks, kc.clone(), vc.clone(), n_past, lm_window=win)
            plain = kbdec.decode_step_batched_plain(
                cfg, q16, toks, kc.clone(), vc.clone(), n_past, win)
            report(f"{K5B} {draw} B {B}" + (" lm_window" if win else ""),
                   kern, plain, truth)
        q32 = sem_q
        q16 = cast_dense(q32, bf)
        kc, vc = filled_cache(sem_cfg, 300, bf, gen)
        truth = kdec.decode_step_plain(sem_cfg, q32, 4321, kc.float(),
                                       vc.float(), 300)
        kern = kdec.decode_step_fused(sem_cfg, q16, 4321, kc.clone(),
                                      vc.clone(), 300)
        plain = kdec.decode_step_plain(sem_cfg, q16, 4321, kc.clone(),
                                       vc.clone(), 300)
        report(f"{K5} {draw} n_past 300", kern, plain, truth)
        del sem_q, coarse_q, q32, q16
        torch.cuda.empty_cache()


def kv8_cache(cfg, rows: int, gen, batch=None):
    """Int8 KV caches on the card (`gpt.init_kv_cache(quant=True)`) whose
    rows [0, rows) of every lane hold random rows quantized by the plain
    `gpt.quantize_kv_rows`."""
    import torch

    from bark_tpu_torch.models import gpt

    kc, vc = gpt.init_kv_cache(cfg, None, gen.device, batch=batch,
                               quant=True)
    for c in (kc, vc):
        live = c["q"][..., :rows, :]
        q, s = gpt.quantize_kv_rows(torch.randn(live.shape, generator=gen,
                                                device=gen.device))
        c["q"][..., :rows, :] = q
        c["s"][..., :rows] = s
        del q, s
    return kc, vc


def kv8_clone(c):
    return {k: v.clone() for k, v in c.items()}


def record_kv8_rows(checks, kernel, name, what, pairs, chained=False):
    """Phase 2's check of the int8 cache rows a kernel wrote against those
    its plain version wrote, `pairs` of (kernel's, plain's) {"q", "s"}
    views. Both quantize fresh rows computed in another summation order,
    so a value next to a rounding boundary may land one step apart. f32
    rows computed from the checked inputs alone (a decode step's rows at
    n_past > 0): bytes at most one step apart at no more than 1% of the
    values (a wrong scale moves values by more than a step, a wrong
    rounding rule about half of them), scales (a row's amax / 127) within
    TOL / 127. `chained` f32 rows, computed from other fresh int8 rows (a
    prefill's later rows and layers, a window's later steps, a lane's later
    layers at n_past 0), where one flip perturbs the rows after it, and
    bf16 rows (a one-ulp flip of a bf16 value moves it by up to ~2 steps):
    the dequantized rows within the bf16 TOL, a few steps at most. The
    flips are counted in every case."""
    flips = n = 0
    dq = ds = deq = 0.0
    for got, want in pairs:
        d = (got["q"].int() - want["q"].int()).abs()
        flips += int((d > 0).sum())
        n += d.numel()
        dq = max(dq, float(d.max()))
        ds = max(ds, max_err(got["s"], want["s"]))
        deq = max(deq, max_err(got["q"].float() * got["s"][..., None],
                               want["q"].float() * want["s"][..., None]))
    key = (kernel, name)
    f0, n0 = checks.kv8_flips.get(key, (0, 0))
    checks.kv8_flips[key] = (f0 + flips, n0 + n)
    log(f"  {kernel:26s} {name:9s} {what:34s} int8 flips {flips}/{n}, max "
        f"|dq| {dq:.0f}, scales {ds:.1e}, dequantized {deq:.3e}")
    if name == "float32" and not chained:
        if dq > 1 or flips > max(1, int(1e-2 * n)) or ds > TOL[name] / 127:
            raise AssertionError(f"{kernel} {name} {what}: int8 rows differ")
    elif name == "float32":
        if deq > TOL["bfloat16"]:
            raise AssertionError(f"{kernel} {name} {what}: dequantized rows "
                                 f"{deq} > {TOL['bfloat16']}")
    else:
        checks.record(kernel, name, f"{what} (dequantized)", deq)


def device_ms(fn, n: int) -> float:
    """cuda_ms of fn() behind a ~0.1 s device sleep, so that the n calls'
    launches queue up and the host's work between them is not timed."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    return cuda_ms(fn, n)


def k6a_alone_checks(checks: Checks, dtype, timed: bool):
    """K6a on its own (`kv8.attn_decode`: one layer's decode attention of
    B lanes) against its plain version on the same qkv rows, at bark-small's
    width: B 1, 8 and 32 at n_past cycling 0/300/1023. Both quantize the
    same fresh rows and queries, so the written int8 rows and scales must be
    bit-equal (the one-step flips of the whole-step checks come from fresh
    values that kernel and plain version compute in another order), and the
    context within TOL. Timed in bf16 at B 8 and 32, n_past 300, beside the
    dense attention kernel (K1's and K7's) on bf16 caches."""
    import dataclasses

    import torch

    from bark_tpu_torch.kernels import kv8
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.models.presets import BARK_SMALL

    dev = torch.device("cuda")
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    cfg = dataclasses.replace(BARK_SMALL["semantic"], n_layer=1)
    D, S = cfg.n_embd, cfg.block_size
    gen = torch.Generator(device=dev).manual_seed(41)
    for B in (1, 8, 32):
        n_past = [(0, 300, 1023)[b % 3] for b in range(B)]
        qkv = torch.randn((B, 3 * D), generator=gen, device=dev).to(dtype)
        kc, vc = (gpt.kv_view(c, 0)
                  for c in kv8_cache(cfg, S - 1, gen, batch=B))
        kc2, vc2 = kv8_clone(kc), kv8_clone(vc)
        ctx = kv8.attn_decode(cfg, qkv, kc, vc, n_past)
        ref = kv8.attn_decode_plain(cfg, qkv, kc2, vc2, n_past)
        checks.record(K6A, name, f"context B {B}", max_err(ctx, ref))
        same = all(torch.equal(a[k], b[k]) for a, b in ((kc, kc2), (vc, vc2))
                   for k in ("q", "s"))
        log(f"  {K6A:26s} {name:9s} {f'K/V rows B {B}':34s} bit-equal "
            f"{same}")
        if not same:
            raise AssertionError(f"{K6A} {name} B={B}: cache rows differ")
    if not timed:
        return
    for B in KV8_BATCHES:
        qkv = torch.randn((B, 3 * D), generator=gen, device=dev).to(dtype)
        slots = torch.full((B,), 300, dtype=torch.int32, device=dev)
        kq, vq = (gpt.kv_view(c, 0) for c in kv8_cache(cfg, 300, gen,
                                                        batch=B))
        kd, vd = ((c["q"].float() * c["s"][..., None]).to(dtype)
                  for c in (kq, vq))
        for label, kc, vc in (("int8", kq, vq), ("bf16", kd, vd)):
            ms = device_ms(lambda: kv8.attn_decode(cfg, qkv, kc, vc, slots),
                           100)
            plain = cuda_ms(lambda: kv8.attn_decode_plain(
                cfg, qkv, kc, vc, [300] * B), 3)
            rows = B * 301 * kv_row_bytes(D, 2, label == "int8")
            cost = (2 * rows + nbytes(qkv) + B * D * 2,
                    B * 4 * D * 301)
            checks.times[f"{K6A if label == 'int8' else ATTN} [B={B}]"] = (
                ms, plain, cost)
            log(f"  attention alone, {label} cache, B={B}, n_past 300: "
                f"{ms:.4f} ms (plain {plain:.3f} ms, bound "
                f"{bound(cost, name)[0]:.4f} ms)")


K6C_T = (1, 63, 64, 65, 257, 437, 617, 887, 1024)  # K6c alone, one lane
K6C_MIXED = (887, 257, 600, 431, 800, 350, 700, 500)  # lanes' n_valid


def attn_prefill_cost(D: int, lanes, item: int, kv8: bool):
    """(bytes, flops) of one layer's causal prefill attention over lanes of
    n rows: the query rows read and the context written in the params
    dtype, each lane's n cache rows of K and V read (int8 rows and their
    scales when kv8); 2 D n (n + 1) flops a lane (QK^T and PV over the
    causal pairs, all heads)."""
    rows = sum(lanes)
    return (2 * rows * D * item + 2 * rows * kv_row_bytes(D, item, kv8),
            sum(2 * D * n * (n + 1) for n in lanes))


def k6c_alone_checks(checks: Checks, dtype, timed: bool):
    """K6c on its own (`kv8.attn_prefill`: one layer's causal prefill
    attention on an int8 cache, the prefills' launch) against its plain
    version on the same query rows and caches, at bark-small's width (12
    heads of 64, 1024 slots): one lane at T in K6C_T, K8's 8 lanes of
    257-887 rows and 32 lanes; the context in f32 within TOL, in bf16
    element by element within K6C_RTOL |plain| + K6C_ATOL, two bf16 runs
    bit-equal. Timed in bf16 at T 887 and 8 x 887 beside the same entry on
    the bf16 cache (the dense attention, `attn_prefill_tc_kernel` on
    DenseTiles) at the same shapes, the stacked lanes' tables uploaded
    once before the timed calls, into `checks.k6c`."""
    import dataclasses

    import torch

    from bark_tpu_torch.kernels import kv8
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.models.presets import BARK_SMALL

    dev = torch.device("cuda")
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    cfg = dataclasses.replace(BARK_SMALL["coarse"], n_layer=1)
    D = cfg.n_embd
    gen = torch.Generator(device=dev).manual_seed(43)
    cases = [[T] for T in K6C_T] + [list(K6C_MIXED),
                                    [K6C_MIXED[b % 8] for b in range(32)]]
    for lanes in cases:
        B = len(lanes)
        kc, vc = (gpt.kv_view(c, 0) for c in kv8_cache(cfg, max(lanes), gen,
                                                        batch=B))
        n = lanes
        if B == 1:
            kc, vc, n = gpt.kv_view(kc, 0), gpt.kv_view(vc, 0), lanes[0]
        q = torch.randn((sum(lanes), D), generator=gen, device=dev).to(dtype)
        ctx = kv8.attn_prefill(cfg, q, kc, vc, n)
        ref = kv8.attn_prefill_plain(cfg, q, kc, vc, n)
        what = (f"T {lanes[0]}" if B == 1 else
                f"{B} lanes, n_valid {min(lanes)}-{max(lanes)}")
        if dtype == torch.bfloat16:
            checks.record_close(K6C, name, f"context {what}", ctx, ref,
                                K6C_RTOL, K6C_ATOL)
        else:
            checks.record(K6C, name, f"context {what}", max_err(ctx, ref))
        if dtype == torch.bfloat16:
            same_bits(f"{K6C} bf16 {what}", (ctx,),
                      (kv8.attn_prefill(cfg, q, kc, vc, n),))
        del kc, vc
    if not timed:
        return
    for label, lanes in (("887", [887]), ("8 x 887", [887] * 8)):
        B = len(lanes)
        kq, vq = (gpt.kv_view(c, 0) for c in kv8_cache(cfg, 887, gen,
                                                        batch=B))
        n = lanes
        if B == 1:
            kq, vq, n = gpt.kv_view(kq, 0), gpt.kv_view(vq, 0), lanes[0]
        kd, vd = ((c["q"].float() * c["s"][..., None]).to(dtype)
                  for c in (kq, vq))
        q = torch.randn((sum(lanes), D), generator=gen, device=dev).to(dtype)
        tables = (None if B == 1 else
                  kv8.attn_prefill_tables(lanes, cfg.block_size, dev))
        rec = {}
        for kv, kc, vc in (("int8", kq, vq), ("bf16", kd, vd)):
            ms = device_ms(lambda: kv8.attn_prefill(cfg, q, kc, vc, n,
                                                    tables=tables), 50)
            plain = cuda_ms(lambda: kv8.attn_prefill_plain(cfg, q, kc, vc, n),
                            3)
            cost = attn_prefill_cost(D, lanes, 2, kv == "int8")
            bound_ms, bound_by = bound(cost, name)
            rec[kv] = dict(ms=ms, plain_ms=plain, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=cost[0], flops=cost[1])
            log(f"  prefill attention alone, {kv} cache, {label} rows: "
                f"{ms:.4f} ms (plain {plain:.3f} ms, bound {bound_ms:.4f} ms, "
                f"{bound_by})")
        checks.k6c[label] = dict(lanes=B, rows=lanes[0], **rec["int8"],
                                 library_ms=None,
                                 bf16_cache_attention=rec["bf16"])
        del kq, vq, kd, vd


def kv8_kernel_checks(checks: Checks, dtype, timed: bool):
    """Phase 2 for K6, one dtype: every kernel that reads or writes the
    int8 cache (K6a inside K1, K5 and K7; K6b and K6c inside K2 and K8;
    and K3, K4, K9, K10 over them) against its plain version on int8
    caches filled by the plain `gpt.quantize_kv_rows`, at bark-small
    shapes: K1 at n_past 0/300/1023 and 300 on the coarse window; K5 q4_0
    at 300; K7 at B 1/8/32 with n_past cycling 0/300/1023; K2 at T 257,
    and 437, 617 and 887 windowed; K8 over 8 and 32 lanes of 257-887 rows; K3 16
    steps, K4 60 steps, K9 16 steps of 8 and 32 lanes, K10 60 steps of 8
    lanes and 12 of 32 (tokens equal in f32; bf16 over one step only).
    First K6a and K6c alone (`k6a_alone_checks`, `k6c_alone_checks`). The
    logits against TOL (TOL_KV8_FIRST for lanes at n_past 0), the cache
    rows by `record_kv8_rows`. Timed in bf16: K1, K5 and K7 at n_past 300,
    K2 at 887 rows, K8 over 8 x 887 rows."""
    import torch

    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import bprefill as kbpre
    from bark_tpu_torch.kernels import bsemantic as kbsem
    from bark_tpu_torch.kernels import bwindow as kbwin
    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.kernels import kv8
    from bark_tpu_torch.kernels import prefill as kpre
    from bark_tpu_torch.kernels import semantic as ksem
    from bark_tpu_torch.kernels import window as kwin
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.ops import sampling

    dev = torch.device("cuda")
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    gen = torch.Generator(device=dev).manual_seed(37)
    sem_cfg, coarse_cfg = phase2_cfgs(dtype)
    svs, cbs = 10000, 1024
    lmw = (svs, svs + 2 * cbs)
    k6a_alone_checks(checks, dtype, timed)
    k6c_alone_checks(checks, dtype, timed)
    sem_p = random_stage_params(sem_cfg, gen, dtype)
    coarse_p = random_stage_params(coarse_cfg, gen, dtype)
    sem_q = random_qpack(sem_cfg, "q4_0", dtype, gen, dev)

    # K1 and K5: one step, its row of every layer
    for kname, cfg, p, n_past, win in (
            (K6_K1, sem_cfg, sem_p, 0, None),
            (K6_K1, sem_cfg, sem_p, 300, None),
            (K6_K1, sem_cfg, sem_p, 1023, None),
            (K6_K1, coarse_cfg, coarse_p, 300, lmw),
            (K6_K5, sem_cfg, sem_q, 300, None)):
        kc, vc = kv8_cache(cfg, n_past, gen)
        kc2, vc2 = kv8_clone(kc), kv8_clone(vc)
        before = kv8.launches
        out = kdec.decode_step_fused(cfg, p, 1234, kc, vc, n_past,
                                     lm_window=win)
        if kv8.launches != before + 1:
            raise AssertionError(f"{kname} did not count a K6 launch")
        ref = kdec.decode_step_plain(cfg, p, 1234, kc2, vc2, n_past, win)
        tag = f"n_past {n_past}" + (" lm_window" if win else "")
        first = n_past == 0  # held as K7's lanes at n_past 0
        checks.record(f"{kname} n_past 0" if first else kname, name,
                      f"logits {tag}", max_err(out, ref),
                      tol=TOL_KV8_FIRST if first else None)
        rows = (slice(None), n_past)
        record_kv8_rows(checks, kname, name, f"K/V row {tag}", [
            (gpt.kv_view(kc, rows), gpt.kv_view(kc2, rows)),
            (gpt.kv_view(vc, rows), gpt.kv_view(vc2, rows))], chained=first)
        del kc, vc, kc2, vc2
    if timed:
        tok_t = torch.tensor([1234], dtype=torch.int32, device=dev)
        for kname, p in ((K6_K1, sem_p), (K6_K5, sem_q)):
            kc, vc = kv8_cache(sem_cfg, 300, gen)
            ms = cuda_ms(lambda: kdec.decode_step_fused(
                sem_cfg, p, tok_t, kc, vc, 300), 50)
            plain = cuda_ms(lambda: kdec.decode_step_plain(
                sem_cfg, p, tok_t, kc, vc, 300), 10)
            checks.times[kname] = (ms, plain,
                                   decode_cost(sem_cfg, p, 300, kv8=True))
    del sem_q
    torch.cuda.empty_cache()

    # K7: B 1, 8, 32 lanes at n_past cycling 0/300/1023, and 8 windowed
    for cfg, p, B, win in ((sem_cfg, sem_p, 1, None),
                           (sem_cfg, sem_p, 8, None),
                           (sem_cfg, sem_p, 32, None),
                           (coarse_cfg, coarse_p, 8, lmw)):
        n_past = [(0, 300, 1023)[b % 3] for b in range(B)]
        toks = torch.randint(0, cfg.n_in_vocab, (B,), generator=gen,
                             device=dev, dtype=torch.int32)
        kc, vc = kv8_cache(cfg, 1023, gen, batch=B)
        kc2, vc2 = kv8_clone(kc), kv8_clone(vc)
        out = kbdec.decode_step_fused_batched(cfg, p, toks, kc, vc, n_past,
                                              lm_window=win)
        ref = kbdec.decode_step_batched_plain(cfg, p, toks, kc2, vc2, n_past,
                                              win)
        tag = f"B {B}" + (" lm_window" if win else "")
        # lanes at n_past 0 apart: TOL_KV8_FIRST, and their rows chained
        for first in (False, True):
            lanes = [b for b, n in enumerate(n_past) if (n == 0) == first]
            if not lanes:
                continue
            what = f"{tag}, n_past {'0' if first else '> 0'} lanes"
            checks.record(f"{K6_K7} n_past 0" if first else K6_K7, name,
                          f"logits {what}", max_err(out[lanes], ref[lanes]),
                          tol=TOL_KV8_FIRST if first else None)
            pairs = [(gpt.kv_view(c, (slice(None), b, n_past[b])),
                      gpt.kv_view(c2, (slice(None), b, n_past[b])))
                     for b in lanes for c, c2 in ((kc, kc2), (vc, vc2))]
            record_kv8_rows(checks, K6_K7, name, f"K/V rows {what}", pairs,
                            chained=first)
        del kc, vc, kc2, vc2
    if timed:
        for B in KV8_BATCHES:
            kc, vc = kv8_cache(sem_cfg, 300, gen, batch=B)
            toks = torch.randint(0, sem_cfg.n_in_vocab, (B,), generator=gen,
                                 device=dev, dtype=torch.int32)
            slots = _build.device_ints([300] * B, dev)
            ms = cuda_ms(lambda: kbdec.decode_step_fused_batched(
                sem_cfg, sem_p, toks, kc, vc, slots), 50)
            plain = cuda_ms(lambda: kbdec.decode_step_batched_plain(
                sem_cfg, sem_p, toks, kc, vc, [300] * B), 1 if B > 8 else 3)
            checks.times[f"{K6_K7}[B={B}]"] = (
                ms, plain, decode_cost(sem_cfg, sem_p, 300, lanes=B, kv8=True))
            del kc, vc
    torch.cuda.empty_cache()

    # K2 (T 257; 437, 617 and 887 windowed) and K8 (8 x 887, 32 lanes of
    # 257-887)
    mixed = K6C_MIXED
    for cfg, p, n_valid, win in (
            (sem_cfg, sem_p, 257, None), (coarse_cfg, coarse_p, 437, lmw),
            (coarse_cfg, coarse_p, 617, lmw), (coarse_cfg, coarse_p, 887, lmw),
            (coarse_cfg, coarse_p, [887] * 8, lmw),
            (coarse_cfg, coarse_p, [mixed[b % 8] for b in range(32)], lmw)):
        single = isinstance(n_valid, int)
        if single:
            n_valid = [n_valid]
        B, T = len(n_valid), max(n_valid)
        x_emb = p["wte"][0][torch.randint(
            0, cfg.n_in_vocab, (B * T,), generator=gen, device=dev)].reshape(
            B, T, cfg.n_embd)
        kc, vc = gpt.init_kv_cache(cfg, None, dev, batch=B, quant=True)
        kc2, vc2 = kv8_clone(kc), kv8_clone(vc)
        if single:
            kname = K6_K2
            lane = lambda c: gpt.kv_view(c, (slice(None), 0))  # noqa: E731
            run = lambda: kpre.prefill_fused(  # noqa: E731
                cfg, p, x_emb[0], lane(kc), lane(vc), T, lm_window=win)
            out = run()
            ref = kpre.prefill_plain(cfg, p, x_emb[0], lane(kc2), lane(vc2),
                                     T, win)
        else:
            kname = K6_K8
            run = lambda: kbpre.prefill_fused_batched(  # noqa: E731
                cfg, p, x_emb, kc, vc, n_valid, lm_window=win)
            out = run()
            ref = kbpre.prefill_batched_plain(cfg, p, x_emb, kc2, vc2,
                                              n_valid, win)
        tag = (f"{B} lanes, n_valid {min(n_valid)}-{max(n_valid)}"
               + (" lm_window" if win else ""))
        checks.record(kname, name, f"logits {tag}", max_err(out, ref))
        pairs = []
        for b, n in enumerate(n_valid):
            for c, c2 in ((kc, kc2), (vc, vc2)):
                idx = (slice(None), b, slice(0, n))
                pairs.append((gpt.kv_view(c, idx), gpt.kv_view(c2, idx)))
        record_kv8_rows(checks, kname, name, f"K/V rows {tag}", pairs,
                        chained=True)
        prefill_rows_kept(kc, vc, n_valid, f"{kname} {name} {tag}")
        if dtype == torch.bfloat16:
            kc3, vc3 = gpt.init_kv_cache(cfg, None, dev, batch=B, quant=True)
            if single:
                again = kpre.prefill_fused(cfg, p, x_emb[0], lane(kc3),
                                           lane(vc3), T, lm_window=win)
            else:
                again = kbpre.prefill_fused_batched(
                    cfg, p, x_emb, kc3, vc3, n_valid, lm_window=win)
            same_bits(f"{kname} bf16 {tag}", (out, kc, vc),
                      (again, kc3, vc3))
            del kc3, vc3
        if timed and (single and T == 887 or n_valid == [887] * 8):
            ms = cuda_ms(run, 10 if single else 5)
            plain = cuda_ms(lambda: kbpre.prefill_batched_plain(
                cfg, p, x_emb, kc2, vc2, n_valid, win), 1 if B > 1 else 3)
            checks.times[kname] = (ms, plain, prefill_cost(
                cfg, p, n_valid if B > 1 else T, win, kv8=True))
        del x_emb, kc, vc, kc2, vc2
    torch.cuda.empty_cache()

    # K3 (16 steps) and K9 (16 steps of 8 and 32 lanes) from 257-row
    # prompts; K4 (60 steps) and K10 (60 steps of 8 lanes, 12 of 32) from
    # contexts of 887 rows (257-887 across lanes); temp 0.7, step parity odd
    for B in (1, 8, 32):
        noise = sampling.gumbel((B, 32, sem_cfg.n_out_vocab), gen, dev)
        logits0 = torch.randn((B, sem_cfg.n_out_vocab), generator=gen,
                              device=dev)
        kc0, vc0 = kv8_cache(sem_cfg, 257, gen, batch=B)
        for K in ((16,) if dtype == torch.float32 else (1,)):
            kw = dict(K=K, temp=0.7, semantic_vocab_size=svs)
            kc, vc, kc2, vc2 = (kv8_clone(c) for c in (kc0, vc0, kc0, vc0))
            if B == 1:
                lane = lambda c: gpt.kv_view(c, (slice(None), 0))  # noqa: E731
                args = (257, 3, noise[0], 2.0)
                got = ksem.semantic_chunk_fused(
                    sem_cfg, sem_p, logits0[0], lane(kc), lane(vc), *args,
                    **kw)
                want = ksem.semantic_chunk_plain(
                    sem_cfg, sem_p, logits0[0], lane(kc2), lane(vc2), *args,
                    **kw)
            else:
                args = (257, 3, noise, 2.0)
                got = kbsem.semantic_chunk_fused_batched(
                    sem_cfg, sem_p, logits0, kc, vc, *args, **kw)
                want = kbsem.semantic_chunk_batched_plain(
                    sem_cfg, sem_p, logits0, kc2, vc2, *args, **kw)
            kname = K6_K3 if B == 1 else K6_K9
            same = bool((got[0].cpu() == want[0].cpu()).all()
                        and (got[1].cpu() == want[1].cpu()).all())
            log(f"  {kname:26s} {name:9s} B={B} K={K}: tokens and flags "
                f"equal {same}")
            if dtype == torch.float32 or K == 1:
                if not same:
                    raise AssertionError(f"{kname} {name} B={B} K={K}: "
                                         f"tokens/flags differ")
                checks.record(kname, name, f"logits, {B} lanes, {K} steps",
                              max_err(got[2], want[2]))
            del kc, vc, kc2, vc2
        del noise, kc0, vc0
    torch.cuda.empty_cache()
    cycle = [887, 700, 500, 257]
    for ctx_len, steps in (([887], 60), ([887] * 8, 60),
                           ([cycle[b % 4] for b in range(32)], 12)):
        B = len(ctx_len)
        noise = sampling.gumbel((steps, B, cbs), gen, dev)
        logits0 = torch.randn((B, coarse_cfg.n_out_vocab), generator=gen,
                              device=dev)
        kc0, vc0 = kv8_cache(coarse_cfg, 887, gen, batch=B)
        for sws in ((steps,) if dtype == torch.float32 else (1,)):
            kw = dict(sws=sws, temp=0.7, semantic_vocab_size=svs,
                      codebook_size=cbs, lm_window=lmw)
            kc, vc, kc2, vc2 = (kv8_clone(c) for c in (kc0, vc0, kc0, vc0))
            if B == 1:
                lane = lambda c: gpt.kv_view(c, (slice(None), 0))  # noqa: E731
                toks = kwin.coarse_window_fused(
                    coarse_cfg, coarse_p, logits0[0], lane(kc), lane(vc), 887,
                    1, noise[:sws, 0], **kw)
                rtoks = kwin.coarse_window_plain(
                    coarse_cfg, coarse_p, logits0[0], lane(kc2), lane(vc2),
                    887, 1, noise[:sws, 0], **kw)
            else:
                toks = kbwin.coarse_window_fused_batched(
                    coarse_cfg, coarse_p, logits0, kc, vc, ctx_len, 1,
                    noise[:sws], **kw)
                rtoks = kbwin.coarse_window_batched_plain(
                    coarse_cfg, coarse_p, logits0, kc2, vc2, ctx_len, 1,
                    noise[:sws], **kw)
            kname = K6_K4 if B == 1 else K6_K10
            same = int((toks.cpu() == rtoks.cpu()).sum())
            log(f"  {kname:26s} {name:9s} B={B} sws={sws}: tokens equal "
                f"{same}/{B * sws}")
            if dtype == torch.float32 or sws == 1:
                if same != B * sws:
                    raise AssertionError(f"{kname} {name} B={B} sws={sws}: "
                                         f"tokens differ")
                pairs = []
                for b, c0 in enumerate(ctx_len):
                    idx = (slice(None), b, slice(c0, c0 + sws))
                    for c, c2 in ((kc, kc2), (vc, vc2)):
                        pairs.append((gpt.kv_view(c, idx), gpt.kv_view(c2, idx)))
                record_kv8_rows(checks, kname, name,
                                f"K/V rows, {B} lanes, {sws} steps", pairs,
                                chained=sws > 1)
            del kc, vc, kc2, vc2
        del noise, kc0, vc0
    torch.cuda.empty_cache()


def small_model_trees():
    """A small model (2 layers, width 128, head dim 64, a tiny token space
    and codec): {stage: (cfg, f32 numpy params)} and (codec cfg, f32 numpy
    codec params), drawn on the host from fixed seeds, so every device
    gets the same weights."""
    import numpy as np

    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.models.config import CodecConfig, GPTConfig

    def stage(seed, **kw):
        cfg = GPTConfig(n_layer=2, n_head=2, n_embd=128, bias=True, **kw)
        tree = gpt.init_params_numpy(cfg, seed, scale=0.08)
        rng = np.random.RandomState(seed + 100)
        for k, v in tree["blocks"].items():  # non-zero biases
            if k.endswith("_b") and not k.startswith("ln"):
                tree["blocks"][k] = (rng.randn(*v.shape) * 0.08).astype(
                    np.float32)
        return cfg, tree

    codec_cfg = CodecConfig(hidden_dim=16, n_filters=2, n_bins=8, n_q_total=8)
    stages = dict(
        semantic=stage(1, block_size=320, n_in_vocab=182, n_out_vocab=16),
        coarse=stage(2, block_size=384, n_in_vocab=34, n_out_vocab=32),
        fine=stage(3, block_size=64, n_in_vocab=9, n_out_vocab=9,
                   n_lm_heads=7, n_wtes=8),
    )
    return stages, (codec_cfg, loader.codec_init_params_numpy(
        codec_cfg, 4, scale=0.15))


def small_model_parts(device):
    """The small model as `BarkContext.from_parts` takes it, on device."""
    import torch

    from bark_tpu_torch.io import loader

    stages, (codec_cfg, codec_tree) = small_model_trees()
    parts = {name: (cfg, loader.params_from_numpy(tree, torch.float32,
                                                  device))
             for name, (cfg, tree) in stages.items()}
    return dict(
        vocab_tokens=SMALL_VOCAB, **parts, codec_cfg=codec_cfg,
        codec_params=loader.params_from_numpy(codec_tree, torch.float32,
                                              device),
    )


_GPT_NAMES = {  # params key -> tensor name under model/h{i}/
    "ln1_g": "ln_1/g", "ln1_b": "ln_1/b", "ln2_g": "ln_2/g",
    "ln2_b": "ln_2/b", "qkv_w": "attn/c_attn/w", "qkv_b": "attn/c_attn/b",
    "proj_w": "attn/c_proj/w", "proj_b": "attn/c_proj/b",
    "fc_w": "mlp/c_fc/w", "fc_b": "mlp/c_fc/b", "out_w": "mlp/c_proj/w",
    "out_b": "mlp/c_proj/b",
}


def write_small_model(path: str) -> None:
    """The small model as an f32 ggml_weights.bin (the layout the port's
    loader reads back: projections stored (out, in), the codec's decoder
    and RVQ tensors under their converter names)."""
    import numpy as np

    from bark_tpu_torch.io import ggml

    def records(items):
        return {n: ggml.TensorRecord.from_array(
            n, np.ascontiguousarray(a, np.float32), ggml.GGMLType.F32)
            for n, a in items}

    def gpt_section(cfg, tree):
        items = [(f"model/wte/{i}", t) for i, t in enumerate(tree["wte"])]
        items += [("model/wpe", tree["wpe"]),
                  ("model/ln_f/g", tree["ln_f_g"]),
                  ("model/ln_f/b", tree["ln_f_b"])]
        items += [(f"model/lm_head/{i}", t)
                  for i, t in enumerate(tree["lm_head"])]
        for l in range(cfg.n_layer):
            items += [(f"model/h{l}/{n}", tree["blocks"][k][l].T
                       if k.endswith("_w") else tree["blocks"][k][l])
                      for k, n in _GPT_NAMES.items()]
        hp = ggml.GPTHParams(
            n_layer=cfg.n_layer, n_head=cfg.n_head, n_embd=cfg.n_embd,
            block_size=cfg.block_size, bias=int(cfg.bias),
            n_in_vocab=cfg.n_in_vocab, n_out_vocab=cfg.n_out_vocab,
            n_lm_heads=cfg.n_lm_heads, n_wtes=cfg.n_wtes, ftype=0)
        return ggml.GPTSection(hparams=hp, tensors=records(items))

    def conv(name, w, b):
        return [(f"{name}.weight", w), (f"{name}.bias", b)]

    stages, (ccfg, ctree) = small_model_trees()
    dec = ctree["decoder"]
    items = [(f"quantizer.vq.layers.{i}._codebook.embed", e)
             for i, e in enumerate(ctree["quantizer"])]
    items += conv("decoder.model.0.conv.conv", dec["conv_in_w"],
                  dec["conv_in_b"])
    for l, lstm in enumerate(dec["lstm"]):
        items += [(f"decoder.model.1.lstm.{k}_l{l}", lstm[v]) for k, v in (
            ("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
            ("bias_ih", "b_ih"), ("bias_hh", "b_hh"))]
    for i, st in enumerate(dec["stages"]):
        idx = 3 + 3 * i
        items += conv(f"decoder.model.{idx}.convtr.convtr", st["convtr_w"],
                      st["convtr_b"])
        for blk, key in (("block.1", "block1"), ("block.3", "block3"),
                         ("shortcut", "shortcut")):
            items += conv(f"decoder.model.{idx + 1}.{blk}.conv.conv",
                          st[key + "_w"], st[key + "_b"])
    items += conv("decoder.model.15.conv.conv", dec["conv_out_w"],
                  dec["conv_out_b"])
    codec = ggml.CodecSection(
        hparams=ggml.CodecHParams(
            in_channels=ccfg.in_channels, hidden_dim=ccfg.hidden_dim,
            n_filters=ccfg.n_filters, kernel_size=ccfg.kernel_size,
            residual_kernel_size=ccfg.residual_kernel_size,
            n_bins=ccfg.n_bins, bandwidth=6, sample_rate=ccfg.sample_rate,
            ftype=0),
        tensors=records(items))
    ggml.write_model_file(path, ggml.ModelFile(
        vocab=list(SMALL_VOCAB),
        **{n: gpt_section(*stages[n]) for n in ("semantic", "coarse",
                                                 "fine")},
        codec=codec))


# the small model's token space (16 semantic tokens, codebooks of 8)
SMALL_VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "he",
                "##llo", "##rld", "wo", "a", "the"]
               + [f"tok{i}" for i in range(20)])
SMALL_PARAMS = dict(
    temp=0.7, fine_temp=0.5, min_eos_p=2.0, sliding_window_size=60,
    max_coarse_history=60, n_steps_text_encoder=12, text_pad_token=180,
    text_encoding_offset=100, semantic_pad_token=16, semantic_vocab_size=16,
    semantic_infer_token=181, coarse_infer_token=33,
    coarse_semantic_pad_token=32, codebook_size=8, compute_dtype="float32",
)


def small_model_reference(packed_path=None, kv8: bool = False):
    """Phase 3: the small model generates on the GPU through the kernels
    and on the CPU through the plain versions, in f32 with the same noise:
    tokens must be equal, audio within 1e-3 (cuDNN's convolutions and LSTM
    sum in another order). With `packed_path` (a quantized model file) it
    is loaded with dequantize_on_load=False, so the GPU run decodes through
    K5; otherwise the dense parts are given directly. kv8: with the int8
    KV cache, so the GPU run goes through K6 (which must launch). The GPU
    run's semantic chunks and coarse windows must each be one launch of
    the step loop (K1's, or K5's when packed), with no other step."""
    import numpy as np
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch import kernels
    from bark_tpu_torch.kernels import kv8 as kkv8
    from bark_tpu_torch.ops import sampling

    runs = {}
    for device in ("cpu", "cuda"):
        params = bt.BarkContextParams(
            **SMALL_PARAMS, dequantize_on_load=not packed_path,
            kv_cache_dtype="int8" if kv8 else "params")
        if packed_path:
            ctx = bt.bark_load_model(packed_path, params, seed=0,
                                     device=device)
            for stage in ("semantic", "coarse", "fine"):
                if "wte_q" not in getattr(ctx, stage + "_params"):
                    raise AssertionError(f"{stage} did not load packed")
        else:
            ctx = bt.BarkContext.from_parts(
                **small_model_parts(device), params=params, seed=0,
                device=device)
        # both runs draw the same noise on the CPU, in the same order
        gen = torch.Generator().manual_seed(11)
        ctx.noise_source = (
            lambda stage, shape, g=gen, d=device:
            sampling.gumbel(shape, g, "cpu").to(d)
        )
        kernels.reset_launches()
        if not bt.bark_generate_audio(ctx, "hello world"):
            raise AssertionError(f"small model generate failed on {device}")
        counts = kernels.launch_counts()
        loop = loop_counts(packed=bool(packed_path))
        if device == "cuda" and (
                min(counts["semantic"], counts["window"]) <= 0
                or loop != (counts["semantic"] + counts["window"], 0)):
            raise AssertionError(f"small model: the chunks and windows were "
                                 f"not one step-loop launch each (on the "
                                 f"{'packed' if packed_path else 'dense'} "
                                 f"read): {counts}, loop {loop}")
        if kv8 and device == "cuda" and kkv8.launches == 0:
            raise AssertionError("the kv8 small model did not launch K6")
        runs[device] = ctx
    cpu, gpu = runs["cpu"], runs["cuda"]
    for name in ("semantic_tokens", "coarse_tokens", "fine_tokens"):
        if not np.array_equal(getattr(cpu, name), getattr(gpu, name)):
            raise AssertionError(f"small model: {name} differ CPU vs GPU")
    audio = bt.bark_get_audio_data(gpu)
    err = float(np.abs(bt.bark_get_audio_data(cpu) - audio).max())
    log(f"  small model{' (q8_0, packed)' if packed_path else ''}"
        f"{' (int8 KV)' if kv8 else ''}: tokens "
        f"equal in all stages, audio max|err| {err:.3e} (tol 1e-3), "
        f"{audio.size} samples")
    if err > 1e-3 or not np.isfinite(audio).all():
        raise AssertionError(f"small model audio differs: {err}")


def small_model_batched_reference(kv8: bool = False, packed_path=None):
    """Phase 3, batched: `generate_audio_batch` of 3 prompts on the small
    model through K7-K10 on the GPU and through their plain versions on
    the CPU, f32, with the same per-lane noise: every lane's semantic,
    coarse and fine tokens equal, audio within 1e-3. kv8: with the int8
    KV cache (K6 inside K7 and K8). `packed_path`: a quantized model file
    loaded with dequantize_on_load=False, so the GPU run decodes through
    K5-batched's packed read. Each chunk and window must be one launch of
    the batched step loop on the read (K9, K10), and no other batched
    step may launch."""
    import numpy as np
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch import kernels
    from bark_tpu_torch.ops import sampling

    texts = ["hello world", "the a", "world hello the a"]
    runs = {}
    for device in ("cpu", "cuda"):
        params = bt.BarkContextParams(
            **SMALL_PARAMS, dequantize_on_load=not packed_path,
            kv_cache_dtype="int8" if kv8 else "params")
        if packed_path:
            ctx = bt.bark_load_model(packed_path, params, seed=0,
                                     device=device)
            for stage in ("semantic", "coarse", "fine"):
                if "wte_q" not in getattr(ctx, stage + "_params"):
                    raise AssertionError(f"{stage} did not load packed")
        else:
            ctx = bt.BarkContext.from_parts(
                **small_model_parts(device), params=params, seed=0,
                device=device)
        ctx.lane_noise_source = (
            lambda stage, lane, shape, d=device: sampling.gumbel(
                shape, torch.Generator().manual_seed(
                    100 * lane + len(stage)), "cpu").to(d))
        kernels.reset_launches()
        runs[device] = ctx._generate_batch(texts)
        if device == "cuda":
            counts = kernels.launch_counts()
            loop = lane_counts(packed=bool(packed_path))
            if min(counts[m] for m in ("bprefill", "bsemantic", "bwindow")
                   + ("kv8",) * kv8) <= 0 or loop != (
                       counts["bsemantic"] + counts["bwindow"], 0):
                raise AssertionError(f"small model batch: a batched kernel "
                                     f"was not launched, or a chunk or "
                                     f"window was not one launch of the "
                                     f"batched loop: {counts}, loop {loop}")
    err = 0.0
    for b, (cpu, gpu) in enumerate(zip(runs["cpu"], runs["cuda"])):
        for key in ("semantic", "coarse", "fine"):
            if not np.array_equal(cpu[key], gpu[key]):
                raise AssertionError(f"small model batch lane {b}: {key} "
                                     f"tokens differ CPU vs GPU")
        if cpu["audio"].size == 0 or not np.isfinite(gpu["audio"]).all():
            raise AssertionError(f"small model batch lane {b}: no audio")
        err = max(err, float(np.abs(cpu["audio"] - gpu["audio"]).max()))
    log(f"  small model, batch of {len(texts)}"
        f"{' (q8_0, packed)' if packed_path else ''}"
        f"{' (int8 KV)' if kv8 else ''}: tokens equal in all stages "
        f"and lanes, audio max|err| {err:.3e} (tol 1e-3)")
    if err > 1e-3:
        raise AssertionError(f"small model batch audio differs: {err}")


PROMPTS = ("hello world", "this is a benchmark of the bark pipeline",
           "a speech test")
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "this", "is",
         "a", "benchmark", "of", "the", "bark", "pipeline", "speech", "test"]


def bark_stages(fmt=None, model: str = "small"):
    """The three stages of bark-small (`model` "large": of bark-large) at
    full width on the card, from a seed: random bf16 weights, or with
    `fmt` random qpacks of that format (bf16 dense leaves)."""
    import torch

    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.models import presets

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    preset = {"small": presets.BARK_SMALL, "large": presets.BARK_LARGE}[model]
    return {
        name: (cfg, gpt.init_params(cfg, gen, torch.bfloat16, dev)
               if fmt is None else
               random_qpack(cfg, fmt, torch.bfloat16, gen, dev))
        for name, cfg in preset.items()
    }


# the name the probes call, on this checkout or another (`--tree`)
bark_small_stages = bark_stages


def bark_small_requests(stages, n: int, label: str, need,
                        kv8: bool = False, packed: bool = False):
    """Phases 4, 4b and 4d: n requests on bark-small (`stages`), 138
    semantic steps with the EOS-probability stop off (bench.py's workload),
    at PyTorch's default precision settings (cuDNN TF32 on for the f32
    codec, matmul TF32 off), driven with the launch counts set to 0 just
    before and read just after. Every kernel module in `need` must have
    been launched; each semantic chunk and coarse window must have been
    one launch of the step loop (K1's, or K5's when `packed`), and K1's
    and K5's own step and the other read's loop never launched. kv8: with the int8 KV cache, every host launch must
    have run K6 and no plain version may have run. Returns (per-request
    results, counts)."""
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch import kernels
    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models.presets import ENCODEC_24KHZ

    dev = torch.device("cuda")
    codec = loader.params_from_numpy(
        loader.codec_init_params_numpy(ENCODEC_24KHZ, 3), torch.float32, dev)
    params = bt.BarkContextParams(compute_dtype="bfloat16",
                                  n_steps_text_encoder=138, min_eos_p=2.0,
                                  stage_sync=True,
                                  kv_cache_dtype="int8" if kv8 else "params")
    kernels.reset_launches()
    results = []
    with counted_plain_calls() as plain:
        for seed, text in enumerate(PROMPTS[:n], start=1):
            results.append(bark_small_request(stages, codec, params, seed,
                                              text, label))
    counts = kernels.launch_counts()
    log(f"  kernel launches in the {n} {label} requests: {counts}, plain "
        f"calls {plain}")
    if min(counts[m] for m in need) <= 0:
        raise AssertionError(f"a kernel of the {label} path was not "
                             f"launched: {counts}")
    loop = loop_counts(packed=packed)
    if loop != (counts["semantic"] + counts["window"], 0):
        raise AssertionError(f"the {label} path did not run each chunk and "
                             f"window as one launch of the step loop, with "
                             f"no other step: {counts}, loop {loop}")
    if kv8:
        check_kv8_run(label, counts, plain)
    return results, counts


def bark_small_request(stages, codec, params, seed: int, text: str,
                       label: str):
    """One request of `bark_small_requests`; returns its result."""
    import numpy as np
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch.models.presets import ENCODEC_24KHZ

    dev = torch.device("cuda")
    ctx = bt.BarkContext.from_parts(
        vocab_tokens=VOCAB, semantic=stages["semantic"],
        coarse=stages["coarse"], fine=stages["fine"],
        codec_cfg=ENCODEC_24KHZ, codec_params=codec, params=params,
        seed=seed, device=dev,
    )
    if not bt.bark_generate_audio(ctx, text):
        raise AssertionError(f"{label} request {seed} produced no audio")
    audio = bt.bark_get_audio_data(ctx)
    n_frames = ctx.fine_tokens.shape[0]
    if audio.shape != (n_frames * 320,) or not np.isfinite(audio).all():
        raise AssertionError(
            f"{label} request {seed}: audio {audio.shape}, finite "
            f"{np.isfinite(audio).all()}, want ({n_frames * 320},)")
    s = ctx.stats
    result = dict(
        seed=seed, text=text, semantic_tokens=int(s.n_sample_semantic),
        coarse_steps=int(s.n_sample_coarse), frames=n_frames,
        audio_s=audio.size / 24000, eval_s=s.t_eval_us / 1e6,
        semantic_s=s.t_semantic_us / 1e6, coarse_s=s.t_coarse_us / 1e6,
        fine_s=s.t_fine_us / 1e6,
        codec_s=(s.t_eval_us - s.t_semantic_us - s.t_coarse_us
                 - s.t_fine_us) / 1e6,
    )
    log(f"  {label} request {seed}: {json.dumps(result)}")
    return result


# the wrappers whose C calls run K6 when given int8 caches (a chunk's or
# window's, single-lane or batched, is its one launch of the step loop)
K6_HOSTS = ("decode", "qdecode", "semantic", "window", "prefill", "bdecode",
            "qbdecode", "bprefill", "bsemantic", "bwindow")


def check_kv8_run(label: str, counts, plain) -> None:
    """A run at kv8 went through K6 alone: every host launch ran it (the
    K6 count equals the hosts' sum, and is not 0) and no plain version
    ran."""
    hosts = sum(counts[m] for m in K6_HOSTS)
    if counts["kv8"] <= 0 or counts["kv8"] != hosts or any(plain.values()):
        raise AssertionError(f"{label}: K6 launches {counts['kv8']} against "
                             f"{hosts} host launches, plain calls {plain}")


@contextlib.contextmanager
def counted_plain_calls():
    """Count calls of the plain references every plain version of K1-K4
    and K7-K10 runs (`gpt.decode_step`, `gpt.prefill`) inside."""
    from bark_tpu_torch.models import gpt

    calls = {"decode_step": 0, "prefill": 0}
    saved = {k: getattr(gpt, k) for k in calls}

    def counting(k):
        def fn(*a, **kw):
            calls[k] += 1
            return saved[k](*a, **kw)
        return fn

    for k in calls:
        setattr(gpt, k, counting(k))
    try:
        yield calls
    finally:
        for k, f in saved.items():
            setattr(gpt, k, f)


def bark_small_batch(stages, B: int, kv8: bool = False,
                     packed: bool = False):
    """Phases 4c, 4d and 4e: one `generate_audio_batch` of B prompts on
    bark-small (`stages`, dense bf16, or qpacks when `packed`), 138
    semantic steps with the EOS-probability stop off, at PyTorch's default
    precision settings, driven with the launch counts set to 0 just before
    and read just after. K8-K10 must have launched, each chunk (K9) and
    window (K10) as one launch of the batched step loop on the dense (on
    the packed when `packed`) read; K1-K5, K7's and K5-batched's own step
    and the other read's loop must not have launched, and no plain version
    may have run; kv8: with the int8 KV cache, and every K8-K10 launch must
    have run K6. Returns the batch's result."""
    import numpy as np
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch import kernels
    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models.presets import ENCODEC_24KHZ

    dev = torch.device("cuda")
    codec = loader.params_from_numpy(
        loader.codec_init_params_numpy(ENCODEC_24KHZ, 3), torch.float32, dev)
    ctx = bt.BarkContext.from_parts(
        vocab_tokens=VOCAB, semantic=stages["semantic"],
        coarse=stages["coarse"], fine=stages["fine"],
        codec_cfg=ENCODEC_24KHZ, codec_params=codec,
        params=bt.BarkContextParams(
            compute_dtype="bfloat16", n_steps_text_encoder=138,
            min_eos_p=2.0, stage_sync=True,
            kv_cache_dtype="int8" if kv8 else "params"),
        seed=100 + B, device=dev,
    )
    texts = [PROMPTS[b % len(PROMPTS)] for b in range(B)]
    kernels.reset_launches()
    with counted_plain_calls() as plain:
        outs = ctx.generate_audio_batch(texts)
    counts = kernels.launch_counts()
    label = f"{'packed ' if packed else ''}batch of {B}"
    log(f"  {label}: kernel launches {counts}, plain calls {plain}")
    for b, a in enumerate(outs):
        if a.size == 0 or a.size % 320 or not np.isfinite(a).all():
            raise AssertionError(f"{label}, lane {b}: audio {a.shape}, "
                                 f"finite {np.isfinite(a).all()}")
    loop = lane_counts(packed=packed)
    if (min(counts[m] for m in ("bprefill", "bsemantic", "bwindow")) <= 0
            or loop != (counts["bsemantic"] + counts["bwindow"], 0)
            or any(counts[m] for m in ("decode", "qdecode", "prefill",
                                       "semantic", "window"))
            or any(plain.values())):
        raise AssertionError(f"{label} did not run on K8-K10 alone, each "
                             f"chunk and window one launch of the batched "
                             f"loop on the {'packed' if packed else 'dense'}"
                             f" read: {counts}, loop {loop}, plain calls "
                             f"{plain}")
    if kv8:
        check_kv8_run(f"kv8 {label}", counts, plain)
    s = ctx.stats
    audio_s = sum(a.size for a in outs) / 24000
    eval_s = s.t_eval_us / 1e6
    return dict(
        B=B, audio_s=audio_s, eval_s=eval_s,
        rtf_per_request=eval_s / (audio_s / B),
        audio_s_per_wall_s=audio_s / eval_s,
        semantic_s=s.t_semantic_us / 1e6, coarse_s=s.t_coarse_us / 1e6,
        fine_s=s.t_fine_us / 1e6,
        codec_s=(s.t_eval_us - s.t_semantic_us - s.t_coarse_us
                 - s.t_fine_us) / 1e6,
        semantic_tokens=s.n_sample_semantic, coarse_steps=s.n_sample_coarse,
        launches=counts,
    )


def rtf(results) -> float:
    return (sum(r["eval_s"] for r in results)
            / sum(r["audio_s"] for r in results))


def log_requests(label, results):
    for r in results:
        log(f"  {label} request {r['seed']}: eval {r['eval_s']:.3f} s = "
            f"semantic {r['semantic_s']:.3f} + coarse {r['coarse_s']:.3f} + "
            f"fine {r['fine_s']:.3f} + codec/rest {r['codec_s']:.3f} s for "
            f"{r['audio_s']:.3f} s of audio")


# ------------------------------------------------------------ phase 4f

# the filtered requests' sampler on bark-small, and the small model's
# (whose 16-token semantic vocab and 8-code books a top_k of 50 would not
# filter)
FILTERS = dict(top_k=50, top_p=0.95)
SMALL_FILTERS = dict(top_k=5, top_p=0.8)
MAX_STEPS = 138  # bench.py's semantic depth


@contextlib.contextmanager
def on_card_only():
    """Count the sampled steps of `ops.sampling.sample` and fail at once
    if one's logits or noise lie on the CPU; and count the plain
    references' calls (`counted_plain_calls`), which run only for CPU
    tensors: the caller requires none."""
    from bark_tpu_torch.ops import sampling

    real = sampling.sample
    seen = {"sampled": 0}

    def sample(logits, temp, noise=None, top_k=0, top_p=0.0):
        if not logits.is_cuda or (noise is not None and not noise.is_cuda):
            raise AssertionError("a sampled step's logits or noise lie on "
                                 "the CPU")
        seen["sampled"] += 1
        return real(logits, temp, noise, top_k, top_p)

    sampling.sample = sample
    try:
        with counted_plain_calls() as plain:
            yield seen, plain
    finally:
        sampling.sample = real


def loop_launches() -> dict:
    """Launches of the four step loops (K3/K4 dense and packed, K9/K10
    dense and packed), apart from the steps' own."""
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.kernels import qbdecode as kqb
    from bark_tpu_torch.kernels import qdecode as kq

    return dict(decode=kdec.loop_launches, qdecode=kq.loop_launches,
                bdecode=kbdec.loop_launches, qbdecode=kqb.loop_launches)


def option_run(stages, codec, label: str, seed: int, run, **kw):
    """Phase 4f: one request or batch (`run(ctx)`) on bark-small at
    bench.py's depth (138 semantic steps, the EOS-probability stop off,
    PyTorch's default precision) with the params `kw`, driven with the
    launch counts set to 0 just before and read just after, no tensor of
    the sampler on the CPU and no plain version run. Returns (ctx, run's
    result, counts, loop launches, sampled steps, wall seconds)."""
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch import kernels
    from bark_tpu_torch.models.presets import ENCODEC_24KHZ

    ctx = bt.BarkContext.from_parts(
        vocab_tokens=VOCAB, semantic=stages["semantic"],
        coarse=stages["coarse"], fine=stages["fine"],
        codec_cfg=ENCODEC_24KHZ, codec_params=codec,
        params=bt.BarkContextParams(
            compute_dtype="bfloat16", n_steps_text_encoder=MAX_STEPS,
            min_eos_p=2.0, stage_sync=True, **kw),
        seed=seed, device=torch.device("cuda"))
    kernels.reset_launches()
    t0 = time.perf_counter()
    with on_card_only() as (seen, plain):
        out = run(ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, loops = kernels.launch_counts(), loop_launches()
    if any(plain.values()):
        raise AssertionError(f"{label}: a plain version ran: {plain}")
    log(f"  {label}: {wall:.3f} s, kernel launches {counts}, loops "
        f"{loops}, sampled steps {seen['sampled']}")
    return ctx, out, counts, loops, seen["sampled"], wall


def request_result(ctx, label: str, wall: float) -> dict:
    """A single request's audio checked and its times."""
    import numpy as np

    audio = ctx.get_audio_data()
    n_frames = ctx.fine_tokens.shape[0]
    if audio is None or audio.shape != (n_frames * 320,) or \
            not np.isfinite(audio).all():
        raise AssertionError(f"{label}: audio "
                             f"{None if audio is None else audio.shape}")
    s = ctx.stats
    return dict(label=label, semantic_tokens=int(ctx.semantic_tokens.size),
                coarse_steps=int(ctx.coarse_tokens.size), frames=n_frames,
                audio_s=audio.size / 24000, eval_s=s.t_eval_us / 1e6,
                wall_s=wall, semantic_s=s.t_semantic_us / 1e6,
                coarse_s=s.t_coarse_us / 1e6, fine_s=s.t_fine_us / 1e6)


def semantic_steps(count: int) -> int:
    """Steps the semantic loop ran for `count` tokens: a stop step decodes
    too (the JAX package's loop)."""
    return count + (count < MAX_STEPS)


def expect(label: str, got: dict, want: dict) -> None:
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"{label}: launches (got, want) {bad}")


def filtered_request(stages, codec, label: str, packed=False, kv8=False):
    """A filtered request (top_k 50, top_p 0.95, temp 0.7): every sampled
    token is one launch of the single step (K1, or K5 when `packed`; K6
    inside it when `kv8`), the prompt and each window one K2, and no step
    loop runs."""
    from bark_tpu_torch.pipeline import coarse as coarse_pipe

    ctx, _, counts, loops, sampled, wall = option_run(
        stages, codec, label, 1,
        lambda c: c.generate_audio(PROMPTS[0]), temp=0.7,
        kv_cache_dtype="int8" if kv8 else "params", **FILTERS)
    count = int(ctx.semantic_tokens.size)
    n_windows = coarse_pipe.coarse_schedule(count, ctx.params)[3]
    steps = semantic_steps(count) + n_windows * ctx.params.sliding_window_size
    step, other = ("qdecode", "decode") if packed else ("decode", "qdecode")
    want = {step: steps, other: 0, "prefill": 1 + n_windows, "semantic": 0,
            "window": 0, "bdecode": 0, "qbdecode": 0, "bprefill": 0}
    if kv8:
        want["kv8"] = steps + 1 + n_windows
    expect(label, counts, want)
    if sampled != steps or any(loops.values()):
        raise AssertionError(f"{label}: {sampled} sampled steps for {steps} "
                             f"launches, loops {loops}")
    r = request_result(ctx, label, wall)
    r.update(launches=counts, steps=steps)
    return ctx, r


def filtered_batch(stages, codec, B: int):
    """A filtered batch of B: every step of the B lanes one launch of
    K7's step (the semantic stage's until the last lane stops, then each
    shared window's 60), each prompt block and window one K8, no loop."""
    from bark_tpu_torch.pipeline import coarse as coarse_pipe

    texts = [PROMPTS[b % len(PROMPTS)] for b in range(B)]
    label = f"filtered batch of {B}"
    ctx, outs, counts, loops, sampled, wall = option_run(
        stages, codec, label, 100 + B, lambda c: c._generate_batch(texts),
        temp=0.7, **FILTERS)
    lane_counts = [int(o["semantic"].size) for o in outs]
    n_win = max(coarse_pipe.coarse_schedule(c, ctx.params)[3]
                for c in lane_counts)
    steps = max(semantic_steps(c) for c in lane_counts) + 60 * n_win
    expect(label, counts, {"bdecode": steps, "bprefill": 1 + n_win,
                           "bsemantic": 0, "bwindow": 0, "qbdecode": 0,
                           "decode": 0, "qdecode": 0, "prefill": 0})
    if sampled != steps or any(loops.values()):
        raise AssertionError(f"{label}: {sampled} sampled steps, loops "
                             f"{loops}")
    audio_s = sum(o["audio"].size for o in outs) / 24000
    return dict(B=B, steps=steps, semantic_tokens=lane_counts,
                audio_s=audio_s, eval_s=ctx.stats.t_eval_us / 1e6,
                wall_s=wall, launches=counts)


def stepped_request(stages, codec):
    """The stepped path with a progress callback, beside the fused request
    with the same seed (so the same noise): tokens bit-equal; each stage's
    percentages rise to 100; each window one K2 and one launch of the
    step loop (K4), each semantic chunk one (K3)."""
    import numpy as np

    from bark_tpu_torch.pipeline import coarse as coarse_pipe
    from bark_tpu_torch.pipeline import fine as fine_pipe

    fused, _, _, _, _, fused_wall = option_run(
        stages, codec, "fused request", 2,
        lambda c: c.generate_audio(PROMPTS[1]))
    calls = []
    ctx, _, counts, loops, _, wall = option_run(
        stages, codec, "stepped request", 2,
        lambda c: c.generate_audio(PROMPTS[1]),
        progress_callback=lambda c, step, pc, ud: calls.append(
            (int(step), pc)))
    for name in ("semantic_tokens", "coarse_tokens", "fine_tokens"):
        if not np.array_equal(getattr(ctx, name), getattr(fused, name)):
            raise AssertionError(f"stepped request: {name} differ from the "
                                 f"fused request's")
    if not np.array_equal(ctx.get_audio_data(), fused.get_audio_data()):
        raise AssertionError("stepped request: audio differs from fused")
    count = int(ctx.semantic_tokens.size)
    n_windows = coarse_pipe.coarse_schedule(count, ctx.params)[3]
    n_blocks = fine_pipe.fine_schedule(ctx.fine_tokens.shape[0], 1024)[1]
    chunks = -(-semantic_steps(count) // 16)
    for step, n in ((0, 2), (1, n_windows), (2, n_blocks)):
        pcs = [pc for s, pc in calls if s == step]
        if len(pcs) != n or pcs != sorted(pcs) or pcs[-1] != 100:
            raise AssertionError(f"stepped request: stage {step} progress "
                                 f"{pcs}, want {n} rising to 100")
    expect("stepped request", counts, {
        "semantic": chunks, "window": n_windows, "prefill": 1 + n_windows,
        "decode": 0, "qdecode": 0})
    if loops["decode"] != chunks + n_windows:
        raise AssertionError(f"stepped request: loops {loops}")
    r = request_result(ctx, "stepped", wall)
    r.update(launches=counts, progress=calls, fused_wall_s=fused_wall,
             fused_eval_s=fused.stats.t_eval_us / 1e6)
    return r


def profile_child(trace_dir: str) -> int:
    """Phase 4f's fresh process: bark-small (random bf16, seed 0), a
    warm-up request without a profiler (the kernels' first use), then one
    request with profile_dir=trace_dir, the first torch.profiler session
    of the process; prints one `profile_child` JSON line with its launches
    and seconds."""
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch import kernels
    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models.presets import ENCODEC_24KHZ

    dev = torch.device("cuda")
    stages = bark_small_stages()
    codec = loader.params_from_numpy(
        loader.codec_init_params_numpy(ENCODEC_24KHZ, 3), torch.float32, dev)
    out = {}
    for pdir in (None, trace_dir):
        ctx = bt.BarkContext.from_parts(
            vocab_tokens=VOCAB, semantic=stages["semantic"],
            coarse=stages["coarse"], fine=stages["fine"],
            codec_cfg=ENCODEC_24KHZ, codec_params=codec,
            params=bt.BarkContextParams(
                compute_dtype="bfloat16", n_steps_text_encoder=MAX_STEPS,
                min_eos_p=2.0, stage_sync=True, profile_dir=pdir),
            seed=1, device=dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        if not ctx.generate_audio(PROMPTS[0]):
            raise AssertionError("profiled request produced no audio")
        out = dict(wall_s=time.perf_counter() - t0,
                   eval_s=ctx.stats.t_eval_us / 1e6,
                   launches=kernels.launch_counts())
    print(json.dumps({"profile_child": out}), flush=True)
    return 0


def profiled_request(smi: str) -> dict:
    """A profile_dir request in a fresh process (`profile_child`), run
    once: its trace must hold one device kernel of the step loop (K3, K4)
    for each chunk and window the request launched, and the prefill GEMMs
    (K2)."""
    import shutil

    trace_dir = os.path.join(OUT_DIR, "profile_dir")
    shutil.rmtree(trace_dir, ignore_errors=True)
    child = json_line(run_child("profile_dir request", [
        sys.executable, "-c",
        f"import sys, chip_smoke; sys.exit(chip_smoke.profile_child("
        f"{trace_dir!r}))"]), "profile_child")
    names = sorted(os.listdir(trace_dir))
    if len(names) != 1 or not names[0].endswith(".pt.trace.json"):
        raise AssertionError(f"profile_dir holds {names}")
    path = os.path.join(trace_dir, names[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    size = os.path.getsize(path)
    shutil.rmtree(trace_dir, ignore_errors=True)
    loop = sum(1 for k in kernels if "decode_steps_kernel" in k)
    gemm = sum(1 for k in kernels if "gemm_tma_kernel" in k)
    launches = child["launches"]
    launched = launches["semantic"] + launches["window"]
    if loop != launched or gemm < launches["prefill"] or not launched:
        raise AssertionError(f"the profile_dir trace lacks the request's "
                             f"kernels: {len(kernels)} device kernels, "
                             f"{loop} of the step loop for {launched} "
                             f"launched, {gemm} GEMMs for "
                             f"{launches['prefill']} prefills")
    log(f"  profile_dir request: trace of {size} bytes, {len(kernels)} "
        f"device kernels, {loop} of the step loop for {launched} launched, "
        f"{gemm} prefill GEMMs; eval {child['eval_s']:.3f} s on {smi}")
    return dict(trace_bytes=size, device_kernels=len(kernels),
                step_loop_kernels=loop, launched_loops=launched,
                gemm_kernels=gemm, eval_s=child["eval_s"],
                wall_s=child["wall_s"], launches=launches)


def voice_requests(stages, codec, source_ctx):
    """A voice request from `preset_from_generation` of `source_ctx`, and
    a batch of 8 with per-lane voices (that preset on even lanes, none on
    odd): the histories condition the prompt (its history slots hold the
    preset's last <= 256 semantic tokens) and re-prime the first coarse
    window at 257 + the coarse history's rows; each chunk and window is
    still one loop launch."""
    from bark_tpu_torch.pipeline import coarse as coarse_pipe
    from bark_tpu_torch.pipeline import voice

    p = source_ctx.params
    preset = voice.preset_from_generation(
        source_ctx.semantic_tokens, source_ctx.coarse_tokens,
        source_ctx.fine_tokens, p)
    sem_hist, coarse_hist = voice.coarse_history(preset, p)
    ctx, _, counts, loops, _, wall = option_run(
        stages, codec, "voice request", 3,
        lambda c: c.generate_audio(PROMPTS[2], voice=preset))
    hist = preset.semantic[-256:]
    if list(ctx.tokens[256:256 + hist.size]) != list(hist):
        raise AssertionError("voice request: the prompt's history slots do "
                             "not hold the preset")
    count = int(ctx.semantic_tokens.size)
    n_windows = coarse_pipe.coarse_schedule(count, p)[3]
    expect("voice request", counts, {
        "window": n_windows, "prefill": 1 + n_windows, "decode": 0,
        "semantic": -(-semantic_steps(count) // 16)})
    r = request_result(ctx, "voice", wall)
    r.update(launches=counts, semantic_history=int(sem_hist.size),
             coarse_history=int(coarse_hist.size),
             first_window_rows=257 + int(coarse_hist.size),
             fine_history=int(min(preset.fine.shape[1], 512)))
    texts = [PROMPTS[b % len(PROMPTS)] for b in range(8)]
    voices = [preset if b % 2 == 0 else None for b in range(8)]
    bctx, outs, bcounts, bloops, _, bwall = option_run(
        stages, codec, "voiced batch of 8", 108,
        lambda c: c._generate_batch(texts, voices=voices))
    if not all(o["audio"].size for o in outs):
        raise AssertionError("voiced batch: a lane produced no audio")
    if min(bcounts[m] for m in ("bprefill", "bsemantic", "bwindow")) <= 0 \
            or bloops["bdecode"] != bcounts["bsemantic"] + bcounts["bwindow"] \
            or bcounts["bdecode"] or bcounts["decode"]:
        raise AssertionError(f"voiced batch: launches {bcounts}, loops "
                             f"{bloops}")
    batch = dict(B=8, wall_s=bwall, eval_s=bctx.stats.t_eval_us / 1e6,
                 audio_s=sum(o["audio"].size for o in outs) / 24000,
                 launches=bcounts)
    return preset, r, batch


def audio_preset(stages, codec, ctx_audio, p):
    """`voice.preset_from_audio` on a generated waveform through the
    EnCodec encoder on the card (random encoder weights from a seed), then
    a request with that preset (fine history only: no semantic donor)."""
    import numpy as np
    import torch

    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models.presets import ENCODEC_24KHZ
    from bark_tpu_torch.pipeline import voice

    enc_codec = loader.params_from_numpy(loader.codec_init_params_numpy(
        ENCODEC_24KHZ, 5, with_encoder=True), torch.float32,
        torch.device("cuda"))
    t0 = time.perf_counter()
    preset = voice.preset_from_audio(enc_codec, ctx_audio, p)
    encode_s = time.perf_counter() - t0
    n_frames = -(-ctx_audio.size // 320)
    if preset.fine.shape != (8, n_frames) or preset.semantic.size or \
            not ((preset.fine >= 0) & (preset.fine < 1024)).all():
        raise AssertionError(f"preset_from_audio: fine {preset.fine.shape} "
                             f"for {n_frames} frames")
    ctx, _, counts, _, _, wall = option_run(
        stages, codec, "audio-preset request", 4,
        lambda c: c.generate_audio(PROMPTS[0], voice=preset))
    r = request_result(ctx, "audio preset", wall)
    r.update(encode_s=encode_s, encoded_frames=n_frames,
             distinct_codes=int(np.unique(preset.fine).size))
    log(f"  preset_from_audio: {n_frames} frames of {ctx_audio.size / 24000:.2f}"
        f" s of audio encoded in {encode_s:.3f} s")
    return r


def options_phase(smi: str) -> dict:
    """Phase 4f: the options of generate_audio and generate_audio_batch
    on bark-small (random weights from a seed, bench.py's depth): filtered
    requests (dense, q4_0, the int8 cache), a filtered batch of 8, the
    stepped path with a progress callback, a profile_dir request in a
    fresh process, voices single and batched, and a preset from audio."""
    import torch

    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models.presets import ENCODEC_24KHZ

    t0 = time.perf_counter()
    codec = loader.params_from_numpy(
        loader.codec_init_params_numpy(ENCODEC_24KHZ, 3), torch.float32,
        torch.device("cuda"))
    stages = bark_small_stages()
    # the single steps' first use on these stages (their tile-major weight
    # copies and plans are made then): not kept
    filtered_request(stages, codec, "filtered request, dense, first use")
    filtered_batch(stages, codec, 2)
    rec = {}
    source, rec["filtered_dense"] = filtered_request(
        stages, codec, "filtered request, dense")
    _, rec["filtered_kv8"] = filtered_request(
        stages, codec, "filtered request, int8 KV cache", kv8=True)
    rec["filtered_batch"] = filtered_batch(stages, codec, 8)
    rec["stepped"] = stepped_request(stages, codec)
    _, rec["voice"], rec["voice_batch"] = voice_requests(stages, codec,
                                                         source)
    rec["audio_preset"] = audio_preset(stages, codec,
                                       source.get_audio_data(), source.params)
    del stages
    torch.cuda.empty_cache()
    _, rec["filtered_q4_0"] = filtered_request(
        bark_small_stages("q4_0"), codec, "filtered request, q4_0",
        packed=True)
    torch.cuda.empty_cache()
    rec["profile_dir"] = profiled_request(smi)
    rec["seconds"] = time.perf_counter() - t0
    rec["card"] = smi
    for key in ("filtered_dense", "filtered_kv8", "filtered_q4_0", "stepped",
                "voice", "audio_preset"):
        r = rec[key]
        log(f"  {key}: eval {r['eval_s']:.3f} s = semantic "
            f"{r['semantic_s']:.3f} + coarse {r['coarse_s']:.3f} + fine "
            f"{r['fine_s']:.3f} s for {r['audio_s']:.3f} s of audio on {smi}")
    for key in ("filtered_batch", "voice_batch"):
        r = rec[key]
        log(f"  {key}: eval {r['eval_s']:.3f} s for {r['audio_s']:.3f} s of "
            f"audio in {r['B']} lanes on {smi}")
    return rec


def small_model_options_reference(q8_path: str) -> None:
    """Phase 3, the options: the small model on the GPU through the
    kernels and on the CPU through the plain versions, f32, the same
    noise: filtered requests (dense, the q8_0 file packed, the int8
    cache), a filtered batch of 3, the stepped path, a voice request and
    a voiced batch: tokens equal in every stage and lane, audio within
    1e-3. Then the EnCodec encoder of a small codec: latent within 1e-4,
    codes equal."""
    import numpy as np
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models import encodec
    from bark_tpu_torch.models.config import CodecConfig
    from bark_tpu_torch.ops import sampling
    from bark_tpu_torch.pipeline import voice

    texts = ["hello world", "the a", "world hello the a"]
    preset = None

    def ctx_on(device, packed=False, **kw):
        params = bt.BarkContextParams(**SMALL_PARAMS, **kw)
        if packed:
            return bt.bark_load_model(q8_path, params, seed=0, device=device)
        return bt.BarkContext.from_parts(**small_model_parts(device),
                                         params=params, seed=0, device=device)

    def noisy(ctx, device):
        gen = torch.Generator().manual_seed(11)
        ctx.noise_source = (lambda stage, shape, g=gen, d=device:
                            sampling.gumbel(shape, g, "cpu").to(d))
        ctx.lane_noise_source = (
            lambda stage, lane, shape, d=device: sampling.gumbel(
                shape, torch.Generator().manual_seed(
                    100 * lane + len(stage)), "cpu").to(d))
        return ctx

    def single(device, voice_=None, packed=False, **kw):
        ctx = noisy(ctx_on(device, packed, **kw), device)
        if not ctx.generate_audio("hello world", voice=voice_):
            raise AssertionError("small model request failed")
        return [ctx.semantic_tokens, ctx.coarse_tokens, ctx.fine_tokens,
                ctx.get_audio_data()], ctx

    def batch(device, voices=None, **kw):
        ctx = noisy(ctx_on(device, **kw), device)
        return [a for o in ctx._generate_batch(texts, voices) for a in (
            o["semantic"], o["coarse"], o["fine"], o["audio"])], ctx

    cases = {
        "filtered": lambda d: single(d, **SMALL_FILTERS),
        "filtered q8_0 packed": lambda d: single(
            d, packed=True, dequantize_on_load=False, **SMALL_FILTERS),
        "filtered int8 KV": lambda d: single(d, kv_cache_dtype="int8",
                                             **SMALL_FILTERS),
        "filtered batch of 3": lambda d: batch(d, **SMALL_FILTERS),
        "stepped": lambda d: single(d, detailed_stats=True),
        "voice": lambda d: single(d, voice_=preset),
        "voiced batch of 3": lambda d: batch(d, [preset, None, preset]),
    }
    for name, run in cases.items():
        (cpu, cpu_ctx), (gpu, _) = run("cpu"), run("cuda")
        if preset is None:
            preset = voice.preset_from_generation(
                cpu_ctx.semantic_tokens, cpu_ctx.coarse_tokens,
                cpu_ctx.fine_tokens, cpu_ctx.params)
        err = 0.0
        for i, (a, b) in enumerate(zip(cpu, gpu)):
            if i % 4 == 3:
                err = max(err, float(np.abs(a - b).max()))
            elif not np.array_equal(a, b):
                raise AssertionError(f"small model, {name}: tokens differ "
                                     f"CPU vs GPU ({i})")
        log(f"  small model, {name}: tokens equal in every stage, audio "
            f"max|err| {err:.3e} (tol 1e-3)")
        if err > 1e-3:
            raise AssertionError(f"small model, {name}: audio differs {err}")
    ccfg = CodecConfig(hidden_dim=16, n_filters=2, n_bins=8, n_q_total=8)
    tree = loader.codec_init_params_numpy(ccfg, 4, 0.15, with_encoder=True)
    audio = torch.from_numpy(np.sin(np.arange(320 * 40, dtype=np.float32)
                                    * 0.05) * 0.5)
    out = {}
    for d in ("cpu", "cuda"):
        params = loader.params_from_numpy(tree, torch.float32, d)
        out[d] = (encodec.encoder_forward(params, audio.to(d)).cpu(),
                  encodec.encode_audio(params, audio.to(d), 8).cpu())
    err = max_err(out["cpu"][0], out["cuda"][0])
    log(f"  small codec's encoder: latent max|err| {err:.3e} (tol 1e-4), "
        f"codes equal {bool((out['cpu'][1] == out['cuda'][1]).all())}")
    if err > 1e-4 or not (out["cpu"][1] == out["cuda"][1]).all():
        raise AssertionError("the encoder differs CPU vs GPU")


# ------------------------------------------------------------ phase 4g

LONG_TEXT = "hello world. this is a speech test."  # two sentences
SERVER_BATCH = 40  # the server's --batch: groups of 32 and 8 lanes
# the streamed chunks against one decode of the final tokens, both at
# PyTorch's defaults (cuDNN TF32 on for the f32 codec, at other lengths):
# a share of the full decode's peak
STREAM_AUDIO_RTOL = 1e-2


def stream_chunks(ctx, text: str):
    """(chunks, host seconds to the first chunk, to the last) of one
    `generate_audio_stream`; each chunk is a host array, so the device
    has finished it."""
    t0 = time.perf_counter()
    chunks, first = [], None
    for chunk in ctx.generate_audio_stream(text):
        first = time.perf_counter() - t0 if first is None else first
        chunks.append(chunk)
    return chunks, first, time.perf_counter() - t0


def single_path_launches(label: str, counts, loops, windows: int,
                         chunks: int, prompts: int = 1) -> None:
    """A single-lane run of `prompts` requests went through K2, K3 and K4
    alone: each window one K2 and one K4, each prompt one K2, each chunk
    and window one launch of the dense step loop, no single step and no
    batched kernel."""
    expect(label, counts, {
        "prefill": prompts + windows, "window": windows, "semantic": chunks,
        "decode": 0, "qdecode": 0, "bprefill": 0, "bsemantic": 0,
        "bwindow": 0, "bdecode": 0})
    if loops["decode"] != chunks + windows or loops["qdecode"]:
        raise AssertionError(f"{label}: loops {loops}")


def streamed_request(stages, codec, smi: str) -> dict:
    """Phase 4g: a streamed request on bark-small beside the fused request
    with the same seed (so the same semantic and coarse noise): the
    semantic and coarse tokens equal, one chunk a coarse window, each
    window one K2 and one K4; the chunks joined are the audio and match
    one decode of the final fine tokens within STREAM_AUDIO_RTOL of its
    peak. Times the first chunk (TTFA) and the whole stream on the host
    clock, after a first stream on other seeds (first use of the
    prefix decodes' lengths: not kept)."""
    import numpy as np
    import torch

    from bark_tpu_torch.pipeline import coarse as coarse_pipe

    option_run(stages, codec, "stream, first use", 9,
               lambda c: stream_chunks(c, PROMPTS[0]))
    fused, _, _, _, _, fused_wall = option_run(
        stages, codec, "fused request", 5,
        lambda c: c.generate_audio(PROMPTS[0]))
    ctx, (chunks, ttfa, total), counts, loops, _, wall = option_run(
        stages, codec, "streamed request", 5,
        lambda c: stream_chunks(c, PROMPTS[0]))
    for name in ("semantic_tokens", "coarse_tokens"):
        if not np.array_equal(getattr(ctx, name), getattr(fused, name)):
            raise AssertionError(f"streamed request: {name} differ from the "
                                 f"fused request's")
    count = int(ctx.semantic_tokens.size)
    windows = coarse_pipe.coarse_schedule(count, ctx.params)[3]
    single_path_launches("streamed request", counts, loops, windows,
                         -(-semantic_steps(count) // 16))
    joined = np.concatenate(chunks)
    n = ctx.fine_tokens.shape[0]
    if len(chunks) != windows or joined.shape != (n * 320,) or \
            not np.array_equal(joined, ctx.get_audio_data()) or \
            not np.isfinite(joined).all():
        raise AssertionError(f"streamed request: {len(chunks)} chunks for "
                             f"{windows} windows, {joined.shape} samples "
                             f"for {n} frames")
    whole = ctx._decode_codec(torch.from_numpy(ctx.fine_tokens).cuda(),
                              n).cpu().numpy()
    err, peak = float(np.abs(joined - whole).max()), float(
        np.abs(whole).max())
    log(f"  streamed request: chunks joined vs one decode of the final "
        f"tokens max|err| {err:.3e} (tol {STREAM_AUDIO_RTOL} x peak "
        f"{peak:.3e})")
    if err > STREAM_AUDIO_RTOL * max(peak, 1.0):
        raise AssertionError(f"streamed chunks differ from the final decode:"
                             f" {err}")
    r = request_result(ctx, "streamed", wall)
    r.update(ttfa_s=ttfa, stream_s=total, chunks=len(chunks),
             chunk_samples=[int(c.size) for c in chunks], launches=counts,
             final_decode_max_abs_err=err, final_decode_peak=peak,
             fused_eval_s=fused.stats.t_eval_us / 1e6,
             fused_wall_s=fused_wall)
    log(f"  streamed request: TTFA {ttfa:.3f} s, stream {total:.3f} s "
        f"(eval {r['eval_s']:.3f} s), {len(chunks)} chunks for "
        f"{r['audio_s']:.3f} s of audio; the fused request eval "
        f"{r['fused_eval_s']:.3f} s on {smi}")
    return r


def long_requests(stages, codec) -> tuple:
    """Phase 4g: `generate_audio_long` and `generate_audio_stream_long` of
    LONG_TEXT's two sentences on bark-small: each sentence's windows one
    K2 and one K4, its chunks one launch of the step loop; the audio the
    two sentences with 0.25 s of silence between them (streamed: one
    chunk a window and the silence)."""
    import numpy as np

    from bark_tpu_torch.pipeline import coarse as coarse_pipe

    out = []
    for label, run in (
            ("long-form request", lambda c: c.generate_audio_long(
                LONG_TEXT)),
            ("streamed long-form request", lambda c: list(
                c.generate_audio_stream_long(LONG_TEXT)))):
        counts_by_sentence = []
        ctx, got, counts, loops, _, wall = option_run(
            stages, codec, label, 6, lambda c: run(
                _keep_sentences(c, counts_by_sentence)))
        if got is False or len(counts_by_sentence) != 2:
            raise AssertionError(f"{label}: {got}, sentences "
                                 f"{counts_by_sentence}")
        windows = sum(coarse_pipe.coarse_schedule(n, ctx.params)[3]
                      for n in counts_by_sentence)
        single_path_launches(label, counts, loops, windows, sum(
            -(-semantic_steps(n) // 16) for n in counts_by_sentence),
            prompts=len(counts_by_sentence))
        audio = ctx.get_audio_data()
        frames = ctx.stats.n_sample_coarse // 2
        if audio.shape != (frames * 320 + 6000,) or \
                not np.isfinite(audio).all() or \
                audio[:frames * 320].std() == 0:
            raise AssertionError(f"{label}: audio {audio.shape} for "
                                 f"{frames} frames")
        if isinstance(got, list) and (
                len(got) != windows + 1 or
                not np.array_equal(np.concatenate(got), audio)):
            raise AssertionError(f"{label}: {len(got)} chunks for "
                                 f"{windows} windows and a silence")
        s = ctx.stats
        out.append(dict(label=label, sentences=counts_by_sentence,
                        windows=windows, audio_s=audio.size / 24000,
                        eval_s=s.t_eval_us / 1e6, wall_s=wall,
                        semantic_s=s.t_semantic_us / 1e6,
                        coarse_s=s.t_coarse_us / 1e6,
                        fine_s=s.t_fine_us / 1e6, launches=counts))
    return tuple(out)


def _keep_sentences(ctx, counts: list):
    """`ctx`, its generate_audio and generate_audio_stream wrapped to
    append each sentence's semantic token count to `counts`."""
    audio, stream = ctx.generate_audio, ctx.generate_audio_stream

    def generate_audio(*a, **kw):
        ok = audio(*a, **kw)
        counts.append(int(ctx.semantic_tokens.size))
        return ok

    def generate_audio_stream(*a, **kw):
        yield from stream(*a, **kw)
        counts.append(int(ctx.semantic_tokens.size))

    ctx.generate_audio = generate_audio
    ctx.generate_audio_stream = generate_audio_stream
    return ctx


def served_requests(stages, codec, smi: str) -> dict:
    """Phase 4g: the port's HTTP server in this process (`cli.server`'s
    handler on a free localhost port, `--batch 40`: its BatchWorker and
    the one generation lock) under SERVER_BATCH concurrent POST /bark and
    one chunked stream request, driven with the launch counts set to 0
    just before and read just after: one generate_audio_batch of 40 in
    groups of 32 and 8 lanes, each group's chunks and windows one launch
    of the batched loop (K9, K10) after one K8 a window, and no batched
    single step; the stream's windows K2 + K4. Fails if the worker fell
    back to single requests or a reply is not 200 with audio."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch import kernels
    from bark_tpu_torch.cli import server as srv
    from bark_tpu_torch.models.presets import ENCODEC_24KHZ

    ctx = bt.BarkContext.from_parts(
        vocab_tokens=VOCAB, semantic=stages["semantic"],
        coarse=stages["coarse"], fine=stages["fine"],
        codec_cfg=ENCODEC_24KHZ, codec_params=codec,
        params=bt.BarkContextParams(
            compute_dtype="bfloat16", n_steps_text_encoder=MAX_STEPS,
            min_eos_p=2.0, stage_sync=True),
        seed=140, device=torch.device("cuda"))
    groups, group = [], ctx._generate_group

    def counted_group(texts, presets, first):
        groups.append(len(texts))
        return group(texts, presets, first)

    ctx._generate_group = counted_group
    lock = threading.Lock()
    # a full batch leaves at once; the window only bounds a short one
    worker = srv.BatchWorker(ctx, SERVER_BATCH, 60_000.0, lock)
    httpd = srv.Server(("127.0.0.1", 0),
                       srv.make_handler(ctx, lock, 1, worker))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/bark"
    replies = {}

    def post(key, payload):
        req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type":
                                              "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=SUBPROCESS_TIMEOUT_S) as r:
            replies[key] = (r.status, r.read(), time.perf_counter() - t0)

    clients = [threading.Thread(target=post, args=(
        i, {"text": PROMPTS[i % len(PROMPTS)]})) for i in range(SERVER_BATCH)]
    clients.append(threading.Thread(target=post, args=(
        "stream", {"text": PROMPTS[1], "stream": True})))
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with counted_plain_calls() as plain:
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=SUBPROCESS_TIMEOUT_S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
    counts, loops = kernels.launch_counts(), loop_launches()
    log(f"  server: {len(replies)} replies in {wall:.3f} s, kernel launches "
        f"{counts}, loops {loops}, groups {groups}, fallbacks "
        f"{worker.fallbacks}, plain calls {plain}")
    if worker.fallbacks or groups != [32, SERVER_BATCH - 32] or \
            any(plain.values()):
        raise AssertionError(f"server: fallbacks {worker.fallbacks}, groups "
                             f"{groups}, plain calls {plain}")
    samples = []
    for key in list(range(SERVER_BATCH)) + ["stream"]:
        status, body, _ = replies.get(key, (None, b"", 0))
        audio = np.frombuffer(body[46 if key == "stream" else 58:], "<f4")
        if status != 200 or body[:4] != b"RIFF" or audio.size == 0 or \
                audio.size % 320 or not np.isfinite(audio).all():
            raise AssertionError(f"server: reply {key}: status {status}, "
                                 f"{audio.size} samples")
        samples.append(audio.size)
    if (min(counts[m] for m in ("bprefill", "bsemantic", "bwindow",
                                "prefill", "semantic", "window")) <= 0
            or loops["bdecode"] != counts["bsemantic"] + counts["bwindow"]
            or loops["decode"] != counts["semantic"] + counts["window"]
            or any(counts[m] for m in ("bdecode", "qbdecode", "decode",
                                       "qdecode"))):
        raise AssertionError(f"server: launches {counts}, loops {loops}")
    audio_s = sum(samples[:SERVER_BATCH]) / 24000
    batch_wall = max(replies[i][2] for i in range(SERVER_BATCH))
    r = dict(requests=SERVER_BATCH, groups=groups, wall_s=wall,
             batch_wall_s=batch_wall, audio_s=audio_s,
             audio_s_per_wall_s=audio_s / batch_wall,
             stream_wall_s=replies["stream"][2],
             stream_audio_s=samples[-1] / 24000, launches=counts,
             loops=loops, fallbacks=worker.fallbacks)
    log(f"  server: {SERVER_BATCH} /bark requests in groups {groups}: the "
        f"last reply after {batch_wall:.3f} s, {audio_s:.3f} s of audio "
        f"({r['audio_s_per_wall_s']:.3f} audio-s per wall-s); the stream "
        f"request {r['stream_wall_s']:.3f} s; all {wall:.3f} s on {smi}")
    return r


def small_model_stream_reference() -> dict:
    """Phase 4g, in f32 with TF32 off: the small model streams two coarse
    windows (sliding_window_size 20) on the GPU through the kernels and on
    the CPU through the plain versions, with the same noise: tokens equal,
    chunks of equal lengths within 1e-3; on the GPU each window one K2 and
    one K4."""
    import numpy as np
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch import kernels
    from bark_tpu_torch.ops import sampling

    runs = {}
    with full_f32():
        for device in ("cpu", "cuda"):
            ctx = bt.BarkContext.from_parts(
                **small_model_parts(device),
                params=bt.BarkContextParams(**dict(
                    SMALL_PARAMS, sliding_window_size=20)),
                seed=0, device=device)
            gen = torch.Generator().manual_seed(11)
            ctx.noise_source = (
                lambda stage, shape, g=gen, d=device:
                sampling.gumbel(shape, g, "cpu").to(d))
            kernels.reset_launches()
            chunks = list(ctx.generate_audio_stream("hello world"))
            counts = kernels.launch_counts()
            if device == "cuda" and (counts["window"] != len(chunks) or
                                     counts["prefill"] != 1 + len(chunks)):
                raise AssertionError(f"small model stream: {len(chunks)} "
                                     f"chunks, launches {counts}")
            runs[device] = (ctx, chunks)
    (cpu, cpu_chunks), (gpu, gpu_chunks) = runs["cpu"], runs["cuda"]
    for name in ("semantic_tokens", "coarse_tokens", "fine_tokens"):
        if not np.array_equal(getattr(cpu, name), getattr(gpu, name)):
            raise AssertionError(f"small model stream: {name} differ CPU vs "
                                 f"GPU")
    if [c.size for c in cpu_chunks] != [c.size for c in gpu_chunks] or \
            len(gpu_chunks) != 2:
        raise AssertionError("small model stream: chunks differ CPU vs GPU")
    err = max(float(np.abs(a - b).max()) for a, b in zip(cpu_chunks,
                                                           gpu_chunks))
    log(f"  small model stream: {len(gpu_chunks)} chunks, tokens equal in "
        f"every stage CPU vs GPU, chunks max|err| {err:.3e} (tol 1e-3)")
    if err > 1e-3:
        raise AssertionError(f"small model stream audio differs: {err}")
    return dict(chunks=len(gpu_chunks), max_abs_err=err)


MAIN_CLI_DRIVER = (
    "import functools, sys\n"
    "import bark_tpu_torch.params as params_mod\n"
    "import chip_smoke\n"
    "from bark_tpu_torch.cli import main\n"
    "params_mod.BarkContextParams = functools.partial(\n"
    "    params_mod.BarkContextParams, **chip_smoke.SMALL_PARAMS)\n"
    "sys.exit(main.main(sys.argv[1:]))\n")


def main_cli_run() -> dict:
    """Phase 4g: `bark_tpu_torch.cli.main` in a subprocess on the small
    model's file (its params patched to the small token space), on the
    card (its default device): exit 0 and a WAV of the request's
    samples."""
    import numpy as np

    from bark_tpu_torch.utils.wav import read_wav

    path = os.path.join(OUT_DIR, "small_cli.bin")
    wav = os.path.join(OUT_DIR, "small_cli.wav")
    write_small_model(path)
    t0 = time.perf_counter()
    run_child("main CLI", [sys.executable, "-c", MAIN_CLI_DRIVER, "-m", path,
                           "-p", "hello world", "-o", wav, "--dtype",
                           "float32", "-s", "2"])
    seconds = time.perf_counter() - t0
    audio, sr = read_wav(wav)
    for f in (path, wav):
        os.unlink(f)
    if sr != 24000 or audio.shape != (18 * 320,) or \
            not np.isfinite(audio).all():
        raise AssertionError(f"main CLI: {audio.shape} samples at {sr} Hz")
    return dict(seconds=seconds, samples=int(audio.size))


def streaming_phase(smi: str) -> dict:
    """Phase 4g: streaming, long-form and the server on bark-small (random
    bf16 weights from a seed, bench.py's depth, PyTorch's defaults), the
    small model's stream GPU vs CPU in f32, and the main CLI in a
    subprocess."""
    import torch

    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models.presets import ENCODEC_24KHZ

    t0 = time.perf_counter()
    codec = loader.params_from_numpy(
        loader.codec_init_params_numpy(ENCODEC_24KHZ, 3), torch.float32,
        torch.device("cuda"))
    stages = bark_small_stages()
    rec = dict(stream=streamed_request(stages, codec, smi))
    rec["long"], rec["stream_long"] = long_requests(stages, codec)
    rec["server"] = served_requests(stages, codec, smi)
    del stages
    torch.cuda.empty_cache()
    rec["small_model_stream"] = small_model_stream_reference()
    rec["main_cli"] = main_cli_run()
    rec["seconds"] = time.perf_counter() - t0
    rec["card"] = smi
    # the single-lane kernels' launches of the stream and long-form runs,
    # and the batched ones of the server's (the kernel table adds them)
    rec["launches"] = {m: sum(rec[k]["launches"][m] for k in (
        "stream", "long", "stream_long")) for m in ("prefill", "semantic",
                                                    "window")}
    rec["launches"].update({m: rec["server"]["launches"][m] for m in (
        "bprefill", "bsemantic", "bwindow")})
    for key in ("long", "stream_long"):
        r = rec[key]
        log(f"  {key}: eval {r['eval_s']:.3f} s = semantic "
            f"{r['semantic_s']:.3f} + coarse {r['coarse_s']:.3f} + fine "
            f"{r['fine_s']:.3f} s for {r['audio_s']:.3f} s of audio "
            f"(2 sentences, {r['windows']} windows) on {smi}")
    return rec


# ------------------------------------------------------------ phase 4h

MG_B = 8  # phase 4h's batches, beside phase 4c's batch of 8
MG_SMALL_TEXTS = ["hello world", "the a", "world hello the a", "a the hello"]


def lane_noise(device, shift: int = 0):
    """A lane-keyed `lane_noise_source`: each (stage, lane) draws from a
    generator of its own seed, so a lane's noise is the same in any batch
    (lane b of this source is lane b + shift of a larger batch)."""
    import torch

    from bark_tpu_torch.ops import sampling

    def source(stage, lane, shape):
        gen = torch.Generator(device=device).manual_seed(
            1000 * (lane + shift) + len(stage))
        return sampling.gumbel(shape, gen, device)

    return source


def bark_small_context(stages, seed: int):
    """A bark-small BarkContext on the card (`bark_small_batch`'s:
    bench.py's 138 semantic steps, no EOS stop, stage_sync)."""
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch.io import loader
    from bark_tpu_torch.models.presets import ENCODEC_24KHZ

    dev = torch.device("cuda")
    return bt.BarkContext.from_parts(
        vocab_tokens=VOCAB, semantic=stages["semantic"],
        coarse=stages["coarse"], fine=stages["fine"],
        codec_cfg=ENCODEC_24KHZ,
        codec_params=loader.params_from_numpy(
            loader.codec_init_params_numpy(ENCODEC_24KHZ, 3), torch.float32,
            dev),
        params=bt.BarkContextParams(
            compute_dtype="bfloat16", n_steps_text_encoder=MAX_STEPS,
            min_eos_p=2.0, stage_sync=True),
        seed=seed, device=dev)


def same_lanes(label: str, got, want, keys=("semantic", "coarse", "fine",
                                             "audio")) -> None:
    """Every lane's `keys` bit-equal, and every lane with audio."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} lanes, want {len(want)}")
    for b, (g, w) in enumerate(zip(got, want)):
        for key in keys:
            if not np.array_equal(g[key], w[key]):
                raise AssertionError(f"{label}, lane {b}: {key} differs")
        if g["audio"].size == 0 or not np.isfinite(g["audio"]).all():
            raise AssertionError(f"{label}, lane {b}: no audio")


def token_agreement(got, want) -> dict:
    """Per stage, the share of token positions equal in got and want over
    every lane (a position either one lacks counts as unequal)."""
    import numpy as np

    rates = {}
    for key in ("semantic", "coarse", "fine"):
        same = total = 0
        for g, w in zip(got, want):
            g, w = g[key].reshape(-1), w[key].reshape(-1)
            n = min(g.size, w.size)
            same += int((g[:n] == w[:n]).sum())
            total += max(g.size, w.size)
        rates[key] = same / max(total, 1)
    return rates


def mg_batch(ctx, texts):
    """(lanes, record) of one `_generate_batch` with the launch counts set
    to 0 just before and read just after, and the plain references
    counted."""
    import torch

    from bark_tpu_torch import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    with counted_plain_calls() as plain:
        lanes = ctx._generate_batch(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = ctx.stats
    audio_s = sum(lane["audio"].size for lane in lanes) / 24000
    return lanes, dict(
        wall_s=wall, eval_s=s.t_eval_us / 1e6, audio_s=audio_s,
        audio_s_per_wall_s=audio_s / (s.t_eval_us / 1e6),
        semantic_s=s.t_semantic_us / 1e6, coarse_s=s.t_coarse_us / 1e6,
        fine_s=s.t_fine_us / 1e6, launches=kernels.launch_counts(),
        loop=lane_counts(), loop_packed=lane_counts(packed=True),
        plain=dict(plain))


def check_dp_kernels(label: str, rec: dict, packed: bool) -> None:
    """A dp batch ran K8-K10 alone (each chunk and window one launch of
    the batched loop on the dense or packed read) and no plain version."""
    c, plain = rec["launches"], rec["plain"]
    loop = rec["loop_packed" if packed else "loop"]
    if (min(c[m] for m in ("bprefill", "bsemantic", "bwindow")) <= 0
            or tuple(loop) != (c["bsemantic"] + c["bwindow"], 0)
            or any(c[m] for m in ("decode", "qdecode", "prefill",
                                  "semantic", "window"))
            or any(plain.values())):
        raise AssertionError(f"{label} did not run on K8-K10 alone: {c}, "
                             f"loop {loop}, plain calls {plain}")


def multigpu_world1(smi: str) -> dict:
    """Phase 4h (a): a world of 1 on NCCL in this process, bark-small at
    full width in bf16: a batch of 8 through `shard_context_dp` (K8-K10,
    no plain version, every lane bit-equal to this process's unsharded
    batch of 8 under the same default noise), the same on q4_0 qpacks
    (K5-batched's read), and through `shard_context` at tp 1 (the
    tensor-parallel forward: no kernel, no plain version; its token
    agreement with the kernel path in bf16)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bark_tpu_torch.parallel import launch, sharding

    texts = [PROMPTS[b % len(PROMPTS)] for b in range(MG_B)]
    rec = {}
    with launch.process_group(1, 0, "cuda"):
        one = torch.ones(1, device="cuda")
        dist.all_reduce(one)
        if dist.get_backend() != "nccl" or one.item() != 1.0:
            raise AssertionError(f"world 1: backend {dist.get_backend()}, "
                                 f"all_reduce {one.item()}")
        for fmt in (None, "q4_0"):
            tag = fmt or "dense"
            stages = bark_small_stages(fmt)
            bark_small_context(stages, 200)._generate_batch(texts[:2])
            base, rec[f"unsharded_{tag}"] = mg_batch(
                bark_small_context(stages, 108), texts)
            dp, rec[f"dp_{tag}"] = mg_batch(sharding.shard_context_dp(
                bark_small_context(stages, 108), sharding.make_dp_mesh()),
                texts)
            check_dp_kernels(f"world 1, dp, {tag}", rec[f"dp_{tag}"],
                             packed=fmt is not None)
            same_lanes(f"world 1, dp, {tag}", dp, base)
            if fmt is None:
                tpl, r = mg_batch(sharding.shard_context(
                    bark_small_context(stages, 108),
                    sharding.make_mesh(1)), texts)
                if any(r["launches"].values()) or any(r["plain"].values()):
                    raise AssertionError(f"world 1, tp 1: kernels "
                                         f"{r['launches']}, plain calls "
                                         f"{r['plain']}")
                for b, lane in enumerate(tpl):
                    a = lane["audio"]
                    if a.size == 0 or a.size % 320 or \
                            not np.isfinite(a).all():
                        raise AssertionError(f"world 1, tp 1, lane {b}: "
                                             f"audio {a.shape}")
                r["token_agreement"] = token_agreement(tpl, base)
                rec["tp1_dense"] = r
            del stages
            torch.cuda.empty_cache()
    for key, r in rec.items():
        log(f"  world 1 {key:16s}: eval {r['eval_s']:.3f} s = semantic "
            f"{r['semantic_s']:.3f} + coarse {r['coarse_s']:.3f} + fine "
            f"{r['fine_s']:.3f} s; {r['audio_s_per_wall_s']:.3f} audio-s "
            f"per wall-s; launches {r['launches']}"
            + (f"; tokens equal to the kernel path "
               f"{r['token_agreement']}" if "token_agreement" in r else "")
            + f" on {smi}")
    return rec


def multigpu_rank(device, spec) -> dict:
    """Phase 4h (b): one of 2 ranks on one card (gloo, `launch.spawn`).
    The small model in f32 with TF32 off, lane-keyed noise: dp 2 and tp 2
    (dense and the int8 cache) give the tokens of the unsharded batch on
    this card; the tp 2 step factories' logits within 2e-5 of the plain
    single-device step. Then bark-small bf16 at dp 2 over 8 lanes: this
    rank's 4 lanes bit-equal to an unsharded batch of those 4 lanes at B 4
    with their noise."""
    import numpy as np
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.parallel import sharding

    out = dict(errors={})
    with full_f32():
        for kv8 in (False, True):
            def small():
                ctx = bt.BarkContext.from_parts(
                    **small_model_parts(device), params=bt.BarkContextParams(
                        **SMALL_PARAMS,
                        kv_cache_dtype="int8" if kv8 else "params"),
                    seed=0, device=device)
                ctx.lane_noise_source = lane_noise(device)
                return ctx

            want = small()._generate_batch(MG_SMALL_TEXTS)
            for mode in (("dp", "tp") if not kv8 else ("tp",)):
                ctx = small()
                if mode == "dp":
                    sharding.shard_context_dp(ctx, sharding.make_dp_mesh())
                else:
                    sharding.shard_context(ctx, sharding.make_mesh(2, dp=1))
                label = f"small model {mode} 2{' int8' if kv8 else ''}"
                got = ctx._generate_batch(MG_SMALL_TEXTS)
                same_lanes(label, got, want, ("semantic", "coarse", "fine"))
                out["errors"][label] = max(
                    float(np.abs(g["audio"] - w["audio"]).max())
                    for g, w in zip(got, want))
        cfg, params = small_model_parts(device)["semantic"]
        mesh = sharding.make_mesh(2, dp=1)
        shard = sharding.shard_gpt_params(mesh, cfg, params)
        toks = torch.arange(2 * 257, device=device).reshape(2, 257) % 181
        x_emb = params["wte"][0][toks]
        kc, vc = sharding.init_kv_cache(cfg, mesh, 2, torch.float32, device)
        pre, kc, vc = sharding.make_batched_prefill(cfg, mesh)(
            shard, x_emb, kc, vc, [257, 257])
        step, _, _ = sharding.make_batched_decode_step(cfg, mesh)(
            shard, torch.tensor([3, 7], device=device), kc, vc, 257)
        err = 0.0
        for b, tok in enumerate((3, 7)):
            k1, v1 = gpt.init_kv_cache(cfg, torch.float32, device)
            ref = gpt.prefill(cfg, params, x_emb[b], k1, v1, 257)
            err = max(err, float((pre[b] - ref).abs().max()))
            ref = gpt.decode_step(cfg, params, tok, k1, v1, 257)
            err = max(err, float((step[b] - ref).abs().max()))
        out["errors"]["tp 2 step factories' logits"] = err
        if err > 2e-5:
            raise AssertionError(f"tp 2 step factories: logits {err} from "
                                 f"the single-device step")
    texts = [PROMPTS[b % len(PROMPTS)] for b in range(MG_B)]
    stages = bark_small_stages()
    ctx = sharding.shard_context_dp(bark_small_context(stages, 300),
                                    sharding.make_dp_mesh())
    ctx.lane_noise_source = lane_noise(device)
    lanes, out["dp2"] = mg_batch(ctx, texts)
    lo, hi = ctx._dp_mesh.lanes(MG_B)
    solo = bark_small_context(stages, 300)
    solo.lane_noise_source = lane_noise(device, shift=lo)
    mine, out["solo"] = mg_batch(solo, texts[lo:hi])
    same_lanes(f"bark-small dp 2, rank lanes {lo}-{hi - 1}", lanes[lo:hi],
               mine)
    out.update(lanes=(lo, hi), rank=ctx._dp_mesh.coord[0])
    return out


def multigpu_world2(smi: str) -> dict:
    """Phase 4h (b): `multigpu_rank` on 2 ranks on cuda:0 over gloo."""
    from bark_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    ranks = launch.spawn(multigpu_rank, 2, "cuda:0", None, timeout_s=900)
    rec = dict(seconds=time.perf_counter() - t0, ranks=ranks)
    for r in ranks:
        log(f"  world 2 rank {r['rank']}: lanes {r['lanes']}, dp 2 eval "
            f"{r['dp2']['eval_s']:.3f} s (its 4 lanes alone at B 4: "
            f"{r['solo']['eval_s']:.3f} s), bit-equal; small model "
            f"{ {k: f'{v:.2e}' for k, v in r['errors'].items()} } on {smi}")
    return rec


def multigpu_dryrun() -> dict:
    """Phase 4h (c): `python -m bark_tpu_torch.parallel.dryrun 2 --device
    cuda` in a subprocess must exit 0."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "bark_tpu_torch.parallel.dryrun", "2",
         "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    if out.returncode != 0 or "dryrun(2) OK" not in out.stdout:
        raise AssertionError(f"the dry run exited {out.returncode}: "
                             f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    return dict(seconds=time.perf_counter() - t0,
                stdout=out.stdout.strip().splitlines())


def multigpu_phase(smi: str, batch8=None) -> dict:
    """Phase 4h: multi-GPU serving (`bark_tpu_torch.parallel`) on the one
    card: (a) a world of 1 on NCCL, (b) a world of 2 on one card over
    gloo, (c) the dry run. Its K8-K10 launches add to the kernel rows'
    (the `multigpu` entry of the results line). `batch8`: phase 4c's
    batch of 8, for the times beside it."""
    t0 = time.perf_counter()
    rec = dict(world1=multigpu_world1(smi))
    rec["world2"] = multigpu_world2(smi)
    rec["dryrun"] = multigpu_dryrun()
    rec["seconds"] = time.perf_counter() - t0
    rec["card"] = smi
    runs = [rec["world1"]["dp_dense"], rec["world1"]["dp_q4_0"]] + [
        r["dp2"] for r in rec["world2"]["ranks"]]
    rec["launches"] = {m: sum(r["launches"][m] for r in runs)
                       for m in ("bprefill", "bsemantic", "bwindow")}
    if batch8 is not None:
        w1 = rec["world1"]
        log(f"  batch of {MG_B}, eval s: phase 4c {batch8['eval_s']:.3f}; "
            f"unsharded {w1['unsharded_dense']['eval_s']:.3f}, dp 1 "
            f"{w1['dp_dense']['eval_s']:.3f}, tp 1 "
            f"{w1['tp1_dense']['eval_s']:.3f}; q4_0 unsharded "
            f"{w1['unsharded_q4_0']['eval_s']:.3f}, dp 1 "
            f"{w1['dp_q4_0']['eval_s']:.3f} on {smi}")
    return rec


# ------------------------------------------------------------ phase 4i

FB_BATCHES = (8, 32)  # phase 4i's dense bf16 batches; q4_0 at the first
# the last smoke of the lane-by-lane fine stage (PERF.md; NVIDIA H100 80GB
# HBM3, 700.00 W): a dense batch's eval seconds and the fine stage's share
# of them
FB_LANE_BY_LANE = {8: (1.382, "65-68%"), 32: (4.490, "75%")}


def counting_forward():
    """The kernels' forward (`pipeline.forward.KernelForward`) recording
    the lanes of each `fine` call."""
    from bark_tpu_torch.pipeline import forward

    class Counting(forward.KernelForward):
        def __init__(self):
            self.fine_lanes = []

        def fine(self, cfg, params, tokens, codebook_idx: int):
            self.fine_lanes.append(
                int(tokens.shape[0]) if tokens.dim() == 3 else 1)
            return super().fine(cfg, params, tokens, codebook_idx)

    return Counting()


@contextlib.contextmanager
def counted_codec():
    """Record the lanes of each `encodec.decode_codes` call."""
    from bark_tpu_torch.models import encodec

    calls, decode = [], encodec.decode_codes

    def counting(params, codes):
        calls.append(int(codes.shape[0]) if codes.dim() == 3 else 1)
        return decode(params, codes)

    encodec.decode_codes = counting
    try:
        yield calls
    finally:
        encodec.decode_codes = decode


def fine_batch_run(stages, B: int, packed: bool = False,
                   agree: bool = True) -> dict:
    """Phase 4i: one `_generate_batch` of B prompts on bark-small
    (`bark_small_context`, the lane-keyed noise of `lane_noise`), driven
    with the launch counts set to 0 just before and read just after, its
    fine forwards and codec calls counted. Its fine stage must be n_fine -
    n_coarse forwards a block of the longest lane, each over the lanes
    still refining (the first over all B), and its codec one call a
    decode length (`BarkContext._codec_frames`): no per-lane loop left.
    K8-K10 alone must have run the semantic and coarse stages (each chunk
    and window one launch of the batched loop), and no plain version.
    Then the fine stage program again over the same lanes and noise: its
    seconds, its peak memory over what was allocated before it, and
    whether it gave the batch's codes; with `agree`, each lane alone
    through the same program, and the share of fine codes equal to the
    batch's."""
    import numpy as np
    import torch

    from bark_tpu_torch import kernels
    from bark_tpu_torch.pipeline import fine as fine_pipe

    dev = torch.device("cuda")
    ctx = bark_small_context(stages, seed=200 + B)
    ctx.lane_noise_source = noise = lane_noise(dev)
    ctx._forward = fwd = counting_forward()
    texts = [PROMPTS[b % len(PROMPTS)] for b in range(B)]
    label = f"{'q4_0 ' if packed else ''}batch of {B}"
    kernels.reset_launches()
    t0 = time.perf_counter()
    with counted_plain_calls() as plain, counted_codec() as codec_calls:
        lanes = ctx._generate_batch(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, loop = kernels.launch_counts(), lane_counts(packed=packed)
    check_dp_kernels(label, dict(launches=counts, plain=dict(plain),
                                 loop=loop, loop_packed=loop), packed)
    p, block = ctx.params, ctx.fine_cfg.block_size
    n_books = p.n_fine_codebooks - p.n_coarse_codebooks
    frames = [lane["fine"].shape[0] for lane in lanes]
    blocks = [fine_pipe.fine_schedule(n, block)[1] for n in frames]
    want = [sum(b > n for b in blocks) for n in range(max(blocks))
            for _ in range(n_books)]
    groups = {}
    for n in frames:
        groups[ctx._codec_frames(n)] = groups.get(ctx._codec_frames(n),
                                                  0) + 1
    log(f"  {label}: fine forwards over {fwd.fine_lanes} lanes, codec "
        f"calls over {codec_calls} lanes ({len(set(frames))} lengths, "
        f"{max(blocks)} blocks)")
    if fwd.fine_lanes != want or sorted(codec_calls) != sorted(
            groups.values()):
        raise AssertionError(
            f"{label}: a per-lane loop is left: fine forwards over "
            f"{fwd.fine_lanes} lanes (want {want}), codec calls over "
            f"{codec_calls} lanes (want {sorted(groups.values())})")
    for b, lane in enumerate(lanes):
        a = lane["audio"]
        if a.size != frames[b] * 320 or not np.isfinite(a).all():
            raise AssertionError(f"{label}, lane {b}: audio {a.shape}")
    s = ctx.stats
    eval_s = s.t_eval_us / 1e6
    audio_s = sum(lane["audio"].size for lane in lanes) / 24000
    rec = dict(
        B=B, frames=sorted(set(frames)), blocks=max(blocks),
        fine_forwards=len(fwd.fine_lanes), fine_forward_lanes=want[0],
        codec_calls=codec_calls, wall_s=wall, eval_s=eval_s,
        audio_s=audio_s, audio_s_per_wall_s=audio_s / eval_s,
        semantic_s=s.t_semantic_us / 1e6, coarse_s=s.t_coarse_us / 1e6,
        fine_s=s.t_fine_us / 1e6,
        codec_s=(s.t_eval_us - s.t_semantic_us - s.t_coarse_us
                 - s.t_fine_us) / 1e6,
        launches=counts)
    rec["fine_share"] = rec["fine_s"] / eval_s
    prog = ctx._program("fine")
    codes = [torch.from_numpy(lane["coarse"]).to(dev) for lane in lanes]
    noises = [noise("fine", b, (nl, n_books, block, p.codebook_size))
              for b, nl in enumerate(blocks)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = prog(ctx.fine_params, codes, frames, noises)
    torch.cuda.synchronize()
    rec["stage_alone_s"] = time.perf_counter() - t0
    rec["stage_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    rec["stage_peak_total_bytes"] = torch.cuda.max_memory_allocated()
    rec["stage_again_equal"] = all(
        np.array_equal(a[:n].cpu().numpy(), lane["fine"])
        for a, n, lane in zip(again, frames, lanes))
    del again
    if agree:
        equal = total = 0
        for b, lane in enumerate(lanes):
            alone = prog(ctx.fine_params, [codes[b]], [frames[b]],
                         [noises[b]])[0][:frames[b]].cpu().numpy()
            equal += int((alone == lane["fine"]).sum())
            total += alone.size
        rec["agreement_alone"] = equal / total
    log(f"  {label}: eval {eval_s:.6f} s ({rec['audio_s_per_wall_s']:.6f} "
        f"audio-s per wall-s): fine {rec['fine_s']:.6f} s "
        f"({100 * rec['fine_share']:.1f}%), codec {rec['codec_s']:.6f} s; "
        f"the stage again {rec['stage_alone_s']:.6f} s, peak +"
        f"{rec['stage_peak_bytes'] / 2**30:.3f} GiB (total "
        f"{rec['stage_peak_total_bytes'] / 2**30:.3f} GiB), same codes "
        f"{rec['stage_again_equal']}"
        + (f"; lanes alone agree {rec['agreement_alone']:.6f}"
           if agree else ""))
    return rec


def fine_batch_phase(smi: str, alone: bool = False) -> dict:
    """Phase 4i: the batched fine stage and codec on bark-small bf16
    (`fine_batch_run`): dense batches of FB_BATCHES (each lane's codes
    also against the lane alone), a q4_0 batch of 8; then the fine stage's
    torch.profiler split at B 1 and 32 in a fresh process
    (`probes/fine_profile.py`, `probe_record`); `alone` (the
    `--fine-batch` run): also the small model's f32 batch on the card
    against the CPU (`small_model_batched_reference`, which phase 3 runs
    in the full smoke). Its K8-K10 launches add to the kernel rows' (the
    `fine_batch` entry of the results line)."""
    import torch

    t0 = time.perf_counter()
    rec = dict(card=smi)
    stages = bark_small_stages()
    bark_small_batch(stages, 2)  # first use of these weights: not kept
    for B in FB_BATCHES:
        rec[f"dense_B{B}"] = fine_batch_run(stages, B)
        earlier_eval, earlier_share = FB_LANE_BY_LANE[B]
        r = rec[f"dense_B{B}"]
        log(f"  dense batch of {B}: fine {r['fine_s']:.6f} s and codec "
            f"{r['codec_s']:.6f} s of eval {r['eval_s']:.6f} s; lane by "
            f"lane (quoted from PERF.md): eval {earlier_eval} s, the fine "
            f"stage {earlier_share} of it, on {smi}")
    del stages
    torch.cuda.empty_cache()
    rec["q4_0_B8"] = fine_batch_run(bark_small_stages("q4_0"), 8,
                                    packed=True, agree=False)
    torch.cuda.empty_cache()
    rec["profile"] = probe_record("fine_profile")
    if alone:
        with full_f32():
            small_model_batched_reference()
    runs = [rec[f"dense_B{B}"] for B in FB_BATCHES] + [rec["q4_0_B8"]]
    rec["launches"] = {m: sum(r["launches"][m] for r in runs)
                       for m in ("bprefill", "bsemantic", "bwindow")}
    rec["seconds"] = time.perf_counter() - t0
    return rec


# ------------------------------------------------------------ phase 4j

LARGE = "bark-large"
# the bark-large rows of the `kernels` line: (the KERNELS entry each is,
# its launch-count module); each timed in bf16 by `large_kernel_checks`
LARGE_ROWS = (("decode_step_fused", "decode"), ("prefill_fused", "prefill"),
              ("semantic_chunk_fused", "semantic"),
              ("coarse_window_fused", "window"), (f"{K5}[q4_0]", "qdecode"),
              (f"{K7}[B=8]", "bdecode"), (f"{K7}[B=32]", "bdecode"),
              ("prefill_fused_batched", "bprefill"),
              ("semantic_chunk_fused_batched", "bsemantic"),
              ("coarse_window_fused_batched", "bwindow"))


def loop_steps_check(what, cfg, p, logits0, k, v, kc, vc, toks, flags,
                     logits, slots, lm_window, sample, noise_row):
    """Fail unless a step loop is its own step launched once a step, with
    the plain sampler: from the caches (k, v, dense or int8) the loop
    began with, K1's (K5's) step on the loop's tokens at its slots, or
    K7's (K5-batched's) when `slots` holds a row of the lanes' slots a
    step, must give the loop's caches (kc, vc) and, for K3/K9, its logits
    bit for bit; and each step's tokens must be `ops.sampling.sample`'s
    on the logits before it (the step's window of the LoopSample
    `sample`, its temp, the noise rows `noise_row(j)`: (B, >= the
    window)), for K3/K9 its flags the stop test's. toks and flags:
    (steps,) of one lane or (B, steps)."""
    import torch

    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.ops import sampling

    lanes = isinstance(slots[0], list)
    toks = toks.reshape(-1, toks.shape[-1])
    buf, want_toks, want_flags = logits0, [], []
    for j, slot in enumerate(slots):
        rows = buf.reshape(-1, buf.shape[-1])
        base, n = sample.window(j, rows.shape[-1])
        tok, eos_p = sampling.sample(rows[:, base:base + n], sample.temp,
                                     noise_row(j)[:, :n])
        want_toks.append(base + tok)
        want_flags.append((base + tok == sample.stop_token)
                          | (eos_p >= sample.min_eos_p))
        if lanes:
            buf = kbdec.decode_step_fused_batched(
                cfg, p, toks[:, j].contiguous(), k, v,
                _build.device_ints(slot, buf.device), lm_window=lm_window)
        else:
            buf = kdec.decode_step_fused(cfg, p, toks[0, j], k, v, slot,
                                         lm_window=lm_window)
    sampled = torch.equal(torch.stack(want_toks, 1), toks.long()) and (
        flags is None or torch.equal(torch.stack(want_flags, 1),
                                     flags.reshape(toks.shape).bool()))
    flat = [[t for x in pair for t in (x.values() if isinstance(x, dict)
                                       else [x])] for pair in ((k, v),
                                                               (kc, vc))]
    same = (all(torch.equal(a, b) for a, b in zip(*flat))
            and (logits is None or torch.equal(buf, logits)))
    if not (sampled and same):
        raise AssertionError(f"{what}: tokens are the plain sampler's "
                             f"{sampled}, bit-equal to the steps {same}")
    log(f"  {what}: each token the plain sampler's, bit-equal to "
        f"{len(slots)} launches of its step on its tokens")

def large_kernel_checks(checks: Checks, dtype, timed: bool):
    """Phase 4j's kernels for one dtype at bark-large's shapes (24 layers,
    16 heads, width 1024), random weights: K1 at n_past 0/300/1023 and the
    coarse step at 887 on the LM window; K2 at T 257, 887 (LM window) and
    the whole 1024-row context; K5 on q8_0 and q4_0 qpacks; K6 in K1 and
    K2; K7 at B 1/8/32 (32 lanes: 512 (head, lane) units, one a thread),
    K5-batched q8_0 at B 8, K6 in K7 at B 32; K8 over 8 lanes of 257-887
    rows and of 887; each against its plain version. The step loops: in
    f32 K3 (16 steps after 257 rows, and a chunk reaching the clamp), K4
    (60 steps at 887, both parities), K9 (8 lanes x 16) and K10 (32 lanes
    x 60) held to their own steps and the plain sampler
    (`loop_steps_check`), K3 and K4 on the int8 cache token-equal to
    their plain versions; in bf16 K3, K4, K9 and K10 (8 lanes x 60) once
    beside their plain versions: the first step's tokens and K/V rows held.
    Timed in bf16 (`LARGE_ROWS`), each on inputs checked first."""
    import torch

    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.kernels import bdecode as kbdec
    from bark_tpu_torch.kernels import bprefill as kbpre
    from bark_tpu_torch.kernels import bsemantic as kbsem
    from bark_tpu_torch.kernels import bwindow as kbwin
    from bark_tpu_torch.kernels import decode as kdec
    from bark_tpu_torch.kernels import prefill as kpre
    from bark_tpu_torch.kernels import qbdecode as kqb
    from bark_tpu_torch.kernels import qdecode as kq
    from bark_tpu_torch.kernels import semantic as ksem
    from bark_tpu_torch.kernels import window as kwin
    from bark_tpu_torch.models import gpt
    from bark_tpu_torch.models.presets import BARK_LARGE
    from bark_tpu_torch.ops import sampling

    dev = torch.device("cuda")
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    f32 = dtype == torch.float32
    gen = torch.Generator(device=dev).manual_seed(57)
    sem_cfg, coarse_cfg = BARK_LARGE["semantic"], BARK_LARGE["coarse"]
    svs, cbs = 10000, 1024
    lmw = (svs, svs + 2 * cbs)
    sem_p = random_stage_params(sem_cfg, gen, dtype)
    coarse_p = random_stage_params(coarse_cfg, gen, dtype)

    def rows_err(kc, kc2, vc, vc2, idx):
        return max(max_err(kc[idx], kc2[idx]), max_err(vc[idx], vc2[idx]))

    # K1 (and K5 on q8_0 and q4_0 qpacks, K6 in K1 on an int8 cache): one
    # step and its cache row of every layer
    sem_q = {fmt: random_qpack(sem_cfg, fmt, dtype, gen, dev)
             for fmt in ("q8_0", "q4_0")}
    for kname, cfg, p, n_past, win in (
            ("decode_step_fused", sem_cfg, sem_p, 0, None),
            ("decode_step_fused", sem_cfg, sem_p, 300, None),
            ("decode_step_fused", sem_cfg, sem_p, 1023, None),
            ("decode_step_fused", coarse_cfg, coarse_p, 887, lmw),
            (f"{K5}[q8_0]", sem_cfg, sem_q["q8_0"], 300, None),
            (f"{K5}[q4_0]", sem_cfg, sem_q["q4_0"], 300, None),
            (K6_K1, sem_cfg, sem_p, 300, None)):
        kv = kname == K6_K1
        if kv:
            kc, vc = kv8_cache(cfg, n_past, gen)
            kc2, vc2 = kv8_clone(kc), kv8_clone(vc)
        else:
            kc, vc = filled_cache(cfg, n_past, dtype, gen)
            kc2, vc2 = kc.clone(), vc.clone()
        before = (kdec.launches, kq.launches)
        out = kdec.decode_step_fused(cfg, p, 1234, kc, vc, n_past,
                                     lm_window=win)
        packed = kname.startswith(K5)
        if (kdec.launches - before[0], kq.launches - before[1]) != (
                (0, 1) if packed else (1, 0)):
            raise AssertionError(f"{kname}: not one launch of its step")
        ref = kdec.decode_step_plain(cfg, p, 1234, kc2, vc2, n_past, win)
        tag = f"n_past {n_past}" + (" lm_window" if win else "")
        checks.record(kname, name, f"logits {tag}", max_err(out, ref))
        rows = (slice(None), n_past)
        if kv:
            record_kv8_rows(checks, kname, name, f"K/V row {tag}", [
                (gpt.kv_view(kc, rows), gpt.kv_view(kc2, rows)),
                (gpt.kv_view(vc, rows), gpt.kv_view(vc2, rows))])
        else:
            checks.record(kname, name, f"K/V row {tag}",
                          rows_err(kc, kc2, vc, vc2, rows))
        if win is not None and (float(out[:win[0]].abs().max()) != 0.0
                                or float(out[win[1]:].abs().max()) != 0.0):
            raise AssertionError(f"{kname}: logits outside lm_window are "
                                 f"not zero")
        if timed and n_past == 300 and kname != f"{K5}[q8_0]" and not kv:
            tok_t = torch.tensor([1234], dtype=torch.int32, device=dev)
            ms = cuda_ms(lambda: kdec.decode_step_fused(
                cfg, p, tok_t, kc, vc, 300), 50)
            plain = cuda_ms(lambda: kdec.decode_step_plain(
                cfg, p, tok_t, kc, vc, 300), 3)
            checks.times[kname] = (ms, plain, decode_cost(cfg, p, 300))
        del kc, vc, kc2, vc2
    del sem_q
    torch.cuda.empty_cache()

    # K2 at T 257, 887 (LM window) and 1024 (the whole context, LM
    # window), and K6 in K2 at 887 on int8 caches: logits, cache rows,
    # rows past T unwritten, in bf16 two runs bit-equal
    for kname, cfg, p, T, win in (
            ("prefill_fused", sem_cfg, sem_p, 257, None),
            ("prefill_fused", coarse_cfg, coarse_p, 887, lmw),
            ("prefill_fused", coarse_cfg, coarse_p, 1024, lmw),
            (K6_K2, coarse_cfg, coarse_p, 887, lmw)):
        kv = kname == K6_K2
        x_emb = p["wte"][0][torch.randint(0, cfg.n_in_vocab, (T,),
                                          generator=gen, device=dev)]

        def caches():
            if kv:
                return tuple(gpt.kv_view(c, (slice(None), 0)) for c in
                             gpt.init_kv_cache(cfg, None, dev, batch=1,
                                               quant=True))
            return gpt.init_kv_cache(cfg, dtype, dev)

        (kc, vc), (kc2, vc2) = caches(), caches()
        out = kpre.prefill_fused(cfg, p, x_emb, kc, vc, T, lm_window=win)
        ref = kpre.prefill_plain(cfg, p, x_emb, kc2, vc2, T, win)
        checks.record(kname, name, f"logits T {T}", max_err(out, ref))
        if kv:
            idx = (slice(None), slice(0, T))
            record_kv8_rows(checks, kname, name, f"K/V rows T {T}", [
                (gpt.kv_view(c, idx), gpt.kv_view(c2, idx))
                for c, c2 in ((kc, kc2), (vc, vc2))], chained=True)
        else:
            checks.record(kname, name, f"K/V rows T {T}",
                          rows_err(kc, kc2, vc, vc2, (slice(None),
                                                      slice(0, T))))
            prefill_rows_kept(kc, vc, [T], f"{kname} {name} T {T}",
                              lanes=False)
        if not f32:
            kc3, vc3 = caches()
            again = kpre.prefill_fused(cfg, p, x_emb, kc3, vc3, T,
                                       lm_window=win)
            same_bits(f"{kname} bf16 T {T}", (out, kc, vc),
                      (again, kc3, vc3))
        if timed and T == 887 and not kv:
            ms = cuda_ms(lambda: kpre.prefill_fused(
                cfg, p, x_emb, kc, vc, T, lm_window=win), 10)
            plain = cuda_ms(lambda: kpre.prefill_plain(
                cfg, p, x_emb, kc2, vc2, T, win), 3)
            checks.times[kname] = (ms, plain, prefill_cost(cfg, p, T, win))
        del x_emb, kc, vc, kc2, vc2
    torch.cuda.empty_cache()

    # K7 at B 1, 8 and 32 with n_past cycling 0/300/1023 (32 lanes: 16
    # heads x 32 = 512 (head, lane) units, one a thread), K5-batched q8_0
    # at B 8, K6 in K7 at B 32 (lanes at n_past 0 held to TOL_KV8_FIRST)
    sem_q8 = random_qpack(sem_cfg, "q8_0", dtype, gen, dev)
    for kname, p, B in ((K7, sem_p, 1), (K7, sem_p, 8), (K7, sem_p, 32),
                        (f"{K5B}[q8_0]", sem_q8, 8), (K6_K7, sem_p, 32)):
        kv = kname == K6_K7
        n_past = [(0, 300, 1023)[b % 3] for b in range(B)]
        toks = torch.randint(0, sem_cfg.n_in_vocab, (B,), generator=gen,
                             device=dev, dtype=torch.int32)
        if kv:
            kc, vc = kv8_cache(sem_cfg, 1023, gen, batch=B)
            kc2, vc2 = kv8_clone(kc), kv8_clone(vc)
        else:
            kc, vc = filled_batched_cache(sem_cfg, B, 1023, dtype, gen)
            kc2, vc2 = kc.clone(), vc.clone()
        before = (kbdec.launches, kqb.launches)
        out = kbdec.decode_step_fused_batched(sem_cfg, p, toks, kc, vc,
                                              n_past)
        packed = kname.startswith(K5B)
        if (kbdec.launches - before[0], kqb.launches - before[1]) != (
                (0, 1) if packed else (1, 0)):
            raise AssertionError(f"{kname} B {B}: not one launch of its "
                                 f"step")
        ref = kbdec.decode_step_batched_plain(sem_cfg, p, toks, kc2, vc2,
                                              n_past)
        if kv:
            for first in (False, True):
                lanes = [b for b, n in enumerate(n_past) if (n == 0) == first]
                what = f"B {B}, n_past {'0' if first else '> 0'} lanes"
                checks.record(f"{K6_K7} n_past 0" if first else K6_K7, name,
                              f"logits {what}",
                              max_err(out[lanes], ref[lanes]),
                              tol=TOL_KV8_FIRST if first else None)
                record_kv8_rows(checks, K6_K7, name, f"K/V rows {what}", [
                    (gpt.kv_view(c, (slice(None), b, n_past[b])),
                     gpt.kv_view(c2, (slice(None), b, n_past[b])))
                    for b in lanes for c, c2 in ((kc, kc2), (vc, vc2))],
                    chained=first)
        else:
            checks.record(kname, name, f"logits B {B}", max_err(out, ref))
            checks.record(kname, name, f"K/V rows B {B}", max(
                rows_err(kc, kc2, vc, vc2, (slice(None), b, n))
                for b, n in enumerate(n_past)))
        del kc, vc, kc2, vc2
        if timed and kname == K7 and B in (8, 32):
            kc, vc = filled_batched_cache(sem_cfg, B, 300, dtype, gen)
            kc2, vc2 = kc.clone(), vc.clone()
            slots = _build.device_ints([300] * B, dev)
            out = kbdec.decode_step_fused_batched(sem_cfg, p, toks, kc2, vc2,
                                                  slots)
            ref = kbdec.decode_step_batched_plain(sem_cfg, p, toks, kc, vc,
                                                  [300] * B)
            checks.record(kname, name, f"logits B {B} timed, n_past 300",
                          max_err(out, ref))
            del kc2, vc2
            ms = cuda_ms(lambda: kbdec.decode_step_fused_batched(
                sem_cfg, p, toks, kc, vc, slots), 50)
            plain = cuda_ms(lambda: kbdec.decode_step_batched_plain(
                sem_cfg, p, toks, kc, vc, [300] * B), 1)
            checks.times[f"{K7}[B={B}]"] = (
                ms, plain, decode_cost(sem_cfg, p, 300, lanes=B))
            del kc, vc
    del sem_q8
    torch.cuda.empty_cache()

    # K8 over 8 lanes of 257-887 rows and 8 of 887 (timed), LM window
    for n_valid in (list(K6C_MIXED), [887] * 8):
        B, T = len(n_valid), max(n_valid)
        x_emb = coarse_p["wte"][0][torch.randint(
            0, coarse_cfg.n_in_vocab, (B * T,), generator=gen,
            device=dev)].reshape(B, T, -1)
        kc, vc = gpt.init_kv_cache(coarse_cfg, dtype, dev, batch=B)
        kc2, vc2 = gpt.init_kv_cache(coarse_cfg, dtype, dev, batch=B)
        out = kbpre.prefill_fused_batched(coarse_cfg, coarse_p, x_emb, kc, vc,
                                          n_valid, lm_window=lmw)
        ref = kbpre.prefill_batched_plain(coarse_cfg, coarse_p, x_emb, kc2,
                                          vc2, n_valid, lmw)
        tag = f"{B} lanes, n_valid {min(n_valid)}-{max(n_valid)}"
        checks.record("prefill_fused_batched", name, f"logits {tag}",
                      max_err(out, ref))
        checks.record("prefill_fused_batched", name, f"K/V rows {tag}", max(
            rows_err(kc, kc2, vc, vc2, (slice(None), b, slice(0, n)))
            for b, n in enumerate(n_valid)))
        prefill_rows_kept(kc, vc, n_valid, f"K8 {name} {tag}")
        if timed and n_valid == [887] * 8:
            ms = cuda_ms(lambda: kbpre.prefill_fused_batched(
                coarse_cfg, coarse_p, x_emb, kc, vc, n_valid, lm_window=lmw),
                5)
            plain = cuda_ms(lambda: kbpre.prefill_batched_plain(
                coarse_cfg, coarse_p, x_emb, kc2, vc2, n_valid, lmw), 1)
            checks.times["prefill_fused_batched"] = (
                ms, plain, prefill_cost(coarse_cfg, coarse_p, n_valid, lmw))
        del x_emb, kc, vc, kc2, vc2
    torch.cuda.empty_cache()

    # the step loops. Semantic: 257-row prompts (plain prefill), temp 0.7;
    # coarse: random 887-row contexts (887, 700, 500, 257 across lanes)
    # and random logits, LM window
    def sem_start(B):
        x_emb = sem_p["wte"][0][torch.randint(
            0, sem_cfg.n_in_vocab, (B * 257,), generator=gen,
            device=dev)].reshape(B, 257, -1)
        kc, vc = gpt.init_kv_cache(sem_cfg, dtype, dev, batch=B)
        logits = kbpre.prefill_batched_plain(sem_cfg, sem_p, x_emb, kc, vc,
                                             [257] * B)
        return logits, kc, vc

    def coarse_start(B, kv=False):
        logits = torch.randn((B, coarse_cfg.n_out_vocab), generator=gen,
                             device=dev)
        if kv:
            return (logits, *kv8_cache(coarse_cfg, 887, gen, batch=B))
        return (logits, *filled_batched_cache(coarse_cfg, B, 887, dtype,
                                              gen))

    lane0 = lambda c: gpt.kv_view(c, (slice(None), 0))  # noqa: E731
    # K3: one lane, 16 steps; f32 also a chunk whose slots reach the clamp
    # (count0 760 after 257 rows), and 16 steps on an int8 cache
    noise = sampling.gumbel((1, 32, sem_cfg.n_out_vocab), gen, dev)
    logits0, kc0, vc0 = sem_start(1)
    for count0 in ((3, 760) if f32 else (3,)):
        kc, vc = kc0.clone(), vc0.clone()
        if count0 > 3:  # rows up to the chunk's first slot
            for c in (kc, vc):
                c[:, :, 257:257 + count0] = c[:, :, :count0]
        start = (kc.clone(), vc.clone())
        kw = dict(K=16, temp=0.7, semantic_vocab_size=svs)
        args = (257, count0, noise[0], 2.0)
        before = loop_counts()
        toks, flags, lg = ksem.semantic_chunk_fused(
            sem_cfg, sem_p, logits0[0], lane0(kc), lane0(vc), *args, **kw)
        if loop_counts(before) != (1, 0):
            raise AssertionError(f"K3 {name}: not one launch of the step "
                                 f"loop and none of K1")
        tag = f"K3 {name} count0 {count0}" + (" (clamp)" if count0 > 3
                                               else "")
        _, _, sample = ksem.chunk_loop(sem_cfg, 257, count0, 0.7, svs, 2.0)
        slots = [min(257 + count0 + j, sem_cfg.block_size - 1)
                 for j in range(16)]
        if f32:
            loop_steps_check(
                tag, sem_cfg, sem_p, logits0[0], *map(lane0, start),
                lane0(kc), lane0(vc), toks, flags, lg, slots, None, sample,
                lambda j: noise[:, sample.noise_row(j, 32)])
            continue
        (rtoks, _, _), plain = once_ms(
            lambda: ksem.semantic_chunk_plain(
                sem_cfg, sem_p, logits0[0], lane0(start[0]),
                lane0(start[1]), *args, **kw))
        loop_first_step(checks, "semantic_chunk_fused", name, tag, toks,
                        rtoks, (kc, vc), start, slots[:1])
        if timed:
            kc, vc = kc0.clone(), vc0.clone()
            ms = cuda_ms(lambda: ksem.semantic_chunk_fused(
                sem_cfg, sem_p, logits0[0], lane0(kc), lane0(vc), *args,
                **kw), 3)
            nb, fl = decode_cost(sem_cfg, sem_p, 257 + 3, steps=16)
            checks.times["semantic_chunk_fused"] = (
                ms, plain, (nb + 16 * sem_cfg.n_out_vocab * 4, fl))
    del kc0, vc0
    if f32:  # K3 on the int8 cache: tokens and flags equal
        logits0 = torch.randn((sem_cfg.n_out_vocab,), generator=gen,
                              device=dev)
        kc, vc = (lane0(c) for c in kv8_cache(sem_cfg, 257, gen, batch=1))
        kc2, vc2 = kv8_clone(kc), kv8_clone(vc)
        kw = dict(K=16, temp=0.7, semantic_vocab_size=svs)
        got = ksem.semantic_chunk_fused(sem_cfg, sem_p, logits0, kc, vc, 257,
                                        3, noise[0], 2.0, **kw)
        want = ksem.semantic_chunk_plain(sem_cfg, sem_p, logits0, kc2, vc2,
                                         257, 3, noise[0], 2.0, **kw)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError("K3 on the int8 cache: tokens/flags differ")
        checks.record(K6_K3, name, "logits after 16 steps",
                      max_err(got[2], want[2]))
        del kc, vc, kc2, vc2
    torch.cuda.empty_cache()

    # K4: one lane, 60 steps at context 887; f32 both parities and 60
    # steps on an int8 cache
    noise = sampling.gumbel((60, 1, cbs), gen, dev)
    logits0, kc0, vc0 = coarse_start(1)
    kw = dict(sws=60, temp=0.7, semantic_vocab_size=svs, codebook_size=cbs,
              lm_window=lmw)
    for step0 in ((1, 0) if f32 else (1,)):
        kc, vc = kc0.clone(), vc0.clone()
        before = loop_counts()
        toks = kwin.coarse_window_fused(coarse_cfg, coarse_p, logits0[0],
                                        lane0(kc), lane0(vc), 887, step0,
                                        noise[:, 0], **kw)
        if loop_counts(before) != (1, 0):
            raise AssertionError(f"K4 {name}: not one launch of the step "
                                 f"loop and none of K1")
        tag = f"K4 {name} parity {'odd' if step0 else 'even'}"
        _, _, sample = kwin.window_loop(coarse_cfg, 887, step0, 0.7, svs,
                                        cbs)
        if f32:
            loop_steps_check(
                tag, coarse_cfg, coarse_p, logits0[0], lane0(kc0.clone()),
                lane0(vc0.clone()), lane0(kc), lane0(vc), toks, None, None,
                [887 + j for j in range(60)], lmw, sample,
                lambda j: noise[sample.noise_row(j, 60)])
            continue
        k, v = kc0.clone(), vc0.clone()
        rtoks, plain = once_ms(lambda: kwin.coarse_window_plain(
            coarse_cfg, coarse_p, logits0[0], lane0(k), lane0(v), 887, step0,
            noise[:, 0], **kw))
        loop_first_step(checks, "coarse_window_fused", name, tag, toks,
                        rtoks, (kc, vc), (k, v), [887])
        if timed:
            ms = cuda_ms(lambda: kwin.coarse_window_fused(
                coarse_cfg, coarse_p, logits0[0], lane0(kc0), lane0(vc0),
                887, 1, noise[:, 0], **kw), 2)
            nb, fl = decode_cost(coarse_cfg, coarse_p, 887, lmw, steps=60)
            checks.times["coarse_window_fused"] = (
                ms, plain, (nb + 60 * cbs * 4, fl))
    del kc0, vc0
    if f32:  # K4 on the int8 cache: tokens equal
        logits0, kc, vc = coarse_start(1, kv=True)
        kc, vc = lane0(kc), lane0(vc)
        kc2, vc2 = kv8_clone(kc), kv8_clone(vc)
        toks = kwin.coarse_window_fused(coarse_cfg, coarse_p, logits0[0], kc,
                                        vc, 887, 1, noise[:, 0], **kw)
        rtoks = kwin.coarse_window_plain(coarse_cfg, coarse_p, logits0[0],
                                         kc2, vc2, 887, 1, noise[:, 0], **kw)
        if not torch.equal(toks, rtoks):
            raise AssertionError("K4 on the int8 cache: tokens differ")
        idx = (slice(None), slice(887, 947))
        record_kv8_rows(checks, K6_K4, name, "K/V rows of a 60-step window",
                        [(gpt.kv_view(c, idx), gpt.kv_view(c2, idx))
                         for c, c2 in ((kc, kc2), (vc, vc2))], chained=True)
        log(f"  K3 (16 steps) and K4 (60 steps) on the int8 cache, f32: "
            f"tokens equal to their plain versions")
        del kc, vc, kc2, vc2
    torch.cuda.empty_cache()

    # K9: 16 steps of 8 lanes after 257-row prompts
    B = 8
    noise = sampling.gumbel((B, 32, sem_cfg.n_out_vocab), gen, dev)
    logits0, kc0, vc0 = sem_start(B)
    kc, vc = kc0.clone(), vc0.clone()
    kw = dict(K=16, temp=0.7, semantic_vocab_size=svs)
    args = (257, 3, noise, 2.0)
    before = lane_counts()
    toks, flags, lg = kbsem.semantic_chunk_fused_batched(
        sem_cfg, sem_p, logits0, kc, vc, *args, **kw)
    if lane_counts(before) != (1, 0):
        raise AssertionError(f"K9 {name}: not one launch of the batched "
                             f"loop and none of K7's step")
    slots, sample = kbsem.chunk_lane_loop(sem_cfg, 257, 3, 16, 0.7, svs, 2.0,
                                          B)
    tag = f"K9 {name} {B} lanes"
    k, v = kc0.clone(), vc0.clone()
    if f32:
        loop_steps_check(
            tag, sem_cfg, sem_p, logits0, k, v, kc, vc, toks, flags, lg,
            slots, None, sample, lambda j: noise[:, sample.noise_row(j, 32)])
    else:
        (rtoks, _, _), plain = once_ms(
            lambda: kbsem.semantic_chunk_batched_plain(
                sem_cfg, sem_p, logits0, k, v, *args, **kw))
        loop_first_step(checks, "semantic_chunk_fused_batched", name, tag,
                        toks, rtoks, (kc, vc), (k, v), slots[:1])
        if timed:
            ms = cuda_ms(lambda: kbsem.semantic_chunk_fused_batched(
                sem_cfg, sem_p, logits0, kc0, vc0, *args, **kw), 3)
            nb, fl = decode_cost(sem_cfg, sem_p, 257 + 3, steps=16, lanes=B)
            checks.times["semantic_chunk_fused_batched"] = (
                ms, plain, (nb + B * 16 * sem_cfg.n_out_vocab * 4, fl))
    del noise, kc0, vc0, kc, vc, k, v
    torch.cuda.empty_cache()

    # K10: 60 steps; f32 over 32 lanes (the batched path's largest
    # window), bf16 over 8 (timed, beside its plain version)
    B = 32 if f32 else 8
    ctx_len = [(887, 700, 500, 257)[b % 4] for b in range(B)]
    noise = sampling.gumbel((60, B, cbs), gen, dev)
    logits0, kc0, vc0 = coarse_start(B)
    kc, vc = kc0.clone(), vc0.clone()
    kw = dict(sws=60, temp=0.7, semantic_vocab_size=svs, codebook_size=cbs,
              lm_window=lmw)
    before = lane_counts()
    toks = kbwin.coarse_window_fused_batched(
        coarse_cfg, coarse_p, logits0, kc, vc, ctx_len, 1, noise, **kw)
    if lane_counts(before) != (1, 0):
        raise AssertionError(f"K10 {name}: not one launch of the batched "
                             f"loop and none of K7's step")
    slots, sample = kbwin.window_lane_loop(ctx_len, 1, 60, 0.7, svs, cbs)
    tag = f"K10 {name} {B} lanes"
    k, v = kc0.clone(), vc0.clone()
    if f32:
        loop_steps_check(
            tag, coarse_cfg, coarse_p, logits0, k, v, kc, vc, toks, None,
            None, slots, lmw, sample,
            lambda j: noise[sample.noise_row(j, 60)])
    else:
        rtoks, plain = once_ms(lambda: kbwin.coarse_window_batched_plain(
            coarse_cfg, coarse_p, logits0, k, v, ctx_len, 1, noise, **kw))
        loop_first_step(checks, "coarse_window_fused_batched", name, tag,
                        toks, rtoks, (kc, vc), (k, v), slots[:1])
        if timed:
            ms = cuda_ms(lambda: kbwin.coarse_window_fused_batched(
                coarse_cfg, coarse_p, logits0, kc0, vc0, ctx_len, 1, noise,
                **kw), 2)
            nb, fl = decode_cost(coarse_cfg, coarse_p, 887, lmw, steps=60,
                                 lanes=B)
            checks.times["coarse_window_fused_batched"] = (
                ms, plain, (nb + 60 * B * cbs * 4, fl))
    del noise, kc0, vc0, kc, vc, k, v
    torch.cuda.empty_cache()


def loop_first_step(checks, kname, name, what, toks, rtoks, run, plain,
                    slots):
    """A bf16 step loop beside its plain version run once on the same
    inputs: its first step's tokens, sampled from the same logits, must be
    equal and the K/V rows that step wrote (lane b's at slots[0][b], or
    one lane's at slots[0]) within TOL; a near-tie argmax may flip a
    later token, so the rest are counted, not held."""
    toks, rtoks = toks.reshape(-1, toks.shape[-1]), rtoks.reshape(
        -1, rtoks.shape[-1])
    first = slots[0] if isinstance(slots[0], list) else [slots[0]]
    if not bool((toks[:, 0] == rtoks[:, 0]).all()):
        raise AssertionError(f"{what}: the first step's tokens differ")
    (kc, vc), (kc2, vc2) = run, plain
    lanes = kc.dim() == 4
    err = max(max_err(c[:, b, n] if lanes else c[:, n],
                      c2[:, b, n] if lanes else c2[:, n])
              for b, n in enumerate(first) for c, c2 in ((kc, kc2),
                                                         (vc, vc2)))
    checks.record(kname, name, "K/V rows of the first step", err)
    same = int((toks == rtoks).sum())
    log(f"  {what}: tokens equal to the plain version's {same}/"
        f"{toks.numel()}, the first step's all")


def large_phase(smi: str) -> dict:
    """Phase 4j: bark-large (24 layers, 16 heads, width 1024) on the card.
    (a) `large_kernel_checks` in f32 (TF32 off) and bf16; (b) bench.py's
    workload on bark-large's stages from a seed (`bark_stages`, random
    bf16 weights): 3 dense requests (RTF from requests 2-3), 1 on the
    int8 cache, 1 on q8_0 qpacks, and a `generate_audio_batch` of 8 dense
    prompts (after a first batch of 2, not kept), each driven with the
    launch counts set to 0 just before and read just after
    (`bark_small_requests`, `bark_small_batch`: every chunk and window one
    launch of the step loop), and no plain version run while they run.
    Returns its record: seconds, peak memory (the checks', the dense and
    int8 requests', the batch's; beside what was allocated before each,
    earlier phases' included), the requests and the batch, its kernel rows
    (`LARGE_ROWS`: ms, plain ms, bound, errors, launches in its runs)."""
    import torch

    t0 = time.perf_counter()
    checks = Checks()
    rec = dict(card=smi, peak_bytes={}, base_bytes={})

    def peak_from(part):  # the peak from now on, and what was held before
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec["base_bytes"][part] = torch.cuda.memory_allocated()

    def peak_of(part):
        rec["peak_bytes"][part] = torch.cuda.max_memory_allocated()

    peak_from("checks")
    with full_f32():
        for dtype in (torch.float32, torch.bfloat16):
            log(f"phase 4j: bark-large kernels vs plain, {dtype}")
            large_kernel_checks(checks, dtype, timed=dtype == torch.bfloat16)
    peak_of("checks")
    rec["checks_s"] = time.perf_counter() - t0
    peak_from("requests")
    need = ("prefill", "semantic", "window")
    with counted_plain_calls() as plain:
        stages = bark_stages(model="large")
        dense, dense_counts = bark_small_requests(stages, 3, "bark-large",
                                                  need)
        kv8, kv8_counts = bark_small_requests(stages, 1, "bark-large kv8",
                                              need + ("kv8",), kv8=True)
        peak_of("requests")
        bark_small_batch(stages, 2)  # first use of the batched path
        peak_from("batch8")
        batch = bark_small_batch(stages, 8)
        peak_of("batch8")
        del stages
        torch.cuda.empty_cache()
        q8, q8_counts = bark_small_requests(bark_stages("q8_0", "large"), 1,
                                            "bark-large q8_0", need,
                                            packed=True)
    if any(plain.values()):
        raise AssertionError(f"phase 4j: a plain version ran: {plain}")
    torch.cuda.empty_cache()
    runs = (dense_counts, kv8_counts, q8_counts, batch["launches"])
    rec.update(requests=dense, rtf=rtf(dense[1:]), requests_kv8=kv8,
               rtf_kv8=rtf(kv8), requests_q8_0=q8, rtf_q8_0=rtf(q8),
               batch8=batch, launches={m: sum(c[m] for c in runs)
                                       for m in runs[0]})
    log(f"  bark-large RTF (dense bf16, requests 2-3): {rec['rtf']:.4f}; "
        f"int8 cache {rec['rtf_kv8']:.4f}; q8_0 {rec['rtf_q8_0']:.4f} on "
        f"{smi}")
    log_requests("bark-large dense", dense)
    log_requests("bark-large kv8", kv8)
    log_requests("bark-large q8_0", q8)
    log(f"  bark-large batch of 8: eval {batch['eval_s']:.3f} s = semantic "
        f"{batch['semantic_s']:.3f} + coarse {batch['coarse_s']:.3f} + fine "
        f"{batch['fine_s']:.3f} + codec/rest {batch['codec_s']:.3f} s; "
        f"{batch['audio_s_per_wall_s']:.3f} audio-s per wall-s")
    log("  bark-large peak memory (torch.cuda.max_memory_allocated; "
        "allocated before it): " + ", ".join(
            f"{k} {v / 2**30:.3f} GiB ({rec['base_bytes'][k] / 2**30:.3f})"
            for k, v in rec["peak_bytes"].items()))
    rows = []
    for name, module in LARGE_ROWS:
        src, replaces, _ = KERNELS[name]
        ms, plain_ms, cost = checks.times[name]
        bound_ms, bound_by = bound(cost, "bfloat16")
        key = name.split("[B=")[0]
        launches = rec["launches"][module]
        log(f"  {LARGE} {name:30s} {ms:9.3f} ms  plain {plain_ms:9.3f} ms  "
            f"bound {bound_ms:7.4f} ms ({bound_by})  launches {launches}")
        rows.append(dict(
            name=f"{LARGE} {name}", route="cuda", source=src,
            replaces=replaces, launches=launches, state="ported",
            max_abs_err=checks.errors[(key, "bfloat16")],
            # None for a loop: held in f32 to its own steps, bit for bit
            max_abs_err_f32=checks.errors.get((key, "float32")),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, bytes=cost[0], flops=cost[1], model=LARGE))
    rec.update(kernels=rows, accuracy={
        f"{k} {d}": e for (k, d), e in sorted(checks.errors.items())},
        kv8_flips={f"{k} {d}": v for (k, d), v in
                   sorted(checks.kv8_flips.items())})
    rec["seconds"] = time.perf_counter() - t0
    return rec


# ------------------------------------------------------------ D1-D5


DMA_REPLACES = {  # form -> (row name, the reference's pallas_call line)
    "stream": ("dma_stream (D1)", "tools/tpu_dma_probe.py:55"),
    "dot": ("dma_stream_dot (D2)", "tools/tpu_dma_probe.py:106"),
    "dotgroup": ("dma_stream_dotgroup (D3)", "tools/tpu_dma_probe.py:163"),
    "chain": ("dma_stream_chain (D4)", "tools/tpu_dma_probe.py:235"),
    "dual": ("dma_stream2 (D5)", "tools/tpu_dma_probe.py:287"),
}
DMA_SOURCE = "bark_tpu_torch/csrc/dma_probe.cu"
DMA_MB = 256  # a pass: five times the 50 MB L2, so it reads device memory
DMA_STAGE_KB = (8, 16, 32)
DMA_RINGS = (2, 3, 4)
# D4 is held against plain on the first tiles of the 256 MB array: a chain
# of 8 links keeps x in bf16's normal range (each link scales it by
# ~0.03-0.06), where a whole pass of 32-128 links ends in zeros
DMA_CHAIN_CHECK_TILES = 8


@contextlib.contextmanager
def dma_uncounted():
    """Launches made to hold a probe against its plain version: they do
    not count toward the main path's launches."""
    from bark_tpu_torch.probes import dma

    before = dict(dma.launches)
    try:
        yield
    finally:
        dma.launches.update(before)


def dma_inputs(form: str, N: int, R: int, G: int, seed: int, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randn((N, R, 1024), generator=gen, device=dev).to(
        torch.bfloat16)
    xlen = 1024 if form == "chain" else G * R
    x = (None if form in ("stream", "dual") else
         torch.randn((1, xlen), generator=gen, device=dev).to(torch.bfloat16))
    return src, x


def dma_check(errors, form, method, what, run, src, x, passes, G):
    """Hold a probe's (out, checksum) on (src, x) against its plain
    version's; the largest |out - plain| per form goes to `errors`."""
    import torch

    from bark_tpu_torch.probes import dma

    with dma_uncounted():
        got = run(src, x)
        torch.cuda.synchronize()
    want = dma.plain(form, src, x, passes, G)
    ratio = dma.excess(form, got, want, src, x, passes, G)
    err = max_err(got[0], want[0])
    errors[form] = max(errors.get(form, 0.0), err)
    ok = ratio <= 1.0  # False for NaN
    log(f"  {DMA_REPLACES[form][0]:26s} {method:8s} {what:34s} max|err| "
        f"{err:.3e}  {ratio:.3f} of tol  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{form} {method} {what}: {ratio:.3f} of tol")


def dma_kernel_checks(errors):
    """Phase 2 for D1-D5: every form and load method against its plain
    version on the card at small sizes, at every stage size: D1, D2, D5 at
    N 8, R 16 (rings 2 and 4 for the ring methods); D3 at G 2 and 4 with N
    8 > ring 4 (the reference's hazard case); D4 at R 1024, N 4, G 1/2/4,
    and G 2 at N 8 > ring 4. out and the checksum within 1e-5 of (|plain|
    + the sum of the terms' magnitudes); D4's x within 1.6e-2 of each
    value's magnitude plus the vector's rms, and its checksum within 1.6e-2
    of the last link's terms' magnitudes (`probes.dma.excess`)."""
    import torch

    from bark_tpu_torch.probes import dma

    dev = torch.device("cuda")
    cases = [(f, 8, 16, 1) for f in ("stream", "dot", "dual")]
    cases += [("dotgroup", 8, 16, G) for G in (2, 4)]
    cases += [("chain", 4, 1024, G) for G in (1, 2, 4)]
    cases += [("chain", 8, 1024, 2)]
    passes = 2
    for form, N, R, G in cases:
        src, x = dma_inputs(form, N, R, G, seed=N + G, dev=dev)
        for method, ring, kb, ok in dma.sweep(form, G, rings=(2, 4),
                                              stage_kbs=DMA_STAGE_KB):
            if not ok:
                log(f"  skip {form} {method} ring {ring} {kb} KB: rings "
                    f"exceed shared memory")
                continue
            dma_check(errors, form, method,
                      f"N {N} R {R} G {G} ring {ring} {kb} KB",
                      dma.make(form, N, R, ring, passes, G, method, kb),
                      src, x, passes, G)


def dma_sweep(errors):
    """Phase 5: D1-D5 at 256 MB a pass (N 128 tiles of R 1024 rows) over
    method x stage size x ring, each timed by `probes.dma.bandwidth` and
    its result held against the plain version (one pass; D4, at G 1, 2
    and 4, on a chain over the array's first DMA_CHAIN_CHECK_TILES tiles).
    Beside them the yardsticks, which are not the port: src.sum in f32 for
    the stream, a cuBLAS GEMV of (1, N R) by (N R, 1024) for the dots
    (each the library call of its form's row), and matmul + tanh per link
    for the chain. Returns (the dma_probe record, the kernel table's
    timing per form)."""
    import torch

    from bark_tpu_torch.probes import dma

    dev = torch.device("cuda")
    R = 1024
    N = DMA_MB * (1 << 20) // (R * dma.ROW_BYTES)
    pass_bytes = N * R * dma.ROW_BYTES
    configs, best, timing = [], {}, {}
    jobs = [("stream", 1), ("dot", 1), ("dual", 1), ("dotgroup", 2),
            ("dotgroup", 4), ("chain", 1), ("chain", 2), ("chain", 4)]
    src = chain_ms = None
    for form, G in jobs:
        del src
        src, x = dma_inputs(form, N, R, G, seed=G, dev=dev)
        key = f"{form}{G}" if form in ("dotgroup", "chain") else form
        # D4's check: a short chain, whose x stays normal
        held = (src[:DMA_CHAIN_CHECK_TILES] if form == "chain" else src)
        for method, ring, kb, ok in dma.sweep(form, G, rings=DMA_RINGS,
                                              stage_kbs=DMA_STAGE_KB):
            tag = f"{key} {method} ring {ring} {kb} KB"
            if not ok:
                log(f"  {tag}: skipped, rings exceed shared memory")
                configs.append(dict(form=key, method=method, ring=ring,
                                    stage_kb=kb, skipped="shared memory"))
                continue
            r = dma.bandwidth(form, src, x, ring=ring, group=G,
                              method=method, stage_kb=kb, p_lo=4, p_hi=24)
            dma_check(errors, form, method,
                      f"{held.numel() >> 19} MB, {tag}",
                      dma.make(form, held.shape[0], R, ring, 1, G, method,
                               kb), held, x, 1, G)
            c = dict(form=key, method=method, ring=ring, stage_kb=kb, **r)
            configs.append(c)
            log(f"  {tag}: {r['gbs']:7.1f} GB/s ({100 * r['share']:.1f}% "
                f"of 3.35 TB/s)" + (f", {r['us_per_link']:.2f} us/link"
                                    if form == "chain" else ""))
            if key not in best or r["gbs"] > best[key]["gbs"]:
                best[key] = c
        if form == "chain":
            best[key]["device_us_per_link"] = dma_link_device_us(
                src, x, best[key], N, R, G)
            if G == 1:  # the yardstick: matmul + tanh a link
                chain_ms = device_ms(lambda: dma_chain_library(src, x), 3)
        # the kernel table's row of this form: its best configuration at
        # the first group the sweep runs it at
        if form not in timing:
            b = best[key]
            run = dma.make(form, N, R, b["ring"], 1, G, b["method"],
                           b["stage_kb"])
            ms = device_ms(lambda: run(src, x), 10)
            plain_ms = device_ms(lambda: dma.plain(form, src, x, 1, G), 3)
            timing[form] = dict(config=key, method=b["method"],
                                ring=b["ring"], stage_kb=b["stage_kb"],
                                ms=ms, plain_ms=plain_ms,
                                library_ms=dma_library_ms(form, src, x, G),
                                bytes=pass_bytes + (0 if x is None
                                                    else nbytes(x)) + 516)
    del src
    torch.cuda.empty_cache()
    sum_ms, gemv_ms = (timing[f]["library_ms"] for f in ("stream", "dot"))
    yard = dict(sum_gbs=pass_bytes / sum_ms / 1e6, sum_ms=sum_ms,
                gemv_gbs=pass_bytes / gemv_ms / 1e6, gemv_ms=gemv_ms,
                chain_us_per_link=chain_ms * 1e3 / N,
                chain_gbs=pass_bytes / chain_ms / 1e6)
    return dict(mb_per_pass=DMA_MB, bytes_per_pass=pass_bytes, N=N, R=R,
                p_lo=4, p_hi=24, chain_check_tiles=DMA_CHAIN_CHECK_TILES,
                configs=configs, best=best, yardsticks=yard), timing


def dma_chain_library(src, x):
    """The chain's yardstick: (1, 1024) x (1024, 1024) matmul + tanh a
    link, over every tile of src."""
    import torch

    y = x
    for i in range(src.shape[0]):
        y = torch.tanh(torch.matmul(y, src[i]) * 1e-3)
    return y


def dma_link_device_us(src, x, b, N, R, G):
    """The device time of one D4 link kernel (torch.profiler over one pass
    of N / G links), so that a link's time splits into the kernel and the
    gaps between launches; None when the profiler shows no device time."""
    from bark_tpu_torch.probes import dma
    from bark_tpu_torch.probes._timing import profiled_us

    run = dma.make("chain", N, R, b["ring"], 1, G, b["method"], b["stage_kb"])
    return profiled_us(lambda: run(src, x), "probe_")


def dma_library_ms(form, src, x, G):
    """One PyTorch call computing the same function, where there is one:
    src.sum in f32 (D1, D5), a (1, N R) x (N R, 1024) matmul with x tiled
    to N R (D2, D3); none for the chain."""
    import torch

    N, R, _ = src.shape
    flat = src.view(N * R, 1024)
    if form in ("stream", "dual"):
        return device_ms(lambda: src.sum(dtype=torch.float32), 10)
    if form in ("dot", "dotgroup"):
        xt = x.repeat(1, N // G).contiguous()
        return device_ms(lambda: torch.matmul(xt, flat), 10)
    return None


# C1-C3, the cache probe (`bark_tpu_torch.probes.cache`): row -> (the
# JAX package's pallas_call it replaces, the port's source)
CACHE_SOURCE = "bark_tpu_torch/csrc/cache_probe.cu"
CACHE_ROWS = {
    "cache_probe_double (C1)": ("tools/tpu_cache_probe.py:64", CACHE_SOURCE),
    "scan_double (C2)": ("tools/tpu_cache_probe.py:71", CACHE_SOURCE),
    "shifted_sass (C3)": ("tests/test_cache.py:32", CACHE_SOURCE),
}
CACHE_ODD_N = 1_000_003  # C1 at an n that fills no block evenly
SUBPROCESS_TIMEOUT_S = 300


def cache_kernel_checks() -> dict:
    """Phase 5b: C1 bit-equal to its plain version on a seeded (8, 128)
    and an odd n, C2 from ones equal to the reference's 1024.0 and to its
    plain version, each timed at (8, 128) beside the plain version and
    `x * 2.0` (device time, launches queued behind a device sleep); C3:
    C1's source shifted by 0 and 7 comment lines compiles to the same SASS
    and keys to the library's object, and a code edit changes the key;
    the shifted copy, linked and loaded alone, bit-equal to the plain
    version and timed the same way. Returns each row's numbers and the
    shifted library."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.probes import cache

    dev = torch.device("cuda")
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(8, 128).astype(np.float32)).to(dev)
    odd = torch.from_numpy(rng.randn(CACHE_ODD_N).astype(np.float32)).to(dev)
    for t in (x, odd):
        got, want = cache.double(t), cache.double_plain(t)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"C1 at {tuple(t.shape)}: max |err| "
                                 f"{max_err(got, want)}, want bit-equal")
    ones = torch.ones((8, 128), device=dev)
    scan, scan_plain = cache.scan_double(ones), cache.scan_double_plain(ones)
    if scan.item() != 1024.0 or scan_plain.item() != 1024.0:
        raise AssertionError(f"C2 from ones: kernel {scan.item()}, plain "
                             f"{scan_plain.item()}, want 1024.0")
    c1 = dict(ms=device_ms(lambda: cache.double(x), 200),
              plain_ms=device_ms(lambda: cache.double_plain(x), 200),
              library_ms=device_ms(lambda: x * 2.0, 200),
              bytes=2 * nbytes(x), max_abs_err=0.0)
    c2 = dict(ms=device_ms(lambda: cache.scan_double(ones), 50),
              plain_ms=device_ms(lambda: cache.scan_double_plain(ones), 50),
              library_ms=None, bytes=nbytes(ones) + 4,
              max_abs_err=abs(scan.item() - scan_plain.item()))
    t0 = time.perf_counter()
    sass0, key0, _ = cache.shifted_sass(0)
    sass7, key7, shifted = cache.shifted_sass(7)
    compile_s = time.perf_counter() - t0
    lib_key = _build.object_key(_build.SRC_DIR / cache.SOURCE)
    with tempfile.TemporaryDirectory() as tmp:
        edited = Path(tmp) / cache.SOURCE
        edited.write_text((_build.SRC_DIR / cache.SOURCE).read_text()
                          .replace("x[i] * 2.0f", "x[i] * 3.0f"))
        edit_key = _build.object_key(edited)
    log(f"  C3: SASS of 0 and 7 pad lines {len(sass0.splitlines())} and "
        f"{len(sass7.splitlines())} lines, equal {sass0 == sass7}; keys "
        f"{key0} {key7}, the library's {lib_key}, after a code edit "
        f"{edit_key}; two compiles and links {compile_s:.2f} s")
    if sass0 != sass7:
        with open(os.path.join(OUT_DIR, "c3_sass.txt"), "w") as f:
            f.write(sass0 + "\n\n==== 7 pad lines ====\n\n" + sass7)
        raise AssertionError("C3: a 7-line shift changed the SASS "
                             "(chiprun_out/c3_sass.txt): key on raw bytes")
    if not key0 == key7 == lib_key or edit_key == key0:
        raise AssertionError(f"C3 keys: shifted {key0} {key7}, library "
                             f"{lib_key}, edited {edit_key}")
    got = cache.shifted_double(shifted, x)
    torch.cuda.synchronize()
    if not torch.equal(got, cache.double_plain(x)):
        raise AssertionError(f"C3 (8, 128): max |err| "
                             f"{max_err(got, cache.double_plain(x))}")
    c3 = dict(ms=device_ms(lambda: cache.shifted_double(shifted, x), 200),
              plain_ms=device_ms(lambda: cache.double_plain(x), 200),
              library_ms=device_ms(lambda: x * 2.0, 200),
              bytes=2 * nbytes(x), max_abs_err=0.0, compile_s=compile_s,
              sass_lines=len(sass7.splitlines()), key=key7,
              same_key_as="C1")
    log(f"  C1 (8, 128): {c1['ms'] * 1e3:.2f} us, plain "
        f"{c1['plain_ms'] * 1e3:.2f} us, x * 2.0 "
        f"{c1['library_ms'] * 1e3:.2f} us; C2: {c2['ms'] * 1e3:.2f} us, "
        f"plain {c2['plain_ms'] * 1e3:.2f} us; C3 (7 lines shifted, its "
        f"own library) {c3['ms'] * 1e3:.2f} us")
    return dict(zip(CACHE_ROWS, (c1, c2, c3))), shifted


# P1-P9, the lowering probe (`bark_tpu_torch.probes.lowering`): name ->
# (the table's row, the JAX package's pallas_call it replaces)
LOWERING_SOURCE = "bark_tpu_torch/csrc/lowering_probe.cu"
LOWERING_ROWS = {
    "probe_while_loop": ("while_loop (P1)", "tools/tpu_mosaic_probe.py:71"),
    "probe_vector_to_smem_scalar": ("vector_to_smem_scalar (P2)",
                                    "tools/tpu_mosaic_probe.py:95"),
    "probe_scalar_dma_row": ("scalar_dma_row (P2b)",
                             "tools/tpu_mosaic_probe.py:127"),
    "probe_dynamic_leading_dma": ("dynamic_leading_dma (P3)",
                                  "tools/tpu_mosaic_probe.py:162"),
    "probe_dynamic_vmem_read": ("dynamic_vmem_read (P4)",
                                "tools/tpu_mosaic_probe.py:196"),
    "probe_dynamic_vmem_write": ("dynamic_vmem_write (P5)",
                                 "tools/tpu_mosaic_probe.py:227"),
    "probe_dyn_ring_stream": ("dyn_ring_stream (P6)",
                              "tools/tpu_mosaic_probe.py:283"),
    "probe_dynamic_hbm_write": ("dynamic_hbm_write (P7)",
                                "tools/tpu_mosaic_probe.py:315"),
    "probe_dynamic_hbm_write_rowoff": ("dynamic_hbm_write_rowoff (P8)",
                                       "tools/tpu_mosaic_probe.py:350"),
    "probe_transposed_group_dot": ("transposed_group_dot (P9)",
                                   "tools/tpu_mosaic_probe.py:391"),
}
# tolerances of a lowering probe against its plain version, by kind:
# data movement and integer results bit-equal; f32 sums the kernel takes in
# the plain version's order within 1e-6 of each value; P9 at the
# reference's f32 atol 1e-4; P9 on bf16 within 1e-5 of the sum of the
# products' magnitudes, by either method: the products of bf16 values are
# exact in f32, and f32 sums of up to 768 of them in another order (f32
# FMAs, or the tensor cores' order) differ by less (a wrong operand layout
# errs by the order of the sum itself)
LP_TOL = {"exact": 0.0, "sum": 1e-6, "dot_f32": 1e-4, "simt_bf16": 1e-5,
          "wgmma_bf16": 1e-5}


def lp_check(errors, name, what, got, want, kind, mag=None):
    """Hold a lowering probe's output against its plain version's: `kind`
    picks the tolerance (LP_TOL); `mag`, for P9 on bf16, the sum of the
    products' magnitudes. The largest |got - want| per probe goes to
    `errors`."""
    import torch

    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name} {what}: shape {tuple(got.shape)}, "
                             f"want {tuple(want.shape)}")
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    tol = LP_TOL[kind]
    if kind == "exact":
        ratio = 0.0 if torch.equal(got, want) else float("inf")
    elif kind == "sum":
        ratio = float((diff / (tol * want.abs())).nan_to_num(
            nan=0.0, posinf=float("inf")).max())
    elif kind == "dot_f32":
        ratio = err / tol
    else:
        ratio = float((diff / (tol * mag)).max())
    errors[name] = max(errors.get(name, 0.0), err)
    ok = ratio <= 1.0
    log(f"  {LOWERING_ROWS[name][0]:30s} {what:44s} max|err| {err:.3e}  "
        f"{kind} tol {tol:.0e}: {ratio:.3f}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {what}: {ratio:.3f} of its tolerance")


def lowering_kernel_checks(errors):
    """Phase 2 for P1-P9: each probe's kernel against its plain version on
    the card, at the reference's shapes and inputs, at seeded inputs (P2
    with tied maxima and a NaN, P2b at tokens 0/93/255, P8 at offsets on
    and off its 8-row grid and outside its buffer) and at the sweep's
    bark-small sizes (P9 by both methods, P6 on 132 blocks); P8 also
    leaves every row outside its window as it was."""
    import numpy as np
    import torch

    from bark_tpu_torch.probes import lowering as lp

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def randn(*shape, dtype=torch.float32):
        return t(rng.standard_normal(shape).astype(np.float32), dtype)

    ref = lp.reference_inputs(dev)
    # P1: every method at the reference's 7 and at 0, 1, 60, 1024, -3
    for n in (7, 0, 1, 60, 1024, -3):
        x = torch.full((1, 1), n, dtype=torch.int32, device=dev)
        for method in lp.WHILE_METHODS:
            lp_check(errors, "probe_while_loop", f"{method}, x = {n}",
                     lp.probe_while_loop(x, method),
                     lp.probe_while_loop_plain(x), "exact")
    # P2: the reference's row, seeded rows, ties (first lane), a NaN
    sem = lp.SEM_LOGITS
    tied = randn(1, sem)
    tied[0, [17, 4000, 9999]] = 50.0
    nan = randn(1, 256)
    nan[0, 30] = float("nan")
    for what, v in (("reference (1, 256)", ref["probe_scalar_dma_row"][0]),
                    ("seeded (1, 256)", randn(1, 256)),
                    (f"seeded (1, {sem})", randn(1, sem)),
                    (f"tied at 17/4000/9999 (1, {sem})", tied),
                    ("NaN at 30 (1, 256)", nan)):
        lp_check(errors, "probe_vector_to_smem_scalar", what,
                 lp.probe_vector_to_smem_scalar(v),
                 lp.probe_vector_to_smem_scalar_plain(v), "exact")
    # P2b: the reference's table at tokens 93, 0 and 255 and at a tie;
    # the semantic wte at the seeded and the tied row, groups 1 and 8
    v_ref, tbl = ref["probe_scalar_dma_row"]
    wte = randn(lp.SEM_WTE, lp.D, dtype=torch.bfloat16)
    cases = [("reference, tok 93", v_ref, tbl, 8)]
    for tok in (0, 255):
        v = torch.zeros((1, 256), device=dev)
        v[0, tok] = 5.0
        cases.append((f"tok {tok}", v, tbl, 8))
    v = torch.zeros((1, 256), device=dev)
    v[0, [3, 200]] = 5.0
    cases.append(("tie at 3/200", v, tbl, 8))
    cases.append(("NaN (no token: zeros)", nan, tbl, 8))
    for group in (1, 8):
        cases.append((f"wte bf16, seeded, group {group}",
                      randn(1, sem), wte, group))
        cases.append((f"wte bf16, tied, group {group}", tied, wte, group))
    for what, v, tb, group in cases:
        for method in lp.ROW_METHODS:
            lp_check(errors, "probe_scalar_dma_row", f"{what}, {method}",
                     lp.probe_scalar_dma_row(v, tb, group, method),
                     lp.probe_scalar_dma_row_plain(v, tb, group), "exact")
    del wte
    # P3: the reference's g, seeded, the semantic noise rows; a last strip
    # of 4 columns, one row, and rows past the strips' 4 stages of 64 (a
    # ring); `block` both ways within the sum tolerance, `strips`
    # bit-equal
    for what, g in (("reference (4, 128)",
                     ref["probe_dynamic_leading_dma"][0]),
                    ("seeded (4, 128)", randn(4, 128)),
                    (f"seeded (60, {sem})", randn(60, sem)),
                    (f"seeded (60, {sem + 4}): a strip of 4 columns",
                     randn(60, sem + 4)),
                    (f"seeded (1, {sem + 4})", randn(1, sem + 4)),
                    (f"seeded (600, {sem + 4}): a ring of stages",
                     randn(600, sem + 4))):
        for pf in (False, True):
            lp_check(errors, "probe_dynamic_leading_dma",
                     f"{what}, block, prefetch {pf}",
                     lp.probe_dynamic_leading_dma(g, pf, "block"),
                     lp.probe_dynamic_leading_dma_plain(g), "sum")
        lp_check(errors, "probe_dynamic_leading_dma", f"{what}, strips",
                 lp.probe_dynamic_leading_dma(g),
                 lp.probe_dynamic_leading_dma_plain(g), "exact")
    # P4, P5: the reference's 6 layers of 128, 12 of 768, 16 of 256
    p_cases = (("reference (6, 16, 128)",
                ref["probe_dynamic_vmem_read"][0]),
               ("seeded (12, 16, 768)", randn(12, 16, lp.D)),
               ("seeded (16, 16, 256)", randn(16, 16, 256)))
    x_cases = (("reference (8, 128), 6 layers",
                ref["probe_dynamic_vmem_write"][0], 6),
               ("seeded (8, 768), 12 layers", randn(8, lp.D), 12),
               ("seeded (8, 256), 16 layers", randn(8, 256), 16))
    for unroll in (False, True):
        for what, p in p_cases:
            lp_check(errors, "probe_dynamic_vmem_read",
                     f"{what}, unroll {unroll}",
                     lp.probe_dynamic_vmem_read(p, unroll),
                     lp.probe_dynamic_vmem_read_plain(p), "sum")
        for what, x, L in x_cases:
            lp_check(errors, "probe_dynamic_vmem_write",
                     f"{what}, unroll {unroll}",
                     lp.probe_dynamic_vmem_write(x, L, unroll),
                     lp.probe_dynamic_vmem_write_plain(x, L), "exact")
    # P6: the reference (1 block, ring 2), seeded f32 on 1-5 blocks,
    # bark-small's decode weights on every SM, rings 2-4, both modes
    w_small = randn(6, 7, 8, 128)
    cases = [("reference (6, 2, 8, 128), 1 block, ring 2",
              ref["probe_dyn_ring_stream"][0], 2, 1, True)]
    for blocks in (1, 3, 5):
        for ring in (1, 3):
            cases.append((f"seeded (6, 7, 8, 128), {blocks} blocks, "
                          f"ring {ring}", w_small, ring, blocks,
                          ring != 1))
    w = randn(lp.LAYERS, lp.LAYER_WEIGHTS // (16 * 1024), 16, 1024,
              dtype=torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for ring in (2, 3, 4):
        for pf in (False, True):
            cases.append((f"bark-small bf16, {sms} blocks, ring {ring}, "
                          f"{'prefetch' if pf else 'drain'}", w, ring,
                          sms, pf))
    for what, ww, ring, blocks, pf in cases:
        lp_check(errors, "probe_dyn_ring_stream", what,
                 lp.probe_dyn_ring_stream(ww, ring, blocks, pf),
                 lp.probe_dyn_ring_stream_plain(ww, blocks), "sum")
    del w
    # P7: the reference's x into 6 layers; a prefill's K/V slabs; one
    # layer; 263 rows a layer, which the ring's 132 blocks and 21-row
    # stages do not divide; one slab into 24 layers
    slab = randn(2 * lp.LAYERS, lp.PREFILL_ROWS, lp.D,
                 dtype=torch.bfloat16)
    odd = randn(2 * lp.LAYERS, lp.PREFILL_ROWS + 6, lp.D,
                dtype=torch.bfloat16)
    for method in lp.WRITE_METHODS:
        for what, x, L in (("reference (8, 128), 6 layers",
                            ref["probe_dynamic_hbm_write"][0], 6),
                           (f"slabs {tuple(slab.shape)} bf16", slab, 0),
                           (f"slabs {tuple(slab[:1].shape)} bf16",
                            slab[:1], 0),
                           (f"x {tuple(slab[0].shape)} bf16, 1 layer",
                            slab[0], 1),
                           (f"slabs {tuple(odd.shape)} bf16", odd, 0),
                           (f"x {tuple(slab[0].shape)} bf16, "
                            f"{2 * lp.LAYERS} layers", slab[0],
                            2 * lp.LAYERS)):
            lp_check(errors, "probe_dynamic_hbm_write",
                     f"{what}, {method}",
                     lp.probe_dynamic_hbm_write(x, L, method=method),
                     lp.probe_dynamic_hbm_write_plain(x, L), "exact")
    del slab, odd
    # P8: offsets on, off and outside the reference's (4, 32) grid, the
    # rest of a sentinel buffer untouched; per-lane K/V rows at n_past
    x8 = ref["probe_dynamic_hbm_write_rowoff"][0]
    for off_v in (19, 0, 7, 24, 31, 33, -1):
        off = torch.full((1, 1), off_v, dtype=torch.int32, device=dev)
        for method in lp.WRITE_METHODS:
            sentinel = randn(4, 32, 128)
            got = lp.probe_dynamic_hbm_write_rowoff(
                x8, off, sentinel.clone(), method=method)
            want = lp.probe_dynamic_hbm_write_rowoff_plain(
                x8, off, sentinel.clone())
            lp_check(errors, "probe_dynamic_hbm_write_rowoff",
                     f"reference x, off {off_v}, {method}, whole buffer",
                     got, want, "exact")
    got = lp.probe_dynamic_hbm_write_rowoff(*ref[
        "probe_dynamic_hbm_write_rowoff"])
    torch.cuda.synchronize()
    outside = torch.cat([got[:, :16], got[:, 24:]], dim=1)
    if not bool(outside.isnan().all()):
        raise AssertionError("P8 wrote outside its window")
    lp_check(errors, "probe_dynamic_hbm_write_rowoff",
             "reference, window [16, 24) of a NaN buffer",
             got[:, 16:24], x8[None].expand(4, 8, 128), "exact")
    for B in lp.KV_BATCHES:
        rows, off, cache = lp.kv_inputs(B, dev, seed=B)
        cache.copy_(randn(*cache.shape, dtype=torch.bfloat16))
        for align in (1, 8):
            for method in lp.WRITE_METHODS:
                got = lp.probe_dynamic_hbm_write_rowoff(
                    rows, off, cache.clone(), align=align, method=method)
                want = lp.probe_dynamic_hbm_write_rowoff_plain(
                    rows, off, cache.clone(), align=align)
                lp_check(errors, "probe_dynamic_hbm_write_rowoff",
                         f"K/V rows of {B} lanes, align {align}, "
                         f"{method}", got, want, "exact")
        del cache, got, want
    torch.cuda.empty_cache()
    # P9: the reference's f32 (simt), seeded f32, bf16 qkv at M 1-64
    # by both methods, and a block whose 32 rows cross a slot boundary
    dot = lp.probe_transposed_group_dot
    dot_plain = lp.probe_transposed_group_dot_plain
    for what, x, wt in (("reference (1, 128) x (3, 128, 128)",
                         *ref["probe_transposed_group_dot"]),
                        ("seeded (5, 128) x (3, 128, 128)",
                         randn(5, 128), randn(3, 128, 128))):
        lp_check(errors, "probe_transposed_group_dot", f"{what}, simt",
                 dot(x, wt), dot_plain(x, wt), "dot_f32")
    bf = torch.bfloat16
    cases = [(f"x ({M}, {lp.D}) x (3, {lp.D}, {lp.D}) bf16",
              randn(M, lp.D, dtype=bf), None) for M in lp.DOT_MS]
    cases.append(("x (5, 64) x (3, 48, 64) bf16: blocks across slots",
                  randn(5, 64, dtype=bf), randn(3, 48, 64, dtype=bf)))
    qkv = randn(3, lp.D, lp.D, dtype=bf)
    for what, x, wt in cases:
        wt = qkv if wt is None else wt
        mag = dot_plain(x.abs(), wt.abs())
        for method in lp.DOT_METHODS:
            lp_check(errors, "probe_transposed_group_dot",
                     f"{what}, {method}", dot(x, wt, method),
                     dot_plain(x, wt), f"{method}_bf16", mag)


def lowering_phase(smi: str):
    """Phase 5c: the lowering probe's CLI in this process (its ten probes at
    the reference's shapes, which must all pass), then its sweep at
    bark-small sizes with the launch counts set to 0 just before and read
    just after. Returns (the `lowering_probe` record, the launches)."""
    from bark_tpu_torch.probes import lowering

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = lowering.main([])
    if rc != 0:
        raise AssertionError(f"probes.lowering exited {rc}: not 10/10")
    for name in lowering.launches:
        lowering.launches[name] = 0
    with full_f32():
        record = lowering.sweep("cuda")
    launches = dict(lowering.launches)
    record.update(smi=smi, seconds=time.perf_counter() - t0)
    log(f"  lowering probe launches in the sweep: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"the sweep did not launch every probe: "
                             f"{launches}")
    return record, launches


def run_child(label: str, cmd, cwd=ROOT) -> str:
    """Run `cmd` from `cwd` (the checkout's root); its stdout (logged).
    Raises unless it exits 0 within SUBPROCESS_TIMEOUT_S."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                         timeout=SUBPROCESS_TIMEOUT_S)
    for line in res.stdout.splitlines():
        log(f"  [{label}] {line}")
    if res.returncode != 0:
        raise AssertionError(f"{label}: exit {res.returncode} after "
                             f"{time.perf_counter() - t0:.1f} s\n"
                             f"{res.stderr[-3000:]}")
    log(f"  {label}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return res.stdout


def json_line(stdout: str, key: str) -> dict:
    for line in stdout.splitlines():
        if line.startswith("{") and f'"{key}"' in line[:40]:
            return json.loads(line)[key]
    raise AssertionError(f"no {key} line in:\n{stdout[-2000:]}")


def warmup_child(warm: bool) -> int:
    """Phase 5b's fresh process: bark-small with random bf16 weights
    (`bark_small_stages`, seed 0), `warmup()` when `warm`, then two
    requests on one context (seed 1); prints one `warmup_child` JSON line
    with the seconds and a hash of every token."""
    import hashlib

    import numpy as np
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch.io import loader
    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.models.presets import ENCODEC_24KHZ

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    stages = bark_small_stages()
    codec = loader.params_from_numpy(
        loader.codec_init_params_numpy(ENCODEC_24KHZ, 3), torch.float32, dev)
    params = bt.BarkContextParams(compute_dtype="bfloat16",
                                  n_steps_text_encoder=138, min_eos_p=2.0,
                                  stage_sync=True)
    ctx = bt.BarkContext.from_parts(
        vocab_tokens=VOCAB, semantic=stages["semantic"],
        coarse=stages["coarse"], fine=stages["fine"],
        codec_cfg=ENCODEC_24KHZ, codec_params=codec, params=params, seed=1,
        device=dev)
    torch.cuda.synchronize()
    out = dict(warmup=warm, setup_s=time.perf_counter() - t0,
               warmup_s=ctx.warmup() if warm else None, requests=[])
    tokens = hashlib.sha256()
    for text in PROMPTS[:2]:
        if not ctx.generate_audio(text):
            raise AssertionError(f"request {text!r} produced no audio")
        audio = ctx.get_audio_data()
        if audio.shape != (ctx.fine_tokens.shape[0] * 320,) or \
                not np.isfinite(audio).all():
            raise AssertionError(f"request {text!r}: audio {audio.shape}")
        s = ctx.stats
        out["requests"].append(dict(
            eval_s=s.t_eval_us / 1e6, semantic_s=s.t_semantic_us / 1e6,
            coarse_s=s.t_coarse_us / 1e6, fine_s=s.t_fine_us / 1e6,
            codec_s=(s.t_eval_us - s.t_semantic_us - s.t_coarse_us
                     - s.t_fine_us) / 1e6))
        for a in (ctx.semantic_tokens, ctx.coarse_tokens, ctx.fine_tokens):
            tokens.update(np.ascontiguousarray(a, np.int32).tobytes())
    out["tokens_sha256"] = tokens.hexdigest()
    out["build"] = _build.last_build
    print(json.dumps({"warmup_child": out}), flush=True)
    return 0


def precompile_runs(dense_path: str, q8_path: str) -> list:
    """Phase 5b: the precompile CLI in subprocesses, three at once, on the
    small model's files (its params patched to the small token space):
    dense, packed on the q8_0 file, and --batch 8; each must exit 0 with
    both generate lines. Returns each run's lines."""
    driver = (
        "import functools, sys\n"
        "import bark_tpu_torch.params as params_mod\n"
        "import chip_smoke\n"
        "from bark_tpu_torch.cli import precompile\n"
        "params_mod.BarkContextParams = functools.partial(\n"
        "    params_mod.BarkContextParams, **chip_smoke.SMALL_PARAMS)\n"
        "sys.exit(precompile.main(sys.argv[1:]))\n")
    configs = (("dense", ["-m", dense_path]),
               ("q8_0 packed", ["-m", q8_path, "--packed"]),
               ("dense --batch 8", ["-m", dense_path, "--batch", "8"]))
    # the three processes at once: each checks lines, none is timed here
    with concurrent.futures.ThreadPoolExecutor(len(configs)) as pool:
        outs = list(pool.map(lambda c: run_child(
            f"precompile {c[0]}", [sys.executable, "-c", driver, *c[1]]),
            configs))
    runs = []
    for (label, _), out in zip(configs, outs):
        for want in ("first generate (compiles)",
                     "second generate (all cached)"):
            if want not in out:
                raise AssertionError(f"precompile {label}: no {want!r} "
                                     f"line")
        runs.append(dict(config=label, lines=out.splitlines()))
    return runs


REBUILD_DRIVER = (
    "import json, sys\n"
    "from bark_tpu_torch.kernels import _build\n"
    "_build.build()\n"
    "print(json.dumps({'build': dict(_build.last_build,\n"
    "                                 pkg=str(_build.PKG_DIR))}))\n")


def one_source_rebuild() -> dict:
    """Phase 5b: a copy of the package, its build cache included, with a
    code edit to C1's source builds in a fresh process: it must compile
    that one object and link. Returns its build record."""
    import shutil
    import tempfile

    from bark_tpu_torch.probes import cache

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        pkg = os.path.join(tmp, "bark_tpu_torch")
        shutil.copytree(os.path.join(ROOT, "bark_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = os.path.join(pkg, "csrc", cache.SOURCE)
        with open(src) as f:
            text = f.read()
        with open(src, "w") as f:
            f.write(text.replace("x[i] * 2.0f", "x[i] * 3.0f"))
        build = json_line(run_child("one-source rebuild", [
            sys.executable, "-c", REBUILD_DRIVER], cwd=tmp), "build")
    if build["pkg"] != pkg:
        raise AssertionError(f"the rebuild imported {build['pkg']}, not the "
                             f"copy {pkg}")
    if list(build["compiled"]) != [cache.SOURCE] or build["link_s"] is None:
        raise AssertionError(f"a code edit to {cache.SOURCE} built {build}, "
                             f"want that object and a link")
    log(f"  one-source rebuild: key lookup {build['lookup_s'] * 1e3:.1f} "
        f"ms, {cache.SOURCE} {build['compiled'][cache.SOURCE]:.2f} s, link "
        f"{build['link_s']:.2f} s")
    return build


def cold_start(smi: str):
    """Phase 5b: C1-C3 against their plain versions; then, with the
    cache probe's launch counts set to 0, its CLI's programs in this
    process, C1 through C3's shifted library among them; a second process
    of the CLI, which must compile nothing; a code edit to C1's source,
    which must rebuild that object alone; bark-small in two fresh
    processes, with and without `warmup` (their tokens equal); and the
    precompile CLI on the small model. Returns (the `cache_probe` record,
    the rows' timings, the launches)."""
    import torch

    import bark_tpu_torch as bt
    from bark_tpu_torch.probes import cache

    t0 = time.perf_counter()
    timing, shifted = cache_kernel_checks()
    for entry in cache.launches:
        cache.launches[entry] = 0
    with contextlib.redirect_stdout(sys.stderr):
        in_process = cache.run(tag="smoke", shifted=shifted)
    launches = dict(cache.launches)
    log(f"  cache probe launches in this process: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"the cache probe did not launch C1 from "
                             f"every entry: {launches}")
    second = json_line(run_child("cache probe, second process", [
        sys.executable, "-m", "bark_tpu_torch.probes.cache", "--tag", "run2",
        "--expect-cached"]), "cache_probe")
    log(f"  second process: key lookup "
        f"{second['build']['lookup_s'] * 1e3:.1f} ms, lib() "
        f"{second['build']['load_s'] * 1e3:.1f} ms; "
        + "; ".join(f"{k} first {second[k]['first_us']:.1f} us, warm "
                    f"{second[k]['warm_us']:.1f} us"
                    for k in ("double", "scan_double", "matmul"))
        + f" (CUDA_MODULE_LOADING={second['CUDA_MODULE_LOADING']})")
    rebuild = one_source_rebuild()
    torch.cuda.empty_cache()
    warm = {}
    for flag in (True, False):
        label = f"bark-small {'with' if flag else 'without'} warmup"
        warm[label] = json_line(run_child(label, [
            sys.executable, "-c",
            f"import sys, chip_smoke; sys.exit(chip_smoke.warmup_child("
            f"{flag}))"]), "warmup_child")
        r = warm[label]["requests"]
        log(f"  {label}: warmup "
            f"{warm[label]['warmup_s'] or 0.0:.3f} s, request 1 eval "
            f"{r[0]['eval_s']:.3f} s, request 2 {r[1]['eval_s']:.3f} s on "
            f"{smi}")
    hashes = {v["tokens_sha256"] for v in warm.values()}
    if len(hashes) != 1:
        raise AssertionError(f"warmup changed the tokens: {warm}")
    dense_path = os.path.join(OUT_DIR, "small_f32.bin")
    q8_path = os.path.join(OUT_DIR, "small_q8_0.bin")
    write_small_model(dense_path)
    bt.bark_model_quantize(dense_path, q8_path, 7)  # MOSTLY_Q8_0
    precompile = precompile_runs(dense_path, q8_path)
    for path in (dense_path, q8_path):
        os.unlink(path)
    record = dict(card=smi, seconds=time.perf_counter() - t0,
                  in_process=in_process, second_process=second,
                  one_source_rebuild=rebuild, warmup=warm,
                  precompile=precompile)
    return record, timing, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    if not os.path.isdir(os.path.join(ROOT, "bark_tpu_torch")):
        log("chip_smoke: run from the root of a bark-tpu checkout")
        return 1
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    from bark_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    build_record = dict(_build.last_build)
    log(f"phase 1: built and loaded {build_record['library']} in "
        f"{build_s:.1f} s: compiled "
        + (", ".join(f"{n} {t:.1f} s" for n, t in
                     build_record["compiled"].items()) or "nothing")
        + f"; link {build_record['link_s']} s; load "
        f"{build_record['load_s']:.3f} s")
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(_build.report_path().read_text())
    if sys.argv[1:] == ["--k1"]:
        k1_only(smi)
        return 0
    if sys.argv[1:] == ["--k7"]:
        with full_f32():
            rec = k7_step_record()
        print(json.dumps({"k7_step": dict(card=smi, **rec)}))
        return 0
    if sys.argv[1:] == ["--streaming"]:
        rec = streaming_phase(smi)
        print(json.dumps({"streaming": rec}))
        return 0
    if sys.argv[1:] == ["--multigpu"]:
        rec = multigpu_phase(smi)
        print(json.dumps({"multigpu": rec}))
        return 0
    if sys.argv[1:] == ["--fine-batch"]:
        rec = fine_batch_phase(smi, alone=True)
        log(f"  phase 4i took {rec['seconds']:.1f} s")
        print(json.dumps({"fine_batch": rec}))
        return 0
    if sys.argv[1:] == ["--large"]:
        rec = large_phase(smi)
        log(f"  phase 4j took {rec['seconds']:.1f} s")
        print(json.dumps({"large": rec}))
        return 0

    checks = Checks()
    with full_f32():
        log("phases 2-3 with TF32 off for matmuls and cuDNN (every f32 "
            "check is full f32)")
        for dtype in (torch.float32, torch.bfloat16):
            log(f"phase 2: kernels vs plain, {dtype}")
            kernel_checks(checks, dtype, timed=dtype == torch.bfloat16)
            log(f"phase 2: K5 (packed decode step) vs plain, {dtype}")
            qkernel_checks(checks, dtype, timed=dtype == torch.bfloat16)
            log(f"phase 2: K7-K10 (batched kernels) vs plain, {dtype}")
            batched_kernel_checks(checks, dtype,
                                  timed=dtype == torch.bfloat16)
            log(f"phase 2: K6 (the int8 KV cache) vs plain, {dtype}")
            kv8_kernel_checks(checks, dtype, timed=dtype == torch.bfloat16)
            log(f"phase 2: K5-batched (the packed batched step) vs plain, "
                f"{dtype}")
            qbatched_kernel_checks(checks, dtype,
                                   timed=dtype == torch.bfloat16)
        log("phase 2c: the batched decode step's record (bf16, bark-small): "
            "K7, K5-batched q4_0 and K6 in K7 at B 1/8/32 and n_past "
            "0/300/1023, one device kernel a step, stamped phases, "
            "torch.matmul at M = B, the kernel's SASS")
        k7_record = k7_step_record()
        log("phase 2b: the prefill profile (bf16, bark-small): K2 at T 257, "
            "437, 617 and 887 and K8 split by device kernel, one request's "
            "8 prefills, the torch.matmul yardstick, the bf16 GEMM's SASS; "
            "the same prefills on int8 caches (K6b, K6c)")
        prefill_record = prefill_phase(smi)
        log("phase 2d: the chunk and window record (bf16, bark-small): K3 "
            "and K4, dense and q4_0, one device kernel a call, beside K1's "
            "and K5's step, stamped")
        k3k4_record = k3k4_phase()
        log("phase 2e: the batched chunk and window record (bf16, "
            "bark-small): K9 (16 steps after 257 rows) and K10 (60 steps at "
            "887, LM window), dense and q4_0, at 8 and 32 lanes, one launch "
            "of the batched step loop a call, beside K7's step")
        k9k10_record = k9k10_phase()
        log("phase 2: bf16 witness, q4_0 packed steps in bf16 vs f32")
        bf16_witness()
        log("phase 2: D1-D5 (the weight-stream probe) vs plain, every "
            "load method")
        dma_errors = {}
        dma_kernel_checks(dma_errors)
        log("phase 2: P1-P9 (the lowering probe) vs plain, at the "
            "reference's shapes, seeded inputs and bark-small sizes")
        lowering_errors = {}
        lowering_kernel_checks(lowering_errors)
        log("phase 3: small model, GPU kernels vs CPU plain")
        small_model_reference()
        log("phase 3: small model, batched, GPU kernels vs CPU plain")
        small_model_batched_reference()
        log("phase 3: small model with the int8 KV cache, single and "
            "batched, GPU kernels vs CPU plain")
        small_model_reference(kv8=True)
        small_model_batched_reference(kv8=True)
        import bark_tpu_torch as bt

        dense_path = os.path.join(OUT_DIR, "small_f32.bin")
        q8_path = os.path.join(OUT_DIR, "small_q8_0.bin")
        write_small_model(dense_path)
        bt.bark_model_quantize(dense_path, q8_path, 7)  # MOSTLY_Q8_0
        log("phase 3: small model from a q8_0 file, packed, GPU vs CPU")
        small_model_reference(q8_path)
        log("phase 3: small model from the q8_0 file, packed and batched "
            "(K5-batched), bf16-dtype and int8 caches, GPU vs CPU")
        small_model_batched_reference(packed_path=q8_path)
        small_model_batched_reference(kv8=True, packed_path=q8_path)
        log("phase 3: small model with the options, GPU kernels vs CPU "
            "plain: top-k/top-p (dense, q8_0 packed, int8 KV, a batch), the "
            "stepped path, voices single and batched; the encoder")
        small_model_options_reference(q8_path)
        for path in (dense_path, q8_path):
            os.unlink(path)
    log(f"phase 4: bark-small, 3 requests (PyTorch defaults: cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}, matmul TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32})")
    need = ("prefill", "semantic", "window")
    results, counts = bark_small_requests(bark_small_stages(), 3, "dense",
                                          need)
    log("phase 4b: bark-small on packed-quantized weights")
    t0 = time.perf_counter()
    stages = bark_small_stages("q4_0")
    torch.cuda.synchronize()
    log(f"  q4_0 qpacks of the three stages built on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    q_results, q_counts = bark_small_requests(stages, 2, "q4_0", need,
                                              packed=True)
    k5_launches = {"q4_0": q_counts["qdecode"]}
    del stages
    for fmt in ("q8_0", "q4_1", "q4_k", "q5_0"):
        _, c = bark_small_requests(bark_small_stages(fmt), 1, fmt,
                                   need, packed=True)
        k5_launches[fmt] = c["qdecode"]
    torch.cuda.empty_cache()
    log(f"phase 4c: bark-small batched requests, B in {BATCHES}")
    stages = bark_small_stages()
    bark_small_batch(stages, 2)  # first use of the batched path: not kept
    batches = [bark_small_batch(stages, B) for B in BATCHES]
    log("phase 4d: bark-small with the int8 KV cache (kv_cache_dtype="
        "'int8'): 2 dense requests, 1 on q4_0 qpacks, batches of "
        f"{KV8_BATCHES}")
    kv8_results, kv8_counts = bark_small_requests(
        stages, 2, "kv8 dense", need + ("kv8",), kv8=True)
    kv8_batches = [bark_small_batch(stages, B, kv8=True)
                   for B in KV8_BATCHES]
    del stages
    torch.cuda.empty_cache()
    kv8_q_results, kv8_q_counts = bark_small_requests(
        bark_small_stages("q4_0"), 1, "kv8 q4_0", need + ("kv8",),
        kv8=True, packed=True)
    torch.cuda.empty_cache()
    log(f"phase 4e: bark-small batched on q4_0 qpacks, B in {BATCHES} "
        f"(bf16 cache) and {KV8_BATCHES} (int8 cache); one batch of 8 in "
        f"q8_0, q4_1, q4_k and q5_0")
    stages = bark_small_stages("q4_0")
    bark_small_batch(stages, 2, packed=True)  # first use: not kept
    q_batches = [bark_small_batch(stages, B, packed=True) for B in BATCHES]
    kv8_q_batches = [bark_small_batch(stages, B, kv8=True, packed=True)
                     for B in KV8_BATCHES]
    del stages
    k5b_launches = {("q4_0", r["B"]): r["launches"]["qbdecode"]
                    for r in q_batches}
    for fmt in ("q8_0", "q4_1", "q4_k", "q5_0"):
        r = bark_small_batch(bark_small_stages(fmt), 8, packed=True)
        k5b_launches[(fmt, 8)] = r["launches"]["qbdecode"]
        torch.cuda.empty_cache()
    log("phase 4f: the options on bark-small: top_k 50 / top_p 0.95 "
        "requests (dense, int8 KV, q4_0) and a batch of 8, the stepped path "
        "with a progress callback, voices single and batched, a preset from "
        "audio, a profile_dir request in a fresh process")
    options = options_phase(smi)
    log(f"  phase 4f took {options['seconds']:.1f} s")
    log("phase 4g: streaming, long-form and the HTTP server on bark-small "
        f"(a stream beside the fused request, two sentences long and "
        f"streamed, {SERVER_BATCH} concurrent requests and a stream through "
        f"--batch {SERVER_BATCH}); the small model's stream GPU vs CPU; "
        f"the main CLI")
    streaming = streaming_phase(smi)
    log(f"  phase 4g took {streaming['seconds']:.1f} s")
    log(f"phase 4h: multi-GPU serving on the one card: a world of 1 on "
        f"NCCL (bark-small, batches of {MG_B}: dp dense and q4_0, tp 1), "
        f"a world of 2 on cuda:0 over gloo (the small model dp 2 / tp 2, "
        f"bark-small dp 2), the dry run")
    multigpu = multigpu_phase(smi, next(r for r in batches
                                        if r["B"] == MG_B))
    log(f"  phase 4h took {multigpu['seconds']:.1f} s")
    log(f"phase 4i: the batched fine stage and codec on bark-small: dense "
        f"batches of {FB_BATCHES} and q4_0 of 8 (fine forwards and codec "
        f"calls counted, lanes against lanes alone), the fine stage's "
        f"profile at B 1 and 32 in a fresh process")
    fine_batch = fine_batch_phase(smi)
    log(f"  phase 4i took {fine_batch['seconds']:.1f} s")
    log("phase 4j: bark-large (24 layers, 16 heads, width 1024): its "
        "kernels vs plain in f32 and bf16, the step loops held to their "
        "steps, 3 dense requests, 1 on the int8 cache, 1 on q8_0, a batch "
        "of 8")
    large = large_phase(smi)
    log(f"  phase 4j took {large['seconds']:.1f} s")
    log(f"phase 5: the weight-stream probe D1-D5 at {DMA_MB} MB a pass, "
        f"every load method, stage size and ring, and its yardsticks")
    from bark_tpu_torch.probes import dma

    for form in dma.launches:
        dma.launches[form] = 0
    t0 = time.perf_counter()
    with full_f32():
        dma_record, dma_timing = dma_sweep(dma_errors)
    dma_launches = dict(dma.launches)
    dma_record["seconds"] = time.perf_counter() - t0
    log(f"  phase 5 took {dma_record['seconds']:.1f} s")
    if not all(dma_launches.values()):
        raise AssertionError(f"phase 5 did not launch every probe form: "
                             f"{dma_launches}")
    log("phase 5b: cold start: C1-C3 vs plain, the cache probe in this "
        "process and in a second one, bark-small with and without warmup "
        "in fresh processes, the precompile CLI")
    cache_record, cache_timing, cache_launches = cold_start(smi)
    log(f"  phase 5b took {cache_record['seconds']:.1f} s")
    log("phase 5c: the lowering probe P1-P9: its CLI in this process "
        "(10/10), then its sweep at bark-small sizes")
    lowering_record, lowering_launches = lowering_phase(smi)
    log(f"  phase 5c took {lowering_record['seconds']:.1f} s")
    foreign = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "bark_tpu"))
    if foreign:
        raise AssertionError(f"the port's run imported {foreign}")

    timed = results[1:]  # request 1 also pays first-use costs
    log(f"RTF (dense bf16, requests 2-3, batch 1): {rtf(timed):.4f} on {smi}")
    log_requests("dense", results)
    log(f"RTF (q4_0 qpack, bf16 dense leaves, requests 1-2, batch 1): "
        f"{rtf(q_results):.4f} on {smi}")
    log_requests("q4_0", q_results)
    for r in batches + kv8_batches + q_batches + kv8_q_batches:
        tag = (("kv8 " if r in kv8_batches + kv8_q_batches else "")
               + ("q4_0 " if r in q_batches + kv8_q_batches else ""))
        log(f"  {tag}batch of {r['B']:2d}: "
            f"eval {r['eval_s']:.3f} s = semantic "
            f"{r['semantic_s']:.3f} + coarse {r['coarse_s']:.3f} + fine "
            f"{r['fine_s']:.3f} + codec/rest {r['codec_s']:.3f} s; RTF per "
            f"request {r['rtf_per_request']:.4f}, "
            f"{r['audio_s_per_wall_s']:.3f} audio-s per wall-s on {smi}")
    log(f"RTF with the int8 KV cache (phase 4d) beside the bf16 cache "
        f"(phases 4, 4b): dense {rtf(kv8_results):.4f} (bf16 cache "
        f"{rtf(timed):.4f}), q4_0 {rtf(kv8_q_results):.4f} (bf16 cache "
        f"{rtf(q_results):.4f}) on {smi}")
    log_requests("kv8 dense", kv8_results)
    log_requests("kv8 q4_0", kv8_q_results)
    dense_batch = {r["B"]: r for r in batches}
    for r in kv8_batches:
        log(f"  batch of {r['B']}: {r['audio_s_per_wall_s']:.3f} audio-s per "
            f"wall-s with the int8 KV cache, "
            f"{dense_batch[r['B']]['audio_s_per_wall_s']:.3f} with bf16")
    for r in q_batches + kv8_q_batches:
        kv = "int8" if r in kv8_q_batches else "bf16"
        base = (dense_batch if kv == "bf16" else
                {d["B"]: d for d in kv8_batches})[r["B"]]
        log(f"  q4_0 batch of {r['B']} ({kv} cache): "
            f"{r['audio_s_per_wall_s']:.3f} audio-s per wall-s, RTF per "
            f"request {r['rtf_per_request']:.4f}; dense bf16 weights "
            f"{base['audio_s_per_wall_s']:.3f}, "
            f"{base['rtf_per_request']:.4f} on {smi}")
    batch_launches = {r["B"]: r["launches"] for r in batches}
    kv8_batch_launches = {r["B"]: r["launches"] for r in kv8_batches}
    # the single steps launch on the filtered paths of phase 4f alone
    counts = dict(counts, decode=options["filtered_dense"]["launches"][
        "decode"])
    k5_launches["q4_0"] = options["filtered_q4_0"]["launches"]["qdecode"]
    batch_launches[8] = dict(batch_launches[8], bdecode=options[
        "filtered_batch"]["launches"]["bdecode"])
    kv8_launches = {  # each K6 row's host launches in phases 4d and 4f
        K6_K1: options["filtered_kv8"]["launches"]["decode"],
        K6_K5: kv8_q_counts["qdecode"],
        K6_K2: kv8_counts["prefill"] + kv8_q_counts["prefill"],
        K6_K8: sum(c["bprefill"] for c in kv8_batch_launches.values()),
        **{f"{K6_K7}[B={b}]": c["bdecode"]
           for b, c in kv8_batch_launches.items()},
    }
    table = []
    for name, (src, replaces, module) in KERNELS.items():
        ms, plain, cost = checks.times[name]
        bound_ms, bound_by = bound(cost, "bfloat16")
        key = name.split("[B=")[0]
        if name in kv8_launches:
            launches = kv8_launches[name]
        elif name.startswith(K5B):
            fmt, b = name[len(K5B) + 1:-1].split(",B=")
            launches = k5b_launches[(fmt, int(b))]
            key = f"{K5B}[{fmt}]"
        elif name.startswith(K5):
            launches = k5_launches[name[len(K5) + 1:-1]]
        elif name.startswith(K7):
            launches = batch_launches[int(name[len(K7) + 3:-1])][module]
        elif module.startswith("b"):
            launches = sum(c[module] for c in batch_launches.values())
        else:
            launches = counts[module]
        if name not in kv8_launches:  # phases 4g-4i's of K2-K4, K8-K10
            launches += streaming["launches"].get(module, 0)
            launches += multigpu["launches"].get(module, 0)
            launches += fine_batch["launches"].get(module, 0)
        log(f"  {name:30s} {ms:9.3f} ms  plain {plain:9.3f} ms  bound "
            f"{bound_ms:7.4f} ms ({bound_by})  launches {launches}  (bf16)")
        row = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, state="ported",
            max_abs_err=checks.errors[(key, "bfloat16")],
            max_abs_err_f32=checks.errors[(key, "float32")],
            ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, bytes=cost[0], flops=cost[1],
        )
        if name in ("prefill_fused", "prefill_fused_batched"):
            key = "887" if name == "prefill_fused" else "8 x 887"
            split = (prefill_record["k2"] if name == "prefill_fused"
                     else prefill_record["k8"])[key]
            row.update(
                library_ms=prefill_record["matmul_device_ms"][key],
                library_call="torch.matmul on the GEMM phase's 48 bf16 "
                             "products (4 a layer x 12) at the same M: "
                             "their device time (torch.profiler)",
                library_event_ms=prefill_record["matmul_ms"][key],
                gemm_ms=split["kinds"]["gemm"] / 1e3,
                split_us=split["kinds"], device_kernels=split["events"])
            if name == "prefill_fused":
                row["ms_by_T"] = {T: r["ms"]
                                  for T, r in prefill_record["k2"].items()}
                row["request_prefills_ms"] = prefill_record["request"]["ms"]
        if name.startswith(f"{K7}[B="):
            row.update(k7_row(k7_record, "k7", int(name[len(K7) + 3:-1])))
        elif name.startswith(f"{K6_K7}[B="):
            row.update(k7_row(k7_record, "k6_k7",
                              int(name[len(K6_K7) + 3:-1])))
        elif name == f"{K5B}[q4_0,B=1]" or name in (f"{K5B}[q4_0,B=8]",
                                                    f"{K5B}[q4_0,B=32]"):
            row.update(k7_row(k7_record, "k5b",
                              int(name.split(",B=")[1][:-1])))
        if name in ("semantic_chunk_fused_batched",
                    "coarse_window_fused_batched"):
            part = "k9" if name == "semantic_chunk_fused_batched" else "k10"
            row.update(
                steps=16 if part == "k9" else 60, lanes=8,
                **{f"record_{w}": k9k10_record[w] for w in
                   ("dense", "q4_0")},
                device_kernels_per_call=k9k10_record["dense"]["B8"][part][
                    "device_kernels"],
                us_a_step_over_k7=k9k10_record["dense"]["B8"][part][
                    "us_a_step_over_step"])
        if name in ("semantic_chunk_fused", "coarse_window_fused"):
            part = "k3" if name == "semantic_chunk_fused" else "k4"
            row.update(
                steps=16 if part == "k3" else 60,
                **{f"record_{w}": k3k4_record[w][part] for w in
                   ("dense", "q4_0")},
                device_kernels_per_call=k3k4_record["dense"][part][
                    "device_kernels"],
                us_a_step_over_k1=k3k4_record["dense"][part][
                    "us_a_step_over_step"])
        if name in (K6_K2, K6_K8):
            row["k6c_alone"] = checks.k6c["887" if name == K6_K2
                                          else "8 x 887"]
            row["k6c_alone_bf16_limit"] = dict(
                rtol=K6C_RTOL, atol=K6C_ATOL,
                max_abs_err=checks.errors[(K6C, "bfloat16")],
                max_of_limit=checks.excess[(K6C, "bfloat16")])
            split = (prefill_record["kv8"]["k2"]["887"] if name == K6_K2
                     else prefill_record["kv8"]["k8"]["8 x 887"])
            row.update(profile_ms=split["ms"], split_us=split["kinds"],
                       device_kernels=split["events"])
        if name == "decode_step_fused":
            row.update(checks.k1_step)
        if name == f"{K5}[q4_0]":
            row.update(checks.k5_step)
        if (key, "float32") in checks.kv8_flips:
            row["int8_flips"] = {d: checks.kv8_flips[(key, d)]
                                 for d in ("float32", "bfloat16")}
        table.append(row)
    table += large["kernels"]
    for form, (name, replaces) in DMA_REPLACES.items():
        t = dma_timing[form]
        bound_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"  {name:30s} {t['ms']:9.3f} ms  plain {t['plain_ms']:9.3f} ms"
            f"  bound {bound_ms:7.4f} ms (bytes)  launches "
            f"{dma_launches[form]}  ({t['config']} {t['method']} ring "
            f"{t['ring']} {t['stage_kb']} KB, one 256 MB pass)")
        table.append(dict(
            name=name, route="cuda", source=DMA_SOURCE, replaces=replaces,
            launches=dma_launches[form], state="ported",
            max_abs_err=dma_errors[form], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=bound_ms, bound_by="bytes",
            library_ms=t["library_ms"], bytes=t["bytes"],
            config=dict(method=t["method"], ring=t["ring"],
                        stage_kb=t["stage_kb"], form=t["config"])))
    for (name, (replaces, src)), n in zip(CACHE_ROWS.items(), (
            cache_launches["double"], cache_launches["scan_double"],
            cache_launches["shifted"])):
        t = cache_timing[name]
        bound_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"  {name:30s} {t['ms']:9.5f} ms  plain {t['plain_ms']:9.5f} ms"
            f"  bound {bound_ms:.2e} ms (bytes)  launches {n}  (f32)")
        table.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=n, state="ported", max_abs_err=t["max_abs_err"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bound_ms,
            bound_by="bytes", library_ms=t["library_ms"], bytes=t["bytes"],
            **{k: t[k] for k in ("compile_s", "sass_lines", "key",
                                 "same_key_as") if k in t}))
    for name, (row_name, replaces) in LOWERING_ROWS.items():
        t = lowering_record["rows"][name]
        bound_ms, bound_by = bound((t["bytes"], t["flops"]),
                                   t["dtype"] if t["flops"] else "bfloat16")
        log(f"  {row_name:30s} {t['ms']:9.5f} ms  plain {t['plain_ms']:9.5f} "
            f"ms  bound {bound_ms:.2e} ms ({bound_by})  launches "
            f"{lowering_launches[name]}  ({t['config']}; library "
            f"{t['library_ms']}, methods {t.get('methods_ms')})")
        table.append(dict(
            name=row_name, route="cuda", source=LOWERING_SOURCE,
            replaces=replaces, launches=lowering_launches[name],
            state="ported", max_abs_err=lowering_errors[name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=t["library_ms"], bytes=t["bytes"], flops=t["flops"],
            config=t["config"],
            **{k: t[k] for k in ("methods_ms", "library_full_ms",
                                 "library_full_bytes") if k in t}))
    accuracy = {f"{k} {d}": e for (k, d), e in sorted(checks.errors.items())}
    print(json.dumps(dict(rtf=rtf(timed), requests=results,
                          rtf_q4_0=rtf(q_results), requests_q4_0=q_results,
                          batches=batches, rtf_kv8=rtf(kv8_results),
                          requests_kv8=kv8_results,
                          rtf_q4_0_kv8=rtf(kv8_q_results),
                          requests_q4_0_kv8=kv8_q_results,
                          batches_kv8=kv8_batches,
                          batches_q4_0=q_batches,
                          batches_q4_0_kv8=kv8_q_batches, options=options,
                          streaming=streaming, multigpu=multigpu,
                          fine_batch=fine_batch, large=large,
                          build_s=build_s,
                          build=build_record,
                          attention_alone={k: v[:2] for k, v in
                                           checks.times.items()
                                           if "alone" in k},
                          accuracy=accuracy,
                          kv8_flips={f"{k} {d}": v for (k, d), v in
                                     sorted(checks.kv8_flips.items())})))
    print(json.dumps({"k1_step": dict(
        card=smi, chain_ms_at_300_quoted_from_perf_md=K1_EARLIER_MS,
        **checks.k1_step, k5_q4_0=dict(
            chain_ms_at_300_quoted_from_perf_md=K5_EARLIER_MS,
            **checks.k5_step))}))
    print(json.dumps({"k7_step": dict(card=smi, **k7_record)}))
    print(json.dumps({"k3k4": dict(card=smi, **k3k4_record)}))
    print(json.dumps({"k9k10": dict(card=smi, **k9k10_record)}))
    print(json.dumps({"dma_probe": dict(card=smi, **dma_record)}))
    print(json.dumps({"cache_probe": cache_record}))
    print(json.dumps({"lowering_probe": lowering_record}))
    print(json.dumps({"prefill_profile": prefill_record}))
    print(json.dumps({"kernels": table, "to_port": []}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # every phase is fatal: report and fail
        import traceback

        traceback.print_exc()
        log(f"chip_smoke: FAILED: {exc}")
        sys.exit(1)
