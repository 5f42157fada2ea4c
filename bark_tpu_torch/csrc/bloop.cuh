// K9 and K10, the batched semantic chunk and coarse window: n_steps steps
// of the batched step (K7, or K5-batched on a qpack's packed read, K6 on
// an int8 cache; lane.cuh) for B = 1..32 lanes as ONE cooperative launch,
// each step sampling every lane's token inside the launch from the logits
// before it (`LaneSampler`, lane.cuh) and decoding it at the lane's slot,
// row j of a slot table in device memory.
//
// Replaces bark_tpu/kernels/semantic.py `semantic_chunk_fused_batched`
// (:1239, its pallas_call at :1393, body `_semantic_kernel_batched` :786:
// K steps of B lanes at the shared slot min(ctx_len + g, block_size - 1),
// a full-vocab Gumbel-argmax over 10048 logits and each lane's stop flag
// tok == semantic_vocab_size or eos_p >= min_eos_p) and bark_tpu/kernels/
// window.py `coarse_window_fused_batched` (:1117, pallas_call :1291, body
// `_window_kernel_batched` :649: one window of sws steps, lane b at slot
// ctx_len[b] + j, step j sampling the codebook window [svs + (cbs if
// step_idx0 + j is odd), + cbs), the LM head over lm_window).
//
// What bounds it is what bounds K7, n_steps times over (bdecode.cu); what
// the loop saves is the sampler's launch a step and the launch gaps
// (before it, a step was two launches: a sampler kernel, then K7), and
// the ring's cold start: each block's chunk sequence is its step's,
// repeated, so the next step's first chunks stream in during the LM head
// and the sample.
//
// What the design does about it: the sample's partials are keyed by LM
// tile and written by the tile's folding warps (LaneSampler), a grid
// barrier, then each block folds, in tile order, only the lanes whose
// token it embeds, so the token depends on the logits alone. At 128
// registers a thread the step's code has no register to spare: values the
// compiler hoisted out of the step loop and held across it spilled from
// the layers' hot paths (208-224 bytes of spill stores a bf16 instance,
// K7's step 0), and K9 dense at B 8 took 9.570 ms for 16 steps against
// K7's step alone of 0.523 (+75 us a step). So each step makes its own
// view of the block, reads the thread's index opaquely at each use
// (`LaneStep::tid`), and carries the step, the chunks taken and the ring's
// producer over in shared memory: no spill, 8.774 ms against 0.539 (+9 us
// a step) (probes/k9k10_profile.py on an NVIDIA H100 80GB HBM3 at 700.00
// W; PERF.md).
#pragma once

#include "lane.cuh"

namespace {

// n_steps of the batched step in one cooperative launch, the sampler
// inside (LaneSampler). A launch takes 5 L + 2 barriers a step: the
// layers', the embed's and the sample's. Each step makes its own view of
// the block and takes what carries over (the step, the chunks taken, the
// ring's producer) from the loop's state in shared memory.
template <typename R>
__global__ void __launch_bounds__(PS_THREADS, 1)
    lane_steps_kernel(const __grid_constant__ LaneArgs<typename R::Weights> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BarkLaneLoop& lp = a.lp;
  {
    LaneStep<R, true> s(a, smem);
    s.loop_stamp(0);
    const int L = s.L, lo = s.pl(LP_LO), hi = s.pl(LP_HI);
    const bool window_ok = lp.codebook
                               ? lo <= lp.svs && lp.svs + 2 * lp.cbs <= hi
                               : lo == 0 && hi == s.V;
    if (s.pl(LP_BLOCKS) != (int)gridDim.x ||
        s.pl(LP_BARRIERS) != LAYER_BARRIERS * L + 1 ||
        s.pl(LP_LAYERS) != L || s.pl(LP_LANES) != a.B ||
        s.pl(LP_PACKED) != (int)R::PACKED || !window_ok)
      __trap();  // a plan for another grid, stage, batch, read or window
    s.setup();
    s.setup_loop();
    s.top_up();  // the ring starts under the first sample
    s.zero_window();
    s.open_partials();
    s.sample_barrier(0);
    s.fold(0);  // its closing barrier orders the reads of the state
  }
  while (true) {
    LaneStep<R, true> s(a, smem);
    s.taken = s.state[LW_TAKEN];
    s.loop_stamp(1 + 3 * s.state[LW_STEP]);
    s.prefetch_noise(s.state[LW_STEP] + 1);
    s.assign_units();
    s.embed();
    int k = 0;
    s.barrier(++k);
    for (int l = 0; l < s.L; ++l) {
      s.gemv_phase(LQ, l);
      s.barrier(++k);
      s.attention(l);
      s.barrier(++k);
      s.gemv_phase(LPROJ, l);
      s.barrier(++k);
      s.gemv_phase(LFC, l);
      s.barrier(++k);
      s.gemv_phase(LOUT, l);
      s.barrier(++k);
    }
    s.loop_stamp(2 + 3 * s.state[LW_STEP]);
    s.gemv_phase<true>(LLM, s.L);  // its folds write the next sample's
    const int j = s.state[LW_STEP];  // partials
    s.loop_stamp(3 + 3 * j);
    if (j + 1 == lp.n_steps) break;
    s.sample_barrier(j + 1);
    s.fold(j + 1);  // its closing barrier orders the update below
    if (s.tid() == 0) {
      s.state[LW_STEP] = j + 1;
      s.state[LW_TAKEN] = s.taken;
    }
    __syncthreads();
  }
  LaneStep<R, true> s(a, smem);
  s.loop_stamp(1 + 3 * lp.n_steps);
  s.leave(lp.n_steps * (LAYER_BARRIERS * s.L + 2));
}

// `a` given the step loop `lp` (its slots, tokens and stamps in place of
// the single step's), or false for a loop the kernel does not take
template <typename Weights>
bool lane_loop_args(const BarkLaneLoop* lp, int blocks, LaneArgs<Weights>& a) {
  const int V = a.w.n_out_vocab;
  if (lp == nullptr || lp->n_steps < 1 || lp->slots == nullptr ||
      lp->tok_out == nullptr || lp->part == nullptr ||
      (long long)lp->n_steps * (LAYER_BARRIERS * a.w.n_layer + 2) * blocks >=
          (1ll << 31) ||
      (lp->temp != 0.0f &&
       (lp->noise == nullptr || lp->noise_rows < 1 || lp->noise_row0 < 0)))
    return false;
  if (lp->codebook ? lp->cbs < 1 || lp->svs < 0 || lp->svs + 2 * lp->cbs > V
                   : lp->flag_out == nullptr)
    return false;
  a.lp = *lp;
  a.tok = nullptr;
  a.n_past = lp->slots;
  a.stamps = nullptr;
  return true;
}

// The loop's entries for params of type T, the extern "C" ones' bodies:
// bloop.cu instantiates them for bf16, bloop_f32.cu for f32, so that nvcc
// builds the loop's 10 instances in two processes at once (in one source
// it took 142-152 s, the library's longest object; PERF.md PR 15).
template <typename T>
int lane_steps_blocks_for(int scale_dtype, int has_min, int D, int S) {
  auto blocks = [&](auto r) {
    return lane_blocks_t<decltype(r)>(
        (const void*)lane_steps_kernel<decltype(r)>, D, S);
  };
  return scale_dtype < 0 ? blocks(DenseRead<T>{})
                         : with_packed_read<T>(scale_dtype, has_min, blocks);
}

template <typename T>
int lane_steps_for(const BarkGPTWeights* w, const void* const* tiles,
                   const int* plan, int blocks, int B, const BarkLaneLoop* lp,
                   void* k_cache, void* v_cache, float* k_scale,
                   float* v_scale, float* work, long long work_floats,
                   int cap, unsigned* sync, float* logits,
                   cudaStream_t stream) {
  LaneArgs<BarkGPTWeights> a;
  if (lp == nullptr ||
      !lane_args(w, tiles, plan, blocks, B, nullptr, lp->slots, k_cache,
                 v_cache, k_scale, v_scale, work, work_floats, cap, sync,
                 nullptr, logits, a) ||
      !lane_loop_args(lp, blocks, a))
    return -1;
  return lane_launch_t<DenseRead<T>>(
      (const void*)lane_steps_kernel<DenseRead<T>>, a, blocks, stream);
}

template <typename T>
int lane_steps_packed_for(const BarkGPTQWeights* w, const void* const* tiles,
                          const int* plan, int blocks, int B,
                          const BarkLaneLoop* lp, void* k_cache,
                          void* v_cache, float* k_scale, float* v_scale,
                          float* work, long long work_floats, int cap,
                          unsigned* sync, float* logits,
                          cudaStream_t stream) {
  LaneArgs<BarkGPTQWeights> a;
  if (lp == nullptr || w->v_pad % TILE ||
      !lane_args(w, tiles, plan, blocks, B, nullptr, lp->slots, k_cache,
                 v_cache, k_scale, v_scale, work, work_floats, cap, sync,
                 nullptr, logits, a) ||
      !lane_loop_args(lp, blocks, a))
    return -1;
  auto launch = [&](auto r) {
    return lane_launch_t<decltype(r)>(
        (const void*)lane_steps_kernel<decltype(r)>, a, blocks, stream);
  };
  return with_packed_read<T>(w->scale_dtype, w->has_min, launch);
}

}  // namespace
