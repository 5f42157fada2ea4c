// K7, the batched decode step, and K5-batched, the same step on
// packed-quantized weights: one token through every layer of a GPT stage
// for B = 1..32 lanes, as ONE persistent kernel a step; K6 (the int8 KV
// cache) inside both. Also K8's batched LM head. The step's device code
// is lane.cuh's, shared with K9 and K10 (bloop.cuh: the step in a loop, the
// sampler inside, ONE launch a chunk or window).
//
// Replaces bark_tpu/kernels/decode.py `decode_step_fused_batched` (:2043,
// its pallas_call at :2174, body `_decode_kernel_batched` :1766): per lane
// b, embed tok[b] at n_past[b] -> L x [LN1 -> QKV -> K/V row written at [l,
// b, n_past[b]] (`_stage_kv_rows` :1301) -> attention over that lane's
// rows <= n_past[b] -> proj + residual -> LN2 -> fc -> tanh-GELU -> out +
// residual] -> ln_f -> LM head over [lo, hi); with quant=True the weights
// are int8 values with per-32-row scales [and mins] (`_tile_stream` :512,
// `_qdot` :1016, `_embed_token` :2371), with kv_quant the int8 cache
// (:1937-1982). The caches are (L, B, S, D); the tokens and each lane's
// slot are read from device memory, never on the host.
//
// What bounds it on an H100: bytes, and barriers. A step streams every
// weight once for all lanes (bark-small: 170 MB in bf16, ~110 MB packed
// q4_0) plus each lane's live cache rows (at B = 32 and n_past 300: 542 MB
// in all, 0.162 ms at 3.35 TB/s) and does 2 FLOPs a weight a lane: 6.3
// GFLOP at B = 32, 6.4 us on the tensor cores at 989 TFLOP/s. Each
// dependent phase costs a grid barrier (~1.5 us, probes/lowering.py P1),
// 5 a layer and one after the embed: 61 for bark-small.
//
// What the design does about it (one cooperative launch of the card's
// co-resident block count, 512 threads, the layer loop inside; the host's
// `lane_plan` says which block takes which (64-column tile, K range) of
// each product and in which order each tile's partials are folded):
// - The products run with the lanes as the N side of the tensor cores'
//   mma.sync m16n8k16 (bf16 in, f32 sums): the weight tile's 64 columns
//   are four m16 tiles, its rows the K side, the lanes n8 tiles (B
//   rounded up to 8). wgmma would want 64 rows on its M side: the lanes
//   would waste half a tile or more of it at B <= 32, and m16n8k16 takes
//   the weights on M, the lanes on N, at any B. 16 warps: 4 m16 tiles x 4
//   k-groups, whose sums are added in a fixed order. The weights stream
//   as bulk copies into a 128 KB ring (K1's chunks, 16 KB in bf16) from a
//   copy laid out in the fragments' order (`lane_tiles`), so a thread's A
//   fragment of a 16 x 16 step is one 16-byte shared load: no ldmatrix,
//   no swizzle. A packed record's 16 x 32 values of a thread are one
//   16-byte load too: each value is rounded to T from q * s in f32 once
//   and feeds every lane; the min term (blocksums(x) @ m) stays on the
//   CUDA cores. f32 weights keep CUDA-core FMAs (the tensor cores would
//   round them to TF32): a thread a column and 4 lanes.
// - A block holds only its item's input rows, all lanes (<= 512 rows x 32
//   lanes, 33 KB in bf16), built from the step's f32 rows in device
//   memory (x, the attention's context, fc's GELU output), LayerNormed
//   per lane on the way; the LN's affine waits in shared memory (loaded
//   in the wait of the barrier before the product), each lane's
//   statistics come from the residual's tile statistics.
// - Each column is folded once: the last block to write a partial of a
//   tile (a ticket: thread 0's acquire-release add) copies the tile's
//   partials into shared memory by cp.async, adds them in the plan's
//   order, applies the epilogue (bias, GELU, residual) for every lane and
//   writes each row once; a residual fold also writes its 64 columns'
//   mean and squared deviations per lane, which an LN's consumer combines
//   (the mean of the means, the deviations with each tile's offset), so
//   no block reads a whole row to normalise it.
// - Attention runs as (head, lane) units, split over the blocks by each
//   lane's live rows (n_past[b] + 1 + a fixed cost), a split every block
//   computes alike from n_past at the start; a block runs its units at
//   once on groups of 512 / 256 / 128 threads (one, two, more units), each
//   K1's `attend_dense` or `attend_int8` (K6a) on a named barrier of its
//   own; a unit writes its head's cache row (int8 with the row scales
//   from the K and V tiles' amax). In the wait of the barrier before a
//   layer the TMA engine is asked to bring each lane's cache rows of that
//   layer into the L2 (one bulk prefetch a slab).
// - Barriers are split as K1's: a block arrives, refills its ring, then
//   waits. The barrier count and the tickets live in the step's scratch;
//   the last block out resets the count, each folder its ticket.
// - `stamps` (null when serving): every block's %globaltimer at the start,
//   after the embed's barrier, at each layer barrier's arrival and release,
//   and at the end, a row of 2 x 5 L + 3 a block.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (probes/
// bdecode_profile.py, this kernel and the 62-launch chain it replaces in
// one call; PERF.md): the bf16 step at n_past 300 takes 0.505-0.509 /
// 0.524-0.535 / 0.955-0.968 ms at B 1 / 8 / 32 (the chain 0.559-0.561 /
// 0.820 / 2.094-2.098), q4_0 0.484 / 0.491-0.498 / 0.909-0.914 (0.518-
// 0.529 / 0.716-0.717 / 1.921-1.922), on the int8 cache 0.501-0.506 /
// 0.513-0.525 / 0.830-0.834 (0.576 / 0.807-0.808 / 2.027-2.028). What
// bounds it now is not its bytes (it runs at 11-17% of their bound) but
// the latency of each phase's chain of dependent steps (inputs from the
// L2, the products, the partial, the ticket, the fold's loads, the
// barrier), ~1-2 us each under the weight stream (every block's stamps,
// `decode.step_critical_us`), and at 32 lanes the attention's dependent
// rounds of cache-row loads (~19 us a layer on the slowest block).
#include "lane.cuh"

namespace {

template <typename R>
__global__ void __launch_bounds__(PS_THREADS, 1)
    lane_step_kernel(const __grid_constant__ LaneArgs<typename R::Weights> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  LaneStep<R> s(a, smem);
  s.stamp(0);
  const int L = s.L, n_barriers = LAYER_BARRIERS * L + 1;
  if (s.pl(LP_BLOCKS) != (int)gridDim.x || s.pl(LP_BARRIERS) != n_barriers ||
      s.pl(LP_LAYERS) != L || s.pl(LP_LANES) != a.B ||
      s.pl(LP_PACKED) != (int)R::PACKED)
    __trap();  // a plan for another grid, stage, batch or read
  s.setup();
  s.top_up();
  s.assign_units();
  s.zero_window();
  s.embed();
  int k = 0;
  s.barrier(++k);
  s.stamp(1);
  for (int l = 0; l < L; ++l) {
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
  s.gemv_phase(LLM, L);
  s.stamp(2 * LAYER_BARRIERS * L + 2);
  s.leave(n_barriers);
}

// ------------------------------------------------------------ K8's LM head

constexpr int LM_WARPS = 8;
constexpr int LM_ROWS = 4;   // vocab rows per warp
constexpr int LM_LANES = 8;  // lanes LayerNormed per pass

// K8's LM head (bark_launch_lm_head_batched): logits[b, v] = dot(LN_f(x[row
// b]), head[v, :]) for v in [lo, hi). Each warp owns LM_ROWS vocab rows;
// per pass, warp j LayerNorms lane b0 + j into shared memory and every
// warp dots its rows with the pass's nb lanes (the head rows come back
// from L2 on later passes). Only the nb rows of hs a pass wrote are read:
// a pass of one lane does one lane's FMAs.
template <typename T>
__global__ void __launch_bounds__(LM_WARPS * 32)
    blm_head_kernel(const T* __restrict__ x, const int* __restrict__ rows,
                    int B, const T* __restrict__ g, const T* __restrict__ bb,
                    const T* __restrict__ head, int D, int V, int lo, int hi,
                    float* __restrict__ logits) {
  extern __shared__ float hs[];  // LM_LANES x D
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v0 = lo + (blockIdx.x * LM_WARPS + warp) * LM_ROWS;
  for (int b0 = 0; b0 < B; b0 += LM_LANES) {
    const int nb = min(LM_LANES, B - b0);
    __syncthreads();  // the previous pass has read hs
    if (warp < nb) {
      const int b = b0 + warp;
      const T* xr = x + (size_t)(rows != nullptr ? rows[b] : b) * D;
      float mean, inv;
      warp_ln_stats(xr, D, mean, inv);
      for (int i = lane; i < D; i += 32) {
        const float y = (to_f32(xr[i]) - mean) * inv;
        hs[warp * D + i] = round_t<T>(y * to_f32(g[i]) + to_f32(bb[i]));
      }
    }
    __syncthreads();
    for (int r = 0; r < LM_ROWS; ++r) {
      const int v = v0 + r;
      if (v >= hi) break;
      const T* row = head + (size_t)v * D;
      float s[LM_LANES];
#pragma unroll
      for (int j = 0; j < LM_LANES; ++j) s[j] = 0.0f;
      for (int i = 2 * lane; i < D; i += 64) {
        float a, c;
        load2(row + i, a, c);
#pragma unroll
        for (int j = 0; j < LM_LANES; ++j) {
          if (j < nb) {  // nb is the same for the whole block
            s[j] = fmaf(hs[j * D + i], a, s[j]);
            s[j] = fmaf(hs[j * D + i + 1], c, s[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < LM_LANES; ++j) {
        if (j >= nb) break;
        const float t = warp_sum(s[j]);
        if (lane == 0) logits[(size_t)(b0 + j) * V + v] = t;
      }
    }
  }
}

template <typename T>
int blm_head_t(const BarkGPTWeights* w, const void* x, const int* rows,
               int B, float* logits, int lo, int hi, cudaStream_t st) {
  const int D = w->n_embd;
  if (hi > lo) {
    blm_head_kernel<T><<<cdiv(hi - lo, LM_WARPS * LM_ROWS), LM_WARPS * 32,
                         LM_LANES * D * sizeof(float), st>>>(
        (const T*)x, rows, B, (const T*)w->ln_f_g, (const T*)w->ln_f_b,
        (const T*)w->lm_head, D, w->n_out_vocab, lo, hi, logits);
  }
  return (int)cudaGetLastError();
}


}  // namespace

// The grid of bark_decode_lanes (scale_dtype < 0) or
// bark_decode_lanes_packed (a qpack's scale dtype and has_min) for a stage
// of params dtype `dtype`, width D and S cache slots: the blocks of its
// kernel the card holds at once (sets the kernel's shared-memory limit).
// Negative: a cudaError negated, or -1 for a shape or format it does not
// take or a card without cooperative launches.
extern "C" int bark_decode_lanes_blocks(int dtype, int scale_dtype,
                                        int has_min, int D, int S) {
  auto blocks = [&](auto r) {
    return lane_blocks_t<decltype(r)>(
        (const void*)lane_step_kernel<decltype(r)>, D, S);
  };
  if (dtype == BARK_BF16)
    return scale_dtype < 0
               ? blocks(DenseRead<bf16>{})
               : with_packed_read<bf16>(scale_dtype, has_min, blocks);
  return scale_dtype < 0
             ? blocks(DenseRead<float>{})
             : with_packed_read<float>(scale_dtype, has_min, blocks);
}

// K7: one decode step of B (1..32) lanes as one cooperative launch of
// `blocks` blocks (bark_decode_lanes_blocks' grid, for which `plan`, the
// lane_plan table of B lanes, was made). tiles: the stage's qkv, proj,
// fc and out weights and its LM head's transpose, tile-major (L, N/64, K,
// 64) and (v_pad/64, D, 64), each 16-row group of a bf16 tile in the mma
// fragments' order (kernels/decode.py `lane_tiles`), 16-byte aligned. tok
// and n_past are B ints in device memory; k_cache and v_cache the stage's
// (L, B, S, D) caches, in the params dtype when k_scale and v_scale are
// null, else int8 with those (L, B, S) f32 row scales (K6a); row n_past[b]
// of lane b of every layer is written in place. work: work_floats >=
// B (9 D + 3 D / 64) + cap f32 of scratch (cap >= 64 B x the plan's most
// items in a phase); sync: 1 + the plan's most tiles in a phase uint32,
// zeroed (left zeroed); stamps null or blocks x (2 x 5 L + 3) uint64;
// logits (B, n_out_vocab) f32, zero outside the plan's [lo, hi). Returns
// the launch's cudaError (0 on success), -1 for arguments it does not
// take; nothing falls back.
extern "C" int bark_decode_lanes(const BarkGPTWeights* w,
                                 const void* const* tiles, const int* plan,
                                 int blocks, int B, const int* tok,
                                 const int* n_past, void* k_cache,
                                 void* v_cache, float* k_scale,
                                 float* v_scale, float* work,
                                 long long work_floats, int cap,
                                 unsigned* sync, unsigned long long* stamps,
                                 float* logits, cudaStream_t stream) {
  LaneArgs<BarkGPTWeights> a;
  if (!lane_args(w, tiles, plan, blocks, B, tok, n_past, k_cache, v_cache,
                 k_scale, v_scale, work, work_floats, cap, sync, stamps,
                 logits, a))
    return -1;
  if (w->dtype == BARK_BF16)
    return lane_launch_t<DenseRead<bf16>>(
        (const void*)lane_step_kernel<DenseRead<bf16>>, a, blocks, stream);
  return lane_launch_t<DenseRead<float>>(
      (const void*)lane_step_kernel<DenseRead<float>>, a, blocks, stream);
}

// K5-batched: bark_decode_lanes on a qpack's weights, its plan made for
// packed reads. tiles: the qpack's four projection weights and its LM head
// as quant-block records, (L, N/64, K/32, rec) and (v_pad/64, D/32, rec)
// bytes (kernels/decode.py `lane_tiles`: a bf16 stage's records hold each
// lane's 16 values of an m16 tile in the mma fragments' order, an f32
// stage's are K5's `step_qtiles`). The rest as bark_decode_lanes'; -1 also
// for a scale dtype other than f16 or f32.
extern "C" int bark_decode_lanes_packed(
    const BarkGPTQWeights* w, const void* const* tiles, const int* plan,
    int blocks, int B, const int* tok, const int* n_past, void* k_cache,
    void* v_cache, float* k_scale, float* v_scale, float* work,
    long long work_floats, int cap, unsigned* sync,
    unsigned long long* stamps, float* logits, cudaStream_t stream) {
  LaneArgs<BarkGPTQWeights> a;
  if (w->v_pad % TILE ||
      !lane_args(w, tiles, plan, blocks, B, tok, n_past, k_cache, v_cache,
                 k_scale, v_scale, work, work_floats, cap, sync, stamps,
                 logits, a))
    return -1;
  auto launch = [&](auto r) {
    return lane_launch_t<decltype(r)>(
        (const void*)lane_step_kernel<decltype(r)>, a, blocks, stream);
  };
  if (w->dtype == BARK_BF16)
    return with_packed_read<bf16>(w->scale_dtype, w->has_min, launch);
  return with_packed_read<float>(w->scale_dtype, w->has_min, launch);
}

extern "C" int bark_launch_lm_head_batched(const BarkGPTWeights* w,
                                           const void* x, const int* rows,
                                           int B, float* logits, int lo,
                                           int hi, cudaStream_t stream) {
  if (w->dtype == BARK_BF16)
    return blm_head_t<bf16>(w, x, rows, B, logits, lo, hi, stream);
  return blm_head_t<float>(w, x, rows, B, logits, lo, hi, stream);
}
