// K1: one token through all layers of a GPT stage, for batch 1, as ONE
// persistent kernel a step; K5, the same step on packed-quantized weights,
// as a weight-read policy of the same kernel; K6, the int8 KV cache,
// inside both; and K3 and K4, a semantic chunk and a coarse window, as ONE
// launch of the same step in a loop with the sampler inside
// (`decode_steps_kernel`, below the step).
//
// Replaces bark_tpu/kernels/decode.py `decode_step_fused` (:2392, its one
// pallas_call at :2536; body `_decode_kernel` :1428, layer loop
// `_dense_layer_stack` :1339, attention `_attend_lane` :1109): embed ->
// L x [LN1 -> fused QKV -> K/V row written at n_past -> attention over rows
// <= n_past -> proj + residual -> LN2 -> fc -> tanh-GELU -> out + residual]
// -> ln_f -> LM head over [lo, hi); with quant=True (K5) the weights are
// int8 values with per-32-row scales [and mins], dequantized as they are
// read (`_tile_stream` :512), the product plus the exact min term
// blocksums(x) @ m (`_qdot` :1016), and the packed wte row (`_embed_token`
// :2371).
//
// What bounds it on an H100: bytes, and barriers. A step streams every
// weight once (bark-small: ~85 M values a stage, 170 MB in bf16, ~90 MB in
// int8 with f16 scales) plus the live cache rows, 197 MB at n_past 300
// (0.0587 ms at 3.35 TB/s; packed q4_0 110 MB, 0.0328 ms), with 2 FLOPs a
// weight, far below the card's ridge. Each dependent phase then costs a
// grid-wide barrier (1.53 us, probes/lowering.py P1), and a step has 4 a
// layer: 48 for bark-small, ~73 us, more than the stream itself.
//
// What the design does about it (one cooperative launch a step, the grid
// the card's co-resident block count, the layer loop inside):
// - The work is laid out by the host (kernels/decode.py `step_plan`, an
//   int32 table each block copies into shared memory): for each phase,
//   which block takes which (64-column tile, K range) of the weight (8-row
//   aligned ranges dense, whole 32-row quant blocks packed), balanced in
//   bytes, and the fixed order in which each column's split-K partials are
//   folded. The kernel takes the table as it is.
// - Four barriers a layer: after LN1+QKV; after attention+proj (each head's
//   blocks own ctx_h, each recomputing the head's attention, and write
//   proj's split-K partial over the head's 64 rows); after LN2+fc; after
//   out. No phase folds partials on its own: the blocks of the next phase
//   fold what they read, in the plan's order (attention its head's q/k/v
//   columns; fc all of x after proj, then LN2 in every block; out its K
//   rows of h, with bias and GELU; the next layer's QKV, and the LM head,
//   all of x after out). Every block keeps the residual x in shared
//   memory, so no row goes back to device memory but the cache rows, which
//   one block a head writes. Partials alternate between two buffers.
// - Weights do not depend on activations: every block walks its own chunk
//   sequence for the whole step (its items of each phase of each layer,
//   then its LM work) through a 128 KB ring of shared-memory slots, one
//   bulk copy a chunk issued by one thread and completing on the slot's
//   mbarrier, so the next phases' tiles are in flight across barriers and
//   across the attention. A chunk is contiguous because the wrapper keeps
//   a tile-major copy of the weights (`step_tiles`, `step_qtiles`). (Measured
//   against it on an H100 at 700 W, chip_smoke.py's K1 record, the step
//   at n_past 300: 16-byte cp.async issued by all 512 threads 0.506 ms
//   against 0.408 with bulk copies; 2-D TMA boxes of tensor maps over the
//   row-major weights, no copy, 0.515-0.520 against 0.359-0.361.)
// - The weight read is the kernel's template policy, and nothing else
//   differs between K1 and K5: `DenseRead` streams chunks of 128 rows of a
//   tile in T and the LM head's vocab rows; `PackedRead` streams chunks of
//   up to 8 quant-block records of a tile (a record: 32 x 64 int8 values,
//   their 64 scales, their 64 mins when the format has them; ~16 KB a
//   chunk) and the LM head as whole-K 64-column tiles of its transposed
//   (D, v_pad) copy, which write their logits with no fold. A packed
//   weight is rounded to T from q * s in f32 and FMA'd in f32, as the
//   plain version (models/gpt.py `qdot`) and the 62-launch chain it
//   replaces computed it; the min term adds each half-block's sum of x
//   times the block's min. q becomes a float by integer shifts and one
//   FADD, and a pair rounds to bf16 in one packed conversion, not through
//   the conversion unit a value at a time: chip_smoke.py --k1 on an H100
//   at 700 W, the q4_0 step at n_past 300 0.3570-0.3579 ms against
//   0.3802-0.3807 with (float)q and round_t (PERF.md).
// - The barrier is split: a block arrives, then refills its ring and hints
//   the next phase's biases, LN affines and (after QKV) its heads' cache
//   rows into the L2 (prefetch.global.L2) while it waits.
// - Everything the kernel writes and reads back (partials) is read with
//   coherent L2 loads (__ldcg), each fold's loads in flight together; the
//   caches, the token and the int8 scales with plain loads, never
//   ld.global.nc.
// - The barrier count lives in the step's scratch; the last block out
//   resets it, so steps queue with no host work between them.
// - `stamps` (null when serving) takes every block's %globaltimer at the
//   start, after the embed, at each barrier's arrival and release, and at
//   the end, a row of 2 x barriers + 3 a block.
//
// K3 and K4 (replacing bark_tpu/kernels/semantic.py `semantic_chunk_fused`
// :555, its pallas_call at :740, and bark_tpu/kernels/window.py
// `coarse_window_fused` :419, pallas_call at :602): n_steps steps of the
// step above in one cooperative launch. Step j first samples its token
// from the current logits (the input logits for j = 0), then decodes it at
// n_past = min(n_past0 + j, clamp). What bounds them is what bounds K1,
// n_steps times over; what the loop saves is the per-step sample launch
// and launch gap, and the ring's cold start: each block's chunk sequence is
// its step's, repeated, so the next step's first chunks are in flight
// during the LM head and the sample. The sampler is a phase of the LM head:
// each block reduces the logits it computed that lie in the step's window
// (its LM rows, or its packed tiles' columns) to a partial (best of
// logits/temp + noise, its index; for K3 the max and sum of exp of the
// EOS scale), one grid barrier follows, and every block folds all the
// partials in the same fixed order, so every block holds the same token
// with no second barrier and embeds it. Registers: the loop kernel holds
// the layers' code of K1 plus a step's state, and at 128 registers a
// thread any state kept live across the layers spilled from their hot
// loops (its dense bf16 layers ran 7-10% slower than K1's). So the slot,
// the chunks a step and the ring's producer live in shared memory at a
// fixed offset (the producer walked by thread 0 alone), the stamps too:
// probes/k3k4_profile.py on an H100 at 700 W, a dense bf16 chunk of 16
// steps 6.37 ms with that state in registers, 5.77 with it in shared
// memory (K1's step 0.360).
//
// The attention arithmetic (`attend_dense`, `attend_int8`) and the weight
// reads live in step.cuh, shared with the batched step (bdecode.cu
// `lane_step_kernel`, K7 and K5-batched: the same ring, barriers and
// reads for 1-32 lanes, its products on the tensor cores) and with the
// standalone attention kernels below, which K6a alone launches a layer at
// a time (bark_launch_attn_decode_batched, kernels/kv8.py).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "step.cuh"

// The step loop's arguments (kernels/_build.py `StepLoop` mirrors it):
// n_steps steps, step j decoding at min(n_past0 + j, clamp); temp (0:
// argmax of the logits) and the noise rows (row min(noise_row0 + j,
// noise_rows - 1) for step j, noise_ld floats apart, each over the
// window's width; null at temp 0); codebook 0: the window [0,
// n_out_vocab) with the stop flag (tok == stop_token or eos_p >=
// min_eos_p), 1: the window [svs + (cbs when step_idx0 + j is odd), + cbs)
// of the coarse stage, no flag; tok_out (n_steps) int32, flag_out
// (n_steps) int32 or null when codebook; part, 4 f32 a block; stamps,
// blocks x (2 + 3 n_steps) uint64 (n_steps <= 64), or null.
struct BarkStepLoop {
  int n_steps, n_past0, clamp;
  float temp;
  const float* noise;
  int noise_ld, noise_row0, noise_rows;
  int codebook, svs, cbs, step_idx0, stop_token;
  float min_eos_p;
  int* tok_out;
  int* flag_out;
  float* part;
  unsigned long long* stamps;
};

namespace {

constexpr int ATT_THREADS = 1024;  // the standalone attention kernels
constexpr int LM_WARPS = 8;        // K2's LM head: one vocab row per warp
constexpr int PLAN_MAX = 8192;  // ints of the plan a block holds
constexpr int FOLD_BATCH = 24;  // partials of a column loaded at once
constexpr int VPT = 2;          // columns of x a thread holds: D <= 1024
constexpr int FOLD2_BATCH = 16;  // partials of each of those loaded at once

// the plan table's header (kernels/decode.py `StepPlan.table`, whose
// `PL_*` names these slots too: keep the two alike): offsets of each
// phase's items (4 ints each: tile, k0, k1, flags), block
// starts (n_blocks + 1), fold offsets (tiles + 1) and fold lists (item
// indices, each tile's in K order), then the LM section (2 ints a block:
// its vocab rows [v0, v1), or with PL_LM_TILES set, its 64-column tiles
// [t0, t1) of the packed LM head, each over all D rows)
enum {
  PL_BLOCKS = 0, PL_BARRIERS = 1, PL_ITEMS = 2, PL_STARTS = 6,
  PL_FOLD_OFF = 10, PL_FOLD = 14, PL_LM = 18, PL_LO = 19, PL_HI = 20,
  PL_LAYERS = 21, PL_LM_TILES = 22
};
enum { PH_QKV = 0, PH_PROJ = 1, PH_FC = 2, PH_OUT = 3, PH_N = 4 };
enum { ITEM_WRITES_KV = 1, ITEM_WRITES_SCALES = 2 };  // proj items' flags

// One block per (head, lane): lane b = blockIdx.y writes the fresh k/v row
// of this head into its (S, D) cache slab at slot n_past[b], then
// attend_dense (one layer's attention on its own, the dense yardstick of
// K6a alone; a slot outside the cache writes a NaN context and no cache
// row).
template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
    attn_decode_kernel(const T* __restrict__ qkv, T* kc, T* vc,
                       const int* __restrict__ n_past_dev, int S, int D,
                       float scale, T* __restrict__ ctx) {
  constexpr int KG = ATT_THREADS / (HD / 8);
  extern __shared__ float sc[];  // n_past + 1 scores
  __shared__ float q[HD], kn[HD], vn[HD];
  __shared__ float red[32];
  __shared__ float part[KG][HD + 1];
  const int off = blockIdx.x * HD;
  const int b = blockIdx.y;
  const int n_past = n_past_dev[b];
  qkv += (size_t)b * 3 * D;
  kc += (size_t)b * S * D;
  vc += (size_t)b * S * D;
  ctx += (size_t)b * D;
  if (n_past < 0 || n_past >= S) {
    for (int d = threadIdx.x; d < HD; d += blockDim.x)
      ctx[off + d] = from_f32<T>(NAN);
    return;
  }
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    kc[(size_t)n_past * D + off + d] = qkv[D + off + d];
    vc[(size_t)n_past * D + off + d] = qkv[2 * D + off + d];
    q[d] = to_f32(qkv[off + d]);
    kn[d] = to_f32(qkv[D + off + d]);
    vn[d] = to_f32(qkv[2 * D + off + d]);
  }
  __syncthreads();
  const float t = attend_dense<T, KG>(q, kn, vn, kc + off, vc + off, n_past,
                                      D, scale, sc, red, part);
  if (threadIdx.x < HD) ctx[off + threadIdx.x] = from_f32<T>(t);
}

// K6a's standalone kernel: attn_decode_kernel on the int8 cache (int8
// (S, D) slabs with f32 row scales). The fresh K and V rows (params dtype,
// in qkv) get their row scales from the amax over all D, which every
// head's block computes alike (a max is exact in any order), so no block
// waits on another; a block writes its head's 64 int8 values of each row
// at slot n_past, the head-0 block the two scales, and each block scores
// the fresh row from its own copy, never reading the slot another block
// writes.
template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
    attn_decode_i8_kernel(const T* __restrict__ qkv, signed char* kc,
                          signed char* vc, float* ks, float* vs,
                          const int* __restrict__ n_past_dev, int S, int D,
                          float scale, T* __restrict__ ctx) {
  constexpr int KG = ATT_THREADS / (HD / 8);
  extern __shared__ float sc[];  // n_past + 1 scores
  __shared__ int qw[HD / 4], kq[HD / 4], vq[HD / 4];
  __shared__ float red[32];
  __shared__ float part[KG][HD + 1];
  const int off = blockIdx.x * HD;
  const int b = blockIdx.y;
  const int n_past = n_past_dev[b];
  qkv += (size_t)b * 3 * D;
  kc += (size_t)b * S * D;
  vc += (size_t)b * S * D;
  ks += (size_t)b * S;
  vs += (size_t)b * S;
  ctx += (size_t)b * D;
  if (n_past < 0 || n_past >= S) {
    for (int d = threadIdx.x; d < HD; d += blockDim.x)
      ctx[off + d] = from_f32<T>(NAN);
    return;
  }
  const T* knew = qkv + D;
  const T* vnew = qkv + 2 * D;
  float ka = 0.0f, va = 0.0f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    ka = fmaxf(ka, fabsf(to_f32(knew[i])));
    va = fmaxf(va, fabsf(to_f32(vnew[i])));
  }
  const float sk = i8_scale(block_max(ka, red));
  const float sv = i8_scale(block_max(va, red));
  if (threadIdx.x < HD) {
    const int d = threadIdx.x;
    const signed char k8 = quant_i8(to_f32(knew[off + d]), i8_inv(sk));
    const signed char v8 = quant_i8(to_f32(vnew[off + d]), i8_inv(sv));
    kc[(size_t)n_past * D + off + d] = k8;
    vc[(size_t)n_past * D + off + d] = v8;
    reinterpret_cast<signed char*>(kq)[d] = k8;
    reinterpret_cast<signed char*>(vq)[d] = v8;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ks[n_past] = sk;
    vs[n_past] = sv;
  }
  float qv = 0.0f;
  if (threadIdx.x < HD) qv = to_f32(qkv[off + threadIdx.x]) * scale;
  const float sq = quant_query(qv, qw, red);
  const float t =
      attend_int8<T, KG>(qw, sq, kq, vq, sk, sv, kc + off, vc + off, ks, vs,
                         n_past, D, sc, red, part);
  if (threadIdx.x < HD) ctx[off + threadIdx.x] = from_f32<T>(t);
}

// Attention of one decode step for one layer: one block per head and lane,
// K6a for an int8 cache.
template <typename T>
int attn_decode_t(const T* qkv, BarkKV kv, const int* n_past_dev, int B,
                  int S, int D, int n_head, T* ctx, cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)(D / n_head)));
  const dim3 grid(n_head, B);
  const size_t smem = S * sizeof(float);
  if (kv.ks != nullptr)
    attn_decode_i8_kernel<T><<<grid, ATT_THREADS, smem, st>>>(
        qkv, (signed char*)kv.k, (signed char*)kv.v, kv.ks, kv.vs,
        n_past_dev, S, D, scale, ctx);
  else
    attn_decode_kernel<T><<<grid, ATT_THREADS, smem, st>>>(
        qkv, (T*)kv.k, (T*)kv.v, n_past_dev, S, D, scale, ctx);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ LM head (K2)

// logits[v] = dot(LN_f(x), head[v, :]) for v in [lo, hi), f32. One warp per
// vocab row of the (V, D) head; every block recomputes ln_f of the one row.
// K2 ends with it (bark_launch_lm_head); the persistent step has its own
// LM phase.
template <typename T>
__global__ void __launch_bounds__(LM_WARPS * 32)
    lm_head_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const T* __restrict__ b, const T* __restrict__ head, int D,
                   int lo, int hi, float* __restrict__ logits) {
  extern __shared__ float hs[];  // D floats
  __shared__ float red[32];
  block_layer_norm<T>(x, g, b, hs, D, red);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v = lo + blockIdx.x * LM_WARPS + warp;
  if (v >= hi) return;
  const T* row = head + (size_t)v * D;
  float s = 0.0f;
  for (int i = 2 * lane; i < D; i += 64) {
    float a, c;
    load2(row + i, a, c);
    s = fmaf(hs[i], a, s);
    s = fmaf(hs[i + 1], c, s);
  }
  s = warp_sum(s);
  if (lane == 0) logits[v] = s;
}

template <typename T>
int lm_head_t(const BarkGPTWeights* w, const void* x_row, float* logits,
              int lo, int hi, cudaStream_t st) {
  const int D = w->n_embd;
  if (hi > lo) {
    lm_head_kernel<T><<<cdiv(hi - lo, LM_WARPS), LM_WARPS * 32,
                        D * sizeof(float), st>>>(
        (const T*)x_row, (const T*)w->ln_f_g, (const T*)w->ln_f_b,
        (const T*)w->lm_head, D, lo, hi, logits);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the step

template <typename Weights>
struct StepArgs {
  Weights w;
  // the tiled copies: each phase's (L, K, N) weight (qkv, proj, fc, out),
  // then (packed only) the LM head's; a chunk of a tile's rows is one
  // contiguous run of bytes
  const void* tiles[PH_N + 1];
  const int* plan;     // the step_plan table
  const int* tok;      // the token, in device memory
  BarkKV kv;           // the stage's (L, S, D) caches (int8 with scales)
  float* partial;      // two buffers of `cap` floats
  unsigned* count;     // the grid barrier's count: 0, left 0
  unsigned long long* stamps;  // blocks x (2 * barriers + 3), or null
  float* logits;       // (n_out_vocab,)
  int n_past, cap, plan_ints;
  BarkStepLoop lp;     // the step loop's (zero in K1's single step)
};

// A step's state kept in shared memory at a fixed offset, so that no
// register holds it across the layers: the slot the step writes, the
// chunks of a block's sequence a step (the step loop's producer wraps
// after them), in the step loop the ring's producer (chunks issued and
// freed, the cursor: thread 0 alone walks it there), the sampler's merge
// scratch (a warp's partial, 4 words, for each of 16 warps); and the step
// loop's stamps, thread 0's clock readings, copied out at the end of a
// stamped launch of at most LOOP_STAMP_STEPS.
enum {
  W_N_PAST = 0, W_CHUNKS = 1, W_ISSUED = 2, W_FREED = 3, W_CURSOR = 4,
  W_MERGE = 8, STATE_WORDS = 8 + 64
};
constexpr int LOOP_STAMP_STEPS = 64;
constexpr int LOOP_STAMPS = 2 + 3 * LOOP_STAMP_STEPS;

// Shared memory (dynamic): the ring and its mbarriers, the loop's stamps,
// the step's state, the plan, K6a's int8 rows, f32 rows.
inline size_t step_smem(int D, int S) {
  const size_t words = 2 * LOOP_STAMPS + STATE_WORDS + PLAN_MAX +
                       3 * (HD / 4) + D + 4 * D + PS_WARPS * TILE + S +
                       PS_KG * (HD + 1) + 3 * HD + 32 + 64;
  return RING_BYTES + 8 * MAX_SLOTS + 4 * words;
}

// One block's view of the step: its shared memory, its chunk ring and the
// plan. Every member function is called by all threads of the block alike.
// LOOP (the step loop): the ring's producer lives in the state's shared
// words and thread 0 alone walks it, so that no thread holds it in
// registers across the phases; in K1 every thread walks it alike. (K1 on
// the loop's producer was slower: probes/k3k4_profile.py on an H100 at
// 700 W, the step at n_past 300 q4_0 0.3678-0.3688 ms against 0.3533-
// 0.3536 with its own, dense 0.3592-0.3622 against 0.3543-0.3579.)
template <typename R, bool LOOP = false>
struct Step {
  using T = typename R::T;
  static constexpr int SLOT = R::SLOT;
  static constexpr int NS = RING_BYTES / SLOT;      // ring slots
  static_assert(NS <= MAX_SLOTS, "the ring has mbarriers for MAX_SLOTS");

  const StepArgs<typename R::Weights>& a;
  int* plan;  // the plan, in shared memory
  int G, L, D, S, b, lm_rows;
  unsigned long long* stamp_buf;  // the loop's stamps, in shared memory
  int* state;  // the step's state (W_*), in shared memory
  unsigned char* ring;
  uint64_t* full;  // a slot's mbarrier: its chunk's bytes landed
  int *qw, *kq, *vq;
  float *x, *vin, *red2, *sc, *qs, *kn, *vn, *red, *sums;
  int sums_turn;  // which half of `sums` the next sum_all writes
  float (*part)[HD + 1];
  // the ring: chunks issued, chunks every thread is done with, chunks taken
  int issued, freed, taken;
  // the producer's cursor: layer (L: the LM section), phase, item (the LM
  // tile when packed), row
  int c_layer, c_phase, c_item, c_row;

  __device__ Step(const StepArgs<typename R::Weights>& args,
                  unsigned char* smem)
      : a(args), G(gridDim.x), L(args.w.n_layer),
        D(args.w.n_embd), S(args.w.block_size), b(blockIdx.x),
        issued(0), freed(0), taken(0), c_layer(0), c_phase(0), c_item(0),
        c_row(0) {
    lm_rows = SLOT / (D * (int)sizeof(T));
    ring = smem;
    full = reinterpret_cast<uint64_t*>(smem + RING_BYTES);
    stamp_buf = reinterpret_cast<unsigned long long*>(full + MAX_SLOTS);
    state = reinterpret_cast<int*>(stamp_buf + LOOP_STAMPS);
    plan = state + STATE_WORDS;
    qw = plan + PLAN_MAX;
    kq = qw + HD / 4;
    vq = kq + HD / 4;
    float* f = reinterpret_cast<float*>(vq + HD / 4);
    x = f;
    vin = x + D;
    red2 = vin + 4 * D;
    sc = red2 + PS_WARPS * TILE;
    part = reinterpret_cast<float(*)[HD + 1]>(sc + S);
    qs = sc + S + PS_KG * (HD + 1);
    kn = qs + HD;
    vn = kn + HD;
    red = vn + HD;
    sums = red + 32;
    sums_turn = 0;
  }

  __device__ __forceinline__ int pl(int i) const { return plan[i]; }

  // the slot this step writes: K1's argument, or the step loop's current
  // step's (in the state's shared words)
  __device__ __forceinline__ int n_past() const {
    if constexpr (LOOP)
      return state[W_N_PAST];
    else
      return a.n_past;
  }

  // the ring's mbarriers, the step's state, and the plan table into shared
  // memory (it is read at every chunk and fold)
  __device__ void setup() {
    if (threadIdx.x == 0) {
      for (int i = 0; i < NS; ++i) mbar_init(&full[i], 1);
      mbar_fence_init();
      if (LOOP)
        for (int i = 0; i < W_MERGE; ++i) state[i] = 0;
    }
    for (int i = threadIdx.x; i < a.plan_ints; i += PS_THREADS)
      plan[i] = __ldg(a.plan + i);
    __syncthreads();
  }
  __device__ __forceinline__ int start(int p, int blk) const {
    return pl(pl(PL_STARTS + p) + blk);
  }
  __device__ __forceinline__ void item(int p, int i, int& tile, int& k0,
                                       int& k1, int& flags) const {
    const int o = pl(PL_ITEMS + p) + 4 * i;
    tile = pl(o);
    k0 = pl(o + 1);
    k1 = pl(o + 2);
    flags = pl(o + 3);
  }
  __device__ __forceinline__ float* buf(int p) const {
    return a.partial + (size_t)(p & 1) * a.cap;
  }

  // phase p's tiled weight of layer l, and its K
  __device__ const unsigned char* tiles(int p, int l, int& K) const {
    const int N = p == PH_QKV ? 3 * D : p == PH_FC ? 4 * D : D;
    K = p == PH_OUT ? 4 * D : D;
    return (const unsigned char*)a.tiles[p] +
           (size_t)l * (N / TILE) * R::tile_bytes(K);
  }

  // past a step's last chunk (chunk `issued` would be the next step's
  // first): the cursor to the next step's start, or false after the
  // launch's last step (K1's only one)
  __device__ bool next_step() {
    if (!LOOP || issued >= state[W_CHUNKS] * a.lp.n_steps) return false;
    c_layer = c_phase = c_item = c_row = 0;
    return true;
  }

  // the chunks of this block's sequence a step, as next_chunk walks them
  __device__ int chunks_a_step() const {
    int n = 0;
    for (int p = 0; p < PH_N; ++p)
      for (int i = start(p, b); i < start(p, b + 1); ++i) {
        int tile, k0, k1, flags;
        item(p, i, tile, k0, k1, flags);
        n += (k1 - k0 + R::CH - 1) / R::CH;
      }
    n *= L;
    const int v0 = pl(pl(PL_LM) + 2 * b), v1 = pl(pl(PL_LM) + 2 * b + 1);
    if (v1 > v0)
      n += R::PACKED ? (v1 - v0) * ((D + R::CH - 1) / R::CH)
                     : (v1 - v0 + lm_rows - 1) / lm_rows;
    return n;
  }

  // The chunk at the producer's cursor (`bytes` from src), advancing the
  // cursor; false past the block's last (of the launch's last step).
  __device__ bool next_chunk(const void*& src, unsigned& bytes) {
    while (true) {
      if (c_layer == L) {
        const int v0 = pl(pl(PL_LM) + 2 * b), v1 = pl(pl(PL_LM) + 2 * b + 1);
        if constexpr (R::PACKED) {  // tiles [v0, v1), each over all D rows
          if (v0 + c_item >= v1) {
            if (!next_step()) return false;
            continue;
          }
          if (c_row >= D) {
            ++c_item;
            c_row = 0;
            continue;
          }
          const int rows = min(R::CH, D - c_row);
          src = (const unsigned char*)a.tiles[PH_N] +
                (size_t)(v0 + c_item) * R::tile_bytes(D) + R::row_at(c_row);
          bytes = R::row_at(rows);
          c_row += rows;
          return true;
        } else {  // vocab rows [v0, v1) of the (V, D) head
          if (v0 + c_row >= v1) {
            if (!next_step()) return false;
            continue;
          }
          const int rows = min(lm_rows, v1 - v0 - c_row);
          src = (const T*)a.w.lm_head + (size_t)(v0 + c_row) * D;
          bytes = rows * D * sizeof(T);
          c_row += rows;
          return true;
        }
      }
      const int i = start(c_phase, b) + c_item;
      if (i >= start(c_phase, b + 1)) {
        c_item = 0;
        c_row = 0;
        if (++c_phase == PH_N) {
          c_phase = 0;
          ++c_layer;
        }
        continue;
      }
      int tile, k0, k1, flags;
      item(c_phase, i, tile, k0, k1, flags);
      if (k0 + c_row >= k1) {
        ++c_item;
        c_row = 0;
        continue;
      }
      int K;
      const unsigned char* W = tiles(c_phase, c_layer, K);
      const int rows = min(R::CH, k1 - k0 - c_row);
      src = W + (size_t)tile * R::tile_bytes(K) + R::row_at(k0 + c_row);
      bytes = R::row_at(rows);
      c_row += rows;
      return true;
    }
  }

  // Fill the free slots: one bulk copy a chunk, issued by thread 0, its
  // bytes completing on the slot's mbarrier (every thread walks the cursor
  // alike, none waiting on the copy's issue but thread 0; LOOP: thread 0
  // alone, its producer loaded from and stored to the state's words).
  __device__ void top_up() {
    if constexpr (LOOP) {
      if (threadIdx.x != 0) return;
      int* w = state;
      issued = w[W_ISSUED];
      freed = w[W_FREED];
      c_layer = w[W_CURSOR];
      c_phase = w[W_CURSOR + 1];
      c_item = w[W_CURSOR + 2];
      c_row = w[W_CURSOR + 3];
      fill();
      w[W_ISSUED] = issued;
      w[W_CURSOR] = c_layer;
      w[W_CURSOR + 1] = c_phase;
      w[W_CURSOR + 2] = c_item;
      w[W_CURSOR + 3] = c_row;
    } else {
      fill();
    }
  }

  // the chunks every thread is done with: those before chunk i
  __device__ __forceinline__ void free_before(int i) {
    if constexpr (LOOP) {
      if (threadIdx.x == 0) state[W_FREED] = i;
    } else {
      freed = i;
    }
  }

  __device__ void fill() {
    while (issued < freed + NS) {
      const void* src;
      unsigned bytes;
      if (!next_chunk(src, bytes)) return;
      if (threadIdx.x == 0) {
        const int slot = issued % NS;
        mbar_expect_tx(&full[slot], bytes);
        bulk_copy(ring + (size_t)slot * SLOT, src, bytes, &full[slot]);
      }
      ++issued;
    }
  }

  // The next chunk of the sequence, landed; the slots of the chunks before
  // it are refilled.
  __device__ const unsigned char* take() {
    const int i = taken++;
    mbar_wait(&full[i % NS], (i / NS) & 1);
    __syncthreads();
    free_before(i);
    top_up();
    return ring + (size_t)(i % NS) * SLOT;
  }

  // after a __syncthreads that follows the last use of the chunks taken
  // (a barrier's arrival)
  __device__ void release() {
    free_before(taken);
    top_up();
  }

  // Phase p's partials of column col folded in the plan's order, up to
  // FOLD_BATCH loads in flight.
  __device__ float fold(int p, int col) const {
    const float* part_p = buf(p) + col % TILE;
    const int tile = col / TILE, o = pl(PL_FOLD_OFF + p);
    const int* list = plan + pl(PL_FOLD + p);
    const int j1 = pl(o + tile + 1);
    float acc = 0.0f;
    for (int j = pl(o + tile); j < j1; j += FOLD_BATCH) {
      float v[FOLD_BATCH];
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u)
        if (j + u < j1) v[u] = __ldcg(part_p + (size_t)list[j + u] * TILE);
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u)
        if (j + u < j1) acc += v[u];
    }
    return acc;
  }

  // f[u] = phase p's partials of column threadIdx.x + u * PS_THREADS (0
  // past D) folded in the plan's order, both columns' loads in flight
  // together
  __device__ void fold_cols(int p, float* f) const {
    const float* part_p = buf(p);
    const int o = pl(PL_FOLD_OFF + p);
    const int* list = plan + pl(PL_FOLD + p);
    int j[VPT], j1[VPT], c[VPT];
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int col = threadIdx.x + u * PS_THREADS;
      f[u] = 0.0f;
      j[u] = j1[u] = c[u] = 0;
      if (col < D) {
        j[u] = pl(o + col / TILE);
        j1[u] = pl(o + col / TILE + 1);
        c[u] = col % TILE;
      }
    }
    while (true) {
      bool more = false;
#pragma unroll
      for (int u = 0; u < VPT; ++u) more |= j[u] < j1[u];
      if (!more) break;
      float v[VPT][FOLD2_BATCH];
#pragma unroll
      for (int u = 0; u < VPT; ++u)
#pragma unroll
        for (int k = 0; k < FOLD2_BATCH; ++k)
          if (j[u] + k < j1[u])
            v[u][k] =
                __ldcg(part_p + (size_t)list[j[u] + k] * TILE + c[u]);
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
#pragma unroll
        for (int k = 0; k < FOLD2_BATCH; ++k)
          if (j[u] + k < j1[u]) f[u] += v[u][k];
        j[u] += FOLD2_BATCH;
      }
    }
  }

  // epilogue of a projection: round(round(sum) + bias), the bias loaded
  // before the partials
  __device__ __forceinline__ float proj_out(int p, int col,
                                            const T* bias) const {
    const float b = to_f32(bias[col]);
    return round_t<T>(round_t<T>(fold(p, col)) + b);
  }

  // a hint to bring n values from v into the L2 (one per 128-byte line)
  __device__ void prefetch(const void* v, size_t bytes) const {
    for (size_t i = (size_t)threadIdx.x * 128; i < bytes;
         i += (size_t)PS_THREADS * 128)
      prefetch_l2((const char*)v + i);
  }

  // x = wte[t] + wpe[n_past] (NaN for a token outside the table; a
  // packed row dequantized as the densified table holds it); the
  // rows' loads go out ahead of the ring's refill (`top_up`: K1's first
  // weight chunks), which the embed then waits behind no longer than its
  // own loads take
  __device__ void embed(int t) {
    constexpr int MAX_PER = VPT;
    const bool ok = t >= 0 && t < a.w.n_in_vocab;
    const T* wpe = (const T*)a.w.wpe + (size_t)n_past() * D;
    float e[MAX_PER], q[MAX_PER];
#pragma unroll
    for (int u = 0; u < MAX_PER; ++u) {
      const int d = threadIdx.x + u * PS_THREADS;
      if (d < D) {
        e[u] = R::embed(a.w, ok ? t : 0, d, D);
        q[u] = to_f32(wpe[d]);
      }
    }
    top_up();
#pragma unroll
    for (int u = 0; u < MAX_PER; ++u) {
      const int d = threadIdx.x + u * PS_THREADS;
      if (d < D) x[d] = ok ? round_t<T>(e[u] + q[u]) : NAN;
    }
    __syncthreads();
  }

  // A block-wide sum with one __syncthreads: the warps' sums go to the two
  // halves of `sums` in turn, so a half is written again only after every
  // thread has passed the next sum's barrier, having read it.
  __device__ float sum_all(float v) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_sum(v);
    float* half = sums + 32 * sums_turn;
    sums_turn ^= 1;
    if (lane == 0) half[warp] = v;
    __syncthreads();
    return warp_sum(lane < PS_WARPS ? half[lane] : 0.0f);
  }

  // x += round(round(fold of phase pf) + bias), the residual rounded (none
  // when bias is null); then vin = LN(x) with affine (g, bb), rounded to T.
  // The thread's columns of bias, g and bb load before the partials; a
  // thread reads only its own columns of x until the closing barrier.
  __device__ void residual_ln(int pf, const T* bias, const T* g,
                              const T* bb) {
    float vb[VPT], vg[VPT], vbb[VPT], f[VPT];
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int d = threadIdx.x + u * PS_THREADS;
      vb[u] = vg[u] = vbb[u] = 0.0f;
      if (d < D) {
        if (bias != nullptr) vb[u] = to_f32(bias[d]);
        vg[u] = to_f32(g[d]);
        vbb[u] = to_f32(bb[d]);
      }
    }
    if (bias != nullptr) {
      fold_cols(pf, f);
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        const int d = threadIdx.x + u * PS_THREADS;
        if (d < D)
          x[d] = round_t<T>(x[d] + round_t<T>(round_t<T>(f[u]) + vb[u]));
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int d = threadIdx.x + u * PS_THREADS;
      if (d < D) s += x[d];
    }
    const float mean = sum_all(s) / (float)D;
    float sq = 0.0f;
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int d = threadIdx.x + u * PS_THREADS;
      if (d < D) {
        const float e = x[d] - mean;
        sq += e * e;
      }
    }
    const float inv = 1.0f / sqrtf(sum_all(sq) / (float)D + BARK_EPS_NORM);
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int d = threadIdx.x + u * PS_THREADS;
      if (d < D) {
        const float y = (x[d] - mean) * inv;
        vin[d] = round_t<T>(y * vg[u] + vbb[u]);
      }
    }
    __syncthreads();
  }

  // Rows [k0, k1) of a tile against vin[k0:k1], in ring chunks (the read
  // policy's share of each chunk a thread), the 16 warps' sums added in
  // order: column threadIdx.x's sum for threads < TILE.
  __device__ float gemv_rows(int k0, int k1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float a0 = 0.0f, a1 = 0.0f;
    for (int r0 = k0; r0 < k1; r0 += R::CH)
      R::dot_chunk(take(), vin + r0, min(R::CH, k1 - r0), a0, a1);
    red2[warp * TILE + 2 * lane] = a0;
    red2[warp * TILE + 2 * lane + 1] = a1;
    __syncthreads();
    float s = 0.0f;
    if (threadIdx.x < TILE)
      for (int g = 0; g < PS_WARPS; ++g) s += red2[g * TILE + threadIdx.x];
    __syncthreads();
    return s;
  }

  // Item i of phase p: its tile's rows [k0, k1), into the item's partial
  // (row i of the phase's buffer).
  __device__ void gemv_item(int p, int i) {
    int tile, k0, k1, flags;
    item(p, i, tile, k0, k1, flags);
    const float s = gemv_rows(k0, k1);
    if (threadIdx.x < TILE) __stcg(buf(p) + (size_t)i * TILE + threadIdx.x, s);
  }

  __device__ void gemv_phase(int p) {
    for (int i = start(p, b); i < start(p, b + 1); ++i) gemv_item(p, i);
  }

  // Head h of layer l: fold its q/k/v columns (all k/v columns for the
  // int8 row scales), write its K/V cache row when `writes` (and the int8
  // scales when `scales`), attend, and leave ctx_h in vin[h*64 : h*64+64].
  __device__ void attend(int l, int h, bool writes, bool scales) {
    const T* bias = (const T*)a.w.qkv_b + (size_t)l * 3 * D;
    const size_t slab = (size_t)l * S;
    const int off = h * HD, n_past = this->n_past();
    float t;
    if (a.kv.ks == nullptr) {
      if (threadIdx.x < 3 * HD) {
        const int which = threadIdx.x / HD, d = threadIdx.x - which * HD;
        const float v = proj_out(PH_QKV, which * D + off + d, bias);
        (which == 0 ? qs : which == 1 ? kn : vn)[d] = v;
        if (writes && which > 0) {
          T* c = (T*)(which == 1 ? a.kv.k : a.kv.v);
          c[(slab + n_past) * D + off + d] = from_f32<T>(v);
        }
      }
      __syncthreads();
      t = attend_dense<T, PS_KG>(qs, kn, vn, (const T*)a.kv.k + slab * D + off,
                                 (const T*)a.kv.v + slab * D + off, n_past,
                                 D, ATT_SCALE, sc, red, part);
    } else {
      float ka = 0.0f, va = 0.0f;
      for (int c = threadIdx.x; c < 2 * D; c += PS_THREADS) {
        const float v = proj_out(PH_QKV, D + c, bias);
        const int which = c / D, d = c - which * D - off;
        if (which == 0)
          ka = fmaxf(ka, fabsf(v));
        else
          va = fmaxf(va, fabsf(v));
        if (d >= 0 && d < HD) (which == 0 ? kn : vn)[d] = v;
      }
      if (threadIdx.x < HD)
        qs[threadIdx.x] = proj_out(PH_QKV, off + threadIdx.x, bias);
      const float sk = i8_scale(block_max(ka, red));
      const float sv = i8_scale(block_max(va, red));
      signed char* kc = (signed char*)a.kv.k + slab * D + off;
      signed char* vc = (signed char*)a.kv.v + slab * D + off;
      if (threadIdx.x < HD) {
        const int d = threadIdx.x;
        const signed char k8 = quant_i8(kn[d], i8_inv(sk));
        const signed char v8 = quant_i8(vn[d], i8_inv(sv));
        reinterpret_cast<signed char*>(kq)[d] = k8;
        reinterpret_cast<signed char*>(vq)[d] = v8;
        if (writes) {
          kc[(size_t)n_past * D + d] = k8;
          vc[(size_t)n_past * D + d] = v8;
        }
      }
      if (scales && threadIdx.x == 0) {
        a.kv.ks[slab + n_past] = sk;
        a.kv.vs[slab + n_past] = sv;
      }
      const float qv = threadIdx.x < HD ? qs[threadIdx.x] * ATT_SCALE : 0.0f;
      const float sq = quant_query(qv, qw, red);
      t = attend_int8<T, PS_KG>(qw, sq, kq, vq, sk, sv, kc, vc,
                                a.kv.ks + slab, a.kv.vs + slab, n_past, D,
                                sc, red, part);
    }
    if (threadIdx.x < HD) vin[off + threadIdx.x] = round_t<T>(t);
    __syncthreads();
  }

  // attention + proj: for each head the block's proj items lie in, the
  // head's attention, then those items (over its 64 rows of proj)
  __device__ void attention_proj_phase(int l) {
    const int s1 = start(PH_PROJ, b + 1);
    int i = start(PH_PROJ, b);
    while (i < s1) {
      int tile, k0, k1, flags;
      item(PH_PROJ, i, tile, k0, k1, flags);
      const int h = k0 / HD;
      attend(l, h, flags & ITEM_WRITES_KV, flags & ITEM_WRITES_SCALES);
      for (; i < s1; ++i) {
        item(PH_PROJ, i, tile, k0, k1, flags);
        if (k0 / HD != h) break;
        gemv_item(PH_PROJ, i);
      }
    }
  }

  // x += proj (folded), LN2, fc
  __device__ void fc_phase(int l) {
    residual_ln(PH_PROJ, (const T*)a.w.proj_b + (size_t)l * D,
                (const T*)a.w.ln2_g + (size_t)l * D,
                (const T*)a.w.ln2_b + (size_t)l * D);
    gemv_phase(PH_FC);
  }

  // h = GELU(fc) on the block's K rows of out, then out
  __device__ void out_phase(int l) {
    const T* bias = (const T*)a.w.fc_b + (size_t)l * 4 * D;
    for (int i = start(PH_OUT, b); i < start(PH_OUT, b + 1); ++i) {
      int tile, k0, k1, flags;
      item(PH_OUT, i, tile, k0, k1, flags);
      for (int r = k0 + threadIdx.x; r < k1; r += PS_THREADS)
        vin[r] = round_t<T>(gelu_tanh(proj_out(PH_FC, r, bias)));
      __syncthreads();
    }
    gemv_phase(PH_OUT);
  }

  // x += out (last layer), ln_f, the block's LM rows; zero outside [lo, hi)
  __device__ void lm_phase() {
    residual_ln(PH_OUT, (const T*)a.w.out_b + (size_t)(L - 1) * D,
                (const T*)a.w.ln_f_g, (const T*)a.w.ln_f_b);
    const int v0 = pl(pl(PL_LM) + 2 * b), v1 = pl(pl(PL_LM) + 2 * b + 1);
    const int lo = pl(PL_LO), hi = pl(PL_HI);
    if constexpr (R::PACKED) {  // whole-K 64-column tiles [v0, v1)
      for (int t = v0; t < v1; ++t) {
        const float s = gemv_rows(0, D);
        const int col = t * TILE + threadIdx.x;
        if (threadIdx.x < TILE && col >= lo && col < hi) a.logits[col] = s;
      }
    } else {  // a warp a vocab row
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      for (int r0 = v0; r0 < v1; r0 += lm_rows) {
        const T* w = reinterpret_cast<const T*>(take());
        const int rows = min(lm_rows, v1 - r0);
        for (int r = warp; r < rows; r += PS_WARPS) {
          const T* row = w + (size_t)r * D;
          float s = 0.0f;
          int i = 2 * lane;
          for (; i + 192 < D; i += 256) {  // 4 pairs in flight
            float p[4], q[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) load2(row + i + 64 * u, p[u], q[u]);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              s = fmaf(vin[i + 64 * u], p[u], s);
              s = fmaf(vin[i + 64 * u + 1], q[u], s);
            }
          }
          for (; i < D; i += 64) {
            float p, q;
            load2(row + i, p, q);
            s = fmaf(vin[i], p, s);
            s = fmaf(vin[i + 1], q, s);
          }
          s = warp_sum(s);
          if (lane == 0) a.logits[r0 + r] = s;
        }
      }
    }
    for (int v = b * PS_THREADS + threadIdx.x; v < a.w.n_out_vocab;
         v += G * PS_THREADS)
      if (v < lo || v >= hi) a.logits[v] = 0.0f;
  }

  // At the barrier that ends phase `done` of layer l: a hint to bring
  // what the next phase reads and the ring does not into the L2 (its
  // biases and LN affines; after QKV, the cache rows of the heads this
  // block attends), so its loads wait on the L2, not on device memory.
  __device__ void prefetch_next(int l, int done) const {
    const size_t e = sizeof(T), row = (size_t)D * e;
    const int n_past = this->n_past();
    if (done == PH_QKV) {
      prefetch((const T*)a.w.qkv_b + (size_t)l * 3 * D, 3 * row);
      prefetch((const T*)a.w.proj_b + (size_t)l * D, row);
      const bool q8 = a.kv.ks != nullptr;
      const size_t re = q8 ? 1 : e;  // bytes of a cache value
      int last = -1;
      for (int i = start(PH_PROJ, b); i < start(PH_PROJ, b + 1); ++i) {
        int tile, k0, k1, flags;
        item(PH_PROJ, i, tile, k0, k1, flags);
        const int h = k0 / HD;
        if (h == last) continue;
        last = h;
        const size_t base = ((size_t)l * S * D + (size_t)h * HD) * re;
        for (int j = threadIdx.x; j < n_past; j += PS_THREADS)
          for (size_t o = 0; o < HD * re; o += 128) {
            prefetch_l2((const char*)a.kv.k + base + j * D * re + o);
            prefetch_l2((const char*)a.kv.v + base + j * D * re + o);
          }
      }
      if (q8) {
        prefetch(a.kv.ks + (size_t)l * S, n_past * sizeof(float));
        prefetch(a.kv.vs + (size_t)l * S, n_past * sizeof(float));
      }
    } else if (done == PH_PROJ) {
      prefetch((const T*)a.w.ln2_g + (size_t)l * D, row);
      prefetch((const T*)a.w.ln2_b + (size_t)l * D, row);
    } else if (done == PH_FC) {
      prefetch((const T*)a.w.fc_b + (size_t)l * 4 * D, 4 * row);
      prefetch((const T*)a.w.out_b + (size_t)l * D, row);
      const bool last_layer = l + 1 == L;
      prefetch(last_layer ? a.w.ln_f_g
                          : (const T*)a.w.ln1_g + (size_t)(l + 1) * D, row);
      prefetch(last_layer ? a.w.ln_f_b
                          : (const T*)a.w.ln1_b + (size_t)(l + 1) * D, row);
    }
  }

  // the k-th stamp of this block (its own row of 2 x barriers + 3)
  __device__ void stamp(int k) const {
    if (a.stamps != nullptr) {
      __syncthreads();
      if (threadIdx.x == 0)
        a.stamps[(size_t)b * (2 * PH_N * L + 3) + k] = global_ns();
    }
  }

  // The k-th barrier of the step (from 1), after phase `done` of layer l:
  // between its arrival and its wait the block refills the ring's freed
  // slots and hints the next phase's reads into the L2.
  __device__ void barrier(int k, int l, int done) {
    stamp(2 * k);
    grid_arrive(a.count);
    release();
    prefetch_next(l, done);
    grid_wait(a.count, (unsigned)k * G);
    stamp(2 * k + 1);
  }

  // The layers of a step (4 barriers each), from the embedded x; k counts
  // the launch's barriers.
  __device__ void layers(int& k) {
    for (int l = 0; l < L; ++l) {
      residual_ln(PH_OUT,
                  l > 0 ? (const T*)a.w.out_b + (size_t)(l - 1) * D : nullptr,
                  (const T*)a.w.ln1_g + (size_t)l * D,
                  (const T*)a.w.ln1_b + (size_t)l * D);
      gemv_phase(PH_QKV);
      barrier(++k, l, PH_QKV);
      attention_proj_phase(l);
      barrier(++k, l, PH_PROJ);
      fc_phase(l);
      barrier(++k, l, PH_FC);
      out_phase(l);
      barrier(++k, l, PH_OUT);
    }
  }

  // the sample's barrier (the k-th of the launch): the block refills its
  // ring while it waits
  __device__ void sample_barrier(int k) {
    grid_arrive(a.count);
    release();
    grid_wait(a.count, (unsigned)k * G);
  }

  // the k-th stamp of this block in the step loop's row of 2 + 3 n_steps,
  // thread 0's clock: the start, then per step j its token folded (1 +
  // 3j), its LM head's start (2 + 3j) and end (3 + 3j), and the end (1 + 3
  // n_steps); kept in shared memory until `loop_stamps_out`
  __device__ void loop_stamp(int k) const {
    if (a.lp.stamps != nullptr && threadIdx.x == 0) stamp_buf[k] = global_ns();
  }
  __device__ void loop_stamps_out() const {
    if (a.lp.stamps != nullptr && threadIdx.x == 0)
      for (int k = 0; k < 2 + 3 * a.lp.n_steps; ++k)
        a.lp.stamps[(size_t)b * (2 + 3 * a.lp.n_steps) + k] = stamp_buf[k];
  }

  // every block arrives once more; the last resets the count to 0 (all
  // have passed every barrier then, so none reads it again)
  __device__ void leave(int n_barriers) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(a.count, 1u) == (unsigned)(n_barriers + 1) * G - 1)
        atomicExch(a.count, 0u);
    }
  }
};

// ------------------------------------------------ the step loop's sampler
//
// It reads the plan and its scratch at fixed offsets of shared memory
// (`loop_smem`), holding nothing of the step's across the layers. Inlined:
// out of line (__noinline__), the calls' register saves made the dense
// chunk and window 4-5% slower (probes/k3k4_profile.py on an H100).

// shared memory at the fixed offset of the step's state (Step::state)
__device__ __forceinline__ int* loop_state() {
  extern __shared__ __align__(128) unsigned char loop_smem[];
  return reinterpret_cast<int*>(loop_smem + RING_BYTES + 8 * MAX_SLOTS +
                                8 * LOOP_STAMPS);
}

// step j's sample window [base, base + n)
__device__ __forceinline__ void loop_window(const BarkStepLoop& lp, int V,
                                            int j, int& base, int& n) {
  if (lp.codebook) {
    n = lp.cbs;
    base = lp.svs + (((lp.step_idx0 + j) & 1) ? lp.cbs : 0);
  } else {
    base = 0;
    n = V;
  }
}

// this block's slots [s0, s1) of step j's window: those of the logits it
// computes (its LM rows, or its packed tiles' columns within [lo, hi);
// kernels/decode.py `sample_slots` mirrors the split)
template <bool PACKED>
__device__ __forceinline__ void loop_slots(const BarkStepLoop& lp, int V,
                                           int j, int& s0, int& s1,
                                           int& base) {
  const int* plan = loop_state() + STATE_WORDS;
  const int b = blockIdx.x;
  int n;
  loop_window(lp, V, j, base, n);
  s0 = plan[plan[PL_LM] + 2 * b];
  s1 = plan[plan[PL_LM] + 2 * b + 1];
  if (PACKED) {
    s0 = max(s0 * TILE, plan[PL_LO]);
    s1 = min(s1 * TILE, plan[PL_HI]);
  }
  s0 = max(s0, base);
  s1 = min(s1, base + n);
}

// step j's noise row (min(row0 + j, rows - 1)), offset so that slot u of
// the window reads element u; null at temp 0
__device__ __forceinline__ const float* loop_noise(const BarkStepLoop& lp,
                                                   int j, int base) {
  return lp.temp != 0.0f
             ? lp.noise +
                   (size_t)min(lp.noise_row0 + j, lp.noise_rows - 1) *
                       lp.noise_ld - base
             : nullptr;
}

// A hint to bring this block's noise of step j's window into the L2, a
// step ahead of its sample (a row is first read there, from device memory)
template <bool PACKED>
__device__ __forceinline__ void prefetch_noise(const BarkStepLoop& lp, int V,
                                               int j) {
  if (lp.temp == 0.0f || j >= lp.n_steps) return;
  int s0, s1, base;
  loop_slots<PACKED>(lp, V, j, s0, s1, base);
  const float* noise = loop_noise(lp, j, base);
  for (int u = s0 + 32 * (int)threadIdx.x; u < s1; u += 32 * PS_THREADS)
    prefetch_l2(noise + u);
}

// logit l on the EOS scale: l / temp, or l / 0.7 at temp 0 (the
// reference's divide); a true division, as ops/sampling.py `divide`
__device__ __forceinline__ float eos_scale(const BarkStepLoop& lp, float l) {
  return lp.temp != 0.0f ? l / lp.temp : l / 0.7f;
}

// A sample partial: the best (value, index) (argmax_take) and, on the EOS
// scale, the largest value m and the sum s of exp(e - m) of the slots seen
// (s 0: none; NaN slots leave m and make s NaN, as a softmax over them
// does).
struct Part {
  float v, m, s;
  int i;
};

// `o` merged into `p`: the same result in either order (max, and sums of
// two terms, commute bit for bit), so lanes that swap partials agree;
// without `eos`, the best pair alone
__device__ __forceinline__ void merge(Part& p, const Part& o, bool eos) {
  argmax_take(p.v, p.i, o.v, o.i);
  if (!eos) return;
  const float m = fmaxf(p.m, o.m);
  p.s = (p.s == 0.0f ? 0.0f : p.s * expf(p.m - m)) +
        (o.s == 0.0f ? 0.0f : o.s * expf(o.m - m));
  p.m = m;
}

// `p` merged over the block (with the EOS sums when `eos`): over each warp
// by a butterfly, the warps' through the state's merge scratch (one
// __syncthreads), then in warp order by the threads that ask (`all`, or
// thread 0 alone). (A second butterfly over the 16 warps' partials in
// place of the ordered merge made the dense step loop spill more and its
// layers slower, probes/k3k4_profile.py on an H100.)
__device__ __forceinline__ Part block_merge(Part p, bool all, bool eos) {
  float* w = reinterpret_cast<float*>(loop_state() + W_MERGE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    Part q;
    q.v = __shfl_xor_sync(0xffffffffu, p.v, o);
    q.m = __shfl_xor_sync(0xffffffffu, p.m, o);
    q.s = __shfl_xor_sync(0xffffffffu, p.s, o);
    q.i = __shfl_xor_sync(0xffffffffu, p.i, o);
    merge(p, q, eos);
  }
  if (lane == 0) {
    w[4 * warp] = p.v;
    w[4 * warp + 1] = p.m;
    w[4 * warp + 2] = p.s;
    w[4 * warp + 3] = __int_as_float(p.i);
  }
  __syncthreads();
  Part t{-INFINITY, -INFINITY, 0.0f, INT_MAX};
  if (all || threadIdx.x == 0)
    for (int u = 0; u < PS_WARPS; ++u)
      merge(t,
            Part{w[4 * u], w[4 * u + 1], w[4 * u + 2],
                 __float_as_int(w[4 * u + 3])},
            eos);
  return t;
}

// Step j's partial from the current logits: this block's slots of the
// window, those of the logits it computes (its LM rows, or its packed
// tiles' columns within [lo, hi); kernels/decode.py `sample_slots` mirrors
// the split), a thread a slot (online over more), written by thread 0 as 4
// floats of lp.part (value, m, s, index). The block's own logits are read
// after the __syncthreads that ended its LM head (j > 0), or the input
// logits (j = 0). One scratch serves every step: the fold reads it right
// after the sample's barrier, and no block writes it again before the
// next step's 4 L barriers.
template <bool PACKED, typename Weights>
__device__ __forceinline__ void sample_partial(const StepArgs<Weights>* args,
                                              int j) {
  const BarkStepLoop& lp = args->lp;
  int s0, s1, base;
  loop_slots<PACKED>(lp, args->w.n_out_vocab, j, s0, s1, base);
  const float* noise = loop_noise(lp, j, base);
  const bool eos = !lp.codebook;
  Part p{-INFINITY, -INFINITY, 0.0f, INT_MAX};
  for (int u = s0 + (int)threadIdx.x; u < s1; u += PS_THREADS) {
    // what the argmax takes: l / temp + the slot's noise, or l at temp 0
    const float l = args->logits[u], e = eos_scale(lp, l);
    if (eos) {
      const float m = fmaxf(p.m, e);
      p.s = (p.s == 0.0f ? 0.0f : p.s * expf(p.m - m)) +
            (e == -INFINITY ? 0.0f : expf(e - m));
      p.m = m;
    }
    argmax_take(p.v, p.i, noise != nullptr ? e + noise[u] : l, u);
  }
  p = block_merge(p, false, eos);
  if (threadIdx.x == 0) {
    float* o = lp.part + 4 * (size_t)blockIdx.x;
    __stcg(o, p.v);
    __stcg(o + 1, p.m);
    __stcg(o + 2, p.s);
    __stcg(o + 3, __int_as_float(p.i));
  }
}

// After the sample's barrier: every block folds the G partials alike
// (thread t takes block t's; merged over each warp, then the warps' in
// order), so all hold the same token (block 0 also the EOS sums). Block 0 writes tok_out[j] and, for
// K3, flag_out[j] = tok == stop_token or eos_p >= min_eos_p, eos_p =
// exp(e_last - m) / s at the window's last slot. Returns the token (base +
// 0 if the window held nothing).
template <typename Weights>
__device__ __forceinline__ int fold_sample(const StepArgs<Weights>* args,
                                          int j) {
  const BarkStepLoop& lp = args->lp;
  int base, n;
  loop_window(lp, args->w.n_out_vocab, j, base, n);
  const float last = __ldcg(args->logits + base + n - 1);
  Part p{-INFINITY, -INFINITY, 0.0f, INT_MAX};
  if (threadIdx.x < gridDim.x) {
    const float* o = lp.part + 4 * (size_t)threadIdx.x;
    p = Part{__ldcg(o), __ldcg(o + 1), __ldcg(o + 2),
             __float_as_int(__ldcg(o + 3))};
  }
  // only block 0 writes the flag: the others merge the best pair alone
  p = block_merge(p, true, !lp.codebook && blockIdx.x == 0);
  const int tok = p.i == INT_MAX ? base : p.i;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    lp.tok_out[j] = tok;
    if (!lp.codebook) {
      const float eos_p = expf(eos_scale(lp, last) - p.m) / p.s;
      lp.flag_out[j] = (int)(tok == lp.stop_token || eos_p >= lp.min_eos_p);
    }
  }
  return tok;
}

template <typename R>
__global__ void __launch_bounds__(PS_THREADS, 1)
    decode_step_kernel(const __grid_constant__ StepArgs<typename R::Weights> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Step<R> s(a, smem);
  s.stamp(0);
  s.setup();
  const int n_barriers = s.pl(PL_BARRIERS);
  if (s.pl(PL_BLOCKS) != (int)gridDim.x || n_barriers != PH_N * s.L ||
      s.pl(PL_LAYERS) != s.L || s.pl(PL_LM_TILES) != (int)R::PACKED)
    __trap();  // a plan for another grid, stage or read: fail the launch
  s.embed(*a.tok);
  s.stamp(1);
  int k = 0;
  s.layers(k);
  s.lm_phase();
  s.stamp(2 * n_barriers + 2);
  s.leave(n_barriers);
}

// K3/K4: n_steps steps of the kernel above in one cooperative launch, the
// sampler inside (see the head of this file). A launch takes 4 L + 1
// barriers a step: the layers', and the sample's before each step's embed.
template <typename R>
__global__ void __launch_bounds__(PS_THREADS, 1)
    decode_steps_kernel(const __grid_constant__ StepArgs<typename R::Weights> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Step<R, true> s(a, smem);
  s.loop_stamp(0);
  s.setup();
  const BarkStepLoop& lp = a.lp;
  const int V = a.w.n_out_vocab, lo = s.pl(PL_LO), hi = s.pl(PL_HI);
  const bool window_ok =
      lp.codebook ? lo <= lp.svs && lp.svs + 2 * lp.cbs <= hi
                  : lo == 0 && hi == V;
  if (s.pl(PL_BLOCKS) != (int)gridDim.x ||
      s.pl(PL_BARRIERS) != PH_N * s.L || s.pl(PL_LAYERS) != s.L ||
      s.pl(PL_LM_TILES) != (int)R::PACKED || !window_ok)
    __trap();  // a plan for another grid, stage, read or window
  if (threadIdx.x == 0) s.state[W_CHUNKS] = s.chunks_a_step();
  __syncthreads();
  s.top_up();  // the ring starts under the first sample
  int k = 0;
  sample_partial<R::PACKED>(&a, 0);
  s.sample_barrier(++k);
  int tok = fold_sample(&a, 0);
  for (int j = 0; j < lp.n_steps; ++j) {
    prefetch_noise<R::PACKED>(lp, a.w.n_out_vocab, j + 1);
    s.loop_stamp(1 + 3 * j);
    if (threadIdx.x == 0) s.state[W_N_PAST] = min(lp.n_past0 + j, lp.clamp);
    __syncthreads();
    s.embed(tok);
    s.layers(k);
    s.loop_stamp(2 + 3 * j);
    s.lm_phase();
    if (j + 1 < lp.n_steps) {
      __syncthreads();  // the block's logits written: its partial reads them
      sample_partial<R::PACKED>(&a, j + 1);
      s.loop_stamp(3 + 3 * j);  // the LM head's end, its partial written
      s.sample_barrier(++k);
      tok = fold_sample(&a, j + 1);
    } else {
      s.loop_stamp(3 + 3 * j);
    }
  }
  s.loop_stamp(1 + 3 * lp.n_steps);
  s.loop_stamps_out();
  s.leave(k);
}

// The co-resident block count of the step's kernels (the single step and
// the step loop) on read R for rows of D values and S cache slots (their
// grid: the fewer of the two), or a negative cudaError / -1 for a shape
// they do not take.
template <typename R>
int step_blocks_t(int D, int S) {
  const size_t smem = step_smem(D, S);
  if (smem > MAX_SMEM || D > VPT * PS_THREADS ||
      (!R::PACKED && D * (int)sizeof(typename R::T) > R::SLOT))
    return -1;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  int loop_per_sm = 0;
  for (const void* f : {(const void*)decode_step_kernel<R>,
                        (const void*)decode_steps_kernel<R>}) {
    if (!err)
      err = (int)cudaFuncSetAttribute(
          f, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  }
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_step_kernel<R>, PS_THREADS, smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &loop_per_sm, decode_steps_kernel<R>, PS_THREADS, smem);
  if (err) return -err;
  return coop ? std::min(per_sm, loop_per_sm) * sms : -1;
}

// one cooperative launch of the single step (loop false) or the step loop
template <typename R>
int decode_step_t(const StepArgs<typename R::Weights>& a, int blocks,
                  cudaStream_t st, bool loop = false) {
  const size_t smem = step_smem(a.w.n_embd, a.w.block_size);
  void* args[] = {(void*)&a};
  const void* f = loop ? (const void*)decode_steps_kernel<R>
                       : (const void*)decode_step_kernel<R>;
  return (int)cudaLaunchCooperativeKernel(f, dim3(blocks), dim3(PS_THREADS),
                                          args, smem, st);
}


// the step's arguments, or false for arguments it does not take
template <typename Weights>
bool step_args(const Weights* w, const void* const* tiles, int n_tiles,
               const int* plan, int plan_ints, int blocks, const int* tok,
               int n_past, void* k_cache, void* v_cache, float* k_scale,
               float* v_scale, float* partial, int cap, unsigned* count,
               unsigned long long* stamps, float* logits,
               StepArgs<Weights>& a) {
  if (w->n_embd / w->n_head != HD || w->n_embd % TILE || blocks < 1 ||
      plan_ints < 1 || plan_ints > PLAN_MAX || n_past < 0 ||
      n_past >= w->block_size ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return false;
  a = StepArgs<Weights>{*w,
                        {},
                        plan,
                        tok,
                        BarkKV{k_cache, v_cache, k_scale, v_scale},
                        partial,
                        count,
                        stamps,
                        logits,
                        n_past,
                        cap,
                        plan_ints};
  for (int i = 0; i < n_tiles; ++i) a.tiles[i] = tiles[i];
  return true;
}

// `a` given the step loop `lp`, or false for a loop the kernel does not
// take
template <typename Weights>
bool loop_args(const BarkStepLoop* lp, int blocks, StepArgs<Weights>& a) {
  const int V = a.w.n_out_vocab, S = a.w.block_size;
  if (lp == nullptr || lp->n_steps < 1 || lp->n_past0 < 0 || lp->clamp < 0 ||
      lp->clamp >= S || blocks > PS_THREADS || lp->tok_out == nullptr ||
      (lp->stamps != nullptr && lp->n_steps > LOOP_STAMP_STEPS) ||
      lp->part == nullptr ||
      (long long)lp->n_steps * (PH_N * a.w.n_layer + 1) * blocks >
          (1ll << 31) ||
      (lp->temp != 0.0f &&
       (lp->noise == nullptr || lp->noise_rows < 1 || lp->noise_row0 < 0)))
    return false;
  if (lp->codebook ? lp->cbs < 1 || lp->svs < 0 || lp->svs + 2 * lp->cbs > V
                   : lp->flag_out == nullptr)
    return false;
  a.lp = *lp;
  return true;
}

}  // namespace

extern "C" int bark_launch_attn_decode_batched(int dtype, const void* qkv,
                                               BarkKV kv, const int* n_past,
                                               int B, int S, int D,
                                               int n_head, void* ctx,
                                               cudaStream_t stream) {
  if (dtype == BARK_BF16)
    return attn_decode_t<bf16>((const bf16*)qkv, kv, n_past, B, S, D, n_head,
                               (bf16*)ctx, stream);
  return attn_decode_t<float>((const float*)qkv, kv, n_past, B, S, D, n_head,
                              (float*)ctx, stream);
}

extern "C" int bark_launch_lm_head(const BarkGPTWeights* w, const void* x_row,
                                   float* logits, int lo, int hi,
                                   cudaStream_t stream) {
  if (w->dtype == BARK_BF16)
    return lm_head_t<bf16>(w, x_row, logits, lo, hi, stream);
  return lm_head_t<float>(w, x_row, logits, lo, hi, stream);
}

// The grid of bark_decode_step (scale_dtype < 0) or bark_decode_step_packed
// (a qpack's scale dtype, BARK_F16 or BARK_F32, and has_min) for a stage
// of params dtype `dtype`, width D and S cache slots: the blocks of its
// kernel the card holds at once (sets the kernel's shared-memory limit).
// Negative: a cudaError negated, or -1 for a shape or format it does not
// take or a card without cooperative launches.
extern "C" int bark_decode_step_blocks(int dtype, int scale_dtype,
                                       int has_min, int D, int S) {
  auto blocks = [&](auto r) { return step_blocks_t<decltype(r)>(D, S); };
  if (dtype == BARK_BF16)
    return scale_dtype < 0
               ? blocks(DenseRead<bf16>{})
               : with_packed_read<bf16>(scale_dtype, has_min, blocks);
  return scale_dtype < 0
             ? blocks(DenseRead<float>{})
             : with_packed_read<float>(scale_dtype, has_min, blocks);
}

// One decode step as one cooperative launch of `blocks` blocks (the grid of
// bark_decode_step_blocks, which `plan`, plan_ints <= 8192 ints, was made
// for). tiles: the four projection weights of the stage (qkv, proj, fc,
// out) laid out tile-major, (L, N / 64, K, 64), 16-byte aligned. k_cache and v_cache
// are the stage's (L, S, D) caches, in the params dtype when k_scale and
// v_scale are null, else int8 with those (L, S) f32 row scales (K6a);
// partial is two buffers of `cap` f32 (cap >= 64 x the plan's most items
// in a phase), count one zeroed uint32 (left zeroed); stamps null, or
// blocks x (2 x barriers + 3) uint64; logits is (n_out_vocab,) f32, zero
// outside the plan's [lo, hi). Returns the launch's cudaError (0 on
// success), -1 for arguments it does not take; nothing falls back.
extern "C" int bark_decode_step(const BarkGPTWeights* w,
                                const void* const* tiles, const int* plan,
                                int plan_ints, int blocks, const int* tok,
                                int n_past,
                                void* k_cache, void* v_cache, float* k_scale,
                                float* v_scale, float* partial, int cap,
                                unsigned* count,
                                unsigned long long* stamps, float* logits,
                                cudaStream_t stream) {
  StepArgs<BarkGPTWeights> a;
  if (!step_args(w, tiles, PH_N, plan, plan_ints, blocks, tok, n_past,
                 k_cache, v_cache, k_scale, v_scale, partial, cap, count,
                 stamps, logits, a))
    return -1;
  if (w->dtype == BARK_BF16)
    return decode_step_t<DenseRead<bf16>>(a, blocks, stream);
  return decode_step_t<DenseRead<float>>(a, blocks, stream);
}

// K5: bark_decode_step on a qpack's weights (csrc/common.cuh
// BarkGPTQWeights), its plan made for packed reads (PL_LM_TILES set).
// tiles: the qpack's four projection weights (qkv, proj, fc, out) and its
// LM head as quant-block records, (L, N / 64, K / 32, rec) and (v_pad /
// 64, D / 32, rec) bytes, rec = 2048 + 64 x the scale's bytes (x 2 with
// mins), 16-byte aligned (kernels/decode.py `step_qtiles`). The rest as
// bark_decode_step's; -1 also for a scale dtype other than f16 or f32.
extern "C" int bark_decode_step_packed(
    const BarkGPTQWeights* w, const void* const* tiles, const int* plan,
    int plan_ints, int blocks, const int* tok, int n_past, void* k_cache,
    void* v_cache, float* k_scale, float* v_scale, float* partial, int cap,
    unsigned* count, unsigned long long* stamps, float* logits,
    cudaStream_t stream) {
  StepArgs<BarkGPTQWeights> a;
  if (w->v_pad % TILE ||
      !step_args(w, tiles, PH_N + 1, plan, plan_ints, blocks, tok, n_past,
                 k_cache, v_cache, k_scale, v_scale, partial, cap, count,
                 stamps, logits, a))
    return -1;
  auto launch = [&](auto r) {
    return decode_step_t<decltype(r)>(a, blocks, stream);
  };
  if (w->dtype == BARK_BF16)
    return with_packed_read<bf16>(w->scale_dtype, w->has_min, launch);
  return with_packed_read<float>(w->scale_dtype, w->has_min, launch);
}

// K3/K4: `lp->n_steps` steps of bark_decode_step as ONE cooperative launch
// of the step loop (decode_steps_kernel), each sampling its token from the
// last logits inside the launch. logits holds the input logits (the
// prefill's or the last chunk's) and is left holding the last step's;
// plan must cover the sample window ([0, n_out_vocab) for codebook 0, [svs,
// svs + 2 cbs) for 1), which the kernel checks. The rest as
// bark_decode_step's, the token and the stamps aside (the loop's are in
// lp). Returns the launch's cudaError (0 on success), -1 for arguments it
// does not take; nothing falls back.
extern "C" int bark_decode_steps(const BarkGPTWeights* w,
                                 const void* const* tiles, const int* plan,
                                 int plan_ints, int blocks,
                                 const BarkStepLoop* lp, void* k_cache,
                                 void* v_cache, float* k_scale,
                                 float* v_scale, float* partial, int cap,
                                 unsigned* count, float* logits,
                                 cudaStream_t stream) {
  StepArgs<BarkGPTWeights> a;
  if (lp == nullptr ||
      !step_args(w, tiles, PH_N, plan, plan_ints, blocks, nullptr,
                 std::min(lp->n_past0, lp->clamp), k_cache, v_cache, k_scale,
                 v_scale, partial, cap, count, nullptr, logits, a) ||
      !loop_args(lp, blocks, a))
    return -1;
  if (w->dtype == BARK_BF16)
    return decode_step_t<DenseRead<bf16>>(a, blocks, stream, true);
  return decode_step_t<DenseRead<float>>(a, blocks, stream, true);
}

// K3/K4 on a qpack: bark_decode_steps on the packed read (the weights and
// tiles of bark_decode_step_packed).
extern "C" int bark_decode_steps_packed(
    const BarkGPTQWeights* w, const void* const* tiles, const int* plan,
    int plan_ints, int blocks, const BarkStepLoop* lp, void* k_cache,
    void* v_cache, float* k_scale, float* v_scale, float* partial, int cap,
    unsigned* count, float* logits, cudaStream_t stream) {
  StepArgs<BarkGPTQWeights> a;
  if (lp == nullptr || w->v_pad % TILE ||
      !step_args(w, tiles, PH_N + 1, plan, plan_ints, blocks, nullptr,
                 std::min(lp->n_past0, lp->clamp), k_cache, v_cache, k_scale,
                 v_scale, partial, cap, count, nullptr, logits, a) ||
      !loop_args(lp, blocks, a))
    return -1;
  auto launch = [&](auto r) {
    return decode_step_t<decltype(r)>(a, blocks, stream, true);
  };
  if (w->dtype == BARK_BF16)
    return with_packed_read<bf16>(w->scale_dtype, w->has_min, launch);
  return with_packed_read<float>(w->scale_dtype, w->has_min, launch);
}
