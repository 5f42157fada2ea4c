// K1: one token through all layers of a GPT stage, for batch 1, as ONE
// persistent kernel a step; K5, the same step on packed-quantized weights,
// as a weight-read policy of the same kernel; and K6, the int8 KV cache,
// inside both.
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
// The attention arithmetic (`attend_dense`, `attend_int8`) is shared with
// the standalone kernel that K7 and K5-batched launch a layer at a time
// (bark_launch_attn_decode_batched).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int HD = 64;             // head dim the attention takes
constexpr int ATT_THREADS = 1024;  // the standalone attention kernels
constexpr int LM_WARPS = 8;        // K2's LM head: one vocab row per warp

// the persistent step
constexpr int PS_THREADS = 512;
constexpr int PS_WARPS = PS_THREADS / 32;     // also the GEMV's row groups
constexpr int PS_KG = PS_THREADS / (HD / 8);  // key groups of its attention
constexpr int TILE = 64;       // output columns of a work item (step_plan's)
constexpr int QB = 32;         // rows of a packed weight's quant block
constexpr int RING_BYTES = 128 * 1024;
constexpr int PLAN_MAX = 8192;  // ints of the plan a block holds
constexpr int FOLD_BATCH = 24;  // partials of a column loaded at once
constexpr int VPT = 2;          // columns of x a thread holds: D <= 1024
constexpr int FOLD2_BATCH = 16;  // partials of each of those loaded at once
constexpr int MAX_SMEM = 227 * 1024;
constexpr float ATT_SCALE = 0.125f;  // 1 / sqrt(HD)

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

// ------------------------------------------------------------ attention

// The context at dim threadIdx.x (threads < HD) from the KG key groups'
// sums in part: each thread adds 8 groups of one dim (blockDim.x = 8 KG
// threads cover every (dim, 8 groups)), then threads < HD add those in
// order: a fixed order, two short steps in place of KG serial adds.
template <int KG>
__device__ __forceinline__ float sum_groups(float (*part)[HD + 1]) {
  __syncthreads();
  const int d = threadIdx.x % HD, c = threadIdx.x / HD;
  float s = 0.0f;
#pragma unroll
  for (int g = 0; g < 8; ++g) s += part[8 * c + g][d];
  __syncthreads();
  part[c][d] = s;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x < HD)
#pragma unroll
    for (int k = 0; k < KG / 8; ++k) t += part[k][threadIdx.x];
  return t;
}

// One head's attention for one query at slot n_past: rows 0..n_past-1 of
// the (S, D) cache slabs kc/vc (the head's column offset applied), row
// n_past from knew/vnew (the fresh row, f32 holding params-dtype values,
// in shared memory). Scores in f32, each thread whole key rows (16-byte
// loads); an f32 softmax; the weights rounded to T (the reference casts
// them to the V dtype); the context by groups of 8 threads, each reading
// one V row with 16-byte loads, the groups' sums added in a fixed order.
// Returns the context's f32 sum at dim threadIdx.x (threads < HD). KG is
// blockDim.x / 8; sc holds n_past + 1 floats.
template <typename T, int KG>
__device__ float attend_dense(const float* q, const float* knew,
                              const float* vnew, const T* kc, const T* vc,
                              int n_past, int D, float scale, float* sc,
                              float* red, float (*part)[HD + 1]) {
  const int n = n_past + 1;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float s = 0.0f;
    if (j < n_past) {
      const T* kr = kc + (size_t)j * D;
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float k8[8];
        load8(kr + d0, k8);
        for (int i = 0; i < 8; ++i) s = fmaf(q[d0 + i], k8[i], s);
      }
    } else {
      for (int d = 0; d < HD; ++d) s = fmaf(q[d], knew[d], s);
    }
    s *= scale;
    sc[j] = s;
    m = fmaxf(m, s);
  }
  m = block_max(m, red);
  float sum = 0.0f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    sc[j] = round_t<T>(sc[j] / sum);
  __syncthreads();
  // the group's cache rows in order, 4 loads in flight, then the fresh row
  // (the group's last when it has it)
  const int dg = (threadIdx.x % (HD / 8)) * 8, kg = threadIdx.x / (HD / 8);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int j = kg;
  for (; j + 3 * KG < n_past; j += 4 * KG) {
    float v8[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) load8(vc + (size_t)(j + u * KG) * D + dg, v8[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float p = sc[j + u * KG];
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, v8[u][i], acc[i]);
    }
  }
  for (; j < n_past; j += KG) {
    float v8[8];
    load8(vc + (size_t)j * D + dg, v8);
    const float p = sc[j];
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, v8[i], acc[i]);
  }
  if (j == n_past) {
    const float p = sc[j];
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vnew[dg + i], acc[i]);
  }
  for (int i = 0; i < 8; ++i) part[kg][dg + i] = acc[i];
  return sum_groups<KG>(part);
}

// K6a's query: q * scale (qv, threads < HD) quantized over the head into
// qw (16 words of 4 int8); returns its scale.
__device__ __forceinline__ float quant_query(float qv, int* qw, float* red) {
  const float sq = i8_scale(block_max(fabsf(qv), red));
  if (threadIdx.x < HD)
    reinterpret_cast<signed char*>(qw)[threadIdx.x] =
        quant_i8(qv, i8_inv(sq));
  __syncthreads();
  return sq;
}

// K6a: attend_dense on the int8 cache. Replaces the kv_quant branches of
// bark_tpu/kernels/decode.py (`_quant_row` :1045, `_quant_qseg` :1033,
// `_attend_lane(_scr)` :1055/:1109, :1603-1634 and :1937-1982), computing
// what the JAX package's XLA path computes (models/gpt.py `_kv_update`,
// `_attention_int8`): a key row's score is the exact integer dot of the
// int8 query qw (scale sq) with the int8 key (`__dp4a` over 16 words),
// then (score * sq) * s_k; the f32 softmax and weights rounded to T as the
// dense path; V rows dequantized as round_t<T>(q * s_v), the context summed
// with f32 FMAs. Rows 0..n_past-1 come from the cache (kc, vc with the
// head's offset; ks, vs the slab's row scales), row n_past from knew/vnew
// (16 words of int8 each) with the scales sk, sv.
template <typename T, int KG>
__device__ float attend_int8(const int* qw, float sq, const int* knew,
                             const int* vnew, float sk, float sv,
                             const signed char* kc, const signed char* vc,
                             const float* ks, const float* vs, int n_past,
                             int D, float* sc, float* red,
                             float (*part)[HD + 1]) {
  const int n = n_past + 1;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int acc = 0;
    if (j < n_past) {
      const int4* kr = reinterpret_cast<const int4*>(kc + (size_t)j * D);
#pragma unroll
      for (int w = 0; w < HD / 16; ++w) {
        const int4 u = kr[w];
        acc = __dp4a(u.x, qw[4 * w], acc);
        acc = __dp4a(u.y, qw[4 * w + 1], acc);
        acc = __dp4a(u.z, qw[4 * w + 2], acc);
        acc = __dp4a(u.w, qw[4 * w + 3], acc);
      }
    } else {
#pragma unroll
      for (int w = 0; w < HD / 4; ++w) acc = __dp4a(knew[w], qw[w], acc);
    }
    const float s = ((float)acc * sq) * (j == n_past ? sk : ks[j]);
    sc[j] = s;
    m = fmaxf(m, s);
  }
  m = block_max(m, red);
  float sum = 0.0f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    sc[j] = round_t<T>(sc[j] / sum);
  __syncthreads();
  // groups of 8 threads read one V row, 8 bytes a thread
  // (4 rows in flight, the fresh row last, as attend_dense)
  const int dg = (threadIdx.x % (HD / 8)) * 8, kg = threadIdx.x / (HD / 8);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  auto add_row = [&](int2 u, float s, float p) {
    const signed char* v8 = reinterpret_cast<const signed char*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[i] = fmaf(p, round_t<T>((float)v8[i] * s), acc[i]);
  };
  int j = kg;
  for (; j + 3 * KG < n_past; j += 4 * KG) {
    int2 u[4];
    float s[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      u[w] = *reinterpret_cast<const int2*>(vc + (size_t)(j + w * KG) * D +
                                            dg);
      s[w] = vs[j + w * KG];
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) add_row(u[w], s[w], sc[j + w * KG]);
  }
  for (; j < n_past; j += KG)
    add_row(*reinterpret_cast<const int2*>(vc + (size_t)j * D + dg), vs[j],
            sc[j]);
  if (j == n_past)
    add_row(*reinterpret_cast<const int2*>(
                reinterpret_cast<const signed char*>(vnew) + dg),
            sv, sc[j]);
  for (int i = 0; i < 8; ++i) part[kg][dg + i] = acc[i];
  return sum_groups<KG>(part);
}

// One block per (head, lane): lane b = blockIdx.y writes the fresh k/v row
// of this head into its (S, D) cache slab at slot n_past[b], then
// attend_dense (K7's and K5-batched's attention, a layer at a time; a slot
// outside the cache writes a NaN context and no cache row).
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

// ------------------------------------------------------------ weight reads

// How the persistent step reads its weights: the policy Step and
// decode_step_kernel are templated on. Each gives the params dtype T, the
// weight struct, the rows of a K-range unit of the plan (UNIT) and of a
// ring chunk (CH), a slot's bytes, where rows of a tile lie in the tiled
// copy, a thread's share of a chunk's product, and a wte value.

// Dense: the four projection weights tile-major in T, (L, N/64, K, 64)
// (`step_tiles`); the LM head (V, D) as the params hold it.
template <typename T_>
struct DenseRead {
  using T = T_;
  using Weights = BarkGPTWeights;
  static constexpr bool PACKED = false;
  static constexpr int UNIT = 8;
  static constexpr int CH = 128;
  static constexpr int SLOT = CH * TILE * (int)sizeof(T);

  // bytes from a tile's start to its row k, and of a tile of K rows
  __device__ static size_t row_at(int k) {
    return (size_t)k * TILE * sizeof(T);
  }
  __device__ static size_t tile_bytes(int K) { return row_at(K); }

  // thread (warp, lane) adds rows warp, warp + 16, ... of the chunk's
  // columns 2 lane, 2 lane + 1 against xin (the chunk's rows of vin)
  __device__ static void dot_chunk(const unsigned char* slot,
                                   const float* xin, int rows, float& a0,
                                   float& a1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const T* w = reinterpret_cast<const T*>(slot);
    if (rows == CH) {  // a whole chunk: every load first
      constexpr int R = CH / PS_WARPS;
      float w0[R], w1[R], xv[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        load2(w + (warp + k * PS_WARPS) * TILE + 2 * lane, w0[k], w1[k]);
        xv[k] = xin[warp + k * PS_WARPS];
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        a0 = fmaf(xv[k], w0[k], a0);
        a1 = fmaf(xv[k], w1[k], a1);
      }
    } else {
      for (int r = warp; r < rows; r += PS_WARPS) {
        float w0, w1;
        load2(w + r * TILE + 2 * lane, w0, w1);
        a0 = fmaf(xin[r], w0, a0);
        a1 = fmaf(xin[r], w1, a1);
      }
    }
  }

  // wte[tok][d] as f32
  __device__ static float embed(const Weights& w, int tok, int d, int D) {
    return to_f32(reinterpret_cast<const T*>(w.wte)[(size_t)tok * D + d]);
  }
};

// Packed (K5): each (L, K, N) weight of a qpack as records, (L, N/64,
// K/32, REC) bytes (`step_qtiles`): a record is one 32-row quant block of
// a 64-column tile, its 32 x 64 int8 values, then its 64 scales S, then,
// with HAS_MIN, its 64 mins; the LM head's transposed (D, v_pad) tile the
// same way, (v_pad/64, D/32, REC). So any run of whole quant blocks of a
// tile is one contiguous, 16-byte-aligned run, and a chunk is up to 8 of
// them (~16 KB of values).
template <typename T_, typename S, bool HAS_MIN>
struct PackedRead {
  using T = T_;
  using Weights = BarkGPTQWeights;
  static constexpr bool PACKED = true;
  static constexpr int UNIT = QB;
  static constexpr int CH = 8 * QB;
  static constexpr int REC =
      QB * TILE + TILE * (int)sizeof(S) * (HAS_MIN ? 2 : 1);
  static constexpr int SLOT = CH / QB * REC;
  static_assert(REC % 16 == 0, "a record must keep bulk copies aligned");

  __device__ static size_t row_at(int k) { return (size_t)(k / QB) * REC; }
  __device__ static size_t tile_bytes(int K) { return row_at(K); }

  __device__ static void load_s2(const unsigned char* p, float& a,
                                 float& b) {
    if constexpr (sizeof(S) == 2) {
      const float2 v =
          __half22float2(*reinterpret_cast<const __half2*>(p));
      a = v.x;
      b = v.y;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      a = v.x;
      b = v.y;
    }
  }

  // the two int8 values of a 16-bit word as exact floats, without the
  // conversion unit (a quarter of the FMA rate): each byte sign-extended
  // by shifts, added to the bits of 1.5 x 2^23 (whose ulp is 1), less
  // 1.5 x 2^23
  __device__ static void i8x2(unsigned short u, float& a, float& b) {
    a = __int_as_float(0x4B400000 + ((int)((unsigned)u << 24) >> 24)) -
        12582912.0f;
    b = __int_as_float(0x4B400000 + ((int)((unsigned)u << 16) >> 24)) -
        12582912.0f;
  }

  // round_t<T> of a pair (bf16: one packed conversion for both)
  __device__ static void round2(float& a, float& b) {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      a = __low2float(h);
      b = __high2float(h);
    }
  }

  // warp w takes rows [16 (w % 2), 16 (w % 2) + 16) of the chunk's record
  // w / 2 (rows / 32 of them), lane its columns 2 lane, 2 lane + 1: each
  // weight round_t<T>(q * s) in f32, FMA'd in f32 against x; with mins,
  // the half-block's sum of x times the block's min of each column (the
  // min term blocksums(x) @ m, summed by halves)
  __device__ static void dot_chunk(const unsigned char* slot,
                                   const float* xin, int rows, float& a0,
                                   float& a1) {
    constexpr int HALF = QB / 2;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp >= 2 * (rows / QB)) return;
    const unsigned char* rec = slot + (size_t)(warp >> 1) * REC;
    const int r0 = (warp & 1) * HALF;
    const unsigned char* q = rec + r0 * TILE + 2 * lane;
    const unsigned char* sp = rec + QB * TILE + 2 * lane * sizeof(S);
    float s0, s1;
    load_s2(sp, s0, s1);
    xin += (warp >> 1) * QB + r0;
    unsigned short v[HALF];
#pragma unroll
    for (int k = 0; k < HALF; ++k)
      v[k] = *reinterpret_cast<const unsigned short*>(q + k * TILE);
    float xs = 0.0f;
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const float x = xin[k];
      float w0, w1;
      i8x2(v[k], w0, w1);
      w0 = __fmul_rn(w0, s0);
      w1 = __fmul_rn(w1, s1);
      round2(w0, w1);
      a0 = fmaf(x, w0, a0);
      a1 = fmaf(x, w1, a1);
      if (HAS_MIN) xs += x;
    }
    if (HAS_MIN) {
      float m0, m1;
      load_s2(sp + TILE * sizeof(S), m0, m1);
      a0 = fmaf(xs, m0, a0);
      a1 = fmaf(xs, m1, a1);
    }
  }

  // the packed wte row's value d: round_t<T>(q * s [+ m]), in f32, as the
  // densified table holds it
  __device__ static float embed(const Weights& w, int tok, int d, int D) {
    const size_t sb = (size_t)tok * (D / QB) + d / QB;
    float v = __fmul_rn(
        (float)reinterpret_cast<const signed char*>(w.wte_q)[(size_t)tok * D +
                                                             d],
        s_to_f32(reinterpret_cast<const S*>(w.wte_s)[sb]));
    if (HAS_MIN)
      v = __fadd_rn(v, s_to_f32(reinterpret_cast<const S*>(w.wte_m)[sb]));
    return round_t<T>(v);
  }
};

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
};

// the most ring slots of any read (dense bf16: 16 KB slots)
constexpr int MAX_SLOTS = RING_BYTES / DenseRead<bf16>::SLOT;

// Shared memory (dynamic): the ring and its mbarriers, the plan, K6a's int8
// rows, f32 rows.
inline size_t step_smem(int D, int S) {
  const size_t words = PLAN_MAX + 3 * (HD / 4) + D + 4 * D + PS_WARPS * TILE +
                       S + PS_KG * (HD + 1) + 3 * HD + 32 + 64;
  return RING_BYTES + 8 * MAX_SLOTS + 4 * words;
}

// One block's view of the step: its shared memory, its chunk ring and the
// plan. Every member function is called by all threads of the block alike.
template <typename R>
struct Step {
  using T = typename R::T;
  static constexpr int SLOT = R::SLOT;
  static constexpr int NS = RING_BYTES / SLOT;      // ring slots
  static_assert(NS <= MAX_SLOTS, "the ring has mbarriers for MAX_SLOTS");

  const StepArgs<typename R::Weights>& a;
  int* plan;  // the plan, in shared memory
  int G, L, D, S, b, lm_rows;
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
    plan = reinterpret_cast<int*>(full + MAX_SLOTS);
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

  // the ring's mbarriers, and the plan table into shared memory (it is
  // read at every chunk and fold)
  __device__ void setup() {
    if (threadIdx.x == 0) {
      for (int i = 0; i < NS; ++i) mbar_init(&full[i], 1);
      mbar_fence_init();
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

  // The chunk at the producer's cursor (`bytes` from src), advancing the
  // cursor; false past the block's last.
  __device__ bool next_chunk(const void*& src, unsigned& bytes) {
    while (true) {
      if (c_layer == L) {
        const int v0 = pl(pl(PL_LM) + 2 * b), v1 = pl(pl(PL_LM) + 2 * b + 1);
        if constexpr (R::PACKED) {  // tiles [v0, v1), each over all D rows
          if (v0 + c_item >= v1) return false;
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
          if (v0 + c_row >= v1) return false;
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
  // alike; none waits on the copy's issue but thread 0).
  __device__ void top_up() {
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
    freed = i;
    top_up();
    return ring + (size_t)(i % NS) * SLOT;
  }

  // after a __syncthreads that follows the last use of the chunks taken
  // (a barrier's arrival)
  __device__ void release() {
    freed = taken;
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

  // x = wte[tok] + wpe[n_past] (NaN for a token outside the table; a
  // packed row dequantized as the densified table holds it); the
  // rows' loads go out ahead of the first weight chunks (`top_up`), which
  // the embed then waits behind no longer than its own loads take
  __device__ void embed_and_start_ring() {
    constexpr int MAX_PER = VPT;
    const int t = *a.tok;
    const bool ok = t >= 0 && t < a.w.n_in_vocab;
    const T* wpe = (const T*)a.w.wpe + (size_t)a.n_past * D;
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
    const int off = h * HD;
    float t;
    if (a.kv.ks == nullptr) {
      if (threadIdx.x < 3 * HD) {
        const int which = threadIdx.x / HD, d = threadIdx.x - which * HD;
        const float v = proj_out(PH_QKV, which * D + off + d, bias);
        (which == 0 ? qs : which == 1 ? kn : vn)[d] = v;
        if (writes && which > 0) {
          T* c = (T*)(which == 1 ? a.kv.k : a.kv.v);
          c[(slab + a.n_past) * D + off + d] = from_f32<T>(v);
        }
      }
      __syncthreads();
      t = attend_dense<T, PS_KG>(qs, kn, vn, (const T*)a.kv.k + slab * D + off,
                                 (const T*)a.kv.v + slab * D + off, a.n_past,
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
          kc[(size_t)a.n_past * D + d] = k8;
          vc[(size_t)a.n_past * D + d] = v8;
        }
      }
      if (scales && threadIdx.x == 0) {
        a.kv.ks[slab + a.n_past] = sk;
        a.kv.vs[slab + a.n_past] = sv;
      }
      const float qv = threadIdx.x < HD ? qs[threadIdx.x] * ATT_SCALE : 0.0f;
      const float sq = quant_query(qv, qw, red);
      t = attend_int8<T, PS_KG>(qw, sq, kq, vq, sk, sv, kc, vc,
                                a.kv.ks + slab, a.kv.vs + slab, a.n_past, D,
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
        for (int j = threadIdx.x; j < a.n_past; j += PS_THREADS)
          for (size_t o = 0; o < HD * re; o += 128) {
            prefetch_l2((const char*)a.kv.k + base + j * D * re + o);
            prefetch_l2((const char*)a.kv.v + base + j * D * re + o);
          }
      }
      if (q8) {
        prefetch(a.kv.ks + (size_t)l * S, a.n_past * sizeof(float));
        prefetch(a.kv.vs + (size_t)l * S, a.n_past * sizeof(float));
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

template <typename R>
__global__ void __launch_bounds__(PS_THREADS, 1)
    decode_step_kernel(const __grid_constant__ StepArgs<typename R::Weights> a) {
  using T = typename R::T;
  extern __shared__ __align__(128) unsigned char smem[];
  Step<R> s(a, smem);
  s.stamp(0);
  s.setup();
  const int n_barriers = s.pl(PL_BARRIERS);
  if (s.pl(PL_BLOCKS) != (int)gridDim.x || n_barriers != PH_N * s.L ||
      s.pl(PL_LAYERS) != s.L || s.pl(PL_LM_TILES) != (int)R::PACKED)
    __trap();  // a plan for another grid, stage or read: fail the launch
  s.embed_and_start_ring();
  s.stamp(1);
  int k = 0;
  for (int l = 0; l < s.L; ++l) {
    s.residual_ln(PH_OUT,
                  l > 0 ? (const T*)a.w.out_b + (size_t)(l - 1) * s.D
                        : nullptr,
                  (const T*)a.w.ln1_g + (size_t)l * s.D,
                  (const T*)a.w.ln1_b + (size_t)l * s.D);
    s.gemv_phase(PH_QKV);
    s.barrier(++k, l, PH_QKV);
    s.attention_proj_phase(l);
    s.barrier(++k, l, PH_PROJ);
    s.fc_phase(l);
    s.barrier(++k, l, PH_FC);
    s.out_phase(l);
    s.barrier(++k, l, PH_OUT);
  }
  s.lm_phase();
  s.stamp(2 * n_barriers + 2);
  s.leave(n_barriers);
}

// The co-resident block count of the step's kernel on read R for rows of D
// values and S cache slots (its grid), or a negative cudaError / -1 for a
// shape it does not take.
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
  if (!err)
    err = (int)cudaFuncSetAttribute(
        decode_step_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_step_kernel<R>, PS_THREADS, smem);
  if (err) return -err;
  return coop ? per_sm * sms : -1;
}

template <typename R>
int decode_step_t(const StepArgs<typename R::Weights>& a, int blocks,
                  cudaStream_t st) {
  const size_t smem = step_smem(a.w.n_embd, a.w.block_size);
  void* args[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel((const void*)decode_step_kernel<R>,
                                          dim3(blocks), dim3(PS_THREADS),
                                          args, smem, st);
}

// f(PackedRead<T, S, HAS_MIN>{}) for a qpack's scale dtype (BARK_F16 or
// BARK_F32) and mins; -1 for another scale dtype
template <typename T, typename F>
int with_packed_read(int scale_dtype, int has_min, F&& f) {
  if (scale_dtype == BARK_F16)
    return has_min ? f(PackedRead<T, __half, true>{})
                   : f(PackedRead<T, __half, false>{});
  if (scale_dtype == BARK_F32)
    return has_min ? f(PackedRead<T, float, true>{})
                   : f(PackedRead<T, float, false>{});
  return -1;
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
