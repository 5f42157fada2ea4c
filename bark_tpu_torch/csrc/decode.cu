// K1: one token through all layers of a GPT stage, for batch 1, as ONE
// persistent kernel a step (and K6, the int8 KV cache, inside it).
//
// Replaces bark_tpu/kernels/decode.py `decode_step_fused` (:2392, its one
// pallas_call at :2536; body `_decode_kernel` :1428, layer loop
// `_dense_layer_stack` :1339, attention `_attend_lane` :1109): embed ->
// L x [LN1 -> fused QKV -> K/V row written at n_past -> attention over rows
// <= n_past -> proj + residual -> LN2 -> fc -> tanh-GELU -> out + residual]
// -> ln_f -> LM head over [lo, hi).
//
// What bounds it on an H100: bytes, and barriers. A step streams every
// weight once (bark-small: ~85 M values a stage, 170 MB in bf16) plus the
// live cache rows, 197 MB at n_past 300 (0.0587 ms at 3.35 TB/s), with 2
// FLOPs a weight, far below the card's ridge. Each dependent phase then
// costs a grid-wide barrier (1.53 us, probes/lowering.py P1), and a step
// has 4 a layer: 48 for bark-small, ~73 us, more than the stream itself.
//
// What the design does about it (one cooperative launch a step, the grid
// the card's co-resident block count, the layer loop inside):
// - The work is laid out by the host (kernels/decode.py `step_plan`, an
//   int32 table each block copies into shared memory): for each phase,
//   which block takes which (64-column tile, 8-row-aligned K range) of the
//   weight, balanced in bytes, and the fixed order in which each column's
//   split-K partials are folded. The kernel takes the table as it is.
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
//   then its LM rows) through a 128 KB ring of shared-memory slots, one
//   bulk copy a chunk issued by one thread and completing on the slot's
//   mbarrier, so the next phases' tiles are in flight across barriers and
//   across the attention. A chunk is contiguous because the wrapper keeps
//   the four projection weights tile-major (`step_tiles`). (Measured
//   against it on an H100 at 700 W, chip_smoke.py's K1 record, the step
//   at n_past 300: 16-byte cp.async issued by all 512 threads 0.506 ms
//   against 0.408 with bulk copies; 2-D TMA boxes of tensor maps over the
//   row-major weights, no copy, 0.515-0.520 against 0.359-0.361.)
// - The barrier is split: a block arrives, then refills its ring and hints
//   the next phase's biases, LN affines and (after QKV) its heads' cache
//   rows into the L2 (prefetch.global.L2) while it waits.
// - Everything the kernel writes and reads back (partials) is read with
//   coherent L2 loads (__ldcg), each fold's loads in flight together; the
//   caches, the token and the int8 scales with plain loads, never
//   ld.global.nc.
// - The barrier count lives in the step's scratch; the last block out
//   resets it, so steps queue with no host work between them.
// - `stamps` (null when serving) takes block 0's %globaltimer at the start,
//   after the embed, at each barrier's arrival and release, and at the end.
//
// The attention arithmetic (`attend_dense`, `attend_int8`) is shared with
// the standalone kernels that K5 and K7 launch a layer at a time
// (bark_launch_attn_decode, bark_launch_attn_decode_batched).
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
constexpr int CH_ROWS = 128;   // weight rows of a ring slot
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
// indices, each tile's in K order), then the LM rows (2 ints a block)
enum {
  PL_BLOCKS = 0, PL_BARRIERS = 1, PL_ITEMS = 2, PL_STARTS = 6,
  PL_FOLD_OFF = 10, PL_FOLD = 14, PL_LM = 18, PL_LO = 19, PL_HI = 20,
  PL_LAYERS = 21
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

// One block per (head, lane): write the fresh k/v row of this head into
// the cache at n_past, then attend_dense. K5 launches one lane at the slot
// `n_past`; K7 launches lane b = blockIdx.y on its (S, D) slab at slot
// n_past_dev[b] (a slot outside the cache writes a NaN context and no
// cache row).
template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
    attn_decode_kernel(const T* __restrict__ qkv, T* kc, T* vc, int n_past,
                       const int* __restrict__ n_past_dev, int S, int D,
                       float scale, T* __restrict__ ctx) {
  constexpr int KG = ATT_THREADS / (HD / 8);
  extern __shared__ float sc[];  // n_past + 1 scores
  __shared__ float q[HD], kn[HD], vn[HD];
  __shared__ float red[32];
  __shared__ float part[KG][HD + 1];
  const int off = blockIdx.x * HD;
  if (n_past_dev != nullptr) {
    const int b = blockIdx.y;
    n_past = n_past_dev[b];
    qkv += (size_t)b * 3 * D;
    kc += (size_t)b * S * D;
    vc += (size_t)b * S * D;
    ctx += (size_t)b * D;
    if (n_past < 0 || n_past >= S) {
      for (int d = threadIdx.x; d < HD; d += blockDim.x)
        ctx[off + d] = from_f32<T>(NAN);
      return;
    }
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
                          signed char* vc, float* ks, float* vs, int n_past,
                          const int* __restrict__ n_past_dev, int S, int D,
                          float scale, T* __restrict__ ctx) {
  constexpr int KG = ATT_THREADS / (HD / 8);
  extern __shared__ float sc[];  // n_past + 1 scores
  __shared__ int qw[HD / 4], kq[HD / 4], vq[HD / 4];
  __shared__ float red[32];
  __shared__ float part[KG][HD + 1];
  const int off = blockIdx.x * HD;
  if (n_past_dev != nullptr) {
    const int b = blockIdx.y;
    n_past = n_past_dev[b];
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
int attn_decode_t(const T* qkv, BarkKV kv, int n_past, const int* n_past_dev,
                  int B, int S, int D, int n_head, T* ctx, cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)(D / n_head)));
  const int rows = n_past_dev != nullptr ? S : n_past + 1;
  const dim3 grid(n_head, B);
  const size_t smem = rows * sizeof(float);
  if (kv.ks != nullptr)
    attn_decode_i8_kernel<T><<<grid, ATT_THREADS, smem, st>>>(
        qkv, (signed char*)kv.k, (signed char*)kv.v, kv.ks, kv.vs, n_past,
        n_past_dev, S, D, scale, ctx);
  else
    attn_decode_kernel<T><<<grid, ATT_THREADS, smem, st>>>(
        qkv, (T*)kv.k, (T*)kv.v, n_past, n_past_dev, S, D, scale, ctx);
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

struct StepArgs {
  BarkGPTWeights w;
  // each phase's (L, K, N) weight tile-major, (L, N / 64, K, 64): a chunk of
  // a tile's rows is one contiguous run of bytes
  const void* tiles[PH_N];
  const int* plan;     // the step_plan table
  const int* tok;      // the token, in device memory
  BarkKV kv;           // the stage's (L, S, D) caches (int8 with scales)
  float* partial;      // two buffers of `cap` floats
  unsigned* count;     // the grid barrier's count: 0, left 0
  unsigned long long* stamps;  // 2 * barriers + 3 of them, or null
  float* logits;       // (n_out_vocab,)
  int n_past, cap, plan_ints;
};

constexpr int MAX_SLOTS = RING_BYTES / (CH_ROWS * TILE * 2);

// Shared memory (dynamic): the ring and its mbarriers, the plan, K6a's int8
// rows, f32 rows.
inline size_t step_smem(int D, int S) {
  const size_t words = PLAN_MAX + 3 * (HD / 4) + D + 4 * D + PS_WARPS * TILE +
                       S + PS_KG * (HD + 1) + 3 * HD + 32 + 64;
  return RING_BYTES + 8 * MAX_SLOTS + 4 * words;
}

// One block's view of the step: its shared memory, its chunk ring and the
// plan. Every member function is called by all threads of the block alike.
template <typename T>
struct Step {
  static constexpr int SLOT = CH_ROWS * TILE * (int)sizeof(T);
  static constexpr int NS = RING_BYTES / SLOT;      // ring slots

  const StepArgs& a;
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
  // the producer's cursor: layer (L: the LM rows), phase, item, row
  int c_layer, c_phase, c_item, c_row;

  __device__ Step(const StepArgs& args, unsigned char* smem)
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

  // phase p's tile-major weight of layer l, and its K
  __device__ const T* tiles(int p, int l, int& K) const {
    const int N = p == PH_QKV ? 3 * D : p == PH_FC ? 4 * D : D;
    K = p == PH_OUT ? 4 * D : D;
    return (const T*)a.tiles[p] + (size_t)l * K * N;
  }

  // The chunk at the producer's cursor (`bytes` from src), advancing the
  // cursor; false past the block's last.
  __device__ bool next_chunk(const T*& src, unsigned& bytes) {
    while (true) {
      if (c_layer == L) {
        const int v0 = pl(pl(PL_LM) + 2 * b), v1 = pl(pl(PL_LM) + 2 * b + 1);
        if (v0 + c_row >= v1) return false;
        const int rows = min(lm_rows, v1 - v0 - c_row);
        src = (const T*)a.w.lm_head + (size_t)(v0 + c_row) * D;
        bytes = rows * D * sizeof(T);
        c_row += rows;
        return true;
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
      const T* W = tiles(c_phase, c_layer, K);
      const int rows = min(CH_ROWS, k1 - k0 - c_row);
      src = W + ((size_t)tile * K + k0 + c_row) * TILE;
      bytes = rows * TILE * sizeof(T);
      c_row += rows;
      return true;
    }
  }

  // Fill the free slots: one bulk copy a chunk, issued by thread 0, its
  // bytes completing on the slot's mbarrier (every thread walks the cursor
  // alike; none waits on the copy's issue but thread 0).
  __device__ void top_up() {
    while (issued < freed + NS) {
      const T* src;
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
  __device__ const T* take() {
    const int i = taken++;
    mbar_wait(&full[i % NS], (i / NS) & 1);
    __syncthreads();
    freed = i;
    top_up();
    return reinterpret_cast<const T*>(ring + (size_t)(i % NS) * SLOT);
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

  // x = wte[tok] + wpe[n_past] (NaN for a token outside the table); the
  // rows' loads go out ahead of the first weight chunks (`top_up`), which
  // the embed then waits behind no longer than its own loads take
  __device__ void embed_and_start_ring() {
    constexpr int MAX_PER = VPT;
    const int t = *a.tok;
    const bool ok = t >= 0 && t < a.w.n_in_vocab;
    const T* wte = (const T*)a.w.wte + (size_t)(ok ? t : 0) * D;
    const T* wpe = (const T*)a.w.wpe + (size_t)a.n_past * D;
    float e[MAX_PER], q[MAX_PER];
#pragma unroll
    for (int u = 0; u < MAX_PER; ++u) {
      const int d = threadIdx.x + u * PS_THREADS;
      if (d < D) {
        e[u] = to_f32(wte[d]);
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

  // Item i of phase p: its tile's rows [k0, k1) against vin[k0:k1], in
  // ring chunks; thread (warp, lane) sums rows warp, warp + 16, ... of
  // columns 2 lane, 2 lane + 1; the 16 row groups are added in order into
  // the item's partial (row i of the phase's buffer).
  __device__ void gemv_item(int p, int i) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int tile, k0, k1, flags;
    item(p, i, tile, k0, k1, flags);
    float a0 = 0.0f, a1 = 0.0f;
    for (int r0 = k0; r0 < k1; r0 += CH_ROWS) {
      const T* w = take();
      const int rows = min(CH_ROWS, k1 - r0);
      const float* xin = vin + r0;
      if (rows == CH_ROWS) {  // a whole chunk: every load first
        constexpr int R = CH_ROWS / PS_WARPS;
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
    red2[warp * TILE + 2 * lane] = a0;
    red2[warp * TILE + 2 * lane + 1] = a1;
    __syncthreads();
    if (threadIdx.x < TILE) {
      float s = 0.0f;
      for (int g = 0; g < PS_WARPS; ++g) s += red2[g * TILE + threadIdx.x];
      __stcg(buf(p) + (size_t)i * TILE + threadIdx.x, s);
    }
    __syncthreads();
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
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int v0 = pl(pl(PL_LM) + 2 * b), v1 = pl(pl(PL_LM) + 2 * b + 1);
    for (int r0 = v0; r0 < v1; r0 += lm_rows) {
      const T* w = take();
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
    const int lo = pl(PL_LO), hi = pl(PL_HI);
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

  __device__ void stamp(int k) const {
    if (a.stamps != nullptr && b == 0) {
      __syncthreads();
      if (threadIdx.x == 0) a.stamps[k] = global_ns();
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

template <typename T>
__global__ void __launch_bounds__(PS_THREADS, 1)
    decode_step_kernel(const __grid_constant__ StepArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Step<T> s(a, smem);
  s.stamp(0);
  s.setup();
  const int n_barriers = s.pl(PL_BARRIERS);
  if (s.pl(PL_BLOCKS) != (int)gridDim.x || n_barriers != PH_N * s.L ||
      s.pl(PL_LAYERS) != s.L)
    __trap();  // a plan for another grid or stage: fail the launch
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

// The co-resident block count of the step's kernel for rows of D values and
// S cache slots (its grid), or a negative cudaError / -1 for a shape it
// does not take.
template <typename T>
int step_blocks_t(int D, int S) {
  const size_t smem = step_smem(D, S);
  if (smem > MAX_SMEM || D * (int)sizeof(T) > Step<T>::SLOT ||
      D > VPT * PS_THREADS)
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
        decode_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_step_kernel<T>, PS_THREADS, smem);
  if (err) return -err;
  return coop ? per_sm * sms : -1;
}

template <typename T>
int decode_step_t(const StepArgs& a, int blocks, cudaStream_t st) {
  const size_t smem = step_smem(a.w.n_embd, a.w.block_size);
  void* args[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel((const void*)decode_step_kernel<T>,
                                          dim3(blocks), dim3(PS_THREADS),
                                          args, smem, st);
}

}  // namespace

extern "C" int bark_launch_attn_decode(int dtype, const void* qkv, BarkKV kv,
                                       int n_past, int D, int n_head,
                                       void* ctx, cudaStream_t stream) {
  if (dtype == BARK_BF16)
    return attn_decode_t<bf16>((const bf16*)qkv, kv, n_past, nullptr, 1, 0,
                               D, n_head, (bf16*)ctx, stream);
  return attn_decode_t<float>((const float*)qkv, kv, n_past, nullptr, 1, 0,
                              D, n_head, (float*)ctx, stream);
}

extern "C" int bark_launch_attn_decode_batched(int dtype, const void* qkv,
                                               BarkKV kv, const int* n_past,
                                               int B, int S, int D,
                                               int n_head, void* ctx,
                                               cudaStream_t stream) {
  if (dtype == BARK_BF16)
    return attn_decode_t<bf16>((const bf16*)qkv, kv, 0, n_past, B, S, D,
                               n_head, (bf16*)ctx, stream);
  return attn_decode_t<float>((const float*)qkv, kv, 0, n_past, B, S, D,
                              n_head, (float*)ctx, stream);
}

extern "C" int bark_launch_lm_head(const BarkGPTWeights* w, const void* x_row,
                                   float* logits, int lo, int hi,
                                   cudaStream_t stream) {
  if (w->dtype == BARK_BF16)
    return lm_head_t<bf16>(w, x_row, logits, lo, hi, stream);
  return lm_head_t<float>(w, x_row, logits, lo, hi, stream);
}

// The grid of bark_decode_step for a stage of params dtype `dtype`, width
// D and S cache slots: the blocks of its kernel the card holds at once
// (sets the kernel's shared-memory limit). Negative: a cudaError negated,
// or -1 for a shape it does not take or a card without cooperative
// launches.
extern "C" int bark_decode_step_blocks(int dtype, int D, int S) {
  if (dtype == BARK_BF16) return step_blocks_t<bf16>(D, S);
  return step_blocks_t<float>(D, S);
}

// One decode step as one cooperative launch of `blocks` blocks (the grid of
// bark_decode_step_blocks, which `plan`, plan_ints <= 8192 ints, was made
// for). tiles: the four projection weights of the stage (qkv, proj, fc,
// out) laid out tile-major, (L, N / 64, K, 64), 16-byte aligned. k_cache and v_cache
// are the stage's (L, S, D) caches, in the params dtype when k_scale and
// v_scale are null, else int8 with those (L, S) f32 row scales (K6a);
// partial is two buffers of `cap` f32 (cap >= 64 x the plan's most items
// in a phase), count one zeroed uint32 (left zeroed); stamps null, or
// 2 x barriers + 3 uint64; logits is (n_out_vocab,) f32, zero outside the
// plan's [lo, hi). Returns the launch's cudaError (0 on success), -1 for
// arguments it does not take; nothing falls back.
extern "C" int bark_decode_step(const BarkGPTWeights* w,
                                const void* const* tiles, const int* plan,
                                int plan_ints, int blocks, const int* tok,
                                int n_past,
                                void* k_cache, void* v_cache, float* k_scale,
                                float* v_scale, float* partial, int cap,
                                unsigned* count,
                                unsigned long long* stamps, float* logits,
                                cudaStream_t stream) {
  if (w->n_embd / w->n_head != HD || w->n_embd % TILE || blocks < 1 ||
      plan_ints < 1 || plan_ints > PLAN_MAX || n_past < 0 ||
      n_past >= w->block_size ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return -1;
  const StepArgs a{*w,
                   {tiles[0], tiles[1], tiles[2], tiles[3]},
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
  if (w->dtype == BARK_BF16) return decode_step_t<bf16>(a, blocks, stream);
  return decode_step_t<float>(a, blocks, stream);
}
