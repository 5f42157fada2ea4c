// K1: one token through all layers of a GPT stage, for batch 1.
//
// Replaces bark_tpu/kernels/decode.py `decode_step_fused` (the Pallas
// kernel `_decode_kernel`, layer math `_dense_layer_stack`, attention
// `_attend_lane`): embed -> L x [LN1 -> fused QKV -> K/V row written at
// n_past -> attention over rows <= n_past -> proj + residual -> LN2 -> fc
// -> tanh-GELU -> out + residual] -> ln_f -> LM head over [lo, hi).
//
// What bounds it: at batch 1 every step streams every weight once (about
// 85 M values per bark-small stage, 170 MB in bf16) plus the live cache
// rows, and does 2 FLOPs per weight, far below the card's ~295 FLOP/byte
// ridge: the step is bound by device-memory bandwidth, and at this size by
// launch latency as much.
//
// What the design does about it: the projections are GEMVs whose threads
// own output columns of the row-major (K, N) weight, so a warp reads 64
// neighbouring columns of one weight row (256 contiguous bytes in bf16)
// per load. To keep enough loads in flight to approach the bandwidth, each
// GEMV is split over K across ~2 blocks per SM; the last block of each
// column tile sums the partials in a fixed order (deterministic results)
// and applies the epilogue. LayerNorm statistics are recomputed by every
// block of the GEMV that consumes them, so LN costs no launch and no round
// trip through device memory. Weights are used in their load-time layout;
// nothing is laid out per step. One C call launches the whole step (5
// kernels a layer, plus embed and LM head), so the host pays one ctypes
// call per token. Not yet done: CUDA graphs, a persistent kernel, a
// split-K attention, wgmma/TMA.
//
// With an int8 cache (K6) the attention of every layer is K6a,
// `attn_decode_i8_kernel` below, also for K5 and K7 (through
// bark_launch_attn_decode and bark_launch_attn_decode_batched).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int HD = 64;            // head dim the attention kernels take
constexpr int GEMV_COLS = 64;     // output columns per block, 2 per lane
constexpr int GEMV_WARPS = 8;     // a block's K rows are split over its warps
constexpr int GEMV_THREADS = GEMV_WARPS * 32;
constexpr int GEMV_TARGET_BLOCKS = 264;  // ~2 per SM of an H100 (132 SMs)
constexpr size_t GEMV_PARTIAL_CAP = 1 << 16;  // f32 partials of one GEMV
constexpr int GEMV_TICKETS = 1024;  // column tiles of one GEMV
constexpr int ATT_THREADS = 1024;  // a multiple of HD; 2-4% faster than 256
constexpr int LM_WARPS = 8;       // one vocab row per warp

enum { EPI_PLAIN = 0, EPI_GELU = 1, EPI_RESID = 2 };

// out = epilogue(round(in @ W) + bias), in = LN(x) when LN else x.
// x: (K,), W: (K, N) row-major, out/resid: (N,). resid may alias out.
//
// Split over K across blocks: block (tile, split) sums rows
// [split*R, split*R + R) for the tile's 64 columns and stores the f32
// partials; the last block of a tile to finish (an atomic ticket) sums the
// gridDim.y partials in split order, so the result does not depend on
// which block finishes last, applies the epilogue, and re-arms the
// tile's ticket for the next launch.
template <typename T, int EPI, bool LN>
__global__ void __launch_bounds__(GEMV_THREADS)
    gemv_kernel(const T* __restrict__ x, const T* __restrict__ ln_g,
                const T* __restrict__ ln_b, const T* __restrict__ W,
                const T* __restrict__ bias, int K, int N, int R,
                const T* resid, T* out, float* partial,
                unsigned int* tickets) {
  extern __shared__ float xs[];  // R floats: this split's input rows
  __shared__ float red[32];
  __shared__ float part[GEMV_WARPS][GEMV_COLS];
  __shared__ bool last;
  const int k0 = blockIdx.y * R, rows = min(R, K - k0);
  if (LN) {
    // LayerNorm statistics over the whole row, applied to this split's rows
    float s = 0.0f;
    for (int i = threadIdx.x; i < K; i += blockDim.x) s += to_f32(x[i]);
    const float mean = block_sum(s, red) / (float)K;
    float sq = 0.0f;
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      const float d = to_f32(x[i]) - mean;
      sq += d * d;
    }
    const float inv = 1.0f / sqrtf(block_sum(sq, red) / (float)K +
                                   BARK_EPS_NORM);
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const float y = (to_f32(x[k0 + i]) - mean) * inv;
      xs[i] = round_t<T>(y * to_f32(ln_g[k0 + i]) + to_f32(ln_b[k0 + i]));
    }
  } else {
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      xs[i] = to_f32(x[k0 + i]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * GEMV_COLS + 2 * lane;
  float a0 = 0.0f, a1 = 0.0f;
  if (c < N) {  // N is even, so c + 1 < N too
    const T* wp = W + (size_t)k0 * N + c;
    int k = warp;
    for (; k + 3 * GEMV_WARPS < rows; k += 4 * GEMV_WARPS) {
      float w0, w1, w2, w3, w4, w5, w6, w7;
      load2(wp + (size_t)k * N, w0, w1);
      load2(wp + (size_t)(k + GEMV_WARPS) * N, w2, w3);
      load2(wp + (size_t)(k + 2 * GEMV_WARPS) * N, w4, w5);
      load2(wp + (size_t)(k + 3 * GEMV_WARPS) * N, w6, w7);
      const float x0 = xs[k], x1 = xs[k + GEMV_WARPS];
      const float x2 = xs[k + 2 * GEMV_WARPS], x3 = xs[k + 3 * GEMV_WARPS];
      a0 = fmaf(x0, w0, a0);
      a1 = fmaf(x0, w1, a1);
      a0 = fmaf(x1, w2, a0);
      a1 = fmaf(x1, w3, a1);
      a0 = fmaf(x2, w4, a0);
      a1 = fmaf(x2, w5, a1);
      a0 = fmaf(x3, w6, a0);
      a1 = fmaf(x3, w7, a1);
    }
    for (; k < rows; k += GEMV_WARPS) {
      float w0, w1;
      load2(wp + (size_t)k * N, w0, w1);
      a0 = fmaf(xs[k], w0, a0);
      a1 = fmaf(xs[k], w1, a1);
    }
  }
  part[warp][2 * lane] = a0;
  part[warp][2 * lane + 1] = a1;
  __syncthreads();
  const int n = blockIdx.x * GEMV_COLS + threadIdx.x;
  if (threadIdx.x < GEMV_COLS && n < N) {
    float acc = 0.0f;
    for (int w = 0; w < GEMV_WARPS; ++w) acc += part[w][threadIdx.x];
    partial[(size_t)blockIdx.y * N + n] = acc;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x < GEMV_COLS && n < N) {
    float acc = 0.0f;
    for (int sp = 0; sp < (int)gridDim.y; ++sp)
      acc += __ldcg(partial + (size_t)sp * N + n);
    float v = round_t<T>(acc);
    v = round_t<T>(v + to_f32(bias[n]));
    if (EPI == EPI_GELU) v = round_t<T>(gelu_tanh(v));
    if (EPI == EPI_RESID) v = round_t<T>(to_f32(resid[n]) + v);
    out[n] = from_f32<T>(v);
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

// Launch one GEMV with enough (tile, split) blocks to keep the card's
// memory pipes full: ~2 blocks per SM, splits of a multiple of 8 rows.
template <typename T, int EPI, bool LN>
int gemv(const T* x, const T* ln_g, const T* ln_b, const T* W,
         const T* bias, int K, int N, const T* resid, T* out,
         float* partial, unsigned int* tickets, cudaStream_t st) {
  const int tiles = (N + GEMV_COLS - 1) / GEMV_COLS;
  int splits = (GEMV_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, K / GEMV_WARPS));
  int R = (K + splits - 1) / splits;
  R = (R + GEMV_WARPS - 1) / GEMV_WARPS * GEMV_WARPS;
  splits = (K + R - 1) / R;
  if ((size_t)splits * N > GEMV_PARTIAL_CAP || tiles > GEMV_TICKETS) return -1;
  gemv_kernel<T, EPI, LN><<<dim3(tiles, splits), GEMV_THREADS,
                            R * sizeof(float), st>>>(
      x, ln_g, ln_b, W, bias, K, N, R, resid, out, partial, tickets);
  return (int)cudaGetLastError();
}

// One block per (head, lane): write the fresh k/v row of this head into
// the cache at n_past, then scores over rows 0..n_past in shared memory, an
// f32 softmax, the weights rounded to T (the reference casts them to the V
// dtype), and the context. Each thread scores whole key rows (16-byte
// loads, many rows in flight); for the context, groups of 8 threads each
// read one V row with 16-byte loads, and the groups' partial sums are
// added in a fixed order. The caches are read with coherent loads: the
// block reads back the row it has just written. K1 launches one lane at
// the slot `n_past`; K7 launches lane b = blockIdx.y on its (S, D) slab at
// slot n_past_dev[b] (a slot outside the cache writes a NaN context and no
// cache row).
template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
    attn_decode_kernel(const T* __restrict__ qkv, T* kc, T* vc, int n_past,
                       const int* __restrict__ n_past_dev, int S, int D,
                       float scale, T* __restrict__ ctx) {
  constexpr int KG = ATT_THREADS / (HD / 8);  // key groups of the V pass
  extern __shared__ float sc[];  // n_past + 1 scores
  __shared__ float q[HD];
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
  T* krow = kc + (size_t)n_past * D + off;
  T* vrow = vc + (size_t)n_past * D + off;
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    krow[d] = qkv[D + off + d];
    vrow[d] = qkv[2 * D + off + d];
    q[d] = to_f32(qkv[off + d]);
  }
  __syncthreads();
  const int n = n_past + 1;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const T* kr = kc + (size_t)j * D + off;
    float s = 0.0f;
    for (int d0 = 0; d0 < HD; d0 += 8) {
      float k8[8];
      load8(kr + d0, k8);
      for (int i = 0; i < 8; ++i) s = fmaf(q[d0 + i], k8[i], s);
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
  const int dg = (threadIdx.x % (HD / 8)) * 8, kg = threadIdx.x / (HD / 8);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = kg; j < n; j += KG) {
    float v8[8];
    load8(vc + (size_t)j * D + off + dg, v8);
    const float p = sc[j];
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, v8[i], acc[i]);
  }
  for (int i = 0; i < 8; ++i) part[kg][dg + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < HD) {
    float t = 0.0f;
    for (int g = 0; g < KG; ++g) t += part[g][threadIdx.x];
    ctx[off + threadIdx.x] = from_f32<T>(t);
  }
}

// K6a: attn_decode_kernel on the int8 cache (int8 (S, D) slabs with f32
// row scales). Replaces the kv_quant branches of bark_tpu/kernels/
// decode.py (`_quant_row` :1045, `_quant_qseg` :1033, `_attend_lane(_scr)`
// :1055/:1109, :1603-1634 and :1937-1982), computing what the JAX
// package's XLA path computes (models/gpt.py `_kv_update`,
// `_attention_int8`), in its order:
//  (i) the fresh K and V rows (params dtype, in qkv) get their row scales
//      from the amax over all D, which every head's block computes alike
//      (a max is exact in any order), so no block waits on another; a
//      block writes its head's 64 int8 values of each row at slot n_past,
//      the head-0 block the two scales, and each block scores the fresh
//      row with its own copy of the scales, never reading the slot's
//      scale another block writes;
// (ii) q * (1/sqrt(64)) is quantized over the head's 64 dims;
// (iii) a key row's score is the exact integer dot of the two int8
//      vectors (__dp4a over 16 words), then (score * s_q) * s_k;
// (iv) the f32 softmax, weights rounded to T, as the dense kernel;
//  (v) V rows dequantized as round_t<T>(q * s_v), the context summed with
//      f32 FMAs.
// What bounds it: the cache bytes, half the bf16 kernel's (a quarter of
// the f32 one's) plus 4 bytes of scale a row; one launch a layer, as the
// dense kernel (an extra quantize launch would cost ~6 us a layer at this
// latency-bound step).
template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
    attn_decode_i8_kernel(const T* __restrict__ qkv, signed char* kc,
                          signed char* vc, float* ks, float* vs, int n_past,
                          const int* __restrict__ n_past_dev, int S, int D,
                          float scale, T* __restrict__ ctx) {
  constexpr int KG = ATT_THREADS / (HD / 8);  // key groups of the V pass
  extern __shared__ float sc[];  // n_past + 1 scores
  __shared__ int qw[HD / 4];     // the quantized q, 4 int8 a word
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
  // (i) the fresh rows' scales over all D, and this head's int8 values
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
    kc[(size_t)n_past * D + off + d] = quant_i8(to_f32(knew[off + d]),
                                                i8_inv(sk));
    vc[(size_t)n_past * D + off + d] = quant_i8(to_f32(vnew[off + d]),
                                                i8_inv(sv));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ks[n_past] = sk;
    vs[n_past] = sv;
  }
  // (ii) q, quantized over the head
  float qv = 0.0f;
  if (threadIdx.x < HD) qv = to_f32(qkv[off + threadIdx.x]) * scale;
  const float sq = i8_scale(block_max(fabsf(qv), red));
  if (threadIdx.x < HD)
    reinterpret_cast<signed char*>(qw)[threadIdx.x] =
        quant_i8(qv, i8_inv(sq));
  __syncthreads();
  // (iii) scores: whole key rows per thread, 4 x 16-byte loads each
  const int n = n_past + 1;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int4* kr = reinterpret_cast<const int4*>(kc + (size_t)j * D + off);
    int acc = 0;
#pragma unroll
    for (int w = 0; w < HD / 16; ++w) {
      const int4 u = kr[w];
      acc = __dp4a(u.x, qw[4 * w], acc);
      acc = __dp4a(u.y, qw[4 * w + 1], acc);
      acc = __dp4a(u.z, qw[4 * w + 2], acc);
      acc = __dp4a(u.w, qw[4 * w + 3], acc);
    }
    const float s = ((float)acc * sq) * (j == n_past ? sk : ks[j]);
    sc[j] = s;
    m = fmaxf(m, s);
  }
  // (iv) softmax
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
  // (v) context: groups of 8 threads read one V row, 8 bytes a thread
  const int dg = (threadIdx.x % (HD / 8)) * 8, kg = threadIdx.x / (HD / 8);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = kg; j < n; j += KG) {
    const int2 u =
        *reinterpret_cast<const int2*>(vc + (size_t)j * D + off + dg);
    const signed char* v8 = reinterpret_cast<const signed char*>(&u);
    const float s = j == n_past ? sv : vs[j];
    const float p = sc[j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[i] = fmaf(p, round_t<T>((float)v8[i] * s), acc[i]);
  }
  for (int i = 0; i < 8; ++i) part[kg][dg + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < HD) {
    float t = 0.0f;
    for (int g = 0; g < KG; ++g) t += part[g][threadIdx.x];
    ctx[off + threadIdx.x] = from_f32<T>(t);
  }
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

// logits[v] = dot(LN_f(x), head[v, :]) for v in [lo, hi), f32. One warp per
// vocab row of the (V, D) head; every block recomputes ln_f of the one row.
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

template <typename T>
int decode_step_t(const BarkGPTWeights* w, const int* tok, int n_past,
                  const BarkKV& kv, void* x_, void* qkv_, void* ctx_,
                  void* h_, float* partial, unsigned int* tickets,
                  float* logits, int lo, int hi, cudaStream_t st) {
  const int L = w->n_layer, D = w->n_embd, S = w->block_size;
  const int V = w->n_out_vocab;
  const size_t LD = (size_t)D;
  T* x = (T*)x_;
  T* qkv = (T*)qkv_;
  T* ctx = (T*)ctx_;
  T* h = (T*)h_;
  int err = bark_launch_embed_token(w, tok, n_past, x, st);
  if (err) return err;
  for (int l = 0; l < L; ++l) {
    const T* ln1_g = (const T*)w->ln1_g + l * LD;
    const T* ln1_b = (const T*)w->ln1_b + l * LD;
    const T* ln2_g = (const T*)w->ln2_g + l * LD;
    const T* ln2_b = (const T*)w->ln2_b + l * LD;
    err = gemv<T, EPI_PLAIN, true>(
        x, ln1_g, ln1_b, (const T*)w->qkv_w + l * LD * 3 * D,
        (const T*)w->qkv_b + l * 3 * LD, D, 3 * D, nullptr, qkv, partial,
        tickets, st);
    if (err) return err;
    err = attn_decode_t<T>(qkv, kv_at(kv, (size_t)l * S, D, sizeof(T)),
                           n_past, nullptr, 1, S, D, w->n_head, ctx, st);
    if (err) return err;
    err = gemv<T, EPI_RESID, false>(
        ctx, nullptr, nullptr, (const T*)w->proj_w + l * LD * D,
        (const T*)w->proj_b + l * LD, D, D, x, x, partial, tickets, st);
    if (err) return err;
    err = gemv<T, EPI_GELU, true>(
        x, ln2_g, ln2_b, (const T*)w->fc_w + l * LD * 4 * D,
        (const T*)w->fc_b + l * 4 * LD, D, 4 * D, nullptr, h, partial,
        tickets, st);
    if (err) return err;
    err = gemv<T, EPI_RESID, false>(
        h, nullptr, nullptr, (const T*)w->out_w + l * LD * 4 * D,
        (const T*)w->out_b + l * LD, 4 * D, D, x, x, partial, tickets, st);
    if (err) return err;
  }
  if (lo > 0 || hi < V) {
    err = (int)cudaMemsetAsync(logits, 0, V * sizeof(float), st);
    if (err) return err;
  }
  return lm_head_t<T>(w, x, logits, lo, hi, st);
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

// Returns cudaGetLastError() after the launches (0 on success). k_cache and
// v_cache are the stage's (L, S, D) caches, in the params dtype when
// k_scale and v_scale are null, else int8 with those (L, S) f32 row scales
// (K6a); x (D), qkv (3D), ctx (D) and h (4D) are caller-allocated scratch
// in the params dtype, partial is 65536 f32 of scratch, tickets 1024
// zeroed uint32 (left zeroed); logits is (n_out_vocab,) f32, zero outside
// [lo, hi).
extern "C" int bark_decode_step(const BarkGPTWeights* w, const int* tok,
                                int n_past, void* k_cache, void* v_cache,
                                float* k_scale, float* v_scale, void* x,
                                void* qkv, void* ctx, void* h,
                                float* partial, unsigned int* tickets,
                                float* logits, int lo, int hi,
                                cudaStream_t stream) {
  if (w->n_embd / w->n_head != HD || w->n_embd % GEMV_COLS ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return -1;
  const BarkKV kv{k_cache, v_cache, k_scale, v_scale};
  if (w->dtype == BARK_BF16)
    return decode_step_t<bf16>(w, tok, n_past, kv, x, qkv, ctx, h, partial,
                               tickets, logits, lo, hi, stream);
  return decode_step_t<float>(w, tok, n_past, kv, x, qkv, ctx, h, partial,
                              tickets, logits, lo, hi, stream);
}
