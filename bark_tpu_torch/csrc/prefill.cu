// K2: causal prefill of n_valid rows into the decode caches, and K8, the
// same for B lanes at once.
//
// Replaces bark_tpu/kernels/prefill.py `prefill_fused` (the Pallas kernel
// `_prefill_kernel`, layer loop `_lane_layers`) and `prefill_fused_batched`
// (`_prefill_kernel_batched`): x = x_emb + wpe, then
// L x [LN1 -> QKV (k, v rows written into cache[l, row]) -> causal
// attention -> proj + residual -> LN2 -> fc -> tanh-GELU -> out + residual],
// then ln_f and the LM head of row n_valid-1 over [lo, hi) (K1's kernel).
//
// What bounds it: at T = 257 (the semantic prompt) or up to 887 (a coarse
// re-prime) the four projections are GEMMs of about 2*T*D*12D FLOPs a
// layer against 12*D*D weights: at T ~ 900 that is ~450 FLOPs per weight
// byte in bf16, above the ridge, so the projections are bound by
// arithmetic; attention (T^2/2 * D * 4 FLOPs a layer) is small beside
// them.
//
// What the design does about it: one tiled GEMM (64x64 output tiles, 32
// deep), templated on the params dtype with f32 accumulate: bf16 goes
// through the tensor cores with WMMA (16x16x16 fragments, 4 warps of 32x32
// each), f32 through a SIMT outer-product loop (each thread 4x8 outputs,
// exact f32 products as the reference computes them). The epilogue rounds,
// adds the bias, and then applies GELU, a residual add in place, or (for
// QKV) writes q to scratch and k, v straight into the cache rows. Only the
// n_valid live rows are computed at all: rows past n_valid are dead to
// every later reader. Attention is one block per (head, 16 query rows):
// K tiles through shared memory for the scores, an f32 softmax per row
// whose weights are rounded to T before the V product (as the reference
// does), V tiles through shared memory for the context. Not yet done:
// wgmma/TMA pipelines, fusing LN into the GEMM prologue, a flash-style
// single pass.
//
// K8 stacks the B lanes' live rows into one M = sum(n_valid) row block, so
// each projection is ONE GEMM whose weights stream once for every lane
// (the bound is K2's, with T = M). Only three places need the lane, and
// read it from small host-built tables (`RowMap`): the embedding (which
// x_emb row and position a stacked row has), the QKV epilogue (which cache
// row of which lane's slab its k, v go to), and attention, whose query
// tiles never straddle two lanes and each read their own lane's cache slab
// and n_valid. The LM head is K7's batched head on each lane's last live
// row.
//
// With int8 caches (K6) the QKV epilogue writes k, v in T to scratch, K6b
// (`quant_rows_kernel`) quantizes each row into its cache row, one launch
// a layer, and the attention is K6c (`attn_prefill_i8_kernel`). The JAX
// package runs such a prefill in XLA; both compute models/gpt.py's int8
// path. What bounds them: K6b moves ~3 bytes a K/V value, K6c reads int8
// tiles; both are small beside the projections' GEMMs.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int HD = 64;
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int GEMM_THREADS = 128;
constexpr int LN_THREADS = 256;
constexpr int QT = 16;  // query rows per attention block
constexpr int KT = 64;  // keys per shared tile
constexpr int PA_THREADS = 256;

enum { GE_QKV = 0, GE_GELU = 1, GE_RESID = 2 };

// the row-major operand tiles of one k-step and the f32 output tile
constexpr int A_LD16 = BK + 8;   // bf16 A tile row stride (elements)
constexpr int B_LD16 = BN + 8;   // bf16 B tile row stride
constexpr int A_LD32 = BM + 4;   // f32 A tile, stored k-major
constexpr int B_LD32 = BN + 4;   // f32 B tile
constexpr int C_LD = BN + 4;     // f32 output tile
constexpr int GEMM_SMEM =
    BK * A_LD32 * 4 + BK * B_LD32 * 4 + BM * C_LD * 4;  // f32 path, largest

// Where each stacked row of a batched prefill (K8) comes from and goes to,
// as device int32 tables; every pointer is null for K2's one lane (stacked
// row m is then row m, position m, cache row m, and the query tiles are
// consecutive).
struct RowMap {
  const int* src;     // (M,) x_emb row of stacked row m: lane * T + pos
  const int* pos;     // (M,) its position
  const int* slot;    // (M,) its cache row in the layer's (B, S, D) slabs
  const int* tiles;   // (n_tiles, 3): lane, first query row, lane's row 0
  const int* lane_n;  // (B,) live rows of each lane
  const int* last;    // (B,) stacked row of each lane's last live row
};

template <typename T>
__global__ void embed_rows_kernel(const T* __restrict__ x_emb,
                                  const T* __restrict__ wpe, int n, int D,
                                  RowMap map, T* __restrict__ x) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * D) return;
  const int m = (int)(i / D), d = (int)(i % D);
  const size_t src = map.src != nullptr ? map.src[m] : m;
  const size_t pos = map.pos != nullptr ? map.pos[m] : m;
  x[i] = from_f32<T>(round_t<T>(to_f32(x_emb[src * D + d]) +
                                to_f32(wpe[pos * D + d])));
}

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
    ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const T* __restrict__ b, int D, T* __restrict__ out) {
  extern __shared__ float row[];  // D floats
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * D;
  block_layer_norm<T>(x + base, g, b, row, D, red);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    out[base + i] = from_f32<T>(row[i]);
}

struct GemmOut {
  void* out;     // GELU: (M, N); RESID: x (M, N), updated in place; QKV: q (M, D)
  void* kc;      // QKV: this layer's (S, D) cache slabs, (B, S, D) for K8
  void* vc;
  int D;         // QKV: model width
  const int* slot;  // QKV: cache row of each stacked row (null: row m)
};

// C = A (M, K) @ B (K, N), both row-major in T, f32 accumulate; rows >= M
// are neither read nor written. Requires K % BK == 0 and N % BN == 0.
template <typename T, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ bias, int M, int N, int K, GemmOut o) {
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  float* Cs = reinterpret_cast<float*>(smem + BK * A_LD32 * 4 +
                                       BK * B_LD32 * 4);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if constexpr (sizeof(T) == 2) {
    bf16* As = reinterpret_cast<bf16*>(smem);
    bf16* Bs = reinterpret_cast<bf16*>(smem + BM * A_LD16 * 2 + 128);
    const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < K; k0 += BK) {
      // A tile 64x32 and B tile 32x64: 256 16-byte vectors each
      for (int v = tid; v < BM * BK / 8; v += GEMM_THREADS) {
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (m0 + r < M)
          val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
        *reinterpret_cast<uint4*>(As + r * A_LD16 + c) = val;
      }
      for (int v = tid; v < BK * BN / 8; v += GEMM_THREADS) {
        const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + r * B_LD16 + c) =
            *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * N + n0 + c);
      }
      __syncthreads();
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * A_LD16 + kk,
                                 A_LD16);
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bfr[j], Bs + kk * B_LD16 + wn * 32 + j * 16,
                                 B_LD16);
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      }
      __syncthreads();
    }
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                                acc[i][j], C_LD, wmma::mem_row_major);
  } else {
    float* As = reinterpret_cast<float*>(smem);              // [BK][A_LD32]
    float* Bs = reinterpret_cast<float*>(smem + BK * A_LD32 * 4);  // [BK][B_LD32]
    const int tx = tid % 8, ty = tid / 8;  // 8 x 8 columns, 16 x 4 rows
    float acc[4][8];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int v = tid; v < BM * BK / 4; v += GEMM_THREADS) {
        const int r = v / (BK / 4), c = (v % (BK / 4)) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + r < M)
          val = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(A) + (size_t)(m0 + r) * K + k0 + c);
        As[(c + 0) * A_LD32 + r] = val.x;
        As[(c + 1) * A_LD32 + r] = val.y;
        As[(c + 2) * A_LD32 + r] = val.z;
        As[(c + 3) * A_LD32 + r] = val.w;
      }
      for (int v = tid; v < BK * BN / 4; v += GEMM_THREADS) {
        const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
        *reinterpret_cast<float4*>(Bs + r * B_LD32 + c) =
            *reinterpret_cast<const float4*>(
                reinterpret_cast<const float*>(B) + (size_t)(k0 + r) * N + n0 + c);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[8];
        for (int i = 0; i < 4; ++i) a[i] = As[kk * A_LD32 + ty * 4 + i];
        for (int j = 0; j < 8; ++j) b[j] = Bs[kk * B_LD32 + tx * 8 + j];
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 8; ++j)
        Cs[(ty * 4 + i) * C_LD + tx * 8 + j] = acc[i][j];
  }
  __syncthreads();

  // epilogue: round, + bias, then GELU / residual / q-k-v split
  for (int idx = tid; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = round_t<T>(Cs[r * C_LD + c]);
    v = round_t<T>(v + to_f32(bias[n]));
    if (EPI == GE_QKV) {
      const int D = o.D, which = n / D, col = n % D;
      const size_t row = which == 0 || o.slot == nullptr ? m : o.slot[m];
      T* dst = which == 0 ? (T*)o.out : (which == 1 ? (T*)o.kc : (T*)o.vc);
      dst[row * D + col] = from_f32<T>(v);
    } else if (EPI == GE_GELU) {
      ((T*)o.out)[(size_t)m * N + n] = from_f32<T>(round_t<T>(gelu_tanh(v)));
    } else {
      T* x = (T*)o.out;
      x[(size_t)m * N + n] = from_f32<T>(round_t<T>(to_f32(x[(size_t)m * N + n]) + v));
    }
  }
}

// Causal attention for query rows [r0, r0+QT) of one head over keys
// [0, min(r0+QT, n)). Dynamic shared memory: QT x ld f32 scores. With
// map.tiles (K8) the tile's lane, r0 and stacked row of the lane's row 0
// come from the table, and the lane's (S, D) cache slab and n_valid are
// used.
template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
    attn_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, int n, int S, int D,
                        int ld, float scale, RowMap map,
                        T* __restrict__ ctx) {
  extern __shared__ float sc[];
  __shared__ float qs[QT][HD + 1];
  __shared__ float ts[KT][HD + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = blockIdx.x * HD;
  int r0 = blockIdx.y * QT;
  if (map.tiles != nullptr) {
    const int* t = map.tiles + 3 * blockIdx.y;
    n = map.lane_n[t[0]];
    kc += (size_t)t[0] * S * D;
    vc += (size_t)t[0] * S * D;
    r0 = t[1];
    q += (size_t)t[2] * D;
    ctx += (size_t)t[2] * D;
  }
  const int nq = min(QT, n - r0);
  const int kmax = min(r0 + QT, n);
  for (int idx = tid; idx < QT * HD; idx += PA_THREADS) {
    const int i = idx / HD, d = idx % HD;
    qs[i][d] = i < nq ? to_f32(q[(size_t)(r0 + i) * D + off + d]) : 0.0f;
  }
  // scores: thread (key j, rows ig*4 .. ig*4+3) per tile of KT keys
  {
    const int j = tid % KT, ig = tid / KT;
    for (int k0 = 0; k0 < kmax; k0 += KT) {
      __syncthreads();
      for (int idx = tid; idx < KT * HD; idx += PA_THREADS) {
        const int jj = idx / HD, d = idx % HD;
        ts[jj][d] = k0 + jj < kmax
                        ? to_f32(kc[(size_t)(k0 + jj) * D + off + d])
                        : 0.0f;
      }
      __syncthreads();
      if (k0 + j < kmax) {
        for (int ii = 0; ii < QT / 4; ++ii) {
          const int i = ig * (QT / 4) + ii;
          float s = 0.0f;
          for (int d = 0; d < HD; ++d) s = fmaf(qs[i][d], ts[j][d], s);
          sc[i * ld + k0 + j] = s * scale;
        }
      }
    }
  }
  __syncthreads();
  // softmax per query row over its causal keys [0, row]; later keys get an
  // exact zero weight, as exp(-1e9 - max) is in the reference
  for (int i = warp; i < QT; i += PA_THREADS / 32) {
    const int nk = min(r0 + i + 1, kmax);
    float* s = sc + i * ld;
    float m = -INFINITY;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, s[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < nk; j += 32) s[j] = round_t<T>(s[j] / sum);
    for (int j = nk + lane; j < kmax; j += 32) s[j] = 0.0f;
  }
  // context: thread (row i, dims d0 .. d0+3)
  const int i = tid / (HD / 4), d0 = (tid % (HD / 4)) * 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < kmax; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < KT * HD; idx += PA_THREADS) {
      const int jj = idx / HD, d = idx % HD;
      ts[jj][d] = k0 + jj < kmax
                      ? to_f32(vc[(size_t)(k0 + jj) * D + off + d])
                      : 0.0f;
    }
    __syncthreads();
    const int nk = min(KT, kmax - k0);
    const float* p = sc + i * ld + k0;
    for (int j = 0; j < nk; ++j) {
      const float pj = p[j];
      for (int t = 0; t < 4; ++t) acc[t] = fmaf(pj, ts[j][d0 + t], acc[t]);
    }
  }
  if (i < nq)
    for (int t = 0; t < 4; ++t)
      ctx[(size_t)(r0 + i) * D + off + d0 + t] = from_f32<T>(acc[t]);
}

// K6b: quantize the QKV epilogue's K (blockIdx.y 0) or V (1) row m of
// `rows` ((2, M, D) in T) into its cache row (m, or map.slot[m] for K8) of
// the layer's int8 slab, with its f32 scale: the row's amax over D, then
// models/gpt.quantize_kv_rows' formula. One block per (row, K or V).
// Replaces the JAX package's XLA `_kv_update` of an int8 cache in prefill
// (bark_tpu/models/gpt.py:212; its Pallas prefill takes no int8 cache).
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
    quant_rows_kernel(const T* __restrict__ rows, int M, int D,
                      const int* __restrict__ slot, signed char* kq,
                      signed char* vq, float* ks, float* vs) {
  __shared__ float red[32];
  const int m = blockIdx.x;
  const bool is_v = blockIdx.y != 0;
  const T* x = rows + ((size_t)blockIdx.y * M + m) * D;
  float a = 0.0f;
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    a = fmaxf(a, fabsf(to_f32(x[i])));
  const float s = i8_scale(block_max(a, red)), inv = i8_inv(s);
  const size_t row = slot != nullptr ? slot[m] : m;
  signed char* q = (is_v ? vq : kq) + row * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    q[i] = quant_i8(to_f32(x[i]), inv);
  if (threadIdx.x == 0) (is_v ? vs : ks)[row] = s;
}

// K6c: attn_prefill_kernel on the int8 cache, as models/gpt.py
// `_attention_int8` computes it: the query tile's rows are quantized per
// (row, head) in shared memory (q * (1/sqrt(64)), scale amax / 127), key
// tiles are staged as int8 with their row scales and scored with integer
// __dp4a dots, (score * s_q) * s_k; value tiles are dequantized to T as
// they are staged (round_t<T>(q * s_v)). The causal softmax and the exact
// zeros past each row are attn_prefill_kernel's. Replaces the JAX
// package's XLA attention of an int8 prefill (bark_tpu/models/gpt.py:273;
// its Pallas prefill takes no int8 cache).
template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
    attn_prefill_i8_kernel(const T* __restrict__ q,
                           const signed char* __restrict__ kc,
                           const signed char* __restrict__ vc,
                           const float* __restrict__ ks,
                           const float* __restrict__ vs, int n, int S, int D,
                           int ld, float scale, RowMap map,
                           T* __restrict__ ctx) {
  extern __shared__ float sc[];
  __shared__ int qw[QT][HD / 4 + 1];   // int8 query rows, 4 a word
  __shared__ float qs[QT];             // their scales
  __shared__ int kw[KT][HD / 4 + 1];   // int8 key tile
  __shared__ float kts[KT];            // its row scales
  __shared__ float ts[KT][HD + 1];     // dequantized value tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = blockIdx.x * HD;
  int r0 = blockIdx.y * QT;
  if (map.tiles != nullptr) {
    const int* t = map.tiles + 3 * blockIdx.y;
    n = map.lane_n[t[0]];
    kc += (size_t)t[0] * S * D;
    vc += (size_t)t[0] * S * D;
    ks += (size_t)t[0] * S;
    vs += (size_t)t[0] * S;
    r0 = t[1];
    q += (size_t)t[2] * D;
    ctx += (size_t)t[2] * D;
  }
  const int nq = min(QT, n - r0);
  const int kmax = min(r0 + QT, n);
  // quantize the query tile: one warp per row, 2 dims a lane
  for (int i = warp; i < QT; i += PA_THREADS / 32) {
    float v0 = 0.0f, v1 = 0.0f;
    if (i < nq) {
      const T* row = q + (size_t)(r0 + i) * D + off;
      v0 = to_f32(row[lane]) * scale;
      v1 = to_f32(row[lane + 32]) * scale;
    }
    const float s = i8_scale(warp_max(fmaxf(fabsf(v0), fabsf(v1))));
    signed char* qb = reinterpret_cast<signed char*>(qw[i]);
    qb[lane] = quant_i8(v0, i8_inv(s));
    qb[lane + 32] = quant_i8(v1, i8_inv(s));
    if (lane == 0) qs[i] = s;
  }
  // scores: thread (key j, rows ig*4 .. ig*4+3) per tile of KT keys
  {
    const int j = tid % KT, ig = tid / KT;
    for (int k0 = 0; k0 < kmax; k0 += KT) {
      __syncthreads();
      for (int idx = tid; idx < KT * HD / 16; idx += PA_THREADS) {
        const int jj = idx / (HD / 16), c = idx % (HD / 16);
        int4 u = make_int4(0, 0, 0, 0);
        if (k0 + jj < kmax)
          u = *reinterpret_cast<const int4*>(kc + (size_t)(k0 + jj) * D +
                                             off + 16 * c);
        kw[jj][4 * c] = u.x;
        kw[jj][4 * c + 1] = u.y;
        kw[jj][4 * c + 2] = u.z;
        kw[jj][4 * c + 3] = u.w;
      }
      if (tid < KT) kts[tid] = k0 + tid < kmax ? ks[k0 + tid] : 0.0f;
      __syncthreads();
      if (k0 + j < kmax) {
        for (int ii = 0; ii < QT / 4; ++ii) {
          const int i = ig * (QT / 4) + ii;
          int acc = 0;
#pragma unroll
          for (int w = 0; w < HD / 4; ++w)
            acc = __dp4a(qw[i][w], kw[j][w], acc);
          sc[i * ld + k0 + j] = ((float)acc * qs[i]) * kts[j];
        }
      }
    }
  }
  __syncthreads();
  // softmax per query row over its causal keys [0, row], as
  // attn_prefill_kernel
  for (int i = warp; i < QT; i += PA_THREADS / 32) {
    const int nk = min(r0 + i + 1, kmax);
    float* s = sc + i * ld;
    float m = -INFINITY;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, s[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < nk; j += 32) s[j] = round_t<T>(s[j] / sum);
    for (int j = nk + lane; j < kmax; j += 32) s[j] = 0.0f;
  }
  // context: thread (row i, dims d0 .. d0+3)
  const int i = tid / (HD / 4), d0 = (tid % (HD / 4)) * 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < kmax; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < KT * HD / 4; idx += PA_THREADS) {
      const int jj = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
      if (k0 + jj < kmax) {
        const char4 c = *reinterpret_cast<const char4*>(
            vc + (size_t)(k0 + jj) * D + off + d);
        const float s = vs[k0 + jj];
        ts[jj][d] = round_t<T>((float)c.x * s);
        ts[jj][d + 1] = round_t<T>((float)c.y * s);
        ts[jj][d + 2] = round_t<T>((float)c.z * s);
        ts[jj][d + 3] = round_t<T>((float)c.w * s);
      } else {
        ts[jj][d] = ts[jj][d + 1] = ts[jj][d + 2] = ts[jj][d + 3] = 0.0f;
      }
    }
    __syncthreads();
    const int nk = min(KT, kmax - k0);
    const float* p = sc + i * ld + k0;
    for (int j = 0; j < nk; ++j) {
      const float pj = p[j];
      for (int t = 0; t < 4; ++t) acc[t] = fmaf(pj, ts[j][d0 + t], acc[t]);
    }
  }
  if (i < nq)
    for (int t = 0; t < 4; ++t)
      ctx[(size_t)(r0 + i) * D + off + d0 + t] = from_f32<T>(acc[t]);
}

template <typename T, int EPI>
int gemm(const T* A, const T* B, const T* bias, int M, int N, int K,
         GemmOut o, cudaStream_t st) {
  dim3 grid(cdiv(N, BN), cdiv(M, BM));
  gemm_kernel<T, EPI><<<grid, GEMM_THREADS, 0, st>>>(A, B, bias, M, N, K, o);
  return (int)cudaGetLastError();
}

// The prefill of M stacked rows of B lanes (K2: B = 1, M = n_valid, a null
// map); max_n is the longest lane's n_valid, n_tiles the attention's query
// tiles. An int8 `kv` (K6) takes kv_rows, (2, M, D) scratch in T for the
// K/V rows that K6b quantizes.
template <typename T>
int prefill_t(const BarkGPTWeights* w, const void* x_emb, int B, int M,
              int max_n, int n_tiles, const RowMap& map, const BarkKV& kv,
              void* x_, void* hb_, void* q_, void* ctx_, void* ff_,
              void* kv_rows, float* logits, int lo, int hi, cudaStream_t st) {
  const int L = w->n_layer, D = w->n_embd, S = w->block_size;
  const int V = w->n_out_vocab;
  const size_t LD = (size_t)D, slab = (size_t)B * S;  // cache rows a layer
  const bool quant = kv.ks != nullptr;
  T* x = (T*)x_;
  T* hb = (T*)hb_;
  T* qb = (T*)q_;
  T* ctx = (T*)ctx_;
  T* ff = (T*)ff_;
  T* rows = (T*)kv_rows;
  const float scale = (float)(1.0 / sqrt((double)(D / w->n_head)));
  const int ld = cdiv(max_n, 4) * 4;
  const size_t att_smem = (size_t)QT * ld * sizeof(float);
  // up to QT x 1024 scores (64 KB) beyond the default 48 KB window; set on
  // every call (one host call), so that it holds on whatever device is
  // current and a refusal is reported here, not as a failed launch
  int err = (int)cudaFuncSetAttribute(
      quant ? (const void*)attn_prefill_i8_kernel<T>
            : (const void*)attn_prefill_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      QT * 1024 * (int)sizeof(float));
  if (err) return err;
  const int total = M * D;
  embed_rows_kernel<T><<<cdiv(total, 256), 256, 0, st>>>(
      (const T*)x_emb, (const T*)w->wpe, M, D, map, x);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 att_grid(w->n_head, n_tiles);
  for (int l = 0; l < L; ++l) {
    const BarkKV c = kv_at(kv, l * slab, D, sizeof(T));
    ln_rows_kernel<T><<<M, LN_THREADS, D * sizeof(float), st>>>(
        x, (const T*)w->ln1_g + l * LD, (const T*)w->ln1_b + l * LD, D, hb);
    // the K/V rows go to the cache, or to kv_rows for K6b to quantize
    const GemmOut qkv_out = quant
        ? GemmOut{qb, rows, rows + (size_t)M * D, D, nullptr}
        : GemmOut{qb, c.k, c.v, D, map.slot};
    err = gemm<T, GE_QKV>(hb, (const T*)w->qkv_w + l * LD * 3 * D,
                          (const T*)w->qkv_b + l * 3 * LD, M, 3 * D, D,
                          qkv_out, st);
    if (err) return err;
    if (quant) {
      quant_rows_kernel<T><<<dim3(M, 2), LN_THREADS, 0, st>>>(
          rows, M, D, map.slot, (signed char*)c.k, (signed char*)c.v, c.ks,
          c.vs);
      err = (int)cudaGetLastError();
      if (err) return err;
      attn_prefill_i8_kernel<T><<<att_grid, PA_THREADS, att_smem, st>>>(
          qb, (const signed char*)c.k, (const signed char*)c.v, c.ks, c.vs,
          M, S, D, ld, scale, map, ctx);
    } else {
      attn_prefill_kernel<T><<<att_grid, PA_THREADS, att_smem, st>>>(
          qb, (const T*)c.k, (const T*)c.v, M, S, D, ld, scale, map, ctx);
    }
    err = (int)cudaGetLastError();
    if (err) return err;
    err = gemm<T, GE_RESID>(ctx, (const T*)w->proj_w + l * LD * D,
                            (const T*)w->proj_b + l * LD, M, D, D,
                            GemmOut{x, nullptr, nullptr, D, nullptr}, st);
    if (err) return err;
    ln_rows_kernel<T><<<M, LN_THREADS, D * sizeof(float), st>>>(
        x, (const T*)w->ln2_g + l * LD, (const T*)w->ln2_b + l * LD, D, hb);
    err = gemm<T, GE_GELU>(hb, (const T*)w->fc_w + l * LD * 4 * D,
                           (const T*)w->fc_b + l * 4 * LD, M, 4 * D, D,
                           GemmOut{ff, nullptr, nullptr, D, nullptr}, st);
    if (err) return err;
    err = gemm<T, GE_RESID>(ff, (const T*)w->out_w + l * LD * 4 * D,
                            (const T*)w->out_b + l * LD, M, D, 4 * D,
                            GemmOut{x, nullptr, nullptr, D, nullptr}, st);
    if (err) return err;
  }
  if (lo > 0 || hi < V) {
    err = (int)cudaMemsetAsync(logits, 0, (size_t)B * V * sizeof(float), st);
    if (err) return err;
  }
  if (map.last != nullptr)
    return bark_launch_lm_head_batched(w, x, map.last, B, logits, lo, hi, st);
  return bark_launch_lm_head(w, x + (size_t)(M - 1) * D, logits, lo, hi, st);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success). x_emb holds
// >= n_valid rows (T, D) of token embeddings without positions; cache rows
// [0, n_valid) of every layer are written, later rows are left as they
// were. The caches are int8 with (L, S) f32 row scales when k_scale and
// v_scale are given (K6b, K6c), and kv_rows is then (2, n_valid, D) scratch
// in the params dtype. x, hb, q, ctx (n_valid, D) and ff (n_valid, 4D) are
// caller-allocated scratch in the params dtype; logits (n_out_vocab,) f32
// are those of row n_valid-1, zero outside [lo, hi).
extern "C" int bark_prefill(const BarkGPTWeights* w, const void* x_emb,
                            int n_valid, void* k_cache, void* v_cache,
                            float* k_scale, float* v_scale, void* x, void* hb,
                            void* q, void* ctx, void* ff, void* kv_rows,
                            float* logits, int lo, int hi,
                            cudaStream_t stream) {
  if (w->n_embd / w->n_head != HD || w->n_embd % BN || n_valid <= 0 ||
      n_valid > w->block_size || w->block_size > 1024 ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (k_scale != nullptr && kv_rows == nullptr))
    return -1;
  const RowMap map{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  const BarkKV kv{k_cache, v_cache, k_scale, v_scale};
  const int n_tiles = cdiv(n_valid, QT);
  if (w->dtype == BARK_BF16)
    return prefill_t<bf16>(w, x_emb, 1, n_valid, n_valid, n_tiles, map, kv, x,
                           hb, q, ctx, ff, kv_rows, logits, lo, hi, stream);
  return prefill_t<float>(w, x_emb, 1, n_valid, n_valid, n_tiles, map, kv, x,
                          hb, q, ctx, ff, kv_rows, logits, lo, hi, stream);
}

// K8. Returns as bark_prefill. x_emb is (B, T, D); the caches are
// (L, B, S, D); `tables` is one device int32 buffer holding, in order,
// src, pos, slot (M each), tiles (3 * n_tiles), lane_n and last (B each)
// of `RowMap`, for M = sum(lane_n) stacked rows; max_n = max(lane_n) and
// n_tiles = sum(ceil(lane_n / 16)) (query tiles of 16 rows). Int8 caches
// take (L, B, S) f32 row scales and kv_rows, as bark_prefill. x, hb, q,
// ctx (M, D) and ff (M, 4D) are scratch in the params dtype; logits (B,
// n_out_vocab) f32 are those of each lane's last live row, zero outside
// [lo, hi).
extern "C" int bark_prefill_batched(const BarkGPTWeights* w,
                                    const void* x_emb, int B, int M,
                                    int max_n, int n_tiles, const int* tables,
                                    void* k_cache, void* v_cache,
                                    float* k_scale, float* v_scale, void* x,
                                    void* hb, void* q, void* ctx, void* ff,
                                    void* kv_rows, float* logits, int lo,
                                    int hi, cudaStream_t stream) {
  if (w->n_embd / w->n_head != HD || w->n_embd % BN || B <= 0 || M <= 0 ||
      max_n <= 0 || max_n > w->block_size || w->block_size > 1024 ||
      n_tiles <= 0 || (k_scale == nullptr) != (v_scale == nullptr) ||
      (k_scale != nullptr && kv_rows == nullptr))
    return -1;
  const RowMap map{tables, tables + M, tables + 2 * M, tables + 3 * M,
                   tables + 3 * M + 3 * n_tiles,
                   tables + 3 * M + 3 * n_tiles + B};
  const BarkKV kv{k_cache, v_cache, k_scale, v_scale};
  if (w->dtype == BARK_BF16)
    return prefill_t<bf16>(w, x_emb, B, M, max_n, n_tiles, map, kv, x, hb, q,
                           ctx, ff, kv_rows, logits, lo, hi, stream);
  return prefill_t<float>(w, x_emb, B, M, max_n, n_tiles, map, kv, x, hb, q,
                          ctx, ff, kv_rows, logits, lo, hi, stream);
}
