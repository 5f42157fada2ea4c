// K5-batched: the batched decode step (K7) on packed-quantized weights.
//
// Replaces the `quant=True` path of bark_tpu/kernels/decode.py
// `decode_step_fused_batched` (the Pallas kernel `_decode_kernel_batched`
// with `_tile_stream`'s int8 tile dequant, `_qdot` and `_embed_token`),
// which K9 and K10 (`semantic_chunk_fused_batched`,
// `coarse_window_fused_batched` with quant=True) run as their steps: per
// lane b, embed the packed wte row of tok[b] at n_past[b] -> L x [LN1 ->
// packed QKV -> K/V row written at [l, b, n_past[b]] -> attention ->
// packed proj + residual -> LN2 -> packed fc -> GELU -> packed out +
// residual] -> ln_f -> packed LM head over [lo, hi). Weights: int8 values
// (L, K, N) with scales [and mins] (L, K/32, N), f16 (q4_0/q4_1/q5_0/q5_1/
// q8_0) or f32 (q4_k/q5_k); the LM head is the transposed, zero-padded
// (D, v_pad) tile; wte rows are blocked along D.
//
// What bounds it: a step streams every packed weight once for all lanes
// (~85 M int8 values plus 5.3 MB of f16 scales a bark-small stage, ~110 MB
// with the LM head, against ~170 MB of bf16 weights for K7) plus each
// lane's live cache rows, and does 2 FLOPs per weight per lane. As for K7,
// bytes (and per-kernel latency) bound it at small B, and the NB f32 FMAs
// per weight of this SIMT kernel at B = 32, where the dequantization
// (one multiply and one rounding per weight, shared by all lanes) adds
// little.
//
// What the design does about it: K7's lane-folded split-K GEMV with K5's
// packed read. A block holds its split of every lane's input rows in
// shared memory (LayerNormed per lane when the GEMV consumes LN) and, for
// the offset formats, each lane's 32-row block sums of them beside it;
// each thread owns CPT neighbouring columns (4 as one char4 up to 8 lanes,
// 2 as one char2 above, so that CPT x NB f32 accumulators stay in
// registers) and reads their CPT scales once per 32-row block. The
// dequantized value round_T(q * s) is made once per weight and FMA'd for
// every lane, so each weight is read from device memory ONCE per step for
// the whole batch, and it is the number the plain version's densified
// tile holds. Splits start on 32-row boundaries, so a split's block sums
// pair with whole rows of mins: warp blk % 8 adds bsum[blk][b] * m[blk, c]
// to lane b's accumulator, per lane. The per-lane partials of the splits
// are summed by the tile's last block in split order (deterministic); the
// epilogues are K7's. Attention is K7's (K6a on int8 caches); the LM head
// launches only the column tiles that cover [lo, hi). Not yet done: lanes
// as the M rows of an mma tile, a persistent kernel, CUDA graphs.
#include <algorithm>

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int MAX_LANES = 32;
constexpr int QB_WARPS = 8;     // each warp takes rows w, w+8, w+16, w+24
constexpr int QB_THREADS = QB_WARPS * 32;  // of every 32-row block
constexpr int QB_TARGET_BLOCKS = 264;  // ~2 per SM of an H100 (132 SMs)
constexpr size_t QB_PARTIAL_CAP = 1 << 16;  // f32 partials of one lane
constexpr int QB_TICKETS = 1024;   // column tiles of one GEMV
constexpr int RED_VALS = 512;      // lane x column sums a warp hands over
                                   // per pass of the cross-warp sum
constexpr int STATIC_SMEM = 20 * 1024;  // static shared memory, rounded up
constexpr int QEMBED_THREADS = 256;

enum { EPI_PLAIN = 0, EPI_GELU = 1, EPI_RESID = 2, EPI_LOGITS = 3 };

// columns a thread owns for NB lanes: CPT x NB accumulators
template <int NB>
__host__ __device__ constexpr int qb_cols() {
  return NB <= 8 ? 4 : 2;
}

// CPT int8 values of one row at p (CPT-byte aligned), as floats
template <int CPT>
__device__ __forceinline__ void load_q(const signed char* p, float* v) {
  if constexpr (CPT == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
  } else {
    const char2 c = *reinterpret_cast<const char2*>(p);
    v[0] = c.x; v[1] = c.y;
  }
}

// the CPT scales (or mins) of columns c..c+CPT-1 of one block row
template <int CPT>
__device__ __forceinline__ void load_s(const float* p, float* v) {
  if constexpr (CPT == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  }
}
template <int CPT>
__device__ __forceinline__ void load_s(const __half* p, float* v) {
  if constexpr (CPT == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
    const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(p));
    v[0] = a.x; v[1] = a.y;
  }
}

// out[b] = epilogue(round(in[b] @ Wdq) + bias) for b < B, in[b] = LN(x[b])
// when LN else x[b], over the columns of tiles [n0 / COLS, n0 / COLS +
// gridDim.x). Wdq[k, n] = round_T(q[k, n] * s[k/32, n]) (+ the per-lane
// min term below); x: (B, K), q: (K, N) int8, s/m: (K/32, N); out row b
// at b * ld_out. EPI_LOGITS writes the f32 sums as they are, for columns
// in [lo, hi) only.
//
// Block (tile, split) sums rows [split*R, split*R + R) (R a multiple of
// 32) for every lane and stores lane b's f32 partials at
// partial[(b * splits + split) * ncols + n - n0]; the tile's last block (an
// atomic ticket) sums each lane's partials in split order, applies the
// epilogue and re-arms the ticket.
template <typename T, typename S, bool HAS_MIN, int NB, int EPI, bool LN>
__global__ void __launch_bounds__(QB_THREADS)
    qbgemv_kernel(const T* __restrict__ x, const T* __restrict__ ln_g,
                  const T* __restrict__ ln_b,
                  const signed char* __restrict__ q, const S* __restrict__ s,
                  const S* __restrict__ m, const T* __restrict__ bias, int B,
                  int K, int N, int R, int n0, int ncols, int lo, int hi,
                  int ld_out, const T* resid, void* out, float* partial,
                  unsigned int* tickets) {
  constexpr int CPT = qb_cols<NB>();
  constexpr int COLS = 32 * CPT;
  constexpr int RL = NB < RED_VALS / COLS ? NB : RED_VALS / COLS;
  extern __shared__ float xs[];  // R x NB: xs[k * NB + b], then the
  float* bsum = xs + R * NB;     // (R/32) x NB block sums (HAS_MIN)
  __shared__ float stat[MAX_LANES][2];
  __shared__ float part[QB_WARPS][RL][COLS];
  __shared__ bool last;
  const int k0 = blockIdx.y * R, rows = min(R, K - k0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (LN) {
    for (int b = warp; b < B; b += QB_WARPS) {
      float mean, inv;
      warp_ln_stats(x + (size_t)b * K, K, mean, inv);
      if (lane == 0) {
        stat[b][0] = mean;
        stat[b][1] = inv;
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < rows * NB; idx += blockDim.x) {
    const int i = idx / NB, b = idx % NB;
    float v = 0.0f;
    if (b < B) {
      v = to_f32(x[(size_t)b * K + k0 + i]);
      if (LN) {
        const float y = (v - stat[b][0]) * stat[b][1];
        v = round_t<T>(y * to_f32(ln_g[k0 + i]) + to_f32(ln_b[k0 + i]));
      }
    }
    xs[idx] = v;
  }
  __syncthreads();
  const int nblk = rows / 32;
  if (HAS_MIN) {
    for (int idx = threadIdx.x; idx < nblk * NB; idx += blockDim.x) {
      const int blk = idx / NB, b = idx % NB;
      float t = 0.0f;
      for (int i = 0; i < 32; ++i) t += xs[(blk * 32 + i) * NB + b];
      bsum[idx] = t;
    }
    __syncthreads();
  }
  const int tile0 = n0 + blockIdx.x * COLS;
  const int c = tile0 + CPT * lane;
  float acc[NB][CPT];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[b][i] = 0.0f;
  if (c < N) {  // N is a multiple of 4, so c + CPT - 1 < N too
    const int b0 = k0 / 32;
    for (int blk = 0; blk < nblk; ++blk) {
      const signed char* qp = q + (size_t)(k0 + blk * 32 + warp) * N + c;
      float w[4][CPT];
#pragma unroll
      for (int j = 0; j < 4; ++j) load_q<CPT>(qp + (size_t)(8 * j) * N, w[j]);
      float sc[CPT];
      load_s<CPT>(s + (size_t)(b0 + blk) * N + c, sc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          w[j][i] = round_t<T>(__fmul_rn(w[j][i], sc[i]));
        const float* xr = xs + (blk * 32 + warp + 8 * j) * NB;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float xv = xr[b];
#pragma unroll
          for (int i = 0; i < CPT; ++i)
            acc[b][i] = fmaf(xv, w[j][i], acc[b][i]);
        }
      }
      if (HAS_MIN && blk % QB_WARPS == warp) {
        float mn[CPT];
        load_s<CPT>(m + (size_t)(b0 + blk) * N + c, mn);
        const float* bs = bsum + blk * NB;
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int i = 0; i < CPT; ++i)
            acc[b][i] = fmaf(bs[b], mn[i], acc[b][i]);
      }
    }
  }
  // the warps' sums of each lane, RL lanes per pass, into the partials
#pragma unroll
  for (int g = 0; g < NB; g += RL) {
    if (g >= B) break;  // B is the same for every thread of the block
#pragma unroll
    for (int r = 0; r < RL; ++r)
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        part[warp][r][CPT * lane + i] = acc[g + r][i];
    __syncthreads();
    for (int idx = threadIdx.x; idx < RL * COLS; idx += blockDim.x) {
      const int r = idx / COLS, n = tile0 + idx % COLS;
      if (g + r < B && n < N) {
        float a = 0.0f;
        for (int w = 0; w < QB_WARPS; ++w) a += part[w][r][idx % COLS];
        partial[((size_t)(g + r) * gridDim.y + blockIdx.y) * ncols + n - n0] =
            a;
      }
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  for (int idx = threadIdx.x; idx < B * COLS; idx += blockDim.x) {
    const int b = idx / COLS, n = tile0 + idx % COLS;
    if (n >= N) continue;
    float a = 0.0f;
    for (int sp = 0; sp < (int)gridDim.y; ++sp)
      a += __ldcg(partial + ((size_t)b * gridDim.y + sp) * ncols + n - n0);
    if (EPI == EPI_LOGITS) {
      if (n >= lo && n < hi) ((float*)out)[(size_t)b * ld_out + n] = a;
    } else {
      float v = round_t<T>(a);
      v = round_t<T>(v + to_f32(bias[n]));
      if (EPI == EPI_GELU) v = round_t<T>(gelu_tanh(v));
      if (EPI == EPI_RESID)
        v = round_t<T>(to_f32(resid[(size_t)b * N + n]) + v);
      ((T*)out)[(size_t)b * ld_out + n] = from_f32<T>(v);
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

// Launch one packed GEMV of B lanes, compiled for NB, over the column
// tiles that cover [n_lo, n_hi): ~2 blocks per SM, splits of a multiple of
// 32 rows.
template <typename T, typename S, bool HM, int NB, int EPI, bool LN>
int qbgemv_nb(int B, const T* x, const T* ln_g, const T* ln_b,
              const signed char* q, const S* s, const S* m, const T* bias,
              int K, int N, int n_lo, int n_hi, int lo, int hi, int ld_out,
              const T* resid, void* out, float* partial,
              unsigned int* tickets, cudaStream_t st) {
  constexpr int COLS = 32 * qb_cols<NB>();
  if (K % 32 || N % 4) return -1;
  const int n0 = n_lo / COLS * COLS;
  const int tiles = cdiv(n_hi - n0, COLS), ncols = tiles * COLS;
  int splits = cdiv(QB_TARGET_BLOCKS, tiles);
  splits = std::max(1, std::min(splits, K / 32));
  const int R = cdiv(cdiv(K, splits), 32) * 32;
  splits = cdiv(K, R);
  if ((size_t)splits * ncols > QB_PARTIAL_CAP || tiles > QB_TICKETS) return -1;
  const int smem = (R + R / 32) * NB * (int)sizeof(float);
  if (smem + STATIC_SMEM > 48 * 1024) {
    // at 16 and 32 lanes the LM head's splits hold ~50 KB of inputs
    const int err = (int)cudaFuncSetAttribute(
        qbgemv_kernel<T, S, HM, NB, EPI, LN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  qbgemv_kernel<T, S, HM, NB, EPI, LN>
      <<<dim3(tiles, splits), QB_THREADS, smem, st>>>(
          x, ln_g, ln_b, q, s, m, bias, B, K, N, R, n0, ncols, lo, hi,
          ld_out, resid, out, partial, tickets);
  return (int)cudaGetLastError();
}

template <typename T, typename S, bool HM, int EPI, bool LN>
int qbgemv(int B, const T* x, const T* ln_g, const T* ln_b,
           const signed char* q, const S* s, const S* m, const T* bias, int K,
           int N, int n_lo, int n_hi, int lo, int hi, int ld_out,
           const T* resid, void* out, float* partial, unsigned int* tickets,
           cudaStream_t st) {
#define BARK_QBGEMV(NB)                                                   \
  return qbgemv_nb<T, S, HM, NB, EPI, LN>(B, x, ln_g, ln_b, q, s, m, bias, \
                                          K, N, n_lo, n_hi, lo, hi, ld_out, \
                                          resid, out, partial, tickets, st)
  if (B <= 1) BARK_QBGEMV(1);
  if (B <= 4) BARK_QBGEMV(4);
  if (B <= 8) BARK_QBGEMV(8);
  if (B <= 16) BARK_QBGEMV(16);
  BARK_QBGEMV(32);
#undef BARK_QBGEMV
}

// x[b] = round_T(round_T(q[tok[b]] * s [+ m]) + wpe[n_past[b]]), one block
// per lane, the token and slot read from device memory; the dequantized
// row is bit-equal to the densified wte's. An out-of-range token or slot
// gives a NaN row, not a read outside the tables.
template <typename T, typename S, bool HAS_MIN>
__global__ void __launch_bounds__(QEMBED_THREADS)
    qbembed_kernel(const int* __restrict__ tok,
                   const int* __restrict__ n_past,
                   const signed char* __restrict__ wq,
                   const S* __restrict__ ws, const S* __restrict__ wm,
                   const T* __restrict__ wpe, int D, int V, int S_,
                   T* __restrict__ x) {
  const int b = blockIdx.x, t = tok[b], p = n_past[b];
  const bool ok = t >= 0 && t < V && p >= 0 && p < S_;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float v = NAN;
    if (ok) {
      const size_t sb = (size_t)t * (D / 32) + d / 32;
      float w = __fmul_rn((float)wq[(size_t)t * D + d], s_to_f32(ws[sb]));
      if (HAS_MIN) w = __fadd_rn(w, s_to_f32(wm[sb]));
      v = round_t<T>(round_t<T>(w) + to_f32(wpe[(size_t)p * D + d]));
    }
    x[(size_t)b * D + d] = from_f32<T>(v);
  }
}

template <typename T, typename S, bool HM>
int qbdecode_step_t(const BarkGPTQWeights* w, int B, const int* tok,
                    const int* n_past, const BarkKV& kv, void* x_,
                    void* qkv_, void* ctx_, void* h_, float* partial,
                    unsigned int* tickets, float* logits, int lo, int hi,
                    cudaStream_t st) {
  const int L = w->n_layer, D = w->n_embd, S_ = w->block_size;
  const int V = w->n_out_vocab;
  const size_t LD = (size_t)D, slab = (size_t)B * S_;  // cache rows a layer
  T* x = (T*)x_;
  T* qkv = (T*)qkv_;
  T* ctx = (T*)ctx_;
  T* h = (T*)h_;
  const signed char* qkv_q = (const signed char*)w->qkv_q;
  const signed char* proj_q = (const signed char*)w->proj_q;
  const signed char* fc_q = (const signed char*)w->fc_q;
  const signed char* out_q = (const signed char*)w->out_q;
  const S* qkv_s = (const S*)w->qkv_s;
  const S* proj_s = (const S*)w->proj_s;
  const S* fc_s = (const S*)w->fc_s;
  const S* out_s = (const S*)w->out_s;
  // per-layer offsets of a (K, N) weight and its (K/32, N) scales
  auto wo = [&](int l, int K, int N) { return (size_t)l * K * N; };
  auto so = [&](int l, int K, int N) { return (size_t)l * (K / 32) * N; };
  auto mo = [&](const void* p, size_t off) {
    return HM ? (const S*)p + off : nullptr;
  };

  qbembed_kernel<T, S, HM><<<B, QEMBED_THREADS, 0, st>>>(
      tok, n_past, (const signed char*)w->wte_q, (const S*)w->wte_s,
      (const S*)w->wte_m, (const T*)w->wpe, D, w->n_in_vocab, S_, x);
  int err = (int)cudaGetLastError();
  if (err) return err;
  for (int l = 0; l < L; ++l) {
    const T* ln1_g = (const T*)w->ln1_g + l * LD;
    const T* ln1_b = (const T*)w->ln1_b + l * LD;
    const T* ln2_g = (const T*)w->ln2_g + l * LD;
    const T* ln2_b = (const T*)w->ln2_b + l * LD;
    err = qbgemv<T, S, HM, EPI_PLAIN, true>(
        B, x, ln1_g, ln1_b, qkv_q + wo(l, D, 3 * D), qkv_s + so(l, D, 3 * D),
        mo(w->qkv_m, so(l, D, 3 * D)), (const T*)w->qkv_b + l * 3 * LD, D,
        3 * D, 0, 3 * D, 0, 0, 3 * D, nullptr, qkv, partial, tickets, st);
    if (err) return err;
    err = bark_launch_attn_decode_batched(
        w->dtype, qkv, kv_at(kv, l * slab, D, sizeof(T)), n_past, B, S_, D,
        w->n_head, ctx, st);
    if (err) return err;
    err = qbgemv<T, S, HM, EPI_RESID, false>(
        B, ctx, nullptr, nullptr, proj_q + wo(l, D, D), proj_s + so(l, D, D),
        mo(w->proj_m, so(l, D, D)), (const T*)w->proj_b + l * LD, D, D, 0, D,
        0, 0, D, x, x, partial, tickets, st);
    if (err) return err;
    err = qbgemv<T, S, HM, EPI_GELU, true>(
        B, x, ln2_g, ln2_b, fc_q + wo(l, D, 4 * D), fc_s + so(l, D, 4 * D),
        mo(w->fc_m, so(l, D, 4 * D)), (const T*)w->fc_b + l * 4 * LD, D,
        4 * D, 0, 4 * D, 0, 0, 4 * D, nullptr, h, partial, tickets, st);
    if (err) return err;
    err = qbgemv<T, S, HM, EPI_RESID, false>(
        B, h, nullptr, nullptr, out_q + wo(l, 4 * D, D),
        out_s + so(l, 4 * D, D), mo(w->out_m, so(l, 4 * D, D)),
        (const T*)w->out_b + l * LD, 4 * D, D, 0, D, 0, 0, D, x, x, partial,
        tickets, st);
    if (err) return err;
  }
  if (lo > 0 || hi < V) {
    err = (int)cudaMemsetAsync(logits, 0, (size_t)B * V * sizeof(float), st);
    if (err) return err;
  }
  if (hi <= lo) return 0;
  return qbgemv<T, S, HM, EPI_LOGITS, true>(
      B, x, (const T*)w->ln_f_g, (const T*)w->ln_f_b,
      (const signed char*)w->lm_q, (const S*)w->lm_s, mo(w->lm_m, 0),
      nullptr, D, w->v_pad, lo, hi, lo, hi, V, nullptr, logits, partial,
      tickets, st);
}

template <typename T>
int qbdecode_step_dt(const BarkGPTQWeights* w, int B, const int* tok,
                     const int* n_past, const BarkKV& kv, void* x, void* qkv,
                     void* ctx, void* h, float* partial,
                     unsigned int* tickets, float* logits, int lo, int hi,
                     cudaStream_t st) {
#define BARK_QBSTEP(S, HM)                                                 \
  return qbdecode_step_t<T, S, HM>(w, B, tok, n_past, kv, x, qkv, ctx, h,  \
                                   partial, tickets, logits, lo, hi, st)
  if (w->scale_dtype == BARK_F16) {
    if (w->has_min) BARK_QBSTEP(__half, true);
    BARK_QBSTEP(__half, false);
  }
  if (w->has_min) BARK_QBSTEP(float, true);
  BARK_QBSTEP(float, false);
#undef BARK_QBSTEP
}

}  // namespace

// The packed batched decode step; arguments and scratch as
// bark_decode_step_batched (csrc/bdecode.cu), int8 caches (K6a) included,
// with the `BarkGPTQWeights` of a qpack. Returns cudaGetLastError() after
// the launches (0 on success), or -1 for a shape or format the kernels do
// not take.
extern "C" int bark_qdecode_step_batched(const BarkGPTQWeights* w, int B,
                                         const int* tok, const int* n_past,
                                         void* k_cache, void* v_cache,
                                         float* k_scale, float* v_scale,
                                         void* x, void* qkv, void* ctx,
                                         void* h, float* partial,
                                         unsigned int* tickets, float* logits,
                                         int lo, int hi,
                                         cudaStream_t stream) {
  if (w->n_embd / w->n_head != 64 || w->n_embd % 64 ||
      w->v_pad % w->n_embd || B < 1 || B > MAX_LANES ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return -1;
  if (w->scale_dtype != BARK_F16 && w->scale_dtype != BARK_F32) return -1;
  const BarkKV kv{k_cache, v_cache, k_scale, v_scale};
  if (w->dtype == BARK_BF16)
    return qbdecode_step_dt<bf16>(w, B, tok, n_past, kv, x, qkv, ctx, h,
                                  partial, tickets, logits, lo, hi, stream);
  return qbdecode_step_dt<float>(w, B, tok, n_past, kv, x, qkv, ctx, h,
                                 partial, tickets, logits, lo, hi, stream);
}
