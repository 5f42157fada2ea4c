// K5: the decode step (K1) on packed-quantized weights.
//
// Replaces the `quant=True` path of bark_tpu/kernels/decode.py
// `decode_step_fused`: the tile dequant of `_tile_stream` (int8 values times
// per-32-row scales, cast to the params dtype), `_qdot` (the product in f32
// plus the exact min term blocksums(x) @ mins of the offset formats) and
// `_embed_token` (one wte row dequantized, + wpe). The same kernels serve
// K3 and K4 (`semantic_chunk_fused`, `coarse_window_fused` with
// quant=True), whose steps are then K5 launches. Weights: int8 values (L, K, N)
// with scales and mins (L, K/32, N) in f16 (q4_0/q4_1/q5_0/q5_1/q8_0) or
// f32 (q4_k/q5_k); the LM head is the transposed, zero-padded (D, v_pad)
// tile; wte rows are blocked along D.
//
// What bounds it: at batch 1 a step reads every weight once and does 2
// FLOPs per weight. A bark-small q8_0/q4_0 step streams ~85 M int8 values
// plus 5.3 MB of f16 scales, the LM head's 7.7 M values and the live KV
// rows: ~110 MB, ~33 us at 3.35 TB/s, against ~200 MB for the bf16 K1 step.
// Like K1 it is far below the card's FLOP/byte ridge, so it is bound by
// bytes, and at this size by per-kernel latency as much (PERF.md).
//
// What the design does about it: a launch chain (embed, 5 per layer, LM
// head; attention is the standalone kernel of csrc/decode.cu), one C call
// per step, with packed GEMVs (K1 was this chain until it became one
// persistent kernel a step; K5 is the next to follow it). Each lane owns 4 neighbouring
// output columns and reads them as one 4-byte char4 per weight row (a
// warp: 128 contiguous bytes), and one 8- or 16-byte load of their 4
// scales per 32-row block. The dequantized value q*s is rounded to the
// params dtype exactly where the reference rounds the tile, then FMA'd in
// f32. Splits over K start on 32-row boundaries, so a split's block sums
// of x (computed once in shared memory, beside x) pair with whole rows of
// mins: warp b%8 adds blocksum_b * m[b, col] to its partial. The last
// block of a column tile (an atomic ticket) sums the partials in a fixed
// order and applies the epilogue. The
// LM head launches only the column tiles that cover [lo, hi) and writes
// only those logits, so the zero v_pad columns are never logits. Not yet
// done: dequantizing to bf16 pairs with packed math, tensor cores, a
// persistent kernel.
#include <algorithm>

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int QG_COLS = 128;    // output columns per block, 4 per lane
constexpr int QG_WARPS = 8;     // each warp takes rows w, w+8, w+16, w+24
constexpr int QG_THREADS = QG_WARPS * 32;  // of every 32-row block
constexpr int QG_TARGET_BLOCKS = 264;  // ~2 per SM of an H100 (132 SMs)
constexpr size_t QG_PARTIAL_CAP = 1 << 16;  // f32 partials of one GEMV
constexpr int QG_TICKETS = 1024;   // column tiles of one GEMV
constexpr int QEMBED_THREADS = 256;

enum { EPI_PLAIN = 0, EPI_GELU = 1, EPI_RESID = 2, EPI_LOGITS = 3 };

__device__ __forceinline__ float s_to_f32(float v) { return v; }
__device__ __forceinline__ float s_to_f32(__half v) { return __half2float(v); }

// the 4 scales (or mins) of columns c..c+3 of one block row
__device__ __forceinline__ void load_s4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_s4(const __half* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
  const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// One weight: q * s in f32, rounded to T (the dequantized tile's dtype).
template <typename T>
__device__ __forceinline__ float deq(signed char q, float s) {
  return round_t<T>(__fmul_rn((float)q, s));
}

// out = epilogue(round(in @ Wdq) + bias), in = LN(x) when LN else x, for
// the columns of tiles [n0 / 128, n0 / 128 + gridDim.x). Wdq[k, n] =
// round_T(q[k, n] * s[k/32, n]) (+ the min term below); x: (K,),
// q: (K, N) int8, s/m: (K/32, N). EPI_LOGITS writes the f32 sums as they
// are to out[n] for n in [lo, hi) only.
//
// Split over K: block (tile, split) sums rows [split*R, split*R + R) (R a
// multiple of 32) and stores its f32 partials at
// partial[split * ncols + n - n0]; each block then takes an atomic ticket
// of its tile, and the last to arrive sums the tile's partials in split
// order, applies the epilogue and resets the ticket.
template <typename T, typename S, bool HAS_MIN, int EPI, bool LN>
__global__ void __launch_bounds__(QG_THREADS)
    qgemv_kernel(const T* __restrict__ x, const T* __restrict__ ln_g,
                 const T* __restrict__ ln_b, const signed char* __restrict__ q,
                 const S* __restrict__ s, const S* __restrict__ m,
                 const T* __restrict__ bias, int K, int N, int R, int n0,
                 int ncols, int lo, int hi, const T* resid, void* out,
                 float* partial, unsigned int* tickets) {
  extern __shared__ float xs[];  // R floats: this split's input rows, then
                                 // R/32 block sums of them (HAS_MIN)
  float* bsum = xs + R;
  __shared__ float red[32];
  __shared__ float part[QG_WARPS][QG_COLS];
  __shared__ bool last;
  const int k0 = blockIdx.y * R, rows = min(R, K - k0);
  if (LN) {
    float sm = 0.0f;
    for (int i = threadIdx.x; i < K; i += blockDim.x) sm += to_f32(x[i]);
    const float mean = block_sum(sm, red) / (float)K;
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
  const int nb = rows / 32;
  if (HAS_MIN) {
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      float t = 0.0f;
      for (int i = 0; i < 32; ++i) t += xs[b * 32 + i];
      bsum[b] = t;
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = n0 + blockIdx.x * QG_COLS + 4 * lane;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (c < N) {  // N is a multiple of 4, so c + 3 < N too
    const int b0 = k0 / 32;
    for (int b = 0; b < nb; ++b) {
      const signed char* qp = q + (size_t)(k0 + b * 32 + warp) * N + c;
      char4 w[4];
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const char4*>(qp + (size_t)(8 * j) * N);
      float sc[4];
      load_s4(s + (size_t)(b0 + b) * N + c, sc);
      for (int j = 0; j < 4; ++j) {
        const float xv = xs[b * 32 + warp + 8 * j];
        a[0] = fmaf(xv, deq<T>(w[j].x, sc[0]), a[0]);
        a[1] = fmaf(xv, deq<T>(w[j].y, sc[1]), a[1]);
        a[2] = fmaf(xv, deq<T>(w[j].z, sc[2]), a[2]);
        a[3] = fmaf(xv, deq<T>(w[j].w, sc[3]), a[3]);
      }
      if (HAS_MIN && b % QG_WARPS == warp) {
        float mn[4];
        load_s4(m + (size_t)(b0 + b) * N + c, mn);
        for (int i = 0; i < 4; ++i) a[i] = fmaf(bsum[b], mn[i], a[i]);
      }
    }
  }
  for (int i = 0; i < 4; ++i) part[warp][4 * lane + i] = a[i];
  __syncthreads();
  const int n = n0 + blockIdx.x * QG_COLS + threadIdx.x;
  const size_t pi = (size_t)(n - n0);
  if (threadIdx.x < QG_COLS && n < N) {
    float acc = 0.0f;
    for (int w = 0; w < QG_WARPS; ++w) acc += part[w][threadIdx.x];
    partial[(size_t)blockIdx.y * ncols + pi] = acc;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x < QG_COLS && n < N) {
    float acc = 0.0f;
    for (int sp = 0; sp < (int)gridDim.y; ++sp)
      acc += __ldcg(partial + (size_t)sp * ncols + pi);
    if (EPI == EPI_LOGITS) {
      if (n >= lo && n < hi) ((float*)out)[n] = acc;
    } else {
      float v = round_t<T>(acc);
      v = round_t<T>(v + to_f32(bias[n]));
      if (EPI == EPI_GELU) v = round_t<T>(gelu_tanh(v));
      if (EPI == EPI_RESID) v = round_t<T>(to_f32(resid[n]) + v);
      ((T*)out)[n] = from_f32<T>(v);
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

// Launch one packed GEMV over the column tiles covering [n0, n1), n0 a
// multiple of 128: ~2 blocks per SM, splits of a multiple of 32 rows.
template <typename T, typename S, bool HAS_MIN, int EPI, bool LN>
int qgemv(const T* x, const T* ln_g, const T* ln_b, const signed char* q,
          const S* s, const S* m, const T* bias, int K, int N, int n0,
          int n1, int lo, int hi, const T* resid, void* out, float* partial,
          unsigned int* tickets, cudaStream_t st) {
  if (K % 32 || N % 4 || n0 % QG_COLS) return -1;
  const int tiles = cdiv(n1 - n0, QG_COLS), ncols = tiles * QG_COLS;
  int splits = cdiv(QG_TARGET_BLOCKS, tiles);
  splits = std::max(1, std::min(splits, K / 32));
  const int R = cdiv(cdiv(K, splits), 32) * 32;
  splits = cdiv(K, R);
  if ((size_t)splits * ncols > QG_PARTIAL_CAP || tiles > QG_TICKETS) return -1;
  qgemv_kernel<T, S, HAS_MIN, EPI, LN>
      <<<dim3(tiles, splits), QG_THREADS, (R + R / 32) * sizeof(float), st>>>(
          x, ln_g, ln_b, q, s, m, bias, K, N, R, n0, ncols, lo, hi, resid,
          out, partial, tickets);
  return (int)cudaGetLastError();
}

// x = round_T(round_T(q[tok] * s[tok] [+ m[tok]]) + wpe[n_past]), the
// token read from device memory; the dequantized row is bit-equal to the
// densified wte that the prefill reads.
template <typename T, typename S, bool HAS_MIN>
__global__ void __launch_bounds__(QEMBED_THREADS)
    qembed_kernel(const int* __restrict__ tok,
                  const signed char* __restrict__ wq, const S* __restrict__ ws,
                  const S* __restrict__ wm, const T* __restrict__ wpe,
                  int n_past, int D, int V, T* __restrict__ x) {
  const int t = *tok;
  const bool ok = t >= 0 && t < V;  // an out-of-range token gives NaN, not a
                                    // read outside the table
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float v = NAN;
    if (ok) {
      const size_t sb = (size_t)t * (D / 32) + d / 32;
      float w = __fmul_rn((float)wq[(size_t)t * D + d], s_to_f32(ws[sb]));
      if (HAS_MIN) w = __fadd_rn(w, s_to_f32(wm[sb]));
      v = round_t<T>(round_t<T>(w) + to_f32(wpe[(size_t)n_past * D + d]));
    }
    x[d] = from_f32<T>(v);
  }
}

template <typename T, typename S, bool HM>
int qdecode_step_t(const BarkGPTQWeights* w, const int* tok, int n_past,
                   const BarkKV& kv, void* x_, void* qkv_, void* ctx_,
                   void* h_, float* partial, unsigned int* tickets,
                   float* logits, int lo, int hi, cudaStream_t st) {
  const int L = w->n_layer, D = w->n_embd, S_ = w->block_size;
  const int V = w->n_out_vocab;
  const size_t LD = (size_t)D;
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
  const S* qkv_m = (const S*)w->qkv_m;
  const S* proj_m = (const S*)w->proj_m;
  const S* fc_m = (const S*)w->fc_m;
  const S* out_m = (const S*)w->out_m;
  // per-layer offsets of a (K, N) weight and its (K/32, N) scales
  auto wo = [&](int l, int K, int N) { return (size_t)l * K * N; };
  auto so = [&](int l, int K, int N) { return (size_t)l * (K / 32) * N; };
  auto mo = [&](const S* p, size_t off) { return HM ? p + off : nullptr; };

  qembed_kernel<T, S, HM><<<1, QEMBED_THREADS, 0, st>>>(
      tok, (const signed char*)w->wte_q, (const S*)w->wte_s,
      (const S*)w->wte_m, (const T*)w->wpe, n_past, D, w->n_in_vocab, x);
  int err = (int)cudaGetLastError();
  if (err) return err;
  for (int l = 0; l < L; ++l) {
    const T* ln1_g = (const T*)w->ln1_g + l * LD;
    const T* ln1_b = (const T*)w->ln1_b + l * LD;
    const T* ln2_g = (const T*)w->ln2_g + l * LD;
    const T* ln2_b = (const T*)w->ln2_b + l * LD;
    err = qgemv<T, S, HM, EPI_PLAIN, true>(
        x, ln1_g, ln1_b, qkv_q + wo(l, D, 3 * D), qkv_s + so(l, D, 3 * D),
        mo(qkv_m, so(l, D, 3 * D)), (const T*)w->qkv_b + l * 3 * LD, D,
        3 * D, 0, 3 * D, 0, 0, nullptr, qkv, partial, tickets, st);
    if (err) return err;
    err = bark_launch_attn_decode(w->dtype, qkv,
                                  kv_at(kv, (size_t)l * S_, D, sizeof(T)),
                                  n_past, D, w->n_head, ctx, st);
    if (err) return err;
    err = qgemv<T, S, HM, EPI_RESID, false>(
        ctx, nullptr, nullptr, proj_q + wo(l, D, D), proj_s + so(l, D, D),
        mo(proj_m, so(l, D, D)), (const T*)w->proj_b + l * LD, D, D, 0, D, 0,
        0, x, x, partial, tickets, st);
    if (err) return err;
    err = qgemv<T, S, HM, EPI_GELU, true>(
        x, ln2_g, ln2_b, fc_q + wo(l, D, 4 * D), fc_s + so(l, D, 4 * D),
        mo(fc_m, so(l, D, 4 * D)), (const T*)w->fc_b + l * 4 * LD, D, 4 * D,
        0, 4 * D, 0, 0, nullptr, h, partial, tickets, st);
    if (err) return err;
    err = qgemv<T, S, HM, EPI_RESID, false>(
        h, nullptr, nullptr, out_q + wo(l, 4 * D, D), out_s + so(l, 4 * D, D),
        mo(out_m, so(l, 4 * D, D)), (const T*)w->out_b + l * LD, 4 * D, D, 0,
        D, 0, 0, x, x, partial, tickets, st);
    if (err) return err;
  }
  if (lo > 0 || hi < V) {
    err = (int)cudaMemsetAsync(logits, 0, V * sizeof(float), st);
    if (err) return err;
  }
  if (hi <= lo) return 0;
  const int n0 = lo / QG_COLS * QG_COLS;
  return qgemv<T, S, HM, EPI_LOGITS, true>(
      x, (const T*)w->ln_f_g, (const T*)w->ln_f_b,
      (const signed char*)w->lm_q, (const S*)w->lm_s,
      HM ? (const S*)w->lm_m : nullptr, nullptr, D, w->v_pad, n0, hi, lo, hi,
      nullptr, logits, partial, tickets, st);
}

template <typename T>
int qdecode_step_dt(const BarkGPTQWeights* w, const int* tok, int n_past,
                    const BarkKV& kv, void* x, void* qkv, void* ctx, void* h,
                    float* partial, unsigned int* tickets, float* logits,
                    int lo, int hi, cudaStream_t st) {
  if (w->scale_dtype == BARK_F16) {
    if (w->has_min)
      return qdecode_step_t<T, __half, true>(w, tok, n_past, kv, x, qkv, ctx,
                                             h, partial, tickets, logits, lo,
                                             hi, st);
    return qdecode_step_t<T, __half, false>(w, tok, n_past, kv, x, qkv, ctx,
                                            h, partial, tickets, logits, lo,
                                            hi, st);
  }
  if (w->has_min)
    return qdecode_step_t<T, float, true>(w, tok, n_past, kv, x, qkv, ctx, h,
                                          partial, tickets, logits, lo, hi,
                                          st);
  return qdecode_step_t<T, float, false>(w, tok, n_past, kv, x, qkv, ctx, h,
                                         partial, tickets, logits, lo, hi,
                                         st);
}

}  // namespace

// The packed decode step: the token in device memory, n_past, the stage's
// (L, S, D) caches (int8 with row scales for K6a, as bark_decode_step's),
// scratch x (D), qkv (3D), ctx (D), h (4D) in the params dtype, partial
// (65536 f32), tickets (1024 zeroed uint32, left zeroed), and the logits
// over [lo, hi), zero outside. Returns cudaGetLastError()
// after the launches (0 on success), or -1 for a shape or format the
// kernels do not take.
extern "C" int bark_qdecode_step(const BarkGPTQWeights* w, const int* tok,
                                 int n_past, void* k_cache, void* v_cache,
                                 float* k_scale, float* v_scale, void* x,
                                 void* qkv, void* ctx, void* h,
                                 float* partial, unsigned int* tickets,
                                 float* logits, int lo, int hi,
                                 cudaStream_t stream) {
  if (w->n_embd / w->n_head != 64 || w->n_embd % 64 || w->v_pad % w->n_embd)
    return -1;
  if (w->scale_dtype != BARK_F16 && w->scale_dtype != BARK_F32) return -1;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return -1;
  const BarkKV kv{k_cache, v_cache, k_scale, v_scale};
  if (w->dtype == BARK_BF16)
    return qdecode_step_dt<bf16>(w, tok, n_past, kv, x, qkv, ctx, h, partial,
                                 tickets, logits, lo, hi, stream);
  return qdecode_step_dt<float>(w, tok, n_past, kv, x, qkv, ctx, h, partial,
                                tickets, logits, lo, hi, stream);
}
