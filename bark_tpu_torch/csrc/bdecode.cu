// K7: one token through all layers of a GPT stage for B lanes at once.
//
// Replaces bark_tpu/kernels/decode.py `decode_step_fused_batched` (the
// Pallas kernel `_decode_kernel_batched`): per lane b, embed tok[b] at
// n_past[b] -> L x [LN1 -> fused QKV -> K/V row written at [l, b,
// n_past[b]] -> attention over that lane's rows <= n_past[b] -> proj +
// residual -> LN2 -> fc -> tanh-GELU -> out + residual] -> ln_f -> LM head
// over [lo, hi). The caches are (L, B, S, D); n_past and the tokens are
// read from device memory, so a sampled token or a per-lane slot table
// never passes through the host.
//
// What bounds it: a step streams every weight once (about 85 M values per
// bark-small stage, 170 MB in bf16) plus each lane's live cache rows, and
// does 2 FLOPs per weight per lane. Up to B ~ 16 the weight bytes bound it
// (and, as for K1, the latency of its ~62 launches); at B = 32 the 64
// f32 FMAs per weight pair of this SIMT kernel reach the card's ~20
// FLOP/byte ridge for f32 CUDA-core arithmetic, so it turns bound by
// operations there.
//
// What the design does about it: K1's split-K GEMV with the lanes folded
// in. A block holds its split of every lane's input rows in shared memory
// (LayerNormed per lane, one warp per lane for the statistics, when the
// GEMV consumes LN), and each thread keeps 2 output columns x NB lanes of
// f32 accumulators: every weight pair it loads is used for all lanes, so
// each weight is read from device memory ONCE per step for the whole batch.
// The per-lane partials of the K splits are summed by the tile's last
// block in split order, so results are deterministic, and each lane's sums
// run in K1's order. NB, the lanes a kernel is compiled for, is the
// power-of-two bucket (1, 4, 8, 16, 32) that holds B. Attention is K1's
// kernel with one block per (head, lane). The LM head LayerNorms 8
// lanes at a time into shared memory, and each warp dots its vocab rows
// with them. Not yet done: lanes as the M rows of an mma.sync/wgmma tile
// (what large B needs), CUDA graphs, a persistent kernel.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int MAX_LANES = 32;
constexpr int GEMV_COLS = 64;     // output columns per block, 2 per lane
constexpr int GEMV_WARPS = 8;     // a block's K rows are split over its warps
constexpr int GEMV_THREADS = GEMV_WARPS * 32;
constexpr int GEMV_TARGET_BLOCKS = 264;  // ~2 per SM of an H100 (132 SMs)
constexpr size_t GEMV_PARTIAL_CAP = 1 << 16;  // f32 partials of one lane
constexpr int GEMV_TICKETS = 1024;  // column tiles of one GEMV
constexpr int RED_LANES = 8;      // lanes per pass of the cross-warp sum
constexpr int STATIC_SMEM = 20 * 1024;  // static shared memory, rounded up
constexpr int EMBED_THREADS = 256;
constexpr int LM_WARPS = 8;
constexpr int LM_ROWS = 4;        // vocab rows per warp
constexpr int LM_LANES = 8;       // lanes LayerNormed per pass

enum { EPI_PLAIN = 0, EPI_GELU = 1, EPI_RESID = 2 };

// out[b] = epilogue(round(in[b] @ W) + bias) for b < B, in[b] = LN(x[b])
// when LN else x[b]. x: (B, K), W: (K, N) row-major, out/resid: (B, N);
// resid may alias out. Block (tile, split) sums rows [split*R, split*R+R)
// for the tile's 64 columns and every lane, and stores the f32 partials
// at partial[(b * splits + split) * N + n]; the tile's last block (an
// atomic ticket) sums each lane's partials in split order, applies the
// epilogue and re-arms the ticket.
template <typename T, int NB, int EPI, bool LN>
__global__ void __launch_bounds__(GEMV_THREADS)
    bgemv_kernel(const T* __restrict__ x, const T* __restrict__ ln_g,
                 const T* __restrict__ ln_b, const T* __restrict__ W,
                 const T* __restrict__ bias, int B, int K, int N, int R,
                 const T* resid, T* out, float* partial,
                 unsigned int* tickets) {
  constexpr int RL = NB < RED_LANES ? NB : RED_LANES;
  extern __shared__ float xs[];  // R x NB: xs[k * NB + b]
  __shared__ float stat[MAX_LANES][2];
  __shared__ float part[GEMV_WARPS][RL][GEMV_COLS];
  __shared__ bool last;
  const int k0 = blockIdx.y * R, rows = min(R, K - k0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (LN) {
    for (int b = warp; b < B; b += GEMV_WARPS) {
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
  const int c = blockIdx.x * GEMV_COLS + 2 * lane;
  float acc[NB][2];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b][0] = acc[b][1] = 0.0f;
  if (c < N) {  // N is even, so c + 1 < N too
    const T* wp = W + (size_t)k0 * N + c;
    int k = warp;
    for (; k + 3 * GEMV_WARPS < rows; k += 4 * GEMV_WARPS) {
      float w[8];
      load2(wp + (size_t)k * N, w[0], w[1]);
      load2(wp + (size_t)(k + GEMV_WARPS) * N, w[2], w[3]);
      load2(wp + (size_t)(k + 2 * GEMV_WARPS) * N, w[4], w[5]);
      load2(wp + (size_t)(k + 3 * GEMV_WARPS) * N, w[6], w[7]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* xr = xs + (k + r * GEMV_WARPS) * NB;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          acc[b][0] = fmaf(xr[b], w[2 * r], acc[b][0]);
          acc[b][1] = fmaf(xr[b], w[2 * r + 1], acc[b][1]);
        }
      }
    }
    for (; k < rows; k += GEMV_WARPS) {
      float w0, w1;
      load2(wp + (size_t)k * N, w0, w1);
      const float* xr = xs + k * NB;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        acc[b][0] = fmaf(xr[b], w0, acc[b][0]);
        acc[b][1] = fmaf(xr[b], w1, acc[b][1]);
      }
    }
  }
  // the warps' sums of each lane, RL lanes per pass, into the partials
  const int col = threadIdx.x % GEMV_COLS;
  const int n = blockIdx.x * GEMV_COLS + col;
#pragma unroll
  for (int g = 0; g < NB; g += RL) {
    if (g >= B) break;  // B is the same for every thread of the block
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      part[warp][r][2 * lane] = acc[g + r][0];
      part[warp][r][2 * lane + 1] = acc[g + r][1];
    }
    __syncthreads();
    for (int r = threadIdx.x / GEMV_COLS; r < RL;
         r += GEMV_THREADS / GEMV_COLS) {
      if (g + r < B && n < N) {
        float a = 0.0f;
        for (int w = 0; w < GEMV_WARPS; ++w) a += part[w][r][col];
        partial[((size_t)(g + r) * gridDim.y + blockIdx.y) * N + n] = a;
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
  for (int idx = threadIdx.x; idx < B * GEMV_COLS; idx += blockDim.x) {
    const int b = idx / GEMV_COLS;
    const int nn = blockIdx.x * GEMV_COLS + idx % GEMV_COLS;
    if (nn >= N) continue;
    float a = 0.0f;
    for (int sp = 0; sp < (int)gridDim.y; ++sp)
      a += __ldcg(partial + ((size_t)b * gridDim.y + sp) * N + nn);
    float v = round_t<T>(a);
    v = round_t<T>(v + to_f32(bias[nn]));
    if (EPI == EPI_GELU) v = round_t<T>(gelu_tanh(v));
    if (EPI == EPI_RESID) v = round_t<T>(to_f32(resid[(size_t)b * N + nn]) + v);
    out[(size_t)b * N + nn] = from_f32<T>(v);
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

// K1's split of a (K, N) GEMV over ~2 blocks per SM, splits of a multiple
// of 8 rows, launched for NB lanes.
template <typename T, int NB, int EPI, bool LN>
int bgemv_nb(int B, const T* x, const T* ln_g, const T* ln_b, const T* W,
             const T* bias, int K, int N, const T* resid, T* out,
             float* partial, unsigned int* tickets, cudaStream_t st) {
  const int tiles = (N + GEMV_COLS - 1) / GEMV_COLS;
  int splits = (GEMV_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, K / GEMV_WARPS));
  int R = (K + splits - 1) / splits;
  R = (R + GEMV_WARPS - 1) / GEMV_WARPS * GEMV_WARPS;
  splits = (K + R - 1) / R;
  if ((size_t)splits * N > GEMV_PARTIAL_CAP || tiles > GEMV_TICKETS) return -1;
  const int smem = R * NB * (int)sizeof(float);
  if (smem + STATIC_SMEM > 48 * 1024) {
    // wide models only (bark-small needs <= 19 KB); raise the window
    const int err = (int)cudaFuncSetAttribute(
        bgemv_kernel<T, NB, EPI, LN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  bgemv_kernel<T, NB, EPI, LN><<<dim3(tiles, splits), GEMV_THREADS, smem,
                                 st>>>(x, ln_g, ln_b, W, bias, B, K, N, R,
                                       resid, out, partial, tickets);
  return (int)cudaGetLastError();
}

template <typename T, int EPI, bool LN>
int bgemv(int B, const T* x, const T* ln_g, const T* ln_b, const T* W,
          const T* bias, int K, int N, const T* resid, T* out,
          float* partial, unsigned int* tickets, cudaStream_t st) {
#define BARK_BGEMV(NB)                                                    \
  return bgemv_nb<T, NB, EPI, LN>(B, x, ln_g, ln_b, W, bias, K, N, resid, \
                                  out, partial, tickets, st)
  if (B <= 1) BARK_BGEMV(1);
  if (B <= 4) BARK_BGEMV(4);
  if (B <= 8) BARK_BGEMV(8);
  if (B <= 16) BARK_BGEMV(16);
  BARK_BGEMV(32);
#undef BARK_BGEMV
}

// x[b] = wte[tok[b]] + wpe[n_past[b]], one block per lane. An out-of-range
// token or slot gives a NaN row, not a read outside the tables.
template <typename T>
__global__ void __launch_bounds__(EMBED_THREADS)
    bembed_kernel(const int* __restrict__ tok, const int* __restrict__ n_past,
                  const T* __restrict__ wte, const T* __restrict__ wpe,
                  int D, int V, int S, T* __restrict__ x) {
  const int b = blockIdx.x, t = tok[b], p = n_past[b];
  const bool ok = t >= 0 && t < V && p >= 0 && p < S;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = ok ? round_t<T>(to_f32(wte[(size_t)t * D + d]) +
                                    to_f32(wpe[(size_t)p * D + d]))
                       : NAN;
    x[(size_t)b * D + d] = from_f32<T>(v);
  }
}

// logits[b, v] = dot(LN_f(x[row b]), head[v, :]) for v in [lo, hi). Each
// warp owns LM_ROWS vocab rows; per pass, warp j LayerNorms lane b0 + j
// into shared memory and every warp dots its rows with the pass's nb lanes
// (the head rows come back from L2 on later passes). Only the nb rows of
// hs a pass wrote are read: a pass of one lane does one lane's FMAs.
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

template <typename T>
int bdecode_step_t(const BarkGPTWeights* w, int B, const int* tok,
                   const int* n_past, const BarkKV& kv, void* x_, void* qkv_,
                   void* ctx_, void* h_, float* partial,
                   unsigned int* tickets, float* logits, int lo, int hi,
                   cudaStream_t st) {
  const int L = w->n_layer, D = w->n_embd, S = w->block_size;
  const int V = w->n_out_vocab;
  const size_t LD = (size_t)D, slab = (size_t)B * S;  // rows a layer
  T* x = (T*)x_;
  T* qkv = (T*)qkv_;
  T* ctx = (T*)ctx_;
  T* h = (T*)h_;
  bembed_kernel<T><<<B, EMBED_THREADS, 0, st>>>(
      tok, n_past, (const T*)w->wte, (const T*)w->wpe, D, w->n_in_vocab, S,
      x);
  int err = (int)cudaGetLastError();
  if (err) return err;
  for (int l = 0; l < L; ++l) {
    const T* ln1_g = (const T*)w->ln1_g + l * LD;
    const T* ln1_b = (const T*)w->ln1_b + l * LD;
    const T* ln2_g = (const T*)w->ln2_g + l * LD;
    const T* ln2_b = (const T*)w->ln2_b + l * LD;
    err = bgemv<T, EPI_PLAIN, true>(
        B, x, ln1_g, ln1_b, (const T*)w->qkv_w + l * LD * 3 * D,
        (const T*)w->qkv_b + l * 3 * LD, D, 3 * D, nullptr, qkv, partial,
        tickets, st);
    if (err) return err;
    err = bark_launch_attn_decode_batched(
        w->dtype, qkv, kv_at(kv, l * slab, D, sizeof(T)), n_past, B, S, D,
        w->n_head, ctx, st);
    if (err) return err;
    err = bgemv<T, EPI_RESID, false>(
        B, ctx, nullptr, nullptr, (const T*)w->proj_w + l * LD * D,
        (const T*)w->proj_b + l * LD, D, D, x, x, partial, tickets, st);
    if (err) return err;
    err = bgemv<T, EPI_GELU, true>(
        B, x, ln2_g, ln2_b, (const T*)w->fc_w + l * LD * 4 * D,
        (const T*)w->fc_b + l * 4 * LD, D, 4 * D, nullptr, h, partial,
        tickets, st);
    if (err) return err;
    err = bgemv<T, EPI_RESID, false>(
        B, h, nullptr, nullptr, (const T*)w->out_w + l * LD * 4 * D,
        (const T*)w->out_b + l * LD, 4 * D, D, x, x, partial, tickets, st);
    if (err) return err;
  }
  if (lo > 0 || hi < V) {
    err = (int)cudaMemsetAsync(logits, 0, (size_t)B * V * sizeof(float), st);
    if (err) return err;
  }
  return blm_head_t<T>(w, x, nullptr, B, logits, lo, hi, st);
}

}  // namespace

extern "C" int bark_launch_lm_head_batched(const BarkGPTWeights* w,
                                           const void* x, const int* rows,
                                           int B, float* logits, int lo,
                                           int hi, cudaStream_t stream) {
  if (w->dtype == BARK_BF16)
    return blm_head_t<bf16>(w, x, rows, B, logits, lo, hi, stream);
  return blm_head_t<float>(w, x, rows, B, logits, lo, hi, stream);
}

// Returns cudaGetLastError() after the launches (0 on success; -1 for a
// shape the kernels do not take). tok and n_past are B int32 each in
// device memory; k_cache and v_cache the stage's (L, B, S, D) caches, row
// n_past[b] of lane b of every layer written in place (int8 with the
// (L, B, S) f32 row scales k_scale and v_scale when given: K6a); x (B, D), qkv
// (B, 3D), ctx (B, D) and h (B, 4D) caller-allocated scratch in the params
// dtype, partial B * 65536 f32 of scratch, tickets 1024 zeroed uint32
// (left zeroed); logits (B, n_out_vocab) f32, zero outside [lo, hi).
extern "C" int bark_decode_step_batched(const BarkGPTWeights* w, int B,
                                        const int* tok, const int* n_past,
                                        void* k_cache, void* v_cache,
                                        float* k_scale, float* v_scale,
                                        void* x, void* qkv, void* ctx, void* h,
                                        float* partial, unsigned int* tickets,
                                        float* logits, int lo, int hi,
                                        cudaStream_t stream) {
  if (w->n_embd / w->n_head != 64 || w->n_embd % GEMV_COLS || B < 1 ||
      B > MAX_LANES || (k_scale == nullptr) != (v_scale == nullptr))
    return -1;
  const BarkKV kv{k_cache, v_cache, k_scale, v_scale};
  if (w->dtype == BARK_BF16)
    return bdecode_step_t<bf16>(w, B, tok, n_past, kv, x, qkv, ctx, h,
                                partial, tickets, logits, lo, hi, stream);
  return bdecode_step_t<float>(w, B, tok, n_past, kv, x, qkv, ctx, h,
                               partial, tickets, logits, lo, hi, stream);
}
