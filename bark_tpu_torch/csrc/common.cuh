// Shared definitions for the hand-written Hopper kernels of bark_tpu_torch.
//
// The kernels are compiled by nvcc into one shared library with a plain C
// interface (kernels/_build.py) and called through ctypes. Every kernel is
// templated on the params dtype T (float or __nv_bfloat16) and computes in
// f32, rounding to T exactly where the reference does (models/gpt.py):
// after every projection's f32 accumulate, after the bias add, after GELU,
// after the residual add, after LayerNorm, and on the attention weights
// before the context product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// dtype codes shared with kernels/_build.py
#define BARK_F32 0
#define BARK_BF16 1
#define BARK_F16 2  // scales and mins of packed weights only

#define BARK_EPS_NORM 1e-5f

// Ceiling division, for grid sizes.
inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Device pointers of one GPT stage's dense params, in the layouts of
// models/gpt.py (stacked along a leading layer axis). Only the first wte
// table and the first LM head are used by the causal stages.
struct BarkGPTWeights {
  const void* wte;      // (n_in_vocab, D)
  const void* wpe;      // (block_size, D)
  const void* ln1_g;    // (L, D)
  const void* ln1_b;
  const void* ln2_g;
  const void* ln2_b;
  const void* qkv_w;    // (L, D, 3D)
  const void* qkv_b;    // (L, 3D)
  const void* proj_w;   // (L, D, D)
  const void* proj_b;   // (L, D)
  const void* fc_w;     // (L, D, 4D)
  const void* fc_b;     // (L, 4D)
  const void* out_w;    // (L, 4D, D)
  const void* out_b;    // (L, D)
  const void* ln_f_g;   // (D,)
  const void* ln_f_b;
  const void* lm_head;  // (n_out_vocab, D)
  int n_layer;
  int n_head;
  int n_embd;
  int block_size;
  int n_in_vocab;
  int n_out_vocab;
  int dtype;            // BARK_F32 or BARK_BF16
};

// Device pointers of one GPT stage's packed-quantized params (a qpack of
// io/loader.py): int8 values with per-32-row scales and, when has_min,
// mins, blocked along each weight's input axis; norms, biases and wpe
// dense in the params dtype. Mins are null when has_min is 0.
struct BarkGPTQWeights {
  const void* wte_q;    // (n_in_vocab, D) int8
  const void* wte_s;    // (n_in_vocab, D/32) scales
  const void* wte_m;
  const void* wpe;      // (block_size, D)
  const void* ln1_g;    // (L, D)
  const void* ln1_b;
  const void* ln2_g;
  const void* ln2_b;
  const void* qkv_q;    // (L, D, 3D) int8
  const void* qkv_s;    // (L, D/32, 3D)
  const void* qkv_m;
  const void* qkv_b;    // (L, 3D)
  const void* proj_q;   // (L, D, D)
  const void* proj_s;
  const void* proj_m;
  const void* proj_b;
  const void* fc_q;     // (L, D, 4D)
  const void* fc_s;
  const void* fc_m;
  const void* fc_b;
  const void* out_q;    // (L, 4D, D)
  const void* out_s;    // (L, 4D/32, D)
  const void* out_m;
  const void* out_b;
  const void* ln_f_g;   // (D,)
  const void* ln_f_b;
  const void* lm_q;     // (D, v_pad) int8, the LM head transposed and
  const void* lm_s;     // (D/32, v_pad)        zero-padded
  const void* lm_m;
  int n_layer;
  int n_head;
  int n_embd;
  int block_size;
  int n_in_vocab;
  int n_out_vocab;
  int v_pad;            // ceil(n_out_vocab / n_embd) * n_embd
  int dtype;            // BARK_F32 or BARK_BF16
  int scale_dtype;      // BARK_F16 or BARK_F32
  int has_min;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// a packed weight's scale or min (f16 or f32) as f32
__device__ __forceinline__ float s_to_f32(float v) { return v; }
__device__ __forceinline__ float s_to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to the params dtype and back: one cast point of the
// reference.
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f32(from_f32<T>(v));
}

// tanh-approximate GELU, the formula of jax.nn.gelu(approximate=True) and
// torch's gelu(approximate="tanh"), in f32.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k_beta = 0.7978845608028654f;  // sqrt(2/pi)
  const float k_kappa = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k_beta * (x + k_kappa * x * x * x)));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum; every thread gets the total. `red` is >= 32 floats of
// shared memory. Safe to call repeatedly with the same `red`.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float t = lane < nw ? red[lane] : 0.0f;
  return warp_sum(t);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float t = lane < nw ? red[lane] : -INFINITY;
  return warp_max(t);
}

// LayerNorm of one (D,) row into shared memory, as models/gpt.layer_norm:
// mean and variance in f32, eps inside the square root, affine in f32, and
// the result rounded to T (stored back as f32 in `out`). `out` is D floats
// of shared memory, `red` 32 floats.
template <typename T>
__device__ void block_layer_norm(const T* x, const T* g, const T* b,
                                 float* out, int D, float* red) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = to_f32(x[i]);
    out[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / (float)D;
  float sq = 0.0f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = out[i] - mean;
    sq += d * d;
  }
  const float var = block_sum(sq, red) / (float)D;
  const float inv = 1.0f / sqrtf(var + BARK_EPS_NORM);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float y = (out[i] - mean) * inv;
    out[i] = round_t<T>(y * to_f32(g[i]) + to_f32(b[i]));
  }
  __syncthreads();
}

// LayerNorm statistics of one (K,) row computed by one warp (no block
// barrier, so every warp of a block can take its own row): the mean and
// 1/sqrt(var + eps), both passes in f32.
template <typename T>
__device__ __forceinline__ void warp_ln_stats(const T* x, int K, float& mean,
                                              float& inv) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int i = lane; i < K; i += 32) s += to_f32(x[i]);
  mean = warp_sum(s) / (float)K;
  float sq = 0.0f;
  for (int i = lane; i < K; i += 32) {
    const float d = to_f32(x[i]) - mean;
    sq += d * d;
  }
  inv = 1.0f / sqrtf(warp_sum(sq) / (float)K + BARK_EPS_NORM);
}

// Two consecutive values of a row as f32 (p 4-byte aligned for bf16, 8-byte
// for f32).
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const bf16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}

// 8 consecutive values of a row as f32, from one 16-byte (bf16) or two
// 16-byte (f32) loads; p is 16-byte aligned.
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __low2float(h[i]);
    v[2 * i + 1] = __high2float(h[i]);
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// ------------------------------------------------------------ int8 KV (K6)

// One slab of a stage's KV caches (a layer's, or a layer's B lanes'): the
// K and V values in the params dtype, or int8 when the f32 row scales ks
// and vs are given (the `{"q", "s"}` caches of models/gpt.init_kv_cache
// with quant=True, dequantized as q * s).
struct BarkKV {
  void* k;
  void* v;
  float* ks;  // null for a dense cache
  float* vs;
};

// The slab `rows` cache rows (of D values, `elem` bytes each when dense)
// past the start of `c`: layer l of an (L, [B,] S, D) cache is
// kv_at(c, l * [B *] S, ...).
inline BarkKV kv_at(const BarkKV& c, size_t rows, int D, size_t elem) {
  const size_t bytes = rows * D * (c.ks != nullptr ? 1 : elem);
  return {(char*)c.k + bytes, (char*)c.v + bytes,
          c.ks != nullptr ? c.ks + rows : nullptr,
          c.vs != nullptr ? c.vs + rows : nullptr};
}

// Per-row symmetric int8 quantization, models/gpt.quantize_kv_rows: the
// scale is amax / 127 (a true division: no fast-math flags are used), its
// inverse 1 / s (0 for a zero row), and a value is round-half-even(x * inv)
// clipped to +-127.
__device__ __forceinline__ float i8_scale(float amax) { return amax / 127.0f; }
__device__ __forceinline__ float i8_inv(float s) {
  return s > 0.0f ? 1.0f / s : 0.0f;
}
__device__ __forceinline__ signed char quant_i8(float x, float inv) {
  const float r = rintf(__fmul_rn(x, inv));
  return (signed char)(int)fminf(fmaxf(r, -127.0f), 127.0f);
}

// Host-side launchers shared between translation units (all return
// cudaGetLastError() of their launches).
extern "C" int bark_launch_lm_head(const BarkGPTWeights* w, const void* x_row,
                                   float* logits, int lo, int hi,
                                   cudaStream_t stream);
// K7's attention: K1's (or K6a's) for B lanes, lane b's (S, D) cache slab
// at S * b rows into `kv`, its qkv row b of (B, 3D), its context row b of
// (B, D), at its own slot n_past[b] (B ints in device memory).
extern "C" int bark_launch_attn_decode_batched(int dtype, const void* qkv,
                                               BarkKV kv, const int* n_past,
                                               int B, int S, int D,
                                               int n_head, void* ctx,
                                               cudaStream_t stream);
// K7's LM head for B rows of x (row rows[b] of x for lane b when rows is
// not null, else row b) into logits (B, n_out_vocab) over [lo, hi); the
// columns outside are left as they were.
extern "C" int bark_launch_lm_head_batched(const BarkGPTWeights* w,
                                           const void* x, const int* rows,
                                           int B, float* logits, int lo,
                                           int hi, cudaStream_t stream);
