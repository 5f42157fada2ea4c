// K3/K4 sampling and embedding: the in-kernel sampler and token embed of
// bark_tpu/kernels/semantic.py `semantic_chunk_fused` (`_semantic_kernel`)
// and bark_tpu/kernels/window.py `coarse_window_fused` (`_window_kernel`);
// the sampler also serves B lanes in one launch for K9 and K10, the
// batched kernels (`_semantic_kernel_batched`, `_window_kernel_batched`).
//
// sample_rows: block b reduces lane b's logits[base : base+n] / temp +
// noise to the argmax, lowest index winning ties as jnp.argmax does, and
// in the same launch the EOS mass softmax(logits / temp')[last] (temp' =
// temp, or 0.7 at temp 0: the reference's hardcoded divide). It writes
// the token (base + index, offset-carrying for the coarse window) and the
// stop flag to device memory, so a chunk or window never waits on the
// host.
//
// embed_token: x = wte[tok] + wpe[n_past], reading tok from device memory.
//
// What bounds them: neither moves more than 40 KB per lane (a 10048-wide
// logit row and its noise row, or one embedding row), so both are bound by
// launch latency, not by bandwidth or arithmetic. The design keeps each to
// one block per lane and a single launch, with no host round trip;
// removing the launches altogether (folding them into the decode step, or a CUDA graph
// over the whole chunk) is later work.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int SAMPLE_THREADS = 1024;
constexpr int EMBED_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(EMBED_THREADS)
    embed_token_kernel(const int* __restrict__ tok, const T* __restrict__ wte,
                       const T* __restrict__ wpe, int n_past, int D, int V,
                       T* __restrict__ x) {
  const int t = *tok;
  const bool ok = t >= 0 && t < V;  // an out-of-range token gives NaN, not a
                                    // read outside the table
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v =
        ok ? round_t<T>(to_f32(wte[(size_t)t * D + d]) +
                        to_f32(wpe[(size_t)n_past * D + d]))
           : NAN;
    x[d] = from_f32<T>(v);
  }
}

// (value, index) argmax step: the larger value wins, the lower index on a
// tie; index INT_MAX marks "nothing seen yet".
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (oi == INT_MAX) return;
  if (i == INT_MAX || ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(SAMPLE_THREADS)
    sample_rows_kernel(const float* __restrict__ logits, int ld_logits,
                       int base, int n, const float* __restrict__ noise,
                       int ld_noise, float temp, int with_eos, int stop_token,
                       float min_eos_p, int* __restrict__ tok_out,
                       int* __restrict__ flag_out) {
  logits += (size_t)blockIdx.x * ld_logits;
  if (noise != nullptr) noise += (size_t)blockIdx.x * ld_noise;
  __shared__ float rv[32];
  __shared__ int ri[32];
  __shared__ float red[32];
  __shared__ float last_e;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float best = -INFINITY;
  int bi = INT_MAX;
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float l = logits[base + i];
    float c, e;
    if (temp != 0.0f) {
      e = l / temp;
      c = e + noise[i];
    } else {
      c = l;
      e = l / 0.7f;
    }
    argmax_merge(best, bi, c, i);
    mx = fmaxf(mx, e);
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    argmax_merge(best, bi, ov, oi);
  }
  if (lane == 0) {
    rv[warp] = best;
    ri[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    best = lane < nw ? rv[lane] : -INFINITY;
    bi = lane < nw ? ri[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      argmax_merge(best, bi, ov, oi);
    }
  }
  // the winner is in warp 0's lanes; keep it for thread 0
  float eos_p = 0.0f;
  if (with_eos) {
    mx = block_max(mx, red);
    float sum = 0.0f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float l = logits[base + i];
      const float e = expf((temp != 0.0f ? l / temp : l / 0.7f) - mx);
      if (i == n - 1) last_e = e;
      sum += e;
    }
    sum = block_sum(sum, red);  // its barriers also publish last_e
    eos_p = last_e / sum;
  }
  if (threadIdx.x == 0) {
    const int tok = base + (bi == INT_MAX ? 0 : bi);
    tok_out[blockIdx.x] = tok;
    if (flag_out != nullptr)
      flag_out[blockIdx.x] =
          (int)(with_eos && (tok == stop_token || eos_p >= min_eos_p));
  }
}

}  // namespace

extern "C" int bark_launch_embed_token(const BarkGPTWeights* w,
                                       const int* tok, int n_past, void* x,
                                       cudaStream_t stream) {
  if (w->dtype == BARK_BF16)
    embed_token_kernel<bf16><<<1, EMBED_THREADS, 0, stream>>>(
        tok, (const bf16*)w->wte, (const bf16*)w->wpe, n_past, w->n_embd,
        w->n_in_vocab, (bf16*)x);
  else
    embed_token_kernel<float><<<1, EMBED_THREADS, 0, stream>>>(
        tok, (const float*)w->wte, (const float*)w->wpe, n_past, w->n_embd,
        w->n_in_vocab, (float*)x);
  return (int)cudaGetLastError();
}

// For each lane b < B, with its logits row at logits + b * ld_logits and
// its noise row at noise + b * ld_noise: tok_out[b] = base +
// argmax(logits[base:base+n] / temp + noise[0:n]) (argmax of the logits at
// temp 0; noise may be null then). With with_eos, flag_out[b] = tok ==
// stop_token or softmax(logits[base:base+n] / temp')[n-1] >= min_eos_p.
// flag_out may be null.
extern "C" int bark_sample_rows(const float* logits, int ld_logits, int base,
                                int n, const float* noise, int ld_noise,
                                float temp, int with_eos, int stop_token,
                                float min_eos_p, int B, int* tok_out,
                                int* flag_out, cudaStream_t stream) {
  if (n <= 0 || B <= 0 || (temp != 0.0f && noise == nullptr)) return -1;
  sample_rows_kernel<<<B, SAMPLE_THREADS, 0, stream>>>(
      logits, ld_logits, base, n, noise, ld_noise, temp, with_eos, stop_token,
      min_eos_p, tok_out, flag_out);
  return (int)cudaGetLastError();
}
