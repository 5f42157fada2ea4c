// K9/K10 sampling: the in-kernel sampler of bark_tpu/kernels/semantic.py
// `semantic_chunk_fused_batched` (`_semantic_kernel_batched`) and
// bark_tpu/kernels/window.py `coarse_window_fused_batched`
// (`_window_kernel_batched`), B lanes in one launch. The single-lane chunk
// and window (K3, K4) sample inside their one launch instead (decode.cu
// `decode_steps_kernel`).
//
// sample_rows: block b reduces lane b's logits[base : base+n] / temp +
// noise to the argmax, lowest index winning ties as jnp.argmax does, and
// in the same launch the EOS mass softmax(logits / temp')[last] (temp' =
// temp, or 0.7 at temp 0: the reference's hardcoded divide). It writes
// the token (base + index, offset-carrying for the coarse window) and the
// stop flag to device memory, so a chunk or window never waits on the
// host; the decode step that follows embeds the token from there.
//
// What bounds it: it moves at most 80 KB per lane (a 10048-wide logit row
// and its noise row), so it is bound by launch latency, not by bandwidth
// or arithmetic. The design keeps it to one block per lane and a single
// launch, with no host round trip; folding it into the batched step
// (`lane_step_kernel`), as decode.cu's step loop folds K3/K4's, is the
// next work on K9/K10.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int SAMPLE_THREADS = 1024;

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
