// K9 and K10's batched step loop for f32 params: bloop.cuh's entries for
// T = float, which bloop.cu's extern "C" entries call. A source of its own
// so that nvcc builds these 5 instances beside bloop.cu's 5.
#include "bloop.cuh"

extern "C" int bark_lane_steps_blocks_f32(int scale_dtype, int has_min,
                                          int D, int S) {
  return lane_steps_blocks_for<float>(scale_dtype, has_min, D, S);
}

extern "C" int bark_lane_steps_f32(const BarkGPTWeights* w,
                                   const void* const* tiles, const int* plan,
                                   int blocks, int B, const BarkLaneLoop* lp,
                                   void* k_cache, void* v_cache,
                                   float* k_scale, float* v_scale,
                                   float* work, long long work_floats,
                                   int cap, unsigned* sync, float* logits,
                                   cudaStream_t stream) {
  return lane_steps_for<float>(w, tiles, plan, blocks, B, lp, k_cache,
                               v_cache, k_scale, v_scale, work, work_floats,
                               cap, sync, logits, stream);
}

extern "C" int bark_lane_steps_packed_f32(
    const BarkGPTQWeights* w, const void* const* tiles, const int* plan,
    int blocks, int B, const BarkLaneLoop* lp, void* k_cache, void* v_cache,
    float* k_scale, float* v_scale, float* work, long long work_floats,
    int cap, unsigned* sync, float* logits, cudaStream_t stream) {
  return lane_steps_packed_for<float>(w, tiles, plan, blocks, B, lp, k_cache,
                                      v_cache, k_scale, v_scale, work,
                                      work_floats, cap, sync, logits, stream);
}
