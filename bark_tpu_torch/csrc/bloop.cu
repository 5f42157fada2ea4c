// K9 and K10's entries: the batched step loop (bloop.cuh
// `lane_steps_kernel`) for bf16 params here, for f32 params through
// bloop_f32.cu's instances.
#include "bloop.cuh"

extern "C" int bark_lane_steps_blocks_f32(int scale_dtype, int has_min,
                                          int D, int S);
extern "C" int bark_lane_steps_f32(const BarkGPTWeights* w,
                                   const void* const* tiles, const int* plan,
                                   int blocks, int B, const BarkLaneLoop* lp,
                                   void* k_cache, void* v_cache,
                                   float* k_scale, float* v_scale,
                                   float* work, long long work_floats,
                                   int cap, unsigned* sync, float* logits,
                                   cudaStream_t stream);
extern "C" int bark_lane_steps_packed_f32(
    const BarkGPTQWeights* w, const void* const* tiles, const int* plan,
    int blocks, int B, const BarkLaneLoop* lp, void* k_cache, void* v_cache,
    float* k_scale, float* v_scale, float* work, long long work_floats,
    int cap, unsigned* sync, float* logits, cudaStream_t stream);

// The grid of bark_decode_lane_steps (scale_dtype < 0) or
// bark_decode_lane_steps_packed: as bark_decode_lanes_blocks' (the same
// plans serve both kernels; the caller takes the fewer).
extern "C" int bark_decode_lane_steps_blocks(int dtype, int scale_dtype,
                                             int has_min, int D, int S) {
  return dtype == BARK_BF16
             ? lane_steps_blocks_for<bf16>(scale_dtype, has_min, D, S)
             : bark_lane_steps_blocks_f32(scale_dtype, has_min, D, S);
}

// K9/K10: `lp->n_steps` steps of bark_decode_lanes as ONE cooperative
// launch of the batched step loop (lane_steps_kernel), each step sampling
// every lane's token from its last logits inside the launch. logits (B,
// n_out_vocab) holds the input logits (the prefill's or the last
// chunk's) and is left holding the last step's; plan (the lane_plan table
// of B lanes) must cover the sample window ([0, n_out_vocab) for codebook
// 0, [svs, svs + 2 cbs) for 1), which the kernel checks; lp->part holds 4
// f32 for each of the plan's LM tiles and lanes. The rest as
// bark_decode_lanes', the tokens, slots and stamps aside (the loop's are
// in lp). Returns the launch's cudaError (0 on success), -1 for arguments
// it does not take; nothing falls back.
extern "C" int bark_decode_lane_steps(
    const BarkGPTWeights* w, const void* const* tiles, const int* plan,
    int blocks, int B, const BarkLaneLoop* lp, void* k_cache, void* v_cache,
    float* k_scale, float* v_scale, float* work, long long work_floats,
    int cap, unsigned* sync, float* logits, cudaStream_t stream) {
  if (w->dtype == BARK_BF16)
    return lane_steps_for<bf16>(w, tiles, plan, blocks, B, lp, k_cache,
                                v_cache, k_scale, v_scale, work, work_floats,
                                cap, sync, logits, stream);
  return bark_lane_steps_f32(w, tiles, plan, blocks, B, lp, k_cache, v_cache,
                             k_scale, v_scale, work, work_floats, cap, sync,
                             logits, stream);
}

// K9/K10 on a qpack: bark_decode_lane_steps on the packed read (the
// weights and tiles of bark_decode_lanes_packed).
extern "C" int bark_decode_lane_steps_packed(
    const BarkGPTQWeights* w, const void* const* tiles, const int* plan,
    int blocks, int B, const BarkLaneLoop* lp, void* k_cache, void* v_cache,
    float* k_scale, float* v_scale, float* work, long long work_floats,
    int cap, unsigned* sync, float* logits, cudaStream_t stream) {
  if (w->dtype == BARK_BF16)
    return lane_steps_packed_for<bf16>(w, tiles, plan, blocks, B, lp,
                                       k_cache, v_cache, k_scale, v_scale,
                                       work, work_floats, cap, sync, logits,
                                       stream);
  return bark_lane_steps_packed_f32(w, tiles, plan, blocks, B, lp, k_cache,
                                    v_cache, k_scale, v_scale, work,
                                    work_floats, cap, sync, logits, stream);
}
