// The parts of the persistent decode step that K1/K5 (decode.cu, one lane)
// and K7/K5-batched (lane.cuh, B lanes) share: the launch shape, the
// head's attention on a dense or an int8 cache (`attend_dense`,
// `attend_int8`), the step loops' sampler (`argmax_take`, `take_slot`,
// `merge`: decode.cu's and lane.cuh's), and the two weight reads,
// `DenseRead` and `PackedRead`, each with the layout of its tile-major copy
// (kernels/decode.py `step_tiles`, `step_qtiles`, `lane_tiles`) and a wte
// value.
#pragma once

#include <cuda_fp16.h>
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int HD = 64;             // head dim the attention takes

// the persistent steps
constexpr int PS_THREADS = 512;
constexpr int PS_WARPS = PS_THREADS / 32;     // also the GEMV's row groups
constexpr int PS_KG = PS_THREADS / (HD / 8);  // key groups of its attention
constexpr int TILE = 64;       // output columns of a work item (the plans')
constexpr int QB = 32;         // rows of a packed weight's quant block
constexpr int RING_BYTES = 128 * 1024;
constexpr int MAX_SMEM = 227 * 1024;
constexpr float ATT_SCALE = 0.125f;  // 1 / sqrt(HD)

// ------------------------------------------------------------ attention

// threadIdx.x read anew: an opaque value, so that nothing derived from it
// is hoisted out of a loop around its read and kept in a register (the
// batched step loop reads it at each use: lane.cuh)
__device__ __forceinline__ unsigned opaque_tid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(r));
  return r;
}

// The threads that run one head's attention: a whole block (K1, K5; K6a
// alone), or one of a block's groups of N consecutive threads (the batched
// step, a (head, lane) unit a group), which wait for each other at named
// barrier 1 + the group's index. OPAQUE: the thread's index by
// `opaque_tid` (the batched step loop's).
struct WholeBlock {
  static constexpr bool WHOLE = true;
  __device__ static unsigned index() { return threadIdx.x; }
  __device__ static int tid() { return threadIdx.x; }
  __device__ static int size() { return blockDim.x; }
  __device__ static void sync() { __syncthreads(); }
};
template <int N, bool OPAQUE = false>
struct ThreadGroup {
  static constexpr bool WHOLE = false;
  __device__ static unsigned index() {
    return OPAQUE ? opaque_tid() : threadIdx.x;
  }
  __device__ static int tid() { return index() % N; }
  __device__ static int size() { return N; }
  __device__ static void sync() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + (int)index() / N), "n"(N)
                 : "memory");
  }
};

// block_max and block_sum over the group's threads (`red`: 32 floats of
// the group's own)
template <typename Grp>
__device__ __forceinline__ float grp_max(float v, float* red) {
  if constexpr (Grp::WHOLE) {
    return block_max(v, red);
  } else {
    const int lane = Grp::index() & 31, w = Grp::tid() >> 5;
    v = warp_max(v);
    Grp::sync();
    if (lane == 0) red[w] = v;
    Grp::sync();
    return warp_max(lane < Grp::size() / 32 ? red[lane] : -INFINITY);
  }
}
template <typename Grp>
__device__ __forceinline__ float grp_sum(float v, float* red) {
  if constexpr (Grp::WHOLE) {
    return block_sum(v, red);
  } else {
    const int lane = Grp::index() & 31, w = Grp::tid() >> 5;
    v = warp_sum(v);
    Grp::sync();
    if (lane == 0) red[w] = v;
    Grp::sync();
    return warp_sum(lane < Grp::size() / 32 ? red[lane] : 0.0f);
  }
}

// The context at dim Grp::tid() (threads < HD) from the KG key groups'
// sums in part: each thread adds 8 groups of one dim (the group's 8 KG
// threads cover every (dim, 8 groups)), then threads < HD add those in
// order: a fixed order, two short steps in place of KG serial adds.
template <int KG, typename Grp = WholeBlock>
__device__ __forceinline__ float sum_groups(float (*part)[HD + 1]) {
  Grp::sync();
  const int d = Grp::tid() % HD, c = Grp::tid() / HD;
  float s = 0.0f;
#pragma unroll
  for (int g = 0; g < 8; ++g) s += part[8 * c + g][d];
  Grp::sync();
  part[c][d] = s;
  Grp::sync();
  float t = 0.0f;
  if (Grp::tid() < HD)
#pragma unroll
    for (int k = 0; k < KG / 8; ++k) t += part[k][Grp::tid()];
  return t;
}

// One head's attention for one query at slot n_past: rows 0..n_past-1 of
// the (S, D) cache slabs kc/vc (the head's column offset applied), row
// n_past from knew/vnew (the fresh row, f32 holding params-dtype values,
// in shared memory). Scores in f32, each thread whole key rows (16-byte
// loads); an f32 softmax; the weights rounded to T (the reference casts
// them to the V dtype); the context by groups of 8 threads, each reading
// one V row with 16-byte loads (VU rows in flight), the groups' sums added
// in a fixed order.
// Returns the context's f32 sum at dim Grp::tid() (threads < HD). KG is
// the group's threads / 8; sc holds n_past + 1 floats.
template <typename T, int KG, typename Grp = WholeBlock, int VU = 4>
__device__ float attend_dense(const float* q, const float* knew,
                              const float* vnew, const T* kc, const T* vc,
                              int n_past, int D, float scale, float* sc,
                              float* red, float (*part)[HD + 1]) {
  const int n = n_past + 1;
  float m = -INFINITY;
  for (int j = Grp::tid(); j < n; j += Grp::size()) {
    float s = 0.0f;
    if (j < n_past) {
      const T* kr = kc + (size_t)j * D;
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float k8[8];
        load8(kr + d0, k8);
        for (int i = 0; i < 8; ++i) s = fmaf(q[d0 + i], k8[i], s);
      }
    } else {
      for (int d = 0; d < HD; ++d) s = fmaf(q[d], knew[d], s);
    }
    s *= scale;
    sc[j] = s;
    m = fmaxf(m, s);
  }
  m = grp_max<Grp>(m, red);
  float sum = 0.0f;
  for (int j = Grp::tid(); j < n; j += Grp::size()) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    sum += e;
  }
  sum = grp_sum<Grp>(sum, red);
  for (int j = Grp::tid(); j < n; j += Grp::size())
    sc[j] = round_t<T>(sc[j] / sum);
  Grp::sync();
  // the group's cache rows in order, 4 loads in flight, then the fresh row
  // (the group's last when it has it)
  const int dg = (Grp::tid() % (HD / 8)) * 8, kg = Grp::tid() / (HD / 8);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int j = kg;
  for (; j + (VU - 1) * KG < n_past; j += VU * KG) {
    float v8[VU][8];
#pragma unroll
    for (int u = 0; u < VU; ++u)
      load8(vc + (size_t)(j + u * KG) * D + dg, v8[u]);
#pragma unroll
    for (int u = 0; u < VU; ++u) {
      const float p = sc[j + u * KG];
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, v8[u][i], acc[i]);
    }
  }
  for (; j < n_past; j += KG) {
    float v8[8];
    load8(vc + (size_t)j * D + dg, v8);
    const float p = sc[j];
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, v8[i], acc[i]);
  }
  if (j == n_past) {
    const float p = sc[j];
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vnew[dg + i], acc[i]);
  }
  for (int i = 0; i < 8; ++i) part[kg][dg + i] = acc[i];
  return sum_groups<KG, Grp>(part);
}

// K6a's query: q * scale (qv, the group's threads < HD) quantized over the
// head into qw (16 words of 4 int8); returns its scale.
template <typename Grp = WholeBlock>
__device__ __forceinline__ float quant_query(float qv, int* qw, float* red) {
  const float sq = i8_scale(grp_max<Grp>(fabsf(qv), red));
  if (Grp::tid() < HD)
    reinterpret_cast<signed char*>(qw)[Grp::tid()] =
        quant_i8(qv, i8_inv(sq));
  Grp::sync();
  return sq;
}

// K6a: attend_dense on the int8 cache. Replaces the kv_quant branches of
// bark_tpu/kernels/decode.py (`_quant_row` :1045, `_quant_qseg` :1033,
// `_attend_lane(_scr)` :1055/:1109, :1603-1634 and :1937-1982), computing
// what the JAX package's XLA path computes (models/gpt.py `_kv_update`,
// `_attention_int8`): a key row's score is the exact integer dot of the
// int8 query qw (scale sq) with the int8 key (`__dp4a` over 16 words),
// then (score * sq) * s_k; the f32 softmax and weights rounded to T as the
// dense path; V rows dequantized as round_t<T>(q * s_v), the context summed
// with f32 FMAs. Rows 0..n_past-1 come from the cache (kc, vc with the
// head's offset; ks, vs the slab's row scales), row n_past from knew/vnew
// (16 words of int8 each) with the scales sk, sv.
template <typename T, int KG, typename Grp = WholeBlock, int VU = 4>
__device__ float attend_int8(const int* qw, float sq, const int* knew,
                             const int* vnew, float sk, float sv,
                             const signed char* kc, const signed char* vc,
                             const float* ks, const float* vs, int n_past,
                             int D, float* sc, float* red,
                             float (*part)[HD + 1]) {
  const int n = n_past + 1;
  float m = -INFINITY;
  for (int j = Grp::tid(); j < n; j += Grp::size()) {
    int acc = 0;
    if (j < n_past) {
      const int4* kr = reinterpret_cast<const int4*>(kc + (size_t)j * D);
#pragma unroll
      for (int w = 0; w < HD / 16; ++w) {
        const int4 u = kr[w];
        acc = __dp4a(u.x, qw[4 * w], acc);
        acc = __dp4a(u.y, qw[4 * w + 1], acc);
        acc = __dp4a(u.z, qw[4 * w + 2], acc);
        acc = __dp4a(u.w, qw[4 * w + 3], acc);
      }
    } else {
#pragma unroll
      for (int w = 0; w < HD / 4; ++w) acc = __dp4a(knew[w], qw[w], acc);
    }
    const float s = ((float)acc * sq) * (j == n_past ? sk : ks[j]);
    sc[j] = s;
    m = fmaxf(m, s);
  }
  m = grp_max<Grp>(m, red);
  float sum = 0.0f;
  for (int j = Grp::tid(); j < n; j += Grp::size()) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    sum += e;
  }
  sum = grp_sum<Grp>(sum, red);
  for (int j = Grp::tid(); j < n; j += Grp::size())
    sc[j] = round_t<T>(sc[j] / sum);
  Grp::sync();
  // groups of 8 threads read one V row, 8 bytes a thread
  // (4 rows in flight, the fresh row last, as attend_dense)
  const int dg = (Grp::tid() % (HD / 8)) * 8, kg = Grp::tid() / (HD / 8);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  auto add_row = [&](int2 u, float s, float p) {
    const signed char* v8 = reinterpret_cast<const signed char*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[i] = fmaf(p, round_t<T>((float)v8[i] * s), acc[i]);
  };
  int j = kg;
  for (; j + (VU - 1) * KG < n_past; j += VU * KG) {
    int2 u[VU];
    float s[VU];
#pragma unroll
    for (int w = 0; w < VU; ++w) {
      u[w] = *reinterpret_cast<const int2*>(vc + (size_t)(j + w * KG) * D +
                                            dg);
      s[w] = vs[j + w * KG];
    }
#pragma unroll
    for (int w = 0; w < VU; ++w) add_row(u[w], s[w], sc[j + w * KG]);
  }
  for (; j < n_past; j += KG)
    add_row(*reinterpret_cast<const int2*>(vc + (size_t)j * D + dg), vs[j],
            sc[j]);
  if (j == n_past)
    add_row(*reinterpret_cast<const int2*>(
                reinterpret_cast<const signed char*>(vnew) + dg),
            sv, sc[j]);
  for (int i = 0; i < 8; ++i) part[kg][dg + i] = acc[i];
  return sum_groups<KG, Grp>(part);
}

// ------------------------------------------------------------ sampling

// The sampler's (value, index) merge, a max by a total order: NaN above
// every number, then the larger value, then on a tie the lower index, as
// torch.argmax and jnp.argmax pick (the first NaN, else the first
// maximum). Index INT_MAX is "nothing seen yet". The order is total, so any
// merge order ends at the same pair.
__device__ __forceinline__ void argmax_take(float& v, int& i, float ov,
                                            int oi) {
  if (oi == INT_MAX) return;
  const bool take =
      i == INT_MAX ||
      (isnan(ov) ? (!isnan(v) || oi < i)
                 : (!isnan(v) && (ov > v || (ov == v && oi < i))));
  if (take) {
    v = ov;
    i = oi;
  }
}

// logit l on the EOS scale: l / temp, or l / 0.7 at temp 0 (the
// reference's divide); a true division, as ops/sampling.py `divide`
__device__ __forceinline__ float eos_scale(float temp, float l) {
  return temp != 0.0f ? l / temp : l / 0.7f;
}

// A sample partial (the step loops': decode.cu's, and bloop.cuh's of B
// lanes): the best (value, index) (argmax_take) and, on the EOS scale, the
// largest value m and the sum s of exp(e - m) of the slots seen (s 0: none;
// NaN slots leave m and make s NaN, as a softmax over them does).
struct Part {
  float v, m, s;
  int i;
};

// slot u of a sample window, logit l, taken into p: the argmax takes l /
// temp + noise[u], or l at temp 0 (noise null); with `eos` the EOS sums
// take l / temp (l / 0.7 at temp 0)
__device__ __forceinline__ void take_slot(Part& p, int u, float l, float temp,
                                          const float* noise, bool eos) {
  const float e = eos_scale(temp, l);
  if (eos) {
    const float m = fmaxf(p.m, e);
    p.s = (p.s == 0.0f ? 0.0f : p.s * expf(p.m - m)) +
          (e == -INFINITY ? 0.0f : expf(e - m));
    p.m = m;
  }
  argmax_take(p.v, p.i, noise != nullptr ? e + noise[u] : l, u);
}

// `o` merged into `p`: the same result in either order (max, and sums of
// two terms, commute bit for bit), so lanes that swap partials agree;
// without `eos`, the best pair alone
__device__ __forceinline__ void merge(Part& p, const Part& o, bool eos) {
  argmax_take(p.v, p.i, o.v, o.i);
  if (!eos) return;
  const float m = fmaxf(p.m, o.m);
  p.s = (p.s == 0.0f ? 0.0f : p.s * expf(p.m - m)) +
        (o.s == 0.0f ? 0.0f : o.s * expf(o.m - m));
  p.m = m;
}

// p merged over the warp by a butterfly: every thread ends with the same
// result (the merge commutes)
__device__ __forceinline__ Part warp_merge(Part p, bool eos) {
  for (int o = 16; o > 0; o >>= 1) {
    Part q;
    q.v = __shfl_xor_sync(0xffffffffu, p.v, o);
    q.m = __shfl_xor_sync(0xffffffffu, p.m, o);
    q.s = __shfl_xor_sync(0xffffffffu, p.s, o);
    q.i = __shfl_xor_sync(0xffffffffu, p.i, o);
    merge(p, q, eos);
  }
  return p;
}

// ------------------------------------------------------------ weight reads

// How the persistent steps read their weights: the policy both kernels are
// templated on (decode.cu `decode_step_kernel`, lane.cuh `LaneStep`).
// Each gives the params dtype T, the weight struct,
// the rows of a K-range unit of K1's plan (UNIT) and of a ring chunk (CH),
// a slot's bytes, where rows of a tile lie in the tiled copy, K1's share
// of a chunk's product for a thread, and a wte value. The batched step
// reads the same bytes a row in another order within each 16-row group
// (bf16: the mma fragments' order, kernels/decode.py `lane_tiles`), so
// row_at and tile_bytes hold for its copies too.

// Dense: the four projection weights tile-major in T, (L, N/64, K, 64)
// (`step_tiles`); the LM head (V, D) as the params hold it.
template <typename T_>
struct DenseRead {
  using T = T_;
  using Weights = BarkGPTWeights;
  static constexpr bool PACKED = false;
  static constexpr bool MINS = false;
  static constexpr int UNIT = 8;
  static constexpr int CH = 128;
  static constexpr int SLOT = CH * TILE * (int)sizeof(T);

  // bytes from a tile's start to its row k, and of a tile of K rows
  __device__ static size_t row_at(int k) {
    return (size_t)k * TILE * sizeof(T);
  }
  __device__ static size_t tile_bytes(int K) { return row_at(K); }

  // thread (warp, lane) adds rows warp, warp + 16, ... of the chunk's
  // columns 2 lane, 2 lane + 1 against xin (the chunk's rows of vin)
  __device__ static void dot_chunk(const unsigned char* slot,
                                   const float* xin, int rows, float& a0,
                                   float& a1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const T* w = reinterpret_cast<const T*>(slot);
    if (rows == CH) {  // a whole chunk: every load first
      constexpr int R = CH / PS_WARPS;
      float w0[R], w1[R], xv[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        load2(w + (warp + k * PS_WARPS) * TILE + 2 * lane, w0[k], w1[k]);
        xv[k] = xin[warp + k * PS_WARPS];
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        a0 = fmaf(xv[k], w0[k], a0);
        a1 = fmaf(xv[k], w1[k], a1);
      }
    } else {
      for (int r = warp; r < rows; r += PS_WARPS) {
        float w0, w1;
        load2(w + r * TILE + 2 * lane, w0, w1);
        a0 = fmaf(xin[r], w0, a0);
        a1 = fmaf(xin[r], w1, a1);
      }
    }
  }

  // wte[tok][d] as f32
  __device__ static float embed(const Weights& w, int tok, int d, int D) {
    return to_f32(reinterpret_cast<const T*>(w.wte)[(size_t)tok * D + d]);
  }
};

// Packed (K5): each (L, K, N) weight of a qpack as records, (L, N/64,
// K/32, REC) bytes (`step_qtiles`): a record is one 32-row quant block of
// a 64-column tile, its 32 x 64 int8 values, then its 64 scales S, then,
// with HAS_MIN, its 64 mins; the LM head's transposed (D, v_pad) tile the
// same way, (v_pad/64, D/32, REC). So any run of whole quant blocks of a
// tile is one contiguous, 16-byte-aligned run, and a chunk is up to 8 of
// them (~16 KB of values).
template <typename T_, typename S, bool HAS_MIN>
struct PackedRead {
  using T = T_;
  using Scale = S;
  using Weights = BarkGPTQWeights;
  static constexpr bool PACKED = true;
  static constexpr bool MINS = HAS_MIN;
  static constexpr int UNIT = QB;
  static constexpr int CH = 8 * QB;
  static constexpr int REC =
      QB * TILE + TILE * (int)sizeof(S) * (HAS_MIN ? 2 : 1);
  static constexpr int SLOT = CH / QB * REC;
  static_assert(REC % 16 == 0, "a record must keep bulk copies aligned");

  __device__ static size_t row_at(int k) { return (size_t)(k / QB) * REC; }
  __device__ static size_t tile_bytes(int K) { return row_at(K); }

  __device__ static void load_s2(const unsigned char* p, float& a,
                                 float& b) {
    if constexpr (sizeof(S) == 2) {
      const float2 v =
          __half22float2(*reinterpret_cast<const __half2*>(p));
      a = v.x;
      b = v.y;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      a = v.x;
      b = v.y;
    }
  }

  // the two int8 values of a 16-bit word as exact floats, without the
  // conversion unit (a quarter of the FMA rate): each byte sign-extended
  // by shifts, added to the bits of 1.5 x 2^23 (whose ulp is 1), less
  // 1.5 x 2^23
  __device__ static void i8x2(unsigned short u, float& a, float& b) {
    a = __int_as_float(0x4B400000 + ((int)((unsigned)u << 24) >> 24)) -
        12582912.0f;
    b = __int_as_float(0x4B400000 + ((int)((unsigned)u << 16) >> 24)) -
        12582912.0f;
  }

  // round_t<T> of a pair (bf16: one packed conversion for both)
  __device__ static void round2(float& a, float& b) {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      a = __low2float(h);
      b = __high2float(h);
    }
  }

  // warp w takes rows [16 (w % 2), 16 (w % 2) + 16) of the chunk's record
  // w / 2 (rows / 32 of them), lane its columns 2 lane, 2 lane + 1: each
  // weight round_t<T>(q * s) in f32, FMA'd in f32 against x; with mins,
  // the half-block's sum of x times the block's min of each column (the
  // min term blocksums(x) @ m, summed by halves)
  __device__ static void dot_chunk(const unsigned char* slot,
                                   const float* xin, int rows, float& a0,
                                   float& a1) {
    constexpr int HALF = QB / 2;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp >= 2 * (rows / QB)) return;
    const unsigned char* rec = slot + (size_t)(warp >> 1) * REC;
    const int r0 = (warp & 1) * HALF;
    const unsigned char* q = rec + r0 * TILE + 2 * lane;
    const unsigned char* sp = rec + QB * TILE + 2 * lane * sizeof(S);
    float s0, s1;
    load_s2(sp, s0, s1);
    xin += (warp >> 1) * QB + r0;
    unsigned short v[HALF];
#pragma unroll
    for (int k = 0; k < HALF; ++k)
      v[k] = *reinterpret_cast<const unsigned short*>(q + k * TILE);
    float xs = 0.0f;
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const float x = xin[k];
      float w0, w1;
      i8x2(v[k], w0, w1);
      w0 = __fmul_rn(w0, s0);
      w1 = __fmul_rn(w1, s1);
      round2(w0, w1);
      a0 = fmaf(x, w0, a0);
      a1 = fmaf(x, w1, a1);
      if (HAS_MIN) xs += x;
    }
    if (HAS_MIN) {
      float m0, m1;
      load_s2(sp + TILE * sizeof(S), m0, m1);
      a0 = fmaf(xs, m0, a0);
      a1 = fmaf(xs, m1, a1);
    }
  }

  // the packed wte row's value d: round_t<T>(q * s [+ m]), in f32, as the
  // densified table holds it
  __device__ static float embed(const Weights& w, int tok, int d, int D) {
    const size_t sb = (size_t)tok * (D / QB) + d / QB;
    float v = __fmul_rn(
        (float)reinterpret_cast<const signed char*>(w.wte_q)[(size_t)tok * D +
                                                             d],
        s_to_f32(reinterpret_cast<const S*>(w.wte_s)[sb]));
    if (HAS_MIN)
      v = __fadd_rn(v, s_to_f32(reinterpret_cast<const S*>(w.wte_m)[sb]));
    return round_t<T>(v);
  }
};

// the most ring slots of any read (dense bf16: 16 KB slots)
constexpr int MAX_SLOTS = RING_BYTES / DenseRead<bf16>::SLOT;

// f(PackedRead<T, S, HAS_MIN>{}) for a qpack's scale dtype (BARK_F16 or
// BARK_F32) and mins; -1 for another scale dtype
template <typename T, typename F>
int with_packed_read(int scale_dtype, int has_min, F&& f) {
  if (scale_dtype == BARK_F16)
    return has_min ? f(PackedRead<T, __half, true>{})
                   : f(PackedRead<T, __half, false>{});
  if (scale_dtype == BARK_F32)
    return has_min ? f(PackedRead<T, float, true>{})
                   : f(PackedRead<T, float, false>{});
  return -1;
}

}  // namespace
