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
// What bounds it at the rows a request prefills: the semantic prompt is
// 257 rows and the coarse windows re-prime 257 to 617 (887 only from a
// longer request's twelfth window). A layer's four projections are
// 24 M D^2 flops against 12 D^2 weights: at M 257 that is 257 flops a
// weight byte in bf16, at the card's ridge (~295), so streaming the 170 MB
// of weights and the tensor cores' rate bound them alike; and at such M a
// projection is one wave of small tiles, so a tile's latency (its pipeline
// fill, its epilogue) counts as much as the rate. Causal attention
// (2 M^2 D flops a layer) is a tenth of the projections at M 887, but on
// CUDA-core f32 FMAs it took a quarter of K2 at M 617.
//
// The design, bf16 (every bf16 prefill on a CUDA tensor; nothing falls
// back):
// - GEMM, `gemm_tma_kernel`: C = A (M, K) row-major activations @ B (K, N)
//   row-major weights, read in place (no second copy). One producer warp
//   issues TMA boxes with 128-byte swizzling, A as 64 rows x 64 K and B as
//   64 K x 64 N of layer l (3-D maps over the (L, K, N) stacks), into a
//   ring of WG_STAGES stages, each with a full and an empty mbarrier; one
//   consumer warpgroup runs wgmma m64n64k16 on them (B MN-major, through
//   the transpose bit) into f32 registers, one group in flight while the
//   next stage's is issued. Tiles are 64 rows x 64 or 128 columns; proj and
//   out (N = D) may split K 2 or 4 ways so that a request's M fills the
//   card (`kernels/prefill.py` `gemm_plan` decides). The grid is the
//   blocks the card holds at once, each walking the (tile, split) work
//   items in turn, so that a block's producer loads the next item while
//   its consumers run the last one's epilogue. Split partials go to f32
//   scratch and the tile's last block to finish (a ticket counter) folds
//   them in split order 0, 1, ... before the epilogue: the same bits every
//   run. TMA fills zeros past row M; rows >= M are never written.
//   The weights' tensor maps are encoded once per stage
//   (`bark_prefill_weight_maps`, kept by the wrapper), the activations'
//   once per call (they depend on M), by the driver's
//   cuTensorMapEncodeTiled reached through the runtime, so the library
//   links no libcuda.
// - attention, `attn_prefill_tc_kernel<DenseTiles>`: one block of 8 warps
//   per (head, 64 query rows), on the tensor cores (mma.sync m16n8k16,
//   ldmatrix): 16 rows a warp, over the even or the odd key tiles. The
//   query tile and every key row it can see are staged in shared memory
//   once, a pair of key tiles a cp.async group, the first pass starting on
//   the first pair while the rest arrive; two passes over the keys (the
//   causal mask applied only on tiles that reach past a warp's first
//   row): the first gives each row's max and sum of exp(s - max) (the sum
//   rescaled as the max grows), the second the weights exp(s - max) / sum,
//   rounded to bf16, times V (V tiles double-buffered), the halves meeting
//   in shared memory in a fixed order. So the weights are normalised
//   before the V product, as the reference's: no unnormalised weights are
//   rescaled. A warp skips key tiles past its last row; the longest query
//   tiles are launched first.
// The epilogue, both dtypes (the reference's prefill.py:484-487,
// :521-523, :533-537, :541-548): the f32 sum rounded to T, + bias rounded,
// then q to scratch and k, v to their cache rows (or to kv_rows for K6b),
// tanh-GELU rounded, or the residual added in place and rounded.
//
// f32 keeps exact f32 products, which the tensor cores do not give (TF32
// would break the f32 contract): a SIMT GEMM (64 x 64 tiles, 4 x 8 outputs
// a thread) and the scalar attention (a block per head and 16 query rows).
// The dtype alone picks the path.
//
// K8 stacks the B lanes' live rows into one M = sum(n_valid) row block, so
// each projection is ONE GEMM whose weights stream once for every lane
// (the bound is K2's, with T = M). Only three places need the lane, and
// read it from small host-built tables (`RowMap`): the embedding (which
// x_emb row and position a stacked row has), the QKV epilogue (which cache
// row of which lane's slab its k, v go to), and attention, whose query
// tiles never straddle two lanes (64 rows for the tensor-core kernel, 16
// for the others) and each read their own lane's cache slab and n_valid.
// The LM head is K7's batched head on each lane's last live row.
//
// With int8 caches (K6) the QKV epilogue writes k, v in T to scratch, K6b
// (`quant_rows_kernel`) quantizes each row into its cache row, one launch
// a layer, and the attention is K6c: in bf16 the tensor-core kernel above
// reading the int8 tiles (`attn_prefill_tc_kernel<Int8Tiles>`: the query
// tile quantized per row and head, scores by mma m16n8k32 s8 with both
// row scales folded in after the exact integer sum, value tiles
// dequantized to bf16 as they enter their stage), in f32 the scalar
// `attn_prefill_i8_kernel`. The JAX package runs such a prefill in XLA;
// both compute models/gpt.py's int8 path. What bounds them: K6b moves ~3
// bytes a K/V value; K6c, at T 887, ~0.6 G int8 operations and as many
// bf16 flops over ~1.4 MB of int8 K/V a layer, like the bf16 attention.
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int HD = 64;
constexpr int LN_THREADS = 256;
constexpr int QT = 16;  // query rows per scalar attention block
constexpr int KT = 64;  // keys per shared tile
constexpr int PA_THREADS = 256;

enum { GE_QKV = 0, GE_GELU = 1, GE_RESID = 2 };

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
  const int* tiles64; // (n_tiles64, 3): `tiles` for 64-row query tiles
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

// The epilogue of output (m, n) from its f32 sum: rounded to T, + bias
// rounded, then the q / k / v split, tanh-GELU, or the residual add.
template <typename T, int EPI>
__device__ __forceinline__ void epilogue(int m, int n, float acc,
                                         const T* __restrict__ bias, int N,
                                         const GemmOut& o) {
  float v = round_t<T>(acc);
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
    x[(size_t)m * N + n] =
        from_f32<T>(round_t<T>(to_f32(x[(size_t)m * N + n]) + v));
  }
}

// ------------------------------------------------------------ f32 GEMM

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int GEMM_THREADS = 128;
constexpr int A_LD32 = BM + 4;  // A tile, stored k-major
constexpr int B_LD32 = BN + 4;

// C = A (M, K) @ B (K, N), both row-major f32, exact f32 products, then
// the epilogue; rows >= M are neither read nor written. Requires K % BK ==
// 0 and N % BN == 0.
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_simt_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ bias, int M, int N, int K,
                     GemmOut o) {
  __shared__ float As[BK * A_LD32];
  __shared__ float Bs[BK * B_LD32];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = tid % 8, ty = tid / 8;  // 8 x 8 columns, 16 x 4 rows
  float acc[4][8];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int v = tid; v < BM * BK / 4; v += GEMM_THREADS) {
      const int r = v / (BK / 4), c = (v % (BK / 4)) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M)
        val = *reinterpret_cast<const float4*>(A + (size_t)(m0 + r) * K +
                                               k0 + c);
      As[(c + 0) * A_LD32 + r] = val.x;
      As[(c + 1) * A_LD32 + r] = val.y;
      As[(c + 2) * A_LD32 + r] = val.z;
      As[(c + 3) * A_LD32 + r] = val.w;
    }
    for (int v = tid; v < BK * BN / 4; v += GEMM_THREADS) {
      const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(Bs + r * B_LD32 + c) =
          *reinterpret_cast<const float4*>(B + (size_t)(k0 + r) * N + n0 + c);
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
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < M)
      for (int j = 0; j < 8; ++j)
        epilogue<float, EPI>(m, n0 + tx * 8 + j, acc[i][j], bias, N, o);
  }
}

// ------------------------------------------------------------ bf16 GEMM

constexpr int WG_BK = 64;         // K a stage: one 128-byte row of A's box
constexpr int WG_STAGES = 4;
constexpr int WG_BOX = WG_BK * 64 * 2;  // a 64 x 64 box (A rows or B columns)

// A tile of BT x BT outputs (BT 64 or 128) has BT / 64 consumer
// warpgroups (64 rows each) and a producer warp; its epilogue stages the
// rounded tile in shared memory, rows of BT + 8 bf16.
__host__ __device__ constexpr int tma_threads(int bt) {
  return bt / 64 * 128 + 32;
}
__host__ __device__ constexpr int tma_stage_bytes(int bt) {
  return 2 * (bt / 64) * WG_BOX;
}
// the ring, the epilogue tile, 2 x WG_STAGES mbarriers, slack to align the
// ring to 1024
__host__ __device__ constexpr int tma_smem_bytes(int bt) {
  return WG_STAGES * tma_stage_bytes(bt) + bt * (bt + 8) * 2 +
         16 * WG_STAGES + 1024;
}

struct TmaGemm {
  const bf16* bias;  // (N,), this layer's
  int M, N;
  int layer;         // B's outermost coordinate
  int k_tiles;       // WG_BK-deep stages a split
  int tiles_n;       // column tiles
  int tiles;         // output tiles
  int items;         // (split, row tile, column tile) work items
  float* part;       // (splits, M, N) f32 partials when K is split, else null
  int* tickets;      // a counter an output tile, 0 between launches
  GemmOut o;
};

// Work item w of a GEMM: column tile, row tile, K split (the column tile
// runs fastest, so blocks side by side share an A box in the L2).
struct Item {
  int tile, n0, m0, split;
};

__device__ __forceinline__ Item gemm_item(const TmaGemm& g, int w, int bt) {
  const int t = w % g.tiles;
  return {t, (t % g.tiles_n) * bt, (t / g.tiles_n) * bt, w / g.tiles};
}

// a barrier among the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void wg_barrier(int wg) {
  if (wg == 0)
    named_barrier<2>(128);
  else
    named_barrier<3>(128);
}

// A persistent block walks the work items blockIdx.x, + gridDim.x, ...: a
// BT x BT output tile over one K split each. The producer warp (the last
// warp, one thread issuing) first asks for its first item's weight boxes
// in the L2 (a layer's weights are cold: they come from device memory
// once, the activations were just written), then streams the boxes
// through the ring, running ahead into the next item while the consumer
// warpgroups (64 rows each, sharing B's boxes) finish one: K / 16 wgmma
// steps a stage into f32 registers, then the epilogue, or, when K is
// split, a stored partial and, in the tile's last block to finish, the
// fold. The epilogue (epilogue()'s arithmetic) rounds the sum, adds the
// bias and rounds into a shared-memory tile, then each warpgroup's threads
// take 16-byte runs of its rows: GELU, the residual (read 16 bytes at a
// time) or the q / k / v row, stored 16 bytes at a time. A QKV tile never
// straddles q, k and v (D is a multiple of BT).
template <int EPI, int BT>
__global__ void __launch_bounds__(tma_threads(BT), 1)
    gemm_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b, TmaGemm g) {
  constexpr int WGS = BT / 64, NJ = BT / 64, CONSUMERS = 128 * WGS;
  constexpr int STAGE = tma_stage_bytes(BT), B_OFF = WGS * WG_BOX;
  constexpr int E_LD = BT + 8;
  extern __shared__ unsigned char dsm[];
  __shared__ int last;
  // 128-byte swizzled boxes want 1024-byte aligned tiles
  unsigned char* ring = dsm + ((1024 - (smem_addr(dsm) & 1023)) & 1023);
  bf16* epi = reinterpret_cast<bf16*>(ring + WG_STAGES * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + BT * E_LD);
  uint64_t* empty = full + WG_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      int it = 0;  // stages issued by this block
      for (int w = blockIdx.x; w < g.items; w += gridDim.x) {
        const Item t = gemm_item(g, w, BT);
        const int k0 = t.split * g.k_tiles * WG_BK;
        if (w == (int)blockIdx.x)  // the first item: its weights are cold
          for (int i = 0; i < g.k_tiles; ++i)
            for (int j = 0; j < NJ; ++j)
              tma_prefetch_3d(&tm_b, t.n0 + 64 * j, k0 + i * WG_BK, g.layer);
        for (int i = 0; i < g.k_tiles; ++i, ++it) {
          const int s = it % WG_STAGES;
          if (it >= WG_STAGES)
            mbar_wait(&empty[s], (it / WG_STAGES - 1) & 1);
          unsigned char* st = ring + s * STAGE;
          const int k = k0 + i * WG_BK;
          mbar_expect_tx(&full[s], STAGE);
          for (int c = 0; c < WGS; ++c)
            tma_load_2d(st + c * WG_BOX, &tm_a, k, t.m0 + 64 * c, &full[s]);
          for (int j = 0; j < NJ; ++j)
            tma_load_3d(st + B_OFF + j * WG_BOX, &tm_b, t.n0 + 64 * j, k,
                        g.layer, &full[s]);
        }
      }
    }
    return;
  }
  // register 4 n8 + 2 h + e of acc[j]: row 64 wg + 16 warp + lane / 4 +
  // 8 h, column 64 j + 8 n8 + 2 (lane % 4) + e of the tile
  const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5,
            lane = tid & 31;
  const int lc = 2 * (lane & 3);
  const size_t slab = (size_t)g.M * g.N;
  const int splits = g.items / g.tiles;
  const GemmOut& o = g.o;
  bf16* rows_s = epi + 64 * wg * E_LD;  // this warpgroup's rows of the tile
  int it = 0;  // stages consumed by this block
  for (int w = blockIdx.x; w < g.items; w += gridDim.x) {
    const Item t = gemm_item(g, w, BT);
    float acc[NJ][32];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[j][r] = 0.0f;
    for (int i = 0; i < g.k_tiles; ++i, ++it) {
      const int s = it % WG_STAGES;
      mbar_wait(&full[s], (it / WG_STAGES) & 1);
      const unsigned char* st = ring + s * STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const uint64_t da =
            wgmma_desc_sw128(st + wg * WG_BOX + 32 * kk, 16, 1024);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          wgmma_m64n64k16_tb(
              acc[j], da,
              wgmma_desc_sw128(st + B_OFF + j * WG_BOX + 2048 * kk, 1024,
                               1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group is done with its tiles
      if (i > 0) mbar_arrive(&empty[(it - 1) % WG_STAGES]);
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[(it - 1) % WG_STAGES]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 32; ++r) fence_operand(acc[j][r]);

    const int r_base = 16 * warp + (lane >> 2);  // and + 8: rows in the WG's 64
    const int m_base = t.m0 + 64 * wg + r_base;
    if (splits > 1) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m_base + 8 * h;
            const int n = t.n0 + 64 * j + 8 * n8 + lc;
            if (m < g.M)
              *reinterpret_cast<float2*>(g.part + t.split * slab +
                                         (size_t)m * g.N + n) =
                  make_float2(acc[j][4 * n8 + 2 * h],
                              acc[j][4 * n8 + 2 * h + 1]);
          }
      __threadfence();
      named_barrier<1>(CONSUMERS);
      if (tid == 0) {
        last = atomicAdd(g.tickets + t.tile, 1) == splits - 1;
        if (last) g.tickets[t.tile] = 0;  // every split is in: reusable
      }
      named_barrier<1>(CONSUMERS);
      if (!last) continue;
      __threadfence();
    }
    // the sums (the partials folded in split order), rounded, + bias,
    // rounded, into the shared tile
    wg_barrier(wg);  // the last item's runs are read
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float2 b[8];
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
        b[n8] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            g.bias + t.n0 + 64 * j + 8 * n8 + lc));
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 64 * j + 8 * n8 + lc;
          float2 v = make_float2(acc[j][4 * n8 + 2 * h],
                                 acc[j][4 * n8 + 2 * h + 1]);
          if (splits > 1 && m_base + 8 * h < g.M) {
            const float* p = g.part + (size_t)(m_base + 8 * h) * g.N + t.n0 + c;
            v = __ldcg(reinterpret_cast<const float2*>(p));
            for (int z = 1; z < splits; ++z) {
              const float2 u =
                  __ldcg(reinterpret_cast<const float2*>(p + z * slab));
              v.x += u.x;
              v.y += u.y;
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(rows_s + (r_base + 8 * h) * E_LD +
                                             c) =
              __floats2bfloat162_rn(round_t<bf16>(v.x) + b[n8].x,
                                    round_t<bf16>(v.y) + b[n8].y);
        }
    }
    wg_barrier(wg);
    // 16-byte runs of the warpgroup's rows: GELU, residual or q / k / v
    int ld = g.N, col0 = t.n0, which = 0;
    bf16* dst = (bf16*)o.out;
    if (EPI == GE_QKV) {
      which = t.n0 / o.D;
      ld = o.D;
      col0 = t.n0 - which * o.D;
      if (which > 0) dst = (bf16*)(which == 1 ? o.kc : o.vc);
    }
    constexpr int RUNS = BT / 8;  // 16-byte runs a row
    for (int idx = wtid; idx < 64 * RUNS; idx += 128) {
      const int r = idx / RUNS, c = (idx % RUNS) * 8;
      const int m = t.m0 + 64 * wg + r;
      if (m >= g.M) continue;
      uint4 u = *reinterpret_cast<const uint4*>(rows_s + r * E_LD + c);
      size_t row = m;
      if (EPI == GE_QKV && which > 0 && o.slot != nullptr) row = o.slot[m];
      bf16* out = dst + row * ld + col0 + c;
      if (EPI != GE_QKV) {
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
        uint4 xr;
        if (EPI == GE_RESID) xr = *reinterpret_cast<const uint4*>(out);
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xr);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float2 f = __bfloat1622float2(h2[e]);
          if (EPI == GE_GELU) {
            f.x = gelu_tanh(f.x);
            f.y = gelu_tanh(f.y);
          } else {
            const float2 x = __bfloat1622float2(x2[e]);
            f.x = x.x + f.x;
            f.y = x.y + f.y;
          }
          h2[e] = __floats2bfloat162_rn(f.x, f.y);
        }
      }
      *reinterpret_cast<uint4*>(out) = u;
    }
  }
}

// ------------------------------------------------------------ tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; strides in bytes of
// the outer ones) whose boxes are 64 x box1 (x 1) with 128-byte swizzling,
// zeros outside the tensor. False if the driver refuses it.
bool encode_bf16(CUtensorMap* map, const void* base, int rank,
                 const cuuint64_t* dims, const cuuint64_t* strides,
                 cuuint32_t box1) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t box[3] = {64, box1, 1}, elem[3] = {1, 1, 1};
  return fn != nullptr && ((uintptr_t)base & 15) == 0 &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (M, K) row-major activations as {K, M}, boxes of 64 K x 64 rows
bool encode_rows(CUtensorMap* map, const void* a, int M, int K) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  return encode_bf16(map, a, 2, dims, strides, 64);
}

// (L, K, N) row-major weights as {N, K, L}, boxes of 64 N x 64 K x 1
bool encode_weights(CUtensorMap* map, const void* w, int L, int K, int N) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  return encode_bf16(map, w, 3, dims, strides, WG_BK);
}

enum { P_QKV = 0, P_PROJ = 1, P_FC = 2, P_OUT = 3 };

// What the bf16 GEMMs of one prefill call read: each projection's A map
// (hb, ctx, hb, ff over M rows) and weight map, its tile and K splits
// (`gemm_plan`), and the split-K scratch.
struct TmaPlan {
  CUtensorMap a[4];
  CUtensorMap b[4];
  int bt[4], splits[4];
  float* part;
  int* tickets;
};

// Fill `tp` for M rows: the weight maps from `wmaps`, the activations'
// encoded, the plan ((tile, splits) a projection, in P_* order)
// checked against the widths. False for a plan or a map the kernel does
// not take.
bool make_tma_plan(const BarkGPTWeights* w, const void* wmaps,
                   const int* plan, float* part, int* tickets, int M,
                   const void* hb, const void* ctx, const void* ff,
                   TmaPlan* tp) {
  const int D = w->n_embd;
  const int nk[4][2] = {{3 * D, D}, {D, D}, {4 * D, D}, {D, 4 * D}};
  if (wmaps == nullptr || plan == nullptr || tickets == nullptr) return false;
  for (int g = 0; g < 4; ++g) {
    const int bt = plan[2 * g], sp = plan[2 * g + 1];
    const int N = nk[g][0], K = nk[g][1];
    if ((bt != 64 && bt != 128) || N % bt || K % WG_BK ||
        (sp != 1 && sp != 2 && sp != 4) || (K / WG_BK) % sp ||
        (sp > 1 && part == nullptr))
      return false;
    tp->bt[g] = bt;
    tp->splits[g] = sp;
  }
  memcpy(tp->b, wmaps, sizeof(tp->b));
  tp->part = part;
  tp->tickets = tickets;
  if (!encode_rows(&tp->a[P_QKV], hb, M, D) ||
      !encode_rows(&tp->a[P_PROJ], ctx, M, D) ||
      !encode_rows(&tp->a[P_OUT], ff, M, 4 * D))
    return false;
  tp->a[P_FC] = tp->a[P_QKV];
  return true;
}

template <int EPI, int BT>
int launch_tma(const TmaPlan& tp, int g, const TmaGemm& args, int blocks,
               cudaStream_t st) {
  gemm_tma_kernel<EPI, BT><<<min(args.items, blocks), tma_threads(BT),
                             tma_smem_bytes(BT), st>>>(tp.a[g], tp.b[g],
                                                       args);
  return (int)cudaGetLastError();
}

// Each gemm_tma_kernel instance's dynamic shared memory and resident
// blocks on the card (its persistent grid), set and asked once a process
// and device: tma_blocks[epilogue][64-row tile, 128-row tile].
int tma_blocks[3][2];
int tma_device = -1;

template <int EPI, int BT>
int set_tma_instance(int sms) {
  const void* k = (const void*)gemm_tma_kernel<EPI, BT>;
  int err = (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, tma_smem_bytes(BT));
  if (!err)
    err = (int)cudaFuncSetAttribute(
        k, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  int per_sm = 0;
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k, tma_threads(BT), tma_smem_bytes(BT));
  tma_blocks[EPI][BT / 128] = sms * per_sm;
  return err ? err : (per_sm > 0 ? 0 : -1);
}

template <int EPI>
int set_tma_epilogue(int sms) {
  const int err = set_tma_instance<EPI, 64>(sms);
  return err ? err : set_tma_instance<EPI, 128>(sms);
}

int set_tma_smem() {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err || dev == tma_device) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (!err) err = set_tma_epilogue<GE_QKV>(sms);
  if (!err) err = set_tma_epilogue<GE_GELU>(sms);
  if (!err) err = set_tma_epilogue<GE_RESID>(sms);
  if (!err) tma_device = dev;
  return err;
}

// Projection g of layer l: A (M rows) @ its weights, + bias, then EPI.
template <typename T, int EPI>
int gemm(const TmaPlan* tp, int g, const T* A, const T* W, const T* bias,
         int M, int N, int K, int l, GemmOut o, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    const int bt = tp->bt[g], sp = tp->splits[g];
    const int tiles = N / bt * cdiv(M, bt);
    const TmaGemm args{bias,   M,          N,       l,
                       K / WG_BK / sp,     N / bt,  tiles,
                       tiles * sp,         sp > 1 ? tp->part : nullptr,
                       tp->tickets,        o};
    if (bt == 64)
      return launch_tma<EPI, 64>(*tp, g, args, tma_blocks[EPI][0], st);
    return launch_tma<EPI, 128>(*tp, g, args, tma_blocks[EPI][1], st);
  } else {
    const dim3 grid(N / BN, cdiv(M, BM));
    gemm_simt_kernel<EPI><<<grid, GEMM_THREADS, 0, st>>>(
        A, W + (size_t)l * K * N, bias, M, N, K, o);
    return (int)cudaGetLastError();
  }
}

// ------------------------------------------------ tensor-core attention

constexpr int TQ = 64;        // query rows a block: 4 row groups of 16
constexpr int TK = 64;        // keys a tile
constexpr int T_LD = HD + 8;  // bf16 row stride in shared memory (144 bytes)
// int8 row stride (80 bytes: the 8 rows of an ldmatrix matrix fall in 8
// distinct quads of banks)
constexpr int I8_LD = HD + 16;
constexpr int TA_THREADS = 256;  // 8 warps: 4 row groups x 2 key halves
constexpr int O_LD = HD + 4;  // f32 row stride of the context partials
static_assert(TA_THREADS == TQ * (HD / 16),
              "Int8Tiles: a thread a 16-dim quarter of a query row");

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// byte k of w as a signed int8 value
__device__ __forceinline__ float i8_at(unsigned w, int k) {
  return (float)((int)(w << (24 - 8 * k)) >> 24);
}

// rows [0, rows) of a head's bf16 slice (columns off .. off + 63, rows D
// apart) from src into dst (rows T_LD apart) by cp.async, zeros from `have`
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src,
                                           int rows, int have, int D,
                                           int off) {
  for (int i = threadIdx.x; i < rows * (HD / 8); i += TA_THREADS) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    bf16* d = dst + r * T_LD + c;
    if (r < have)
      cp_async16(d, src + (size_t)r * D + off + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// The warp's 16 x 64 dot products with a bf16 key tile (TK rows from kt):
// qa holds its query rows as 4 A fragments of 16 dims; s[j] holds keys
// 8 j .. 8 j + 7 as mma's C fragment (rows lane / 4 and lane / 4 + 8, keys
// 2 (lane % 4) and + 1).
__device__ __forceinline__ void tile_scores(float (&s)[8][4],
                                            const unsigned (&qa)[4][4],
                                            const bf16* kt, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned b[4];
      ldmatrix_x4(b, kt + (8 * j + (lane & 7)) * T_LD + 32 * h +
                         (lane >> 3) * 8);
      mma_16816(s[j], qa[2 * h], b[0], b[1]);
      mma_16816(s[j], qa[2 * h + 1], b[2], b[3]);
    }
}

// How attn_prefill_tc_kernel reads a layer's cache: a bf16 cache
// (DenseTiles) or an int8 one with f32 row scales (Int8Tiles). The kernel
// argument holds the layer's cache; a block makes a `Block` of it over its
// shared memory and its lane's slab, which stages the query tile (inside
// the first key pair's cp.async group) and each pair of key tiles (a group
// each), loads a warp's query rows as A fragments, scores a key tile into
// mma's C fragments (f32, scaled, not yet masked), and brings each pair of
// value tiles into a V stage as bf16: `fetch_values` at the top of a step,
// `land_values` after its products.
struct DenseTiles {
  const bf16* k;
  const bf16* v;
  float scale;  // 1 / sqrt(head dim)

  // the query tile, two stages of two V tiles, and `keys` key rows (a
  // multiple of 2 TK: the keys are staged a pair of tiles at a time)
  static constexpr size_t smem_bytes(int keys) {
    return (size_t)(TQ + 4 * TK + keys) * T_LD * sizeof(bf16);
  }

  struct Block {
    const bf16* k;
    const bf16* v;
    float scale;
    int D, off;
    bf16* qs;  // [TQ][T_LD]
    bf16* vs;  // [2 stages][2 tiles][TK][T_LD]
    bf16* ks;  // [keys][T_LD]
    unsigned qa[4][4];  // the warp's query rows: 4 A fragments of 16 dims

    // slab: the lane's first cache row
    __device__ Block(const DenseTiles& c, unsigned char* sm, size_t slab,
                     int D, int off, int)
        : k(c.k + slab * D), v(c.v + slab * D), scale(c.scale), D(D),
          off(off) {
      qs = reinterpret_cast<bf16*>(sm);
      vs = qs + TQ * T_LD;
      ks = vs + 4 * TK * T_LD;
    }
    // q: the tile's first row; rows from nq on are zeros
    __device__ void stage_query(const bf16* q, int nq) {
      stage_bf16(qs, q, TQ, nq, D, off);
    }
    __device__ void stage_keys(int st, int kmax) {
      stage_bf16(ks + st * 2 * TK * T_LD, k + (size_t)st * 2 * TK * D,
                 2 * TK, min(2 * TK, kmax - st * 2 * TK), D, off);
    }
    __device__ void fetch_values(int st, int kmax) {
      stage_bf16(vs + (st & 1) * 2 * TK * T_LD, v + (size_t)st * 2 * TK * D,
                 2 * TK, min(2 * TK, kmax - st * 2 * TK), D, off);
    }
    __device__ void land_values(int) {}  // cp.async wrote the stage
    __device__ const bf16* values(int st, int half) const {
      return vs + ((st & 1) * 2 + half) * TK * T_LD;
    }
    __device__ void load_query(int rg, int lane) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(qa[kk], qs + (16 * rg + (lane & 15)) * T_LD + 16 * kk +
                                (lane >> 4) * 8);
    }
    __device__ void scores(float (&s)[8][4], int kt, int lane) const {
      tile_scores(s, qa, ks + kt * TK * T_LD, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    }
  };
};

// K6c's reads, models/gpt.py `_attention_int8`: each query row of the tile
// is scaled by 1 / sqrt(64) and quantized per (row, head) in registers (a
// thread a 16-dim quarter of a row, the quarters' amax met by shuffles),
// and kept in shared memory as int8 with its f32 scale. Key tiles are
// staged as int8 rows (64 bytes, 80 apart) with their f32 row scales by
// cp.async, and scored by mma m16n8k32 s8 in two k-steps: the int32 sum
// is exact (|dot| <= 127^2 * 64 < 2^24), so each score ((float)dot * s_q)
// * s_k is the reference's to the bit. Value tiles are dequantized once,
// to bf16 (round(q * s_v), the reference's `_kv_read`), as they enter a V
// stage; from there the bf16 pass runs unchanged. They come through
// registers, not cp.async: a step issues its loads of the next pair before
// its products and converts and stores them after, so their latency hides
// behind the mma work and no int8 staging buffer or extra barrier is
// needed.
struct Int8Tiles {
  const signed char* k;
  const signed char* v;
  const float* ks;  // the rows' scales
  const float* vs;
  float scale;  // 1 / sqrt(head dim), applied before q is quantized

  // two stages of two bf16 V tiles; the int8 query tile and its scales;
  // `keys` key rows' scales, then the int8 rows
  static constexpr size_t smem_bytes(int keys) {
    return (size_t)4 * TK * T_LD * sizeof(bf16) +
           (size_t)(TQ + keys) * (I8_LD + sizeof(float));
  }

  struct Block {
    const signed char* k;
    const signed char* v;
    const float* ks;
    const float* vs;
    float scale;
    int D, off;
    bf16* vst;         // [2 stages][2 tiles][TK][T_LD]
    signed char* qq;   // [TQ][I8_LD]
    float* qsc;        // [TQ]
    float* ksc;        // [keys]
    signed char* kq;   // [keys][I8_LD]
    unsigned qa[2][4];  // the warp's query rows: 2 A fragments of 32 dims
    float sq[2];        // their scales (rows lane / 4 and + 8)
    uint4 vr[2];        // the thread's two 16-byte chunks of a value pair
    float vsr[2];       // their rows' scales

    __device__ Block(const Int8Tiles& c, unsigned char* sm, size_t slab,
                     int D, int off, int keys)
        : k(c.k + slab * D), v(c.v + slab * D), ks(c.ks + slab),
          vs(c.vs + slab), scale(c.scale), D(D), off(off) {
      vst = reinterpret_cast<bf16*>(sm);
      qq = reinterpret_cast<signed char*>(vst + 4 * TK * T_LD);
      qsc = reinterpret_cast<float*>(qq + TQ * I8_LD);
      ksc = qsc + TQ;
      kq = reinterpret_cast<signed char*>(ksc + keys);
    }
    __device__ void stage_query(const bf16* q, int nq) {
      const int i = threadIdx.x >> 2, c = (threadIdx.x & 3) * 16;
      float x[16];
      if (i < nq) {
        const uint4* p =
            reinterpret_cast<const uint4*>(q + (size_t)i * D + off + c);
        const uint4 u0 = p[0], u1 = p[1];
        const unsigned w[8] = {u0.x, u0.y, u0.z, u0.w,
                               u1.x, u1.y, u1.z, u1.w};
#pragma unroll
        for (int t = 0; t < 8; ++t) {  // a bf16's f32 is its bits << 16
          x[2 * t] = __uint_as_float(w[t] << 16) * scale;
          x[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u) * scale;
        }
      } else {
#pragma unroll
        for (int t = 0; t < 16; ++t) x[t] = 0.0f;
      }
      float a = 0.0f;
#pragma unroll
      for (int t = 0; t < 16; ++t) a = fmaxf(a, fabsf(x[t]));
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
      const float s = i8_scale(a), inv = i8_inv(s);
      unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int t = 0; t < 16; ++t)
        w[t >> 2] |= (unsigned)(unsigned char)quant_i8(x[t], inv)
                     << (8 * (t & 3));
      *reinterpret_cast<uint4*>(qq + i * I8_LD + c) =
          make_uint4(w[0], w[1], w[2], w[3]);
      if (c == 0) qsc[i] = s;
    }
    __device__ void stage_keys(int st, int kmax) {
      const int k0 = st * 2 * TK, have = min(2 * TK, kmax - k0);
      for (int i = threadIdx.x; i < 2 * TK * (HD / 16); i += TA_THREADS) {
        const int r = i / (HD / 16), c = (i % (HD / 16)) * 16;
        signed char* d = kq + (k0 + r) * I8_LD + c;
        if (r < have)
          cp_async16(d, k + (size_t)(k0 + r) * D + off + c);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
      for (int r = threadIdx.x; r < 2 * TK; r += TA_THREADS) {
        if (r < have)
          cp_async4(ksc + k0 + r, ks + k0 + r);
        else
          ksc[k0 + r] = 0.0f;
      }
    }
    // value rows [k0, k0 + 2 TK) into registers: chunk i = tid + 256 h is
    // row i / 4, dims 16 (i % 4) .. + 15
    __device__ void fetch_values(int st, int kmax) {
      const int k0 = st * 2 * TK, have = min(2 * TK, kmax - k0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = threadIdx.x + h * TA_THREADS;
        const int r = i / (HD / 16), c = (i % (HD / 16)) * 16;
        vr[h] = make_uint4(0, 0, 0, 0);
        vsr[h] = 0.0f;
        if (r < have) {
          vr[h] = *reinterpret_cast<const uint4*>(v + (size_t)(k0 + r) * D +
                                                  off + c);
          vsr[h] = vs[k0 + r];
        }
      }
    }
    __device__ void land_values(int st) {
      bf16* stage = vst + (st & 1) * 2 * TK * T_LD;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = threadIdx.x + h * TA_THREADS;
        const int r = i / (HD / 16), c = (i % (HD / 16)) * 16;
        const unsigned u[4] = {vr[h].x, vr[h].y, vr[h].z, vr[h].w};
        unsigned w[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int b = 2 * (t & 1);
          w[t] = pack_bf16(i8_at(u[t >> 1], b) * vsr[h],
                           i8_at(u[t >> 1], b + 1) * vsr[h]);
        }
        uint4* d = reinterpret_cast<uint4*>(stage + r * T_LD + c);
        d[0] = make_uint4(w[0], w[1], w[2], w[3]);
        d[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
    }
    __device__ const bf16* values(int st, int half) const {
      return vst + ((st & 1) * 2 + half) * TK * T_LD;
    }
    __device__ void load_query(int rg, int lane) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldmatrix_x4(qa[kk], qq + (16 * rg + (lane & 15)) * I8_LD + 32 * kk +
                                (lane >> 4) * 16);
      sq[0] = qsc[16 * rg + (lane >> 2)];
      sq[1] = qsc[16 * rg + (lane >> 2) + 8];
    }
    __device__ void scores(float (&s)[8][4], int kt, int lane) const {
      const signed char* rows = kq + kt * TK * I8_LD;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int acc[4] = {0, 0, 0, 0};
        unsigned b[4];
        ldmatrix_x4(b, rows + (8 * j + (lane & 7)) * I8_LD + (lane >> 3) * 16);
        mma_16832_s8(acc, qa[0], b[0], b[1]);
        mma_16832_s8(acc, qa[1], b[2], b[3]);
        const float2 sk = *reinterpret_cast<const float2*>(
            ksc + kt * TK + 8 * j + 2 * (lane & 3));
        s[j][0] = ((float)acc[0] * sq[0]) * sk.x;
        s[j][1] = ((float)acc[1] * sq[0]) * sk.y;
        s[j][2] = ((float)acc[2] * sq[1]) * sk.x;
        s[j][3] = ((float)acc[3] * sq[1]) * sk.y;
      }
    }
  };
};

// Causal attention of one head for query rows [r0, r0 + TQ) over keys
// [0, min(r0 + TQ, n)), on the tensor cores, the cache read as `Tiles`
// says: f32 scores and softmax, the normalised weights rounded to bf16
// before the V product (bf16 values), the context rounded to bf16. Warp w
// takes rows 16 (w % 4) .. + 15 over the key tiles of parity w / 4; the
// two halves' maxima and sums meet in shared memory after the first pass,
// and their context partials after the second, in the order (even tiles)
// + (odd tiles), so the result is the same bits every run.
// The exponential is the fast `__expf` and the division a multiply by
// 1 / sum: f32 rounding apart, the reference's softmax. Grid (heads, query
// tiles); with map.tiles64 (K8) the tile's lane, r0 and stacked row of the
// lane's row 0 come from the table, and the lane's (S, D) slab is read.
template <class Tiles>
__global__ void __launch_bounds__(TA_THREADS)
    attn_prefill_tc_kernel(const bf16* __restrict__ q, Tiles cache, int n,
                           int S, int D, RowMap map, int n_tiles,
                           bf16* __restrict__ ctx) {
  extern __shared__ __align__(16) unsigned char tsm[];
  __shared__ float red[2][2][TQ];  // (max, sum) x key half x row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 3, half = warp >> 2;
  const int off = blockIdx.x * HD;
  const int tile = n_tiles - 1 - (int)blockIdx.y;  // the longest first
  int r0 = tile * TQ;
  size_t slab = 0;
  if (map.tiles64 != nullptr) {
    const int* t = map.tiles64 + 3 * tile;
    n = map.lane_n[t[0]];
    slab = (size_t)t[0] * S;
    r0 = t[1];
    q += (size_t)t[2] * D;
    ctx += (size_t)t[2] * D;
  }
  const int nq = min(TQ, n - r0), kmax = min(r0 + TQ, n);
  const int nkt = (kmax + TK - 1) / TK, nst = (nkt + 1) / 2;
  typename Tiles::Block c(cache, tsm, slab, D, off, nst * 2 * TK);
  // The key rows, two tiles (one a half) a commit group, the query tile
  // in the first, so that pass 1 starts on the first keys while later
  // ones arrive; then V tiles 0 and 1.
  for (int st = 0; st < nst; ++st) {
    c.stage_keys(st, kmax);
    if (st == 0) c.stage_query(q + (size_t)r0 * D, nq);
    cp_async_commit();
  }
  c.fetch_values(0, kmax);
  cp_async_commit();
  const int row_first = r0 + 16 * rg, last_row = row_first + 15;
  const int lr = 16 * rg + (lane >> 2);  // this lane's rows: lr and lr + 8
  const int row0 = r0 + lr, key0 = 2 * (lane & 3);
  float s[8][4];
  // The warp's scores with key tile kt: -inf where the causal mask hides
  // a key (only a tile that reaches past the warp's first row has such
  // keys).
  auto scores = [&](int kt) {
    c.scores(s, kt, lane);
    if (kt * TK + TK - 1 > row_first)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * TK + 8 * j + key0 + (e & 1) > row0 + 8 * (e >> 1))
            s[j][e] = -INFINITY;
  };
  // pass 1: each row's max over its causal keys and its sum of exp(s -
  // max), the sum rescaled when the max grows (no weight is formed yet)
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  for (int st = 0; st < nst; ++st) {
    cp_async_wait(nst - st);  // the key groups up to st (and Q) are in
    __syncthreads();
    if (st == 0) c.load_query(rg, lane);
    const int kt = 2 * st + half;
    if (kt >= nkt || kt * TK > last_row) continue;
    scores(kt);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tm = fmaxf(tm, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      if (tm > mx[h]) {
        sum[h] *= __expf(mx[h] - tm);
        mx[h] = tm;
      }
      if (mx[h] != -INFINITY)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum[h] += __expf(s[j][2 * h] - mx[h]) +
                    __expf(s[j][2 * h + 1] - mx[h]);
    }
  }
  // the quad's four lanes (each pair combined commutatively, so every lane
  // gets the same bits), then the two halves in the order (even, odd)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx[h], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, sum[h], o);
      const float m = fmaxf(mx[h], m2);
      sum[h] = m == -INFINITY ? 0.0f
                              : sum[h] * __expf(mx[h] - m) +
                                    l2 * __expf(m2 - m);
      mx[h] = m;
    }
    if ((lane & 3) == 0) {
      red[0][half][lr + 8 * h] = mx[h];
      red[1][half][lr + 8 * h] = sum[h];
    }
  }
  c.land_values(0);
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lr + 8 * h;
    mx[h] = fmaxf(red[0][0][r], red[0][1][r]);
    inv[h] = 1.0f / (red[1][0][r] * __expf(red[0][0][r] - mx[h]) +
                     (red[0][1][r] == -INFINITY
                          ? 0.0f
                          : red[1][1][r] * __expf(red[0][1][r] - mx[h])));
  }
  // pass 2: the normalised weights, rounded to bf16, times V; step st
  // holds V tiles 2 st and 2 st + 1, one for each half, and brings in the
  // next pair
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst) c.fetch_values(st + 1, kmax);
    cp_async_commit();
    cp_async_wait(1);
    __syncthreads();
    const int kt = 2 * st + half;
    if (kt < nkt && kt * TK <= last_row) {
      scores(kt);
      unsigned pa[4][4];  // A fragments of P, 16 keys each (masked: 0)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = round_t<bf16>(__expf(s[j][e] - mx[e >> 1]) * inv[e >> 1]);
        pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
      }
      const bf16* vt = c.values(st, half);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int d2 = 0; d2 < 4; ++d2) {
          unsigned b[4];
          ldmatrix_x4_trans(b, vt + (16 * kk + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * T_LD +
                                   16 * d2 + (lane >> 4) * 8);
          mma_16816(o[2 * d2], pa[kk], b[0], b[1]);
          mma_16816(o[2 * d2 + 1], pa[kk], b[2], b[3]);
        }
    }
    if (st + 1 < nst) c.land_values(st + 1);
    __syncthreads();  // before the next step reads, or overwrites, a stage
  }
  // the odd tiles' partials through shared memory (over the V stages),
  // added to the even tiles'; rows < nq stored, rounded to bf16
  float* op = reinterpret_cast<float*>(const_cast<bf16*>(c.values(0, 0)));
  if (half == 1)
#pragma unroll
    for (int d = 0; d < 8; ++d)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(op + (lr + 8 * h) * O_LD + 8 * d + key0) =
            make_float2(o[d][2 * h], o[d][2 * h + 1]);
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lr + 8 * h;
      if (r < nq) {
        const float2 u =
            *reinterpret_cast<const float2*>(op + r * O_LD + 8 * d + key0);
        *reinterpret_cast<__nv_bfloat162*>(
            ctx + (size_t)(r0 + r) * D + off + 8 * d + key0) =
            __floats2bfloat162_rn(o[d][2 * h] + u.x, o[d][2 * h + 1] + u.y);
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

// K6c in f32 (bf16 runs attn_prefill_tc_kernel<Int8Tiles>): the scalar
// attn_prefill_kernel on the int8 cache, as models/gpt.py
// `_attention_int8` computes it: the query tile's rows are quantized per
// (row, head) in shared memory (q * (1/sqrt(64)), scale amax / 127), key
// tiles are staged as int8 with their row scales and scored with integer
// __dp4a dots, (score * s_q) * s_k; value tiles are dequantized to T as
// they are staged (round_t<T>(q * s_v)). The causal softmax and the exact
// zeros past each row are attn_prefill_kernel's. Replaces, with the
// tensor-core kernel, the JAX package's XLA attention of an int8 prefill
// (bark_tpu/models/gpt.py:273; its Pallas prefill takes no int8 cache).
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

// The dynamic shared memory of the attention a prefill in T on a dense or
// int8 (`quant`) cache runs, at its most (1024 keys) beyond the default 48
// KB window, set on every call (one host call each), so that it holds on
// whatever device is current and a refusal is reported here, not as a
// failed launch.
template <typename T>
int set_attn_smem(bool quant) {
  const void* k;
  int bytes = QT * 1024 * (int)sizeof(float);  // the scalar kernels' scores
  if constexpr (sizeof(T) == 2) {
    k = quant ? (const void*)attn_prefill_tc_kernel<Int8Tiles>
              : (const void*)attn_prefill_tc_kernel<DenseTiles>;
    bytes = (int)(quant ? Int8Tiles::smem_bytes(1024)
                        : DenseTiles::smem_bytes(1024));
  } else {
    k = quant ? (const void*)attn_prefill_i8_kernel<T>
              : (const void*)attn_prefill_kernel<T>;
  }
  return (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// One layer's causal attention of M stacked query rows q (D wide, heads of
// 64) into ctx over the layer's cache c (int8 when it has row scales):
// bf16 on the tensor cores (attn_prefill_tc_kernel over 64-row query
// tiles, DenseTiles or Int8Tiles), f32 by the scalar kernels (16-row
// tiles). The lanes, query tiles and n_valid as prefill_t takes them.
template <typename T>
int attention(const T* q, const BarkKV& c, int M, int max_n, int n_tiles,
              int n_tiles64, int S, int D, int n_head, const RowMap& map,
              T* ctx, cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)(D / n_head)));
  const bool quant = c.ks != nullptr;
  if constexpr (sizeof(T) == 2) {
    const int keys = cdiv(max_n, 2 * TK) * 2 * TK;
    const dim3 grid(n_head, n_tiles64);
    if (quant)
      attn_prefill_tc_kernel<<<grid, TA_THREADS, Int8Tiles::smem_bytes(keys),
                               st>>>(
          q,
          Int8Tiles{(const signed char*)c.k, (const signed char*)c.v, c.ks,
                    c.vs, scale},
          M, S, D, map, n_tiles64, ctx);
    else
      attn_prefill_tc_kernel<<<grid, TA_THREADS,
                               DenseTiles::smem_bytes(keys), st>>>(
          q, DenseTiles{(const bf16*)c.k, (const bf16*)c.v, scale}, M, S, D,
          map, n_tiles64, ctx);
  } else {
    const int ld = cdiv(max_n, 4) * 4;
    const dim3 grid(n_head, n_tiles);
    const size_t smem = (size_t)QT * ld * sizeof(float);
    if (quant)
      attn_prefill_i8_kernel<T><<<grid, PA_THREADS, smem, st>>>(
          q, (const signed char*)c.k, (const signed char*)c.v, c.ks, c.vs,
          M, S, D, ld, scale, map, ctx);
    else
      attn_prefill_kernel<T><<<grid, PA_THREADS, smem, st>>>(
          q, (const T*)c.k, (const T*)c.v, M, S, D, ld, scale, map, ctx);
  }
  return (int)cudaGetLastError();
}

// The prefill of M stacked rows of B lanes (K2: B = 1, M = n_valid, a null
// map); max_n is the longest lane's n_valid, n_tiles / n_tiles64 the
// attention's 16-row / 64-row query tiles. An int8 `kv` (K6) takes kv_rows,
// (2, M, D) scratch in T for the K/V rows that K6b quantizes. `tp`: the
// bf16 GEMMs' maps and plan (null for f32).
template <typename T>
int prefill_t(const BarkGPTWeights* w, const void* x_emb, int B, int M,
              int max_n, int n_tiles, int n_tiles64, const RowMap& map,
              const BarkKV& kv, void* x_, void* hb_, void* q_, void* ctx_,
              void* ff_, void* kv_rows, const TmaPlan* tp, float* logits,
              int lo, int hi, cudaStream_t st) {
  constexpr bool tc = sizeof(T) == 2;  // tensor cores: bf16
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
  int err = set_attn_smem<T>(quant);
  if (!err && tc) err = set_tma_smem();
  if (err) return err;
  const int total = M * D;
  embed_rows_kernel<T><<<cdiv(total, 256), 256, 0, st>>>(
      (const T*)x_emb, (const T*)w->wpe, M, D, map, x);
  err = (int)cudaGetLastError();
  if (err) return err;
  for (int l = 0; l < L; ++l) {
    const BarkKV c = kv_at(kv, l * slab, D, sizeof(T));
    ln_rows_kernel<T><<<M, LN_THREADS, D * sizeof(float), st>>>(
        x, (const T*)w->ln1_g + l * LD, (const T*)w->ln1_b + l * LD, D, hb);
    // the K/V rows go to the cache, or to kv_rows for K6b to quantize
    const GemmOut qkv_out = quant
        ? GemmOut{qb, rows, rows + (size_t)M * D, D, nullptr}
        : GemmOut{qb, c.k, c.v, D, map.slot};
    err = gemm<T, GE_QKV>(tp, P_QKV, hb, (const T*)w->qkv_w,
                          (const T*)w->qkv_b + l * 3 * LD, M, 3 * D, D, l,
                          qkv_out, st);
    if (err) return err;
    if (quant) {
      quant_rows_kernel<T><<<dim3(M, 2), LN_THREADS, 0, st>>>(
          rows, M, D, map.slot, (signed char*)c.k, (signed char*)c.v, c.ks,
          c.vs);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
    err = attention<T>(qb, c, M, max_n, n_tiles, n_tiles64, S, D, w->n_head,
                       map, ctx, st);
    if (err) return err;
    err = gemm<T, GE_RESID>(tp, P_PROJ, ctx, (const T*)w->proj_w,
                            (const T*)w->proj_b + l * LD, M, D, D, l,
                            GemmOut{x, nullptr, nullptr, D, nullptr}, st);
    if (err) return err;
    ln_rows_kernel<T><<<M, LN_THREADS, D * sizeof(float), st>>>(
        x, (const T*)w->ln2_g + l * LD, (const T*)w->ln2_b + l * LD, D, hb);
    err = gemm<T, GE_GELU>(tp, P_FC, hb, (const T*)w->fc_w,
                           (const T*)w->fc_b + l * 4 * LD, M, 4 * D, D, l,
                           GemmOut{ff, nullptr, nullptr, D, nullptr}, st);
    if (err) return err;
    err = gemm<T, GE_RESID>(tp, P_OUT, ff, (const T*)w->out_w,
                            (const T*)w->out_b + l * LD, M, D, 4 * D, l,
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

// The dtype's prefill: bf16 through the TMA + wgmma GEMMs (their plan and
// maps checked, the activations' encoded for M rows, before any launch),
// f32 through the SIMT ones.
int prefill_dtype(const BarkGPTWeights* w, const void* x_emb, int B, int M,
                  int max_n, int n_tiles, int n_tiles64, const RowMap& map,
                  const BarkKV& kv, void* x, void* hb, void* q, void* ctx,
                  void* ff, void* kv_rows, const void* wmaps,
                  const int* plan, float* part, int* tickets, float* logits,
                  int lo, int hi, cudaStream_t st) {
  if (w->dtype != BARK_BF16)
    return prefill_t<float>(w, x_emb, B, M, max_n, n_tiles, n_tiles64, map,
                            kv, x, hb, q, ctx, ff, kv_rows, nullptr, logits,
                            lo, hi, st);
  TmaPlan tp;
  if (!make_tma_plan(w, wmaps, plan, part, tickets, M, hb, ctx, ff, &tp))
    return -1;
  return prefill_t<bf16>(w, x_emb, B, M, max_n, n_tiles, n_tiles64, map, kv,
                         x, hb, q, ctx, ff, kv_rows, &tp, logits, lo, hi, st);
}

// The RowMap of K8's `tables` (bark_prefill_batched) for B lanes, M
// stacked rows and n_tiles 16-row query tiles.
RowMap lane_map(const int* tables, int B, int M, int n_tiles) {
  const int* t = tables + 3 * M + 3 * n_tiles;  // lane_n, last, tiles64
  return RowMap{tables, tables + M, tables + 2 * M, tables + 3 * M,
                t, t + B, t + 2 * B};
}

}  // namespace

// The tensor maps of a bf16 stage's four projection weights, which the
// prefills' GEMMs read in place: qkv, proj, fc and out, 4 CUtensorMap of
// 128 bytes into `maps` (host memory the caller keeps with the weights and
// passes to bark_prefill / bark_prefill_batched). Returns 0, or -1 for f32
// weights, a width the GEMM does not take, or a map the driver refuses
// (e.g. weights not 16-byte aligned).
extern "C" int bark_prefill_weight_maps(const BarkGPTWeights* w,
                                        void* maps) {
  const int L = w->n_layer, D = w->n_embd;
  CUtensorMap m[4];
  if (w->dtype != BARK_BF16 || D % WG_BK ||
      !encode_weights(&m[P_QKV], w->qkv_w, L, D, 3 * D) ||
      !encode_weights(&m[P_PROJ], w->proj_w, L, D, D) ||
      !encode_weights(&m[P_FC], w->fc_w, L, D, 4 * D) ||
      !encode_weights(&m[P_OUT], w->out_w, L, 4 * D, D))
    return -1;
  memcpy(maps, m, sizeof(m));
  return 0;
}

// Returns cudaGetLastError() after the launches (0 on success). x_emb holds
// >= n_valid rows (T, D) of token embeddings without positions; cache rows
// [0, n_valid) of every layer are written, later rows are left as they
// were. The caches are int8 with (L, S) f32 row scales when k_scale and
// v_scale are given (K6b, K6c), and kv_rows is then (2, n_valid, D) scratch
// in the params dtype. x, hb, q, ctx (n_valid, D) and ff (n_valid, 4D) are
// caller-allocated scratch in the params dtype; logits (n_out_vocab,) f32
// are those of row n_valid-1, zero outside [lo, hi). bf16 weights also take
// `wmaps` (bark_prefill_weight_maps), `plan` (host ints: N tile and K
// splits of qkv, proj, fc, out; kernels/prefill.py gemm_plan), `part` (f32
// scratch of splits * n_valid * N floats for every split projection) and
// `tickets` (int32 scratch, zeroed once, of a projection's row tiles x
// column tiles); f32 weights ignore them.
extern "C" int bark_prefill(const BarkGPTWeights* w, const void* x_emb,
                            int n_valid, void* k_cache, void* v_cache,
                            float* k_scale, float* v_scale, void* x, void* hb,
                            void* q, void* ctx, void* ff, void* kv_rows,
                            const void* wmaps, const int* plan, float* part,
                            int* tickets, float* logits, int lo, int hi,
                            cudaStream_t stream) {
  if (w->n_embd / w->n_head != HD || w->n_embd % BN || n_valid <= 0 ||
      n_valid > w->block_size || w->block_size > 1024 ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (k_scale != nullptr && kv_rows == nullptr))
    return -1;
  const RowMap map{nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr};
  const BarkKV kv{k_cache, v_cache, k_scale, v_scale};
  return prefill_dtype(w, x_emb, 1, n_valid, n_valid, cdiv(n_valid, QT),
                       cdiv(n_valid, TQ), map, kv, x, hb, q, ctx, ff,
                       kv_rows, wmaps, plan, part, tickets, logits, lo, hi,
                       stream);
}

// K8. Returns as bark_prefill. x_emb is (B, T, D); the caches are
// (L, B, S, D); `tables` is one device int32 buffer holding, in order,
// src, pos, slot (M each), tiles (3 * n_tiles), lane_n and last (B each)
// of `RowMap`, then tiles64 (3 * n_tiles64), for M = sum(lane_n) stacked
// rows; max_n = max(lane_n), n_tiles = sum(ceil(lane_n / 16)) and
// n_tiles64 = sum(ceil(lane_n / 64)) (query tiles of 16 and 64 rows).
// Int8 caches take (L, B, S) f32 row scales and kv_rows, as bark_prefill.
// x, hb, q, ctx (M, D) and ff (M, 4D) are scratch in the params dtype;
// wmaps, plan, part and tickets as bark_prefill's, for M rows; logits (B,
// n_out_vocab) f32 are those of each lane's last live row, zero outside
// [lo, hi).
extern "C" int bark_prefill_batched(const BarkGPTWeights* w,
                                    const void* x_emb, int B, int M,
                                    int max_n, int n_tiles, int n_tiles64,
                                    const int* tables, void* k_cache,
                                    void* v_cache, float* k_scale,
                                    float* v_scale, void* x, void* hb,
                                    void* q, void* ctx, void* ff,
                                    void* kv_rows, const void* wmaps,
                                    const int* plan, float* part,
                                    int* tickets, float* logits, int lo,
                                    int hi, cudaStream_t stream) {
  if (w->n_embd / w->n_head != HD || w->n_embd % BN || B <= 0 || M <= 0 ||
      max_n <= 0 || max_n > w->block_size || w->block_size > 1024 ||
      n_tiles <= 0 || n_tiles64 <= 0 ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (k_scale != nullptr && kv_rows == nullptr))
    return -1;
  const BarkKV kv{k_cache, v_cache, k_scale, v_scale};
  return prefill_dtype(w, x_emb, B, M, max_n, n_tiles, n_tiles64,
                       lane_map(tables, B, M, n_tiles), kv, x, hb, q, ctx, ff,
                       kv_rows, wmaps, plan, part, tickets, logits, lo, hi,
                       stream);
}

// K6c alone (kernels/kv8.py `attn_prefill`): one layer's causal attention
// of a prefill, the prefills' own launch, on given query rows; the
// prefills never call it. q and ctx are (M, D) in `dtype` (BARK_BF16: the
// tensor-core kernel, else f32: the scalar one), heads of 64; kv holds the
// layer's cache, (B, S, D) int8 values with (B, S) f32 row scales (K6c),
// or, without scales, (B, S, D) in `dtype` (the dense attention, its
// yardstick). One lane (B 1, tables null): M = max_n = n_valid, n_tiles =
// ceil(M / 16), n_tiles64 = ceil(M / 64). B lanes: M stacked rows and
// `tables`, max_n, n_tiles and n_tiles64 as bark_prefill_batched takes
// them. Returns cudaGetLastError() after the launch, or -1 for a shape it
// does not take.
extern "C" int bark_launch_attn_prefill(int dtype, const void* q, BarkKV kv,
                                        int B, int M, int max_n,
                                        int n_tiles, int n_tiles64,
                                        const int* tables, int S, int D,
                                        int n_head, void* ctx,
                                        cudaStream_t stream) {
  if (n_head <= 0 || D != n_head * HD || S > 1024 || B <= 0 || M <= 0 ||
      max_n <= 0 || max_n > S || n_tiles <= 0 || n_tiles64 <= 0 ||
      (kv.ks == nullptr) != (kv.vs == nullptr) ||
      (tables == nullptr && (B != 1 || M != max_n)))
    return -1;
  const bool quant = kv.ks != nullptr;
  const RowMap map = tables != nullptr
                         ? lane_map(tables, B, M, n_tiles)
                         : RowMap{nullptr, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, nullptr};
  if (dtype == BARK_BF16) {
    const int err = set_attn_smem<bf16>(quant);
    return err ? err
               : attention<bf16>((const bf16*)q, kv, M, max_n, n_tiles,
                                 n_tiles64, S, D, n_head, map, (bf16*)ctx,
                                 stream);
  }
  const int err = set_attn_smem<float>(quant);
  return err ? err
             : attention<float>((const float*)q, kv, M, max_n, n_tiles,
                                n_tiles64, S, D, n_head, map, (float*)ctx,
                                stream);
}
