// K7, the batched decode step, and K5-batched, the same step on
// packed-quantized weights: one token through every layer of a GPT stage
// for B = 1..32 lanes, as ONE persistent kernel a step; K6 (the int8 KV
// cache) inside both. Also K8's batched LM head.
//
// Replaces bark_tpu/kernels/decode.py `decode_step_fused_batched` (:2043,
// its pallas_call at :2174, body `_decode_kernel_batched` :1766): per lane
// b, embed tok[b] at n_past[b] -> L x [LN1 -> QKV -> K/V row written at [l,
// b, n_past[b]] (`_stage_kv_rows` :1301) -> attention over that lane's
// rows <= n_past[b] -> proj + residual -> LN2 -> fc -> tanh-GELU -> out +
// residual] -> ln_f -> LM head over [lo, hi); with quant=True the weights
// are int8 values with per-32-row scales [and mins] (`_tile_stream` :512,
// `_qdot` :1016, `_embed_token` :2371), with kv_quant the int8 cache
// (:1937-1982). The caches are (L, B, S, D); the tokens and each lane's
// slot are read from device memory, never on the host.
//
// What bounds it on an H100: bytes, and barriers. A step streams every
// weight once for all lanes (bark-small: 170 MB in bf16, ~110 MB packed
// q4_0) plus each lane's live cache rows (at B = 32 and n_past 300: 542 MB
// in all, 0.162 ms at 3.35 TB/s) and does 2 FLOPs a weight a lane: 6.3
// GFLOP at B = 32, 6.4 us on the tensor cores at 989 TFLOP/s. Each
// dependent phase costs a grid barrier (~1.5 us, probes/lowering.py P1),
// 5 a layer and one after the embed: 61 for bark-small.
//
// What the design does about it (one cooperative launch of the card's
// co-resident block count, 512 threads, the layer loop inside; the host's
// `lane_plan` says which block takes which (64-column tile, K range) of
// each product and in which order each tile's partials are folded):
// - The products run with the lanes as the N side of the tensor cores'
//   mma.sync m16n8k16 (bf16 in, f32 sums): the weight tile's 64 columns
//   are four m16 tiles, its rows the K side, the lanes n8 tiles (B
//   rounded up to 8). wgmma would want 64 rows on its M side: the lanes
//   would waste half a tile or more of it at B <= 32, and m16n8k16 takes
//   the weights on M, the lanes on N, at any B. 16 warps: 4 m16 tiles x 4
//   k-groups, whose sums are added in a fixed order. The weights stream
//   as bulk copies into a 128 KB ring (K1's chunks, 16 KB in bf16) from a
//   copy laid out in the fragments' order (`lane_tiles`), so a thread's A
//   fragment of a 16 x 16 step is one 16-byte shared load: no ldmatrix,
//   no swizzle. A packed record's 16 x 32 values of a thread are one
//   16-byte load too: each value is rounded to T from q * s in f32 once
//   and feeds every lane; the min term (blocksums(x) @ m) stays on the
//   CUDA cores. f32 weights keep CUDA-core FMAs (the tensor cores would
//   round them to TF32): a thread a column and 4 lanes.
// - A block holds only its item's input rows, all lanes (<= 512 rows x 32
//   lanes, 33 KB in bf16), built from the step's f32 rows in device
//   memory (x, the attention's context, fc's GELU output), LayerNormed
//   per lane on the way; the LN's affine waits in shared memory (loaded
//   in the wait of the barrier before the product), each lane's
//   statistics come from the residual's tile statistics.
// - Each column is folded once: the last block to write a partial of a
//   tile (a ticket: thread 0's acquire-release add) copies the tile's
//   partials into shared memory by cp.async, adds them in the plan's
//   order, applies the epilogue (bias, GELU, residual) for every lane and
//   writes each row once; a residual fold also writes its 64 columns'
//   mean and squared deviations per lane, which an LN's consumer combines
//   (the mean of the means, the deviations with each tile's offset), so
//   no block reads a whole row to normalise it.
// - Attention runs as (head, lane) units, split over the blocks by each
//   lane's live rows (n_past[b] + 1 + a fixed cost), a split every block
//   computes alike from n_past at the start; a block runs its units at
//   once on groups of 512 / 256 / 128 threads (one, two, more units), each
//   K1's `attend_dense` or `attend_int8` (K6a) on a named barrier of its
//   own; a unit writes its head's cache row (int8 with the row scales
//   from the K and V tiles' amax). In the wait of the barrier before a
//   layer the TMA engine is asked to bring each lane's cache rows of that
//   layer into the L2 (one bulk prefetch a slab).
// - Barriers are split as K1's: a block arrives, refills its ring, then
//   waits. The barrier count and the tickets live in the step's scratch;
//   the last block out resets the count, each folder its ticket.
// - `stamps` (null when serving): every block's %globaltimer at the start,
//   after the embed's barrier, at each layer barrier's arrival and release,
//   and at the end, a row of 2 x 5 L + 3 a block.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (probes/
// bdecode_profile.py, this kernel and the 62-launch chain it replaces in
// one call; PERF.md): the bf16 step at n_past 300 takes 0.505-0.509 /
// 0.524-0.535 / 0.955-0.968 ms at B 1 / 8 / 32 (the chain 0.559-0.561 /
// 0.820 / 2.094-2.098), q4_0 0.484 / 0.491-0.498 / 0.909-0.914 (0.518-
// 0.529 / 0.716-0.717 / 1.921-1.922), on the int8 cache 0.501-0.506 /
// 0.513-0.525 / 0.830-0.834 (0.576 / 0.807-0.808 / 2.027-2.028). What
// bounds it now is not its bytes (it runs at 11-17% of their bound) but
// the latency of each phase's chain of dependent steps (inputs from the
// L2, the products, the partial, the ticket, the fold's loads, the
// barrier), ~1-2 us each under the weight stream (every block's stamps,
// `decode.step_critical_us`), and at 32 lanes the attention's dependent
// rounds of cache-row loads (~19 us a layer on the slowest block).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "step.cuh"

namespace {

constexpr int MAX_LANES = 32;
constexpr int LANE_ROWS = 512;         // most K rows of an item (lane_plan's)
constexpr int VIN_BF = LANE_ROWS + 8;  // a lane's bf16 inputs, padded so a
                                       // warp's B fragments miss no bank
constexpr int VIN_F = LANE_ROWS + 4;   // a lane's f32 inputs
constexpr int RED_LD = 68;             // a lane's 64 k-group sums, padded
constexpr int ATT_COST = 128;  // a (head, lane) unit's cost beside its rows
constexpr int ATT_GROUPS = 4;  // the most units a block attends at once
constexpr int FOLD_FLOATS = 22528;  // partials a fold stages at once
constexpr int VIN_QUADS = 2;   // 4-row runs of inputs a thread loads at once
constexpr int MAX_OWN = 16;    // items of a product a block takes
constexpr int MAX_TILES = 16;  // 64-column tiles of a row: D <= 1024

// the lane plan's header (kernels/decode.py `LanePlan.table`, whose `LP_*`
// names these slots too: keep the two alike); per phase (qkv, proj, fc,
// out, lm) the offsets of its items (4 ints each: tile, k0, k1, 0), block
// starts, fold offsets and fold lists, its first tile and its tiles
enum {
  LP_BLOCKS = 0, LP_BARRIERS = 1, LP_LAYERS = 2, LP_LANES = 3, LP_LO = 4,
  LP_HI = 5, LP_PACKED = 6, LP_PAIRS = 7, LP_NPAIRS = 8, LP_ITEMS = 9,
  LP_STARTS = 14, LP_FOLD_OFF = 19, LP_FOLD = 24, LP_TILE0 = 29,
  LP_NTILES = 34
};
enum { LQ = 0, LPROJ = 1, LFC = 2, LOUT = 3, LLM = 4, LPH = 5 };
constexpr int LAYER_BARRIERS = 5;  // qkv, attention, proj, fc, out
// ints of shared memory: the ticket's verdict, the warps' sums, then each
// product's count of the block's items and those items (i, tile, k0, k1)
constexpr int INTS = 64 + LPH * (1 + 4 * MAX_OWN) + 3;  // a multiple of 4

template <typename Weights>
struct LaneArgs {
  Weights w;
  // the tiled copies (`lane_tiles`): qkv, proj, fc, out (L, N/64, K, 64),
  // the LM head's transpose (v_pad/64, D, 64), in the read's layout
  const void* tiles[LPH];
  const int* plan;    // the lane_plan table
  const int* tok;     // (B,) tokens, in device memory
  const int* n_past;  // (B,) slots, in device memory
  BarkKV kv;          // the stage's (L, B, S, D) caches (int8 with scales)
  float* work;        // the step's f32 rows and partials (`lane_work`)
  unsigned* sync;     // [0] the grid barrier's count, then the tickets
  unsigned long long* stamps;  // blocks x (2 x 5 L + 3), or null
  float* logits;      // (B, n_out_vocab)
  int B;
};

// f32 floats of the step's work buffer ahead of its partials: x (B, D),
// qkv (B, 3D), ctx (B, D), h (B, 4D), the residual's tile statistics
// (D/64, B, 2) and the K and V tiles' amax (2D/64, B)
// (kernels/decode.py `lane_work_floats` adds the partials)
__host__ __device__ inline size_t lane_rows_floats(int B, int D) {
  return (size_t)B * 9 * D + (size_t)(D / TILE) * B * 2 +
         (size_t)(2 * D / TILE) * B;
}

// floats of the shared memory of one attention group of KG key groups (8
// KG threads): its scores (S, rounded up to 4 so that K6a's rows stay
// aligned), the key groups' sums, q, k, v, a reduction's 32, K6a's three
// int8 rows
__host__ __device__ inline int att_floats(int S, int KG) {
  return (S + 3) / 4 * 4 + KG * (HD + 1) + 3 * HD + 32 + 3 * (HD / 4);
}

// Shared memory (dynamic): the ring and its mbarriers, the lanes' LN
// statistics, a few ints and the block's items, the next LN's affine,
// then one region that the products (inputs, block sums, k-group sums,
// staged tile statistics), a fold (staged partials) and the attention
// (each group's scores, key groups' sums, rows) take in turn: ~226 KB.
inline size_t lane_work_bytes(int S, bool mma) {
  const size_t vin = mma ? (size_t)MAX_LANES * VIN_BF * 2
                         : (size_t)MAX_LANES * VIN_F * 4;
  const size_t gemv = vin + 4 * MAX_LANES * (LANE_ROWS / QB) +
                      (mma ? 4 * 4 * MAX_LANES * RED_LD : 0) +
                      8 * MAX_LANES * MAX_TILES;
  const size_t att = 4 * ATT_GROUPS *
                     (size_t)att_floats(S, PS_THREADS / ATT_GROUPS / 8);
  return std::max(std::max(gemv, att), (size_t)4 * FOLD_FLOATS);
}
inline size_t lane_smem(int S, bool mma) {
  return RING_BYTES + 8 * MAX_SLOTS +
         4 * (2 * MAX_LANES + INTS + 2 * MAX_TILES * TILE) +
         lane_work_bytes(S, mma);
}

// *t += 1 at gpu scope, releasing what the block wrote before its last
// barrier and acquiring what the other blocks released; the old value
__device__ __forceinline__ unsigned ticket_add(unsigned* t) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(t)
               : "memory");
  return old;
}

// One block's view of the batched step. Every member function is called by
// all threads of the block alike.
template <typename R>
struct LaneStep {
  using T = typename R::T;
  static constexpr bool MMA = sizeof(T) == 2;  // bf16: the tensor cores
  static constexpr int SLOT = R::SLOT;
  static constexpr int NS = RING_BYTES / SLOT;
  static_assert(NS <= MAX_SLOTS, "the ring has mbarriers for MAX_SLOTS");

  const LaneArgs<typename R::Weights>& a;
  const int* plan;  // in device memory, read through the L1
  int G, L, D, S, B, NT, b, V;
  float *x, *qkv, *ctx, *hb, *stats, *amax, *partial;  // device memory
  unsigned *count, *tickets;
  unsigned char* ring;
  uint64_t* full;
  float* lstat;  // each lane's LN mean and 1 / std
  int* ints;     // [0] the ticket's verdict, [32..47] the warps' sums
  int* own_n;    // [p]: the block's items of product p
  int* own;      // [p][j]: its j-th (i, tile, k0, k1)
  float* lnp;    // the next LN's affine, g then b (D each), as f32
  // the products' view of the work region
  T* vin;       // (32, VIN_*) the item's input rows, lane-major
  float* bsum;  // (32, 16) each lane's 32-row block sums of vin
  float* red;   // (4, 32, RED_LD) the k-groups' sums
  float2* st;   // (MAX_TILES, 32) the residual's tile statistics, staged
  float* att;   // the attention's view of it: ATT_GROUPS x att_floats
  int issued, freed, taken;  // the ring: as K1's
  int c_layer, c_phase, c_item, c_row;  // the producer's cursor
  int p0, p1;  // the block's (head, lane) units

  __device__ LaneStep(const LaneArgs<typename R::Weights>& args,
                      unsigned char* smem)
      : a(args), plan(args.plan), G(gridDim.x), L(args.w.n_layer),
        D(args.w.n_embd), S(args.w.block_size), B(args.B),
        NT((args.B + 7) / 8), b(blockIdx.x), V(args.w.n_out_vocab),
        issued(0), freed(0), taken(0), c_layer(0), c_phase(0), c_item(0),
        c_row(0), p0(0), p1(0) {
    x = a.work;
    qkv = x + (size_t)B * D;
    ctx = qkv + (size_t)B * 3 * D;
    hb = ctx + (size_t)B * D;
    stats = hb + (size_t)B * 4 * D;
    amax = stats + (size_t)(D / TILE) * B * 2;
    partial = a.work + lane_rows_floats(B, D);
    count = a.sync;
    tickets = a.sync + 1;
    ring = smem;
    full = reinterpret_cast<uint64_t*>(smem + RING_BYTES);
    lstat = reinterpret_cast<float*>(full + MAX_SLOTS);
    ints = reinterpret_cast<int*>(lstat + 2 * MAX_LANES);
    own_n = ints + 64;
    own = own_n + LPH;
    lnp = reinterpret_cast<float*>(ints + INTS);
    unsigned char* w =
        reinterpret_cast<unsigned char*>(lnp + 2 * MAX_TILES * TILE);
    vin = reinterpret_cast<T*>(w);
    bsum = reinterpret_cast<float*>(
        w + (MMA ? MAX_LANES * VIN_BF * 2 : MAX_LANES * VIN_F * 4));
    red = bsum + MAX_LANES * (LANE_ROWS / QB);
    st = reinterpret_cast<float2*>(red + (MMA ? 4 * MAX_LANES * RED_LD : 0));
    att = reinterpret_cast<float*>(w);
  }

  __device__ __forceinline__ int pl(int i) const { return __ldg(plan + i); }
  __device__ __forceinline__ int start(int p, int blk) const {
    return pl(pl(LP_STARTS + p) + blk);
  }
  __device__ __forceinline__ void item(int p, int i, int& tile, int& k0,
                                       int& k1) const {
    const int o = pl(LP_ITEMS + p) + 4 * i;
    tile = pl(o);
    k0 = pl(o + 1);
    k1 = pl(o + 2);
  }

  // The ring's mbarriers, and the block's items of each product (read at
  // every chunk) from the plan into shared memory.
  __device__ void setup() {
    if (threadIdx.x == 0) {
      for (int i = 0; i < NS; ++i) mbar_init(&full[i], 1);
      mbar_fence_init();
    }
    if ((int)threadIdx.x < LPH) {
      const int p = threadIdx.x, i0 = start(p, b), n = start(p, b + 1) - i0;
      if (n > MAX_OWN) __trap();  // the wrapper's plans stay below
      own_n[p] = n;
      for (int j = 0; j < n; ++j) {
        int* o = own + (p * MAX_OWN + j) * 4;
        o[0] = i0 + j;
        item(p, i0 + j, o[1], o[2], o[3]);
      }
    }
    __syncthreads();
  }

  // phase p's tiled weight of layer l (the LM head's for p == LLM), its K
  __device__ const unsigned char* tiles(int p, int l, int& K) const {
    if (p == LLM) {
      K = D;
      return (const unsigned char*)a.tiles[LLM];
    }
    const int N = p == LQ ? 3 * D : p == LFC ? 4 * D : D;
    K = p == LOUT ? 4 * D : D;
    return (const unsigned char*)a.tiles[p] +
           (size_t)l * (N / TILE) * R::tile_bytes(K);
  }

  // The chunk at the producer's cursor (layers x the four products, then
  // the LM head's items), advancing it; false past the block's last.
  __device__ bool next_chunk(const void*& src, unsigned& bytes) {
    while (c_layer <= L) {
      const int p = c_layer == L ? LLM : c_phase;
      if (c_item >= own_n[p]) {
        c_item = 0;
        c_row = 0;
        if (c_layer == L || ++c_phase == 4) {
          c_phase = 0;
          ++c_layer;
        }
        continue;
      }
      const int* o = own + (p * MAX_OWN + c_item) * 4;
      const int tile = o[1], k0 = o[2], k1 = o[3];
      if (k0 + c_row >= k1) {
        ++c_item;
        c_row = 0;
        continue;
      }
      int K;
      const unsigned char* W = tiles(p, c_layer, K);
      const int rows = min(R::CH, k1 - k0 - c_row);
      src = W + (size_t)tile * R::tile_bytes(K) + R::row_at(k0 + c_row);
      bytes = R::row_at(rows);
      c_row += rows;
      return true;
    }
    return false;
  }

  // the ring, as K1's (decode.cu Step::top_up, take, release)
  __device__ void top_up() {
    while (issued < freed + NS) {
      const void* src;
      unsigned bytes;
      if (!next_chunk(src, bytes)) return;
      if (threadIdx.x == 0) {
        const int slot = issued % NS;
        mbar_expect_tx(&full[slot], bytes);
        bulk_copy(ring + (size_t)slot * SLOT, src, bytes, &full[slot]);
      }
      ++issued;
    }
  }
  __device__ const unsigned char* take() {
    const int i = taken++;
    mbar_wait(&full[i % NS], (i / NS) & 1);
    __syncthreads();
    freed = i;
    top_up();
    return ring + (size_t)(i % NS) * SLOT;
  }
  __device__ void release() {
    freed = taken;
    top_up();
  }

  // The block's (head, lane) units [p0, p1): the plan's pairs in order,
  // each costing its lane's live rows + 1 + ATT_COST, go to the block that
  // holds the midpoint of their cost (every block computes the same split;
  // kernels/decode.py `lane_units` is its mirror).
  __device__ void assign_units() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n = pl(LP_NPAIRS);
    int c = 0;
    if ((int)threadIdx.x < n) {
      const int np = a.n_past[pl(pl(LP_PAIRS) + 2 * threadIdx.x + 1)];
      c = (np >= 0 && np < S ? np + 1 : 0) + ATT_COST;
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int* wsum = ints + 32;
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int before = incl - c, total = 0;
    for (int w = 0; w < PS_WARPS; ++w) {
      if (w < warp) before += wsum[w];
      total += wsum[w];
    }
    const long long mid = 2LL * before + c;
    const int owner = (int)(mid * G / (2LL * total));
    const bool mine = (int)threadIdx.x < n;
    p0 = __syncthreads_count(mine && owner < b);
    p1 = __syncthreads_count(mine && owner <= b);
  }

  // this block's share of zeroing the logits outside [lo, hi)
  __device__ void zero_window() const {
    const int lo = pl(LP_LO), hi = pl(LP_HI);
    if (lo == 0 && hi == V) return;
    for (int i = b * PS_THREADS + threadIdx.x; i < B * V;
         i += G * PS_THREADS) {
      const int c = i % V;
      if (c < lo || c >= hi) a.logits[i] = 0.0f;
    }
  }

  // a residual tile's statistics for lane bb (the warp's columns 2 lane,
  // 2 lane + 1 of it): the mean and the squared deviations from it
  __device__ void tile_stats(int tile, int bb, float v0, float v1) const {
    const float mean = warp_sum(v0 + v1) / (float)TILE;
    const float d0 = v0 - mean, d1 = v1 - mean;
    const float m2 = warp_sum(d0 * d0 + d1 * d1);
    if ((threadIdx.x & 31) == 0)
      __stcg(reinterpret_cast<float2*>(stats) + (size_t)tile * B + bb,
             make_float2(mean, m2));
  }

  // x = wte[tok] + wpe[n_past] for every lane, a warp a (lane, tile) of
  // the grid's, with the tile's statistics (NaN for a token or slot
  // outside its table)
  __device__ void embed() const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nt = D / TILE;
    for (int u = b * PS_WARPS + warp; u < B * nt; u += G * PS_WARPS) {
      const int bb = u / nt, tile = u - bb * nt;
      const int t = a.tok[bb], np = a.n_past[bb];
      const bool ok = t >= 0 && t < a.w.n_in_vocab && np >= 0 && np < S;
      const int col = tile * TILE + 2 * lane;
      float v0 = NAN, v1 = NAN;
      if (ok) {
        const T* wpe = (const T*)a.w.wpe + (size_t)np * D;
        v0 = round_t<T>(R::embed(a.w, t, col, D) + to_f32(wpe[col]));
        v1 = round_t<T>(R::embed(a.w, t, col + 1, D) + to_f32(wpe[col + 1]));
      }
      __stcg(reinterpret_cast<float2*>(x + (size_t)bb * D + col),
             make_float2(v0, v1));
      tile_stats(tile, bb, v0, v1);
    }
  }

  // The item's input rows [k0, k1) of every lane into vin, 4-row runs a
  // thread (LayerNormed for qkv, fc and the LM head, the affine from lnp,
  // which the barrier before the product loaded), and with mins their
  // 32-row block sums. `with_stats`: the first item of an LN product also
  // computes every lane's mean and 1 / std from the residual's tile
  // statistics, a warp a lane: the mean of the tiles' means, and the sum
  // of their squared deviations, each with 64 x its mean's from the row's
  // (the tiles are alike in size), both summed over the warp's threads in
  // a fixed order; their loads go out with the first rows'.
  __device__ void build_vin(int p, int l, int k0, int k1,
                            bool with_stats) {
    const int q = (k1 - k0) / 4;
    const float* src = p == LPROJ ? ctx : p == LOUT ? hb : x;
    const size_t ld = p == LOUT ? 4 * (size_t)D : (size_t)D;
    const bool has_ln = p == LQ || p == LFC || p == LLM;  // affine: lnp
    const int nt = D / TILE;
    if (with_stats && (int)threadIdx.x < B * nt)
      st[threadIdx.x] =
          __ldcg(reinterpret_cast<const float2*>(stats) + threadIdx.x);
    float4 v[VIN_QUADS];
    auto load = [&](int e0) {
#pragma unroll
      for (int u = 0; u < VIN_QUADS; ++u) {
        const int e = e0 + u * PS_THREADS, lane = e / q;
        if (e < B * q)
          v[u] = __ldcg(reinterpret_cast<const float4*>(
              src + (size_t)lane * ld + k0 + 4 * (e - lane * q)));
      }
    };
    auto put = [&](int e0) {
#pragma unroll
      for (int u = 0; u < VIN_QUADS; ++u) {
        const int e = e0 + u * PS_THREADS, lane = e / q;
        const int r = 4 * (e - lane * q);
        if (e >= B * q) break;
        float y[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        T* o = vin + lane * (MMA ? VIN_BF : VIN_F) + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (has_ln) {
            const float z = (y[c] - lstat[2 * lane]) * lstat[2 * lane + 1];
            y[c] = round_t<T>(z * lnp[k0 + r + c] + lnp[D + k0 + r + c]);
          }
          o[c] = from_f32<T>(y[c]);
        }
      }
    };
    load(threadIdx.x);
    if (with_stats) {
      __syncthreads();
      {  // warp w: lanes w, w + 16; its thread t: tile t
        const int t = threadIdx.x & 31;
        for (int ln = threadIdx.x >> 5; ln < B; ln += PS_WARPS) {
          const float2 s2 = t < nt ? st[t * B + ln] : make_float2(0.f, 0.f);
          const float mean = warp_sum(s2.x) / (float)nt;
          const float d = s2.x - mean;
          const float m2 = warp_sum(t < nt ? s2.y + (float)TILE * d * d : 0.f);
          if (t == 0) {
            lstat[2 * ln] = mean;
            lstat[2 * ln + 1] = 1.0f / sqrtf(m2 / (float)D + BARK_EPS_NORM);
          }
        }
      }
      __syncthreads();
    }
    put(threadIdx.x);
    for (int e0 = threadIdx.x + PS_THREADS * VIN_QUADS; e0 < B * q;
         e0 += PS_THREADS * VIN_QUADS) {
      load(e0);
      put(e0);
    }
    if constexpr (R::MINS) {
      __syncthreads();
      const int nb = 4 * q / QB;
      for (int e = threadIdx.x; e < B * nb; e += PS_THREADS) {
        const int ln = e / nb, blk = e - ln * nb;
        const T* v = vin + ln * (MMA ? VIN_BF : VIN_F) + blk * QB;
        float s = 0.0f;
        for (int i = 0; i < QB; ++i) s += to_f32(v[i]);
        bsum[ln * (LANE_ROWS / QB) + blk] = s;
      }
    }
    __syncthreads();
  }

  // ---------------------------------------------- a chunk's products

  // bf16 dense: the chunk's rows in 16-row steps of the fragments' layout
  // (per step: 4 m16 tiles x 32 lanes x 8 values); warp (mt, kg) takes
  // steps kg, kg + 4 of its m16 tile for every n8 tile of lanes
  __device__ void mma_dense(const unsigned char* slot, int r0, int rows,
                            float (&acc)[4][4]) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int mt = warp & 3, kg = warp >> 2, g = lane >> 2, t = lane & 3;
    const bf16* xin = reinterpret_cast<const bf16*>(vin);
    for (int ks = kg; ks < rows / 16; ks += 4) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          slot + ((size_t)(ks * 4 + mt) * 32 + lane) * 16);
      const unsigned av[4] = {w.x, w.y, w.z, w.w};
      const int kk = r0 + ks * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < NT) {
          const bf16* row = xin + (8 * j + g) * VIN_BF + kk;
          mma_16816(acc[j], av, *reinterpret_cast<const unsigned*>(row),
                    *reinterpret_cast<const unsigned*>(row + 8));
        }
      }
    }
  }

  // a scale (or min) of column c of a record's 64, as f32
  __device__ static float scale_at(const unsigned char* p, int c) {
    using S = typename R::Scale;
    return s_to_f32(reinterpret_cast<const S*>(p)[c]);
  }

  // two int8 values (a 16-bit word) times s, each rounded to bf16: one
  // bf16x2 register of an A fragment
  __device__ static unsigned deq2(unsigned u, float s) {
    float lo, hi;
    R::i8x2((unsigned short)u, lo, hi);
    const __nv_bfloat162 h =
        __floats2bfloat162_rn(__fmul_rn(lo, s), __fmul_rn(hi, s));
    return *reinterpret_cast<const unsigned*>(&h);
  }

  // bf16 packed: records of 32 rows, each lane's 16 values of an m16 tile
  // in the fragments' order (two 16-row steps); warp (mt, kg) takes
  // records kg, kg + 4; the min term of each record per lane
  __device__ void mma_packed(const unsigned char* slot, int r0, int rows,
                             float (&acc)[4][4]) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int mt = warp & 3, kg = warp >> 2, g = lane >> 2, t = lane & 3;
    const bf16* xin = reinterpret_cast<const bf16*>(vin);
    for (int r = kg; r < rows / QB; r += 4) {
      const unsigned char* rec = slot + (size_t)r * R::REC;
      const uint4 q =
          *reinterpret_cast<const uint4*>(rec + (mt * 32 + lane) * 16);
      const unsigned char* sp = rec + QB * TILE;
      const float s_lo = scale_at(sp, 16 * mt + g);
      const float s_hi = scale_at(sp, 16 * mt + g + 8);
      const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const unsigned av[4] = {deq2(words[2 * ks] & 0xffffu, s_lo),
                                deq2(words[2 * ks] >> 16, s_hi),
                                deq2(words[2 * ks + 1] & 0xffffu, s_lo),
                                deq2(words[2 * ks + 1] >> 16, s_hi)};
        const int kk = r0 + r * QB + ks * 16 + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < NT) {
            const bf16* row = xin + (8 * j + g) * VIN_BF + kk;
            mma_16816(acc[j], av, *reinterpret_cast<const unsigned*>(row),
                      *reinterpret_cast<const unsigned*>(row + 8));
          }
        }
      }
      if constexpr (R::MINS) {
        const unsigned char* mp =
            sp + TILE * sizeof(typename R::Scale);
        const float m_lo = scale_at(mp, 16 * mt + g);
        const float m_hi = scale_at(mp, 16 * mt + g + 8);
        const int blk = r0 / QB + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < NT) {
            const float b0 = bsum[(8 * j + 2 * t) * (LANE_ROWS / QB) + blk];
            const float b1 =
                bsum[(8 * j + 2 * t + 1) * (LANE_ROWS / QB) + blk];
            acc[j][0] = fmaf(b0, m_lo, acc[j][0]);
            acc[j][1] = fmaf(b1, m_lo, acc[j][1]);
            acc[j][2] = fmaf(b0, m_hi, acc[j][2]);
            acc[j][3] = fmaf(b1, m_hi, acc[j][3]);
          }
        }
      }
    }
  }

  // f32 (dense or packed): thread (column c, lane group lg) sums lanes lg,
  // lg + 8, lg + 16, lg + 24 over the chunk's rows in order, into
  // acc[i][0]; a packed weight is q * s in f32, and each record adds its
  // min term
  __device__ void fma_chunk(const unsigned char* slot, int r0, int rows,
                            float (&acc)[4][4]) const {
    const int c = threadIdx.x & (TILE - 1), lg = threadIdx.x / TILE;
    const float* xin = reinterpret_cast<const float*>(vin);
    if constexpr (!R::PACKED) {
      const float* w = reinterpret_cast<const float*>(slot);
      for (int r = 0; r < rows; ++r) {
        const float wv = w[r * TILE + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (lg + 8 * i < B)
            acc[i][0] = fmaf(xin[(lg + 8 * i) * VIN_F + r0 + r], wv,
                             acc[i][0]);
      }
    } else {
      for (int rr = 0; rr < rows / QB; ++rr) {
        const unsigned char* rec = slot + (size_t)rr * R::REC;
        const unsigned char* sp = rec + QB * TILE;
        const float s = scale_at(sp, c);
        const int k0 = r0 + rr * QB;
        for (int k = 0; k < QB; ++k) {
          const float wv = __fmul_rn(
              (float)reinterpret_cast<const signed char*>(rec)[k * TILE + c],
              s);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (lg + 8 * i < B)
              acc[i][0] = fmaf(xin[(lg + 8 * i) * VIN_F + k0 + k], wv,
                               acc[i][0]);
        }
        if constexpr (R::MINS) {
          const float m = scale_at(sp + TILE * sizeof(typename R::Scale), c);
          const int blk = k0 / QB;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (lg + 8 * i < B)
              acc[i][0] = fmaf(bsum[(lg + 8 * i) * (LANE_ROWS / QB) + blk], m,
                               acc[i][0]);
        }
      }
    }
  }

  // item i's partial, lane-major rows of 64 columns (i * B + lane): the
  // tensor-core path's 4 k-groups' sums go to shared memory and every
  // thread adds them in order for 4 columns of a lane (16-byte loads and
  // stores); the f32 path writes each thread's own sums
  __device__ void put_partial(int i, float (&acc)[4][4]) {
    if constexpr (MMA) {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const int mt = warp & 3, kg = warp >> 2, g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < NT) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int nn = 8 * j + 2 * t + (e & 1);
            const int m = 16 * mt + g + 8 * (e >> 1);
            red[(kg * MAX_LANES + nn) * RED_LD + m] = acc[j][e];
          }
        }
      }
      __syncthreads();
      const int nn = threadIdx.x / (TILE / 4), m = 4 * (threadIdx.x % 16);
      if (nn < B) {
        float4 s = *reinterpret_cast<const float4*>(red + nn * RED_LD + m);
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          const float4 r = *reinterpret_cast<const float4*>(
              red + (k * MAX_LANES + nn) * RED_LD + m);
          s.x += r.x;
          s.y += r.y;
          s.z += r.z;
          s.w += r.w;
        }
        __stcg(reinterpret_cast<float4*>(partial +
                                         ((size_t)i * B + nn) * TILE + m),
               s);
      }
    } else {
      const int c = threadIdx.x & (TILE - 1), lg = threadIdx.x / TILE;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (lg + 8 * k < B)
          __stcg(partial + ((size_t)i * B + lg + 8 * k) * TILE + c,
                 acc[k][0]);
    }
  }

  // ---------------------------------------------- folds and epilogues

  // What the epilogue of lane bb's columns col, col + 1 (the warp's of
  // tile `tile`) of phase p of layer l reads besides the sums, loaded
  // ahead of them: the bias pair and, for a residual, x's pair.
  struct EpiIn {
    float b0, b1, x0, x1;
  };
  __device__ EpiIn epi_in(int p, int l, int tile, int bb) const {
    const int col = tile * TILE + 2 * (threadIdx.x & 31);
    EpiIn e{0.0f, 0.0f, 0.0f, 0.0f};
    if (p == LLM) return e;
    const T* bias = p == LQ     ? (const T*)a.w.qkv_b + (size_t)l * 3 * D
                    : p == LFC  ? (const T*)a.w.fc_b + (size_t)l * 4 * D
                    : p == LPROJ ? (const T*)a.w.proj_b + (size_t)l * D
                                 : (const T*)a.w.out_b + (size_t)l * D;
    load2(bias + col, e.b0, e.b1);
    if (p == LPROJ || p == LOUT) {
      const float2 xo = __ldcg(
          reinterpret_cast<const float2*>(x + (size_t)bb * D + col));
      e.x0 = xo.x;
      e.x1 = xo.y;
    }
    return e;
  }

  // lane bb's columns col, col + 1 of phase p from their folded sums s0,
  // s1 and the epilogue's inputs
  __device__ void epilogue(int p, int tile, int bb, float s0, float s1,
                           const EpiIn& in) const {
    const int lane = threadIdx.x & 31;
    const int col = tile * TILE + 2 * lane;
    if (p == LLM) {
      const int lo = pl(LP_LO), hi = pl(LP_HI);
      float* o = a.logits + (size_t)bb * V;
      if (col >= lo && col < hi) o[col] = s0;
      if (col + 1 >= lo && col + 1 < hi) o[col + 1] = s1;
      return;
    }
    float v0 = round_t<T>(round_t<T>(s0) + in.b0);
    float v1 = round_t<T>(round_t<T>(s1) + in.b1);
    if (p == LQ) {
      __stcg(reinterpret_cast<float2*>(qkv + (size_t)bb * 3 * D + col),
             make_float2(v0, v1));
      if (tile >= D / TILE) {  // a K or V tile: its amax, for int8 scales
        const float m = warp_max(fmaxf(fabsf(v0), fabsf(v1)));
        if (lane == 0)
          __stcg(amax + (size_t)(tile - D / TILE) * B + bb, m);
      }
    } else if (p == LFC) {
      v0 = round_t<T>(gelu_tanh(v0));
      v1 = round_t<T>(gelu_tanh(v1));
      __stcg(reinterpret_cast<float2*>(hb + (size_t)bb * 4 * D + col),
             make_float2(v0, v1));
    } else {  // proj, out: the residual
      v0 = round_t<T>(in.x0 + v0);
      v1 = round_t<T>(in.x1 + v1);
      __stcg(reinterpret_cast<float2*>(x + (size_t)bb * D + col),
             make_float2(v0, v1));
      tile_stats(tile, bb, v0, v1);
    }
  }

  // After an item of tile `tile` wrote its partial: the tile's last block
  // in (its ticket) folds the tile's partials in the plan's order for
  // every lane and writes the epilogue's rows. Its threads copy the
  // partials into shared memory by 16-byte cp.async, as many items at a
  // time as the products' region holds (all of a tile's at B <= 16 on
  // bark-small), then warp w adds lanes w and w + 16, a thread two
  // columns. Every block loads the epilogue's inputs before taking its
  // ticket, so the last one waits only on the partials. The ticket is
  // thread 0's acquire-release add after the block's barrier, as a grid
  // barrier's arrival (hopper.cuh grid_arrive): no fence a thread.
  __device__ void ticket(int p, int l, int tile) {
    const int lt = tile - pl(LP_TILE0 + p);
    const int fo = pl(LP_FOLD_OFF + p);
    const int j0 = pl(fo + lt), j1 = pl(fo + lt + 1);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int* list = plan + pl(LP_FOLD + p);
    const int nb = warp >= B ? 0 : warp + PS_WARPS < B ? 2 : 1;
    EpiIn in[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (k < nb) in[k] = epi_in(p, l, tile, warp + PS_WARPS * k);
    __syncthreads();  // every partial of the block written
    if (threadIdx.x == 0)  // release them, acquire the other blocks'
      ints[0] = ticket_add(tickets + lt) == (unsigned)(j1 - j0 - 1);
    __syncthreads();
    if (!ints[0]) return;
    float* fb = reinterpret_cast<float*>(vin);  // free after the products
    const int per = B * TILE, quads = per / 4;  // an item's partial
    const int round = min(j1 - j0, FOLD_FLOATS / per);
    float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    for (int j = j0; j < j1; j += round) {
      const int m = min(round, j1 - j);
      for (int c = threadIdx.x; c < m * quads; c += PS_THREADS) {
        const int u = c / quads, o = 4 * (c - u * quads);
        cp_async16(fb + u * per + o,
                   partial + (size_t)__ldg(list + j + u) * per + o);
      }
      cp_async_commit();
      cp_async_wait(0);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k < nb) {
          const float* f = fb + (warp + PS_WARPS * k) * TILE + 2 * lane;
          for (int u = 0; u < m; ++u) {
            const float2 v = *reinterpret_cast<const float2*>(f + u * per);
            s[k][0] += v.x;
            s[k][1] += v.y;
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (k < nb)
        epilogue(p, tile, warp + PS_WARPS * k, s[k][0], s[k][1], in[k]);
    if (threadIdx.x == 0) tickets[lt] = 0u;
  }

  // item i of phase p: its inputs, its chunks' products, its partial, and
  // the fold when it is its tile's last
  __device__ void gemv_item(int p, int l, int j) {
    const int* o = own + (p * MAX_OWN + j) * 4;
    const int i = o[0], tile = o[1], k0 = o[2], k1 = o[3];
    build_vin(p, l, k0, k1, j == 0 && (p == LQ || p == LFC || p == LLM));
    float acc[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
    for (int r = k0; r < k1; r += R::CH) {
      const unsigned char* slot = take();
      const int rows = min(R::CH, k1 - r);
      if constexpr (!MMA)
        fma_chunk(slot, r - k0, rows, acc);
      else if constexpr (R::PACKED)
        mma_packed(slot, r - k0, rows, acc);
      else
        mma_dense(slot, r - k0, rows, acc);
    }
    put_partial(i, acc);
    ticket(p, l, tile);
  }

  __device__ void gemv_phase(int p, int l) {
    for (int j = 0; j < own_n[p]; ++j) gemv_item(p, l, j);
  }

  // ---------------------------------------------- attention

  // Unit (h, bb) of layer l, on one group of N threads (its own shared
  // memory `mem`): the head's q, k, v of the lane from qkv, its K/V cache
  // row at n_past[bb] (int8 with the row scales from the K and V tiles'
  // amax; the head-0 unit writes the scales), the attention, and the
  // head's context into ctx (NaN for a slot outside the cache, and no
  // cache row).
  template <int N>
  __device__ void attend(int l, int h, int bb, float* mem) {
    using G = ThreadGroup<N>;
    constexpr int ATT_T = N, ATT_KG = N / (HD / 8);
    const int t = G::tid(), np = a.n_past[bb], off = h * HD;
    float* co = ctx + (size_t)bb * D + off;
    if (np < 0 || np >= S) {
      if (t < HD) __stcg(co + t, NAN);
      return;
    }
    float* sc = mem;
    float(*part)[HD + 1] =
        reinterpret_cast<float(*)[HD + 1]>(sc + (S + 3) / 4 * 4);
    float* qs = reinterpret_cast<float*>(part + ATT_KG);
    float *kn = qs + HD, *vn = kn + HD, *red = vn + HD;
    int* qw = reinterpret_cast<int*>(red + 32);
    int *kq = qw + HD / 4, *vq = kq + HD / 4;
    const size_t slab = ((size_t)l * B + bb) * S;  // the lane's rows
    const float* qr = qkv + (size_t)bb * 3 * D;
    float o;
    if (a.kv.ks == nullptr) {
      for (int c = t; c < 3 * HD; c += ATT_T) {
        const int which = c / HD, d = c - which * HD;
        const float v = __ldcg(qr + which * D + off + d);
        (which == 0 ? qs : which == 1 ? kn : vn)[d] = v;
        if (which > 0) {
          T* cache = (T*)(which == 1 ? a.kv.k : a.kv.v);
          cache[(slab + np) * D + off + d] = from_f32<T>(v);
        }
      }
      G::sync();
      o = attend_dense<T, ATT_KG, G>(qs, kn, vn,
                                     (const T*)a.kv.k + slab * D + off,
                                     (const T*)a.kv.v + slab * D + off, np, D,
                                     ATT_SCALE, sc, red, part);
    } else {
      const int nt = D / TILE;
      float ka = 0.0f, va = 0.0f;
      if (t < nt)
        ka = __ldcg(amax + (size_t)t * B + bb);
      else if (t < 2 * nt)
        va = __ldcg(amax + (size_t)t * B + bb);
      const float sk = i8_scale(grp_max<G>(ka, red));
      const float sv = i8_scale(grp_max<G>(va, red));
      signed char* kc = (signed char*)a.kv.k + slab * D + off;
      signed char* vc = (signed char*)a.kv.v + slab * D + off;
      if (t < HD) {
        const signed char k8 = quant_i8(__ldcg(qr + D + off + t), i8_inv(sk));
        const signed char v8 =
            quant_i8(__ldcg(qr + 2 * D + off + t), i8_inv(sv));
        reinterpret_cast<signed char*>(kq)[t] = k8;
        reinterpret_cast<signed char*>(vq)[t] = v8;
        kc[(size_t)np * D + t] = k8;
        vc[(size_t)np * D + t] = v8;
      }
      if (h == 0 && t == 0) {
        a.kv.ks[slab + np] = sk;
        a.kv.vs[slab + np] = sv;
      }
      const float qv = t < HD ? __ldcg(qr + off + t) * ATT_SCALE : 0.0f;
      const float sq = quant_query<G>(qv, qw, red);
      o = attend_int8<T, ATT_KG, G>(qw, sq, kq, vq, sk, sv, kc, vc,
                                    a.kv.ks + slab, a.kv.vs + slab, np, D, sc,
                                    red, part);
    }
    if (t < HD) __stcg(co + t, round_t<T>(o));
    G::sync();
  }

  // the block's units on groups of N threads: group g takes units p0 + g,
  // p0 + g + 512 / N, ...
  template <int N>
  __device__ void attend_units(int l) {
    const int pairs = pl(LP_PAIRS), g = threadIdx.x / N;
    for (int u = p0 + g; u < p1; u += PS_THREADS / N)
      attend<N>(l, pl(pairs + 2 * u), pl(pairs + 2 * u + 1),
                att + (size_t)g * att_floats(S, N / (HD / 8)));
  }

  // as many units at once as the block has, up to ATT_GROUPS: one unit on
  // all 512 threads, two on 256 each, more on 128 each
  __device__ void attention(int l) {
    if (p1 - p0 <= 1)
      attend_units<PS_THREADS>(l);
    else if (p1 - p0 == 2)
      attend_units<PS_THREADS / 2>(l);
    else
      attend_units<PS_THREADS / ATT_GROUPS>(l);
  }

  // In the wait of the barrier before layer l: the TMA engine brings the
  // cache rows [0, n_past) of every lane whose head-0 unit this block
  // attends into the L2, the lane's K and V slabs (and int8 scales)
  // as contiguous runs of all its heads, which the blocks of its other
  // units read too; thread 0 issues them, nothing waits on them.
  __device__ void prefetch_lanes(int l) const {
    if (threadIdx.x != 0) return;
    const bool q8 = a.kv.ks != nullptr;
    const size_t re = q8 ? 1 : sizeof(T);
    const int pairs = pl(LP_PAIRS);
    for (int u = p0; u < p1; ++u) {
      if (pl(pairs + 2 * u) != 0) continue;
      const int bb = pl(pairs + 2 * u + 1);
      const int np = min(max(a.n_past[bb], 0), S);
      if (np == 0) continue;
      const size_t slab = ((size_t)l * B + bb) * S;
      const unsigned bytes = (unsigned)((size_t)np * D * re);
      bulk_prefetch_l2((const char*)a.kv.k + slab * D * re, bytes);
      bulk_prefetch_l2((const char*)a.kv.v + slab * D * re, bytes);
      if (q8) {
        const unsigned sb = (unsigned)(np * sizeof(float) + 15) / 16 * 16;
        bulk_prefetch_l2(a.kv.ks + slab, sb);
        bulk_prefetch_l2(a.kv.vs + slab, sb);
      }
    }
  }

  // ---------------------------------------------- barriers and stamps

  __device__ void stamp(int k) const {
    if (a.stamps != nullptr) {
      __syncthreads();
      if (threadIdx.x == 0)
        a.stamps[(size_t)b * (2 * LAYER_BARRIERS * L + 3) + k] = global_ns();
    }
  }

  // The k-th barrier of the step (from 1; the embed's is the first),
  // stamped as layer barrier k - 1 (none for the embed's): between its
  // arrival and its wait the block refills its ring, before a layer asks
  // for its lanes' cache rows (`prefetch_lanes`), and before an LN product
  // loads the LN's affine into lnp.
  __device__ void barrier(int k) {
    if (k > 1) stamp(2 * (k - 1));
    grid_arrive(count);
    release();
    const int l = (k - 1) / LAYER_BARRIERS, next = (k - 1) % LAYER_BARRIERS;
    if (next == 0 && l < L) prefetch_lanes(l);  // the next layer's rows
    if (next == 0 || next == 3) {  // before QKV, FC, the LM head: their LN
      const T *g, *bb;
      if (l == L) {
        g = (const T*)a.w.ln_f_g;
        bb = (const T*)a.w.ln_f_b;
      } else if (next == 0) {
        g = (const T*)a.w.ln1_g + (size_t)l * D;
        bb = (const T*)a.w.ln1_b + (size_t)l * D;
      } else {
        g = (const T*)a.w.ln2_g + (size_t)l * D;
        bb = (const T*)a.w.ln2_b + (size_t)l * D;
      }
      for (int i = threadIdx.x; i < D; i += PS_THREADS) {
        lnp[i] = to_f32(g[i]);
        lnp[D + i] = to_f32(bb[i]);
      }
    }
    grid_wait(count, (unsigned)k * G);
    if (k > 1) stamp(2 * (k - 1) + 1);
  }

  // every block arrives once more; the last resets the count to 0
  __device__ void leave(int n_barriers) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(count, 1u) == (unsigned)(n_barriers + 1) * G - 1)
        atomicExch(count, 0u);
    }
  }
};

template <typename R>
__global__ void __launch_bounds__(PS_THREADS, 1)
    lane_step_kernel(const __grid_constant__ LaneArgs<typename R::Weights> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  LaneStep<R> s(a, smem);
  s.stamp(0);
  const int L = s.L, n_barriers = LAYER_BARRIERS * L + 1;
  if (s.pl(LP_BLOCKS) != (int)gridDim.x || s.pl(LP_BARRIERS) != n_barriers ||
      s.pl(LP_LAYERS) != L || s.pl(LP_LANES) != a.B ||
      s.pl(LP_PACKED) != (int)R::PACKED)
    __trap();  // a plan for another grid, stage, batch or read
  s.setup();
  s.top_up();
  s.assign_units();
  s.zero_window();
  s.embed();
  int k = 0;
  s.barrier(++k);
  s.stamp(1);
  for (int l = 0; l < L; ++l) {
    s.gemv_phase(LQ, l);
    s.barrier(++k);
    s.attention(l);
    s.barrier(++k);
    s.gemv_phase(LPROJ, l);
    s.barrier(++k);
    s.gemv_phase(LFC, l);
    s.barrier(++k);
    s.gemv_phase(LOUT, l);
    s.barrier(++k);
  }
  s.gemv_phase(LLM, L);
  s.stamp(2 * LAYER_BARRIERS * L + 2);
  s.leave(n_barriers);
}

template <typename R>
int lane_blocks_t(int D, int S) {
  const size_t smem = lane_smem(S, sizeof(typename R::T) == 2);
  if (smem > MAX_SMEM || D % TILE || D > 1024 || S > 1024) return -1;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaFuncSetAttribute(
        lane_step_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lane_step_kernel<R>, PS_THREADS, smem);
  if (err) return -err;
  return coop ? per_sm * sms : -1;
}

template <typename R>
int lane_step_t(const LaneArgs<typename R::Weights>& a, int blocks,
                cudaStream_t st) {
  const size_t smem = lane_smem(a.w.block_size, sizeof(typename R::T) == 2);
  void* args[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel((const void*)lane_step_kernel<R>,
                                          dim3(blocks), dim3(PS_THREADS),
                                          args, smem, st);
}

// the step's arguments, or false for arguments it does not take
template <typename Weights>
bool lane_args(const Weights* w, const void* const* tiles, const int* plan,
               int blocks, int B, const int* tok, const int* n_past,
               void* k_cache, void* v_cache, float* k_scale, float* v_scale,
               float* work, long long work_floats, int cap, unsigned* sync,
               unsigned long long* stamps, float* logits,
               LaneArgs<Weights>& a) {
  const int D = w->n_embd;
  if (D / w->n_head != HD || D % TILE || D > 1024 || w->block_size > 1024 ||
      blocks < 1 || B < 1 || B > MAX_LANES || w->n_head * B > PS_THREADS ||
      cap < 0 || work_floats < (long long)(lane_rows_floats(B, D) + cap) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return false;
  a = LaneArgs<Weights>{*w, {}, plan, tok, n_past,
                        BarkKV{k_cache, v_cache, k_scale, v_scale},
                        work, sync, stamps, logits, B};
  for (int i = 0; i < LPH; ++i) a.tiles[i] = tiles[i];
  return true;
}

// ------------------------------------------------------------ K8's LM head

constexpr int LM_WARPS = 8;
constexpr int LM_ROWS = 4;   // vocab rows per warp
constexpr int LM_LANES = 8;  // lanes LayerNormed per pass

// K8's LM head (bark_launch_lm_head_batched): logits[b, v] = dot(LN_f(x[row
// b]), head[v, :]) for v in [lo, hi). Each warp owns LM_ROWS vocab rows;
// per pass, warp j LayerNorms lane b0 + j into shared memory and every
// warp dots its rows with the pass's nb lanes (the head rows come back
// from L2 on later passes). Only the nb rows of hs a pass wrote are read:
// a pass of one lane does one lane's FMAs.
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


}  // namespace


// The grid of bark_decode_lanes (scale_dtype < 0) or
// bark_decode_lanes_packed (a qpack's scale dtype and has_min) for a stage
// of params dtype `dtype`, width D and S cache slots: the blocks of its
// kernel the card holds at once (sets the kernel's shared-memory limit).
// Negative: a cudaError negated, or -1 for a shape or format it does not
// take or a card without cooperative launches.
extern "C" int bark_decode_lanes_blocks(int dtype, int scale_dtype,
                                        int has_min, int D, int S) {
  auto blocks = [&](auto r) { return lane_blocks_t<decltype(r)>(D, S); };
  if (dtype == BARK_BF16)
    return scale_dtype < 0
               ? blocks(DenseRead<bf16>{})
               : with_packed_read<bf16>(scale_dtype, has_min, blocks);
  return scale_dtype < 0
             ? blocks(DenseRead<float>{})
             : with_packed_read<float>(scale_dtype, has_min, blocks);
}

// K7: one decode step of B (1..32) lanes as one cooperative launch of
// `blocks` blocks (bark_decode_lanes_blocks' grid, for which `plan`, the
// lane_plan table of B lanes, was made). tiles: the stage's qkv, proj,
// fc and out weights and its LM head's transpose, tile-major (L, N/64, K,
// 64) and (v_pad/64, D, 64), each 16-row group of a bf16 tile in the mma
// fragments' order (kernels/decode.py `lane_tiles`), 16-byte aligned. tok
// and n_past are B ints in device memory; k_cache and v_cache the stage's
// (L, B, S, D) caches, in the params dtype when k_scale and v_scale are
// null, else int8 with those (L, B, S) f32 row scales (K6a); row n_past[b]
// of lane b of every layer is written in place. work: work_floats >=
// B (9 D + 3 D / 64) + cap f32 of scratch (cap >= 64 B x the plan's most
// items in a phase); sync: 1 + the plan's most tiles in a phase uint32,
// zeroed (left zeroed); stamps null or blocks x (2 x 5 L + 3) uint64;
// logits (B, n_out_vocab) f32, zero outside the plan's [lo, hi). Returns
// the launch's cudaError (0 on success), -1 for arguments it does not
// take; nothing falls back.
extern "C" int bark_decode_lanes(const BarkGPTWeights* w,
                                 const void* const* tiles, const int* plan,
                                 int blocks, int B, const int* tok,
                                 const int* n_past, void* k_cache,
                                 void* v_cache, float* k_scale,
                                 float* v_scale, float* work,
                                 long long work_floats, int cap,
                                 unsigned* sync, unsigned long long* stamps,
                                 float* logits, cudaStream_t stream) {
  LaneArgs<BarkGPTWeights> a;
  if (!lane_args(w, tiles, plan, blocks, B, tok, n_past, k_cache, v_cache,
                 k_scale, v_scale, work, work_floats, cap, sync, stamps,
                 logits, a))
    return -1;
  if (w->dtype == BARK_BF16)
    return lane_step_t<DenseRead<bf16>>(a, blocks, stream);
  return lane_step_t<DenseRead<float>>(a, blocks, stream);
}

// K5-batched: bark_decode_lanes on a qpack's weights, its plan made for
// packed reads. tiles: the qpack's four projection weights and its LM head
// as quant-block records, (L, N/64, K/32, rec) and (v_pad/64, D/32, rec)
// bytes (kernels/decode.py `lane_tiles`: a bf16 stage's records hold each
// lane's 16 values of an m16 tile in the mma fragments' order, an f32
// stage's are K5's `step_qtiles`). The rest as bark_decode_lanes'; -1 also
// for a scale dtype other than f16 or f32.
extern "C" int bark_decode_lanes_packed(
    const BarkGPTQWeights* w, const void* const* tiles, const int* plan,
    int blocks, int B, const int* tok, const int* n_past, void* k_cache,
    void* v_cache, float* k_scale, float* v_scale, float* work,
    long long work_floats, int cap, unsigned* sync,
    unsigned long long* stamps, float* logits, cudaStream_t stream) {
  LaneArgs<BarkGPTQWeights> a;
  if (w->v_pad % TILE ||
      !lane_args(w, tiles, plan, blocks, B, tok, n_past, k_cache, v_cache,
                 k_scale, v_scale, work, work_floats, cap, sync, stamps,
                 logits, a))
    return -1;
  auto launch = [&](auto r) {
    return lane_step_t<decltype(r)>(a, blocks, stream);
  };
  if (w->dtype == BARK_BF16)
    return with_packed_read<bf16>(w->scale_dtype, w->has_min, launch);
  return with_packed_read<float>(w->scale_dtype, w->has_min, launch);
}

extern "C" int bark_launch_lm_head_batched(const BarkGPTWeights* w,
                                           const void* x, const int* rows,
                                           int B, float* logits, int lo,
                                           int hi, cudaStream_t stream) {
  if (w->dtype == BARK_BF16)
    return blm_head_t<bf16>(w, x, rows, B, logits, lo, hi, stream);
  return blm_head_t<float>(w, x, rows, B, logits, lo, hi, stream);
}
