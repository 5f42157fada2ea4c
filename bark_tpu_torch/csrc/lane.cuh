// The batched decode step's device code, shared by its two kernels: K7 /
// K5-batched's single step (bdecode.cu `lane_step_kernel`) and K9 / K10's
// step loop (bloop.cuh `lane_steps_kernel`, the step in a loop with the
// sampler inside): the launch's arguments, the shared-memory layout, one
// block's view of the step (`LaneStep`, its design at the head of
// bdecode.cu) and the loop's sampler (`LaneSampler`). Three sources
// (bdecode.cu, and the loop's bloop.cu and bloop_f32.cu), so that nvcc
// builds the two kernels' 20 instances in three processes at once.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "step.cuh"

// The batched step loop's arguments (kernels/_build.py `LaneLoop` mirrors
// it): n_steps steps of B lanes, step j's slots row j of the (n_steps, B)
// table `slots`; temp (0: argmax of the logits) and the noise (null at
// temp 0): lane b's row of step j at noise + b * noise_lane_ld +
// min(noise_row0 + j, noise_rows - 1) * noise_step_ld, each over the
// window's width; codebook 0: the window [0, n_out_vocab) with the stop
// flag (tok == stop_token or eos_p >= min_eos_p), 1: [svs + (cbs when
// step_idx0 + j is odd), + cbs), no flag; tok_out and flag_out (n_steps,
// B) int32 (flag_out null when codebook); part, 4 f32 a (LM tile, lane);
// stamps, blocks x (2 + 3 n_steps) uint64, or null.
struct BarkLaneLoop {
  int n_steps;
  const int* slots;
  float temp;
  const float* noise;
  long long noise_lane_ld, noise_step_ld;
  int noise_row0, noise_rows;
  int codebook, svs, cbs, step_idx0, stop_token;
  float min_eos_p;
  int* tok_out;
  int* flag_out;
  float* part;
  unsigned long long* stamps;
};

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
// The step loop's state, in shared memory at a fixed offset (so that no
// register holds it, or its address, from one step to the next): the
// step, the chunks of a block's sequence a step, the ring's producer
// (chunks issued and freed, the cursor: thread 0 alone walks it), the
// mask of the lanes whose token the block embeds, the chunks taken, then
// each lane's token.
enum {
  LW_STEP = 0, LW_CHUNKS = 1, LW_ISSUED = 2, LW_FREED = 3, LW_CURSOR = 4,
  LW_LANES = 8, LW_TAKEN = 9, LW_TOK = 32, LOOP_WORDS = LW_TOK + MAX_LANES
};

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
  BarkLaneLoop lp;    // the step loop's (zero in K7's single step)
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
// statistics, a few ints and the block's items, the next LN's affine, the
// step loop's state (LOOP_OFF), then one region that the products
// (inputs, block sums, k-group sums, staged tile statistics), a fold
// (staged partials) and the attention (each group's scores, key groups'
// sums, rows) take in turn: ~226 KB.
constexpr int LOOP_OFF = RING_BYTES + 8 * MAX_SLOTS +
                         4 * (2 * MAX_LANES + INTS + 2 * MAX_TILES * TILE);
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
  return LOOP_OFF + 4 * LOOP_WORDS + lane_work_bytes(S, mma);
}

// ------------------------------------------------ the step loop's sampler
//
// Step j of the loop (K9, K10) samples every lane's token from the logits
// before it, then decodes the tokens. The sample's partials are keyed by
// LM tile: the block that folds a tile of the LM head (its ticket's last,
// which changes from run to run) reduces each lane's 64 columns of it
// within the next step's window to a partial, in the fold's warps; after
// one grid barrier each block folds, in tile order, the partials of the
// lanes whose token it embeds. So a token depends on the logits alone,
// never on which block folded a tile. The opening sample, the fold and the
// noise prefetch run out of line (__noinline__, from the launch's
// arguments and the loop's state), so that their registers are their own;
// the partial runs inline in the LM head's fold, where a call was slower.

template <typename Weights>
struct LaneSampler {
  const LaneArgs<Weights>& a;
  int B, V, G, b, D;

  __device__ explicit LaneSampler(const LaneArgs<Weights>& args)
      : a(args), B(args.B), V(args.w.n_out_vocab), G(gridDim.x),
        b(blockIdx.x), D(args.w.n_embd) {}

  // step j's sample window [base, base + n)
  __device__ void window(int j, int& base, int& n) const {
    if (a.lp.codebook) {
      n = a.lp.cbs;
      base = a.lp.svs + (((a.lp.step_idx0 + j) & 1) ? a.lp.cbs : 0);
    } else {
      base = 0;
      n = V;
    }
  }

  // lane bb's noise row of step j (element u: window slot base + u)
  __device__ const float* noise_row(int j, int bb) const {
    return a.lp.noise + bb * a.lp.noise_lane_ld +
           min(a.lp.noise_row0 + j, a.lp.noise_rows - 1) *
               a.lp.noise_step_ld;
  }

  // the block that writes lane bb's token and flag: the one that embeds
  // the lane's first tile (LaneStep::embed's split)
  __device__ int writer(int bb) const {
    return (bb * (D / TILE) / PS_WARPS) % G;
  }

  // the LM head's first tile (its partials' slot 0)
  __device__ int tile0() const { return __ldg(a.plan + LP_TILE0 + LLM); }

  // Lane bb's partial of step j's sample over the warp's columns col, col
  // + 1 of LM tile `tile` (logits l0, l1): those in the window, merged over
  // the warp in a fixed order, written by lane 0 to slot (tile - tile0, bb)
  // of the loop's scratch. A tile with no slot of the window writes nothing
  // (the fold reads only the window's tiles).
  __device__ void put(int j, int tile, int bb, float l0, float l1) const {
    int base, n;
    window(j, base, n);
    if (tile * TILE >= base + n || (tile + 1) * TILE <= base) return;
    const bool eos = !a.lp.codebook;
    const float temp = a.lp.temp;
    const float* z = temp != 0.0f ? noise_row(j, bb) - base : nullptr;
    const int col = tile * TILE + 2 * (threadIdx.x & 31);
    Part p{-INFINITY, -INFINITY, 0.0f, INT_MAX};
    if (col >= base && col < base + n) take_slot(p, col, l0, temp, z, eos);
    if (col + 1 >= base && col + 1 < base + n)
      take_slot(p, col + 1, l1, temp, z, eos);
    p = warp_merge(p, eos);
    if ((threadIdx.x & 31) == 0)
      __stcg(reinterpret_cast<float4*>(a.lp.part) +
                 (size_t)(tile - tile0()) * B + bb,
             make_float4(p.v, p.m, p.s, __int_as_float(p.i)));
  }

  // step 0's partials, from the input logits: a warp a (window tile, lane)
  // of the grid's
  __device__ void open() const {
    int base, n;
    window(0, base, n);
    const int ta = base / TILE, nw = (base + n - 1) / TILE - ta + 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int u = b * PS_WARPS + warp; u < nw * B; u += G * PS_WARPS) {
      const int bb = u / nw, tile = ta + u - bb * nw;
      const int col = tile * TILE + 2 * lane;
      const float* lg = a.logits + (size_t)bb * V;
      const float l0 = col < V ? __ldcg(lg + col) : 0.0f;
      const float l1 = col + 1 < V ? __ldcg(lg + col + 1) : 0.0f;
      put(0, tile, bb, l0, l1);
    }
  }

  // After the sample's barrier: step j's token of each lane this block
  // embeds (the state's mask), a warp a lane: the partials of the window's
  // tiles in tile order (lane t of the warp merges tiles t, t + 32, ... in
  // turn, then a butterfly), into the state. The lane's writer also writes
  // tok_out[j][bb] and, for the full window, flag_out[j][bb] = tok ==
  // stop_token or eos_p >= min_eos_p, eos_p = exp(e_last - M) / S at the
  // window's last slot. The token is the window's base if it held nothing.
  __device__ void fold(int* state, int j) const {
    int base, n;
    window(j, base, n);
    const int ta = base / TILE, tb = (base + n - 1) / TILE, t0 = tile0();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const bool eos = !a.lp.codebook;
    int k = 0;
    for (unsigned m = (unsigned)state[LW_LANES]; m != 0; m &= m - 1, ++k) {
      if (k % PS_WARPS != warp) continue;
      const int bb = __ffs(m) - 1;
      Part p{-INFINITY, -INFINITY, 0.0f, INT_MAX};
      for (int t = ta + lane; t <= tb; t += 32) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(a.lp.part) +
                                (size_t)(t - t0) * B + bb);
        merge(p, Part{q.x, q.y, q.z, __float_as_int(q.w)}, eos);
      }
      p = warp_merge(p, eos);
      const int tok = p.i == INT_MAX ? base : p.i;
      if (lane == 0) {
        state[LW_TOK + bb] = tok;
        if (writer(bb) == b) {
          a.lp.tok_out[j * B + bb] = tok;
          if (eos) {
            const float last =
                __ldcg(a.logits + (size_t)bb * V + base + n - 1);
            const float eos_p =
                expf(eos_scale(a.lp.temp, last) - p.m) / p.s;
            a.lp.flag_out[j * B + bb] =
                (int)(tok == a.lp.stop_token || eos_p >= a.lp.min_eos_p);
          }
        }
      }
    }
    __syncthreads();
  }

  // thread 0 asks the TMA engine to bring step j's noise rows of the lanes
  // this block writes into the L2, a step ahead of their first read
  __device__ void prefetch(int j) const {
    if (threadIdx.x != 0 || a.lp.temp == 0.0f || j >= a.lp.n_steps) return;
    int base, n;
    window(j, base, n);
    for (int bb = 0; bb < B; ++bb) {
      const float* z = noise_row(j, bb);
      if (writer(bb) == b && ((size_t)z | (size_t)n * 4) % 16 == 0)
        bulk_prefetch_l2(z, (unsigned)n * 4);
    }
  }
};

template <typename Weights>
__device__ __forceinline__ void sample_put(const LaneArgs<Weights>& a, int j,
                                        int tile, int bb, float l0,
                                        float l1) {
  LaneSampler<Weights>(a).put(j, tile, bb, l0, l1);
}
template <typename Weights>
__device__ __noinline__ void sample_open(const LaneArgs<Weights>& a) {
  LaneSampler<Weights>(a).open();
}
template <typename Weights>
__device__ __noinline__ void sample_fold(const LaneArgs<Weights>& a,
                                         int* state, int j) {
  LaneSampler<Weights>(a).fold(state, j);
}
template <typename Weights>
__device__ __noinline__ void sample_prefetch(const LaneArgs<Weights>& a,
                                             int j) {
  LaneSampler<Weights>(a).prefetch(j);
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
// all threads of the block alike. LOOP (the step loop, K9/K10): the slots
// are the current step's row of the loop's table, the tokens are in the
// loop's state, and the ring's producer lives there too, walked by thread
// 0 alone across the steps (as decode.cu's loop does, and for its reason:
// no register holds it across the layers).
//
// Why two forms when no request runs K7's single step (each K9 chunk and
// K10 window is one launch of the loop): the single step is the yardstick
// the loop is held to. probes/k9k10_profile.py reads the loop's cost a
// step as its time over K7's step alone, and chip_smoke.py `k7_chain` and
// the card tests check the loop's bits against K7 launched step by step,
// a kernel that carries nothing from one step to the next. Run as a
// one-step loop, K7 would take on the LOOP forms (the opaque index reads,
// the state and the ring's producer in shared memory), which made it
// slower when tried, and the yardstick would then measure the loop
// against itself: what those forms cost (the q4_0 loop's layers, PERF.md
// section 7) would no longer show.
template <typename R, bool LOOP = false>
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
  int* state;   // the step loop's state (LW_*), in shared memory
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
    state = reinterpret_cast<int*>(smem + LOOP_OFF);
    unsigned char* w = smem + LOOP_OFF + 4 * LOOP_WORDS;
    vin = reinterpret_cast<T*>(w);
    bsum = reinterpret_cast<float*>(
        w + (MMA ? MAX_LANES * VIN_BF * 2 : MAX_LANES * VIN_F * 4));
    red = bsum + MAX_LANES * (LANE_ROWS / QB);
    st = reinterpret_cast<float2*>(red + (MMA ? 4 * MAX_LANES * RED_LD : 0));
    att = reinterpret_cast<float*>(w);
  }

  // the thread's index: threadIdx.x, or in the loop its opaque read at each
  // use, so that nothing derived from it is hoisted out of the step loop
  // and held in a register across it (ThreadGroup<N, true> the same)
  __device__ __forceinline__ unsigned tid() const {
    if constexpr (LOOP)
      return opaque_tid();
    else
      return threadIdx.x;
  }

  // lane bb's slot this step, and its token: K7's arguments, or in the
  // loop the current step's row of the slot table and the loop's state
  __device__ __forceinline__ int n_past(int bb) const {
    if constexpr (LOOP)
      return a.n_past[state[LW_STEP] * B + bb];
    else
      return a.n_past[bb];
  }
  __device__ __forceinline__ int token(int bb) const {
    if constexpr (LOOP)
      return state[LW_TOK + bb];
    else
      return a.tok[bb];
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
    if (tid() == 0) {
      for (int i = 0; i < NS; ++i) mbar_init(&full[i], 1);
      mbar_fence_init();
    }
    if ((int)tid() < LPH) {
      const int p = tid(), i0 = start(p, b), n = start(p, b + 1) - i0;
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
  // the LM head's items), advancing it; false past the block's last (of
  // the loop's last step: in the loop the cursor wraps to the next step's
  // first chunk).
  __device__ bool next_chunk(const void*& src, unsigned& bytes) {
    while (true) {
      if (c_layer > L) {
        if (!LOOP || issued >= state[LW_CHUNKS] * a.lp.n_steps) return false;
        c_layer = c_phase = c_item = c_row = 0;
      }
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
  }

  // the chunks of this block's sequence a step, as next_chunk walks them
  __device__ int chunks_a_step() const {
    int n[2] = {0, 0};
    for (int p = 0; p < LPH; ++p)
      for (int j = 0; j < own_n[p]; ++j) {
        const int* o = own + (p * MAX_OWN + j) * 4;
        n[p == LLM] += (o[3] - o[2] + R::CH - 1) / R::CH;
      }
    return n[0] * L + n[1];
  }

  // the ring, as K1's (decode.cu Step::top_up, take, release); LOOP:
  // thread 0 alone walks the producer, loaded from and stored to the
  // loop's state
  __device__ void top_up() {
    if constexpr (LOOP) {
      if (tid() != 0) return;
      int* w = state;
      issued = w[LW_ISSUED];
      freed = w[LW_FREED];
      c_layer = w[LW_CURSOR];
      c_phase = w[LW_CURSOR + 1];
      c_item = w[LW_CURSOR + 2];
      c_row = w[LW_CURSOR + 3];
      fill();
      w[LW_ISSUED] = issued;
      w[LW_CURSOR] = c_layer;
      w[LW_CURSOR + 1] = c_phase;
      w[LW_CURSOR + 2] = c_item;
      w[LW_CURSOR + 3] = c_row;
    } else {
      fill();
    }
  }
  __device__ __forceinline__ void free_before(int i) {
    if constexpr (LOOP) {
      if (tid() == 0) state[LW_FREED] = i;
    } else {
      freed = i;
    }
  }
  __device__ void fill() {
    while (issued < freed + NS) {
      const void* src;
      unsigned bytes;
      if (!next_chunk(src, bytes)) return;
      if (tid() == 0) {
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
    free_before(i);
    top_up();
    return ring + (size_t)(i % NS) * SLOT;
  }
  __device__ void release() {
    free_before(taken);
    top_up();
  }

  // The block's (head, lane) units [p0, p1): the plan's pairs in order,
  // each costing its lane's live rows + 1 + ATT_COST, go to the block that
  // holds the midpoint of their cost (every block computes the same split;
  // kernels/decode.py `lane_units` is its mirror).
  __device__ void assign_units() {
    const int lane = tid() & 31, warp = tid() >> 5;
    const int n = pl(LP_NPAIRS);
    int c = 0;
    if ((int)tid() < n) {
      const int np = n_past(pl(pl(LP_PAIRS) + 2 * tid() + 1));
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
    const bool mine = (int)tid() < n;
    p0 = __syncthreads_count(mine && owner < b);
    p1 = __syncthreads_count(mine && owner <= b);
  }

  // this block's share of zeroing the logits outside [lo, hi)
  __device__ void zero_window() const {
    const int lo = pl(LP_LO), hi = pl(LP_HI);
    if (lo == 0 && hi == V) return;
    for (int i = b * PS_THREADS + tid(); i < B * V;
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
    if ((tid() & 31) == 0)
      __stcg(reinterpret_cast<float2*>(stats) + (size_t)tile * B + bb,
             make_float2(mean, m2));
  }

  // x = wte[tok] + wpe[n_past] for every lane, a warp a (lane, tile) of
  // the grid's, with the tile's statistics (NaN for a token or slot
  // outside its table)
  __device__ void embed() const {
    const int lane = tid() & 31, warp = tid() >> 5;
    const int nt = D / TILE;
    for (int u = b * PS_WARPS + warp; u < B * nt; u += G * PS_WARPS) {
      const int bb = u / nt, tile = u - bb * nt;
      const int t = token(bb), np = n_past(bb);
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
    if (with_stats && (int)tid() < B * nt)
      st[tid()] =
          __ldcg(reinterpret_cast<const float2*>(stats) + tid());
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
    load(tid());
    if (with_stats) {
      __syncthreads();
      {  // warp w: lanes w, w + 16; its thread t: tile t
        const int t = tid() & 31;
        for (int ln = tid() >> 5; ln < B; ln += PS_WARPS) {
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
    put(tid());
    for (int e0 = tid() + PS_THREADS * VIN_QUADS; e0 < B * q;
         e0 += PS_THREADS * VIN_QUADS) {
      load(e0);
      put(e0);
    }
    if constexpr (R::MINS) {
      __syncthreads();
      const int nb = 4 * q / QB;
      for (int e = tid(); e < B * nb; e += PS_THREADS) {
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
    const int lane = tid() & 31, warp = tid() >> 5;
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
    const int lane = tid() & 31, warp = tid() >> 5;
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
    const int c = tid() & (TILE - 1), lg = tid() / TILE;
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
      const int lane = tid() & 31, warp = tid() >> 5;
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
      const int nn = tid() / (TILE / 4), m = 4 * (tid() % 16);
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
      const int c = tid() & (TILE - 1), lg = tid() / TILE;
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
    const int col = tile * TILE + 2 * (tid() & 31);
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
  // s1 and the epilogue's inputs (SAMPLE: the loop's LM head, whose folds
  // also write the next step's sample partials)
  template <bool SAMPLE>
  __device__ void epilogue(int p, int tile, int bb, float s0, float s1,
                           const EpiIn& in) const {
    const int lane = tid() & 31;
    const int col = tile * TILE + 2 * lane;
    if (p == LLM) {
      const int lo = pl(LP_LO), hi = pl(LP_HI);
      float* o = a.logits + (size_t)bb * V;
      if (col >= lo && col < hi) o[col] = s0;
      if (col + 1 >= lo && col + 1 < hi) o[col + 1] = s1;
      if constexpr (SAMPLE) {  // the next step's sample, from these logits
        const int j = state[LW_STEP] + 1;
        if (j < a.lp.n_steps) sample_put(a, j, tile, bb, s0, s1);
      }
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
  template <bool SAMPLE>
  __device__ void ticket(int p, int l, int tile) {
    const int lt = tile - pl(LP_TILE0 + p);
    const int fo = pl(LP_FOLD_OFF + p);
    const int j0 = pl(fo + lt), j1 = pl(fo + lt + 1);
    const int lane = tid() & 31, warp = tid() >> 5;
    const int* list = plan + pl(LP_FOLD + p);
    const int nb = warp >= B ? 0 : warp + PS_WARPS < B ? 2 : 1;
    EpiIn in[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (k < nb) in[k] = epi_in(p, l, tile, warp + PS_WARPS * k);
    __syncthreads();  // every partial of the block written
    if (tid() == 0)  // release them, acquire the other blocks'
      ints[0] = ticket_add(tickets + lt) == (unsigned)(j1 - j0 - 1);
    __syncthreads();
    if (!ints[0]) return;
    float* fb = reinterpret_cast<float*>(vin);  // free after the products
    const int per = B * TILE, quads = per / 4;  // an item's partial
    const int round = min(j1 - j0, FOLD_FLOATS / per);
    float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    for (int j = j0; j < j1; j += round) {
      const int m = min(round, j1 - j);
      for (int c = tid(); c < m * quads; c += PS_THREADS) {
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
        epilogue<SAMPLE>(p, tile, warp + PS_WARPS * k, s[k][0], s[k][1],
                         in[k]);
    if (tid() == 0) tickets[lt] = 0u;
  }

  // item i of phase p: its inputs, its chunks' products, its partial, and
  // the fold when it is its tile's last
  template <bool SAMPLE>
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
    ticket<SAMPLE>(p, l, tile);
  }

  template <bool SAMPLE = false>
  __device__ void gemv_phase(int p, int l) {
    for (int j = 0; j < own_n[p]; ++j) gemv_item<SAMPLE>(p, l, j);
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
    using G = ThreadGroup<N, LOOP>;
    constexpr int ATT_T = N, ATT_KG = N / (HD / 8);
    const int t = G::tid(), np = n_past(bb), off = h * HD;
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
    const int pairs = pl(LP_PAIRS), g = tid() / N;
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
    if (tid() != 0) return;
    const bool q8 = a.kv.ks != nullptr;
    const size_t re = q8 ? 1 : sizeof(T);
    const int pairs = pl(LP_PAIRS);
    for (int u = p0; u < p1; ++u) {
      if (pl(pairs + 2 * u) != 0) continue;
      const int bb = pl(pairs + 2 * u + 1);
      const int np = min(max(n_past(bb), 0), S);
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
      if (tid() == 0)
        a.stamps[(size_t)b * (2 * LAYER_BARRIERS * L + 3) + k] = global_ns();
    }
  }

  // The k-th barrier of the step (from 1; the embed's is the first),
  // stamped as layer barrier k - 1 (none for the embed's): between its
  // arrival and its wait the block refills its ring, before a layer asks
  // for its lanes' cache rows (`prefetch_lanes`), and before an LN product
  // loads the LN's affine into lnp. In the loop it is the launch's barrier
  // `loop_barrier(step, k)`.
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
      for (int i = tid(); i < D; i += PS_THREADS) {
        lnp[i] = to_f32(g[i]);
        lnp[D + i] = to_f32(bb[i]);
      }
    }
    const int n = LOOP ? loop_barrier(state[LW_STEP], k) : k;
    grid_wait(count, (unsigned)n * G);
    if (k > 1) stamp(2 * (k - 1) + 1);
  }

  // every block arrives once more; the last resets the count to 0
  __device__ void leave(int n_barriers) {
    __syncthreads();
    if (tid() == 0) {
      __threadfence();
      if (atomicAdd(count, 1u) == (unsigned)(n_barriers + 1) * G - 1)
        atomicExch(count, 0u);
    }
  }

  // ---------------------------------------------- the step loop (K9, K10)
  //
  // The launch's barriers: per step the sample's and the step's 5 L + 1;
  // the sampler is LaneSampler's (above).

  // the launch's index of the step's k-th barrier (k 0: the sample's)
  __device__ __forceinline__ int loop_barrier(int j, int k) const {
    return j * (LAYER_BARRIERS * L + 2) + 1 + k;
  }

  // the loop's state: the step, the chunks a step, the producer at its
  // start, and the lanes whose tokens this block embeds (`embed`'s split)
  __device__ void setup_loop() {
    if (tid() == 0) {
      for (int i = 0; i < LW_TOK; ++i) state[i] = 0;
      state[LW_CHUNKS] = chunks_a_step();
      const int nt = D / TILE;
      unsigned lanes = 0;
      for (int bb = 0; bb < B; ++bb)
        for (int u = bb * nt; u < (bb + 1) * nt; ++u)
          if ((u / PS_WARPS) % G == b) lanes |= 1u << bb;
      state[LW_LANES] = (int)lanes;
    }
    __syncthreads();
  }

  // the sampler's parts (LaneSampler, out of line)
  __device__ void open_partials() const { sample_open(a); }
  __device__ void fold(int j) { sample_fold(a, state, j); }
  __device__ void prefetch_noise(int j) const { sample_prefetch(a, j); }

  // the sample's barrier before step j: the block refills its ring while
  // it waits
  __device__ void sample_barrier(int j) {
    grid_arrive(count);
    release();
    grid_wait(count, (unsigned)loop_barrier(j, 0) * G);
  }

  // the k-th stamp of this block in the loop's row of 2 + 3 n_steps,
  // thread 0's clock: the start, then per step j its tokens folded (1 +
  // 3j), its LM head's start (2 + 3j) and end with the next sample's
  // partials (3 + 3j), and the end (1 + 3 n_steps) (decode.py
  // `loop_phases_us` splits them)
  __device__ void loop_stamp(int k) const {
    if (a.lp.stamps != nullptr && tid() == 0)
      a.lp.stamps[(size_t)b * (2 + 3 * a.lp.n_steps) + k] = global_ns();
  }
};

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

// The co-resident block count of a batched step kernel (`kernel`: the
// single step's or the loop's instance for read R) for rows of D values
// and S cache slots, or a negative cudaError / -1 for a shape it does not
// take (sets the kernel's shared-memory limit).
template <typename R>
int lane_blocks_t(const void* kernel, int D, int S) {
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
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, PS_THREADS, smem);
  if (err) return -err;
  return coop ? per_sm * sms : -1;
}

// one cooperative launch of a batched step kernel for read R
template <typename R>
int lane_launch_t(const void* kernel, const LaneArgs<typename R::Weights>& a,
                  int blocks, cudaStream_t st) {
  const size_t smem = lane_smem(a.w.block_size, sizeof(typename R::T) == 2);
  void* args[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(blocks),
                                          dim3(PS_THREADS), args, smem, st);
}

}  // namespace
