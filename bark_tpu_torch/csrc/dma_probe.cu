// D1-D5: the weight-stream probe, one kernel template for the five Pallas
// kernels of tools/tpu_dma_probe.py.
//
// Replaces `make_stream` (D1), `make_stream_dot` (D2),
// `make_stream_dotgroup` (D3), `make_stream_chain` (D4) and `make_stream2`
// (D5): an (N, R, 1024) bf16 array streamed from device memory `passes`
// times, each tile consumed in one of five ways (probes/dma.py has the
// functions and their plain versions).
//
// What bounds it: bytes. Every form reads each weight once a pass and does
// at most 2 FLOPs per weight, so a pass of the 256 MB array takes at least
// 256 MB / 3.35 TB/s = 80 us. The probe asks how close each way of moving
// a weight from device memory to an SM gets to that.
//
// The design: the (N R, 1024) rows are cut into stages of `srows` whole
// rows (8-48 KB, contiguous), and ~2 persistent blocks per SM each stream
// a contiguous run of stages, `passes` times. A block has 256 threads in
// two row groups of 128; a thread holds 8 columns of a row. The load
// method is a template parameter:
//   LD4       4-byte loads into registers, the warp reading 128 contiguous
//             bytes per instruction (K1's GEMV, `load2` in decode.cu);
//   LD16      16-byte loads into registers, a thread's 8 columns at once;
//   CP_ASYNC  16-byte cp.async.cg into a ring of `ring` stages in shared
//             memory, one commit group a stage;
//   BULK      one 1-D bulk copy (the TMA engine) a stage, into a ring with
//             a full and an empty mbarrier per slot.
// The register methods hold one stage (two for D5) in flight per block;
// the ring methods `ring` (D5: two rings of `ring`, even stages in one and
// odd in the other, each slot with its own barriers). A slot is refilled
// only after every thread released it (the empty barrier, or the
// __syncthreads after the consumer), which avoids the reference's
// prefetch hazard (probes/dma.py).
//
// The forms are runtime arguments of the same kernel: in "columns" mode
// each row is FMA'd against one x value into the thread's 8 column sums
// (D1: x = 1; D2: x[k]; D3: x[(i mod G) R + k]; D4 with G = 1: x[k]), in
// "rows" mode (D4 with G > 1) each row is dotted with x (1024 values) into
// one row sum. Sums across blocks are folded in a fixed order: each block
// writes its partials and takes its group's ticket; the last block of each
// group of 16 sums the group's partials in block order, and the last of
// those sums the group sums and writes `out` and the checksum (row mode:
// the last block sums each column's G row sums). Results do not depend on
// the order in which blocks finish. A D4 link is one launch (the host
// launches one per link, as K1 does its layers, from one C call, the
// launch planned once), whose finisher applies x <- bf16(tanh(1e-3 y)) in
// place.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int COLS = 1024;         // values per row (2 KB of bf16)
constexpr int ROW_BYTES = COLS * 2;
constexpr int THREADS = 256;       // two row groups of 128 threads
constexpr int FOLD_GROUP = 16;     // blocks whose partials one block sums
constexpr int MAX_SLOTS = 8;       // ring x rings
constexpr int STRIDE_OUT = COLS + 64;  // partial row with D1/D5's sum

enum { LD4 = 0, LD16 = 1, CP_ASYNC = 2, BULK = 3 };
enum { STREAM = 0, DOT = 1, DOTGROUP = 2, CHAIN = 3, DUAL = 4 };

struct Probe {
  const bf16* src;     // rows x 1024
  const bf16* x;       // null (D1, D5), G R values (D2-D3), 1024 (D4)
  int rows, R, G;      // rows of this launch, tile rows, group
  int srows, nr, ring; // stage rows, rings (1 or 2), ring depth
  int passes;
  int row_mode;        // D4 with G > 1: each row dotted with x
  int want_row0;       // D1, D5: out sums row 0 of each tile, columns < 128
  int form;
  float* partial;      // per-block column sums, or per-row sums, then
                       // the group sums at row cap_blocks
  int stride;          // floats between two partial rows
  int cap_blocks;      // the most blocks a launch has
  unsigned int* tickets;  // 1 + groups, zero between launches
  float* total;        // COLS + 1 folded sums
  bf16* xnext;         // D4: x, updated in place by the folders
  float* out;          // 128
  float* check;        // 1
};

// the column of value j (0..7) that thread q of a row group holds
template <int M>
__device__ __forceinline__ int col_of(int q, int j) {
  if (M == LD4) return 2 * (q + 128 * (j >> 1)) + (j & 1);
  return 8 * q + j;
}

__device__ __forceinline__ float lo_bf16(unsigned int u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned int u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Per-thread state of the consumer, identical for every load method.
template <int M>
struct Consumer {
  float acc[8];
  float row0;
  float xc[8];  // row mode: x at this thread's columns
  int q, h;

  __device__ void init(const Probe& p) {
    q = threadIdx.x & 127;
    h = threadIdx.x >> 7;
    row0 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j] = 0.0f;
      xc[j] = p.row_mode ? to_f32(p.x[col_of<M>(q, j)]) : 0.0f;
    }
  }

  // one row, tile i and row k of that tile, its 8 values at this thread's
  // columns; `lr` is its row index in the block's run (row mode)
  __device__ void row(const Probe& p, int i, int k, int lr, const float* v,
                      float* rowpart) {
    if (p.row_mode) {
      float d = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) d = fmaf(xc[j], v[j], d);
      d = warp_sum(d);
      if ((threadIdx.x & 31) == 0) rowpart[lr * 4 + ((q >> 5) & 3)] = d;
      return;
    }
    if (p.x == nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += v[j];
      if (p.want_row0 && k == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (col_of<M>(q, j) < 128) row0 += v[j];
      }
    } else {
      const float xv = to_f32(p.x[(i % p.G) * p.R + k]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(xv, v[j], acc[j]);
    }
  }
};

__device__ __forceinline__ void unpack8(const uint4& u, float* v) {
  v[0] = lo_bf16(u.x); v[1] = hi_bf16(u.x);
  v[2] = lo_bf16(u.y); v[3] = hi_bf16(u.y);
  v[4] = lo_bf16(u.z); v[5] = hi_bf16(u.z);
  v[6] = lo_bf16(u.w); v[7] = hi_bf16(u.w);
}

// Tile and tile row of row rr of a stage whose first row is tile i0, row
// k0 (one division a stage, not a row)
__device__ __forceinline__ void tile_pos(int i0, int k0, int rr, int R,
                                         int& i, int& k) {
  i = i0;
  k = k0 + rr;
  while (k >= R) {
    k -= R;
    ++i;
  }
}

// The run of stages of this block: [s0, s0 + n)
__device__ __forceinline__ void block_run(int stages, int& s0, int& n) {
  const int per = stages / gridDim.x, extra = stages % gridDim.x;
  const int b = blockIdx.x;
  s0 = b * per + min(b, extra);
  n = per + (b < extra ? 1 : 0);
}

// --------------------------------------------------------------- fold

// dst[c] = sum of `n` rows of `stride` floats at `rows`, in row order, for
// c < ncols (L2 loads: the rows were written by other blocks)
__device__ __forceinline__ void sum_rows(const float* rows, int n,
                                         int stride, int ncols, float* dst) {
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    float s = 0.0f;
#pragma unroll 8
    for (int r = 0; r < n; ++r) s += __ldcg(rows + (size_t)r * stride + c);
    dst[c] = s;
  }
}

// After the block's partials are written. Columns mode: blocks fold in
// groups of FOLD_GROUP (the last block of a group to arrive sums the
// group's rows), then the last group folder sums the group rows. Row mode:
// the last block sums the G row sums of every column. The finishing block
// applies D4's epilogue and writes out and the checksum.
__device__ void fold(const Probe& p, float* red) {
  __shared__ bool last;
  const int ncols = COLS + (p.want_row0 ? 1 : 0);
  float* group_rows = p.partial + (size_t)p.cap_blocks * p.stride;
  __threadfence();
  __syncthreads();
  if (p.row_mode) {
    if (threadIdx.x == 0)
      last = atomicAdd(&p.tickets[0], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) p.tickets[0] = 0;
    sum_rows(p.partial, p.G, COLS, COLS, p.total);
  } else {
    const int n_groups = (gridDim.x + FOLD_GROUP - 1) / FOLD_GROUP;
    const int g = blockIdx.x / FOLD_GROUP;
    const int members = min(FOLD_GROUP, (int)gridDim.x - g * FOLD_GROUP);
    if (threadIdx.x == 0)
      last = atomicAdd(&p.tickets[1 + g], 1u) == (unsigned)members - 1;
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) p.tickets[1 + g] = 0;
    sum_rows(p.partial + (size_t)g * FOLD_GROUP * p.stride, members,
             p.stride, ncols, group_rows + (size_t)g * p.stride);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(&p.tickets[0], 1u) == (unsigned)n_groups - 1;
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) p.tickets[0] = 0;
    sum_rows(group_rows, n_groups, p.stride, ncols, p.total);
  }
  // the finisher; each thread reads back the totals it wrote
  float s = 0.0f;
  for (int c = threadIdx.x; c < COLS; c += blockDim.x) {
    const float y = p.total[c];
    s += y;
    if (p.xnext != nullptr) p.xnext[c] = __float2bfloat16_rn(tanhf(y * 1e-3f));
  }
  s = block_sum(s, red);  // synchronises the block
  if (threadIdx.x == 0) p.check[0] = s;
  if (threadIdx.x < 128) {
    float o;
    if (p.form == CHAIN)
      o = __bfloat162float(p.xnext[threadIdx.x]);
    else
      o = p.total[p.want_row0 ? COLS : 0];
    p.out[threadIdx.x] = o;
  }
}

// Write the block's partials (columns mode: the two row groups' sums in
// group order; row mode: each row's 4 warp sums in warp order).
template <int M>
__device__ void finish_block(const Probe& p, Consumer<M>& cons,
                             const float* rowpart, int g0, int nrows,
                             float* red) {
  __shared__ float cs[COLS];
  __syncthreads();
  if (p.row_mode) {
    for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
      const float* rp = rowpart + 4 * i;
      p.partial[g0 + i] = ((rp[0] + rp[1]) + rp[2]) + rp[3];
    }
    fold(p, red);
    return;
  }
  if (cons.h == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[col_of<M>(cons.q, j)] = cons.acc[j];
  }
  __syncthreads();
  float* mine = p.partial + (size_t)blockIdx.x * p.stride;
  if (cons.h == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col_of<M>(cons.q, j);
      mine[c] = cons.acc[j] + cs[c];
    }
  }
  if (p.want_row0) {
    const float r0 = block_sum(cons.row0, red);
    if (threadIdx.x == 0) mine[COLS] = r0;
  }
  fold(p, red);
}

// ---------------------------------------------------------- the kernels

// Register methods: each thread loads SR rows of a stage (NB stages, 2 for
// D5) into registers, then consumes them.
template <int M, int SR, int NB>
__global__ void __launch_bounds__(THREADS)
    probe_regs_kernel(Probe p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ float red[32];
  float* rowpart = reinterpret_cast<float*>(dsm);
  const int stages = p.rows / p.srows;
  int s0, nloc;
  block_run(stages, s0, nloc);
  Consumer<M> cons;
  cons.init(p);
  const int T = p.passes * nloc;
  for (int t = 0; t < T; t += NB) {
    uint4 buf[NB][SR];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int st = s0 + (t + b) % nloc;
      const bool live = t + b < T;
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        const unsigned char* rowp =
            reinterpret_cast<const unsigned char*>(p.src) +
            ((size_t)st * p.srows + 2 * r + cons.h) * ROW_BYTES;
        if (!live) {
          buf[b][r] = make_uint4(0, 0, 0, 0);
        } else if (M == LD16) {
          buf[b][r] = __ldg(reinterpret_cast<const uint4*>(rowp) + cons.q);
        } else {
          const unsigned* w = reinterpret_cast<const unsigned*>(rowp);
          buf[b][r].x = __ldg(w + cons.q);
          buf[b][r].y = __ldg(w + cons.q + 128);
          buf[b][r].z = __ldg(w + cons.q + 256);
          buf[b][r].w = __ldg(w + cons.q + 384);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (t + b >= T) break;
      const int g0 = (s0 + (t + b) % nloc) * p.srows;
      const int i0 = g0 / p.R, k0 = g0 % p.R;
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        float v[8];
        unpack8(buf[b][r], v);  // LD4: pairs at 4 strided columns
        int i, k;
        tile_pos(i0, k0, 2 * r + cons.h, p.R, i, k);
        cons.row(p, i, k, (t + b) * p.srows + 2 * r + cons.h, v, rowpart);
      }
    }
  }
  finish_block<M>(p, cons, rowpart, s0 * p.srows, nloc * p.srows, red);
}

// Ring methods: stages land in nr rings of `ring` slots in shared memory.
template <int M>
__global__ void __launch_bounds__(THREADS)
    probe_ring_kernel(Probe p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ float red[32];
  __shared__ __align__(8) uint64_t full[MAX_SLOTS], empty[MAX_SLOTS];
  const int D = p.nr * p.ring;
  const unsigned stage_bytes = (unsigned)p.srows * ROW_BYTES;
  float* rowpart = reinterpret_cast<float*>(dsm + (size_t)D * stage_bytes);
  const int stages = p.rows / p.srows;
  int s0, nloc;
  block_run(stages, s0, nloc);
  const int T = p.passes * nloc;
  Consumer<M> cons;
  cons.init(p);
  // stage t of the run: ring t % nr, slot (t / nr) % ring of that ring
  auto slot = [&](int t) { return (t % p.nr) * p.ring + (t / p.nr) % p.ring; };
  auto gsrc = [&](int t) {
    return reinterpret_cast<const unsigned char*>(p.src) +
           (size_t)(s0 + t % nloc) * stage_bytes;
  };
  if (M == BULK && threadIdx.x == 0) {
    for (int i = 0; i < D; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the u-th stage goes to slot(u) on that slot's (u / D)-th use, after
  // every thread released the slot's previous use (u - D)
  auto produce = [&](int u) {
    if (M == BULK) {
      if (threadIdx.x != 0 || u >= T) return;
      const int sl = slot(u), use = u / D;
      if (use > 0) mbar_wait(&empty[sl], (use - 1) & 1);
      mbar_expect_tx(&full[sl], stage_bytes);
      bulk_copy(dsm + (size_t)sl * stage_bytes, gsrc(u), stage_bytes,
                &full[sl]);
    } else {
      if (u < T) {
        unsigned char* dst = dsm + (size_t)slot(u) * stage_bytes;
        const unsigned char* src = gsrc(u);
        for (unsigned c = threadIdx.x; c < stage_bytes / 16; c += THREADS)
          cp_async16(dst + 16 * c, src + 16 * c);
      }
      cp_async_commit();  // an empty group past the end keeps the count
    }
  };
  for (int u = 0; u < D - 1; ++u) produce(u);
  for (int t = 0; t < T; ++t) {
    produce(t + D - 1);  // into the slot stage t - 1 released
    const int sl = slot(t);
    if (M == BULK) {
      mbar_wait(&full[sl], (t / D) & 1);
    } else {
      cp_async_wait(D - 1);
      __syncthreads();
    }
    const unsigned char* base = dsm + (size_t)sl * stage_bytes;
    const int g0 = (s0 + t % nloc) * p.srows;
    const int i0 = g0 / p.R, k0 = g0 % p.R;
    for (int r = cons.h; r < p.srows; r += 2) {
      float v[8];
      unpack8(reinterpret_cast<const uint4*>(base + (size_t)r * ROW_BYTES)
                  [cons.q], v);
      int i, k;
      tile_pos(i0, k0, r, p.R, i, k);
      cons.row(p, i, k, t * p.srows + r, v, rowpart);
    }
    if (M == BULK)
      mbar_arrive(&empty[sl]);
    else
      __syncthreads();
  }
  finish_block<M>(p, cons, rowpart, s0 * p.srows, nloc * p.srows, red);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// A launch, planned once for a call (a D4 call launches it per link):
// the kernel of the method, its dynamic shared memory (set on the kernel
// here) and its grid, ~2 blocks an SM, all resident at once unless shared
// memory holds only one a block.
struct Plan {
  void (*kernel)(Probe);
  size_t dyn;
  int blocks;
};

int plan_kernel(void (*kernel)(Probe), const Probe& p, size_t dyn, int n_sm,
                Plan* out) {
  const int stages = p.rows / p.srows;
  int nb = std::min(stages, p.cap_blocks);
  if (p.row_mode)  // the row sums of the longest run (one pass)
    dyn += (size_t)((stages + nb - 1) / nb) * p.srows * 4 * sizeof(float);
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err) return err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           THREADS, dyn);
  if (err) return err;
  if (per_sm < 1) return -1;
  // a row-mode run's shared memory was sized for cap_blocks: keep them
  if (!p.row_mode) nb = std::min(nb, std::min(per_sm, 2) * n_sm);
  *out = Plan{kernel, dyn, nb};
  return 0;
}

int plan(int method, const Probe& p, int n_sm, Plan* out) {
  const size_t ring_bytes = (size_t)p.nr * p.ring * p.srows * ROW_BYTES;
  if (method == CP_ASYNC)
    return plan_kernel(probe_ring_kernel<CP_ASYNC>, p, ring_bytes, n_sm, out);
  if (method == BULK)
    return plan_kernel(probe_ring_kernel<BULK>, p, ring_bytes, n_sm, out);
  // register methods: SR = srows / 2 rows a thread, 1 or 2 stages
#define BARK_REGS(MM, SR)                                                   \
  if (method == MM && p.srows == 2 * SR)                                    \
    return plan_kernel(p.nr == 2 ? probe_regs_kernel<MM, SR, 2>             \
                                 : probe_regs_kernel<MM, SR, 1>,            \
                       p, 0, n_sm, out);
  BARK_REGS(LD4, 2) BARK_REGS(LD4, 4) BARK_REGS(LD4, 8)
  BARK_REGS(LD16, 2) BARK_REGS(LD16, 4) BARK_REGS(LD16, 8)
#undef BARK_REGS
  return -1;
}

int go(const Plan& pl, const Probe& p, cudaStream_t stream) {
  pl.kernel<<<pl.blocks, THREADS, pl.dyn, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// One probe call. form: 0 stream (D1), 1 dot (D2), 2 dotgroup (D3),
// 3 chain (D4), 4 dual (D5); method: 0 ld4, 1 ld16, 2 cp_async, 3 bulk.
// src (N, R, 1024) bf16; x (1, G R) bf16 for D2/D3, (1, 1024) for D4, null
// otherwise. D4 launches passes x N / G links, each a kernel over its G
// tiles, with x copied into `xbuf` (1024 bf16) first and updated there.
// partial: `cap` floats of scratch; tickets: `n_tickets` zeroed uints, left
// zeroed; total: 1025 floats; out: 128 floats; check: 1 float. Returns 0,
// -1 for a shape or argument the kernel does not take, or a cudaError.
extern "C" int bark_dma_probe(int form, int method, const void* src,
                              const void* x, void* xbuf, int N, int R, int G,
                              int ring, int stage_rows, int passes,
                              float* partial, long long cap,
                              unsigned int* tickets, int n_tickets,
                              float* total, float* out, float* check,
                              cudaStream_t stream) {
  if (form < STREAM || form > DUAL || method < LD4 || method > BULK ||
      N <= 0 || R <= 0 || G <= 0 || N % G || passes <= 0 ||
      stage_rows <= 0 || stage_rows % 2 || ring < 1 || ring > 4)
    return -1;
  Probe p{};
  p.src = (const bf16*)src;
  p.x = (const bf16*)x;
  p.R = R;
  p.G = form == DOTGROUP ? G : 1;
  p.srows = stage_rows;
  p.nr = form == DUAL ? 2 : 1;
  p.ring = method >= CP_ASYNC ? ring : 1;
  p.want_row0 = form == STREAM || form == DUAL;
  p.form = form;
  p.partial = partial;
  p.tickets = tickets;
  p.total = total;
  p.out = out;
  p.check = check;
  if ((form == STREAM || form == DUAL) != (x == nullptr)) return -1;
  if ((size_t)p.nr * p.ring * stage_rows * ROW_BYTES > 227 * 1024 - 8192)
    return -1;
  const int n_sm = sm_count();
  p.cap_blocks = 2 * n_sm;
  const int n_groups = (p.cap_blocks + FOLD_GROUP - 1) / FOLD_GROUP;
  if (n_tickets < 1 + n_groups) return -1;
  Plan pl;
  if (form != CHAIN) {
    p.rows = N * R;
    p.passes = passes;
    p.stride = p.want_row0 ? STRIDE_OUT : COLS;
    if (p.rows % stage_rows ||
        (long long)(p.cap_blocks + n_groups) * p.stride > cap)
      return -1;
    const int err = plan(method, p, n_sm, &pl);
    return err ? err : go(pl, p, stream);
  }
  // D4: R == 1024, one link a kernel; G = 1 contracts over W's rows
  // (columns mode), G > 1 over its columns (row mode) and sums the G tiles
  if (R != COLS || xbuf == nullptr || COLS % stage_rows) return -1;
  p.rows = G * COLS;
  p.passes = 1;
  p.row_mode = G > 1;
  p.G = G > 1 ? G : 1;
  p.stride = COLS;
  p.x = (const bf16*)xbuf;
  p.xnext = (bf16*)xbuf;
  if ((long long)std::max((p.cap_blocks + n_groups) * COLS, G * COLS) > cap)
    return -1;
  int err = plan(method, p, n_sm, &pl);
  if (err) return err;
  err = (int)cudaMemcpyAsync(xbuf, x, COLS * sizeof(bf16),
                             cudaMemcpyDeviceToDevice, stream);
  if (err) return err;
  for (int pass = 0; pass < passes; ++pass)
    for (int l = 0; l < N / G; ++l) {
      p.src = (const bf16*)src + (size_t)l * G * COLS * COLS;
      err = go(pl, p, stream);
      if (err) return err;
    }
  return 0;
}
