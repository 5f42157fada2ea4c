// P1-P9: the lowering probe, one source for the ten Pallas kernels of
// tools/tpu_mosaic_probe.py. Each asked whether Mosaic lowers a construct
// that a whole-stage decode kernel needs; here each asks what the Hopper
// counterpart of that construct costs. The kernels take their sizes as
// arguments, so one kernel runs at the reference's shapes and at
// bark-small's (probes/lowering.py has the functions, their plain
// versions and the questions).
//
// P1 `probe_while_loop` (`pallas_call` at :71): a loop on a counter that
//    the body updates. (a) the reference's one block, the counter in
//    shared memory; (b) a persistent grid under a cooperative launch, a
//    grid-wide barrier an iteration and a stop flag that block 0 sets on
//    the device (the EOS stop); (c) one launch an iteration, the chain the
//    host drives. Bound: latency, not bytes (8 bytes move); the design
//    puts a number on each way of carrying a dependency.
// P2 `probe_vector_to_smem_scalar` (:95): a block reduction (the first
//    lane holding the max) turned into a scalar that later code uses.
//    Bound: one read of the row.
// P2b `probe_scalar_dma_row` (:127): the argmax, then a bulk copy of the
//    aligned group of table rows holding that token into shared memory, in
//    the same block; the two-launch form writes the token to device memory
//    and a second kernel reads it. Bound: the row read plus one table row.
// P3 `probe_dynamic_leading_dma` (:162): the rows of g summed in order.
//    `block`: one block, each row a bulk copy at the loop's index, with the
//    next row's copy in flight or not (the question: a row read's latency
//    in a persistent kernel). `strips`: a block for each strip of 64
//    columns, which issues a bulk copy of its strip of every row (a ring
//    of 64-row stages past 256 rows) before it adds anything, so that the
//    card's SMs, not one, read g with all of it in flight; each thread
//    then sums its column in row order, as the plain version does (bit
//    for bit). Bound: one read of g.
// P4 `probe_dynamic_vmem_read` (:196): a block's columns of p in shared
//    memory, read at a run-time layer index; the layer loop unrolled or
//    not. Bound: one read of p; the question is registers and program size.
// P5 `probe_dynamic_vmem_write` (:227): x + l staged in shared memory at a
//    run-time layer index, then bulk stores out. Bound: one write of out.
// P6 `probe_dyn_ring_stream` (:283): a bulk-copy ring with full and empty
//    mbarriers over layers of tiles, the next layer's first tiles in
//    flight across the layer boundary or the ring drained there; 1 block
//    (the reference) or a persistent grid with a grid-wide barrier a layer.
//    Bound: one read of w (the stream).
// P7 `probe_dynamic_hbm_write` (:315) and P8 `probe_dynamic_hbm_write_rowoff`
//    (:350): rows written to device memory at a run-time layer index (P8:
//    and a run-time row offset), by bulk stores from shared memory or by
//    plain 16-byte stores. A bulk copy takes 16-byte aligned addresses and
//    sizes (hopper.cuh): a row of 16-byte multiples may start at any row,
//    where the TPU's copies wanted 8-row windows. `bulk` and `st16`: a
//    block for each chunk of a lane's rows, every layer in turn, one round
//    trip in flight. `ring`: a persistent grid (a block an SM), each block
//    a contiguous run of the flattened (lane, layer, row) range, its layer
//    and row found at run time; it keeps a ring of stages loading while
//    earlier stages' bulk stores drain, so that megabytes, not a few
//    hundred KB, are in flight across the card; one set of rows for every
//    layer (src_ls 0) is read once and stored L times. Bound: the rows
//    read and written.
// P9 `probe_transposed_group_dot` (:391): x (M, K) against g slots of
//    (N, K) weights read as one (g N, K) operand, contracting both on K.
//    `simt`: f32 FMAs on the CUDA cores, any float type; `wgmma`: bf16,
//    wgmma.mma_async with A (x's rows, padded to 64) and B (32 rows of the
//    slots) read K-major from shared memory through no-swizzle descriptors.
//    The operands are re-laid out on their way in: per-thread 16-byte
//    cp.async puts the row-major slots into core-matrix order (8 rows x 16
//    bytes), where a bulk or TMA fill would need a tensor map or a swizzled
//    layout. The slot boundary is invisible to the descriptor. Bound: the
//    weight read at small M, the tensor cores' rate at large.
//
// Every entry returns cudaGetLastError() of its launches, or -1 for
// arguments the kernels do not take.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MAX_DYN_SMEM = 227 * 1024 - 1024;  // less the static barriers

// ------------------------------------------------------------ P1

// (a) the reference: the loop's condition reads a counter in shared memory
// that its body increments; c is the loop carry, the iterations run.
__global__ void while_block_kernel(const int* x, int* out) {
  __shared__ volatile int cnt;
  if (threadIdx.x != 0) return;
  const int n = x[0];
  cnt = 0;
  int c = 0;
  while (cnt < n) {
    cnt = cnt + 1;
    c = c + 1;
  }
  out[0] = c;
}

// (b) every block runs the loop; block 0 tests the condition and writes
// the iteration at which all stop (stop[0], -1 until then), which every
// block reads after that iteration's barrier. A block that reads it early
// sees another iteration's number and goes on, so none leaves early. The
// entry zeroes the barrier's count before each launch.
__global__ void while_grid_kernel(const int* x, int* out, unsigned* count,
                                  int* stop) {
  const int n = x[0];
  if (n <= 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = 0;
    return;
  }
  int i = 0;
  for (;; ++i) {
    if (blockIdx.x == 0 && threadIdx.x == 0 && i + 1 >= n) stop[0] = i;
    grid_barrier(count, (unsigned)(i + 1) * gridDim.x);
    if (*(volatile int*)stop == i) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = i + 1;
}

// (c) one iteration; the host launches it n times
__global__ void while_step_kernel(const int* x, int* cnt, int* out) {
  const int c = cnt[0];
  if (c < x[0]) cnt[0] = c + 1;
  out[0] = cnt[0];
}

// ------------------------------------------------------------ P2, P2b

// max that keeps a NaN (jnp.max, torch.max)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// The first index of the maximum of v[0, n), in every thread; 2^30 when
// v holds a NaN (no value equals the max), as the reference gives.
__device__ int block_argmax_first(const float* v, int n) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = max_nan(m, v[i]);
  for (int o = 16; o; o >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) redf[warp] = m;
  __syncthreads();
  m = lane < nw ? redf[lane] : -INFINITY;
  for (int o = 16; o; o >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  int t = 1 << 30;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (v[i] == m) {
      t = i;
      break;
    }
  for (int o = 16; o; o >>= 1) t = min(t, __shfl_xor_sync(0xffffffffu, t, o));
  if (lane == 0) redi[warp] = t;
  __syncthreads();
  t = lane < nw ? redi[lane] : 1 << 30;
  for (int o = 16; o; o >>= 1) t = min(t, __shfl_xor_sync(0xffffffffu, t, o));
  return t;
}

constexpr int ARG_THREADS = 1024;

// P2: out = 2 tok + 1 (wrapping as int32 does); tok to `tok` when given
__global__ void __launch_bounds__(ARG_THREADS)
    argmax_kernel(const float* v, int n, int* tok, int* out) {
  const int t = block_argmax_first(v, n);
  if (threadIdx.x == 0) {
    if (tok != nullptr) tok[0] = t;
    if (out != nullptr) out[0] = (int)((unsigned)t * 2u + 1u);
  }
}

// P2b: the token (the argmax of v, or read from tok_in), its aligned group
// of `group` table rows copied into shared memory, its row to out; out is
// zeros when the group lies outside the table (tok 2^30 from a NaN).
template <bool ARGMAX>
__global__ void __launch_bounds__(ARG_THREADS)
    row_kernel(const float* v, int n, const int* tok_in,
               const unsigned char* tbl, int rows, int row_bytes, int group,
               unsigned char* out) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full;
  const int t = ARGMAX ? block_argmax_first(v, n) : tok_in[0];
  const long long base = t >= 0 ? (long long)(t / group) * group : -1;
  const bool ok = base >= 0 && base + group <= rows;
  if (threadIdx.x == 0 && ok) {
    mbar_init(&full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (ok) {
    if (threadIdx.x == 0) {
      const unsigned bytes = (unsigned)group * row_bytes;
      mbar_expect_tx(&full, bytes);
      bulk_copy(dsm, tbl + base * row_bytes, bytes, &full);
    }
    mbar_wait(&full, 0);
  }
  const uint4* row =
      reinterpret_cast<const uint4*>(dsm + (ok ? (t - base) * row_bytes : 0));
  for (int i = threadIdx.x; i < row_bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(out)[i] = ok ? row[i] : make_uint4(0, 0, 0, 0);
}

// ------------------------------------------------------------ P3

constexpr int ROWSUM_COLS = 16;  // columns a thread sums: width <= 16384

// acc = acc + g[j] for j in order; with PREFETCH row j + 1's copy is
// issued before row j is summed (two slots), else after.
template <bool PREFETCH>
__global__ void __launch_bounds__(1024)
    rows_sum_kernel(const float* g, int n_rows, int width, float* out) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full[2];
  const unsigned row_bytes = (unsigned)width * 4;
  float acc[ROWSUM_COLS];
#pragma unroll
  for (int k = 0; k < ROWSUM_COLS; ++k) acc[k] = 0.0f;
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto start = [&](int j) {
    mbar_expect_tx(&full[j & 1], row_bytes);
    bulk_copy(dsm + (j & 1) * row_bytes, g + (size_t)j * width, row_bytes,
              &full[j & 1]);
  };
  if (threadIdx.x == 0 && n_rows > 0) start(0);
  for (int j = 0; j < n_rows; ++j) {
    if (PREFETCH && threadIdx.x == 0 && j + 1 < n_rows) start(j + 1);
    mbar_wait(&full[j & 1], (j >> 1) & 1);
    const float* row = reinterpret_cast<const float*>(dsm + (j & 1) * row_bytes);
#pragma unroll
    for (int k = 0; k < ROWSUM_COLS; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < width) acc[k] = acc[k] + row[c];
    }
    __syncthreads();  // the slot is read before it is filled again
    if (!PREFETCH && threadIdx.x == 0 && j + 1 < n_rows) start(j + 1);
  }
#pragma unroll
  for (int k = 0; k < ROWSUM_COLS; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < width) out[c] = acc[k];
  }
}

constexpr int STRIP_COLS = 64;   // columns a block of `strips` sums, one a thread
constexpr int STRIP_ROWS = 64;   // rows a stage of a strip holds
constexpr int STRIP_STAGES = 4;  // stages in flight: all of g up to 256 rows

// out[c0 + c] = sum over j in order of g[j, c0 + c] for the block's strip
// of columns (the last one may be narrower, 16 bytes at least). Group k of
// STRIP_ROWS rows lands in stage k % stages, each row's strip a bulk copy
// issued by a lane of the first warp; a stage is refilled after every
// thread has summed it.
__global__ void __launch_bounds__(STRIP_COLS)
    rows_sum_strips_kernel(const float* g, int n_rows, int width, float* out) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full[STRIP_STAGES];
  const int c0 = blockIdx.x * STRIP_COLS, c = threadIdx.x;
  const int cols = min(STRIP_COLS, width - c0);
  const unsigned seg = (unsigned)cols * 4;  // a multiple of 16: width % 4 == 0
  const int groups = (n_rows + STRIP_ROWS - 1) / STRIP_ROWS;
  const int stages = min(groups, STRIP_STAGES);
  const int lane = threadIdx.x & 31;
  const bool issuer = threadIdx.x < 32;
  const size_t stage_bytes = (size_t)STRIP_ROWS * STRIP_COLS * 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int k) {
    const int s = k % stages, j0 = k * STRIP_ROWS;
    const int nr = min(STRIP_ROWS, n_rows - j0);
    if (lane == 0) mbar_expect_tx(&full[s], (unsigned)nr * seg);
    __syncwarp();  // the arrival first; the copies' bytes count against it
    for (int r = lane; r < nr; r += 32)
      bulk_copy(dsm + s * stage_bytes + (size_t)r * STRIP_COLS * 4,
                g + (size_t)(j0 + r) * width + c0, seg, &full[s]);
  };
  if (issuer)
    for (int k = 0; k < stages; ++k) issue(k);
  float acc = 0.0f;
  for (int k = 0; k < groups; ++k) {
    const int s = k % stages;
    mbar_wait(&full[s], (k / stages) & 1);
    const float* rows = reinterpret_cast<const float*>(dsm + s * stage_bytes);
    const int nr = min(STRIP_ROWS, n_rows - k * STRIP_ROWS);
    if (c < cols)
      for (int r = 0; r < nr; ++r) acc = acc + rows[r * STRIP_COLS + c];
    if (k + stages < groups) {
      __syncthreads();  // every thread has read stage s
      if (issuer) issue(k + stages);
    }
  }
  if (c < cols) out[c0 + c] = acc;
}

// ------------------------------------------------------------ P4, P5

constexpr int LP_COLS = 128;   // columns a block of P4/P5 takes, one a thread
constexpr int MAX_LAYERS = 16;
constexpr int P4_ROWS = 16;    // rows a layer of P4's params
constexpr int P5_ROWS = 8;     // rows a layer of P5's stage

// out[c] = sum over l of p[l, 0, c] + 2 p[l, 3, c], in the loop's order,
// the block's columns of p copied into shared memory first
template <bool UNROLL>
__global__ void __launch_bounds__(LP_COLS)
    layer_read_kernel(const float* p, int L, int W, float* out) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full;
  const float* s = reinterpret_cast<const float*>(dsm);  // (L, 16, LP_COLS)
  const int c0 = blockIdx.x * LP_COLS, c = threadIdx.x;
  if (threadIdx.x == 0) {
    mbar_init(&full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned seg = LP_COLS * 4;
    mbar_expect_tx(&full, (unsigned)L * P4_ROWS * seg);
    for (int i = 0; i < L * P4_ROWS; ++i)
      bulk_copy(dsm + (size_t)i * seg, p + (size_t)i * W + c0, seg, &full);
  }
  mbar_wait(&full, 0);
  float acc = 0.0f;
  if (UNROLL) {
#pragma unroll
    for (int l = 0; l < MAX_LAYERS; ++l)
      if (l < L)
        acc = (acc + s[(l * P4_ROWS) * LP_COLS + c]) +
              s[(l * P4_ROWS + 3) * LP_COLS + c] * 2.0f;
  } else {
#pragma unroll 1
    for (int l = 0; l < L; ++l)
      acc = (acc + s[(l * P4_ROWS) * LP_COLS + c]) +
            s[(l * P4_ROWS + 3) * LP_COLS + c] * 2.0f;
  }
  out[c0 + c] = acc;
}

// stage[l] = x + l for the block's columns, then bulk stores into out
// (L, 8, W): one store of the whole stage when the block spans the width
template <bool UNROLL>
__global__ void __launch_bounds__(LP_COLS)
    layer_write_kernel(const float* x, int L, int W, float* out) {
  extern __shared__ __align__(128) unsigned char dsm[];
  float* st = reinterpret_cast<float*>(dsm);  // (L, 8, LP_COLS)
  const int c0 = blockIdx.x * LP_COLS, c = threadIdx.x;
  float xv[P5_ROWS];
#pragma unroll
  for (int r = 0; r < P5_ROWS; ++r) xv[r] = x[(size_t)r * W + c0 + c];
  if (UNROLL) {
#pragma unroll
    for (int l = 0; l < MAX_LAYERS; ++l)
      if (l < L) {
#pragma unroll
        for (int r = 0; r < P5_ROWS; ++r)
          st[(l * P5_ROWS + r) * LP_COLS + c] = xv[r] + (float)l;
      }
  } else {
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int r = 0; r < P5_ROWS; ++r)
        st[(l * P5_ROWS + r) * LP_COLS + c] = xv[r] + (float)l;
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned seg = LP_COLS * 4;
    if (W == LP_COLS) {
      bulk_store(out, st, (unsigned)L * P5_ROWS * seg);
    } else {
      for (int i = 0; i < L * P5_ROWS; ++i)
        bulk_store(out + (size_t)i * W + c0, st + i * LP_COLS, seg);
    }
    bulk_commit();
    bulk_wait();
  }
}

// ------------------------------------------------------------ P6

constexpr int RING_THREADS = 128;
constexpr int RING_COLS = 8;  // row-0 columns a thread sums: W <= 1024
constexpr int RING_MAX = 4;

struct Ring {
  const unsigned char* w;  // (L, T, tile) tiles of tile_bytes
  int L, T, W, ring, prefetch;
  unsigned tile_bytes;
  unsigned* count;    // the grid barrier's counter (zero, left zero)
  float* partial;     // gridDim.x rows of W
  unsigned* ticket;   // zero, left zero
  float* out;         // W
};

// Block b takes tiles b, b + nb, ... of every layer, in order, through a
// ring of `ring` slots (full: the bytes landed; empty: every thread read
// the slot). Its row-0 sums go to partial[b]; the last block to finish
// sums the partials in block order into out.
template <typename T>
__global__ void __launch_bounds__(RING_THREADS) ring_kernel(Ring p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full[RING_MAX], empty[RING_MAX];
  __shared__ bool last;
  const int nb = gridDim.x, b = blockIdx.x;
  const int n = b < p.T ? (p.T - b + nb - 1) / nb : 0;  // tiles a layer
  const int U = p.L * n;
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.ring; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], RING_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  auto produce = [&](int v) {
    const int slot = v % p.ring, use = v / p.ring;
    if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
    const int l = v / n, t = b + (v % n) * nb;
    mbar_expect_tx(&full[slot], p.tile_bytes);
    bulk_copy(dsm + (size_t)slot * p.tile_bytes,
              p.w + ((size_t)l * p.T + t) * p.tile_bytes, p.tile_bytes,
              &full[slot]);
  };
  float acc[RING_COLS];
#pragma unroll
  for (int k = 0; k < RING_COLS; ++k) acc[k] = 0.0f;
  int issued = 0;  // thread 0's next tile to copy
  for (int l = 0; l < p.L; ++l) {
    for (int i = 0; i < n; ++i) {
      const int u = l * n + i;
      if (threadIdx.x == 0)
        while (issued < U && issued < u + p.ring &&
               (p.prefetch || issued / n == l))
          produce(issued++);
      const int slot = u % p.ring;
      mbar_wait(&full[slot], (u / p.ring) & 1);
      const T* row = reinterpret_cast<const T*>(dsm + (size_t)slot * p.tile_bytes);
#pragma unroll
      for (int k = 0; k < RING_COLS; ++k) {
        const int c = threadIdx.x + k * RING_THREADS;
        if (c < p.W) acc[k] = acc[k] + to_f32(row[c]);
      }
      mbar_arrive(&empty[slot]);
    }
    if (nb > 1) grid_barrier(p.count, (unsigned)(l + 1) * nb);
  }
#pragma unroll
  for (int k = 0; k < RING_COLS; ++k) {
    const int c = threadIdx.x + k * RING_THREADS;
    if (c < p.W) p.partial[(size_t)b * p.W + c] = acc[k];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.ticket, 1u) == (unsigned)nb - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) {  // every block has passed every barrier
    *p.ticket = 0;
    *p.count = 0;
  }
  for (int c = threadIdx.x; c < p.W; c += RING_THREADS) {
    float s = __ldcg(p.partial + c);
    for (int q = 1; q < nb; ++q) s = s + __ldcg(p.partial + (size_t)q * p.W + c);
    p.out[c] = s;
  }
}

// ------------------------------------------------------------ P7, P8

constexpr int WRITE_THREADS = 128;
constexpr int WRITE_SMEM = 32 * 1024;  // a block's rows in flight (bulk)
constexpr int TARGET_BLOCKS = 132;

constexpr int WRING_MAX = 16;  // `ring`: stages a block keeps

struct RowWrite {
  const unsigned char* src;  // (L, B, rows) rows; src_ls 0: one set for all L
  long long src_ls, src_bs;  // bytes between layers, lanes
  unsigned char* dst;        // (L, B, S) rows
  long long dst_ls, dst_bs;
  const int* offs;           // B row offsets, or null (every offset 0)
  int L, B, rows, row_bytes, S, align;
  int chunk;                 // rows a block (bulk, st16) or a stage (ring)
  int stages;                // ring: 2 to WRING_MAX
  unsigned long long* stamps;  // ring: 4 ns a block, or null (RING_STAMPS)
};

// the ring's stamps of a block: its start, its first and last piece
// landed, its stores complete (%globaltimer)
constexpr int RING_STAMPS = 4;

// The first row of lane b's window, or -1 when the window leaves [0, S).
__device__ __forceinline__ long long window_base(const RowWrite& p, int b) {
  const long long off = p.offs != nullptr ? p.offs[b] : 0;
  const long long base = off >= 0 ? off / p.align * p.align : -1;
  return base >= 0 && base + p.rows <= p.S ? base : -1;
}

// Block (x, y) writes rows [x chunk, ...) of lane y into every layer, at
// row (off // align) align + r of the lane; a lane whose rows would leave
// [0, S) is not written. BULK: each layer's rows a bulk copy into shared
// memory (once when src_ls is 0) and a bulk store out; else 16-byte loads
// and stores.
template <bool BULK>
__global__ void __launch_bounds__(WRITE_THREADS) row_write_kernel(RowWrite p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full;
  const int b = blockIdx.y, r0 = blockIdx.x * p.chunk;
  const int nr = min(p.chunk, p.rows - r0);
  const long long base = window_base(p, b);
  if (base < 0 || nr <= 0) return;
  const unsigned bytes = (unsigned)nr * p.row_bytes;
  const unsigned char* src = p.src + b * p.src_bs + (long long)r0 * p.row_bytes;
  unsigned char* dst = p.dst + b * p.dst_bs + (base + r0) * p.row_bytes;
  if (BULK) {
    if (threadIdx.x != 0) return;  // one thread moves the block's rows
    mbar_init(&full, 1);
    mbar_fence_init();
    unsigned phase = 0;
    for (int l = 0; l < p.L; ++l) {
      if (l == 0 || p.src_ls != 0) {
        if (l > 0) bulk_wait_read();  // the last store has read the rows
        mbar_expect_tx(&full, bytes);
        bulk_copy(dsm, src + l * p.src_ls, bytes, &full);
        mbar_wait(&full, phase);
        phase ^= 1;
      }
      bulk_store(dst + l * p.dst_ls, dsm, bytes);
      bulk_commit();
    }
    bulk_wait();
  } else {
    for (int l = 0; l < p.L; ++l) {
      const uint4* s = reinterpret_cast<const uint4*>(src + l * p.src_ls);
      uint4* d = reinterpret_cast<uint4*>(dst + l * p.dst_ls);
      for (unsigned i = threadIdx.x; i < bytes / 16; i += WRITE_THREADS)
        d[i] = s[i];
    }
  }
}

// wait until all but the newest of the thread's bulk groups have read
// their shared memory
__device__ __forceinline__ void bulk_wait_read_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// `ring`: block x takes units [x U / grid, (x + 1) U / grid) of the U =
// B x L' x rows units (lane, layer, row), L' = L, or 1 when src_ls is 0
// (then each piece is stored into every layer). A piece is a run of at
// most `chunk` rows of one lane and layer, or of one lane where its
// layers lie end to end in src and in dst (a prefill's slabs); a lane
// whose window leaves [0, S) has none. One thread keeps `stages` pieces
// loading; after piece k's store it refills piece k - 1's stage, once
// that store has read it.
__global__ void __launch_bounds__(32) row_ring_kernel(RowWrite p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full[WRING_MAX];
  __shared__ unsigned char* pdst[WRING_MAX];  // each stage's piece: its rows
  __shared__ unsigned pbytes[WRING_MAX];      // in layer 0 (once) or its own
  if (threadIdx.x != 0) return;
  const unsigned long long t_start = global_ns();
  unsigned long long t_first = 0, t_last = 0;
  const bool once = p.src_ls == 0;
  const long long layer_bytes = (long long)p.rows * p.row_bytes;
  const bool flat = !once && p.src_ls == layer_bytes && p.dst_ls == layer_bytes;
  const long long per_lane = (long long)(once ? 1 : p.L) * p.rows;
  const long long total = per_lane * p.B;
  const long long u1 = total * (blockIdx.x + 1) / gridDim.x;
  long long u = total * blockIdx.x / gridDim.x;
  const unsigned stage_bytes = (unsigned)p.chunk * p.row_bytes;
  for (int s = 0; s < p.stages; ++s) mbar_init(&full[s], 1);
  mbar_fence_init();
  // the next piece of the run into stage k % stages; false past its end
  auto load = [&](int k) -> bool {
    while (u < u1) {
      const int b = (int)(u / per_lane);
      const long long base = window_base(p, b);
      if (base < 0) {
        u = min(u1, (b + 1) * per_lane);
        continue;
      }
      const long long rem = u % per_lane;
      const int l = (int)(rem / p.rows), r = (int)(rem % p.rows);
      const long long left = flat ? per_lane - rem : p.rows - r;
      const int n = (int)min(min((long long)p.chunk, left), u1 - u);
      const int s = k % p.stages;
      pdst[s] = p.dst + b * p.dst_bs + l * p.dst_ls + (base + r) * p.row_bytes;
      pbytes[s] = (unsigned)n * p.row_bytes;
      mbar_expect_tx(&full[s], pbytes[s]);
      bulk_copy(dsm + (size_t)s * stage_bytes,
                p.src + b * p.src_bs + l * p.src_ls + (long long)r * p.row_bytes,
                pbytes[s], &full[s]);
      u += n;
      return true;
    }
    return false;
  };
  int loaded = 0;
  while (loaded < p.stages && load(loaded)) ++loaded;
  for (int k = 0; k < loaded; ++k) {
    const int s = k % p.stages;
    mbar_wait(&full[s], (k / p.stages) & 1);
    if (p.stamps != nullptr) {
      t_last = global_ns();
      if (k == 0) t_first = t_last;
    }
    for (int l = 0; l < (once ? p.L : 1); ++l)
      bulk_store(pdst[s] + l * p.dst_ls, dsm + (size_t)s * stage_bytes,
                 pbytes[s]);
    bulk_commit();
    if (k > 0 && loaded == k - 1 + p.stages) {
      bulk_wait_read_but_one();  // piece k - 1's stores have read its stage
      if (load(loaded)) ++loaded;
    }
  }
  bulk_wait();
  if (p.stamps != nullptr) {
    unsigned long long* t = p.stamps + (size_t)blockIdx.x * RING_STAMPS;
    t[0] = t_start;
    t[1] = t_first;
    t[2] = t_last;
    t[3] = global_ns();
  }
}

// ------------------------------------------------------------ P9

constexpr int DOT_WARPS = 8;  // output columns a simt block
constexpr int DOT_MT = 8;     // x rows a warp's pass
constexpr int WG_N = 32;      // output columns a wgmma block (n of m64n32k16)

// out[m, j] = sum_k x[m, k] w[j, k], one warp a column j, f32 FMAs
template <typename T>
__global__ void __launch_bounds__(DOT_WARPS * 32)
    group_dot_simt_kernel(const T* x, const T* w, int M, int NG, int K,
                          float* out) {
  extern __shared__ __align__(128) unsigned char dsm[];
  T* xs = reinterpret_cast<T*>(dsm);  // (M, K)
  for (int i = threadIdx.x; i < M * K; i += blockDim.x) xs[i] = x[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * DOT_WARPS + warp;
  if (j >= NG) return;
  const T* wr = w + (size_t)j * K;
  for (int m0 = 0; m0 < M; m0 += DOT_MT) {
    float acc[DOT_MT];
#pragma unroll
    for (int i = 0; i < DOT_MT; ++i) acc[i] = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float wv = to_f32(wr[k]);
#pragma unroll
      for (int i = 0; i < DOT_MT; ++i)
        if (m0 + i < M) acc[i] = fmaf(to_f32(xs[(m0 + i) * K + k]), wv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < DOT_MT; ++i) {
      const float s = warp_sum(acc[i]);
      if (lane == 0 && m0 + i < M) out[(size_t)(m0 + i) * NG + j] = s;
    }
  }
}

// A wgmma matrix descriptor of a no-swizzle K-major operand: core
// matrices of 8 rows x 16 bytes (128 contiguous bytes), `lbo` bytes
// between the two core matrices of a k16 step, `sbo` between 8-row groups.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, unsigned lbo,
                                               unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d = A B (scale_d 0) or d += A B (1)
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// Row r, 16-byte chunk c of a (rows, K) bf16 operand in the core-matrix
// layout: 8-row group r / 8 holds its K / 8 core matrices in K order.
__device__ __forceinline__ unsigned char* core_at(unsigned char* base, int r,
                                                  int c, int kc) {
  return base + (r >> 3) * (kc * 128) + c * 128 + (r & 7) * 16;
}

// out[m, j0 + n] for the block's 32 columns: A = x's M rows (zeros to 64),
// B = rows j0 .. j0 + 31 of the (NG, K) slots, both copied into shared
// memory in the core-matrix layout by 16-byte cp.async, then K / 16
// wgmma steps into 16 f32 registers a thread.
__global__ void __launch_bounds__(128)
    group_dot_wgmma_kernel(const bf16* x, const bf16* w, int M, int NG,
                           int K, float* out) {
  extern __shared__ __align__(128) unsigned char dsm[];
  unsigned char* sa = dsm;                     // (64, K)
  unsigned char* sb = dsm + (size_t)64 * K * 2;  // (WG_N, K)
  const int j0 = blockIdx.x * WG_N, kc = K / 8;
  for (int i = threadIdx.x; i < 64 * kc; i += 128) {
    const int r = i / kc, c = i % kc;
    unsigned char* d = core_at(sa, r, c, kc);
    if (r < M)
      cp_async16(d, x + (size_t)r * K + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
  for (int i = threadIdx.x; i < WG_N * kc; i += 128) {
    const int r = i / kc, c = i % kc;
    unsigned char* d = core_at(sb, r, c, kc);
    if (j0 + r < NG)
      cp_async16(d, w + (size_t)(j0 + r) * K + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  cp_async_wait(0);
  fence_proxy_async();
  __syncthreads();
  float d[16];  // written by the first step (scale-d 0)
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const unsigned sbo = (unsigned)kc * 128;
  for (int k = 0; k < K / 16; ++k)
    wgmma_m64n32k16(d, wgmma_desc(sa + k * 256, 128, sbo),
                    wgmma_desc(sb + k * 256, 128, sbo), k > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  // D's fragment: warp q holds rows 16 q .. 16 q + 15; register 4 n8 + 2 h
  // + e is row 16 q + lane / 4 + 8 h, column 8 n8 + 2 (lane % 4) + e
  const int q = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int n8 = 0; n8 < WG_N / 8; ++n8)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 16 * q + (lane >> 2) + 8 * h;
        const int col = j0 + 8 * n8 + 2 * (lane & 3) + e;
        if (row < M && col < NG)
          out[(size_t)row * NG + col] = d[4 * n8 + 2 * h + e];
      }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes > (size_t)MAX_DYN_SMEM) return -1;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// P1. method 0: one block (the reference); 1: `blocks` blocks under a
// cooperative launch, a grid barrier an iteration; 2: n_launch launches of
// one iteration. x: 1 int32, out: 1 int32, scratch: 2 int32 (reset here).
extern "C" int bark_lp_while(int method, const int* x, int* out,
                             int* scratch, int blocks, int n_launch,
                             cudaStream_t stream) {
  if (method == 0) {
    while_block_kernel<<<1, 32, 0, stream>>>(x, out);
    return (int)cudaGetLastError();
  }
  if (method == 1) {
    if (blocks < 1) return -1;
    int err = (int)cudaMemsetAsync(scratch, 0, sizeof(int), stream);
    if (!err)
      err = (int)cudaMemsetAsync(scratch + 1, 0xff, sizeof(int), stream);
    if (err) return err;
    unsigned* count = reinterpret_cast<unsigned*>(scratch);
    int* stop = scratch + 1;
    void* args[] = {&x, &out, &count, &stop};
    return (int)cudaLaunchCooperativeKernel((const void*)while_grid_kernel,
                                            dim3(blocks), dim3(32), args, 0,
                                            stream);
  }
  if (method != 2 || n_launch < 0) return -1;
  int err = (int)cudaMemsetAsync(scratch, 0, sizeof(int), stream);
  if (!err) err = (int)cudaMemsetAsync(out, 0, sizeof(int), stream);
  if (err) return err;
  for (int i = 0; i < n_launch; ++i) {
    while_step_kernel<<<1, 1, 0, stream>>>(x, scratch, out);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// P2: v (n) f32; out = 2 argmax + 1; tok (may be null) = the argmax.
extern "C" int bark_lp_argmax(const float* v, int n, int* tok, int* out,
                              cudaStream_t stream) {
  if (n <= 0) return -1;
  argmax_kernel<<<1, ARG_THREADS, 0, stream>>>(v, n, tok, out);
  return (int)cudaGetLastError();
}

// P2b. method 0: one kernel; 1: P2's kernel writes the token to tok, a
// second kernel reads it. tbl: rows x row_bytes; out: row_bytes.
extern "C" int bark_lp_row(int method, const float* v, int n,
                           const void* tbl, int rows, int row_bytes,
                           int group, void* out, int* tok,
                           cudaStream_t stream) {
  if (n <= 0 || rows <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      group < 1 || method < 0 || method > 1)
    return -1;
  const size_t smem = (size_t)group * row_bytes;
  const auto* t = static_cast<const unsigned char*>(tbl);
  auto* o = static_cast<unsigned char*>(out);
  if (method == 0) {
    int err = set_smem((const void*)row_kernel<true>, smem);
    if (err) return err;
    row_kernel<true><<<1, ARG_THREADS, smem, stream>>>(v, n, nullptr, t, rows,
                                                       row_bytes, group, o);
    return (int)cudaGetLastError();
  }
  int err = set_smem((const void*)row_kernel<false>, smem);
  if (err) return err;
  argmax_kernel<<<1, ARG_THREADS, 0, stream>>>(v, n, tok, nullptr);
  err = (int)cudaGetLastError();
  if (err) return err;
  row_kernel<false><<<1, ARG_THREADS, smem, stream>>>(v, n, tok, t, rows,
                                                      row_bytes, group, o);
  return (int)cudaGetLastError();
}

// P3: g (n_rows, width) f32 -> out (width) f32. method 0: one block, a
// row at a time; 1: one block, the next row in flight; 2: strips.
extern "C" int bark_lp_rows_sum(const float* g, int n_rows, int width,
                                int method, float* out,
                                cudaStream_t stream) {
  if (n_rows < 0 || width <= 0 || width % 4 || width > ROWSUM_COLS * 1024 ||
      method < 0 || method > 2)
    return -1;
  if (method == 2) {
    const int groups = (n_rows + STRIP_ROWS - 1) / STRIP_ROWS;
    const size_t smem = (size_t)std::max(1, std::min(groups, STRIP_STAGES)) *
                        STRIP_ROWS * STRIP_COLS * 4;
    int err = set_smem((const void*)rows_sum_strips_kernel, smem);
    if (err) return err;
    rows_sum_strips_kernel<<<(width + STRIP_COLS - 1) / STRIP_COLS,
                             STRIP_COLS, smem, stream>>>(g, n_rows, width,
                                                         out);
    return (int)cudaGetLastError();
  }
  const size_t smem = 2 * (size_t)width * 4;
  const int threads = std::min(1024, (width + 31) / 32 * 32);
  const void* k = method == 1 ? (const void*)rows_sum_kernel<true>
                              : (const void*)rows_sum_kernel<false>;
  int err = set_smem(k, smem);
  if (err) return err;
  if (method == 1)
    rows_sum_kernel<true><<<1, threads, smem, stream>>>(g, n_rows, width, out);
  else
    rows_sum_kernel<false><<<1, threads, smem, stream>>>(g, n_rows, width, out);
  return (int)cudaGetLastError();
}

// P4: p (L, 16, W) f32 -> out (W). P5: x (8, W) f32 -> out (L, 8, W).
extern "C" int bark_lp_layers(int write, int unroll, const float* in, int L,
                              int W, float* out, cudaStream_t stream) {
  if (L < 1 || L > MAX_LAYERS || W <= 0 || W % LP_COLS) return -1;
  const size_t smem =
      (size_t)L * (write ? P5_ROWS : P4_ROWS) * LP_COLS * sizeof(float);
  const void* k =
      write ? (unroll ? (const void*)layer_write_kernel<true>
                      : (const void*)layer_write_kernel<false>)
            : (unroll ? (const void*)layer_read_kernel<true>
                      : (const void*)layer_read_kernel<false>);
  int err = set_smem(k, smem);
  if (err) return err;
  const int blocks = W / LP_COLS;
  if (write && unroll)
    layer_write_kernel<true><<<blocks, LP_COLS, smem, stream>>>(in, L, W, out);
  else if (write)
    layer_write_kernel<false><<<blocks, LP_COLS, smem, stream>>>(in, L, W, out);
  else if (unroll)
    layer_read_kernel<true><<<blocks, LP_COLS, smem, stream>>>(in, L, W, out);
  else
    layer_read_kernel<false><<<blocks, LP_COLS, smem, stream>>>(in, L, W, out);
  return (int)cudaGetLastError();
}

// P6: w (L, T, R, W) f32 (dtype 0) or bf16 (1); out (W) f32. blocks > 1
// is a cooperative launch (every block resident). scratch: 2 zeroed words
// (the barrier's counter, the ticket), left zeroed; partial: blocks x W.
extern "C" int bark_lp_ring(int dtype, const void* w, int L, int T, int R,
                            int W, int ring, int prefetch, int blocks,
                            unsigned* scratch, float* partial, float* out,
                            cudaStream_t stream) {
  const int item = dtype == BARK_BF16 ? 2 : 4;
  const size_t tile = (size_t)R * W * item;
  if ((dtype != BARK_F32 && dtype != BARK_BF16) || L < 1 || T < 1 ||
      R < 1 || W <= 0 || W > RING_COLS * RING_THREADS || ring < 1 ||
      ring > RING_MAX || blocks < 1 || tile % 16 || tile * ring > MAX_DYN_SMEM)
    return -1;
  Ring p{static_cast<const unsigned char*>(w), L, T, W, ring, prefetch,
         (unsigned)tile, scratch, partial, scratch + 1, out};
  const size_t smem = tile * ring;
  const void* k = dtype == BARK_BF16 ? (const void*)ring_kernel<bf16>
                                     : (const void*)ring_kernel<float>;
  int err = set_smem(k, smem);
  if (err) return err;
  if (blocks == 1) {
    if (dtype == BARK_BF16)
      ring_kernel<bf16><<<1, RING_THREADS, smem, stream>>>(p);
    else
      ring_kernel<float><<<1, RING_THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(k, dim3(blocks), dim3(RING_THREADS),
                                          args, smem, stream);
}

// P7, P8: rows of src (L or 1, B, rows, row_bytes; src_ls 0: one set of
// rows for every layer) into dst (L, B, S, row_bytes) at each lane's row
// (offs[b] // align) align (offs null: 0). method 0: bulk stores; 1: plain
// 16-byte stores; 2: the ring, on at most `blocks` blocks with `stages`
// stages of up to `stage_bytes` (whole rows, one at least), RING_STAMPS
// ns a block into `stamps` when it is not null. Strides in bytes; every
// address and size a multiple of 16.
extern "C" int bark_lp_row_write(int method, const void* src,
                                 long long src_ls, long long src_bs,
                                 void* dst, long long dst_ls,
                                 long long dst_bs, const int* offs, int L,
                                 int B, int rows, int row_bytes, int S,
                                 int align, int blocks, int stages,
                                 int stage_bytes, unsigned long long* stamps,
                                 cudaStream_t stream) {
  if (method < 0 || method > 2 || L < 1 || B < 1 || B > 65535 || rows < 1 ||
      row_bytes <= 0 || row_bytes % 16 || row_bytes > WRITE_SMEM ||
      rows > S || align < 1 || src_ls % 16 || src_bs % 16 || dst_ls % 16 ||
      dst_bs % 16 || (reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst)) % 16)
    return -1;
  if (method == 2) {
    if (blocks < 1 || stages < 2 || stages > WRING_MAX) return -1;
    const int stage_rows =
        std::max(1, std::min(rows, stage_bytes / row_bytes));
    const long long units = (long long)B * (src_ls == 0 ? 1 : L) * rows;
    RowWrite p{static_cast<const unsigned char*>(src), src_ls, src_bs,
               static_cast<unsigned char*>(dst), dst_ls, dst_bs, offs, L, B,
               rows, row_bytes, S, align, stage_rows, stages, stamps};
    const size_t smem = (size_t)stages * stage_rows * row_bytes;
    int err = set_smem((const void*)row_ring_kernel, smem);
    if (err) return err;
    row_ring_kernel<<<(int)std::min<long long>(blocks, units), 32, smem,
                      stream>>>(p);
    return (int)cudaGetLastError();
  }
  const int per_lane = std::max(1, (TARGET_BLOCKS + B - 1) / B);
  const int chunk = std::max(
      1, std::min({(rows + per_lane - 1) / per_lane, rows,
                   WRITE_SMEM / row_bytes}));
  RowWrite p{static_cast<const unsigned char*>(src), src_ls, src_bs,
             static_cast<unsigned char*>(dst), dst_ls, dst_bs, offs, L, B,
             rows, row_bytes, S, align, chunk, 0, nullptr};
  const dim3 grid((rows + chunk - 1) / chunk, B);
  if (method == 0) {
    const size_t smem = (size_t)chunk * row_bytes;
    int err = set_smem((const void*)row_write_kernel<true>, smem);
    if (err) return err;
    row_write_kernel<true><<<grid, WRITE_THREADS, smem, stream>>>(p);
  } else {
    row_write_kernel<false><<<grid, WRITE_THREADS, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// P9: x (M, K), w (NG, K) (g slots of N rows), out (M, NG) f32.
// method 0: simt, dtype f32 (0) or bf16 (1); 1: wgmma, bf16, M <= 64,
// K % 16 == 0.
extern "C" int bark_lp_group_dot(int method, int dtype, const void* x,
                                 const void* w, int M, int NG, int K,
                                 float* out, cudaStream_t stream) {
  if (M < 1 || NG < 1 || K < 1 || (dtype != BARK_F32 && dtype != BARK_BF16))
    return -1;
  if (method == 0) {
    const size_t smem = (size_t)M * K * (dtype == BARK_BF16 ? 2 : 4);
    const int blocks = (NG + DOT_WARPS - 1) / DOT_WARPS;
    if (dtype == BARK_BF16) {
      int err = set_smem((const void*)group_dot_simt_kernel<bf16>, smem);
      if (err) return err;
      group_dot_simt_kernel<bf16><<<blocks, DOT_WARPS * 32, smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w), M, NG, K,
          out);
    } else {
      int err = set_smem((const void*)group_dot_simt_kernel<float>, smem);
      if (err) return err;
      group_dot_simt_kernel<float><<<blocks, DOT_WARPS * 32, smem, stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(w), M, NG,
          K, out);
    }
    return (int)cudaGetLastError();
  }
  if (method != 1 || dtype != BARK_BF16 || M > 64 || K % 16 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return -1;
  const size_t smem = (size_t)(64 + WG_N) * K * 2;
  int err = set_smem((const void*)group_dot_wgmma_kernel, smem);
  if (err) return err;
  group_dot_wgmma_kernel<<<(NG + WG_N - 1) / WG_N, 128, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), M, NG, K,
      out);
  return (int)cudaGetLastError();
}
