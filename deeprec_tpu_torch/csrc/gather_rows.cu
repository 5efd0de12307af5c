// K1: embedding row gather, out[i, :] = values[clamp(slots[i], 0, R-1), :d].
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/pallas_gather.py
// gather_rows (_gather_kernel), which streams rows through a queue of
// async HBM->VMEM copies in 128-lane groups. The TPU kernel's lane
// grouping, one-hot select and R % (128/D) rule are gone: any width, any
// row count, any row stride.
//
// What bounds it on Hopper: at the large shapes (106,496-205,825 rows of
// 64 bytes) HBM bytes, the rows read and written (the slots are a few
// percent of that); at the small ones (5,195-53,248 rows) the launch and
// one round trip of two dependent loads (the slot, then its row). The
// design, for both:
// - A sub-warp of `lanes` threads (a power of two, at least the row's
//   vector units, at most 32) copies a row, neighbouring threads on
//   neighbouring 16-byte (or the widest the alignment allows) units. Each
//   sub-warp takes kRows rows of a warp tile of 32/lanes * kRows
//   consecutive rows. The warp loads the tile's slots 32 to a coalesced
//   load, clamps them and hands them out by __shfl_sync; each thread then
//   issues the loads of all its kRows rows before its first store. So a
//   thread has kRows independent row loads in flight, and the slot round
//   trip is paid once a tile.
// - The grid is at most one full wave of resident blocks (the SM count and
//   the kernel's occupancy, taken once a device) and blocks stride over
//   the tiles, so a large n has no tail wave. kRows (1, 2 or 4) is the
//   least that gives the card's resident threads one row each: a small n
//   keeps one row a thread and spreads over every SM, a large one takes
//   more rows a thread.
// - A programmatic dependent launch (launch.cuh): the blocks may be
//   scheduled while the work queued before is finishing, wait for it
//   before the first read of slots or values (out may be a block the
//   allocator just reused), and let the kernel queued after (K2's forward
//   on the serving and host-index training paths, itself a dependent)
//   schedule its blocks as soon as they have issued their first row loads.
// - Index arithmetic inside a tile is 32-bit with shifts; the row offset
//   slot * ld stays 64-bit, as a table may pass 2^31 bytes.
// One 16-byte unit a thread behind its own slot load, on a grid of
// n * lanes / 256 blocks with an ordinary launch, measured slower on the
// card at every shape the paths give it.
//
// The copy is dtype-agnostic: the wrapper (ops/gather.py) passes row sizes
// and strides in bytes and picks the vector unit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {
namespace k1 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

template <typename I>
__device__ __forceinline__ int64_t clamp_slot(I s, int64_t n_rows) {
  const int64_t v = (int64_t)s;
  return v < 0 ? 0 : (v >= n_rows ? n_rows - 1 : v);
}

// U: the vector unit (uint4, uint2, uint32_t, uint16_t or uint8_t); ld and
// row_units in units of U. lanes_log2: log2 of the threads a row.
template <typename U, typename I, int kRows>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const U* __restrict__ values, int64_t ld, int64_t n_rows,
    const I* __restrict__ slots, int64_t n, int row_units,
    U* __restrict__ out, int lanes_log2) {
  wait_for_prerequisite();  // every thread, before any access to memory
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lanes_log2;
  const int sub = lane >> lanes_log2;  // this thread's sub-warp
  const int col = lane & (lanes - 1);  // its first unit of a row
  const int g_log2 = 5 - lanes_log2;   // log2 of the sub-warps of a warp
  int tile_log2 = g_log2;              // log2 of the rows of a warp tile
  for (int r = kRows; r > 1; r >>= 1) ++tile_log2;
  const int64_t step = ((int64_t)gridDim.x * kWarps) << tile_log2;
  int64_t t0 = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5))
               << tile_log2;
  for (bool first = true; t0 < n; t0 += step, first = false) {  // per warp
    const int left = n - t0 < (1 << tile_log2) ? (int)(n - t0)
                                               : 1 << tile_log2;
    // the tile's slots, 32 a load: row j's in lane j & 31, register j >> 5
    // (clamped, a slot still fits its type)
    I s[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int j = (k << 5) + lane;
      s[k] = j < left ? (I)clamp_slot(slots[t0 + j], n_rows) : (I)0;
    }
    // this thread's rows: row r of the sub-warp is j = r * 32/lanes + sub,
    // written at dst + r * dst_step (+ its unit)
    const U* src[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int k = (r << g_log2) >> 5;  // the same for the whole warp
      I v = s[0];
#pragma unroll
      for (int q = 1; q < kRows; ++q) v = q == k ? s[q] : v;
      v = __shfl_sync(0xffffffffu, v, ((r << g_log2) + sub) & 31);
      src[r] = values + (int64_t)v * ld;
    }
    U* dst = out + (t0 + sub) * row_units;
    const int dst_step = row_units << g_log2;
    if (first && col >= row_units) launch_dependents();  // no unit to copy
    for (int c = col; c < row_units; c += lanes) {
      U x[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if ((r << g_log2) + sub < left) x[r] = __ldg(src[r] + c);
      if (first && c == col) launch_dependents();
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if ((r << g_log2) + sub < left) dst[r * dst_step + c] = x[r];
    }
  }
}

// The card's SM count and resident threads an SM, taken once a device.
struct Card {
  int sms, threads_per_sm;
};

Card card() {
  static Card cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return {};
  Card& c = cached[dev];
  if (c.sms == 0) {
    cudaDeviceGetAttribute(&c.threads_per_sm,
                           cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return c;
}

// Resident blocks of one instantiation on one SM (the same on every SM of
// a card; the cards of one process are taken to be of one kind).
template <typename U, typename I, int kRows>
int resident_blocks() {
  static int cached = 0;
  if (cached == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, gather_rows_kernel<U, I, kRows>, kThreads, 0);
  return cached;
}

// Blocks at kRows rows a thread: one per kWarps warp tiles, at most one
// full wave of resident blocks (the blocks then stride over the tiles).
template <typename U, typename I, int kRows>
int64_t grid_blocks(int64_t n, int g_log2) {
  const int64_t tile = (int64_t)kRows << g_log2;
  const int64_t blocks = ((n + tile - 1) / tile + kWarps - 1) / kWarps;
  const int64_t wave = (int64_t)card().sms * resident_blocks<U, I, kRows>();
  return wave > 0 && blocks > wave ? wave : blocks;
}

struct Plan {
  int lanes_log2;
  int rows;  // kRows
  int64_t blocks;
};

// kRows: the fewest of 1, 2 and 4 that give the card's resident threads at
// most one row each (n * lanes / kRows of them), else 4. More rows a
// thread cost registers, so resident threads, and lost at every shape
// measured (8: PERF.md).
template <typename U, typename I>
Plan plan_for(int64_t n, int64_t row_units) {
  Plan p;
  p.lanes_log2 = 0;
  while (p.lanes_log2 < 5 && (1 << p.lanes_log2) < row_units) ++p.lanes_log2;
  const int g_log2 = 5 - p.lanes_log2;
  const Card c = card();
  const int64_t threads = (int64_t)c.sms * c.threads_per_sm;
  const int64_t rows = n << p.lanes_log2;  // thread-rows at one a thread
  p.rows = rows <= threads ? 1 : rows <= 2 * threads ? 2 : 4;
  p.blocks = p.rows == 1   ? grid_blocks<U, I, 1>(n, g_log2)
             : p.rows == 2 ? grid_blocks<U, I, 2>(n, g_log2)
                           : grid_blocks<U, I, 4>(n, g_log2);
  return p;
}

template <typename U, typename I>
cudaError_t launch(const void* values, int64_t ld_bytes, int64_t n_rows,
                   const void* slots, int64_t n, int64_t row_bytes, void* out,
                   cudaStream_t stream) {
  const int64_t row_units = row_bytes / (int64_t)sizeof(U);
  const int64_t ld = ld_bytes / (int64_t)sizeof(U);
  const Plan p = plan_for<U, I>(n, row_units);
  const auto kernel = p.rows == 1   ? gather_rows_kernel<U, I, 1>
                      : p.rows == 2 ? gather_rows_kernel<U, I, 2>
                                    : gather_rows_kernel<U, I, 4>;
  return launch_dependent(kernel, p.blocks, kThreads, stream,
                          (const U*)values, ld, n_rows, (const I*)slots, n,
                          (int)row_units, (U*)out, p.lanes_log2);
}

template <typename U>
cudaError_t launch_unit(const void* values, int64_t ld_bytes, int64_t n_rows,
                        const void* slots, int slots_are_64, int64_t n,
                        int64_t row_bytes, void* out, cudaStream_t stream) {
  return slots_are_64
             ? launch<U, int64_t>(values, ld_bytes, n_rows, slots, n,
                                  row_bytes, out, stream)
             : launch<U, int32_t>(values, ld_bytes, n_rows, slots, n,
                                  row_bytes, out, stream);
}

}  // namespace k1
}  // namespace

// unit: bytes per vector load (16, 8, 4, 2 or 1); it divides row_bytes,
// ld_bytes and both base addresses (the wrapper checks). Returns the
// launch's cudaError_t; 0 is success. Launches on `stream`, never syncs.
extern "C" int deeprec_gather_rows(const void* values, int64_t ld_bytes,
                                   int64_t n_rows, const void* slots,
                                   int slots_are_64, int64_t n,
                                   int64_t row_bytes, void* out, int unit,
                                   void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit) {
    case 16: return k1::launch_unit<uint4>(values, ld_bytes, n_rows, slots,
                                           slots_are_64, n, row_bytes, out,
                                           st);
    case 8: return k1::launch_unit<uint2>(values, ld_bytes, n_rows, slots,
                                          slots_are_64, n, row_bytes, out, st);
    case 4: return k1::launch_unit<uint32_t>(values, ld_bytes, n_rows, slots,
                                             slots_are_64, n, row_bytes, out,
                                             st);
    case 2: return k1::launch_unit<uint16_t>(values, ld_bytes, n_rows, slots,
                                             slots_are_64, n, row_bytes, out,
                                             st);
    case 1: return k1::launch_unit<uint8_t>(values, ld_bytes, n_rows, slots,
                                            slots_are_64, n, row_bytes, out,
                                            st);
    default: return (int)cudaErrorInvalidValue;
  }
}
