// K2: fused gather + pool, forward and backward (the backward is below the
// forward kernels). For each bag b,
//   out[b, :] = scale(n_b) * sum over k with valid[b, k] of
//               values[clamp(slots[b, k], 0, R-1), :D]
// with scale 1 (sum), 1/max(n,1) (mean) or 1/sqrt(max(n,1)) (sqrtn), n_b
// the bag's valid count; an all-invalid bag gives 0.
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/pallas_fused_lookup.py
// fused_pooled_lookup (_fused_kernel), which streams each example's rows
// through a DMA queue into a VMEM accumulator. Like it, this kernel never
// writes the [B*w, D] expanded rows: the pooled [B, D] is the only write.
// It is bound by HBM bytes (slots and flags read, valid rows read, pooled
// rows written); at the Criteo shapes ([26*4096, 1], D 16) the pooled
// write is 6.8 of the 8.8 MB. No D % 128 rule, no chunk padding; slots and
// valid may be strided views (the serving path passes
// inverse.view(W, B)[o:o+w].T without a copy).
//
// Design: one warp per tile of consecutive bags, so the index loads are
// shared. Each lane loads one (bag, lane) slot and its flag of the tile,
// both at once, never a branch on the flag before the slot's load; the
// flags become a warp ballot and the slots reach the row readers by
// __shfl_sync, so one index round trip serves the whole tile. The tile's
// output is contiguous, and lane l computes its vector units u = l, l+32,
// ... (bag u / dv, column u % dv, in units of V), so every store
// instruction writes 32 consecutive vectors (512 bytes in float4).
// - w == 1 (the Criteo columns, one id a bag): a tile is 32 bags, and
//   every combiner is the row itself or 0 (a valid count of 0 or 1 divides
//   by 1). A lane issues kFwdLoads row loads before it stores any of them:
//   at D 16 a lane holds 4 float4 of 4 bags in flight.
// - w > 1 (multi-hot): a tile is 32 / w bags (one when w > 32, whose ids
//   are then loaded 32 at a time); the lane of unit (q, c) walks the bag's
//   ids, kFwdLoads row loads in flight, and adds the valid ones in id order
//   in f32. Its scale comes from the ballot's popcount; sum has no scale
//   code (a template flag).
// bf16 rows (a bfloat16 table): the vector unit is 8 bf16 (16 bytes, one
// uint4 load) where D and the row stride allow it, else one bf16. The
// w == 1 path copies the row's bits, as any combiner of one row is the row.
// The multi-hot path widens each row to f32, adds and scales in f32, and
// rounds once (to nearest even) when it writes the bag: as the plain
// version (torch's CPU bf16 sum accumulates in f32) and the JAX package's
// XLA path do. The Pallas kernel accumulates in the table's dtype
// (pallas_fused_lookup.py:72); this kernel does not copy that.
// What bounds it at the Criteo shapes is not the index round trips but
// their order: the rows must arrive (two dependent loads, ~0.9 us) before
// the 6.8 MB write (~1.7 us) can start, and a launch costs ~2 us more back
// to back (measured on an H100 80GB HBM3 at 700 W). So both kernels are
// launched as programmatic dependents of the work before them
// (griddepcontrol): their blocks are scheduled while that work finishes,
// and each waits for it before its first access to memory (out may be a
// block the allocator just reused).

#include <cooperative_groups.h>
#include <cub/block/block_scan.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdThreads = 256;
constexpr int kFwdLoads = 4;  // row loads in flight per lane

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 div4(float4 a, float d) {
  return make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}
__device__ __forceinline__ float add_(float a, float b) { return a + b; }
__device__ __forceinline__ float div_(float a, float d) { return a / d; }
__device__ __forceinline__ float4 add_(float4 a, float4 b) { return add4(a, b); }
__device__ __forceinline__ float4 div_(float4 a, float d) { return div4(a, d); }

template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// bf16 <-> f32: a bf16 is the high half of an f32, so widening is a shift;
// narrowing rounds to nearest even.
using bf16x1 = unsigned short;  // one bf16's bits
__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf_pack(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
}
template <> __device__ __forceinline__ bf16x1 zero<bf16x1>() { return 0; }
template <> __device__ __forceinline__ uint4 zero<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

struct float8 {  // the f32 sums of 8 bf16 lanes
  float4 a, b;
};
template <> __device__ __forceinline__ float8 zero<float8>() {
  return {zero<float4>(), zero<float4>()};
}
__device__ __forceinline__ float8 add_(float8 x, float8 y) {
  return {add4(x.a, y.a), add4(x.b, y.b)};
}
__device__ __forceinline__ float8 div_(float8 x, float d) {
  return {div4(x.a, d), div4(x.b, d)};
}

// The accumulator of a vector unit V read from the table: V itself for
// f32, f32 lanes for bf16 (up widens, down rounds).
template <typename V> struct Acc {
  using T = V;
  static __device__ __forceinline__ T up(V v) { return v; }
  static __device__ __forceinline__ V down(T a) { return a; }
};
template <> struct Acc<bf16x1> {
  using T = float;
  static __device__ __forceinline__ T up(bf16x1 v) { return bf_lo(v); }
  static __device__ __forceinline__ bf16x1 down(T a) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(a));
  }
};
template <> struct Acc<uint4> {  // 8 bf16
  using T = float8;
  static __device__ __forceinline__ T up(uint4 v) {
    return {make_float4(bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y)),
            make_float4(bf_lo(v.z), bf_hi(v.z), bf_lo(v.w), bf_hi(v.w))};
  }
  static __device__ __forceinline__ uint4 down(T a) {
    return make_uint4(bf_pack(a.a.x, a.a.y), bf_pack(a.a.z, a.a.w),
                      bf_pack(a.b.x, a.b.y), bf_pack(a.b.z, a.b.w));
  }
};

__device__ __forceinline__ int64_t clamp_row(int64_t s, int64_t n_rows) {
  return s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s);
}

// Unit u of a tile's output: bag u / dv, column u % dv (a shift and a mask
// when dv is a power of two, dv_shift >= 0).
__device__ __forceinline__ int unit_bag(int u, int dv, int dv_shift) {
  return dv_shift >= 0 ? u >> dv_shift : u / dv;
}

// w == 1. V: float or float4 (f32 rows), bf16x1 or uint4 (bf16 rows: 1 or
// 8 lanes), the vector unit; ld and dv are in units of V. Every combiner
// gives valid ? row : 0, a copy of the row's bits.
template <typename V, typename I>
__global__ void __launch_bounds__(kFwdThreads) pooled_lookup_w1_kernel(
    const V* __restrict__ values, int64_t ld, int64_t n_rows, int dv,
    int dv_shift, const I* __restrict__ slots, int64_t s_b,
    const bool* __restrict__ valid, int64_t v_b, int64_t n_bags,
    V* __restrict__ out) {
  launch_dependents();
  wait_for_prerequisite();  // before any access: out may be reused memory
  const int lane = threadIdx.x & 31;
  const int64_t b0 = (int64_t)blockIdx.x * kFwdThreads + threadIdx.x - lane;
  if (b0 >= n_bags) return;  // the whole warp: its tile starts past the end
  const int64_t b = b0 + lane;
  bool ok = false;
  int64_t row = 0;
  if (b < n_bags) {  // the flag and the slot in one round trip
    ok = valid[b * v_b];
    row = (int64_t)slots[b * s_b];
  }
  row = clamp_row(row, n_rows);
  const unsigned oks = __ballot_sync(kFull, ok);
  const int nb = n_bags - b0 < 32 ? (int)(n_bags - b0) : 32;
  const int units = nb * dv;
  V* tile_out = out + b0 * dv;
  for (int base = 0; base < units; base += 32 * kFwdLoads) {  // warp-uniform
    V x[kFwdLoads];
#pragma unroll
    for (int j = 0; j < kFwdLoads; ++j) {
      const int u = base + 32 * j + lane;
      const int q = unit_bag(u, dv, dv_shift) & 31;  // past the end: unused
      const int64_t r = __shfl_sync(kFull, row, q);
      x[j] = u < units && (oks >> q & 1u)
                 ? __ldg(values + r * ld + (u - q * dv)) : zero<V>();
    }
#pragma unroll
    for (int j = 0; j < kFwdLoads; ++j) {
      const int u = base + 32 * j + lane;
      if (u < units) tile_out[u] = x[j];
    }
  }
}

// w > 1 (or any w). kComb: 0 sum, 1 mean, 2 sqrtn. V as above; the sums
// and the scale are in Acc<V>::T (f32 lanes).
template <typename V, typename I, int kComb>
__global__ void __launch_bounds__(kFwdThreads) pooled_lookup_kernel(
    const V* __restrict__ values, int64_t ld, int64_t n_rows, int dv,
    int dv_shift, const I* __restrict__ slots, int64_t s_b, int64_t s_k,
    const bool* __restrict__ valid, int64_t v_b, int64_t v_k, int64_t n_bags,
    int64_t w, V* __restrict__ out) {
  launch_dependents();
  wait_for_prerequisite();
  const int lane = threadIdx.x & 31;
  const int per = w < 32 ? (int)w : 32;  // ids of a bag in one load
  const int tile = 32 / per;             // bags of a tile
  const int64_t b0 =
      ((int64_t)blockIdx.x * kFwdThreads + threadIdx.x) / 32 * tile;
  if (b0 >= n_bags) return;  // the whole warp
  const int nb = n_bags - b0 < tile ? (int)(n_bags - b0) : tile;
  // this lane's id of a load: bag b0 + id_bag, id k0 + id_k
  const int id_bag = lane / per, id_k = lane - id_bag * per;
  bool ok = false;
  int64_t row = 0;
  unsigned oks = 0u;
  auto load_ids = [&](int64_t k0) {  // every lane of the warp calls
    ok = false;
    row = 0;
    if (id_bag < nb && k0 + id_k < w) {
      const int64_t bb = b0 + id_bag, k = k0 + id_k;
      ok = valid[bb * v_b + k * v_k];
      row = (int64_t)slots[bb * s_b + k * s_k];
    }
    row = clamp_row(row, n_rows);
    oks = __ballot_sync(kFull, ok);
  };
  if (w <= 32) load_ids(0);  // the tile's ids, once
  const int units = nb * dv;
  V* tile_out = out + b0 * dv;
  for (int base = 0; base < units; base += 32) {  // warp-uniform
    const int u = base + lane;
    const bool live = u < units;
    const int q = live ? unit_bag(u, dv, dv_shift) : 0;
    const int c = u - q * dv;
    typename Acc<V>::T acc = zero<typename Acc<V>::T>();
    int n = 0;
    for (int64_t k0 = 0; k0 < w; k0 += 32) {  // one pass unless w > 32
      if (w > 32) load_ids(k0);
      const int kn = w - k0 < per ? (int)(w - k0) : per;
      const unsigned bag_oks =
          per == 32 ? oks : oks >> (q * per) & ((1u << per) - 1u);
      n += __popc(bag_oks);
      for (int k = 0; k < kn; k += kFwdLoads) {  // warp-uniform
        V x[kFwdLoads];
#pragma unroll
        for (int j = 0; j < kFwdLoads; ++j) {
          const int kk = k + j;
          const int64_t r = __shfl_sync(kFull, row, (q * per + kk) & 31);
          x[j] = live && kk < kn && (bag_oks >> kk & 1u)
                     ? __ldg(values + r * ld + c) : zero<V>();
        }
#pragma unroll
        for (int j = 0; j < kFwdLoads; ++j)  // in id order, as the plain sum
          if (k + j < kn && (bag_oks >> (k + j) & 1u))
            acc = add_(acc, Acc<V>::up(x[j]));
      }
    }
    if (kComb != 0) {
      const float m = (float)(n > 1 ? n : 1);
      acc = div_(acc, kComb == 1 ? m : sqrtf(m));
    }
    if (live) tile_out[u] = Acc<V>::down(acc);
  }
}


template <typename V, typename I>
cudaError_t launch_fwd(const V* values, int64_t ld, int64_t n_rows, int64_t d,
                       const I* slots, int64_t s_b, int64_t s_k,
                       const bool* valid, int64_t v_b, int64_t v_k,
                       int64_t n_bags, int64_t w, int combiner, V* out,
                       cudaStream_t stream) {
  const int dv = (int)d;  // in units of V
  int dv_shift = -1;
  if ((dv & (dv - 1)) == 0)
    for (dv_shift = 0; (1 << dv_shift) < dv; ++dv_shift) {}
  if (w == 1)  // one warp per 32 bags
    return launch_dependent(pooled_lookup_w1_kernel<V, I>,
                            (n_bags + kFwdThreads - 1) / kFwdThreads,
                            kFwdThreads, stream, values, ld, n_rows, dv,
                            dv_shift, slots, s_b, valid, v_b, n_bags, out);
  const int64_t tile = w < 32 ? 32 / w : 1;  // bags of a warp
  const int64_t warps = (n_bags + tile - 1) / tile;
  const int64_t blocks = (warps * 32 + kFwdThreads - 1) / kFwdThreads;
  const auto kernel = combiner == 1   ? pooled_lookup_kernel<V, I, 1>
                      : combiner == 2 ? pooled_lookup_kernel<V, I, 2>
                                      : pooled_lookup_kernel<V, I, 0>;
  return launch_dependent(kernel, blocks, kFwdThreads, stream, values, ld,
                          n_rows, dv, dv_shift, slots, s_b, s_k, valid, v_b,
                          v_k, n_bags, w, out);
}

template <typename V>
cudaError_t launch(const void* values, int64_t ld, int64_t n_rows, int64_t d,
                   const void* slots, int slots_are_64, int64_t s_b,
                   int64_t s_k, const void* valid, int64_t v_b, int64_t v_k,
                   int64_t n_bags, int64_t w, int combiner, void* out,
                   cudaStream_t stream) {
  if (slots_are_64)
    return launch_fwd((const V*)values, ld, n_rows, d, (const int64_t*)slots,
                      s_b, s_k, (const bool*)valid, v_b, v_k, n_bags, w,
                      combiner, (V*)out, stream);
  return launch_fwd((const V*)values, ld, n_rows, d, (const int32_t*)slots,
                    s_b, s_k, (const bool*)valid, v_b, v_k, n_bags, w,
                    combiner, (V*)out, stream);
}

// K2 backward: the pooling's gradient with respect to values,
//   d_values[r, :] = sum over the valid lanes (b, k) with
//                    clamp(slots[b, k], 0, R-1) == r of d_pooled[b, :] / scale_b
// scale_b = 1 (sum), max(n_b,1) (mean) or sqrt(max(n_b,1)) (sqrtn); a row
// that no valid lane touches gets 0. The Pallas TPU kernel has no backward
// (its caller differentiated the XLA gather, whose transpose XLA sums in a
// fixed order); this is the port's own. Bound by HBM bytes: the gradient
// rows of the bags that hold a valid lane, the slots and flags, the [R, D]
// output written once.
//
// Design: the result is a function of the inputs alone, so two runs of one
// training stream stay bit-equal. No float atomics: each row is summed in
// an order fixed by its lanes and written once (zeros too), with no fill
// before. Two launches, as the atomic design's fill + adds: the ordering
// (order_kernel), one cooperative launch on at most the blocks the card
// holds at once, parted by grid barriers, and the rows (rows_kernel) as
// its programmatic dependent. The ordering is a counting sort on the whole
// row, placed with integer atomics (exact in any order); only where a lane
// lands inside its row's segment depends on scheduling, and the rows
// kernel restores lane order before it adds:
//  1. Each row's count is cleared; each bag gets its scale (mean, sqrtn).
//  2. Each valid lane (b, k), at position t = b*w + k (the plain version's
//     lane order), adds one to its row's count. A warp's lanes of one row
//     (__match_any_sync) add their number with one atomic: Criteo's hot row
//     (~1,400 of a batch's 106,496 ids, all in one column's 4,096 lanes)
//     costs ~128 atomics, not 1,400.
//  3. Each touched row claims its segment [lo, lo + count) of the lanes
//     with an atomic add on one total, a warp's rows at once. Where a
//     segment lies changes no sum, so no scan over the rows is needed.
//     A row of more than kExact lanes is listed (medium up to kWarpLanes,
//     long beyond).
//  4. Each valid lane writes t into its row's segment at a position taken
//     with an atomic add on the row's cursor, a warp's lanes of a row at
//     once; the cursor ends at the segment's end. A thread keeps the row
//     of its first lane from step 2, so wherever the grid has a thread a
//     lane, a lane's slot and flag are read once.
//  5. (rows_kernel) A block takes 64 rows, 4 threads a row, and sums the
//     rows of at most kExact lanes: the 4 threads rank the row's lanes
//     (each compares its four with all the row's) and one thread per vector
//     column adds them in lane order: the order of the plain version,
//     whose index_add_ adds in index order, so the sums are bit-equal to
//     it. The listed rows go to blocks of their own at the front of the
//     grid, so the longest chains start first and a block of rows never
//     takes several long rows one after another: a medium row to a warp
//     (8 to a block), which ranks its lanes in shared memory; a long row to a
//     block, which sorts them through a bitmap (set bits in order are the
//     lanes in order; windows of kMapWords * 32 lane indices from the
//     row's smallest lane, empty windows skipped), kept in shared memory
//     up to kBlockLanes lanes and in the scratch beyond. Then 32 or 256
//     threads each sum a contiguous run of the sorted lanes in order, and
//     the runs' sums are added in run order (a warp's through shared
//     memory, one lane a vector; then the 8 warps' sums). A row of at most
//     32 lanes thus still adds in lane order; a longer one adds in a tree
//     that its lane count fixes (tests/torch_k2_order.py states that
//     order and tree in plain PyTorch, and the card tests hold this
//     kernel bit-equal to it on every row).
// Steps 1-4 cross three grid barriers, every lane-parallel step has a
// thread a lane (blocks of 1,024 threads, at least one an SM), and no pass
// depends on R's bits. A bf16 gradient is widened to f32 as it is loaded,
// and each row's f32 sum is rounded once to bf16 as it is written.
constexpr int kBwdThreads = 256;  // the rows kernel's block
constexpr int kWarps = kBwdThreads / 32;
constexpr int kOrderThreads = 1024;  // the ordering's block: a lane a thread
constexpr int kOrderWarps = kOrderThreads / 32;
static_assert(kOrderWarps <= 32, "one warp scans the block's warps");
constexpr int kRowLanes = 4;    // a short row's threads
constexpr int kBlockRows = kBwdThreads / kRowLanes;
constexpr int kExact = 16;      // short rows: at most this many lanes
constexpr int kWarpLanes = 128;  // medium rows (a warp): at most this many
constexpr int kHold = 8;        // a long row's lanes a thread keeps
constexpr int kBlockLanes = kHold * kBwdThreads;  // sorted in shared memory
constexpr int kMapWords = 4096;  // a long row's bitmap: 131,072 lanes a window
constexpr int kDepth = 8;       // short rows: gradient loads in flight a lane
constexpr int kChunk = 4;       // runs: vectors of a row a thread holds
constexpr int kRunDepth = 2;    // runs: lanes in flight a thread
constexpr int kRowHeld = kExact / kRowLanes;  // a short row's lanes a thread
static_assert(kExact % kRowLanes == 0 && 32 % kRowLanes == 0,
              "a short row: whole lanes a thread, whole rows a warp");
static_assert(kWarpLanes == 4 * 32, "a warp's row: four lanes a thread");

__device__ __forceinline__ float2 add_(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 div_(float2 a, float d) {
  return make_float2(a.x / d, a.y / d);
}
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}

// The gradient's vector of a vector unit V of f32 sums (float4, float2 or
// float) and its output vector: V itself for f32, as many bf16 lanes
// (uint2: 4, unsigned: 2, bf16x1: 1) for bf16; `up` widens, `down` rounds
// to nearest even.
template <typename V, bool kBf16> struct Lanes {
  using G = V;
  static __device__ __forceinline__ V up(G v) { return v; }
  static __device__ __forceinline__ G down(V v) { return v; }
};
template <> struct Lanes<float4, true> {
  using G = uint2;
  static __device__ __forceinline__ float4 up(G v) {
    return make_float4(bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y));
  }
  static __device__ __forceinline__ G down(float4 v) {
    return make_uint2(bf_pack(v.x, v.y), bf_pack(v.z, v.w));
  }
};
template <> struct Lanes<float2, true> {
  using G = unsigned;
  static __device__ __forceinline__ float2 up(G v) {
    return make_float2(bf_lo(v), bf_hi(v));
  }
  static __device__ __forceinline__ G down(float2 v) {
    return bf_pack(v.x, v.y);
  }
};
template <> struct Lanes<float, true> {
  using G = bf16x1;
  static __device__ __forceinline__ float up(G v) { return bf_lo(v); }
  static __device__ __forceinline__ G down(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// The ordering's arrays: the inputs and the scratch the wrapper allocates.
// Scratch written during the launch is read with __ldcg (L2), never
// through the read-only cache.
struct OrderArgs {
  const void* slots;
  int slots_are_64;
  int64_t s_b, s_k;
  const bool* valid;
  int64_t v_b, v_k, n_bags, w, n_rows;
  int combiner;
  int2* rows;     // [n_rows]: x the row's valid lanes, y its segment's cursor
  int* lanes;     // [n]: each row's lanes in its segment, in no set order
  int* sorted;    // [n]: the lanes of a row longer than kBlockLanes, sorted
  float* scales;  // [n_bags]
  int4* mids;     // {row, lo, count, 0} of kExact < count <= kWarpLanes
  int4* longs;    // ... of more than kWarpLanes lanes
  int* counters;  // [3]: lanes claimed so far, mids and longs listed
  int64_t n;
};

// Lane t's row, or -1 where the lane is not valid (the flag and the slot
// loaded at once).
template <typename I>
__device__ __forceinline__ int lane_row(const OrderArgs& a, int64_t t) {
  const I* slots = (const I*)a.slots;
  const int64_t b = a.w == 1 ? t : t / a.w, k = t - b * a.w;
  const bool ok = a.valid[b * a.v_b + k * a.v_k];
  const int64_t s = (int64_t)slots[b * a.s_b + k * a.s_k];
  return ok ? (int)clamp_row(s, a.n_rows) : -1;
}

// Lane t's row as lane_row gives it, or -1 past the last lane.
__device__ __forceinline__ int any_lane_row(const OrderArgs& a, int64_t t) {
  if (t >= a.n) return -1;
  return a.slots_are_64 ? lane_row<int64_t>(a, t) : lane_row<int32_t>(a, t);
}

// Steps 2 (kPlace false) and 4 for lane t of row `row`; every lane of the
// warp calls. A warp's lanes of one row share one atomic; their positions
// follow their lane order.
template <bool kPlace>
__device__ __forceinline__ void lane_step(const OrderArgs& a, int64_t t,
                                          int row, int lane) {
  const unsigned peers = __match_any_sync(kFull, row);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (row >= 0 && lane == leader) {
    if (kPlace)
      base = atomicAdd(&a.rows[row].y, __popc(peers));
    else
      atomicAdd(&a.rows[row].x, __popc(peers));
  }
  if (!kPlace) return;
  base = __shfl_sync(kFull, base, leader) +
         __popc(peers & ((1u << lane) - 1u));
  if (row >= 0) a.lanes[base] = (int)t;
}

// Steps 1-4 in one cooperative launch, grid barriers between them.
__global__ void __launch_bounds__(kOrderThreads) order_kernel(
    const OrderArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kOrderThreads;
  const int64_t warp =
      ((int64_t)blockIdx.x * kOrderThreads + threadIdx.x) / 32;
  // 1. counts cleared, scales
  const int64_t n1 = a.combiner != 0 && a.n_bags > a.n_rows ? a.n_bags
                                                            : a.n_rows;
  for (int64_t t = (int64_t)blockIdx.x * kOrderThreads + threadIdx.x; t < n1;
       t += stride) {
    if (t < a.n_rows) a.rows[t] = make_int2(0, 0);
    if (a.combiner != 0 && t < a.n_bags) {
      int n = 0;
      for (int64_t j = 0; j < a.w; ++j) n += a.valid[t * a.v_b + j * a.v_k];
      const float m = (float)(n > 1 ? n : 1);
      a.scales[t] = a.combiner == 1 ? m : sqrtf(m);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 3) a.counters[threadIdx.x] = 0;
  grid.sync();
  // 2. counts (whole warps: the loop's bound is a warp's first lane); a
  // thread keeps its first lane's row for step 4
  int kept = -1;
  for (int64_t t0 = warp * 32; t0 < a.n; t0 += stride) {
    const int row = any_lane_row(a, t0 + lane);
    if (t0 == warp * 32) kept = row;
    lane_step<false>(a, t0 + lane, row, lane);
  }
  grid.sync();
  // 3. segments: a block's rows take one atomic on the total; the rows
  // longer than kExact lanes are listed for the rows kernel's own blocks,
  // each with its segment, one atomic a block for each list
  __shared__ int3 claims[kOrderWarps];  // a warp's lanes, mids, longs
  const unsigned below = (1u << lane) - 1u;
  const int wid = threadIdx.x >> 5;
  for (int64_t r0 = (int64_t)blockIdx.x * kOrderThreads; r0 < a.n_rows;
       r0 += stride) {  // block-uniform
    const int64_t r = r0 + threadIdx.x;
    const int c = r < a.n_rows ? __ldcg(&a.rows[r].x) : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned mid = __ballot_sync(kFull, c > kExact && c <= kWarpLanes);
    const unsigned big = __ballot_sync(kFull, c > kWarpLanes);
    if (lane == 31) claims[wid] = make_int3(incl, __popc(mid), __popc(big));
    __syncthreads();
    if (wid == 0) {  // the warps' claims scanned, the block's taken
      const int3 mine = lane < kOrderWarps ? claims[lane] : make_int3(0, 0, 0);
      int3 sum = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(kFull, sum.x, o);
        const int y = __shfl_up_sync(kFull, sum.y, o);
        const int z = __shfl_up_sync(kFull, sum.z, o);
        if (lane >= o) sum = make_int3(sum.x + x, sum.y + y, sum.z + z);
      }
      int3 at = make_int3(0, 0, 0);
      if (lane == 31) {
        if (sum.x) at.x = atomicAdd(a.counters, sum.x);
        if (sum.y) at.y = atomicAdd(a.counters + 1, sum.y);
        if (sum.z) at.z = atomicAdd(a.counters + 2, sum.z);
      }
      at = make_int3(__shfl_sync(kFull, at.x, 31), __shfl_sync(kFull, at.y, 31),
                     __shfl_sync(kFull, at.z, 31));
      if (lane < kOrderWarps)
        claims[lane] = make_int3(at.x + sum.x - mine.x, at.y + sum.y - mine.y,
                                 at.z + sum.z - mine.z);
    }
    __syncthreads();
    const int3 at = claims[wid];
    const int lo = at.x + incl - c;
    if (r < a.n_rows) a.rows[r].y = lo;
    const int4 entry = make_int4((int)r, lo, c, 0);
    if (mid >> lane & 1u) a.mids[at.y + __popc(mid & below)] = entry;
    if (big >> lane & 1u) a.longs[at.z + __popc(big & below)] = entry;
    __syncthreads();  // claims are free again
  }
  grid.sync();
  // 4. placement; the rows kernel's blocks may be scheduled from here
  launch_dependents();
  for (int64_t t0 = warp * 32; t0 < a.n; t0 += stride) {
    const int row = t0 == warp * 32 ? kept : any_lane_row(a, t0 + lane);
    lane_step<true>(a, t0 + lane, row, lane);
  }
}

// Loads the term of lane t: its bag's gradient vector col.
template <typename V, bool kBf16>
__device__ __forceinline__ V load_term(const typename Lanes<V, kBf16>::G* g,
                                       int64_t dv, int bag, int64_t col) {
  return Lanes<V, kBf16>::up(__ldg(g + (int64_t)bag * dv + col));
}

__device__ __forceinline__ int lane_bag(int t, int w) {
  return w == 1 ? t : t / w;
}

// srt[i], srt in shared memory or in global memory this block wrote (read
// through L2 there).
__device__ __forceinline__ int sorted_lane(const int* srt, int i) {
  return __isGlobal(srt) ? __ldcg(srt + i) : srt[i];
}

// acc[j] = the sum, in order, of the terms of run `run` of `n_runs`
// contiguous runs of the sorted lanes srt[0, len), vector columns c0 + j
// (zero past dv).
template <typename V, bool kBf16, bool kScaled>
__device__ __forceinline__ void run_sum(
    V (&acc)[kChunk], const typename Lanes<V, kBf16>::G* g, int64_t dv,
    int w, const int* srt, const float* scales, int len, int run, int n_runs,
    int64_t c0) {
  const int per = (len + n_runs - 1) / n_runs;
  const int a = min(run * per, len), e = min((run + 1) * per, len);
#pragma unroll
  for (int j = 0; j < kChunk; ++j) acc[j] = zero<V>();
  for (int i0 = a; i0 < e; i0 += kRunDepth) {
    int bag[kRunDepth];
#pragma unroll
    for (int u = 0; u < kRunDepth; ++u)
      bag[u] = i0 + u < e ? lane_bag(sorted_lane(srt, i0 + u), w) : 0;
    V x[kRunDepth][kChunk];
    float s[kRunDepth];
#pragma unroll
    for (int u = 0; u < kRunDepth; ++u) {
      s[u] = kScaled && i0 + u < e ? __ldcg(scales + bag[u]) : 1.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        x[u][j] = i0 + u < e && c0 + j < dv
                      ? load_term<V, kBf16>(g, dv, bag[u], c0 + j) : zero<V>();
    }
#pragma unroll
    for (int u = 0; u < kRunDepth; ++u)
      if (i0 + u < e)
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          acc[j] = add_(acc[j], kScaled ? div_(x[u][j], s[u]) : x[u][j]);
  }
}

// Lane j < kChunk's acc[0] becomes the sum of the warp's 32 acc[j] in lane
// order, staged through `buf`, the warp's 32 x kChunk vectors of shared
// memory (a few loads a lane, where 31 rounds of shuffles of every vector
// contend for the shuffle unit). Every lane of the warp must call.
template <typename V>
__device__ __forceinline__ void lanes_in_order(V (&acc)[kChunk], int lane,
                                               V (*buf)[kChunk]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) buf[lane][j] = acc[j];
  __syncwarp();
  if (lane < kChunk) {
    V tot = buf[0][lane];
#pragma unroll
    for (int src = 1; src < 32; ++src) tot = add_(tot, buf[src][lane]);
    acc[0] = tot;
  }
  __syncwarp();  // buf is free again
}

// The block's smallest v.x and largest v.y; `red` holds kWarps pairs.
// Every thread calls; ends with the block synchronised.
__device__ __forceinline__ int2 block_min_max(int2 v, int2* red) {
  v = make_int2(__reduce_min_sync(kFull, v.x), __reduce_max_sync(kFull, v.y));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int q = 1; q < kWarps; ++q)
    v = make_int2(min(v.x, red[q].x), max(v.y, red[q].y));
  __syncthreads();
  return v;
}

using WordScan = cub::BlockScan<int, kBwdThreads>;

// Shared memory of the rows kernel. The bitmap of a long row and the
// warps' staging of their runs' sums are never live together.
template <typename V> struct RowsSmem {
  union {
    V stage[kWarps][32][kChunk];  // lanes_in_order's
    unsigned map[kMapWords];      // a long row's bitmap
  };
  union {
    struct {
      int4 held[kWarps][kWarpLanes / 4];  // a warp's row as loaded
      int sorted[kWarps][kWarpLanes];     // ... in lane order
    } mid;
    int long_lanes[kBlockLanes];  // a long row's, in lane order
  };
  int short_lanes[kBlockRows][kExact];
  V part[kWarps][kChunk];
  typename WordScan::TempStorage scan;
  int2 red[kWarps];
};

// The block sorts the n lanes src[0, n) of one row (in no set order, each
// lane once) into lane order: into sm.long_lanes when n <= kBlockLanes,
// else into dst (global scratch, n ints); returns where. Each window of
// kMapWords * 32 lane indices, from the row's smallest lane up, becomes a
// bitmap whose set bits, in order, are the window's lanes; a window with
// no lane is skipped. Every thread calls; ends with the block
// synchronised.
template <typename V>
__device__ const int* sort_long(const int* src, int n, int* dst,
                                RowsSmem<V>& sm) {
  const int tid = threadIdx.x;
  const bool hold = n <= kBlockLanes;
  int held[kHold];
  int lo = INT32_MAX, hi = -1;
  if (hold) {
#pragma unroll
    for (int j = 0; j < kHold; ++j) {
      const int i = tid + j * kBwdThreads;
      held[j] = i < n ? __ldcg(src + i) : INT32_MAX;
      if (i < n) {
        lo = min(lo, held[j]);
        hi = max(hi, held[j]);
      }
    }
  } else {
    for (int i = tid; i < n; i += kBwdThreads) {
      const int t = __ldcg(src + i);
      lo = min(lo, t);
      hi = max(hi, t);
    }
  }
  const int2 span = block_min_max(make_int2(lo, hi), sm.red);
  lo = span.x;
  hi = span.y;
  int* out = hold ? sm.long_lanes : dst;
  int done = 0;
  for (int64_t base = lo; base <= hi;) {  // block-uniform
    const int64_t full = base + (int64_t)kMapWords * 32;
    const int64_t end = full < (int64_t)hi + 1 ? full : (int64_t)hi + 1;
    const int words = (int)((end - base + 31) / 32);
    for (int i = tid; i < words; i += kBwdThreads) sm.map[i] = 0u;
    __syncthreads();
    int next = INT32_MAX;  // the smallest lane past this window
    auto mark = [&](int t) {
      if (t >= base && t < end) {
        const int64_t bit = t - base;
        atomicOr(sm.map + (bit >> 5), 1u << (bit & 31));
      } else if (t >= end) {
        next = min(next, t);
      }
    };
    if (hold) {
#pragma unroll
      for (int j = 0; j < kHold; ++j)
        if (tid + j * kBwdThreads < n) mark(held[j]);
    } else {
      for (int i = tid; i < n; i += kBwdThreads) mark(__ldcg(src + i));
    }
    next = block_min_max(make_int2(next, 0), sm.red).x;  // the map is done too
    const int per = (words + kBwdThreads - 1) / kBwdThreads;
    const int w0 = min(tid * per, words), w1 = min(w0 + per, words);
    int cnt = 0;
    for (int i = w0; i < w1; ++i) cnt += __popc(sm.map[i]);
    int at, found;
    WordScan(sm.scan).ExclusiveSum(cnt, at, found);
    at += done;
    for (int i = w0; i < w1; ++i)
      for (unsigned m = sm.map[i]; m; m &= m - 1u)
        out[at++] = (int)(base + 32 * i + __ffs(m) - 1);
    done += found;
    __syncthreads();  // out complete, the map and the scan free again
    base = next == INT32_MAX ? (int64_t)hi + 1 : next;
  }
  return out;
}

// Step 5's arguments: the gradient, the ordering's scratch and the output.
template <typename G> struct RowsArgs {
  const G* g;
  int64_t dv;  // D in units of V
  int w;
  const int* lanes;
  int* sorted;
  const float* scales;
  const int2* rows;
  int64_t n_rows;
  const int4* mids;
  const int4* longs;
  const int* counters;
  int big_blocks;  // the blocks that take the listed rows
  G* out;
};

// A listed row of kExact < len <= kWarpLanes lanes by one warp: each lane
// holds four of its lanes and ranks them against the row's others (four a
// shared-memory load), then 32 contiguous runs are summed and added in run
// order. Every lane of the warp calls.
template <typename V, bool kBf16, bool kScaled>
__device__ void mid_row(const RowsArgs<typename Lanes<V, kBf16>::G>& a,
                        int4 e, RowsSmem<V>& sm, int lane, int warp) {
  const int64_t row = e.x;
  const int lo = e.y, len = e.z;
  int* held = (int*)sm.mid.held[warp];
  int* srt = sm.mid.sorted[warp];
  int v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = lane + 32 * q;
    v[q] = i < len ? __ldcg(a.lanes + lo + i) : INT32_MAX;
    held[i] = v[q];  // past the row: INT32_MAX, never below a lane
  }
  __syncwarp();
  int k[4] = {0, 0, 0, 0};
#pragma unroll 4
  for (int j = 0; j < (len + 3) >> 2; ++j) {
    const int4 x = sm.mid.held[warp][j];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      k[q] += (x.x < v[q]) + (x.y < v[q]) + (x.z < v[q]) + (x.w < v[q]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (lane + 32 * q < len) srt[k[q]] = v[q];
  __syncwarp();
  for (int64_t c0 = 0; c0 < a.dv; c0 += kChunk) {
    V acc[kChunk];
    run_sum<V, kBf16, kScaled>(acc, a.g, a.dv, a.w, srt, a.scales, len, lane,
                               32, c0);
    lanes_in_order(acc, lane, sm.stage[warp]);
    if (lane < kChunk && c0 + lane < a.dv)
      a.out[row * a.dv + c0 + lane] = Lanes<V, kBf16>::down(acc[0]);
  }
}

// A listed row of more than kWarpLanes lanes by the whole block: sorted
// (sort_long), then 256 contiguous runs summed, each warp's added in run
// order, then the 8 warps' in warp order. Every thread calls.
template <typename V, bool kBf16, bool kScaled>
__device__ void long_row(const RowsArgs<typename Lanes<V, kBf16>::G>& a,
                         int4 e, RowsSmem<V>& sm, int lane, int warp) {
  const int64_t row = e.x;
  const int* srt = sort_long(a.lanes + e.y, e.z, a.sorted + e.y, sm);
  for (int64_t c0 = 0; c0 < a.dv; c0 += kChunk) {
    V acc[kChunk];
    run_sum<V, kBf16, kScaled>(acc, a.g, a.dv, a.w, srt, a.scales, e.z,
                               threadIdx.x, kBwdThreads, c0);
    lanes_in_order(acc, lane, sm.stage[warp]);
    if (lane < kChunk) sm.part[warp][lane] = acc[0];
    __syncthreads();
    if (threadIdx.x < kChunk) {  // the 8 warps' sums in warp order
      V tot = sm.part[0][threadIdx.x];
      for (int q = 1; q < kWarps; ++q) tot = add_(tot, sm.part[q][threadIdx.x]);
      if (c0 + threadIdx.x < a.dv)
        a.out[row * a.dv + c0 + threadIdx.x] = Lanes<V, kBf16>::down(tot);
    }
    __syncthreads();
  }
}

// Step 5. Blocks [0, big_blocks) take the listed rows in units, a unit a
// block in turn: first each long row, then each 8 medium rows (a warp
// each). They come first in the grid, so the longest chains start with
// the kernel. Every later block takes kBlockRows rows, kRowLanes threads a
// row, and sums those of at most kExact lanes: each thread holds kRowHeld
// lanes and ranks them against the row's others, and one thread per vector
// column adds them in lane order (the plain version's). A programmatic
// dependent of the ordering.
template <typename V, bool kBf16, bool kScaled>
__global__ void __launch_bounds__(kBwdThreads) rows_kernel(
    const RowsArgs<typename Lanes<V, kBf16>::G> a) {
  using L = Lanes<V, kBf16>;
  __shared__ RowsSmem<V> sm;
  wait_for_prerequisite();  // the ordering has landed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < a.big_blocks) {  // block-uniform
    const int n_mid = __ldcg(a.counters + 1), n_long = __ldcg(a.counters + 2);
    const int units = n_long + (n_mid + kWarps - 1) / kWarps;
    for (int u = blockIdx.x; u < units; u += a.big_blocks) {
      if (u < n_long) {
        long_row<V, kBf16, kScaled>(a, __ldcg(a.longs + u), sm, lane, warp);
      } else {
        const int m = (u - n_long) * kWarps + warp;
        if (m < n_mid)
          mid_row<V, kBf16, kScaled>(a, __ldcg(a.mids + m), sm, lane, warp);
        __syncthreads();  // the next unit may be a long row
      }
    }
    return;
  }
  const int c = threadIdx.x % kRowLanes;
  const int64_t r = (int64_t)(blockIdx.x - a.big_blocks) * kBlockRows +
                    threadIdx.x / kRowLanes;
  const int2 rb = r < a.n_rows ? __ldcg(a.rows + r) : make_int2(0, 0);
  const int len = rb.x, lo = rb.y - rb.x;  // the cursor ended at the end
  const bool few = r < a.n_rows && len <= kExact;
  int l[kRowHeld], k[kRowHeld];  // lane c + kRowLanes * q of the row
#pragma unroll
  for (int q = 0; q < kRowHeld; ++q) {
    const int i = c + kRowLanes * q;
    l[q] = few && i < len ? __ldcg(a.lanes + lo + i) : INT32_MAX;
    k[q] = 0;
  }
  const int most = __reduce_max_sync(kFull, few ? len : 0);
#pragma unroll
  for (int j = 0; j < kExact; ++j) {  // warp-uniform
    if (j >= most) break;
    const int v = __shfl_sync(kFull, l[j / kRowLanes],
                              (lane & ~(kRowLanes - 1)) | (j % kRowLanes));
#pragma unroll
    for (int q = 0; q < kRowHeld; ++q) k[q] += v < l[q];
  }
  int* srt = sm.short_lanes[threadIdx.x / kRowLanes];
#pragma unroll
  for (int q = 0; q < kRowHeld; ++q)
    if (few && c + kRowLanes * q < len) srt[k[q]] = l[q];
  __syncwarp();
  if (!few) return;  // a listed row, or past the end
  for (int64_t col = c; col < a.dv; col += kRowLanes) {
    V acc = zero<V>();
    for (int i0 = 0; i0 < len; i0 += kDepth) {
      V x[kDepth];
      float s[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int bag = i0 + u < len ? lane_bag(srt[i0 + u], a.w) : 0;
        s[u] = kScaled && i0 + u < len ? __ldcg(a.scales + bag) : 1.f;
        x[u] = i0 + u < len ? load_term<V, kBf16>(a.g, a.dv, bag, col)
                            : zero<V>();
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u)
        if (i0 + u < len) acc = add_(acc, kScaled ? div_(x[u], s[u]) : x[u]);
    }
    a.out[r * a.dv + col] = L::down(acc);
  }
}

// Lays the scratch out from `base` (NULL: sizes only) into `a`; returns
// its bytes.
template <typename A>
size_t bwd_scratch(int64_t n, int64_t n_bags, int64_t n_rows, void* base,
                   A* a) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    void* p = base == nullptr ? nullptr : (char*)base + off;
    off += (bytes + 255) & ~size_t{255};
    return p;
  };
  a->rows = (int2*)take(n_rows * sizeof(int2));
  a->lanes = (int*)take(n * sizeof(int));
  a->sorted = (int*)take(n * sizeof(int));
  a->scales = (float*)take(n_bags * sizeof(float));
  const int64_t mids = n / (kExact + 1), longs = n / (kWarpLanes + 1);
  a->mids = (int4*)take((mids < n_rows ? mids : n_rows) * sizeof(int4));
  a->longs = (int4*)take((longs < n_rows ? longs : n_rows) * sizeof(int4));
  a->counters = (int*)take(3 * sizeof(int));
  return off;
}

// Steps 1-4 as one cooperative launch on as many blocks as its widest
// step needs (at least one an SM), at most the blocks the card holds at
// once.
cudaError_t launch_order(const OrderArgs& a, cudaStream_t stream) {
  static int resident = 0;
  const int64_t sms = sm_count();
  const int64_t wave = sms * resident_blocks(order_kernel, kOrderThreads,
                                             &resident);
  int64_t blocks = (a.n + kOrderThreads - 1) / kOrderThreads;
  const int64_t row_blocks = (a.n_rows + kOrderThreads - 1) / kOrderThreads;
  if (row_blocks > blocks) blocks = row_blocks;
  if (blocks < sms) blocks = sms;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) return cudaErrorInvalidConfiguration;  // the card holds none
  return launch_cooperative(order_kernel, blocks, kOrderThreads, stream, a);
}

// Step 5 at vector unit V, f32 or bf16 lanes, as the ordering's
// programmatic dependent: as many blocks for the listed rows as they could
// need (a warp a row of more than kExact lanes, at most two an SM), then a
// block for each kBlockRows rows.
template <typename V, bool kBf16>
cudaError_t launch_rows(const void* d_pooled, int64_t dv, const OrderArgs& a,
                        void* out, cudaStream_t stream) {
  using G = typename Lanes<V, kBf16>::G;
  RowsArgs<G> r = {(const G*)d_pooled, dv, (int)a.w, a.lanes, a.sorted,
                   a.scales, a.rows, a.n_rows, a.mids, a.longs, a.counters,
                   0, (G*)out};
  const int64_t listed = a.n / (kExact + 1);  // at most
  const int64_t big = (listed + kWarps - 1) / kWarps, most = 2 * sm_count();
  r.big_blocks = (int)(big < most ? big : most);
  const auto kernel = a.combiner != 0 ? rows_kernel<V, kBf16, true>
                                      : rows_kernel<V, kBf16, false>;
  return launch_dependent(
      kernel, r.big_blocks + (a.n_rows + kBlockRows - 1) / kBlockRows,
      kBwdThreads, stream, r);
}

// The backward: the ordering, then the rows at vector width vec (4, 2 or
// 1 lanes) of f32 or bf16.
cudaError_t launch_bwd(const void* d_pooled, int64_t d, const void* slots,
                       int slots_are_64, int64_t s_b, int64_t s_k,
                       const void* valid, int64_t v_b, int64_t v_k,
                       int64_t n_bags, int64_t w, int combiner, void* out,
                       int64_t n_rows, int vec, int bf16, void* scratch,
                       cudaStream_t st) {
  OrderArgs a = {};
  a.slots = slots;
  a.slots_are_64 = slots_are_64;
  a.s_b = s_b;
  a.s_k = s_k;
  a.valid = (const bool*)valid;
  a.v_b = v_b;
  a.v_k = v_k;
  a.n_bags = n_bags;
  a.w = w;
  a.n_rows = n_rows;
  a.combiner = combiner;
  a.n = n_bags * w;
  bwd_scratch(a.n, n_bags, n_rows, scratch, &a);
  cudaError_t err = launch_order(a, st);
  if (err != cudaSuccess) return err;
  if (vec == 4)
    return bf16 ? launch_rows<float4, true>(d_pooled, d / 4, a, out, st)
                : launch_rows<float4, false>(d_pooled, d / 4, a, out, st);
  if (vec == 2)
    return bf16 ? launch_rows<float2, true>(d_pooled, d / 2, a, out, st)
                : launch_rows<float2, false>(d_pooled, d / 2, a, out, st);
  return bf16 ? launch_rows<float, true>(d_pooled, d, a, out, st)
              : launch_rows<float, false>(d_pooled, d, a, out, st);
}

}  // namespace

// values [n_rows, d] of f32 (bf16 == 0) or bf16 (bf16 == 1) with row
// stride ld (elements); slots [n_bags, w] int32/int64 and valid [n_bags, w]
// bool with element strides (s_b, s_k) and (v_b, v_k); out [n_bags, d]
// contiguous, of the values' type. combiner: 0 sum, 1 mean, 2 sqrtn. vec:
// 1 when d, ld and both base addresses allow 16-byte loads (float4, or 8
// bf16; the wrapper checks). Returns the launch's cudaError_t; 0 is
// success.
extern "C" int deeprec_fused_pooled_lookup(
    const void* values, int64_t ld, int64_t n_rows, int64_t d,
    const void* slots, int slots_are_64, int64_t s_b, int64_t s_k,
    const void* valid, int64_t v_b, int64_t v_k, int64_t n_bags, int64_t w,
    int combiner, void* out, int vec, int bf16, void* stream) {
  if (n_bags == 0 || d == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (w == 0)  // no ids: every bag pools nothing
    return (int)cudaMemsetAsync(
        out, 0, (size_t)(n_bags * d) * (bf16 ? 2 : sizeof(float)), st);
  if (bf16 && vec)
    return launch<uint4>(values, ld / 8, n_rows, d / 8, slots, slots_are_64,
                         s_b, s_k, valid, v_b, v_k, n_bags, w, combiner, out,
                         st);
  if (bf16)
    return launch<bf16x1>(values, ld, n_rows, d, slots, slots_are_64, s_b,
                          s_k, valid, v_b, v_k, n_bags, w, combiner, out, st);
  if (vec)
    return launch<float4>(values, ld / 4, n_rows, d / 4, slots, slots_are_64,
                          s_b, s_k, valid, v_b, v_k, n_bags, w, combiner, out,
                          st);
  return launch<float>(values, ld, n_rows, d, slots, slots_are_64, s_b, s_k,
                       valid, v_b, v_k, n_bags, w, combiner, out, st);
}

// The backward's scratch bytes for n_bags * w lanes and n_rows rows (the
// wrapper allocates them; 256-byte aligned).
extern "C" int64_t deeprec_fused_pooled_lookup_bwd_scratch(int64_t n_bags,
                                                          int64_t w,
                                                          int64_t n_rows) {
  OrderArgs a;
  return (int64_t)bwd_scratch(n_bags * w, n_bags, n_rows, nullptr, &a);
}

// d_pooled [n_bags, d] contiguous, f32 (bf16 == 0) or bf16; slots/valid as
// for the forward; out [n_rows, d] contiguous, of d_pooled's type: every
// row written once, 0 where no valid lane touches it. vec: 4, 2 or 1, the
// widest vector of lanes that d and the base addresses allow (the wrapper
// checks); scratch: deeprec_fused_pooled_lookup_bwd_scratch bytes, 256-byte
// aligned. n_bags * w and n_rows below 2^31 - 1. Two launches (the
// ordering, cooperative; the rows); returns the first cudaError_t, 0 on
// success.
extern "C" int deeprec_fused_pooled_lookup_bwd(
    const void* d_pooled, int64_t d, const void* slots, int slots_are_64,
    int64_t s_b, int64_t s_k, const void* valid, int64_t v_b, int64_t v_k,
    int64_t n_bags, int64_t w, int combiner, void* out, int64_t n_rows,
    int vec, int bf16, void* scratch, void* stream) {
  if (n_rows * d == 0) return 0;
  if (n_bags * w >= INT32_MAX || n_rows >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      launch_bwd(d_pooled, d, slots, slots_are_64, s_b, s_k, valid, v_b, v_k,
                 n_bags, w, combiner, out, n_rows, vec, bf16, scratch,
                 (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // the first failed launch
  return (int)(err != cudaSuccess ? err : last);
}
