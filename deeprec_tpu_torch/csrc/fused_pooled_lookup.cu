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
// to back (probes/kernel_probe.cu's variants on an H100 80GB HBM3 at
// 700 W). So both kernels are launched as programmatic dependents of the
// work before them (griddepcontrol): their blocks are scheduled while
// that work finishes, and each waits for it before its first access to
// memory (out may be a block the allocator just reused).

#include <cooperative_groups.h>
#include <cub/block/block_radix_sort.cuh>
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
// before. Two launches, as the atomic design's fill + adds: steps 1-3 in
// one cooperative launch (order_kernel) on at most the blocks the card
// holds at once, parted by grid barriers, and step 4 (rows_kernel) as its
// programmatic dependent:
//  1. Each lane (b, k), at position b*w + k (the plain version's lane
//     order), gets the key clamp(slot) where valid and R where not, and
//     the value b; each bag its scale (mean, sqrtn); the row bounds are
//     cleared.
//  2. An LSD radix sort of the pairs, 8 bits a pass over the bits R needs:
//     each tile of kTile lanes counts its digits; then each tile sums
//     every tile's counts into its digits' offsets, sorts its lanes by
//     digit (cub::BlockRadixSort, stable) and writes them there. Stable at
//     every pass, so each row's lanes stay in lane order.
//  3. Each row's range [lo, hi) of the sorted lanes, where the key
//     changes; an untouched row keeps [0, 0).
//  4. A block takes 32 rows at a time, 8 lanes a row. A row of at most
//     kExact lanes is summed in lane order by one lane per vector column:
//     the order of the plain version, whose index_add_ adds in index order,
//     so the sums are bit-equal to it. A row of up to kWarpLanes lanes is
//     left to its warp, a longer one to the whole block (Criteo's skew puts
//     ~1,400 of a batch's 106,496 ids on one of ~17,750 rows): 32 or 256
//     threads each sum a contiguous run of the row's lanes in order, and
//     the runs' sums are added in run order (a warp's through shared
//     memory, one lane a vector; then the 8 warps' sums). A row of at most
//     32 lanes thus still adds in lane order; a longer one adds in a tree
//     that its lane count fixes.
// A bf16 gradient is widened to f32 as it is loaded, and each row's f32
// sum is rounded once to bf16 as it is written.
constexpr int kBwdThreads = 256;
constexpr int kSortItems = 8;  // lanes a thread holds in a tile's sort
constexpr int kTile = kBwdThreads * kSortItems;
constexpr int kDigits = 256;   // 8 bits a pass
constexpr int kRowLanes = 8;   // a row's lanes in the first pass
constexpr int kBlockRows = kBwdThreads / kRowLanes;
constexpr int kExact = 16;     // rows of at most this many lanes: pass 1
constexpr int kWarpLanes = 128;  // ... at most this many: a warp; more: the block
constexpr int kDepth = 8;      // pass 1: gradient loads in flight a lane
constexpr int kChunk = 4;      // runs: vectors of a row a thread holds
constexpr int kRunDepth = 2;   // runs: lanes in flight a thread
static_assert(kBwdThreads == kDigits, "a thread a digit");

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

// The ordering's arrays: the inputs and the scratch the wrapper allocates
// (keys[0], bags[0] in lane order; keys[1], bags[1] the sort's other
// buffer; hist the tiles' digit counts; scales; bounds). Scratch written
// during the launch is read with __ldcg (L2), never through the read-only
// cache.
struct OrderArgs {
  const void* slots;
  int slots_are_64;
  int64_t s_b, s_k;
  const bool* valid;
  int64_t v_b, v_k, n_bags, w, n_rows;
  int combiner;
  unsigned* keys[2];
  int* bags[2];
  unsigned* hist;  // [kDigits][n_tiles], digit-major
  float* scales;
  int2* bounds;
  int64_t n, n_tiles;
  int end_bit;
};

// Step 1 for lane/bag/row t.
template <typename I, typename A>
__device__ __forceinline__ void order_one(const A& a, int64_t t) {
  const I* slots = (const I*)a.slots;
  if (t < a.n) {
    const int64_t b = a.w == 1 ? t : t / a.w, k = t - b * a.w;
    const bool ok = a.valid[b * a.v_b + k * a.v_k];
    const int64_t row =
        clamp_row((int64_t)slots[b * a.s_b + k * a.s_k], a.n_rows);
    a.keys[0][t] = ok ? (unsigned)row : (unsigned)a.n_rows;
    a.bags[0][t] = (int)b;
  }
  if (a.combiner != 0 && t < a.n_bags) {
    int n = 0;
    for (int64_t j = 0; j < a.w; ++j) n += a.valid[t * a.v_b + j * a.v_k];
    const float m = (float)(n > 1 ? n : 1);
    a.scales[t] = a.combiner == 1 ? m : sqrtf(m);
  }
  if (t < a.n_rows) a.bounds[t] = make_int2(0, 0);
}

using TileSort = cub::BlockRadixSort<unsigned, kBwdThreads, kSortItems, int>;
using DigitScan = cub::BlockScan<unsigned, kBwdThreads>;

// Step 2, one pass: the lanes of keys[src], bags[src] stably sorted by
// their digit at `bit` into keys[1 - src], bags[1 - src]. `cnt` counts a
// tile's digits, `offset` holds where they go.
template <typename A>
__device__ void sort_pass(const A& a, int src, int bit, cg::grid_group& grid,
                          unsigned* cnt, unsigned* offset,
                          typename TileSort::TempStorage& sort,
                          typename DigitScan::TempStorage& scan) {
  const unsigned* keys = a.keys[src];
  const int* bags = a.bags[src];
  const int t = threadIdx.x;
  // each tile's digit counts, digit-major
  for (int64_t tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    cnt[t] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSortItems; ++j) {
      const int64_t i = tile * kTile + j * kBwdThreads + t;
      if (i < a.n) atomicAdd(cnt + (__ldcg(keys + i) >> bit & 255u), 1u);
    }
    __syncthreads();
    a.hist[(int64_t)t * a.n_tiles + tile] = cnt[t];
    __syncthreads();
  }
  grid.sync();
  // each tile sorted by digit (its lanes past n: digit 255, after the
  // real ones) and written at its digits' offsets
  for (int64_t tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    unsigned digit[kSortItems];
    int local[kSortItems];
#pragma unroll
    for (int j = 0; j < kSortItems; ++j) {
      local[j] = t * kSortItems + j;  // blocked: the stable order
      const int64_t i = tile * kTile + local[j];
      digit[j] = i < a.n ? __ldcg(keys + i) >> bit & 255u : 255u;
    }
    // where digit t's lanes of this tile go: after every tile's lanes of
    // smaller digits and this digit's lanes of the tiles before
    unsigned total = 0, before = 0;
    const unsigned* counts = a.hist + (int64_t)t * a.n_tiles;
#pragma unroll 16
    for (int64_t q = 0; q < a.n_tiles; ++q) {
      const unsigned c = __ldcg(counts + q);
      total += c;
      before += q < tile ? c : 0u;
    }
    unsigned below;
    DigitScan(scan).ExclusiveSum(total, below);
    offset[t] = below + before;
    TileSort(sort).Sort(digit, local, 0, 8);
    cnt[t] = 0;
    __syncthreads();
    const int64_t base = tile * kTile;
    const int real = a.n - base < kTile ? (int)(a.n - base) : kTile;
#pragma unroll
    for (int j = 0; j < kSortItems; ++j)
      if (local[j] < real) atomicAdd(cnt + digit[j], 1u);
    __syncthreads();
    unsigned first;  // where this thread's digit starts in the sorted tile
    DigitScan(scan).ExclusiveSum(cnt[t], first);
    __syncthreads();
    cnt[t] = first;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSortItems; ++j) {
      if (local[j] >= real) continue;
      const unsigned pos = t * kSortItems + j - cnt[digit[j]];
      const int64_t dst = (int64_t)offset[digit[j]] + pos;
      a.keys[1 - src][dst] = __ldcg(keys + base + local[j]);
      a.bags[1 - src][dst] = __ldcg(bags + base + local[j]);
    }
    __syncthreads();
  }
  grid.sync();
}

// Loads the term of sorted lane i: bag bags[i]'s gradient vector col.
template <typename V, bool kBf16>
__device__ __forceinline__ V load_term(const typename Lanes<V, kBf16>::G* g,
                                       int64_t dv, int bag, int64_t col) {
  return Lanes<V, kBf16>::up(__ldg(g + (int64_t)bag * dv + col));
}

// acc[j] = the sum, in order, of the terms of run `run` of `n_runs`
// contiguous runs of the sorted lanes [lo, hi), vector columns c0 + j
// (zero past dv).
template <typename V, bool kBf16, bool kScaled>
__device__ __forceinline__ void run_sum(
    V (&acc)[kChunk], const typename Lanes<V, kBf16>::G* g, int64_t dv,
    const int* bags, const float* scales, int lo, int hi, int run, int n_runs,
    int64_t c0) {
  const int len = hi - lo, per = (len + n_runs - 1) / n_runs;
  const int a = lo + min(run * per, len), e = lo + min((run + 1) * per, len);
#pragma unroll
  for (int j = 0; j < kChunk; ++j) acc[j] = zero<V>();
  for (int i0 = a; i0 < e; i0 += kRunDepth) {
    int bag[kRunDepth];
#pragma unroll
    for (int u = 0; u < kRunDepth; ++u)
      bag[u] = i0 + u < e ? __ldcg(bags + i0 + u) : 0;
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

// Step 4, rows [32 * blockIdx.x, + 32): a row of at most kExact lanes by
// its 8 lanes, then each warp's rows of up to kWarpLanes lanes, then the
// block's longer rows; bags, bounds, scales: the ordering's. dv: D in
// units of V. A programmatic dependent of the ordering.
template <typename V, bool kBf16, bool kScaled>
__global__ void __launch_bounds__(kBwdThreads) rows_kernel(
    const typename Lanes<V, kBf16>::G* __restrict__ g, int64_t dv,
    const int* __restrict__ bags, const float* __restrict__ scales,
    const int2* __restrict__ bounds, int64_t n_rows,
    typename Lanes<V, kBf16>::G* __restrict__ out) {
  using L = Lanes<V, kBf16>;
  __shared__ V stage[kBwdThreads / 32][32][kChunk];  // lanes_in_order's
  __shared__ V part[kBwdThreads / 32][kChunk];
  __shared__ int long_rows[kBlockRows];
  __shared__ int n_long;
  wait_for_prerequisite();  // the ordering has landed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = threadIdx.x % kRowLanes;
  const int64_t r0 = (int64_t)blockIdx.x * kBlockRows;
  const int64_t r = r0 + threadIdx.x / kRowLanes;
  if (threadIdx.x == 0) n_long = 0;
  const int2 bd = r < n_rows ? __ldcg(bounds + r) : make_int2(0, 0);
  const int len = bd.y - bd.x;
  if (r < n_rows && len <= kExact) {  // in lane order: the plain version's
    for (int64_t col = c; col < dv; col += kRowLanes) {
      V acc = zero<V>();
      for (int i0 = bd.x; i0 < bd.y; i0 += kDepth) {
        V x[kDepth];
        float s[kDepth];
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const int bag = i0 + u < bd.y ? __ldcg(bags + i0 + u) : 0;
          s[u] = kScaled && i0 + u < bd.y ? __ldcg(scales + bag) : 1.f;
          x[u] = i0 + u < bd.y ? load_term<V, kBf16>(g, dv, bag, col)
                               : zero<V>();
        }
#pragma unroll
        for (int u = 0; u < kDepth; ++u)
          if (i0 + u < bd.y) acc = add_(acc, kScaled ? div_(x[u], s[u]) : x[u]);
      }
      out[r * dv + col] = L::down(acc);
    }
  }
  // the warp's rows of kExact < len <= kWarpLanes, one at a time
  unsigned mine = __ballot_sync(kFull, c == 0 && len > kExact &&
                                           len <= kWarpLanes);
  while (mine) {  // warp-uniform
    const int src = __ffs(mine) - 1;
    mine &= mine - 1;
    const int lo = __shfl_sync(kFull, bd.x, src);
    const int hi = __shfl_sync(kFull, bd.y, src);
    const int64_t row = r0 + warp * (32 / kRowLanes) + src / kRowLanes;
    for (int64_t c0 = 0; c0 < dv; c0 += kChunk) {
      V acc[kChunk];
      run_sum<V, kBf16, kScaled>(acc, g, dv, bags, scales, lo, hi, lane, 32,
                                 c0);
      lanes_in_order(acc, lane, stage[warp]);
      if (lane < kChunk && c0 + lane < dv)
        out[row * dv + c0 + lane] = L::down(acc[0]);
    }
  }
  // the block's rows of more than kWarpLanes lanes, with every thread
  __syncthreads();
  if (c == 0 && len > kWarpLanes)  // any order: the rows are independent
    long_rows[atomicAdd(&n_long, 1)] = (int)(r - r0);
  __syncthreads();
  for (int h = 0; h < n_long; ++h) {  // block-uniform
    const int64_t row = r0 + long_rows[h];
    const int2 hb = __ldcg(bounds + row);
    for (int64_t c0 = 0; c0 < dv; c0 += kChunk) {
      V acc[kChunk];
      run_sum<V, kBf16, kScaled>(acc, g, dv, bags, scales, hb.x, hb.y,
                                 threadIdx.x, kBwdThreads, c0);
      lanes_in_order(acc, lane, stage[warp]);
      if (lane < kChunk) part[warp][lane] = acc[0];
      __syncthreads();
      if (threadIdx.x < kChunk) {  // the 8 warps' sums in warp order
        V tot = part[0][threadIdx.x];
        for (int q = 1; q < kBwdThreads / 32; ++q)
          tot = add_(tot, part[q][threadIdx.x]);
        if (c0 + threadIdx.x < dv)
          out[row * dv + c0 + threadIdx.x] = L::down(tot);
      }
      __syncthreads();
    }
  }
}


// Steps 1-3 in one cooperative launch, grid barriers between them.
__global__ void __launch_bounds__(kBwdThreads) order_kernel(
    const OrderArgs a) {
  __shared__ typename TileSort::TempStorage sort;
  __shared__ typename DigitScan::TempStorage scan;
  __shared__ unsigned cnt[kDigits], offset[kDigits];
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = (int64_t)gridDim.x * kBwdThreads;
  const int64_t n1 = a.n > a.n_rows ? a.n : a.n_rows;
  for (int64_t t = (int64_t)blockIdx.x * kBwdThreads + threadIdx.x; t < n1;
       t += stride) {
    if (a.slots_are_64)
      order_one<int64_t>(a, t);
    else
      order_one<int32_t>(a, t);
  }
  grid.sync();
  int src = 0;
  for (int bit = 0; bit < a.end_bit; bit += 8) {
    sort_pass(a, src, bit, grid, cnt, offset, sort, scan);
    src = 1 - src;
  }
  // step 3: position i of the sorted keys (i == n: past the last) opens
  // the range of its key and closes the range of the key before it
  launch_dependents();
  const unsigned* keys = a.keys[src];
  for (int64_t i = (int64_t)blockIdx.x * kBwdThreads + threadIdx.x;
       i <= a.n; i += stride) {
    const int64_t key = i < a.n ? __ldcg(keys + i) : a.n_rows;
    const int64_t prev = i > 0 ? __ldcg(keys + i - 1) : -1;
    if (key == prev) continue;
    if (key < a.n_rows) a.bounds[key].x = (int)i;
    if (prev >= 0 && prev < a.n_rows) a.bounds[prev].y = (int)i;
  }
}

int key_bits(int64_t n_rows) {  // keys are 0 .. n_rows
  int bits = 1;
  while (bits < 32 && (int64_t{1} << bits) <= n_rows) ++bits;
  return bits;
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
  a->n_tiles = (n + kTile - 1) / kTile;
  for (int i = 0; i < 2; ++i) {
    a->keys[i] = (unsigned*)take(n * sizeof(unsigned));
    a->bags[i] = (int*)take(n * sizeof(int));
  }
  a->hist = (unsigned*)take(kDigits * a->n_tiles * sizeof(unsigned));
  a->scales = (float*)take(n_bags * sizeof(float));
  a->bounds = (int2*)take(n_rows * sizeof(int2));
  return off;
}

// Steps 1-3 as one cooperative launch on as many blocks as its tiles need
// (at least one an SM, for the lane-wise steps), at most the blocks the
// card holds at once.
cudaError_t launch_order(const OrderArgs& a, cudaStream_t stream) {
  static int resident = 0;
  const int64_t sms = sm_count();
  const int64_t wave = sms * resident_blocks(order_kernel, kBwdThreads,
                                             &resident);
  int64_t blocks = a.n_tiles > sms ? a.n_tiles : sms;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) return cudaErrorInvalidConfiguration;  // the card holds none
  return launch_cooperative(order_kernel, blocks, kBwdThreads, stream, a);
}

// Step 4 at vector unit V, f32 or bf16 lanes, as the ordering's
// programmatic dependent; `sorted` names the buffer the sort left its
// lanes in.
template <typename V, bool kBf16>
cudaError_t launch_rows(const void* d_pooled, int64_t dv, const OrderArgs& a,
                        int sorted, void* out, cudaStream_t stream) {
  using G = typename Lanes<V, kBf16>::G;
  const auto kernel = a.combiner != 0 ? rows_kernel<V, kBf16, true>
                                      : rows_kernel<V, kBf16, false>;
  return launch_dependent(kernel, (a.n_rows + kBlockRows - 1) / kBlockRows,
                          kBwdThreads, stream, (const G*)d_pooled, dv,
                          (const int*)a.bags[sorted], (const float*)a.scales,
                          (const int2*)a.bounds, a.n_rows, (G*)out);
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
  a.end_bit = a.n > 0 ? key_bits(n_rows) : 0;
  bwd_scratch(a.n, n_bags, n_rows, scratch, &a);
  cudaError_t err = launch_order(a, st);
  if (err != cudaSuccess) return err;
  const int sorted = (a.end_bit + 7) / 8 % 2;
  if (vec == 4)
    return bf16 ? launch_rows<float4, true>(d_pooled, d / 4, a, sorted, out,
                                            st)
                : launch_rows<float4, false>(d_pooled, d / 4, a, sorted, out,
                                             st);
  if (vec == 2)
    return bf16 ? launch_rows<float2, true>(d_pooled, d / 2, a, sorted, out,
                                            st)
                : launch_rows<float2, false>(d_pooled, d / 2, a, sorted, out,
                                             st);
  return bf16 ? launch_rows<float, true>(d_pooled, d, a, sorted, out, st)
              : launch_rows<float, false>(d_pooled, d, a, sorted, out, st);
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
