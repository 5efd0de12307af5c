// K2's backward in its previous, radix-sorted design, kept as a probe so
// that chip_smoke.py can time it in turns with the port's kernel
// (csrc/fused_pooled_lookup.cu) at every shape the port runs K2's backward
// at. It orders the valid lanes by row with an LSD radix sort, 8 bits a
// pass, in one cooperative launch (each pass a histogram, a grid barrier,
// a tile sort by cub::BlockRadixSort and a scatter, another grid barrier),
// then sums each row in the order its lanes fix as the ordering's
// programmatic dependent. Its sums are bit-equal to the port's: both add
// a row's lanes in the same order and the same run tree. The entry
// probe_k2_bwd_radix takes the port's entry's arguments; its scratch
// bytes come from probe_k2_bwd_radix_scratch. Included by kernel_probe.cu;
// a copy, not built into the port's library.
#pragma once

#include <cooperative_groups.h>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/launch.cuh"

namespace radix_bwd {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ int64_t clamp_row(int64_t s, int64_t n_rows) {
  return s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s);
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

}  // namespace radix_bwd

// The design's scratch bytes for n_bags * w lanes and n_rows rows.
extern "C" int64_t probe_k2_bwd_radix_scratch(int64_t n_bags, int64_t w,
                                              int64_t n_rows) {
  radix_bwd::OrderArgs a;
  return (int64_t)radix_bwd::bwd_scratch(n_bags * w, n_bags, n_rows, nullptr,
                                         &a);
}

// The arguments of the port's deeprec_fused_pooled_lookup_bwd; scratch:
// probe_k2_bwd_radix_scratch bytes, 256-byte aligned. Two launches (the
// ordering, cooperative; the rows); returns the first cudaError_t.
extern "C" int probe_k2_bwd_radix(
    const void* d_pooled, int64_t d, const void* slots, int slots_are_64,
    int64_t s_b, int64_t s_k, const void* valid, int64_t v_b, int64_t v_k,
    int64_t n_bags, int64_t w, int combiner, void* out, int64_t n_rows,
    int vec, int bf16, void* scratch, void* stream) {
  if (n_rows * d == 0) return 0;
  if (n_bags * w >= INT32_MAX || n_rows >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = radix_bwd::launch_bwd(
      d_pooled, d, slots, slots_are_64, s_b, s_k, valid, v_b, v_k, n_bags, w,
      combiner, out, n_rows, vec, bf16, scratch, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // the first failed launch
  return (int)(err != cudaSuccess ? err : last);
}
