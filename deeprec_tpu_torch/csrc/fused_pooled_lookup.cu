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
// What bounds it at the Criteo shapes is not the index round trips but
// their order: the rows must arrive (two dependent loads, ~0.9 us) before
// the 6.8 MB write (~1.7 us) can start, and a launch costs ~2 us more back
// to back (probes/kernel_probe.cu's variants on an H100 80GB HBM3 at
// 700 W). So both kernels are launched as programmatic dependents of the
// work before them (griddepcontrol): their blocks are scheduled while
// that work finishes, and each waits for it before its first access to
// memory (out may be a block the allocator just reused).

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

#include "launch.cuh"

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

__device__ __forceinline__ int64_t clamp_row(int64_t s, int64_t n_rows) {
  return s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s);
}

// Unit u of a tile's output: bag u / dv, column u % dv (a shift and a mask
// when dv is a power of two, dv_shift >= 0).
__device__ __forceinline__ int unit_bag(int u, int dv, int dv_shift) {
  return dv_shift >= 0 ? u >> dv_shift : u / dv;
}

// w == 1. V: float or float4 (the vector unit); ld and dv are in units of
// V. Every combiner gives valid ? row : 0.
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

// w > 1 (or any w). kComb: 0 sum, 1 mean, 2 sqrtn.
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
    V acc = zero<V>();
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
          if (k + j < kn && (bag_oks >> (k + j) & 1u)) acc = add_(acc, x[j]);
      }
    }
    if (kComb != 0) {
      const float m = (float)(n > 1 ? n : 1);
      acc = div_(acc, kComb == 1 ? m : sqrtf(m));
    }
    if (live) tile_out[u] = acc;
  }
}

// K2 backward: the pooling's gradient with respect to values,
//   d_values[clamp(slots[b, k], 0, R-1), :] += d_pooled[b, :] / scale_b
// for every valid lane (b, k), scale_b = 1 (sum), max(n_b,1) (mean) or
// sqrt(max(n_b,1)) (sqrtn). The Pallas TPU kernel has no backward (its
// caller differentiated the XLA gather instead); this is the port's own.
// Bound by HBM bytes: d_pooled read once, slots/valid read once, the
// [R, D] output written once.
//
// Design: contention on a row must not grow with that row's id count.
// Criteo's skew puts ~1,400 of a batch's 106,496 ids on one of ~17,750
// rows; one f32 atomic per id and column serialises ~22,700 adds on that
// row's 64 bytes in L2. Here one thread owns one (bag, lane) id and holds
// its scaled gradient row in registers, kChunk vectors (float4 where D
// allows) at a time. __match_any_sync on the clamped row groups the warp's
// valid ids that hit one row; the group's rows are summed with shuffles in
// log2(group size) steps (reduce_peers), and only the group's leader's sum
// reaches global memory, as vector atomics (float4/float2 atomicAdd,
// compute capability 9.x: one RED.128 per 16 bytes). A row then takes at
// most one add per 32-id window that touches it. Ids run bag-major, or
// lane-major when the lane stride is the larger one (the transposed views
// inverse.view(W, B)[o:o+w].T), so a warp reads consecutive slots and, on
// the training layout, holds 32 consecutive examples of one column, where
// duplicates are common.
//
// What then bounds it is the number of 16-byte adds L2 must take, not
// their contention: with plain stores in place of the atomics the kernel
// is as slow. So the leaders' sums are written kChunk lanes to a leader
// (add_leaders): each warp instruction adds whole 64-byte runs of 8 rows,
// full 32-byte sectors, not one 16-byte piece of 32 rows.
//
// The output must be zero before the first add. A zero-fill kernel runs
// first and lets this kernel launch at once (programmatic dependent
// launch, griddepcontrol): the loads, the grouping and the shuffles
// overlap the fill, and every thread waits for it (griddepcontrol.wait)
// only before its first add. The atomics add in a different order on
// every run, so results agree with the plain version to rounding, not
// bits.
constexpr int kChunk = 4;  // vectors of a row held in registers at a time
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ float2 shfl(float2 v, int src) {
  return make_float2(__shfl_sync(kFull, v.x, src),
                     __shfl_sync(kFull, v.y, src));
}
__device__ __forceinline__ float4 shfl(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}
__device__ __forceinline__ float2 add_(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 div_(float2 a, float d) {
  return make_float2(a.x / d, a.y / d);
}
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}
__device__ __forceinline__ void red_add(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void red_add(float2* p, float2 v) {
  atomicAdd(p, v);  // sm_90: one vector reduction, the result unused
}
__device__ __forceinline__ void red_add(float4* p, float4 v) {
  atomicAdd(p, v);
}

// Sums x over the lanes of `peers` (this lane's group, from
// __match_any_sync) into the group's lowest lane. Each round, every live
// lane adds the value of the next live peer above it; the peers of odd
// rank are then done, and ranks halve. Every lane of the warp must call.
template <typename V>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane,
                                             V (&x)[kChunk]) {
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above) - 1;  // -1 when none: read, unused
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const V t = shfl(x[j], next & 31);
      if (next >= 0) x[j] = add_(x[j], t);
    }
    above &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
}

// Adds the sums that the lanes of `leaders` hold (x, at row) to d_values,
// kChunk lanes to a leader: lane q*kChunk + j adds vector j of the q-th
// leader, so each instruction writes the chunks of 32/kChunk leaders as
// contiguous runs. c0 is the chunk's first vector; dv is d in units of V.
// Every lane of the warp must call.
template <typename V>
__device__ __forceinline__ void add_leaders(unsigned leaders, int lane,
                                            const V (&x)[kChunk],
                                            int64_t row, int64_t c0,
                                            int64_t dv, V* d_values) {
  const int n = __popc(leaders);
  const int j = lane % kChunk;
  for (int base = 0; base < n; base += 32 / kChunk) {  // warp-uniform
    const int q = base + lane / kChunk;
    const int src = q < n ? (int)__fns(leaders, 0, q + 1) : 0;
    V v = zero<V>();
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const V s = shfl(x[i], src);
      if (i == j) v = s;
    }
    const int64_t r = __shfl_sync(kFull, row, src);
    if (q < n && c0 + j < dv) red_add(d_values + r * dv + c0 + j, v);
  }
}

// x[j] = g[c0 + j] for the vectors of the chunk below dv; 0 past it or
// when !load.
template <typename V>
__device__ __forceinline__ void load_chunk(V (&x)[kChunk], const V* g,
                                           int64_t c0, int64_t dv, bool load) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    x[j] = load && c0 + j < dv ? __ldg(g + c0 + j) : zero<V>();
}

// Zero-fills out[0, n) and lets the dependent backward launch at once.
__global__ void zero_fill_kernel(float* __restrict__ out, int64_t n) {
  launch_dependents();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n4 = n / 4;  // out is 16-byte aligned (see the entry)
  if (i < n4) reinterpret_cast<float4*>(out)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n - 4 * n4) out[4 * n4 + i] = 0.f;
}

// Zeroes the lanes that are not ok, divides the others by their bag's
// scale (kScaled: mean or sqrtn) and sums each group into its leader.
template <bool kScaled, typename V>
__device__ __forceinline__ void scale_and_reduce(V (&x)[kChunk], bool ok,
                                                 float scale, unsigned peers,
                                                 int lane) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    x[j] = !ok ? zero<V>() : kScaled ? div_(x[j], scale) : x[j];
  reduce_peers(peers, lane, x);
}

// V: float4, float2 or float (the vector unit); dv is d in units of V.
// kScaled: mean or sqrtn (combiner 1 or 2); sum has no scale code at all.
template <typename V, typename I, bool kScaled>
__global__ void __launch_bounds__(kBwdThreads) fused_pooled_lookup_bwd_kernel(
    const V* __restrict__ d_pooled, int64_t dv,
    const I* __restrict__ slots, int64_t s_b, int64_t s_k,
    const bool* __restrict__ valid, int64_t v_b, int64_t v_k, int64_t n_bags,
    int64_t w, int combiner, V* __restrict__ d_values, int64_t n_rows,
    int lane_major) {
  const int64_t n_ids = n_bags * w;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t - (threadIdx.x & 31) >= n_ids) {  // the whole warp is past the end
    wait_for_prerequisite();  // no thread ends before the zero-fill
    return;
  }
  const int lane = threadIdx.x & 31;
  int64_t b = t, k = 0;  // w == 1, the width-1 columns: no division
  if (w > 1 && lane_major) {
    k = t / n_bags;
    b = t - k * n_bags;
  } else if (w > 1) {
    b = t / w;
    k = t - b * w;
  }
  // The flag, the slot and the first chunk of the gradient row are loaded
  // together, whatever the flag says: one round trip to memory, not three
  // dependent ones.
  const bool in = t < n_ids;
  const V* g = d_pooled + b * dv;
  bool ok = false;
  int64_t row = 0;
  V x[kChunk];
  if (in) {
    ok = valid[b * v_b + k * v_k];
    row = (int64_t)slots[b * s_b + k * s_k];
  }
  load_chunk(x, g, 0, dv, in);
  row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
  float scale = 1.f;
  if (kScaled && ok) {
    int n = 0;
    for (int64_t j = 0; j < w; ++j) n += valid[b * v_b + j * v_k] ? 1 : 0;
    const float m = (float)(n > 1 ? n : 1);
    scale = combiner == 1 ? m : sqrtf(m);
  }
  // invalid and past-the-end ids each form a group of their own; a 32-bit
  // key where the rows allow it (half the match's work)
  const long long key = ok ? (long long)row : -1ll - lane;
  const unsigned peers = n_rows <= INT32_MAX
                             ? __match_any_sync(kFull, (int)key)
                             : __match_any_sync(kFull, key);
  const unsigned leaders =
      __ballot_sync(kFull, ok && lane == __ffs(peers) - 1);
  scale_and_reduce<kScaled>(x, ok, scale, peers, lane);
  wait_for_prerequisite();  // the zero-fill has landed
  add_leaders(leaders, lane, x, row, 0, dv, d_values);
  // rows wider than one chunk (D > 16 in float4): the rest, chunk by chunk
  for (int64_t c0 = kChunk; c0 < dv; c0 += kChunk) {  // warp-uniform loop
    load_chunk(x, g, c0, dv, ok);
    scale_and_reduce<kScaled>(x, ok, scale, peers, lane);
    add_leaders(leaders, lane, x, row, c0, dv, d_values);
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

// Launches the backward as the programmatic dependent of the zero-fill
// just queued on `stream`.
template <typename V, typename I>
cudaError_t launch_bwd(const void* d_pooled, int64_t dv, const void* slots,
                       int64_t s_b, int64_t s_k, const void* valid,
                       int64_t v_b, int64_t v_k, int64_t n_bags, int64_t w,
                       int combiner, void* d_values, int64_t n_rows,
                       cudaStream_t stream) {
  const int lane_major = w > 1 && llabs(s_k) > llabs(s_b);
  const auto kernel = combiner != 0
                          ? fused_pooled_lookup_bwd_kernel<V, I, true>
                          : fused_pooled_lookup_bwd_kernel<V, I, false>;
  return launch_dependent(kernel, (n_bags * w + kBwdThreads - 1) / kBwdThreads,
                          kBwdThreads, stream, (const V*)d_pooled, dv,
                          (const I*)slots, s_b, s_k, (const bool*)valid, v_b,
                          v_k, n_bags, w, combiner, (V*)d_values, n_rows,
                          lane_major);
}

template <typename V>
cudaError_t launch_bwd(const void* d_pooled, int64_t dv, const void* slots,
                       int slots_are_64, int64_t s_b, int64_t s_k,
                       const void* valid, int64_t v_b, int64_t v_k,
                       int64_t n_bags, int64_t w, int combiner, void* d_values,
                       int64_t n_rows, cudaStream_t stream) {
  if (slots_are_64)
    return launch_bwd<V, int64_t>(d_pooled, dv, slots, s_b, s_k, valid, v_b,
                                  v_k, n_bags, w, combiner, d_values, n_rows,
                                  stream);
  return launch_bwd<V, int32_t>(d_pooled, dv, slots, s_b, s_k, valid, v_b,
                                v_k, n_bags, w, combiner, d_values, n_rows,
                                stream);
}

}  // namespace

// f32 values [n_rows, d] with row stride ld (elements); slots [n_bags, w]
// int32/int64 and valid [n_bags, w] bool with element strides (s_b, s_k)
// and (v_b, v_k); out [n_bags, d] contiguous f32. combiner: 0 sum, 1 mean,
// 2 sqrtn. vec4: 1 when d, ld and both base addresses allow float4 loads
// (the wrapper checks). Returns the launch's cudaError_t; 0 is success.
extern "C" int deeprec_fused_pooled_lookup(
    const void* values, int64_t ld, int64_t n_rows, int64_t d,
    const void* slots, int slots_are_64, int64_t s_b, int64_t s_k,
    const void* valid, int64_t v_b, int64_t v_k, int64_t n_bags, int64_t w,
    int combiner, void* out, int vec4, void* stream) {
  if (n_bags == 0 || d == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (w == 0)  // no ids: every bag pools nothing
    return (int)cudaMemsetAsync(out, 0, (size_t)(n_bags * d) * sizeof(float),
                                st);
  if (vec4)
    return launch<float4>(values, ld / 4, n_rows, d / 4, slots, slots_are_64,
                          s_b, s_k, valid, v_b, v_k, n_bags, w, combiner, out,
                          st);
  return launch<float>(values, ld, n_rows, d, slots, slots_are_64, s_b, s_k,
                       valid, v_b, v_k, n_bags, w, combiner, out, st);
}

// d_pooled [n_bags, d] contiguous f32; slots/valid as for the forward;
// d_values [n_rows, d] contiguous f32, 16-byte aligned (the wrapper
// allocates it), receives the sums (zero-filled here first, on the
// stream). vec: 4, 2 or 1, the widest vector that d and d_pooled's base
// address allow (the wrapper checks). Returns the first cudaError_t; 0 is
// success.
extern "C" int deeprec_fused_pooled_lookup_bwd(
    const void* d_pooled, int64_t d, const void* slots, int slots_are_64,
    int64_t s_b, int64_t s_k, const void* valid, int64_t v_b, int64_t v_k,
    int64_t n_bags, int64_t w, int combiner, void* d_values, int64_t n_rows,
    int vec, void* stream) {
  const int64_t n = n_rows * d;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t zero_blocks = (n / 4 + kBwdThreads - 1) / kBwdThreads;
  zero_fill_kernel<<<(unsigned)(zero_blocks > 0 ? zero_blocks : 1),
                     kBwdThreads, 0, st>>>((float*)d_values, n);
  if (n_bags == 0 || w == 0) return (int)cudaGetLastError();
  cudaError_t err;
  if (vec == 4)
    err = launch_bwd<float4>(d_pooled, d / 4, slots, slots_are_64, s_b, s_k,
                             valid, v_b, v_k, n_bags, w, combiner, d_values,
                             n_rows, st);
  else if (vec == 2)
    err = launch_bwd<float2>(d_pooled, d / 2, slots, slots_are_64, s_b, s_k,
                             valid, v_b, v_k, n_bags, w, combiner, d_values,
                             n_rows, st);
  else
    err = launch_bwd<float>(d_pooled, d, slots, slots_are_64, s_b, s_k, valid,
                            v_b, v_k, n_bags, w, combiner, d_values, n_rows,
                            st);
  const cudaError_t last = cudaGetLastError();  // the fill's, or this one's
  return (int)(last != cudaSuccess ? last : err);
}
