// Design probes for K1, K2 (both directions) and K3b on the card: variants of
// each kernel that keep or drop one part of its work, timed by
// kernel_probe.py beside the port's own kernels. Not part of the port's
// library (ops/_build.py builds csrc/ only); kernel_probe.py builds this
// file on its own.
//
// K2 forward variants (D 16 as float4, w 1, int32 or int64 slots, sum),
// selected by probe_k2f's mode:
//   0 the previous design: four threads a bag, each one dependent chain
//     (flag, branch, slot, one float4 row load, store)
//   1 an empty kernel on the port's grid (one warp per 32 bags)
//   2 index loads only: each lane loads one bag's slot and flag
//   3 index loads and row loads, no stores
//   4 stores only: zeros to the output, no loads
//   5 the port's design (a copy), 256 threads a block
//   6 the same, 128 threads a block
//   7 the same, 512 threads a block
//   8 the same, 1024 threads a block
//   9 the port's design with streaming stores (st.global.cs)
//  10 stores only, streaming
//  11 two tiles a warp: 8 row loads in flight per lane before any store
//  12 the port's design launched as a programmatic dependent of whatever
//     precedes it on the stream: griddepcontrol.wait before the first
//     load, launch_dependents at once (256 threads a block)
//  13 the same, 128 threads a block
//  14 the same, 512 threads a block
// Variants 1-4 and 10 write no output (4 and 10 write zeros): they are
// timed, not checked.
//
// K2 backward variants (D 16 as float4, int32 slots, w 1, sum), selected
// by probe_k2's mode:
//   0 an empty kernel on the same grid (the launch floor)
//   1 loads only (flag, slot, gradient row)
//   2 loads and warp grouping (match + shuffle sums), no writes
//   3 grouped; each leader adds its own four 16-byte pieces (RED.128)
//   4 grouped; each leader stores its own four pieces (plain stores)
//   5 grouped; four lanes to a leader, one piece each (RED.128): the port's
//     write pattern
//   6 grouped; four lanes to a leader, plain stores
//   7 not grouped: every valid id adds its own four pieces
//   8 zero-fill kernel, then variant 5 as an ordinary launch
//   9 zero-fill kernel, then variant 5 as its programmatic dependent (the
//     port's design)
//  10 block aggregation: zero-fill, then tiles of 1024 ids sorted by row
//     (cub::BlockRadixSort) and summed run by run, as a dependent launch
// Variants 1-7 do not zero the output: they are timed, not checked.
// These variants probe the atomic design the port ran until it was made
// deterministic; that design itself, whole (every vector width, bf16,
// int32 and int64 slots, strided views, the combiners), is
// probe_k2_bwd_atomic in k2_bwd_atomic.cuh, included below.
//
// K3b variants (int4 copy of plane[:cap], then U int32 stores), selected
// by probe_k3b's mode:
//   0 copy on blocks of one pass each (128 at CAP 2^21), then the scatter
//     as its programmatic dependent (the port's design)
//   1 the same two kernels as ordinary launches
//   2 copy on one block per SM, striding, then the dependent scatter
//   3 one cooperative launch: copy, grid barrier, scatter
//   4 the copy alone
//
// K1 variants (16- or 4-byte units, int32 or int64 slots), selected by
// probe_k1's mode; the port's design is csrc/gather_rows.cu, included
// below:
//   0 the previous design: one vector unit a thread behind its own slot
//     load, a grid of n * lanes / 256 blocks, an ordinary launch
//   1 an empty kernel on the port's grid, as a dependent (the launch floor)
//   2 slot loads only: the port's tiles, slots loaded, clamped, shuffled
//   3 the port's design as an ordinary launch (no programmatic dependency)
//   4 bulk asynchronous copies (16-byte units only): each row one
//     cp.async.bulk global->shared completed on an mbarrier, then the
//     block's contiguous tile of 128 rows one cp.async.bulk shared->global;
//     one wave of resident blocks striding over the tiles, as a dependent
//   5-8 the port's design at 1, 2, 4 or 8 rows a thread (its grid rule,
//     one wave at most, for that row count; the port takes 1, 2 or 4)
// Variants 1 and 2 write no output: they are timed, not checked.
//
// K4 variants (the hash index's lookup), selected by probe_k4's mode; the
// port's kernels are csrc/hash_table.cu, included below:
//   0 the previous design: a key a half-warp, its probes in series, an
//     ordinary launch on n * 16 threads (one wave at most)
//   1 the port's kernel at 4 keys a half-warp, dependent launch
//   2 the same at 8 keys a half-warp
//   3 the same at 16 keys a half-warp (a key a lane)
//   4 the port's kernel (its keys a half-warp) as an ordinary launch
// K5 variants (lookup_or_insert), selected by probe_k5's mode:
//   0 the previous design: the plane copied out of place and the
//     arbitration words zeroed by the kernel each call, a barrier after
//     that, then two a round; per-key state in global memory read through
//     L2; every resident block
//   1 the port's kernel (in place) on every resident block, not a grid
//     sized to the keys
//   2 an empty cooperative kernel on the port's grid crossing one grid
//     barrier (the floor of a steady step's launch and barrier)
//   3-6 the port's kernel at 2, 4, 8 or 16 keys a half-warp
// K4 variants 5 and 6: the port's kernel at 2 and 1 keys a half-warp,
// dependent launch.
#include "../csrc/gather_rows.cu"
#include "../csrc/hash_table.cu"

#include "k2_bwd_atomic.cuh"

#include <cooperative_groups.h>
#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}
__device__ __forceinline__ void red4(float4* p, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// the port's reduce_peers for a float4 x 4 row
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane,
                                             float4 (&x)[4]) {
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above) - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 t = shfl4(x[j], next & 31);
      if (next >= 0) x[j] = add4(x[j], t);
    }
    above &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
}

// four lanes to a leader, one 16-byte piece each
template <bool kRed>
__device__ __forceinline__ void write_4lanes(unsigned leaders, int lane,
                                             const float4 (&x)[4], int row,
                                             float4* out) {
  const int n = __popc(leaders);
  for (int base = 0; base < n; base += 8) {
    const int q = base + lane / 4, c = lane % 4;
    const int src = q < n ? (int)__fns(leaders, 0, q + 1) : 0;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 s = shfl4(x[i], src);
      if (i == c) v = s;
    }
    const int r = __shfl_sync(kFull, row, src);
    if (q < n) {
      if (kRed) red4(out + (int64_t)r * 4 + c, v);
      else out[(int64_t)r * 4 + c] = v;
    }
  }
}

__global__ void empty_kernel(int* p) {
  if (p != nullptr && threadIdx.x == 9999) p[0] = 1;
}

__global__ void zero_fill(float4* out, int64_t n4) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) k2_variant(
    const float4* __restrict__ dp, const int* __restrict__ slots,
    const bool* __restrict__ valid, int64_t n, float4* __restrict__ out,
    int n_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t - lane >= n) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    return;
  }
  const bool in = t < n;
  const bool ok = in && valid[t];
  int row = in ? slots[t] : 0;
  float4 x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    x[j] = in ? __ldg(dp + t * 4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
  if (!ok)
    for (int j = 0; j < 4; ++j) x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
  if (kMode == 1) {  // keep the loads live
    if (x[0].x == 12345.f && x[3].w == 5.f && row == 7) out[0] = x[1];
    return;
  }
  if (kMode == 7) {
    if (ok)
      for (int j = 0; j < 4; ++j) red4(out + (int64_t)row * 4 + j, x[j]);
    return;
  }
  const unsigned peers = __match_any_sync(kFull, ok ? row : -1 - lane);
  const bool leader = ok && lane == __ffs(peers) - 1;
  reduce_peers(peers, lane, x);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (kMode == 2) {
    if (leader && x[0].x == 12345.f) out[0] = x[1];
  } else if (kMode == 3 || kMode == 4) {
    if (leader)
      for (int j = 0; j < 4; ++j) {
        if (kMode == 3) red4(out + (int64_t)row * 4 + j, x[j]);
        else out[(int64_t)row * 4 + j] = x[j];
      }
  } else {
    write_4lanes<kMode == 5>(__ballot_sync(kFull, leader), lane, x, row, out);
  }
}

// tiles of kTile ids: rows staged in shared memory, (row, id) sorted, runs
// of a row summed in each warp and added once
constexpr int kSortIpt = 4, kTile = kThreads * kSortIpt;
__global__ void __launch_bounds__(kThreads) k2_block_sorted(
    const float4* __restrict__ dp, const int* __restrict__ slots,
    const bool* __restrict__ valid, int64_t n, float4* __restrict__ out,
    int n_rows, int bits) {
  using Sort = cub::BlockRadixSort<unsigned, kThreads, kSortIpt, unsigned short>;
  __shared__ typename Sort::TempStorage sort_tmp;
  extern __shared__ float4 grads[];  // kTile x 4
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile * 4; i += kThreads) {
    const int64_t e = base * 4 + i;
    grads[i] = e < n * 4 ? __ldg(dp + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const unsigned sentinel = (1u << bits) - 1u;  // above every row
  unsigned keys[kSortIpt];
  unsigned short ids[kSortIpt];
#pragma unroll
  for (int i = 0; i < kSortIpt; ++i) {
    const int local = threadIdx.x * kSortIpt + i;
    const int64_t id = base + local;
    bool ok = false;
    int r = 0;
    if (id < n) {
      ok = valid[id];
      r = slots[id];
    }
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    keys[i] = ok ? (unsigned)r : sentinel;
    ids[i] = (unsigned short)local;
  }
  Sort(sort_tmp).SortBlockedToStriped(keys, ids, 0, bits);
  __syncthreads();
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kSortIpt; ++i) {
    const bool ok = keys[i] != sentinel;
    float4 x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = ok ? grads[ids[i] * 4 + j] : make_float4(0.f, 0.f, 0.f, 0.f);
    const unsigned peers = __match_any_sync(kFull, ok ? (int)keys[i] : -1 - lane);
    const unsigned leaders = __ballot_sync(kFull, ok && lane == __ffs(peers) - 1);
    reduce_peers(peers, lane, x);
    write_4lanes<true>(leaders, lane, x, (int)keys[i], out);
  }
}

template <typename K, typename... A>
cudaError_t launch(bool dependent, K kernel, int blocks, int threads, int smem,
                   cudaStream_t st, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// K3b
constexpr int kCopyThreads = 1024, kUnroll = 4;

__global__ void __launch_bounds__(kCopyThreads) plane_copy(
    const int4* __restrict__ src, int4* __restrict__ dst, int64_t n4) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int64_t stride = (int64_t)gridDim.x * kCopyThreads;
  for (int64_t first = (int64_t)blockIdx.x * kCopyThreads + threadIdx.x;
       first < n4; first += kUnroll * stride) {
    int4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (first + u * stride < n4) r[u] = __ldcs(src + first + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (first + u * stride < n4) __stcs(dst + first + u * stride, r[u]);
  }
}

__global__ void scatter(const int* __restrict__ slots,
                        const int* __restrict__ vals, int64_t n, int64_t cap,
                        int* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t s = -1;
  int v = 0;
  if (i < n) {
    s = slots[i];
    v = vals[i];
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (s >= 0 && s < cap) out[s] = v;
}

__global__ void __launch_bounds__(kCopyThreads) cooperative_rmw(
    const int4* __restrict__ src, const int* __restrict__ slots,
    const int* __restrict__ vals, int64_t n, int64_t cap,
    int* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kCopyThreads;
  const int64_t t = (int64_t)blockIdx.x * kCopyThreads + threadIdx.x;
  int64_t s0 = -1;
  int v0 = 0;
  if (t < n) {
    s0 = slots[t];
    v0 = vals[t];
  }
  int4* dst = reinterpret_cast<int4*>(out);
  const int64_t n4 = cap / 4;
  for (int64_t first = t; first < n4; first += kUnroll * stride) {
    int4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (first + u * stride < n4) r[u] = __ldcs(src + first + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (first + u * stride < n4) __stcs(dst + first + u * stride, r[u]);
  }
  cg::this_grid().sync();
  if (s0 >= 0 && s0 < cap) out[s0] = v0;
  for (int64_t i = t + stride; i < n; i += stride)
    if (slots[i] >= 0 && slots[i] < cap) out[slots[i]] = vals[i];
}

// K2 forward
template <typename I>
__global__ void k2f_old(const float4* __restrict__ values, int64_t ld,
                        int64_t n_rows, const I* __restrict__ slots,
                        const bool* __restrict__ valid, int64_t n_bags,
                        float4* __restrict__ out) {
  const int lanes = 4, d = 4;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t b = t / lanes;
  if (b >= n_bags) return;
  const int c = (int)(t - b * lanes);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid[b]) {
    int64_t s = (int64_t)slots[b];
    s = s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s);
    acc = add4(acc, __ldg(values + s * ld + c));
  }
  out[b * d + c] = acc;
}

// kMode 1-5 of the list above; the grid is one warp per 32 bags
template <int kMode, typename I>
__global__ void k2f_variant(const float4* __restrict__ values, int64_t ld,
                            int64_t n_rows, const I* __restrict__ slots,
                            const bool* __restrict__ valid, int64_t n_bags,
                            float4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane;
  if (kMode == 1) {
    if (out == nullptr) out[b0] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  if (b0 >= n_bags) return;
  const int nb = n_bags - b0 < 32 ? (int)(n_bags - b0) : 32;
  const int units = nb * 4;
  float4* tile_out = out + b0 * 4;
  if (kMode == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = 32 * j + lane;
      if (u < units) tile_out[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int64_t b = b0 + lane;
  bool ok = false;
  int64_t row = 0;
  if (b < n_bags) {
    ok = valid[b];
    row = (int64_t)slots[b];
  }
  row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
  if (kMode == 2) {  // keep the loads live
    if (ok && row == n_rows + 7) out[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const unsigned oks = __ballot_sync(kFull, ok);
  float4 x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int u = 32 * j + lane;
    const int q = (u >> 2) & 31;
    const int64_t r = __shfl_sync(kFull, row, q);
    x[j] = u < units && (oks >> q & 1u) ? __ldg(values + r * ld + (u & 3))
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (kMode == 3) {
    if (x[0].x == 12345.f && x[1].y == 5.f && x[2].z == 7.f && x[3].w == 9.f)
      out[0] = x[1];
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int u = 32 * j + lane;
    if (u < units) tile_out[u] = x[j];
  }
}

// modes 5-12 with kStream (st.global.cs), kPdl (griddepcontrol) and
// kTiles tiles of 32 bags a warp; kZeros: stores only
template <bool kStream, bool kPdl, int kTiles, bool kZeros, typename I>
__global__ void k2f_full(const float4* __restrict__ values, int64_t ld,
                         int64_t n_rows, const I* __restrict__ slots,
                         const bool* __restrict__ valid, int64_t n_bags,
                         float4* __restrict__ out) {
  if (kPdl) asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int64_t b0 =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane) * kTiles;
  if (kPdl) asm volatile("griddepcontrol.wait;" ::: "memory");
  if (b0 >= n_bags) return;
  float4 x[4 * kTiles];
  int units[kTiles];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int64_t tb = b0 + 32 * t;
    const int64_t left = n_bags - tb;
    const int nb = left <= 0 ? 0 : left < 32 ? (int)left : 32;
    units[t] = nb * 4;
    bool ok = false;
    int64_t row = 0;
    if (!kZeros && lane < nb) {
      ok = valid[tb + lane];
      row = (int64_t)slots[tb + lane];
    }
    row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
    const unsigned oks = __ballot_sync(kFull, ok);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = 32 * j + lane;
      const int q = (u >> 2) & 31;
      const int64_t r = __shfl_sync(kFull, row, q);
      x[4 * t + j] = u < units[t] && (oks >> q & 1u)
                         ? __ldg(values + r * ld + (u & 3))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = 32 * j + lane;
      float4* o = out + (b0 + 32 * t) * 4 + u;
      if (u < units[t]) {
        if (kStream) __stcs(o, x[4 * t + j]);
        else *o = x[4 * t + j];
      }
    }
  }
}

template <typename I>
cudaError_t probe_k2f_typed(int mode, const float4* values, int64_t ld,
                            int64_t n_rows, const I* slots, const bool* valid,
                            int64_t n, float4* out, cudaStream_t st) {
  if (mode == 0) {
    const int64_t blocks = (n * 4 + 255) / 256;
    k2f_old<I><<<(unsigned)blocks, 256, 0, st>>>(values, ld, n_rows, slots,
                                                 valid, n, out);
    return cudaGetLastError();
  }
  if (mode < 1 || mode > 14) return cudaErrorInvalidValue;
  using K = void (*)(const float4*, int64_t, int64_t, const I*, const bool*,
                     int64_t, float4*);
  const K kernels[15] = {nullptr,
                         k2f_variant<1, I>,
                         k2f_variant<2, I>,
                         k2f_variant<3, I>,
                         k2f_variant<4, I>,
                         k2f_variant<5, I>,
                         k2f_variant<5, I>,
                         k2f_variant<5, I>,
                         k2f_variant<5, I>,
                         k2f_full<true, false, 1, false, I>,
                         k2f_full<true, false, 1, true, I>,
                         k2f_full<false, false, 2, false, I>,
                         k2f_full<false, true, 1, false, I>,
                         k2f_full<false, true, 1, false, I>,
                         k2f_full<false, true, 1, false, I>};
  const int threads = mode == 6 || mode == 13   ? 128
                      : mode == 7 || mode == 14 ? 512
                      : mode == 8               ? 1024
                                                : 256;
  const int tiles = mode == 11 ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + threads * tiles - 1) / (threads * tiles)));
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = mode >= 12 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernels[mode], values, ld, n_rows, slots,
                            valid, n, out);
}

// K1
template <typename U, typename I>
__global__ void k1_old(const U* __restrict__ values, int64_t ld_units,
                       int64_t n_rows, const I* __restrict__ slots, int64_t n,
                       int64_t row_units, U* __restrict__ out, int lanes) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t i = t / lanes;
  if (i >= n) return;
  int lane = (int)(t - i * lanes);
  int64_t s = (int64_t)slots[i];
  s = s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s);
  const U* src = values + s * ld_units;
  U* dst = out + i * row_units;
  for (int64_t c = lane; c < row_units; c += lanes) dst[c] = __ldg(src + c);
}

// variant 1 (kSlots false) and 2 (kSlots true), on the port's parameters
template <typename U, typename I, int kRows, bool kSlots>
__global__ void __launch_bounds__(k1::kThreads) k1_part(
    const U* __restrict__ values, int64_t ld, int64_t n_rows,
    const I* __restrict__ slots, int64_t n, int row_units,
    U* __restrict__ out, int lanes_log2) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (!kSlots) {
    if (out == nullptr) out[0] = values[0];
    return;
  }
  const int lane = threadIdx.x & 31;
  const int sub = lane >> lanes_log2;
  const int g_log2 = 5 - lanes_log2;
  int tile_log2 = g_log2;
  for (int r = kRows; r > 1; r >>= 1) ++tile_log2;
  const int64_t step = ((int64_t)gridDim.x * k1::kWarps) << tile_log2;
  int64_t acc = 0;
  for (int64_t t0 = ((int64_t)blockIdx.x * k1::kWarps + (threadIdx.x >> 5))
                    << tile_log2;
       t0 < n; t0 += step) {
    const int left = n - t0 < (1 << tile_log2) ? (int)(n - t0)
                                               : 1 << tile_log2;
    I s[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int j = (k << 5) + lane;
      s[k] = j < left ? (I)k1::clamp_slot(slots[t0 + j], n_rows) : (I)0;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int k = (r << g_log2) >> 5;
      I v = s[0];
#pragma unroll
      for (int q = 1; q < kRows; ++q) v = q == k ? s[q] : v;
      acc += __shfl_sync(kFull, v, (((r << g_log2) + sub) & 31));
    }
  }
  if (acc == n_rows * 1000003 + 7) out[0] = values[0];  // keep them live
}

constexpr int kBulkRows = 128;  // rows of a block tile

template <typename I>
__global__ void __launch_bounds__(kBulkRows) k1_bulk(
    const char* __restrict__ values, int64_t ld_bytes, int64_t n_rows,
    const I* __restrict__ slots, int64_t n, int row_bytes,
    char* __restrict__ out) {
  extern __shared__ __align__(128) char tile[];  // kBulkRows * row_bytes
  __shared__ __align__(8) uint64_t bar;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const unsigned bar_s = (unsigned)__cvta_generic_to_shared(&bar);
  const unsigned tile_s = (unsigned)__cvta_generic_to_shared(tile);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_s)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  unsigned phase = 0;
  bool first = true;
  for (int64_t t0 = (int64_t)blockIdx.x * kBulkRows; t0 < n;
       t0 += (int64_t)gridDim.x * kBulkRows) {
    const int rows = n - t0 < kBulkRows ? (int)(n - t0) : kBulkRows;
    if (threadIdx.x == 0) {
      // the previous tile's store has read the buffer
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar_s), "r"(rows * row_bytes)
                   : "memory");
    }
    __syncthreads();
    if ((int)threadIdx.x < rows) {
      const int64_t s = k1::clamp_slot(slots[t0 + threadIdx.x], n_rows);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(tile_s + threadIdx.x * row_bytes),
          "l"(values + s * ld_bytes), "r"(row_bytes), "r"(bar_s)
          : "memory");
    }
    if (first) asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    first = false;
    asm volatile(
        "{\n .reg .pred p;\n WAIT:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        " @!p bra WAIT;\n}" ::"r"(bar_s),
        "r"(phase)
        : "memory");
    phase ^= 1u;
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              out + t0 * row_bytes),
          "r"(tile_s), "r"(rows * row_bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <typename I>
cudaError_t k1_bulk_launch(const void* values, int64_t ld_bytes,
                           int64_t n_rows, const I* slots, int64_t n,
                           int64_t row_bytes, void* out, cudaStream_t st) {
  if (row_bytes % 16 || ld_bytes % 16 || row_bytes > 256)  // 32 KB a tile
    return cudaErrorInvalidValue;
  const int smem = kBulkRows * (int)row_bytes;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k1_bulk<I>, kBulkRows, smem);
  if (e != cudaSuccess) return e;
  const int64_t tiles = (n + kBulkRows - 1) / kBulkRows;
  const int64_t wave = (int64_t)k1::card().sms * per_sm;
  return launch(true, k1_bulk<I>, (int)(tiles < wave ? tiles : wave),
                kBulkRows, smem, st, (const char*)values, ld_bytes, n_rows,
                slots, n, (int)row_bytes, (char*)out);
}

template <typename U, typename I, int kRows>
cudaError_t k1_rows(int mode, const k1::Plan& p, const U* values, int64_t ld,
                    int64_t n_rows, const I* slots, int64_t n, int row_units,
                    U* out, cudaStream_t st) {
  const auto kernel = mode == 1   ? k1_part<U, I, kRows, false>
                      : mode == 2 ? k1_part<U, I, kRows, true>
                                  : k1::gather_rows_kernel<U, I, kRows>;
  return launch(mode != 3, kernel, (int)p.blocks, k1::kThreads, 0, st, values,
                ld, n_rows, slots, n, row_units, out, p.lanes_log2);
}

template <typename U, typename I>
cudaError_t k1_variant(int mode, const void* values, int64_t ld_bytes,
                       int64_t n_rows, const void* slots, int64_t n,
                       int64_t row_bytes, void* out, cudaStream_t st) {
  const int64_t row_units = row_bytes / (int64_t)sizeof(U);
  const int64_t ld = ld_bytes / (int64_t)sizeof(U);
  const U* v = (const U*)values;
  const I* s = (const I*)slots;
  U* o = (U*)out;
  if (mode == 0) {
    int lanes = 1;
    while (lanes < 32 && lanes < row_units) lanes <<= 1;
    const int64_t blocks = (n * lanes + 255) / 256;
    k1_old<U, I><<<(unsigned)blocks, 256, 0, st>>>(v, ld, n_rows, s, n,
                                                   row_units, o, lanes);
    return cudaGetLastError();
  }
  if (mode == 4)
    return k1_bulk_launch<I>(values, ld_bytes, n_rows, s, n, row_bytes, out,
                             st);
  if (mode < 1 || mode > 8) return cudaErrorInvalidValue;
  k1::Plan p = k1::plan_for<U, I>(n, row_units);
  const int g_log2 = 5 - p.lanes_log2;
  if (mode >= 5) p.rows = 1 << (mode - 5);
  if (mode == 5) p.blocks = k1::grid_blocks<U, I, 1>(n, g_log2);
  if (mode == 6) p.blocks = k1::grid_blocks<U, I, 2>(n, g_log2);
  if (mode == 7) p.blocks = k1::grid_blocks<U, I, 4>(n, g_log2);
  if (mode == 8) p.blocks = k1::grid_blocks<U, I, 8>(n, g_log2);
  const int m = mode >= 5 ? 0 : mode;
  const int ru = (int)row_units;
  switch (p.rows) {
    case 1: return k1_rows<U, I, 1>(m, p, v, ld, n_rows, s, n, ru, o, st);
    case 2: return k1_rows<U, I, 2>(m, p, v, ld, n_rows, s, n, ru, o, st);
    case 4: return k1_rows<U, I, 4>(m, p, v, ld, n_rows, s, n, ru, o, st);
    default: return k1_rows<U, I, 8>(m, p, v, ld, n_rows, s, n, ru, o, st);
  }
}

template <typename U>
cudaError_t k1_unit(int mode, const void* values, int64_t ld_bytes,
                    int64_t n_rows, const void* slots, int slots_are_64,
                    int64_t n, int64_t row_bytes, void* out, cudaStream_t st) {
  return slots_are_64 ? k1_variant<U, int64_t>(mode, values, ld_bytes, n_rows,
                                               slots, n, row_bytes, out, st)
                      : k1_variant<U, int32_t>(mode, values, ld_bytes, n_rows,
                                               slots, n, row_bytes, out, st);
}

}  // namespace

namespace {
namespace ht_old {

using ht::block_sum;
using ht::bucket_base;
using ht::kEmpty;
using ht::kThreads;
using ht::ld_l2;
using ht::ld_nc;
using ht::probe_masks;
constexpr int kDone = 0, kPending = 1, kWant = 2;

// K4's previous design: (slots, found) for n keys; one half-warp a key.
__global__ void __launch_bounds__(kThreads) lookup_kernel(
    const int64_t* __restrict__ plane, int64_t cap, int w, uint32_t bmask,
    const int64_t* __restrict__ keys, int64_t n, int max_probes,
    int64_t* __restrict__ slots, bool* __restrict__ found) {
  const int l = threadIdx.x & 15;
  const int64_t halves = (int64_t)gridDim.x * (kThreads / 16);
  for (int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 4;
       i < n; i += halves) {  // the same i on the half's 16 lanes
    const int64_t key = keys[i];
    int64_t slot = cap;
    if (key != kEmpty) {  // EMPTY keys are never found
      for (int off = 0; off < max_probes; ++off) {
        const int64_t base = bucket_base(key, off, w, bmask);
        const int64_t kw = l < w ? ld_nc(plane + base + l) : 0;
        unsigned match, empty;
        probe_masks(kw, key, w, &match, &empty);
        if (match) {
          slot = base + __ffs(match) - 1;
          break;
        }
        if (empty) break;  // a bucket with an empty lane proves absence
      }
    }
    if (l == 0) {
      slots[i] = slot;
      found[i] = slot != cap;
    }
  }
}

// K5's previous design. scratch (int32): state [n], off [n], target [n]
// (the claimed slot), arb [cap] (the arbitration words), pending
// [max_rounds] (the count of keys left after each round); the kernel
// initialises all of it.
__global__ void __launch_bounds__(kThreads) lookup_or_insert_kernel(
    const int64_t* __restrict__ plane_in, int64_t* plane, int64_t cap, int w,
    uint32_t bmask, const int64_t* __restrict__ ukeys, int64_t n,
    int max_probes, int max_rounds, const int64_t* __restrict__ size_in,
    const int64_t* __restrict__ overflow_in, int64_t* size,
    int64_t* overflow, int64_t* slots, bool* created, int32_t* scratch) {
  cg::grid_group grid = cg::this_grid();
  int32_t* state = scratch;
  int32_t* off = state + n;
  int32_t* target = off + n;
  uint32_t* arb = reinterpret_cast<uint32_t*>(target + n);
  uint32_t* pending = arb + cap;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * kThreads;
  const int l = threadIdx.x & 15;

  // the plane's copy, zeroed arbitration words and counts, each key's state
  for (int64_t j = tid; j < cap; j += threads) {
    plane[j] = plane_in[j];
    arb[j] = 0;
  }
  for (int64_t j = tid; j < max_rounds; j += threads) pending[j] = 0;
  if (tid == 0) {
    *size = *size_in;
    *overflow = *overflow_in;
  }
  for (int64_t i = tid; i < n; i += threads) {
    state[i] = ukeys[i] != kEmpty ? kPending : kDone;
    off[i] = 0;
    slots[i] = cap;
    created[i] = false;
  }
  unsigned long long made = 0;  // the keys this thread's lanes created
  grid.sync();

  for (int r = 0; r < max_rounds; ++r) {
    // read, hit, claim, advance: one half-warp a key
    for (int64_t i = tid >> 4; i < n; i += threads >> 4) {
      if (__ldcg(state + i) != kPending) continue;  // the same on the half
      const int64_t key = ukeys[i];
      const int o = __ldcg(off + i);
      const int64_t base = bucket_base(key, o, w, bmask);
      const int64_t kw = l < w ? ld_l2(plane + base + l) : 0;
      unsigned match, empty;
      probe_masks(kw, key, w, &match, &empty);
      if (l == 0) {
        if (match) {  // a key stored before this call (keys are unique)
          slots[i] = base + __ffs(match) - 1;
          state[i] = kDone;
        } else if (empty) {  // the first empty lane; the lowest rank wins
          const int64_t t = base + __ffs(empty) - 1;
          target[i] = (int32_t)t;
          atomicMax(arb + t, ~(uint32_t)i);
          state[i] = kWant;
        } else {  // a full bucket: the next one next round
          off[i] = o + 1;
        }
      }
    }
    grid.sync();
    // commit: one thread a key
    unsigned long long left = 0;
    for (int64_t i = tid; i < n; i += threads) {
      int s = __ldcg(state + i);
      if (s == kDone) continue;
      if (s == kWant) {
        const int32_t t = __ldcg(target + i);
        if (__ldcg(arb + t) == ~(uint32_t)i) {
          plane[t] = ukeys[i];
          slots[i] = t;
          created[i] = true;
          state[i] = kDone;
          ++made;
          continue;
        }
        s = kPending;  // lost: the same bucket next round
      }
      // past the probe bound a key can neither match nor claim
      if (__ldcg(off + i) >= max_probes) s = kDone;
      else ++left;
      state[i] = s;
    }
    const unsigned long long sum = block_sum(left);
    if (threadIdx.x == 0 && sum) atomicAdd(pending + r, (uint32_t)sum);
    grid.sync();
    if (__ldcg(pending + r) == 0) break;  // the same in every thread
  }

  // size += created, overflow += the valid keys left without a slot
  unsigned long long failed = 0;
  for (int64_t i = tid; i < n; i += threads)
    failed += ukeys[i] != kEmpty && ld_l2(slots + i) == cap;
  const unsigned long long m = block_sum(made);
  const unsigned long long f = block_sum(failed);
  if (threadIdx.x == 0) {
    if (m) atomicAdd(reinterpret_cast<unsigned long long*>(size), m);
    if (f) atomicAdd(reinterpret_cast<unsigned long long*>(overflow), f);
  }
}


// One grid barrier, nothing else (K5 variant 2).
__global__ void __launch_bounds__(kThreads) barrier_only() {
  cg::this_grid().sync();
}

}  // namespace ht_old

// K4 as probe mode `mode` (see the top of the file).
cudaError_t probe_k4_launch(int mode, const void* plane, int64_t cap,
                            const void* keys, int64_t n, int max_probes,
                            void* slots, void* found, cudaStream_t st) {
  switch (mode) {
    case 0: {
      int w;
      uint32_t bmask;
      ht::geometry(cap, &w, &bmask);
      static int per_sm = 0;
      const int64_t wave =
          (int64_t)sm_count() *
          resident_blocks(ht_old::lookup_kernel, kThreads, &per_sm);
      int64_t blocks = (n * 16 + kThreads - 1) / kThreads;
      if (wave > 0 && blocks > wave) blocks = wave;
      ht_old::lookup_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
          (const int64_t*)plane, cap, w, bmask, (const int64_t*)keys, n,
          max_probes, (int64_t*)slots, (bool*)found);
      return cudaGetLastError();
    }
    case 1:
      return ht::launch_lookup<4>(plane, cap, keys, n, max_probes, slots,
                                  found, st, true);
    case 2:
      return ht::launch_lookup<8>(plane, cap, keys, n, max_probes, slots,
                                  found, st, true);
    case 3:
      return ht::launch_lookup<16>(plane, cap, keys, n, max_probes, slots,
                                   found, st, true);
    case 4:
      return ht::launch_lookup<ht::kLookupRun>(plane, cap, keys, n,
                                               max_probes, slots, found, st,
                                               false);
    case 5:
      return ht::launch_lookup<2>(plane, cap, keys, n, max_probes, slots,
                                  found, st, true);
    case 6:
      return ht::launch_lookup<1>(plane, cap, keys, n, max_probes, slots,
                                  found, st, true);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K4 probe variants: deeprec_hash_lookup's arguments after the mode.
extern "C" int probe_k4(int mode, const void* plane, int64_t cap,
                        const void* keys, int64_t n, int max_probes,
                        void* slots, void* found, void* stream) {
  if (n == 0) return 0;
  return (int)probe_k4_launch(mode, plane, cap, keys, n, max_probes, slots,
                              found, (cudaStream_t)stream);
}

// K5 probe variants. Mode 0 (the previous design) reads plane_in, size_in
// and overflow_in and writes plane, size and overflow (a new table);
// scratch: int32 [3 n + cap + max_probes + w]. Modes 1 and 3-6 (the port's
// kernel) work in place on plane, size and overflow; scratch: int32 [2 n];
// arb: deeprec_hash_lookup_or_insert's arbitration words.
extern "C" int probe_k5(int mode, const void* plane_in, void* plane,
                        int64_t cap, const void* ukeys, int64_t n,
                        int max_probes, const void* size_in,
                        const void* overflow_in, void* size, void* overflow,
                        void* slots, void* created, void* scratch, void* arb,
                        void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 1)
    return (int)ht::launch_insert<ht::kInsertRun>(
        plane, cap, ukeys, n, max_probes, size, overflow, slots, created,
        scratch, arb, st, true);
  if (mode == 2)
    return (int)launch_cooperative(
        ht_old::barrier_only, ht::insert_blocks<ht::kInsertRun>(n, false),
        kThreads, st);
  if (mode >= 3 && mode <= 6) {
    const auto run = mode == 3   ? ht::launch_insert<2>
                     : mode == 4 ? ht::launch_insert<4>
                     : mode == 5 ? ht::launch_insert<8>
                                 : ht::launch_insert<16>;
    return (int)run(plane, cap, ukeys, n, max_probes, size, overflow, slots,
                    created, scratch, arb, st, false);
  }
  if (mode != 0) return (int)cudaErrorInvalidValue;
  int w;
  uint32_t bmask;
  ht::geometry(cap, &w, &bmask);
  static int per_sm = 0;
  const int64_t blocks =
      (int64_t)sm_count() *
      resident_blocks(ht_old::lookup_or_insert_kernel, kThreads, &per_sm);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  return (int)launch_cooperative(
      ht_old::lookup_or_insert_kernel, blocks, kThreads, st,
      (const int64_t*)plane_in, (int64_t*)plane, cap, w, bmask,
      (const int64_t*)ukeys, n, max_probes, max_probes + w,
      (const int64_t*)size_in, (const int64_t*)overflow_in, (int64_t*)size,
      (int64_t*)overflow, (int64_t*)slots, (bool*)created,
      (int32_t*)scratch);
}

// deeprec_gather_rows's arguments after the mode (unit: the vector unit in
// bytes, as the wrapper picks it: 16 or 4 at the shapes probed; variant 4
// needs 16).
extern "C" int probe_k1(int mode, const void* values, int64_t ld_bytes,
                        int64_t n_rows, const void* slots, int slots_are_64,
                        int64_t n, int64_t row_bytes, void* out, int unit,
                        void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 4 && unit != 16) return (int)cudaErrorInvalidValue;
  switch (unit) {
    case 16: return (int)k1_unit<uint4>(mode, values, ld_bytes, n_rows, slots,
                                        slots_are_64, n, row_bytes, out, st);
    case 4: return (int)k1_unit<uint32_t>(mode, values, ld_bytes, n_rows,
                                          slots, slots_are_64, n, row_bytes,
                                          out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dp [n, 16] f32, slots int32 [n], valid bool [n], out [n_rows, 16] f32.
extern "C" int probe_k2(int mode, const void* dp, const void* slots,
                        const void* valid, int64_t n, void* out,
                        int64_t n_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  const int zero_blocks = (int)((n_rows * 4 + kThreads - 1) / kThreads);
  auto args = [&](auto kernel, bool dep) {
    return launch(dep, kernel, blocks, kThreads, 0, st, (const float4*)dp,
                  (const int*)slots, (const bool*)valid, n, (float4*)out,
                  (int)n_rows);
  };
  switch (mode) {
    case 0: empty_kernel<<<blocks, kThreads, 0, st>>>(nullptr); break;
    case 1: return args(k2_variant<1>, false);
    case 2: return args(k2_variant<2>, false);
    case 3: return args(k2_variant<3>, false);
    case 4: return args(k2_variant<4>, false);
    case 5: return args(k2_variant<5>, false);
    case 6: return args(k2_variant<6>, false);
    case 7: return args(k2_variant<7>, false);
    case 8:
    case 9:
      zero_fill<<<zero_blocks, kThreads, 0, st>>>((float4*)out, n_rows * 4);
      return args(k2_variant<5>, mode == 9);
    case 10: {
      const int smem = kTile * 64;
      cudaError_t e = cudaFuncSetAttribute(
          k2_block_sorted, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      int bits = 1;
      while ((1ll << bits) - 1 < n_rows) ++bits;
      zero_fill<<<zero_blocks, kThreads, 0, st>>>((float4*)out, n_rows * 4);
      return launch(true, k2_block_sorted, (int)((n + kTile - 1) / kTile),
                    kThreads, smem, st, (const float4*)dp, (const int*)slots,
                    (const bool*)valid, n, (float4*)out, (int)n_rows, bits);
    }
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// plane int32 [>= cap] (cap % 4 == 0, 16-byte aligned), slots/vals int32
// [n], out int32 [cap].
extern "C" int probe_k3b(int mode, const void* plane, const void* slots,
                         const void* vals, int64_t n, int64_t cap, void* out,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t n4 = cap / 4;
  const int one_pass = (int)((n4 + kCopyThreads * kUnroll - 1) /
                             (kCopyThreads * kUnroll));
  const int scatter_blocks = (int)((n + 255) / 256);
  if (mode == 3) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cooperative_rmw,
                                                  kCopyThreads, 0);
    const int blocks = one_pass < sms * per_sm ? one_pass : sms * per_sm;
    const int4* src = (const int4*)plane;
    const int* s = (const int*)slots;
    const int* v = (const int*)vals;
    int* o = (int*)out;
    void* kargs[] = {(void*)&src, (void*)&s, (void*)&v, (void*)&n, (void*)&cap,
                     (void*)&o};
    return cudaLaunchCooperativeKernel((const void*)cooperative_rmw, blocks,
                                       kCopyThreads, kargs, 0, st);
  }
  const int blocks = mode == 2 && sms < one_pass ? sms : one_pass;
  plane_copy<<<blocks, kCopyThreads, 0, st>>>((const int4*)plane, (int4*)out,
                                              n4);
  if (mode == 4) return (int)cudaGetLastError();
  return launch(mode != 1, scatter, scatter_blocks, 256, 0, st,
                (const int*)slots, (const int*)vals, n, cap, (int*)out);
}

// values [n_rows, 4] float4 with row stride ld (float4 units), slots int32
// or int64 [n] (slots_are_64), valid bool [n], out [n, 16] f32.
extern "C" int probe_k2f(int mode, const void* values, int64_t ld,
                         int64_t n_rows, const void* slots, int slots_are_64,
                         const void* valid, int64_t n, void* out,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (slots_are_64)
    return (int)probe_k2f_typed(mode, (const float4*)values, ld, n_rows,
                                (const int64_t*)slots, (const bool*)valid, n,
                                (float4*)out, st);
  return (int)probe_k2f_typed(mode, (const float4*)values, ld, n_rows,
                              (const int32_t*)slots, (const bool*)valid, n,
                              (float4*)out, st);
}
