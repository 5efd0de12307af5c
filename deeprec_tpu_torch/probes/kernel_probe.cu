// Design probes for K2 (both directions) and K3b on the card: variants of
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
//
// K3b variants (int4 copy of plane[:cap], then U int32 stores), selected
// by probe_k3b's mode:
//   0 copy on blocks of one pass each (128 at CAP 2^21), then the scatter
//     as its programmatic dependent (the port's design)
//   1 the same two kernels as ordinary launches
//   2 copy on one block per SM, striding, then the dependent scatter
//   3 one cooperative launch: copy, grid barrier, scatter
//   4 the copy alone
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

}  // namespace

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
