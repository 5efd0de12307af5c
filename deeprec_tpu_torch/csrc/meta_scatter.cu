// K3a and K3b: the EmbeddingVariable metadata writes at unique slots.
//
// K3a replaces the Pallas TPU kernel benchmarks/pallas_meta_bench.py
// pallas_dma_stores (_dma_kernel), which issued one DMA per slot and never
// compiled on the TPU (Mosaic's (1024,) tiling forbids 1-element HBM
// slices). On Hopper a 4-byte store to any address is one instruction.
// The indices below cap are unique by construction (the resolver's slots
// of distinct keys), so plain stores and a plain read-modify-write of the
// freq suffice: no two threads touch one element, no atomics are needed.
// A lane whose index lies outside [0, cap) is skipped, so row cap (the
// shared null row) keeps -1/-1/0. Any plane may be absent (a null
// pointer). Two entries, one thread per lane each:
//
// lookup_meta (the training path's): the whole metadata step of a
// host-index lookup_or_create over its U unique lanes,
//   live     = counts[i] > 0 && uslots[i] != cap && !readonly
//   create_steps[dest[i]]  = gs
//   versions[uslots[i]]    = gs                 where live
//   freqs[uslots[i]]      += counts[i]          where live (add_freqs)
//   admitted[i] = uslots[i] != cap && (no filter ||
//                 freqs[uslots[i]] >= filter_freq, after the add)
// Its bytes (~0.5 MB a Criteo step) take 0.0001 ms at HBM rate: what it
// costs is the launch. So it takes over the lane arithmetic around the
// writes (live, the masked index, the admission test), which were ten
// more launches of the same floor, and it is launched as a programmatic
// dependent of the work before it (griddepcontrol), so its own launch
// overlaps that work's end; every thread waits for that work before it
// touches memory. A lane's admission reads the freq its own add left in a
// register; a lane that does not add (readonly, no count) reads the
// plane, which no other lane writes at that slot.
//
// meta_scatter (the benchmark's function, off the training path):
//   create_steps[dest[i]]  = gs
//   versions[mdest[i]]     = gs
//   freqs[mdest[i]]       += counts[i]
// With only one plane this is scatter_set, one scalar to a plane at U
// slots, the Pallas kernel's own function.
//
// Both are bound by HBM bytes: the lanes read once, and one 4-byte element
// written (and, for the freq, read) per plane and lane; each scattered
// element costs a 32-byte sector of traffic in practice.
//
// K3b, blocked_rmw_set (out of place).
//   out = plane[:cap]; out[slots[i]] = vals[i] for 0 <= slots[i] < cap
// Replaces benchmarks/pallas_meta_bench.py pallas_blocked_rmw
// (_rmw_kernel), which streamed the plane through VMEM in 64K-element
// blocks (it did not compile on the TPU either: no scatter lowering).
// Bound by HBM bytes: the whole plane read and written once (2 x 4 x cap
// bytes) plus the U slots and values. On Hopper the VMEM tile has no use:
// nothing is read twice, and a block that scans all U updates for its own
// tile (the TPU kernel's shape) reads them 128 times from L2. So two
// kernels, one per pass. plane_copy_kernel streams plane -> out with
// 16-byte accesses in one pass, each thread keeping kUnroll loads in
// flight (128 blocks at CAP 2^21). scatter_updates_kernel, one thread per
// update, stores the updates after it; it is launched as the copy's
// programmatic dependent (griddepcontrol), so its blocks start while the
// copy streams, load their slot and value, and wait only before the
// store for the copy to finish and become visible: the kernel boundary
// is the grid-wide barrier. The slots below cap are unique (a resolver's
// slots), so no two updates collide. It is not on the training path: it
// computes K3b's function so the card can answer the benchmark's question
// (stream the plane, or scatter).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kCopyThreads = 1024;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread

template <typename I>
__global__ void meta_scatter_kernel(int32_t* __restrict__ create_steps,
                                    const I* __restrict__ dest,
                                    int32_t* __restrict__ versions,
                                    int32_t* __restrict__ freqs,
                                    const I* __restrict__ mdest,
                                    const int32_t* __restrict__ counts,
                                    int32_t gs, int64_t n, int64_t cap) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (create_steps != nullptr) {
    int64_t s = (int64_t)dest[i];
    if (s >= 0 && s < cap) create_steps[s] = gs;
  }
  if (versions != nullptr || freqs != nullptr) {
    int64_t s = (int64_t)mdest[i];
    if (s >= 0 && s < cap) {
      if (versions != nullptr) versions[s] = gs;
      if (freqs != nullptr) freqs[s] += counts[i];
    }
  }
}

template <typename I>
__global__ void lookup_meta_kernel(
    const I* __restrict__ uslots, const int32_t* __restrict__ counts,
    const bool* __restrict__ readonly, const I* __restrict__ dest,
    int32_t* __restrict__ create_steps, int32_t* __restrict__ versions,
    int32_t* __restrict__ freqs, int add_freqs, int filter,
    int32_t filter_freq, bool* __restrict__ admitted, int32_t gs, int64_t n,
    int64_t cap) {
  launch_dependents();
  // the work before this launch has finished: admitted may be memory the
  // allocator just reused
  wait_for_prerequisite();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // every load of the lane at once: the flag is one byte all lanes share
  const int64_t s = (int64_t)uslots[i];
  const int32_t c = counts[i];
  const bool ro = *readonly;
  const int64_t d = create_steps != nullptr ? (int64_t)dest[i] : -1;
  if (d >= 0 && d < cap) create_steps[d] = gs;
  const bool in = s >= 0 && s < cap;
  const bool live = in && c > 0 && !ro;
  int32_t f = 0;
  if (live && versions != nullptr) versions[s] = gs;
  if (live && add_freqs) {
    f = freqs[s] + c;
    freqs[s] = f;
  } else if (filter && in) {
    f = freqs[s];
  }
  admitted[i] = s != cap && (!filter || (in && f >= filter_freq));
}

// Copies src[0, n) to dst in units of W (int4, or int32 when unaligned):
// the grid covers n in one pass, each thread loading its kUnroll units
// before storing them. A thread's units lie one grid-width apart, so the
// whole grid streams through one region of the plane at a time.
template <typename W>
__device__ __forceinline__ void copy_units(const W* __restrict__ src,
                                           W* __restrict__ dst, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kCopyThreads;
  const int64_t first = (int64_t)blockIdx.x * kCopyThreads + threadIdx.x;
  W r[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (first + u * stride < n) r[u] = __ldcs(src + first + u * stride);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (first + u * stride < n) __stcs(dst + first + u * stride, r[u]);
}

// out[0, cap) = plane[0, cap); with vec4, as int4 and then, in block 0,
// the cap % 4 elements past the last int4. Lets the dependent scatter
// launch at once.
__global__ void __launch_bounds__(kCopyThreads) plane_copy_kernel(
    const int32_t* __restrict__ plane, int32_t* __restrict__ out, int64_t cap,
    int vec4) {
  launch_dependents();
  if (!vec4) {
    copy_units(plane, out, cap);
    return;
  }
  const int64_t n4 = cap / 4;
  copy_units(reinterpret_cast<const int4*>(plane),
             reinterpret_cast<int4*>(out), n4);
  if (blockIdx.x == 0 && threadIdx.x < cap - 4 * n4)
    out[4 * n4 + threadIdx.x] = plane[4 * n4 + threadIdx.x];
}

template <typename I>
__global__ void scatter_updates_kernel(const I* __restrict__ slots,
                                       const int32_t* __restrict__ vals,
                                       int64_t n, int64_t cap,
                                       int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t s = -1;
  int32_t v = 0;
  if (i < n) {
    s = (int64_t)slots[i];
    v = vals[i];
  }
  wait_for_prerequisite();  // the copy has finished, its stores visible
  if (s >= 0 && s < cap) out[s] = v;
}

}  // namespace

// int32 planes of at least cap+1 elements, each may be null; dest/mdest
// int32 or int64 [n] (idx_are_64), counts int32 [n] (read only with
// freqs). Returns the launch's cudaError_t; 0 is success. Never syncs.
extern "C" int deeprec_meta_scatter(void* create_steps, const void* dest,
                                    void* versions, void* freqs,
                                    const void* mdest, const void* counts,
                                    int idx_are_64, int gs, int64_t n,
                                    int64_t cap, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  if (idx_are_64)
    meta_scatter_kernel<int64_t><<<(unsigned)blocks, threads, 0, st>>>(
        (int32_t*)create_steps, (const int64_t*)dest, (int32_t*)versions,
        (int32_t*)freqs, (const int64_t*)mdest, (const int32_t*)counts,
        (int32_t)gs, n, cap);
  else
    meta_scatter_kernel<int32_t><<<(unsigned)blocks, threads, 0, st>>>(
        (int32_t*)create_steps, (const int32_t*)dest, (int32_t*)versions,
        (int32_t*)freqs, (const int32_t*)mdest, (const int32_t*)counts,
        (int32_t)gs, n, cap);
  return (int)cudaGetLastError();
}

// uslots and dest int32 or int64 [n] (idx_are_64), counts int32 [n],
// readonly one bool, the planes int32 of at least cap+1 elements (each may
// be null; freqs is read with add_freqs or filter), admitted bool [n].
// Returns the launch's cudaError_t; 0 is success. Never syncs.
extern "C" int deeprec_lookup_meta(const void* uslots, const void* counts,
                                   const void* readonly, const void* dest,
                                   void* create_steps, void* versions,
                                   void* freqs, int add_freqs, int filter,
                                   int filter_freq, void* admitted,
                                   int idx_are_64, int gs, int64_t n,
                                   int64_t cap, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t blocks = (n + 255) / 256;
  if (idx_are_64)
    return (int)launch_dependent(
        lookup_meta_kernel<int64_t>, blocks, 256, st, (const int64_t*)uslots,
        (const int32_t*)counts, (const bool*)readonly, (const int64_t*)dest,
        (int32_t*)create_steps, (int32_t*)versions, (int32_t*)freqs,
        add_freqs, filter, (int32_t)filter_freq, (bool*)admitted,
        (int32_t)gs, n, cap);
  return (int)launch_dependent(
      lookup_meta_kernel<int32_t>, blocks, 256, st, (const int32_t*)uslots,
      (const int32_t*)counts, (const bool*)readonly, (const int32_t*)dest,
      (int32_t*)create_steps, (int32_t*)versions, (int32_t*)freqs, add_freqs,
      filter, (int32_t)filter_freq, (bool*)admitted, (int32_t)gs, n, cap);
}

// plane int32 [>= cap], slots int32/int64 [n], vals int32 [n], out int32
// [cap]. vec4: 1 when plane and out are 16-byte aligned (the wrapper
// checks); a cap that is not a multiple of 4 copies its last elements
// singly. Returns the first cudaError_t; 0 is success.
extern "C" int deeprec_blocked_rmw_set(const void* plane, const void* slots,
                                       int slots_are_64, const void* vals,
                                       int64_t n, int64_t cap, void* out,
                                       int vec4, void* stream) {
  if (cap == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t span = (int64_t)kCopyThreads * kUnroll;  // units a block
  const int64_t units = vec4 ? cap / 4 : cap;
  const int64_t blocks = units > span ? (units + span - 1) / span : 1;
  plane_copy_kernel<<<(unsigned)blocks, kCopyThreads, 0, st>>>(
      (const int32_t*)plane, (int32_t*)out, cap, vec4);
  if (n == 0) return (int)cudaGetLastError();
  const int64_t scatter_blocks = (n + 255) / 256;
  const cudaError_t launched =
      slots_are_64
          ? launch_dependent(scatter_updates_kernel<int64_t>, scatter_blocks,
                             256, st, (const int64_t*)slots,
                             (const int32_t*)vals, n, cap, (int32_t*)out)
          : launch_dependent(scatter_updates_kernel<int32_t>, scatter_blocks,
                             256, st, (const int32_t*)slots,
                             (const int32_t*)vals, n, cap, (int32_t*)out);
  const cudaError_t last = cudaGetLastError();  // the copy's, or this one's
  return (int)(last != cudaSuccess ? last : launched);
}
