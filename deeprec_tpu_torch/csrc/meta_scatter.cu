// K3a and K3b: the EmbeddingVariable metadata writes at unique slots.
//
// K3a, meta_scatter (in place). For each lane i of a host-index lookup
//   create_steps[dest[i]]  = gs
//   versions[mdest[i]]     = gs
//   freqs[mdest[i]]       += counts[i]
// in one launch, one thread per lane. A lane whose index lies outside
// [0, cap) is skipped, so row cap (the shared null row) keeps -1/-1/0.
// Any of the three planes may be absent (a null pointer): with only one
// plane this is scatter_set, one scalar to a plane at U slots.
// Replaces the Pallas TPU kernel benchmarks/pallas_meta_bench.py
// pallas_dma_stores (_dma_kernel), which issued one DMA per slot and never
// compiled on the TPU (Mosaic's (1024,) tiling forbids 1-element HBM
// slices). On Hopper a 4-byte store to any address is one instruction.
// The indices below cap are unique by construction (the resolver's slots
// of distinct keys), so plain stores and a plain read-modify-write of the
// freq suffice: no two threads touch one element, no atomics are needed.
// Bound by HBM bytes: the index and count lanes read, and one 4-byte
// element written (and, for the freq, read) per plane and lane; each
// scattered element costs a 32-byte sector of traffic in practice.
//
// K3b, blocked_rmw_set (out of place).
//   out = plane[:cap]; out[slots[i]] = vals[i] for 0 <= slots[i] < cap
// Replaces benchmarks/pallas_meta_bench.py pallas_blocked_rmw
// (_rmw_kernel), which streamed the plane through VMEM in 64K-element
// blocks (it did not compile on the TPU either: no scatter lowering). A
// Hopper block holds at most 227 KB of shared memory, so each block owns a
// TILE of 16K int32 (64 KB): it loads its tile, scans all U updates and
// applies those that fall in the tile, and stores the tile. Bound by HBM
// bytes: the whole plane read and written once (2 x 4 x cap bytes) plus
// the U slots and values; the per-block scan of the U updates hits L2.
// It is not on the training path: it computes K3b's function so the card
// can answer the benchmark's question (stream the plane, or scatter).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1 << 14;       // int32 elements per block (64 KB)
constexpr int kRmwThreads = 1024;

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
__global__ void blocked_rmw_kernel(const int32_t* __restrict__ plane,
                                   const I* __restrict__ slots,
                                   const int32_t* __restrict__ vals,
                                   int64_t n, int64_t cap,
                                   int32_t* __restrict__ out, int vec4) {
  extern __shared__ int32_t tile[];
  const int64_t lo = (int64_t)blockIdx.x * kTile;
  const int64_t rest = cap - lo;
  const int len = (int)(rest < kTile ? rest : kTile);
  if (vec4) {  // len % 4 == 0 and both bases 16-byte aligned
    const int4* src = reinterpret_cast<const int4*>(plane + lo);
    int4* t4 = reinterpret_cast<int4*>(tile);
    for (int j = threadIdx.x; j < len / 4; j += blockDim.x) t4[j] = src[j];
  } else {
    for (int j = threadIdx.x; j < len; j += blockDim.x) tile[j] = plane[lo + j];
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t s = (int64_t)slots[i] - lo;
    if (s >= 0 && s < len) tile[s] = vals[i];
  }
  __syncthreads();
  if (vec4) {
    int4* dst = reinterpret_cast<int4*>(out + lo);
    const int4* t4 = reinterpret_cast<const int4*>(tile);
    for (int j = threadIdx.x; j < len / 4; j += blockDim.x) dst[j] = t4[j];
  } else {
    for (int j = threadIdx.x; j < len; j += blockDim.x) out[lo + j] = tile[j];
  }
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

// plane int32 [>= cap], slots int32/int64 [n], vals int32 [n], out int32
// [cap]. vec4: 1 when cap % 4 == 0 and plane and out are 16-byte aligned
// (the wrapper checks). Returns the first cudaError_t; 0 is success.
extern "C" int deeprec_blocked_rmw_set(const void* plane, const void* slots,
                                       int slots_are_64, const void* vals,
                                       int64_t n, int64_t cap, void* out,
                                       int vec4, void* stream) {
  if (cap == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = kTile * (int)sizeof(int32_t);  // above 48 KB: opt in
  cudaError_t err;
  const int64_t blocks = (cap + kTile - 1) / kTile;
  if (slots_are_64) {
    err = cudaFuncSetAttribute(blocked_rmw_kernel<int64_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    blocked_rmw_kernel<int64_t><<<(unsigned)blocks, kRmwThreads, smem, st>>>(
        (const int32_t*)plane, (const int64_t*)slots, (const int32_t*)vals,
        n, cap, (int32_t*)out, vec4);
  } else {
    err = cudaFuncSetAttribute(blocked_rmw_kernel<int32_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    blocked_rmw_kernel<int32_t><<<(unsigned)blocks, kRmwThreads, smem, st>>>(
        (const int32_t*)plane, (const int32_t*)slots, (const int32_t*)vals,
        n, cap, (int32_t*)out, vec4);
  }
  return (int)cudaGetLastError();
}
