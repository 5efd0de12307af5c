// DLRM's pairwise dot interaction, forward and backward. For an example b
// of feats [B, F, D] (f32, contiguous), with p the index of the pair
// (i, j), i > j, in the row-major order of tril_indices(F, F, -1)
// (p = i (i - 1) / 2 + j):
//   forward   out[b, p]        = <feats[b, i, :], feats[b, j, :]>
//   backward  d_feats[b, i, :] = sum over j != i, ascending, of
//                                g[b, pair(i, j)] * feats[b, j, :]
//
// Replaces no TPU kernel: the JAX package leaves DotInteraction to XLA (an
// einsum for the Gram matrix, then a tril_indices gather). Done so in
// PyTorch, a step forms the [B, F, F] Gram matrix (191 MB at B 65,536,
// F 27) by a batched GEMM, gathers its strictly-lower triangle, and in the
// backward zeroes a gradient of the whole Gram matrix, scatters the [B, P]
// gradient into it with index_put_(accumulate=True) (a sort-based scatter
// with the batch strided by F * F floats) and runs two more batched GEMMs:
// about 5.5 ms a step at B 65,536 on an H100, against the 0.16 ms that the
// interaction's own bytes take.
//
// What bounds it: HBM bytes. The forward reads F * D floats and writes P
// floats an example; the backward reads F * D + P and writes F * D. Both
// are a few FLOPs a byte (2 D F (F - 1) / 2 FLOPs over (F D + P) 4 bytes:
// about 3 at F 27, D 16; about 6 at D 128), below the card's f32 SIMT
// line of about 20, so CUDA cores in f32, no tensor cores, no TF32.
//
// Design: a block of kThreads takes E consecutive examples, E as many as
// give each of its threads one work item (below) and fit 48 KB of shared
// memory (one example may take more, up to the card's opt-in limit). It
// copies their feats, contiguous in memory, into shared memory once, by
// coalesced loads of one unit each: a float4 where 4 divides D, else a
// float. Nothing of the Gram matrix is written anywhere. A thread works on
// K units of a row at a time (a chunk: 4, 2 or 1, the most that divide the
// row's units), held in registers, so each shared-memory load feeds as
// many fmas. Shared memory holds an example chunk-major: chunk c of every
// row, then chunk c + 1; a row's chunk takes KP units, K padded to an odd
// number, so the rows that neighbouring threads load at once start in
// distinct bank groups, and the stride from row to row is a constant of
// the kernel (the unrolled loops address by immediate offsets). The C =
// units / K chunks of a row are a loop with a count set at run time.
// - Forward: a work item is a row i >= 1 of an example. Its thread holds
//   chunk c of row i in registers and walks j = 0 .. i - 1: all threads of
//   an example are at the same j at once, so the load of row j's chunk is
//   a broadcast. Each dot is one f32 fma chain over k = 0 .. D - 1, chunk
//   by chunk (a fixed order), kept in an [E, P] tile in shared memory; the
//   block then writes the tile, every store instruction on consecutive
//   floats of out. Rows differ in length (row i has i pairs), so a warp
//   runs as long as its longest row.
// - Backward: the block also copies its [E, P] rows of g into shared
//   memory. A work item is chunk c of a row i. Its thread sums
//   g(i, j) * feats[j, chunk c] over j ascending, j != i, in one f32 fma
//   chain an element; at step j all threads of an example read the same
//   chunk of row j (a broadcast), and each its g(i, j). Each output is
//   written once, by its one thread: no gradient of the Gram matrix, no
//   memset, no sort and no atomics, so two runs are bit-equal.
// The kernels are templated on the unit and on K; D and F are arguments.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {
namespace di {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // dynamic shared memory, no opt-in

__host__ __device__ constexpr int pairs(int f) { return f * (f - 1) / 2; }

// Units a row's chunk of k units takes in shared memory: odd (see the
// design note).
__host__ __device__ constexpr int padded(int k) { return k % 2 ? k : k + 1; }

// Units of a chunk: 4, 2 or 1, the most that divide the row's u units.
inline int chunk_units(int u) { return u % 4 == 0 ? 4 : u % 2 == 0 ? 2 : 1; }

// Shared memory of a block of e examples: their rows (u units of `unit`
// bytes, in chunks of k), then the [e, P] tile (the forward's output, the
// backward's g).
inline int64_t smem_bytes(int e, int f, int u, int k, int unit) {
  return (int64_t)e * f * (u / k) * padded(k) * unit +
         (int64_t)e * pairs(f) * 4;
}

// Examples a block: one work item a thread (items of an example: its f - 1
// rows forward, f times the chunks of a row backward), within kSmemBytes
// unless one example takes more.
inline int examples_per_block(int items, int f, int u, int k, int unit) {
  int e = kThreads / items > 1 ? kThreads / items : 1;
  while (e > 1 && smem_bytes(e, f, u, k, unit) > kSmemBytes) --e;
  return e;
}

__device__ __forceinline__ float dot(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float dot(float a, float b, float acc) {
  return fmaf(a, b, acc);
}

__device__ __forceinline__ float4 axpy(float w, float4 x, float4 acc) {
  return make_float4(fmaf(w, x.x, acc.x), fmaf(w, x.y, acc.y),
                     fmaf(w, x.z, acc.z), fmaf(w, x.w, acc.w));
}

__device__ __forceinline__ float axpy(float w, float x, float acc) {
  return fmaf(w, x, acc);
}

// Copies examples [e0, e0 + ne) of feats (rows of u units, c_n chunks of
// K) into s, chunk-major: unit v of chunk c of row j of example ex at
// s + ((ex * c_n + c) * f + j) * padded(K) + v.
template <typename T, int K>
__device__ __forceinline__ void stage_rows(const T* __restrict__ feats,
                                           int64_t e0, int ne, int f, int u,
                                           T* s) {
  constexpr int KP = padded(K);
  const int c_n = u / K;
  const T* src = feats + e0 * f * u;
  const int n = ne * f * u;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int r = q / u, k = q - r * u;  // row ex * f + j, unit k of it
    int row = r;  // the row's chunk k / K, counted in chunks of KP
    if (c_n > 1) row += (r / f) * (c_n - 1) * f + k / K * f;
    s[row * KP + k % K] = __ldg(src + q);
  }
}

// The dots of row i with rows 0 .. i - 1 over one chunk (`chunk`: chunk c
// of row 0 of an example), added to o[j] unless this is the first.
template <typename T, int K, bool kFirst>
__device__ __forceinline__ void dot_chunk(const T* chunk, int i, float* o) {
  constexpr int KP = padded(K);
  T x[K];
#pragma unroll
  for (int v = 0; v < K; ++v) x[v] = chunk[i * KP + v];
  for (int j = 0; j < i; ++j) {
    float acc = kFirst ? 0.f : o[j];
#pragma unroll
    for (int v = 0; v < K; ++v) acc = dot(x[v], chunk[j * KP + v], acc);
    o[j] = acc;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) dot_interaction_kernel(
    const T* __restrict__ feats, float* __restrict__ out, int64_t b, int f,
    int u, int e) {
  extern __shared__ float4 smem[];
  const int cs = f * padded(K), c_n = u / K, p_n = pairs(f);  // cs: chunk
  const int64_t e0 = (int64_t)blockIdx.x * e;
  const int ne = b - e0 < e ? (int)(b - e0) : e;
  T* s = reinterpret_cast<T*>(smem);
  float* tile = reinterpret_cast<float*>(s + e * c_n * cs);
  stage_rows<T, K>(feats, e0, ne, f, u, s);
  __syncthreads();

  for (int q = threadIdx.x; q < ne * (f - 1); q += kThreads) {
    const int ex = q / (f - 1), i = q - ex * (f - 1) + 1;
    const T* rows = s + ex * c_n * cs;
    float* o = tile + ex * p_n + pairs(i);
    dot_chunk<T, K, true>(rows, i, o);
    for (int c = 1; c < c_n; ++c) dot_chunk<T, K, false>(rows + c * cs, i, o);
  }
  __syncthreads();
  float* dst = out + e0 * p_n;
  for (int k = threadIdx.x; k < ne * p_n; k += kThreads) dst[k] = tile[k];
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) dot_interaction_backward_kernel(
    const T* __restrict__ feats, const float* __restrict__ g,
    T* __restrict__ d_feats, int64_t b, int f, int u, int e) {
  extern __shared__ float4 smem[];
  constexpr int KP = padded(K);
  const int cs = f * KP, c_n = u / K, p_n = pairs(f);
  const int64_t e0 = (int64_t)blockIdx.x * e;
  const int ne = b - e0 < e ? (int)(b - e0) : e;
  T* s = reinterpret_cast<T*>(smem);
  float* gs = reinterpret_cast<float*>(s + e * c_n * cs);
  stage_rows<T, K>(feats, e0, ne, f, u, s);
  const float* gsrc = g + e0 * p_n;
  for (int q = threadIdx.x; q < ne * p_n; q += kThreads)
    gs[q] = __ldg(gsrc + q);
  __syncthreads();

  // item q: row i of chunk c of example ex, i fastest (the threads of a
  // warp share a chunk, so their loads of row j's chunk are one address)
  for (int q = threadIdx.x; q < ne * c_n * f; q += kThreads) {
    const int r = q / f, i = q - r * f;  // r = ex * c_n + c
    const int ex = r / c_n, c = r - ex * c_n;
    const T* col = s + r * cs;
    const float* ge = gs + ex * p_n;
    const int tri_i = pairs(i);
    T acc[K];
#pragma unroll
    for (int v = 0; v < K; ++v) acc[v] = T{};
    for (int j = 0, tri_j = 0; j < f; tri_j += j, ++j) {  // tri_j = pairs(j)
      if (j == i) continue;
      const float w = ge[j < i ? tri_i + j : tri_j + i];
#pragma unroll
      for (int v = 0; v < K; ++v) acc[v] = axpy(w, col[j * KP + v], acc[v]);
    }
    T* o = d_feats + ((e0 + ex) * f + i) * u + K * c;
#pragma unroll
    for (int v = 0; v < K; ++v) o[v] = acc[v];
  }
}

// Launches one of kernels (K 1, 2, 4) on args and the examples: b of
// them, items work items an example, u units of T a row.
template <typename T, typename Kernel, typename... A>
cudaError_t launch(const Kernel (&kernels)[3], int64_t b, int f, int u,
                   int items, cudaStream_t stream, A... args) {
  const int k = chunk_units(u);
  const Kernel kernel = kernels[k == 4 ? 2 : k - 1];
  const int e = examples_per_block(items, f, u, k, sizeof(T));
  const int64_t smem = smem_bytes(e, f, u, k, sizeof(T));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((b + e - 1) / e), kThreads, smem, stream>>>(
      args..., b, f, u, e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const void* feats, int64_t b, int f, int u, void* out,
                    cudaStream_t stream) {
  using Kernel = void (*)(const T*, float*, int64_t, int, int, int);
  static const Kernel kernels[3] = {dot_interaction_kernel<T, 1>,
                                    dot_interaction_kernel<T, 2>,
                                    dot_interaction_kernel<T, 4>};
  return launch<T>(kernels, b, f, u, f - 1, stream, (const T*)feats,
                   (float*)out);
}

template <typename T>
cudaError_t backward(const void* feats, const void* g, int64_t b, int f,
                     int u, void* d_feats, cudaStream_t stream) {
  using Kernel = void (*)(const T*, const float*, T*, int64_t, int, int,
                          int);
  static const Kernel kernels[3] = {dot_interaction_backward_kernel<T, 1>,
                                    dot_interaction_backward_kernel<T, 2>,
                                    dot_interaction_backward_kernel<T, 4>};
  return launch<T>(kernels, b, f, u, f * (u / chunk_units(u)), stream,
                   (const T*)feats, (const float*)g, (T*)d_feats);
}

}  // namespace di
}  // namespace

// feats f32 [b, f, d], contiguous and, where 4 divides d, 16-byte aligned;
// out f32 [b, f (f - 1) / 2]. b > 0, f >= 2, d >= 1, and one example's
// rows and pairs within the card's shared memory (the wrapper,
// ops/interaction.py, checks the dtype and layout; anything else returns
// cudaErrorInvalidValue unlaunched). Returns the launch's cudaError_t; 0
// is success. Never syncs.
extern "C" int deeprec_dot_interaction(const void* feats, int64_t b, int f,
                                       int d, void* out, void* stream) {
  if (b <= 0 || f < 2 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(d % 4 ? di::forward<float>(feats, b, f, d, out, st)
                     : di::forward<float4>(feats, b, f, d / 4, out, st));
}

// feats as above; g f32 [b, f (f - 1) / 2], contiguous; d_feats f32
// [b, f, d], aligned as feats.
extern "C" int deeprec_dot_interaction_backward(const void* feats,
                                                const void* g, int64_t b,
                                                int f, int d, void* d_feats,
                                                void* stream) {
  if (b <= 0 || f < 2 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(d % 4
                   ? di::backward<float>(feats, g, b, f, d, d_feats, st)
                   : di::backward<float4>(feats, g, b, f, d / 4, d_feats,
                                          st));
}
