// K2: fused gather + pool, forward and backward (the backward is below the
// forward kernel). For each bag b,
//   out[b, :] = scale(n_b) * sum over k with valid[b, k] of
//               values[clamp(slots[b, k], 0, R-1), :D]
// with scale 1 (sum), 1/max(n,1) (mean) or 1/sqrt(max(n,1)) (sqrtn), n_b
// the bag's valid count; an all-invalid bag gives 0.
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/pallas_fused_lookup.py
// fused_pooled_lookup (_fused_kernel), which streams each example's rows
// through a DMA queue into a VMEM accumulator. Like it, this kernel never
// writes the [B*w, D] expanded rows: the pooled [B, D] is the only write.
// It is bound by HBM bytes (valid rows read + pooled rows written). One
// sub-warp per bag, each thread owns a float4 (or a float) of the row,
// loops over the bag's w lanes, skips invalid lanes with a predicate (the
// TPU kernel's argsort left-pack is not needed) and accumulates in f32.
// No D % 128 rule, no chunk padding; slots and valid may be strided views
// (the serving path passes inverse.view(W, B)[o:o+w].T without a copy).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// V: float or float4 (the vector unit); ld and d are in units of V.
template <typename V, typename I>
__global__ void fused_pooled_lookup_kernel(
    const V* __restrict__ values, int64_t ld, int64_t n_rows, int64_t d,
    const I* __restrict__ slots, int64_t s_b, int64_t s_k,
    const bool* __restrict__ valid, int64_t v_b, int64_t v_k, int64_t n_bags,
    int64_t w, int combiner, V* __restrict__ out, int lanes) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t b = t / lanes;
  if (b >= n_bags) return;
  int lane = (int)(t - b * lanes);
  const I* bag_slots = slots + b * s_b;
  const bool* bag_valid = valid + b * v_b;
  for (int64_t c = lane; c < d; c += lanes) {
    V acc = zero<V>();
    int n = 0;
    for (int64_t k = 0; k < w; ++k) {
      if (!bag_valid[k * v_k]) continue;
      int64_t s = (int64_t)bag_slots[k * s_k];
      s = s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s);
      acc = add_(acc, __ldg(values + s * ld + c));
      ++n;
    }
    const float m = (float)(n > 1 ? n : 1);
    if (combiner == 1) acc = div_(acc, m);
    else if (combiner == 2) acc = div_(acc, sqrtf(m));
    out[b * d + c] = acc;
  }
}

// K2 backward: the pooling's gradient with respect to values,
//   d_values[clamp(slots[b, k], 0, R-1), :] += d_pooled[b, :] / scale_b
// for every valid lane (b, k), scale_b = 1 (sum), max(n_b,1) (mean) or
// sqrt(max(n_b,1)) (sqrtn). The Pallas TPU kernel has no backward (its
// caller differentiated the XLA gather instead); this is the port's own.
// Bound by HBM bytes: d_pooled read once, slots/valid read once, each
// touched d_values element written (the wrapper zero-fills the [R, D]
// output first). Design: as the forward, one sub-warp per bag and one
// column per thread; every valid lane adds its share with an f32
// atomicAdd. Criteo's skew puts thousands of adds on a few hot rows, which
// serialise in L2; a segmented sum over a sorted inverse would avoid that
// and is left to a later change. The atomics add in a different order on
// every run, so results agree with the plain version to rounding, not bits.
template <typename I>
__global__ void fused_pooled_lookup_bwd_kernel(
    const float* __restrict__ d_pooled, int64_t d,
    const I* __restrict__ slots, int64_t s_b, int64_t s_k,
    const bool* __restrict__ valid, int64_t v_b, int64_t v_k, int64_t n_bags,
    int64_t w, int combiner, float* __restrict__ d_values, int64_t n_rows,
    int lanes) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t b = t / lanes;
  if (b >= n_bags) return;
  int lane = (int)(t - b * lanes);
  const I* bag_slots = slots + b * s_b;
  const bool* bag_valid = valid + b * v_b;
  int n = 0;
  for (int64_t k = 0; k < w; ++k) n += bag_valid[k * v_k] ? 1 : 0;
  const float m = (float)(n > 1 ? n : 1);
  for (int64_t c = lane; c < d; c += lanes) {
    float g = d_pooled[b * d + c];
    if (combiner == 1) g = g / m;
    else if (combiner == 2) g = g / sqrtf(m);
    for (int64_t k = 0; k < w; ++k) {
      if (!bag_valid[k * v_k]) continue;
      int64_t s = (int64_t)bag_slots[k * s_k];
      s = s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s);
      atomicAdd(d_values + s * d + c, g);
    }
  }
}

template <typename V>
cudaError_t launch(const void* values, int64_t ld, int64_t n_rows, int64_t d,
                   const void* slots, int slots_are_64, int64_t s_b,
                   int64_t s_k, const void* valid, int64_t v_b, int64_t v_k,
                   int64_t n_bags, int64_t w, int combiner, void* out,
                   cudaStream_t stream) {
  int lanes = 1;
  while (lanes < 32 && lanes < d) lanes <<= 1;
  const int threads = 256;
  const int64_t blocks = (n_bags * lanes + threads - 1) / threads;
  if (slots_are_64)
    fused_pooled_lookup_kernel<V, int64_t>
        <<<(unsigned)blocks, threads, 0, stream>>>(
            (const V*)values, ld, n_rows, d, (const int64_t*)slots, s_b, s_k,
            (const bool*)valid, v_b, v_k, n_bags, w, combiner, (V*)out,
            lanes);
  else
    fused_pooled_lookup_kernel<V, int32_t>
        <<<(unsigned)blocks, threads, 0, stream>>>(
            (const V*)values, ld, n_rows, d, (const int32_t*)slots, s_b, s_k,
            (const bool*)valid, v_b, v_k, n_bags, w, combiner, (V*)out,
            lanes);
  return cudaGetLastError();
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
  if (n_bags == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4)
    return launch<float4>(values, ld / 4, n_rows, d / 4, slots, slots_are_64,
                          s_b, s_k, valid, v_b, v_k, n_bags, w, combiner, out,
                          st);
  return launch<float>(values, ld, n_rows, d, slots, slots_are_64, s_b, s_k,
                       valid, v_b, v_k, n_bags, w, combiner, out, st);
}

// d_pooled [n_bags, d] contiguous f32; slots/valid as for the forward;
// d_values [n_rows, d] contiguous f32, zero-filled by the caller, receives
// the sums. Returns the launch's cudaError_t; 0 is success.
extern "C" int deeprec_fused_pooled_lookup_bwd(
    const void* d_pooled, int64_t d, const void* slots, int slots_are_64,
    int64_t s_b, int64_t s_k, const void* valid, int64_t v_b, int64_t v_k,
    int64_t n_bags, int64_t w, int combiner, void* d_values, int64_t n_rows,
    void* stream) {
  if (n_bags == 0 || d == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int lanes = 1;
  while (lanes < 32 && lanes < d) lanes <<= 1;
  const int threads = 256;
  const int64_t blocks = (n_bags * lanes + threads - 1) / threads;
  if (slots_are_64)
    fused_pooled_lookup_bwd_kernel<int64_t><<<(unsigned)blocks, threads, 0,
                                              st>>>(
        (const float*)d_pooled, d, (const int64_t*)slots, s_b, s_k,
        (const bool*)valid, v_b, v_k, n_bags, w, combiner, (float*)d_values,
        n_rows, lanes);
  else
    fused_pooled_lookup_bwd_kernel<int32_t><<<(unsigned)blocks, threads, 0,
                                              st>>>(
        (const float*)d_pooled, d, (const int32_t*)slots, s_b, s_k,
        (const bool*)valid, v_b, v_k, n_bags, w, combiner, (float*)d_values,
        n_rows, lanes);
  return (int)cudaGetLastError();
}
