// Programmatic dependent launch (Hopper's griddepcontrol), cooperative
// launch and the opt-in to more shared memory, shared by the kernels that
// use them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Lets the grids launched after this one as its programmatic dependents
// start their blocks now.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Returns once the grid this one depends on has finished and its writes
// are visible; at once for a grid launched without the dependency.
__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launches kernel on `blocks` blocks of `threads` as the programmatic
// dependent of the work queued before it on stream: its blocks may start
// before that work has finished, and must call wait_for_prerequisite()
// before they touch memory that work uses.
template <typename... K, typename... A>
cudaError_t launch_dependent(void (*kernel)(K...), int64_t blocks,
                             int threads, cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, (K)args...);
}

// The current device's SM count, taken once a device.
inline int sm_count() {
  constexpr int kDevices = 64;
  static int cached[kDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kDevices) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// Resident blocks of `kernel` at `threads` a block on one SM (the same on
// every SM of a card; the cards of one process are taken to be of one
// kind), taken once into *cached.
template <typename F>
int resident_blocks(F kernel, int threads, int* cached) {
  if (*cached == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(cached, kernel, threads, 0);
  return *cached;
}

// A cooperative launch of kernel on `blocks` blocks of `threads`: all of
// them resident at once, so that the grid may cross grid.sync().
template <typename... K, typename... A>
cudaError_t launch_cooperative(void (*kernel)(K...), int64_t blocks,
                               int threads, cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, (K)args...);
}

// Lets kernel take smem bytes of dynamic shared memory: past the 48 KB any
// launch may take, up to the card's opt-in limit; cudaErrorInvalidValue
// past that.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int64_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > most) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
