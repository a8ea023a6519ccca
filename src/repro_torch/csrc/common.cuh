// Shared helpers of the port's CUDA kernels (built into one library by
// repro_torch/kernels/_build.py). Every reduction here runs in a fixed
// order: no floating-point atomics, so repeated runs are bit-identical.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Sum over the 32 lanes of a warp by an xor butterfly. Every lane ends with
// the same bits (each stage adds the same two values, in either order).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Dynamic shared memory viewed as T. One raw buffer serves every
// instantiation (an extern __shared__ array of T would clash between the
// float and double instantiations).
template <typename T>
__device__ __forceinline__ T* shared_as() {
  extern __shared__ __align__(16) unsigned char repro_smem[];
  return reinterpret_cast<T*>(repro_smem);
}

// What the card makes of ``kernel`` launched with ``threads`` threads and
// ``dyn_smem`` bytes of dynamic shared memory: info = {resident blocks per
// SM, registers a thread, shared bytes a block (static + dynamic), threads,
// local (spilled) bytes a thread}.
template <typename Kernel>
inline cudaError_t kernel_occupancy(Kernel kernel, int threads, size_t dyn_smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn_smem);
  if (e != cudaSuccess) return e;
  info[0] = blocks;
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.sharedSizeBytes + dyn_smem);
  info[3] = threads;
  info[4] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

}  // namespace repro
