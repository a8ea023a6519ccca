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

}  // namespace repro
