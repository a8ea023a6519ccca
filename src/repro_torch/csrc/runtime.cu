// Entry points of the kernel library as a whole, not of one kernel.
#include "common.cuh"

namespace {

// Does nothing: one warp, no memory traffic. What a launch costs.
__global__ void noop_kernel() {}

}  // namespace

// The message of a cudaError_t that an entry point returned.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the empty kernel <<<1, 32>>> on `stream`: timed back to back, it
// gives the launch floor that every kernel's time includes. Returns the
// cudaError_t of the launch.
extern "C" int repro_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Enqueues the host function `fn(data)` on `stream` (cudaLaunchHostFunc):
// under stream capture it becomes a host node of the graph, run on CUDA's
// callback thread when the work before it in the stream has finished, and
// the work after it waits until `fn` returns. No kernel is launched. `fn`
// must call no CUDA API. Returns the cudaError_t of the enqueue.
extern "C" int repro_host_node(void* fn, void* data, void* stream) {
  return static_cast<int>(cudaLaunchHostFunc(
      static_cast<cudaStream_t>(stream), reinterpret_cast<cudaHostFn_t>(fn),
      data));
}
