// K3: the Anderson update pass, all clients in one launch.
//
// Replaces the TPU kernel repro/kernels/anderson/anderson.py::update_pallas
// (pallas_call at :107, body _update_kernel at :78):
//
//   w+ = w - eta * g - beta * (S^T gamma - eta * Y^T gamma)
//
// elementwise over d, with the m coefficients gamma broadcast.
//
// What bounds it: device memory (2m + 2 reads and one write per element,
// about 2m multiply-adds). At the slice's shapes (K=100, m=10, d=54) it is
// tiny and its time is the launch.
//
// Design: grid = (ceil(d / 256), K); gamma[k] is staged in shared memory
// once per block, each thread owns one column j and sums its m terms in
// order (deterministic, no atomics). w and g may be shared by every client
// (client stride 0). Screened history columns are zeroed by the caller
// before this pass (core/anderson.py): an infinite column times a zero
// coefficient would be NaN.
//
// Accumulation type: T is float for f32 inputs (as the TPU kernel) and
// double for f64 inputs (where the TPU kernel downcast to f32); see PERF.md.
#include "common.cuh"

namespace {

constexpr int kUpdateThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kUpdateThreads)
update_kernel(const T* __restrict__ w, long long w_stride, const T* __restrict__ g,
              long long g_stride, const T* __restrict__ s, const T* __restrict__ y,
              const T* __restrict__ gamma, T* __restrict__ out, int m, int d, T eta,
              T beta) {
  T* gam = repro::shared_as<T>();  // [m]
  const int k = blockIdx.y;
  for (int i = threadIdx.x; i < m; i += kUpdateThreads)
    gam[i] = gamma[static_cast<size_t>(k) * m + i];
  __syncthreads();
  const int j = blockIdx.x * kUpdateThreads + threadIdx.x;
  if (j >= d) return;
  const T* sk = s + static_cast<size_t>(k) * m * d + j;
  const T* yk = y + static_cast<size_t>(k) * m * d + j;
  T s_g = T(0), y_g = T(0);
  for (int i = 0; i < m; ++i) {
    s_g += gam[i] * sk[static_cast<size_t>(i) * d];
    y_g += gam[i] * yk[static_cast<size_t>(i) * d];
  }
  const T wv = w[k * w_stride + j];
  const T gv = g[k * g_stride + j];
  out[static_cast<size_t>(k) * d + j] = wv - eta * gv - beta * (s_g - eta * y_g);
}

template <typename T>
cudaError_t launch(const void* w, long long w_stride, const void* g, long long g_stride,
                   const void* s, const void* y, const void* gamma, void* out, int K,
                   int m, int d, double eta, double beta, cudaStream_t stream) {
  const dim3 grid((d + kUpdateThreads - 1) / kUpdateThreads, K);
  update_kernel<T><<<grid, kUpdateThreads, m * sizeof(T), stream>>>(
      static_cast<const T*>(w), w_stride, static_cast<const T*>(g), g_stride,
      static_cast<const T*>(s), static_cast<const T*>(y), static_cast<const T*>(gamma),
      static_cast<T*>(out), m, d, static_cast<T>(eta), static_cast<T>(beta));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. s, y [K, m, d] and gamma [K, m]
// contiguous; client k's w and g at w + k * w_stride, g + k * g_stride
// (stride 0: shared by all clients); out [K, d]. Returns the cudaError_t
// of the launch.
extern "C" int repro_update(int dtype, const void* w, long long w_stride, const void* g,
                            long long g_stride, const void* s, const void* y,
                            const void* gamma, void* out, int K, int m, int d,
                            double eta, double beta, void* stream) {
  if (K <= 0 || K > 65535 || m <= 0 || d <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? launch<float>(w, w_stride, g, g_stride, s, y, gamma, out, K, m, d, eta, beta, st)
          : launch<double>(w, w_stride, g, g_stride, s, y, gamma, out, K, m, d, eta, beta,
                           st);
  return static_cast<int>(e);
}
