// K2: the Anderson Gram pass, all clients in one launch.
//
// Replaces the TPU kernel repro/kernels/anderson/anderson.py::gram_pallas
// (pallas_call at :58, body _gram_kernel at :27): one pass over the history
// Y [m, d] and the gradient g [d] builds Y Y^T [m, m] and Y g [m].
//
// What bounds it: device memory (about m/2 + 1 multiply-adds per byte of
// Y read, well under the card's ridge). At the slice's shapes (K=100, m=10,
// d=54) it is tiny and its time is the launch.
//
// Design: grid = K, one block per client. The block walks d in tiles of
// kGramTile columns, staging Y[:, tile] and g[tile] in shared memory, so Y
// is read from memory once. Each of the P = m(m+1)/2 + m outputs (the upper
// triangle of Y Y^T, then Y g) is owned by `parts` threads that split the
// tile's columns in a fixed interleave; after the last tile the parts are
// summed in a fixed order and the upper triangle is mirrored, so the Gram
// matrix is exactly symmetric and bit-identical from run to run. No atomics.
//
// Accumulation type: T is float for f32 inputs (as the TPU kernel) and
// double for f64 inputs (where the TPU kernel downcast to f32); see PERF.md.
#include "common.cuh"

namespace {

constexpr int kGramThreads = 256;
constexpr int kGramTile = 64;      // columns of Y staged per pass
constexpr int kMaxHistory = 64;    // ops.py::MAX_HISTORY

template <typename T>
__global__ void __launch_bounds__(kGramThreads)
gram_kernel(const T* __restrict__ y, const T* __restrict__ g, long long g_stride,
            T* __restrict__ gram, T* __restrict__ yg, int m, int d) {
  T* ys = repro::shared_as<T>();     // [m][kGramTile]
  T* gs = ys + m * kGramTile;        // [kGramTile]
  T* red = gs + kGramTile;           // [kGramThreads] partials
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const T* yk = y + static_cast<size_t>(k) * m * d;
  const T* gk = g + static_cast<size_t>(k) * g_stride;
  const int n_pairs = m * (m + 1) / 2;
  const int P = n_pairs + m;

  for (int o0 = 0; o0 < P; o0 += kGramThreads) {
    const int p_here = min(P - o0, kGramThreads);
    const int parts = kGramThreads / p_here;
    const int o = o0 + tid % p_here;
    const int part = tid / p_here;
    const bool active = part < parts;
    // output o -> (row i, column j) of the upper triangle, or (i, -1) for Y g
    int i = 0, j = -1;
    if (o < n_pairs) {
      int rem = o;
      while (rem >= m - i) { rem -= m - i; ++i; }
      j = i + rem;
    } else {
      i = o - n_pairs;
    }
    T acc = T(0);
    for (int c0 = 0; c0 < d; c0 += kGramTile) {
      const int tw = min(kGramTile, d - c0);
      __syncthreads();
      for (int e = tid; e < m * tw; e += kGramThreads) {
        const int r = e / tw, c = e % tw;
        ys[r * kGramTile + c] = yk[static_cast<size_t>(r) * d + c0 + c];
      }
      for (int c = tid; c < tw; c += kGramThreads) gs[c] = gk[c0 + c];
      __syncthreads();
      if (active) {
        const T* a = ys + i * kGramTile;
        const T* b = j >= 0 ? ys + j * kGramTile : gs;
        for (int c = part; c < tw; c += parts) acc += a[c] * b[c];
      }
    }
    red[tid] = acc;
    __syncthreads();
    if (part == 0) {
      T sum = red[tid];
      for (int p = 1; p < parts; ++p) sum += red[p * p_here + tid];
      T* gk_out = gram + static_cast<size_t>(k) * m * m;
      if (j >= 0) {
        gk_out[i * m + j] = sum;
        gk_out[j * m + i] = sum;
      } else {
        yg[static_cast<size_t>(k) * m + i] = sum;
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* y, const void* g, long long g_stride, void* gram,
                   void* yg, int K, int m, int d, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(m) * kGramTile + kGramTile + kGramThreads) *
                      sizeof(T);
  gram_kernel<T><<<K, kGramThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), g_stride,
      static_cast<T*>(gram), static_cast<T*>(yg), m, d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. y [K, m, d] contiguous; g is client k's
// gradient at g + k * g_stride (g_stride 0: one g shared by all clients);
// gram [K, m, m], yg [K, m]. Returns the cudaError_t of the launch.
extern "C" int repro_gram(int dtype, const void* y, const void* g, long long g_stride,
                          void* gram, void* yg, int K, int m, int d, void* stream) {
  if (K <= 0 || m <= 0 || m > kMaxHistory || d <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? launch<float>(y, g, g_stride, gram, yg, K, m, d, st)
                             : launch<double>(y, g, g_stride, gram, yg, K, m, d, st);
  return static_cast<int>(e);
}
