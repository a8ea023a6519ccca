// K1: the fused dual-gradient local trajectory, all clients in one launch.
//
// Replaces the TPU kernel repro/kernels/local_update/local_update.py::
// trajectory_pallas (pallas_call at :154, body _make_traj_kernel at :74).
// For client k it runs `steps` = L+1 corrected GD steps from w0 (= the round
// anchor w^t) and emits every (w_l, r_l):
//
//   r = X^T (c(Xw) - a * c(Xw0)) / n + reg * w + u,    w <- w - eta * r
//
// with c the link coefficient (logistic: -y*sigmoid(-y*z); linear: z - y)
// and a in {0, 1}. X is [S*n, d] per client, S in {1, steps}.
//
// What bounds it: device memory. Each step reads the client's X once: the
// live and the anchor logits come from the same rows, and the one combined
// X^T c sweep reuses those rows from registers. At the paper's scale
// (K=100 clients x 5810 rows x d=54, 11 steps) that is 11 * N * d elements
// a round; the K blocks' designs (251 MB in f64) do not fit the 50 MB L2,
// so every step streams X from HBM, and the kernel is fast only if enough
// loads are in flight to cover the memory latency.
//
// Design: grid = K, one block per client; the TPU's sequential step axis
// becomes a loop inside the block, with w, w0 and the per-warp partial sums
// of X^T c in shared memory. Each warp owns fixed groups of kRows rows,
// lanes across the columns. It issues every load of a group (kRows rows x
// kChunk columns, and the rows' y and mask) before it uses any, so one
// memory latency serves the group; then z = x.w (and x.w0), the
// coefficients, and c*x added into its own partial from the same
// registers. Designs wider than kChunk columns take the group in chunks
// and read each chunk again for the backward sweep (from cache). The partials
// are summed in warp order at the end of the step: fixed order, no
// atomics, so the result is bit-identical from run to run. The ragged
// edges (rows past n, columns past d) are masked here; nothing is padded
// by the caller.
#include "common.cuh"

namespace {

constexpr int kTrajThreads = 512;
constexpr int kTrajWarps = kTrajThreads / 32;  // ops.py::_TRAJ_WARPS
constexpr int kRows = 8;                       // rows a warp keeps in flight
constexpr int kLaneCols = 2;                   // columns a lane holds
constexpr int kChunk = 32 * kLaneCols;         // columns a warp holds

__device__ __forceinline__ float sigmoid(float a) { return 1.0f / (1.0f + expf(-a)); }
__device__ __forceinline__ double sigmoid(double a) { return 1.0 / (1.0 + exp(-a)); }

template <typename T, int LINK>
__device__ __forceinline__ T link_coeff(T z, T y, T m) {
  if (LINK == 0) return (-y) * sigmoid(-(z * y)) * m;  // logistic
  return (z - y) * m;                                  // linear
}

// Rows r0..r0+kRows-1, columns c0 + t*32 + lane of one design block into
// registers: every load is issued before any is used. Zero past the edges.
template <typename T>
__device__ __forceinline__ void load_rows(T (&xv)[kRows][kLaneCols],
                                          const T* __restrict__ xs, int r0, int c0,
                                          int lane, int n, int d) {
#pragma unroll
  for (int q = 0; q < kRows; ++q)
#pragma unroll
    for (int t = 0; t < kLaneCols; ++t) {
      const int j = c0 + t * 32 + lane;
      xv[q][t] = (r0 + q < n && j < d) ? xs[static_cast<size_t>(r0 + q) * d + j] : T(0);
    }
}

template <typename T, int LINK, bool ANCHOR>
__global__ void __launch_bounds__(kTrajThreads)
trajectory_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const T* __restrict__ mask, const T* __restrict__ w0,
                  const T* __restrict__ u, const T* __restrict__ invn,
                  T* __restrict__ w_traj, T* __restrict__ r_traj,
                  int S, int n, int d, int steps, T eta, T reg) {
  T* w_cur = repro::shared_as<T>();  // [d] live iterate
  T* w_anc = w_cur + d;              // [d] anchor w0
  T* part = w_anc + d;               // [kTrajWarps][d] per-warp X^T c partials
  const int k = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t kd = static_cast<size_t>(k) * d;
  const T* xk = x + static_cast<size_t>(k) * S * n * d;
  const T* yk = y + static_cast<size_t>(k) * S * n;
  const T* mk = mask + static_cast<size_t>(k) * S * n;
  const T inv = invn[k];

  for (int j = tid; j < d; j += kTrajThreads) {
    w_cur[j] = w0[kd + j];
    w_anc[j] = w0[kd + j];
  }
  for (int j = tid; j < kTrajWarps * d; j += kTrajThreads) part[j] = T(0);
  __syncthreads();

  T* my_part = part + warp * d;
  const int n_chunks = (d + kChunk - 1) / kChunk;
  for (int step = 0; step < steps; ++step) {
    const size_t blk = (S == 1) ? 0 : step;
    const T* xs = xk + blk * n * d;
    const T* ys = yk + blk * n;
    const T* ms = mk + blk * n;

    for (int r0 = warp * kRows; r0 < n; r0 += kTrajWarps * kRows) {
      T xv[kRows][kLaneCols];
      // lane q < kRows holds row r0+q's target and mask (shuffled out below)
      const bool own_row = lane < kRows && r0 + lane < n;
      const T y_lane = own_row ? ys[r0 + lane] : T(0);
      const T m_lane = own_row ? ms[r0 + lane] : T(0);
      // forward: live (and anchor) logits of the warp's rows
      T z[kRows], z0[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) z[q] = z0[q] = T(0);
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int c0 = ch * kChunk;
        load_rows(xv, xs, r0, c0, lane, n, d);
#pragma unroll
        for (int t = 0; t < kLaneCols; ++t) {
          const int j = c0 + t * 32 + lane;
          const T wj = j < d ? w_cur[j] : T(0);
          const T aj = (ANCHOR && j < d) ? w_anc[j] : T(0);
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            z[q] += xv[q][t] * wj;
            if (ANCHOR) z0[q] += xv[q][t] * aj;
          }
        }
      }
      T c[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        z[q] = repro::warp_sum(z[q]);
        if (ANCHOR) z0[q] = repro::warp_sum(z0[q]);
        const T yv = __shfl_sync(0xffffffffu, y_lane, q);
        const T mv = __shfl_sync(0xffffffffu, m_lane, q);
        // rows past n have mask 0, so c is exactly 0 there
        c[q] = link_coeff<T, LINK>(z[q], yv, mv);
        if (ANCHOR) c[q] -= link_coeff<T, LINK>(z0[q], yv, mv);
      }
      // one combined backward sweep: both residual terms ride c
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int c0 = ch * kChunk;
        if (n_chunks > 1) load_rows(xv, xs, r0, c0, lane, n, d);
#pragma unroll
        for (int t = 0; t < kLaneCols; ++t) {
          const int j = c0 + t * 32 + lane;
          if (j < d) {
            T acc = my_part[j];
#pragma unroll
            for (int q = 0; q < kRows; ++q) acc += c[q] * xv[q][t];
            my_part[j] = acc;
          }
        }
      }
    }
    __syncthreads();

    // emit (w_l, r_l) and take the step; partials summed in warp order
    const size_t out = (static_cast<size_t>(k) * steps + step) * d;
    for (int j = tid; j < d; j += kTrajThreads) {
      T acc = T(0);
      for (int wp = 0; wp < kTrajWarps; ++wp) {
        acc += part[wp * d + j];
        part[wp * d + j] = T(0);
      }
      const T w_now = w_cur[j];
      const T r = acc * inv + reg * w_now + u[kd + j];
      w_traj[out + j] = w_now;
      r_traj[out + j] = r;
      w_cur[j] = w_now - eta * r;
    }
    __syncthreads();
  }
}

template <typename T, int LINK, bool ANCHOR>
cudaError_t launch(const void* x, const void* y, const void* mask, const void* w0,
                   const void* u, const void* invn, void* w_traj, void* r_traj,
                   int K, int S, int n, int d, int steps, double eta, double reg,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 + kTrajWarps) * d * sizeof(T);
  auto kernel = trajectory_kernel<T, LINK, ANCHOR>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<K, kTrajThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(mask),
      static_cast<const T*>(w0), static_cast<const T*>(u), static_cast<const T*>(invn),
      static_cast<T*>(w_traj), static_cast<T*>(r_traj), S, n, d, steps,
      static_cast<T>(eta), static_cast<T>(reg));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int link, int anchor, const void* x, const void* y,
                         const void* mask, const void* w0, const void* u,
                         const void* invn, void* w_traj, void* r_traj, int K, int S,
                         int n, int d, int steps, double eta, double reg,
                         cudaStream_t st) {
  if (link == 0 && anchor)
    return launch<T, 0, true>(x, y, mask, w0, u, invn, w_traj, r_traj, K, S, n, d,
                              steps, eta, reg, st);
  if (link == 0)
    return launch<T, 0, false>(x, y, mask, w0, u, invn, w_traj, r_traj, K, S, n, d,
                               steps, eta, reg, st);
  if (anchor)
    return launch<T, 1, true>(x, y, mask, w0, u, invn, w_traj, r_traj, K, S, n, d,
                              steps, eta, reg, st);
  return launch<T, 1, false>(x, y, mask, w0, u, invn, w_traj, r_traj, K, S, n, d,
                             steps, eta, reg, st);
}

}  // namespace

// dtype: 0 = float32, 1 = float64; link: 0 = logistic, 1 = linear.
// All arrays contiguous on the card: x [K, S*n, d]; y, mask [K, S*n];
// w0, u [K, d]; invn [K]; w_traj, r_traj [K, steps, d]. Returns the
// cudaError_t of the launch.
extern "C" int repro_trajectory(int dtype, int link, int anchor, const void* x,
                                const void* y, const void* mask, const void* w0,
                                const void* u, const void* invn, void* w_traj,
                                void* r_traj, int K, int S, int n, int d, int steps,
                                double eta, double reg, void* stream) {
  if (K <= 0 || S <= 0 || n <= 0 || d <= 0 || steps <= 0 || (link != 0 && link != 1) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? launch_dtype<float>(link, anchor, x, y, mask, w0, u, invn, w_traj, r_traj, K, S,
                            n, d, steps, eta, reg, st)
      : launch_dtype<double>(link, anchor, x, y, mask, w0, u, invn, w_traj, r_traj, K,
                             S, n, d, steps, eta, reg, st);
  return static_cast<int>(e);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
