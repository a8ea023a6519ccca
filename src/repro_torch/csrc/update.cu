// K3: the Anderson update pass, all clients in one launch; and the whole AA
// step after the Gram pass (repro_aa_step), which the main path runs.
//
// Replaces the TPU kernel repro/kernels/anderson/anderson.py::update_pallas
// (pallas_call at :107, body _update_kernel at :78):
//
//   w+ = w - eta * g - beta * (S^T gamma - eta * Y^T gamma)
//
// elementwise over d, with the m coefficients gamma broadcast.
//
// Accumulation type: T is float for f32 inputs (as the TPU kernel) and
// double for f64 inputs (where the TPU kernel downcast to f32); see PERF.md.
//
// repro_update (standalone; no main path launches it): grid = (ceil(d /
// 256), K); gamma[k] is staged in shared memory once per block, each thread
// owns one column j and sums its m terms in order. Screened history columns
// must be zeroed by the caller (an infinite column times a zero coefficient
// would be NaN).
//
// repro_aa_step: everything between the Gram pass and (w+, stats), per
// client, in one launch: the clip_rtol screen, the Tikhonov system, its
// eigendecomposition, the filtered solve for gamma, the stats (theta,
// |gamma|, cond, used, clipped) and the update. Its plain version,
// kernels/anderson/ref.py::aa_step_ref, follows it op for op.
//
// What bounds it: not the device. Its bytes (S, Y, w, g, the Gram matrix
// and Y g in; w+, gamma and the stats out) take 0.3 us at the main path's
// shape (K=100, m=10, d=54); its time is the solve's latency: n - 1 = 9
// rounds a sweep, 8-10 sweeps in f64 and 6-8 in f32 on the main path's
// Gram matrices, and each round a chain of dependent IEEE divisions and
// square roots, then shared-memory rotations, between two barriers (about
// 1.1 us a round in f64 on the H100; PERF.md). The composition it replaced
// ran 81 torch kernels and a batched cuSOLVER eigh, whose info check read
// the device from the host once a round; this launch reads nothing back.
//
// Design: grid = (B, K), 256 threads a block. Every block of client k runs
// the same solve on the same input, so gamma is bit-identical in all:
// - The screen (warp 0): column norms off the Gram diagonal; their median
//   over the finite columns by rank (the middle pair's mean for an even
//   count). A screened column leaves the system, the rhs, the Tikhonov
//   diagonal and the update by selection, never by a multiply (it may
//   carry inf).
// - The eigen-solve (the whole block): cyclic Jacobi on the system (padded
//   by one zero row and column to an even n) in shared memory. A sweep is
//   the n - 1 rounds of the circle method: round r pairs (r, n - 1) and
//   (r + k, r - k) mod (n - 1), tabled once. Thread k < n/2 owns pair k:
//   pair (p, q) rotates when |a_pq| > eps sqrt|a_pp| sqrt|a_qq|, by tan =
//   sgn(th) / (|th| + sqrt(th^2 + 1)), th = (a_qq - a_pp) / 2 a_pq (1/2th
//   where th^2 overflows), and its thread writes its own 2x2 block. After
//   a barrier, every thread takes items of the rotation: 2x2 blocks of
//   pairs of pairs (columns by the second pair, then rows by the first,
//   written to both triangles, so A stays exactly symmetric) and rows of
//   V. A round none of whose pairs rotates is skipped. Stop rule: before
//   each sweep, a matrix none of whose pairs would rotate has converged
//   (every off-diagonal entry of the diagonally scaled matrix, whose
//   diagonal is 1, is at most eps, the type's machine epsilon); at most
//   kMaxSweeps = 30 sweeps. The relative test keeps the small
//   eigenvalues' relative accuracy (the Gram matrices here reach condition
//   numbers of 1e11). Every operation is an _rn intrinsic, so none is
//   contracted into an FMA and the plain version's torch ops give the
//   same bits.
// - The solve (warp 0): gamma = V diag(inv) V^T rhs over the eigenvalues
//   above filter_rtol * max and the 1e-30 guard, every sum in index order.
//   A system with a non-finite entry gives gamma = NaN, used 0, cond 1.
// - B = 1 (small d, the main path): the block also writes the stats and
//   updates every column. B > 1 (large d): block 0 writes the stats and
//   computes |g|^2 over all of d; blocks 1 .. B - 1 split the update, so
//   |g|^2's read of g runs beside the update rather than after it.
//   kernels/anderson/ops.py::aa_step_blocks picks B from d and K.
// - |g|^2 (for theta) is summed in double, the only sum not in the plain
//   version's order.
// - No atomics, no allocation, no host read; w and g may be shared by all
//   clients (stride 0).
#include <cfloat>

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

// ---------------------------------------------------------------------------
// repro_aa_step

constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kMaxSweeps = 30;    // ref.py MAX_SWEEPS
constexpr int kMaxHistory = 64;   // ops.py MAX_HISTORY
constexpr unsigned kFull = 0xffffffffu;

// IEEE-rounded arithmetic, one rounding per operation (no FMA contraction).
template <typename T>
struct Ieee;

template <>
struct Ieee<float> {
  static constexpr float kEps = FLT_EPSILON;
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct Ieee<double> {
  static constexpr double kEps = DBL_EPSILON;
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// Dynamic shared memory of one block, n = m + (m & 1), h = n / 2:
// double gsq[kStepWarps]; T A[n n], V[n n], dsq[n], cs[h], sn[h], rhs[m],
// coef[m], gam[m], norms[m], med[2]; int sched[(n - 1) h] (round r's pair
// k, p | q << 8), offd[h (h - 1) / 2] (the pairs of pairs P1 < P2, P1 |
// P2 << 8), vit[n h] (V's items, row | pair << 8), keep[m].
template <typename T>
size_t step_smem_bytes(int m) {
  const int n = m + (m & 1), h = n / 2;
  return sizeof(double) * kStepWarps + sizeof(T) * (2 * n * n + n + 2 * h + 4 * m + 2) +
         sizeof(int) * ((n - 1) * h + h * (h - 1) / 2 + n * h + m);
}

template <typename T>
__global__ void __launch_bounds__(kStepThreads)
aa_step_kernel(const T* __restrict__ w, long long w_stride, const T* __restrict__ g,
               long long g_stride, const T* __restrict__ s, const T* __restrict__ y,
               const T* __restrict__ gram, const T* __restrict__ yg, T* __restrict__ out,
               T* __restrict__ gamma_out, T* __restrict__ stats,
               long long* __restrict__ counts, const T* __restrict__ gnorm2, int K, int m,
               int d, T eta, T beta, T tik, T filt, T clip) {
  using O = Ieee<T>;
  const T kTiny = T(1e-30);
  const int n = m + (m & 1), h = n / 2;
  double* gsq = repro::shared_as<double>();
  T* A = reinterpret_cast<T*>(gsq + kStepWarps);
  T* V = A + n * n;
  T* dsq = V + n * n;  // sqrt|a_ii|, kept beside the diagonal
  T* cs = dsq + n;
  T* sn = cs + h;
  T* rhs = sn + h;
  T* coef = rhs + m;
  T* gam = coef + m;
  T* norms = gam + m;
  T* med = norms + m;
  int* sched = reinterpret_cast<int*>(med + 2);
  int* offd = sched + (n - 1) * h;
  int* vit = offd + h * (h - 1) / 2;
  int* keep = vit + n * h;

  const int k = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool stats_block = blockIdx.x == 0;
  const T* gk = g + k * g_stride;
  T proj2 = T(0), gnorm = T(0), cond = T(1);
  int used = 0, kept = 0;
  bool bad = false;

  if (warp == 0) {
    const T* gramk = gram + static_cast<size_t>(k) * m * m;
    const T* ygk = yg + static_cast<size_t>(k) * m;
    // 1. the clip_rtol screen
    if (clip > T(0)) {
      for (int i = lane; i < m; i += 32) {
        const T dg = gramk[i * m + i];
        norms[i] = O::sqrt(dg < T(0) ? T(0) : dg);
      }
      __syncwarp();
      const int nf = __popc(__ballot_sync(kFull, lane < m && isfinite(norms[lane]))) +
                     __popc(__ballot_sync(kFull, lane + 32 < m && isfinite(norms[lane + 32])));
      for (int i = lane; i < m; i += 32) {
        const T v = norms[i];
        if (!isfinite(v)) continue;
        int rank = 0;
        for (int j = 0; j < m; ++j) {
          const T u = norms[j];
          rank += isfinite(u) && (u < v || (u == v && j < i));
        }
        if (rank == (nf - 1) / 2) med[0] = v;
        if (rank == nf / 2) med[1] = v;
      }
      __syncwarp();
      const T mid = nf > 0 ? O::add(med[0], O::mul(O::sub(med[1], med[0]), T(0.5))) : T(0);
      for (int i = lane; i < m; i += 32)
        keep[i] = isfinite(norms[i]) && O::mul(norms[i], clip) <= mid;
    } else {
      for (int i = lane; i < m; i += 32) keep[i] = 1;
    }
    __syncwarp();
    // 2. the system over the kept columns, and V = I
    for (int o = lane; o < n * n; o += 32) {
      const int i = o / n, j = o - i * n;
      A[o] = (i < m && j < m && keep[i] && keep[j]) ? gramk[i * m + j] : T(0);
      V[o] = i == j ? T(1) : T(0);
    }
    for (int i = lane; i < m; i += 32) rhs[i] = keep[i] ? ygk[i] : T(0);
    __syncwarp();
    T lam = T(0);
    if (lane == 0) {
      T tr = T(0);
      for (int i = 0; i < m; ++i) tr = O::add(tr, A[i * n + i]);
      lam = O::div(O::mul(tr, tik), T(m));
    }
    lam = __shfl_sync(kFull, lam, 0);
    for (int i = lane; i < m; i += 32)
      if (keep[i]) A[i * n + i] = O::add(A[i * n + i], lam);
    __syncwarp();
    bool nonfinite = false;
    for (int o = lane; o < n * n; o += 32) nonfinite |= !isfinite(A[o]);
    bad = __any_sync(kFull, nonfinite);
    if (bad)
      for (int o = lane; o < n * n; o += 32) A[o] = T(0);
    __syncwarp();
    for (int i = lane; i < n; i += 32) dsq[i] = O::sqrt(fabs(A[i * n + i]));
    // the circle method's rounds and the items of a round, once: no
    // division inside the rounds
    for (int o = lane; o < (n - 1) * h; o += 32) {
      const int r = o / h, kk = o - r * h;
      const int a = kk == 0 ? r : (r + kk) % (n - 1);
      const int b = kk == 0 ? n - 1 : (r - kk + n - 1) % (n - 1);
      sched[o] = min(a, b) | (max(a, b) << 8);
    }
    for (int o = lane; o < h * h; o += 32) {
      const int P1 = o / h, P2 = o - P1 * h;
      if (P1 < P2) offd[P2 * (P2 - 1) / 2 + P1] = P1 | (P2 << 8);
    }
    for (int o = lane; o < n * h; o += 32) vit[o] = (o / h) | ((o % h) << 8);
  }
  __syncthreads();

  // 3. cyclic Jacobi, the whole block: threads k < h own round r's pairs;
  // every thread takes items of the rotation (pairs of pairs, rows of V)
  const int noff = h * (h - 1) / 2, nitems = noff + n * h;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool sig = false;
    for (int i = tid; i < n; i += kStepThreads)
      for (int j = i + 1; j < n; ++j)
        sig |= fabs(A[i * n + j]) > O::mul(O::mul(dsq[i], O::kEps), dsq[j]);
    if (!__syncthreads_or(sig)) break;
    for (int r = 0; r < n - 1; ++r) {
      const int* sr = sched + r * h;
      bool rot = false;
      int p = 0, q = 0;
      T app = T(0), aqq = T(0), apq = T(0), t = T(0), c = T(1), sv = T(0);
      if (tid < h) {
        p = sr[tid] & 255;
        q = sr[tid] >> 8;
        app = A[p * n + p];
        aqq = A[q * n + q];
        apq = A[p * n + q];
        rot = fabs(apq) > O::mul(O::mul(dsq[p], O::kEps), dsq[q]);
        if (rot) {
          const T th = O::div(O::sub(aqq, app), O::mul(apq, T(2)));
          const T tt = O::mul(th, th);
          t = isfinite(tt) ? O::div(th >= T(0) ? T(1) : T(-1),
                                    O::add(fabs(th), O::sqrt(O::add(tt, T(1)))))
                           : O::div(T(0.5), th);
          c = O::div(T(1), O::sqrt(O::add(O::mul(t, t), T(1))));
          sv = O::mul(t, c);
        }
        cs[tid] = c;
        sn[tid] = sv;
      }
      // a round none of whose pairs rotates changes nothing
      if (!__syncthreads_or(rot)) continue;
      if (tid < h) {
        // the pair's own 2x2 block: no other thread reads it this round
        const T tapq = O::mul(t, apq);
        const T npp = O::sub(app, tapq), nqq = O::add(aqq, tapq);
        const T npq = rot ? T(0) : apq;
        A[p * n + p] = npp;
        A[q * n + q] = nqq;
        A[p * n + q] = npq;
        A[q * n + p] = npq;
        dsq[p] = O::sqrt(fabs(npp));
        dsq[q] = O::sqrt(fabs(nqq));
      }
      for (int it = tid; it < nitems; it += kStepThreads) {
        if (it < noff) {
          const int P1 = offd[it] & 255, P2 = offd[it] >> 8;
          const int a = sr[P1] & 255, b = sr[P1] >> 8, e = sr[P2] & 255, f = sr[P2] >> 8;
          const T c1 = cs[P1], s1 = sn[P1], c2 = cs[P2], s2 = sn[P2];
          const T xae = A[a * n + e], xaf = A[a * n + f];
          const T xbe = A[b * n + e], xbf = A[b * n + f];
          // columns by the second pair
          const T yae = O::sub(O::mul(c2, xae), O::mul(s2, xaf));
          const T yaf = O::add(O::mul(s2, xae), O::mul(c2, xaf));
          const T ybe = O::sub(O::mul(c2, xbe), O::mul(s2, xbf));
          const T ybf = O::add(O::mul(s2, xbe), O::mul(c2, xbf));
          // then rows by the first
          const T zae = O::sub(O::mul(c1, yae), O::mul(s1, ybe));
          const T zbe = O::add(O::mul(s1, yae), O::mul(c1, ybe));
          const T zaf = O::sub(O::mul(c1, yaf), O::mul(s1, ybf));
          const T zbf = O::add(O::mul(s1, yaf), O::mul(c1, ybf));
          A[a * n + e] = zae;
          A[e * n + a] = zae;
          A[a * n + f] = zaf;
          A[f * n + a] = zaf;
          A[b * n + e] = zbe;
          A[e * n + b] = zbe;
          A[b * n + f] = zbf;
          A[f * n + b] = zbf;
        } else {
          const int i = vit[it - noff] & 255, P = vit[it - noff] >> 8;
          const int vp = sr[P] & 255, vq = sr[P] >> 8;
          const T cv = cs[P], svv = sn[P];
          const T v0 = V[i * n + vp], v1 = V[i * n + vq];
          V[i * n + vp] = O::sub(O::mul(cv, v0), O::mul(svv, v1));
          V[i * n + vq] = O::add(O::mul(svv, v0), O::mul(cv, v1));
        }
      }
      __syncthreads();
    }
  }

  if (warp == 0) {
    // 4. the filtered solve: lane j owns eigenpair j (and j + 32)
    T ev[2], inv[2];
    bool kp[2];
    T emax = T(0);
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      const T e = j < m ? A[j * n + j] : T(0);
      ev[u] = e < T(0) ? T(0) : e;
      if (j < m) emax = ev[u] > emax ? ev[u] : emax;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_xor_sync(kFull, emax, off);
      emax = o > emax ? o : emax;
    }
    const T floor_ = O::mul(emax < kTiny ? kTiny : emax, kTiny);
    T emin = emax;
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      kp[u] = j < m && ev[u] > O::mul(emax, filt) && ev[u] > floor_;
      inv[u] = kp[u] ? O::div(T(1), ev[u]) : T(0);
      if (kp[u]) emin = ev[u] < emin ? ev[u] : emin;
      if (j < m) {
        T proj = T(0);
        for (int i = 0; i < m; ++i) proj = O::add(proj, O::mul(V[i * n + j], rhs[i]));
        coef[j] = O::mul(inv[u], proj);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_xor_sync(kFull, emin, off);
      emin = o < emin ? o : emin;
    }
    used = __popc(__ballot_sync(kFull, kp[0])) + __popc(__ballot_sync(kFull, kp[1]));
    cond = used > 0 ? O::div(emax, emin < kTiny ? kTiny : emin) : T(1);
    __syncwarp();
    for (int i = lane; i < m; i += 32) {
      T gi = T(0);
      for (int j = 0; j < m; ++j) gi = O::add(gi, O::mul(V[i * n + j], coef[j]));
      gam[i] = bad ? static_cast<T>(nan("")) : gi;
      if (stats_block) gamma_out[static_cast<size_t>(k) * m + i] = gam[i];
    }
    __syncwarp();
    if (lane == 0) {
      T g2 = T(0);
      for (int i = 0; i < m; ++i) {
        g2 = O::add(g2, O::mul(gam[i], gam[i]));
        proj2 = O::add(proj2, O::mul(rhs[i], gam[i]));
        kept += keep[i];
      }
      gnorm = O::sqrt(g2);
    }
  }
  if (stats_block && gnorm2 == nullptr) {
    // |g|^2 for theta, in double (unless the caller gives it)
    double acc = 0.0;
    for (int j = tid; j < d; j += kStepThreads) {
      const double v = static_cast<double>(gk[j]);
      acc += v * v;
    }
    acc = repro::warp_sum(acc);
    if (lane == 0) gsq[warp] = acc;
  }
  __syncthreads();

  // 5. the stats, by block 0 of the client
  if (stats_block && tid == 0) {
    T gn2;
    if (gnorm2 != nullptr) {
      gn2 = gnorm2[k];
    } else {
      double acc = 0.0;
      for (int u = 0; u < kStepWarps; ++u) acc += gsq[u];
      gn2 = static_cast<T>(acc);
    }
    const T x = O::sub(T(1), O::div(proj2, gn2 < kTiny ? kTiny : gn2));
    stats[k] = O::sqrt(x < T(0) ? T(0) : (x > T(1) ? T(1) : x));
    stats[K + k] = gnorm;
    stats[2 * K + k] = cond;
    counts[k] = used;
    counts[K + k] = m - kept;
  }

  // 6. the update, the kept columns summed in order
  if (gridDim.x > 1 && stats_block) return;
  const int first = gridDim.x > 1 ? blockIdx.x - 1 : 0;
  const int parts = gridDim.x > 1 ? gridDim.x - 1 : 1;
  const T* sk = s + static_cast<size_t>(k) * m * d;
  const T* yk = y + static_cast<size_t>(k) * m * d;
  const T* wk = w + k * w_stride;
  T* outk = out + static_cast<size_t>(k) * d;
  unsigned long long kept_mask = 0;
  for (int i = 0; i < m; ++i) kept_mask |= static_cast<unsigned long long>(keep[i] != 0) << i;
  for (int j = first * kStepThreads + tid; j < d; j += parts * kStepThreads) {
    T s_g = T(0), y_g = T(0);
    // every load is issued whether its column is kept or not (a screened
    // column's values are read, never used), so the loads run ahead
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const T gi = gam[i];
      const T s_new = O::add(s_g, O::mul(gi, sk[static_cast<size_t>(i) * d + j]));
      const T y_new = O::add(y_g, O::mul(gi, yk[static_cast<size_t>(i) * d + j]));
      if ((kept_mask >> i) & 1) {
        s_g = s_new;
        y_g = y_new;
      }
    }
    outk[j] = O::sub(O::sub(wk[j], O::mul(gk[j], eta)),
                     O::mul(O::sub(s_g, O::mul(y_g, eta)), beta));
  }
}

template <typename T>
cudaError_t launch_step(const void* w, long long w_stride, const void* g,
                        long long g_stride, const void* s, const void* y, const void* gram,
                        const void* yg, void* out, void* gamma, void* stats, void* counts,
                        const void* gnorm2, int K, int m, int d, int blocks, double eta,
                        double beta,
                        double tik, double filt, double clip, cudaStream_t stream) {
  const size_t smem = step_smem_bytes<T>(m);
  cudaError_t e = cudaFuncSetAttribute(aa_step_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  aa_step_kernel<T><<<dim3(blocks, K), kStepThreads, smem, stream>>>(
      static_cast<const T*>(w), w_stride, static_cast<const T*>(g), g_stride,
      static_cast<const T*>(s), static_cast<const T*>(y), static_cast<const T*>(gram),
      static_cast<const T*>(yg), static_cast<T*>(out), static_cast<T*>(gamma),
      static_cast<T*>(stats), static_cast<long long*>(counts),
      static_cast<const T*>(gnorm2), K, m, d,
      static_cast<T>(eta), static_cast<T>(beta), static_cast<T>(tik),
      static_cast<T>(filt), static_cast<T>(clip));
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

// dtype: 0 = float32, 1 = float64; every array of that type but counts.
// s, y [K, m, d], gram [K, m, m], yg [K, m] contiguous; client k's w and g
// at w + k * w_stride, g + k * g_stride (stride 0: shared). Writes out
// [K, d] (w+), gamma [K, m], stats [3, K] (theta, |gamma|, cond) and counts
// [2, K] int64 (used, clipped). gnorm2: [K] |g|^2 for theta, or null to
// sum it over the client's d here (a sharded caller gives the sum over
// every rank's part). blocks: the blocks a client (grid x; > 1 adds a
// stats block to blocks - 1 update blocks). Returns the cudaError_t of the
// launch.
extern "C" int repro_aa_step(int dtype, const void* w, long long w_stride, const void* g,
                             long long g_stride, const void* s, const void* y,
                             const void* gram, const void* yg, void* out, void* gamma,
                             void* stats, void* counts, const void* gnorm2, int K, int m,
                             int d, int blocks,
                             double eta, double beta, double tikhonov, double filter_rtol,
                             double clip_rtol, void* stream) {
  if (K <= 0 || K > 65535 || m <= 0 || m > kMaxHistory || d <= 0 || blocks <= 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0 ? launch_step<float>(w, w_stride, g, g_stride, s, y, gram, yg, out, gamma,
                                      stats, counts, gnorm2, K, m, d, blocks, eta, beta,
                                      tikhonov, filter_rtol, clip_rtol, st)
                 : launch_step<double>(w, w_stride, g, g_stride, s, y, gram, yg, out, gamma,
                                       stats, counts, gnorm2, K, m, d, blocks, eta, beta,
                                       tikhonov, filter_rtol, clip_rtol, st);
  return static_cast<int>(e);
}
