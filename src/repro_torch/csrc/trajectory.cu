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
// What bounds it: device memory. At the paper's scale (K=100 clients x 5810
// rows x d=54, 11 steps) the clients' designs are 251 MB in f64, more than
// the 50 MB L2 cache, so a kernel that reads X each step moves 11 times
// that (a floor of 0.82 ms); one that reads it once moves 251 MB (0.078 ms).
//
// Two designs behind one entry point; ops.py::plan_trajectory picks one
// from the shape (cluster = 0 asks for the streaming one).
//
// Resident (full batch, S = 1: every step reads the same rows). The TPU
// kernel kept a client's design in VMEM; here one thread-block cluster per
// client keeps it in shared memory. The cluster's blocks split the client's
// n rows, copy their slice of X (row pitch d | 1, odd: the forward's
// row-per-thread reads are conflict-free), y and mask into shared memory
// once (cp.async), and run every step from there: each thread takes a row,
// z = x.w, c = c(z) - a c(x.w0) (the anchor's term computed once); each
// warp sums c x over a slice of rows, lanes across the columns; the block
// sums its warps in order and publishes its partial X^T c [d] (double
// buffered by step parity, so one cluster barrier a step suffices). After
// the barrier every block reads all the cluster's partials through
// distributed shared memory in rank order, so each computes the same r and
// the same next w bit for bit; rank 0 writes (w_l, r_l). X is read from
// device memory once per round.
//
// Streaming (per-step minibatch rows, S = steps, or a client whose rows do
// not fit 16 blocks): grid = K, one block per client; the TPU's sequential
// step axis is a loop inside the block, with w, w0 and the per-warp partial
// sums of X^T c in shared memory. Each warp owns fixed groups of kRows rows,
// lanes across the columns. It issues every load of a group (kRows rows x
// kChunk columns, and the rows' y and mask) before it uses any, so one
// memory latency serves the group; then z = x.w (and x.w0), the
// coefficients, and c*x added into its own partial from the same
// registers. Designs wider than kChunk columns take the group in chunks
// and read each chunk again for the backward sweep (from cache). The
// partials are summed in warp order at the end of the step.
//
// Both: every sum runs in a fixed order and nothing is atomic, so reruns
// are bit-identical. The ragged edges (rows past n, columns past d) are
// masked here; nothing is padded by the caller. Measured (PERF.md): at the
// paper's scale the resident design takes 0.84 ms in f64 (0.42 in f32)
// against the streaming one's 2.40; the H100 holds 7 clusters of 16 at
// once, so f64 runs in 15 waves, and a step costs ~4.3 us, a quarter of
// it the cluster barrier.
#include <cooperative_groups.h>

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

// ---- the resident design: one thread-block cluster per client -----------

namespace cg = cooperative_groups;

constexpr int kResThreads = 512;
constexpr int kResWarps = kResThreads / 32;    // ops.py::_RES_WARPS
constexpr int kMaxCluster = 16;                // ops.py::MAX_CLUSTER

// Shared bytes of a resident block holding `rows` rows: w, w0, kResWarps
// warp partials and the cluster partial (two step parities) per column;
// X at the odd row pitch d | 1 (the forward's row-per-thread reads are then
// conflict-free); y, mask, c and the anchor's c per row.
// ops.py::resident_smem_bytes is the same formula.
template <typename T>
size_t resident_smem(int rows, int d) {
  return (static_cast<size_t>(d) * (4 + kResWarps) +
          static_cast<size_t>(rows) * ((d | 1) + 4)) * sizeof(T);
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(sizeof(T)));
}

// x_r . w over one resident row, in four interleaved sums (fixed order).
template <typename T>
__device__ __forceinline__ T row_dot(const T* __restrict__ xr, const T* __restrict__ w, int d) {
  T z0 = T(0), z1 = T(0), z2 = T(0), z3 = T(0);
  int c = 0;
#pragma unroll 2
  for (; c + 3 < d; c += 4) {
    z0 += xr[c] * w[c];
    z1 += xr[c + 1] * w[c + 1];
    z2 += xr[c + 2] * w[c + 2];
    z3 += xr[c + 3] * w[c + 3];
  }
  for (; c < d; ++c) z0 += xr[c] * w[c];
  return (z0 + z1) + (z2 + z3);
}

// grid = K clusters of `cluster` blocks along x; block rank q of client k
// holds rows [q rows, (q + 1) rows) of the client's n.
template <typename T, int LINK, bool ANCHOR>
__global__ void __launch_bounds__(kResThreads)
trajectory_resident_kernel(const T* __restrict__ x, const T* __restrict__ y,
                           const T* __restrict__ mask, const T* __restrict__ w0,
                           const T* __restrict__ u, const T* __restrict__ invn,
                           T* __restrict__ w_traj, T* __restrict__ r_traj,
                           int n, int d, int steps, int rows, T eta, T reg) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int k = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pitch = d | 1;
  T* w_cur = repro::shared_as<T>();        // [d]
  T* w_anc = w_cur + d;                    // [d]
  T* part = w_anc + d;                     // [kResWarps][d] warp partials
  T* pub = part + kResWarps * d;           // [2][d] the block's partial, by parity
  T* xs = pub + 2 * d;                     // [rows][pitch]
  T* ys = xs + static_cast<size_t>(rows) * pitch;
  T* ms = ys + rows;
  T* coef = ms + rows;                     // this step's c per row
  T* canc = coef + rows;                   // the anchor's c(x.w0) per row
  const int r0 = rank * rows;
  const int nr = max(0, min(rows, n - r0));
  const size_t kd = static_cast<size_t>(k) * d;
  const size_t row0 = static_cast<size_t>(k) * n + r0;

  // the block's rows into shared memory, once
  const T* xk = x + row0 * d;
  for (int e = tid; e < nr * d; e += kResThreads) {
    const int r = e / d;
    cp_async(xs + r * pitch + (e - r * d), xk + e);
  }
  for (int r = tid; r < nr; r += kResThreads) {
    cp_async(ys + r, y + row0 + r);
    cp_async(ms + r, mask + row0 + r);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int j = tid; j < d; j += kResThreads) w_cur[j] = w_anc[j] = w0[kd + j];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (ANCHOR)
    for (int r = tid; r < nr; r += kResThreads)
      canc[r] = link_coeff<T, LINK>(row_dot(xs + r * pitch, w_anc, d), ys[r], ms[r]);
  const int rpw = (nr + kResWarps - 1) / kResWarps;   // rows a warp sums
  const int wr0 = warp * rpw, wr1 = min(nr, wr0 + rpw);
  const T inv = invn[k];

  for (int step = 0; step < steps; ++step) {
    // forward: a thread a row
    for (int r = tid; r < nr; r += kResThreads) {
      T c = link_coeff<T, LINK>(row_dot(xs + r * pitch, w_cur, d), ys[r], ms[r]);
      if (ANCHOR) c -= canc[r];
      coef[r] = c;
    }
    __syncthreads();
    // backward: warp partials of X^T c, lanes across the columns
    for (int c0 = 0; c0 < d; c0 += 64) {
      const int ja = c0 + lane, jb = ja + 32;
      T acc_a = T(0), acc_b = T(0);
      for (int r = wr0; r < wr1; ++r) {
        const T cr = coef[r];
        const T* xr = xs + r * pitch;
        if (ja < d) acc_a += cr * xr[ja];
        if (jb < d) acc_b += cr * xr[jb];
      }
      if (ja < d) part[warp * d + ja] = acc_a;
      if (jb < d) part[warp * d + jb] = acc_b;
    }
    __syncthreads();
    // the block's partial (warps in order), published to the cluster
    T* pb = pub + (step & 1) * d;
    for (int j = tid; j < d; j += kResThreads) {
      T acc = T(0);
#pragma unroll
      for (int wp = 0; wp < kResWarps; ++wp) acc += part[wp * d + j];
      pb[j] = acc;
    }
    cluster.sync();
    // the cluster's partials in rank order: every block takes the same step
    const size_t out = (static_cast<size_t>(k) * steps + step) * d;
    for (int j = tid; j < d; j += kResThreads) {
      T v[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        v[q] = q < cs ? cluster.map_shared_rank(pb, q)[j] : T(0);
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < cs) acc += v[q];
      const T w_now = w_cur[j];
      const T r = acc * inv + reg * w_now + u[kd + j];
      if (rank == 0) {
        w_traj[out + j] = w_now;
        r_traj[out + j] = r;
      }
      w_cur[j] = w_now - eta * r;
    }
    __syncthreads();
  }
  cluster.sync();   // no block leaves while another may still read its partials
}

// ---- launches -------------------------------------------------------------

struct TrajArgs {
  const void *x, *y, *mask, *w0, *u, *invn;
  void *w_traj, *r_traj;
  int K, S, n, d, steps, cluster;
  double eta, reg;
  cudaStream_t stream;
};

template <typename T, int LINK, bool ANCHOR>
struct Streaming {
  static cudaError_t call(const TrajArgs& a, int*) {
    const size_t smem = static_cast<size_t>(2 + kTrajWarps) * a.d * sizeof(T);
    auto kernel = trajectory_kernel<T, LINK, ANCHOR>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<a.K, kTrajThreads, smem, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.y),
        static_cast<const T*>(a.mask), static_cast<const T*>(a.w0),
        static_cast<const T*>(a.u), static_cast<const T*>(a.invn),
        static_cast<T*>(a.w_traj), static_cast<T*>(a.r_traj), a.S, a.n, a.d, a.steps,
        static_cast<T>(a.eta), static_cast<T>(a.reg));
    return cudaGetLastError();
  }
};

// The resident kernel's attributes and launch configuration for a.cluster
// blocks a client (the grid: a.K clusters).
template <typename T, int LINK, bool ANCHOR>
cudaError_t resident_config(const TrajArgs& a, cudaLaunchConfig_t* cfg,
                            cudaLaunchAttribute* attr) {
  if (a.cluster < 1 || a.cluster > kMaxCluster || a.S != 1)
    return cudaErrorInvalidValue;
  auto kernel = trajectory_resident_kernel<T, LINK, ANCHOR>;
  const int rows = (a.n + a.cluster - 1) / a.cluster;
  const size_t smem = resident_smem<T>(rows, a.d);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(a.K * a.cluster);
  cfg->blockDim = dim3(kResThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = a.stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int LINK, bool ANCHOR>
struct Resident {
  static cudaError_t call(const TrajArgs& a, int*) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = resident_config<T, LINK, ANCHOR>(a, &cfg, &attr);
    if (e != cudaSuccess) return e;
    const int rows = (a.n + a.cluster - 1) / a.cluster;
    e = cudaLaunchKernelEx(&cfg, trajectory_resident_kernel<T, LINK, ANCHOR>,
                           static_cast<const T*>(a.x), static_cast<const T*>(a.y),
                           static_cast<const T*>(a.mask), static_cast<const T*>(a.w0),
                           static_cast<const T*>(a.u), static_cast<const T*>(a.invn),
                           static_cast<T*>(a.w_traj), static_cast<T*>(a.r_traj), a.n, a.d,
                           a.steps, rows, static_cast<T>(a.eta), static_cast<T>(a.reg));
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }
};

// info = {clusters the card keeps resident at once, shared bytes a block,
// threads a block, registers a thread}.
template <typename T, int LINK, bool ANCHOR>
struct ResidentQuery {
  static cudaError_t call(const TrajArgs& a, int* info) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    TrajArgs one = a;
    one.K = 1;
    cudaError_t e = resident_config<T, LINK, ANCHOR>(one, &cfg, &attr);
    if (e != cudaSuccess) return e;
    auto kernel = trajectory_resident_kernel<T, LINK, ANCHOR>;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    info[0] = clusters;
    info[1] = static_cast<int>(cfg.dynamicSmemBytes + fa.sharedSizeBytes);
    info[2] = kResThreads;
    info[3] = fa.numRegs;
    return cudaSuccess;
  }
};

// Op<T, LINK, ANCHOR>::call(a, info) for the runtime dtype, link and anchor.
template <template <typename, int, bool> class Op>
cudaError_t dispatch(int dtype, int link, int anchor, const TrajArgs& a, int* info) {
  const bool anc = anchor != 0;
  if (dtype == 0) {
    if (link == 0) return anc ? Op<float, 0, true>::call(a, info) : Op<float, 0, false>::call(a, info);
    return anc ? Op<float, 1, true>::call(a, info) : Op<float, 1, false>::call(a, info);
  }
  if (link == 0) return anc ? Op<double, 0, true>::call(a, info) : Op<double, 0, false>::call(a, info);
  return anc ? Op<double, 1, true>::call(a, info) : Op<double, 1, false>::call(a, info);
}

bool bad_args(int dtype, int link, const TrajArgs& a) {
  return a.K <= 0 || a.S <= 0 || a.n <= 0 || a.d <= 0 || a.steps <= 0 || a.cluster < 0 ||
         a.cluster > kMaxCluster || (link != 0 && link != 1) || (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = float64; link: 0 = logistic, 1 = linear;
// cluster: 0 for the streaming design, else the resident design's blocks a
// client (1 .. 16; S must be 1). All arrays contiguous on the card:
// x [K, S*n, d]; y, mask [K, S*n]; w0, u [K, d]; invn [K]; w_traj, r_traj
// [K, steps, d]. Returns the cudaError_t of the launch.
extern "C" int repro_trajectory(int dtype, int link, int anchor, const void* x,
                                const void* y, const void* mask, const void* w0,
                                const void* u, const void* invn, void* w_traj,
                                void* r_traj, int K, int S, int n, int d, int steps,
                                int cluster, double eta, double reg, void* stream) {
  const TrajArgs a{x, y, mask, w0, u, invn, w_traj, r_traj, K, S, n, d, steps, cluster,
                   eta, reg, static_cast<cudaStream_t>(stream)};
  if (bad_args(dtype, link, a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cluster == 0 ? dispatch<Streaming>(dtype, link, anchor, a, nullptr)
                               : dispatch<Resident>(dtype, link, anchor, a, nullptr);
  return static_cast<int>(e);
}

// What the card makes of the resident design for n rows of d columns in
// `cluster` blocks, without launching it: info[4] as ResidentQuery fills it.
extern "C" int repro_trajectory_clusters(int dtype, int link, int anchor, int n, int d,
                                         int cluster, int* info) {
  const TrajArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   1, 1, n, d, 1, cluster, 0.0, 0.0, nullptr};
  if (bad_args(dtype, link, a) || cluster == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<ResidentQuery>(dtype, link, anchor, a, info));
}
