// K7: the Mamba-2 SSD intra-chunk step (arXiv:2405.21060 §6).
//
// Replaces the TPU kernel repro/kernels/ssd/ssd.py::ssd_chunk_pallas
// (pallas_call at :75, body _ssd_chunk_kernel at :26; wrapper ops.py:23,
// the model's ssd_fn hook). For every chunk g and head h, with
// L[i,j] = exp(da_i - da_j) for j <= i and 0 above the diagonal:
//   y[i]  = sum_j (C_i . B_j) L[i,j] dt_j x_j                     [Q, hd]
//   state = sum_j exp(da_last - da_j) dt_j x_j (outer) B_j       [hd, st]
// B and C are shared by the nh heads of a chunk.
//
// What bounds it: operations (f32 on the CUDA cores, 67 TFLOP/s). At
// Zamba2-7B's served shape (G = 32 chunks, nh = 112, Q = 256, hd = st =
// 64) the causal products are ~15 GFLOP and C B^T ~0.1 GFLOP once per
// chunk, against ~0.5 GB of x, y and state.
//
// Design: two kernels behind one entry point.
//  1. cb_kernel computes C B^T once per chunk (the TPU kernel recomputes it
//     for each of the nh heads) into a [G, Q, Q] f32 scratch the wrapper
//     allocates, stored transposed (key-major) so the second kernel reads
//     it along the rows; only the 64 x 64 tiles on or below the diagonal
//     are written, and only those are read. At G = 32, Q = 256 it is 8 MB
//     and stays in the 50 MB L2 cache for the second kernel.
//  2. ssd_kernel: one block of 256 threads per (head, chunk). It stages the
//     chunk's dt and da once, then for each 64-row tile i of y walks the
//     64-key tiles j <= i: it forms M = CB[i, j] * exp(da_i - da_j) in
//     shared memory (key-major), masking BEFORE the exp (j > i gives 0 and
//     seg = da_i - da_j, positive there, is never exponentiated), stages
//     x_j dt_j, and accumulates y += M (x dt) in registers: each thread a
//     4 x 4 patch (two for hd > 64), fed by one 16-byte shared load of M
//     and one of x per 16 FMAs, so the FMA units and not shared memory set
//     the pace. Then it walks all Q rows once more for the state, (x w)^T B
//     with w_j = dt_j exp(da_last - da_j), in 4 x 4 patches the same way.
//     x, y and state stay in the model's layout ([G, Q, nh, hd] and
//     [G, nh, hd, st]): no transposes around the launch. Every sum runs in
//     a fixed order (the plain version's: j ascending): no atomics.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;           // rows / keys per tile
constexpr int kMaxQ = 256;       // ops.py::MAX_CHUNK
constexpr int kMaxDim = 128;     // ops.py::MAX_DIM (hd and st)

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[a][b] += u[a] * v[b] for the 4 x 4 patch of an outer product.
__device__ __forceinline__ void fma4x4(float (*acc)[4], float4 u, float4 v) {
  const float uu[4] = {u.x, u.y, u.z, u.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(uu[a], vv[b], acc[a][b]);
}

// CBt[g, j, i] = sum_s C[g, i, s] B[g, j, s] on the tiles j <= i (stored
// transposed, j-major, so the second kernel reads it along i).
__global__ void __launch_bounds__(kThreads)
cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ cbt,
          int Q, int st) {
  const int lds = st + 1;                  // odd stride: conflict-free column reads
  float* cs = repro::shared_as<float>();   // [kT][lds]
  float* bs = cs + kT * lds;               // [kT][lds]
  // blockIdx.x enumerates the lower-triangular tile pairs (it, jt <= it)
  int it = 0, rem = blockIdx.x;
  while (rem > it) { rem -= it + 1; ++it; }
  const int jt = rem;
  const int g = blockIdx.y;
  const int i0 = it * kT, j0 = jt * kT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* cg = Cm + static_cast<size_t>(g) * Q * st;
  const float* bg = Bm + static_cast<size_t>(g) * Q * st;
  for (int e = tid; e < kT * st; e += kThreads) {
    const int r = e / st, c = e % st;
    cs[r * lds + c] = i0 + r < Q ? cg[(i0 + r) * st + c] : 0.f;
    bs[r * lds + c] = j0 + r < Q ? bg[(j0 + r) * st + c] : 0.f;
  }
  __syncthreads();
  float acc[4][4] = {};                    // [j = ty + 16 a][i = tx + 16 b]
  for (int s = 0; s < st; ++s) {
    float cv[4], bv[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) cv[b] = cs[(tx + 16 * b) * lds + s];
#pragma unroll
    for (int a = 0; a < 4; ++a) bv[a] = bs[(ty + 16 * a) * lds + s];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(cv[b], bv[a], acc[a][b]);
  }
  float* out = cbt + static_cast<size_t>(g) * Q * Q;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + tx + 16 * b;
      if (i < Q && j < Q) out[j * Q + i] = acc[a][b];
    }
  }
}

// One block per (head, chunk). kWideX: hd > 64 (each thread owns a second
// group of 4 head columns, at +64); kWideS: st > 64 (a second group of 4
// state columns).
template <bool kWideX, bool kWideS>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ da, const float* __restrict__ Bm,
           const float* __restrict__ cbt, float* __restrict__ y, float* __restrict__ state,
           int Q, int nh, int hd, int st) {
  constexpr int xw = kWideX ? 128 : 64;      // staged width of an x tile
  constexpr int bw = kWideS ? 128 : 64;      // staged width of a B tile
  constexpr int nx = kWideX ? 2 : 1, ns = kWideS ? 2 : 1;
  float* das = repro::shared_as<float>();    // [kMaxQ]
  float* dts = das + kMaxQ;                  // [kMaxQ]
  float* r1 = dts + kMaxQ;                   // M^T [kT][kT], then B [kT][bw]
  float* r2 = r1 + kT * (bw > kT ? bw : kT); // x dt [kT][xw], then x w
  const int h = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, wrp = tid / 32;
  const size_t x_row = static_cast<size_t>(nh) * hd;
  const float* xg = x + static_cast<size_t>(g) * Q * x_row + static_cast<size_t>(h) * hd;
  float* yg = y + static_cast<size_t>(g) * Q * x_row + static_cast<size_t>(h) * hd;
  const float* cbg = cbt + static_cast<size_t>(g) * Q * Q;

  for (int r = tid; r < Q; r += kThreads) {
    das[r] = da[(static_cast<size_t>(g) * Q + r) * nh + h];
    dts[r] = dt[(static_cast<size_t>(g) * Q + r) * nh + h];
  }

  // y: for each 64-row tile i, the key tiles j <= i. Thread (ty, tx) owns
  // rows 4 ty .. 4 ty + 3 and head columns 4 tx .. 4 tx + 3 (+ 64).
  const int nt = (Q + kT - 1) / kT;
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * kT;
    float acc[nx][4][4] = {};
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();   // das/dts staged; the last tile's M and x dt consumed
      for (int c = wrp; c < kT; c += kThreads / 32) {
        const int j = j0 + c;
#pragma unroll
        for (int r = lane; r < kT; r += 32) {
          const int i = i0 + r;
          float m = 0.f;
          if (i < Q && j <= i)   // mask before the exp
            m = cbg[static_cast<size_t>(j) * Q + i] * expf(das[i] - das[j]);
          r1[c * kT + r] = m;    // M^T: key-major
        }
      }
      for (int r = wrp; r < kT; r += kThreads / 32) {
        const int j = j0 + r;
        const float w = j < Q ? dts[j] : 0.f;
#pragma unroll
        for (int c = lane; c < xw; c += 32)
          r2[r * xw + c] = j < Q && c < hd ? xg[j * x_row + c] * w : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kT; ++kk) {
        const float4 m = ld4(r1 + kk * kT + 4 * ty);
#pragma unroll
        for (int p = 0; p < nx; ++p) fma4x4(acc[p], m, ld4(r2 + kk * xw + 64 * p + 4 * tx));
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = i0 + 4 * ty + a;
      if (row >= Q) continue;
#pragma unroll
      for (int p = 0; p < nx; ++p)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = 64 * p + 4 * tx + b;
          if (col < hd) yg[row * x_row + col] = acc[p][a][b];
        }
    }
  }

  // chunk state: (x w)^T B, w_j = dt_j exp(da_last - da_j). Thread (ty, tx)
  // owns head rows 4 ty .. 4 ty + 3 (+ 64) and state columns 4 tx .. (+ 64).
  const float* bg = Bm + static_cast<size_t>(g) * Q * st;
  const float da_last = das[Q - 1];
  float acc[nx][ns][4][4] = {};
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();
    for (int r = wrp; r < kT; r += kThreads / 32) {
      const int j = j0 + r;
      const float w = j < Q ? dts[j] * expf(da_last - das[j]) : 0.f;
#pragma unroll
      for (int c = lane; c < bw; c += 32)
        r1[r * bw + c] = j < Q && c < st ? bg[j * st + c] : 0.f;
#pragma unroll
      for (int c = lane; c < xw; c += 32)
        r2[r * xw + c] = j < Q && c < hd ? xg[j * x_row + c] * w : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kT; ++kk) {
#pragma unroll
      for (int p = 0; p < nx; ++p) {
        const float4 u = ld4(r2 + kk * xw + 64 * p + 4 * ty);
#pragma unroll
        for (int q = 0; q < ns; ++q) fma4x4(acc[p][q], u, ld4(r1 + kk * bw + 64 * q + 4 * tx));
      }
    }
  }
  float* sg = state + (static_cast<size_t>(g) * nh + h) * hd * st;
#pragma unroll
  for (int p = 0; p < nx; ++p)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = 64 * p + 4 * ty + a;
      if (row >= hd) continue;
#pragma unroll
      for (int q = 0; q < ns; ++q)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = 64 * q + 4 * tx + b;
          if (col < st) sg[row * st + col] = acc[p][q][a][b];
        }
    }
}

template <bool kWideX, bool kWideS>
cudaError_t launch_ssd(const float* x, const float* dt, const float* da, const float* Bm,
                       const float* cbt, float* y, float* state, int G, int Q, int nh,
                       int hd, int st, cudaStream_t s) {
  constexpr int xw = kWideX ? 128 : 64, bw = kWideS ? 128 : 64;
  const size_t smem = (2 * static_cast<size_t>(kMaxQ) + static_cast<size_t>(kT) * (bw > kT ? bw : kT) +
                       static_cast<size_t>(kT) * xw) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ssd_kernel<kWideX, kWideS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  ssd_kernel<kWideX, kWideS><<<dim3(nh, G), kThreads, smem, s>>>(x, dt, da, Bm, cbt, y, state,
                                                                  Q, nh, hd, st);
  return cudaGetLastError();
}

}  // namespace

// All float32, contiguous, in the model's layout: x [G, Q, nh, hd];
// dt, da [G, Q, nh]; B, C [G, Q, st]; cb (scratch) [G, Q, Q];
// y [G, Q, nh, hd]; state [G, nh, hd, st]. Q <= 256, hd and st <= 128.
// Returns the cudaError_t of the launches.
extern "C" int repro_ssd(const void* x, const void* dt, const void* da, const void* Bm,
                         const void* Cm, void* cb, void* y, void* state, int G, int Q,
                         int nh, int hd, int st, void* stream) {
  if (G <= 0 || G > 65535 || Q <= 0 || Q > kMaxQ || nh <= 0 || hd <= 0 ||
      hd > kMaxDim || st <= 0 || st > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (Q + kT - 1) / kT;
  const size_t cb_smem = 2 * static_cast<size_t>(kT) * (st + 1) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(cb_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cb_kernel<<<dim3(nt * (nt + 1) / 2, G), kThreads, cb_smem, s>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(cb),
      Q, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* xp = static_cast<const float*>(x);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* dap = static_cast<const float*>(da);
  const auto* bp = static_cast<const float*>(Bm);
  const auto* cbp = static_cast<const float*>(cb);
  auto* yp = static_cast<float*>(y);
  auto* sp = static_cast<float*>(state);
  if (hd > 64)
    e = st > 64 ? launch_ssd<true, true>(xp, dtp, dap, bp, cbp, yp, sp, G, Q, nh, hd, st, s)
                : launch_ssd<true, false>(xp, dtp, dap, bp, cbp, yp, sp, G, Q, nh, hd, st, s);
  else
    e = st > 64 ? launch_ssd<false, true>(xp, dtp, dap, bp, cbp, yp, sp, G, Q, nh, hd, st, s)
                : launch_ssd<false, false>(xp, dtp, dap, bp, cbp, yp, sp, G, Q, nh, hd, st, s);
  return static_cast<int>(e);
}
