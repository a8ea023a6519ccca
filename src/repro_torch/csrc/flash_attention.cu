// K6: causal (optionally sliding-window) attention with an online softmax.
// This file holds the f32 kernel, on the CUDA cores, and the entry point;
// bf16 inputs go to the tensor-core kernel of flash_attention_tc.cu.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (pallas_call at :98, body _flash_kernel at :26; wrapper ops.py:31): for
// each query row, softmax(q k^T / sqrt(d)) v over the keys at or before it
// (and, with a window w > 0, after row - w), without the [S, S] scores ever
// reaching device memory.
//
// What bounds it: operations. At Zamba2-7B's attention shape (B*H = 128, S = 2048,
// d = 112) the causal half of q k^T and p v is ~120 GFLOP against ~0.2 GB
// moved; the arithmetic is f32 on the CUDA cores (as the TPU kernel's
// body: astype(f32) on load, f32 products), so the floor is 67 TFLOP/s.
//
// Design: grid = (query tiles, H, B), one block of 256 threads per
// (batch, head, 64-row query tile), the heaviest (last) query tiles first.
// The block reads q, k, v in the model's [B, S, heads, d] layout; query
// head h reads kv head h / (H / KV) (GQA, no repeated copy). It loops over
// the 64-key tiles that can hold a visible key (it skips those past the
// causal frontier and those wholly behind the window), staging K^T and V in
// shared memory as f32 (Q^T once). Each thread owns a 4 x 4 patch of the
// score tile (rows 4 ty .., keys 4 tx ..) and a 4 x 4 patch (two for
// d > 64) of the accumulator, fed by 16-byte shared loads: one of Q^T and
// one of K^T per 16 FMAs for the scores, one of P^T and one of V per 16
// for p v. The 16 threads of a row share its running max and normaliser
// through xor shuffles. A masked score is -inf, so its probability is
// exactly 0 and a row whose keys are all masked so far keeps l = 0 and
// acc = 0 (the TPU kernel's -1e30 gives such rows p = 1 until a later
// block rescales them by alpha = 0: the same result, with no garbage in
// between). The ragged edge of S is masked in the kernel: nothing is
// padded. The output is acc / max(l, 1e-30) in f32. Every sum runs
// in a fixed order: no atomics, bit-identical reruns.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kMaxD = 128;     // ops.py::MAX_HEAD_DIM
constexpr int ldt = kBQ + 4;   // rows of Q^T, K^T and P^T: 16-byte aligned, and
                               // the transposing stores below hit 32 banks
constexpr float kMInit = -1e30f;

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

// The max (or sum) over the 16 lanes that share a row (lanes tx = 0..15
// of one half-warp); every one of them ends with the same bits.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dst[c][r] = src row r, column c (0 past the S rows), for the
// 64 rows from row0 and the d columns, src rows ``row_stride`` apart. A
// warp covers 8 columns x 4 rows per store: 32 distinct banks.
__device__ __forceinline__ void load_transposed(float* dst, const float* src, size_t row_stride,
                                                int row0, int S, int d) {
  const int lane = threadIdx.x % 32, wrp = threadIdx.x / 32;
  const int c_lo = lane / 4, r_lo = lane % 4;
  const int n_blocks = (d + 7) / 8 * (kBQ / 4);
  for (int e = wrp; e < n_blocks; e += kThreads / 32) {
    const int c = (e / (kBQ / 4)) * 8 + c_lo, r = (e % (kBQ / 4)) * 4 + r_lo;
    if (c < d) dst[c * ldt + r] = row0 + r < S ? src[(row0 + r) * row_stride + c] : 0.f;
  }
}

// kWide: d > 64 (each thread owns a second group of 4 output columns, at +64).
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ out, int S, int H, int KV, int d, int causal, int window,
             float scale) {
  constexpr int vw = kWide ? 128 : 64;        // staged width of a V tile
  constexpr int nv = kWide ? 2 : 1;
  float* qt = repro::shared_as<float>();      // Q^T [d][ldt]
  float* kt = qt + d * ldt;                   // K^T [d][ldt]
  float* vs = kt + d * ldt;                   // V [kBK][vw]
  float* pt = vs + kBK * vw;                  // P^T [kBK][ldt]

  const int nq = (S + kBQ - 1) / kBQ;
  const int qtile = nq - 1 - blockIdx.x;      // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qtile * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, wrp = tid / 32;
  const size_t q_row = static_cast<size_t>(H) * d;
  const size_t kv_row = static_cast<size_t>(KV) * d;
  const float* qb = q + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * d;
  const float* kb = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kvh) * d;
  const float* vb = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kvh) * d;

  load_transposed(qt, qb, q_row, q0, S, d);

  float m[4], l[4], acc[nv][4][4] = {};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kMInit;
    l[a] = 0.f;
  }

  const int nk = (S + kBK - 1) / kBK;
  const int kt_end = causal ? min(nk, (q0 + kBQ - 1) / kBK + 1) : nk;
  for (int ktile = 0; ktile < kt_end; ++ktile) {
    const int k0 = ktile * kBK;
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;   // behind the window
    __syncthreads();
    load_transposed(kt, kb, kv_row, k0, S, d);
    for (int r = wrp; r < kBK; r += kThreads / 32) {
      const bool in = k0 + r < S;
#pragma unroll
      for (int c = lane; c < vw; c += 32)
        vs[r * vw + c] = in && c < d ? vb[(k0 + r) * kv_row + c] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < d; ++kk)
      fma4x4(s, ld4(qt + kk * ldt + 4 * ty), ld4(kt + kk * ldt + 4 * tx));

    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + 4 * ty + a;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        const bool ok = col < S && (!causal || col <= row) &&
                        (window <= 0 || col > row - window);
        s[a][j] = ok ? s[a][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[a][j]);
      }
      const float m_new = fmaxf(m[a], row_max16(mx));     // finite: m starts at -1e30
      const float alpha = expf(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[a][j] = expf(s[a][j] - m_new);                   // masked: exp(-inf) = 0
        psum += p[a][j];
      }
      l[a] = l[a] * alpha + row_sum16(psum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < nv; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][a][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * ldt + 4 * ty) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pa = ld4(pt + kk * ldt + 4 * ty);
#pragma unroll
      for (int c = 0; c < nv; ++c) fma4x4(acc[c], pa, ld4(vs + kk * vw + 64 * c + 4 * tx));
    }
  }

  float* ob = out + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * d;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + 4 * ty + a;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < nv; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 64 * c + 4 * tx + j;
        if (col < d) ob[row * q_row + col] = acc[c][a][j] * inv;
      }
  }
}

template <bool kWide>
size_t smem_bytes(int d) {
  constexpr int vw = kWide ? 128 : 64;
  return (2 * static_cast<size_t>(d) * ldt + static_cast<size_t>(kBK) * vw +
          static_cast<size_t>(kBK) * ldt) * sizeof(float);
}

template <bool kWide>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out, int B,
                         int S, int H, int KV, int d, int causal, int window,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes<kWide>(d);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<kWide>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  // 1/sqrt(d) as the TPU kernel's Python constant, rounded to f32
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  flash_kernel<kWide><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, H, KV, d, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int H, int KV, int d, int causal, int window, cudaStream_t stream) {
  return d > 64 ? launch_flash<true>(q, k, v, out, B, S, H, KV, d, causal, window, stream)
                : launch_flash<false>(q, k, v, out, B, S, H, KV, d, causal, window, stream);
}

template <bool kWide>
cudaError_t occupancy(int d, int* info) {
  const size_t smem = smem_bytes<kWide>(d);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<kWide>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return repro::kernel_occupancy(flash_kernel<kWide>, kThreads, smem, info);
}

}  // namespace

namespace repro {
cudaError_t flash_attention_tc(const void* q, const void* k, const void* v, void* out, int B,
                               int S, int H, int KV, int d, int causal, int window,
                               cudaStream_t stream);
cudaError_t flash_attention_tc_occupancy(int d, int* info);
}  // namespace repro

// dtype: 0 = float32 (this file's CUDA-core kernel), 2 = bfloat16 (the
// tensor-core kernel, flash_attention_tc.cu; d a multiple of 16); q, k, v
// and out alike. q, out [B, S, H, d] and k, v [B, S, KV, d], contiguous;
// H % KV == 0, d <= 128; causal 0/1; window 0 (none) or > 0. Returns the
// cudaError_t of the launch.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int S, int H,
                                     int KV, int d, int causal, int window,
                                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || d <= 0 || d > kMaxD ||
      window < 0 || H > 65535 || B > 65535 || (dtype != 0 && dtype != 2) ||
      (dtype == 2 && d % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? launch(q, k, v, out, B, S, H, KV, d, causal, window, st)
          : repro::flash_attention_tc(q, k, v, out, B, S, H, KV, d, causal, window, st);
  return static_cast<int>(e);
}

// The kernel that takes (dtype, d), as the card resolves it: info =
// {blocks per SM, registers a thread, shared bytes a block, threads, local
// bytes a thread} (common.cuh::kernel_occupancy).
extern "C" int repro_flash_occupancy(int dtype, int d, int* info) {
  if (d <= 0 || d > kMaxD || (dtype != 0 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = dtype == 2 ? repro::flash_attention_tc_occupancy(d, info)
                  : d > 64  ? occupancy<true>(d, info)
                            : occupancy<false>(d, info);
  return static_cast<int>(e);
}
