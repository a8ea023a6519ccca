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
// What bounds it: bytes, once the products run on the tensor cores. At
// Zamba2-7B's served shape (G = 32 chunks, nh = 112, Q = 256, hd = st =
// 64) the three products are ~23 GFLOP; split into three TF32 passes each
// they take 0.14 ms at the 495 TFLOP/s TF32 rate, while x, y and the state
// (~0.54 GB) take 0.16 ms at 3.35 TB/s. On the CUDA cores (the design this
// one replaces) the same products took 0.34 ms at 67 TFLOP/s at best.
//
// Design: every product on the tensor cores (mma.sync m16n8k8 .tf32, f32
// accumulate), f32 kept by a split: an f32 operand a is a_hi + a_lo with
// a_hi = tf32(a) and a_lo = tf32(a - a_hi), and each product sums
// a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, ~2^-22 of the product, is
// dropped). One TF32 pass keeps ~2^-11 and would break the 1e-5 contract.
// Each k-step's three passes land in a zeroed fragment that a round-to-
// nearest add sums into the running f32 accumulator (mma3).
//  1. cb_kernel computes C B^T once per chunk (not per head) into a
//     [G, Qp, Qp] f32 scratch the wrapper allocates (Qp: Q rounded up to
//     64), row-major, only the 64 x 64 tiles on or below the diagonal. At
//     G = 32, Q = 256 it is 8 MB and stays in the 50 MB L2 cache.
//  2. ssd_kernel: one block of 8 warps per (head, chunk). It copies the
//     chunk's x for its head into shared memory once by cp.async (row
//     pitch hd + 4: the fragments' loads are conflict-free), and the
//     state's first B chunk with it. For y, warp w owns the 16-row groups
//     w and 15 - w (equal causal work); per 8 keys it loads the CB
//     fragment from L2 straight into the accumulator layout, forms
//     M' = CB * exp(da_i - da_j) * dt_j there, masking BEFORE the exp
//     (above the diagonal seg > 0 is never exponentiated), splits it in
//     registers and uses it as the A operand against x. That works because
//     the k order of a product is free: A's k slots tig and tig + 4 are
//     taken to be keys 2 tig and 2 tig + 1, the layout of the accumulator's
//     columns, and x is read with the same key map. The state, (x w)^T B
//     with w_j = dt_j exp(da_last - da_j), reuses the staged x as its A
//     operand (transposed by reading it the other way) against B, staged
//     in double-buffered chunks of 64 keys (32 for st > 64) by cp.async,
//     the next chunk in flight during this one. x, y and the state stay in
//     the model's layout ([G, Q, nh, hd], [G, nh, hd, st]); ragged Q, hd
//     and st are zero padded in shared memory. The products run in a fixed
//     order and nothing is atomic: reruns are bit-identical. Measured
//     (PERF.md): 0.85 ms at the shape above, 5.3x its bound (0.77 ms
//     before the per-k-step add of mma3); it is bound by
//     latency (1.4 of 4 instructions a cycle issued, the tensor cores a
//     quarter busy), 16 warps an SM (registers and shared memory allow two
//     blocks).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCbThreads = 128;  // cb_kernel: 4 warps of 16 rows
constexpr int kT = 64;           // cb_kernel's tile; Qp is a multiple of it
constexpr int kMaxQ = 256;       // ops.py::MAX_CHUNK
constexpr int kMaxDim = 128;     // ops.py::MAX_DIM (hd and st)

// ---- split TF32 on the tensor cores -------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value (an f32 with its 13 low mantissa bits 0).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile: a (16 x 8) a[0..3] at (row grp, k tig),
// (grp + 8, tig), (grp, tig + 4), (grp + 8, tig + 4); b (8 x 8) b[0..1] at
// (k tig, col grp), (tig + 4, grp); d at (grp, 2 tig), (grp, 2 tig + 1),
// (grp + 8, 2 tig), (grp + 8, 2 tig + 1), with grp = lane / 4, tig = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The split product of one k-step, the small terms first, into a zeroed
// fragment that an IEEE add (round to nearest) then adds to d. The tensor
// cores' own f32 accumulation drops low bits when it aligns its addends;
// chained through a contraction of 16-32 k-steps that error grew with the
// depth and put the kernel 1.2e-6 from an f64 truth at Mamba-2-2.7B's
// shape (st = 128), three times the plain version's 4.2e-7, and 64 such
// layers carried it past the 1e-4 f32 logits gate. Added per k-step, 3.2e-7.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], t[e]);
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
}

__device__ __forceinline__ void split2(float2 v, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split(v.x, hi[0], lo[0]);
  split(v.y, hi[1], lo[1]);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// ---- 1. C B^T once per chunk -------------------------------------------

// cb[g, i, j] = sum_s C[g, i, s] B[g, j, s] on the 64 x 64 tiles j <= i,
// row-major [Qp, Qp]; rows and keys past Q come out 0 (zero-padded C, B).
// kSt: st padded to 64 or 128.
template <int kSt>
__global__ void __launch_bounds__(kCbThreads)
cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ cb,
          int Q, int Qp, int st) {
  constexpr int ld = kSt + 8;              // row pitch: 8-byte loads conflict-free
  float* cs = repro::shared_as<float>();   // [kT][ld]
  float* bs = cs + kT * ld;                // [kT][ld]
  // blockIdx.x enumerates the lower-triangular tile pairs (it, jt <= it)
  int it = 0, rem = blockIdx.x;
  while (rem > it) { rem -= it + 1; ++it; }
  const int i0 = it * kT, j0 = rem * kT;
  const int g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  const float* cg = Cm + static_cast<size_t>(g) * Q * st;
  const float* bg = Bm + static_cast<size_t>(g) * Q * st;
  for (int e = tid; e < kT * kSt; e += kCbThreads) {
    const int r = e / kSt, c = e % kSt;
    cs[r * ld + c] = i0 + r < Q && c < st ? cg[(i0 + r) * st + c] : 0.f;
    bs[r * ld + c] = j0 + r < Q && c < st ? bg[(j0 + r) * st + c] : 0.f;
  }
  __syncthreads();
  // warp w: rows 16 w .. 16 w + 15 of the tile, all 64 keys (8 n-tiles);
  // k slots tig, tig + 4 hold s = s0 + 2 tig, s0 + 2 tig + 1 in A and B alike
  float acc[kT / 8][4] = {};
  const float* ca = cs + (16 * warp + grp) * ld + 2 * tig;
#pragma unroll 2
  for (int s0 = 0; s0 < kSt; s0 += 8) {
    const float2 lo_row = ld2(ca + s0), hi_row = ld2(ca + 8 * ld + s0);
    const float a[4] = {lo_row.x, hi_row.x, lo_row.y, hi_row.y};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int t = 0; t < kT / 8; ++t) {
      uint32_t bh[2], bl[2];
      split2(ld2(bs + (8 * t + grp) * ld + s0 + 2 * tig), bh, bl);
      mma3(acc[t], ah, al, bh, bl);
    }
  }
  float* out = cb + (static_cast<size_t>(g) * Qp + i0 + 16 * warp + grp) * Qp + j0 + 2 * tig;
#pragma unroll
  for (int t = 0; t < kT / 8; ++t) {
    *reinterpret_cast<float2*>(out + 8 * t) = make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(out + 8 * static_cast<size_t>(Qp) + 8 * t) =
        make_float2(acc[t][2], acc[t][3]);
  }
}

// ---- 2. y and the chunk state per (head, chunk) -------------------------

// p[0] = a and p[1] = b where they lie inside the row (left: the columns
// from p to its end); one 8-byte store where both do and p is aligned.
__device__ __forceinline__ void store2(float* p, float a, float b, int left) {
  if (left >= 2 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (left >= 1) p[0] = a;
    if (left >= 2) p[1] = b;
  }
}

// exp(x) as 2^(x log2 e) on the SFU: ~2 + 1.2 |x| ulp. A decay term with
// |x| large is e^x small, so its share of y keeps ~1e-7 relative accuracy.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first nrows rows of a row-major [*, width] global array (row pitch
// gpitch floats) into shared rows of pitch spitch, by cp.async (16 bytes at
// a time where width is a multiple of 4), then zeros: columns width ..
// kW - 1, and rows past `valid` (of the nrows) entirely.
template <int kW>
__device__ __forceinline__ void stage_rows(float* dst, int spitch, const float* src,
                                           size_t gpitch, int nrows, int valid, int width,
                                           int tid) {
  if (width % 4 == 0) {
    const int cpr = width / 4;
    for (int e = tid; e < valid * cpr; e += kThreads) {
      const int r = e / cpr, c = 4 * (e - r * cpr);
      cp_async16(dst + r * spitch + c, src + r * gpitch + c);
    }
  } else {
    for (int e = tid; e < valid * width; e += kThreads) {
      const int r = e / width, c = e - r * width;
      cp_async4(dst + r * spitch + c, src + r * gpitch + c);
    }
  }
  const int pad = kW - width;
  for (int e = tid; e < valid * pad; e += kThreads) {
    const int r = e / pad;
    dst[r * spitch + width + e - r * pad] = 0.f;
  }
  for (int e = tid; e < (nrows - valid) * kW; e += kThreads) {
    const int r = valid + e / kW;
    dst[r * spitch + e % kW] = 0.f;
  }
}

// Keys of the state's B chunks: double-buffered, 64 keys (st <= 64) or 32.
template <int kSt>
constexpr int kStateChunk = kSt == 64 ? 64 : 32;

// Shared floats of ssd_kernel: da, dt, w = dt exp(da_last - da) (3 x
// kMaxQ); x [Qr x (kHd + 4)]; two B chunks [kStateChunk x (kSt + 4)].
template <int kHd, int kSt>
size_t ssd_smem(int Qr) {
  return (3 * static_cast<size_t>(kMaxQ) + static_cast<size_t>(Qr) * (kHd + 4) +
          2 * static_cast<size_t>(kStateChunk<kSt>) * (kSt + 4)) * sizeof(float);
}

// kHd, kSt: hd and st padded to 64 or 128. Qr: Q rounded up to 16 (row
// groups); Qp: the scratch's pitch.
template <int kHd, int kSt>
__global__ void __launch_bounds__(kThreads, kHd == 64 ? 2 : 1)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ da, const float* __restrict__ Bm,
           const float* __restrict__ cb, float* __restrict__ y, float* __restrict__ state,
           int Q, int Qr, int Qp, int nh, int hd, int st) {
  constexpr int ldx = kHd + 4, ldb = kSt + 4;   // row pitches: conflict-free fragments
  constexpr int NT = kHd / 8;                   // y: n-tiles of a row group
  constexpr int MT = kHd / 16;                  // state: m-tiles (head dims)
  constexpr int NSW = kSt / 8 / (kWarps / MT);  // state: n-tiles a warp owns
  constexpr int KC = kStateChunk<kSt>;
  float* das = repro::shared_as<float>();       // [kMaxQ]
  float* dts = das + kMaxQ;                     // [kMaxQ]
  float* ws = dts + kMaxQ;                      // [kMaxQ] dt_j exp(da_last - da_j)
  float* xs = ws + kMaxQ;                       // x [Qr][ldx]
  float* bsm = xs + static_cast<size_t>(Qr) * ldx;   // B chunks [2][KC][ldb]
  const int h = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  const size_t x_row = static_cast<size_t>(nh) * hd;
  const float* xg = x + static_cast<size_t>(g) * Q * x_row + static_cast<size_t>(h) * hd;
  float* yg = y + static_cast<size_t>(g) * Q * x_row + static_cast<size_t>(h) * hd;
  const float* bg = Bm + static_cast<size_t>(g) * Q * st;
  const int nchunks = (Qr + KC - 1) / KC;
  auto stage_b = [&](int c) {   // B chunk c into buffer c % 2
    const int j0 = c * KC, keys = Qr - j0 < KC ? Qr - j0 : KC;
    const int valid = Q - j0 < keys ? Q - j0 : keys;
    stage_rows<kSt>(bsm + (c & 1) * KC * ldb, ldb, bg + static_cast<size_t>(j0) * st, st,
                    keys, valid, st, tid);
  };

  // x (group 1) and the state's first B chunk (group 2) in flight while
  // the decays are computed and, for B, while y is
  stage_rows<kHd>(xs, ldx, xg, x_row, Qr, Q, hd, tid);
  cp_async_commit();
  stage_b(0);
  cp_async_commit();
  for (int r = tid; r < Qr; r += kThreads) {
    const size_t at = (static_cast<size_t>(g) * Q + r) * nh + h;
    das[r] = r < Q ? da[at] : 0.f;
    dts[r] = r < Q ? dt[at] : 0.f;
  }
  __syncthreads();
  const float da_last = das[Q - 1];
  for (int r = tid; r < Qr; r += kThreads) ws[r] = r < Q ? dts[r] * expf(da_last - das[r]) : 0.f;
  cp_async_wait<1>();
  __syncthreads();

  // y: warp w owns row groups w and 2 kWarps - 1 - w (16 rows each); the A
  // operand is M' = CB * exp(da_i - da_j) * dt_j, the B operand x
  for (int pass = 0; pass < 2; ++pass) {
    const int rg = pass == 0 ? warp : 2 * kWarps - 1 - warp;
    if (16 * rg >= Qr) continue;
    const int ia = 16 * rg + grp, ib = ia + 8;
    const float da_a = das[ia], da_b = das[ib];
    const float* cba = cb + (static_cast<size_t>(g) * Qp + ia) * Qp + 2 * tig;
    const float* cbb = cba + 8 * static_cast<size_t>(Qp);
    const float* xp = xs + 2 * tig * ldx + grp;     // key 2 tig, column grp
    const int nks = 2 * rg + 2;                     // 8-key steps up to row 16 rg + 15
    float acc[NT][4] = {};
    float2 ca = ld2(cba), cbv = ld2(cbb);
    for (int ks = 0; ks < nks; ++ks) {
      const int j = 8 * ks + 2 * tig;
      float2 na = ca, nb = cbv;
      if (ks + 1 < nks) {           // the next step's CB, in flight during this one
        na = ld2(cba + 8 * (ks + 1));
        nb = ld2(cbb + 8 * (ks + 1));
      }
      // M' in the accumulator's layout, masked before the exp; k slots tig
      // and tig + 4 are keys j and j + 1
      const float dj0 = das[j], dj1 = das[j + 1], t0 = dts[j], t1 = dts[j + 1];
      const float m[4] = {
          ia < Q && j <= ia ? ca.x * fast_exp(da_a - dj0) * t0 : 0.f,
          ib < Q && j <= ib ? cbv.x * fast_exp(da_b - dj0) * t0 : 0.f,
          ia < Q && j + 1 <= ia ? ca.y * fast_exp(da_a - dj1) * t1 : 0.f,
          ib < Q && j + 1 <= ib ? cbv.y * fast_exp(da_b - dj1) * t1 : 0.f};
      uint32_t ah[4], al[4];
      split4(m, ah, al);
      const float* xk = xp + 8 * ks * ldx;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t bh[2], bl[2];
        split2(make_float2(xk[8 * t], xk[ldx + 8 * t]), bh, bl);
        mma3(acc[t], ah, al, bh, bl);
      }
      ca = na;
      cbv = nb;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = 8 * t + 2 * tig;
      if (ia < Q) store2(yg + ia * x_row + c, acc[t][0], acc[t][1], hd - c);
      if (ib < Q) store2(yg + ib * x_row + c, acc[t][2], acc[t][3], hd - c);
    }
  }

  // chunk state: (x w)^T B over the B chunks, the next one in flight. Warp
  // w: m-tile w % MT (16 head dims), n-tiles (w / MT) NSW .. + NSW.
  const int mt = warp % MT, n0 = (warp / MT) * NSW;
  const float* xa = xs + 2 * tig * ldx + 16 * mt + grp;   // key 2 tig, head dim
  float sacc[NSW][4] = {};
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      stage_b(c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk c in place for every warp
    const int j0 = c * KC, keys = Qr - j0 < KC ? Qr - j0 : KC;
    const float* bk = bsm + (c & 1) * KC * ldb + 2 * tig * ldb + grp;
    for (int kk = 0; kk < keys; kk += 8) {
      // A = (x w)^T: rows are head dims, k slots tig / tig + 4 keys 2 tig / + 1
      const int j = j0 + kk;
      const float* xr = xa + j * ldx;
      const float w0 = ws[j + 2 * tig], w1 = ws[j + 2 * tig + 1];
      const float a[4] = {xr[0] * w0, xr[8] * w0, xr[ldx] * w1, xr[ldx + 8] * w1};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
      const float* br = bk + kk * ldb;
#pragma unroll
      for (int t = 0; t < NSW; ++t) {
        uint32_t bh[2], bl[2];
        split2(make_float2(br[8 * (n0 + t)], br[ldb + 8 * (n0 + t)]), bh, bl);
        mma3(sacc[t], ah, al, bh, bl);
      }
    }
    __syncthreads();   // chunk c consumed before its buffer takes chunk c + 2
  }
  float* sg = state + (static_cast<size_t>(g) * nh + h) * hd * st;
  const int pa = 16 * mt + grp, pb = pa + 8;
#pragma unroll
  for (int t = 0; t < NSW; ++t) {
    const int c = 8 * (n0 + t) + 2 * tig;
    if (pa < hd) store2(sg + pa * st + c, sacc[t][0], sacc[t][1], st - c);
    if (pb < hd) store2(sg + pb * st + c, sacc[t][2], sacc[t][3], st - c);
  }
}

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int kSt>
cudaError_t launch_cb(const float* Bm, const float* Cm, float* cb, int G, int Q, int st,
                      cudaStream_t s) {
  const int Qp = round_up(Q, kT), nt = Qp / kT;
  const size_t smem = 2 * static_cast<size_t>(kT) * (kSt + 8) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(cb_kernel<kSt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cb_kernel<kSt><<<dim3(nt * (nt + 1) / 2, G), kCbThreads, smem, s>>>(Bm, Cm, cb, Q, Qp, st);
  return cudaGetLastError();
}

template <int kHd, int kSt>
cudaError_t set_ssd_smem(int Q, size_t* smem) {
  *smem = ssd_smem<kHd, kSt>(round_up(Q, 16));
  return cudaFuncSetAttribute(ssd_kernel<kHd, kSt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <int kHd, int kSt>
cudaError_t launch_ssd(const float* x, const float* dt, const float* da, const float* Bm,
                       const float* cb, float* y, float* state, int G, int Q, int nh, int hd,
                       int st, cudaStream_t s) {
  size_t smem = 0;
  cudaError_t e = set_ssd_smem<kHd, kSt>(Q, &smem);
  if (e != cudaSuccess) return e;
  ssd_kernel<kHd, kSt><<<dim3(nh, G), kThreads, smem, s>>>(
      x, dt, da, Bm, cb, y, state, Q, round_up(Q, 16), round_up(Q, kT), nh, hd, st);
  return cudaGetLastError();
}

template <int kHd, int kSt>
cudaError_t occupancy_ssd(int Q, int* info) {
  size_t smem = 0;
  cudaError_t e = set_ssd_smem<kHd, kSt>(Q, &smem);
  if (e != cudaSuccess) return e;
  return repro::kernel_occupancy(ssd_kernel<kHd, kSt>, kThreads, smem, info);
}

bool bad_shape(int Q, int hd, int st) {
  return Q <= 0 || Q > kMaxQ || hd <= 0 || hd > kMaxDim || st <= 0 || st > kMaxDim;
}

}  // namespace

// All float32, contiguous, in the model's layout: x [G, Q, nh, hd];
// dt, da [G, Q, nh]; B, C [G, Q, st]; cb (scratch) [G, Qp, Qp] with Qp = Q
// rounded up to 64; y [G, Q, nh, hd]; state [G, nh, hd, st]. Q <= 256, hd
// and st <= 128. Returns the cudaError_t of the launches.
extern "C" int repro_ssd(const void* x, const void* dt, const void* da, const void* Bm,
                         const void* Cm, void* cb, void* y, void* state, int G, int Q,
                         int nh, int hd, int st, void* stream) {
  if (G <= 0 || G > 65535 || nh <= 0 || bad_shape(Q, hd, st))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const float*>(Bm);
  const auto* cp = static_cast<const float*>(Cm);
  auto* cbp = static_cast<float*>(cb);
  cudaError_t e = st > 64 ? launch_cb<128>(bp, cp, cbp, G, Q, st, s)
                          : launch_cb<64>(bp, cp, cbp, G, Q, st, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* xp = static_cast<const float*>(x);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* dap = static_cast<const float*>(da);
  auto* yp = static_cast<float*>(y);
  auto* sp = static_cast<float*>(state);
  if (hd > 64)
    e = st > 64 ? launch_ssd<128, 128>(xp, dtp, dap, bp, cbp, yp, sp, G, Q, nh, hd, st, s)
                : launch_ssd<128, 64>(xp, dtp, dap, bp, cbp, yp, sp, G, Q, nh, hd, st, s);
  else
    e = st > 64 ? launch_ssd<64, 128>(xp, dtp, dap, bp, cbp, yp, sp, G, Q, nh, hd, st, s)
                : launch_ssd<64, 64>(xp, dtp, dap, bp, cbp, yp, sp, G, Q, nh, hd, st, s);
  return static_cast<int>(e);
}

// What the card makes of ssd_kernel at chunk Q, head dim hd and state st,
// without launching it: info as common.cuh's kernel_occupancy fills it.
extern "C" int repro_ssd_occupancy(int Q, int hd, int st, int* info) {
  if (bad_shape(Q, hd, st)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = hd > 64 ? (st > 64 ? occupancy_ssd<128, 128>(Q, info)
                                     : occupancy_ssd<128, 64>(Q, info))
                          : (st > 64 ? occupancy_ssd<64, 128>(Q, info)
                                     : occupancy_ssd<64, 64>(Q, info));
  return static_cast<int>(e);
}
