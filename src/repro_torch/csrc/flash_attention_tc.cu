// K6, bf16 inputs: causal (optionally sliding-window) attention on Hopper's
// tensor cores. Reached through repro_flash_attention (flash_attention.cu)
// for dtype 2; f32 inputs stay on that file's CUDA-core kernel.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (pallas_call at :98, body _flash_kernel at :26) for bf16 q, k, v: for each
// query row, softmax(q k^T / sqrt(d)) v over the keys visible to it, the
// [S, S] scores never reaching device memory.
//
// Numerics. The TPU kernel casts q, k, v to f32 and runs both products in
// f32. q k^T on bf16 inputs is exact in that sense: each bf16 x bf16
// product is exact in f32, and the tensor cores accumulate in f32. p is an
// f32 probability, so p v splits it: p_hi = bf16(p), p_lo = bf16(p - p_hi),
// and two bf16 products against the same V keep 16 bits of p (a relative
// error of at most 2^-17 a term, far under the bf16 output's 2^-9). The
// plain version rounds nothing but the output.
//
// What bounds it: operations. Per visible (row, key) pair, q k^T costs 2d
// and the split p v 4d on the bf16 tensor cores (989 TFLOP/s), the online
// softmax ~4 on the CUDA cores (67 TFLOP/s). At the served shape (B*H = 128,
// S = 2048, d = 112) that is 0.198 ms; the bytes take 0.070 ms.
//
// Design (wgmma, bf16 in, f32 accumulate; PERF.md has the mma.sync design
// it replaced, and why):
// - grid = (query tiles, H, B), heaviest causal tiles first. A block is two
//   warpgroups (8 warps) and owns 128 query rows: each warpgroup 64, each
//   warp 16 full rows. Query head h reads kv head h / (H / KV) in the
//   model's [B, S, heads, d] layout. The two warpgroups share every K and V
//   tile, which halves the tiles' traffic from L2 against 64-row blocks.
// - Q goes to shared memory by cp.async (16 bytes a thread) and into
//   registers once by ldmatrix: d/16 A fragments a warp.
// - K and V tiles of 64 keys go to a ring of three slots each by cp.async,
//   two tiles ahead; rows at or past S are zero-filled (src-size 0). Tiles
//   are laid out in 8 x 8 core matrices, so the tensor cores read them
//   through plain (unswizzled) descriptors without bank conflicts.
// - Per tile j, one warpgroup-wide wgmma sequence computes S = Q K^T into
//   registers (A = Q from registers, B = K, K-major), and a second computes
//   tile j-1's p v (A = p_hi, then p_lo, from registers; B = V, MN-major)
//   while the warps take tile j's online softmax: each row's max over the
//   quad of lanes that hold it (__shfl_xor_sync), the scale 1/sqrt(d)
//   folded with log2(e) into one multiply before ex2. Masks are applied
//   only on a tile that crosses the diagonal, the window's edge or the end
//   of S; interior tiles take the unmasked path. A masked score is -inf, so
//   its p is exactly 0.
// - P never leaves registers: an accumulator fragment of S is, once split,
//   an A fragment of p v.
// - Each lane keeps partial row sums; the quad sums them at the end. The
//   output is acc / max(l, 1e-30) in bf16. Every sum runs in a fixed
//   order: no atomics, bit-identical reruns.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWG = 2;                   // warpgroups a block
constexpr int kThreads = 128 * kWG;
constexpr int kBQ = 64 * kWG;            // query rows a block
constexpr int kBK = 64;                  // keys a tile
constexpr int kSlots = 3;                // ring slots for K, and for V (two tiles ahead)
constexpr int kNT = kBK / 8;             // 8-key column groups of S
constexpr float kMInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// what cp.async wrote becomes visible to the tensor cores' (async) reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; ftz: a tiny p is 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- wgmma -------------------------------------------------------------

// A shared tile of 64 rows x kD is laid out in 8 x 8 core matrices (8 rows
// of 16 bytes, 128 contiguous bytes each), row-major over (row / 8, col / 8):
// element (r, c) sits at ((r/8) (kD/8) + c/8) 64 + (r%8) 8 + c%8. The same
// layout is K-major for K (B of q k^T: a k-step's two core matrices 128
// bytes apart, the next 8 keys 16 kD bytes on) and MN-major for V (B of
// p v, transposed: the next 8 keys 16 kD bytes on, the next 8 columns 128
// bytes on). Descriptor: start, leading (K-direction) and stride
// (M/N-direction) byte offsets, each >> 4; no swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The registers hold what the wgmmas waited for wrote (and nothing moves
// them while a wgmma may still read or write them): a compiler fence on
// each, placed beside every wgmma issue and wait.
template <int R>
__device__ __forceinline__ void hold(float (&d)[R][4]) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&d)[kNT / 2][4]) {
#pragma unroll
  for (int j = 0; j < kNT / 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
}

// The asm operand lists of wgmma_rs: WG_Rj names the four registers of the
// accumulator's 8-column group j, WG_REGSn / WG_OUTSn those of an n-column
// accumulator, WG_TAILn the operands after it.
#define WG_R0 "%0, %1, %2, %3"
#define WG_R1 "%4, %5, %6, %7"
#define WG_R2 "%8, %9, %10, %11"
#define WG_R3 "%12, %13, %14, %15"
#define WG_R4 "%16, %17, %18, %19"
#define WG_R5 "%20, %21, %22, %23"
#define WG_R6 "%24, %25, %26, %27"
#define WG_R7 "%28, %29, %30, %31"
#define WG_R8 "%32, %33, %34, %35"
#define WG_R9 "%36, %37, %38, %39"
#define WG_R10 "%40, %41, %42, %43"
#define WG_R11 "%44, %45, %46, %47"
#define WG_R12 "%48, %49, %50, %51"
#define WG_R13 "%52, %53, %54, %55"
#define WG_R14 "%56, %57, %58, %59"
#define WG_R15 "%60, %61, %62, %63"
#define WG_REGS16 WG_R0 ", " WG_R1
#define WG_OUTS16 WG_O(0), WG_O(1)
#define WG_TAIL16 "}, {%8, %9, %10, %11}, %12, p, 1, 1, "
#define WG_SCALE16 "%13"
#define WG_REGS32 WG_REGS16 ", " WG_R2 ", " WG_R3
#define WG_OUTS32 WG_OUTS16, WG_O(2), WG_O(3)
#define WG_TAIL32 "}, {%16, %17, %18, %19}, %20, p, 1, 1, "
#define WG_SCALE32 "%21"
#define WG_REGS48 WG_REGS32 ", " WG_R4 ", " WG_R5
#define WG_OUTS48 WG_OUTS32, WG_O(4), WG_O(5)
#define WG_TAIL48 "}, {%24, %25, %26, %27}, %28, p, 1, 1, "
#define WG_SCALE48 "%29"
#define WG_REGS64 WG_REGS48 ", " WG_R6 ", " WG_R7
#define WG_OUTS64 WG_OUTS48, WG_O(6), WG_O(7)
#define WG_TAIL64 "}, {%32, %33, %34, %35}, %36, p, 1, 1, "
#define WG_SCALE64 "%37"
#define WG_REGS80 WG_REGS64 ", " WG_R8 ", " WG_R9
#define WG_OUTS80 WG_OUTS64, WG_O(8), WG_O(9)
#define WG_TAIL80 "}, {%40, %41, %42, %43}, %44, p, 1, 1, "
#define WG_SCALE80 "%45"
#define WG_REGS96 WG_REGS80 ", " WG_R10 ", " WG_R11
#define WG_OUTS96 WG_OUTS80, WG_O(10), WG_O(11)
#define WG_TAIL96 "}, {%48, %49, %50, %51}, %52, p, 1, 1, "
#define WG_SCALE96 "%53"
#define WG_REGS112 WG_REGS96 ", " WG_R12 ", " WG_R13
#define WG_OUTS112 WG_OUTS96, WG_O(12), WG_O(13)
#define WG_TAIL112 "}, {%56, %57, %58, %59}, %60, p, 1, 1, "
#define WG_SCALE112 "%61"
#define WG_REGS128 WG_REGS112 ", " WG_R14 ", " WG_R15
#define WG_OUTS128 WG_OUTS112, WG_O(14), WG_O(15)
#define WG_TAIL128 "}, {%64, %65, %66, %67}, %68, p, 1, 1, "
#define WG_SCALE128 "%69"
#define WG_O(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d (64 x N, f32; warp w of the warpgroup holds rows 16 w .. in mma.sync's
// C layout) += a b: a (64 x 16 bf16) in registers, warp w's rows in
// mma.sync's A layout; b (16 x N bf16) in shared memory by its descriptor,
// K-major (kTransB 0) or MN-major (1); scale_d 0 ignores d's old value.
template <int N, int kTransB>
__device__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t desc,
                         int scale_d);

#define WG_DEFINE(N, TRANS)                                                              \
  template <>                                                                            \
  __device__ __forceinline__ void wgmma_rs<N, TRANS>(                                    \
      float(&d)[N / 8][4], const uint32_t(&a)[4], uint64_t desc, int scale_d) {          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " WG_SCALE##N ", 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" WG_REGS##N \
                 WG_TAIL##N #TRANS ";\n}\n"                                              \
                 : WG_OUTS##N                                                            \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)); \
  }
WG_DEFINE(64, 0)   // q k^T: 64 keys
WG_DEFINE(16, 1)   // p v: N = d
WG_DEFINE(32, 1)
WG_DEFINE(48, 1)
WG_DEFINE(64, 1)
WG_DEFINE(80, 1)
WG_DEFINE(96, 1)
WG_DEFINE(112, 1)
WG_DEFINE(128, 1)

// The 64 rows from row0 of a [*, kD] slab (rows row_stride apart) into a
// core-matrix tile: 16-byte chunk e lands at byte 16 e (a warp's stores are
// contiguous), row (e / kD) 8 + e % 8, columns 8 ((e % kD) / 8) ..; rows at
// or past S are zeros.
template <int kD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t row_stride,
                                          int row0, int S) {
  constexpr int kChunks = kBK * kD / 8;
#pragma unroll
  for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    if (kChunks % kThreads != 0 && e >= kChunks) break;
    const int r = e / kD * 8 + e % 8, ch = e % kD / 8;
    const bool valid = row0 + r < S;
    const bf16* g = src + static_cast<size_t>(valid ? row0 + r : 0) * row_stride + ch * 8;
    cp_async16(smem_addr(dst + 8 * e), g, valid);
  }
}

// The online softmax of one 64-key tile of S (this lane's rows g and g+8
// of the warp's 16 from r0; keys from k0): masks where the tile crosses
// the diagonal, the window's edge or S, the running max and sum, S -> p in
// place; a_lo, a_hi: the factors that rescale the rows' old accumulators.
__device__ __forceinline__ void softmax_tile(float (&s)[kNT][4], float& m_lo, float& m_hi,
                                             float& l_lo, float& l_hi, float& a_lo,
                                             float& a_hi, int r0, int k0, int g, int t, int S,
                                             int causal, int window, float scale_log2) {
  if ((causal && k0 + kBK - 1 > r0) || (window > 0 && k0 <= r0 + 15 - window) ||
      k0 + kBK > S) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + e / 2 * 8, col = k0 + 8 * j + 2 * t + e % 2;
        const bool ok = col < S && (!causal || col <= row) && (window <= 0 || col > row - window);
        if (!ok) s[j][e] = -INFINITY;
      }
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
  }
  const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));   // finite: m starts at -1e30
  const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
  a_lo = ex2((m_lo - mn_lo) * scale_log2);
  a_hi = ex2((m_hi - mn_hi) * scale_log2);
  m_lo = mn_lo;
  m_hi = mn_hi;
  const float mc_lo = mn_lo * scale_log2, mc_hi = mn_hi * scale_log2;
  float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    s[j][0] = ex2(fmaf(s[j][0], scale_log2, -mc_lo));   // masked: 2^-inf = 0
    s[j][1] = ex2(fmaf(s[j][1], scale_log2, -mc_lo));
    s[j][2] = ex2(fmaf(s[j][2], scale_log2, -mc_hi));
    s[j][3] = ex2(fmaf(s[j][3], scale_log2, -mc_hi));
    ps_lo += s[j][0] + s[j][1];
    ps_hi += s[j][2] + s[j][3];
  }
  l_lo = l_lo * a_lo + ps_lo;
  l_hi = l_hi * a_hi + ps_hi;
}

// p (the accumulator fragments of S) -> the A fragments of p v, split into
// bf16 hi and lo parts: keys 16 kc .. 16 kc + 15 are fragment kc.
__device__ __forceinline__ void split_p(const float (&s)[kNT][4], uint32_t (&ph)[kNT / 2][4],
                                        uint32_t (&pl)[kNT / 2][4]) {
#pragma unroll
  for (int kc = 0; kc < kNT / 2; ++kc) {
    split_bf16(s[2 * kc][0], s[2 * kc][1], ph[kc][0], pl[kc][0]);
    split_bf16(s[2 * kc][2], s[2 * kc][3], ph[kc][1], pl[kc][1]);
    split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[kc][2], pl[kc][2]);
    split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[kc][3], pl[kc][3]);
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int S, int H, int KV,
                int causal, int window, float scale_log2) {
  constexpr int kKSteps = kD / 16;       // k-steps of q k^T
  constexpr int kTile = kBK * kD;        // elements of a Q, K or V tile
  constexpr uint32_t kRowBlock = 16 * kD;   // bytes between 8-row groups
  bf16* qs = repro::shared_as<bf16>();   // [Q: kWG tiles][K: kSlots][V: kSlots]
  bf16* ks = qs + kWG * kTile;
  bf16* vs = ks + kSlots * kTile;

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wg = warp / 4, wq = warp % 4;   // warpgroup; warp within it
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * wg + 16 * wq;    // this warp's first row
  const size_t q_row = static_cast<size_t>(H) * kD;
  const size_t kv_row = static_cast<size_t>(KV) * kD;
  const bf16* qb = q + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * kD;
  const bf16* kb = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kvh) * kD;
  const bf16* vb = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kvh) * kD;

  // the key tiles that hold a key visible to some row of the block:
  // j = 0 .. n-1 from kt_lo
  const int nk = (S + kBK - 1) / kBK;
  const int kt_hi = causal ? min(nk, (q0 + kBQ - 1) / kBK + 1) : nk;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int n = kt_hi - kt_lo;
  auto load_k = [&](int j) {
    if (j < n) load_tile<kD>(ks + j % kSlots * kTile, kb, kv_row, (kt_lo + j) * kBK, S);
    cp_async_commit();
  };
  auto load_v = [&](int j) {
    if (j < n) load_tile<kD>(vs + j % kSlots * kTile, vb, kv_row, (kt_lo + j) * kBK, S);
    cp_async_commit();
  };

  // commits in order: Q, K0, V0, K1 | K2, V1 | K3, V2 | ... (tile j adds
  // K(j+2), V(j+1)), so at tile j, K(j) and V(j-1) are all but the last two
#pragma unroll
  for (int w = 0; w < kWG; ++w) load_tile<kD>(qs + w * kTile, qb, q_row, q0 + 64 * w, S);
  cp_async_commit();
  load_k(0);
  load_v(0);
  load_k(1);

  uint32_t qf[kKSteps][4], ph[kNT / 2][4], pl[kNT / 2][4];
  float o[kD / 8][4], s[kNT][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  float m_lo = kMInit, m_hi = kMInit, l_lo = 0.f, l_hi = 0.f, a_lo, a_hi;   // rows g, g+8

  for (int j = 0; j < n; ++j) {
    cp_async_wait<2>();   // K(j) and V(j-1) (and Q)
    fence_async_shared();
    __syncthreads();      // ... from every thread; K(j-1) and V(j-2) are free
    load_k(j + 2);
    load_v(j + 1);
    if (j == 0) {
      const int mtx = lane / 8;   // the core matrix this lane addresses
      const bf16* qw = qs + wg * kTile;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(qw + ((2 * wq + mtx % 2) * (kD / 8) + 2 * kk + mtx / 2) *
                                               64 + lane % 8 * 8));
    }
    const bf16* kj = ks + j % kSlots * kTile;
    const bf16* vp = vs + (j + kSlots - 1) % kSlots * kTile;   // V(j-1)
    hold(s);
    hold(o);
    hold(ph);
    hold(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      wgmma_rs<kBK, 0>(s, qf[kk], smem_desc(kj + 2 * 64 * kk, 128, kRowBlock), kk > 0);
    wgmma_commit();
    if (j > 0) {
#pragma unroll
      for (int kc = 0; kc < kNT / 2; ++kc) {
        const uint64_t dv = smem_desc(vp + 2 * kc * 8 * kD, kRowBlock, 128);
        wgmma_rs<kD, 1>(o, ph[kc], dv, 1);
        wgmma_rs<kD, 1>(o, pl[kc], dv, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();      // q k^T of tile j
    hold(s);
    softmax_tile(s, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, r0, (kt_lo + j) * kBK, g, t, S, causal,
                 window, scale_log2);
    wgmma_wait<0>();      // p v of tile j-1
    hold(o);
    hold(ph);
    hold(pl);
#pragma unroll
    for (int jj = 0; jj < kD / 8; ++jj) {
      o[jj][0] *= a_lo;
      o[jj][1] *= a_lo;
      o[jj][2] *= a_hi;
      o[jj][3] *= a_hi;
    }
    split_p(s, ph, pl);
  }

  cp_async_wait<0>();     // V(n-1)
  fence_async_shared();
  __syncthreads();
  hold(o);
  hold(ph);
  hold(pl);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < kNT / 2; ++kc) {
    const uint64_t dv = smem_desc(vs + (n - 1) % kSlots * kTile + 2 * kc * 8 * kD, kRowBlock, 128);
    wgmma_rs<kD, 1>(o, ph[kc], dv, 1);
    wgmma_rs<kD, 1>(o, pl[kc], dv, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  hold(o);

  const float inv_lo = 1.f / fmaxf(quad_sum(l_lo), 1e-30f);
  const float inv_hi = 1.f / fmaxf(quad_sum(l_hi), 1e-30f);
  bf16* ob = out + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * kD;
  const int row_lo = r0 + g, row_hi = r0 + g + 8;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * q_row + col) =
          __floats2bfloat162_rn(o[j][0] * inv_lo, o[j][1] * inv_lo);
    if (row_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_hi * q_row + col) =
          __floats2bfloat162_rn(o[j][2] * inv_hi, o[j][3] * inv_hi);
  }
}

template <int kD>
size_t smem_bytes() {
  return static_cast<size_t>(kWG + 2 * kSlots) * kBK * kD * sizeof(bf16);
}

template <int kD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int B, int S,
                      int H, int KV, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<kD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  // 1/sqrt(d) as the TPU kernel's Python constant, rounded to f32, times log2(e)
  const float scale_log2 = static_cast<float>(1.0 / sqrt(static_cast<double>(kD))) * kLog2e;
  flash_tc_kernel<kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, H, KV, causal, window, scale_log2);
  return cudaGetLastError();
}

template <int kD>
cudaError_t occupancy_tc(int* info) {
  const size_t smem = smem_bytes<kD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return repro::kernel_occupancy(flash_tc_kernel<kD>, kThreads, smem, info);
}

}  // namespace

namespace repro {

// bf16 q, out [B, S, H, d], k, v [B, S, KV, d]; d a multiple of 16, <= 128.
cudaError_t flash_attention_tc(const void* q, const void* k, const void* v, void* out, int B,
                               int S, int H, int KV, int d, int causal, int window,
                               cudaStream_t stream) {
  switch (d) {
    case 16: return launch_tc<16>(q, k, v, out, B, S, H, KV, causal, window, stream);
    case 32: return launch_tc<32>(q, k, v, out, B, S, H, KV, causal, window, stream);
    case 48: return launch_tc<48>(q, k, v, out, B, S, H, KV, causal, window, stream);
    case 64: return launch_tc<64>(q, k, v, out, B, S, H, KV, causal, window, stream);
    case 80: return launch_tc<80>(q, k, v, out, B, S, H, KV, causal, window, stream);
    case 96: return launch_tc<96>(q, k, v, out, B, S, H, KV, causal, window, stream);
    case 112: return launch_tc<112>(q, k, v, out, B, S, H, KV, causal, window, stream);
    case 128: return launch_tc<128>(q, k, v, out, B, S, H, KV, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t flash_attention_tc_occupancy(int d, int* info) {
  switch (d) {
    case 16: return occupancy_tc<16>(info);
    case 32: return occupancy_tc<32>(info);
    case 48: return occupancy_tc<48>(info);
    case 64: return occupancy_tc<64>(info);
    case 80: return occupancy_tc<80>(info);
    case 96: return occupancy_tc<96>(info);
    case 112: return occupancy_tc<112>(info);
    case 128: return occupancy_tc<128>(info);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro
