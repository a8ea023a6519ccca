// K4 + K5: the int8 stochastic-rounding wire codec, encode and decode as two
// launches, every client in each.
//
// repro_quantize replaces the TPU kernel
// repro/kernels/quant/quant.py::quantize_pallas (pallas_call at :56, body
// _quantize_kernel at :28): per chunk of C values,
//
//   scale = max|x| / 127  (1 for an all-zero chunk)
//   q     = clip(floor(x / scale + u), -127, 127)  as int8
//
// with the uniforms u in [0, 1) an input, so the plain version
// (kernels/quant/ref.py) gives the same codes from the same draws.
//
// repro_dequantize replaces quantize.py::dequantize_pallas (pallas_call at
// :82, body _dequantize_kernel at :45): out = q * scale of its chunk.
//
// What bounds them: device memory. Quantize reads x (4 B, or 8 B for a
// float64 x, converted on load) and u (4 B) and writes q (1 B) per value
// plus one 4 B scale per chunk; dequantize reads 1 B and writes 4 B (or
// 8 B) per value. There is about one division per value, far below the
// card's rate. Only the n values of a row carry data: the draws of the
// ragged chunk's padding lanes are not read (a padding value is 0, so its
// code floor(0 / scale + u) is 0 whatever u is, and is written as 0).
//
// Design: one warp per chunk, 8 warps per block. Lane l holds slots
// i = 0..VPL-1 at column i * 32 + l, so each load instruction of the warp
// reads 32 neighbouring values (coalesced), and the chunk's values stay in
// registers between the max and the rounding: x is read once. The max is a
// __shfl_xor butterfly; max is order-free, so the result is deterministic
// with no atomics. Lane 0 writes the scale. The x row of a client is read
// at its true length n with its own row stride: columns at or past n read
// as 0 (what the reference's zero padding of the flat vector gives), and
// the grid covers exactly B * nc chunks, so neither the reference's
// pad-to-chunk copy nor its ROW_TILE=8 padding of the chunk count is
// needed. Decode writes only the first n columns of each row.
//
// Exactness: x / scale and amax / 127 are IEEE divisions (__fdiv_rn; the
// library builds without --use_fast_math), the add is __fadd_rn (never
// contracted into an FMA), so q and the scales are bit-identical to the
// plain version given the same u.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kQuantWarps = 8;
constexpr int kQuantThreads = kQuantWarps * 32;
constexpr int kMaxChunk = 1024;

// max that propagates NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <typename TX, int VPL>
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const TX* __restrict__ x, long long n, const float* __restrict__ u,
                int8_t* __restrict__ q, float* __restrict__ scales, long long chunks,
                int nc, int C) {
  const long long chunk = static_cast<long long>(blockIdx.x) * kQuantWarps +
                          (threadIdx.x >> 5);
  if (chunk >= chunks) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long b = chunk / nc;
  const long long c0 = (chunk - b * nc) * C;  // first column of the chunk
  const TX* xrow = x + b * n;
  const long long base = chunk * C;
  // every load of the chunk is issued before the first use
  float v[VPL], r[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = i * 32 + lane;
    const long long col = c0 + j;
    const bool live = j < C && col < n;
    v[i] = live ? static_cast<float>(xrow[col]) : 0.0f;
    r[i] = live ? u[base + j] : 0.0f;
  }
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) amax = nan_max(amax, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = i * 32 + lane;
    if (j < C) {
      const float f = floorf(__fadd_rn(__fdiv_rn(v[i], scale), r[i]));
      q[base + j] = static_cast<int8_t>(__float2int_rz(fminf(fmaxf(f, -127.0f), 127.0f)));
    }
  }
  if (lane == 0) scales[chunk] = scale;
}

template <typename TO, int VPL>
__global__ void __launch_bounds__(kQuantThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  TO* __restrict__ out, long long n, long long chunks, int nc, int C) {
  const long long chunk = static_cast<long long>(blockIdx.x) * kQuantWarps +
                          (threadIdx.x >> 5);
  if (chunk >= chunks) return;
  const int lane = threadIdx.x & 31;
  const long long b = chunk / nc;
  const long long c0 = (chunk - b * nc) * C;
  const float scale = scales[chunk];
  const long long base = chunk * C;
  TO* orow = out + b * n;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = i * 32 + lane;
    const long long col = c0 + j;
    if (j < C && col < n)
      orow[col] = static_cast<TO>(__fmul_rn(static_cast<float>(q[base + j]), scale));
  }
}

// values per lane: the least power of two with 32 * VPL >= C
int lanes_slots(int C) {
  int vpl = 1;
  while (32 * vpl < C) vpl *= 2;
  return vpl;
}

template <typename TX, int VPL>
cudaError_t launch_q(const void* x, long long n, const void* u, void* q, void* scales,
                     long long chunks, int nc, int C, cudaStream_t st) {
  const long long blocks = (chunks + kQuantWarps - 1) / kQuantWarps;
  quantize_kernel<TX, VPL><<<static_cast<unsigned>(blocks), kQuantThreads, 0, st>>>(
      static_cast<const TX*>(x), n, static_cast<const float*>(u),
      static_cast<int8_t*>(q), static_cast<float*>(scales), chunks, nc, C);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_q(const void* x, long long n, const void* u, void* q, void* scales,
                       long long chunks, int nc, int C, cudaStream_t st) {
  switch (lanes_slots(C)) {
    case 1: return launch_q<TX, 1>(x, n, u, q, scales, chunks, nc, C, st);
    case 2: return launch_q<TX, 2>(x, n, u, q, scales, chunks, nc, C, st);
    case 4: return launch_q<TX, 4>(x, n, u, q, scales, chunks, nc, C, st);
    case 8: return launch_q<TX, 8>(x, n, u, q, scales, chunks, nc, C, st);
    case 16: return launch_q<TX, 16>(x, n, u, q, scales, chunks, nc, C, st);
    default: return launch_q<TX, 32>(x, n, u, q, scales, chunks, nc, C, st);
  }
}

template <typename TO, int VPL>
cudaError_t launch_dq(const void* q, const void* scales, void* out, long long n,
                      long long chunks, int nc, int C, cudaStream_t st) {
  const long long blocks = (chunks + kQuantWarps - 1) / kQuantWarps;
  dequantize_kernel<TO, VPL><<<static_cast<unsigned>(blocks), kQuantThreads, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<TO*>(out), n, chunks, nc, C);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t dispatch_dq(const void* q, const void* scales, void* out, long long n,
                        long long chunks, int nc, int C, cudaStream_t st) {
  switch (lanes_slots(C)) {
    case 1: return launch_dq<TO, 1>(q, scales, out, n, chunks, nc, C, st);
    case 2: return launch_dq<TO, 2>(q, scales, out, n, chunks, nc, C, st);
    case 4: return launch_dq<TO, 4>(q, scales, out, n, chunks, nc, C, st);
    case 8: return launch_dq<TO, 8>(q, scales, out, n, chunks, nc, C, st);
    case 16: return launch_dq<TO, 16>(q, scales, out, n, chunks, nc, C, st);
    default: return launch_dq<TO, 32>(q, scales, out, n, chunks, nc, C, st);
  }
}

bool bad_shape(int B, int nc, int C, long long n) {
  const long long chunks = static_cast<long long>(B) * nc;
  return B <= 0 || nc <= 0 || C <= 0 || C > kMaxChunk || n <= 0 ||
         n > static_cast<long long>(nc) * C || n <= static_cast<long long>(nc - 1) * C ||
         (chunks + kQuantWarps - 1) / kQuantWarps > 0x7fffffffLL;
}

}  // namespace

// x_dtype: 0 = float32, 1 = float64. x: B rows of n values (row stride n);
// u: [B, nc, C] float32; q: [B, nc, C] int8; scales: [B, nc] float32.
// nc = ceil(n / C): the chunks of a row cover its n values, the last one
// ragged. Returns the cudaError_t of the launch.
extern "C" int repro_quantize(int x_dtype, const void* x, long long n, const void* u,
                              void* q, void* scales, int B, int nc, int C,
                              void* stream) {
  if (bad_shape(B, nc, C, n) || (x_dtype != 0 && x_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(B) * nc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_dtype == 0 ? dispatch_q<float>(x, n, u, q, scales, chunks, nc, C, st)
                   : dispatch_q<double>(x, n, u, q, scales, chunks, nc, C, st);
  return static_cast<int>(e);
}

// out_dtype: 0 = float32, 1 = float64 (the float32 product, widened
// exactly). q: [B, nc, C] int8; scales: [B, nc] float32; out: B rows of the
// first n values (row stride n).
extern "C" int repro_dequantize(int out_dtype, const void* q, const void* scales,
                                void* out, long long n, int B, int nc, int C,
                                void* stream) {
  if (bad_shape(B, nc, C, n) || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(B) * nc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      out_dtype == 0 ? dispatch_dq<float>(q, scales, out, n, chunks, nc, C, st)
                     : dispatch_dq<double>(q, scales, out, n, chunks, nc, C, st);
  return static_cast<int>(e);
}
