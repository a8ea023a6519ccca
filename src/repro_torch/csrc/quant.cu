// K4 + K5: the int8 stochastic-rounding wire codec, every client in one
// launch: encode and decode as two launches (the two ends of a wire), and
// the one-device uplink fused with its error-feedback arithmetic.
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
// repro_int8_uplink computes both on the main path, for every client's
// upload x in T (float32 or float64), with the uplink's optional buffers:
// anchor [n] (broadcast over clients), the difference-coding reference ref
// and the error-feedback residual ef (both [B, n]), and an optional addend
// post [B, n] to the decoded value (the DP noise of robust/faults.py). In
// the order of CrossClientReduce.uplink, every step rounded in T:
//
//   v = x - anchor - ref + ef       (each term where present, in that order)
//   dec = (T) decode(encode((float) v))
//   dec = dec + post                (with post)
//   new_e = v - dec                 (with ef)
//   dec = dec + ref                 (with ref; new_h = dec, written apart
//                                    only when an anchor follows)
//   dec = dec + anchor
//
// The codes and scales stay in registers: nothing on the one-device wire
// reads them (its bytes are counted from shapes).
//
// What bounds them: device memory. Quantize reads x (4 B, or 8 B for a
// float64 x, converted on load) and u (4 B) and writes q (1 B) per value
// plus one 4 B scale per chunk; dequantize reads 1 B and writes 4 B (or
// 8 B) per value; the uplink reads x, u and each buffer once and writes
// dec (and new_e, new_h) once. There are a few operations per value, far
// below the card's rate. Only the n values of a row carry data: the draws
// of the ragged chunk's padding lanes are not read (a padding value is 0,
// so its code floor(0 / scale + u) is 0 whatever u is, and is written as 0).
//
// Design: one warp per chunk, 8 warps per block. Lane l holds slots
// i = 0..VPL-1 at column i * 32 + l, so each load instruction of the warp
// reads 32 neighbouring values (coalesced), and the chunk's values stay in
// registers between the max and the rounding: every input is read once
// (the uplink keeps v in T, and ref and anchor, until dec and new_e are
// written). The max is a __shfl_xor butterfly; max is order-free, so the
// result is deterministic with no atomics. A row is read at its true
// length n with its own row stride: columns at or past n read as 0 (what
// the reference's zero padding of the flat vector gives), and the grid
// covers exactly B * nc chunks, so neither the reference's pad-to-chunk
// copy nor its ROW_TILE=8 padding of the chunk count is needed. Outputs are
// written for the first n columns of each row only.
//
// A NaN value's code is 0, as XLA's float-to-int conversion gives it
// (a chunk holding a NaN has scale 1: NaN > 0 is false; a chunk holding
// an Inf has scale Inf, and Inf / Inf is NaN). The plain version maps NaN
// to 0 explicitly too: a float NaN cast to int8 is undefined in C++ and
// in torch.
//
// Exactness: x / scale and amax / 127 are IEEE divisions (__fdiv_rn; the
// library builds without --use_fast_math), every add and subtract is an
// _rn intrinsic (never contracted into an FMA), the decode is the float32
// product __fmul_rn widened exactly, and a float64 v is rounded to float32
// by __double2float_rn: the outputs are bit-identical to the plain
// versions given the same u.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kQuantWarps = 8;
constexpr int kQuantThreads = kQuantWarps * 32;
constexpr int kMaxChunk = 1024;
// which of the uplink's optional buffers are present (a bit each)
constexpr int kAnchor = 1, kRef = 2, kEf = 4, kPost = 8;

// max that propagates NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The chunk a warp takes over the [B, nc] grid: its row, the row's first
// column in it, and the first of its C slots in a [B, nc, C] array.
struct ChunkAt {
  long long chunk, row, col0, base;
  int lane;
};

__device__ __forceinline__ ChunkAt chunk_at(int nc, int C) {
  ChunkAt at;
  at.chunk = static_cast<long long>(blockIdx.x) * kQuantWarps + (threadIdx.x >> 5);
  at.lane = threadIdx.x & 31;
  at.row = at.chunk / nc;
  at.col0 = (at.chunk - at.row * nc) * C;
  at.base = at.chunk * C;
  return at;
}

// The chunk's scale from each lane's max |v|: the warp's max over a
// butterfly, / 127 as an IEEE quotient; 1 for an all-zero chunk.
__device__ __forceinline__ float chunk_scale(float amax) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
}

// The stochastic-rounding code of v, with its uniform r, in a chunk of
// this scale; 0 for a NaN (fmaxf would return -127 for it).
__device__ __forceinline__ int8_t sr_code(float v, float r, float scale) {
  const float f = floorf(__fadd_rn(__fdiv_rn(v, scale), r));
  if (f != f) return 0;
  return static_cast<int8_t>(__float2int_rz(fminf(fmaxf(f, -127.0f), 127.0f)));
}

// What the other end decodes: the float32 product q * scale, widened
// exactly to TO.
template <typename TO>
__device__ __forceinline__ TO decode(int8_t q, float scale) {
  return static_cast<TO>(__fmul_rn(static_cast<float>(q), scale));
}

// IEEE round-to-nearest arithmetic in T, never contracted.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float to_f32(float a) { return a; }
__device__ __forceinline__ float to_f32(double a) { return __double2float_rn(a); }

template <typename TX, int VPL>
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const TX* __restrict__ x, long long n, const float* __restrict__ u,
                int8_t* __restrict__ q, float* __restrict__ scales, long long chunks,
                int nc, int C) {
  const ChunkAt at = chunk_at(nc, C);
  if (at.chunk >= chunks) return;  // whole warp leaves together
  const TX* xrow = x + at.row * n;
  // every load of the chunk is issued before the first use
  float v[VPL], r[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = i * 32 + at.lane;
    const long long col = at.col0 + j;
    const bool live = j < C && col < n;
    v[i] = live ? static_cast<float>(xrow[col]) : 0.0f;
    r[i] = live ? u[at.base + j] : 0.0f;
  }
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) amax = nan_max(amax, fabsf(v[i]));
  const float scale = chunk_scale(amax);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = i * 32 + at.lane;
    if (j < C) q[at.base + j] = sr_code(v[i], r[i], scale);
  }
  if (at.lane == 0) scales[at.chunk] = scale;
}

template <typename TO, int VPL>
__global__ void __launch_bounds__(kQuantThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  TO* __restrict__ out, long long n, long long chunks, int nc, int C) {
  const ChunkAt at = chunk_at(nc, C);
  if (at.chunk >= chunks) return;
  const float scale = scales[at.chunk];
  TO* orow = out + at.row * n;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = i * 32 + at.lane;
    const long long col = at.col0 + j;
    if (j < C && col < n) orow[col] = decode<TO>(q[at.base + j], scale);
  }
}

// BUF: which of anchor / ref / ef / post are present (kAnchor | kRef |
// kEf | kPost). new_e is written with ef, new_h with both ref and an anchor.
template <typename T, int VPL, int BUF>
__global__ void __launch_bounds__(kQuantThreads)
uplink_kernel(const T* __restrict__ x, const T* __restrict__ anchor,
              const T* __restrict__ ref, const T* __restrict__ ef,
              const T* __restrict__ post, const float* __restrict__ u,
              T* __restrict__ dec, T* __restrict__ new_e, T* __restrict__ new_h,
              long long n, long long chunks, int nc, int C) {
  constexpr bool kA = BUF & kAnchor, kR = BUF & kRef, kE = BUF & kEf,
                 kP = BUF & kPost;
  const ChunkAt at = chunk_at(nc, C);
  if (at.chunk >= chunks) return;
  const long long row0 = at.row * n;
  // v in T from its load to new_e; ref and anchor until they are added back
  T v[VPL], hr[VPL], ha[VPL];
  float r[VPL];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = i * 32 + at.lane;
    const long long col = at.col0 + j;
    const bool live = j < C && col < n;
    T t = live ? x[row0 + col] : T(0);
    if constexpr (kA) {
      ha[i] = live ? anchor[col] : T(0);
      t = sub_rn(t, ha[i]);
    }
    if constexpr (kR) {
      hr[i] = live ? ref[row0 + col] : T(0);
      t = sub_rn(t, hr[i]);
    }
    if constexpr (kE) t = add_rn(t, live ? ef[row0 + col] : T(0));
    v[i] = t;
    r[i] = live ? u[at.base + j] : 0.0f;
    amax = nan_max(amax, fabsf(to_f32(t)));
  }
  const float scale = chunk_scale(amax);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = i * 32 + at.lane;
    const long long col = at.col0 + j;
    if (j < C && col < n) {
      T d = decode<T>(sr_code(to_f32(v[i]), r[i], scale), scale);
      if constexpr (kP) d = add_rn(d, post[row0 + col]);
      if constexpr (kE) new_e[row0 + col] = sub_rn(v[i], d);
      if constexpr (kR) {
        d = add_rn(d, hr[i]);
        if constexpr (kA) new_h[row0 + col] = d;
      }
      if constexpr (kA) d = add_rn(d, ha[i]);
      dec[row0 + col] = d;
    }
  }
}

// values per lane: the least power of two with 32 * VPL >= C
int lanes_slots(int C) {
  int vpl = 1;
  while (32 * vpl < C) vpl *= 2;
  return vpl;
}

// f(std::integral_constant<int, VPL>) for the chunk width C
template <typename F>
cudaError_t with_vpl(int C, F&& f) {
  switch (lanes_slots(C)) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    default: return f(std::integral_constant<int, 32>());
  }
}

// f(std::integral_constant<int, BUF>) for the buffers present
template <typename F>
cudaError_t with_buffers(int buf, F&& f) {
  switch (buf) {
    case 0: return f(std::integral_constant<int, 0>());
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
    case 9: return f(std::integral_constant<int, 9>());
    case 10: return f(std::integral_constant<int, 10>());
    case 11: return f(std::integral_constant<int, 11>());
    case 12: return f(std::integral_constant<int, 12>());
    case 13: return f(std::integral_constant<int, 13>());
    case 14: return f(std::integral_constant<int, 14>());
    default: return f(std::integral_constant<int, 15>());
  }
}

unsigned grid(long long chunks) {
  return static_cast<unsigned>((chunks + kQuantWarps - 1) / kQuantWarps);
}

template <typename TX>
cudaError_t launch_q(const void* x, long long n, const void* u, void* q, void* scales,
                     long long chunks, int nc, int C, cudaStream_t st) {
  return with_vpl(C, [&](auto vpl) {
    quantize_kernel<TX, decltype(vpl)::value><<<grid(chunks), kQuantThreads, 0, st>>>(
        static_cast<const TX*>(x), n, static_cast<const float*>(u),
        static_cast<int8_t*>(q), static_cast<float*>(scales), chunks, nc, C);
    return cudaGetLastError();
  });
}

template <typename TO>
cudaError_t launch_dq(const void* q, const void* scales, void* out, long long n,
                      long long chunks, int nc, int C, cudaStream_t st) {
  return with_vpl(C, [&](auto vpl) {
    dequantize_kernel<TO, decltype(vpl)::value><<<grid(chunks), kQuantThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<TO*>(out), n, chunks, nc, C);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_uplink(int buf, const void* x, const void* anchor, const void* ref,
                          const void* ef, const void* post, const void* u, void* dec,
                          void* new_e, void* new_h, long long n, long long chunks,
                          int nc, int C, cudaStream_t st) {
  return with_buffers(buf, [&](auto b) {
    return with_vpl(C, [&](auto vpl) {
      uplink_kernel<T, decltype(vpl)::value, decltype(b)::value>
          <<<grid(chunks), kQuantThreads, 0, st>>>(
              static_cast<const T*>(x), static_cast<const T*>(anchor),
              static_cast<const T*>(ref), static_cast<const T*>(ef),
              static_cast<const T*>(post), static_cast<const float*>(u),
              static_cast<T*>(dec), static_cast<T*>(new_e),
              static_cast<T*>(new_h), n, chunks, nc, C);
      return cudaGetLastError();
    });
  });
}

bool bad_shape(int dtype, int B, int nc, int C, long long n) {
  const long long chunks = static_cast<long long>(B) * nc;
  return (dtype != 0 && dtype != 1) || B <= 0 || nc <= 0 || C <= 0 || C > kMaxChunk ||
         n <= 0 || n > static_cast<long long>(nc) * C ||
         n <= static_cast<long long>(nc - 1) * C ||
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
  if (bad_shape(x_dtype, B, nc, C, n)) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(B) * nc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = x_dtype == 0
                            ? launch_q<float>(x, n, u, q, scales, chunks, nc, C, st)
                            : launch_q<double>(x, n, u, q, scales, chunks, nc, C, st);
  return static_cast<int>(e);
}

// out_dtype: 0 = float32, 1 = float64 (the float32 product, widened
// exactly). q: [B, nc, C] int8; scales: [B, nc] float32; out: B rows of the
// first n values (row stride n).
extern "C" int repro_dequantize(int out_dtype, const void* q, const void* scales,
                                void* out, long long n, int B, int nc, int C,
                                void* stream) {
  if (bad_shape(out_dtype, B, nc, C, n)) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(B) * nc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = out_dtype == 0
                            ? launch_dq<float>(q, scales, out, n, chunks, nc, C, st)
                            : launch_dq<double>(q, scales, out, n, chunks, nc, C, st);
  return static_cast<int>(e);
}

// dtype: 0 = float32, 1 = float64, the type T of x, the buffers and the
// outputs. x, ref, ef, post, dec, new_e, new_h: B rows of n values (row
// stride n); anchor: n values; u: [B, nc, C] float32, nc = ceil(n / C).
// anchor, ref, ef and post are each null when absent; new_e is given
// exactly when ef is, new_h exactly when both ref and anchor are (with ref
// alone, dec is the new reference). Returns the cudaError_t of the launch.
extern "C" int repro_int8_uplink(int dtype, const void* x, const void* anchor,
                                 const void* ref, const void* ef, const void* post,
                                 const void* u, void* dec, void* new_e, void* new_h,
                                 long long n, int B, int nc, int C, void* stream) {
  const int buf = (anchor ? kAnchor : 0) | (ref ? kRef : 0) | (ef ? kEf : 0) |
                  (post ? kPost : 0);
  if (bad_shape(dtype, B, nc, C, n) || !x || !u || !dec || (!ef != !new_e) ||
      (!(anchor && ref) != !new_h))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(B) * nc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? launch_uplink<float>(buf, x, anchor, ref, ef, post, u, dec, new_e,
                                        new_h, n, chunks, nc, C, st)
                 : launch_uplink<double>(buf, x, anchor, ref, ef, post, u, dec, new_e,
                                         new_h, n, chunks, nc, C, st);
  return static_cast<int>(e);
}
