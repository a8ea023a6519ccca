// K2: the Anderson Gram pass, all clients in one launch.
//
// Replaces the TPU kernel repro/kernels/anderson/anderson.py::gram_pallas
// (pallas_call at :58, body _gram_kernel at :27): one pass over the history
// Y [m, d] and the gradient g [d] builds Y Y^T [m, m] and Y g [m].
//
// What bounds it: device memory (about m/2 + 1 multiply-adds per byte of
// Y read, well under the card's ridge). At the slice's shapes (K=100, m=10,
// d=54: 4.3 KB of Y a client) it is all fixed cost, so the design keeps the
// chain from launch to store short.
//
// Two designs; kernels/anderson/ops.py::gram_parts picks one from the shape.
//
// The block design (many clients, narrow d): grid = K, one block of 512
// threads per client.
// - Staging: the block stages Y[:, tile] and g[tile] in shared memory and
//   passes one barrier. When the tile is all of Y_k (m (d + 1) values fit),
//   both are contiguous and go in one pass of 16-byte loads; a wider Y is
//   walked in tiles, with a second barrier before each restage (correct at
//   any d, but one block a client: not built to be fast there).
// - Output mapping: output o < m(m+1)/2 is the pair (i <= j) of a constant
//   table of the upper triangle column by column (so it does not depend on
//   m); the next m outputs are Y g. No loop finds (i, j), and a thread
//   reads its first pair before the barrier, while the staging loads fly.
// - Warp sums: each output belongs to a group of kLanes = 4 lanes of one
//   warp (128 groups a block: the main path's 65 outputs take one round).
//   The lanes take the columns sub, sub + 4, ... and a fixed two-step
//   xor-shuffle tree sums them (on the H100, 4 lanes a group ran faster
//   than 8 or 16: more outputs in flight, a shorter tree). The group's
//   first lane carries the total from tile to tile in shared memory (only
//   it touches that entry: no barrier) and stores it after the last tile,
//   at (i, j) and (j, i), so the Gram matrix is exactly symmetric.
// - Packing: one block per client (100 blocks on 132 SMs, one wave), so
//   every client's chain runs in parallel and ends with its block; the
//   profiler put the old design's loss to torch.bmm inside the kernel, not
//   between launches (PERF.md).
// - No atomics: the sums run in a fixed order, so reruns are bit-identical.
//
// The split design (few clients, wide d: at K = 4 the block design would
// run on 4 of the 132 SMs): grid = (parts, K), 256 threads a block. Part p
// of client k sums the columns [p·w, (p+1)·w) of its slice of d into the
// P = m(m+1)/2 + m outputs, which live in registers (m <= 8, so at most 44
// of them): each thread walks its columns with 16-byte loads of every row
// of Y and of g, then a fixed xor-shuffle tree per warp and the warps in
// order through shared memory give the block's P partial sums, stored in
// a [K, parts, P] workspace. A second kernel, one block a client, sums each
// output's parts in part order and writes Y Y^T (both triangles) and Y g.
// No atomics in either: reruns are bit-identical. Offsets are 64-bit
// (K m d exceeds 2^31 at smollm-135m's width).
//
// Accumulation type: T is float for f32 inputs (as the TPU kernel) and
// double for f64 inputs (where the TPU kernel downcast to f32); see PERF.md.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kGramThreads = 512;
constexpr int kLanes = 4;                           // lanes summing one output
constexpr int kGroups = kGramThreads / kLanes;      // outputs in flight a block
constexpr int kMaxHistory = 64;                     // ops.py::MAX_HISTORY
constexpr int kMaxPairs = kMaxHistory * (kMaxHistory + 1) / 2;
constexpr size_t kSmemBytes = 48 * 1024;

struct PairTable {
  unsigned char i[kMaxPairs], j[kMaxPairs];
};

constexpr PairTable make_pair_table() {
  PairTable t{};
  int o = 0;
  for (int j = 0; j < kMaxHistory; ++j)
    for (int i = 0; i <= j; ++i) {
      t.i[o] = static_cast<unsigned char>(i);
      t.j[o] = static_cast<unsigned char>(j);
      ++o;
    }
  return t;
}

// pair o of the upper triangle, column by column: (0,0), (0,1), (1,1), ...
__constant__ PairTable kPairs = make_pair_table();

// dst[0:n] = src[0:n] by the whole block: 16-byte loads where both ends
// are 16-byte aligned, then the tail one value at a time.
template <typename T>
__device__ __forceinline__ void copy_to_shared(T* dst, const T* __restrict__ src, int n) {
  constexpr int kVec = 16 / sizeof(T);
  int done = 0;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    done = n / kVec * kVec;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int e = threadIdx.x; e < n / kVec; e += kGramThreads) d4[e] = __ldg(s4 + e);
  }
  for (int e = done + threadIdx.x; e < n; e += kGramThreads) dst[e] = src[e];
}

// output o -> (i, j) of the upper triangle, or (o - n_pairs, -1) for Y g
__device__ __forceinline__ void output_pair(int o, int n_pairs, int& i, int& j) {
  if (o < n_pairs) {
    i = kPairs.i[o];
    j = kPairs.j[o];
  } else {
    i = o - n_pairs;
    j = -1;
  }
}

// The sum over the kLanes lanes of a group (xor tree; every lane of the
// group ends with the same bits).
template <typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kGramThreads)
gram_kernel(const T* __restrict__ y, const T* __restrict__ g, long long g_stride,
            T* __restrict__ gram, T* __restrict__ yg, int m, int d, int tile_cols) {
  const int k = blockIdx.x;
  const int n_pairs = m * (m + 1) / 2;
  const int P = n_pairs + m;
  T* ys = repro::shared_as<T>();        // [m][tw]
  T* gs = ys + m * tile_cols;           // [tw]
  T* total = gs + tile_cols;            // [P], each entry owned by one group
  const int group = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  const T* yk = y + static_cast<size_t>(k) * m * d;
  const T* gk = g + static_cast<size_t>(k) * g_stride;
  int i0 = 0, j0 = 0;                   // the first round's pair, read early
  if (group < P) output_pair(group, n_pairs, i0, j0);

  for (int c0 = 0; c0 < d; c0 += tile_cols) {
    const int tw = min(tile_cols, d - c0);
    const bool last = c0 + tw == d;
    if (c0 != 0) __syncthreads();   // every group is done with the last tile
    if (tw == d) {                        // all of Y_k: contiguous
      copy_to_shared(ys, yk, m * d);
      copy_to_shared(gs, gk, d);
    } else {
      for (int e = threadIdx.x; e < m * tw; e += kGramThreads) {
        const int r = e / tw, c = e % tw;
        ys[e] = yk[static_cast<size_t>(r) * d + c0 + c];
      }
      for (int c = threadIdx.x; c < tw; c += kGramThreads) gs[c] = gk[c0 + c];
    }
    __syncthreads();

    // every lane of a warp runs every round (the shuffles need the whole
    // warp); a group past P sums zeros and stores nothing
    for (int o = group; o - group < P; o += kGroups) {
      int i = i0, j = j0;
      if (o != group && o < P) output_pair(o, n_pairs, i, j);
      T acc = T(0);
      if (o < P) {
        const T* a = ys + i * tw;
        const T* b = j >= 0 ? ys + j * tw : gs;
        for (int c = sub; c < tw; c += kLanes) acc += a[c] * b[c];
      }
      acc = group_sum(acc);
      if (sub != 0 || o >= P) continue;
      if (c0 != 0) acc = total[o] + acc;
      if (!last) {
        total[o] = acc;
      } else if (j >= 0) {
        gram[(static_cast<size_t>(k) * m + i) * m + j] = acc;
        gram[(static_cast<size_t>(k) * m + j) * m + i] = acc;
      } else {
        yg[static_cast<size_t>(k) * m + i] = acc;
      }
    }
  }
}

// columns a tile of Y holds: as many as fit beside g and the P totals
template <typename T>
int tile_cols(int m, int d) {
  const int P = m * (m + 1) / 2 + m;
  const int fit = static_cast<int>((kSmemBytes / sizeof(T) - P) / (m + 1));
  return std::min(d, fit);
}

template <typename T>
size_t smem_bytes(int m, int tw) {
  return (static_cast<size_t>(m + 1) * tw + m * (m + 1) / 2 + m) * sizeof(T);
}

template <typename T>
cudaError_t launch(const void* y, const void* g, long long g_stride, void* gram, void* yg, int K,
                   int m, int d, cudaStream_t stream) {
  const int tw = tile_cols<T>(m, d);
  gram_kernel<T><<<K, kGramThreads, smem_bytes<T>(m, tw), stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), g_stride, static_cast<T*>(gram),
      static_cast<T*>(yg), m, d, tw);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the split design
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitMaxHistory = 8;                 // ops.py::SPLIT_MAX_HISTORY
constexpr int kFinishThreads = 64;                  // >= the P of m = 8 (44)

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

__device__ __forceinline__ float lane_of(const float4& v, int l) {
  return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
}
__device__ __forceinline__ double lane_of(const double2& v, int l) { return l == 0 ? v.x : v.y; }

// acc += the products of one column: the pairs (i <= j) in kPairs' order,
// then y_i g
template <typename T, int M>
__device__ __forceinline__ void add_column(T (&acc)[M * (M + 1) / 2 + M], const T (&yc)[M],
                                           T gc) {
  int o = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
#pragma unroll
    for (int i = 0; i <= j; ++i) {
      acc[o] += yc[i] * yc[j];
      ++o;
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) acc[o + i] += yc[i] * gc;
}

template <typename T, int M>
__global__ void __launch_bounds__(kSplitThreads)
gram_split_kernel(const T* __restrict__ y, const T* __restrict__ g, long long g_stride,
                  T* __restrict__ ws, long long d, long long part_cols, bool vec) {
  constexpr int P = M * (M + 1) / 2 + M;
  constexpr int kVec = 16 / sizeof(T);
  using V = typename Vec16<T>::type;
  __shared__ T red[kSplitWarps][P];
  const int part = blockIdx.x, k = blockIdx.y;
  const long long c0 = min(d, static_cast<long long>(part) * part_cols);
  const long long c1 = min(d, c0 + part_cols);
  const T* yk = y + static_cast<size_t>(k) * M * d;
  const T* gk = g + static_cast<size_t>(k) * g_stride;
  T acc[P];
#pragma unroll
  for (int o = 0; o < P; ++o) acc[o] = T(0);

  if (vec) {   // c0, d, the rows and g are all on 16-byte boundaries
    for (long long c = c0 + static_cast<long long>(threadIdx.x) * kVec; c < c1;
         c += static_cast<long long>(kSplitThreads) * kVec) {
      V yv[M];
#pragma unroll
      for (int i = 0; i < M; ++i)
        yv[i] = __ldg(reinterpret_cast<const V*>(yk + static_cast<size_t>(i) * d + c));
      const V gv = __ldg(reinterpret_cast<const V*>(gk + c));
#pragma unroll
      for (int l = 0; l < kVec; ++l) {
        T yc[M];
#pragma unroll
        for (int i = 0; i < M; ++i) yc[i] = lane_of(yv[i], l);
        add_column<T, M>(acc, yc, lane_of(gv, l));
      }
    }
  } else {
    for (long long c = c0 + threadIdx.x; c < c1; c += kSplitThreads) {
      T yc[M];
#pragma unroll
      for (int i = 0; i < M; ++i) yc[i] = yk[static_cast<size_t>(i) * d + c];
      add_column<T, M>(acc, yc, gk[c]);
    }
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 0; o < P; ++o) {
    T v = acc[o];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][o] = v;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < P; o += kSplitThreads) {
    T sum = red[0][o];
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w) sum += red[w][o];
    ws[(static_cast<size_t>(k) * gridDim.x + part) * P + o] = sum;
  }
}

// each output of client k: its parts summed in part order
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
gram_finish_kernel(const T* __restrict__ ws, T* __restrict__ gram, T* __restrict__ yg, int m,
                   int parts) {
  const int k = blockIdx.x;
  const int n_pairs = m * (m + 1) / 2;
  const int P = n_pairs + m;
  for (int o = threadIdx.x; o < P; o += kFinishThreads) {
    const T* wk = ws + static_cast<size_t>(k) * parts * P + o;
    T sum = T(0);
    for (int p = 0; p < parts; ++p) sum += wk[static_cast<size_t>(p) * P];
    int i, j;
    output_pair(o, n_pairs, i, j);
    if (j >= 0) {
      gram[(static_cast<size_t>(k) * m + i) * m + j] = sum;
      gram[(static_cast<size_t>(k) * m + j) * m + i] = sum;
    } else {
      yg[static_cast<size_t>(k) * m + i] = sum;
    }
  }
}

template <typename T, int M>
cudaError_t launch_split_m(const T* y, const T* g, long long g_stride, T* ws, int K, long long d,
                           int parts, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  // a part's width is a whole number of 16-byte vectors
  long long part_cols = (d + parts - 1) / parts;
  part_cols = (part_cols + 15) / 16 * 16;
  const bool vec = d % kVec == 0 && g_stride % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  gram_split_kernel<T, M><<<dim3(parts, K), kSplitThreads, 0, stream>>>(y, g, g_stride, ws, d,
                                                                      part_cols, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_split(const void* y, const void* g, long long g_stride, void* gram, void* yg,
                         void* ws, int K, int m, long long d, int parts, cudaStream_t stream) {
  const T* yt = static_cast<const T*>(y);
  const T* gt = static_cast<const T*>(g);
  T* wt = static_cast<T*>(ws);
  cudaError_t e;
  switch (m) {
    case 1: e = launch_split_m<T, 1>(yt, gt, g_stride, wt, K, d, parts, stream); break;
    case 2: e = launch_split_m<T, 2>(yt, gt, g_stride, wt, K, d, parts, stream); break;
    case 3: e = launch_split_m<T, 3>(yt, gt, g_stride, wt, K, d, parts, stream); break;
    case 4: e = launch_split_m<T, 4>(yt, gt, g_stride, wt, K, d, parts, stream); break;
    case 5: e = launch_split_m<T, 5>(yt, gt, g_stride, wt, K, d, parts, stream); break;
    case 6: e = launch_split_m<T, 6>(yt, gt, g_stride, wt, K, d, parts, stream); break;
    case 7: e = launch_split_m<T, 7>(yt, gt, g_stride, wt, K, d, parts, stream); break;
    default: e = launch_split_m<T, 8>(yt, gt, g_stride, wt, K, d, parts, stream); break;
  }
  if (e != cudaSuccess) return e;
  gram_finish_kernel<T><<<K, kFinishThreads, 0, stream>>>(wt, static_cast<T*>(gram),
                                                         static_cast<T*>(yg), m, parts);
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

// info as repro_flash_occupancy's, for the Gram kernel at (dtype, m, d).
extern "C" int repro_gram_occupancy(int dtype, int m, int d, int* info) {
  if (m <= 0 || m > kMaxHistory || d <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      dtype == 0
          ? repro::kernel_occupancy(gram_kernel<float>, kGramThreads,
                                    smem_bytes<float>(m, tile_cols<float>(m, d)), info)
          : repro::kernel_occupancy(gram_kernel<double>, kGramThreads,
                                    smem_bytes<double>(m, tile_cols<double>(m, d)), info);
  return static_cast<int>(e);
}

// The split design (header): y, g, g_stride, gram and yg as repro_gram's;
// ws a [K, parts, m(m+1)/2 + m] workspace of the dtype; m <= 8. Two
// launches, the parts then their sum. Returns the cudaError_t of the last.
extern "C" int repro_gram_split(int dtype, const void* y, const void* g, long long g_stride,
                                void* gram, void* yg, void* ws, int K, int m, long long d,
                                int parts, void* stream) {
  if (K <= 0 || K > 65535 || m <= 0 || m > kSplitMaxHistory || d <= 0 || parts <= 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
                      ? launch_split<float>(y, g, g_stride, gram, yg, ws, K, m, d, parts, st)
                      : launch_split<double>(y, g, g_stride, gram, yg, ws, K, m, d, parts, st);
  return static_cast<int>(e);
}
