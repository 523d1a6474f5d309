// K5 for Hopper (sm_90a): the weight gradient of the fused count encoder
//
//     dWL = g1^T @ log1p(x)      (r1, D)
//     dWX = g2^T @ float(x)      (r2, D)
//
// for integer (int8 / int16) or float32 counts x (M, D) and float32 row
// cotangents g1 (M, r1), g2 (M, r2) with row strides ld1, ld2.
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/enc_kernel.py:
// _make_bwd_kernel / _bwd_call, which keeps every row of the batch in
// VMEM and walks D tiles in grid order.  Every output is a column sum
// over the M rows, so here the D tiles run as concurrent blocks:
//
//   stage 1 (count_encode_bwd_tiles): a block owns one kTile-column D
//     tile and one chunk of the rows; the grid is (tiles) x (chunks).
//     The block stages its chunk's cotangent rows in shared memory once
//     (one barrier; a chunk over 128 rows in batches of 128) as
//     [row][slot], the slots padded to a multiple of 4, so that a row's
//     4-16 cotangents reach a thread as 1-4 16-byte broadcasts; the same
//     barrier covers the 256-entry log1p table, filled with the forward's
//     log1pf values (count_encode.cu), so the forward and backward see
//     the same bits of log1p(x).  A thread owns kCols adjacent columns
//     (one vector load a row where x's alignment allows, element loads
//     otherwise, the same values either way) and keeps nw x kCols sums in
//     registers: every cotangent it reads feeds kCols FMAs.  The block's
//     kGroups warps take the chunk's rows in turn (warp w rows w,
//     w + kGroups, ...), each with the counts of its next kAhead rows in
//     flight, the first of them loaded before the barrier; the warps'
//     sums are added in warp order through shared memory.  The
//     compile-time instances (NL, NX) = (2, 2), (5, 3), (12, 3), the
//     trainers' widths, take log1p(x) or x per slot at compile time; the
//     general instance takes any r1 + r2 <= 16 and selects per slot.
//     With one chunk (the plan's choice at M <= 128) the block writes
//     dWL / dWX itself; otherwise one partial per (chunk, slot, column)
//     goes to a float32 workspace (chunks, nw, D).
//   stage 2 (count_encode_bwd_sum, more than one chunk only): adds the
//     chunks' partials of each output in chunk order.
// No atomics, and nothing is allocated here: the wrapper hands in the
// workspace (enc_kernel.bwd_plan sizes it).
//
// Why the bits depend on (M, D) alone: the chunking is the plan's, set
// by (M, D); a thread adds its rows in row order from 0, the block its
// warps in warp order, stage 2 the chunks in chunk order; counts of any
// storage type are widened to the same float32 values and go through the
// same instructions.  So int8, int16 and float32 storage of the same
// integers give the same bits, and every run repeats them.
//
// What bounds it on the H100: one read of x (2 MB of int8 at M = 100,
// D = 20,000) and r1 + r2 FMAs a count, far below the tensor cores'
// ridge point, so plain FMAs: ~1 us of either at 12 + 3 rows.  The
// earlier design (one column a thread, one scalar load of a cotangent
// per FMA behind runtime slot tests) waited on L1 latency at 17-70 us.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 2;                  // adjacent columns a thread owns
constexpr int kGroups = 8;                // warps of a block: row groups
constexpr int kThreads = 32 * kGroups;
constexpr int kTile = 32 * kCols;         // D columns of a block's tile
constexpr int kMaxW = 16;                 // r1 + r2 per launch
constexpr int kStageRows = 128;           // cotangent rows staged at once
constexpr int kAhead = 8;                 // rows whose counts are in flight
constexpr int kMaxChunks = 64;
static_assert(kStageRows % kGroups == 0, "a warp keeps its rows' order");
static_assert(kStageRows * 4 % kThreads == 0, "whole cotangent loads");
constexpr int kLut = 256;                 // log1p table for counts 0..255
constexpr int kRedFloats = 4096;          // the warps' sums, a round
constexpr int kSumThreads = 256;
constexpr int kMinBlocks = 3;             // blocks an SM (register budget)

template <typename T>
__device__ __forceinline__ float log1p_count(T v, const float* lut) {
  if constexpr (std::is_integral<T>::value) {
    const int i = static_cast<int>(v);
    return (i >= 0 && i < kLut) ? lut[i] : log1pf(static_cast<float>(v));
  } else {
    return log1pf(v);
  }
}

template <int N>
struct Bytes;
template <>
struct Bytes<2> {
  using type = unsigned short;
};
template <>
struct Bytes<4> {
  using type = unsigned int;
};
template <>
struct Bytes<8> {
  using type = uint2;
};
template <>
struct Bytes<16> {
  using type = uint4;
};

// kCols counts of one row from column c on: one load of kCols * sizeof(T)
// bytes when vec, element loads (0 past D) otherwise
template <typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, bool vec,
                                          int64_t left, T (&v)[kCols]) {
  if (vec) {
    using V = typename Bytes<kCols * sizeof(T)>::type;
    union {
      V raw;
      T val[kCols];
    } u;
    u.raw = *reinterpret_cast<const V*>(p);
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = u.val[j];
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = j < left ? p[j] : T(0);
  }
}

// Stage 1.  NL, NX: the compile-time widths (log1p slots, raw slots), or
// 0, 0 for the general instance (runtime r1, r2; any r1 + r2 <= kMaxW).
template <typename T, int NL, int NX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
count_encode_bwd_tiles(const T* __restrict__ x, int64_t M, int64_t D,
                       const float* __restrict__ g1, int r1, int64_t ld1,
                       const float* __restrict__ g2, int r2, int64_t ld2,
                       int64_t chunk_rows, float* __restrict__ dWL,
                       float* __restrict__ dWX, float* __restrict__ ws) {
  constexpr bool GEN = NL + NX == 0;
  constexpr int NW = GEN ? kMaxW : NL + NX;  // the sums a thread keeps
  constexpr int KP = (NW + 3) / 4 * 4;       // slots a staged row
  constexpr int KB = kRedFloats / (kGroups * kTile);  // slots a round
  static_assert(KB >= 1, "the reduction buffer holds one slot at least");
  __shared__ __align__(16) float gs[kStageRows * KP];
  __shared__ float lut[kLut];
  __shared__ float red[kGroups][KB][kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t chunk = blockIdx.y;
  const int64_t row0 = chunk * chunk_rows;
  const int nrows = static_cast<int>(
      row0 + chunk_rows <= M ? chunk_rows : (M > row0 ? M - row0 : 0));
  const int nl = GEN ? r1 : NL;
  const int nw = GEN ? r1 + r2 : NW;

  const int64_t c0 = tile * kTile + lane * kCols;
  const int64_t left = D - c0;  // columns of this thread inside D
  constexpr int64_t kVecBytes = kCols * static_cast<int64_t>(sizeof(T));
  const bool vec =
      left >= kCols &&
      ((reinterpret_cast<uintptr_t>(x) |
        static_cast<uintptr_t>(D * static_cast<int64_t>(sizeof(T)))) %
       kVecBytes) == 0;
  const T* xp = x + row0 * D + (left > 0 ? c0 : 0);

  float acc[NW][kCols];
#pragma unroll
  for (int k = 0; k < NW; ++k)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[k][j] = 0.f;

  for (int i = tid; i < kLut; i += kThreads)
    lut[i] = log1pf(static_cast<float>(i));
  // the chunk's rows in batches of kStageRows (one batch up to 128 rows):
  // warp w takes rows w, w + kGroups, ... of the chunk in order, with the
  // counts of its next kAhead rows in flight (a ring of registers)
  for (int b0 = 0; b0 < nrows; b0 += kStageRows) {
    const int nb = nrows - b0 < kStageRows ? nrows - b0 : kStageRows;
    const int n = warp < nb ? (nb - warp + kGroups - 1) / kGroups : 0;
    const T* xb = xp + static_cast<int64_t>(b0 + warp) * D;
    const int64_t step = static_cast<int64_t>(kGroups) * D;
    if (b0 > 0) __syncthreads();  // every warp is done with the last batch
    // the ring's first rows and the batch's cotangents [row][slot] (zero
    // past nw): all their loads in flight before the barrier
    T ring[kAhead][kCols];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) ring[u][j] = T(0);
      if (left > 0 && u < n) load_cols(xb + u * step, vec, left, ring[u]);
    }
    constexpr int kPer = kStageRows * KP / kThreads;  // cotangents a thread
    float gv[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + q * kThreads;
      const int rr = i / KP;
      const int k = i - rr * KP;
      const int64_t b = row0 + b0 + rr;
      gv[q] = rr >= nb   ? 0.f
              : k < nl   ? g1[b * ld1 + k]
              : k < nw   ? g2[b * ld2 + (k - nl)]
                         : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) gs[tid + q * kThreads] = gv[q];
    __syncthreads();
    if (left <= 0) continue;
    for (int i0 = 0; i0 < n; i0 += kAhead) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int i = i0 + u;
        if (i < n) {
          const int r = warp + i * kGroups;  // the row in the batch
          float L[kCols], X[kCols];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            X[j] = static_cast<float>(ring[u][j]);
            L[j] = log1p_count(ring[u][j], lut);
          }
          if (i + kAhead < n)
            load_cols(xb + (i + kAhead) * step, vec, left, ring[u]);
          float g[KP];
#pragma unroll
          for (int q = 0; q < KP / 4; ++q) {
            const float4 g4 = reinterpret_cast<const float4*>(gs + r * KP)[q];
            g[4 * q] = g4.x;
            g[4 * q + 1] = g4.y;
            g[4 * q + 2] = g4.z;
            g[4 * q + 3] = g4.w;
          }
#pragma unroll
          for (int k = 0; k < NW; ++k) {
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[k][j] = fmaf(g[k], (GEN ? k < nl : k < NL) ? L[j] : X[j],
                               acc[k][j]);
          }
        }
      }
    }
  }

  // the block's warps in warp order, KB slots a round; then one sum per
  // (slot, column): to dWL / dWX with one chunk, else to the workspace
  const int64_t nchunks = gridDim.y;
#pragma unroll
  for (int k0 = 0; k0 < NW; k0 += KB) {
    if (k0 > 0) __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      if (k0 + kk < NW) {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          red[warp][kk][lane * kCols + j] = acc[k0 + kk][j];
      }
    }
    __syncthreads();
    const int nk = nw - k0 < KB ? nw - k0 : KB;
    for (int i = tid; i < nk * kTile; i += kThreads) {
      const int kk = i / kTile;
      const int col = i - kk * kTile;
      const int64_t c = tile * kTile + col;
      if (c >= D) continue;
      float s = red[0][kk][col];
#pragma unroll
      for (int w = 1; w < kGroups; ++w) s += red[w][kk][col];
      const int k = k0 + kk;
      if (nchunks > 1)
        ws[(chunk * nw + k) * D + c] = s;
      else if (k < nl)
        dWL[k * D + c] = s;
      else
        dWX[(k - nl) * D + c] = s;
    }
  }
}

// Stage 2: output i of the (nw, D) stack is the sum of its chunks'
// partials, added in chunk order.
__global__ void __launch_bounds__(kSumThreads)
count_encode_bwd_sum(const float* __restrict__ ws, int64_t chunks, int nl,
                     int nw, int64_t D, float* __restrict__ dWL,
                     float* __restrict__ dWX) {
  const int64_t n = nw * D;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSumThreads +
                    threadIdx.x;
  if (i >= n) return;
  float s = ws[i];
  for (int64_t j = 1; j < chunks; ++j) s += ws[j * n + i];
  const int64_t k = i / D;
  const int64_t c = i - k * D;
  if (k < nl)
    dWL[k * D + c] = s;
  else
    dWX[(k - nl) * D + c] = s;
}

bool fixed_widths(int r1, int r2) {
  return (r1 == 2 && r2 == 2) || (r1 == 5 && r2 == 3) || (r1 == 12 && r2 == 3);
}

struct Launch {
  const void* x;
  int64_t M, D;
  const float* g1;
  int r1;
  int64_t ld1;
  const float* g2;
  int r2;
  int64_t ld2;
  int64_t chunk_rows;
  float* dWL;
  float* dWX;
  float* ws;
};

template <typename T, int NL, int NX>
void launch(const Launch& L, dim3 grid, cudaStream_t s) {
  count_encode_bwd_tiles<T, NL, NX><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(L.x), L.M, L.D, L.g1, L.r1, L.ld1, L.g2, L.r2,
      L.ld2, L.chunk_rows, L.dWL, L.dWX, L.ws);
}

template <typename T>
void launch_widths(const Launch& L, bool fixed, dim3 grid, cudaStream_t s) {
  if (!fixed)
    launch<T, 0, 0>(L, grid, s);
  else if (L.r1 == 2)
    launch<T, 2, 2>(L, grid, s);
  else if (L.r1 == 5)
    launch<T, 5, 3>(L, grid, s);
  else
    launch<T, 12, 3>(L, grid, s);
}

}  // namespace

// One K5 launch (enc_kernel.bwd_plan): dtype 0 = float32, 1 = int16,
// 2 = int8; r1 + r2 in [1, 16].  g1 / g2 point at the first cotangent
// column of this launch's slot group (row strides ld1 / ld2), dWL / dWX
// at its first output row (row stride D).  The plan: fixed (1 for the
// compile-time widths (2, 2), (5, 3), (12, 3), which must then be the
// widths; 0 otherwise), tile (kTile), chunks of ceil(M / chunks) rows
// (at most kMaxChunks, at most M), and a float32 workspace of
// ws_floats >= chunks * (r1 + r2) * D floats when chunks > 1 (ws may be
// null with one chunk).  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int mmvae_count_encode_bwd(const void* x, int dtype, int64_t M,
                                      int64_t D, const void* g1, int r1,
                                      int64_t ld1, const void* g2, int r2,
                                      int64_t ld2, int fixed, int tile,
                                      int chunks, void* dWL, void* dWX,
                                      void* ws, int64_t ws_floats,
                                      void* stream) {
  if (r1 < 0 || r2 < 0 || r1 + r2 < 1 || r1 + r2 > kMaxW || M < 1 || D < 1 ||
      fixed != (fixed_widths(r1, r2) ? 1 : 0) || tile != kTile || chunks < 1 ||
      chunks > kMaxChunks || chunks > M ||
      (D + kTile - 1) / kTile > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunk_rows = (M + chunks - 1) / chunks;
  const int64_t nw = r1 + r2;
  if ((chunks > 1 && (ws == nullptr || ws_floats < chunks * nw * D)) ||
      (nw * D + kSumThreads - 1) / kSumThreads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const Launch L{x, M, D, static_cast<const float*>(g1), r1, ld1,
                 static_cast<const float*>(g2), r2, ld2, chunk_rows,
                 static_cast<float*>(dWL), static_cast<float*>(dWX),
                 static_cast<float*>(ws)};
  const dim3 grid(static_cast<unsigned>((D + kTile - 1) / kTile),
                  static_cast<unsigned>(chunks));
  switch (dtype) {
    case 0:
      launch_widths<float>(L, fixed != 0, grid, s);
      break;
    case 1:
      launch_widths<int16_t>(L, fixed != 0, grid, s);
      break;
    case 2:
      launch_widths<int8_t>(L, fixed != 0, grid, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return static_cast<int>(e);
  count_encode_bwd_sum<<<static_cast<unsigned>((nw * D + kSumThreads - 1) /
                                               kSumThreads),
                         kSumThreads, 0, s>>>(
      static_cast<const float*>(ws), chunks, r1, r2 + r1, D,
      static_cast<float*>(dWL), static_cast<float*>(dWX));
  return static_cast<int>(cudaGetLastError());
}
