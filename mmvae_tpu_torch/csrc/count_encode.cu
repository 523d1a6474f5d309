// count_encode forward for Hopper (sm_90a): the fused count-encoder
// contraction
//
//     hL = log1p(x) @ WL^T      (M, nl)
//     hX = float(x) @ WX^T      (M, nx)
//     st = [sum L, sum L^2, sum L*f, sum L^2*f]   (M, 4), L = log1p(x)
//
// for integer (int8 / int16) or float32 counts x (M, D) and float32
// weight rows WL (nl, D), WX (nx, D), all row-major and contiguous.  The
// row stats are optional (STATS): the joint vMF+NB model takes its row
// L2 norms from them.  The filter f (D,) float32 is optional too (FILT,
// with STATS only): the labeled mixture's annotation mask, whose
// filtered pair gives the norm of its masked vMF input; with no filter
// the filtered pair equals the plain one.
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/enc_kernel.py:
// _make_fwd_kernel / _fwd_call (K4), with want_stats (K4s) and with filt
// (K4f).  The TPU kernel puts every row of the batch in each D tile and
// carries the row sums across a sequential grid of tiles in VMEM.  Here
// the D tiles run as concurrent blocks and a second kernel adds them:
//
//   stage 1 (count_encode_tiles): a block owns one kTile-column D tile
//     and one group of kGroup rows; the grid is (row groups) x (tiles).
//     The block loads its tile of the weight rows and of the filter, and
//     a 256-entry log1p table, into shared memory once (one barrier).
//     Lane l of warp w takes row l of the group and the warp's kLaneCols
//     columns of the tile: it loads its counts into registers (16-byte
//     vector loads where x and D allow it, element loads otherwise, the
//     same arithmetic either way), widens them there, takes log1p from
//     the table for integer counts below 256 (log1pf otherwise) and
//     keeps its row's sums in registers: NL for the log1p rows, NX for
//     the raw rows (compile-time bounds, so no instruction chooses
//     between log1p(x) and x per row), 2 or 4 for the stats.  Every lane
//     reads the same weight, a shared-memory broadcast, so one weight
//     load serves 32 rows.  The block adds its 8 warps' sums in warp
//     order through shared memory and writes one partial per (tile, row,
//     output) to a float32 workspace (tiles, M, nl + nx + NS).
//   stage 2 (count_encode_sum): 8 warps finish 32 (row, output) sums;
//     warp w adds tiles w, w + 8, ... in order, then the 8 warps' sums
//     are added in warp order; the kernel writes hL, hX and st.
// No atomics anywhere, and nothing is allocated here: the wrapper hands
// in the workspace.
//
// What bounds it on the H100: the bytes of counts.  Each count is read
// once (1 byte for int8) and costs one log1p lookup and nl + nx FMAs; the
// weights leave device memory once per row group (M / 32 times, from L2),
// not once per two rows.  At the serving launch (M = 1600, 2 rows) the
// floor is 32 MB of int8 counts, ~10 us at 3.35 TB/s; at a training batch
// (M = 100, D = 20,000, up to 15 rows) it is ~3 MB, ~1 us, and launch
// latency, the blocks' fill of the card and the FMAs' issue set the time.
//
// Why not the earlier design (a block owned 2 whole rows and walked all
// of D): at M = 100 it launched 50 blocks on 132 SMs, one 8-warp block
// an SM at 254 registers a thread (16 rows with FILT), and every block
// streamed every weight row from L2 to serve 2 rows of counts (60 MB of
// weight reads for 2 MB of counts at 12 + 3 rows).  This design launches
// 79 x 4 blocks at M = 100 and keeps only the row's sums in registers.
//
// Why a row's bits depend only on D and that row's data: the tiles and
// each warp's column slice are fixed by D alone (kTile never depends on
// M or the dtype); a lane adds its columns in column order, the block
// its warps in warp order, stage 2 the tiles in a fixed order set by
// their count; counts of any storage type are widened to the same
// float32 values and go through the same instructions (the table holds
// log1pf of 0..255).  So one launch over 1,600 rows, sixteen of 100 or a
// ragged split, and int8, int16 or float32 storage of the same integers
// give the same bits, and every run repeats them.
//
// The ragged D edge is masked here (columns past D read 0 and weight 0);
// x is not padded on the host.  A launch takes at most kMaxL log1p rows
// and kMaxX raw rows; callers with more launch once per group (see
// mmvae_tpu_torch/ops/enc_kernel.py, whose fwd_plan holds kTile too).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (mmvae_tpu_torch/ops/_cuda.py)

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLaneCols = 32;               // columns of its row a lane adds
constexpr int kTile = kWarps * kLaneCols;   // D columns of a block's tile
constexpr int kGroup = 32;                  // rows of a block: one a lane
constexpr int kMaxL = 16;                   // log1p rows per launch
constexpr int kMaxX = 4;                    // raw rows per launch
constexpr int kLut = 256;                   // log1p table for counts 0..255
constexpr int kSumThreads = 256;
static_assert(kTile == kThreads && kLut == kThreads,
              "a thread fills one tile column and one table entry");

// log1p of one count.  Integer counts below kLut read a table that was
// filled with log1pf of the same values, so the result has the same bits
// as the float32 path's log1pf and costs one shared-memory load.
template <typename T>
__device__ __forceinline__ float log1p_count(T v, const float* lut) {
  if constexpr (std::is_integral<T>::value) {
    const int i = static_cast<int>(v);
    return (i >= 0 && i < kLut) ? lut[i] : log1pf(static_cast<float>(v));
  } else {
    return log1pf(v);
  }
}

// A lane's counts live packed in 32-bit words (4 int8, 2 int16 or 1
// float32 a word), so they stay in registers whatever the dtype.
// float32 counts take four times the registers of int8: a lane loads them
// in four parts of 8 columns, each after the one before is used, so that
// every instance fits the register budget of 2 blocks an SM unspilled.
template <typename T>
constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int kParts = sizeof(T) == 4 ? 4 : 1;

template <typename T>
__device__ __forceinline__ uint32_t count_bits(T v) {
  if constexpr (sizeof(T) == 4)
    return __float_as_uint(v);
  else if constexpr (sizeof(T) == 2)
    return static_cast<uint16_t>(v);
  else
    return static_cast<uint8_t>(v);
}

template <typename T>
__device__ __forceinline__ T count_at(const uint32_t* w, int j) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(w[j]);
  else if constexpr (sizeof(T) == 2)
    return static_cast<int16_t>(w[j >> 1] >> (16 * (j & 1)));
  else
    return static_cast<int8_t>(w[j >> 2] >> (8 * (j & 3)));
}

// N counts of row xr from column c on (row live, columns < D; 0 past
// them) into w: 16-byte loads when vec, element loads otherwise
template <typename T, int N>
__device__ __forceinline__ void load_counts(const T* __restrict__ xr,
                                            int64_t c, int64_t D, bool live,
                                            bool vec, uint32_t* w) {
  constexpr int kWords = N / kPerWord<T>;
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int q = 0; q < kWords / 4; ++q) {
      const uint4 v = __ldg(p + q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kWords; ++q) w[q] = 0u;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T v = (live && c + j < D) ? xr[c + j] : T(0);
      w[j / kPerWord<T>] |= count_bits(v)
                            << (8 * sizeof(T) * (j % kPerWord<T>));
    }
  }
}

// Stage 1.  NL, NX: compile-time bounds on nl (1, 2, 4, 8 or 16) and
// nx (0 or 4), so the sums stay in registers; weight rows past nl and nx
// are zero in the tile.  STATS: also the row stats' sums.  FILT (with
// STATS): the filtered pair.
template <typename T, int NL, int NX, bool STATS, bool FILT>
__global__ void __launch_bounds__(kThreads, 2)
count_encode_tiles(const T* __restrict__ x, int64_t M, int64_t D,
                   const float* __restrict__ WL, int nl,
                   const float* __restrict__ WX, int nx,
                   const float* __restrict__ f, float* __restrict__ ws) {
  static_assert(STATS || !FILT, "the filter only enters the stats");
  // per-row sums: NL log1p rows, NX raw rows, then the stats: sum L,
  // sum L^2 (and with FILT sum L*f, sum L*f*L)
  constexpr int NS = STATS ? (FILT ? 4 : 2) : 0;
  constexpr int NO = NL + NX + NS;
  constexpr int kPartCols = kLaneCols / kParts<T>;
  __shared__ __align__(16) float wl[NL][kTile];
  __shared__ __align__(16) float wx[NX > 0 ? NX : 1][kTile];
  __shared__ __align__(16) float fsm[FILT ? kTile : 4];
  __shared__ float lut[kLut];
  __shared__ float red[kWarps][NO][kGroup + 1];  // +1: no bank conflicts

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kGroup;
  const int64_t tile = blockIdx.y;
  const int64_t col0 = tile * kTile;
  const int64_t row = row0 + lane;
  const bool live = row < M;
  const int64_t c0 = col0 + warp * kLaneCols;

  // this lane's counts (the first part of them for float32), loaded
  // before anything else so that their latency overlaps the tables' fill
  uint32_t xw[kPartCols / kPerWord<T>];
  const T* xr = x + (live ? row * D : 0);
  const bool vec =
      live && c0 + kLaneCols <= D &&
      ((reinterpret_cast<uintptr_t>(x) |
        static_cast<uintptr_t>(D * static_cast<int64_t>(sizeof(T)))) &
       15) == 0;
  load_counts<T, kPartCols>(xr, c0, D, live, vec, xw);

  // the block's tables: log1p of 0..255, the tile of the weight rows
  // (zero past D, nl and nx) and of the filter
  lut[tid] = log1pf(static_cast<float>(tid));
  {
    const int64_t c = col0 + tid;
    const bool in = c < D;
#pragma unroll
    for (int k = 0; k < NL; ++k)
      wl[k][tid] = (in && k < nl) ? WL[k * D + c] : 0.f;
#pragma unroll
    for (int k = 0; k < NX; ++k)
      wx[k][tid] = (in && k < nx) ? WX[k * D + c] : 0.f;
    if constexpr (FILT) fsm[tid] = in ? f[c] : 0.f;
  }
  __syncthreads();

  float acc[NO];
#pragma unroll
  for (int k = 0; k < NO; ++k) acc[k] = 0.f;
#pragma unroll 1
  for (int h = 0; h < kParts<T>; ++h) {
    if (h > 0) load_counts<T, kPartCols>(xr, c0 + h * kPartCols, D, live,
                                         vec, xw);
#pragma unroll
    for (int j0 = 0; j0 < kPartCols; j0 += 4) {
      const int cw = warp * kLaneCols + h * kPartCols + j0;  // in the tile
      // masked columns and rows read 0, and log1p(0) = 0
      float L[4], X[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const T v = count_at<T>(xw, j0 + u);
        X[u] = static_cast<float>(v);
        L[u] = log1p_count(v, lut);
      }
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(&wl[k][cw]);
        acc[k] = fmaf(L[0], w.x, acc[k]);
        acc[k] = fmaf(L[1], w.y, acc[k]);
        acc[k] = fmaf(L[2], w.z, acc[k]);
        acc[k] = fmaf(L[3], w.w, acc[k]);
      }
#pragma unroll
      for (int k = NL; k < NL + NX; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(&wx[k - NL][cw]);
        acc[k] = fmaf(X[0], w.x, acc[k]);
        acc[k] = fmaf(X[1], w.y, acc[k]);
        acc[k] = fmaf(X[2], w.z, acc[k]);
        acc[k] = fmaf(X[3], w.w, acc[k]);
      }
      constexpr int S0 = NL + NX;  // the stats' sums
      if constexpr (STATS) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[S0] += L[u];
          acc[S0 + 1] = fmaf(L[u], L[u], acc[S0 + 1]);
        }
      }
      if constexpr (FILT) {
        const float4 fv = *reinterpret_cast<const float4*>(&fsm[cw]);
        const float fu[4] = {fv.x, fv.y, fv.z, fv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float lf = L[u] * fu[u];
          acc[S0 + 2] += lf;
          acc[S0 + 3] = fmaf(lf, L[u], acc[S0 + 3]);
        }
      }
    }
  }

  // the block's 8 warps in warp order, then one partial per (row, output)
#pragma unroll
  for (int k = 0; k < NO; ++k) red[warp][k][lane] = acc[k];
  __syncthreads();
  const int width = nl + nx + NS;
  for (int i = tid; i < kGroup * width; i += kThreads) {
    const int r = i / width;
    const int o = i - r * width;
    const int k = o < nl        ? o
                  : o < nl + nx ? NL + (o - nl)
                                : NL + NX + (o - nl - nx);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][k][r];
    if (row0 + r < M) ws[(tile * M + row0 + r) * width + o] = s;
  }
}

// Stage 2: a block finishes 32 consecutive (row, output) sums of the
// workspace (tiles, M, width).  Warp w adds tiles w, w + 8, w + 16, ...
// in that order (their loads all in flight at once), then warp 0 adds
// the 8 warps' sums in warp order: a fixed order that depends on the
// tile count alone.  Outputs 0..nl-1 go to hL, nl..nw-1 to hX, the ns
// stats to st (dup: no filter, so the filtered pair is the plain one).
__global__ void __launch_bounds__(kSumThreads)
count_encode_sum(const float* __restrict__ ws, int64_t tiles, int64_t M,
                 int nl, int nx, int ns, bool dup,
                 float* __restrict__ hL, int64_t ldl,
                 float* __restrict__ hX, int64_t ldx,
                 float* __restrict__ st) {
  constexpr int kSumWarps = kSumThreads / 32;
  __shared__ float part[kSumWarps][32];
  const int nw = nl + nx;
  const int width = nw + ns;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n = M * width;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  float s = 0.f;
  if (i < n) {
#pragma unroll 8
    for (int64_t t = warp; t < tiles; t += kSumWarps) s += ws[t * n + i];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || i >= n) return;
  s = 0.f;
#pragma unroll
  for (int w = 0; w < kSumWarps; ++w) s += part[w][lane];
  const int64_t row = i / width;
  const int o = static_cast<int>(i - row * width);
  if (o < nl) {
    hL[row * ldl + o] = s;
  } else if (o < nw) {
    hX[row * ldx + (o - nl)] = s;
  } else {
    st[row * 4 + (o - nw)] = s;
    if (dup) st[row * 4 + 2 + (o - nw)] = s;
  }
}

int64_t num_tiles(int64_t D) { return (D + kTile - 1) / kTile; }

int num_stats(const void* st, const void* filt) {
  return filt != nullptr ? 4 : (st != nullptr ? 2 : 0);
}

template <typename T, int NL, int NX>
void launch(const void* x, int64_t M, int64_t D, const void* WL, int nl,
            const void* WX, int nx, void* hL, int64_t ldl, void* hX,
            int64_t ldx, void* st, const void* filt, void* ws,
            cudaStream_t stream) {
  const int64_t tiles = num_tiles(D);
  const dim3 grid(static_cast<unsigned>((M + kGroup - 1) / kGroup),
                  static_cast<unsigned>(tiles));
  const T* xp = static_cast<const T*>(x);
  const auto* wl = static_cast<const float*>(WL);
  const auto* wx = static_cast<const float*>(WX);
  const auto* f = static_cast<const float*>(filt);
  auto* w = static_cast<float*>(ws);
  if (f != nullptr)
    count_encode_tiles<T, NL, NX, true, true>
        <<<grid, kThreads, 0, stream>>>(xp, M, D, wl, nl, wx, nx, f, w);
  else if (st != nullptr)
    count_encode_tiles<T, NL, NX, true, false>
        <<<grid, kThreads, 0, stream>>>(xp, M, D, wl, nl, wx, nx, nullptr, w);
  else
    count_encode_tiles<T, NL, NX, false, false>
        <<<grid, kThreads, 0, stream>>>(xp, M, D, wl, nl, wx, nx, nullptr, w);
  const int ns = num_stats(st, filt);
  const int64_t n = M * (nl + nx + ns);
  count_encode_sum<<<static_cast<unsigned>((n + 31) / 32), kSumThreads, 0,
                     stream>>>(
      w, tiles, M, nl, nx, ns, f == nullptr, static_cast<float*>(hL), ldl,
      static_cast<float*>(hX), ldx, static_cast<float*>(st));
}

template <typename T, int NL>
void launch_x(const void* x, int64_t M, int64_t D, const void* WL, int nl,
              const void* WX, int nx, void* hL, int64_t ldl, void* hX,
              int64_t ldx, void* st, const void* filt, void* ws,
              cudaStream_t stream) {
  if (nx == 0)
    launch<T, NL, 0>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt, ws,
                     stream);
  else
    launch<T, NL, kMaxX>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt,
                         ws, stream);
}

template <typename T>
void launch_rows(const void* x, int64_t M, int64_t D, const void* WL,
                 int nl, const void* WX, int nx, void* hL, int64_t ldl,
                 void* hX, int64_t ldx, void* st, const void* filt, void* ws,
                 cudaStream_t stream) {
  if (nl <= 1)
    launch_x<T, 1>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt, ws,
                   stream);
  else if (nl <= 2)
    launch_x<T, 2>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt, ws,
                   stream);
  else if (nl <= 4)
    launch_x<T, 4>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt, ws,
                   stream);
  else if (nl <= 8)
    launch_x<T, 8>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt, ws,
                   stream);
  else
    launch_x<T, kMaxL>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt,
                       ws, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8.  nl <= 16 log1p rows WL and
// nx <= 4 raw rows WX (one of them at least).  hL / hX point at the first
// output column of this launch's weight-row group, with row strides
// ldl / ldx.  st is the (M, 4) row-stats output, or null for the
// instance without stats; filt the (D,) float32 filter of the stats'
// filtered pair, or null (it needs st).  ws is a float32 workspace of
// ws_floats >= tiles * M * (nl + nx + NS) elements, tiles = ceil(D / 256)
// and NS = 4 with filt, 2 with st alone, else 0 (enc_kernel.fwd_plan).
// Returns cudaGetLastError() after both launches (0 = launched).
extern "C" int mmvae_count_encode_fwd(const void* x, int dtype, int64_t M,
                                      int64_t D, const void* WL, int nl,
                                      const void* WX, int nx, void* hL,
                                      int64_t ldl, void* hX, int64_t ldx,
                                      void* st, const void* filt, void* ws,
                                      int64_t ws_floats, void* stream) {
  if (nl < 0 || nx < 0 || nl + nx < 1 || nl > kMaxL || nx > kMaxX || M < 0 ||
      D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (filt != nullptr && st == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const int64_t tiles = num_tiles(D);
  const int64_t n = M * (nl + nx + num_stats(st, filt));
  if (ws == nullptr || ws_floats < tiles * n || tiles > 65535 ||
      (n + 31) / 32 > 0x7fffffff || (M + kGroup - 1) / kGroup > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_rows<float>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt,
                         ws, s);
      break;
    case 1:
      launch_rows<int16_t>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st,
                           filt, ws, s);
      break;
    case 2:
      launch_rows<int8_t>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st,
                          filt, ws, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
