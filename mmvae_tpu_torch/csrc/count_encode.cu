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
// _make_fwd_kernel / _fwd_call, without and with want_stats, and with
// filt (K4f).  The TPU kernel walks
// D tiles in grid order and carries per-row sums in VMEM scratch; here a
// block owns kRows rows of x and loops over D inside the block, which
// takes the place of that sequential grid axis.  Nothing carries between
// blocks, so no atomics and no second pass.
//
// What bounds it on the H100: it reads the M*D counts once (1 byte each
// for int8) and the weight rows from L1/L2; per count it does one log1p
// and nl + nx FMAs.  At the serving width (nl + nx = 2) that is ~4 FLOP
// per count byte, far below the tensor cores' ridge point, so the kernel
// uses plain FMAs and no wgmma; the floor is memory (32 MB of int8 counts
// per 1600-row launch is ~10 us at 3.35 TB/s), and what holds it above
// that floor is memory latency.  The design:
//   * a thread serves the same kCols columns of a step for every row of
//     its block, so each weight value is read once per block and reused
//     for all kRows rows from registers (staging the weight tile in shared
//     memory instead cost a barrier per tile and measured 2.5x slower);
//   * every load of a step is issued before any use, so a thread keeps
//     kRows x kCols counts and kCols x NW weights in flight;
//   * x is widened in registers and log1p comes from a 256-entry table
//     for integer counts (log1pf for float32 and for counts >= 256); the
//     (M, D) float views of the plain version are never materialised;
//   * kRows x NW f32 accumulators stay in registers (NW, the compile-time
//     bound on nl + nx, is 1, 2, 4, 8 or 16);
//   * a row is reduced by warp shuffles, then across warps through shared
//     memory in a fixed order;
//   * the STATS instance adds two per-row register sums (L and L * L, L
//     as above) and reduces them the same way; the FILT instance two more
//     (L * f and L * f * L): the thread that loads a step's weights also
//     loads its kCols filter values, once per block, and reuses them for
//     the block's kRows rows.
// A row's result therefore depends only on D and that row's data — not
// on M, on which block ran it, or on the storage type of x (int8, int16
// and float32 holding the same integers give the same bits) — so a sweep
// is bitwise invariant to how rows are grouped into launches.
//
// The ragged D edge is masked here; x is not padded on the host.  Callers
// with nl + nx > 16 launch once per group of <= 16 weight rows (see
// mmvae_tpu_torch/ops/enc_kernel.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (mmvae_tpu_torch/ops/_cuda.py)

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;                 // rows of x per block
constexpr int kCols = 8;                 // columns per thread per step
constexpr int kStep = kThreads * kCols;  // D columns a block covers per step
constexpr int kMaxW = 16;                // nl + nx per launch
constexpr int kLut = 256;                // log1p table for counts 0..255

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

// NW: compile-time bound on nl + nx (1, 2, 4, 8 or 16), so the
// accumulators stay in registers and a narrow launch spends no
// instructions on unused weight rows.  STATS: also write st (M, 4).
// FILT (with STATS): the filtered pair of st is taken against f.
template <typename T, int NW, bool STATS, bool FILT>
__global__ void __launch_bounds__(kThreads)
count_encode_fwd_kernel(const T* __restrict__ x, int64_t M, int64_t D,
                        const float* __restrict__ WL, int nl,
                        const float* __restrict__ WX, int nx,
                        float* __restrict__ hL, int64_t ldl,
                        float* __restrict__ hX, int64_t ldx,
                        float* __restrict__ st,
                        const float* __restrict__ f) {
  static_assert(STATS || !FILT, "the filter only enters the stats");
  // per-row stats: sum L, sum L^2 (and with FILT sum L*f, sum L*f*L)
  constexpr int NS = STATS ? (FILT ? 4 : 2) : 0;
  __shared__ float red[kWarps][kRows][NW + NS];  // per-warp partial sums
  __shared__ float lut[kLut];

  const int nw = nl + nx;
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;

  for (int i = tid; i < kLut; i += kThreads)
    lut[i] = log1pf(static_cast<float>(i));
  __syncthreads();

  const T* xr[kRows];
  bool live[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    live[r] = row0 + r < M;
    xr[r] = x + (live[r] ? (row0 + r) * D : 0);
  }

  float acc[kRows][NW + NS];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int k = 0; k < NW + NS; ++k) acc[r][k] = 0.f;

  for (int64_t d0 = tid; d0 < D; d0 += kStep) {
    // issue every load of the step before any use: kCols x NW weights
    // (read once per block, reused for all kRows rows) and
    // kRows x kCols counts; lanes of a warp read neighbouring columns
    float w[kCols][NW];
    float fv[kCols];
    T xv[kRows][kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int64_t c = d0 + j * kThreads;
      const bool in = c < D;
#pragma unroll
      for (int k = 0; k < NW; ++k)
        w[j][k] = (in && k < nw)
                      ? (k < nl ? WL[k * D + c] : WX[(k - nl) * D + c])
                      : 0.f;
      if constexpr (FILT) fv[j] = in ? f[c] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        xv[r][j] = (in && live[r]) ? xr[r][c] : T(0);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xf = static_cast<float>(xv[r][j]);
        const float lx = log1p_count(xv[r][j], lut);
#pragma unroll
        for (int k = 0; k < NW; ++k)
          if (k < nw) acc[r][k] = fmaf(k < nl ? lx : xf, w[j][k], acc[r][k]);
        // masked columns and rows read 0, and log1p(0) = 0
        if constexpr (STATS) {
          acc[r][NW] += lx;
          acc[r][NW + 1] = fmaf(lx, lx, acc[r][NW + 1]);
        }
        if constexpr (FILT) {
          const float lf = lx * fv[j];
          acc[r][NW + 2] += lf;
          acc[r][NW + 3] = fmaf(lf, lx, acc[r][NW + 3]);
        }
      }
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int k = 0; k < NW + NS; ++k) {
      float v = acc[r][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][r][k] = v;
    }
  }
  __syncthreads();

  if (tid < kRows * NW) {
    const int r = tid / NW;
    const int k = tid - r * NW;
    const int64_t row = row0 + r;
    if (k < nw && row < M) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][r][k];
      if (k < nl)
        hL[row * ldl + k] = s;
      else
        hX[row * ldx + (k - nl)] = s;
    }
  }
  if constexpr (STATS) {
    if (tid < kRows * NS) {
      const int r = tid / NS;
      const int k = tid - r * NS;
      const int64_t row = row0 + r;
      if (row < M) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][r][NW + k];
        st[row * 4 + k] = s;
        // no filter: the filtered pair is the plain one
        if constexpr (!FILT) st[row * 4 + 2 + k] = s;
      }
    }
  }
}

template <typename T, int NW>
void launch(const void* x, int64_t M, int64_t D, const void* WL, int nl,
            const void* WX, int nx, void* hL, int64_t ldl, void* hX,
            int64_t ldx, void* st, const void* filt, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((M + kRows - 1) / kRows));
  const T* xp = static_cast<const T*>(x);
  const auto* wl = static_cast<const float*>(WL);
  const auto* wx = static_cast<const float*>(WX);
  auto* hl = static_cast<float*>(hL);
  auto* hx = static_cast<float*>(hX);
  auto* s = static_cast<float*>(st);
  const auto* f = static_cast<const float*>(filt);
  if (f != nullptr)
    count_encode_fwd_kernel<T, NW, true, true><<<grid, kThreads, 0, stream>>>(
        xp, M, D, wl, nl, wx, nx, hl, ldl, hx, ldx, s, f);
  else if (s != nullptr)
    count_encode_fwd_kernel<T, NW, true, false><<<grid, kThreads, 0, stream>>>(
        xp, M, D, wl, nl, wx, nx, hl, ldl, hx, ldx, s, nullptr);
  else
    count_encode_fwd_kernel<T, NW, false, false>
        <<<grid, kThreads, 0, stream>>>(xp, M, D, wl, nl, wx, nx, hl, ldl,
                                        hx, ldx, nullptr, nullptr);
}

template <typename T>
void launch_rows(const void* x, int64_t M, int64_t D, const void* WL,
                 int nl, const void* WX, int nx, void* hL, int64_t ldl,
                 void* hX, int64_t ldx, void* st, const void* filt,
                 cudaStream_t stream) {
  const int nw = nl + nx;
  if (nw <= 1)
    launch<T, 1>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt, stream);
  else if (nw <= 2)
    launch<T, 2>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt, stream);
  else if (nw <= 4)
    launch<T, 4>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt, stream);
  else if (nw <= 8)
    launch<T, 8>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt, stream);
  else
    launch<T, kMaxW>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt,
                     stream);
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8.  hL / hX point at the first
// output column of this launch's weight-row group, with row strides
// ldl / ldx.  st is the (M, 4) row-stats output, or null for the
// instance without stats; filt the (D,) float32 filter of the stats'
// filtered pair, or null (it needs st).  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int mmvae_count_encode_fwd(const void* x, int dtype, int64_t M,
                                      int64_t D, const void* WL, int nl,
                                      const void* WX, int nx, void* hL,
                                      int64_t ldl, void* hX, int64_t ldx,
                                      void* st, const void* filt,
                                      void* stream) {
  if (nl < 0 || nx < 0 || nl + nx < 1 || nl + nx > kMaxW || M < 0 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (filt != nullptr && st == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  if ((M + kRows - 1) / kRows > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_rows<float>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st, filt,
                         s);
      break;
    case 1:
      launch_rows<int16_t>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st,
                           filt, s);
      break;
    case 2:
      launch_rows<int8_t>(x, M, D, WL, nl, WX, nx, hL, ldl, hX, ldx, st,
                          filt, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
