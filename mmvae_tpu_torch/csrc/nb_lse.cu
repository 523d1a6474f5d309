// K1 for Hopper (sm_90a): the row logsumexp of the in-kernel decoder logits
//
//     h   = [zm | c] @ [wd; wc] + bias2        (B, D), never stored
//     lse = logsumexp(h, axis=1)                (B, 1)
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/nb_step.py: _make_lse_kernel
// / _lse_call, which carries an online (max, sum) pair per row across a
// sequential grid of D tiles.  Here the D tiles run as concurrent blocks:
//
//   stage 1 (lse_tiles): a block owns one kTile-column D tile and one
//     group of kGroup rows; the grid is (row groups) x (tiles).  The
//     block loads the tile's R + C + 1 weight rows into shared memory
//     once (one barrier; the general instance, any R + C, walks them in
//     slices of 16 rows and latents, one barrier a slice); lane l of warp
//     w takes row l of the group, keeps its row's latents in registers
//     and the warp's kLaneCols columns of the tile: it forms their logits
//     in the one order of h (nb_step_common.cuh: compute_h4, so K6, K2
//     and K3 subtract this normaliser from the same bits of h at every
//     width), keeps them in registers and
//     reduces them to one (max, sum of exp(h - max)) pair in two passes,
//     with no shuffle: every weight is a shared-memory broadcast, read
//     by all 32 rows.  The block merges its 8 warps' pairs in warp order
//     and writes one pair per (tile, row) to a float32 workspace
//     (tiles, B, 2).  Columns past D count as empty pairs (sum 0).
//   stage 2 (lse_sum): a block finishes 32 rows; warp w merges tiles w,
//     w + 8, ... in that order (16 loads in flight at a time), then warp 0
//     merges the 8 warps' pairs in warp order and writes max + log(sum):
//     a fixed order set by D.
// No atomics, and nothing is allocated here: the wrapper hands in the
// workspace (nb_step.lse_plan sizes it).
//
// What bounds it on the H100: per (row, column) R + C FMAs, an add, a
// max and one expf, reading only the stacked weight rows (4 x D floats
// at the default model); the (B, D) logits are never written.  At
// B = 100, D = 20,000 that is 2 M exps, ~1 us of the card's float32
// issue; the earlier design spent most of its time on two warp
// shuffle reductions a row and warp and on 125 K partials a call.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include "nb_step_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneCols = 32;               // columns of its row a lane takes
constexpr int kTile = kWarps * kLaneCols;   // D columns of a block's tile
constexpr int kGroup = 32;                  // rows of a block: one a lane
constexpr int kSlice = 16;                  // general: latents a pass takes
constexpr int kFixedRC = 3;                 // the compile-time (R, C) = (2, 1)
constexpr int kAhead = 16;                  // stage 2's pairs in flight
static_assert(kLaneCols % 4 == 0, "a lane forms 4 logits at a time");

// (M, S) <- merge with (m, s); an empty pair (s == 0) changes nothing
__device__ __forceinline__ void merge(float& M, float& S, float m, float s) {
  if (s == 0.f) return;
  if (S == 0.f) {
    M = m;
    S = s;
  } else if (m > M) {
    S = S * expf(M - m) + s;
    M = m;
  } else {
    S += s * expf(m - M);
  }
}

// Stage 1.  RCF: the compile-time R + C (kFixedRC): its R + C + 1 weight
// rows in shared memory and the row's latents in registers at once; or 0
// for the general instance, any runtime R + C: the logits are accumulated
// over slices of kSlice latents and weight rows (one barrier a slice, the
// bias row kept beside them), FMAs over k ascending from 0, then + bias,
// the order of compute_h4 and of every other kernel's h.
template <int RCF>
__global__ void __launch_bounds__(kThreads)
lse_tiles(const float* __restrict__ zc, const float* __restrict__ W,
          int64_t B, int64_t D, int RC, float* __restrict__ ws) {
  constexpr bool kFixed = RCF > 0;
  // weight rows a tile keeps: R + C + 1, or a slice and the bias row
  constexpr int NT = kFixed ? RCF + 1 : kSlice + 1;
  constexpr int NZ = NT - 1;                     // latents a lane keeps
  __shared__ __align__(16) float w[NT][kTile];
  __shared__ float pm[kWarps][kGroup];
  __shared__ float ps[kWarps][kGroup];

  const int rc = kFixed ? RCF : RC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kGroup + lane;
  const bool live = row < B;
  const int64_t tile = blockIdx.y;
  const int64_t col0 = tile * kTile;
  // this warp's columns: the first nvalid of them lie inside D
  const int cw = warp * kLaneCols;
  const int64_t left = D - (col0 + cw);
  const int nvalid = left <= 0 ? 0 : (left < kLaneCols ? static_cast<int>(left)
                                                       : kLaneCols);
  float h[kLaneCols];
  if constexpr (kFixed) {
    // the tile's weight rows (zero past D and past the bias row)
    for (int cc = tid; cc < kTile; cc += kThreads) {
      const int64_t c = col0 + cc;
      const bool in = c < D;
#pragma unroll
      for (int k = 0; k < NT; ++k)
        w[k][cc] = (in && k <= rc) ? W[k * D + c] : 0.f;
    }
    float z[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k)
      z[k] = (live && k < rc) ? zc[row * rc + k] : 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kLaneCols; j += 4) {
      const float4 v = nbk::compute_h4(z, &w[0][cw + j], kTile, rc);
      h[j] = v.x;
      h[j + 1] = v.y;
      h[j + 2] = v.z;
      h[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) h[j] = 0.f;
    for (int k0 = 0; k0 < rc; k0 += kSlice) {
      const int n = rc - k0 < kSlice ? rc - k0 : kSlice;
      if (k0 > 0) __syncthreads();  // the last slice is read
      // the slice's weight rows (w[0..n)), the bias row w[kSlice] once
      for (int cc = tid; cc < kTile; cc += kThreads) {
        const int64_t c = col0 + cc;
        const bool in = c < D;
#pragma unroll
        for (int k = 0; k < kSlice; ++k)
          w[k][cc] = (in && k < n) ? W[(k0 + k) * D + c] : 0.f;
        if (k0 == 0) w[kSlice][cc] = in ? W[rc * D + c] : 0.f;
      }
      float z[NZ];
#pragma unroll
      for (int k = 0; k < NZ; ++k)
        z[k] = (live && k < n) ? zc[row * rc + k0 + k] : 0.f;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kLaneCols; j += 4) {
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
          if (k < n) {
            const float4 wk = *reinterpret_cast<const float4*>(&w[k][cw + j]);
            h[j] = fmaf(z[k], wk.x, h[j]);
            h[j + 1] = fmaf(z[k], wk.y, h[j + 1]);
            h[j + 2] = fmaf(z[k], wk.z, h[j + 2]);
            h[j + 3] = fmaf(z[k], wk.w, h[j + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLaneCols; j += 4) {
      const float4 b = *reinterpret_cast<const float4*>(&w[kSlice][cw + j]);
      h[j] = h[j] + b.x;
      h[j + 1] = h[j + 1] + b.y;
      h[j + 2] = h[j + 2] + b.z;
      h[j + 3] = h[j + 3] + b.w;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kLaneCols; ++j)
    if (j < nvalid) m = fmaxf(m, h[j]);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kLaneCols; ++j)
    if (j < nvalid) s += expf(h[j] - m);
  pm[warp][lane] = m;
  ps[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || !live) return;
  float M = -INFINITY, S = 0.f;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) merge(M, S, pm[v][lane], ps[v][lane]);
  float* o = ws + (tile * B + row) * 2;
  o[0] = M;
  o[1] = S;
}

// Stage 2: a block finishes kGroup rows of the workspace (tiles, B, 2).
__global__ void __launch_bounds__(kThreads)
lse_sum(const float* __restrict__ ws, int64_t tiles, int64_t B,
        float* __restrict__ lse) {
  __shared__ float pm[kWarps][kGroup];
  __shared__ float ps[kWarps][kGroup];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kGroup + lane;
  float M = -INFINITY, S = 0.f;
  if (row < B) {
    // kAhead pairs in flight, then merged in order
    for (int64_t t0 = warp; t0 < tiles; t0 += kWarps * kAhead) {
      float2 p[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int64_t t = t0 + u * kWarps;
        p[u] = t < tiles
                   ? *reinterpret_cast<const float2*>(ws + (t * B + row) * 2)
                   : make_float2(0.f, 0.f);  // empty
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) merge(M, S, p[u].x, p[u].y);
    }
  }
  pm[warp][lane] = M;
  ps[warp][lane] = S;
  __syncthreads();
  if (warp != 0 || row >= B) return;
  M = -INFINITY;
  S = 0.f;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) merge(M, S, pm[v][lane], ps[v][lane]);
  lse[row] = M + logf(S);
}

}  // namespace

// zc (B, R+C), W (>= R+C+1, D), lse (B, 1), any R >= 1, C >= 0.  The plan
// (nb_step.lse_plan): fixed (1 exactly when (R, C) = (2, 1)), tile (kTile)
// and a float32
// workspace of ws_floats >= ceil(D / kTile) * B * 2 floats.  Returns
// cudaGetLastError() after the two launches (0 = launched).
extern "C" int mmvae_nb_lse(const void* zc, const void* W, int64_t B,
                            int64_t D, int R, int C, int fixed, int tile,
                            void* ws, int64_t ws_floats, void* lse,
                            void* stream) {
  const int64_t tiles = (D + kTile - 1) / kTile;
  if (B < 1 || D < 1 || R < 1 || C < 0 ||
      fixed != (R == 2 && C == 1 ? 1 : 0) || tile != kTile || ws == nullptr ||
      ws_floats < tiles * B * 2 || tiles > 65535 ||
      (B + kGroup - 1) / kGroup > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((B + kGroup - 1) / kGroup),
                  static_cast<unsigned>(tiles));
  const auto* zcp = static_cast<const float*>(zc);
  const auto* Wp = static_cast<const float*>(W);
  auto* parts = static_cast<float*>(ws);
  if (fixed)
    lse_tiles<kFixedRC><<<grid, kThreads, 0, s>>>(zcp, Wp, B, D, R + C, parts);
  else
    lse_tiles<0><<<grid, kThreads, 0, s>>>(zcp, Wp, B, D, R + C, parts);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lse_sum<<<static_cast<unsigned>((B + kGroup - 1) / kGroup), kThreads, 0,
            s>>>(parts, tiles, B, static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}
