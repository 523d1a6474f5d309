// K3 for Hopper (sm_90a): the softmax-coupling terms of the boot-step
// gradient, with no read of the counts
//
//     p    = softmax(h) = exp(h - lse)            (recomputed, never stored)
//     fout = [zc^T (p * rsum) ; colsum(p * rsum)] (R + C + 1, D)
//     u2   = p @ wd^T                             (B, R)
//
// The caller forms dh = dls - p * rowsum(dls) from K2's gout minus fout,
// and d_zm = u1 - rsum * u2.
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/nb_step.py:
// _make_finish_kernel / _finish_call.
//
// What bounds it on the H100: operations.  Per (row, column) R + C FMAs
// and an add for h, one expf, R + C + 1 FMAs into the column sums and R
// into u2's row terms; no (B, D) operand is read or written, only the
// stacked weight rows and fout (2 x 4 x D floats at the default model).
// At B = 100, D = 20,000 that is well under a microsecond of the card's
// float32 issue: what a call costs is its latency (loads, the row sums'
// shuffles, the two launches), and the layout is chosen to keep that
// short.
//
// Layout: K2's (nb_valgrad.cu, nbk::tile).  Stage 1 (finish_tiles): a
// block of 4 warps owns one 64-column tile of D and one chunk of rows,
// grid (tiles, chunks) with the chunking of ops/nb_step.finish_plan;
// lane l owns columns 2l, 2l + 1, warp w takes the chunk's rows w,
// w + 4, ...  The compile-time instance ((R, C) = (2, 1), every CLI
// default) keeps its W columns, the row's latents and its column sums in
// registers; the general one keeps W's R + C + 1 rows and each warp's
// column sums in dynamic shared memory (1,280 bytes a row, so any
// R + C + 1 <= 181).  Per row a lane adds its 2 columns' u2 terms first;
// then a warp sums the row's R outputs over its 64 columns (at R = 2:
// the lanes trade halves, lane ^ 16, and add the one value left, 5
// shuffles for both outputs) and writes one partial per (output, tile,
// row).  The column sums: each warp's in registers, the block's 4 warps
// added in order in shared memory, written to fout with one chunk, else
// to the chunks' partials.  Stage 2 (finish_sum, nbk::tile::tile_sums):
// the u2 partials over the tiles and the chunks' column partials, each
// in a fixed order.
//
// What the layout does about the earlier design (a block of 64 columns x
// 4 row groups over ALL B rows, one column a thread, NT = 8 or 16 slots
// with a test in every loop, zc read again for the column sums, R shuffle
// trees per row and warp, and reduce_parts adding 626 partials a row from
// one 128-thread block): twice the blocks at the main path's B = 100
// (ceil(B / 50) row chunks, the best of 1-8 on the H100), 2 columns a
// thread, the widths at compile time on the main path, u2's terms added
// over a lane's columns before any shuffle, half the partials, and a
// second stage that reads coalesced.
//
// Bits.  p has the earlier design's bits (the one order of h); the order
// of every sum depends on (B, D) alone.  No atomics; bitwise repeatable.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include <cstdint>

#include "nb_step_common.cuh"

namespace {

using namespace nbk;
using namespace nbk::tile;

// Blocks an SM each instance asks for: the compile-time instance 8 (<= 64
// registers), the general one 4.
template <bool FIXED>
constexpr int min_blocks() {
  return FIXED ? 8 : 4;
}

// Dynamic shared memory of a general instance: the tile's Tc = R + C + 1
// weight rows (sw) and each warp's Tc column sums (sacc)
inline int64_t general_smem(int Tc) {
  return static_cast<int64_t>(1 + kWarps) * Tc * kTile * sizeof(float);
}

// Stage 1.  FR, FC > 0: the widths at compile time; FR = 0: the general
// instance.  Writes the u2 partials parts (R, tiles, B) and the column
// sums (straight to fout with one chunk, else to cparts (chunks, Tc, D)).
template <int FR, int FC>
__global__ void __launch_bounds__(kBlockThreads, min_blocks<(FR > 0)>())
finish_tiles(const float* __restrict__ zc, const float* __restrict__ lse,
             const float* __restrict__ rsum, const float* __restrict__ W,
             int64_t B, int64_t D, int R_, int C_, float* __restrict__ fout,
             float* __restrict__ parts, float* __restrict__ cparts) {
  constexpr bool kFixed = FR > 0;
  static_assert(!kFixed || FR == 2, "the row sums trade halves: R = 2");
  constexpr int NT = kFixed ? FR + FC + 1 : 1;  // stacked rows held
  const int R = kFixed ? FR : R_;
  const int RC = R + (kFixed ? FC : C_);
  const int Tc = RC + 1;
  __shared__ __align__(16) float sacc[kFixed ? kWarps : 1][NT]
                                     [kFixed ? kTile : 1];
  // general: sw (Tc, kTile), then gsacc (kWarps, Tc, kTile)
  extern __shared__ __align__(16) float dyn[];
  float* const sw = dyn;
  float* const gsacc = dyn + Tc * kTile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t tiles = gridDim.x;
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  const int64_t c0 = tile * kTile + lane * kLaneCols;

  float w[NT][kLaneCols];
  float acc[NT][kLaneCols];
  auto wv = [&](int k, int j) -> float {
    return sw[k * kTile + lane * kLaneCols + j];
  };
  auto accv = [&](int k, int j) -> float& {
    return gsacc[(warp * Tc + k) * kTile + lane * kLaneCols + j];
  };
  if constexpr (kFixed) {
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        w[k][j] = c0 + j < D ? __ldg(W + k * D + c0 + j) : 0.f;
        acc[k][j] = 0.f;
      }
  } else {
    for (int i = threadIdx.x; i < Tc * kTile; i += kBlockThreads) {
      const int64_t c = tile * kTile + (i % kTile);
      sw[i] = c < D ? __ldg(W + (i / kTile) * D + c) : 0.f;
    }
    for (int k = 0; k < Tc; ++k)
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) accv(k, j) = 0.f;
    __syncthreads();
  }

  const int64_t r0 = chunk * B / chunks;
  const int64_t r1 = (chunk + 1) * B / chunks;
  for (int64_t b = r0 + warp; b < r1; b += kWarps) {
    const float lb = __ldg(lse + b);
    const float rs = __ldg(rsum + b);
    const float* zcr = zc + b * RC;
    if constexpr (kFixed) {
      float zr[NT];
#pragma unroll
      for (int k = 0; k < RC; ++k) zr[k] = __ldg(zcr + k);
      float u[FR];  // this lane's u2 terms of the row
#pragma unroll
      for (int r = 0; r < FR; ++r) u[r] = 0.f;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        // h in the one order of nb_step_common.cuh
        float h = 0.f;
#pragma unroll
        for (int k = 0; k < RC; ++k) h = fmaf(zr[k], w[k][j], h);
        h = h + w[RC][j];
        const float p = c0 + j < D ? expf(h - lb) : 0.f;
        const float pr = p * rs;
#pragma unroll
        for (int k = 0; k < RC; ++k) acc[k][j] = fmaf(zr[k], pr, acc[k][j]);
        acc[RC][j] += pr;
#pragma unroll
        for (int r = 0; r < FR; ++r) u[r] = fmaf(p, w[r][j], u[r]);
      }
      // both sums at once: the lanes trade halves (lane ^ 16), then add
      // the one value left over their 16 lanes; lane 16v holds output v
      const bool h16 = lane & 16;
      float m = h16 ? u[1] : u[0];
      m += __shfl_xor_sync(0xffffffffu, h16 ? u[0] : u[1], 16);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m += __shfl_xor_sync(0xffffffffu, m, off);
      if ((lane & 15) == 0) parts[((lane >> 4) * tiles + tile) * B + b] = m;
    } else {
      float p[kLaneCols];
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        float h = 0.f;
        for (int k = 0; k < RC; ++k) h = fmaf(__ldg(zcr + k), wv(k, j), h);
        h = h + wv(RC, j);
        p[j] = c0 + j < D ? expf(h - lb) : 0.f;
        const float pr = p[j] * rs;
        for (int k = 0; k < RC; ++k)
          accv(k, j) = fmaf(__ldg(zcr + k), pr, accv(k, j));
        accv(RC, j) += pr;
      }
      for (int r = 0; r < R; ++r) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) v = fmaf(p[j], wv(r, j), v);
        const float t = warp_sum(v);
        if (lane == (r & 31)) parts[(r * tiles + tile) * B + b] = t;
      }
    }
  }

  // column sums: each warp's, then the block's warps added in order
  if constexpr (kFixed) {
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        sacc[warp][k][lane * kLaneCols + j] = acc[k][j];
  }
  __syncthreads();
  auto sac = [&](int g, int k, int col) -> float {
    if constexpr (kFixed)
      return sacc[g][k][col];
    else
      return gsacc[(g * Tc + k) * kTile + col];
  };
  for (int i = threadIdx.x; i < Tc * kTile; i += kBlockThreads) {
    const int k = i / kTile;
    const int col = i % kTile;
    const int64_t c = tile * kTile + col;
    if (c >= D) continue;
    float s = sac(0, k, col);
#pragma unroll
    for (int g = 1; g < kWarps; ++g) s += sac(g, k, col);
    if (chunks == 1)
      fout[k * D + c] = s;
    else
      cparts[(static_cast<int64_t>(chunk) * Tc + k) * D + c] = s;
  }
}

// Stage 2 (nbk::tile::tile_sums): u2 from the row partials, fout from the
// chunks' column partials
__global__ void __launch_bounds__(kSumThreads)
finish_sum(const float* __restrict__ parts, const float* __restrict__ cparts,
           int64_t B, int64_t D, int R, int64_t tiles, int Tc, int chunks,
           int64_t row_blocks, int64_t col_blocks, float* __restrict__ u2,
           float* __restrict__ fout) {
  tile_sums(parts, cparts, nullptr, B, D, R, tiles, Tc, chunks, -1, 0,
            row_blocks, col_blocks, u2, fout, nullptr);
}

template <bool FIXED>
cudaError_t launch_tiles(const float* zc, const float* lse, const float* rsum,
                         const float* W, int64_t B, int64_t D, int R, int C,
                         int chunks, float* fout, float* parts, float* cparts,
                         cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(tiles_of(D)),
                  static_cast<unsigned>(chunks));
  const auto kernel =
      finish_tiles<FIXED ? kFixR : 0, FIXED ? kFixC : 0>;
  const int64_t smem = FIXED ? 0 : general_smem(R + C + 1);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kBlockThreads, smem, s>>>(zc, lse, rsum, W, B, D, R, C, fout,
                                           parts, cparts);
  return cudaGetLastError();
}

}  // namespace

// zc (B, R+C), lse (B, 1), rsum (B, 1), W (>= R+C+1, D); writes
// fout (R+C+1, D) and u2 (B, R).  The launch plan (ops/nb_step.finish_plan):
// fixed = 1 exactly when (R, C) = (2, 1); tile = kTile; chunks row chunks,
// 1 <= chunks <= B; ws holds ws_floats >= the u2 partials (R, tiles, B)
// and, with chunks > 1, the column partials (chunks, R+C+1, D).  The
// general instance takes any R >= 1, C >= 0 whose R + C + 1 rows fit a
// block's shared memory (kMaxSmem: R + C + 1 <= 181).  Returns
// cudaGetLastError() after the two launches (0 = launched).
extern "C" int mmvae_nb_finish(const void* zc, const void* lse,
                               const void* rsum, const void* W, int64_t B,
                               int64_t D, int R, int C, int fixed, int tile,
                               int chunks, void* fout, void* ws,
                               int64_t ws_floats, void* u2, void* stream) {
  const int Tc = R + C + 1;
  if (!dims_ok(B, D, R, C, 1) || fixed != (R == kFixR && C == kFixC ? 1 : 0) ||
      tile != kTile || chunks < 1 || chunks > B || chunks > kMaxChunks ||
      ws == nullptr || general_smem(Tc) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = tiles_of(D);
  const int64_t rows = R * tiles * B;
  const int64_t cols = chunks > 1 ? static_cast<int64_t>(chunks) * Tc * D : 0;
  if (ws_floats < rows + cols) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* parts = static_cast<float*>(ws);
  auto* cparts = parts + rows;
  auto* fp = static_cast<float*>(fout);
  const auto* zcp = static_cast<const float*>(zc);
  const auto* lp = static_cast<const float*>(lse);
  const auto* rp = static_cast<const float*>(rsum);
  const auto* Wp = static_cast<const float*>(W);
  const cudaError_t e =
      fixed ? launch_tiles<true>(zcp, lp, rp, Wp, B, D, R, C, chunks, fp,
                                 parts, cparts, s)
            : launch_tiles<false>(zcp, lp, rp, Wp, B, D, R, C, chunks, fp,
                                  parts, cparts, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t row_blocks = (R * B + 31) / 32;
  const int64_t col_blocks =
      chunks > 1 ? (Tc * D + kSumThreads - 1) / kSumThreads : 0;
  finish_sum<<<static_cast<unsigned>(row_blocks + col_blocks), kSumThreads, 0,
               s>>>(parts, cparts, B, D, R, tiles, Tc, chunks, row_blocks,
                    col_blocks, static_cast<float*>(u2), fp);
  return static_cast<int>(cudaGetLastError());
}
