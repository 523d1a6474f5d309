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
// _make_finish_kernel / _finish_call.  Layout and reductions as in
// nb_step_common.cuh: fout's columns are summed over B inside the block,
// u2's rows over D as per-warp partials added in a fixed order by
// reduce_parts.  No atomics; bitwise repeatable.
//
// What bounds it on the H100: per (row, column) R + C FMAs, one expf and
// R + C + 1 FMAs into the column sums; no (B, D) operand is read, so it is
// ALU and shuffle bound (R shuffle reductions per row and warp).
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include "nb_step_common.cuh"

namespace {

using namespace nbk;

template <int NT>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ zc, const float* __restrict__ lse,
              const float* __restrict__ rsum, const float* __restrict__ W,
              int64_t B, int64_t D, int R, int C, float* __restrict__ fout,
              float* __restrict__ parts) {
  __shared__ float sacc[kRowGroups][NT][kTileCols];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t tile = blockIdx.x;
  const int64_t c = tile * kTileCols + tx;
  const bool valid = c < D;
  const int RC = R + C;
  float w[NT];
  load_wcol<NT>(W, D, c, valid, RC + 1, w);
  float acc[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) acc[k] = 0.f;
  const int lane = tx & 31;
  const int64_t part = tile * kWarpCols + (tx >> 5);

  for (int64_t b = ty; b < B; b += kRowGroups) {
    float p = 0.f;
    if (valid) {
      const float* zcr = zc + b * RC;
      p = expf(compute_h<NT>(zcr, w, RC) - __ldg(lse + b));
      const float pr = p * __ldg(rsum + b);
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        if (k < RC) acc[k] = fmaf(__ldg(zcr + k), pr, acc[k]);
        if (k == RC) acc[k] += pr;
      }
    }
    float* o = parts + (part * B + b) * R;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (k < R) {
        const float s = warp_sum(p * w[k]);
        if (lane == 0) o[k] = s;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NT; ++k) sacc[ty][k][tx] = acc[k];
  __syncthreads();
  if (ty == 0 && valid) {
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (k <= RC) {
        float s = sacc[0][k][tx];
#pragma unroll
        for (int g = 1; g < kRowGroups; ++g) s += sacc[g][k][tx];
        fout[k * D + c] = s;
      }
    }
  }
}

}  // namespace

// Workspace floats for mmvae_nb_finish: (num_parts(D), B, R).
extern "C" int64_t mmvae_nb_finish_ws(int64_t B, int64_t D, int R) {
  return num_parts(D) * B * R;
}

// zc (B, R+C), lse (B, 1), rsum (B, 1), W (>= R+C+1, D); writes
// fout (R+C+1, D) and u2 (B, R).  Returns cudaGetLastError() after the two
// launches (0 = launched).
extern "C" int mmvae_nb_finish(const void* zc, const void* lse,
                               const void* rsum, const void* W, int64_t B,
                               int64_t D, int R, int C, void* fout, void* ws,
                               void* u2, void* stream) {
  if (!dims_ok(B, D, R, C, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(num_tiles(D)));
  const dim3 block(kTileCols, kRowGroups);
  const auto* zcp = static_cast<const float*>(zc);
  const auto* lp = static_cast<const float*>(lse);
  const auto* rp = static_cast<const float*>(rsum);
  const auto* Wp = static_cast<const float*>(W);
  auto* fp = static_cast<float*>(fout);
  auto* parts = static_cast<float*>(ws);
  if (R + C + 1 <= 8)
    finish_kernel<8><<<grid, block, 0, s>>>(zcp, lp, rp, Wp, B, D, R, C, fp,
                                            parts);
  else
    finish_kernel<kMaxT><<<grid, block, 0, s>>>(zcp, lp, rp, Wp, B, D, R, C,
                                                fp, parts);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_reduce(parts, num_parts(D), B, R,
                                        static_cast<float*>(u2), R, s));
}
