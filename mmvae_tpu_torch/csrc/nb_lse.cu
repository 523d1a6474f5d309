// K1 for Hopper (sm_90a): the row logsumexp of the in-kernel decoder logits
//
//     h   = [zm | c] @ [wd; wc] + bias2        (B, D), never stored
//     lse = logsumexp(h, axis=1)                (B, 1)
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/nb_step.py: _make_lse_kernel
// / _lse_call, which carries an online (max, sum) pair across a sequential
// grid of D tiles.  Here the D tiles run as concurrent blocks (layout in
// nb_step_common.cuh): each warp reduces its 32 columns of a row to one
// (max, sum-of-exp) pair by shuffles and writes it as a partial; a second
// kernel merges the partials of each row in a fixed order.  Columns past
// the ragged D edge count as -inf.
//
// What bounds it on the H100: per (row, column) R + C FMAs and one expf,
// reading only the stacked weight rows (6 x D floats at the default
// model, from L2); the (B, D) logits are never written.  At B = 100,
// D = 20000 that is 2 M exps: a few microseconds of ALU work, so launch
// latency and the two shuffle reductions per row and warp dominate.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include "nb_step_common.cuh"

namespace {

using namespace nbk;

template <int NT>
__global__ void __launch_bounds__(kThreads)
lse_partials(const float* __restrict__ zc, const float* __restrict__ W,
             int64_t B, int64_t D, int RC, float* __restrict__ parts) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t tile = blockIdx.x;
  const int64_t c = tile * kTileCols + tx;
  const bool valid = c < D;
  float w[NT];
  load_wcol<NT>(W, D, c, valid, RC + 1, w);
  const int lane = tx & 31;
  const int64_t part = tile * kWarpCols + (tx >> 5);
  for (int64_t b = ty; b < B; b += kRowGroups) {
    const float h = valid ? compute_h<NT>(zc + b * RC, w, RC) : -INFINITY;
    const float m = warp_max(h);
    const float s = warp_sum(valid ? expf(h - m) : 0.f);
    if (lane == 0) {
      float* o = parts + (part * B + b) * 2;
      o[0] = m;
      o[1] = s;
    }
  }
}

// (M, S) <- merge with (m, s); an empty part (s == 0) changes nothing
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

__global__ void __launch_bounds__(kReduceThreads)
lse_merge(const float* __restrict__ parts, int64_t nparts, int64_t B,
          float* __restrict__ lse) {
  __shared__ float sm[kReduceThreads];
  __shared__ float ss[kReduceThreads];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  float M = -INFINITY, S = 0.f;
  for (int64_t j = t; j < nparts; j += kReduceThreads) {
    const float* p = parts + (j * B + b) * 2;
    merge(M, S, p[0], p[1]);
  }
  sm[t] = M;
  ss[t] = S;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
      float m0 = sm[t], s0 = ss[t];
      merge(m0, s0, sm[t + w], ss[t + w]);
      sm[t] = m0;
      ss[t] = s0;
    }
    __syncthreads();
  }
  if (t == 0) lse[b] = sm[0] + logf(ss[0]);
}

}  // namespace

// Workspace floats for mmvae_nb_lse: (num_parts(D), B, 2).
extern "C" int64_t mmvae_nb_lse_ws(int64_t B, int64_t D) {
  return num_parts(D) * B * 2;
}

// zc (B, R+C), W (>= R+C+1, D), ws as sized above, lse (B, 1).  Returns
// cudaGetLastError() after the two launches (0 = launched).
extern "C" int mmvae_nb_lse(const void* zc, const void* W, int64_t B,
                            int64_t D, int R, int C, void* ws, void* lse,
                            void* stream) {
  if (!dims_ok(B, D, R, C, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int RC = R + C;
  const dim3 grid(static_cast<unsigned>(num_tiles(D)));
  const dim3 block(kTileCols, kRowGroups);
  const auto* zcp = static_cast<const float*>(zc);
  const auto* Wp = static_cast<const float*>(W);
  auto* parts = static_cast<float*>(ws);
  if (RC + 1 <= 8)
    lse_partials<8><<<grid, block, 0, s>>>(zcp, Wp, B, D, RC, parts);
  else
    lse_partials<kMaxT><<<grid, block, 0, s>>>(zcp, Wp, B, D, RC, parts);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lse_merge<<<static_cast<unsigned>(B), kReduceThreads, 0, s>>>(
      parts, num_parts(D), B, static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}
