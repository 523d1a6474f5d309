// P1 for Hopper (sm_90a): the roofline probe of the NB valgrad kernel.
//
// Replaces the Pallas TPU kernel benchmarks/valgrad_roofline.py:
// _elementwise_kernel (pl.pallas_call at :69).  It computes what that
// kernel computes, for each element of a (B, D) float32 array:
//
//   y_i = x * (1 + 0.01 i)            for i < CHAINS independent chains
//   y_i = op(y_i)                     NREP times, the chains interleaved
//   out = y_0 + y_1 + ... + y_{CHAINS-1}
//
// with op one of the five classes of the JAX probe (its main(), :169-175):
//   fma     y * 0.9999 + 1e-4
//   exp     exp(-y) * 0.5 + 0.25
//   log     log1p(y) * 0.8 + 0.1
//   div     1 / (1 + y)
//   select  y > 0.5 ? y * 0.9 : y
// so that the slope of its time over NREP prices one op of each class at
// the geometry of the kernel it measures.
//
// The geometry is K2's own (nb_valgrad.cu, nb_step_common.cuh), not the
// TPU's (104, 1024) x 20 tiling: a block is kTileCols columns x
// kRowGroups row groups of threads, each thread walking rows ty, ty + 4,
// ... of its column, one row at a time (`#pragma unroll 1`: K2's row loop
// is not unrolled either, so rows add no ILP that K2 does not have).
//
// NREP (8 and 40, the JAX probe's; 2 for the CPU tests' shapes) and
// CHAINS (1 and 4) are template parameters and their loops are unrolled,
// as Pallas unrolls them at trace time: a runtime loop would add a
// counter, a compare and a branch to each repetition and bias the
// single-chain slope.  The chains live in a register array; x is read
// from memory and the sum stored, so nothing folds away.
//
// Built with the port's flags (ops/_cuda.py), without --use_fast_math:
// expf, log1pf and the IEEE divide are the accurate sequences K2 gets.
// nvcc contracts y * a + b into one FFMA (--fmad=true is its default), so
// the fma and the exp / log classes round once where the plain PyTorch
// version rounds twice; every op is a contraction, so the two stay within
// a few ulp.
//
// What bounds it on the H100: operations (the fma class at NREP 40 and
// four chains is 320 M FFMAs on 2 M elements against 8 MB read and 8 MB
// written).  It exists to be timed, not to be fast.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "nb_step_common.cuh"

namespace {

using nbk::kRowGroups;
using nbk::kThreads;
using nbk::kTileCols;

enum Op : int { kFma = 0, kExp = 1, kLog = 2, kDiv = 3, kSelect = 4 };

// the probe's constants as JAX and PyTorch take a Python float into a
// float32 op: the double, rounded once to float32
template <int OP>
__device__ __forceinline__ float apply(float y) {
  constexpr float kA = static_cast<float>(0.9999), kB = static_cast<float>(1e-4);
  constexpr float kHalf = static_cast<float>(0.5), kQuarter = static_cast<float>(0.25);
  constexpr float kL = static_cast<float>(0.8), kTenth = static_cast<float>(0.1);
  constexpr float kSel = static_cast<float>(0.9);
  if (OP == kFma) return y * kA + kB;
  if (OP == kExp) return expf(-y) * kHalf + kQuarter;
  if (OP == kLog) return log1pf(y) * kL + kTenth;
  if (OP == kDiv) return 1.f / (1.f + y);
  return y > kHalf ? y * kSel : y;
}

template <int OP, int NREP, int CHAINS>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(const float* __restrict__ x, int64_t B, int64_t D,
                   float* __restrict__ out) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kTileCols + threadIdx.x;
  if (c >= D) return;
#pragma unroll 1
  for (int64_t b = threadIdx.y; b < B; b += kRowGroups) {
    const float xv = x[b * D + c];
    float y[CHAINS];
#pragma unroll
    for (int i = 0; i < CHAINS; ++i)
      // the JAX probe's multiplier: 1 + 0.01 i in double, then float32
      y[i] = xv * static_cast<float>(1.0 + 0.01 * i);
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
#pragma unroll
      for (int i = 0; i < CHAINS; ++i) y[i] = apply<OP>(y[i]);
    }
    float acc = y[0];
#pragma unroll
    for (int i = 1; i < CHAINS; ++i) acc = acc + y[i];
    out[b * D + c] = acc;
  }
}

template <int OP, int NREP, int CHAINS>
void launch_n(const float* x, int64_t B, int64_t D, float* out, int reps,
              cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(nbk::num_tiles(D)));
  const dim3 block(kTileCols, kRowGroups);
  for (int r = 0; r < reps; ++r)
    elementwise_kernel<OP, NREP, CHAINS><<<grid, block, 0, s>>>(x, B, D, out);
}

// every (nrep, chains) instance of one op class; false when not built
template <int OP>
bool launch_op(int nrep, int chains, const float* x, int64_t B, int64_t D,
               float* out, int reps, cudaStream_t s) {
#define MMVAE_P1_CASE(N, C)                                  \
  if (nrep == N && chains == C) {                            \
    launch_n<OP, N, C>(x, B, D, out, reps, s);               \
    return true;                                             \
  }
  MMVAE_P1_CASE(2, 1)
  MMVAE_P1_CASE(2, 4)
  MMVAE_P1_CASE(8, 1)
  MMVAE_P1_CASE(8, 4)
  MMVAE_P1_CASE(40, 1)
  MMVAE_P1_CASE(40, 4)
#undef MMVAE_P1_CASE
  return false;
}

}  // namespace

// op: 0 fma, 1 exp, 2 log, 3 div, 4 select; nrep in {2, 8, 40}, chains in
// {1, 4} (the compiled instances).  Launches the kernel `reps` times back
// to back on `stream`, each writing the same (B, D) out from x, so a
// timing loop pays no host time between launches.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int mmvae_roofline_elementwise(const void* x, int64_t B, int64_t D,
                                          int op, int nrep, int chains,
                                          int reps, void* out, void* stream) {
  if (B < 1 || D < 1 || reps < 1 || nbk::num_tiles(D) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const float*>(x);
  auto* op_ = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (op) {
    case kFma:
      ok = launch_op<kFma>(nrep, chains, xp, B, D, op_, reps, s);
      break;
    case kExp:
      ok = launch_op<kExp>(nrep, chains, xp, B, D, op_, reps, s);
      break;
    case kLog:
      ok = launch_op<kLog>(nrep, chains, xp, B, D, op_, reps, s);
      break;
    case kDiv:
      ok = launch_op<kDiv>(nrep, chains, xp, B, D, op_, reps, s);
      break;
    case kSelect:
      ok = launch_op<kSelect>(nrep, chains, xp, B, D, op_, reps, s);
      break;
    default:
      break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
