// K6 for Hopper (sm_90a): the reporting NB negative log-likelihood
//
//     ls  = h - lse,  mu = exp(ls) * depth + EPS
//     nu  = clip(softplus(zn @ wn + bias_n), NU_LO, NU_HI) + EPS
//     nll = sum_{b,d} lgamma(nu) - lgamma(nu + x) [+ lgamma(x + 1)]
//                     + x (log(mu + nu) - log mu) + nu (log(mu + nu) - log nu)
//
// with the logits h built in the kernel from [zm | c] and the stacked
// weight rows, so the only (B, D) tensor read is the count matrix x.
//
// The joint vMF+NB model's variant (JOINT: has_pb and nu_exp together)
// scales p by exp(pb) of its column, pb the last stacked row, with exp(pb)
// taken once per column and not per element, and decodes
// nu = clamp(exp(npre), 0, NU_HI) + EPS.
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/nb_step.py:
// _make_value_kernel / _value_call (the reporting pass runs it with
// with_const=True; the joint model with has_pb and nu_exp).  As on the
// TPU, the lgamma differences take one of three regimes chosen per tile
// from ALL its valid counts: every count an integer <= 7 (exact
// select-product), every count an integer (the product saturated at 7
// factors plus a Stirling correction), otherwise the shift-into-Stirling
// lgamma.  Here the tile is a block's 64 columns
// x all B rows (block_regime), so the choice is uniform per block and
// costs no divergence.
//
// The scalar sum: each warp reduces its terms by shuffles into one
// partial, and reduce_parts adds the partials in a fixed order — no
// atomics, the same bits every run.
//
// What bounds it on the H100: one read of x (2 MB of int8 at B = 100,
// D = 20000) and ~6 transcendentals per element (exp, log1p, 3 logs, the
// regime's lgamma work; the joint variant decodes nu with one exp instead
// of exp + log1p); ALU and special-function throughput, not memory.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include "nb_step_common.cuh"

namespace {

using namespace nbk;

constexpr int kWarps = kThreads / 32;

template <typename T, int NT, bool CONST, bool JOINT>
__global__ void __launch_bounds__(kThreads)
value_partials(const T* __restrict__ x, const float* __restrict__ zc,
               const float* __restrict__ zn, const float* __restrict__ depth,
               const float* __restrict__ lse, const float* __restrict__ W,
               int64_t B, int64_t D, int R, int C, int Rn,
               float* __restrict__ parts) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kTileCols + tx;
  const bool valid = c < D;
  const int RC = R + C;
  const int base = RC + 1;
  float w[NT];
  load_wcol<NT>(W, D, c, valid, RC + Rn + 2 + (JOINT ? 1 : 0), w);
  const float epb = JOINT ? exp_pb<NT>(w, RC + Rn + 2) : 1.f;
  const int regime = block_regime<T>(x, B, D, c, valid, ty);
  float acc = 0.f;
  if (valid) {
    for (int64_t b = ty; b < B; b += kRowGroups) {
      const float xv = load_count(x + b * D + c);
      const float h = compute_h<NT>(zc + b * RC, w, RC);
      float p = expf(h - __ldg(lse + b));
      if (JOINT) p *= epb;
      const float mu = p * __ldg(depth + b) + kEps;
      const float npre = compute_nupre<NT>(zn + b * Rn, w, base, Rn);
      float nu;
      if (JOINT) {
        nu = exp_nu(expf(npre));
      } else {
        const float sp = fmaxf(npre, 0.f) + log1pf(expf(-fabsf(npre)));
        nu = fminf(fmaxf(sp, kNuLo), kNuHi) + kEps;
      }
      const float denom = logf(mu + nu);
      acc += lg_terms<CONST>(regime, xv, nu) + xv * (denom - logf(mu)) +
             nu * (denom - logf(nu));
    }
  }
  acc = warp_sum(acc);
  const int warp = (ty * kTileCols + tx) >> 5;
  if ((tx & 31) == 0) parts[static_cast<int64_t>(blockIdx.x) * kWarps + warp] = acc;
}

template <typename T, int NT, bool JOINT>
void launch(const void* x, const float* zc, const float* zn,
            const float* depth, const float* lse, const float* W, int64_t B,
            int64_t D, int R, int C, int Rn, bool with_const, float* parts,
            cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(num_tiles(D)));
  const dim3 block(kTileCols, kRowGroups);
  const T* xp = static_cast<const T*>(x);
  if (with_const)
    value_partials<T, NT, true, JOINT><<<grid, block, 0, s>>>(
        xp, zc, zn, depth, lse, W, B, D, R, C, Rn, parts);
  else
    value_partials<T, NT, false, JOINT><<<grid, block, 0, s>>>(
        xp, zc, zn, depth, lse, W, B, D, R, C, Rn, parts);
}

template <typename T>
void launch_nt(const void* x, const float* zc, const float* zn,
               const float* depth, const float* lse, const float* W,
               int64_t B, int64_t D, int R, int C, int Rn, bool with_const,
               bool joint, float* parts, cudaStream_t s) {
  const bool narrow = R + C + Rn + 2 + (joint ? 1 : 0) <= 8;
  if (narrow && joint)
    launch<T, 8, true>(x, zc, zn, depth, lse, W, B, D, R, C, Rn, with_const,
                       parts, s);
  else if (narrow)
    launch<T, 8, false>(x, zc, zn, depth, lse, W, B, D, R, C, Rn, with_const,
                        parts, s);
  else if (joint)
    launch<T, kMaxT, true>(x, zc, zn, depth, lse, W, B, D, R, C, Rn,
                           with_const, parts, s);
  else
    launch<T, kMaxT, false>(x, zc, zn, depth, lse, W, B, D, R, C, Rn,
                            with_const, parts, s);
}

}  // namespace

// Workspace floats for mmvae_nb_value: one partial per warp of each tile.
extern "C" int64_t mmvae_nb_value_ws(int64_t D) {
  return num_tiles(D) * kWarps;
}

// dtype: 0 = float32, 1 = int16, 2 = int8.  x (B, D), zc (B, R+C),
// zn (B, Rn), depth (B, 1), lse (B, 1), W (R+C+Rn+2+joint, D); joint = 1
// selects the pb / exp-nu variant.  out is one float.  Returns
// cudaGetLastError() after the two launches (0 = launched).
extern "C" int mmvae_nb_value(const void* x, int dtype, const void* zc,
                              const void* zn, const void* depth,
                              const void* lse, const void* W, int64_t B,
                              int64_t D, int R, int C, int Rn, int with_const,
                              int joint, void* ws, void* out, void* stream) {
  if (!dims_ok(B, D, R, C, Rn, joint != 0) || (joint != 0 && joint != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* zcp = static_cast<const float*>(zc);
  const auto* znp = static_cast<const float*>(zn);
  const auto* dp = static_cast<const float*>(depth);
  const auto* lp = static_cast<const float*>(lse);
  const auto* Wp = static_cast<const float*>(W);
  auto* parts = static_cast<float*>(ws);
  const bool wc = with_const != 0;
  const bool jt = joint != 0;
  switch (dtype) {
    case 0:
      launch_nt<float>(x, zcp, znp, dp, lp, Wp, B, D, R, C, Rn, wc, jt, parts,
                       s);
      break;
    case 1:
      launch_nt<int16_t>(x, zcp, znp, dp, lp, Wp, B, D, R, C, Rn, wc, jt,
                         parts, s);
      break;
    case 2:
      launch_nt<int8_t>(x, zcp, znp, dp, lp, Wp, B, D, R, C, Rn, wc, jt,
                        parts, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_reduce(parts, mmvae_nb_value_ws(D), 1, 1,
                                        static_cast<float*>(out), 1, s));
}
