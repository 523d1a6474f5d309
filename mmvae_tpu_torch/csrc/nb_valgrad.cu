// K2 for Hopper (sm_90a): the gradient of the boot-step NB NLL in ONE pass
// over the counts (grad-only form)
//
//   per column d (stacked like W):  gout = [zc^T dls ; colsum dls ;
//                                           zn^T dnupre ; colsum dnupre]
//   per row b:  rsum = rowsum(dls),  u1 = dls @ wd^T,  dzn = dnupre @ wn^T
//
// where dls = d nll / d log_softmax(h) (before the softmax coupling, which
// the finisher K3 supplies) and dnupre = d nll / d (zn @ wn + bias_n).
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/nb_step.py:
// _make_valgrad_kernel / _valgrad_call in four instances: need_value=False
// (the form every packed boot step runs) for the NB model and for the joint
// vMF+NB model (JOINT = has_pb and nu_exp), and need_value=True (VALUE: the
// value-bearing boot step) for each of them, nb_step_boot and
// nb_step_boot_joint.  The math follows the TPU kernel line by line:
//   * softplus and the sigmoid the backward needs share one exp(-|z|);
//   * ONE divide gives 1/(mu+nu), 1/mu and the sigmoid's 1/(1+e):
//     rec = 1/((1+e) mu (mu+nu)).  dP/P of the select-product is a divide
//     of its own and is NOT folded into it: P grows like nu^7 and the
//     product would overflow float32 at large depth;
//   * grad-only: log(mu+nu) - log(nu) = -log(nu / (mu+nu)), one log;
//   * the digamma difference takes the block's regime (all counts <= 7,
//     all integer, or general), chosen from every valid count of the tile.
// JOINT: mu = pe * depth + EPS with pe = p * exp(pb), exp(pb) once per
// column; dls uses pe, while K3's coupling term keeps the plain p, so
// gw = gout - fout stays right.  nu = clamp(exp(npre), 0, NU_HI) + EPS:
// no sigmoid, so rec = 1/(mu (mu+nu)) without the (1+e) factor, and
// dnupre = dnu * exp(npre) where exp(npre) < NU_HI (the lower clamp never
// binds).  The pb gradient row, colsum(dls), is one more per-column row.
//
// VALUE adds the NLL without lgamma(x + 1): the lgamma difference in the
// block's regime (lg_terms, as K6 computes it) plus
// x (log(mu + nu) - log mu) + nu (log(mu + nu) - log nu), where both log
// differences are taken as one log of a ratio from the shared reciprocal
// (the grad-only dln, and -log(mu / (mu + nu))).  Every gradient
// expression is the grad-only instance's, so the two write the same bits;
// each warp's value partial is one float per tile, added in a fixed order
// by a second reduce_parts launch.
//
// Two kinds of reduction (layout in nb_step_common.cuh): the per-column
// rows of gout sum over the B rows inside the block (row groups combine
// through shared memory in a fixed order), the per-row outputs sum over D
// as per-warp partials that reduce_parts adds in a fixed order.  No
// atomics; bitwise repeatable.
//
// What bounds it on the H100: one read of x and ~8 transcendentals plus
// ~60 FMAs per element; ALU / special-function bound at the default
// widths, with 4 + 2 * 5 warp shuffles per (row, warp) for the row sums.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include "nb_step_common.cuh"

namespace {

using namespace nbk;

// The grad-only JOINT instances ask for three blocks per SM (at most 80
// registers a thread): left to themselves, ptxas gives their NT = 8
// instances 94 registers for int8 and float32 counts, two blocks per SM,
// and they ran 1.5x their int16 twin.  The NB instances ask for one block
// per SM: a bound of three made them ~10% slower on the H100.  The JOINT
// VALUE instances keep the lgamma terms live as well and ask for two:
// under a bound of three their NT = 16 instances spilled (80 registers,
// 72 bytes), under two they take 105-109 without a spill; the NT = 8
// ones take 64-71 either way.
template <bool JOINT, bool VALUE>
constexpr int min_blocks() {
  return JOINT ? (VALUE ? 2 : 3) : 1;
}

template <typename T, int NT, bool JOINT, bool VALUE>
__global__ void __launch_bounds__(kThreads, (min_blocks<JOINT, VALUE>()))
valgrad_kernel(const T* __restrict__ x, const float* __restrict__ zc,
               const float* __restrict__ zn, const float* __restrict__ depth,
               const float* __restrict__ lse, const float* __restrict__ W,
               int64_t B, int64_t D, int R, int C, int Rn,
               float* __restrict__ gout, float* __restrict__ parts,
               float* __restrict__ vparts) {
  __shared__ float sacc[kRowGroups][NT][kTileCols];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t tile = blockIdx.x;
  const int64_t c = tile * kTileCols + tx;
  const bool valid = c < D;
  const int RC = R + C;
  const int base = RC + 1;
  const int pbi = RC + Rn + 2;  // the pb row (JOINT)
  const int Tn = RC + Rn + 2 + (JOINT ? 1 : 0);
  const int K = 1 + R + Rn;
  float w[NT];
  load_wcol<NT>(W, D, c, valid, Tn, w);
  const float epb = JOINT ? exp_pb<NT>(w, pbi) : 1.f;
  const int regime = block_regime<T>(x, B, D, c, valid, ty);
  float acc[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) acc[k] = 0.f;
  const int lane = tx & 31;
  const int64_t part = tile * kWarpCols + (tx >> 5);
  float val = 0.f;  // VALUE: this thread's NLL terms

  for (int64_t b = ty; b < B; b += kRowGroups) {
    float dls = 0.f, dnp = 0.f;
    if (valid) {
      const float xv = load_count(x + b * D + c);
      const float dep = __ldg(depth + b);
      const float h = compute_h<NT>(zc + b * RC, w, RC);
      const float p = expf(h - __ldg(lse + b));
      const float pe = JOINT ? p * epb : p;
      const float mu = pe * dep + kEps;
      const float npre = compute_nupre<NT>(zn + b * Rn, w, base, Rn);
      // JOINT: sp = exp(npre); otherwise softplus and the sigmoid share
      // one exp(-|npre|)
      const float e = JOINT ? 0.f : expf(-fabsf(npre));
      const float sp = JOINT ? expf(npre) : fmaxf(npre, 0.f) + log1pf(e);
      const float nu =
          JOINT ? exp_nu(sp) : fminf(fmaxf(sp, kNuLo), kNuHi) + kEps;
      const float dg = dg_term(regime, xv, nu);
      // the one shared divide
      const float mn = mu + nu;
      const float v = mu * mn;
      float rec, sig = 0.f;
      if (JOINT) {
        rec = 1.f / v;
      } else {
        const float u = 1.f + e;
        rec = 1.f / (u * v);
        const float r = rec * v;
        sig = npre >= 0.f ? r : e * r;
        rec = rec * u;
      }
      const float inv_mn = rec * mu;
      const float inv_mu = rec * mn;
      const float dln = -logf(nu * inv_mn);
      const float t = (xv + nu) * inv_mn;
      const float dmu = t - xv * inv_mu;
      dls = dmu * pe * dep;
      const float dnu = dg + t + dln - 1.f;
      if (VALUE)
        val += lg_terms<false>(regime, xv, nu) - xv * logf(mu * inv_mn) +
               nu * dln;
      if (JOINT)
        dnp = sp < kNuHi ? dnu * sp : 0.f;
      else
        dnp = (sp > kNuLo && sp < kNuHi) ? dnu * sig : 0.f;
      const float* zcr = zc + b * RC;
      const float* znr = zn + b * Rn;
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        if (k < RC) acc[k] = fmaf(__ldg(zcr + k), dls, acc[k]);
        if (k == RC) acc[k] += dls;
        if (k >= base && k < base + Rn)
          acc[k] = fmaf(__ldg(znr + (k - base)), dnp, acc[k]);
        if (k == base + Rn) acc[k] += dnp;
        if (JOINT && k == pbi) acc[k] += dls;
      }
    }
    // per-row sums over this warp's 32 columns: [rsum | u1 | dzn]
    float* o = parts + (part * B + b) * K;
    const float rs = warp_sum(dls);
    if (lane == 0) o[0] = rs;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (k < R) {
        const float s = warp_sum(dls * w[k]);
        if (lane == 0) o[1 + k] = s;
      }
      if (k >= base && k < base + Rn) {
        const float s = warp_sum(dnp * w[k]);
        if (lane == 0) o[1 + R + (k - base)] = s;
      }
    }
  }

  if (VALUE) {
    val = warp_sum(val);
    if (lane == 0) vparts[tile * (kThreads / 32) + ((ty * kTileCols + tx) >> 5)] = val;
  }

  // per-column sums: add the row groups in order
#pragma unroll
  for (int k = 0; k < NT; ++k) sacc[ty][k][tx] = acc[k];
  __syncthreads();
  if (ty == 0 && valid) {
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (k < Tn) {
        float s = sacc[0][k][tx];
#pragma unroll
        for (int g = 1; g < kRowGroups; ++g) s += sacc[g][k][tx];
        gout[k * D + c] = s;
      }
    }
  }
}

template <typename T, bool JOINT, bool VALUE>
void launch(const void* x, const float* zc, const float* zn,
            const float* depth, const float* lse, const float* W, int64_t B,
            int64_t D, int R, int C, int Rn, float* gout, float* parts,
            float* vparts, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(num_tiles(D)));
  const dim3 block(kTileCols, kRowGroups);
  const T* xp = static_cast<const T*>(x);
  if (R + C + Rn + 2 + (JOINT ? 1 : 0) <= 8)
    valgrad_kernel<T, 8, JOINT, VALUE><<<grid, block, 0, s>>>(
        xp, zc, zn, depth, lse, W, B, D, R, C, Rn, gout, parts, vparts);
  else
    valgrad_kernel<T, kMaxT, JOINT, VALUE><<<grid, block, 0, s>>>(
        xp, zc, zn, depth, lse, W, B, D, R, C, Rn, gout, parts, vparts);
}

template <typename T>
void launch_variant(const void* x, const float* zc, const float* zn,
                    const float* depth, const float* lse, const float* W,
                    int64_t B, int64_t D, int R, int C, int Rn, bool joint,
                    bool value, float* gout, float* parts, float* vparts,
                    cudaStream_t s) {
  if (joint && value)
    launch<T, true, true>(x, zc, zn, depth, lse, W, B, D, R, C, Rn, gout,
                          parts, vparts, s);
  else if (joint)
    launch<T, true, false>(x, zc, zn, depth, lse, W, B, D, R, C, Rn, gout,
                           parts, vparts, s);
  else if (value)
    launch<T, false, true>(x, zc, zn, depth, lse, W, B, D, R, C, Rn, gout,
                           parts, vparts, s);
  else
    launch<T, false, false>(x, zc, zn, depth, lse, W, B, D, R, C, Rn, gout,
                            parts, vparts, s);
}

}  // namespace

// Workspace floats for mmvae_nb_valgrad: (num_parts(D), B, 1 + R + Rn)
// row partials, then one value partial per warp of each tile.
extern "C" int64_t mmvae_nb_valgrad_ws(int64_t B, int64_t D, int R, int Rn) {
  return num_parts(D) * B * (1 + R + Rn) + num_tiles(D) * (kThreads / 32);
}

// dtype: 0 = float32, 1 = int16, 2 = int8.  joint = 1 selects the pb /
// exp-nu variant, whose W and gout have the pb row last; need_value = 1
// also writes the NLL without lgamma(x + 1) to value (one float; unused
// otherwise).  Writes gout (R+C+Rn+2+joint, D) and rowout
// (B, 1 + R + Rn) = [rsum | u1 | dzn].  Returns cudaGetLastError() after
// the launches (0 = launched).
extern "C" int mmvae_nb_valgrad(const void* x, int dtype, const void* zc,
                                const void* zn, const void* depth,
                                const void* lse, const void* W, int64_t B,
                                int64_t D, int R, int C, int Rn, int joint,
                                int need_value, void* gout, void* ws,
                                void* rowout, void* value, void* stream) {
  if (!dims_ok(B, D, R, C, Rn, joint != 0) || (joint != 0 && joint != 1) ||
      (need_value != 0 && need_value != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool jt = joint != 0;
  const bool nv = need_value != 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* zcp = static_cast<const float*>(zc);
  const auto* znp = static_cast<const float*>(zn);
  const auto* dp = static_cast<const float*>(depth);
  const auto* lp = static_cast<const float*>(lse);
  const auto* Wp = static_cast<const float*>(W);
  auto* gp = static_cast<float*>(gout);
  const int K = 1 + R + Rn;
  auto* parts = static_cast<float*>(ws);
  auto* vparts = parts + num_parts(D) * B * K;
  switch (dtype) {
    case 0:
      launch_variant<float>(x, zcp, znp, dp, lp, Wp, B, D, R, C, Rn, jt, nv,
                            gp, parts, vparts, s);
      break;
    case 1:
      launch_variant<int16_t>(x, zcp, znp, dp, lp, Wp, B, D, R, C, Rn, jt, nv,
                              gp, parts, vparts, s);
      break;
    case 2:
      launch_variant<int8_t>(x, zcp, znp, dp, lp, Wp, B, D, R, C, Rn, jt, nv,
                             gp, parts, vparts, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_reduce(parts, num_parts(D), B, K, static_cast<float*>(rowout), K,
                    s);
  if (e != cudaSuccess || !nv) return static_cast<int>(e);
  return static_cast<int>(launch_reduce(vparts, num_tiles(D) * (kThreads / 32),
                                        1, 1, static_cast<float*>(value), 1,
                                        s));
}
