// K7 and K8 for Hopper (sm_90a): the v1 fused NB ELBO data term over
// materialized decoder logits h and overdispersion pre-activations nu_pre
//
//     ls  = h - lse,  lse = logsumexp(h) over the row,  p = exp(ls)
//     mu  = p * depth + EPS
//     nu  = clip(softplus(nu_pre), NU_LO, NU_HI) + EPS
//     nll = sum_{b,d} lgamma(nu) - lgamma(nu + x) [+ lgamma(x + 1)]
//                     + x (log(mu + nu) - log mu) + nu (log(mu + nu) - log nu)
//
// K7 (nb_elbo_fwd, WITH_CONST adds lgamma(x + 1)) replaces the Pallas TPU
// kernel mmvae_tpu/ops/nb_elbo.py: _make_fwd_kernel / _fwd_call.  The TPU
// kernel walks D tiles twice in grid order (phase 0: an online max / sum of
// exp in VMEM scratch; phase 1: the terms) and carries per-row sums from
// tile to tile.  Here ONE block owns one row (B = 100 rows fit the 132
// SMs): its threads stride the row's columns twice, first for the online
// max / sum of exp, then for the terms, and reduce their partials in a
// fixed order (warp shuffles, then the warps in index order).  Per row it
// writes lse, rowsum(dls) with dls = dmu * p * depth, rowsum(dmu * p) (the
// depth gradient) and the row's NLL; a second launch (reduce_parts) adds
// the B row NLLs in a fixed order.  No atomics: a row's outputs depend on
// its data alone, and the scalar is bitwise repeatable.  Every lgamma,
// lgamma(x + 1) included, is the shift-into-Stirling lgamma_pos, as on the
// TPU (not K6's three count regimes).
//
// K8 (nb_elbo_bwd) replaces _bwd_kernel / _bwd_call: an elementwise map
// over (B, D) that recomputes the activations from the saved (B, 1)
// residuals and writes
//     dh  = g (dls - p rowsum(dls))
//     dnu = g (psi(nu) - psi(nu + x) + (x + nu)/(mu + nu) + log(mu + nu)
//              - log nu - 1) sigmoid(nu_pre)   where NU_LO < softplus < NU_HI,
//           0 elsewhere (the clamp's mask, kept exactly)
// with g the NLL's cotangent, read from device memory.
//
// Operands (row-major, contiguous): x (B, D) int8 / int16 / float32,
// widened in registers; h, nu_pre (B, D) float32; depth (B, 1).
//
// What bounds them on the H100: K7 reads x once, h twice (the second pass
// mostly from L2) and nu_pre once, with ~70 operations an element (two or
// three lgamma_pos, exp, log1p, three logs, two divides); K8 reads x, h
// and nu_pre once, writes dh and dnu, ~75 operations an element (two
// digamma_pos with eight divides each).  At B = 100, D = 20,000 both are
// memory bound in principle (~24 MB read); the simple one-row-per-block K7
// leaves 32 SMs idle and is latency bound.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include "nb_step_common.cuh"

namespace {

using namespace nbk;

constexpr int kFwdThreads = 512;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float sigmoid(float v) {
  if (v >= 0.f) return 1.f / (1.f + expf(-v));
  const float e = expf(v);
  return e / (1.f + e);
}

// (max, sum of exp) pair merge of the online logsumexp
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T, bool CONST>
__global__ void __launch_bounds__(kFwdThreads)
elbo_fwd_kernel(const T* __restrict__ x, const float* __restrict__ h,
                const float* __restrict__ nu_pre,
                const float* __restrict__ depth, int64_t B, int64_t D,
                float* __restrict__ rows) {
  __shared__ float sm[kFwdWarps], ss[kFwdWarps];
  __shared__ float s_acc[3][kFwdWarps];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const float* hr = h + b * D;

  // phase 0: online max / sum of exp over the row
  float m = -INFINITY, s = 0.f;
  for (int64_t d = t; d < D; d += kFwdThreads) {
    const float v = __ldg(hr + d);
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  m = sm[0];
  s = ss[0];
  for (int w = 1; w < kFwdWarps; ++w) lse_merge(m, s, sm[w], ss[w]);
  const float lse = m + logf(s);

  // phase 1: the terms and the backward's row sums
  const float dep = __ldg(depth + b);
  const T* xr = x + b * D;
  const float* nr = nu_pre + b * D;
  float nll = 0.f, rs = 0.f, dd = 0.f;
  for (int64_t d = t; d < D; d += kFwdThreads) {
    const float xv = load_count(xr + d);
    const float p = expf(__ldg(hr + d) - lse);
    const float mu = p * dep + kEps;
    const float nu = fminf(fmaxf(softplus(__ldg(nr + d)), kNuLo), kNuHi) + kEps;
    const float inv_mn = 1.f / (mu + nu);
    const float dmu = xv * (inv_mn - 1.f / mu) + nu * inv_mn;
    const float denom = logf(mu + nu);
    float term = lgamma_pos(nu) - lgamma_pos(nu + xv) +
                 xv * (denom - logf(mu)) + nu * (denom - logf(nu));
    if (CONST) term += lgamma_pos(xv + 1.f);
    nll += term;
    const float dmu_p = dmu * p;
    rs += dmu_p * dep;
    dd += dmu_p;
  }
  nll = warp_sum(nll);
  rs = warp_sum(rs);
  dd = warp_sum(dd);
  if (lane == 0) {
    s_acc[0][warp] = nll;
    s_acc[1][warp] = rs;
    s_acc[2][warp] = dd;
  }
  __syncthreads();
  if (t < 3) {
    float a = s_acc[t][0];
    for (int w = 1; w < kFwdWarps; ++w) a += s_acc[t][w];
    // rows: [lse | rowsum(dls) | rowsum(dmu p) | row NLL], each (B,)
    rows[(t == 0 ? 3 : t) * B + b] = a;
  }
  if (t == 3) rows[b] = lse;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
elbo_bwd_kernel(const float* __restrict__ g, const T* __restrict__ x,
                const float* __restrict__ h, const float* __restrict__ nu_pre,
                const float* __restrict__ depth, const float* __restrict__ lse,
                const float* __restrict__ rowsum, int64_t D,
                float* __restrict__ dh, float* __restrict__ dnu) {
  const int64_t b = blockIdx.y;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (d >= D) return;
  const int64_t i = b * D + d;
  const float gv = __ldg(g);
  const float dep = __ldg(depth + b);
  const float xv = load_count(x + i);
  const float p = expf(__ldg(h + i) - __ldg(lse + b));
  const float mu = p * dep + kEps;
  const float np = __ldg(nu_pre + i);
  const float sp = softplus(np);
  const float nu = fminf(fmaxf(sp, kNuLo), kNuHi) + kEps;
  const float inv_mn = 1.f / (mu + nu);
  const float dmu = xv * (inv_mn - 1.f / mu) + nu * inv_mn;
  dh[i] = gv * (dmu * p * dep - p * __ldg(rowsum + b));
  const float dn = digamma_pos(nu) - digamma_pos(nu + xv) +
                   (xv + nu) * inv_mn + logf(mu + nu) - logf(nu) - 1.f;
  dnu[i] = (sp > kNuLo && sp < kNuHi) ? gv * dn * sigmoid(np) : 0.f;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* h, const float* nu_pre,
                       const float* depth, int64_t B, int64_t D, bool with_const,
                       float* rows, float* out, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const dim3 grid(static_cast<unsigned>(B));
  if (with_const)
    elbo_fwd_kernel<T, true><<<grid, kFwdThreads, 0, s>>>(xp, h, nu_pre,
                                                         depth, B, D, rows);
  else
    elbo_fwd_kernel<T, false><<<grid, kFwdThreads, 0, s>>>(xp, h, nu_pre,
                                                          depth, B, D, rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the row NLLs (rows[3 B .. 4 B)) added in a fixed order
  return launch_reduce(rows + 3 * B, B, 1, 1, out, 1, s);
}

template <typename T>
cudaError_t launch_bwd(const float* g, const void* x, const float* h,
                       const float* nu_pre, const float* depth,
                       const float* lse, const float* rowsum, int64_t B,
                       int64_t D, float* dh, float* dnu, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((D + kBwdThreads - 1) / kBwdThreads),
                  static_cast<unsigned>(B));
  elbo_bwd_kernel<T><<<grid, kBwdThreads, 0, s>>>(
      g, static_cast<const T*>(x), h, nu_pre, depth, lse, rowsum, D, dh, dnu);
  return cudaGetLastError();
}

inline bool elbo_dims_ok(int64_t B, int64_t D) {
  return B >= 1 && D >= 1 && B <= 65535 &&
         (D + kBwdThreads - 1) / kBwdThreads <= 0x7fffffff;
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8.  x, h, nu_pre (B, D); depth
// (B, 1).  rows is (4, B) float32: [lse | rowsum(dls) | rowsum(dmu p) |
// row NLL]; out one float, the NLL.  Returns cudaGetLastError() after the
// two launches (0 = launched).
extern "C" int mmvae_nb_elbo_fwd(const void* x, int dtype, const void* h,
                                 const void* nu_pre, const void* depth,
                                 int64_t B, int64_t D, int with_const,
                                 void* rows, void* out, void* stream) {
  if (!elbo_dims_ok(B, D)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* hp = static_cast<const float*>(h);
  const auto* np = static_cast<const float*>(nu_pre);
  const auto* dp = static_cast<const float*>(depth);
  auto* rp = static_cast<float*>(rows);
  auto* op = static_cast<float*>(out);
  const bool wc = with_const != 0;
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch_fwd<float>(x, hp, np, dp, B, D, wc, rp, op, s);
      break;
    case 1:
      e = launch_fwd<int16_t>(x, hp, np, dp, B, D, wc, rp, op, s);
      break;
    case 2:
      e = launch_fwd<int8_t>(x, hp, np, dp, B, D, wc, rp, op, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// g: the scalar cotangent (one float in device memory).  Writes dh and
// dnu (B, D).  Returns cudaGetLastError() after the launch.
extern "C" int mmvae_nb_elbo_bwd(const void* g, const void* x, int dtype,
                                 const void* h, const void* nu_pre,
                                 const void* depth, const void* lse,
                                 const void* rowsum, int64_t B, int64_t D,
                                 void* dh, void* dnu, void* stream) {
  if (!elbo_dims_ok(B, D)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(g);
  const auto* hp = static_cast<const float*>(h);
  const auto* np = static_cast<const float*>(nu_pre);
  const auto* dp = static_cast<const float*>(depth);
  const auto* lp = static_cast<const float*>(lse);
  const auto* rp = static_cast<const float*>(rowsum);
  auto* dhp = static_cast<float*>(dh);
  auto* dnp = static_cast<float*>(dnu);
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch_bwd<float>(gp, x, hp, np, dp, lp, rp, B, D, dhp, dnp, s);
      break;
    case 1:
      e = launch_bwd<int16_t>(gp, x, hp, np, dp, lp, rp, B, D, dhp, dnp, s);
      break;
    case 2:
      e = launch_bwd<int8_t>(gp, x, hp, np, dp, lp, rp, B, D, dhp, dnp, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
