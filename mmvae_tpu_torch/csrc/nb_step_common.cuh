// Shared device code of the fused NB step kernels (nb_lse.cu, nb_value.cu,
// nb_valgrad.cu, nb_finish.cu): the launch layout of K6 and K3, the
// in-kernel logits, the lgamma / digamma regimes and the deterministic
// second stage.
//
// Port of the in-kernel pieces of mmvae_tpu/ops/nb_step.py (_compute_h,
// _compute_nupre, _fast_flag, _int_flag, _fast_products, _mixed_lgdg) and
// of mmvae_tpu/ops/nb_elbo.py (_stirling_lgamma, _lgamma_pos,
// _stirling_digamma, _digamma_pos).  All arithmetic is float32; the
// JAX kernels' bf16 MXU products are a TPU artifact and are not copied.
//
// Operands (all row-major, contiguous):
//   x     (B, D)      counts, int8 / int16 / float32, widened in registers
//   zc    (B, R+C)    [z_mu | covariates]
//   zn    (B, Rn)     z_nu
//   depth (B, 1), lse (B, 1), rsum (B, 1)
//   W     (T, D)      stacked rows [wd (R) | wc (C) | bias2 | wn (Rn) |
//                     bias_n], T = R + C + Rn + 2; the joint vMF+NB
//                     model's variant (JOINT) appends the post-softmax
//                     log-bias row pb, T = R + C + Rn + 3
//
// Layout shared by the column-tile kernels.  The TPU kernels walk D tiles
// in grid order and carry per-row sums in VMEM scratch; here a block owns
// kTileCols columns of D and ALL B rows, so every per-column sum (the
// weight-gradient rows) is finished inside the block.  The block's
// threads are kTileCols columns x kRowGroups row groups: row group g
// takes rows g, g + kRowGroups, ...  A warp is 32 columns of one row
// group; per-row sums over D are reduced across the warp by shuffles and
// written as one partial per (warp column, tile), and a second kernel
// (reduce_parts) adds the partials of each row in a fixed order.  No
// atomics, so every output is bitwise repeatable.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace nbk {

constexpr float kEps = 1e-4f;
constexpr float kNuLo = 1e-4f;
constexpr float kNuHi = 1e4f;
constexpr float kXMaxFast = 7.0f;  // select-product regime: counts 0..7
constexpr float kHalfLog2Pi = 0.9189385332046727f;

constexpr int kTileCols = 64;                  // columns of D per block
constexpr int kRowGroups = 4;                  // row groups per block
constexpr int kThreads = kTileCols * kRowGroups;
constexpr int kWarpCols = kTileCols / 32;      // warps across a row group
constexpr int kMaxT = 16;                      // stacked rows the kernels take
constexpr int kReduceThreads = 128;

// lgamma / digamma regime of a block's tile (all its valid counts)
enum Regime : int { kFast = 0, kMixed = 1, kGeneral = 2 };

inline int64_t num_tiles(int64_t D) { return (D + kTileCols - 1) / kTileCols; }
// partials per row: one per warp column of each tile
inline int64_t num_parts(int64_t D) { return num_tiles(D) * kWarpCols; }

template <typename T>
__device__ __forceinline__ float load_count(const T* p) {
  return static_cast<float>(*p);
}

// h = bias2 + sum_k zc[k] * W[k]: the logits of one (row, column), in one
// fixed order in every kernel, so K1's normaliser and K6 / K2 / K3's
// softmax see the same bits.
template <int NT>
__device__ __forceinline__ float compute_h(const float* __restrict__ zc_row,
                                           const float (&w)[NT], int RC) {
  float h = 0.f, bias = 0.f;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (k < RC) h = fmaf(__ldg(zc_row + k), w[k], h);
    if (k == RC) bias = w[k];
  }
  return h + bias;
}

// compute_h's arithmetic for 4 adjacent columns whose stacked weight rows
// sit in shared memory (row k at w + k * ld, 16-byte aligned) and whose
// row latents z[0..RC) sit in registers (nb_lse.cu): FMAs over k ascending
// from 0, then + bias, so every column's h has compute_h's bits.  The two
// must stay in step.
template <int NZ>
__device__ __forceinline__ float4 compute_h4(const float (&z)[NZ],
                                             const float* w, int ld, int RC) {
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < NZ; ++k) {
    if (k < RC) {
      const float4 wk = *reinterpret_cast<const float4*>(w + k * ld);
      h.x = fmaf(z[k], wk.x, h.x);
      h.y = fmaf(z[k], wk.y, h.y);
      h.z = fmaf(z[k], wk.z, h.z);
      h.w = fmaf(z[k], wk.w, h.w);
    }
  }
  const float4 b = *reinterpret_cast<const float4*>(w + RC * ld);
  return make_float4(h.x + b.x, h.y + b.y, h.z + b.z, h.w + b.w);
}

// overdispersion pre-activation: bias_n + sum_r zn[r] * wn[r]
template <int NT>
__device__ __forceinline__ float compute_nupre(const float* __restrict__ zn_row,
                                               const float (&w)[NT], int base,
                                               int Rn) {
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < NT; ++k)
    if (k >= base && k < base + Rn) v = fmaf(__ldg(zn_row + (k - base)), w[k], v);
#pragma unroll
  for (int k = 0; k < NT; ++k)
    if (k == base + Rn) v += w[k];
  return v;
}

// the block's W column in registers (zeros past the ragged D edge)
template <int NT>
__device__ __forceinline__ void load_wcol(const float* __restrict__ W, int64_t D,
                                          int64_t c, bool valid, int T,
                                          float (&w)[NT]) {
#pragma unroll
  for (int k = 0; k < NT; ++k) w[k] = (valid && k < T) ? W[k * D + c] : 0.f;
}

__device__ __forceinline__ float stirling_lgamma(float w) {
  const float iw = 1.f / w;
  const float iw2 = iw * iw;
  const float corr =
      iw * (1.f / 12.f - iw2 * (1.f / 360.f - iw2 * (1.f / 1260.f)));
  return (w - 0.5f) * logf(w) - w + kHalfLog2Pi + corr;
}

__device__ __forceinline__ float lgamma_pos(float z) {
  if (z < 8.f) {
    const float prod = z * (z + 1.f) * (z + 2.f) * (z + 3.f) * (z + 4.f) *
                       (z + 5.f) * (z + 6.f) * (z + 7.f);
    return stirling_lgamma(z + 8.f) - logf(prod);
  }
  return stirling_lgamma(z);
}

__device__ __forceinline__ float stirling_digamma(float w) {
  const float iw = 1.f / w;
  const float iw2 = iw * iw;
  return logf(w) - 0.5f * iw -
         iw2 * (1.f / 12.f - iw2 * (1.f / 120.f - iw2 * (1.f / 252.f)));
}

__device__ __forceinline__ float digamma_pos(float z) {
  if (z < 8.f) {
    const float recips = 1.f / z + 1.f / (z + 1.f) + 1.f / (z + 2.f) +
                         1.f / (z + 3.f) + 1.f / (z + 4.f) + 1.f / (z + 5.f) +
                         1.f / (z + 6.f) + 1.f / (z + 7.f);
    return stirling_digamma(z + 8.f) - recips;
  }
  return stirling_digamma(z);
}

// Select-products for integer x (saturating at 7 factors):
//   P  = prod_{k<min(x,7)} (nu + k)   lgamma(nu) - lgamma(nu + x) = -log P
//   dP = dP / dnu                      digamma difference = -dP / P
//   Pc = min(x,7)!                     lgamma(x + 1) = log Pc
template <bool DG, bool CONST>
__device__ __forceinline__ void fast_products(float x, float nu, float& P,
                                              float& dP, float& Pc) {
  P = 1.f;
  dP = 0.f;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const bool sel = x > static_cast<float>(k);
    const float m = nu + static_cast<float>(k);
    if (DG) dP = sel ? fmaf(dP, m, P) : dP;
    P = sel ? P * m : P;
  }
  Pc = 1.f;
  if (CONST) {
#pragma unroll
    for (int k = 2; k <= 7; ++k)
      Pc = x >= static_cast<float>(k) ? Pc * static_cast<float>(k) : Pc;
  }
}

// lgamma(nu) - lgamma(nu + x) [+ lgamma(x + 1) when CONST], by regime
template <bool CONST>
__device__ __forceinline__ float lg_terms(int regime, float x, float nu) {
  float P, dP, Pc;
  if (regime == kFast) {
    fast_products<false, CONST>(x, nu, P, dP, Pc);
    return CONST ? logf(Pc / P) : -logf(P);
  }
  if (regime == kMixed) {
    fast_products<false, CONST>(x, nu, P, dP, Pc);
    const bool small = x <= kXMaxFast;
    float lg = -logf(P);
    if (!small)
      lg += stirling_lgamma(nu + 7.f) - stirling_lgamma(fmaxf(nu + x, 8.f));
    if (CONST)
      lg += small ? logf(Pc) : stirling_lgamma(fmaxf(x, 8.f) + 1.f);
    return lg;
  }
  float lg = lgamma_pos(nu) - lgamma_pos(nu + x);
  if (CONST) lg += lgamma_pos(x + 1.f);
  return lg;
}

// digamma(nu) - digamma(nu + x), by regime
__device__ __forceinline__ float dg_term(int regime, float x, float nu) {
  if (regime == kGeneral) return digamma_pos(nu) - digamma_pos(nu + x);
  float P, dP, Pc;
  fast_products<true, false>(x, nu, P, dP, Pc);
  float dg = -dP / P;
  if (regime == kMixed && x > kXMaxFast)
    dg += stirling_digamma(nu + 7.f) - stirling_digamma(fmaxf(nu + x, 8.f));
  return dg;
}

// The block's regime: every valid count of its tile (all B rows x its
// kTileCols columns) decides, as _fast_flag / _int_flag decide for a TPU
// tile.  Called by every thread of the block (it synchronises).
template <typename T>
__device__ __forceinline__ int block_regime(const T* __restrict__ x, int64_t B,
                                            int64_t D, int64_t c, bool valid,
                                            int row0) {
  int fast = 1, allint = 1;
  if (valid) {
    for (int64_t b = row0; b < B; b += kRowGroups) {
      const float v = load_count(x + b * D + c);
      const bool integral = std::is_integral<T>::value || v == floorf(v);
      fast &= (v >= 0.f && v <= kXMaxFast && integral) ? 1 : 0;
      allint &= (v >= 0.f && integral) ? 1 : 0;
    }
  }
  fast = __syncthreads_and(fast);
  allint = __syncthreads_and(allint);
  return fast ? kFast : (allint ? kMixed : kGeneral);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Second stage: out[b * ldo + k] = sum_j parts[(j * B + b) * K + k] for
// j < nparts, one block per row b.  Thread t adds parts t, t + 128, ... in
// order, then a fixed tree adds the threads: the same bits every run.
static __global__ void __launch_bounds__(kReduceThreads)
reduce_parts(const float* __restrict__ parts, int64_t nparts, int64_t B, int K,
             float* __restrict__ out, int64_t ldo) {
  __shared__ float red[kReduceThreads];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int64_t j = t; j < nparts; j += kReduceThreads)
      s += parts[(j * B + b) * K + k];
    red[t] = s;
    __syncthreads();
    for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
      if (t < w) red[t] += red[t + w];
      __syncthreads();
    }
    if (t == 0) out[b * ldo + k] = red[0];
    __syncthreads();
  }
}

static inline cudaError_t launch_reduce(const float* parts, int64_t nparts, int64_t B,
                                 int K, float* out, int64_t ldo,
                                 cudaStream_t s) {
  reduce_parts<<<static_cast<unsigned>(B), kReduceThreads, 0, s>>>(
      parts, nparts, B, K, out, ldo);
  return cudaGetLastError();
}

// The joint variant's overdispersion decode: nu = clamp(exp(npre), 0,
// NU_HI) + EPS (vmfnb.hh:488-493), against the NB model's softplus-clip.
__device__ __forceinline__ float exp_nu(float sp) {
  return fminf(sp, kNuHi) + kEps;
}

// exp(pb) of the block's column, once per thread: row pbi of the W
// column in registers (1 when the variant has no pb row)
template <int NT>
__device__ __forceinline__ float exp_pb(const float (&w)[NT], int pbi) {
  float e = 1.f;
#pragma unroll
  for (int k = 0; k < NT; ++k)
    if (k == pbi) e = expf(w[k]);
  return e;
}

// checks shared by the C entry points; extra = 1 for the pb row
inline bool dims_ok(int64_t B, int64_t D, int R, int C, int Rn,
                    int extra = 0) {
  return B >= 1 && D >= 1 && R >= 1 && C >= 0 && Rn >= 1 &&
         R + C + Rn + 2 + extra <= kMaxT && num_tiles(D) <= 0x7fffffff &&
         B <= 0x7fffffff;
}

}  // namespace nbk
