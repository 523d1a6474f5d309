// Shared device code of the fused NB step kernels (nb_lse.cu, nb_value.cu,
// nb_valgrad.cu, nb_finish.cu) and of K7 / K8 (nb_elbo.cu): the in-kernel
// logits' order, the lgamma / digamma regimes, the regime scan, and the
// tile layout and second stage of K2, K6 and K3 (K7's too).
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
// The logits.  Every kernel forms h = bias2 + sum_k zc[k] W[k] in ONE
// order: FMAs over k ascending from 0, starting at 0.f, then + bias2
// (compute_h4 below for K1's compile-time instance, the same loop written
// out in K1's wide instance and in K6, K2 and K3), so K1's normaliser and
// K6 / K2 / K3's softmax see the same bits of h at every width.  The
// overdispersion pre-activation nu_pre = bias_n + sum_r zn[r] wn[r] is
// formed the same way (FMAs over r ascending, then + bias_n).
//
// Widths.  The compile-time instances ((R, C, Rn) = (2, 1, 1), every CLI
// default) keep their stacked rows in registers; the general ones take
// any width.  K2's and K3's keep the tile's weights and column sums in
// dynamic shared memory, a slot a row, so the card's 232,448 bytes a
// block (kMaxSmem) are their only limit; K6's keeps the weights alone
// there, and K1's walks its rows in slices (ops/nb_step.py's plans state
// each limit).
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

// the roofline probe's block (roofline_probe.cu): K2's earlier layout,
// kTileCols columns x kRowGroups row groups
constexpr int kTileCols = 64;
constexpr int kRowGroups = 4;
constexpr int kThreads = kTileCols * kRowGroups;
// shared memory an H100 block can have (opt-in past 48 KB)
constexpr int kMaxSmem = 232448;

// lgamma / digamma regime of a block's tile (all its valid counts)
enum Regime : int { kFast = 0, kMixed = 1, kGeneral = 2 };

inline int64_t num_tiles(int64_t D) { return (D + kTileCols - 1) / kTileCols; }

template <typename T>
__device__ __forceinline__ float load_count(const T* p) {
  return static_cast<float>(*p);
}

// The logits of 4 adjacent columns whose stacked weight rows sit in
// shared memory (row k at w + k * ld, 16-byte aligned) and whose row
// latents z[0..RC) sit in registers (nb_lse.cu's compile-time instance):
// FMAs over k ascending from 0, then + bias, the one order of h (top of
// this file), which every other kernel's loop over k must keep.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The joint variant's overdispersion decode: nu = clamp(exp(npre), 0,
// NU_HI) + EPS (vmfnb.hh:488-493), against the NB model's softplus-clip.
__device__ __forceinline__ float exp_nu(float sp) {
  return fminf(sp, kNuHi) + kEps;
}

// checks shared by the C entry points of K6, K2 and K3 (K3 passes
// Rn = 1: it reads no overdispersion rows); the shared-memory limit of a
// general instance is checked by its entry
inline bool dims_ok(int64_t B, int64_t D, int R, int C, int Rn) {
  return B >= 1 && D >= 1 && R >= 1 && C >= 0 && Rn >= 1 &&
         num_tiles(D) <= 0x7fffffff && B <= 0x7fffffff;
}

// ----------------------------------------------------------------------
// The tile layout of K2 (nb_valgrad.cu), K6 (nb_value.cu) and K3
// (nb_finish.cu).  Stage 1: a block of kWarps = 4 warps owns one kTile =
// 64-column tile of D and one chunk of rows (grid (tiles, chunks), the
// chunking from the wrapper's plan); lane l owns the kLaneCols = 2
// adjacent columns 2l, 2l + 1 of the tile, warp w takes the chunk's rows
// w, w + 4, ...  Stage 2 (tile_sums) adds the partials in fixed orders.
// ----------------------------------------------------------------------
namespace tile {

constexpr int kLaneCols = 2;                  // adjacent columns a thread owns
constexpr int kWarps = 4;                     // row groups of a block
constexpr int kBlockThreads = 32 * kWarps;
constexpr int kTile = 32 * kLaneCols;         // columns of D a block owns
constexpr int kScanBytes = 16;                // a regime-scan load
constexpr int kSumThreads = 256;
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kMaxChunks = 65535;             // gridDim.y
// the compile-time instances: the widths every CLI default launches
constexpr int kFixR = 2, kFixC = 1, kFixRn = 1;

inline bool fixed_widths(int R, int C, int Rn) {
  return R == kFixR && C == kFixC && Rn == kFixRn;
}

inline int64_t tiles_of(int64_t D) { return (D + kTile - 1) / kTile; }

// A thread's kLaneCols adjacent counts of one row, one vector load wide
template <typename T>
struct alignas(kLaneCols * sizeof(T)) Counts {
  T v[kLaneCols];
};

// Counts c0 .. c0 + kLaneCols - 1 of the row at xr (0 past D): one vector
// load when vec (D a multiple of kLaneCols and x aligned to it), element
// loads otherwise; the same values either way.
template <typename T>
__device__ __forceinline__ Counts<T> load_counts(const T* __restrict__ xr,
                                                 int64_t c0, int64_t D,
                                                 bool vec) {
  Counts<T> c;
  if (vec) {
    if (c0 < D) return *reinterpret_cast<const Counts<T>*>(xr + c0);
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) c.v[j] = T(0);
    return c;
  }
#pragma unroll
  for (int j = 0; j < kLaneCols; ++j) c.v[j] = c0 + j < D ? xr[c0 + j] : T(0);
  return c;
}

// The regime of the counts a thread scanned: fast = every count an
// integer in [0, 7], allint = every count a non-negative integer, as the
// TPU's _fast_flag / _int_flag test a tile.  Integer storage ORs the
// counts' bits (a byte or half-word passes iff the OR of every such one
// at its place does), float32 tests each count.
template <typename T>
struct RegimeScan {
  uint32_t bits = 0u;
  bool fast = true, allint = true;

  __device__ __forceinline__ void add(T v) {
    if constexpr (sizeof(T) == 1) {
      bits |= static_cast<uint8_t>(v);
    } else if constexpr (sizeof(T) == 2) {
      bits |= static_cast<uint16_t>(v);
    } else {
      const bool integral = v == floorf(v);
      fast &= v >= 0.f && v <= kXMaxFast && integral;
      allint &= v >= 0.f && integral;
    }
  }
  __device__ __forceinline__ void add(uint4 w) {  // 16 bytes of counts
    if constexpr (sizeof(T) < 4) {
      bits |= w.x | w.y | w.z | w.w;
    } else {
      add(__uint_as_float(w.x));
      add(__uint_as_float(w.y));
      add(__uint_as_float(w.z));
      add(__uint_as_float(w.w));
    }
  }
  __device__ __forceinline__ bool all_fast() const {
    if constexpr (sizeof(T) == 1) return (bits & 0xF8F8F8F8u) == 0u;
    if constexpr (sizeof(T) == 2) return (bits & 0xFFF8FFF8u) == 0u;
    return fast;
  }
  __device__ __forceinline__ bool all_int() const {
    if constexpr (sizeof(T) == 1) return (bits & 0x80808080u) == 0u;
    if constexpr (sizeof(T) == 2) return (bits & 0x80008000u) == 0u;
    return allint;
  }
};

// The regime of a block's tile: every count of its kTile columns over all
// B rows (not only the block's chunk), so every block of a tile, and K6
// and K2 alike, choose one regime for a count.  16-byte loads where
// scan16 (D a multiple of 16 / sizeof(T) and x 16-byte aligned), element
// loads otherwise.  Called by every thread of the block (it synchronises).
template <typename T>
__device__ __forceinline__ int tile_regime(const T* __restrict__ x, int64_t B,
                                           int64_t D, int64_t tile,
                                           bool scan16) {
  RegimeScan<T> scan;
  const int t = threadIdx.x;
  if (scan16) {
    constexpr int kGroups = kTile * static_cast<int>(sizeof(T)) / kScanBytes;
    constexpr int kPer = kScanBytes / static_cast<int>(sizeof(T));
    const int64_t c = tile * kTile + (t % kGroups) * kPer;
    if (c < D)
      for (int64_t b = t / kGroups; b < B; b += kBlockThreads / kGroups)
        scan.add(__ldg(reinterpret_cast<const uint4*>(x + b * D + c)));
  } else {
    const int64_t c = tile * kTile + t % kTile;
    if (c < D)
      for (int64_t b = t / kTile; b < B; b += kBlockThreads / kTile)
        scan.add(x[b * D + c]);
  }
  const int fast = __syncthreads_and(scan.all_fast());
  const int allint = __syncthreads_and(scan.all_int());
  return fast ? kFast : (allint ? kMixed : kGeneral);
}

// vec: a row's kLaneCols counts of a thread in one load (D a multiple of
// kLaneCols, x aligned to it); scan16: the regime scan in 16-byte loads
template <typename T>
inline bool vec_loads(const void* x, int64_t D) {
  return D % kLaneCols == 0 &&
         reinterpret_cast<uintptr_t>(x) % (kLaneCols * sizeof(T)) == 0;
}
template <typename T>
inline bool scan16_loads(const void* x, int64_t D) {
  return D % (kScanBytes / sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(x) % kScanBytes == 0;
}

// Stage 2, one launch of three kinds of block (each kernel's own
// __global__ calls it, so the profiler names the kernel):
//   row blocks: 32 (row, output) sums each, lane = output o = k * B + b;
//     warp w adds tiles w, w + 8, ... of parts (K, tiles, B) in order,
//     then the 8 warps in order;
//   column blocks (chunks > 1): one (row k, column) sum a thread of
//     cparts (chunks, Tc, D), the chunks in order; a pb row (pb_src >= 0)
//     written again as the copy of row pb_src;
//   one value block (nvparts > 0): thread t adds partials t, t + 256, ...,
//     then a fixed tree.
__device__ __forceinline__ void tile_sums(
    const float* __restrict__ parts, const float* __restrict__ cparts,
    const float* __restrict__ vparts, int64_t B, int64_t D, int K,
    int64_t tiles, int Tc, int chunks, int pb_src, int64_t nvparts,
    int64_t row_blocks, int64_t col_blocks, float* __restrict__ rowout,
    float* __restrict__ gout, float* __restrict__ value) {
  __shared__ float red[kSumThreads];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int64_t blk = blockIdx.x;
  if (blk < row_blocks) {
    const int64_t o = blk * 32 + lane;
    const bool ok = o < K * B;
    const int64_t k = ok ? o / B : 0;
    const int64_t b = ok ? o - k * B : 0;
    float s = 0.f;
    if (ok)
      for (int64_t p = warp; p < tiles; p += kSumWarps)
        s += parts[(k * tiles + p) * B + b];
    red[t] = s;
    __syncthreads();
    if (warp == 0 && ok) {
      float r = red[lane];
#pragma unroll
      for (int g = 1; g < kSumWarps; ++g) r += red[g * 32 + lane];
      rowout[b * K + k] = r;
    }
    return;
  }
  blk -= row_blocks;
  if (blk < col_blocks) {
    const int64_t i = blk * kSumThreads + t;
    if (i < Tc * D) {
      float s = cparts[i];
      for (int ch = 1; ch < chunks; ++ch) s += cparts[ch * Tc * D + i];
      gout[i] = s;
      if (i / D == pb_src) gout[Tc * D + (i - pb_src * D)] = s;
    }
    return;
  }
  float s = 0.f;
  for (int64_t j = t; j < nvparts; j += kSumThreads) s += vparts[j];
  red[t] = s;
  __syncthreads();
  for (int g = kSumThreads / 2; g > 0; g >>= 1) {
    if (t < g) red[t] += red[t + g];
    __syncthreads();
  }
  if (t == 0) *value = red[0];
}

// Opt a general instance into `bytes` of dynamic shared memory (past the
// default 48 KB a launch needs it); 0 = done
template <typename K>
inline cudaError_t allow_smem(K kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tile

}  // namespace nbk
