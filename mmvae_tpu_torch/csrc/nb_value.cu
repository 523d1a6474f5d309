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
// lgamma.  The tile is 64 columns over all B rows (nbk::tile::tile_regime,
// K2's scan), so the choice is uniform per block and costs no divergence.
//
// What bounds it on the H100: operations, not bytes.  One read of x (2 MB
// of int8 at B = 100, D = 20,000) against ~80 operations a count: the
// logits, one exp, softplus (exp, log1p), three logs and the regime's
// lgamma work (the joint variant decodes nu with one exp in place of exp
// and log1p); chip_smoke.OPS_PER_ELEMENT and valgrad_roofline.OP_MIX count
// them.
//
// Layout: K2's (nb_valgrad.cu, nbk::tile).  Stage 1 (value_tiles): a block
// of 4 warps owns one 64-column tile of D and one chunk of rows, grid
// (tiles, chunks) with the chunking of ops/nb_step.value_plan (ceil(B /
// 20) <= 8 chunks: 313 x 5 = 1,565 blocks at the main path's B = 100,
// D = 20,000); lane l owns columns 2l, 2l + 1 (one 2-, 4- or 8-byte load
// of a row's counts where x and D allow it), two independent chains; warp
// w takes the chunk's rows w, w + 4, ...  The compile-time instance
// ((R, C, Rn) = (2, 1, 1), every CLI default) keeps its W columns and the
// row's latents in registers; the general one keeps W's R + C + Rn + 2
// rows in dynamic shared memory (256 bytes a row, so any width up to 908
// rows) and reads the latents from L1.  Each warp sums its terms into one
// partial; stage 2 (value_sum, nbk::tile::tile_sums' value block) adds the
// partials in a fixed order.
//
// What the layout does about the earlier design (a block of 64 columns x
// 4 row groups over ALL B rows, one column a thread, block_regime
// scanning every row before any work, runtime widths in loops unrolled to
// 8 or 16 slots, and reduce_parts adding 2,504 partials from one block):
// 5x the blocks at 7 an SM and 2 chains a thread; widths at compile time
// on the main path; the regime in 16-byte loads; a second stage of 256
// threads.
//
// Bits.  Each count's term is the earlier design's expression in the same
// regime; the order of the sums depends on (B, D) alone (a thread's rows
// in order, its 2 columns in order, the warp's butterfly, then stage 2's
// fixed order).  No atomics; bitwise repeatable; the same bits for int8,
// int16 and float32 storage of the same counts.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include <cstdint>

#include "nb_step_common.cuh"

namespace {

using namespace nbk;
using namespace nbk::tile;

// Blocks an SM each instance asks for: the compile-time instances 7
// (<= 72 registers, as K2's), the general ones 4.
template <bool FIXED>
constexpr int min_blocks() {
  return FIXED ? 7 : 4;
}

// Dynamic shared memory of a general instance: the tile's weight rows
// (R + C + Rn + 2 of them; pb's exp is taken from W directly)
inline int64_t general_smem(int Tw) {
  return static_cast<int64_t>(Tw) * kTile * sizeof(float);
}

// One count's NLL terms: the earlier design's expressions
template <bool CONST, bool JOINT>
__device__ __forceinline__ float count_value(float xv, float h, float lb,
                                             float dep, float epb, float npre,
                                             int regime) {
  float p = expf(h - lb);
  if (JOINT) p *= epb;
  const float mu = p * dep + kEps;
  float nu;
  if (JOINT) {
    nu = exp_nu(expf(npre));
  } else {
    const float sp = fmaxf(npre, 0.f) + log1pf(expf(-fabsf(npre)));
    nu = fminf(fmaxf(sp, kNuLo), kNuHi) + kEps;
  }
  const float denom = logf(mu + nu);
  return lg_terms<CONST>(regime, xv, nu) + xv * (denom - logf(mu)) +
         nu * (denom - logf(nu));
}

// Stage 1.  FR, FC, FRn > 0: the widths at compile time; FR = 0: the
// general instance (runtime widths, W's rows in dynamic shared memory).
// Writes one value partial a warp: vparts (chunks, tiles, kWarps).
template <typename T, int FR, int FC, int FRn, bool CONST, bool JOINT>
__global__ void __launch_bounds__(kBlockThreads, min_blocks<(FR > 0)>())
value_tiles(const T* __restrict__ x, const float* __restrict__ zc,
            const float* __restrict__ zn, const float* __restrict__ depth,
            const float* __restrict__ lse, const float* __restrict__ W,
            int64_t B, int64_t D, int R_, int C_, int Rn_, int vec, int scan16,
            float* __restrict__ vparts) {
  constexpr bool kFixed = FR > 0;
  constexpr int NT = kFixed ? FR + FC + FRn + 2 : 1;  // stacked rows held
  const int R = kFixed ? FR : R_;
  const int C = kFixed ? FC : C_;
  const int Rn = kFixed ? FRn : Rn_;
  const int RC = R + C;
  const int base = RC + 1;
  const int Tw = RC + Rn + 2;  // rows of W besides pb
  extern __shared__ __align__(16) float sw[];  // general: (Tw, kTile)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t tiles = gridDim.x;
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  const int64_t c0 = tile * kTile + lane * kLaneCols;

  float w[NT][kLaneCols];
  if constexpr (kFixed) {
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        w[k][j] = c0 + j < D ? __ldg(W + k * D + c0 + j) : 0.f;
  } else {
    for (int i = threadIdx.x; i < Tw * kTile; i += kBlockThreads) {
      const int64_t c = tile * kTile + (i % kTile);
      sw[i] = c < D ? __ldg(W + (i / kTile) * D + c) : 0.f;
    }
  }
  auto wv = [&](int k, int j) -> float {
    return sw[k * kTile + lane * kLaneCols + j];
  };
  float epb[kLaneCols];
#pragma unroll
  for (int j = 0; j < kLaneCols; ++j)
    epb[j] = JOINT ? expf(c0 + j < D ? __ldg(W + Tw * D + c0 + j) : 0.f) : 1.f;

  // also the barrier after the general instance's weight rows
  const int regime = tile_regime<T>(x, B, D, tile, scan16 != 0);

  float val = 0.f;
  const int64_t r0 = chunk * B / chunks;
  const int64_t r1 = (chunk + 1) * B / chunks;
  for (int64_t b = r0 + warp; b < r1; b += kWarps) {
    const Counts<T> xc = load_counts<T>(x + b * D, c0, D, vec != 0);
    const float dep = __ldg(depth + b);
    const float lb = __ldg(lse + b);
    const float* zcr = zc + b * RC;
    const float* znr = zn + b * Rn;
    float zr[NT], znv[NT];  // the row's latents (compile-time widths)
    if constexpr (kFixed) {
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        zr[k] = k < RC ? __ldg(zcr + k) : 0.f;
        znv[k] = k < Rn ? __ldg(znr + k) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
      // h and nu_pre in the one order of nb_step_common.cuh
      float h = 0.f, npre = 0.f;
      if constexpr (kFixed) {
#pragma unroll
        for (int k = 0; k < RC; ++k) h = fmaf(zr[k], w[k][j], h);
        h = h + w[RC][j];
#pragma unroll
        for (int k = 0; k < Rn; ++k) npre = fmaf(znv[k], w[base + k][j], npre);
        npre += w[base + Rn][j];
      } else {
        for (int k = 0; k < RC; ++k) h = fmaf(__ldg(zcr + k), wv(k, j), h);
        h = h + wv(RC, j);
        for (int k = 0; k < Rn; ++k)
          npre = fmaf(__ldg(znr + k), wv(base + k, j), npre);
        npre += wv(base + Rn, j);
      }
      const float vt = count_value<CONST, JOINT>(
          static_cast<float>(xc.v[j]), h, lb, dep, epb[j], npre, regime);
      val += c0 + j < D ? vt : 0.f;
    }
  }
  val = warp_sum(val);
  if (lane == 0) vparts[(chunk * tiles + tile) * kWarps + warp] = val;
}

// Stage 2: tile_sums' value block over the stage-1 partials
__global__ void __launch_bounds__(kSumThreads)
value_sum(const float* __restrict__ vparts, int64_t nvparts,
          float* __restrict__ value) {
  tile_sums(nullptr, nullptr, vparts, 0, 0, 0, 0, 0, 1, -1, nvparts, 0, 0,
            nullptr, nullptr, value);
}

// One call's stage-1 operands, on the host
struct Launch {
  const void* x;
  const float *zc, *zn, *depth, *lse, *W;
  int64_t B, D;
  int R, C, Rn, chunks, vec, scan16;
  float* vparts;
};

template <typename T, bool FIXED, bool CONST, bool JOINT>
cudaError_t launch_tiles(const Launch& L, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(tiles_of(L.D)),
                  static_cast<unsigned>(L.chunks));
  const auto kernel = value_tiles<T, FIXED ? kFixR : 0, FIXED ? kFixC : 0,
                                  FIXED ? kFixRn : 0, CONST, JOINT>;
  const int64_t smem = FIXED ? 0 : general_smem(L.R + L.C + L.Rn + 2);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kBlockThreads, smem, s>>>(
      static_cast<const T*>(L.x), L.zc, L.zn, L.depth, L.lse, L.W, L.B, L.D,
      L.R, L.C, L.Rn, L.vec, L.scan16, L.vparts);
  return cudaGetLastError();
}

template <typename T, bool FIXED>
cudaError_t launch_variant(const Launch& L, bool with_const, bool joint,
                           cudaStream_t s) {
  if (with_const && joint) return launch_tiles<T, FIXED, true, true>(L, s);
  if (with_const) return launch_tiles<T, FIXED, true, false>(L, s);
  if (joint) return launch_tiles<T, FIXED, false, true>(L, s);
  return launch_tiles<T, FIXED, false, false>(L, s);
}

template <typename T>
cudaError_t launch_dtype(Launch L, bool with_const, bool joint, bool fixed,
                         cudaStream_t s) {
  L.vec = vec_loads<T>(L.x, L.D);
  L.scan16 = scan16_loads<T>(L.x, L.D);
  return fixed ? launch_variant<T, true>(L, with_const, joint, s)
               : launch_variant<T, false>(L, with_const, joint, s);
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8.  x (B, D), zc (B, R+C),
// zn (B, Rn), depth (B, 1), lse (B, 1), W (R+C+Rn+2+joint, D); joint = 1
// selects the pb / exp-nu variant.  The launch plan
// (ops/nb_step.value_plan): fixed = 1 exactly when (R, C, Rn) = (2, 1, 1);
// tile = kTile; chunks row chunks, 1 <= chunks <= B; ws holds ws_floats
// >= chunks * tiles * kWarps partials.  The general instance takes any
// widths whose R + C + Rn + 2 weight rows fit a block's shared memory
// (kMaxSmem: <= 908 rows).  out is one float.  Returns cudaGetLastError()
// after the two launches (0 = launched).
extern "C" int mmvae_nb_value(const void* x, int dtype, const void* zc,
                              const void* zn, const void* depth,
                              const void* lse, const void* W, int64_t B,
                              int64_t D, int R, int C, int Rn, int with_const,
                              int joint, int fixed, int tile, int chunks,
                              void* ws, int64_t ws_floats, void* out,
                              void* stream) {
  if (!dims_ok(B, D, R, C, Rn) || (joint != 0 && joint != 1) ||
      fixed != (fixed_widths(R, C, Rn) ? 1 : 0) || tile != kTile ||
      chunks < 1 || chunks > B || chunks > kMaxChunks || ws == nullptr ||
      general_smem(R + C + Rn + 2) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nvparts = static_cast<int64_t>(chunks) * tiles_of(D) * kWarps;
  if (ws_floats < nvparts) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* vparts = static_cast<float*>(ws);
  const Launch L{x, static_cast<const float*>(zc),
                 static_cast<const float*>(zn),
                 static_cast<const float*>(depth),
                 static_cast<const float*>(lse), static_cast<const float*>(W),
                 B, D, R, C, Rn, chunks, 0, 0, vparts};
  const bool wc = with_const != 0;
  const bool jt = joint != 0;
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch_dtype<float>(L, wc, jt, fixed != 0, s);
      break;
    case 1:
      e = launch_dtype<int16_t>(L, wc, jt, fixed != 0, s);
      break;
    case 2:
      e = launch_dtype<int8_t>(L, wc, jt, fixed != 0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  value_sum<<<1, kSumThreads, 0, s>>>(vparts, nvparts,
                                      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
