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
//   * the digamma difference takes its column tile's regime (all counts
//     <= 7, all integer, or general), chosen from every valid count of the
//     tile's 64 columns over ALL B rows, as nb_value.cu's block and the
//     TPU's per-tile flags choose it (nbk::tile::tile_regime, shared with
//     K6).
// JOINT: mu = pe * depth + EPS with pe = p * exp(pb), exp(pb) once per
// column; dls uses pe, while K3's coupling term keeps the plain p, so
// gw = gout - fout stays right.  nu = clamp(exp(npre), 0, NU_HI) + EPS:
// no sigmoid, so rec = 1/(mu (mu+nu)) without the (1+e) factor, and
// dnupre = dnu * exp(npre) where exp(npre) < NU_HI (the lower clamp never
// binds).  The pb gradient row, colsum(dls), is the same sum as the
// colsum(dls) row and is written twice.
//
// VALUE adds the NLL without lgamma(x + 1): the lgamma difference in the
// tile's regime (lg_terms, as K6 computes it) plus
// x (log(mu + nu) - log mu) + nu (log(mu + nu) - log nu), where both log
// differences are taken as one log of a ratio from the shared reciprocal
// (the grad-only dln, and -log(mu / (mu + nu))).  Every gradient
// expression is the grad-only instance's (count_grad below), so the two
// write the same bits.
//
// What bounds it on the H100: operations, not bytes.  It reads 1 byte of
// int8 counts per element and does ~130 ALU operations, 2 exp, 2 log and
// 2 divides a count (more with VALUE; valgrad_roofline.OP_MIX counts them
// per line); the roofline probe P1 (mmvae_tpu_torch/benchmarks/
// valgrad_roofline.py) prices that op mix at ~15-20 us for the main
// path's 100 x 20,000 counts, against ~2 us for its bytes.
//
// Layout.  Stage 1 (valgrad_tiles): a block of kWarps = 4 warps owns one
// kTile = 64-column tile of D and one chunk of rows; the grid is (tiles,
// chunks).  Lane l owns the kLaneCols = 2 adjacent columns 2l, 2l + 1 of
// the tile (one 2-, 4- or 8-byte load of a row's counts where x and D
// allow it, element loads otherwise, the same values either way); warp w
// takes the chunk's rows w, w + 4, ... (nbk::tile, the layout K6 and K3
// share).  A thread keeps its columns' stacked W rows and their column
// sums in registers (the general instance keeps both in dynamic shared
// memory, sized by the runtime widths) and computes its 2 counts of a row
// as 2 independent chains.  Per row a lane adds its columns' row terms; a warp
// then sums the row's four outputs over its 64 columns at once (6
// shuffles).  The tile's regime is scanned first, over all B rows, in
// 16-byte loads.  Stage 2 (valgrad_sum, nbk::tile::tile_sums) adds, in fixed
// orders: the row partials, laid out (output, tile, row) so that
// neighbouring threads read neighbouring rows; the chunks' column
// partials, in chunk order; and the value partials.
//
// What the layout does about the earlier design (a block of 64 columns x
// 4 row groups over ALL B rows, one column a thread, reduce_parts as its
// second stage):
//   * too little work in flight: 313 blocks of 256 threads at 1-3 blocks
//     an SM, one dependent chain a thread, a 1.19-wave tail.  Now (tiles x
//     chunks) blocks of 128 threads at 7 an SM, 2 chains a thread: the
//     chunking (ops/nb_step.valgrad_plan, ceil(B / 20) <= 8 chunks) gives
//     313 x 5 = 1,565 blocks at the main path's B = 100, D = 20,000;
//   * runtime widths in unrolled loops: the instance the CLI defaults
//     launch, (R, C, Rn) = (2, 1, 1), has its widths at compile time, so
//     its loops carry no slot tests and it reads each row's zc and zn into
//     registers once.  The general instance takes runtime widths: W's
//     rows and the column sums in shared memory (1,280 bytes a stacked
//     row), so any R + C + Rn + 2 <= 181 (the card's 232,448 bytes a
//     block); the C entry checks the plan's instance against the shape;
//   * row sums by shuffles row by row: 4 trees of 5 shuffles per row and
//     32 columns before, 6 shuffles per row and 64 columns now;
//   * a slow, shared second stage: reduce_parts (one 128-thread block a
//     row, uncoalesced, K serial tree passes), which stays for K7 alone;
//     K2's own valgrad_sum reads coalesced and spreads its work.
// Variants measured on the H100 and dropped (PERF.md): 4 columns a
// thread (128-column tiles, 101-112 registers at 4 blocks an SM; stage 1
// took 1.6x this design's time), 4 or 8 blocks an SM, 8 warps a block.
//
// Bits.  Each count's terms are the earlier design's (the same
// expressions; the regime's tile is the same 64 columns over all B rows);
// only the order of the sums changed.  It depends on (B, D) alone: column
// sums add a thread's rows in order, the block's 4 warps in order, then
// the chunks in order (the chunking is a function of B); row sums add a
// lane's 2 columns in order, the warp's lanes by a fixed butterfly, then
// the tiles in a fixed order.  No atomics; bitwise repeatable; the same
// bits for int8, int16 and float32 storage of the same counts.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include <cstdint>

#include "nb_step_common.cuh"

namespace {

using namespace nbk;
using namespace nbk::tile;

// Blocks an SM each instance asks for.  The compile-time instances ask
// for 7 (<= 72 registers, 28 warps an SM): left at 4 they take 104-110
// registers and stage 1 ran 1.13x slower on the H100 at the main path's
// 5 row chunks (up to 1.36x at others); at 8 (64 registers) the
// grad-only ones spill.  The general instances (runtime widths, W and the
// column sums in shared memory) ask for 3.
template <bool FIXED>
constexpr int min_blocks() {
  return FIXED ? 7 : 3;
}

// Dynamic shared memory of a general instance: the tile's Tc weight rows
// (sw) and each warp's Tc column sums (sacc), a float a (row, column)
inline int64_t general_smem(int Tc) {
  return static_cast<int64_t>(1 + kWarps) * Tc * kTile * sizeof(float);
}

// One count's gradient terms (and with VALUE its NLL terms): the
// expressions of the earlier design, unchanged, shared by every instance.
template <bool JOINT, bool VALUE>
__device__ __forceinline__ void count_grad(float xv, float h, float lb,
                                           float dep, float epb, float npre,
                                           int regime, float& dls, float& dnp,
                                           float& vterm) {
  const float p = expf(h - lb);
  const float pe = JOINT ? p * epb : p;
  const float mu = pe * dep + kEps;
  // JOINT: sp = exp(npre); otherwise softplus and the sigmoid share one
  // exp(-|npre|)
  const float e = JOINT ? 0.f : expf(-fabsf(npre));
  const float sp = JOINT ? expf(npre) : fmaxf(npre, 0.f) + log1pf(e);
  const float nu = JOINT ? exp_nu(sp) : fminf(fmaxf(sp, kNuLo), kNuHi) + kEps;
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
    vterm = lg_terms<false>(regime, xv, nu) - xv * logf(mu * inv_mn) + nu * dln;
  if (JOINT)
    dnp = sp < kNuHi ? dnu * sp : 0.f;
  else
    dnp = (sp > kNuLo && sp < kNuHi) ? dnu * sig : 0.f;
}

// Stage 1.  FR, FC, FRn > 0: the widths at compile time (the instance the
// CLI defaults launch), W's columns, the row's latents and the column
// sums in registers; FR = 0: the general instance, R, C, Rn at run time,
// W's Tc columns and each warp's Tc column sums in dynamic shared memory
// (general_smem(Tc) bytes), any width that fits a block.  Writes the row
// partials parts (K, tiles, B), the column sums (straight to gout with one
// chunk, else to cparts (chunks, Tc, D)) and with VALUE one value partial
// a warp.
template <typename T, int FR, int FC, int FRn, bool JOINT, bool VALUE>
__global__ void __launch_bounds__(kBlockThreads, min_blocks<(FR > 0)>())
valgrad_tiles(const T* __restrict__ x, const float* __restrict__ zc,
              const float* __restrict__ zn, const float* __restrict__ depth,
              const float* __restrict__ lse, const float* __restrict__ W,
              int64_t B, int64_t D, int R_, int C_, int Rn_, int vec,
              int scan16,
              float* __restrict__ gout, float* __restrict__ parts,
              float* __restrict__ cparts, float* __restrict__ vparts) {
  constexpr bool kFixed = FR > 0;
  constexpr int NT = kFixed ? FR + FC + FRn + 2 : 1;  // stacked rows held
  const int R = kFixed ? FR : R_;
  const int C = kFixed ? FC : C_;
  const int Rn = kFixed ? FRn : Rn_;
  const int RC = R + C;
  const int base = RC + 1;
  const int Tc = RC + Rn + 2;  // gradient rows summed (pb's is a copy)
  const int K = 1 + R + Rn;    // per-row outputs [rsum | u1 | dzn]
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

  // the tile's W columns: registers (compile-time widths) or shared memory
  float w[NT][kLaneCols];
  if constexpr (kFixed) {
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        w[k][j] = c0 + j < D ? __ldg(W + k * D + c0 + j) : 0.f;
  } else {
    for (int i = threadIdx.x; i < Tc * kTile; i += kBlockThreads) {
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
    epb[j] = JOINT ? expf(c0 + j < D ? __ldg(W + Tc * D + c0 + j) : 0.f) : 1.f;

  const int regime = tile_regime<T>(x, B, D, tile, scan16 != 0);

  // the column sums over this warp's rows: registers with compile-time
  // widths, else this thread's own slots of gsacc
  float acc[NT][kLaneCols];
  auto accv = [&](int k, int j) -> float& {
    return gsacc[(warp * Tc + k) * kTile + lane * kLaneCols + j];
  };
  if constexpr (kFixed) {
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) acc[k][j] = 0.f;
  } else {
    for (int k = 0; k < Tc; ++k)
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) accv(k, j) = 0.f;
  }
  float val = 0.f;  // VALUE: this thread's NLL terms

  const int64_t r0 = chunk * B / chunks;
  const int64_t r1 = (chunk + 1) * B / chunks;
  for (int64_t b = r0 + warp; b < r1; b += kWarps) {
    const Counts<T> xc = load_counts<T>(x + b * D, c0, D, vec != 0);
    const float dep = __ldg(depth + b);
    const float lb = __ldg(lse + b);
    const float* zcr = zc + b * RC;
    const float* znr = zn + b * Rn;
    if constexpr (kFixed) {
      // this row's latents in registers
      float zr[NT], znv[NT];
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        zr[k] = k < RC ? __ldg(zcr + k) : 0.f;
        znv[k] = k < Rn ? __ldg(znr + k) : 0.f;
      }
      float rs[NT];  // [rsum | u1 | dzn] over this lane's columns
#pragma unroll
      for (int s = 0; s < NT; ++s) rs[s] = 0.f;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        const bool ok = c0 + j < D;
        const float xv = static_cast<float>(xc.v[j]);
        // h = bias2 + sum_k zc[k] W[k] and nu_pre = bias_n + sum_r zn[r]
        // wn[r], in the one order of nb_step_common.cuh (K1's normaliser
        // sees the same h bits)
        float h = 0.f, bias = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) {
          if (k < RC) h = fmaf(zr[k], w[k][j], h);
          if (k == RC) bias = w[k][j];
        }
        h = h + bias;
        float npre = 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k)
          if (k >= base && k < base + Rn)
            npre = fmaf(znv[k - base], w[k][j], npre);
        npre += w[base + Rn][j];
        float dls, dnp, vt = 0.f;
        count_grad<JOINT, VALUE>(xv, h, lb, dep, epb[j], npre, regime, dls,
                                 dnp, vt);
        dls = ok ? dls : 0.f;
        dnp = ok ? dnp : 0.f;
        if (VALUE) val += ok ? vt : 0.f;
#pragma unroll
        for (int k = 0; k < NT; ++k) {
          if (k < RC) acc[k][j] = fmaf(zr[k], dls, acc[k][j]);
          if (k == RC) acc[k][j] += dls;
          if (k >= base && k < base + Rn)
            acc[k][j] = fmaf(znv[k - base], dnp, acc[k][j]);
          if (k == base + Rn) acc[k][j] += dnp;
        }
        rs[0] += dls;
#pragma unroll
        for (int s = 1; s < NT; ++s) {
          if (s <= R) rs[s] = fmaf(dls, w[s - 1][j], rs[s]);
          if (s > R && s < K) rs[s] = fmaf(dnp, w[base + s - 1 - R][j], rs[s]);
        }
      }
      // the row's partials over the tile's kTile columns
      if constexpr (1 + FR + FRn == 4) {
        // four sums at once: the lanes trade halves of their four values
        // (lane ^ 16) and then halves of the two left (lane ^ 8), and add
        // the one left over the lanes of their group of 8; lane 8v holds
        // output v.  A fixed order, 6 shuffles in place of 20.
        const bool h16 = lane & 16, h8 = lane & 8;
        float k0 = h16 ? rs[2] : rs[0], k1 = h16 ? rs[3] : rs[1];
        k0 += __shfl_xor_sync(0xffffffffu, h16 ? rs[0] : rs[2], 16);
        k1 += __shfl_xor_sync(0xffffffffu, h16 ? rs[1] : rs[3], 16);
        float m = h8 ? k1 : k0;
        m += __shfl_xor_sync(0xffffffffu, h8 ? k0 : k1, 8);
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
          m += __shfl_xor_sync(0xffffffffu, m, off);
        if ((lane & 7) == 0) parts[((lane >> 3) * tiles + tile) * B + b] = m;
      } else {
        // lane s writes output s
        float mine = 0.f;
#pragma unroll
        for (int s = 0; s < NT; ++s) {
          if (s < K) {
            const float t = warp_sum(rs[s]);
            if (lane == s) mine = t;
          }
        }
        if (lane < K) parts[(lane * tiles + tile) * B + b] = mine;
      }
    } else {
      // runtime widths: each count's dls and dnp, then the row outputs
      float dls[kLaneCols], dnp[kLaneCols];
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        const bool ok = c0 + j < D;
        const float xv = static_cast<float>(xc.v[j]);
        // h and nu_pre in the one order of nb_step_common.cuh
        float h = 0.f;
        for (int k = 0; k < RC; ++k) h = fmaf(__ldg(zcr + k), wv(k, j), h);
        h = h + wv(RC, j);
        float npre = 0.f;
        for (int k = 0; k < Rn; ++k)
          npre = fmaf(__ldg(znr + k), wv(base + k, j), npre);
        npre += wv(base + Rn, j);
        float vt = 0.f;
        count_grad<JOINT, VALUE>(xv, h, lb, dep, epb[j], npre, regime,
                                 dls[j], dnp[j], vt);
        dls[j] = ok ? dls[j] : 0.f;
        dnp[j] = ok ? dnp[j] : 0.f;
        if (VALUE) val += ok ? vt : 0.f;
        for (int k = 0; k < RC; ++k)
          accv(k, j) = fmaf(__ldg(zcr + k), dls[j], accv(k, j));
        accv(RC, j) += dls[j];
        for (int k = 0; k < Rn; ++k)
          accv(base + k, j) = fmaf(__ldg(znr + k), dnp[j], accv(base + k, j));
        accv(base + Rn, j) += dnp[j];
      }
      // output s over this lane's columns (in column order), summed over
      // the warp; lane s mod 32 writes it
      for (int s = 0; s < K; ++s) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) {
          if (s == 0)
            v += dls[j];
          else if (s <= R)
            v = fmaf(dls[j], wv(s - 1, j), v);
          else
            v = fmaf(dnp[j], wv(base + s - 1 - R, j), v);
        }
        const float t = warp_sum(v);
        if (lane == (s & 31)) parts[(s * tiles + tile) * B + b] = t;
      }
    }
  }

  if (VALUE) {
    val = warp_sum(val);
    if (lane == 0) vparts[(chunk * tiles + tile) * kWarps + warp] = val;
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
    if (chunks == 1) {
      gout[k * D + c] = s;
      if (JOINT && k == RC) gout[Tc * D + c] = s;  // the pb row
    } else {
      cparts[(static_cast<int64_t>(chunk) * Tc + k) * D + c] = s;
    }
  }
}

// Stage 2 (nbk::tile::tile_sums): the row partials, the chunks' column
// partials (the pb row a copy of row R + C) and the value partials
__global__ void __launch_bounds__(kSumThreads)
valgrad_sum(const float* __restrict__ parts, const float* __restrict__ cparts,
            const float* __restrict__ vparts, int64_t B, int64_t D, int K,
            int64_t tiles, int Tc, int chunks, int pb_src, int64_t nvparts,
            int64_t row_blocks, int64_t col_blocks, float* __restrict__ rowout,
            float* __restrict__ gout, float* __restrict__ value) {
  tile_sums(parts, cparts, vparts, B, D, K, tiles, Tc, chunks, pb_src,
            nvparts, row_blocks, col_blocks, rowout, gout, value);
}

// The launch plan's workspace, in floats: row partials (K, tiles, B),
// column partials (chunks, Tc, D) when chunks > 1, value partials
// (chunks, tiles, kWarps) with VALUE.  ops/nb_step.valgrad_plan computes
// the same.
struct Workspace {
  int64_t rows, cols, vals;
  int64_t total() const { return rows + cols + vals; }
};

inline Workspace workspace(int64_t B, int64_t D, int R, int C, int Rn,
                           bool value, int chunks) {
  const int64_t tiles = tiles_of(D);
  return {(1 + R + Rn) * tiles * B,
          chunks > 1 ? static_cast<int64_t>(chunks) * (R + C + Rn + 2) * D : 0,
          value ? static_cast<int64_t>(chunks) * tiles * kWarps : 0};
}

// One call's stage-1 operands, on the host
struct Launch {
  const void* x;
  const float *zc, *zn, *depth, *lse, *W;
  int64_t B, D;
  int R, C, Rn, chunks, vec, scan16;
  float *gout, *parts, *cparts, *vparts;
};

template <typename T, bool FIXED, bool JOINT, bool VALUE>
cudaError_t launch_tiles(const Launch& L, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(tiles_of(L.D)),
                  static_cast<unsigned>(L.chunks));
  const auto kernel =
      valgrad_tiles<T, FIXED ? kFixR : 0, FIXED ? kFixC : 0,
                    FIXED ? kFixRn : 0, JOINT, VALUE>;
  const int64_t smem = FIXED ? 0 : general_smem(L.R + L.C + L.Rn + 2);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kBlockThreads, smem, s>>>(
      static_cast<const T*>(L.x), L.zc, L.zn, L.depth, L.lse, L.W, L.B, L.D,
      L.R, L.C, L.Rn, L.vec, L.scan16, L.gout, L.parts, L.cparts, L.vparts);
  return cudaGetLastError();
}

template <typename T, bool FIXED>
cudaError_t launch_variant(const Launch& L, bool joint, bool value,
                           cudaStream_t s) {
  if (joint && value) return launch_tiles<T, FIXED, true, true>(L, s);
  if (joint) return launch_tiles<T, FIXED, true, false>(L, s);
  if (value) return launch_tiles<T, FIXED, false, true>(L, s);
  return launch_tiles<T, FIXED, false, false>(L, s);
}

template <typename T>
cudaError_t launch_dtype(Launch L, bool joint, bool value, bool fixed,
                         cudaStream_t s) {
  L.vec = vec_loads<T>(L.x, L.D);
  L.scan16 = scan16_loads<T>(L.x, L.D);
  return fixed ? launch_variant<T, true>(L, joint, value, s)
               : launch_variant<T, false>(L, joint, value, s);
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8.  joint = 1 selects the pb /
// exp-nu variant, whose W and gout have the pb row last; need_value = 1
// also writes the NLL without lgamma(x + 1) to value (one float; unused
// otherwise).  The launch plan (ops/nb_step.valgrad_plan): fixed = 1 for
// the compile-time instance, which the entry picks by shape, (R, C, Rn) =
// (2, 1, 1), and refuses otherwise; tile = kTile; chunks row chunks,
// 1 <= chunks <= B; ws holds ws_floats >= the plan's workspace.  The
// general instance takes any widths whose general_smem(R + C + Rn + 2)
// fits a block (kMaxSmem: R + C + Rn + 2 <= 181).  Writes
// gout (R+C+Rn+2+joint, D) and rowout (B, 1 + R + Rn) = [rsum | u1 | dzn].
// Returns cudaGetLastError() after the two launches (0 = launched).
extern "C" int mmvae_nb_valgrad(const void* x, int dtype, const void* zc,
                                const void* zn, const void* depth,
                                const void* lse, const void* W, int64_t B,
                                int64_t D, int R, int C, int Rn, int joint,
                                int need_value, int fixed, int tile,
                                int chunks, void* gout, void* ws,
                                int64_t ws_floats, void* rowout, void* value,
                                void* stream) {
  if (!dims_ok(B, D, R, C, Rn) || (joint != 0 && joint != 1) ||
      (need_value != 0 && need_value != 1) ||
      fixed != (fixed_widths(R, C, Rn) ? 1 : 0) || tile != kTile ||
      chunks < 1 || chunks > B || chunks > kMaxChunks || ws == nullptr ||
      general_smem(R + C + Rn + 2) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool jt = joint != 0;
  const bool nv = need_value != 0;
  const Workspace plan = workspace(B, D, R, C, Rn, nv, chunks);
  if (ws_floats < plan.total()) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* gp = static_cast<float*>(gout);
  auto* parts = static_cast<float*>(ws);
  auto* cparts = parts + plan.rows;
  auto* vparts = cparts + plan.cols;
  const Launch L{x, static_cast<const float*>(zc),
                 static_cast<const float*>(zn),
                 static_cast<const float*>(depth),
                 static_cast<const float*>(lse), static_cast<const float*>(W),
                 B, D, R, C, Rn, chunks, 0, 0, gp, parts, cparts, vparts};
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch_dtype<float>(L, jt, nv, fixed != 0, s);
      break;
    case 1:
      e = launch_dtype<int16_t>(L, jt, nv, fixed != 0, s);
      break;
    case 2:
      e = launch_dtype<int8_t>(L, jt, nv, fixed != 0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int K = 1 + R + Rn;
  const int Tc = R + C + Rn + 2;
  const int64_t row_blocks = (K * B + 31) / 32;
  const int64_t col_blocks =
      chunks > 1 ? (Tc * D + kSumThreads - 1) / kSumThreads : 0;
  const int64_t blocks = row_blocks + col_blocks + (nv ? 1 : 0);
  valgrad_sum<<<static_cast<unsigned>(blocks), kSumThreads, 0, s>>>(
      parts, cparts, vparts, B, D, K, tiles_of(D), Tc, chunks,
      jt ? R + C : -1, plan.vals, row_blocks, col_blocks,
      static_cast<float*>(rowout), gp, static_cast<float*>(value));
  return static_cast<int>(cudaGetLastError());
}
