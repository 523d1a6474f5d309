// K7 and K8 for Hopper (sm_90a): the v1 fused NB ELBO data term over
// materialized decoder logits h and overdispersion pre-activations nu_pre
//
//     ls  = h - lse,  lse = logsumexp(h) over the row,  p = exp(ls)
//     mu  = p * depth + EPS
//     nu  = clip(softplus(nu_pre), NU_LO, NU_HI) + EPS
//     nll = sum_{b,d} lgamma(nu) - lgamma(nu + x) [+ lgamma(x + 1)]
//                     + x (log(mu + nu) - log mu) + nu (log(mu + nu) - log nu)
//
// K7 (mmvae_nb_elbo_fwd, CONST adds lgamma(x + 1)) replaces the Pallas TPU
// kernel mmvae_tpu/ops/nb_elbo.py: _make_fwd_kernel / _fwd_call.  The TPU
// kernel walks D tiles twice in grid order (phase 0: an online max / sum of
// exp in VMEM scratch; phase 1: the terms) and carries per-row sums from
// tile to tile.  Per row it writes lse, rowsum(dls) with dls = dmu * p *
// depth, rowsum(dmu * p) (the depth gradient) and the row's NLL; the scalar
// is the rows' NLLs added in a fixed order.
//
// K8 (mmvae_nb_elbo_bwd) replaces _bwd_kernel / _bwd_call: an elementwise
// map over (B, D) that recomputes the activations from the saved (B, 1)
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
// What bounds them on the H100.  K7 reads x, h and nu_pre once (18 MB at
// B = 100, D = 20,000 in int8: 5.4 us at 3.35 TB/s) and executes ~72
// ALU operations, 3 exp, 4 log and a divide a count (K7c 90 and 2
// divides; benchmarks/valgrad_roofline.OP_MIX): the instruction rate,
// not bytes, once h is read once.  K8 reads the same and writes dh and
// dnu (34 MB, 10.2 us) with ~92 ALU operations, 2 exp, 2 log and 2
// divides a count: about as much instruction time as bytes.
//
// K7's layout: a thread-block CLUSTER per row (elbo_fwd_rows).  The row
// is cut into `cluster` slices of `slice` columns (ops/nb_elbo.elbo_plan:
// 8 blocks of ~2,500 columns at D = 20,000, 800 blocks at B = 100; 8
// beat 1, 2, 4 and 16 blocks a row on the H100, PERF.md §6); a
// block of 256 threads owns one slice, thread t its columns t, t + 256, ...
// (quads of 4 adjacent columns a thread with 16-byte loads ran 4-7%
// slower: more registers, fewer columns in flight):
//   pass 0: each block reads its slice of h, nu_pre and x once into shared
//     memory (12 bytes a column; the ON-CHIP instance), the block's max,
//     then its sum of exp(h - max), and the regime of its counts
//     (RegimeScan over the widened counts, so integer-valued float32
//     counts take the regime int8 and int16 take);
//   the cluster trades the blocks' (max, sum-exp) pairs through
//     distributed shared memory; every block merges them in rank order, so
//     all of them hold the same lse bits;
//   pass 1: the terms and the two row sums from shared memory, the
//     block's partials added in a fixed order and stored into rank 0's
//     shared memory, which adds them in rank order and writes the row.
// A slice past the shared memory a block has (D > 154,112) takes the
// RE-READ instance: the same passes read h, nu_pre and x from global
// memory (L2) again.  A second launch (elbo_fwd_sum) adds the B row NLLs
// in a fixed order.
//
// K7's arithmetic: the count regimes of K6 (nbk::lg_terms) by the block's
// counts: all integers <= 7 (select-products, one log), all integers (the
// products saturated at 7 factors plus a Stirling correction), otherwise
// the shift-into-Stirling lgamma_pos; ONE divide gives 1/(mu + nu) and
// 1/mu, and each log difference is one log of a ratio.
//
// K8's layout (elbo_bwd_groups): a thread owns 4 adjacent columns of a
// row, one 16-byte load of h and of nu_pre, one 4-, 8- or 16-byte load of
// the counts and 16-byte stores of dh and dnu (element loads where D or an
// operand's alignment does not allow it); grid (ceil(D / 1024), B).  The
// digamma difference takes the regime of the warp's 128 counts (a vote):
// integer counts use nbk::dg_term's select-products; the general regime
// takes each digamma_pos's eight shift reciprocals as one quotient dP / P
// (P = prod (z + k) < 2.6e8 for z < 8, times w = z + 8 < 16 in the same
// divide).  One shared divide gives 1/(mu + nu), 1/mu and the sigmoid's
// 1/(1 + e) (K2's count_grad); dP / P is kept out of it (P grows like
// nu^7 and the product would overflow float32).
//
// Bits.  Every sum has an order fixed by (B, D) and the plan: a thread's
// columns in order, the warp's butterfly, the warps in order, the
// cluster's ranks in order, the rows in order.  A row's outputs depend on
// that row's data alone; the regime of a count on its block's (K7) or
// warp's (K8) counts, fixed by the shape.  No atomics; bitwise
// repeatable; the same bits for int8, int16 and float32 storage of the
// same integer counts.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include <cooperative_groups.h>

#include "nb_step_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace nbk;

constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kSliceAlign = 32;    // a slice is whole warps of columns
constexpr int kColBytes = 12;      // h, nu_pre and the widened count
// a slice's shared memory at most: a block's, less 1 KB for the static
constexpr int kSliceSmem = kMaxSmem - 1024;
constexpr int kBwdThreads = 256;
constexpr int kBwdCols = 4;        // adjacent columns a K8 thread owns (quads)
constexpr int kBwdBlockCols = kBwdThreads * kBwdCols;

// The block's sum (MAX: max) of v in a fixed order: the warp's butterfly
// (every lane ends with the same bits), then the warps in index order.
// Every thread gets the result; red holds kFwdWarps floats.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kFwdWarps; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is free again
  return r;
}

// One count's NLL terms and dmu * p (K7)
template <bool CONST>
__device__ __forceinline__ void count_terms(float xv, float hv, float lse,
                                            float dep, float np, int regime,
                                            float& term, float& dmu_p) {
  const float p = expf(hv - lse);
  const float mu = p * dep + kEps;
  const float sp = fmaxf(np, 0.f) + log1pf(expf(-fabsf(np)));
  const float nu = fminf(fmaxf(sp, kNuLo), kNuHi) + kEps;
  // the one divide: 1/(mu + nu) and 1/mu
  const float mn = mu + nu;
  const float rec = 1.f / (mu * mn);
  const float inv_mn = rec * mu;
  const float inv_mu = rec * mn;
  const float t = (xv + nu) * inv_mn;
  dmu_p = (t - xv * inv_mu) * p;
  term = lg_terms<CONST>(regime, xv, nu) - xv * logf(mu * inv_mn) -
         nu * logf(nu * inv_mn);
}

// K7's stage 1: one cluster of `cluster` blocks a row (grid cluster * B),
// block rank r owns columns [r * slice, min((r + 1) * slice, D)), thread
// t its columns r * slice + t, + 256, ...  ONCHIP: the slice's h, nu_pre
// and widened counts in dynamic shared memory (3 * slice floats);
// otherwise re-read from global memory.
// rows (4, B): [lse | rowsum(dls) | rowsum(dmu p) | row NLL].
template <typename T, bool CONST, bool ONCHIP>
__global__ void __launch_bounds__(kFwdThreads, 4)
elbo_fwd_rows(const T* __restrict__ x, const float* __restrict__ h,
              const float* __restrict__ nu_pre,
              const float* __restrict__ depth, int64_t B, int64_t D,
              int64_t slice, float* __restrict__ rows) {
  extern __shared__ __align__(16) float sbuf[];  // ONCHIP: h | nu_pre | x
  __shared__ float red[kFwdWarps];
  __shared__ float pair[2];                 // this block's (max, sum exp)
  __shared__ float acc[kMaxCluster][2];     // rank 0: each block's sums
  __shared__ float s_lse;
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x / ncl;
  const int64_t lo = rank * slice;
  const int64_t hi = lo + slice < D ? lo + slice : D;
  const float* hr = h + b * D;
  const float* nr = nu_pre + b * D;
  const T* xr = x + b * D;
  float* sh = sbuf;
  float* sn = sbuf + slice;
  float* sx = sbuf + 2 * slice;

  // pass 0: the slice in, its max and the regime of its counts
  float m = -INFINITY;
  tile::RegimeScan<float> scan;
  for (int64_t c = lo + t; c < hi; c += kFwdThreads) {
    const float v = __ldg(hr + c);
    const float xv = load_count(xr + c);
    m = fmaxf(m, v);
    scan.add(xv);
    if (ONCHIP) {
      sh[c - lo] = v;
      sn[c - lo] = __ldg(nr + c);
      sx[c - lo] = xv;
    }
  }
  m = block_reduce<true>(m, red);
  float s = 0.f;
  if (m != -INFINITY)
    for (int64_t c = lo + t; c < hi; c += kFwdThreads)
      s += expf((ONCHIP ? sh[c - lo] : __ldg(hr + c)) - m);
  s = block_reduce<false>(s, red);
  const int regime = __syncthreads_and(scan.all_fast())
                         ? kFast
                         : (__syncthreads_and(scan.all_int()) ? kMixed
                                                              : kGeneral);

  // the cluster's (max, sum exp) pairs, merged in rank order by warp 0
  if (t == 0) {
    pair[0] = m;
    pair[1] = s;
  }
  cluster.sync();
  if (t < 32) {
    float mr = -INFINITY, sr = 0.f;
    if (t < ncl) {
      const float* pr = cluster.map_shared_rank(&pair[0], t);
      mr = pr[0];
      sr = pr[1];
    }
    float mm = mr;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    const float e = mr == -INFINITY ? 0.f : sr * expf(mr - mm);
    float tot = 0.f;
    for (int r = 0; r < ncl; ++r) tot += __shfl_sync(0xffffffffu, e, r);
    if (t == 0) s_lse = mm + logf(tot);
  }
  __syncthreads();
  const float lse = s_lse;

  // pass 1: the terms and the row sums
  const float dep = __ldg(depth + b);
  float nll = 0.f, dd = 0.f;
  for (int64_t c = lo + t; c < hi; c += kFwdThreads) {
    const int64_t i = c - lo;
    const float xv = ONCHIP ? sx[i] : load_count(xr + c);
    const float hv = ONCHIP ? sh[i] : __ldg(hr + c);
    const float np = ONCHIP ? sn[i] : __ldg(nr + c);
    float term, dmu_p;
    count_terms<CONST>(xv, hv, lse, dep, np, regime, term, dmu_p);
    nll += term;
    dd += dmu_p;
  }
  nll = block_reduce<false>(nll, red);
  dd = block_reduce<false>(dd, red);
  if (t == 0) {
    float* dst = cluster.map_shared_rank(&acc[0][0], 0);
    dst[2 * rank] = nll;
    dst[2 * rank + 1] = dd;
  }
  cluster.sync();  // also keeps every block's pair alive until all read it
  if (rank == 0 && t == 0) {
    float n = acc[0][0], d = acc[0][1];
    for (int r = 1; r < ncl; ++r) {
      n += acc[r][0];
      d += acc[r][1];
    }
    rows[b] = lse;
    rows[B + b] = d * dep;
    rows[2 * B + b] = d;
    rows[3 * B + b] = n;
  }
}

// K7's stage 2: the B row NLLs added in a fixed order (tile_sums' value
// block: thread t adds rows t, t + 256, ..., then a fixed tree)
__global__ void __launch_bounds__(tile::kSumThreads)
elbo_fwd_sum(const float* __restrict__ row_nll, int64_t B,
             float* __restrict__ out) {
  tile::tile_sums(nullptr, nullptr, row_nll, 0, 0, 0, 0, 0, 1, -1, B, 0, 0,
                  nullptr, nullptr, out);
}

// digamma(z) for z > 0 by the shift-by-8 scheme with the eight shift
// reciprocals sum 1/(z + k) = dP / P, P = prod_{k<8} (z + k), and
// Stirling's 1/w from ONE divide r = 1/(P w): P w < 2.6e8 * 16 for z < 8.
__device__ __forceinline__ float digamma_q(float z) {
  float P = 1.f, dP = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float m = z + static_cast<float>(k);
    dP = fmaf(dP, m, P);
    P *= m;
  }
  const bool shift = z < 8.f;
  P = shift ? P : 1.f;
  dP = shift ? dP : 0.f;
  const float w = shift ? z + 8.f : z;
  const float r = 1.f / (P * w);
  const float iw = P * r;
  const float iw2 = iw * iw;
  return logf(w) - 0.5f * iw -
         iw2 * (1.f / 12.f - iw2 * (1.f / 120.f - iw2 * (1.f / 252.f))) -
         dP * (w * r);
}

// One count's dh and dnu (K8): K2's count_grad, NB instance
__device__ __forceinline__ void count_bwd(float xv, float hv, float lse,
                                          float dep, float rsum, float np,
                                          int regime, float gv, float& dh,
                                          float& dnu) {
  const float p = expf(hv - lse);
  const float mu = p * dep + kEps;
  const float e = expf(-fabsf(np));
  const float sp = fmaxf(np, 0.f) + log1pf(e);
  const float nu = fminf(fmaxf(sp, kNuLo), kNuHi) + kEps;
  const float dg = regime == kGeneral ? digamma_q(nu) - digamma_q(nu + xv)
                                      : dg_term(regime, xv, nu);
  // the one shared divide: 1/(mu + nu), 1/mu and the sigmoid's 1/(1 + e)
  const float mn = mu + nu;
  const float v = mu * mn;
  const float u = 1.f + e;
  float rec = 1.f / (u * v);
  const float r = rec * v;
  const float sig = np >= 0.f ? r : e * r;
  rec = rec * u;
  const float inv_mn = rec * mu;
  const float inv_mu = rec * mn;
  const float t = (xv + nu) * inv_mn;
  const float dmu = t - xv * inv_mu;
  dh = gv * (dmu * p * dep - p * rsum);
  const float d = dg + t - logf(nu * inv_mn) - 1.f;
  dnu = (sp > kNuLo && sp < kNuHi) ? gv * d * sig : 0.f;
}

// 4 adjacent counts, one vector load wide
template <typename T>
struct alignas(4 * sizeof(T)) Counts4 {
  T v[4];
};

// K8: grid (ceil(D / kBwdBlockCols), B); a thread owns columns c0 .. c0 +
// kBwdCols - 1 of row blockIdx.y, in quads.  VEC: D a multiple of
// kBwdCols and every operand aligned to its quad's width.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdThreads, 4)
elbo_bwd_groups(const float* __restrict__ g, const T* __restrict__ x,
                const float* __restrict__ h, const float* __restrict__ nu_pre,
                const float* __restrict__ depth, const float* __restrict__ lse,
                const float* __restrict__ rowsum, int64_t D,
                float* __restrict__ dh, float* __restrict__ dnu) {
  const int64_t b = blockIdx.y;
  const int64_t c0 =
      (static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x) *
      kBwdCols;
  const int64_t i0 = b * D + c0;
  float xv[kBwdCols], hv[kBwdCols], nv[kBwdCols];
  if (VEC) {
#pragma unroll
    for (int q = 0; q < kBwdCols; q += 4) {
      if (c0 < D) {
        const Counts4<T> xc =
            *reinterpret_cast<const Counts4<T>*>(x + i0 + q);
        const float4 h4 = __ldg(reinterpret_cast<const float4*>(h + i0 + q));
        const float4 n4 =
            __ldg(reinterpret_cast<const float4*>(nu_pre + i0 + q));
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[q + j] = static_cast<float>(xc.v[j]);
        hv[q] = h4.x, hv[q + 1] = h4.y, hv[q + 2] = h4.z, hv[q + 3] = h4.w;
        nv[q] = n4.x, nv[q + 1] = n4.y, nv[q + 2] = n4.z, nv[q + 3] = n4.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[q + j] = hv[q + j] = nv[q + j] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBwdCols; ++j) {
      const bool ok = c0 + j < D;
      xv[j] = ok ? load_count(x + i0 + j) : 0.f;
      hv[j] = ok ? __ldg(h + i0 + j) : 0.f;
      nv[j] = ok ? __ldg(nu_pre + i0 + j) : 0.f;
    }
  }
  // the regime of the warp's counts (past D: 0, which every regime takes)
  tile::RegimeScan<float> scan;
#pragma unroll
  for (int j = 0; j < kBwdCols; ++j) scan.add(xv[j]);
  const int regime = __all_sync(0xffffffffu, scan.all_fast())
                         ? kFast
                         : (__all_sync(0xffffffffu, scan.all_int()) ? kMixed
                                                                   : kGeneral);
  const float gv = __ldg(g);
  const float dep = __ldg(depth + b);
  const float lb = __ldg(lse + b);
  const float rs = __ldg(rowsum + b);
  float oh[kBwdCols], on[kBwdCols];
#pragma unroll
  for (int j = 0; j < kBwdCols; ++j)
    count_bwd(xv[j], hv[j], lb, dep, rs, nv[j], regime, gv, oh[j], on[j]);
  if (VEC) {
    if (c0 < D)
#pragma unroll
      for (int q = 0; q < kBwdCols; q += 4) {
        *reinterpret_cast<float4*>(dh + i0 + q) =
            make_float4(oh[q], oh[q + 1], oh[q + 2], oh[q + 3]);
        *reinterpret_cast<float4*>(dnu + i0 + q) =
            make_float4(on[q], on[q + 1], on[q + 2], on[q + 3]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < kBwdCols; ++j)
      if (c0 + j < D) {
        dh[i0 + j] = oh[j];
        dnu[i0 + j] = on[j];
      }
  }
}

// the plan (ops/nb_elbo.elbo_plan) checked: a power-of-two cluster of at
// most kMaxCluster blocks, each owning a non-empty slice of whole warps
// of columns, the slices covering D; the instance follows from the slice
inline bool fwd_plan_ok(int64_t D, int cluster, int threads, int64_t slice,
                        int onchip) {
  return threads == kFwdThreads && cluster >= 1 && cluster <= kMaxCluster &&
         (cluster & (cluster - 1)) == 0 && slice >= 1 &&
         slice % kSliceAlign == 0 && slice * cluster >= D &&
         slice * (cluster - 1) < D &&
         onchip == (slice * kColBytes <= kSliceSmem ? 1 : 0);
}

inline bool elbo_dims_ok(int64_t B, int64_t D) {
  return B >= 1 && D >= 1 && B <= 65535 &&
         (D + kBwdBlockCols - 1) / kBwdBlockCols <= 0x7fffffff;
}

template <typename T, bool CONST, bool ONCHIP>
cudaError_t launch_rows(const void* x, const float* h, const float* nu_pre,
                        const float* depth, int64_t B, int64_t D,
                        int cluster, int64_t slice, float* rows,
                        cudaStream_t s) {
  const auto kernel = elbo_fwd_rows<T, CONST, ONCHIP>;
  const int64_t smem = ONCHIP ? slice * kColBytes : 0;
  cudaError_t e = tile::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster * B));
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), h, nu_pre,
                         depth, B, D, slice, rows);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* h, const float* nu_pre,
                       const float* depth, int64_t B, int64_t D,
                       bool with_const, int cluster, int64_t slice,
                       bool onchip, float* rows, float* out, cudaStream_t s) {
  cudaError_t e;
  if (with_const)
    e = onchip ? launch_rows<T, true, true>(x, h, nu_pre, depth, B, D,
                                            cluster, slice, rows, s)
               : launch_rows<T, true, false>(x, h, nu_pre, depth, B, D,
                                             cluster, slice, rows, s);
  else
    e = onchip ? launch_rows<T, false, true>(x, h, nu_pre, depth, B, D,
                                             cluster, slice, rows, s)
               : launch_rows<T, false, false>(x, h, nu_pre, depth, B, D,
                                              cluster, slice, rows, s);
  if (e != cudaSuccess) return e;
  elbo_fwd_sum<<<1, tile::kSumThreads, 0, s>>>(rows + 3 * B, B, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const float* g, const void* x, const float* h,
                       const float* nu_pre, const float* depth,
                       const float* lse, const float* rowsum, int64_t B,
                       int64_t D, float* dh, float* dnu, cudaStream_t s) {
  const auto al = [](const void* p, size_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const bool vec = D % kBwdCols == 0 && al(x, 4 * sizeof(T)) &&
                   al(h, 16) && al(nu_pre, 16) && al(dh, 16) && al(dnu, 16);
  const dim3 grid(static_cast<unsigned>((D + kBwdBlockCols - 1) /
                                        kBwdBlockCols),
                  static_cast<unsigned>(B));
  const T* xp = static_cast<const T*>(x);
  if (vec)
    elbo_bwd_groups<T, true><<<grid, kBwdThreads, 0, s>>>(
        g, xp, h, nu_pre, depth, lse, rowsum, D, dh, dnu);
  else
    elbo_bwd_groups<T, false><<<grid, kBwdThreads, 0, s>>>(
        g, xp, h, nu_pre, depth, lse, rowsum, D, dh, dnu);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8.  x, h, nu_pre (B, D); depth
// (B, 1).  The plan (ops/nb_elbo.elbo_plan): cluster blocks a row of
// threads each, slice columns a block, onchip = 1 for the instance that
// holds the slice in shared memory (exactly when slice * 12 bytes fit
// kSliceSmem).  ws (ws_floats >= 4 B) receives the rows (4, B): [lse |
// rowsum(dls) | rowsum(dmu p) | row NLL]; out one float, the NLL.  Returns
// cudaGetLastError() after the two launches (0 = launched).
extern "C" int mmvae_nb_elbo_fwd(const void* x, int dtype, const void* h,
                                 const void* nu_pre, const void* depth,
                                 int64_t B, int64_t D, int with_const,
                                 int cluster, int threads, int64_t slice,
                                 int onchip, void* ws, int64_t ws_floats,
                                 void* out, void* stream) {
  if (!elbo_dims_ok(B, D) || !fwd_plan_ok(D, cluster, threads, slice, onchip) ||
      ws == nullptr || ws_floats < 4 * B)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* hp = static_cast<const float*>(h);
  const auto* np = static_cast<const float*>(nu_pre);
  const auto* dp = static_cast<const float*>(depth);
  auto* rp = static_cast<float*>(ws);
  auto* op = static_cast<float*>(out);
  const bool wc = with_const != 0;
  const bool oc = onchip != 0;
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch_fwd<float>(x, hp, np, dp, B, D, wc, cluster, slice, oc, rp,
                            op, s);
      break;
    case 1:
      e = launch_fwd<int16_t>(x, hp, np, dp, B, D, wc, cluster, slice, oc, rp,
                              op, s);
      break;
    case 2:
      e = launch_fwd<int8_t>(x, hp, np, dp, B, D, wc, cluster, slice, oc, rp,
                             op, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// g: the scalar cotangent (one float in device memory).  block_cols: the
// plan's columns a K8 block (kBwdBlockCols).  Writes dh and dnu (B, D).
// Returns cudaGetLastError() after the launch.
extern "C" int mmvae_nb_elbo_bwd(const void* g, const void* x, int dtype,
                                 const void* h, const void* nu_pre,
                                 const void* depth, const void* lse,
                                 const void* rowsum, int64_t B, int64_t D,
                                 int block_cols, void* dh, void* dnu,
                                 void* stream) {
  if (!elbo_dims_ok(B, D) || block_cols != kBwdBlockCols)
    return static_cast<int>(cudaErrorInvalidValue);
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
