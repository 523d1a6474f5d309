// K5 for Hopper (sm_90a): the weight gradient of the fused count encoder
//
//     dWL = g1^T @ log1p(x)      (r1, D)
//     dWX = g2^T @ float(x)      (r2, D)
//
// for integer (int8 / int16) or float32 counts x (B, D) and float32 row
// cotangents g1 (B, r1), g2 (B, r2).
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/enc_kernel.py:
// _make_bwd_kernel / _bwd_call.  Every output is a column sum over the B
// rows, so a block owns 64 columns of D and all B rows (4 row groups of
// 64 threads; rows g, g + 4, ... per group) and needs no cross-block sum:
// the row groups are added through shared memory in a fixed order, and
// the result is bitwise repeatable.  log1p of integer counts below 256 is
// the same table lookup as in the forward kernel (count_encode.cu), so the
// forward and backward see the same bits of log1p(x).
//
// What bounds it on the H100: one read of x (2 MB of int8 at B = 100,
// D = 20000) and r1 + r2 FMAs per count; far below the tensor cores' ridge
// point, so plain FMAs.  With ~300 blocks of 256 threads and ~25 rows per
// thread, memory latency of the row loop is what it waits on.
//
// Build: see mmvae_tpu_torch/ops/_cuda.py.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kTileCols = 64;
constexpr int kRowGroups = 4;
constexpr int kThreads = kTileCols * kRowGroups;
constexpr int kMaxW = 16;  // r1 + r2 per launch
constexpr int kLut = 256;

template <typename T>
__device__ __forceinline__ float log1p_count(T v, const float* lut) {
  if constexpr (std::is_integral<T>::value) {
    const int i = static_cast<int>(v);
    return (i >= 0 && i < kLut) ? lut[i] : log1pf(static_cast<float>(v));
  } else {
    return log1pf(v);
  }
}

template <typename T, int NW>
__global__ void __launch_bounds__(kThreads)
count_encode_bwd_kernel(const T* __restrict__ x, int64_t B, int64_t D,
                        const float* __restrict__ g1, int r1, int64_t ld1,
                        const float* __restrict__ g2, int r2, int64_t ld2,
                        float* __restrict__ dWL, float* __restrict__ dWX) {
  __shared__ float lut[kLut];
  __shared__ float sacc[kRowGroups][NW][kTileCols];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileCols + tx;
  for (int i = tid; i < kLut; i += kThreads) lut[i] = log1pf(static_cast<float>(i));
  __syncthreads();

  const int64_t c = static_cast<int64_t>(blockIdx.x) * kTileCols + tx;
  const bool valid = c < D;
  const int nw = r1 + r2;
  float acc[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) acc[k] = 0.f;
  if (valid) {
#pragma unroll 4
    for (int64_t b = ty; b < B; b += kRowGroups) {
      const T v = x[b * D + c];
      const float xf = static_cast<float>(v);
      const float lx = log1p_count(v, lut);
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (k < r1)
          acc[k] = fmaf(__ldg(g1 + b * ld1 + k), lx, acc[k]);
        else if (k < nw)
          acc[k] = fmaf(__ldg(g2 + b * ld2 + (k - r1)), xf, acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NW; ++k) sacc[ty][k][tx] = acc[k];
  __syncthreads();
  if (ty == 0 && valid) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      if (k < nw) {
        float s = sacc[0][k][tx];
#pragma unroll
        for (int g = 1; g < kRowGroups; ++g) s += sacc[g][k][tx];
        if (k < r1)
          dWL[k * D + c] = s;
        else
          dWX[(k - r1) * D + c] = s;
      }
    }
  }
}

template <typename T, int NW>
void launch(const void* x, int64_t B, int64_t D, const void* g1, int r1,
            int64_t ld1, const void* g2, int r2, int64_t ld2, void* dWL,
            void* dWX, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((D + kTileCols - 1) / kTileCols));
  const dim3 block(kTileCols, kRowGroups);
  count_encode_bwd_kernel<T, NW><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), B, D, static_cast<const float*>(g1), r1, ld1,
      static_cast<const float*>(g2), r2, ld2, static_cast<float*>(dWL),
      static_cast<float*>(dWX));
}

template <typename T>
void launch_rows(const void* x, int64_t B, int64_t D, const void* g1, int r1,
                 int64_t ld1, const void* g2, int r2, int64_t ld2, void* dWL,
                 void* dWX, cudaStream_t s) {
  const int nw = r1 + r2;
  if (nw <= 2)
    launch<T, 2>(x, B, D, g1, r1, ld1, g2, r2, ld2, dWL, dWX, s);
  else if (nw <= 4)
    launch<T, 4>(x, B, D, g1, r1, ld1, g2, r2, ld2, dWL, dWX, s);
  else if (nw <= 8)
    launch<T, 8>(x, B, D, g1, r1, ld1, g2, r2, ld2, dWL, dWX, s);
  else
    launch<T, kMaxW>(x, B, D, g1, r1, ld1, g2, r2, ld2, dWL, dWX, s);
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8.  g1 / g2 point at the first
// cotangent column of this launch's row group (row strides ld1 / ld2);
// dWL / dWX at its first output row (row stride D).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int mmvae_count_encode_bwd(const void* x, int dtype, int64_t B,
                                      int64_t D, const void* g1, int r1,
                                      int64_t ld1, const void* g2, int r2,
                                      int64_t ld2, void* dWL, void* dWX,
                                      void* stream) {
  if (r1 < 0 || r2 < 0 || r1 + r2 < 1 || r1 + r2 > kMaxW || B < 0 || D < 1 ||
      (D + kTileCols - 1) / kTileCols > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_rows<float>(x, B, D, g1, r1, ld1, g2, r2, ld2, dWL, dWX, s);
      break;
    case 1:
      launch_rows<int16_t>(x, B, D, g1, r1, ld1, g2, r2, ld2, dWL, dWX, s);
      break;
    case 2:
      launch_rows<int8_t>(x, B, D, g1, r1, ld1, g2, r2, ld2, dWL, dWX, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
