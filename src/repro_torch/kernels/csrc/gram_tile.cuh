// One 128 x 128 output tile of A B^T, an fp32 FFMA product over k written by
// hand (no cuBLAS), added into `out`.
//
// Shared by the streamed Gram (rff_gram_stream_fused.cu: K2/K3 and K5/K6,
// the products of a chunk's cos/sin slabs) and the centered Gram
// (centered_gram.cu: K8, Sigma with its row mean subtracted).  The template
// flag `kCentered` selects the loads:
//   false: A, B rows hold K contiguous floats, K a multiple of 8 and rows
//          16-byte aligned (the workspace slabs): float4 loads, no mask;
//   true:  rows of any length K (the ragged sample count n): scalar loads,
//          k >= K masked to 0, and mu[row] subtracted as the tile is loaded,
//          so the centered matrix never exists in device memory.
// Rows at or past `rows` load as 0 and are not written.
//
// 256 threads, each an 8 x 8 block of the tile (two groups of 4 rows and of 4
// columns 64 apart, so a warp's shared-memory reads are contiguous float4s).
// The k loop steps by GK = 8 with no double buffering: a simple tile, right
// first.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int GT = 128;  // output tile edge
constexpr int GK = 8;    // k step
constexpr int GTHREADS = 256;

template <bool kCentered>
__device__ __forceinline__ float4 gram_load4(const float* __restrict__ m, int64_t ld, int r,
                                             int rows, int k, int K,
                                             const float* __restrict__ mu) {
  if (r >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = m + int64_t(r) * ld + k;
  if constexpr (!kCentered) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const float mr = mu[r];
    return make_float4(k + 0 < K ? p[0] - mr : 0.f, k + 1 < K ? p[1] - mr : 0.f,
                       k + 2 < K ? p[2] - mr : 0.f, k + 3 < K ? p[3] - mr : 0.f);
  }
}

// Tile (bi, bj) of A B^T over k in [0, K); A and B are (rows, ld) row-major.
template <bool kCentered>
__device__ __forceinline__ void gram_tile(const float* __restrict__ A,
                                          const float* __restrict__ B, int64_t ld, int rows,
                                          int K, const float* __restrict__ mu, int bi, int bj,
                                          float* __restrict__ out, int64_t ldo) {
  __shared__ __align__(16) float As[GK][GT + 4];
  __shared__ __align__(16) float Bs[GK][GT + 4];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lrow = tid / 2, lk = (tid % 2) * 4;
  const int ar = bi * GT + lrow, br = bj * GT + lrow;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GK) {
    const float4 va = gram_load4<kCentered>(A, ld, ar, rows, k0 + lk, K, mu);
    const float4 vb = gram_load4<kCentered>(B, ld, br, rows, k0 + lk, K, mu);
    As[lk + 0][lrow] = va.x; As[lk + 1][lrow] = va.y; As[lk + 2][lrow] = va.z; As[lk + 3][lrow] = va.w;
    Bs[lk + 0][lrow] = vb.x; Bs[lk + 1][lrow] = vb.y; Bs[lk + 2][lrow] = vb.z; Bs[lk + 3][lrow] = vb.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = bi * GT + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = bj * GT + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < rows) out[int64_t(r) * ldo + c] += acc[i][j];
    }
  }
}

}  // namespace rt
