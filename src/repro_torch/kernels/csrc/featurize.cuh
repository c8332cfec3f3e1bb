// Featurize: [cos(Omega X); sin(Omega X)] * scale, an fp32 FFMA product over
// p with the cos/sin epilogue fused, written by hand (no cuBLAS).
//
// Only K1 (rff.cu) uses it now, with OperandOmega as the Omega source; K2/K3
// and the seed-fused path (K7, K5/K6) run on the tensor cores in
// featurize_tf32.cuh.  The source is the template parameter `Gen`, any
// functor `float operator()(row, col)` with a `draw(e)` that selects ensemble
// draw e (blockIdx.y).  `Gen` is called only for row < nf and col < p, so an
// operand is never read past its edges.
//
// Tile: BM = 32 feature rows x BN = 256 sample columns per block of 256
// threads, each thread 4 rows x 8 columns (two groups of 4 columns 128 apart,
// so the shared-memory reads of a warp are contiguous float4s).  The k loop
// walks p in chunks of BK = 16; the Omega tile (32 x 16) is produced by `Gen`
// (a global read, or 512 threefry draws), the X tile (16 x 256) is read
// coalesced.  BN is wide on purpose: a drawn Omega tile is reused by BN
// columns, so the draw costs 1/BN of a draw per FMA.
//
// Columns at or past `n_valid` of the block are written as 0 (a masked
// sample, not cos(0) = 1); rows at or past `nf` are not written.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int FZ_BM = 32;
constexpr int FZ_BN = 256;
constexpr int FZ_BK = 16;
constexpr int FZ_THREADS = 256;

template <class Gen>
__global__ void __launch_bounds__(FZ_THREADS)
featurize_kernel(Gen gen, const float* __restrict__ x, int64_t ldx, int x_col0,
                 int nf, int p, int n_valid, int ncols_out, float scale,
                 float* __restrict__ out_c, float* __restrict__ out_s, int64_t ldo,
                 int64_t draw_stride) {
  __shared__ __align__(16) float As[FZ_BK][FZ_BM + 4];  // +4: fewer bank conflicts on the transposed store
  __shared__ __align__(16) float Bs[FZ_BK][FZ_BN];
  const Gen g = gen.draw(blockIdx.y);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * FZ_BM;
  const int col0 = blockIdx.z * FZ_BN;
  const int ty = tid / 32;  // rows ty*4 .. ty*4+3
  const int tx = tid % 32;  // columns tx*4 .. +3 and 128 + tx*4 .. +3

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p; k0 += FZ_BK) {
#pragma unroll
    for (int i = 0; i < (FZ_BM * FZ_BK) / FZ_THREADS; ++i) {
      const int idx = tid + i * FZ_THREADS;
      const int r = idx / FZ_BK, kk = idx % FZ_BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < nf && gk < p) ? g(uint32_t(gr), uint32_t(gk)) : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < FZ_BK; ++kk) {
      const int gk = k0 + kk;
      const int c = col0 + tid;
      Bs[kk][tid] = (gk < p && c < n_valid) ? x[int64_t(gk) * ldx + x_col0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FZ_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][128 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int64_t dofs = int64_t(blockIdx.y) * draw_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= nf) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 128 + tx * 4 + (j - 4));
      if (c >= ncols_out) continue;
      float sv = 0.f, cv = 0.f;
      if (c < n_valid) {
        sincosf(acc[i][j], &sv, &cv);
        sv *= scale;
        cv *= scale;
      }
      out_c[dofs + int64_t(r) * ldo + c] = cv;
      out_s[dofs + int64_t(r) * ldo + c] = sv;
    }
  }
}

template <class Gen>
cudaError_t launch_featurize(const Gen& gen, int draws, const float* x, int64_t ldx,
                             int x_col0, int nf, int p, int n_valid, int ncols_out,
                             float scale, float* out_c, float* out_s, int64_t ldo,
                             int64_t draw_stride, cudaStream_t stream) {
  const dim3 grid((nf + FZ_BM - 1) / FZ_BM, draws, (ncols_out + FZ_BN - 1) / FZ_BN);
  featurize_kernel<Gen><<<grid, FZ_THREADS, 0, stream>>>(
      gen, x, ldx, x_col0, nf, p, n_valid, ncols_out, scale, out_c, out_s, ldo,
      draw_stride);
  return cudaGetLastError();
}

}  // namespace rt
