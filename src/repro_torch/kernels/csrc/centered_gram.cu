// K8 on the card: the centered Gram  G = (Sigma - mu 1^T)(Sigma - mu 1^T)^T.
//
// Replaces src/repro/kernels/centered_gram.py:38 (centered_gram_pallas,
// _gram_kernel), the Sigma H Sigma^T of the dense RF-TCA fit.  As in the
// reference, the row mean mu (2N,) is computed outside the kernel (a torch
// reduction in the wrapper) and subtracted as each tile is loaded, so the
// centered (2N, n) matrix never reaches device memory.  The reference pads
// the samples with the row mean to a multiple of its block; here the ragged
// n is masked in the loads instead (gram_tile.cuh with kCentered = true).
//
// Design: the shared 128 x 128 fp32 FFMA tile of gram_tile.cuh, one block per
// output tile with row tile <= column tile (G is symmetric; the wrapper
// mirrors the upper tiles), each block walking all n samples.
// Bound: fp32 operations, ~2 n (2N)^2 / 2 FLOP over the upper tiles, against
// (2N n + (2N)^2) * 4 bytes.
#include "gram_tile.cuh"

namespace {

__global__ void __launch_bounds__(rt::GTHREADS)
centered_gram_kernel(const float* __restrict__ sigma, const float* __restrict__ mu, int rows,
                     int n, float* __restrict__ out) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bi > bj) return;
  rt::gram_tile<true>(sigma, sigma, n, rows, n, mu, bi, bj, out, rows);
}

}  // namespace

// out (rows, rows) must be zero on entry; its upper tiles receive the sum.
extern "C" int rt_centered_gram(const void* sigma, const void* mu, int rows, int n, void* out,
                                void* stream) {
  const int t = (rows + rt::GT - 1) / rt::GT;
  centered_gram_kernel<<<dim3(t, t), rt::GTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sigma), static_cast<const float*>(mu), rows, n,
      static_cast<float*>(out));
  return int(cudaGetLastError());
}
