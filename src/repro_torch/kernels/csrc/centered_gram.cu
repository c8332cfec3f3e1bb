// K8 on the card: the centered Gram  G = (Sigma - mu 1^T)(Sigma - mu 1^T)^T.
//
// Replaces src/repro/kernels/centered_gram.py:38 (centered_gram_pallas,
// _gram_kernel), the Sigma H Sigma^T of the dense RF-TCA fit.  As in the
// reference, the row mean mu (2N,) is computed outside the kernel (a torch
// reduction in the wrapper) and subtracted as each tile is loaded, so the
// centered (2N, n) matrix never reaches device memory.  The reference pads
// the samples with the row mean to a multiple of its block; here the ragged
// n is masked after the shift instead.  bf16 Sigma gives fp32 G, with mu the
// row mean rounded to bf16 (centered_gram.py:53), as the reference's.
//
// Design: fp32 Sigma takes the tensor-core Gram of gram_tf32.cuh
// (kCentered): three tf32 wgmma products a product with a fold every 32 of
// k.  bf16 Sigma takes gram_bf16.cuh: Sigma less mu in two bf16 parts, four
// bf16 wgmma products a product with a fold every 128 of k.  Both load
// Sigma by TMA (rows a multiple of 16 bytes apart: the wrapper copies Sigma
// with zero columns appended otherwise), take both operands less mu and mask
// the columns past n to 0 after the shift, compute the upper tiles only and
// split the k axis across blocks where the tiles are few (2N = 2000: 136
// tiles, 4 ways), the splits' partial tiles added in split order by a second
// kernel, so two identical calls agree bit for bit and G is exactly
// symmetric.  G is fp32 either way, as the reference's.
// Bound: operations, (2N)^2 n fp32-accurate FLOP over the upper tiles at the
// split-TF32 rate (495 / 3 TFLOP/s), against (2N n + (2N)^2) * 4 bytes; bf16
// Sigma: one bf16 product at 989 TFLOP/s against 2N n * 2 + (2N)^2 * 4.
#include "gram_bf16.cuh"
#include "gram_tf32.cuh"

// the k-tile the k split counts in: 32 of k for fp32 Sigma, 64 for bf16
extern "C" int rt_centered_gram_k_tile(int bf16) { return bf16 ? rt::GB_BK : rt::GX_BK; }

// sigma (rows, ld) with its first n columns the samples, fp32 or (bf16 != 0)
// bf16, its rows 16-byte aligned (TMA); mu (rows,) fp32 the row means; the
// k split (split ways of kt_per_split k-tiles of rt_centered_gram_k_tile)
// is the caller's; with split > 1, ws (tiles, split, 128, 128) floats for the
// partial tiles.  out (rows, rows) is written here: *whole = 1 where every
// element is (bf16 Sigma, or a split's sum, which writes the upper tiles'
// mirror), else 0: the upper tiles, the rest zero, for the caller to mirror.
extern "C" int rt_centered_gram(const void* sigma, int64_t ld, int bf16, const void* mu, int rows,
                                int n, void* out, int split, int kt_per_split, void* ws,
                                int* whole, void* stream) {
  const int bk = bf16 ? rt::GB_BK : rt::GX_BK;
  CUtensorMap tsig;
  const bool mapped =
      bf16 ? hop::map_bf16(&tsig, sigma, rows, n, ld, bk, rt::GX_T, CU_TENSOR_MAP_SWIZZLE_128B)
           : hop::map_f32_sw128(&tsig, sigma, rows, n, ld, bk, rt::GX_T);
  if (!mapped) return int(cudaErrorInvalidValue);
  const int t = (rows + rt::GX_T - 1) / rt::GX_T, n_kt = (n + bk - 1) / bk;
  // one product of Sigma with itself, both operands less mu (the shift,
  // one draw whose k-tiles are all of n), columns >= n masked
  const rt::GxArgs a{rows, n_kt, 0, 1, static_cast<float*>(out), nullptr, nullptr,
                     static_cast<const float*>(mu), nullptr, n_kt, 1, nullptr, nullptr, n,
                     static_cast<float*>(ws)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  *whole = bf16 || split > 1;
  if (bf16)
    return int(rt::launch_gram_bf16_kernel(tsig, t * (t + 1) / 2, split, kt_per_split, a, st));
  // the fp32 kernel adds into G's upper tiles, and a split's sum into both
  const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * rows * rows, st);
  if (err != cudaSuccess) return int(err);
  return int(rt::launch_gram_tf32_kernel<true>(tsig, tsig, t * (t + 1) / 2, split, kt_per_split,
                                               a, st));
}
