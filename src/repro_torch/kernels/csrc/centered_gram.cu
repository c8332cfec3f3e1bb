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
// Design: the tensor-core Gram of gram_tf32.cuh (kCentered): three tf32
// wgmma products a product with a fold every 32 of k, Sigma by TMA (rows a
// multiple of 16 bytes apart: the wrapper copies Sigma with zero columns
// appended otherwise), both operands less mu and the columns past n masked
// to 0 after the shift, upper tiles only (the wrapper mirrors them), the k
// axis split across blocks where the tiles are few (2N = 2000: 136 tiles, 4
// ways), the splits' partial tiles added in split order by a second
// kernel, so two identical calls agree bit for bit and the mirrored G is
// exactly symmetric.  bf16 Sigma is loaded as bf16 and widened in the
// splitters' pass (kBf16); G is fp32 either way, as the reference's.
// Bound: operations, (2N)^2 n fp32-accurate FLOP over the upper tiles at the
// split-TF32 rate (495 / 3 TFLOP/s), against (2N n + (2N)^2) * 4 bytes
// (2N n * 2 for bf16 Sigma).
#include "gram_tf32.cuh"

// sigma (rows, ld) with its first n columns the samples, fp32 or (bf16 != 0)
// bf16, its rows 16-byte aligned (TMA); mu (rows,) fp32 the row means; out
// (rows, rows) must be zero on entry: its upper tiles receive the sum, and
// with split > 1 its lower triangle their mirror (the wrapper mirrors G
// otherwise).  The
// k split (split ways of kt_per_split k-tiles of 32) is the caller's; with
// split > 1, ws (tiles, split, 128, 128) floats for the partial tiles.
extern "C" int rt_centered_gram(const void* sigma, int64_t ld, int bf16, const void* mu, int rows,
                                int n, void* out, int split, int kt_per_split, void* ws,
                                void* stream) {
  CUtensorMap tsig;
  const bool mapped =
      bf16 ? hop::map_bf16(&tsig, sigma, rows, n, ld, rt::GX_BK, rt::GX_T,
                           CU_TENSOR_MAP_SWIZZLE_NONE)
           : hop::map_f32_sw128(&tsig, sigma, rows, n, ld, rt::GX_BK, rt::GX_T);
  if (!mapped) return int(cudaErrorInvalidValue);
  const int t = (rows + rt::GX_T - 1) / rt::GX_T, n_kt = (n + rt::GX_BK - 1) / rt::GX_BK;
  // one product of Sigma with itself, both operands less mu (the shift,
  // one draw whose k-tiles are all of n), columns >= n masked
  const rt::GxArgs a{rows, n_kt, 0, 1, static_cast<float*>(out), nullptr, nullptr,
                     static_cast<const float*>(mu), nullptr, n_kt, 1, nullptr, nullptr, n,
                     static_cast<float*>(ws)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(bf16 ? rt::launch_gram_tf32_kernel<true, true>(tsig, tsig, t * (t + 1) / 2, split,
                                                            kt_per_split, a, st)
                  : rt::launch_gram_tf32_kernel<true>(tsig, tsig, t * (t + 1) / 2, split,
                                                      kt_per_split, a, st));
}
