// K8 on the card: the centered Gram  G = (Sigma - mu 1^T)(Sigma - mu 1^T)^T.
//
// Replaces src/repro/kernels/centered_gram.py:38 (centered_gram_pallas,
// _gram_kernel), the Sigma H Sigma^T of the dense RF-TCA fit.  As in the
// reference, the row mean mu (2N,) is computed outside the kernel (a torch
// reduction in the wrapper) and subtracted as each tile is loaded, so the
// centered (2N, n) matrix never reaches device memory.  The reference pads
// the samples with the row mean to a multiple of its block; here the ragged
// n is masked after the shift instead.
//
// Design: the tensor-core Gram of gram_tf32.cuh (kCentered): three tf32
// wgmma products a product with a fold every 32 of k, Sigma by TMA (rows a
// multiple of 4 floats apart: the wrapper copies Sigma with zero columns
// appended otherwise), both operands less mu and the columns past n masked
// to 0 after the shift, upper tiles only (the wrapper mirrors them), the k
// axis split across blocks where the tiles are few (2N = 2000: 136 tiles, 4
// ways).  With a split the blocks add with red.global.add, so two identical
// calls agree to rounding, not bit for bit; the mirrored G stays exactly
// symmetric.
// Bound: operations, (2N)^2 n fp32-accurate FLOP over the upper tiles at the
// split-TF32 rate (495 / 3 TFLOP/s), against (2N n + (2N)^2) * 4 bytes.
#include "gram_tf32.cuh"

// sigma (rows, ld) with its first n columns the samples, ld a multiple of 4
// and sigma 16-byte aligned (TMA); mu (rows,) the row means; out (rows,
// rows) must be zero on entry: its upper tiles receive the sum.
extern "C" int rt_centered_gram(const void* sigma, int64_t ld, const void* mu, int rows, int n,
                                void* out, void* stream) {
  CUtensorMap tsig;
  if (!hop::map_f32_sw128(&tsig, sigma, rows, n, ld, rt::GX_BK, rt::GX_T))
    return int(cudaErrorInvalidValue);
  const int t = (rows + rt::GX_T - 1) / rt::GX_T, n_kt = (n + rt::GX_BK - 1) / rt::GX_BK;
  // one product of Sigma with itself, both operands less mu (the shift,
  // one draw whose k-tiles are all of n), columns >= n masked
  const rt::GxArgs a{rows, n_kt, 0, 1, static_cast<float*>(out), nullptr, nullptr,
                     static_cast<const float*>(mu), nullptr, n_kt, 1, nullptr, nullptr, n};
  return int(rt::launch_gram_tf32_kernel<true>(tsig, tsig, t * (t + 1) / 2, a,
                                               static_cast<cudaStream_t>(stream)));
}
