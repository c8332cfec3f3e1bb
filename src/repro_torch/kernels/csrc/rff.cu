// K1 on the card: Sigma = [cos(Omega X); sin(Omega X)] / sqrt(N).
//
// Replaces src/repro/kernels/rff.py:48 (rff_pallas, _rff_kernel).  The
// product over p is an fp32 FFMA loop (not TF32: the reference's bound is
// 2e-5) with the cos/sin epilogue fused, so the (N, n) phase matrix never
// reaches device memory.  Bound: fp32 operations, 2 N p n FLOP against
// (N p + p n + 2 N n) * 4 bytes.  The design is the shared featurize tile
// (featurize.cuh) with Omega read from the operand.
#include "featurize.cuh"
#include "threefry.cuh"

extern "C" int rt_rff(const void* omega, const void* x, int nf, int p, int n,
                      float inv_sqrt_n, void* out, void* stream) {
  const rt::OperandOmega gen{static_cast<const float*>(omega), p};
  float* o = static_cast<float*>(out);
  return int(rt::launch_featurize(gen, 1, static_cast<const float*>(x), n, 0, nf, p, n, n,
                                  inv_sqrt_n, o, o + int64_t(nf) * n, n, 0,
                                  static_cast<cudaStream_t>(stream)));
}
