// K1 on the card: Sigma = [cos(Omega X); sin(Omega X)] / sqrt(N).
//
// Replaces src/repro/kernels/rff.py:48 (rff_pallas, _rff_kernel).  The
// product over p is an fp32 FFMA loop (not TF32: the reference's bound is
// 2e-5) with the cos/sin epilogue fused, so the (N, n) phase matrix never
// reaches device memory.  Bound: fp32 operations, 2 N p n FLOP against
// (N p + p n + 2 N n) * 4 bytes.  The design is the shared featurize tile
// (featurize.cuh) with Omega read from the operand.
#include "featurize.cuh"
#include "featurize_tf32.cuh"
#include "threefry.cuh"

extern "C" int rt_rff(const void* omega, const void* x, int nf, int p, int n,
                      float inv_sqrt_n, void* out, void* stream) {
  const rt::OperandOmega gen{static_cast<const float*>(omega), p};
  float* o = static_cast<float*>(out);
  return int(rt::launch_featurize(gen, 1, static_cast<const float*>(x), n, 0, nf, p, n, n,
                                  inv_sqrt_n, o, o + int64_t(nf) * n, n, 0,
                                  static_cast<cudaStream_t>(stream)));
}

// K7 on the card: K1 with Omega drawn in the kernel, no operand.
//
// Replaces src/repro/kernels/rff.py:117 (rff_fused_pallas,
// _rff_fused_kernel).  The seed-fused featurize of featurize_tf32.cuh: the
// product as three tf32 wgmma products (fp32-accurate) with element (row,
// col) of Omega = threefry(seed, ensemble_index, row, col) (K4,
// threefry.cuh) drawn by a producer warpgroup beside them, once per cluster
// of CTAs spanning 1024 sample columns.  The scale is 1/sqrt(N) of the true
// N.  Bound: operations, 3 x 2 N p n FLOP at the tf32 rate, plus ~82 integer
// operations per draw for (N p) * ceil(n / 1024) draws, against (p n + 2 N
// n) * 4 bytes.
// x is (p, ldx) with its first n columns the samples; ldx a multiple of 4
// (the TMA row stride; the wrapper pads), out is (2 nf, n); stats null or
// three uint64 counters the kernel adds to (featurize_tf32.cuh's FtArgs)
extern "C" int rt_rff_fused(uint32_t k0, uint32_t ensemble_index, float inv_sigma, int kind,
                            const void* x, int64_t ldx, int nf, int p, int n, float inv_sqrt_n,
                            void* out, void* stats, void* stream) {
  const rt::FusedOmega gen{k0, ensemble_index, inv_sigma, kind};
  float* o = static_cast<float*>(out);
  return int(rt::launch_featurize_tf32(gen, 1, static_cast<const float*>(x), ldx, 0, nf, p, n, n,
                                       inv_sqrt_n, o, o + int64_t(nf) * n, n, 0,
                                       static_cast<unsigned long long*>(stats),
                                       static_cast<cudaStream_t>(stream)));
}
