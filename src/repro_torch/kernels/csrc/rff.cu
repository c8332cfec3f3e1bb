// K1 on the card: Sigma = [cos(Omega X); sin(Omega X)] / sqrt(N).
//
// Replaces src/repro/kernels/rff.py:48 (rff_pallas, _rff_kernel).  The
// operand featurize of featurize_tf32.cuh, the one K2/K3 run: the product
// over p as three tf32 wgmma products (fp32-accurate; the reference's bound
// is 2e-5), Omega loaded by TMA, phases of |z| >= 64 recomputed as fp32's FMA
// chain, the cos/sin epilogue fused, so the (N, n) phase matrix never reaches
// device memory.  Bound: operations, 3 x 2 N p n FLOP at the tf32 rate,
// against (N p + p n + 2 N n) * 4 bytes.  At a transform request's width
// (64-512 columns) the output tiles are too few to fill the card, so the
// wrapper splits the k-tiles of p into slices (rff.split_plan): the slices'
// phase sums go to a workspace and a finishing pass adds them in order and
// takes cos and sin (featurize_tf32.cuh).
#include "featurize_tf32.cuh"
#include "threefry.cuh"

// omega (nf, ld_omega) with its first p columns the weights; x (p, ldx) with
// its first n columns the samples; ld_omega and ldx multiples of 4 (TMA; the
// wrapper pads); out (2 nf, n); part null (one launch into out) or the
// workspace (slices, nf, n) of a split of kt_per_split k-tiles a slice;
// stats null or three uint64 counters, of which only the phases recomputed
// are added to (nothing is drawn)
extern "C" int rt_rff(const void* omega, int64_t ld_omega, const void* x, int64_t ldx, int nf,
                      int p, int n, float inv_sqrt_n, void* out, void* part, int slices,
                      int kt_per_split, void* stats, void* stream) {
  float* o = static_cast<float*>(out);
  rt::FtArgs a{0, nf, p, n, n, inv_sqrt_n, o, o + int64_t(nf) * n, n, 0,
               static_cast<unsigned long long*>(stats)};
  a.part = static_cast<float*>(part);
  a.kt_per_split = kt_per_split;
  return int(rt::launch_featurize_operand(static_cast<const float*>(omega), ld_omega,
                                          static_cast<const float*>(x), ldx, a, slices,
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
