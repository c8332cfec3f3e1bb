// K2/K3 and K5/K6 on the card: the streamed Gram, one design for all N.
//
// Replaces src/repro/kernels/rff_gram_stream.py:244 (rff_gram_stream_pallas,
// K2) and :180 (rff_gram_stream_tiled_pallas, K3), which read Omega from an
// operand, and :524 (rff_gram_stream_fused_pallas, K5) and :587
// (rff_gram_stream_fused_tiled_pallas, K6), which draw it in the kernel.  The
// TPU's untiled/tiled split came from VMEM holding three N^2 accumulators;
// here the accumulators live in device memory and one design serves every N.
// The five-output contract is the reference's:
//   G_cc = C C^T, G_cs = C S^T, G_ss = S S^T          (nf, nf), pooled over draws
//   M_c[:, 2e] = C_e ell, M_c[:, 2e+1] = C_e 1 (and M_s) (nf, 2S), per draw
// with C, S = cos, sin of Omega_e X scaled by 1/sqrt(N S) (the true N; S = 1
// for the operand path), padded sample columns masked to 0.
//
// Per chunk of bc sample columns the host launches, in order:
//   1. featurize on the tensor cores (featurize_tf32.cuh: three tf32
//      products a product, phases of |z| >= 64 recomputed as fp32's FMA
//      chain): rt_fused_featurize draws Omega_e in the kernel (FusedOmega,
//      threefry K4; once per 1024 columns of the chunk), rt_operand_featurize
//      loads it from the (N, p) operand by TMA.  Either writes the chunk's
//      (nf, S bc) cos and sin slabs into a workspace reused by every chunk;
//   2. gram_moments: the 2S moment columns of the chunk, one warp per
//      (row, draw, cos|sin), added into M_c and M_s;
//   3. rt_fused_gram_accumulate: the three (nf, nf) products over k = S bc,
//      added into G_cc, G_cs, G_ss on the tensor cores (gram_tf32.cuh: three
//      tf32 products, a TMA ring, k split across blocks where the tiles are
//      few, each row of the A operand taken less its draw's mean over the
//      first chunk, added back by the last chunk's launch).  G_cc and G_ss
//      are symmetric, so only tiles with row tile <= column tile are
//      computed (the wrapper mirrors them).
// Peak memory: O(N^2 + N bc S).  A fused Omega is drawn once per (feature
// tile, k-tile, 1024 columns of a chunk); an operand Omega is read once per
// (feature tile, k-tile, 128 columns of a chunk), mostly from the L2.  Bound:
// operations of the Gram products (~4 S n nf^2 FLOP with the symmetry) ahead
// of the featurize product (2 S nf p n) and the draws, both at the
// split-TF32 rate (495 / 3 TFLOP/s).
#include "featurize_tf32.cuh"
#include "gram_tf32.cuh"
#include "threefry.cuh"

namespace {

// One warp per (row r, draw e, cos|sin): the chunk's ell-moment and column
// sum of that feature row, added into columns (2e, 2e+1) of M_c or M_s.
__global__ void gram_moments_kernel(const float* __restrict__ wc, const float* __restrict__ ws,
                                    int nf, int draws, int bc, const float* __restrict__ ell,
                                    int n_valid, float* __restrict__ mc,
                                    float* __restrict__ ms) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= nf * draws * 2) return;
  const int which = warp % 2;
  const int e = (warp / 2) % draws;
  const int r = warp / (2 * draws);
  const float* row = (which ? ws : wc) + int64_t(r) * draws * bc + int64_t(e) * bc;
  float m = 0.f, s = 0.f;
  for (int j = lane; j < n_valid; j += 32) {
    const float v = row[j];
    m = fmaf(v, ell[j], m);
    s += v;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    m += __shfl_down_sync(0xffffffffu, m, off);
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if (lane == 0) {
    float* out = (which ? ms : mc) + int64_t(r) * 2 * draws + 2 * e;
    out[0] += m;
    out[1] += s;
  }
}

}  // namespace

extern "C" int rt_fused_featurize(uint32_t k0, float inv_sigma, int kind, const void* x,
                                  int64_t ldx, int x_col0, int nf, int p, int n_valid,
                                  int bc, int draws, float scale, void* wc, void* ws,
                                  void* stats, void* stream) {
  const rt::FusedOmega gen{k0, 0u, inv_sigma, kind};
  return int(rt::launch_featurize_tf32(gen, draws, static_cast<const float*>(x), ldx, x_col0, nf,
                                  p, n_valid, bc, scale, static_cast<float*>(wc),
                                  static_cast<float*>(ws), int64_t(draws) * bc, bc,
                                  static_cast<unsigned long long*>(stats),
                                  static_cast<cudaStream_t>(stream)));
}

// omega (nf, ld_omega) with its first p columns the weights, ld_omega a
// multiple of 4; x (p, ldx) likewise (TMA row strides; the wrapper pads);
// stats: null, or the counters of launch_featurize_tf32, of which only the
// phases recomputed are added to (nothing is drawn)
extern "C" int rt_operand_featurize(const void* omega, int64_t ld_omega, const void* x,
                                    int64_t ldx, int x_col0, int nf, int p, int n_valid,
                                    int bc, float scale, void* wc, void* ws, void* stats,
                                    void* stream) {
  const rt::FtArgs a{x_col0, nf, p, n_valid, bc, scale, static_cast<float*>(wc),
                     static_cast<float*>(ws), bc, 0,
                     static_cast<unsigned long long*>(stats)};
  return int(rt::launch_featurize_operand(static_cast<const float*>(omega), ld_omega,
                                          static_cast<const float*>(x), ldx, a, 1,
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int rt_gram_moments(const void* wc, const void* ws, int nf, int draws, int bc,
                               const void* ell, int n_valid, void* mc, void* ms,
                               void* stream) {
  const int64_t threads = int64_t(nf) * draws * 2 * 32;
  gram_moments_kernel<<<int((threads + 255) / 256), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wc), static_cast<const float*>(ws), nf, draws, bc,
      static_cast<const float*>(ell), n_valid, static_cast<float*>(mc),
      static_cast<float*>(ms));
  return int(cudaGetLastError());
}

// K = draws x bc columns, bc a multiple of 32 (the workspace's chunk widths
// are of 256); shift_c, shift_s: (nf, draws) row shifts of the A operand;
// mom_c, mom_s: the moments (nf, 2 draws) at the last chunk, else null
extern "C" int rt_fused_gram_accumulate(const void* wc, const void* ws, int nf, int K, int bc,
                                        void* gcc, void* gcs, void* gss, const void* shift_c,
                                        const void* shift_s, const void* mom_c,
                                        const void* mom_s, void* stream) {
  if (K % rt::GX_BK != 0 || bc % rt::GX_BK != 0 || K % bc != 0)
    return int(cudaErrorInvalidValue);
  CUtensorMap tc, ts;
  if (!hop::map_f32_sw128(&tc, wc, nf, K, K, rt::GX_BK, rt::GX_T) ||
      !hop::map_f32_sw128(&ts, ws, nf, K, K, rt::GX_BK, rt::GX_T))
    return int(cudaErrorInvalidValue);
  const int t = (nf + rt::GX_T - 1) / rt::GX_T;
  const rt::GxArgs a{nf, K / rt::GX_BK, 0, 1,
                     static_cast<float*>(gcc), static_cast<float*>(gcs), static_cast<float*>(gss),
                     static_cast<const float*>(shift_c), static_cast<const float*>(shift_s),
                     bc / rt::GX_BK, K / bc,
                     static_cast<const float*>(mom_c), static_cast<const float*>(mom_s), K};
  return int(rt::launch_gram_tf32_kernel<false>(tc, ts, t * (t + 1) + t * t, a,
                                                static_cast<cudaStream_t>(stream)));
}
