// K5 + K6 on the card: the seed-fused streamed Gram, one design for all N.
//
// Replaces src/repro/kernels/rff_gram_stream.py:524 (untiled,
// rff_gram_stream_fused_pallas) and :587 (tiled,
// rff_gram_stream_fused_tiled_pallas).  The TPU split between the two came
// from VMEM holding three N^2 accumulators; here the accumulators live in
// device memory and one design serves every N.  The five-output contract is
// the reference's:
//   G_cc = C C^T, G_cs = C S^T, G_ss = S S^T          (nf, nf), pooled over draws
//   M_c[:, 2e] = C_e ell, M_c[:, 2e+1] = C_e 1 (and M_s) (nf, 2S), per draw
// with C, S = cos, sin of Omega_e X scaled by 1/sqrt(N S), padded sample
// columns masked to 0.
//
// Per chunk of bc sample columns the host launches, in order:
//   1. featurize<FusedOmega> (featurize.cuh): draws Omega_e in the kernel
//      (threefry, K4) and writes the (nf, S bc) cos and sin slabs of the
//      chunk into a workspace reused by every chunk;
//   2. gram_moments: the 2S moment columns of the chunk, one warp per
//      (row, draw, cos|sin), added into M_c and M_s;
//   3. gram_accumulate: the three (nf, nf) products over k = S bc, added into
//      G_cc, G_cs, G_ss.  128 x 128 output tile per block of 256 threads,
//      each 8 x 8; G_cc and G_ss are symmetric, so only tiles with
//      row tile <= column tile are computed (the wrapper mirrors them).
// Peak memory: O(N^2 + N bc S).  Omega is drawn once per (row tile, p chunk,
// 256-column tile of a chunk).
// Bound: fp32 operations of the Gram products (~4 S n nf^2 FLOP with the
// symmetry) ahead of the featurize product (2 S nf p n) and the draws.
#include "featurize.cuh"
#include "threefry.cuh"

namespace {

constexpr int GT = 128;  // output tile edge
constexpr int GK = 8;    // k step
constexpr int GTHREADS = 256;

__global__ void __launch_bounds__(GTHREADS)
gram_accumulate_kernel(const float* __restrict__ wc, const float* __restrict__ ws, int nf,
                       int K, float* __restrict__ gcc, float* __restrict__ gcs,
                       float* __restrict__ gss) {
  const int which = blockIdx.z;  // 0: cc, 1: cs, 2: ss
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (which != 1 && bi > bj) return;
  const float* A = which == 2 ? ws : wc;
  const float* B = which == 0 ? wc : ws;
  float* out = which == 0 ? gcc : (which == 1 ? gcs : gss);

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

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += GK) {
    const float4 va = ar < nf ? *reinterpret_cast<const float4*>(A + int64_t(ar) * K + k0 + lk) : zero;
    const float4 vb = br < nf ? *reinterpret_cast<const float4*>(B + int64_t(br) * K + k0 + lk) : zero;
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
    if (r >= nf) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = bj * GT + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < nf) out[int64_t(r) * nf + c] += acc[i][j];
    }
  }
}

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
                                  void* stream) {
  const rt::FusedOmega gen{k0, 0u, inv_sigma, kind};
  return int(rt::launch_featurize(gen, draws, static_cast<const float*>(x), ldx, x_col0, nf,
                                  p, n_valid, bc, scale, static_cast<float*>(wc),
                                  static_cast<float*>(ws), int64_t(draws) * bc, bc,
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

extern "C" int rt_gram_accumulate(const void* wc, const void* ws, int nf, int K, void* gcc,
                                  void* gcs, void* gss, void* stream) {
  const int t = (nf + GT - 1) / GT;
  gram_accumulate_kernel<<<dim3(t, t, 3), GTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wc), static_cast<const float*>(ws), nf, K,
      static_cast<float*>(gcc), static_cast<float*>(gcs), static_cast<float*>(gss));
  return int(cudaGetLastError());
}
