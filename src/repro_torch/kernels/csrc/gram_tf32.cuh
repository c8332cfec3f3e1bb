// The seed-fused Gram accumulate on Hopper's tensor cores: G_cc += C C^T,
// G_cs += C S^T, G_ss += S S^T over one chunk's k = S bc columns of the cos
// and sin slabs, fp32-accurate as three tf32 products.
//
// Replaces the Gram stage of src/repro/kernels/rff_gram_stream.py:524
// (rff_gram_stream_fused_pallas, K5) and :587 (its tiled form, K6).  The
// operand path (K2/K3) keeps the FFMA tile of gram_tile.cuh.
//
// Bound: operations, ~4 S n N^2 fp32-accurate FLOP with the symmetry, 3x that
// on the tf32 tensor cores (495 TFLOP/s dense).  A 128 x 128 tile reads 32 KB
// a k-step of 32 for 1 MFLOP of fp32-equivalent work, so at the split-TF32
// rate it leans on the L2 (the slabs of one chunk, 30-64 MB, are read by
// every tile of a row or column).
//
// Design:
//   - Both operands are the slabs' rows, K-major as tf32 wgmma needs.  A
//     (tile rows) comes from shared memory into registers, split there into
//     hi = tf32(v) and lo = tf32(v - hi); B (tile columns) is split once a
//     stage by the producer warpgroup into hi (in place) and lo tiles, so the
//     workspace keeps one fp32 slab per chunk (pre-split slabs would halve
//     the chunk width and double the read-modify-writes of the N^2
//     accumulators).  Each k-step runs three wgmma m64n128k8 into one fp32
//     accumulator, the two small terms first (A_lo B_hi, A_hi B_lo, A_hi B_hi).
//     The tensor cores' fp32 additions round toward zero, which over a
//     chunk's k (2048 at N = 4096, S = 4) biases a positive diagonal by ~1e-5
//     of its size, half the gate; so each stage (k of 32) starts a fresh
//     wgmma accumulator, added to the block's sum in registers with fp32's
//     rounding to nearest (~5e-7: tests/test_torch_split_tf32_numerics.py).
//   - Warp-specialised: one producer thread keeps a 4-stage TMA ring of A and
//     B tiles (32 k x 128 rows each, 128-byte swizzle, rows past N
//     zero-filled) in flight; producer warps 1-3 split B (an issuing thread
//     that also split measured slower: its waits for free stages held the
//     splits back); consumer warpgroups 1 and 2 own 64 tile rows each.
//   - A shifted: each row of the A operand (C for G_cc and G_cs, S for
//     G_ss) is taken less its draw's shift a (the row's mean over that
//     draw's columns of the first chunk, from the moments), so the products
//     are (A - a 1^T) B^T; the last chunk's launch adds a (B 1)^T, B 1 the
//     moments' column sums over every chunk.  With small phases a row of C
//     is nearly constant and G_H is a cancellation of G_cc; products of the
//     unshifted rows (each value split into two tf32 parts, ~2^-22 of it
//     lost) came out farther from the float64 answer than fp32's sgemm
//     (H100: 1.5e-5 against 1.2e-5 at N = 65, p = 40, sigma = 28).  A
//     shifted row is small, and so are the split's losses on both operands
//     of its products (tests/test_torch_split_tf32_numerics.py).
//   - The grid walks the upper tiles of G_cc and G_ss (they are symmetric;
//     the wrapper mirrors them) and every tile of G_cs.  Where those tiles
//     are too few for the card (K5's 136 at N = 1000 on 132 SMs) the chunk's
//     k is split across blocks (`split`), each adding its part with
//     red.global.add: the order of the additions then varies from run to
//     run, so two identical calls agree to rounding, not bit for bit.  With
//     split = 1 each tile is read, added to and written back, in a fixed
//     order.
#pragma once
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace rt {

constexpr int GX_T = 128;  // output tile edge
constexpr int GX_BK = 32;  // k a stage
constexpr int GX_STAGES = 4;
constexpr int GX_TILE_BYTES = GX_T * GX_BK * 4;  // 16 KB
constexpr int GX_STAGE_BYTES = 3 * GX_TILE_BYTES;  // A, B (hi in place), B lo
constexpr int GX_SMEM = 1024 + GX_STAGES * GX_STAGE_BYTES + 24 * GX_STAGES;
constexpr int GX_SPLITTERS = 96;  // producer warps 1-3

struct GxArgs {
  int nf, n_kt, kt_per_split, split;
  float* gcc;
  float* gcs;
  float* gss;
  const float* shift_c;  // (nf, draws): draw e's shift of each row of C, or null
  const float* shift_s;  // and of S
  int kt_per_draw, draws;  // k-tiles of one draw's columns in the chunk
  // the last chunk: the moments (nf, 2 draws), column 2e + 1 draw e's row
  // sums of C and of S over every chunk; null before it
  const float* mom_c;
  const float* mom_s;
};

// tile q of the upper triangle, column-major: (bi, bj) with bi <= bj
__device__ __forceinline__ void upper_tile(int q, int& bi, int& bj) {
  int j = static_cast<int>((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
  while (j * (j + 1) / 2 > q) --j;
  while ((j + 1) * (j + 2) / 2 <= q) ++j;
  bj = j;
  bi = q - j * (j + 1) / 2;
}

__global__ void __launch_bounds__(384, 1)
gram_tf32_kernel(const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap ts,
                 const GxArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + GX_STAGES * GX_STAGE_BYTES;
  auto a_sm = [&](int s) { return base + s * GX_STAGE_BYTES; };
  auto b_hi = [&](int s) { return base + s * GX_STAGE_BYTES + GX_TILE_BYTES; };
  auto b_lo = [&](int s) { return base + s * GX_STAGE_BYTES + 2 * GX_TILE_BYTES; };
  auto landed = [&](int s) { return bars + 8u * s; };
  auto full = [&](int s) { return bars + 8u * (GX_STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (2 * GX_STAGES + s); };

  // block -> (which, bi, bj): upper G_cc tiles, all G_cs tiles, upper G_ss
  const int t_side = (a.nf + GX_T - 1) / GX_T;
  const int n_up = t_side * (t_side + 1) / 2;
  int q = blockIdx.x, which, bi, bj;
  if (q < n_up) {
    which = 0;
    upper_tile(q, bi, bj);
  } else if (q < n_up + t_side * t_side) {
    which = 1;
    q -= n_up;
    bi = q / t_side;
    bj = q % t_side;
  } else {
    which = 2;
    upper_tile(q - n_up - t_side * t_side, bi, bj);
  }
  const CUtensorMap* ta = which == 2 ? &ts : &tc;
  const CUtensorMap* tb = which == 0 ? &tc : &ts;
  const float* sh_a = which == 2 ? a.shift_s : a.shift_c;
  // B's row sums: the shift's correction a (B 1)^T, added once (split 0)
  const float* mom_b = blockIdx.y == 0 && sh_a ? (which == 0 ? a.mom_c : a.mom_s) : nullptr;
  float* out = which == 0 ? a.gcc : (which == 1 ? a.gcs : a.gss);
  const int kt0 = blockIdx.y * a.kt_per_split;
  const int kt1 = min(a.n_kt, kt0 + a.kt_per_split);
  const int n_it = kt1 - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GX_STAGES; ++s) {
      hop::mbar_init(landed(s), 1);
      hop::mbar_init(full(s), GX_SPLITTERS);
      hop::mbar_init(empty(s), 2);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int t = threadIdx.x % 128;
  if (wg == 0) {
    // the consumers hold two accumulators: registers move to them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = t / 32;
    if (warp == 0) {
      // ---- one thread keeps the TMA loads in flight
      if (t == 0) {
        for (int it = 0; it < n_it; ++it) {
          const int s = it % GX_STAGES;
          hop::mbar_wait(empty(s), ((it / GX_STAGES) & 1) ^ 1);
          hop::fence_proxy_async();
          hop::mbar_expect_tx(landed(s), 2 * GX_TILE_BYTES);
          const int k0 = (kt0 + it) * GX_BK;
          hop::tma_load_2d(a_sm(s), ta, landed(s), k0, bi * GX_T);
          hop::tma_load_2d(b_hi(s), tb, landed(s), k0, bj * GX_T);
        }
      }
    } else {
      // ---- warps 1-3 split each landed B tile into hi (in place) and lo,
      // their 11 float4s a thread unrolled so the loads overlap
      const int u = t - 32;
      uint8_t* sb = smem_raw + (base - raw);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % GX_STAGES;
        hop::mbar_wait(landed(s), (it / GX_STAGES) & 1);
        float4* hi = reinterpret_cast<float4*>(sb + (b_hi(s) - base));
        float4* lo = reinterpret_cast<float4*>(sb + (b_lo(s) - base));
#pragma unroll
        for (int j = 0; j < (GX_TILE_BYTES / 16 + GX_SPLITTERS - 1) / GX_SPLITTERS; ++j) {
          const int i = u + GX_SPLITTERS * j;
          if (i >= GX_TILE_BYTES / 16) break;
          const float4 v = hi[i];
          uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
          hop::split_tf32(v.x, h0, l0);
          hop::split_tf32(v.y, h1, l1);
          hop::split_tf32(v.z, h2, l2);
          hop::split_tf32(v.w, h3, l3);
          hi[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(h2),
                              __uint_as_float(h3));
          lo[i] = make_float4(__uint_as_float(l0), __uint_as_float(l1), __uint_as_float(l2),
                              __uint_as_float(l3));
        }
        hop::fence_proxy_async();  // B hi and lo are wgmma operands
        hop::mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: warpgroup w owns tile rows 64 w .. 64 w + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = wg - 1;
    const int lane = t % 32;
    const int gq = lane / 4, tq = lane % 4;
    const int r0 = 64 * w + 16 * (t / 32) + gq;  // this thread's tile rows r0 and r0 + 8
    const uint8_t* sb = smem_raw + (base - raw);
    const int ra = bi * GX_T + r0;  // rows ra and ra + 8 of A
    // each stage's products start a fresh wgmma accumulator (part), added to
    // the sum with fp32's rounding to nearest: the tensor cores' additions
    // round toward zero, and over a chunk's k of 2048 into one accumulator
    // the truncations add up to ~1e-5 of a positive diagonal
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    // this stage's draw and its shifts of rows ra and ra + 8, loaded when the
    // draw changes (every kt_per_draw >= 8 stages)
    int e_cur = -1;
    float sh0 = 0.f, sh1 = 0.f;
    for (int it = 0; it < n_it; ++it) {
      const int s = it % GX_STAGES;
      const int e = (kt0 + it) / a.kt_per_draw;
      if (e != e_cur && sh_a) {
        e_cur = e;
        sh0 = ra < a.nf ? __ldg(sh_a + int64_t(ra) * a.draws + e) : 0.f;
        sh1 = ra + 8 < a.nf ? __ldg(sh_a + int64_t(ra + 8) * a.draws + e) : 0.f;
      }
      hop::mbar_wait(full(s), (it / GX_STAGES) & 1);
      const uint8_t* at = sb + (a_sm(s) - base);
      uint32_t hi[GX_BK / 8][4], lo[GX_BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < GX_BK / 8; ++kk) {
        const int k = 8 * kk + tq;
        const float v0 = *reinterpret_cast<const float*>(at + hop::sw128_f32(r0, k));
        const float v1 = *reinterpret_cast<const float*>(at + hop::sw128_f32(r0 + 8, k));
        const float v2 = *reinterpret_cast<const float*>(at + hop::sw128_f32(r0, k + 4));
        const float v3 = *reinterpret_cast<const float*>(at + hop::sw128_f32(r0 + 8, k + 4));
        hop::split_tf32(v0 - sh0, hi[kk][0], lo[kk][0]);
        hop::split_tf32(v1 - sh1, hi[kk][1], lo[kk][1]);
        hop::split_tf32(v2 - sh0, hi[kk][2], lo[kk][2]);
        hop::split_tf32(v3 - sh1, hi[kk][3], lo[kk][3]);
      }
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GX_BK / 8; ++kk)
        hop::wgmma_tf32x3_n128(part, hi[kk], lo[kk], hop::desc_sw128(b_hi(s) + kk * 32),
                               hop::desc_sw128(b_lo(s) + kk * 32), kk);
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(part);
      hop::fence_regs(hi);
      hop::fence_regs(lo);
      if (t == 0) hop::mbar_arrive(empty(s));
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = bi * GX_T + r0 + 8 * i;
      if (r >= a.nf) continue;
      float* row = out + int64_t(r) * a.nf;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = bj * GX_T + 8 * j + 2 * tq + e;
          if (c >= a.nf) continue;
          float v = acc[4 * j + 2 * i + e];
          if (mom_b) {
            float corr = 0.f;
            for (int d = 0; d < a.draws; ++d)
              corr = fmaf(sh_a[int64_t(r) * a.draws + d],
                          mom_b[int64_t(c) * 2 * a.draws + 2 * d + 1], corr);
            v += corr;
          }
          if (a.split > 1)
            atomicAdd(row + c, v);
          else
            row[c] += v;
        }
    }
  }
}

// a 2-d map of an (nf, K) fp32 slab, boxes of 32 k x 128 rows, 128-byte swizzle
inline bool make_slab_map(CUtensorMap* map, const void* ptr, int nf, int K) {
  cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)nf};
  cuuint64_t strides[1] = {(cuuint64_t)K * 4};
  cuuint32_t box[2] = {(cuuint32_t)GX_BK, (cuuint32_t)GX_T};
  cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the k split for nf features and K columns: enough blocks for about four
// waves where the tiles alone are fewer, at least 8 k-tiles a block
inline int gram_tf32_split(int nf, int K, int sms) {
  const int t = (nf + GX_T - 1) / GX_T;
  const int tiles = t * (t + 1) + t * t;
  const int n_kt = K / GX_BK;
  const int most = n_kt / 8 > 1 ? n_kt / 8 : 1;
  const int split = (4 * sms + tiles - 1) / tiles;
  return split < most ? split : most;
}

// K = draws x bc columns, bc a multiple of 32 (the workspace's chunk widths
// are of 256); shift_c, shift_s (nf, draws) or null; mom_c, mom_s the
// moments (nf, 2 draws) at the last chunk, else null
inline cudaError_t launch_gram_tf32(const float* wc, const float* ws, int nf, int K, int bc,
                                    float* gcc, float* gcs, float* gss, const float* shift_c,
                                    const float* shift_s, const float* mom_c, const float* mom_s,
                                    cudaStream_t stream) {
  if (K % GX_BK != 0 || bc % GX_BK != 0 || K % bc != 0) return cudaErrorInvalidValue;
  CUtensorMap tc, ts;
  if (!make_slab_map(&tc, wc, nf, K) || !make_slab_map(&ts, ws, nf, K))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int t = (nf + GX_T - 1) / GX_T;
  const int tiles = t * (t + 1) + t * t;
  GxArgs a{nf, K / GX_BK, 0, gram_tf32_split(nf, K, sms), gcc, gcs, gss,
           shift_c, shift_s, bc / GX_BK, K / bc, mom_c, mom_s};
  a.kt_per_split = (a.n_kt + a.split - 1) / a.split;
  a.split = (a.n_kt + a.kt_per_split - 1) / a.kt_per_split;
  cudaError_t err = cudaFuncSetAttribute(gram_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GX_SMEM);
  if (err != cudaSuccess) return err;
  gram_tf32_kernel<<<dim3(tiles, a.split), 384, GX_SMEM, stream>>>(tc, ts, a);
  return cudaGetLastError();
}

}  // namespace rt
