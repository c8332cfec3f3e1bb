// The Gram products on Hopper's tensor cores, fp32-accurate as three tf32
// products, one design for every Gram of the port:
//   - the streamed Gram accumulate (kCentered = false): G_cc += C C^T, G_cs
//     += C S^T, G_ss += S S^T over one chunk's k = S bc columns of the cos
//     and sin slabs, whether Omega is an operand or drawn;
//   - the centered Gram (kCentered = true): G = (Sigma - mu 1^T)(Sigma -
//     mu 1^T)^T over the n samples of Sigma (2N, n).
//
// Replaces the Gram stage of src/repro/kernels/rff_gram_stream.py:244
// (rff_gram_stream_pallas, K2), :180 (its tiled form, K3), :524
// (rff_gram_stream_fused_pallas, K5) and :587 (its tiled form, K6), and
// src/repro/kernels/centered_gram.py:38 (centered_gram_pallas, K8).
//
// Bound: operations, ~4 S n N^2 fp32-accurate FLOP with the symmetry for
// the streamed Gram, (2N)^2 n for the centered one, 3x that on the tf32
// tensor cores (495 TFLOP/s dense).  A 128 x 128 tile reads 32 KB a k-step
// of 32 for 1 MFLOP of fp32-equivalent work, so at the split-TF32 rate it
// leans on the L2 (the slabs of one chunk, 30-64 MB, or Sigma, 30-118 MB,
// are read by every tile of a row or column).
//
// Design:
//   - Both operands are rows of one (rows, K) matrix, K-major as tf32 wgmma
//     needs.  A (tile rows) comes from shared memory into registers, split
//     there into hi = tf32(v) and lo = tf32(v - hi); B (tile columns) is
//     split once a stage by the producer warpgroup into hi (in place) and lo
//     tiles, so the operand stays one fp32 matrix in device memory (pre-split
//     slabs would halve the chunk width and double the read-modify-writes of
//     the N^2 accumulators).  Each k-step runs three wgmma m64n128k8 into one
//     fp32 accumulator, the two small terms first (A_lo B_hi, A_hi B_lo, A_hi
//     B_hi).  The tensor cores' fp32 additions round toward zero, which over a
//     chunk's k (2048 at N = 4096, S = 4) biases a positive diagonal by ~1e-5
//     of its size, half the gate; so each stage (k of 32) starts a fresh
//     wgmma accumulator, added to the block's sum in registers with fp32's
//     rounding to nearest (~5e-7: tests/test_torch_split_tf32_numerics.py).
//   - Warp-specialised: one producer thread keeps a 4-stage TMA ring of A and
//     B tiles (32 k x 128 rows each, 128-byte swizzle, rows past the matrix
//     and k past its columns zero-filled) in flight; producer warps 1-3 split
//     B (an issuing thread that also split measured slower: its waits for
//     free stages held the splits back); consumer warpgroups 1 and 2 own 64
//     tile rows each.
//   - Streamed Gram, A shifted: each row of the A operand (C for G_cc and
//     G_cs, S for G_ss) is taken less its draw's shift a (the row's mean over
//     that draw's columns of the first chunk, from the moments), so the
//     products are (A - a 1^T) B^T; the last chunk's launch adds a (B 1)^T,
//     B 1 the moments' column sums over every chunk.  With small phases a row
//     of C is nearly constant and G_H is a cancellation of G_cc; products of
//     the unshifted rows (each value split into two tf32 parts, ~2^-22 of it
//     lost) came out farther from the float64 answer than fp32's sgemm
//     (H100: 1.5e-5 against 1.2e-5 at N = 65, p = 40, sigma = 28).  A
//     shifted row is small, and so are the split's losses on both operands
//     of its products (tests/test_torch_split_tf32_numerics.py).
//   - Centered Gram, both operands shifted: A less mu in registers as above,
//     B less mu in the splitters' pass, and no add-back.  A one-sided shift
//     would leave ((Sigma - mu 1^T) 1) mu^T, mu times the rounding residue of
//     the mean: on nearly constant rows (cos rows at small phases) that is
//     past the 1e-5 gate.  n need not be a multiple of 32: TMA fills the
//     columns past n with 0, which the shift would turn into -mu (a bias of
//     pad mu_i mu_j an entry), so columns at or past n are masked to 0 after
//     the shift, in both operands.  One product, upper tiles only.
//   - The grid walks the upper tiles of the symmetric products (G_cc, G_ss,
//     the centered G; the wrappers mirror them) and every tile of G_cs.
//     Where those tiles are too few for the card (K5's and K2's 136 at N =
//     1000, K8's 136 at 2N = 2000, on 132 SMs) the k axis is split across
//     blocks (`split`, from the shape alone: gram_split_plan in
//     kernels/rff_gram_stream.py, for an H100's 132 SMs whatever card runs
//     it).  Each block writes its partial tile to a workspace (in the
//     fragments' order, 16-byte stores) and a second kernel adds each tile's
//     partials in split order, 0 first, into the output.  The sum then has
//     one order, so two identical calls agree bit for bit on any H100; for
//     the centered Gram it writes both triangles, the wrapper's mirror.  The
//     products lose the red.global.add they had (K2's 0.271 -> 0.246 ms on
//     an H100) and the sum takes 0.035-0.039 ms (PERF.md); a last-block sum
//     inside the Gram kernel held each tile's last SM once a wave and was
//     slower.  With split = 1 each tile is read, added to and written back,
//     in a fixed order.  The centered Gram on bf16 Sigma is gram_bf16.cuh's,
//     on the bf16 tensor cores; it shares the split's sum.
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
// + the landed, full and empty barriers
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
  int k_valid;  // columns at or past it are padding, masked after the shift (centered)
  // split > 1: the partial tiles (tiles, split, GX_T, GX_T)
  float* ws;
};

// tile q of the upper triangle, column-major: (bi, bj) with bi <= bj
__device__ __forceinline__ void upper_tile(int q, int& bi, int& bj) {
  int j = static_cast<int>((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
  while (j * (j + 1) / 2 > q) --j;
  while ((j + 1) * (j + 2) / 2 <= q) ++j;
  bj = j;
  bi = q - j * (j + 1) / 2;
}

// output tile q: which product (0 G_cc, 1 G_cs, 2 G_ss) and its tile (bi,
// bj): the upper G_cc tiles, every G_cs tile, the upper G_ss tiles (centered:
// the upper tiles of its one product)
template <bool kCentered>
__device__ __forceinline__ void gram_tile(int q, int nf, int& which, int& bi, int& bj) {
  const int t_side = (nf + GX_T - 1) / GX_T;
  const int n_up = t_side * (t_side + 1) / 2;
  if (kCentered || q < n_up) {
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
}

// kCentered: one product (G_cc's slot) of the (nf, K) matrix with itself,
// both operands less shift_c (mu, draws = 1), columns >= k_valid masked
template <bool kCentered>
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
  // (centered: the upper tiles of its one product)
  const int tile_id = blockIdx.x, split_id = blockIdx.y;
  int which, bi, bj;
  gram_tile<kCentered>(tile_id, a.nf, which, bi, bj);
  const CUtensorMap* ta = which == 2 ? &ts : &tc;
  const CUtensorMap* tb = which == 0 ? &tc : &ts;
  const float* sh_a = which == 2 ? a.shift_s : a.shift_c;
  // B's row sums: the shift's correction a (B 1)^T, added once (split 0)
  const float* mom_b = split_id == 0 && sh_a ? (which == 0 ? a.mom_c : a.mom_s) : nullptr;
  float* out = which == 0 ? a.gcc : (which == 1 ? a.gcs : a.gss);
  const int kt0 = split_id * a.kt_per_split;
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
        auto split = [&](int i, float4 v) {
          uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
          hop::split_tf32(v.x, h0, l0);
          hop::split_tf32(v.y, h1, l1);
          hop::split_tf32(v.z, h2, l2);
          hop::split_tf32(v.w, h3, l3);
          hi[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(h2),
                              __uint_as_float(h3));
          lo[i] = make_float4(__uint_as_float(l0), __uint_as_float(l1), __uint_as_float(l2),
                              __uint_as_float(l3));
        };
        if constexpr (kCentered) {
          // B less mu, the columns past k_valid masked after the shift; one
          // float4 at a time (unrolled with the means it spilled at 40
          // registers).  float4 i holds row i / 8, swizzled chunk i % 8:
          // columns k .. k + 3
          const int k0 = (kt0 + it) * GX_BK;
#pragma unroll 1
          for (int i = u; i < GX_TILE_BYTES / 16; i += GX_SPLITTERS) {
            const int r = i / 8;
            const int k = k0 + 4 * ((i % 8) ^ (r % 8));
            const int gr = bj * GX_T + r;
            const float m = gr < a.nf ? __ldg(a.shift_c + gr) : 0.f;
            float4 v = hi[i];
            v.x = k < a.k_valid ? v.x - m : 0.f;
            v.y = k + 1 < a.k_valid ? v.y - m : 0.f;
            v.z = k + 2 < a.k_valid ? v.z - m : 0.f;
            v.w = k + 3 < a.k_valid ? v.w - m : 0.f;
            split(i, v);
          }
        } else {
#pragma unroll
          for (int j = 0; j < (GX_TILE_BYTES / 16 + GX_SPLITTERS - 1) / GX_SPLITTERS; ++j) {
            const int i = u + GX_SPLITTERS * j;
            if (i >= GX_TILE_BYTES / 16) break;
            split(i, hi[i]);
          }
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
      // the centered Gram masks the padding columns after the shift
      const int k_pad = kCentered ? a.k_valid - (kt0 + it) * GX_BK : GX_BK;
      uint32_t hi[GX_BK / 8][4], lo[GX_BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < GX_BK / 8; ++kk) {
        const int k = 8 * kk + tq;
        const float v0 = *reinterpret_cast<const float*>(at + hop::sw128_f32(r0, k));
        const float v1 = *reinterpret_cast<const float*>(at + hop::sw128_f32(r0 + 8, k));
        const float v2 = *reinterpret_cast<const float*>(at + hop::sw128_f32(r0, k + 4));
        const float v3 = *reinterpret_cast<const float*>(at + hop::sw128_f32(r0 + 8, k + 4));
        hop::split_tf32(k < k_pad ? v0 - sh0 : 0.f, hi[kk][0], lo[kk][0]);
        hop::split_tf32(k < k_pad ? v1 - sh1 : 0.f, hi[kk][1], lo[kk][1]);
        hop::split_tf32(k + 4 < k_pad ? v2 - sh0 : 0.f, hi[kk][2], lo[kk][2]);
        hop::split_tf32(k + 4 < k_pad ? v3 - sh1 : 0.f, hi[kk][3], lo[kk][3]);
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

    // the shift's correction a (B 1)^T, added by split 0 at the last chunk
    auto add_corr = [&](int i, int j, int e, float v) {
      const int r = bi * GX_T + r0 + 8 * i, c = bj * GX_T + 8 * j + 2 * tq + e;
      if (mom_b && r < a.nf && c < a.nf) {
        float corr = 0.f;
        for (int d = 0; d < a.draws; ++d)
          corr = fmaf(sh_a[int64_t(r) * a.draws + d],
                      mom_b[int64_t(c) * 2 * a.draws + 2 * d + 1], corr);
        v += corr;
      }
      return v;
    };
    if (a.split > 1) {
      // the partial to the workspace in the fragments' order (thread u's 64
      // values contiguous), for gram_split_reduce_kernel
      const int u = threadIdx.x - 128;  // the consumer thread, 0 .. 255
      float4* mine = reinterpret_cast<float4*>(
          a.ws + (int64_t(tile_id) * a.split + split_id) * GX_T * GX_T + u * 64);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        float v[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int idx = 4 * q + h;  // = 4 j + 2 i + e
          v[h] = add_corr((idx / 2) % 2, idx / 4, idx % 2, acc[idx]);
        }
        __stcg(mine + q, make_float4(v[0], v[1], v[2], v[3]));
      }
      return;
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
          row[c] += add_corr(i, j, e, acc[4 * j + 2 * i + e]);
        }
    }
  }
}

// The k split's sum: a tile's fragments over four blocks of 256 threads,
// thread u of block (tile, quarter) taking that quarter of the fragment of
// the Gram kernel's consumer thread u, the splits' partials added in split
// order, 0 first, then into the output.  The sum has one order whichever
// blocks ran first, so identical calls agree bit for bit.
template <bool kCentered>
__global__ void __launch_bounds__(256)
gram_split_reduce_kernel(const GxArgs a) {
  const int u = threadIdx.x, w = u / 128, t = u % 128, lane = t % 32, qt = blockIdx.y;
  const int r0 = 64 * w + 16 * (t / 32) + lane / 4, tq = lane % 4;
  int which, bi, bj;
  gram_tile<kCentered>(blockIdx.x, a.nf, which, bi, bj);
  float* out = which == 0 ? a.gcc : (which == 1 ? a.gcs : a.gss);
  const float4* ws = reinterpret_cast<const float4*>(
      a.ws + int64_t(blockIdx.x) * a.split * GX_T * GX_T) + u * 16 + 4 * qt;
  float v[16];
#pragma unroll 1
  for (int sp = 0; sp < a.split; ++sp) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 p = __ldcg(ws + sp * (GX_T * GX_T / 4) + q);
      v[4 * q] = sp == 0 ? p.x : v[4 * q] + p.x;
      v[4 * q + 1] = sp == 0 ? p.y : v[4 * q + 1] + p.y;
      v[4 * q + 2] = sp == 0 ? p.z : v[4 * q + 2] + p.z;
      v[4 * q + 3] = sp == 0 ? p.w : v[4 * q + 3] + p.w;
    }
  }
  // fragment values 16 qt .. 16 qt + 15: (j, i, e) with 4 j + 2 i + e.  The
  // centered Gram (one launch into a zero G) is written mirrored, as the
  // wrapper's mirror_upper would make it: G[c][r] = G[r][c] for c > r
#pragma unroll
  for (int h = 0; h < 16; ++h) {
    const int idx = 16 * qt + h, j = idx / 4, i = (idx / 2) % 2, e = idx % 2;
    const int r = bi * GX_T + r0 + 8 * i, c = bj * GX_T + 8 * j + 2 * tq + e;
    if (r >= a.nf || c >= a.nf) continue;
    if constexpr (kCentered) {
      if (c >= r) {
        out[int64_t(r) * a.nf + c] = v[h];
        out[int64_t(c) * a.nf + r] = v[h];
      }
    } else {
      out[int64_t(r) * a.nf + c] += v[h];
    }
  }
}

// split ways of kt_per_split k-tiles each over `tiles` output tiles; split
// > 1 needs a.ws (tiles x split x GX_T^2 floats) and adds the splits by
// gram_split_reduce_kernel.  The split comes from the caller (the shape
// alone), never from the card.
template <bool kCentered>
inline cudaError_t launch_gram_tf32_kernel(const CUtensorMap& ta, const CUtensorMap& tb, int tiles,
                                           int split, int kt_per_split, GxArgs a,
                                           cudaStream_t stream) {
  if (split < 1 || kt_per_split < 1 || (split - 1) * kt_per_split >= a.n_kt ||
      split * kt_per_split < a.n_kt || (split > 1 && !a.ws))
    return cudaErrorInvalidValue;
  a.split = split;
  a.kt_per_split = kt_per_split;
  cudaError_t err = cudaFuncSetAttribute(gram_tf32_kernel<kCentered>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GX_SMEM);
  if (err != cudaSuccess) return err;
  gram_tf32_kernel<kCentered><<<dim3(tiles, split), 384, GX_SMEM, stream>>>(ta, tb, a);
  if (split > 1) gram_split_reduce_kernel<kCentered><<<dim3(tiles, 4), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace rt
