// The centered Gram on bf16 Sigma on Hopper's bf16 tensor cores:
// G = (Sigma - mu 1^T)(Sigma - mu 1^T)^T in fp32, mu the row mean rounded to
// bf16 (the wrapper's, as the reference takes it).
//
// Replaces src/repro/kernels/centered_gram.py:38 (centered_gram_pallas, K8)
// where Sigma is bf16, as its tests sweep it (tests/test_kernels.py:29).
//
// Bound: operations, (2N)^2 n FLOP over the upper tiles on the bf16 tensor
// cores (989 TFLOP/s dense), against 2N n * 2 bytes read and (2N)^2 * 4
// written; this route does 4x that work.
//
// Design:
//   - The operands are fp32's c = a - mu in two bf16 parts, hi = bf16(c) and
//     lo = bf16(c - hi) (c - hi is exact).  For any two bf16 values a and mu,
//     hi + lo is fp32's c exactly: where a and mu are near in size, c - hi
//     has at most 8 significant bits; where |a| is under half a bf16 step
//     of mu, hi = -mu and lo = a.  (Checked over every bf16 a against every
//     mu in [1, 2).)  The product runs as four bf16 wgmma m64n128k16 a k-step
//     of 16 into one fp32 accumulator, the small terms first (lo lo, lo hi,
//     hi lo, hi hi), so each k-step adds c_a c_b exactly.  lo lo is needed:
//     |lo| reaches 2^-8 |c|, and on rows with many equal elements its terms
//     add up to ~1e-5 of max|G|, K8's gate (tests/test_torch_bf16_numerics.py).
//     On nearly constant rows (cos rows at small phases), where G cancels, c
//     is a few bf16 steps of mu and fits hi alone.  One uncentred product with
//     the rank-one correction -s mu^T - mu s^T + n mu mu^T (a quarter of the
//     work) misses the gate there, up to 8x.
//   - One producer thread keeps a 4-stage TMA ring of the A and B tiles
//     (64 k x 128 rows of bf16 each: one 128-byte swizzled row a row, rows
//     past 2N and k past n zero-filled).  Consumer warpgroups 1 and 2 own 64
//     tile rows each and make A's parts in registers (the wgmma RS form); both
//     take each landed B tile less mu, mask the columns at or past n to 0
//     after the shift (TMA's zero fill would become -mu: gram_tf32.cuh) and
//     split it into hi (in place) and lo tiles, then meet at a named barrier.
//     Three producer warps splitting B, as gram_tf32.cuh's do, fell behind
//     the products on an H100: the split's ~10 instructions a value pair
//     need the consumers' eight warps.
//   - The tensor cores' fp32 additions round toward zero, so the accumulator
//     is folded into the sum in registers (fp32's rounding to nearest) every
//     two stages (128 of k).  Inside a fold the second stage's products are
//     issued while the first's run (wgmma.wait_group 1), the two stages' A
//     parts in separate registers; the two consumers fill each other's fold.
//   - Upper tiles only; the k split (gram_split_plan at k-tiles of 64, from
//     the shape alone) and its sum in split order by gram_tf32.cuh's
//     gram_split_reduce_kernel, which writes both triangles.  Without a split
//     each tile writes itself and its mirror (a diagonal tile its upper half
//     both ways), so G is exactly symmetric and every element is written.
#pragma once
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "gram_tf32.cuh"
#include "hopper.cuh"

namespace rt {

constexpr int GB_BK = 64;  // k a stage: one 128-byte swizzled row of bf16
constexpr int GB_STAGES = 4;
constexpr int GB_TILE_BYTES = GX_T * GB_BK * 2;  // 16 KB
// a stage holds A, B (hi in place) and B lo
constexpr int GB_STAGE_BYTES = 3 * GB_TILE_BYTES;
// + the landed and empty barriers
constexpr int GB_SMEM = 1024 + GB_STAGES * GB_STAGE_BYTES + 16 * GB_STAGES;
static_assert(GB_STAGE_BYTES % 1024 == 0, "stages must keep the swizzle phase");
// the B rows a consumer thread splits: 256 threads, 8 chunks a row
constexpr int GB_SPLIT_ROWS = GX_T * 8 / 256;

// byte offset of element (row, k) in a 128-byte-swizzled tile of bf16 rows of
// 64 values (the layout a CU_TENSOR_MAP_SWIZZLE_128B load writes)
__device__ __forceinline__ uint32_t sw128_bf16(int row, int k) {
  return static_cast<uint32_t>(row * 128 + ((((k >> 3) ^ row) & 7) << 4) + (k & 7) * 2);
}

// (c0, c1) as bf16 pairs hi = bf16(c), lo = bf16(c - hi) (c - hi is exact)
__device__ __forceinline__ void split_pair(float c0, float c1, uint32_t& hi, uint32_t& lo) {
  hi = hop::pack_bf16(c0, c1);
  lo = hop::pack_bf16(c0 - __uint_as_float(hi << 16), c1 - __uint_as_float(hi & 0xFFFF0000u));
}

// a consumer thread's share of one stage's B tile (rows row0 .. of Sigma):
// chunk u % 8 (8 values) of rows u / 8 + 32 j, less their means mu, masked at
// or past k_pad (kTail: the stage reaches past n), into hi (in place) and
// lo.  Chunk c of row r holds k 8 (c ^ (r % 8)) .. + 7
template <bool kTail>
__device__ __forceinline__ void gb_split_b(uint4* hi, uint4* lo, int u, const float* mu, int row0,
                                           int nf, int k_pad) {
  const int cc = u % 8;
#pragma unroll
  for (int j = 0; j < GB_SPLIT_ROWS; ++j) {
    const int r = u / 8 + 32 * j;
    const int i = 8 * r + cc, k = 8 * (cc ^ (r % 8));
    const float m = row0 + r < nf ? __ldg(mu + row0 + r) : 0.f;
    const uint4 v = hi[i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float c0 = __uint_as_float(w[q] << 16) - m;
      const float c1 = __uint_as_float(w[q] & 0xFFFF0000u) - m;
      split_pair(!kTail || k + 2 * q < k_pad ? c0 : 0.f,
                 !kTail || k + 2 * q + 1 < k_pad ? c1 : 0.f, h[q], l[q]);
    }
    hi[i] = make_uint4(h[0], h[1], h[2], h[3]);
    lo[i] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// a consumer's A parts of one stage from its tile `at`: the fragment words
// (r0, k), (r0 + 8, k), (r0, k + 8), (r0 + 8, k + 8) for k = 16 kk + 2 tq,
// less the rows' means sh0 and sh1, the columns at or past k_pad masked
// (kTail: the stage reaches past n)
template <bool kTail>
__device__ __forceinline__ void gb_load_parts(const uint8_t* at, int r0, int tq, float sh0,
                                              float sh1, int k_pad, uint32_t (&hi)[4][4],
                                              uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < GB_BK / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 16 * kk + 2 * tq + 8 * (q / 2);
      const float m = q % 2 ? sh1 : sh0;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(at + sw128_bf16(r0 + 8 * (q % 2), k));
      split_pair(!kTail || k < k_pad ? __uint_as_float(v << 16) - m : 0.f,
                 !kTail || k + 1 < k_pad ? __uint_as_float(v & 0xFFFF0000u) - m : 0.f, hi[kk][q],
                 lo[kk][q]);
    }
}

// a landed stage (A tile at `at`, B's hi tile at byte b_off of `sb`, its lo
// tile one tile further): B split by both consumers, who then meet, and this
// thread's A parts
__device__ __forceinline__ void gb_stage(const uint8_t* at, uint32_t b_off, uint8_t* sb, int u,
                                         int r0, int tq, float sh0, float sh1, const float* mu,
                                         int row0, int nf, int k_pad, uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
  uint4* bh = reinterpret_cast<uint4*>(sb + b_off);
  uint4* bl = reinterpret_cast<uint4*>(sb + b_off + GB_TILE_BYTES);
  if (k_pad >= GB_BK) {
    gb_split_b<false>(bh, bl, u, mu, row0, nf, k_pad);
    hop::fence_proxy_async();  // B hi and lo are wgmma operands
    hop::named_sync(1, 256);
    gb_load_parts<false>(at, r0, tq, sh0, sh1, k_pad, hi, lo);
  } else {
    gb_split_b<true>(bh, bl, u, mu, row0, nf, k_pad);
    hop::fence_proxy_async();
    hop::named_sync(1, 256);
    gb_load_parts<true>(at, r0, tq, sh0, sh1, k_pad, hi, lo);
  }
}

// one stage's products into `part`, lo lo, lo hi, hi lo, hi hi a k-step (B's
// hi and lo tiles at b_hi and b_lo), committed as one group; `first` starts
// `part`
__device__ __forceinline__ void gb_products(float (&part)[64], const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4], uint32_t b_hi,
                                            uint32_t b_lo, bool first) {
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < GB_BK / 16; ++kk) {
    const uint64_t dh = hop::desc_sw128(b_hi + kk * 32);
    const uint64_t dl = hop::desc_sw128(b_lo + kk * 32);
    hop::wgmma_rs_n128(part, lo[kk], dl, first && kk == 0 ? 0 : 1);
    hop::wgmma_rs_n128(part, lo[kk], dh);
    hop::wgmma_rs_n128(part, hi[kk], dl);
    hop::wgmma_rs_n128(part, hi[kk], dh);
  }
  hop::wgmma_commit();
}

// a.shift_c is mu (a.nf rows), a.k_valid = n, a.n_kt k-tiles of GB_BK; out
// a.gcc (nf, nf), written whole
__global__ void __launch_bounds__(384, 1)
gram_bf16_kernel(const __grid_constant__ CUtensorMap ts, const GxArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sb = smem_raw + (base - raw);
  const uint32_t bars = base + GB_STAGES * GB_STAGE_BYTES;
  auto a_sm = [&](int s) { return base + s * GB_STAGE_BYTES; };
  auto b_hi = [&](int s) { return a_sm(s) + GB_TILE_BYTES; };
  auto b_lo = [&](int s) { return a_sm(s) + 2 * GB_TILE_BYTES; };
  auto landed = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (GB_STAGES + s); };

  const int tile_id = blockIdx.x, split_id = blockIdx.y;
  int bi, bj;
  upper_tile(tile_id, bi, bj);
  const int kt0 = split_id * a.kt_per_split;
  const int n_it = min(a.n_kt, kt0 + a.kt_per_split) - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GB_STAGES; ++s) {
      hop::mbar_init(landed(s), 1);
      hop::mbar_init(empty(s), 2);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int t = threadIdx.x % 128;
  if (wg == 0) {
    // ---- one thread keeps the TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (t == 0) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % GB_STAGES;
        hop::mbar_wait(empty(s), ((it / GB_STAGES) & 1) ^ 1);
        hop::fence_proxy_async();  // after the consumers' reads and writes
        const int k0 = (kt0 + it) * GB_BK;
        hop::mbar_expect_tx(landed(s), 2 * GB_TILE_BYTES);
        hop::tma_load_2d(a_sm(s), &ts, landed(s), k0, bi * GX_T);
        hop::tma_load_2d(b_hi(s), &ts, landed(s), k0, bj * GX_T);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns tile rows 64 w .. 64 w + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int w = wg - 1;
  const int lane = t % 32, gq = lane / 4, tq = lane % 4;
  const int r0 = 64 * w + 16 * (t / 32) + gq;  // this thread's tile rows r0 and r0 + 8
  const int ra = bi * GX_T + r0;
  const float sh0 = ra < a.nf ? __ldg(a.shift_c + ra) : 0.f;
  const float sh1 = ra + 8 < a.nf ? __ldg(a.shift_c + ra + 8) : 0.f;
  const int u = threadIdx.x - 128;  // the consumer thread, 0 .. 255
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  auto release = [&](int it) {
    if (t == 0) hop::mbar_arrive(empty(it % GB_STAGES));
  };
  uint32_t hi0[4][4], lo0[4][4], hi1[4][4], lo1[4][4];
#pragma unroll 1
  for (int it = 0; it < n_it; it += 2) {
    // one fold: two stages, the second's products issued while the first's run
    int s = it % GB_STAGES;
    hop::mbar_wait(landed(s), (it / GB_STAGES) & 1);
    gb_stage(sb + (a_sm(s) - base), b_hi(s) - base, sb, u, r0, tq, sh0, sh1, a.shift_c,
             bj * GX_T, a.nf, a.k_valid - (kt0 + it) * GB_BK, hi0, lo0);
    gb_products(part, hi0, lo0, b_hi(s), b_lo(s), true);
    if (it + 1 < n_it) {
      s = (it + 1) % GB_STAGES;
      hop::mbar_wait(landed(s), ((it + 1) / GB_STAGES) & 1);
      gb_stage(sb + (a_sm(s) - base), b_hi(s) - base, sb, u, r0, tq, sh0, sh1, a.shift_c,
               bj * GX_T, a.nf, a.k_valid - (kt0 + it + 1) * GB_BK, hi1, lo1);
      gb_products(part, hi1, lo1, b_hi(s), b_lo(s), false);
      hop::wgmma_wait<1>();
      hop::fence_regs(hi0);
      hop::fence_regs(lo0);
      release(it);
      hop::wgmma_wait<0>();
      hop::fence_regs(hi1);
      hop::fence_regs(lo1);
      release(it + 1);
    } else {
      hop::wgmma_wait<0>();
      hop::fence_regs(hi0);
      hop::fence_regs(lo0);
      release(it);
    }
    hop::fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  if (a.split > 1) {
    // the partial to the workspace in the fragments' order (thread u's 64
    // values contiguous), for gram_split_reduce_kernel
    float4* mine = reinterpret_cast<float4*>(
        a.ws + (int64_t(tile_id) * a.split + split_id) * GX_T * GX_T + u * 64);
#pragma unroll
    for (int q = 0; q < 16; ++q)
      __stcg(mine + q, make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]));
    return;
  }
  // the tile and its mirror: G[r][c] and G[c][r], a diagonal tile's c >= r only
  const bool diag = bi == bj;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    if (r >= a.nf) continue;
    float* row = a.gcc + int64_t(r) * a.nf;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = bj * GX_T + 8 * j + 2 * tq + e;
        if (c >= a.nf || (diag && c < r)) continue;
        const float v = acc[4 * j + 2 * i + e];
        row[c] = v;
        a.gcc[int64_t(c) * a.nf + r] = v;
      }
  }
}

// the upper tiles of the centered Gram of bf16 Sigma (ts: 64 k x 128 rows
// boxes, 128-byte swizzle), split ways of kt_per_split k-tiles of GB_BK; split
// > 1 needs a.ws (tiles x split x GX_T^2 floats) and adds the splits by
// gram_split_reduce_kernel.  The split comes from the caller (the shape
// alone), never from the card.
inline cudaError_t launch_gram_bf16_kernel(const CUtensorMap& ts, int tiles, int split,
                                           int kt_per_split, GxArgs a, cudaStream_t stream) {
  if (split < 1 || kt_per_split < 1 || (split - 1) * kt_per_split >= a.n_kt ||
      split * kt_per_split < a.n_kt || (split > 1 && !a.ws))
    return cudaErrorInvalidValue;
  a.split = split;
  a.kt_per_split = kt_per_split;
  cudaError_t err =
      cudaFuncSetAttribute(gram_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GB_SMEM);
  if (err != cudaSuccess) return err;
  gram_bf16_kernel<<<dim3(tiles, split), 384, GB_SMEM, stream>>>(ts, a);
  if (split > 1) gram_split_reduce_kernel<true><<<dim3(tiles, 4), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace rt
