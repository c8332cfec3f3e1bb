// The featurize on Hopper's tensor cores: [cos(Omega X); sin(Omega X)] *
// scale, with Omega either drawn in the kernel (FusedOmega: threefry(seed, e,
// row, col)) or an (N, p) operand loaded by TMA (kOperand).
//
// Replaces src/repro/kernels/rff.py:117 (rff_fused_pallas, K7) and the first
// stage of src/repro/kernels/rff_gram_stream.py:524 and :587
// (rff_gram_stream_fused_pallas and its tiled form, K5/K6), which draw Omega
// in the kernel and never store it; and src/repro/kernels/rff.py:48
// (rff_pallas, K1) and the first stage of rff_gram_stream.py:244 and :180
// (rff_gram_stream_pallas and its tiled form, K2/K3), which read it.
//
// Bound: operations.  The product is fp32-accurate work of 2 N p n FLOP; on
// the tf32 tensor cores (495 TFLOP/s dense) as three products that is 3 x 2 N
// p n / 495e12 s, 2.5x under the fp32 FFMA bound (67 TFLOP/s).  Each drawn
// Omega element costs ~82 integer operations of threefry plus its transform,
// so the draws are the second term, and they grow with how often an element
// is drawn again; an operand Omega costs its bytes only.
//
// Design:
//   - Z^T = X^T Omega^T, so both wgmma operands are K-major as tf32 needs: A
//     is X (p, n), read from its TMA-loaded tile into registers (its k axis
//     is not contiguous, and only registers take any layout), B is the Omega
//     tile, K-major as drawn or loaded.  Every value is split as hi = tf32(v), lo = tf32(v
//     - hi); each k-step runs three wgmma m64n128k8 into one fp32
//     accumulator, the two small terms first (X_lo Om_hi, X_hi Om_lo, then
//     X_hi Om_hi).  One tf32 product keeps 10 mantissa bits and misses the
//     2e-5 gate; three keep ~22 (tests/test_torch_split_tf32_numerics.py).
//   - The tensor cores' fp32 additions round toward zero.  Over p = 2048
//     (768 additions into one accumulator) the truncations biased the
//     phases enough to put chip_smoke.py's G_H 4.3e-5 from plain (H100), so each stage
//     (k of 32) starts a fresh wgmma accumulator that is added to the sum in
//     registers with fp32's rounding to nearest.  The two accumulators are
//     why a consumer warpgroup owns one 64-row block, not two.
//   - Warp-specialised: warpgroups 0 and 1 produce, 2 and 3 consume.  A CTA
//     owns 128 features x 128 samples.  The producers fill a 4-stage ring of
//     k-tiles of 32: the X tile by TMA (four 32-column boxes, 128-byte
//     swizzle; rows of X must be a multiple of 4 floats apart, so the wrapper
//     copies X with zero columns appended where they are not), and this
//     CTA's share of the Omega tile, drawn on the integer and SFU pipes two
//     elements a thread while the consumers' products hold the tensor cores.
//     One producer warpgroup drawing four a thread left the consumers
//     waiting a quarter of the time.
//   - Drawn Omega: once per cluster of CL <= 8 CTAs along the samples
//     (1024 columns), so an element is drawn ceil(n / 1024) times (was
//     ceil(n / 256)).  Each CTA draws 128 / CL feature rows of the tile into
//     its own ring, split into hi and lo and swizzled, and one thread pushes
//     them to the other CTAs with cp.async.bulk shared::cluster copies that
//     count their bytes on the receivers' full barriers (stores into the
//     other CTAs' shared memory needed a cluster-scope proxy fence that cost
//     more than the draws); after a named barrier of the producers, thread r
//     pushes the share to CTA r.  A stage is full once its X and Omega bytes
//     have landed and the local share is drawn, and free once both
//     consumer warpgroups of every CTA have released it (CL x 2 arrivals);
//     CTAs past the columns still draw their share.
//   - Operand Omega (kOperand): one producer thread loads the stage's X boxes
//     and the Omega tile by TMA (boxes of 32 k x 16 feature rows, 128-byte
//     swizzle, so the tile lands in the layout the draws write; rows past N
//     and k past p zero-filled; Omega's rows must be a multiple of 4 floats
//     apart, so the wrapper copies an Omega with p not a multiple of 4 with
//     zero columns appended) onto a `landed` barrier; producer warps 1-7 then
//     split the Omega tile into hi (in place) and lo and release the stage.
//     Each CTA loads its own tile (a cluster of 1; the L2 serves the
//     repeats): on an H100 TMA multicast of the tile timed level across 2
//     CTAs and 1.2-1.5x slower across 4 or 8, as a stage is free only once
//     every CTA of the cluster has released it (PERF.md).
//   - The epilogue stages the phases through shared memory (once every CTA
//     of the cluster is past its products), runs sincosf one element a
//     thread in a rolled loop (unrolled over the accumulator fragment it
//     thrashed the instruction cache) and writes C and S a warp per 32
//     consecutive columns; columns at or past n_valid are written as 0 (a
//     masked sample, not cos(0) = 1), features at or past nf are not written.
//   - Phases the split products may round past the gate are recomputed there
//     in float64: summed in float64 from the fp32 operands (each product
//     exact; the tile on the FP64 tensor cores, 4 k a step, the finishing
//     pass as FMAs over k in order), cos and sin taken in float64 and scaled
//     in float64, then rounded to one of the two fp32 values beside the
//     result: the one on the side of the same feature from fp32's sequential
//     FMA chain over k (cos and sin in fp32, scaled, as plain takes them).
//     The result is within one fp32 ULP of the float64 answer, so no farther
//     from it than plain's fp32 sum in any k order (cuBLAS picks its order by
//     shape; the chain alone matched it at 3612 columns and lay 1e-2 from
//     float64 at 300).  The side matters only at the reference's 2e-5 edge:
//     where plain lies just inside 2e-5 of the float64 answer, the float64
//     answer rounded to nearest can fall just past 2e-5 of plain (7 of K7's
//     14.8 M Cauchy features at 3612 columns on an H100), and rounding toward
//     the chain keeps it inside wherever plain sums in the chain's order.
//     The phases taken:
//     |z| >= 64, where one ULP of z moves cos by >= 4e-6 and the split
//     products round differently, and phases whose terms are large, where a
//     phase under 64 summed from Cauchy terms of ~1e4 cancels: the split
//     products round at ~2^-20 of sum_k |omega_fk x_kc|.
//     That sum is bounded by |omega_f|_2 |x_c|_2, from norms the kernel takes
//     on the way (the producers square each Omega element they draw or split
//     into per-row slots, the consumers each X element they split), and a
//     phase is recomputed where 2^-20 |omega_f| |x_c| scale exceeds a
//     quarter of the 2e-5 gate (FT_CANCEL).  Gaussian draws at the
//     median-heuristic sigma stay below both (the bound under two thirds of
//     the threshold at the smoke's widths); Cauchy draws exceed the bound in
//     every phase (tests/test_torch_split_tf32_numerics.py).  A CTA with
//     any such phase recomputes its whole 128 x 128 tile and keeps the
//     result where the rule asks, in two passes, each the main loop again
//     on fp32 operands: two buffers of 32 k, X by TMA, Omega redrawn once
//     per cluster and pass (each CTA draws its share of the rows and pushes
//     it to the others by bulk copies), first fp32's chain (8 x 8 outputs a
//     thread, 64 registers), then the float64 sums (mma m8n8k4, a warp's
//     32 x 64 outputs in 128 registers a thread; the two do not fit one
//     pass without spills, and FMAs in float64 took ~2.5x the chain's time,
//     a float-to-double conversion per operand use at 16 a cycle); the
//     cluster takes them when any of its CTAs has such a phase.  A sum per
//     element would redraw each Omega element and reload X for every warp
//     that needs it.  A kept phase reaches the output loop as the chain (in
//     the phases) and its float64 sum as two fp32 parts, a byte marking it.
//     An operand Omega is loaded there by TMA as in the main loop.
//   - Split over p (operand Omega, K1 at a transform request's width): where
//     the output tiles are fewer than the SMs (300 columns at N = 1000 are
//     24 tiles on 132 SMs, each walking 64 k-tiles), the grid's z runs over
//     slices of the k-tiles (the wrapper's split_plan), and each CTA writes
//     its folded phase sums to a workspace (slices, nf, ldo) instead of
//     running the epilogue, and its partial squared norms of Omega's rows
//     (the CTAs of the first sample block) and of X's columns (those of the
//     first feature block).  A finishing pass adds the slices in slice order
//     (no atomics: the sum does not depend on the order the CTAs ran in),
//     recomputes from the whole sum and the whole norms, by the epilogue's
//     rule, over all of p as the epilogue recomputes (a slice's partial
//     phase does not say whether the whole phase reaches 64), then takes cos
//     and sin as the epilogue does.
//   - With a counter array, the kernel adds the Omega elements its producers
//     drew, the phases it recomputed and the Omega elements the recompute
//     drew in both its passes (chip_smoke.py reads the draws per element and
//     the recomputed share from them); an operand Omega adds to the phases
//     only.
#pragma once
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "threefry.cuh"

namespace rt {

constexpr int FT_FEATS = 128;    // features a CTA (the wgmma N)
constexpr int FT_COLS = 128;     // sample columns a CTA: 2 consumers x 64 (the wgmma M)
constexpr int FT_BK = 32;        // k a stage: one 128-byte swizzled row
constexpr int FT_STAGES = 4;
constexpr int FT_CLUSTER = 8;    // CTAs along the samples sharing one draw
constexpr int FT_PT = 256;       // producer threads: warpgroups 0 and 1
constexpr int FT_THREADS = FT_PT + 256;  // + consumer warpgroups 2 and 3
constexpr int FT_UNIT = 2;       // consecutive k a producer thread draws at once
constexpr int FT_SPLITTERS = FT_PT - 32;  // operand Omega: producer warps 1-7 split the tile
constexpr int FT_OM_BOX_ROWS = 16;        // operand Omega: a TMA box of 32 k x 16 feature rows
constexpr int FT_OM_BOXES = FT_FEATS / FT_OM_BOX_ROWS;
constexpr int FT_OM_BOX_BYTES = FT_OM_BOX_ROWS * FT_BK * 4;
constexpr int FT_OM_BYTES = FT_FEATS * FT_BK * 4;            // 16 KB, hi or lo
constexpr int FT_XBOX_BYTES = FT_BK * 32 * 4;                // one TMA box: 32 k x 32 samples
constexpr int FT_X_BYTES = (FT_COLS / 32) * FT_XBOX_BYTES;   // 16 KB
constexpr int FT_STAGE_BYTES = 2 * FT_OM_BYTES + FT_X_BYTES;  // 48 KB
constexpr int FT_OUT_LD = FT_COLS + 4;  // epilogue rows: 4 words apart mod 32 banks
constexpr int FT_RK = 32;  // k a step of the epilogue's recompute
constexpr int FT_RK_BYTES = FT_RK * FT_FEATS * 4;  // one Omega or X buffer of a step
// after the ring: its full and empty barriers, the recompute's two full and
// two empty barriers, the recompute flag, the operand path's landed barriers
constexpr int FT_BARS_BYTES = 256;
static_assert(16 * FT_STAGES + 32 + 16 + 8 * FT_STAGES <= FT_BARS_BYTES, "the barriers fit");
// then the norms: up to FT_SLOTS partial sums of squares a feature row (one
// for each producer thread that draws or splits its elements: 16 drawing, 8
// splitting an operand), the rows' squared norms and the columns' (this
// CTA's samples)
constexpr int FT_SLOTS = 16;
static_assert(FT_STAGE_BYTES % 1024 == 0, "stages must keep the swizzle phase");
static_assert(FT_FEATS == FT_COLS, "the recompute stages Omega and X tiles in one loop");
// The epilogue reuses the ring.  The phases first ([feature][sample],
// FT_OUT_LD apart; fp32's chain where the recompute keeps it), then the
// recompute's buffers: Omega [2], 128 feature rows of 32 k laid out as the
// ring's (128-byte swizzled), then X [2] as TMA lands it (4 boxes of 32
// samples, 128-byte swizzled, 1024-aligned); once both passes are done the
// buffers hold the kept phases' float64 sums' high fp32 parts
// ([feature][sample], FT_COLS apart).  Past them, written while the second
// pass streams through the buffers, the low parts ([feature][sample],
// FT_OUT_LD apart) and a byte an element marking the kept ones
// ([feature][sample], FT_COLS apart).
constexpr int FT_RC_OM = (FT_FEATS * FT_OUT_LD * 4 + 1023) / 1024 * 1024;
constexpr int FT_RC_X = FT_RC_OM + 2 * FT_RK_BYTES;
constexpr int FT_RC_HI = FT_RC_OM;
constexpr int FT_RC_LO = FT_RC_X + 2 * FT_RK_BYTES;
constexpr int FT_RC_MARK = FT_RC_LO + FT_FEATS * FT_OUT_LD * 4;
static_assert(FT_RC_HI + FT_FEATS * FT_COLS * 4 <= FT_RC_LO, "the high parts fit the buffers");
static_assert(FT_RK == FT_BK && FT_RK_BYTES == FT_X_BYTES, "the recompute's X k-tile is a stage's");
constexpr int FT_RING_BYTES = FT_STAGES * FT_STAGE_BYTES;
constexpr int FT_EPI_BYTES = FT_RC_MARK + FT_FEATS * FT_COLS;
constexpr int FT_SHARED_BYTES = FT_RING_BYTES > FT_EPI_BYTES ? FT_RING_BYTES : FT_EPI_BYTES;
constexpr int FT_NORMS = FT_SHARED_BYTES + FT_BARS_BYTES;
constexpr int FT_SMEM = 1024 + FT_NORMS + (FT_FEATS * FT_SLOTS + FT_FEATS + FT_COLS) * 4;
static_assert(FT_SHARED_BYTES % 8 == 0 && FT_SMEM <= 227 * 1024, "the shared memory fits a CTA");

// phases at least this large are recomputed in the epilogue in float64
// (below)
constexpr float FT_EXACT_PHASE = 64.0f;
// and phases whose terms may cancel past the gate: those with |omega_f|_2
// |x_c|_2 scale > FT_CANCEL, where the split products' 2^-20 of
// sum_k |omega_fk x_kc| <= |omega_f| |x_c| could reach a quarter of 2e-5
constexpr float FT_CANCEL = 5e-6f * 1048576.0f;

// whether the epilogue's rule recomputes a valid phase z with row and
// column squared norms rn, cn; lim2 = (FT_CANCEL / scale)^2
__device__ __forceinline__ bool ft_exact(float z, float rn, float cn, float lim2) {
  return fabsf(z) >= FT_EXACT_PHASE || rn * cn > lim2;
}

// d += a b on the FP64 tensor cores: one 8 x 8 x 4 product a warp (A row
// major, lane l holding A[l / 4][l % 4]; B column major, B[l % 4][l / 4];
// D[l / 4][2 (l % 4) + i] in d_i)
__device__ __forceinline__ void ft_dmma(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// a recomputed feature: y (cos or sin of the float64 phase, times the scale,
// in float64) rounded to the fp32 value beside it on the side of h (the
// same feature from fp32's chain, rounded as plain rounds it)
__device__ __forceinline__ float ft_toward(double y, float h) {
  const double hd = h;
  return hd > y ? __double2float_ru(y) : hd < y ? __double2float_rd(y) : __double2float_rn(y);
}

struct FtArgs {
  int x_col0;  // X's column of the first sample
  int nf, p, n_valid, ncols_out;
  float scale;
  float* out_c;
  float* out_s;
  int64_t ldo, draw_stride;
  // null, or [Omega elements the producers drew, phases recomputed, Omega
  // elements the recompute drew], added to
  unsigned long long* stats;
  // split over p (operand Omega only): null, or the workspace (slices, nf,
  // ldo) of the slices' phase sums, blockIdx.z the slice of kt_per_split
  // k-tiles
  float* part = nullptr;
  int kt_per_split = 0;
  // and the slices' squared norms: (slices, nf) of Omega's rows, (slices,
  // ncols_out) of X's columns (launch_featurize_operand sets them)
  float* part_rn = nullptr;
  float* part_cn = nullptr;
};

// kOperand: Omega from the tensor map tom ((N, p), 32 k x 16 row boxes);
// otherwise drawn by gen (tom unused)
template <bool kOperand>
__global__ void __launch_bounds__(FT_THREADS, 1)
featurize_tf32_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tom, const FusedOmega gen,
                      const FtArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sb = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t bars = base + FT_SHARED_BYTES;
  auto om_hi = [&](int s) { return base + s * FT_STAGE_BYTES; };
  auto om_lo = [&](int s) { return base + s * FT_STAGE_BYTES + FT_OM_BYTES; };
  auto xs = [&](int s) { return base + s * FT_STAGE_BYTES + 2 * FT_OM_BYTES; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (FT_STAGES + s); };
  auto rc_full = [&](int b) { return bars + 16u * FT_STAGES + 8u * b; };
  auto rc_empty = [&](int b) { return bars + 16u * FT_STAGES + 16u + 8u * b; };
  auto rc_om = [&](int b) { return base + FT_RC_OM + b * FT_RK_BYTES; };
  auto rc_x = [&](int b) { return base + FT_RC_X + b * FT_RK_BYTES; };
  // the recompute flag; the one of the cluster's CTA 0 decides for all
  const uint32_t flag = bars + 16u * FT_STAGES + 32u;
  // the operand path: a stage's X and Omega bytes have landed (before the split)
  auto landed = [&](int s) { return bars + 16u * FT_STAGES + 48u + 8u * s; };
  // [FT_FEATS][kSlots]: the squares' partial sums of each row, slot t %
  // kSlots of the producer thread t that draws or splits them
  constexpr int kSlots = kOperand ? 8 : 16;
  float* slot = reinterpret_cast<float*>(sb + FT_NORMS);
  float* rn = slot + FT_FEATS * FT_SLOTS;  // [FT_FEATS] squared row norms
  float* cn = rn + FT_FEATS;               // [FT_COLS] squared column norms
  const uint32_t rn_at = base + FT_NORMS + FT_FEATS * FT_SLOTS * 4;

  uint32_t ncl;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(ncl));
  const uint32_t rank = hop::cluster_ctarank();
  const int col0 = blockIdx.x * FT_COLS;   // sample columns of this CTA
  const int f0 = blockIdx.y * FT_FEATS;    // feature rows of this CTA
  const int n_kt = (a.p + FT_BK - 1) / FT_BK;
  // this CTA's k-tiles: kt0 .. kt0 + n_it - 1 (all of them unless split)
  const int kt0 = a.part ? static_cast<int>(blockIdx.z) * a.kt_per_split : 0;
  const int n_it = a.part ? min(a.kt_per_split, n_kt - kt0) : n_kt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FT_STAGES; ++s) {
      // drawn: the producer's arrival, the rest transaction bytes; operand:
      // the splitters' arrivals
      hop::mbar_init(full(s), kOperand ? FT_SPLITTERS : 1);
      hop::mbar_init(empty(s), ncl * 2);
      hop::mbar_init(landed(s), 1);
    }
    for (int b = 0; b < 2; ++b) {
      hop::mbar_init(rc_full(b), 1);
      hop::mbar_init(rc_empty(b), ncl * 2);
    }
    *reinterpret_cast<int*>(sb + (flag - base)) = 0;
    hop::mbar_fence_init();
  }
  for (int i = threadIdx.x; i < FT_FEATS * kSlots; i += FT_THREADS) slot[i] = 0.f;
  hop::cluster_sync();  // every barrier of the cluster exists before any remote traffic

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int t = threadIdx.x % 128;
  if (wg < 2) {
    // ---- producers.  Their registers move to the consumers: 2 x 128 x 40 +
    // 2 x 128 x 216 = 65536
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int tp = threadIdx.x;
    if constexpr (kOperand) {
      // X and the Omega tile by TMA (thread 0), the Omega tile split by
      // warps 1-7
      auto load = [&](uint32_t x_dst, uint32_t om_dst, uint32_t bar, int k0) {
        for (int b = 0; b < FT_COLS / 32; ++b)
          hop::tma_load_2d(x_dst + b * FT_XBOX_BYTES, &tx, bar, a.x_col0 + col0 + 32 * b, k0);
        for (int j = 0; j < FT_OM_BOXES; ++j)
          hop::tma_load_2d(om_dst + j * FT_OM_BOX_BYTES, &tom, bar, k0, f0 + FT_OM_BOX_ROWS * j);
      };
      if (tp == 0) {
        for (int kt = 0; kt < n_it; ++kt) {
          const int s = kt % FT_STAGES;
          hop::mbar_wait_cluster(empty(s), ((kt / FT_STAGES) & 1) ^ 1);
          hop::fence_proxy_async();
          hop::mbar_expect_tx(landed(s), FT_X_BYTES + FT_OM_BYTES);
          load(xs(s), om_hi(s), landed(s), (kt0 + kt) * FT_BK);
        }
      } else if (tp >= 32) {
        // float4 i of the tile is row i / 8, chunk i % 8: this thread's
        // squares of its chunks, summed over the stages, are their slots
        constexpr int kPer = (FT_OM_BYTES / 16 + FT_SPLITTERS - 1) / FT_SPLITTERS;
        float sq[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) sq[j] = 0.f;
        for (int kt = 0; kt < n_it; ++kt) {
          const int s = kt % FT_STAGES;
          hop::mbar_wait(landed(s), (kt / FT_STAGES) & 1);
          float4* hi = reinterpret_cast<float4*>(sb + (om_hi(s) - base));
          float4* lo = reinterpret_cast<float4*>(sb + (om_lo(s) - base));
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const int i = tp - 32 + FT_SPLITTERS * j;
            if (i >= FT_OM_BYTES / 16) break;
            const float4 v = hi[i];
            sq[j] = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, sq[j]))));
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
          if (kt == n_it - 1) {  // the slots, before the last stage's release
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              const int i = tp - 32 + FT_SPLITTERS * j;
              if (i < FT_OM_BYTES / 16) slot[i] = sq[j];
            }
          }
          hop::fence_proxy_async();  // Omega hi and lo are wgmma operands
          hop::mbar_arrive(full(s));
        }
      }
      hop::cluster_sync();  // the epilogue reuses the ring (as below)
      hop::cluster_sync();  // the consumers of every CTA have flagged large phases
      if (hop::ld_cluster_u32(hop::mapa(flag, 0))) {
        // the recompute's X and Omega k-tiles, fp32, by TMA as in the main
        // loop, once for each of its two passes
        if (tp == 0) {
          const int n_st = (a.p + FT_RK - 1) / FT_RK;
#pragma unroll 1
          for (int st = 0; st < 2 * n_st; ++st) {
            const int b = st & 1;
            hop::mbar_wait_cluster(rc_empty(b), ((st >> 1) & 1) ^ 1);
            hop::fence_proxy_async();  // the consumers' reads of the buffer come first
            hop::mbar_expect_tx(rc_full(b), FT_X_BYTES + FT_RK_BYTES);
            load(rc_x(b), rc_om(b), rc_full(b), (st % n_st) * FT_RK);
          }
        }
        hop::cluster_sync();  // no copy into or out of a CTA that has exited
      }
    } else {
      // X by TMA; this CTA's share of Omega drawn into its own ring and
      // pushed to the other CTAs of the cluster by bulk copies
      const FusedOmega g = gen.draw(blockIdx.z);
      const int r_lo = static_cast<int>(rank * FT_FEATS / ncl);
      const int r_hi = static_cast<int>((rank + 1) * FT_FEATS / ncl);
      const int n_units = (r_hi - r_lo) * (FT_BK / FT_UNIT);
      // Omega bytes this CTA receives from the others a stage, hi and lo
      const uint32_t remote_bytes = 2u * (FT_FEATS - (r_hi - r_lo)) * 128u;
      uint32_t drawn = 0;  // in-range Omega elements this thread drew
      // the squares of this thread's first unit's row (its slot, written at
      // the last stage); further units' (cluster of < 8) go to their slots
      float sq0 = 0.f;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % FT_STAGES;
        hop::mbar_wait_cluster(empty(s), ((kt / FT_STAGES) & 1) ^ 1);
        const int k0 = kt * FT_BK;
        if (tp == 0) {
          hop::mbar_expect_tx_only(full(s), FT_X_BYTES + remote_bytes);
          for (int b = 0; b < FT_COLS / 32; ++b)
            hop::tma_load_2d(xs(s) + b * FT_XBOX_BYTES, &tx, full(s), a.x_col0 + col0 + 32 * b, k0);
        }
        for (int un = tp; un < n_units; un += FT_PT) {
          const int row = r_lo + un / (FT_BK / FT_UNIT);
          const int kc = FT_UNIT * (un % (FT_BK / FT_UNIT));  // in the k-tile
          const int gr = f0 + row;
          // the integer rounds of the unit's draws first, side by side (no
          // branch between them), then their float transforms
          uint32_t b0[FT_UNIT], b1[FT_UNIT];
          float hi[FT_UNIT], lo[FT_UNIT], sq = 0.f;
#pragma unroll
          for (int i = 0; i < FT_UNIT; ++i)
            threefry2x32(g.key0, g.key1, uint32_t(gr), uint32_t(k0 + kc + i), b0[i], b1[i]);
#pragma unroll
          for (int i = 0; i < FT_UNIT; ++i) {
            const bool in = gr < a.nf && k0 + kc + i < a.p;
            drawn += in;
            const float v = in ? g.from_bits(b0[i], b1[i]) : 0.f;
            sq = fmaf(v, v, sq);
            uint32_t h, l;
            hop::split_tf32(v, h, l);
            hi[i] = __uint_as_float(h);
            lo[i] = __uint_as_float(l);
          }
          // unit un is slot un % 16 (= tp % 16) of its row at every stage
          if (un == tp)
            sq0 += sq;
          else
            slot[row * kSlots + un % kSlots] += sq;
          // a unit is two consecutive words of one 16-byte chunk
          const uint32_t off = hop::sw128_f32(row, kc);
          *reinterpret_cast<float2*>(sb + (om_hi(s) - base) + off) = make_float2(hi[0], hi[1]);
          *reinterpret_cast<float2*>(sb + (om_lo(s) - base) + off) = make_float2(lo[0], lo[1]);
        }
        if (kt == n_kt - 1 && tp < n_units)  // the first unit's slot, before the release
          slot[(r_lo + tp / (FT_BK / FT_UNIT)) * kSlots + tp % kSlots] = sq0;
        hop::fence_proxy_async();  // the share is a wgmma operand and a bulk-copy source
        hop::named_sync(1, FT_PT);
        // thread r pushes the share to CTA r (the local one arrives instead)
        if (tp < static_cast<int>(ncl)) {
          const uint32_t off = r_lo * 128u, bytes = (r_hi - r_lo) * 128u;
          const uint32_t r = tp;
          if (r != rank) {
            hop::bulk_copy_cluster(hop::mapa(om_hi(s) + off, r), om_hi(s) + off, bytes,
                                   hop::mapa(full(s), r));
            hop::bulk_copy_cluster(hop::mapa(om_lo(s) + off, r), om_lo(s) + off, bytes,
                                   hop::mapa(full(s), r));
          } else {
            hop::mbar_arrive(full(s));
          }
        }
      }
      if (a.stats) {
        drawn = __reduce_add_sync(0xffffffffu, drawn);
        if (tp % 32 == 0) atomicAdd(&a.stats[0], (unsigned long long)drawn);
      }
      // the epilogue below reuses the ring: no CTA of the cluster may still
      // copy out of it or into it
      hop::cluster_sync();
      hop::cluster_sync();  // the consumers of every CTA have flagged large phases
      if (hop::ld_cluster_u32(hop::mapa(flag, 0))) {
        // the recompute's Omega k-tiles, fp32, drawn and pushed as the main
        // loop's are, once for each of its two passes; X by TMA
        const uint32_t remote_fp32 = (FT_FEATS - (r_hi - r_lo)) * 128u;
        const int n_st = (a.p + FT_RK - 1) / FT_RK;
        uint32_t redrawn = 0;
#pragma unroll 1
        for (int st = 0; st < 2 * n_st; ++st) {
          const int b = st & 1;
          hop::mbar_wait_cluster(rc_empty(b), ((st >> 1) & 1) ^ 1);
          const int k0 = (st % n_st) * FT_RK;
          if (tp == 0) {
            hop::fence_proxy_async();  // the consumers' reads of the buffer come first
            hop::mbar_expect_tx_only(rc_full(b), FT_X_BYTES + remote_fp32);
            for (int bx = 0; bx < FT_COLS / 32; ++bx)
              hop::tma_load_2d(rc_x(b) + bx * FT_XBOX_BYTES, &tx, rc_full(b),
                               a.x_col0 + col0 + 32 * bx, k0);
          }
#pragma unroll 1
          for (int un = tp; un < n_units; un += FT_PT) {
            const int row = r_lo + un / (FT_RK / FT_UNIT);
            const int kc = FT_UNIT * (un % (FT_RK / FT_UNIT));
            const int gr = f0 + row;
            uint32_t b0[FT_UNIT], b1[FT_UNIT];
            float v[FT_UNIT];
#pragma unroll
            for (int i = 0; i < FT_UNIT; ++i)
              threefry2x32(g.key0, g.key1, uint32_t(gr), uint32_t(k0 + kc + i), b0[i], b1[i]);
#pragma unroll
            for (int i = 0; i < FT_UNIT; ++i) {
              const bool in = gr < a.nf && k0 + kc + i < a.p;
              redrawn += in;
              v[i] = in ? g.from_bits(b0[i], b1[i]) : 0.f;
            }
            *reinterpret_cast<float2*>(sb + (rc_om(b) - base) + hop::sw128_f32(row, kc)) =
                make_float2(v[0], v[1]);
          }
          hop::fence_proxy_async();  // the share is a bulk-copy source
          hop::named_sync(1, FT_PT);
          if (tp < static_cast<int>(ncl)) {
            const uint32_t off = r_lo * 128u, bytes = (r_hi - r_lo) * 128u;
            const uint32_t r = tp;
            if (r != rank)
              hop::bulk_copy_cluster(hop::mapa(rc_om(b) + off, r), rc_om(b) + off, bytes,
                                     hop::mapa(rc_full(b), r));
            else
              hop::mbar_arrive(rc_full(b));
          }
        }
        if (a.stats) {
          redrawn = __reduce_add_sync(0xffffffffu, redrawn);
          if (tp % 32 == 0) atomicAdd(&a.stats[2], (unsigned long long)redrawn);
        }
        hop::cluster_sync();  // no copy into or out of a CTA that has exited
      }
    }
  } else {
    // ---- consumers: warpgroup w owns samples 64 w .. 64 w + 63 of the CTA
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int w = wg - 2;
    const int lane = t % 32;
    const int gq = lane / 4, tq = lane % 4;
    const int m0 = 64 * w + 16 * (t / 32) + gq;  // this thread's rows m0 and m0 + 8
    // each stage's products start a fresh wgmma accumulator (part), added to
    // the sum with fp32's rounding to nearest: the tensor cores' additions
    // round toward zero, and over p = 2048 (768 of them) into one
    // accumulator the truncations bias the phases by ~4e-5 of G_H
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // byte offsets in a stage's X tile of this thread's fragment at k = tq:
    // X element (k, m) is in box m / 32, 128-byte swizzled; the swizzle
    // phase is k % 8, the same at every k-step (k + 8 j), which only adds
    // 1024 j bytes.  m0 % 32 < 24, so m0 + 8 stays in the box.
    uint32_t xoff[4];
    {
      const int box = (m0 / 32) * FT_XBOX_BYTES, c = m0 % 32;
      xoff[0] = box + hop::sw128_f32(tq, c);
      xoff[1] = box + hop::sw128_f32(tq, c + 8);
      xoff[2] = box + hop::sw128_f32(tq + 4, c);
      xoff[3] = box + hop::sw128_f32(tq + 4, c + 8);
    }

    // the squared norms of this thread's columns m0 and m0 + 8 over its k
    float xsq[2] = {0.f, 0.f};
    for (int kt = 0; kt < n_it; ++kt) {
      const int s = kt % FT_STAGES;
      // CTA scope: the stage's bytes land as transactions (TMA, bulk copies
      // from the cluster), the local share behind a CTA-scope release
      hop::mbar_wait(full(s), (kt / FT_STAGES) & 1);
      const uint8_t* x_sm = sb + (xs(s) - base);
      // the stage's four k-steps: fragments, then their 12 products
      uint32_t hi[FT_BK / 8][4], lo[FT_BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < FT_BK / 8; ++kk)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float xv = *reinterpret_cast<const float*>(x_sm + 1024 * kk + xoff[v]);
          xsq[v & 1] = fmaf(xv, xv, xsq[v & 1]);
          hop::split_tf32(xv, hi[kk][v], lo[kk][v]);
        }
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FT_BK / 8; ++kk)
        hop::wgmma_tf32x3_n128(part, hi[kk], lo[kk], hop::desc_sw128(om_hi(s) + kk * 32),
                               hop::desc_sw128(om_lo(s) + kk * 32), kk);
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(part);
      hop::fence_regs(hi);
      hop::fence_regs(lo);
      // the warpgroup's products on stage s are complete: release it in
      // every CTA of the cluster (thread r signals CTA r)
      if (t < static_cast<int>(ncl)) hop::mbar_arrive_cluster(hop::mapa(empty(s), t));
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }

    // epilogue: the columns' squared norms (the four lanes of a quad hold
    // their k) and the rows' (from the producers' slots); the phases through
    // shared memory (the ring is free once every CTA of the cluster is past
    // its products: no bulk copy reads or writes it any more), then cos and
    // sin one element a thread at a time, each warp writing 32 consecutive
    // columns of a row; a slice of a split writes its phase sums and partial
    // norms instead, for the finishing pass
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xsq[i] += __shfl_xor_sync(0xffffffffu, xsq[i], 1);
      xsq[i] += __shfl_xor_sync(0xffffffffu, xsq[i], 2);
    }
    if (tq == 0) {
      cn[m0] = xsq[0];
      cn[m0 + 8] = xsq[1];
    }
    // the rows' squared norms: the rows this CTA drew or split from its
    // slots (its producers wrote them before releasing the last stage), the
    // others from the CTA that drew them (a drawn Omega: rows r_lo(r) ..
    // r_lo(r + 1) - 1 in CTA r) once the cluster is past its products
    const int u = threadIdx.x - FT_PT;
    uint32_t owner = rank;
    if (!kOperand && u < FT_FEATS)
      for (owner = 0; (owner + 1) * FT_FEATS / ncl <= static_cast<uint32_t>(u);) ++owner;
    if (u < FT_FEATS && owner == rank) {
      float sq = 0.f;
#pragma unroll
      for (int q = 0; q < kSlots; ++q) sq += slot[u * kSlots + q];
      rn[u] = sq;
    }
    hop::cluster_sync();
    if (u < FT_FEATS) {
      if (owner != rank)
        rn[u] = __uint_as_float(hop::ld_cluster_u32(hop::mapa(rn_at + 4 * u, owner)));
      if (a.part && blockIdx.x == 0 && f0 + u < a.nf) a.part_rn[blockIdx.z * a.nf + f0 + u] = rn[u];
    }
    hop::named_sync(2, 256);  // rn and cn complete
    if (a.part && blockIdx.y == 0 && u >= FT_FEATS && col0 + u - FT_FEATS < a.ncols_out)
      a.part_cn[int64_t(blockIdx.z) * a.ncols_out + col0 + u - FT_FEATS] = cn[u - FT_FEATS];
    const float lim = FT_CANCEL / a.scale, lim2 = lim * lim;
    float* zt = reinterpret_cast<float*>(sb);  // [feature][sample], FT_OUT_LD apart
    bool big = false;  // a phase of this thread's that the recompute must take
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z = acc[4 * j + 2 * i + e];
          const int fl = 8 * j + 2 * tq + e, cl = m0 + 8 * i;
          zt[fl * FT_OUT_LD + cl] = z;
          big |= !a.part && f0 + fl < a.nf && col0 + cl < a.n_valid &&
                 ft_exact(z, rn[fl], cn[cl], lim2);
        }
    if (__any_sync(0xffffffffu, big) && lane == 0) hop::red_or_cluster(hop::mapa(flag, 0), 1u);
    hop::cluster_sync();  // the phases in shared memory; the cluster's flag
    const int64_t dofs = int64_t(blockIdx.z) * a.draw_stride;
    const bool recompute = hop::ld_cluster_u32(hop::mapa(flag, 0));
    const float* zhi = reinterpret_cast<const float*>(sb + FT_RC_HI);  // once both passes are done
    float* zlo = reinterpret_cast<float*>(sb + FT_RC_LO);
    uint8_t* kept = sb + FT_RC_MARK;
    if (recompute) {
      // one ULP of a phase |z| >= 64 moves cos by >= 64 2^-24, a phase of
      // large terms cancels, and the split products with the tensor cores'
      // truncating additions round differently from fp32: recompute the
      // phases ft_exact takes in float64, FMAs over k in order from the fp32
      // operands.  The output is the fp32 value beside the float64 feature
      // on the side of fp32's sequential FMA chain: within one fp32 ULP of
      // the float64 answer, and on the side of plain where plain sums in that
      // order, as cuBLAS does at the full width, so an element whose plain
      // value lies just inside 2e-5 of the float64 answer stays within 2e-5
      // of it (the reference's rule; the float64 answer rounded to nearest
      // fell past that on 7 of K7's 14.8 M Cauchy features at 3612 columns).
      // The tile streams twice: the chain (64 registers a thread), then the
      // float64 sums on the FP64 tensor cores (128).
      // Thread (tf, tc) owns features 4 tf + {0..3, 64..67} and samples
      // 4 tc + {0..3, 64..67}
      const int tf = u / 16, tc = u % 16;
      const int n_st = (a.p + FT_RK - 1) / FT_RK;
      // stage st of the two passes' stream: the body on its buffers (Omega;
      // X sample c at k: box c / 32, row k, 16-byte chunk (c % 32) / 4 ^ k %
      // 8), then buffer b released in every CTA of the cluster once the
      // warpgroup is done reading it, before the async proxy writes it again
      // (thread r signals CTA r)
      auto stage = [&](int st, auto&& body) {
        const int b = st & 1;
        hop::mbar_wait(rc_full(b), (st >> 1) & 1);
        body(sb + (rc_om(b) - base), sb + (rc_x(b) - base));
        hop::fence_proxy_async();
        hop::named_sync(8 + w, 128);
        if (t < static_cast<int>(ncl)) hop::mbar_arrive_cluster(hop::mapa(rc_empty(b), t));
      };
      auto x_at = [&](const uint8_t* x_b, int kk, int half) {  // samples 4 tc + {0..3} + 64 half
        return *reinterpret_cast<const float4*>(x_b + (tc / 8 + 2 * half) * FT_XBOX_BYTES +
                                                kk * 128 + (((tc % 8) ^ (kk % 8)) * 16));
      };
      uint32_t taken = 0;
      {
        // pass 1: fp32's FMA chain
        float r[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) r[i][j] = 0.f;
#pragma unroll 1
        for (int st = 0; st < n_st; ++st)
          stage(st, [&](const uint8_t* om_b, const uint8_t* x_b) {
#pragma unroll 2
            for (int kq = 0; kq < FT_RK / 4; ++kq) {
              // Omega (feature, 4 kq .. 4 kq + 3) is one 16-byte chunk
              float4 om4[8];
#pragma unroll
              for (int i = 0; i < 8; ++i)
                om4[i] = *reinterpret_cast<const float4*>(
                    om_b + hop::sw128_f32(4 * tf + (i & 3) + 64 * (i >> 2), 4 * kq));
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float4 v0 = x_at(x_b, 4 * kq + q, 0), v1 = x_at(x_b, 4 * kq + q, 1);
                const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  const float wi =
                      q == 0 ? om4[i].x : q == 1 ? om4[i].y : q == 2 ? om4[i].z : om4[i].w;
#pragma unroll
                  for (int j = 0; j < 8; ++j) r[i][j] = fmaf(wi, v[j], r[i][j]);
                }
              }
            }
          });
        // the chain in place of the phases ft_exact takes, and their marks
        // (the phases and marks lie outside the buffers the next pass streams
        // through)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int fl = 4 * tf + (i & 3) + 64 * (i >> 2),
                      cl = 4 * tc + (j & 3) + 64 * (j >> 2);
            float& z = zt[fl * FT_OUT_LD + cl];
            const bool take =
                f0 + fl < a.nf && col0 + cl < a.n_valid && ft_exact(z, rn[fl], cn[cl], lim2);
            if (take) z = r[i][j];
            kept[fl * FT_COLS + cl] = take;
            taken += take;
          }
      }
      {
        // pass 2: the float64 sums, 4 k a step on the FP64 tensor cores.  Warp
        // v of the consumers owns features fw .. fw + 31 and samples cw .. cw
        // + 63: 4 x 8 products of 8 x 8, two accumulators a lane each.  A
        // lane loads Omega (feature fw + 8 i + gq, k) and X (k, sample cw + 8
        // j + gq) at k = 4 step + tq, once each, as float64.
        const int v = w * 4 + (t / 32);
        const int fw = 32 * (v % 4), cw = 64 * (v / 4);
        double d[4][8][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) d[i][j][0] = d[i][j][1] = 0.0;
#pragma unroll 1
        for (int st = n_st; st < 2 * n_st; ++st)
          stage(st, [&](const uint8_t* om_b, const uint8_t* x_b) {
#pragma unroll 2
            for (int step = 0; step < FT_RK / 4; ++step) {
              const int kk = 4 * step + tq;
              double am[4], bm[8];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                am[i] = *reinterpret_cast<const float*>(om_b + hop::sw128_f32(fw + 8 * i + gq, kk));
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int c = cw + 8 * j + gq;
                bm[j] = *reinterpret_cast<const float*>(
                    x_b + (c / 32) * FT_XBOX_BYTES + hop::sw128_f32(kk, c % 32));
              }
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) ft_dmma(d[i][j][0], d[i][j][1], am[i], bm[j]);
            }
          });
        // no copy into or out of a CTA that has exited, and none into its
        // buffers: they take the kept sums' high fp32 parts (hi + lo within
        // 2^-48 of the float64 sum)
        hop::cluster_sync();
        float* hi = reinterpret_cast<float*>(sb + FT_RC_HI);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int fl = fw + 8 * i + gq, cl = cw + 8 * j + 2 * tq + e;
              if (kept[fl * FT_COLS + cl]) {
                const float h = static_cast<float>(d[i][j][e]);
                hi[fl * FT_COLS + cl] = h;
                zlo[fl * FT_OUT_LD + cl] = static_cast<float>(d[i][j][e] - static_cast<double>(h));
              }
            }
      }
      if (a.stats) {
        taken = __reduce_add_sync(0xffffffffu, taken);
        if (lane == 0) atomicAdd(&a.stats[1], (unsigned long long)taken);
      }
      hop::named_sync(2, 256);
    }
    const double scale_d = a.scale;
#pragma unroll 1
    for (int idx = u; idx < FT_FEATS * FT_COLS; idx += 256) {
      // a warp: 32 consecutive columns of one feature row
      const int fl = idx / FT_COLS, cl = idx % FT_COLS;
      const int f = f0 + fl;
      const int c = col0 + cl;
      if (f >= a.nf || c >= a.ncols_out) continue;
      const float z = zt[fl * FT_OUT_LD + cl];
      if (a.part) {
        a.part[(int64_t(blockIdx.z) * a.nf + f) * a.ldo + c] = z;
        continue;
      }
      float sv = 0.f, cv = 0.f;
      if (c < a.n_valid) {
        sincosf(z, &sv, &cv);  // z: the chain, where kept
        sv *= a.scale;
        cv *= a.scale;
        if (recompute && kept[idx]) {  // cos and sin in float64, rounded toward the chain's
          double sd, cd;
          sincos(static_cast<double>(zhi[idx]) + zlo[fl * FT_OUT_LD + cl], &sd, &cd);
          sv = ft_toward(sd * scale_d, sv);
          cv = ft_toward(cd * scale_d, cv);
        }
      }
      a.out_c[dofs + int64_t(f) * a.ldo + c] = cv;
      a.out_s[dofs + int64_t(f) * a.ldo + c] = sv;
    }
  }
}

// grid: sample CTAs (a multiple of the cluster size) x feature blocks x draws
// (an operand Omega split over p: x slices).  A drawn Omega is shared by a
// cluster, the least that keeps ceil(columns / 1024) clusters; an operand
// Omega is loaded by each CTA (a cluster of 1)
template <bool kOperand>
inline void featurize_tf32_grid(int nf, int ncols_out, int draws, dim3& grid, int& cluster) {
  const int ncta = (ncols_out + FT_COLS - 1) / FT_COLS;
  const int nclus = kOperand ? ncta : (ncta + FT_CLUSTER - 1) / FT_CLUSTER;
  cluster = (ncta + nclus - 1) / nclus;
  grid = dim3(nclus * cluster, (nf + FT_FEATS - 1) / FT_FEATS, draws);
}

template <bool kOperand>
inline cudaError_t launch_featurize_tf32_kernel(const CUtensorMap& tx, const CUtensorMap& tom,
                                                const FusedOmega& gen, int draws,
                                                const FtArgs& a, cudaStream_t stream) {
  dim3 grid;
  int cluster;
  featurize_tf32_grid<kOperand>(a.nf, a.ncols_out, draws, grid, cluster);
  cudaError_t err = cudaFuncSetAttribute(featurize_tf32_kernel<kOperand>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, FT_SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(FT_THREADS);
  cfg.dynamicSmemBytes = FT_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, featurize_tf32_kernel<kOperand>, tx, tom, gen, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The finishing pass of a split over p: one warp per (feature row, 32
// consecutive columns), 8 rows a block.  The slices' phase sums and squared
// norms are added in slice order; a phase that ft_exact takes is recomputed
// from the operands over all of p as the epilogue recomputes it (float64
// FMAs over k in order, fp32's chain beside them, cos and sin in float64
// rounded toward the chain's), Omega's row read as a broadcast and X's rows
// coalesced, by every lane of a warp that has such a phase (the others skip
// the sums); then cos and sin, columns past n_valid written as 0.
__global__ void __launch_bounds__(256)
featurize_finish_kernel(const float* __restrict__ om, int64_t ld_om, const float* __restrict__ x,
                        int64_t ldx, int slices, const FtArgs a) {
  const int f = blockIdx.y * 8 + threadIdx.x / 32;
  const int c = blockIdx.x * 32 + threadIdx.x % 32;
  const bool valid = c < a.n_valid;
  const int64_t at = int64_t(f) * a.ldo + c;
  const bool in = f < a.nf && c < a.ncols_out;
  // the block's 8 rows' and 32 columns' squared norms: their slices' parts
  // (part i: slice i / 40, norm i % 40) loaded by the whole block, the first
  // 4 a thread issued beside the phase sums' loads, then summed in slice order
  extern __shared__ float fin[];  // [slices][40] parts, then [40] sums
  float* norms = fin + 40 * slices;
  auto norm_part = [&](int i) {
    const int j = i % 40, sl = i / 40;
    const bool row = j < 8;
    const int k = row ? blockIdx.y * 8 + j : blockIdx.x * 32 + j - 8;
    const int size = row ? a.nf : a.ncols_out;
    return k < size ? (row ? a.part_rn : a.part_cn)[int64_t(sl) * size + k] : 0.f;
  };
  float pre[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = threadIdx.x + q * 256;
    pre[q] = i < 40 * slices ? norm_part(i) : 0.f;
  }
  float z = 0.f;
  if (in) {
    z = a.part[at];
#pragma unroll 4
    for (int sl = 1; sl < slices; ++sl) z += a.part[int64_t(sl) * a.nf * a.ldo + at];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = threadIdx.x + q * 256;
    if (i < 40 * slices) fin[i] = pre[q];
  }
  for (int i = threadIdx.x + 4 * 256; i < 40 * slices; i += 256) fin[i] = norm_part(i);
  __syncthreads();
  if (threadIdx.x < 40) {
    float sq = 0.f;
    for (int sl = 0; sl < slices; ++sl) sq += fin[sl * 40 + threadIdx.x];
    norms[threadIdx.x] = sq;
  }
  __syncthreads();
  if (f >= a.nf) return;  // the whole warp
  const float rsq = norms[threadIdx.x / 32], csq = norms[8 + threadIdx.x % 32];
  const float lim = FT_CANCEL / a.scale;
  const bool big = valid && ft_exact(z, rsq, csq, lim * lim);
  const uint32_t bigs = __ballot_sync(0xffffffffu, big);
  double r = 0.0;  // the float64 sum, and fp32's chain beside it
  if (bigs) {
    const float* w = om + int64_t(f) * ld_om;
    const float* xc = x + a.x_col0 + (valid ? c : 0);
    float chain = 0.f;
#pragma unroll 8
    for (int k = 0; k < a.p; ++k) {
      const float wk = w[k], xk = xc[int64_t(k) * ldx];
      r = fma(static_cast<double>(wk), static_cast<double>(xk), r);
      chain = fmaf(wk, xk, chain);
    }
    if (big) z = chain;
    if (a.stats && threadIdx.x % 32 == 0) atomicAdd(&a.stats[1], (unsigned long long)__popc(bigs));
  }
  if (in) {
    float sv = 0.f, cv = 0.f;
    if (valid) {
      sincosf(z, &sv, &cv);
      sv *= a.scale;
      cv *= a.scale;
      if (big) {  // as the epilogue: float64, rounded toward the chain's
        double sd, cd;
        sincos(r, &sd, &cd);
        sv = ft_toward(sd * static_cast<double>(a.scale), sv);
        cv = ft_toward(cd * static_cast<double>(a.scale), cv);
      }
    }
    a.out_c[at] = cv;
    a.out_s[at] = sv;
  }
}

// Omega an (nf, p) operand, rows ld_omega apart; x (p, ldx); ld_omega and
// ldx multiples of 4 and both 16-byte aligned (TMA).  Without a.part, one
// launch writes C and S; with it, the featurize writes `slices` phase sums
// of a.kt_per_split k-tiles each to a.part (slices, nf, ldo), followed by
// their squared norms (slices, nf) and (slices, ncols_out), and the
// finishing pass writes C and S.
inline cudaError_t launch_featurize_operand(const float* omega, int64_t ld_omega, const float* x,
                                            int64_t ldx, const FtArgs& a, int slices,
                                            cudaStream_t stream) {
  CUtensorMap tx, tom;
  if (!hop::map_f32_sw128(&tx, x, a.p, ldx, ldx, 32, FT_BK) ||
      !hop::map_f32_sw128(&tom, omega, a.nf, a.p, ld_omega, FT_BK, FT_OM_BOX_ROWS))
    return cudaErrorInvalidValue;
  if (!a.part) return launch_featurize_tf32_kernel<true>(tx, tom, FusedOmega{}, 1, a, stream);
  const int n_kt = (a.p + FT_BK - 1) / FT_BK;  // every slice has k-tiles, and they cover p
  if (a.draw_stride != 0 || slices < 1 || a.kt_per_split < 1 ||
      (slices - 1) * a.kt_per_split >= n_kt || slices * a.kt_per_split < n_kt)
    return cudaErrorInvalidValue;
  FtArgs b = a;  // the slices' norms follow their phase sums in the workspace
  b.part_rn = a.part + int64_t(slices) * a.nf * a.ldo;
  b.part_cn = b.part_rn + int64_t(slices) * a.nf;
  cudaError_t err = launch_featurize_tf32_kernel<true>(tx, tom, FusedOmega{}, slices, b, stream);
  if (err != cudaSuccess) return err;
  const int fin_bytes = 40 * (slices + 1) * 4;  // the finishing pass's norms
  if (fin_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(featurize_finish_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, fin_bytes);
    if (err != cudaSuccess) return err;
  }
  featurize_finish_kernel<<<dim3((a.ncols_out + 31) / 32, (a.nf + 7) / 8), 256, fin_bytes,
                            stream>>>(omega, ld_omega, x, ldx, slices, b);
  return cudaGetLastError();
}

// Omega drawn by gen; x: (p, ldx) row-major, ldx a multiple of 4 and x
// 16-byte aligned (TMA)
inline cudaError_t launch_featurize_tf32(const FusedOmega& gen, int draws, const float* x,
                                         int64_t ldx, int x_col0, int nf, int p, int n_valid,
                                         int ncols_out, float scale, float* out_c,
                                         float* out_s, int64_t ldo, int64_t draw_stride,
                                         unsigned long long* stats, cudaStream_t stream) {
  CUtensorMap tx;
  if (!hop::map_f32_sw128(&tx, x, p, ldx, ldx, 32, FT_BK)) return cudaErrorInvalidValue;
  const FtArgs a{x_col0, nf, p, n_valid, ncols_out, scale, out_c, out_s, ldo, draw_stride,
                 stats};
  return launch_featurize_tf32_kernel<false>(tx, tx, gen, draws, a, stream);
}

}  // namespace rt
