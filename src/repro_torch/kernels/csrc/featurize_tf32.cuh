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
//   - Phases of |z| >= 64 are recomputed there as fp32's sequential FMA chain
//     over k, the plain version's sgemm order.  At such phases one ULP of z
//     moves cos by >= 4e-6 and the split products round differently: on
//     Cauchy draws with phases up to ~1e4 even the float64 phase rounded once
//     is 2.8e-5 from plain in G_H, past the 2e-5 gate, while the recompute
//     (7 % of the phases there) lands within 2e-6
//     (tests/test_torch_split_tf32_numerics.py).  A CTA with any such phase
//     runs one FFMA pass over its whole 128 x 128 tile and keeps the chain's
//     value where |z| >= 64.  The pass is the main loop again in fp32: two
//     buffers of 32 k, X by TMA, Omega redrawn once per cluster (each CTA
//     draws its share of the rows and pushes it to the others by bulk
//     copies), the consumers running the FMAs 8 x 8 outputs a thread; the
//     cluster takes it when any of its CTAs has such a phase.  Gaussian phases at the
//     median-heuristic sigma stay far below 64; Cauchy phases at the data's
//     width take the pass in every tile (chip_smoke.py times it); a chain
//     per element would redraw each Omega element and reload X for every
//     warp that needs it.
//     An operand Omega is loaded there by TMA as in the main loop.
//   - Split over p (operand Omega, K1 at a transform request's width): where
//     the output tiles are fewer than the SMs (300 columns at N = 1000 are
//     24 tiles on 132 SMs, each walking 64 k-tiles), the grid's z runs over
//     slices of the k-tiles (the wrapper's split_plan), and each CTA writes
//     its folded phase sums to a workspace (slices, nf, ldo) instead of
//     running the epilogue.  A finishing pass adds the slices in slice order
//     (no atomics: the sum does not depend on the order the CTAs ran in),
//     recomputes phases of |z| >= 64 from the whole sum as fp32's FMA chain
//     over all of p (a slice's partial phase does not say whether the whole
//     phase reaches 64), then takes cos and sin as the epilogue does.
//   - With a counter array, the kernel adds the Omega elements its producers
//     drew, the phases it recomputed and the Omega elements the recompute
//     drew (chip_smoke.py reads the draws per element and the recomputed
//     share from them); an operand Omega adds to the phases only.
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
constexpr int FT_RK = 32;  // k a step of the epilogue's FFMA recompute
constexpr int FT_RK_BYTES = FT_RK * FT_FEATS * 4;  // one Omega or X buffer of a step
// the ring, its full and empty barriers, the recompute's two full and two
// empty barriers, the recompute flag, the operand path's landed barriers
constexpr int FT_SMEM =
    1024 + FT_STAGES * FT_STAGE_BYTES + 16 * FT_STAGES + 32 + 16 + 8 * FT_STAGES;
static_assert(FT_STAGE_BYTES % 1024 == 0, "stages must keep the swizzle phase");
static_assert(FT_FEATS == FT_COLS, "the recompute stages Omega and X tiles in one loop");
// the recompute's buffers follow the phases: Omega [2], 128 feature rows of
// 32 k laid out as the ring's (128-byte swizzled), then X [2] as TMA lands
// it (4 boxes of 32 samples, 128-byte swizzled, 1024-aligned)
constexpr int FT_RC_OM = (FT_FEATS * FT_OUT_LD * 4 + 1023) / 1024 * 1024;
constexpr int FT_RC_X = FT_RC_OM + 2 * FT_RK_BYTES;
static_assert(FT_RC_X + 2 * FT_RK_BYTES <= FT_STAGES * FT_STAGE_BYTES,
              "the epilogue's phases and the recompute's buffers fit the ring");
static_assert(FT_RK == FT_BK && FT_RK_BYTES == FT_X_BYTES, "the recompute's X k-tile is a stage's");

// phases at least this large are recomputed in the epilogue as fp32's
// sequential FMA chain (below)
constexpr float FT_EXACT_PHASE = 64.0f;

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
  const uint32_t bars = base + FT_STAGES * FT_STAGE_BYTES;
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
        for (int kt = 0; kt < n_it; ++kt) {
          const int s = kt % FT_STAGES;
          hop::mbar_wait(landed(s), (kt / FT_STAGES) & 1);
          float4* hi = reinterpret_cast<float4*>(sb + (om_hi(s) - base));
          float4* lo = reinterpret_cast<float4*>(sb + (om_lo(s) - base));
#pragma unroll
          for (int j = 0; j < (FT_OM_BYTES / 16 + FT_SPLITTERS - 1) / FT_SPLITTERS; ++j) {
            const int i = tp - 32 + FT_SPLITTERS * j;
            if (i >= FT_OM_BYTES / 16) break;
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
          hop::fence_proxy_async();  // Omega hi and lo are wgmma operands
          hop::mbar_arrive(full(s));
        }
      }
      hop::cluster_sync();  // the epilogue reuses the ring (as below)
      hop::cluster_sync();  // the consumers of every CTA have flagged large phases
      if (hop::ld_cluster_u32(hop::mapa(flag, 0))) {
        // the recompute's X and Omega k-tiles, fp32, by TMA as in the main loop
        if (tp == 0) {
          const int n_st = (a.p + FT_RK - 1) / FT_RK;
#pragma unroll 1
          for (int st = 0; st < n_st; ++st) {
            const int b = st & 1;
            hop::mbar_wait_cluster(rc_empty(b), ((st >> 1) & 1) ^ 1);
            hop::fence_proxy_async();  // the consumers' reads of the buffer come first
            hop::mbar_expect_tx(rc_full(b), FT_X_BYTES + FT_RK_BYTES);
            load(rc_x(b), rc_om(b), rc_full(b), st * FT_RK);
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
          float hi[FT_UNIT], lo[FT_UNIT];
#pragma unroll
          for (int i = 0; i < FT_UNIT; ++i)
            threefry2x32(g.key0, g.key1, uint32_t(gr), uint32_t(k0 + kc + i), b0[i], b1[i]);
#pragma unroll
          for (int i = 0; i < FT_UNIT; ++i) {
            const bool in = gr < a.nf && k0 + kc + i < a.p;
            drawn += in;
            const float v = in ? g.from_bits(b0[i], b1[i]) : 0.f;
            uint32_t h, l;
            hop::split_tf32(v, h, l);
            hi[i] = __uint_as_float(h);
            lo[i] = __uint_as_float(l);
          }
          // a unit is two consecutive words of one 16-byte chunk
          const uint32_t off = hop::sw128_f32(row, kc);
          *reinterpret_cast<float2*>(sb + (om_hi(s) - base) + off) = make_float2(hi[0], hi[1]);
          *reinterpret_cast<float2*>(sb + (om_lo(s) - base) + off) = make_float2(lo[0], lo[1]);
        }
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
        // loop's are; X by TMA
        const uint32_t remote_fp32 = (FT_FEATS - (r_hi - r_lo)) * 128u;
        const int n_st = (a.p + FT_RK - 1) / FT_RK;
        uint32_t redrawn = 0;
#pragma unroll 1
        for (int st = 0; st < n_st; ++st) {
          const int b = st & 1;
          hop::mbar_wait_cluster(rc_empty(b), ((st >> 1) & 1) ^ 1);
          const int k0 = st * FT_RK;
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
        for (int v = 0; v < 4; ++v)
          hop::split_tf32(*reinterpret_cast<const float*>(x_sm + 1024 * kk + xoff[v]), hi[kk][v],
                          lo[kk][v]);
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

    // epilogue: the phases through shared memory (the ring is free once
    // every CTA of the cluster is past its products: no bulk copy reads or
    // writes it any more), then cos and sin one element a thread at a time,
    // each warp writing 32 consecutive columns of a row; a slice of a split
    // writes its phase sums instead, for the finishing pass
    hop::cluster_sync();
    float* zt = reinterpret_cast<float*>(sb);  // [feature][sample], FT_OUT_LD apart
    bool big = false;  // a phase of this thread's that the recompute must take
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z = acc[4 * j + 2 * i + e];
          zt[(8 * j + 2 * tq + e) * FT_OUT_LD + m0 + 8 * i] = z;
          big |= !a.part && f0 + 8 * j + 2 * tq + e < a.nf && col0 + m0 + 8 * i < a.n_valid &&
                 fabsf(z) >= FT_EXACT_PHASE;
        }
    if (__any_sync(0xffffffffu, big) && lane == 0) hop::red_or_cluster(hop::mapa(flag, 0), 1u);
    hop::cluster_sync();  // the phases in shared memory; the cluster's flag
    const int64_t dofs = int64_t(blockIdx.z) * a.draw_stride;
    const int u = threadIdx.x - FT_PT;
    if (hop::ld_cluster_u32(hop::mapa(flag, 0))) {
      // one ULP of a phase |z| >= 64 moves cos by >= 64 2^-24, and the split
      // products with the tensor cores' truncating additions round
      // differently from fp32: recompute the tile as fp32's FMA chain over k
      // in order (the plain version's sgemm) and keep it where |z| >= 64.
      // Thread (tf, tc) owns features 4 tf + {0..3, 64..67} and samples
      // 4 tc + {0..3, 64..67}
      const int tf = u / 16, tc = u % 16;
      const int n_st = (a.p + FT_RK - 1) / FT_RK;
      float r[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) r[i][j] = 0.f;
#pragma unroll 1
      for (int st = 0; st < n_st; ++st) {
        const int b = st & 1;
        hop::mbar_wait(rc_full(b), (st >> 1) & 1);
        const uint8_t* om_b = sb + (rc_om(b) - base);
        // X sample c at k: box c / 32, row k, 16-byte chunk (c % 32) / 4 ^ k % 8
        const uint8_t* x_b = sb + (rc_x(b) - base) + (tc / 8) * FT_XBOX_BYTES;
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
            const int kk = 4 * kq + q;
            const int xo = kk * 128 + (((tc % 8) ^ (kk % 8)) * 16);
            const float4 v0 = *reinterpret_cast<const float4*>(x_b + xo);
            const float4 v1 = *reinterpret_cast<const float4*>(x_b + 2 * FT_XBOX_BYTES + xo);
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
        // the warpgroup is done reading buffer b (before the async proxy
        // writes it again): release it in every CTA of the cluster (thread r
        // signals CTA r)
        hop::fence_proxy_async();
        hop::named_sync(8 + w, 128);
        if (t < static_cast<int>(ncl)) hop::mbar_arrive_cluster(hop::mapa(rc_empty(b), t));
      }
      hop::cluster_sync();  // no copy into or out of a CTA that has exited
      uint32_t taken = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int fl = 4 * tf + (i & 3) + 64 * (i >> 2), cl = 4 * tc + (j & 3) + 64 * (j >> 2);
          float& z = zt[fl * FT_OUT_LD + cl];
          if (f0 + fl < a.nf && col0 + cl < a.n_valid && fabsf(z) >= FT_EXACT_PHASE) {
            z = r[i][j];
            ++taken;
          }
        }
      if (a.stats) {
        taken = __reduce_add_sync(0xffffffffu, taken);
        if (lane == 0) atomicAdd(&a.stats[1], (unsigned long long)taken);
      }
      hop::named_sync(2, 256);
    }
#pragma unroll 1
    for (int idx = u; idx < FT_FEATS * FT_COLS; idx += 256) {
      // a warp: 32 consecutive columns of one feature row
      const int f = f0 + idx / FT_COLS;
      const int c = col0 + idx % FT_COLS;
      if (f >= a.nf || c >= a.ncols_out) continue;
      const float z = zt[(idx / FT_COLS) * FT_OUT_LD + idx % FT_COLS];
      if (a.part) {
        a.part[(int64_t(blockIdx.z) * a.nf + f) * a.ldo + c] = z;
        continue;
      }
      float sv = 0.f, cv = 0.f;
      if (c < a.n_valid) {
        sincosf(z, &sv, &cv);
        sv *= a.scale;
        cv *= a.scale;
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
// consecutive columns), 8 rows a block.  The slices' phase sums are added in
// slice order; a phase of |z| >= FT_EXACT_PHASE is recomputed from the
// operands as fp32's sequential FMA chain over all of p (the epilogue's
// rule, the same chain), Omega's row read as a broadcast and X's rows
// coalesced, by every lane of a warp that has such a phase (the others
// skip the chain); then cos and sin, columns past n_valid written as 0.
__global__ void __launch_bounds__(256)
featurize_finish_kernel(const float* __restrict__ om, int64_t ld_om, const float* __restrict__ x,
                        int64_t ldx, int slices, const FtArgs a) {
  const int f = blockIdx.y * 8 + threadIdx.x / 32;
  const int c = blockIdx.x * 32 + threadIdx.x % 32;
  if (f >= a.nf) return;  // the whole warp
  const bool valid = c < a.n_valid;
  const int64_t at = int64_t(f) * a.ldo + c;
  float z = 0.f;
  if (c < a.ncols_out) {
    z = a.part[at];
    for (int sl = 1; sl < slices; ++sl) z += a.part[int64_t(sl) * a.nf * a.ldo + at];
  }
  const bool big = valid && fabsf(z) >= FT_EXACT_PHASE;
  const uint32_t bigs = __ballot_sync(0xffffffffu, big);
  if (bigs) {
    const float* w = om + int64_t(f) * ld_om;
    const float* xc = x + a.x_col0 + (valid ? c : 0);
    float r = 0.f;
#pragma unroll 8
    for (int k = 0; k < a.p; ++k) r = fmaf(w[k], xc[int64_t(k) * ldx], r);
    if (big) z = r;
    if (a.stats && threadIdx.x % 32 == 0) atomicAdd(&a.stats[1], (unsigned long long)__popc(bigs));
  }
  if (c < a.ncols_out) {
    float sv = 0.f, cv = 0.f;
    if (valid) {
      sincosf(z, &sv, &cv);
      sv *= a.scale;
      cv *= a.scale;
    }
    a.out_c[at] = cv;
    a.out_s[at] = sv;
  }
}

// Omega an (nf, p) operand, rows ld_omega apart; x (p, ldx); ld_omega and
// ldx multiples of 4 and both 16-byte aligned (TMA).  Without a.part, one
// launch writes C and S; with it, the featurize writes `slices` phase sums
// of a.kt_per_split k-tiles each to a.part and the finishing pass writes C
// and S.
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
  cudaError_t err = launch_featurize_tf32_kernel<true>(tx, tom, FusedOmega{}, slices, a, stream);
  if (err != cudaSuccess) return err;
  featurize_finish_kernel<<<dim3((a.ncols_out + 31) / 32, (a.nf + 7) / 8), 256, 0, stream>>>(
      omega, ld_omega, x, ldx, slices, a);
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
