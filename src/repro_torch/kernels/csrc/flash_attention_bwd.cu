// K11b on the card: the backward of K11 (GQA online-softmax attention with
// causal and window masks), dQ, dK and dV from the forward's lse.
//
// Replaces no TPU kernel.  The reference differentiates its jnp blockwise
// scan (src/repro/models/attention.py:81-175) and has no Pallas backward; the
// port needs this one because its forward is a hand-written kernel
// (flash_attention.cu), which autograd cannot differentiate.  With
// scale = 1/sqrt(d), S = q K^T scale, and the forward's lse = log sum_j
// exp(S_ij) and fp32 output o (before its rounding to q's dtype):
//   D_i  = sum_c dO_ic o_ic                      (flash_bwd_delta_kernel)
//   P_ij = exp(S_ij - lse_i), kept pairs only,   dP = dO V^T,
//   dS   = P (dP - D),
//   dV_j = sum_{h in group, i} P_ij dO_i,  dK_j = scale sum_{h, i} dS_ij q_i
//                                                (the dK/dV kernels)
//   dQ_i = scale sum_j dS_ij k_j                 (the dQ kernels)
// D is taken from the fp32 output: the bf16-rounded one would put dQ and dK
// up to ~17 bf16 ULPs from the exact gradient (a CPU model of these formulas
// at unit-scale inputs).  The gradients are rounded once to the inputs'
// dtype (fp32 or bf16).  Both paths are deterministic: no atomics, each
// gradient element is written once by one block.
//
// Bound: operations.  The least work is one recompute of S and dP and the
// three products dV, dK, dQ: 2 (3 d + 2 dv) per kept (query, key) pair.  At
// smollm-135m's training shape (8, 9, 3, 2048, 64) bf16 causal that is
// 0.098 ms on the bf16 tensor cores (989 TFLOP/s); at the FFMA rate (67
// TFLOP/s) 1.44 ms, a floor no FFMA design could beat.
//
// bf16 path (flash_bwd_dkdv_tc_kernel, flash_bwd_dq_tc_kernel): every
// product on wgmma, every operand tile loaded by TMA, warp-specialised as
// K11's forward (one producer thread, a ring of stages with mbarriers,
// 128-byte swizzle; consumer warpgroups of 64 rows).
//   - One tile serves both operand forms.  A Q, K, V or dO tile of 64 rows
//     held as 128-byte bf16 rows is a K-major operand where the feature axis
//     is reduced (S^T = K Q^T, dP^T = V dO^T, S = Q K^T, dP = dO V^T) and
//     the MN-major B where the sequence axis is reduced (dV += P^T dO,
//     dK += dS^T Q, dQ += dS K): the forms of the forward's QK^T and PV.
//   - P and dS are computed in fp32 on the S and dP accumulators, whose
//     register layout is the A fragment of the next product, so neither goes
//     through shared memory.  Each enters its bf16 product as kPdsParts = 2
//     bf16 parts (hi = bf16(x), lo = bf16(x - hi): 17 bits), two wgmmas into
//     one fp32 accumulator.  One bf16 rounding lands 3-14 gate units from plain on
//     sums that cancel; two parts hold the gate at unit scale and with v at
//     a model's scale (tests/test_torch_flash_bwd_numerics.py, a CPU model
//     of these tile loops with the tensor cores' truncating additions).
//     Q, K, V and dO are bf16 already, so S and dP are exact products
//     summed in fp32.
//   - dK/dV: one block per (64 NC keys, KV head, batch, output chunk).  K and
//     V of the block's keys are loaded once and stay resident; the producer
//     streams the Q and dO tiles of the g = h / kv query heads of the group
//     over the query tiles of the causal / window band.  Each consumer
//     warpgroup owns 64 keys and runs S^T, dP^T, P^T, dS^T, dV += P^T dO and
//     dK += dS^T Q on every streamed tile, so GQA's sum stays in its
//     accumulators.  A block holds two 64-column output blocks of [dV, dK]
//     (at d = dv = 64 both, at d = dv = 128 two of one); the grid takes the
//     rest as chunks, each recomputing S (and dP where it holds dK columns):
//     a design choice for the register budget, not a runtime fallback.
//     Causal key blocks with the most queries run first; a warpgroup skips
//     the tiles of its block's band where it has no kept pair (the other
//     warpgroup's diagonal tile).
//   - dQ: one block per (64 NC queries, head, batch, output chunk), Q and dO
//     resident, K and V streamed over the key tiles of the band; S and dP
//     are recomputed and dQ += dS K.  Heaviest query blocks first.  (Atomics
//     for dQ in the dK/dV kernel would save the recompute, ~15 % of the
//     work, at the cost of determinism.)
//   - Each warpgroup runs its tiles on its own: S and dP, wait, P and dS,
//     the output products, wait.  Turns on named barriers (as the forward
//     takes), and issuing tile i - 1's output products together with tile
//     i's S and dP, both measured 4-17 % slower on an H100: the two
//     warpgroups interleave best unscheduled.
//   - Tensor maps describe the (batch, head, seq) strides as they are, so
//     the model's transposed (b, s, h, d) views load without a copy; boxes
//     past s, d or dv are zero-filled, which pads d and dv to 64 and masks
//     nothing: the score masks do.  Two consumer warpgroups share each
//     streamed tile; where the resident rows and two stages do not fit the
//     227 KB (d + dv past ~440), one warpgroup and fewer stages.  The widths
//     in 64-column blocks, d / 64 + dv / 64 rounded up, are at most 14.
// fp32 path (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): the FFMA tile of
//   K11's fp32 path, as fp32 operands cannot go through the tensor cores
//   within the fp32 gate (TF32 keeps ~3 digits).  A block of 256 threads
//   owns 64 rows (queries for dQ, keys for dK/dV); thread (ty, tx) owns
//   rows 4 ty .. 4 ty + 3 and the other side's columns tx + 16 j, a 4 x 4
//   register tile of S and of dP, and the output columns tx + 16 c of a
//   DP-wide chunk.  Operand tiles are staged in shared memory (rows padded
//   by one float), 64 x DP at a time; output widths past DP are split over
//   the grid.  Any d and dv.
// Any s >= 1, any (batch, head, seq) strides with a contiguous feature axis.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <utility>
#include <vector>

#include "hopper.cuh"

namespace {

struct Strides {
  int64_t b, h, s;  // in elements; the feature axis is contiguous
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool kept(int qp, int kp, int s, int causal, int window) {
  return qp < s && kp < s && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// D[row] = sum_c do[row][c] o[row][c]: 8 lanes a row, 4 rows a warp, each
// lane taking 8 consecutive columns at a time (16 loads in flight a lane)
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ d_o, const float* __restrict__ o,
                       float* __restrict__ delta, int n_heads, int s, int dv, Strides dos,
                       Strides os, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x / 8;
  const int sub = threadIdx.x % 8;
  float acc = 0.0f;
  if (row < rows) {
    const int i = static_cast<int>(row % s);
    const int h = static_cast<int>((row / s) % n_heads);
    const int64_t b = row / (static_cast<int64_t>(s) * n_heads);
    const T* dr = d_o + b * dos.b + h * dos.h + i * dos.s;
    const float* orow = o + b * os.b + h * os.h + i * os.s;
    for (int c0 = 8 * sub; c0 < dv; c0 += 64) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + u < dv) acc = fmaf(to_f(dr[c0 + u]), orow[c0 + u], acc);
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && row < rows) delta[row] = acc;
}

struct Args {
  const void *q, *k, *v, *d_o;
  const float *o, *lse;
  float* delta;
  void *dq, *dk, *dv;
  int b, h, kv, s, d, dvw;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float scale;
};

template <typename T>
cudaError_t launch_delta(const Args& a, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(a.b) * a.h * a.s;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 31) / 32), 256, 0, stream>>>(
      static_cast<const T*>(a.d_o), a.o, a.delta, a.h, a.s, a.dvw, a.dos, a.os, rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FFMA
// ---------------------------------------------------------------------------

constexpr int kB = 64;          // rows of a tile: queries (dQ) or keys (dK, dV)
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 rows x columns each
constexpr int kPS = kB + 4;     // row stride of the P and dS tiles (rows 4 apart: 16 banks)

// dst[r][c] (row stride DP + 1) = src[r * ld + c] for r < valid and c < w, else 0
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int64_t ld,
                                          int valid, int w) {
  for (int idx = threadIdx.x; idx < kB * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    float x = 0.0f;
    if (r < valid && c < w) x = src[r * ld + c];
    dst[r * (DP + 1) + c] = x;
  }
}

// acc[i][j] += sum_c a[4 ty + i][c] b[tx + 16 j][c] over one chunk
template <int DP>
__device__ __forceinline__ void dot_rows(float (&acc)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll 8
  for (int c = 0; c < DP; ++c) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(4 * ty + i) * (DP + 1) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * (DP + 1) + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// out[i][c] += sum_r p[4 ty + i][r] t[r][tx + 16 c], r over the 64 columns of p
template <int DP>
__device__ __forceinline__ void prod_rows(float (&out)[4][DP / 16], const float* p,
                                          const float* t, int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = p[(4 * ty + i) * kPS + r];
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      const float y = t[r * (DP + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][c] = fmaf(x[i], y, out[i][c]);
    }
  }
}

// acc += A B^T over `width` columns in chunks of DP: A's 64 rows from a (row
// stride as, a_valid rows), B's from b.  A stays in a_sm when `a_kept` (its
// width fits one chunk and it was loaded before the loop).
template <int DP>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], float* a_sm, float* b_sm,
                                         const float* a, int64_t as, int a_valid, bool a_kept,
                                         const float* b, int64_t bs, int b_valid, int width,
                                         int ty, int tx) {
  for (int c0 = 0; c0 < width; c0 += DP) {
    const int w = min(DP, width - c0);
    __syncthreads();  // the tiles' last readers are done
    if (!a_kept) load_tile<DP>(a_sm, a + c0, as, a_valid, w);
    load_tile<DP>(b_sm, b + c0, bs, b_valid, w);
    __syncthreads();
    dot_rows<DP>(acc, a_sm, b_sm, ty, tx);
  }
}

template <int DP>
constexpr size_t bwd_smem_bytes() {
  // four 64 x (DP + 1) operand tiles and two 64 x kPS tiles (P, dS)
  return sizeof(float) * (4 * kB * (DP + 1) + 2 * kB * kPS);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ d_o,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int n_heads, int n_kv,
                      int s, int d, int dvw, int n_oc, Strides qs, Strides ks, Strides vs,
                      Strides dos, Strides dks, Strides dvs, int causal, int window,
                      float scale) {
  extern __shared__ float smem[];
  float* k_sm = smem;                     // row side: K, V of this key tile
  float* v_sm = k_sm + kB * (DP + 1);
  float* q_sm = v_sm + kB * (DP + 1);     // column side: Q, dO of a query tile
  float* do_sm = q_sm + kB * (DP + 1);
  float* p_sm = do_sm + kB * (DP + 1);    // [key][query]: P^T, then dS^T
  float* ds_sm = p_sm + kB * kPS;
  constexpr int kCols = DP / 16;

  const int kt = causal ? blockIdx.x : gridDim.x - 1 - blockIdx.x;  // most queries first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z / n_oc;
  const int c0 = (blockIdx.z % n_oc) * DP;
  const bool do_k = c0 < d, do_v = c0 < dvw;
  const int g = n_heads / n_kv;
  const int k0 = kt * kB;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const float* kb = k + b * ks.b + kvh * ks.h + k0 * ks.s;
  const float* vb = v + b * vs.b + kvh * vs.h + k0 * vs.s;
  const bool k_kept = d <= DP, v_kept = dvw <= DP;
  if (k_kept) load_tile<DP>(k_sm, kb, ks.s, s - k0, d);
  if (v_kept) load_tile<DP>(v_sm, vb, vs.s, s - k0, dvw);

  // query tiles that meet the band of keys k0 .. k0 + 63
  const int n_qt = (s + kB - 1) / kB;
  const int qt_lo = causal ? k0 / kB : 0;
  const int qt_hi = window > 0 ? min(n_qt, (k0 + kB - 1 + window - 1) / kB + 1) : n_qt;

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const float* lse_h = lse + (static_cast<int64_t>(b) * n_heads + h) * s;
    const float* delta_h = delta + (static_cast<int64_t>(b) * n_heads + h) * s;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kB;
      const float* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
      const float* dob = d_o + b * dos.b + h * dos.h + q0 * dos.s;
      float st[4][4], dpt[4][4], lse_c[4], del_c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + tx + 16 * j;
        lse_c[j] = qp < s ? lse_h[qp] : 0.0f;
        del_c[j] = qp < s ? delta_h[qp] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) st[i][j] = dpt[i][j] = 0.0f;
      }
      // S^T = K Q^T and dP^T = V dO^T on this (key, query) tile pair
      tile_dot<DP>(st, k_sm, q_sm, kb, ks.s, s - k0, k_kept, qb, qs.s, s - q0, d, ty, tx);
      tile_dot<DP>(dpt, v_sm, do_sm, vb, vs.s, s - k0, v_kept, dob, dos.s, s - q0, dvw, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qp = q0 + tx + 16 * j;
          const float p = kept(qp, kp, s, causal, window) ? expf(st[i][j] * scale - lse_c[j])
                                                          : 0.0f;
          p_sm[(4 * ty + i) * kPS + tx + 16 * j] = p;
          ds_sm[(4 * ty + i) * kPS + tx + 16 * j] = p * (dpt[i][j] - del_c[j]);
        }
      }
      // the output chunk's columns of Q and dO (already staged when one chunk)
      const bool rq = do_k && d > DP, rdo = do_v && dvw > DP;
      if (rq || rdo) {
        __syncthreads();
        if (rq) load_tile<DP>(q_sm, qb + c0, qs.s, s - q0, min(DP, d - c0));
        if (rdo) load_tile<DP>(do_sm, dob + c0, dos.s, s - q0, min(DP, dvw - c0));
      }
      __syncthreads();
      if (do_v) prod_rows<DP>(acc_v, p_sm, do_sm, ty, tx);
      if (do_k) prod_rows<DP>(acc_k, ds_sm, q_sm, ty, tx);
    }
  }

  float* dkb = dk + b * dks.b + kvh * dks.h;
  float* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + 4 * ty + i;
    if (kp >= s) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + tx + 16 * c;
      if (do_k && col < d) dkb[kp * dks.s + col] = acc_k[i][c] * scale;
      if (do_v && col < dvw) dvb[kp * dvs.s + col] = acc_v[i][c];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ d_o,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int n_heads, int n_kv, int s, int d, int dvw,
                    int n_oc, Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
                    int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* q_sm = smem;                     // row side: Q, dO of this query tile
  float* do_sm = q_sm + kB * (DP + 1);
  float* k_sm = do_sm + kB * (DP + 1);    // column side: K, V of a key tile
  float* v_sm = k_sm + kB * (DP + 1);
  float* ds_sm = v_sm + kB * (DP + 1);    // [query][key]
  constexpr int kCols = DP / 16;

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // most keys first
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_oc;
  const int c0 = (blockIdx.z % n_oc) * DP;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = qt * kB;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const float* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
  const float* dob = d_o + b * dos.b + h * dos.h + q0 * dos.s;
  const float* kbase = k + b * ks.b + kvh * ks.h;
  const float* vbase = v + b * vs.b + kvh * vs.h;
  const bool q_kept = d <= DP, do_kept = dvw <= DP;
  if (q_kept) load_tile<DP>(q_sm, qb, qs.s, s - q0, d);
  if (do_kept) load_tile<DP>(do_sm, dob, dos.s, s - q0, dvw);

  float lse_r[4], del_r[4];
  const int64_t stat0 = (static_cast<int64_t>(b) * n_heads + h) * s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    lse_r[i] = qp < s ? lse[stat0 + qp] : 0.0f;
    del_r[i] = qp < s ? delta[stat0 + qp] : 0.0f;
  }

  // key tiles that meet the band of rows q0 .. q_last
  const int q_last = min(q0 + kB, s) - 1;
  const int kt_hi = causal ? q_last / kB + 1 : (s + kB - 1) / kB;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kB : 0;

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kB;
    const float* kb = kbase + k0 * ks.s;
    const float* vb = vbase + k0 * vs.s;
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
    tile_dot<DP>(sc, q_sm, k_sm, qb, qs.s, s - q0, q_kept, kb, ks.s, s - k0, d, ty, tx);
    tile_dot<DP>(dp, do_sm, v_sm, dob, dos.s, s - q0, do_kept, vb, vs.s, s - k0, dvw, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p =
            kept(qp, kp, s, causal, window) ? expf(sc[i][j] * scale - lse_r[i]) : 0.0f;
        ds_sm[(4 * ty + i) * kPS + tx + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    if (d > DP) {  // the output chunk's columns of K
      __syncthreads();
      load_tile<DP>(k_sm, kb + c0, ks.s, s - k0, min(DP, d - c0));
    }
    __syncthreads();
    prod_rows<DP>(acc, ds_sm, k_sm, ty, tx);
  }

  float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= s) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < d) dqb[qp * dqs.s + col] = acc[i][c] * scale;
    }
  }
}

template <int DP>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* d_o = static_cast<const float*>(a.d_o);
  constexpr size_t bytes = bwd_smem_bytes<DP>();
  const int n_t = (a.s + kB - 1) / kB;
  const int n_kc = (a.d + DP - 1) / DP, n_vc = (a.dvw + DP - 1) / DP;
  auto dkdv = flash_bwd_dkdv_kernel<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int n_oc = max(n_kc, n_vc);
  dkdv<<<dim3(n_t, a.kv, a.b * n_oc), kThreads, bytes, stream>>>(
      q, k, v, d_o, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.h,
      a.kv, a.s, a.d, a.dvw, n_oc, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.causal, a.window,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<DP>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(n_t, a.h, a.b * n_kc), kThreads, bytes, stream>>>(
      q, k, v, d_o, a.lse, a.delta, static_cast<float*>(a.dq), a.h, a.kv, a.s, a.d, a.dvw, n_kc,
      a.qs, a.ks, a.vs, a.dos, a.dqs, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

cudaError_t run_f32(const Args& a, cudaStream_t stream) {
  cudaError_t err = launch_delta<float>(a, stream);
  if (err != cudaSuccess) return err;
  // the chunk width: d and dv above 128 are taken 128 at a time
  const int w = max(min(a.d, 128), min(a.dvw, 128));
  if (w <= 32) return launch_f32<32>(a, stream);
  if (w <= 64) return launch_f32<64>(a, stream);
  return launch_f32<128>(a, stream);
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kRows = 64;             // rows of a consumer warpgroup and of a streamed tile
constexpr int kBlk = kRows * 128;     // bytes of 64 rows of one 64-column swizzled block
constexpr int kOutBlocks = 2;         // 64-column output blocks a dK/dV block holds
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;    // the H100's 227 KB a block can use
constexpr int kPdsParts = 2;          // bf16 parts of P and dS in their products
constexpr float kLog2e = 1.4426950408889634f;

struct TcCfg {
  int b, h, kv, g, s;
  int db, vb;        // 64-column blocks of d (q, k) and of dv (v, dO), zero-filled by TMA
  int d_out, dv_out;  // columns of the gradients
  int causal, window;
  float scale, scale_log2;  // 1 / sqrt(d) and log2(e) / sqrt(d)
  int n_rb;          // row blocks of nc x 64 rows along s
  int n_chunks;      // output chunks over the grid
  int stages;
  const float* lse;    // (b, h, s)
  const float* delta;  // (b, h, s)
  __nv_bfloat16 *dq, *dk, *dv;
  Strides dqs, dks, dvs;
};

// dynamic shared memory: 1024 bytes of slack to align the base for the
// swizzle, nc resident and `stages` streamed tiles of w blocks, the barriers
__host__ __device__ inline uint32_t tc_smem(int nc, int w, int stages) {
  return 1024 + (nc + stages) * w * kBlk + 8 * (1 + 2 * stages);
}

// a tile pair that holds a masked pair: a ragged edge, the causal diagonal,
// the window's edge
__device__ __forceinline__ bool tile_masked(const TcCfg& c, int q0, int k0) {
  return q0 + kRows > c.s || k0 + kRows > c.s || (c.causal && k0 + kRows - 1 > q0) ||
         (c.window > 0 && q0 + kRows - 1 - k0 >= c.window);
}

// a tile pair with no kept pair: past s, above the causal diagonal, or past
// the window (a warpgroup's share of its block's band can hold such tiles)
__device__ __forceinline__ bool tile_empty(const TcCfg& c, int q0, int k0) {
  return q0 >= c.s || k0 >= c.s || (c.causal && k0 > q0 + kRows - 1) ||
         (c.window > 0 && q0 - (k0 + kRows - 1) >= c.window);
}

// (p, ds) from the fp32 scores and dP of one 64 x 64 tile, in place: P =
// exp(S scale - lse) on kept pairs, else 0; dS = P (dP - D).  Element 4 jj +
// 2 i + e of a fragment is row `row0 + 8 i`, column `col0 + 8 jj + e`.  With
// kRowStats the rows are queries (the dQ kernel) and lse2 (log2 units) and
// del hold the thread's two rows; else the columns are (the dK/dV kernel)
// and they hold its 16 columns, 2 jj + e.
template <bool kMasked, bool kRowStats, bool kDs, int NS>
__device__ __forceinline__ void probs(float (&sc)[32], float (&dp)[32], const TcCfg& c, int row0,
                                      int col0, const float (&lse2)[NS], const float (&del)[NS]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * jj + 2 * i + e;
        int si, qp, kp;
        if constexpr (kRowStats) {
          si = i;
          qp = row0 + 8 * i;
          kp = col0 + 8 * jj + e;
        } else {
          si = 2 * jj + e;
          qp = col0 + 8 * jj + e;
          kp = row0 + 8 * i;
        }
        float p = hop::exp2_approx(fmaf(sc[idx], c.scale_log2, -lse2[si]));
        if (kMasked && !kept(qp, kp, c.s, c.causal, c.window)) p = 0.0f;
        sc[idx] = p;
        if constexpr (kDs) dp[idx] = p * (dp[idx] - del[si]);
      }
}

// the fragment of 64 x 64 as the A operand of four k-steps, in NP bf16
// parts: part n is bf16 of what parts 0 .. n - 1 leave of each value
template <int NP>
__device__ __forceinline__ void split_parts(const float (&x)[32], uint32_t (&parts)[NP][4][4]) {
#pragma unroll
  for (int t16 = 0; t16 < 4; ++t16)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float a = x[8 * t16 + 2 * r], b = x[8 * t16 + 2 * r + 1];
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const uint32_t pk = hop::pack_bf16(a, b);
        parts[n][t16][r] = pk;
        a -= __uint_as_float(pk << 16);
        b -= __uint_as_float(pk & 0xFFFF0000u);
      }
    }
}

// acc (64 x 64) += X B over 64 rows of B: X from registers in NP parts (the
// small ones first), B a 64 x 64 MN-major block at shared address b0
template <int NP>
__device__ __forceinline__ void product_parts(float (&acc)[32], const uint32_t (&x)[NP][4][4],
                                              uint32_t b0) {
#pragma unroll
  for (int t16 = 0; t16 < 4; ++t16) {
    const uint64_t bd = hop::desc_sw128(b0 + t16 * 2048);
#pragma unroll
    for (int n = NP - 1; n >= 0; --n) hop::wgmma_rs_n64_tb(acc, x[n][t16], bd);
  }
}

template <int NP>
__device__ __forceinline__ void fence_parts(uint32_t (&parts)[NP][4][4]) {
#pragma unroll
  for (int n = 0; n < NP; ++n) hop::fence_regs(parts[n]);
}

// acc (64 x 64) (=) A B^T over nb 64-column blocks: both K-major, A blocks at
// a0 + j kBlk, B blocks at b0 + j kBlk
__device__ __forceinline__ void product_kmajor(float (&acc)[32], uint32_t a0, uint32_t b0,
                                               int nb) {
  for (int j = 0; j < nb; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma_ss<64>(acc, hop::desc_sw128(a0 + j * kBlk + kk * 32),
                        hop::desc_sw128(b0 + j * kBlk + kk * 32), (j | kk) != 0);
  }
}

// dK and dV of 64 NC keys of one KV head: K, V resident, the group's Q and
// dO tiles streamed; output blocks chunk * 2 + j of [dV blocks, dK blocks]
template <int NC>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const TcCfg c) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int w_blocks = c.db + c.vb;
  const uint32_t res = base;                                 // [NC][K blocks, V blocks]
  const uint32_t ring = res + NC * w_blocks * kBlk;          // [stage][Q blocks, dO blocks]
  const uint32_t bars = ring + c.stages * w_blocks * kBlk;
  const uint32_t res_full = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + c.stages + st); };

  // block -> (key block, chunk, kv head, batch); causal key blocks with the
  // most queries (the first) first
  const int inner = c.n_chunks * c.kv * c.b;
  const int rb = static_cast<int>(blockIdx.x) / inner;
  int rest = static_cast<int>(blockIdx.x) % inner;
  const int chunk = rest % c.n_chunks;
  rest /= c.n_chunks;
  const int kvh = rest % c.kv;
  const int bi = rest / c.kv;
  const int k0 = rb * NC * kRows;
  // query tiles [lo, hi) that meet the band of the block's keys
  const int n_qt = (c.s + kRows - 1) / kRows;
  const int k_last = min(k0 + NC * kRows, c.s) - 1;
  const int lo = c.causal ? k0 / kRows : 0;
  const int hi = c.window > 0 ? min(n_qt, (k_last + c.window - 1) / kRows + 1) : n_qt;

  if (threadIdx.x == 0) {
    hop::mbar_init(res_full, 1);
    for (int st = 0; st < c.stages; ++st) {
      hop::mbar_init(full(st), 1);
      hop::mbar_init(empty(st), NC * 128);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index broadcast from lane 0, so every branch that follows
  // from it is warp-uniform to the compiler (no wgmma is serialised)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      hop::mbar_expect_tx(res_full, NC * w_blocks * kBlk);
      for (int w = 0; w < NC; ++w) {
        const uint32_t dst = res + w * w_blocks * kBlk;
        for (int j = 0; j < c.db; ++j)
          hop::tma_load_4d(dst + j * kBlk, &tk, res_full, j * 64, k0 + w * kRows, kvh, bi);
        for (int j = 0; j < c.vb; ++j)
          hop::tma_load_4d(dst + (c.db + j) * kBlk, &tv, res_full, j * 64, k0 + w * kRows, kvh,
                           bi);
      }
      int it = 0;
      for (int hh = 0; hh < c.g; ++hh) {
        const int head = kvh * c.g + hh;
        for (int qt = lo; qt < hi; ++qt, ++it) {
          const int st = it % c.stages;
          hop::mbar_wait(empty(st), ((it / c.stages) & 1) ^ 1);
          hop::mbar_expect_tx(full(st), w_blocks * kBlk);
          const uint32_t dst = ring + st * w_blocks * kBlk;
          for (int j = 0; j < c.db; ++j)
            hop::tma_load_4d(dst + j * kBlk, &tq, full(st), j * 64, qt * kRows, head, bi);
          for (int j = 0; j < c.vb; ++j)
            hop::tma_load_4d(dst + (c.db + j) * kBlk, &tdo, full(st), j * 64, qt * kRows, head,
                             bi);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns 64 keys
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int kw = k0 + w * kRows;
    const int kr = kw + (t / 32) * 16 + lane / 4;  // this thread's keys kr and kr + 8
    // output slot j: 1 a dV block, 2 a dK block, 0 none; its column block
    int kind[kOutBlocks], col[kOutBlocks];
    bool need_dp = false;
#pragma unroll
    for (int j = 0; j < kOutBlocks; ++j) {
      const int o = chunk * kOutBlocks + j;
      kind[j] = o < c.vb ? 1 : (o < c.vb + c.db ? 2 : 0);
      col[j] = kind[j] == 1 ? o : o - c.vb;
      need_dp |= kind[j] == 2;
    }
    float acc[kOutBlocks][32];
#pragma unroll
    for (int j = 0; j < kOutBlocks; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
    float sct[32], dpt[32];  // S^T, dP^T of this tile (keys x queries)
    uint32_t p_parts[kPdsParts][4][4], ds_parts[kPdsParts][4][4];
    const uint32_t k_res = res + w * w_blocks * kBlk;
    const uint32_t v_res = k_res + c.db * kBlk;

    hop::mbar_wait(res_full, 0);
    int it = 0;
    for (int hh = 0; hh < c.g; ++hh) {
      const int64_t stat0 = (static_cast<int64_t>(bi) * c.h + kvh * c.g + hh) * c.s;
      const float* lse_h = c.lse + stat0;
      const float* delta_h = c.delta + stat0;
      for (int qt = lo; qt < hi; ++qt, ++it) {
        const int st = it % c.stages;
        hop::mbar_wait(full(st), (it / c.stages) & 1);
        const uint32_t q_sm = ring + st * w_blocks * kBlk;
        const uint32_t do_sm = q_sm + c.db * kBlk;
        const int q0 = qt * kRows;
        if (tile_empty(c, q0, kw)) {  // the other warpgroup's diagonal or window edge
          hop::mbar_arrive(empty(st));
          continue;
        }
        // S^T = K Q^T, dP^T = V dO^T
        hop::wgmma_fence();
        product_kmajor(sct, k_res, q_sm, c.db);
        if (need_dp) product_kmajor(dpt, v_res, do_sm, c.vb);
        hop::wgmma_commit();
        // lse and D of this thread's 16 query columns, in log2 units for lse
        float lse_c[16], del_c[16];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qp = min(q0 + 8 * jj + 2 * quad + e, c.s - 1);
            lse_c[2 * jj + e] = lse_h[qp] * kLog2e;
            del_c[2 * jj + e] = need_dp ? delta_h[qp] : 0.0f;
          }
        hop::wgmma_wait_all();
        hop::fence_regs(sct);
        hop::fence_regs(dpt);
        const int col0 = q0 + 2 * quad;
        if (tile_masked(c, q0, kw)) {
          if (need_dp)
            probs<true, false, true>(sct, dpt, c, kr, col0, lse_c, del_c);
          else
            probs<true, false, false>(sct, dpt, c, kr, col0, lse_c, del_c);
        } else {
          if (need_dp)
            probs<false, false, true>(sct, dpt, c, kr, col0, lse_c, del_c);
          else
            probs<false, false, false>(sct, dpt, c, kr, col0, lse_c, del_c);
        }
        split_parts(sct, p_parts);
        if (need_dp) split_parts(dpt, ds_parts);
        // dV += P^T dO, dK += dS^T Q on the slots' column blocks
        hop::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kOutBlocks; ++j) {
          if (kind[j] == 1)
            product_parts(acc[j], p_parts, do_sm + col[j] * kBlk);
          else if (kind[j] == 2)
            product_parts(acc[j], ds_parts, q_sm + col[j] * kBlk);
        }
        hop::wgmma_commit();
        hop::wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < kOutBlocks; ++j) hop::fence_regs(acc[j]);
        fence_parts(p_parts);
        fence_parts(ds_parts);
        hop::mbar_arrive(empty(st));
      }
    }

    // dV, and dK times the scale, rounded once to bf16
#pragma unroll
    for (int j = 0; j < kOutBlocks; ++j) {
      if (kind[j] == 0) continue;
      __nv_bfloat16* out = kind[j] == 1 ? c.dv + bi * c.dvs.b + kvh * c.dvs.h
                                        : c.dk + bi * c.dks.b + kvh * c.dks.h;
      const int64_t ld = kind[j] == 1 ? c.dvs.s : c.dks.s;
      const int width = kind[j] == 1 ? c.dv_out : c.d_out;
      const float mul = kind[j] == 1 ? 1.0f : c.scale;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = kr + 8 * i;
        if (row >= c.s) continue;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = col[j] * 64 + 8 * jj + 2 * quad + e;
            if (cc < width)
              out[row * ld + cc] = __float2bfloat16_rn(acc[j][4 * jj + 2 * i + e] * mul);
          }
      }
    }
  }
}

// dQ of 64 NC queries of one head: Q, dO resident, K, V tiles streamed;
// output blocks chunk * NBQ + j of dQ's d blocks
template <int NC, int NBQ>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const TcCfg c) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int w_blocks = c.db + c.vb;
  const uint32_t res = base;                                 // [NC][Q blocks, dO blocks]
  const uint32_t ring = res + NC * w_blocks * kBlk;          // [stage][K blocks, V blocks]
  const uint32_t bars = ring + c.stages * w_blocks * kBlk;
  const uint32_t res_full = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + c.stages + st); };

  // block -> (query block, chunk, head, batch); causal query blocks with
  // the most keys (the last) first
  const int inner = c.n_chunks * c.h * c.b;
  const int rb = c.n_rb - 1 - static_cast<int>(blockIdx.x) / inner;
  int rest = static_cast<int>(blockIdx.x) % inner;
  const int chunk = rest % c.n_chunks;
  rest /= c.n_chunks;
  const int head = rest % c.h;
  const int bi = rest / c.h;
  const int kvh = head / c.g;
  const int qb0 = rb * NC * kRows;
  // key tiles [lo, hi) that meet the band of the block's queries
  const int q_last = min(qb0 + NC * kRows, c.s) - 1;
  const int hi = c.causal ? q_last / kRows + 1 : (c.s + kRows - 1) / kRows;
  const int lo = c.window > 0 ? max(0, qb0 - c.window + 1) / kRows : 0;

  if (threadIdx.x == 0) {
    hop::mbar_init(res_full, 1);
    for (int st = 0; st < c.stages; ++st) {
      hop::mbar_init(full(st), 1);
      hop::mbar_init(empty(st), NC * 128);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      hop::mbar_expect_tx(res_full, NC * w_blocks * kBlk);
      for (int w = 0; w < NC; ++w) {
        const uint32_t dst = res + w * w_blocks * kBlk;
        for (int j = 0; j < c.db; ++j)
          hop::tma_load_4d(dst + j * kBlk, &tq, res_full, j * 64, qb0 + w * kRows, head, bi);
        for (int j = 0; j < c.vb; ++j)
          hop::tma_load_4d(dst + (c.db + j) * kBlk, &tdo, res_full, j * 64, qb0 + w * kRows,
                           head, bi);
      }
      int it = 0;
      for (int kt = lo; kt < hi; ++kt, ++it) {
        const int st = it % c.stages;
        hop::mbar_wait(empty(st), ((it / c.stages) & 1) ^ 1);
        hop::mbar_expect_tx(full(st), w_blocks * kBlk);
        const uint32_t dst = ring + st * w_blocks * kBlk;
        for (int j = 0; j < c.db; ++j)
          hop::tma_load_4d(dst + j * kBlk, &tk, full(st), j * 64, kt * kRows, kvh, bi);
        for (int j = 0; j < c.vb; ++j)
          hop::tma_load_4d(dst + (c.db + j) * kBlk, &tv, full(st), j * 64, kt * kRows, kvh, bi);
      }
    }
  } else {
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int q0 = qb0 + w * kRows;
    const int qr = q0 + (t / 32) * 16 + lane / 4;  // this thread's queries qr and qr + 8
    const int64_t stat0 = (static_cast<int64_t>(bi) * c.h + head) * c.s;
    float lse_r[2], del_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = min(qr + 8 * i, c.s - 1);
      lse_r[i] = c.lse[stat0 + qp] * kLog2e;
      del_r[i] = c.delta[stat0 + qp];
    }
    float acc[NBQ][32];
#pragma unroll
    for (int j = 0; j < NBQ; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
    float sc[32], dp[32];
    uint32_t ds_parts[kPdsParts][4][4];
    const uint32_t q_res = res + w * w_blocks * kBlk;
    const uint32_t do_res = q_res + c.db * kBlk;

    hop::mbar_wait(res_full, 0);
    int it = 0;
    for (int kt = lo; kt < hi; ++kt, ++it) {
      const int st = it % c.stages;
      hop::mbar_wait(full(st), (it / c.stages) & 1);
      const uint32_t k_sm = ring + st * w_blocks * kBlk;
      const uint32_t v_sm = k_sm + c.db * kBlk;
      if (tile_empty(c, q0, kt * kRows)) {
        hop::mbar_arrive(empty(st));
        continue;
      }
      // S = Q K^T, dP = dO V^T
      hop::wgmma_fence();
      product_kmajor(sc, q_res, k_sm, c.db);
      product_kmajor(dp, do_res, v_sm, c.vb);
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(sc);
      hop::fence_regs(dp);
      const int k0 = kt * kRows;
      if (tile_masked(c, q0, k0))
        probs<true, true, true>(sc, dp, c, qr, k0 + 2 * quad, lse_r, del_r);
      else
        probs<false, true, true>(sc, dp, c, qr, k0 + 2 * quad, lse_r, del_r);
      split_parts(dp, ds_parts);
      // dQ += dS K on the chunk's column blocks
      hop::wgmma_fence();
#pragma unroll
      for (int j = 0; j < NBQ; ++j) {
        const int cb = chunk * NBQ + j;
        if (cb < c.db) product_parts(acc[j], ds_parts, k_sm + cb * kBlk);
      }
      hop::wgmma_commit();
      hop::wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < NBQ; ++j) hop::fence_regs(acc[j]);
      fence_parts(ds_parts);
      hop::mbar_arrive(empty(st));
    }

    // dQ times the scale, rounded once to bf16
    __nv_bfloat16* out = c.dq + bi * c.dqs.b + head * c.dqs.h;
#pragma unroll
    for (int j = 0; j < NBQ; ++j) {
      const int cb = chunk * NBQ + j;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qr + 8 * i;
        if (row >= c.s) continue;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = cb * 64 + 8 * jj + 2 * quad + e;
            if (cc < c.d_out)
              out[row * c.dqs.s + cc] = __float2bfloat16_rn(acc[j][4 * jj + 2 * i + e] * c.scale);
          }
      }
    }
  }
}

// a 4-d map of a (b, heads, s, width) bf16 tensor, feature axis contiguous,
// boxes of 64 columns x 64 rows, 128-byte swizzle; columns past width and
// rows past s read as 0
bool make_map(CUtensorMap* map, const void* ptr, int width, int s, int heads, int b,
              Strides st) {
  cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  cuuint32_t box[4] = {64, (cuuint32_t)kRows, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// raises a kernel's dynamic shared memory limit to the card's most, once a
// kernel and device rather than on every call
cudaError_t allow_smem(const void* kernel) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& kd : done)
    if (kd.first == kernel && kd.second == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess) done.emplace_back(kernel, dev);
  return err;
}

template <typename K>
cudaError_t launch_tc(K kernel, int nc, int grid, const CUtensorMap& tq, const CUtensorMap& tk,
                      const CUtensorMap& tv, const CUtensorMap& tdo, const TcCfg& c,
                      cudaStream_t stream) {
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  kernel<<<grid, (nc + 1) * 128, tc_smem(nc, c.db + c.vb, c.stages), stream>>>(tq, tk, tv, tdo,
                                                                               c);
  return cudaGetLastError();
}

// How the bf16 kernels take db and vb 64-column blocks of d and dv: two
// consumer warpgroups and the most stages that fit, one warpgroup where the
// resident rows and two stages of two do not (nc 0: past 14 blocks); the
// dK/dV kernel's output chunks of kOutBlocks, the dQ kernel's of nbq.
struct TcPlan {
  int nc = 0, stages = 0, kv_chunks = 0, nbq = 0, q_chunks = 0;
};

TcPlan tc_plan(int db, int vb) {
  TcPlan p;
  const int w_blocks = db + vb;
  for (int cand = 2; cand >= 1 && !p.nc; --cand)
    for (int st = kMaxStages; st >= (cand == 2 ? 2 : 1) && !p.nc; --st)
      if (tc_smem(cand, w_blocks, st) <= kSmemLimit) {
        p.nc = cand;
        p.stages = st;
      }
  p.kv_chunks = (w_blocks + kOutBlocks - 1) / kOutBlocks;
  p.nbq = db == 1 ? 1 : 2;
  p.q_chunks = (db + p.nbq - 1) / p.nbq;
  return p;
}

cudaError_t run_bf16(const Args& a, cudaStream_t stream) {
  TcCfg c{};
  c.b = a.b;
  c.h = a.h;
  c.kv = a.kv;
  c.g = a.h / a.kv;
  c.s = a.s;
  c.db = (a.d + 63) / 64;
  c.vb = (a.dvw + 63) / 64;
  c.d_out = a.d;
  c.dv_out = a.dvw;
  c.causal = a.causal;
  c.window = a.window;
  c.scale = a.scale;
  c.scale_log2 = a.scale * kLog2e;
  c.lse = a.lse;
  c.delta = a.delta;
  c.dq = static_cast<__nv_bfloat16*>(a.dq);
  c.dk = static_cast<__nv_bfloat16*>(a.dk);
  c.dv = static_cast<__nv_bfloat16*>(a.dv);
  c.dqs = a.dqs;
  c.dks = a.dks;
  c.dvs = a.dvs;
  const TcPlan plan = tc_plan(c.db, c.vb);
  const int nc = plan.nc;
  if (!nc) return cudaErrorInvalidValue;
  c.stages = plan.stages;

  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, a.q, a.d, a.s, a.h, a.b, a.qs) ||
      !make_map(&tk, a.k, a.d, a.s, a.kv, a.b, a.ks) ||
      !make_map(&tv, a.v, a.dvw, a.s, a.kv, a.b, a.vs) ||
      !make_map(&tdo, a.d_o, a.dvw, a.s, a.h, a.b, a.dos))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_delta<__nv_bfloat16>(a, stream);
  if (err != cudaSuccess) return err;

  c.n_rb = (a.s + nc * kRows - 1) / (nc * kRows);
  c.n_chunks = plan.kv_chunks;
  const int grid_kv = c.n_rb * c.n_chunks * c.kv * c.b;
  err = nc == 2 ? launch_tc(flash_bwd_dkdv_tc_kernel<2>, 2, grid_kv, tq, tk, tv, tdo, c, stream)
                : launch_tc(flash_bwd_dkdv_tc_kernel<1>, 1, grid_kv, tq, tk, tv, tdo, c, stream);
  if (err != cudaSuccess) return err;

  c.n_chunks = plan.q_chunks;
  const int grid_q = c.n_rb * c.n_chunks * c.h * c.b;
  if (nc == 2)
    return plan.nbq == 1
               ? launch_tc(flash_bwd_dq_tc_kernel<2, 1>, 2, grid_q, tq, tk, tv, tdo, c, stream)
               : launch_tc(flash_bwd_dq_tc_kernel<2, 2>, 2, grid_q, tq, tk, tv, tdo, c, stream);
  return plan.nbq == 1
             ? launch_tc(flash_bwd_dq_tc_kernel<1, 1>, 1, grid_q, tq, tk, tv, tdo, c, stream)
             : launch_tc(flash_bwd_dq_tc_kernel<1, 2>, 1, grid_q, tq, tk, tv, tdo, c, stream);
}

}  // namespace

// How the bf16 kernels run d and dv (for reports): out = {consumer
// warpgroups, stages, bf16 parts of P and dS, dK/dV output chunks, dQ
// output chunks, dynamic shared memory bytes}.  cudaErrorInvalidValue where
// the widths do not fit, as rt_flash_attention_bwd returns then.
extern "C" int rt_flash_attention_bwd_plan(int d, int dv, int* out) {
  const int db = (d + 63) / 64, vb = (dv + 63) / 64;
  const TcPlan p = tc_plan(db, vb);
  if (!p.nc) return static_cast<int>(cudaErrorInvalidValue);
  const int plan[6] = {p.nc, p.stages, kPdsParts, p.kv_chunks, p.q_chunks,
                       static_cast<int>(tc_smem(p.nc, db + vb, p.stages))};
  for (int i = 0; i < 6; ++i) out[i] = plan[i];
  return 0;
}

// q (b, h, s, d), k (b, kv, s, d), v (b, kv, s, dv), do (b, h, s, dv) and the
// gradients dq, dk, dv of the same shapes, all of one dtype (0 = fp32, 1 =
// bf16), each given by its (batch, head, seq) strides in elements with the
// feature axis contiguous; o (b, h, s, dv) the forward's fp32 output before
// rounding (strides likewise), lse (b, h, s) fp32 contiguous, delta a (b, h,
// s) fp32 workspace.  For bf16 the base addresses of q, k, v and do and their
// strides in bytes are multiples of 16 (rows zero-padded by the caller where
// needed; d and dv stay the widths of the gradients), and ceil(d / 64) +
// ceil(dv / 64) <= 14.  Launches three kernels on `stream`: D, dK/dV, dQ.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a dtype, width or
// layout it does not take.
extern "C" int rt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const float* o, const void* d_o,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int b, int h,
    int kv, int s, int d, int dvw, int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
    int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
    int64_t oss, int64_t dosb, int64_t dosh, int64_t doss, int64_t dqsb, int64_t dqsh,
    int64_t dqss, int64_t dksb, int64_t dksh, int64_t dkss, int64_t dvsb, int64_t dvsh,
    int64_t dvss, int causal, int window, float scale, void* stream) {
  Args a{q, k, v, d_o, o, lse, delta, dq, dk, dv, b, h, kv, s, d, dvw,
         Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss}, Strides{vsb, vsh, vss},
         Strides{osb, osh, oss}, Strides{dosb, dosh, doss}, Strides{dqsb, dqsh, dqss},
         Strides{dksb, dksh, dkss}, Strides{dvsb, dvsh, dvss}, causal, window, scale};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = run_f32(a, st);
  } else if (dtype == 1) {
    err = run_bf16(a, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
