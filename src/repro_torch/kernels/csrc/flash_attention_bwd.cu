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
//                                                (flash_bwd_dkdv_kernel)
//   dQ_i = scale sum_j dS_ij k_j                 (flash_bwd_dq_kernel)
// D is taken from the fp32 output: the bf16-rounded one would put dQ and dK
// up to ~17 bf16 ULPs from the exact gradient (a CPU model of these formulas
// at unit-scale inputs).  Everything is fp32; the gradients are rounded once
// to the inputs' dtype (fp32 or bf16).
//
// Bound: operations.  The least work is one recompute of S and dP and the
// three products dV, dK, dQ: 2 (3 d + 2 dv) per kept (query, key) pair.  At
// smollm-135m's training shape (8, 9, 3, 2048, 64) bf16 causal that is
// 0.098 ms on the bf16 tensor cores (989 TFLOP/s) and 1.44 ms at the FFMA
// rate (67 TFLOP/s) this design runs at.
//
// Design (simple and deterministic; tensor cores are later work): the FFMA
// tile of K11's fp32 path.  A block of 256 threads owns 64 rows (queries for
// dQ, keys for dK/dV); thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and the
// other side's columns tx + 16 j, a 4 x 4 register tile of S and of dP, and
// the output columns tx + 16 c of a DP-wide chunk.  Operand tiles are staged
// in shared memory as fp32 (rows padded by one float), 64 x DP at a time, d
// and dv in chunks of DP; a row-side tile whose width fits one chunk is
// loaded once a block.  Output widths past DP are split over the grid, each
// chunk recomputing S and dP.
//   dK/dV: one block per (key tile, KV head, batch x output chunk).  It loops
//     over the g = h / kv query heads of its group and over the query tiles
//     that meet its key tile's causal / window band, so GQA's sum stays in
//     the block's registers: no atomics, and each dK and dV element is
//     written once.  Key tiles with the most queries (causal: the first)
//     are scheduled first.
//   dQ: one block per (query tile, head, batch x output chunk), looping over
//     the key tiles in the band, heaviest query tiles first.
// Any d and dv, any s >= 1, any (batch, head, seq) strides with a contiguous
// feature axis.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kB = 64;          // rows of a tile: queries (dQ) or keys (dK, dV)
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 rows x columns each
constexpr int kPS = kB + 4;     // row stride of the P and dS tiles (rows 4 apart: 16 banks)

struct Strides {
  int64_t b, h, s;  // in elements; the feature axis is contiguous
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool kept(int qp, int kp, int s, int causal, int window) {
  return qp < s && kp < s && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// dst[r][c] (row stride DP + 1) = src[r * ld + c] as fp32 for r < valid and
// c < w, else 0
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int64_t ld,
                                          int valid, int w) {
  for (int idx = threadIdx.x; idx < kB * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    float x = 0.0f;
    if (r < valid && c < w) x = to_f(src[r * ld + c]);
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
template <typename T, int DP>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], float* a_sm, float* b_sm,
                                         const T* a, int64_t as, int a_valid, bool a_kept,
                                         const T* b, int64_t bs, int b_valid, int width, int ty,
                                         int tx) {
  for (int c0 = 0; c0 < width; c0 += DP) {
    const int w = min(DP, width - c0);
    __syncthreads();  // the tiles' last readers are done
    if (!a_kept) load_tile<T, DP>(a_sm, a + c0, as, a_valid, w);
    load_tile<T, DP>(b_sm, b + c0, bs, b_valid, w);
    __syncthreads();
    dot_rows<DP>(acc, a_sm, b_sm, ty, tx);
  }
}

// D[row] = sum_c do[row][c] o[row][c], one warp a row
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ d_o, const float* __restrict__ o,
                       float* __restrict__ delta, int n_heads, int s, int dv, Strides dos,
                       Strides os, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int i = static_cast<int>(row % s);
  const int h = static_cast<int>((row / s) % n_heads);
  const int64_t b = row / (static_cast<int64_t>(s) * n_heads);
  const T* dr = d_o + b * dos.b + h * dos.h + i * dos.s;
  const float* orow = o + b * os.b + h * os.h + i * os.s;
  float acc = 0.0f;
  for (int c = threadIdx.x % 32; c < dv; c += 32) acc = fmaf(to_f(dr[c]), orow[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) delta[row] = acc;
}

template <int DP>
constexpr size_t bwd_smem_bytes() {
  // four 64 x (DP + 1) operand tiles and two 64 x kPS tiles (P, dS)
  return sizeof(float) * (4 * kB * (DP + 1) + 2 * kB * kPS);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ d_o, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int n_heads, int n_kv, int s, int d, int dvw, int n_oc, Strides qs,
                      Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, int causal,
                      int window, float scale) {
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

  const T* kb = k + b * ks.b + kvh * ks.h + k0 * ks.s;
  const T* vb = v + b * vs.b + kvh * vs.h + k0 * vs.s;
  const bool k_kept = d <= DP, v_kept = dvw <= DP;
  if (k_kept) load_tile<T, DP>(k_sm, kb, ks.s, s - k0, d);
  if (v_kept) load_tile<T, DP>(v_sm, vb, vs.s, s - k0, dvw);

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
      const T* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
      const T* dob = d_o + b * dos.b + h * dos.h + q0 * dos.s;
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
      tile_dot<T, DP>(st, k_sm, q_sm, kb, ks.s, s - k0, k_kept, qb, qs.s, s - q0, d, ty, tx);
      tile_dot<T, DP>(dpt, v_sm, do_sm, vb, vs.s, s - k0, v_kept, dob, dos.s, s - q0, dvw, ty,
                      tx);
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
        if (rq) load_tile<T, DP>(q_sm, qb + c0, qs.s, s - q0, min(DP, d - c0));
        if (rdo) load_tile<T, DP>(do_sm, dob + c0, dos.s, s - q0, min(DP, dvw - c0));
      }
      __syncthreads();
      if (do_v) prod_rows<DP>(acc_v, p_sm, do_sm, ty, tx);
      if (do_k) prod_rows<DP>(acc_k, ds_sm, q_sm, ty, tx);
    }
  }

  T* dkb = dk + b * dks.b + kvh * dks.h;
  T* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + 4 * ty + i;
    if (kp >= s) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + tx + 16 * c;
      if (do_k && col < d) dkb[kp * dks.s + col] = from_f<T>(acc_k[i][c] * scale);
      if (do_v && col < dvw) dvb[kp * dvs.s + col] = from_f<T>(acc_v[i][c]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ d_o, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int n_heads, int n_kv,
                    int s, int d, int dvw, int n_oc, Strides qs, Strides ks, Strides vs,
                    Strides dos, Strides dqs, int causal, int window, float scale) {
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

  const T* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
  const T* dob = d_o + b * dos.b + h * dos.h + q0 * dos.s;
  const T* kbase = k + b * ks.b + kvh * ks.h;
  const T* vbase = v + b * vs.b + kvh * vs.h;
  const bool q_kept = d <= DP, do_kept = dvw <= DP;
  if (q_kept) load_tile<T, DP>(q_sm, qb, qs.s, s - q0, d);
  if (do_kept) load_tile<T, DP>(do_sm, dob, dos.s, s - q0, dvw);

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
    const T* kb = kbase + k0 * ks.s;
    const T* vb = vbase + k0 * vs.s;
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
    tile_dot<T, DP>(sc, q_sm, k_sm, qb, qs.s, s - q0, q_kept, kb, ks.s, s - k0, d, ty, tx);
    tile_dot<T, DP>(dp, do_sm, v_sm, dob, dos.s, s - q0, do_kept, vb, vs.s, s - k0, dvw, ty, tx);
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
      load_tile<T, DP>(k_sm, kb + c0, ks.s, s - k0, min(DP, d - c0));
    }
    __syncthreads();
    prod_rows<DP>(acc, ds_sm, k_sm, ty, tx);
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= s) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < d) dqb[qp * dqs.s + col] = from_f<T>(acc[i][c] * scale);
    }
  }
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

template <typename T, int DP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* d_o = static_cast<const T*>(a.d_o);
  const int64_t rows = static_cast<int64_t>(a.b) * a.h * a.s;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      d_o, a.o, a.delta, a.h, a.s, a.dvw, a.dos, a.os, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t bytes = bwd_smem_bytes<DP>();
  const int n_t = (a.s + kB - 1) / kB;
  const int n_kc = (a.d + DP - 1) / DP, n_vc = (a.dvw + DP - 1) / DP;
  auto dkdv = flash_bwd_dkdv_kernel<T, DP>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int n_oc = max(n_kc, n_vc);
  dkdv<<<dim3(n_t, a.kv, a.b * n_oc), kThreads, bytes, stream>>>(
      q, k, v, d_o, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.h, a.kv,
      a.s, a.d, a.dvw, n_oc, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.causal, a.window,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, DP>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(n_t, a.h, a.b * n_kc), kThreads, bytes, stream>>>(
      q, k, v, d_o, a.lse, a.delta, static_cast<T*>(a.dq), a.h, a.kv, a.s, a.d, a.dvw, n_kc,
      a.qs, a.ks, a.vs, a.dos, a.dqs, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Args& a, cudaStream_t stream) {
  // the chunk width: d and dv above 128 are taken 128 at a time
  const int w = max(min(a.d, 128), min(a.dvw, 128));
  if (w <= 32) return launch<T, 32>(a, stream);
  if (w <= 64) return launch<T, 64>(a, stream);
  return launch<T, 128>(a, stream);
}

}  // namespace

// q (b, h, s, d), k (b, kv, s, d), v (b, kv, s, dv), do (b, h, s, dv) and the
// gradients dq, dk, dv of the same shapes, all of one dtype (0 = fp32, 1 =
// bf16), each given by its (batch, head, seq) strides in elements with the
// feature axis contiguous; o (b, h, s, dv) the forward's fp32 output before
// rounding (strides likewise), lse (b, h, s) fp32 contiguous, delta a (b, h,
// s) fp32 workspace.  Launches three kernels on `stream`: D, dK/dV, dQ.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a dtype it does
// not take.
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
    err = run<float>(a, st);
  } else if (dtype == 1) {
    err = run<__nv_bfloat16>(a, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
