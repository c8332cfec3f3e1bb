// K11 on the card: blockwise online-softmax attention (GQA, causal, window).
//
// Replaces src/repro/kernels/flash_attention.py:69 (flash_attention_pallas,
// _flash_kernel), reached through kernels/ops.py:331 and, in the port, by the
// LM backbone's prefill attention (models/attention.py, the math of the
// reference's jnp blockwise scan at models/attention.py:81):
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, kvh, j] / sqrt(d)) v[b, kvh, j]
// with kvh = h / (H / KV), keys j kept where (causal: i >= j) and
// (window > 0: i - j < window).  Scores, the running max and sum and the
// accumulator are fp32; masked scores take the reference's finite -1e30
// (never -inf: exp(-inf - -inf) is NaN) and p = 0 there; the output is
// acc / max(l, 1e-30), rounded once to q's dtype.  Key tiles wholly outside
// the causal / window band of a q tile are skipped, and heavier (later)
// causal q tiles are scheduled first.  Any d and dv, any s >= 1.
//
// Bound: operations, on the bf16 tensor cores (989 TFLOP/s dense), counted as
// 2 (d + dv) per kept (query, key) pair: the same work whatever implements
// it.  At the serve shape (8, 9, 3, 2048, 64) that is 0.039 ms; the bytes
// (q, k, v read once, o written once: 50.3 MB) take 0.015 ms at 3.35 TB/s.
//
// bf16 path (flash_bf16_kernel): warp-specialised, on wgmma and TMA.
//   - Both products on the tensor cores.  S = q K^T is wgmma m64nKBKk16 with
//     q and K from shared memory (both K-major), looping over d in steps of
//     16 (d zero-padded to a multiple of 64 by TMA's fill).  O += P V is
//     wgmma m64n64k16 with P from registers and V from shared memory as the
//     transposed (MN-major) B, one per 64 columns of dv.  The S accumulator's
//     register layout is the A fragment of the PV product, so p never goes
//     through shared memory.
//   - p is kept to fp32 accuracy in the PV product: it goes in as three
//     bf16 operands, p_hi = bf16(p), p_mid = bf16(p - p_hi) and p_lo =
//     bf16(p - p_hi - p_mid), whose sum is p to 24 bits, accumulated into one
//     fp32 O.  One bf16 rounding of p puts the output far beyond the
//     one-ULP gate at unit-scale inputs; two parts (17 bits) stay within it
//     there but not once |v| reaches the model's ~60, where an output that
//     cancels is held to ~2e-5 and two parts leave 2^-17 |v|
//     (tests/test_torch_flash_numerics.py).  The split costs two extra PV
//     products, at most 2x the tensor work of QK^T + PV.
//   - A ring of K and V tiles fed by TMA: one producer thread issues
//     cp.async.bulk.tensor loads into two stages each, with mbarrier
//     arrive/expect-tx; the consumers release a stage once their wgmma on it
//     has completed.  128-byte swizzle, matching the wgmma descriptors.  The
//     tensor maps describe the (batch, head, seq) strides as they are, so the
//     model's transposed (b, s, h, d) views load without a copy; boxes past s,
//     d or dv are zero-filled by TMA, and the softmax masks the key tail.
//   - One K/V tile feeds the g = h / kv query heads of a group: a block owns
//     one q tile position of 64 rows for gb heads of one KV head, one consumer
//     warpgroup each (gb = 3 or 2); with gb = 1 (g = 1, MLA) a block takes two
//     q tiles so the ring still feeds two warpgroups.  The producer
//     warpgroup gives its registers to the consumers (setmaxnreg).
//   - The consumer warpgroups take turns issuing their products (named
//     barriers), so one's softmax runs while the next one's products hold
//     the tensor cores.  No wgmma sits behind a branch that the compiler
//     cannot prove warp-uniform: ptxas would issue every wgmma of the
//     kernel one at a time.
//   - d: q is loaded once and held in shared memory while it fits; past
//     that, q and K stream through the ring in d-chunks, so d has no limit.
//     dv up to 256 sits in one accumulator; a larger dv is split over the
//     grid in chunks of <= 256, each chunk recomputing the scores.
// fp32 path (flash_f32_kernel): the FFMA design.  fp32 operands cannot go
//   through the tensor cores within the fp32 gate of 2e-5 (TF32 keeps ~3
//   digits).  Block (q tile of 64 rows, head, batch x dv chunk), 256 threads:
//   the q tile and each 64-key K and V tile are staged in shared memory;
//   thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and keys (and output columns)
//   tx + 16 j, a 4 x 4 register tile of scores.  QK^T loops over d in chunks
//   of <= 128 (q reloaded per chunk when d needs more than one); dv is split
//   over the grid in chunks of <= 128.
// Training (lse != null): each row's log-sum-exp of its scaled scores, m +
//   log l in fp32, is written to lse (b, h, s) by the blocks of the first dv
//   chunk; the bf16 path also writes the fp32 output before its rounding to
//   o_acc (b, h, s, dv contiguous) when that is not null.  K11b
//   (flash_attention_bwd.cu) recomputes P = exp(S / sqrt(d) - lse) from them.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

struct Strides {
  int64_t b, h, s;  // in elements; the feature axis is contiguous
};

// ---------------------------------------------------------------------------
// fp32: FFMA
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBK + 4;  // rows 4 apart land 16 banks apart

template <int DP>
constexpr size_t f32_smem_bytes() {
  // q and k chunks padded by one column (conflict-free row reads), v, p
  return sizeof(float) * (2 * kBQ * (DP + 1) + kBK * DP + kBQ * kPStride);
}

// rows x (w of DP) of a [rows, DP] tile from src (row stride src_s); rows
// past `valid` and columns past w are zero
template <int DP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int64_t src_s, int valid, int w) {
  for (int idx = threadIdx.x; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    float x = 0.0f;
    if (r < valid && c < w) x = src[r * src_s + c];
    dst[r * LD + c] = x;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int n_heads, int n_kv,
                 int s, int d, int dv, int n_dvc, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window, float scale, float* __restrict__ lse) {
  extern __shared__ float smem[];
  float* q_sm = smem;                       // [kBQ][DP + 1]
  float* k_sm = q_sm + kBQ * (DP + 1);      // [kBK][DP + 1]
  float* v_sm = k_sm + kBK * (DP + 1);      // [kBK][DP]
  float* p_sm = v_sm + kBK * DP;            // [kBQ][kPStride]
  constexpr int kCols = DP / 16;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_dvc;
  const int dv0 = (blockIdx.z % n_dvc) * DP;
  const int dvw = min(DP, dv - dv0);
  const int n_dc = (d + DP - 1) / DP;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const float* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h + dv0;
  if (n_dc == 1) load_tile<DP, DP + 1>(q_sm, qb, qs.s, s - q0, d);

  // key tiles that meet the band of rows q0 .. q_last
  const int q_last = min(q0 + kBQ, s) - 1;
  const int n_kt = (s + kBK - 1) / kBK;
  const int kt_hi = causal ? q_last / kBK + 1 : n_kt;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int dc = 0; dc < n_dc; ++dc) {
      const int c0 = dc * DP;
      const int cw = min(DP, d - c0);
      __syncthreads();  // the previous chunk's q, k (and tile's v, p) are consumed
      if (n_dc > 1) load_tile<DP, DP + 1>(q_sm, qb + c0, qs.s, s - q0, cw);
      load_tile<DP, DP + 1>(k_sm, kb + k0 * ks.s + c0, ks.s, s - k0, cw);
      if (dc == n_dc - 1) load_tile<DP, DP>(v_sm, vb + k0 * vs.s, vs.s, s - k0, dvw);
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DP; ++dd) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = q_sm[(ty * 4 + i) * (DP + 1) + dd];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = k_sm[(tx + 16 * j) * (DP + 1) + dd];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < s && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.0f;
        sum += p;
        p_sm[(ty * 4 + i) * kPStride + tx + 16 * j] = p;
      }
      l[i] = corr * l[i] + sum;  // this thread's share of the row sum
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_sm[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = v_sm[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  float* ob = o + b * os.b + h * os.h + dv0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int qp = q0 + ty * 4 + i;
    if (qp >= s) continue;
    if (lse != nullptr && dv0 == 0 && tx == 0)
      lse[(static_cast<int64_t>(b) * n_heads + h) * s + qp] = m[i] + logf(li);
    const float inv = 1.0f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < dvw) ob[qp * os.s + col] = acc[i][c] * inv;
    }
  }
}

template <int DP>
cudaError_t launch_f32(const float* q, const float* k, const float* v, float* o, int b, int h,
                       int kv, int s, int d, int dv, Strides qs, Strides ks, Strides vs,
                       Strides os, int causal, int window, float scale, float* lse,
                       cudaStream_t stream) {
  constexpr size_t bytes = f32_smem_bytes<DP>();
  auto kernel = flash_f32_kernel<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int n_dvc = (dv + DP - 1) / DP;
  dim3 grid((s + kBQ - 1) / kBQ, h, b * n_dvc);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, o, h, kv, s, d, dv, n_dvc, qs, ks, vs, os,
                                           causal, window, scale, lse);
  return cudaGetLastError();
}

cudaError_t run_f32(const float* q, const float* k, const float* v, float* o, int b, int h,
                    int kv, int s, int d, int dv, Strides qs, Strides ks, Strides vs, Strides os,
                    int causal, int window, float scale, float* lse, cudaStream_t stream) {
  // the chunk width: d and dv above 128 are taken 128 at a time
  const int w = max(min(d, 128), min(dv, 128));
  if (w <= 32)
    return launch_f32<32>(q, k, v, o, b, h, kv, s, d, dv, qs, ks, vs, os, causal, window, scale,
                          lse, stream);
  if (w <= 64)
    return launch_f32<64>(q, k, v, o, b, h, kv, s, d, dv, qs, ks, vs, os, causal, window, scale,
                          lse, stream);
  return launch_f32<128>(q, k, v, o, b, h, kv, s, d, dv, qs, ks, vs, os, causal, window, scale,
                         lse, stream);
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kRows = 64;              // q rows of one consumer warpgroup (wgmma M)
constexpr int kBlockCols = 64;         // bf16 columns of one 128-byte swizzled block
constexpr int kQBlock = kRows * 128;   // bytes of a 64-row block of q
constexpr int kStages = 2;                // K and V ring stages (more measured no faster)
constexpr int kBars = 1 + 4 * kStages;  // q_full, k_full, k_empty, v_full, v_empty
constexpr int kSmemLimit = 232448;      // the H100's 227 KB a block can use

struct Bf16Cfg {
  int b, s, n_kv, g, gb, n_hb, n_qb, n_dvc;
  int d_blocks;      // d rounded up to 64, in 64-column blocks
  int chunk_blocks;  // d blocks per K-ring item (d_blocks when q is resident)
  int q_resident;    // q held in shared memory for the whole block
  int dv_out;        // columns of o
  int causal, window;
  float scale_log2;  // log2(e) / sqrt(d)
  __nv_bfloat16* o;
  Strides os;
  float* lse;    // (b, h, s) log-sum-exp a row, or null
  float* o_acc;  // (b, h, s, dv_out) fp32 output before rounding, or null
};

struct Bf16Smem {
  uint32_t q_bytes, k_stage, v_stage, total;
};

__host__ __device__ inline Bf16Smem bf16_smem(int nc, int kbk, int dvt, int d_blocks,
                                              int chunk_blocks, int q_resident) {
  Bf16Smem m;
  m.q_bytes = q_resident ? nc * d_blocks * kQBlock : 0;
  m.k_stage = (q_resident ? 0 : nc * chunk_blocks * kQBlock) + chunk_blocks * kbk * 128;
  m.v_stage = dvt / kBlockCols * kbk * 128;
  // 1024 bytes of slack to align the base for the swizzle, then the barriers
  m.total = 1024 + m.q_bytes + kStages * (m.k_stage + m.v_stage) + 8 * kBars;
  return m;
}

// key tiles [lo, hi) that meet the band of the q tile at q0 (empty past s)
template <int KBK>
__device__ __forceinline__ void key_band(const Bf16Cfg& c, int q0, int& lo, int& hi) {
  if (q0 >= c.s) {
    lo = hi = 0;
    return;
  }
  const int q_last = min(q0 + kRows, c.s) - 1;
  hi = c.causal ? q_last / KBK + 1 : (c.s + KBK - 1) / KBK;
  lo = c.window > 0 ? max(0, q0 - c.window + 1) / KBK : 0;
}

__device__ __forceinline__ bool kept(const Bf16Cfg& c, int qp, int kp) {
  return kp < c.s && (!c.causal || qp >= kp) && (c.window <= 0 || qp - kp < c.window);
}

// one tile's online softmax on the S fragment (raw scores in, p out): row
// max over the quad of lanes that share a row, m and l and the O rows
// rescaled; masked keys get the sentinel, then p = 0
template <bool kMasked, int KBK, int kVBlocks>
__device__ __forceinline__ void online_softmax(float (&sc)[KBK / 2], float (&acc)[kVBlocks][32],
                                               float (&m)[2], float (&l)[2], const Bf16Cfg& c,
                                               int r0, int quad, int k0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + 8 * r;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < KBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        if (kMasked && !kept(c, qp, k0 + 8 * j + 2 * quad + e)) x = kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * c.scale_log2);
    const float corr = hop::exp2_approx(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < KBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        const float p = hop::exp2_approx(fmaf(x, c.scale_log2, -m_new));
        x = (kMasked && x == kNegInf) ? 0.0f : p;
        sum += x;
      }
    l[r] = corr * l[r] + sum;  // this thread's share of the row sum
#pragma unroll
    for (int vb = 0; vb < kVBlocks; ++vb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[vb][4 * j + 2 * r] *= corr;
        acc[vb][4 * j + 2 * r + 1] *= corr;
      }
  }
}

// NC consumer warpgroups of 64 q rows each, KBK keys a tile, DVT columns of
// dv a block (a multiple of 64, at most 256)
template <int NC, int KBK, int DVT>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Bf16Cfg c) {
  constexpr int kVBlocks = DVT / kBlockCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  const Bf16Smem lay = bf16_smem(NC, KBK, DVT, c.d_blocks, c.chunk_blocks, c.q_resident);
  const uint32_t q_sm = base;
  const uint32_t k_sm = q_sm + lay.q_bytes;
  const uint32_t v_sm = k_sm + kStages * lay.k_stage;
  const uint32_t bars = v_sm + kStages * lay.v_stage;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto k_empty = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8u * (1 + 3 * kStages + st); };

  // block -> (q block, batch, kv head, head block, dv chunk), the heaviest
  // causal q blocks first over the whole grid
  const int inner = c.b * c.n_kv * c.n_hb * c.n_dvc;
  const int qb = c.n_qb - 1 - static_cast<int>(blockIdx.x) / inner;
  int rest = static_cast<int>(blockIdx.x) % inner;
  const int dvc = rest % c.n_dvc;
  rest /= c.n_dvc;
  const int hb = rest % c.n_hb;
  rest /= c.n_hb;
  const int kvh = rest % c.n_kv;
  const int bi = rest / c.n_kv;
  const int qt_per_block = NC / c.gb;
  auto head_of = [&](int w) { return kvh * c.g + hb * c.gb + w % c.gb; };
  auto q0_of = [&](int w) { return (qb * qt_per_block + w / c.gb) * kRows; };

  int lo = 1 << 30, hi = 0;
#pragma unroll
  for (int w = 0; w < NC; ++w) {
    int l, h;
    key_band<KBK>(c, q0_of(w), l, h);
    if (h > l) {
      lo = min(lo, l);
      hi = max(hi, h);
    }
  }
  const int n_items = (c.d_blocks + c.chunk_blocks - 1) / c.chunk_blocks;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      hop::mbar_init(k_full(st), 1);
      hop::mbar_init(v_full(st), 1);
      hop::mbar_init(k_empty(st), NC * 128);
      hop::mbar_init(v_empty(st), NC * 128);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index broadcast from lane 0, so the compiler sees every
  // branch that follows from it as warp-uniform (wgmma in a path it thinks
  // divergent is serialised)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight.  Registers
    // move to the consumers within the block's allocation: (NC + 1) x 128
    // threads at 168 (NC = 2) or 128 (NC = 3) registers
    if constexpr (NC == 3) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    }
    if (threadIdx.x != 0) return;
    if (c.q_resident) {
      hop::mbar_expect_tx(q_full, NC * c.d_blocks * kQBlock);
      for (int w = 0; w < NC; ++w)
        for (int cb = 0; cb < c.d_blocks; ++cb)
          hop::tma_load_4d(q_sm + (w * c.d_blocks + cb) * kQBlock, &tq, q_full, cb * kBlockCols,
                           q0_of(w), head_of(w), bi);
    }
    int it = 0, vt = 0;
    for (int kt = lo; kt < hi; ++kt) {
      for (int ci = 0; ci < n_items; ++ci, ++it) {
        const int st = it % kStages;
        hop::mbar_wait(k_empty(st), ((it / kStages) & 1) ^ 1);
        const int cb0 = ci * c.chunk_blocks;
        const int nb = min(c.chunk_blocks, c.d_blocks - cb0);
        const uint32_t stage = k_sm + st * lay.k_stage;
        const uint32_t q_part = c.q_resident ? 0 : NC * c.chunk_blocks * kQBlock;
        hop::mbar_expect_tx(k_full(st), (c.q_resident ? 0 : NC * nb * kQBlock) + nb * KBK * 128);
        if (!c.q_resident)
          for (int w = 0; w < NC; ++w)
            for (int j = 0; j < nb; ++j)
              hop::tma_load_4d(stage + (w * c.chunk_blocks + j) * kQBlock, &tq, k_full(st),
                               (cb0 + j) * kBlockCols, q0_of(w), head_of(w), bi);
        for (int j = 0; j < nb; ++j)
          hop::tma_load_4d(stage + q_part + j * KBK * 128, &tk, k_full(st),
                           (cb0 + j) * kBlockCols, kt * KBK, kvh, bi);
      }
      const int st = vt % kStages;
      hop::mbar_wait(v_empty(st), ((vt / kStages) & 1) ^ 1);
      hop::mbar_expect_tx(v_full(st), lay.v_stage);
      for (int j = 0; j < kVBlocks; ++j)
        hop::tma_load_4d(v_sm + st * lay.v_stage + j * KBK * 128, &tv, v_full(st),
                         dvc * DVT + j * kBlockCols, kt * KBK, kvh, bi);
      ++vt;
    }
    return;
  }

  // ---- consumers: warpgroup w owns 64 q rows of one head
  if constexpr (NC == 3) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  }
  const int w = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int head = head_of(w);
  const int q0 = q0_of(w);
  const int r0 = q0 + (t / 32) * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
  int my_lo, my_hi;
  key_band<KBK>(c, q0, my_lo, my_hi);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // m in log2 units
  float acc[kVBlocks][32];
#pragma unroll
  for (int vb = 0; vb < kVBlocks; ++vb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[vb][i] = 0.0f;
  float sc[KBK / 2];                                // S of this tile
  uint32_t p_hi[KBK / 16][4], p_mid[KBK / 16][4], p_lo[KBK / 16][4];  // the last tile's P

  // Turns: the warpgroups issue their products one after another (named
  // barrier 1 + w), so one warpgroup's softmax runs while the next one's
  // products occupy the tensor cores.  Turn i issues PV of tile i - 1 and
  // QK^T of tile i; every warpgroup takes all n + 1 turns and issues both
  // products in each (a tile outside its band has P = 0 and its S unread),
  // so no wgmma sits behind a branch.  (Overlapping a warpgroup's own
  // softmax with its PV, waiting for QK^T alone, measured slower: the p
  // fragment it needs apart from S costs registers.)  With streamed d a turn would wait on
  // K stages that the other warpgroups have yet to free, so then there are
  // no turns.
  if (c.q_resident) hop::mbar_wait(q_full, 0);
  const bool turns = n_items == 1;
  if (turns && w == NC - 1) hop::named_arrive(1, 256);  // warpgroup 0 goes first
  const int n = hi - lo;
  int it = 0;  // K-ring items consumed
  for (int i = 0; i <= n; ++i) {
    const int kt = lo + i;
    const bool qk = i < n && kt >= my_lo && kt < my_hi;
    const int vst = (i + kStages - 1) % kStages;
    if (i > 0) hop::mbar_wait(v_full(vst), ((i - 1) / kStages) & 1);
    if (i < n && n_items == 1) hop::mbar_wait(k_full(it % kStages), (it / kStages) & 1);

    if (turns) hop::named_sync(1 + w, 256);
    hop::wgmma_fence();
    if (i > 0) {
      // O += p_hi V + p_mid V + p_lo V
      const uint32_t vbase = v_sm + vst * lay.v_stage;
#pragma unroll
      for (int t16 = 0; t16 < KBK / 16; ++t16)
#pragma unroll
        for (int vb = 0; vb < kVBlocks; ++vb) {
          const uint64_t dv_desc = hop::desc_sw128(vbase + vb * KBK * 128 + t16 * 2048);
          hop::wgmma_rs_n64_tb(acc[vb], p_hi[t16], dv_desc);
          hop::wgmma_rs_n64_tb(acc[vb], p_mid[t16], dv_desc);
          hop::wgmma_rs_n64_tb(acc[vb], p_lo[t16], dv_desc);
        }
      hop::wgmma_commit();
    }
    if (i < n) {
      // S = q K^T over d, one K-ring item (a d-chunk) at a time
      for (int ci = 0; ci < n_items; ++ci) {
        const int st = (it + ci) % kStages;
        if (n_items > 1) hop::mbar_wait(k_full(st), ((it + ci) / kStages) & 1);
        const int cb0 = ci * c.chunk_blocks;
        const int nb = min(c.chunk_blocks, c.d_blocks - cb0);
        const uint32_t stage = k_sm + st * lay.k_stage;
        const uint32_t a0 = c.q_resident ? q_sm + (w * c.d_blocks + cb0) * kQBlock
                                         : stage + w * c.chunk_blocks * kQBlock;
        const uint32_t b0 = stage + (c.q_resident ? 0 : NC * c.chunk_blocks * kQBlock);
        for (int j = 0; j < nb; ++j) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_ss<KBK>(sc, hop::desc_sw128(a0 + j * kQBlock + kk * 32),
                               hop::desc_sw128(b0 + j * KBK * 128 + kk * 32),
                               (ci | j | kk) != 0);
        }
        hop::wgmma_commit();
        if (n_items > 1) {  // streamed d: free the stage before the next chunk
          hop::wgmma_wait_all();
          hop::mbar_arrive(k_empty(st));
        }
      }
    }
    if (turns && !(w == NC - 1 && i == n)) hop::named_arrive(1 + (w + 1) % NC, 256);
    hop::wgmma_wait_all();
    hop::fence_regs(sc);
#pragma unroll
    for (int vb = 0; vb < kVBlocks; ++vb) hop::fence_regs(acc[vb]);
    hop::fence_regs(p_hi);
    hop::fence_regs(p_mid);
    hop::fence_regs(p_lo);
    if (i > 0) hop::mbar_arrive(v_empty(vst));
    if (i < n) {
      if (n_items == 1) hop::mbar_arrive(k_empty(it % kStages));
      it += n_items;
    }
    if (!qk) {
#pragma unroll
      for (int t16 = 0; t16 < KBK / 16; ++t16)
#pragma unroll
        for (int r = 0; r < 4; ++r) p_hi[t16][r] = p_mid[t16][r] = p_lo[t16][r] = 0u;
      continue;
    }

    // online softmax in fp32, in log2 units; masks only on tiles that need them
    const int k0 = kt * KBK;
    if (k0 + KBK > c.s || (c.causal && k0 + KBK - 1 > q0) ||
        (c.window > 0 && q0 + kRows - 1 - k0 >= c.window))
      online_softmax<true, KBK, kVBlocks>(sc, acc, m, l, c, r0, quad, k0);
    else
      online_softmax<false, KBK, kVBlocks>(sc, acc, m, l, c, r0, quad, k0);
    // the S fragment of keys 16 t .. 16 t + 15 is the A fragment of step t
#pragma unroll
    for (int t16 = 0; t16 < KBK / 16; ++t16)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        hop::split_bf16(sc[8 * t16 + 2 * r], sc[8 * t16 + 2 * r + 1], p_hi[t16][r],
                        p_mid[t16][r], p_lo[t16][r]);
  }

  // o = acc / max(l, 1e-30), rounded once to bf16
  __nv_bfloat16* ob = c.o + bi * c.os.b + head * c.os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qp = r0 + 8 * i;
    if (qp >= c.s) continue;
    const int64_t row = (static_cast<int64_t>(bi) * c.n_kv * c.g + head) * c.s + qp;
    if (c.lse != nullptr && dvc == 0 && quad == 0)
      c.lse[row] = m[i] * 0.69314718055994531f + logf(li);  // m is in log2 units
    const float inv = 1.0f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int vb = 0; vb < kVBlocks; ++vb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = dvc * DVT + vb * kBlockCols + 8 * j + 2 * quad + e;
          if (col < c.dv_out) {
            const float x = acc[vb][4 * j + 2 * i + e] * inv;
            ob[qp * c.os.s + col] = __float2bfloat16_rn(x);
            if (c.o_acc != nullptr) c.o_acc[row * c.dv_out + col] = x;
          }
        }
  }
}

// a 4-d map of a (b, heads, s, width) bf16 tensor, feature axis contiguous,
// boxes of 64 columns x `rows`, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int width, int s, int heads, int b, Strides st,
              int rows) {
  cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  cuuint32_t box[4] = {(cuuint32_t)kBlockCols, (cuuint32_t)rows, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, int KBK, int DVT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, int h, int kv, int d, int dv,
                        Strides qs, Strides ks, Strides vs, Bf16Cfg c, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, d, c.s, h, c.b, qs, kRows) ||
      !make_map(&tk, k, d, c.s, kv, c.b, ks, KBK) || !make_map(&tv, v, dv, c.s, kv, c.b, vs, KBK))
    return cudaErrorInvalidValue;
  const Bf16Smem lay = bf16_smem(NC, KBK, DVT, c.d_blocks, c.chunk_blocks, c.q_resident);
  auto kernel = flash_bf16_kernel<NC, KBK, DVT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return err;
  const int grid = c.n_qb * c.b * c.n_kv * c.n_hb * c.n_dvc;
  kernel<<<grid, (NC + 1) * 128, lay.total, stream>>>(tq, tk, tv, c);
  return cudaGetLastError();
}

// the bf16 kernel's shape for one call: consumer warpgroups, key tile, dv
// block, and the d layout (q resident, or q and K streamed in d-chunks)
struct Bf16Plan {
  int nc, kbk, dvt;
  Bf16Cfg c;
};

Bf16Plan plan_bf16(int b, int h, int kv, int s, int d, int dv) {
  Bf16Plan p{};
  Bf16Cfg& c = p.c;
  c.b = b;
  c.s = s;
  c.n_kv = kv;
  c.g = h / kv;
  c.n_dvc = (dv + 255) / 256;
  p.dvt = ((dv + c.n_dvc - 1) / c.n_dvc + kBlockCols - 1) / kBlockCols * kBlockCols;
  // gb heads of a group share the block's K/V tiles: 3 warpgroups when g
  // divides by 3 and the fragments fit 160 registers a thread, else 2
  c.gb = (c.g % 3 == 0 && p.dvt <= 64) ? 3 : (c.g % 2 == 0 ? 2 : 1);
  p.nc = c.gb == 3 ? 3 : 2;
  c.n_hb = c.g / c.gb;
  const int n_qt = (s + kRows - 1) / kRows;
  const int qt_per_block = p.nc / c.gb;
  c.n_qb = (n_qt + qt_per_block - 1) / qt_per_block;
  c.d_blocks = (d + kBlockCols - 1) / kBlockCols;
  // 128 keys a tile with two consumer warpgroups and a 64-wide dv block
  // (240 registers a thread hold S, the three parts of P and O) where q, two
  // K stages and two V stages fit; else 64; past that, q and K stream
  // through the ring in d-chunks
  p.kbk = 64;
  c.q_resident = 1;
  c.chunk_blocks = c.d_blocks;
  if (p.nc == 2 && p.dvt == 64 &&
      bf16_smem(2, 128, p.dvt, c.d_blocks, c.d_blocks, 1).total <= kSmemLimit) {
    p.kbk = 128;
  } else if (bf16_smem(p.nc, 64, p.dvt, c.d_blocks, c.d_blocks, 1).total > kSmemLimit) {
    c.q_resident = 0;
    c.chunk_blocks = 1;
    while (c.chunk_blocks < c.d_blocks &&
           bf16_smem(p.nc, 64, p.dvt, c.d_blocks, c.chunk_blocks + 1, 0).total <= kSmemLimit)
      ++c.chunk_blocks;
  }
  return p;
}

cudaError_t run_bf16(const void* q, const void* k, const void* v, void* o, int b, int h, int kv,
                     int s, int d, int dv, int dv_out, Strides qs, Strides ks, Strides vs,
                     Strides os, int causal, int window, float scale, float* lse, float* o_acc,
                     cudaStream_t stream) {
  Bf16Plan p = plan_bf16(b, h, kv, s, d, dv);
  Bf16Cfg& c = p.c;
  c.dv_out = dv_out;
  c.causal = causal;
  c.window = window;
  c.scale_log2 = scale * 1.4426950408889634f;
  c.o = static_cast<__nv_bfloat16*>(o);
  c.os = os;
  c.lse = lse;
  c.o_acc = o_acc;
#define FA_LAUNCH(NC_, KBK_, DVT_)                                                            \
  if (p.nc == NC_ && p.kbk == KBK_ && p.dvt == DVT_)                                          \
    return launch_bf16<NC_, KBK_, DVT_>(q, k, v, h, kv, d, dv, qs, ks, vs, c, stream);
  FA_LAUNCH(3, 64, 64)
  FA_LAUNCH(2, 128, 64)
  FA_LAUNCH(2, 64, 64)
  FA_LAUNCH(2, 64, 128)
  FA_LAUNCH(2, 64, 192)
  FA_LAUNCH(2, 64, 256)
#undef FA_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, h, s, d), k (b, kv, s, d), v (b, kv, s, dv), o (b, h, s, dv_out),
// each given by its (batch, head, seq) strides in elements with the feature
// axis contiguous; dtype 0 = fp32, 1 = bf16 (all four tensors).  For bf16,
// d and dv are the widths of the tensors as given (rows zero-padded to 16
// bytes by the caller where needed) and dv_out <= dv the columns written;
// the base addresses and the strides in bytes are multiples of 16.  lse
// (b, h, s) fp32 receives each row's log-sum-exp and o_acc (b, h, s, dv_out)
// fp32 contiguous the bf16 path's output before its rounding; either may be
// null (the serve path passes both null).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape or layout
// the kernel does not take.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int dtype, int b, int h, int kv, int s, int d, int dv,
                                  int dv_out, int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                                  int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                                  int64_t vss, int64_t osb, int64_t osh, int64_t oss,
                                  int causal, int window, float scale, float* lse, float* o_acc,
                                  void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && dv_out == dv) {
    err = run_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o), b, h, kv, s, d, dv, qs,
                  ks, vs, os, causal, window, scale, lse, st);
  } else if (dtype == 1) {
    err = run_bf16(q, k, v, o, b, h, kv, s, d, dv, dv_out, qs, ks, vs, os, causal, window, scale,
                   lse, o_acc, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The bf16 plan for a shape, for reports: out[0..7] = consumer warpgroups,
// keys a tile, dv block, dv chunks over the grid, q resident (1) or
// streamed (0), d blocks a ring item, dynamic shared memory in bytes, blocks.
extern "C" int rt_flash_attention_plan(int b, int h, int kv, int s, int d, int dv, int* out) {
  const Bf16Plan p = plan_bf16(b, h, kv, s, d, dv);
  const Bf16Cfg& c = p.c;
  out[0] = p.nc;
  out[1] = p.kbk;
  out[2] = p.dvt;
  out[3] = c.n_dvc;
  out[4] = c.q_resident;
  out[5] = c.chunk_blocks;
  out[6] = static_cast<int>(
      bf16_smem(p.nc, p.kbk, p.dvt, c.d_blocks, c.chunk_blocks, c.q_resident).total);
  out[7] = c.n_qb * c.b * c.n_kv * c.n_hb * c.n_dvc;
  return 0;
}
