// K11 on the card: blockwise online-softmax attention (GQA, causal, window).
//
// Replaces src/repro/kernels/flash_attention.py:69 (flash_attention_pallas,
// _flash_kernel), reached through kernels/ops.py:331 and, in the port, by the
// LM backbone's prefill attention (models/attention.py, the math of the
// reference's jnp blockwise scan at models/attention.py:81):
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, kvh, j] / sqrt(d)) v[b, kvh, j]
// with kvh = h / (H / KV), keys j kept where (causal: i >= j) and
// (window > 0: i - j < window).  q, k and v are read as fp32 or bf16 and
// upcast on load; scores, the running max and sum and the accumulator are
// fp32, and p stays fp32 in the PV product (the reference kernel's choice;
// the jnp scan rounds p to v's dtype there).  The output is acc / max(l,
// 1e-30), rounded to q's dtype.
//
// Bound: at the serve shape, operations (a bf16 tensor-core roofline); this
// first design runs on the fp32 FFMA pipe.  Block (q tile of 64 rows, head,
// batch), 256 threads: the q tile and each 64-key K and V tile are staged in
// shared memory as fp32; thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and keys
// (and output columns) tx + 16 j, a 4 x 4 register tile of scores, so each
// shared-memory load feeds two FMAs.  The row max reduces over the 16 lanes
// of a half-warp with shuffles; p goes through shared memory to the PV
// product.  Key tiles wholly outside the causal / window band of the q tile
// are skipped; masked scores take the reference's finite -1e30 (never -inf:
// exp(-inf - -inf) is NaN) and p = 0 there.  Any s >= 1: the key tail is
// zero-filled and masked, and query rows past s are not stored.  Heavier
// (later) causal q tiles are scheduled first.  Later designs: wgmma / TMA,
// one K/V tile shared by the g heads of a group, double buffering.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBK + 4;  // rows 4 apart land 16 banks apart
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Strides {
  int64_t b, h, s;  // in elements; the feature axis is contiguous
};

template <int DP>
constexpr size_t smem_bytes() {
  // q and k tiles padded by one column (conflict-free row reads), v, p
  return sizeof(float) * (2 * kBQ * (DP + 1) + kBK * DP + kBQ * kPStride);
}

// rows x (d of DP) of a [rows, DP] tile from src (row stride src_s), upcast
// to fp32; rows past `valid` and columns past d are zero
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int64_t src_s,
                                          int valid, int d) {
  for (int idx = threadIdx.x; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    float x = 0.0f;
    if (r < valid && c < d) x = to_f32(src[r * src_s + c]);
    dst[r * LD + c] = x;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int n_heads, int n_kv,
                       int s, int d, int dv, Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* q_sm = smem;                       // [kBQ][DP + 1]
  float* k_sm = q_sm + kBQ * (DP + 1);      // [kBK][DP + 1]
  float* v_sm = k_sm + kBK * (DP + 1);      // [kBK][DP]
  float* p_sm = v_sm + kBK * DP;            // [kBQ][kPStride]
  constexpr int kCols = DP / 16;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  load_tile<T, DP, DP + 1>(q_sm, qb + q0 * qs.s, qs.s, s - q0, d);

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
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_tile<T, DP, DP + 1>(k_sm, kb + k0 * ks.s, ks.s, s - k0, d);
    load_tile<T, DP, DP>(v_sm, vb + k0 * vs.s, vs.s, s - k0, dv);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
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

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int qp = q0 + ty * 4 + i;
    if (qp >= s) continue;
    const float inv = 1.0f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) store(ob + qp * os.s + col, acc[i][c] * inv);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int h, int kv,
                   int s, int d, int dv, Strides qs, Strides ks, Strides vs, Strides os,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  auto kernel = flash_attention_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), h, kv, s, d, dv, qs, ks, vs, os, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dp, const void* q, const void* k, const void* v, void* o, int b, int h,
                     int kv, int s, int d, int dv, Strides qs, Strides ks, Strides vs,
                     Strides os, int causal, int window, float scale, cudaStream_t stream) {
  switch (dp) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, h, kv, s, d, dv, qs, ks, vs, os, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, h, kv, s, d, dv, qs, ks, vs, os, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, h, kv, s, d, dv, qs, ks, vs, os, causal, window,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, h, s, d), k (b, kv, s, d), v (b, kv, s, dv), o (b, h, s, dv), each
// given by its (batch, head, seq) strides in elements with the feature axis
// contiguous; dtype 0 = fp32, 1 = bf16 (all four tensors); dp in {32, 64,
// 128} is max(d, dv) rounded up.  Returns cudaGetLastError().
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int dtype, int dp, int b, int h, int kv, int s, int d, int dv,
                                  int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                                  int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                                  int64_t vss, int64_t osb, int64_t osh, int64_t oss,
                                  int causal, int window, float scale, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(dp, q, k, v, o, b, h, kv, s, d, dv, qs, ks, vs, os, causal, window,
                          scale, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(dp, q, k, v, o, b, h, kv, s, d, dv, qs, ks, vs, os, causal,
                                  window, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
