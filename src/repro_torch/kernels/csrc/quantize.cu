// K10 on the card: fused stochastic-rounding quantize -> dequantize.
//
// Replaces src/repro/kernels/quantize.py:37 (fake_quant_pallas,
// _fake_quant_kernel), the wire codecs' qint8/qint4 round trip inside the
// batched round engine, and the per-tensor absmax scale the reference
// computes beside it (kernels/ops.py:316-318, comm/codecs.py:166-168):
//   scale[r]  = absmax_r > 0 ? absmax_r / qmax : 1   (NaN absmax: 1)
//   out[r, i] = clip(floor(x[r, i] / scale[r] + u[r, i]), -qmax, qmax) * scale[r]
// Row r is one payload (one client's moments, W_RF or classifier leaf).
// Two entry points: rt_fake_quant_rows computes each row's scale itself (the
// codec round trip, one launch), rt_fake_quant takes the scales given.
//
// The divides are IEEE round-to-nearest (__fdiv_rn; the library is built
// without --use_fast_math): a multiply by the reciprocal flips floor() at
// quantization-bin boundaries and would part from the plain version and the
// host codec.  The clip is written with comparisons so that a NaN stays NaN,
// as torch.clamp and jnp.clip keep it.  The row maximum is exact in any
// order; fmaxf drops a NaN, so a NaN flag is carried beside it, and a row
// holding a NaN has scale 1, as jnp.where(NaN > 0, ...) gives.
//
// Bound: bytes.  Each element reads x (and u, where uniforms are given) and
// writes out: 12 (8) bytes for a compare, a divide, an add, a floor, two
// compares and a multiply.  Design of the fused kernel: a row is spread over
// a thread block cluster of up to 8 CTAs (a short row is one CTA); each CTA
// loads its slice once into registers (16-byte loads where the row length is
// a multiple of 4), reduces its absmax and NaN flag and writes them into every
// CTA of the cluster (distributed shared memory, map_shared_rank); after one
// cluster barrier each CTA reduces the partials it holds and quantizes the
// slice it holds, its uniforms loaded beside x before the
// reduction.  A slice past the registers' room is read a second time (from
// L2).  Without uniforms u is the constant 0.5 (rounding
// half up): no tensor of 0.5s is made or read.  The given-scale kernel: one
// block row per payload row (blockIdx.y), grid-stride within the row.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;
constexpr int kHold = 4;        // vectors a thread of the fused kernel holds
constexpr int kMaxCluster = 8;  // the portable cluster size

__device__ __forceinline__ float fake_quant1(float x, float u, float s, float qmax) {
  float q = floorf(__fadd_rn(__fdiv_rn(x, s), u));
  q = q < -qmax ? -qmax : (q > qmax ? qmax : q);
  return __fmul_rn(q, s);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fake_quant_kernel(const float* __restrict__ x, const float* __restrict__ u,
                  const float* __restrict__ scale, int d, float qmax, float* __restrict__ out) {
  const size_t base = size_t(blockIdx.y) * size_t(d);
  const float s = scale[blockIdx.y];
  const int stride = gridDim.x * blockDim.x;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    const float4* u4 = reinterpret_cast<const float4*>(u + base);
    float4* o4 = reinterpret_cast<float4*>(out + base);
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < (d >> 2); i += stride) {
      const float4 a = x4[i], b = u4[i];
      o4[i] = make_float4(fake_quant1(a.x, b.x, s, qmax), fake_quant1(a.y, b.y, s, qmax),
                          fake_quant1(a.z, b.z, s, qmax), fake_quant1(a.w, b.w, s, qmax));
    }
  } else {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < d; i += stride) {
      out[base + i] = fake_quant1(x[base + i], u[base + i], s, qmax);
    }
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

// u: the uniforms at p's offset, or null for the constant 0.5
template <int V>
__device__ __forceinline__ void load_u(const float* u, float (&uu)[V]) {
  if (u != nullptr) {
    load_vec<V>(u, uu);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) uu[c] = 0.5f;
  }
}

template <int V>
__device__ __forceinline__ void quant_store(float* p, const float (&x)[V], const float (&uu)[V],
                                            float s, float qmax) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(fake_quant1(x[0], uu[0], s, qmax), fake_quant1(x[1], uu[1], s, qmax),
                    fake_quant1(x[2], uu[2], s, qmax), fake_quant1(x[3], uu[3], s, qmax));
  } else {
    p[0] = fake_quant1(x[0], uu[0], s, qmax);
  }
}

// grid (cluster, rows), cluster (cluster, 1, 1) when kClustered; CTA `rank`
// of row blockIdx.y owns the row's vectors [rank * slice, min(dv, (rank + 1)
// * slice)).
template <int V, bool kClustered>
__global__ void __launch_bounds__(kThreads)
fake_quant_rows_kernel(const float* __restrict__ x, const float* __restrict__ u, int d,
                       int slice, float qmax, float* __restrict__ out) {
  namespace cg = cooperative_groups;
  __shared__ float warp_max[kThreads / 32];
  __shared__ int warp_nan[kThreads / 32];
  __shared__ float part_max[kMaxCluster];  // the cluster's CTAs' partials, by rank
  __shared__ int part_nan[kMaxCluster];
  __shared__ float row_scale;
  int rank = 0, csize = 1;
  if constexpr (kClustered) {
    rank = int(cg::this_cluster().block_rank());
    csize = int(cg::this_cluster().num_blocks());
    // announce that this CTA runs; the wait below, before any write into
    // another CTA's shared memory, then finds every CTA of the cluster started
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const int dv = d / V;
  const int beg = rank * slice;
  const int end = min(dv, beg + slice);
  const size_t base = size_t(blockIdx.y) * size_t(d);
  const float* xr = x + base;
  const float* ur = u != nullptr ? u + base : nullptr;
  float* outr = out + base;
  const bool held = end - beg <= kHold * int(blockDim.x);
  float hold[kHold][V], hold_u[kHold][V];
  float m = 0.0f;
  bool has_nan = false;
  auto take = [&](const float (&a)[V]) {
#pragma unroll
    for (int c = 0; c < V; ++c) {
      m = fmaxf(m, fabsf(a[c]));
      has_nan |= a[c] != a[c];
    }
  };
  if (held) {
#pragma unroll
    for (int q = 0; q < kHold; ++q) {
      const int i = beg + int(threadIdx.x) + q * int(blockDim.x);
      if (i < end) {
        load_vec<V>(xr + size_t(i) * V, hold[q]);
        load_u<V>(ur ? ur + size_t(i) * V : nullptr, hold_u[q]);  // in flight across the reduction
      }
    }
#pragma unroll
    for (int q = 0; q < kHold; ++q) {
      if (beg + int(threadIdx.x) + q * int(blockDim.x) < end) take(hold[q]);
    }
  } else {
    for (int i = beg + int(threadIdx.x); i < end; i += blockDim.x) {
      float a[V];
      load_vec<V>(xr + size_t(i) * V, a);
      take(a);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
  has_nan = __any_sync(0xffffffffu, has_nan);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_max[warp] = m;
    warp_nan[warp] = has_nan;
  }
  __syncthreads();
  if constexpr (kClustered) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0) {
    float mm = lane < int(blockDim.x + 31) / 32 ? warp_max[lane] : 0.0f;
    int nn = lane < int(blockDim.x + 31) / 32 ? warp_nan[lane] : 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, s));
    nn = __any_sync(0xffffffffu, nn);
    if constexpr (kClustered) {  // lane r writes this CTA's partial into CTA r
      if (lane < csize) {
        *cg::this_cluster().map_shared_rank(&part_max[rank], lane) = mm;
        *cg::this_cluster().map_shared_rank(&part_nan[rank], lane) = nn;
      }
    } else if (lane == 0) {
      row_scale = (nn == 0 && mm > 0.0f) ? __fdiv_rn(mm, qmax) : 1.0f;
    }
  }
  if constexpr (kClustered) {
    // every CTA's partial is in every CTA (the cluster barrier releases the
    // remote writes; no CTA touches another's memory after it, so any may exit)
    cg::this_cluster().sync();
    if (warp == 0) {
      float mm = lane < csize ? part_max[lane] : 0.0f;
      int nn = lane < csize ? part_nan[lane] : 0;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, s));
      nn = __any_sync(0xffffffffu, nn);
      if (lane == 0) row_scale = (nn == 0 && mm > 0.0f) ? __fdiv_rn(mm, qmax) : 1.0f;
    }
  }
  __syncthreads();
  const float s = row_scale;
  if (held) {
#pragma unroll
    for (int q = 0; q < kHold; ++q) {
      const int i = beg + int(threadIdx.x) + q * int(blockDim.x);
      if (i < end) quant_store<V>(outr + size_t(i) * V, hold[q], hold_u[q], s, qmax);
    }
  } else {
    for (int i = beg + int(threadIdx.x); i < end; i += blockDim.x) {
      float a[V], uu[V];
      load_vec<V>(xr + size_t(i) * V, a);
      load_u<V>(ur ? ur + size_t(i) * V : nullptr, uu);
      quant_store<V>(outr + size_t(i) * V, a, uu, s, qmax);
    }
  }
}

template <int V>
int launch_rows(const float* x, const float* u, int rows, int d, float qmax, float* out,
                cudaStream_t st) {
  const int dv = d / V;
  // CTAs a row: enough that each thread holds at most kHold vectors, up to 8
  int cluster = (dv + kThreads * kHold - 1) / (kThreads * kHold);
  cluster = max(1, min(kMaxCluster, cluster));
  const int slice = (dv + cluster - 1) / cluster;
  // a vector a thread where the slice allows (a short row's latency), else kHold
  const int threads = max(32, min(kThreads, (slice + 31) / 32 * 32));
  if (cluster == 1) {
    fake_quant_rows_kernel<V, false><<<dim3(1, rows), threads, 0, st>>>(x, u, d, slice, qmax,
                                                                        out);
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, rows, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return int(cudaLaunchKernelEx(&cfg, fake_quant_rows_kernel<V, true>, x, u, d, slice, qmax,
                                out));
}

}  // namespace

// x, u, out: (rows, d) fp32 contiguous; scale: (rows,) fp32.  rows <= 65535.
extern "C" int rt_fake_quant(const void* x, const void* u, const void* scale, int rows, int d,
                             float qmax, void* out, void* stream) {
  const bool vec = (d % 4) == 0;
  const int work = vec ? d / 4 : d;
  int bx = (work + kThreads - 1) / kThreads;
  bx = bx < 1 ? 1 : (bx > kMaxBlocksX ? kMaxBlocksX : bx);
  const dim3 grid(bx, rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (vec) {
    fake_quant_kernel<true><<<grid, kThreads, 0, st>>>(xp, up, sp, d, qmax, op);
  } else {
    fake_quant_kernel<false><<<grid, kThreads, 0, st>>>(xp, up, sp, d, qmax, op);
  }
  return int(cudaGetLastError());
}

// x, out: (rows, d) fp32 contiguous; u: (rows, d) fp32 contiguous or null
// (u = 0.5).  Each row's scale absmax / qmax (1 for a zero or NaN row) is
// computed in the kernel.  rows <= 65535.
extern "C" int rt_fake_quant_rows(const void* x, const void* u, int rows, int d, float qmax,
                                  void* out, void* stream) {
  const bool vec = (d % 4) == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (u == nullptr || (reinterpret_cast<uintptr_t>(u) % 16) == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* up = static_cast<const float*>(u);
  float* op = static_cast<float*>(out);
  const int err = vec ? launch_rows<4>(xp, up, rows, d, qmax, op, st)
                      : launch_rows<1>(xp, up, rows, d, qmax, op, st);
  return err != 0 ? err : int(cudaGetLastError());
}
