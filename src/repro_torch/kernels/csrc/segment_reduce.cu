// K9 on the card: weighted segment reduce of the two-tier fleet merges.
//
// Replaces src/repro/kernels/segment_reduce.py:49 (segment_reduce_pallas,
// _segment_reduce_kernel), reached through kernels/ops.py:266-295 and
// federated/aggregation.py:88-108 (edge_weighted_sums):
//   out[e, d] = sum_k M[e, k] * w[k] * v[k, d]
// with M the (E, K) 0/1 membership of seg_ids.  The reference contracts the
// dense weighted membership (onehot(seg) * w) against the values; a non-member
// row then enters every sum as 0 * w_k * v[k, d], which is NaN when v[k, d] or
// w_k is not finite.  So a non-finite value in column d of one edge spreads to
// every other edge's column d, and the kernel keeps that: it sums each edge's
// members in ascending k, and the last block to finish a column tile writes
// NaN to out[e, d] wherever a non-member of e is non-finite in column d.  It
// records, per column, the smallest and largest edge holding a non-finite
// (value, weight) pair; out[e, d] keeps its own sum only when both are e.
//
// Bound: bytes.  Every value is read once (each row belongs to one edge) for
// one FMA; the (E, D) output is written once.  Design: block (tile, e) owns
// 256 columns of edge e, one thread per column, loads coalesced along the
// row.  The block gathers its members itself, in ascending k, chunk by chunk
// into shared memory (row index and weight), so no CSR is built outside the
// kernel; then each thread walks that list.  D may be odd (the hierarchy's
// ones column), so the loads are scalar.  The cross-block NaN rule costs two
// atomicMax per column that holds a non-finite member value, and one atomic
// per block to find the last block of each column tile.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ v, const int* __restrict__ seg,
                      const float* __restrict__ w, int k_rows, int d, int n_seg,
                      float* __restrict__ out, int* __restrict__ flags,
                      unsigned* __restrict__ done) {
  __shared__ int mem_k[kChunk];
  __shared__ float mem_w[kChunk];
  __shared__ int warp_sum[kWarps];
  __shared__ bool last_block;
  const int e = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const bool live = col < d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc = 0.0f;
  int bad = 0;
  for (int base = 0; base < k_rows; base += kChunk) {
    // gather this chunk's members of e, in ascending k
    const int k0 = base + threadIdx.x * kPerThread;
    unsigned hit = 0;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (k0 + q < k_rows && seg[k0 + q] == e) hit |= 1u << q;
    }
    const int cnt = __popc(hit);
    int incl = cnt;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int off = incl - cnt, total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int s = warp_sum[i];
      off += i < warp ? s : 0;
      total += s;
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (hit & (1u << q)) {
        mem_k[off] = k0 + q;
        mem_w[off] = w[k0 + q];
        ++off;
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int j = 0; j < total; ++j) {
        const float x = v[size_t(mem_k[j]) * size_t(d) + col];
        const float wk = mem_w[j];
        bad += !(isfinite(x) && isfinite(wk));
        acc = fmaf(wk, x, acc);
      }
    }
    __syncthreads();  // the next chunk reuses mem_k, mem_w and warp_sum
  }
  if (live) {
    out[size_t(e) * size_t(d) + col] = acc;
    if (bad) {
      atomicMax(&flags[col], e + 1);          // largest edge + 1
      atomicMax(&flags[d + col], n_seg - e);  // n_seg - smallest edge
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last_block = atomicAdd(&done[blockIdx.x], 1u) == unsigned(n_seg - 1);
  }
  __syncthreads();
  if (!last_block || !live) return;
  const int hi = atomicAdd(&flags[col], 0);  // read through L2
  if (hi == 0) return;
  const int e_max = hi - 1;
  const int e_min = n_seg - atomicAdd(&flags[d + col], 0);
  const float nan = __int_as_float(0x7fc00000);
  for (int e2 = 0; e2 < n_seg; ++e2) {
    if (e_min != e_max || e2 != e_min) out[size_t(e2) * size_t(d) + col] = nan;
  }
}

}  // namespace

// v: (k_rows, d) fp32; seg: (k_rows,) int32 in [0, n_seg); w: (k_rows,) fp32;
// out: (n_seg, d) fp32; flags: (2 d,) int32 zeros; done: (ceil(d / 256),)
// uint32 zeros.  All contiguous.  n_seg <= 65535 (gridDim.y).
extern "C" int rt_segment_reduce(const void* v, const void* seg, const void* w, int k_rows, int d,
                                 int n_seg, void* out, void* flags, void* done, void* stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, n_seg);
  segment_reduce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int*>(seg), static_cast<const float*>(w),
      k_rows, d, n_seg, static_cast<float*>(out), static_cast<int*>(flags),
      static_cast<unsigned*>(done));
  return int(cudaGetLastError());
}
