// K9 on the card: weighted segment reduce of the two-tier fleet merges, and
// the edge masses beside it.
//
// Replaces src/repro/kernels/segment_reduce.py:49 (segment_reduce_pallas,
// _segment_reduce_kernel), reached through kernels/ops.py:266-295 and
// federated/aggregation.py:88-108 (edge_weighted_sums), and the ones column
// that fleet/hierarchy.py:49-60 appends to get the masses from it:
//   out[e, d] = sum_k M[e, k] * w[k] * v[k, d],   mass[e] = sum_k M[e, k] * w[k]
// with M the (E, K) 0/1 membership of the segment ids.  The reference
// contracts the dense weighted membership (onehot(seg) * w) against the
// values; a non-member row then enters every sum as 0 * w_k * v[k, d], which
// is NaN when v[k, d] or w_k is not finite.  So a non-finite (value, weight)
// pair in column d of one edge spreads NaN to every other edge's column d
// (and a non-finite weight to every other edge's mass), and the kernel keeps
// that: out[e, d] keeps its own sum only when every non-finite pair of
// column d lies in edge e.  A row whose id lies outside [0, E) is in no edge
// and, when non-finite, makes the column NaN in every edge.
//
// The membership comes as a plan, built once per topology: the row indices
// grouped by edge in ascending k (`order`) and the (E + 1) offsets (`offs`),
// edge e's rows order[offs[e], offs[e+1]), the rows with ids below 0 before
// offs[0] and those at or past E after offs[E].  Each edge's sum is one fmaf
// a member in ascending k, so two calls agree bit for bit, and with the
// sums of the ones-column kernel this replaces.
//
// Bound: bytes.  Every value is read once (each row belongs to one edge) for
// one FMA; the (E, D) sums and the (E,) masses are written once.  Design:
//  - 16-byte loads where D % 4 == 0 (and the rows are 16-byte aligned),
//    scalar loads otherwise; a thread owns V = 4 or 1 columns;
//  - a member batch of kB rows has its loads in flight before the first
//    add: kB = 16 where the launch is too small to fill the SMs (a 16-member
//    edge is then one memory round trip, not sixteen), kB = 2 where it fills
//    them many times over (few registers, more warps to hide the latency);
//  - the member loop has no guard on the columns (a thread whose columns lie
//    past the row sums the weights alone, outside it): a guard inside made
//    every load a branch and held the small merge back;
//  - the edge's and the outside rows' offsets are loaded together up front;
//  - no per-call scratch: a block owns (column tile, edge), each warp's lanes
//    one row segment (up to 512 contiguous bytes a load); the flags (the
//    smallest and largest edge holding a non-finite pair of a column) meet in
//    a device workspace zeroed once by the wrapper, and the last block of each
//    column tile spreads the NaNs and resets its part of the workspace for
//    the next call.  (A cluster owning a column tile across all edges, its
//    flags meeting in distributed shared memory, needs no workspace but was
//    slower at both of FL's shapes; PERF.md has its times.)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int V>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// Rows order[beg, end) over the V columns at `col` (all inside the row):
// acc[c] = sum w_k v[k, col + c] in ascending k (one fmaf a member), wsum =
// sum w_k in the same order.  Bit c of the result is set when column col + c
// holds a non-finite value or weight among the rows; wbad when a weight is
// non-finite.  The probes fmaf(0, x, p) stay 0 until x is Inf or NaN, and
// then stay NaN.
template <int V, int kB>
__device__ __forceinline__ unsigned edge_sum(const float* __restrict__ v,
                                             const int* __restrict__ order,
                                             const float* __restrict__ w, int beg, int end,
                                             size_t d, int col, float (&acc)[V], float& wsum,
                                             bool& wbad) {
  float probe[V], wprobe = 0.0f;
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = probe[c] = 0.0f;
  wsum = 0.0f;
  for (int j0 = beg; j0 < end; j0 += kB) {
    const int n = min(kB, end - j0);
    int kk[kB];
    float wk[kB];
    float x[kB][V];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      if (q < n) kk[q] = __ldg(order + j0 + q);
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      if (q < n) {
        wk[q] = __ldg(w + kk[q]);
        load_cols<V>(v + size_t(kk[q]) * d + col, x[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      if (q < n) {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          acc[c] = fmaf(wk[q], x[q][c], acc[c]);
          probe[c] = fmaf(0.0f, x[q][c], probe[c]);
        }
        wsum += wk[q];
        wprobe = fmaf(0.0f, wk[q], wprobe);
      }
    }
  }
  wbad = wprobe != 0.0f;
  unsigned bad = 0;
#pragma unroll
  for (int c = 0; c < V; ++c) bad |= unsigned(wbad || probe[c] != 0.0f) << c;
  return bad;
}

// edge_sum's wsum and wbad alone, for a thread whose columns lie past the row
// (it still writes the masses where D is 0).
__device__ __forceinline__ float weight_sum(const int* __restrict__ order,
                                            const float* __restrict__ w, int beg, int end,
                                            bool& wbad) {
  float wsum = 0.0f, wprobe = 0.0f;
  for (int j = beg; j < end; ++j) {
    const float wk = __ldg(w + __ldg(order + j));
    wsum += wk;
    wprobe = fmaf(0.0f, wk, wprobe);
  }
  wbad = wprobe != 0.0f;
  return wsum;
}

// edge_sum where the columns lie inside the row, else weight_sum (no column flags)
template <int V, int kB>
__device__ __forceinline__ unsigned rows_sum(const float* __restrict__ v,
                                             const int* __restrict__ order,
                                             const float* __restrict__ w, int beg, int end,
                                             size_t d, int col, bool live, float (&acc)[V],
                                             float& wsum, bool& wbad) {
  if (live) return edge_sum<V, kB>(v, order, w, beg, end, d, col, acc, wsum, wbad);
  wsum = weight_sum(order, w, beg, end, wbad);
  return 0u;
}

// grid (column tiles, n_seg), block threads x V columns of edge blockIdx.y.
// ws: per column (and the masses in slot d) the codes hi = largest flagged
// edge + 2 and lo = n_seg + 1 - smallest flagged edge (0: none; a row in no
// edge is edge -1), then one done-counter a column tile.
template <int V, int kB>
__global__ void __launch_bounds__(kThreads)
segment_reduce_edge_kernel(const float* __restrict__ v, const int* __restrict__ order,
                           const int* __restrict__ offs, const float* __restrict__ w, int k_rows,
                           int d, int n_seg, float* __restrict__ out, float* __restrict__ mass,
                           int* __restrict__ ws) {
  __shared__ bool last_block, any_flag;
  int* hi_w = ws;
  int* lo_w = ws + d + 1;
  unsigned* done = reinterpret_cast<unsigned*>(ws + 2 * (d + 1));
  const int e = blockIdx.y;
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const bool live = col < d;
  const bool do_mass = mass != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  bool flagged = false;
  auto flag = [&](unsigned bad, bool wbad, int edge) {
#pragma unroll
    for (int c = 0; c < V; ++c) {
      if (bad & (1u << c)) {
        atomicMax(&hi_w[col + c], edge + 2);
        atomicMax(&lo_w[col + c], n_seg + 1 - edge);
        flagged = true;
      }
    }
    if (do_mass && wbad) {
      atomicMax(&hi_w[d], edge + 2);
      atomicMax(&lo_w[d], n_seg + 1 - edge);
      flagged = true;
    }
  };
  const int beg = __ldg(offs + e), end = __ldg(offs + e + 1);
  if (e == 0) {  // the rows in no edge flag every edge (id -1)
    const int lo_end = __ldg(offs), hi_beg = __ldg(offs + n_seg);
    float acc[V], wsum;
    bool wbad;
    unsigned bad = rows_sum<V, kB>(v, order, w, 0, lo_end, d, col, live, acc, wsum, wbad);
    flag(bad, wbad, -1);
    bad = rows_sum<V, kB>(v, order, w, hi_beg, k_rows, d, col, live, acc, wsum, wbad);
    flag(bad, wbad, -1);
  }
  float acc[V], wsum;
  bool wbad;
  const unsigned bad = rows_sum<V, kB>(v, order, w, beg, end, d, col, live, acc, wsum, wbad);
  if (live) store_cols<V>(out + size_t(e) * size_t(d) + col, acc);
  if (do_mass) mass[e] = wsum;
  flag(bad, wbad, e);
  // the block's stores and flags, then one fence before its count; the count
  // carries the flagged blocks in its high half, so the last block reads the
  // flags only where some block set one
  const bool block_flagged = __syncthreads_or(flagged);
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned old = atomicAdd(&done[blockIdx.x], block_flagged ? 0x10001u : 1u);
    last_block = (old & 0xffffu) == unsigned(n_seg - 1);
    any_flag = block_flagged || (old >> 16) != 0;
  }
  __syncthreads();
  if (!last_block) return;
  if (threadIdx.x == 0) done[blockIdx.x] = 0u;
  if (!any_flag) return;
  __threadfence();
  const float qnan = __int_as_float(0x7fc00000);
  auto spread = [&](int slot, int hi, int lo, float* base, size_t stride) {
    hi_w[slot] = 0;  // reset for the next call
    lo_w[slot] = 0;
    const int e_max = hi - 2, e_min = n_seg + 1 - lo;
    for (int e2 = 0; e2 < n_seg; ++e2) {
      if (e_min != e_max || e2 != e_min) base[size_t(e2) * stride] = qnan;
    }
  };
  if (live) {
    int hi[V], lo[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {  // through L2, all in flight together
      hi[c] = __ldcg(&hi_w[col + c]);
      lo[c] = __ldcg(&lo_w[col + c]);
    }
#pragma unroll
    for (int c = 0; c < V; ++c) {
      if (hi[c] != 0) spread(col + c, hi[c], lo[c], out + col + c, size_t(d));
    }
  }
  if (do_mass) {
    const int hi = __ldcg(&hi_w[d]), lo = __ldcg(&lo_w[d]);
    if (hi != 0) spread(d, hi, lo, mass, 1);
  }
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

// deep member batches only where the launch leaves the SMs room for them
bool deep_batches(long long threads) { return threads < 2048LL * sm_count(); }

struct Args {
  const float* v;
  const int* order;
  const int* offs;
  const float* w;
  int k_rows, d, n_seg;
  float* out;
  float* mass;
  int* ws;
  cudaStream_t st;
};

template <int V>
int launch_edge(const Args& a) {
  // the widest block whose grid still puts two blocks on every SM
  const int dv = a.d / V;
  int threads = 32;
  for (int t = kThreads; t >= 32; t >>= 1) {
    if (((dv + t - 1) / t) * a.n_seg >= 2 * sm_count()) {
      threads = t;
      break;
    }
  }
  const dim3 grid(max(1, (dv + threads - 1) / threads), a.n_seg);
  if (deep_batches((long long)grid.x * grid.y * threads)) {
    segment_reduce_edge_kernel<V, 16><<<grid, threads, 0, a.st>>>(
        a.v, a.order, a.offs, a.w, a.k_rows, a.d, a.n_seg, a.out, a.mass, a.ws);
  } else {
    segment_reduce_edge_kernel<V, 2><<<grid, threads, 0, a.st>>>(
        a.v, a.order, a.offs, a.w, a.k_rows, a.d, a.n_seg, a.out, a.mass, a.ws);
  }
  return 0;
}

}  // namespace

// v: (k_rows, d) fp32; order: (k_rows,) int32, offs: (n_seg + 1,) int32 (the
// membership plan); w: (k_rows,) fp32; out: (n_seg, d) fp32; mass: (n_seg,)
// fp32 or null; ws: a zeroed workspace of at least 2 (d + 1) + max(1,
// ceil(d / 32)) int32, which the launch leaves zeroed.  All contiguous.
// k_rows >= 1, n_seg in [1, 65535].
extern "C" int rt_segment_reduce(const void* v, const void* order, const void* offs,
                                 const void* w, int k_rows, int d, int n_seg, void* out,
                                 void* mass, void* ws, void* stream) {
  const Args a{static_cast<const float*>(v), static_cast<const int*>(order),
               static_cast<const int*>(offs), static_cast<const float*>(w), k_rows, d, n_seg,
               static_cast<float*>(out), static_cast<float*>(mass), static_cast<int*>(ws),
               static_cast<cudaStream_t>(stream)};
  const bool vec = (d % 4) == 0 && (reinterpret_cast<uintptr_t>(v) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  const int err = vec ? launch_edge<4>(a) : launch_edge<1>(a);
  return err != 0 ? err : int(cudaGetLastError());
}
