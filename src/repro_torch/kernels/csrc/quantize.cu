// K10 on the card: fused stochastic-rounding quantize -> dequantize.
//
// Replaces src/repro/kernels/quantize.py:37 (fake_quant_pallas,
// _fake_quant_kernel), the wire codecs' qint8/qint4 round trip inside the
// batched round engine:
//   out[r, i] = clip(floor(x[r, i] / scale[r] + u[r, i]), -qmax, qmax) * scale[r]
// Row r is one payload (one client's moments, W_RF or classifier leaf); the
// per-row absmax scale is a torch reduction in the wrapper, as the reference
// computes its per-tensor scale outside its kernel (kernels/ops.py:316-318).
//
// The divide is IEEE round-to-nearest (__fdiv_rn; the library is built
// without --use_fast_math): a multiply by the reciprocal flips floor() at
// quantization-bin boundaries and would part from the plain version and the
// host codec.  The clip is written with comparisons so that a NaN stays NaN,
// as torch.clamp and jnp.clip keep it.
//
// Bound: bytes.  Each element reads x and u and writes out, 12 bytes, for a
// divide, an add, a floor, two compares and a multiply.  Design: one block
// row per payload row (blockIdx.y), 16-byte loads and stores when the row
// length is a multiple of 4 (every row then starts 16-byte aligned), plain
// scalar loads over the whole row otherwise, grid-stride within the row.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;

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
