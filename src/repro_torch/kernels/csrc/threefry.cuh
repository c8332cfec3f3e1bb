// Counter-based threefry-2x32-20 draws of the seed-fused Omega (K4).
//
// Replaces src/repro/kernels/prng.py (threefry2x32, _uniform, _normal,
// _cauchy, fused_omega_block), the generator body that the fused TPU kernels
// call.  Element (row, col) of draw e under seed s is a pure function of
// (s & 0xFFFFFFFF, e, row, col), so every kernel that needs an Omega element
// re-derives it from its absolute coordinates; no (N, p) tensor is read.
//
// Bound: integer throughput (about 80 int32 operations per element) plus the
// Box-Muller or tan-Cauchy transform; a draw is never stored by the fused
// kernels, only recomputed, so the bytes are the output alone.
//
// The float transforms follow the reference operation for operation:
//   u = (bits >> 8) * 2^-24
//   gauss   : sqrt(-2 * log1p(-u1)) * cos(f32(2 pi) * u2)
//   laplace : tan(f32(pi) * (u - 0.5))
//   scale   : multiply by f32(1 / sigma) (not a divide)
// Built without --use_fast_math, so log1pf, cosf and tanf are the accurate
// library functions.
#pragma once
#include <cstdint>

namespace rt {

__host__ __device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// 20-round threefry-2x32 of counter (c0, c1) under key (k0, k1).
__host__ __device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                                      uint32_t c0, uint32_t c1,
                                                      uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int d = 0; d < 5; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[d % 2][i]) ^ x0;
    }
    x0 += ks[(d + 1) % 3];
    x1 += ks[(d + 2) % 3] + uint32_t(d + 1);
  }
  o0 = x0;
  o1 = x1;
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  return float(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24, exact
}

enum RfKernel : int { kGauss = 0, kLaplace = 1 };

// One Omega element: the seed-fused generator at absolute (row, col).
struct FusedOmega {
  uint32_t key0;      // seed & 0xFFFFFFFF
  uint32_t key1;      // ensemble index
  float inv_sigma;    // f32(1 / sigma); 1.0f is exact, so sigma == 1 needs no branch
  int kind;           // RfKernel

  __device__ __forceinline__ float operator()(uint32_t row, uint32_t col) const {
    uint32_t b0, b1;
    threefry2x32(key0, key1, row, col, b0, b1);
    return from_bits(b0, b1);
  }
  // the float transform of one element's threefry bits (callers that draw
  // several elements at once run the integer rounds of all of them first).
  // The assumptions state the arguments' ranges (u in [0, 1 - 2^-24]), so
  // the compiler may drop the library functions' branches for arguments that
  // cannot occur; the values are the same.
  __device__ __forceinline__ float from_bits(uint32_t b0, uint32_t b1) const {
    float v;
    if (kind == kGauss) {
      const float u1 = uniform24(b0);
      const float u2 = uniform24(b1);
      const float l = log1pf(-u1);
      __builtin_assume(l <= 0.0f && l > -17.0f);
      const float r = sqrtf(-2.0f * l);
      const float a = 6.283185307179586f * u2;
      __builtin_assume(a >= 0.0f && a < 6.3f);
      v = r * cosf(a);
    } else {
      const float a = 3.141592653589793f * (uniform24(b0) - 0.5f);
      __builtin_assume(a >= -1.6f && a < 1.6f);
      v = tanf(a);
    }
    return v * inv_sigma;
  }
  __host__ __device__ FusedOmega draw(int e) const {
    FusedOmega g = *this;
    g.key1 = key1 + uint32_t(e);
    return g;
  }
};

}  // namespace rt
