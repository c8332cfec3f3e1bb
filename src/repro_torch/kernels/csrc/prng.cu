// K4 on the card: the seed-fused Omega block and its raw threefry bits.
//
// Replaces src/repro/kernels/prng.py:94 (fused_omega_block) where the
// reference materializes Omega (the transform memo) and :48 (threefry2x32).
// One thread per element of a (rows, cols) counter grid at offset
// (row0, col0); counters wrap modulo 2^32 as the reference's uint32 iota.
// Bound: integer operations (~80 int32 ops per element); the output is the
// only memory traffic.
#include <cuda_runtime.h>
#include "threefry.cuh"

namespace {

__global__ void threefry_bits_kernel(uint32_t k0, uint32_t k1, uint32_t row0,
                                     uint32_t col0, int rows, int cols,
                                     uint32_t* __restrict__ out0,
                                     uint32_t* __restrict__ out1) {
  const int64_t total = int64_t(rows) * cols;
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < total;
       i += int64_t(gridDim.x) * blockDim.x) {
    const uint32_t r = row0 + uint32_t(i / cols);
    const uint32_t c = col0 + uint32_t(i % cols);
    uint32_t b0, b1;
    rt::threefry2x32(k0, k1, r, c, b0, b1);
    out0[i] = b0;
    out1[i] = b1;
  }
}

__global__ void fused_omega_kernel(rt::FusedOmega gen, uint32_t row0, uint32_t col0,
                                   int rows, int cols, float* __restrict__ out) {
  const int64_t total = int64_t(rows) * cols;
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < total;
       i += int64_t(gridDim.x) * blockDim.x) {
    out[i] = gen(row0 + uint32_t(i / cols), col0 + uint32_t(i % cols));
  }
}

int grid_for(int64_t total) {
  const int64_t blocks = (total + 255) / 256;
  return int(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

}  // namespace

extern "C" int rt_threefry_bits(uint32_t k0, uint32_t k1, uint32_t row0, uint32_t col0,
                                int rows, int cols, void* out0, void* out1,
                                void* stream) {
  threefry_bits_kernel<<<grid_for(int64_t(rows) * cols), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      k0, k1, row0, col0, rows, cols, static_cast<uint32_t*>(out0),
      static_cast<uint32_t*>(out1));
  return int(cudaGetLastError());
}

extern "C" int rt_fused_omega(uint32_t k0, uint32_t k1, float inv_sigma, int kind,
                              uint32_t row0, uint32_t col0, int rows, int cols,
                              void* out, void* stream) {
  const rt::FusedOmega gen{k0, k1, inv_sigma, kind};
  fused_omega_kernel<<<grid_for(int64_t(rows) * cols), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      gen, row0, col0, rows, cols, static_cast<float*>(out));
  return int(cudaGetLastError());
}
