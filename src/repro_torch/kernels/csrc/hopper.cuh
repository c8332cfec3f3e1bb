// Hopper (sm_90a) building blocks written as inline PTX: mbarriers, TMA tile
// loads, warpgroup matrix multiplies (wgmma) and their shared-memory
// descriptors.  Used by flash_attention.cu (K11's bf16 path) and, in their
// tf32 forms with the cluster and cp.async helpers at the end of this file,
// by featurize_tf32.cuh and gram_tf32.cuh (K2/K3, K5-K8).
//
// Shared-memory tiles are bf16 rows of 128 bytes (64 values) stored with the
// 128-byte swizzle that a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes: the
// 16-byte chunk c of row r lands at chunk c ^ (r % 8).  Every tile starts on a
// 1024-byte boundary, so the swizzle phase is the row index and a descriptor's
// base offset is 0.  A descriptor names 8-row groups 1024 bytes apart (SBO).
//   K-major operand (the reduction axis contiguous: q and K rows): one wgmma
//     step of k = 16 reads 32 bytes of each row; the next step starts 32 bytes
//     further along the row.
//   MN-major operand (the output axis contiguous: V's rows, transposed B):
//     one step of k = 16 reads 16 rows of 128 bytes; the next starts 2048
//     bytes further on.
// Accumulator fragments follow the m64nNk16 layout: thread t of the
// warpgroup (warp w = t / 32, lane l) holds rows 16 w + l / 4 and that + 8,
// and in each 8-column group j the columns 8 j + 2 (l % 4) and that + 1, as
// d[4 j + 2 i + c] for row half i and column c.
#pragma once
#include <cstdint>
#include <cuda.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed (the loop inside the
// asm, so the threads leave it together as far as the compiler can tell)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 4-d tensor map into shared memory, completion counted in
// bytes on `bar`; boxes reaching past the tensor are zero-filled
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// descriptor of a 128-byte-swizzled operand at shared address `addr`:
// 8-row groups 1024 bytes apart (SBO); the leading offset (LBO) is unused,
// as every operand here is K-major or one 64-wide block of an MN-major one
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // layout type 1: 128-byte swizzle
  return d;
}

// named barrier `id` (1-15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 2^x on the SFU (relative error ~2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) as three bf16 pairs whose sum is (a, b) to fp32's 24 bits:
// hi = bf16(a, b), mid = bf16 of the remainder, lo = bf16 of what is left
// (each remainder is exact in fp32); a in the low half of each register (the
// order of an m16n8k16 A fragment)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(b), "f"(a));
  return r;
}
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  a -= __uint_as_float(hi << 16);
  b -= __uint_as_float(hi & 0xFFFF0000u);
  mid = pack_bf16(a, b);
  a -= __uint_as_float(mid << 16);
  b -= __uint_as_float(mid & 0xFFFF0000u);
  lo = pack_bf16(a, b);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x N, fp32) (+)= A (64 x 16, shared, K-major) B^T (N x 16, shared,
// K-major); acc = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers: the m16n8k16 A fragment
// of each warp's 16 rows) B (16 x 64, shared, MN-major: B's rows contiguous)
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n64(d, a, b, acc);
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n128(d, a, b, acc);
}


// ---------------------------------------------------------------------------
// tf32 on the tensor cores, split into three products (featurize_tf32.cuh,
// gram_tf32.cuh).  The byte geometry above holds for fp32 words: a 128-byte
// swizzled row is 32 values, a wgmma k-step of 8 reads 32 bytes of each row.
// tf32 operands in shared memory must be K-major (the transpose bits exist
// for 16-bit types only), so A comes from registers where its K axis is not
// contiguous in memory.
// ---------------------------------------------------------------------------

// tf32(x), rounded to nearest with ties away from zero (the low 13 bits 0)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~22 bits: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// D (64 x 128, fp32) (+)= A (64 x 8, tf32 in registers: rows 16 w + l / 4
// and + 8, columns l % 4 and + 4 of warp w, lane l, as a0..a3 = (r, c), (r +
// 8, c), (r, c + 4), (r + 8, c + 4)) B^T (B: 128 x 8, shared, K-major); acc =
// 0 overwrites D.  The tensor cores' fp32 additions into D round toward zero.
__device__ __forceinline__ void wgmma_rs_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// the three products of one k-step into one accumulator, the two small
// terms first: D (+)= A_lo B_hi^T + A_hi B_lo^T + A_hi B_hi^T (acc = 0 starts D)
__device__ __forceinline__ void wgmma_tf32x3_n128(float (&d)[64], const uint32_t (&a_hi)[4],
                                                  const uint32_t (&a_lo)[4], uint64_t b_hi,
                                                  uint64_t b_lo, int acc = 1) {
  wgmma_rs_tf32_n128(d, a_lo, b_hi, acc);
  wgmma_rs_tf32_n128(d, a_hi, b_lo);
  wgmma_rs_tf32_n128(d, a_hi, b_hi);
}

// byte offset of element (row, k) in a 128-byte-swizzled tile of fp32 rows
// of 32 values (the layout a CU_TENSOR_MAP_SWIZZLE_128B load writes)
__device__ __forceinline__ uint32_t sw128_f32(int row, int k) {
  return static_cast<uint32_t>(row * 128 + ((((k >> 2) ^ row) & 7) << 4) + (k & 3) * 4);
}

// ---- thread block clusters -------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the shared::cluster address of `addr` (this CTA's shared memory) in CTA `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// one arrival on an mbarrier of any CTA of the cluster (a mapa address),
// releasing this thread's earlier writes at cluster scope
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbar_wait that acquires at cluster scope (arrivals from other CTAs)
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a 32-bit load from any CTA of the cluster's shared memory (a mapa address)
__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// bitwise or into a 32-bit word of any CTA of the cluster (a mapa address)
__device__ __forceinline__ void red_or_cluster(uint32_t addr, uint32_t v) {
  asm volatile("red.shared::cluster.or.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma operands, bulk copies, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- copies ----------------------------------------------------------------

// one box of a 2-d tensor map (columns c0, rows c1); boxes reaching past the
// tensor are zero-filled
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// (host) the TMA map of a (rows, cols) fp32 matrix whose rows are ld floats
// apart, boxes of box_cols x box_rows, 128-byte swizzle, out-of-bounds
// elements read as 0; false where TMA cannot take it (ld not a multiple of 4,
// ptr not 16-byte aligned) or cuTensorMapEncodeTiled refuses it
inline bool map_f32_sw128(CUtensorMap* map, const void* ptr, int64_t rows, int64_t cols,
                          int64_t ld, int box_cols, int box_rows) {
  if (ld % 4 != 0 || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `bytes` (a multiple of 16) from this CTA's shared memory to `dst` in any CTA
// of the cluster (mapa addresses for dst and bar), counted on that CTA's
// barrier `bar` as transaction bytes; an async-proxy copy, so wgmma there
// reads it without a proxy fence
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, uint32_t src, uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// announce `bytes` of transaction traffic on `bar` without arriving
__device__ __forceinline__ void mbar_expect_tx_only(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

}  // namespace hop
