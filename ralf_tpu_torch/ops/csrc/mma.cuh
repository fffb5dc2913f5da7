// Tensor-core and async-copy building blocks for Hopper (sm_90a) shared by
// the attention kernels K1-K4 and K6 (and, through hopper.cuh, K5's
// smem_addr and pack_bf16): 16-byte cp.async with zero fill, ldmatrix,
// mma.sync.m16n8k16 with bf16 inputs and fp32 sums, and m16n8k32 with int8
// inputs and int32 sums.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, c = lane % 4):
//   A [16 x 16] row-major, 4 regs of bf16x2: a0 (row g, cols 2c, 2c+1),
//     a1 (row g+8, the same cols), a2 (row g, cols 2c+8, 2c+9), a3 (row g+8, ...)
//   B [16 x 8], 2 regs: b0 (rows 2c, 2c+1, col g), b1 (rows 2c+8, 2c+9, col g)
//   C/D [16 x 8] fp32: d0, d1 (row g, cols 2c, 2c+1), d2, d3 (row g+8, ...)
// An accumulator pair of n-tiles (2j, 2j+1) is, packed to bf16, the A
// fragment of k-step j: the way a probability tile feeds the next product
// without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ralf {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with `valid` false the 16 bytes are zeros and
// nothing is read (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores, bf16 x bf16 -> fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a . b on the tensor cores, int8 x int8 -> int32 (m16n8k32).  Each
// register holds 4 int8, lowest k first: a0 (row g, k 4c .. 4c+3), a1 (row
// g+8, the same k), a2 (row g, k 16+4c ..), a3 (row g+8, ...); b0 (k 4c ..
// 4c+3, col g), b1 (k 16+4c .., col g); d as in m16n8k16.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed, x in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace ralf
