// Tensor-core building blocks shared by the split-TF32 kernels
// (quant_matmul.cu, flash_attention.cu): cp.async copies into shared
// memory, the TF32 splits of an fp32 value, and mma.sync m16n8k8 in TF32.
//
// mma.sync.m16n8k8 tf32 fragments (lane = 4 g + t, g = lane / 4):
//   A 16 x 8: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8 x 8:  b0 (k t, col g), b1 (k t + 4, col g)
//   C 16 x 8: c0 (row g, col 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Which k and column each slot stands for is the caller's choice, as long
// as A and B agree on k and B and C on the column.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy, or 16 zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v = big + small (+ ~2^-22 |v|), both TF32 values, rounded to nearest.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  const float rest = __fsub_rn(v, __uint_as_float(big));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// The same split in fewer operations, for kernels bound by it (the flash
// backward): the tensor cores read a TF32 operand's top 19 bits and
// drop the low 13 (CUTLASS's round_half_ulp_truncate relies on this), so
// big is v's bits plus half a TF32 ulp (rounded to nearest, ties away,
// once the low bits are dropped) and small is v - big, truncated by the
// tensor cores. Two integer operations and one fp32 subtraction, where
// cvt.rna is a slow conversion and an exact integer rounding of both
// parts saturates the integer pipe. A NaN survives in small (big may read
// as 0); an infinity makes small NaN, as cvt.rna does.
__device__ __forceinline__ void split_tf32_trunc(float v, uint32_t& big,
                                                 uint32_t& small) {
  big = __float_as_uint(v) + 0x1000u;
  small = __float_as_uint(__fsub_rn(v, __uint_as_float(big & 0xFFFFE000u)));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

