// Hopper (sm_90a) building blocks: TMA tensor maps, mbarrier rings and
// wgmma on 128-byte swizzled tiles. Used by the bf16 flash kernels
// (flash_attention.cu), meant for every kernel redesigned for the card.
//
// The tile format. A TMA box is 64 rows of 64 bf16 (128 bytes a row,
// the 128-byte swizzle's width), 8 KB, written into shared memory at a
// 1024-byte aligned address with the 16-byte chunks of row r permuted
// by r % 8 (CU_TENSOR_MAP_SWIZZLE_128B). Rows and columns past the
// tensor's end arrive as zeros. wgmma reads such a tile through a
// descriptor (layout 1, SWIZZLE_128B):
//   K-major operand (the tile's rows are M or N, its columns K: Q and K
//     in Q.K^T): stride between 8-row groups (SBO) 1024 bytes; the k-th
//     16-column step starts 32 k bytes into the box.
//   MN-major operand (rows are K, columns N: V in P.V, K in dS.K, dO
//     and Q as the B of P^T.dO and dS^T.Q), the instruction's transpose
//     bit set: SBO 1024 bytes between 8-row groups of K; the k-th
//     16-row step starts 2048 k bytes into the box; one box is N = 64
//     (LBO, the stride to the next 64 columns, is then not read).
//
// The ring. A stage's "full" barrier counts one arrival (the producer's
// arrive.expect_tx) plus the bytes its TMA loads bring, and one arrival
// a producer lane for its cp.async copies if it makes any; its "empty"
// barrier counts every consumer thread's arrival. Use u of a stage (u =
// 0, 1, ...) waits for phase u % 2 of "full"; the producer's refill u
// waits for phase (u - 1) % 2 of "empty".
//
// The int8 tile format (quant_matmul.cu's q). A TMA box is 64 rows of 64
// bytes, 4 KB, 64-byte swizzled (CU_TENSOR_MAP_SWIZZLE_64B): the 16-byte
// chunk c of row r lies at chunk c ^ ((r >> 1) % 4), so the 8 rows an
// ldmatrix reads at one logical chunk fall in 8 distinct bank groups.
// Its box starts at a 1024-byte aligned address (the swizzle reads the
// address bits).
//
// wgmma fragments (warp w of the warpgroup, lane = 4 g + t):
//   accumulator m64nN fp32: d[4j + 2h + e] = (row 16w + g + 8h,
//     column 8j + 2t + e);
//   A from registers, m64k16 bf16: a[0] (row 16w + g, k 2t, 2t + 1),
//     a[1] (row + 8, the same k), a[2] (row, k + 8), a[3] (row + 8,
//     k + 8); two bf16 a register, the lower k in the low half.
//
// cuTensorMapEncodeTiled belongs to libcuda, not to the runtime: its
// address is taken once through the runtime's cudaGetDriverEntryPoint,
// so the libraries link no -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kBox = 64;                         // rows and bf16 columns
constexpr int kBoxBytes = kBox * kBox * 2;       // 8 KB
constexpr int kSwizzleAlign = 1024;

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map over a contiguous bf16 [n, rows, cols] tensor whose box is
// `box_rows` rows by 64 columns, 128-byte swizzled. False if the encode
// is refused.
inline bool encode_rows_bf16(CUtensorMap* map, const void* base, int n,
                             int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {kBox, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map over a contiguous int8 [rows, cols] matrix whose box is 64 rows
// by 64 columns, 64-byte swizzled (the int8 tile format above). cols % 16
// == 0 (the row pitch TMA takes). False if the encode is refused.
inline bool encode_rows_int8(CUtensorMap* map, const void* base, int rows,
                             int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------- device
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after p (dynamic shared
// memory is allocated with kSwizzleAlign bytes to spare).
__device__ __forceinline__ unsigned char* align_swizzle(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kSwizzleAlign - (a % kSwizzleAlign)) % kSwizzleAlign);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's arrival on a "full" barrier, announcing `bytes` of TMA.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Box at (column c0, row c1, matrix c2) of a 3-D map into dst.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Box at (column c0, row c1) of a 2-D map into dst.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Four 8 x 8 matrices of 16-bit elements, transposed: lanes 8 i .. 8 i + 7
// give the row addresses of matrix i, and lane 4 g + t receives in r[i]
// its elements (row 2 t, column g) in the low half and (row 2 t + 1,
// column g) in the high half.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// One arrival on `bar` once every cp.async this thread issued before it
// has landed (.noinc: the barrier's count includes these arrivals).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wgmma descriptor of a 128-byte swizzled tile at shared address `addr`
// (module comment): SBO 1024 bytes; LBO 16 bytes (not read by a K-major
// operand, nor by an MN-major one of N = 64).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of these registers
// across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define PTT_OUT16(d, b)                                                     \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),          \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7]),      \
      "+f"(d[b + 8]), "+f"(d[b + 9]), "+f"(d[b + 10]), "+f"(d[b + 11]),    \
      "+f"(d[b + 12]), "+f"(d[b + 13]), "+f"(d[b + 14]), "+f"(d[b + 15])

// d (64 x 64) = A.B (+ d when accumulate), A and B K-major in shared
// memory: A 64 x 16, B 16 x 64 (stored as 64 rows of k).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : PTT_OUT16(d, 0), PTT_OUT16(d, 16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with N = 32.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : PTT_OUT16(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A.B, A 64 x 16 from registers, B 16 x 64 MN-major in
// shared memory (16 rows of k, 64 columns of n; the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : PTT_OUT16(d, 0), PTT_OUT16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A.B, A 64 x 16 from registers, B 16 x 128 K-major in
// shared memory (128 rows of k; no transpose): d0 holds columns 0-63 of
// the accumulator, d1 columns 64-127 (each in the layout of an N = 64
// accumulator).
__device__ __forceinline__ void wgmma_rs_n128_k(float (&d0)[32],
                                                float (&d1)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : PTT_OUT16(d0, 0), PTT_OUT16(d0, 16), PTT_OUT16(d1, 0),
        PTT_OUT16(d1, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same with N = 192: d0, d1, d2 hold columns 0-63, 64-127, 128-191.
__device__ __forceinline__ void wgmma_rs_n192_k(float (&d0)[32],
                                                float (&d1)[32],
                                                float (&d2)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n"
      "}\n"
      : PTT_OUT16(d0, 0), PTT_OUT16(d0, 16), PTT_OUT16(d1, 0),
        PTT_OUT16(d1, 16), PTT_OUT16(d2, 0), PTT_OUT16(d2, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef PTT_OUT16

}  // namespace hopper
