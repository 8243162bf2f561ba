// Int8 weight-only quantization and quantized matmul, for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/quant_matmul.py:
//   quantize_int8 <- _quantize_kernel (quant_matmul.py:63, launched by
//                    quantize_int8 :84)
//   quant_matmul  <- _qmm_kernel (quant_matmul.py:110, launched by
//                    quant_matmul :173)
// Plain PyTorch versions and wrappers: paddle_tpu_torch/ops/quant_matmul.py
// (quantize_int8_plain, quant_matmul_plain; quantize_int8, quant_matmul).
//
// quantize_int8: w fp32 [k, n] -> q int8 [k, n], scales fp32 [n].
//   Per column: amax = max |w| over k, scale = max(amax * (1/127), 1e-12),
//   q = clip(rint(w / scale), -127, 127), or with stochastic rounding
//   clip(floor(w / scale + u), -127, 127), u in [0, 1) from a murmur3
//   finalizer hash of (flat index, seed) in uint32 (_hash_uniform :46-60).
//   The arithmetic is the reference's as XLA compiles it on the CPU: the
//   constant division amax / 127 becomes a multiply by the fp32 reciprocal,
//   while w / scale stays a true division (__fdiv_rn), and rintf rounds half
//   to even as jnp.round does. The result is bit-identical to the plain
//   version and to the reference.
//   Bound: device-memory bytes (read w once, write q and scales: 5 bytes per
//   element; 11.8 MB at [3072, 768], 3.5 us at 3.35 TB/s). Design: one block
//   of 32 adjacent columns x 8 row groups, so each warp reads 128 contiguous
//   bytes of a row; the 8 partial maxima meet in shared memory, and the same
//   block then writes q for its columns (the second read of w mostly hits
//   L2). Simple, not fast: only n / 32 blocks run.
//
// quant_matmul: x fp32 [m, k] @ (q int8 [k, n] * scales [n]) -> fp32 [m, n].
//   fp32 accumulator over k, multiplied by the column's scale once at the
//   end, as _qmm_kernel does (and as the plain version does).
//   Bound: fp32 operations outside the tensor cores (2 m n k; 0.144 ms for
//   (8192, 768, 768) at 67 TFLOP/s). Design: a tiled SIMT GEMM. A 256-thread
//   block owns a 64 x 64 output tile; each thread owns a 4 x 4 micro-tile
//   strided by 16 rows and 16 columns, so its shared-memory reads are
//   broadcasts (x) or 16 consecutive words (w) and its stores coalesce.
//   Per k-step of 32, the x tile is stored transposed in shared memory with
//   a pitch of 65 floats (conflict-free transposing stores), and the int8 w
//   tile is loaded as char4 (one byte when n % 4 != 0) and converted to fp32
//   in shared memory. Any m, n, k >= 1: rows, columns and k past the end are
//   zero-filled and never stored. No tensor cores, no double buffering.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQCols = 32;   // columns per quantize block (a warp's width)
constexpr int kQRows = 8;    // row groups per quantize block

constexpr int kBM = 64, kBN = 64, kBK = 32;   // matmul tiles
constexpr int kThreads = 256;                 // 16 x 16, 4 x 4 per thread
constexpr int kXPitch = kBM + 1;

__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t seed) {
  uint32_t h = (idx * 2654435761u) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return __uint2float_rn(h >> 8) * (1.0f / 16777216.0f);   // exact
}

template <bool STOCHASTIC>
__global__ void __launch_bounds__(kQCols * kQRows)
quantize_kernel(const float* __restrict__ w, int8_t* __restrict__ q,
                float* __restrict__ scales, int k, int n, uint32_t seed) {
  __shared__ float part[kQRows][kQCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kQCols + tx;
  float amax = 0.0f;
  if (col < n)
    for (int r = ty; r < k; r += kQRows)
      amax = fmaxf(amax, fabsf(w[static_cast<size_t>(r) * n + col]));
  part[ty][tx] = amax;
  __syncthreads();
  if (ty == 0) {
    for (int i = 1; i < kQRows; ++i) amax = fmaxf(amax, part[i][tx]);
    const float scale = fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-12f);
    part[0][tx] = scale;
    if (col < n) scales[col] = scale;
  }
  __syncthreads();
  if (col >= n) return;
  const float scale = part[0][tx];
  for (int r = ty; r < k; r += kQRows) {
    const size_t i = static_cast<size_t>(r) * n + col;
    const float x = __fdiv_rn(w[i], scale);
    float v;
    if (STOCHASTIC) {
      const uint32_t flat = static_cast<uint32_t>(r) *
                            static_cast<uint32_t>(n) +
                            static_cast<uint32_t>(col);
      v = floorf(__fadd_rn(x, hash_uniform(flat, seed)));
    } else {
      v = rintf(x);
    }
    q[i] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ qw,
           const float* __restrict__ scales, float* __restrict__ out, int m,
           int n, int k) {
  __shared__ float xs[kBK][kXPitch];               // x tile, transposed
  __shared__ __align__(16) float ws[kBK][kBN];     // dequantized w tile
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBK, kc = idx % kBK;
      const int gr = row0 + r, gk = k0 + kc;
      xs[kc][r] = (gr < m && gk < k) ? x[static_cast<size_t>(gr) * k + gk]
                                     : 0.0f;
    }
    if (VEC) {
#pragma unroll
      for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / (kBN / 4), c = (idx % (kBN / 4)) * 4;
        const int gk = k0 + r, gc = col0 + c;
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gk < k && gc < n) {   // n % 4 == 0: all four columns or none
          const char4 b = *reinterpret_cast<const char4*>(
              qw + static_cast<size_t>(gk) * n + gc);
          f = make_float4(b.x, b.y, b.z, b.w);
        }
        *reinterpret_cast<float4*>(&ws[r][c]) = f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK * kBN / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / kBN, c = idx % kBN;
        const int gk = k0 + r, gc = col0 + c;
        ws[r][c] = (gk < k && gc < n)
                       ? static_cast<float>(qw[static_cast<size_t>(gk) * n + gc])
                       : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + tx + 16 * j;
    if (c >= n) continue;
    const float s = scales[c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r < m) out[static_cast<size_t>(r) * n + c] = __fmul_rn(acc[i][j], s);
    }
  }
}

}  // namespace

// w: fp32 [k, n] contiguous; q: int8 [k, n]; scales: fp32 [n].
// stochastic: 0 nearest, 1 stochastic rounding with `seed`.
// Returns a cudaError_t code.
extern "C" int quantize_int8(const void* w, void* q, void* scales, int k,
                             int n, int stochastic, unsigned int seed,
                             void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kQCols - 1) / kQCols), block(kQCols, kQRows);
  auto* wp = static_cast<const float*>(w);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(scales);
  if (stochastic)
    quantize_kernel<true><<<grid, block, 0, st>>>(wp, qp, sp, k, n, seed);
  else
    quantize_kernel<false><<<grid, block, 0, st>>>(wp, qp, sp, k, n, seed);
  return static_cast<int>(cudaGetLastError());
}

// x: fp32 [m, k]; qw: int8 [k, n] (4-byte aligned); scales: fp32 [n];
// out: fp32 [m, n]; all contiguous. Returns a cudaError_t code.
extern "C" int quant_matmul(const void* x, const void* qw, const void* scales,
                            void* out, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  auto* xp = static_cast<const float*>(x);
  auto* qp = static_cast<const int8_t*>(qw);
  auto* sp = static_cast<const float*>(scales);
  auto* op = static_cast<float*>(out);
  if (n % 4 == 0)
    qmm_kernel<true><<<grid, kThreads, 0, st>>>(xp, qp, sp, op, m, n, k);
  else
    qmm_kernel<false><<<grid, kThreads, 0, st>>>(xp, qp, sp, op, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
