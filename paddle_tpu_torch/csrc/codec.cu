// Blockwise KV/gradient codec kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/codec.py:
//   codec_encode <- _encode_kernel (codec.py:93, launched by block_encode)
//   codec_decode <- _decode_kernel (codec.py:138, launched by block_decode)
// Plain PyTorch versions: paddle_tpu_torch/distributed/grad_comm.py
// block_encode / block_decode. Wrappers: paddle_tpu_torch/ops/codec.py.
//
// What they compute, over a row-major [nb, bs] layout with one fp32 scale
// per row (block):
//   encode: q = x / s[row] with an IEEE divide (__fdiv_rn; the build uses
//           no --use_fast_math), then
//           int8_block: rintf (half-to-even), clamp to [-127, 127], int8;
//           fp8_block:  float8_e4m3fn, round-to-nearest-even, saturating.
//           The output is the wire dtype the KV pool stores (1 byte).
//   decode: out[i] = (float(q[i]) * s[row]) / world for i < numel, fp32.
// Bits equal the plain versions' (and the JAX reference's): the same
// correctly rounded divide, multiply and conversions.
//
// What bounds them: device-memory bytes. Each element is read once and
// written once with a handful of operations, far below the H100's
// ~20 fp32 operations per byte of HBM bandwidth. Bounds at the serving
// slice's GPT-125M shapes (ept = 12 layers * 2 * 768 = 18,432 elements
// per token, 1024-element scale blocks, 3.35 TB/s):
//   encode, 512-token prompt: read 37.7 MB fp32, write 9.4 MB int8 ~ 14 us
//   decode, 1024-token context: read 18.9 MB, write 75.5 MB         ~ 28 us
//   one decode step, batch 8: ~0.7 MB — launch-bound, not byte-bound.
//
// Design: one thread per 4 consecutive elements, so each thread issues one
// 16-byte fp32 load or store and one 4-byte payload access; neighbouring
// threads touch neighbouring addresses. bs % 4 == 0 (checked by the
// wrapper), so the 4 elements share a row and the scale is loaded once per
// thread. The ragged tail (numel % 4 on decode) is masked with a scalar
// loop. Simple and right first; speed is later work.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInt8 = 0;
constexpr int kFp8 = 1;

template <int CODEC>
__device__ __forceinline__ uint8_t encode_one(float x, float s) {
  const float q = __fdiv_rn(x, s);
  if (CODEC == kInt8) {
    const float r = fminf(fmaxf(rintf(q), -127.0f), 127.0f);
    return static_cast<uint8_t>(static_cast<int8_t>(r));
  } else {
    return static_cast<uint8_t>(
        __nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3));
  }
}

template <int CODEC>
__device__ __forceinline__ float decode_one(uint8_t b, float s,
                                            float world) {
  float v;
  if (CODEC == kInt8) {
    v = static_cast<float>(static_cast<int8_t>(b));
  } else {
    __nv_fp8_e4m3 f;
    f.__x = b;
    v = static_cast<float>(f);
  }
  return __fdiv_rn(__fmul_rn(v, s), world);
}

template <int CODEC>
__global__ void encode_kernel(const float* __restrict__ x,
                              const float* __restrict__ scales,
                              uint8_t* __restrict__ out, int64_t n,
                              int64_t bs) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const float s = __ldg(scales + i / bs);
  if (i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    uchar4 o;
    o.x = encode_one<CODEC>(v.x, s);
    o.y = encode_one<CODEC>(v.y, s);
    o.z = encode_one<CODEC>(v.z, s);
    o.w = encode_one<CODEC>(v.w, s);
    *reinterpret_cast<uchar4*>(out + i) = o;
  } else {
    for (int64_t j = i; j < n; ++j) out[j] = encode_one<CODEC>(x[j], s);
  }
}

template <int CODEC>
__global__ void decode_kernel(const uint8_t* __restrict__ q,
                              const float* __restrict__ scales,
                              float* __restrict__ out, int64_t numel,
                              int64_t bs, float world) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= numel) return;
  const float s = __ldg(scales + i / bs);
  if (i + 4 <= numel) {
    const uchar4 v = *reinterpret_cast<const uchar4*>(q + i);
    float4 o;
    o.x = decode_one<CODEC>(v.x, s, world);
    o.y = decode_one<CODEC>(v.y, s, world);
    o.z = decode_one<CODEC>(v.z, s, world);
    o.w = decode_one<CODEC>(v.w, s, world);
    *reinterpret_cast<float4*>(out + i) = o;
  } else {
    for (int64_t j = i; j < numel; ++j)
      out[j] = decode_one<CODEC>(q[j], s, world);
  }
}

inline unsigned int grid_for(int64_t n) {
  const int64_t quads = (n + 3) / 4;
  return static_cast<unsigned int>((quads + kThreads - 1) / kThreads);
}

}  // namespace

// x: fp32 [nb * bs]; scales: fp32 [nb]; out: 1-byte wire [nb * bs].
// codec: 0 = int8_block, 1 = fp8_block. Returns cudaGetLastError().
extern "C" int codec_encode(const void* x, const void* scales, void* out,
                            int64_t nb, int64_t bs, int codec,
                            void* stream) {
  const int64_t n = nb * bs;
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scales);
  uint8_t* op = static_cast<uint8_t*>(out);
  if (codec == kInt8) {
    encode_kernel<kInt8><<<grid_for(n), kThreads, 0, st>>>(xp, sp, op, n, bs);
  } else if (codec == kFp8) {
    encode_kernel<kFp8><<<grid_for(n), kThreads, 0, st>>>(xp, sp, op, n, bs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: 1-byte wire [nb * bs]; scales: fp32 [nb]; out: fp32 [numel],
// numel <= nb * bs. Returns cudaGetLastError().
extern "C" int codec_decode(const void* q, const void* scales, void* out,
                            int64_t nb, int64_t bs, int64_t numel, int codec,
                            float world, void* stream) {
  if (numel == 0) return static_cast<int>(cudaSuccess);
  if (numel > nb * bs) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  if (codec == kInt8) {
    decode_kernel<kInt8><<<grid_for(numel), kThreads, 0, st>>>(
        qp, sp, op, numel, bs, world);
  } else if (codec == kFp8) {
    decode_kernel<kFp8><<<grid_for(numel), kThreads, 0, st>>>(
        qp, sp, op, numel, bs, world);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
