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
//           The output is the wire dtype the KV pool stores (1 byte),
//           or the gradient wire's carrier, which the sum over ranks
//           neither wraps nor rounds: int8 values as int32, fp8 values
//           as fp32 (grad_comm.py block_encode(carrier=True)).
//   decode: out[i] = (float(q[i]) * s[row]) / world for i < numel, fp32,
//           from the 1-byte wire dtype or from a (summed) carrier.
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
// thread (16 bytes too for a 4-byte carrier). The ragged tail (numel % 4
// on decode) is masked with a scalar loop. Simple and right first; speed
// is later work.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInt8 = 0;
constexpr int kFp8 = 1;

// the 4-element vector of each element type, for 4- and 16-byte accesses
template <typename T> struct Vec4;
template <> struct Vec4<uint8_t> { using type = uchar4; };
template <> struct Vec4<int32_t> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

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

// the value of one wire byte (int8 or fp8 e4m3), exactly
template <int CODEC>
__device__ __forceinline__ float wire_value(uint8_t b) {
  if (CODEC == kInt8) return static_cast<float>(static_cast<int8_t>(b));
  __nv_fp8_e4m3 f;
  f.__x = b;
  return static_cast<float>(f);
}

// one encoded element in the output type: the wire byte itself, or its
// value in the carrier (int32 for int8, fp32 for fp8)
template <int CODEC, typename OutT>
__device__ __forceinline__ OutT to_out(uint8_t b) {
  if constexpr (sizeof(OutT) == 1) {
    return b;
  } else if constexpr (CODEC == kInt8) {
    return static_cast<OutT>(static_cast<int8_t>(b));
  } else {
    return static_cast<OutT>(wire_value<kFp8>(b));
  }
}

template <int CODEC, typename InT>
__device__ __forceinline__ float decode_one(InT v, float s, float world) {
  float x;
  if constexpr (sizeof(InT) == 1) {
    x = wire_value<CODEC>(v);
  } else {
    x = static_cast<float>(v);   // the carrier's exact value
  }
  return __fdiv_rn(__fmul_rn(x, s), world);
}

template <int CODEC, typename OutT>
__global__ void encode_kernel(const float* __restrict__ x,
                              const float* __restrict__ scales,
                              OutT* __restrict__ out, int64_t n,
                              int64_t bs) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const float s = __ldg(scales + i / bs);
  if (i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    typename Vec4<OutT>::type o;
    o.x = to_out<CODEC, OutT>(encode_one<CODEC>(v.x, s));
    o.y = to_out<CODEC, OutT>(encode_one<CODEC>(v.y, s));
    o.z = to_out<CODEC, OutT>(encode_one<CODEC>(v.z, s));
    o.w = to_out<CODEC, OutT>(encode_one<CODEC>(v.w, s));
    *reinterpret_cast<typename Vec4<OutT>::type*>(out + i) = o;
  } else {
    for (int64_t j = i; j < n; ++j)
      out[j] = to_out<CODEC, OutT>(encode_one<CODEC>(x[j], s));
  }
}

template <int CODEC, typename InT>
__global__ void decode_kernel(const InT* __restrict__ q,
                              const float* __restrict__ scales,
                              float* __restrict__ out, int64_t numel,
                              int64_t bs, float world) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= numel) return;
  const float s = __ldg(scales + i / bs);
  if (i + 4 <= numel) {
    const typename Vec4<InT>::type v =
        *reinterpret_cast<const typename Vec4<InT>::type*>(q + i);
    float4 o;
    o.x = decode_one<CODEC, InT>(v.x, s, world);
    o.y = decode_one<CODEC, InT>(v.y, s, world);
    o.z = decode_one<CODEC, InT>(v.z, s, world);
    o.w = decode_one<CODEC, InT>(v.w, s, world);
    *reinterpret_cast<float4*>(out + i) = o;
  } else {
    for (int64_t j = i; j < numel; ++j)
      out[j] = decode_one<CODEC, InT>(q[j], s, world);
  }
}

inline unsigned int grid_for(int64_t n) {
  const int64_t quads = (n + 3) / 4;
  return static_cast<unsigned int>((quads + kThreads - 1) / kThreads);
}

template <int CODEC, typename OutT>
void launch_encode(const void* x, const void* scales, void* out, int64_t n,
                   int64_t bs, cudaStream_t st) {
  encode_kernel<CODEC, OutT><<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(scales),
      static_cast<OutT*>(out), n, bs);
}

template <int CODEC, typename InT>
void launch_decode(const void* q, const void* scales, void* out,
                   int64_t numel, int64_t bs, float world, cudaStream_t st) {
  decode_kernel<CODEC, InT><<<grid_for(numel), kThreads, 0, st>>>(
      static_cast<const InT*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), numel, bs, world);
}

}  // namespace

// x: fp32 [nb * bs]; scales: fp32 [nb]; out: [nb * bs] of the 1-byte wire
// dtype (carrier 0) or of the carrier (carrier 1: int32 for int8_block,
// fp32 for fp8_block). codec: 0 = int8_block, 1 = fp8_block. Returns
// cudaGetLastError().
extern "C" int codec_encode(const void* x, const void* scales, void* out,
                            int64_t nb, int64_t bs, int codec, int carrier,
                            void* stream) {
  const int64_t n = nb * bs;
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (codec == kInt8 && !carrier) {
    launch_encode<kInt8, uint8_t>(x, scales, out, n, bs, st);
  } else if (codec == kInt8) {
    launch_encode<kInt8, int32_t>(x, scales, out, n, bs, st);
  } else if (codec == kFp8 && !carrier) {
    launch_encode<kFp8, uint8_t>(x, scales, out, n, bs, st);
  } else if (codec == kFp8) {
    launch_encode<kFp8, float>(x, scales, out, n, bs, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [nb * bs] of the payload type `wire`: 0 int8, 1 fp8 e4m3 (1 byte
// each), 2 int32 carrier, 3 fp32 carrier; scales: fp32 [nb]; out: fp32
// [numel], numel <= nb * bs. Returns cudaGetLastError().
extern "C" int codec_decode(const void* q, const void* scales, void* out,
                            int64_t nb, int64_t bs, int64_t numel, int wire,
                            float world, void* stream) {
  if (numel == 0) return static_cast<int>(cudaSuccess);
  if (numel > nb * bs) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wire) {
    case 0:
      launch_decode<kInt8, uint8_t>(q, scales, out, numel, bs, world, st);
      break;
    case 1:
      launch_decode<kFp8, uint8_t>(q, scales, out, numel, bs, world, st);
      break;
    case 2:
      launch_decode<kInt8, int32_t>(q, scales, out, numel, bs, world, st);
      break;
    case 3:
      launch_decode<kFp8, float>(q, scales, out, numel, bs, world, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
