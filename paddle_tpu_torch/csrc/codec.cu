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
//   encode: x fp32, bf16 or fp16, lifted to fp32 (exact; the reference's
//           _as_blocks makes the same fp32 values), then
//           q = x / s[row] with an IEEE divide (__fdiv_rn; the build uses
//           no --use_fast_math), then
//           int8_block: rintf (half-to-even), clamp to [-127, 127], int8;
//           fp8_block:  float8_e4m3fn, round-to-nearest-even, saturating.
//           x holds n <= nb * bs elements; the rest of the last row
//           encodes as x = 0, the bits the plain version's zero padding
//           gives (0 for int8 and int32, 0x00 for fp8, +0.0 for fp32).
//           The output is the wire dtype the KV pool stores (1 byte),
//           or the gradient wire's carrier, which the sum over ranks
//           neither wraps nor rounds: int8 values as int32, fp8 values
//           as fp32 (grad_comm.py block_encode(carrier=True)).
//   decode: out[i] = (float(q[i]) * s[row]) / world for i < numel, from
//           the 1-byte wire dtype or from a (summed) carrier, stored
//           fp32 or rounded once to bf16 (__float2bfloat16_rn) or to
//           fp16 (__float2half_rn), to nearest even, as the reference's
//           .astype(...) and PyTorch's .to(...) round: an fp16 result
//           below 2^-14 is kept as a subnormal and one past 65,504
//           rounds to inf (the build sets no flush-to-zero, no
//           --use_fast_math); when world is a power of two the
//           divide is a multiply by its exact inverse (the same
//           correctly rounded result).
// Bits equal the plain versions' (and the JAX reference's): the same
// correctly rounded divide, multiply and conversions.
//
// What bounds them: device-memory bytes, and at the serving decode step
// the fixed cost of a launch. Each element is read once and written once
// with a handful of operations, far below the H100's ~20 fp32 operations
// per byte of HBM bandwidth. At GPT-125M's shapes (ept = 12 layers * 2 *
// 768 = 18,432 elements per token, 1024-element blocks, 3.35 TB/s):
//   encode, 1024 tokens: read 75.5 MB fp32, write 18.9 MB int8   ~ 28 us
//   decode, 1024 tokens: read 18.9 MB, write 75.5 MB             ~ 28 us
//   a gradient bucket of 4615 blocks, int32 carrier: 37.8 MB     ~ 11 us
//   a bf16 or fp16 bucket reads 2 bytes an element instead of 4 (6 bytes
//   an element with the int32 carrier), and a decode to either writes 2
//   one decode step, batch 8: ~0.7 MB, 0.2 us of bytes against a launch
//   of several us; no design of the kernel moves that.
//
// Design, for the bytes (variants timed by tools/torch_codec_ab.py):
//  - The input is read where it lies. The kernel reads x only below n
//    and encodes zeros above it, so a ragged bucket (n % bs != 0) needs
//    no zero-padded copy: a copy is one more read and write of the
//    bucket and an allocation, as long as the encode itself.
//  - The grid maps onto rows: blockIdx.y and threadIdx.y pick the row,
//    blockIdx.x and threadIdx.x the thread's place in it, so a thread
//    reads its row's scale once and divides no index.
//  - A thread keeps kQuads = 2 quads (4 consecutive elements each) in
//    flight, both loads issued before the first is used. The quads are
//    interleaved across the warp (lane l takes 4 l + 128 k), so every
//    warp access is one contiguous run: 512 bytes of fp32 or int32,
//    128 bytes of 1-byte payload. 1 quad was faster at the decode step
//    and slower on the largest buckets, 4 quads slower at every serving
//    shape; 16 consecutive elements a thread (one 16-byte payload
//    access) half-filled the 32-byte sectors of every 4-byte access and
//    ran the fp32 decode and the carrier encode at half speed.
//  - The decode divides by world with a multiply when world is a power
//    of two (the serving read-back's world = 1 and a 2-rank wire), by
//    the exact inverse: the same bits, none of the divide's per-element
//    cost, which bound the decode.
//  - Inputs are read once, so they are loaded streaming (__ldcs): 3-5%
//    faster on the serving encodes than plain or read-only loads, 2%
//    slower on the largest gradient bucket.
//  - Only a quad that reaches past the end (the last row's tail) is
//    read or written element by element; every other quad is one
//    access.
//  - A bf16 quad is one 8-byte access, lifted to fp32 by a shift of its
//    bits (exact); an fp16 quad is the same access, each half lifted by
//    __half2float (exact: every fp16 value, subnormals included, is an
//    fp32 value), not a shift; a 16-bit output quad is one 8-byte store.
//    So the 16-bit forms keep the fp32 forms' layout, rows and
//    interleaved quads, and move fewer bytes.
//  - The vector accesses need pointers aligned to a quad's bytes (16 for
//    fp32 and int32, 8 for bf16, 16 for the 1-byte wire as the caller
//    allocates it; every caller of the port: the buffers are their own
//    allocations). Any other start takes the element-by-element path
//    everywhere: right, and slower.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kQuads = 2;       // 4-element quads a thread keeps in flight
constexpr int kQuadStride = 32 * 4;           // elements between them
constexpr int kWarpSpan = kQuads * kQuadStride;   // elements a warp takes
constexpr int kInt8 = 0;
constexpr int kFp8 = 1;
constexpr int kF32 = 0;   // element types of the encode's input and the
constexpr int kBf16 = 1;  // decode's output
constexpr int kF16 = 2;

// four elements of each type, moved in one access
template <typename T> struct Quad;
template <> struct Quad<uint8_t> { using type = uchar4; };
template <> struct Quad<int32_t> { using type = int4; };
template <> struct Quad<float> { using type = float4; };

// p[0..3] in one streaming access when VEC and all four lie below the
// end (`left` elements remain from p on), else element by element, the
// ones at or past the end reading as 0
template <typename T, bool VEC>
__device__ __forceinline__ typename Quad<T>::type load_quad(const T* p,
                                                            int64_t left) {
  using Q = typename Quad<T>::type;
  if (VEC && left >= 4) return __ldcs(reinterpret_cast<const Q*>(p));
  Q r;
  r.x = left > 0 ? p[0] : T(0);
  r.y = left > 1 ? p[1] : T(0);
  r.z = left > 2 ? p[2] : T(0);
  r.w = left > 3 ? p[3] : T(0);
  return r;
}

// bf16 bits in the low or high half of a 32-bit word, as fp32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// fp16 bits in the low or high half of a 32-bit word, as fp32 (exact)
__device__ __forceinline__ float f16_lo(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
}
__device__ __forceinline__ float f16_hi(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

// the 16-bit element types: their value as fp32 (exact), and an fp32
// rounded to them, nearest even, as 16 bits
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ uint32_t bits16(float x) {
  if constexpr (std::is_same_v<T, __half>)
    return __half_as_ushort(__float2half_rn(x));
  else
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// p[0..3] lifted to fp32: fp32 as load_quad reads it; bf16 or fp16 in
// one 8-byte streaming access when VEC and all four lie below the end,
// else element by element, the ones at or past the end reading as 0
template <typename InT, bool VEC>
__device__ __forceinline__ float4 load_in(const InT* p, int64_t left) {
  if constexpr (std::is_same_v<InT, float>) {
    return load_quad<float, VEC>(p, left);
  } else {
    if (VEC && left >= 4) {
      const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
      if constexpr (std::is_same_v<InT, __half>)
        return make_float4(f16_lo(u.x), f16_hi(u.x), f16_lo(u.y),
                           f16_hi(u.y));
      else
        return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                           bf16_hi(u.y));
    }
    return make_float4(left > 0 ? to_f32(p[0]) : 0.0f,
                       left > 1 ? to_f32(p[1]) : 0.0f,
                       left > 2 ? to_f32(p[2]) : 0.0f,
                       left > 3 ? to_f32(p[3]) : 0.0f);
  }
}

// p[0..3] = v, in one access when VEC and all four lie below the end,
// else only the elements below it
template <typename T, bool VEC>
__device__ __forceinline__ void store_quad(T* p,
                                           const typename Quad<T>::type& v,
                                           int64_t left) {
  using Q = typename Quad<T>::type;
  if (VEC && left >= 4) {
    *reinterpret_cast<Q*>(p) = v;
    return;
  }
  if (left > 0) p[0] = v.x;
  if (left > 1) p[1] = v.y;
  if (left > 2) p[2] = v.z;
  if (left > 3) p[3] = v.w;
}

// A zero input skips the divide: 0 / s is the signed zero x itself for
// s > 0 (infinite s included). Zeros are common (a ragged block's tail,
// the embedding gradient's untouched rows), and an all-zero block, whose
// scale is the 1e-12 floor, made the decode-step encode 0.5 us slower
// through the divide (tools/torch_codec_ab.py).
template <int CODEC>
__device__ __forceinline__ uint8_t encode_one(float x, float s) {
  const float q = x == 0.0f && s > 0.0f ? x : __fdiv_rn(x, s);
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

// (x * s) / world. With POW2 (world a power of two, 1 included) w is
// 1 / world, exact, and the divide is a multiply by it: both round the
// same real number, so the bits are the divide's. Otherwise w is world.
template <int CODEC, typename InT, bool POW2>
__device__ __forceinline__ float decode_one(InT v, float s, float w) {
  float x;
  if constexpr (sizeof(InT) == 1) {
    x = wire_value<CODEC>(v);
  } else {
    x = static_cast<float>(v);   // the carrier's exact value
  }
  const float y = __fmul_rn(x, s);
  return POW2 ? __fmul_rn(y, w) : __fdiv_rn(y, w);
}

// decoded values stored: fp32 as store_quad writes them; bf16 or fp16
// each rounded to nearest even, in one 8-byte access when VEC and all
// four lie below the end, else only the elements below it
template <typename OutT, bool VEC>
__device__ __forceinline__ void store_out(OutT* p, const float4& v,
                                          int64_t left) {
  if constexpr (std::is_same_v<OutT, float>) {
    store_quad<float, VEC>(p, v, left);
  } else {
    const uint32_t b0 = bits16<OutT>(v.x), b1 = bits16<OutT>(v.y),
                   b2 = bits16<OutT>(v.z), b3 = bits16<OutT>(v.w);
    if (VEC && left >= 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(b0 | b1 << 16, b2 | b3 << 16);
      return;
    }
    unsigned short* h = reinterpret_cast<unsigned short*>(p);
    if (left > 0) h[0] = static_cast<unsigned short>(b0);
    if (left > 1) h[1] = static_cast<unsigned short>(b1);
    if (left > 2) h[2] = static_cast<unsigned short>(b2);
    if (left > 3) h[3] = static_cast<unsigned short>(b3);
  }
}

template <int CODEC, typename OutT>
__device__ __forceinline__ typename Quad<OutT>::type encode_quad(float4 v,
                                                                 float s) {
  typename Quad<OutT>::type o;
  o.x = to_out<CODEC, OutT>(encode_one<CODEC>(v.x, s));
  o.y = to_out<CODEC, OutT>(encode_one<CODEC>(v.y, s));
  o.z = to_out<CODEC, OutT>(encode_one<CODEC>(v.z, s));
  o.w = to_out<CODEC, OutT>(encode_one<CODEC>(v.w, s));
  return o;
}

template <int CODEC, typename InT, bool POW2>
__device__ __forceinline__ float4 decode_quad(
    const typename Quad<InT>::type& v, float s, float w) {
  return make_float4(decode_one<CODEC, InT, POW2>(v.x, s, w),
                     decode_one<CODEC, InT, POW2>(v.y, s, w),
                     decode_one<CODEC, InT, POW2>(v.z, s, w),
                     decode_one<CODEC, InT, POW2>(v.w, s, w));
}

// The thread's first quad: its offset in a row (blockIdx.x, threadIdx.x;
// a warp takes kWarpSpan elements, lane l the quads at 4 l + k
// kQuadStride), and its first row (blockIdx.y, threadIdx.y), striding by
// the grid's rows when nb outgrows gridDim.y.
__device__ __forceinline__ int64_t quad_offset() {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  return (t / 32) * kWarpSpan + (t % 32) * 4;
}
__device__ __forceinline__ int64_t first_row() {
  return static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y;
}
__device__ __forceinline__ int64_t row_stride() {
  return static_cast<int64_t>(gridDim.y) * blockDim.y;
}

template <int CODEC, typename InT, typename OutT, bool VEC>
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const InT* __restrict__ x,
                  const float* __restrict__ scales, OutT* __restrict__ out,
                  int64_t n, int64_t nb, int64_t bs) {
  const int64_t e = quad_offset();
  if (e >= bs) return;
  for (int64_t row = first_row(); row < nb; row += row_stride()) {
    const float s = __ldg(scales + row);
    const int64_t i = row * bs + e;
    float4 v[kQuads];
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {   // every load in flight first
      const int64_t at = i + k * kQuadStride;
      if (e + k * kQuadStride < bs)
        v[k] = load_in<InT, VEC>(x + at, n - at);
    }
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {   // past n: encode(0), as padded
      const int64_t at = i + k * kQuadStride;
      if (e + k * kQuadStride < bs)
        store_quad<OutT, VEC>(out + at, encode_quad<CODEC, OutT>(v[k], s),
                              4);
    }
  }
}

template <int CODEC, typename InT, typename OutT, bool VEC, bool POW2>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const InT* __restrict__ q,
                  const float* __restrict__ scales, OutT* __restrict__ out,
                  int64_t numel, int64_t nb, int64_t bs, float w) {
  const int64_t e = quad_offset();
  if (e >= bs) return;
  for (int64_t row = first_row(); row < nb; row += row_stride()) {
    const int64_t i = row * bs + e;
    if (i >= numel) return;   // rows only grow
    const float s = __ldg(scales + row);
    typename Quad<InT>::type v[kQuads];
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const int64_t at = i + k * kQuadStride;
      if (e + k * kQuadStride < bs)
        v[k] = load_quad<InT, VEC>(q + at, numel - at);
    }
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const int64_t at = i + k * kQuadStride;
      if (e + k * kQuadStride < bs)
        store_out<OutT, VEC>(out + at,
                             decode_quad<CODEC, InT, POW2>(v[k], s, w),
                             numel - at);
    }
  }
}

// threadIdx.x over a row's warps (kWarpSpan elements each, up to
// kThreads threads), threadIdx.y over the rows a block takes; the grid's
// rows capped at the hardware's 65535 (the kernels stride past it).
struct Launch {
  dim3 grid, block;
};

inline Launch launch_for(int64_t nb, int64_t bs) {
  const int64_t per_row = (bs + kWarpSpan - 1) / kWarpSpan * 32;
  const int64_t bx = per_row < kThreads ? per_row : kThreads;
  const int64_t by = kThreads / bx;
  const int64_t gy = (nb + by - 1) / by;
  return {dim3(static_cast<unsigned>((per_row + bx - 1) / bx),
               static_cast<unsigned>(gy < 65535 ? gy : 65535)),
          dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by))};
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a quad of T starts on its own size: 16 bytes for fp32 and int32, 8 for
// bf16 and fp16 (the 1-byte wire is held to 16 as well)
template <typename T>
inline bool quad_aligned(const void* p) {
  return sizeof(T) == 2 ? reinterpret_cast<uintptr_t>(p) % 8 == 0
                        : aligned16(p);
}

template <int CODEC, typename InT, typename OutT>
void launch_encode(const void* x, const void* scales, void* out, int64_t n,
                   int64_t nb, int64_t bs, cudaStream_t st) {
  const Launch l = launch_for(nb, bs);
  const auto* xp = static_cast<const InT*>(x);
  const auto* sp = static_cast<const float*>(scales);
  auto* op = static_cast<OutT*>(out);
  if (quad_aligned<InT>(x) && aligned16(out))
    encode_kernel<CODEC, InT, OutT, true><<<l.grid, l.block, 0, st>>>(
        xp, sp, op, n, nb, bs);
  else
    encode_kernel<CODEC, InT, OutT, false><<<l.grid, l.block, 0, st>>>(
        xp, sp, op, n, nb, bs);
}

template <int CODEC, typename OutT>
void launch_encode(const void* x, const void* scales, void* out, int64_t n,
                   int64_t nb, int64_t bs, int in_type, cudaStream_t st) {
  if (in_type == kBf16)
    launch_encode<CODEC, __nv_bfloat16, OutT>(x, scales, out, n, nb, bs, st);
  else if (in_type == kF16)
    launch_encode<CODEC, __half, OutT>(x, scales, out, n, nb, bs, st);
  else
    launch_encode<CODEC, float, OutT>(x, scales, out, n, nb, bs, st);
}

template <int CODEC, typename InT, typename OutT, bool VEC>
void launch_decode(const Launch& l, const void* q, const void* scales,
                   void* out, int64_t numel, int64_t nb, int64_t bs,
                   float world, cudaStream_t st) {
  const auto* qp = static_cast<const InT*>(q);
  const auto* sp = static_cast<const float*>(scales);
  auto* op = static_cast<OutT*>(out);
  int e;
  if (std::frexp(world, &e) == 0.5f)   // world = 2^(e - 1)
    decode_kernel<CODEC, InT, OutT, VEC, true><<<l.grid, l.block, 0, st>>>(
        qp, sp, op, numel, nb, bs, std::ldexp(1.0f, 1 - e));
  else
    decode_kernel<CODEC, InT, OutT, VEC, false><<<l.grid, l.block, 0, st>>>(
        qp, sp, op, numel, nb, bs, world);
}

template <int CODEC, typename InT, typename OutT>
void launch_decode(const void* q, const void* scales, void* out,
                   int64_t numel, int64_t nb, int64_t bs, float world,
                   cudaStream_t st) {
  const Launch l = launch_for(nb, bs);
  if (aligned16(q) && quad_aligned<OutT>(out))
    launch_decode<CODEC, InT, OutT, true>(l, q, scales, out, numel, nb, bs,
                                          world, st);
  else
    launch_decode<CODEC, InT, OutT, false>(l, q, scales, out, numel, nb, bs,
                                           world, st);
}

template <int CODEC, typename InT>
void launch_decode(const void* q, const void* scales, void* out,
                   int64_t numel, int64_t nb, int64_t bs, float world,
                   int out_type, cudaStream_t st) {
  if (out_type == kBf16)
    launch_decode<CODEC, InT, __nv_bfloat16>(q, scales, out, numel, nb, bs,
                                             world, st);
  else if (out_type == kF16)
    launch_decode<CODEC, InT, __half>(q, scales, out, numel, nb, bs, world,
                                      st);
  else
    launch_decode<CODEC, InT, float>(q, scales, out, numel, nb, bs, world,
                                     st);
}

}  // namespace

// x: [n] of in_type (0 fp32, 1 bf16, 2 fp16), n <= nb * bs, read in place (any
// start aligned to its element); bs % 4 == 0; scales: fp32 [nb]; out:
// [nb * bs] of the 1-byte wire dtype (carrier 0) or of the carrier
// (carrier 1: int32 for int8_block, fp32 for fp8_block), the elements
// from n on encoding x = 0. codec: 0 = int8_block, 1 = fp8_block.
// Returns cudaGetLastError().
extern "C" int codec_encode(const void* x, const void* scales, void* out,
                            int64_t n, int64_t nb, int64_t bs, int codec,
                            int carrier, int in_type, void* stream) {
  if (nb == 0) return static_cast<int>(cudaSuccess);
  if (bs <= 0 || bs % 4 || n > nb * bs || in_type < kF32 ||
      in_type > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (codec == kInt8 && !carrier) {
    launch_encode<kInt8, uint8_t>(x, scales, out, n, nb, bs, in_type, st);
  } else if (codec == kInt8) {
    launch_encode<kInt8, int32_t>(x, scales, out, n, nb, bs, in_type, st);
  } else if (codec == kFp8 && !carrier) {
    launch_encode<kFp8, uint8_t>(x, scales, out, n, nb, bs, in_type, st);
  } else if (codec == kFp8) {
    launch_encode<kFp8, float>(x, scales, out, n, nb, bs, in_type, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [nb * bs] of the payload type `wire`: 0 int8, 1 fp8 e4m3 (1 byte
// each), 2 int32 carrier, 3 fp32 carrier; scales: fp32 [nb]; out:
// [numel] of out_type (0 fp32, 1 bf16, 2 fp16), numel <= nb * bs;
// bs % 4 == 0.
// Returns cudaGetLastError().
extern "C" int codec_decode(const void* q, const void* scales, void* out,
                            int64_t nb, int64_t bs, int64_t numel, int wire,
                            float world, int out_type, void* stream) {
  if (numel == 0) return static_cast<int>(cudaSuccess);
  if (bs <= 0 || bs % 4 || numel > nb * bs || out_type < kF32 ||
      out_type > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wire) {
    case 0:
      launch_decode<kInt8, uint8_t>(q, scales, out, numel, nb, bs, world,
                                    out_type, st);
      break;
    case 1:
      launch_decode<kFp8, uint8_t>(q, scales, out, numel, nb, bs, world,
                                   out_type, st);
      break;
    case 2:
      launch_decode<kInt8, int32_t>(q, scales, out, numel, nb, bs, world,
                                    out_type, st);
      break;
    case 3:
      launch_decode<kFp8, float>(q, scales, out, numel, nb, bs, world,
                                 out_type, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
