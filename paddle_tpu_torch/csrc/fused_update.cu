// Fused optimizer updates over flat parameter buckets, for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused_update.py:
//   fused_update_buckets <- _plain_kernel (fused_update.py:122, launched by
//                           fused_update_flat :223, once per bucket by
//                           paddle_tpu/optimizer/fused.py:189-214)
//   fused_dequant_update_buckets
//                        <- _dequant_kernel (fused_update.py:134, launched
//                           by fused_dequant_update_flat :283, once per
//                           bucket by paddle_tpu/jit/__init__.py:763-800)
// Plain PyTorch versions and wrappers: paddle_tpu_torch/ops/fused_update.py
// (buckets_plain / fused_update_buckets, fused_dequant_update_buckets;
// reference_dequant_update_flat is the plain dequantizing update of one
// bucket).
//
// What they compute: one SGD / Momentum / Adam / AdamW step over fp32
// elements, in place: p (and the slots) are read, updated and written
// back. The arithmetic is _update_math (fused_update.py:92-119) op for
// op, each op rounded once: __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn keep nvcc from contracting a*b+c into an FMA,
// so the result is bit-identical to the plain PyTorch version, whose
// kernels round every op. Hyperparameters arrive as fp32 values the host
// rounded from Python floats, as PyTorch rounds a Python scalar operand.
//
// A bucket of fused_update_buckets is fp32 or bf16: bf16 parameters and
// gradients with fp32 moments follow the reference's cast chain
// (fused_update.py:12-28, optimizer/fused.py _bucket_fn): the gradient
// cast to the parameters' dtype (a no-op here: the bucket holds one) and
// lifted to fp32, the parameter lifted to fp32, the same fp32 ops, and
// the new parameter rounded to bf16 to nearest even
// (__float2bfloat16_rn, as PyTorch's .to(bfloat16)); the moments stay
// fp32. So the bf16 update is bit-identical to its plain version too. An
// fp16 bucket is the same chain with __half: read as __half2float, the
// new parameter stored by __float2half_rn (to nearest even, as PyTorch's
// .to(float16) and the reference's new_p.astype(out dtype),
// fused_update.py:129), 8 elements a chunk as bf16's. Buckets of all
// three dtypes ride in one launch: the table's dtype word picks the
// thread's chunk width and element type. The dequantizing update takes
// the three as well.
//
// fused_update_buckets runs one step of an updater over all of its
// buckets in one launch. It walks a table in device memory, one Bucket
// per flat bucket (pointers, size, wd, lr_mult, beta powers in and out),
// built once by the caller and rebuilt only when a pointer changes. The
// scalar prep of _scalar_prep (:181-191) runs here too, per bucket, with
// PyTorch's fp32 ops: lr * lr_mult, beta_pow * beta, 1 - beta_pow * beta.
// Thread b of the launch writes bucket b's stepped powers to pow_out,
// which no thread of the launch reads (the caller alternates two
// buffers), so no thread can read a power another has already stepped.
//
// fused_dequant_update_buckets walks the same table, each bucket carrying,
// instead of the gradient, the gradient wire's payload summed over
// `world` ranks: int8 values in an int32 carrier or fp8 values in an
// fp32 carrier (one carrier type a launch), with one fp32 scale per
// block_size elements, and an optional fp32 residual. Each element's
// gradient is block_decode's chain, q * scale[i / block_size]
// (__fmul_rn), then / world (__fdiv_rn, a true division: the plain
// version divides by a device tensor), then + residual, then the
// reference's cast chain (_dequant_kernel, fused_update.py:148): rounded
// to the bucket's dtype, then to the parameters' dtype, and lifted to
// fp32, which for a bucket of bf16 parameters, or a bf16 bucket over
// fp32 ones, is one __float2bfloat16_rn and back, and for fp16 one
// __float2half_rn and back (subnormals kept, inf past 65,504: the build
// has no flush-to-zero); the update follows in registers. The decoded
// gradient never reaches device memory. It runs once a step over every
// bucket, fp32, bf16 and fp16 alike.
//
// What bounds them: device-memory bytes. AdamW reads p, g (or the 4-byte
// carrier), m1, m2 and writes p, m1, m2: 28 bytes per element for ~20
// operations (32 with a residual, plus the scale vector). All of GPT-125M
// (124.5 M parameters) moves 3.49 GB per step, 1.04 ms at 3.35 TB/s; the
// int32 carrier is as wide as the fp32 gradient, so the two kernels share
// the bound. A bf16 or fp16 bucket moves 22 bytes an element (p 2 + 2,
// g 2, moments 8 + 8): GPT-125M in bf16, 2.74 GB, 0.82 ms; from the
// carrier 24 bytes (q 4), 2.99 GB, 0.89 ms (times on the card: PERF.md).
//
// Design: one thread per chunk of consecutive elements, 4 in an fp32
// bucket and 8 in a bf16 one, so the parameters and the gradient are one
// 16-byte vector a thread either way (the moments two in a bf16 bucket);
// the wrappers check 16-byte alignment. A bucket's ragged tail (n % 4 or
// n % 8) is a scalar loop in its last thread. A launch's grid covers the
// chunks of every bucket, one after the other; a thread finds its
// chunk's bucket by a binary search over the table's first chunks.
// Nothing is staged in shared memory: each element is touched once. The
// two kernels share the walk and the update; they differ only in where a
// chunk's gradient comes from (PlainGrad, DequantGrad). The dequantizing
// one reads the chunk's carrier as one or two 16-byte vectors and one
// scale for the chunk when its elements share a block, else one per
// element, so every block_size is taken.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
enum Kind { kSgd = 0, kMomentum = 1, kAdam = 2, kAdamW = 3 };

struct Hyper {
  float wd;        // weight decay; has_wd mirrors the reference's `if wd:`
  int has_wd;
  float h0, h1;    // momentum: (mu, -); adam: (beta1, beta2)
  float om0, om1;  // adam: (1 - beta1, 1 - beta2), rounded on the host
  float eps;
  int nesterov;
};

template <int KIND>
__device__ __forceinline__ void update_one(float& p, float g, float& s0,
                                           float& s1, const Hyper& h,
                                           float lr, float c1, float c2) {
  if (KIND == kSgd) {
    if (h.has_wd) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    p = __fsub_rn(p, __fmul_rn(lr, g));
  } else if (KIND == kMomentum) {
    if (h.has_wd) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    const float v = __fadd_rn(__fmul_rn(h.h0, s0), g);
    s0 = v;
    if (h.nesterov)
      p = __fsub_rn(p, __fmul_rn(lr, __fadd_rn(g, __fmul_rn(h.h0, v))));
    else
      p = __fsub_rn(p, __fmul_rn(lr, v));
  } else {
    if (KIND == kAdam && h.has_wd) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    const float m1 = __fadd_rn(__fmul_rn(h.h0, s0), __fmul_rn(h.om0, g));
    const float m2 = __fadd_rn(__fmul_rn(h.h1, s1),
                               __fmul_rn(__fmul_rn(h.om1, g), g));
    const float mhat = __fdiv_rn(m1, c1);
    const float vhat = __fdiv_rn(m2, c2);
    float np = __fsub_rn(
        p, __fdiv_rn(__fmul_rn(lr, mhat), __fadd_rn(__fsqrt_rn(vhat), h.eps)));
    if (KIND == kAdamW && h.has_wd)
      np = __fsub_rn(np, __fmul_rn(__fmul_rn(lr, h.wd), p));
    p = np;
    s0 = m1;
    s1 = m2;
  }
}

// One bucket of a launch. ops/fused_update.py (BucketTable) packs the
// same 112-byte layout as fourteen 8-byte words.
struct Bucket {
  void* p;                // fp32 or bf16 (dtype)
  const void* g;          // the parameters' dtype (null in a dequant table)
  float* s0;              // velocity or moment1 (null for sgd)
  float* s1;              // moment2 (null unless adam / adamw)
  const float* pow_in;    // adam: [beta1^t, beta2^t]
  float* pow_out;         // adam: [beta1^(t+1), beta2^(t+1)], written
  int64_t n;
  int64_t start;          // the bucket's first chunk in the launch
  float wd;
  float lm;               // lr_mult
  int64_t dtype;          // 0: fp32 p and g, 4 elements a chunk; 1: bf16,
                          // 8; 2: fp32 p whose dequantized gradient is
                          // rounded to bf16 (a bf16 bucket), 4; 3: fp16,
                          // 8; 4: fp32 p whose dequantized gradient is
                          // rounded to fp16 (an fp16 bucket), 4
  const void* q;          // dequant: the summed carrier, [>= n]
  const float* scales;    // dequant: fp32 [ceil(n / bs)]
  const float* res;       // dequant: fp32 residual [n], or null
  int64_t bs;             // dequant: elements a scale
};
static_assert(sizeof(Bucket) == 112, "BucketTable packs 14 words a bucket");

// The parameters' and gradients' element type of a bucket: fp32 as it
// is, bf16 lifted to fp32 and rounded back to nearest even.
template <typename P> struct Elem;
template <> struct Elem<float> {
  static constexpr int kChunk = 4;
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kChunk = 8;
  __device__ static float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <> struct Elem<__half> {
  static constexpr int kChunk = 8;
  __device__ static float load(__half x) { return __half2float(x); }
  __device__ static __half store(float x) { return __float2half_rn(x); }
};

// The gradient of a plain update: g in the parameters' dtype, lifted to
// fp32 (the cast to the parameters' dtype is a no-op: the bucket holds
// it), a chunk as one 16-byte vector.
struct PlainGrad {
  template <typename P, int C>
  __device__ __forceinline__ void chunk(const Bucket& e, int64_t i,
                                        float (&g)[C]) const {
    const uint4 gv =
        *reinterpret_cast<const uint4*>(static_cast<const P*>(e.g) + i);
    const P* gx = reinterpret_cast<const P*>(&gv);
#pragma unroll
    for (int k = 0; k < C; ++k) g[k] = Elem<P>::load(gx[k]);
  }
  template <typename P>
  __device__ __forceinline__ float one(const Bucket& e, int64_t j) const {
    return Elem<P>::load(static_cast<const P*>(e.g)[j]);
  }
};

template <typename Q> struct Vec4;
template <> struct Vec4<int32_t> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

// The gradient of a dequantizing update, decoded from the summed carrier
// Q (int32 or fp32): block_decode's chain, then the cast chain.
template <typename Q>
struct DequantGrad {
  float world;

  // (q * scale) / world (+ residual), rounded to bf16 and back where the
  // bucket or the parameters are bf16, to fp16 and back where they are
  // fp16
  __device__ __forceinline__ float decode(const Bucket& e, Q q, float s,
                                          float r) const {
    float g = __fdiv_rn(__fmul_rn(static_cast<float>(q), s), world);
    if (e.res != nullptr) g = __fadd_rn(g, r);
    if (e.dtype == 1 || e.dtype == 2)
      return __bfloat162float(__float2bfloat16_rn(g));
    if (e.dtype >= 3) return __half2float(__float2half_rn(g));
    return g;
  }

  template <typename P, int C>
  __device__ __forceinline__ void chunk(const Bucket& e, int64_t i,
                                        float (&g)[C]) const {
    using V = typename Vec4<Q>::type;
    const Q* __restrict__ q = static_cast<const Q*>(e.q) + i;
    Q qv[C];
    float r[C];
#pragma unroll
    for (int k = 0; k < C; k += 4) {
      const V v = *reinterpret_cast<const V*>(q + k);
      qv[k] = v.x; qv[k + 1] = v.y; qv[k + 2] = v.z; qv[k + 3] = v.w;
      const float4 rv = e.res != nullptr
                            ? *reinterpret_cast<const float4*>(e.res + i + k)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      r[k] = rv.x; r[k + 1] = rv.y; r[k + 2] = rv.z; r[k + 3] = rv.w;
    }
    const int64_t blk = i / e.bs;
    if ((i + C - 1) / e.bs == blk) {   // one block: one scale
      const float s = __ldg(e.scales + blk);
#pragma unroll
      for (int k = 0; k < C; ++k) g[k] = decode(e, qv[k], s, r[k]);
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k)
        g[k] = decode(e, qv[k], __ldg(e.scales + (i + k) / e.bs), r[k]);
    }
  }
  template <typename P>
  __device__ __forceinline__ float one(const Bucket& e, int64_t j) const {
    return decode(e, static_cast<const Q*>(e.q)[j],
                  __ldg(e.scales + j / e.bs),
                  e.res != nullptr ? e.res[j] : 0.0f);
  }
};

// Update elements [i, i + kChunk) of bucket e (or its tail up to n), the
// gradient from `grad`: p as one 16-byte vector, each moment as
// kChunk / 4 float4s.
template <int KIND, typename P, class Grad>
__device__ __forceinline__ void update_chunk(const Bucket& e, int64_t i,
                                             const Hyper& h, float lr,
                                             float c1, float c2,
                                             const Grad& grad) {
  constexpr bool kSlot0 = KIND != kSgd;
  constexpr bool kSlot1 = KIND == kAdam || KIND == kAdamW;
  constexpr int C = Elem<P>::kChunk;
  P* __restrict__ p = static_cast<P*>(e.p);
  float* __restrict__ s0 = e.s0;
  float* __restrict__ s1 = e.s1;
  if (i + C <= e.n) {
    uint4 pv = *reinterpret_cast<const uint4*>(p + i);
    float gx[C];
    grad.template chunk<P, C>(e, i, gx);
    P* px = reinterpret_cast<P*>(&pv);
    float a[C], b[C];
#pragma unroll
    for (int q = 0; q < C; q += 4) {
      const float4 va = kSlot0 ? *reinterpret_cast<const float4*>(s0 + i + q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 vb = kSlot1 ? *reinterpret_cast<const float4*>(s1 + i + q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      a[q] = va.x; a[q + 1] = va.y; a[q + 2] = va.z; a[q + 3] = va.w;
      b[q] = vb.x; b[q + 1] = vb.y; b[q + 2] = vb.z; b[q + 3] = vb.w;
    }
#pragma unroll
    for (int q = 0; q < C; ++q) {
      float pj = Elem<P>::load(px[q]);
      update_one<KIND>(pj, gx[q], a[q], b[q], h, lr, c1, c2);
      px[q] = Elem<P>::store(pj);
    }
    *reinterpret_cast<uint4*>(p + i) = pv;
#pragma unroll
    for (int q = 0; q < C; q += 4) {
      if (kSlot0)
        *reinterpret_cast<float4*>(s0 + i + q) =
            make_float4(a[q], a[q + 1], a[q + 2], a[q + 3]);
      if (kSlot1)
        *reinterpret_cast<float4*>(s1 + i + q) =
            make_float4(b[q], b[q + 1], b[q + 2], b[q + 3]);
    }
  } else {
    for (int64_t j = i; j < e.n; ++j) {
      float a = kSlot0 ? s0[j] : 0.f, b = kSlot1 ? s1[j] : 0.f;
      float pj = Elem<P>::load(p[j]);
      update_one<KIND>(pj, grad.template one<P>(e, j), a, b, h, lr, c1, c2);
      p[j] = Elem<P>::store(pj);
      if (kSlot0) s0[j] = a;
      if (kSlot1) s1[j] = b;
    }
  }
}

// One thread per chunk c of the launch's `total`, in bucket order;
// thread b < nb also steps bucket b's beta powers (adam).
template <int KIND, class Grad>
__device__ __forceinline__ void walk_table(const Bucket* __restrict__ table,
                                           int nb, int64_t total,
                                           const float* __restrict__ lr_dev,
                                           Hyper h, const Grad& grad) {
  constexpr bool kSlot1 = KIND == kAdam || KIND == kAdamW;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (kSlot1 && c < nb) {
    const Bucket& e = table[c];
    e.pow_out[0] = __fmul_rn(e.pow_in[0], h.h0);
    e.pow_out[1] = __fmul_rn(e.pow_in[1], h.h1);
  }
  if (c >= total) return;
  int lo = 0, hi = nb - 1;          // the last bucket starting at or before c
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid].start <= c) lo = mid; else hi = mid - 1;
  }
  const Bucket& e = table[lo];
  h.wd = e.wd;
  h.has_wd = e.wd != 0.0f;
  const float lr = __fmul_rn(*lr_dev, e.lm);     // _scalar_prep's fp32 ops
  const float c1 =
      kSlot1 ? __fsub_rn(1.0f, __fmul_rn(e.pow_in[0], h.h0)) : 1.0f;
  const float c2 =
      kSlot1 ? __fsub_rn(1.0f, __fmul_rn(e.pow_in[1], h.h1)) : 1.0f;
  if (e.dtype == 1)
    update_chunk<KIND, __nv_bfloat16>(e, (c - e.start) * 8, h, lr, c1, c2,
                                      grad);
  else if (e.dtype == 3)
    update_chunk<KIND, __half>(e, (c - e.start) * 8, h, lr, c1, c2, grad);
  else   // 0, and the fp32 parameters of 16-bit buckets, 2 and 4
    update_chunk<KIND, float>(e, (c - e.start) * 4, h, lr, c1, c2, grad);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
update_kernel(const Bucket* __restrict__ table, int nb, int64_t total,
              const float* __restrict__ lr_dev, Hyper h) {
  walk_table<KIND>(table, nb, total, lr_dev, h, PlainGrad{});
}

// the carrier's value is exact in fp32: |q| <= 127 * world, or fp8 sums
template <int KIND, typename Q>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const Bucket* __restrict__ table, int nb, int64_t total,
               const float* __restrict__ lr_dev, float world, Hyper h) {
  walk_table<KIND>(table, nb, total, lr_dev, h, DequantGrad<Q>{world});
}

// Calls launch(std::integral_constant<int, KIND>{}) for the rule `kind`
// and returns the launch's error code.
template <typename F>
int with_kind(int kind, F&& launch) {
  switch (kind) {
    case kSgd: launch(std::integral_constant<int, kSgd>{}); break;
    case kMomentum: launch(std::integral_constant<int, kMomentum>{}); break;
    case kAdam: launch(std::integral_constant<int, kAdam>{}); break;
    case kAdamW: launch(std::integral_constant<int, kAdamW>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// a thread per chunk, and at least one per bucket for its powers
inline unsigned int grid_for(int nb, int64_t total_chunks) {
  const int64_t threads = total_chunks > nb ? total_chunks : nb;
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// One update of every bucket in `table` (device memory, nb Bucket
// entries whose chunks, 4 elements in an fp32 bucket and 8 in a bf16 or
// fp16 one, start at 0 and run back to back, total_chunks in all), in place.
// lr: fp32 [1] on the device, the step's learning rate.
// kind: 0 sgd, 1 momentum, 2 adam, 3 adamw; h0, h1: (mu, -) or (beta1,
// beta2); om0, om1: 1 - h0, 1 - h1 rounded on the host. Adam's stepped
// powers go to each bucket's pow_out. Returns a cudaError_t code.
extern "C" int fused_update_buckets(const void* table, int nb,
                                    int64_t total_chunks, const void* lr,
                                    int kind, float h0, float h1, float om0,
                                    float om1, float eps, int nesterov,
                                    void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  if (table == nullptr || lr == nullptr || total_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{0.0f, 0, h0, h1, om0, om1, eps, nesterov};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kind(kind, [&](auto k) {
    update_kernel<decltype(k)::value>
        <<<grid_for(nb, total_chunks), kThreads, 0, st>>>(
            static_cast<const Bucket*>(table), nb, total_chunks,
            static_cast<const float*>(lr), h);
  });
}

// fused_update_buckets with every bucket's gradient decoded from its
// summed wire payload (the table's q, scales, res, bs; g unused): q is
// an int32 (q_is_float 0) or fp32 (q_is_float 1) carrier in every
// bucket; world: the ranks the payloads were summed over; the rest as in
// fused_update_buckets. Returns a cudaError_t code.
extern "C" int fused_dequant_update_buckets(
    const void* table, int nb, int64_t total_chunks, const void* lr,
    int q_is_float, float world, int kind, float h0, float h1, float om0,
    float om1, float eps, int nesterov, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  if (table == nullptr || lr == nullptr || total_chunks < 0 || world <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{0.0f, 0, h0, h1, om0, om1, eps, nesterov};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const Bucket*>(table);
  const auto* l = static_cast<const float*>(lr);
  const unsigned int grid = grid_for(nb, total_chunks);
  return with_kind(kind, [&](auto k) {
    constexpr int K = decltype(k)::value;
    if (q_is_float)
      dequant_kernel<K, float><<<grid, kThreads, 0, st>>>(t, nb, total_chunks,
                                                          l, world, h);
    else
      dequant_kernel<K, int32_t><<<grid, kThreads, 0, st>>>(
          t, nb, total_chunks, l, world, h);
  });
}
