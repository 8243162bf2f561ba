// Fused optimizer updates over flat parameter buckets, for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused_update.py:
//   fused_update_buckets <- _plain_kernel (fused_update.py:122, launched by
//                           fused_update_flat :223, once per bucket by
//                           paddle_tpu/optimizer/fused.py:189-214)
//   fused_dequant_update <- _dequant_kernel (fused_update.py:134, launched
//                           by fused_dequant_update_flat :283)
// Plain PyTorch versions and wrappers: paddle_tpu_torch/ops/fused_update.py
// (buckets_plain / fused_update_buckets, reference_dequant_update_flat /
// fused_dequant_update).
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
// fp32. So the bf16 update is bit-identical to its plain version too.
// Buckets of both dtypes ride in one launch: the table's dtype word
// picks the thread's chunk width.
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
// fused_dequant_update takes, instead of the gradient, the gradient wire's
// payload summed over `world` ranks: int8 values in an int32 carrier or
// fp8 values in an fp32 carrier, with one fp32 scale per block_size
// elements, and an optional fp32 residual. Each element's gradient is
// block_decode's chain, q * scale[i / block_size] (__fmul_rn), then
// / world (__fdiv_rn, a true division: the plain version divides by a
// device tensor), then + residual; the update follows in registers. The
// decoded gradient never reaches device memory. It runs once per bucket.
//
// What bounds them: device-memory bytes. AdamW reads p, g (or the 4-byte
// carrier), m1, m2 and writes p, m1, m2: 28 bytes per element for ~20
// operations (32 with a residual, plus the scale vector). All of GPT-125M
// (124.5 M parameters) moves 3.49 GB per step, 1.04 ms at 3.35 TB/s; the
// int32 carrier is as wide as the fp32 gradient, so the two kernels share
// the bound. A bf16 bucket moves 22 bytes an element (p 2 + 2, g 2,
// moments 8 + 8): GPT-125M in bf16, 2.74 GB, 0.82 ms (times on the card:
// PERF.md).
//
// Design: one thread per chunk of consecutive elements, 4 in an fp32
// bucket and 8 in a bf16 one, so the parameters and the gradient are one
// 16-byte vector a thread either way (the moments two in a bf16 bucket);
// the wrappers check 16-byte alignment. A bucket's ragged tail (n % 4 or
// n % 8) is a scalar loop in its last thread. The update kernel's grid
// covers the chunks of every bucket, one after the other; a thread finds
// its chunk's bucket by a binary search over the table's first chunks.
// Nothing is staged in shared memory: each element is touched once. The
// dequantizing kernel reads one scale for the thread's 4 elements when
// they share a block, else one per element, so every block_size is
// taken.

#include <cuda_bf16.h>
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

// One bucket of a fused_update_buckets launch. ops/fused_update.py
// (BucketTable) packs the same 80-byte layout as ten 8-byte words.
struct Bucket {
  void* p;                // fp32 or bf16 (dtype)
  const void* g;          // the parameters' dtype
  float* s0;              // velocity or moment1 (null for sgd)
  float* s1;              // moment2 (null unless adam / adamw)
  const float* pow_in;    // adam: [beta1^t, beta2^t]
  float* pow_out;         // adam: [beta1^(t+1), beta2^(t+1)], written
  int64_t n;
  int64_t start;          // the bucket's first chunk in the launch
  float wd;
  float lm;               // lr_mult
  int64_t dtype;          // 0: fp32 p and g, 4 elements a chunk; 1: bf16, 8
};
static_assert(sizeof(Bucket) == 80, "BucketTable packs 10 words a bucket");

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

// Update elements [i, i + kChunk) of bucket e (or its tail up to n): p
// and g as one 16-byte vector, each moment as kChunk / 4 float4s.
template <int KIND, typename P>
__device__ __forceinline__ void update_chunk(const Bucket& e, int64_t i,
                                             const Hyper& h, float lr,
                                             float c1, float c2) {
  constexpr bool kSlot0 = KIND != kSgd;
  constexpr bool kSlot1 = KIND == kAdam || KIND == kAdamW;
  constexpr int C = Elem<P>::kChunk;
  P* __restrict__ p = static_cast<P*>(e.p);
  const P* __restrict__ g = static_cast<const P*>(e.g);
  float* __restrict__ s0 = e.s0;
  float* __restrict__ s1 = e.s1;
  if (i + C <= e.n) {
    uint4 pv = *reinterpret_cast<const uint4*>(p + i);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + i);
    P* px = reinterpret_cast<P*>(&pv);
    const P* gx = reinterpret_cast<const P*>(&gv);
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
      update_one<KIND>(pj, Elem<P>::load(gx[q]), a[q], b[q], h, lr, c1, c2);
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
      update_one<KIND>(pj, Elem<P>::load(g[j]), a, b, h, lr, c1, c2);
      p[j] = Elem<P>::store(pj);
      if (kSlot0) s0[j] = a;
      if (kSlot1) s1[j] = b;
    }
  }
}

// One thread per chunk c of the launch's `total`, in bucket order;
// thread b < nb also steps bucket b's beta powers (adam).
template <int KIND>
__global__ void __launch_bounds__(kThreads)
update_kernel(const Bucket* __restrict__ table, int nb, int64_t total,
              const float* __restrict__ lr_dev, Hyper h) {
  constexpr bool kSlot0 = KIND != kSgd;
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
  if (e.dtype)
    update_chunk<KIND, __nv_bfloat16>(e, (c - e.start) * 8, h, lr, c1, c2);
  else
    update_chunk<KIND, float>(e, (c - e.start) * 4, h, lr, c1, c2);
}

template <typename Q>
__device__ __forceinline__ float carrier_value(Q q) {
  return static_cast<float>(q);   // exact: |q| <= 127 * world, or fp8
}

// the decoded, averaged gradient of one element (block_decode's chain)
template <typename Q>
__device__ __forceinline__ float dequant_one(Q q, float scale, float world,
                                             const float* res, int64_t j) {
  float g = __fdiv_rn(__fmul_rn(carrier_value(q), scale), world);
  if (res != nullptr) g = __fadd_rn(g, res[j]);
  return g;
}

template <typename Q> struct Vec4;
template <> struct Vec4<int32_t> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

template <int KIND, typename Q>
__global__ void __launch_bounds__(kThreads)
dequant_update_kernel(float* __restrict__ p, const Q* __restrict__ q,
                      const float* __restrict__ scales,
                      const float* __restrict__ res, float* __restrict__ s0,
                      float* __restrict__ s1, const float* __restrict__ svec,
                      int64_t n, int64_t bs, float world, Hyper h) {
  constexpr bool kSlot0 = KIND != kSgd;
  constexpr bool kSlot1 = KIND == kAdam || KIND == kAdamW;
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const float lr = svec[0];
  const float c1 = kSlot1 ? svec[1] : 1.0f;
  const float c2 = kSlot1 ? svec[2] : 1.0f;
  if (i + 4 <= n) {
    const int64_t blk = i / bs;
    float sc[4];
    if ((i + 3) / bs == blk) {
      sc[0] = sc[1] = sc[2] = sc[3] = __ldg(scales + blk);
    } else {
      for (int k = 0; k < 4; ++k) sc[k] = __ldg(scales + (i + k) / bs);
    }
    const typename Vec4<Q>::type qv =
        *reinterpret_cast<const typename Vec4<Q>::type*>(q + i);
    float4 pv = *reinterpret_cast<const float4*>(p + i);
    float4 a = kSlot0 ? *reinterpret_cast<const float4*>(s0 + i)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 b = kSlot1 ? *reinterpret_cast<const float4*>(s1 + i)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    update_one<KIND>(pv.x, dequant_one(qv.x, sc[0], world, res, i), a.x, b.x,
                     h, lr, c1, c2);
    update_one<KIND>(pv.y, dequant_one(qv.y, sc[1], world, res, i + 1), a.y,
                     b.y, h, lr, c1, c2);
    update_one<KIND>(pv.z, dequant_one(qv.z, sc[2], world, res, i + 2), a.z,
                     b.z, h, lr, c1, c2);
    update_one<KIND>(pv.w, dequant_one(qv.w, sc[3], world, res, i + 3), a.w,
                     b.w, h, lr, c1, c2);
    *reinterpret_cast<float4*>(p + i) = pv;
    if (kSlot0) *reinterpret_cast<float4*>(s0 + i) = a;
    if (kSlot1) *reinterpret_cast<float4*>(s1 + i) = b;
  } else {
    for (int64_t j = i; j < n; ++j) {
      float a = kSlot0 ? s0[j] : 0.f, b = kSlot1 ? s1[j] : 0.f;
      float pj = p[j];
      update_one<KIND>(pj, dequant_one(q[j], __ldg(scales + j / bs), world,
                                       res, j),
                       a, b, h, lr, c1, c2);
      p[j] = pj;
      if (kSlot0) s0[j] = a;
      if (kSlot1) s1[j] = b;
    }
  }
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

inline unsigned int grid_for(int64_t n) {
  return static_cast<unsigned int>(((n + 3) / 4 + kThreads - 1) / kThreads);
}

}  // namespace

// One update of every bucket in `table` (device memory, nb Bucket
// entries whose chunks, 4 elements in an fp32 bucket and 8 in a bf16
// one, start at 0 and run back to back, total_chunks in all), in place.
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
  // a thread per chunk, and at least one per bucket for its powers
  const int64_t threads = total_chunks > nb ? total_chunks : nb;
  const auto grid =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  return with_kind(kind, [&](auto k) {
    update_kernel<decltype(k)::value><<<grid, kThreads, 0, st>>>(
        static_cast<const Bucket*>(table), nb, total_chunks,
        static_cast<const float*>(lr), h);
  });
}

// One bucket's update (fused_update_buckets' math, its scalars prepared
// by the caller) with the gradient decoded from the summed wire payload:
// p, s0, s1 fp32 [n] (unused slots may be null); svec: fp32 [1] (sgd,
// momentum) or [3] (adam, adamw) on the device, [lr * lr_mult,
// 1 - beta1^t, 1 - beta2^t]; wd, h0, h1, om0, om1, eps, nesterov as in
// fused_update_buckets; q: [>= n] int32 (q_is_float 0) or fp32
// (q_is_float 1) carrier; scales: fp32 [ceil(n / bs)], element i's scale
// at i / bs; residual: fp32 [n] or null; world: the ranks the payload was
// summed over. Returns a cudaError_t code.
extern "C" int fused_dequant_update(void* p, const void* q, int q_is_float,
                                    const void* scales, const void* residual,
                                    void* s0, void* s1, const void* svec,
                                    int64_t n, int64_t bs, float world,
                                    int kind, float wd, float h0, float h1,
                                    float om0, float om1, float eps,
                                    int nesterov, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (bs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{wd, wd != 0.0f, h0, h1, om0, om1, eps, nesterov};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(p);
  auto* sp = static_cast<const float*>(scales);
  auto* rp = static_cast<const float*>(residual);
  auto* ap = static_cast<float*>(s0);
  auto* bp = static_cast<float*>(s1);
  auto* sv = static_cast<const float*>(svec);
  return with_kind(kind, [&](auto k) {
    constexpr int K = decltype(k)::value;
    if (q_is_float)
      dequant_update_kernel<K, float><<<grid_for(n), kThreads, 0, st>>>(
          pp, static_cast<const float*>(q), sp, rp, ap, bp, sv, n, bs, world,
          h);
    else
      dequant_update_kernel<K, int32_t><<<grid_for(n), kThreads, 0, st>>>(
          pp, static_cast<const int32_t*>(q), sp, rp, ap, bp, sv, n, bs,
          world, h);
  });
}
