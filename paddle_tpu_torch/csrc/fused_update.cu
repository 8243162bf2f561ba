// Fused optimizer update over a flat parameter bucket, for Hopper (sm_90a).
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/fused_update.py:
//   fused_update <- _plain_kernel (fused_update.py:122, launched by
//                   fused_update_flat :223)
// Plain PyTorch version and wrapper: paddle_tpu_torch/ops/fused_update.py
// (reference_update_flat, fused_update).
//
// What it computes: one SGD / Momentum / Adam / AdamW step over n fp32
// elements, in place: p (and the slots) are read, updated and written
// back. The arithmetic is _update_math (fused_update.py:92-119) op for
// op, each op rounded once: __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn keep nvcc from contracting a*b+c into an FMA,
// so the result is bit-identical to the plain PyTorch version, whose
// kernels round every op. The scalars lr*lr_mult, 1-beta1^t and
// 1-beta2^t (svec, _scalar_prep :181-191) are read from device memory,
// so the host never waits for the card between steps. Hyperparameters
// arrive as fp32 values the host rounded from Python floats, as PyTorch
// rounds a Python scalar operand.
//
// What bounds it: device-memory bytes. AdamW reads p, g, m1, m2 and
// writes p, m1, m2: 28 bytes per element for ~20 operations. All of
// GPT-125M (124.5 M parameters) moves 3.49 GB per step, 1.04 ms at
// 3.35 TB/s.
//
// Design: one thread per 4 consecutive elements, each array read and
// written as one 16-byte vector per thread (the wrapper checks 16-byte
// alignment); the ragged tail (n % 4) is a scalar loop in the last
// thread. Nothing is staged in shared memory: each element is touched
// once.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <int KIND>
__global__ void __launch_bounds__(kThreads)
update_kernel(float* __restrict__ p, const float* __restrict__ g,
              float* __restrict__ s0, float* __restrict__ s1,
              const float* __restrict__ svec, int64_t n, Hyper h) {
  constexpr bool kSlot0 = KIND != kSgd;
  constexpr bool kSlot1 = KIND == kAdam || KIND == kAdamW;
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const float lr = svec[0];
  const float c1 = kSlot1 ? svec[1] : 1.0f;
  const float c2 = kSlot1 ? svec[2] : 1.0f;
  if (i + 4 <= n) {
    float4 pv = *reinterpret_cast<const float4*>(p + i);
    const float4 gv = *reinterpret_cast<const float4*>(g + i);
    float4 a = kSlot0 ? *reinterpret_cast<const float4*>(s0 + i)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 b = kSlot1 ? *reinterpret_cast<const float4*>(s1 + i)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    update_one<KIND>(pv.x, gv.x, a.x, b.x, h, lr, c1, c2);
    update_one<KIND>(pv.y, gv.y, a.y, b.y, h, lr, c1, c2);
    update_one<KIND>(pv.z, gv.z, a.z, b.z, h, lr, c1, c2);
    update_one<KIND>(pv.w, gv.w, a.w, b.w, h, lr, c1, c2);
    *reinterpret_cast<float4*>(p + i) = pv;
    if (kSlot0) *reinterpret_cast<float4*>(s0 + i) = a;
    if (kSlot1) *reinterpret_cast<float4*>(s1 + i) = b;
  } else {
    for (int64_t j = i; j < n; ++j) {
      float a = kSlot0 ? s0[j] : 0.f, b = kSlot1 ? s1[j] : 0.f;
      float pj = p[j];
      update_one<KIND>(pj, g[j], a, b, h, lr, c1, c2);
      p[j] = pj;
      if (kSlot0) s0[j] = a;
      if (kSlot1) s1[j] = b;
    }
  }
}

}  // namespace

// p, g, s0, s1: fp32 [n] (s0: velocity or moment1, s1: moment2; unused
// slots may be null); svec: fp32 [1] (sgd, momentum) or [3] (adam, adamw)
// on the device. kind: 0 sgd, 1 momentum, 2 adam, 3 adamw. Updates p and
// the slots in place. Returns a cudaError_t code.
extern "C" int fused_update(void* p, const void* g, void* s0, void* s1,
                            const void* svec, int64_t n, int kind, float wd,
                            float h0, float h1, float om0, float om1,
                            float eps, int nesterov, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Hyper h{wd, wd != 0.0f, h0, h1, om0, om1, eps, nesterov};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int grid =
      static_cast<unsigned int>(((n + 3) / 4 + kThreads - 1) / kThreads);
  auto* pp = static_cast<float*>(p);
  auto* gp = static_cast<const float*>(g);
  auto* ap = static_cast<float*>(s0);
  auto* bp = static_cast<float*>(s1);
  auto* sv = static_cast<const float*>(svec);
  switch (kind) {
    case kSgd:
      update_kernel<kSgd><<<grid, kThreads, 0, st>>>(pp, gp, ap, bp, sv, n, h);
      break;
    case kMomentum:
      update_kernel<kMomentum><<<grid, kThreads, 0, st>>>(pp, gp, ap, bp, sv,
                                                         n, h);
      break;
    case kAdam:
      update_kernel<kAdam><<<grid, kThreads, 0, st>>>(pp, gp, ap, bp, sv, n,
                                                     h);
      break;
    case kAdamW:
      update_kernel<kAdamW><<<grid, kThreads, 0, st>>>(pp, gp, ap, bp, sv, n,
                                                      h);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
