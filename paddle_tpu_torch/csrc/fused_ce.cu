// Chunk epilogues of the fused (chunked) linear + cross-entropy loss, for
// Hopper (sm_90a).
//
// Replace the elementwise stages of the scan bodies of
// paddle_tpu/incubate/nn/functional.py fused_linear_cross_entropy, which
// the reference computes in jnp (no Pallas kernel there):
//   ce_chunk_fwd <- _fwd_state's step (functional.py:231-249): merge one
//                   [N, C] chunk of logits into the online logsumexp and
//                   pick the label's logit;
//   ce_chunk_bwd <- _core_bwd's step (functional.py:266-279): the chunk's
//                   dlogit = (softmax - onehot) * g.
// Plain PyTorch versions and wrappers: paddle_tpu_torch/ops/fused_ce.py.
// The chunk GEMMs around them stay cuBLAS (torch.matmul), as the
// reference leaves them to XLA outside any kernel.
//
// What they compute, for row r of the fp32 chunk logit[N, C] (row-major,
// contiguous), x = logit[r, j] + bias[j] (no bias: + 0 is skipped),
// columns start .. start + C - 1 of the vocabulary:
//   forward: m_new = max(m[r], max_j x);
//            s[r]  = s[r] * exp(m[r] - m_new) + sum_j exp(x - m_new);
//            m[r]  = m_new;
//            picked[r] = x at j = label[r] - start when the label falls
//            in the chunk, else unchanged.
//   backward, in place: logit[r, j] = (exp(x - lse[r]) - (label[r] ==
//            start + j)) * g[r].
// The ops and their order are the reference's; the row sums are taken in
// another order (a tree over the block), so the forward agrees with the
// plain version to fp32 rounding, not bit for bit. The backward is
// elementwise: the same ops on each element. No --use_fast_math: expf
// is the accurate one (2 ulp). The port's last chunk is ragged (C
// columns up to V) where the reference pads to the chunk grid with -inf
// columns; exp(-inf) adds 0, so the sums are the same.
//
// What bounds them: device-memory bytes. At GPT-125M's bench step (N =
// 8 x 1024 tokens, chunk 8192 of V = 50,304: six full chunks and one of
// 1,152 columns), a full chunk is 268 MB of fp32; the forward reads it
// once (0.080 ms at 3.35 TB/s), the backward reads and writes it once
// (0.160 ms), with a few operations an element (one exp), far under the
// card's ~20 fp32 operations a byte.
//
// Design, for the bytes:
//  - Forward: one block a row. Each thread loads its quads (4 columns,
//    one 16-byte streaming access when the row allows it) into
//    registers: KQ quads a thread, interleaved across the block, so a
//    warp's access is one contiguous run. The row's max is a block
//    reduction over the registers, the exp-sum a second one over the
//    same registers, so the chunk is read once. A chunk wider than a
//    block's registers (8192 columns: 256 threads of 8 quads) is taken
//    in segments merged online the same way (the bench's chunk is one
//    segment).
//  - The label's logit is one extra 4-byte read by one thread.
//  - The forward's vector accesses need C % 4 == 0 and a 16-byte aligned
//    logit (torch.empty gives that); otherwise every quad is read element
//    by element: right, and slower (65% of its bound at BERT's last
//    chunk of 5946 columns, PERF.md).
//  - Backward: one block a row, each row on its own alignment: the body
//    in aligned quads (one streaming read and one streaming store each,
//    two quads in flight a thread), then a scalar head of up to 3
//    columns to the row's first 16-byte boundary and a scalar tail of up
//    to 3, taken by the last threads (the fewest quads), after the body
//    so that their dependent round trips do not delay a warp's quads.
//    So a chunk whose width is not a multiple of 4 (BERT's 5946 of
//    30,522 at chunk 8192: every odd row starts 8 bytes off the grid)
//    takes the 16-byte path for all but 6 columns a row. The bias ([C], the same
//    for every row) is read element by element at whatever alignment it
//    has against the body: 23.8 KB at 5946 columns, from L1 and L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kBwdThreads = 256;

// the most threads of a forward block holding KQ quads each: 256 x 8
// quads = 8192 columns a segment (64 registers of data a thread), 512 x 2
// below 4096 columns
constexpr int fwd_threads(int kq) { return kq >= 8 ? 256 : 512; }

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// the block's max (MAX) or sum of v, in every thread; `red` holds 32
// floats, free on entry and on exit
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nwarps ? red[lane] : (MAX ? -INFINITY : 0.0f);
  r = MAX ? warp_max(r) : warp_sum(r);
  __syncthreads();
  return r;
}

// four columns j0 .. j0 + 3 of a row (x + bias), those at or past `c`
// reading as -inf; one streaming access when VEC and all four exist
template <bool VEC>
__device__ __forceinline__ float4 load_cols(const float* row,
                                            const float* bias, int64_t j0,
                                            int64_t c) {
  float4 v;
  if (VEC && j0 + 4 <= c) {
    v = __ldcs(reinterpret_cast<const float4*>(row + j0));
  } else {
    v.x = j0 < c ? row[j0] : -INFINITY;
    v.y = j0 + 1 < c ? row[j0 + 1] : -INFINITY;
    v.z = j0 + 2 < c ? row[j0 + 2] : -INFINITY;
    v.w = j0 + 3 < c ? row[j0 + 3] : -INFINITY;
  }
  if (bias != nullptr) {
    v.x += j0 < c ? bias[j0] : 0.0f;
    v.y += j0 + 1 < c ? bias[j0 + 1] : 0.0f;
    v.z += j0 + 2 < c ? bias[j0 + 2] : 0.0f;
    v.w += j0 + 3 < c ? bias[j0 + 3] : 0.0f;
  }
  return v;
}

__device__ __forceinline__ float exp_or_zero(float x, float m, bool valid) {
  return valid ? expf(x - m) : 0.0f;
}

template <int KQ, bool VEC>
__global__ void __launch_bounds__(KQ >= 8 ? 256 : 512)
    ce_fwd_kernel(const float* __restrict__ logit,
                  const float* __restrict__ bias,
                  const int32_t* __restrict__ labels, int64_t c,
                  int64_t start, float* __restrict__ m,
                  float* __restrict__ s, float* __restrict__ picked) {
  __shared__ float red[32];
  const int64_t r = blockIdx.x;
  const float* row = logit + r * c;
  const int64_t span = static_cast<int64_t>(KQ) * 4 * blockDim.x;
  float m_run = m[r], s_run = s[r];
  for (int64_t seg = 0; seg < c; seg += span) {
    float4 v[KQ];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
      const int64_t j0 = seg + 4 * (threadIdx.x + int64_t(k) * blockDim.x);
      v[k] = load_cols<VEC>(row, bias, j0, c);
      mx = fmaxf(mx, fmaxf(fmaxf(v[k].x, v[k].y), fmaxf(v[k].z, v[k].w)));
    }
    const float m_new = fmaxf(m_run, block_reduce<true>(mx, red));
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
      const int64_t j0 = seg + 4 * (threadIdx.x + int64_t(k) * blockDim.x);
      acc += exp_or_zero(v[k].x, m_new, j0 < c);
      acc += exp_or_zero(v[k].y, m_new, j0 + 1 < c);
      acc += exp_or_zero(v[k].z, m_new, j0 + 2 < c);
      acc += exp_or_zero(v[k].w, m_new, j0 + 3 < c);
    }
    const float sum = block_reduce<false>(acc, red);
    s_run = s_run * expf(m_run - m_new) + sum;
    m_run = m_new;
  }
  if (threadIdx.x == 0) {
    m[r] = m_run;
    s[r] = s_run;
    const int64_t j = static_cast<int64_t>(labels[r]) - start;
    if (j >= 0 && j < c)
      picked[r] = row[j] + (bias != nullptr ? bias[j] : 0.0f);
  }
}

// x of one column j (+ bias), then its dlogit, in place: the ops of the
// header's backward, the same for every access path
__device__ __forceinline__ float bwd_one(float x, const float* bias,
                                         int64_t j, int64_t hot, float l,
                                         float gr) {
  if (bias != nullptr) x += __ldg(bias + j);
  return (expf(x - l) - (j == hot ? 1.0f : 0.0f)) * gr;
}

// One block a row, the row taken on its own alignment: an aligned float4
// body (streaming loads and stores, two quads in flight a thread), then
// a scalar head up to the row's first 16-byte boundary and a scalar tail,
// taken by the block's last threads, which have the fewest quads.
__global__ void __launch_bounds__(kBwdThreads)
    ce_bwd_kernel(float* __restrict__ logit, const float* __restrict__ bias,
                  const float* __restrict__ lse,
                  const int32_t* __restrict__ labels,
                  const float* __restrict__ g, int64_t c, int64_t start) {
  const int64_t r = blockIdx.x;
  float* row = logit + r * c;
  const float l = lse[r], gr = g[r];
  const int64_t hot = static_cast<int64_t>(labels[r]) - start;
  const int64_t lead =
      ((16 - reinterpret_cast<uintptr_t>(row) % 16) % 16) / 4;
  const int64_t head = lead < c ? lead : c;
  const int64_t quads = (c - head) / 4;
  float4* body = reinterpret_cast<float4*>(row + head);
  auto quad = [&](float4 v, int64_t i) {
    const int64_t j0 = head + 4 * i;
    v.x = bwd_one(v.x, bias, j0, hot, l, gr);
    v.y = bwd_one(v.y, bias, j0 + 1, hot, l, gr);
    v.z = bwd_one(v.z, bias, j0 + 2, hot, l, gr);
    v.w = bwd_one(v.w, bias, j0 + 3, hot, l, gr);
    __stcs(body + i, v);
  };
  int64_t i = threadIdx.x;
  for (; i + blockDim.x < quads; i += 2 * blockDim.x) {
    const float4 v0 = __ldcs(body + i), v1 = __ldcs(body + i + blockDim.x);
    quad(v0, i);
    quad(v1, i + blockDim.x);
  }
  if (i < quads) quad(__ldcs(body + i), i);
  const int64_t j = blockDim.x - 1 - threadIdx.x;   // 0 for the last
  const int64_t tail = head + 4 * quads;
  if (j < head) row[j] = bwd_one(row[j], bias, j, hot, l, gr);
  if (tail + j < c)
    row[tail + j] = bwd_one(row[tail + j], bias, tail + j, hot, l, gr);
}

bool vec_ok(const void* p, int64_t c) {
  return c % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int round_up_warp(int64_t t) { return static_cast<int>((t + 31) / 32 * 32); }

template <int KQ>
void launch_fwd(const float* logit, const float* bias, const int32_t* labels,
                int64_t n, int64_t c, int64_t start, float* m, float* s,
                float* picked, cudaStream_t st) {
  const int64_t quads = (c + 3) / 4;
  const int threads = static_cast<int>(std::min<int64_t>(
      fwd_threads(KQ), round_up_warp((quads + KQ - 1) / KQ)));
  if (vec_ok(logit, c))
    ce_fwd_kernel<KQ, true><<<n, threads, 0, st>>>(logit, bias, labels, c,
                                                   start, m, s, picked);
  else
    ce_fwd_kernel<KQ, false><<<n, threads, 0, st>>>(logit, bias, labels, c,
                                                    start, m, s, picked);
}

}  // namespace

// logit: fp32 [n, c] contiguous; bias: fp32 [c] or null; labels: int32
// [n]; m, s, picked: fp32 [n], updated in place (see the header).
// Returns cudaGetLastError().
extern "C" int ce_chunk_fwd(const void* logit, const void* bias,
                            const void* labels, int64_t n, int64_t c,
                            int64_t start, void* m, void* s, void* picked,
                            void* stream) {
  if (n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (n < 0 || c < 0 || n > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(logit);
  const auto* b = static_cast<const float*>(bias);
  const auto* lb = static_cast<const int32_t*>(labels);
  auto* mm = static_cast<float*>(m);
  auto* ss = static_cast<float*>(s);
  auto* pk = static_cast<float*>(picked);
  // 8 quads a thread from 4096 columns on (256 threads at the bench's
  // 8192), 2 below (160 threads at its last chunk of 1152)
  if (c >= 4096)
    launch_fwd<8>(x, b, lb, n, c, start, mm, ss, pk, st);
  else
    launch_fwd<2>(x, b, lb, n, c, start, mm, ss, pk, st);
  return static_cast<int>(cudaGetLastError());
}

// logit: fp32 [n, c] contiguous, overwritten by dlogit; bias: fp32 [c] or
// null; lse, g: fp32 [n]; labels: int32 [n]. Returns cudaGetLastError().
extern "C" int ce_chunk_bwd(void* logit, const void* bias, const void* lse,
                            const void* labels, const void* g, int64_t n,
                            int64_t c, int64_t start, void* stream) {
  if (n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (n < 0 || c < 0 || n > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<float*>(logit);
  const auto* b = static_cast<const float*>(bias);
  const auto* l = static_cast<const float*>(lse);
  const auto* lb = static_cast<const int32_t*>(labels);
  const auto* gg = static_cast<const float*>(g);
  ce_bwd_kernel<<<n, kBwdThreads, 0, st>>>(x, b, l, lb, gg, c, start);
  return static_cast<int>(cudaGetLastError());
}
