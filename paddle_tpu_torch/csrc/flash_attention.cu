// Flash attention forward and backward kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/flash_attention.py:
//   flash_fwd <- _fwd_kernel (flash_attention.py:118, launched by _fwd :177)
//   flash_dq  <- _dq_kernel  (flash_attention.py:213, launched by _bwd :307)
//   flash_dkv <- _dkv_kernel (flash_attention.py:251, launched by _bwd :325)
// Plain PyTorch versions and wrappers: paddle_tpu_torch/ops/flash_attention.py
// (flash_fwd_plain, flash_dq_plain, flash_dkv_plain).
//
// What they compute, per (batch, head) over contiguous fp32 [s, d] tiles of
// a [b, n, s, d] layout, with the reference's numerics:
//   q is pre-scaled by 1/sqrt(d) before q.k^T; masked scores (the causal
//   upper triangle, and here also keys past the sequence end) are -1e30,
//   not -inf; tiles wholly above the diagonal are skipped;
//   forward: online softmax, l clamped at 1e-30, out = acc / l,
//            lse = m + log(l)                                  (:154-158)
//   dq:  p = exp(s - lse), ds = p * (dO.V^T - delta), dq = (ds.K) * scale
//   dkv: dv = p^T.dO, dk = ds^T.(q * scale) (dk carries the scale, :285)
// delta = rowsum(dO * O) is computed outside, as the reference does (:298).
//
// What bounds them: operations. At the training slice's shape (b8 n12 s1024
// d64, causal) the forward does 2 causal products (12.9 GFLOP), dq 3
// (19.3 GFLOP) and dkv 4 (25.8 GFLOP) against ~25-50 MB of inputs and
// outputs each. flash_fwd runs both products in 3xTF32 on the tensor cores
// (3 x 12.9 GFLOP at 495 TFLOP/s: 0.078 ms); dq and dkv run fp32 FMAs on
// the SIMT cores (0.29 / 0.38 ms at 67 TFLOP/s). All are far above their
// 0.01-0.02 ms byte bounds.
//
// flash_fwd design: one block of 4 warps per (batch*head, 64 query rows);
// each warp owns 16 query rows, so a row's max and sum stay inside the
// warp (two shuffles across the 4 lanes of a quad). Both products run on
// mma.sync m16n8k8 tf32 with fp32 accumulators in registers, each fp32
// operand split as big + small (cvt.rna; see split_tf32) and multiplied as
// small.big + big.small + big.big, the arithmetic of the fp32 SDPA
// yardstick (CUTLASS's fast-fp32 mode). The scaled Q tile is split once
// per block: into registers at d <= 64, into shared memory above (where
// registers would spill). K and V tiles of 64 keys are double-buffered in
// shared memory by cp.async, so the next tile's load overlaps this tile's
// products; they are split as their fragments are read. P goes to the
// second product through registers: mma slot t of a key chunk c reads key
// 8c + 2t and slot t + 4 key 8c + 2t + 1, which puts the score
// accumulator's (c0, c1, c2, c3) exactly where the next product's A
// fragment (a0, a2, a1, a3) wants them. Row pitches of d + 8 floats (K, Q)
// and d + 4 (V) make the fragment loads free of bank conflicts.
//
// dq, dkv design (simple and right first; tensor cores are later work):
// one block of 256 threads per (batch*head, 64-row tile). The
// block's own tile and the streamed tiles live in shared memory with a
// row pitch of d + 1 floats, so both row-wise and column-wise reads are
// free of bank conflicts. The 256 threads form a 16 x 16 grid: thread
// (ty, tx) owns rows ty*4 .. ty*4+3 and columns tx + 16*j, keeps its
// accumulators in registers and does fp32 FMAs on the SIMT cores. The
// sequential grid axis of the TPU kernels becomes a loop inside the
// block: the forward and dq loop over key tiles for a fixed query tile,
// dkv loops over query tiles for a fixed key tile, so every output element
// has one owner and no atomics are needed.
// Any s >= 1 works: rows past the end are zero-filled on load, masked in
// the scores and never stored. d is a template parameter, 16..128 in
// steps of 16.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kTile = 64;        // rows per tile, queries and keys alike
constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr int kRows = 4;         // rows per thread (kTile / 16)
constexpr int kPitchP = kTile + 1;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF (:31)

// Copy rows [row0, row0 + kTile) of a [s, D] matrix into shared memory at
// pitch D + 1, multiplied by `mul`, zero past row s.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int s, float mul) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * LD + c] =
        row < s ? __fmul_rn(src[static_cast<size_t>(row) * D + c], mul)
                : 0.0f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int s) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = row0 + r;
    dst[r] = row < s ? src[row] : 0.0f;
  }
}

// d += a * b in 3xTF32: small.big + big.small + big.big.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ab,
                                           const uint32_t* as, uint32_t bb0,
                                           uint32_t bb1, uint32_t bs0,
                                           uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// Sums and maxima over the 4 lanes of a quad (one mma row's owners).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------- forward
constexpr int kFwdThreads = 128;   // 4 warps x 16 query rows

template <int D>
struct FwdTiles {
  static constexpr int PK = D + 8;            // K and Q row pitch (floats)
  static constexpr int PV = D + 4;            // V row pitch
  static constexpr bool QREG = D <= 64;       // split Q kept in registers
  static constexpr int kStage = kTile * (PK + PV);
  static constexpr int kQ = QREG ? 0 : 2 * kTile * PK;   // Q big, small
  static constexpr size_t bytes = sizeof(float) * (2 * kStage + kQ);
};

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out,
           float* __restrict__ lse, int s, int causal, float scale) {
  using T = FwdTiles<D>;
  constexpr int PK = T::PK, PV = T::PV, C = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qb = smem + 2 * T::kStage;           // !QREG: split Q, big
  float* Qs = Qb + kTile * PK;                //        and small

  // heaviest causal tiles (the last query rows) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;               // tile rows r0 and r0 + 8

  const int n_kt = (s + kTile - 1) / kTile;
  const int kt_end = causal ? min(n_kt, q0 / kTile + 1) : n_kt;

  auto load_kv = [&](int kt) {
    float* Ks = smem + (kt & 1) * T::kStage;
    float* Vs = Ks + kTile * PK;
    const int k0 = kt * kTile;
    for (int e = threadIdx.x; e < kTile * D / 4; e += kFwdThreads) {
      const int r = e / (D / 4), c = (e % (D / 4)) * 4;
      const bool ok = k0 + r < s;
      const size_t off = ok ? base + static_cast<size_t>(k0 + r) * D + c : 0;
      cp_async16(Ks + r * PK + c, k + off, ok);
      cp_async16(Vs + r * PV + c, v + off, ok);
    }
  };
  load_kv(0);
  cp_async_commit();

  // Q fragments, pre-scaled and split once: slot t of d-chunk c is
  // column 8c + 2t, slot t + 4 column 8c + 2t + 1.
  uint32_t qb[T::QREG ? C : 1][4], qs[T::QREG ? C : 1][4];
  if constexpr (T::QREG) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + r0 + 8 * h;
        float2 x = make_float2(0.0f, 0.0f);
        if (row < s)
          x = *reinterpret_cast<const float2*>(
              q + base + static_cast<size_t>(row) * D + 8 * c + 2 * t);
        split_tf32(__fmul_rn(x.x, scale), qb[c][h], qs[c][h]);
        split_tf32(__fmul_rn(x.y, scale), qb[c][2 + h], qs[c][2 + h]);
      }
  } else {
    for (int e = threadIdx.x; e < kTile * D / 2; e += kFwdThreads) {
      const int r = e / (D / 2), c = (e % (D / 2)) * 2;
      float2 x = make_float2(0.0f, 0.0f);
      if (q0 + r < s)
        x = *reinterpret_cast<const float2*>(
            q + base + static_cast<size_t>(q0 + r) * D + c);
      uint32_t b0, s0, b1, s1;
      split_tf32(__fmul_rn(x.x, scale), b0, s0);
      split_tf32(__fmul_rn(x.y, scale), b1, s1);
      *reinterpret_cast<float2*>(Qb + r * PK + c) =
          make_float2(__uint_as_float(b0), __uint_as_float(b1));
      *reinterpret_cast<float2*>(Qs + r * PK + c) =
          make_float2(__uint_as_float(s0), __uint_as_float(s1));
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[C][4];
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int kt = 0; kt < kt_end; ++kt) {
    if (kt + 1 < kt_end) load_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile kt (and the split Q) visible to every warp
    const float* Ks = smem + (kt & 1) * T::kStage;
    const float* Vs = Ks + kTile * PK;
    const int k0 = kt * kTile;

    // scores: 16 rows x 64 keys a warp; n-tile j is keys 8j .. 8j + 7
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      uint32_t ab[4], as[4];
      if constexpr (T::QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ab[i] = qb[c][i];
          as[i] = qs[c][i];
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = (r0 + 8 * h) * PK + 8 * c + 2 * t;
          const float2 xb = *reinterpret_cast<const float2*>(Qb + o);
          const float2 xs = *reinterpret_cast<const float2*>(Qs + o);
          ab[h] = __float_as_uint(xb.x);
          ab[2 + h] = __float_as_uint(xb.y);
          as[h] = __float_as_uint(xs.x);
          as[2 + h] = __float_as_uint(xs.y);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(
            Ks + (8 * j + g) * PK + 8 * c + 2 * t);
        uint32_t kb0, ks0, kb1, ks1;
        split_tf32(kv.x, kb0, ks0);
        split_tf32(kv.y, kb1, ks1);
        mma_3xtf32(sc[j], ab, as, kb0, kb1, ks0, ks1);
      }
    }

    // mask, then the online softmax of rows r0 (h = 0) and r0 + 8 (h = 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r0 + 8 * h;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t + e;
          const bool ok = col < s && (!causal || col <= row);
          float& x = sc[j][2 * h + e];
          x = ok ? x : kNegInf;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float alpha = expf(m[h] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[j][2 * h + e];
          x = expf(x - m_new);
          rs += x;
        }
      l[h] = l[h] * alpha + quad_sum(rs);
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        acc[j][2 * h] *= alpha;
        acc[j][2 * h + 1] *= alpha;
      }
    }

    // acc += P V; key chunk c: slot t is key 8c + 2t, slot t + 4 key
    // 8c + 2t + 1, so the score fragment is P's A fragment as it stands
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t pb[4], ps[4];
      split_tf32(sc[c][0], pb[0], ps[0]);   // row g,     key 8c + 2t
      split_tf32(sc[c][2], pb[1], ps[1]);   // row g + 8, key 8c + 2t
      split_tf32(sc[c][1], pb[2], ps[2]);   // row g,     key 8c + 2t + 1
      split_tf32(sc[c][3], pb[3], ps[3]);   // row g + 8, key 8c + 2t + 1
      const float* v0 = Vs + (8 * c + 2 * t) * PV + g;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        uint32_t vb0, vs0, vb1, vs1;
        split_tf32(v0[8 * j], vb0, vs0);
        split_tf32(v0[PV + 8 * j], vb1, vs1);
        mma_3xtf32(acc[j], pb, ps, vb0, vb1, vs0, vs1);
      }
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= s) continue;
    const float li = fmaxf(l[h], 1e-30f);
    float* o = out + base + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < C; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(__fdiv_rn(acc[j][2 * h], li),
                      __fdiv_rn(acc[j][2 * h + 1], li));
    if (t == 0)
      lse[static_cast<size_t>(blockIdx.y) * s + row] = m[h] + logf(li);
  }
}

// --------------------------------------------------------------------- dq
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int s, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kTile][LD], pre-scaled
  float* Os = Qs + kTile * LD;       // dO [kTile][LD]
  float* Ks = Os + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;       // ds [kTile][kPitchP]
  float* Ls = Ps + kTile * kPitchP;  // lse [kTile]
  float* Ds = Ls + kTile;            // delta [kTile]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * s;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(Qs, q + base, q0, s, scale);
  load_tile<D>(Os, dout + base, q0, s, 1.0f);
  load_rows(Ls, lse + rbase, q0, s);
  load_rows(Ds, delta + rbase, q0, s);

  float acc[kRows][C];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;

  const int n_kt = (s + kTile - 1) / kTile;
  const int kt_end = causal ? min(n_kt, q0 / kTile + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(Ks, k + base, k0, s, 1.0f);
    load_tile<D>(Vs, v + base, k0, s, 1.0f);
    __syncthreads();

    float sc[kRows][4], dp[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], ov[kRows], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = Qs[(ty * kRows + i) * LD + d];
        ov[i] = Os[(ty * kRows + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < s && (!causal || col <= row);
        const float p = ok ? expf(sc[i][j] - Ls[r]) : 0.0f;
        Ps[r * kPitchP + tx + 16 * j] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = Ps[(ty * kRows + i) * kPitchP + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float kv = Ks[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= s) continue;
    float* o = dq + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) o[tx + 16 * c] = __fmul_rn(acc[i][c], scale);
  }
}

// -------------------------------------------------------------------- dkv
template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, int s,
           int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                  // this block's keys [kTile][LD]
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;       // streamed queries, pre-scaled
  float* Os = Qs + kTile * LD;       // streamed dO
  float* Ps = Os + kTile * LD;       // p^T [key][query]
  float* Ss = Ps + kTile * kPitchP;  // ds^T [key][query]
  float* Ls = Ss + kTile * kPitchP;
  float* Ds = Ls + kTile;

  const int k0 = blockIdx.x * kTile;  // heaviest causal tiles come first
  const size_t base = static_cast<size_t>(blockIdx.y) * s * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * s;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(Ks, k + base, k0, s, 1.0f);
  load_tile<D>(Vs, v + base, k0, s, 1.0f);

  float dk_acc[kRows][C], dv_acc[kRows][C];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  const int n_qt = (s + kTile - 1) / kTile;
  const int qt_begin = causal ? k0 / kTile : 0;
  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<D>(Qs, q + base, q0, s, scale);
    load_tile<D>(Os, dout + base, q0, s, 1.0f);
    load_rows(Ls, lse + rbase, q0, s);
    load_rows(Ds, delta + rbase, q0, s);
    __syncthreads();

    float st[kRows][4], dpt[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[kRows], vv[kRows], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = Ks[(ty * kRows + i) * LD + d];
        vv[i] = Vs[(ty * kRows + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * LD + d];
        ov[j] = Os[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int key = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int row = q0 + c;
        const bool ok = row < s && key < s && (!causal || key <= row);
        const float p = ok ? expf(st[i][j] - Ls[c]) : 0.0f;
        Ps[r * kPitchP + c] = p;
        Ss[r * kPitchP + c] = p * (dpt[i][j] - Ds[c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[kRows], sv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = Ps[(ty * kRows + i) * kPitchP + qq];
        sv[i] = Ss[(ty * kRows + i) * kPitchP + qq];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float ov = Os[qq * LD + tx + 16 * c];
        const float qv = Qs[qq * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          dv_acc[i][c] = fmaf(pv[i], ov, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sv[i], qv, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty * kRows + i;
    if (key >= s) continue;
    float* ok_ = dk + base + static_cast<size_t>(key) * D;
    float* ov_ = dv + base + static_cast<size_t>(key) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ok_[tx + 16 * c] = dk_acc[i][c];
      ov_[tx + 16 * c] = dv_acc[i][c];
    }
  }
}

// Shared-memory bytes of the backward kernels at head dim d.
inline size_t dq_smem(int d) {
  return sizeof(float) * (4 * kTile * (d + 1) + kTile * kPitchP + 2 * kTile);
}
inline size_t dkv_smem(int d) {
  return sizeof(float) *
         (4 * kTile * (d + 1) + 2 * kTile * kPitchP + 2 * kTile);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int threads, int bh, int s,
           cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kTile - 1) / kTile, bh);
  kernel<<<grid, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PTT_FLASH_DISPATCH(D_, CALL)                                       \
  switch (D_) {                                                            \
    case 16: CALL(16); case 32: CALL(32); case 48: CALL(48);               \
    case 64: CALL(64); case 80: CALL(80); case 96: CALL(96);               \
    case 112: CALL(112); case 128: CALL(128);                              \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }

// q, k, v, out: fp32 [bh, s, d] contiguous; lse: fp32 [bh, s].
// d in {16, 32, ..., 128}; s >= 1. Returns a cudaError_t code.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int bh, int s, int d,
                         int causal, float scale, void* stream) {
  if (bh <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const float*>(q);
  auto* kp = static_cast<const float*>(k);
  auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(out);
  auto* lp = static_cast<float*>(lse);
#define PTT_CALL(DD)                                                       \
  return launch(fwd_kernel<DD>, FwdTiles<DD>::bytes, kFwdThreads, bh, s,   \
                st, qp, kp, vp, op, lp, s, causal, scale)
  PTT_FLASH_DISPATCH(d, PTT_CALL)
#undef PTT_CALL
}

// q, k, v, dout, dq: fp32 [bh, s, d]; lse, delta: fp32 [bh, s].
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int bh, int s, int d, int causal,
                        float scale, void* stream) {
  if (bh <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const float*>(q);
  auto* kp = static_cast<const float*>(k);
  auto* vp = static_cast<const float*>(v);
  auto* dop = static_cast<const float*>(dout);
  auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<const float*>(delta);
  auto* dqp = static_cast<float*>(dq);
#define PTT_CALL(DD)                                                       \
  return launch(dq_kernel<DD>, dq_smem(DD), kThreads, bh, s, st, qp, kp, \
                vp, dop, lp, dp, dqp, s, causal, scale)
  PTT_FLASH_DISPATCH(d, PTT_CALL)
#undef PTT_CALL
}

// q, k, v, dout, dk, dv: fp32 [bh, s, d]; lse, delta: fp32 [bh, s].
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int bh, int s, int d, int causal,
                         float scale, void* stream) {
  if (bh <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const float*>(q);
  auto* kp = static_cast<const float*>(k);
  auto* vp = static_cast<const float*>(v);
  auto* dop = static_cast<const float*>(dout);
  auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<const float*>(delta);
  auto* dkp = static_cast<float*>(dk);
  auto* dvp = static_cast<float*>(dv);
#define PTT_CALL(DD)                                                       \
  return launch(dkv_kernel<DD>, dkv_smem(DD), kThreads, bh, s, st, qp,    \
                kp, vp, dop, lp, dp, dkp, dvp, s, causal, scale)
  PTT_FLASH_DISPATCH(d, PTT_CALL)
#undef PTT_CALL
}
