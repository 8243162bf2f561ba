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
// outputs each. All three run every product on the tensor cores in 3xTF32:
// mma.sync m16n8k8 tf32 with fp32 accumulators in registers, each fp32
// operand split as big + small and multiplied as small.big + big.small +
// big.big, the arithmetic of the fp32 SDPA yardstick (CUTLASS's fast-fp32
// mode). The forward splits with cvt.rna (split_tf32); dq and dkv, which
// the splits bound, with split_tf32_trunc (big rounded to nearest, small
// truncated; two integer operations where cvt.rna is a slow conversion:
// the pair ran 1.6x faster on an H100, PERF.md). One TF32 pass drops the
// small parts and misses the backward's tolerance
// (tests/test_torch_split_tf32.py). Bounds at 3
// passes and 495 TFLOP/s: 0.078 (forward), 0.117 (dq) and 0.156 ms (dkv),
// far above their 0.01-0.02 ms byte bounds.
//
// Common design: one block of 4 warps per (batch*head, 64-row tile); each
// warp owns 16 rows of the block's tile, and every output element has one
// owner, so there are no atomics and a launch repeats its bits. The
// sequential grid axis of the TPU kernels becomes a loop inside the block:
// the forward and dq stream 64-key tiles past a fixed query tile, dkv
// streams 64-query tiles past a fixed key tile. Streamed tiles are
// double-buffered in shared memory by cp.async, so the next tile's load
// overlaps this tile's products, and are split as their fragments are
// read. Any s >= 1 works: rows past the end are zero-filled on load,
// masked in the scores and never stored. d is a template parameter,
// 16..128 in steps of 16.
//
// Causal work per block grows with its tile (1 to s / 64 streamed tiles).
// dq and dkv take the grid as (batch*head, tile), so blocks are handed out
// heaviest tile first across all heads and the light ones fill the tail;
// and only the diagonal and the tail tile compute masks, the others take
// an unmasked copy of the softmax step: its integer compares competed with
// the splits for the integer pipe. Both cut the causal pair by 1.35x on an
// H100 (PERF.md); the forward keeps the grid (tile, batch*head).
//
// A score's accumulator becomes the next product's A operand in
// registers, never through shared memory. A C fragment holds (row g,
// columns 2t and 2t + 1) and (row g + 8, the same columns); an A fragment
// wants (row g, slot t), (g + 8, t), (g, t + 4), (g + 8, t + 4). Letting
// slot t of chunk c stand for the score's column 8c + 2t and slot t + 4
// for 8c + 2t + 1 puts (c0, c1, c2, c3) where (a0, a2, a1, a3) are read.
//
// flash_fwd: row max and sum stay inside the warp (two shuffles across the
// 4 lanes of a quad). The scaled Q tile is split once per block: into
// registers at d <= 64, into shared memory above (where registers would
// spill). Row pitches of d + 8 floats (K, Q) and d + 4 (V) make its
// fragment loads free of bank conflicts: K is read row-wise (8 bytes a
// lane, a row per g), V column-wise (a row per t, a column per g).
//
// flash_dq: per key tile, S = Qs.K^T and dP = dO.V^T (16 query rows x 64
// keys a warp), p = exp(S - lse) and dS = p (dP - delta) in registers,
// each row's lse and delta held by the quad that owns the row, then
// dQ += dS.K. flash_dkv computes the transposed scores directly,
// S^T = K.Qs^T and dP^T = V.dO^T (16 keys x 64 queries a warp; lse and
// delta per column, from the streamed tile's rows in shared memory), then
// dV += P^T.dO and dK += dS^T.Qs, so every product has the forward's
// shape. Each streamed tile is read in both patterns: row-wise as the B
// operand of a score product and column-wise as the B operand of the
// product after it (K in dq; Q and dO in dkv). No single pitch is free of
// conflicts for both under the forward's slot order, so the streamed rows
// are permuted inside each group of 8: column n of a score n-tile j stands
// for row 8j + kslot(n), kslot(n) = n ^ ((n >> 2) & 1), i.e. rows 0 1 2 3
// 5 4 7 6. Then at pitch d + 8 (8 or 24 mod 32 banks for every d here) a
// row-wise read puts the 4 rows of each half-warp on 4 disjoint 8-bank
// windows, and a column-wise read puts slots t = 0..3 on rows
// {0, 2, 5, 7} or {1, 3, 4, 6}, 8 banks apart: both conflict-free. The
// streamed Q in dkv is scaled in shared memory by the thread that copied
// it, after its cp.async lands. The block's own rows (Q and dO in dq, K
// and V in dkv) are loaded once into shared memory at the same pitch and
// split as their fragments are read: held in registers at d = 64 they
// spilled (255 registers), and ran slower.
// Shared memory at d = 64: dq 110,592 bytes (two stages of K and V, and
// the own rows), dkv 111,616 (two stages of Q, dO, lse and delta, and the
// own rows): two blocks an SM, as dkv's ~210 registers allow. At d = 128:
// 208,896 and 209,920, one block.
//
// bf16 forms (flash_fwd_bf16, flash_dq_bf16, flash_dkv_bf16; separate
// kernels, not a branch in the fp32 ones): bf16 q, k, v, dO, out, dq,
// dk, dv; lse and delta fp32, as the reference's kernels load bf16,
// compute in fp32 and store the output dtype. Every product is
// mma.sync m16n8k16 bf16 with fp32 accumulators. Q.K^T and dO.V^T (and
// dkv's K.Q^T, V.dO^T) multiply two bf16 operands, exact, in one pass.
// P.V, dS.K, P^T.dO and dS^T.Q have an fp32 operand (p or ds), rounded to
// bf16 to nearest even for one pass: on unit-scale inputs at s = 1024
// d = 64 a CPU model of that rounding keeps every output element at
// under half of its limit against the fp32 plain versions (2e-2 of its
// magnitude plus 1.6e-2 of its row's RMS; a hi + lo split in two passes
// under 0.3 of it; tests/test_torch_bf16_train.py). The scale
// 1/sqrt(d) multiplies the fp32 scores (q is not pre-scaled: q * scale
// is exact in bf16 only when d is a power of 4), and dq and dk are
// scaled once at the end. Bounds at b8 n12 s1024 d64 causal, 989 TFLOP/s
// bf16 dense: 0.013 ms forward, 0.020 dq, 0.026 dkv of operations
// against ~0.015 / 0.019 / 0.023 ms of bytes (PERF.md).
//
// The tile walk is the fp32 kernels': 4 warps x 16 own rows, 64-row
// streamed tiles double-buffered by cp.async, grid (batch*head, tile)
// heaviest tile first, masks only on the diagonal and tail tiles, and a
// score's accumulator becomes the next product's A operand in registers
// (the m16n8k16 A fragment of key chunk c is the C fragments of key
// tiles 2c and 2c + 1, packed in pairs). Tiles are bf16 in shared memory
// at a row pitch of d + 8 elements (16 bytes over a multiple of 16, so
// the 8 rows one ldmatrix phase reads fall on 8 distinct 16-byte bank
// groups for every d here) and every fragment is read with ldmatrix:
// plain for a tile whose rows are the product's n (K in Q.K^T) or the
// own rows (A), .trans for a tile whose rows are its k (V in P.V, K in
// dS.K, dO and Q in dkv). The own rows stay in shared memory and are
// read per product, which keeps d = 128 out of spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kTile = 64;        // rows per tile, queries and keys alike
constexpr int kThreads = 128;    // 4 warps x 16 rows of the block's tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF (:31)

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
__global__ void __launch_bounds__(kThreads)
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
    for (int e = threadIdx.x; e < kTile * D / 4; e += kThreads) {
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
    for (int e = threadIdx.x; e < kTile * D / 2; e += kThreads) {
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

// --------------------------------------------------------------- backward
// Streamed-row slot permutation of the score products: column n of
// n-tile j stands for row 8j + kslot(n) of the streamed tile (keys in dq,
// queries in dkv), and slot t / t + 4 of the next product's chunk c for
// row 8c + kslot(2t) / 8c + kslot(2t + 1).
__device__ __forceinline__ int kslot(int n) { return n ^ ((n >> 2) & 1); }

template <int D>
struct BwdTiles {
  static constexpr int P = D + 8;                 // row pitch of every tile
  static constexpr int kOwn = 2 * kTile * P;      // own rows: Q, dO / K, V
  static constexpr int kDqStage = 2 * kTile * P;  // streamed K, V
  static constexpr int kDkvStage = 2 * kTile * P + 2 * kTile;  // Q, dO,
                                                               // lse, delta
  static constexpr size_t dq_bytes = sizeof(float) * (2 * kDqStage + kOwn);
  static constexpr size_t dkv_bytes =
      sizeof(float) * (2 * kDkvStage + kOwn);
};

// cp.async rows [row0, row0 + kTile) of a [s, D] matrix into shared
// memory at pitch P, zeros past s.
template <int D, int P>
__device__ __forceinline__ void stream_rows(float* dst, const float* src,
                                            int row0, int s) {
  for (int e = threadIdx.x; e < kTile * D / 4; e += kThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const bool ok = row0 + r < s;
    cp_async16(dst + r * P + c,
               src + (ok ? static_cast<size_t>(row0 + r) * D + c : 0), ok);
  }
}

// The same rows, times `mul`, by plain loads (a block's own tile).
template <int D, int P>
__device__ __forceinline__ void own_rows(float* dst, const float* src,
                                         int row0, int s, float mul) {
  for (int e = threadIdx.x; e < kTile * D / 4; e += kThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < s)
      x = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * D + c);
    x.x = __fmul_rn(x.x, mul);
    x.y = __fmul_rn(x.y, mul);
    x.z = __fmul_rn(x.z, mul);
    x.w = __fmul_rn(x.w, mul);
    *reinterpret_cast<float4*>(dst + r * P + c) = x;
  }
}

// Split A fragment of d-chunk c of a warp's own rows r and r + 8, from
// a tile in shared memory at pitch P.
template <int P>
__device__ __forceinline__ void own_a(uint32_t* ab, uint32_t* as,
                                      const float* tile, int c, int r,
                                      int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 v = *reinterpret_cast<const float2*>(
        tile + (r + 8 * h) * P + 8 * c + 2 * t);
    split_tf32_trunc(v.x, ab[h], as[h]);
    split_tf32_trunc(v.y, ab[2 + h], as[2 + h]);
  }
}

// d += A (own rows x d-chunk) . B, B's column g being row `row` of a
// streamed tile at d-chunk c (8 bytes a lane: the row-wise read).
__device__ __forceinline__ void mma_rowwise(float* d, const uint32_t* ab,
                                            const uint32_t* as,
                                            const float* row) {
  const float2 x = *reinterpret_cast<const float2*>(row);
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32_trunc(x.x, bb0, bs0);
  split_tf32_trunc(x.y, bb1, bs1);
  mma_3xtf32(d, ab, as, bb0, bb1, bs0, bs1);
}

// A fragment of streamed-row chunk c from a score accumulator, split:
// the slot permutation makes (c0, c2, c1, c3) the A slots (0, 1, 2, 3).
__device__ __forceinline__ void score_a(uint32_t* ab, uint32_t* as,
                                        const float* x) {
  split_tf32_trunc(x[0], ab[0], as[0]);
  split_tf32_trunc(x[2], ab[1], as[1]);
  split_tf32_trunc(x[1], ab[2], as[2]);
  split_tf32_trunc(x[3], ab[3], as[3]);
}

// d += A . B with B = rows `lo` and `hi` (slots t, t + 4) of a streamed
// tile at column g + 8j (the column-wise read).
__device__ __forceinline__ void mma_colwise(float* d, const uint32_t* ab,
                                            const uint32_t* as, float lo,
                                            float hi) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32_trunc(lo, bb0, bs0);
  split_tf32_trunc(hi, bb1, bs1);
  mma_3xtf32(d, ab, as, bb0, bb1, bs0, bs1);
}

// --------------------------------------------------------------------- dq
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int s, int causal, float scale) {
  using T = BwdTiles<D>;
  constexpr int P = T::P, C = D / 8, kStage = T::kDqStage;
  extern __shared__ __align__(16) float smem[];
  float* Qo = smem + 2 * kStage;              // own rows: scaled Q
  float* Oo = Qo + kTile * P;                 //           and dO

  // grid (batch*head, tile): every head's heaviest causal tile (the last
  // query rows) is handed out before any head's next one
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const size_t base = static_cast<size_t>(blockIdx.x) * s * D;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;               // tile rows r0 and r0 + 8
  const int hg = kslot(g), lo = kslot(2 * t), hi = lo ^ 1;

  const int n_kt = (s + kTile - 1) / kTile;
  const int kt_end = causal ? min(n_kt, q0 / kTile + 1) : n_kt;

  auto load_kv = [&](int kt) {
    float* Ks = smem + (kt & 1) * kStage;
    stream_rows<D, P>(Ks, k + base, kt * kTile, s);
    stream_rows<D, P>(Ks + kTile * P, v + base, kt * kTile, s);
  };
  load_kv(0);
  cp_async_commit();

  own_rows<D, P>(Qo, q + base, q0, s, scale);
  own_rows<D, P>(Oo, dout + base, q0, s, 1.0f);
  float lr[2], dr[2];   // lse and delta of rows r0 and r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    lr[h] = row < s ? lse[rbase + row] : 0.0f;
    dr[h] = row < s ? delta[rbase + row] : 0.0f;
  }

  float acc[C][4];
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int kt = 0; kt < kt_end; ++kt) {
    if (kt + 1 < kt_end) load_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile kt (and the own rows) visible to every warp
    const float* Ks = smem + (kt & 1) * kStage;
    const float* Vs = Ks + kTile * P;
    const int k0 = kt * kTile;

    // S = Qs K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      uint32_t qb[4], qs[4], ob[4], os[4];
      own_a<P>(qb, qs, Qo, c, r0, t);
      own_a<P>(ob, os, Oo, c, r0, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = (8 * j + hg) * P + 8 * c + 2 * t;
        mma_rowwise(sc[j], qb, qs, Ks + o);
        mma_rowwise(dp[j], ob, os, Vs + o);
      }
    }

    // p = exp(s - lse), ds = p (dp - delta); masked p = 0, where only the
    // diagonal tile and the tail tile have masked pairs
    auto p_ds = [&](auto masked) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + r0 + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p = expf(sc[j][2 * h + e] - lr[h]);
            if constexpr (decltype(masked)::value) {
              const int col = k0 + 8 * j + (e ? hi : lo);
              p = col < s && (!causal || col <= row) ? p : 0.0f;
            }
            sc[j][2 * h + e] = p * (dp[j][2 * h + e] - dr[h]);
          }
      }
    };
    if (k0 + kTile > s || (causal && k0 == q0))
      p_ds(std::true_type());
    else
      p_ds(std::false_type());

    // dQ += dS K over the tile's 8 key chunks
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t ab[4], as[4];
      score_a(ab, as, sc[c]);
      const float* kl = Ks + (8 * c + lo) * P + g;
      const float* kh = Ks + (8 * c + hi) * P + g;
#pragma unroll
      for (int j = 0; j < C; ++j)
        mma_colwise(acc[j], ab, as, kl[8 * j], kh[8 * j]);
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= s) continue;
    float* o = dq + base + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < C; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(__fmul_rn(acc[j][2 * h], scale),
                      __fmul_rn(acc[j][2 * h + 1], scale));
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
  using T = BwdTiles<D>;
  constexpr int P = T::P, C = D / 8, kStage = T::kDkvStage;
  static_assert(kThreads == 2 * kTile, "one thread per lse/delta entry");
  extern __shared__ __align__(16) float smem[];
  float* Ko = smem + 2 * kStage;              // own rows: K
  float* Vo = Ko + kTile * P;                 //           and V

  // grid (batch*head, tile), heaviest causal tiles (the first keys) first
  const int k0 = blockIdx.y * kTile;
  const size_t base = static_cast<size_t>(blockIdx.x) * s * D;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;               // tile keys r0 and r0 + 8
  const int hg = kslot(g), lo = kslot(2 * t), hi = lo ^ 1;

  const int n_qt = (s + kTile - 1) / kTile;
  const int qt_begin = causal ? blockIdx.y : 0;

  // stage: Q [kTile][P], dO [kTile][P], lse [kTile], delta [kTile]
  auto load_q = [&](int qt) {
    float* Qs = smem + (qt & 1) * kStage;
    const int q0 = qt * kTile;
    stream_rows<D, P>(Qs, q + base, q0, s);
    stream_rows<D, P>(Qs + kTile * P, dout + base, q0, s);
    const int i = threadIdx.x % kTile;
    const bool ok = q0 + i < s;
    cp_async4(Qs + 2 * kTile * P + threadIdx.x,
              (threadIdx.x < kTile ? lse : delta) + (ok ? rbase + q0 + i : 0),
              ok);
  };
  // the copy of tile qt this thread made, times the scale (q pre-scaled)
  auto scale_q = [&](int qt) {
    float* Qs = smem + (qt & 1) * kStage;
    for (int e = threadIdx.x; e < kTile * D / 4; e += kThreads) {
      float4* x = reinterpret_cast<float4*>(Qs + (e / (D / 4)) * P +
                                            (e % (D / 4)) * 4);
      float4 y = *x;
      y.x = __fmul_rn(y.x, scale);
      y.y = __fmul_rn(y.y, scale);
      y.z = __fmul_rn(y.z, scale);
      y.w = __fmul_rn(y.w, scale);
      *x = y;
    }
  };
  load_q(qt_begin);
  cp_async_commit();

  own_rows<D, P>(Ko, k + base, k0, s, 1.0f);
  own_rows<D, P>(Vo, v + base, k0, s, 1.0f);

  float dka[C][4], dva[C][4];
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[j][i] = dva[j][i] = 0.0f;

  for (int qt = qt_begin; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) load_q(qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    scale_q(qt);
    __syncthreads();   // tile qt (and the own rows) visible to every warp
    const float* Qs = smem + (qt & 1) * kStage;
    const float* Os = Qs + kTile * P;
    const float* Ls = Os + kTile * P;
    const float* Ds = Ls + kTile;
    const int q0 = qt * kTile;

    // S^T = K Qs^T and dP^T = V dO^T: 16 keys x 64 queries a warp
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      uint32_t kb[4], ks[4], vb[4], vs[4];
      own_a<P>(kb, ks, Ko, c, r0, t);
      own_a<P>(vb, vs, Vo, c, r0, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = (8 * j + hg) * P + 8 * c + 2 * t;
        mma_rowwise(st[j], kb, ks, Qs + o);
        mma_rowwise(dpt[j], vb, vs, Os + o);
      }
    }

    // p^T = exp(s^T - lse[query]), ds^T = p^T (dp^T - delta[query]);
    // masked as in dq
    auto p_ds = [&](auto masked) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = k0 + r0 + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + (e ? hi : lo);
            float p = expf(st[j][2 * h + e] - Ls[col]);
            if constexpr (decltype(masked)::value) {
              const int row = q0 + col;
              p = row < s && key < s && (!causal || key <= row) ? p : 0.0f;
            }
            dpt[j][2 * h + e] = p * (dpt[j][2 * h + e] - Ds[col]);
            st[j][2 * h + e] = p;
          }
      }
    };
    if (q0 + kTile > s || k0 + kTile > s || (causal && q0 == k0))
      p_ds(std::true_type());
    else
      p_ds(std::false_type());

    // dV += P^T dO and dK += dS^T Qs over the tile's 8 query chunks
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t pb[4], ps[4], db[4], ds[4];
      score_a(pb, ps, st[c]);
      score_a(db, ds, dpt[c]);
      const float* ol = Os + (8 * c + lo) * P + g;
      const float* oh = Os + (8 * c + hi) * P + g;
      const float* ql = Qs + (8 * c + lo) * P + g;
      const float* qh = Qs + (8 * c + hi) * P + g;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        mma_colwise(dva[j], pb, ps, ol[8 * j], oh[8 * j]);
        mma_colwise(dka[j], db, ds, ql[8 * j], qh[8 * j]);
      }
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + r0 + 8 * h;
    if (key >= s) continue;
    const size_t o = base + static_cast<size_t>(key) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      *reinterpret_cast<float2*>(dk + o + 8 * j) =
          make_float2(dka[j][2 * h], dka[j][2 * h + 1]);
      *reinterpret_cast<float2*>(dv + o + 8 * j) =
          make_float2(dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------ bf16 forms
using bf16 = __nv_bfloat16;

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulators.
// Fragments (lane = 4 g + t): a0 (row g, k 2t..2t+1), a1 (g + 8, 2t..),
// a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); b0 (k 2t..2t+1, col g), b1
// (k 2t + 8.., col g); c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (g + 8).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i .. 8i + 7 give
// the row addresses of matrix i, and r[i] gets (row g, cols 2t, 2t + 1)
// of it, or with .trans (rows 2t, 2t + 1, col g).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A fragment of rows [r0, r0 + 16) x columns [16c, 16c + 16) of a tile at
// pitch P.
template <int P>
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* tile, int r0,
                                       int c, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4(a, tile + (r0 + (i & 1) * 8 + r) * P + 16 * c + (i >> 1) * 8);
}

// B fragments of A.T^T: the tile's rows are n, its columns k. b[0], b[1]
// for n-tile j (rows 8j ..), b[2], b[3] for n-tile j + 1, k-chunk c.
template <int P>
__device__ __forceinline__ void frag_bt(uint32_t* b, const bf16* tile, int j,
                                        int c, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4(b, tile + (8 * j + (i >> 1) * 8 + r) * P + 16 * c + (i & 1) * 8);
}

// B fragments of A.T: the tile's rows are k, its columns n. b[0], b[1]
// for n-tile j (columns 8j ..), b[2], b[3] for n-tile j + 1, k-chunk c
// (rows 16c ..).
template <int P>
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* tile, int c,
                                       int j, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4_trans(b,
                tile + (16 * c + (i & 1) * 8 + r) * P + 8 * j + (i >> 1) * 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x low
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment of key (or query) chunk c from the score accumulators of
// n-tiles 2c (x0) and 2c + 1 (x1), rounded to bf16.
__device__ __forceinline__ void score_frag(uint32_t* a, const float* x0,
                                           const float* x1) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

template <int D>
struct Bf16Tiles {
  static constexpr int P = D + 8;               // row pitch (elements)
  static constexpr int kRows = kTile * P;       // one tile
  // forward: two stages of K, V and the own Q; dq: the same and dO
  static constexpr size_t fwd_bytes = sizeof(bf16) * 5 * kRows;
  static constexpr size_t dq_bytes = sizeof(bf16) * 6 * kRows;
  static constexpr size_t dkv_stage =            // Q, dO; lse, delta
      sizeof(bf16) * 2 * kRows + sizeof(float) * 2 * kTile;
  static constexpr size_t dkv_bytes = 2 * dkv_stage + sizeof(bf16) * 2 * kRows;
};

// cp.async rows [row0, row0 + kTile) of a bf16 [s, D] matrix into shared
// memory at pitch P, zeros past s (16 bytes = 8 elements a copy).
template <int D, int P>
__device__ __forceinline__ void stream_rows_bf16(bf16* dst, const bf16* src,
                                                 int row0, int s) {
  constexpr int G = D / 8;
  for (int e = threadIdx.x; e < kTile * G; e += kThreads) {
    const int r = e / G, c = (e % G) * 8;
    const bool ok = row0 + r < s;
    cp_async16(dst + r * P + c,
               src + (ok ? static_cast<size_t>(row0 + r) * D + c : 0), ok);
  }
}

// Store rows r0 + g and r0 + g + 8 (h = 0, 1) of a warp's fp32
// accumulators, times `mul`, as bf16 (pairs of columns 8j + 2t).
template <int D>
__device__ __forceinline__ void store_rows_bf16(bf16* dst, float (*acc)[4],
                                                int row, int h, int t,
                                                float mul) {
  bf16* o = dst + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
        acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out,
                float* __restrict__ lse, int s, int causal, float scale) {
  using T = Bf16Tiles<D>;
  constexpr int P = T::P, KC = D / 16, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* Qo = smem + 4 * T::kRows;             // after two stages of K, V

  // grid (batch*head, tile), heaviest causal tiles (the last rows) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const size_t base = static_cast<size_t>(blockIdx.x) * s * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;                   // the warp's own rows

  const int n_kt = (s + kTile - 1) / kTile;
  const int kt_end = causal ? min(n_kt, q0 / kTile + 1) : n_kt;

  auto load_kv = [&](int kt) {
    bf16* Ks = smem + (kt & 1) * 2 * T::kRows;
    stream_rows_bf16<D, P>(Ks, k + base, kt * kTile, s);
    stream_rows_bf16<D, P>(Ks + T::kRows, v + base, kt * kTile, s);
  };
  stream_rows_bf16<D, P>(Qo, q + base, q0, s);
  load_kv(0);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int kt = 0; kt < kt_end; ++kt) {
    if (kt + 1 < kt_end) load_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile kt (and Q) visible to every warp
    const bf16* Ks = smem + (kt & 1) * 2 * T::kRows;
    const bf16* Vs = Ks + T::kRows;
    const int k0 = kt * kTile;

    // S = Q K^T: 16 rows x 64 keys a warp; n-tile j is keys 8j .. 8j + 7
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.0f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t a[4];
      frag_a<P>(a, Qo, r0, c, lane);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        frag_bt<P>(b, Ks, j, c, lane);
        mma_bf16(sc[j], a, b[0], b[1]);
        mma_bf16(sc[j + 1], a, b[2], b[3]);
      }
    }

    // scale, mask (diagonal and tail tiles), online softmax of rows
    // r0 + g (h = 0) and r0 + g + 8 (h = 1)
    const bool masked = k0 + kTile > s || (causal && k0 == q0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r0 + g + 8 * h;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[j][2 * h + e];
          x *= scale;
          if (masked) {
            const int col = k0 + 8 * j + 2 * t + e;
            x = col < s && (!causal || col <= row) ? x : kNegInf;
          }
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
      for (int j = 0; j < DT; ++j) {
        acc[j][2 * h] *= alpha;
        acc[j][2 * h + 1] *= alpha;
      }
    }

    // acc += P V over the tile's 4 key chunks of 16
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t a[4];
      score_frag(a, sc[2 * c], sc[2 * c + 1]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];
        frag_b<P>(b, Vs, c, j, lane);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= s) continue;
    const float li = fmaxf(l[h], 1e-30f);
    store_rows_bf16<D>(out + base, acc, row, h, t, 1.0f / li);
    if (t == 0)
      lse[static_cast<size_t>(blockIdx.x) * s + row] = m[h] + logf(li);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dq, int s, int causal, float scale) {
  using T = Bf16Tiles<D>;
  constexpr int P = T::P, KC = D / 16, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* Qo = smem + 4 * T::kRows;             // own rows: Q
  bf16* Oo = Qo + T::kRows;                   //           and dO

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const size_t base = static_cast<size_t>(blockIdx.x) * s * D;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  const int n_kt = (s + kTile - 1) / kTile;
  const int kt_end = causal ? min(n_kt, q0 / kTile + 1) : n_kt;

  auto load_kv = [&](int kt) {
    bf16* Ks = smem + (kt & 1) * 2 * T::kRows;
    stream_rows_bf16<D, P>(Ks, k + base, kt * kTile, s);
    stream_rows_bf16<D, P>(Ks + T::kRows, v + base, kt * kTile, s);
  };
  stream_rows_bf16<D, P>(Qo, q + base, q0, s);
  stream_rows_bf16<D, P>(Oo, dout + base, q0, s);
  load_kv(0);
  cp_async_commit();
  float lr[2], dr[2];   // lse and delta of rows r0 + g and r0 + g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    lr[h] = row < s ? lse[rbase + row] : 0.0f;
    dr[h] = row < s ? delta[rbase + row] : 0.0f;
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int kt = 0; kt < kt_end; ++kt) {
    if (kt + 1 < kt_end) load_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = smem + (kt & 1) * 2 * T::kRows;
    const bf16* Vs = Ks + T::kRows;
    const int k0 = kt * kTile;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.0f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t aq[4], ao[4];
      frag_a<P>(aq, Qo, r0, c, lane);
      frag_a<P>(ao, Oo, r0, c, lane);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bk[4], bv[4];
        frag_bt<P>(bk, Ks, j, c, lane);
        frag_bt<P>(bv, Vs, j, c, lane);
        mma_bf16(sc[j], aq, bk[0], bk[1]);
        mma_bf16(sc[j + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[j], ao, bv[0], bv[1]);
        mma_bf16(dp[j + 1], ao, bv[2], bv[3]);
      }
    }

    // p = exp(s * scale - lse), ds = p (dp - delta); masked p = 0
    auto p_ds = [&](auto masked) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + r0 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p = expf(sc[j][2 * h + e] * scale - lr[h]);
            if constexpr (decltype(masked)::value) {
              const int col = k0 + 8 * j + 2 * t + e;
              p = col < s && (!causal || col <= row) ? p : 0.0f;
            }
            sc[j][2 * h + e] = p * (dp[j][2 * h + e] - dr[h]);
          }
      }
    };
    if (k0 + kTile > s || (causal && k0 == q0))
      p_ds(std::true_type());
    else
      p_ds(std::false_type());

    // dQ += dS K over the tile's 4 key chunks
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t a[4];
      score_frag(a, sc[2 * c], sc[2 * c + 1]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];
        frag_b<P>(b, Ks, c, j, lane);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row < s) store_rows_bf16<D>(dq + base, acc, row, h, t, scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int s, int causal, float scale) {
  using T = Bf16Tiles<D>;
  constexpr int P = T::P, KC = D / 16, DT = D / 8;
  static_assert(kThreads == 2 * kTile, "one thread per lse/delta entry");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ko = reinterpret_cast<bf16*>(smem_raw + 2 * T::dkv_stage);
  bf16* Vo = Ko + T::kRows;                   // own rows: K and V

  // grid (batch*head, tile), heaviest causal tiles (the first keys) first
  const int k0 = blockIdx.y * kTile;
  const size_t base = static_cast<size_t>(blockIdx.x) * s * D;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;                   // the warp's own keys

  const int n_qt = (s + kTile - 1) / kTile;
  const int qt_begin = causal ? blockIdx.y : 0;

  // stage: Q [kTile][P], dO [kTile][P] (bf16), lse [kTile], delta [kTile]
  auto stage = [&](int qt) {
    return reinterpret_cast<bf16*>(smem_raw + (qt & 1) * T::dkv_stage);
  };
  auto load_q = [&](int qt) {
    bf16* Qs = stage(qt);
    const int q0 = qt * kTile;
    stream_rows_bf16<D, P>(Qs, q + base, q0, s);
    stream_rows_bf16<D, P>(Qs + T::kRows, dout + base, q0, s);
    float* Ls = reinterpret_cast<float*>(Qs + 2 * T::kRows);
    const int i = threadIdx.x % kTile;
    const bool ok = q0 + i < s;
    cp_async4(Ls + threadIdx.x,
              (threadIdx.x < kTile ? lse : delta) + (ok ? rbase + q0 + i : 0),
              ok);
  };
  stream_rows_bf16<D, P>(Ko, k + base, k0, s);
  stream_rows_bf16<D, P>(Vo, v + base, k0, s);
  load_q(qt_begin);
  cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[j][i] = dva[j][i] = 0.0f;

  for (int qt = qt_begin; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) load_q(qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qs = stage(qt);
    const bf16* Os = Qs + T::kRows;
    const float* Ls = reinterpret_cast<const float*>(Qs + 2 * T::kRows);
    const float* Ds = Ls + kTile;
    const int q0 = qt * kTile;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries a warp
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.0f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t ak[4], av[4];
      frag_a<P>(ak, Ko, r0, c, lane);
      frag_a<P>(av, Vo, r0, c, lane);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bq[4], bo[4];
        frag_bt<P>(bq, Qs, j, c, lane);
        frag_bt<P>(bo, Os, j, c, lane);
        mma_bf16(st[j], ak, bq[0], bq[1]);
        mma_bf16(st[j + 1], ak, bq[2], bq[3]);
        mma_bf16(dpt[j], av, bo[0], bo[1]);
        mma_bf16(dpt[j + 1], av, bo[2], bo[3]);
      }
    }

    // p^T = exp(s^T * scale - lse[query]), ds^T = p^T (dp^T - delta)
    auto p_ds = [&](auto masked) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = k0 + r0 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            float p = expf(st[j][2 * h + e] * scale - Ls[col]);
            if constexpr (decltype(masked)::value) {
              const int row = q0 + col;
              p = row < s && key < s && (!causal || key <= row) ? p : 0.0f;
            }
            dpt[j][2 * h + e] = p * (dpt[j][2 * h + e] - Ds[col]);
            st[j][2 * h + e] = p;
          }
      }
    };
    if (q0 + kTile > s || k0 + kTile > s || (causal && q0 == k0))
      p_ds(std::true_type());
    else
      p_ds(std::false_type());

    // dV += P^T dO and dK += dS^T Q over the tile's 4 query chunks
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t ap[4], ad[4];
      score_frag(ap, st[2 * c], st[2 * c + 1]);
      score_frag(ad, dpt[2 * c], dpt[2 * c + 1]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bo[4], bq[4];
        frag_b<P>(bo, Os, c, j, lane);
        frag_b<P>(bq, Qs, c, j, lane);
        mma_bf16(dva[j], ap, bo[0], bo[1]);
        mma_bf16(dva[j + 1], ap, bo[2], bo[3]);
        mma_bf16(dka[j], ad, bq[0], bq[1]);
        mma_bf16(dka[j + 1], ad, bq[2], bq[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + r0 + g + 8 * h;
    if (key >= s) continue;
    store_rows_bf16<D>(dk + base, dka, key, h, t, scale);
    store_rows_bf16<D>(dv + base, dva, key, h, t, 1.0f);
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t st,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int n_tiles(int s) { return (s + kTile - 1) / kTile; }

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
  return launch(fwd_kernel<DD>, FwdTiles<DD>::bytes, dim3(n_tiles(s), bh), \
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
  return launch(dq_kernel<DD>, BwdTiles<DD>::dq_bytes, dim3(bh, n_tiles(s)), \
                st, qp, kp, vp, dop, lp, dp, dqp, s, causal, scale)
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
  return launch(dkv_kernel<DD>, BwdTiles<DD>::dkv_bytes,                   \
                dim3(bh, n_tiles(s)), st, qp, kp, vp, dop, lp, dp, dkp, dvp, \
                s, causal, scale)
  PTT_FLASH_DISPATCH(d, PTT_CALL)
#undef PTT_CALL
}

// The bf16 forms: q, k, v, out (dout, dq, dk, dv): bf16 [bh, s, d]
// contiguous, 16-byte aligned; lse, delta: fp32 [bh, s].
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int s, int d,
                              int causal, float scale, void* stream) {
  if (bh <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(out);
  auto* lp = static_cast<float*>(lse);
#define PTT_CALL(DD)                                                       \
  return launch(fwd_bf16_kernel<DD>, Bf16Tiles<DD>::fwd_bytes,             \
                dim3(bh, n_tiles(s)), st, qp, kp, vp, op, lp, s, causal,   \
                scale)
  PTT_FLASH_DISPATCH(d, PTT_CALL)
#undef PTT_CALL
}

extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int bh, int s,
                             int d, int causal, float scale, void* stream) {
  if (bh <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* dop = static_cast<const bf16*>(dout);
  auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<const float*>(delta);
  auto* dqp = static_cast<bf16*>(dq);
#define PTT_CALL(DD)                                                       \
  return launch(dq_bf16_kernel<DD>, Bf16Tiles<DD>::dq_bytes,               \
                dim3(bh, n_tiles(s)), st, qp, kp, vp, dop, lp, dp, dqp, s, \
                causal, scale)
  PTT_FLASH_DISPATCH(d, PTT_CALL)
#undef PTT_CALL
}

extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int bh,
                              int s, int d, int causal, float scale,
                              void* stream) {
  if (bh <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* dop = static_cast<const bf16*>(dout);
  auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<const float*>(delta);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
#define PTT_CALL(DD)                                                       \
  return launch(dkv_bf16_kernel<DD>, Bf16Tiles<DD>::dkv_bytes,             \
                dim3(bh, n_tiles(s)), st, qp, kp, vp, dop, lp, dp, dkp,    \
                dvp, s, causal, scale)
  PTT_FLASH_DISPATCH(d, PTT_CALL)
#undef PTT_CALL
}
