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
// compute in fp32 and store the output dtype. Every product is bf16 on
// the tensor cores with fp32 accumulators. Q.K^T and dO.V^T (and dkv's
// K.Q^T, V.dO^T) multiply two bf16 operands, exact, in one pass. P.V,
// dS.K, P^T.dO and dS^T.Q have an fp32 operand (p or ds), rounded to
// bf16 to nearest even for one pass: on unit-scale inputs at s = 1024
// d = 64 a CPU model of that rounding keeps every output element at
// under half of its limit against the fp32 plain versions (2e-2 of its
// magnitude plus 1.6e-2 of its row's RMS; a hi + lo split in two passes
// under 0.3 of it; tests/test_torch_bf16_train.py). The scale
// 1/sqrt(d) multiplies the fp32 scores (q is not pre-scaled: q * scale
// is exact in bf16 only when d is a power of 4), and dq and dk are
// scaled once at the end. Bounds at b8 n12 s1024 d64 causal, 989 TFLOP/s
// bf16 dense: 0.013 ms forward, 0.020 dq, 0.026 dkv of operations
// against 0.0151 / 0.019 / 0.023 ms of bytes (PERF.md).
//
// fp16 forms (flash_fwd_fp16, flash_dq_fp16, flash_dkv_fp16): the bf16
// kernels below are templates over the element type E, and the fp16
// instances differ in three places only: the tensor maps' data type, the
// wgmma operand type (.f16 for .bf16: the same fragments and
// descriptors) and the rounding of p and ds to fp16 (__floats2half2_rn).
// fp16 keeps 3 more mantissa bits than bf16 but 5 fewer exponent bits,
// and dS underflows: the backward scales each dS row by a power of two
// before it rounds it (ds_scale_rows, below; tests/test_torch_fp16_train.py
// models the alternatives). The bounds are bf16's: the same bytes and the
// same dense rate.
//
// The three bf16 kernels, flash_fwd_bf16 (replaces _fwd_kernel,
// flash_attention.py:118), flash_dq_bf16 (_dq_kernel, :213) and
// flash_dkv_bf16 (_dkv_kernel, :251), are Hopper's own design
// (hopper.cuh): TMA, mbarriers and wgmma. What bounds them at the
// training shape: the forward 0.0151 ms of bytes (q, k, v in, out and
// lse out) against 0.0130 ms of operations, dq 0.0196 ms of operations
// against 0.0190 of bytes, dkv 0.0261 ms of operations against 0.0228 of
// bytes; the mma.sync kernels before them ran 5.3-5.8x those bounds.
// Design, all three:
// - warp roles: one producer warp, whose one thread issues every TMA
//   load, keeps a ring of stages in flight; consumer warpgroups of 128
//   threads run wgmma m64n64k16 (dkv's score products at d > 64:
//   m64n32k16) on what has landed. No thread spends registers or
//   instructions on addresses, and no ldmatrix re-reads a tile: wgmma
//   reads the swizzled tiles from shared memory through descriptors.
// - tiles: 64 x 64 bf16 boxes (128-byte rows, 128-byte swizzle), two
//   side by side at d > 64. Rows past s and columns past d (d of 16,
//   32, 48; 80, 96, 112 in the second box) arrive from TMA as zeros, so
//   there are no masked copies; the padded columns multiply zeros.
// - the score accumulator becomes the second product's A operand in
//   registers (wgmma's RS form), rounded to bf16; V, K, dO and Q are
//   that product's B operand as they lie, MN-major (the descriptor's
//   transpose bit), with no transposed copy. dq reads each K box twice
//   in place, K-major as the B of S = Q K^T and MN-major as the B of
//   dQ += dS K, as dkv reads its Q box.
// - the forward's pipeline (FlashAttention-3's overlap inside a
//   warpgroup): wgmma is asynchronous, so a warpgroup issues tile j's
//   scores, then tile j - 1's P.V, and computes tile j's softmax while
//   P.V runs; a stage is released when its P.V is done. At d = 64 a
//   64 x 64 tile's 4096 exponentials take the special-function unit
//   about as long as its two products take the tensor cores. The
//   forward is bound by latency, not by either unit: it gains with the
//   warpgroups resident an SM and the stages in flight (below).
// - 2^x on the special-function unit (ex2.approx.ftz) of the scores
//   times scale * log2(e), less lse * log2(e) in the backward, lse
//   returned in the natural log; grid (batch*head, tile), heaviest
//   causal tile first; masks only on the diagonal and tail tiles.
// - every output element has one owner (a consumer thread of one
//   block), no atomics: a launch repeats its bits.
// Forward: a block holds kFwdWarpgroups x 64 query rows, loaded once;
// K and V stream through kFwdStages stages of 64 keys; a warpgroup
// skips (but releases) a tile wholly above its own diagonal. The online
// softmax keeps each lane's share of the row sum, the quad's four added
// at the end. dq: the forward's shape with dkv's second score product
// and no online softmax: a block holds 64 query rows of Q and dO, loaded
// once, and each consumer thread its two rows' lse and delta in
// registers; K and V stream through kDqStages stages of 64 keys, up to
// the diagonal tile; per tile S = Q K^T and dP = dO V^T, then p and dS
// in registers, then dQ += dS K. dkv: a block holds kDkvWarpgroups x
// 64 keys of K and V; Q and dO (TMA) and their lse and delta rows
// (cp.async by the producer warp's lanes, landing on the stage's
// barrier: a 1-D tensor map of the [bh * s] vector is refused without
// strides, and a one-row 2-D fp32 map encodes but its load stops the
// kernel with an illegal instruction, H100, CUDA 12.8) stream through
// kDkvStages stages of BQ queries: 64 at d <= 64; 32 at d > 64, where
// dK and dV take 64 registers each and a 64-query S^T and dP^T 32 each,
// too many for a thread's 255 beside the rest (a 32-query tile keeps
// S^T and dP^T at 16).
// -Xptxas -v (sm_90a, CUDA 12.8; tools/torch_flash_ab.py prints it):
// forward 122-128 registers a thread at d <= 64, 164-180 above; dkv
// 167-168 at d <= 64 (two blocks an SM), 201-203 above; dq 128 at
// d <= 64 (three blocks an SM), 158-160 above; no spills.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
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

// 2^x on the special-function unit, subnormal results flushed to zero
// (a softmax term under 2^-126 of its row's largest adds nothing).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
using fp16 = __half;

// Two floats rounded to nearest even as one register of two 16-bit
// values of type E (bf16 or fp16), lo in the low half; and the pair type.
template <typename E> struct Pair16;
template <> struct Pair16<bf16> {
  using type = __nv_bfloat162;
  __device__ static type round(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);   // .x low
  }
};
template <> struct Pair16<fp16> {
  using type = __half2;
  __device__ static type round(float lo, float hi) {
    return __floats2half2_rn(lo, hi);       // .x low
  }
};

template <typename E>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  const typename Pair16<E>::type v = Pair16<E>::round(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of key (or query) chunk c from the 8-register chunk 8c
// of a wgmma score accumulator (x0 = its n-tile 2c, x1 = 2c + 1),
// rounded to E.
template <typename E>
__device__ __forceinline__ void score_frag(uint32_t* a, const float* x0,
                                           const float* x1) {
  a[0] = pack16<E>(x0[0], x0[1]);
  a[1] = pack16<E>(x0[2], x0[3]);
  a[2] = pack16<E>(x1[0], x1[1]);
  a[3] = pack16<E>(x1[2], x1[3]);
}

// ------------------------------------------- bf16 kernels: wgmma + TMA
// Warp roles, stages and blocks an SM, as tools/torch_flash_ab.py timed
// them side by side at b8 n12 s1024 d64 causal (H100 80GB HBM3, 700 W;
// PERF.md): the forward with one consumer warpgroup a block, three
// blocks an SM (ptxas held to 136 registers) and four stages 0.0516 ms,
// level with bf16 SDPA's forward; three stages 0.0528, two 0.0613; two
// blocks an SM 0.0732; two warpgroups a block (one block an SM) 0.0805.
// With two stages the pipeline below lost to none (0.081 against 0.069
// ms): a stage is released a tile later, so the next load waited. dkv
// with one warpgroup, two blocks an SM and three stages 0.0858; two
// stages 0.0922, four 0.0911, two warpgroups 0.0949; dkv's pipeline
// held 224 registers (one block an SM) and ran 0.130-0.137, so dkv
// waits for each tile's score products. dq with one warpgroup and three
// stages 0.0560-0.0568 ms; two stages 0.0580, four 0.0640 (two blocks
// an SM by shared memory). ptxas gives dq 128 registers at d = 64
// whether asked for one, two or three blocks an SM (three fit); two ran
// 0.0560 against three's 0.0568. Issuing dP as a second group, so p is
// computed while it runs, took dq from 0.0592 to 0.0565. dq's pipeline
// (the next tile's scores issued before this tile's dQ product) held
// 142 registers and ran level at two blocks an SM (0.0654 against
// 0.0658), and spilled at three (0.0892): it was dropped.
constexpr int kFwdWarpgroups = 1;  // consumer warpgroups, 64 query rows each
constexpr int kFwdStages = 4;      // K/V stages in the forward's ring
constexpr int kFwdMinBlocks = 3;   // blocks an SM asked of ptxas at d <= 64
constexpr int kDkvWarpgroups = 1;  // consumer warpgroups, 64 keys each
constexpr int kDkvStages = 3;      // Q/dO/lse/delta stages in dkv's ring
constexpr int kDqStages = 3;       // K/V stages in dq's ring
constexpr int kDqMinBlocks = 2;    // blocks an SM asked of ptxas at d <= 64
constexpr float kLog2e = 1.4426950408889634f;

// Store rows r and r + 8 (h = 0, 1) of a warp's wgmma accumulators over
// `NB` 64-column boxes, times `mul`, as E: the columns below D.
template <typename E, int D, int NB>
__device__ __forceinline__ void store_boxes(E* dst,
                                            const float (&acc)[NB][32],
                                            int row, int h, int t,
                                            float mul) {
  E* o = dst + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (64 * b + 8 * j < D)
        *reinterpret_cast<typename Pair16<E>::type*>(o + 64 * b + 8 * j) =
            Pair16<E>::round(acc[b][4 * j + 2 * h] * mul,
                             acc[b][4 * j + 2 * h + 1] * mul);
}

// The fp16 backward's remedy for dS's range. fp16's smallest normal is
// 6.1e-5 and it holds nothing under 6e-8, while dS = p (dP - delta) at a
// training shape lies near or below both (the loss's gradient is ~1/(b s)
// an element, and p ~1/s), so dS rounded to fp16 as it is would lose most
// of its bits or all of them (tests/test_torch_fp16_train.py models it).
// Each accumulator row r (a query row of dQ, a key row of dK) keeps a
// power-of-two exponent k_r, at first kDsShiftMax: a tile's dS row is
// multiplied by 2^k_r before it is rounded to fp16, where k_r falls to
// 14 - e, e the exponent of the row's largest |dS| in the tile, whenever
// that is lower, so the largest lands in [2^14, 2^15); when k_r falls the
// row's fp32 accumulator is multiplied by 2^(new - old) first (exact),
// and the epilogue multiplies by 2^-k_r. A row's rounding is then relative
// to its running largest |dS|, as bf16's exponent would give it. bf16 has
// fp32's exponent and keeps the plain rounding.
constexpr int kDsShiftMax = 100;

__device__ __forceinline__ int ds_shift(float amax) {
  const int e = static_cast<int>((__float_as_uint(amax) >> 23) & 0xff) - 127;
  return max(-kDsShiftMax, min(kDsShiftMax, 14 - e));
}

// 2^k as a float from its exponent bits (k in [-126, 127]), 0 below: a
// shift's factor without scalbnf's special cases
__device__ __forceinline__ float exp2i(int k) {
  return k < -126 ? 0.0f : __int_as_float((127 + k) << 23);
}

// The epilogue's multiplier of a dS product's row: scale, and for fp16
// 2^-k of the row's shift.
template <typename E>
__device__ __forceinline__ float ds_unscale(float scale, int k) {
  if constexpr (std::is_same<E, fp16>::value)
    return scale * exp2i(-k);
  else
    return scale;
}

// Row h of a thread's dS in x (its N-wide accumulator layout, N = 8 NJ
// columns) scaled by 2^ks[h] after ks[h] falls to this tile's shift; the
// row of the NB-box accumulator acc rescaled when it does.
template <int NJ, int NB>
__device__ __forceinline__ void ds_scale_rows(float* x, float (&acc)[NB][32],
                                              int (&ks)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) mx = fmaxf(mx, fabsf(x[4 * j + 2 * h + e]));
    const int k = min(ks[h], ds_shift(quad_max(mx)));
    if (k != ks[h]) {
      const float f = exp2i(k - ks[h]);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[b][4 * j + 2 * h + e] *= f;
      ks[h] = k;
    }
    const float up = exp2i(k);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) x[4 * j + 2 * h + e] *= up;
  }
}

template <int D, int WG, int ST>
struct FwdHopper {
  static constexpr int NB = (D + 63) / 64;            // 64-column boxes
  static constexpr int kQ = WG * NB * hopper::kBoxBytes;
  static constexpr int kStage = 2 * NB * hopper::kBoxBytes;   // K, V
  static constexpr int kThreads = 128 * WG + 32;
  static constexpr int kMinBlocks = NB == 1 ? kFwdMinBlocks : 1;
  static constexpr size_t bytes =
      hopper::kSwizzleAlign + kQ + ST * kStage + 8 * (1 + 2 * ST);
};

template <typename E, int D, int WG, int ST>
__global__ void __launch_bounds__(FwdHopper<D, WG, ST>::kThreads,
                                  FwdHopper<D, WG, ST>::kMinBlocks)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 E* __restrict__ out, float* __restrict__ lse, int s,
                 int causal, float scale) {
  using namespace hopper;
  using T = FwdHopper<D, WG, ST>;
  constexpr int NB = T::NB, KS = D / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align_swizzle(smem_raw);   // [WG][NB] boxes of Q
  unsigned char* KV = Qs + T::kQ;                // [ST] stages: K, V boxes
  uint64_t* q_full = reinterpret_cast<uint64_t*>(KV + ST * T::kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  // grid (batch*head, tile), heaviest causal tiles (the last rows) first
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64 * WG;
  const int n_kt = (s + 63) / 64;
  const int kt_end =
      causal ? min(n_kt, (min(q0 + 64 * WG, s) - 1) / 64 + 1) : n_kt;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == WG) {   // the producer warp: one thread issues every load
    if (threadIdx.x == 128 * WG) {
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      const int live = min(WG, (s - q0 + 63) / 64);  // warpgroups with rows
      mbar_expect_tx(q_full, live * NB * kBoxBytes);
      for (int w = 0; w < live; ++w)
        for (int b = 0; b < NB; ++b)
          tma_load_3d(Qs + (w * NB + b) * kBoxBytes, &tq, 64 * b,
                      q0 + 64 * w, bh, q_full);
      for (int kt = 0; kt < kt_end; ++kt) {
        const int st = kt % ST, use = kt / ST;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        unsigned char* Ks = KV + st * T::kStage;
        mbar_expect_tx(&full[st], T::kStage);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(Ks + b * kBoxBytes, &tk, 64 * b, 64 * kt, bh,
                      &full[st]);
          tma_load_3d(Ks + (NB + b) * kBoxBytes, &tv, 64 * b, 64 * kt, bh,
                      &full[st]);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows qw .. qw + 63; warp w rows r0 and r0 + 8
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + 64 * wg;
  const int r0 = qw + 16 * warp + g;
  const int kt_mine =
      qw >= s ? 0 : causal ? min(kt_end, qw / 64 + 1) : kt_end;
  const float sl2 = scale * kLog2e;   // raw scores to base-2 exponents

  float o[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[b][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2];
  float sc[32];          // the scores, then p, of the newest tile
  uint32_t pa[4][4];     // p of the tile whose P.V is next, as E
  const uint32_t qa = smem_u32(Qs + wg * NB * kBoxBytes);
  auto stage = [&](int kt) { return smem_u32(KV + (kt % ST) * T::kStage); };

  // S = Q K^T of tile kt: 64 rows x 64 keys, Q and K K-major in shared
  // memory; issued, not waited for
  auto scores = [&](int kt) {
    const uint32_t ka = stage(kt);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const uint32_t off = (k / 4) * kBoxBytes + (k % 4) * 32;
      wgmma_ss_n64<E>(sc, desc_sw128(qa + off), desc_sw128(ka + off),
                      k > 0);
    }
    wgmma_commit();
  };
  // P.V of tile kt; issued
  auto pv = [&](int kt) {
    const uint32_t va = stage(kt) + NB * kBoxBytes;
    wgmma_fence();
    // O += P V, P from registers, V MN-major: the tile's 4 key chunks
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
        wgmma_rs_n64_mn<E>(o[b], pa[c],
                           desc_sw128(va + b * kBoxBytes + c * 2048));
    }
    wgmma_commit();
  };
  // mask (diagonal and tail tiles), then the online softmax in base 2
  // of rows r0 (h = 0) and r0 + 8 (h = 1) over sc: m, l and alpha; l is
  // this lane's share of the row sum, the quad's four added at the end.
  // O is rescaled by alpha later, once no product writes it.
  auto softmax = [&](int kt, auto masked) {
    const int k0 = 64 * kt;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          if constexpr (decltype(masked)::value) {
            const int col = k0 + 8 * j + 2 * t + e;
            x = col < s && (!causal || col <= row) ? x : kNegInf;
          }
          mx = fmaxf(mx, x);
        }
      const float m_new = quad_max(mx);
      const float base = m_new * sl2;
      alpha[h] = exp2_ftz(fmaf(m[h], sl2, -base));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = exp2_ftz(fmaf(x, sl2, -base));
          rs += x;
        }
      l[h] = l[h] * alpha[h] + rs;
      m[h] = m_new;
    }
  };
  auto softmax_of = [&](int kt) {
    if (64 * kt + 64 > s || (causal && 64 * kt == qw))
      softmax(kt, std::true_type());
    else
      softmax(kt, std::false_type());
  };
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[b][4 * j + 2 * h] *= alpha[h];
          o[b][4 * j + 2 * h + 1] *= alpha[h];
        }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      score_frag<E>(pa[c], sc + 8 * c, sc + 8 * c + 4);
  };
  auto drain = [&]() {   // every product of this warpgroup done
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(o[b]);
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(pa[c]);
  };
  auto full_wait = [&](int kt) { mbar_wait(&full[kt % ST], (kt / ST) & 1); };

  // The pipeline (one warpgroup): tile kt's scores are issued before
  // tile kt - 1's P.V, so the softmax of kt runs while P.V of kt - 1 is
  // on the tensor cores; a stage is released once its P.V is done.
  // Tiles kt_mine .. kt_end - 1 lie wholly above this warpgroup's
  // diagonal: released unread.
  mbar_wait(q_full, 0);
  if (kt_mine > 0) {
    full_wait(0);
    scores(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_of(0);
    rescale_and_pack();
    for (int kt = 1; kt < kt_mine; ++kt) {
      full_wait(kt);
      scores(kt);
      pv(kt - 1);
      wgmma_wait<1>();   // the scores of kt; P.V of kt - 1 may run on
      fence_regs(sc);
      softmax_of(kt);
      drain();
      mbar_arrive(&empty[(kt - 1) % ST]);
      rescale_and_pack();
    }
    pv(kt_mine - 1);
    drain();
    mbar_arrive(&empty[(kt_mine - 1) % ST]);
  }
  for (int kt = kt_mine; kt < kt_end; ++kt) {
    full_wait(kt);
    mbar_arrive(&empty[kt % ST]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const float li = fmaxf(quad_sum(l[h]), 1e-30f);
    if (row >= s) continue;
    store_boxes<E, D, NB>(out + static_cast<size_t>(bh) * s * D, o, row, h,
                          t, 1.0f / li);
    if (t == 0)
      lse[static_cast<size_t>(bh) * s + row] = m[h] * scale + logf(li);
  }
}

template <int D, int WG, int ST>
struct DkvHopper {
  static constexpr int NB = (D + 63) / 64;            // 64-column boxes
  // streamed queries a stage: at d > 64 the four accumulators of a
  // 64 x 64 tile (dK and dV 64 registers each, S^T and dP^T 32) leave
  // too few of a thread's 255 registers; 32 queries halve S^T and dP^T
  static constexpr int BQ = NB == 1 ? 64 : 32;
  static constexpr int kQBox = BQ * 128;               // a box of BQ rows
  static constexpr int kOwn = WG * 2 * NB * hopper::kBoxBytes;   // K, V
  static constexpr int kStage = 2 * NB * kQBox;        // Q, dO
  static constexpr int kRows = 2 * BQ * 4;             // lse, delta
  static constexpr int kThreads = 128 * WG + 32;
  static constexpr size_t bytes = hopper::kSwizzleAlign + kOwn +
                                  ST * (kStage + kRows) + 8 * (1 + 2 * ST);
};

// One k-step of d = A.B (+ d), N = 64 or 32 (the accumulator's size)
template <typename E, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (N == 64)
    hopper::wgmma_ss_n64<E>(d, a, b, accumulate);
  else
    hopper::wgmma_ss_n32<E>(d, a, b, accumulate);
}

template <typename E, int D, int WG, int ST>
__global__ void __launch_bounds__(DkvHopper<D, WG, ST>::kThreads)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, E* __restrict__ dk,
                 E* __restrict__ dv, int s, int causal, float scale) {
  using namespace hopper;
  using T = DkvHopper<D, WG, ST>;
  constexpr int NB = T::NB, BQ = T::BQ, KS = D / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Own = align_swizzle(smem_raw);  // [WG][K, V][NB] boxes
  unsigned char* QO = Own + T::kOwn;             // [ST] stages: Q, dO
  float* Rows = reinterpret_cast<float*>(QO + ST * T::kStage);  // lse, delta
  uint64_t* own_full = reinterpret_cast<uint64_t*>(Rows + ST * 2 * BQ);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + ST;

  // grid (batch*head, tile), heaviest causal tiles (the first keys) first
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * 64 * WG;
  const int n_qt = (s + BQ - 1) / BQ;
  const int qt_begin = causal ? k0 / BQ : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1 + 32);   // the TMA thread, the lanes' cp.async
      mbar_init(&empty[i], 128 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == WG) {   // the producer warp
    const int lane = threadIdx.x & 31;
    const size_t rbase = static_cast<size_t>(bh) * s;
    if (lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tdo);
      const int live = min(WG, (s - k0 + 63) / 64);  // warpgroups with keys
      mbar_expect_tx(own_full, live * 2 * NB * kBoxBytes);
      for (int w = 0; w < live; ++w)
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(Own + (2 * w * NB + b) * kBoxBytes, &tk, 64 * b,
                      k0 + 64 * w, bh, own_full);
          tma_load_3d(Own + ((2 * w + 1) * NB + b) * kBoxBytes, &tv, 64 * b,
                      k0 + 64 * w, bh, own_full);
        }
    }
    for (int qt = qt_begin, i = 0; qt < n_qt; ++qt, ++i) {
      const int st = i % ST, use = i / ST;
      if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
      const int q0 = qt * BQ;
      if (lane == 0) {   // one thread: the Q and dO boxes by TMA
        unsigned char* Qs = QO + st * T::kStage;
        mbar_expect_tx(&full[st], T::kStage);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(Qs + b * T::kQBox, &tq, 64 * b, q0, bh, &full[st]);
          tma_load_3d(Qs + (NB + b) * T::kQBox, &tdo, 64 * b, q0, bh,
                      &full[st]);
        }
      }
      // the warp: the tile's lse and delta rows by cp.async, zeros past
      // s, each lane's copies landing on the same barrier
      float* R = Rows + st * 2 * BQ;
      for (int e = lane; e < 2 * BQ; e += 32) {
        const int r = e % BQ;
        const bool ok = q0 + r < s;
        cp_async4(R + e, (e < BQ ? lse : delta) + (ok ? rbase + q0 + r : 0),
                  ok);
      }
      mbar_arrive_cp_async(&full[st]);
    }
    return;
  }

  // a consumer warpgroup: keys kw .. kw + 63; warp w keys key0, key0 + 8
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kw = k0 + 64 * wg;
  const int key0 = kw + 16 * warp + g;
  const float sl2 = scale * kLog2e;   // raw scores to base-2 exponents

  float dka[NB][32], dva[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[b][i] = dva[b][i] = 0.0f;
  const uint32_t ka = smem_u32(Own + 2 * wg * NB * kBoxBytes);
  const uint32_t va = ka + NB * kBoxBytes;
  int ks[2] = {kDsShiftMax, kDsShiftMax};   // fp16: each key row's 2^k
  mbar_wait(own_full, 0);

  for (int qt = qt_begin, i = 0; qt < n_qt; ++qt, ++i) {
    const int st = i % ST;
    mbar_wait(&full[st], (i / ST) & 1);
    const int q0 = qt * BQ;
    // else every query of the tile is before every key of this warpgroup
    if (kw < s && (!causal || q0 + BQ > kw)) {
      const uint32_t qa = smem_u32(QO + st * T::kStage);
      const uint32_t oa = qa + NB * T::kQBox;
      const float* Ls = Rows + st * 2 * BQ;
      const float* Ds = Ls + BQ;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries, all four
      // operands K-major in shared memory
      float sT[BQ / 2], dpT[BQ / 2];
#pragma unroll
      for (int x = 0; x < BQ / 2; ++x) sT[x] = dpT[x] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const uint32_t oa_k = (k / 4) * kBoxBytes + (k % 4) * 32;
        const uint32_t ob_k = (k / 4) * T::kQBox + (k % 4) * 32;
        wgmma_ss<E, BQ>(sT, desc_sw128(ka + oa_k), desc_sw128(qa + ob_k),
                        k > 0);
        wgmma_ss<E, BQ>(dpT, desc_sw128(va + oa_k), desc_sw128(oa + ob_k),
                        k > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sT);
      fence_regs(dpT);

      // p^T = 2^(s^T * scale * log2(e) - lse[query] * log2(e)),
      // ds^T = p^T (dp^T - delta[query]); masked p = 0, where only the
      // diagonal tile and the tail tiles have masked pairs
      auto p_ds = [&](auto masked) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = key0 + 8 * h;
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * t + e;
              const int x = 4 * j + 2 * h + e;
              float p = exp2_ftz(fmaf(sT[x], sl2, -Ls[col] * kLog2e));
              if constexpr (decltype(masked)::value) {
                const int row = q0 + col;
                p = row < s && key < s && (!causal || key <= row) ? p : 0.0f;
              }
              dpT[x] = p * (dpT[x] - Ds[col]);
              sT[x] = p;
            }
        }
      };
      if (q0 + BQ > s || kw + 64 > s || (causal && q0 < kw + 63))
        p_ds(std::true_type());
      else
        p_ds(std::false_type());
      if constexpr (std::is_same<E, fp16>::value)
        ds_scale_rows<BQ / 8, NB>(dpT, dka, ks);

      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) {
        score_frag<E>(pa[c], sT + 8 * c, sT + 8 * c + 4);
        score_frag<E>(da[c], dpT + 8 * c, dpT + 8 * c + 4);
      }
      wgmma_fence();
      // dV += P^T dO and dK += dS^T Q, dO and Q MN-major: the tile's
      // query chunks of 16
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          wgmma_rs_n64_mn<E>(dva[b], pa[c],
                             desc_sw128(oa + b * T::kQBox + c * 2048));
          wgmma_rs_n64_mn<E>(dka[b], da[c],
                             desc_sw128(qa + b * T::kQBox + c * 2048));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        fence_regs(dka[b]);
        fence_regs(dva[b]);
      }
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) {
        fence_regs(pa[c]);
        fence_regs(da[c]);
      }
    }
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= s) continue;
    store_boxes<E, D, NB>(dk + static_cast<size_t>(bh) * s * D, dka, key, h,
                          t, ds_unscale<E>(scale, ks[h]));
    store_boxes<E, D, NB>(dv + static_cast<size_t>(bh) * s * D, dva, key, h,
                          t, 1.0f);
  }
}

template <int D, int ST>
struct DqHopper {
  static constexpr int NB = (D + 63) / 64;                    // 64-column boxes
  static constexpr int kOwn = 2 * NB * hopper::kBoxBytes;     // Q, dO
  static constexpr int kStage = 2 * NB * hopper::kBoxBytes;   // K, V
  static constexpr int kThreads = 128 + 32;
  static constexpr int kMinBlocks = NB == 1 ? kDqMinBlocks : 1;
  static constexpr size_t bytes =
      hopper::kSwizzleAlign + kOwn + ST * kStage + 8 * (1 + 2 * ST);
};

template <typename E, int D, int ST>
__global__ void __launch_bounds__(DqHopper<D, ST>::kThreads,
                                  DqHopper<D, ST>::kMinBlocks)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta, E* __restrict__ dq, int s,
                int causal, float scale) {
  using namespace hopper;
  using T = DqHopper<D, ST>;
  constexpr int NB = T::NB, KS = D / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Own = align_swizzle(smem_raw);  // [Q, dO][NB] boxes
  unsigned char* KV = Own + T::kOwn;             // [ST] stages: K, V boxes
  uint64_t* own_full = reinterpret_cast<uint64_t*>(KV + ST * T::kStage);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + ST;

  // grid (batch*head, tile), heaviest causal tiles (the last rows) first;
  // causal blocks stop at their diagonal tile
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int kt_end = causal ? q0 / 64 + 1 : (s + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {   // the producer warp: one thread issues every load
    if (threadIdx.x == 128) {
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      mbar_expect_tx(own_full, T::kOwn);
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(Own + b * kBoxBytes, &tq, 64 * b, q0, bh, own_full);
        tma_load_3d(Own + (NB + b) * kBoxBytes, &tdo, 64 * b, q0, bh,
                    own_full);
      }
      for (int kt = 0; kt < kt_end; ++kt) {
        const int st = kt % ST, use = kt / ST;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        unsigned char* Ks = KV + st * T::kStage;
        mbar_expect_tx(&full[st], T::kStage);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(Ks + b * kBoxBytes, &tk, 64 * b, 64 * kt, bh,
                      &full[st]);
          tma_load_3d(Ks + (NB + b) * kBoxBytes, &tv, 64 * b, 64 * kt, bh,
                      &full[st]);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: warp w rows r0 and r0 + 8, each row's lse
  // and delta in the registers of the quad that owns it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * warp + g;
  const float sl2 = scale * kLog2e;   // raw scores to base-2 exponents
  float ll[2], dr[2];                 // lse * log2(e) and delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const size_t i = static_cast<size_t>(bh) * s + row;
    ll[h] = row < s ? lse[i] * kLog2e : 0.0f;
    dr[h] = row < s ? delta[i] : 0.0f;
  }

  float acc[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.0f;
  float sc[32], dp[32];   // S, then p, then dS; dP
  uint32_t da[4][4];      // dS as E: the A operand of dQ += dS K
  int ks[2] = {kDsShiftMax, kDsShiftMax};   // fp16: each row's 2^k
  const uint32_t qa = smem_u32(Own);
  const uint32_t oa = qa + NB * kBoxBytes;
  auto stage = [&](int kt) { return smem_u32(KV + (kt % ST) * T::kStage); };

  // S = Q K^T, then dP = dO V^T, of tile kt: 64 rows x 64 keys, all four
  // operands K-major in shared memory; issued as two groups, so p is
  // computed while dP runs
  auto scores = [&](int kt) {
    const uint32_t ka = stage(kt);
    const uint32_t va = ka + NB * kBoxBytes;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const uint32_t off = (k / 4) * kBoxBytes + (k % 4) * 32;
      wgmma_ss_n64<E>(sc, desc_sw128(qa + off), desc_sw128(ka + off),
                      k > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const uint32_t off = (k / 4) * kBoxBytes + (k % 4) * 32;
      wgmma_ss_n64<E>(dp, desc_sw128(oa + off), desc_sw128(va + off),
                      k > 0);
    }
    wgmma_commit();
  };
  // p = 2^(s * scale * log2(e) - lse * log2(e)) in place of S; masked
  // p = 0 (keys past s and, causal, after the row), where only the
  // diagonal and the tail tiles have masked pairs
  auto p_exp = [&](int kt, auto masked) {
    const int k0 = 64 * kt;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          const float p = exp2_ftz(fmaf(x, sl2, -ll[h]));
          if constexpr (decltype(masked)::value) {
            const int col = k0 + 8 * j + 2 * t + e;
            x = col < s && (!causal || col <= row) ? p : 0.0f;
          } else {
            x = p;
          }
        }
    }
  };
  // ds = p (dp - delta), rounded to E (fp16: scaled first) into the A
  // fragments of the tile's 4 key chunks
  auto ds_pack = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * h + e;
          sc[x] *= dp[x] - dr[h];
        }
    if constexpr (std::is_same<E, fp16>::value)
      ds_scale_rows<8, NB>(sc, acc, ks);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      score_frag<E>(da[c], sc + 8 * c, sc + 8 * c + 4);
  };

  mbar_wait(own_full, 0);
  for (int kt = 0; kt < kt_end; ++kt) {
    mbar_wait(&full[kt % ST], (kt / ST) & 1);
    scores(kt);
    wgmma_wait<1>();   // S; dP may run on
    fence_regs(sc);
    if (64 * kt + 64 > s || (causal && 64 * kt == q0))
      p_exp(kt, std::true_type());
    else
      p_exp(kt, std::false_type());
    wgmma_wait<0>();
    fence_regs(dp);
    ds_pack();
    wgmma_fence();
    // dQ += dS K, dS from registers, K MN-major: the tile's 4 key chunks
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
        wgmma_rs_n64_mn<E>(acc[b], da[c],
                           desc_sw128(stage(kt) + b * kBoxBytes + c * 2048));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(da[c]);
    mbar_arrive(&empty[kt % ST]);   // the stage's last reader is done
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row < s)
      store_boxes<E, D, NB>(dq + static_cast<size_t>(bh) * s * D, acc, row,
                            h, t, ds_unscale<E>(scale, ks[h]));
  }
}

template <typename Kernel, typename... Args>
int launch_threads(Kernel kernel, size_t smem, dim3 grid, int threads,
                   cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The mma.sync kernels: kThreads a block.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t st,
           Args... args) {
  return launch_threads(kernel, smem, grid, kThreads, st, args...);
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

// The 16-bit forms (E bf16 or fp16), one template each; the extern "C"
// entry points below instance them.
namespace {

template <typename E>
int fwd16(const void* q, const void* k, const void* v, void* out, void* lse,
          int bh, int s, int d, int causal, float scale, void* stream) {
  if (bh <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tq, tk, tv;   // encoded per launch: the pointers move
  if (!hopper::encode_rows<E>(&tq, q, bh, s, d, hopper::kBox) ||
      !hopper::encode_rows<E>(&tk, k, bh, s, d, hopper::kBox) ||
      !hopper::encode_rows<E>(&tv, v, bh, s, d, hopper::kBox))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* op = static_cast<E*>(out);
  auto* lp = static_cast<float*>(lse);
  constexpr int rows = 64 * kFwdWarpgroups;   // query rows a block
#define PTT_CALL(DD)                                                       \
  {                                                                        \
    using T = FwdHopper<DD, kFwdWarpgroups, kFwdStages>;                   \
    return launch_threads(                                                 \
        fwd_wgmma_kernel<E, DD, kFwdWarpgroups, kFwdStages>, T::bytes,     \
        dim3(bh, (s + rows - 1) / rows), T::kThreads, st, tq, tk, tv, op,  \
        lp, s, causal, scale);                                             \
  }
  PTT_FLASH_DISPATCH(d, PTT_CALL)
#undef PTT_CALL
}

template <typename E>
int dq16(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dq, int bh, int s, int d,
         int causal, float scale, void* stream) {
  if (bh <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::encode_rows<E>(&tq, q, bh, s, d, hopper::kBox) ||
      !hopper::encode_rows<E>(&tk, k, bh, s, d, hopper::kBox) ||
      !hopper::encode_rows<E>(&tv, v, bh, s, d, hopper::kBox) ||
      !hopper::encode_rows<E>(&tdo, dout, bh, s, d, hopper::kBox))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<const float*>(delta);
  auto* dqp = static_cast<E*>(dq);
#define PTT_CALL(DD)                                                       \
  {                                                                        \
    using T = DqHopper<DD, kDqStages>;                                     \
    return launch_threads(dq_wgmma_kernel<E, DD, kDqStages>, T::bytes,     \
                          dim3(bh, n_tiles(s)), T::kThreads, st, tq, tk,   \
                          tv, tdo, lp, dp, dqp, s, causal, scale);         \
  }
  PTT_FLASH_DISPATCH(d, PTT_CALL)
#undef PTT_CALL
}

template <typename E>
int dkv16(const void* q, const void* k, const void* v, const void* dout,
          const void* lse, const void* delta, void* dk, void* dv, int bh,
          int s, int d, int causal, float scale, void* stream) {
  if (bh <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the streamed Q and dO boxes are the kernel's BQ rows (DkvHopper)
  const int bq = d > 64 ? 32 : 64;
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::encode_rows<E>(&tq, q, bh, s, d, bq) ||
      !hopper::encode_rows<E>(&tk, k, bh, s, d, hopper::kBox) ||
      !hopper::encode_rows<E>(&tv, v, bh, s, d, hopper::kBox) ||
      !hopper::encode_rows<E>(&tdo, dout, bh, s, d, bq))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<const float*>(delta);
  auto* dkp = static_cast<E*>(dk);
  auto* dvp = static_cast<E*>(dv);
  constexpr int keys = 64 * kDkvWarpgroups;   // keys a block
#define PTT_CALL(DD)                                                       \
  {                                                                        \
    using T = DkvHopper<DD, kDkvWarpgroups, kDkvStages>;                   \
    static_assert(T::BQ == (DD > 64 ? 32 : 64), "bq above");               \
    return launch_threads(                                                 \
        dkv_wgmma_kernel<E, DD, kDkvWarpgroups, kDkvStages>, T::bytes,     \
        dim3(bh, (s + keys - 1) / keys), T::kThreads, st, tq, tk, tv, tdo, \
        lp, dp, dkp, dvp, s, causal, scale);                               \
  }
  PTT_FLASH_DISPATCH(d, PTT_CALL)
#undef PTT_CALL
}

}  // namespace

// The bf16 forms: q, k, v, out (dout, dq, dk, dv): bf16 [bh, s, d]
// contiguous, 16-byte aligned; lse, delta: fp32 [bh, s].
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int s, int d,
                              int causal, float scale, void* stream) {
  return fwd16<bf16>(q, k, v, out, lse, bh, s, d, causal, scale, stream);
}

extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int bh, int s,
                             int d, int causal, float scale, void* stream) {
  return dq16<bf16>(q, k, v, dout, lse, delta, dq, bh, s, d, causal, scale,
                    stream);
}

extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int bh,
                              int s, int d, int causal, float scale,
                              void* stream) {
  return dkv16<bf16>(q, k, v, dout, lse, delta, dk, dv, bh, s, d, causal,
                     scale, stream);
}

// The fp16 forms (flash_fwd_fp16 <- _fwd_kernel, flash_dq_fp16 <-
// _dq_kernel, flash_dkv_fp16 <- _dkv_kernel): the same kernels on fp16
// q, k, v, out (dout, dq, dk, dv), with fp16 tensor maps and wgmma
// operands, P rounded to fp16 (to nearest even, __floats2half2_rn) and
// dS scaled before it is (ds_scale_rows); lse, delta fp32.
extern "C" int flash_fwd_fp16(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int s, int d,
                              int causal, float scale, void* stream) {
  return fwd16<fp16>(q, k, v, out, lse, bh, s, d, causal, scale, stream);
}

extern "C" int flash_dq_fp16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int bh, int s,
                             int d, int causal, float scale, void* stream) {
  return dq16<fp16>(q, k, v, dout, lse, delta, dq, bh, s, d, causal, scale,
                    stream);
}

extern "C" int flash_dkv_fp16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int bh,
                              int s, int d, int causal, float scale,
                              void* stream) {
  return dkv16<fp16>(q, k, v, dout, lse, delta, dk, dv, bh, s, d, causal,
                     scale, stream);
}
