// Int8 weight-only quantization and quantized matmul, for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/quant_matmul.py:
//   quantize_int8 <- _quantize_kernel (quant_matmul.py:63, launched by
//                    quantize_int8 :84)
//   quant_matmul  <- _qmm_kernel (quant_matmul.py:110, launched by
//                    quant_matmul :173), fp32 activations
//   quant_matmul_16 <- the same kernel on 16-bit activations (amp's bf16
//                    or fp16 x, the output in x's dtype or fp32, :117-124;
//                    quant_matmul_bf16 is its bf16 form)
// Plain PyTorch versions and wrappers: paddle_tpu_torch/ops/quant_matmul.py
// (quantize_int8_plain, quant_matmul_plain; quantize_int8, quant_matmul,
// which takes both forms by x's dtype).
//
// quantize_int8: w fp32 [k, n] -> q int8 [k, n], scales fp32 [n].
//   Per column: amax = max |w| over k, scale = max(amax * (1/127), 1e-12),
//   q = clip(rint(w / scale), -127, 127), or with stochastic rounding
//   clip(floor(w / scale + u), -127, 127), u in [0, 1) from a murmur3
//   finalizer hash of (flat index, seed) in uint32 (_hash_uniform :46-60).
//   The arithmetic is the reference's as XLA compiles it on the CPU: the
//   constant division amax / 127 becomes a multiply by the fp32 reciprocal,
//   while w / scale stays a true division (__fdiv_rn), and rintf rounds half
//   to even as jnp.round does. The result is bit-identical to the plain
//   version and to the reference.
//   Bound: device-memory bytes (read w once, write q and scales: 5 bytes per
//   element; 11.8 MB at [3072, 768], 3.5 us at 3.35 TB/s). Design: the k
//   reduction is split over a thread-block cluster. A block owns a tile of
//   32 adjacent columns and a slab of ceil(k / 8) rows; the 8 blocks of a
//   column tile form one cluster along k (cudaLaunchKernelEx), so n = 768
//   runs 24 x 8 = 192 blocks on the 132 SMs. Each block reads its slab
//   once, 8 threads a row with 16-byte loads (a warp reads four 128-byte
//   rows), kQBatch rows a thread in flight, keeps it in shared memory
//   and reduces its column maxima (warp shuffles, then the 8 warps through
//   shared memory). The blocks of the cluster read each other's 32 partial
//   maxima through distributed shared memory (map_shared_rank) after a
//   cluster barrier; each block then quantizes its own slab out of shared
//   memory and stores the int8 values as packed 4-byte words, and cluster
//   rank 0 writes the scales. A second cluster barrier, arrived at once
//   the peers' maxima are read and waited on at exit, keeps every block's
//   maxima alive until its peers have read them. So w is read from device
//   memory once. When a slab does not fit the shared-memory budget
//   (k > 8 * kQMaxSlabRows) the block reads its slab again to quantize it,
//   mostly from L2. n % 4 != 0 or an unaligned w falls back to element
//   loads and byte stores. What bounds it at BERT-base's shapes is
//   latency, not bytes: the two dependent passes and the barriers between
//   them take ~9 us even at [768, 2] (PERF.md).
//
// quant_matmul: x fp32 [m, k] @ (q int8 [k, n] * scales [n]) -> fp32 [m, n].
//   fp32 accumulator over k, multiplied by the column's scale once at the
//   end, as _qmm_kernel does (and as the plain version does).
//   Arithmetic: split TF32 on the tensor cores (mma.sync m16n8k8 tf32, fp32
//   accumulators in registers). Every int8 value is exact in TF32, so only
//   x is split: x_big = tf32_rna(x), x_small = tf32_rna(x - x_big)
//   (cvt.rna rounds; leaving the low 13 bits for the tensor core to
//   truncate would lose ~2^-10 a split), and two products x_small q +
//   x_big q give x q to ~2^-22 |x| |q| a term, against the check's
//   2 k 2^-24 (|x| @ |q|) s (tests/torch_checks.py qmm_limit).
//   Why mma.sync and not wgmma: wgmma's tf32 form takes both shared-memory
//   operands K-major only, and q is stored [k, n] (N-major for B), so it
//   would need a transposing int8 -> tf32 pass through shared memory ahead
//   of every product, plus descriptor swizzles; mma.sync takes fragments
//   from registers, where the int8 bytes are widened as they are read.
//   Bound: at m = 8192 operations (2 passes of 2 m n k at 495 TFLOP/s
//   TF32: 0.039 ms at (8192, 768, 768)); at m <= 64 bytes (the int8
//   weight: 0.59 MB at (16, 768, 768), 0.18 us at 3.35 TB/s).
//   Design: a 256-thread block (8 warps as 2 x 4) owns a (32 MT) x 128
//   output tile, MT = 4 (m > 64), 2 (m > 32) or 1; a warp owns MT 16-row
//   tiles x 32 columns. k-steps of 32 flow through a 3-stage ring in
//   shared memory filled by cp.async (16-byte copies, zero-filled past the
//   ragged edge; 4-byte copies for x when k % 4 != 0, plain byte loads for
//   q when n % 16 != 0), so two k-steps are in flight while one is
//   multiplied. q travels as int8 (a quarter of the bytes of the fp32
//   weight) and is widened in registers. Inside a k-step, mma slot t of
//   k-chunk s reads k = 8 s + 2 t and slot t + 4 reads k = 8 s + 2 t + 1,
//   and a warp's column slot (tile j, lane group g) is column 4 g + j:
//   one 8-byte load gives a thread both halves of its x fragment, one
//   4-byte load its four tiles' q bytes, and its outputs are 8 adjacent
//   columns. Row pitches of 40 floats and 144 bytes make these loads free
//   of bank conflicts. When the (m, n) tiles would leave SMs idle (m <= 64
//   in BERT: the pooler and the NSP head), k is split over up to 16 slices
//   whose fp32 partial sums go to a workspace and are added in slice order
//   by a second kernel, which also applies the scales: deterministic, no
//   atomics. Any m, n, k >= 1: rows, columns and k past the end are
//   zero-filled and never stored.
//
// quant_matmul_16: x bf16 or fp16 [m, k] @ (q int8 [k, n] * scales [n])
//   -> x's dtype, or fp32 (out_dtype=float32). fp32 accumulator over k,
//   times the column's fp32 scale at the end, rounded to the out type
//   once, as _qmm_kernel computes it for a 16-bit x (x.astype(f32) @
//   q.astype(f32), acc * s, astype(out dtype)); the fp32 out stores the
//   same product unrounded. The bf16 and fp16 forms are one template over
//   the element type E (and the out type O): only the widening of int8,
//   the instruction's type name and the TMA map's element type differ.
//   Arithmetic: 16-bit tensor-core products with fp32 accumulators. Every
//   int8 value is exact in bf16 (8 significant bits) and in fp16 (11),
//   and the tensor cores form each 16-bit product exactly, so the sums
//   are the reference's products added in fp32 in another order: the
//   fp32 limit of quant_matmul (2 k 2^-24 (|x| @ |q|) s) holds before
//   the store. int8 -> bf16 in registers: a byte b is v = int8(b), and
//   float(2^23 + (b ^ 0x80)) - (2^23 + 128) = v exactly (one byte
//   permute and one subtraction); two such floats are packed to bf16x2
//   (exact). int8 -> fp16: the fp16 bits 0x64 above b ^ 0x80 are 1024 +
//   (b ^ 0x80), and one fp16x2 subtraction of 1152 leaves v (two values
//   a byte permute and a subtraction). Bound: 2 m n k bf16 operations at the H100 SXM data sheet's
//   989 TFLOP/s (0.0098 ms at (8192, 768, 768), 0.0391 at (8192, 3072,
//   768)) or, at m <= 64, the int8 weight's bytes. Three routes, chosen
//   by shape in ops/quant_matmul.py (route16), never by failure:
//   - cluster (quant_matmul_bf16_cluster), every m <= 64: all 29 launches
//     of an int8 BERT-base forward under O2 at batch 1 x 64 tokens, the
//     pooler and the NSP head at any batch. What bounds it: the int8
//     weight's bytes (0.59 MB at (16, 768, 768), 0.18 us at 3.35 TB/s)
//     and, under a cold L2, the ~0.6-0.8 us latency of a round trip to
//     device memory, which at these sizes outweighs the bytes: the design
//     pays that round trip once a block, in one launch with no workspace.
//     The k reduction is split over a thread-block cluster: the grid is
//     n tiles of bn columns (16 or 32 where that holds n, else 64: 12
//     tiles at n = 768, 96 blocks, which ran faster than 192 blocks of 32
//     columns) by 8 blocks along k, each cluster (1, 8) one tile
//     (cudaLaunchKernelEx);
//     block rank r takes k [r ks, (r + 1) ks), ks = k / 8 rounded up to
//     16 (ranks past k hold zeros). A block issues every 16-byte cp.async
//     of its q slice (ks x bn bytes, 3 KB at (16, 768, 768)) and of x's
//     matching columns for all m rows before it waits for any, then
//     computes out^T = q^T x^T on mma.sync m16n8k16 bf16: 16 columns of n
//     fill the 16-row A side and m fills the 8-wide B side in NT = 1, 2, 4
//     or 8 slots (m = 1 wastes 7/8 of a small product, not 31/32 of a
//     large one). A comes from ldmatrix.x2.trans of q's 16-bit pairs and
//     the wgmma route's byte-permute widening (row g stands for column
//     2g, row g + 8 for 2g + 1); B from ldmatrix of x's rows. Warps split
//     the tile's 16-column groups and, where fewer than 4, its k16 steps.
//     Rank r owns columns [r bn / 8, (r + 1) bn / 8) of the tile. Each
//     warp keeps fp32 sums in registers and stores them straight into
//     the owner's shared memory through distributed shared memory
//     (map_shared_rank: stores, which need no round trip, not loads;
//     each block arrives on a cluster barrier as it starts and waits on
//     it before its first store, since a peer's shared memory exists only
//     once the peer runs); after the next cluster barrier the owner adds
//     the 8 ranks' sums (and its warps' along k) in rank order 0 .. 7
//     from its own shared memory, times the column's scale (prefetched
//     with the loads), rounded to bf16 once: deterministic, no atomics,
//     no second kernel.
//     No block reads a peer's memory after the barrier, so none has to
//     wait for its peers before it exits. The NSP head's q (2 bytes a row)
//     is read as the contiguous bytes it is (element loads, 8 a thread in
//     flight), not as a 128-column tile of which 126 are padding; k % 8
//     != 0, an x off the 16-byte grid and n % 16 != 0 take element loads
//     too. k past 4096 is taken 512 rows a chunk. The shared-memory limit
//     and a cudaOccupancyMaxActiveClusters check are set once per kernel
//     instance and device.
//   - wgmma (quant_matmul_bf16_wgmma), m > 64 where TMA describes both
//     operands (n % 16 == 0, k % 8 == 0, x and qw 16-byte aligned): 27
//     of the 29 launches of an int8 BERT-base forward under O2 at 16 x
//     512. It computes out^T = q^T x^T, so that the operand to widen is wgmma's
//     A, the one that may come from registers: q stays [k, n] in device
//     memory (no transposed copy: the weight's bytes at rest are a
//     metric of the int8 slice). A persistent block (one an SM) of one
//     producer warp and WG consumer warpgroups walks tiles of MT rows of
//     m by 64 WG columns of n through a ring of ST stages, each the x box
//     (MT rows of 64 k, TMA, 128-byte swizzle: the K-major B of the
//     product, as K in the flash kernels' Q.K^T) and a 64 x 64 int8 box
//     of q a warpgroup (TMA, 64-byte swizzle), filled by the producer
//     through mbarriers across tiles. Each stage of q is widened once: a
//     warp's ldmatrix.x4.trans of 16-bit pairs of q gives a lane the
//     bytes of two adjacent columns at k = 2t, 2t + 1 (and + 8), exactly
//     A's fragment for its rows g and g + 8 once those rows stand for
//     the columns 2g and 2g + 1; a byte permute per value widens it, in
//     registers, while the previous stage's products run (two register
//     sets). Nothing widened goes back to shared memory. One product
//     m64n192k16 per k16 (MT = 192), the accumulator 64 columns of n by
//     MT rows of m; epilogue: times the column's scale in fp32, rounded
//     to bf16 once, a lane's two adjacent columns stored as one bf16x2 (a
//     quad of lanes writes 32 contiguous bytes of a row). MT = 192, WG =
//     2, ST = 4: 258 tiles at m = 8192, n = 768, 1.95 waves on 132 SMs
//     (128 rows would give 2.9 and 256 rows 1.45, and 256 rows spill).
//     Measured (PERF.md, tools/torch_qmm_ab.py): the products alone run
//     at 73% of the bound at (8192, 3072, 768), with the ldmatrix and
//     the widening at 63%, with the loads at 59%: the widening's integer
//     and float operations, in the warps that issue the products, are
//     what stands between the kernel and bf16 torch.matmul (1.17-1.19x);
//     widening into shared memory for SS products instead ran 1.2x
//     slower. Rows, columns and k past the end arrive from TMA as zeros
//     and are never stored.
//   - mma.sync (quant_matmul_bf16), the other m > 64 shapes (the NSP
//     head's n = 2 at a large batch, ragged pitches, an x off the 16-byte
//     grid); it was also the route of m <= 64 before the cluster route,
//     and takes any m still: quant_matmul's tiles, ring and k slices (and
//     their workspace and second kernel) on bf16 x: a (32 MT) x 128 tile, 3 stages
//     of k-steps of 32 (two k16 products), x rows pitched 96 bytes so a
//     warp's 8-byte fragment loads are free of bank conflicts. In a k16
//     product, mma k-slots (2t, 2t + 1) stand for k = 4t, 4t + 1 and
//     slots (2t + 8, 2t + 9) for 4t + 2, 4t + 3: one 8-byte load gives a
//     thread both halves of its x fragment for a row, four 4-byte loads
//     of q rows 4t .. 4t + 3 its four column tiles' B fragments (q's
//     144-byte pitch leaves them 2-way bank-conflicted). Column slots as
//     in quant_matmul: a thread's outputs are 8 adjacent columns, one
//     16-byte store of bf16. Any m, n, k >= 1; k % 8 != 0 or an
//     unaligned x is loaded element by element.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kQCols = 32;           // columns per quantize block
constexpr int kQVecs = kQCols / 4;     // threads a row, 4 columns each
constexpr int kQThreads = 256;
constexpr int kQRowStep = kQThreads / kQVecs;   // rows a pass
static_assert(kQCols % 4 == 0 && 32 % kQVecs == 0, "whole rows a warp");
// rows a thread loads before it uses any (loads in flight a thread)
constexpr int kQBatch = 4;
constexpr int kQCluster = 8;    // blocks along k per column tile (portable)
constexpr int kQMaxSlabRows = 768;   // 96 KB of shared memory a block

__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t seed) {
  uint32_t h = (idx * 2654435761u) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return __uint2float_rn(h >> 8) * (1.0f / 16777216.0f);   // exact
}

// w[r, c .. c + 3], zero past column n
__device__ __forceinline__ float4 quant_load(const float* __restrict__ w,
                                             int r, int c, int n, bool vec) {
  const float* row = w + static_cast<size_t>(r) * n;
  if (vec && c + 4 <= n) return *reinterpret_cast<const float4*>(row + c);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = c + i < n ? row[c + i] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool STOCHASTIC>
__device__ __forceinline__ uint32_t quant_one(float w, float scale, int r,
                                              int c, int n, uint32_t seed) {
  const float x = __fdiv_rn(w, scale);
  float v;
  if (STOCHASTIC) {
    const uint32_t flat = static_cast<uint32_t>(r) *
                          static_cast<uint32_t>(n) +
                          static_cast<uint32_t>(c);
    v = floorf(__fadd_rn(x, hash_uniform(flat, seed)));
  } else {
    v = rintf(x);
  }
  return static_cast<uint8_t>(
      static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f)));
}

// Grid (column tiles, kQCluster), clusters of (1, kQCluster): block rank
// r of a tile owns rows [r * slab, (r + 1) * slab). STAGED: the slab is
// kept in dynamic shared memory (slab * kQCols floats) between the two
// passes; otherwise the second pass reads w again.
template <bool STOCHASTIC, bool STAGED>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const float* __restrict__ w, int8_t* __restrict__ q,
                float* __restrict__ scales, int k, int n, int slab,
                uint32_t seed, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_max[kQThreads / 32][kQCols];
  __shared__ float part_max[kQCols];      // read by the cluster's peers
  __shared__ float col_scale[kQCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, c4 = tid % kQVecs, rg = tid / kQVecs;
  const int col = blockIdx.x * kQCols + 4 * c4;
  const int r0 = rank * slab, r1 = min(k, r0 + slab);
  float4* tile = reinterpret_cast<float4*>(smem);   // [slab][kQVecs]
  float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, m3 = 0.0f;
  for (int rb = r0 + rg; rb < r1; rb += kQBatch * kQRowStep) {
    float4 v[kQBatch];
#pragma unroll
    for (int j = 0; j < kQBatch; ++j) {
      const int r = rb + j * kQRowStep;
      v[j] = r < r1 ? quant_load(w, r, col, n, vec)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < kQBatch; ++j) {
      const int r = rb + j * kQRowStep;
      if (STAGED && r < r1) tile[(r - r0) * kQVecs + c4] = v[j];
      m0 = fmaxf(m0, fabsf(v[j].x));
      m1 = fmaxf(m1, fabsf(v[j].y));
      m2 = fmaxf(m2, fabsf(v[j].z));
      m3 = fmaxf(m3, fabsf(v[j].w));
    }
  }
  // lanes kQVecs apart hold the same columns (max is exact in any order)
#pragma unroll
  for (int off = kQVecs; off < 32; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xFFFFFFFFu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xFFFFFFFFu, m1, off));
    m2 = fmaxf(m2, __shfl_xor_sync(0xFFFFFFFFu, m2, off));
    m3 = fmaxf(m3, __shfl_xor_sync(0xFFFFFFFFu, m3, off));
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane < kQVecs) {
    warp_max[warp][4 * lane] = m0;
    warp_max[warp][4 * lane + 1] = m1;
    warp_max[warp][4 * lane + 2] = m2;
    warp_max[warp][4 * lane + 3] = m3;
  }
  __syncthreads();
  if (tid < kQCols) {
    float m = warp_max[0][tid];
#pragma unroll
    for (int i = 1; i < kQThreads / 32; ++i) m = fmaxf(m, warp_max[i][tid]);
    part_max[tid] = m;
  }
  cluster.sync();                        // every block's part_max is ready
  if (tid < kQCols) {
    float amax = 0.0f;
#pragma unroll
    for (int b = 0; b < kQCluster; ++b)
      amax = fmaxf(amax, cluster.map_shared_rank(part_max, b)[tid]);
    const float scale = fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-12f);
    col_scale[tid] = scale;
    const int c = blockIdx.x * kQCols + tid;
    if (rank == 0 && c < n) scales[c] = scale;
  }
  // done with the peers' part_max: say so now, wait for them at the end
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  const float s0 = col_scale[4 * c4], s1 = col_scale[4 * c4 + 1];
  const float s2 = col_scale[4 * c4 + 2], s3 = col_scale[4 * c4 + 3];
  if (col < n) {
    for (int rb = r0 + rg; rb < r1; rb += kQBatch * kQRowStep) {
      float4 v[kQBatch];
#pragma unroll
      for (int j = 0; j < kQBatch; ++j) {
        const int r = rb + j * kQRowStep;
        if (r < r1)
          v[j] = STAGED ? tile[(r - r0) * kQVecs + c4]
                        : quant_load(w, r, col, n, vec);
      }
#pragma unroll
      for (int j = 0; j < kQBatch; ++j) {
        const int r = rb + j * kQRowStep;
        if (r >= r1) break;
        const uint32_t word =
            quant_one<STOCHASTIC>(v[j].x, s0, r, col, n, seed) |
            quant_one<STOCHASTIC>(v[j].y, s1, r, col + 1, n, seed) << 8 |
            quant_one<STOCHASTIC>(v[j].z, s2, r, col + 2, n, seed) << 16 |
            quant_one<STOCHASTIC>(v[j].w, s3, r, col + 3, n, seed) << 24;
        int8_t* out = q + static_cast<size_t>(r) * n + col;
        if (vec && col + 4 <= n) {
          *reinterpret_cast<uint32_t*>(out) = word;
        } else {
          for (int i = 0; i < 4 && col + i < n; ++i)
            out[i] = static_cast<int8_t>((word >> (8 * i)) & 0xFFu);
        }
      }
    }
  }
  // no block leaves while a peer may still read its part_max
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <bool STOCHASTIC, bool STAGED>
cudaError_t quantize_launch(const float* w, int8_t* q, float* scales, int k,
                            int n, int slab, uint32_t seed, int vec,
                            cudaStream_t st) {
  auto kernel = quantize_kernel<STOCHASTIC, STAGED>;
  const size_t smem =
      STAGED ? static_cast<size_t>(slab) * kQCols * sizeof(float) : 0;
  if (STAGED) {   // the slab plus the static arrays may pass 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kQMaxSlabRows * kQCols * sizeof(float)));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kQCols - 1) / kQCols, kQCluster, 1);
  cfg.blockDim = dim3(kQThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = kQCluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, w, q, scales, k, n, slab, seed,
                            vec);
}

constexpr int kBN = 128, kBK = 32;   // matmul tile columns, k-step
constexpr int kStages = 3;            // cp.async ring depth
constexpr int kThreads = 256;         // 8 warps: 2 (rows) x 4 (columns)
constexpr int kXPitch = kBK + 8;      // floats per x row in shared memory
constexpr int kQPitch = kBN + 16;     // bytes per q row in shared memory
constexpr int kMaxSplits = 16;
constexpr int kSMs = 132;

template <int MT>
__host__ __device__ constexpr int stage_bytes() {
  return 32 * MT * kXPitch * 4 + kBK * kQPitch;
}

__device__ __forceinline__ uint32_t int8_as_tf32(uint32_t word, int byte) {
  const int v = static_cast<int8_t>((word >> (8 * byte)) & 0xFFu);
  return __float_as_uint(static_cast<float>(v));   // exact
}

// x rows [row0, row0 + 32 MT) and q columns [col0, col0 + 128) of the
// k-step at kt0, into ring stage `st`. k-steps never straddle `kend`
// except at k itself, so a 4-float chunk of x (k % 4 == 0) and a 16-byte
// chunk of q (n % 16 == 0) are wholly inside or wholly outside.
template <int MT, bool XV, bool QV>
__device__ __forceinline__ void qmm_load(
    unsigned char* smem, int st, const float* __restrict__ x,
    const int8_t* __restrict__ qw, int m, int n, int k, int kend, int row0,
    int col0, int kt0) {
  constexpr int BM = 32 * MT;
  float* xs = reinterpret_cast<float*>(smem + st * stage_bytes<MT>());
  int8_t* qs = reinterpret_cast<int8_t*>(smem + st * stage_bytes<MT>() +
                                         BM * kXPitch * 4);
  const int tid = threadIdx.x;
  if (XV) {
#pragma unroll
    for (int i = 0; i < BM * (kBK / 4) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 3, c = (e & 7) * 4;
      const int gr = row0 + r, gk = kt0 + c;
      const bool ok = gr < m && gk < kend;
      cp_async16(xs + r * kXPitch + c,
                 ok ? x + static_cast<size_t>(gr) * k + gk : x, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BM * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 5, c = e & 31;
      const int gr = row0 + r, gk = kt0 + c;
      const bool ok = gr < m && gk < kend;
      cp_async4(xs + r * kXPitch + c,
                ok ? x + static_cast<size_t>(gr) * k + gk : x, ok);
    }
  }
  if (QV) {
    const int r = tid >> 3, c = (tid & 7) * 16;
    const int gk = kt0 + r, gc = col0 + c;
    const bool ok = gk < kend && gc < n;
    cp_async16(qs + r * kQPitch + c,
               ok ? qw + static_cast<size_t>(gk) * n + gc : qw, ok);
  } else {
#pragma unroll 4
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 7, c = e & 127;
      const int gk = kt0 + r, gc = col0 + c;
      qs[r * kQPitch + c] =
          (gk < kend && gc < n) ? qw[static_cast<size_t>(gk) * n + gc] : 0;
    }
  }
}

// Grid (n tiles, m tiles, k slices). One slice: out = acc * scales; more:
// ws[slice] = acc, reduced by qmm_reduce.
template <int MT, bool XV, bool QV>
__global__ void __launch_bounds__(kThreads, 2)
qmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ qw,
           const float* __restrict__ scales, float* __restrict__ out,
           float* __restrict__ ws, int m, int n, int k, int kchunk) {
  constexpr int BM = 32 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(k, kbeg + kchunk);
  const int nkt = (kend - kbeg + kBK - 1) / kBK;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt)
      qmm_load<MT, XV, QV>(smem, s, x, qw, m, n, k, kend, row0, col0,
                           kbeg + s * kBK);
    cp_async_commit();
  }

  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage `it` landed; stage it - 1 is free again
    const int nx = it + kStages - 1;
    if (nx < nkt)
      qmm_load<MT, XV, QV>(smem, nx % kStages, x, qw, m, n, k, kend, row0,
                           col0, kbeg + nx * kBK);
    cp_async_commit();

    const int st = it % kStages;
    const float* xs = reinterpret_cast<const float*>(
                          smem + st * stage_bytes<MT>()) +
                      (wm * MT * 16 + g) * kXPitch + 2 * t;
    const unsigned char* qs = smem + st * stage_bytes<MT>() +
                              BM * kXPitch * 4 + 2 * t * kQPitch +
                              wn * 32 + 4 * g;
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {
      const uint32_t w0 =
          *reinterpret_cast<const uint32_t*>(qs + 8 * s * kQPitch);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
          qs + (8 * s + 1) * kQPitch);
      uint32_t b0[4], b1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b0[j] = int8_as_tf32(w0, j);
        b1[j] = int8_as_tf32(w1, j);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float2 lo = *reinterpret_cast<const float2*>(
            xs + i * 16 * kXPitch + 8 * s);
        const float2 hi = *reinterpret_cast<const float2*>(
            xs + (i * 16 + 8) * kXPitch + 8 * s);
        uint32_t big[4], small[4];
        split_tf32(lo.x, big[0], small[0]);   // row g,     slot t
        split_tf32(hi.x, big[1], small[1]);   // row g + 8, slot t
        split_tf32(lo.y, big[2], small[2]);   // row g,     slot t + 4
        split_tf32(hi.y, big[3], small[3]);   // row g + 8, slot t + 4
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(acc[i][j], small, b0[j], b1[j]);
          mma_tf32(acc[i][j], big, b0[j], b1[j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool whole = gridDim.z == 1;
  float* dst = whole ? out : ws + static_cast<size_t>(blockIdx.z) * m * n;
  const int col = col0 + wn * 32 + 8 * t;   // this thread's 8 columns
  float sc[8];
#pragma unroll
  for (int o = 0; o < 8; ++o)
    sc[o] = (whole && col + o < n) ? scales[col + o] : 1.0f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * MT * 16 + i * 16 + g + 8 * h;
      if (row >= m) continue;
      float v[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float a = acc[i][o & 3][(o >> 2) + 2 * h];
        v[o] = whole ? __fmul_rn(a, sc[o]) : a;
      }
      float* p = dst + static_cast<size_t>(row) * n + col;
      if ((n & 3) == 0 && col + 8 <= n) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(p + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int o = 0; o < 8; ++o)
          if (col + o < n) p[o] = v[o];
      }
    }
}

// out = (sum of the slices' partial sums, in slice order) * scales.
__global__ void qmm_reduce(const float* __restrict__ ws,
                           const float* __restrict__ scales,
                           float* __restrict__ out, int m, int n,
                           int splits) {
  const size_t total = static_cast<size_t>(m) * n;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, ws[z * total + i]);
    out[i] = __fmul_rn(s, scales[i % n]);
  }
}

inline int qmm_mt(int m) { return m > 64 ? 4 : (m > 32 ? 2 : 1); }

// k slices for (m, n, k): enough blocks for every SM twice over when the
// (m, n) tiles alone leave SMs idle, at most kMaxSplits, whole k-steps each.
inline int qmm_splits(int m, int n, int k, int* kchunk) {
  const int tiles = ((n + kBN - 1) / kBN) * ((m + 32 * qmm_mt(m) - 1) /
                                             (32 * qmm_mt(m)));
  const int ksteps = (k + kBK - 1) / kBK;
  int want = tiles >= kSMs ? 1 : (2 * kSMs + tiles - 1) / tiles;
  want = std::max(1, std::min(want, std::min(ksteps, kMaxSplits)));
  const int per = (ksteps + want - 1) / want;
  *kchunk = per * kBK;
  return (ksteps + per - 1) / per;
}

template <int MT, bool XV, bool QV>
int qmm_launch(const float* x, const int8_t* qw, const float* sc, float* out,
               float* ws, int m, int n, int k, cudaStream_t st) {
  int kchunk = 0;
  const int splits = qmm_splits(m, n, k, &kchunk);
  if (splits > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qmm_kernel<MT, XV, QV>;
  const int smem = kStages * stage_bytes<MT>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (m + 32 * MT - 1) / (32 * MT), splits);
  kernel<<<grid, kThreads, smem, st>>>(x, qw, sc, out, ws, m, n, k, kchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(m) * n;
  const int blocks = static_cast<int>(
      std::min<size_t>((total + 255) / 256, static_cast<size_t>(4 * kSMs)));
  qmm_reduce<<<blocks, 256, 0, st>>>(ws, sc, out, m, n, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int qmm_dispatch(bool xv, bool qv, const float* x, const int8_t* qw,
                 const float* sc, float* out, float* ws, int m, int n, int k,
                 cudaStream_t st) {
  if (xv && qv) return qmm_launch<MT, true, true>(x, qw, sc, out, ws, m, n, k, st);
  if (xv) return qmm_launch<MT, true, false>(x, qw, sc, out, ws, m, n, k, st);
  if (qv) return qmm_launch<MT, false, true>(x, qw, sc, out, ws, m, n, k, st);
  return qmm_launch<MT, false, false>(x, qw, sc, out, ws, m, n, k, st);
}

// ------------------------------------------------------- bf16 activations
constexpr int kXPitchH = 48;          // bf16 per x row in shared memory

template <int MT>
__host__ __device__ constexpr int stage_bytes_h() {
  return 32 * MT * kXPitchH * 2 + kBK * kQPitch;
}

// Bytes j of the int8 word w as float (exact, see the header).
__device__ __forceinline__ float int8_byte_as_float(uint32_t flipped,
                                                    int j) {
  const uint32_t bits = __byte_perm(flipped, 0x4B000000u, 0x7440u | j);
  return __fsub_rn(__uint_as_float(bits), 8388736.0f);
}

// Two fp32 values rounded to a pair of the 16-bit type E (bf16 or
// fp16), nearest even, lo in the low half: exact for small integers.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<E, __half>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The out types O of the 16-bit kernels: x's type E, or fp32 from the
// same accumulator (out_dtype=float32). p[0], p[1] = a, b as one store
// (p aligned to the pair), and p[0] = a.
template <typename O>
__device__ __forceinline__ void store_pair(O* p, float a, float b) {
  if constexpr (std::is_same_v<O, float>)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(p) = pack2<O>(a, b);
}

template <typename O>
__device__ __forceinline__ void store_one(O* p, float a) {
  if constexpr (std::is_same_v<O, float>)
    *p = a;
  else if constexpr (std::is_same_v<O, __half>)
    *p = __float2half_rn(a);
  else
    *p = __float2bfloat16_rn(a);
}

template <typename E, int MT, bool XV, bool QV>
__device__ __forceinline__ void qmm_h_load(
    unsigned char* smem, int st, const E* __restrict__ x,
    const int8_t* __restrict__ qw, int m, int n, int k, int kend, int row0,
    int col0, int kt0) {
  constexpr int BM = 32 * MT;
  E* xs = reinterpret_cast<E*>(smem + st * stage_bytes_h<MT>());
  int8_t* qs = reinterpret_cast<int8_t*>(smem + st * stage_bytes_h<MT>() +
                                         BM * kXPitchH * 2);
  const int tid = threadIdx.x;
  if (XV) {   // 16-byte chunks: 4 a row of 32 bf16
    for (int e = tid; e < BM * (kBK / 8); e += kThreads) {
      const int r = e >> 2, c = (e & 3) * 8;
      const int gr = row0 + r, gk = kt0 + c;
      const bool ok = gr < m && gk < kend;
      cp_async16(xs + r * kXPitchH + c,
                 ok ? x + static_cast<size_t>(gr) * k + gk : x, ok);
    }
  } else {   // the 16 bits as they are, zeros past the ends
    const uint16_t* xg = reinterpret_cast<const uint16_t*>(x);
    uint16_t* xh = reinterpret_cast<uint16_t*>(xs);
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int r = e >> 5, c = e & 31;
      const int gr = row0 + r, gk = kt0 + c;
      xh[r * kXPitchH + c] = (gr < m && gk < kend)
                                 ? xg[static_cast<size_t>(gr) * k + gk]
                                 : uint16_t{0};
    }
  }
  if (QV) {
    const int r = tid >> 3, c = (tid & 7) * 16;
    const int gk = kt0 + r, gc = col0 + c;
    const bool ok = gk < kend && gc < n;
    cp_async16(qs + r * kQPitch + c,
               ok ? qw + static_cast<size_t>(gk) * n + gc : qw, ok);
  } else {
#pragma unroll 4
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 7, c = e & 127;
      const int gk = kt0 + r, gc = col0 + c;
      qs[r * kQPitch + c] =
          (gk < kend && gc < n) ? qw[static_cast<size_t>(gk) * n + gc] : 0;
    }
  }
}

// d += A.B on mma.sync m16n8k16 with operands of the 16-bit type E; the
// bf16 and fp16 instructions are one text of the type's name (TY).
#define PTT_MMA16(TY)                                                       \
  asm volatile(                                                             \
      "mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "            \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                      \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1))

template <typename E>
__device__ __forceinline__ void mma16(float* d, uint32_t a0, uint32_t a1,
                                      uint32_t a2, uint32_t a3, uint32_t b0,
                                      uint32_t b1) {
  if constexpr (std::is_same_v<E, __half>)
    PTT_MMA16("f16");
  else
    PTT_MMA16("bf16");
}
#undef PTT_MMA16

// Grid (n tiles, m tiles, k slices). One slice: out = O(acc * scales);
// more: ws[slice] = acc, reduced by qmm_reduce_h.
template <typename E, typename O, int MT, bool XV, bool QV>
__global__ void __launch_bounds__(kThreads, 2)
qmm_bf16_kernel(const E* __restrict__ x, const int8_t* __restrict__ qw,
                const float* __restrict__ scales, O* __restrict__ out,
                float* __restrict__ ws, int m, int n, int k, int kchunk) {
  constexpr int BM = 32 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(k, kbeg + kchunk);
  const int nkt = (kend - kbeg + kBK - 1) / kBK;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt)
      qmm_h_load<E, MT, XV, QV>(smem, s, x, qw, m, n, k, kend, row0, col0,
                                kbeg + s * kBK);
    cp_async_commit();
  }

  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage `it` landed; stage it - 1 is free again
    const int nx = it + kStages - 1;
    if (nx < nkt)
      qmm_h_load<E, MT, XV, QV>(smem, nx % kStages, x, qw, m, n, k, kend,
                                row0, col0, kbeg + nx * kBK);
    cp_async_commit();

    const int st = it % kStages;
    const E* xs = reinterpret_cast<const E*>(
                      smem + st * stage_bytes_h<MT>()) +
                  (wm * MT * 16 + g) * kXPitchH + 4 * t;
    const unsigned char* qs = smem + st * stage_bytes_h<MT>() +
                              BM * kXPitchH * 2 + 4 * t * kQPitch +
                              wn * 32 + 4 * g;
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)   // q rows 16 s + 4 t + r, flipped
        w[r] = *reinterpret_cast<const uint32_t*>(
                   qs + (16 * s + r) * kQPitch) ^ 0x80808080u;
      uint32_t b0[4], b1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b0[j] = pack2<E>(int8_byte_as_float(w[0], j),
                         int8_byte_as_float(w[1], j));
        b1[j] = pack2<E>(int8_byte_as_float(w[2], j),
                         int8_byte_as_float(w[3], j));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint2 lo = *reinterpret_cast<const uint2*>(
            xs + i * 16 * kXPitchH + 16 * s);
        const uint2 hi = *reinterpret_cast<const uint2*>(
            xs + (i * 16 + 8) * kXPitchH + 16 * s);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16<E>(acc[i][j], lo.x, hi.x, lo.y, hi.y, b0[j], b1[j]);
      }
    }
  }
  cp_async_wait<0>();

  const bool whole = gridDim.z == 1;
  const int col = col0 + wn * 32 + 8 * t;   // this thread's 8 columns
  float sc[8];
#pragma unroll
  for (int o = 0; o < 8; ++o)
    sc[o] = (whole && col + o < n) ? scales[col + o] : 1.0f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * MT * 16 + i * 16 + g + 8 * h;
      if (row >= m) continue;
      float v[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) v[o] = acc[i][o & 3][(o >> 2) + 2 * h];
      if (!whole) {
        float* p = ws + static_cast<size_t>(blockIdx.z) * m * n +
                   static_cast<size_t>(row) * n + col;
        if ((n & 3) == 0 && col + 8 <= n) {
          *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(p + 4) =
              make_float4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int o = 0; o < 8; ++o)
            if (col + o < n) p[o] = v[o];
        }
        continue;
      }
      O* p = out + static_cast<size_t>(row) * n + col;
#pragma unroll
      for (int o = 0; o < 8; ++o) v[o] = __fmul_rn(v[o], sc[o]);
      // 8 columns: one 16-byte store of a 16-bit O, two of fp32
      constexpr int kVec = std::is_same_v<O, float> ? 4 : 8;
      if (n % kVec == 0 && col + 8 <= n) {
        if constexpr (std::is_same_v<O, float>) {
          *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(p + 4) =
              make_float4(v[4], v[5], v[6], v[7]);
        } else {
          *reinterpret_cast<uint4*>(p) =
              make_uint4(pack2<O>(v[0], v[1]), pack2<O>(v[2], v[3]),
                         pack2<O>(v[4], v[5]), pack2<O>(v[6], v[7]));
        }
      } else {
#pragma unroll
        for (int o = 0; o < 8; ++o)
          if (col + o < n) store_one<O>(p + o, v[o]);
      }
    }
}

// out = O((sum of the slices' partial sums, in slice order) * scales).
template <typename O>
__global__ void qmm_reduce_h(const float* __restrict__ ws,
                             const float* __restrict__ scales,
                             O* __restrict__ out, int m, int n, int splits) {
  const size_t total = static_cast<size_t>(m) * n;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, ws[z * total + i]);
    store_one<O>(out + i, __fmul_rn(s, scales[i % n]));
  }
}

template <typename E, typename O, int MT, bool XV, bool QV>
int qmm_h_launch(const E* x, const int8_t* qw, const float* sc, O* out,
                 float* ws, int m, int n, int k, cudaStream_t st) {
  int kchunk = 0;
  const int splits = qmm_splits(m, n, k, &kchunk);
  if (splits > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qmm_bf16_kernel<E, O, MT, XV, QV>;
  const int smem = kStages * stage_bytes_h<MT>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (m + 32 * MT - 1) / (32 * MT), splits);
  kernel<<<grid, kThreads, smem, st>>>(x, qw, sc, out, ws, m, n, k, kchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(m) * n;
  const int blocks = static_cast<int>(
      std::min<size_t>((total + 255) / 256, static_cast<size_t>(4 * kSMs)));
  qmm_reduce_h<O><<<blocks, 256, 0, st>>>(ws, sc, out, m, n, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, typename O, int MT>
int qmm_h_dispatch(bool xv, bool qv, const E* x, const int8_t* qw,
                   const float* sc, O* out, float* ws, int m, int n, int k,
                   cudaStream_t st) {
  if (xv && qv)
    return qmm_h_launch<E, O, MT, true, true>(x, qw, sc, out, ws, m, n, k, st);
  if (xv)
    return qmm_h_launch<E, O, MT, true, false>(x, qw, sc, out, ws, m, n, k,
                                               st);
  if (qv)
    return qmm_h_launch<E, O, MT, false, true>(x, qw, sc, out, ws, m, n, k,
                                               st);
  return qmm_h_launch<E, O, MT, false, false>(x, qw, sc, out, ws, m, n, k,
                                              st);
}

// --------------------------------------------- bf16 activations on wgmma
// The route for m > 64 (header). out^T = q^T x^T: a warpgroup's A is 64
// columns of q (its n-slots) by 16 k, widened in registers; B is the x
// tile (MT rows of m by 64 k, K-major, as K in Q.K^T of the flash
// kernels); the accumulator holds 64 n-slots by MT rows of m.
constexpr int kQmmWarpgroups = 2;   // consumers, 64 columns of n each
constexpr int kQmmRows = 192;       // rows of m a tile: the products' N
constexpr int kQmmStages = 4;       // k-steps of 64 in the ring
constexpr int kK16 = 4;             // k16 products a k-step of 64


template <int WG, int MT, int ST>
struct QmmHopper {
  static constexpr int kX = MT * 128;        // x box: MT rows of 64 bf16
  static constexpr int kQ = 64 * 64;         // a warpgroup's q box
  static constexpr int kStage = kX + WG * kQ;
  static constexpr int kThreads = 128 * WG + 32;
  static constexpr size_t bytes =
      hopper::kSwizzleAlign + ST * kStage + 8 * 2 * ST;
  static_assert(MT == 128 || MT == 192 || MT == 256,
                "MT: 128, 192 or 256 rows (products of N = 128 or 192)");
  static_assert(kStage % hopper::kSwizzleAlign == 0, "aligned boxes");
};

// The 4 int8 of v (bytes b0..b3) as two pairs of E: (b0, b2) in lo and
// (b1, b3) in hi, the first of each pair in the low half. Each byte is
// exact. bf16 (header): 2^23 + (b ^ 0x80) as fp32 bits, minus 2^23 +
// 128, then the upper half of the fp32, which drops only zero bits.
// fp16: 0x64 above the byte b ^ 0x80 is the fp16 1024 + (b ^ 0x80) (an
// ulp of 1 in [1024, 2048)), and one fp16x2 subtraction of 1152 (0x6480)
// from both halves leaves int8(b), exactly.
template <typename E>
__device__ __forceinline__ void widen_int8x4(uint32_t v, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  if constexpr (std::is_same_v<E, __half>) {
    const uint32_t kBias = 0x64806480u;
    uint32_t l = __byte_perm(u, 0x6464u, 0x4240);
    uint32_t h = __byte_perm(u, 0x6464u, 0x4341);
    const __half2 lv = __hsub2(*reinterpret_cast<const __half2*>(&l),
                               *reinterpret_cast<const __half2*>(&kBias));
    const __half2 hv = __hsub2(*reinterpret_cast<const __half2*>(&h),
                               *reinterpret_cast<const __half2*>(&kBias));
    lo = *reinterpret_cast<const uint32_t*>(&lv);
    hi = *reinterpret_cast<const uint32_t*>(&hv);
    return;
  }
  constexpr uint32_t kBase = 0x4B000000u;
  constexpr float kBias = 8388736.0f;
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, kBase, 0x7650)),
                             kBias);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, kBase, 0x7651)),
                             kBias);
  const float f2 = __fsub_rn(__uint_as_float(__byte_perm(u, kBase, 0x7652)),
                             kBias);
  const float f3 = __fsub_rn(__uint_as_float(__byte_perm(u, kBase, 0x7653)),
                             kBias);
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  hi = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::fence_regs(a[i]);
}

// Persistent: a block an SM walks the tiles blockIdx.x, + gridDim.x, ...
// (n tile fastest, so the blocks in flight share rows of x). One producer
// warp keeps the ring full across tiles, so the next tile's loads run
// during this one's epilogue; consumer warpgroup wg owns columns
// n0 + 64 wg .. + 63 of each tile.
template <typename E, typename O, int WG, int MT, int ST>
__global__ void __launch_bounds__(QmmHopper<WG, MT, ST>::kThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tq,
                 const float* __restrict__ scales, O* __restrict__ out, int m,
                 int n, int k) {
  using namespace hopper;
  using T = QmmHopper<WG, MT, ST>;
  constexpr int P = MT / 64;   // n64 accumulators: 64 rows of m each
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_swizzle(smem_raw);   // [ST] stages: x, q
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * T::kStage);
  uint64_t* empty = full + ST;
  const int n_tiles = (n + 64 * WG - 1) / (64 * WG);
  const int tiles = n_tiles * ((m + MT - 1) / MT);
  const int nkt = (k + 63) / 64;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == WG) {   // the producer warp: one thread issues every load
    if (threadIdx.x == 128 * WG) {
      tma_prefetch(&tx);
      tma_prefetch(&tq);
      int g = 0;   // this block's k-steps so far, over its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = tile % n_tiles * 64 * WG, m0 = tile / n_tiles * MT;
        for (int kt = 0; kt < nkt; ++kt, ++g) {
          const int st = g % ST, use = g / ST;
          if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
          unsigned char* s = ring + st * T::kStage;
          mbar_expect_tx(&full[st], T::kStage);
          tma_load_3d(s, &tx, 64 * kt, m0, 0, &full[st]);
          for (int w = 0; w < WG; ++w)
            tma_load_2d(s + T::kX + w * T::kQ, &tq, n0 + 64 * w, 64 * kt,
                        &full[st]);
        }
      }
    }
    return;
  }

  // a consumer: warp `warp` of warpgroup wg, lane 4 g + t. Its A rows
  // (n-slots) 16 warp + g and + 8 stand for columns 16 warp + 2 g and
  // + 1 of the warpgroup's 64, so that one 16-bit element of q (two
  // adjacent columns) feeds both.
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  float acc[P][32];
  uint32_t a0[kK16][4], a1[kK16][4];   // A of two k-steps in flight
  int g0 = 0;   // the block's k-step index of this tile's first k-step

  // A of k-step kt: ldmatrix.trans of q's rows k (lane's row 32 h + lane)
  // at this warp's 16 columns, two k16 products a load
  auto load_a = [&](int kt, uint32_t (&a)[kK16][4]) {
    const uint32_t qs = smem_u32(ring + (g0 + kt) % ST * T::kStage + T::kX +
                                 wg * T::kQ);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 32 * h + lane;
      uint32_t v[4];
      ldmatrix_x4_trans(v, qs + r * 64 + 16 * (warp ^ ((r >> 1) & 3)));
      widen_int8x4<E>(v[0], a[2 * h][0], a[2 * h][1]);
      widen_int8x4<E>(v[1], a[2 * h][2], a[2 * h][3]);
      widen_int8x4<E>(v[2], a[2 * h + 1][0], a[2 * h + 1][1]);
      widen_int8x4<E>(v[3], a[2 * h + 1][2], a[2 * h + 1][3]);
    }
  };
  // the products of k-step kt; issued, not waited for
  auto mma = [&](int kt, const uint32_t (&a)[kK16][4]) {
    const uint32_t xs = smem_u32(ring + (g0 + kt) % ST * T::kStage);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kK16; ++ks) {
      if constexpr (P == 3) {   // one product over the 192 rows of x
        wgmma_rs_n192_k<E>(acc[0], acc[1], acc[2], a[ks],
                           desc_sw128(xs + 32 * ks));
      } else {
#pragma unroll
        for (int p = 0; p < P; p += 2)   // 128 rows of x a product
          wgmma_rs_n128_k<E>(acc[p], acc[p + 1], a[ks],
                             desc_sw128(xs + p * kBoxBytes + 32 * ks));
      }
    }
    wgmma_commit();
  };
  auto full_wait = [&](int kt) {
    mbar_wait(&full[(g0 + kt) % ST], (g0 + kt) / ST & 1);
  };
  auto release = [&](int kt) { mbar_arrive(&empty[(g0 + kt) % ST]); };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, g0 += nkt) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
    // k-step kt + 1 is loaded and widened while the products of kt run; a
    // stage is released once the products that read it are done
    full_wait(0);
    load_a(0, a0);
    for (int kt = 0; kt < nkt; kt += 2) {
      mma(kt, a0);
      if (kt > 0) {
        wgmma_wait<1>();
        fence_frags(a1);
        release(kt - 1);
      }
      if (kt + 1 >= nkt) break;
      full_wait(kt + 1);
      load_a(kt + 1, a1);
      mma(kt + 1, a1);
      wgmma_wait<1>();
      fence_frags(a0);
      release(kt);
      if (kt + 2 < nkt) {
        full_wait(kt + 2);
        load_a(kt + 2, a0);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < P; ++p) fence_regs(acc[p]);
    release(nkt - 1);

    // out[row, col], out[row, col + 1] = O(acc * scale): 32 contiguous
    // bytes of a row a quad of lanes (64 of fp32)
    const int col = tile % n_tiles * 64 * WG + 64 * wg + 16 * warp + 2 * g;
    const int m0 = tile / n_tiles * MT;
    if (col < n) {   // n % 16 == 0: col + 1 < n as well
      const float s0 = scales[col], s1 = scales[col + 1];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = m0 + 64 * p + 8 * j + 2 * t + e;
            if (row >= m) continue;
            store_pair<O>(out + static_cast<size_t>(row) * n + col,
                          __fmul_rn(acc[p][4 * j + e], s0),
                          __fmul_rn(acc[p][4 * j + 2 + e], s1));
          }
    }
  }
}

// The SM count of the current device, read once.
inline int sm_count() {
  static const int count = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return kSMs;
    return sms;
  }();
  return count;
}

template <typename E, typename O, int WG, int MT, int ST>
int qmm_wgmma_launch(const void* x, const void* qw, const float* sc, O* out,
                     int m, int n, int k, cudaStream_t st) {
  using T = QmmHopper<WG, MT, ST>;
  CUtensorMap tx, tq;   // encoded per launch: the pointers move
  if (!hopper::encode_rows<E>(&tx, x, 1, m, k, MT) ||
      !hopper::encode_rows_int8(&tq, qw, k, n))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qmm_wgmma_kernel<E, O, WG, MT, ST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long tiles = static_cast<long>((n + 64 * WG - 1) / (64 * WG)) *
                     ((m + MT - 1) / MT);
  const int grid = static_cast<int>(std::min<long>(tiles, sm_count()));
  kernel<<<grid, T::kThreads, T::bytes, st>>>(tx, tq, sc, out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------- bf16 activations at m <= 64 on a cluster
// The route for m <= 64 (header). out^T = q^T x^T on mma.sync m16n8k16: A
// is 16 columns of q by 16 k, widened from ldmatrix.trans of 16-bit pairs
// as on the wgmma route (row g stands for column 2g, row g + 8 for 2g +
// 1); B is 8 rows of x by 16 k (ldmatrix of x's rows); a warp's
// accumulator holds its 16 columns by NT slots of 8 rows of m.
constexpr int kCluster = 8;       // blocks along k a column tile (portable)
constexpr int kCWarps = 4;
constexpr int kCThreads = 32 * kCWarps;
constexpr int kCMaxChunk = 512;   // k rows of x and q a block holds at once
constexpr int kMaxDevices = 64;

// Bytes a row of the q tile and of the x chunk in shared memory: an odd
// number of 16-byte units, so the 8 rows an ldmatrix reads fall in 8
// distinct bank groups (bn and chunk are multiples of 16).
__host__ __device__ constexpr int cluster_qpitch(int bn) {
  return bn / 16 % 2 ? bn : bn + 16;
}
__host__ __device__ constexpr int cluster_xpitch(int chunk) {
  return 2 * chunk + 16;
}
// Dynamic shared memory of a block: x [8 NT][xpitch] and q [chunk]
// [qpitch], then the sums its peers push to it, [kCluster ranks][warps
// along k][8 NT][bn / kCluster] fp32 (bn / 16 groups of kCWarps / (bn /
// 16) warps: kCWarps 16 8 NT floats whatever bn).
__host__ __device__ constexpr int cluster_loads(int nt, int bn, int chunk) {
  return 8 * nt * cluster_xpitch(chunk) + chunk * cluster_qpitch(bn);
}
__host__ __device__ constexpr int cluster_smem(int nt, int bn, int chunk) {
  return cluster_loads(nt, bn, chunk) + kCWarps * 16 * 8 * nt * 4;
}
__host__ __device__ constexpr int cluster_smem_max(int nt) {
  return cluster_smem(nt, 64, kCMaxChunk);
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// dst(e, src(e)) for e in [0, count), kBatch loads of a thread in flight
// before the first store; `between` runs once the first batch's loads are
// issued, so that its work hides their latency.
template <typename T, typename Src, typename Dst, typename Between>
__device__ __forceinline__ void batched_copy(int count, Src src, Dst dst,
                                             Between between) {
  constexpr int kBatch = 8;
  bool first = true;
  for (int base = threadIdx.x; first || base < count;
       base += kBatch * kCThreads) {
    T v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = base + i * kCThreads;
      if (e < count) v[i] = src(e);
    }
    if (first) between();
    first = false;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = base + i * kCThreads;
      if (e < count) dst(e, v[i]);
    }
  }
}

// Row and unit of e = threadIdx.x + i kCThreads in rows of `per` units,
// stepped without a division per copy.
struct UnitWalk {
  int r, c, dr, dc;
  __device__ explicit UnitWalk(int per)
      : r(threadIdx.x / per), c(threadIdx.x % per), dr(kCThreads / per),
        dc(kCThreads % per) {}
  __device__ void next(int per) {
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
};

// A chunk into shared memory: x's rows [0, 8 NT) at k [c0, c0 + 16 steps)
// and q's rows there at columns [n0, n0 + bn); zeros past m, past n and
// past the chunk's `rows` k rows that exist. Every copy is issued before
// any is waited for: 16-byte cp.async where the pitches and bases allow
// (XV: k % 8 == 0 and x on the 16-byte grid; QV: n % 16 == 0 and q on
// it), else element loads, kBatch a thread in flight.
template <typename E, int NT, bool XV, bool QV>
__device__ __forceinline__ void cluster_load(
    unsigned char* xs, unsigned char* qs, const E* __restrict__ x,
    const int8_t* __restrict__ qw, int m, int n, int k, int n0, int c0,
    int rows, int steps, int bn, int xp, int qp) {
  const int tid = threadIdx.x, kk = 16 * steps;
  if (QV) {
    const int per = bn / 16;   // 16-byte units a row
    UnitWalk u(per);
    for (int e = tid; e < kk * per; e += kCThreads, u.next(per)) {
      const int c = 16 * u.c;
      const bool ok = u.r < rows && n0 + c < n;
      cp_async16(qs + u.r * qp + c,
                 ok ? qw + static_cast<size_t>(c0 + u.r) * n + n0 + c : qw,
                 ok);
    }
  }
  if (XV) {
    const int per = 2 * steps;   // 16-byte units a row
    UnitWalk u(per);
    for (int e = tid; e < 8 * NT * per; e += kCThreads, u.next(per)) {
      const int c = 8 * u.c;
      const bool ok = u.r < m && c < rows;
      cp_async16(xs + u.r * xp + 2 * c,
                 ok ? x + static_cast<size_t>(u.r) * k + c0 + c : x, ok);
    }
  }
  cp_async_commit();
  if (!QV) {
    const int wn = min(bn, n - n0);   // the tile's columns that exist
    const int sh = __ffs(bn) - 1;     // bn is a power of two
    // the tile's bytes along k x n: contiguous when wn == n (the NSP
    // head); zeros where nothing exists, written while they travel
    batched_copy<int8_t>(
        rows * wn,
        [&](int e) {
          return qw[static_cast<size_t>(c0 + e / wn) * n + n0 + e % wn];
        },
        [&](int e, int8_t v) {
          qs[e / wn * qp + e % wn] = static_cast<unsigned char>(v);
        },
        [&] {
          for (int e = tid; e < kk * bn; e += kCThreads) {
            const int r = e >> sh, c = e & (bn - 1);
            if (r >= rows || c >= wn) qs[r * qp + c] = 0;
          }
        });
  }
  if (!XV) {
    const uint16_t* xh = reinterpret_cast<const uint16_t*>(x);
    uint16_t* xsh = reinterpret_cast<uint16_t*>(xs);
    const int xph = xp / 2;
    batched_copy<uint16_t>(
        m * rows,
        [&](int e) {
          return xh[static_cast<size_t>(e / rows) * k + c0 + e % rows];
        },
        [&](int e, uint16_t v) { xsh[e / rows * xph + e % rows] = v; },
        [&] {
          UnitWalk u(kk);
          for (int e = tid; e < 8 * NT * kk; e += kCThreads, u.next(kk))
            if (u.r >= m || u.c >= rows) xsh[u.r * xph + u.c] = 0;
        });
  }
}

// Grid (column tiles of bn, kCluster), clusters of (1, kCluster): block
// rank r of a tile sums k [r kslice, (r + 1) kslice) in chunks of at most
// `chunk` rows (one chunk at BERT's shapes). Warp w owns the tile's
// columns 16 (w % G) .. + 15, G = bn / 16, and the chunk's k16 steps w /
// G, + kCWarps / G, ...; it pushes its fp32 sums of each column to the
// rank that owns it (rank r: the tile's columns [r bn / 8, (r + 1) bn /
// 8)), which adds them in rank order, then scales and rounds once.
template <typename E, typename O, int NT, bool XV, bool QV>
__global__ void __launch_bounds__(kCThreads)
qmm_cluster_kernel(const E* __restrict__ x, const int8_t* __restrict__ qw,
                   const float* __restrict__ scales, O* __restrict__ out,
                   int m, int n, int k, int bn, int kslice, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tile_scales[64];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int groups = bn / 16, kws = kCWarps / groups;   // along n, along k
  const int cn = warp % groups, kw = warp / groups;
  const int n0 = blockIdx.x * bn;
  const int kb = rank * kslice, ke = min(k, kb + kslice);
  const int xp = cluster_xpitch(chunk), qp = cluster_qpitch(bn);
  unsigned char* xs = smem;
  unsigned char* qs = smem + 8 * NT * xp;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
  // a peer's shared memory may be written only once the peer runs: say
  // that this block does, and wait for the peers before the first push
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the tile's scales travel with the first chunk's copies, so that the
  // epilogue does not wait on device memory
  if (threadIdx.x < bn) {
    const bool ok = n0 + static_cast<int>(threadIdx.x) < n;
    cp_async4(tile_scales + threadIdx.x,
              ok ? scales + n0 + threadIdx.x : scales, ok);
  }

  for (int c0 = kb; c0 < ke; c0 += chunk) {
    const int rows = min(chunk, ke - c0), steps = (rows + 15) / 16;
    if (c0 != kb) __syncthreads();   // the last chunk's reads are done
    cluster_load<E, NT, XV, QV>(xs, qs, x, qw, m, n, k, n0, c0, rows, steps,
                                bn, xp, qp);
    cp_async_wait<0>();
    __syncthreads();
    const uint32_t xa = smem_addr(xs), qa = smem_addr(qs);
#pragma unroll 2
    for (int s = kw; s < steps; s += kws) {
      uint32_t v[2], a[4];
      ldmatrix_x2_trans(v, qa + (16 * s + (lane & 15)) * qp + 16 * cn);
      widen_int8x4<E>(v[0], a[0], a[1]);
      widen_int8x4<E>(v[1], a[2], a[3]);
      // lane l gives the address of row l % 8 of matrix l / 8: x's rows
      // 8 (j + l / 16) .., k 16 s + 8 ((l / 8) % 2) ..
      const uint32_t xk = xa + 2 * (16 * s + 8 * ((lane >> 3) & 1));
      if constexpr (NT == 1) {
        uint32_t b[2];
        ldmatrix_x2(b, xk + (lane & 7) * xp);
        mma16<E>(acc[0], a[0], a[1], a[2], a[3], b[0], b[1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, xk + (8 * (j + (lane >> 4)) + (lane & 7)) * xp);
          mma16<E>(acc[j], a[0], a[1], a[2], a[3], b[0], b[1]);
          mma16<E>(acc[j + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
        }
      }
    }
  }

  cp_async_commit();   // the scales, where no chunk was loaded
  cp_async_wait<0>();
  // Push: rank o owns the tile's columns [o cols, (o + 1) cols); this
  // warp's sums of its columns go straight into their owner's shared
  // memory, to recv[rank][kw] there. d0, d1 (row g: column 2g; m 8j +
  // 2t, + 1), d2, d3 (column 2g + 1): 2g and 2g + 1 have one owner.
  const int cols = bn / kCluster, pairs = cols / 2;
  float* recv = reinterpret_cast<float*>(smem + cluster_loads(NT, bn, chunk));
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  {
    const int lc = 16 * cn + 2 * g;
    float* dst = cluster.map_shared_rank(recv, lc / cols) +
                 (rank * kws + kw) * 8 * NT * cols + lc % cols;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = 8 * j + 2 * t;
      if (row < m)
        *reinterpret_cast<float2*>(dst + row * cols) =
            make_float2(acc[j][0], acc[j][2]);
      if (row + 1 < m)
        *reinterpret_cast<float2*>(dst + (row + 1) * cols) =
            make_float2(acc[j][1], acc[j][3]);
    }
  }
  // every push has landed; no block reads a peer's memory after this
  cluster.sync();

  const bool paired = (n & 1) == 0 &&
                      reinterpret_cast<uintptr_t>(out) % (2 * sizeof(O)) == 0;
  for (int e = threadIdx.x; e < m * pairs; e += kCThreads) {
    const int row = e / pairs, c = 2 * (e % pairs);
    const float* mine = recv + row * cols + c;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      for (int w = 0; w < kws; ++w) {
        const float2 v = *reinterpret_cast<const float2*>(
            mine + (r * kws + w) * 8 * NT * cols);
        s0 = __fadd_rn(s0, v.x);
        s1 = __fadd_rn(s1, v.y);
      }
    }
    const int lc = rank * cols + c, col = n0 + lc;
    const float sc0 = tile_scales[lc], sc1 = tile_scales[lc + 1];
    O* o = out + static_cast<size_t>(row) * n + col;
    if (paired && col + 1 < n) {
      store_pair<O>(o, __fmul_rn(s0, sc0), __fmul_rn(s1, sc1));
    } else {
      if (col < n) store_one<O>(o, __fmul_rn(s0, sc0));
      if (col + 1 < n) store_one<O>(o + 1, __fmul_rn(s1, sc1));
    }
  }
}

// A launch of `tiles` x kCluster blocks of kCThreads, clusters of (1,
// kCluster); `attr` holds the cluster shape.
inline cudaLaunchConfig_t cluster_config(int tiles, int smem,
                                         cudaStream_t st,
                                         cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = kCluster;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, kCluster, 1);
  cfg.blockDim = dim3(kCThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once per kernel instance and device: the dynamic shared-memory limit,
// and whether a cluster of kCluster such blocks fits the card at all.
template <typename Kernel>
cudaError_t cluster_prepare(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, smem, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  return clusters > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Columns a tile: the narrowest of 16, 32 and 64 that holds n, else 64
// (n = 768: 12 tiles, 96 blocks; the NSP head's n = 2: 16). Wider tiles
// read x fewer times and need no sum across warps; at n = 768 they ran
// faster than 32-column tiles on 192 blocks (PERF.md, row 9b).
inline int cluster_bn(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : 64;
}

template <typename E, typename O, int NT, bool XV, bool QV>
int qmm_cluster_launch(const E* x, const int8_t* qw, const float* sc, O* out,
                       int m, int n, int k, cudaStream_t st) {
  auto kernel = qmm_cluster_kernel<E, O, NT, XV, QV>;
  static int ready[kMaxDevices] = {};   // 0 not yet, 1 ready, -error
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (ready[dev] == 0) {
    err = cluster_prepare(kernel, cluster_smem_max(NT));
    ready[dev] = err == cudaSuccess ? 1 : -static_cast<int>(err);
  }
  if (ready[dev] != 1) return -ready[dev];
  const int bn = cluster_bn(n);
  const int kslice = ((k + kCluster - 1) / kCluster + 15) / 16 * 16;
  const int chunk = std::min(kslice, kCMaxChunk);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      (n + bn - 1) / bn, cluster_smem(NT, bn, chunk), st, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, x, qw, sc, out, m, n, k, bn, kslice,
                           chunk);
  // a refused launch also sets the last error: take it
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename E, typename O, int NT>
int qmm_cluster_dispatch(bool xv, bool qv, const E* x, const int8_t* qw,
                         const float* sc, O* out, int m, int n, int k,
                         cudaStream_t st) {
  if (xv && qv)
    return qmm_cluster_launch<E, O, NT, true, true>(x, qw, sc, out, m, n, k,
                                                    st);
  if (xv)
    return qmm_cluster_launch<E, O, NT, true, false>(x, qw, sc, out, m, n, k,
                                                     st);
  if (qv)
    return qmm_cluster_launch<E, O, NT, false, true>(x, qw, sc, out, m, n, k,
                                                     st);
  return qmm_cluster_launch<E, O, NT, false, false>(x, qw, sc, out, m, n, k,
                                                    st);
}

// The 16-bit forms' (x type, out type) pairs: x_type 0 bf16, 1 fp16;
// out_f32 0 writes x's type, 1 fp32 from the same accumulator. Calls
// launch(Types<E, O>{}) and returns its code.
template <typename E_, typename O_>
struct Types {
  using E = E_;
  using O = O_;
};

template <typename F>
int with_types(int x_type, int out_f32, F&& launch) {
  if (x_type == 0)
    return out_f32 ? launch(Types<__nv_bfloat16, float>{})
                   : launch(Types<__nv_bfloat16, __nv_bfloat16>{});
  if (x_type == 1)
    return out_f32 ? launch(Types<__half, float>{})
                   : launch(Types<__half, __half>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// w: fp32 [k, n] contiguous; q: int8 [k, n]; scales: fp32 [n].
// stochastic: 0 nearest, 1 stochastic rounding with `seed`.
// Returns a cudaError_t code.
extern "C" int quantize_int8(const void* w, void* q, void* scales, int k,
                             int n, int stochastic, unsigned int seed,
                             void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* wp = static_cast<const float*>(w);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(scales);
  const int slab = (k + kQCluster - 1) / kQCluster;
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaError_t err;
  if (slab <= kQMaxSlabRows)
    err = stochastic
              ? quantize_launch<true, true>(wp, qp, sp, k, n, slab, seed, vec, st)
              : quantize_launch<false, true>(wp, qp, sp, k, n, slab, seed, vec, st);
  else
    err = stochastic
              ? quantize_launch<true, false>(wp, qp, sp, k, n, slab, seed, vec, st)
              : quantize_launch<false, false>(wp, qp, sp, k, n, slab, seed, vec, st);
  // a refused launch also sets the last error: take it, so the next
  // launch does not report it
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Number of k slices quant_matmul splits (m, n, k) into; the caller
// passes a workspace of splits * m * n floats when it is more than 1.
extern "C" int quant_matmul_splits(int m, int n, int k) {
  if (m <= 0 || n <= 0 || k <= 0) return 0;
  int kchunk = 0;
  return qmm_splits(m, n, k, &kchunk);
}

// x: fp32 [m, k]; qw: int8 [k, n]; scales: fp32 [n]; out: fp32 [m, n]; all
// contiguous, 4-byte aligned; ws: fp32 [splits, m, n] or null when
// quant_matmul_splits is 1. Returns a cudaError_t code.
extern "C" int quant_matmul(const void* x, const void* qw, const void* scales,
                            void* out, void* ws, int m, int n, int k,
                            void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 ||
      (m + 32 * qmm_mt(m) - 1) / (32 * qmm_mt(m)) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<const float*>(x);
  auto* qp = static_cast<const int8_t*>(qw);
  auto* sp = static_cast<const float*>(scales);
  auto* op = static_cast<float*>(out);
  auto* wp = static_cast<float*>(ws);
  const bool xv = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool qv = n % 16 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0;
  switch (qmm_mt(m)) {
    case 4: return qmm_dispatch<4>(xv, qv, xp, qp, sp, op, wp, m, n, k, st);
    case 2: return qmm_dispatch<2>(xv, qv, xp, qp, sp, op, wp, m, n, k, st);
    default: return qmm_dispatch<1>(xv, qv, xp, qp, sp, op, wp, m, n, k, st);
  }
}

// x: bf16 (x_type 0) or fp16 (1) [m, k]; qw: int8 [k, n]; scales: fp32
// [n]; out: [m, n] of x's type (out_f32 0) or fp32 (1); all contiguous,
// x 2-byte aligned, out aligned to its element, qw 4-byte aligned; ws as
// for quant_matmul (the same k slices). Returns a cudaError_t code.
extern "C" int quant_matmul_16(const void* x, const void* qw,
                               const void* scales, void* out, void* ws, int m,
                               int n, int k, int x_type, int out_f32,
                               void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 ||
      (m + 32 * qmm_mt(m) - 1) / (32 * qmm_mt(m)) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const int8_t*>(qw);
  auto* sp = static_cast<const float*>(scales);
  auto* wp = static_cast<float*>(ws);
  const bool xv = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool qv = n % 16 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0;
  return with_types(x_type, out_f32, [&](auto t) {
    using E = typename decltype(t)::E;
    using O = typename decltype(t)::O;
    auto* xp = static_cast<const E*>(x);
    auto* op = static_cast<O*>(out);
    switch (qmm_mt(m)) {
      case 4:
        return qmm_h_dispatch<E, O, 4>(xv, qv, xp, qp, sp, op, wp, m, n, k, st);
      case 2:
        return qmm_h_dispatch<E, O, 2>(xv, qv, xp, qp, sp, op, wp, m, n, k, st);
      default:
        return qmm_h_dispatch<E, O, 1>(xv, qv, xp, qp, sp, op, wp, m, n, k, st);
    }
  });
}

// The wgmma route of quant_matmul_16 (m > 64): the same operands, and
// n % 16 == 0, k % 8 == 0, x and qw 16-byte aligned (the row pitches and
// bases TMA takes), out aligned to two of its elements; no workspace.
// Returns a cudaError_t code.
extern "C" int quant_matmul_16_wgmma(const void* x, const void* qw,
                                     const void* scales, void* out, int m,
                                     int n, int k, int x_type, int out_f32,
                                     void* stream) {
  constexpr int rows = kQmmRows;
  if (m <= 0 || n <= 0 || k <= 0 || n % 16 != 0 || k % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(qw) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % (out_f32 ? 8 : 4) != 0 ||
      static_cast<long>((m + rows - 1) / rows) * ((n + 63) / 64) >
          INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_types(x_type, out_f32, [&](auto t) {
    using E = typename decltype(t)::E;
    using O = typename decltype(t)::O;
    return qmm_wgmma_launch<E, O, kQmmWarpgroups, kQmmRows, kQmmStages>(
        x, qw, static_cast<const float*>(scales), static_cast<O*>(out), m,
        n, k, static_cast<cudaStream_t>(stream));
  });
}

// The cluster route of quant_matmul_16 (m <= 64): the same operands as
// quant_matmul_16 (x 2-byte aligned, out aligned to its element, qw
// 4-byte aligned), one launch, no workspace. Returns a cudaError_t code.
extern "C" int quant_matmul_16_cluster(const void* x, const void* qw,
                                       const void* scales, void* out, int m,
                                       int n, int k, int x_type, int out_f32,
                                       void* stream) {
  if (m <= 0 || m > 64 || n <= 0 || k <= 0 ||
      reinterpret_cast<uintptr_t>(x) % 2 != 0 ||
      reinterpret_cast<uintptr_t>(qw) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % (out_f32 ? 4 : 2) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const int8_t*>(qw);
  auto* sp = static_cast<const float*>(scales);
  const bool xv = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool qv = n % 16 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0;
  return with_types(x_type, out_f32, [&](auto t) {
    using E = typename decltype(t)::E;
    using O = typename decltype(t)::O;
    auto* xp = static_cast<const E*>(x);
    auto* op = static_cast<O*>(out);
    if (m <= 8)
      return qmm_cluster_dispatch<E, O, 1>(xv, qv, xp, qp, sp, op, m, n, k, st);
    if (m <= 16)
      return qmm_cluster_dispatch<E, O, 2>(xv, qv, xp, qp, sp, op, m, n, k, st);
    if (m <= 32)
      return qmm_cluster_dispatch<E, O, 4>(xv, qv, xp, qp, sp, op, m, n, k, st);
    return qmm_cluster_dispatch<E, O, 8>(xv, qv, xp, qp, sp, op, m, n, k, st);
  });
}

// The bf16 forms with bf16 out (quant_matmul_16 at x_type 0, out_f32 0),
// under the names tools/torch_qmm_ab.py calls.
extern "C" int quant_matmul_bf16(const void* x, const void* qw,
                                 const void* scales, void* out, void* ws,
                                 int m, int n, int k, void* stream) {
  return quant_matmul_16(x, qw, scales, out, ws, m, n, k, 0, 0, stream);
}

extern "C" int quant_matmul_bf16_wgmma(const void* x, const void* qw,
                                       const void* scales, void* out, int m,
                                       int n, int k, void* stream) {
  return quant_matmul_16_wgmma(x, qw, scales, out, m, n, k, 0, 0, stream);
}

extern "C" int quant_matmul_bf16_cluster(const void* x, const void* qw,
                                         const void* scales, void* out,
                                         int m, int n, int k, void* stream) {
  return quant_matmul_16_cluster(x, qw, scales, out, m, n, k, 0, 0, stream);
}
