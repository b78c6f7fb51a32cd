// Hand-written Hopper (sm_90a) kernels for the refinement hot path and the
// subspace solver.
//
// Kernels 1-5 each compute what one Pallas TPU kernel of
// spectralcluster_tpu/kernels/fused.py computes; none is carried over block
// by block. Kernels 6-7 compute what the JAX package's subspace solver
// leaves to XLA (its panel product, a CholeskyQR pass), kernel 8 the whole
// of its K-Means (k-means++ and the cosine Lloyd loop). The
// plain PyTorch twin of each kernel sits beside its wrapper in
// spectralcluster_tpu_torch/kernels/fused.py and defines the semantics.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsct_fused.so fused.cu
// (kernels/build.py does this at first use). No --use_fast_math: every
// division and square root stays IEEE, and the products are float32 FMAs
// on the CUDA cores (kernel 6: float64 tensor-core MMAs of float32
// inputs), never TF32 tensor cores.
//
// Interface: plain C. Every sct_* function but the reports and queries
// (sct_resident_blocks, sct_affinity_batched_schedule,
// sct_panel_matmul_schedule) launches its kernel (one launch, or for 6 one
// per 32 columns) on the given stream, does not synchronize, allocates
// nothing, and returns cudaGetLastError() so the caller sees a refused
// launch.
//
// Batched forms (sct_*_batched). The JAX package's batched step runs each
// Pallas kernel under vmap, which adds a leading grid axis over the
// utterances of a chunk. One launch covers B contiguous (N, N) matrices:
// threshold_symmetrize with the utterance as a grid index (blockIdx.z);
// crop_diagonal and row_wise_normalize by treating the batch as B·N rows
// (utterance r / N, diagonal column r % N), as templates on kBatched whose
// one-matrix instances compile to the code they had before the batch axis;
// the affinity and row_max by kernels of their own (1b, 2b), designed for
// the chunk's shapes. Each utterance's n_valid is read from a (B,) int32
// array in device memory, so a chunk of ragged utterances needs no host
// value per utterance.
//
// Card figures used below (H100 SXM data sheet): 3.35 TB/s HBM3,
// 67 TFLOP/s float32 on the CUDA cores. N = 10240, d = 256 on the main path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "kmeans.cuh"

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int cdiv_device(int a, int b) {
  return (a + b - 1) / b;
}

// ---------------------------------------------------------------------------
// 1. Cosine affinity: out = (xn xnᵀ + 1) / 2, one triangle of tile pairs.
//
// Replaces affinity_pallas / _affinity_kernel (kernels/fused.py:46-77), an
// fp32 HIGHEST-precision MXU dot with the affine step in the epilogue.
// Bound: both operands are row blocks of one xn, so the output is exactly
// symmetric and the least work is N(N+1)/2 dot products of length d:
// N(N+1)·d = 26.9 GFLOP at N=10240, d=256 -> 0.40 ms at 67 TFLOP/s on the
// CUDA cores. Its bytes (N·d read, N² written: 0.42 GB -> 0.125 ms) cost
// less, so it is bound by float32 operations. IEEE float32 FMAs only: no
// TF32 tensor cores, no --use_fast_math.
// Design, against that bound:
//  * operand: the wrapper hands over xnᵀ, (d_pad, ld) k-major and zero-padded
//    to whole tiles, so the two operand tiles of a k slice are rows of one
//    array, copied into shared memory with 16-byte cp.async, no transpose,
//    no masks;
//  * a 128x128 output tile per 256-thread block, an 8x8 register tile per
//    thread laid out as 2x2 sub-tiles of 4x4: each k step reads its 16
//    operands with four conflict-free 128-bit shared loads for 64 FMAs;
//  * a ring of kAffStages shared-memory stages of kAffDepth-deep k slices:
//    the copies of slice s+kAffStages-1 fly while slice s is computed, with
//    one __syncthreads per slice;
//  * one triangle: the 1-D grid walks the tile pairs bi <= bj only,
//    T(T+1)/2 blocks for T = ceil(N/128) (3,240, not 6,400, at N=10240).
//    An off-diagonal block writes tile (bi,bj) and its transpose (bj,bi)
//    straight from registers: a thread's 4 consecutive rows are 4
//    consecutive columns of the transpose, so both stores are 16 bytes wide
//    and neighbouring lanes fill whole 32-byte sectors. A diagonal block
//    writes once;
//  * every output element is one fmaf chain over k = 0..d-1 in order (the
//    zero padding adds exact zeros), so out equals outᵀ bit for bit, and the
//    bits are those of any tiled SGEMM that sums in k order.
// ---------------------------------------------------------------------------

constexpr int kAffTile = 128;    // output tile edge; the operand's ld unit
constexpr int kAffDepth = 16;    // k slice; the operand's d_pad unit
constexpr int kAffStages = 3;
constexpr int kAffThreads = 256;
constexpr int kAffStageFloats = 2 * kAffDepth * kAffTile;
constexpr int kAffSmemBytes = kAffStages * kAffStageFloats * 4;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Tile pair p of the upper triangle, column by column:
// p = bj(bj+1)/2 + bi with 0 <= bi <= bj.
__device__ __forceinline__ void triangle_pair(int p, int& bi, int& bj) {
  int j = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while (j * (j + 1) / 2 > p) --j;
  while ((j + 1) * (j + 2) / 2 <= p) ++j;
  bj = j;
  bi = p - j * (j + 1) / 2;
}

// Copies k slice `slice` of the operand columns [row0, row0+128) and
// [col0, col0+128) into one stage: two (kAffDepth, 128) k-major tiles.
__device__ __forceinline__ void load_slice(float* stage, const float* xt,
                                           int ld, int slice, int row0,
                                           int col0, int tid) {
  float* as = stage;
  float* bs = stage + kAffDepth * kAffTile;
  const float* src = xt + (size_t)slice * kAffDepth * ld;
#pragma unroll
  for (int u = 0; u < kAffDepth * kAffTile / 4 / kAffThreads; ++u) {
    const int q = tid + u * kAffThreads;
    const int k = q / (kAffTile / 4);
    const int c = (q % (kAffTile / 4)) * 4;
    cp_async16(as + k * kAffTile + c, src + (size_t)k * ld + row0 + c);
    cp_async16(bs + k * kAffTile + c, src + (size_t)k * ld + col0 + c);
  }
}

// Stores 4 consecutive values at row[c..c+3], those < n.
__device__ __forceinline__ void store4(float* row, int c, int n, bool vec,
                                       float v0, float v1, float v2,
                                       float v3) {
  if (vec) {
    // n % 4 == 0 and c % 4 == 0, so c < n covers all four.
    if (c < n) {
      *reinterpret_cast<float4*>(row + c) = make_float4(v0, v1, v2, v3);
    }
    return;
  }
  if (c < n) row[c] = v0;
  if (c + 1 < n) row[c + 1] = v1;
  if (c + 2 < n) row[c + 2] = v2;
  if (c + 3 < n) row[c + 3] = v3;
}

__global__ void __launch_bounds__(kAffThreads, 2)
affinity_kernel(const float* __restrict__ xt, float* __restrict__ out, int n,
                int ld, int k_slices) {
  extern __shared__ __align__(16) float smem[];
  int bi, bj;
  triangle_pair(blockIdx.x, bi, bj);
  const int row0 = bi * kAffTile;
  const int col0 = bj * kAffTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // The thread grid is 16x16; a warp owns 4 of its rows by 8 of its columns.
  // Thread (ty, tx) holds rows {0, 64} + 4ty + 0..3 and columns
  // {0, 64} + 4tx + 0..3 of the tile.
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

#pragma unroll
  for (int s = 0; s < kAffStages - 1; ++s) {
    if (s < k_slices) {
      load_slice(smem + s * kAffStageFloats, xt, ld, s, row0, col0, tid);
    }
    cp_async_commit();
  }
  for (int ks = 0; ks < k_slices; ++ks) {
    // Slice ks has landed; every thread is done with slice ks-1, whose stage
    // the next copy refills.
    cp_async_wait<kAffStages - 2>();
    __syncthreads();
    const int next = ks + kAffStages - 1;
    if (next < k_slices) {
      load_slice(smem + (next % kAffStages) * kAffStageFloats, xt, ld, next,
                 row0, col0, tid);
    }
    cp_async_commit();
    const float* as = smem + (ks % kAffStages) * kAffStageFloats;
    const float* bs = as + kAffDepth * kAffTile;
#pragma unroll
    for (int k = 0; k < kAffDepth; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kAffTile +
                                                         4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * kAffTile +
                                                         64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kAffTile +
                                                         4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * kAffTile +
                                                         64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = (acc[i][j] + 1.0f) * 0.5f;
  }
  const bool vec =
      (n & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  // Tile (bi, bj): row r, columns c..c+3.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i >> 2) * 64 + 4 * ty + (i & 3);
    if (r >= n) continue;
    float* orow = out + (size_t)r * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      store4(orow, col0 + h * 64 + 4 * tx, n, vec, acc[i][4 * h],
             acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
  if (bi == bj) return;
  // Tile (bj, bi): row c of the transpose is column c of the register tile.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col0 + (j >> 2) * 64 + 4 * tx + (j & 3);
    if (c >= n) continue;
    float* orow = out + (size_t)c * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      store4(orow, row0 + h * 64 + 4 * ty, n, vec, acc[4 * h][j],
             acc[4 * h + 1][j], acc[4 * h + 2][j], acc[4 * h + 3][j]);
    }
  }
}

// Lets the affinity kernel take kAffSmemBytes of dynamic shared memory; set
// once per process.
cudaError_t affinity_smem_opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      affinity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kAffSmemBytes);
  return err;
}

// ---------------------------------------------------------------------------
// 1b. Batched affinity: the 2-D kernel's products on row-major operands,
// the largest blocks first.
//
// Replaces affinity_pallas under the batched step's vmap (parallel/batch.py):
// the B matrices (xn_b xn_bᵀ + 1) / 2 of one chunk, B·N(N+1)·d float32
// operations, 4.3 GFLOP -> 0.064 ms at (B, N, d) = (16, 1024, 256); its bytes
// (16.8 MB read, 67 MB written -> 0.025 ms) cost less. The 2-D kernel with
// the utterance as a grid index lost time there three ways (PERF.md §6):
// its wrapper first copied xnᵀ into a padded operand, a copy whose reads
// stride by d; its 576 tile pairs of 128x128 are 2.2 waves over the 264
// resident blocks; and its diagonal tiles are computed in full.
// Design:
//  * the operand is the normalized rows as they are, (B, N, d4) row-major
//    (d4 = d padded to a multiple of 4 by the wrapper, only where d % 4 !=
//    0): no transposed copy. Each k slice is copied into a ring of shared
//    memory as it lies, with the 2-D kernel's count of 16-byte cp.async,
//    and one slice ahead of its products each thread moves 4 float4s of it
//    into a k-major tile with 16 scalar stores: a warp reads 32 rows'
//    float4 and writes 32 consecutive floats of each k, both at the fewest
//    wavefronts. (Copying with 4-byte cp.async straight into k-major order
//    was slower, and so was reading float4s along k from a row-major tile,
//    which spilled.)
//  * the products are the 2-D kernel's k loop on that tile, so each element
//    is one fmaf chain over k = 0..16·ceil(d4/16)-1 in order (the zero fill
//    past N and d adds exact zeros): each matrix equals the 2-D kernel's
//    bit for bit, and its own transpose;
//  * a block computes some of the four 64x64 quads of a 128x128 tile pair,
//    and the grid puts the largest blocks first: the off-diagonal pairs,
//    then the diagonal tiles at 3/4 of the work (the lower left quad is the
//    mirror of the upper right one, and the columns are the rows, staged
//    once), the last quarter-wave of them split into an upper row half and
//    a lower quad, so that small blocks fill the last wave's gaps.
// ---------------------------------------------------------------------------

constexpr int kAbQuad = kAffTile / 2;
constexpr int kAbStages = 3;
// A ring stage: a slice of the piece's rows (at 0) and columns (at
// kAffTile) as they lie, kAffDepth floats a row, padded to kAbRowPitch so
// that 8 rows' float4 q fall in 8 bank groups.
constexpr int kAbRowPitch = kAffDepth + 4;
constexpr int kAbRingFloats = 2 * kAffTile * kAbRowPitch;
// A k-major tile: the 2-D kernel's stage, (kAffDepth, kAffTile) of rows,
// then of columns.
constexpr int kAbTileFloats = 2 * kAffDepth * kAffTile;
constexpr int kAbSmemBytes =
    (kAbStages * kAbRingFloats + 2 * kAbTileFloats) * 4;

// A block's piece of the upper triangle: the 64x64 quads kQuads (bit
// 2hr + hc for rows row0 + 64hr, columns col0 + 64hc) of utterance utt.
// kOffDiagonal: a 128x128 tile pair bi < bj, all four quads. The others lie
// on a diagonal tile (row0 = col0), whose columns are its rows: kDiagonal
// its quads (0,0), (0,1), (1,1) (the lower left one is the mirror of the
// upper right one), kUpperHalf its upper row half, kLowerQuad its lower
// right quad, as a 64-row piece from row0 + 64.
constexpr int kOffDiagonal = 0xf;
constexpr int kDiagonal = 0xb;
constexpr int kUpperHalf = 0x3;
constexpr int kLowerQuad = 0x1;

struct AffPiece {
  int kind, utt, row0, col0;
};

// Block blk's piece. The grid puts the largest first: the b·T(T-1)/2
// off-diagonal pairs (utterance by utterance, pair bj(bj-1)/2 + bi), then
// the diagonal tiles, the last `split` of which come as an upper half and
// a lower quad each, all the halves, then all the quads: small blocks
// fill the last wave's gaps. kind < 0: a quad past n.
__device__ __forceinline__ AffPiece affinity_piece(int blk, int n, int b,
                                                   int tiles, int split) {
  const int off = tiles * (tiles - 1) / 2;
  if (blk < b * off) {
    const int utt = blk / off;
    const int pr = blk - utt * off;
    int bj = static_cast<int>((sqrtf(8.0f * pr + 1.0f) + 1.0f) * 0.5f);
    while (bj > 1 && bj * (bj - 1) / 2 > pr) --bj;
    while ((bj + 1) * bj / 2 <= pr) ++bj;
    const int bi = pr - bj * (bj - 1) / 2;
    return AffPiece{kOffDiagonal, utt, bi * kAffTile, bj * kAffTile};
  }
  blk -= b * off;
  const int whole = b * tiles - split;
  int kind = kDiagonal, g = blk;
  if (blk >= whole + split) {
    kind = kLowerQuad;
    g = blk - split;
  } else if (blk >= whole) {
    kind = kUpperHalf;
  }
  const int utt = g / tiles;
  const int r0 =
      (g - utt * tiles) * kAffTile + (kind == kLowerQuad ? kAbQuad : 0);
  return AffPiece{r0 < n ? kind : -1, utt, r0, r0};
}

// Copies k slice `slice` of kRows rows of x (n, d4), row-major, from row
// `first`, into ring rows [0, kRows) as they lie; zero past n and d4.
// Thread tid copies float4 c % 4 of row c / 4, c = tid + 256u: a warp 8
// rows of 64 bytes.
template <int kRows>
__device__ __forceinline__ void stage_rows(float* ring, const float* x,
                                           int n, int d4, int slice,
                                           int first, int tid) {
#pragma unroll
  for (int u = 0; u < kRows * 4 / kAffThreads; ++u) {
    const int c = tid + u * kAffThreads;
    const int r = c >> 2;
    const int q = c & 3;
    const int k = slice * kAffDepth + 4 * q;
    const bool ok = first + r < n && k < d4;
    const float* src = ok ? x + (size_t)(first + r) * d4 + k : x;
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(ring + r * kAbRowPitch + 4 * q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0));
  }
}

// Ring rows [0, kRows) -> k-major tiles of 128 rows (rows [128, 256) are
// the column operand's, the second tile). Thread tid moves float4 q of row
// r, r = c % 32 + 32(c / 128), q = c / 32 % 4, c = tid + 256u: a warp
// reads 32 rows' float4 q (4 wavefronts, the least for 512 bytes) and
// writes 32 consecutive floats of each of k = 4q..4q+3.
template <int kRows>
__device__ __forceinline__ void transpose_rows(float* tiles,
                                               const float* ring, int tid) {
#pragma unroll
  for (int u = 0; u < kRows * 4 / kAffThreads; ++u) {
    const int c = tid + u * kAffThreads;
    const int r = (c & 31) + 32 * (c >> 7);
    const int q = (c >> 5) & 3;
    const float4 v =
        *reinterpret_cast<const float4*>(ring + r * kAbRowPitch + 4 * q);
    float* t = tiles + (r >> 7) * kAffDepth * kAffTile + (r & 127);
    t[(4 * q) * kAffTile] = v.x;
    t[(4 * q + 1) * kAffTile] = v.y;
    t[(4 * q + 2) * kAffTile] = v.z;
    t[(4 * q + 3) * kAffTile] = v.w;
  }
}

// The ring rows a piece stages: its rows, and its columns after them off
// the diagonal; 64 rows for a lower quad, the only piece in one quad.
template <int kQuads>
constexpr int kPieceRows = kQuads == kOffDiagonal ? 2 * kAffTile
                           : (kQuads & 0xe)       ? kAffTile
                                                  : kAbQuad;

template <int kQuads>
__device__ __forceinline__ void stage_piece(float* ring, const float* x,
                                            int n, int d4, int slice,
                                            const AffPiece& p, int tid) {
  if (kQuads == kOffDiagonal) {
    stage_rows<kAffTile>(ring, x, n, d4, slice, p.row0, tid);
    stage_rows<kAffTile>(ring + kAffTile * kAbRowPitch, x, n, d4, slice,
                         p.col0, tid);
  } else {
    stage_rows<kPieceRows<kQuads>>(ring, x, n, d4, slice, p.row0, tid);
  }
}

// The piece's products: acc[i][j] over rows 64(i/4) + 4ty + i%4 and
// columns 64(j/4) + 4tx + j%4 of it, ty and tx the 2-D kernel's, for the
// quads of kQuads. Slice s is copied into ring stage s % kAbStages, moved
// into k-major tile s % 2 one slice ahead of its products, and multiplied
// by the 2-D kernel's k loop; one __syncthreads a slice orders the three.
template <int kQuads>
__device__ __forceinline__ void piece_products(const float* x, int n, int d4,
                                               int k_slices,
                                               const AffPiece& p, float* smem,
                                               float (&acc)[8][8]) {
  constexpr int kRows = kPieceRows<kQuads>;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  float* ring = smem;
  float* tiles = smem + kAbStages * kAbRingFloats;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < kAbStages; ++s) {
    if (s < k_slices) {
      stage_piece<kQuads>(ring + s * kAbRingFloats, x, n, d4, s, p, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<kAbStages - 1>();
  __syncthreads();
  if (k_slices > 0) transpose_rows<kRows>(tiles, ring, tid);
  for (int ks = 0; ks < k_slices; ++ks) {
    // Slice ks+1 has landed; every thread is done with tile (ks+1) % 2
    // (slice ks-1's products) and with ring stage ks % kAbStages (slice
    // ks's move), and slice ks's move is in tile ks % 2.
    cp_async_wait<kAbStages - 2>();
    __syncthreads();
    if (ks + 1 < k_slices) {
      transpose_rows<kRows>(tiles + ((ks + 1) & 1) * kAbTileFloats,
                            ring + ((ks + 1) % kAbStages) * kAbRingFloats,
                            tid);
    }
    if (ks + kAbStages < k_slices) {
      stage_piece<kQuads>(ring + (ks % kAbStages) * kAbRingFloats, x, n, d4,
                          ks + kAbStages, p, tid);
    }
    cp_async_commit();
    const float* as = tiles + (ks & 1) * kAbTileFloats;
    const float* bs =
        kQuads == kOffDiagonal ? as + kAffDepth * kAffTile : as;
#pragma unroll
    for (int k = 0; k < kAffDepth; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kQuads & (0x3 << (2 * h))) {
          const float4 v = *reinterpret_cast<const float4*>(
              as + k * kAffTile + h * kAbQuad + 4 * ty);
          a[4 * h] = v.x; a[4 * h + 1] = v.y; a[4 * h + 2] = v.z;
          a[4 * h + 3] = v.w;
        }
        if (kQuads & (0x5 << h)) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs + k * kAffTile + h * kAbQuad + 4 * tx);
          b[4 * h] = v.x; b[4 * h + 1] = v.y; b[4 * h + 2] = v.z;
          b[4 * h + 3] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (kQuads & (1 << (2 * (i >> 2) + (j >> 2)))) {
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
      }
    }
  }
}

// Stores (acc + 1) / 2 of piece p's quads; a quad off the diagonal also
// writes its transpose: row c of it is column c of the register tile, 4
// consecutive rows of the piece.
template <int kQuads>
__device__ __forceinline__ void piece_store(float* out, int n,
                                            const AffPiece& p, bool vec,
                                            float (&acc)[8][8]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  float* o = out + (size_t)p.utt * n * n;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r0 = p.row0 + hr * kAbQuad;
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      if (!(kQuads & (1 << (2 * hr + hc)))) continue;
      const int c0 = p.col0 + hc * kAbQuad;
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[i][j] = (acc[4 * hr + i][4 * hc + j] + 1.0f) * 0.5f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 4 * ty + i;
        if (r < n) {
          store4(o + (size_t)r * n, c0 + 4 * tx, n, vec, v[i][0], v[i][1],
                 v[i][2], v[i][3]);
        }
      }
      if (r0 == c0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * tx + j;
        if (c < n) {
          store4(o + (size_t)c * n, r0 + 4 * ty, n, vec, v[0][j], v[1][j],
                 v[2][j], v[3][j]);
        }
      }
    }
  }
}

template <int kQuads>
__device__ __forceinline__ void affinity_piece_run(const float* x, float* out,
                                                   int n, int d4,
                                                   int k_slices,
                                                   const AffPiece& p,
                                                   float* smem, bool vec) {
  float acc[8][8];
  piece_products<kQuads>(x, n, d4, k_slices, p, smem, acc);
  piece_store<kQuads>(out, n, p, vec, acc);
}

// xn: B utterances of (n, d4), row-major; out: B matrices of (n, n).
__global__ void __launch_bounds__(kAffThreads, 2)
affinity_batched_kernel(const float* __restrict__ xn, float* __restrict__ out,
                        int b, int n, int d4, int k_slices, int tiles,
                        int split) {
  extern __shared__ __align__(16) float smem[];
  const AffPiece p = affinity_piece(blockIdx.x, n, b, tiles, split);
  const float* x = xn + (size_t)p.utt * n * d4;
  const bool vec =
      (n & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  switch (p.kind) {
    case kOffDiagonal:
      affinity_piece_run<kOffDiagonal>(x, out, n, d4, k_slices, p, smem, vec);
      break;
    case kDiagonal:
      affinity_piece_run<kDiagonal>(x, out, n, d4, k_slices, p, smem, vec);
      break;
    case kUpperHalf:
      affinity_piece_run<kUpperHalf>(x, out, n, d4, k_slices, p, smem, vec);
      break;
    case kLowerQuad:
      affinity_piece_run<kLowerQuad>(x, out, n, d4, k_slices, p, smem, vec);
      break;
    default:
      break;
  }
}

cudaError_t affinity_batched_smem_opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      affinity_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kAbSmemBytes);
  return err;
}

// ---------------------------------------------------------------------------
// 2./3. Row max and CropDiagonal: one warp per row, one resident wave.
//
// row_max replaces row_max_pallas / _row_max_kernel (kernels/fused.py:
// 85-140): the max of row i over columns < n_valid; with exclude_diagonal
// the diagonal entry counts as 0 (also in rows >= n_valid, where it is set
// after the column mask, exactly as the TPU kernel does). The TPU kernel
// carries a running max across a sequential grid axis of column tiles; here
// a warp's loop over the columns takes that axis's place and a warp shuffle
// finishes the reduction, so nothing carries between blocks.
// Bound: reading N·n_valid floats once, 0.42 GB -> 0.125 ms at N=10240.
// Design, against that bound:
//  * one resident wave: the grid is as many blocks as the card holds at
//    once (cudaOccupancyMaxActiveBlocksPerMultiprocessor × the SMs), cut so
//    that every warp strides over the same number of rows, ceil(N / the
//    resident warps). No second, mostly empty wave is left;
//  * each lane issues kRowUnroll 16-byte loads before it reduces them, so
//    enough bytes are in flight to cover the HBM latency;
//  * no mask tests in the hot loop: the columns a row reduces, [0, n_valid)
//    less the diagonal under exclude_diagonal, are one or two column
//    ranges, each streamed by one fmaxf-only loop. Only the at most three
//    columns at either end of a range that do not fill a float4 are read
//    one by one. exclude_diagonal is a template argument, so the main
//    path's form (no exclusion) compiles to the one range; with it the max
//    starts at 0, the diagonal's value, and the diagonal is never read.
// A max is order-free, so every traversal gives the twin's bits.
//
// crop_diagonal replaces crop_diagonal_pallas / _crop_diag_kernel
// (kernels/fused.py:226-254), which runs the row max and then a second
// N² pass that copies the matrix with the diagonal replaced. Here the row
// max and the diagonal write are fused, on the same traversal. Only N values
// change, so with out == a the kernel writes the diagonal IN PLACE: it reads
// N·n_valid floats and writes N, 0.42 GB -> 0.125 ms at N=10240, where the
// copy would read and write N² (0.84 GB). The main path hands it the fresh
// affinity, which nothing reads afterwards. With out != a it first copies
// the row (N² read + N² written) for callers that keep a; the row max then
// reads the row again, from L2.
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowUnroll = 4;

// The lane's max over row[lo, hi), folded into m. `vec`: the row starts
// 16-byte aligned.
__device__ __forceinline__ float range_max(const float* __restrict__ row,
                                           int lo, int hi, bool vec, int lane,
                                           float m) {
  if (vec) {
    const int lo4 = (lo + 3) >> 2;
    const int hi4 = hi >> 2;
    if (lo4 < hi4) {
      if (lo + lane < 4 * lo4) m = fmaxf(m, row[lo + lane]);
      if (4 * hi4 + lane < hi) m = fmaxf(m, row[4 * hi4 + lane]);
      const float4* row4 = reinterpret_cast<const float4*>(row);
      int c = lo4 + lane;
      for (; c + 32 * (kRowUnroll - 1) < hi4; c += 32 * kRowUnroll) {
        float4 v[kRowUnroll];
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) v[u] = row4[c + 32 * u];
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          m = fmaxf(m, fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w)));
        }
      }
      for (; c < hi4; c += 32) {
        const float4 v = row4[c];
        m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
      }
      return m;
    }
  }
  for (int c = lo + lane; c < hi; c += 32) m = fmaxf(m, row[c]);
  return m;
}

// Row i's max over columns < n_valid; with kExclude, column i counts as 0.
template <bool kExclude>
__device__ __forceinline__ float row_max_value(const float* __restrict__ row,
                                               int i, int n_valid, bool vec,
                                               int lane) {
  float m = kExclude ? 0.0f : -INFINITY;
  // With kExclude the columns are [0, min(i, n_valid)) and [i+1, n_valid).
  // One copy of the range loop serves both, so the exclusion adds no
  // registers to it.
#pragma unroll 1
  for (int part = 0; part < (kExclude ? 2 : 1); ++part) {
    const int lo = part == 0 ? 0 : i + 1;
    const int hi = kExclude && part == 0 ? min(i, n_valid) : n_valid;
    m = range_max(row, lo, hi, vec, lane, m);
  }
  return warp_max(m);
}

// Row r of a kernel's `rows`: its diagonal column i and its n_valid. One
// matrix (kBatched false): rows = n, i = r, n_valid the argument. A batch
// of (n, n) matrices: rows = B·n, utterance r / n, i = r % n and that
// utterance's entry of `n_valids` clamped to [0, n]. A template argument,
// so that the one-matrix forms compile to the code they had before the
// batch axis (the batch's extra live values made ptxas spill there).
template <bool kBatched>
__device__ __forceinline__ void row_position(int r, int n, int n_valid,
                                             const int* __restrict__ n_valids,
                                             int& i, int& nv) {
  if (kBatched) {
    const int utterance = r / n;
    i = r - utterance * n;
    nv = min(max(n_valids[utterance], 0), n);
  } else {
    i = r;
    nv = n_valid;
  }
}

// One matrix of n rows of length n (rows = n). `n_valids` is not read
// (nullptr); the parameter list is the one the kernel had as a template on
// kBatched, so that it keeps its compiled code.
template <bool kExclude>
__global__ void __launch_bounds__(kRowThreads)
row_max_kernel(const float* __restrict__ a, float* __restrict__ out, int rows,
               int n, int n_valid, const int* __restrict__ n_valids,
               int vec) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kRowWarps;
  for (int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5); r < rows;
       r += warps) {
    int i, nv;
    row_position<false>(r, n, n_valid, n_valids, i, nv);
    const float m = row_max_value<kExclude>(a + (size_t)r * n, i, nv,
                                            vec != 0, lane);
    if (lane == 0) out[r] = m;
  }
}

// 2b. Batched row max, for the short rows of a chunk (4 KB at N=1024).
// Replaces row_max_pallas under the batched step's vmap. The 2-D kernel's
// one-wave grid (above) gave each warp about two rows of the batch in turn,
// far apart, each read in two dependent rounds of kRowUnroll loads. Here a
// warp takes one row and a lane issues all its loads of a kRbLoads·512-byte
// stretch (the whole row at N=1024) before it reduces any; the grid is one
// warp per row, B·N / 8 blocks with no stride, which the block scheduler
// hands out in order, so the batch is read as one sweep with no occupancy
// query. Bound: the B·N·n_valid floats read once, 67 MB -> 0.020 ms at
// (16, 1024). With kExclude the max starts at 0, the diagonal's value, and
// column i is read with the rest and dropped, so the two column ranges of
// the 2-D kernel are one. A max is order-free: the twin's bits, and the
// 2-D kernel's.
constexpr int kRbLoads = 8;

template <bool kExclude>
__global__ void __launch_bounds__(kRowThreads)
row_max_batched_kernel(const float* __restrict__ a, float* __restrict__ out,
                       int rows, int n, const int* __restrict__ n_valids,
                       int vec) {
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  // Row i of utterance r / n, valid columns its n_valid clamped to [0, n],
  // or all n without n_valids.
  const int utterance = r / n;
  const int i = r - utterance * n;
  const int nv = n_valids ? min(max(n_valids[utterance], 0), n) : n;
  const float* row = a + (size_t)r * n;
  float m = kExclude ? 0.0f : -INFINITY;
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int n4 = nv >> 2;
    for (int c0 = lane; c0 < n4; c0 += 32 * kRbLoads) {
      float4 v[kRbLoads];
#pragma unroll
      for (int u = 0; u < kRbLoads; ++u) {
        const int c = c0 + 32 * u;
        v[u] = c < n4 ? row4[c]
                      : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                    -INFINITY);
      }
#pragma unroll
      for (int u = 0; u < kRbLoads; ++u) {
        if (kExclude && c0 + 32 * u == (i >> 2)) {
          const int e = i & 3;
          v[u].x = e == 0 ? -INFINITY : v[u].x;
          v[u].y = e == 1 ? -INFINITY : v[u].y;
          v[u].z = e == 2 ? -INFINITY : v[u].z;
          v[u].w = e == 3 ? -INFINITY : v[u].w;
        }
        m = fmaxf(m, fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w)));
      }
    }
    // The at most three columns past the last whole float4.
    const int c = 4 * n4 + lane;
    if (c < nv && !(kExclude && c == i)) m = fmaxf(m, row[c]);
  } else {
    for (int c0 = lane; c0 < nv; c0 += 32 * kRbLoads) {
      float v[kRbLoads];
#pragma unroll
      for (int u = 0; u < kRbLoads; ++u) {
        const int c = c0 + 32 * u;
        v[u] = c < nv && !(kExclude && c == i) ? row[c] : -INFINITY;
      }
#pragma unroll
      for (int u = 0; u < kRbLoads; ++u) m = fmaxf(m, v[u]);
    }
  }
  m = warp_max(m);
  if (lane == 0) out[r] = m;
}

template <bool kBatched>
__global__ void __launch_bounds__(kRowThreads)
crop_diagonal_kernel(const float* a, float* out, int rows, int n, int n_valid,
                     const int* __restrict__ n_valids, int vec) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kRowWarps;
  for (int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5); r < rows;
       r += warps) {
    int i, nv;
    row_position<kBatched>(r, n, n_valid, n_valids, i, nv);
    const float* row = a + (size_t)r * n;
    float* orow = out + (size_t)r * n;
    if (out != a) {
      int start = lane;
      if (vec) {
        const float4* row4 = reinterpret_cast<const float4*>(row);
        float4* orow4 = reinterpret_cast<float4*>(orow);
        for (int c4 = lane; c4 < (n >> 2); c4 += 32) orow4[c4] = row4[c4];
        start = 4 * (n >> 2) + lane;
      }
      for (int c = start; c < n; c += 32) orow[c] = row[c];
    }
    // The row max never reads column i, and row i is only this warp's, so
    // the in-place write races with nothing; __syncwarp orders the copy of
    // column i before lane 0 overwrites it.
    const float m = row_max_value<true>(row, i, nv, vec != 0, lane);
    __syncwarp();
    if (lane == 0) orow[i] = m;
  }
}

// The card's SMs, and the blocks of a warp-per-row kernel resident on one
// SM: asked once per process, which drives one card.
int sm_count() {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return sms;
}

template <auto kKernel>
int row_resident_blocks() {
  static const int blocks = [] {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel,
                                                  kRowThreads, 0);
    return per_sm;
  }();
  return blocks;
}

// Blocks of a warp-per-row kernel over `rows` rows: the card's resident
// warps, cut so that every warp takes the same number of rows (one warp per
// row if the occupancy query failed; the launch then reports its error).
template <auto kKernel>
int row_blocks(int rows) {
  const int resident = sm_count() * row_resident_blocks<kKernel>() * kRowWarps;
  if (rows <= 0 || resident <= 0) return cdiv(rows > 0 ? rows : 1, kRowWarps);
  const int rows_per_warp = cdiv(rows, resident);
  return cdiv(cdiv(rows, rows_per_warp), kRowWarps);
}

// ---------------------------------------------------------------------------
// 4. RowWiseThreshold + Symmetrize in one pass.
//
// Replaces threshold_symmetrize_general_pallas / _thresh_sym_kernel
// (kernels/fused.py:148-218): T(x; m) = x < m ? x·mult : (binarize ? 1 : x)
// with m the row's threshold, then out[i,j] = max (or mean) of
// T(A[i,j]; thr_i) and T(A[j,i]; thr_j); preserve_diagonal zeroes the
// diagonal first and sets it to 1 last. Bound: N² floats read and N²
// written, 0.84 GB -> 0.25 ms at N=10240. The TPU kernel reads each tile
// twice (once as (i,j), once as the transposed operand of (j,i)). Here the
// output is symmetric, so one block takes the tile pair (i,j)/(j,i) with
// i <= j: it loads both 32x32 tiles once into shared memory (rows padded by
// one float so the transposed reads hit distinct banks), computes, and
// writes both output tiles, each row of a tile coalesced. Blocks below the
// diagonal of the tile grid exit at once. Thresholds are a per-row (N, 1)
// input and the flags are arguments, so a new p_percentile needs no
// rebuild.
// ---------------------------------------------------------------------------

constexpr int kTsTile = 32;
constexpr int kTsRows = 8;

__device__ __forceinline__ float soft_threshold(float x, float m, float mult,
                                                bool binarize) {
  return x < m ? x * mult : (binarize ? 1.0f : x);
}

__device__ __forceinline__ float sym_value(float x, float thr_x, float y,
                                           float thr_y, bool diag, float mult,
                                           bool binarize, bool preserve,
                                           bool average) {
  if (preserve && diag) return 1.0f;
  const float tx = soft_threshold(x, thr_x, mult, binarize);
  const float ty = soft_threshold(y, thr_y, mult, binarize);
  return average ? 0.5f * (tx + ty) : fmaxf(tx, ty);
}

// kBatched: utterance blockIdx.z of a batch, its matrix, thresholds and
// output (a template argument, as for the affinity).
template <bool kBatched>
__global__ void __launch_bounds__(kTsTile * kTsRows)
threshold_symmetrize_kernel(const float* __restrict__ a,
                            const float* __restrict__ thr,
                            float* __restrict__ out, int n, float mult,
                            int binarize, int preserve, int average) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bi > bj) return;
  if (kBatched) {
    a += (size_t)blockIdx.z * n * n;
    thr += (size_t)blockIdx.z * n;
    out += (size_t)blockIdx.z * n * n;
  }
  __shared__ float s1[kTsTile][kTsTile + 1];  // A[bi rows, bj cols]
  __shared__ float s2[kTsTile][kTsTile + 1];  // A[bj rows, bi cols]
  const int tx = threadIdx.x;
  const int r0 = bi * kTsTile;
  const int c0 = bj * kTsTile;
  for (int r = threadIdx.y; r < kTsTile; r += kTsRows) {
    const int g1r = r0 + r, g1c = c0 + tx;
    s1[r][tx] = (g1r < n && g1c < n) ? a[(size_t)g1r * n + g1c] : 0.0f;
    const int g2r = c0 + r, g2c = r0 + tx;
    s2[r][tx] = (g2r < n && g2c < n) ? a[(size_t)g2r * n + g2c] : 0.0f;
  }
  __syncthreads();
  const bool bin = binarize != 0, pres = preserve != 0, avg = average != 0;
  for (int r = threadIdx.y; r < kTsTile; r += kTsRows) {
    const int gr = r0 + r, gc = c0 + tx;
    if (gr < n && gc < n) {
      out[(size_t)gr * n + gc] = sym_value(s1[r][tx], thr[gr], s2[tx][r],
                                           thr[gc], gr == gc, mult, bin,
                                           pres, avg);
    }
  }
  if (bi == bj) return;
  for (int r = threadIdx.y; r < kTsTile; r += kTsRows) {
    const int gr = c0 + r, gc = r0 + tx;
    if (gr < n && gc < n) {
      out[(size_t)gr * n + gc] = sym_value(s2[r][tx], thr[gr], s1[tx][r],
                                           thr[gc], false, mult, bin, pres,
                                           avg);
    }
  }
}

// ---------------------------------------------------------------------------
// 5. RowWiseNormalize: out = A / rowmax(A).
//
// Replaces row_wise_normalize_pallas / _row_norm_kernel (kernels/fused.py:
// 262-283), which runs row_max_pallas (over columns < n_valid, diagonal
// included) and then a second N² pass dividing each tile by its rows'
// maxima. Every column is divided, as there; rows >= n_valid keep the max
// of their valid columns, and the callers re-mask padding. Bound: N² read
// + N² written, 0.84 GB -> 0.25 ms at N=10240. Design: one block per row,
// the row max with 16-byte loads, a warp shuffle and one shared-memory
// step across the block's warps, then a second pass over the same row
// writing a / m. A row is 40 KB at N=10240, so that second read comes from
// the 50 MB L2, not from HBM. The division is IEEE (no --use_fast_math,
// no reciprocal), so the result equals the twin's `mat / rowmax` bit for
// bit; a row whose valid max is 0 gives 0/0 = NaN there as in the twin.
// Batched form (5b): the grid is the batch's B·N rows, block r a row of
// utterance r / N with that utterance's n_valid (row_position<true>), so
// each matrix gets the bits the one-matrix form gives it. Bound at
// (B, N) = (16, 1024): 2·B·N²·4 B = 134 MB -> 0.040 ms.
// ---------------------------------------------------------------------------

template <bool kBatched>
__global__ void __launch_bounds__(kRowThreads)
row_wise_normalize_kernel(const float* __restrict__ a, float* __restrict__ out,
                          int n, int n_valid, const int* __restrict__ n_valids,
                          int vec) {
  __shared__ float warp_maxima[kRowThreads / 32];
  const int tid = threadIdx.x;
  int i, nv;
  row_position<kBatched>(blockIdx.x, n, n_valid, n_valids, i, nv);
  const size_t base = (size_t)blockIdx.x * n;
  const float* row = a + base;
  float* orow = out + base;

  float m = -INFINITY;
  int start = tid;
  if (vec) {
    // Row starts are 16-byte aligned (n % 4 == 0, checked by the caller).
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int lim4 = nv >> 2;
    for (int c4 = tid; c4 < lim4; c4 += kRowThreads) {
      const float4 v = row4[c4];
      m = fmaxf(fmaxf(m, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
    }
    start = (lim4 << 2) + tid;
  }
  for (int c = start; c < nv; c += kRowThreads) m = fmaxf(m, row[c]);
  m = warp_max(m);
  if ((tid & 31) == 0) warp_maxima[tid >> 5] = m;
  __syncthreads();
  m = warp_maxima[0];
#pragma unroll
  for (int w = 1; w < kRowThreads / 32; ++w) m = fmaxf(m, warp_maxima[w]);

  start = tid;
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    float4* orow4 = reinterpret_cast<float4*>(orow);
    const int lim4 = n >> 2;
    for (int c4 = tid; c4 < lim4; c4 += kRowThreads) {
      const float4 v = row4[c4];
      orow4[c4] = make_float4(v.x / m, v.y / m, v.z / m, v.w / m);
    }
    start = (lim4 << 2) + tid;
  }
  for (int c = start; c < n; c += kRowThreads) orow[c] = row[c] / m;
}

// The grid's y and z dimensions, which carry a batch's utterance index.
constexpr int kMaxGridYZ = 65535;

cudaError_t launch_affinity(const float* xt, float* out, int n, int ld,
                            int d_pad, cudaStream_t stream) {
  // xt is xnᵀ zero-padded to (d_pad, ld): whole k slices, whole tiles.
  if (ld % kAffTile != 0 || ld < n || d_pad % kAffDepth != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t attr = affinity_smem_opt_in();
  if (attr != cudaSuccess) return attr;
  const int tiles = cdiv(n, kAffTile);
  affinity_kernel<<<tiles * (tiles + 1) / 2, kAffThreads, kAffSmemBytes,
                    stream>>>(xt, out, n, ld, d_pad / kAffDepth);
  return cudaGetLastError();
}

// Blocks of the batched affinity resident on one SM (2 by its launch
// bounds and shared memory); asked once per process.
int affinity_batched_resident() {
  static const int blocks = [] {
    int per_sm = 0;
    if (affinity_batched_smem_opt_in() != cudaSuccess) return 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, affinity_batched_kernel, kAffThreads, kAbSmemBytes);
    return per_sm;
  }();
  return blocks;
}

// The batched affinity's diagonal tiles that come split in two, so that
// small blocks fill the last wave: a quarter of the card's resident slots.
int affinity_batched_split(int b, int n) {
  const long long diagonal = (long long)b * cdiv(n, kAffTile);
  const int quarter = sm_count() * affinity_batched_resident() / 4;
  return static_cast<int>(diagonal < quarter ? diagonal : quarter);
}

// The batched affinity's grid: b·T(T-1)/2 off-diagonal tile pairs, b·T
// diagonal tiles, and `split` of these twice, for T = ceil(n/128).
long long affinity_batched_blocks(int b, int n, int split) {
  const long long tiles = cdiv(n, kAffTile);
  return b * (tiles * (tiles + 1) / 2) + split;
}

cudaError_t launch_affinity_batched(const float* xn, float* out, int b, int n,
                                    int d4, cudaStream_t stream) {
  if (b < 1 || n < 1 || d4 < 0 || d4 % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(xn) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t attr = affinity_batched_smem_opt_in();
  if (attr != cudaSuccess) return attr;
  const int split = affinity_batched_split(b, n);
  const long long blocks = affinity_batched_blocks(b, n, split);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  affinity_batched_kernel<<<static_cast<int>(blocks), kAffThreads,
                            kAbSmemBytes, stream>>>(
      xn, out, b, n, d4, cdiv(d4, kAffDepth), cdiv(n, kAffTile), split);
  return cudaGetLastError();
}

cudaError_t launch_row_max(const float* a, float* out, int n, int n_valid,
                           int exclude_diagonal, int vec,
                           cudaStream_t stream) {
  if (exclude_diagonal) {
    const int grid = row_blocks<row_max_kernel<true>>(n);
    row_max_kernel<true><<<grid, kRowThreads, 0, stream>>>(
        a, out, n, n, n_valid, nullptr, vec);
  } else {
    const int grid = row_blocks<row_max_kernel<false>>(n);
    row_max_kernel<false><<<grid, kRowThreads, 0, stream>>>(
        a, out, n, n, n_valid, nullptr, vec);
  }
  return cudaGetLastError();
}

cudaError_t launch_row_max_batched(const float* a, float* out, int rows,
                                   int n, const int* n_valids,
                                   int exclude_diagonal, int vec,
                                   cudaStream_t stream) {
  const int grid = cdiv(rows, kRowWarps);
  if (exclude_diagonal) {
    row_max_batched_kernel<true><<<grid, kRowThreads, 0, stream>>>(
        a, out, rows, n, n_valids, vec);
  } else {
    row_max_batched_kernel<false><<<grid, kRowThreads, 0, stream>>>(
        a, out, rows, n, n_valids, vec);
  }
  return cudaGetLastError();
}

template <bool kBatched>
cudaError_t launch_crop_diagonal(const float* a, float* out, int rows, int n,
                                 int n_valid, const int* n_valids, int vec,
                                 cudaStream_t stream) {
  const int grid = row_blocks<crop_diagonal_kernel<kBatched>>(rows);
  crop_diagonal_kernel<kBatched><<<grid, kRowThreads, 0, stream>>>(
      a, out, rows, n, n_valid, n_valids, vec);
  return cudaGetLastError();
}

cudaError_t launch_threshold_symmetrize(const float* a, const float* thr,
                                        float* out, int b, int n,
                                        float multiplier, int binarize,
                                        int preserve_diagonal, int average,
                                        cudaStream_t stream) {
  if (b < 1 || b > kMaxGridYZ) return cudaErrorInvalidValue;
  const int tiles = cdiv(n, kTsTile);
  const dim3 grid(tiles, tiles, b);
  const dim3 block(kTsTile, kTsRows);
  if (b == 1) {
    threshold_symmetrize_kernel<false><<<grid, block, 0, stream>>>(
        a, thr, out, n, multiplier, binarize, preserve_diagonal, average);
  } else {
    threshold_symmetrize_kernel<true><<<grid, block, 0, stream>>>(
        a, thr, out, n, multiplier, binarize, preserve_diagonal, average);
  }
  return cudaGetLastError();
}

// B·n rows must fit the kernels' int row index.
bool rows_fit(int b, int n) {
  return b >= 1 && (long long)b * n <= 2147483647LL;
}


// ---------------------------------------------------------------------------
// 6. The subspace solver's panel product: y = a x, a (m, k) float32, x (k, c).
//
// Replaces no Pallas kernel: the JAX package's subspace iteration computes
// it as an XLA dot (spectralcluster_tpu/ops/eigen.py:415-427, the residual
// of ops/dc.py:1080). Its rounding error is noise that every iteration
// puts back into the panel, and it sets how far the solver's residual
// falls: with cuBLAS's float32 product the certified route of ops/dc.py
// declines at N=20480 (its residual settles near 9e-6 of the operand's
// scale, above the 1e-5 limit of res_abs), and at N=10240 it runs to its
// iteration cap where a float64 product certifies within 200 iterations.
// Accumulation: every product of two float32 values is exact in float64;
// each output is a float64 sum over each of S ranges of k, the S partial
// sums are added in range order in float64, and the total is rounded to
// float32 once. The orders are fixed by the shape (no atomics), so the
// result does not depend on the run or the launch. No TF32, no
// --use_fast_math.
// Bound: one read of a (m·k·4 bytes: 0.42 GB at N=10240 -> 0.125 ms at
// 3.35 TB/s). Its 2·m·k·c float64 operations (3.4 GFLOP at c=16 -> 0.05
// ms at the float64 tensor-core peak, 67 TFLOP/s) cost less, but only if
// the MMAs overlap the loads. Design:
//  * a goes from device memory straight into registers, each lane four
//    16-byte loads per 32-deep tile of its warp's 16 rows, kPanelStages
//    tiles ahead of the MMAs: no shared memory and no barrier between a
//    load of a and its use, and ~80 KB in flight per SM at two blocks.
//  * sm_90's float64 MMA m16n8k8. Inside a 32-deep tile the order of k is
//    permuted so that each lane's A fragments are its own loads: lane
//    (g, t) holds columns 4t..4t+3 and 16+4t..16+4t+3 of rows g and g+8,
//    and MMA s of the tile takes column 4t+s as its k index t and column
//    16+4t+s as t+4. Each element of a is converted to float64 once. The
//    sums cover the same products in another fixed order.
//  * x is staged kPanelStages tiles at a time in shared memory, converted
//    to float64 and laid out in that fragment order (one 16-byte shared
//    load per lane per MMA), in two buffers: one barrier per chunk. x is
//    read at its own strides, so the solver's transposed panels need no
//    copy.
//  * the k split: a thread-block cluster of S blocks (grid y), one range
//    of k each. At the end each block puts its float64 partial sums in its
//    own shared memory, and block r of the cluster adds the S partials of
//    its share of the outputs in rank order through distributed shared
//    memory, then rounds once. One launch, no scratch. S ≤ 8 is chosen so
//    that the launch fills the card's resident blocks in whole waves; each
//    block walks its range from its own starting tile, spread over the row
//    blocks, so that the blocks that run at once read different columns.
//  * up to 32 columns (four 8-column MMA groups) per launch.
// A row pitch or base that is not 16-byte aligned (an odd-width operand)
// takes the same kernel with 4-byte loads (VEC false).
// ---------------------------------------------------------------------------

constexpr int kPanelWarps = 8;
constexpr int kPanelThreads = 32 * kPanelWarps;
constexpr int kPanelWarpRows = 16;
constexpr int kPanelBlockRows = kPanelWarps * kPanelWarpRows;
constexpr int kPanelTileK = 32;
constexpr int kPanelStages = 3;
constexpr int kPanelChunkK = kPanelStages * kPanelTileK;
constexpr int kPanelCols = 32;
constexpr int kPanelMaxSplit = 8;

// x's chunk in fragment order, two buffers: [buffer][tile][MMA s][column
// group][lane] = (b0, b1). 12 KB per column group; the block's float64
// partial sums ((kPanelBlockRows, 8·NG), 8 KB per group) reuse it.
template <int NG>
struct PanelSmem {
  double2 x[2][kPanelStages][4][NG][32];
};

// One warp's 32-deep tile of a: columns 4t.. and 16+4t.. (lo, hi) of rows
// g (0) and g+8 (1).
struct PanelTile {
  float4 lo0, hi0, lo1, hi1;
};

__device__ __forceinline__ float f4_at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <bool VEC>
__device__ __forceinline__ void panel_load(PanelTile& p, const float* r0,
                                           const float* r1, int k0, int k_hi,
                                           int tig) {
  const int c0 = k0 + 4 * tig;
  const int c1 = c0 + 16;
  if (VEC && k0 + kPanelTileK <= k_hi) {
    p.lo0 = __ldcs(reinterpret_cast<const float4*>(r0 + c0));
    p.hi0 = __ldcs(reinterpret_cast<const float4*>(r0 + c1));
    p.lo1 = __ldcs(reinterpret_cast<const float4*>(r1 + c0));
    p.hi1 = __ldcs(reinterpret_cast<const float4*>(r1 + c1));
  } else {
    // Past k_hi the tile is zero: x is zero there too, and 0·0 adds an
    // exact zero.
    float v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in0 = c0 + i < k_hi, in1 = c1 + i < k_hi;
      v[0][i] = in0 ? __ldcs(r0 + c0 + i) : 0.0f;
      v[1][i] = in1 ? __ldcs(r0 + c1 + i) : 0.0f;
      v[2][i] = in0 ? __ldcs(r1 + c0 + i) : 0.0f;
      v[3][i] = in1 ? __ldcs(r1 + c1 + i) : 0.0f;
    }
    p.lo0 = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
    p.hi0 = make_float4(v[1][0], v[1][1], v[1][2], v[1][3]);
    p.lo1 = make_float4(v[2][0], v[2][1], v[2][2], v[2][3]);
    p.hi1 = make_float4(v[3][0], v[3][1], v[3][2], v[3][3]);
  }
}

// d += a b for a 16 x 8 x 8 float64 MMA; A fragment (g, t), (g+8, t),
// (g, t+4), (g+8, t+4), B (t, g), (t+4, g), D (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1) for lane 4g + t.
__device__ __forceinline__ void mma_f64_16x8x8(double (&d)[4], double a0,
                                               double a1, double a2,
                                               double a3, double b0,
                                               double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// a: the batch's matrices at stride_a, rows lda apart; x: (k, c_all)
// float32 per matrix at stride_x, entry (i, j) at i·x_row + j·x_col,
// columns [col0, col0 + 8·NG) used; y: (batch, m, c_all) float32. Block
// (row block, split, matrix); the splits of a row block form a cluster.
template <int NG, bool VEC>
__global__ void __launch_bounds__(kPanelThreads, NG <= 2 ? 2 : 1)
panel_matmul_kernel(const float* __restrict__ a, const float* __restrict__ x,
                    float* __restrict__ y, int m, int k, long long lda,
                    long long stride_a, long long x_row, long long x_col,
                    long long stride_x, int c_all, int col0, int per_tiles) {
  __shared__ PanelSmem<NG> smem;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane >> 2;
  const int tig = lane & 3;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int z = blockIdx.z;
  const int c = min(8 * NG, c_all - col0);
  a += z * stride_a;
  x += z * stride_x + col0 * x_col;
  // Rows past m repeat row m - 1; their sums are never written.
  const int row0 = blockIdx.x * kPanelBlockRows + warp * kPanelWarpRows;
  const float* r0 = a + (long long)min(row0 + group, m - 1) * lda;
  const float* r1 = a + (long long)min(row0 + group + 8, m - 1) * lda;
  const int k_lo = min(k, split * per_tiles * kPanelTileK);
  const int k_hi = min(k, k_lo + per_tiles * kPanelTileK);
  const int tiles = cdiv_device(k_hi - k_lo, kPanelTileK);
  const int chunks = cdiv_device(tiles, kPanelStages);
  // The block walks its range's tiles from its own starting tile, the row
  // blocks' starts spread evenly over the range, so that the blocks that
  // run at once read different columns of a and rows of x (at b=16,
  // 13-17% faster at N=10240 and 20480 than one start for all;
  // tools/panel_matmul_sweep.py).
  const int rot =
      tiles > 0 ? (int)((long long)(blockIdx.x + z * gridDim.x) * tiles /
                        ((long long)gridDim.x * gridDim.z))
                : 0;
  auto tile_k0 = [&](int step) {
    const int t = step + rot;
    return k_lo + (t < tiles ? t : t - tiles) * kPanelTileK;
  };

  // x's chunk: kPanelChunkK x 8·NG values, kPanelThreads apart, k fastest.
  constexpr int kXPer = kPanelChunkK * 8 * NG / kPanelThreads;
  float xv[kXPer];
  auto x_load = [&](int ch) {
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = threadIdx.x + i * kPanelThreads;
      const int kk = e % kPanelChunkK, j = e / kPanelChunkK;
      const int step = ch * kPanelStages + kk / kPanelTileK;
      const int row = step < tiles ? tile_k0(step) + kk % kPanelTileK : k_hi;
      xv[i] = (row < k_hi && j < c)
                  ? __ldg(x + (long long)row * x_row + (long long)j * x_col)
                  : 0.0f;
    }
  };
  auto x_store = [&](int buf) {
    double* base = reinterpret_cast<double*>(&smem.x[buf][0][0][0][0]);
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = threadIdx.x + i * kPanelThreads;
      const int kk = e % kPanelChunkK, j = e / kPanelChunkK;
      const int tile = kk / kPanelTileK, r = kk % kPanelTileK;
      const int half = r >> 4, t = (r & 15) >> 2, s = r & 3;
      const int n = j >> 3, g = j & 7;
      base[(((tile * 4 + s) * NG + n) * 32 + g * 4 + t) * 2 + half] =
          static_cast<double>(xv[i]);
    }
  };

  double acc[NG][4];
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0;
  }
  PanelTile pre[kPanelStages];
#pragma unroll
  for (int d = 0; d < kPanelStages; ++d) {
    if (d < tiles) panel_load<VEC>(pre[d], r0, r1, tile_k0(d), k_hi, tig);
  }
  if (chunks > 0) {
    x_load(0);
    x_store(0);
  }
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    const bool next = ch + 1 < chunks;
    if (next) x_load(ch + 1);
#pragma unroll
    for (int d = 0; d < kPanelStages; ++d) {
      const int tile = ch * kPanelStages + d;
      if (tile < tiles) {
        const double2(&xs)[4][NG][32] = smem.x[buf][d];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const double a0 = f4_at(pre[d].lo0, s), a1 = f4_at(pre[d].lo1, s);
          const double a2 = f4_at(pre[d].hi0, s), a3 = f4_at(pre[d].hi1, s);
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            const double2 bb = xs[s][n][lane];
            mma_f64_16x8x8(acc[n], a0, a1, a2, a3, bb.x, bb.y);
          }
        }
        if (tile + kPanelStages < tiles) {
          panel_load<VEC>(pre[d], r0, r1, tile_k0(tile + kPanelStages), k_hi,
                          tig);
        }
      }
    }
    if (next) x_store(buf ^ 1);
    __syncthreads();
  }

  // The block's partial sums, (kPanelBlockRows, 8·NG) float64, in the x
  // buffers (free after the loop's last barrier).
  constexpr int kW = 8 * NG;
  double* part = reinterpret_cast<double*>(&smem);
  const int prow = warp * kPanelWarpRows + group;
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    const int col = 8 * n + 2 * tig;
    part[prow * kW + col] = acc[n][0];
    part[prow * kW + col + 1] = acc[n][1];
    part[(prow + 8) * kW + col] = acc[n][2];
    part[(prow + 8) * kW + col + 1] = acc[n][3];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // Block `split` (its rank in the cluster) adds its share of the outputs
  // over the cluster's blocks in rank order, and rounds once.
  constexpr int kTotal = kPanelBlockRows * kW;
  const int share = cdiv_device(kTotal, splits);
  const int e_hi = min(kTotal, (split + 1) * share);
  for (int e = split * share + threadIdx.x; e < e_hi; e += kPanelThreads) {
    const int r = e / kW, col = e % kW;
    const int row = blockIdx.x * kPanelBlockRows + r;
    if (row < m && col < c) {
      double sum = 0.0;
      for (int j = 0; j < splits; ++j) {
        sum += cluster.map_shared_rank(part, j)[e];
      }
      y[((long long)z * m + row) * c_all + col0 + col] =
          static_cast<float>(sum);
    }
  }
  // No block leaves while the others read its shared memory.
  cluster.sync();
}

cudaLaunchConfig_t panel_config(dim3 grid, cudaLaunchAttribute* attr,
                                cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kPanelThreads);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = grid.y;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Blocks of the kernel resident on the card at once, asked once per
// kernel (the card's SMs if the query fails).
template <int NG, bool VEC>
int panel_resident_blocks() {
  static const int blocks = [] {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, panel_matmul_kernel<NG, VEC>, kPanelThreads, 0) !=
            cudaSuccess ||
        per_sm < 1) {
      cudaGetLastError();
      per_sm = 1;
    }
    return per_sm * sm_count();
  }();
  return blocks;
}

// The k split S of a launch of `blocks` row blocks over `tiles` 32-deep
// tiles: the S ≤ kPanelMaxSplit (each range at least kPanelStages tiles)
// whose launch fills the most of its last wave of resident blocks, a
// larger S only where it fills 5% more. S = 3 and 6 are left out: at
// N=10240 and 20480 and on a 5120-row stripe of 20480 they ran 1.05-1.56x
// slower than the S chosen (tools/panel_matmul_sweep.py times every S).
template <int NG, bool VEC>
int panel_splits(long long blocks, int tiles) {
  const long long slots = panel_resident_blocks<NG, VEC>();
  int best = 1;
  double best_fill = -1.0;
  for (int s = 1; s <= kPanelMaxSplit; ++s) {
    if (s > 1 && tiles < s * kPanelStages) break;
    if (s % 3 == 0) continue;
    const long long launched = blocks * s;
    const long long waves = (launched + slots - 1) / slots;
    const double fill = (double)launched / (double)(waves * slots);
    if (fill > best_fill + 0.05) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

template <int NG, bool VEC>
cudaError_t launch_panel_group(const float* a, const float* x, float* y,
                               int batch, int m, int k, long long lda,
                               long long stride_a, long long x_row,
                               long long x_col, long long stride_x, int c_all,
                               int col0, cudaStream_t stream,
                               int* splits_out) {
  const int row_blocks = cdiv(m, kPanelBlockRows);
  const int tiles = cdiv(k, kPanelTileK);
  const int splits = panel_splits<NG, VEC>((long long)row_blocks * batch,
                                           tiles);
  if (splits_out != nullptr) {
    splits_out[0] = splits;
    splits_out[1] = panel_resident_blocks<NG, VEC>();
    return cudaSuccess;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = panel_config(
      dim3(row_blocks, splits, batch), &attr, stream);
  return cudaLaunchKernelEx(&cfg, panel_matmul_kernel<NG, VEC>, a, x, y, m,
                            k, lda, stride_a, x_row, x_col, stride_x, c_all,
                            col0, cdiv(tiles, splits));
}

// One launch per kPanelCols columns; vec: a's rows start 16-byte aligned.
// With splits_out set nothing is launched: the first launch's k split and
// the card's resident blocks of its kernel are written there.
cudaError_t launch_panel_matmul(const float* a, const float* x, float* y,
                                int batch, int m, int k, long long lda,
                                long long stride_a, int c_all,
                                long long x_row, long long x_col,
                                long long stride_x, bool vec,
                                cudaStream_t stream,
                                int* splits_out = nullptr) {
  if (batch < 1 || batch > kMaxGridYZ || m < 1 || k < 1 || c_all < 1 ||
      lda < k) {
    return cudaErrorInvalidValue;
  }
  for (int col0 = 0; col0 < c_all; col0 += kPanelCols) {
    const int groups = cdiv(std::min(kPanelCols, c_all - col0), 8);
    cudaError_t err = cudaErrorInvalidValue;
    switch (groups * 2 + (vec ? 1 : 0)) {
#define SCT_PANEL_CASE(NG)                                                  \
  case NG * 2:                                                              \
    err = launch_panel_group<NG, false>(a, x, y, batch, m, k, lda,          \
                                        stride_a, x_row, x_col, stride_x,   \
                                        c_all, col0, stream, splits_out);   \
    break;                                                                  \
  case NG * 2 + 1:                                                          \
    err = launch_panel_group<NG, true>(a, x, y, batch, m, k, lda,           \
                                       stride_a, x_row, x_col, stride_x,    \
                                       c_all, col0, stream, splits_out);    \
    break;
      SCT_PANEL_CASE(1) SCT_PANEL_CASE(2) SCT_PANEL_CASE(3) SCT_PANEL_CASE(4)
#undef SCT_PANEL_CASE
    }
    if (err != cudaSuccess || splits_out != nullptr) return err;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 7. Shifted CholeskyQR passes: q = y L⁻ᵀ, L Lᵀ = g + δ·I,
//    δ = rel · max(diag g), for a (k, b) panel y and its Gram g; the pair
//    form computes the 1e-6 pass and its 1e-2 rescue in one launch.
//
// Replaces no Pallas kernel: the JAX package's cholqr2_shifted
// (spectralcluster_tpu/ops/eigen.py:280-304) runs a Cholesky and a
// triangular solve through XLA, at the 1e-6 shift and at the 1e-2 one, and
// takes the second where the first failed or left a non-finite value. The
// pass leaves q short of orthonormal by δ·(g + δI)⁻¹, about 1e-6, which is
// where the subspace solver's residual test stops (1e-6), so the rounding
// of L's diagonal and of the solve decides whether the certified route of
// ops/dc.py stops before its iteration cap. This kernel rounds as LAPACK's
// unblocked float32 routines do: each entry of L one fmaf chain in k order
// and one correctly rounded division or square root (spotf2), and each row
// of q solved forward the same way (strsm); cuSOLVER's and cuBLAS's float32
// routines round otherwise. IEEE float32 only, no --use_fast_math.
// Bound: one read of y and one write of each q (3·k·b·4 bytes for the
// pair: 3.9 MB at N=20480, b=16 -> 1.2 µs); the (b, b) Choleskys are
// sequential. Design: in every block warp 0 factors g + δI and, in the
// pair form, warp 1 g + δ'I, in shared memory (column by column, lanes
// over the rows below the diagonal); then each thread reads one row of y
// once into registers, solves it against each factor and writes each q
// transposed ((b, k) row-major), so a warp's stores of one column are
// coalesced. The failed column of the first factor (1-based, 0 when none),
// as LAPACK's info, goes to `info`. The pair form also writes `bad`: 1
// where the first pass failed or left a non-finite value in the panel. Its
// blocks OR their rows' finiteness into a word of `ticket` (an integer OR:
// no order); the last block of the panel to count itself in (an integer
// counter in the same workspace) writes `bad` and resets both words, so
// the workspace is zero between launches and nothing is filled per call.
// Launches on one workspace must run in stream order.
// ---------------------------------------------------------------------------

constexpr int kQrThreads = 256;

// Warp 0's lanes of a block factor g + δI into l, δ = rel·max(diag g)
// (spotf2's rounding); failed is the failed column, 1-based, 0 if none.
template <int BMAX>
__device__ void cholqr_factor(float (&l)[BMAX][BMAX + 1], int& failed,
                              const float* __restrict__ g, int b,
                              float delta_rel, int lane) {
  float gmax = 0.0f;
  for (int j = 0; j < b; ++j) gmax = fmaxf(gmax, g[j * b + j]);
  const float delta = delta_rel * fmaxf(gmax, 1e-30f);
  for (int e = lane; e < b * b; e += 32) {
    const int i = e / b, j = e % b;
    if (i >= j) l[i][j] = g[i * b + j] + (i == j ? delta : 0.0f);
  }
  if (lane == 0) failed = 0;
  __syncwarp();
  for (int j = 0; j < b; ++j) {
    if (lane == 0 && failed == 0) {
      float s = l[j][j];
      for (int c = 0; c < j; ++c) s = fmaf(-l[j][c], l[j][c], s);
      if (!(s > 0.0f)) {
        failed = j + 1;
        l[j][j] = s;
      } else {
        l[j][j] = sqrtf(s);
      }
    }
    __syncwarp();
    if (failed) break;
    for (int i = j + 1 + lane; i < b; i += 32) {
      float s = l[i][j];
      for (int c = 0; c < j; ++c) s = fmaf(-l[i][c], l[j][c], s);
      l[i][j] = s / l[j][j];
    }
    __syncwarp();
  }
  if (failed) {
    // Past the failed column L is undefined, as LAPACK leaves it: NaN,
    // so every row of q is NaN and the caller's finiteness check sees it.
    for (int e = lane; e < b * b; e += 32) {
      const int i = e / b, j = e % b;
      if (i >= j && j + 1 >= failed) l[i][j] = __int_as_float(0x7fc00000);
    }
  }
  __syncwarp();
}

// The forward solve of one row, y L⁻ᵀ, in strsm's order.
template <int BMAX>
__device__ __forceinline__ void cholqr_solve(const float (&l)[BMAX][BMAX + 1],
                                             const float (&yv)[BMAX],
                                             float (&xo)[BMAX], int b) {
#pragma unroll
  for (int j = 0; j < BMAX; ++j) {
    if (j < b) {
      float s = yv[j];
#pragma unroll
      for (int c = 0; c < j; ++c) s = fmaf(-l[j][c], xo[c], s);
      xo[j] = s / l[j][j];
    }
  }
}

// qt: the first pass's q of each panel ((b, k), batch of them), then in
// the pair form the rescue's.
template <int BMAX, bool kPair>
__global__ void __launch_bounds__(kQrThreads)
cholqr_pass_kernel(const float* __restrict__ y, const float* __restrict__ g,
                   float* __restrict__ qt, int* __restrict__ info,
                   unsigned char* __restrict__ bad,
                   unsigned* __restrict__ ticket, int batch, int k, int b,
                   long long y_batch, long long y_row, long long y_col,
                   float delta_rel, float rescue_rel) {
  __shared__ float l[kPair ? 2 : 1][BMAX][BMAX + 1];
  __shared__ int failed[2];
  const int z = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  y += (long long)z * y_batch;
  g += (long long)z * b * b;
  if (warp == 0) {
    cholqr_factor<BMAX>(l[0], failed[0], g, b, delta_rel, lane);
    if (blockIdx.x == 0 && lane == 0) info[z] = failed[0];
  } else if (kPair && warp == 1) {
    cholqr_factor<BMAX>(l[kPair ? 1 : 0], failed[1], g, b, rescue_rel, lane);
  }
  __syncthreads();
  const int row = blockIdx.x * kQrThreads + threadIdx.x;
  bool nonfinite = false;
  if (row < k) {
    const float* yr = y + (long long)row * y_row;
    float yv[BMAX], xo[BMAX];
#pragma unroll
    for (int j = 0; j < BMAX; ++j) {
      if (j < b) yv[j] = yr[j * y_col];
    }
    float* q = qt + (long long)z * b * k + row;
    cholqr_solve<BMAX>(l[0], yv, xo, b);
#pragma unroll
    for (int j = 0; j < BMAX; ++j) {
      if (j < b) {
        q[(long long)j * k] = xo[j];
        nonfinite |= !isfinite(xo[j]);
      }
    }
    if (kPair) {
      q += (long long)batch * b * k;
      cholqr_solve<BMAX>(l[kPair ? 1 : 0], yv, xo, b);
#pragma unroll
      for (int j = 0; j < BMAX; ++j) {
        if (j < b) q[(long long)j * k] = xo[j];
      }
    }
  }
  if (kPair) {
    const int any = __syncthreads_or(nonfinite);
    if (threadIdx.x == 0) {
      unsigned* count = ticket + 2 * z;
      unsigned* seen = count + 1;
      if (any) atomicOr(seen, 1u);
      __threadfence();
      if (atomicAdd(count, 1u) == gridDim.x - 1) {
        const unsigned found = atomicExch(seen, 0u);
        atomicExch(count, 0u);
        bad[z] = (found != 0u || failed[0] != 0) ? 1 : 0;
      }
    }
  }
}

template <bool kPair>
cudaError_t launch_cholqr_pass(const float* y, const float* g, float* qt,
                               int* info, unsigned char* bad,
                               unsigned* ticket, int batch, int k, int b,
                               long long y_batch, long long y_row,
                               long long y_col, float delta_rel,
                               float rescue_rel, cudaStream_t stream) {
  if (batch < 1 || batch > kMaxGridYZ || k < 1 || b < 1 || b > 64 ||
      (kPair && (bad == nullptr || ticket == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(cdiv(k, kQrThreads), batch);
#define SCT_QR_LAUNCH(BMAX)                                                 \
  cholqr_pass_kernel<BMAX, kPair><<<grid, kQrThreads, 0, stream>>>(         \
      y, g, qt, info, bad, ticket, batch, k, b, y_batch, y_row, y_col,      \
      delta_rel, rescue_rel)
  if (b <= 16) {
    SCT_QR_LAUNCH(16);
  } else if (b <= 32) {
    SCT_QR_LAUNCH(32);
  } else {
    SCT_QR_LAUNCH(64);
  }
#undef SCT_QR_LAUNCH
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 8. K-Means: k-means++ seeding and the cosine Lloyd loop with its stop
//    rule, one block per utterance, one launch per call or batch.
//
// Replaces no Pallas kernel: the JAX package runs kmeans_fit
// (spectralcluster_tpu/ops/kmeans.py) as XLA ops inside its jit, Lloyd as a
// lax.while_loop. Eager PyTorch ran it as ~550 small launches a call, paced
// by the host: k-means++'s Gumbel draws made in numpy and copied to the
// card, a dozen ops per centre, ~30 launches per Lloyd round and a host
// read of the stop flags every 16 rounds. Its twin, kmeans_plain in
// kernels/fused.py (ops/kmeans.py's _plusplus and _lloyd with the cosine
// distance), defines the semantics, which this kernel computes so:
//  * draws: JAX's threefry2x32 stream as prng.py computes it. The
//    utterance's key is split into sub-keys (counter j of the key); trial t
//    of step j at row i takes draw t·rows + i of sub-key j, made into a
//    float32 Gumbel value with numpy's float32 log (kmeans.cuh's np_logf),
//    so the draws equal prng.gumbel's bit for bit. Only the draws of rows
//    < n are made;
//  * seeding: the first centre is the argmax of log(w + 1e-30) + g; each
//    further one the best of `trials` candidates, drawn from
//    log(closest + 1e-30) + g, by squared-euclidean potentials weighted by
//    w. Every argmax and argmin orders as torch's: NaN first, then the
//    lower index on ties;
//  * Lloyd: cosine distances to the centroids, columns >= n_clusters at
//    +inf; the weighted mean of the rows' least distances; stop when it is
//    <= the previous round's and >= (1 - tol)·previous, or after
//    max_iter + 1 rounds, with that round's labels; otherwise the weighted
//    centroid means, an empty cluster keeping its centroid. The loop ends
//    at the stopping round itself.
// Each product, division and square root rounds where the twin's torch op
// rounds (no contraction into an FMA where torch rounds twice). The sums
// run in one fixed order, another than the twin's cuBLAS products and
// reductions, so a distance or a mean can differ in its last bits: that
// moves a label only at a near tie, and a round count only where the mean
// sits on the stop rule's boundary.
// Bound: latency. A round is ~2·k·d FMAs and k divisions a row (7 x 7 at
// N=1024: ~0.1 MFLOP, a microsecond at any rate), then block-wide
// reductions that nothing can hide: the rounds, and k-means++'s k_max - 1
// steps, are serial (tools/kmeans_latency.cu times each such step on the
// card; chip_smoke.py adds them up in this kernel's order as its bound).
// Design, against that: one block of 512 threads per
// utterance; its rows in shared memory where they fit (n·d·4 <= 160 KB:
// every call, batched chunks of 1024), read through L1/L2 otherwise (a
// long recording's 573 KB); the centroids, their norms and the candidates
// in shared memory; each thread sums its rows into every centroid column
// at once (64 / width clusters per pass), reduced by warp shuffles and one
// pass over the warps' partials in a fixed order, so a run repeats its
// bits; the labels go to the output each round, the round count to device
// memory. No host value is read: n_clusters and a batch's keys come from
// device memory.
// ---------------------------------------------------------------------------

using namespace sct_km;

constexpr int kKmSmemRowsBytes = 160 * 1024;

// torch.minimum: NaN where either is.
__device__ __forceinline__ float km_nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// A row of d <= KD columns, zero past d (zeros add nothing below).
template <int KD>
__device__ __forceinline__ void km_load_row(float (&v)[KD], const float* xs,
                                            int i, int d) {
  const float* r = xs + (long long)i * d;
#pragma unroll
  for (int j = 0; j < KD; ++j) v[j] = j < d ? r[j] : 0.0f;
}

// torch.sum(v * v): each square rounded, then summed in column order.
template <int KD>
__device__ __forceinline__ float km_sumsq(const float* v) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < KD; ++j) s = __fadd_rn(s, __fmul_rn(v[j], v[j]));
  return s;
}

// A row's product with a centre: one fmaf chain in column order.
template <int KD>
__device__ __forceinline__ float km_dot(const float (&v)[KD],
                                        const float* c) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < KD; ++j) s = fmaf(v[j], c[j], s);
  return s;
}

// cdist_sqeuclidean of a row and a centre: (x2 + y2) - 2·dot, at least 0
// (NaN stays NaN, as clamp_min leaves it).
__device__ __forceinline__ float km_sqdist(float x2, float y2, float dot) {
  const float d2 = __fsub_rn(__fadd_rn(x2, y2), __fmul_rn(2.0f, dot));
  return d2 < 0.0f ? 0.0f : d2;
}

struct KmeansArgs {
  const float* x;          // b utterances of (n, d), contiguous
  const float* w;          // (b, n) weights, or null: every weight 1
  const int* n_clusters;   // (b,) on the card, or null: nc_value
  int nc_value;
  const uint32_t* keys;    // (b, 2) JAX key data, or null: (k1, k2)
  uint32_t k1, k2;
  int n, d, k_max, rows, trials, max_iter;
  float keep;              // float32(1 - tol)
  int rows_in_smem;
  int* labels;             // (b, n)
  float* centroids;        // (b, k_max, d)
  int* rounds;             // (b,)
  float* closest;          // (b, n) scratch: k-means++'s potentials
};

// KD: the width (k_max and d) bound; G: the clusters whose sums a thread
// keeps at once, G·(KD + 1) registers.
template <int KD, int G>
__global__ void __launch_bounds__(kKmThreads, 1)
kmeans_kernel(const KmeansArgs a) {
  constexpr int kSums = G * (KD + 1);
  extern __shared__ float rows_smem[];
  __shared__ float cent[kKmMaxWidth][KD];
  __shared__ float cnorm[kKmMaxWidth];
  __shared__ float cand[kKmMaxTrials][KD];
  __shared__ float cand_sq[kKmMaxTrials];
  __shared__ uint32_t sub[kKmMaxWidth][2];
  __shared__ float red[kKmWarps * kSums];
  __shared__ int red_i[kKmWarps * kKmMaxTrials];
  __shared__ float sums[kSums];
  __shared__ int picked[kKmMaxTrials];

  const int tid = threadIdx.x;
  const int u = blockIdx.x;
  const int n = a.n, d = a.d, k_max = a.k_max, trials = a.trials;
  const float* xg = a.x + (long long)u * n * d;
  const float* w = a.w ? a.w + (long long)u * n : nullptr;
  int* labels = a.labels + (long long)u * n;
  float* closest = a.closest + (long long)u * n;
  const int nc_raw = a.n_clusters ? a.n_clusters[u] : a.nc_value;
  const int nc = nc_raw < 0 ? 0 : (nc_raw > k_max ? k_max : (int)nc_raw);

  // jax.random.split(key, k_max + 1): sub-key j is the key's counter j.
  if (tid < k_max) {
    uint32_t s1 = 0u, s2 = static_cast<uint32_t>(tid);
    threefry2x32(a.keys ? a.keys[2 * u] : a.k1,
                 a.keys ? a.keys[2 * u + 1] : a.k2, s1, s2);
    sub[tid][0] = s1;
    sub[tid][1] = s2;
  }
  const float* xs = xg;
  if (a.rows_in_smem) {
    for (int e = tid; e < n * d; e += kKmThreads) rows_smem[e] = xg[e];
    xs = rows_smem;
  }
  __syncthreads();

  // k-means++: the first centre, argmax of log(w + 1e-30) + g.
  float bv[kKmMaxTrials];
  int bi[kKmMaxTrials];
  bv[0] = -INFINITY;
  bi[0] = INT_MAX;
  for (int i = tid; i < n; i += kKmThreads) {
    const float wi = w ? w[i] : 1.0f;
    const float v = __fadd_rn(logf(__fadd_rn(wi, 1e-30f)),
                              gumbel_draw(sub[0][0], sub[0][1],
                                          static_cast<uint32_t>(i)));
    if (km_max_first(v, i, bv[0], bi[0])) {
      bv[0] = v;
      bi[0] = i;
    }
  }
  km_block_argmax(bv, bi, 1, red, red_i, picked);
  if (tid < KD) {
    cent[0][tid] = tid < d ? xs[(long long)picked[0] * d + tid] : 0.0f;
  }
  __syncthreads();
  if (tid == 0) cand_sq[0] = km_sumsq<KD>(cent[0]);
  __syncthreads();
  for (int i = tid; i < n; i += kKmThreads) {
    float v[KD];
    km_load_row<KD>(v, xs, i, d);
    const float wi = w ? w[i] : 1.0f;
    const float d2 =
        km_sqdist(km_sumsq<KD>(v), cand_sq[0], km_dot<KD>(v, cent[0]));
    closest[i] = wi > 0.0f ? d2 : 0.0f;
  }

  // Each further centre: the candidate of least weighted potential.
  for (int j = 1; j < k_max; ++j) {
    const uint32_t s1 = sub[j][0], s2 = sub[j][1];
#pragma unroll
    for (int t = 0; t < kKmMaxTrials; ++t) {
      bv[t] = -INFINITY;
      bi[t] = INT_MAX;
    }
    for (int i = tid; i < n; i += kKmThreads) {
      const float wi = w ? w[i] : 1.0f;
      const float logit =
          wi > 0.0f ? logf(__fadd_rn(closest[i], 1e-30f)) : -INFINITY;
#pragma unroll
      for (int t = 0; t < kKmMaxTrials; ++t) {
        if (t < trials) {
          const uint32_t c = static_cast<uint32_t>(t) *
                                 static_cast<uint32_t>(a.rows) +
                             static_cast<uint32_t>(i);
          const float v = __fadd_rn(logit, gumbel_draw(s1, s2, c));
          if (km_max_first(v, i, bv[t], bi[t])) {
            bv[t] = v;
            bi[t] = i;
          }
        }
      }
    }
    km_block_argmax(bv, bi, trials, red, red_i, picked);
    for (int e = tid; e < trials * KD; e += kKmThreads) {
      const int t = e / KD, jj = e % KD;
      cand[t][jj] = jj < d ? xs[(long long)picked[t] * d + jj] : 0.0f;
    }
    __syncthreads();
    if (tid < trials) cand_sq[tid] = km_sumsq<KD>(cand[tid]);
    __syncthreads();
    float pot[kKmMaxTrials];
#pragma unroll
    for (int t = 0; t < kKmMaxTrials; ++t) pot[t] = 0.0f;
    for (int i = tid; i < n; i += kKmThreads) {
      float v[KD];
      km_load_row<KD>(v, xs, i, d);
      const float wi = w ? w[i] : 1.0f;
      const float x2 = km_sumsq<KD>(v);
      const float c = closest[i];
#pragma unroll
      for (int t = 0; t < kKmMaxTrials; ++t) {
        if (t < trials) {
          const float nc_t =
              wi > 0.0f
                  ? km_nan_min(c, km_sqdist(x2, cand_sq[t],
                                            km_dot<KD>(v, cand[t])))
                  : 0.0f;
          pot[t] = __fadd_rn(pot[t], __fmul_rn(nc_t, wi));
        }
      }
    }
    km_block_sum<kKmMaxTrials>(pot, trials, red, sums);
    int best = 0;
    for (int t = 1; t < trials; ++t) {
      if (km_min_first(sums[t], t, sums[best], best)) best = t;
    }
    if (tid < KD) cent[j][tid] = cand[best][tid];
    for (int i = tid; i < n; i += kKmThreads) {
      float v[KD];
      km_load_row<KD>(v, xs, i, d);
      const float wi = w ? w[i] : 1.0f;
      const float d2 = km_sqdist(km_sumsq<KD>(v), cand_sq[best],
                                 km_dot<KD>(v, cand[best]));
      closest[i] = wi > 0.0f ? km_nan_min(closest[i], d2) : 0.0f;
    }
    __syncthreads();
  }

  // Lloyd, from the seeded centres.
  {
    float total[1] = {0.0f};
    for (int i = tid; i < n; i += kKmThreads) {
      total[0] = __fadd_rn(total[0], w ? w[i] : 1.0f);
    }
    km_block_sum<1>(total, 1, red, sums);
  }
  const float w_total = sums[0];
  if (tid < k_max) cnorm[tid] = sqrtf(km_sumsq<KD>(cent[tid]));
  __syncthreads();
  float prev = 0.0f;
  int round = 0;
  while (true) {
    ++round;
    // Assignment, with the first G clusters' sums on the way.
    float acc[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[q] = 0.0f;
    float msum[1] = {0.0f};
    for (int i = tid; i < n; i += kKmThreads) {
      float v[KD];
      km_load_row<KD>(v, xs, i, d);
      const float wi = w ? w[i] : 1.0f;
      const float xn = sqrtf(km_sumsq<KD>(v));
      float best_d = INFINITY;
      int best_k = INT_MAX;
      for (int k = 0; k < k_max; ++k) {
        const float dist =
            k < nc ? __fsub_rn(1.0f, __fdiv_rn(km_dot<KD>(v, cent[k]),
                                               __fmul_rn(xn, cnorm[k])))
                   : INFINITY;
        if (km_min_first(dist, k, best_d, best_k)) {
          best_d = dist;
          best_k = k;
        }
      }
      labels[i] = best_k;
      if (wi > 0.0f) msum[0] = __fadd_rn(msum[0], __fmul_rn(best_d, wi));
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float wk = best_k == g ? wi : 0.0f;
#pragma unroll
        for (int jj = 0; jj < KD; ++jj) {
          acc[g * (KD + 1) + jj] = fmaf(wk, v[jj], acc[g * (KD + 1) + jj]);
        }
        acc[g * (KD + 1) + KD] = __fadd_rn(acc[g * (KD + 1) + KD], wk);
      }
    }
    km_block_sum<1>(msum, 1, red, sums);
    const float mean = __fdiv_rn(sums[0], w_total);
    if (round > a.max_iter) break;
    if (mean <= prev && mean >= __fmul_rn(a.keep, prev)) break;
    // Weighted means, G clusters per pass; an empty cluster keeps its
    // centroid.
    for (int g0 = 0; g0 < k_max; g0 += G) {
      if (g0 > 0) {
#pragma unroll
        for (int q = 0; q < kSums; ++q) acc[q] = 0.0f;
        for (int i = tid; i < n; i += kKmThreads) {
          float v[KD];
          km_load_row<KD>(v, xs, i, d);
          const float wi = w ? w[i] : 1.0f;
          const int lab = labels[i];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float wk = lab == g0 + g ? wi : 0.0f;
#pragma unroll
            for (int jj = 0; jj < KD; ++jj) {
              acc[g * (KD + 1) + jj] =
                  fmaf(wk, v[jj], acc[g * (KD + 1) + jj]);
            }
            acc[g * (KD + 1) + KD] = __fadd_rn(acc[g * (KD + 1) + KD], wk);
          }
        }
      }
      km_block_sum<kSums>(acc, kSums, red, sums);
      for (int e = tid; e < G * KD; e += kKmThreads) {
        const int g = e / KD, jj = e % KD, k = g0 + g;
        const float count = sums[g * (KD + 1) + KD];
        if (k < k_max && jj < d && count > 0.0f) {
          cent[k][jj] = __fdiv_rn(sums[g * (KD + 1) + jj], count);
        }
      }
      __syncthreads();
    }
    if (tid < k_max) cnorm[tid] = sqrtf(km_sumsq<KD>(cent[tid]));
    __syncthreads();
    prev = mean;
  }
  float* out = a.centroids + (long long)u * k_max * d;
  for (int e = tid; e < k_max * d; e += kKmThreads) out[e] = cent[e / d][e % d];
  if (tid == 0) a.rounds[u] = round;
}

template <int KD, int G>
cudaError_t launch_kmeans_width(const KmeansArgs& a, int b,
                                cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kmeans_kernel<KD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kKmSmemRowsBytes);
  if (attr != cudaSuccess) return attr;
  const size_t smem =
      a.rows_in_smem ? static_cast<size_t>(a.n) * a.d * sizeof(float) : 0;
  kmeans_kernel<KD, G><<<b, kKmThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_kmeans(KmeansArgs a, int b, cudaStream_t stream) {
  if (b < 1 || a.n < 1 || a.d < 1 || a.d > kKmMaxWidth || a.k_max < 1 ||
      a.k_max > kKmMaxWidth || a.trials < 1 || a.trials > kKmMaxTrials ||
      a.rows < a.n || (long long)a.trials * a.rows > 0xffffffffLL ||
      a.max_iter < 0 || a.labels == nullptr || a.centroids == nullptr ||
      a.rounds == nullptr || a.closest == nullptr ||
      (a.keys == nullptr && b != 1)) {
    return cudaErrorInvalidValue;
  }
  a.rows_in_smem = (long long)a.n * a.d * 4 <= kKmSmemRowsBytes;
  const int width = std::max(a.d, a.k_max);
  if (width <= 8) return launch_kmeans_width<8, 8>(a, b, stream);
  if (width <= 16) return launch_kmeans_width<16, 4>(a, b, stream);
  return launch_kmeans_width<32, 2>(a, b, stream);
}

}  // namespace

extern "C" {

const char* sct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int sct_affinity(const float* xt, float* out, int n, int ld, int d_pad,
                 void* stream) {
  return static_cast<int>(launch_affinity(xt, out, n, ld, d_pad,
                                          static_cast<cudaStream_t>(stream)));
}

// xn: B normalized utterances of (n, d4), row-major, 16-byte aligned, d4 a
// multiple of 4; out: B matrices of (n, n), contiguous.
int sct_affinity_batched(const float* xn, float* out, int b, int n, int d4,
                         void* stream) {
  return static_cast<int>(launch_affinity_batched(
      xn, out, b, n, d4, static_cast<cudaStream_t>(stream)));
}

int sct_row_max(const float* a, float* out, int n, int n_valid,
                int exclude_diagonal, int vec, void* stream) {
  return static_cast<int>(launch_row_max(a, out, n, n_valid, exclude_diagonal,
                                         vec,
                                         static_cast<cudaStream_t>(stream)));
}

// a: B matrices of (n, n); out: B·n maxima; n_valids: B int32 on the card,
// or nullptr when every column is valid.
int sct_row_max_batched(const float* a, float* out, int b, int n,
                        const int* n_valids, int exclude_diagonal, int vec,
                        void* stream) {
  if (!rows_fit(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_row_max_batched(
      a, out, b * n, n, n_valids, exclude_diagonal, vec,
      static_cast<cudaStream_t>(stream)));
}

int sct_crop_diagonal(const float* a, float* out, int n, int n_valid, int vec,
                      void* stream) {
  return static_cast<int>(launch_crop_diagonal<false>(
      a, out, n, n, n_valid, nullptr, vec, static_cast<cudaStream_t>(stream)));
}

int sct_crop_diagonal_batched(const float* a, float* out, int b, int n,
                              const int* n_valids, int vec, void* stream) {
  if (!rows_fit(b, n) || n_valids == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      launch_crop_diagonal<true>(a, out, b * n, n, n, n_valids, vec,
                                 static_cast<cudaStream_t>(stream)));
}

// Blocks resident on one SM, for reports: kernel 0 is the affinity, 1
// row_max (the main path's form, no exclude_diagonal), 2 crop_diagonal, 3
// the batched affinity, 4 the batched row_max (no exclude_diagonal).
int sct_resident_blocks(int kernel, int* blocks) {
  cudaError_t err = cudaSuccess;
  if (kernel == 0) {
    err = affinity_smem_opt_in();
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, affinity_kernel, kAffThreads, kAffSmemBytes);
    }
  } else if (kernel == 1) {
    *blocks = row_resident_blocks<row_max_kernel<false>>();
  } else if (kernel == 2) {
    *blocks = row_resident_blocks<crop_diagonal_kernel<false>>();
  } else if (kernel == 3) {
    *blocks = affinity_batched_resident();
  } else if (kernel == 4) {
    *blocks = row_resident_blocks<row_max_batched_kernel<false>>();
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The batched affinity's grid for (b, n), its diagonal tiles that come
// split, and the card's resident slots for it, for reports.
int sct_affinity_batched_schedule(int b, int n, long long* blocks,
                                  int* split, int* slots) {
  if (b < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = affinity_batched_smem_opt_in();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  *split = affinity_batched_split(b, n);
  *blocks = affinity_batched_blocks(b, n, *split);
  *slots = sm_count() * affinity_batched_resident();
  return static_cast<int>(*slots > 0 ? cudaSuccess
                                     : cudaErrorInvalidConfiguration);
}

int sct_threshold_symmetrize(const float* a, const float* thr, float* out,
                             int n, float multiplier, int binarize,
                             int preserve_diagonal, int average,
                             void* stream) {
  return static_cast<int>(launch_threshold_symmetrize(
      a, thr, out, 1, n, multiplier, binarize, preserve_diagonal, average,
      static_cast<cudaStream_t>(stream)));
}

// a, out: B matrices of (n, n); thr: B·n row thresholds.
int sct_threshold_symmetrize_batched(const float* a, const float* thr,
                                     float* out, int b, int n,
                                     float multiplier, int binarize,
                                     int preserve_diagonal, int average,
                                     void* stream) {
  return static_cast<int>(launch_threshold_symmetrize(
      a, thr, out, b, n, multiplier, binarize, preserve_diagonal, average,
      static_cast<cudaStream_t>(stream)));
}

int sct_row_wise_normalize(const float* a, float* out, int n, int n_valid,
                           int vec, void* stream) {
  row_wise_normalize_kernel<false><<<n, kRowThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      a, out, n, n_valid, nullptr, vec);
  return static_cast<int>(cudaGetLastError());
}

// a, out: B matrices of (n, n); n_valids: B int32 on the card. One block
// per row of the batch.
int sct_row_wise_normalize_batched(const float* a, float* out, int b, int n,
                                   const int* n_valids, int vec,
                                   void* stream) {
  if (!rows_fit(b, n) || n_valids == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  row_wise_normalize_kernel<true><<<b * n, kRowThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      a, out, n, n, n_valids, vec);
  return static_cast<int>(cudaGetLastError());
}

// a: batch matrices of (m, k) float32 at stride_a, rows lda apart; x: batch
// panels of (k, c) float32 at stride_x, entry (i, j) at i·x_row + j·x_col;
// y: batch matrices of (m, c) float32, contiguous. One launch per 32
// columns.
int sct_panel_matmul(const float* a, const float* x, float* y, int batch,
                     int m, int k, long long lda, long long stride_a, int c,
                     long long x_row, long long x_col, long long stride_x,
                     void* stream) {
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 && lda % 4 == 0 &&
                   (batch == 1 || stride_a % 4 == 0);
  return static_cast<int>(launch_panel_matmul(
      a, x, y, batch, m, k, lda, stride_a, c, x_row, x_col, stride_x, vec,
      static_cast<cudaStream_t>(stream)));
}

// The k split (the cluster size) that sct_panel_matmul takes for a
// (batch, m, k) product by c <= 32 columns, 16-byte aligned rows or not,
// and the card's resident blocks of that kernel, for reports.
int sct_panel_matmul_schedule(int batch, int m, int k, int c, int vec,
                              int* splits, int* resident) {
  int out[2] = {0, 0};
  const cudaError_t err = launch_panel_matmul(
      nullptr, nullptr, nullptr, batch, m, k, k, (long long)m * k, c, c, 1,
      0, vec != 0, nullptr, out);
  *splits = out[0];
  *resident = out[1];
  return static_cast<int>(err);
}

// y: batch panels of (k, b), entry (i, j) of panel z at z·y_batch + i·y_row
// + j·y_col; g: their (b, b) Grams, contiguous; qt: batch matrices of
// (b, k), q transposed; info: batch int32, the failed column of each
// Cholesky (0: none). b ≤ 64.
int sct_cholqr_pass(const float* y, const float* g, float* qt, int* info,
                    int batch, int k, int b, long long y_batch,
                    long long y_row, long long y_col, float delta_rel,
                    void* stream) {
  return static_cast<int>(launch_cholqr_pass<false>(
      y, g, qt, info, nullptr, nullptr, batch, k, b, y_batch, y_row, y_col,
      delta_rel, 0.0f, static_cast<cudaStream_t>(stream)));
}

// The pass at delta_rel and at rescue_rel in one launch, from one read of
// y: qt holds 2·batch matrices of (b, k), the first pass's then the
// rescue's; info the first pass's failed column; bad (batch bytes) 1 where
// the first pass failed or left a non-finite value; ticket: 2·batch
// uint32, zero before the launch and zero after it. b ≤ 64.
int sct_cholqr_pass_pair(const float* y, const float* g, float* qt,
                         int* info, unsigned char* bad, unsigned* ticket,
                         int batch, int k, int b, long long y_batch,
                         long long y_row, long long y_col, float delta_rel,
                         float rescue_rel, void* stream) {
  return static_cast<int>(launch_cholqr_pass<true>(
      y, g, qt, info, bad, ticket, batch, k, b, y_batch, y_row, y_col,
      delta_rel, rescue_rel, static_cast<cudaStream_t>(stream)));
}

// Kernel 8: K-Means of b utterances of (n, d) float32 rows, one block
// each: k-means++ from JAX key data (keys: b pairs on the card, or null and
// the one key (k1, k2) by value when b is 1) over `rows` draw rows with
// `trials` candidates a step, then cosine Lloyd. w: (b, n) weights or null
// (all 1); n_clusters: b int32 on the card, or null and nc_value. Writes
// labels (b, n) int32, centroids (b, k_max, d) and rounds (b,) int32;
// scratch: b·n floats. k_max and d at most 32.
int sct_kmeans(const float* x, const float* w, const int* n_clusters,
               int nc_value, const unsigned* keys, unsigned k1,
               unsigned k2, int b, int n, int d, int k_max, int rows,
               int trials, int max_iter, float keep, int* labels,
               float* centroids, int* rounds, float* scratch,
               void* stream) {
  KmeansArgs a;
  a.x = x;
  a.w = w;
  a.n_clusters = n_clusters;
  a.nc_value = nc_value;
  a.keys = keys;
  a.k1 = k1;
  a.k2 = k2;
  a.n = n;
  a.d = d;
  a.k_max = k_max;
  a.rows = rows;
  a.trials = trials;
  a.max_iter = max_iter;
  a.keep = keep;
  a.rows_in_smem = 0;
  a.labels = labels;
  a.centroids = centroids;
  a.rounds = rounds;
  a.closest = scratch;
  return static_cast<int>(
      launch_kmeans(a, b, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
