// Hand-written Hopper (sm_90a) kernels for the refinement hot path and the
// subspace solver.
//
// Kernels 1-5 each compute what one Pallas TPU kernel of
// spectralcluster_tpu/kernels/fused.py computes; none is carried over block
// by block. Kernels 6-7 compute what the JAX package's subspace solver
// leaves to XLA (its panel product, a CholeskyQR pass). The
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
// sct_panel_matmul_splits) launches its kernels (one, or for 6 a pass per
// 16 columns and the sum of its partials) on the given stream, does
// not synchronize, allocates nothing, and returns cudaGetLastError() so
// the caller sees a refused launch.
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

#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

namespace {

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
// float32 once (x is converted to float64 as it is staged). The orders are
// fixed, so the result does not depend on the launch. No TF32, no
// --use_fast_math.
// Bound: one read of a (m·k·4 bytes: 0.42 GB at N=10240 -> 0.125 ms at
// 3.35 TB/s); its 2·m·k·c float64 operations (3.4 GFLOP at c=16 -> 0.05
// ms on the card's float64 tensor cores, 67 TFLOP/s) cost less. Design: a
// block takes kPanelBlockRows rows (64 a warp) and one of S ranges of k,
// S chosen so that the grid holds about two blocks per SM. Per
// kPanelTileK-deep slice the block stages x's rows (converted to float64,
// shared by its 8 warps; x is read at its own strides, so the solver's
// transposed panels need no copy) and each warp its 64 rows of a
// (coalesced 64-byte row segments) in shared memory; each warp then runs
// float64 tensor-core MMAs (m8n8k4: 8 rows by 8 columns by 4 of k, its A
// fragment converted from the staged float32 values) over its 64 x C
// output. The S float64 partials go to scratch, and a second kernel adds
// them. A launch covers up to kPanelCols columns.
// ---------------------------------------------------------------------------

constexpr int kPanelWarps = 8;
constexpr int kPanelThreads = 32 * kPanelWarps;
constexpr int kPanelWarpRows = 64;
constexpr int kPanelBlockRows = kPanelWarps * kPanelWarpRows;
constexpr int kPanelTileK = 16;
constexpr int kPanelCols = 16;

// The k ranges a (batch, m, k) product is cut into: about two blocks per
// SM in all, each range a whole number of kPanelTileK slices.
int panel_splits(int batch, int m, int k) {
  const long long row_blocks = (long long)batch * cdiv(m, kPanelBlockRows);
  const long long want = cdiv(2 * sm_count(), (int)std::min<long long>(
      row_blocks, 1 << 30));
  const int slices = cdiv(k, kPanelTileK);
  const long long s = std::max<long long>(1, std::min<long long>(want,
                                                                 slices));
  const int per = cdiv(slices, (int)s);
  return cdiv(slices, per);
}

// a: the batch's matrices at stride_a, rows lda apart; x: (k, c_all)
// float32 per matrix at stride_x, entry (i, j) at i·x_row + j·x_col,
// columns [col0, col0 + C) used; partial: (splits, batch, m, c_all)
// float64. Block (row block, split, matrix).
template <int C>
__global__ void __launch_bounds__(kPanelThreads)
panel_matmul_kernel(const float* __restrict__ a, const float* __restrict__ x,
                    double* __restrict__ partial, int batch, int m, int k,
                    long long lda, long long stride_a, long long x_row,
                    long long x_col, long long stride_x, int c_all, int col0,
                    int per) {
  __shared__ float tile[kPanelWarps][kPanelWarpRows][kPanelTileK + 1];
  __shared__ __align__(16) double xs[kPanelTileK][kPanelCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.y;
  const int z = blockIdx.z;
  const int row0 = blockIdx.x * kPanelBlockRows + warp * kPanelWarpRows;
  a += z * stride_a;
  x += z * stride_x + col0 * x_col;
  const int k_lo = min(k, split * per);
  const int k_hi = min(k, k_lo + per);
  // The warp's 64 x 16 output as float64 MMA tiles (m8n8k4): 8 row
  // groups by kGroups column groups of 8, two values a lane each.
  constexpr int kGroups = (C + 7) / 8;
  double acc[kPanelWarpRows / 8][kGroups][2];
#pragma unroll
  for (int g = 0; g < kPanelWarpRows / 8; ++g) {
#pragma unroll
    for (int cg = 0; cg < kGroups; ++cg) acc[g][cg][0] = acc[g][cg][1] = 0.0;
  }
  // Lane l loads column l % 16 of rows l / 16, l / 16 + 2, ...: each load
  // instruction reads two 64-byte row segments.
  const int lcol = lane % kPanelTileK;
  const int lrow = lane / kPanelTileK;
  // The MMA fragments' lane roles: A row and B column (group), A column
  // and B row (thread in group).
  const int group = lane >> 2;
  const int tig = lane & 3;
  for (int k0 = k_lo; k0 < k_hi; k0 += kPanelTileK) {
    const int kk = k0 + lcol;
    const bool k_in = kk < k_hi;
    float v[kPanelWarpRows / 2];
#pragma unroll
    for (int i = 0; i < kPanelWarpRows / 2; ++i) {
      const int row = row0 + 2 * i + lrow;
      v[i] = (k_in && row < m) ? __ldcs(a + row * lda + kk) : 0.0f;
    }
    if (threadIdx.x < kPanelTileK * kPanelCols) {
      // x's rows k0.. in float64, zero past k_hi and past column C.
      const int t = threadIdx.x % kPanelTileK;
      const int c = threadIdx.x / kPanelTileK;
      xs[t][c] = (k0 + t < k_hi && c < C)
                     ? static_cast<double>(__ldg(x + (k0 + t) * x_row +
                                                 c * x_col))
                     : 0.0;
    }
#pragma unroll
    for (int i = 0; i < kPanelWarpRows / 2; ++i) {
      tile[warp][2 * i + lrow][lcol] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kPanelTileK; ks += 4) {
      double bf[kGroups];
#pragma unroll
      for (int cg = 0; cg < kGroups; ++cg) bf[cg] = xs[ks + tig][cg * 8 + group];
#pragma unroll
      for (int g = 0; g < kPanelWarpRows / 8; ++g) {
        const double af = static_cast<double>(tile[warp][g * 8 + group][ks + tig]);
#pragma unroll
        for (int cg = 0; cg < kGroups; ++cg) {
          asm volatile(
              "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
              "{%0, %1}, {%2}, {%3}, {%0, %1};"
              : "+d"(acc[g][cg][0]), "+d"(acc[g][cg][1])
              : "d"(af), "d"(bf[cg]));
        }
      }
    }
    __syncthreads();
  }
  double* out = partial + ((long long)split * batch + z) * m * c_all + col0;
#pragma unroll
  for (int g = 0; g < kPanelWarpRows / 8; ++g) {
    const int row = row0 + g * 8 + group;
#pragma unroll
    for (int cg = 0; cg < kGroups; ++cg) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = cg * 8 + 2 * tig + i;
        if (row < m && col < C) {
          out[(long long)row * c_all + col] = acc[g][cg][i];
        }
      }
    }
  }
}

// y: the float32 rounding of the splits' partials added in split order.
__global__ void panel_finish_kernel(const double* __restrict__ partial,
                                    float* __restrict__ y, long long count,
                                    int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  double s = 0.0;
  for (int j = 0; j < splits; ++j) s += partial[j * count + e];
  y[e] = static_cast<float>(s);
}

template <int C>
void launch_panel_group(const float* a, const float* x, double* partial,
                        int batch, int m, int k, long long lda,
                        long long stride_a, long long x_row, long long x_col,
                        long long stride_x, int c_all, int col0, int splits,
                        int per, cudaStream_t stream) {
  const dim3 grid(cdiv(m, kPanelBlockRows), splits, batch);
  panel_matmul_kernel<C><<<grid, kPanelThreads, 0, stream>>>(
      a, x, partial, batch, m, k, lda, stride_a, x_row, x_col, stride_x,
      c_all, col0, per);
}

cudaError_t launch_panel_matmul(const float* a, const float* x,
                                double* partial, float* y, int batch, int m,
                                int k, long long lda, long long stride_a,
                                int c_all, long long x_row, long long x_col,
                                long long stride_x, cudaStream_t stream) {
  if (batch < 1 || batch > kMaxGridYZ || m < 1 || k < 1 || c_all < 1 ||
      lda < k) {
    return cudaErrorInvalidValue;
  }
  const int splits = panel_splits(batch, m, k);
  const int per = cdiv(cdiv(k, kPanelTileK), splits) * kPanelTileK;
  for (int col0 = 0; col0 < c_all; col0 += kPanelCols) {
    const int c = min(kPanelCols, c_all - col0);
    switch (c) {
#define SCT_PANEL_CASE(C)                                                   \
  case C:                                                                   \
    launch_panel_group<C>(a, x, partial, batch, m, k, lda, stride_a,       \
                          x_row, x_col, stride_x, c_all, col0, splits,     \
                          per, stream);                                    \
    break;
      SCT_PANEL_CASE(1) SCT_PANEL_CASE(2) SCT_PANEL_CASE(3)
      SCT_PANEL_CASE(4) SCT_PANEL_CASE(5) SCT_PANEL_CASE(6)
      SCT_PANEL_CASE(7) SCT_PANEL_CASE(8) SCT_PANEL_CASE(9)
      SCT_PANEL_CASE(10) SCT_PANEL_CASE(11) SCT_PANEL_CASE(12)
      SCT_PANEL_CASE(13) SCT_PANEL_CASE(14) SCT_PANEL_CASE(15)
      SCT_PANEL_CASE(16)
#undef SCT_PANEL_CASE
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long count = (long long)batch * m * c_all;
  panel_finish_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      partial, y, count, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 7. One shifted CholeskyQR pass: q = y L⁻ᵀ, L Lᵀ = g + δ·I,
//    δ = rel · max(diag g), for a (k, b) panel y and its Gram g.
//
// Replaces no Pallas kernel: the JAX package's cholqr2_shifted
// (spectralcluster_tpu/ops/eigen.py:280-304) runs a Cholesky and a
// triangular solve through XLA. The pass leaves q short of orthonormal by
// δ·(g + δI)⁻¹, about 1e-6, which is where the subspace solver's residual
// test stops (1e-6), so the rounding of L's diagonal and of the solve
// decides whether the certified route of ops/dc.py stops before its
// iteration cap. This kernel rounds as LAPACK's unblocked float32 routines
// do: each entry of L one fmaf chain in k order and one correctly rounded
// division or square root (spotf2), and each row of q solved forward the
// same way (strsm); cuSOLVER's and cuBLAS's float32 routines round
// otherwise. IEEE float32 only, no --use_fast_math.
// Bound: one read of y and one write of q (2·k·b·4 bytes: 2.6 MB at
// N=20480, b=16 -> 0.8 µs); the (b, b) Cholesky is sequential. Design: the
// first warp of every block factors g + δI in shared memory (column by
// column, lanes over the rows below the diagonal), then each thread solves
// one row of y, its b values in registers, and writes q transposed ((b, k)
// row-major), so a warp's stores of one column are coalesced. The failed
// column (1-based, 0 when none), as LAPACK's info, goes to `info`.
// ---------------------------------------------------------------------------

constexpr int kQrThreads = 256;

template <int BMAX>
__global__ void __launch_bounds__(kQrThreads)
cholqr_pass_kernel(const float* __restrict__ y, const float* __restrict__ g,
                   float* __restrict__ qt, int* __restrict__ info, int k,
                   int b, long long y_batch, long long y_row, long long y_col,
                   float delta_rel) {
  __shared__ float l[BMAX][BMAX + 1];
  __shared__ int failed;
  const int z = blockIdx.y;
  y += (long long)z * y_batch;
  g += (long long)z * b * b;
  qt += (long long)z * b * k;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
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
    if (blockIdx.x == 0 && lane == 0) info[z] = failed;
  }
  __syncthreads();
  const int row = blockIdx.x * kQrThreads + threadIdx.x;
  if (row >= k) return;
  const float* yr = y + (long long)row * y_row;
  float x[BMAX];
#pragma unroll
  for (int j = 0; j < BMAX; ++j) {
    if (j < b) {
      float s = yr[j * y_col];
#pragma unroll
      for (int c = 0; c < j; ++c) s = fmaf(-l[j][c], x[c], s);
      x[j] = s / l[j][j];
      qt[(long long)j * k + row] = x[j];
    }
  }
}

cudaError_t launch_cholqr_pass(const float* y, const float* g, float* qt,
                               int* info, int batch, int k, int b,
                               long long y_batch, long long y_row,
                               long long y_col, float delta_rel,
                               cudaStream_t stream) {
  if (batch < 1 || batch > kMaxGridYZ || k < 1 || b < 1 || b > 64) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(cdiv(k, kQrThreads), batch);
  if (b <= 16) {
    cholqr_pass_kernel<16><<<grid, kQrThreads, 0, stream>>>(
        y, g, qt, info, k, b, y_batch, y_row, y_col, delta_rel);
  } else if (b <= 32) {
    cholqr_pass_kernel<32><<<grid, kQrThreads, 0, stream>>>(
        y, g, qt, info, k, b, y_batch, y_row, y_col, delta_rel);
  } else {
    cholqr_pass_kernel<64><<<grid, kQrThreads, 0, stream>>>(
        y, g, qt, info, k, b, y_batch, y_row, y_col, delta_rel);
  }
  return cudaGetLastError();
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

// The k ranges sct_panel_matmul cuts a (batch, m, k) product into: the
// wrapper allocates splits x batch x m x c float64 of scratch for them.
int sct_panel_matmul_splits(int batch, int m, int k) {
  return (batch < 1 || m < 1 || k < 1) ? 0 : panel_splits(batch, m, k);
}

// a: batch matrices of (m, k) float32 at stride_a, rows lda apart; x: batch
// panels of (k, c) float32 at stride_x, entry (i, j) at i·x_row + j·x_col;
// partial: scratch of sct_panel_matmul_splits(batch, m, k) x batch x m x c
// float64; y: batch matrices of (m, c) float32, contiguous. One launch per
// 16 columns, then one that adds the partials.
int sct_panel_matmul(const float* a, const float* x, double* partial,
                     float* y, int batch, int m, int k, long long lda,
                     long long stride_a, int c, long long x_row,
                     long long x_col, long long stride_x, void* stream) {
  return static_cast<int>(launch_panel_matmul(
      a, x, partial, y, batch, m, k, lda, stride_a, c, x_row, x_col,
      stride_x, static_cast<cudaStream_t>(stream)));
}

// y: batch panels of (k, b), entry (i, j) of panel z at z·y_batch + i·y_row
// + j·y_col; g: their (b, b) Grams, contiguous; qt: batch matrices of
// (b, k), q transposed; info: batch int32, the failed column of each
// Cholesky (0: none). b ≤ 64.
int sct_cholqr_pass(const float* y, const float* g, float* qt, int* info,
                    int batch, int k, int b, long long y_batch,
                    long long y_row, long long y_col, float delta_rel,
                    void* stream) {
  return static_cast<int>(launch_cholqr_pass(
      y, g, qt, info, batch, k, b, y_batch, y_row, y_col, delta_rel,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
