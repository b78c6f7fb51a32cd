// Hand-written Hopper (sm_90a) kernels for the refinement hot path.
//
// Each kernel computes what one Pallas TPU kernel of
// spectralcluster_tpu/kernels/fused.py computes; none is carried over block
// by block. The plain PyTorch twin of each kernel sits beside its wrapper in
// spectralcluster_tpu_torch/kernels/fused.py and defines the semantics.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsct_fused.so fused.cu
// (kernels/build.py does this at first use). No --use_fast_math: every
// division and square root stays IEEE, and the products are float32 FMAs
// on the CUDA cores, never TF32 tensor cores.
//
// Interface: plain C. Every function launches one kernel on the given
// stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError() so the caller sees a refused launch.
//
// Card figures used below (H100 SXM data sheet): 3.35 TB/s HBM3,
// 67 TFLOP/s float32 on the CUDA cores. N = 10240, d = 256 on the main path.

#include <cuda_runtime.h>
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

// ---------------------------------------------------------------------------
// 1. Cosine affinity: out = (xn xnᵀ + 1) / 2.
//
// Replaces affinity_pallas / _affinity_kernel (kernels/fused.py:46-77), an
// fp32 HIGHEST-precision MXU dot with the affine step in the epilogue.
// Bound: 2·N²·d = 53.7 GFLOP at N=10240, d=256 -> 0.80 ms at 67 TFLOP/s;
// its bytes (N·d in, N² out = 0.42 GB -> 0.125 ms) are six times cheaper, so
// it is bound by float32 operations. Design: a shared-memory-tiled SGEMM,
// 64x64 output tile per 256-thread block, 16-deep k slices, a 4x4 register
// tile per thread (each shared load feeds four FMAs), and the affine step
// fused into the store. Both operands are row blocks of the same xn, so no
// transposed copy exists. Every product sums its d terms in k order, so the
// output is exactly symmetric. Speed (double buffering, wider register
// tiles, computing one triangle) is later work.
// ---------------------------------------------------------------------------

constexpr int kAffTile = 64;
constexpr int kAffDepth = 16;
constexpr int kAffThreads = 256;

__global__ void __launch_bounds__(kAffThreads)
affinity_kernel(const float* __restrict__ xn, float* __restrict__ out, int n,
                int d) {
  // Stored k-major so the inner loop reads rows of the tile.
  __shared__ float as[kAffDepth][kAffTile + 4];
  __shared__ float bs[kAffDepth][kAffTile + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.y * kAffTile;
  const int col0 = blockIdx.x * kAffTile;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < d; k0 += kAffDepth) {
    for (int l = tid; l < kAffTile * kAffDepth; l += kAffThreads) {
      const int r = l / kAffDepth;
      const int c = l % kAffDepth;
      const int k = k0 + c;
      const int ga = row0 + r;
      const int gb = col0 + r;
      as[c][r] = (ga < n && k < d) ? xn[(size_t)ga * d + k] : 0.0f;
      bs[c][r] = (gb < n && k < d) ? xn[(size_t)gb * d + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kAffDepth; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = as[k][ty + 16 * i];
        b[i] = bs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < n) out[(size_t)r * n + c] = (acc[i][j] + 1.0f) * 0.5f;
    }
  }
}

// ---------------------------------------------------------------------------
// 2./3. Row max and CropDiagonal: one warp per row.
//
// row_max replaces row_max_pallas / _row_max_kernel (kernels/fused.py:
// 85-140): the max of row i over columns < n_valid; with exclude_diagonal
// the diagonal entry counts as 0 (also in rows >= n_valid, where it is set
// after the column mask, exactly as the TPU kernel does). The TPU kernel
// carries a running max across a sequential grid axis of column tiles; here
// the loop over columns inside the warp takes that axis's place and a warp
// shuffle finishes the reduction, so nothing carries between blocks.
// Bound: reading N·n_valid floats, 0.42 GB -> 0.125 ms at N=10240; the
// design streams each row once with 16-byte coalesced loads.
//
// crop_diagonal replaces crop_diagonal_pallas / _crop_diag_kernel
// (kernels/fused.py:226-254), which runs the row max and then a second
// N² pass that copies the matrix with the diagonal replaced. Here the row
// max and the diagonal write are fused. Only N values change, so with
// out == a the kernel writes the diagonal IN PLACE: it reads N·n_valid
// floats and writes N, 0.42 GB -> 0.125 ms at N=10240, where the copy
// would read and write N² (0.84 GB). The main path hands it the fresh
// affinity, which nothing reads afterwards. With out != a it copies each
// row as it streams it (N² read + N² written) for callers that keep a.
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;

__device__ __forceinline__ float masked(float v, int c, int i, bool exclude) {
  return (exclude && c == i) ? 0.0f : v;
}

// Max of row i over columns < n_valid (diagonal as 0 when `exclude`);
// with kCopy, also copies columns < n into orow.
template <bool kCopy>
__device__ float stream_row(const float* __restrict__ row,
                            float* __restrict__ orow, int i, int n,
                            int n_valid, bool exclude, bool vec, int lane) {
  const int limit = kCopy ? n : n_valid;
  float m = -INFINITY;
  int start = lane;
  if (vec) {
    // Row starts are 16-byte aligned (n % 4 == 0, checked by the caller).
    const float4* row4 = reinterpret_cast<const float4*>(row);
    float4* orow4 = reinterpret_cast<float4*>(orow);
    const int lim4 = limit >> 2;
    for (int c4 = lane; c4 < lim4; c4 += 32) {
      const float4 v = row4[c4];
      if (kCopy) orow4[c4] = v;
      const int c = c4 << 2;
      if (c < n_valid) m = fmaxf(m, masked(v.x, c, i, exclude));
      if (c + 1 < n_valid) m = fmaxf(m, masked(v.y, c + 1, i, exclude));
      if (c + 2 < n_valid) m = fmaxf(m, masked(v.z, c + 2, i, exclude));
      if (c + 3 < n_valid) m = fmaxf(m, masked(v.w, c + 3, i, exclude));
    }
    start = (lim4 << 2) + lane;
  }
  for (int c = start; c < limit; c += 32) {
    const float v = row[c];
    if (kCopy) orow[c] = v;
    if (c < n_valid) m = fmaxf(m, masked(v, c, i, exclude));
  }
  if (exclude && i >= n_valid) m = fmaxf(m, 0.0f);
  return warp_max(m);
}

__global__ void __launch_bounds__(kRowThreads)
row_max_kernel(const float* __restrict__ a, float* __restrict__ out, int n,
               int n_valid, int exclude_diagonal, int vec) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const float m = stream_row<false>(a + (size_t)i * n, nullptr, i, n, n_valid,
                                    exclude_diagonal != 0, vec != 0, lane);
  if (lane == 0) out[i] = m;
}

__global__ void __launch_bounds__(kRowThreads)
crop_diagonal_kernel(const float* a, float* out, int n, int n_valid,
                     int vec) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const float* row = a + (size_t)i * n;
  float* orow = out + (size_t)i * n;
  // Row i's diagonal is read and written only by the warp of row i, so the
  // in-place form has no race across warps; within the warp the shuffles
  // of the reduction and __syncwarp order every lane's read (and copy) of
  // the row before lane 0's diagonal write.
  const float m = (out != a)
      ? stream_row<true>(row, orow, i, n, n_valid, true, vec != 0, lane)
      : stream_row<false>(row, nullptr, i, n, n_valid, true, vec != 0, lane);
  __syncwarp();
  if (lane == 0) orow[i] = m;
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

__global__ void __launch_bounds__(kTsTile * kTsRows)
threshold_symmetrize_kernel(const float* __restrict__ a,
                            const float* __restrict__ thr,
                            float* __restrict__ out, int n, float mult,
                            int binarize, int preserve, int average) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bi > bj) return;
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
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRowThreads)
row_wise_normalize_kernel(const float* __restrict__ a, float* __restrict__ out,
                          int n, int n_valid, int vec) {
  __shared__ float warp_maxima[kRowThreads / 32];
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * n;
  const float* row = a + base;
  float* orow = out + base;

  float m = -INFINITY;
  int start = tid;
  if (vec) {
    // Row starts are 16-byte aligned (n % 4 == 0, checked by the caller).
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int lim4 = n_valid >> 2;
    for (int c4 = tid; c4 < lim4; c4 += kRowThreads) {
      const float4 v = row4[c4];
      m = fmaxf(fmaxf(m, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
    }
    start = (lim4 << 2) + tid;
  }
  for (int c = start; c < n_valid; c += kRowThreads) m = fmaxf(m, row[c]);
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

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

const char* sct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int sct_affinity(const float* xn, float* out, int n, int d, void* stream) {
  const dim3 grid(cdiv(n, kAffTile), cdiv(n, kAffTile));
  affinity_kernel<<<grid, kAffThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xn, out, n, d);
  return static_cast<int>(cudaGetLastError());
}

int sct_row_max(const float* a, float* out, int n, int n_valid,
                int exclude_diagonal, int vec, void* stream) {
  const int blocks = cdiv(n, kRowThreads / 32);
  row_max_kernel<<<blocks, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, out, n, n_valid, exclude_diagonal, vec);
  return static_cast<int>(cudaGetLastError());
}

int sct_crop_diagonal(const float* a, float* out, int n, int n_valid, int vec,
                      void* stream) {
  const int blocks = cdiv(n, kRowThreads / 32);
  crop_diagonal_kernel<<<blocks, kRowThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, out, n,
                                                              n_valid, vec);
  return static_cast<int>(cudaGetLastError());
}

int sct_threshold_symmetrize(const float* a, const float* thr, float* out,
                             int n, float multiplier, int binarize,
                             int preserve_diagonal, int average,
                             void* stream) {
  const int tiles = cdiv(n, kTsTile);
  const dim3 grid(tiles, tiles);
  const dim3 block(kTsTile, kTsRows);
  threshold_symmetrize_kernel<<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      a, thr, out, n, multiplier, binarize, preserve_diagonal, average);
  return static_cast<int>(cudaGetLastError());
}

int sct_row_wise_normalize(const float* a, float* out, int n, int n_valid,
                           int vec, void* stream) {
  row_wise_normalize_kernel<<<n, kRowThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      a, out, n, n_valid, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
