// The latencies that bound kernel 8 (csrc/fused.cu's kmeans_kernel), each
// measured as the kernel meets it: one block of kKmThreads threads on one
// SM, `reps` of one step in a chain, each step waiting on the one before.
// chip_smoke.py builds this file with kernels/build.py (csrc/ is on its
// include path), times each probe at two rep counts with CUDA events and
// takes the difference over the reps, then adds the steps that one call
// of kernel 8 makes in its order (its latency model).
//
// Probes (`what`):
//   0  __syncthreads();
//   1  km_block_sum of m sums, of kSums values a thread (M = 72: width 8,
//      eight clusters a pass, what the calls and long cells run);
//   2  km_block_sum of m <= kKmMaxTrials sums (k-means++'s potentials);
//   3  km_block_argmax of m <= kKmMaxTrials lists;
//   4  m independent Gumbel draws a thread (kmeans.cuh's gumbel_draw), each
//      counter taken from the thread's draws before.

#include "kmeans.cuh"

namespace {

using namespace sct_km;

constexpr int kWideSums = 72;

__global__ void __launch_bounds__(kKmThreads, 1)
kmeans_latency_kernel(int what, int m, int reps, float* out) {
  __shared__ float red[kKmWarps * kWideSums];
  __shared__ int red_i[kKmWarps * kKmMaxTrials];
  __shared__ float sums[kWideSums];
  __shared__ int picked[kKmMaxTrials];
  const int tid = threadIdx.x;
  if (tid < kWideSums) sums[tid] = 0.0f;
  if (tid < kKmMaxTrials) picked[tid] = 0;
  __syncthreads();
  float carry = static_cast<float>(tid);
  for (int r = 0; r < reps; ++r) {
    if (what == 0) {
      __syncthreads();
    } else if (what == 1) {
      // Each step waits on the last one's first sum alone.
      const float base = sums[0] * 0.5f + carry;
      float v[kWideSums];
#pragma unroll
      for (int q = 0; q < kWideSums; ++q) v[q] = base + q;
      km_block_sum<kWideSums>(v, m, red, sums);
    } else if (what == 2) {
      const float base = sums[0] * 0.5f + carry;
      float v[kKmMaxTrials];
#pragma unroll
      for (int q = 0; q < kKmMaxTrials; ++q) v[q] = base + q;
      km_block_sum<kKmMaxTrials>(v, m, red, sums);
    } else if (what == 3) {
      const int base = picked[0] ^ tid;
      float v[kKmMaxTrials];
      int idx[kKmMaxTrials];
#pragma unroll
      for (int q = 0; q < kKmMaxTrials; ++q) {
        v[q] = static_cast<float>(base + q);
        idx[q] = tid;
      }
      km_block_argmax(v, idx, m, red, red_i, picked);
    } else {
      uint32_t c = __float_as_uint(carry);
      float g = 0.0f;
#pragma unroll
      for (int q = 0; q < kKmMaxTrials; ++q) {
        if (q < m) g += gumbel_draw(0x2au, static_cast<uint32_t>(q), c + q);
      }
      carry = g;
    }
  }
  if (tid == 0) out[0] = carry + sums[0] + static_cast<float>(picked[0]);
}

}  // namespace

extern "C" int probe_kmeans_latency(int what, int m, int reps, float* out,
                                    void* stream) {
  if (what < 0 || what > 4 || m < 1 || reps < 0 || out == nullptr ||
      (what == 1 ? m > kWideSums : m > kKmMaxTrials)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kmeans_latency_kernel<<<1, kKmThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(what, m, reps,
                                                               out);
  return static_cast<int>(cudaGetLastError());
}
