// Kernel 8's Gumbel draws (csrc/kmeans.cuh's gumbel_draw) at flat counters
// 0..count-1 of one key, for tests/test_torch_gpu.py to hold against
// prng.gumbel. Built by kernels/build.py, whose include path holds csrc/.

#include "kmeans.cuh"

namespace {

__global__ void gumbel_probe_kernel(uint32_t k1, uint32_t k2, int count,
                                    float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) {
    out[i] = sct_km::gumbel_draw(k1, k2, static_cast<uint32_t>(i));
  }
}

}  // namespace

extern "C" int probe_gumbel(unsigned k1, unsigned k2, int count, float* out) {
  if (count < 1 || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gumbel_probe_kernel<<<(count + 255) / 256, 256>>>(k1, k2, count, out);
  return static_cast<int>(cudaGetLastError());
}
