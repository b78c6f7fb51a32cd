// Kernel 8's parts that checks and measurements outside fused.cu build
// too: JAX's threefry2x32 stream and its Gumbel draws, as prng.py makes
// them, and the block-wide sum and argmax, in torch's order, that the
// kernel's serial steps wait on. fused.cu includes this file; a probe
// that includes it builds in seconds (kernels/build.py hashes it with the
// sources).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sct_km {

constexpr int kKmThreads = 512;
constexpr int kKmWarps = kKmThreads / 32;
constexpr int kKmMaxWidth = 32;   // k_max and the column count
constexpr int kKmMaxTrials = 5;   // 2 + int(log(32))

template <int R>
__device__ __forceinline__ void threefry_mix(uint32_t& x1, uint32_t& x2) {
  x1 += x2;
  x2 = ((x2 << R) | (x2 >> (32 - R))) ^ x1;
}

// Threefry-2x32 with 20 rounds on one counter pair (prng.threefry2x32).
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x1, uint32_t& x2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x1 += k1;
  x2 += k2;
#define SCT_TF_MIX4(a, b, c, d)                                             \
  threefry_mix<a>(x1, x2);                                                  \
  threefry_mix<b>(x1, x2);                                                  \
  threefry_mix<c>(x1, x2);                                                  \
  threefry_mix<d>(x1, x2)
  SCT_TF_MIX4(13, 15, 26, 6);
  x1 += k2;
  x2 += k3 + 1u;
  SCT_TF_MIX4(17, 29, 16, 24);
  x1 += k3;
  x2 += k1 + 2u;
  SCT_TF_MIX4(13, 15, 26, 6);
  x1 += k1;
  x2 += k2 + 3u;
  SCT_TF_MIX4(17, 29, 16, 24);
  x1 += k2;
  x2 += k3 + 4u;
  SCT_TF_MIX4(13, 15, 26, 6);
  x1 += k3;
  x2 += k1 + 5u;
#undef SCT_TF_MIX4
}

// numpy's float32 log, the one prng.gumbel's np.log runs on x86 with AVX2
// or AVX512F (numpy's SIMD loop since 1.20): x = m·2^e with m in [0.5, 1),
// m doubled (and e less one) where m <= sqrt(1/2), then log(m) as a ratio of
// two degree-5 polynomials in m - 1, each by fused multiply-adds in
// Horner's order, and e·ln 2 added by one more. Held bit for bit against
// np.log on every uniform, and every -log of one, that gumbel_draw takes
// (all 2^23); CUDA's logf rounds about a third of the draws another way.
// For normal x > 0, the only inputs here.
__device__ __forceinline__ float np_logf(float x) {
  const uint32_t bits = __float_as_uint(x);
  float e = static_cast<float>(static_cast<int>((bits >> 23) & 0xffu) - 126);
  float m = __uint_as_float((bits & 0x7fffffu) | 0x3f000000u);
  if (m <= 0.707106781186547524f) {
    m = __fadd_rn(m, m);
    e = __fsub_rn(e, 1.0f);
  }
  m = __fsub_rn(m, 1.0f);
  float p = __fmaf_rn(2.589979117907922693523e-02f, m,
                      3.808837741388407920751e-01f);
  p = __fmaf_rn(p, m, 1.480000633576506585156e+00f);
  p = __fmaf_rn(p, m, 2.112677543073053063722e+00f);
  p = __fmaf_rn(p, m, 9.999999999999998702752e-01f);
  p = __fmaf_rn(p, m, 0.0f);
  float q = __fmaf_rn(5.875095403124574342950e-03f, m,
                      1.546476374983906719538e-01f);
  q = __fmaf_rn(q, m, 9.864942958519418960339e-01f);
  q = __fmaf_rn(q, m, 2.453006071784736363091e+00f);
  q = __fmaf_rn(q, m, 2.612677543073109236779e+00f);
  q = __fmaf_rn(q, m, 1.0f);
  return __fmaf_rn(e, 0.693147180559945309417f, __fdiv_rn(p, q));
}

// jax.random.gumbel's float32 value at flat counter c of key (k1, k2), as
// prng.gumbel makes it, bit for bit: the xor of both threefry words, its
// top 23 bits as a uniform u in [tiny, 1), then -log(-log(u)) with numpy's
// log.
__device__ __forceinline__ float gumbel_draw(uint32_t k1, uint32_t k2,
                                            uint32_t c) {
  uint32_t hi = 0u, lo = c;
  threefry2x32(k1, k2, hi, lo);
  const float f = __uint_as_float(((hi ^ lo) >> 9) | 0x3f800000u) - 1.0f;
  const float tiny = 1.17549435e-38f;
  const float u = fmaxf(tiny, __fadd_rn(__fmul_rn(f, 1.0f - tiny), tiny));
  return -np_logf(-np_logf(u));
}

// torch.argmax's order of (value, index) pairs: NaN first, then the larger
// value, then the lower index. km_min_first: torch.argmin's.
__device__ __forceinline__ bool km_max_first(float a, int ia, float b,
                                             int ib) {
  if (isnan(a) || isnan(b)) return isnan(a) && (!isnan(b) || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ bool km_min_first(float a, int ia, float b,
                                             int ib) {
  if (isnan(a) || isnan(b)) return isnan(a) && (!isnan(b) || ia < ib);
  return a < b || (a == b && ia < ib);
}

// Sums across the block of v[q], q < m <= M: a warp's butterfly, then the
// warps' partials in warp order, into out[q]; red holds kKmWarps · M
// floats. Every thread calls it; out is read after it returns.
template <int M>
__device__ void km_block_sum(const float (&v)[M], int m, float* red,
                             float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    if (q < m) {
      float s = v[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == 0) red[warp * M + q] = s;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < m; q += kKmThreads) {
    float s = red[q];
    for (int wp = 1; wp < kKmWarps; ++wp) s += red[wp * M + q];
    out[q] = s;
  }
  __syncthreads();
}

// The first (value, index) pair across the block, in torch.argmax's order,
// of each of m <= kKmMaxTrials lists, into out[q]. Every thread calls it.
__device__ void km_block_argmax(float (&v)[kKmMaxTrials],
                                int (&idx)[kKmMaxTrials], int m, float* red,
                                int* red_i, int* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kKmMaxTrials; ++q) {
    if (q < m) {
      float a = v[q];
      int ia = idx[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float b = __shfl_xor_sync(0xffffffffu, a, off);
        const int ib = __shfl_xor_sync(0xffffffffu, ia, off);
        if (km_max_first(b, ib, a, ia)) {
          a = b;
          ia = ib;
        }
      }
      if (lane == 0) {
        red[warp * kKmMaxTrials + q] = a;
        red_i[warp * kKmMaxTrials + q] = ia;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < m) {
    const int q = threadIdx.x;
    float a = red[q];
    int ia = red_i[q];
    for (int wp = 1; wp < kKmWarps; ++wp) {
      const float b = red[wp * kKmMaxTrials + q];
      const int ib = red_i[wp * kKmMaxTrials + q];
      if (km_max_first(b, ib, a, ia)) {
        a = b;
        ia = ib;
      }
    }
    out[q] = ia;
  }
  __syncthreads();
}

}  // namespace sct_km
