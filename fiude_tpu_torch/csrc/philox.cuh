// Philox4x32-10 and the Box-Muller normal of the Bayes kernels' weight noise.
//
// Stands for the TPU's on-core generator in the JAX package:
// pltpu.prng_seed(seed, e) + _kernel_normal (fiude_tpu/ops/pallas_bayes.py:
// 91-100, pallas_bayes_train.py:95-102).  A draw is a pure function of
// (seed, evaluation e, weight array k, element i): counter (i, k, e, 0), key
// (seed's low word, seed's high word), output words 0 and 1.  The same
// arithmetic in plain PyTorch is fiude_tpu_torch/ops/philox.py, which the
// kernels' normals are held against on the card.  No cuRAND; logf, cosf and
// sqrtf are the accurate ones (the build passes no --use_fast_math).

#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;   // round multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;   // key increments

struct Words { uint32_t x, y, z, w; };

__device__ __forceinline__ Words philox4x32_10(Words c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += kW0; k1 += kW1; }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = Words{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// The JAX package's map of bits to uniforms: the top 23 bits of a word make a
// float in [1, 2); u1 = 2 - m1 in (0, 1], u2 = m2 - 1 in [0, 1).
__device__ __forceinline__ float unit_float(uint32_t word) {
  return __uint_as_float((word >> 9) | 0x3F800000u);
}

__device__ __forceinline__ float normal(unsigned long long seed, uint32_t e, uint32_t k,
                                        uint32_t i) {
  const Words r = philox4x32_10(Words{i, k, e, 0u}, (uint32_t)seed, (uint32_t)(seed >> 32));
  const float u1 = 2.0f - unit_float(r.x);
  const float u2 = unit_float(r.y) - 1.0f;
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

}  // namespace philox
