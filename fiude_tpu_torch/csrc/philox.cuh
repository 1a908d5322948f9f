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
//
// The rounds are split so that a kernel drawing many (e, k, i) hoists what
// repeats: the round keys depend only on the seed (Keys); round 0's product of
// the counter's word 0 (i) and round 1's product of what round 0 made of it
// depend only on the element (Element); round 0's product of word 2 (e) and
// round 1's product of what round 0 made of that depend only on the
// evaluation and the array (Evaluation).  normal() joins them and runs rounds
// 2-9: the same integers, so the same bits, as the ten rounds in one piece
// (normal(keys(seed), element(keys, i), evaluation(keys, e, k)) is the draw of
// (seed, e, k, i)).

#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;   // round multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;   // key increments
constexpr int kRounds = 10;

// (high, low) words of m * a, as one wide multiply.
__device__ __forceinline__ void mulhilo(uint32_t m, uint32_t a, uint32_t& hi, uint32_t& lo) {
  const uint64_t p = (uint64_t)m * a;
  hi = (uint32_t)(p >> 32);
  lo = (uint32_t)p;
}

struct Keys { uint32_t k0[kRounds], k1[kRounds]; };   // round r's key

__device__ __forceinline__ Keys keys(unsigned long long seed) {
  Keys k;
  k.k0[0] = (uint32_t)seed;
  k.k1[0] = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 1; r < kRounds; ++r) {
    k.k0[r] = k.k0[r - 1] + kW0;
    k.k1[r] = k.k1[r - 1] + kW1;
  }
  return k;
}

// Round 1's state is (a ^ ev.x, y, b ^ ev.z, ev.w): a, y, b from the element,
// x, z, w from the evaluation.
struct Element { uint32_t a, y, b; };
struct Evaluation { uint32_t x, z, w; };

__device__ __forceinline__ Element element(const Keys& k, uint32_t i) {
  uint32_t hi0, lo0, hi1, lo1;
  mulhilo(kM0, i, hi0, lo0);                 // round 0: counter word 0 is i
  mulhilo(kM1, hi0 ^ k.k1[0], hi1, lo1);     // round 1: word 2 is hi0 ^ 0 ^ k1
  return Element{hi1 ^ k.k0[1], lo1, lo0 ^ k.k1[1]};
}

__device__ __forceinline__ Evaluation evaluation(const Keys& k, uint32_t e, uint32_t array) {
  uint32_t hi0, lo0, hi1, lo1;
  mulhilo(kM1, e, hi1, lo1);                        // round 0: counter word 2 is e
  mulhilo(kM0, hi1 ^ array ^ k.k0[0], hi0, lo0);   // round 1: word 0 is hi1 ^ k ^ k0
  return Evaluation{lo1, hi0, lo0};
}

// The JAX package's map of bits to uniforms: the top 23 bits of a word make a
// float in [1, 2); u1 = 2 - m1 in (0, 1], u2 = m2 - 1 in [0, 1).
__device__ __forceinline__ float unit_float(uint32_t word) {
  return __uint_as_float((word >> 9) | 0x3F800000u);
}

__device__ __forceinline__ float normal(const Keys& k, const Element& el, const Evaluation& ev) {
  uint32_t x = el.a ^ ev.x, y = el.y, z = el.b ^ ev.z, w = ev.w;
#pragma unroll
  for (int r = 2; r < kRounds; ++r) {
    uint32_t hi0, lo0, hi1, lo1;
    mulhilo(kM0, x, hi0, lo0);
    mulhilo(kM1, z, hi1, lo1);
    x = hi1 ^ y ^ k.k0[r];
    y = lo1;
    z = hi0 ^ w ^ k.k1[r];
    w = lo0;
  }
  const float u1 = 2.0f - unit_float(x);
  const float u2 = unit_float(y) - 1.0f;
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

}  // namespace philox
