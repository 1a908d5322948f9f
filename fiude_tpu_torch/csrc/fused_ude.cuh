// The RK4(3/8) trajectory of the UDE field plus the per-step decode, shared by
// K2 (csrc/fused_ude.cu: fixed weights) and K7 (csrc/fused_bayes.cu: weights
// resampled on every evaluation) through the compile-time switch kBayes.
// The design notes are in fused_ude.cu and fused_bayes.cu.
//
// A second compile-time switch, kBf16, is the bfloat16 compute mode of both
// (compute_dtype="bfloat16", pallas_ude.py:190-192, pallas_bayes.py:112-114):
// in every product of the field, and in the frozen tail's first-layer
// product, both operands are rounded to bfloat16 (nearest even) and the
// products are summed in float32; biases, ELU, |.|, the SIR field, the stage
// combination and the state stay float32, and so does the decode product.
// The weights arrive already rounded, as bfloat16 arrays (rounded once, by
// the caller or by the draw kernel: half the bytes to read).  Activations
// are rounded with __float2bfloat16_rn where they are stored, once, not where
// they are read: the first layer's and every inner layer's output in its
// epilogue (after ELU), the tail at load, and the stage input into a rounded
// copy `zr` before the first-layer product (the SIR field reads the unrounded
// one).  The sums are float32 FMAs on the CUDA cores, not tensor-core MMAs:
// the same function up to the order of the sum.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxDeep = 8;     // layers after the first, per net
constexpr int kTile = 16;       // ensemble rows per block
constexpr int kG = kTile / 4;   // float4 row groups per feature
constexpr int kThreads = 256;

struct Net {
  int n;                        // layers after the first (0: net absent)
  int out[kMaxDeep];
  const void* w[kMaxDeep];      // (in, out), float or (kBf16) bfloat16
  const float* b[kMaxDeep];
};

// With kBayes (K7, csrc/fused_bayes.cu) every weight pointer of the field is
// that of evaluation 0 in a buffer of effective weights (E, P), and
// evaluation e reads its weights P * e elements further on and its biases
// PB * e floats further on (PB = P when the biases live in the same buffer;
// with kBf16 they have a float32 buffer of their own, (E, PB)).
struct UdeArgs {
  size_t P;           // elements of one evaluation's weights (kBayes only)
  size_t PB;          // floats of one evaluation's biases (kBayes only)
  int R;              // regions; the head is 3R wide
  int DT;             // tail width R*(L-3), may be 0
  int N0;             // first-layer width: fp columns, then aug columns
  int n0_fp;          // fp columns of the first layer (0: no SIR term)
  int R_out;          // decoder outputs
  const void* w0h;    // (3R, N0), float or (kBf16) bfloat16
  const void* w0t;    // (DT, N0), likewise
  const float* b0;    // (N0)
  Net fp, aug;
  const float* dec_w; // (3R, R_out)
  const float* dec_b; // (R_out)
};

struct Tile {         // shared-memory buffers, each [width][kTile]
  float4 *zh, *zs, *k1, *k2, *k3, *k4, *ct, *h0, *p, *q, *rates;
  float4 *tail;       // the frozen tail, kept for every evaluation (kBayes only)
  float4 *zr;         // the stage input rounded to bfloat16 (kBf16 only)
};

__device__ __forceinline__ float eluf(float x) { return x > 0.f ? x : expm1f(x); }

__device__ __forceinline__ float4 splat(float v) { return make_float4(v, v, v, v); }

// x rounded to bfloat16 (nearest even), as a float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element i of a weight array: float, or bfloat16 widened to float.
template <bool kBf16>
__device__ __forceinline__ float load_w(const void* __restrict__ W, size_t i) {
  if (kBf16)
    return __uint_as_float((unsigned)__ldg(static_cast<const unsigned short*>(W) + i) << 16);
  return __ldg(static_cast<const float*>(W) + i);
}

// out = in @ W[woff..] + (addend ? addend : bias), ELU on columns < split when
// act_lo and on columns >= split when act_hi, then (round_out) rounded to
// bfloat16 for the product that reads it.  With kBf16, W is bfloat16 and `in`
// is expected already rounded.  Ends with a barrier.
template <bool kBf16>
__device__ void dense(const void* __restrict__ W, size_t woff, const float* __restrict__ bias,
                      const float4* addend, const float4* in, int K, int N,
                      float4* out, int split, bool act_lo, bool act_hi, bool round_out) {
  for (int it = threadIdx.x; it < N * kG; it += blockDim.x) {
    const int j = it % N, g = it / N;
    float4 acc = addend ? addend[j * kG + g] : splat(__ldg(bias + j));
    const float4* x4 = in + g;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float w = load_w<kBf16>(W, woff + (size_t)k * N + j);
      const float4 x = x4[k * kG];
      acc.x += x.x * w; acc.y += x.y * w; acc.z += x.z * w; acc.w += x.w * w;
    }
    if (j < split ? act_lo : act_hi) {
      acc.x = eluf(acc.x); acc.y = eluf(acc.y); acc.z = eluf(acc.z); acc.w = eluf(acc.w);
    }
    if (kBf16 && round_out) {
      acc.x = round_bf16(acc.x); acc.y = round_bf16(acc.y);
      acc.z = round_bf16(acc.z); acc.w = round_bf16(acc.w);
    }
    out[j * kG + g] = acc;
  }
  __syncthreads();
}

// A net's layers after the first, reading `in` (width K).  ELU feeds every
// layer but the last (reference ordering); the last writes `last_out`, the
// others ping-pong through p and q (rounded for the next product with kBf16).
template <bool kBf16>
__device__ void deep_layers(const Net& net, size_t woff, size_t boff, const float4* in, int K,
                            float4* p, float4* q, float4* last_out) {
  for (int d = 0; d < net.n; ++d) {
    const bool last = d == net.n - 1;
    float4* dst = last ? last_out : (d & 1 ? q : p);
    dense<kBf16>(net.w[d], woff, net.b[d] + boff, nullptr, in, K, net.out[d], dst, net.out[d],
                 d + 1 < net.n - 1, false, !last);
    in = dst;
    K = net.out[d];
  }
}

// The UDE field at stage input zs, written to `field` (both [3R][kTile]);
// `e` is the evaluation's index (its weights, with kBayes).
template <bool kBayes, bool kBf16>
__device__ void rhs(const UdeArgs& a, const Tile& s, const float4* zs,
                    float4* field, float fa_w, int e) {
  const bool mech = a.n0_fp > 0, has_aug = a.aug.n > 0;
  const size_t woff = kBayes ? a.P * (size_t)e : 0;
  const size_t boff = kBayes ? a.PB * (size_t)e : 0;
  const float4* zin = zs;
  if (kBf16) {      // the product reads a rounded copy, the SIR field zs itself
    const float* z = reinterpret_cast<const float*>(zs);
    float* zr = reinterpret_cast<float*>(s.zr);
    for (int i = threadIdx.x; i < 3 * a.R * kTile; i += blockDim.x) zr[i] = round_bf16(z[i]);
    zin = s.zr;     // the barrier that ends the tail's product, or this one
    if (!kBayes) __syncthreads();
  }
  // the tail's first-layer term (with the bias): constant when the weights
  // are, recomputed from this evaluation's weights when they are resampled
  if (kBayes)
    dense<kBf16>(a.w0t, woff, a.b0 + boff, nullptr, s.tail, a.DT, a.N0, s.ct, a.N0, false,
                 false, false);
  // first layers of both nets in one pass over the head; the addend is ct
  dense<kBf16>(a.w0h, woff, nullptr, s.ct, zin, 3 * a.R, a.N0, s.h0, a.n0_fp,
               a.fp.n >= 2, a.aug.n >= 2, true);
  if (has_aug)
    deep_layers<kBf16>(a.aug, woff, boff, s.h0 + a.n0_fp * kG, a.N0 - a.n0_fp, s.p, s.q, field);
  if (mech) deep_layers<kBf16>(a.fp, woff, boff, s.h0, a.n0_fp, s.p, s.q, s.rates);

  const float* z = reinterpret_cast<const float*>(zs);
  const float* rt = reinterpret_cast<const float*>(s.rates);
  float* f = reinterpret_cast<float*>(field);
  for (int idx = threadIdx.x; idx < a.R * kTile; idx += blockDim.x) {
    const int r = idx / kTile, row = idx % kTile;
    const int iS = (3 * r) * kTile + row, iI = iS + kTile, iR = iI + kTile;
    float f0, f1, f2;
    if (mech) {
      const float beta = fabsf(rt[(2 * r) * kTile + row]);
      const float gamma = fabsf(rt[(2 * r + 1) * kTile + row]);
      const float plus_i = beta * z[iS] * z[iI];
      const float minus_i = gamma * z[iI];
      f0 = -plus_i;
      f1 = plus_i - minus_i;
      f2 = minus_i;
      if (has_aug) {
        f0 += fa_w * f[iS];
        f1 += fa_w * f[iI];
        f2 += fa_w * f[iR];
      }
    } else {
      f0 = f[iS]; f1 = f[iI]; f2 = f[iR];
    }
    f[iS] = (z[iS] > 2.f || z[iS] < -1.f) ? 0.f : f0;
    f[iI] = (z[iI] > 2.f || z[iI] < -1.f) ? 0.f : f1;
    f[iR] = (z[iR] > 2.f || z[iR] < -1.f) ? 0.f : f2;
  }
  __syncthreads();
}

// Decode the head to out[t] (T, B, R_out), masking rows past B.
__device__ void decode(const UdeArgs& a, const Tile& s, int t, int B, int row0,
                       float* __restrict__ out) {
  // float32 in both compute modes (pallas_ude.py:272-274)
  dense<false>(a.dec_w, 0, a.dec_b, nullptr, s.zh, 3 * a.R, a.R_out, s.p, a.R_out, false, false,
               false);
  const float* y = reinterpret_cast<const float*>(s.p);
  for (int idx = threadIdx.x; idx < kTile * a.R_out; idx += blockDim.x) {
    const int row = idx / a.R_out, o = idx % a.R_out;
    if (row0 + row < B) out[((size_t)t * B + row0 + row) * a.R_out + o] = y[o * kTile + row];
  }
  __syncthreads();
}

template <bool kBayes, bool kBf16>
__global__ void __launch_bounds__(kThreads)
ude_trajectory_kernel(const float* __restrict__ zh0, const float* __restrict__ ztail,
                      int B, int T, float dt, float fa_w, UdeArgs a, int wmax,
                      float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int W3 = 3 * a.R;
  const int row0 = blockIdx.x * kTile;
  Tile s;
  float4* p = smem;
  s.zh = p;  p += W3 * kG;
  s.zs = p;  p += W3 * kG;
  // the tail is staged where the stages will live: it is read once, first
  float4* tail = p;
  s.k1 = p;  p += W3 * kG;
  s.k2 = p;  p += W3 * kG;
  s.k3 = p;  p += W3 * kG;
  s.k4 = p;  p += W3 * kG;
  if (kBayes) { tail = p; p += a.DT * kG; }
  else if (a.DT > 4 * W3) p = tail + a.DT * kG;
  s.tail = tail;
  s.ct = p;  p += a.N0 * kG;
  s.h0 = p;  p += a.N0 * kG;
  s.p = p;   p += wmax * kG;
  s.q = p;   p += wmax * kG;
  s.rates = p;  p += 2 * a.R * kG;
  s.zr = p;

  float* zh = reinterpret_cast<float*>(s.zh);
  float* tl = reinterpret_cast<float*>(tail);
  for (int idx = threadIdx.x; idx < kTile * W3; idx += blockDim.x) {
    const int row = idx / W3, c = idx % W3;
    zh[c * kTile + row] = row0 + row < B ? zh0[(size_t)(row0 + row) * W3 + c] : 0.f;
  }
  for (int idx = threadIdx.x; idx < kTile * a.DT; idx += blockDim.x) {
    const int row = idx / a.DT, c = idx % a.DT;
    const float v = row0 + row < B ? ztail[(size_t)(row0 + row) * a.DT + c] : 0.f;
    tl[c * kTile + row] = kBf16 ? round_bf16(v) : v;      // the tail only feeds a product
  }
  __syncthreads();
  // constant first-layer term of the frozen tail, plus the bias
  if (!kBayes)
    dense<kBf16>(a.w0t, 0, a.b0, nullptr, tail, a.DT, a.N0, s.ct, a.N0, false, false, false);
  decode(a, s, 0, B, row0, out);

  const int n = W3 * kTile;
  float* zs = reinterpret_cast<float*>(s.zs);
  const float* k1 = reinterpret_cast<const float*>(s.k1);
  const float* k2 = reinterpret_cast<const float*>(s.k2);
  const float* k3 = reinterpret_cast<const float*>(s.k3);
  const float* k4 = reinterpret_cast<const float*>(s.k4);
  const float third = 1.f / 3.f;
  for (int t = 1; t < T; ++t) {
    rhs<kBayes, kBf16>(a, s, s.zh, s.k1, fa_w, 4 * (t - 1) + 0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) zs[i] = zh[i] + dt * (third * k1[i]);
    __syncthreads();
    rhs<kBayes, kBf16>(a, s, s.zs, s.k2, fa_w, 4 * (t - 1) + 1);
    for (int i = threadIdx.x; i < n; i += blockDim.x) zs[i] = zh[i] + dt * (k2[i] - third * k1[i]);
    __syncthreads();
    rhs<kBayes, kBf16>(a, s, s.zs, s.k3, fa_w, 4 * (t - 1) + 2);
    for (int i = threadIdx.x; i < n; i += blockDim.x) zs[i] = zh[i] + dt * (k1[i] - k2[i] + k3[i]);
    __syncthreads();
    rhs<kBayes, kBf16>(a, s, s.zs, s.k4, fa_w, 4 * (t - 1) + 3);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      zh[i] = zh[i] + dt * (k1[i] + 3.f * (k2[i] + k3[i]) + k4[i]) * 0.125f;
    __syncthreads();
    decode(a, s, t, B, row0, out);
  }
}

// Shared-memory bytes a block needs (the layout carved in the kernel).
size_t smem_bytes(int R, int DT, int N0, int wmax, bool bayes, bool bf16) {
  const size_t W3 = 3 * (size_t)R;
  const size_t stages = bayes ? 4 * W3 + (size_t)DT : (size_t)DT > 4 * W3 ? (size_t)DT : 4 * W3;
  const size_t feats = 2 * W3 + stages + 2 * (size_t)N0 + 2 * (size_t)wmax + 2 * (size_t)R +
                       (bf16 ? W3 : 0);
  return feats * kTile * sizeof(float);
}

// Ping-pong width: every inner layer's output and the decoded row.
int pingpong_width(int R_out, int n_fp, const int* fp_out, int n_aug, const int* aug_out) {
  int wmax = R_out;
  for (int d = 0; d + 1 < n_fp; ++d) wmax = fp_out[d] > wmax ? fp_out[d] : wmax;
  for (int d = 0; d + 1 < n_aug; ++d) wmax = aug_out[d] > wmax ? aug_out[d] : wmax;
  return wmax;
}

template <bool kBayes, bool kBf16>
int launch_trajectory(const float* zh0, const float* ztail, int B, int T, float dt, float fa_w,
                      const UdeArgs& a, int wmax, float* out, void* stream) {
  const size_t smem = smem_bytes(a.R, a.DT, a.N0, wmax, kBayes, kBf16);
  cudaError_t err = cudaFuncSetAttribute(ude_trajectory_kernel<kBayes, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kTile - 1) / kTile;
  ude_trajectory_kernel<kBayes, kBf16>
      <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(zh0, ztail, B, T, dt, fa_w,
                                                                       a, wmax, out);
  return cudaGetLastError();
}

}  // namespace
