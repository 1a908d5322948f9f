// RK4(3/8) trajectory of the UDE field plus the per-step linear decode, for
// Hopper (sm_90a): kernel K2 of the serving path.
//
// Replaces: fiude_tpu/ops/pallas_ude.py::fused_trajectory_decode (kernel body
// _make_kernel, pallas_ude.py:184-299): T-1 Kutta 3/8 steps x 4 evaluations of
// the UDE field on the S, I, R head of the state, with the frozen latent
// tail's first-layer term computed once (pallas_ude.py:251-255), ELU MLPs,
// |.| rates, SIR + fa_w * Fa (or SIR alone, or Fa alone), out-of-range
// zeroing, and each step's state decoded to R outputs (pallas_ude.py:262-290).
//
// What bounds it on the card: arithmetic on the float32 pipes.  Each RHS
// evaluation is ~41.6k multiply-adds a row at the `state` config (every hot
// weight used once a row), so at B = 2048, T = 85 a forecast is ~60 GFLOP of
// thin products (K, N <= 147), which tensor cores would only take in TF32 or
// lower precision; the serving path stays in float32.  The 41.6k hot weights
// (166 KB) and the decoder (29 KB) do not fit one block's 227 KB of shared
// memory beside a state tile.
//
// What the design does about it:
//  * one block per tile of kTile = 16 ensemble rows (128 blocks at B = 2048);
//    the ragged last tile is masked, not shrunk;
//  * the tile's state head, the four stages and every MLP activation stay in
//    shared memory for all T steps, stored feature-major ([feature][row]):
//    a column slice of an activation is contiguous, and one 16-byte shared
//    load gives a thread the same feature of four rows;
//  * weights are read from global memory through the read-only path (__ldg),
//    where the working set stays in L1 and L2 (about 92 KB of shared memory a
//    block at the `state` config, which leaves the rest of the SM's 256 KB to
//    L1).  Thread j of a layer owns output column j for four rows, so a warp
//    reads consecutive weights, and each weight loaded serves four rows;
//  * ELU is applied in the epilogue of the layer whose output the next layer
//    reads activated, never inside an inner loop;
//  * no packing: the head is region-major (r*3 + c), which is the order the
//    rates net (beta, gamma per region), the Fa net (3 per region) and the
//    decoder already use, so only the first layers' rows are split into head
//    and tail (by the caller);
//  * fa_w and dt are runtime arguments, so a fa_w ramp or a new grid step
//    needs no rebuild.
// All arithmetic is float32.  The kernel allocates nothing.

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
  const float* w[kMaxDeep];     // (in, out)
  const float* b[kMaxDeep];
};

struct UdeArgs {
  int R;              // regions; the head is 3R wide
  int DT;             // tail width R*(L-3), may be 0
  int N0;             // first-layer width: fp columns, then aug columns
  int n0_fp;          // fp columns of the first layer (0: no SIR term)
  int R_out;          // decoder outputs
  const float* w0h;   // (3R, N0)
  const float* w0t;   // (DT, N0)
  const float* b0;    // (N0)
  Net fp, aug;
  const float* dec_w; // (3R, R_out)
  const float* dec_b; // (R_out)
};

struct Tile {         // shared-memory buffers, each [width][kTile]
  float4 *zh, *zs, *k1, *k2, *k3, *k4, *ct, *h0, *p, *q, *rates;
};

__device__ __forceinline__ float eluf(float x) { return x > 0.f ? x : expm1f(x); }

__device__ __forceinline__ float4 splat(float v) { return make_float4(v, v, v, v); }

// out = in @ W + (addend ? addend : bias), ELU on columns < split when
// act_lo and on columns >= split when act_hi.  Ends with a barrier.
__device__ void dense(const float* __restrict__ W, const float* __restrict__ bias,
                      const float4* addend, const float4* in, int K, int N,
                      float4* out, int split, bool act_lo, bool act_hi) {
  for (int it = threadIdx.x; it < N * kG; it += blockDim.x) {
    const int j = it % N, g = it / N;
    float4 acc = addend ? addend[j * kG + g] : splat(__ldg(bias + j));
    const float4* x4 = in + g;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(W + (size_t)k * N + j);
      const float4 x = x4[k * kG];
      acc.x += x.x * w; acc.y += x.y * w; acc.z += x.z * w; acc.w += x.w * w;
    }
    if (j < split ? act_lo : act_hi) {
      acc.x = eluf(acc.x); acc.y = eluf(acc.y); acc.z = eluf(acc.z); acc.w = eluf(acc.w);
    }
    out[j * kG + g] = acc;
  }
  __syncthreads();
}

// A net's layers after the first, reading `in` (width K).  ELU feeds every
// layer but the last (reference ordering); the last writes `last_out`, the
// others ping-pong through p and q.
__device__ void deep_layers(const Net& net, const float4* in, int K, float4* p,
                            float4* q, float4* last_out) {
  for (int d = 0; d < net.n; ++d) {
    const bool last = d == net.n - 1;
    float4* dst = last ? last_out : (d & 1 ? q : p);
    dense(net.w[d], net.b[d], nullptr, in, K, net.out[d], dst, net.out[d],
          d + 1 < net.n - 1, false);
    in = dst;
    K = net.out[d];
  }
}

// The UDE field at stage input zs, written to `field` (both [3R][kTile]).
__device__ void rhs(const UdeArgs& a, const Tile& s, const float4* zs,
                    float4* field, float fa_w) {
  const bool mech = a.n0_fp > 0, has_aug = a.aug.n > 0;
  // first layers of both nets in one pass over the head; the frozen tail's
  // term (with the bias) is the addend ct
  dense(a.w0h, nullptr, s.ct, zs, 3 * a.R, a.N0, s.h0, a.n0_fp,
        a.fp.n >= 2, a.aug.n >= 2);
  if (has_aug) deep_layers(a.aug, s.h0 + a.n0_fp * kG, a.N0 - a.n0_fp, s.p, s.q, field);
  if (mech) deep_layers(a.fp, s.h0, a.n0_fp, s.p, s.q, s.rates);

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
  dense(a.dec_w, a.dec_b, nullptr, s.zh, 3 * a.R, a.R_out, s.p, a.R_out, false, false);
  const float* y = reinterpret_cast<const float*>(s.p);
  for (int idx = threadIdx.x; idx < kTile * a.R_out; idx += blockDim.x) {
    const int row = idx / a.R_out, o = idx % a.R_out;
    if (row0 + row < B) out[((size_t)t * B + row0 + row) * a.R_out + o] = y[o * kTile + row];
  }
  __syncthreads();
}

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
  if (a.DT > 4 * W3) p = tail + a.DT * kG;
  s.ct = p;  p += a.N0 * kG;
  s.h0 = p;  p += a.N0 * kG;
  s.p = p;   p += wmax * kG;
  s.q = p;   p += wmax * kG;
  s.rates = p;

  float* zh = reinterpret_cast<float*>(s.zh);
  float* tl = reinterpret_cast<float*>(tail);
  for (int idx = threadIdx.x; idx < kTile * W3; idx += blockDim.x) {
    const int row = idx / W3, c = idx % W3;
    zh[c * kTile + row] = row0 + row < B ? zh0[(size_t)(row0 + row) * W3 + c] : 0.f;
  }
  for (int idx = threadIdx.x; idx < kTile * a.DT; idx += blockDim.x) {
    const int row = idx / a.DT, c = idx % a.DT;
    tl[c * kTile + row] = row0 + row < B ? ztail[(size_t)(row0 + row) * a.DT + c] : 0.f;
  }
  __syncthreads();
  // constant first-layer term of the frozen tail, plus the bias
  dense(a.w0t, a.b0, nullptr, tail, a.DT, a.N0, s.ct, a.N0, false, false);
  decode(a, s, 0, B, row0, out);

  const int n = W3 * kTile;
  float* zs = reinterpret_cast<float*>(s.zs);
  const float* k1 = reinterpret_cast<const float*>(s.k1);
  const float* k2 = reinterpret_cast<const float*>(s.k2);
  const float* k3 = reinterpret_cast<const float*>(s.k3);
  const float* k4 = reinterpret_cast<const float*>(s.k4);
  const float third = 1.f / 3.f;
  for (int t = 1; t < T; ++t) {
    rhs(a, s, s.zh, s.k1, fa_w);
    for (int i = threadIdx.x; i < n; i += blockDim.x) zs[i] = zh[i] + dt * (third * k1[i]);
    __syncthreads();
    rhs(a, s, s.zs, s.k2, fa_w);
    for (int i = threadIdx.x; i < n; i += blockDim.x) zs[i] = zh[i] + dt * (k2[i] - third * k1[i]);
    __syncthreads();
    rhs(a, s, s.zs, s.k3, fa_w);
    for (int i = threadIdx.x; i < n; i += blockDim.x) zs[i] = zh[i] + dt * (k1[i] - k2[i] + k3[i]);
    __syncthreads();
    rhs(a, s, s.zs, s.k4, fa_w);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      zh[i] = zh[i] + dt * (k1[i] + 3.f * (k2[i] + k3[i]) + k4[i]) * 0.125f;
    __syncthreads();
    decode(a, s, t, B, row0, out);
  }
}

void fill_net(Net& net, int n, const int* outs, const void* const* w, const void* const* b) {
  net.n = n;
  for (int d = 0; d < n; ++d) {
    net.out[d] = outs[d];
    net.w[d] = static_cast<const float*>(w[d]);
    net.b[d] = static_cast<const float*>(b[d]);
  }
}

// Shared-memory bytes a block needs (the layout carved in the kernel).
size_t smem_bytes(int R, int DT, int N0, int wmax) {
  const size_t W3 = 3 * (size_t)R;
  const size_t stages = (size_t)DT > 4 * W3 ? (size_t)DT : 4 * W3;
  const size_t feats = 2 * W3 + stages + 2 * (size_t)N0 + 2 * (size_t)wmax + 2 * (size_t)R;
  return feats * kTile * sizeof(float);
}

}  // namespace

extern "C" {

// zh0 (B, 3R) region-major head; ztail (B, DT); weights (in, out) float32;
// out (T, B, R_out).  Launches on `stream`; returns cudaGetLastError().
int fused_ude_trajectory(const float* zh0, const float* ztail, int B, int T,
                         float dt, float fa_w, int R, int DT, int N0, int n0_fp,
                         int R_out, const void* w0h, const void* w0t, const void* b0,
                         int n_fp, const int* fp_out, const void* const* fp_w,
                         const void* const* fp_b, int n_aug, const int* aug_out,
                         const void* const* aug_w, const void* const* aug_b,
                         const void* dec_w, const void* dec_b, float* out,
                         void* stream) {
  if (B < 1 || T < 1 || R < 1 || DT < 0 || N0 < 1 || R_out < 1 || n_fp < 0 || n_fp > kMaxDeep || n_aug < 0 || n_aug > kMaxDeep ||
      (n_fp > 0) != (n0_fp > 0) || (n_aug > 0) != (N0 > n0_fp))
    return cudaErrorInvalidValue;
  UdeArgs a = {};
  a.R = R; a.DT = DT; a.N0 = N0; a.n0_fp = n0_fp; a.R_out = R_out;
  a.w0h = static_cast<const float*>(w0h);
  a.w0t = static_cast<const float*>(w0t);
  a.b0 = static_cast<const float*>(b0);
  a.dec_w = static_cast<const float*>(dec_w);
  a.dec_b = static_cast<const float*>(dec_b);
  fill_net(a.fp, n_fp, fp_out, fp_w, fp_b);
  fill_net(a.aug, n_aug, aug_out, aug_w, aug_b);
  // ping-pong width: every inner layer's output and the decoded row
  int wmax = R_out;
  for (int d = 0; d + 1 < n_fp; ++d) wmax = fp_out[d] > wmax ? fp_out[d] : wmax;
  for (int d = 0; d + 1 < n_aug; ++d) wmax = aug_out[d] > wmax ? aug_out[d] : wmax;
  const size_t smem = smem_bytes(R, DT, N0, wmax);

  cudaError_t err = cudaFuncSetAttribute(
      ude_trajectory_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kTile - 1) / kTile;
  ude_trajectory_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      zh0, ztail, B, T, dt, fa_w, a, wmax, out);
  return cudaGetLastError();
}

}  // extern "C"
