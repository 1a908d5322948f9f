// RK4(3/8) training trajectory of the UDE field in stats mode, forward and
// hand-written backward, for Hopper (sm_90a): kernels K5 and K6 of the
// training path.
//
// Replaces: fiude_tpu/ops/pallas_train.py::_get_train_traj.fwd_impl (K5,
// kernel body _make_fwd_kernel, pallas_train.py:174-325) and
// ::_get_train_traj.bwd_impl (K6, _make_bwd_kernel, pallas_train.py:332-618),
// in stats mode (stats_mode=True): T-1 Kutta 3/8 steps of the field's S, I, R
// head (ELU MLPs, |.| rates, SIR + fa_w * Fa, out-of-range freeze), the head
// trajectory, and instead of the per-evaluation aux streams five masked sums:
// sum(beta - 0.8), sum(gamma - 0.55), their sums of squares, and sum(Fa^2),
// each evaluation weighted by tmask[step].  The backward recomputes the four
// stages of every step from the stored state (recompute, not store), and
// backpropagates by hand through the stage combination, the MLPs, |.|, the
// SIR field and the freeze mask, rebuilding each evaluation's aux cotangent
// from the five statistics' cotangents (pallas_train.py:435-445).
//
// What bounds it on the card: float32 arithmetic on the CUDA cores and the
// latency of the weight reads, as in K2 (csrc/fused_ude.cu): each RHS
// evaluation is ~41.6k multiply-adds a row at the `state` config, and the
// backward does ~15 evaluations' worth a step (3 recomputed stages, then 4
// evaluations each recomputed with its activations kept, backpropagated to
// the inputs, and contracted into the weight cotangents).  The TPU backward
// sums weight cotangents in per-tile VMEM blocks; one block of the card holds
// 227 KB of shared memory, not the 166 KB of hot weights' cotangents beside
// the ~3x larger live set of the backward, and float atomics across blocks
// would change the gradient's bits from run to run.
//
// What the design does about it:
//  * one block per tile of kTile = 16 ensemble rows (128 blocks at B = 2048),
//    the ragged last tile masked (its rows contribute nothing to the sums);
//  * state, stages, stage cotangents and every layer's pre- and
//    post-activation stay in shared memory, feature-major ([feature][row]);
//    ~210 KB a block in the backward at the `state` config, ~110 KB forward;
//  * each block owns one slice of a partials buffer in global memory and
//    adds its weight cotangents there, each element owned by one thread in
//    every pass; the slices are summed after the launch (as the JAX package
//    sums its per-tile blocks, pallas_train.py:806-810): no atomics, the same
//    bits on every run;
//  * the frozen tail's first-layer term is computed once; its cotangents
//    (the tail's, the tail weights', the first bias's) are contracted once at
//    the end from the first layer's cotangent summed over all evaluations;
//  * the backward reads transposed copies of the weights ((out, in)), so the
//    threads of a warp read consecutive addresses in both directions;
//  * the statistics are accumulated per thread over the whole trajectory and
//    reduced once per block, in a fixed order.
// All arithmetic is float32.  The kernels allocate nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxDeep = 8;     // layers after the first, per net
constexpr int kTile = 16;       // ensemble rows per block
constexpr int kG = kTile / 4;   // float4 row groups per feature
constexpr int kThreads = 256;
constexpr int kStats = 8;       // floats of statistics a block writes (5 used)
constexpr float kShiftBeta = 0.8f, kShiftGamma = 0.55f;   // RATE_SHIFT

struct Net {
  int n;                        // layers after the first (0: net absent)
  int out[kMaxDeep];
  const float* w[kMaxDeep];     // (in, out)
  const float* wt[kMaxDeep];    // (out, in)
  const float* b[kMaxDeep];
  size_t gw[kMaxDeep], gb[kMaxDeep];   // offsets of the cotangents in a slice
};

struct Args {
  int B, T, R, DT, N0, n0_fp;
  int dmax;            // the widest layer after the first
  const float* w0h;    // (3R, N0)
  const float* w0t;    // (DT, N0)
  const float* b0;     // (N0)
  const float* w0ht;   // (N0, 3R)
  const float* w0tt;   // (N0, DT)
  Net fp, aug;
  const float* dts;    // (T-1)
  const float* tmask;  // (T-1)
  const float* fa_w;   // scalar
  size_t g_w0h, g_w0t, g_b0, g_faw, n_grad;   // slice layout
};

// Per-net activation buffers: pre[d] for every layer after the first,
// post[d] (what layer d+1 reads) for all but the last.
struct Acts {
  float4* pre[kMaxDeep];
  float4* post[kMaxDeep];
};

struct Stash {
  float4 *ct, *h0pre, *h0post;
  Acts fp, aug;
};

__device__ __forceinline__ float eluf(float x) { return x > 0.f ? x : expm1f(x); }

// d/dh elu(h) as the JAX kernel writes it (pallas_train.py:100-102)
__device__ __forceinline__ float elu_grad(float h) { return h > 0.f ? 1.f : expf(fminf(h, 0.f)); }

__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.f) - (x < 0.f)); }

__device__ __forceinline__ bool frozen(float x) { return x > 2.f || x < -1.f; }

__device__ __forceinline__ float4 splat(float v) { return make_float4(v, v, v, v); }

__device__ __forceinline__ void fma4(float4& acc, const float4& x, float w) {
  acc.x += x.x * w; acc.y += x.y * w; acc.z += x.z * w; acc.w += x.w * w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// pre = in @ W + (addend ? addend : bias); post (if given) = ELU(pre) on the
// columns < split when act_lo and >= split when act_hi, pre elsewhere.
// Ends with a barrier.
__device__ void dense(const float* __restrict__ W, const float* __restrict__ bias,
                      const float4* addend, const float4* in, int K, int N,
                      float4* pre, float4* post, int split, bool act_lo, bool act_hi) {
  for (int it = threadIdx.x; it < N * kG; it += blockDim.x) {
    const int j = it % N, g = it / N;
    float4 acc = addend ? addend[j * kG + g] : splat(__ldg(bias + j));
    const float4* x4 = in + g;
#pragma unroll 4
    for (int k = 0; k < K; ++k) fma4(acc, x4[k * kG], __ldg(W + (size_t)k * N + j));
    pre[j * kG + g] = acc;
    if (post) {
      if (j < split ? act_lo : act_hi) {
        acc.x = eluf(acc.x); acc.y = eluf(acc.y); acc.z = eluf(acc.z); acc.w = eluf(acc.w);
      }
      post[j * kG + g] = acc;
    }
  }
  __syncthreads();
}

// out (+)= (delta @ W^T) [* elu'(pre) when act], Wt (N, K) = W^T row-major.
// Ends with a barrier.
__device__ void dense_back(const float* __restrict__ Wt, const float4* delta, int N, int K,
                           float4* out, const float4* pre, bool act, bool accumulate) {
  for (int it = threadIdx.x; it < K * kG; it += blockDim.x) {
    const int k = it % K, g = it / K;
    float4 acc = splat(0.f);
    const float4* d4 = delta + g;
#pragma unroll 4
    for (int j = 0; j < N; ++j) fma4(acc, d4[j * kG], __ldg(Wt + (size_t)j * K + k));
    if (act) {
      const float4 h = pre[k * kG + g];
      acc.x *= elu_grad(h.x); acc.y *= elu_grad(h.y);
      acc.z *= elu_grad(h.z); acc.w *= elu_grad(h.w);
    }
    if (accumulate) {
      const float4 o = out[k * kG + g];
      acc.x += o.x; acc.y += o.y; acc.z += o.z; acc.w += o.w;
    }
    out[k * kG + g] = acc;
  }
  __syncthreads();
}

// This block's slice: gw (K, N) += x^T delta, gb (N) += column sums of delta,
// over the tile's rows.  Each element has one owner thread.
__device__ void weight_grad(const float4* x, int K, const float4* delta, int N,
                            float* __restrict__ gw, float* __restrict__ gb) {
  for (int it = threadIdx.x; it < K * N; it += blockDim.x) {
    const int k = it / N, j = it % N;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kG; ++g) s += dot4(x[k * kG + g], delta[j * kG + g]);
    gw[it] += s;
  }
  if (gb != nullptr) {
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 d = delta[j * kG + g];
        s += d.x + d.y + d.z + d.w;
      }
      gb[j] += s;
    }
  }
}

// A net's layers after the first, reading `in` (width K), pre/post-activations
// into `acts`.  Layer d's output is ELU'd for layer d+1 when d < n-2.
__device__ void net_forward(const Net& net, const float4* in, int K, const Acts& acts) {
  for (int d = 0; d < net.n; ++d) {
    const bool last = d == net.n - 1;
    dense(net.w[d], net.b[d], nullptr, in, K, net.out[d], acts.pre[d],
          last ? nullptr : acts.post[d], net.out[d], d < net.n - 2, false);
    in = acts.post[d];
    K = net.out[d];
  }
}

// One RHS evaluation at zs, keeping every activation in `st`.  With `field`,
// also writes the field; with `stats`, adds this evaluation's statistics
// (weight m, tile rows < valid) to the thread's accumulators.
__device__ void rhs_eval(const Args& a, const Stash& st, const float4* zs, float4* field,
                         float fa_w, float m, int valid, float* stats) {
  const bool mech = a.n0_fp > 0, has_aug = a.aug.n > 0;
  dense(a.w0h, nullptr, st.ct, zs, 3 * a.R, a.N0, st.h0pre, st.h0post, a.n0_fp,
        a.fp.n >= 2, a.aug.n >= 2);
  if (mech) net_forward(a.fp, st.h0post, a.n0_fp, st.fp);
  if (has_aug) net_forward(a.aug, st.h0post + a.n0_fp * kG, a.N0 - a.n0_fp, st.aug);
  if (field == nullptr && stats == nullptr) return;

  const float* z = reinterpret_cast<const float*>(zs);
  const float* rp = mech ? reinterpret_cast<const float*>(st.fp.pre[a.fp.n - 1]) : nullptr;
  const float* fa = has_aug ? reinterpret_cast<const float*>(st.aug.pre[a.aug.n - 1]) : nullptr;
  float* f = reinterpret_cast<float*>(field);
  for (int idx = threadIdx.x; idx < a.R * kTile; idx += blockDim.x) {
    const int r = idx / kTile, row = idx % kTile;
    const int iS = (3 * r) * kTile + row, iI = iS + kTile, iR = iI + kTile;
    float beta = 0.f, gamma = 0.f;
    if (mech) {
      beta = fabsf(rp[(2 * r) * kTile + row]);
      gamma = fabsf(rp[(2 * r + 1) * kTile + row]);
    }
    if (stats != nullptr && row < valid) {
      if (mech) {
        const float db = beta - kShiftBeta, dg = gamma - kShiftGamma;
        stats[0] += m * db;
        stats[1] += m * dg;
        stats[2] += m * (db * db);
        stats[3] += m * (dg * dg);
      }
      if (has_aug)
        stats[4] += m * (fa[iS] * fa[iS] + fa[iI] * fa[iI] + fa[iR] * fa[iR]);
    }
    if (f == nullptr) continue;
    float f0, f1, f2;
    if (mech) {
      const float plus_i = beta * z[iS] * z[iI];
      const float minus_i = gamma * z[iI];
      f0 = -plus_i;
      f1 = plus_i - minus_i;
      f2 = minus_i;
      if (has_aug) {
        f0 += fa_w * fa[iS];
        f1 += fa_w * fa[iI];
        f2 += fa_w * fa[iR];
      }
    } else {
      f0 = fa[iS]; f1 = fa[iI]; f2 = fa[iR];
    }
    f[iS] = frozen(z[iS]) ? 0.f : f0;
    f[iI] = frozen(z[iI]) ? 0.f : f1;
    f[iR] = frozen(z[iR]) ? 0.f : f2;
  }
  __syncthreads();
}

// Carve the stash (ct, h0 pre/post, both nets' activations) from p.
__device__ float4* carve_stash(const Args& a, float4* p, Stash& st) {
  st.ct = p;     p += a.N0 * kG;
  st.h0pre = p;  p += a.N0 * kG;
  st.h0post = p; p += a.N0 * kG;
  const Net* nets[2] = {&a.fp, &a.aug};
  Acts* acts[2] = {&st.fp, &st.aug};
  for (int q = 0; q < 2; ++q) {
    for (int d = 0; d < nets[q]->n; ++d) {
      acts[q]->pre[d] = p;
      p += nets[q]->out[d] * kG;
      if (d + 1 < nets[q]->n) {
        acts[q]->post[d] = p;
        p += nets[q]->out[d] * kG;
      }
    }
  }
  return p;
}

size_t stash_features(const Args& a) {
  size_t n = 3 * (size_t)a.N0;
  const Net* nets[2] = {&a.fp, &a.aug};
  for (const Net* net : nets)
    for (int d = 0; d < net->n; ++d) n += (d + 1 < net->n ? 2 : 1) * (size_t)net->out[d];
  return n;
}

// Load rows of a (B, W) matrix into a [W][kTile] buffer, zero past B.
__device__ void load_tile(const float* __restrict__ src, int B, int W, int row0, float4* dst) {
  float* d = reinterpret_cast<float*>(dst);
  for (int idx = threadIdx.x; idx < kTile * W; idx += blockDim.x) {
    const int row = idx / W, c = idx % W;
    d[c * kTile + row] = row0 + row < B ? src[(size_t)(row0 + row) * W + c] : 0.f;
  }
}

__device__ void store_tile(const float4* src, int B, int W, int row0, float* __restrict__ dst) {
  const float* s = reinterpret_cast<const float*>(src);
  for (int idx = threadIdx.x; idx < kTile * W; idx += blockDim.x) {
    const int row = idx / W, c = idx % W;
    if (row0 + row < B) dst[(size_t)(row0 + row) * W + c] = s[c * kTile + row];
  }
}

// Deterministic block sum of v[k] (k < nv) into out[k], zeros into
// out[nv .. kStats); uses buf (nv * blockDim floats of shared memory).
__device__ void block_sum(const float* v, int nv, float* buf, float* __restrict__ out) {
  const int tid = threadIdx.x, n = blockDim.x;
  for (int k = 0; k < nv; ++k) buf[k * n + tid] = v[k];
  __syncthreads();
  for (int w = n / 2; w > 0; w /= 2) {
    if (tid < w)
      for (int k = 0; k < nv; ++k) buf[k * n + tid] += buf[k * n + tid + w];
    __syncthreads();
  }
  if (tid < kStats) out[tid] = tid < nv ? buf[tid * n] : 0.f;
}

// ---------------------------------------------------------------------------
// K5: forward.  Shared memory: zh, zs, k1..k4 ([3R][kTile] each; the tail is
// staged over the stages first), then the stash.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
train_forward_kernel(const float* __restrict__ zh0, const float* __restrict__ ztail,
                     Args a, float* __restrict__ traj, float* __restrict__ stats_out) {
  extern __shared__ float4 smem[];
  const int W3 = 3 * a.R, B = a.B;
  const int row0 = blockIdx.x * kTile;
  const int valid = min(kTile, B - row0);
  float4* p = smem;
  float4* zh = p; p += W3 * kG;
  float4* zs = p; p += W3 * kG;
  float4* k[4];
  float4* stages = p;
  for (int q = 0; q < 4; ++q) { k[q] = p; p += W3 * kG; }
  if (a.DT > 4 * W3) p = stages + a.DT * kG;
  Stash st;
  carve_stash(a, p, st);
  const float fa_w = *a.fa_w;

  load_tile(zh0, B, W3, row0, zh);
  load_tile(ztail, B, a.DT, row0, stages);
  __syncthreads();
  dense(a.w0t, a.b0, nullptr, stages, a.DT, a.N0, st.ct, nullptr, 0, false, false);
  store_tile(zh, B, W3, row0, traj);

  float acc[kStats] = {};
  const int n = W3 * kTile;
  float* zhf = reinterpret_cast<float*>(zh);
  float* zsf = reinterpret_cast<float*>(zs);
  const float* k1 = reinterpret_cast<const float*>(k[0]);
  const float* k2 = reinterpret_cast<const float*>(k[1]);
  const float* k3 = reinterpret_cast<const float*>(k[2]);
  const float* k4 = reinterpret_cast<const float*>(k[3]);
  const float third = 1.f / 3.f;
  for (int i = 0; i + 1 < a.T; ++i) {
    const float dt = a.dts[i], m = a.tmask[i];
    rhs_eval(a, st, zh, k[0], fa_w, m, valid, acc);
    for (int e = threadIdx.x; e < n; e += blockDim.x) zsf[e] = zhf[e] + dt * k1[e] * third;
    __syncthreads();
    rhs_eval(a, st, zs, k[1], fa_w, m, valid, acc);
    for (int e = threadIdx.x; e < n; e += blockDim.x) zsf[e] = zhf[e] + dt * (k2[e] - k1[e] * third);
    __syncthreads();
    rhs_eval(a, st, zs, k[2], fa_w, m, valid, acc);
    for (int e = threadIdx.x; e < n; e += blockDim.x) zsf[e] = zhf[e] + dt * (k1[e] - k2[e] + k3[e]);
    __syncthreads();
    rhs_eval(a, st, zs, k[3], fa_w, m, valid, acc);
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      zhf[e] = zhf[e] + dt * (k1[e] + 3.f * (k2[e] + k3[e]) + k4[e]) * 0.125f;
    __syncthreads();
    store_tile(zh, B, W3, row0, traj + (size_t)(i + 1) * B * W3);
  }
  block_sum(acc, 5, reinterpret_cast<float*>(stages), stats_out + (size_t)blockIdx.x * kStats);
}

// ---------------------------------------------------------------------------
// K6: backward.
// ---------------------------------------------------------------------------
struct Grad {          // [feature][kTile] buffers of the reverse sweep
  float4 *zh, *u2, *u3, *u4;             // the step's stage inputs
  float4 *gz, *gacc, *gk1, *gk2, *gk3;   // cotangents
  float4 *gout, *gu;                     // one evaluation's VJP: in, out
  float4 *d0, *d0sum;                    // first layer's cotangent; its sum
  float4 *da, *db, *dc;                  // deep-layer cotangents
};

// Backprop a net's layers after the first from `delta` (its last layer's
// output cotangent, in buffer `x`), into the first layer's columns
// [c0, c0 + K0) of g.d0; ping-pongs through x and y.
__device__ void net_backward(const Args& a, const Net& net, const Acts& acts,
                             const Stash& st, int c0, int K0, float4* x, float4* y,
                             const Grad& g, float* slice) {
  float4* delta = x;
  float4* other = y;
  for (int d = net.n - 1; d >= 0; --d) {
    const float4* in = d == 0 ? st.h0post + c0 * kG : acts.post[d - 1];
    const float4* in_pre = d == 0 ? st.h0pre + c0 * kG : acts.pre[d - 1];
    const int K = d == 0 ? K0 : net.out[d - 1];
    const bool act = d == 0 ? net.n >= 2 : d - 1 < net.n - 2;
    weight_grad(in, K, delta, net.out[d], slice + net.gw[d], slice + net.gb[d]);
    float4* dst = d == 0 ? g.d0 + c0 * kG : other;
    dense_back(net.wt[d], delta, net.out[d], K, dst, in_pre, act, false);
    other = delta;
    delta = dst;
  }
}

// VJP of one RHS evaluation at u: g.gu = d(field)/du^T g.gout, with every
// weight cotangent added to this block's slice.  In stats mode the aux
// cotangents are m * (g1 + 2 (rate - shift) g2) for the rates and
// m * 2 g_f2 Fa for the Fa field (pallas_train.py:435-445).  The freeze mask
// zeroes the field's cotangent, not the state's.
__device__ void rhs_vjp(const Args& a, const Stash& st, const Grad& g, const float4* u,
                        float fa_w, float m, const float* gs, int valid, float* slice,
                        float& faw_acc) {
  const bool mech = a.n0_fp > 0, has_aug = a.aug.n > 0;
  rhs_eval(a, st, u, nullptr, fa_w, m, valid, nullptr);

  const float* z = reinterpret_cast<const float*>(u);
  const float* go = reinterpret_cast<const float*>(g.gout);
  float* gu = reinterpret_cast<float*>(g.gu);
  const float* rp = mech ? reinterpret_cast<const float*>(st.fp.pre[a.fp.n - 1]) : nullptr;
  const float* fa = has_aug ? reinterpret_cast<const float*>(st.aug.pre[a.aug.n - 1]) : nullptr;
  float* d_rates = reinterpret_cast<float*>(g.da);
  float* d_fa = reinterpret_cast<float*>(g.dc);
  for (int idx = threadIdx.x; idx < a.R * kTile; idx += blockDim.x) {
    const int r = idx / kTile, row = idx % kTile;
    const bool live = row < valid;
    const int iS = (3 * r) * kTile + row, iI = iS + kTile, iR = iI + kTile;
    const float gS = frozen(z[iS]) ? 0.f : go[iS];
    const float gI = frozen(z[iI]) ? 0.f : go[iI];
    const float gR = frozen(z[iR]) ? 0.f : go[iR];
    float uS = 0.f, uI = 0.f;
    if (mech) {
      const float pb = rp[(2 * r) * kTile + row], pg = rp[(2 * r + 1) * kTile + row];
      const float beta = fabsf(pb), gamma = fabsf(pg);
      const float S = z[iS], I = z[iI];
      const float g_plus = gI - gS, g_minus = gR - gI;
      float gbeta = g_plus * S * I;
      float ggam = g_minus * I;
      uS = g_plus * beta * I;
      uI = g_plus * beta * S + g_minus * gamma;
      if (live) {
        gbeta += m * (gs[0] + 2.f * (beta - kShiftBeta) * gs[2]);
        ggam += m * (gs[1] + 2.f * (gamma - kShiftGamma) * gs[3]);
      }
      d_rates[(2 * r) * kTile + row] = sgn(pb) * gbeta;
      d_rates[(2 * r + 1) * kTile + row] = sgn(pg) * ggam;
      if (has_aug) {
        faw_acc += gS * fa[iS] + gI * fa[iI] + gR * fa[iR];
        d_fa[iS] = fa_w * gS;
        d_fa[iI] = fa_w * gI;
        d_fa[iR] = fa_w * gR;
      }
    } else {
      d_fa[iS] = gS; d_fa[iI] = gI; d_fa[iR] = gR;
    }
    if (has_aug && live) {
      const float c = m * (2.f * gs[4]);
      d_fa[iS] += c * fa[iS];
      d_fa[iI] += c * fa[iI];
      d_fa[iR] += c * fa[iR];
    }
    gu[iS] = uS;
    gu[iI] = uI;
    gu[iR] = 0.f;
  }
  __syncthreads();
  if (mech) net_backward(a, a.fp, st.fp, st, 0, a.n0_fp, g.da, g.db, g, slice);
  if (has_aug) net_backward(a, a.aug, st.aug, st, a.n0_fp, a.N0 - a.n0_fp, g.dc, g.db, g, slice);
  // first layer: its weights' cotangent per evaluation, the bias and tail
  // terms from the sum over evaluations (at the end), the input cotangent
  weight_grad(u, 3 * a.R, g.d0, a.N0, slice + a.g_w0h, nullptr);
  float* d0sum = reinterpret_cast<float*>(g.d0sum);
  const float* d0 = reinterpret_cast<const float*>(g.d0);
  for (int e = threadIdx.x; e < a.N0 * kTile; e += blockDim.x) d0sum[e] += d0[e];
  dense_back(a.w0ht, g.d0, a.N0, 3 * a.R, g.gu, nullptr, false, true);
}

size_t grad_features(const Args& a) {
  return 11 * (size_t)(3 * a.R) + 2 * (size_t)a.N0 + 3 * (size_t)a.dmax;
}

// Shared memory: the Grad buffers (zh, u2..u4, gz, gacc, gk1..gk3, gout, gu
// [3R]; d0, d0sum [N0]; da, db, dc [widest deep layer]), then the stash.  The
// tail is staged over gacc.. (free at the start and at the end).
__global__ void __launch_bounds__(kThreads)
train_backward_kernel(const float* __restrict__ traj, const float* __restrict__ gtraj,
                      const float* __restrict__ ztail, const float* __restrict__ gstats,
                      Args a, float* __restrict__ g_zhead, float* __restrict__ g_ztail,
                      float* __restrict__ partials) {
  extern __shared__ float4 smem[];
  const int W3 = 3 * a.R, B = a.B;
  const int row0 = blockIdx.x * kTile;
  const int valid = min(kTile, B - row0);
  const int tid = threadIdx.x;
  float* slice = partials + (size_t)blockIdx.x * a.n_grad;
  const int dmax = a.dmax;

  Grad g;
  float4* p = smem;
  float4** w3[] = {&g.zh, &g.u2, &g.u3, &g.u4, &g.gz, &g.gacc, &g.gk1, &g.gk2, &g.gk3,
                   &g.gout, &g.gu};
  for (float4** b : w3) { *b = p; p += W3 * kG; }
  g.d0 = p;    p += a.N0 * kG;
  g.d0sum = p; p += a.N0 * kG;
  g.da = p;    p += dmax * kG;
  g.db = p;    p += dmax * kG;
  g.dc = p;    p += dmax * kG;
  float4* tail = g.gacc;                  // 6 * 3R features free up to gu
  if (a.DT > 6 * W3) { tail = p; p += a.DT * kG; }
  Stash st;
  carve_stash(a, p, st);
  const float fa_w = *a.fa_w;
  float gs[5];
  for (int q = 0; q < 5; ++q) gs[q] = gstats[q];

  for (size_t e = tid; e < a.n_grad; e += blockDim.x) slice[e] = 0.f;
  float* d0sum = reinterpret_cast<float*>(g.d0sum);
  for (int e = tid; e < a.N0 * kTile; e += blockDim.x) d0sum[e] = 0.f;
  load_tile(ztail, B, a.DT, row0, tail);
  load_tile(gtraj + (size_t)(a.T - 1) * B * W3, B, W3, row0, g.gz);
  __syncthreads();
  dense(a.w0t, a.b0, nullptr, tail, a.DT, a.N0, st.ct, nullptr, 0, false, false);

  const int n = W3 * kTile;
  float* zh = reinterpret_cast<float*>(g.zh);
  float* u2 = reinterpret_cast<float*>(g.u2);
  float* u3 = reinterpret_cast<float*>(g.u3);
  float* u4 = reinterpret_cast<float*>(g.u4);
  float* gz = reinterpret_cast<float*>(g.gz);
  float* gacc = reinterpret_cast<float*>(g.gacc);
  float* gk1 = reinterpret_cast<float*>(g.gk1);
  float* gk2 = reinterpret_cast<float*>(g.gk2);
  float* gk3 = reinterpret_cast<float*>(g.gk3);
  float* gout = reinterpret_cast<float*>(g.gout);
  const float* gu = reinterpret_cast<const float*>(g.gu);
  const float third = 1.f / 3.f;
  float faw_acc = 0.f;
  for (int i = a.T - 2; i >= 0; --i) {
    const float dt = a.dts[i], m = a.tmask[i];
    load_tile(traj + (size_t)i * B * W3, B, W3, row0, g.zh);
    __syncthreads();
    // the stages, recomputed from the stored state (k1..k3 in gk1..gk3)
    rhs_eval(a, st, g.zh, g.gk1, fa_w, m, valid, nullptr);
    for (int e = tid; e < n; e += blockDim.x) u2[e] = zh[e] + dt * gk1[e] * third;
    __syncthreads();
    rhs_eval(a, st, g.u2, g.gk2, fa_w, m, valid, nullptr);
    for (int e = tid; e < n; e += blockDim.x) u3[e] = zh[e] + dt * (gk2[e] - gk1[e] * third);
    __syncthreads();
    rhs_eval(a, st, g.u3, g.gk3, fa_w, m, valid, nullptr);
    for (int e = tid; e < n; e += blockDim.x) {
      u4[e] = zh[e] + dt * (gk1[e] - gk2[e] + gk3[e]);
      const float c = gz[e];
      gk1[e] = c * (dt * 0.125f);
      gk2[e] = c * (dt * 0.375f);
      gk3[e] = c * (dt * 0.375f);
      gout[e] = c * (dt * 0.125f);
      gacc[e] = c;
    }
    __syncthreads();
    rhs_vjp(a, st, g, g.u4, fa_w, m, gs, valid, slice, faw_acc);
    for (int e = tid; e < n; e += blockDim.x) {
      gacc[e] += gu[e];
      gk1[e] += dt * gu[e];
      gk2[e] -= dt * gu[e];
      gk3[e] += dt * gu[e];
      gout[e] = gk3[e];
    }
    __syncthreads();
    rhs_vjp(a, st, g, g.u3, fa_w, m, gs, valid, slice, faw_acc);
    for (int e = tid; e < n; e += blockDim.x) {
      gacc[e] += gu[e];
      gk2[e] += dt * gu[e];
      gk1[e] -= dt * gu[e] * third;
      gout[e] = gk2[e];
    }
    __syncthreads();
    rhs_vjp(a, st, g, g.u2, fa_w, m, gs, valid, slice, faw_acc);
    for (int e = tid; e < n; e += blockDim.x) {
      gacc[e] += gu[e];
      gk1[e] += dt * gu[e] * third;
      gout[e] = gk1[e];
    }
    __syncthreads();
    rhs_vjp(a, st, g, g.zh, fa_w, m, gs, valid, slice, faw_acc);
    for (int e = tid; e < n; e += blockDim.x) gacc[e] += gu[e];
    __syncthreads();
    load_tile(gtraj + (size_t)i * B * W3, B, W3, row0, g.gout);
    __syncthreads();
    for (int e = tid; e < n; e += blockDim.x) gz[e] = gacc[e] + gout[e];
    __syncthreads();
  }
  store_tile(g.gz, B, W3, row0, g_zhead);

  // the tail's terms, from the first layer's cotangent summed over every
  // evaluation: g_tail = d0sum @ W0t^T, g_W0t += tail^T d0sum, g_b0 += sums
  load_tile(ztail, B, a.DT, row0, tail);
  __syncthreads();
  weight_grad(tail, a.DT, g.d0sum, a.N0, slice + a.g_w0t, slice + a.g_b0);
  __syncthreads();
  dense_back(a.w0tt, g.d0sum, a.N0, a.DT, tail, nullptr, false, false);
  store_tile(tail, B, a.DT, row0, g_ztail);
  __syncthreads();
  // blockDim floats from the start of shared memory (>= 38 * kTile floats)
  block_sum(&faw_acc, 1, reinterpret_cast<float*>(smem), slice + a.g_faw);
}

// Host side -------------------------------------------------------------------

void fill_net(Net& net, int n, const int* outs, const void* const* w,
              const void* const* wt, const void* const* b) {
  net.n = n;
  for (int d = 0; d < n; ++d) {
    net.out[d] = outs[d];
    net.w[d] = static_cast<const float*>(w[d]);
    net.wt[d] = wt != nullptr ? static_cast<const float*>(wt[d]) : nullptr;
    net.b[d] = static_cast<const float*>(b[d]);
  }
}

int fill_args(Args& a, int B, int T, const float* dts, const float* tmask,
              const float* fa_w, int R, int DT, int N0, int n0_fp, const void* w0h,
              const void* w0t, const void* b0, int n_fp, const int* fp_out,
              const void* const* fp_w, const void* const* fp_wt, const void* const* fp_b,
              int n_aug, const int* aug_out, const void* const* aug_w,
              const void* const* aug_wt, const void* const* aug_b) {
  if (B < 1 || T < 1 || R < 1 || DT < 0 || N0 < 1 || n_fp < 0 || n_fp > kMaxDeep ||
      n_aug < 0 || n_aug > kMaxDeep || (n_fp > 0) != (n0_fp > 0) ||
      (n_aug > 0) != (N0 > n0_fp))
    return cudaErrorInvalidValue;
  a = Args{};
  a.B = B; a.T = T; a.R = R; a.DT = DT; a.N0 = N0; a.n0_fp = n0_fp;
  a.w0h = static_cast<const float*>(w0h);
  a.w0t = static_cast<const float*>(w0t);
  a.b0 = static_cast<const float*>(b0);
  a.dts = dts; a.tmask = tmask; a.fa_w = fa_w;
  fill_net(a.fp, n_fp, fp_out, fp_w, fp_wt, fp_b);
  fill_net(a.aug, n_aug, aug_out, aug_w, aug_wt, aug_b);
  a.dmax = 1;
  for (int d = 0; d < n_fp; ++d) a.dmax = fp_out[d] > a.dmax ? fp_out[d] : a.dmax;
  for (int d = 0; d < n_aug; ++d) a.dmax = aug_out[d] > a.dmax ? aug_out[d] : a.dmax;
  // the cotangent slice: w0h, w0t, b0, each deep layer's (w, b), fa_w
  size_t off = 0;
  a.g_w0h = off; off += (size_t)3 * R * N0;
  a.g_w0t = off; off += (size_t)DT * N0;
  a.g_b0 = off;  off += N0;
  int in = n0_fp;
  for (int d = 0; d < n_fp; ++d) {
    a.fp.gw[d] = off; off += (size_t)in * fp_out[d];
    a.fp.gb[d] = off; off += fp_out[d];
    in = fp_out[d];
  }
  in = N0 - n0_fp;
  for (int d = 0; d < n_aug; ++d) {
    a.aug.gw[d] = off; off += (size_t)in * aug_out[d];
    a.aug.gb[d] = off; off += aug_out[d];
    in = aug_out[d];
  }
  a.g_faw = off; off += kStats;
  a.n_grad = off;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of one block's cotangent slice in fused_train_backward's partials
// (layout: w0h, w0t, b0, each fp layer's w then b, each aug layer's, then
// fa_w padded to 8), for the wrapper to allocate and split.
long long fused_train_grad_floats(int R, int DT, int N0, int n0_fp, int n_fp,
                                  const int* fp_out, int n_aug, const int* aug_out) {
  long long n = (long long)3 * R * N0 + (long long)DT * N0 + N0;
  int in = n0_fp;
  for (int d = 0; d < n_fp; ++d) { n += (long long)in * fp_out[d] + fp_out[d]; in = fp_out[d]; }
  in = N0 - n0_fp;
  for (int d = 0; d < n_aug; ++d) { n += (long long)in * aug_out[d] + aug_out[d]; in = aug_out[d]; }
  return n + kStats;
}

int fused_train_blocks(int B) { return (B + kTile - 1) / kTile; }

// K5.  zh0 (B, 3R) region-major head; ztail (B, DT); dts, tmask (T-1) and
// fa_w (scalar) on the device; weights (in, out).  Writes traj (T, B, 3R) and
// stats (blocks, 8): per block sum(beta - 0.8), sum(gamma - 0.55), the two
// sums of squares, sum(Fa^2).  Launches on `stream`; returns
// cudaGetLastError().
int fused_train_forward(const float* zh0, const float* ztail, int B, int T,
                        const float* dts, const float* tmask, const float* fa_w, int R,
                        int DT, int N0, int n0_fp, const void* w0h, const void* w0t,
                        const void* b0, int n_fp, const int* fp_out,
                        const void* const* fp_w, const void* const* fp_b, int n_aug,
                        const int* aug_out, const void* const* aug_w,
                        const void* const* aug_b, float* traj, float* stats,
                        void* stream) {
  Args a;
  int err = fill_args(a, B, T, dts, tmask, fa_w, R, DT, N0, n0_fp, w0h, w0t, b0, n_fp,
                      fp_out, fp_w, nullptr, fp_b, n_aug, aug_out, aug_w, nullptr, aug_b);
  if (err != cudaSuccess) return err;
  const size_t W3 = 3 * (size_t)R;
  const size_t stages = (size_t)DT > 4 * W3 ? (size_t)DT : 4 * W3;
  size_t feats = 2 * W3 + stages + stash_features(a);
  const size_t red = (5 * kThreads + kTile - 1) / kTile;   // block_sum's buffer
  if (stages < red) feats += red - stages;
  const size_t smem = feats * kTile * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(train_forward_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  train_forward_kernel<<<fused_train_blocks(B), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(zh0, ztail, a, traj, stats);
  return cudaGetLastError();
}

// K6.  traj (T, B, 3R) from K5, gtraj its cotangent, ztail (B, DT), gstats (5)
// the cotangents of the five statistics; weights (in, out) and their
// transposes (out, in), w0ht (N0, 3R), w0tt (N0, DT).  Writes g_zhead
// (B, 3R), g_ztail (B, DT) and partials (blocks, fused_train_grad_floats):
// each block's share of every weight cotangent, summed by the caller.
int fused_train_backward(const float* traj, const float* gtraj, const float* ztail,
                         int B, int T, const float* dts, const float* tmask,
                         const float* fa_w, const float* gstats, int R, int DT, int N0,
                         int n0_fp, const void* w0h, const void* w0t, const void* b0,
                         const void* w0ht, const void* w0tt, int n_fp, const int* fp_out,
                         const void* const* fp_w, const void* const* fp_wt,
                         const void* const* fp_b, int n_aug, const int* aug_out,
                         const void* const* aug_w, const void* const* aug_wt,
                         const void* const* aug_b, float* g_zhead, float* g_ztail,
                         float* partials, void* stream) {
  Args a;
  int err = fill_args(a, B, T, dts, tmask, fa_w, R, DT, N0, n0_fp, w0h, w0t, b0, n_fp,
                      fp_out, fp_w, fp_wt, fp_b, n_aug, aug_out, aug_w, aug_wt, aug_b);
  if (err != cudaSuccess) return err;
  a.w0ht = static_cast<const float*>(w0ht);
  a.w0tt = static_cast<const float*>(w0tt);
  size_t feats = grad_features(a) + stash_features(a);
  if ((size_t)DT > 6 * 3 * (size_t)R) feats += DT;
  const size_t smem = feats * kTile * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(train_backward_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  train_backward_kernel<<<fused_train_blocks(B), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      traj, gtraj, ztail, gstats, a, g_zhead, g_ztail, partials);
  return cudaGetLastError();
}

}  // extern "C"
