// RK4(3/8) training trajectory of the UDE field, forward and hand-written
// backward, for Hopper (sm_90a): kernels K5 and K6 of the training path, in
// stats mode and in aux-streaming mode.
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
// the inputs, and contracted into the weight cotangents).
//
// What the design does about it:
//  * one block per tile of kTile = 16 ensemble rows (128 blocks at B = 2048),
//    the ragged last tile masked (its rows contribute nothing to the sums);
//  * state, stages and activations stay in shared memory, feature-major
//    ([feature][row]); the backward keeps every layer's pre- and
//    post-activation (~210 KB a block at the `state` config), the forward
//    only what the next layer reads: zh, zs, k1..k3 (k4 folds into the
//    step's update), the tail, ct, the first layer's output, two ping-pong
//    halves a net and each net's last pre-activation (~110 KB);
//  * the forward (K5, K8) reads its weights from shared memory only,
//    streamed through two stages: an evaluation's passes (the first layer;
//    then layer d of the rates net and of the Fa net on threads of their
//    own) cut into chunks that fit a stage, the next chunk's cp.async copies
//    issued after the barrier that frees its stage, while the current one is
//    used; 512 threads, a thread a tile of 4 rows x 1-8 columns of one
//    product (ops/fused_train.py::forward_plan picks them by a cost model);
//    the SIR combine is fused with the stage update, which also writes the
//    trajectory's rows; the aux streams go to global memory from the last
//    layer's epilogue, coalesced and evict-first;
//  * every sum of the forward starts at its bias (K5's first layer: at its
//    addend ct = b0 + tail @ w0_tail) and adds k = 0, 1, ... in order, one FMA
//    a step, as the backward's recomputation (dense_t) does: no split of k
//    over lanes and no bias added after the sum, so the backward recomputes
//    the forward's stages bit for bit and a state freezes at the same stage
//    in both (the freeze bounds make a float32 trajectory discontinuous);
//  * the frozen tail's first-layer term is computed once (K5);
//  * the backward reads transposed copies of the weights ((out, in)), so the
//    threads of a warp read consecutive addresses in both directions;
//  * the statistics are accumulated per thread over the whole trajectory and
//    reduced once per block, in a fixed order.
//
// The backward (K6, and K9 below) runs in two parts.  The reverse sweep's
// products issue several steps' weight loads before their FMAs (kAheadFor:
// a step waited ~400 cycles for its weights from L2).  The sweep forms no
// weight cotangent: at every evaluation it writes the layer
// inputs (the state, each net's part of the first layer's output, each inner
// layer's output) and the pre-activation cotangents (the first layer's, each
// deep layer's) of its rows to a workspace in global memory, coalesced and
// evict-first, (E, Bp, F) floats, F = 972 at the `state` config (222 MB at
// B = 2048, E = 28).  One grouped contraction launch then forms every weight
// and bias cotangent as X^T D over the E x B rows: a CTA a (matrix, 64 x 64
// output tile, evaluation), 4 x 4 outputs a thread, float32 FMAs in row
// order; a second small launch adds each output's evaluations in order.  The
// TPU kernel adds its cotangents per tile in VMEM (pallas_train.py:504-547);
// a block of the card could hold 16 rows' worth beside the sweep's live set,
// and adding them into a global slice a block at every evaluation cost K6
// 1.0 ms and K9 8.2 ms (scripts/port_train_times.py --probe).  The frozen
// tail's terms come from the first layer's cotangent summed over every
// evaluation (kept in shared memory, d0sum): the tail's cotangent at the end
// of the sweep, the tail weights' and the first bias's in the contraction.
// No float atomics anywhere: the same bits on every run.  The plan (rows a
// block, threads, shared memory, the workspace's segments, the contraction's
// jobs, tiles and chunks) is ops/fused_train.py::backward_plan, the only
// planner; the launchers check what the kernels rely on and refuse the rest.
// All arithmetic is float32.  The kernels allocate nothing.
//
// Aux-streaming mode (stats_mode=False in the JAX package, its default;
// pallas_train.py:228-252,298-323,396-415,425-477) is the same two kernels
// under the run-time switch Args::stream_aux: instead of the five sums, the
// forward writes every evaluation's |rates| (E, B, 2R) and Fa (E, B, 3R),
// E = 4(T-1), evaluation e = 4 * step + stage, to global memory (the rates
// before the freeze mask and for frozen rows too), and the backward reads
// their cotangents, a tile an evaluation, where stats mode rebuilds them from
// the sums' cotangents; tmask is the loss's.  The forward stores each
// output from the thread that formed it (a warp's lanes on consecutive
// columns of a row: coalesced); the backward loads a tile's 16 rows, one
// contiguous run of global memory, into shared memory feature-major.
//
// K8 and K9, the Bayes families' training trajectory, are the same kernels
// under the compile-time switch kBayes.  They replace
// fiude_tpu/ops/pallas_bayes_train.py::_get_bayes_train_traj.fwd_impl (K8,
// _make_fwd_kernel, pallas_bayes_train.py:113-274) and ::bwd_impl (K9,
// _make_bwd_kernel, :281-598) in both modes: K5/K6's math on effective
// weights w(e) = mean + z(e) * |std| that differ on every RHS evaluation e.
// The weights are not drawn here: fused_bayes_draw (csrc/fused_bayes.cu)
// writes w(e), its transposes and z(e) for every evaluation to global memory
// once for all blocks (the noise is shared by every row), and evaluation e
// reads its arrays P * e floats past evaluation 0's.  What changes with
// kBayes:
//  * the frozen tail's first-layer term is recomputed on every evaluation
//    (the first layer is resampled), so the tail keeps its own shared buffer;
//    K8's first pass runs over [tail | head], DT + 3R deep from the bias,
//    the rows of w0_tail then w0_head: the sums of ct, then h0, in one chain;
//  * the sweep adds the tail's cotangent into the rows the block owns on
//    every evaluation, with that evaluation's weights;
//  * the contraction forms each evaluation's cotangents G(e) = X(e)^T D(e)
//    apart (a CTA an evaluation), the tail weights' with ztail and D0(e),
//    and writes G(e) and z(e) * G(e) (z(e) read once a tile) for the
//    cotangents of the packed means and |stds|: g_mean = sum_e G(e),
//    g_stdabs = sum_e z(e) * G(e) (it cannot be formed from the summed
//    g_mean); the sign of std is autograd's, outside the kernel;
//  * no per-block copy of any weight: the Bayes backward uses the shared
//    memory of K6 less the summed first-layer cotangent plus the tail
//    (216,320 bytes a block at the `state` config, K6 208,832).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// The forward's dynamic shared memory, named at file scope so that every
// access through it compiles to a shared-memory instruction.
extern __shared__ __align__(16) unsigned char fwd_smem[];

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
  size_t gw[kMaxDeep], gb[kMaxDeep];   // the packed offsets of its (w, b)
};

// The backward's workspace (ops/fused_train.py::backward_plan, checked by the
// launcher), which the sweep writes every evaluation's layer inputs and
// pre-activation cotangents to: float offsets of the segments in a row of F
// floats, rows padded to Bp.
struct Sweep {
  int Bp, F, N0p;
  int u, h0fp, h0aug, d0;                     // segments
  int fp_post[kMaxDeep], aug_post[kMaxDeep], fp_d[kMaxDeep], aug_d[kMaxDeep];
  float* ws;       // (E, Bp, F), then K6's summed first-layer cotangent (Bp, N0p)
  float* faw;      // (blocks, kStats): each block's share of fa_w's cotangent
};

// With kBayes every weight pointer is that of evaluation 0 in a buffer of
// effective weights (E, P) (the transposes likewise), at the arrays' packed
// offsets.
struct Args {
  size_t P;            // floats of one evaluation's packed weights
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
  size_t g_w0h, g_w0t, g_b0;   // packed offsets
  // aux-streaming mode (stream_aux): no statistics and no tmask; the forward
  // writes every evaluation's aux, the backward reads its cotangents (either
  // may be absent: a family without that net, or a loss that never read it)
  int stream_aux;
  float* rates_out;      // (E, B, 2R) |rates| of evaluation e = 4 * step + stage
  float* fa_out;         // (E, B, 3R)
  const float* g_rates;  // (E, B, 2R)
  const float* g_fa;     // (E, B, 3R)
  Sweep sw;              // the backward's plan and workspace
};

// Per-net activation buffers: pre[d] for every layer after the first,
// post[d] (what layer d+1 reads) for all but the last.
struct Acts {
  float4* pre[kMaxDeep];
  float4* post[kMaxDeep];
};

struct Stash {
  float4 *tail;        // the frozen tail, kept for every evaluation (kBayes only)
  float4 *ct, *h0pre, *h0post;
  Acts fp, aug;
};

// ELU without a branch (the same values, -0 and NaN included): every lane
// evaluates expm1f, so a tile's values do not diverge one by one.
__device__ __forceinline__ float eluf(float x) {
  const float em = expm1f(x > 0.f ? 0.f : x);
  return x > 0.f ? x : em;
}

// d/dh elu(h) as the JAX kernel writes it (pallas_train.py:100-102)
__device__ __forceinline__ float elu_grad(float h) { return h > 0.f ? 1.f : expf(fminf(h, 0.f)); }

__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.f) - (x < 0.f)); }

__device__ __forceinline__ bool frozen(float x) { return x > 2.f || x < -1.f; }

__device__ __forceinline__ float4 splat(float v) { return make_float4(v, v, v, v); }

__device__ __forceinline__ void fma4(float4& acc, const float4& x, float w) {
  acc.x += x.x * w; acc.y += x.y * w; acc.z += x.z * w; acc.w += x.w * w;
}

// ---- the backward's products (and K5's ct, once a launch) ---------------------
//
// A product out[col][rows] = sum_k x[k][rows] * W[k * ldw + col] over the
// tile's 16 rows: a thread an output column of 4 rows (one weight and one
// 16-byte load of activations a step), each thread issuing the loads of
// kAhead steps of its sum before their FMAs.  A step's weights come from L2
// (~400 cycles): issued a step at a time, every step waited for them
// (scripts/port_train_times.py --probe: 350-650 cycles a step in every
// product).  The sum's order is the steps' order either way.  kAhead is
// measured per kernel: 8 for K6; 1 for K9, whose evaluations each read new
// weights and whose deeper loops ran slower.  Register tiles of 4 rows x 4
// columns on split lanes were no faster in either kernel and are not kept
// (PERF.md, Findings).  The weights come through L1 at
// any alignment: K9 reads them at their packed offsets in the draw's buffer.
template <bool kBayes>
constexpr int kAheadFor = kBayes ? 1 : 8;

// Column col's sum for the 4 rows of group g starts at init(col, g), as the
// forward's sums start at their bias or addend: with the same FMAs in the same
// order (k = 0, 1, ...), the backward's recomputed stages are the forward's
// bit for bit, so a state freezes at the same stage in both.  `epi(col, g, v)`
// gets the 4 sums.  No barrier.
template <int kAhead, class Init, class Epi>
__device__ __forceinline__ void product(const float4* x, const float* __restrict__ W, int ldw,
                                        int K, int N, Init init, Epi epi) {
  for (int it = threadIdx.x; it < N * kG; it += blockDim.x) {
    const int j = it % N, g = it / N;
    float4 acc = init(j, g);
    int k = 0;
    for (; k + kAhead <= K; k += kAhead) {
      float w[kAhead];
      float4 xv[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        w[u] = __ldg(W + (size_t)(k + u) * ldw + j);
        xv[u] = x[(k + u) * kG + g];
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) fma4(acc, xv[u], w[u]);
    }
    for (; k < K; ++k) fma4(acc, x[k * kG + g], __ldg(W + (size_t)k * ldw + j));
    const float v[4] = {acc.x, acc.y, acc.z, acc.w};
    epi(j, g, v);
  }
}

__device__ __forceinline__ float4 elu4(float4 v) {
  return make_float4(eluf(v.x), eluf(v.y), eluf(v.z), eluf(v.w));
}

// pre = in @ W + (addend ? addend : bias); post (if given) = ELU(pre) on the
// columns < split when act_lo and >= split when act_hi, pre elsewhere.  Ends
// with a barrier.
template <int kAhead>
__device__ void dense_t(const float* __restrict__ W, const float* __restrict__ bias,
                        const float4* addend, const float4* in, int K, int N, float4* pre,
                        float4* post, int split, bool act_lo, bool act_hi) {
  product<kAhead>(in, W, N, K, N, [&](int col, int rg) {
    return addend ? addend[col * kG + rg] : splat(__ldg(bias + col));
  }, [&](int col, int rg, const float (&v)[4]) {
    const float4 o = make_float4(v[0], v[1], v[2], v[3]);
    pre[col * kG + rg] = o;
    if (post) post[col * kG + rg] = (col < split ? act_lo : act_hi) ? elu4(o) : o;
  });
  __syncthreads();
}

// out (+)= (delta @ W^T) [* elu'(pre) when act], Wt (N, K) = W^T row-major,
// with the backward's products.  Ends with a barrier.
template <int kAhead>
__device__ void dense_back_t(const float* __restrict__ Wt, const float4* delta, int N, int K,
                             float4* out, const float4* pre, bool act, bool accumulate) {
  product<kAhead>(delta, Wt, K, N, K, [](int, int) { return splat(0.f); },
                  [&](int col, int rg, const float (&v)[4]) {
    float4 o = make_float4(v[0], v[1], v[2], v[3]);
    if (act) {
      const float4 h = pre[col * kG + rg];
      o.x *= elu_grad(h.x); o.y *= elu_grad(h.y); o.z *= elu_grad(h.z); o.w *= elu_grad(h.w);
    }
    if (accumulate) {
      const float4 p = out[col * kG + rg];
      o.x += p.x; o.y += p.y; o.z += p.z; o.w += p.w;
    }
    out[col * kG + rg] = o;
  });
  __syncthreads();
}

// out (B, K) rows row0.. += delta @ W^T for the tile's valid rows, Wt (N, K):
// the tail's cotangent, accumulated over evaluations in the rows this block
// owns (kBayes).  Each element has one owner thread.  No barrier.
template <int kAhead>
__device__ void dense_back_rows_t(const float* __restrict__ Wt, const float4* delta, int N, int K,
                                  float* __restrict__ out, int row0, int valid) {
  product<kAhead>(delta, Wt, K, N, K, [](int, int) { return splat(0.f); },
                  [&](int col, int rg, const float (&v)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (4 * rg + r < valid) out[(size_t)(row0 + 4 * rg + r) * K + col] += v[r];
  });
}

// A net's layers after the first, reading `in` (width K), pre/post-activations
// into `acts`.  Layer d's output is ELU'd for layer d+1 when d < n-2.
template <int kAhead>
__device__ void net_forward(const Net& net, size_t woff, const float4* in, int K,
                            const Acts& acts) {
  for (int d = 0; d < net.n; ++d) {
    const bool last = d == net.n - 1;
    dense_t<kAhead>(net.w[d] + woff, net.b[d] + woff, nullptr, in, K, net.out[d], acts.pre[d],
                    last ? nullptr : acts.post[d], net.out[d], d < net.n - 2, false);
    in = acts.post[d];
    K = net.out[d];
  }
}

// The backward's recomputation of one RHS evaluation at zs, keeping every
// activation in `st`; with `field`, also writes the field.  `e` is the
// evaluation's index: with kBayes its weights, and the tail's first-layer
// term recomputed from them.  Ends with a barrier.
template <bool kBayes>
__device__ void rhs_eval(const Args& a, const Stash& st, const float4* zs, float4* field,
                         float fa_w, int e) {
  const bool mech = a.n0_fp > 0, has_aug = a.aug.n > 0;
  const size_t woff = kBayes ? a.P * (size_t)e : 0;
  constexpr int kAhead = kAheadFor<kBayes>;
  if (kBayes)
    dense_t<kAhead>(a.w0t + woff, a.b0 + woff, nullptr, st.tail, a.DT, a.N0, st.ct, nullptr, 0,
                    false, false);
  dense_t<kAhead>(a.w0h + woff, nullptr, st.ct, zs, 3 * a.R, a.N0, st.h0pre, st.h0post,
                  a.n0_fp, a.fp.n >= 2, a.aug.n >= 2);
  if (mech) net_forward<kAhead>(a.fp, woff, st.h0post, a.n0_fp, st.fp);
  if (has_aug)
    net_forward<kAhead>(a.aug, woff, st.h0post + a.n0_fp * kG, a.N0 - a.n0_fp, st.aug);
  if (field == nullptr) return;

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

// Store a [W][kTile] buffer into rows row0.. of a (B, W) matrix, none past B.
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
// K5 / K8: the forward (ops/fused_train.py::forward_plan, read by
// read_forward_plan).  A block of kFThreads threads takes kTile rows; an RHS
// evaluation runs as passes (the first layer, then layer d of both nets on
// threads of their own), then the SIR combine fused with the stage update.
// Every sum starts at its bias (K5's first layer: at its addend ct) and adds
// k = 0, 1, .. in order with one FMA a step, as dense_t's do: the backward
// recomputes these stages bit for bit.  The weights are read from shared
// memory only, streamed through two stages: a pass's rows in chunks, the next
// chunk's cp.async copies issued after the barrier that frees its stage.
// ---------------------------------------------------------------------------
constexpr int kFThreads = 512;
constexpr int kFMaxSteps = kMaxDeep + 1;
constexpr int kFMaxChunks = 32;
constexpr int kFArgsBytes = 3072;   // the plan and the arguments, copied ahead of the tile
enum FwdKind { kFFirst, kFFp, kFAug };

struct FJob { int kind, layer, K, N, cols, t0, nt, ldw; };
struct FStep { int n_jobs; FJob job[2]; };
struct FChunk { int step, k0[2], k1[2], off[2], boff[2]; };   // boff: a bias row, or -1
struct FPlan {        // only ints: copied into shared memory word by word
  int smem, stage_bytes;
  int zh, tail, zs, kbuf, ct, h0, fpb, augb, rates, fa, wts;   // byte offsets
  int n_steps, n_chunks;
  int fph, augh;                // bytes of a ping-pong half (derived from the widths)
  FStep step[kFMaxSteps];
  FChunk chunk[kFMaxChunks];
  int chunk0[kFMaxSteps + 1];   // an evaluation's first chunk of each pass (derived)
};
static_assert(sizeof(FPlan) % 16 == 0 && sizeof(Args) % 4 == 0 &&
              sizeof(FPlan) + sizeof(Args) <= kFArgsBytes, "kFArgsBytes");

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A row's `bytes` from `s` to `d` by one warp in units of kUnit bytes; the
// last unit may reach past the row's last byte (up to the next kUnit boundary).
template <int kUnit>
__device__ __forceinline__ void copy_units(unsigned char* d, const unsigned char* s, int bytes,
                                           int lane) {
  for (int i = lane * kUnit; i < bytes; i += 32 * kUnit) cp_async(d + i, s + i, kUnit);
}

// One float row of n floats from global `src` to shared `dst` by one warp, in
// the widest of 16-, 8- and 4-byte units the row's address allows; a
// matrix's last row (`last`) in 4-byte units, so that no copy reads past it.
__device__ __forceinline__ void copy_row(unsigned char* dst, const float* src, int n, bool last,
                                         int lane) {
  const uintptr_t a = (uintptr_t)src;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  if ((a & 15) == 0 && !last)
    copy_units<16>(dst, s, 4 * n, lane);
  else if ((a & 7) == 0 && !last)
    copy_units<8>(dst, s, 4 * n, lane);
  else
    copy_units<4>(dst, s, 4 * n, lane);
}

template <bool kBayes>
struct Fwd {
  const Args& a;
  const FPlan& p;
  int row0, B, valid;

  __device__ float4* buf(int off) const { return reinterpret_cast<float4*>(fwd_smem + off); }

  __device__ const Net& net(int kind) const { return kind == kFFp ? a.fp : a.aug; }

  __device__ unsigned char* stage(int g) const { return fwd_smem + p.wts + (g & 1) * p.stage_bytes; }

  // Row k of job j's weights for evaluation e (K8: P * e floats further on;
  // its first layer's rows are w0_tail's, then w0_head's); `last` when it is
  // its matrix's last row.
  __device__ const float* weight_row(const FJob& j, int e, int k, bool& last) const {
    const size_t woff = kBayes ? a.P * (size_t)e : 0;
    if (j.kind == kFFirst) {
      if (kBayes && k < a.DT) {
        last = k == a.DT - 1;
        return a.w0t + woff + (size_t)k * j.N;
      }
      const int kh = kBayes ? k - a.DT : k;
      last = k == j.K - 1;
      return a.w0h + woff + (size_t)kh * j.N;
    }
    last = k == j.K - 1;
    return net(j.kind).w[j.layer] + woff + (size_t)k * j.N;
  }

  // Issue the copies of chunk c of evaluation e into the stage of global chunk
  // g: one warp a row; a pass's first chunk also holds its products' bias rows.
  __device__ void copy_chunk(int c, int e, int g) const {
    const FChunk& ch = p.chunk[c];
    const FStep& sp = p.step[ch.step];
    unsigned char* base = stage(g);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int r = warp;
    for (int jx = 0; jx < sp.n_jobs; ++jx) {
      const FJob& j = sp.job[jx];
      const int n = ch.k1[jx] - ch.k0[jx];
      for (; r < n; r += kFThreads / 32) {
        bool last;
        const float* src = weight_row(j, e, ch.k0[jx] + r, last);
        copy_row(base + ch.off[jx] + (size_t)r * j.ldw * 4, src, j.N, last, lane);
      }
      r -= n;
      if (ch.boff[jx] >= 0 && warp == kFThreads / 32 - 1 - jx)
        copy_row(base + ch.boff[jx], bias(j, e), j.N, true, lane);
    }
  }

  // Job j's bias for evaluation e (K8: P * e floats further on).
  __device__ const float* bias(const FJob& j, int e) const {
    const size_t woff = kBayes ? a.P * (size_t)e : 0;
    return (j.kind == kFFirst ? a.b0 : net(j.kind).b[j.layer]) + woff;
  }

  // The input activations of a job ([K][4 row groups] float4s).
  __device__ const float4* input(const FJob& j) const {
    if (j.kind == kFFirst) return buf(kBayes ? p.tail : p.zs);
    if (j.layer == 0) return buf(p.h0) + (j.kind == kFFp ? 0 : a.n0_fp * kG);
    return half(j.kind, j.layer - 1);
  }

  // The ping-pong half that layer d of a net writes (when not its last) and
  // layer d + 1 reads.
  __device__ float4* half(int kind, int d) const {
    return buf(kind == kFFp ? p.fpb + (d & 1) * p.fph : p.augb + (d & 1) * p.augh);
  }

  // acc[r][q] += x[k] (row 4 rg + r) * W[k][c0 + q] for k in [kb, ke), one
  // FMA a step in k's order, kUnroll steps' loads issued before their FMAs.
  // W's row k at w + (k - kb) * ldw floats.
  template <int kC>
  __device__ __forceinline__ static void accumulate(float (&acc)[4][8], const float4* x,
                                                    const float* w, int ldw, int kb, int ke) {
    constexpr int kUnroll = 4;
    int k = kb;
    for (; k + kUnroll <= ke; k += kUnroll) {
      float4 xv[kUnroll];
      float wv[kUnroll][kC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xv[u] = x[(k + u) * kG];
        load_cols<kC>(wv[u], w + (size_t)(k + u - kb) * ldw);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fma_tile<kC>(acc, xv[u], wv[u]);
    }
    for (; k < ke; ++k) {
      float wv[kC];
      load_cols<kC>(wv, w + (size_t)(k - kb) * ldw);
      fma_tile<kC>(acc, x[k * kG], wv);
    }
  }

  template <int kC>
  __device__ __forceinline__ static void load_cols(float (&wv)[kC], const float* w) {
    if constexpr (kC == 1) {
      wv[0] = w[0];
    } else if constexpr (kC == 2) {
      const float2 v = *reinterpret_cast<const float2*>(w);
      wv[0] = v.x; wv[1] = v.y;
    } else {
#pragma unroll
      for (int q = 0; q < kC; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(w + q);
        wv[q] = v.x; wv[q + 1] = v.y; wv[q + 2] = v.z; wv[q + 3] = v.w;
      }
    }
  }

  template <int kC>
  __device__ __forceinline__ static void fma_tile(float (&acc)[4][8], const float4& x,
                                                  const float (&wv)[kC]) {
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kC; ++q) acc[r][q] = fmaf(xs[r], wv[q], acc[r][q]);
  }

  // One pass (step s of evaluation e, its chunks from global chunk g on):
  // every chunk starts with a barrier, after which the next chunk's copies go
  // to the other stage.  Returns the global chunk count after the pass.
  __device__ int run_pass(int s, int e, int E, int g) const {
    const FStep& sp = p.step[s];
    const int t = threadIdx.x;
    int jx = -1;
    for (int j = 0; j < sp.n_jobs; ++j)
      if (t >= sp.job[j].t0 && t < sp.job[j].t0 + sp.job[j].nt) jx = j;
    const FJob* j = jx >= 0 ? &sp.job[jx] : nullptr;
    int C = 1, rg = 0, c0 = 0;
    bool active = false;
    if (j != nullptr) {
      C = j->cols;
      const int ncg = (j->N + C - 1) / C, item = t - j->t0;
      active = item < 4 * ncg;
      rg = item / ncg;
      c0 = (item % ncg) * C;
    }
    float acc[4][8];
    const int c_end = p.chunk0[s + 1];
    for (int ci = p.chunk0[s]; ci < c_end; ++ci, ++g) {
      cp_async_wait_all();
      __syncthreads();
      {     // the next chunk: this evaluation's next, or the next one's first
        const int nc = ci + 1 < p.n_chunks ? ci + 1 : 0, ne = ci + 1 < p.n_chunks ? e : e + 1;
        if (ne < E) copy_chunk(nc, ne, g + 1);
      }
      if (!active) continue;
      const FChunk& ch = p.chunk[ci];
      if (ci == p.chunk0[s]) {   // each sum starts at its bias (K5's first layer: its addend)
        const float4* ct = buf(p.ct);
        const float* b = reinterpret_cast<const float*>(stage(g) + ch.boff[jx]);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = c0 + q < j->N ? c0 + q : j->N - 1;
          const float4 v = j->kind == kFFirst && !kBayes ? ct[col * kG + rg] : splat(b[col]);
          acc[0][q] = v.x; acc[1][q] = v.y; acc[2][q] = v.z; acc[3][q] = v.w;
        }
      }
      const float4* x = input(*j) + rg;
      const float* w = reinterpret_cast<const float*>(stage(g) + ch.off[jx]) + c0;
      const int kb = ch.k0[jx], ke = ch.k1[jx];
      switch (C) {
        case 1: accumulate<1>(acc, x, w, j->ldw, kb, ke); break;
        case 2: accumulate<2>(acc, x, w, j->ldw, kb, ke); break;
        case 4: accumulate<4>(acc, x, w, j->ldw, kb, ke); break;
        default: accumulate<8>(acc, x, w, j->ldw, kb, ke); break;
      }
    }
    if (active) finish(*j, acc, rg, c0, e);
    return g;
  }

  // A tile's outputs: ELU'd where the next layer wants them (as dense_t's
  // post), a net's last layer's pre-activations to the rates / Fa buffer and,
  // in aux-streaming mode, straight to their global rows (|rates| before the
  // freeze mask, and for frozen rows too), evict-first.
  __device__ void finish(const FJob& j, const float (&acc)[4][8], int rg, int c0, int e) const {
    const bool first = j.kind == kFFirst;
    const Net& n = net(j.kind);
    const bool last = !first && j.layer == n.n - 1;
    float4* dst = first ? buf(p.h0)
                  : last ? buf(j.kind == kFFp ? p.rates : p.fa) : half(j.kind, j.layer);
    float* aux = last ? (j.kind == kFFp ? a.rates_out : a.fa_out) : nullptr;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = c0 + q;
      if (q >= j.cols || col >= j.N) break;
      const float4 v = make_float4(acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
      const bool act = first ? (col < a.n0_fp ? a.fp.n >= 2 : a.aug.n >= 2)
                             : !last && j.layer < n.n - 2;
      dst[col * kG + rg] = act ? elu4(v) : v;
      if (aux != nullptr) {
        const float vs[4] = {v.x, v.y, v.z, v.w};
        const bool absval = j.kind == kFFp;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = row0 + 4 * rg + r;
          if (row < B) __stcs(aux + ((size_t)e * B + row) * j.N + col, absval ? fabsf(vs[r]) : vs[r]);
        }
      }
    }
  }

  // The field at this stage's input zs from the rates and Fa just computed
  // (rhs_eval's arithmetic), the freeze mask, the statistics (stats mode:
  // weight m, rows < valid), and the Kutta 3/8 stage update in the forward's
  // order: k_stage, the next stage's input zs and, at stage 3, the new state,
  // also written to its row of the trajectory.  A thread a (region, group of
  // 4 rows).
  __device__ void combine(int stage_, int i, float dt, float m, float fa_w, float* stats,
                          float* __restrict__ traj) const {
    const bool mech = a.n0_fp > 0, has_aug = a.aug.n > 0;
    const int W3 = 3 * a.R;
    float* zh = reinterpret_cast<float*>(buf(p.zh));
    float* zs = reinterpret_cast<float*>(buf(p.zs));
    float* k1 = reinterpret_cast<float*>(buf(p.kbuf));
    float* k2 = k1 + W3 * kTile;
    float* k3 = k2 + W3 * kTile;
    const float* rp = reinterpret_cast<const float*>(buf(p.rates));
    const float* fa = reinterpret_cast<const float*>(buf(p.fa));
    const float third = 1.f / 3.f;
    for (int idx = threadIdx.x; idx < a.R * kTile; idx += kFThreads) {
      const int r = idx / kTile, row = idx % kTile;
      const int iS = (3 * r) * kTile + row, iI = iS + kTile, iR = iI + kTile;
      const float z[3] = {zs[iS], zs[iI], zs[iR]};
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
      float f0, f1, f2;
      if (mech) {
        const float plus_i = beta * z[0] * z[1];
        const float minus_i = gamma * z[1];
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
      const float f[3] = {frozen(z[0]) ? 0.f : f0, frozen(z[1]) ? 0.f : f1,
                          frozen(z[2]) ? 0.f : f2};
      const int ix[3] = {iS, iI, iR};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int o = ix[q];
        if (stage_ == 0) {
          k1[o] = f[q];
          zs[o] = zh[o] + dt * f[q] * third;
        } else if (stage_ == 1) {
          k2[o] = f[q];
          zs[o] = zh[o] + dt * (f[q] - k1[o] * third);
        } else if (stage_ == 2) {
          k3[o] = f[q];
          zs[o] = zh[o] + dt * (k1[o] - k2[o] + f[q]);
        } else {
          const float nz = zh[o] + dt * (k1[o] + 3.f * (k2[o] + k3[o]) + f[q]) * 0.125f;
          zh[o] = nz;
          zs[o] = nz;
          if (row0 + row < B) traj[((size_t)(i + 1) * B + row0 + row) * W3 + 3 * r + q] = nz;
        }
      }
    }
  }
};

template <bool kBayes>
__global__ void __launch_bounds__(kFThreads, 1)
train_forward_kernel(const float* __restrict__ zh0, const float* __restrict__ ztail,
                     const __grid_constant__ Args args, const __grid_constant__ FPlan plan,
                     float* __restrict__ traj, float* __restrict__ stats_out) {
  unsigned char* sm = fwd_smem;
  // the plan and the arguments into shared memory (the first kFArgsBytes):
  // read there, an index into them is a shared load
  {
    const int* from[2] = {reinterpret_cast<const int*>(&plan), reinterpret_cast<const int*>(&args)};
    int* to[2] = {reinterpret_cast<int*>(sm), reinterpret_cast<int*>(sm + sizeof(FPlan))};
    const int n[2] = {(int)(sizeof(FPlan) / 4), (int)(sizeof(Args) / 4)};
    for (int h = 0; h < 2; ++h)
      for (int i = threadIdx.x; i < n[h]; i += kFThreads) to[h][i] = from[h][i];
    __syncthreads();
  }
  const FPlan& p = *reinterpret_cast<const FPlan*>(sm);
  const Args& a = *reinterpret_cast<const Args*>(sm + sizeof(FPlan));
  const int W3 = 3 * a.R, B = a.B, row0 = blockIdx.x * kTile;
  const Fwd<kBayes> f{a, p, row0, B, min(kTile, B - row0)};
  float* zh = reinterpret_cast<float*>(sm + p.zh);
  float* zs = reinterpret_cast<float*>(sm + p.zs);
  float* tail = reinterpret_cast<float*>(sm + p.tail);
  for (int idx = threadIdx.x; idx < kTile * W3; idx += kFThreads) {
    const int row = idx / W3, c = idx % W3;
    const bool in = row0 + row < B;
    const float v = in ? zh0[(size_t)(row0 + row) * W3 + c] : 0.f;
    zh[c * kTile + row] = v;
    zs[c * kTile + row] = v;
    if (in) traj[(size_t)(row0 + row) * W3 + c] = v;
  }
  for (int idx = threadIdx.x; idx < kTile * a.DT; idx += kFThreads) {
    const int row = idx / a.DT, c = idx % a.DT;
    tail[c * kTile + row] = row0 + row < B ? ztail[(size_t)(row0 + row) * a.DT + c] : 0.f;
  }
  const int E = 4 * (a.T - 1);
  if (E > 0) f.copy_chunk(0, 0, 0);
  __syncthreads();
  if (!kBayes)     // K5's addend ct = b0 + tail @ w0_tail, once, as the backward forms it
    dense_t<kAheadFor<false>>(a.w0t, a.b0, nullptr, reinterpret_cast<const float4*>(tail), a.DT,
                              a.N0, reinterpret_cast<float4*>(sm + p.ct), nullptr, 0, false,
                              false);

  float acc[kStats] = {};
  float* stats = a.stream_aux ? nullptr : acc;
  const float fa_w = *a.fa_w;
  int g = 0;
  for (int e = 0; e < E; ++e) {
    const int i = e >> 2;
    for (int s = 0; s < p.n_steps; ++s) g = f.run_pass(s, e, E, g);
    __syncthreads();
    f.combine(e & 3, i, a.dts[i], a.stream_aux ? 1.f : a.tmask[i], fa_w, stats, traj);
  }
  if (!a.stream_aux) {
    __syncthreads();      // the last combine done; the stages are free (no copy in flight)
    block_sum(acc, 5, reinterpret_cast<float*>(sm + p.wts), stats_out + (size_t)blockIdx.x * kStats);
  }
}

// ---------------------------------------------------------------------------
// K6 / K9: backward.  The reverse sweep (train_backward_kernel) recomputes
// each step's stages, backpropagates every evaluation to the state and the
// tail, and writes the evaluation's layer inputs and pre-activation
// cotangents to the workspace; the contraction (train_contract_kernel, then
// train_reduce_kernel) forms every weight and bias cotangent from them.
// ---------------------------------------------------------------------------
struct Grad {          // [feature][kTile] buffers of the reverse sweep
  float4 *zh, *u2, *u3, *u4;             // the step's stage inputs
  float4 *gz, *gacc, *gk1, *gk2, *gk3;   // cotangents
  float4 *gout, *gu;                     // one evaluation's VJP: in, out
  float4 *d0, *d0sum;                    // first layer's cotangent; its sum
  float4 *da, *db, *dc;                  // deep-layer cotangents
};

// The block's 16 rows of a row-major matrix (row stride ld, row0's first
// element at dst) from a [W][kTile] buffer: a thread a float4 (one feature, 4
// rows), its 4 rows stored apart, a warp's lanes on consecutive columns.
// Evict-first, as the aux streams: the contraction reads them once.
__device__ void store_rows(const float4* src, int W, float* __restrict__ dst, int ld) {
  for (int it = threadIdx.x; it < W * kG; it += blockDim.x) {
    const int f = it % W, g = it / W;
    const float4 v = src[f * kG + g];
    float* o = dst + (size_t)(4 * g) * ld + f;
    __stcs(o, v.x);
    __stcs(o + ld, v.y);
    __stcs(o + 2 * (size_t)ld, v.z);
    __stcs(o + 3 * (size_t)ld, v.w);
  }
}

// Evaluation e's rows row0.. of a workspace segment.
__device__ __forceinline__ float* ws_rows(const Args& a, int e, int seg, int row0) {
  return a.sw.ws + ((size_t)e * a.sw.Bp + row0) * a.sw.F + seg;
}

// Backprop a net's layers after the first from `delta` (its last layer's
// output cotangent, in buffer `x`), into the first layer's columns
// [c0, c0 + K0) of g.d0; ping-pongs through x and y.  Each layer's cotangent
// goes to evaluation e's segment seg_d[d] of the workspace.
template <int kAhead>
__device__ void net_backward(const Args& a, const Net& net, const Acts& acts, const Stash& st,
                             int c0, int K0, float4* x, float4* y, const Grad& g, size_t woff,
                             const int* seg_d, int e, int row0) {
  float4* delta = x;
  float4* other = y;
  for (int d = net.n - 1; d >= 0; --d) {
    const float4* in_pre = d == 0 ? st.h0pre + c0 * kG : acts.pre[d - 1];
    const int K = d == 0 ? K0 : net.out[d - 1];
    const bool act = d == 0 ? net.n >= 2 : d - 1 < net.n - 2;
    store_rows(delta, net.out[d], ws_rows(a, e, seg_d[d], row0), a.sw.F);
    float4* dst = d == 0 ? g.d0 + c0 * kG : other;
    dense_back_t<kAhead>(net.wt[d] + woff, delta, net.out[d], K, dst, in_pre, act, false);
    other = delta;
    delta = dst;
  }
}

// VJP of one RHS evaluation at u: g.gu = d(field)/du^T g.gout.  In stats mode
// the aux cotangents are m * (g1 + 2 (rate - shift) g2) for the rates and
// m * 2 g_f2 Fa for the Fa field (pallas_train.py:435-445); in aux-streaming
// mode they are evaluation e's tiles of g_rates and g_fa, staged in g.da and
// g.dc (free until the loop below writes the nets' cotangents there), zero
// where a stream is absent.  The freeze mask zeroes the field's cotangent,
// not the state's, and not the aux cotangent: a frozen row's rates and Fa
// still reach the nets.  The evaluation's layer inputs and pre-activation
// cotangents go to the workspace; no weight cotangent is formed here.  K6
// adds the first layer's cotangent to d0sum; K9, whose first layer is new
// every evaluation, adds the tail's cotangent into g_ztail's rows row0...
template <bool kBayes>
__device__ void rhs_vjp(const Args& a, const Stash& st, const Grad& g, const float4* u,
                        float fa_w, float m, const float* gs, int valid, float& faw_acc, int e,
                        float* __restrict__ g_ztail, int row0) {
  const bool mech = a.n0_fp > 0, has_aug = a.aug.n > 0;
  const size_t woff = kBayes ? a.P * (size_t)e : 0;
  const bool aux_rates = a.stream_aux && mech && a.g_rates != nullptr;
  const bool aux_fa = a.stream_aux && has_aug && a.g_fa != nullptr;
  if (aux_rates) load_tile(a.g_rates + (size_t)e * a.B * 2 * a.R, a.B, 2 * a.R, row0, g.da);
  if (aux_fa) load_tile(a.g_fa + (size_t)e * a.B * 3 * a.R, a.B, 3 * a.R, row0, g.dc);
  rhs_eval<kBayes>(a, st, u, nullptr, fa_w, e);  // ends in a barrier

  // the layer inputs: the state, the first layer's output (each net's part),
  // each inner layer's
  const int F = a.sw.F;
  store_rows(u, 3 * a.R, ws_rows(a, e, a.sw.u, row0), F);
  if (mech) {
    store_rows(st.h0post, a.n0_fp, ws_rows(a, e, a.sw.h0fp, row0), F);
    for (int d = 0; d + 1 < a.fp.n; ++d)
      store_rows(st.fp.post[d], a.fp.out[d], ws_rows(a, e, a.sw.fp_post[d], row0), F);
  }
  if (has_aug) {
    store_rows(st.h0post + a.n0_fp * kG, a.N0 - a.n0_fp, ws_rows(a, e, a.sw.h0aug, row0), F);
    for (int d = 0; d + 1 < a.aug.n; ++d)
      store_rows(st.aug.post[d], a.aug.out[d], ws_rows(a, e, a.sw.aug_post[d], row0), F);
  }

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
      if (aux_rates) {
        gbeta += d_rates[(2 * r) * kTile + row];
        ggam += d_rates[(2 * r + 1) * kTile + row];
      } else if (live && !a.stream_aux) {
        gbeta += m * (gs[0] + 2.f * (beta - kShiftBeta) * gs[2]);
        ggam += m * (gs[1] + 2.f * (gamma - kShiftGamma) * gs[3]);
      }
      d_rates[(2 * r) * kTile + row] = sgn(pb) * gbeta;
      d_rates[(2 * r + 1) * kTile + row] = sgn(pg) * ggam;
    }
    if (has_aug) {
      float aS = 0.f, aI = 0.f, aR = 0.f;       // the Fa field's aux cotangent
      if (aux_fa) {
        aS = d_fa[iS]; aI = d_fa[iI]; aR = d_fa[iR];
      } else if (live && !a.stream_aux) {
        const float c = m * (2.f * gs[4]);
        aS = c * fa[iS]; aI = c * fa[iI]; aR = c * fa[iR];
      }
      const float s = mech ? fa_w : 1.f;
      if (mech) faw_acc += gS * fa[iS] + gI * fa[iI] + gR * fa[iR];
      d_fa[iS] = s * gS + aS;
      d_fa[iI] = s * gI + aI;
      d_fa[iR] = s * gR + aR;
    }
    gu[iS] = uS;
    gu[iI] = uI;
    gu[iR] = 0.f;
  }
  __syncthreads();
  constexpr int kAhead = kAheadFor<kBayes>;
  if (mech)
    net_backward<kAhead>(a, a.fp, st.fp, st, 0, a.n0_fp, g.da, g.db, g, woff, a.sw.fp_d, e, row0);
  if (has_aug)
    net_backward<kAhead>(a, a.aug, st.aug, st, a.n0_fp, a.N0 - a.n0_fp, g.dc, g.db, g, woff,
                         a.sw.aug_d, e, row0);
  store_rows(g.d0, a.N0, ws_rows(a, e, a.sw.d0, row0), F);
  if (kBayes) {
    dense_back_rows_t<kAhead>(a.w0tt + woff, g.d0, a.N0, a.DT, g_ztail, row0, valid);
  } else {
    float* d0sum = reinterpret_cast<float*>(g.d0sum);
    const float* d0 = reinterpret_cast<const float*>(g.d0);
    for (int q = threadIdx.x; q < a.N0 * kTile; q += blockDim.x) d0sum[q] += d0[q];
  }
  dense_back_t<kAhead>(a.w0ht + woff, g.d0, a.N0, 3 * a.R, g.gu, nullptr, false, true);
}

size_t grad_features(const Args& a, bool bayes) {
  const size_t W3 = 3 * (size_t)a.R;
  const size_t tail = bayes || (size_t)a.DT > 6 * W3 ? a.DT : 0;
  return 11 * W3 + (bayes ? 1 : 2) * (size_t)a.N0 + 3 * (size_t)a.dmax + tail;
}

// Shared memory: the Grad buffers (zh, u2..u4, gz, gacc, gk1..gk3, gout, gu
// [3R]; d0, d0sum [N0]; da, db, dc [widest deep layer]), then the stash.  The
// tail is staged over gacc.. (free at the start and at the end).  With kBayes
// there is no d0sum and the tail has its own buffer.
template <bool kBayes>
__global__ void __launch_bounds__(kThreads)
train_backward_kernel(const float* __restrict__ traj, const float* __restrict__ gtraj,
                      const float* __restrict__ ztail, const float* __restrict__ gstats,
                      Args a, float* __restrict__ g_zhead, float* __restrict__ g_ztail) {
  extern __shared__ float4 smem[];
  const int W3 = 3 * a.R, B = a.B;
  const int row0 = blockIdx.x * kTile;
  const int valid = min(kTile, B - row0);
  const int tid = threadIdx.x;
  const int dmax = a.dmax;

  Grad g;
  float4* p = smem;
  float4** w3[] = {&g.zh, &g.u2, &g.u3, &g.u4, &g.gz, &g.gacc, &g.gk1, &g.gk2, &g.gk3,
                   &g.gout, &g.gu};
  for (float4** b : w3) { *b = p; p += W3 * kG; }
  g.d0 = p;    p += a.N0 * kG;
  g.d0sum = p;
  if (!kBayes) p += a.N0 * kG;
  g.da = p;    p += dmax * kG;
  g.db = p;    p += dmax * kG;
  g.dc = p;    p += dmax * kG;
  float4* tail = g.gacc;                  // 6 * 3R features free up to gu
  if (kBayes || a.DT > 6 * W3) { tail = p; p += a.DT * kG; }
  Stash st;
  carve_stash(a, p, st);
  st.tail = tail;
  const float fa_w = *a.fa_w;
  float gs[5];
  for (int q = 0; q < 5; ++q) gs[q] = a.stream_aux ? 0.f : gstats[q];

  if (kBayes) {
    for (int e = tid; e < valid * a.DT; e += blockDim.x) g_ztail[(size_t)row0 * a.DT + e] = 0.f;
  } else {
    float* d0sum = reinterpret_cast<float*>(g.d0sum);
    for (int e = tid; e < a.N0 * kTile; e += blockDim.x) d0sum[e] = 0.f;
  }
  load_tile(ztail, B, a.DT, row0, tail);
  load_tile(gtraj + (size_t)(a.T - 1) * B * W3, B, W3, row0, g.gz);
  __syncthreads();
  constexpr int kAhead = kAheadFor<kBayes>;
  if (!kBayes)
    dense_t<kAhead>(a.w0t, a.b0, nullptr, tail, a.DT, a.N0, st.ct, nullptr, 0, false, false);

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
    const float dt = a.dts[i], m = a.stream_aux ? 1.f : a.tmask[i];
    load_tile(traj + (size_t)i * B * W3, B, W3, row0, g.zh);
    __syncthreads();
    // the stages, recomputed from the stored state (k1..k3 in gk1..gk3)
    rhs_eval<kBayes>(a, st, g.zh, g.gk1, fa_w, 4 * i);
    for (int e = tid; e < n; e += blockDim.x) u2[e] = zh[e] + dt * gk1[e] * third;
    __syncthreads();
    rhs_eval<kBayes>(a, st, g.u2, g.gk2, fa_w, 4 * i + 1);
    for (int e = tid; e < n; e += blockDim.x) u3[e] = zh[e] + dt * (gk2[e] - gk1[e] * third);
    __syncthreads();
    rhs_eval<kBayes>(a, st, g.u3, g.gk3, fa_w, 4 * i + 2);
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
    rhs_vjp<kBayes>(a, st, g, g.u4, fa_w, m, gs, valid, faw_acc, 4 * i + 3, g_ztail, row0);
    for (int e = tid; e < n; e += blockDim.x) {
      gacc[e] += gu[e];
      gk1[e] += dt * gu[e];
      gk2[e] -= dt * gu[e];
      gk3[e] += dt * gu[e];
      gout[e] = gk3[e];
    }
    __syncthreads();
    rhs_vjp<kBayes>(a, st, g, g.u3, fa_w, m, gs, valid, faw_acc, 4 * i + 2, g_ztail, row0);
    for (int e = tid; e < n; e += blockDim.x) {
      gacc[e] += gu[e];
      gk2[e] += dt * gu[e];
      gk1[e] -= dt * gu[e] * third;
      gout[e] = gk2[e];
    }
    __syncthreads();
    rhs_vjp<kBayes>(a, st, g, g.u2, fa_w, m, gs, valid, faw_acc, 4 * i + 1, g_ztail, row0);
    for (int e = tid; e < n; e += blockDim.x) {
      gacc[e] += gu[e];
      gk1[e] += dt * gu[e] * third;
      gout[e] = gk1[e];
    }
    __syncthreads();
    rhs_vjp<kBayes>(a, st, g, g.zh, fa_w, m, gs, valid, faw_acc, 4 * i + 0, g_ztail, row0);
    for (int e = tid; e < n; e += blockDim.x) gacc[e] += gu[e];
    __syncthreads();
    load_tile(gtraj + (size_t)i * B * W3, B, W3, row0, g.gout);
    __syncthreads();
    for (int e = tid; e < n; e += blockDim.x) gz[e] = gacc[e] + gout[e];
    __syncthreads();
  }
  store_tile(g.gz, B, W3, row0, g_zhead);

  // K6's tail: the first layer's cotangent summed over every evaluation goes
  // to the workspace for the tail weights' and the first bias's cotangents,
  // and gives the tail's own, g_tail = d0sum @ W0t^T (with kBayes it was
  // added on every evaluation)
  if (!kBayes) {
    const size_t E = 4 * (size_t)(a.T - 1);
    store_rows(g.d0sum, a.N0, a.sw.ws + E * a.sw.Bp * a.sw.F + (size_t)row0 * a.sw.N0p,
               a.sw.N0p);
    load_tile(ztail, B, a.DT, row0, tail);
    __syncthreads();
    dense_back_t<kAhead>(a.w0tt, g.d0sum, a.N0, a.DT, tail, nullptr, false, false);
    store_tile(tail, B, a.DT, row0, g_ztail);
  }
  __syncthreads();
  // blockDim floats from the start of shared memory (>= 38 * kTile floats)
  block_sum(&faw_acc, 1, reinterpret_cast<float*>(smem), a.sw.faw + (size_t)blockIdx.x * kStats);
}

// ---- the weight cotangents: one grouped contraction -------------------------
//
// Job j is one weight matrix (K, N) and its bias: G = sum over rows of
// X^T D, X the matrix's input rows (K wide), D its pre-activation cotangent
// rows (N wide), both from the workspace (K6/K9's tail weights: X = ztail,
// D = K6's summed first-layer cotangent, or K9's of each evaluation), and the
// bias's cotangent the column sums of D.  A CTA owns (job, 64 x 64 output
// tile, one evaluation's Bp rows): a thread 4 x 4 outputs, the rows streamed
// 16 at a time through shared memory (X and D as float4 rows, the next step's
// loads issued before this step's FMAs), IEEE float32 FMAs in row order.  It
// writes its evaluation's partial tile (kBayes: and z(e) times it, z(e) read
// once a tile) to the partials; train_reduce_kernel then sums each output's
// partials over the evaluations in order.  No atomics: the same bits on
// every run.
constexpr int kCT = 64;               // a CTA's output tile: kCT x kCT
constexpr int kCRows = 16;            // rows a step
constexpr int kCThreads = 256;
constexpr int kMaxJobs = 2 + 2 * kMaxDeep;

struct Job {
  int K, N;                  // widths of X and D: the cotangent is (K, N)
  int xsrc;                  // 0: X from the workspace, 1: X = ztail (B, xld)
  int xld, dld;              // row strides (floats)
  long long xoff, doff;      // float offsets of evaluation 0's first row
  long long estride;         // floats from one evaluation's rows to the next's
  int n_eval, kt, nt, cta0;  // evaluations (each a chunk of Bp rows), tiles, first CTA
  long long part, bpart;     // offsets of the partials [n_eval][K][N], [n_eval][N] (-1: none)
  long long gw, gb;          // offsets in the packed layout (gb -1: no bias)
};

struct Contract {
  int n_jobs, B, Bp, ctas, blocks;
  long long P, part_total;   // packed floats; floats of one set of partials
  Job job[kMaxJobs];
};

template <bool kBayes>
__global__ void __launch_bounds__(kCThreads)
train_contract_kernel(const __grid_constant__ Contract c, const float* __restrict__ ws,
                      const float* __restrict__ ztail, const float* __restrict__ z,
                      float* __restrict__ part) {
  __shared__ __align__(16) float xs[2][kCRows][kCT];
  __shared__ __align__(16) float ds[2][kCRows][kCT];
  int j = 0;
  while (j + 1 < c.n_jobs && (int)blockIdx.x >= c.job[j + 1].cta0) ++j;
  const Job& jb = c.job[j];
  int local = (int)blockIdx.x - jb.cta0;
  const int e = local % jb.n_eval;
  local /= jb.n_eval;
  const int k0 = (local / jb.nt) * kCT, n0 = (local % jb.nt) * kCT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lr = tid >> 4, kx = k0 + 4 * (tid & 15), nd = n0 + 4 * (tid & 15);
  const bool bias = k0 == 0 && jb.gb >= 0;
  const float* xe = ws + jb.xoff + (long long)e * jb.estride;
  const float* de = ws + jb.doff + (long long)e * jb.estride;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  auto load = [&](int b, float4& xv, float4& dv) {
    if (jb.xsrc == 0) {
      xv = kx < jb.K ? __ldg(reinterpret_cast<const float4*>(xe + (size_t)b * jb.xld + kx)) : zero;
    } else {
      float t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        t[i] = b < c.B && kx + i < jb.K ? __ldg(ztail + (size_t)b * jb.xld + kx + i) : 0.f;
      xv = make_float4(t[0], t[1], t[2], t[3]);
    }
    dv = nd < jb.N ? __ldg(reinterpret_cast<const float4*>(de + (size_t)b * jb.dld + nd)) : zero;
  };

  float acc[16], bacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float4 xv, dv;
  load(lr, xv, dv);
  const int steps = c.Bp / kCRows;
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    *reinterpret_cast<float4*>(&xs[buf][lr][4 * (tid & 15)]) = xv;
    *reinterpret_cast<float4*>(&ds[buf][lr][4 * (tid & 15)]) = dv;
    __syncthreads();
    if (s + 1 < steps) load((s + 1) * kCRows + lr, xv, dv);
#pragma unroll
    for (int r = 0; r < kCRows; ++r) {
      const float4 xa = *reinterpret_cast<const float4*>(&xs[buf][r][4 * ty]);
      const float4 da = *reinterpret_cast<const float4*>(&ds[buf][r][4 * tx]);
      const float xr[4] = {xa.x, xa.y, xa.z, xa.w}, dr[4] = {da.x, da.y, da.z, da.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[4 * i + q] = fmaf(xr[i], dr[q], acc[4 * i + q]);
    }
    if (bias) {               // row ty of the step: each row once a column
      const float4 da = *reinterpret_cast<const float4*>(&ds[buf][ty][4 * tx]);
      bacc[0] += da.x; bacc[1] += da.y; bacc[2] += da.z; bacc[3] += da.w;
    }
  }

  const int K = jb.K, N = jb.N;
  const float* ze = kBayes ? z + (long long)e * c.P : nullptr;
  float* pw = part + jb.part + (size_t)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + 4 * tx + q;
      if (k >= K || col >= N) continue;
      const size_t o = (size_t)k * N + col;
      pw[o] = acc[4 * i + q];
      if (kBayes) pw[c.part_total + o] = acc[4 * i + q] * __ldg(ze + jb.gw + o);
    }
  }
  if (bias) {                 // the 16 row classes' sums, added in order
    __syncthreads();
    float* red = &xs[0][0][0];
#pragma unroll
    for (int q = 0; q < 4; ++q) red[ty * kCT + 4 * tx + q] = bacc[q];
    __syncthreads();
    if (tid < kCT && n0 + tid < N) {
      float sum = 0.f;
      for (int t = 0; t < 16; ++t) sum += red[t * kCT + tid];
      float* pb = part + jb.bpart + (size_t)e * N + n0 + tid;
      pb[0] = sum;
      if (kBayes) pb[c.part_total] = sum * __ldg(ze + jb.gb + n0 + tid);
    }
  }
}

// Each packed cotangent (kBayes: the means', then the |std|s') as the sum of
// its partials over the evaluations in order; fa_w's as the blocks' shares
// in order, after them.
template <bool kBayes>
__global__ void __launch_bounds__(256)
train_reduce_kernel(const __grid_constant__ Contract c, const float* __restrict__ part,
                    const float* __restrict__ faw, float* __restrict__ grads) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == c.P) {
    float sum = 0.f;
    for (int b = 0; b < c.blocks; ++b) sum += faw[(size_t)b * kStats];
    grads[(kBayes ? 2 : 1) * c.P] = sum;
    return;
  }
  if (i > c.P) return;
  const float* src = nullptr;
  long long stride = 0;
  int n = 0;
  for (int j = 0; j < c.n_jobs && src == nullptr; ++j) {
    const Job& jb = c.job[j];
    const long long kn = (long long)jb.K * jb.N;
    if (i >= jb.gw && i < jb.gw + kn) {
      src = part + jb.part + (i - jb.gw);
      stride = kn;
      n = jb.n_eval;
    } else if (jb.gb >= 0 && i >= jb.gb && i < jb.gb + jb.N) {
      src = part + jb.bpart + (i - jb.gb);
      stride = jb.N;
      n = jb.n_eval;
    }
  }
  if (src == nullptr) return;    // not reached: the plan covers every packed offset
  float sum = 0.f;
  for (int e = 0; e < n; ++e) sum += src[e * stride];
  grads[i] = sum;
  if (kBayes) {
    float sd = 0.f;
    for (int e = 0; e < n; ++e) sd += src[c.part_total + e * stride];
    grads[c.P + i] = sd;
  }
}

// Host side -------------------------------------------------------------------

void fill_net(Net& net, int n, const int* outs, const void* const* w,
              const void* const* wt, const void* const* b) {
  net.n = n;
  for (int d = 0; d < n; ++d) {
    net.out[d] = outs[d];
    net.w[d] = w != nullptr ? static_cast<const float*>(w[d]) : nullptr;
    net.wt[d] = wt != nullptr ? static_cast<const float*>(wt[d]) : nullptr;
    net.b[d] = b != nullptr ? static_cast<const float*>(b[d]) : nullptr;
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
  // the packed layout: w0h, w0t, b0, each deep layer's (w, b)
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
  a.P = off;
  return cudaSuccess;
}

// Point the weights at evaluation 0 of the effective-weight buffers: the
// packed offsets.
void point_at(Args& a, const float* w, const float* wt) {
  a.w0h = w + a.g_w0h; a.w0t = w + a.g_w0t; a.b0 = w + a.g_b0;
  a.w0ht = wt != nullptr ? wt + a.g_w0h : nullptr;
  a.w0tt = wt != nullptr ? wt + a.g_w0t : nullptr;
  Net* nets[2] = {&a.fp, &a.aug};
  for (Net* net : nets)
    for (int d = 0; d < net->n; ++d) {
      net->w[d] = w + net->gw[d];
      net->b[d] = w + net->gb[d];
      net->wt[d] = wt != nullptr ? wt + net->gw[d] : nullptr;
    }
}

// Switch to aux-streaming mode: the forward's outputs or the backward's
// cotangent inputs, any of them null when absent.
void stream_aux(Args& a, float* rates_out, float* fa_out, const float* g_rates,
                const float* g_fa) {
  a.stream_aux = 1;
  a.rates_out = rates_out; a.fa_out = fa_out;
  a.g_rates = g_rates; a.g_fa = g_fa;
}

// ---- the forward's plan -------------------------------------------------------
//
// ops/fused_train.py::forward_plan makes it, the only planner.  The launchers
// read its ints (64-bit, ForwardPlan.flat()) and check what the kernel relies
// on; they refuse any other plan.  In order:
//   rows, threads, cluster, B, T, bayes, stream_aux, blocks, partials,
//   smem_bytes, stages, stage_bytes, the byte offsets of zh, tail, zs, kbuf,
//   ct, h0, fpb, augb, rates, fa, wts;
//   n, then n passes (n_jobs, then each job's kind, layer, K, N, cols, t0,
//     nt, ldw);
//   n, then n chunks (step, k0[2], k1[2], off[2], boff[2]).
constexpr long long kSmemLimit = 232448;         // dynamic shared memory a block can use
constexpr long long kMaxOffset = 1LL << 50;      // floats: any offset or size of the plan
constexpr long long kMaxWidth = 1 << 16;         // floats: a width, a row stride

// The ints of a plan, read in order; `ok` turns false on reading past the
// end or on a value outside [-1, kMaxOffset).
struct Longs {
  const long long* v;
  int n, i;
  bool ok;
  long long get() {
    const long long x = i < n ? v[i++] : -2;
    ok = ok && x >= -1 && x < kMaxOffset;
    return x;
  }
};

// Reads the plan of n ints at v into p and checks what the kernel relies on,
// for these widths (a) and mode: its rows, threads and cluster (1); its batch,
// points, blocks and statistics rows; each buffer 16-byte aligned, as large
// as the kernel uses it, in the layout's order (K8: the tail just before zs),
// all below the two stages and those inside smem_bytes <= kSmemLimit, with
// room in the stages for the statistics' block sum; every pass's products
// those of these widths in the kernel's order, each on warps of its own with
// a thread for every tile and a row stride that holds its tiles' columns;
// and each pass's weight rows covered in order by its chunks, a chunk's rows
// inside its stage.  Fills the derived fields.
bool read_forward_plan(const long long* v, int n, const Args& a, bool bayes, FPlan& p) {
  if (v == nullptr) return false;
  p = FPlan{};
  Longs in{v, n, 0, true};
  long long h[12];
  for (long long& x : h) x = in.get();
  const long long blocks = ((long long)a.B + kTile - 1) / kTile;
  if (!in.ok || h[0] != kTile || h[1] != kFThreads || h[2] != 1 || h[3] != a.B ||
      h[4] != a.T || h[5] != (bayes ? 1 : 0) || h[6] != a.stream_aux || h[7] != blocks ||
      h[8] != (a.stream_aux ? 0 : blocks) || h[9] < 1 || h[9] > kSmemLimit || h[10] != 2 ||
      h[11] < 16 || h[11] % 16 || 2 * h[11] < 5 * 4 * kFThreads)
    return false;
  p.smem = (int)h[9];
  p.stage_bytes = (int)h[11];
  int* offs[11] = {&p.zh, &p.tail, &p.zs, &p.kbuf, &p.ct, &p.h0, &p.fpb, &p.augb, &p.rates,
                   &p.fa, &p.wts};
  for (int* o : offs) {
    const long long x = in.get();
    if (!in.ok || x < kFArgsBytes || x > kSmemLimit || x % 16) return false;
    *o = (int)x;
  }
  const int W3 = 3 * a.R, row = kTile * 4;
  int wf = 0, wa = 0;
  for (int d = 0; d + 1 < a.fp.n; ++d) wf = a.fp.out[d] > wf ? a.fp.out[d] : wf;
  for (int d = 0; d + 1 < a.aug.n; ++d) wa = a.aug.out[d] > wa ? a.aug.out[d] : wa;
  p.fph = wf * row;
  p.augh = wa * row;
  const long long sizes[10] = {(long long)W3 * row, (long long)a.DT * row, (long long)W3 * row,
                               3LL * W3 * row, bayes ? 0 : (long long)a.N0 * row,
                               (long long)a.N0 * row, 2LL * p.fph, 2LL * p.augh,
                               a.fp.n ? 2LL * a.R * row : 0, a.aug.n ? (long long)W3 * row : 0};
  for (int b = 0; b < 10; ++b)
    if (*offs[b] + sizes[b] > *offs[b + 1]) return false;
  if ((bayes && p.tail + sizes[1] != p.zs) || (long long)p.wts + 2LL * p.stage_bytes > p.smem)
    return false;

  // the passes: the first layer (K8: over [tail | head]), then layer d of the
  // rates net and of the Fa net
  const int depth = a.fp.n > a.aug.n ? a.fp.n : a.aug.n;
  p.n_steps = (int)in.get();
  if (!in.ok || p.n_steps != depth + 1 || p.n_steps > kFMaxSteps) return false;
  for (int s = 0; s < p.n_steps; ++s) {
    FStep& sp = p.step[s];
    sp.n_jobs = (int)in.get();
    int kinds[2], layers[2], want = 0;
    if (s == 0) { kinds[want] = kFFirst; layers[want++] = 0; }
    if (s > 0 && s - 1 < a.fp.n) { kinds[want] = kFFp; layers[want++] = s - 1; }
    if (s > 0 && s - 1 < a.aug.n) { kinds[want] = kFAug; layers[want++] = s - 1; }
    if (!in.ok || sp.n_jobs != want) return false;
    int t = 0;
    for (int j = 0; j < want; ++j) {
      long long f[8];
      for (long long& x : f) x = in.get();
      const int kind = kinds[j], d = layers[j];
      long long K, N;
      if (kind == kFFirst) {
        K = bayes ? W3 + a.DT : W3;
        N = a.N0;
      } else {
        const Net& net = kind == kFFp ? a.fp : a.aug;
        K = d ? net.out[d - 1] : (kind == kFFp ? a.n0_fp : a.N0 - a.n0_fp);
        N = net.out[d];
      }
      const long long C = f[4], tiles = 4 * ((N + C - 1) / (C > 0 ? C : 1));
      if (!in.ok || f[0] != kind || f[1] != d || f[2] != K || f[3] != N ||
          (C != 1 && C != 2 && C != 4 && C != 8) || f[5] != t || f[6] % 32 || f[6] < tiles ||
          f[5] + f[6] > kFThreads || f[7] % 4 || f[7] < (N + C - 1) / C * C || f[7] > kMaxWidth)
        return false;
      sp.job[j] = FJob{kind, d, (int)K, (int)N, (int)C, (int)f[5], (int)f[6], (int)f[7]};
      t = (int)(f[5] + f[6]);
    }
  }

  // the weights: each pass's rows in order over its chunks, inside their stage
  p.n_chunks = (int)in.get();
  if (!in.ok || p.n_chunks < 1 || p.n_chunks > kFMaxChunks) return false;
  int next_k[2] = {0, 0};
  for (int c = 0; c < p.n_chunks; ++c) {
    FChunk& ch = p.chunk[c];
    long long f[9];
    for (long long& x : f) x = in.get();
    const int prev = c ? p.chunk[c - 1].step : 0;
    if (!in.ok || f[0] < prev || f[0] > prev + (c ? 1 : 0) || f[0] >= p.n_steps) return false;
    ch.step = (int)f[0];
    const bool first = c == 0 || ch.step != prev;
    if (c && ch.step != prev) {
      const FStep& ps = p.step[prev];
      for (int j = 0; j < ps.n_jobs; ++j)
        if (next_k[j] != ps.job[j].K) return false;
      next_k[0] = next_k[1] = 0;
    }
    const FStep& sp = p.step[ch.step];
    long long end = 0;
    for (int j = 0; j < 2; ++j) {
      ch.k0[j] = (int)f[1 + j];
      ch.k1[j] = (int)f[3 + j];
      ch.off[j] = (int)f[5 + j];
      ch.boff[j] = (int)f[7 + j];
      if (j >= sp.n_jobs) continue;
      if (f[1 + j] != next_k[j] || f[3 + j] <= f[1 + j] || f[3 + j] > sp.job[j].K ||
          f[5 + j] % 16 || f[5 + j] < end)
        return false;
      end = f[5 + j] + (f[3 + j] - f[1 + j]) * sp.job[j].ldw * 4;
      if (end > p.stage_bytes) return false;
      next_k[j] = ch.k1[j];
    }
    // a pass's first chunk holds a bias row for each product that starts at
    // one (all but K5's first layer), after the weight rows; no other chunk
    for (int j = 0; j < sp.n_jobs; ++j) {
      const bool wants = first && !(sp.job[j].kind == kFFirst && !bayes);
      if (!wants) {
        if (f[7 + j] != -1) return false;
        continue;
      }
      if (f[7 + j] % 16 || f[7 + j] < end) return false;
      end = f[7 + j] + 4LL * ((sp.job[j].N + 3) / 4 * 4);
      if (end > p.stage_bytes) return false;
    }
  }
  const FStep& last = p.step[p.n_steps - 1];
  if (in.i != n || p.chunk[p.n_chunks - 1].step != p.n_steps - 1) return false;
  for (int j = 0; j < last.n_jobs; ++j)
    if (next_k[j] != last.job[j].K) return false;
  for (int c = 0, s = 0; s <= p.n_steps; ++s) {
    while (c < p.n_chunks && p.chunk[c].step < s) ++c;
    p.chunk0[s] = c;
  }
  return true;
}

// Launch on `stream` with the plan of plan_len ints; refuse a plan
// read_forward_plan does not take.
template <bool kBayes>
int launch_forward(const float* zh0, const float* ztail, const Args& a, float* traj,
                   float* stats, const long long* plan, int plan_len, void* stream) {
  FPlan p;
  if (!read_forward_plan(plan, plan_len, a, kBayes, p) || (!a.stream_aux && stats == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(train_forward_kernel<kBayes>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return e;
  train_forward_kernel<kBayes><<<(a.B + kTile - 1) / kTile, kFThreads, p.smem,
                                 static_cast<cudaStream_t>(stream)>>>(zh0, ztail, a, p, traj,
                                                                      stats);
  return cudaGetLastError();
}

// ---- the backward's plan ------------------------------------------------------
//
// ops/fused_train.py::backward_plan makes it, the only planner.  The launchers
// read its ints (64-bit, BackwardPlan.flat()) and check what the kernels rely
// on; they refuse any other plan.  In order:
//   rows, threads, B, T, bayes, blocks, Bp, E, smem_bytes, F, N0p, ws_floats,
//   ctas, part_total, P, grad_floats;
//   n, then n workspace segments (kind, layer, offset, width);
//   n, then n contraction jobs (K, N, xsrc, xld, xoff, dld, doff, estride,
//     n_eval, kt, nt, cta0, part, bpart, gw, gb).
enum SegKind { kSU, kSH0Fp, kSH0Aug, kSFpPost, kSAugPost, kSD0, kSFpD, kSAugD };
constexpr int kMaxSegs = 4 + 4 * kMaxDeep;
static_assert(kCRows == kTile, "the contraction steps through a block's rows");

struct PlanHead {
  long long rows, threads, B, T, bayes, blocks, Bp, E, smem, F, N0p, ws_floats, ctas,
      part_total, P, grad_floats;
};
struct Seg { long long kind, layer, off, width; };

long long round4(long long n) { return (n + 3) / 4 * 4; }

// Whether n_eval x rows operand rows, `width` floats each at off + e * estride
// + b * ld, lie inside [0, total).  All arguments below kMaxOffset.
bool inside(long long off, long long estride, long long n_eval, long long ld, long long rows,
            long long width, long long total) {
  if (off < 0 || estride < 0 || ld < 0 || n_eval < 1 || rows < 1 || width < 1 ||
      off + width > total)
    return false;
  long long room = total - off - width;
  if (ld > 0) {
    if (rows - 1 > room / ld) return false;
    room -= (rows - 1) * ld;
  }
  return estride == 0 || n_eval - 1 <= room / estride;
}

bool apart(long long a0, long long a1, long long b0, long long b1) { return a1 <= b0 || b1 <= a0; }

// Reads the plan of n ints at v into h, segs (ns of them) and c, and checks
// what the contraction relies on: the header's counts consistent (the
// blocks, the padded rows, E = 4(T-1), the packed cotangents' length, the
// workspace at least the rows' floats and K6's summed first-layer cotangent,
// shared memory within the limit); every segment inside a row, apart from
// the others; every job's X and D rows inside the workspace (ztail: inside
// its B rows of xld floats) at 16-byte alignment, its partials inside
// part_total and apart from every other's, its CTAs following the previous
// job's, one a 64 x 64 tile and evaluation; and the packed cotangents [0, P)
// covered once by the jobs' weights and biases.
bool read_plan(const long long* v, int n, bool bayes, PlanHead& h, Seg* segs, int& ns,
               Contract& c) {
  if (v == nullptr) return false;
  Longs in{v, n, 0, true};
  long long* head[] = {&h.rows, &h.threads, &h.B, &h.T, &h.bayes, &h.blocks, &h.Bp, &h.E,
                       &h.smem, &h.F, &h.N0p, &h.ws_floats, &h.ctas, &h.part_total, &h.P,
                       &h.grad_floats};
  for (long long* f : head) *f = in.get();
  if (!in.ok || h.rows != kTile || h.threads != kThreads || h.bayes != (bayes ? 1 : 0) ||
      h.B < 1 || h.B > (1 << 26) || h.T < 2 || h.T > kMaxWidth ||
      h.E != 4 * (h.T - 1) || h.blocks != (h.B + kTile - 1) / kTile ||
      h.Bp != h.blocks * kTile || h.smem < 1 || h.smem > kSmemLimit || h.F < 1 ||
      h.F > kMaxWidth || h.F % 4 || h.N0p < 0 || h.N0p > kMaxWidth || h.N0p % 4 || h.P < 1 ||
      h.grad_floats != (bayes ? 2 : 1) * h.P + 1 || h.ctas < 1 || h.ctas > 0x7fffffff ||
      h.ws_floats < h.E * h.Bp * h.F + (bayes ? 0 : h.Bp * h.N0p))
    return false;

  ns = (int)in.get();
  if (!in.ok || ns < 1 || ns > kMaxSegs) return false;
  for (int i = 0; i < ns; ++i) {
    Seg& s = segs[i];
    for (long long* f : {&s.kind, &s.layer, &s.off, &s.width}) *f = in.get();
    if (!in.ok || s.kind < kSU || s.kind > kSAugD || s.layer < 0 || s.layer >= kMaxDeep ||
        s.off < 0 || s.width < 1 || s.off + s.width > h.F)
      return false;
    for (int j = 0; j < i; ++j)
      if (!apart(s.off, s.off + s.width, segs[j].off, segs[j].off + segs[j].width) ||
          (s.kind == segs[j].kind && s.layer == segs[j].layer))
        return false;
  }

  c = Contract{};
  c.B = (int)h.B; c.Bp = (int)h.Bp; c.blocks = (int)h.blocks; c.ctas = (int)h.ctas;
  c.P = h.P; c.part_total = h.part_total;
  c.n_jobs = (int)in.get();
  if (!in.ok || c.n_jobs < 1 || c.n_jobs > kMaxJobs) return false;
  long long cta = 0, covered = 0;
  long long parts[2 * kMaxJobs][2], packed[2 * kMaxJobs][2];
  int n_parts = 0, n_packed = 0;
  for (int j = 0; j < c.n_jobs; ++j) {
    long long K, N, xsrc, xld, xoff, dld, doff, estride, n_eval, kt, nt, cta0, part, bpart, gw,
        gb;
    for (long long* f : {&K, &N, &xsrc, &xld, &xoff, &dld, &doff, &estride, &n_eval, &kt, &nt,
                         &cta0, &part, &bpart, &gw, &gb})
      *f = in.get();
    if (!in.ok || K < 1 || K > kMaxWidth || N < 1 || N > kMaxWidth || n_eval < 1 ||
        n_eval > h.E || kt != (K + kCT - 1) / kCT || nt != (N + kCT - 1) / kCT || cta0 != cta ||
        (xsrc != 0 && xsrc != 1) || xld > kMaxWidth || dld > kMaxWidth || dld % 4 || doff % 4 ||
        !inside(doff, estride, n_eval, dld, h.Bp, round4(N), h.ws_floats) ||
        (gb < 0) != (bpart < 0))
      return false;
    if (xsrc == 0 ? xld % 4 || xoff % 4 ||
                        !inside(xoff, estride, n_eval, xld, h.Bp, round4(K), h.ws_floats)
                  : xld < K || xoff != 0)
      return false;
    cta += kt * nt * n_eval;
    parts[n_parts][0] = part;
    parts[n_parts++][1] = part + n_eval * K * N;
    packed[n_packed][0] = gw;
    packed[n_packed++][1] = gw + K * N;
    covered += K * N;
    if (gb >= 0) {
      parts[n_parts][0] = bpart;
      parts[n_parts++][1] = bpart + n_eval * N;
      packed[n_packed][0] = gb;
      packed[n_packed++][1] = gb + N;
      covered += N;
    }
    Job& jb = c.job[j];
    jb.K = (int)K; jb.N = (int)N; jb.xsrc = (int)xsrc; jb.xld = (int)xld; jb.dld = (int)dld;
    jb.xoff = xoff; jb.doff = doff; jb.estride = estride; jb.n_eval = (int)n_eval;
    jb.kt = (int)kt; jb.nt = (int)nt; jb.cta0 = (int)cta0;
    jb.part = part; jb.bpart = bpart; jb.gw = gw; jb.gb = gb;
  }
  if (!in.ok || in.i != n || cta != h.ctas || covered != h.P) return false;
  for (int i = 0; i < n_parts; ++i) {
    if (parts[i][0] < 0 || parts[i][1] > h.part_total) return false;
    for (int j = 0; j < i; ++j)
      if (!apart(parts[i][0], parts[i][1], parts[j][0], parts[j][1])) return false;
  }
  for (int i = 0; i < n_packed; ++i) {       // apart and inside [0, P), summing to P
    if (packed[i][0] < 0 || packed[i][1] > h.P) return false;
    for (int j = 0; j < i; ++j)
      if (!apart(packed[i][0], packed[i][1], packed[j][0], packed[j][1])) return false;
  }
  return true;
}

// Checks that the plan read by read_plan is for these widths (a), as the
// sweep relies on: its batch, points and packed length; room for the shared
// memory it carves and for K6's summed first-layer cotangent; and exactly
// the segments the sweep writes, each as wide as it writes it.  Fills a.sw.
bool sweep_plan(Args& a, bool bayes, const PlanHead& h, const Seg* segs, int ns) {
  const long long carve = (long long)(grad_features(a, bayes) + stash_features(a)) * kTile * 4;
  if (h.B != a.B || h.T != a.T || h.P != (long long)a.P || h.smem < carve ||
      (!bayes && h.N0p < a.N0))
    return false;
  Sweep& sw = a.sw;
  sw.Bp = (int)h.Bp;
  sw.F = (int)h.F;
  sw.N0p = (int)h.N0p;
  int want = 0;
  auto find = [&](int kind, int layer, int width) {
    ++want;
    for (int i = 0; i < ns; ++i)
      if (segs[i].kind == kind && segs[i].layer == layer)
        return segs[i].width == width ? (int)segs[i].off : -1;
    return -1;
  };
  bool ok = (sw.u = find(kSU, 0, 3 * a.R)) >= 0 && (sw.d0 = find(kSD0, 0, a.N0)) >= 0;
  sw.h0fp = sw.h0aug = -1;
  if (a.fp.n) ok = ok && (sw.h0fp = find(kSH0Fp, 0, a.n0_fp)) >= 0;
  if (a.aug.n) ok = ok && (sw.h0aug = find(kSH0Aug, 0, a.N0 - a.n0_fp)) >= 0;
  for (int d = 0; d < a.fp.n; ++d) {
    ok = ok && (sw.fp_d[d] = find(kSFpD, d, a.fp.out[d])) >= 0;
    if (d + 1 < a.fp.n) ok = ok && (sw.fp_post[d] = find(kSFpPost, d, a.fp.out[d])) >= 0;
  }
  for (int d = 0; d < a.aug.n; ++d) {
    ok = ok && (sw.aug_d[d] = find(kSAugD, d, a.aug.out[d])) >= 0;
    if (d + 1 < a.aug.n) ok = ok && (sw.aug_post[d] = find(kSAugPost, d, a.aug.out[d])) >= 0;
  }
  return ok && want == ns;
}

template <bool kBayes>
int launch_backward(const float* traj, const float* gtraj, const float* ztail,
                    const float* gstats, Args& a, float* g_zhead, float* g_ztail,
                    const long long* plan, int plan_len, float* ws, float* faw, void* stream) {
  PlanHead h;
  Seg segs[kMaxSegs];
  int ns = 0;
  Contract c;
  if (!read_plan(plan, plan_len, kBayes, h, segs, ns, c) || !sweep_plan(a, kBayes, h, segs, ns) ||
      ws == nullptr || faw == nullptr)
    return cudaErrorInvalidValue;
  a.sw.ws = ws;
  a.sw.faw = faw;
  cudaError_t e = cudaFuncSetAttribute(train_backward_kernel<kBayes>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)h.smem);
  if (e != cudaSuccess) return e;
  train_backward_kernel<kBayes><<<(a.B + kTile - 1) / kTile, kThreads, (size_t)h.smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      traj, gtraj, ztail, gstats, a, g_zhead, g_ztail);
  return cudaGetLastError();
}

template <bool kBayes>
int launch_contract(const Contract& c, const float* ws, const float* ztail, const float* z,
                    const float* faw, float* part, float* grads, cudaStream_t s) {
  train_contract_kernel<kBayes><<<c.ctas, kCThreads, 0, s>>>(c, ws, ztail, z, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  train_reduce_kernel<kBayes><<<(unsigned)((c.P + 1 + 255) / 256), 256, 0, s>>>(c, part, faw,
                                                                                grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5.  zh0 (B, 3R) region-major head; ztail (B, DT); dts, tmask (T-1) and
// fa_w (scalar) on the device; weights (in, out).  Writes traj (T, B, 3R) and
// stats (blocks, 8): per block sum(beta - 0.8), sum(gamma - 0.55), the two
// sums of squares, sum(Fa^2).  With aux_mode != 0 (aux-streaming) tmask and
// stats are not read or written (null), and every evaluation's |rates| go to
// rates (4(T-1), B, 2R) and its Fa to fa (4(T-1), B, 3R), each null for a
// family without that net.  The plan of plan_len ints
// (ops/fused_train.py::forward_plan, refused unless read_forward_plan takes it
// for these widths and mode).  Launches on `stream`; returns
// cudaGetLastError().
int fused_train_forward(const float* zh0, const float* ztail, int B, int T,
                        const float* dts, const float* tmask, const float* fa_w, int R,
                        int DT, int N0, int n0_fp, const void* w0h, const void* w0t,
                        const void* b0, int n_fp, const int* fp_out,
                        const void* const* fp_w, const void* const* fp_b, int n_aug,
                        const int* aug_out, const void* const* aug_w,
                        const void* const* aug_b, float* traj, float* stats,
                        int aux_mode, float* rates, float* fa, const long long* plan,
                        int plan_len, void* stream) {
  Args a;
  int err = fill_args(a, B, T, dts, tmask, fa_w, R, DT, N0, n0_fp, w0h, w0t, b0, n_fp,
                      fp_out, fp_w, nullptr, fp_b, n_aug, aug_out, aug_w, nullptr, aug_b);
  if (err != cudaSuccess) return err;
  if (aux_mode) stream_aux(a, rates, fa, nullptr, nullptr);
  return launch_forward<false>(zh0, ztail, a, traj, stats, plan, plan_len, stream);
}

// K6's reverse sweep.  traj (T, B, 3R) from K5, gtraj its cotangent, ztail
// (B, DT), gstats (5) the cotangents of the five statistics; weights (in,
// out) and their transposes (out, in), w0ht (N0, 3R), w0tt (N0, DT); the plan
// of plan_len ints (ops/fused_train.py::backward_plan, refused unless
// read_plan and sweep_plan take it for these widths).  Writes g_zhead (B, 3R), g_ztail
// (B, DT), the workspace ws (the plan's ws_floats) and faw (blocks, 8): each
// block's share of fa_w's cotangent.  With aux_mode != 0 tmask and gstats
// are not read (null) and the aux cotangents are g_rates (4(T-1), B, 2R) and
// g_fa (4(T-1), B, 3R), either null when the loss never read that stream.
int fused_train_backward(const float* traj, const float* gtraj, const float* ztail,
                         int B, int T, const float* dts, const float* tmask,
                         const float* fa_w, const float* gstats, int R, int DT, int N0,
                         int n0_fp, const void* w0h, const void* w0t, const void* b0,
                         const void* w0ht, const void* w0tt, int n_fp, const int* fp_out,
                         const void* const* fp_w, const void* const* fp_wt,
                         const void* const* fp_b, int n_aug, const int* aug_out,
                         const void* const* aug_w, const void* const* aug_wt,
                         const void* const* aug_b, float* g_zhead, float* g_ztail,
                         int aux_mode, const float* g_rates, const float* g_fa,
                         const long long* plan, int plan_len, float* ws, float* faw,
                         void* stream) {
  Args a;
  int err = fill_args(a, B, T, dts, tmask, fa_w, R, DT, N0, n0_fp, w0h, w0t, b0, n_fp,
                      fp_out, fp_w, fp_wt, fp_b, n_aug, aug_out, aug_w, aug_wt, aug_b);
  if (err != cudaSuccess) return err;
  a.w0ht = static_cast<const float*>(w0ht);
  a.w0tt = static_cast<const float*>(w0tt);
  if (aux_mode) stream_aux(a, nullptr, nullptr, g_rates, g_fa);
  return launch_backward<false>(traj, gtraj, ztail, gstats, a, g_zhead, g_ztail, plan, plan_len,
                                ws, faw, stream);
}

// K8.  As fused_train_forward, with the weights of evaluation e = 4 * step +
// stage read from weff (4(T-1), P), fused_bayes_draw's output: each
// evaluation's packed arrays (w0_head, w0_tail, b0, then each later (w, b) of
// the rates net, then of the Fa net; (in, out) weights).  aux_mode, rates, fa
// and the plan (forward_plan with bayes) as in fused_train_forward.
int fused_bayes_train_forward(const float* zh0, const float* ztail, int B, int T,
                              const float* dts, const float* tmask, const float* fa_w, int R,
                              int DT, int N0, int n0_fp, const float* weff, long long P,
                              int n_fp, const int* fp_out, int n_aug, const int* aug_out,
                              float* traj, float* stats, int aux_mode, float* rates,
                              float* fa, const long long* plan, int plan_len, void* stream) {
  Args a;
  int err = fill_args(a, B, T, dts, tmask, fa_w, R, DT, N0, n0_fp, nullptr, nullptr, nullptr,
                      n_fp, fp_out, nullptr, nullptr, nullptr, n_aug, aug_out, nullptr, nullptr,
                      nullptr);
  if (err != cudaSuccess) return err;
  if ((long long)a.P != P) return cudaErrorInvalidValue;
  point_at(a, weff, nullptr);
  if (aux_mode) stream_aux(a, rates, fa, nullptr, nullptr);
  return launch_forward<true>(zh0, ztail, a, traj, stats, plan, plan_len, stream);
}

// K9's reverse sweep.  As fused_train_backward, with weff and wteff (each
// matrix transposed in its slot) (4(T-1), P) from fused_bayes_draw, and the
// Bayes plan; g_ztail gets the tail's cotangent summed over the evaluations.
int fused_bayes_train_backward(const float* traj, const float* gtraj, const float* ztail,
                               int B, int T, const float* dts, const float* tmask,
                               const float* fa_w, const float* gstats, int R, int DT, int N0,
                               int n0_fp, const float* weff, const float* wteff, long long P,
                               int n_fp, const int* fp_out, int n_aug, const int* aug_out,
                               float* g_zhead, float* g_ztail, int aux_mode,
                               const float* g_rates, const float* g_fa,
                               const long long* plan, int plan_len, float* ws, float* faw,
                               void* stream) {
  Args a;
  int err = fill_args(a, B, T, dts, tmask, fa_w, R, DT, N0, n0_fp, nullptr, nullptr, nullptr,
                      n_fp, fp_out, nullptr, nullptr, nullptr, n_aug, aug_out, nullptr, nullptr,
                      nullptr);
  if (err != cudaSuccess) return err;
  if ((long long)a.P != P) return cudaErrorInvalidValue;
  point_at(a, weff, wteff);
  if (aux_mode) stream_aux(a, nullptr, nullptr, g_rates, g_fa);
  return launch_backward<true>(traj, gtraj, ztail, gstats, a, g_zhead, g_ztail, plan, plan_len,
                               ws, faw, stream);
}

// The weight cotangents of K6 (bayes = 0) or K9 (bayes = 1) from a sweep's
// workspace ws, ztail (B, DT), z (4(T-1), P) (K9's noise; null for K6) and
// faw (blocks, 8), by the sweep's plan (plan_len ints, BackwardPlan.flat()):
// two launches (the contraction, then the sum of its partials), the partials
// in `part` (the plan's part_total floats, twice with bayes).  Writes grads:
// the packed cotangents (P), with bayes then the packed |std|s' (P), then
// fa_w's.
int fused_train_contract(int bayes, const long long* plan, int plan_len, const float* ws,
                         const float* ztail, const float* z, const float* faw, float* part,
                         float* grads, void* stream) {
  PlanHead h;
  Seg segs[kMaxSegs];
  int ns = 0;
  Contract c;
  if (!read_plan(plan, plan_len, bayes != 0, h, segs, ns, c) || ws == nullptr ||
      faw == nullptr || part == nullptr || grads == nullptr || (bayes && z == nullptr))
    return cudaErrorInvalidValue;
  for (int j = 0; j < c.n_jobs; ++j)
    if (c.job[j].xsrc == 1 && ztail == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bayes ? launch_contract<true>(c, ws, ztail, z, faw, part, grads, s)
               : launch_contract<false>(c, ws, ztail, z, faw, part, grads, s);
}

}  // extern "C"
