// Back-GRU encoder backward (BPTT) for Hopper (sm_90a): kernel K4 of the
// training path.
//
// Replaces: fiude_tpu/ops/pallas_gru_train.py::_get_enc_train.bwd_impl (kernel
// body _make_bwd_kernel, pallas_gru_train.py:146-270): backprop of the ReLU
// head, then the reverse sweep t = T-1 .. 0 through the stacked GRU, giving
// the cotangent of every GRU and head weight and bias.  x is training data:
// no x cotangent is computed (pallas_gru_train.py:26-28).
//
// What bounds it on the card: the reverse sweep is T x n_layers dependent
// layer-steps, each a (rows x 3H_l) x (3H_l x H_l) product (the recurrent
// cotangent) and, below the top layer, a (rows x 3H_{l+1}) x (3H_{l+1} x H_l)
// one (the cotangent from the layer above).  At the `state` shape (B = 32,
// T = 42, H = 256, 128) that is ~11 M multiply-adds a step, so operations
// do not set the pace: the chain of dependent layer-steps does, as in the
// forward (csrc/fused_gru.cu), and the loop weights (w_hh of every layer,
// w_ih from layer 1 on: 1.376 MB there) are read at every step.  The TPU
// kernel also accumulates the weight cotangents inside the sweep, in VMEM;
// on the card that would be ~740k accumulators a block, or float atomics
// across blocks, whose order (and so whose result) changes from run to run.
//
// What the design does about it:
//  * the forward (K3) stored every layer's hidden state and gate values, so
//    the sweep recomputes nothing: per layer-step it reads the gates and the
//    previous state, forms the gate cotangents and runs the two products;
//  * the head's backward is a small launch of its own (bptt_head_kernel), one
//    block per 4 rows, ahead of the sweep; it leaves the top layer's
//    final-state cotangent in a (B, H) scratch;
//  * the sweep runs on thread-block clusters (bptt_cluster_kernel), K1's
//    design run backwards: a cluster of C CTAs takes R batch rows, and CTA c
//    owns the hidden units [c*U_l, (c+1)*U_l) of every layer l (U_l =
//    ceil(H_l / C)).  With the plan's `resident` flag a CTA copies once into
//    shared memory the columns of its units in w_hh_l (3H_l x U_l, torch's
//    (3H, H) layout) and in w_ih_{l+1} (3H_{l+1} x U_l), 1.376 MB / C at the
//    `state` shape; otherwise it reads the same columns through L2;
//  * every CTA keeps, double buffered for its R rows, the gate cotangents
//    that its units' products contract over: gh_l (3H_l) of every layer and
//    gx_{l+1} (3H_{l+1}) of the layer above, k-major ([K][R], one 16-byte load
//    serves 4 rows).  The layers run as a reverse wavefront: in barrier
//    interval i layer l takes step t = T-1 - (i - (n_layers-1-l)), the top
//    layer leading, and forms for its units
//      dh_l(t) = g_l(t+1) * z_l(t+1) + gh_l(t+1) @ w_hh_l + gx_{l+1}(t) @ w_ih_{l+1}
//    from the buffers written in interval i-1 (the first term is kept by the
//    CTA; the top layer starts from the head's cotangent).  It then forms
//    gx_l(t) and gh_l(t), writes them to the (B, T, 3H) scratch in global
//    memory and into the next buffer of every CTA of the cluster through
//    distributed shared memory (cluster.map_shared_rank); one cluster barrier
//    ends the interval: T + n_layers - 1 of them (43 at the `state` shape);
//  * a CTA's warps are split between the layers by their multiply-adds, not
//    evenly (layer 0's products are 1,152 deep for 16 units at the `state`
//    shape, layer 1's 384 deep for 8), and each unit's sum over 4 rows is
//    split over a fixed group of S lanes and reduced by the forward's
//    shuffle reduce-scatter (row_sum, csrc/gru_cluster.cuh).  C, R, S and
//    the warp split follow from the widths alone, so a row's gate
//    cotangents do not depend on B or on its slot, and repeat bit for bit;
//  * the step's gates, previous state and carried term are loaded before the
//    products are issued, so their latency hides behind them;
//  * the weight and bias cotangents are contractions over the B*T rows of
//    gate cotangents, done afterwards by a tiled launch (gemm_tn_kernel) in
//    which one thread owns each output and sums in a fixed order: no
//    atomics, the same bits on every run.
// Padded rows of the last cluster run on clamped inputs and are never stored.
// All arithmetic is float32.  The kernels allocate nothing: the caller
// passes every scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "gru_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxFF = 8;
constexpr int kRows = 4;          // batch rows a head block
constexpr int kHeadThreads = 256;
constexpr int kWarps = 12;        // warps of a sweep CTA, split between the layers
constexpr int kThreads = 32 * kWarps;

// Row maps of the second operand of gemm_tn_kernel, over rows b*T + t.
constexpr int kRowsSame = 0;    // row r
constexpr int kRowsFlip = 1;    // b*T + (T-1-t): the window read backwards
constexpr int kRowsPrev = 2;    // r - 1, a zero row at t = 0: the previous h

struct HeadArgs {
  int B, T, n_ff, HL;
  const float* hlast;                // (B, T, HL): the top GRU layer's states
  int ff_in[kMaxFF], ff_out[kMaxFF];
  const float* ff_w[kMaxFF];         // (in, out)
  const float* ff_wt[kMaxFF];        // (out, in), torch layout
  const float* ff_b[kMaxFF];
  float* ff_act[kMaxFF];             // (B, in): each head layer's input
  float* ff_delta[kMaxFF];           // (B, out): each head layer's output cotangent
  const float* g;                    // (B, ff_out[n_ff-1])
  float* dtop;                       // (B, HL): the cotangent of the top layer's final state
};

struct BpttArgs {
  int B, T, n_layers;
  int H[kMaxLayers];
  const float* w_ih_t[kMaxLayers];   // (3H, in), torch layout
  const float* w_hh_t[kMaxLayers];   // (3H, H)
  const float* hseq[kMaxLayers];     // (B, T, H)
  const float* gates[kMaxLayers];    // (B, T, 4H): r | z | n | W_hn h + b_hn
  float* ggx[kMaxLayers];            // (B, T, 3H) gate cotangents, input side
  float* ggh[kMaxLayers];            // (B, T, 3H) gate cotangents, hidden side
  const float* dtop;                 // (B, H[n_layers-1]), from the head
};

// The sweep's launch plan (fiude_tpu_torch/ops/fused_gru_train.py::bptt_plan).
struct Plan {
  int cluster;                     // CTAs a cluster, C
  int rows;                        // batch rows a cluster, R (a multiple of 4)
  int units[kMaxLayers];           // hidden units a CTA, ceil(H_l / C)
  int resident;                    // loop weights in shared memory (else through L2)
};

// How a sweep CTA lays out its dynamic shared memory (float offsets) and
// splits its warps: fiude_tpu_torch/ops/fused_gru_train.py::bptt_smem_bytes
// and bptt_layer_warps mirror it.
struct Layout {
  int K[kMaxLayers];               // depth of layer l's products: 3H_l (+ 3H_{l+1})
  int buf[kMaxLayers];             // two [K_l][R] buffers: gh_l, then gx_{l+1}
  int carry[kMaxLayers];           // [U_l][R]: g * z of the CTA's units, the step before
  int w[kMaxLayers];               // resident slices [K_l][ld_l]: w_hh_l, then w_ih_{l+1}
  int ld[kMaxLayers];              // the slices' row stride
  int split[kMaxLayers];           // lanes a unit's sum is split over, S
  int first[kMaxLayers + 1];       // layer l runs on warps [first[l], first[l+1])
  int total;
};

// Warps by work: every layer gets one, then each further warp goes to the
// layer with the most multiply-adds a warp (the lowest layer on a tie).
void layer_warps(const long long* work, int n_layers, int* first) {
  int warps[kMaxLayers];
  for (int l = 0; l < n_layers; ++l) warps[l] = 1;
  for (int extra = kWarps - n_layers; extra > 0; --extra) {
    int best = 0;
    for (int l = 1; l < n_layers; ++l)
      if (work[l] * warps[best] > work[best] * warps[l]) best = l;
    ++warps[best];
  }
  first[0] = 0;
  for (int l = 0; l < n_layers; ++l) first[l + 1] = first[l] + warps[l];
}

Layout make_layout(const int* H, int n_layers, const Plan& p) {
  Layout s = {};
  const int RG = p.rows / 4;
  long long work[kMaxLayers];
  for (int l = 0; l < n_layers; ++l) {
    s.K[l] = 3 * H[l] + (l + 1 < n_layers ? 3 * H[l + 1] : 0);
    work[l] = (long long)p.units[l] * RG * s.K[l];
  }
  layer_warps(work, n_layers, s.first);
  long long at = 0;
  for (int l = 0; l < n_layers; ++l) {
    s.buf[l] = (int)at;
    at += 2LL * s.K[l] * p.rows;
  }
  for (int l = 0; l < n_layers; ++l) {
    s.carry[l] = (int)at;
    at += (long long)p.units[l] * p.rows;
  }
  for (int l = 0; l < n_layers; ++l) {
    s.split[l] = split_lanes(p.units[l] * RG, 32 * (s.first[l + 1] - s.first[l]));
    s.ld[l] = slice_stride(p.units[l], s.split[l], RG);
    s.w[l] = (int)at;
    if (p.resident) at += (long long)s.K[l] * s.ld[l];
  }
  s.total = at > kSmemLimit ? kSmemLimit + 1 : (int)at;   // past the limit: refused
  return s;
}

__device__ __forceinline__ void set_lane(float4& v, int r, float x) {
  if (r == 0) v.x = x; else if (r == 1) v.y = x; else if (r == 2) v.z = x; else v.w = x;
}

__device__ __forceinline__ void fma4(float4& acc, const float4& x, float w) {
  acc.x += x.x * w; acc.y += x.y * w; acc.z += x.z * w; acc.w += x.w * w;
}

// Load rows row0.. of a (B, W) matrix into buf [W][kRows]; rows past B repeat
// row B-1 (they are computed and never written back).
__device__ void load_rows(const float* __restrict__ src, int B, int W, int row0,
                          float4* buf) {
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    float4 v;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      set_lane(v, r, src[(size_t)min(row0 + r, B - 1) * W + j]);
    buf[j] = v;
  }
}

__device__ void store_rows(const float4* buf, int B, int W, int row0,
                           float* __restrict__ dst) {
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < B) dst[(size_t)(row0 + r) * W + j] = lane(buf[j], r);
  }
}

// out[k] = sum_j in[j] * Wt[j][k] for k < K, Wt (N, K) row-major.  A thread's
// chain waits on L2 (686 deep at the `state` head): 16 weight loads in flight.
__device__ void matvec_t(const float* __restrict__ Wt, const float4* in, int N, int K,
                         float4* out) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float4 acc = splat(0.f);
#pragma unroll 16
    for (int j = 0; j < N; ++j) fma4(acc, in[j], __ldg(Wt + (size_t)j * K + k));
    out[k] = acc;
  }
}

// The head's backward for kRows rows a block: its forward again from the top
// layer's final state (the activations are no input), then the cotangents
// down to that state.  Shared memory, all [width][kRows] float4: the head's
// inputs act[i] (ff_in[i]) and pre-activations pre[i] (ff_out[i], i < n_ff-1),
// two cotangent buffers (the widest head width) and the top state's
// cotangent (HL).
__global__ void __launch_bounds__(kHeadThreads)
bptt_head_kernel(HeadArgs a, int w_max) {
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int B = a.B, T = a.T, HL = a.HL;

  float4* p = smem;
  float4* act[kMaxFF];
  float4* pre[kMaxFF];
  for (int i = 0; i < a.n_ff; ++i) { act[i] = p; p += a.ff_in[i]; }
  for (int i = 0; i + 1 < a.n_ff; ++i) { pre[i] = p; p += a.ff_out[i]; }
  float4* da = p; p += w_max;
  float4* db = p; p += w_max;
  float4* top = p;

  for (int j = tid; j < HL; j += blockDim.x) {
    float4 v;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      set_lane(v, r, a.hlast[((size_t)min(row0 + r, B - 1) * T + T - 1) * HL + j]);
    act[0][j] = v;
  }
  __syncthreads();
  for (int i = 0; i + 1 < a.n_ff; ++i) {
    const int K = a.ff_in[i], N = a.ff_out[i];
    const bool relu = i + 1 <= a.n_ff - 2;   // layer i+1 reads ReLU(out)
    for (int j = tid; j < N; j += blockDim.x) {
      float4 acc = splat(a.ff_b[i][j]);
#pragma unroll 16
      for (int k = 0; k < K; ++k) fma4(acc, act[i][k], __ldg(a.ff_w[i] + (size_t)k * N + j));
      pre[i][j] = acc;
      if (relu) {
        acc.x = fmaxf(acc.x, 0.f); acc.y = fmaxf(acc.y, 0.f);
        acc.z = fmaxf(acc.z, 0.f); acc.w = fmaxf(acc.w, 0.f);
      }
      act[i + 1][j] = acc;
    }
    __syncthreads();
  }
  for (int i = 0; i < a.n_ff; ++i) store_rows(act[i], B, a.ff_in[i], row0, a.ff_act[i]);
  const int n_last = a.ff_out[a.n_ff - 1];
  load_rows(a.g, B, n_last, row0, da);
  __syncthreads();
  float4* d = da;
  float4* e = db;
  for (int i = a.n_ff - 1; i >= 0; --i) {
    store_rows(d, B, a.ff_out[i], row0, a.ff_delta[i]);
    float4* dst = i == 0 ? top : e;
    matvec_t(a.ff_wt[i], d, a.ff_out[i], a.ff_in[i], dst);
    if (i > 0 && i <= a.n_ff - 2) {          // ReLU sat before layer i
      for (int k = tid; k < a.ff_in[i]; k += blockDim.x) {
        const float4 h = pre[i - 1][k];
        float4 v = dst[k];
        v.x = h.x > 0.f ? v.x : 0.f; v.y = h.y > 0.f ? v.y : 0.f;
        v.z = h.z > 0.f ? v.z : 0.f; v.w = h.w > 0.f ? v.w : 0.f;
        dst[k] = v;
      }
    }
    __syncthreads();
    e = d;
    d = dst;
  }
  store_rows(top, B, HL, row0, a.dtop);
}

// Columns [unit0, unit0 + U) of W (K, H) row-major into the slice [K][ld]
// (zeros for units past H).
__device__ void load_columns(float* __restrict__ dst, const float* __restrict__ W, int K,
                             int H, int U, int ld, int unit0) {
  for (int i = threadIdx.x; i < K * U; i += kThreads) {
    const int k = i / U, u = i % U, unit = unit0 + u;
    dst[k * ld + u] = unit < H ? W[(size_t)k * H + unit] : 0.f;
  }
}

// acc (4 rows) += sum over k = s, s + S, ... < K of in[k] * W[k][u]: W the
// resident slice, or the global matrix offset by the CTA's first unit.
template <bool kResident>
__device__ __forceinline__ void partial_dot(const float* __restrict__ W, int ld,
                                            const float4* __restrict__ in, int RG, int rg,
                                            int K, int s, int S, int u, float4& acc) {
#pragma unroll 4
  for (int k = s; k < K; k += S) {
    const float4 x = in[k * RG + rg];
    float w;
    if constexpr (kResident) {
      w = W[k * ld + u];
    } else {
      w = __ldg(W + (size_t)k * ld + u);
    }
    fma4(acc, x, w);
  }
}

// One cluster of C CTAs runs R batch rows through the reverse sweep.  Shared
// memory: the Layout above.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
bptt_cluster_kernel(BpttArgs a, Plan p, Layout ly) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster, R = p.rows, RG = R / 4;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x) / C * R;
  const int tid = threadIdx.x;
  const int B = a.B, T = a.T, NL = a.n_layers;

  for (int i = tid; i < ly.carry[0]; i += kThreads) sm[i] = 0.f;   // every buffer
  for (int l = 0; l < NL; ++l) {     // the carried term: the head's cotangent at the top
    const int U = p.units[l], H = a.H[l];
    for (int i = tid; i < U * R; i += kThreads) {
      const int unit = rank * U + i / R, row = min(row0 + i % R, B - 1);
      sm[ly.carry[l] + i] = l == NL - 1 && unit < H ? a.dtop[(size_t)row * H + unit] : 0.f;
    }
  }
  if constexpr (kResident) {
    for (int l = 0; l < NL; ++l) {
      const int U = p.units[l], H = a.H[l];
      load_columns(sm + ly.w[l], a.w_hh_t[l], 3 * H, H, U, ly.ld[l], rank * U);
      if (l + 1 < NL)
        load_columns(sm + ly.w[l] + 3 * H * ly.ld[l], a.w_ih_t[l + 1], 3 * a.H[l + 1], H, U,
                     ly.ld[l], rank * U);
    }
  }
  cluster.sync();   // zeroed and loaded in every CTA before any remote write

  // A thread serves one layer, on the layer's run of warps, for the whole sweep.
  int l = 0;
  while (tid / 32 >= ly.first[l + 1]) ++l;
  const int lthreads = 32 * (ly.first[l + 1] - ly.first[l]), ltid = tid - 32 * ly.first[l];
  const int H = a.H[l], U = p.units[l], unit0 = rank * U;
  const int own = max(0, min(U, H - unit0));
  const int K = ly.K[l], KA = 3 * H;        // gh_l's rows, then gx_{l+1}'s
  float* buf = sm + ly.buf[l];              // [2][K][R]
  float* carry = sm + ly.carry[l];          // [U][R]
  // gx_l goes to rows 3H_{l-1} .. of layer l-1's buffers
  float* below = l > 0 ? sm + ly.buf[l - 1] + 3 * a.H[l - 1] * R : nullptr;
  const int Kbelow = l > 0 ? ly.K[l - 1] : 0;
  const float* wa;
  const float* wb;
  int ld;
  if constexpr (kResident) {
    wa = sm + ly.w[l];
    wb = wa + KA * ly.ld[l];
    ld = ly.ld[l];
  } else {
    wa = a.w_hh_t[l] + unit0;
    wb = l + 1 < NL ? a.w_ih_t[l + 1] + unit0 : nullptr;
    ld = H;
  }
  const float* hseq = a.hseq[l];
  const float* gates = a.gates[l];
  float* ggx = a.ggx[l];
  float* ggh = a.ggh[l];
  const int S = ly.split[l];
  const int s = ltid & (S - 1);
  const unsigned mask = group_mask(tid, S);

  // Reverse wavefront: in interval i layer l takes step t = T-1 - (i - (NL-1-l)),
  // reading gh_l(t+1) and gx_{l+1}(t), which the interval before wrote.
  for (int i = 0; i < T + NL - 1; ++i) {
    const int t = T - 1 - i + (NL - 1 - l);
    if (t >= 0 && t < T) {
      const int cur = i & 1, nxt = cur ^ 1;
      const float4* in = reinterpret_cast<const float4*>(buf + cur * K * R);
      float* gh_next = buf + nxt * K * R;
      float* gx_next = l > 0 ? below + nxt * Kbelow * R : nullptr;
      for (int pp = ltid / S; pp < U * RG; pp += lthreads / S) {
        const int u = pp / RG, rg = pp % RG;
        if (u >= own) continue;        // the whole group skips together
        const int unit = unit0 + u;
        const int slot = rg * 4 + (s & 3), row = row0 + slot;   // this lane's row
        const size_t at = (size_t)min(row, B - 1) * T + t;
        // the step's gates, the previous state and the carried term, loaded
        // while the products run
        const float* gt = gates + at * 4 * H + unit;
        const float rr = gt[0], z = gt[H], n = gt[2 * H], hn = gt[3 * H];
        const float hp = t > 0 ? hseq[(at - 1) * H + unit] : 0.f;
        const float c = carry[u * R + slot];
        float4 acc = splat(0.f);
        partial_dot<kResident>(wa, ld, in, RG, rg, KA, s, S, u, acc);
        if (K > KA) partial_dot<kResident>(wb, ld, in + KA * RG, RG, rg, K - KA, s, S, u, acc);
        const float gg = row_sum(acc, s, S, mask) + c;
        const float gz = gg * (hp - n) * z * (1.f - z);
        const float gn = gg * (1.f - z) * (1.f - n * n);
        const float gr = gn * hn * rr * (1.f - rr);
        const float ghn = gn * rr;
        __syncwarp(mask);              // every lane has read the carried term
        if (s < 4) {
          carry[u * R + slot] = gg * z;
          if (row < B) {
            const size_t o = at * 3 * H + unit;
            ggx[o] = gr;
            ggx[o + H] = gz;
            ggx[o + 2 * H] = gn;
            ggh[o] = gr;
            ggh[o + H] = gz;
            ggh[o + 2 * H] = ghn;
          }
        }
        // lanes s, s + 4, ... hold the same row: they share out the cluster's CTAs
        float* gh_at = gh_next + unit * R + slot;
        for (int q = s >> 2; q < C; q += S >> 2) {
          *cluster.map_shared_rank(gh_at, q) = gr;
          *cluster.map_shared_rank(gh_at + H * R, q) = gz;
          *cluster.map_shared_rank(gh_at + 2 * H * R, q) = ghn;
          if (l > 0) {
            float* gx_at = gx_next + unit * R + slot;
            *cluster.map_shared_rank(gx_at, q) = gr;
            *cluster.map_shared_rank(gx_at + H * R, q) = gz;
            *cluster.map_shared_rank(gx_at + 2 * H * R, q) = gn;
          }
        }
      }
    }
    cluster.sync();
  }
}

using SweepKernel = void (*)(BpttArgs, Plan, Layout);

SweepKernel sweep_kernel(bool resident) {
  return resident ? bptt_cluster_kernel<true> : bptt_cluster_kernel<false>;
}

// C (M, N) = A^T @ Bm: A (K, M) and Bm (K, N) row-major, Bm's rows read
// through `rows` (kRowsSame / kRowsFlip / kRowsPrev over rows b*T + t), or a
// column of ones when Bm is null (N = 1: column sums).  One thread owns each
// of a 4x4 patch of outputs and sums k in order: no atomics.
constexpr int TM = 64, TN = 64, TK = 16;

__global__ void __launch_bounds__(256)
gemm_tn_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
               float* __restrict__ C, int M, int N, int K, int rows, int T) {
  __shared__ float As[TK][TM];
  __shared__ float Bs[TK][TN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = tid; i < TK * TM; i += 256) {
      const int kk = i / TM, m = i % TM;
      const int gk = k0 + kk, gm = m0 + m;
      As[kk][m] = (gk < K && gm < M) ? A[(size_t)gk * M + gm] : 0.f;
    }
    for (int i = tid; i < TK * TN; i += 256) {
      const int kk = i / TN, n = i % TN;
      const int gk = k0 + kk, gn = n0 + n;
      float v = 0.f;
      if (gk < K && gn < N) {
        if (Bm == nullptr) {
          v = 1.f;
        } else {
          int src = gk;
          if (rows == kRowsFlip) src = (gk / T) * T + (T - 1 - gk % T);
          if (rows == kRowsPrev) src = gk % T == 0 ? -1 : gk - 1;
          v = src < 0 ? 0.f : Bm[(size_t)src * N + gn];
        }
      }
      Bs[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][ty * 4 + i];
        bv[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

cudaError_t gemm_tn(const float* A, const float* Bm, float* C, int M, int N, int K,
                    int rows, int T, cudaStream_t s) {
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  gemm_tn_kernel<<<grid, 256, 0, s>>>(A, Bm, C, M, N, K, rows, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// How many sweep clusters of `cluster` CTAs with `smem_bytes` each can run at
// once (cudaOccupancyMaxActiveClusters) in `active`.
int fused_backgru_bptt_max_active_clusters(int cluster, int smem_bytes, int resident,
                                           int* active) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const SweepKernel kernel = sweep_kernel(resident != 0);
  cudaError_t err = cluster_config(kernel, cluster, 1, kThreads, smem_bytes, nullptr, &attr,
                                   &cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
}

// x (B, T, I); per GRU layer l: w_ih_t (3H, in), w_hh_t (3H, H) in torch's
// layout, hseq (B, T, H) and gates (B, T, 4H) from the training forward,
// scratch ggx/ggh (B, T, 3H); per head layer i: ff_w (in, out), ff_wt
// (out, in), ff_b (out), scratch ff_act (B, in) and ff_delta (B, out); g
// (B, out_last) the head output's cotangent; scratch dtop (B, H[n_layers-1]).
// The sweep's plan (cluster, rows, units, smem_bytes, resident) is
// bptt_plan's; an inconsistent one returns cudaErrorInvalidValue, a cluster
// the card cannot hold cudaErrorInvalidConfiguration, before anything is
// launched.  Writes the cotangents g_w_ih (3H, in), g_w_hh (3H, H), g_b_ih,
// g_b_hh (3H), g_ff_w (out, in), g_ff_b (out), all overwritten.  Launches on
// `stream`: the head, the sweep, then the 14 contractions at the `state`
// shape (4 a GRU layer, 2 a head layer); returns the first error.
int fused_backgru_backward(const float* x, int B, int T, int I, int n_layers,
                           const int* H, const void* const* w_ih_t,
                           const void* const* w_hh_t, const void* const* hseq,
                           const void* const* gates, void* const* ggx,
                           void* const* ggh, int n_ff, const int* ff_out,
                           const void* const* ff_w, const void* const* ff_wt,
                           const void* const* ff_b, void* const* ff_act,
                           void* const* ff_delta, const float* g, float* dtop,
                           void* const* g_w_ih, void* const* g_w_hh,
                           void* const* g_b_ih, void* const* g_b_hh,
                           void* const* g_ff_w, void* const* g_ff_b, int cluster, int rows,
                           const int* units, int smem_bytes, int resident, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_ff < 1 || n_ff > kMaxFF ||
      B < 1 || T < 1 || I < 1 || cluster < 1 || cluster > kMaxCluster || rows < 4 ||
      rows % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BpttArgs a = {};
  Plan p = {};
  a.B = B; a.T = T; a.n_layers = n_layers;
  p.cluster = cluster;
  p.rows = rows;
  p.resident = resident != 0;
  for (int l = 0; l < n_layers; ++l) {
    if (H[l] < 1 || units[l] != (H[l] + cluster - 1) / cluster) return cudaErrorInvalidValue;
    a.H[l] = H[l];
    p.units[l] = units[l];
    a.w_ih_t[l] = static_cast<const float*>(w_ih_t[l]);
    a.w_hh_t[l] = static_cast<const float*>(w_hh_t[l]);
    a.hseq[l] = static_cast<const float*>(hseq[l]);
    a.gates[l] = static_cast<const float*>(gates[l]);
    a.ggx[l] = static_cast<float*>(ggx[l]);
    a.ggh[l] = static_cast<float*>(ggh[l]);
  }
  a.dtop = dtop;
  const Layout ly = make_layout(H, n_layers, p);
  if ((size_t)ly.total * sizeof(float) != (size_t)smem_bytes || smem_bytes > kSmemLimit)
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const SweepKernel kernel = sweep_kernel(p.resident);
  cudaError_t err = cluster_config(kernel, cluster, (B + rows - 1) / rows, kThreads,
                                   smem_bytes, s, &attr, &cfg);
  if (err != cudaSuccess) return err;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (active == 0) return cudaErrorInvalidConfiguration;

  HeadArgs h = {};
  h.B = B; h.T = T; h.n_ff = n_ff; h.HL = H[n_layers - 1];
  h.hlast = a.hseq[n_layers - 1];
  h.g = g;
  h.dtop = dtop;
  int w_max = 1, in = H[n_layers - 1];
  size_t floats4 = 0;
  for (int i = 0; i < n_ff; ++i) {
    h.ff_in[i] = in;
    h.ff_out[i] = ff_out[i];
    h.ff_w[i] = static_cast<const float*>(ff_w[i]);
    h.ff_wt[i] = static_cast<const float*>(ff_wt[i]);
    h.ff_b[i] = static_cast<const float*>(ff_b[i]);
    h.ff_act[i] = static_cast<float*>(ff_act[i]);
    h.ff_delta[i] = static_cast<float*>(ff_delta[i]);
    floats4 += in + (i + 1 < n_ff ? ff_out[i] : 0);
    w_max = in > w_max ? in : w_max;
    w_max = ff_out[i] > w_max ? ff_out[i] : w_max;
    in = ff_out[i];
  }
  floats4 += 2 * (size_t)w_max + H[n_layers - 1];
  const size_t head_smem = floats4 * sizeof(float4);
  err = cudaFuncSetAttribute(bptt_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)head_smem);
  if (err != cudaSuccess) return err;
  bptt_head_kernel<<<(B + kRows - 1) / kRows, kHeadThreads, head_smem, s>>>(h, w_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, a, p, ly);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();

  const int rows_bt = B * T;
  for (int l = 0; l < n_layers && err == cudaSuccess; ++l) {
    const int H3 = 3 * H[l];
    const float* below = l == 0 ? x : a.hseq[l - 1];
    const int in_l = l == 0 ? I : H[l - 1];
    err = gemm_tn(a.ggx[l], below, static_cast<float*>(g_w_ih[l]), H3, in_l, rows_bt,
                  l == 0 ? kRowsFlip : kRowsSame, T, s);
    if (err == cudaSuccess)
      err = gemm_tn(a.ggh[l], a.hseq[l], static_cast<float*>(g_w_hh[l]), H3, H[l], rows_bt,
                    kRowsPrev, T, s);
    if (err == cudaSuccess)
      err = gemm_tn(a.ggx[l], nullptr, static_cast<float*>(g_b_ih[l]), H3, 1, rows_bt,
                    kRowsSame, T, s);
    if (err == cudaSuccess)
      err = gemm_tn(a.ggh[l], nullptr, static_cast<float*>(g_b_hh[l]), H3, 1, rows_bt,
                    kRowsSame, T, s);
  }
  for (int i = 0; i < n_ff && err == cudaSuccess; ++i) {
    err = gemm_tn(h.ff_delta[i], h.ff_act[i], static_cast<float*>(g_ff_w[i]),
                  h.ff_out[i], h.ff_in[i], B, kRowsSame, T, s);
    if (err == cudaSuccess)
      err = gemm_tn(h.ff_delta[i], nullptr, static_cast<float*>(g_ff_b[i]),
                    h.ff_out[i], 1, B, kRowsSame, T, s);
  }
  return err;
}

}  // extern "C"
