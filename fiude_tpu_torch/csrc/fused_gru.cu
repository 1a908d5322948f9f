// Back-GRU encoder forward for Hopper (sm_90a): kernel K1 of the serving path,
// and K3, its training forward.
//
// Replaces: fiude_tpu/ops/pallas_gru.py::_fused_backgru (kernel body
// _make_kernel, pallas_gru.py:72-121), the one-launch TPU encoder: layer 0's
// input projection for every step, the stacked GRU recurrence over the
// time-reversed window, then the ReLU head with the reference ordering
// Linear, (ReLU, Linear)*, Linear.  Also replaces
// fiude_tpu/ops/pallas_gru_train.py::_get_enc_train.fwd_impl (K3), which
// runs the serving kernel unchanged under custom_vjp: here the same kernel,
// given the optional hseq/gates outputs, also stores every layer's hidden
// state and gate values (r, z, n and W_hn h + b_hn) at every step, which the
// backward (csrc/fused_gru_train.cu, K4) reads instead of re-running the
// 42-step forward sweep as the TPU backward does.  They cost 5 floats a
// hidden unit a step (~10 MB at the `state` shape) and save the backward a
// sequential sweep; serving passes null and writes nothing.
//
// What bounds it on the card: the recurrence is T x n_layers dependent
// layer-steps of (rows x H) x (H x 3H) products.  At the `state` config
// (B = 32, T = 42, H = 256, 128) a step is ~11 M multiply-adds, so the
// operations (0.03 ms for the whole call at 67 TFLOP/s) do not set the pace:
// the chain of dependent layer-steps does (84, or 43 barrier intervals with
// the wavefront below), each as long as one product's latency plus one
// exchange of the new hidden state.  The loop weights (w_hh of every
// layer, w_ih of layers >= 1: 1.376 MB there) are read at every step.
//
// What the design does about it:
//  * the input projection for all B*T rows, which the TPU kernel computes in
//    its body (pallas_gru.py:82-85), is one tiled SGEMM launch
//    (sgemm_bias_kernel) ahead of the recurrence: it leaves the sequential
//    loop and runs at full width over the grid;
//  * the recurrence runs on thread-block clusters (backgru_cluster_kernel):
//    a cluster of C CTAs takes R batch rows, and CTA c owns the hidden units
//    [c*U_l, (c+1)*U_l) of every layer l (U_l = ceil(H_l / C)).  With the
//    plan's `resident` flag a CTA copies its units' gate columns of w_hh and
//    w_ih (l >= 1) into shared memory once and keeps them there for all T
//    steps (1.376 MB / C at the `state` shape); otherwise, for an encoder too
//    wide for that, it reads the same slice through L2 at every step;
//  * every CTA keeps the full hidden state of its R rows for every layer,
//    double buffered, k-major ([H][R], one 16-byte load serves 4 rows).  The
//    CTA's warps are split between the layers, and the sweep runs as a
//    wavefront: in barrier interval i layer l takes step i - l, from its own
//    state of step i-l-1 and the layer below's of step i-l, both written in
//    interval i-1.  A layer-step computes the CTA's units from the local
//    copies and writes the new values into the next buffer of every CTA of
//    the cluster through distributed shared memory (cluster.map_shared_rank);
//    one cluster barrier (barrier.cluster arrive.release / wait.acquire) ends
//    the interval: T + n_layers - 1 barriers in all (43 at the `state` shape,
//    against 84 layer by layer).  A buffer written in interval i was last
//    read in interval i-1, so one barrier an interval suffices;
//  * a unit's three gate sums over the 4 rows of a row group are split over
//    a fixed group of S >= 4 consecutive lanes (split-K), then summed by
//    shuffles that first leave each lane one row (a reduce-scatter) and then
//    add across the lanes holding that row, so one lane computes one row's
//    gate; each output has one owner group, no atomics.  C, R and S follow
//    from the widths and the layer count, not from B, so a row's result does
//    not depend on B or on the cluster it lands in, and K3's outputs (and
//    K4's gradients) repeat bit for bit;
//  * a resident slice's rows are padded to a stride that puts the S k-rows
//    and the units of one warp load in 32 different shared-memory banks;
//  * the biases and layer 0's projection are read before the products are
//    issued, so their latency hides behind them;
//  * the ReLU head runs in the same kernel, each layer split by output
//    column across the cluster (one owner thread a column and row group, the
//    sum in reference order), its hidden layers exchanged like the states;
//  * the window is flipped by indexing (step t reads time T-1-t): no copy.
// Padded rows of the last cluster run on clamped inputs and are never stored.
// All arithmetic is float32 (no TF32).  The kernel allocates nothing: the
// caller passes the projection scratch and the output.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxFF = 8;
constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;          // with cudaFuncAttributeNonPortableClusterSizeAllowed
constexpr int kSmemLimit = 232448;       // dynamic shared memory a block can use

struct GruArgs {
  int n_layers;
  int H[kMaxLayers];
  const float* w_ih[kMaxLayers];   // (in, 3H), gate blocks r|z|n
  const float* w_hh[kMaxLayers];   // (H, 3H)
  const float* b_ih[kMaxLayers];   // (3H)
  const float* b_hh[kMaxLayers];   // (3H)
  int n_ff;
  int ff_out[kMaxFF];
  const float* ff_w[kMaxFF];       // (in, out)
  const float* ff_b[kMaxFF];
  float* hseq[kMaxLayers];         // optional (B, T, H): h after step t
  float* gates[kMaxLayers];        // optional (B, T, 4H): r | z | n | W_hn h + b_hn
};

// The launch plan (fiude_tpu_torch/ops/fused_gru.py::recurrence_plan).
struct Plan {
  int cluster;                     // CTAs a cluster, C
  int rows;                        // batch rows a cluster, R (a multiple of 4)
  int units[kMaxLayers];           // hidden units a CTA, ceil(H_l / C)
  int resident;                    // loop weights in shared memory (else through L2)
};

// How a CTA lays out its dynamic shared memory (float offsets) and splits
// its threads: fiude_tpu_torch/ops/fused_gru.py::plan_smem_bytes mirrors it.
struct Layout {
  int h[kMaxLayers];               // two [H_l][R] hidden-state buffers a layer
  int ff;                          // two [ff_max][R] head buffers
  int whh[kMaxLayers];             // resident slices [H_l][ld]
  int wih[kMaxLayers];             // resident slices [H_{l-1}][ld], l >= 1
  int ld[kMaxLayers];              // the slices' row stride
  int split[kMaxLayers];           // lanes a unit's sums are split over, S
  int total;
};

// The threads of layer l: a contiguous run of the block's warps, the runs'
// sizes differing by at most one warp.
__host__ __device__ int first_warp(int l, int n_layers) {
  return (l * (kThreads / 32) + n_layers - 1) / n_layers;
}

// S: the largest power of two from 4 to 32 with which the layer's (unit,
// row group) pairs fill its threads.
int split_lanes(int pairs, int threads) {
  int S = 4;
  while (S < 32 && pairs * S * 2 <= threads) S *= 2;
  return S;
}

// Row stride of a resident slice, at least its 3U gate columns.  One warp
// load reads S consecutive k (the split-K lanes) of nu = 32 / (S * R/4)
// consecutive units: a stride of nu times an odd number puts them in 32
// different banks.
int slice_stride(int U, int S, int RG) {
  const int nu = S * RG >= 32 ? 1 : 32 / (S * RG);
  int m = (3 * U + nu - 1) / nu;
  if (m % 2 == 0) ++m;
  return m * nu;
}

Layout make_layout(const int* H, int n_layers, int ff_max, const Plan& p) {
  Layout s = {};
  int at = 0;
  for (int l = 0; l < n_layers; ++l) {
    s.h[l] = at;
    at += 2 * H[l] * p.rows;
  }
  s.ff = at;
  at += 2 * ff_max * p.rows;
  for (int l = 0; l < n_layers; ++l) {
    const int threads = 32 * (first_warp(l + 1, n_layers) - first_warp(l, n_layers));
    s.split[l] = split_lanes(p.units[l] * p.rows / 4, threads);
    s.ld[l] = slice_stride(p.units[l], s.split[l], p.rows / 4);
    s.whh[l] = at;
    if (p.resident) at += H[l] * s.ld[l];
    s.wih[l] = at;
    if (p.resident && l > 0) at += H[l - 1] * s.ld[l];
  }
  s.total = at;
  return s;
}

// ---------------------------------------------------------------------------
// C[M, N] = A[M, K] @ B[K, N] + bias[N]; 64x64 tiles, 4x4 outputs a thread.
// ---------------------------------------------------------------------------
constexpr int TM = 64, TN = 64, TK = 16;

__global__ void __launch_bounds__(256)
sgemm_bias_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ bias, float* __restrict__ C,
                  int M, int N, int K) {
  __shared__ float As[TK][TM + 1];
  __shared__ float Bs[TK][TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = tid; i < TM * TK; i += 256) {
      const int m = i / TK, k = i % TK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < TK * TN; i += 256) {
      const int k = i / TN, n = i % TN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? Bm[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty * 4 + i];
        b[i] = Bs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
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
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j] + bias[gn];
    }
  }
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// One unit's GRU update; r, z, n are returned for the training forward.
__device__ __forceinline__ float gru_update(float xr, float xz, float xn, float hr,
                                            float hz, float hn, float h, float& r,
                                            float& z, float& n) {
  r = sigmoidf(xr + hr);
  z = sigmoidf(xz + hz);
  n = tanhf(xn + r * hn);
  return (1.f - z) * n + z * h;
}

__device__ __forceinline__ float4 splat(float v) { return make_float4(v, v, v, v); }

__device__ __forceinline__ float lane(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// Gate g of owned unit u at input row k of a layer's loop weights: the
// resident slice [k][g*U + u], or the global (in, 3H) matrix through L2.
template <bool kResident>
struct SliceWeights {
  const float* base;   // the slice, or the matrix offset by the CTA's first unit
  int ld;              // row stride
  int gs;              // gate stride: U, or H
  __device__ __forceinline__ float operator()(int k, int g, int u) const {
    if constexpr (kResident) {
      return base[k * ld + g * gs + u];
    } else {
      return __ldg(base + (size_t)k * ld + g * gs + u);
    }
  }
};

// Copy the gate columns of units [unit0, unit0 + U) of W (K, 3H) into the
// slice [K][ld] (zeros for units past H).
__device__ void load_slice(float* __restrict__ dst, const float* __restrict__ W, int K, int H,
                           int U, int ld, int unit0) {
  const int cols = 3 * U;
  for (int i = threadIdx.x; i < K * cols; i += kThreads) {
    const int k = i / cols, c = i % cols, g = c / U, unit = unit0 + c % U;
    dst[k * ld + c] = unit < H ? W[(size_t)k * 3 * H + g * H + unit] : 0.f;
  }
}

// acc[g] (4 rows) += sum over k = s, s + S, ... < K of in[k] * W(k, g, u).
template <bool kResident>
__device__ __forceinline__ void partial_gates(const SliceWeights<kResident>& W,
                                              const float4* __restrict__ in, int RG, int rg,
                                              int K, int s, int S, int u, float4 acc[3]) {
#pragma unroll 4
  for (int k = s; k < K; k += S) {
    const float4 x = in[k * RG + rg];
    const float wr = W(k, 0, u), wz = W(k, 1, u), wn = W(k, 2, u);
    acc[0].x += x.x * wr; acc[0].y += x.y * wr; acc[0].z += x.z * wr; acc[0].w += x.w * wr;
    acc[1].x += x.x * wz; acc[1].y += x.y * wz; acc[1].z += x.z * wz; acc[1].w += x.w * wz;
    acc[2].x += x.x * wn; acc[2].y += x.y * wn; acc[2].z += x.z * wn; acc[2].w += x.w * wn;
  }
}

// The three gate sums of row s & 3 of a row group, summed over the S lanes
// of an aligned group (S >= 4): two halving steps leave each lane one row
// (a reduce-scatter), the rest add across the lanes that hold the same row.
// Every step adds the same two partial sums, in one order or the other, so a
// row's sum has one tree whatever its slot, and the lanes that hold it agree
// bit for bit.
__device__ __forceinline__ void row_sums(const float4 v[3], int s, int S, unsigned mask,
                                         float out[3]) {
  const bool odd = s & 1, hi = s & 2;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float lo2 = (odd ? v[g].y : v[g].x) + __shfl_xor_sync(mask, odd ? v[g].x : v[g].y, 1);
    const float hi2 = (odd ? v[g].w : v[g].z) + __shfl_xor_sync(mask, odd ? v[g].z : v[g].w, 1);
    out[g] = (hi ? hi2 : lo2) + __shfl_xor_sync(mask, hi ? lo2 : hi2, 2);
    for (int m = 4; m < S; m <<= 1) out[g] += __shfl_xor_sync(mask, out[g], m);
  }
}

// One cluster of C CTAs runs R batch rows through the whole recurrence and
// the head.  Shared memory: the Layout above.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
backgru_cluster_kernel(const float* __restrict__ xproj, int B, int T, GruArgs a, Plan p,
                       Layout ly, int ff_max, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster, R = p.rows, RG = R / 4;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x) / C * R;
  const int tid = threadIdx.x;
  const int H0 = a.H[0];

  for (int i = tid; i < ly.ff; i += kThreads) sm[i] = 0.f;   // every h buffer
  if constexpr (kResident) {
    for (int l = 0; l < a.n_layers; ++l) {
      const int U = p.units[l];
      load_slice(sm + ly.whh[l], a.w_hh[l], a.H[l], a.H[l], U, ly.ld[l], rank * U);
      if (l > 0)
        load_slice(sm + ly.wih[l], a.w_ih[l], a.H[l - 1], a.H[l], U, ly.ld[l], rank * U);
    }
  }
  cluster.sync();   // zeroed and loaded in every CTA before any remote write

  // The warps are split between the layers (contiguous runs whose sizes differ
  // by at most one); a thread serves one layer for the whole sweep.
  const int NL = a.n_layers, l = tid / 32 * NL / (kThreads / 32);
  const int first = first_warp(l, NL);
  const int lthreads = (first_warp(l + 1, NL) - first) * 32, ltid = tid - first * 32;
  const int H = a.H[l], U = p.units[l], unit0 = rank * U;
  const int own = max(0, min(U, H - unit0));
  const int Kin = l > 0 ? a.H[l - 1] : 0;
  float* hbuf = sm + ly.h[l];                        // [2][H][R]
  const float* hbelow = sm + ly.h[l > 0 ? l - 1 : 0];
  SliceWeights<kResident> whh, wih;
  if constexpr (kResident) {
    whh = {sm + ly.whh[l], ly.ld[l], U};
    wih = {sm + ly.wih[l], ly.ld[l], U};
  } else {
    whh = {a.w_hh[l] + unit0, 3 * H, H};
    wih = {a.w_ih[l] + unit0, 3 * H, H};
  }
  const float* bhh = a.b_hh[l];
  const float* bih = a.b_ih[l];
  float* hseq = a.hseq[l];
  float* gates = a.gates[l];
  const int S = ly.split[l];
  const int s = ltid & (S - 1);
  const unsigned mask = S == 32 ? 0xffffffffu : ((1u << S) - 1u) << ((tid & 31) & ~(S - 1));

  // Wavefront: in interval i layer l takes step t = i - l, reading h_l(t-1)
  // and h_{l-1}(t), which the interval before wrote; one barrier an interval.
  for (int i = 0; i < T + NL - 1; ++i) {
    const int t = i - l;
    if (t >= 0 && t < T) {
      const int cur = t & 1, nxt = cur ^ 1;
      const float4* hc = reinterpret_cast<const float4*>(hbuf + cur * H * R);
      float* hn = hbuf + nxt * H * R;
      const float4* below = reinterpret_cast<const float4*>(hbelow + nxt * Kin * R);
      for (int pp = ltid / S; pp < U * RG; pp += lthreads / S) {
        const int u = pp / RG, rg = pp % RG;
        if (u >= own) continue;        // the whole group skips together
        const int unit = unit0 + u;
        const int slot = rg * 4 + (s & 3), row = row0 + slot;   // this lane's row
        // the biases and layer 0's projection, loaded while the products run
        float sh[3] = {bhh[unit], bhh[H + unit], bhh[2 * H + unit]};
        float sx[3];
        if (l == 0) {
          const float* xp = xproj + ((size_t)min(row, B - 1) * T + T - 1 - t) * 3 * H0 + unit;
          sx[0] = xp[0];
          sx[1] = xp[H0];
          sx[2] = xp[2 * H0];
        } else {
          sx[0] = bih[unit];
          sx[1] = bih[H + unit];
          sx[2] = bih[2 * H + unit];
        }
        float4 gh[3] = {splat(0.f), splat(0.f), splat(0.f)};
        float4 gx[3] = {splat(0.f), splat(0.f), splat(0.f)};
        partial_gates(whh, hc, RG, rg, H, s, S, u, gh);
        if (l > 0) partial_gates(wih, below, RG, rg, Kin, s, S, u, gx);
        float sums[3];
        row_sums(gh, s, S, mask, sums);
#pragma unroll
        for (int g = 0; g < 3; ++g) sh[g] += sums[g];
        if (l > 0) {
          row_sums(gx, s, S, mask, sums);
#pragma unroll
          for (int g = 0; g < 3; ++g) sx[g] += sums[g];
        }
        float gr, gz, gn;
        const float o = gru_update(sx[0], sx[1], sx[2], sh[0], sh[1], sh[2],
                                   hbuf[cur * H * R + unit * R + slot], gr, gz, gn);
        if (hseq != nullptr && s < 4 && row < B) {
          const size_t at = (size_t)row * T + t;
          hseq[at * H + unit] = o;
          float* gt = gates + at * 4 * H;
          gt[unit] = gr;
          gt[H + unit] = gz;
          gt[2 * H + unit] = gn;
          gt[3 * H + unit] = sh[2];
        }
        // lanes s, s + 4, ... hold the same row: they share out the cluster's CTAs
        for (int q = s >> 2; q < C; q += S >> 2) *cluster.map_shared_rank(hn + unit * R + slot, q) = o;
      }
    }
    cluster.sync();
  }

  // ReLU head, reference ordering: ReLU before layers 1 .. n_ff-2 only.  Each
  // layer's columns are split across the cluster; hidden layers are exchanged.
  const int L = a.n_layers - 1;
  const float4* in = reinterpret_cast<const float4*>(sm + ly.h[L] + (T & 1) * a.H[L] * R);
  int K = a.H[L];
  for (int i = 0; i < a.n_ff; ++i) {
    const int N = a.ff_out[i], Uh = (N + C - 1) / C, j0 = rank * Uh;
    const int owned = max(0, min(Uh, N - j0));
    const float* W = a.ff_w[i];
    const float* bias = a.ff_b[i];
    const bool last = i == a.n_ff - 1;
    const bool relu = i + 1 <= a.n_ff - 2;   // the next layer reads ReLU(out)
    float4* dst = reinterpret_cast<float4*>(sm + ly.ff + (i & 1) * ff_max * R);
    for (int pp = tid; pp < owned * RG; pp += kThreads) {
      const int j = j0 + pp / RG, rg = pp % RG;
      float4 acc = splat(bias[j]);
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float w = __ldg(W + (size_t)k * N + j);
        const float4 x = in[k * RG + rg];
        acc.x += x.x * w; acc.y += x.y * w; acc.z += x.z * w; acc.w += x.w * w;
      }
      if (last) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = row0 + rg * 4 + r;
          if (row < B) out[(size_t)row * N + j] = lane(acc, r);
        }
      } else {
        if (relu) {
          acc.x = fmaxf(acc.x, 0.f); acc.y = fmaxf(acc.y, 0.f);
          acc.z = fmaxf(acc.z, 0.f); acc.w = fmaxf(acc.w, 0.f);
        }
        for (int q = 0; q < C; ++q) *cluster.map_shared_rank(dst + j * RG + rg, q) = acc;
      }
    }
    if (!last) cluster.sync();
    in = dst;
    K = N;
  }
}

using ClusterKernel = void (*)(const float*, int, int, GruArgs, Plan, Layout, int, float*);

ClusterKernel cluster_kernel(bool resident) {
  return resident ? backgru_cluster_kernel<true> : backgru_cluster_kernel<false>;
}

// The cluster launch of `kernel` with `smem` bytes a CTA, attributes set.
cudaError_t cluster_config(ClusterKernel kernel, int cluster, int n_clusters, int smem,
                           cudaStream_t s, cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(n_clusters * cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The message for a code the launchers below (and fused_ude.cu's) return.
const char* fiude_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// How many clusters of `cluster` CTAs with `smem_bytes` each can run at once
// (cudaOccupancyMaxActiveClusters) in `active`.
int fused_backgru_max_active_clusters(int cluster, int smem_bytes, int resident, int* active) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const ClusterKernel kernel = cluster_kernel(resident != 0);
  cudaError_t err = cluster_config(kernel, cluster, 1, smem_bytes, nullptr, &attr, &cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
}

// x (B, T, I) float32; weights (in, out) float32; xproj scratch (B*T, 3*H[0]);
// out (B, ff_out[n_ff-1]); hseq and gates null (serving, K1) or per layer
// (B, T, H[l]) and (B, T, 4*H[l]) (training forward, K3).  The plan (cluster,
// rows, units, smem_bytes, resident) is recurrence_plan's; an inconsistent
// one returns cudaErrorInvalidValue, a cluster the card cannot hold
// cudaErrorInvalidConfiguration.  Launches on `stream`; returns the first
// error of the launches.
int fused_backgru_forward(const float* x, int B, int T, int I, int n_layers,
                          const int* H, const void* const* w_ih,
                          const void* const* w_hh, const void* const* b_ih,
                          const void* const* b_hh, int n_ff, const int* ff_out,
                          const void* const* ff_w, const void* const* ff_b,
                          void* const* hseq, void* const* gates, int cluster, int rows,
                          const int* units, int smem_bytes, int resident,
                          float* xproj, float* out, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_ff < 1 || n_ff > kMaxFF ||
      B < 1 || T < 1 || I < 1 || cluster < 1 || cluster > kMaxCluster || rows < 4 ||
      rows % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GruArgs a = {};
  Plan p = {};
  a.n_layers = n_layers;
  p.cluster = cluster;
  p.rows = rows;
  p.resident = resident != 0;
  for (int l = 0; l < n_layers; ++l) {
    if (H[l] < 1 || units[l] != (H[l] + cluster - 1) / cluster) return cudaErrorInvalidValue;
    a.H[l] = H[l];
    p.units[l] = units[l];
    a.w_ih[l] = static_cast<const float*>(w_ih[l]);
    a.w_hh[l] = static_cast<const float*>(w_hh[l]);
    a.b_ih[l] = static_cast<const float*>(b_ih[l]);
    a.b_hh[l] = static_cast<const float*>(b_hh[l]);
    a.hseq[l] = hseq != nullptr ? static_cast<float*>(hseq[l]) : nullptr;
    a.gates[l] = hseq != nullptr ? static_cast<float*>(gates[l]) : nullptr;
  }
  a.n_ff = n_ff;
  int ff_max = 1;
  for (int i = 0; i < n_ff; ++i) {
    a.ff_out[i] = ff_out[i];
    a.ff_w[i] = static_cast<const float*>(ff_w[i]);
    a.ff_b[i] = static_cast<const float*>(ff_b[i]);
    if (i < n_ff - 1 && ff_out[i] > ff_max) ff_max = ff_out[i];
  }
  const Layout ly = make_layout(H, n_layers, ff_max, p);
  if ((size_t)ly.total * sizeof(float) != (size_t)smem_bytes || smem_bytes > kSmemLimit)
    return cudaErrorInvalidValue;

  const int M = B * T, N = 3 * H[0];
  dim3 ggrid((N + TN - 1) / TN, (M + TM - 1) / TM);
  sgemm_bias_kernel<<<ggrid, 256, 0, s>>>(x, a.w_ih[0], a.b_ih[0], xproj, M, N, I);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const ClusterKernel kernel = cluster_kernel(p.resident);
  err = cluster_config(kernel, cluster, (B + rows - 1) / rows, smem_bytes, s, &attr, &cfg);
  if (err != cudaSuccess) return err;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (active == 0) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(xproj), B, T, a, p, ly,
                           ff_max, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
