// Back-GRU encoder backward (BPTT) for Hopper (sm_90a): kernel K4 of the
// training path.
//
// Replaces: fiude_tpu/ops/pallas_gru_train.py::_get_enc_train.bwd_impl (kernel
// body _make_bwd_kernel, pallas_gru_train.py:146-270): backprop of the ReLU
// head, then the reverse sweep t = T-1 .. 0 through the stacked GRU, giving
// the cotangent of every GRU and head weight and bias.  x is training data:
// no x cotangent is computed (pallas_gru_train.py:26-28).
//
// What bounds it on the card: the reverse sweep is T sequential steps, each
// two (rows x 3H) x (3H x H) products a layer (the recurrent and the
// below-layer cotangents).  As in K1 the weights (~3 MB at the `state`
// config) do not fit one block's 227 KB of shared memory, so each step
// streams them from L2, and the step time is that stream's latency.  The
// TPU kernel also accumulates the weight cotangents inside the sweep, in
// VMEM; on the card that would be ~740k accumulators a block, or float
// atomics across blocks, whose order (and so whose result) changes from run
// to run.
//
// What the design does about it:
//  * the forward (K3, csrc/fused_gru.cu) stored every layer's hidden state
//    and gate values, so the sweep recomputes nothing: per step and layer it
//    reads the gates, forms the gate cotangents, and runs two transposed
//    matrix-vector products for kRows batch rows a block (weights read in
//    torch's (out, in) layout, so the threads of a warp read consecutive
//    addresses);
//  * the head's backward runs in the same launch, before the sweep, for the
//    block's rows;
//  * the sweep writes each step's gate cotangents (B*T rows) to global
//    memory, and the weight and bias cotangents are contractions over those
//    B*T rows, done afterwards by a tiled launch (gemm_tn_kernel) in which
//    one thread owns each output and sums in a fixed order: no atomics, the
//    same bits on every run.
// All arithmetic is float32.  The kernels allocate nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxFF = 8;
constexpr int kRows = 4;        // batch rows per sweep block
constexpr int kThreads = 256;

// Row maps of the second operand of gemm_tn_kernel, over rows b*T + t.
constexpr int kRowsSame = 0;    // row r
constexpr int kRowsFlip = 1;    // b*T + (T-1-t): the window read backwards
constexpr int kRowsPrev = 2;    // r - 1, a zero row at t = 0: the previous h

struct BpttArgs {
  int B, T, n_layers, n_ff;
  int H[kMaxLayers];
  const float* w_ih_t[kMaxLayers];   // (3H, in), torch layout
  const float* w_hh_t[kMaxLayers];   // (3H, H)
  const float* hseq[kMaxLayers];     // (B, T, H)
  const float* gates[kMaxLayers];    // (B, T, 4H)
  float* ggx[kMaxLayers];            // (B, T, 3H) gate cotangents, input side
  float* ggh[kMaxLayers];            // (B, T, 3H) gate cotangents, hidden side
  int ff_in[kMaxFF], ff_out[kMaxFF];
  const float* ff_w[kMaxFF];         // (in, out)
  const float* ff_wt[kMaxFF];        // (out, in), torch layout
  const float* ff_b[kMaxFF];
  float* ff_act[kMaxFF];             // (B, in): each head layer's input
  float* ff_delta[kMaxFF];           // (B, out): each head layer's output cotangent
  const float* g;                    // (B, ff_out[n_ff-1])
};

__device__ __forceinline__ float4 splat(float v) { return make_float4(v, v, v, v); }

__device__ __forceinline__ float lane(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
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

// out[k] (+)= sum_j in[j] * Wt[j][k] for k < K, Wt (N, K) row-major.
__device__ void matvec_t(const float* __restrict__ Wt, const float4* in, int N, int K,
                         float4* out, bool accumulate) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float4 acc = accumulate ? out[k] : splat(0.f);
#pragma unroll 4
    for (int j = 0; j < N; ++j) fma4(acc, in[j], __ldg(Wt + (size_t)j * K + k));
    out[k] = acc;
  }
}

// Shared memory, all [width][kRows] float4: dh per layer, carry (H_max),
// sx and sh (3*H_max), the head's inputs act[i] (ff_in[i]) and
// pre-activations pre[i] (ff_out[i], i < n_ff-1), and two head cotangent
// buffers (the widest head width).
__global__ void __launch_bounds__(kThreads)
bptt_kernel(BpttArgs a, int h_max, int w_max) {
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int B = a.B, T = a.T, L = a.n_layers;

  float4* p = smem;
  float4* dh[kMaxLayers];
  for (int l = 0; l < L; ++l) { dh[l] = p; p += a.H[l]; }
  float4* carry = p; p += h_max;
  float4* sx = p; p += 3 * h_max;
  float4* sh = p; p += 3 * h_max;
  float4* act[kMaxFF];
  float4* pre[kMaxFF];
  for (int i = 0; i < a.n_ff; ++i) { act[i] = p; p += a.ff_in[i]; }
  for (int i = 0; i + 1 < a.n_ff; ++i) { pre[i] = p; p += a.ff_out[i]; }
  float4* da = p; p += w_max;
  float4* db = p;

  // ---- head: forward from the last layer's final state, then backward ----
  const int HL = a.H[L - 1];
  for (int j = tid; j < HL; j += blockDim.x) {
    float4 v;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      set_lane(v, r, a.hseq[L - 1][((size_t)min(row0 + r, B - 1) * T + T - 1) * HL + j]);
    act[0][j] = v;
  }
  __syncthreads();
  for (int i = 0; i + 1 < a.n_ff; ++i) {
    const int K = a.ff_in[i], N = a.ff_out[i];
    const bool relu = i + 1 <= a.n_ff - 2;   // layer i+1 reads ReLU(out)
    for (int j = tid; j < N; j += blockDim.x) {
      float4 acc = splat(a.ff_b[i][j]);
#pragma unroll 4
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
    float4* dst = i == 0 ? dh[L - 1] : e;
    matvec_t(a.ff_wt[i], d, a.ff_out[i], a.ff_in[i], dst, false);
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
  for (int l = 0; l + 1 < L; ++l)
    for (int j = tid; j < a.H[l]; j += blockDim.x) dh[l][j] = splat(0.f);
  __syncthreads();

  // ---- BPTT: steps t = T-1 .. 0, layers top down ----
  for (int t = T - 1; t >= 0; --t) {
    for (int l = L - 1; l >= 0; --l) {
      const int H = a.H[l];
      for (int j = tid; j < H; j += blockDim.x) {
        const float4 g = dh[l][j];
        float4 gx[3], gh[3], c;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const size_t at = (size_t)min(row0 + r, B - 1) * T + t;
          const float* gt = a.gates[l] + at * 4 * H;
          const float rr = gt[j], z = gt[H + j], n = gt[2 * H + j], hn = gt[3 * H + j];
          const float hp = t > 0 ? a.hseq[l][(at - 1) * H + j] : 0.f;
          const float gg = lane(g, r);
          const float gz = gg * (hp - n) * z * (1.f - z);
          const float gn = gg * (1.f - z) * (1.f - n * n);
          const float gr = gn * hn * rr * (1.f - rr);
          set_lane(gx[0], r, gr); set_lane(gx[1], r, gz); set_lane(gx[2], r, gn);
          set_lane(gh[0], r, gr); set_lane(gh[1], r, gz); set_lane(gh[2], r, gn * rr);
          set_lane(c, r, gg * z);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          sx[q * H + j] = gx[q];
          sh[q * H + j] = gh[q];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (row0 + r >= B) continue;
            const size_t at = ((size_t)(row0 + r) * T + t) * 3 * H + q * H + j;
            a.ggx[l][at] = lane(gx[q], r);
            a.ggh[l][at] = lane(gh[q], r);
          }
        }
        carry[j] = c;
      }
      __syncthreads();
      // dh_l for step t-1 = g * z + ggh @ W_hh; the layer below gets ggx @ W_ih
      for (int k = tid; k < H; k += blockDim.x) dh[l][k] = carry[k];
      matvec_t(a.w_hh_t[l], sh, 3 * H, H, dh[l], true);
      if (l > 0) matvec_t(a.w_ih_t[l], sx, 3 * H, a.H[l - 1], dh[l - 1], true);
      __syncthreads();
    }
  }
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

// x (B, T, I); per GRU layer l: w_ih_t (3H, in), w_hh_t (3H, H) in torch's
// layout, hseq (B, T, H) and gates (B, T, 4H) from the training forward,
// scratch ggx/ggh (B, T, 3H); per head layer i: ff_w (in, out), ff_wt
// (out, in), ff_b (out), scratch ff_act (B, in) and ff_delta (B, out); g
// (B, out_last) the head output's cotangent.  Writes the cotangents g_w_ih
// (3H, in), g_w_hh (3H, H), g_b_ih, g_b_hh (3H), g_ff_w (out, in), g_ff_b
// (out), all overwritten.  Launches on `stream`; returns cudaGetLastError().
int fused_backgru_backward(const float* x, int B, int T, int I, int n_layers,
                           const int* H, const void* const* w_ih_t,
                           const void* const* w_hh_t, const void* const* hseq,
                           const void* const* gates, void* const* ggx,
                           void* const* ggh, int n_ff, const int* ff_out,
                           const void* const* ff_w, const void* const* ff_wt,
                           const void* const* ff_b, void* const* ff_act,
                           void* const* ff_delta, const float* g,
                           void* const* g_w_ih, void* const* g_w_hh,
                           void* const* g_b_ih, void* const* g_b_hh,
                           void* const* g_ff_w, void* const* g_ff_b, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_ff < 1 || n_ff > kMaxFF ||
      B < 1 || T < 1 || I < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BpttArgs a = {};
  a.B = B; a.T = T; a.n_layers = n_layers; a.n_ff = n_ff;
  a.g = g;
  int h_max = 1;
  size_t floats4 = 0;
  for (int l = 0; l < n_layers; ++l) {
    a.H[l] = H[l];
    a.w_ih_t[l] = static_cast<const float*>(w_ih_t[l]);
    a.w_hh_t[l] = static_cast<const float*>(w_hh_t[l]);
    a.hseq[l] = static_cast<const float*>(hseq[l]);
    a.gates[l] = static_cast<const float*>(gates[l]);
    a.ggx[l] = static_cast<float*>(ggx[l]);
    a.ggh[l] = static_cast<float*>(ggh[l]);
    h_max = H[l] > h_max ? H[l] : h_max;
    floats4 += H[l];
  }
  int w_max = 1, in = H[n_layers - 1];
  for (int i = 0; i < n_ff; ++i) {
    a.ff_in[i] = in;
    a.ff_out[i] = ff_out[i];
    a.ff_w[i] = static_cast<const float*>(ff_w[i]);
    a.ff_wt[i] = static_cast<const float*>(ff_wt[i]);
    a.ff_b[i] = static_cast<const float*>(ff_b[i]);
    a.ff_act[i] = static_cast<float*>(ff_act[i]);
    a.ff_delta[i] = static_cast<float*>(ff_delta[i]);
    floats4 += in + (i + 1 < n_ff ? ff_out[i] : 0);
    w_max = in > w_max ? in : w_max;
    w_max = ff_out[i] > w_max ? ff_out[i] : w_max;
    in = ff_out[i];
  }
  floats4 += 7 * (size_t)h_max + 2 * (size_t)w_max;
  const size_t smem = floats4 * sizeof(float4);

  cudaError_t err = cudaFuncSetAttribute(
      bptt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bptt_kernel<<<(B + kRows - 1) / kRows, kThreads, smem, s>>>(a, h_max, w_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int rows = B * T;
  for (int l = 0; l < n_layers && err == cudaSuccess; ++l) {
    const int H3 = 3 * H[l];
    const float* below = l == 0 ? x : a.hseq[l - 1];
    const int in_l = l == 0 ? I : H[l - 1];
    err = gemm_tn(a.ggx[l], below, static_cast<float*>(g_w_ih[l]), H3, in_l, rows,
                  l == 0 ? kRowsFlip : kRowsSame, T, s);
    if (err == cudaSuccess)
      err = gemm_tn(a.ggh[l], a.hseq[l], static_cast<float*>(g_w_hh[l]), H3, H[l], rows,
                    kRowsPrev, T, s);
    if (err == cudaSuccess)
      err = gemm_tn(a.ggx[l], nullptr, static_cast<float*>(g_b_ih[l]), H3, 1, rows,
                    kRowsSame, T, s);
    if (err == cudaSuccess)
      err = gemm_tn(a.ggh[l], nullptr, static_cast<float*>(g_b_hh[l]), H3, 1, rows,
                    kRowsSame, T, s);
  }
  for (int i = 0; i < n_ff && err == cudaSuccess; ++i) {
    err = gemm_tn(a.ff_delta[i], a.ff_act[i], static_cast<float*>(g_ff_w[i]),
                  a.ff_out[i], a.ff_in[i], B, kRowsSame, T, s);
    if (err == cudaSuccess)
      err = gemm_tn(a.ff_delta[i], nullptr, static_cast<float*>(g_ff_b[i]),
                    a.ff_out[i], 1, B, kRowsSame, T, s);
  }
  return err;
}

}  // extern "C"
