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
// What bounds it on the card: the recurrence is T sequential steps of
// (rows x H) x (H x 3H) products.  At the `state` config (H = 256, 128) the
// weights are ~740k floats (3 MB): they cannot sit in one block's 227 KB of
// shared memory, so every step streams ~1.4 MB of recurrent weights from the
// 50 MB L2 into each block.  The work per step is small, so the step time is
// the L2 -> SM weight stream and its latency, not arithmetic.
//
// What the design does about it:
//  * the input projection for all B*T rows, which the TPU kernel computes in
//    its body (pallas_gru.py:82-85), is one tiled SGEMM launch
//    (sgemm_bias_kernel) ahead of the recurrence: it leaves the sequential
//    loop and runs at full width over the grid;
//  * the recurrence runs one block per kRows batch rows, with every layer's
//    hidden state in shared memory, looping over t and over layers inside the
//    block.  Each weight read from L2 feeds kRows rows (hidden states are
//    stored k-major, [H][kRows], so one 16-byte shared load serves all rows);
//  * thread j owns hidden unit j of a layer and computes its three gates, so
//    the gate math needs no exchange; weights are stored (in, out), so the
//    threads of a warp read consecutive addresses;
//  * the window is flipped by indexing (step t reads time T-1-t): no copy.
// All arithmetic is float32 (no TF32).  The kernel allocates nothing: the
// caller passes the projection scratch and the output.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxFF = 8;
constexpr int kRows = 4;        // batch rows per recurrence block
constexpr int kThreads = 256;

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

// acc[g][r] += sum_k in[k][r] * W[k][g*H + j] for the three gates g.
__device__ __forceinline__ void gate_matvec(const float* __restrict__ W, int K, int H,
                                           int j, const float4* in, float4 acc[3]) {
  const int H3 = 3 * H;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float* w = W + (size_t)k * H3 + j;
    const float wr = __ldg(w), wz = __ldg(w + H), wn = __ldg(w + 2 * H);
    const float4 x = in[k];
    acc[0].x += x.x * wr; acc[0].y += x.y * wr; acc[0].z += x.z * wr; acc[0].w += x.w * wr;
    acc[1].x += x.x * wz; acc[1].y += x.y * wz; acc[1].z += x.z * wz; acc[1].w += x.w * wz;
    acc[2].x += x.x * wn; acc[2].y += x.y * wn; acc[2].z += x.z * wn; acc[2].w += x.w * wn;
  }
}

__device__ __forceinline__ float4 splat(float v) { return make_float4(v, v, v, v); }

__device__ __forceinline__ float lane(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(float4& v, int r, float x) {
  if (r == 0) v.x = x; else if (r == 1) v.y = x; else if (r == 2) v.z = x; else v.w = x;
}

// Shared memory: per layer two hidden-state buffers [H][kRows] (current and
// next, swapped by step parity), then two head buffers [ff_max][kRows].
__global__ void __launch_bounds__(kThreads)
backgru_recurrence_kernel(const float* __restrict__ xproj, int B, int T,
                          GruArgs a, int ff_max, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;

  float4* hbuf[kMaxLayers];
  float4* ffbuf = smem;
  for (int l = 0; l < a.n_layers; ++l) {
    hbuf[l] = ffbuf;
    ffbuf += 2 * a.H[l];
  }

  for (int l = 0; l < a.n_layers; ++l)
    for (int i = tid; i < 2 * a.H[l]; i += blockDim.x) hbuf[l][i] = splat(0.f);
  __syncthreads();

  const int H0 = a.H[0];
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const int tt = T - 1 - t;      // time-reversed window
    for (int l = 0; l < a.n_layers; ++l) {
      const int H = a.H[l];
      const float4* hc = hbuf[l] + cur * H;
      float4* hn = hbuf[l] + nxt * H;
      for (int j = tid; j < H; j += blockDim.x) {
        const float* bh = a.b_hh[l];
        float4 gh[3] = {splat(bh[j]), splat(bh[H + j]), splat(bh[2 * H + j])};
        gate_matvec(a.w_hh[l], H, H, j, hc, gh);
        float4 gx[3];
        if (l == 0) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int row = min(row0 + r, B - 1);
            const float* xp = xproj + ((size_t)row * T + tt) * 3 * H0;
            set_lane(gx[0], r, xp[j]);
            set_lane(gx[1], r, xp[H0 + j]);
            set_lane(gx[2], r, xp[2 * H0 + j]);
          }
        } else {
          const float* bi = a.b_ih[l];
          gx[0] = splat(bi[j]); gx[1] = splat(bi[H + j]); gx[2] = splat(bi[2 * H + j]);
          const float4* below = hbuf[l - 1] + nxt * a.H[l - 1];
          gate_matvec(a.w_ih[l], a.H[l - 1], H, j, below, gx);
        }
        const float4 h = hc[j];
        float4 o;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float gr, gz, gn;
          set_lane(o, r, gru_update(lane(gx[0], r), lane(gx[1], r), lane(gx[2], r),
                                    lane(gh[0], r), lane(gh[1], r), lane(gh[2], r),
                                    lane(h, r), gr, gz, gn));
          if (a.hseq[l] != nullptr && row0 + r < B) {
            const size_t at = (size_t)(row0 + r) * T + t;
            a.hseq[l][at * H + j] = lane(o, r);
            float* g = a.gates[l] + at * 4 * H;
            g[j] = gr;
            g[H + j] = gz;
            g[2 * H + j] = gn;
            g[3 * H + j] = lane(gh[2], r);
          }
        }
        hn[j] = o;
      }
      __syncthreads();
    }
  }

  // ReLU head, reference ordering: ReLU before layers 1 .. n_ff-2 only.
  const int L = a.n_layers - 1;
  const float4* in = hbuf[L] + (T & 1) * a.H[L];
  int K = a.H[L];
  for (int i = 0; i < a.n_ff; ++i) {
    const int N = a.ff_out[i];
    const float* W = a.ff_w[i];
    const float* bias = a.ff_b[i];
    const bool last = i == a.n_ff - 1;
    const bool relu = i + 1 <= a.n_ff - 2;   // the next layer reads ReLU(out)
    float4* dst = ffbuf + (i & 1) * ff_max;
    for (int j = tid; j < N; j += blockDim.x) {
      float4 acc = splat(bias[j]);
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float w = __ldg(W + (size_t)k * N + j);
        const float4 x = in[k];
        acc.x += x.x * w; acc.y += x.y * w; acc.z += x.z * w; acc.w += x.w * w;
      }
      if (last) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (row0 + r < B) out[(size_t)(row0 + r) * N + j] = lane(acc, r);
      } else {
        if (relu) {
          acc.x = fmaxf(acc.x, 0.f); acc.y = fmaxf(acc.y, 0.f);
          acc.z = fmaxf(acc.z, 0.f); acc.w = fmaxf(acc.w, 0.f);
        }
        dst[j] = acc;
      }
    }
    __syncthreads();
    in = dst;
    K = N;
  }
}

}  // namespace

extern "C" {

// The message for a code the launchers below (and fused_ude.cu's) return.
const char* fiude_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, T, I) float32; weights (in, out) float32; xproj scratch (B*T, 3*H[0]);
// out (B, ff_out[n_ff-1]); hseq and gates null (serving, K1) or per layer
// (B, T, H[l]) and (B, T, 4*H[l]) (training forward, K3).  Launches on
// `stream`; returns cudaGetLastError().
int fused_backgru_forward(const float* x, int B, int T, int I, int n_layers,
                          const int* H, const void* const* w_ih,
                          const void* const* w_hh, const void* const* b_ih,
                          const void* const* b_hh, int n_ff, const int* ff_out,
                          const void* const* ff_w, const void* const* ff_b,
                          void* const* hseq, void* const* gates,
                          float* xproj, float* out, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_ff < 1 || n_ff > kMaxFF ||
      B < 1 || T < 1 || I < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GruArgs a = {};
  a.n_layers = n_layers;
  size_t floats4 = 0;
  for (int l = 0; l < n_layers; ++l) {
    a.H[l] = H[l];
    a.w_ih[l] = static_cast<const float*>(w_ih[l]);
    a.w_hh[l] = static_cast<const float*>(w_hh[l]);
    a.b_ih[l] = static_cast<const float*>(b_ih[l]);
    a.b_hh[l] = static_cast<const float*>(b_hh[l]);
    a.hseq[l] = hseq != nullptr ? static_cast<float*>(hseq[l]) : nullptr;
    a.gates[l] = hseq != nullptr ? static_cast<float*>(gates[l]) : nullptr;
    floats4 += 2 * (size_t)H[l];
  }
  a.n_ff = n_ff;
  int ff_max = 1;
  for (int i = 0; i < n_ff; ++i) {
    a.ff_out[i] = ff_out[i];
    a.ff_w[i] = static_cast<const float*>(ff_w[i]);
    a.ff_b[i] = static_cast<const float*>(ff_b[i]);
    if (i < n_ff - 1 && ff_out[i] > ff_max) ff_max = ff_out[i];
  }
  floats4 += 2 * (size_t)ff_max;
  const size_t smem = floats4 * sizeof(float4);

  const int M = B * T, N = 3 * H[0];
  dim3 ggrid((N + TN - 1) / TN, (M + TM - 1) / TM);
  sgemm_bias_kernel<<<ggrid, 256, 0, s>>>(x, a.w_ih[0], a.b_ih[0], xproj, M, N, I);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(backgru_recurrence_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kRows - 1) / kRows;
  backgru_recurrence_kernel<<<blocks, kThreads, smem, s>>>(xproj, B, T, a, ff_max, out);
  return cudaGetLastError();
}

}  // extern "C"
