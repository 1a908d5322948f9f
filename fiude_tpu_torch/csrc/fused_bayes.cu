// The Bayes (mean-field variational) families' serving trajectory for Hopper
// (sm_90a): kernel K7, and the weight draw that K7, K8 and K9 share.
//
// Replaces: fiude_tpu/ops/pallas_bayes.py::fused_bayes_trajectory_decode
// (kernel body _make_bayes_kernel, pallas_bayes.py:103-230): K2's T-1 Kutta
// 3/8 steps and per-step decode with effective weights w = mean + z * |std|
// drawn fresh on each of the 4(T-1) RHS evaluations, one draw shared by every
// row of the folded ensemble, and the frozen tail's first-layer product on
// every evaluation (the first layer is resampled, so it cannot be hoisted,
// pallas_bayes.py:29-31).
//
// Where the noise is made.  The TPU kernel materializes the effective
// weights inside every batch-tile program from the on-core generator; its
// tiles are 1024 rows, so the draw is small beside the products.  On the
// card a block holds 16 rows: were every block to draw all P = 73,493
// normals itself per evaluation (the `state` config), ~100 integer and
// transcendental operations a weight would stand against 16 multiply-adds a
// weight, 128 blocks over, and the 294 KB of effective weights do not fit a
// block's shared memory beside its state.  The noise is shared by all rows,
// so it is drawn ONCE for all blocks: bayes_draw_kernel writes the effective
// weights of every evaluation (E, P) to global memory (and, for training,
// their transposes and the noise z itself), launched by the same wrapper on
// the same stream; the trajectory kernel is then K2's loop (fused_ude.cuh
// with kBayes) with the weight base moved by P floats an evaluation and the
// tail product inside the loop.  Cost: one more launch and E * P floats (99 MB
// for a request of 85 daily points, 8 MB for a training step of 8 weekly
// points), read back through L2 by blocks that walk the evaluations nearly in
// step.
//
// What bounds K7 on the card: float32 arithmetic, as K2, with 392 x 128
// instead of 147 x 128 multiply-adds a row in the first layer (72,960
// multiply-adds a row an evaluation against K2's 41,600), and the L2 rate:
// every block reads each evaluation's 294 KB (147 KB in bfloat16) into shared
// memory, 12.6 GB a request of 128 blocks.  K7 streams them through two
// shared-memory stages with cp.async (fused_ude.cuh), the next chunk in
// flight while the current one is read; the first layer is one pass over
// [head | tail], 392 deep (the tail's rows follow the head's in the packed
// buffer).  The buffer's evaluations start at any 4-byte (bfloat16: 2-byte)
// boundary, so each row is copied in the widest units its address allows,
// a bfloat16 row from the word that holds its first element.

// The draw is Philox4x32-10 + Box-Muller (philox.cuh), a pure function of
// (seed, evaluation, packed array, element): the same bits for every block,
// in the backward as in the forward, and in the plain PyTorch version
// (ops/philox.py).  In injected-noise mode (tests) z is read from a buffer
// (E, P) instead.
//
// The bfloat16 compute mode (compute_dtype="bfloat16", pallas_bayes.py:105-113:
// the effective weight is formed in float32, then rounded): the draw rounds
// every effective weight once, writing a bfloat16 buffer (E, P) in place of
// the float32 one (half the bytes K7 then reads) and the biases, which stay
// float32, into a compact buffer (E, PB) of their own; K7 runs fused_ude.cuh
// with kBf16.

#include "fused_ude.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxArrays = 3 + 4 * kMaxDeep;   // w0_head, w0_tail, b0, (w, b) per later layer

struct Packed {           // the packed arrays, end to end
  int n;
  int off[kMaxArrays + 1];
  int rows[kMaxArrays];   // a bias is one row
  int cols[kMaxArrays];
  int boff[kMaxArrays];   // a bias's offset among the biases, -1 for a matrix
  int PB;                 // floats of all biases
};

// b0 is array 2, and every later layer is a (w, b) pair from array 3 on.
__host__ __device__ inline bool is_bias(int k) { return k == 2 || (k >= 3 && (k - 3) % 2 == 1); }

// w[e][p] = mean[p] + z * std[p] with z = noise[e][p] or the Philox normal of
// (seed, e, array, element); every output is optional: w (E, P) float32; wt
// each matrix transposed in its own slot; zout keeps z for the backward; wb
// (E, P) the same weights rounded to bfloat16 with the biases in float32 in
// bias (E, PB).
__global__ void bayes_draw_kernel(const float* __restrict__ mean, const float* __restrict__ stdabs,
                                  const float* __restrict__ noise, unsigned long long seed,
                                  int P, Packed pk, float* __restrict__ w,
                                  float* __restrict__ wt, float* __restrict__ zout,
                                  __nv_bfloat16* __restrict__ wb, float* __restrict__ bias) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int e = blockIdx.y;
  if (p >= P) return;
  int k = 0;
  while (k + 1 < pk.n && p >= pk.off[k + 1]) ++k;
  const int i = p - pk.off[k];
  const size_t base = (size_t)e * P;
  const float z = noise != nullptr ? noise[base + p]
                                   : philox::normal(seed, (uint32_t)e, (uint32_t)k, (uint32_t)i);
  const float v = mean[p] + z * stdabs[p];
  if (w != nullptr) w[base + p] = v;
  if (zout != nullptr) zout[base + p] = z;
  if (wb != nullptr) {
    wb[base + p] = __float2bfloat16_rn(v);
    if (pk.boff[k] >= 0) bias[(size_t)e * pk.PB + pk.boff[k] + i] = v;
  }
  if (wt != nullptr) {
    const int r = i / pk.cols[k], c = i % pk.cols[k];
    wt[base + pk.off[k] + (size_t)c * pk.rows[k] + r] = v;
  }
}

// Offsets of a field's packed arrays (w0_head, w0_tail, b0, then each later
// (w, b) of the rates net, then of the Fa net); returns P.
size_t packed_offsets(int R, int DT, int N0, int n0_fp, int n_fp, const int* fp_out, int n_aug,
                      const int* aug_out, size_t* w_off, size_t* b_off) {
  size_t off = (size_t)3 * R * N0 + (size_t)DT * N0 + N0;
  int in = n0_fp, q = 0;
  for (int d = 0; d < n_fp; ++d, ++q) {
    w_off[q] = off; off += (size_t)in * fp_out[d];
    b_off[q] = off; off += fp_out[d];
    in = fp_out[d];
  }
  in = N0 - n0_fp;
  for (int d = 0; d < n_aug; ++d, ++q) {
    w_off[q] = off; off += (size_t)in * aug_out[d];
    b_off[q] = off; off += aug_out[d];
    in = aug_out[d];
  }
  return off;
}

}  // namespace

extern "C" {

// The effective weights of E evaluations.  mean, stdabs (P): the packed
// arrays end to end, n_arr of them with rows[k] x cols[k] elements; noise
// (E, P) or null (then Philox from `seed`); writes, each unless null, w (E, P),
// wt (E, P), z (E, P), and for the bfloat16 compute mode wb (E, P) bfloat16
// with bias (E, PB) float32, PB the total length of the bias arrays (b0, then
// each later layer's).  Launches on `stream`; returns cudaGetLastError().
int fused_bayes_draw(const float* mean, const float* stdabs, const float* noise,
                     unsigned long long seed, int E, int P, int n_arr, const int* rows,
                     const int* cols, float* w, float* wt, float* z, void* wb, float* bias,
                     void* stream) {
  if (E < 1 || E > 65535 || P < 1 || n_arr < 1 || n_arr > kMaxArrays ||
      (wb != nullptr) != (bias != nullptr))
    return cudaErrorInvalidValue;
  Packed pk = {};
  pk.n = n_arr;
  for (int k = 0; k < n_arr; ++k) {
    if (rows[k] < 0 || cols[k] < 1) return cudaErrorInvalidValue;
    pk.rows[k] = rows[k];
    pk.cols[k] = cols[k];
    pk.off[k + 1] = pk.off[k] + rows[k] * cols[k];
    pk.boff[k] = -1;
    if (is_bias(k)) { pk.boff[k] = pk.PB; pk.PB += cols[k]; }
  }
  if (pk.off[n_arr] != P) return cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((P + threads - 1) / threads, E);
  bayes_draw_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      mean, stdabs, noise, seed, P, pk, w, wt, z, static_cast<__nv_bfloat16*>(wb), bias);
  return cudaGetLastError();
}

// K7.  zh0 (B, 3R) region-major head; ztail (B, DT); weff (4(T-1), P) from
// fused_bayes_draw, each evaluation's packed arrays ((in, out) weights);
// decoder (3R, R_out); out (T, B, R_out).  With bias != null (the bfloat16
// compute mode) weff is the draw's bfloat16 buffer and bias (4(T-1), PB) its
// float32 biases.  plan (plan_len ints): ops/fused_ude.py::TrajectoryPlan.flat()
// of a K7 plan, refused (cudaErrorInvalidValue) where read_plan finds that the
// kernel cannot run it.  Launches on `stream`; returns cudaGetLastError().
int fused_bayes_trajectory(const float* zh0, const float* ztail, int B, int T, float dt,
                           float fa_w, int R, int DT, int N0, int n0_fp, int R_out,
                           const void* weff, int P, int n_fp, const int* fp_out, int n_aug,
                           const int* aug_out, const void* dec_w, const void* dec_b,
                           float* out, const float* bias, const int* plan, int plan_len,
                           void* stream) {
  if (B < 1 || T < 1 || R < 1 || DT < 0 || N0 < 1 || R_out < 1 || n_fp < 0 || n_fp > kMaxDeep ||
      n_aug < 0 || n_aug > kMaxDeep || (n_fp > 0) != (n0_fp > 0) || (n_aug > 0) != (N0 > n0_fp))
    return cudaErrorInvalidValue;
  size_t w_off[2 * kMaxDeep], b_off[2 * kMaxDeep];
  if (packed_offsets(R, DT, N0, n0_fp, n_fp, fp_out, n_aug, aug_out, w_off, b_off) != (size_t)P)
    return cudaErrorInvalidValue;
  const bool bf16 = bias != nullptr;
  const size_t esz = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const char* wbase = static_cast<const char*>(weff);
  auto matrix = [&](size_t off) { return static_cast<const void*>(wbase + off * esz); };
  UdeArgs a = {};
  a.P = P;
  a.R = R; a.DT = DT; a.N0 = N0; a.n0_fp = n0_fp; a.R_out = R_out;
  a.w0h = matrix(0);
  a.w0t = matrix((size_t)3 * R * N0);
  // the biases: in the float32 buffer at their packed offsets, or end to end
  // in the compact buffer (b0, then each later layer's)
  const float* bbase = bf16 ? bias : static_cast<const float*>(weff);
  size_t boff = bf16 ? 0 : (size_t)3 * R * N0 + (size_t)DT * N0;
  a.b0 = bbase + boff;
  boff = N0;
  a.dec_w = static_cast<const float*>(dec_w);
  a.dec_b = static_cast<const float*>(dec_b);
  Net* nets[2] = {&a.fp, &a.aug};
  const int counts[2] = {n_fp, n_aug};
  const int* outs[2] = {fp_out, aug_out};
  for (int q = 0, l = 0; q < 2; ++q) {
    nets[q]->n = counts[q];
    for (int d = 0; d < counts[q]; ++d, ++l) {
      nets[q]->out[d] = outs[q][d];
      nets[q]->w[d] = matrix(w_off[l]);
      nets[q]->b[d] = bbase + (bf16 ? boff : b_off[l]);
      boff += outs[q][d];
    }
  }
  a.PB = bf16 ? boff : (size_t)P;
  if (bf16)
    return launch_trajectory<true, true>(zh0, ztail, B, T, dt, fa_w, a, plan, plan_len, out,
                                         stream);
  return launch_trajectory<true, false>(zh0, ztail, B, T, dt, fa_w, a, plan, plan_len, out,
                                        stream);
}

}  // extern "C"
