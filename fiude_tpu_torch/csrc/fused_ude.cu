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
// All arithmetic is float32 unless the caller asks for the bfloat16 compute
// mode (compute_dtype="bfloat16" of the TPU kernel, pallas_ude.py:185-192,
// 321-327): then the field's products take both operands rounded to bfloat16,
// the weights from bfloat16 copies the caller rounded once, and sum in
// float32 (fused_ude.cuh, kBf16); the decode stays float32.  The kernel
// allocates nothing.  The device code is in fused_ude.cuh, which K7
// (fused_bayes.cu) instantiates with kBayes.

#include "fused_ude.cuh"

namespace {

void fill_net(Net& net, int n, const int* outs, const void* const* w, const void* const* b) {
  net.n = n;
  for (int d = 0; d < n; ++d) {
    net.out[d] = outs[d];
    net.w[d] = w[d];
    net.b[d] = static_cast<const float*>(b[d]);
  }
}

}  // namespace

extern "C" {

// zh0 (B, 3R) region-major head; ztail (B, DT); weights (in, out) float32;
// out (T, B, R_out).  With bf16 != 0 the field's matrices (w0h, w0t, fp_w,
// aug_w) are bfloat16 arrays and the field's products run in the bfloat16
// compute mode; biases and the decoder stay float32.  Launches on `stream`;
// returns cudaGetLastError().
int fused_ude_trajectory(const float* zh0, const float* ztail, int B, int T,
                         float dt, float fa_w, int R, int DT, int N0, int n0_fp,
                         int R_out, const void* w0h, const void* w0t, const void* b0,
                         int n_fp, const int* fp_out, const void* const* fp_w,
                         const void* const* fp_b, int n_aug, const int* aug_out,
                         const void* const* aug_w, const void* const* aug_b,
                         const void* dec_w, const void* dec_b, float* out,
                         int bf16, void* stream) {
  if (B < 1 || T < 1 || R < 1 || DT < 0 || N0 < 1 || R_out < 1 || n_fp < 0 || n_fp > kMaxDeep ||
      n_aug < 0 || n_aug > kMaxDeep || (n_fp > 0) != (n0_fp > 0) || (n_aug > 0) != (N0 > n0_fp))
    return cudaErrorInvalidValue;
  UdeArgs a = {};
  a.R = R; a.DT = DT; a.N0 = N0; a.n0_fp = n0_fp; a.R_out = R_out;
  a.w0h = w0h;
  a.w0t = w0t;
  a.b0 = static_cast<const float*>(b0);
  a.dec_w = static_cast<const float*>(dec_w);
  a.dec_b = static_cast<const float*>(dec_b);
  fill_net(a.fp, n_fp, fp_out, fp_w, fp_b);
  fill_net(a.aug, n_aug, aug_out, aug_w, aug_b);
  const int wmax = pingpong_width(R_out, n_fp, fp_out, n_aug, aug_out);
  if (bf16) return launch_trajectory<false, true>(zh0, ztail, B, T, dt, fa_w, a, wmax, out, stream);
  return launch_trajectory<false, false>(zh0, ztail, B, T, dt, fa_w, a, wmax, out, stream);
}

}  // extern "C"
