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
// What bounds it on the card: the float32 pipes and the SM's issue slots.
// Each RHS evaluation is ~41.6k multiply-adds a row at the `state` config
// (every hot weight used once a row), so at B = 2048, T = 85 a forecast is
// ~60 GFLOP of thin products (K, N <= 147), which tensor cores would only
// take in TF32 or lower precision; the serving path stays IEEE float32.  A
// block re-reads every weight once an evaluation for its 16 or 32 rows, so
// where the weights come from decides the time: through L1 (an earlier
// design) they missed, ~100 cycles a load.
//
// What the design does about it (details in fused_ude.cuh):
//  * one block of 512 threads, one an SM, per tile of kTile = 16 ensemble
//    rows while those blocks fit one wave of the card's SMs (128 blocks at
//    B = 2048 on the H100's 132), else, in float32, of kWideTile = 32 rows
//    (B = 4096, a forecast cell's request: 128 blocks, not 256 in two
//    waves), a lane then computing its outputs for both 16-row halves; the
//    rule is ops/fused_ude.py::tile_for, and a row's bits are the same in
//    either tile; the ragged last tile is masked;
//  * the tile's state head, the stages and every activation stay in shared
//    memory for all T steps, feature-major ([feature][row]);
//  * the weights are read from shared memory only: the float32 field's 166
//    KB do not fit beside the tile and stream from L2 through two stages
//    (cp.async, the next chunk in flight while the current one is read); in
//    bfloat16 (83 KB) they stay resident, loaded once; the decoder (29 KB) is
//    resident in the 16-row tile and read through L2 (__ldg) in the 32-row
//    one;
//  * register tiles: a lane computes 4 rows x 4 columns from one 16-byte load
//    of activations and one of weights, split lanes and a fixed shuffle tree
//    where a product has few outputs; the rates net's and the Fa net's layer
//    d run side by side on disjoint warps, one barrier a pass;
//  * the bfloat16 mode's products on the tensor cores (mma.sync m16n8k16 with
//    float32 accumulation), its activations stored as bfloat16 rows;
//  * the frozen tail's first-layer term is computed once (from global
//    memory), its product kept as the first layer's addend;
//  * the SIR combine, the freeze mask and the Kutta 3/8 stage update are one
//    pass; the decode of each step rides in a pass of its first evaluation;
//  * fa_w and dt are runtime arguments, so a fa_w ramp or a new grid step
//    needs no rebuild; the launch plan (ops/fused_ude.py::trajectory_plan) is
//    made in Python and checked by the launcher, which refuses a plan the
//    kernel cannot run.
// All arithmetic is float32 unless the caller asks for the bfloat16 compute
// mode (compute_dtype="bfloat16" of the TPU kernel, pallas_ude.py:185-192,
// 321-327): then the field's products take both operands rounded to bfloat16,
// the weights from bfloat16 copies the caller rounded once, and sum in
// float32 on the tensor cores (fused_ude.cuh, kBf16); the decode stays
// float32.  The kernel
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
// compute mode; biases and the decoder stay float32.  plan (plan_len ints):
// ops/fused_ude.py::TrajectoryPlan.flat(), refused (cudaErrorInvalidValue)
// where read_plan (fused_ude.cuh) finds that the kernel cannot run it.
// Launches on `stream`; returns cudaGetLastError().
int fused_ude_trajectory(const float* zh0, const float* ztail, int B, int T,
                         float dt, float fa_w, int R, int DT, int N0, int n0_fp,
                         int R_out, const void* w0h, const void* w0t, const void* b0,
                         int n_fp, const int* fp_out, const void* const* fp_w,
                         const void* const* fp_b, int n_aug, const int* aug_out,
                         const void* const* aug_w, const void* const* aug_b,
                         const void* dec_w, const void* dec_b, float* out,
                         int bf16, const int* plan, int plan_len, void* stream) {
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
  if (bf16)
    return launch_trajectory<false, true>(zh0, ztail, B, T, dt, fa_w, a, plan, plan_len, out,
                                          stream);
  return launch_trajectory<false, false>(zh0, ztail, B, T, dt, fa_w, a, plan, plan_len, out,
                                         stream);
}

}  // extern "C"
