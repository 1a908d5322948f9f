// The RK4(3/8) trajectory of the UDE field plus the per-step decode, shared by
// K2 (csrc/fused_ude.cu: fixed weights) and K7 (csrc/fused_bayes.cu: weights
// resampled on every evaluation) through the compile-time switch kBayes.
// The design notes are in fused_ude.cu and fused_bayes.cu.
//
// A second compile-time switch, kBf16, is the bfloat16 compute mode of both
// (compute_dtype="bfloat16", pallas_ude.py:190-192, pallas_bayes.py:112-114):
// in every product of the field, and in the frozen tail's first-layer
// product, both operands are rounded to bfloat16 (nearest even) and the
// products are summed in float32; biases, ELU, |.|, the SIR field, the stage
// combination and the state stay float32, and so does the decode product.
// The weights arrive already rounded, as bfloat16 arrays (rounded once, by
// the caller or by the draw kernel: half the bytes to read).  Activations
// are rounded with __float2bfloat16_rn where they are stored, once, not where
// they are read: the first layer's and every inner layer's output in its
// epilogue (after ELU), the tail at load, and the stage input into a rounded
// copy `zin` for the first-layer product (the SIR field reads the unrounded
// `zs`).  The products run on the tensor cores (mma.sync m16n8k16, bfloat16
// operands, float32 accumulation): the same function as the twin's up to the
// order of the sum.  (K2's frozen-tail term, once a launch, sums with FMAs.)
//
// The launch plan (ops/fused_ude.py::trajectory_plan, the only planner; the
// launcher checks it with read_plan) fixes everything but the number of blocks:
//  * a block owns a tile of kTile = 16 ensemble rows on kThreads = 512
//    threads, or, in float32, kWideTile = 32 rows (the launcher in Python
//    takes it where 16-row blocks would need more than one wave of the
//    card's SMs) on the same warps, jobs and splits: each lane then owns the
//    same outputs of two 16-row halves, one weight load feeding both;
//    the state, the stages and every activation stay in shared memory for
//    all T steps, feature-major ([feature][tile rows] floats: one 16-byte load
//    gives a lane one feature of 4 rows);
//  * an RHS evaluation runs as passes ("steps" of the plan): the first layer
//    (K7: over [head | tail], 3R + DT deep, the tail's rows being the next
//    rows of the same packed matrix), then layer d of the rates net and of
//    the Fa net side by side on disjoint warps, then the SIR combine fused
//    with the stage update; the decode of the state rides in one pass of each
//    step's first evaluation;
//  * a float32 job (one product of a pass) maps its output onto lanes as 4
//    rows x kCols = 4 columns each (a 16-byte load of activations and one of
//    weights feed 16 FMAs); where a product has few outputs, `split` lanes
//    share a tile, each summing every split-th k, and a fixed xor-shuffle
//    tree adds their parts, so a row's bits depend on the widths alone,
//    never on the batch or the tile; a bfloat16 job runs on the tensor cores,
//    each warp owning 8-column tiles of all 16 rows;
//  * the plan and the arguments are copied into shared memory first, so an
//    index into them is a shared load;
//  * the weights are read from shared memory, never through L1: resident
//    (K2 where they fit beside the tile, loaded once) or streamed through two
//    stages, the next chunk (a pass's rows, split to fit a stage) copied with
//    cp.async while the current one is read.  Every chunk starts with one
//    barrier, which also ends the previous pass; the combine has one more;
//  * the Kutta stages take two slots (stage 2 stores k2 + k3 in k2's, all
//    that stage 3 reads of them) and a net's ping-pong halves only those it
//    writes; the decoder is resident in the 16-row tile (measured faster
//    there than through L2) and read from global memory in the 32-row one
//    (offset `dec` 0), which leaves its weight stages ~25-33 KB.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// The trajectory kernel's dynamic shared memory, named at file scope so that
// every access through it compiles to a shared-memory instruction.
extern __shared__ __align__(16) unsigned char ude_smem[];

namespace {

constexpr int kMaxDeep = 8;          // layers after the first, per net
constexpr int kTile = 16;            // ensemble rows per block
constexpr int kWideTile = 32;        // ... in the wide tile (float32 only)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block can use
constexpr int kMaxJobs = 3;          // products a pass: two nets' layers and the decode
constexpr int kMaxSteps = kMaxDeep + 1;
constexpr int kMaxChunks = 24;
// A CUDA-core (float32) product gives a lane 4 rows x kCols columns: one
// 16-byte load of activations and kCols / 4 of weights feed 4 kCols FMAs
// (kCols = 8 measured slower, and spills at 512 threads).
constexpr int kCols = 4;
constexpr int kAcc = 4 * kCols;      // a lane's accumulators (also kCols m16n8 tiles' worth)
// The bfloat16 mode's field products run on the tensor cores (mma.sync
// m16n8k16, the 16-row tile's rows as M); the activations they read (the stage
// input zin, h0 and the inner layers' outputs) are stored as bfloat16 rows,
// [16 rows][operand_stride(width)], not as float32 features.
enum JobKind { kFirst, kFp, kAug, kDecode, kCt };

struct Net {
  int n;                        // layers after the first (0: net absent)
  int out[kMaxDeep];
  const void* w[kMaxDeep];      // (in, out), float or (kBf16) bfloat16
  const float* b[kMaxDeep];
};

// With kBayes (K7, csrc/fused_bayes.cu) every weight pointer of the field is
// that of evaluation 0 in a buffer of effective weights (E, P), and
// evaluation e reads its weights P * e elements further on and its biases
// PB * e floats further on (PB = P when the biases live in the same buffer;
// with kBf16 they have a float32 buffer of their own, (E, PB)).  The first
// layer's matrix then has 3R + DT rows: w0t follows w0h in the buffer.
struct UdeArgs {
  size_t P;           // elements of one evaluation's weights (kBayes only)
  size_t PB;          // floats of one evaluation's biases (kBayes only)
  int R;              // regions; the head is 3R wide
  int DT;             // tail width R*(L-3), may be 0
  int N0;             // first-layer width: fp columns, then aug columns
  int n0_fp;          // fp columns of the first layer (0: no SIR term)
  int R_out;          // decoder outputs
  const void* w0h;    // (3R, N0), float or (kBf16) bfloat16
  const void* w0t;    // (DT, N0), likewise
  const float* b0;    // (N0)
  Net fp, aug;
  const float* dec_w; // (3R, R_out)
  const float* dec_b; // (R_out)
};

// ---- the plan: made by ops/fused_ude.py::trajectory_plan, laid out as its .flat() ----

struct JobPlan { int kind, layer, K, N, warp0, warps, split, ldw; };
struct StepPlan { int n_jobs; JobPlan job[kMaxJobs]; };
struct ChunkPlan { int step, k0[2], k1[2], off[2]; };
struct Plan {        // only ints: copied into shared memory word by word
  int tile, threads, smem_bytes, resident, stages, stage_bytes;
  int zh, zin, zs, kbuf, ct, h0, fpb, augb, rates, fa, dec, wts;   // byte offsets
  int ldw_dec, n_steps, dec_step;
  StepPlan step[kMaxSteps], dec_jobs, final_dec, ctp;
  int n_chunks;
  ChunkPlan chunk[kMaxChunks];
  int chunk0[kMaxSteps + 1];   // an evaluation's first chunk of each step (derived)
};
// Shared memory the kernel copies the plan and its arguments into, ahead of
// the tile (ops/fused_ude.py::ARGS_BYTES).
constexpr int kArgsBytes = 2560;
static_assert(sizeof(Plan) % 8 == 0 && sizeof(UdeArgs) % 4 == 0 &&
              sizeof(Plan) + sizeof(UdeArgs) <= kArgsBytes, "kArgsBytes");

// Row stride (elements) of an N-column matrix in shared memory
// (ops/fused_ude.py::row_stride): 16-byte rows, an odd count of 16-byte
// units; a bfloat16 row keeps room for its shift and the tensor cores' last
// 8-column tile.
int row_stride(int n, bool bf16) {
  if (bf16) return 8 * (((8 * ((n + 7) / 8) + 2 + 7) / 8) | 1);
  return 4 * (((kCols / 4) * ((n + kCols - 1) / kCols)) | 1);
}

// Row stride (elements) of a bfloat16 activation buffer the tensor cores read
// (ops/fused_ude.py::operand_stride).
__host__ __device__ inline int operand_stride(int w) { return 16 * ((w + 15) / 16) + 24; }

// The ints of a plan, read in order; `ok` turns false on reading past the end.
struct Ints {
  const int* v;
  int n, i;
  bool ok;
  int get() {
    if (i < n) return v[i++];
    ok = false;
    return 0;
  }
};

bool read_jobs(Ints& in, StepPlan& s) {
  s.n_jobs = in.get();
  if (s.n_jobs < 0 || s.n_jobs > kMaxJobs) return false;
  for (int j = 0; j < s.n_jobs; ++j) {
    JobPlan& q = s.job[j];
    for (int* f : {&q.kind, &q.layer, &q.K, &q.N, &q.warp0, &q.warps, &q.split, &q.ldw})
      *f = in.get();
  }
  return in.ok;
}

// Whether job j of a pass is the product (kind, layer) of these widths, on
// warps following the pass's earlier jobs', with a lane for every output
// tile (a tensor-core warp: at most kCols tiles of 8 columns) and the row
// stride the copies use.
bool job_ok(const UdeArgs& a, bool bayes, bool bf16, const StepPlan& s, int j, int kind,
            int layer) {
  const JobPlan& q = s.job[j];
  const int W3 = 3 * a.R;
  int K = 0, N = 0;
  switch (kind) {
    case kFirst: K = bayes ? W3 + a.DT : W3; N = a.N0; break;
    case kFp: K = layer ? a.fp.out[layer - 1] : a.n0_fp; N = a.fp.out[layer]; break;
    case kAug: K = layer ? a.aug.out[layer - 1] : a.N0 - a.n0_fp; N = a.aug.out[layer]; break;
    case kDecode: K = W3; N = a.R_out; break;
    default: K = a.DT; N = a.N0; break;
  }
  const int warp0 = j ? s.job[j - 1].warp0 + s.job[j - 1].warps : 0;
  const bool mma = bf16 && kind != kDecode && kind != kCt;
  const int S = q.split;
  return q.kind == kind && q.layer == layer && q.K == K && q.N == N && q.warp0 == warp0 &&
         q.warps >= 1 && warp0 + q.warps <= kWarps && (S == 1 || S == 2 || S == 4 || S == 8) &&
         (mma ? q.warps * kCols >= (N + 7) / 8
              : q.warps * 32 / S >= 4 * ((N + kCols - 1) / kCols)) &&
         q.ldw == row_stride(N, bf16 && kind != kDecode);
}

// Reads the plan of n ints at v (TrajectoryPlan.flat()) into p and checks
// what the kernel relies on: its tile (16 rows, or 32 in float32) and
// threads; every pass's products those of these widths, in the kernel's order,
// each on warps of its own with a lane for each output; each buffer 16-byte
// aligned and as large as the kernel reads for the tile's rows (the
// ping-pong halves a net writes included), in the layout's order; each
// pass's weight rows covered in order by its chunks, a chunk's rows inside
// its stage (resident: side by side, none over another); no resident weights
// for K7, whose weights are new every evaluation; and all of it inside
// kSmemLimit.  Returns false for any other plan: the launcher then refuses it.
bool read_plan(const UdeArgs& a, bool bayes, bool bf16, const int* v, int n, Plan& p) {
  p = Plan{};
  Ints in{v, n, 0, true};
  int* head[] = {&p.tile, &p.threads, &p.smem_bytes, &p.resident, &p.stages, &p.stage_bytes,
                 &p.zh, &p.zin, &p.zs, &p.kbuf, &p.ct, &p.h0, &p.fpb, &p.augb, &p.rates,
                 &p.fa, &p.dec, &p.wts, &p.ldw_dec, &p.n_steps, &p.dec_step};
  for (int* f : head) *f = in.get();
  const int depth = a.fp.n > a.aug.n ? a.fp.n : a.aug.n, W3 = 3 * a.R;
  if (!in.ok || (p.tile != kTile && (p.tile != kWideTile || bf16)) ||
      p.threads != kThreads || p.n_steps != depth + 1 ||
      p.n_steps > kMaxSteps || p.dec_step < 0 || p.dec_step >= p.n_steps ||
      p.ldw_dec != row_stride(a.R_out, false) || p.smem_bytes > kSmemLimit ||
      (p.resident != 0 && p.resident != 1) || (bayes && p.resident))
    return false;

  // the passes: the first layer, then layer d of the rates net and of the Fa net
  for (int s = 0; s < p.n_steps; ++s) {
    const StepPlan& sp = p.step[s];
    if (!read_jobs(in, p.step[s])) return false;
    int kinds[2], n_mat = 0;
    if (s == 0) kinds[n_mat++] = kFirst;
    if (s > 0 && s - 1 < a.fp.n) kinds[n_mat++] = kFp;
    if (s > 0 && s - 1 < a.aug.n) kinds[n_mat++] = kAug;
    if (sp.n_jobs != n_mat) return false;
    for (int j = 0; j < n_mat; ++j)
      if (!job_ok(a, bayes, bf16, sp, j, kinds[j], s ? s - 1 : 0)) return false;
  }
  // the decode: one pass's jobs and then it; alone; K2's frozen-tail term
  if (!read_jobs(in, p.dec_jobs) || !read_jobs(in, p.final_dec) || !read_jobs(in, p.ctp))
    return false;
  const StepPlan& ds = p.step[p.dec_step];
  if (p.dec_jobs.n_jobs != ds.n_jobs + 1 || p.final_dec.n_jobs != 1 ||
      p.ctp.n_jobs != (bayes ? 0 : 1))
    return false;
  for (int j = 0; j < ds.n_jobs; ++j)
    if (!job_ok(a, bayes, bf16, p.dec_jobs, j, ds.job[j].kind, ds.job[j].layer))
      return false;
  if (!job_ok(a, bayes, bf16, p.dec_jobs, ds.n_jobs, kDecode, 0) ||
      !job_ok(a, bayes, bf16, p.final_dec, 0, kDecode, 0) ||
      (!bayes && !job_ok(a, bayes, bf16, p.ctp, 0, kCt, 0)))
    return false;

  // the tile: each buffer at least as large as the kernel uses it, in order
  // (float32: the product reads the stage input itself, zs = zin; a decoder
  // at offset 0 is read from global memory and has no buffer)
  const int row = p.tile * 4;
  auto operand = [&](int w) { return bf16 ? (w ? 2 * kTile * operand_stride(w) : 0) : w * row; };
  auto halves = [](const Net& net) { return net.n > 2 ? 2 : net.n - 1 > 0 ? net.n - 1 : 0; };
  int fpw = 0, augw = 0;
  for (int d = 0; d + 1 < a.fp.n; ++d) fpw = a.fp.out[d] > fpw ? a.fp.out[d] : fpw;
  for (int d = 0; d + 1 < a.aug.n; ++d) augw = a.aug.out[d] > augw ? a.aug.out[d] : augw;
  const int kb = bayes ? 2 * W3 : (2 * W3 > a.DT ? 2 * W3 : a.DT);
  const int offs[12] = {p.zh, p.zin, p.zs, p.kbuf, p.ct, p.h0, p.fpb, p.augb, p.rates, p.fa,
                        p.dec, p.wts};
  const int sizes[12] = {W3 * row, operand(bayes ? W3 + a.DT : W3), bf16 ? W3 * row : 0,
                         kb * row, bayes ? 0 : a.N0 * row, operand(a.N0),
                         halves(a.fp) * operand(fpw), halves(a.aug) * operand(augw),
                         a.fp.n ? 2 * a.R * row : 0, a.aug.n ? W3 * row : 0,
                         p.dec ? W3 * p.ldw_dec * 4 : 0, 0};
  // a net that writes two ping-pong halves: the kernel halves its gap
  if ((halves(a.fp) == 2 && (p.augb - p.fpb) / 2 < operand(fpw)) ||
      (halves(a.aug) == 2 && (p.rates - p.augb) / 2 < operand(augw)) ||
      (p.augb - p.fpb) / 2 % 16 || (p.rates - p.augb) / 2 % 16)
    return false;
  if (!bf16 && p.zs != p.zin) return false;
  int prev = -1;   // the buffers in order, zs (float32) and a global decoder skipped
  for (int i = 0; i < 12; ++i) {
    if ((!bf16 && i == 2) || (i == 10 && p.dec == 0)) continue;
    if (offs[i] < kArgsBytes || offs[i] > p.smem_bytes || offs[i] % 16 ||
        (prev >= 0 && offs[prev] + sizes[prev] > offs[i]))
      return false;
    prev = i;
  }

  // the weights: each pass's rows in order over its chunks, inside their stage
  p.n_chunks = in.get();
  if (!in.ok || p.n_chunks < 1 || p.n_chunks > kMaxChunks) return false;
  const int esize = bf16 ? 2 : 4;
  const int room = p.resident ? p.smem_bytes - p.wts : p.stage_bytes;
  if (!p.resident && (p.stages != 2 || p.stage_bytes < 16 || p.stage_bytes % 16 ||
                      p.stage_bytes > kSmemLimit || p.wts + 2 * p.stage_bytes > p.smem_bytes))
    return false;
  int next_k[2] = {0, 0}, end = 0;
  for (int c = 0; c < p.n_chunks; ++c) {
    ChunkPlan& ch = p.chunk[c];
    for (int* f : {&ch.step, &ch.k0[0], &ch.k0[1], &ch.k1[0], &ch.k1[1], &ch.off[0], &ch.off[1]})
      *f = in.get();
    const int prev_step = c ? p.chunk[c - 1].step : 0;
    if (!in.ok || ch.step < prev_step || ch.step > prev_step + (c ? 1 : 0) ||
        ch.step >= p.n_steps)
      return false;
    if (c == 0 || ch.step != prev_step) {
      if (c && (next_k[0] != p.step[prev_step].job[0].K ||
                (p.step[prev_step].n_jobs > 1 && next_k[1] != p.step[prev_step].job[1].K)))
        return false;
      next_k[0] = next_k[1] = 0;
    }
    if (!p.resident) end = 0;
    const StepPlan& sp = p.step[ch.step];
    for (int j = 0; j < sp.n_jobs; ++j) {
      if (ch.k0[j] != next_k[j] || ch.k1[j] <= ch.k0[j] || ch.k1[j] > sp.job[j].K ||
          ch.off[j] % 16 || ch.off[j] < end || ch.off[j] > room)
        return false;
      next_k[j] = ch.k1[j];
      end = ch.off[j] + (ch.k1[j] - ch.k0[j]) * sp.job[j].ldw * esize;
      if (end > room) return false;
    }
  }
  const StepPlan& last = p.step[p.n_steps - 1];
  if (in.i != n || p.chunk[p.n_chunks - 1].step != p.n_steps - 1 ||
      next_k[0] != last.job[0].K || (last.n_jobs > 1 && next_k[1] != last.job[1].K))
    return false;
  for (int c = 0, s = 0; s <= p.n_steps; ++s) {
    while (c < p.n_chunks && p.chunk[c].step < s) ++c;
    p.chunk0[s] = c;
  }
  return true;
}

// ---- device code ----

// ELU without a branch: every lane evaluates expm1f, so a tile's 16 values
// interleave instead of diverging one by one.
__device__ __forceinline__ float eluf(float x) {
  const float em = expm1f(fminf(x, 0.f));
  return x > 0.f ? x : em;
}

// x rounded to bfloat16 (nearest even), as a float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

// Rows [k0, k1) of a K x N row-major matrix at `src` into shared memory at
// `dst` (row k at dst + (k - k0) * ldw * kEsize), one warp a row, in the
// widest of 16-, 8- and 4-byte units the row's address allows.  A bfloat16
// row that starts between two 4-byte words is copied from the word before it:
// its element c then sits at element c + 1 of the shared row (`parity`).  A
// row's last unit may read into the next row, never past the matrix: its
// last row goes in 4-byte units (an aligned 4-byte word that holds a byte of
// the matrix lies inside the matrix's allocation).
template <int kEsize>
__device__ void copy_rows(unsigned char* dst, const unsigned char* src, int k0, int k1, int K,
                          int N, int ldw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = k0 + warp; k < k1; k += kWarps) {
    const uintptr_t a = (uintptr_t)(src + (size_t)k * N * kEsize);
    const unsigned char* s = (const unsigned char*)(a & ~(uintptr_t)3);
    unsigned char* d = dst + (size_t)(k - k0) * ldw * kEsize;
    const int bytes = (int)(a & 3) + N * kEsize;
    if ((a & 15) == 0 && k + 1 < K)
      copy_units<16>(d, s, bytes, lane);
    else if ((a & 7) == 0 && k + 1 < K)
      copy_units<8>(d, s, bytes, lane);
    else
      copy_units<4>(d, s, bytes, lane);
  }
}

// The element offset (0 or 1) at which row k of a bfloat16 matrix starts in
// its shared copy: the matrix's own start parity, flipped on odd rows when
// its width N is odd.
__device__ __forceinline__ int row_parity(int par0, int npar, int k) { return par0 ^ (k & npar); }

template <bool kBayes, bool kBf16, int kRows>
struct Traj {
  const UdeArgs& a;
  const Plan& p;
  int row0, B;

  static_assert(kRows == kTile || (kRows == kWideTile && !kBf16),
                "a tile of 16 rows, or 32 in float32");
  static constexpr int kEsize = kBf16 ? 2 : 4;
  static constexpr int kGroups = kRows / 4;   // 4-row groups: float4s a feature
  // A lane's tile of a CUDA-core product is 4 rows x kCols columns in each of
  // kSets 16-row halves of the tile: row groups rg and rg + 4.
  static constexpr int kSets = kRows / kTile;

  __device__ float4* buf(int off) const { return reinterpret_cast<float4*>(ude_smem + off); }

  // evaluation e's matrix of a job (kBayes: P * e elements further on)
  __device__ const unsigned char* matrix(const JobPlan& j, int e) const {
    const void* w = j.kind == kFirst ? a.w0h : j.kind == kFp ? a.fp.w[j.layer] : a.aug.w[j.layer];
    return static_cast<const unsigned char*>(w) + (kBayes ? a.P * (size_t)e * kEsize : 0);
  }

  __device__ const float* bias(const JobPlan& j, int e) const {
    const size_t boff = kBayes ? a.PB * (size_t)e : 0;
    switch (j.kind) {
      case kFirst: return a.b0 + boff;
      case kFp: return a.fp.b[j.layer] + boff;
      case kAug: return a.aug.b[j.layer] + boff;
      case kDecode: return a.dec_b;
      default: return a.b0;
    }
  }

  __device__ unsigned char* chunk_base(int g) const {
    return ude_smem + p.wts + (p.resident ? 0 : (g & 1) * p.stage_bytes);
  }

  // Issue the copies of chunk c of evaluation e into the stage of global chunk g.
  __device__ void copy_chunk(int c, int e, int g) const {
    const ChunkPlan& ch = p.chunk[c];
    const StepPlan& sp = p.step[ch.step];
    unsigned char* base = chunk_base(g);
    for (int j = 0; j < sp.n_jobs; ++j)
      copy_rows<kEsize>(base + ch.off[j], matrix(sp.job[j], e), ch.k0[j], ch.k1[j], sp.job[j].K,
                        sp.job[j].N, sp.job[j].ldw);
  }

  // The input activations of a float32 field product (feature-major float4
  // [K][kGroups row groups]).
  __device__ const float4* input(const JobPlan& j) const {
    switch (j.kind) {
      case kFirst: return buf(p.zin);
      case kFp: return j.layer == 0 ? buf(p.h0) : half(kFp, j.layer - 1);
      default: return j.layer == 0 ? buf(p.h0) + a.n0_fp * kGroups : half(kAug, j.layer - 1);
    }
  }

  // The ping-pong half that layer d of a net writes (when not its last) and
  // layer d + 1 reads: each half as wide as the net's widest inner layer (a
  // net of one inner layer writes half 0 alone).
  __device__ float4* half(int kind, int d) const {
    const int lo = kind == kFp ? p.fpb : p.augb, hi = kind == kFp ? p.augb : p.rates;
    return buf(lo + (d & 1) * ((hi - lo) / 2));
  }

  // acc += x[k] (4 rows) * w[k] (kCols columns) with FMAs.
  __device__ __forceinline__ static void fma_tile(float (&acc)[kAcc], const float4& x,
                                                  const float (&ws)[kCols]) {
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[r * kCols + q] = fmaf(xs[r], ws[q], acc[r * kCols + q]);
  }

  // acc += in[k] x W[k] for this lane's k in [kb, ke) (k = s mod S), 4 rows
  // (row groups rg + 4t of the kSets halves) x kCols columns from c; W's
  // float32 row k at w + (k - kw) * ldw elements.
  __device__ __forceinline__ void accumulate(float (&acc)[kSets][kAcc], const float4* in,
                                             const unsigned char* w, int ldw, int kw, int kb,
                                             int ke, int S, int s, int rg, int c) const {
    int k = kb + ((s - kb) % S + S) % S;
#pragma unroll 4
    for (; k < ke; k += S) {
      float4 x[kSets];
#pragma unroll
      for (int t = 0; t < kSets; ++t) x[t] = in[k * kGroups + rg + 4 * t];
      const float4* wr = reinterpret_cast<const float4*>(w + ((size_t)(k - kw) * ldw + c) * 4);
      float ws[kCols];
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q)
        *reinterpret_cast<float4*>(ws + 4 * q) = wr[q];
#pragma unroll
      for (int t = 0; t < kSets; ++t) fma_tile(acc[t], x[t], ws);
    }
  }

  // A product whose K x N matrix W is read from global memory with __ldg (in
  // bfloat16 with kWBf16), in the k order of accumulate: K2's frozen-tail
  // term (once a launch; W = w0t) and the 32-row tile's decode (W = dec_w).
  template <bool kWBf16>
  __device__ void accumulate_global(float (&acc)[kSets][kAcc], const float4* in, const void* W,
                                    int K, int N, int S, int s, int rg, int c) const {
    for (int k = s; k < K; k += S) {
      float ws[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const size_t i = (size_t)k * N + c + q;
        const unsigned short* wb = static_cast<const unsigned short*>(W);
        ws[q] = c + q >= N ? 0.f
                : kWBf16 ? __uint_as_float((unsigned)__ldg(wb + i) << 16)
                         : __ldg(static_cast<const float*>(W) + i);
      }
#pragma unroll
      for (int t = 0; t < kSets; ++t) fma_tile(acc[t], in[k * kGroups + rg + 4 * t], ws);
    }
  }

  // The decode's product of the state head: the decoder resident (p.dec, the
  // 16-row tile) or read from global memory (the 32-row tile).
  __device__ __forceinline__ void decode_products(float (&acc)[kSets][kAcc], const JobPlan& j,
                                                  int S, int s, int rg, int c) const {
    if (p.dec)
      accumulate(acc, buf(p.zh), ude_smem + p.dec, p.ldw_dec, 0, 0, j.K, S, s, rg, c);
    else
      accumulate_global<false>(acc, buf(p.zh), a.dec_w, j.K, j.N, S, s, rg, c);
  }

  // The bfloat16 products on the tensor cores: this warp (wj of the job's nw)
  // owns the n-tiles t = wj + nw * i (i < kCols) of 8 columns for all 16 rows,
  // acc[4i..4i+3] its m16n8 accumulator, over rows [kb, ke) of W in k-blocks
  // of 16 (a block that the chunk's rows cut has the other rows of W masked
  // to zero; the other chunk adds them).  A: the activations' bfloat16 rows
  // (x + koff: row r at x + r * lda), zeros or finite values past the
  // width; B: W's raw bfloat16 rows.
  __device__ __forceinline__ void accumulate_mma(float (&acc)[kAcc], const unsigned short* x,
                                                 int lda, int koff, const unsigned char* w,
                                                 int ldw, int kw, int kb, int ke, int N, int wj,
                                                 int nw, int par0, int npar) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, ntiles = (N + 7) / 8;
    auto pair = [&](const unsigned short* q) -> unsigned {   // two bfloat16 along k
      return (koff & 1) ? (unsigned)q[0] | ((unsigned)q[1] << 16)
                        : *reinterpret_cast<const unsigned*>(q);
    };
    // this lane's 4 k of a block, k16 + r with r = 2 tq + {0, 1, 8, 9}: their
    // rows of W at column g (tile t adds 8 t columns), at element
    // k16 * ldw + roff[i] (a row's parity depends on r alone: k16 is even)
    const unsigned short* w16 = reinterpret_cast<const unsigned short*>(w);
    int roff[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 2 * tq + (i & 1) + 8 * (i >> 1);
      roff[i] = (r - kw) * ldw + row_parity(par0, npar, r) + g;
    }
    for (int k16 = kb & ~15; k16 < ke; k16 += 16) {
      const unsigned short* wrow[4];
      unsigned keep[4];
      if (k16 >= kb && k16 + 16 <= ke) {      // a whole block of the chunk's rows
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          keep[i] = 0xffffu;
          wrow[i] = w16 + k16 * ldw + roff[i];
        }
      } else {                                // a k outside them reads a row inside and counts 0
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k16 + 2 * tq + (i & 1) + 8 * (i >> 1);
          const bool in_chunk = k >= kb && k < ke;
          const int kk = in_chunk ? k : kb;
          keep[i] = in_chunk ? 0xffffu : 0u;
          wrow[i] = w16 + (size_t)(kk - kw) * ldw + row_parity(par0, npar, kk) + g;
        }
      }
      // a0: (row g, k 2tq..+1), a1: row g + 8, a2: k + 8, a3: both
      const unsigned short* xr = x + g * lda + koff + k16 + 2 * tq;
      const unsigned af[4] = {pair(xr), pair(xr + 8 * lda), pair(xr + 8), pair(xr + 8 * lda + 8)};
#pragma unroll
      for (int i = 0; i < kAcc / 4; ++i) {
        const int t = wj + nw * i;
        if (t < ntiles) {
          unsigned bf[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            bf[h] = (wrow[2 * h][8 * t] & keep[2 * h]) |
                    ((wrow[2 * h + 1][8 * t] & keep[2 * h + 1]) << 16);
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
              "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(acc[4 * i]), "+f"(acc[4 * i + 1]), "+f"(acc[4 * i + 2]), "+f"(acc[4 * i + 3])
              : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(bf[0]), "r"(bf[1]));
        }
      }
    }
  }

  // The widest inner layer of a net: the width of its ping-pong halves.
  __device__ __forceinline__ int inner_width(const Net& net) const {
    int w = 0;
    for (int d = 0; d + 1 < net.n; ++d) w = net.out[d] > w ? net.out[d] : w;
    return w;
  }

  // The tensor cores' A operand of a job: the bfloat16 rows it reads, their
  // stride and the column it starts at.
  __device__ __forceinline__ const unsigned short* operand(const JobPlan& j, int& lda,
                                                          int& koff) const {
    koff = 0;
    if (j.kind == kFirst) {
      lda = operand_stride(kBayes ? 3 * a.R + a.DT : 3 * a.R);
      return reinterpret_cast<const unsigned short*>(ude_smem + p.zin);
    }
    const Net& net = j.kind == kFp ? a.fp : a.aug;
    if (j.layer == 0) {
      lda = operand_stride(a.N0);
      koff = j.kind == kFp ? 0 : a.n0_fp;
      return reinterpret_cast<const unsigned short*>(ude_smem + p.h0);
    }
    lda = operand_stride(inner_width(net));
    return reinterpret_cast<const unsigned short*>(half(j.kind, j.layer - 1));
  }

  // Store one output of a field product: plus its bias `bb` (K2's first
  // layer: its addend ct), ELU and rounding as the layer wants.
  __device__ __forceinline__ void store(const JobPlan& j, int col, int row, float v,
                                        float bb) const {
    const Net* net = j.kind == kFp ? &a.fp : &a.aug;
    bool act, rnd = kBf16;
    float* dst;
    if (j.kind == kFirst) {
      v += kBayes ? bb : reinterpret_cast<const float*>(ude_smem + p.ct)[col * kRows + row];
      act = col < a.n0_fp ? a.fp.n >= 2 : a.aug.n >= 2;
      dst = reinterpret_cast<float*>(ude_smem + p.h0);
    } else {
      const bool last = j.layer == net->n - 1;
      v += bb;
      act = j.layer + 1 < net->n - 1;
      rnd = kBf16 && !last;
      dst = reinterpret_cast<float*>(last ? ude_smem + (j.kind == kFp ? p.rates : p.fa)
                                          : reinterpret_cast<unsigned char*>(half(j.kind, j.layer)));
    }
    if (act) v = eluf(v);
    if (rnd) v = round_bf16(v);
    if (rnd) {                             // an input of the next product: a bfloat16 row
      const int lda = operand_stride(j.kind == kFirst ? a.N0 : inner_width(*net));
      reinterpret_cast<__nv_bfloat16*>(dst)[row * lda + col] = __float2bfloat16_rn(v);
    } else {
      dst[col * kRows + row] = v;
    }
  }

  // The biases a lane adds in its epilogue, loaded before its products so
  // that their latency hides behind them: a CUDA-core tile's kCols columns
  // from c, a tensor-core warp's 2 columns of each of its n-tiles.
  __device__ __forceinline__ void load_bias(const JobPlan& j, int e, bool mma, bool active, int c,
                                            float (&bb)[kAcc / 2]) const {
#pragma unroll
    for (int i = 0; i < kAcc / 2; ++i) bb[i] = 0.f;
    if (j.kind == kFirst && !kBayes) return;     // K2's first layer adds ct instead
    const float* b = bias(j, e);
    if (mma) {
      const int wj = (threadIdx.x >> 5) - j.warp0, tq = threadIdx.x & 3, ntiles = (j.N + 7) / 8;
#pragma unroll
      for (int i = 0; i < kAcc / 4; ++i)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int t = wj + j.warps * i, col = 8 * t + 2 * tq + v;
          if (t < ntiles && col < j.N) bb[2 * i + v] = __ldg(b + col);
        }
    } else if (active) {
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        if (c + q < j.N) bb[q] = __ldg(b + c + q);
    }
  }

  // The tensor cores' epilogue: each lane holds rows g and g + 8, columns
  // 8t + 2(lane % 4) + {0, 1} of its n-tiles.
  __device__ __forceinline__ void finish_mma(const float (&acc)[kAcc], const JobPlan& j,
                                             const float (&bb)[kAcc / 2]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
    const int wj = (threadIdx.x >> 5) - j.warp0, ntiles = (j.N + 7) / 8;
#pragma unroll
    for (int i = 0; i < kAcc / 4; ++i) {
      const int t = wj + j.warps * i;
      if (t >= ntiles) continue;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int col = 8 * t + 2 * tq + (v & 1);
        if (col < j.N) store(j, col, g + 8 * (v >> 1), acc[4 * i + v], bb[2 * i + (v & 1)]);
      }
    }
  }

  // Sum the split lanes' parts (a fixed xor tree), add the bias or addend,
  // apply ELU / rounding and store this lane's share of the tile: of the
  // kCols columns, those c' with c' mod min(S, kCols) = its split index.
  __device__ __forceinline__ void finish(float (&acc)[kSets][kAcc], const JobPlan& j,
                                         const float (&bb)[kAcc / 2], int t_out,
                                         float* __restrict__ out) const {
    const int lane = threadIdx.x & 31, S = j.split, q = 32 / S;
    for (int m = 16; m >= q; m >>= 1)
#pragma unroll
      for (int t = 0; t < kSets; ++t)
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[t][i] += __shfl_xor_sync(0xffffffffu, acc[t][i], m);
    const int item = ((threadIdx.x >> 5) - j.warp0) * q + lane % q, s = lane / q;
    if (item >= 4 * ((j.N + kCols - 1) / kCols)) return;
    const int c = (item >> 2) * kCols, share = S < kCols ? S : kCols;
    bool act = false, rnd = false;
    float4* dst = nullptr;
    const Net* net = j.kind == kFp ? &a.fp : &a.aug;
    if (j.kind == kFirst) {
      dst = buf(p.h0);
      rnd = kBf16;
    } else if (j.kind == kFp || j.kind == kAug) {
      const bool last = j.layer == net->n - 1;
      act = j.layer + 1 < net->n - 1;
      rnd = kBf16 && !last;
      dst = last ? buf(j.kind == kFp ? p.rates : p.fa) : half(j.kind, j.layer);
    } else if (j.kind == kCt) {
      dst = buf(p.ct);
    }
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int col = c + cc;
      if (cc % share != s || col >= j.N) continue;
      if (j.kind == kFirst) act = col < a.n0_fp ? a.fp.n >= 2 : a.aug.n >= 2;
#pragma unroll
      for (int t = 0; t < kSets; ++t) {
        const int rg = (item & 3) + 4 * t;     // this half's row group
        float v[4];
        if (j.kind == kFirst && !kBayes) {
          const float4 ad = buf(p.ct)[col * kGroups + rg];
          v[0] = acc[t][cc] + ad.x; v[1] = acc[t][kCols + cc] + ad.y;
          v[2] = acc[t][2 * kCols + cc] + ad.z; v[3] = acc[t][3 * kCols + cc] + ad.w;
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) v[r] = acc[t][r * kCols + cc] + bb[cc];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (act) v[r] = eluf(v[r]);
          if (rnd) v[r] = round_bf16(v[r]);
        }
        if (j.kind == kDecode) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = row0 + rg * 4 + r;
            if (row < B) out[((size_t)t_out * B + row) * a.R_out + col] = v[r];
          }
        } else {
          dst[col * kGroups + rg] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }

  // One pass (step s of evaluation e, chunks from global chunk g on): every
  // chunk starts with a barrier; the stage after it is filled meanwhile.
  // Returns the global chunk count after the pass.
  __device__ int run_step(const StepPlan& sp, int s, int e, int E, int g, int t_out,
                          float* __restrict__ out) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int jx = -1;
    for (int j = 0; j < sp.n_jobs; ++j)
      if (warp >= sp.job[j].warp0 && warp < sp.job[j].warp0 + sp.job[j].warps) jx = j;
    float acc[kSets][kAcc];
#pragma unroll
    for (int t = 0; t < kSets; ++t)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[t][i] = 0.f;
    const JobPlan* j = jx >= 0 ? &sp.job[jx] : nullptr;
    int S = 1, sl = 0, rg = 0, c = 0, par0 = 0, npar = 0;
    bool active = false;
    if (j != nullptr) {
      S = j->split;
      const int q = 32 / S, item = (warp - j->warp0) * q + lane % q;
      sl = lane / q;
      active = item < 4 * ((j->N + kCols - 1) / kCols);
      rg = item & 3;
      c = (item >> 2) * kCols;
      if (kBf16 && j->kind != kDecode) {
        par0 = (int)(((uintptr_t)matrix(*j, e) >> 1) & 1);
        npar = j->N & 1;
      }
    }
    // bfloat16: the field's products on the tensor cores; the decode (and
    // every float32 product) on the CUDA cores
    const bool mma = kBf16 && j != nullptr && j->kind != kDecode;
    float bb[kAcc / 2];
    if (j != nullptr) load_bias(*j, e, mma, active, c, bb);
    const int c_end = p.chunk0[s + 1];
    for (int ci = p.chunk0[s]; ci < c_end; ++ci, ++g) {
      cp_async_wait_all();
      __syncthreads();
      if (!p.resident) {     // the next chunk: this evaluation's next, or the next one's first
        const int nc = ci + 1 < p.n_chunks ? ci + 1 : 0, ne = ci + 1 < p.n_chunks ? e : e + 1;
        if (ne < E) copy_chunk(nc, ne, g + 1);
      }
      if (!active && !mma) continue;        // a warp's mma takes all its lanes
      const ChunkPlan& ch = p.chunk[ci];
      if (j->kind == kDecode) {
        if (ci + 1 == c_end) decode_products(acc, *j, S, sl, rg, c);
      } else if (mma) {
        int lda, koff;
        const unsigned short* x = operand(*j, lda, koff);
        accumulate_mma(acc[0], x, lda, koff, chunk_base(g) + ch.off[jx], j->ldw, ch.k0[jx],
                       ch.k0[jx], ch.k1[jx], j->N, warp - j->warp0, j->warps, par0, npar);
      } else {
        accumulate(acc, input(*j), chunk_base(g) + ch.off[jx], j->ldw, ch.k0[jx], ch.k0[jx],
                   ch.k1[jx], S, sl, rg, c);
      }
    }
    if (mma)
      finish_mma(acc[0], *j, bb);
    else if (j != nullptr)
      finish(acc, *j, bb, t_out, out);
    return g;
  }

  // The decode alone (the last point, or every point when T == 1): float32
  // in both modes.
  __device__ void run_decode(int t_out, float* __restrict__ out) const {
    const JobPlan& j = p.final_dec.job[0];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < j.warp0 || warp >= j.warp0 + j.warps) return;
    float acc[kSets][kAcc];
#pragma unroll
    for (int t = 0; t < kSets; ++t)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[t][i] = 0.f;
    const int q = 32 / j.split, item = (warp - j.warp0) * q + lane % q;
    const bool active = item < 4 * ((j.N + kCols - 1) / kCols);
    const int c = (item >> 2) * kCols;
    float bb[kAcc / 2];
    load_bias(j, 0, false, active, c, bb);
    if (active) decode_products(acc, j, j.split, lane / q, item & 3, c);
    finish(acc, j, bb, t_out, out);
  }

  // K2's frozen-tail term plus the bias, once a launch, into ct.
  __device__ void run_ct() const {
    const JobPlan& j = p.ctp.job[0];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < j.warp0 || warp >= j.warp0 + j.warps) return;
    float acc[kSets][kAcc];
#pragma unroll
    for (int t = 0; t < kSets; ++t)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[t][i] = 0.f;
    const int q = 32 / j.split, item = (warp - j.warp0) * q + lane % q;
    const bool active = item < 4 * ((j.N + kCols - 1) / kCols);
    const int c = (item >> 2) * kCols;
    float bb[kAcc / 2];
    load_bias(j, 0, false, active, c, bb);
    if (active)
      accumulate_global<kBf16>(acc, buf(p.kbuf), a.w0t, j.K, j.N, j.split, lane / q, item & 3, c);
    finish(acc, j, bb, 0, nullptr);
  }

  // The field at this stage's input from the rates and Fa just computed, the
  // freeze mask, and the Kutta 3/8 stage update fused in: k1 (stage 0), k2
  // (stage 1), k2 + k3 in k2's slot (stage 2: stage 3 reads them as that sum,
  // the same float addition as summing them there), the next stage's input
  // (zs, and its rounded copy zin with kBf16), and at stage 3 the new state.
  __device__ void combine(int stage, float dt, float fa_w) const {
    const bool mech = a.n0_fp > 0, has_aug = a.aug.n > 0;
    float4* zh = buf(p.zh);
    float4* zs = buf(p.zs);
    float4* zin = buf(p.zin);
    float4* k1 = buf(p.kbuf);
    float4* k2 = k1 + 3 * a.R * kGroups;
    const float4* rt = buf(p.rates);
    const float4* fa = buf(p.fa);
    const float third = 1.f / 3.f;
    const int lda = operand_stride(kBayes ? 3 * a.R + a.DT : 3 * a.R);
    // a thread a (region, group of 4 rows): the region's S, I, R as float4s
    for (int idx = threadIdx.x; idx < a.R * kGroups; idx += kThreads) {
      const int r = idx / kGroups, rg = idx % kGroups, i0 = 3 * r * kGroups + rg;
      float z[3][4], f[3][4], beta[4], gamma[4];
#pragma unroll
      for (int q = 0; q < 3; ++q) *reinterpret_cast<float4*>(z[q]) = zs[i0 + kGroups * q];
      if (mech) {
        *reinterpret_cast<float4*>(beta) = rt[2 * r * kGroups + rg];
        *reinterpret_cast<float4*>(gamma) = rt[(2 * r + 1) * kGroups + rg];
      }
      if (has_aug)
#pragma unroll
        for (int q = 0; q < 3; ++q) *reinterpret_cast<float4*>(f[q]) = fa[i0 + kGroups * q];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (mech) {
          const float plus_i = fabsf(beta[u]) * z[0][u] * z[1][u];
          const float minus_i = fabsf(gamma[u]) * z[1][u];
          const float sir[3] = {-plus_i, plus_i - minus_i, minus_i};
#pragma unroll
          for (int q = 0; q < 3; ++q) f[q][u] = has_aug ? sir[q] + fa_w * f[q][u] : sir[q];
        }
#pragma unroll
        for (int q = 0; q < 3; ++q)     // frozen out of range
          f[q][u] = (z[q][u] > 2.f || z[q][u] < -1.f) ? 0.f : f[q][u];
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int i = i0 + kGroups * q;
        const float4 kv = *reinterpret_cast<const float4*>(f[q]), h = zh[i];
        float4 nz;
        if (stage == 0) {
          k1[i] = kv;
          nz = make_float4(h.x + dt * (third * kv.x), h.y + dt * (third * kv.y),
                           h.z + dt * (third * kv.z), h.w + dt * (third * kv.w));
        } else if (stage == 1) {
          const float4 a1 = k1[i];
          k2[i] = kv;
          nz = make_float4(h.x + dt * (kv.x - third * a1.x), h.y + dt * (kv.y - third * a1.y),
                           h.z + dt * (kv.z - third * a1.z), h.w + dt * (kv.w - third * a1.w));
        } else if (stage == 2) {
          const float4 a1 = k1[i], a2 = k2[i];
          k2[i] = make_float4(a2.x + kv.x, a2.y + kv.y, a2.z + kv.z, a2.w + kv.w);
          nz = make_float4(h.x + dt * (a1.x - a2.x + kv.x), h.y + dt * (a1.y - a2.y + kv.y),
                           h.z + dt * (a1.z - a2.z + kv.z), h.w + dt * (a1.w - a2.w + kv.w));
        } else {
          const float4 a1 = k1[i], a23 = k2[i];
          nz = make_float4(h.x + dt * (a1.x + 3.f * a23.x + kv.x) * 0.125f,
                           h.y + dt * (a1.y + 3.f * a23.y + kv.y) * 0.125f,
                           h.z + dt * (a1.z + 3.f * a23.z + kv.z) * 0.125f,
                           h.w + dt * (a1.w + 3.f * a23.w + kv.w) * 0.125f);
          zh[i] = nz;
        }
        zs[i] = nz;
        if (kBf16) {                      // the tensor cores' rows: feature 3r + q of 4 rows
          __nv_bfloat16* xr = reinterpret_cast<__nv_bfloat16*>(zin) + rg * 4 * lda + 3 * r + q;
          const float n4[4] = {nz.x, nz.y, nz.z, nz.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) xr[u * lda] = __float2bfloat16_rn(n4[u]);
        }
      }
    }
  }
};

template <bool kBayes, bool kBf16, int kRows>
__global__ void __launch_bounds__(kThreads, 1)
ude_trajectory_kernel(const float* __restrict__ zh0, const float* __restrict__ ztail, int B, int T,
                      float dt, float fa_w, const __grid_constant__ UdeArgs args,
                      const __grid_constant__ Plan plan, float* __restrict__ out) {
  using Tr = Traj<kBayes, kBf16, kRows>;
  unsigned char* smem = ude_smem;
  // the plan and the arguments into shared memory (the first kArgsBytes):
  // read there, an index into them is a shared load, not a generic one into
  // the parameter space
  {
    const int* from[2] = {reinterpret_cast<const int*>(&plan), reinterpret_cast<const int*>(&args)};
    int* to[2] = {reinterpret_cast<int*>(smem), reinterpret_cast<int*>(smem + sizeof(Plan))};
    const int n[2] = {(int)(sizeof(Plan) / 4), (int)(sizeof(UdeArgs) / 4)};
    for (int h = 0; h < 2; ++h)
      for (int i = threadIdx.x; i < n[h]; i += kThreads) to[h][i] = from[h][i];
    __syncthreads();
  }
  const Plan& p = *reinterpret_cast<const Plan*>(smem);
  const UdeArgs& a = *reinterpret_cast<const UdeArgs*>(smem + sizeof(Plan));
  const Tr tr{a, p, (int)blockIdx.x * kRows, B};
  const int W3 = 3 * a.R, row0 = tr.row0;
  float* zh = reinterpret_cast<float*>(smem + p.zh);
  float* zs = reinterpret_cast<float*>(smem + p.zs);
  float* zin = reinterpret_cast<float*>(smem + p.zin);
  constexpr bool kMmaRows = kBf16;   // the tensor cores' bfloat16 rows
  const int lda = operand_stride(kBayes ? W3 + a.DT : W3);
  __nv_bfloat16* zin_rows = reinterpret_cast<__nv_bfloat16*>(zin);
  if (kMmaRows) {   // they start as zeros, and their padding stays so
    for (int o = p.zin + 16 * threadIdx.x; o < p.zs; o += 16 * kThreads)
      *reinterpret_cast<float4*>(smem + o) = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int o = p.h0 + 16 * threadIdx.x; o < p.rates; o += 16 * kThreads)
      *reinterpret_cast<float4*>(smem + o) = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < kRows * W3; idx += kThreads) {
    const int row = idx / W3, c = idx % W3;
    const float v = row0 + row < B ? zh0[(size_t)(row0 + row) * W3 + c] : 0.f;
    zh[c * kRows + row] = v;
    zs[c * kRows + row] = v;
    if (kMmaRows) zin_rows[row * lda + c] = __float2bfloat16_rn(v);
  }
  // the tail only feeds a product: K7's after the head in zin, K2's in kbuf
  float* tl = kBayes ? zin + W3 * kRows : reinterpret_cast<float*>(smem + p.kbuf);
  for (int idx = threadIdx.x; idx < kRows * a.DT; idx += kThreads) {
    const int row = idx / a.DT, c = idx % a.DT;
    const float v = row0 + row < B ? ztail[(size_t)(row0 + row) * a.DT + c] : 0.f;
    if (kMmaRows && kBayes)
      zin_rows[row * lda + W3 + c] = __float2bfloat16_rn(v);
    else
      tl[c * kRows + row] = kBf16 ? round_bf16(v) : v;
  }
  const int E = 4 * (T - 1);
  if (p.dec)
    copy_rows<4>(smem + p.dec, reinterpret_cast<const unsigned char*>(a.dec_w), 0, W3, W3,
                 a.R_out, p.ldw_dec);
  if (E > 0) {
    if (p.resident)
      for (int c = 0; c < p.n_chunks; ++c) tr.copy_chunk(c, 0, 0);
    else
      tr.copy_chunk(0, 0, 0);
  }
  __syncthreads();
  if (!kBayes) tr.run_ct();

  int g = 0;
  for (int e = 0; e < E; ++e) {
    const int stage = e & 3;
    for (int s = 0; s < p.n_steps; ++s)
      g = tr.run_step(stage == 0 && s == p.dec_step ? p.dec_jobs : p.step[s], s, e, E, g, e >> 2,
                      out);
    __syncthreads();
    tr.combine(stage, dt, fa_w);
  }
  cp_async_wait_all();
  __syncthreads();
  tr.run_decode(T - 1, out);
}

template <bool kBayes, bool kBf16, int kRows>
int launch_tile(const float* zh0, const float* ztail, int B, int T, float dt, float fa_w,
                const UdeArgs& a, const Plan& p, float* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(ude_trajectory_kernel<kBayes, kBf16, kRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kRows - 1) / kRows;
  ude_trajectory_kernel<kBayes, kBf16, kRows><<<blocks, kThreads, p.smem_bytes,
                                                static_cast<cudaStream_t>(stream)>>>(
      zh0, ztail, B, T, dt, fa_w, a, p, out);
  return cudaGetLastError();
}

// Launch on `stream` with the plan of plan_len ints at `plan`
// (ops/fused_ude.py::TrajectoryPlan.flat()), in blocks of the plan's tile;
// refuse a plan read_plan does not take.
template <bool kBayes, bool kBf16>
int launch_trajectory(const float* zh0, const float* ztail, int B, int T, float dt, float fa_w,
                      const UdeArgs& a, const int* plan, int plan_len, float* out, void* stream) {
  Plan p;
  if (plan == nullptr || !read_plan(a, kBayes, kBf16, plan, plan_len, p))
    return cudaErrorInvalidValue;
  if constexpr (!kBf16)
    if (p.tile == kWideTile)
      return launch_tile<kBayes, kBf16, kWideTile>(zh0, ztail, B, T, dt, fa_w, a, p, out, stream);
  return launch_tile<kBayes, kBf16, kTile>(zh0, ztail, B, T, dt, fa_w, a, p, out, stream);
}

}  // namespace
