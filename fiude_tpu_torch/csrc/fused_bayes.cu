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
// card a block holds 16 or 32 rows: were every block to draw all P = 73,493
// normals itself per evaluation (the `state` config), ~100 integer and
// transcendental operations a weight would stand against 16 or 32
// multiply-adds a weight, 128 blocks over, and the 294 KB of effective
// weights do not fit a block's shared memory beside its state.  The noise is shared by all rows,
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
// memory: 12.6 GB a request of 128 blocks, whether 2048 rows in 16-row
// blocks or 4096 in 32-row ones (25.3 GB for 4096 rows in 16-row blocks,
// the tile K7 took before it had a wide one; ops/fused_ude.py::tile_for
// takes 32 rows where 16-row blocks would need more than one wave of the
// card's SMs).  K7 streams them through two
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
//
// The draw's design (bayes_draw_kernel).  Its outputs, each optional: w
// (E, P); w^T, each matrix transposed in its own slot, for K9's products
// with the weights' transposes; z (E, P), the noise K9 replays; or, in the
// bfloat16 mode, wb (E, P) bfloat16 with the biases in float32 in bias
// (E, PB).  P = 73,493 at the `state` widths is odd, so every evaluation's
// row, and every array in it, starts at any 4-byte (bfloat16: 2-byte)
// boundary; the layout is K7/K8/K9's and is never padded.
// * A block owns one tile of one array (32 rows x 32 columns; a 1-row array,
//   a bias, walks as rows of 32 elements and is its own transpose) and a
//   group of consecutive evaluations.  The tiles are numbered array by array,
//   row by row (blockIdx.x); the plan (ops/fused_bayes.py::draw_plan) gives
//   the arrays and the group, grid.y = ceil(E / group), and read_draw_plan
//   checks it and lays out a table of each tile's (array, tile row, tile
//   column) in the kernel's parameters.  A block reads its entry once, into
//   uniform registers; no thread searches the arrays or divides an index.
//   (A block that finds its array among the arrays' first tiles and divides
//   for its tile row and column, once, keeps those values in more
//   registers, 61-62 a thread against 48 (or spills at 48), and draws 3-30%
//   slower on the H100: PERF.md, the weight draw's findings.)
// * Each thread draws 4 elements of the tile (column t % 32, rows t / 32 +
//   8j) in every evaluation of the group; their means and |stds| are loaded
//   once, and so is every part of Philox that does not change with the
//   evaluation in the source: the 10 round keys (the seed's) and rounds
//   0-1's products of the element index (philox.cuh).  An evaluation adds
//   its own rounds 0-1 product (one for the block) and runs rounds 2-9.
//   (ptxas keeps the keys as the seed plus a constant and adds them again on
//   the uniform datapath where a round needs them.)
// * The tile's w and z go to shared memory (two buffers of 32 x 33 floats
//   each, so a bank never serves two lanes of a row or of a column, and one
//   barrier an evaluation), then out: the tile's rows to w, z, wb and bias,
//   its columns to w^T, each row or column a segment stored by 8 lanes, one
//   16-byte vector a lane (bfloat16: 8 bytes, 4 elements) between a scalar
//   head up to the first aligned address and a scalar tail, all streaming
//   stores (st.global.cs).  Both sides of the transpose are coalesced.
// * The weight is fmaf(z, |std|, mean): one rounding, as the expression
//   mean + z * |std| compiles to under nvcc's default -fmad=true.
// What bounds it.  A normal of the function costs Philox's 8 remaining
// rounds (two wide multiplies and two three-way XORs each), the map to
// uniforms, the accurate logf, cosf and sqrtf and the multiply-add:
// utils/sass.py counts them in draw_normal_probe below, the function alone,
// for the issue bound.  This kernel issues more a normal: the key adds
// above, its staging and stores, and a few bytes of spills (sqrtf's slow
// path is a CALL, and ptxas saves some of the elements' registers around it;
// the kernel uses 48 registers of the 255 its launch bounds allow, so the
// spills are not a register limit's).  The serving modes write 4 bytes a
// weight (w) or 2 (bfloat16) and are bound by the issue rate; a block there
// draws up to 4 evaluations, setting up its tile once.  The training modes
// write 12 (w, w^T and z) and are bound by their stores: a segment's first
// and last 32-byte sectors are shared with the neighbouring tile's (P is
// odd, so no layout of the tiles aligns them), and on the H100 such stores
// drain fastest from blocks of one evaluation each, which the plan then
// gives, and as streaming stores (scripts/port_draw_times.py --groups times
// each mode at other groups).

#include "fused_ude.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxArrays = 3 + 4 * kMaxDeep;   // w0_head, w0_tail, b0, (w, b) per later layer
constexpr int kDrawThreads = 256;
constexpr int kDrawTile = 32;                  // a tile's rows and columns
constexpr int kDrawPitch = kDrawTile + 1;      // a staged tile's row, in floats
constexpr int kDrawRows = kDrawTile * kDrawTile / kDrawThreads;   // elements a thread draws
constexpr int kDrawMaxTiles = 768;             // the tile table's room in the parameters

struct DrawArray { int off, rows, cols, boff; };   // boff: among the biases, or -1
struct DrawPlan {          // read_draw_plan's reading of DrawPlan.flat()
  int E, group, P, PB, n_arr, n_tiles;
  DrawArray arr[kMaxArrays];
  unsigned tile[kDrawMaxTiles];   // array | tile row << 8 | tile column << 20
};
static_assert(sizeof(DrawPlan) + 10 * sizeof(void*) <= 4096, "the draw's parameters");

// b0 is array 2, and every later layer is a (w, b) pair from array 3 on.
__host__ __device__ inline bool is_bias(int k) { return k == 2 || (k >= 3 && (k - 3) % 2 == 1); }

// A 1-row array walks as rows of kDrawTile elements.
__host__ __device__ inline int walk_cols(const DrawArray& a) {
  return a.rows == 1 ? kDrawTile : a.cols;
}
__host__ __device__ inline int walk_rows(const DrawArray& a) {
  return a.rows == 1 ? (a.cols + kDrawTile - 1) / kDrawTile : a.rows;
}

// Streaming stores (st.global.cs): the outputs are written once and read by the
// next kernel, and a store that lingers in L2 beside them only slows the draw.
__device__ __forceinline__ void put(float* d, float v) { __stcs(d, v); }
__device__ __forceinline__ void put(__nv_bfloat16* d, float v) {
  __stcs(reinterpret_cast<unsigned short*>(d), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
__device__ __forceinline__ void put4(float* d, float a, float b, float c, float e) {
  __stcs(reinterpret_cast<float4*>(d), make_float4(a, b, c, e));
}
__device__ __forceinline__ void put4(__nv_bfloat16* d, float a, float b, float c, float e) {
  const auto h = [](float v) { return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v)); };
  __stcs(reinterpret_cast<uint2*>(d), make_uint2(h(a) | h(b) << 16, h(c) | h(e) << 16));
}

// Lanes l = 0-7 store a segment of n <= 32 staged elements (element j at
// src[j * step] in shared memory) to dst[0, n): a scalar head up to the first
// address a vector of 4 elements may start at, one vector a lane, a scalar tail.
template <typename T>
__device__ __forceinline__ void store_segment(T* dst, const float* src, int step, int n, int l) {
  constexpr unsigned kVector = 4 * sizeof(T);
  const int head = min(n, (int)(((0u - (unsigned)(uintptr_t)dst) & (kVector - 1)) / sizeof(T)));
  const int body = (n - head) >> 2, tail = n - head - 4 * body;
  if (l < head) put(dst + l, src[l * step]);
  if (l < body) {
    const int j = head + 4 * l;
    put4(dst + j, src[j * step], src[(j + 1) * step], src[(j + 2) * step], src[(j + 3) * step]);
  }
  if (l < tail) {
    const int j = head + 4 * body + l;
    put(dst + j, src[j * step]);
  }
}

// w[e][p] = mean[p] + z * std[p] with z = noise[e][p] (kNoise) or the Philox
// normal of (seed, e, array, element), for the plan's tile blockIdx.x and
// evaluations [group * blockIdx.y, + group); every output is optional.
template <bool kNoise>
__global__ void __launch_bounds__(kDrawThreads)
bayes_draw_kernel(const float* __restrict__ mean, const float* __restrict__ stdabs,
                  const float* __restrict__ noise, unsigned long long seed,
                  const __grid_constant__ DrawPlan plan, float* __restrict__ w,
                  float* __restrict__ wt, float* __restrict__ zout,
                  __nv_bfloat16* __restrict__ wb, float* __restrict__ bias) {
  __shared__ float sw[2][kDrawTile * kDrawPitch];
  __shared__ float sz[2][kDrawTile * kDrawPitch];
  const unsigned code = plan.tile[blockIdx.x];
  const int k = (int)(code & 255u);
  const DrawArray a = plan.arr[k];
  const bool flat = a.rows == 1;
  const int wcols = walk_cols(a), n = a.rows * a.cols;
  const int r0 = (int)((code >> 8) & 4095u) * kDrawTile, c0 = (int)(code >> 20) * kDrawTile;
  const int nr = min(kDrawTile, walk_rows(a) - r0), nc = min(kDrawTile, wcols - c0);
  // a tile row's elements: a matrix's all nc; a walked 1-row array's last may be short
  auto row_len = [&](int r) { return flat ? min(kDrawTile, n - (r0 + r) * kDrawTile) : nc; };

  // the draw: column c of rows rq + 8j
  const int c = threadIdx.x % kDrawTile, rq = threadIdx.x / kDrawTile;
  const philox::Keys keys = philox::keys(seed);
  bool ok[kDrawRows];
  int idx[kDrawRows];
  float mu[kDrawRows], sd[kDrawRows];
  philox::Element el[kDrawRows];
#pragma unroll
  for (int j = 0; j < kDrawRows; ++j) {
    const int r = rq + j * (kDrawThreads / kDrawTile);
    ok[j] = r < nr && c < row_len(r);
    idx[j] = (r0 + r) * wcols + c0 + c;
    mu[j] = ok[j] ? mean[a.off + idx[j]] : 0.f;
    sd[j] = ok[j] ? stdabs[a.off + idx[j]] : 0.f;
    if (!kNoise) el[j] = philox::element(keys, (uint32_t)idx[j]);
  }
  // the stores: segment q (a tile row, or for w^T a tile column) by lanes l
  const int q = threadIdx.x / 8, l = threadIdx.x % 8;
  const int e0 = (int)blockIdx.y * plan.group, ne = min(plan.group, plan.E - e0);
  for (int g = 0; g < ne; ++g) {
    const int e = e0 + g;
    const size_t base = (size_t)e * plan.P + a.off;
    float* tw = sw[g & 1];
    float* tz = sz[g & 1];
    philox::Evaluation ev = {};
    if (!kNoise) ev = philox::evaluation(keys, (uint32_t)e, (uint32_t)k);
#pragma unroll
    for (int j = 0; j < kDrawRows; ++j) {
      if (!ok[j]) continue;
      const int at = (rq + j * (kDrawThreads / kDrawTile)) * kDrawPitch + c;
      const float z = kNoise ? noise[base + idx[j]] : philox::normal(keys, el[j], ev);
      tw[at] = fmaf(z, sd[j], mu[j]);
      if (zout != nullptr) tz[at] = z;
    }
    __syncthreads();     // the other buffer is free: every thread passed this after its last store
    if (q < nr) {
      const int len = row_len(q);
      const size_t at = base + (size_t)(r0 + q) * wcols + c0;
      const float* row = tw + q * kDrawPitch;
      if (w != nullptr) store_segment(w + at, row, 1, len, l);
      if (zout != nullptr) store_segment(zout + at, tz + q * kDrawPitch, 1, len, l);
      if (wb != nullptr) {
        store_segment(wb + at, row, 1, len, l);
        if (a.boff >= 0)
          store_segment(bias + (size_t)e * plan.PB + a.boff + (at - base), row, 1, len, l);
      }
      if (wt != nullptr && flat) store_segment(wt + at, row, 1, len, l);
    }
    if (wt != nullptr && !flat && q < nc)      // column q of the tile is a row of w^T
      store_segment(wt + base + (size_t)(c0 + q) * a.rows + r0, tw + q, kDrawPitch, nr, l);
  }
}

// Reads the plan of n ints at v (ops/fused_bayes.py::DrawPlan.flat()) into p
// and checks what the kernel relies on, for E evaluations of the n_arr packed
// arrays (rows[k] x cols[k], P elements in all): its threads and tile size;
// 1 <= group <= E and ceil(E / group) <= 65,535 (grid.y); each array's
// offset, shape and bias offset (a bias is one row); the count of tiles, at
// most kDrawMaxTiles.  Lays out the tile table, array by array, row by row.
bool read_draw_plan(const int* v, int n, int E, int P, int n_arr, const int* rows,
                    const int* cols, DrawPlan& p) {
  constexpr int kHead = 9;
  if (v == nullptr || n_arr < 1 || n_arr > kMaxArrays || n != kHead + 4 * n_arr) return false;
  p = DrawPlan{};
  const int threads = v[0], tile = v[1], groups = v[4];
  p.E = v[2]; p.group = v[3]; p.P = v[5]; p.PB = v[6]; p.n_arr = v[7]; p.n_tiles = v[8];
  if (threads != kDrawThreads || tile != kDrawTile || p.E != E || E < 1 || p.group < 1 ||
      p.group > E || groups != (E - 1) / p.group + 1 || groups > 65535 || p.P != P || P < 1 ||
      p.n_arr != n_arr)
    return false;
  const int* at = v + kHead;
  long long off = 0, PB = 0;
  int t = 0;
  for (int k = 0; k < n_arr; ++k, at += 4) {
    DrawArray& a = p.arr[k];
    a = DrawArray{at[0], at[1], at[2], at[3]};
    if (rows[k] < 0 || cols[k] < 1 || a.rows != rows[k] || a.cols != cols[k] || a.off != off ||
        a.boff != (is_bias(k) ? PB : -1) || (is_bias(k) && a.rows != 1))
      return false;
    off += (long long)a.rows * a.cols;
    if (is_bias(k)) PB += a.cols;
    if (off > P) return false;
    const int down = (walk_rows(a) + kDrawTile - 1) / kDrawTile;
    const int across = (walk_cols(a) + kDrawTile - 1) / kDrawTile;
    if (down * across > kDrawMaxTiles - t) return false;   // down x across <= P: no overflow
    for (int tr = 0; tr < down; ++tr)
      for (int tc = 0; tc < across; ++tc)
        p.tile[t++] = (unsigned)k | (unsigned)tr << 8 | (unsigned)tc << 20;
  }
  return off == P && p.PB == PB && p.n_tiles == t;
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

// The draw's function on its own, for counting what it issues: never
// launched.  fiude_tpu_torch/utils/sass.py reads these kernels' SASS in the
// built library and takes the instructions of one normal as the difference
// between the evaluation loops of draw_normal_probe<2> and
// draw_normal_probe<1>: Philox's rounds 2-9, the map of bits to uniforms, the
// accurate logf, cosf and sqrtf (their hot paths) and the multiply-add that
// makes a weight.  That is the least a draw of the same bits issues a weight;
// the loop, the evaluation's part of Philox and whatever a draw kernel adds
// to it (its tile, its stores, its register traffic) cancel in the
// difference.  The draw's issue bound (sass.draw_bound) rests on this count,
// not on bayes_draw_kernel's own.  They stand outside the anonymous namespace:
// a kernel of internal linkage that nothing calls is left out of the build.

// Each thread keeps kN weights (element i0 + j) through E evaluations of
// array 0: w = fmaf(z, std, w), the weight's one multiply-add, chained so that
// nothing else is needed to keep it.
template <int kN>
__global__ void draw_normal_probe(unsigned long long seed, const float* __restrict__ mean,
                                  const float* __restrict__ stdabs, int E,
                                  float* __restrict__ out) {
  const philox::Keys keys = philox::keys(seed);
  const int i0 = ((int)blockIdx.x * (int)blockDim.x + (int)threadIdx.x) * kN;
  philox::Element el[kN];
  float w[kN], sd[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    el[j] = philox::element(keys, (uint32_t)(i0 + j));
    w[j] = mean[i0 + j];
    sd[j] = stdabs[i0 + j];
  }
#pragma unroll 1
  for (int e = 0; e < E; ++e) {
    const philox::Evaluation ev = philox::evaluation(keys, (uint32_t)e, 0u);
#pragma unroll
    for (int j = 0; j < kN; ++j) w[j] = fmaf(philox::normal(keys, el[j], ev), sd[j], w[j]);
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) out[i0 + j] = w[j];
}

template __global__ void draw_normal_probe<1>(unsigned long long, const float*, const float*,
                                              int, float*);
template __global__ void draw_normal_probe<2>(unsigned long long, const float*, const float*,
                                              int, float*);

extern "C" {

// The effective weights of E evaluations.  mean, stdabs (P): the packed
// arrays end to end, n_arr of them with rows[k] x cols[k] elements; noise
// (E, P) or null (then Philox from `seed`); writes, each unless null, w (E, P),
// wt (E, P), z (E, P), and for the bfloat16 compute mode wb (E, P) bfloat16
// with bias (E, PB) float32, PB the total length of the bias arrays (b0, then
// each later layer's).  plan (plan_len ints): ops/fused_bayes.py::
// DrawPlan.flat(), refused (cudaErrorInvalidValue) where read_draw_plan finds
// that the kernel cannot run it.  Launches on `stream`; returns
// cudaGetLastError().
int fused_bayes_draw(const float* mean, const float* stdabs, const float* noise,
                     unsigned long long seed, int E, int P, int n_arr, const int* rows,
                     const int* cols, const int* plan, int plan_len, float* w, float* wt,
                     float* z, void* wb, float* bias, void* stream) {
  DrawPlan p;
  if ((wb != nullptr) != (bias != nullptr) ||
      !read_draw_plan(plan, plan_len, E, P, n_arr, rows, cols, p))
    return cudaErrorInvalidValue;
  const dim3 grid(p.n_tiles, (E - 1) / p.group + 1);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* wb16 = static_cast<__nv_bfloat16*>(wb);
  if (noise != nullptr)
    bayes_draw_kernel<true><<<grid, kDrawThreads, 0, s>>>(mean, stdabs, noise, seed, p, w, wt,
                                                          z, wb16, bias);
  else
    bayes_draw_kernel<false><<<grid, kDrawThreads, 0, s>>>(mean, stdabs, noise, seed, p, w, wt,
                                                           z, wb16, bias);
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
