// What the Back-GRU encoder's two thread-block-cluster kernels share: the
// forward recurrence (K1/K3, csrc/fused_gru.cu) and the reverse sweep of its
// BPTT (K4, csrc/fused_gru_train.cu).  Both split a layer's hidden units
// across the C CTAs of a cluster, sum each unit's products over a fixed
// group of S lanes (split-K) reduced by the same shuffle reduce-scatter, pad
// a resident weight slice's rows against shared-memory bank conflicts, and
// launch with cudaLaunchKernelEx on a non-portable cluster size.  The launch
// plans that use these helpers are mirrored in Python by
// fiude_tpu_torch/ops/fused_gru.py (recurrence_plan) and
// fiude_tpu_torch/ops/fused_gru_train.py (bptt_plan).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCluster = 16;          // with cudaFuncAttributeNonPortableClusterSizeAllowed
constexpr int kSmemLimit = 232448;       // dynamic shared memory a block can use

// S: the largest power of two from 4 to 32 with which a layer's (unit, row
// group) pairs fill its threads.
inline int split_lanes(int pairs, int threads) {
  int S = 4;
  while (S < 32 && pairs * S * 2 <= threads) S *= 2;
  return S;
}

// Row stride of a resident slice of `cols` columns.  One warp load reads S
// consecutive rows (the split-K lanes) of nu = 32 / (S * RG) consecutive
// units: a stride of nu times an odd number puts them in 32 different banks.
inline int slice_stride(int cols, int S, int RG) {
  const int nu = S * RG >= 32 ? 1 : 32 / (S * RG);
  int m = (cols + nu - 1) / nu;
  if (m % 2 == 0) ++m;
  return m * nu;
}

// The shuffle mask of the aligned group of S lanes that holds lane `tid`.
__host__ __device__ inline unsigned group_mask(int tid, int S) {
  return S == 32 ? 0xffffffffu : ((1u << S) - 1u) << ((tid & 31) & ~(S - 1));
}

__device__ __forceinline__ float4 splat(float v) { return make_float4(v, v, v, v); }

__device__ __forceinline__ float lane(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// The sum of row s & 3 of a row group, over the S lanes of an aligned group
// (S >= 4) that each hold a partial sum of the group's 4 rows: two halving
// steps leave each lane one row (a reduce-scatter), the rest add across the
// lanes that hold the same row.  Every step adds the same two partial sums,
// in one order or the other, so a row's sum has one tree whatever its slot,
// and the lanes that hold it agree bit for bit.
__device__ __forceinline__ float row_sum(const float4& v, int s, int S, unsigned mask) {
  const bool odd = s & 1, hi = s & 2;
  const float lo2 = (odd ? v.y : v.x) + __shfl_xor_sync(mask, odd ? v.x : v.y, 1);
  const float hi2 = (odd ? v.w : v.z) + __shfl_xor_sync(mask, odd ? v.z : v.w, 1);
  float out = (hi ? hi2 : lo2) + __shfl_xor_sync(mask, hi ? lo2 : hi2, 2);
  for (int m = 4; m < S; m <<= 1) out += __shfl_xor_sync(mask, out, m);
  return out;
}

// The cluster launch of `kernel` with `threads` threads and `smem` bytes of
// dynamic shared memory a CTA, its attributes set.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int cluster, int n_clusters, int threads, int smem,
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
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace
