// What the SDE-GAN whole-solve kernels share (gan_gen_fwd.cu, gan_cde_fwd.cu
// and their reverse sweeps gan_gen_bwd.cuh, gan_cde_bwd.cu): the limits of
// their widths, the width of a row's group of lanes, lipswish with precise
// expf, and the weight-gradient partials of the sweeps with their sum.
//
// A batch row is served by a group of G lanes inside one warp, lane l
// owning state unit l and hidden unit l (G a power of two at least
// max(S, M), at most 32; 32 / G rows a warp). Rows never interact, so a
// step needs no block barrier. A row's vectors go through the warp's
// shared memory (gan_warp_rows.cuh): every kernel evaluates a tower with
// the same arithmetic, in the same order of every sum (layer 1 from the
// time term, the state's terms in order, the bias last; layer 2 the hidden
// units in order, then the bias, then tanh).
//
// The forward kernels (5 and 7) are templated on W, the storage type of
// their weights and noise: float, or __nv_bfloat16 for bf16 mixed mode
// (their _bf16 entry points; the JAX package's rule: the state, the
// slopes, the cotangents and every sum stay float32). The weights are
// widened once, as they are staged in shared memory and registers; the
// products' inputs are rounded to W where the JAX package's _tower_fwd
// rounds them (rnd<W>, mixed_dtype.cuh). With W = float the kernels are
// the float32 ones. The reverse sweeps here are float32 only; bf16
// kernels 6 and 8 are kernels of their own (gan_bwd_bf16.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "mixed_dtype.cuh"

namespace tsde_gan {

using tsde_mixed::from_f;
using tsde_mixed::ldw;
using tsde_mixed::rnd;
using tsde_mixed::to_f;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_LANES = 32;     // S, M <= 32: a row's group fits a warp
constexpr int MAX_K = 8;          // noise or control channels per unit
constexpr int MAX_THREADS = 256;

__host__ __device__ inline int group_width(int S, int M) {
  const int need = S > M ? S : M;
  int G = 1;
  while (G < need) G <<= 1;
  return G;
}

// lipswish as the JAX kernel computes it: 0.909 * x * sigmoid(x), with a
// precise expf.
__device__ __forceinline__ float lipswish(float x) {
  return 0.909f * x * (1.f / (1.f + expf(-x)));
}

// The group width of kernels 5, 6 and 8 is at least 16, so it takes one of
// two values and is a template parameter: a lane's weights (kernel 5) or
// weight-gradient accumulators (6, 8) are then register arrays of
// compile-time size. Lanes past S or M add exact zeros.
__host__ __device__ inline int bwd_group_width(int S, int M) {
  const int G = group_width(S, M);
  return G < 16 ? 16 : G;
}

// ---------------------------------------------------------------------------
// Backward kernels.
//
// Weight-gradient partials: one for each warp of the reverse sweep (the
// rows of a warp are summed inside it), so their number does not depend on
// the block size.
__host__ __device__ inline int bwd_partials(int B, int S, int M) {
  const int rows_per_warp = 32 / bwd_group_width(S, M);
  return (B + rows_per_warp - 1) / rows_per_warp;
}

// The hidden unit's activation and lipswish's derivative at its
// pre-activation x, with lipswish's arithmetic.
__device__ __forceinline__ void lipswish_and_slope(float x, float& a,
                                                   float& slope) {
  const float s = 1.f / (1.f + expf(-x));
  a = 0.909f * x * s;
  slope = 0.909f * (s + x * s * (1.f - s));
}

// Sums v over the G lanes of each group, in a fixed butterfly: every lane
// of the group ends with the same sum.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL, v, off, G);
  return v;
}

// out[e] = the sum over p < n of partials[p * P + e], one warp per element:
// lane l adds partials l, l + 32, ... in order, then the lanes' sums meet in
// a fixed butterfly. No atomics: the same partials give bitwise the same
// sums.
static __global__ void sum_partials(const float* partials, int n, int P,
                                    float* out) {
  const int e = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= P) return;
  float acc = 0.f;
  for (int p = lane; p < n; p += 32) acc += partials[size_t(p) * P + e];
  acc = group_sum<32>(acc);
  if (lane == 0) out[e] = acc;
}

constexpr int SUM_THREADS = 256;

static inline cudaError_t launch_sum_partials(const float* partials, int n,
                                              int P, float* out,
                                              cudaStream_t stream) {
  constexpr int per_block = SUM_THREADS / 32;
  sum_partials<<<(P + per_block - 1) / per_block, SUM_THREADS, 0, stream>>>(
      partials, n, P, out);
  return cudaGetLastError();
}

}  // namespace tsde_gan
