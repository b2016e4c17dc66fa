// The SDE-GAN towers (Linear, lipswish, Linear, tanh of [t, z]) for the
// whole-solve kernels (gan_gen_fwd.cu, gan_cde_fwd.cu, and the backward
// kernels gan_gen_bwd.cu, gan_cde_bwd.cu that recompute them), so every
// kernel evaluates a tower with the same arithmetic. Kernels 6, 7 and 8
// move a row's vectors through the warp's shared memory instead of the
// shuffles below (gan_warp_rows.cuh), in the same order of every sum.
//
// Layout (gan_gen_fwd.cu). A batch row is served by a group of G lanes
// inside one warp (G = the power of two >= max(S, M), at most 32; 32 / G
// rows per warp):
// lane l of the group owns hidden unit l of each tower and state unit l
// (with its K output channels). Rows never interact, so a step needs no
// block barrier: the only communication is __shfl_sync inside the group.
// A tower's weights sit in shared memory, padded with zeros to G columns so
// that lanes past M or S compute exact zeros and every lane runs the same
// instructions:
//   w1s[r * G + k]         = W1[r][k]               r < 1+S (row 0: time)
//   w2s[(k * K + j) * G + i] = W2[k][i * K + j]     output (i, j) of unit i
// Neighbouring lanes read neighbouring words, and the groups of a warp read
// the same words (a broadcast), so the reads are free of bank conflicts.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace tsde_gan {

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

__host__ __device__ inline size_t tower_w1_floats(int S, int G) {
  return size_t(1 + S) * G;
}

__host__ __device__ inline size_t tower_w2_floats(int M, int K, int G) {
  return size_t(M) * K * G;
}

// lipswish as the JAX kernel computes it: 0.909 * x * sigmoid(x), with a
// precise expf.
__device__ __forceinline__ float lipswish(float x) {
  return 0.909f * x * (1.f / (1.f + expf(-x)));
}

// Stages W1 (1+S, M) and W2 (M, S*K) of one tower into the padded layouts
// above, with the whole block.
__device__ inline void stage_tower(float* w1s, float* w2s, const float* W1,
                                   const float* W2, int S, int M, int K,
                                   int G) {
  for (int e = threadIdx.x; e < (1 + S) * G; e += blockDim.x) {
    const int r = e / G, k = e % G;
    w1s[e] = k < M ? W1[r * M + k] : 0.f;
  }
  for (int e = threadIdx.x; e < M * K * G; e += blockDim.x) {
    const int k = e / (K * G), j = (e / G) % K, i = e % G;
    w2s[e] = i < S ? W2[k * (S * K) + i * K + j] : 0.f;
  }
}

// Layer 1 of NT towers that share the input [t, z] (z distributed one unit
// per lane of the group): this lane's hidden pre-activation of each tower,
// bias added last, as x @ W1 + b1 sums. The z shuffles are shared by the
// towers.
template <int NT>
__device__ __forceinline__ void tower_layer1(const float* const (&w1s)[NT],
                                             const float (&b1)[NT], float t,
                                             float z, int S, int G, int li,
                                             float (&pre)[NT]) {
#pragma unroll
  for (int q = 0; q < NT; ++q) pre[q] = t * w1s[q][li];
#pragma unroll 4
  for (int i = 0; i < S; ++i) {
    const float zi = __shfl_sync(FULL, z, i, G);
#pragma unroll
    for (int q = 0; q < NT; ++q)
      pre[q] = fmaf(zi, w1s[q][(1 + i) * G + li], pre[q]);
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) pre[q] += b1[q];
}

// Layer 2 of one tower: the K outputs of this lane's state unit,
// tanh(a @ W2 + b2), from the hidden activations a (one per lane).
template <int K>
__device__ __forceinline__ void tower_layer2(const float* w2s, float a,
                                             const float (&b2)[K], int M,
                                             int G, int li,
                                             float (&out)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) out[j] = 0.f;
  const float* w = w2s + li;
#pragma unroll 4
  for (int k = 0; k < M; ++k) {
    const float ak = __shfl_sync(FULL, a, k, G);
#pragma unroll
    for (int j = 0; j < K; ++j) out[j] = fmaf(ak, w[j * G], out[j]);
    w += K * G;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) out[j] = tanhf(out[j] + b2[j]);
}

// ---------------------------------------------------------------------------
// Backward kernels.
//
// Their group width is at least 16, so it takes one of two values and is a
// template parameter: a lane's weight-gradient accumulators are then
// register arrays of compile-time size. Lanes past S or M add exact zeros.
__host__ __device__ inline int bwd_group_width(int S, int M) {
  const int G = group_width(S, M);
  return G < 16 ? 16 : G;
}

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
