// Numerics and shared-memory helpers common to the latent-SDE whole-solve
// kernels (latent_fused_fwd.cu, latent_fused_bwd.cu), so that the reverse
// sweep recomputes exactly the forward kernel's activations.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace tsde_latent {

constexpr int TB = 8;            // batch rows per block
constexpr float EPS = 1e-7f;     // stable_division clamp
constexpr int NW = 16;           // weights, in latent_fused.WEIGHT_NAMES order

// Reserves n floats at `at`, keeping every array on a 16-byte boundary so
// activations can be read as float4.
__host__ __device__ inline size_t take(size_t& at, size_t n) {
  size_t start = at;
  at += (n + 3) & ~size_t(3);
  return start;
}

// Element counts of the 16 weight tensors of one replica: the stride of
// each weight stack, and the layout of the weight gradients.
__host__ __device__ inline void weight_sizes(int L, int C, int H,
                                             size_t (&n)[NW]) {
  const size_t D = size_t(L) + C, h = H, l = L;
  const size_t sizes[NW] = {D * h, h, h * h, h, h * l, l,
                            l * h, h, h * h, h, h * l, l,
                            l * h, l * h, l * h, l};
  for (int i = 0; i < NW; ++i) n[i] = sizes[i];
}

// Replicas. A launch of K stacked replicas puts the replica on blockIdx.y:
// every per-replica array is (K, ...) replica-major, so replica k's block
// offsets each pointer by k times one replica's size, and reads ctx_idx and
// dts, which the replicas share, as they are. A single solve is the launch
// with K = 1, so replica k of a stacked launch runs exactly the code of a
// single solve on replica k's inputs.
__device__ __forceinline__ size_t replica() { return blockIdx.y; }

// jax.nn.softplus: logaddexp(x, 0).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Copies count floats with a block of NT threads.
template <int NT>
__device__ __forceinline__ void copy_to_smem(float* dst, const float* src,
                                             int count) {
  for (int e = threadIdx.x; e < count; e += NT) dst[e] = src[e];
}

}  // namespace tsde_latent

// The 16 weight pointers of the launch functions' C interface, in
// latent_fused.WEIGHT_NAMES order, and the same as an initialiser list.
#define TSDE_WEIGHT_PARAMS                                                   \
    const float* f_w1, const float* f_b1, const float* f_w2,                 \
    const float* f_b2, const float* f_w3, const float* f_b3,                 \
    const float* h_w1, const float* h_b1, const float* h_w2,                 \
    const float* h_b2, const float* h_w3, const float* h_b3,                 \
    const float* g_w1, const float* g_b1, const float* g_w2,                 \
    const float* g_b2
#define TSDE_WEIGHTS                                                         \
  {f_w1, f_b1, f_w2, f_b2, f_w3, f_b3, h_w1, h_b1, h_w2, h_b2, h_w3, h_b3,   \
   g_w1, g_b1, g_w2, g_b2}
