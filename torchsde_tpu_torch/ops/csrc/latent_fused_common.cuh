// Numerics and shared-memory helpers common to the latent-SDE whole-solve
// kernels (latent_fused_fwd.cu, latent_fused_bwd.cu), so that the reverse
// sweep recomputes exactly the forward kernel's activations.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace tsde_latent {

constexpr int TB = 8;            // batch rows per block
constexpr float EPS = 1e-7f;     // stable_division clamp

// Reserves n floats at `at`, keeping every array on a 16-byte boundary so
// activations can be read as float4.
__host__ __device__ inline size_t take(size_t& at, size_t n) {
  size_t start = at;
  at += (n + 3) & ~size_t(3);
  return start;
}

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
