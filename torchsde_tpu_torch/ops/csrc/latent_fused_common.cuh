// Numerics and shared-memory helpers common to the latent-SDE whole-solve
// kernels (latent_fused_fwd.cu, latent_fused_bwd.cu), so that the reverse
// sweep recomputes exactly the forward kernel's activations.
//
// Their arguments are templated on W, the type of the weights and of the
// streams (context, noise, the states zs, their cotangents gz, dnoise):
// float, or __nv_bfloat16 for bf16 mixed mode (the JAX package's rule:
// the state, the KL channel and every sum stay float32). In mixed mode each
// product's inputs are rounded to bf16 (rnd<W>, mixed_dtype.cuh) and the
// product sums in float32, as the JAX package's dots with
// preferred_element_type float32 do. The mixed modes of the forward and of
// the reverse sweep are kernels of their own on bf16 tensor cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "mixed_dtype.cuh"

// Stage clocks, for measurement only: in a build with TSDE_STAGE_CLOCKS
// defined (chip_smoke.py --only tiles), thread 0 of every block of a bf16
// kernel that marks its stages (the sweep, the forward) adds each stage's
// clock cycles, barrier waits included, to tsde_stage_clocks[stage], an
// array each source defines in its own namespace; otherwise the marks are
// nothing.
#ifdef TSDE_STAGE_CLOCKS
#define TSDE_MARK(i)                                                       \
  do {                                                                     \
    if (threadIdx.x == 0) {                                                \
      const long long now = clock64();                                     \
      atomicAdd(&tsde_stage_clocks[i],                                     \
                static_cast<unsigned long long>(now - mark));              \
      mark = now;                                                          \
    }                                                                      \
  } while (0)
#else
#define TSDE_MARK(i) \
  do {               \
  } while (0)
#endif

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

// The element helpers of mixed mode (mixed_dtype.cuh).
using tsde_mixed::from_f;
using tsde_mixed::ldw;
using tsde_mixed::rnd;
using tsde_mixed::to_f;

// Copies count elements, widened to float, with a block of NT threads.
template <int NT, typename W>
__device__ __forceinline__ void copy_to_smem(float* dst, const W* src,
                                             int count) {
  for (int e = threadIdx.x; e < count; e += NT) dst[e] = to_f(src[e]);
}

// Asynchronous 4-byte copy into shared memory; zero-fills when !valid (src
// must still be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// One float of a stream into shared memory by cp.async (it lands by the
// next wait), zero when !valid (src must still be a valid address).
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      bool valid) {
  cp_async4(dst, src, valid);
}

}  // namespace tsde_latent

// The 16 weight pointers of the launch functions' C interface, in
// latent_fused.WEIGHT_NAMES order, of type T, and the same as an
// initialiser list.
#define TSDE_WEIGHT_PARAMS_T(T)                                              \
    const T* f_w1, const T* f_b1, const T* f_w2, const T* f_b2,              \
    const T* f_w3, const T* f_b3, const T* h_w1, const T* h_b1,              \
    const T* h_w2, const T* h_b2, const T* h_w3, const T* h_b3,              \
    const T* g_w1, const T* g_b1, const T* g_w2, const T* g_b2
#define TSDE_WEIGHT_PARAMS TSDE_WEIGHT_PARAMS_T(float)
#define TSDE_WEIGHTS                                                         \
  {f_w1, f_b1, f_w2, f_b2, f_w3, f_b3, h_w1, h_b1, h_w2, h_b2, h_w3, h_b3,   \
   g_w1, g_b1, g_w2, g_b2}
