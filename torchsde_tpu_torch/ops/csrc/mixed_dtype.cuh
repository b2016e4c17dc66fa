// bf16 mixed mode's element helpers, shared by the latent-SDE kernels
// (latent_fused_common.cuh) and the SDE-GAN kernels (gan_fused_common.cuh).
//
// A kernel templated on W, the storage type of its weights and bf16
// streams (float, or __nv_bfloat16 in mixed mode), widens each element to
// float as it reads it (to_f, ldw) and rounds a product's input to W
// (rnd<W>): a bf16 x bf16 product is exact in float32, so an FMA chain over
// rounded operands is the JAX package's dot with preferred_element_type
// float32 up to the order of its sum. With W = float every rounding is the
// identity and every read the float32 kernel's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tsde_mixed {

// A value of a stream or weight as float (exact).
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A float as a stream's element (rounded to nearest even in bf16).
template <typename W>
__device__ __forceinline__ W from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A product's input: v rounded to W and widened back.
template <typename W>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<W>(v));
}

// A weight read through the read-only cache; a bf16 one by a plain load
// (the bf16 __ldg is an inline asm the compiler does not schedule around).
__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

}  // namespace tsde_mixed
