// A row's vectors through the warp's shared memory: the helpers that the
// SDE-GAN kernels 5, 6, 7 and 8 (gan_gen_fwd.cu, gan_gen_bwd.cuh,
// gan_cde_fwd.cu, gan_cde_bwd.cu) share.
//
// A batch row is served by a group of lanes of one warp, lane l owning
// state unit l and hidden unit l. Each vector a product needs whole (the
// tower's input z1, the hidden activations, the output cotangents, ...)
// is written once to the row's slot in the warp's shared memory; after a
// __syncwarp every lane of the row reads it back four floats a load, all
// lanes of the row the same address (a broadcast). Each lane reads its own
// weights four a load too, from copies laid out lane-major: lane l's row
// starts at l times a stride of odd_quad floats (4 x an odd number), so
// the eight lanes of a quarter-warp, whose float4 loads the card serves
// together, hit eight distinct groups of four banks.

#pragma once

#include <cuda_runtime.h>

namespace tsde_gan {

// The smallest multiple of 4 at least n whose quarter is odd: the stride of
// a lane-major weight copy that a quarter-warp reads as float4 without
// bank conflicts.
__host__ __device__ inline int odd_quad(int n) {
  int q = (n + 3) / 4;
  if (q % 2 == 0) ++q;
  return 4 * q;
}

// acc = fmaf(v[j], w[j], acc) for j < n in order, v a row vector of the
// warp's shared memory and w a lane's weight row, both read as float4
// (NQ of them at most).
template <int NQ>
__device__ __forceinline__ float dot4(const float* v, const float* w, int n,
                                      float acc) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (4 * q >= n) break;
    const float4 x = v4[q], y = w4[q];
    acc = fmaf(x.x, y.x, acc);
    if (4 * q + 1 < n) acc = fmaf(x.y, y.y, acc);
    if (4 * q + 2 < n) acc = fmaf(x.z, y.z, acc);
    if (4 * q + 3 < n) acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// The first n floats of a row vector of the warp's shared memory into a
// lane's registers, read as float4 (N a multiple of 4; zeros past n's
// float4).
template <int N>
__device__ __forceinline__ void load4(const float* v, int n, float (&r)[N]) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * q < n) x = v4[q];
    r[4 * q] = x.x;
    r[4 * q + 1] = x.y;
    r[4 * q + 2] = x.z;
    r[4 * q + 3] = x.w;
  }
}

// acc = fmaf(v[j], w[j], acc) for j < n in order, v in a lane's registers
// and w its weight row in shared memory, read as float4.
template <int N>
__device__ __forceinline__ float dotr4(const float (&v)[N], const float* w,
                                       int n, float acc) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    if (4 * q >= n) break;
    const float4 y = w4[q];
    acc = fmaf(v[4 * q], y.x, acc);
    if (4 * q + 1 < n) acc = fmaf(v[4 * q + 1], y.y, acc);
    if (4 * q + 2 < n) acc = fmaf(v[4 * q + 2], y.z, acc);
    if (4 * q + 3 < n) acc = fmaf(v[4 * q + 3], y.w, acc);
  }
  return acc;
}

}  // namespace tsde_gan
