// Bulk standard normals from a counter-based generator, for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/prng.py:_normal_kernel
// (launched by pallas_normal), which reseeds the TPU's hardware generator a
// tile and turns its bits into normals by Box-Muller. That stream cannot be
// reproduced off the TPU, so the port has its own, a function of (seed, flat
// index) alone and not of how a launch is tiled: paired Box-Muller on
// Philox4x32-10 (Salmon et al., SC'11; Random123's constants) with key
// (seed, 0). Element e takes the counter (e / 4 as a 64-bit value in words
// 0-1, 0, 0); words 0 and 1 give elements 4c and 4c+1, words 2 and 3
// elements 4c+2 and 4c+3, as r cos(theta) and r sin(theta) with, in float32
// as prng.py:42-49, u = (bits >> 8) * 2^-24 + 2^-25, r = sqrt(-2 log u1)
// and theta = 2 pi u2. Each cosine is the JAX kernel's formula on its two
// words. ops/prng.py:philox_normal_plain computes the same stream with int64
// torch operations.
//
// What bounds it. The output, 4 bytes an element, is the only traffic:
// 268M normals are 1.07 GB, 0.32 ms at 3.35 TB/s. Four normals cost one
// Philox call (ten rounds of two 32 x 32 -> 64-bit products, XORs and key
// bumps) and two each of the accurate logf, sqrtf and sincosf (one range
// reduction for both halves): some 55 instructions a normal, about 0.5 ms
// at 132 SMs executing 128 thread-instructions a clock. The instruction
// rate, not the bytes, binds; PERF.md holds the measured time.
//
// Design. One thread per counter, that is per four elements, in a
// grid-stride loop; each quadruple is stored as one float4 (the output is
// 16-byte aligned at multiples of 4), a ragged tail of 1-3 elements alone.
// No fast math: __logf's absolute error near u1 = 1 (some 2^-21) would
// corrupt small r and could make the square root's argument negative. The
// seed is read from device memory, so drawing it from a generator needs no
// host sync.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;   // multipliers
constexpr unsigned W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;   // key bumps
constexpr int NT = 256;
constexpr float TWO_PI = 6.28318530717958647692f;

struct Words {
  unsigned w[4];
};

__device__ __forceinline__ Words philox4x32_10(Words c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += W0;
      k1 += W1;
    }
    const unsigned hi0 = __umulhi(M0, c.w[0]), lo0 = M0 * c.w[0];
    const unsigned hi1 = __umulhi(M1, c.w[2]), lo1 = M1 * c.w[2];
    Words n;
    n.w[0] = hi1 ^ c.w[1] ^ k0;
    n.w[1] = lo1;
    n.w[2] = hi0 ^ c.w[3] ^ k1;
    n.w[3] = lo0;
    c = n;
  }
  return c;
}

// Paired Box-Muller on two 24-bit uniforms in (0, 1), as prng.py:42-49:
// the cosine half and the sine half of one radius and angle.
__device__ __forceinline__ float2 box_muller(unsigned bits1, unsigned bits2) {
  const float u1 = float(bits1 >> 8) * 5.9604644775390625e-08f
                   + 2.98023223876953125e-08f;
  const float u2 = float(bits2 >> 8) * 5.9604644775390625e-08f
                   + 2.98023223876953125e-08f;
  const float r = sqrtf(-2.f * logf(u1));
  float s, c;
  sincosf(TWO_PI * u2, &s, &c);
  return make_float2(r * c, r * s);
}

__global__ void __launch_bounds__(NT) philox_normal_kernel(
    const int* seed, float* out, long long n) {
  const unsigned key = static_cast<unsigned>(__ldg(seed));
  const long long quads = (n + 3) / 4;
  for (long long q = blockIdx.x * static_cast<long long>(NT) + threadIdx.x;
       q < quads; q += static_cast<long long>(gridDim.x) * NT) {
    Words c;
    c.w[0] = static_cast<unsigned>(q);
    c.w[1] = static_cast<unsigned>(static_cast<unsigned long long>(q) >> 32);
    c.w[2] = 0u;
    c.w[3] = 0u;
    const Words b = philox4x32_10(c, key, 0u);
    const float2 lo = box_muller(b.w[0], b.w[1]);
    const float2 hi = box_muller(b.w[2], b.w[3]);
    if (4 * q + 3 < n) {
      reinterpret_cast<float4*>(out)[q] = make_float4(lo.x, lo.y, hi.x, hi.y);
    } else {
      const float z[4] = {lo.x, lo.y, hi.x, hi.y};
      for (long long e = 4 * q; e < n; ++e) out[e] = z[e - 4 * q];
    }
  }
}

}  // namespace

extern "C" {

// Writes n standard normals of the stream of the int32 seed at *seed (a
// device pointer) into out (n float32s on the device) on `stream`; returns
// cudaGetLastError() (0 on success).
int tsde_philox_normal(const int* seed, float* out, long long n, int device,
                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long quads = (n + 3) / 4;
  // Enough blocks for every SM to hold 8 (2048 threads), looping beyond.
  const long long want = (quads + NT - 1) / NT;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 8 ? want
                                                               : 132 * 8);
  philox_normal_kernel<<<blocks, NT, 0, stream>>>(seed, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
