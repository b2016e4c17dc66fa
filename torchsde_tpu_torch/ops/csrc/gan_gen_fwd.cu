// Whole-solve forward of the SDE-GAN generator, for Hopper (sm_90a), bound
// to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/gan_fused.py:_gen_fwd_kernel
// (launched by _gen_solve_fwd_impl). Same function: reversible Heun for a
// Stratonovich SDE with general noise, carry (x, z, f, g), per step
//   z1 = 2 x - z + dt f0 + g0 . dW
//   f1 = tanh(lipswish([t1, z1] @ W1f + b1f) @ W2f + b2f)        (S outputs)
//   g1 = tanh(lipswish([t1, z1] @ W1g + b1g) @ W2g + b2g)        (S*m outputs)
//   x1 = x + dt/2 (f0 + f1) + 1/2 (g0 + g1) . dW
// where g . dW is the per-row (S, m) @ (m) product, g[i*m + j] its (i, j).
//
// What bounds it. Per row and step it does (1+S)M + MS + (1+S)M + MSm + 2Sm
// multiply-adds: 1,664 at S=16, M=16, m=3, so 0.21 GFLOP for a solve of 63
// steps at B=1024 (3.2 us at the float32 peak). It writes ys, zs (N,B,S) and
// gs (N,B,S*m), 20.6 MB at that size, and reads 0.8 MB of noise: 6.5 us at
// 3.35 TB/s, so by the bytes it is bound by the stores. In practice it is
// bound by latency: 63 dependent steps of products far too small to fill
// the card.
//
// Design. A row's work stays inside one warp, so a step costs shuffles and
// no block barrier: a group of G lanes per row (G = 16 at the flagship,
// two rows per warp), lane l owning state unit l (its x, z, f and its m
// entries of g in registers, m a template parameter, so it forms its own
// g . dW with no tile matrices) and hidden unit l of both towers. Layer 1
// gathers z1 through __shfl_sync inside the group (shared by both towers),
// layer 2 gathers the hidden activations the same way. The towers' weights
// (1,664 floats at the flagship) are staged once per block into shared
// memory, zero-padded to G columns (gan_fused_common.cuh). Each step's
// noise, time and width are loaded one step ahead. With one lane per unit,
// 1024 rows fill 16,384 threads: 128 blocks of 128. The stores of a step
// are contiguous per row, and neighbouring rows are neighbouring in memory.
// Precise expf and tanhf; state and sums in float32. The kernel allocates
// nothing and does not synchronise the host.

#include <cuda_runtime.h>
#include <stddef.h>

#include "gan_fused_common.cuh"

namespace {

using namespace tsde_gan;

struct GenArgs {
  const float* x0;      // (B, S)
  const float* f0;      // (B, S)
  const float* g0;      // (B, S*m)
  const float* noise;   // (N, B, m)
  const float* t1s;     // (N,)
  const float* dts;     // (N,)
  const float* w[8];    // W1f b1f W2f b2f W1g b1g W2g b2g
  float* ys;            // (N, B, S)
  float* zs;            // (N, B, S)
  float* gs;            // (N, B, S*m)
  int B, S, M, m, N, G;
};

__host__ __device__ inline size_t gen_smem_floats(int S, int M, int m,
                                                  int G) {
  return 2 * tower_w1_floats(S, G) + tower_w2_floats(M, 1, G)
         + tower_w2_floats(M, m, G);
}

// Row `row`'s noise of step s (zeros for a row past the batch).
template <int m>
__device__ __forceinline__ void load_noise(const float* noise, int B, int s,
                                           int row, bool live,
                                           float (&dW)[m]) {
  const float* src = noise + (size_t(s) * B + row) * m;
#pragma unroll
  for (int j = 0; j < m; ++j) dW[j] = live ? __ldg(src + j) : 0.f;
}

// The number of noise channels m is a template parameter (1..MAX_K), so a
// lane's m entries of g and dW are registers and its loops over them are
// unrolled exactly.
template <int m>
__global__ void __launch_bounds__(MAX_THREADS)
gan_gen_fwd_kernel(const GenArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int S = a.S, M = a.M, B = a.B, G = a.G;
  float* w1f = sm;
  float* w1g = w1f + tower_w1_floats(S, G);
  float* w2f = w1g + tower_w1_floats(S, G);
  float* w2g = w2f + tower_w2_floats(M, 1, G);
  stage_tower(w1f, w2f, a.w[0], a.w[2], S, M, 1, G);
  stage_tower(w1g, w2g, a.w[4], a.w[6], S, M, m, G);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int li = lane & (G - 1);
  const int rows_per_warp = 32 / G;
  const int warp_row0 =
      (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * rows_per_warp;
  // No barrier follows: a warp with no row of the batch is done. The others
  // run every lane (the shuffles take the whole warp); rows past the end
  // compute on zeros and store nothing.
  if (warp_row0 >= B) return;
  const int row = warp_row0 + lane / G;
  const bool live = row < B;
  const bool unit = live && li < S;
  const bool hid = li < M;

  const float* w1s[2] = {w1f, w1g};
  const float b1[2] = {hid ? a.w[1][li] : 0.f, hid ? a.w[5][li] : 0.f};
  float b2f[1] = {li < S ? a.w[3][li] : 0.f};
  float b2g[m];
#pragma unroll
  for (int j = 0; j < m; ++j) b2g[j] = li < S ? a.w[7][li * m + j] : 0.f;

  float x = unit ? a.x0[size_t(row) * S + li] : 0.f;
  float z = x;
  float f = unit ? a.f0[size_t(row) * S + li] : 0.f;
  float g[m];
#pragma unroll
  for (int j = 0; j < m; ++j)
    g[j] = unit ? a.g0[(size_t(row) * S + li) * m + j] : 0.f;

  float dW_next[m];
  load_noise<m>(a.noise, B, 0, row, live, dW_next);
  float dt_next = __ldg(a.dts), t1_next = __ldg(a.t1s);
  for (int s = 0; s < a.N; ++s) {
    float dW[m];
#pragma unroll
    for (int j = 0; j < m; ++j) dW[j] = dW_next[j];
    if (s + 1 < a.N) load_noise<m>(a.noise, B, s + 1, row, live, dW_next);
    const float dt = dt_next, t1 = t1_next;
    if (s + 1 < a.N) {
      dt_next = __ldg(a.dts + s + 1);
      t1_next = __ldg(a.t1s + s + 1);
    }

    float g0dW = 0.f;
#pragma unroll
    for (int j = 0; j < m; ++j) g0dW = fmaf(g[j], dW[j], g0dW);
    const float z1 = 2.f * x - z + dt * f + g0dW;

    float pre[2];
    tower_layer1<2>(w1s, b1, t1, z1, S, G, li, pre);
    float f1[1], g1[m];
    tower_layer2<1>(w2f, lipswish(pre[0]), b2f, M, G, li, f1);
    tower_layer2<m>(w2g, lipswish(pre[1]), b2g, M, G, li, g1);

    float gsum = 0.f;
#pragma unroll
    for (int j = 0; j < m; ++j) gsum = fmaf(g[j] + g1[j], dW[j], gsum);
    x = x + 0.5f * dt * (f + f1[0]) + 0.5f * gsum;
    z = z1;
    f = f1[0];
#pragma unroll
    for (int j = 0; j < m; ++j) g[j] = g1[j];

    if (unit) {
      const size_t at = (size_t(s) * B + row) * S + li;
      a.ys[at] = x;
      a.zs[at] = z;
#pragma unroll
      for (int j = 0; j < m; ++j) a.gs[at * m + j] = g[j];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for these widths.
size_t tsde_gan_gen_fwd_smem_bytes(int S, int M, int m) {
  return gen_smem_floats(S, M, m, group_width(S, M)) * sizeof(float);
}

// Launches the solve on `stream` with `threads` threads per block and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// widths beyond the kernel's limits (S, M <= 32, m <= 8, threads a multiple
// of 32 up to 256). All pointers are device pointers to contiguous float32
// arrays; weights in the order of gan_fused.GEN_WEIGHT_NAMES.
int tsde_gan_gen_fwd(const float* x0, const float* f0, const float* g0,
                     const float* noise, const float* t1s, const float* dts,
                     const float* W1f, const float* b1f, const float* W2f,
                     const float* b2f, const float* W1g, const float* b1g,
                     const float* W2g, const float* b2g, float* ys, float* zs,
                     float* gs, int B, int S, int M, int m, int N, int threads,
                     int device, cudaStream_t stream) {
  if (S < 1 || S > MAX_LANES || M < 1 || M > MAX_LANES || m < 1 ||
      m > MAX_K || threads < 32 || threads > MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  GenArgs a;
  a.x0 = x0; a.f0 = f0; a.g0 = g0; a.noise = noise; a.t1s = t1s;
  a.dts = dts;
  const float* w[8] = {W1f, b1f, W2f, b2f, W1g, b1g, W2g, b2g};
  for (int i = 0; i < 8; ++i) a.w[i] = w[i];
  a.ys = ys; a.zs = zs; a.gs = gs;
  a.B = B; a.S = S; a.M = M; a.m = m; a.N = N;
  a.G = group_width(S, M);
  const int rows_per_block = (threads / 32) * (32 / a.G);
  const size_t smem = tsde_gan_gen_fwd_smem_bytes(S, M, m);
  void (*kernel)(GenArgs) = nullptr;
  switch (m) {
    case 1: kernel = gan_gen_fwd_kernel<1>; break;
    case 2: kernel = gan_gen_fwd_kernel<2>; break;
    case 3: kernel = gan_gen_fwd_kernel<3>; break;
    case 4: kernel = gan_gen_fwd_kernel<4>; break;
    case 5: kernel = gan_gen_fwd_kernel<5>; break;
    case 6: kernel = gan_gen_fwd_kernel<6>; break;
    case 7: kernel = gan_gen_fwd_kernel<7>; break;
    default: kernel = gan_gen_fwd_kernel<8>; break;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + rows_per_block - 1) / rows_per_block, threads, smem,
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
