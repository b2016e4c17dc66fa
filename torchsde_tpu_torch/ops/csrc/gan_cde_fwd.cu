// Whole-solve forward of the SDE-GAN critic's neural CDE, for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/gan_fused.py:_cde_fwd_kernel
// (launched by _cde_solve_fwd_impl). Same function: the drift-only CDE
// dh = F(t, h) X'(t) dt by reversible Heun, carry (h, z, f), per step
//   z1 = 2 h - z + dt f0
//   F  = tanh(lipswish([t1, z1] @ W1 + b1) @ W2 + b2)     (S*C outputs)
//   f1 = F . slope                 (per row, (S, C) @ (C), F[i*C + c])
//   h1 = h + dt/2 (f0 + f1)
// with the control's slope at each step's end point streamed in.
//
// What bounds it. Per row and step it does (1+S)M + MSC + SC multiply-adds:
// 866 at S=17, M=16, C=2, so 0.22 GFLOP for a solve of 63 steps over the
// 2048 rows of a served request (fake and real paths together; 3.3 us at
// the float32 peak). It writes hs, zs (N,B,S), 17.5 MB at that size, and
// reads 1.0 MB of slopes: 5.6 us at 3.35 TB/s, so by the bytes it is bound
// by the stores. In practice it is bound by latency: 63 dependent steps of
// tiny products. The critic only needs hs[-1] to score, but zs feeds the
// reverse sweep, so both are kept.
//
// Design (as gan_gen_fwd.cu, with gan_fused_common.cuh's tower): a row's
// work stays inside a group of G lanes of one warp (G = 32 for S = 17: one
// row per warp, 2048 warps, 512 blocks of 128), lane l owning state unit l
// (h, z, f and its C outputs of F in registers, C a template parameter)
// and hidden unit l; layer 1 and layer 2 gather through __shfl_sync, so a
// step needs no block barrier. The tower's weights (882 floats unpadded)
// are staged once per block into shared memory. Each step's slopes, time
// and width are loaded one step ahead. Precise expf and tanhf; state and
// sums in float32. The kernel allocates nothing and does not synchronise
// the host.

#include <cuda_runtime.h>
#include <stddef.h>

#include "gan_fused_common.cuh"

namespace {

using namespace tsde_gan;

struct CdeArgs {
  const float* h0;      // (B, S)
  const float* f0;      // (B, S)
  const float* slopes;  // (N, B, C)
  const float* t1s;     // (N,)
  const float* dts;     // (N,)
  const float* w[4];    // W1 b1 W2 b2
  float* hs;            // (N, B, S)
  float* zs;            // (N, B, S)
  int B, S, M, C, N, G;
};

__host__ __device__ inline size_t cde_smem_floats(int S, int M, int C,
                                                  int G) {
  return tower_w1_floats(S, G) + tower_w2_floats(M, C, G);
}

// Row `row`'s control slopes of step s (zeros for a row past the batch).
template <int C>
__device__ __forceinline__ void load_slopes(const float* slopes, int B, int s,
                                            int row, bool live,
                                            float (&sl)[C]) {
  const float* src = slopes + (size_t(s) * B + row) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) sl[c] = live ? __ldg(src + c) : 0.f;
}

// The number of control channels C is a template parameter (1..MAX_K), so
// a lane's C outputs of F are registers and its loops over them are
// unrolled exactly.
template <int C>
__global__ void __launch_bounds__(MAX_THREADS)
gan_cde_fwd_kernel(const CdeArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int S = a.S, M = a.M, B = a.B, G = a.G;
  float* w1 = sm;
  float* w2 = w1 + tower_w1_floats(S, G);
  stage_tower(w1, w2, a.w[0], a.w[2], S, M, C, G);
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

  const float* w1s[1] = {w1};
  const float b1[1] = {li < M ? a.w[1][li] : 0.f};
  float b2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) b2[c] = li < S ? a.w[3][li * C + c] : 0.f;

  float h = unit ? a.h0[size_t(row) * S + li] : 0.f;
  float z = h;
  float f = unit ? a.f0[size_t(row) * S + li] : 0.f;

  float sl_next[C];
  load_slopes<C>(a.slopes, B, 0, row, live, sl_next);
  float dt_next = __ldg(a.dts), t1_next = __ldg(a.t1s);
  for (int s = 0; s < a.N; ++s) {
    float sl[C];
#pragma unroll
    for (int c = 0; c < C; ++c) sl[c] = sl_next[c];
    if (s + 1 < a.N) load_slopes<C>(a.slopes, B, s + 1, row, live, sl_next);
    const float dt = dt_next, t1 = t1_next;
    if (s + 1 < a.N) {
      dt_next = __ldg(a.dts + s + 1);
      t1_next = __ldg(a.t1s + s + 1);
    }

    const float z1 = 2.f * h - z + dt * f;
    float pre[1];
    tower_layer1<1>(w1s, b1, t1, z1, S, G, li, pre);
    float F[C];
    tower_layer2<C>(w2, lipswish(pre[0]), b2, M, G, li, F);
    float f1 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) f1 = fmaf(F[c], sl[c], f1);

    h = h + 0.5f * dt * (f + f1);
    z = z1;
    f = f1;
    if (unit) {
      const size_t at = (size_t(s) * B + row) * S + li;
      a.hs[at] = h;
      a.zs[at] = z;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for these widths.
size_t tsde_gan_cde_fwd_smem_bytes(int S, int M, int C) {
  return cde_smem_floats(S, M, C, group_width(S, M)) * sizeof(float);
}

// Launches the solve on `stream` with `threads` threads per block and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// widths beyond the kernel's limits (S, M <= 32, C <= 8, threads a multiple
// of 32 up to 256). All pointers are device pointers to contiguous float32
// arrays; weights in the order of gan_fused.CDE_WEIGHT_NAMES.
int tsde_gan_cde_fwd(const float* h0, const float* f0, const float* slopes,
                     const float* t1s, const float* dts, const float* W1,
                     const float* b1, const float* W2, const float* b2,
                     float* hs, float* zs, int B, int S, int M, int C, int N,
                     int threads, int device, cudaStream_t stream) {
  if (S < 1 || S > MAX_LANES || M < 1 || M > MAX_LANES || C < 1 ||
      C > MAX_K || threads < 32 || threads > MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  CdeArgs a;
  a.h0 = h0; a.f0 = f0; a.slopes = slopes; a.t1s = t1s; a.dts = dts;
  const float* w[4] = {W1, b1, W2, b2};
  for (int i = 0; i < 4; ++i) a.w[i] = w[i];
  a.hs = hs; a.zs = zs;
  a.B = B; a.S = S; a.M = M; a.C = C; a.N = N;
  a.G = group_width(S, M);
  const int rows_per_block = (threads / 32) * (32 / a.G);
  const size_t smem = tsde_gan_cde_fwd_smem_bytes(S, M, C);
  void (*kernel)(CdeArgs) = nullptr;
  switch (C) {
    case 1: kernel = gan_cde_fwd_kernel<1>; break;
    case 2: kernel = gan_cde_fwd_kernel<2>; break;
    case 3: kernel = gan_cde_fwd_kernel<3>; break;
    case 4: kernel = gan_cde_fwd_kernel<4>; break;
    case 5: kernel = gan_cde_fwd_kernel<5>; break;
    case 6: kernel = gan_cde_fwd_kernel<6>; break;
    case 7: kernel = gan_cde_fwd_kernel<7>; break;
    default: kernel = gan_cde_fwd_kernel<8>; break;
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
