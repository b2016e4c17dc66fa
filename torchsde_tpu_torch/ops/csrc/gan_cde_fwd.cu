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
// Design. A row's work stays inside a group of G lanes of one warp (G the
// power of two at least max(S, M, 4); 32 for S = 17: one row a warp, 2,048
// warps), lane l owning state unit l (h, z, f and its C outputs of F in
// registers, C a template parameter) and hidden unit l. The row's vectors
// go through the warp's shared memory (gan_warp_rows.cuh): z1 is written
// once to the row's slot and, after a __syncwarp, read by every lane of the
// row into registers four floats a load; then the hidden activations a1
// likewise, once for all C outputs. Each lane reads its weights, W1's
// column l and W2's C columns of unit l, once from lane-major copies staged
// in shared memory into registers (at the widest widths, S = M = 32 and
// C = 8, some spill to local memory; reading W2 from shared memory at
// every step instead took 0.048 ms against 0.032 there, NVIDIA H100 80GB
// HBM3, 700 W). No shuffle is left: the earlier design
// gathered z1 and a1 lane to lane with __shfl_sync, 33 shuffles and 33
// scalar weight loads a row and step. What bounds a step is its chain of
// dependent products, so the critic's reference widths (S 17, M 16), and
// the widest (S = M = 32), run instantiations
// with the widths fixed, whose chains have no branch. At the
// reference scale it takes 0.038 ms, against the shuffle design's 0.088
// (NVIDIA H100 80GB HBM3, 700 W). Every sum keeps that design's order
// (layer 1's bias last, the hidden units in order), so hs and zs are
// bitwise its. Each step's slopes, time and width are loaded one step
// ahead. Precise expf and tanhf; state and sums in float32. The kernel
// allocates nothing and does not synchronise the host.
//
// bf16 mixed mode (tsde_gan_cde_fwd_bf16; the JAX package's _tower_fwd
// with bf16 weights): the weights come in bf16 and are widened once as
// they are staged; the slopes, the state and hs, zs stay float32. Only the
// products' inputs are rounded to bf16: [t1, z1] before layer 1 and a1
// before layer 2 (F . slope, the biases and the update stay float32).

#include <cuda_runtime.h>
#include <stddef.h>

#include "gan_fused_common.cuh"
#include "gan_warp_rows.cuh"

namespace {

using namespace tsde_gan;

// W is the storage type of the weights (float, or bf16 in mixed mode); the
// rest is float32 either way.
template <typename W>
struct CdeArgs {
  const float* h0;      // (B, S)
  const float* f0;      // (B, S)
  const float* slopes;  // (N, B, C)
  const float* t1s;     // (N,)
  const float* dts;     // (N,)
  const W* w[4];        // W1 b1 W2 b2
  float* hs;            // (N, B, S)
  float* zs;            // (N, B, S)
  int B, S, M, C, N;
};

// The lanes of a row: at least 4, so that a row's slot holds whole float4.
__host__ __device__ inline int cde_fwd_group_width(int S, int M) {
  const int G = group_width(S, M);
  return G < 4 ? 4 : G;
}

// The solve's shared memory (floats). The block's weight copies, G lane
// rows each at a stride from odd_quad (zeros past S or M):
//   w1c[l * K1 + i]            = W1[1 + i][l]        layer 1, hidden l
//   w2c[(l * C + c) * K2 + k]  = W2[k][l * C + c]    layer 2, unit l
// then each warp's rows, a row's slot holding z1 (G) and a1 (G).
struct CdeFwdLayout {
  int K1, K2;
  int w1c, w2c, block;
};

__host__ __device__ inline CdeFwdLayout cde_fwd_layout(int S, int M, int C,
                                                       int G) {
  CdeFwdLayout L;
  L.K1 = odd_quad(S);
  L.K2 = odd_quad(M);
  L.w1c = 0;
  L.w2c = L.w1c + G * L.K1;
  L.block = L.w2c + G * C * L.K2;
  return L;
}

// Every warp's slots take 32 / G rows of 2 G floats: 64 floats a warp.
__host__ __device__ inline size_t cde_fwd_smem_floats(int S, int M, int C,
                                                      int G, int warps) {
  return size_t(cde_fwd_layout(S, M, C, G).block) + size_t(warps) * 64;
}

// Stages the lane-major weight copies with the whole block, widened to
// float.
template <typename W>
__device__ inline void stage_cde_fwd_weights(float* sm,
                                             const CdeFwdLayout& L,
                                             const W* W1, const W* W2, int S,
                                             int M, int C, int G) {
  const int SC = S * C;
  for (int e = threadIdx.x; e < G * L.K1; e += blockDim.x) {
    const int l = e / L.K1, i = e % L.K1;
    sm[L.w1c + e] = l < M && i < S ? to_f(W1[(1 + i) * M + l]) : 0.f;
  }
  for (int e = threadIdx.x; e < G * C * L.K2; e += blockDim.x) {
    const int o = e / L.K2, k = e % L.K2, l = o / C;
    sm[L.w2c + e] = l < S && k < M ? to_f(W2[k * SC + o]) : 0.f;
  }
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

// The group width G (4, 8, 16 or 32), H, the most hidden units (G, or 16
// at the critic's fixed reference widths), and the number of control channels C (1..MAX_K) are
// template parameters: a lane's weights and its C outputs of F are
// register arrays and the loops over them unroll exactly. SF and MF fix S
// and M where they are not 0, so that every product's chain unrolls
// without a branch.
template <typename W, int G, int H, int C, int SF, int MF>
__global__ void __launch_bounds__(MAX_THREADS)
gan_cde_fwd_kernel(const CdeArgs<W> a) {
  extern __shared__ __align__(16) float sm[];
  const int S = SF ? SF : a.S, M = MF ? MF : a.M, B = a.B;
  const CdeFwdLayout L = cde_fwd_layout(S, M, C, G);
  stage_cde_fwd_weights(sm, L, a.w[0], a.w[2], S, M, C, G);
  __syncthreads();

  constexpr int RPW = 32 / G;                  // rows per warp
  const int lane = threadIdx.x & 31;
  const int li = lane & (G - 1);
  const int warp_row0 =
      (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * RPW;
  // No barrier follows: a warp with no row of the batch is done. The others
  // run every lane (__syncwarp takes the whole warp); rows past the end
  // compute on zeros and store nothing.
  if (warp_row0 >= B) return;
  const int row = warp_row0 + lane / G;
  const bool live = row < B;
  const bool unit = live && li < S;
  const bool hid = li < M;

  // This lane's weights, W1's column and W2's C columns, read once from
  // the lane-major copies into registers (zeros past S or M).
  float w1[G], w2[C][H];
  load4(sm + L.w1c + li * L.K1, S, w1);
#pragma unroll
  for (int c = 0; c < C; ++c)
    load4(sm + L.w2c + (li * C + c) * L.K2, M, w2[c]);
  float* zv = sm + L.block + (threadIdx.x >> 5) * 64 + (lane / G) * 2 * G;
  float* av = zv + G;
  const float w1t = hid ? to_f(a.w[0][li]) : 0.f;    // W1's time row
  const float b1 = hid ? to_f(a.w[1][li]) : 0.f;
  float b2[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    b2[c] = li < S ? to_f(a.w[3][li * C + c]) : 0.f;

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

    // Layer 1 at [t1, z1], its input rounded to W: the last step's reads of
    // zv ended before its a1 barrier.
    const float z1 = 2.f * h - z + dt * f;
    zv[li] = rnd<W>(z1);
    __syncwarp();
    float zr[G];
    load4(zv, S, zr);
    float pre = rnd<W>(t1) * w1t;
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < S) pre = fmaf(zr[i], w1[i], pre);
    av[li] = rnd<W>(lipswish(pre + b1));
    __syncwarp();
    // Layer 2 and F . slope, a1 read once for the C outputs: the next
    // step writes av only after its z1 barrier, which every lane reaches
    // past these reads.
    float ar[H], o[C];
    load4(av, M, ar);
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = 0.f;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      if (k < M) {
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] = fmaf(ar[k], w2[c][k], o[c]);
      }
    }
    float f1 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) f1 = fmaf(tanhf(o[c] + b2[c]), sl[c], f1);

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

template <typename W>
using CdeFwdKernel = void (*)(CdeArgs<W>);

template <typename W, int G, int H, int SF = 0, int MF = 0>
CdeFwdKernel<W> cde_fwd_kernel_for(int C) {
  switch (C) {
    case 1: return gan_cde_fwd_kernel<W, G, H, 1, SF, MF>;
    case 2: return gan_cde_fwd_kernel<W, G, H, 2, SF, MF>;
    case 3: return gan_cde_fwd_kernel<W, G, H, 3, SF, MF>;
    case 4: return gan_cde_fwd_kernel<W, G, H, 4, SF, MF>;
    case 5: return gan_cde_fwd_kernel<W, G, H, 5, SF, MF>;
    case 6: return gan_cde_fwd_kernel<W, G, H, 6, SF, MF>;
    case 7: return gan_cde_fwd_kernel<W, G, H, 7, SF, MF>;
    default: return gan_cde_fwd_kernel<W, G, H, 8, SF, MF>;
  }
}

// Launches the solve (float32 weights, or bf16 in mixed mode): the body of
// both entry points below.
template <typename W>
int launch_cde_fwd(const float* h0, const float* f0, const float* slopes,
                   const float* t1s, const float* dts, const W* const* w,
                   float* hs, float* zs, int B, int S, int M, int C, int N,
                   int threads, int device, cudaStream_t stream) {
  if (S < 1 || S > MAX_LANES || M < 1 || M > MAX_LANES || C < 1 ||
      C > MAX_K || threads < 32 || threads > MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  CdeArgs<W> a;
  a.h0 = h0; a.f0 = f0; a.slopes = slopes; a.t1s = t1s; a.dts = dts;
  for (int i = 0; i < 4; ++i) a.w[i] = w[i];
  a.hs = hs; a.zs = zs;
  a.B = B; a.S = S; a.M = M; a.C = C; a.N = N;
  const int G = cde_fwd_group_width(S, M);
  // The critic's reference widths, and the widest, run instantiations with
  // them fixed.
  const CdeFwdKernel<W> kernel =
      S == 17 && M == 16   ? cde_fwd_kernel_for<W, 32, 16, 17, 16>(C)
      : S == 32 && M == 32 ? cde_fwd_kernel_for<W, 32, 32, 32, 32>(C)
      : G == 4             ? cde_fwd_kernel_for<W, 4, 4>(C)
      : G == 8             ? cde_fwd_kernel_for<W, 8, 8>(C)
      : G == 16            ? cde_fwd_kernel_for<W, 16, 16>(C)
                           : cde_fwd_kernel_for<W, 32, 32>(C);
  const size_t smem = cde_fwd_smem_floats(S, M, C, G, threads / 32)
                      * sizeof(float);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = (threads / 32) * (32 / G);
  kernel<<<(B + rows_per_block - 1) / rows_per_block, threads, smem,
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for these widths at `threads`
// threads a block.
size_t tsde_gan_cde_fwd_smem_bytes(int S, int M, int C, int threads) {
  return cde_fwd_smem_floats(S, M, C, cde_fwd_group_width(S, M),
                             threads / 32) * sizeof(float);
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
  const float* w[4] = {W1, b1, W2, b2};
  return launch_cde_fwd(h0, f0, slopes, t1s, dts, w, hs, zs, B, S, M, C, N,
                        threads, device, stream);
}

// bf16 mixed mode: the weights bf16, the rest as above.
int tsde_gan_cde_fwd_bf16(const float* h0, const float* f0,
                          const float* slopes, const float* t1s,
                          const float* dts, const __nv_bfloat16* W1,
                          const __nv_bfloat16* b1, const __nv_bfloat16* W2,
                          const __nv_bfloat16* b2, float* hs, float* zs,
                          int B, int S, int M, int C, int N, int threads,
                          int device, cudaStream_t stream) {
  const __nv_bfloat16* w[4] = {W1, b1, W2, b2};
  return launch_cde_fwd(h0, f0, slopes, t1s, dts, w, hs, zs, B, S, M, C, N,
                        threads, device, stream);
}

}  // extern "C"
