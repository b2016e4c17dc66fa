// Reverse sweep of the SDE-GAN critic's neural CDE solve, for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/gan_fused.py:_cde_bwd_kernel
// (launched by _cde_solve_bwd_impl). Same function: the reverse recurrence
// of the drift-only reversible Heun of gan_cde_fwd.cu, cotangents (ay, az,
// af) of the carry (h, z, f), for each step n from the last to the first,
// with z1 = zs[n] and the step's control slope:
//   ay += ghs[n];  Af = af + dt/2 ay
//   recompute F = tower([t1, z1]) (S*C outputs, F[i*C + c])
//   dslopes[n][c] = sum_i Af[i] F[i][c];  dF[i][c] = Af[i] slope[c]
//   backpropagate dF through the tower: dz and every weight gradient
//   Az = az + dz;  ay += 2 Az;  az = -Az;  af = dt/2 ay + dt Az
// and at the end dh0 = ay + az, df0 = af. The knot times get no gradient.
//
// What bounds it. Per row and step it recomputes the tower ((1+S)M + MSC
// multiply-adds), does twice that going back and 2SC for the slopes: 2,564
// at S=17, M=16, C=2, so 0.66 GFLOP for 63 steps over the 2048 rows of a
// training step (9.9 us at the float32 peak). It reads zs, ghs (N,B,S) and
// the slopes and writes dslopes, about 20 MB (6 us at 3.35 TB/s). In
// practice it is bound by latency and by the shared-memory pipe: 63
// dependent steps of tiny products. The earlier design moved every value a
// product needs from one lane to the others with __shfl_sync, about 127
// shuffles a row and step at the reference scale, and read each weight as
// its own 4-byte load; it took 0.33 ms (NVIDIA H100 80GB HBM3, 700 W).
//
// Design, as gan_gen_bwd.cuh: a row's work stays inside a group of G lanes of
// one warp (G = 32 for S = 17: one row per warp), lane l owning state unit
// l (ay, az, af and its C outputs) and hidden unit l. Each vector a product
// needs whole (z1, the hidden activations a1, the output cotangents d2 and
// the hidden cotangents d1) is written once to the row's slot in the
// warp's shared memory and, after a __syncwarp, read back by every lane of
// the group four values a load (a broadcast); each lane reads its own
// weights four a load too, from copies laid out lane-major with a stride of
// 4 x odd floats, so the eight lanes of a quarter-warp hit distinct banks.
// The only shuffles left are the slopes' group sums. Every sum keeps the
// earlier design's order (the bias last in layer 1, the output units in
// order going back), so the outputs are bitwise those of the shuffle
// design. Lane l accumulates column l of W1 and b1[l], and column l of W2
// and its b2 entries: 68 registers at the reference scale (G, C and the
// most hidden units template parameters), so a lane fits in 128 and 16
// warps share an SM: one wave. Each warp writes one partial; a second
// kernel sums them in a fixed order, so two calls give bitwise the same
// gradients. At the reference scale it takes 0.154 ms, the same bits as
// the shuffle design's 0.327 (NVIDIA H100 80GB HBM3, 700 W).
// Precise expf and tanhf, float32 throughout. The kernels allocate nothing
// and do not synchronise the host.
//
// The bf16 mixed mode is a kernel of its own, on bf16 tensor cores
// (gan_cde_bwd_bf16.cu).

#include <cuda_runtime.h>
#include <stddef.h>

#include "gan_fused_common.cuh"
#include "gan_warp_rows.cuh"

namespace {

using namespace tsde_gan;

struct CdeBwdArgs {
  const float* slopes;  // (N, B, C)
  const float* t1s;     // (N,)
  const float* dts;     // (N,)
  const float* w[4];    // W1 b1 W2 b2
  const float* zs;      // (N, B, S)
  const float* ghs;     // (N, B, S)
  float* dh0;           // (B, S)
  float* df0;           // (B, S)
  float* dslopes;       // (N, B, C)
  float* partials;      // (bwd_partials(B, S, M), P)
  int B, S, M, C, N, P;
};

// The sweep's shared memory (floats). The block's weight copies, each G
// lane rows of a stride from odd_quad (zeros past S or M):
//   w1c[l * K1 + i]            = W1[1 + i][l]        layer 1, hidden l
//   w2c[(l * C + c) * K2 + k]  = W2[k][l * C + c]    layer 2, unit l
//   w2r[l * K3 + j]            = W2[l][j]            da, hidden l
//   w1r[l * K2 + k]            = W1[1 + l][k]        dz, unit l
// then each warp's rows, a row's slot holding z1 (G), a1 (G), d2 (G * C)
// and d1 (G).
struct CdeLayout {
  int K1, K2, K3;
  int w1c, w2c, w2r, w1r, block;
  int z, a, d, e, row;  // offsets inside a row's slot, and its size
};

__host__ __device__ inline CdeLayout cde_layout(int S, int M, int C, int G) {
  CdeLayout L;
  L.K1 = odd_quad(S);
  L.K2 = odd_quad(M);
  L.K3 = odd_quad(S * C);
  L.w1c = 0;
  L.w2c = L.w1c + G * L.K1;
  L.w2r = L.w2c + G * C * L.K2;
  L.w1r = L.w2r + G * L.K3;
  L.block = L.w1r + G * L.K2;
  L.z = 0;
  L.a = G;
  L.d = 2 * G;
  L.e = 2 * G + G * C;
  L.row = 3 * G + G * C;
  return L;
}

__host__ __device__ inline size_t cde_bwd_smem_floats(int S, int M, int C,
                                                      int G, int warps) {
  const CdeLayout L = cde_layout(S, M, C, G);
  return size_t(L.block) + size_t(warps) * 32 * (3 + C);
}

// Row `row`'s inputs of step s: z1 and ghs of unit li and the slopes; zeros
// off the batch or past S.
template <int C>
struct CdeStepIn {
  float z1, gh, sl[C];
};

template <int C>
__device__ __forceinline__ void load_cde_step(const CdeBwdArgs& a, int s,
                                              int row, int li, bool live,
                                              bool unit, CdeStepIn<C>& in) {
  const size_t at = (size_t(s) * a.B + row) * a.S + li;
  in.z1 = unit ? __ldg(a.zs + at) : 0.f;
  in.gh = unit ? __ldg(a.ghs + at) : 0.f;
  const float* sl = a.slopes + (size_t(s) * a.B + row) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) in.sl[c] = live ? __ldg(sl + c) : 0.f;
}

// The number of control channels C (1..MAX_K) and the group width G (16 or
// 32) are template parameters, as in gan_gen_bwd.cuh.
// Stages the lane-major weight copies of cde_layout with the whole block.
__device__ inline void stage_cde_weights(float* sm, const CdeLayout& L,
                                         const float* W1, const float* W2,
                                         int S, int M, int C, int G) {
  const int SC = S * C;
  for (int e = threadIdx.x; e < G * L.K1; e += blockDim.x) {
    const int l = e / L.K1, i = e % L.K1;
    sm[L.w1c + e] = l < M && i < S ? W1[(1 + i) * M + l] : 0.f;
  }
  for (int e = threadIdx.x; e < G * C * L.K2; e += blockDim.x) {
    const int o = e / L.K2, k = e % L.K2, l = o / C;
    sm[L.w2c + e] = l < S && k < M ? W2[k * SC + o] : 0.f;
  }
  for (int e = threadIdx.x; e < G * L.K3; e += blockDim.x) {
    const int l = e / L.K3, j = e % L.K3;
    sm[L.w2r + e] = l < M && j < SC ? W2[l * SC + j] : 0.f;
  }
  for (int e = threadIdx.x; e < G * L.K2; e += blockDim.x) {
    const int l = e / L.K2, k = e % L.K2;
    sm[L.w1r + e] = l < S && k < M ? W1[(1 + l) * M + k] : 0.f;
  }
}

// The number of control channels C (1..MAX_K), the group width G (16 or
// 32) and H, the most hidden units (16 or G), are template parameters: the
// weight-gradient accumulators are register arrays of their sizes. Where
// they are few (H C <= 32, as at the reference scale) a lane is held to 128
// registers, so 16 warps share an SM: the critic's 2,048 rows in one wave.
template <int G, int H, int C>
__global__ void __launch_bounds__(MAX_THREADS, H * C <= 32 ? 2 : 1)
gan_cde_bwd_kernel(const CdeBwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int S = a.S, M = a.M, B = a.B, SC = S * C;
  const CdeLayout L = cde_layout(S, M, C, G);
  stage_cde_weights(sm, L, a.w[0], a.w[2], S, M, C, G);
  __syncthreads();

  constexpr int RPW = 32 / G;                  // rows per warp
  const int lane = threadIdx.x & 31;
  const int li = lane & (G - 1);
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  // No barrier follows: a warp with no row of the batch is done. The others
  // run every lane; rows past the end compute on zeros, add zeros and store
  // nothing.
  if (warp * RPW >= B) return;
  const int row = warp * RPW + lane / G;
  const bool live = row < B;
  const bool unit = live && li < S;
  const bool hid = li < M;

  // This lane's weight rows, and its row's slot.
  const float* w1c = sm + L.w1c + li * L.K1;
  const float* w2c = sm + L.w2c + li * C * L.K2;
  const float* w2r = sm + L.w2r + li * L.K3;
  const float* w1r = sm + L.w1r + li * L.K2;
  float* slot = sm + L.block + (threadIdx.x >> 5) * 32 * (3 + C)
                + (lane / G) * L.row;
  float* zv = slot + L.z;
  float* av = slot + L.a;
  float* dv = slot + L.d;
  float* ev = slot + L.e;
  const float w1t = hid ? a.w[0][li] : 0.f;    // W1's time row
  const float b1 = hid ? a.w[1][li] : 0.f;
  float b2[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    b2[c] = li < S ? a.w[3][li * C + c] : 0.f;

  float ay = 0.f, az = 0.f, af = 0.f;
  // Column li of dW1 (row 0: time) and of dW2 (outputs (li, c); row k).
  float gw1[1 + G], gw2[H][C], gb1 = 0.f, gb2[C];
#pragma unroll
  for (int r = 0; r <= G; ++r) gw1[r] = 0.f;
#pragma unroll
  for (int k = 0; k < H; ++k) {
#pragma unroll
    for (int c = 0; c < C; ++c) gw2[k][c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) gb2[c] = 0.f;

  CdeStepIn<C> next;
  load_cde_step<C>(a, a.N - 1, row, li, live, unit, next);
  float dt_next = __ldg(a.dts + a.N - 1), t1_next = __ldg(a.t1s + a.N - 1);
  for (int s = a.N - 1; s >= 0; --s) {
    const CdeStepIn<C> in = next;
    const float dt = dt_next, t1 = t1_next;
    if (s > 0) {
      load_cde_step<C>(a, s - 1, row, li, live, unit, next);
      dt_next = __ldg(a.dts + s - 1);
      t1_next = __ldg(a.t1s + s - 1);
    }

    ay += in.gh;
    const float Af = af + 0.5f * dt * ay;

    // The tower's forward at [t1, z1]: the last step's reads of zv ended
    // before its d1 barrier.
    zv[li] = in.z1;
    __syncwarp();
    float a1, sl1;
    lipswish_and_slope(dot4<G / 4>(zv, w1c, S, t1 * w1t) + b1, a1, sl1);
    av[li] = a1;
    __syncwarp();
    float F[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      F[c] = tanhf(dot4<G / 4>(av, w2c + c * L.K2, M, 0.f) + b2[c]);

    // The slopes' cotangent, and the outputs' pre-activation cotangents.
    float ds[C], d2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ds[c] = group_sum<G>(Af * F[c]);
      const float dpre2 = Af * in.sl[c] * (1.f - F[c] * F[c]);
      gb2[c] += dpre2;
      d2[c] = dpre2;
      dv[li * C + c] = d2[c];
    }
    if (live && li == 0) {
      float* out = a.dslopes + (size_t(s) * B + row) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) out[c] = ds[c];
    }

    // Layer 2's weights: dW2[k][(li, c)] += a1[k] dpre2[(li, c)].
#pragma unroll
    for (int k4 = 0; k4 < H; k4 += 4) {
      if (k4 < M) {
        const float4 v = *reinterpret_cast<const float4*>(av + k4);
        const float ak[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k4 + j < M) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              gw2[k4 + j][c] = fmaf(ak[j], d2[c], gw2[k4 + j][c]);
          }
        }
      }
    }
    __syncwarp();

    // Hidden unit li's cotangent, through lipswish.
    const float d1 = dot4<G * C / 4>(dv, w2r, SC, 0.f) * sl1;

    // Layer 1's weights: dW1[r][li] += [t1, z1][r] dpre1[li].
    gb1 += d1;
    gw1[0] = fmaf(t1, d1, gw1[0]);
#pragma unroll
    for (int i4 = 0; i4 < G; i4 += 4) {
      if (i4 < S) {
        const float4 v = *reinterpret_cast<const float4*>(zv + i4);
        const float zi[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i4 + j < S) gw1[1 + i4 + j] = fmaf(zi[j], d1, gw1[1 + i4 + j]);
      }
    }
    ev[li] = d1;
    __syncwarp();

    // State unit li's cotangent.
    const float Az = az + dot4<G / 4>(ev, w1r, M, 0.f);

    af = 0.5f * dt * ay + dt * Az;
    ay += 2.f * Az;
    az = -Az;
  }

  if (unit) {
    const size_t at = size_t(row) * S + li;
    a.dh0[at] = ay + az;
    a.df0[at] = af;
  }

  // The two row groups of a warp (G = 16) add up, group 0 first; then lane
  // li of the first group writes the warp's partial of the entries it owns,
  // laid out as the weights in gan_fused.CDE_WEIGHT_NAMES order.
  if constexpr (RPW == 2) {
#pragma unroll
    for (int r = 0; r <= G; ++r) gw1[r] += __shfl_down_sync(FULL, gw1[r], 16);
#pragma unroll
    for (int k = 0; k < H; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        gw2[k][c] += __shfl_down_sync(FULL, gw2[k][c], 16);
    }
    gb1 += __shfl_down_sync(FULL, gb1, 16);
#pragma unroll
    for (int c = 0; c < C; ++c) gb2[c] += __shfl_down_sync(FULL, gb2[c], 16);
  }
  if (lane >= G) return;
  float* pW1 = a.partials + size_t(warp) * a.P;
  float* pb1 = pW1 + (1 + S) * M;
  float* pW2 = pb1 + M;
  float* pb2 = pW2 + M * SC;
  if (hid) {
#pragma unroll
    for (int r = 0; r <= G; ++r) {
      if (r <= S) pW1[r * M + li] = gw1[r];
    }
    pb1[li] = gb1;
  }
  if (li < S) {
#pragma unroll
    for (int k = 0; k < H; ++k) {
      if (k < M) {
#pragma unroll
        for (int c = 0; c < C; ++c) pW2[k * SC + li * C + c] = gw2[k][c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) pb2[li * C + c] = gb2[c];
  }
}

using CdeBwdKernel = void (*)(CdeBwdArgs);

template <int G, int H>
CdeBwdKernel cde_bwd_kernel_for(int C) {
  switch (C) {
    case 1: return gan_cde_bwd_kernel<G, H, 1>;
    case 2: return gan_cde_bwd_kernel<G, H, 2>;
    case 3: return gan_cde_bwd_kernel<G, H, 3>;
    case 4: return gan_cde_bwd_kernel<G, H, 4>;
    case 5: return gan_cde_bwd_kernel<G, H, 5>;
    case 6: return gan_cde_bwd_kernel<G, H, 6>;
    case 7: return gan_cde_bwd_kernel<G, H, 7>;
    default: return gan_cde_bwd_kernel<G, H, 8>;
  }
}

// Launches the sweep and the sum of its partials: the body of the entry
// point below.
int launch_cde_bwd(const float* slopes, const float* t1s, const float* dts,
                   const float* const* w, const float* zs, const float* ghs,
                   float* dh0, float* df0, float* dslopes, float* partials,
                   float* dw, int B, int S, int M, int C, int N, int threads,
                   int device, cudaStream_t stream) {
  if (S < 1 || S > MAX_LANES || M < 1 || M > MAX_LANES || C < 1 ||
      C > MAX_K || threads < 32 || threads > MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  CdeBwdArgs a;
  a.slopes = slopes; a.t1s = t1s; a.dts = dts;
  for (int i = 0; i < 4; ++i) a.w[i] = w[i];
  a.zs = zs; a.ghs = ghs;
  a.dh0 = dh0; a.df0 = df0; a.dslopes = dslopes; a.partials = partials;
  a.B = B; a.S = S; a.M = M; a.C = C; a.N = N;
  a.P = (1 + S) * M + M + M * S * C + S * C;
  const int G = bwd_group_width(S, M);
  const CdeBwdKernel kernel =
      G == 16   ? cde_bwd_kernel_for<16, 16>(C)
      : M <= 16 ? cde_bwd_kernel_for<32, 16>(C)
                : cde_bwd_kernel_for<32, 32>(C);
  const size_t smem = cde_bwd_smem_floats(S, M, C, G, threads / 32)
                      * sizeof(float);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = (threads / 32) * (32 / G);
  kernel<<<(B + rows_per_block - 1) / rows_per_block, threads, smem,
           stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_sum_partials(partials, bwd_partials(B, S, M), a.P, dw, stream));
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the sweep needs for these widths at
// `threads` threads a block.
size_t tsde_gan_cde_bwd_smem_bytes(int S, int M, int C, int threads) {
  return cde_bwd_smem_floats(S, M, C, bwd_group_width(S, M), threads / 32)
         * sizeof(float);
}

// Launches the sweep (`threads` threads per block) and the sum of its
// partials on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for widths beyond the kernel's limits (S, M <= 32,
// C <= 8, threads a multiple of 32 up to 256). All pointers are device
// pointers to contiguous float32 arrays; weights in the order of
// gan_fused.CDE_WEIGHT_NAMES. partials holds tsde_gan_bwd_partials(B, S, M)
// x P floats and dw P floats, P the weights' total element count; dw
// receives their gradients back to back.
int tsde_gan_cde_bwd(const float* slopes, const float* t1s, const float* dts,
                     const float* W1, const float* b1, const float* W2,
                     const float* b2, const float* zs, const float* ghs,
                     float* dh0, float* df0, float* dslopes, float* partials,
                     float* dw, int B, int S, int M, int C, int N,
                     int threads, int device, cudaStream_t stream) {
  const float* w[4] = {W1, b1, W2, b2};
  return launch_cde_bwd(slopes, t1s, dts, w, zs, ghs, dh0, df0, dslopes,
                        partials, dw, B, S, M, C, N, threads, device, stream);
}

}  // extern "C"
