// Reverse sweep of the SDE-GAN generator's whole solve, for Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/gan_fused.py:_gen_bwd_kernel
// (launched by _gen_solve_bwd_impl). Same function: the hand-derived reverse
// recurrence of reversible Heun (gan_gen_fwd.cu), cotangents (ay, az, af, ag)
// of the carry (x, z, f, g), for each step n from the last to the first,
// with z1 = zs[n], g1 = gs[n] (g_{n+1}) and g0 = gs[n-1] (g_n; the input g0
// at n = 0):
//   ay += gy[n];  Af = af + dt/2 ay;  Ag = ag + outer(ay, dW/2)
//   recompute both towers at [t1, z1]; backpropagate Af through the drift
//   tower and Ag through the diffusion tower: dz and every weight gradient
//   Az = az + dz;  dnoise[n] = Az . g0 + (ay/2) . (g0 + g1)
//   ay += 2 Az;  az = -Az;  af = dt/2 ay + dt Az;  ag = outer(ay/2 + Az, dW)
// and at the end dx0 = ay + az, df0 = af, dg0 = ag.
//
// What bounds it. Per row and step it recomputes the towers' forward
// (2(1+S)M + MS(1+m) multiply-adds), does twice that going back (weight
// gradients and input cotangents) and about 4Sm for the noise terms: 4,896
// at S=16, M=16, m=3, so 0.63 GFLOP for 63 steps at B=1024 (9.4 us at the
// float32 peak). It reads zs, gy (N,B,S), gs (N,B,S*m) and the noise and
// writes dnoise, about 22 MB (6.6 us at 3.35 TB/s). In practice it is bound
// by latency, like the forward: 63 dependent steps of tiny products.
//
// Design, on gan_gen_fwd.cu's: a row's work stays inside a group of G lanes
// of one warp (G = 16 at the flagship, two rows per warp), lane l owning
// state unit l (its cotangents ay, az, af and its m entries of ag) and
// hidden unit l of both towers; products gather through __shfl_sync, so a
// step needs no block barrier. The weights and transposed copies of them
// are staged once per block in shared memory, zero-padded to G, so every
// product reads neighbouring words. g_{n+1} is carried from the step before
// in registers; each step's inputs are loaded one step ahead.
//
// Weight gradients (1,664 floats at the flagship) are sums over every row
// and step. Lane l accumulates the entries it owns: column l of each W1 and
// b1[l] (hidden unit l), column l of each W2 and b2[l] (output unit l), 104
// registers at the flagship. G is a template parameter (16 or 32), so these
// are register arrays of compile-time size; at the widest shapes they spill
// to local memory, which stays correct. At the end the two row groups of a
// warp are added in a fixed order and each warp writes one partial; a
// second kernel sums the partials in a fixed order. No atomics, so two
// calls give bitwise the same gradients. Precise expf and tanhf, float32
// throughout. The kernels allocate nothing and do not synchronise the host.

#include <cuda_runtime.h>
#include <stddef.h>

#include "gan_fused_common.cuh"

namespace {

using namespace tsde_gan;

struct GenBwdArgs {
  const float* g0;      // (B, S*m)
  const float* noise;   // (N, B, m)
  const float* t1s;     // (N,)
  const float* dts;     // (N,)
  const float* w[8];    // W1f b1f W2f b2f W1g b1g W2g b2g
  const float* zs;      // (N, B, S)
  const float* gs;      // (N, B, S*m)
  const float* gy;      // (N, B, S)
  float* dx0;           // (B, S)
  float* df0;           // (B, S)
  float* dg0;           // (B, S*m)
  float* dnoise;        // (N, B, m)
  float* partials;      // (bwd_partials(B, S, M), P)
  int B, S, M, m, N, P;
};

__host__ __device__ inline size_t gen_bwd_smem_floats(int S, int M, int m,
                                                      int G) {
  return 2 * tower_w1_floats(S, G) + tower_w2_floats(M, 1, G)
         + tower_w2_floats(M, m, G) + 2 * size_t(G) * G
         + size_t(G) * (1 + m) * G;
}

// Row `row`'s inputs of step s: z1 and gy of unit li, the noise, and g_n
// (gs[s-1], or g0 at s = 0); zeros off the batch or past S.
template <int K>
struct StepIn {
  float z1, gy, dW[K], gp[K];
};

template <int K>
__device__ __forceinline__ void load_step(const GenBwdArgs& a, int s,
                                          int row, int li, bool live,
                                          bool unit, StepIn<K>& in) {
  const size_t at = (size_t(s) * a.B + row) * a.S + li;
  in.z1 = unit ? __ldg(a.zs + at) : 0.f;
  in.gy = unit ? __ldg(a.gy + at) : 0.f;
  const float* dW = a.noise + (size_t(s) * a.B + row) * K;
  const float* gp = s > 0
      ? a.gs + ((size_t(s - 1) * a.B + row) * a.S + li) * K
      : a.g0 + (size_t(row) * a.S + li) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    in.dW[j] = live ? __ldg(dW + j) : 0.f;
    in.gp[j] = unit ? __ldg(gp + j) : 0.f;
  }
}

// The number of noise channels K = m (1..MAX_K) and the group width G (16
// or 32) are template parameters: a lane's channels and its weight-gradient
// accumulators are registers, and the loops over them unroll exactly.
template <int G, int K>
__global__ void __launch_bounds__(MAX_THREADS)
gan_gen_bwd_kernel(const GenBwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int S = a.S, M = a.M, B = a.B;
  float* w1f = sm;
  float* w1g = w1f + tower_w1_floats(S, G);
  float* w2f = w1g + tower_w1_floats(S, G);
  float* w2g = w2f + tower_w2_floats(M, 1, G);
  float* w1tf = w2g + tower_w2_floats(M, K, G);
  float* w1tg = w1tf + G * G;
  float* w2tf = w1tg + G * G;
  float* w2tg = w2tf + G * G;
  stage_tower(w1f, w2f, a.w[0], a.w[2], S, M, 1, G);
  stage_tower(w1g, w2g, a.w[4], a.w[6], S, M, K, G);
  stage_tower_t(w1tf, w2tf, a.w[0], a.w[2], S, M, 1, G);
  stage_tower_t(w1tg, w2tg, a.w[4], a.w[6], S, M, K, G);
  __syncthreads();

  constexpr int RPW = 32 / G;                  // rows per warp
  const int lane = threadIdx.x & 31;
  const int li = lane & (G - 1);
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  // No barrier follows: a warp with no row of the batch is done. The others
  // run every lane (the shuffles take the whole warp); rows past the end
  // compute on zeros, add zeros and store nothing.
  if (warp * RPW >= B) return;
  const int row = warp * RPW + lane / G;
  const bool live = row < B;
  const bool unit = live && li < S;
  const bool hid = li < M;

  const float* w1s[2] = {w1f, w1g};
  const float b1[2] = {hid ? a.w[1][li] : 0.f, hid ? a.w[5][li] : 0.f};
  float b2f[1] = {li < S ? a.w[3][li] : 0.f};
  float b2g[K];
#pragma unroll
  for (int j = 0; j < K; ++j) b2g[j] = li < S ? a.w[7][li * K + j] : 0.f;

  // Cotangents of unit li's carry, and g_{n+1} of the step being reversed.
  float ay = 0.f, az = 0.f, af = 0.f, ag[K], gn[K];
  // Column li of dW1 (row 0: time) and of dW2 (output li; row k), biases.
  float gw1f[1 + G], gw1g[1 + G], gw2f[G], gw2g[G][K];
  float gb1f = 0.f, gb1g = 0.f, gb2f = 0.f, gb2g[K];
#pragma unroll
  for (int r = 0; r <= G; ++r) gw1f[r] = gw1g[r] = 0.f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    gw2f[k] = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) gw2g[k][j] = 0.f;
  }
  const size_t last = ((size_t(a.N - 1) * B + row) * S + li) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ag[j] = gb2g[j] = 0.f;
    gn[j] = unit ? __ldg(a.gs + last + j) : 0.f;
  }

  StepIn<K> next;
  load_step<K>(a, a.N - 1, row, li, live, unit, next);
  float dt_next = __ldg(a.dts + a.N - 1), t1_next = __ldg(a.t1s + a.N - 1);
  for (int s = a.N - 1; s >= 0; --s) {
    const StepIn<K> in = next;
    const float dt = dt_next, t1 = t1_next;
    if (s > 0) {
      load_step<K>(a, s - 1, row, li, live, unit, next);
      dt_next = __ldg(a.dts + s - 1);
      t1_next = __ldg(a.t1s + s - 1);
    }

    ay += in.gy;
    const float Af = af + 0.5f * dt * ay;
    float Ag[K];
#pragma unroll
    for (int j = 0; j < K; ++j) Ag[j] = ag[j] + 0.5f * ay * in.dW[j];

    // The towers' forward at [t1, z1].
    float pre[2], a1f, a1g, slf, slg;
    tower_layer1<2>(w1s, b1, t1, in.z1, S, G, li, pre);
    lipswish_and_slope(pre[0], a1f, slf);
    lipswish_and_slope(pre[1], a1g, slg);
    float fo[1], go[K];
    tower_layer2<1>(w2f, a1f, b2f, M, G, li, fo);
    tower_layer2<K>(w2g, a1g, b2g, M, G, li, go);

    // Output pre-activation cotangents of unit li, and layer 2's weights:
    // dW2[k][li] += a1[k] dpre2[li].
    const float d2f = Af * (1.f - fo[0] * fo[0]);
    float d2g[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d2g[j] = Ag[j] * (1.f - go[j] * go[j]);
      gb2g[j] += d2g[j];
    }
    gb2f += d2f;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k < M) {
        const float akf = __shfl_sync(FULL, a1f, k, G);
        const float akg = __shfl_sync(FULL, a1g, k, G);
        gw2f[k] = fmaf(akf, d2f, gw2f[k]);
#pragma unroll
        for (int j = 0; j < K; ++j) gw2g[k][j] = fmaf(akg, d2g[j], gw2g[k][j]);
      }
    }

    // Hidden unit li's cotangent, through lipswish.
    float daf = 0.f, dag = 0.f;
#pragma unroll 4
    for (int o = 0; o < S; ++o) {
      daf = fmaf(__shfl_sync(FULL, d2f, o, G), w2tf[o * G + li], daf);
#pragma unroll
      for (int j = 0; j < K; ++j)
        dag = fmaf(__shfl_sync(FULL, d2g[j], o, G),
                   w2tg[(o * K + j) * G + li], dag);
    }
    const float d1f = daf * slf, d1g = dag * slg;

    // Layer 1's weights: dW1[r][li] += [t1, z1][r] dpre1[li].
    gb1f += d1f;
    gb1g += d1g;
    gw1f[0] = fmaf(t1, d1f, gw1f[0]);
    gw1g[0] = fmaf(t1, d1g, gw1g[0]);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (i < S) {
        const float zi = __shfl_sync(FULL, in.z1, i, G);
        gw1f[1 + i] = fmaf(zi, d1f, gw1f[1 + i]);
        gw1g[1 + i] = fmaf(zi, d1g, gw1g[1 + i]);
      }
    }

    // State unit li's cotangent from both towers.
    float dz = 0.f;
#pragma unroll 4
    for (int k = 0; k < M; ++k) {
      dz = fmaf(__shfl_sync(FULL, d1f, k, G), w1tf[k * G + li], dz);
      dz = fmaf(__shfl_sync(FULL, d1g, k, G), w1tg[k * G + li], dz);
    }
    const float Az = az + dz;

    // dnoise[s][j] = sum over units of Az g_n + ay/2 (g_n + g_{n+1}).
    float dn[K];
#pragma unroll
    for (int j = 0; j < K; ++j)
      dn[j] = group_sum<G>(Az * in.gp[j] + 0.5f * ay * (in.gp[j] + gn[j]));
    if (live && li == 0) {
      float* out = a.dnoise + (size_t(s) * B + row) * K;
#pragma unroll
      for (int j = 0; j < K; ++j) out[j] = dn[j];
    }

    af = 0.5f * dt * ay + dt * Az;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ag[j] = (0.5f * ay + Az) * in.dW[j];
      gn[j] = in.gp[j];
    }
    ay += 2.f * Az;
    az = -Az;
  }

  if (unit) {
    const size_t at = size_t(row) * S + li;
    a.dx0[at] = ay + az;
    a.df0[at] = af;
#pragma unroll
    for (int j = 0; j < K; ++j) a.dg0[at * K + j] = ag[j];
  }

  // The two row groups of a warp (G = 16) add up, group 0 first; then lane
  // li of the first group writes the warp's partial of the entries it owns,
  // laid out as the weights in gan_fused.GEN_WEIGHT_NAMES order.
  if constexpr (RPW == 2) {
#pragma unroll
    for (int r = 0; r <= G; ++r) {
      gw1f[r] += __shfl_down_sync(FULL, gw1f[r], 16);
      gw1g[r] += __shfl_down_sync(FULL, gw1g[r], 16);
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      gw2f[k] += __shfl_down_sync(FULL, gw2f[k], 16);
#pragma unroll
      for (int j = 0; j < K; ++j)
        gw2g[k][j] += __shfl_down_sync(FULL, gw2g[k][j], 16);
    }
    gb1f += __shfl_down_sync(FULL, gb1f, 16);
    gb1g += __shfl_down_sync(FULL, gb1g, 16);
    gb2f += __shfl_down_sync(FULL, gb2f, 16);
#pragma unroll
    for (int j = 0; j < K; ++j) gb2g[j] += __shfl_down_sync(FULL, gb2g[j], 16);
  }
  if (lane >= G) return;
  const int Sm = S * K;
  float* p = a.partials + size_t(warp) * a.P;
  float* pW1f = p;
  float* pb1f = pW1f + (1 + S) * M;
  float* pW2f = pb1f + M;
  float* pb2f = pW2f + M * S;
  float* pW1g = pb2f + S;
  float* pb1g = pW1g + (1 + S) * M;
  float* pW2g = pb1g + M;
  float* pb2g = pW2g + M * Sm;
  if (hid) {
#pragma unroll
    for (int r = 0; r <= G; ++r) {
      if (r <= S) {
        pW1f[r * M + li] = gw1f[r];
        pW1g[r * M + li] = gw1g[r];
      }
    }
    pb1f[li] = gb1f;
    pb1g[li] = gb1g;
  }
  if (li < S) {
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k < M) {
        pW2f[k * S + li] = gw2f[k];
#pragma unroll
        for (int j = 0; j < K; ++j) pW2g[k * Sm + li * K + j] = gw2g[k][j];
      }
    }
    pb2f[li] = gb2f;
#pragma unroll
    for (int j = 0; j < K; ++j) pb2g[li * K + j] = gb2g[j];
  }
}

using GenBwdKernel = void (*)(GenBwdArgs);

template <int G>
GenBwdKernel gen_bwd_kernel_for(int m) {
  switch (m) {
    case 1: return gan_gen_bwd_kernel<G, 1>;
    case 2: return gan_gen_bwd_kernel<G, 2>;
    case 3: return gan_gen_bwd_kernel<G, 3>;
    case 4: return gan_gen_bwd_kernel<G, 4>;
    case 5: return gan_gen_bwd_kernel<G, 5>;
    case 6: return gan_gen_bwd_kernel<G, 6>;
    case 7: return gan_gen_bwd_kernel<G, 7>;
    default: return gan_gen_bwd_kernel<G, 8>;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the sweep needs for these widths.
size_t tsde_gan_gen_bwd_smem_bytes(int S, int M, int m) {
  return gen_bwd_smem_floats(S, M, m, bwd_group_width(S, M)) * sizeof(float);
}

// Weight-gradient partials of either backward kernel for a batch of B rows:
// the partial buffer holds one row of all weight gradients for each.
int tsde_gan_bwd_partials(int B, int S, int M) {
  return bwd_partials(B, S, M);
}

// Launches the sweep (`threads` threads per block) and the sum of its
// partials on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for widths beyond the kernel's limits (S, M <= 32,
// m <= 8, threads a multiple of 32 up to 256). All pointers are device
// pointers to contiguous float32 arrays; weights in the order of
// gan_fused.GEN_WEIGHT_NAMES. partials holds tsde_gan_bwd_partials(B, S, M)
// x P floats and dw P floats, P the weights' total element count; dw
// receives their gradients back to back.
int tsde_gan_gen_bwd(const float* g0, const float* noise, const float* t1s,
                     const float* dts, const float* W1f, const float* b1f,
                     const float* W2f, const float* b2f, const float* W1g,
                     const float* b1g, const float* W2g, const float* b2g,
                     const float* zs, const float* gs, const float* gy,
                     float* dx0, float* df0, float* dg0, float* dnoise,
                     float* partials, float* dw, int B, int S, int M, int m,
                     int N, int threads, int device, cudaStream_t stream) {
  if (S < 1 || S > MAX_LANES || M < 1 || M > MAX_LANES || m < 1 ||
      m > MAX_K || threads < 32 || threads > MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  GenBwdArgs a;
  a.g0 = g0; a.noise = noise; a.t1s = t1s; a.dts = dts;
  const float* w[8] = {W1f, b1f, W2f, b2f, W1g, b1g, W2g, b2g};
  for (int i = 0; i < 8; ++i) a.w[i] = w[i];
  a.zs = zs; a.gs = gs; a.gy = gy;
  a.dx0 = dx0; a.df0 = df0; a.dg0 = dg0; a.dnoise = dnoise;
  a.partials = partials;
  a.B = B; a.S = S; a.M = M; a.m = m; a.N = N;
  a.P = 2 * (1 + S) * M + 2 * M + M * S * (1 + m) + S * (1 + m);
  const int G = bwd_group_width(S, M);
  const GenBwdKernel kernel =
      G == 16 ? gen_bwd_kernel_for<16>(m) : gen_bwd_kernel_for<32>(m);
  const size_t smem = tsde_gan_gen_bwd_smem_bytes(S, M, m);
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

}  // extern "C"
