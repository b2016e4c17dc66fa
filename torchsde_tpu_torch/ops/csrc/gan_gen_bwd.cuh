// Reverse sweep of the SDE-GAN generator's whole solve, for Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes): the kernel and its
// launch, instantiated by gan_gen_bwd.cu (float32). The bf16 mixed mode is
// a kernel of its own, on bf16 tensor cores (gan_gen_bwd_bf16.cu).
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
// Design. A row's vectors go through the warp's shared memory
// (gan_warp_rows.cuh), as in gan_cde_bwd.cu: each vector a product needs
// whole (z1, the hidden activations a1f and a1g, the output cotangents d2f
// and the S*m entries of d2g, the hidden cotangents d1f and d1g) is written
// once to the row's slot and, after a __syncwarp, read by every lane of the
// row four floats a load (z1 and a1 once a step into registers, for the
// product and the weight gradients both). Each lane reads its weights four
// a load from lane-major copies staged once a block (W1's columns for
// layer 1, W2's columns for layer 2, W2's rows for the hidden cotangents,
// W1's rows for dz), at strides of 4 x an odd number of floats, so a
// quarter-warp's loads hit distinct banks. A row is served by a group of
// G lanes (G = 16 at the reference scale: two rows a warp; 32 where S or M
// passes 16), lane l owning state unit l and hidden unit l of both towers.
// The only shuffles left in a step are dnoise's group sums. (A second
// layout, one row a warp with the drift tower on lanes 0-15 and the
// diffusion tower on 16-31, took 0.134 ms against this one's 0.097 at the
// reference scale, where the diffusion half does m = 3 times the drift
// half's layer-2 and hidden-cotangent work; it won only with one or two
// noise channels, which no configuration of the repo runs.)
// Every sum keeps the earlier shuffle design's order (layer 1's bias last,
// the output units in order going back, dz alternating the drift's and the
// diffusion's hidden units), so dx0, df0, dg0 and dnoise are bitwise that
// design's. What bounds a step is its chain of dependent products: at the
// reference widths (S = M = 16) an instantiation with the widths fixed
// runs every product's chain without a branch (with the widths known only
// at run time, each guarded term of a chain is a branch). The
// earlier shuffle design took 0.240 ms at the reference scale; this one
// 0.097 (NVIDIA H100 80GB HBM3, 700 W). g_{n+1} is carried
// from the step before in registers; each step's inputs are loaded one
// step ahead.
//
// Weight gradients (1,664 floats at the reference scale) are sums over
// every row and step. A lane accumulates the entries it owns: column l of
// W1 and b1[l], and column l of W2 with its b2 entries, of each tower it
// serves, in register arrays sized by the template widths (G, m). At the
// end the two rows of a warp add up, row 2w first, and each warp writes one
// partial; a second kernel sums the partials in a fixed order, so the
// weight gradients are bitwise the earlier design's, and two calls give the
// same bits. Precise expf and tanhf, float32 throughout.
// The kernels allocate nothing and do not synchronise the host.
//
// The bf16 mixed mode is a kernel of its own (gan_gen_bwd_bf16.cu).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "gan_fused_common.cuh"
#include "gan_warp_rows.cuh"

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

// The sweep's shared memory (floats). The block's weight copies, each G
// lane rows of a stride from odd_quad (zeros past S or M), for each tower
// q (0 drift, 1 diffusion, with kq = 1 or m output channels a unit):
//   w1c[q][l * K1 + i]              = W1q[1 + i][l]          layer 1
//   w2c[q][(l * kq + j) * K2 + k]   = W2q[k][l * kq + j]     layer 2
//   w2r[q][l * K3[q] + o]           = W2q[l][o]              da, hidden l
// and for dz, the two towers' rows interleaved:
//   w1r[l * K4 + 2 k + q]           = W1q[1 + l][k]          unit l
// then each warp's rows, a row's slot holding z1 (G), a1f and a1g (G
// each), d2f (G), d2g (G * m) and d1 (2 G, d1f and d1g interleaved).
struct GenLayout {
  int K1, K2, K3[2], K4;
  int w1c[2], w2c[2], w2r[2], w1r, block;
  int z, a[2], d[2], e, row;  // offsets inside a row's slot, and its size
};

__host__ __device__ inline GenLayout gen_layout(int S, int M, int m, int G) {
  GenLayout L;
  L.K1 = odd_quad(S);
  L.K2 = odd_quad(M);
  L.K3[0] = odd_quad(S);
  L.K3[1] = odd_quad(S * m);
  L.K4 = odd_quad(2 * M);
  L.w1c[0] = 0;
  L.w1c[1] = L.w1c[0] + G * L.K1;
  L.w2c[0] = L.w1c[1] + G * L.K1;
  L.w2c[1] = L.w2c[0] + G * L.K2;
  L.w2r[0] = L.w2c[1] + G * m * L.K2;
  L.w2r[1] = L.w2r[0] + G * L.K3[0];
  L.w1r = L.w2r[1] + G * L.K3[1];
  L.block = L.w1r + G * L.K4;
  L.z = 0;
  L.a[0] = G;
  L.a[1] = 2 * G;
  L.d[0] = 3 * G;
  L.d[1] = 4 * G;
  L.e = (4 + m) * G;
  L.row = (6 + m) * G;
  return L;
}

__host__ __device__ inline size_t gen_bwd_smem_floats(int S, int M, int m,
                                                      int warps) {
  const GenLayout L = gen_layout(S, M, m, bwd_group_width(S, M));
  return size_t(L.block) + size_t(warps) * 32 * (6 + m);
}

// Stages the lane-major weight copies of gen_layout with the whole block.
__device__ inline void stage_gen_weights(float* sm, const GenLayout& L,
                                         const float* const* w, int S, int M,
                                         int m, int G) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* W1 = w[4 * q];
    const float* W2 = w[4 * q + 2];
    const int kq = q ? m : 1, Sk = S * kq, K3 = L.K3[q];
    for (int e = threadIdx.x; e < G * L.K1; e += blockDim.x) {
      const int l = e / L.K1, i = e % L.K1;
      sm[L.w1c[q] + e] = l < M && i < S ? W1[(1 + i) * M + l] : 0.f;
    }
    for (int e = threadIdx.x; e < G * kq * L.K2; e += blockDim.x) {
      const int o = e / L.K2, k = e % L.K2, l = o / kq;
      sm[L.w2c[q] + e] = l < S && k < M ? W2[k * Sk + o] : 0.f;
    }
    for (int e = threadIdx.x; e < G * K3; e += blockDim.x) {
      const int l = e / K3, o = e % K3;
      sm[L.w2r[q] + e] = l < M && o < Sk ? W2[l * Sk + o] : 0.f;
    }
  }
  for (int e = threadIdx.x; e < G * L.K4; e += blockDim.x) {
    const int l = e / L.K4, c = e % L.K4, k = c / 2;
    sm[L.w1r + e] = l < S && k < M ? w[4 * (c % 2)][(1 + l) * M + k] : 0.f;
  }
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

// What a lane reads of one tower: its weight rows, its row's vectors of
// that tower, and its biases.
template <int K>
struct GenTower {
  const float* w1c;   // W1's column li
  const float* w2c;   // W2's kq columns of output unit li
  const float* w2r;   // W2's row li
  float* av;          // the row's hidden activations
  float* dv;          // the row's output cotangents
  int kq;             // output channels a unit
  float w1t, b1, b2[K];
};

template <int K>
__device__ __forceinline__ GenTower<K> gen_tower(const float* sm,
                                                 const GenLayout& L,
                                                 const GenBwdArgs& a,
                                                 float* slot, int q, int li) {
  GenTower<K> T;
  T.kq = q ? K : 1;
  T.w1c = sm + L.w1c[q] + li * L.K1;
  T.w2c = sm + L.w2c[q] + li * T.kq * L.K2;
  T.w2r = sm + L.w2r[q] + li * L.K3[q];
  T.av = slot + L.a[q];
  T.dv = slot + L.d[q];
  const bool hid = li < a.M;
  T.w1t = hid ? a.w[4 * q][li] : 0.f;    // W1's time row
  T.b1 = hid ? a.w[4 * q + 1][li] : 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j)
    T.b2[j] = li < a.S && j < T.kq ? a.w[4 * q + 3][li * T.kq + j] : 0.f;
  return T;
}

// The group width G (16 or 32) and the number of noise channels K = m
// (1..MAX_K) are template parameters: a lane's channels and weight-gradient
// accumulators are register arrays and the loops over them unroll exactly.
// SF and MF fix S and M where they are not 0, so that every product's chain
// unrolls without a branch.
template <int G, int K, int SF, int MF>
__global__ void __launch_bounds__(MAX_THREADS)
gan_gen_bwd_kernel(const GenBwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int S = SF ? SF : a.S, M = MF ? MF : a.M, B = a.B;
  const GenLayout L = gen_layout(S, M, K, G);
  stage_gen_weights(sm, L, a.w, S, M, K, G);
  __syncthreads();

  constexpr int RPW = 32 / G;                  // rows per warp
  const int lane = threadIdx.x & 31;
  const int li = lane & (G - 1);
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  // No barrier follows: a warp with no row of the batch is done. The others
  // run every lane (__syncwarp and the shuffles take the whole warp); rows
  // past the end compute on zeros, add zeros and store nothing.
  if (warp * RPW >= B) return;
  const int rw = lane / G;                     // the row inside the warp
  const int row = warp * RPW + rw;
  const bool live = row < B;
  const bool unit = live && li < S;

  float* slot = sm + L.block + (threadIdx.x >> 5) * 32 * (6 + K)
                + rw * L.row;
  float* zv = slot + L.z;
  float* ev = slot + L.e;
  const float* w1r = sm + L.w1r + li * L.K4;
  GenTower<K> T[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) T[q] = gen_tower<K>(sm, L, a, slot, q, li);

  // Cotangents of unit li's carry, and g_{n+1} of the step being reversed.
  float ay = 0.f, az = 0.f, af = 0.f, ag[K], gn[K];
  // Of each tower: column li of dW1 (row 0: time) and of dW2 (outputs
  // (li, j); row k), and the biases.
  float gw1[2][1 + G], gw2[2][G][K], gb1[2], gb2[2][K];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    gb1[q] = 0.f;
#pragma unroll
    for (int r = 0; r <= G; ++r) gw1[q][r] = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      gb2[q][j] = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) gw2[q][k][j] = 0.f;
    }
  }
  const size_t last = ((size_t(a.N - 1) * B + row) * S + li) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ag[j] = 0.f;
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

    // The towers' layer 1 at [t1, z1], z1 read once into registers: the
    // last step's reads of zv ended before its d1 barrier.
    zv[li] = in.z1;
    __syncwarp();
    float zr[G];
    load4(zv, S, zr);
    float sl1[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float a1;
      lipswish_and_slope(dotr4(zr, T[q].w1c, S, t1 * T[q].w1t) + T[q].b1,
                         a1, sl1[q]);
      T[q].av[li] = a1;
    }
    __syncwarp();

    // Layer 2 from the hidden activations read once into registers, its
    // outputs' pre-activation cotangents, and its weights:
    // dW2[k][(li, j)] += a1[k] dpre2[(li, j)].
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float ar[G];
      load4(T[q].av, M, ar);
      float o[K];
#pragma unroll
      for (int j = 0; j < K; ++j) o[j] = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < G; k4 += 4) {
        if (k4 < M) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            if (j < T[q].kq) {
              const float4 y = *reinterpret_cast<const float4*>(
                  T[q].w2c + j * L.K2 + k4);
              o[j] = fmaf(ar[k4], y.x, o[j]);
              if (k4 + 1 < M) o[j] = fmaf(ar[k4 + 1], y.y, o[j]);
              if (k4 + 2 < M) o[j] = fmaf(ar[k4 + 2], y.z, o[j]);
              if (k4 + 3 < M) o[j] = fmaf(ar[k4 + 3], y.w, o[j]);
            }
          }
        }
      }
      float d2[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        d2[j] = 0.f;
        if (j < T[q].kq) {
          const float out = tanhf(o[j] + T[q].b2[j]);
          const float dpre2 = (q ? Ag[j] : Af) * (1.f - out * out);
          gb2[q][j] += dpre2;
          d2[j] = dpre2;
          T[q].dv[li * T[q].kq + j] = d2[j];
        }
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (k < M) {
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (j < T[q].kq)
              gw2[q][k][j] = fmaf(ar[k], d2[j], gw2[q][k][j]);
        }
      }
    }
    __syncwarp();

    // Hidden unit li's cotangents, through lipswish, and layer 1's weights:
    // dW1[r][li] += [t1, z1][r] dpre1[li].
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float da = dot4<G * K / 4>(T[q].dv, T[q].w2r, S * T[q].kq, 0.f);
      const float d1 = da * sl1[q];
      gb1[q] += d1;
      gw1[q][0] = fmaf(t1, d1, gw1[q][0]);
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (i < S) gw1[q][1 + i] = fmaf(zr[i], d1, gw1[q][1 + i]);
      ev[2 * li + q] = d1;
    }
    __syncwarp();

    // State unit li's cotangent from both towers, their hidden units
    // alternating in one chain (the JAX kernel adds the two towers' input
    // cotangents as two float32 vectors: the same terms in another order).
    const float Az = az + dot4<G / 2>(ev, w1r, 2 * M, 0.f);

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

  // The two rows of a warp (G = 16) add up, row 2w first; then lane li of
  // the first writes the warp's partial of the entries it owns, laid out as
  // the weights in gan_fused.GEN_WEIGHT_NAMES order.
  if constexpr (RPW == 2) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int r = 0; r <= G; ++r)
        gw1[q][r] += __shfl_down_sync(FULL, gw1[q][r], 16);
#pragma unroll
      for (int k = 0; k < G; ++k) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (j < T[q].kq)
            gw2[q][k][j] += __shfl_down_sync(FULL, gw2[q][k][j], 16);
      }
      gb1[q] += __shfl_down_sync(FULL, gb1[q], 16);
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (j < T[q].kq) gb2[q][j] += __shfl_down_sync(FULL, gb2[q][j], 16);
    }
  }
  if (lane >= G) return;
  const int base[2] = {0, (1 + S) * M + M + M * S + S};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int kq = T[q].kq, Sk = S * kq;
    float* pW1 = a.partials + size_t(warp) * a.P + base[q];
    float* pb1 = pW1 + (1 + S) * M;
    float* pW2 = pb1 + M;
    float* pb2 = pW2 + M * Sk;
    if (li < M) {
#pragma unroll
      for (int r = 0; r <= G; ++r) {
        if (r <= S) pW1[r * M + li] = gw1[q][r];
      }
      pb1[li] = gb1[q];
    }
    if (li < S) {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (k < M) {
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (j < kq) pW2[k * Sk + li * kq + j] = gw2[q][k][j];
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (j < kq) pb2[li * kq + j] = gb2[q][j];
    }
  }
}

using GenBwdKernel = void (*)(GenBwdArgs);

template <int G, int SF = 0, int MF = 0>
GenBwdKernel gen_bwd_kernel_for(int m) {
  switch (m) {
    case 1: return gan_gen_bwd_kernel<G, 1, SF, MF>;
    case 2: return gan_gen_bwd_kernel<G, 2, SF, MF>;
    case 3: return gan_gen_bwd_kernel<G, 3, SF, MF>;
    case 4: return gan_gen_bwd_kernel<G, 4, SF, MF>;
    case 5: return gan_gen_bwd_kernel<G, 5, SF, MF>;
    case 6: return gan_gen_bwd_kernel<G, 6, SF, MF>;
    case 7: return gan_gen_bwd_kernel<G, 7, SF, MF>;
    default: return gan_gen_bwd_kernel<G, 8, SF, MF>;
  }
}

// Launches the sweep and the sum of its partials: the body of the entry
// points of gan_gen_bwd.cu.
inline int launch_gen_bwd(const float* g0, const float* noise,
                          const float* t1s, const float* dts,
                          const float* const* w, const float* zs,
                          const float* gs, const float* gy, float* dx0,
                          float* df0, float* dg0, float* dnoise,
                          float* partials, float* dw, int B, int S, int M,
                          int m, int N, int threads, int device,
                          cudaStream_t stream) {
  if (S < 1 || S > MAX_LANES || M < 1 || M > MAX_LANES || m < 1 ||
      m > MAX_K || threads < 32 || threads > MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  GenBwdArgs a;
  a.g0 = g0; a.noise = noise; a.t1s = t1s; a.dts = dts;
  for (int i = 0; i < 8; ++i) a.w[i] = w[i];
  a.zs = zs; a.gs = gs; a.gy = gy;
  a.dx0 = dx0; a.df0 = df0; a.dg0 = dg0; a.dnoise = dnoise;
  a.partials = partials;
  a.B = B; a.S = S; a.M = M; a.m = m; a.N = N;
  a.P = 2 * (1 + S) * M + 2 * M + M * S * (1 + m) + S * (1 + m);
  const int G = bwd_group_width(S, M);
  // The reference widths run an instantiation with them fixed.
  const GenBwdKernel kernel =
      S == 16 && M == 16 ? gen_bwd_kernel_for<16, 16, 16>(m)
      : G == 16          ? gen_bwd_kernel_for<16>(m)
                         : gen_bwd_kernel_for<32>(m);
  const size_t smem = gen_bwd_smem_floats(S, M, m, threads / 32)
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
