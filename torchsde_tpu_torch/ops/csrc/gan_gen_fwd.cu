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
// the card, each a chain of two 16-term dot products, lipswish and tanh.
//
// Design. One row a warp. A row's vectors go through the warp's shared
// memory (gan_warp_rows.cuh), as in gan_cde_fwd.cu: z1 is written once to
// the row's slot and, after a __syncwarp, read by every lane into
// registers four floats a load; then the hidden activations likewise, once
// a step for all of a tower's outputs. Each lane reads its weights (W1's
// column of its hidden unit, W2's columns of its state unit) once from
// lane-major copies staged in shared memory into registers. No shuffle is
// left in a step. Where S, M <= 16 the towers sit on the two half-warps:
// lanes 0-15 (h = 0) the drift tower, lanes 16-31 (h = 1) the diffusion
// tower, lane li of each hidden unit li of its tower and the outputs of
// state unit li (f, or the m entries of g). Both halves carry the row's
// state (x, z, f, g of unit li) and compute it alike, and every lane runs
// the same instructions: a drift lane runs the diffusion's m chains of
// layer 2 on W2f's column and keeps the first, so that no branch splits
// the warp; the two towers' outputs meet in the row's slot after a third
// __syncwarp. Against two rows a warp with both towers on a lane (kernel
// 6's layout) it took 0.041 ms against 0.048 at the reference scale, and
// 0.036 against 0.044 with one row: half the work a lane shortens the
// chain more than the third exchange lengthens it (NVIDIA H100 80GB HBM3,
// 700 W). Where S or M passes 16 a row takes all 32 lanes, lane l both
// towers' hidden unit l and state unit l; layer 2's weights stay in
// registers up to three noise channels, and past that, where they would
// spill, are read from shared memory at each step.
//
// The reference widths (S = M = 16) run instantiations with the widths
// fixed, whose chains have no branch. The weights are staged with eight
// loads of a thread in flight. At the reference scale the solve takes
// 0.033 ms, against 0.079 for the earlier design, which gathered z1 and
// the hidden activations lane to lane with 48 shuffles a row and step; at
// B = 1 0.027 ms, so one warp's chain of dependent steps is still most of
// the time (NVIDIA H100 80GB HBM3, 700 W). Every sum keeps the order of the
// earlier shuffle design (layer 1 from the time term, z1's terms in order,
// the bias last; layer 2 the hidden units in order, then the bias), so ys,
// zs and gs are bitwise its. Each step's noise, time and width are loaded
// one step ahead. Precise expf and tanhf; state and sums in float32. The
// kernel allocates nothing and does not synchronise the host.
//
// bf16 mixed mode (tsde_gan_gen_fwd_bf16; the JAX package's _tower_fwd
// with bf16 weights): the weights and the noise come in bf16, the weights
// widened once as they are staged, the noise a step ahead by a 2-byte
// load (cp.async moves 4 bytes at least). Only the products' inputs are
// rounded to bf16: [t1, z1] before layer 1 and the hidden activations
// before layer 2. The biases, lipswish, tanh, the g . dW products and the
// state stay float32; ys, zs and gs go out float32.

#include <cuda_runtime.h>
#include <stddef.h>

#include "gan_fused_common.cuh"
#include "gan_warp_rows.cuh"

namespace {

using namespace tsde_gan;

// W is the storage type of the noise and the weights (float, or bf16 in
// mixed mode); the rest is float32 either way.
template <typename W>
struct GenArgs {
  const float* x0;      // (B, S)
  const float* f0;      // (B, S)
  const float* g0;      // (B, S*m)
  const W* noise;       // (N, B, m)
  const float* t1s;     // (N,)
  const float* dts;     // (N,)
  const W* w[8];        // W1f b1f W2f b2f W1g b1g W2g b2g
  float* ys;            // (N, B, S)
  float* zs;            // (N, B, S)
  float* gs;            // (N, B, S*m)
  int B, S, M, m, N;
};

// The solve's shared memory (floats). The block's weight copies, G lane
// rows each at a stride from odd_quad (zeros past S or M; G = 16 where
// S, M <= 16, else 32):
//   w1c[q][l * K1 + i]               = W1q[1 + i][l]    layer 1 of tower q
//   w2c[(l * (1 + m) + o) * K2 + k]  = W2f[k][l]             (o = 0)
//                                    = W2g[k][l * m + o - 1] (o >= 1)
// then each warp's row: z1 (G), the two towers' hidden activations (G
// each) and, at G = 16, the two halves' m outputs a lane (2 G m).
struct GenFwdLayout {
  int K1, K2;
  int w1c[2], w2c, block;
};

__host__ __device__ inline GenFwdLayout gen_fwd_layout(int S, int M, int m,
                                                       int G) {
  GenFwdLayout L;
  L.K1 = odd_quad(S);
  L.K2 = odd_quad(M);
  L.w1c[0] = 0;
  L.w1c[1] = G * L.K1;
  L.w2c = 2 * G * L.K1;
  L.block = L.w2c + G * (1 + m) * L.K2;
  return L;
}

__host__ __device__ inline int gen_fwd_warp_floats(int m, int G) {
  return G == 16 ? 48 + 32 * m : 96;
}

__host__ __device__ inline size_t gen_fwd_smem_floats(int S, int M, int m,
                                                      int warps) {
  const int G = bwd_group_width(S, M);
  return size_t(gen_fwd_layout(S, M, m, G).block)
         + size_t(warps) * gen_fwd_warp_floats(m, G);
}

// Entry e of the block's weight copies, widened to float.
template <typename W>
__device__ __forceinline__ float gen_fwd_weight(const GenFwdLayout& L,
                                                const W* const* w, int S,
                                                int M, int m, int e) {
  if (e < L.w2c) {
    const int q = e >= L.w1c[1], r = q ? e - L.w1c[1] : e;
    const int l = r / L.K1, i = r % L.K1;
    return l < M && i < S ? ldw(w[4 * q] + (1 + i) * M + l) : 0.f;
  }
  const int r = (e - L.w2c) / L.K2, k = (e - L.w2c) % L.K2;
  const int l = r / (1 + m), o = r % (1 + m);
  if (l >= S || k >= M) return 0.f;
  return o ? ldw(w[6] + k * (S * m) + l * m + o - 1)
           : ldw(w[2] + k * S + l);
}

// Stages the weight copies with the whole block, eight loads of a thread
// in flight at once (a loop of a load and a store each waits out every
// load's latency in turn).
template <typename W>
__device__ inline void stage_gen_fwd_weights(float* sm,
                                             const GenFwdLayout& L,
                                             const W* const* w, int S,
                                             int M, int m) {
  constexpr int BATCH = 8;
  for (int e0 = threadIdx.x; e0 < L.block; e0 += BATCH * blockDim.x) {
    float v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int e = e0 + b * blockDim.x;
      v[b] = e < L.block ? gen_fwd_weight(L, w, S, M, m, e) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int e = e0 + b * blockDim.x;
      if (e < L.block) sm[e] = v[b];
    }
  }
}

// Calls chunk(q) for the float4 chunks q of [0, n) in order (n <= N): a
// product's chains run in one chunk loop, their terms interleaved, and
// with the widths known only at run time the chunks past n are skipped
// with one branch each rather than run as guarded terms of the chain.
template <int N, class F>
__device__ __forceinline__ void for_chunks(int n, F chunk) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    if (4 * q >= n) break;
    chunk(q);
  }
}

// acc = fmaf(v[k], w[k], acc) for the k < n of chunk q in order, v in
// registers and w the chunk's four weights.
template <int N>
__device__ __forceinline__ float chunk_dot(const float (&v)[N], float4 w,
                                           int q, int n, float acc) {
  const int k = 4 * q;
  acc = fmaf(v[k], w.x, acc);
  if (k + 1 < n) acc = fmaf(v[k + 1], w.y, acc);
  if (k + 2 < n) acc = fmaf(v[k + 2], w.z, acc);
  if (k + 3 < n) acc = fmaf(v[k + 3], w.w, acc);
  return acc;
}

template <int N>
__device__ __forceinline__ float4 chunk(const float (&w)[N], int q) {
  return make_float4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
}

// A lane's unit of the row's state, its noise (widened to float) and its
// output pointers, advanced a step at a time.
template <typename W, int K>
struct GenRow {
  float x, z, f, g[K], dW[K], dW_next[K];
  const W* noise;       // the row's noise of the next step
  float *ys, *zs, *gs;  // unit li's outputs of this step
  size_t noise_step, step, g_step;

  __device__ GenRow(const GenArgs<W>& a, int row, int li, bool unit) {
    const int S = a.S;
    x = unit ? a.x0[size_t(row) * S + li] : 0.f;
    z = x;
    f = unit ? a.f0[size_t(row) * S + li] : 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j)
      g[j] = unit ? a.g0[(size_t(row) * S + li) * K + j] : 0.f;
    noise = a.noise + size_t(row) * K;
    noise_step = size_t(a.B) * K;
    step = size_t(a.B) * S;
    g_step = step * K;
    ys = a.ys + size_t(row) * S + li;
    zs = a.zs + size_t(row) * S + li;
    gs = a.gs + (size_t(row) * S + li) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) dW_next[j] = ldw(noise + j);
  }

  // Takes step s's noise and loads the next step's.
  __device__ __forceinline__ void next_noise(bool more) {
#pragma unroll
    for (int j = 0; j < K; ++j) dW[j] = dW_next[j];
    noise += noise_step;
    if (more) {
#pragma unroll
      for (int j = 0; j < K; ++j) dW_next[j] = ldw(noise + j);
    }
  }

  __device__ __forceinline__ float z1(float dt) const {
    float g0dW = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) g0dW = fmaf(g[j], dW[j], g0dW);
    return 2.f * x - z + dt * f + g0dW;
  }

  __device__ __forceinline__ void update(float z1, float dt, float f1,
                                         const float (&g1)[K]) {
    float gsum = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) gsum = fmaf(g[j] + g1[j], dW[j], gsum);
    x = x + 0.5f * dt * (f + f1) + 0.5f * gsum;
    z = z1;
    f = f1;
#pragma unroll
    for (int j = 0; j < K; ++j) g[j] = g1[j];
  }

  __device__ __forceinline__ void advance() {
    ys += step;
    zs += step;
    gs += g_step;
  }
};

// S, M <= 16: the towers on the two half-warps. The number of noise
// channels K = m (1..MAX_K) is a template parameter: a lane's m entries of
// g and its weights are register arrays and the loops over them unroll
// exactly. SF and MF fix S and M where they are not 0, so that every
// product's chain unrolls without a branch.
template <typename W, int K, int SF, int MF>
__global__ void __launch_bounds__(MAX_THREADS)
gan_gen_fwd_kernel(const GenArgs<W> a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int G = 16;
  const int S = SF ? SF : a.S, M = MF ? MF : a.M;
  const GenFwdLayout L = gen_fwd_layout(S, M, K, G);
  stage_gen_fwd_weights(sm, L, a.w, S, M, K);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  // No barrier follows: a warp with no row of the batch is done.
  if (row >= a.B) return;
  const int h = (threadIdx.x >> 4) & 1, li = threadIdx.x & 15;
  const bool unit = li < S, hid = li < M;

  // This lane's weights: W1's column li of its tower and W2's columns of
  // unit li (a drift lane: W2f's, m times; zeros past S or M).
  float w1[G], w2[K][G];
  load4(sm + (h ? L.w1c[1] : L.w1c[0]) + li * L.K1, S, w1);
  const float* w2s = sm + L.w2c + li * (1 + K) * L.K2;
#pragma unroll
  for (int j = 0; j < K; ++j) load4(w2s + (h ? 1 + j : 0) * L.K2, M, w2[j]);
  float* zv = sm + L.block + warp * gen_fwd_warp_floats(K, G);
  float* av = zv + G;                          // a1f, then a1g
  float* ov = av + 2 * G;                      // each half's K a lane
  const float w1t = hid ? to_f(a.w[4 * h][li]) : 0.f;    // W1's time row
  const float b1 = hid ? to_f(a.w[4 * h + 1][li]) : 0.f;
  float b2[K];
#pragma unroll
  for (int j = 0; j < K; ++j)
    b2[j] = !unit ? 0.f : to_f(h ? a.w[7][li * K + j] : a.w[3][li]);

  GenRow<W, K> r(a, row, li, unit);
  float dt_next = __ldg(a.dts), t1_next = __ldg(a.t1s);
  for (int s = 0; s < a.N; ++s) {
    const bool more = s + 1 < a.N;
    r.next_noise(more);
    const float dt = dt_next, t1 = t1_next;
    if (more) {
      dt_next = __ldg(a.dts + s + 1);
      t1_next = __ldg(a.t1s + s + 1);
    }

    // Layer 1 at [t1, z1], its input rounded to W: the last step's reads of
    // zv ended before its a1 barrier.
    const float z1 = r.z1(dt);
    if (h == 0) zv[li] = rnd<W>(z1);
    __syncwarp();
    float zr[G];
    load4(zv, S, zr);
    float pre = rnd<W>(t1) * w1t;
    for_chunks<G>(S, [&](int q) {
      pre = chunk_dot(zr, chunk(w1, q), q, S, pre);
    });
    av[h * G + li] = rnd<W>(lipswish(pre + b1));
    __syncwarp();
    // Layer 2 of this half's tower, its hidden activations read once: the
    // next step writes av only after its z1 barrier, which every lane
    // reaches past these reads.
    float ar[G];
    load4(av + h * G, M, ar);
    float o[K];
#pragma unroll
    for (int j = 0; j < K; ++j) o[j] = 0.f;
    for_chunks<G>(M, [&](int q) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        o[j] = chunk_dot(ar, chunk(w2[j], q), q, M, o[j]);
    });
    float* out = ov + (h * G + li) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) out[j] = tanhf(o[j] + b2[j]);
    __syncwarp();
    // Unit li's f1 from the drift half and g1 from the diffusion half: the
    // next step writes ov only after its a1 barrier.
    const float f1 = ov[li * K];
    float g1[K];
#pragma unroll
    for (int j = 0; j < K; ++j) g1[j] = ov[(G + li) * K + j];
    r.update(z1, dt, f1, g1);

    if (unit) {
      if (h == 0) {
        *r.ys = r.x;
        *r.zs = r.z;
      } else {
#pragma unroll
        for (int j = 0; j < K; ++j) r.gs[j] = r.g[j];
      }
    }
    r.advance();
  }
}

// S or M > 16: a row on all 32 lanes, lane l both towers' hidden unit l and
// state unit l. Past three noise channels layer 2's weights (32 (1 + m) a
// lane) would spill from registers: there they are read from shared memory
// at each step, four a load (at m 8 that took 0.038 ms against 0.224 for
// registers, at m 3 0.042 against 0.038; NVIDIA H100 80GB HBM3, 700 W).
template <typename W, int K>
__global__ void __launch_bounds__(MAX_THREADS)
gan_gen_fwd_wide_kernel(const GenArgs<W> a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int G = 32;
  constexpr bool WS = K > 3;
  const int S = a.S, M = a.M;
  const GenFwdLayout L = gen_fwd_layout(S, M, K, G);
  stage_gen_fwd_weights(sm, L, a.w, S, M, K);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= a.B) return;
  const int li = threadIdx.x & 31;
  const bool unit = li < S, hid = li < M;

  float w1[2][G], w2[WS ? 1 : 1 + K][G];
#pragma unroll
  for (int q = 0; q < 2; ++q) load4(sm + L.w1c[q] + li * L.K1, S, w1[q]);
  const float* w2s = sm + L.w2c + li * (1 + K) * L.K2;
  if constexpr (!WS) {
#pragma unroll
    for (int o = 0; o <= K; ++o) load4(w2s + o * L.K2, M, w2[o]);
  }
  float* zv = sm + L.block + warp * gen_fwd_warp_floats(K, G);
  float* av = zv + G;                          // a1f, then a1g
  float w1t[2], b1[2], b2[1 + K];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    w1t[q] = hid ? to_f(a.w[4 * q][li]) : 0.f;
    b1[q] = hid ? to_f(a.w[4 * q + 1][li]) : 0.f;
  }
  b2[0] = unit ? to_f(a.w[3][li]) : 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j)
    b2[1 + j] = unit ? to_f(a.w[7][li * K + j]) : 0.f;

  GenRow<W, K> r(a, row, li, unit);
  float dt_next = __ldg(a.dts), t1_next = __ldg(a.t1s);
  for (int s = 0; s < a.N; ++s) {
    const bool more = s + 1 < a.N;
    r.next_noise(more);
    const float dt = dt_next, t1 = t1_next;
    if (more) {
      dt_next = __ldg(a.dts + s + 1);
      t1_next = __ldg(a.t1s + s + 1);
    }

    const float z1 = r.z1(dt);
    zv[li] = rnd<W>(z1);
    __syncwarp();
    float zr[G];
    load4(zv, S, zr);
    const float t1r = rnd<W>(t1);
    float pre[2] = {t1r * w1t[0], t1r * w1t[1]};
    for_chunks<G>(S, [&](int q) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        pre[c] = chunk_dot(zr, chunk(w1[c], q), q, S, pre[c]);
    });
#pragma unroll
    for (int c = 0; c < 2; ++c)
      av[c * G + li] = rnd<W>(lipswish(pre[c] + b1[c]));
    __syncwarp();
    // Layer 2: the drift's output from a1f, the diffusion's m from a1g.
    float arf[G], arg[G], o[1 + K];
    load4(av, M, arf);
    load4(av + G, M, arg);
#pragma unroll
    for (int p = 0; p <= K; ++p) o[p] = 0.f;
    for_chunks<G>(M, [&](int q) {
#pragma unroll
      for (int p = 0; p <= K; ++p) {
        const float4 y =
            WS ? reinterpret_cast<const float4*>(w2s + p * L.K2)[q]
               : chunk(w2[WS ? 0 : p], q);
        o[p] = chunk_dot(p ? arg : arf, y, q, M, o[p]);
      }
    });
    float g1[K];
#pragma unroll
    for (int j = 0; j < K; ++j) g1[j] = tanhf(o[1 + j] + b2[1 + j]);
    r.update(z1, dt, tanhf(o[0] + b2[0]), g1);

    if (unit) {
      *r.ys = r.x;
      *r.zs = r.z;
#pragma unroll
      for (int j = 0; j < K; ++j) r.gs[j] = r.g[j];
    }
    r.advance();
  }
}

template <typename W>
using GenFwdKernel = void (*)(GenArgs<W>);

template <typename W, int SF = 0, int MF = 0>
GenFwdKernel<W> gen_fwd_kernel_for(int m) {
  switch (m) {
    case 1: return gan_gen_fwd_kernel<W, 1, SF, MF>;
    case 2: return gan_gen_fwd_kernel<W, 2, SF, MF>;
    case 3: return gan_gen_fwd_kernel<W, 3, SF, MF>;
    case 4: return gan_gen_fwd_kernel<W, 4, SF, MF>;
    case 5: return gan_gen_fwd_kernel<W, 5, SF, MF>;
    case 6: return gan_gen_fwd_kernel<W, 6, SF, MF>;
    case 7: return gan_gen_fwd_kernel<W, 7, SF, MF>;
    default: return gan_gen_fwd_kernel<W, 8, SF, MF>;
  }
}

template <typename W>
GenFwdKernel<W> gen_fwd_wide_kernel_for(int m) {
  switch (m) {
    case 1: return gan_gen_fwd_wide_kernel<W, 1>;
    case 2: return gan_gen_fwd_wide_kernel<W, 2>;
    case 3: return gan_gen_fwd_wide_kernel<W, 3>;
    case 4: return gan_gen_fwd_wide_kernel<W, 4>;
    case 5: return gan_gen_fwd_wide_kernel<W, 5>;
    case 6: return gan_gen_fwd_wide_kernel<W, 6>;
    case 7: return gan_gen_fwd_wide_kernel<W, 7>;
    default: return gan_gen_fwd_wide_kernel<W, 8>;
  }
}

// Launches the solve (float32 weights and noise, or bf16 in mixed mode):
// the body of both entry points below.
template <typename W>
int launch_gen_fwd(const float* x0, const float* f0, const float* g0,
                   const W* noise, const float* t1s, const float* dts,
                   const W* const* w, float* ys, float* zs, float* gs, int B,
                   int S, int M, int m, int N, int threads, int device,
                   cudaStream_t stream) {
  if (S < 1 || S > MAX_LANES || M < 1 || M > MAX_LANES || m < 1 ||
      m > MAX_K || threads < 32 || threads > MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  GenArgs<W> a;
  a.x0 = x0; a.f0 = f0; a.g0 = g0; a.noise = noise; a.t1s = t1s;
  a.dts = dts;
  for (int i = 0; i < 8; ++i) a.w[i] = w[i];
  a.ys = ys; a.zs = zs; a.gs = gs;
  a.B = B; a.S = S; a.M = M; a.m = m; a.N = N;
  // The reference widths run an instantiation with them fixed.
  const GenFwdKernel<W> kernel =
      S == 16 && M == 16           ? gen_fwd_kernel_for<W, 16, 16>(m)
      : bwd_group_width(S, M) == 16 ? gen_fwd_kernel_for<W>(m)
                                    : gen_fwd_wide_kernel_for<W>(m);
  const size_t smem = gen_fwd_smem_floats(S, M, m, threads / 32)
                      * sizeof(float);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = threads / 32;
  kernel<<<(B + rows_per_block - 1) / rows_per_block, threads, smem,
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for these widths at `threads`
// threads a block (the same for both entry points: the weights are staged
// as float).
size_t tsde_gan_gen_fwd_smem_bytes(int S, int M, int m, int threads) {
  return gen_fwd_smem_floats(S, M, m, threads / 32) * sizeof(float);
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
  const float* w[8] = {W1f, b1f, W2f, b2f, W1g, b1g, W2g, b2g};
  return launch_gen_fwd(x0, f0, g0, noise, t1s, dts, w, ys, zs, gs, B, S, M,
                        m, N, threads, device, stream);
}

// bf16 mixed mode: the noise and the weights bf16, the rest as above (ys,
// zs and gs float32).
int tsde_gan_gen_fwd_bf16(
    const float* x0, const float* f0, const float* g0,
    const __nv_bfloat16* noise, const float* t1s, const float* dts,
    const __nv_bfloat16* W1f, const __nv_bfloat16* b1f,
    const __nv_bfloat16* W2f, const __nv_bfloat16* b2f,
    const __nv_bfloat16* W1g, const __nv_bfloat16* b1g,
    const __nv_bfloat16* W2g, const __nv_bfloat16* b2g, float* ys, float* zs,
    float* gs, int B, int S, int M, int m, int N, int threads, int device,
    cudaStream_t stream) {
  const __nv_bfloat16* w[8] = {W1f, b1f, W2f, b2f, W1g, b1g, W2g, b2g};
  return launch_gen_fwd(x0, f0, g0, noise, t1s, dts, w, ys, zs, gs, B, S, M,
                        m, N, threads, device, stream);
}

}  // extern "C"
