// Kernel 6, the reverse sweep of the SDE-GAN generator's whole solve, in
// bf16 mixed mode, for Hopper (sm_90a) on bf16 tensor cores, bound to
// PyTorch through a plain C interface (ctypes). gan_gen_bwd.cu (over
// gan_gen_bwd.cuh) is the float32 kernel.
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/gan_fused.py:_gen_bwd_kernel
// with bf16 weights and noise (launched by _gen_solve_bwd_impl): the
// reverse recurrence of reversible Heun (gan_gen_bwd.cuh), cotangents (ay,
// az, af, ag) of the carry (x, z, f, g), for each step n from the last to
// the first, with z1 = zs[n], g1 = gs[n] (g_{n+1}) and g0 = gs[n-1] (g_n;
// the input g0 at n = 0):
//   ay += gy[n];  Af = af + dt/2 ay;  Ag = ag + outer(ay, dW/2)
//   recompute both towers at [t1, z1]; backpropagate Af through the drift
//   tower and Ag through the diffusion tower: dz and every weight gradient
//   Az = az + dz;  dnoise[n] = Az . g0 + (ay/2) . (g0 + g1)
//   ay += 2 Az;  az = -Az;  af = dt/2 ay + dt Az;  ag = outer(ay/2 + Az, dW)
// and at the end dx0 = ay + az, df0 = af, dg0 = ag. Mixed mode (the JAX
// package's _tower_fwd and _tower_bwd): the weights and the noise bf16,
// the rest float32; each product's inputs rounded to bf16 and nothing else
// ([t1, z1], the hidden activations, dpre2, dpre1); b1's and b2's sums on
// the unrounded cotangents; the weights' gradients summed in float32 over
// every row and step and rounded once by the caller; dnoise each step's
// float32 sum rounded to bf16 once.
//
// What bounds it. Per row and step it recomputes both towers and takes
// them back: 4,896 multiply-adds at S = M = 16, m = 3, 0.63 GFLOP for 63
// steps at B = 1,024 (0.64 us at the bf16 peak); it reads zs, gy, gs and
// the noise and writes dnoise, some 22 MB at these dtypes (6.6 us at 3.35
// TB/s). It is a chain of 63 dependent steps of small products; the
// float32-template design it replaces ran each dot product as a serial
// fmaf chain, two rows a warp at 244 registers a lane, and took 0.119 ms
// (NVIDIA H100 80GB HBM3, 700 W).
//
// Design (gan_bwd_bf16.cuh): eight rows a group of three warps, every
// product an mma.m16n8k16 or, for the weights' gradients, an mma.m16n8k8
// whose k is the group's rows; the generator's 1,024 rows are 128 groups,
// 384 warps. The forward warp recomputes both towers one step ahead and
// hands them over in shared memory; one backward warp takes the drift
// back and the other the diffusion, and they swap their dz each step. A
// group of two warps, both towers' backward in one, took 0.1085 ms at the
// reference (NVIDIA H100 80GB HBM3, 700 W): the backward warp's step, some
// 460 instructions against the forward's 280, set the pace. The
// diffusion's outputs are laid out channel by channel (o = j U + u), so
// Ag, dpre2 and the noise terms need no data from another lane; dnoise is
// a sum over a lane's units, then over the warp's unit groups (three
// shuffles), rounded to bf16 once. The weights' A tiles of both towers are
// staged once a block; the weights' gradients stay in accumulator tiles
// for all 63 steps, and each group writes one partial, summed in a fixed
// order and rounded to bf16 by sum_partials_bf16, so two calls give the
// same bits at any block size. Each step's inputs (z1, gy, g_n, the
// noise) are loaded two steps ahead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "gan_bwd_bf16.cuh"
#include "gan_fused_common.cuh"

namespace {

using namespace tsde_gan_bf16;

struct GenBwdBf16Args {
  const float* g0;                 // (B, S*m)
  const __nv_bfloat16* noise;      // (N, B, m)
  const float* t1s;                // (N,)
  const float* dts;                // (N,)
  const __nv_bfloat16* w[8];       // W1f b1f W2f b2f W1g b1g W2g b2g
  const float* zs;                 // (N, B, S)
  const float* gs;                 // (N, B, S*m)
  const float* gy;                 // (N, B, S)
  float* dx0;                      // (B, S)
  float* df0;                      // (B, S)
  float* dg0;                      // (B, S*m)
  __nv_bfloat16* dnoise;           // (N, B, m)
  float* partials;                 // (ceil(B / 8), P)
  int B, S, M, m, N, P;
};

// Where a lane's state elements sit in a step's (B, S) slab: row r0 +
// elem_row, unit elem_unit; -1 off the batch or past S.
template <int UT>
__device__ __forceinline__ void state_offsets(int B, int S, int r0,
                                              int lane, int (&off)[UT][4]) {
#pragma unroll
  for (int t = 0; t < UT; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = elem_unit(lane, t, i), row = r0 + elem_row(lane, i);
      off[t][i] = u < S && row < B ? row * S + u : -1;
    }
  }
}

// A (B, S) slab's values at a lane's state elements, zeros at -1.
template <int UT>
__device__ __forceinline__ void load_state(const float* slab,
                                           const int (&off)[UT][4],
                                           float (&v)[UT][4]) {
#pragma unroll
  for (int t = 0; t < UT; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[t][i] = ldg_early(slab + (off[t][i] >= 0 ? off[t][i] : 0),
                          off[t][i] >= 0);
  }
}

// g_n of a lane's state elements and channels j < m (gs[s - 1], or g0 at
// s = 0), zeros past m or at -1.
template <int UT, int K>
__device__ __forceinline__ void load_g(const GenBwdBf16Args& a, int s,
                                       const int (&off)[UT][4],
                                       float (&g)[K][UT][4]) {
  const float* slab = s > 0 ? a.gs + size_t(s - 1) * a.B * a.S * a.m : a.g0;
#pragma unroll
  for (int t = 0; t < UT; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool on = off[t][i] >= 0 && j < a.m;
        g[j][t][i] = ldg_early(slab + (on ? size_t(off[t][i]) * a.m + j : 0),
                               on);
      }
    }
  }
}

// The noise of a lane's two rows at step s, zeros off the batch or past m.
template <int K>
__device__ __forceinline__ void load_noise(const GenBwdBf16Args& a, int s,
                                           int r0, int lane,
                                           float (&dW)[K][2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = r0 + 2 * (lane & 3) + e;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool on = row < a.B && j < a.m;
      dW[j][e] = ldg_early(
          a.noise + (on ? (size_t(s) * a.B + row) * a.m + j : 0), on);
    }
  }
}

// A backward warp's inputs of step s: gy at its state elements, and g_n
// (the drift's warp, for dnoise) or the noise of its two rows (the
// diffusion's).
template <int UT, int K>
struct GenStep {
  float gy[UT][4], dW[K][2], gp[K][UT][4];
};

template <int UT, int K>
__device__ __forceinline__ void load_gen_step(const GenBwdBf16Args& a, int s,
                                              int r0, int lane,
                                              const int (&off)[UT][4],
                                              bool drift,
                                              GenStep<UT, K>& in) {
  load_state(a.gy + size_t(s) * a.B * a.S, off, in.gy);
  if (drift)
    load_g(a, s, off, in.gp);
  else
    load_noise(a, s, r0, lane, in.dW);
}

// K noise channels, UT state tiles and HT hidden tiles at most (template
// parameters: every array of a lane has a compile-time size); the widths
// below them run on zero weights. A block holds whole row groups of three
// warps: 3g is group g's forward warp (both towers at z1), 3g + 1 takes
// the drift back and writes dnoise, dx0 and df0, 3g + 2 takes the
// diffusion back and writes dg0. The two backward warps swap their dz at
// a barrier of their own and carry the same ay and az.
template <int K, int UT, int HT>
__global__ void __launch_bounds__(tsde_gan::MAX_THREADS)
gan_gen_bwd_bf16(const GenBwdBf16Args a) {
  constexpr int OG = K * UT;
  constexpr int FWORDS = 2 * UT + step_words<HT, UT>();
  constexpr int WORDS = FWORDS + step_words<HT, OG>();
  constexpr int XWORDS = 4 * UT;                  // a dz tile of the state
  extern __shared__ __align__(16) uint32_t frag[];
  StageClocks clk;
  clk.start();
  const int tiles_f = op_first(4, UT, HT, UT);
  uint32_t* frag_g = frag + tiles_f * 128;
  // Both towers' raw copies go where the row groups' slots will be.
  uint16_t* raw_f =
      reinterpret_cast<uint16_t*>(frag_g + op_first(4, UT, HT, OG) * 128);
  uint16_t* raw_g = raw_f + raw_bytes(a.S, a.M, 1) / 2;
  copy_raw(raw_f, a.w[0], (1 + a.S) * a.M, a.w[2], a.M * a.S);
  copy_raw(raw_g, a.w[4], (1 + a.S) * a.M, a.w[6], a.M * a.S * a.m);
  __syncthreads();
  stage_tower<UT, HT, UT>(frag, raw_f, a.S, a.M, 1);
  stage_tower<UT, HT, OG>(frag_g, raw_g, a.S, a.M, a.m);
  __syncthreads();
  clk.mark(10);

  const int lane = threadIdx.x & 31;
  const int pair = threadIdx.x / 96;        // the row group in the block
  const int role = (threadIdx.x >> 5) % 3;
  const int group = blockIdx.x * (blockDim.x / 96) + pair;
  const int r0 = group * ROWS;
  // No block barrier follows: a group with no row of the batch is done;
  // rows past the end compute on zeros and store nothing.
  if (r0 >= a.B) return;
  uint32_t* slots = frag_g + op_first(4, UT, HT, OG) * 128
                    + pair * 2 * (WORDS + 2 * XWORDS) * 32;
  uint32_t* xchg = slots + 2 * WORDS * 32;
  const int id_step = 1 + 2 * pair, id_swap = 2 + 2 * pair;

  Tower<UT, HT, UT> Tf;
  Tower<UT, HT, OG> Tg;
  init_tower(Tf, frag, a.w, a.S, a.M, 1, lane);
  init_tower(Tg, frag_g, a.w + 4, a.S, a.M, a.m, lane);
  clk.mark(11);
  int off[UT][4];
  state_offsets(a.B, a.S, r0, lane, off);
  const bool first = blockIdx.x == 0 && pair == 0;

  if (role == 0) {
    // Both towers at each step's z1, one step ahead of the backward warps.
    // z1 and t1 two steps ahead (z, then z2): a load of the step after
    // next has a whole step to land.
    float z[UT][4], z2[UT][4];
    load_state(a.zs + size_t(a.N - 1) * a.B * a.S, off, z);
    load_state(a.zs + size_t(a.N > 1 ? a.N - 2 : 0) * a.B * a.S, off, z2);
    float t1_next = __ldg(a.t1s + a.N - 1);
    float t1_next2 = __ldg(a.t1s + (a.N > 1 ? a.N - 2 : 0));
    clk.mark(8);
    for (int s = a.N - 1; s >= 0; --s) {
      uint32_t zb[UT][2];
      pack_tiles(z, zb);
      const float t1r = __bfloat162float(__float2bfloat16_rn(t1_next));
#pragma unroll
      for (int t = 0; t < UT; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) z[t][i] = z2[t][i];
      }
      t1_next = t1_next2;
      if (s > 1) {
        load_state(a.zs + size_t(s - 2) * a.B * a.S, off, z2);
        t1_next2 = ldg_early(a.t1s + s - 2, true);
      }
      clk.mark(0);
      TowerStep<HT, UT> ff;
      TowerStep<HT, OG> fg;
      tower_forward(Tf, zb, t1r, lane, ff.ab, ff.sl1, ff.F);
      clk.mark(1);
      tower_forward(Tg, zb, t1r, lane, fg.ab, fg.sl1, fg.F);
      clk.mark(2);
      const SlotLane slot{slots + (s & 1) * WORDS * 32 + lane};
      int w = 0;
      put_z(slot, w, zb);
      put_step(slot, w, ff);
      put_step(slot, w, fg);
      clk.mark(3);
      group_sync(id_step, 96);
      clk.mark(4);
    }
    clk.flush(threadIdx.x >> 5, first, lane);
    return;
  }

  const bool drift = role == 1;
  // Cotangents of the lane's state elements (both backward warps carry ay
  // and az alike), the drift warp's af and g_{n+1}, the diffusion warp's
  // ag.
  float ay[UT][4], az[UT][4], af[UT][4], ag[K][UT][4], gn[K][UT][4];
#pragma unroll
  for (int t = 0; t < UT; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ay[t][i] = az[t][i] = af[t][i] = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) ag[j][t][i] = 0.f;
    }
  }
  if (drift) load_g(a, a.N, off, gn);

  // Each step's inputs two steps ahead (next, then next2).
  GenStep<UT, K> next, next2;
  load_gen_step(a, a.N - 1, r0, lane, off, drift, next);
  load_gen_step(a, a.N > 1 ? a.N - 2 : 0, r0, lane, off, drift, next2);
  float dt_next = __ldg(a.dts + a.N - 1), t1_next = __ldg(a.t1s + a.N - 1);
  float dt_next2 = __ldg(a.dts + (a.N > 1 ? a.N - 2 : 0));
  float t1_next2 = __ldg(a.t1s + (a.N > 1 ? a.N - 2 : 0));
  clk.mark(8);
  for (int s = a.N - 1; s >= 0; --s) {
    const GenStep<UT, K> in = next;
    const float dt = dt_next, t1r = __bfloat162float(__float2bfloat16_rn(
                                  t1_next));
    next = next2;
    dt_next = dt_next2;
    t1_next = t1_next2;
    if (s > 1) {
      load_gen_step(a, s - 2, r0, lane, off, drift, next2);
      dt_next2 = ldg_early(a.dts + s - 2, true);
      t1_next2 = ldg_early(a.t1s + s - 2, true);
    }
#pragma unroll
    for (int t = 0; t < UT; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) ay[t][i] += in.gy[t][i];
    }
    clk.mark(0);

    group_sync(id_step, 96);
    clk.mark(1);
    const SlotLane slot{slots + (s & 1) * WORDS * 32 + lane};
    uint32_t zb[UT][2];
    int w = 0;
    get_z(slot, w, zb);
    float dz[UT][4];
#pragma unroll
    for (int t = 0; t < UT; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dz[t][i] = 0.f;
    }
    if (drift) {
      // The drift's outputs' cotangent Af, taken back through its tower.
      TowerStep<HT, UT> ff;
      get_step(slot, w, ff);
      float dpf[UT][4];
#pragma unroll
      for (int t = 0; t < UT; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float Af = af[t][i] + 0.5f * dt * ay[t][i];
          dpf[t][i] = Af * (1.f - ff.F[t][i] * ff.F[t][i]);
        }
      }
      clk.mark(2);
      tower_backward(Tf, dpf, ff.ab, zb, ff.sl1, t1r, lane, dz);
    } else {
      // The diffusion's, Ag = ag + outer(ay, dW / 2).
      TowerStep<HT, OG> fg;
      w = FWORDS;
      get_step(slot, w, fg);
      float dpg[OG][4];
#pragma unroll
      for (int t = 0; t < UT; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float Ag = ag[j][t][i] + 0.5f * ay[t][i] * in.dW[j][i & 1];
            const float out = fg.F[j * UT + t][i];
            dpg[j * UT + t][i] = Ag * (1.f - out * out);
          }
        }
      }
      clk.mark(2);
      tower_backward(Tg, dpg, fg.ab, zb, fg.sl1, t1r, lane, dz);
    }
    clk.mark(3);

    // The towers' dz swapped: Az = az + (dz_f + dz_g) in both warps.
    uint32_t* x = xchg + (s & 1) * 2 * XWORDS * 32 + lane;
    const SlotLane mine{x + (drift ? 0 : XWORDS * 32)};
    const SlotLane theirs{x + (drift ? XWORDS * 32 : 0)};
#pragma unroll
    for (int t = 0; t < UT; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mine.put(4 * t + i, __float_as_uint(dz[t][i]));
    }
    group_sync(id_swap, 64);
    clk.mark(4);
    float Az[UT][4];
#pragma unroll
    for (int t = 0; t < UT; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float other = __uint_as_float(theirs.get(4 * t + i));
        Az[t][i] = az[t][i] + (drift ? dz[t][i] + other : other + dz[t][i]);
      }
    }

    clk.mark(5);
    if (drift) {
      // dnoise[s][row][j] = sum over units of Az g_n + ay/2 (g_n +
      // g_{n+1}), over the lane's units, then the warp's unit groups; lane
      // 4 g + q stores the (row 2q + e, channel j) with 2j + e = g (mod 8).
#pragma unroll
      for (int j = 0; j < K; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float dn = 0.f;
#pragma unroll
          for (int t = 0; t < UT; ++t) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 2 * h + e;
              dn = fmaf(Az[t][i], in.gp[j][t][i], dn);
              dn = fmaf(0.5f * ay[t][i], in.gp[j][t][i] + gn[j][t][i], dn);
            }
          }
          dn = units_sum(dn);
          const int row = r0 + 2 * (lane & 3) + e;
          if ((lane >> 2) == ((2 * j + e) & 7) && j < a.m && row < a.B)
            a.dnoise[(size_t(s) * a.B + row) * a.m + j] =
                __float2bfloat16_rn(dn);
        }
      }
    }

#pragma unroll
    for (int t = 0; t < UT; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (drift) {
          af[t][i] = 0.5f * dt * ay[t][i] + dt * Az[t][i];
#pragma unroll
          for (int j = 0; j < K; ++j) gn[j][t][i] = in.gp[j][t][i];
        } else {
#pragma unroll
          for (int j = 0; j < K; ++j)
            ag[j][t][i] = (0.5f * ay[t][i] + Az[t][i]) * in.dW[j][i & 1];
        }
        ay[t][i] += 2.f * Az[t][i];
        az[t][i] = -Az[t][i];
      }
    }
    clk.mark(6);
  }

  float* p = a.partials + size_t(group) * a.P;
#pragma unroll
  for (int t = 0; t < UT; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (off[t][i] < 0) continue;
      if (drift) {
        a.dx0[off[t][i]] = ay[t][i] + az[t][i];
        a.df0[off[t][i]] = af[t][i];
      } else {
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (j < a.m) a.dg0[size_t(off[t][i]) * a.m + j] = ag[j][t][i];
      }
    }
  }
  if (drift)
    write_tower_partial(Tf, p, a.S, a.M, 1, lane);
  else
    write_tower_partial(Tg, p + (1 + a.S) * a.M + a.M + a.M * a.S + a.S,
                        a.S, a.M, a.m, lane);
  clk.mark(9);
  clk.flush(threadIdx.x >> 5, first, lane);
}

using GenBwdBf16Kernel = void (*)(GenBwdBf16Args);

// The instantiation for these widths, by (noise channels, state tiles,
// hidden tiles) it holds: the state's and the hidden units' tiles as the
// widths need them (one to 16 units, two to 32), the channels 3 or 8. A
// lane's accumulators grow with the product of the three, so a narrower
// width never runs the widest's instantiation, which spills (the
// reference widths, S, M <= 16, m <= 3, run <3, 1, 1>).
struct GenBf16Design {
  GenBwdBf16Kernel kernel;
  int K, UT, HT;
};

template <int K>
GenBf16Design gen_bf16_tiles(int UT, int HT) {
  if (UT == 1)
    return HT == 1 ? GenBf16Design{gan_gen_bwd_bf16<K, 1, 1>, K, 1, 1}
                   : GenBf16Design{gan_gen_bwd_bf16<K, 1, 2>, K, 1, 2};
  return HT == 1 ? GenBf16Design{gan_gen_bwd_bf16<K, 2, 1>, K, 2, 1}
                 : GenBf16Design{gan_gen_bwd_bf16<K, 2, 2>, K, 2, 2};
}

GenBf16Design gen_bf16_design(int S, int M, int m) {
  const int UT = S <= 16 ? 1 : 2, HT = M <= 16 ? 1 : 2;
  return m <= 3 ? gen_bf16_tiles<3>(UT, HT) : gen_bf16_tiles<8>(UT, HT);
}

// Both towers' staged tiles, then each row group's two slots and two
// pairs of dz tiles (the towers' raw copies before the step loop).
size_t gen_bf16_smem_bytes(int S, int M, int m, int groups) {
  const GenBf16Design d = gen_bf16_design(S, M, m);
  const int OG = d.K * d.UT;
  const int words = 2 * d.UT + 6 * d.HT + 4 * d.UT + 6 * d.HT + 4 * OG
                    + 2 * 4 * d.UT;
  const size_t slots = size_t(groups) * 2 * words * 32 * 4;
  const size_t raw = raw_bytes(S, M, 1) + raw_bytes(S, M, m);
  return size_t(op_first(4, d.UT, d.HT, d.UT) + op_first(4, d.UT, d.HT, OG))
             * 128 * 4
         + (slots > raw ? slots : raw);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the bf16 sweep needs for these widths
// at `threads` threads a block at most: both towers' staged weight tiles
// and the slots of each row group of three warps (96 threads).
size_t tsde_gan_gen_bwd_smem_bytes_bf16(int S, int M, int m, int threads) {
  return gen_bf16_smem_bytes(S, M, m, threads < 96 ? 1 : threads / 96);
}

#if defined(TSDE_GAN_CLOCKS)
// The stage clocks' sums (64 counters), then zeroed.
int tsde_gan_gen_bwd_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, tsde_gan_clocks,
                                         sizeof(tsde_gan_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[64] = {};
  return static_cast<int>(cudaMemcpyToSymbol(tsde_gan_clocks, zero,
                                             sizeof zero));
}
#endif

// The instantiation the bf16 sweep runs for these widths, as 100 K + 10 UT
// + HT (noise channels, state and hidden tiles it holds).
int tsde_gan_gen_bwd_design_bf16(int S, int M, int m) {
  const GenBf16Design d = gen_bf16_design(S, M, m);
  return 100 * d.K + 10 * d.UT + d.HT;
}

// bf16 mixed mode: the noise, the weights and dnoise bf16, the rest
// float32 but dw, the weights' gradients summed in float32 (the partials)
// and rounded to bf16 once. Launches the sweep (at most `threads`
// threads a block, at least one row group's 96) and the sum of its
// partials on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for widths beyond the kernel's limits (S, M <= 32,
// m <= 8, threads a multiple of 32 up to 256). partials holds
// tsde_gan_bwd_partials_bf16(B) x P floats, P the weights' total element
// count; dw receives their gradients back to back in
// gan_fused.GEN_WEIGHT_NAMES order.
int tsde_gan_gen_bwd_bf16(
    const float* g0, const __nv_bfloat16* noise, const float* t1s,
    const float* dts, const __nv_bfloat16* W1f, const __nv_bfloat16* b1f,
    const __nv_bfloat16* W2f, const __nv_bfloat16* b2f,
    const __nv_bfloat16* W1g, const __nv_bfloat16* b1g,
    const __nv_bfloat16* W2g, const __nv_bfloat16* b2g, const float* zs,
    const float* gs, const float* gy, float* dx0, float* df0, float* dg0,
    __nv_bfloat16* dnoise, float* partials, __nv_bfloat16* dw, int B,
    int S, int M,
    int m, int N, int threads, int device, cudaStream_t stream) {
  if (S < 1 || S > tsde_gan::MAX_LANES || M < 1 ||
      M > tsde_gan::MAX_LANES || m < 1 || m > tsde_gan::MAX_K ||
      threads < 32 || threads > tsde_gan::MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  GenBwdBf16Args a;
  a.g0 = g0; a.noise = noise; a.t1s = t1s; a.dts = dts;
  const __nv_bfloat16* w[8] = {W1f, b1f, W2f, b2f, W1g, b1g, W2g, b2g};
  for (int i = 0; i < 8; ++i) a.w[i] = w[i];
  a.zs = zs; a.gs = gs; a.gy = gy;
  a.dx0 = dx0; a.df0 = df0; a.dg0 = dg0; a.dnoise = dnoise;
  a.partials = partials;
  a.B = B; a.S = S; a.M = M; a.m = m; a.N = N;
  a.P = 2 * (1 + S) * M + 2 * M + M * S * (1 + m) + S * (1 + m);
  const GenBf16Design d = gen_bf16_design(S, M, m);
  const int groups = (B + ROWS - 1) / ROWS;
  const int per = groups_per_block(groups, 3, threads, device);
  const size_t smem = gen_bf16_smem_bytes(S, M, m, per);
  err = cudaFuncSetAttribute(d.kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  d.kernel<<<(groups + per - 1) / per, 96 * per, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sum_partials_bf16(partials, groups, a.P,
                                                   dw, stream));
}

}  // extern "C"
