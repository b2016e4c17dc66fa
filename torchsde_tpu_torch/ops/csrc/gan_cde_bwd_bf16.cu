// Kernel 8, the reverse sweep of the SDE-GAN critic's neural CDE solve, in
// bf16 mixed mode, for Hopper (sm_90a) on bf16 tensor cores, bound to
// PyTorch through a plain C interface (ctypes). gan_cde_bwd.cu is the
// float32 kernel.
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/gan_fused.py:_cde_bwd_kernel
// with bf16 weights (launched by _cde_solve_bwd_impl): the reverse
// recurrence of gan_cde_bwd.cu, cotangents (ay, az, af) of the carry (h, z,
// f), for each step n from the last to the first, with z1 = zs[n]:
//   ay += ghs[n];  Af = af + dt/2 ay
//   recompute F = tower([t1, z1]) (S C outputs, F[i C + c])
//   dslopes[n][c] = sum_i Af[i] F[i][c];  dF[i][c] = Af[i] slope[c]
//   backpropagate dF through the tower: dz and every weight gradient
//   Az = az + dz;  ay += 2 Az;  az = -Az;  af = dt/2 ay + dt Az
// and at the end dh0 = ay + az, df0 = af. Mixed mode (the JAX package's
// _tower_fwd and _tower_bwd): the weights bf16, the rest float32; each
// product's inputs rounded to bf16 and nothing else ([t1, z1], a1, dpre2,
// dpre1); b1's and b2's sums on the unrounded cotangents; the weights'
// gradients summed in float32 over every row and step and rounded once by
// the caller.
//
// What bounds it. Per row and step it recomputes the tower and takes it
// back: 2,564 multiply-adds at S = 17, M = 16, C = 2, 0.66 GFLOP for 63
// steps over the critic's 2,048 rows (0.67 us at the bf16 peak); it reads
// zs, ghs and the slopes and writes dslopes, some 20 MB (6 us at 3.35
// TB/s). It is a chain of 63 dependent steps of small products; the
// float32-template design it replaces ran each dot product as a serial
// fmaf chain of 16 to 34 terms, one row a warp, and took 0.164 ms (NVIDIA
// H100 80GB HBM3, 700 W).
//
// Design (gan_bwd_bf16.cuh): eight rows a group of two warps, every
// product an mma.m16n8k16 (layers 1 and 2, the hidden cotangent, dz) or,
// for the weights' gradients, an mma.m16n8k8 whose k is the group's rows;
// the critic's 2,048 rows are 256 groups, 512 warps. The forward warp
// recomputes the tower one step ahead and hands it over in shared memory;
// the backward warp takes it back. The outputs are laid out channel by
// channel (o = c U + u), so a channel's outputs sit in the lanes as the
// state's cotangents do: dslopes is a sum over a lane's units, then over
// the warp's unit groups (three shuffles), and dF = Af slope needs no data
// from another lane. lipswish, its slope and tanh run on the accumulators'
// elements. The weights' A tiles are staged once a block; the weights'
// gradients stay in accumulator tiles for all 63 steps, and each group
// writes one partial, summed in a fixed order and rounded to bf16 by
// sum_partials_bf16, so two calls give the same bits at any block size.
// Each step's inputs are loaded two steps ahead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "gan_bwd_bf16.cuh"
#include "gan_fused_common.cuh"

namespace {

using namespace tsde_gan_bf16;

struct CdeBwdBf16Args {
  const float* slopes;             // (N, B, C)
  const float* t1s;                // (N,)
  const float* dts;                // (N,)
  const __nv_bfloat16* w[4];       // W1 b1 W2 b2
  const float* zs;                 // (N, B, S)
  const float* ghs;                // (N, B, S)
  float* dh0;                      // (B, S)
  float* df0;                      // (B, S)
  float* dslopes;                  // (N, B, C)
  float* partials;                 // (ceil(B / 8), P)
  int B, S, M, C, N, P;
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

// The backward warp's inputs of step s: ghs at its state elements and the
// slopes of its two rows (zeros off the batch or past C).
template <int UT, int CC>
struct CdeStep {
  float gh[UT][4], sl[CC][2];
};

template <int UT, int CC>
__device__ __forceinline__ void load_cde_step(const CdeBwdBf16Args& a, int s,
                                              int r0, int lane,
                                              const int (&off)[UT][4],
                                              CdeStep<UT, CC>& in) {
  load_state(a.ghs + size_t(s) * a.B * a.S, off, in.gh);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = r0 + 2 * (lane & 3) + e;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const bool on = row < a.B && c < a.C;
      in.sl[c][e] = ldg_early(
          a.slopes + (on ? (size_t(s) * a.B + row) * a.C + c : 0), on);
    }
  }
}

// CC channels, UT state tiles and HT hidden tiles at most (template
// parameters: every array of a lane has a compile-time size); the widths
// below them run on zero weights. A block holds whole row groups: warp 2g
// of the block is group g's forward warp, 2g + 1 its backward warp.
template <int CC, int UT, int HT>
__global__ void __launch_bounds__(tsde_gan::MAX_THREADS)
gan_cde_bwd_bf16(const CdeBwdBf16Args a) {
  constexpr int OT = CC * UT, WORDS = 2 * UT + step_words<HT, OT>();
  extern __shared__ __align__(16) uint32_t frag[];
  StageClocks clk;
  clk.start();
  const int tiles = op_first(4, UT, HT, OT);
  // The weights' raw copy goes where the row groups' slots will be.
  uint16_t* raw = reinterpret_cast<uint16_t*>(frag + tiles * 128);
  copy_raw(raw, a.w[0], (1 + a.S) * a.M, a.w[2], a.M * a.S * a.C);
  __syncthreads();
  stage_tower<UT, HT, OT>(frag, raw, a.S, a.M, a.C);
  __syncthreads();
  clk.mark(10);

  const int lane = threadIdx.x & 31;
  const int pair = threadIdx.x >> 6;        // the row group in the block
  const int group = blockIdx.x * (blockDim.x >> 6) + pair;
  const bool fwd = ((threadIdx.x >> 5) & 1) == 0;
  const int r0 = group * ROWS;
  // No block barrier follows: a group with no row of the batch is done;
  // rows past the end compute on zeros and store nothing.
  if (r0 >= a.B) return;
  uint32_t* slots = frag + tiles * 128 + pair * 2 * WORDS * 32;
  const int id = 1 + pair;

  Tower<UT, HT, OT> T;
  init_tower(T, frag, a.w, a.S, a.M, a.C, lane);
  clk.mark(11);
  int off[UT][4];
  state_offsets(a.B, a.S, r0, lane, off);
  const bool first = blockIdx.x == 0 && pair == 0;

  if (fwd) {
    // The towers at each step's z1, one step ahead of the backward warp.
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
      TowerStep<HT, OT> f;
      tower_forward(T, zb, t1r, lane, f.ab, f.sl1, f.F);
      clk.mark(1);
      const SlotLane slot{slots + (s & 1) * WORDS * 32 + lane};
      int w = 0;
      put_z(slot, w, zb);
      put_step(slot, w, f);
      clk.mark(3);
      group_sync(id, 64);
      clk.mark(4);
    }
    clk.flush(threadIdx.x >> 5, first, lane);
    return;
  }

  float ay[UT][4], az[UT][4], af[UT][4];
#pragma unroll
  for (int t = 0; t < UT; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) ay[t][i] = az[t][i] = af[t][i] = 0.f;
  }
  // Each step's inputs two steps ahead (next, then next2).
  CdeStep<UT, CC> next, next2;
  load_cde_step(a, a.N - 1, r0, lane, off, next);
  load_cde_step(a, a.N > 1 ? a.N - 2 : 0, r0, lane, off, next2);
  float dt_next = __ldg(a.dts + a.N - 1), t1_next = __ldg(a.t1s + a.N - 1);
  float dt_next2 = __ldg(a.dts + (a.N > 1 ? a.N - 2 : 0));
  float t1_next2 = __ldg(a.t1s + (a.N > 1 ? a.N - 2 : 0));
  clk.mark(8);
  for (int s = a.N - 1; s >= 0; --s) {
    const CdeStep<UT, CC> in = next;
    const float dt = dt_next, t1r = __bfloat162float(__float2bfloat16_rn(
                                  t1_next));
    next = next2;
    dt_next = dt_next2;
    t1_next = t1_next2;
    if (s > 1) {
      load_cde_step(a, s - 2, r0, lane, off, next2);
      dt_next2 = ldg_early(a.dts + s - 2, true);
      t1_next2 = ldg_early(a.t1s + s - 2, true);
    }

    float Af[UT][4];
#pragma unroll
    for (int t = 0; t < UT; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ay[t][i] += in.gh[t][i];
        Af[t][i] = af[t][i] + 0.5f * dt * ay[t][i];
      }
    }
    clk.mark(0);

    group_sync(id, 64);
    clk.mark(1);
    const SlotLane slot{slots + (s & 1) * WORDS * 32 + lane};
    uint32_t zb[UT][2];
    TowerStep<HT, OT> f;
    int w = 0;
    get_z(slot, w, zb);
    get_step(slot, w, f);

    // dslopes[c] of each row: Af . F over the lane's units, then over the
    // warp's unit groups; dpre2 = Af slope (1 - F^2).
    float dp2[OT][4];
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      float ds[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < UT; ++t) {
        const int o = c * UT + t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float F = f.F[o][i];
          ds[i & 1] = fmaf(Af[t][i], F, ds[i & 1]);
          dp2[o][i] = Af[t][i] * in.sl[c][i & 1] * (1.f - F * F);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ds[e] = units_sum(ds[e]);
        const int row = r0 + 2 * (lane & 3) + e;
        if (lane < 4 && c < a.C && row < a.B)
          a.dslopes[(size_t(s) * a.B + row) * a.C + c] = ds[e];
      }
    }

    float dz[UT][4];
#pragma unroll
    for (int t = 0; t < UT; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dz[t][i] = 0.f;
    }
    clk.mark(2);
    tower_backward(T, dp2, f.ab, zb, f.sl1, t1r, lane, dz);
    clk.mark(3);

#pragma unroll
    for (int t = 0; t < UT; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float Az = az[t][i] + dz[t][i];
        af[t][i] = 0.5f * dt * ay[t][i] + dt * Az;
        ay[t][i] += 2.f * Az;
        az[t][i] = -Az;
      }
    }
    clk.mark(6);
  }

#pragma unroll
  for (int t = 0; t < UT; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (off[t][i] >= 0) {
        a.dh0[off[t][i]] = ay[t][i] + az[t][i];
        a.df0[off[t][i]] = af[t][i];
      }
    }
  }
  write_tower_partial(T, a.partials + size_t(group) * a.P, a.S, a.M, a.C,
                      lane);
  clk.mark(9);
  clk.flush(threadIdx.x >> 5, first, lane);
}

using CdeBwdBf16Kernel = void (*)(CdeBwdBf16Args);

// The instantiation for these widths, by (channels, state tiles, hidden
// tiles) it holds: the state's and the hidden units' tiles as the widths
// need them (one to 16 units, two to 32), the channels rounded up to 2, 4
// or 8. A lane's accumulators grow with the product of the three (the
// output tiles times the hidden tiles), so a narrower width never runs
// the widest's instantiation, which spills (the JAX bf16 test's widths,
// S, M <= 16, C <= 2, run <2, 1, 1>, the reference's <2, 2, 1>).
struct CdeBf16Design {
  CdeBwdBf16Kernel kernel;
  int CC, UT, HT;
};

template <int CC>
CdeBf16Design cde_bf16_tiles(int UT, int HT) {
  if (UT == 1)
    return HT == 1 ? CdeBf16Design{gan_cde_bwd_bf16<CC, 1, 1>, CC, 1, 1}
                   : CdeBf16Design{gan_cde_bwd_bf16<CC, 1, 2>, CC, 1, 2};
  return HT == 1 ? CdeBf16Design{gan_cde_bwd_bf16<CC, 2, 1>, CC, 2, 1}
                 : CdeBf16Design{gan_cde_bwd_bf16<CC, 2, 2>, CC, 2, 2};
}

CdeBf16Design cde_bf16_design(int S, int M, int C) {
  const int UT = S <= 16 ? 1 : 2, HT = M <= 16 ? 1 : 2;
  return C <= 2   ? cde_bf16_tiles<2>(UT, HT)
         : C <= 4 ? cde_bf16_tiles<4>(UT, HT)
                  : cde_bf16_tiles<8>(UT, HT);
}

// The staged tiles, then each row group's two slots (the weights' raw copy
// before the step loop).
size_t cde_bf16_smem_bytes(int S, int M, int C, int groups) {
  const CdeBf16Design d = cde_bf16_design(S, M, C);
  const int OT = d.CC * d.UT;
  const int words = 2 * d.UT + 2 * d.HT + 4 * d.HT + 4 * OT;
  const size_t slots = size_t(groups) * 2 * words * 32 * 4;
  const size_t raw = raw_bytes(S, M, C);
  return size_t(op_first(4, d.UT, d.HT, OT)) * 128 * 4
         + (slots > raw ? slots : raw);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the bf16 sweep needs for these widths
// at `threads` threads a block at most: its staged weight tiles and two
// slots a row group of two warps (64 threads).
size_t tsde_gan_cde_bwd_smem_bytes_bf16(int S, int M, int C, int threads) {
  return cde_bf16_smem_bytes(S, M, C, threads < 64 ? 1 : threads / 64);
}

#if defined(TSDE_GAN_CLOCKS)
// The stage clocks' sums (64 counters), then zeroed.
int tsde_gan_cde_bwd_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, tsde_gan_clocks,
                                         sizeof(tsde_gan_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[64] = {};
  return static_cast<int>(cudaMemcpyToSymbol(tsde_gan_clocks, zero,
                                             sizeof zero));
}
#endif

// The instantiation the bf16 sweep runs for these widths, as 100 CC + 10
// UT + HT (channels, state and hidden tiles it holds).
int tsde_gan_cde_bwd_design_bf16(int S, int M, int C) {
  const CdeBf16Design d = cde_bf16_design(S, M, C);
  return 100 * d.CC + 10 * d.UT + d.HT;
}

// Weight-gradient partials of either bf16 backward kernel for a batch of
// B rows: one a group of 8 rows.
int tsde_gan_bwd_partials_bf16(int B) { return (B + ROWS - 1) / ROWS; }

// bf16 mixed mode: the weights bf16, the rest float32 but dw, the
// weights' gradients summed in float32 and rounded to bf16 once.
// Launches the sweep (at most `threads` threads a block, at least one row
// group's 64) and the sum of its partials on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for widths
// beyond the kernel's limits (S, M <= 32, C <= 8, threads a multiple of
// 32 up to 256). partials holds
// tsde_gan_bwd_partials_bf16(B) x P floats, P the weights' total element
// count; dw receives their gradients back to back.
int tsde_gan_cde_bwd_bf16(const float* slopes, const float* t1s,
                          const float* dts, const __nv_bfloat16* W1,
                          const __nv_bfloat16* b1, const __nv_bfloat16* W2,
                          const __nv_bfloat16* b2, const float* zs,
                          const float* ghs, float* dh0, float* df0,
                          float* dslopes, float* partials,
                          __nv_bfloat16* dw, int B,
                          int S, int M, int C, int N, int threads, int device,
                          cudaStream_t stream) {
  if (S < 1 || S > tsde_gan::MAX_LANES || M < 1 ||
      M > tsde_gan::MAX_LANES || C < 1 || C > tsde_gan::MAX_K ||
      threads < 32 || threads > tsde_gan::MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  CdeBwdBf16Args a;
  a.slopes = slopes; a.t1s = t1s; a.dts = dts;
  a.w[0] = W1; a.w[1] = b1; a.w[2] = W2; a.w[3] = b2;
  a.zs = zs; a.ghs = ghs;
  a.dh0 = dh0; a.df0 = df0; a.dslopes = dslopes; a.partials = partials;
  a.B = B; a.S = S; a.M = M; a.C = C; a.N = N;
  a.P = (1 + S) * M + M + M * S * C + S * C;
  const CdeBf16Design d = cde_bf16_design(S, M, C);
  const int groups = tsde_gan_bwd_partials_bf16(B);
  const int per = groups_per_block(groups, 2, threads, device);
  const size_t smem = cde_bf16_smem_bytes(S, M, C, per);
  err = cudaFuncSetAttribute(d.kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  d.kernel<<<(groups + per - 1) / per, 64 * per, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sum_partials_bf16(partials, groups, a.P,
                                                   dw, stream));
}

}  // extern "C"
