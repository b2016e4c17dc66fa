// Reverse sweep of the latent-SDE logqp Euler-Maruyama whole solve, for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/latent_fused.py:_bwd_kernel
// (with _backward_core), launched by _fused_solve_bwd_impl. For each step s
// from the last to the first, with z the pre-step state (z0 or zs[s-1]) and
// ginc the reverse cumulative sum of the logqp cotangents gq:
//   recompute f, h, g, u from z as latent_fused_fwd.cu does;
//   dz += gz[s];  dnoise[s] = dz * g;  du = ginc * u * dt
//   df = dz * dt + du / gs;  dh = -du / gs
//   dg = dz * dW - (du * u / gs) * [g > 1e-7]   (only the u-path is masked)
// then backpropagate df, dh through the two softplus towers and dg through
// the per-dimension sigmoid nets (softplus' = 1 - exp(-softplus)), add every
// weight gradient, scatter the context cotangent into dctx[ctx_idx[s]], and
// carry dz += dx[:, :L] to the step before.
//
// What bounds it. Per batch row and step the work is the forward recomputed
// (44,032 multiply-adds at L=4, C=64, H=128), the input cotangents going
// back (44,032) and the weight gradients (44,032): 34.6 GFLOP for a solve at
// B=1024 and 128 steps, 0.52 ms at the float32 peak. Only the first two sit
// on the chain of dependent steps; the weight gradients are sums over all
// rows and steps that no later step needs.
//
// Design: two phases on one stream.
//
// 1. The sweep (latent_bwd_sweep, SWEEP_THREADS threads a block): only the
//    step-to-step chain. The batch is cut into tiles of R = 8 rows, one block
//    each (128 blocks at B=1024: one wave on 132 SMs), and each block sweeps
//    the steps backwards with its weights (45,068 floats at the flagship) in
//    shared memory. Half the threads take the drift tower f, half the prior
//    tower h, a hidden unit each (strided beyond); the h half also takes the
//    g nets' forward, and each half half of their backward. Sums over hidden
//    units (the L outputs of layer 3 and of the g nets, their z-cotangents)
//    are warp shuffles, then per-warp sums in shared memory; the input
//    cotangent dx = dpre1 W1^T splits the hidden units into JP parts, so most
//    threads take a share. Once a step has read its inputs for the last
//    time, the step before's (pre-step z and context rows, noise, gz, gq)
//    start to arrive by cp.async while the step's last two stages compute.
//    Each step the sweep writes, for its rows, the scratch
//    tensors whose products give the layer weights' gradients: a1 and a2 of
//    both towers, their pre-activation cotangents dpre1 and dpre2 (each
//    (n,B,H)) and df, dh (each (n,B,L)): 537 MB at the flagship and K = 1,
//    2.15 GB at K = 4, K x n x B x (8H + 2L) floats in all. The g nets'
//    gradients (3LH + L floats) are summed on chip in shared memory, each
//    element by one thread, and added to the block's row of the partials
//    every FLUSH steps; their weights are read through L1, which leaves
//    the sweep's shared memory within 448 bytes of the former one's at
//    every shape whose context is at most twice as wide as its hidden
//    layer. There are no per-step writes of gradient partials to device
//    memory.
//
// 2. The contraction: the layer weights' gradients as products over all
//    M = n x B rows. fw2 = a1f^T dpre2f and hw2 (the H x H products) and the
//    context rows of fw1 = ctx[ctx_idx]^T dpre1f (the context gathered on
//    the fly, not stored) go to latent_bwd_contract: 64 x 128 output tiles
//    of 256 threads (4 x 8 a thread), 16-row slabs of both operands
//    double-buffered in shared memory by cp.async. The products with an
//    L-wide side (fw1's z rows and hw1 from z_pre gathered from z0 and zs;
//    fw3 = a2f^T df, hw3) are bound by the bytes they read and go to
//    latent_bwd_skinny, a thread a column. Each bias comes with its weight:
//    the column sums of dpre1f, dpre2f, dpre2h as the tiled products' bias
//    rows, those of dpre1h, df, dh as a column of ones in the skinny ones
//    (both summed in float64; the tiles' products in float32 FMAs).
//    Both split the rows into chunks
//    of RC (fixed, so each replica's sums are the same at any K), each chunk
//    into its own partial row; latent_bwd_reduce sums the chunks' and the
//    sweep blocks' rows in a fixed order. No atomics: the gradients are
//    bitwise the same from call to call.
//
// dctx is written straight into the zeroed (T,B,C) output: only the block
// that owns a row touches it, in step order. Plain f32 FMAs, no fast math;
// tensor cores are later work (float32 tolerances).
//
// Windows. The scratch grows with the steps (n x B x (8H + 2L) floats a
// replica), so a long solve runs both phases over windows of steps, last
// first (latent_fused.bwd_window: the most steps whose workspace fits 2 GiB
// a replica, from one replica's shapes alone). Between windows each sweep
// block keeps its chain in the workspace's carry: dz, the running sum of gq
// and the g nets' on-chip sums (their partial rows stay where they are), so
// the g nets' flushes fall on the same steps as in one window. Each
// window's contraction adds its chunks' partial rows into float64 sums
// (latent_bwd_reduce); the last writes the gradients. One window is the
// whole solve, computed as before.
//
// Layouts. Matrices indexed [in][hidden] are kept with an odd row stride
// (H | 1), so both the forward product (threads over the hidden unit) and
// the input-cotangent product (threads over the input row) read shared
// memory without bank conflicts. Activations are [unit][row], so a thread
// reads a unit's R rows as R / 4 float4s, broadcast to the warp.
//
// bf16 mixed mode (the _bf16 entry points; latent_fused_common.cuh) follows
// the JAX package's _backward_core: the pre-step z (z0 rounded as it is
// staged, zs already bf16), gz and the noise come in bf16, gq in float32;
// every product rounds its inputs to bf16 where that function does, the
// cotangents going into a product (df, dh, dpre2, dpre1, the g nets'
// dpre2g and dpre1g) and the activations (the towers' a1 and a2, the g
// nets' hidden units), while the activations for softplus' and the
// cotangents themselves stay float32. Its sweep and tiled contraction are
// kernels of their own on bf16 tensor cores (latent_bwd_sweep_bf16,
// latent_bwd_contract_bf16, below). The scratch holds what the products
// read, a1, a2 and the cotangents rounded, in bf16: half the float32
// workspace's bytes. The biases' gradients, JAX's sums of the unrounded
// cotangents, are summed by the sweep on chip as the g nets' are, and the
// reduction takes them from the blocks' partial rows. dctx and every weight
// gradient are summed in float32 and rounded to bf16 once, by the caller;
// dnoise goes out in bf16.
//
// K stacked replicas (tsde_latent_fused_bwd_multi) replace the Pallas
// kernel _bwd_kernel_multi (launched by _fused_solve_multi_bwd_impl). The
// replica is the sweep's grid y axis and the contraction's z axis, and each
// replica has its own workspace (scratch and partials), so replica k's
// gradients are bitwise those of a single call on its inputs.

#include <cuda_runtime.h>
#include <stddef.h>

#include "latent_fused_common.cuh"
#include "mma_bf16.cuh"

namespace tsde_latent_bwd {

using namespace tsde_latent;
using tsde_bf16::a_frag;
using tsde_bf16::b_frag;
using tsde_bf16::put_tile;
using tsde_bf16::quad_sum_add;
using tsde_bf16::take_bytes;
using tsde_bf16::warp_mma;

constexpr int SWEEP_THREADS = 256;  // the sweep's block size and rows a
constexpr int SWEEP_ROWS = TB;      // block (8; PERF.md times the others)
constexpr int NSCRATCH = 8;         // (n,B,H) scratch tensors
enum Scratch { A1F, A1H, A2F, A2H, DP1F, DP1H, DP2F, DP2H };
constexpr int FLUSH = 8;            // steps of the g nets' on-chip sums
constexpr int RC = 512;             // rows of a contraction chunk
constexpr int CT = 256;             // contraction threads
constexpr int TI = 64, TJ = 128, KS = 16;   // contraction tile and slab
constexpr int SKB = 16;             // rows a skinny thread loads at once

__host__ __device__ inline int row_stride(int H) { return H | 1; }

// Parts the hidden units are split into for dx = dpre1 W1^T: enough for
// most of the NT threads to take one of the (L + C + L) x JP products, and
// few enough that the partial sums fit where dpre2 was (2H x R floats).
__host__ __device__ inline int jparts(int NT, int D, int L, int H) {
  int jp = (NT < 2 * H ? NT : 2 * H) / (D + L);
  if (jp < 1) jp = 1;
  if (jp > H) jp = H;
  return jp;
}

struct Layout {
  size_t fw1, fb1, fw2, fb2, fw3t, fb3;
  size_t hw1, hb1, hw2, hb2, hw3t, hb3;
  size_t gb2;
  size_t x, io, a1, a2, red, dl, dz, ginc, gacc;
  size_t total;
};

// Floats of a step's per-row inputs for R rows: noise [l][r], gz [l][r],
// gq [r].
__host__ __device__ inline int io_floats(int L, int R) { return 2 * L * R + R; }

// Floats of a sweep block's carried chain between windows: dz [l][r], ginc
// [r], the g nets' on-chip sums (3LH) and gb2's [l][r].
__host__ __device__ inline int carry_floats(int L, int H, int R) {
  return 3 * L * H + (2 * L + 1) * R;
}

// The sweep's shared memory for NT threads and R rows a block.
__host__ __device__ inline Layout make_layout(int L, int C, int H, int NT,
                                              int R) {
  Layout s;
  size_t at = 0;
  const size_t D = size_t(L) + C, h = H, l = L, ld = row_stride(H);
  const size_t nwt = NT / 64;                        // warps of a tower
  const size_t jp = jparts(NT, int(D), L, H);
  s.fw1 = take(at, D * ld);  s.fb1 = take(at, h);   // [k][j], stride ld
  s.fw2 = take(at, h * ld);  s.fb2 = take(at, h);
  s.fw3t = take(at, l * ld); s.fb3 = take(at, l);   // W3 stored as [l][k]
  s.hw1 = take(at, l * ld);  s.hb1 = take(at, h);
  s.hw2 = take(at, h * ld);  s.hb2 = take(at, h);
  s.hw3t = take(at, l * ld); s.hb3 = take(at, l);
  s.gb2 = take(at, l);               // (the g nets' other weights: L1)
  s.x = take(at, D * R);            // [k][r]: z, then the context row
  s.io = take(at, size_t(io_floats(L, R)));
  s.a1 = take(at, 2 * h * R);       // [tower][j][r]; later dpre1
  const size_t pdx = jp * (D + l);   // dx's partial sums, after dpre2
  s.a2 = take(at, (2 * h > pdx ? 2 * h : pdx) * R);   // later dpre2
  s.red = take(at, 3 * nwt * l * R);  // [kind][warp][l][r]: f (later the
                                       // g nets' z-cotangent), h, g
  s.dl = take(at, 3 * l * R);       // [kind][l][r]: df, dh, dpre2 of g
  s.dz = take(at, l * R);           // [l][r]: the carried dz
  s.ginc = take(at, R);
  s.gacc = take(at, 3 * l * h + l * R);   // g nets' gw1, gb1, gw2; gb2
  s.total = at;
  return s;
}

// W: float, or __nv_bfloat16 in mixed mode.
template <typename W>
struct Args {
  const float* z0;       // ([K,] B, L)
  const W* ctx;          // ([K,] T, B, C)
  const int* ctx_idx;    // (n,), shared by the replicas
  const W* noise;        // ([K,] n, B, L)
  const float* dts;      // (n,), shared by the replicas
  const W* w[NW];        // each ([K,] ...)
  const W* zs;           // ([K,] n, B, L): post-step states from the forward
  const W* gz;           // ([K,] n, B, L)
  const float* gq;       // ([K,] n, B, 1)
  float* dz0;            // ([K,] B, L)
  float* dctx;           // ([K,] T, B, C), zeroed by the caller; float32
  W* dnoise;             // ([K,] n, B, L)
  float* ws;             // ([K,] workspace_floats): scratch, then partials
  size_t ws_stride;      // floats of one replica's workspace
  size_t parts;          // offset of the partials in a workspace
  size_t carry;          // offset of the sweep blocks' carried chain
  size_t sums;           // offset of the windows' float64 sums
  size_t off[NW];        // offset of each weight's gradient in a partial
  size_t P;
  int B, L, C, H, T, n;  // n: the window's steps
  int n_all, lo;         // the solve's steps; the window's first step
  int carry_in, carry_out;   // read / leave the carry (not the last /
                             // first window)
};

// Sums each of the R values over the warp's lanes.
template <int R>
__device__ __forceinline__ void warp_sum(float (&v)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[r] += __shfl_xor_sync(0xffffffffu, v[r], off);
  }
}

// A unit's R rows, 16-byte aligned, as R / 4 float4 loads.
template <int R>
__device__ __forceinline__ void load_rows(float (&v)[R], const float* p) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 t = *reinterpret_cast<const float4*>(p + 4 * q);
    v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z;
    v[4 * q + 3] = t.w;
  }
}

// (rows, cols) row-major into shared memory with row stride ld.
template <int NT>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows, int cols, int ld) {
  for (int e = threadIdx.x; e < rows * cols; e += NT)
    dst[(e / cols) * ld + e % cols] = src[e];
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows of step s's inputs for the tile at row0: x = [pre-step z | context
// row ctx_idx[s]] as [k][r], noise and gz as [l][r], gq as [r]; rows past
// the batch are zero-filled. The pre-step z is z0 at the solve's first
// step (`first`: s == 0 of the window from step 0), else the state after
// the step before, zs[s - 1] (before a later window's first step: the
// last state of the window before it).
template <int NT, int R>
__device__ __forceinline__ void prefetch_step(
    int s, bool first, float* xb, float* iob, const float* z0, const float* zs,
    const float* ctx, const int* ctx_idx, const float* noise, const float* gz,
    const float* gq, int row0, int B, int L, int C, int T) {
  const int D = L + C;
  const float* zpre = zs + ptrdiff_t(s - 1) * B * L;
  const int ci = min(max(ctx_idx[s], 0), T - 1);
  const float* cst = ctx + size_t(ci) * B * C;
  for (int e = threadIdx.x; e < R * D; e += NT) {
    const int r = e / D, k = e % D, row = row0 + r;
    const bool valid = row < B;
    float* dst = xb + k * R + r;
    if (k >= L)
      stage(dst, valid ? cst + size_t(row) * C + (k - L) : ctx, valid);
    else if (first)
      stage(dst, valid ? z0 + size_t(row) * L + k : z0, valid);
    else
      stage(dst, valid ? zpre + size_t(row) * L + k : zs, valid);
  }
  for (int e = threadIdx.x; e < R * L; e += NT) {
    const int r = e / L, l = e % L, row = row0 + r;
    const bool valid = row < B;
    const size_t at = valid ? (size_t(s) * B + row) * L + l : 0;
    stage(iob + l * R + r, noise + at, valid);
    stage(iob + (L + l) * R + r, gz + at, valid);
  }
  for (int r = threadIdx.x; r < R; r += NT) {
    const bool valid = row0 + r < B;
    cp_async4(iob + 2 * L * R + r, gq + (valid ? size_t(s) * B + row0 + r : 0),
              valid);
  }
  cp_async_commit();
}

// One block an SM (its shared memory): registers up to 255 a thread. At
// the default bound ptxas held the sweep to 128 and spilled; 168 and no
// spills took kernel 2 from 3.44 to 3.31 ms (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py --only ab).
template <int NT, int R>
__global__ void __launch_bounds__(NT, 1)
    latent_bwd_sweep(const Args<float> a) {
  constexpr int NTT = NT / 2;          // threads of a tower
  constexpr int NWT = NTT / 32;        // warps of a tower
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, C = a.C, H = a.H, B = a.B, D = L + C, n = a.n;
  const int ld = row_stride(H);
  const Layout lay = make_layout(L, C, H, NT, R);
  const int tid = threadIdx.x, lane = tid & 31;
  const int tw = tid / NTT, tt = tid % NTT, wt = tt / 32;
  const int row0 = blockIdx.x * R;
  const int JP = jparts(NT, D, L, H), KK = D + L, jlen = (H + JP - 1) / JP;
  const int top = a.n_all - a.lo;      // steps from the window's start on

  // This block's replica; the per-step arrays start at the window's first
  // step.
  const size_t rep = replica(), steps = size_t(a.n_all) * B * L;
  const size_t M = size_t(n) * B;
  const float* z0 = a.z0 + rep * B * L;
  const float* ctx = a.ctx + rep * a.T * B * C;
  const float* noise = a.noise + rep * steps;
  const float* zs = a.zs + rep * steps;
  const float* gz = a.gz + rep * steps;
  const float* gq = a.gq + rep * a.n_all * B;
  float* dz0 = a.dz0 + rep * B * L;
  float* dctx = a.dctx + rep * a.T * B * C;
  float* dnoise = a.dnoise + rep * steps;
  float* ws = a.ws + rep * a.ws_stride;
  float* sdf = ws + NSCRATCH * M * H;       // df, then dh: (n, B, L) each
  float* sdh = sdf + M * L;
  size_t wsize[NW];
  weight_sizes(L, C, H, wsize);
  const float* wr[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) wr[i] = a.w[i] + rep * wsize[i];

  float* x = sm + lay.x;
  float* io = sm + lay.io;
  prefetch_step<NT, R>(n - 1, n == 1 && a.lo == 0, x, io, z0, zs, ctx,
                       a.ctx_idx, noise, gz, gq, row0, B, L, C, a.T);

  copy_rows<NT>(sm + lay.fw1, wr[0], D, H, ld);
  copy_to_smem<NT>(sm + lay.fb1, wr[1], H);
  copy_rows<NT>(sm + lay.fw2, wr[2], H, H, ld);
  copy_to_smem<NT>(sm + lay.fb2, wr[3], H);
  copy_to_smem<NT>(sm + lay.fb3, wr[5], L);
  copy_rows<NT>(sm + lay.hw1, wr[6], L, H, ld);
  copy_to_smem<NT>(sm + lay.hb1, wr[7], H);
  copy_rows<NT>(sm + lay.hw2, wr[8], H, H, ld);
  copy_to_smem<NT>(sm + lay.hb2, wr[9], H);
  copy_to_smem<NT>(sm + lay.hb3, wr[11], L);
  for (int e = tid; e < H * L; e += NT) {      // (H, L) -> [l][k]
    const int k = e / L, l = e % L;
    sm[lay.fw3t + l * ld + k] = wr[4][e];
    sm[lay.hw3t + l * ld + k] = wr[10][e];
  }
  copy_to_smem<NT>(sm + lay.gb2, wr[15], L);
  // The chain starts at zero, or where the window after this one left it:
  // dz [l][r], ginc [r], then the g nets' sums gacc, in the block's carry.
  const int CW = carry_floats(L, H, R);
  float* carry = ws + a.carry + size_t(blockIdx.x) * CW;
  float* gacc = sm + lay.gacc;            // gw1, gb1, gw2 [l][k]; gb2 [l][r]
  for (int e = tid; e < L * R; e += NT)
    sm[lay.dz + e] = a.carry_in ? carry[e] : 0.f;
  for (int e = tid; e < R; e += NT)
    sm[lay.ginc + e] = a.carry_in ? carry[L * R + e] : 0.f;
  for (int e = tid; e < 3 * L * H + L * R; e += NT)
    gacc[e] = a.carry_in ? carry[(L + 1) * R + e] : 0.f;

  const float* fw1 = sm + lay.fw1;
  const float* fb1 = sm + lay.fb1;
  const float* fw3t = sm + lay.fw3t;
  const float* fb3 = sm + lay.fb3;
  const float* hw1 = sm + lay.hw1;
  const float* hb1 = sm + lay.hb1;
  const float* hw3t = sm + lay.hw3t;
  const float* hb3 = sm + lay.hb3;
  // The g nets' (L,1,H), (L,H), (L,H,1) weights as [l][k], each element
  // read by one thread (through L1); gb2 in shared memory.
  const float* gw1 = wr[12];
  const float* gb1 = wr[13];
  const float* gw2 = wr[14];
  const float* gb2 = sm + lay.gb2;
  float* a1 = sm + lay.a1;
  float* a2 = sm + lay.a2;
  float* red = sm + lay.red;
  float* dl = sm + lay.dl;
  float* dzs = sm + lay.dz;
  float* ginc = sm + lay.ginc;
  // This thread's tower: weights of layers 2 and 3, scratch tensors.
  const float* w2 = sm + (tw ? lay.hw2 : lay.fw2);
  const float* b2 = sm + (tw ? lay.hb2 : lay.fb2);
  const float* w3t = tw ? hw3t : fw3t;
  float* a1t = a1 + size_t(tw) * H * R;
  float* a2t = a2 + size_t(tw) * H * R;
  float* sa1 = ws + (tw ? A1H : A1F) * M * H;
  float* sa2 = ws + (tw ? A2H : A2F) * M * H;
  float* sdp1 = ws + (tw ? DP1H : DP1F) * M * H;
  float* sdp2 = ws + (tw ? DP2H : DP2F) * M * H;
  float* part = ws + a.parts + blockIdx.x * a.P;   // the block's partial row
  cp_async_wait<0>();
  __syncthreads();

  for (int s = n - 1; s >= 0; --s) {
    const float* xb = x;
    const float* iob = io;
    const size_t srow = size_t(s) * B + row0;    // scratch row of r = 0
    for (int r = tid; r < R; r += NT) ginc[r] += iob[2 * L * R + r];

    // B. Layer 1: f on x (tower 0), h on z (tower 1); the h threads then
    // take the g nets' output sums.
    for (int j = tt; j < H; j += NTT) {
      float acc[R], xv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      const float* w1 = tw ? hw1 : fw1;
      const int kin = tw ? L : D;
#pragma unroll 4
      for (int k = 0; k < kin; ++k) {
        const float w = w1[k * ld + j];
        load_rows(xv, xb + k * R);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(xv[r], w, acc[r]);
      }
      const float b = (tw ? hb1 : fb1)[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = softplus(acc[r] + b);
        a1t[j * R + r] = v;
        if (row0 + r < B) sa1[(srow + r) * H + j] = v;
      }
    }
    if (tw == 1) {
      for (int l = 0; l < L; ++l) {
        float t[R], zv[R];
#pragma unroll
        for (int r = 0; r < R; ++r) t[r] = 0.f;
        load_rows(zv, xb + l * R);
        for (int k = tt; k < H; k += NTT) {
          const float w1 = ldw(gw1 + l * H + k);
          const float b1 = ldw(gb1 + l * H + k);
          const float w2g = ldw(gw2 + l * H + k);
#pragma unroll
          for (int r = 0; r < R; ++r)
            t[r] = fmaf(softplus(zv[r] * w1 + b1), w2g, t[r]);
        }
        warp_sum(t);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            red[((2 * NWT + wt) * L + l) * R + r] = t[r];
        }
      }
    }
    __syncthreads();

    // C. Layer 2 of this thread's tower; D. its layer-3 sums over the
    // thread's own units (no barrier: each reads back what it wrote).
    for (int j = tt; j < H; j += NTT) {
      float acc[R], v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = w2[k * ld + j];
        load_rows(v, a1t + k * R);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(v[r], w, acc[r]);
      }
      const float b = b2[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float u = softplus(acc[r] + b);
        a2t[j * R + r] = u;
        if (row0 + r < B) sa2[(srow + r) * H + j] = u;
      }
    }
    for (int l = 0; l < L; ++l) {
      float t[R], v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = 0.f;
      for (int k = tt; k < H; k += NTT) {
        const float w = w3t[l * ld + k];
        load_rows(v, a2t + k * R);
#pragma unroll
        for (int r = 0; r < R; ++r) t[r] = fmaf(v[r], w, t[r]);
      }
      warp_sum(t);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          red[((tw * NWT + wt) * L + l) * R + r] = t[r];
      }
    }
    __syncthreads();

    // E. Per row and output: the step's f, h, g, u and the cotangents of f,
    // h and of g's pre-activation; dnoise; the carried dz takes gz.
    for (int e = tid; e < L * R; e += NT) {
      const int l = e / R, r = e % R, row = row0 + r;
      const bool valid = row < B;
      float pf = 0.f, ph = 0.f, pg = 0.f;
      for (int w = 0; w < NWT; ++w) {
        pf += red[((0 * NWT + w) * L + l) * R + r];
        ph += red[((1 * NWT + w) * L + l) * R + r];
        pg += red[((2 * NWT + w) * L + l) * R + r];
      }
      const float f = pf + fb3[l];
      const float h = ph + hb3[l];
      const float g = sigmoid(pg + gb2[l]);
      const bool big = g > EPS;
      const float gs = big ? g : EPS;
      const float u = (f - h) / gs;
      const float dt = a.dts[s];
      const float dz = dzs[e] + iob[(L + l) * R + r];
      const float dW = iob[l * R + r];
      const size_t at = valid ? (size_t(s) * B + row) * L + l : 0;
      if (valid) dnoise[at] = dz * g;
      const float du = ginc[r] * u * dt;
      const float df = dz * dt + du / gs;
      const float dh = -du / gs;
      const float dg = dz * dW - (big ? du * u / gs : 0.f);
      const float d2 = dg * g * (1.f - g);
      dl[(0 * L + l) * R + r] = df;
      dl[(1 * L + l) * R + r] = dh;
      dl[(2 * L + l) * R + r] = d2;
      dzs[e] = dz;
      gacc[3 * L * H + e] += d2;
      if (valid) {
        sdf[at] = df;
        sdh[at] = dh;
      }
    }
    __syncthreads();

    // F. Layer 3 back to dpre2 (in place over a2) and b2; the g nets'
    // backward, tower t taking the outputs l = t, t + 2, ...: their
    // gradients summed on chip, their z-cotangent as per-warp sums.
    for (int k = tt; k < H; k += NTT) {
      float v[R], da[R];
      load_rows(v, a2t + k * R);
#pragma unroll
      for (int r = 0; r < R; ++r) da[r] = 0.f;
      for (int l = 0; l < L; ++l) {
        const float w = w3t[l * ld + k];
        const float* d = dl + (tw * L + l) * R;
#pragma unroll
        for (int r = 0; r < R; ++r) da[r] = fmaf(d[r], w, da[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = da[r] * (1.f - expf(-v[r]));
        a2t[k * R + r] = p;       // G's products' input
        if (row0 + r < B) sdp2[(srow + r) * H + k] = p;
      }
    }
    for (int l = tw; l < L; l += 2) {
      float tz[R], zv[R], d2[R];
#pragma unroll
      for (int r = 0; r < R; ++r) tz[r] = 0.f;
      load_rows(zv, xb + l * R);
      load_rows(d2, dl + (2 * L + l) * R);
      for (int k = tt; k < H; k += NTT) {
        const int i = l * H + k;
        const float w1 = ldw(gw1 + i), b1 = ldw(gb1 + i);
        const float w2g = ldw(gw2 + i);
        float sw2 = 0.f, sw1 = 0.f, sb1 = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float act = softplus(zv[r] * w1 + b1);
          const float d2r = d2[r];
          sw2 = fmaf(act, d2r, sw2);
          const float dp1 = d2r * w2g * (1.f - expf(-act));
          const float dp1r = dp1;
          sw1 = fmaf(dp1r, zv[r], sw1);
          sb1 += dp1;
          tz[r] = fmaf(dp1r, w1, tz[r]);
        }
        gacc[i] += sw1;
        gacc[L * H + i] += sb1;
        gacc[2 * L * H + i] += sw2;
      }
      warp_sum(tz);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          red[(wt * L + l) * R + r] = tz[r];
      }
    }
    __syncthreads();

    // x and the step's inputs are read for the last time above: fetch the
    // step before's while G and H compute.
    if (s > 0)
      prefetch_step<NT, R>(s - 1, s == 1 && a.lo == 0, x, io, z0, zs, ctx,
                           a.ctx_idx, noise, gz, gq, row0, B, L, C, a.T);
    // Every FLUSH steps of the solve the g nets' on-chip sums join the
    // block's partial row, so no float32 sum runs over more than FLUSH x R
    // terms (one over all 1,024 of a block drifted from float64 five times
    // as far as the plain version's blocked sums).
    if ((top - s) % FLUSH == 0 || (s == 0 && a.lo == 0)) {
      const bool first = top - s <= FLUSH;
      for (int e = tid; e < 3 * L * H; e += NT) {
        float* p = part + a.off[12] + e;
        *p = first ? gacc[e] : *p + gacc[e];
        gacc[e] = 0.f;
      }
      for (int l = tid; l < L; l += NT) {
        float v = 0.f;
        for (int r = 0; r < R; ++r) {
          v += gacc[3 * L * H + l * R + r];
          gacc[3 * L * H + l * R + r] = 0.f;
        }
        float* p = part + a.off[15] + l;
        *p = first ? v : *p + v;
      }
    }

    // G. dpre1 = (dpre2 W2^T) * softplus'(a1), in place over a1: thread k
    // owns row k of W2.
    for (int k = tt; k < H; k += NTT) {
      float da[R], v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) da[r] = 0.f;
#pragma unroll 4
      for (int j = 0; j < H; ++j) {
        const float w = w2[k * ld + j];
        load_rows(v, a2t + j * R);
#pragma unroll
        for (int r = 0; r < R; ++r) da[r] = fmaf(v[r], w, da[r]);
      }
      load_rows(v, a1t + k * R);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = da[r] * (1.f - expf(-v[r]));
        a1t[k * R + r] = p;
        if (row0 + r < B) sdp1[(srow + r) * H + k] = p;
      }
    }
    __syncthreads();

    // H. The input cotangents dx = dpre1 W1^T of f (rows k < D) and of h
    // (rows D + l), each over one of JP parts of the hidden units, into
    // partial sums over a2 (free since G).
    float* pdx = a2;
    for (int e = tid; e < KK * JP; e += NT) {
      const int kk = e % KK, jp = e / KK;
      const float* w = kk < D ? fw1 + kk * ld : hw1 + (kk - D) * ld;
      const float* q = kk < D ? a1 : a1 + H * R;
      const int j1 = min(H, (jp + 1) * jlen);
      float acc[R], v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int j = jp * jlen; j < j1; ++j) {
        const float wv = w[j];
        load_rows(v, q + j * R);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(v[r], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) pdx[(jp * KK + kk) * R + r] = acc[r];
    }
    cp_async_wait<0>();
    __syncthreads();

    // The z part of dx, h's and the g nets' z-cotangents join the carried
    // dz (the thread that owns it in E); the context part goes to
    // dctx[ctx_idx[s]], each element by one thread in step order.
    for (int e = tid; e < L * R; e += NT) {
      const int l = e / R, r = e % R;
      float v = dzs[e];
      for (int jp = 0; jp < JP; ++jp)
        v += pdx[(jp * KK + l) * R + r] + pdx[(jp * KK + D + l) * R + r];
      for (int w = 0; w < NWT; ++w) v += red[(w * L + l) * R + r];
      dzs[e] = v;
    }
    const int ci = min(max(a.ctx_idx[s], 0), a.T - 1);
    for (int e = tid; e < R * C; e += NT) {
      const int r = e / C, c = e % C, row = row0 + r;
      if (row >= B) continue;
      float v = 0.f;
      for (int jp = 0; jp < JP; ++jp) v += pdx[(jp * KK + L + c) * R + r];
      dctx[(size_t(ci) * B + row) * C + c] += v;
    }
  }
  __syncthreads();

  if (a.carry_out) {              // the window before this one goes on
    for (int e = tid; e < L * R; e += NT) carry[e] = dzs[e];
    for (int e = tid; e < R; e += NT) carry[L * R + e] = ginc[e];
    for (int e = tid; e < 3 * L * H + L * R; e += NT)
      carry[(L + 1) * R + e] = gacc[e];
    return;
  }
  for (int e = tid; e < R * L; e += NT) {
    const int r = e / L, l = e % L, row = row0 + r;
    if (row < B) dz0[size_t(row) * L + l] = dzs[l * R + r];
  }
}

// ---------------------------------------------------------------------------
// The sweep in bf16 mixed mode, on tensor cores (latent_bwd_sweep_bf16).
//
// The chain of latent_bwd_sweep, redesigned for bf16 operands. The weights
// stay bf16 in shared memory (84 KB at the flagship, against the float
// layout's 176), as [input][unit] rows laid out for ldmatrix
// (tsde_bf16::ldsm_offset), and every product with a hidden-wide side runs
// on mma.m16n8k16 with the weight as the 16-row A operand and the block's
// 8 rows as the n = 8 B operand: layer 1 ([z | ctx] W1) and layer 2 of both
// towers read the weights transposed, and going back dpre2 W2^T and dx =
// dpre1 W1^T read the same rows as they are. A k-tile's rows past a
// weight's end read a zero row. Each warp of a tower owns the same m-tiles
// (16 units) in every stage, so the float32 a1 and a2 that softplus' needs
// stay in its registers. An activation or cotangent is rounded once, two at
// a time (cvt.rn.bf16x2), where it is written as the next product's B
// operand: [row][unit] bf16 in shared memory, transposed by movmatrix; the
// scratch takes the same rows by 16-byte stores, so it is bf16 and half the
// float32 one. The L-wide products (layer 3 both ways) and the g nets stay
// on FMAs. The biases' gradients are JAX's sums of the unrounded float32
// cotangents: each unit's by the warp that owns it, a step's rows summed in
// the warp, into on-chip sums flushed every FLUSH steps into the block's
// partial row, as the g nets' are (they are carried between windows with
// them). A step's inputs are loaded into registers once the step has read
// its own for the last time and stored after its last product; its
// context row and width a step ahead.
//
// What bounds it. Shared memory is 111,616 bytes at the flagship, so two
// blocks fit an SM, and the launch takes registers for two (128 a thread;
// ptxas spills some) where the grid has more blocks than the card has SMs
// (kernel 4), else for one (kernel 2's 128 blocks; 255). With 8 or
// 16 warps an SM each stage's chain of dependent instructions, not the
// tensor cores, sets the time: the g nets' softplus and exp (F, B), the
// products' ldmatrix-mma chains and their softplus (C, G, H), the one warp
// of E (chip_smoke.py --only tiles reads the stages' clocks; PERF.md).

// Its stage clocks (latent_fused_common.cuh: TSDE_MARK), for measurement
// only.
#ifdef TSDE_STAGE_CLOCKS
__device__ unsigned long long tsde_stage_clocks[8];
#endif

// Floats of the on-chip bias sums in mixed mode: the unit sums of dpre1f,
// dpre2f, dpre1h, dpre2h ([4][H]), then df and dh by row ([2][L][R]).
__host__ __device__ inline int bias_sum_floats(int L, int H, int R) {
  return 4 * H + 2 * L * R;
}

// A sweep block's carried chain in mixed mode: the float one's, then the
// bias sums.
__host__ __device__ inline int carry_floats_bf16(int L, int H, int R) {
  return carry_floats(L, H, R) + bias_sum_floats(L, H, R);
}

// Byte offsets of the bf16 sweep's shared memory, each on 16 bytes.
struct Bf16Layout {
  size_t fw1, fw2, hw1, hw2, zero, w3, b1, b2, b3, gb2, x, zf, io, act1,
      act2, red, dl, dz, ginc, pdz, gacc, bacc, total;
  int hp;   // H padded to 16
  int wc;   // 16-byte chunks of a weight row (tsde_bf16::ldsm_chunks)
  int as;   // row stride of the [tower][row][unit] activations (bf16)
  int xs;   // row stride of x (bf16)
};

__host__ __device__ inline Bf16Layout make_bf16_layout(int L, int C, int H,
                                                       int NT, int R) {
  Bf16Layout s;
  size_t at = 0;
  const size_t D = size_t(L) + C, h = H, l = L, nwt = NT / 64;
  s.hp = tsde_bf16::pad16(H);
  s.wc = tsde_bf16::ldsm_chunks(H);
  // Row strides of 8 (mod 16) bf16: the 32-bit B-fragment reads and the
  // transposed stores of a warp fall on 32 distinct banks.
  s.as = s.hp + 8;
  s.xs = tsde_bf16::pad16(int(D)) + 8;
  const size_t row = size_t(s.wc) * 16;   // bytes of a weight row
  const size_t hp = s.hp;
  s.fw1 = take_bytes(at, D * row);        // [in][unit] bf16
  s.fw2 = take_bytes(at, h * row);
  s.hw1 = take_bytes(at, l * row);
  s.hw2 = take_bytes(at, h * row);
  s.zero = take_bytes(at, 16);            // the zero row
  s.w3 = take_bytes(at, 2 * hp * l * 4);  // [tower][unit][l] float
  s.b1 = take_bytes(at, 2 * hp * 4);      // [tower][unit] float
  s.b2 = take_bytes(at, 2 * hp * 4);
  s.b3 = take_bytes(at, 2 * l * 4);
  s.gb2 = take_bytes(at, l * 4);
  s.x = take_bytes(at, size_t(R) * s.xs * 2);       // [r][k] bf16
  s.zf = take_bytes(at, l * R * 4);                 // [l][r]: z rounded
  s.io = take_bytes(at, size_t(io_floats(L, R)) * 4);
  s.act1 = take_bytes(at, 2 * size_t(R) * s.as * 2);   // a1, then dpre1
  s.act2 = take_bytes(at, 2 * size_t(R) * s.as * 2);   // a2, then dpre2
  s.red = take_bytes(at, 3 * nwt * l * R * 4);
  s.dl = take_bytes(at, 3 * l * R * 4);   // df, dh, dpre2 of g, rounded
  s.dz = take_bytes(at, l * R * 4);
  s.ginc = take_bytes(at, size_t(R) * 4);
  s.pdz = take_bytes(at, 2 * l * R * 4);  // dx's z parts of f and h
  s.gacc = take_bytes(at, (3 * l * h + l * R) * 4);
  s.bacc = take_bytes(at, size_t(bias_sum_floats(L, H, R)) * 4);
  s.total = at;
  return s;
}

// A step's inputs for a block's rows, element by element: x = [pre-step z
// rounded | context row] (r, k) for e < R D, then noise and gz (r, l), then
// gq (r), each as raw bits (bf16 in the low half, or a float); rows past the
// batch are zero.
struct StepIn {
  const float* z0;
  const __nv_bfloat16 *zs, *ctx, *noise, *gz;
  const float* gq;
  const int* ctx_idx;
  int B, L, C, T, row0;
};

__device__ __forceinline__ uint32_t bf_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

template <int R>
__device__ __forceinline__ int step_elems(const StepIn& in) {
  return R * (in.L + in.C) + 2 * R * in.L + R;
}

// Element e of step s's inputs (`first`: z_pre is z0, rounded; ci: the
// step's context row).
template <int R>
__device__ __forceinline__ uint32_t step_bits(const StepIn& in, int e, int s,
                                              bool first, int ci) {
  const int L = in.L, D = L + in.C;
  if (e < R * D) {
    const int r = e / D, k = e % D, row = in.row0 + r;
    if (row >= in.B) return 0u;
    if (k >= L)
      return bf_bits(in.ctx[(size_t(ci) * in.B + row) * in.C + k - L]);
    if (first)
      return bf_bits(__float2bfloat16_rn(in.z0[size_t(row) * L + k]));
    return bf_bits(
        in.zs[(ptrdiff_t(s) - 1) * in.B * L + ptrdiff_t(row) * L + k]);
  }
  e -= R * D;
  if (e < 2 * R * L) {
    const int kind = e / (R * L), i = e % (R * L);
    const int row = in.row0 + i / L;
    if (row >= in.B) return 0u;
    const __nv_bfloat16* src = kind ? in.gz : in.noise;
    return bf_bits(src[(size_t(s) * in.B + row) * L + i % L]);
  }
  e -= 2 * R * L;
  const int row = in.row0 + e;
  return row < in.B ? __float_as_uint(in.gq[size_t(s) * in.B + row]) : 0u;
}

// Stores element e's bits: x [r][k] (xs the row stride), z also as float
// zf [l][r], noise and gz as float io [kind][l][r], gq as io [2L][r].
template <int R>
__device__ __forceinline__ void put_step(const StepIn& in, int e, uint32_t v,
                                         __nv_bfloat16* x, int xs, float* zf,
                                         float* io) {
  const int L = in.L, D = L + in.C;
  if (e < R * D) {
    const int r = e / D, k = e % D;
    x[r * xs + k] = __ushort_as_bfloat16(static_cast<unsigned short>(v));
    if (k < L) zf[k * R + r] = __uint_as_float(v << 16);
    return;
  }
  e -= R * D;
  if (e < 2 * R * L) {
    const int kind = e / (R * L), i = e % (R * L);
    io[(kind * L + i % L) * R + i / L] = __uint_as_float(v << 16);
    return;
  }
  io[2 * L * R + e - 2 * R * L] = __uint_as_float(v);
}

// A thread's element of a step's inputs, decoded once (the decoding divides
// by the widths): what it is, its offset in its source's slab for a step
// (a step's context row for IN_CTX), and where it goes: x [r][k] (dst; z
// also zf [l][r], dst2), or io. Rows past the batch are IN_NONE: their
// zeros, stored with the first step's inputs, stay.
enum InKind { IN_NONE, IN_CTX, IN_Z, IN_NOISE, IN_GZ, IN_GQ };
struct InSlot {
  int kind, src, dst, dst2;
};

template <int R>
__device__ __forceinline__ InSlot in_slot(const StepIn& in, int e, int xs) {
  const int L = in.L, D = L + in.C;
  InSlot q{IN_NONE, 0, 0, 0};
  if (e < R * D) {
    const int r = e / D, k = e % D, row = in.row0 + r;
    if (row < in.B) {
      q.kind = k < L ? IN_Z : IN_CTX;
      q.src = k < L ? row * L + k : row * in.C + k - L;
      q.dst = r * xs + k;
      q.dst2 = k * R + r;
    }
    return q;
  }
  e -= R * D;
  if (e < 2 * R * L) {
    const int kind = e / (R * L), i = e % (R * L);
    const int r = i / L, l = i % L, row = in.row0 + r;
    if (row < in.B) {
      q.kind = kind ? IN_GZ : IN_NOISE;
      q.src = row * L + l;
      q.dst = (kind * L + l) * R + r;
    }
    return q;
  }
  e -= 2 * R * L;
  if (e < R && in.row0 + e < in.B) {
    q.kind = IN_GQ;
    q.src = in.row0 + e;
    q.dst = 2 * L * R + e;
  }
  return q;
}

// A slot's element of step s (`first`: z_pre is z0, rounded; ci: the
// step's context row), as step_bits gives it.
__device__ __forceinline__ uint32_t in_load(const StepIn& in, const InSlot& q,
                                            int s, bool first, int ci) {
  const size_t BL = size_t(in.B) * in.L;
  switch (q.kind) {
    case IN_CTX:
      return bf_bits(in.ctx[size_t(ci) * in.B * in.C + q.src]);
    case IN_Z:
      return first ? bf_bits(__float2bfloat16_rn(in.z0[q.src]))
                   : bf_bits(in.zs[(ptrdiff_t(s) - 1) * ptrdiff_t(BL) +
                                   q.src]);
    case IN_NOISE:
      return bf_bits(in.noise[size_t(s) * BL + q.src]);
    case IN_GZ:
      return bf_bits(in.gz[size_t(s) * BL + q.src]);
    case IN_GQ:
      return __float_as_uint(in.gq[size_t(s) * in.B + q.src]);
  }
  return 0u;
}

__device__ __forceinline__ void in_store(const InSlot& q, uint32_t v,
                                         __nv_bfloat16* x, float* zf,
                                         float* io) {
  if (q.kind == IN_CTX || q.kind == IN_Z) {
    x[q.dst] = __ushort_as_bfloat16(static_cast<unsigned short>(v));
    if (q.kind == IN_Z) zf[q.dst2] = __uint_as_float(v << 16);
  } else if (q.kind == IN_NOISE || q.kind == IN_GZ) {
    io[q.dst] = __uint_as_float(v << 16);
  } else if (q.kind == IN_GQ) {
    io[q.dst] = __uint_as_float(v);
  }
}

// Rows of a [tower][row][unit] bf16 array (row stride `stride`) to rows
// srow.. of the towers' (n, B, H) scratch tensors f and h, the first `rows`
// of the block's R; 16 bytes a store where H allows. tr0, c0: the thread's
// first chunk, tower x R + row and column, decoded once (tr0 < 0: decode
// each chunk here).
template <int NT, int R>
__device__ __forceinline__ void put_rows(const __nv_bfloat16* act, int stride,
                                         __nv_bfloat16* f, __nv_bfloat16* h,
                                         size_t srow, int H, int rows,
                                         int tr0, int c0) {
  if (H % 8 == 0) {
    const int CH = H / 8;
    for (int e = threadIdx.x; e < 2 * R * CH; e += NT) {
      const bool own = tr0 >= 0 && e == int(threadIdx.x);
      const int tr = own ? tr0 : e / CH, c = own ? c0 : e % CH;
      const int t = tr / R, r = tr % R;
      if (r < rows)
        *reinterpret_cast<uint4*>((t ? h : f) + (srow + r) * H + 8 * c) =
            *reinterpret_cast<const uint4*>(act + (t * R + r) * stride +
                                            8 * c);
    }
  } else {
    for (int e = threadIdx.x; e < 2 * R * H; e += NT) {
      const int t = e / (R * H), r = (e / H) % R, j = e % H;
      if (r < rows)
        (t ? h : f)[(srow + r) * H + j] = act[(t * R + r) * stride + j];
    }
  }
}

// The g nets' output sums of output l over the units k = tt, tt + NTT, ...
// and R rows (z rounded, zf [l][r]): out[r] = sum_k rnd(softplus(z_r w1 +
// b1)) w2, summed over the warp (lane 0 writes out).
template <int NTT, int R>
__device__ __forceinline__ void gnet_forward(
    int l, int H, int tt, int lane, const float* zf,
    const __nv_bfloat16* gw1, const __nv_bfloat16* gb1,
    const __nv_bfloat16* gw2, float* out) {
  float t[R], zv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = 0.f;
  load_rows(zv, zf + l * R);
  for (int k = tt; k < H; k += NTT) {
    const float w1 = ldw(gw1 + l * H + k);
    const float b1 = ldw(gb1 + l * H + k);
    const float w2g = ldw(gw2 + l * H + k);
#pragma unroll
    for (int r = 0; r < R; ++r)
      t[r] = fmaf(rnd<__nv_bfloat16>(softplus(zv[r] * w1 + b1)), w2g, t[r]);
  }
  warp_sum(t);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = t[r];
  }
}

// The g nets' backward for output l (dpre2 of g rounded, dl2 [r]): their
// weights' gradients summed on chip (gacc, each element by one thread),
// their z-cotangent summed over the warp into out.
template <int NTT, int R>
__device__ __forceinline__ void gnet_backward(
    int l, int L, int H, int tt, int lane, const float* zf, const float* dl2,
    const __nv_bfloat16* gw1, const __nv_bfloat16* gb1,
    const __nv_bfloat16* gw2, float* gacc, float* out) {
  float tz[R], zv[R], d2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) tz[r] = 0.f;
  load_rows(zv, zf + l * R);
  load_rows(d2, dl2);
  for (int k = tt; k < H; k += NTT) {
    const int i = l * H + k;
    const float w1 = ldw(gw1 + i), b1 = ldw(gb1 + i);
    const float w2g = ldw(gw2 + i);
    float sw2 = 0.f, sw1 = 0.f, sb1 = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = softplus(zv[r] * w1 + b1);
      sw2 = fmaf(rnd<__nv_bfloat16>(v), d2[r], sw2);
      const float dp1 = d2[r] * w2g * (1.f - expf(-v));
      const float dp1r = rnd<__nv_bfloat16>(dp1);
      sw1 = fmaf(dp1r, zv[r], sw1);
      sb1 += dp1;
      tz[r] = fmaf(dp1r, w1, tz[r]);
    }
    gacc[i] += sw1;
    gacc[L * H + i] += sb1;
    gacc[2 * L * H + i] += sw2;
  }
  warp_sum(tz);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = tz[r];
  }
}

// NT threads (two towers of NT / 64 warps), R rows a block (R / 8 n-tiles),
// MPW m-tiles a warp at most (MPW NT / 64 x 16 units a tower), MINB blocks
// an SM for ptxas's register budget.
template <int NT, int R, int MPW, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    latent_bwd_sweep_bf16(const Args<__nv_bfloat16> a) {
  using namespace tsde_bf16;
  using bf = __nv_bfloat16;
  constexpr int NTT = NT / 2, NWT = NTT / 32, NWARP = NT / 32, NR = R / 8;
  constexpr int PF = 3 * NR;   // a step's input elements a thread holds
  static_assert(R % 8 == 0 && NT % 64 == 0, "rows in n-tiles, two towers");
  extern __shared__ __align__(16) unsigned char smb[];
  const int L = a.L, C = a.C, H = a.H, B = a.B, D = L + C, n = a.n;
  const Bf16Layout lay = make_bf16_layout(L, C, H, NT, R);
  const int MT = lay.hp / 16, WC = lay.wc, AS = lay.as, XS = lay.xs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tw = tid / NTT, tt = tid % NTT, wt = tt / 32;
  const int row0 = blockIdx.x * R, rows = min(R, B - row0);
  const int top = a.n_all - a.lo;

  const size_t rep = replica(), steps = size_t(a.n_all) * B * L;
  const size_t M = size_t(n) * B, MH = M * H;
  const StepIn in{a.z0 + rep * B * L, a.zs + rep * steps,
                  a.ctx + rep * a.T * B * C, a.noise + rep * steps,
                  a.gz + rep * steps, a.gq + rep * a.n_all * B, a.ctx_idx,
                  B, L, C, a.T, row0};
  float* dz0 = a.dz0 + rep * B * L;
  float* dctx = a.dctx + rep * a.T * B * C;
  bf* dnoise = a.dnoise + rep * steps;
  float* ws = a.ws + rep * a.ws_stride;
  bf* scr = reinterpret_cast<bf*>(ws);      // the scratch, bf16
  bf* sdf = scr + NSCRATCH * MH;            // df, then dh: (n, B, L) each
  bf* sdh = sdf + M * L;
  size_t wsize[NW];
  weight_sizes(L, C, H, wsize);
  const bf* wr[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) wr[i] = a.w[i] + rep * wsize[i];

  bf* fw1 = reinterpret_cast<bf*>(smb + lay.fw1);
  bf* fw2 = reinterpret_cast<bf*>(smb + lay.fw2);
  bf* hw1 = reinterpret_cast<bf*>(smb + lay.hw1);
  bf* hw2 = reinterpret_cast<bf*>(smb + lay.hw2);
  bf* zero = reinterpret_cast<bf*>(smb + lay.zero);
  float* w3s = reinterpret_cast<float*>(smb + lay.w3);
  float* b1s = reinterpret_cast<float*>(smb + lay.b1);
  float* b2s = reinterpret_cast<float*>(smb + lay.b2);
  float* b3s = reinterpret_cast<float*>(smb + lay.b3);
  float* gb2 = reinterpret_cast<float*>(smb + lay.gb2);
  bf* x = reinterpret_cast<bf*>(smb + lay.x);
  float* zf = reinterpret_cast<float*>(smb + lay.zf);
  float* io = reinterpret_cast<float*>(smb + lay.io);
  bf* act1 = reinterpret_cast<bf*>(smb + lay.act1);
  bf* act2 = reinterpret_cast<bf*>(smb + lay.act2);
  float* red = reinterpret_cast<float*>(smb + lay.red);
  float* dl = reinterpret_cast<float*>(smb + lay.dl);
  float* dzs = reinterpret_cast<float*>(smb + lay.dz);
  float* ginc = reinterpret_cast<float*>(smb + lay.ginc);
  float* pdz = reinterpret_cast<float*>(smb + lay.pdz);
  float* gacc = reinterpret_cast<float*>(smb + lay.gacc);
  float* bacc = reinterpret_cast<float*>(smb + lay.bacc);

  // The weights: W1 and W2 of both towers as [in][unit] bf16 (units past H
  // zero), W3 as float [tower][unit][l], the biases as float.
  const bf zb = __ushort_as_bfloat16(0);
  const struct {
    bf* dst;
    int src, rows;
  } wl[4] = {{fw1, 0, D}, {fw2, 2, H}, {hw1, 6, L}, {hw2, 8, H}};
  for (int w = 0; w < 4; ++w) {
    for (int e = tid; e < wl[w].rows * lay.hp; e += NT) {
      const int k = e / lay.hp, j = e % lay.hp;
      wl[w].dst[ldsm_offset(k, j, WC)] =
          j < H ? wr[wl[w].src][size_t(k) * H + j] : zb;
    }
  }
  for (int e = tid; e < 8; e += NT) zero[e] = zb;
  for (int e = tid; e < 2 * lay.hp * L; e += NT) {
    const int t = e / (lay.hp * L), j = (e / L) % lay.hp, l = e % L;
    w3s[e] = j < H ? to_f(wr[t ? 10 : 4][j * L + l]) : 0.f;
  }
  for (int e = tid; e < 2 * lay.hp; e += NT) {
    const int t = e / lay.hp, j = e % lay.hp;
    b1s[e] = j < H ? to_f(wr[t ? 7 : 1][j]) : 0.f;
    b2s[e] = j < H ? to_f(wr[t ? 9 : 3][j]) : 0.f;
  }
  for (int e = tid; e < 2 * L; e += NT)
    b3s[e] = to_f(wr[e < L ? 5 : 11][e % L]);
  for (int e = tid; e < L; e += NT) gb2[e] = to_f(wr[15][e]);
  for (int e = tid; e < R * XS; e += NT)      // x past D stays zero
    if (e % XS >= D) x[e] = zb;
  // The chain starts at zero, or where the window after this one left it:
  // dz, ginc, the g nets' sums, the bias sums.
  const int CW = carry_floats_bf16(L, H, R);
  float* carry = ws + a.carry + size_t(blockIdx.x) * CW;
  for (int e = tid; e < L * R; e += NT)
    dzs[e] = a.carry_in ? carry[e] : 0.f;
  for (int e = tid; e < R; e += NT)
    ginc[e] = a.carry_in ? carry[L * R + e] : 0.f;
  const int GA = 3 * L * H + L * R, BA = bias_sum_floats(L, H, R);
  for (int e = tid; e < GA; e += NT)
    gacc[e] = a.carry_in ? carry[(L + 1) * R + e] : 0.f;
  for (int e = tid; e < BA; e += NT)
    bacc[e] = a.carry_in ? carry[(L + 1) * R + GA + e] : 0.f;
  // The step's context row and width, loaded a step ahead.
  int ci = min(max(__ldg(a.ctx_idx + n - 1), 0), a.T - 1);
  float dt = __ldg(a.dts + n - 1);
  const int E = step_elems<R>(in);
  for (int e = tid; e < E; e += NT)
    put_step<R>(in, e, step_bits<R>(in, e, n - 1, n == 1 && a.lo == 0, ci),
                x, XS, zf, io);
  // With registers for one block an SM, the thread's elements of a step's
  // inputs and its first chunk of the scratch rows are decoded here once;
  // with two, where registers are short, where they are used.
  constexpr bool decoded = MINB == 1;
  InSlot slot[decoded ? PF : 1];
  if constexpr (decoded) {
#pragma unroll
    for (int i = 0; i < PF; ++i) slot[i] = in_slot<R>(in, tid + i * NT, XS);
  }
  const int tr0 = decoded && H % 8 == 0 ? tid / (H / 8) : -1;
  const int c0 = decoded && H % 8 == 0 ? tid % (H / 8) : 0;
  __syncthreads();

  // This thread's tower.
  const bf* w1t = tw ? hw1 : fw1;
  const bf* w2t = tw ? hw2 : fw2;
  const int kin = tw ? L : D;
  const float* b1t = b1s + tw * lay.hp;
  const float* b2t = b2s + tw * lay.hp;
  const float* w3t = w3s + tw * lay.hp * L;
  bf* act1t = act1 + tw * R * AS;
  bf* act2t = act2 + tw * R * AS;
  float* bsum1 = bacc + 2 * tw * H;          // dpre1's unit sums
  float* bsum2 = bsum1 + H;                  // dpre2's
  float* bsum3 = bacc + 4 * H;               // df's, then dh's [l][r]
  float* part = ws + a.parts + blockIdx.x * a.P;   // the block's partial row
  const bf* gw1 = wr[12];
  const bf* gb1 = wr[13];
  const bf* gw2 = wr[14];
  // This lane's a1 and a2 (float), and a2 rounded, packed.
  float a1r[MPW][NR][4], a2r[MPW][NR][4];
  uint32_t a2p[MPW][NR][2];
  // The warp's m-tiles of its tower: wt, wt + NWT, ... (nmt of them).
  int m0[MPW];
#pragma unroll
  for (int i = 0; i < MPW; ++i) m0[i] = 16 * (wt + i * NWT);
  const int nmt = min(MPW, max(0, (MT - wt + NWT - 1) / NWT));

#ifdef TSDE_STAGE_CLOCKS
  long long mark = clock64();
#endif
  for (int s = n - 1; s >= 0; --s) {
    const size_t srow = size_t(s) * B + row0;    // scratch row of r = 0
    const bool prev = s > 0, first = s == 1 && a.lo == 0;
    const int ci_prev =
        prev ? min(max(__ldg(a.ctx_idx + s - 1), 0), a.T - 1) : 0;
    const float dt_prev = prev ? __ldg(a.dts + s - 1) : 0.f;
    for (int r = tid; r < R; r += NT) ginc[r] += io[2 * L * R + r];

    // B. Layer 1 of the tower on the warp's m-tiles (a1 kept, rounded into
    // act1); then the g nets' output sums, tower t taking the outputs l =
    // t, t + 2, ...
    {
      float acc[MPW][NR][4] = {};
      warp_mma<MPW, NR, true>(acc, w1t, WC, kin, zero, m0, nmt, kin, x, XS,
                              lane);
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
        if (i >= nmt) break;
#pragma unroll
        for (int nt = 0; nt < NR; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = m0[i] + d_row(lane, e);
            a1r[i][nt][e] = j < H ? softplus(acc[i][nt][e] + b1t[j]) : 0.f;
          }
          uint32_t pk[2];
          put_tile(act1t, AS, m0[i], nt, a1r[i][nt], pk, lane);
        }
      }
    }
    for (int l = tw; l < L; l += 2)
      gnet_forward<NTT, R>(l, H, tt, lane, zf, gw1, gb1, gw2,
                           red + ((2 * NWT + wt) * L + l) * R);
    __syncthreads();
    TSDE_MARK(0);

    // C. a1 to the scratch; layer 2 (a2 kept, rounded into act2) and layer
    // 3's sums over the lane's units, then over the warp.
    put_rows<NT, R>(act1, AS, scr + A1F * MH, scr + A1H * MH, srow, H, rows,
                    tr0, c0);
    {
      float acc[MPW][NR][4] = {};
      warp_mma<MPW, NR, true>(acc, w2t, WC, H, zero, m0, nmt, H, act1t, AS,
                              lane);
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
        if (i >= nmt) break;
#pragma unroll
        for (int nt = 0; nt < NR; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = m0[i] + d_row(lane, e);
            a2r[i][nt][e] = j < H ? softplus(acc[i][nt][e] + b2t[j]) : 0.f;
          }
          put_tile(act2t, AS, m0[i], nt, a2r[i][nt], a2p[i][nt], lane);
        }
      }
    }
    for (int l = 0; l < L; ++l) {
      float t[NR][2] = {};
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
        if (i >= nmt) break;
#pragma unroll
        for (int nt = 0; nt < NR; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float w = w3t[(m0[i] + 8 * h + (lane >> 2)) * L + l];
            t[nt][0] = fmaf(lo_f(a2p[i][nt][h]), w, t[nt][0]);
            t[nt][1] = fmaf(hi_f(a2p[i][nt][h]), w, t[nt][1]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NR; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            t[nt][c] += __shfl_xor_sync(0xffffffffu, t[nt][c], off);
          if (lane < 4)
            red[((tw * NWT + wt) * L + l) * R + 8 * nt + 2 * lane + c] =
                t[nt][c];
        }
      }
    }
    __syncthreads();
    TSDE_MARK(1);

    // E. a2 to the scratch. Per row and output: the step's f, h, g, u and
    // the cotangents of f, h and of g's pre-activation (kept rounded, the
    // products' inputs; their sums unrounded); dnoise; dz takes gz.
    put_rows<NT, R>(act2, AS, scr + A2F * MH, scr + A2H * MH, srow, H, rows,
                    tr0, c0);
    for (int e = tid; e < L * R; e += NT) {
      const int l = e / R, r = e % R, row = row0 + r;
      const bool valid = row < B;
      float pf = 0.f, ph = 0.f, pg = 0.f;
      for (int w = 0; w < NWT; ++w) {
        pf += red[((0 * NWT + w) * L + l) * R + r];
        ph += red[((1 * NWT + w) * L + l) * R + r];
        pg += red[((2 * NWT + w) * L + l) * R + r];
      }
      const float f = pf + b3s[l];
      const float h = ph + b3s[L + l];
      const float g = sigmoid(pg + gb2[l]);
      const bool big = g > EPS;
      const float gs = big ? g : EPS;
      const float u = (f - h) / gs;
      const float dz = dzs[e] + io[(L + l) * R + r];
      const float dW = io[l * R + r];
      const size_t at = valid ? (size_t(s) * B + row) * L + l : 0;
      if (valid) dnoise[at] = from_f<bf>(dz * g);
      const float du = ginc[r] * u * dt;
      const float df = dz * dt + du / gs;
      const float dh = -du / gs;
      const float dg = dz * dW - (big ? du * u / gs : 0.f);
      const float d2 = dg * g * (1.f - g);
      dl[(0 * L + l) * R + r] = rnd<bf>(df);
      dl[(1 * L + l) * R + r] = rnd<bf>(dh);
      dl[(2 * L + l) * R + r] = rnd<bf>(d2);
      dzs[e] = dz;
      gacc[3 * L * H + e] += d2;
      bsum3[e] += df;
      bsum3[L * R + e] += dh;
      if (valid) {
        sdf[at] = from_f<bf>(df);
        sdh[at] = from_f<bf>(dh);
      }
    }
    __syncthreads();
    TSDE_MARK(2);

    // F. dpre2 = (dl W3^T) softplus'(a2) on the lane's units (rounded into
    // act2, over a2) and its unit sums; the g nets' backward, tower t taking
    // the outputs l = t, t + 2, ...: their gradients summed on chip, their
    // z-cotangent as per-warp sums.
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (i >= nmt) break;
      float bs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NR; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = m0[i] + d_row(lane, e), r = 8 * nt + d_col(lane, e);
          float da = 0.f;
          for (int l = 0; l < L; ++l)
            da = fmaf(dl[(tw * L + l) * R + r], w3t[j * L + l], da);
          p[e] = da * (1.f - expf(-a2r[i][nt][e]));
        }
        uint32_t pk[2];
        put_tile(act2t, AS, m0[i], nt, p, pk, lane);
        bs[0] += p[0] + p[1];
        bs[1] += p[2] + p[3];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = m0[i] + 8 * h + (lane >> 2);
        quad_sum_add(bs[h], bsum2 + j, j < H, lane);
      }
    }
    for (int l = tw; l < L; l += 2)
      gnet_backward<NTT, R>(l, L, H, tt, lane, zf, dl + (2 * L + l) * R, gw1,
                            gb1, gw2, gacc, red + (wt * L + l) * R);
    __syncthreads();
    TSDE_MARK(3);

    // The step before's inputs start to arrive: the step's own are read for
    // the last time above; they are stored after H.
    uint32_t pf[PF];
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      if constexpr (decoded) {
        if (prev) pf[i] = in_load(in, slot[i], s - 1, first, ci_prev);
      } else {
        const int e = tid + i * NT;
        if (prev && e < E) pf[i] = step_bits<R>(in, e, s - 1, first, ci_prev);
      }
    }

    // G. dpre2 to the scratch; dpre1 = (dpre2 W2^T) softplus'(a1) on the
    // lane's units (rounded into act1, over a1) and its unit sums.
    put_rows<NT, R>(act2, AS, scr + DP2F * MH, scr + DP2H * MH, srow, H,
                    rows, tr0, c0);
    {
      float acc[MPW][NR][4] = {};
      warp_mma<MPW, NR, false>(acc, w2t, WC, H, zero, m0, nmt, H, act2t, AS,
                               lane);
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
        if (i >= nmt) break;
        float bs[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < NR; ++nt) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[e] = acc[i][nt][e] * (1.f - expf(-a1r[i][nt][e]));
          uint32_t pk[2];
          put_tile(act1t, AS, m0[i], nt, p, pk, lane);
          bs[0] += p[0] + p[1];
          bs[1] += p[2] + p[3];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = m0[i] + 8 * h + (lane >> 2);
          quad_sum_add(bs[h], bsum1 + k, k < H, lane);
        }
      }
    }
    __syncthreads();
    TSDE_MARK(4);

    // H. dpre1 to the scratch. Every FLUSH steps of the solve the on-chip
    // sums join the block's partial row (the g nets' as in
    // latent_bwd_sweep; the biases' after G, which adds dpre1's). Then dx =
    // dpre1 W1^T: the m-tiles of f's D inputs and h's L over the warps, the
    // z parts into pdz, the context part into dctx[ctx_idx[s]] (each element
    // by one lane, in step order).
    put_rows<NT, R>(act1, AS, scr + DP1F * MH, scr + DP1H * MH, srow, H,
                    rows, tr0, c0);
    if ((top - s) % FLUSH == 0 || (s == 0 && a.lo == 0)) {
      const bool fst = top - s <= FLUSH;
      for (int e = tid; e < 3 * L * H; e += NT) {
        float* p = part + a.off[12] + e;
        *p = fst ? gacc[e] : *p + gacc[e];
        gacc[e] = 0.f;
      }
      for (int l = tid; l < L; l += NT) {
        float v = 0.f;
        for (int r = 0; r < R; ++r) {
          v += gacc[3 * L * H + l * R + r];
          gacc[3 * L * H + l * R + r] = 0.f;
        }
        float* p = part + a.off[15] + l;
        *p = fst ? v : *p + v;
      }
      for (int e = tid; e < 4 * H; e += NT) {
        const int b = e / H;   // fb1, fb2, hb1, hb2
        float* p = part + a.off[(b >> 1) * 6 + 1 + 2 * (b & 1)] + e % H;
        *p = fst ? bacc[e] : *p + bacc[e];
        bacc[e] = 0.f;
      }
      for (int e = tid; e < 2 * L; e += NT) {
        const int t = e / L, l = e % L;
        float v = 0.f;
        for (int r = 0; r < R; ++r) {
          v += bsum3[(t * L + l) * R + r];
          bsum3[(t * L + l) * R + r] = 0.f;
        }
        float* p = part + a.off[t ? 11 : 5] + l;
        *p = fst ? v : *p + v;
      }
    }
    const int MXF = (D + 15) / 16, MX = MXF + (L + 15) / 16;
    for (int mx = warp; mx < MX; mx += NWARP) {
      const int t = mx < MXF ? 0 : 1, m0 = 16 * (t ? mx - MXF : mx);
      float acc[1][NR][4] = {};
      const int mx0[1] = {m0};
      warp_mma<1, NR, false>(acc, t ? hw1 : fw1, WC, t ? L : D, zero, mx0, 1,
                             H, act1 + t * R * AS, AS, lane);
#pragma unroll
      for (int nt = 0; nt < NR; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = m0 + d_row(lane, e), r = 8 * nt + d_col(lane, e);
          if (k < L)
            pdz[(t * L + k) * R + r] = acc[0][nt][e];
          else if (t == 0 && k < D && r < rows)
            dctx[(size_t(ci) * B + row0 + r) * C + k - L] += acc[0][nt][e];
        }
      }
    }
    if (prev) {
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        if constexpr (decoded) {
          in_store(slot[i], pf[i], x, zf, io);
        } else {
          const int e = tid + i * NT;
          if (e < E) put_step<R>(in, e, pf[i], x, XS, zf, io);
        }
      }
      for (int e = tid + PF * NT; e < E; e += NT)
        put_step<R>(in, e, step_bits<R>(in, e, s - 1, first, ci_prev), x,
                    XS, zf, io);
    }
    __syncthreads();
    TSDE_MARK(5);

    // I. dz takes the z parts of dx (f's, h's) and the g nets'
    // z-cotangents.
    for (int e = tid; e < L * R; e += NT) {
      const int l = e / R, r = e % R;
      float v = dzs[e] + pdz[l * R + r] + pdz[(L + l) * R + r];
      for (int w = 0; w < NWT; ++w) v += red[(w * L + l) * R + r];
      dzs[e] = v;
    }
    ci = ci_prev;
    dt = dt_prev;
    TSDE_MARK(6);
  }
  __syncthreads();

  if (a.carry_out) {              // the window before this one goes on
    for (int e = tid; e < L * R; e += NT) carry[e] = dzs[e];
    for (int e = tid; e < R; e += NT) carry[L * R + e] = ginc[e];
    for (int e = tid; e < GA; e += NT) carry[(L + 1) * R + e] = gacc[e];
    for (int e = tid; e < BA; e += NT)
      carry[(L + 1) * R + GA + e] = bacc[e];
    return;
  }
  for (int e = tid; e < R * L; e += NT) {
    const int r = e / L, l = e % L, row = row0 + r;
    if (row < B) dz0[size_t(row) * L + l] = dzs[l * R + r];
  }
}

// A product of the contraction: out[i][j] = sum over rows m of
// A[m][i] * Bm[m][j], into a chunk's partial row at `out` (row-major, I x J),
// and the bias row out[I][j] = sum over m of Bm[m][j] (the layer's bias
// follows its weight in the partial row).
struct Job {
  size_t a, b, out;   // A's and Bm's offsets in the workspace (a: unused
                      // when A is the context, gathered), out's in a partial
  int ctx_rows;       // A is ctx[ctx_idx[m / B]][m % B] (I = C)
  int I, J, tiles_j, tile0;
};

struct ContractArgs {
  Job job[3];
  int njobs;
  const float* ctx;
  const int* ctx_idx;
  float* ws;
  size_t ws_stride, parts, P;
  int M, B, C, T;
};

// Loads rows [m, m + KS) of a job's A tile (columns i0..i0+TI) and Bm tile
// (columns j0..j0+TJ) into one slab buffer; zero past the chunk's end and
// the matrices' edges.
__device__ __forceinline__ void load_slab(const ContractArgs& a,
                                          const Job& jb, const float* A,
                                          const float* Bm, const float* ctx,
                                          int m, int m1, int i0, int j0,
                                          float* As, float* Bs) {
  for (int e = threadIdx.x; e < KS * TI; e += CT) {
    const int kk = e / TI, i = e % TI, mm = m + kk, gi = i0 + i;
    const bool valid = mm < m1 && gi < jb.I;
    if (jb.ctx_rows) {
      const float* src = ctx;
      if (valid) {
        const int s = mm / a.B, b = mm % a.B;
        const int ci = min(max(a.ctx_idx[s], 0), a.T - 1);
        src = ctx + (size_t(ci) * a.B + b) * a.C + gi;
      }
      stage(As + kk * TI + i, src, valid);
    } else {
      cp_async4(As + kk * TI + i, valid ? A + size_t(mm) * jb.I + gi : A,
                valid);
    }
  }
  for (int e = threadIdx.x; e < KS * TJ; e += CT) {
    const int kk = e / TJ, j = e % TJ, mm = m + kk, gj = j0 + j;
    const bool valid = mm < m1 && gj < jb.J;
    cp_async4(Bs + kk * TJ + j,
              valid ? Bm + size_t(mm) * jb.J + gj : Bm, valid);
  }
  cp_async_commit();
}

// One output tile of one product over one chunk of rows; grid (tiles,
// chunks, replicas). A is the scratch's activations or the context, Bm
// the cotangents, also summed into the bias row.
__global__ void __launch_bounds__(CT)
    latent_bwd_contract(const ContractArgs a) {
  __shared__ __align__(16) float As[2][KS * TI];
  __shared__ __align__(16) float Bs[2][KS * TJ];
  const int tile = blockIdx.x;
  int q = 0;
  while (q + 1 < a.njobs && tile >= a.job[q + 1].tile0) ++q;
  const Job& jb = a.job[q];
  const int local = tile - jb.tile0;
  const int i0 = (local / jb.tiles_j) * TI, j0 = (local % jb.tiles_j) * TJ;
  const int m0 = blockIdx.y * RC, m1 = min(a.M, m0 + RC);
  const size_t rep = blockIdx.z;
  const float* ws = a.ws + rep * a.ws_stride;
  const float* ctx = a.ctx + rep * size_t(a.T) * a.B * a.C;
  const float* A = ws + jb.a;
  const float* Bm = ws + jb.b;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  // Warps 0-3 of the tiles in the first rows sum the bias row, a column a
  // thread, from the slabs in shared memory (a warp-uniform branch).
  const bool bias = i0 == 0 && threadIdx.x < TJ;
  double bsum = 0.0;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int slabs = (m1 - m0 + KS - 1) / KS;
  load_slab(a, jb, A, Bm, ctx, m0, m1, i0, j0, As[0], Bs[0]);
  for (int t = 0; t < slabs; ++t) {
    if (t + 1 < slabs) {
      load_slab(a, jb, A, Bm, ctx, m0 + (t + 1) * KS, m1, i0, j0,
                As[(t + 1) & 1], Bs[(t + 1) & 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = As[t & 1];
    const float* bs = Bs[t & 1];
    if (bias) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) bsum += bs[kk * TJ + threadIdx.x];
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(as + kk * TI + ti * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * TJ + tj * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * TJ + 64 + tj * 4);
      const float av_[4] = {av.x, av.y, av.z, av.w};
      const float bv[8] = {b0.x, b0.y, b0.z,
                           b0.w, b1.x, b1.y,
                           b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av_[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* out = a.ws + rep * a.ws_stride + a.parts + blockIdx.y * a.P + jb.out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ti * 4 + i;
    if (gi >= jb.I) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gj = j0 + (j < 4 ? tj * 4 + j : 64 + tj * 4 + j - 4);
      if (gj < jb.J) out[size_t(gi) * jb.J + gj] = acc[i][j];
    }
  }
  if (bias && j0 + int(threadIdx.x) < jb.J)
    out[size_t(jb.I) * jb.J + j0 + threadIdx.x] = static_cast<float>(bsum);
}

// The contraction in mixed mode, on tensor cores: every product of the
// towers' weights as out = A^T Bm over one chunk of rows, A and Bm bf16 as
// the sweep stored them (or A gathered: the context rows, or z_pre, z0
// rounded or zs), 32-row slabs double-buffered by 16-byte cp.async
// (element by element where a row is not whole 16-byte chunks), 64 x 128
// output tiles, each warp 32 x 32 of them as 2 x 4 m16n8k16 products with A
// and Bm read by ldmatrix.trans. The L-wide products (fw1's z rows, hw1,
// fw3, hw3) are tiles too, zero past their L rows or columns: what they
// cost is the bytes they read, which the tiles read once. No bias rows:
// the sweep sums the biases.
constexpr int CKS = 32;                    // rows of a slab
constexpr int CAS = TI + 8, CBS = TJ + 8;  // slab row strides (bf16)
constexpr int NJOBS16 = 7;
enum Source { FROM_SCRATCH, FROM_CTX, FROM_ZPRE };

struct Job16 {
  size_t a, b, out;   // A's and Bm's offsets in the scratch (bf16), out's
                      // in a partial row
  int src;            // A: the scratch, ctx[ctx_idx[m / B]][m % B], or
                      // z_pre (z0 for the solve's first step, else zs[-1])
  int I, J, tiles_j, tile0;
};

struct ContractArgs16 {
  Job16 job[NJOBS16];
  int njobs;
  const __nv_bfloat16* ctx;
  const int* ctx_idx;
  const float* z0;                 // the solve's z0
  const __nv_bfloat16* zs;         // the window's zs
  size_t zs_stride;                // its replica stride
  int first;                       // the window starts at the solve's first
                                   // step
  float* ws;
  size_t ws_stride, parts, P;
  int M, B, C, T, L;
};

// Row mm's element gi of a job's A for replica rep (the caller has checked
// mm and gi), as bf16.
__device__ __forceinline__ __nv_bfloat16 a_elem(const ContractArgs16& a,
                                                const Job16& jb,
                                                const __nv_bfloat16* A,
                                                size_t rep, int mm, int gi) {
  if (jb.src == FROM_SCRATCH) return A[size_t(mm) * jb.I + gi];
  const int s = mm / a.B, b = mm % a.B;
  if (jb.src == FROM_CTX) {
    const int ci = min(max(a.ctx_idx[s], 0), a.T - 1);
    return a.ctx[rep * size_t(a.T) * a.B * a.C +
                 (size_t(ci) * a.B + b) * a.C + gi];
  }
  if (s == 0 && a.first)
    return __float2bfloat16_rn(a.z0[(rep * a.B + b) * a.L + gi]);
  return a.zs[rep * a.zs_stride + (ptrdiff_t(mm) - a.B) * a.L + gi];
}

__device__ __forceinline__ void load_slab_bf16(
    const ContractArgs16& a, const Job16& jb, const __nv_bfloat16* A,
    const __nv_bfloat16* Bm, size_t rep, int m, int m1, int i0, int j0,
    __nv_bfloat16* As, __nv_bfloat16* Bs) {
  using bf = __nv_bfloat16;
  const bf zb = __ushort_as_bfloat16(0);
  const bool whole = jb.src != FROM_ZPRE && jb.I % 8 == 0;
  for (int e = threadIdx.x; e < CKS * (TI / 8); e += CT) {
    const int kk = e / (TI / 8), c = e % (TI / 8), mm = m + kk;
    const int gi = i0 + 8 * c;
    bf* dst = As + kk * CAS + 8 * c;
    if (whole) {
      const bool valid = mm < m1 && gi < jb.I;
      const bf* src = A;
      if (valid && jb.src == FROM_CTX) {
        const int s = mm / a.B, b = mm % a.B;
        const int ci = min(max(a.ctx_idx[s], 0), a.T - 1);
        src = a.ctx + rep * size_t(a.T) * a.B * a.C +
              (size_t(ci) * a.B + b) * a.C + gi;
      } else if (valid) {
        src = A + size_t(mm) * jb.I + gi;
      }
      tsde_bf16::cp_async16(dst, src, valid);
    } else {
      for (int u = 0; u < 8; ++u)
        dst[u] = mm < m1 && gi + u < jb.I ? a_elem(a, jb, A, rep, mm, gi + u)
                                          : zb;
    }
  }
  for (int e = threadIdx.x; e < CKS * (TJ / 8); e += CT) {
    const int kk = e / (TJ / 8), c = e % (TJ / 8), mm = m + kk;
    const int gj = j0 + 8 * c;
    const bf* src = mm < m1 ? Bm + size_t(mm) * jb.J : Bm;
    bf* dst = Bs + kk * CBS + 8 * c;
    if (jb.J % 8 == 0) {
      const bool valid = mm < m1 && gj < jb.J;
      tsde_bf16::cp_async16(dst, valid ? src + gj : src, valid);
    } else {
      for (int u = 0; u < 8; ++u)
        dst[u] = mm < m1 && gj + u < jb.J ? src[gj + u] : zb;
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(CT)
    latent_bwd_contract_bf16(const ContractArgs16 a) {
  using namespace tsde_bf16;
  using bf = __nv_bfloat16;
  __shared__ __align__(16) bf As[2][CKS * CAS];
  __shared__ __align__(16) bf Bs[2][CKS * CBS];
  const int tile = blockIdx.x;
  int q = 0;
  while (q + 1 < a.njobs && tile >= a.job[q + 1].tile0) ++q;
  const Job16& jb = a.job[q];
  const int local = tile - jb.tile0;
  const int i0 = (local / jb.tiles_j) * TI, j0 = (local % jb.tiles_j) * TJ;
  const int m0 = blockIdx.y * RC, m1 = min(a.M, m0 + RC);
  const size_t rep = blockIdx.z;
  const bf* sc = reinterpret_cast<const bf*>(a.ws + rep * a.ws_stride);
  const bf* A = sc + jb.a;
  const bf* Bm = sc + jb.b;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wi = 32 * (warp >> 2), wj = 32 * (warp & 3);

  float acc[2][4][4] = {};
  const int slabs = (m1 - m0 + CKS - 1) / CKS;
  load_slab_bf16(a, jb, A, Bm, rep, m0, m1, i0, j0, As[0], Bs[0]);
  for (int t = 0; t < slabs; ++t) {
    if (t + 1 < slabs) {
      load_slab_bf16(a, jb, A, Bm, rep, m0 + (t + 1) * CKS, m1, i0, j0,
                     As[(t + 1) & 1], Bs[(t + 1) & 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf* as = As[t & 1];
    const bf* bs = Bs[t & 1];
#pragma unroll
    for (int k0 = 0; k0 < CKS; k0 += 16) {
      uint32_t af[2][4], bq[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_trans(af[mi], as + x4_offset(lane, k0, wi + 16 * mi, CAS,
                                             kColsFirst));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_trans(bq[np], bs + x4_offset(lane, k0, wj + 16 * np, CBS,
                                             kRowsFirst));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], af[mi], bq[ni >> 1][2 * (ni & 1)],
              bq[ni >> 1][2 * (ni & 1) + 1]);
      }
    }
    __syncthreads();
  }
  float* out = a.ws + rep * a.ws_stride + a.parts + blockIdx.y * a.P + jb.out;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gi = i0 + wi + 16 * mi + d_row(lane, e);
        const int gj = j0 + wj + 8 * ni + d_col(lane, e);
        if (gi < jb.I && gj < jb.J)
          out[size_t(gi) * jb.J + gj] = acc[mi][ni][e];
      }
    }
  }
}

// A product with an L-wide side: out = W^T S, W (M, H) in the workspace,
// S (M, L) either in the workspace or z_pre (z0 for the first B rows, zs
// after), stored [l][c] (z rows of layer 1) or [c][l] (layer 3). A column
// of ones appended to S (ones_s) or to W (ones_w) gives the bias that
// follows the weight: hb1 = the sum of dpre1h, fb3 = the sum of df.
struct SkinnyJob {
  size_t w, s, out;
  int z_pre;          // S is z_pre, gathered from z0 and zs
  int by_column;      // out[c][l] rather than out[l][c]
  int ones_s, ones_w;
};

struct SkinnyArgs {
  SkinnyJob job[4];
  const float* z0;       // the solve's z0
  const float* zs;       // the window's zs
  size_t zs_stride;      // its replica stride
  int first;             // the window starts at the solve's first step
  float* ws;
  size_t ws_stride, parts, P;
  int M, B, L, H;
};

// A thread a column c of W, summing over one chunk of rows in row order;
// grid (jobs, chunks, replicas). Each thread loads SKB rows of its column
// before it adds them, so that many loads are in flight at once. float32
// only: mixed mode's L-wide products are latent_bwd_contract_bf16's.
__global__ void __launch_bounds__(CT) latent_bwd_skinny(const SkinnyArgs a) {
  const SkinnyJob& jb = a.job[blockIdx.x];
  const int m0 = blockIdx.y * RC, m1 = min(a.M, m0 + RC);
  const size_t rep = blockIdx.z;
  const int L = a.L, H = a.H;
  const float* ws = a.ws + rep * a.ws_stride;
  const float* Wm = ws + jb.w;
  const float* S = ws + jb.s;
  const float* z0 = a.z0 + rep * size_t(a.B) * L;
  const float* zs = a.zs + rep * a.zs_stride;
  float* out = a.ws + rep * a.ws_stride + a.parts + blockIdx.y * a.P + jb.out;
  for (int c = threadIdx.x; c < H + jb.ones_w; c += CT) {
    for (int l0 = 0; l0 < L; l0 += 4) {
      const bool ones = jb.ones_s && l0 == 0;   // S's column of ones
      double acc[4] = {0.0, 0.0, 0.0, 0.0}, bias = 0.0;
      for (int m = m0; m < m1; m += SKB) {
        float w[SKB];
#pragma unroll
        for (int u = 0; u < SKB; ++u) {
          const bool in = m + u < m1;
          w[u] = !in ? 0.f : c < H ? Wm[size_t(m + u) * H + c] : 1.f;
        }
#pragma unroll
        for (int u = 0; u < SKB; ++u) {
          const int mm = min(m + u, m1 - 1);
          // S's row: z_pre is z0 at the solve's first step, else the
          // state before (zs[-1] of a later window: the window before's).
          const bool from_z0 = mm < a.B && a.first;
          const float* zrow = zs + (ptrdiff_t(mm) - a.B) * L;
          const float* srow = !jb.z_pre ? S + size_t(mm) * L
                              : from_z0 ? z0 + size_t(mm) * L : zrow;
          const double wu = w[u];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (l0 + i < L) {
              const double sv = __ldg(srow + l0 + i);
              acc[i] = fma(wu, sv, acc[i]);
            }
          }
          if (ones) bias += wu;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + i;
        if (l < L)
          out[jb.by_column ? size_t(c) * L + l : size_t(l) * H + c] =
              static_cast<float>(acc[i]);
      }
      if (ones) out[size_t(L) * H + c] = static_cast<float>(bias);
    }
  }
}

// dw[e] = the float64 sum of the partial rows that hold element e, in row
// order: the contraction's chunks for the towers f and h (weights 0-11),
// added to the earlier windows' sums (none for the `first`), the sweep's
// blocks for the weights the sweep sums (`swept`, a bit a weight: the g
// nets', and in mixed mode the towers' biases too; after the `last` window
// only); replica blockIdx.y sums its own workspace into its own row of dw,
// or, before the last window, the contraction's elements into its float64
// sums.
struct ReduceArgs {
  size_t off[NW];
  const float* ws;
  size_t ws_stride, parts, sums, P;
  int chunks, blocks, first, last;
  unsigned swept;
  float* dw;
};

// The weights the sweep sums on chip: the g nets' (12-15), and in mixed
// mode the towers' biases (1, 3, 5, 7, 9, 11).
constexpr unsigned SWEPT_G = 0xf000u, SWEPT_BIASES = 0x0aaau;

__global__ void latent_bwd_reduce(const ReduceArgs a) {
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= a.P) return;
  int w = 0;
  while (w + 1 < NW && e >= a.off[w + 1]) ++w;
  const bool swept = (a.swept >> w) & 1u;
  if (swept && !a.last) return;
  const float* ws = a.ws + blockIdx.y * a.ws_stride;
  double* sums = reinterpret_cast<double*>(const_cast<float*>(ws) + a.sums);
  const int rows = swept ? a.blocks : a.chunks;
  const float* p = ws + a.parts + e;
  double acc = !swept && !a.first ? sums[e] : 0.0;
  for (int b = 0; b < rows; ++b) acc += p[size_t(b) * a.P];
  if (a.last)
    a.dw[blockIdx.y * a.P + e] = static_cast<float>(acc);
  else
    sums[e] = acc;
}

// Element counts of the workspace of one replica for windows of W steps:
// the scratch of W x B rows, then max(chunks, blocks) partial rows of P
// floats, the sweep blocks' carried chains and the float64 sums of the
// towers' gradients (P doubles, on an even float). Blocks at SWEEP_ROWS
// rows a block: the most of any launch<NT, R> with R >= SWEEP_ROWS, whose
// carry is the largest. In mixed mode (`mixed`) the scratch is bf16, half
// as many floats, each block's carry holds the bias sums too, and the
// scratch and the whole are rounded up to 4 floats, so that every
// replica's scratch starts on 16 bytes.
struct Sizes {
  size_t P, parts, carry, sums, total;
  int blocks;
};

__host__ inline Sizes sizes_of(int B, int L, int C, int H, int W,
                               bool mixed = false) {
  Sizes z;
  size_t w[NW];
  weight_sizes(L, C, H, w);
  z.P = 0;
  for (int i = 0; i < NW; ++i) z.P += w[i];
  const size_t M = size_t(W) * B;
  const int chunks = static_cast<int>((M + RC - 1) / RC);
  z.blocks = (B + SWEEP_ROWS - 1) / SWEEP_ROWS;   // the most sweep blocks
  z.parts = M * (NSCRATCH * size_t(H) + 2 * size_t(L));
  if (mixed) z.parts = (z.parts / 2 + 3) & ~size_t(3);
  const size_t rows = chunks > z.blocks ? chunks : z.blocks;
  z.carry = z.parts + rows * z.P;
  const size_t each = mixed ? carry_floats_bf16(L, H, SWEEP_ROWS)
                            : carry_floats(L, H, SWEEP_ROWS);
  z.sums = (z.carry + size_t(z.blocks) * each + 1) & ~size_t(1);
  z.total = z.sums + 2 * z.P;
  if (mixed) z.total = (z.total + 3) & ~size_t(3);
  return z;
}

template <int NT, int R>
int launch_sweep(const Args<float>& a, int K, cudaStream_t stream) {
  const size_t smem = make_layout(a.L, a.C, a.H, NT, R).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      latent_bwd_sweep<NT, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.B + R - 1) / R;
  latent_bwd_sweep<NT, R><<<dim3(blocks, K), NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 sweep's instantiation for these widths: MPW m-tiles a warp
// covers H up to 16 MPW NT / 64; 2 at the flagship. `query`: return, rather
// than launch, the blocks an SM its shared memory and registers allow.
template <int NT, int R, int MPW, int MINB>
int launch_sweep_bf16_mpw(const Args<__nv_bfloat16>& a, int K,
                          cudaStream_t stream, bool query) {
  auto kernel = latent_bwd_sweep_bf16<NT, R, MPW, MINB>;
  const size_t smem = make_bf16_layout(a.L, a.C, a.H, NT, R).total;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return query ? -static_cast<int>(err)
                                       : static_cast<int>(err);
  if (query) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NT,
                                                        smem);
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
  }
  const int blocks = (a.B + R - 1) / R;
  kernel<<<dim3(blocks, K), NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// MINB = 0: registers for two blocks an SM where the grid has more blocks
// than the card has SMs, else for one (the same arithmetic either way).
template <int NT, int R, int MINB>
int launch_sweep_bf16(const Args<__nv_bfloat16>& a, int K,
                      cudaStream_t stream, bool query = false) {
  const int mt = tsde_bf16::pad16(a.H) / 16, nwt = NT / 64;
  if constexpr (MINB == 0) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const bool full = (a.B + R - 1) / R * K > sms;
    return full ? launch_sweep_bf16<NT, R, 2>(a, K, stream, query)
                : launch_sweep_bf16<NT, R, 1>(a, K, stream, query);
  } else {
    if (mt <= 2 * nwt)
      return launch_sweep_bf16_mpw<NT, R, 2, MINB>(a, K, stream, query);
    if (mt <= 4 * nwt)   // wider towers: one block an SM
      return launch_sweep_bf16_mpw<NT, R, 4, 1>(a, K, stream, query);
    return query ? -static_cast<int>(cudaErrorInvalidValue)
                 : static_cast<int>(cudaErrorInvalidValue);
  }
}

// The contraction and the reduction of a window (a: its arguments, as the
// sweep's), on a workspace the sweep has filled with `blocks` partial rows.
// The reduction of a window's partial rows into dw (the weights the sweep
// sums: `swept`).
template <typename W>
int launch_reduce(const Args<W>& a, int chunks, int blocks, int K,
                  unsigned swept, float* dw, cudaStream_t stream) {
  ReduceArgs r;
  for (int i = 0; i < NW; ++i) r.off[i] = a.off[i];
  r.ws = a.ws;
  r.ws_stride = a.ws_stride;
  r.parts = a.parts;
  r.sums = a.sums;
  r.P = a.P;
  r.chunks = chunks;
  r.blocks = blocks;
  r.first = a.n_all - a.lo == a.n;    // the solve's last steps
  r.last = a.lo == 0;
  r.swept = swept;
  r.dw = dw;
  constexpr int RT = 256;
  latent_bwd_reduce<<<dim3(static_cast<unsigned>((a.P + RT - 1) / RT), K),
                      RT, 0, stream>>>(r);
  return static_cast<int>(cudaGetLastError());
}

// The contraction and the reduction of a window in mixed mode: the seven
// products as latent_bwd_contract_bf16's tiles.
inline int launch_contraction_bf16(const Args<__nv_bfloat16>& a, int blocks,
                                   int K, float* dw, cudaStream_t stream) {
  const int L = a.L, C = a.C, H = a.H;
  const size_t M = size_t(a.n) * a.B, MH = M * H;
  const int chunks = static_cast<int>((M + RC - 1) / RC);
  const size_t df = NSCRATCH * MH, dh = df + M * L;
  // (src, A, Bm, out, I, J): fw1's context rows, fw2, hw2, fw1's z rows,
  // hw1, fw3, hw3.
  const struct {
    int src;
    size_t a, b, out;
    int I, J;
  } jobs[NJOBS16] = {
      {FROM_CTX, 0, DP1F * MH, a.off[0] + size_t(L) * H, C, H},
      {FROM_SCRATCH, A1F * MH, DP2F * MH, a.off[2], H, H},
      {FROM_SCRATCH, A1H * MH, DP2H * MH, a.off[8], H, H},
      {FROM_ZPRE, 0, DP1F * MH, a.off[0], L, H},
      {FROM_ZPRE, 0, DP1H * MH, a.off[6], L, H},
      {FROM_SCRATCH, A2F * MH, df, a.off[4], H, L},
      {FROM_SCRATCH, A2H * MH, dh, a.off[10], H, L}};
  ContractArgs16 c;
  int tiles = 0;
  for (int q = 0; q < NJOBS16; ++q) {
    Job16& jb = c.job[q];
    jb.src = jobs[q].src;
    jb.a = jobs[q].a;
    jb.b = jobs[q].b;
    jb.out = jobs[q].out;
    jb.I = jobs[q].I;
    jb.J = jobs[q].J;
    jb.tiles_j = (jb.J + TJ - 1) / TJ;
    jb.tile0 = tiles;
    tiles += ((jb.I + TI - 1) / TI) * jb.tiles_j;
  }
  c.njobs = NJOBS16;
  c.ctx = a.ctx;
  c.ctx_idx = a.ctx_idx;
  c.z0 = a.z0;
  c.zs = a.zs;
  c.zs_stride = size_t(a.n_all) * a.B * L;
  c.first = a.lo == 0;
  c.ws = a.ws;
  c.ws_stride = a.ws_stride;
  c.parts = a.parts;
  c.P = a.P;
  c.M = static_cast<int>(M);
  c.B = a.B;
  c.C = C;
  c.T = a.T;
  c.L = L;
  latent_bwd_contract_bf16<<<dim3(tiles, chunks, K), CT, 0, stream>>>(c);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce(a, chunks, blocks, K, SWEPT_G | SWEPT_BIASES, dw,
                       stream);
}

inline int launch_contraction(const Args<float>& a, int blocks, int K,
                              float* dw, cudaStream_t stream) {
  const int L = a.L, C = a.C, H = a.H;
  const size_t M = size_t(a.n) * a.B, MH = M * H;
  const int chunks = static_cast<int>((M + RC - 1) / RC);
  ContractArgs c;
  // fw1's context rows (weight rows L..D-1) and fb1, fw2 and fb2, hw2 and
  // hb2.
  const size_t a_of[3] = {0, A1F * MH, A1H * MH};
  const size_t b_of[3] = {DP1F * MH, DP2F * MH, DP2H * MH};
  const size_t out_of[3] = {a.off[0] + size_t(L) * H, a.off[2], a.off[8]};
  const int rows_of[3] = {C, H, H};
  int tiles = 0;
  for (int q = 0; q < 3; ++q) {
    Job& jb = c.job[q];
    jb.a = a_of[q];
    jb.b = b_of[q];
    jb.out = out_of[q];
    jb.ctx_rows = q == 0;
    jb.I = rows_of[q];
    jb.J = H;
    jb.tiles_j = (H + TJ - 1) / TJ;
    jb.tile0 = tiles;
    tiles += ((jb.I + TI - 1) / TI) * jb.tiles_j;
  }
  c.njobs = 3;
  c.ctx = a.ctx;
  c.ctx_idx = a.ctx_idx;
  c.ws = a.ws;
  c.ws_stride = a.ws_stride;
  c.parts = a.parts;
  c.P = a.P;
  c.M = static_cast<int>(M);
  c.B = a.B;
  c.C = C;
  c.T = a.T;
  latent_bwd_contract<<<dim3(tiles, chunks, K), CT, 0, stream>>>(c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  SkinnyArgs s;
  const size_t df = NSCRATCH * MH, dh = df + M * L;
  const SkinnyJob jobs[4] = {
      {DP1F * MH, 0, a.off[0], 1, 0, 0, 0},    // fw1's z rows
      {DP1H * MH, 0, a.off[6], 1, 0, 1, 0},    // hw1 and hb1
      {A2F * MH, df, a.off[4], 0, 1, 0, 1},    // fw3 and fb3
      {A2H * MH, dh, a.off[10], 0, 1, 0, 1}};  // hw3 and hb3
  for (int q = 0; q < 4; ++q) s.job[q] = jobs[q];
  s.z0 = a.z0;
  s.zs = a.zs;
  s.zs_stride = size_t(a.n_all) * a.B * L;
  s.first = a.lo == 0;
  s.ws = a.ws;
  s.ws_stride = a.ws_stride;
  s.parts = a.parts;
  s.P = a.P;
  s.M = static_cast<int>(M);
  s.B = a.B;
  s.L = L;
  s.H = H;
  latent_bwd_skinny<<<dim3(4, chunks, K), CT, 0, stream>>>(s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce(a, chunks, blocks, K, SWEPT_G, dw, stream);
}

// Launches, for K stacked solves (K = 1: a single solve), on `stream`,
// over windows of `window` steps, last first: for `stages` bit 0 the sweep
// at NT threads and R rows a block, for bit 1 the contraction and the
// reduction on the workspace such a sweep filled (both bits: any window;
// one bit alone: one window, the whole solve); returns cudaGetLastError()
// (0 on success). In mixed mode the sweep is latent_bwd_sweep_bf16,
// registers for MINB blocks an SM (0: as the grid fills the card).
template <int NT, int R, typename W, int MINB = 0>
int launch(Args<W> a, int K, float* dw, int stages, int window, int device,
           cudaStream_t stream) {
  constexpr bool mixed = sizeof(W) < sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K <= 0 || a.B <= 0 || a.n <= 0) return 0;
  if (window <= 0 || (stages != 3 && window < a.n))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t sizes[NW];
  weight_sizes(a.L, a.C, a.H, sizes);
  size_t P = 0;
  for (int i = 0; i < NW; ++i) {
    a.off[i] = P;
    P += sizes[i];
  }
  const int B = a.B, L = a.L, n = a.n;
  const Sizes z = sizes_of(B, L, a.C, a.H, window < n ? window : n, mixed);
  a.P = z.P;
  a.ws_stride = z.total;
  a.parts = z.parts;
  a.carry = z.carry;
  a.sums = z.sums;
  a.n_all = n;
  // Each window sees its own steps [lo, hi) as steps 0 to n - 1: the
  // per-step arrays from step lo on (z_pre of step lo: z0, or zs[lo - 1]
  // just before the window's zs).
  for (int hi = n; hi > 0; hi -= window) {
    const int lo = hi > window ? hi - window : 0;
    const size_t at = size_t(lo) * B * L;
    Args<W> wa = a;
    wa.ctx_idx = a.ctx_idx + lo;
    wa.noise = a.noise + at;
    wa.dts = a.dts + lo;
    wa.zs = a.zs + at;
    wa.gz = a.gz + at;
    wa.gq = a.gq + size_t(lo) * B;
    wa.dnoise = a.dnoise + at;
    wa.n = hi - lo;
    wa.lo = lo;
    wa.carry_in = hi < n;
    wa.carry_out = lo > 0;
    if (stages & 1) {
      int rc;
      if constexpr (mixed)
        rc = launch_sweep_bf16<NT, R, MINB>(wa, K, stream);
      else
        rc = launch_sweep<NT, R>(wa, K, stream);
      if (rc != 0) return rc;
    }
    if (stages & 2) {
      int rc;
      if constexpr (mixed)
        rc = launch_contraction_bf16(wa, (B + R - 1) / R, K, dw, stream);
      else
        rc = launch_contraction(wa, (B + R - 1) / R, K, dw, stream);
      if (rc != 0) return rc;
    }
  }
  return 0;
}

template <typename W>
Args<W> make_args(const float* z0, const W* ctx, const int* ctx_idx,
                  const W* noise, const float* dts, const W* const* w,
                  const W* zs, const W* gz, const float* gq, float* dz0,
                  float* dctx, W* dnoise, float* ws, int B, int L, int C,
                  int H, int T, int n) {
  Args<W> a;
  a.z0 = z0; a.ctx = ctx; a.ctx_idx = ctx_idx; a.noise = noise; a.dts = dts;
  for (int i = 0; i < NW; ++i) a.w[i] = w[i];
  a.zs = zs; a.gz = gz; a.gq = gq;
  a.dz0 = dz0; a.dctx = dctx; a.dnoise = dnoise; a.ws = ws;
  a.B = B; a.L = L; a.C = C; a.H = H; a.T = T; a.n = n;
  return a;
}

}  // namespace tsde_latent_bwd

extern "C" {

// Dynamic shared memory one block of the sweep needs for these widths, at
// the sweep's block size.
size_t tsde_latent_fused_bwd_smem_bytes(int L, int C, int H) {
  using namespace tsde_latent_bwd;
  return make_layout(L, C, H, SWEEP_THREADS, SWEEP_ROWS).total * sizeof(float);
}

// Floats of one replica's workspace for windows of W steps: the scratch
// tensors (W x B x (8H + 2L)), the partial rows, the sweep blocks' carried
// chains and the float64 sums of the windows.
size_t tsde_latent_fused_bwd_workspace(int B, int L, int C, int H, int W) {
  return tsde_latent_bwd::sizes_of(B, L, C, H, W).total;
}

// The same in mixed mode: the scratch in bf16 (W x B x (4H + L) floats).
size_t tsde_latent_fused_bwd_workspace_bf16(int B, int L, int C, int H,
                                            int W) {
  return tsde_latent_bwd::sizes_of(B, L, C, H, W, true).total;
}

// Dynamic shared memory one block of the bf16 sweep needs for these widths.
size_t tsde_latent_fused_bwd_smem_bytes_bf16(int L, int C, int H) {
  using namespace tsde_latent_bwd;
  return make_bf16_layout(L, C, H, SWEEP_THREADS, SWEEP_ROWS).total;
}

// Blocks of the bf16 sweep an SM of `device` holds at these widths (its
// shared memory and registers) in a grid of `blocks` blocks (the
// instantiation such a grid launches), or minus a CUDA error.
int tsde_latent_fused_bwd_blocks_per_sm_bf16(int L, int C, int H, int blocks,
                                             int device) {
  using namespace tsde_latent_bwd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  Args<__nv_bfloat16> a{};
  a.B = blocks * SWEEP_ROWS;
  a.L = L;
  a.C = C;
  a.H = H;
  return launch_sweep_bf16<SWEEP_THREADS, SWEEP_ROWS, 0>(a, 1, 0, true);
}

// Launches, over windows of `window` steps, last first, the sweep, the
// contraction and the reduction on `stream` and returns cudaGetLastError()
// (0 on success). All pointers are device pointers to contiguous float32
// arrays, ctx_idx int32; weights in the order of latent_fused.WEIGHT_NAMES.
// dctx must be zeroed; ws holds tsde_latent_fused_bwd_workspace(B, L, C, H,
// window) floats and dw P floats, P the weights' total element count; dw
// receives their gradients back to back. The _bf16 entry points take bf16
// mixed mode: ctx, noise, the weights, zs, gz and dnoise bf16, the rest
// (dctx and dw too, summed in float32) as here.
int tsde_latent_fused_bwd(
    const float* z0, const float* ctx, const int* ctx_idx, const float* noise,
    const float* dts, TSDE_WEIGHT_PARAMS, const float* zs, const float* gz,
    const float* gq, float* dz0, float* dctx, float* dnoise, float* ws,
    float* dw, int B, int L, int C, int H, int T, int n, int window,
    int device, cudaStream_t stream) {
  using namespace tsde_latent_bwd;
  const float* w[NW] = TSDE_WEIGHTS;
  const Args a = make_args(z0, ctx, ctx_idx, noise, dts, w, zs, gz, gq, dz0,
                           dctx, dnoise, ws, B, L, C, H, T, n);
  return launch<SWEEP_THREADS, SWEEP_ROWS>(a, 1, dw, 3, window, device,
                                           stream);
}

// The same for K stacked replicas in one launch of each phase a window:
// every per-replica array has a leading K axis (see
// tsde_latent_fused_fwd_multi), ws holds K workspaces and dw K x P: each
// replica's weight gradients, summed over its own chunks and blocks in
// order. The window depends on one replica's shapes only, so replica k's
// outputs are bitwise those of a single solve on its inputs.
int tsde_latent_fused_bwd_multi(
    const float* z0, const float* ctx, const int* ctx_idx, const float* noise,
    const float* dts, TSDE_WEIGHT_PARAMS, const float* zs, const float* gz,
    const float* gq, float* dz0, float* dctx, float* dnoise, float* ws,
    float* dw, int K, int B, int L, int C, int H, int T, int n, int window,
    int device, cudaStream_t stream) {
  using namespace tsde_latent_bwd;
  const float* w[NW] = TSDE_WEIGHTS;
  const Args a = make_args(z0, ctx, ctx_idx, noise, dts, w, zs, gz, gq, dz0,
                           dctx, dnoise, ws, B, L, C, H, T, n);
  return launch<SWEEP_THREADS, SWEEP_ROWS>(a, K, dw, 3, window, device,
                                           stream);
}

// tsde_latent_fused_bwd_multi's phases one at a time, for measurement:
// `stages` bit 0 the sweep, bit 1 the contraction and the reduction on the
// workspace a sweep left; either alone needs one window (window >= n).
int tsde_latent_fused_bwd_stages(
    const float* z0, const float* ctx, const int* ctx_idx, const float* noise,
    const float* dts, TSDE_WEIGHT_PARAMS, const float* zs, const float* gz,
    const float* gq, float* dz0, float* dctx, float* dnoise, float* ws,
    float* dw, int K, int B, int L, int C, int H, int T, int n, int window,
    int stages, int device, cudaStream_t stream) {
  using namespace tsde_latent_bwd;
  const float* w[NW] = TSDE_WEIGHTS;
  const Args a = make_args(z0, ctx, ctx_idx, noise, dts, w, zs, gz, gq, dz0,
                           dctx, dnoise, ws, B, L, C, H, T, n);
  return launch<SWEEP_THREADS, SWEEP_ROWS>(a, K, dw, stages, window, device,
                                           stream);
}

#define TSDE_BWD_BF16_PARAMS                                                 \
  const float *z0, const __nv_bfloat16 *ctx, const int *ctx_idx,             \
      const __nv_bfloat16 *noise, const float *dts,                          \
      TSDE_WEIGHT_PARAMS_T(__nv_bfloat16), const __nv_bfloat16 *zs,          \
      const __nv_bfloat16 *gz, const float *gq, float *dz0, float *dctx,     \
      __nv_bfloat16 *dnoise, float *ws, float *dw

int tsde_latent_fused_bwd_bf16(TSDE_BWD_BF16_PARAMS, int B, int L, int C,
                               int H, int T, int n, int window, int device,
                               cudaStream_t stream) {
  using namespace tsde_latent_bwd;
  const __nv_bfloat16* w[NW] = TSDE_WEIGHTS;
  const auto a = make_args(z0, ctx, ctx_idx, noise, dts, w, zs, gz, gq, dz0,
                           dctx, dnoise, ws, B, L, C, H, T, n);
  return launch<SWEEP_THREADS, SWEEP_ROWS>(a, 1, dw, 3, window, device,
                                           stream);
}

int tsde_latent_fused_bwd_multi_bf16(TSDE_BWD_BF16_PARAMS, int K, int B,
                                     int L, int C, int H, int T, int n,
                                     int window, int device,
                                     cudaStream_t stream) {
  using namespace tsde_latent_bwd;
  const __nv_bfloat16* w[NW] = TSDE_WEIGHTS;
  const auto a = make_args(z0, ctx, ctx_idx, noise, dts, w, zs, gz, gq, dz0,
                           dctx, dnoise, ws, B, L, C, H, T, n);
  return launch<SWEEP_THREADS, SWEEP_ROWS>(a, K, dw, 3, window, device,
                                           stream);
}

int tsde_latent_fused_bwd_stages_bf16(TSDE_BWD_BF16_PARAMS, int K, int B,
                                      int L, int C, int H, int T, int n,
                                      int window, int stages, int device,
                                      cudaStream_t stream) {
  using namespace tsde_latent_bwd;
  const __nv_bfloat16* w[NW] = TSDE_WEIGHTS;
  const auto a = make_args(z0, ctx, ctx_idx, noise, dts, w, zs, gz, gq, dz0,
                           dctx, dnoise, ws, B, L, C, H, T, n);
  return launch<SWEEP_THREADS, SWEEP_ROWS>(a, K, dw, stages, window, device,
                                           stream);
}

}  // extern "C"
