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
// cotangents themselves stay float32. The scratch keeps a1 and a2 rounded
// (only the products read them) and the cotangents float32 (the biases'
// gradients sum them unrounded), so the workspace is the float32 one; the
// contraction rounds the cotangents as it multiplies. dctx and every weight
// gradient are summed in float32 and rounded to bf16 once, by the caller;
// dnoise goes out in bf16. The weights are widened into shared memory as
// in latent_fused_fwd.cu.
//
// K stacked replicas (tsde_latent_fused_bwd_multi) replace the Pallas
// kernel _bwd_kernel_multi (launched by _fused_solve_multi_bwd_impl). The
// replica is the sweep's grid y axis and the contraction's z axis, and each
// replica has its own workspace (scratch and partials), so replica k's
// gradients are bitwise those of a single call on its inputs.

#include <cuda_runtime.h>
#include <stddef.h>

#include "latent_fused_common.cuh"

namespace tsde_latent_bwd {

using namespace tsde_latent;

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

// (rows, cols) row-major into shared memory with row stride ld, widened
// to float.
template <int NT, typename W>
__device__ __forceinline__ void copy_rows(float* dst, const W* src,
                                          int rows, int cols, int ld) {
  for (int e = threadIdx.x; e < rows * cols; e += NT)
    dst[(e / cols) * ld + e % cols] = to_f(src[e]);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows of step s's inputs for the tile at row0: x = [pre-step z | context
// row ctx_idx[s]] as [k][r] (z as a product's input: rounded to W), noise
// and gz as [l][r], gq as [r]; rows past the batch are zero-filled. The
// pre-step z is z0 at the solve's first step (`first`: s == 0 of the
// window from step 0), else the state after the step before, zs[s - 1]
// (before a later window's first step: the last state of the window
// before it).
template <int NT, int R, typename W>
__device__ __forceinline__ void prefetch_step(
    int s, bool first, float* xb, float* iob, const float* z0, const W* zs,
    const W* ctx, const int* ctx_idx, const W* noise, const W* gz,
    const float* gq, int row0, int B, int L, int C, int T) {
  const int D = L + C;
  const W* zpre = zs + ptrdiff_t(s - 1) * B * L;
  const int ci = min(max(ctx_idx[s], 0), T - 1);
  const W* cst = ctx + size_t(ci) * B * C;
  for (int e = threadIdx.x; e < R * D; e += NT) {
    const int r = e / D, k = e % D, row = row0 + r;
    const bool valid = row < B;
    float* dst = xb + k * R + r;
    if (k >= L)
      stage(dst, valid ? cst + size_t(row) * C + (k - L) : ctx, valid);
    else if (first)
      stage_rounded<W>(dst, valid ? z0 + size_t(row) * L + k : z0, valid);
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
template <int NT, int R, typename W>
__global__ void __launch_bounds__(NT, 1) latent_bwd_sweep(const Args<W> a) {
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
  const W* ctx = a.ctx + rep * a.T * B * C;
  const W* noise = a.noise + rep * steps;
  const W* zs = a.zs + rep * steps;
  const W* gz = a.gz + rep * steps;
  const float* gq = a.gq + rep * a.n_all * B;
  float* dz0 = a.dz0 + rep * B * L;
  float* dctx = a.dctx + rep * a.T * B * C;
  W* dnoise = a.dnoise + rep * steps;
  float* ws = a.ws + rep * a.ws_stride;
  float* sdf = ws + NSCRATCH * M * H;       // df, then dh: (n, B, L) each
  float* sdh = sdf + M * L;
  size_t wsize[NW];
  weight_sizes(L, C, H, wsize);
  const W* wr[NW];
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
    sm[lay.fw3t + l * ld + k] = to_f(wr[4][e]);
    sm[lay.hw3t + l * ld + k] = to_f(wr[10][e]);
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
  const W* gw1 = wr[12];
  const W* gb1 = wr[13];
  const W* gw2 = wr[14];
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
        if (row0 + r < B) sa1[(srow + r) * H + j] = rnd<W>(v);
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
            t[r] = fmaf(rnd<W>(softplus(zv[r] * w1 + b1)), w2g, t[r]);
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
        for (int r = 0; r < R; ++r) acc[r] = fmaf(rnd<W>(v[r]), w, acc[r]);
      }
      const float b = b2[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float u = softplus(acc[r] + b);
        a2t[j * R + r] = u;
        if (row0 + r < B) sa2[(srow + r) * H + j] = rnd<W>(u);
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
        for (int r = 0; r < R; ++r) t[r] = fmaf(rnd<W>(v[r]), w, t[r]);
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
      if (valid) dnoise[at] = from_f<W>(dz * g);
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
        for (int r = 0; r < R; ++r) da[r] = fmaf(rnd<W>(d[r]), w, da[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = da[r] * (1.f - expf(-v[r]));
        a2t[k * R + r] = rnd<W>(p);       // G's products' input
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
          const float d2r = rnd<W>(d2[r]);
          sw2 = fmaf(rnd<W>(act), d2r, sw2);
          const float dp1 = d2r * w2g * (1.f - expf(-act));
          const float dp1r = rnd<W>(dp1);
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

    // G. dpre1 = (dpre2 W2^T) * softplus'(a1), in place over a1 (rounded to
    // W: H's products' input): thread k owns row k of W2.
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
        a1t[k * R + r] = rnd<W>(p);
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

template <typename W>
struct ContractArgs {
  Job job[3];
  int njobs;
  const W* ctx;
  const int* ctx_idx;
  float* ws;
  size_t ws_stride, parts, P;
  int M, B, C, T;
};

// Loads rows [m, m + KS) of a job's A tile (columns i0..i0+TI) and Bm tile
// (columns j0..j0+TJ) into one slab buffer; zero past the chunk's end and
// the matrices' edges.
template <typename W>
__device__ __forceinline__ void load_slab(const ContractArgs<W>& a,
                                          const Job& jb, const float* A,
                                          const float* Bm, const W* ctx,
                                          int m, int m1, int i0, int j0,
                                          float* As, float* Bs) {
  for (int e = threadIdx.x; e < KS * TI; e += CT) {
    const int kk = e / TI, i = e % TI, mm = m + kk, gi = i0 + i;
    const bool valid = mm < m1 && gi < jb.I;
    if (jb.ctx_rows) {
      const W* src = ctx;
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
// chunks, replicas). A (the scratch's activations, or the context) holds
// products' inputs as they are; Bm (the cotangents) is rounded to W as the
// products read it, and summed unrounded into the bias row.
template <typename W>
__global__ void __launch_bounds__(CT)
    latent_bwd_contract(const ContractArgs<W> a) {
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
  const W* ctx = a.ctx + rep * size_t(a.T) * a.B * a.C;
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
      const float bv[8] = {rnd<W>(b0.x), rnd<W>(b0.y), rnd<W>(b0.z),
                           rnd<W>(b0.w), rnd<W>(b1.x), rnd<W>(b1.y),
                           rnd<W>(b1.z), rnd<W>(b1.w)};
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

template <typename W>
struct SkinnyArgs {
  SkinnyJob job[4];
  const float* z0;       // the solve's z0
  const W* zs;           // the window's zs
  size_t zs_stride;      // its replica stride
  int first;             // the window starts at the solve's first step
  float* ws;
  size_t ws_stride, parts, P;
  int M, B, L, H;
};

// A thread a column c of W, summing over one chunk of rows in row order;
// grid (jobs, chunks, replicas). Each thread loads SKB rows of its column
// before it adds them, so that many loads are in flight at once. The
// products take their inputs rounded to W (the type parameter: z_pre and
// the cotangents; the activations are stored rounded), the bias columns of
// ones sum the cotangents unrounded.
template <typename W>
__global__ void __launch_bounds__(CT) latent_bwd_skinny(const SkinnyArgs<W> a) {
  const SkinnyJob& jb = a.job[blockIdx.x];
  const int m0 = blockIdx.y * RC, m1 = min(a.M, m0 + RC);
  const size_t rep = blockIdx.z;
  const int L = a.L, H = a.H;
  const float* ws = a.ws + rep * a.ws_stride;
  const float* Wm = ws + jb.w;
  const float* S = ws + jb.s;
  const float* z0 = a.z0 + rep * size_t(a.B) * L;
  const W* zs = a.zs + rep * a.zs_stride;
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
          const W* zrow = zs + (ptrdiff_t(mm) - a.B) * L;
          // float32 picks its row's pointer before one load. The bf16
          // body below, with W = float, gives the same bits but made
          // kernel 2's float32 contraction at the flagship take 1.05-1.24
          // ms rather than 0.84 on an H100, so the two stay apart.
          if constexpr (sizeof(W) == sizeof(float)) {
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
          } else {
            // The products' inputs rounded to W (zs is already), and S
            // unrounded against W's column of ones (c == H), a bias.
            const double wu = rnd<W>(w[u]);
            const float* frow = jb.z_pre ? z0 + size_t(mm) * L
                                         : S + size_t(mm) * L;
            const bool round_s = jb.z_pre || c < H;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (l0 + i < L) {
                const float f = jb.z_pre && !from_z0 ? to_f(zrow[l0 + i])
                                                     : frow[l0 + i];
                const double sv = round_s ? rnd<W>(f) : f;
                acc[i] = fma(wu, sv, acc[i]);
              }
            }
            if (ones) bias += w[u];
          }
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
// blocks for the g nets (after the `last` window only); replica blockIdx.y
// sums its own workspace into its own row of dw, or, before the last
// window, the towers' elements into its float64 sums.
struct ReduceArgs {
  size_t off[NW];
  const float* ws;
  size_t ws_stride, parts, sums, P;
  int chunks, blocks, first, last;
  float* dw;
};

__global__ void latent_bwd_reduce(const ReduceArgs a) {
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= a.P) return;
  int w = 0;
  while (w + 1 < NW && e >= a.off[w + 1]) ++w;
  if (w >= 12 && !a.last) return;
  const float* ws = a.ws + blockIdx.y * a.ws_stride;
  double* sums = reinterpret_cast<double*>(const_cast<float*>(ws) + a.sums);
  const int rows = w < 12 ? a.chunks : a.blocks;
  const float* p = ws + a.parts + e;
  double acc = w < 12 && !a.first ? sums[e] : 0.0;
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
// carry is the largest.
struct Sizes {
  size_t P, parts, carry, sums, total;
  int blocks;
};

__host__ inline Sizes sizes_of(int B, int L, int C, int H, int W) {
  Sizes z;
  size_t w[NW];
  weight_sizes(L, C, H, w);
  z.P = 0;
  for (int i = 0; i < NW; ++i) z.P += w[i];
  const size_t M = size_t(W) * B;
  const int chunks = static_cast<int>((M + RC - 1) / RC);
  z.blocks = (B + SWEEP_ROWS - 1) / SWEEP_ROWS;   // the most sweep blocks
  z.parts = M * (NSCRATCH * size_t(H) + 2 * size_t(L));
  const size_t rows = chunks > z.blocks ? chunks : z.blocks;
  z.carry = z.parts + rows * z.P;
  z.sums = (z.carry + size_t(z.blocks) * carry_floats(L, H, SWEEP_ROWS) + 1)
           & ~size_t(1);
  z.total = z.sums + 2 * z.P;
  return z;
}

template <int NT, int R, typename W>
int launch_sweep(const Args<W>& a, int K, cudaStream_t stream) {
  const size_t smem = make_layout(a.L, a.C, a.H, NT, R).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      latent_bwd_sweep<NT, R, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.B + R - 1) / R;
  latent_bwd_sweep<NT, R, W><<<dim3(blocks, K), NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The contraction and the reduction of a window (a: its arguments, as the
// sweep's), on a workspace the sweep has filled with `blocks` partial rows.
template <typename W>
int launch_contraction(const Args<W>& a, int blocks, int K, float* dw,
                       cudaStream_t stream) {
  const int L = a.L, C = a.C, H = a.H;
  const size_t M = size_t(a.n) * a.B, MH = M * H;
  const int chunks = static_cast<int>((M + RC - 1) / RC);
  ContractArgs<W> c;
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

  SkinnyArgs<W> s;
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
  r.dw = dw;
  constexpr int RT = 256;
  latent_bwd_reduce<<<dim3(static_cast<unsigned>((a.P + RT - 1) / RT), K),
                      RT, 0, stream>>>(r);
  return static_cast<int>(cudaGetLastError());
}

// Launches, for K stacked solves (K = 1: a single solve), on `stream`,
// over windows of `window` steps, last first: for `stages` bit 0 the sweep
// at NT threads and R rows a block, for bit 1 the contraction and the
// reduction on the workspace such a sweep filled (both bits: any window;
// one bit alone: one window, the whole solve); returns cudaGetLastError()
// (0 on success).
template <int NT, int R, typename W>
int launch(Args<W> a, int K, float* dw, int stages, int window, int device,
           cudaStream_t stream) {
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
  const Sizes z = sizes_of(B, L, a.C, a.H, window < n ? window : n);
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
      const int rc = launch_sweep<NT, R>(wa, K, stream);
      if (rc != 0) return rc;
    }
    if (stages & 2) {
      const int rc = launch_contraction(wa, (B + R - 1) / R, K, dw, stream);
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
