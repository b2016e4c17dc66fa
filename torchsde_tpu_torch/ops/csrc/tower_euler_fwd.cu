// Whole-solve Euler-Maruyama forward of an SDE whose drift and diffusion are
// MLP towers (TowerSpec), for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/fused_solve.py:
// _euler_fwd_kernel, launched by _make_euler's fwd_impl. For each step n,
// with x = [t0_n? | y]:
//   f = drift(x), g = diffusion(x)
//   y += f * dt_n + g . dW_n    (g * dW, or sum_j g[i, j] dW[j] for general
//                                noise, g the row-major (S, m) output)
//
// What bounds it. A solve is N dependent steps; per row and step it costs
// the towers' multiply-adds, sum of in*out over both towers' layers (8,320 at
// d 32, hidden 128; 33,024 at d 128), against a few hundred bytes of noise
// and state. So it is bound by arithmetic and by the step-to-step
// dependency: the only parallelism is over batch rows and units inside a
// step. The earlier design (8 rows a block, 256 threads, one unit a
// thread, the towers read from L2 by 512 blocks at batch 4096) took
// 1.48 ms against a 0.26 ms float32 bound at d 32, hidden 128 (NVIDIA H100
// 80GB HBM3, 700 W), each weight read feeding 8 multiply-adds.
//
// Designs, chosen on the host from the widths, the batch and the SM count
// (fused_solve.forward_design); a block runs the whole step loop for R rows
// (8, 16 or 32):
//   - 3xTF32 (where both towers fit a block split into TF32 halves and one
//     wave of blocks takes 32 rows; at batch 4096, d 32, hidden 128: 512
//     threads, 128 blocks): each layer a tensor-core product on its
//     tower's warps (tower_fwd_tile.cuh, mma_tf32.cuh), three TF32
//     products for each float32 one, the bias and activation on the
//     accumulator fragments; 1.19 ms there. The instruction rate binds
//     it: the precise activations take about a quarter of the time, the
//     tensor pipe's three products a tile about a fifth (mma.sync at these
//     shapes, far from wgmma's rate), the fragment loads, splits and
//     stores most of the rest;
//   - FMA tiles (tower_fwd_tile.cuh, as kernels 11 and 13): the towers in
//     shared memory where they fit, else read through L2; every unit one
//     fmaf chain over its inputs in order, so every FMA design gives the
//     bits of the earlier 8-row kernel (1.46 ms at 32 rows there; at 8
//     rows on general noise 0.74 ms against the earlier kernel's 1.11).
// The next step's noise, time and dt arrive by cp.async during the towers.

#include <cuda_runtime.h>
#include <stddef.h>

#include "tower_fwd_tile.cuh"

namespace {

using namespace tsde_tower;

struct Args {
  const int* table;
  const float* pack[2];  // fw, gw
  const float* y0;       // (B, S)
  const float* noise;    // (N, B, m)
  const float* t0s;      // (N,)
  const float* dts;      // (N,)
  float* ys;             // (N, B, S)
  Dims d;
  int stage, R, B, N;
};

// g . dW of state unit i, row r, with g's unit u at g[u * gu] and noise
// channel j at nz[j * RS] (both already offset to row r). The diagonal
// product is rounded on its own (__fmul_rn), never fused into the update's
// add, as the earlier 8-row kernel rounded it: the FMA tiles keep its bits.
__device__ __forceinline__ float noise_term(const Dims& d, const float* g,
                                            int gu, const float* nz, int RS,
                                            int i) {
  if (d.diag) return __fmul_rn(g[i * gu], nz[i * RS]);
  float gdw = 0.f;
  for (int j = 0; j < d.m; ++j)
    gdw = fmaf(g[(i * d.m + j) * gu], nz[j * RS], gdw);
  return gdw;
}

// FMA tiles. One block an SM, as tower_euler_logqp_fwd.cu.
template <int NT>
__global__ void __launch_bounds__(NT, 1) tower_euler_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d = a.d;
  const int R = a.R, RS = tile_ld(R);
  const int tid = threadIdx.x, row0 = blockIdx.x * R;
  const int S = d.S, wt = d.wt, B = a.B, N = a.N;
  const TileLayout s = tile_setup<NT>(a.table, d, EULER_FWD, a.stage, R, 1,
                                      0, sm, a.pack);
  float* x = sm + s.x;
  // Rows past the end of the batch compute on zeros and are never stored.
  for (int e = tid; e < S * R; e += NT) {
    const int r = e / S, i = e % S, row = row0 + r;
    x[(wt + i) * RS + r] = row < B ? a.y0[size_t(row) * S + i] : 0.f;
  }
  tile_prefetch<NT>(s, sm, 0, 0, a.noise, a.t0s, a.dts, wt, d.m, B, row0,
                    R);
  tile_cp_async_wait_all();
  __syncthreads();
  const TileTower tw = tile_tower<NT>(s, d, a.stage, 1, 0, sm, a.pack);
  const float* f = tile_out(s, d, 1, 0, 0, sm);
  const float* g = tile_out(s, d, 1, 0, 1, sm);

  for (int n = 0; n < N; ++n) {
    if (n > 0) {
      tile_cp_async_wait_all();
      __syncthreads();
    }
    tile_towers(tw, x, R, false, false, [&] {
      if (n + 1 < N)
        tile_prefetch<NT>(s, sm, n + 1, (n + 1) & 1, a.noise, a.t0s, a.dts,
                          wt, d.m, B, row0, R);
    });
    const float* nz = sm + s.nz[n & 1];
    const float dt = sm[s.dt + (n & 1)];
    // The update writes only the state rows of x, which the next step's
    // towers read after its first barrier.
    for (int e = tid; e < S * R; e += NT) {
      const int r = e / S, i = e % S, row = row0 + r;
      if (row >= B) continue;
      const float gdw = noise_term(d, g + r, RS, nz + r, RS, i);
      const float y = x[(wt + i) * RS + r] + f[i * RS + r] * dt + gdw;
      x[(wt + i) * RS + r] = y;
      a.ys[(size_t(n) * B + row) * S + i] = y;
    }
  }
}

// 3xTF32 tiles: every tower in the block, split.
template <int NT>
__global__ void __launch_bounds__(NT, 1)
    tower_euler_fwd_mma_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d = a.d;
  constexpr int R = MMA_ROWS;
  const int RS = tile_ld(R);
  const int tid = threadIdx.x, row0 = blockIdx.x * R;
  const int S = d.S, wt = d.wt, B = a.B, N = a.N;
  const MmaLayout s = mma_setup<NT>(a.table, d, sm, a.pack);
  const Layer* plan = reinterpret_cast<const Layer*>(sm + s.plan);
  const int xld = plan[0].pad;
  float* x = sm + s.x;
  for (int e = tid; e < S * R; e += NT) {
    const int r = e / S, i = e % S, row = row0 + r;
    x[r * xld + tsde_mma::k_pos(wt + i)] =
        row < B ? a.y0[size_t(row) * S + i] : 0.f;
  }
  tile_prefetch<NT>(s, sm, 0, 0, a.noise, a.t0s, a.dts, wt, d.m, B, row0, R,
                    xld);
  tile_cp_async_wait_all();
  __syncthreads();
  // This thread's tower, its warp among the tower's, and the towers'
  // outputs [row][unit] (paired order).
  constexpr int NTT = NT / 2, NW = NTT / 32;
  const int t = tid / NTT, wi = (tid % NTT) >> 5, lane = tid & 31;
  const Layer* tp = plan + d.base(t);
  const int nl = d.nl(t);
  const Layer& fL = plan[d.nf - 1];
  const Layer& gL = plan[d.nf + d.ng - 1];
  const float* f = sm + fL.post;
  const float* g = sm + gL.post;
  const int fld = fL.ld, gld = gL.ld;

  for (int n = 0; n < N; ++n) {
    if (n > 0) {
      tile_cp_async_wait_all();
      __syncthreads();
    }
    for (int i = 0; i < s.maxl; ++i) {
      if (i < nl) mma_layer(tp[i], i, nl, sm, wi, NW, lane);
      __syncthreads();
      if (i == 0 && n + 1 < N)
        tile_prefetch<NT>(s, sm, n + 1, (n + 1) & 1, a.noise, a.t0s, a.dts,
                          wt, d.m, B, row0, R, xld);
    }
    const float* nz = sm + s.nz[n & 1];
    const float dt = sm[s.dt + (n & 1)];
    for (int e = tid; e < S * R; e += NT) {
      const int r = e / S, i = e % S, row = row0 + r;
      if (row >= B) continue;
      float gdw;
      if (d.diag) {
        gdw = g[r * gld + tsde_mma::k_pos(i)] * nz[i * RS + r];
      } else {
        gdw = 0.f;
        for (int j = 0; j < d.m; ++j)
          gdw = fmaf(g[r * gld + tsde_mma::k_pos(i * d.m + j)],
                     nz[j * RS + r], gdw);
      }
      float* xi = x + r * xld + tsde_mma::k_pos(wt + i);
      const float y = *xi + f[r * fld + tsde_mma::k_pos(i)] * dt + gdw;
      *xi = y;
      a.ys[(size_t(n) * B + row) * S + i] = y;
    }
  }
}

template <int NT>
int launch(const Args& a, const TileLayout& s, cudaStream_t stream) {
  return static_cast<int>(launch_tile(tower_euler_fwd_kernel<NT>, a, a.B,
                                      a.R, NT, 1, s, stream));
}

template <int NT>
int launch_mma(const Args& a, const MmaLayout& s, cudaStream_t stream) {
  void (*kernel)(Args) = tower_euler_fwd_mma_kernel<NT>;
  const size_t smem = s.total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(a.B + a.R - 1) / a.R, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of a kernel of `kind` (1 the Euler sweep,
// 3 the reversible-Heun sweep, 5 the Euler logqp sweep) needs for this host
// layer table ((in, out, activation) per layer: drift, diffusion, then
// prior), with the towers of `stage` (bit 0 drift, bit 1 diffusion, bit 2
// prior) copied there.
size_t tsde_tower_smem_bytes(int kind, const int* table, int nf, int ng,
                             int nh, int S, int m, int diag, int wt,
                             int stage) {
  const Dims d = {nf, ng, nh, S, m, diag, wt};
  return make_layout(table, d, kind, stage, nullptr).total * sizeof(float);
}

// Blocks of a sweep over B rows (fused_solve.staged_towers compares them
// with the card's SMs).
int tsde_tower_blocks(int B) { return blocks_for(B); }

// Dynamic shared memory one block of kernel 9's 3xTF32 design needs for
// this host layer table (fused_solve.fwd_smem_bytes computes the same on
// the host).
size_t tsde_tower_euler_fwd_mma_smem_bytes(const int* table, int nf, int ng,
                                           int S, int m, int diag, int wt) {
  const Dims d = {nf, ng, 0, S, m, diag, wt};
  return make_mma_layout(table, d, nullptr).total * sizeof(float);
}

// Launches the solve on `stream` and returns the CUDA error code (0 on
// success). table_host and table_dev hold the same layer table; all other
// pointers are device pointers to contiguous float32 arrays. The design
// (fused_solve.forward_design): R rows a block (8, 16 or 32) on `threads`
// threads, `mma` 1 for the 3xTF32 tiles (32 rows, 64, 128, 256 or 512
// threads; every tower in shared memory), else the FMA tiles (256, 512 or
// 768 threads) with the towers of `stage` staged.
int tsde_tower_euler_fwd(const int* table_host, const int* table_dev,
                         const float* fw, const float* gw, const float* y0,
                         const float* noise, const float* t0s,
                         const float* dts, float* ys, int nf, int ng, int nh,
                         int S, int m, int diag, int wt, int stage, int rows,
                         int threads, int mma, int B, int N, int device,
                         cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  Args a;
  a.table = table_dev;
  a.pack[0] = fw; a.pack[1] = gw;
  a.y0 = y0; a.noise = noise; a.t0s = t0s; a.dts = dts; a.ys = ys;
  a.d = {nf, ng, nh, S, m, diag, wt};
  a.stage = stage;
  a.R = rows; a.B = B; a.N = N;
  if (nh != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mma) {
    if (!mma_design_ok(a.d, rows, threads))
      return static_cast<int>(cudaErrorInvalidValue);
    const MmaLayout s = make_mma_layout(table_host, a.d, nullptr);
    switch (threads) {
      case 64: return launch_mma<64>(a, s, stream);
      case 128: return launch_mma<128>(a, s, stream);
      case 256: return launch_mma<256>(a, s, stream);
      case 512: return launch_mma<512>(a, s, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (!tile_design_ok(a.d, rows, threads, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const TileLayout s = make_tile_layout(table_host, a.d, EULER_FWD, stage,
                                        rows, 1, nullptr);
  switch (threads) {
    case 256: return launch<256>(a, s, stream);
    case 512: return launch<512>(a, s, stream);
    case 768: return launch<768>(a, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
