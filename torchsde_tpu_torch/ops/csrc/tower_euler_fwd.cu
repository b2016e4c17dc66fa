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
// step.
//
// Design (tower_solve_common.cuh). One block per tile of TB = 8 rows runs
// the whole step loop with no grid-wide sync. Its 256 threads evaluate the
// drift and the diffusion side by side, a layer depth per barrier, thread j
// owning unit j; the state lives in the input rows x of shared memory. The
// towers the host names (fused_solve.staged_towers) are copied to shared
// memory; the others are read from their packs in device memory, where
// every block reads the same weights, thread j column j side by side, and
// the caches keep them. Plain f32 FMAs, no fast math; tensor cores are
// later work.

#include <cuda_runtime.h>
#include <stddef.h>

#include "tower_solve_common.cuh"

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
  int stage, B, N;
};

__global__ void __launch_bounds__(NT) tower_euler_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d = a.d;
  const float* w[2];
  const Layout s = setup(a.table, d, EULER_FWD, a.stage, sm, a.pack, w);
  const Layer* plan = reinterpret_cast<const Layer*>(sm + s.plan);
  const int tid = threadIdx.x, row0 = blockIdx.x * TB;
  const int S = d.S, m = d.m, wt = d.wt, B = a.B;
  float* x = sm + s.x;
  // Rows past the end of the batch compute on zeros and are never stored.
  for (int e = tid; e < S * TB; e += NT) {
    const int r = e / S, i = e % S, row = row0 + r;
    x[(wt + i) * TB + r] = row < B ? a.y0[size_t(row) * S + i] : 0.f;
  }

  for (int n = 0; n < a.N; ++n) {
    if (wt && tid < TB) x[tid] = a.t0s[n];
    __syncthreads();
    towers_forward(plan, d, s, w, sm, false);
    const float* f = tower_out(plan, d, s, sm, 0, false);
    const float* g = tower_out(plan, d, s, sm, 1, false);
    // The update writes only the state rows of x, which the next step's
    // towers read after its first barrier.
    const float dt = a.dts[n];
    for (int e = tid; e < S * TB; e += NT) {
      const int r = e / S, i = e % S, row = row0 + r;
      if (row >= B) continue;
      const size_t at = size_t(n) * B + row;
      const float* dW = a.noise + at * m;
      float gdw;
      if (d.diag) {
        gdw = g[i * TB + r] * dW[i];
      } else {
        gdw = 0.f;
        for (int j = 0; j < m; ++j)
          gdw = fmaf(g[(i * m + j) * TB + r], dW[j], gdw);
      }
      const float y = x[(wt + i) * TB + r] + f[i * TB + r] * dt + gdw;
      x[(wt + i) * TB + r] = y;
      a.ys[at * S + i] = y;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of a kernel of `kind` (0 Euler forward, 1
// its sweep, 2 reversible-Heun forward, 3 its sweep, 4 Euler logqp forward,
// 5 its sweep) needs for this host layer table ((in, out, activation) per
// layer: drift, diffusion, then prior), with the towers of `stage` (bit 0
// drift, bit 1 diffusion, bit 2 prior) copied there.
size_t tsde_tower_smem_bytes(int kind, const int* table, int nf, int ng,
                             int nh, int S, int m, int diag, int wt,
                             int stage) {
  const Dims d = {nf, ng, nh, S, m, diag, wt};
  return make_layout(table, d, kind, stage, nullptr).total * sizeof(float);
}

// Blocks of a solve over B rows: the backward kernels' partial buffers hold
// one row of all weight gradients for each.
int tsde_tower_blocks(int B) { return blocks_for(B); }

// Launches the solve on `stream` and returns cudaGetLastError() (0 on
// success). table_host and table_dev hold the same layer table; all other
// pointers are device pointers to contiguous float32 arrays.
int tsde_tower_euler_fwd(const int* table_host, const int* table_dev,
                         const float* fw, const float* gw, const float* y0,
                         const float* noise, const float* t0s,
                         const float* dts, float* ys, int nf, int ng, int nh,
                         int S, int m, int diag, int wt, int stage, int B,
                         int N, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  Args a;
  a.table = table_dev;
  a.pack[0] = fw; a.pack[1] = gw;
  a.y0 = y0; a.noise = noise; a.t0s = t0s; a.dts = dts; a.ys = ys;
  a.d = {nf, ng, nh, S, m, diag, wt};
  a.stage = stage; a.B = B; a.N = N;
  const Layout s = make_layout(table_host, a.d, EULER_FWD, stage, nullptr);
  err = prepare(tower_euler_fwd_kernel, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tower_euler_fwd_kernel<<<blocks_for(B), NT, s.total * sizeof(float),
                           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
