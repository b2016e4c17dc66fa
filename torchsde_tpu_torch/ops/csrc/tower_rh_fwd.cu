// Whole-solve reversible Heun forward of an SDE whose drift and diffusion are
// MLP towers (TowerSpec), for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/fused_solve.py:
// _rh_fwd_kernel, launched by _make_rh's fwd_impl. With the carry
// (y, z, f, g), starting from (y0, y0, f0, g0), each step n is:
//   z1 = 2 y - z + dt_n f + g . dW_n
//   f1 = drift([t1_n? | z1]), g1 = diffusion([t1_n? | z1])
//   y1 = y + dt_n/2 (f + f1) + (g + g1) . dW_n/2
// where g . dW is g * dW, or sum_j g[i, j] dW[j] for general noise (g the
// row-major (S, m) output). It stores y1, z1 and g1 of every step.
//
// What bounds it: as tower_euler_fwd.cu, one evaluation of both towers per
// row and step in a chain of dependent steps; arithmetic and the step-to-step
// dependency.
//
// Design (tower_solve_common.cuh): one block per tile of TB = 8 rows runs
// the step loop; the drift and the diffusion run side by side on the
// block's two halves. The carry lives in shared memory: z in the towers'
// input rows, y, f and g in arrays of their own, each element owned by one
// thread. Towers that do not fit a block's shared memory are read from
// device memory through the L2 cache.

#include <cuda_runtime.h>
#include <stddef.h>

#include "tower_solve_common.cuh"

namespace {

using namespace tsde_tower;

struct Args {
  const int* table;
  const float* pack[2];  // fw, gw
  const float* y0;       // (B, S)
  const float* f0;       // (B, S)
  const float* g0;       // (B, G), G = S or S*m
  const float* noise;    // (N, B, m)
  const float* t1s;      // (N,)
  const float* dts;      // (N,)
  float* ys;             // (N, B, S)
  float* zs;             // (N, B, S)
  float* gs;             // (N, B, G)
  Dims d;
  int stage, B, N;
};

__global__ void __launch_bounds__(NT) tower_rh_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d = a.d;
  const float* w[2];
  const Layout s = setup(a.table, d, RH_FWD, a.stage, sm, a.pack, w);
  const Layer* plan = reinterpret_cast<const Layer*>(sm + s.plan);
  const int tid = threadIdx.x, row0 = blockIdx.x * TB;
  const int S = d.S, m = d.m, wt = d.wt, B = a.B, G = d.gwidth();
  const int gper = d.diag ? 1 : m;        // g entries of one state unit
  float* x = sm + s.x;                    // z in the state rows
  float* yc = sm + s.carry[0];
  float* fc = sm + s.carry[1];
  float* gc = sm + s.carry[2];
  // Thread (r, i) owns y[i], z[i], f[i] and g[i, :] of row r throughout.
  // Rows past the end of the batch stay zero and are never stored.
  for (int e = tid; e < S * TB; e += NT) {
    const int r = e / S, i = e % S, row = row0 + r;
    const bool valid = row < B;
    const float y = valid ? a.y0[size_t(row) * S + i] : 0.f;
    yc[i * TB + r] = y;
    x[(wt + i) * TB + r] = y;
    fc[i * TB + r] = valid ? a.f0[size_t(row) * S + i] : 0.f;
    for (int u = i * gper; u < (i + 1) * gper; ++u)
      gc[u * TB + r] = valid ? a.g0[size_t(row) * G + u] : 0.f;
  }

  for (int n = 0; n < a.N; ++n) {
    const float dt = a.dts[n];
    // A. z1 = 2 y - z + dt f + g . dW into the towers' input rows.
    for (int e = tid; e < S * TB; e += NT) {
      const int r = e / S, i = e % S, row = row0 + r;
      if (row >= B) continue;
      const size_t at = size_t(n) * B + row;
      const float* dW = a.noise + at * m;
      float gdw;
      if (d.diag) {
        gdw = gc[i * TB + r] * dW[i];
      } else {
        gdw = 0.f;
        for (int j = 0; j < m; ++j)
          gdw = fmaf(gc[(i * m + j) * TB + r], dW[j], gdw);
      }
      const float z1 = 2.f * yc[i * TB + r] - x[(wt + i) * TB + r]
                       + dt * fc[i * TB + r] + gdw;
      x[(wt + i) * TB + r] = z1;
      a.zs[at * S + i] = z1;
    }
    if (wt && tid < TB) x[tid] = a.t1s[n];
    __syncthreads();

    // B. f1, g1 at [t1 | z1].
    towers_forward(plan, d, s, w, sm, false);
    const float* f1 = tower_out(plan, d, s, sm, 0, false);
    const float* g1 = tower_out(plan, d, s, sm, 1, false);

    // C. y1, and the carry moves on. The next step's phase A touches only
    // what the same thread owns, and its barrier comes before the towers
    // overwrite f1 and g1.
    for (int e = tid; e < S * TB; e += NT) {
      const int r = e / S, i = e % S, row = row0 + r;
      if (row >= B) continue;
      const size_t at = size_t(n) * B + row;
      const float* dW = a.noise + at * m;
      float gdw = 0.f;
      for (int u = i * gper, j = d.diag ? i : 0; u < (i + 1) * gper;
           ++u, ++j) {
        const float gn = g1[u * TB + r];
        gdw = fmaf(gc[u * TB + r] + gn, 0.5f * dW[j], gdw);
        gc[u * TB + r] = gn;
        a.gs[at * G + u] = gn;
      }
      const float fn = f1[i * TB + r];
      const float y1 = yc[i * TB + r] + 0.5f * dt * (fc[i * TB + r] + fn)
                       + gdw;
      yc[i * TB + r] = y1;
      fc[i * TB + r] = fn;
      a.ys[at * S + i] = y1;
    }
  }
}

}  // namespace

extern "C" {

// Launches the solve on `stream` and returns cudaGetLastError() (0 on
// success). table_host and table_dev hold the same layer table; all other
// pointers are device pointers to contiguous float32 arrays.
int tsde_tower_rh_fwd(const int* table_host, const int* table_dev,
                      const float* fw, const float* gw, const float* y0,
                      const float* f0, const float* g0, const float* noise,
                      const float* t1s, const float* dts, float* ys,
                      float* zs, float* gs, int nf, int ng, int S, int m,
                      int diag, int wt, int stage, int B, int N, int device,
                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  Args a;
  a.table = table_dev;
  a.pack[0] = fw; a.pack[1] = gw;
  a.y0 = y0; a.f0 = f0; a.g0 = g0; a.noise = noise; a.t1s = t1s;
  a.dts = dts; a.ys = ys; a.zs = zs; a.gs = gs;
  a.d = {nf, ng, S, m, diag, wt};
  a.stage = stage; a.B = B; a.N = N;
  const Layout s = make_layout(table_host, a.d, RH_FWD, stage, nullptr);
  err = prepare(tower_rh_fwd_kernel, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tower_rh_fwd_kernel<<<blocks_for(B), NT, s.total * sizeof(float),
                        stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
