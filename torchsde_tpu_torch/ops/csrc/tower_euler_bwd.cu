// Reverse sweep of the whole-solve Euler-Maruyama of a TowerSpec SDE, for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/fused_solve.py:
// _euler_bwd_kernel, launched by _make_euler's bwd_impl. For each step n
// from the last to the first, with x = [t0_n? | y_n] and y_n the pre-step
// state (y0 or ys[n-1]):
//   recompute both towers at x, keeping every layer's activations;
//   dy += gy[n];  dnoise[n] = dy . g   (dy * g, or sum_i dy[i] g[i, j])
//   backpropagate dy * dt through the drift and dy (x) dW (dy * dW, or the
//   outer product dy[i] dW[j]) through the diffusion, adding every weight
//   gradient; dy += the input cotangent's state columns.
//
// What bounds it. Per row and step it recomputes the towers and does two
// products of the same size per layer going back (weight gradient and input
// cotangent): three times the forward's multiply-adds, against a few hundred
// bytes of state, noise and cotangents. Only the recompute and the input
// cotangents sit on the chain of dependent steps (dy); the weight gradients
// are sums over all rows and steps that no later step needs.
//
// Design: two phases on one stream, as kernels 12 and 14.
//
// 1. The sweep (tower_solve_common.cuh): one block per tile of TB = 8 rows
//    sweeps the steps backwards with no grid-wide sync, its 256 threads
//    running the two towers side by side, a layer depth per two barriers
//    going back. Each step it writes, for its rows, every layer's
//    pre-activation cotangent and the input of every layer after the first
//    to the scratch (towers_backward_chain): there are no per-step
//    weight-gradient partials (per-block partials added at every step took
//    most of an earlier design's time).
// 2. The contraction (tower_bwd_contract.cu): every layer's weight and bias
//    gradients as products and column sums over all N x B rows of the
//    scratch, the layers' first input [t0_n | y_n] gathered from t0s, y0 and
//    ys; float32 sums over fixed chunks of rows, the chunks' partial rows
//    summed in float64 in chunk order. No atomics: the gradients are bitwise
//    the same from call to call.
//
// A long solve runs the two phases over windows of steps, last first, the
// carried dy kept in dy0 between them (tower_bwd_contract.cu: Windows).

#include <cuda_runtime.h>
#include <stddef.h>

#include "tower_solve_common.cuh"

namespace {

using namespace tsde_tower;

struct Args {
  const int* table;
  const float* pack[2];  // fw, gw
  const float* y0;       // (B, S): the window's first pre-step state
  const float* noise;    // (N, B, m)
  const float* t0s;      // (N,)
  const float* dts;      // (N,)
  const float* ys;       // (N, B, S): post-step states from the forward
  const float* gy;       // (N, B, S)
  float* dy0;            // (B, S): dy in and out of a window
  float* dnoise;         // (N, B, m)
  float* ws;             // the workspace (chain_workspace)
  Dims d;
  int stage, B, N;       // N: the window's steps
};

__global__ void __launch_bounds__(NT) tower_euler_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d = a.d;
  const float* w[2];
  const Layout s = setup(a.table, d, EULER_BWD, a.stage, sm, a.pack, w);
  const Layer* plan = reinterpret_cast<const Layer*>(sm + s.plan);
  const int tid = threadIdx.x, row0 = blockIdx.x * TB;
  const int S = d.S, m = d.m, wt = d.wt, B = a.B;
  float* x = sm + s.x;
  float* dy = sm + s.carry[0];            // [i][r]: the carried dy
  float* dout_f = sm + s.dout[0];
  float* dout_g = sm + s.dout[1];
  ScratchRows sr = scratch_rows(a.table, d, s, sm, a.ws, B, a.N);
  sr.rows = B - row0 < TB ? B - row0 : TB;
  // dy starts where the window after this one left it in dy0 (zero before
  // the last window). Thread e owns element (e % S) x TB + e / S here and
  // in phases A and E.
  for (int e = tid; e < S * TB; e += NT) {
    const int r = e / S, i = e % S, row = row0 + r;
    dy[i * TB + r] = row < B ? a.dy0[size_t(row) * S + i] : 0.f;
  }
  __syncthreads();

  for (int n = a.N - 1; n >= 0; --n) {
    const float dt = a.dts[n];
    // A. x = [t | pre-step y]; dy takes gy; the towers' output cotangents.
    // Rows past the end of the batch compute on zeros, get zero cotangents
    // and are not written to the scratch.
    const float* ypre = n == 0 ? a.y0 : a.ys + size_t(n - 1) * B * S;
    for (int e = tid; e < S * TB; e += NT) {
      const int r = e / S, i = e % S, row = row0 + r;
      const bool valid = row < B;
      const size_t at = size_t(n) * B + row;
      x[(wt + i) * TB + r] = valid ? ypre[size_t(row) * S + i] : 0.f;
      const float v = dy[i * TB + r] + (valid ? a.gy[at * S + i] : 0.f);
      dy[i * TB + r] = v;
      dout_f[i * TB + r] = v * dt;
      const float* dW = a.noise + at * m;
      if (d.diag) {
        dout_g[i * TB + r] = valid ? v * dW[i] : 0.f;
      } else {
        for (int j = 0; j < m; ++j)
          dout_g[(i * m + j) * TB + r] = valid ? v * dW[j] : 0.f;
      }
    }
    if (wt && tid < TB) x[tid] = a.t0s[n];
    __syncthreads();

    // B. Recompute both towers, keeping each layer's activations.
    towers_forward(plan, d, s, w, sm, true);

    // C. dnoise: thread (r, j) reads dy and the diffusion's output, which
    // the backward below leaves as they are.
    const float* g = tower_out(plan, d, s, sm, 1, true);
    for (int e = tid; e < m * TB; e += NT) {
      const int r = e / m, j = e % m, row = row0 + r;
      if (row >= B) continue;
      float v;
      if (d.diag) {
        v = dy[j * TB + r] * g[j * TB + r];
      } else {
        v = 0.f;
        for (int i = 0; i < S; ++i)
          v = fmaf(dy[i * TB + r], g[(i * m + j) * TB + r], v);
      }
      a.dnoise[(size_t(n) * B + row) * m + j] = v;
    }

    // D. Both towers back to their input, each layer's dpre and input to
    // the scratch.
    sr.m0 = size_t(n) * B + row0;
    towers_backward_chain(plan, d, s, w, sm, sr);

    // E. The state columns of the input cotangent join the carried dy.
    for (int e = tid; e < S * TB; e += NT) {
      const int r = e / S, i = e % S;
      dy[i * TB + r] += dout_f[(wt + i) * TB + r] + dout_g[(wt + i) * TB + r];
    }
    __syncthreads();
  }

  for (int e = tid; e < S * TB; e += NT) {
    const int r = e / S, i = e % S, row = row0 + r;
    if (row < B) a.dy0[size_t(row) * S + i] = dy[i * TB + r];
  }
}

}  // namespace

extern "C" {

// Launches kernel 10 on `stream`: over windows of `window` steps, last
// first, the sweep and then the contraction and the reduction of its
// scratch; returns cudaGetLastError() (0 on success). table_host and
// table_dev hold the same layer table; all other pointers are device
// pointers to contiguous float32 arrays. ws holds
// tsde_tower_bwd_workspace(..., B, window) floats and dw P floats, P the
// two packs' total size; dw receives [dfw | dgw]. For measurement,
// `stages` 1 runs the sweep alone and 2 the contraction and the reduction
// alone on the workspace a sweep left (one window only); 3 runs both.
int tsde_tower_euler_bwd(const int* table_host, const int* table_dev,
                         const float* fw, const float* gw, const float* y0,
                         const float* noise, const float* t0s,
                         const float* dts, const float* ys, const float* gy,
                         float* dy0, float* dnoise, float* ws, float* dw,
                         int nf, int ng, int nh, int S, int m, int diag,
                         int wt, int stage, int B, int N, int window,
                         int stages, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  if (window <= 0 || (stages != 3 && window < N))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.table = table_dev;
  a.pack[0] = fw; a.pack[1] = gw;
  a.y0 = y0; a.noise = noise; a.t0s = t0s; a.dts = dts; a.ys = ys;
  a.gy = gy; a.dy0 = dy0; a.dnoise = dnoise; a.ws = ws;
  a.d = {nf, ng, nh, S, m, diag, wt};
  a.stage = stage; a.B = B; a.N = N;
  const Layout s = make_layout(table_host, a.d, EULER_BWD, stage, nullptr);
  const ChainWorkspace w = chain_workspace(table_host, a.d, s.P, B, window);
  if (stages & 1) {
    err = prepare(tower_euler_bwd_kernel, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemsetAsync(dy0, 0, size_t(B) * S * sizeof(float), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // Each window's sweep sees its own steps [lo, hi) as steps 0 to N - 1:
  // its inputs from step lo on, the pre-step state of its first step (y0
  // or ys[lo - 1]) as its y0; dy passes from window to window in dy0.
  for (int hi = N; hi > 0; hi -= window) {
    const int lo = hi > window ? hi - window : 0;
    const size_t at = size_t(lo) * B * S;
    const float* first = lo == 0 ? y0 : ys + at - size_t(B) * S;
    if (stages & 1) {
      Args wa = a;
      wa.y0 = first; wa.noise = noise + size_t(lo) * B * m;
      wa.t0s = t0s + lo; wa.dts = dts + lo; wa.ys = ys + at;
      wa.gy = gy + at; wa.dnoise = dnoise + size_t(lo) * B * m;
      wa.N = hi - lo;
      tower_euler_bwd_kernel<<<blocks_for(B), NT, s.total * sizeof(float),
                               stream>>>(wa);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (stages & 2) {
      const int rc = launch_contraction(table_host, table_dev, a.d,
                                        t0s + lo, first, ys + at, ws, w, dw,
                                        B, hi - lo, hi == N, lo == 0,
                                        stream);
      if (rc != 0) return rc;
    }
  }
  return 0;
}

}  // extern "C"
