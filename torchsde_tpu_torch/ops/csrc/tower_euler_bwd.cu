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
// bytes of state, noise and cotangents. Bound by arithmetic and by the
// step-to-step dependency of dy.
//
// Design (tower_solve_common.cuh). One block per tile of TB = 8 rows sweeps
// the steps backwards with no grid-wide sync; the two towers go back side
// by side, a layer depth per two barriers. Each layer's pre-activation and
// output for the tile stay in shared memory (TB x out x 2 floats a layer),
// so the towers may be of any depth that fits a block. Rows interact only
// through the weight gradients: each block adds its rows' contributions of
// every step into a private float32 partial in device memory (blocks x
// both packs' floats, L2-resident), each element always by the same thread,
// and a second kernel sums the partials over blocks in a fixed order. No
// atomics: the gradients are bitwise the same from call to call.

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
  const float* ys;       // (N, B, S): post-step states from the forward
  const float* gy;       // (N, B, S)
  float* dy0;            // (B, S)
  float* dnoise;         // (N, B, m)
  float* partials;       // (blocks, P)
  size_t P;
  Dims d;
  int stage, B, N;
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
  float* part = a.partials + size_t(blockIdx.x) * a.P;
  for (int e = tid; e < S * TB; e += NT) dy[e] = 0.f;

  for (int n = a.N - 1; n >= 0; --n) {
    const bool first = n == a.N - 1;
    const float dt = a.dts[n];
    // A. x = [t | pre-step y]; dy takes gy; the towers' output cotangents.
    // Rows past the end of the batch compute on zeros and get zero
    // cotangents, so they add nothing to the weight gradients.
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

    // D. Both towers back to their input, every weight gradient into the
    // block's partial.
    towers_backward(plan, d, s, w, sm, part, first);

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

// Launches the sweep and the sum of its partials on `stream` and returns
// cudaGetLastError() (0 on success). table_host and table_dev hold the same
// layer table; all other pointers are device pointers to contiguous float32
// arrays. partials holds tsde_tower_blocks(B) x P floats and dw P floats, P
// the two packs' total size; dw receives [dfw | dgw].
int tsde_tower_euler_bwd(const int* table_host, const int* table_dev,
                         const float* fw, const float* gw, const float* y0,
                         const float* noise, const float* t0s,
                         const float* dts, const float* ys, const float* gy,
                         float* dy0, float* dnoise, float* partials,
                         float* dw, int nf, int ng, int nh, int S, int m,
                         int diag, int wt, int stage, int B, int N,
                         int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  Args a;
  a.table = table_dev;
  a.pack[0] = fw; a.pack[1] = gw;
  a.y0 = y0; a.noise = noise; a.t0s = t0s; a.dts = dts; a.ys = ys;
  a.gy = gy; a.dy0 = dy0; a.dnoise = dnoise; a.partials = partials;
  a.d = {nf, ng, nh, S, m, diag, wt};
  a.stage = stage; a.B = B; a.N = N;
  const Layout s = make_layout(table_host, a.d, EULER_BWD, stage, nullptr);
  a.P = s.P;
  err = prepare(tower_euler_bwd_kernel, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = blocks_for(B);
  tower_euler_bwd_kernel<<<blocks, NT, s.total * sizeof(float), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(partials, blocks, s.P, dw, stream));
}

}  // extern "C"
