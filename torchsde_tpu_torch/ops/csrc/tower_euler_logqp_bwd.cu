// Reverse sweep of the whole-solve Euler-Maruyama of a TowerSpec SDE with
// its KL channel (logqp), for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/fused_solve.py:
// _euler_logqp_bwd_kernel, launched by _make_euler_logqp's bwd_impl. The
// cotangent of qs enters as ginc, its reverse cumulative sum over steps
// (the cotangent of step n's KL increment), formed outside the kernel. For
// each step n from the last to the first, with x = [t0_n? | y_n] and y_n the
// pre-step state (y0 or ys[n-1]):
//   recompute the three towers at x, keeping every layer's activations,
//   and gs, u as the forward does;
//   dy += gy[n];  dnoise[n] = dy g
//   du = ginc[n] u dt;  df = dy dt + du / gs;  dh = -du / gs
//   dg = dy dW - (du u / gs) [|g| > 1e-7]    (the mask spares dy dW)
//   backpropagate df, dg and dh through their towers, adding every weight
//   gradient; dy += the sum of the input cotangents' state columns.
//
// What bounds it. Per row and step it recomputes the towers and does two
// products of the same size per layer going back (weight gradient and input
// cotangent): three times the forward's multiply-adds, against a few hundred
// bytes of state, noise and cotangents. Bound by arithmetic and by the
// step-to-step dependency of dy.
//
// Design (tower_solve_common.cuh). One block per tile of TB = 8 rows sweeps
// the steps backwards with no grid-wide sync, its 384 threads running the
// three towers side by side, a layer depth per two barriers going back.
// Rows interact only through the weight gradients: each block adds its
// rows' contributions of every step into a private float32 partial in
// device memory (blocks x all three packs' floats), each element always by
// the same thread, and a second kernel sums the partials over blocks in
// block order with a compensated sum. No atomics: the gradients are bitwise
// the same from call to call.

#include <cuda_runtime.h>
#include <stddef.h>

#include "tower_solve_common.cuh"

namespace {

using namespace tsde_tower;

constexpr float EPS = 1e-7f;       // stable_division's clamp

struct Args {
  const int* table;
  const float* pack[MAX_TOWERS];  // fw, gw, hw
  const float* y0;                // (B, S)
  const float* noise;             // (N, B, S)
  const float* t0s;               // (N,)
  const float* dts;               // (N,)
  const float* ys;                // (N, B, S): post-step states
  const float* gy;                // (N, B, S)
  const float* ginc;              // (N, B, 1)
  float* dy0;                     // (B, S)
  float* dnoise;                  // (N, B, S)
  float* partials;                // (blocks, P)
  size_t P;
  Dims d;
  int stage, B, N;
};

__global__ void __launch_bounds__(NT3)
    tower_euler_logqp_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d = a.d;
  const float* w[MAX_TOWERS];
  const Layout s = setup(a.table, d, EULER_LOGQP_BWD, a.stage, sm, a.pack,
                         w);
  const Layer* plan = reinterpret_cast<const Layer*>(sm + s.plan);
  const int tid = threadIdx.x, row0 = blockIdx.x * TB;
  const int S = d.S, wt = d.wt, B = a.B;
  float* x = sm + s.x;
  float* dy = sm + s.carry[0];            // [i][r]: the carried dy
  float* dout_f = sm + s.dout[0];
  float* dout_g = sm + s.dout[1];
  float* dout_h = sm + s.dout[2];
  float* part = a.partials + size_t(blockIdx.x) * a.P;
  for (int e = tid; e < S * TB; e += NT3) dy[e] = 0.f;

  for (int n = a.N - 1; n >= 0; --n) {
    const bool first = n == a.N - 1;
    const float dt = a.dts[n];
    // A. x = [t | pre-step y]; dy takes gy. Rows past the end of the batch
    // compute on zeros and get zero cotangents, so they add nothing to the
    // weight gradients.
    const float* ypre = n == 0 ? a.y0 : a.ys + size_t(n - 1) * B * S;
    for (int e = tid; e < S * TB; e += NT3) {
      const int r = e / S, i = e % S, row = row0 + r;
      const bool valid = row < B;
      x[(wt + i) * TB + r] = valid ? ypre[size_t(row) * S + i] : 0.f;
      if (valid) dy[i * TB + r] += a.gy[(size_t(n) * B + row) * S + i];
    }
    if (wt && tid < TB) x[tid] = a.t0s[n];
    __syncthreads();

    // B. Recompute the three towers, keeping each layer's activations.
    towers_forward(plan, d, s, w, sm, true);

    // C. The towers' output cotangents and dnoise, a thread per (row,
    // unit); the backward below leaves the towers' outputs as they are.
    const float* f = tower_out(plan, d, s, sm, 0, true);
    const float* g = tower_out(plan, d, s, sm, 1, true);
    const float* h = tower_out(plan, d, s, sm, 2, true);
    for (int e = tid; e < S * TB; e += NT3) {
      const int r = e / S, i = e % S, row = row0 + r, k = i * TB + r;
      if (row >= B) {
        dout_f[k] = 0.f;
        dout_g[k] = 0.f;
        dout_h[k] = 0.f;
        continue;
      }
      const size_t at = size_t(n) * B + row;
      const float gv = g[k];
      const bool big = fabsf(gv) > EPS;
      const float gs = big ? gv : (gv >= 0.f ? EPS : -EPS);
      const float u = (f[k] - h[k]) / gs;
      const float dyv = dy[k];
      a.dnoise[at * S + i] = dyv * gv;
      const float du = a.ginc[at] * u * dt;
      dout_f[k] = dyv * dt + du / gs;
      dout_h[k] = -du / gs;
      dout_g[k] =
          dyv * a.noise[at * S + i] - (du * u / gs) * (big ? 1.f : 0.f);
    }
    __syncthreads();

    // D. The three towers back to their input, every weight gradient into
    // the block's partial.
    towers_backward(plan, d, s, w, sm, part, first);

    // E. The state columns of the input cotangents join the carried dy.
    for (int e = tid; e < S * TB; e += NT3) {
      const int r = e / S, i = e % S, k = (wt + i) * TB + r;
      dy[i * TB + r] += (dout_f[k] + dout_h[k]) + dout_g[k];
    }
    __syncthreads();
  }

  for (int e = tid; e < S * TB; e += NT3) {
    const int r = e / S, i = e % S, row = row0 + r;
    if (row < B) a.dy0[size_t(row) * S + i] = dy[i * TB + r];
  }
}

}  // namespace

extern "C" {

// Launches the sweep and the sum of its partials on `stream` and returns
// cudaGetLastError() (0 on success). table_host and table_dev hold the same
// layer table (drift, diffusion, prior); all other pointers are device
// pointers to contiguous float32 arrays. partials holds tsde_tower_blocks(B)
// x P floats and dw P floats, P the three packs' total size; dw receives
// [dfw | dgw | dhw].
int tsde_tower_euler_logqp_bwd(const int* table_host, const int* table_dev,
                               const float* fw, const float* gw,
                               const float* hw, const float* y0,
                               const float* noise, const float* t0s,
                               const float* dts, const float* ys,
                               const float* gy, const float* ginc,
                               float* dy0, float* dnoise, float* partials,
                               float* dw, int nf, int ng, int nh, int S,
                               int m, int diag, int wt, int stage, int B,
                               int N, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  if (nh <= 0 || !diag || m != S)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.table = table_dev;
  a.pack[0] = fw; a.pack[1] = gw; a.pack[2] = hw;
  a.y0 = y0; a.noise = noise; a.t0s = t0s; a.dts = dts; a.ys = ys;
  a.gy = gy; a.ginc = ginc; a.dy0 = dy0; a.dnoise = dnoise;
  a.partials = partials;
  a.d = {nf, ng, nh, S, m, diag, wt};
  a.stage = stage; a.B = B; a.N = N;
  const Layout s = make_layout(table_host, a.d, EULER_LOGQP_BWD, stage,
                               nullptr);
  a.P = s.P;
  err = prepare(tower_euler_logqp_bwd_kernel, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = blocks_for(B);
  tower_euler_logqp_bwd_kernel<<<blocks, NT3, s.total * sizeof(float),
                                 stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(partials, blocks, s.P, dw, stream));
}

}  // extern "C"
