// Whole-solve Euler-Maruyama forward of a TowerSpec SDE with its KL channel
// (logqp), for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/fused_solve.py:
// _euler_logqp_fwd_kernel, launched by _make_euler_logqp's fwd_impl. Noise
// is diagonal and all three towers read the same x = [t0_n? | y]. For each
// step n:
//   f = drift(x), g = diffusion(x), h = prior(x)
//   gs = g where |g| > 1e-7, else 1e-7 sign(g), sign(0) = +1
//   u = (f - h) / gs;  q += 0.5 sum_i u_i^2 dt_n
//   y += f dt_n + g dW_n        (the unclamped g)
//
// What bounds it. Per row and step it costs the three towers' multiply-adds
// (24,576 at d 32, hidden 128; 98,304 at d 128) against a few hundred bytes
// of noise and state, so it is bound by arithmetic and by the step-to-step
// dependency: the only parallelism is over rows and units inside a step.
//
// Design (tower_solve_common.cuh). One block per tile of TB = 8 rows runs
// the whole step loop with no grid-wide sync. Its 384 threads evaluate the
// drift, the diffusion and the prior on three 128-thread groups side by
// side, a layer depth per barrier. After the towers' last layer a thread
// per (row, unit) forms u, the state update and u^2 (kept in shared
// memory); after a barrier thread r sums its row's u^2 over the S units in
// unit order and carries its row's q in a register. The towers the host
// names are staged in shared memory, the others read from their packs in
// device memory through L2. Plain f32 FMAs, IEEE division, no fast math.

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
  float* ys;                      // (N, B, S)
  float* qs;                      // (N, B, 1)
  Dims d;
  int stage, B, N;
};

__global__ void __launch_bounds__(NT3)
    tower_euler_logqp_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d = a.d;
  const float* w[MAX_TOWERS];
  const Layout s = setup(a.table, d, EULER_LOGQP_FWD, a.stage, sm, a.pack,
                         w);
  const Layer* plan = reinterpret_cast<const Layer*>(sm + s.plan);
  const int tid = threadIdx.x, row0 = blockIdx.x * TB;
  const int S = d.S, wt = d.wt, B = a.B;
  float* x = sm + s.x;
  float* usq = sm + s.carry[0];           // [i][r]: u^2 of this step
  // Rows past the end of the batch compute on zeros and are never stored.
  for (int e = tid; e < S * TB; e += NT3) {
    const int r = e / S, i = e % S, row = row0 + r;
    x[(wt + i) * TB + r] = row < B ? a.y0[size_t(row) * S + i] : 0.f;
  }
  float q = 0.f;                          // thread r < TB: row r's KL

  for (int n = 0; n < a.N; ++n) {
    if (wt && tid < TB) x[tid] = a.t0s[n];
    __syncthreads();
    towers_forward(plan, d, s, w, sm, false);
    const float* f = tower_out(plan, d, s, sm, 0, false);
    const float* g = tower_out(plan, d, s, sm, 1, false);
    const float* h = tower_out(plan, d, s, sm, 2, false);
    // The update writes only the state rows of x, which the next step's
    // towers read after its first barrier.
    const float dt = a.dts[n];
    for (int e = tid; e < S * TB; e += NT3) {
      const int r = e / S, i = e % S, row = row0 + r, k = i * TB + r;
      const float gv = g[k];
      const float gs = fabsf(gv) > EPS ? gv : (gv >= 0.f ? EPS : -EPS);
      const float u = (f[k] - h[k]) / gs;
      usq[k] = u * u;
      if (row >= B) continue;
      const size_t at = (size_t(n) * B + row) * S + i;
      const float y = x[(wt + i) * TB + r] + f[k] * dt + gv * a.noise[at];
      x[(wt + i) * TB + r] = y;
      a.ys[at] = y;
    }
    __syncthreads();
    if (tid < TB) {
      float sum = 0.f;
      for (int i = 0; i < S; ++i) sum += usq[i * TB + tid];
      q = q + 0.5f * sum * dt;
      const int row = row0 + tid;
      if (row < B) a.qs[size_t(n) * B + row] = q;
    }
  }
}

}  // namespace

extern "C" {

// Launches the solve on `stream` and returns cudaGetLastError() (0 on
// success). table_host and table_dev hold the same layer table (drift,
// diffusion, prior); all other pointers are device pointers to contiguous
// float32 arrays. Noise is diagonal: m = S.
int tsde_tower_euler_logqp_fwd(const int* table_host, const int* table_dev,
                               const float* fw, const float* gw,
                               const float* hw, const float* y0,
                               const float* noise, const float* t0s,
                               const float* dts, float* ys, float* qs,
                               int nf, int ng, int nh, int S, int m,
                               int diag, int wt, int stage, int B, int N,
                               int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  if (nh <= 0 || !diag || m != S)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.table = table_dev;
  a.pack[0] = fw; a.pack[1] = gw; a.pack[2] = hw;
  a.y0 = y0; a.noise = noise; a.t0s = t0s; a.dts = dts;
  a.ys = ys; a.qs = qs;
  a.d = {nf, ng, nh, S, m, diag, wt};
  a.stage = stage; a.B = B; a.N = N;
  const Layout s = make_layout(table_host, a.d, EULER_LOGQP_FWD, stage,
                               nullptr);
  err = prepare(tower_euler_logqp_fwd_kernel, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tower_euler_logqp_fwd_kernel<<<blocks_for(B), NT3,
                                 s.total * sizeof(float), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
