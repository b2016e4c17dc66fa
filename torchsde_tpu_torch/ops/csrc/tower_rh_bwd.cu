// Reverse sweep of the whole-solve reversible Heun of a TowerSpec SDE, for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/fused_solve.py:
// _rh_bwd_kernel, launched by _make_rh's bwd_impl. It carries the cotangents
// (ay, az, af, ag) of the forward's carry (y, z, f, g) from the last step to
// the first. For each step n, with g_n = g0 or gs[n-1] and g_{n+1} = gs[n]:
//   ay += gy[n];  Af = af + dt/2 ay;  Ag = ag + ay (x) dW/2
//   recompute both towers at [t1_n? | zs[n]]; backpropagate Af through the
//   drift and Ag through the diffusion, adding every weight gradient;
//   Az = az + the input cotangent's state columns
//   dnoise[n] = Az . g_n + ay/2 . (g_n + g_{n+1})
//   ay <- ay + 2 Az;  az <- -Az;  af <- dt/2 ay + dt Az
//   ag <- (ay/2 + Az) (x) dW
// and at the end dy0 = ay + az, df0 = af, dg0 = ag. Here a (x) dW is a * dW,
// or the outer product a[i] dW[j] for general noise, and a . g is a * g, or
// sum_i a[i] g[i, j].
//
// What bounds it: as tower_euler_bwd.cu, three times the forward's tower
// multiply-adds per row and step; arithmetic and the dependency of the
// carried cotangents.
//
// Design (tower_solve_common.cuh): one block per tile of TB = 8 rows sweeps
// the steps backwards, the towers side by side, each layer's activations
// kept in shared memory; the carried cotangents in shared memory, each
// element owned by one thread. Weight gradients go to a private float32
// partial per block in device memory, summed over blocks in a fixed order by
// a second kernel: no atomics, bitwise repeatable.

#include <cuda_runtime.h>
#include <stddef.h>

#include "tower_solve_common.cuh"

namespace {

using namespace tsde_tower;

struct Args {
  const int* table;
  const float* pack[2];  // fw, gw
  const float* g0;       // (B, G), G = S or S*m
  const float* noise;    // (N, B, m)
  const float* t1s;      // (N,)
  const float* dts;      // (N,)
  const float* zs;       // (N, B, S)
  const float* gs;       // (N, B, G)
  const float* gy;       // (N, B, S)
  float* dy0;            // (B, S)
  float* df0;            // (B, S)
  float* dg0;            // (B, G)
  float* dnoise;         // (N, B, m)
  float* partials;       // (blocks, P)
  size_t P;
  Dims d;
  int stage, B, N;
};

__global__ void __launch_bounds__(NT) tower_rh_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d = a.d;
  const float* w[2];
  const Layout s = setup(a.table, d, RH_BWD, a.stage, sm, a.pack, w);
  const Layer* plan = reinterpret_cast<const Layer*>(sm + s.plan);
  const int tid = threadIdx.x, row0 = blockIdx.x * TB;
  const int S = d.S, m = d.m, wt = d.wt, B = a.B, G = d.gwidth();
  const int gper = d.diag ? 1 : m;        // g entries of one state unit
  float* x = sm + s.x;
  float* ay = sm + s.carry[0];
  float* az = sm + s.carry[1];
  float* af = sm + s.carry[2];
  float* ag = sm + s.carry[3];
  float* Az = sm + s.carry[4];
  float* dout_f = sm + s.dout[0];
  float* dout_g = sm + s.dout[1];
  float* part = a.partials + size_t(blockIdx.x) * a.P;
  // Thread (r, i) owns ay[i], az[i], af[i] and ag[i, :] of row r.
  for (int e = tid; e < S * TB; e += NT) {
    ay[e] = az[e] = af[e] = 0.f;
  }
  for (int e = tid; e < G * TB; e += NT) ag[e] = 0.f;
  __syncthreads();

  for (int n = a.N - 1; n >= 0; --n) {
    const bool first = n == a.N - 1;
    const float dt = a.dts[n];
    // A. x = [t1 | z_{n+1}]; ay takes gy; the towers' output cotangents
    // Af and Ag. Rows past the end of the batch stay zero throughout.
    for (int e = tid; e < S * TB; e += NT) {
      const int r = e / S, i = e % S, row = row0 + r;
      const bool valid = row < B;
      const size_t at = size_t(n) * B + row;
      x[(wt + i) * TB + r] = valid ? a.zs[at * S + i] : 0.f;
      const float v = ay[i * TB + r] + (valid ? a.gy[at * S + i] : 0.f);
      ay[i * TB + r] = v;
      dout_f[i * TB + r] = af[i * TB + r] + 0.5f * dt * v;
      const float* dW = a.noise + at * m;
      for (int u = i * gper, j = d.diag ? i : 0; u < (i + 1) * gper;
           ++u, ++j)
        dout_g[u * TB + r] = ag[u * TB + r]
                             + (valid ? v * (0.5f * dW[j]) : 0.f);
    }
    if (wt && tid < TB) x[tid] = a.t1s[n];
    __syncthreads();

    // B. Recompute both towers, keeping each layer's activations; then both
    // back to their input, every weight gradient into the block's partial.
    towers_forward(plan, d, s, w, sm, true);
    towers_backward(plan, d, s, w, sm, part, first);

    // C. Az = az + the input cotangent's state columns.
    for (int e = tid; e < S * TB; e += NT) {
      const int r = e / S, i = e % S;
      Az[i * TB + r] = az[i * TB + r] + dout_f[(wt + i) * TB + r]
                       + dout_g[(wt + i) * TB + r];
    }
    __syncthreads();

    // D. dnoise by thread (r, j), and ag by its owner; both read ay and Az
    // as they are before E.
    const float* gn = n == 0 ? a.g0 : a.gs + size_t(n - 1) * B * G;
    const float* gx = a.gs + size_t(n) * B * G;
    for (int e = tid; e < m * TB; e += NT) {
      const int r = e / m, j = e % m, row = row0 + r;
      if (row >= B) continue;
      const float* gnr = gn + size_t(row) * G;
      const float* gxr = gx + size_t(row) * G;
      float v = 0.f;
      if (d.diag) {
        v = Az[j * TB + r] * gnr[j]
            + 0.5f * ay[j * TB + r] * (gnr[j] + gxr[j]);
      } else {
        for (int i = 0; i < S; ++i) {
          const int u = i * m + j;
          v += Az[i * TB + r] * gnr[u]
               + 0.5f * ay[i * TB + r] * (gnr[u] + gxr[u]);
        }
      }
      a.dnoise[(size_t(n) * B + row) * m + j] = v;
    }
    for (int e = tid; e < S * TB; e += NT) {
      const int r = e / S, i = e % S, row = row0 + r;
      const float c = 0.5f * ay[i * TB + r] + Az[i * TB + r];
      const float* dW = a.noise + (size_t(n) * B + row) * m;
      for (int u = i * gper, j = d.diag ? i : 0; u < (i + 1) * gper;
           ++u, ++j)
        ag[u * TB + r] = row < B ? c * dW[j] : 0.f;
    }
    __syncthreads();

    // E. The carried cotangents move on. The next step's phase A touches
    // only what the same thread owns here, and writes the dout buffers,
    // which phase C read before its barrier.
    for (int e = tid; e < S * TB; e += NT) {
      const int r = e / S, i = e % S;
      const float v = ay[i * TB + r], A = Az[i * TB + r];
      ay[i * TB + r] = v + 2.f * A;
      az[i * TB + r] = -A;
      af[i * TB + r] = 0.5f * dt * v + dt * A;
    }
  }

  for (int e = tid; e < S * TB; e += NT) {
    const int r = e / S, i = e % S, row = row0 + r;
    if (row >= B) continue;
    a.dy0[size_t(row) * S + i] = ay[i * TB + r] + az[i * TB + r];
    a.df0[size_t(row) * S + i] = af[i * TB + r];
    for (int u = i * gper; u < (i + 1) * gper; ++u)
      a.dg0[size_t(row) * G + u] = ag[u * TB + r];
  }
}

}  // namespace

extern "C" {

// Launches the sweep and the sum of its partials on `stream` and returns
// cudaGetLastError() (0 on success). table_host and table_dev hold the same
// layer table; all other pointers are device pointers to contiguous float32
// arrays. partials holds tsde_tower_blocks(B) x P floats and dw P floats, P
// the two packs' total size; dw receives [dfw | dgw].
int tsde_tower_rh_bwd(const int* table_host, const int* table_dev,
                      const float* fw, const float* gw, const float* g0,
                      const float* noise, const float* t1s, const float* dts,
                      const float* zs, const float* gs, const float* gy,
                      float* dy0, float* df0, float* dg0, float* dnoise,
                      float* partials, float* dw, int nf, int ng, int nh,
                      int S, int m, int diag, int wt, int stage, int B, int N,
                      int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  Args a;
  a.table = table_dev;
  a.pack[0] = fw; a.pack[1] = gw;
  a.g0 = g0; a.noise = noise; a.t1s = t1s; a.dts = dts; a.zs = zs;
  a.gs = gs; a.gy = gy; a.dy0 = dy0; a.df0 = df0; a.dg0 = dg0;
  a.dnoise = dnoise; a.partials = partials;
  a.d = {nf, ng, nh, S, m, diag, wt};
  a.stage = stage; a.B = B; a.N = N;
  const Layout s = make_layout(table_host, a.d, RH_BWD, stage, nullptr);
  a.P = s.P;
  err = prepare(tower_rh_bwd_kernel, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = blocks_for(B);
  tower_rh_bwd_kernel<<<blocks, NT, s.total * sizeof(float), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(partials, blocks, s.P, dw, stream));
}

}  // extern "C"
