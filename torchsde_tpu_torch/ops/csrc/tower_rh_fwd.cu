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
// dependency. The earlier 8-row design (256 threads, the drift staged, the
// diffusion read from L2 at every step) took 2.7 ms against a 0.26 ms bound
// at batch 1024, d 128, hidden 128 (NVIDIA H100 80GB HBM3, 700 W).
//
// Design (tower_fwd_tile.cuh). A block runs the step loop for R rows; the
// host picks the design and R (fused_solve.forward_design). At d 128 the two
// towers (264 KB) do not fit a block: a cluster of two blocks on two SMs
// holds a tower each in shared memory, R = 16 rows (64 clusters, one wave).
// Both blocks keep the carry: z in the towers' input rows, y, f and g in
// arrays of their own, each element owned by one thread. After the towers
// each block reads the other's output through distributed shared memory;
// block 0 stores ys and zs, block 1 gs. Narrower towers that fit one block
// together run there, a tower to each half of its threads. The next step's
// noise, time and dt arrive by cp.async during the towers.

#include <cuda_runtime.h>
#include <stddef.h>

#include "tower_fwd_tile.cuh"

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
  int stage, R, cluster, B, N;
};

// One block an SM, as tower_euler_logqp_fwd.cu.
template <int NT>
__global__ void __launch_bounds__(NT, 1) tower_rh_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d = a.d;
  const int R = a.R, CL = a.cluster, RS = tile_ld(R);
  const int rank = CL > 1 ? cluster_rank() : 0;
  const int tid = threadIdx.x, row0 = (blockIdx.x / CL) * R;
  const int S = d.S, m = d.m, wt = d.wt, B = a.B, N = a.N, G = d.gwidth();
  const int gper = d.diag ? 1 : m;        // g entries of one state unit
  const TileLayout s = tile_setup<NT>(a.table, d, RH_FWD, a.stage, R, CL,
                                      rank, sm, a.pack);
  float* x = sm + s.x;                    // z in the state rows
  float* yc = sm + s.carry[0];
  float* fc = sm + s.carry[1];
  float* gc = sm + s.carry[2];
  // Rows past the end of the batch stay zero and are never stored.
  for (int e = tid; e < S * R; e += NT) {
    const int r = e / S, i = e % S, row = row0 + r;
    const bool valid = row < B;
    const float y = valid ? a.y0[size_t(row) * S + i] : 0.f;
    yc[i * RS + r] = y;
    x[(wt + i) * RS + r] = y;
    fc[i * RS + r] = valid ? a.f0[size_t(row) * S + i] : 0.f;
  }
  for (int e = tid; e < G * R; e += NT) {
    const int r = e / G, u = e % G, row = row0 + r;
    gc[u * RS + r] = row < B ? a.g0[size_t(row) * G + u] : 0.f;
  }
  tile_prefetch<NT>(s, sm, 0, 0, a.noise, a.t1s, a.dts, wt, m, B, row0, R);
  tile_cp_async_wait_all();
  __syncthreads();
  if (CL > 1) {                           // every block of the cluster runs
    cluster_arrive();
    cluster_wait();
  }
  // A cluster splits the stores: block 0 ys and zs, block 1 gs.
  const bool store_yz = rank == 0, store_g = rank == CL - 1;
  const int items = tile_items(S, R);
  const TileTower tw = tile_tower<NT>(s, d, a.stage, CL, rank, sm, a.pack);
  const float* f1 = tile_out(s, d, CL, rank, 0, sm);
  const float* g1 = tile_out(s, d, CL, rank, 1, sm);

  for (int n = 0; n < N; ++n) {
    if (n > 0) {
      tile_cp_async_wait_all();
      __syncthreads();
    }
    const float* nz = sm + s.nz[n & 1];   // [j][r]
    const float dt = sm[s.dt + (n & 1)];
    // A. z1 = 2 y - z + dt f + g . dW into the towers' input rows.
    for (int e = tid; e < items; e += NT) {
      const TileItem it = tile_item(e, S);
      const int i = it.i, r = it.r, row = row0 + r;
      if (i >= S) continue;
      float gdw;
      if (d.diag) {
        gdw = gc[i * RS + r] * nz[i * RS + r];
      } else {
        gdw = 0.f;
        for (int j = 0; j < m; ++j)
          gdw = fmaf(gc[(i * m + j) * RS + r], nz[j * RS + r], gdw);
      }
      const float z1 = 2.f * yc[i * RS + r] - x[(wt + i) * RS + r]
                       + dt * fc[i * RS + r] + gdw;
      x[(wt + i) * RS + r] = z1;
      if (store_yz && row < B) a.zs[(size_t(n) * B + row) * S + i] = z1;
    }
    __syncthreads();

    // B. f1, g1 at [t1 | z1].
    tile_towers(tw, x, R, CL > 1, n > 0, [&] {
      if (n + 1 < N)
        tile_prefetch<NT>(s, sm, n + 1, (n + 1) & 1, a.noise, a.t1s, a.dts,
                          wt, m, B, row0, R);
    });
    if (CL > 1) {                         // both towers' outputs are written
      cluster_arrive();
      cluster_wait();
    }

    // C. y1, and the carry moves on; each element by the thread that owns
    // it in phase A.
    for (int e = tid; e < items; e += NT) {
      const TileItem it = tile_item(e, S);
      const int i = it.i, r = it.r, row = row0 + r;
      if (i >= S) continue;
      const size_t at = size_t(n) * B + row;
      float gdw = 0.f;
      for (int u = i * gper, j = d.diag ? i : 0; u < (i + 1) * gper;
           ++u, ++j) {
        const float gn = g1[u * RS + r];
        gdw = fmaf(gc[u * RS + r] + gn, 0.5f * nz[j * RS + r], gdw);
        gc[u * RS + r] = gn;
        if (store_g && row < B) a.gs[at * G + u] = gn;
      }
      const float fn = f1[i * RS + r];
      const float y1 = yc[i * RS + r] + 0.5f * dt * (fc[i * RS + r] + fn)
                       + gdw;
      yc[i * RS + r] = y1;
      fc[i * RS + r] = fn;
      if (store_yz && row < B) a.ys[at * S + i] = y1;
    }
    if (CL > 1) cluster_arrive();         // done with the other's output
  }
  // No block leaves while another may still read its shared memory.
  if (CL > 1) cluster_wait();
}

template <int NT>
int launch(const Args& a, const TileLayout& s, cudaStream_t stream) {
  return static_cast<int>(launch_tile(tower_rh_fwd_kernel<NT>, a, a.B, a.R,
                                      NT, a.cluster, s, stream));
}

template <int NT>
int clusters(int smem, int cluster) {
  return tile_max_clusters(tower_rh_fwd_kernel<NT>, NT, smem, cluster);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of kernel 11 (kind 2) or 13 (kind 4)
// needs for this host layer table at `rows` rows a block, in clusters of
// `cluster` blocks, the towers of `stage` staged (fused_solve.
// fwd_smem_bytes computes the same on the host).
size_t tsde_tower_fwd_smem_bytes(int kind, const int* table, int nf, int ng,
                                 int nh, int S, int m, int diag, int wt,
                                 int stage, int rows, int cluster) {
  const Dims d = {nf, ng, nh, S, m, diag, wt};
  return make_tile_layout(table, d, kind, stage, rows, cluster, nullptr)
             .total * sizeof(float);
}

// Launches the solve on `stream` and returns the CUDA error code (0 on
// success). table_host and table_dev hold the same layer table; all other
// pointers are device pointers to contiguous float32 arrays. The design as
// tsde_tower_euler_logqp_fwd's: R rows a block, `threads` threads, clusters
// of `cluster` blocks (1, or 2: a tower a block), the towers of `stage`.
int tsde_tower_rh_fwd(const int* table_host, const int* table_dev,
                      const float* fw, const float* gw, const float* y0,
                      const float* f0, const float* g0, const float* noise,
                      const float* t1s, const float* dts, float* ys,
                      float* zs, float* gs, int nf, int ng, int nh, int S,
                      int m, int diag, int wt, int stage, int rows,
                      int threads, int cluster, int B, int N, int device,
                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  Args a;
  a.table = table_dev;
  a.pack[0] = fw; a.pack[1] = gw;
  a.y0 = y0; a.f0 = f0; a.g0 = g0; a.noise = noise; a.t1s = t1s;
  a.dts = dts; a.ys = ys; a.zs = zs; a.gs = gs;
  a.d = {nf, ng, nh, S, m, diag, wt};
  a.stage = cluster > 1 ? 3 : stage;
  a.R = rows; a.cluster = cluster; a.B = B; a.N = N;
  if (nh != 0 || !tile_design_ok(a.d, rows, threads, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const TileLayout s = make_tile_layout(table_host, a.d, RH_FWD, a.stage,
                                        rows, cluster, nullptr);
  switch (threads) {
    case 256: return launch<256>(a, s, stream);
    case 384: return launch<384>(a, s, stream);
    case 512: return launch<512>(a, s, stream);
    case 768: return launch<768>(a, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Clusters of `cluster` blocks of `threads` threads and `smem` bytes the
// card runs at once (tile_max_clusters), for measurement.
int tsde_tower_rh_fwd_clusters(int threads, int smem, int cluster) {
  switch (threads) {
    case 256: return clusters<256>(smem, cluster);
    case 384: return clusters<384>(smem, cluster);
    case 512: return clusters<512>(smem, cluster);
    case 768: return clusters<768>(smem, cluster);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
