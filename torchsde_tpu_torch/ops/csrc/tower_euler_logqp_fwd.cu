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
// The earlier 8-row design (384 threads, 512 blocks at batch 4096) read
// every weight from L2 at every step, 8 multiply-adds a load, and took
// 3.2 ms against a 0.39 ms bound at d 32 (NVIDIA H100 80GB HBM3, 700 W).
//
// Design (tower_fwd_tile.cuh). A block runs the step loop for R rows; the
// host picks the design and R (fused_solve.forward_design): at d 32 all
// three towers sit in one block's shared memory and R = 32 gives one wave
// of blocks, a tower to each third of the threads; towers too large for a
// block go a tower to a block of a cluster of three. Each step: the
// towers, a layer depth per barrier, the next step's noise, time and dt
// copied in by cp.async after the first layer; then a thread per (unit,
// row) forms u, the state update and u^2, which 8 lanes sum in a fixed tree
// into a part of the row's sum; after a barrier thread r sums its row's
// parts in order and carries its row's q in a register. Plain f32 FMAs,
// IEEE division, no fast math.

#include <cuda_runtime.h>
#include <stddef.h>

#include "tower_fwd_tile.cuh"

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
  int stage, R, cluster, B, N;
};

// One block an SM: its shared memory allows no more, and the bound lets
// ptxas give each thread the registers of the whole SM.
template <int NT>
__global__ void __launch_bounds__(NT, 1)
    tower_euler_logqp_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d = a.d;
  const int R = a.R, CL = a.cluster, RS = tile_ld(R);
  const int rank = CL > 1 ? cluster_rank() : 0;
  const int tid = threadIdx.x, row0 = (blockIdx.x / CL) * R;
  const int S = d.S, wt = d.wt, B = a.B, N = a.N;
  const TileLayout s = tile_setup<NT>(a.table, d, EULER_LOGQP_FWD, a.stage,
                                      R, CL, rank, sm, a.pack);
  float* x = sm + s.x;
  float* part = sm + s.carry[0];          // [p][r]: parts of sum u^2
  // Rows past the end of the batch compute on zeros and are never stored.
  for (int e = tid; e < S * R; e += NT) {
    const int r = e / S, i = e % S, row = row0 + r;
    x[(wt + i) * RS + r] = row < B ? a.y0[size_t(row) * S + i] : 0.f;
  }
  tile_prefetch<NT>(s, sm, 0, 0, a.noise, a.t0s, a.dts, wt, S, B, row0, R);
  tile_cp_async_wait_all();
  __syncthreads();
  if (CL > 1) {                           // every block of the cluster runs
    cluster_arrive();
    cluster_wait();
  }
  // A cluster splits the stores: block 0 the states, the last block q.
  const bool store_y = rank == 0, store_q = rank == CL - 1;
  const int items = tile_items(S, R), parts = tile_parts(S);
  const TileTower tw = tile_tower<NT>(s, d, a.stage, CL, rank, sm, a.pack);
  const float* f = tile_out(s, d, CL, rank, 0, sm);
  const float* g = tile_out(s, d, CL, rank, 1, sm);
  const float* h = tile_out(s, d, CL, rank, 2, sm);
  float q = 0.f;                          // thread r < R: row r's KL

  for (int n = 0; n < N; ++n) {
    if (n > 0) {
      tile_cp_async_wait_all();
      __syncthreads();
    }
    tile_towers(tw, x, R, CL > 1, n > 0, [&] {
      if (n + 1 < N)
        tile_prefetch<NT>(s, sm, n + 1, (n + 1) & 1, a.noise, a.t0s, a.dts,
                          wt, S, B, row0, R);
    });
    if (CL > 1) {                         // every tower's output is written
      cluster_arrive();
      cluster_wait();
    }
    const float* nz = sm + s.nz[n & 1];
    const float dt = sm[s.dt + (n & 1)];
    // The update writes only the state rows of x, which the next step's
    // towers read after its first barrier.
    for (int e = tid; e < items; e += NT) {
      const TileItem it = tile_item(e, S);
      const int i = it.i, r = it.r, row = row0 + r;
      float usq = 0.f;
      if (i < S) {
        const int k = i * RS + r;
        const float gv = g[k];
        const float gs = fabsf(gv) > EPS ? gv : (gv >= 0.f ? EPS : -EPS);
        const float u = (f[k] - h[k]) / gs;
        usq = u * u;
        const float y = x[(wt + i) * RS + r] + f[k] * dt + gv * nz[k];
        x[(wt + i) * RS + r] = y;
        if (store_y && row < B) a.ys[(size_t(n) * B + row) * S + i] = y;
      }
      // The part of units [8p, 8p + 8): the same tree in every lane.
      usq += __shfl_xor_sync(0xffffffffu, usq, 1);
      usq += __shfl_xor_sync(0xffffffffu, usq, 2);
      usq += __shfl_xor_sync(0xffffffffu, usq, 4);
      if ((e & 7) == 0) part[(i / UP) * RS + r] = usq;
    }
    if (CL > 1) cluster_arrive();         // done with the others' outputs
    __syncthreads();
    if (store_q && tid < R) {
      float sum = 0.f;
      for (int p = 0; p < parts; ++p) sum += part[p * RS + tid];
      q = q + 0.5f * sum * dt;
      const int row = row0 + tid;
      if (row < B) a.qs[size_t(n) * B + row] = q;
    }
  }
  // No block leaves while another may still read its shared memory.
  if (CL > 1) cluster_wait();
}

template <int NT>
int launch(const Args& a, const TileLayout& s, cudaStream_t stream) {
  return static_cast<int>(launch_tile(tower_euler_logqp_fwd_kernel<NT>, a,
                                      a.B, a.R, NT, a.cluster, s, stream));
}

template <int NT>
int clusters(int smem, int cluster) {
  return tile_max_clusters(tower_euler_logqp_fwd_kernel<NT>, NT, smem, cluster);
}

}  // namespace

extern "C" {

// Launches the solve on `stream` and returns the CUDA error code (0 on
// success). table_host and table_dev hold the same layer table (drift,
// diffusion, prior); all other pointers are device pointers to contiguous
// float32 arrays. Noise is diagonal: m = S. The design (fused_solve.
// forward_design): R rows a block (8, 16 or 32) on `threads` threads (256,
// 384, 512 or 768), in clusters of `cluster` blocks (1, or 3: a tower a
// block), the towers of `stage` staged in shared memory (a cluster stages
// every tower, each in its block).
int tsde_tower_euler_logqp_fwd(const int* table_host, const int* table_dev,
                               const float* fw, const float* gw,
                               const float* hw, const float* y0,
                               const float* noise, const float* t0s,
                               const float* dts, float* ys, float* qs,
                               int nf, int ng, int nh, int S, int m,
                               int diag, int wt, int stage, int rows,
                               int threads, int cluster, int B, int N,
                               int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  Args a;
  a.table = table_dev;
  a.pack[0] = fw; a.pack[1] = gw; a.pack[2] = hw;
  a.y0 = y0; a.noise = noise; a.t0s = t0s; a.dts = dts;
  a.ys = ys; a.qs = qs;
  a.d = {nf, ng, nh, S, m, diag, wt};
  a.stage = cluster > 1 ? 7 : stage;
  a.R = rows; a.cluster = cluster; a.B = B; a.N = N;
  if (nh <= 0 || !diag || m != S ||
      !tile_design_ok(a.d, rows, threads, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const TileLayout s = make_tile_layout(table_host, a.d, EULER_LOGQP_FWD,
                                        a.stage, rows, cluster, nullptr);
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
int tsde_tower_euler_logqp_fwd_clusters(int threads, int smem, int cluster) {
  switch (threads) {
    case 256: return clusters<256>(smem, cluster);
    case 384: return clusters<384>(smem, cluster);
    case 512: return clusters<512>(smem, cluster);
    case 768: return clusters<768>(smem, cluster);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
