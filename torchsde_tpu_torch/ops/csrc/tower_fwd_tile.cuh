// Row tiles for the whole-solve forward kernels 9, 11 and 13
// (tower_euler_fwd.cu, tower_rh_fwd.cu, tower_euler_logqp_fwd.cu), beside
// the 8-row helpers of tower_solve_common.cuh, whose layer table, plan and
// activations they share; and, at the end, kernel 9's 3xTF32 tiles.
//
// A block (or a cluster of blocks) holds R rows (8, 16 or 32) and runs the
// whole step loop. Three designs, chosen on the host from the widths, the
// batch, the SM count and the shared-memory limits
// (fused_solve.forward_design):
//   - block: every tower in the block's shared memory, the block's threads
//     split evenly over the towers;
//   - cluster: a thread-block cluster of one block a tower, each holding
//     its own tower in shared memory; after the towers' last layer every
//     block reads the others' outputs through distributed shared memory
//     and runs the (cheap) update itself, so each keeps the state;
//   - streamed: a block as in the first design, the towers that do not fit
//     read from their packs in device memory through L2.
// Inside a tower, an item of a layer is one output unit j for RP rows (16,
// 8 or 4: the most that still give every thread of the tower an item): the
// thread reads W[k][j] once and the RP rows of the layer's input as float4
// broadcasts, so a weight read feeds RP multiply-adds.
//
// A row's arithmetic does not depend on R, on the thread count or on the
// design: every layer unit is one fmaf chain over its inputs in order, then
// the bias and the activation (as layer_forward), and a row's sum over the
// state units (kernel 13's sum of u^2) is over fixed parts of 8 units, each
// a fixed tree of adds across 8 lanes, the parts then summed in order.
//
// The [unit][row] arrays have a row stride of R + 4 floats: a warp of the
// update (8 units by 4 rows) and the layers' float4 stores then touch
// distinct banks. Staged weights keep their pack's layout (W [in][out] then
// b, a layer after the other), so staging is one copy of the pack.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "mma_tf32.cuh"
#include "tower_solve_common.cuh"

namespace tsde_tower {

constexpr int UP = 8;   // state units of a part of a row's sum (8 lanes)

__host__ __device__ inline int tile_ld(int R) { return R + 4; }

__host__ __device__ inline int tile_parts(int S) { return (S + UP - 1) / UP; }

// Offsets (in floats) of a tile kernel's arrays in dynamic shared memory.
struct TileLayout {
  size_t plan;
  size_t w[MAX_TOWERS];       // staged packs (a cluster: its block's, w[0])
  size_t x;                   // [k][r]: the towers' input [t? | state]
  size_t buf[MAX_TOWERS][2];  // each tower's even and odd layers' outputs
                              // (a cluster: buf[0], sized for any tower)
  size_t nz[2];               // [j][r]: a step's noise, two steps' slots
  size_t dt;                  // the two slots' dt
  size_t carry[3];            // RH_FWD: y, f, g [unit][row]; EULER_LOGQP_
                              // FWD: carry[0], the parts of u^2 [part][row];
                              // EULER_FWD: none
  size_t total;
  int maxl;
};

// The layout of a forward tile kernel of `kind` (EULER_FWD, RH_FWD or
// EULER_LOGQP_FWD) at R rows; `cluster` 1 for one block holding the towers
// of `stage` (bit t: tower t in shared memory), else the cluster's size
// (a tower a block, each staged). Fills `plan` when it is not null.
__host__ __device__ inline TileLayout make_tile_layout(const int* table,
                                                       Dims d, int kind,
                                                       int stage, int R,
                                                       int cluster,
                                                       Layer* plan) {
  TileLayout s = {};
  size_t at = 0;
  const size_t RS = tile_ld(R);
  s.plan = take(at, size_t(d.nf + d.ng + d.nh) * PLAN_INTS);
  int pack[MAX_TOWERS] = {0, 0, 0};
  int wide[MAX_TOWERS][2] = {{0, 0}, {0, 0}, {0, 0}};
  for (int t = 0; t < d.towers(); ++t) {
    for (int i = 0; i < d.nl(t); ++i) {
      const int* row = table + TABLE_COLS * (d.base(t) + i);
      Layer L = {};
      L.in = row[0];
      L.out = row[1];
      L.act = row[2];
      L.g = L.w = pack[t];
      L.b = pack[t] + L.in * L.out;
      L.ld = L.out;
      pack[t] += L.in * L.out + L.out;
      wide[t][i & 1] = imax(wide[t][i & 1], L.out);
      if (plan) plan[d.base(t) + i] = L;
    }
  }
  s.maxl = imax(imax(d.nf, d.ng), d.nh);
  if (cluster > 1) {
    int most = 0;
    for (int t = 0; t < d.towers(); ++t) most = imax(most, pack[t]);
    s.w[0] = take(at, most);
  } else {
    for (int t = 0; t < d.towers(); ++t)
      s.w[t] = (stage >> t) & 1 ? take(at, pack[t]) : 0;
  }
  s.x = take(at, size_t(d.in0()) * RS);
  if (cluster > 1) {
    int even = 0, odd = 0;
    for (int t = 0; t < d.towers(); ++t) {
      even = imax(even, wide[t][0]);
      odd = imax(odd, wide[t][1]);
    }
    s.buf[0][0] = take(at, even * RS);
    s.buf[0][1] = take(at, odd * RS);
  } else {
    for (int t = 0; t < d.towers(); ++t) {
      s.buf[t][0] = take(at, wide[t][0] * RS);
      s.buf[t][1] = take(at, wide[t][1] * RS);
    }
  }
  s.nz[0] = take(at, d.m * RS);
  s.nz[1] = take(at, d.m * RS);
  s.dt = take(at, 2);
  if (kind == RH_FWD) {
    s.carry[0] = take(at, d.S * RS);                   // y
    s.carry[1] = take(at, d.S * RS);                   // f
    s.carry[2] = take(at, d.gwidth() * RS);            // g
  } else if (kind == EULER_LOGQP_FWD) {
    s.carry[0] = take(at, tile_parts(d.S) * RS);       // parts of u^2
  }
  s.total = at;
  return s;
}

// Rows an item of a layer of `out` units takes, for a tower's NTT threads.
__host__ __device__ inline int tile_rows_a_thread(int out, int R, int NTT) {
  for (int rp = 16; rp > 4; rp /= 2)
    if (rp <= R && out * (R / rp) >= NTT) return rp;
  return 4;
}

__device__ __forceinline__ void tile_cp_async4(float* dst, const float* src,
                                               bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void tile_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void tile_cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The two halves of a cluster barrier: arrive releases this thread's
// shared-memory accesses so far, wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  return static_cast<int>(cooperative_groups::this_cluster().block_rank());
}

// A shared-memory address of this block as block `rank` of the cluster
// has it.
__device__ __forceinline__ const float* cluster_remote(const float* p,
                                                       int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(
      const_cast<float*>(p), static_cast<unsigned>(rank));
}

// Item (j, r0) of a layer: out[j][r0 + r] = act(in[:, r0 + r] . W[:, j] +
// b[j]) for r < RP, W [in][out] from w + L.w, rows of stride RS.
template <int RP>
__device__ __forceinline__ void tile_unit(const Layer& L,
                                          const float* __restrict__ w,
                                          const float* in, float* out,
                                          int RS, int j, int r0) {
  float acc[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) acc[r] = 0.f;
  const float* wj = w + L.w + j;
  const float* xr = in + r0;
#pragma unroll 4
  for (int k = 0; k < L.in; ++k) {
    const float wk = wj[k * L.out];
#pragma unroll
    for (int q = 0; q < RP / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(xr + k * RS + 4 * q);
      acc[4 * q] = fmaf(v.x, wk, acc[4 * q]);
      acc[4 * q + 1] = fmaf(v.y, wk, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, wk, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, wk, acc[4 * q + 3]);
    }
  }
  const float b = w[L.b + j];
  float* o = out + j * RS + r0;
#pragma unroll
  for (int q = 0; q < RP / 4; ++q) {
    float4 v;
    v.x = act_fwd(acc[4 * q] + b, L.act);
    v.y = act_fwd(acc[4 * q + 1] + b, L.act);
    v.z = act_fwd(acc[4 * q + 2] + b, L.act);
    v.w = act_fwd(acc[4 * q + 3] + b, L.act);
    *reinterpret_cast<float4*>(o + 4 * q) = v;
  }
}

// One layer of a tower for R rows on the tower's NTT threads (this one
// tt).
__device__ inline void tile_layer(const Layer& L, const float* w,
                                  const float* in, float* out, int R, int tt,
                                  int NTT) {
  const int RP = tile_rows_a_thread(L.out, R, NTT), RS = tile_ld(R);
  const int items = L.out * (R / RP);
  for (int it = tt; it < items; it += NTT) {
    const int j = it % L.out, r0 = (it / L.out) * RP;
    if (RP == 16)
      tile_unit<16>(L, w, in, out, RS, j, r0);
    else if (RP == 8)
      tile_unit<8>(L, w, in, out, RS, j, r0);
    else
      tile_unit<4>(L, w, in, out, RS, j, r0);
  }
}

// Element t of a tower array, by selects rather than an index that would
// put the array in local memory.
template <typename T>
__device__ __forceinline__ T tower_pick(const T* v, int t) {
  return t == 0 ? v[0] : t == 1 ? v[1] : v[2];
}

// Builds the plan (thread 0) and starts the copies of the packs this block
// stages (a cluster's block: its own tower's); returns the layout. The
// caller waits for the copies and syncs before using either.
template <int NT>
__device__ inline TileLayout tile_setup(const int* table, Dims d, int kind,
                                        int stage, int R, int cluster,
                                        int rank, float* sm,
                                        const float* const* pack) {
  const TileLayout s = make_tile_layout(table, d, kind, stage, R, cluster,
                                        nullptr);
  if (threadIdx.x == 0)
    make_tile_layout(table, d, kind, stage, R, cluster,
                     reinterpret_cast<Layer*>(sm + s.plan));
  for (int t = 0; t < d.towers(); ++t) {
    const bool mine = cluster > 1 ? t == rank : ((stage >> t) & 1);
    if (!mine) continue;
    int size = 0;
    for (int i = 0; i < d.nl(t); ++i) {
      const int* row = table + TABLE_COLS * (d.base(t) + i);
      size += row[0] * row[1] + row[1];
    }
    float* dst = sm + (cluster > 1 ? s.w[0] : tower_pick(s.w, t));
    const float* src = tower_pick(pack, t);
    for (int e = threadIdx.x; e < size; e += NT)
      tile_cp_async4(dst + e, src + e, true);
  }
  tile_cp_async_commit();
  return s;
}

// This thread's tower in a tile kernel: its layers, its weights (shared
// memory where they are staged in this block, else the pack in device
// memory), its two activation buffers, and its place among the tower's
// threads. Built once, before the step loop.
struct TileTower {
  const Layer* plan;
  const float* w;
  float* buf0;
  float* buf1;
  int nl, tt, NTT, depth;
};

template <int NT>
__device__ inline TileTower tile_tower(const TileLayout& s, Dims d,
                                       int stage, int cluster, int rank,
                                       float* sm, const float* const* pack) {
  const int NTT = cluster > 1 ? NT : NT / d.towers();
  const int t = cluster > 1 ? rank : threadIdx.x / NTT;
  const int b = cluster > 1 ? 0 : t;
  TileTower tw;
  tw.plan = reinterpret_cast<const Layer*>(sm + s.plan) + d.base(t);
  if (cluster > 1)
    tw.w = sm + s.w[0];
  else
    tw.w = (stage >> t) & 1 ? sm + tower_pick(s.w, t) : tower_pick(pack, t);
  tw.buf0 = sm + (b == 0 ? s.buf[0][0] : b == 1 ? s.buf[1][0] : s.buf[2][0]);
  tw.buf1 = sm + (b == 0 ? s.buf[0][1] : b == 1 ? s.buf[1][1] : s.buf[2][1]);
  tw.nl = d.nl(t);
  tw.tt = cluster > 1 ? threadIdx.x : threadIdx.x % NTT;
  tw.NTT = NTT;
  tw.depth = cluster > 1 ? tw.nl : s.maxl;
  return tw;
}

// Tower t's output [unit][row] after the towers: in this block, or (a
// cluster) in block t's shared memory. Fixed for the whole solve.
__device__ inline const float* tile_out(const TileLayout& s, Dims d,
                                        int cluster, int rank, int t,
                                        const float* sm) {
  const int odd = (d.nl(t) - 1) & 1;
  if (cluster == 1) {
    const size_t at = t == 0 ? s.buf[0][odd] : t == 1 ? s.buf[1][odd]
                                                      : s.buf[2][odd];
    return sm + at;
  }
  const float* p = sm + s.buf[0][odd];
  return t == rank ? p : cluster_remote(p, t);
}

// Starts step n's copies into slot `slot`: its noise (N, B, m) as [j][r]
// (rows past the batch zero-filled), its dt and, with a time column, its
// time into x's unit 0 (row r at x + r * xstride). One commit group.
template <int NT, typename Layout>
__device__ inline void tile_prefetch(const Layout& s, float* sm, int n,
                                     int slot, const float* noise,
                                     const float* times, const float* dts,
                                     int wt, int m, int B, int row0, int R,
                                     int xstride = 1) {
  const int RS = tile_ld(R);
  const float* src = noise + size_t(n) * B * m;
  float* nz = sm + s.nz[slot];
  for (int e = threadIdx.x; e < R * m; e += NT) {
    const int r = e / m, j = e % m, row = row0 + r;
    const bool valid = row < B;
    tile_cp_async4(nz + j * RS + r, valid ? src + size_t(row) * m + j : noise,
                   valid);
  }
  if (wt)
    for (int r = threadIdx.x; r < R; r += NT)
      tile_cp_async4(sm + s.x + r * xstride, times + n, true);
  if (threadIdx.x == 0) tile_cp_async4(sm + s.dt + slot, dts + n, true);
  tile_cp_async_commit();
}

// The towers of one step for the block's rows from x (tw: this thread's
// tower). Without a cluster the block's threads are split evenly over the
// towers, one layer depth per barrier; a cluster's block runs its own
// tower. After the first layer the next step's copies start (`next`, which
// may not touch what the later layers read); a cluster's block waits,
// before the first layer that writes the buffer its output is in, for the
// other blocks to have read the last step's output there (`wait_out`).
// Ends with a barrier.
template <typename Next>
__device__ inline void tile_towers(const TileTower& tw, const float* x,
                                   int R, bool cluster, bool wait_out,
                                   Next next) {
  for (int i = 0; i < tw.depth; ++i) {
    if (cluster && wait_out && i == ((tw.nl - 1) & 1)) cluster_wait();
    if (i < tw.nl) {
      const float* in = i == 0 ? x : ((i - 1) & 1 ? tw.buf1 : tw.buf0);
      tile_layer(tw.plan[i], tw.w, in, i & 1 ? tw.buf1 : tw.buf0, R, tw.tt,
                 tw.NTT);
    }
    __syncthreads();
    if (i == 0) next();
  }
}

// Item e of an update over the state units and rows: a warp takes 8 units
// by 4 rows (units fastest), so that its shared-memory reads hit distinct
// banks and its stores to (row, unit) arrays are four 32-byte runs. Units
// past S are masked, not skipped, so every lane of a warp takes part.
struct TileItem {
  int i, r;
};

__device__ __forceinline__ TileItem tile_item(int e, int S) {
  const int lane = e & 31, w = e >> 5, groups = (S + UP - 1) / UP;
  return {(w % groups) * UP + (lane & 7), (w / groups) * 4 + (lane >> 3)};
}

__host__ __device__ inline int tile_items(int S, int R) {
  return tile_parts(S) * UP * R;
}

// Launches a tile kernel of `threads` threads a block over B rows, R a
// block, in clusters of `cluster` blocks.
template <typename Args>
inline cudaError_t launch_tile(void (*kernel)(Args), const Args& a, int B,
                               int R, int threads, int cluster,
                               const TileLayout& s, cudaStream_t stream) {
  const size_t smem = s.total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((B + R - 1) / R * cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// How many clusters of `cluster` blocks of a tile kernel of `threads`
// threads and `smem` bytes the card runs at once (0 when it cannot run
// one), or a negative CUDA error code.
template <typename Args>
inline int tile_max_clusters(void (*kernel)(Args), int threads, int smem,
                             int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Whether a design is one the tile kernels take: R of 8, 16 or 32; a
// cluster of one block a tower, or none; without a cluster, threads a
// tower a multiple of 32.
__host__ __device__ inline bool tile_design_ok(Dims d, int R, int threads,
                                               int cluster) {
  if (R != 8 && R != 16 && R != 32) return false;
  if (cluster != 1 && cluster != d.towers()) return false;
  return cluster > 1 || threads % (32 * d.towers()) == 0;
}

// ---------------------------------------------------------------------------
// 3xTF32 row tiles (kernel 9's design where every tower fits a block split;
// mma_tf32.cuh). A block holds MMA_ROWS = 32 rows (two m-tiles of 16: at 8
// or 16 rows, an m-tile half zero or one a block, these tiles lost to the
// FMA tiles) and every tower's weights, split into TF32 halves and laid
// out as B fragments. A layer is one product [32 x in] . [in x out] on its
// tower's warps: the warps share its 16 x 8 output tiles in jobs of TM x TN
// tiles, summing k-tile kt into accumulator kt % KS (KS independent chains,
// added in order at the end), then add the bias and apply the activation
// on the accumulator fragment and store it for the next layer. Activations are [row][unit] in the
// paired order of mma_tf32.cuh (stride frag_ld), so a thread reads its A
// fragment as two float2 without bank conflicts; units past a layer's
// width are zero, as are the weights past it, so padding adds zeros. A
// layer that feeds another stores its output split, the TF32 hi parts in
// its array and the lo parts in a twin right after it (32 rows of the same
// stride), so the warps that read a fragment do not each split it again;
// the towers' input x (the state and the time, which cp.async writes) is
// split as it is read. A tower's last layer stores float32 for the update.
//
// Plan fields (Layer) in this layout: w, b the offsets in shared memory of
// the split weight tiles and the bias (padded to 8); pre, post the offsets
// of the layer's input and output arrays, pad and ld their strides.

struct MmaLayout {
  size_t plan;
  size_t x;                   // [row][k], paired: the towers' input
  size_t buf[MAX_TOWERS][2];  // each tower's even and odd layers' outputs
                              // (with lo twins where a layer feeds another)
  size_t nz[2];               // [j][r] (stride 36): a step's noise
  size_t dt;                  // the two slots' dt
  size_t total;
  int maxl;
};

constexpr int MMA_ROWS = 32;

__host__ __device__ inline MmaLayout make_mma_layout(const int* table,
                                                     Dims d, Layer* plan) {
  MmaLayout s = {};
  size_t at = 0;
  s.plan = take(at, size_t(d.nf + d.ng + d.nh) * PLAN_INTS);
  int wide[MAX_TOWERS][2] = {{0, 0}, {0, 0}, {0, 0}};
  int parts[MAX_TOWERS][2] = {{1, 1}, {1, 1}, {1, 1}};  // 2: with lo twin
  for (int t = 0; t < d.towers(); ++t) {
    int pack = 0;
    for (int i = 0; i < d.nl(t); ++i) {
      const int* row = table + TABLE_COLS * (d.base(t) + i);
      Layer L = {};
      L.in = row[0];
      L.out = row[1];
      L.act = row[2];
      L.g = pack;
      pack += L.in * L.out + L.out;
      L.w = static_cast<int>(take(at, tsde_mma::frag_floats(L.in, L.out)));
      L.b = static_cast<int>(take(at, tsde_mma::pad8(L.out)));
      wide[t][i & 1] = imax(wide[t][i & 1], L.out);
      if (i + 1 < d.nl(t)) parts[t][i & 1] = 2;
      if (plan) plan[d.base(t) + i] = L;
    }
  }
  const int xld = tsde_mma::frag_ld(tsde_mma::pad8(d.in0()));
  int ld[MAX_TOWERS][2] = {{0, 0}, {0, 0}, {0, 0}};
  s.x = take(at, size_t(MMA_ROWS) * xld);
  for (int t = 0; t < d.towers(); ++t) {
    for (int p = 0; p < 2; ++p) {
      ld[t][p] = tsde_mma::frag_ld(tsde_mma::pad8(wide[t][p]));
      s.buf[t][p] = take(at, size_t(MMA_ROWS) * ld[t][p] * parts[t][p]);
    }
  }
  s.nz[0] = take(at, size_t(d.m) * tile_ld(MMA_ROWS));
  s.nz[1] = take(at, size_t(d.m) * tile_ld(MMA_ROWS));
  s.dt = take(at, 2);
  s.total = at;
  s.maxl = imax(imax(d.nf, d.ng), d.nh);
  for (int t = 0; plan && t < d.towers(); ++t) {
    for (int i = 0; i < d.nl(t); ++i) {
      Layer& L = plan[d.base(t) + i];
      L.pre = static_cast<int>(i == 0 ? s.x : s.buf[t][(i - 1) & 1]);
      L.pad = i == 0 ? xld : ld[t][(i - 1) & 1];
      L.post = static_cast<int>(s.buf[t][i & 1]);
      L.ld = ld[t][i & 1];
    }
  }
  return s;
}

// act_fwd of every value of v, the branch on `act` taken once.
template <int N>
__device__ __forceinline__ void act_fwd_all(float (&v)[N], int act) {
  switch (act) {
    case SOFTPLUS:
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = softplus(v[i]);
      break;
    case TANH:
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = tanhf(v[i]);
      break;
    case SIGMOID:
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = sigmoid(v[i]);
      break;
    case LIPSWISH:
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = 0.909f * v[i] * sigmoid(v[i]);
      break;
    default:
      break;
  }
}

// Jobs of TM x TN output tiles of layer L (of the two m-tiles) for warp wi
// of the tower's NW warps. IN_SPLIT: the input is stored split (a hidden
// layer's output), else float32 (x); `out_split`: store the output split
// for the next layer.
template <int TM, int TN, int KS, bool IN_SPLIT>
__device__ inline void mma_jobs(const Layer L, float* sm, int wi, int NW,
                                int lane, bool out_split) {
  using namespace tsde_mma;
  const int KT = pad8(L.in) / 8, NTn = pad8(L.out) / 8;
  const int mg = MMA_ROWS / 16 / TM, jobs = mg * ((NTn + TN - 1) / TN);
  const float* in = sm + L.pre;
  const float* in_lo = in + MMA_ROWS * L.pad;
  float* out = sm + L.post;
  float* out_lo = out + MMA_ROWS * L.ld;
  const float* tiles = sm + L.w;
  const float* bias = sm + L.b;
  const int g = lane >> 2, q = lane & 3;
  for (int job = wi; job < jobs; job += NW) {
    const int m0 = (job % mg) * TM, n0 = (job / mg) * TN;
    float acc[KS][TM][TN][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int tm = 0; tm < TM; ++tm)
#pragma unroll
        for (int tn = 0; tn < TN; ++tn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ks][tm][tn][e] = 0.f;
    for (int kt0 = 0; kt0 < KT; kt0 += KS) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int kt = kt0 + ks;
        if (kt < KT) {
          AFrag a[TM];
#pragma unroll
          for (int tm = 0; tm < TM; ++tm)
            a[tm] = IN_SPLIT
                        ? load_a_split(in, in_lo, L.pad, (m0 + tm) * 16, kt,
                                       lane)
                        : load_a_paired(in, L.pad, (m0 + tm) * 16, kt, lane);
#pragma unroll
          for (int tn = 0; tn < TN; ++tn) {
            if (n0 + tn < NTn) {
              const BFrag b = load_b(tiles, kt * NTn + n0 + tn, lane);
#pragma unroll
              for (int tm = 0; tm < TM; ++tm) mma3(acc[ks][tm][tn], a[tm], b);
            }
          }
        }
      }
    }
    // The chains' sums and the bias (zero past the layer's width), then
    // the activation on the whole fragment at once: one branch on it, and
    // the values' instruction chains interleave.
    float v[TM * TN * 4];
#pragma unroll
    for (int tm = 0; tm < TM; ++tm) {
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) {
        const int nt = n0 + tn < NTn ? n0 + tn : NTn - 1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float u = acc[0][tm][tn][e];
#pragma unroll
          for (int ks = 1; ks < KS; ++ks) u += acc[ks][tm][tn][e];
          v[(tm * TN + tn) * 4 + e] = u + bias[nt * 8 + 2 * q + (e & 1)];
        }
      }
    }
    act_fwd_all(v, L.act);
#pragma unroll
    for (int tm = 0; tm < TM; ++tm) {
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) {
        const int nt = n0 + tn;
        if (nt >= NTn) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = (m0 + tm) * 16 + g + (e >> 1) * 8;
          const int col = nt * 8 + 2 * q + (e & 1);
          const int at = r * L.ld + k_pos(col);
          const float y = col < L.out ? v[(tm * TN + tn) * 4 + e] : 0.f;
          if (out_split) {
            uint32_t hi, lo;
            split(y, hi, lo);
            out[at] = __uint_as_float(hi);
            out_lo[at] = __uint_as_float(lo);
          } else {
            out[at] = y;
          }
        }
      }
    }
  }
}

// Layer i of a tower of nl layers on its NW warps (this one wi): the
// largest jobs that still give every warp one, else one tile a job in four
// chains.
template <bool IN_SPLIT>
__device__ inline void mma_layer_in(const Layer& L, int wi, int NW,
                                    int lane, float* sm, bool out_split) {
  const int NTn = tsde_mma::pad8(L.out) / 8;
  if ((NTn + 1) / 2 >= NW)
    mma_jobs<2, 2, 1, IN_SPLIT>(L, sm, wi, NW, lane, out_split);
  else if (NTn >= NW)
    mma_jobs<2, 1, 2, IN_SPLIT>(L, sm, wi, NW, lane, out_split);
  else
    mma_jobs<1, 1, 4, IN_SPLIT>(L, sm, wi, NW, lane, out_split);
}

__device__ inline void mma_layer(const Layer& L, int i, int nl, float* sm,
                                 int wi, int NW, int lane) {
  if (i == 0)
    mma_layer_in<false>(L, wi, NW, lane, sm, nl > 1);
  else
    mma_layer_in<true>(L, wi, NW, lane, sm, i + 1 < nl);
}

// Builds the plan (thread 0), zeroes the activations, then stages every
// tower split into TF32 halves as B fragments, with the whole block.
// Returns the layout; the caller syncs before using the weights.
template <int NT>
__device__ inline MmaLayout mma_setup(const int* table, Dims d, float* sm,
                                      const float* const* pack) {
  const MmaLayout s = make_mma_layout(table, d, nullptr);
  Layer* plan = reinterpret_cast<Layer*>(sm + s.plan);
  if (threadIdx.x == 0) make_mma_layout(table, d, plan);
  for (size_t e = s.x + threadIdx.x; e < s.nz[0]; e += NT) sm[e] = 0.f;
  __syncthreads();
  for (int t = 0; t < d.towers(); ++t) {
    const float* src = tower_pick(pack, t);
    for (int i = 0; i < d.nl(t); ++i) {
      const Layer L = plan[d.base(t) + i];
      const float* W = src + L.g;
      tsde_mma::stage_b(sm + L.w, L.in, L.out,
                        [&](int k, int n) { return W[k * L.out + n]; },
                        threadIdx.x, NT);
      for (int e = threadIdx.x; e < tsde_mma::pad8(L.out); e += NT)
        sm[L.b + e] = e < L.out ? W[L.in * L.out + e] : 0.f;
    }
  }
  return s;
}

// Whether a 3xTF32 design is one kernel 9 takes: MMA_ROWS rows, whole
// warps a tower.
__host__ __device__ inline bool mma_design_ok(Dims d, int R, int threads) {
  return R == MMA_ROWS && threads % (32 * d.towers()) == 0;
}

}  // namespace tsde_tower
