// The contraction phase of the chain sweeps of TowerSpec SDEs (kernel 10,
// tower_euler_bwd.cu, kernel 12, tower_rh_bwd.cu, and kernel 14,
// tower_euler_logqp_bwd.cu), for Hopper (sm_90a), bound to PyTorch through
// their plain C interfaces (ctypes).
//
// Replaces the weight-gradient half of the Pallas TPU kernels
// torchsde_tpu/ops/fused_solve.py:_euler_bwd_kernel, _rh_bwd_kernel and
// _euler_logqp_bwd_kernel, which add every layer's weight gradients at every
// step. Here they are
// products over all M = N x B rows of the scratch the sweep wrote
// (tower_solve_common.cuh: scratch_columns): for every layer of every tower
//   dW = X^T D,  db = the column sums of D,
// X the layer's input (for a tower's first layer the row [t | state],
// gathered from the solve's times and states, not stored), D its
// pre-activation cotangent. The table of products is built from the layer
// table on the host and in every block alike (find_job), so the contraction
// takes any depth, width (1-128), activation, time column and general
// noise.
//
// What bounds it. 2 x M x sum(in x out) operations against the scratch's
// M x sum(widths) floats read once: at R1 (batch 1024, d 128, hidden 128,
// 128 steps) 17.2 GFLOP against 0.40 GB, bound by the operations; at L1
// (batch 4096, d 32, hidden 128, with a prior) 25.8 GFLOP against 1.81 GB,
// near the balance of the two.
//
// Windows. A solve whose scratch would outgrow the workspace's budget
// (fused_solve.WORKSPACE_BYTES) is swept in windows of steps, last first;
// each window's contraction sums its rows into the float64 sums of the
// windows before it (tower_bwd_reduce), so the workspace holds one
// window's scratch.
//
// Design. Each product is cut into output tiles of TI x TJ (TJ = 128
// columns of B) and its rows into chunks of RC; a block takes one tile over
// one chunk, 16-row slabs of both operands double-buffered in shared memory
// by cp.async (16-byte copies of the scratch, whose rows start on 16-byte
// boundaries; 4-byte copies of the gathered rows), each thread a 4 x 8
// block of the tile in float32 FMAs. Products whose two sides are both
// wider than 32 take 64 x 128 tiles of 256 threads (A = X, B = D); a
// product with a side of 32 or less, bound more by the bytes it reads,
// takes 32 x 128 tiles of 128 threads with that side as A (the output then
// written transposed when A is D). The tile of B's first columns (A's, when
// A is D) also sums the bias, a column a thread, in float64. Each chunk
// writes its own partial row of all packs' floats; tower_bwd_reduce sums
// the partial rows in float64 in chunk order. No atomics: the gradients are
// bitwise the same from call to call.

#include <cuda_runtime.h>
#include <stddef.h>

#include "tower_solve_common.cuh"

namespace tsde_tower {
namespace {

constexpr int KS = 16;        // rows of a slab
constexpr int TJ = 128;       // columns of B in a tile
constexpr int NARROW = 32;    // a product with a side this narrow or less
constexpr int TI_WIDE = 64, TI_NARROW = 32;   // rows of A in a tile

// An operand of a product: the scratch tensor at column col (row stride
// ld), or (gather) the gathered first input of a tower.
struct Operand {
  int col, ld;
  bool gather;
};

// out[i * si + j * sj] = sum over rows m of A[m][i] B[m][j] (i < I, j < J)
// in a partial row; the bias (the column sums of the layer's D: A when
// bias_a, else B) at `bias`.
struct Job {
  Operand a, b;
  int I, J;
  int out, si, sj, bias, bias_a;
  int tiles_j, tile0;
};

// Numbers the tiles of the products of one kind (narrow or wide) in layer
// order; fills *jb with the product that holds tile `tile` (when jb is not
// null) and returns the kind's tile count.
__host__ __device__ inline int find_job(const int* table, Dims d, int narrow,
                                        int tile, Job* jb) {
  // The scratch's X columns come first (scratch_columns), D's after them.
  int dat = 0;
  for (int t = 0; t < d.towers(); ++t) {
    for (int i = 1; i < d.nl(t); ++i)
      if (stores_input(i))
        dat += scratch_ld(table[TABLE_COLS * (d.base(t) + i)]);
  }
  int xat = 0, pack = 0, tiles = 0;
  for (int t = 0; t < d.towers(); ++t) {
    for (int i = 0; i < d.nl(t); ++i) {
      const int* row = table + TABLE_COLS * (d.base(t) + i);
      const int in = row[0], out = row[1];
      const Operand x = {i == 0 ? 0 : xat, scratch_ld(in), i == 0};
      const Operand dp = {dat, scratch_ld(out), false};
      if (stores_input(i)) xat += scratch_ld(in);
      dat += scratch_ld(out);
      const int kind = (in < out ? in : out) <= NARROW;
      if (kind == narrow) {
        Job j;
        const bool a_is_x = !narrow || in <= out;
        j.a = a_is_x ? x : dp;
        j.b = a_is_x ? dp : x;
        j.I = a_is_x ? in : out;
        j.J = a_is_x ? out : in;
        j.out = pack;
        j.si = a_is_x ? out : 1;
        j.sj = a_is_x ? 1 : out;
        j.bias = pack + in * out;
        j.bias_a = !a_is_x;
        j.tiles_j = (j.J + TJ - 1) / TJ;
        j.tile0 = tiles;
        const int TI = narrow ? TI_NARROW : TI_WIDE;
        const int n = ((j.I + TI - 1) / TI) * j.tiles_j;
        if (jb && tile >= tiles && tile < tiles + n) *jb = j;
        tiles += n;
      }
      pack += in * out + out;
    }
  }
  return tiles;
}

struct ContractArgs {
  const int* table;
  Dims d;
  const float* times;   // (steps,)
  const float* st0;     // the states of rows m < B
  const float* st1;     // the states of rows m >= B, from row B
  float* ws;
  size_t M, parts, P;   // the window's rows; the partial rows' offset, size
  int B;
};

// Asynchronous copies into shared memory (sm_80 and later); src must be a
// valid address even when nothing is read from it.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row mm's column k of a tower's first input [t | state].
__device__ __forceinline__ const float* first_input(const ContractArgs& a,
                                                    size_t mm, int k) {
  const int S = a.d.S, wt = a.d.wt;
  return k < wt ? a.times + mm / a.B
                : (mm < size_t(a.B) ? a.st0 + mm * S
                                    : a.st1 + (mm - a.B) * S) + (k - wt);
}

// Rows [m, m + KS) of an operand's columns [c0, c0 + TW) into dst
// ([row][TW]); zero past the chunk's end m1 and the operand's width W.
template <int TW, int NTH>
__device__ __forceinline__ void load_operand(const ContractArgs& a,
                                             const Operand& op, int W,
                                             size_t m, size_t m1, int c0,
                                             float* dst) {
  if (op.gather) {
    for (int e = threadIdx.x; e < KS * TW; e += NTH) {
      const int kk = e / TW, c = e % TW, gc = c0 + c;
      const size_t mm = m + kk;
      const bool valid = mm < m1 && gc < W;
      cp_async4(dst + kk * TW + c, valid ? first_input(a, mm, gc) : a.ws,
                valid);
    }
    return;
  }
  const float* base = a.ws + a.M * op.col;
  for (int e = threadIdx.x; e < KS * TW / 4; e += NTH) {
    const int kk = e / (TW / 4), c = (e % (TW / 4)) * 4, gc = c0 + c;
    const size_t mm = m + kk;
    const int left = W - gc;
    const int n = mm < m1 && left > 0 ? (left < 4 ? left : 4) : 0;
    cp_async16(dst + kk * TW + c, n ? base + mm * op.ld + gc : a.ws, 4 * n);
  }
}

// One output tile of one product over one chunk of rows; grid (chunks,
// tiles of the kind). Registers are held to two blocks of the wide tiles
// an SM (128 a thread) and three of the narrow ones (168): on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py) the wide tiles took 0.67 ms at
// R1 so and 0.84 at 155 registers; the narrow ones 1.17 ms at L1 so, 1.25
// at four blocks an SM and 1.39 at two.
template <int TI>
__global__ void __launch_bounds__(TI * 4, TI == TI_WIDE ? 2 : 3)
    tower_bwd_contract(
    const ContractArgs a) {
  constexpr int NTH = TI * 4;
  __shared__ __align__(16) float As[2][KS * TI];
  __shared__ __align__(16) float Bs[2][KS * TJ];
  Job jb;
  find_job(a.table, a.d, TI == TI_NARROW, blockIdx.y, &jb);
  const int local = blockIdx.y - jb.tile0;
  const int i0 = (local / jb.tiles_j) * TI, j0 = (local % jb.tiles_j) * TJ;
  const size_t m0 = size_t(blockIdx.x) * RC;
  const size_t m1 = a.M < m0 + RC ? a.M : m0 + RC;
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  // The bias, a column a thread, by the tile of the first columns of the
  // side it sums (a warp-uniform branch).
  const bool bias = jb.bias_a ? j0 == 0 && tid < TI : i0 == 0 && tid < TJ;
  double bsum = 0.0;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int slabs = static_cast<int>((m1 - m0 + KS - 1) / KS);
  load_operand<TI, NTH>(a, jb.a, jb.I, m0, m1, i0, As[0]);
  load_operand<TJ, NTH>(a, jb.b, jb.J, m0, m1, j0, Bs[0]);
  cp_async_commit();
  for (int s = 0; s < slabs; ++s) {
    if (s + 1 < slabs) {
      const size_t m = m0 + size_t(s + 1) * KS;
      load_operand<TI, NTH>(a, jb.a, jb.I, m, m1, i0, As[(s + 1) & 1]);
      load_operand<TJ, NTH>(a, jb.b, jb.J, m, m1, j0, Bs[(s + 1) & 1]);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = As[s & 1];
    const float* bs = Bs[s & 1];
    if (bias) {
      const float* col = jb.bias_a ? as + tid : bs + tid;
      const int ld = jb.bias_a ? TI : TJ;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) bsum += col[kk * ld];
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(as + kk * TI + ti * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * TJ + tj * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * TJ + 64 + tj * 4);
      const float av_[4] = {av.x, av.y, av.z, av.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av_[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* out = a.ws + a.parts + size_t(blockIdx.x) * a.P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ti * 4 + i;
    if (gi >= jb.I) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gj = j0 + (j < 4 ? tj * 4 + j : 64 + tj * 4 + j - 4);
      if (gj < jb.J) out[jb.out + gi * jb.si + gj * jb.sj] = acc[i][j];
    }
  }
  if (bias) {
    const int c = (jb.bias_a ? i0 : j0) + tid;
    if (c < (jb.bias_a ? jb.I : jb.J))
      out[jb.bias + c] = static_cast<float>(bsum);
  }
}

// The float64 sum of the chunks' partial rows, in chunk order, added to
// the earlier windows' sums (none when `first`); into dw[e] when `last`,
// else into sums[e].
__global__ void tower_bwd_reduce(const float* parts, int chunks, size_t P,
                                 double* sums, bool first, bool last,
                                 float* dw) {
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= P) return;
  const float* p = parts + e;
  double acc = first ? 0.0 : sums[e];
  int c = 0;
  for (; c + 8 <= chunks; c += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = p[size_t(c + u) * P];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  for (; c < chunks; ++c) acc += p[size_t(c) * P];
  if (last)
    dw[e] = static_cast<float>(acc);
  else
    sums[e] = acc;
}

// Floats of all packs: each layer's weights and bias.
size_t packs_size(const int* table, Dims d) {
  size_t P = 0;
  for (int l = 0; l < d.nf + d.ng + d.nh; ++l)
    P += size_t(table[TABLE_COLS * l]) * table[TABLE_COLS * l + 1]
         + table[TABLE_COLS * l + 1];
  return P;
}

}  // namespace

int launch_contraction(const int* table_host, const int* table_dev, Dims d,
                       const float* times, const float* st0,
                       const float* st1, float* ws, const ChainWorkspace& w,
                       float* dw, int B, int steps, bool first, bool last,
                       cudaStream_t stream) {
  ContractArgs a;
  a.table = table_dev;
  a.d = d;
  a.times = times;
  a.st0 = st0;
  a.st1 = st1;
  a.ws = ws;
  a.B = B;
  a.M = size_t(steps) * B;
  a.parts = w.parts;
  a.P = packs_size(table_host, d);
  const unsigned chunks = static_cast<unsigned>(contract_chunks(a.M));
  const int wide = find_job(table_host, d, 0, -1, nullptr);
  const int narrow = find_job(table_host, d, 1, -1, nullptr);
  if (wide > 0) {
    tower_bwd_contract<TI_WIDE><<<dim3(chunks, wide), TI_WIDE * 4, 0,
                                  stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (narrow > 0) {
    tower_bwd_contract<TI_NARROW><<<dim3(chunks, narrow), TI_NARROW * 4, 0,
                                    stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int RT = 256;
  tower_bwd_reduce<<<static_cast<unsigned>((a.P + RT - 1) / RT), RT, 0,
                     stream>>>(ws + a.parts, static_cast<int>(chunks), a.P,
                               reinterpret_cast<double*>(ws + w.sums), first,
                               last, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tsde_tower

extern "C" {

// Floats of the workspace of kernel 10, 12 or 14 (the same form) for
// windows of W steps over B rows (tower_solve_common.cuh:
// chain_workspace).
size_t tsde_tower_bwd_workspace(const int* table, int nf, int ng, int nh,
                                int S, int m, int diag, int wt, int B,
                                int W) {
  using namespace tsde_tower;
  const Dims d = {nf, ng, nh, S, m, diag, wt};
  return chain_workspace(table, d, packs_size(table, d), B, W).total;
}

}  // extern "C"
