// Tower math and shared-memory layout common to the whole-solve kernels of
// TowerSpec SDEs (tower_euler_fwd.cu, tower_euler_bwd.cu, tower_rh_fwd.cu,
// tower_rh_bwd.cu, tower_euler_logqp_fwd.cu, tower_euler_logqp_bwd.cu), so
// that the reverse sweeps recompute exactly the forward kernels' activations.
//
// Kernels 11 and 13 (tower_rh_fwd.cu, tower_euler_logqp_fwd.cu) take the
// layer table, the plan's Layer and the activations from here and lay out
// their row tiles by tower_fwd_tile.cuh; what follows is the other four's.
//
// Block layout. A block holds TB batch rows and TW = 128 threads for each of
// its towers: NT = 256 for drift and diffusion (threads 0-127 the drift,
// 128-255 the diffusion), NT3 = 384 when a prior drift joins them (threads
// 256-383). The towers run side by side, one layer depth per barrier (four
// warps per tower, so the activation switch and the layer loops are uniform
// in every warp). Inside a tower,
// thread j computes output unit j of a layer for all TB rows (every width is
// at most 128): it reads a weight once and the layer's input rows as two
// float4 broadcasts, so one weight read feeds TB multiply-adds. Activations
// are kept [unit][row] in shared memory.
//
// The layer table is (in, out, activation code) per layer: the drift's
// layers, the diffusion's, then the prior's. From it every block builds a
// plan of the layers in shared memory: where the weights are (in shared
// memory, with an odd row stride, for a tower staged there; else in the
// tower's flat pack in device memory, read through L1 and L2), where the
// layer's gradient goes in the flat packs, and for the backward kernels
// where the layer's pre-activation and output are kept. The host computes
// the same layout with the same function (make_layout) to size the launch,
// and tsde_tower_smem_bytes reports it.
//
// The reverse sweeps (EULER_BWD, RH_BWD, EULER_LOGQP_BWD) carry only the
// step-to-step chain: at each step they write, for their rows, every
// layer's pre-activation cotangent and the input of every layer after the
// first to a scratch workspace in device memory (scratch_columns,
// towers_backward_chain), and a second phase (tower_bwd_contract.cu)
// contracts those over all steps and rows into the weight gradients; a
// long solve, a window of steps at a time (chain_workspace).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace tsde_tower {

constexpr int TB = 8;              // batch rows per block
constexpr int TW = 128;            // threads per tower; the widest layer
constexpr int NT = 2 * TW;         // threads of a drift-and-diffusion block
constexpr int NT3 = 3 * TW;        // threads of a block with a prior drift
constexpr int MAX_TOWERS = 3;
constexpr int TABLE_COLS = 3;      // in, out, activation code

enum Act : int { SOFTPLUS = 0, TANH = 1, SIGMOID = 2, LIPSWISH = 3,
                 LINEAR = 4 };
enum Kind : int { EULER_FWD = 0, EULER_BWD = 1, RH_FWD = 2, RH_BWD = 3,
                  EULER_LOGQP_FWD = 4, EULER_LOGQP_BWD = 5 };

// The solve's widths: drift, diffusion and prior-drift layer counts (nh = 0:
// no prior), state S, noise channels m (S for diagonal noise), diagonal
// noise, and whether the towers read a time column (wt = 1) before the
// state. Tower t is 0 the drift, 1 the diffusion, 2 the prior.
struct Dims {
  int nf, ng, nh, S, m, diag, wt;
  __host__ __device__ int towers() const { return nh > 0 ? 3 : 2; }
  __host__ __device__ int nl(int t) const {
    return t == 0 ? nf : t == 1 ? ng : nh;
  }
  __host__ __device__ int base(int t) const {
    return t == 0 ? 0 : t == 1 ? nf : nf + ng;
  }
  __host__ __device__ int gwidth() const { return diag ? S : S * m; }
  __host__ __device__ int in0() const { return S + wt; }
};

struct Layer {
  int in, out, act;
  int w, b, ld;      // W (row stride ld) and b, from the tower's weight base
  int g;             // W's offset in the tower's pack; b follows at g+in*out
  int pre, post;     // backward kernels: [unit][row] pre-activation, output
  int pad;
};
constexpr int PLAN_INTS = sizeof(Layer) / sizeof(int);

// Reserves n floats at `at`, keeping every array on a 16-byte boundary so
// activations can be read as float4.
__host__ __device__ inline size_t take(size_t& at, size_t n) {
  const size_t start = at;
  at += (n + 3) & ~size_t(3);
  return start;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Offsets (in floats) of each array in dynamic shared memory.
struct Layout {
  size_t plan;
  size_t wstage[MAX_TOWERS];  // staged weights of each tower
  size_t x;                   // [k][r]: the towers' input [t? | y]
  size_t buf[MAX_TOWERS][2];  // forward kernels: ping-pong activations
  size_t dout[MAX_TOWERS];    // backward kernels: output cotangents
  size_t carry[5];            // the kernel's own [unit][row] arrays
  size_t cols;                // backward kernels: each layer's scratch
                              // columns (scratch_columns), as ints
  size_t total;
  size_t P;                   // floats of all packs, [fw | gw | hw]
  int toff[MAX_TOWERS];       // each pack's offset in [fw | gw | hw]
  int maxl;                   // the deepest tower's layer count
};

// The layout of a kernel of `kind` for this layer table; fills `plan` when
// it is not null. `stage` bit t set: tower t is copied to shared memory.
__host__ __device__ inline Layout make_layout(const int* table, Dims d,
                                              int kind, int stage,
                                              Layer* plan) {
  Layout s = {};
  size_t at = 0;
  s.plan = take(at, size_t(d.nf + d.ng + d.nh) * PLAN_INTS);
  int maxw[MAX_TOWERS] = {1, 1, 1};
  int pack[MAX_TOWERS] = {0, 0, 0};
  for (int t = 0; t < d.towers(); ++t) {
    const bool staged = (stage >> t) & 1;
    size_t sw = 0;
    for (int i = 0; i < d.nl(t); ++i) {
      const int* row = table + TABLE_COLS * (d.base(t) + i);
      Layer L = {};
      L.in = row[0];
      L.out = row[1];
      L.act = row[2];
      L.g = pack[t];
      if (staged) {
        L.ld = L.out | 1;
        L.w = static_cast<int>(take(sw, size_t(L.in) * L.ld));
        L.b = static_cast<int>(take(sw, L.out));
      } else {
        L.ld = L.out;
        L.w = pack[t];
        L.b = pack[t] + L.in * L.out;
      }
      pack[t] += L.in * L.out + L.out;
      maxw[t] = imax(maxw[t], L.out);
      if (plan) plan[d.base(t) + i] = L;
    }
    s.wstage[t] = staged ? take(at, sw) : 0;
  }
  s.P = 0;
  for (int t = 0; t < d.towers(); ++t) {
    s.toff[t] = static_cast<int>(s.P);
    s.P += size_t(pack[t]);
  }
  s.maxl = imax(imax(d.nf, d.ng), d.nh);
  s.x = take(at, size_t(d.in0()) * TB);
  const bool bwd = kind == EULER_BWD || kind == RH_BWD ||
                   kind == EULER_LOGQP_BWD;
  for (int t = 0; t < d.towers(); ++t) {
    if (!bwd) {
      s.buf[t][0] = take(at, size_t(maxw[t]) * TB);
      s.buf[t][1] = take(at, size_t(maxw[t]) * TB);
      continue;
    }
    for (int i = 0; i < d.nl(t); ++i) {
      const int out = table[TABLE_COLS * (d.base(t) + i) + 1];
      const int pre = static_cast<int>(take(at, size_t(out) * TB));
      const int post = static_cast<int>(take(at, size_t(out) * TB));
      if (plan) {
        plan[d.base(t) + i].pre = pre;
        plan[d.base(t) + i].post = post;
      }
    }
    s.dout[t] = take(at, size_t(imax(d.in0(), maxw[t])) * TB);
  }
  const size_t sS = size_t(d.S) * TB, sG = size_t(d.gwidth()) * TB;
  if (kind == EULER_BWD || kind == EULER_LOGQP_BWD) {
    s.carry[0] = take(at, sS);                         // dy
  } else if (kind == RH_BWD) {
    s.carry[0] = take(at, sS);                         // ay
    s.carry[1] = take(at, sS);                         // az
    s.carry[2] = take(at, sS);                         // af
    s.carry[3] = take(at, sG);                         // ag
    s.carry[4] = take(at, sS);                         // Az
  }
  if (bwd) s.cols = take(at, 2 * size_t(d.nf + d.ng + d.nh));
  s.total = at;
  return s;
}

// jax.nn.softplus: logaddexp(x, 0), which never overflows.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float act_fwd(float x, int act) {
  switch (act) {
    case SOFTPLUS: return softplus(x);
    case TANH: return tanhf(x);
    case SIGMOID: return sigmoid(x);
    case LIPSWISH: return 0.909f * x * sigmoid(x);
    default: return x;
  }
}

// d pre from d out, by the JAX package's formulas (softplus' = 1 - e^-out).
__device__ __forceinline__ float act_bwd(float d, float pre, float out,
                                         int act) {
  switch (act) {
    case SOFTPLUS: return d * (1.f - expf(-out));
    case TANH: return d * (1.f - out * out);
    case SIGMOID: return d * out * (1.f - out);
    case LIPSWISH: {
      const float sig = sigmoid(pre);
      return d * (0.909f * (sig + pre * sig * (1.f - sig)));
    }
    default: return d;
  }
}

__device__ __forceinline__ void load_rows(float (&v)[TB], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Builds the plan, stages the towers of `stage` into shared memory and
// returns the layout; w[t] is tower t's weight base (shared or device
// memory). Ends with a barrier.
__device__ inline Layout setup(const int* table, Dims d, int kind, int stage,
                               float* sm, const float* const* pack,
                               const float** w) {
  const Layout s = make_layout(table, d, kind, stage, nullptr);
  Layer* plan = reinterpret_cast<Layer*>(sm + s.plan);
  if (threadIdx.x == 0) make_layout(table, d, kind, stage, plan);
  __syncthreads();
  for (int t = 0; t < d.towers(); ++t) {
    if (!((stage >> t) & 1)) {
      w[t] = pack[t];
      continue;
    }
    float* dst = sm + s.wstage[t];
    for (int i = 0; i < d.nl(t); ++i) {
      const Layer L = plan[d.base(t) + i];
      const float* src = pack[t] + L.g;
      for (int e = threadIdx.x; e < L.in * L.out; e += blockDim.x)
        dst[L.w + (e / L.out) * L.ld + e % L.out] = src[e];
      for (int e = threadIdx.x; e < L.out; e += blockDim.x)
        dst[L.b + e] = src[L.in * L.out + e];
    }
    w[t] = dst;
  }
  __syncthreads();
  return s;
}

// Thread j's unit of one layer for the tile: out[j][r] = act(pre[j][r]),
// pre = in[:, r] . W[:, j] + b[j]; pre is kept when `pre` is not null.
__device__ inline void layer_forward(const Layer& L,
                                     const float* __restrict__ w,
                                     const float* in, float* pre, float* out,
                                     int j) {
  if (j >= L.out) return;
  float acc[TB], v[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) acc[r] = 0.f;
  const float* wj = w + L.w + j;
#pragma unroll 4
  for (int k = 0; k < L.in; ++k) {
    const float wk = wj[size_t(k) * L.ld];
    load_rows(v, in + k * TB);
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = fmaf(v[r], wk, acc[r]);
  }
  const float b = w[L.b + j];
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    const float p = acc[r] + b;
    if (pre) pre[j * TB + r] = p;
    out[j * TB + r] = act_fwd(p, L.act);
  }
}

// Every tower's forward for the tile from x (thread group t runs tower t),
// one layer depth per barrier. With `cache` every layer keeps its
// pre-activation and output where the plan says (the backward kernels);
// otherwise each tower alternates between its two buffers. Ends with a
// barrier.
__device__ inline void towers_forward(const Layer* plan, Dims d,
                                      const Layout& s, const float* const* w,
                                      float* sm, bool cache) {
  const int t = threadIdx.x / TW, j = threadIdx.x % TW;
  const Layer* tp = plan + d.base(t);
  for (int i = 0; i < s.maxl; ++i) {
    if (i < d.nl(t)) {
      const Layer L = tp[i];
      if (cache) {
        const float* in = i == 0 ? sm + s.x : sm + tp[i - 1].post;
        layer_forward(L, w[t], in, sm + L.pre, sm + L.post, j);
      } else {
        const float* in = i == 0 ? sm + s.x : sm + s.buf[t][(i - 1) & 1];
        layer_forward(L, w[t], in, nullptr, sm + s.buf[t][i & 1], j);
      }
    }
    __syncthreads();
  }
}

// Tower t's output [unit][row] after towers_forward.
__device__ inline const float* tower_out(const Layer* plan, Dims d,
                                         const Layout& s, const float* sm,
                                         int t, bool cache) {
  const int top = d.nl(t) - 1;
  return cache ? sm + plan[d.base(t) + top].post : sm + s.buf[t][top & 1];
}

// Thread k's input unit of a layer going back: dout[k][r] = dpre[:, r] .
// W[k, :].
__device__ inline void layer_input_grad(const Layer& L,
                                        const float* __restrict__ w,
                                        const float* dpre, float* dout,
                                        int k) {
  if (k >= L.in) return;
  float acc[TB], v[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) acc[r] = 0.f;
  const float* wk = w + L.w + size_t(k) * L.ld;
#pragma unroll 4
  for (int j = 0; j < L.out; ++j) {
    const float wv = wk[j];
    load_rows(v, dpre + j * TB);
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = fmaf(v[r], wv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < TB; ++r) dout[k * TB + r] = acc[r];
}

// Whether a chain sweep writes layer i's input (the output of layer i - 1)
// to the scratch: for every layer after its tower's first, whose input
// [t | state] the contraction gathers from the solve instead.
__host__ __device__ inline bool stores_input(int i) { return i > 0; }

// Row stride of a scratch tensor of width w: w rounded up to a multiple of
// four, so that every row starts on a 16-byte boundary.
__host__ __device__ inline int scratch_ld(int w) { return (w + 3) & ~3; }

// The scratch the chain sweeps write. For every layer l (the table's order)
// its pre-activation cotangent D_l and, unless l is its tower's first layer
// (stores_input), its input X_l (the output of the layer before), each an
// (M, w) row-major tensor of M = N x B rows (row n x B + b: the window's
// step n, batch row b; N the window's steps) with row stride scratch_ld(w), at M x col floats from the
// workspace's start: first every X, then every D, each in table order.
// Fills xcol[l] (-1 where X_l is not stored) and dcol[l] when they are not
// null; returns the columns of a row, the sum of the strides.
__host__ __device__ inline size_t scratch_columns(const int* table, Dims d,
                                                  int* xcol, int* dcol) {
  size_t at = 0;
  for (int t = 0; t < d.towers(); ++t) {
    for (int i = 0; i < d.nl(t); ++i) {
      const int l = d.base(t) + i;
      if (xcol) xcol[l] = stores_input(i) ? static_cast<int>(at) : -1;
      if (stores_input(i)) at += scratch_ld(table[TABLE_COLS * l]);
    }
  }
  for (int l = 0; l < d.nf + d.ng + d.nh; ++l) {
    if (dcol) dcol[l] = static_cast<int>(at);
    at += scratch_ld(table[TABLE_COLS * l + 1]);
  }
  return at;
}

// Rows of a contraction chunk: the weight gradients are summed in float32
// over a chunk of M's rows, each chunk into a partial row of its own, and
// the partial rows in float64 in chunk order.
constexpr int RC = 512;

__host__ __device__ inline size_t contract_chunks(size_t M) {
  return (M + RC - 1) / RC;
}

// A chain sweep's workspace, for windows of W steps: the scratch of W x B
// rows (from float 0), the contraction's partial rows of P floats (all
// packs) from `parts`, kernel 12's carried cotangents between windows
// from `carry` (ay, az, af, ag: 3S + G floats a row of the batch rounded
// up to TB rows; kernels 10 and 14 pass their dy in dy0), the float64 sums
// of the windows' weight gradients (P doubles) from `sums`; `total`
// floats.
struct ChainWorkspace {
  size_t parts, carry, sums, total;
};

__host__ __device__ inline ChainWorkspace chain_workspace(const int* table,
                                                          Dims d, size_t P,
                                                          int B, int W) {
  const size_t M = size_t(W) * B;
  const size_t rows = size_t(B + TB - 1) / TB * TB;
  ChainWorkspace w;
  w.parts = M * scratch_columns(table, d, nullptr, nullptr);
  w.carry = w.parts + contract_chunks(M) * P;
  w.sums = (w.carry + rows * (3 * d.S + d.gwidth()) + 1) & ~size_t(1);
  w.total = w.sums + 2 * P;
  return w;
}

// Where a chain sweep's block writes its window's step n: its first row
// m0 = n x B + row0 of the scratch, `rows` of its TB rows inside the batch; the layers'
// columns (xcol, dcol: Layout::cols in shared memory).
struct ScratchRows {
  float* ws;
  size_t M, m0;
  int rows;
  const int* xcol;
  const int* dcol;
};

// Thread j's unit of a [unit][row] array to the scratch tensor at column
// col (width w): element (m0 + r, j) for the tile's rows r inside the
// batch.
__device__ __forceinline__ void store_unit(const ScratchRows& sr, int col,
                                           int w, const float* src, int j) {
  const size_t ld = scratch_ld(w);
  float* dst = sr.ws + sr.M * col + sr.m0 * ld + j;
  float v[TB];
  load_rows(v, src + j * TB);
#pragma unroll
  for (int r = 0; r < TB; ++r)
    if (r < sr.rows) dst[r * ld] = v[r];
}

// Backpropagates each tower's output cotangent (in its dout buffer) through
// the cache of towers_forward, the deepest layers first, each layer's dpre
// (kept over pre) and input to the scratch, not its weight gradients. Leaves the cotangent of x ([k][r],
// in0 rows) in each tower's dout buffer. Two barriers a layer depth; ends
// with a barrier.
__device__ inline void towers_backward_chain(const Layer* plan, Dims d,
                                             const Layout& s,
                                             const float* const* w, float* sm,
                                             const ScratchRows& sr) {
  const int t = threadIdx.x / TW, j = threadIdx.x % TW;
  const Layer* tp = plan + d.base(t);
  float* dout = sm + s.dout[t];
  for (int q = 0; q < s.maxl; ++q) {
    const int i = d.nl(t) - 1 - q, l = d.base(t) + i;
    if (i >= 0) {
      const Layer L = tp[i];
      if (j < L.out) {
        float pv[TB], ov[TB], dv[TB];
        float* pre = sm + L.pre;
        load_rows(pv, pre + j * TB);
        load_rows(ov, sm + L.post + j * TB);
        load_rows(dv, dout + j * TB);
#pragma unroll
        for (int r = 0; r < TB; ++r)
          pre[j * TB + r] = act_bwd(dv[r], pv[r], ov[r], L.act);
        store_unit(sr, sr.dcol[l], L.out, pre, j);
      }
      if (stores_input(i) && j < L.in)
        store_unit(sr, sr.xcol[l], L.in, sm + tp[i - 1].post, j);
    }
    __syncthreads();
    if (i >= 0) layer_input_grad(tp[i], w[t], sm + tp[i].pre, dout, j);
    __syncthreads();
  }
}

// Fills a chain sweep's Layout::cols with the scratch columns of a window
// of N steps; the caller syncs before reading them.
__device__ inline ScratchRows scratch_rows(const int* table, Dims d,
                                           const Layout& s, float* sm,
                                           float* ws, int B, int N) {
  int* cols = reinterpret_cast<int*>(sm + s.cols);
  const int nl = d.nf + d.ng + d.nh;
  if (threadIdx.x == 0) scratch_columns(table, d, cols, cols + nl);
  ScratchRows sr;
  sr.ws = ws;
  sr.M = size_t(N) * B;
  sr.m0 = 0;
  sr.rows = 0;
  sr.xcol = cols;
  sr.dcol = cols + nl;
  return sr;
}

// The contraction of a chain sweep's scratch of one window into the weight
// gradients, and the reduction of its partial rows, on `stream`
// (tower_bwd_contract.cu). The scratch holds the window's `steps` x B rows
// from ws; w is the workspace's layout. The layers' first input [t | state]
// is gathered, not stored: the window's row m = n x B + b reads times[n]
// and state row m of st0 when m < B, else row m - B of st1. The first
// window's sums start at zero (`first`); the last (`last`) writes them to
// [dfw | dgw | dhw] (dw, P floats), the others to w.sums.
int launch_contraction(const int* table_host, const int* table_dev, Dims d,
                       const float* times, const float* st0,
                       const float* st1, float* ws, const ChainWorkspace& w,
                       float* dw, int B, int steps, bool first, bool last,
                       cudaStream_t stream);

inline int blocks_for(int B) { return (B + TB - 1) / TB; }

// Sets the kernel's dynamic shared memory for this layout; returns the CUDA
// error code.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, const Layout& s) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(s.total * sizeof(float)));
}

}  // namespace tsde_tower
