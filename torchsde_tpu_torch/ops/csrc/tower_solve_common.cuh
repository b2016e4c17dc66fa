// Tower math and shared-memory layout common to the whole-solve kernels of
// TowerSpec SDEs (tower_euler_fwd.cu, tower_euler_bwd.cu, tower_rh_fwd.cu,
// tower_rh_bwd.cu), so that the reverse sweeps recompute exactly the forward
// kernels' activations.
//
// Block layout. A block holds TB batch rows and NT = 256 threads: threads
// 0-127 run the drift tower and threads 128-255 the diffusion tower, side by
// side, one layer depth per barrier (four warps per tower, so the activation
// switch and the layer loops are uniform in every warp). Inside a tower,
// thread j computes output unit j of a layer for all TB rows (every width is
// at most 128): it reads a weight once and the layer's input rows as two
// float4 broadcasts, so one weight read feeds TB multiply-adds. Activations
// are kept [unit][row] in shared memory.
//
// The layer table is (in, out, activation code) per layer, the drift's
// layers first. From it every block builds a plan of the layers in shared
// memory: where the weights are (in shared memory, with an odd row stride,
// for a tower staged there; else in the tower's flat pack in device memory,
// read through L1 and L2), where the layer's gradient goes in the flat packs,
// and for the backward kernels where the layer's pre-activation and output
// are kept. The host computes the same layout with the same function
// (make_layout) to size the launch, and tsde_tower_smem_bytes reports it.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace tsde_tower {

constexpr int TB = 8;              // batch rows per block
constexpr int HALF = 128;          // threads per tower; the widest layer
constexpr int NT = 2 * HALF;       // threads per block
constexpr int TABLE_COLS = 3;      // in, out, activation code

enum Act : int { SOFTPLUS = 0, TANH = 1, SIGMOID = 2, LIPSWISH = 3,
                 LINEAR = 4 };
enum Kind : int { EULER_FWD = 0, EULER_BWD = 1, RH_FWD = 2, RH_BWD = 3 };

// The solve's widths: drift and diffusion layer counts, state S, noise
// channels m (S for diagonal noise), diagonal noise, and whether the towers
// read a time column (wt = 1) before the state.
struct Dims {
  int nf, ng, S, m, diag, wt;
  __host__ __device__ int nl(int t) const { return t == 0 ? nf : ng; }
  __host__ __device__ int base(int t) const { return t == 0 ? 0 : nf; }
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
  size_t wstage[2];    // staged weights of each tower
  size_t x;            // [k][r]: the towers' input [t? | y]
  size_t buf[2][2];    // forward kernels: each tower's ping-pong activations
  size_t dout[2];      // backward kernels: each tower's output cotangent
  size_t carry[5];     // the kernel's own [unit][row] arrays
  size_t total;
  size_t P;            // floats of both packs, [fw | gw]
  int toff1;           // the diffusion pack's offset in [fw | gw]
  int maxl;            // the deeper tower's layer count
};

// The layout of a kernel of `kind` for this layer table; fills `plan` when
// it is not null. `stage` bit t set: tower t is copied to shared memory.
__host__ __device__ inline Layout make_layout(const int* table, Dims d,
                                              int kind, int stage,
                                              Layer* plan) {
  Layout s = {};
  size_t at = 0;
  s.plan = take(at, size_t(d.nf + d.ng) * PLAN_INTS);
  int maxw[2] = {1, 1};
  int pack[2] = {0, 0};
  for (int t = 0; t < 2; ++t) {
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
  s.toff1 = pack[0];
  s.P = size_t(pack[0]) + pack[1];
  s.maxl = imax(d.nf, d.ng);
  s.x = take(at, size_t(d.in0()) * TB);
  const bool bwd = kind == EULER_BWD || kind == RH_BWD;
  for (int t = 0; t < 2; ++t) {
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
  if (kind == EULER_BWD) {
    s.carry[0] = take(at, sS);                         // dy
  } else if (kind == RH_FWD) {
    s.carry[0] = take(at, sS);                         // y
    s.carry[1] = take(at, sS);                         // f
    s.carry[2] = take(at, sG);                         // g
  } else if (kind == RH_BWD) {
    s.carry[0] = take(at, sS);                         // ay
    s.carry[1] = take(at, sS);                         // az
    s.carry[2] = take(at, sS);                         // af
    s.carry[3] = take(at, sG);                         // ag
    s.carry[4] = take(at, sS);                         // Az
  }
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
                               float* sm, const float* const pack[2],
                               const float* w[2]) {
  const Layout s = make_layout(table, d, kind, stage, nullptr);
  Layer* plan = reinterpret_cast<Layer*>(sm + s.plan);
  if (threadIdx.x == 0) make_layout(table, d, kind, stage, plan);
  __syncthreads();
  for (int t = 0; t < 2; ++t) {
    if (!((stage >> t) & 1)) {
      w[t] = pack[t];
      continue;
    }
    float* dst = sm + s.wstage[t];
    for (int i = 0; i < d.nl(t); ++i) {
      const Layer L = plan[d.base(t) + i];
      const float* src = pack[t] + L.g;
      for (int e = threadIdx.x; e < L.in * L.out; e += NT)
        dst[L.w + (e / L.out) * L.ld + e % L.out] = src[e];
      for (int e = threadIdx.x; e < L.out; e += NT)
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

// Both towers' forward for the tile from x, one layer depth per barrier.
// With `cache` every layer keeps its pre-activation and output where the
// plan says (the backward kernels); otherwise each tower alternates between
// its two buffers. Ends with a barrier.
__device__ inline void towers_forward(const Layer* plan, Dims d,
                                      const Layout& s, const float* const w[2],
                                      float* sm, bool cache) {
  const int t = threadIdx.x / HALF, j = threadIdx.x % HALF;
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

// Adds v to element i of a block's partial; the sweep's first step stores
// instead, so the buffer needs no zeroing.
__device__ __forceinline__ void accum(float* p, size_t i, float v,
                                      bool first) {
  p[i] = first ? v : p[i] + v;
}

// Thread j's unit of a layer going back: dpre[j][r] from the output
// cotangent (kept over pre), then the gradients of b[j] and of column j of
// W, added to the tower's partial `part`.
__device__ inline void layer_weight_grads(const Layer& L, const float* in,
                                          float* pre, const float* post,
                                          const float* dout, float* part,
                                          bool first, int j) {
  if (j >= L.out) return;
  float dp[TB], pv[TB], ov[TB], dv[TB], v[TB];
  load_rows(pv, pre + j * TB);
  load_rows(ov, post + j * TB);
  load_rows(dv, dout + j * TB);
  float db = 0.f;
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    dp[r] = act_bwd(dv[r], pv[r], ov[r], L.act);
    pre[j * TB + r] = dp[r];
    db += dp[r];
  }
  accum(part, size_t(L.g) + size_t(L.in) * L.out + j, db, first);
#pragma unroll 4
  for (int k = 0; k < L.in; ++k) {
    load_rows(v, in + k * TB);
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < TB; ++r) acc = fmaf(v[r], dp[r], acc);
    accum(part, size_t(L.g) + size_t(k) * L.out + j, acc, first);
  }
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

// Backpropagates each tower's output cotangent (in its dout buffer) through
// the cache of towers_forward, the deepest layers first, adding every
// weight gradient to the block's partial `part` ([fw | gw]). Leaves the
// cotangent of x ([k][r], in0 rows) in each tower's dout buffer. Two
// barriers a layer depth; ends with a barrier.
__device__ inline void towers_backward(const Layer* plan, Dims d,
                                       const Layout& s,
                                       const float* const w[2], float* sm,
                                       float* part, bool first) {
  const int t = threadIdx.x / HALF, j = threadIdx.x % HALF;
  const Layer* tp = plan + d.base(t);
  float* part_t = part + (t == 0 ? 0 : s.toff1);
  float* dout = sm + s.dout[t];
  for (int q = 0; q < s.maxl; ++q) {
    const int i = d.nl(t) - 1 - q;
    if (i >= 0) {
      const Layer L = tp[i];
      const float* in = i == 0 ? sm + s.x : sm + tp[i - 1].post;
      layer_weight_grads(L, in, sm + L.pre, sm + L.post, dout, part_t, first,
                         j);
    }
    __syncthreads();
    if (i >= 0) layer_input_grad(tp[i], w[t], sm + tp[i].pre, dout, j);
    __syncthreads();
  }
}

// out[e] = sum over blocks of partials[b][e], in block order: the weight
// gradients, bitwise the same from call to call. The sum is compensated
// (Neumaier): a plain float32 sum over 512 partials lands about three times
// further from a float64 run than the plain version's matmuls do.
static __global__ void reduce_partials(const float* partials, int blocks,
                                       size_t P, float* out) {
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= P) return;
  float sum = 0.f, comp = 0.f;
  for (int b = 0; b < blocks; ++b) {
    const float v = partials[size_t(b) * P + e];
    const float t = sum + v;
    comp += fabsf(sum) >= fabsf(v) ? (sum - t) + v : (v - t) + sum;
    sum = t;
  }
  out[e] = sum + comp;
}

inline int blocks_for(int B) { return (B + TB - 1) / TB; }

// Sets the kernel's dynamic shared memory for this layout; returns the CUDA
// error code.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, const Layout& s) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(s.total * sizeof(float)));
}

// Launches the sum of the sweep's partials into dw on `stream`.
static inline cudaError_t launch_reduce(const float* partials, int blocks,
                                        size_t P, float* dw,
                                        cudaStream_t stream) {
  constexpr int RT = 256;
  reduce_partials<<<static_cast<unsigned>((P + RT - 1) / RT), RT, 0,
                    stream>>>(partials, blocks, P, dw);
  return cudaGetLastError();
}

}  // namespace tsde_tower
