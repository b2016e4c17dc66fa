// Whole-solve forward of the latent-SDE logqp Euler-Maruyama solve, for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/latent_fused.py:_fwd_kernel
// (with _forward_core), launched by _fused_solve_fwd_impl. Same function, same
// order of operations per step, with x = [z | ctx] and the pre-step z:
//   f = softplus-MLP_f(x), h = softplus-MLP_h(z)           (3 layers each)
//   g_l = sigmoid(w2_l . softplus(z_l * w1_l + b1_l) + b2_l) (per dimension)
//   u = (f - h) / where(g > 1e-7, g, 1e-7)
//   q += 0.5 * sum_l(u * u) * dt;  z += f * dt + g * dW
//
// What bounds it. The solve is a chain of n dependent steps (128 at the
// flagship config). One step of one batch row costs (L+C)H + 2H^2 + LH + 2HL
// + 2LH multiply-adds: 44,032 at L=4, C=64, H=128, about 88 kFLOP, so
// 11.5 GFLOP for a solve at B=1024. Its memory traffic is small (the context
// rows, 8.4 MB, and noise, zs and qs, 4 MB), so it is bound by arithmetic and
// by the step-to-step dependency: the only parallelism is over batch rows and
// hidden units inside a step.
//
// Design. Rows never interact in the forward, so the batch is cut into tiles
// of TB rows, one thread block per tile (128 blocks at B=1024: one wave on
// 132 SMs), and each block runs the whole step loop with no grid-wide sync.
// All weights (45,068 floats, 176 KiB at the flagship) are copied into
// shared memory once and reused by every step; the state z stays in shared
// memory and q in a register. Each thread owns one hidden unit (strided when
// H > NT) and keeps TB accumulators, so one shared-memory weight read feeds
// TB FMAs while activations are read as broadcasts. The per-row outputs of
// a step (f and h contract over H, g over its nets' hidden units) are
// reduced one warp per output with shuffles. Plain f32 FMAs: tensor cores,
// TMA and bf16 are later work. The kernel allocates nothing and does not
// synchronise the host.
//
// K stacked replicas (tsde_latent_fused_fwd_multi) replace the Pallas
// kernel _fwd_kernel_multi (launched by _fused_solve_multi_fwd_impl), which
// unrolls the K chains inside each grid step. Here the replica is the grid's
// y axis instead: each block holds one replica's weights in shared memory
// (one block an SM at the flagship), so K x 128 blocks run in about
// ceil(128K / 132) waves and the bound is K times a single solve's.

#include <cuda_runtime.h>
#include <stddef.h>

#include "latent_fused_common.cuh"

namespace {

using namespace tsde_latent;

constexpr int NT = 128;          // threads per block
constexpr int NWARPS = NT / 32;

// Offsets (in floats) of each array in dynamic shared memory.
struct Layout {
  size_t fw1, fb1, fw2, fb2, fw3t, fb3;
  size_t hw1, hb1, hw2, hb2, hw3t, hb3;
  size_t gw1, gb1, gw2, gb2;
  size_t x, a1f, a1h, a2f, a2h, out;
  size_t total;
};

__host__ __device__ inline Layout make_layout(int L, int C, int H) {
  Layout s;
  size_t at = 0;
  const size_t D = size_t(L) + C, h = H, l = L;
  s.fw1 = take(at, D * h);   s.fb1 = take(at, h);
  s.fw2 = take(at, h * h);   s.fb2 = take(at, h);
  s.fw3t = take(at, h * l);  s.fb3 = take(at, l);   // W3 stored as (L, H)
  s.hw1 = take(at, l * h);   s.hb1 = take(at, h);
  s.hw2 = take(at, h * h);   s.hb2 = take(at, h);
  s.hw3t = take(at, h * l);  s.hb3 = take(at, l);
  s.gw1 = take(at, l * h);   s.gb1 = take(at, l * h);
  s.gw2 = take(at, l * h);   s.gb2 = take(at, l);
  s.x = take(at, D * TB);            // [k][r]: rows k < L are z, then ctx
  s.a1f = take(at, h * TB);          // [j][r]
  s.a1h = take(at, h * TB);          // [j][r]
  s.a2f = take(at, size_t(TB) * h);  // [r][j]
  s.a2h = take(at, size_t(TB) * h);  // [r][j]
  s.out = take(at, 3 * l * TB);      // [kind][r][l]: f, h, g pre-activations
  s.total = at;
  return s;
}

struct Args {
  const float* z0;       // ([K,] B, L)
  const float* ctx;      // ([K,] T, B, C)
  const int* ctx_idx;    // (n,), shared by the replicas
  const float* noise;    // ([K,] n, B, L)
  const float* dts;      // (n,), shared by the replicas
  const float* w[NW];    // f_w1 f_b1 f_w2 f_b2 f_w3 f_b3, h_*, g_w1 g_b1 g_w2 g_b2
  float* zs;             // ([K,] n, B, L)
  float* qs;             // ([K,] n, B, 1)
  int B, L, C, H, T, n;
};

__global__ void __launch_bounds__(NT) latent_fused_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, C = a.C, H = a.H, B = a.B, D = L + C;
  const Layout lay = make_layout(L, C, H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TB;

  // This block's replica.
  const size_t rep = replica(), steps = size_t(a.n) * B * L;
  const float* z0 = a.z0 + rep * B * L;
  const float* ctx = a.ctx + rep * a.T * B * C;
  const float* noise = a.noise + rep * steps;
  float* zs = a.zs + rep * steps;
  float* qs = a.qs + rep * a.n * B;
  size_t wsize[NW];
  weight_sizes(L, C, H, wsize);
  const float* wr[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) wr[i] = a.w[i] + rep * wsize[i];

  // Weights into shared memory, once for the whole solve.
  copy_to_smem<NT>(sm + lay.fw1, wr[0], D * H);
  copy_to_smem<NT>(sm + lay.fb1, wr[1], H);
  copy_to_smem<NT>(sm + lay.fw2, wr[2], H * H);
  copy_to_smem<NT>(sm + lay.fb2, wr[3], H);
  copy_to_smem<NT>(sm + lay.fb3, wr[5], L);
  copy_to_smem<NT>(sm + lay.hw1, wr[6], L * H);
  copy_to_smem<NT>(sm + lay.hb1, wr[7], H);
  copy_to_smem<NT>(sm + lay.hw2, wr[8], H * H);
  copy_to_smem<NT>(sm + lay.hb2, wr[9], H);
  copy_to_smem<NT>(sm + lay.hb3, wr[11], L);
  for (int e = tid; e < H * L; e += NT) {      // (H, L) -> (L, H)
    const int j = e / L, l = e % L;
    sm[lay.fw3t + l * H + j] = wr[4][e];
    sm[lay.hw3t + l * H + j] = wr[10][e];
  }
  copy_to_smem<NT>(sm + lay.gw1, wr[12], L * H);  // (L,1,H) as (L,H)
  copy_to_smem<NT>(sm + lay.gb1, wr[13], L * H);
  copy_to_smem<NT>(sm + lay.gw2, wr[14], L * H);  // (L,H,1) as (L,H)
  copy_to_smem<NT>(sm + lay.gb2, wr[15], L);

  float* x = sm + lay.x;
  float* a1f = sm + lay.a1f;
  float* a1h = sm + lay.a1h;
  float* a2f = sm + lay.a2f;
  float* a2h = sm + lay.a2h;
  float* out = sm + lay.out;
  // Rows past the end of the batch compute on zeros and are never stored.
  for (int e = tid; e < L * TB; e += NT) {
    const int l = e / TB, r = e % TB, row = row0 + r;
    x[l * TB + r] = row < B ? z0[size_t(row) * L + l] : 0.f;
  }
  float q = 0.f;                               // row `tid` for tid < TB
  __syncthreads();

  for (int s = 0; s < a.n; ++s) {
    // A. This step's context rows into x[L:].
    const int ci = min(max(a.ctx_idx[s], 0), a.T - 1);
    const float* cstep = ctx + size_t(ci) * B * C;
    for (int e = tid; e < TB * C; e += NT) {
      const int r = e / C, c = e % C, row = row0 + r;
      x[(L + c) * TB + r] = row < B ? cstep[size_t(row) * C + c] : 0.f;
    }
    __syncthreads();

    // B. Layer 1 of f (input x) and of h (input z).
    for (int j = tid; j < H; j += NT) {
      float af[TB], ah[TB];
#pragma unroll
      for (int r = 0; r < TB; ++r) af[r] = ah[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        const float w = sm[lay.fw1 + k * H + j];
        const float4 x0 = *reinterpret_cast<const float4*>(x + k * TB);
        const float4 x1 = *reinterpret_cast<const float4*>(x + k * TB + 4);
        af[0] = fmaf(x0.x, w, af[0]); af[1] = fmaf(x0.y, w, af[1]);
        af[2] = fmaf(x0.z, w, af[2]); af[3] = fmaf(x0.w, w, af[3]);
        af[4] = fmaf(x1.x, w, af[4]); af[5] = fmaf(x1.y, w, af[5]);
        af[6] = fmaf(x1.z, w, af[6]); af[7] = fmaf(x1.w, w, af[7]);
      }
      for (int k = 0; k < L; ++k) {
        const float w = sm[lay.hw1 + k * H + j];
        const float4 x0 = *reinterpret_cast<const float4*>(x + k * TB);
        const float4 x1 = *reinterpret_cast<const float4*>(x + k * TB + 4);
        ah[0] = fmaf(x0.x, w, ah[0]); ah[1] = fmaf(x0.y, w, ah[1]);
        ah[2] = fmaf(x0.z, w, ah[2]); ah[3] = fmaf(x0.w, w, ah[3]);
        ah[4] = fmaf(x1.x, w, ah[4]); ah[5] = fmaf(x1.y, w, ah[5]);
        ah[6] = fmaf(x1.z, w, ah[6]); ah[7] = fmaf(x1.w, w, ah[7]);
      }
      const float bf = sm[lay.fb1 + j], bh = sm[lay.hb1 + j];
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        a1f[j * TB + r] = softplus(af[r] + bf);
        a1h[j * TB + r] = softplus(ah[r] + bh);
      }
    }
    __syncthreads();

    // C. Layer 2 of both towers.
    for (int j = tid; j < H; j += NT) {
      float af[TB], ah[TB];
#pragma unroll
      for (int r = 0; r < TB; ++r) af[r] = ah[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float wf = sm[lay.fw2 + k * H + j];
        const float wh = sm[lay.hw2 + k * H + j];
        const float4 f0 = *reinterpret_cast<const float4*>(a1f + k * TB);
        const float4 f1 = *reinterpret_cast<const float4*>(a1f + k * TB + 4);
        const float4 h0 = *reinterpret_cast<const float4*>(a1h + k * TB);
        const float4 h1 = *reinterpret_cast<const float4*>(a1h + k * TB + 4);
        af[0] = fmaf(f0.x, wf, af[0]); af[1] = fmaf(f0.y, wf, af[1]);
        af[2] = fmaf(f0.z, wf, af[2]); af[3] = fmaf(f0.w, wf, af[3]);
        af[4] = fmaf(f1.x, wf, af[4]); af[5] = fmaf(f1.y, wf, af[5]);
        af[6] = fmaf(f1.z, wf, af[6]); af[7] = fmaf(f1.w, wf, af[7]);
        ah[0] = fmaf(h0.x, wh, ah[0]); ah[1] = fmaf(h0.y, wh, ah[1]);
        ah[2] = fmaf(h0.z, wh, ah[2]); ah[3] = fmaf(h0.w, wh, ah[3]);
        ah[4] = fmaf(h1.x, wh, ah[4]); ah[5] = fmaf(h1.y, wh, ah[5]);
        ah[6] = fmaf(h1.z, wh, ah[6]); ah[7] = fmaf(h1.w, wh, ah[7]);
      }
      const float bf = sm[lay.fb2 + j], bh = sm[lay.hb2 + j];
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        a2f[r * H + j] = softplus(af[r] + bf);
        a2h[r * H + j] = softplus(ah[r] + bh);
      }
    }
    __syncthreads();

    // D. Per-row outputs, one warp each: layer 3 of f and h, and the g nets'
    // contraction (their hidden layer is evaluated on the fly).
    const int per_kind = L * TB;
    for (int o = warp; o < 3 * per_kind; o += NWARPS) {
      const int kind = o / per_kind, rem = o % per_kind;
      const int r = rem / L, l = rem % L;
      float acc = 0.f;
      if (kind == 0) {
        for (int k = lane; k < H; k += 32)
          acc = fmaf(a2f[r * H + k], sm[lay.fw3t + l * H + k], acc);
      } else if (kind == 1) {
        for (int k = lane; k < H; k += 32)
          acc = fmaf(a2h[r * H + k], sm[lay.hw3t + l * H + k], acc);
      } else {
        const float z = x[l * TB + r];
        for (int k = lane; k < H; k += 32) {
          const float pre = z * sm[lay.gw1 + l * H + k] + sm[lay.gb1 + l * H + k];
          acc = fmaf(softplus(pre), sm[lay.gw2 + l * H + k], acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) out[o] = acc;
    }
    __syncthreads();

    // E. State update, one thread per row. No barrier follows: the next
    // step's phase A writes only the context rows of x, and its barrier
    // orders these z writes before phase B reads them.
    if (tid < TB) {
      const int r = tid, row = row0 + r;
      const float dt = a.dts[s];
      float usum = 0.f;
      for (int l = 0; l < L; ++l) {
        const float f = out[r * L + l] + sm[lay.fb3 + l];
        const float h = out[per_kind + r * L + l] + sm[lay.hb3 + l];
        const float g = sigmoid(out[2 * per_kind + r * L + l] + sm[lay.gb2 + l]);
        const float gs = g > EPS ? g : EPS;
        const float u = (f - h) / gs;
        usum += u * u;
        const size_t at = (size_t(s) * B + row) * L + l;
        const float dW = row < B ? noise[at] : 0.f;
        const float zn = x[l * TB + r] + f * dt + g * dW;
        x[l * TB + r] = zn;
        if (row < B) zs[at] = zn;
      }
      q = q + 0.5f * usum * dt;
      if (row < B) qs[size_t(s) * B + row] = q;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for these widths.
size_t tsde_latent_fused_fwd_smem_bytes(int L, int C, int H) {
  return make_layout(L, C, H).total * sizeof(float);
}

const char* tsde_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

namespace {

// Launches K stacked solves (K = 1: a single solve) on `stream` and returns
// cudaGetLastError() (0 on success).
int launch(const Args& a, int K, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K <= 0 || a.B <= 0 || a.n <= 0) return 0;
  const size_t smem = tsde_latent_fused_fwd_smem_bytes(a.L, a.C, a.H);
  err = cudaFuncSetAttribute(latent_fused_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.B + TB - 1) / TB, K);
  latent_fused_fwd_kernel<<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* z0, const float* ctx, const int* ctx_idx,
               const float* noise, const float* dts, const float* const* w,
               float* zs, float* qs, int B, int L, int C, int H, int T, int n) {
  Args a;
  a.z0 = z0; a.ctx = ctx; a.ctx_idx = ctx_idx; a.noise = noise; a.dts = dts;
  for (int i = 0; i < NW; ++i) a.w[i] = w[i];
  a.zs = zs; a.qs = qs;
  a.B = B; a.L = L; a.C = C; a.H = H; a.T = T; a.n = n;
  return a;
}

}  // namespace

extern "C" {

// Launches the solve on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers to contiguous float32 arrays,
// ctx_idx int32; weights in the order of latent_fused.WEIGHT_NAMES.
int tsde_latent_fused_fwd(
    const float* z0, const float* ctx, const int* ctx_idx, const float* noise,
    const float* dts, TSDE_WEIGHT_PARAMS, float* zs, float* qs, int B, int L,
    int C, int H, int T, int n, int device, cudaStream_t stream) {
  const float* w[NW] = TSDE_WEIGHTS;
  return launch(make_args(z0, ctx, ctx_idx, noise, dts, w, zs, qs, B, L, C,
                          H, T, n), 1, device, stream);
}

// The same for K stacked replicas in one launch: z0 (K,B,L), ctx (K,T,B,C),
// noise (K,n,B,L), each weight (K, ...), zs (K,n,B,L) and qs (K,n,B,1);
// ctx_idx (n,) and dts (n,) are shared.
int tsde_latent_fused_fwd_multi(
    const float* z0, const float* ctx, const int* ctx_idx, const float* noise,
    const float* dts, TSDE_WEIGHT_PARAMS, float* zs, float* qs, int K, int B,
    int L, int C, int H, int T, int n, int device, cudaStream_t stream) {
  const float* w[NW] = TSDE_WEIGHTS;
  return launch(make_args(z0, ctx, ctx_idx, noise, dts, w, zs, qs, B, L, C,
                          H, T, n), K, device, stream);
}

}  // extern "C"
