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
// 11.5 GFLOP for a solve at B=1024, and 4H + LH softplus evaluations (the
// towers' and the g nets': 1,024 a row and step), each some forty
// instructions. Its memory traffic is small (the context rows,
// 8.4 MB, and noise, zs and qs, 4 MB), so it is bound by instruction issue
// and by the step-to-step dependency: the only parallelism is over batch
// rows and hidden units inside a step.
//
// Design. Rows never interact in the forward, so the batch is cut into tiles
// of R rows, one thread block per tile, and each block runs the whole step
// loop with no grid-wide sync. All weights (45,068 floats, 176 KiB at the
// flagship) are copied into shared memory once and reused by every step,
// which leaves room for one block an SM; so a block has 512 threads (four
// warps a scheduler, to hide the latency of shared memory and of the
// softplus chains), the drift tower f on one half and the prior h on the
// other: 128 threads over the hidden units (strided when H > 128) times two
// groups of the rows. A thread keeps R / 2 accumulators, so one
// shared-memory weight read feeds R / 2 FMAs while the activations
// ([unit][row]) are read as float4 broadcasts. Each step:
//   1. layer 1 of f (on x) and of h (on z); barrier;
//   2. the next step's context rows (into x, which layer 1 has read) and
//      noise (double-buffered) start to arrive by cp.async; layer 2 of both
//      towers; barrier;
//   3. the per-row outputs as sums over parts of the hidden units, spread
//      over all the block's threads: layer 3 of f and of h (NP parts), the
//      g nets' hidden layer and output (NPG parts, softplus on the fly);
//      each part's sum to shared memory; barrier;
//   4. a thread an output (l, r): the parts summed in a fixed order, g, u,
//      the state update and zs; wait for the copies; barrier; a thread a row
//      then adds its sum of u^2 to q and writes qs.
// No row's arithmetic depends on R or on the other rows of its block, so a
// row's result is the same at any block size and in any replica.
// Matrices [in][hidden] are stored with row stride H (threads read along
// the hidden units); those read along the hidden units by threads of
// different outputs (W3^T and the g nets' [l][k]) with an odd stride, free of
// bank conflicts. Plain f32 FMAs, each written out (fmaf) so that no
// instantiation contracts differently, and the precise softplus of the
// reverse sweep; no fast math.
//
// Blocks of 256, 512 and 1,024 threads and 8 and 16 rows were timed on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --only tiles): 512 threads
// were the fastest at every K, by 18-26 % over 256 and 7-17 % over 1,024.
//
// bf16 mixed mode (the _bf16 entry points; latent_fused_common.cuh): the
// weights, the context and the noise come in bf16 and are widened to float
// as they are staged in shared memory (so the shared-memory layout is the
// float32 kernel's; holding them in bf16 there is later work), the states
// zs go out in bf16 while the carried state (zc) and qs stay float32. The
// products' inputs are rounded to bf16 where the JAX package's
// _forward_core rounds them: x = [z | ctx] (x keeps z rounded, zc the
// carry), the two hidden activations of each tower (rounded as they are
// written, since only products read them here), and the g nets' scalar z_l
// and hidden activations. Biases, softplus, sigmoid, u, the KL integrand
// and the update are float32. The bf16 noise and context rows are loaded
// and widened by plain loads (cp.async's smallest copy is 4 bytes).
//
// K stacked replicas (tsde_latent_fused_fwd_multi) replace the Pallas
// kernel _fwd_kernel_multi (launched by _fused_solve_multi_fwd_impl), which
// unrolls the K chains inside each grid step. Here the replica is the grid's
// y axis instead: each block holds one replica's weights in shared memory
// (one block an SM at the flagship). When 8-row tiles would need more than
// one wave of blocks (K x B / 8 over the SMs), a block takes 16 rows, which
// halves the waves for less than twice the work a block (at K 4: 3.50 ms
// against 3.93 at 8 rows, same card).

#include <cuda_runtime.h>
#include <stddef.h>

#include "latent_fused_common.cuh"

namespace tsde_latent_fwd {

using namespace tsde_latent;

constexpr int FWD_THREADS = 512;  // threads a block: a tower on each half
constexpr int TW = 128;           // a tower's threads over the hidden units
constexpr int NP = 4;             // parts of f's and h's layer-3 sums
constexpr int NPG = 8;            // parts of the g nets' sums

__host__ __device__ inline int row_stride(int H) { return H | 1; }

// Offsets (in floats) of each array in dynamic shared memory for R rows.
struct Layout {
  size_t fw1, fb1, fw2, fb2, fw3t, fb3;
  size_t hw1, hb1, hw2, hb2, hw3t, hb3;
  size_t gw1, gb1, gw2, gb2;
  size_t x, zc, nz, a1, a2, red, usq;
  size_t total;
};

__host__ __device__ inline Layout make_layout(int L, int C, int H, int R) {
  Layout s;
  size_t at = 0;
  const size_t D = size_t(L) + C, h = H, l = L, ld = row_stride(H);
  s.fw1 = take(at, D * h);   s.fb1 = take(at, h);   // [k][j]
  s.fw2 = take(at, h * h);   s.fb2 = take(at, h);
  s.fw3t = take(at, l * ld); s.fb3 = take(at, l);   // W3 as [l][k]
  s.hw1 = take(at, l * h);   s.hb1 = take(at, h);
  s.hw2 = take(at, h * h);   s.hb2 = take(at, h);
  s.hw3t = take(at, l * ld); s.hb3 = take(at, l);
  s.gw1 = take(at, l * ld);  s.gb1 = take(at, l * ld);   // [l][k]
  s.gw2 = take(at, l * ld);  s.gb2 = take(at, l);
  s.x = take(at, D * R);             // [k][r]: rows k < L are z (as a
                                     // product's input), then ctx
  s.zc = take(at, l * R);            // [l][r]: the carried state z
  s.nz = take(at, 2 * l * R);        // [buffer][l][r]: noise
  s.a1 = take(at, 2 * h * R);        // [tower][j][r]
  s.a2 = take(at, 2 * h * R);        // [tower][j][r]
  s.red = take(at, (2 * NP + NPG) * l * R);  // [f|h|g parts][l][r]
  s.usq = take(at, l * R);           // [l][r]: u^2
  s.total = at;
  return s;
}

// W: float, or __nv_bfloat16 in mixed mode.
template <typename W>
struct Args {
  const float* z0;       // ([K,] B, L)
  const W* ctx;          // ([K,] T, B, C)
  const int* ctx_idx;    // (n,), shared by the replicas
  const W* noise;        // ([K,] n, B, L)
  const float* dts;      // (n,), shared by the replicas
  const W* w[NW];        // in latent_fused.WEIGHT_NAMES order
  W* zs;                 // ([K,] n, B, L)
  float* qs;             // ([K,] n, B, 1)
  int B, L, C, H, T, n;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A unit's N rows as N / 4 float4 loads (16-byte aligned), or one float2
// (N = 2, 8-byte aligned).
template <int N>
__device__ __forceinline__ void load_rows(float (&v)[N], const float* p) {
  if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(p + 4 * q);
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }
}

// Step s's context rows into x's rows L.. ([k][r]) and its noise into nzb
// ([l][r]), for the tile at row0; rows past the batch are zero-filled.
template <int NT, int R, typename W>
__device__ __forceinline__ void prefetch_step(int s, float* x, float* nzb,
                                              const W* ctx,
                                              const int* ctx_idx,
                                              const W* noise, int row0,
                                              int B, int L, int C, int T) {
  const int ci = min(max(__ldg(ctx_idx + s), 0), T - 1);
  const W* cst = ctx + size_t(ci) * B * C;
  for (int e = threadIdx.x; e < R * C; e += NT) {
    const int r = e / C, c = e % C, row = row0 + r;
    const bool valid = row < B;
    stage(x + (L + c) * R + r, valid ? cst + size_t(row) * C + c : ctx,
          valid);
  }
  for (int e = threadIdx.x; e < R * L; e += NT) {
    const int r = e / L, l = e % L, row = row0 + r;
    const bool valid = row < B;
    stage(nzb + l * R + r,
          valid ? noise + (size_t(s) * B + row) * L + l : noise, valid);
  }
  cp_async_commit();
}

// One layer of a tower for this thread's units j (strided by TW) and rows
// [r0, r0 + RP): out[j][r] = softplus(in[:, r] . W[:, j] + b[j]), W [k][j]
// with row stride H, in and out [unit][row] with R rows; out is written
// rounded to W (only products read it).
template <int R, int RP, typename W>
__device__ __forceinline__ void layer(const float* w, const float* b,
                                      const float* in, float* out, int kin,
                                      int H, int j0, int r0) {
  for (int j = j0; j < H; j += TW) {
    float acc[RP], v[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kin; ++k) {
      const float wk = w[k * H + j];
      load_rows(v, in + k * R + r0);
#pragma unroll
      for (int r = 0; r < RP; ++r) acc[r] = fmaf(v[r], wk, acc[r]);
    }
    const float bj = b[j];
#pragma unroll
    for (int r = 0; r < RP; ++r)
      out[j * R + r0 + r] = rnd<W>(softplus(acc[r] + bj));
  }
}

// One block an SM (its shared memory): registers up to 128 a thread at 512
// threads, where the default bound held ptxas to 64 (0.985 against 0.956
// ms for kernel 1 at 94; NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py
// --only ab).
template <int NT, int R, typename W>
__global__ void __launch_bounds__(NT, 1)
    latent_fused_fwd_kernel(const Args<W> a) {
  constexpr int NTT = NT / 2;          // threads of a tower
  constexpr int RG = NTT / TW;         // row groups of a tower's threads
  constexpr int RP = R / RG;           // rows a thread
  static_assert(RP == 2 || RP % 4 == 0, "rows a thread: 2 or 4k");
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, C = a.C, H = a.H, B = a.B, D = L + C, n = a.n;
  const int ld = row_stride(H);
  const Layout lay = make_layout(L, C, H, R);
  const int tid = threadIdx.x, tw = tid / NTT, tt = tid % NTT;
  const int j0 = tt % TW, r0 = (tt / TW) * RP;
  const int row0 = blockIdx.x * R;
  const int O = L * R;                 // per-row outputs of a kind
  const int nfh = 2 * NP * O;          // f's and h's layer-3 parts
  const int klen = (H + NP - 1) / NP, kleng = (H + NPG - 1) / NPG;

  // This block's replica.
  const size_t rep = replica(), steps = size_t(n) * B * L;
  const float* z0 = a.z0 + rep * B * L;
  const W* ctx = a.ctx + rep * a.T * B * C;
  const W* noise = a.noise + rep * steps;
  W* zs = a.zs + rep * steps;
  float* qs = a.qs + rep * n * B;
  size_t wsize[NW];
  weight_sizes(L, C, H, wsize);
  const W* wr[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) wr[i] = a.w[i] + rep * wsize[i];

  float* x = sm + lay.x;
  float* zc = sm + lay.zc;
  float* nz = sm + lay.nz;
  float* a1 = sm + lay.a1;
  float* a2 = sm + lay.a2;
  float* red = sm + lay.red;
  float* usq = sm + lay.usq;
  prefetch_step<NT, R>(0, x, nz, ctx, a.ctx_idx, noise, row0, B, L, C, a.T);

  // Weights into shared memory (as float), once for the whole solve.
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
  for (int e = tid; e < H * L; e += NT) {      // (H, L) -> [l][k]
    const int k = e / L, l = e % L;
    sm[lay.fw3t + l * ld + k] = to_f(wr[4][e]);
    sm[lay.hw3t + l * ld + k] = to_f(wr[10][e]);
  }
  for (int e = tid; e < L * H; e += NT) {      // (L,1,H), (L,H), (L,H,1)
    const int l = e / H, k = e % H;
    sm[lay.gw1 + l * ld + k] = to_f(wr[12][e]);
    sm[lay.gb1 + l * ld + k] = to_f(wr[13][e]);
    sm[lay.gw2 + l * ld + k] = to_f(wr[14][e]);
  }
  copy_to_smem<NT>(sm + lay.gb2, wr[15], L);
  // Rows past the end of the batch compute on zeros and are never stored.
  for (int e = tid; e < L * R; e += NT) {
    const int l = e / R, r = e % R, row = row0 + r;
    const float z = row < B ? z0[size_t(row) * L + l] : 0.f;
    zc[l * R + r] = z;
    x[l * R + r] = rnd<W>(z);
  }
  float q = 0.f;                               // row `tid` for tid < R
  cp_async_wait_all();
  __syncthreads();

  const float* w1 = sm + (tw ? lay.hw1 : lay.fw1);
  const float* b1 = sm + (tw ? lay.hb1 : lay.fb1);
  const float* w2 = sm + (tw ? lay.hw2 : lay.fw2);
  const float* b2 = sm + (tw ? lay.hb2 : lay.fb2);
  float* a1t = a1 + size_t(tw) * H * R;
  float* a2t = a2 + size_t(tw) * H * R;

  for (int s = 0; s < n; ++s) {
    // 1. Layer 1: f on x, h on z.
    layer<R, RP, W>(w1, b1, x, a1t, tw ? L : D, H, j0, r0);
    __syncthreads();

    // 2. x's context rows are read: the next step's start to arrive. Layer 2.
    if (s + 1 < n)
      prefetch_step<NT, R>(s + 1, x, nz + ((s + 1) & 1) * L * R, ctx,
                           a.ctx_idx, noise, row0, B, L, C, a.T);
    layer<R, RP, W>(w2, b2, a1t, a2t, H, H, j0, r0);
    __syncthreads();

    // 3. The per-row outputs' parts: item e of f and h is (tower, part p,
    // output o = l R + r), then the g nets' items (part p, output o).
    for (int e = tid; e < nfh + NPG * O; e += NT) {
      float acc = 0.f;
      if (e < nfh) {
        const int t = e / (NP * O), p = (e / O) % NP, o = e % O;
        const int l = o / R, r = o % R;
        const float* av = a2 + size_t(t) * H * R + r;
        const float* w3 = sm + (t ? lay.hw3t : lay.fw3t) + l * ld;
        const int k1 = min(H, (p + 1) * klen);
#pragma unroll 4
        for (int k = p * klen; k < k1; ++k)
          acc = fmaf(av[k * R], w3[k], acc);
      } else {
        const int p = (e - nfh) / O, o = (e - nfh) % O;
        const int l = o / R, r = o % R;
        const float z = x[l * R + r];
        const float* gw1 = sm + lay.gw1 + l * ld;
        const float* gb1 = sm + lay.gb1 + l * ld;
        const float* gw2 = sm + lay.gw2 + l * ld;
        const int k1 = min(H, (p + 1) * kleng);
#pragma unroll 4
        for (int k = p * kleng; k < k1; ++k)
          acc = fmaf(rnd<W>(softplus(fmaf(z, gw1[k], gb1[k]))), gw2[k],
                     acc);
      }
      red[e] = acc;
    }
    __syncthreads();

    // 4. A thread an output: f, h, g, u from the parts in order, the state
    // update; u^2 for the row's KL sum.
    const float dt = a.dts[s];
    const float* nzb = nz + (s & 1) * L * R;
    for (int o = tid; o < O; o += NT) {
      const int l = o / R, r = o % R, row = row0 + r;
      float pf = 0.f, ph = 0.f, pg = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        pf += red[p * O + o];
        ph += red[(NP + p) * O + o];
      }
#pragma unroll
      for (int p = 0; p < NPG; ++p) pg += red[(2 * NP + p) * O + o];
      const float f = pf + sm[lay.fb3 + l];
      const float h = ph + sm[lay.hb3 + l];
      const float g = sigmoid(pg + sm[lay.gb2 + l]);
      const float gs = g > EPS ? g : EPS;
      const float u = (f - h) / gs;
      usq[o] = u * u;
      const float zn = fmaf(g, nzb[o], fmaf(f, dt, zc[o]));
      zc[o] = zn;
      x[o] = rnd<W>(zn);
      if (row < B) zs[(size_t(s) * B + row) * L + l] = from_f<W>(zn);
    }
    cp_async_wait_all();
    __syncthreads();

    // The row's KL increment, in the order of l.
    if (tid < R) {
      float usum = 0.f;
      for (int l = 0; l < L; ++l) usum += usq[l * R + tid];
      q = fmaf(0.5f * usum, dt, q);
      if (row0 + tid < B) qs[size_t(s) * B + row0 + tid] = q;
    }
  }
}

__host__ inline size_t smem_bytes(int L, int C, int H, int R) {
  return make_layout(L, C, H, R).total * sizeof(float);
}

// Launches K stacked solves (K = 1: a single solve) at R rows a block on
// `stream` and returns cudaGetLastError() (0 on success).
template <int NT, int R, typename W>
int launch_rows(const Args<W>& a, int K, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.L, a.C, a.H, R);
  cudaError_t err = cudaFuncSetAttribute(
      latent_fused_fwd_kernel<NT, R, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.B + R - 1) / R, K);
  latent_fused_fwd_kernel<NT, R, W><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Rows a block for K replicas of B rows: 16 when 8-row blocks would
// outnumber the SMs and 16 rows fit a block's shared memory, else 8.
inline int rows_for(int K, int B, int L, int C, int H, int device) {
  int sms = 0, smem_max = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
          != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_max,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return TB;
  const long blocks8 = long(K) * ((B + TB - 1) / TB);
  if (blocks8 > sms && smem_bytes(L, C, H, 2 * TB) <= size_t(smem_max))
    return 2 * TB;
  return TB;
}

template <typename W>
int launch(const Args<W>& a, int K, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K <= 0 || a.B <= 0 || a.n <= 0) return 0;
  if (rows_for(K, a.B, a.L, a.C, a.H, device) == 2 * TB)
    return launch_rows<FWD_THREADS, 2 * TB>(a, K, stream);
  return launch_rows<FWD_THREADS, TB>(a, K, stream);
}

template <typename W>
Args<W> make_args(const float* z0, const W* ctx, const int* ctx_idx,
                  const W* noise, const float* dts, const W* const* w, W* zs,
                  float* qs, int B, int L, int C, int H, int T, int n) {
  Args<W> a;
  a.z0 = z0; a.ctx = ctx; a.ctx_idx = ctx_idx; a.noise = noise; a.dts = dts;
  for (int i = 0; i < NW; ++i) a.w[i] = w[i];
  a.zs = zs; a.qs = qs;
  a.B = B; a.L = L; a.C = C; a.H = H; a.T = T; a.n = n;
  return a;
}

}  // namespace tsde_latent_fwd

extern "C" {

// Dynamic shared memory one block needs for these widths (at 8 rows a
// block, the fewest a launch takes).
size_t tsde_latent_fused_fwd_smem_bytes(int L, int C, int H) {
  return tsde_latent_fwd::smem_bytes(L, C, H, tsde_latent::TB);
}

// Rows a block of K stacked solves of B rows take on this device (8 or 16).
int tsde_latent_fused_fwd_rows(int K, int B, int L, int C, int H,
                               int device) {
  return tsde_latent_fwd::rows_for(K, B, L, C, H, device);
}

const char* tsde_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the solve on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers to contiguous float32 arrays,
// ctx_idx int32; weights in the order of latent_fused.WEIGHT_NAMES. The
// _bf16 entry points take bf16 mixed mode: ctx, noise, the weights and zs
// bf16, the rest as here.
int tsde_latent_fused_fwd(
    const float* z0, const float* ctx, const int* ctx_idx, const float* noise,
    const float* dts, TSDE_WEIGHT_PARAMS, float* zs, float* qs, int B, int L,
    int C, int H, int T, int n, int device, cudaStream_t stream) {
  using namespace tsde_latent_fwd;
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
  using namespace tsde_latent_fwd;
  const float* w[NW] = TSDE_WEIGHTS;
  return launch(make_args(z0, ctx, ctx_idx, noise, dts, w, zs, qs, B, L, C,
                          H, T, n), K, device, stream);
}

int tsde_latent_fused_fwd_bf16(
    const float* z0, const __nv_bfloat16* ctx, const int* ctx_idx,
    const __nv_bfloat16* noise, const float* dts,
    TSDE_WEIGHT_PARAMS_T(__nv_bfloat16), __nv_bfloat16* zs, float* qs, int B,
    int L, int C, int H, int T, int n, int device, cudaStream_t stream) {
  using namespace tsde_latent_fwd;
  const __nv_bfloat16* w[NW] = TSDE_WEIGHTS;
  return launch(make_args(z0, ctx, ctx_idx, noise, dts, w, zs, qs, B, L, C,
                          H, T, n), 1, device, stream);
}

int tsde_latent_fused_fwd_multi_bf16(
    const float* z0, const __nv_bfloat16* ctx, const int* ctx_idx,
    const __nv_bfloat16* noise, const float* dts,
    TSDE_WEIGHT_PARAMS_T(__nv_bfloat16), __nv_bfloat16* zs, float* qs, int K,
    int B, int L, int C, int H, int T, int n, int device,
    cudaStream_t stream) {
  using namespace tsde_latent_fwd;
  const __nv_bfloat16* w[NW] = TSDE_WEIGHTS;
  return launch(make_args(z0, ctx, ctx_idx, noise, dts, w, zs, qs, B, L, C,
                          H, T, n), K, device, stream);
}

}  // extern "C"
