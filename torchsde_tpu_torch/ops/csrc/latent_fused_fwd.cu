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
// bf16 mixed mode (the _bf16 entry points) is a kernel of its own on bf16
// tensor cores, latent_fwd_bf16 below.
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
#include "mma_bf16.cuh"

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
template <int NT, int R>
__device__ __forceinline__ void prefetch_step(int s, float* x, float* nzb,
                                              const float* ctx,
                                              const int* ctx_idx,
                                              const float* noise, int row0,
                                              int B, int L, int C, int T) {
  const int ci = min(max(__ldg(ctx_idx + s), 0), T - 1);
  const float* cst = ctx + size_t(ci) * B * C;
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
// with row stride H, in and out [unit][row] with R rows.
template <int R, int RP>
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
      out[j * R + r0 + r] = softplus(acc[r] + bj);
  }
}

// One block an SM (its shared memory): registers up to 128 a thread at 512
// threads, where the default bound held ptxas to 64 (0.985 against 0.956
// ms for kernel 1 at 94; NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py
// --only ab).
template <int NT, int R>
__global__ void __launch_bounds__(NT, 1)
    latent_fused_fwd_kernel(const Args<float> a) {
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
  const float* ctx = a.ctx + rep * a.T * B * C;
  const float* noise = a.noise + rep * steps;
  float* zs = a.zs + rep * steps;
  float* qs = a.qs + rep * n * B;
  size_t wsize[NW];
  weight_sizes(L, C, H, wsize);
  const float* wr[NW];
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
  for (int e = tid; e < H * L; e += NT) {      // (H, L) -> [l][k]
    const int k = e / L, l = e % L;
    sm[lay.fw3t + l * ld + k] = wr[4][e];
    sm[lay.hw3t + l * ld + k] = wr[10][e];
  }
  for (int e = tid; e < L * H; e += NT) {      // (L,1,H), (L,H), (L,H,1)
    const int l = e / H, k = e % H;
    sm[lay.gw1 + l * ld + k] = wr[12][e];
    sm[lay.gb1 + l * ld + k] = wr[13][e];
    sm[lay.gw2 + l * ld + k] = wr[14][e];
  }
  copy_to_smem<NT>(sm + lay.gb2, wr[15], L);
  // Rows past the end of the batch compute on zeros and are never stored.
  for (int e = tid; e < L * R; e += NT) {
    const int l = e / R, r = e % R, row = row0 + r;
    const float z = row < B ? z0[size_t(row) * L + l] : 0.f;
    zc[l * R + r] = z;
    x[l * R + r] = z;
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
    layer<R, RP>(w1, b1, x, a1t, tw ? L : D, H, j0, r0);
    __syncthreads();

    // 2. x's context rows are read: the next step's start to arrive. Layer 2.
    if (s + 1 < n)
      prefetch_step<NT, R>(s + 1, x, nz + ((s + 1) & 1) * L * R, ctx,
                           a.ctx_idx, noise, row0, B, L, C, a.T);
    layer<R, RP>(w2, b2, a1t, a2t, H, H, j0, r0);
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
          acc = fmaf(softplus(fmaf(z, gw1[k], gb1[k])), gw2[k], acc);
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
      x[o] = zn;
      if (row < B) zs[(size_t(s) * B + row) * L + l] = zn;
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
template <int NT, int R>
int launch_rows(const Args<float>& a, int K, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.L, a.C, a.H, R);
  cudaError_t err = cudaFuncSetAttribute(
      latent_fused_fwd_kernel<NT, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.B + R - 1) / R, K);
  latent_fused_fwd_kernel<NT, R><<<grid, NT, smem, stream>>>(a);
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

int launch(const Args<float>& a, int K, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K <= 0 || a.B <= 0 || a.n <= 0) return 0;
  if (rows_for(K, a.B, a.L, a.C, a.H, device) == 2 * TB)
    return launch_rows<FWD_THREADS, 2 * TB>(a, K, stream);
  return launch_rows<FWD_THREADS, TB>(a, K, stream);
}

// ---------------------------------------------------------------------------
// The forward in bf16 mixed mode, on tensor cores (latent_fwd_bf16).
//
// The JAX package's _forward_core in mixed mode: the products' inputs are
// rounded to bf16 and the products summed in float32, at x = [z | ctx] (z
// rounded; zc, the carried state, float32), each tower's two hidden
// activations, and the g nets' scalar z_l and hidden activations; the
// biases, softplus, sigmoid, u, the KL integrand, the update and qs are
// float32, zs goes out in bf16.
//
// Design. The weights of layers 1 and 2 stay bf16 in shared memory as
// [input][unit] rows laid out for ldmatrix (tsde_bf16::ldsm_offset: 16-byte
// chunks, swizzled), 84 KB at the flagship against the float kernel's 176,
// so two blocks fit an SM. Layers 1 and 2 of both towers run on
// mma.m16n8k16 with the weight, read transposed, as the 16-row A operand
// and the block's rows as n = 8 B operands (the reverse sweep's products,
// mma_bf16.cuh: warp_mma); a k-tile past a weight's rows reads a zero row.
// x is [row][k] bf16 with z's L columns padded to 8 (tsde_bf16::fwd_x_col)
// so that a step's context row lands on 16 bytes: it arrives by 16-byte
// cp.async, a step ahead, as the noise does in 8 or 16-byte copies (plain
// loads where the widths do not allow them). Layer 1's output is rounded,
// two values at a time (cvt.rn.bf16x2), and transposed by movmatrix into
// the [row][unit] layout layer 2 reads as its B operand; layer 2's output
// is rounded and transposed the same way but stays in the warp's
// registers as layer 3's B operand: layer 3 (L outputs, padded to 16 by
// the zero row) is one mma an m-tile of units, and the m-tiles' sums are
// added over the tower in order. The g nets (L x H softplus a
// row) run on FMAs in BF16_NPG parts of the units, their weights bf16 in
// shared memory, a thread a part of one output for RG rows at once (RG
// independent chains). Three barriers a step:
//   A. layer 1 of both towers; the g nets' parts;
//   B. the next step's context rows and noise start to arrive; layer 2 and
//      layer 3's m-tile products;
//   C. a thread an output: f, h, g, u, the update, zs, u^2 (the row's KL
//      increment is added at the next step's A).
// No row's sum depends on the rows a block, the threads or the block count
// (a row's n-tile, an m-tile's units and the parts of a sum are fixed by
// the widths), so replicas are bitwise single solves and the launch picks
// its block by the grid (bf16_design).
//
// What bounds it. The products take 0.047 ms of the bf16 peak at K = 4.
// With 8 or 16 warps an SM the step's chains of dependent instructions
// set its pace: the products' fragments and their epilogues, the 4H + LH
// softplus a row and step (each an exp and a log1p, some forty
// instructions) and three barriers (chip_smoke.py --only tiles reads the
// stages' clocks; PERF.md).

constexpr int BF16_NPG = 16;            // parts of the g nets' sums

// Its stage clocks (latent_fused_common.cuh: TSDE_MARK), for measurement
// only: A's layer 1 (thread 0's own), A's g nets to the barrier, B, C.
#ifdef TSDE_STAGE_CLOCKS
__device__ unsigned long long tsde_stage_clocks[8];
#endif

// Byte offsets of the bf16 forward's shared memory, each on 16 bytes.
struct FwdBf16Layout {
  size_t fw1, fw2, hw1, hw2, zero, w3, b1, b2, b3, gw, gb2, x, nz, zc,
      act1, red, usq, total;
  int mt;   // m-tiles of a tower (16 units each)
  int hp;   // H padded to 16
  int wc;   // 16-byte chunks of a weight row (tsde_bf16::ldsm_chunks)
  int as;   // row stride of the [tower][row][unit] activations (bf16)
  int xs;   // row stride of x (bf16)
  int xk;   // columns of x (and rows of f's staged W1): z padded, then ctx
  int ld;   // row stride of the g nets' bf16 weights
};

__host__ __device__ inline FwdBf16Layout make_fwd_bf16_layout(int L, int C,
                                                             int H, int R) {
  using tsde_bf16::take_bytes;
  FwdBf16Layout s;
  size_t at = 0;
  const size_t h = H, l = L;
  s.hp = tsde_bf16::pad16(H);
  s.mt = s.hp / 16;
  s.wc = tsde_bf16::ldsm_chunks(H);
  s.as = s.hp + 8;
  s.xk = tsde_bf16::fwd_x_col(L + C, L);
  s.xs = tsde_bf16::pad16(s.xk) + 8;
  s.ld = row_stride(H);
  const size_t row = size_t(s.wc) * 16;   // bytes of a weight row
  const size_t hp = s.hp;
  s.fw1 = take_bytes(at, size_t(s.xk) * row);  // [x column][unit] bf16
  s.fw2 = take_bytes(at, h * row);
  s.hw1 = take_bytes(at, l * row);
  s.hw2 = take_bytes(at, h * row);
  s.zero = take_bytes(at, 16);                 // the zero row
  s.w3 = take_bytes(at, 2 * l * row);          // [tower][l][unit] bf16
  s.b1 = take_bytes(at, 2 * hp * 4);           // [tower][unit] float
  s.b2 = take_bytes(at, 2 * hp * 4);
  s.b3 = take_bytes(at, 2 * l * 4);
  s.gw = take_bytes(at, 3 * l * s.ld * 2);     // g's w1, b1, w2 [l][k]
  s.gb2 = take_bytes(at, l * 4);
  s.x = take_bytes(at, size_t(R) * s.xs * 2);  // [r][x column] bf16
  s.nz = take_bytes(at, 2 * size_t(R) * l * 2);   // [buffer][r][l] bf16
  s.zc = take_bytes(at, l * R * 4);            // [l][r]: the carried state
  s.act1 = take_bytes(at, 2 * size_t(R) * s.as * 2);  // [tower][r][unit]
  s.red = take_bytes(at, (2 * size_t(s.mt) + BF16_NPG) * l * R * 4);
  s.usq = take_bytes(at, l * R * 4);
  s.total = at;
  return s;
}

// The largest of 16, 8 and 4 bytes that a row of `cols` bf16 (row stride
// the same in global memory, `dstride` in shared memory) and the two base
// addresses allow a cp.async to move, or 0 (element by element).
__device__ __forceinline__ int copy_bytes(const void* src, const void* dst,
                                          int cols, int dstride) {
  const unsigned bits = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
      unsigned(cols * 2) | unsigned(dstride * 2));
  return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : 0;
}

// Asynchronous copy of `bytes` (4, 8 or 16) into shared memory;
// zero-fills when !valid (src must still be a valid address).
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes, bool valid) {
  const unsigned d = tsde_bf16::smem_addr(dst);
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}

// R rows (from row0; past B zero) of `cols` bf16 of a (B, cols) slab into
// shared memory rows of stride `dstride`, by cp.async where copy_bytes
// allows (they land by the wait after the caller's commit), else by plain
// loads.
template <int NT, int R>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int dstride,
                                           const __nv_bfloat16* src,
                                           int cols, int row0, int B) {
  const int cb = copy_bytes(src, dst, cols, dstride);
  if (cb) {
    const int per = cb / 2, chunks = cols / per;
    for (int e = threadIdx.x; e < R * chunks; e += NT) {
      const int r = e / chunks, c = (e % chunks) * per, row = row0 + r;
      const bool valid = row < B;
      cp_async_n(dst + r * dstride + c,
                 valid ? src + size_t(row) * cols + c : src, cb, valid);
    }
  } else {
    for (int e = threadIdx.x; e < R * cols; e += NT) {
      const int r = e / cols, c = e % cols, row = row0 + r;
      dst[r * dstride + c] = row < B ? src[size_t(row) * cols + c]
                                     : __ushort_as_bfloat16(0);
    }
  }
}

// A weight (rows, H) bf16 into its ldmatrix layout (`wc` chunks a row;
// units past H zero), stored row k at dst row map(k); 16-byte cp.async
// chunks where H and the address allow (committed by the caller).
template <int NT, typename Map>
__device__ __forceinline__ void stage_weight(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             int rows, int H, int wc,
                                             Map map) {
  using tsde_bf16::ldsm_offset;
  if (H % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int per = H / 8;
    for (int e = threadIdx.x; e < rows * wc; e += NT) {
      const int k = e / wc, c = e % wc;
      __nv_bfloat16* d = dst + ldsm_offset(map(k), 8 * c, wc);
      if (c < per)
        cp_async_n(d, src + size_t(k) * H + 8 * c, 16, true);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = threadIdx.x; e < rows * wc * 8; e += NT) {
      const int k = e / (wc * 8), j = e % (wc * 8);
      dst[ldsm_offset(map(k), j, wc)] =
          j < H ? src[size_t(k) * H + j] : __ushort_as_bfloat16(0);
    }
  }
}

// NT threads (two towers of NT / 64 warps), R rows a block (R / 8 n-tiles),
// MPW m-tiles a warp at most, MINB blocks an SM for ptxas's register
// budget.
template <int NT, int R, int MPW, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    latent_fwd_bf16(const Args<__nv_bfloat16> a) {
  using namespace tsde_bf16;
  using bf = __nv_bfloat16;
  constexpr int NTT = NT / 2, NWT = NTT / 32, NR = R / 8;
  // Rows a g-net item takes (an item a thread at L = 4).
  constexpr int RG = BF16_NPG * 4 * R / NT < 1 ? 1
                     : BF16_NPG * 4 * R / NT > R ? R
                                                 : BF16_NPG * 4 * R / NT;
  static_assert(R % 8 == 0 && NT % 64 == 0, "rows in n-tiles, two towers");
  extern __shared__ __align__(16) unsigned char smb[];
  const int L = a.L, C = a.C, H = a.H, B = a.B, D = L + C, n = a.n;
  const FwdBf16Layout lay = make_fwd_bf16_layout(L, C, H, R);
  const int MT = lay.mt, WC = lay.wc, AS = lay.as, XS = lay.xs;
  const int XK = lay.xk, LD = lay.ld, LP = fwd_x_col(L, L);
  const int tid = threadIdx.x, lane = tid & 31;
  const int tw = tid / NTT, tt = tid % NTT, wt = tt / 32;
  const int row0 = blockIdx.x * R;
  const int O = L * R;                   // per-row outputs of a kind
  const int kleng = (H + BF16_NPG - 1) / BF16_NPG;

  // This block's replica.
  const size_t rep = replica(), steps = size_t(n) * B * L;
  const float* z0 = a.z0 + rep * B * L;
  const bf* ctx = a.ctx + rep * a.T * B * C;
  const bf* noise = a.noise + rep * steps;
  bf* zs = a.zs + rep * steps;
  float* qs = a.qs + rep * n * B;
  size_t wsize[NW];
  weight_sizes(L, C, H, wsize);
  const bf* wr[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) wr[i] = a.w[i] + rep * wsize[i];

  bf* fw1 = reinterpret_cast<bf*>(smb + lay.fw1);
  bf* fw2 = reinterpret_cast<bf*>(smb + lay.fw2);
  bf* hw1 = reinterpret_cast<bf*>(smb + lay.hw1);
  bf* hw2 = reinterpret_cast<bf*>(smb + lay.hw2);
  bf* zero = reinterpret_cast<bf*>(smb + lay.zero);
  bf* w3s = reinterpret_cast<bf*>(smb + lay.w3);
  float* b1s = reinterpret_cast<float*>(smb + lay.b1);
  float* b2s = reinterpret_cast<float*>(smb + lay.b2);
  float* b3s = reinterpret_cast<float*>(smb + lay.b3);
  bf* gws = reinterpret_cast<bf*>(smb + lay.gw);
  float* gb2 = reinterpret_cast<float*>(smb + lay.gb2);
  bf* x = reinterpret_cast<bf*>(smb + lay.x);
  bf* nz = reinterpret_cast<bf*>(smb + lay.nz);
  float* zc = reinterpret_cast<float*>(smb + lay.zc);
  bf* act1 = reinterpret_cast<bf*>(smb + lay.act1);
  float* red = reinterpret_cast<float*>(smb + lay.red);
  float* redg = red + 2 * MT * O;        // the g nets' parts [p][l][r]
  float* usq = reinterpret_cast<float*>(smb + lay.usq);

  // The weights, once for the whole solve: W1 and W2 of both towers as
  // [input][unit] bf16 (f's W1 rows at x's columns, the padding zero), W3
  // as [l][unit] bf16 (layer 3's A operand), the biases as float, the g
  // nets' w1, b1 and w2 as bf16 [3][l][k].
  const bf zb = __ushort_as_bfloat16(0);
  stage_weight<NT>(fw1, wr[0], D, H, WC,
                   [L](int k) { return fwd_x_col(k, L); });
  stage_weight<NT>(fw2, wr[2], H, H, WC, [](int k) { return k; });
  stage_weight<NT>(hw1, wr[6], L, H, WC, [](int k) { return k; });
  stage_weight<NT>(hw2, wr[8], H, H, WC, [](int k) { return k; });
  for (int e = tid; e < (LP - L) * WC * 8; e += NT)
    fw1[(L * WC * 8) + e] = zb;          // the z padding's rows
  for (int e = tid; e < 8; e += NT) zero[e] = zb;
  for (int e = tid; e < 2 * L * WC * 8; e += NT) {  // (H, L) -> [l][unit]
    const int t = e / (L * WC * 8), l = (e / (WC * 8)) % L, j = e % (WC * 8);
    w3s[t * L * WC * 8 + ldsm_offset(l, j, WC)] =
        j < H ? wr[t ? 10 : 4][j * L + l] : zb;
  }
  for (int e = tid; e < 2 * lay.hp; e += NT) {
    const int t = e / lay.hp, j = e % lay.hp;
    b1s[e] = j < H ? to_f(wr[t ? 7 : 1][j]) : 0.f;
    b2s[e] = j < H ? to_f(wr[t ? 9 : 3][j]) : 0.f;
  }
  for (int e = tid; e < 2 * L; e += NT)
    b3s[e] = to_f(wr[e < L ? 5 : 11][e % L]);
  for (int e = tid; e < 3 * L * H; e += NT) {      // (L,1,H), (L,H), (L,H,1)
    const int m = e / (L * H), l = (e / H) % L, k = e % H;
    gws[(m * L + l) * LD + k] = wr[12 + m][l * H + k];
  }
  for (int e = tid; e < L; e += NT) gb2[e] = to_f(wr[15][e]);
  // x: z rounded, zeros past it and past the context; the first step's
  // context rows and noise. Rows past the batch compute on zeros and are
  // never stored.
  for (int e = tid; e < R * XS; e += NT) {
    const int r = e / XS, k = e % XS;
    if (k >= L && (k < LP || k >= XK)) x[e] = zb;
    if (k < L) {
      const float z = row0 + r < B ? z0[size_t(row0 + r) * L + k] : 0.f;
      zc[k * R + r] = z;
      x[e] = __float2bfloat16_rn(z);
    }
  }
  int ci = min(max(__ldg(a.ctx_idx), 0), a.T - 1);
  stage_rows<NT, R>(x + LP, XS, ctx + size_t(ci) * B * C, C, row0, B);
  stage_rows<NT, R>(nz, L, noise, L, row0, B);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // This thread's tower and the warp's m-tiles of it: wt, wt + NWT, ...
  const bf* w1t = tw ? hw1 : fw1;
  const bf* w2t = tw ? hw2 : fw2;
  const int kin = tw ? L : XK;
  const float* b1t = b1s + tw * lay.hp;
  const float* b2t = b2s + tw * lay.hp;
  const bf* w3t = w3s + tw * L * WC * 8;
  bf* act1t = act1 + tw * R * AS;
  float* redt = red + tw * MT * O;       // the tower's m-tiles' sums
  int m0[MPW];
#pragma unroll
  for (int i = 0; i < MPW; ++i) m0[i] = 16 * (wt + i * NWT);
  const int nmt = min(MPW, max(0, (MT - wt + NWT - 1) / NWT));
  float q = 0.f;                         // row `tid`'s KL sum, tid < R
  float dt_prev = 0.f;

#ifdef TSDE_STAGE_CLOCKS
  long long mark = clock64();
#endif
  for (int s = 0; s < n; ++s) {
    const float dt = __ldg(a.dts + s);
    const int ci_next =
        s + 1 < n ? min(max(__ldg(a.ctx_idx + s + 1), 0), a.T - 1) : 0;
    // The KL increment of the step before, in the order of l.
    if (s > 0 && tid < R) {
      float usum = 0.f;
      for (int l = 0; l < L; ++l) usum += usq[l * R + tid];
      q = fmaf(0.5f * usum, dt_prev, q);
      if (row0 + tid < B) qs[size_t(s - 1) * B + row0 + tid] = q;
    }

    // A. Layer 1 of the tower on the warp's m-tiles, rounded into act1;
    // the g nets' parts: item e = (part p, output l, rows g RG ..).
    {
      float acc[MPW][NR][4] = {};
      warp_mma<MPW, NR, true>(acc, w1t, WC, kin, zero, m0, nmt, kin, x, XS,
                              lane);
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
        if (i >= nmt) break;
#pragma unroll
        for (int nt = 0; nt < NR; ++nt) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = m0[i] + d_row(lane, e);
            v[e] = j < H ? softplus(acc[i][nt][e] + b1t[j]) : 0.f;
          }
          uint32_t pk[2];
          put_tile(act1t, AS, m0[i], nt, v, pk, lane);
        }
      }
    }
    TSDE_MARK(0);
    for (int e = tid; e < BF16_NPG * L * (R / RG); e += NT) {
      const int g = e % (R / RG), l = (e / (R / RG)) % L;
      const int p = e / ((R / RG) * L);
      float z[RG], acc[RG];
#pragma unroll
      for (int j = 0; j < RG; ++j) {
        z[j] = __bfloat162float(x[(g * RG + j) * XS + l]);
        acc[j] = 0.f;
      }
      const bf* g1 = gws + l * LD;
      const bf* gb1 = g1 + L * LD;
      const bf* g2 = gb1 + L * LD;
      const int k1 = min(H, (p + 1) * kleng);
#pragma unroll 4
      for (int k = p * kleng; k < k1; ++k) {
        const float w1 = __bfloat162float(g1[k]);
        const float b1 = __bfloat162float(gb1[k]);
        const float w2 = __bfloat162float(g2[k]);
#pragma unroll
        for (int j = 0; j < RG; ++j)
          acc[j] = fmaf(rnd<bf>(softplus(fmaf(z[j], w1, b1))), w2, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < RG; ++j) redg[(p * L + l) * R + g * RG + j] = acc[j];
    }
    __syncthreads();
    TSDE_MARK(1);

    // B. x's context rows and the noise of the step before are read: the
    // next step's start to arrive. Layer 2, and layer 3 on each m-tile of
    // its output.
    if (s + 1 < n) {
      stage_rows<NT, R>(x + LP, XS, ctx + size_t(ci_next) * B * C, C, row0,
                        B);
      stage_rows<NT, R>(nz + ((s + 1) & 1) * R * L, L,
                        noise + size_t(s + 1) * B * L, L, row0, B);
      cp_async_commit();
    }
    {
      float acc[MPW][NR][4] = {};
      warp_mma<MPW, NR, true>(acc, w2t, WC, H, zero, m0, nmt, H, act1t, AS,
                              lane);
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
        if (i >= nmt) break;
#pragma unroll
        for (int nt = 0; nt < NR; ++nt) {
          // a2 rounded and transposed into layer 3's B operand, the
          // m-tile's 16 units its k.
          uint32_t b[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = m0[i] + d_row(lane, 2 * h + e);
              v[e] = j < H ? softplus(acc[i][nt][2 * h + e] + b2t[j]) : 0.f;
            }
            b[h] = transpose(pack(v[0], v[1]));
          }
          // Layer 3 over the m-tile's units, 16 outputs a product.
          for (int l0 = 0; l0 < L; l0 += 16) {
            uint32_t af[4];
            a_frag(af, w3t, WC, L, zero, l0, m0[i], false, lane);
            float d[4] = {};
            mma(d, af, b[0], b[1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int l = l0 + d_row(lane, e);
              if (l < L)
                redt[(m0[i] / 16) * O + l * R + 8 * nt + d_col(lane, e)] =
                    d[e];
            }
          }
        }
      }
    }
    __syncthreads();
    TSDE_MARK(2);

    // C. A thread an output: f, h, g, u from the sums in order, the state
    // update; u^2 for the row's KL sum.
    const bf* nzb = nz + (s & 1) * R * L;
    for (int o = tid; o < O; o += NT) {
      const int l = o / R, r = o % R, row = row0 + r;
      float pf = 0.f, ph = 0.f, pg = 0.f;
      for (int m = 0; m < MT; ++m) {
        pf += red[m * O + o];
        ph += red[(MT + m) * O + o];
      }
#pragma unroll
      for (int p = 0; p < BF16_NPG; ++p) pg += redg[p * O + o];
      const float f = pf + b3s[l];
      const float h = ph + b3s[L + l];
      const float g = sigmoid(pg + gb2[l]);
      const float gs = g > EPS ? g : EPS;
      const float u = (f - h) / gs;
      usq[o] = u * u;
      const float zn =
          fmaf(g, __bfloat162float(nzb[r * L + l]), fmaf(f, dt, zc[o]));
      zc[o] = zn;
      const bf zr = __float2bfloat16_rn(zn);
      x[r * XS + l] = zr;
      if (row < B) zs[(size_t(s) * B + row) * L + l] = zr;
    }
    dt_prev = dt;
    cp_async_wait_all();
    __syncthreads();
    TSDE_MARK(3);
  }
  if (tid < R && n > 0) {
    float usum = 0.f;
    for (int l = 0; l < L; ++l) usum += usq[l * R + tid];
    q = fmaf(0.5f * usum, dt_prev, q);
    if (row0 + tid < B) qs[size_t(n - 1) * B + row0 + tid] = q;
  }
}

// The bf16 forward's block for K replicas of B rows: rows, threads and the
// blocks an SM ptxas budgets registers for. Where the 8-row grid fits the
// SMs (kernel 1), 8 rows at 512 threads; where the 16-row one does, 16
// rows at 512; else 16 rows at 256 threads, two blocks an SM (kernel 3 at
// K = 4: one wave of 256 blocks). Every block gives the same bits.
struct Bf16Design {
  int rows, threads, minb;
};

inline Bf16Design bf16_design(int K, int B, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
      != cudaSuccess)
    sms = 1;
  if (long(K) * ((B + TB - 1) / TB) <= sms) return {TB, 512, 1};
  if (long(K) * ((B + 2 * TB - 1) / (2 * TB)) <= sms) return {2 * TB, 512, 1};
  return {2 * TB, 256, 2};
}

template <int NT, int R, int MPW, int MINB>
int launch_bf16_mpw(const Args<__nv_bfloat16>& a, int K, cudaStream_t stream,
                    bool query) {
  auto kernel = latent_fwd_bf16<NT, R, MPW, MINB>;
  const size_t smem = make_fwd_bf16_layout(a.L, a.C, a.H, R).total;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return query ? -static_cast<int>(err)
                                       : static_cast<int>(err);
  if (query) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NT,
                                                        smem);
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
  }
  const dim3 grid((a.B + R - 1) / R, K);
  kernel<<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 forward at NT threads, R rows a block and registers for MINB
// blocks an SM, with MPW by H: a warp takes one or two of its tower's
// m-tiles, or four (wider towers) with registers for one block an SM;
// `query`: blocks an SM instead of a launch.
template <int NT, int R, int MINB>
int launch_bf16_rows(const Args<__nv_bfloat16>& a, int K, cudaStream_t stream,
                     bool query = false) {
  const int mt = tsde_bf16::pad16(a.H) / 16, nwt = NT / 64;
  if (mt <= nwt) return launch_bf16_mpw<NT, R, 1, MINB>(a, K, stream, query);
  if (mt <= 2 * nwt)
    return launch_bf16_mpw<NT, R, 2, MINB>(a, K, stream, query);
  if (mt <= 4 * nwt)
    return launch_bf16_mpw<NT, R, 4, 1>(a, K, stream, query);
  return query ? -static_cast<int>(cudaErrorInvalidValue)
               : static_cast<int>(cudaErrorInvalidValue);
}

int launch_bf16(const Args<__nv_bfloat16>& a, int K, int device,
                cudaStream_t stream, bool query = false) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!query && (K <= 0 || a.B <= 0 || a.n <= 0)) return 0;
  const Bf16Design d = bf16_design(K, a.B, device);
  if (d.threads == 256)
    return launch_bf16_rows<256, 2 * TB, 2>(a, K, stream, query);
  if (d.rows == 2 * TB)
    return launch_bf16_rows<512, 2 * TB, 1>(a, K, stream, query);
  return launch_bf16_rows<512, TB, 1>(a, K, stream, query);
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
  return launch_bf16(
      make_args(z0, ctx, ctx_idx, noise, dts, w, zs, qs, B, L, C, H, T, n),
      1, device, stream);
}

int tsde_latent_fused_fwd_multi_bf16(
    const float* z0, const __nv_bfloat16* ctx, const int* ctx_idx,
    const __nv_bfloat16* noise, const float* dts,
    TSDE_WEIGHT_PARAMS_T(__nv_bfloat16), __nv_bfloat16* zs, float* qs, int K,
    int B, int L, int C, int H, int T, int n, int device,
    cudaStream_t stream) {
  using namespace tsde_latent_fwd;
  const __nv_bfloat16* w[NW] = TSDE_WEIGHTS;
  return launch_bf16(
      make_args(z0, ctx, ctx_idx, noise, dts, w, zs, qs, B, L, C, H, T, n),
      K, device, stream);
}

// The bf16 forward's dynamic shared memory a block at 8 rows, and the
// blocks of it an SM holds for K replicas of B rows at the launch's
// choice of rows and registers (negative: a CUDA error).
size_t tsde_latent_fused_fwd_smem_bytes_bf16(int L, int C, int H) {
  using namespace tsde_latent_fwd;
  return make_fwd_bf16_layout(L, C, H, tsde_latent::TB).total;
}

int tsde_latent_fused_fwd_blocks_per_sm_bf16(int K, int B, int L, int C,
                                             int H, int device) {
  using namespace tsde_latent_fwd;
  Args<__nv_bfloat16> a{};
  a.B = B;
  a.L = L;
  a.C = C;
  a.H = H;
  return launch_bf16(a, K, device, 0, true);
}

}  // extern "C"
