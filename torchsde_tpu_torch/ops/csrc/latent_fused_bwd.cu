// Reverse sweep of the latent-SDE logqp Euler-Maruyama whole solve, for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/latent_fused.py:_bwd_kernel
// (with _backward_core), launched by _fused_solve_bwd_impl. For each step s
// from the last to the first, with z the pre-step state (z0 or zs[s-1]) and
// ginc the reverse cumulative sum of the logqp cotangents gq:
//   recompute f, h, g, u from z as latent_fused_fwd.cu does;
//   dz += gz[s];  dnoise[s] = dz * g;  du = ginc * u * dt
//   df = dz * dt + du / gs;  dh = -du / gs
//   dg = dz * dW - (du * u / gs) * [g > 1e-7]   (only the u-path is masked)
// then backpropagate df, dh through the two softplus towers and dg through
// the per-dimension sigmoid nets (softplus' = 1 - exp(-softplus)), add every
// weight gradient, scatter the context cotangent into dctx[ctx_idx[s]], and
// carry dz += dx[:, :L] to the step before.
//
// What bounds it. Per batch row and step it recomputes the forward (44,032
// multiply-adds at L=4, C=64, H=128) and does two products of the same size
// per layer going back (the weight gradient and the input cotangent):
// 132,096 multiply-adds, 34.6 GFLOP for a solve at B=1024 and 128 steps.
// Its inputs and outputs are about 26 MB, so it is bound by arithmetic and by
// the step-to-step dependency of dz, as the forward is.
//
// Design. Rows interact only through the weight gradients. The batch is cut
// into tiles of TB rows, one block each (128 blocks at B=1024: one wave on 132
// SMs), and each block sweeps the steps backwards with no grid-wide sync. The
// weights (45,068 floats at the flagship) live in shared memory, which then
// has no room for their f32 gradient accumulators too; so each block adds
// its rows' contributions of every step into a private partial in device
// memory (blocks x 45,068 floats, 23 MB at the flagship, L2-resident), each
// element always by the same thread, and a second kernel sums the partials
// over blocks in a fixed order. No atomics: the gradients are bitwise the
// same from call to call. dctx is written straight into the zeroed (T,B,C)
// output: only the block that owns a row touches it, in step order.
//
// Layouts. Matrices indexed [in][hidden] are kept with an odd row stride
// (H | 1), so both the forward product (threads over the hidden unit) and
// the input-cotangent product (threads over the input row) read shared
// memory without bank conflicts. Activations are [unit][row], so a thread
// reads a unit's TB rows as two float4s, broadcast to the warp. Contractions
// to the L outputs (layer 3, the g nets) are summed by warp shuffles and
// then over the block's warps. Plain f32 FMAs, no fast math; tensor cores
// are later work.
//
// K stacked replicas (tsde_latent_fused_bwd_multi) replace the Pallas
// kernel _bwd_kernel_multi (launched by _fused_solve_multi_bwd_impl). The
// replica is the grid's y axis, as in the forward: each block sweeps one
// replica's tile, its partial row sits at (replica, block), and the
// reduction sums each replica's own blocks in block order, so replica k's
// gradients are bitwise those of a single sweep on its inputs. The partials
// total K x 23 MB at the flagship, but only the resident blocks' rows
// (132 of them, 24 MB) are live at a time.

#include <cuda_runtime.h>
#include <stddef.h>

#include "latent_fused_common.cuh"

namespace {

using namespace tsde_latent;

constexpr int NT = 128;          // threads per block
constexpr int NWARPS = NT / 32;

__host__ __device__ inline int row_stride(int H) { return H | 1; }

struct Layout {
  size_t fw1, fb1, fw2, fb2, fw3t, fb3;
  size_t hw1, hb1, hw2, hb2, hw3t, hb3;
  size_t gw1, gb1, gw2, gb2;
  size_t x, a1f, a1h, a2f, a2h, red, dl, dz;
  size_t total;
};

__host__ __device__ inline Layout make_layout(int L, int C, int H) {
  Layout s;
  size_t at = 0;
  const size_t D = size_t(L) + C, h = H, l = L, ld = row_stride(H);
  s.fw1 = take(at, D * ld);  s.fb1 = take(at, h);   // [k][j], stride ld
  s.fw2 = take(at, h * ld);  s.fb2 = take(at, h);
  s.fw3t = take(at, l * ld); s.fb3 = take(at, l);   // W3 stored as [l][k]
  s.hw1 = take(at, l * ld);  s.hb1 = take(at, h);
  s.hw2 = take(at, h * ld);  s.hb2 = take(at, h);
  s.hw3t = take(at, l * ld); s.hb3 = take(at, l);
  s.gw1 = take(at, l * h);   s.gb1 = take(at, l * h);   // [l][k]
  s.gw2 = take(at, l * h);   s.gb2 = take(at, l);
  s.x = take(at, D * TB);            // [k][r]: rows k < L are z, then ctx
  s.a1f = take(at, h * TB);          // [j][r]; later dpre1 of f
  s.a1h = take(at, h * TB);
  s.a2f = take(at, h * TB);          // [j][r]; later dpre2 of f
  s.a2h = take(at, h * TB);
  s.red = take(at, size_t(NWARPS) * 3 * l * TB);  // [warp][kind][l][r]
  s.dl = take(at, 3 * l * TB);       // [kind][l][r]: df, dh, dpre2 of g
  s.dz = take(at, l * TB);           // [l][r]: the carried dz
  s.total = at;
  return s;
}

struct Args {
  const float* z0;       // ([K,] B, L)
  const float* ctx;      // ([K,] T, B, C)
  const int* ctx_idx;    // (n,), shared by the replicas
  const float* noise;    // ([K,] n, B, L)
  const float* dts;      // (n,), shared by the replicas
  const float* w[NW];    // each ([K,] ...)
  const float* zs;       // ([K,] n, B, L): post-step states from the forward
  const float* gz;       // ([K,] n, B, L)
  const float* gq;       // ([K,] n, B, 1)
  float* dz0;            // ([K,] B, L)
  float* dctx;           // ([K,] T, B, C), zeroed by the caller
  float* dnoise;         // ([K,] n, B, L)
  float* partials;       // ([K,] blocks, P)
  size_t off[NW];        // offset of each weight's gradient in a partial
  size_t P;
  int B, L, C, H, T, n;
};

// Adds v to element i of a block's partial; the sweep's first step stores
// instead, so the buffer needs no zeroing.
__device__ __forceinline__ void accum(float* p, size_t i, float v,
                                      bool first) {
  p[i] = first ? v : p[i] + v;
}

// Sums each of the TB values over the warp's lanes.
__device__ __forceinline__ void warp_sum(float (&v)[TB]) {
#pragma unroll
  for (int r = 0; r < TB; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[r] += __shfl_xor_sync(0xffffffffu, v[r], off);
  }
}

__device__ __forceinline__ void load_rows(float (&v)[TB], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// (rows, cols) row-major into shared memory with row stride ld.
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows, int cols, int ld) {
  for (int e = threadIdx.x; e < rows * cols; e += NT)
    dst[(e / cols) * ld + e % cols] = src[e];
}

__global__ void __launch_bounds__(NT) latent_fused_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, C = a.C, H = a.H, B = a.B, D = L + C;
  const int ld = row_stride(H);
  const Layout lay = make_layout(L, C, H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TB;

  // This block's replica.
  const size_t rep = replica(), steps = size_t(a.n) * B * L;
  const float* z0 = a.z0 + rep * B * L;
  const float* ctx = a.ctx + rep * a.T * B * C;
  const float* noise = a.noise + rep * steps;
  const float* zs = a.zs + rep * steps;
  const float* gz = a.gz + rep * steps;
  const float* gq = a.gq + rep * a.n * B;
  float* dz0 = a.dz0 + rep * B * L;
  float* dctx = a.dctx + rep * a.T * B * C;
  float* dnoise = a.dnoise + rep * steps;
  size_t wsize[NW];
  weight_sizes(L, C, H, wsize);
  const float* wr[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) wr[i] = a.w[i] + rep * wsize[i];

  copy_rows(sm + lay.fw1, wr[0], D, H, ld);
  copy_to_smem<NT>(sm + lay.fb1, wr[1], H);
  copy_rows(sm + lay.fw2, wr[2], H, H, ld);
  copy_to_smem<NT>(sm + lay.fb2, wr[3], H);
  copy_to_smem<NT>(sm + lay.fb3, wr[5], L);
  copy_rows(sm + lay.hw1, wr[6], L, H, ld);
  copy_to_smem<NT>(sm + lay.hb1, wr[7], H);
  copy_rows(sm + lay.hw2, wr[8], H, H, ld);
  copy_to_smem<NT>(sm + lay.hb2, wr[9], H);
  copy_to_smem<NT>(sm + lay.hb3, wr[11], L);
  for (int e = tid; e < H * L; e += NT) {      // (H, L) -> [l][k]
    const int k = e / L, l = e % L;
    sm[lay.fw3t + l * ld + k] = wr[4][e];
    sm[lay.hw3t + l * ld + k] = wr[10][e];
  }
  copy_to_smem<NT>(sm + lay.gw1, wr[12], L * H);  // (L,1,H) as [l][k]
  copy_to_smem<NT>(sm + lay.gb1, wr[13], L * H);
  copy_to_smem<NT>(sm + lay.gw2, wr[14], L * H);  // (L,H,1) as [l][k]
  copy_to_smem<NT>(sm + lay.gb2, wr[15], L);

  const float* fw1 = sm + lay.fw1;
  const float* fb1 = sm + lay.fb1;
  const float* fw2 = sm + lay.fw2;
  const float* fb2 = sm + lay.fb2;
  const float* fw3t = sm + lay.fw3t;
  const float* fb3 = sm + lay.fb3;
  const float* hw1 = sm + lay.hw1;
  const float* hb1 = sm + lay.hb1;
  const float* hw2 = sm + lay.hw2;
  const float* hb2 = sm + lay.hb2;
  const float* hw3t = sm + lay.hw3t;
  const float* hb3 = sm + lay.hb3;
  const float* gw1 = sm + lay.gw1;
  const float* gb1 = sm + lay.gb1;
  const float* gw2 = sm + lay.gw2;
  const float* gb2 = sm + lay.gb2;
  float* x = sm + lay.x;
  float* a1f = sm + lay.a1f;
  float* a1h = sm + lay.a1h;
  float* a2f = sm + lay.a2f;
  float* a2h = sm + lay.a2h;
  float* red = sm + lay.red;
  float* dl = sm + lay.dl;
  float* dzs = sm + lay.dz;

  float* part = a.partials + (rep * gridDim.x + blockIdx.x) * a.P;
  float* pw[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) pw[i] = part + a.off[i];

  for (int e = tid; e < L * TB; e += NT) dzs[e] = 0.f;
  float ginc = 0.f;                            // row `tid` for tid < TB
  __syncthreads();

  for (int s = a.n - 1; s >= 0; --s) {
    const bool first = s == a.n - 1;

    // A. x = [pre-step z | this step's context rows]. Rows past the end of
    // the batch compute on zeros, get zero cotangents and are never stored.
    const float* zpre = s == 0 ? z0 : zs + size_t(s - 1) * B * L;
    const int ci = min(max(a.ctx_idx[s], 0), a.T - 1);
    const float* cstep = ctx + size_t(ci) * B * C;
    for (int e = tid; e < TB * D; e += NT) {
      const int r = e / D, k = e % D, row = row0 + r;
      float v = 0.f;
      if (row < B)
        v = k < L ? zpre[size_t(row) * L + k] : cstep[size_t(row) * C + k - L];
      x[k * TB + r] = v;
    }
    __syncthreads();

    // B. Layer 1 of f (input x) and h (input z); the g nets' output sums.
    for (int j = tid; j < H; j += NT) {
      float af[TB], ah[TB], xv[TB];
#pragma unroll
      for (int r = 0; r < TB; ++r) af[r] = ah[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        const float w = fw1[k * ld + j];
        load_rows(xv, x + k * TB);
#pragma unroll
        for (int r = 0; r < TB; ++r) af[r] = fmaf(xv[r], w, af[r]);
      }
      for (int k = 0; k < L; ++k) {
        const float w = hw1[k * ld + j];
        load_rows(xv, x + k * TB);
#pragma unroll
        for (int r = 0; r < TB; ++r) ah[r] = fmaf(xv[r], w, ah[r]);
      }
      const float bf = fb1[j], bh = hb1[j];
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        a1f[j * TB + r] = softplus(af[r] + bf);
        a1h[j * TB + r] = softplus(ah[r] + bh);
      }
    }
    for (int l = 0; l < L; ++l) {
      float t[TB], zv[TB];
#pragma unroll
      for (int r = 0; r < TB; ++r) t[r] = 0.f;
      load_rows(zv, x + l * TB);
      for (int k = tid; k < H; k += NT) {
        const float w1 = gw1[l * H + k], b1 = gb1[l * H + k];
        const float w2 = gw2[l * H + k];
#pragma unroll
        for (int r = 0; r < TB; ++r)
          t[r] = fmaf(softplus(zv[r] * w1 + b1), w2, t[r]);
      }
      warp_sum(t);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < TB; ++r)
          red[((warp * 3 + 2) * L + l) * TB + r] = t[r];
      }
    }
    __syncthreads();

    // C. Layer 2 of both towers.
    for (int j = tid; j < H; j += NT) {
      float af[TB], ah[TB], vf[TB], vh[TB];
#pragma unroll
      for (int r = 0; r < TB; ++r) af[r] = ah[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float wf = fw2[k * ld + j], wh = hw2[k * ld + j];
        load_rows(vf, a1f + k * TB);
        load_rows(vh, a1h + k * TB);
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          af[r] = fmaf(vf[r], wf, af[r]);
          ah[r] = fmaf(vh[r], wh, ah[r]);
        }
      }
      const float bf = fb2[j], bh = hb2[j];
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        a2f[j * TB + r] = softplus(af[r] + bf);
        a2h[j * TB + r] = softplus(ah[r] + bh);
      }
    }
    __syncthreads();

    // D. Layer 3 of both towers, as per-warp sums.
    for (int l = 0; l < L; ++l) {
      float tf[TB], th[TB], vf[TB], vh[TB];
#pragma unroll
      for (int r = 0; r < TB; ++r) tf[r] = th[r] = 0.f;
      for (int k = tid; k < H; k += NT) {
        const float wf = fw3t[l * ld + k], wh = hw3t[l * ld + k];
        load_rows(vf, a2f + k * TB);
        load_rows(vh, a2h + k * TB);
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          tf[r] = fmaf(vf[r], wf, tf[r]);
          th[r] = fmaf(vh[r], wh, th[r]);
        }
      }
      warp_sum(tf);
      warp_sum(th);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          red[((warp * 3 + 0) * L + l) * TB + r] = tf[r];
          red[((warp * 3 + 1) * L + l) * TB + r] = th[r];
        }
      }
    }
    __syncthreads();

    // E. Per row: the step's f, h, g, u and the cotangents of f, h and of
    // g's pre-activation; dnoise; the carried dz takes gz.
    if (tid < TB) {
      const int r = tid, row = row0 + r;
      const bool valid = row < B;
      const float dt = a.dts[s];
      if (valid) ginc += gq[size_t(s) * B + row];
      for (int l = 0; l < L; ++l) {
        float pf = 0.f, ph = 0.f, pg = 0.f;
        for (int w = 0; w < NWARPS; ++w) {
          pf += red[((w * 3 + 0) * L + l) * TB + r];
          ph += red[((w * 3 + 1) * L + l) * TB + r];
          pg += red[((w * 3 + 2) * L + l) * TB + r];
        }
        const float f = pf + fb3[l];
        const float h = ph + hb3[l];
        const float g = sigmoid(pg + gb2[l]);
        const bool big = g > EPS;
        const float gs = big ? g : EPS;
        const float u = (f - h) / gs;
        const size_t at = (size_t(s) * B + row) * L + l;
        const float dz = dzs[l * TB + r] + (valid ? gz[at] : 0.f);
        const float dW = valid ? noise[at] : 0.f;
        if (valid) dnoise[at] = dz * g;
        const float du = ginc * u * dt;
        const float df = dz * dt + du / gs;
        const float dh = -du / gs;
        const float dg = dz * dW - (big ? du * u / gs : 0.f);
        dl[(0 * L + l) * TB + r] = df;
        dl[(1 * L + l) * TB + r] = dh;
        dl[(2 * L + l) * TB + r] = dg * g * (1.f - g);
        dzs[l * TB + r] = dz;
      }
    }
    __syncthreads();

    // F. Layer 3 back to dpre2 of f and h (in place over a2), their W3 and
    // b3; the g nets' whole backward, with their z-cotangent as warp sums.
    for (int k = tid; k < H; k += NT) {
      float vf[TB], vh[TB], daf[TB], dah[TB];
      load_rows(vf, a2f + k * TB);
      load_rows(vh, a2h + k * TB);
#pragma unroll
      for (int r = 0; r < TB; ++r) daf[r] = dah[r] = 0.f;
      for (int l = 0; l < L; ++l) {
        const float wf = fw3t[l * ld + k], wh = hw3t[l * ld + k];
        float sf = 0.f, sh = 0.f;
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          const float df = dl[(0 * L + l) * TB + r];
          const float dh = dl[(1 * L + l) * TB + r];
          daf[r] = fmaf(df, wf, daf[r]);
          dah[r] = fmaf(dh, wh, dah[r]);
          sf = fmaf(vf[r], df, sf);
          sh = fmaf(vh[r], dh, sh);
        }
        accum(pw[4], size_t(k) * L + l, sf, first);
        accum(pw[10], size_t(k) * L + l, sh, first);
      }
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        a2f[k * TB + r] = daf[r] * (1.f - expf(-vf[r]));
        a2h[k * TB + r] = dah[r] * (1.f - expf(-vh[r]));
      }
    }
    for (int l = tid; l < L; l += NT) {
      float sf = 0.f, sh = 0.f, sg = 0.f;
      for (int r = 0; r < TB; ++r) {
        sf += dl[(0 * L + l) * TB + r];
        sh += dl[(1 * L + l) * TB + r];
        sg += dl[(2 * L + l) * TB + r];
      }
      accum(pw[5], l, sf, first);
      accum(pw[11], l, sh, first);
      accum(pw[15], l, sg, first);
    }
    for (int l = 0; l < L; ++l) {
      float tz[TB], zv[TB], d2[TB];
#pragma unroll
      for (int r = 0; r < TB; ++r) tz[r] = 0.f;
      load_rows(zv, x + l * TB);
      load_rows(d2, dl + (2 * L + l) * TB);
      for (int k = tid; k < H; k += NT) {
        const size_t i = size_t(l) * H + k;
        const float w1 = gw1[i], b1 = gb1[i], w2 = gw2[i];
        float sw2 = 0.f, sw1 = 0.f, sb1 = 0.f;
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          const float act = softplus(zv[r] * w1 + b1);
          sw2 = fmaf(act, d2[r], sw2);
          const float dp1 = d2[r] * w2 * (1.f - expf(-act));
          sw1 = fmaf(dp1, zv[r], sw1);
          sb1 += dp1;
          tz[r] = fmaf(dp1, w1, tz[r]);
        }
        accum(pw[12], i, sw1, first);
        accum(pw[13], i, sb1, first);
        accum(pw[14], i, sw2, first);
      }
      warp_sum(tz);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < TB; ++r)
          red[((warp * 3 + 0) * L + l) * TB + r] = tz[r];
      }
    }
    __syncthreads();

    // G1. W2 and b2 of both towers: thread j owns column j.
    for (int j = tid; j < H; j += NT) {
      float pf[TB], ph[TB], vf[TB], vh[TB];
      load_rows(pf, a2f + j * TB);
      load_rows(ph, a2h + j * TB);
      float bf = 0.f, bh = 0.f;
#pragma unroll
      for (int r = 0; r < TB; ++r) { bf += pf[r]; bh += ph[r]; }
      accum(pw[3], j, bf, first);
      accum(pw[9], j, bh, first);
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        load_rows(vf, a1f + k * TB);
        load_rows(vh, a1h + k * TB);
        float sf = 0.f, sh = 0.f;
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          sf = fmaf(vf[r], pf[r], sf);
          sh = fmaf(vh[r], ph[r], sh);
        }
        accum(pw[2], size_t(k) * H + j, sf, first);
        accum(pw[8], size_t(k) * H + j, sh, first);
      }
    }
    __syncthreads();

    // G2. dpre1 = (dpre2 W2^T) * softplus'(a1), in place over a1: thread k
    // owns row k of W2.
    for (int k = tid; k < H; k += NT) {
      float daf[TB], dah[TB], vf[TB], vh[TB];
#pragma unroll
      for (int r = 0; r < TB; ++r) daf[r] = dah[r] = 0.f;
#pragma unroll 4
      for (int j = 0; j < H; ++j) {
        const float wf = fw2[k * ld + j], wh = hw2[k * ld + j];
        load_rows(vf, a2f + j * TB);
        load_rows(vh, a2h + j * TB);
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          daf[r] = fmaf(vf[r], wf, daf[r]);
          dah[r] = fmaf(vh[r], wh, dah[r]);
        }
      }
      load_rows(vf, a1f + k * TB);
      load_rows(vh, a1h + k * TB);
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        a1f[k * TB + r] = daf[r] * (1.f - expf(-vf[r]));
        a1h[k * TB + r] = dah[r] * (1.f - expf(-vh[r]));
      }
    }
    __syncthreads();

    // H. W1 and b1 of both towers (thread j owns column j), then the input
    // cotangent dx (thread k owns input row k): its z part joins the carried
    // dz with the g nets' sums, its context part goes to dctx[ctx_idx[s]].
    for (int j = tid; j < H; j += NT) {
      float qf[TB], qh[TB], xv[TB];
      load_rows(qf, a1f + j * TB);
      load_rows(qh, a1h + j * TB);
      float bf = 0.f, bh = 0.f;
#pragma unroll
      for (int r = 0; r < TB; ++r) { bf += qf[r]; bh += qh[r]; }
      accum(pw[1], j, bf, first);
      accum(pw[7], j, bh, first);
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        load_rows(xv, x + k * TB);
        float sf = 0.f;
#pragma unroll
        for (int r = 0; r < TB; ++r) sf = fmaf(xv[r], qf[r], sf);
        accum(pw[0], size_t(k) * H + j, sf, first);
      }
      for (int k = 0; k < L; ++k) {
        load_rows(xv, x + k * TB);
        float sh = 0.f;
#pragma unroll
        for (int r = 0; r < TB; ++r) sh = fmaf(xv[r], qh[r], sh);
        accum(pw[6], size_t(k) * H + j, sh, first);
      }
    }
    for (int k = tid; k < D; k += NT) {
      float dx[TB], v[TB];
#pragma unroll
      for (int r = 0; r < TB; ++r) dx[r] = 0.f;
#pragma unroll 4
      for (int j = 0; j < H; ++j) {
        const float w = fw1[k * ld + j];
        load_rows(v, a1f + j * TB);
#pragma unroll
        for (int r = 0; r < TB; ++r) dx[r] = fmaf(v[r], w, dx[r]);
      }
      if (k < L) {
        for (int j = 0; j < H; ++j) {
          const float w = hw1[k * ld + j];
          load_rows(v, a1h + j * TB);
#pragma unroll
          for (int r = 0; r < TB; ++r) dx[r] = fmaf(v[r], w, dx[r]);
        }
        for (int w = 0; w < NWARPS; ++w) {
#pragma unroll
          for (int r = 0; r < TB; ++r)
            dx[r] += red[((w * 3 + 0) * L + k) * TB + r];
        }
#pragma unroll
        for (int r = 0; r < TB; ++r) dzs[k * TB + r] += dx[r];
      } else {
        for (int r = 0; r < TB; ++r) {
          const int row = row0 + r;
          if (row < B) dctx[(size_t(ci) * B + row) * C + k - L] += dx[r];
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < TB * L; e += NT) {
    const int r = e / L, l = e % L, row = row0 + r;
    if (row < B) dz0[size_t(row) * L + l] = dzs[l * TB + r];
  }
}

// out[e] = sum over blocks of partials[b][e], in block order; replica
// blockIdx.y sums its own blocks' partials into its own row of out.
__global__ void latent_fused_bwd_reduce(const float* partials, int blocks,
                                        size_t P, float* out) {
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= P) return;
  partials += replica() * blocks * P;
  out += replica() * P;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partials[size_t(b) * P + e];
  out[e] = acc;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the sweep needs for these widths.
size_t tsde_latent_fused_bwd_smem_bytes(int L, int C, int H) {
  return make_layout(L, C, H).total * sizeof(float);
}

// Blocks of the sweep for a batch of B rows: the partial buffer holds one
// row of all weight gradients for each.
int tsde_latent_fused_bwd_blocks(int B) {
  return (B + tsde_latent::TB - 1) / tsde_latent::TB;
}

}  // extern "C"

namespace {

// Launches the sweeps of K stacked solves (K = 1: a single solve) and the
// reduction on `stream`; returns cudaGetLastError() (0 on success).
int launch(Args a, int K, float* dw, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K <= 0 || a.B <= 0 || a.n <= 0) return 0;
  size_t sizes[NW];
  weight_sizes(a.L, a.C, a.H, sizes);
  size_t P = 0;
  for (int i = 0; i < NW; ++i) {
    a.off[i] = P;
    P += sizes[i];
  }
  a.P = P;
  const size_t smem = tsde_latent_fused_bwd_smem_bytes(a.L, a.C, a.H);
  err = cudaFuncSetAttribute(latent_fused_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = tsde_latent_fused_bwd_blocks(a.B);
  latent_fused_bwd_kernel<<<dim3(blocks, K), NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int RT = 256;
  const dim3 grid(static_cast<unsigned>((P + RT - 1) / RT), K);
  latent_fused_bwd_reduce<<<grid, RT, 0, stream>>>(a.partials, blocks, P, dw);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* z0, const float* ctx, const int* ctx_idx,
               const float* noise, const float* dts, const float* const* w,
               const float* zs, const float* gz, const float* gq, float* dz0,
               float* dctx, float* dnoise, float* partials, int B, int L,
               int C, int H, int T, int n) {
  Args a;
  a.z0 = z0; a.ctx = ctx; a.ctx_idx = ctx_idx; a.noise = noise; a.dts = dts;
  for (int i = 0; i < NW; ++i) a.w[i] = w[i];
  a.zs = zs; a.gz = gz; a.gq = gq;
  a.dz0 = dz0; a.dctx = dctx; a.dnoise = dnoise; a.partials = partials;
  a.B = B; a.L = L; a.C = C; a.H = H; a.T = T; a.n = n;
  return a;
}

}  // namespace

extern "C" {

// Launches the sweep and the reduction on `stream` and returns
// cudaGetLastError() (0 on success). All pointers are device pointers to
// contiguous float32 arrays, ctx_idx int32; weights in the order of
// latent_fused.WEIGHT_NAMES. dctx must be zeroed; partials holds
// tsde_latent_fused_bwd_blocks(B) x P floats and dw P floats, P the
// weights' total element count; dw receives their gradients back to back.
int tsde_latent_fused_bwd(
    const float* z0, const float* ctx, const int* ctx_idx, const float* noise,
    const float* dts, TSDE_WEIGHT_PARAMS, const float* zs, const float* gz,
    const float* gq, float* dz0, float* dctx, float* dnoise, float* partials,
    float* dw, int B, int L, int C, int H, int T, int n, int device,
    cudaStream_t stream) {
  const float* w[NW] = TSDE_WEIGHTS;
  return launch(make_args(z0, ctx, ctx_idx, noise, dts, w, zs, gz, gq, dz0,
                          dctx, dnoise, partials, B, L, C, H, T, n),
                1, dw, device, stream);
}

// The same for K stacked replicas in one launch: every per-replica array
// has a leading K axis (see tsde_latent_fused_fwd_multi), partials holds
// K x tsde_latent_fused_bwd_blocks(B) x P floats and dw K x P: each
// replica's weight gradients, summed over its own blocks in block order.
int tsde_latent_fused_bwd_multi(
    const float* z0, const float* ctx, const int* ctx_idx, const float* noise,
    const float* dts, TSDE_WEIGHT_PARAMS, const float* zs, const float* gz,
    const float* gq, float* dz0, float* dctx, float* dnoise, float* partials,
    float* dw, int K, int B, int L, int C, int H, int T, int n, int device,
    cudaStream_t stream) {
  const float* w[NW] = TSDE_WEIGHTS;
  return launch(make_args(z0, ctx, ctx_idx, noise, dts, w, zs, gz, gq, dz0,
                          dctx, dnoise, partials, B, L, C, H, T, n),
                K, dw, device, stream);
}

}  // extern "C"
