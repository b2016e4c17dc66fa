"""The bf16 tensor-core index arithmetic of kernels 1-4, on the host.

``csrc/mma_bf16.cuh`` keeps the arithmetic of the bf16 sweep and
contraction (which row each lane of a warp names to ldmatrix, which
elements of a fragment or an accumulator it holds, where a transposed tile
goes) as plain host-and-device functions. Here the host C++ compiler builds
them against stand-ins for the CUDA headers, beside a warp emulated over 32
lanes as the PTX ISA lays out ldmatrix (.trans), mma.m16n8k16 .bf16 and
movmatrix.trans, and the sweep's, the contraction's and the forward's
products, addressed as the kernels address them, are held to numpy on
bf16-rounded inputs. A copy of the header with two fragment rows swapped,
or with the forward's context columns shifted, must fail.

``csrc/gan_bwd_bf16.cuh`` does the same for the bf16 reverse sweeps of the
SDE-GAN (kernels 6 and 8): a tower's step for a warp of 8 rows (layers 1
and 2, the hidden cotangent, dz and the weights' gradients on m16n8k16 and
m16n8k8, the weights staged as the kernels stage them), at the reference
widths and the widest, against numpy on the emulated step's own bf16
roundings; a copy with a swapped fragment row or a shifted weight column
must fail."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

CSRC = Path(__file__).resolve().parents[1] / "torchsde_tpu_torch" / "ops" \
    / "csrc"

CUDA_STUB = """#pragma once
#define __host__
#define __device__
"""

# The warp, emulated from the PTX ISA's layouts (not from the header), and
# the kernels' products addressed through the header's functions.
EMULATOR = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#include "mma_bf16.cuh"
#include "gan_bwd_bf16.cuh"
using namespace tsde_bf16;
using namespace tsde_gan_bf16;

static float bf(uint16_t b) {
  uint32_t u = (uint32_t)b << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
static uint16_t rn(float f) {          // round to nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

// ldmatrix.x4 (.trans): lanes 8m..8m+7 give matrix m's row offsets (-1: a
// zero row); lane t receives of matrix m row t/4, columns 2(t%4), +1 (of
// the transposed matrix with .trans) in register m, the first the low half.
static void ldsm(const uint16_t* src, const int* off, bool trans,
                 uint32_t r[32][4]) {
  for (int m = 0; m < 4; ++m) {
    uint16_t M[8][8];
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j)
        M[i][j] = off[8 * m + i] < 0 ? 0 : src[off[8 * m + i] + j];
    for (int t = 0; t < 32; ++t) {
      const int i = t / 4, j = 2 * (t % 4);
      const uint16_t lo = trans ? M[j][i] : M[i][j];
      const uint16_t hi = trans ? M[j + 1][i] : M[i][j + 1];
      r[t][m] = (uint32_t)lo | ((uint32_t)hi << 16);
    }
  }
}

// mma.m16n8k16.row.col.f32.bf16.bf16.f32: A register i of lane 4g+q holds
// A[g + 8(i%2)][2q + 8(i/2) + {0,1}], B register i B[2q + 8i + {0,1}][g],
// d[i] is D[g + 8(i/2)][2q + i%2]; D += A B in float32, k in order.
static void mma(float d[32][4], uint32_t a[32][4], uint32_t b[32][2]) {
  float A[16][16], B[16][8];
  for (int t = 0; t < 32; ++t) {
    const int g = t / 4, q = t % 4;
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i % 2), col = 2 * q + 8 * (i / 2);
      A[row][col] = bf(a[t][i] & 0xffff);
      A[row][col + 1] = bf(a[t][i] >> 16);
    }
    for (int i = 0; i < 2; ++i) {
      B[2 * q + 8 * i][g] = bf(b[t][i] & 0xffff);
      B[2 * q + 8 * i + 1][g] = bf(b[t][i] >> 16);
    }
  }
  for (int t = 0; t < 32; ++t) {
    const int g = t / 4, q = t % 4;
    for (int i = 0; i < 4; ++i) {
      float s = 0.f;
      for (int k = 0; k < 16; ++k)
        s += A[g + 8 * (i / 2)][k] * B[k][2 * q + i % 2];
      d[t][i] += s;
    }
  }
}

// movmatrix.m8n8.trans.b16: lane t holds row t/4, columns 2(t%4), +1.
static void movm(const uint32_t in[32], uint32_t out[32]) {
  uint16_t M[8][8];
  for (int t = 0; t < 32; ++t) {
    M[t / 4][2 * (t % 4)] = in[t] & 0xffff;
    M[t / 4][2 * (t % 4) + 1] = in[t] >> 16;
  }
  for (int t = 0; t < 32; ++t) {
    const int i = t / 4, j = 2 * (t % 4);
    out[t] = (uint32_t)M[j][i] | ((uint32_t)M[j + 1][i] << 16);
  }
}

// A weight w (rows x H, row-major) staged as the sweep stages it.
static void stage(const uint16_t* w, int rows, int H, uint16_t* s) {
  const int chunks = ldsm_chunks(H);
  memset(s, 0, sizeof(uint16_t) * rows * chunks * 8);
  for (int k = 0; k < rows; ++k)
    for (int j = 0; j < H; ++j) s[ldsm_offset(k, j, chunks)] = w[k * H + j];
}

// One warp's products of the sweep over a staged weight: `trans` the
// forward (out[unit][r] = sum_k w[k][unit] src[r][k], the units' m-tiles
// over k-tiles of `rows` inputs), else going back (out[k][r] = sum_unit
// w[k][unit] src[r][unit], the inputs' m-tiles over the units' k-tiles);
// src [R][stride] bf16, out float [MT 16][R].
extern "C" void sweep_product(const uint16_t* w, int rows, int H, int trans,
                              const uint16_t* src, int stride, int R,
                              float* out, uint16_t* stored, int sstride) {
  const int chunks = ldsm_chunks(H), HP = pad16(H);
  static uint16_t s[1 << 20];
  stage(w, rows, H, s);
  const int M = trans ? HP : pad16(rows), K = trans ? rows : HP;
  for (int m0 = 0; m0 < M; m0 += 16) {
    for (int nt = 0; nt < R / 8; ++nt) {
      float d[32][4] = {};
      for (int k0 = 0; k0 < K; k0 += 16) {
        int off[32];
        uint32_t a[32][4], b[32][2];
        for (int t = 0; t < 32; ++t)
          off[t] = trans ? a_tile_offset(t, k0, m0, true, chunks, rows)
                         : a_tile_offset(t, m0, k0, false, chunks, rows);
        ldsm(s, off, trans != 0, a);
        for (int t = 0; t < 32; ++t)
          for (int i = 0; i < 2; ++i) {
            uint32_t word;
            memcpy(&word, src + b_offset(t, nt, k0, stride, i), 4);
            b[t][i] = word;
          }
        mma(d, a, b);
      }
      for (int t = 0; t < 32; ++t)
        for (int i = 0; i < 4; ++i)
          out[(m0 + d_row(t, i)) * R + nt * 8 + d_col(t, i)] = d[t][i];
      // The tile rounded, packed and transposed into stored [R][sstride].
      for (int h = 0; h < 2; ++h) {
        uint32_t pk[32], tr[32];
        for (int t = 0; t < 32; ++t)
          pk[t] = rn(d[t][2 * h]) | ((uint32_t)rn(d[t][2 * h + 1]) << 16);
        movm(pk, tr);
        for (int t = 0; t < 32; ++t)
          memcpy(stored + t_offset(t, nt, m0, sstride, h), &tr[t], 4);
      }
    }
  }
}

static float softplus_(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// A warp's product of the bf16 forward (latent_fused_fwd.cu:
// latent_fwd_bf16) over a weight staged as the kernel stages it (`wrows`
// stored rows, `kin` of them read), for the m-tile at m0 and n-tile nt:
// acc = W^T src, src [R][stride] bf16.
static void forward_tile(const uint16_t* s, int wrows, int kin, int chunks,
                         int m0, int nt, const uint16_t* src, int stride,
                         float d[32][4]) {
  memset(d, 0, sizeof(float) * 32 * 4);
  for (int k0 = 0; k0 < kin; k0 += 16) {
    int off[32];
    uint32_t a[32][4], b[32][2];
    for (int t = 0; t < 32; ++t)
      off[t] = a_tile_offset(t, k0, m0, true, chunks, wrows);
    ldsm(s, off, true, a);
    for (int t = 0; t < 32; ++t)
      for (int i = 0; i < 2; ++i)
        memcpy(&b[t][i], src + b_offset(t, nt, k0, stride, i), 4);
    mma(d, a, b);
  }
}

// The drift tower f of the bf16 forward for one block of R rows, its
// products addressed as the kernel addresses them: x = [z | ctx] (R x D
// bf16) laid out at fwd_x_col's columns; W1 (D x H) staged at the same
// rows, the padding's rows zero; layer 1 rounded and transposed into act1;
// layer 2 rounded and transposed into layer 3's B operand in the lanes;
// layer 3 one product an m-tile, added over the m-tiles in order. f [L][R]
// float.
extern "C" void forward_f(const uint16_t* w1, const float* b1,
                          const uint16_t* w2, const float* b2,
                          const float* w3, const uint16_t* xin, int L,
                          int C, int H, int R, float* f) {
  const int D = L + C, chunks = ldsm_chunks(H), HP = pad16(H);
  const int XK = fwd_x_col(D, L), XS = pad16(XK) + 8, AS = HP + 8;
  static uint16_t s1[1 << 18], s2[1 << 18], x[1 << 14], act1[1 << 16];
  memset(s1, 0, sizeof s1);
  memset(s2, 0, sizeof s2);
  memset(x, 0, sizeof x);
  for (int k = 0; k < D; ++k)
    for (int j = 0; j < H; ++j)
      s1[ldsm_offset(fwd_x_col(k, L), j, chunks)] = w1[k * H + j];
  for (int k = 0; k < H; ++k)
    for (int j = 0; j < H; ++j) s2[ldsm_offset(k, j, chunks)] = w2[k * H + j];
  for (int r = 0; r < R; ++r)
    for (int k = 0; k < D; ++k) x[r * XS + fwd_x_col(k, L)] = xin[r * D + k];
  // Layer 1, each m-tile rounded and transposed into act1 [R][AS].
  for (int m0 = 0; m0 < HP; m0 += 16)
    for (int nt = 0; nt < R / 8; ++nt) {
      float d[32][4];
      forward_tile(s1, XK, XK, chunks, m0, nt, x, XS, d);
      for (int h = 0; h < 2; ++h) {
        uint32_t pk[32], tr[32];
        for (int t = 0; t < 32; ++t) {
          float v[2];
          for (int e = 0; e < 2; ++e) {
            const int j = m0 + d_row(t, 2 * h + e);
            v[e] = j < H ? softplus_(d[t][2 * h + e] + b1[j]) : 0.f;
          }
          pk[t] = rn(v[0]) | ((uint32_t)rn(v[1]) << 16);
        }
        movm(pk, tr);
        for (int t = 0; t < 32; ++t)
          memcpy(act1 + t_offset(t, nt, m0, AS, h), &tr[t], 4);
      }
    }
  // W3 (H x L) as [l][unit] rows, layer 3's A operand.
  static uint16_t s3[1 << 14];
  memset(s3, 0, sizeof s3);
  for (int l = 0; l < L; ++l)
    for (int j = 0; j < H; ++j)
      s3[ldsm_offset(l, j, chunks)] = rn(w3[j * L + l]);
  // Layer 2 and layer 3, m-tile by m-tile: layer 2's tile rounded and
  // transposed in the lanes into layer 3's B operand, one product of 16
  // outputs an m-tile (rows past L the zero row).
  for (int i = 0; i < L * R; ++i) f[i] = 0.f;
  for (int m0 = 0; m0 < HP; m0 += 16) {
    float part[64][64] = {};            // [l][r] of this m-tile
    for (int nt = 0; nt < R / 8; ++nt) {
      float d[32][4];
      forward_tile(s2, H, H, chunks, m0, nt, act1, AS, d);
      uint32_t b[32][2];
      for (int h = 0; h < 2; ++h) {
        uint32_t pk[32], tr[32];
        for (int t = 0; t < 32; ++t) {
          float v[2];
          for (int e = 0; e < 2; ++e) {
            const int j = m0 + d_row(t, 2 * h + e);
            v[e] = j < H ? softplus_(d[t][2 * h + e] + b2[j]) : 0.f;
          }
          pk[t] = rn(v[0]) | ((uint32_t)rn(v[1]) << 16);
        }
        movm(pk, tr);
        for (int t = 0; t < 32; ++t) b[t][h] = tr[t];
      }
      for (int l0 = 0; l0 < L; l0 += 16) {
        int off[32];
        uint32_t a[32][4];
        for (int t = 0; t < 32; ++t)
          off[t] = a_tile_offset(t, l0, m0, false, chunks, L);
        ldsm(s3, off, false, a);
        float acc[32][4] = {};
        mma(acc, a, b);
        for (int t = 0; t < 32; ++t)
          for (int e = 0; e < 4; ++e) {
            const int l = l0 + d_row(t, e);
            if (l < L) part[l][8 * nt + d_col(t, e)] = acc[t][e];
          }
      }
    }
    for (int l = 0; l < L; ++l)
      for (int r = 0; r < R; ++r) f[l * R + r] += part[l][r];
  }
}

// One block's output tile of the contraction (8 warps of 32 x 32): out[i][j]
// = sum_m As[m][i] Bs[m][j] over KS rows of slabs As [KS][as], Bs [KS][bs].
extern "C" void contract_tile(const uint16_t* As, int as, const uint16_t* Bs,
                              int bs, int KS, float* out, int J) {
  for (int warp = 0; warp < 8; ++warp) {
    const int wi = 32 * (warp >> 2), wj = 32 * (warp & 3);
    float d[2][4][32][4] = {};
    for (int k0 = 0; k0 < KS; k0 += 16) {
      uint32_t a[2][32][4], bq[2][32][4];
      for (int mi = 0; mi < 2; ++mi) {
        int off[32];
        for (int t = 0; t < 32; ++t)
          off[t] = x4_offset(t, k0, wi + 16 * mi, as, kColsFirst);
        ldsm(As, off, true, a[mi]);
      }
      for (int np = 0; np < 2; ++np) {
        int off[32];
        for (int t = 0; t < 32; ++t)
          off[t] = x4_offset(t, k0, wj + 16 * np, bs, kRowsFirst);
        ldsm(Bs, off, true, bq[np]);
      }
      for (int mi = 0; mi < 2; ++mi)
        for (int ni = 0; ni < 4; ++ni) {
          uint32_t b[32][2];
          for (int t = 0; t < 32; ++t) {
            b[t][0] = bq[ni >> 1][t][2 * (ni & 1)];
            b[t][1] = bq[ni >> 1][t][2 * (ni & 1) + 1];
          }
          mma(d[mi][ni], a[mi], b);
        }
    }
    for (int mi = 0; mi < 2; ++mi)
      for (int ni = 0; ni < 4; ++ni)
        for (int t = 0; t < 32; ++t)
          for (int e = 0; e < 4; ++e)
            out[(wi + 16 * mi + d_row(t, e)) * J + wj + 8 * ni + d_col(t, e)]
                = d[mi][ni][t][e];
  }
}

// mma.m16n8k8 .bf16: a0 holds A[g][2q + {0,1}], a1 A[g + 8][2q + {0,1}],
// b B[2q + {0,1}][g]; d[i] is D[g + 8(i/2)][2q + i%2].
static void mma8(float d[32][4], uint32_t a[32][2], const uint32_t b[32]) {
  float A[16][8], B[8][8];
  for (int t = 0; t < 32; ++t) {
    const int g = t / 4, q = t % 4;
    for (int i = 0; i < 2; ++i) {
      A[g + 8 * i][2 * q] = bf(a[t][i] & 0xffff);
      A[g + 8 * i][2 * q + 1] = bf(a[t][i] >> 16);
    }
    B[2 * q][g] = bf(b[t] & 0xffff);
    B[2 * q + 1][g] = bf(b[t] >> 16);
  }
  for (int t = 0; t < 32; ++t) {
    const int g = t / 4, q = t % 4;
    for (int i = 0; i < 4; ++i) {
      float s = 0.f;
      for (int k = 0; k < 8; ++k)
        s += A[g + 8 * (i / 2)][k] * B[k][2 * q + i % 2];
      d[t][i] += s;
    }
  }
}

static float sigmoid_(float x) { return 1.f / (1.f + expf(-x)); }

// One tower's step of the bf16 GAN sweeps for a warp of 8 rows, as
// gan_bwd_bf16.cuh's tower_forward and tower_backward address it, in an
// instantiation of UT state, HT hidden and KC UT output tiles: the
// weights staged by tower_word (W1 (1+S) x M and W2 M x S kq, bf16 bits;
// b1, b2 float), z [8][S] bf16 bits, the outputs' cotangents dout [8][S
// kq]. Out, [row][...] as numpy has them: pre1 [8][M] (layer 1 with the
// time and the bias), a1r [8][M] and the outputs' pre-activation o [8][S
// kq], dpre2 [8][S kq] and its rounding, da [8][M], dpre1 [8][M] and its
// rounding, dz [8][S]; and the weights' gradients as one warp's partial
// (W1, b1, W2, b2 back to back).
extern "C" void gan_tower_step(const uint16_t* W1, const float* b1,
                               const uint16_t* W2, const float* b2, int S,
                               int M, int kq, int UT, int HT, int KC,
                               const uint16_t* z, float t1r,
                               const float* dout, float* pre1, uint16_t* a1r,
                               float* o, float* dpre2, uint16_t* dp2r,
                               float* da, float* dpre1, uint16_t* dp1r,
                               float* dz, float* part) {
  const int OT = KC * UT, U = 16 * UT, Sk = S * kq;
  static uint32_t frag[1 << 16];
  const int words = op_first(4, UT, HT, OT) * 128;
  for (int w = 0; w < words; ++w) {
    int src[2], w2;
    tower_word(w, UT, HT, OT, S, M, kq, src, &w2);
    const uint16_t* W = w2 ? W2 : W1;
    frag[w] = (src[0] < 0 ? 0u : W[src[0]])
              | ((uint32_t)(src[1] < 0 ? 0u : W[src[1]]) << 16);
  }
  auto tile = [&](int op, int t, uint32_t a[32][4]) {
    for (int l = 0; l < 32; ++l)
      for (int r = 0; r < 4; ++r)
        a[l][r] = frag[((op_first(op, UT, HT, OT) + t) * 32 + l) * 4 + r];
  };
  auto packed = [&](const float v[32][4], uint32_t pk[2][32]) {
    for (int l = 0; l < 32; ++l)
      for (int h = 0; h < 2; ++h)
        pk[h][l] = rn(v[l][2 * h]) | ((uint32_t)rn(v[l][2 * h + 1]) << 16);
  };
  // z's tiles in the lanes, packed, and transposed into layer 1's B.
  static float zv[4][32][4];
  static uint32_t zb[4][2][32], zt[4][2][32];
  for (int t = 0; t < UT; ++t) {
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < 4; ++i) {
        const int u = elem_unit(l, t, i), r = elem_row(l, i);
        zv[t][l][i] = u < S ? bf(z[r * S + u]) : 0.f;
      }
    packed(zv[t], zb[t]);
    for (int h = 0; h < 2; ++h) movm(zb[t][h], zt[t][h]);
  }
  // Layer 1 with lipswish, rounded into ab, transposed into layer 2's B.
  static uint32_t ab[2][2][32], at[2][2][32];
  static float sl1[2][32][4];
  for (int t = 0; t < HT; ++t) {
    float acc[32][4] = {};
    for (int k = 0; k < UT; ++k) {
      uint32_t a[32][4], b[32][2];
      tile(kLayer1, t * UT + k, a);
      for (int l = 0; l < 32; ++l) { b[l][0] = zt[k][0][l]; b[l][1] = zt[k][1][l]; }
      mma(acc, a, b);
    }
    float a1[32][4];
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < 4; ++i) {
        const int j = elem_unit(l, t, i), r = elem_row(l, i);
        const float x = acc[l][i] + (j < M ? t1r * bf(W1[j]) + b1[j] : 0.f);
        const float sg = sigmoid_(x);
        a1[l][i] = 0.909f * x * sg;
        sl1[t][l][i] = 0.909f * (sg + x * sg * (1.f - sg));
        if (j < M) pre1[r * M + j] = x;
      }
    packed(a1, ab[t]);
    for (int h = 0; h < 2; ++h) {
      movm(ab[t][h], at[t][h]);
      for (int l = 0; l < 32; ++l)
        for (int e = 0; e < 2; ++e) {
          const int j = 16 * t + 8 * h + l / 4, r = 2 * (l % 4) + e;
          if (j < M) a1r[r * M + j] = (ab[t][h][l] >> (16 * e)) & 0xffff;
        }
    }
  }
  // Layer 2 and the outputs' cotangents: dpre2 = dout (1 - tanh^2),
  // rounded into db (m16n8k8's A), transposed into dt (da's B).
  static uint32_t db[16][2][32], dt[16][2][32];
  static float g2[16][4][32][4], g1[2][8][32][4], gb2[16][32][4],
      gb1[2][32][4], gt[2][32][4];
  memset(g2, 0, sizeof g2);
  memset(g1, 0, sizeof g1);
  for (int t = 0; t < OT; ++t) {
    float acc[32][4] = {};
    for (int k = 0; k < HT; ++k) {
      uint32_t a[32][4], b[32][2];
      tile(kLayer2, t * HT + k, a);
      for (int l = 0; l < 32; ++l) { b[l][0] = at[k][0][l]; b[l][1] = at[k][1][l]; }
      mma(acc, a, b);
    }
    float dp[32][4];
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < 4; ++i) {
        const int c = out_col(elem_unit(l, t, i), U, S, kq);
        const int r = elem_row(l, i);
        const float x = acc[l][i] + (c >= 0 ? b2[c] : 0.f);
        const float F = tanhf(x);
        dp[l][i] = c >= 0 ? dout[r * Sk + c] * (1.f - F * F) : 0.f;
        gb2[t][l][i] = dp[l][i];
        if (c >= 0) {
          o[r * Sk + c] = x;
          dpre2[r * Sk + c] = dp[l][i];
        }
      }
    packed(dp, db[t]);
    for (int h = 0; h < 2; ++h) {
      movm(db[t][h], dt[t][h]);
      for (int l = 0; l < 32; ++l)
        for (int e = 0; e < 2; ++e) {
          const int c = out_col(16 * t + 8 * h + l / 4, U, S, kq);
          const int r = 2 * (l % 4) + e;
          if (c >= 0) dp2r[r * Sk + c] = (db[t][h][l] >> (16 * e)) & 0xffff;
        }
    }
    for (int k = 0; k < HT; ++k)
      for (int h = 0; h < 2; ++h) {
        uint32_t a[32][2];
        for (int l = 0; l < 32; ++l) { a[l][0] = db[t][0][l]; a[l][1] = db[t][1][l]; }
        mma8(g2[t][2 * k + h], a, ab[k][h]);
      }
  }
  // The hidden cotangent, dpre1 rounded into eb, dz, and dW1's sums.
  static uint32_t eb[2][2][32], et[2][2][32];
  for (int t = 0; t < HT; ++t) {
    float acc[32][4] = {};
    for (int k = 0; k < OT; ++k) {
      uint32_t a[32][4], b[32][2];
      tile(kHidden, t * OT + k, a);
      for (int l = 0; l < 32; ++l) { b[l][0] = dt[k][0][l]; b[l][1] = dt[k][1][l]; }
      mma(acc, a, b);
    }
    float dp[32][4];
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < 4; ++i) {
        const int j = elem_unit(l, t, i), r = elem_row(l, i);
        dp[l][i] = acc[l][i] * sl1[t][l][i];
        gb1[t][l][i] = dp[l][i];
        if (j < M) {
          da[r * M + j] = acc[l][i];
          dpre1[r * M + j] = dp[l][i];
        }
      }
    packed(dp, eb[t]);
    for (int h = 0; h < 2; ++h) {
      movm(eb[t][h], et[t][h]);
      for (int l = 0; l < 32; ++l)
        for (int e = 0; e < 2; ++e) {
          const int j = 16 * t + 8 * h + l / 4, r = 2 * (l % 4) + e;
          const uint16_t v = (eb[t][h][l] >> (16 * e)) & 0xffff;
          gt[t][l][2 * h + e] = t1r * bf(v);
          if (j < M) dp1r[r * M + j] = v;
        }
    }
    for (int k = 0; k < UT; ++k)
      for (int h = 0; h < 2; ++h) {
        uint32_t a[32][2];
        for (int l = 0; l < 32; ++l) { a[l][0] = eb[t][0][l]; a[l][1] = eb[t][1][l]; }
        mma8(g1[t][2 * k + h], a, zb[k][h]);
      }
  }
  for (int t = 0; t < UT; ++t) {
    float acc[32][4] = {};
    for (int k = 0; k < HT; ++k) {
      uint32_t a[32][4], b[32][2];
      tile(kInput, t * HT + k, a);
      for (int l = 0; l < 32; ++l) { b[l][0] = et[k][0][l]; b[l][1] = et[k][1][l]; }
      mma(acc, a, b);
    }
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < 4; ++i) {
        const int u = elem_unit(l, t, i), r = elem_row(l, i);
        if (u < S) dz[r * S + u] = acc[l][i];
      }
  }
  // The warp's partial, as write_tower_partial lays it out: the per-row
  // sums over a quad's lanes and a lane's two rows.
  float* pW1 = part;
  float* pb1 = pW1 + (1 + S) * M;
  float* pW2 = pb1 + M;
  float* pb2 = pW2 + M * Sk;
  for (int t = 0; t < HT; ++t)
    for (int l = 0; l < 32; l += 4)
      for (int h = 0; h < 2; ++h) {
        float st = 0.f, sb = 0.f;
        for (int q = 0; q < 4; ++q)
          for (int e = 0; e < 2; ++e) {
            st += gt[t][l + q][2 * h + e];
            sb += gb1[t][l + q][2 * h + e];
          }
        const int j = elem_unit(l, t, 2 * h);
        if (j < M) { pW1[j] = st; pb1[j] = sb; }
      }
  for (int t = 0; t < HT; ++t)
    for (int n = 0; n < 2 * UT; ++n)
      for (int l = 0; l < 32; ++l)
        for (int i = 0; i < 4; ++i) {
          const int j = elem_unit(l, t, i), k = 8 * n + elem_row(l, i);
          if (j < M && k < S) pW1[(1 + k) * M + j] = g1[t][n][l][i];
        }
  for (int t = 0; t < OT; ++t) {
    for (int l = 0; l < 32; l += 4)
      for (int h = 0; h < 2; ++h) {
        float sb = 0.f;
        for (int q = 0; q < 4; ++q)
          for (int e = 0; e < 2; ++e) sb += gb2[t][l + q][2 * h + e];
        const int c = out_col(elem_unit(l, t, 2 * h), U, S, kq);
        if (c >= 0) pb2[c] = sb;
      }
    for (int n = 0; n < 2 * HT; ++n)
      for (int l = 0; l < 32; ++l)
        for (int i = 0; i < 4; ++i) {
          const int c = out_col(elem_unit(l, t, i), U, S, kq);
          const int j = 8 * n + elem_row(l, i);
          if (c >= 0 && j < M) pW2[j * Sk + c] = g2[t][n][l][i];
        }
  }
}
"""


def _build(folder, header, gan_header=None):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "cuda_runtime.h").write_text(CUDA_STUB)
    (folder / "mma_bf16.cuh").write_text(header)
    (folder / "gan_bwd_bf16.cuh").write_text(
        gan_header or (CSRC / "gan_bwd_bf16.cuh").read_text())
    (folder / "emulator.cpp").write_text(EMULATOR)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-ffp-contract=off", f"-I{folder}", "-o",
                    str(folder / "emulator.so"),
                    str(folder / "emulator.cpp")], check=True)
    lib = ctypes.CDLL(str(folder / "emulator.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sweep_product.argtypes = [P, I, I, I, P, I, I, P, P, I]
    lib.contract_tile.argtypes = [P, I, P, I, I, P, I]
    lib.forward_f.argtypes = [P] * 6 + [I] * 4 + [P]
    lib.gan_tower_step.argtypes = ([P] * 4 + [I] * 6 + [P, ctypes.c_float]
                                   + [P] * 11)
    return lib


@pytest.fixture(scope="module")
def warp(tmp_path_factory):
    """The header's arithmetic with the emulated warp, built for the host;
    skipped where there is no host C++ compiler."""
    return _build(tmp_path_factory.mktemp("mma_bf16"),
                  (CSRC / "mma_bf16.cuh").read_text())


def _bf16_bits(a):
    """float32 values rounded to bf16 (to nearest even), as uint16 bits."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + 0x7fff + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _from_bits(b):
    return (b.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _sweep(warp, w, rows, H, trans, src, R):
    """The emulated product and the stored [R][HP + 8] tile it leaves."""
    HP = (H + 15) // 16 * 16
    M = HP if trans else (rows + 15) // 16 * 16
    out = np.zeros((M, R), np.float32)
    stored = np.zeros((R, M + 8), np.uint16)
    warp.sweep_product(_ptr(w), rows, H, int(trans), _ptr(src),
                       src.shape[1], R, _ptr(out), _ptr(stored), M + 8)
    return out, stored


def _inputs(rng, *shape, scale=1.0):
    return _bf16_bits(scale * rng.standard_normal(shape))


# The float32 sum of a product of bf16 values against numpy's float64:
# 1e-5 of the output's scale (at most 128 terms).
REL = 1e-5


def _check(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale)


@pytest.mark.parametrize("R", [8, 16])
@pytest.mark.parametrize("L,C,H", [(4, 64, 128), (3, 5, 40)],
                         ids=["flagship", "narrow"])
def test_sweep_products_on_the_emulated_warp(warp, L, C, H, R):
    """The sweep's three kinds of product, addressed as the kernel
    addresses them: W x (layer 1: x = [z | ctx], D = L + C inputs, read
    transposed, D = 68 padded to 80 at the flagship), W dpre (W2 going back:
    dpre2 W2^T, as stored) and dpre1 W1^T (the inputs' m-tiles past D read
    the zero row), against numpy; and the tiles rounded and transposed into
    the [row][unit] layout the next product reads."""
    rng = np.random.default_rng(H + R)
    D, HP = L + C, (H + 15) // 16 * 16
    w1, w2 = _inputs(rng, D, H, scale=0.3), _inputs(rng, H, H, scale=0.3)
    xs = (D + 15) // 16 * 16 + 8
    x = np.zeros((R, xs), np.uint16)
    x[:, :D] = _inputs(rng, R, D)
    dp = np.zeros((R, HP + 8), np.uint16)
    dp[:, :H] = _inputs(rng, R, H)

    got, stored = _sweep(warp, w1, D, H, True, x, R)
    want = _from_bits(w1).T @ _from_bits(x[:, :D]).T
    _check(got[:H], want)
    assert not got[H:].any()
    assert np.array_equal(stored[:, :HP], _bf16_bits(got.T))
    for w, rows in ((w2, H), (w1, D)):
        got, stored = _sweep(warp, w, rows, H, False, dp, R)
        want = _from_bits(w) @ _from_bits(dp[:, :H]).T
        _check(got[:rows], want)
        assert not got[rows:].any()
        assert np.array_equal(stored[:, :got.shape[0]], _bf16_bits(got.T))


def test_contraction_tile_on_the_emulated_warps(warp):
    """One 64 x 128 output tile of the contraction from a 32-row slab (A
    and Bm read transposed by ldmatrix, eight warps of 32 x 32): out = A^T
    Bm against numpy."""
    rng = np.random.default_rng(7)
    KS, TI, TJ = 32, 64, 128
    A = np.zeros((KS, TI + 8), np.uint16)
    Bm = np.zeros((KS, TJ + 8), np.uint16)
    A[:, :TI] = _inputs(rng, KS, TI)
    Bm[:, :TJ] = _inputs(rng, KS, TJ, scale=0.01)
    out = np.zeros((TI, TJ), np.float32)
    warp.contract_tile(_ptr(A), TI + 8, _ptr(Bm), TJ + 8, KS, _ptr(out), TJ)
    _check(out, _from_bits(A[:, :TI]).T @ _from_bits(Bm[:, :TJ]))


def test_swapped_fragment_rows_are_caught(tmp_path):
    """The header with the two 8-row halves of an accumulator swapped
    (d_row): the emulated products no longer match numpy, so the checks
    above would fail it."""
    header = (CSRC / "mma_bf16.cuh").read_text()
    right = "return (lane >> 2) + 8 * (i >> 1);"
    assert header.count(right) == 1
    bad = _build(tmp_path, header.replace(
        right, "return (lane >> 2) + 8 * (1 - (i >> 1));"))
    rng = np.random.default_rng(1)
    w = _inputs(rng, 68, 128, scale=0.3)
    x = np.zeros((8, 88), np.uint16)
    x[:, :68] = _inputs(rng, 8, 68)
    got, _ = _sweep(bad, w, 68, 128, True, x, 8)
    want = _from_bits(w).T @ _from_bits(x[:, :68]).T
    with pytest.raises(AssertionError):
        _check(got[:128], want)


def _softplus(v):
    return np.maximum(v, 0.0) + np.log1p(np.exp(-np.abs(v)))


def _forward_case(rng, L, C, H, R):
    D = L + C
    w1, w2 = _inputs(rng, D, H, scale=0.3), _inputs(rng, H, H, scale=0.2)
    b1 = rng.standard_normal(H).astype(np.float32) * 0.1
    b2 = rng.standard_normal(H).astype(np.float32) * 0.1
    w3 = rng.standard_normal((H, L)).astype(np.float32) * 0.2
    x = _inputs(rng, R, D)
    return w1, b1, w2, b2, w3, x


def _forward_f(warp, case, L, C, H, R):
    w1, b1, w2, b2, w3, x = case
    f = np.zeros((L, R), np.float32)
    warp.forward_f(_ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(w3),
                   _ptr(x), L, C, H, R, _ptr(f))
    return f


def _forward_want(case):
    """numpy's f on the same bf16 roundings: x, a1, a2 and W3 rounded, sums
    in float64."""
    w1, b1, w2, b2, w3, x = case
    a1 = _from_bits(_bf16_bits(_softplus(_from_bits(x) @ _from_bits(w1)
                                         + b1)))
    a2 = _from_bits(_bf16_bits(_softplus(a1 @ _from_bits(w2) + b2)))
    return (a2 @ _from_bits(_bf16_bits(w3))).T


# The forward's f against numpy's: float32 sums of the three tensor-core
# products against float64, 3e-7 of scale at these seeds (a bf16 rounding
# of an activation that the two sums flipped would show as some 1e-3); a
# swapped row or column lands far above.
FWD_REL = REL


@pytest.mark.parametrize("R", [8, 16])
@pytest.mark.parametrize("L,C,H", [(4, 64, 128), (3, 5, 40), (1, 1, 136)],
                         ids=["flagship", "narrow", "wide"])
def test_forward_products_on_the_emulated_warp(warp, L, C, H, R):
    """The bf16 forward's drift tower f for a block of R rows, addressed as
    latent_fwd_bf16 addresses it: x with z's columns padded to 8
    (fwd_x_col) and W1 staged at the same rows, layer 1 rounded and
    transposed into act1, layer 2 rounded and transposed in the lanes into
    layer 3's B operand, layer 3 one product an m-tile (whichever warp
    holds it) added over the m-tiles in order; against numpy on the same
    roundings."""
    rng = np.random.default_rng(L + C + H + R)
    case = _forward_case(rng, L, C, H, R)
    want = _forward_want(case)
    got = _forward_f(warp, case, L, C, H, R)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_REL * scale)


@pytest.mark.parametrize("right,wrong", [
    ("return (lane >> 2) + 8 * (i >> 1);",
     "return (lane >> 2) + 8 * (1 - (i >> 1));"),
    ("return k < L ? k : k - L + ((L + 7) & ~7);",
     "return k < L ? k : k - L + ((L + 7) & ~7) - 5;")],
    ids=["swapped-rows", "shifted-context"])
def test_forward_index_faults_are_caught(tmp_path, right, wrong):
    """The header with an accumulator's two 8-row halves swapped, or with
    the context's first column on z's last: the emulated forward no longer
    matches numpy."""
    header = (CSRC / "mma_bf16.cuh").read_text()
    assert header.count(right) == 1
    bad = _build(tmp_path, header.replace(right, wrong))
    L, C, H, R = 4, 64, 128, 8
    case = _forward_case(np.random.default_rng(3), L, C, H, R)
    want = _forward_want(case)
    got = _forward_f(bad, case, L, C, H, R)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FWD_REL * float(np.abs(want).max()))


def _lipswish(x):
    return 0.909 * x / (1.0 + np.exp(-x))


def _lipswish_slope(x):
    s = 1.0 / (1.0 + np.exp(-x))
    return 0.909 * (s + x * s * (1.0 - s))


def _tower_case(rng, S, M, kq):
    """A tower's bf16 weights (bits), its biases (bf16 values as float32),
    a warp's 8 rows of z (bits), the step's time (a bf16 value) and the
    outputs' cotangents."""
    W1 = _inputs(rng, 1 + S, M, scale=0.3)
    W2 = _inputs(rng, M, S * kq, scale=0.3)
    b1 = _from_bits(_inputs(rng, M, scale=0.1)).astype(np.float32)
    b2 = _from_bits(_inputs(rng, S * kq, scale=0.1)).astype(np.float32)
    z = _inputs(rng, 8, S)
    t1r = float(_from_bits(_inputs(rng, 1))[0])
    dout = rng.standard_normal((8, S * kq)).astype(np.float32)
    return W1, b1, W2, b2, z, t1r, dout


def _tower_step(warp, case, S, M, kq, UT, HT, KC):
    W1, b1, W2, b2, z, t1r, dout = case
    f = lambda *shape: np.zeros(shape, np.float32)       # noqa: E731
    u = lambda *shape: np.zeros(shape, np.uint16)        # noqa: E731
    out = dict(pre1=f(8, M), a1r=u(8, M), o=f(8, S * kq),
               dpre2=f(8, S * kq), dp2r=u(8, S * kq), da=f(8, M),
               dpre1=f(8, M), dp1r=u(8, M), dz=f(8, S),
               part=f((1 + S) * M + M + M * S * kq + S * kq))
    warp.gan_tower_step(_ptr(W1), _ptr(b1), _ptr(W2), _ptr(b2), S, M, kq,
                        UT, HT, KC, _ptr(z), t1r, _ptr(dout),
                        *[_ptr(out[k]) for k in (
                            "pre1", "a1r", "o", "dpre2", "dp2r", "da",
                            "dpre1", "dp1r", "dz", "part")])
    return out


def _check_tower_step(case, got, S, M, kq):
    """Each product of the emulated step against numpy's on the step's own
    bf16 roundings (so a rounding that the float32 and float64 sums flip
    cannot show), each rounding within half a bf16 ulp of its value, and
    the warp's partial of the weights' gradients."""
    W1, b1, W2, b2, z, t1r, dout = case
    W1f, W2f, zr = _from_bits(W1), _from_bits(W2), _from_bits(z)
    _check(got["pre1"], zr @ W1f[1:] + t1r * W1f[0] + b1)
    a1r = _from_bits(got["a1r"])
    np.testing.assert_allclose(a1r, _lipswish(got["pre1"].astype(np.float64)),
                               rtol=2 ** -8, atol=1e-30)
    _check(got["o"], a1r @ W2f + b2)
    _check(got["dpre2"], dout * (1.0 - np.tanh(got["o"].astype(np.float64))
                                 ** 2))
    dp2r = _from_bits(got["dp2r"])
    np.testing.assert_allclose(dp2r, got["dpre2"], rtol=2 ** -8, atol=1e-30)
    _check(got["da"], dp2r @ W2f.T)
    _check(got["dpre1"], got["da"] * _lipswish_slope(
        got["pre1"].astype(np.float64)))
    dp1r = _from_bits(got["dp1r"])
    np.testing.assert_allclose(dp1r, got["dpre1"], rtol=2 ** -8, atol=1e-30)
    _check(got["dz"], dp1r @ W1f[1:].T)
    p, Sk = got["part"], S * kq
    gW1 = p[:(1 + S) * M].reshape(1 + S, M)
    gb1 = p[(1 + S) * M:(2 + S) * M]
    gW2 = p[(2 + S) * M:(2 + S) * M + M * Sk].reshape(M, Sk)
    gb2 = p[(2 + S) * M + M * Sk:]
    xin = np.concatenate([np.full((8, 1), t1r), zr], axis=1)
    _check(gW1, xin.T @ dp1r)
    _check(gb1, got["dpre1"].sum(0))
    _check(gW2, a1r.T @ dp2r)
    _check(gb2, got["dpre2"].sum(0))


# A tower of each kind of instantiation (S, M, kq, and the tiles UT, HT,
# KC it holds): kernel 8 at the reference (S 17, C 2), at the widest (C
# 8), at C 3 in its own instantiation (one of four channels' tiles zero)
# and in the widest's (a state tile and five of eight channels' tiles
# zero); kernel 6's drift (kq 1) and diffusion (m 3) at the reference,
# and the widest.
TOWER_CASES = [(17, 16, 2, 2, 1, 2), (16, 16, 2, 1, 1, 2),
               (32, 32, 8, 2, 2, 8), (9, 24, 3, 2, 2, 8),
               (16, 16, 1, 1, 1, 1), (16, 16, 3, 1, 1, 3),
               (32, 32, 1, 2, 2, 1), (1, 1, 1, 1, 1, 1),
               (9, 24, 3, 1, 2, 4)]


@pytest.mark.parametrize("S,M,kq,UT,HT,KC", TOWER_CASES)
def test_gan_tower_step_on_the_emulated_warp(warp, S, M, kq, UT, HT, KC):
    """A tower's step of the bf16 GAN sweeps (gan_bwd_bf16.cuh) for a warp
    of 8 rows, its weights staged by tower_word and every product
    addressed as tower_forward and tower_backward address it: layer 1
    (the time's row apart), layer 2 with its outputs laid out channel by
    channel, the hidden cotangent, dz, and the weights' gradients on
    m16n8k8 over the warp's rows, written as write_tower_partial writes
    them; against numpy."""
    case = _tower_case(np.random.default_rng(S + 3 * M + 7 * kq), S, M, kq)
    got = _tower_step(warp, case, S, M, kq, UT, HT, KC)
    _check_tower_step(case, got, S, M, kq)


@pytest.mark.parametrize("right,wrong", [
    ("return (lane >> 2) + 8 * (r & 1);",
     "return (lane >> 2) + 8 * (1 - (r & 1));"),
    ("if (op == kLayer1) return m < M && k < S ? (1 + k) * M + m : -1;",
     "if (op == kLayer1) return m < M && k < S ? k * M + m : -1;"),
    ("const int k = 16 * (tile % kt) + a_col(lane, r);",
     "const int k = 16 * (tile / kt) + a_col(lane, r);")],
    ids=["swapped-fragment-row", "shifted-input-column",
         "swapped-tile-coordinates"])
def test_gan_tower_index_faults_are_caught(tmp_path, right, wrong):
    """gan_bwd_bf16.cuh with an A fragment's two 8-row halves swapped,
    layer 1's weights one input row off (the time's row read for z's
    first), or a staged tile's k-tile taken from its m-tile: the emulated
    step no longer matches numpy."""
    header = (CSRC / "gan_bwd_bf16.cuh").read_text()
    assert header.count(right) == 1
    bad = _build(tmp_path, (CSRC / "mma_bf16.cuh").read_text(),
                 header.replace(right, wrong))
    S, M, kq = 17, 16, 2
    case = _tower_case(np.random.default_rng(5), S, M, kq)
    got = _tower_step(bad, case, S, M, kq, 2, 1, 2)
    with pytest.raises(AssertionError):
        _check_tower_step(case, got, S, M, kq)
