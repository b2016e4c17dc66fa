// The bf16 mixed mode of the SDE-GAN reverse sweeps (kernel 6,
// gan_gen_bwd_bf16.cu; kernel 8, gan_cde_bwd_bf16.cu) on bf16 tensor cores:
// what the two share. A tower (Linear, lipswish, Linear, tanh) recomputed
// at a step's stored state and taken back through, for eight batch rows a
// warp, on mma.m16n8k16 and mma.m16n8k8 with bf16 operands and float32
// sums: the JAX package's _tower_fwd and _tower_bwd
// (torchsde_tpu/ops/gan_fused.py), jnp.dot(x.astype(bf16), w,
// preferred_element_type=float32) up to the order of each sum.
//
// The layout. Every product has the warp's 8 rows as its n dimension and a
// tower's units as m: a value of the step lives in the lanes as an
// accumulator tile does (mma_bf16.cuh: d_row, d_col), unit 16 t + d_row
// of m-tile t, batch row d_col, so lane 4 g + q holds units g and g + 8 of
// each m-tile, rows 2q and 2q + 1. The state, its cotangents, the tower's
// hidden units and its outputs all sit so; an elementwise step (lipswish,
// tanh, the reversible-Heun update) runs on the elements a lane holds. A
// tile rounded two values a word (pack: cvt.rn.bf16x2) is two 8 x 8
// blocks, block h the units 8h + g at rows 2q, 2q + 1:
//   - as they stand, the A operand (a0, a1) or a B operand (block h: the
//     n-tile of units 8h..8h + 7) of an m16n8k8 product whose k is the
//     warp's 8 rows: the weights' gradients, dW^T += cotangent x input;
//   - transposed (movmatrix), the B operand of an m16n8k16 product whose k
//     is the units: the next layer.
// The weights are A operands, [unit][input] tiles of 16 x 16, staged once
// a block in shared memory in fragment order (a lane's four words of a
// tile at one 16-byte address, so a warp's loads of a tile hit distinct
// banks), zeros past the widths.
//
// A tower's products, for U = 16 UT units of state (S of them used), H =
// 16 HT hidden units (M used) and O = 16 OT outputs: output o = c U + u is
// unit u's channel c (of kq: 1 for the drift, m for the diffusion, C for
// the critic), column u kq + c of W2, so a channel's outputs line up with
// the state's elements. The input [t1, z1] is z1 (U inputs) and the time
// apart: its row of W1 enters layer 1 as t1 w1t + b1 and its gradient is
// summed on the lanes.
//   layer 1     pre1 (H x 8) = W1z^T (H x U) z1r (U x 8)          kLayer1
//   layer 2     o (O x 8)    = W2'^T (O x H) a1r (H x 8)          kLayer2
//   going back  da (H x 8)   = W2' (H x O) dpre2r (O x 8)         kHidden
//               dz (U x 8)  += W1z (U x H) dpre1r (H x 8)         kInput
//   gradients   dW2^T (O x H) += dpre2r (O x 8) a1r^T (8 x H)     m16n8k8
//               dW1z^T (H x U) += dpre1r (H x 8) z1r^T (8 x U)     m16n8k8
// A step's roundings are the JAX package's: [t1, z1], a1, dpre2 and dpre1
// rounded to bf16 as products' inputs, the biases' sums on the unrounded
// cotangents, every sum float32. The weights' gradients stay in
// accumulator tiles for the whole sweep; each row group writes one
// partial.
//
// A group of 8 rows runs on two or three warps. The forward warp
// recomputes the towers at each step's stored state (z1 does not depend
// on the cotangents), one step ahead of the backward warps, which take
// them back and carry the cotangents and the sums. The forward warp hands
// a step over in a slot of shared memory (two slots, by the step's
// parity; a lane's words at a stride of 32, so a warp's accesses hit
// distinct banks), and the group meets at one named barrier a step: the
// forward warp writes step s's slot and arrives, a backward warp arrives
// and reads it, and the forward warp may write that slot again only after
// every backward warp arrived at the next step's barrier, by which time
// it has read it. (Kernel 6's two backward warps, one a tower, swap their
// towers' dz the same way at a second barrier of their own.) A lone
// warp's step is a long chain of dependent instructions; warps on several
// of the SM's schedulers run its parts at once.
//
// lipswish's sigmoid and tanh are __expf and __fdividef: a few float32
// ulps from expf and tanhf, far below the bf16 roundings around them,
// without the precise functions' branches to a slow path.
//
// The index arithmetic (which weight each fragment word holds, which
// output a tile row is) is plain host-and-device code, so that a host
// build can emulate a warp over it (tests/test_torch_mma_bf16.py); the
// kernels' parts are under __CUDACC__.

#pragma once

#include "mma_bf16.cuh"
#if defined(__CUDACC__)
#include "gan_fused_common.cuh"
#endif

namespace tsde_gan_bf16 {

using namespace tsde_bf16;

// Batch rows a warp: the n dimension of every product.
constexpr int ROWS = 8;

// A tower's four weight operands, in the order their tiles are staged.
enum TowerOp { kLayer1 = 0, kLayer2 = 1, kHidden = 2, kInput = 3 };

// m-tiles and k-tiles of each operand, for UT state, HT hidden and OT
// output tiles.
__host__ __device__ inline int op_mtiles(int op, int UT, int HT, int OT) {
  return op == kLayer1 ? HT : op == kLayer2 ? OT : op == kHidden ? HT : UT;
}
__host__ __device__ inline int op_ktiles(int op, int UT, int HT, int OT) {
  return op == kLayer1 ? UT : op == kLayer2 ? HT : op == kHidden ? OT : HT;
}

// The first tile of operand op; op = 4 gives the tower's tile count.
__host__ __device__ inline int op_first(int op, int UT, int HT, int OT) {
  int at = 0;
  for (int o = 0; o < op; ++o)
    at += op_mtiles(o, UT, HT, OT) * op_ktiles(o, UT, HT, OT);
  return at;
}

// Where an A operand's register r of lane `lane` sits in its 16 x 16 tile
// (PTX ISA, mma.m16n8k16 .bf16): row a_row, columns a_col and a_col + 1.
__host__ __device__ inline int a_row(int lane, int r) {
  return (lane >> 2) + 8 * (r & 1);
}
__host__ __device__ inline int a_col(int lane, int r) {
  return 2 * (lane & 3) + 8 * (r >> 1);
}

// Output o of layer 2 (o = c U + u): its column of W2 (S kq wide), or -1
// in the padding.
__host__ __device__ inline int out_col(int o, int U, int S, int kq) {
  const int c = o / U, u = o % U;
  return u < S && c < kq ? u * kq + c : -1;
}

// The weight at (m, k) of operand op: an index of W1 ((1 + S) x M, the
// time's row first; *w2 = 0) or of W2 (M x S kq; *w2 = 1), or -1 past the
// widths.
__host__ __device__ inline int tower_weight(int op, int m, int k, int U,
                                            int S, int M, int kq, int* w2) {
  *w2 = op == kLayer2 || op == kHidden;
  if (op == kLayer1) return m < M && k < S ? (1 + k) * M + m : -1;
  if (op == kInput) return m < S && k < M ? (1 + m) * M + k : -1;
  const int h = op == kLayer2 ? k : m;
  const int o = out_col(op == kLayer2 ? m : k, U, S, kq);
  return h < M && o >= 0 ? h * S * kq + o : -1;
}

// Word i of operand op's staged tiles (lane-major: tile, lane, register),
// as the two weights of its low and high half (tower_weight's indices, -1
// a zero) and the matrix they come from.
__host__ __device__ inline void op_word(int op, int i, int UT, int HT, int OT,
                                        int S, int M, int kq, int (&src)[2],
                                        int* w2) {
  const int tile = i >> 7, lane = (i >> 2) & 31, r = i & 3;
  const int kt = op_ktiles(op, UT, HT, OT);
  const int m = 16 * (tile / kt) + a_row(lane, r);
  const int k = 16 * (tile % kt) + a_col(lane, r);
  for (int e = 0; e < 2; ++e)
    src[e] = tower_weight(op, m, k + e, 16 * UT, S, M, kq, w2);
}

// Word w of a tower's staged tiles, the operands one after another.
__host__ __device__ inline void tower_word(int w, int UT, int HT, int OT,
                                           int S, int M, int kq, int (&src)[2],
                                           int* w2) {
  int op = 0;
  while (op < 3 && (w >> 7) >= op_first(op + 1, UT, HT, OT)) ++op;
  op_word(op, w - 128 * op_first(op, UT, HT, OT), UT, HT, OT, S, M, kq, src,
          w2);
}

// The unit (m) and batch row (n, within the warp's 8) of accumulator
// element i of m-tile t at lane `lane`.
__host__ __device__ inline int elem_unit(int lane, int t, int i) {
  return 16 * t + d_row(lane, i);
}
__host__ __device__ inline int elem_row(int lane, int i) {
  return d_col(lane, i);
}

#if defined(__CUDACC__)

// d += a . b, one bf16 m16n8k8 product summed in float32: A (16 x 8) in
// a0 (rows g) and a1 (rows g + 8), columns 2q, 2q + 1; B (8 x 8) rows 2q,
// 2q + 1 of column g.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// A step's inputs are loaded a step ahead of their use, and these loads
// are volatile asm so that the compiler keeps them where they are written:
// left to it, it moved each load down to its use, and every step waited
// out a global load (1,000-1,300 of 2,400 cycles a step in kernel 6's
// stage clocks). *p where `valid`, else 0 (nothing is read).
__device__ __forceinline__ float ldg_early(const float* p, bool valid) {
  float v;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b32 %0, 0;\n"
      " @q ld.global.nc.f32 %0, [%1];\n}\n"
      : "=f"(v) : "l"(p), "r"(int(valid)));
  return v;
}
__device__ __forceinline__ float ldg_early(const __nv_bfloat16* p,
                                           bool valid) {
  unsigned short v;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b16 %0, 0;\n"
      " @q ld.global.nc.u16 %0, [%1];\n}\n"
      : "=h"(v) : "l"(p), "r"(int(valid)));
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// Copies a tower's weights W1 (n1 bf16) and W2 (n2) into raw (shared
// memory, 16-byte aligned; W2 at raw + pad8(n1)) with the whole block, 16
// bytes a load where a weight's address allows it.
__device__ inline void copy_raw(uint16_t* raw, const __nv_bfloat16* W1,
                                int n1, const __nv_bfloat16* W2, int n2) {
  const __nv_bfloat16* src[2] = {W1, W2};
  const int n[2] = {n1, n2};
  uint16_t* dst[2] = {raw, raw + ((n1 + 7) & ~7)};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint16_t* w = reinterpret_cast<const uint16_t*>(src[k]);
    const int vec =
        (reinterpret_cast<size_t>(w) & 15) == 0 ? n[k] / 8 : 0;
    const uint4* w4 = reinterpret_cast<const uint4*>(w);
    uint4* d4 = reinterpret_cast<uint4*>(dst[k]);
#pragma unroll 4
    for (int i = threadIdx.x; i < vec; i += blockDim.x) d4[i] = __ldg(w4 + i);
#pragma unroll 4
    for (int i = 8 * vec + threadIdx.x; i < n[k]; i += blockDim.x)
      dst[k][i] = __ldg(w + i);
  }
}

// Shared memory copy_raw needs for a tower of these widths (bytes).
__host__ __device__ inline size_t raw_bytes(int S, int M, int kq) {
  const int n1 = (1 + S) * M, n2 = M * S * kq;
  return size_t((n1 + 7) & ~7) * 2 + size_t((n2 + 7) & ~7) * 2;
}

// Stages a tower's tiles (tower_word) into frag with the whole block from
// its raw copy in shared memory (copy_raw), operand by operand: each warp
// takes whole tiles, a lane its four words of each (op_word, the tile
// counts and the operand constants), stored as one 16-byte word. (Reading
// each word's weights from global memory, a batch of loads a round trip,
// took 4-8k cycles a block; a search for each word's operand with runtime
// divisions, 20-26k.)
template <int UT, int HT, int OT>
__device__ inline void stage_tower(uint32_t* frag, const uint16_t* raw,
                                   int S, int M, int kq) {
  const uint16_t* w1 = raw;
  const uint16_t* w2 = raw + (((1 + S) * M + 7) & ~7);
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
#pragma unroll
  for (int op = 0; op < 4; ++op) {
    const int tiles = op_mtiles(op, UT, HT, OT) * op_ktiles(op, UT, HT, OT);
    uint4* dst = reinterpret_cast<uint4*>(frag + 128 * op_first(op, UT, HT,
                                                                OT));
    for (int t = threadIdx.x >> 5; t < tiles; t += warps) {
      uint32_t v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int src[2], in2;
        op_word(op, (t * 32 + lane) * 4 + r, UT, HT, OT, S, M, kq, src,
                &in2);
        const uint16_t* w = in2 ? w2 : w1;
        const uint32_t lo = src[0] < 0 ? 0u : w[src[0]];
        const uint32_t hi = src[1] < 0 ? 0u : w[src[1]];
        v[r] = lo | (hi << 16);
      }
      dst[t * 32 + lane] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Stage clocks of a measurement build (-DTSDE_GAN_CLOCKS): each warp sums
// the cycles between its marks in registers, and warp w of the first row
// group adds them to tsde_gan_clocks[16 w ...] at the end. Compiled out
// otherwise.
#if defined(TSDE_GAN_CLOCKS)
__device__ unsigned long long tsde_gan_clocks[64];
struct StageClocks {
  long long last, sum[12];
  __device__ __forceinline__ void start() {
    last = clock64();
#pragma unroll
    for (int k = 0; k < 12; ++k) sum[k] = 0;
  }
  __device__ __forceinline__ void mark(int k) {
    const long long t = clock64();
    sum[k] += t - last;
    last = t;
  }
  __device__ __forceinline__ void flush(int warp, bool first, int lane) {
    if (!first || lane) return;
#pragma unroll
    for (int k = 0; k < 12; ++k)
      atomicAdd(tsde_gan_clocks + 16 * warp + k, (unsigned long long)sum[k]);
  }
};
#else
struct StageClocks {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(int, bool, int) {}
};
#endif

// A lane's constants and sums of one tower, UT state, HT hidden and OT
// output tiles: its biases and time weights, and its weight gradients.
template <int UT, int HT, int OT>
struct Tower {
  const uint4* frag;          // the staged tiles, one uint4 a lane and tile
  float w1t[HT][2], b1[HT][2], b2[OT][2];   // units g, g + 8 of each tile
  float g1[HT][2 * UT][4];    // dW1z^T tiles: hidden x 8 inputs
  float g2[OT][2 * HT][4];    // dW2^T tiles: output x 8 hidden units
  float gt[HT][4], gb1[HT][4], gb2[OT][4];  // time row, biases: per row

  __device__ __forceinline__ uint4 tile(int op, int t, int lane) const {
    return frag[(op_first(op, UT, HT, OT) + t) * 32 + lane];
  }
};

// The tower's constants for lane `lane` from its bf16 weights (W1, b1, W2,
// b2), its sums zeroed.
template <int UT, int HT, int OT>
__device__ __forceinline__ void init_tower(Tower<UT, HT, OT>& T,
                                           const uint32_t* frag,
                                           const __nv_bfloat16* const* w,
                                           int S, int M, int kq, int lane) {
  T.frag = reinterpret_cast<const uint4*>(frag);
#pragma unroll
  for (int t = 0; t < HT; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = elem_unit(lane, t, 2 * h);
      T.w1t[t][h] = j < M ? __bfloat162float(w[0][j]) : 0.f;
      T.b1[t][h] = j < M ? __bfloat162float(w[1][j]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) T.gt[t][i] = T.gb1[t][i] = 0.f;
#pragma unroll
    for (int n = 0; n < 2 * UT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) T.g1[t][n][i] = 0.f;
    }
  }
#pragma unroll
  for (int t = 0; t < OT; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = out_col(elem_unit(lane, t, 2 * h), 16 * UT, S, kq);
      T.b2[t][h] = o >= 0 ? __bfloat162float(w[3][o]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) T.gb2[t][i] = 0.f;
#pragma unroll
    for (int n = 0; n < 2 * HT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) T.g2[t][n][i] = 0.f;
    }
  }
}

// lipswish (0.909 x sigmoid(x)) and its slope at x, sigmoid by __expf and
// __fdividef (0 for x far below -87, where sigmoid is below 2^-126).
__device__ __forceinline__ void lipswish_fast(float x, float& a,
                                              float& slope) {
  const float s = __fdividef(1.f, 1.f + __expf(-x));
  a = 0.909f * x * s;
  slope = 0.909f * (s + x * s * (1.f - s));
}

// tanh(x) = 1 - 2 / (1 + exp(2x)), by __expf and __fdividef: 1 and -1 at
// the ends, and an absolute error of a few float32 ulps of 1 near 0.
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}

// The state's elements (UT tiles of 4) rounded two a word: zb[t][h] is
// block h of tile t (units 16 t + 8 h + g, rows 2q, 2q + 1).
template <int UT>
__device__ __forceinline__ void pack_tiles(const float (&v)[UT][4],
                                           uint32_t (&pk)[UT][2]) {
#pragma unroll
  for (int t = 0; t < UT; ++t) {
    pk[t][0] = pack(v[t][0], v[t][1]);
    pk[t][1] = pack(v[t][2], v[t][3]);
  }
}

// The tower's forward at [t1r, z1r] (z1r as its packed blocks zb): the
// hidden activations rounded and packed (ab), lipswish's slopes (sl1) and
// the outputs after tanh (F).
template <int UT, int HT, int OT>
__device__ __forceinline__ void tower_forward(const Tower<UT, HT, OT>& T,
                                              const uint32_t (&zb)[UT][2],
                                              float t1r, int lane,
                                              uint32_t (&ab)[HT][2],
                                              float (&sl1)[HT][4],
                                              float (&F)[OT][4]) {
  uint32_t zt[UT][2];
#pragma unroll
  for (int k = 0; k < UT; ++k) {
    zt[k][0] = transpose(zb[k][0]);
    zt[k][1] = transpose(zb[k][1]);
  }
#pragma unroll
  for (int t = 0; t < HT; ++t) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < UT; ++k) {
      const uint4 a = T.tile(kLayer1, t * UT + k, lane);
      const uint32_t af[4] = {a.x, a.y, a.z, a.w};
      mma(acc, af, zt[k][0], zt[k][1]);
    }
    float a1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lipswish_fast(acc[i] + t1r * T.w1t[t][i >> 1] + T.b1[t][i >> 1],
                    a1[i], sl1[t][i]);
    ab[t][0] = pack(a1[0], a1[1]);
    ab[t][1] = pack(a1[2], a1[3]);
  }
  uint32_t at[HT][2];
#pragma unroll
  for (int k = 0; k < HT; ++k) {
    at[k][0] = transpose(ab[k][0]);
    at[k][1] = transpose(ab[k][1]);
  }
#pragma unroll
  for (int t = 0; t < OT; ++t) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < HT; ++k) {
      const uint4 a = T.tile(kLayer2, t * HT + k, lane);
      const uint32_t af[4] = {a.x, a.y, a.z, a.w};
      mma(acc, af, at[k][0], at[k][1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) F[t][i] = tanh_fast(acc[i] + T.b2[t][i >> 1]);
  }
}

// The tower taken back from its outputs' pre-activation cotangents dp2:
// its weight gradients summed into T, and the cotangent of z1 added to dz
// (the accumulator tiles of the state).
template <int UT, int HT, int OT>
__device__ __forceinline__ void tower_backward(Tower<UT, HT, OT>& T,
                                               const float (&dp2)[OT][4],
                                               const uint32_t (&ab)[HT][2],
                                               const uint32_t (&zb)[UT][2],
                                               const float (&sl1)[HT][4],
                                               float t1r, int lane,
                                               float (&dz)[UT][4]) {
  uint32_t db[OT][2], dt[OT][2];
#pragma unroll
  for (int t = 0; t < OT; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) T.gb2[t][i] += dp2[t][i];
    db[t][0] = pack(dp2[t][0], dp2[t][1]);
    db[t][1] = pack(dp2[t][2], dp2[t][3]);
    dt[t][0] = transpose(db[t][0]);
    dt[t][1] = transpose(db[t][1]);
    // dW2^T (outputs x hidden) += dpre2r a1r^T, k the warp's rows.
#pragma unroll
    for (int k = 0; k < HT; ++k) {
      mma_k8(T.g2[t][2 * k], db[t][0], db[t][1], ab[k][0]);
      mma_k8(T.g2[t][2 * k + 1], db[t][0], db[t][1], ab[k][1]);
    }
  }
  uint32_t eb[HT][2], et[HT][2];
#pragma unroll
  for (int t = 0; t < HT; ++t) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < OT; ++k) {
      const uint4 a = T.tile(kHidden, t * OT + k, lane);
      const uint32_t af[4] = {a.x, a.y, a.z, a.w};
      mma(acc, af, dt[k][0], dt[k][1]);
    }
    float dp1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dp1[i] = acc[i] * sl1[t][i];
      T.gb1[t][i] += dp1[i];
    }
    eb[t][0] = pack(dp1[0], dp1[1]);
    eb[t][1] = pack(dp1[2], dp1[3]);
    et[t][0] = transpose(eb[t][0]);
    et[t][1] = transpose(eb[t][1]);
    // The time row's gradient on the lanes: t1r times the rounded dpre1.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T.gt[t][2 * h] = fmaf(t1r, lo_f(eb[t][h]), T.gt[t][2 * h]);
      T.gt[t][2 * h + 1] = fmaf(t1r, hi_f(eb[t][h]), T.gt[t][2 * h + 1]);
    }
    // dW1z^T (hidden x inputs) += dpre1r z1r^T, k the warp's rows.
#pragma unroll
    for (int k = 0; k < UT; ++k) {
      mma_k8(T.g1[t][2 * k], eb[t][0], eb[t][1], zb[k][0]);
      mma_k8(T.g1[t][2 * k + 1], eb[t][0], eb[t][1], zb[k][1]);
    }
  }
#pragma unroll
  for (int t = 0; t < UT; ++t) {
#pragma unroll
    for (int k = 0; k < HT; ++k) {
      const uint4 a = T.tile(kInput, t * HT + k, lane);
      const uint32_t af[4] = {a.x, a.y, a.z, a.w};
      mma(dz[t], af, et[k][0], et[k][1]);
    }
  }
}

// What the forward warp hands over for one tower and step: the hidden
// activations rounded and packed, lipswish's slopes and the outputs.
template <int HT, int OT>
struct TowerStep {
  uint32_t ab[HT][2];
  float sl1[HT][4], F[OT][4];
};

// Words of a lane in a step's slot: z1's packed blocks, then each tower's
// TowerStep.
template <int HT, int OT>
__host__ __device__ constexpr int step_words() {
  return 2 * HT + 4 * HT + 4 * OT;
}

// A lane's side of the slot: word w at slot[32 w + lane].
struct SlotLane {
  uint32_t* p;
  __device__ __forceinline__ void put(int w, uint32_t v) const {
    p[32 * w] = v;
  }
  __device__ __forceinline__ uint32_t get(int w) const { return p[32 * w]; }
};

template <int UT>
__device__ __forceinline__ void put_z(const SlotLane& s, int& w,
                                      const uint32_t (&zb)[UT][2]) {
#pragma unroll
  for (int t = 0; t < UT; ++t) {
    s.put(w++, zb[t][0]);
    s.put(w++, zb[t][1]);
  }
}

template <int UT>
__device__ __forceinline__ void get_z(const SlotLane& s, int& w,
                                      uint32_t (&zb)[UT][2]) {
#pragma unroll
  for (int t = 0; t < UT; ++t) {
    zb[t][0] = s.get(w++);
    zb[t][1] = s.get(w++);
  }
}

template <int HT, int OT>
__device__ __forceinline__ void put_step(const SlotLane& s, int& w,
                                         const TowerStep<HT, OT>& f) {
#pragma unroll
  for (int t = 0; t < HT; ++t) {
    s.put(w++, f.ab[t][0]);
    s.put(w++, f.ab[t][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) s.put(w++, __float_as_uint(f.sl1[t][i]));
  }
#pragma unroll
  for (int t = 0; t < OT; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s.put(w++, __float_as_uint(f.F[t][i]));
  }
}

template <int HT, int OT>
__device__ __forceinline__ void get_step(const SlotLane& s, int& w,
                                         TowerStep<HT, OT>& f) {
#pragma unroll
  for (int t = 0; t < HT; ++t) {
    f.ab[t][0] = s.get(w++);
    f.ab[t][1] = s.get(w++);
#pragma unroll
    for (int i = 0; i < 4; ++i) f.sl1[t][i] = __uint_as_float(s.get(w++));
  }
#pragma unroll
  for (int t = 0; t < OT; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f.F[t][i] = __uint_as_float(s.get(w++));
  }
}

// Named barrier `id` of `threads` threads (a row group's warps).
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Sums a per-row value v[i] of unit tile t over the warp's 8 rows (its two
// elements of a row pair, then the quad's lanes); lane q = 0 holds the sum
// of units g (h = 0) and g + 8 (h = 1).
__device__ __forceinline__ float rows_sum(const float (&v)[4], int h) {
  float s = v[2 * h] + v[2 * h + 1];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// Writes the warp's partial of the tower's weight gradients at p, laid out
// as the weights W1, b1, W2, b2 back to back.
template <int UT, int HT, int OT>
__device__ __forceinline__ void write_tower_partial(
    const Tower<UT, HT, OT>& T, float* p, int S, int M, int kq, int lane) {
  const int U = 16 * UT, Sk = S * kq;
  float* pW1 = p;
  float* pb1 = pW1 + (1 + S) * M;
  float* pW2 = pb1 + M;
  float* pb2 = pW2 + M * Sk;
#pragma unroll
  for (int t = 0; t < HT; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float st = rows_sum(T.gt[t], h), sb = rows_sum(T.gb1[t], h);
      const int j = elem_unit(lane, t, 2 * h);
      if ((lane & 3) == 0 && j < M) {
        pW1[j] = st;
        pb1[j] = sb;
      }
    }
#pragma unroll
    for (int n = 0; n < 2 * UT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = elem_unit(lane, t, i), k = 8 * n + elem_row(lane, i);
        if (j < M && k < S) pW1[(1 + k) * M + j] = T.g1[t][n][i];
      }
    }
  }
#pragma unroll
  for (int t = 0; t < OT; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sb = rows_sum(T.gb2[t], h);
      const int o = out_col(elem_unit(lane, t, 2 * h), U, S, kq);
      if ((lane & 3) == 0 && o >= 0) pb2[o] = sb;
    }
#pragma unroll
    for (int n = 0; n < 2 * HT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = out_col(elem_unit(lane, t, i), U, S, kq);
        const int j = 8 * n + elem_row(lane, i);
        if (o >= 0 && j < M) pW2[j * Sk + o] = T.g2[t][n][i];
      }
    }
  }
}

// Sums v over the warp's 8 row groups g (lanes 4 g + q): every lane ends
// with the sum over its q's lanes, in a fixed butterfly.
__device__ __forceinline__ float units_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// out[e] = the partials' float32 sum over p < n of partials[p * P + e]
// (tsde_gan::sum_partials' order: lane l adds partials l, l + 32, ... in
// order, then a fixed butterfly), rounded to bf16 once: the weights'
// gradients in their own dtype, with no conversion launched after.
static __global__ void sum_partials_bf16(const float* partials, int n, int P,
                                         __nv_bfloat16* out) {
  const int e = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= P) return;
  float acc = 0.f;
  for (int p = lane; p < n; p += 32) acc += partials[size_t(p) * P + e];
  acc = tsde_gan::group_sum<32>(acc);
  if (lane == 0) out[e] = __float2bfloat16_rn(acc);
}

static inline cudaError_t launch_sum_partials_bf16(const float* partials,
                                                   int n, int P,
                                                   __nv_bfloat16* out,
                                                   cudaStream_t stream) {
  constexpr int per_block = tsde_gan::SUM_THREADS / 32;
  sum_partials_bf16<<<(P + per_block - 1) / per_block,
                      tsde_gan::SUM_THREADS, 0, stream>>>(partials, n, P,
                                                           out);
  return cudaGetLastError();
}

// Row groups of `warps` warps a block: as many as `threads` allows, but
// no more than leave every SM a block where the grid is short of the
// card's SMs; at least one.
static inline int groups_per_block(int groups, int warps, int threads,
                                   int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int per = groups / (sms > 0 ? sms : 1);
  const int most = threads / (32 * warps);
  if (per > most) per = most;
  return per < 1 ? 1 : per;
}

#endif  // __CUDACC__

}  // namespace tsde_gan_bf16
