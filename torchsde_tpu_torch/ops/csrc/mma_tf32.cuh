// 3xTF32 tensor-core products for kernel 9 (tower_euler_fwd.cu through
// tower_fwd_tile.cuh): float32 operands split into TF32 halves, their
// mma.sync.m16n8k8 products summed into one float32 accumulator.
//
// The split. x = hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x
// - hi), both rounded to nearest: hi keeps 11 significant bits, lo the next
// 11, so hi + lo is x to about 2^-22 of it. The product a.b is then
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the small terms first, lo_a.lo_b
// (about 2^-22 of the product) dropped: CUTLASS's 3xTF32 scheme, near
// float32 accuracy at three tensor-core products a tile.
//
// The m16n8k8 fragments (PTX ISA, mma.m16n8k8 .tf32), lane = 4 g + q
// (g = lane / 4, q = lane % 4):
//   A (16 x 8, row-major): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4),
//                          a3 (g + 8, q + 4)
//   B (8 x 8):             b0 (q, g), b1 (q + 4, g)       as (k, n)
//   C, D (16 x 8):         c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q),
//                          c3 (g + 8, 2q + 1)
// The order of k inside a k-tile is the caller's to choose, as long as A
// and B agree. Activations are stored in the "paired" order: A's k = q and
// k = q + 4 side by side (k_pos below), so a thread reads (a0, a2) and
// (a1, a3) as two float2. B fragments of weights are staged once, split,
// as one float4 a lane (hi b0, hi b1, lo b0, lo b1): one conflict-free
// 16-byte load a tile.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tsde_mma {

// Rounds up to a whole number of k- or n-tiles.
__host__ __device__ inline int pad8(int n) { return (n + 7) & ~7; }

// Row stride (floats) of a [row][k] array read by A-fragment float2 loads:
// at least w and 8 more than a multiple of 32, so that each half-warp of a
// float2 access (4 rows x 4 lanes) hits 32 distinct banks.
__host__ __device__ inline int frag_ld(int w) {
  return w + (((8 - w) % 32) + 32) % 32;
}

// Where column k of a [row][k] array sits in the paired order: inside each
// group of 8, k and k + 4 side by side.
__host__ __device__ inline int k_pos(int k) {
  const int j = k & 7;
  return (k & ~7) | (j < 4 ? 2 * j : 2 * (j - 4) + 1);
}

// Floats of the split B fragments of a (K x N) weight: K/8 x N/8 tiles of
// 32 float4 (K and N padded to 8).
__host__ __device__ inline int frag_floats(int K, int N) {
  return pad8(K) * pad8(N) * 2;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a . b, one TF32 m16n8k8 product.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into its two TF32 halves.
struct AFrag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ AFrag split_a(float a0, float a1, float a2,
                                         float a3) {
  AFrag f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// The A fragment of rows r0 + g, r0 + 8 + g of a [row][k] array in the
// paired order (stride ld), k-tile kt.
__device__ __forceinline__ AFrag load_a_paired(const float* p, int ld,
                                               int r0, int kt, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const float2 u = *reinterpret_cast<const float2*>(
      p + (r0 + g) * ld + kt * 8 + 2 * q);
  const float2 v = *reinterpret_cast<const float2*>(
      p + (r0 + g + 8) * ld + kt * 8 + 2 * q);
  return split_a(u.x, v.x, u.y, v.y);
}

// The A fragment of rows r0 + g, r0 + 8 + g, k-tile kt, of a [row][k]
// array stored split in the paired order: hi parts at hi, lo parts at lo.
__device__ __forceinline__ AFrag load_a_split(const float* hi,
                                              const float* lo, int ld,
                                              int r0, int kt, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int at = (r0 + g) * ld + kt * 8 + 2 * q, at8 = at + 8 * ld;
  const float2 uh = *reinterpret_cast<const float2*>(hi + at);
  const float2 vh = *reinterpret_cast<const float2*>(hi + at8);
  const float2 ul = *reinterpret_cast<const float2*>(lo + at);
  const float2 vl = *reinterpret_cast<const float2*>(lo + at8);
  return {{__float_as_uint(uh.x), __float_as_uint(vh.x),
           __float_as_uint(uh.y), __float_as_uint(vh.y)},
          {__float_as_uint(ul.x), __float_as_uint(vl.x),
           __float_as_uint(ul.y), __float_as_uint(vl.y)}};
}

// B fragment words of a split weight tile: hi b0, hi b1, lo b0, lo b1.
struct BFrag {
  uint32_t hi0, hi1, lo0, lo1;
};

__device__ __forceinline__ BFrag load_b(const float* tiles, int tile,
                                        int lane) {
  const float4 v =
      reinterpret_cast<const float4*>(tiles)[tile * 32 + lane];
  return {__float_as_uint(v.x), __float_as_uint(v.y), __float_as_uint(v.z),
          __float_as_uint(v.w)};
}

// d += a . b in 3xTF32: the two small products, then the large one.
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a,
                                     const BFrag& b) {
  mma(d, a.lo, b.hi0, b.hi1);
  mma(d, a.hi, b.lo0, b.lo1);
  mma(d, a.hi, b.hi0, b.hi1);
}

// Stages a (K x N) weight w(k, n) (zero past K or N) as split B fragments
// in the paired k order, KT x NT tiles of 32 lanes (a float4 a lane: hi
// b0, hi b1, lo b0, lo b1; frag_floats), tile kt * NT + nt, with the
// threads of `tid` from 0 to `nthreads`.
template <typename W>
__device__ inline void stage_b(float* tiles, int K, int N, W w, int tid,
                               int nthreads) {
  const int KT = pad8(K) / 8, NT = pad8(N) / 8;
  for (int e = tid; e < KT * NT * 32; e += nthreads) {
    const int lane = e & 31, tile = e >> 5;
    const int kt = tile / NT, nt = tile % NT;
    const int g = lane >> 2, q = lane & 3, n = nt * 8 + g;
    const int k0 = kt * 8 + q, k1 = k0 + 4;
    const float w0 = k0 < K && n < N ? w(k0, n) : 0.f;
    const float w1 = k1 < K && n < N ? w(k1, n) : 0.f;
    uint32_t h0, l0, h1, l1;
    split(w0, h0, l0);
    split(w1, h1, l1);
    reinterpret_cast<float4*>(tiles)[e] = make_float4(
        __uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
        __uint_as_float(l1));
  }
}

}  // namespace tsde_mma
