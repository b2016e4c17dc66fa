// bf16 tensor-core products for the bf16 mixed mode of kernels 1-4
// (latent_fused_fwd.cu, latent_fused_bwd.cu): mma.sync.m16n8k16 with bf16
// operands and float32 accumulators, which is exactly the JAX package's
// jnp.dot(x.astype(bf16), w, preferred_element_type=float32) up to the
// order of its sum.
//
// The fragments (PTX ISA, mma.m16n8k16 .bf16), lane = 4 g + q (g = lane /
// 4, q = lane % 4), each .b32 register two bf16, the lower half first:
//   A (16 x 16, row-major): register i holds A[g + 8 (i & 1)][2q + 8 (i >> 1)
//                           + {0, 1}]
//   B (16 x 8, "col"):      register i holds B[2q + 8 i + {0, 1}][g]
//   C, D (16 x 8, float):   d[i] = D[g + 8 (i >> 1)][2q + (i & 1)]
// ldmatrix.x4 loads four 8 x 8 bf16 matrices: lanes 8 m to 8 m + 7 give the
// addresses of matrix m's eight rows (16 bytes each), and lane t receives
// of matrix m row t / 4, columns 2 (t % 4) and 2 (t % 4) + 1 (with .trans,
// the matrix transposed) in register m. movmatrix.trans transposes one 8 x
// 8 matrix held that way.
//
// The index arithmetic below (which row and column each lane names or
// holds) is plain host-and-device code, so that a host build can emulate a
// warp over it (tests/test_torch_mma_bf16.py); the instructions themselves
// are the part only nvcc compiles (__CUDACC__).

#pragma once

#if defined(__CUDACC__)
#include <cuda_bf16.h>
#endif
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tsde_bf16 {

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// Reserves n bytes at `at`, keeping every array on a 16-byte boundary.
__host__ __device__ inline size_t take_bytes(size_t& at, size_t n) {
  const size_t start = at;
  at += (n + 15) & ~size_t(15);
  return start;
}

// Chunks of 8 bf16 (16 bytes) a row of a [row][col] array holds when
// ldmatrix reads it: its columns padded to 16 with zeros, then, unless the
// chunk count is a multiple of 8 (the rows are swizzled then), padded to
// an odd count. Either way the eight rows of one ldmatrix phase fall on
// eight distinct 16-byte bank groups.
__host__ __device__ inline int ldsm_chunks(int cols) {
  const int c = pad16(cols) / 8;
  return c % 8 == 0 ? c : (c | 1);
}

// Element offset of (row, col) in such an array: chunk c of row r at c ^
// (r & 7) where the rows are swizzled, else at c.
__host__ __device__ inline int ldsm_offset(int row, int col, int chunks) {
  const int c = col >> 3;
  const int at = chunks % 8 == 0 ? c ^ (row & 7) : c;
  return (row * chunks + at) * 8 + (col & 7);
}

// The two orders in which an x4 load takes the four 8 x 8 blocks of a 16 x
// 16 tile, as (row block, column block) of the stored tile:
//   kRowsFirst: (0, 0), (8, 0), (0, 8), (8, 8): the A operand of a stored
//     [m][k] tile, not transposed; or, transposed, the B operands of two
//     n-tiles of a stored [k][n] tile (b0, b1 of the first, then of the
//     second);
//   kColsFirst: (0, 0), (0, 8), (8, 0), (8, 8): the A operand of a stored
//     [k][m] tile, transposed.
enum X4Order { kRowsFirst = 0, kColsFirst = 1 };

// The stored row (in the tile) whose address lane `lane` gives to an x4
// load in `order`, and the first column of its 16 bytes.
__host__ __device__ inline int x4_row(int lane, int order) {
  const int m = lane >> 3;
  return (lane & 7) + 8 * (order == kRowsFirst ? (m & 1) : (m >> 1));
}
__host__ __device__ inline int x4_col(int lane, int order) {
  const int m = lane >> 3;
  return 8 * (order == kRowsFirst ? (m >> 1) : (m & 1));
}

// The column (k) of a B fragment's register i at lane `lane`, read as one
// 32-bit word from row g (n) of a stored [n][k] array: k and k + 1.
__host__ __device__ inline int b_col(int lane, int i) {
  return 2 * (lane & 3) + 8 * i;
}

// Where an accumulator element d[i] sits in the 16 x 8 tile.
__host__ __device__ inline int d_row(int lane, int i) {
  return (lane >> 2) + 8 * (i >> 1);
}
__host__ __device__ inline int d_col(int lane, int i) {
  return 2 * (lane & 3) + (i & 1);
}

// An accumulator tile D (16 m x 8 n) goes to a stored [n][m] array as the
// next product's B operand: its halves h = 0, 1 (rows 8 h to 8 h + 7)
// packed, d[2h] low, d[2h + 1] high, are two 8 x 8 matrices in ldmatrix's
// layout; transposed by movmatrix, lane `lane` holds of half h the word of
// stored row t_row (n) at columns t_col (m) and t_col + 1.
__host__ __device__ inline int t_row(int lane) { return lane >> 2; }
__host__ __device__ inline int t_col(int lane, int h) {
  return 8 * h + 2 * (lane & 3);
}

// The column of input k (z for k < L, then the context) in the bf16
// forward's [row][k] x and the row of f's W1 that multiplies it: z's L
// columns padded to a multiple of 8, so that the context starts on 16
// bytes (its rows arrive by 16-byte copies) and the padding's weight rows
// are zero.
__host__ __device__ inline int fwd_x_col(int k, int L) {
  return k < L ? k : k - L + ((L + 7) & ~7);
}

// The element offsets the kernels use, from the above.
//
// An x4 load of the 16 x 16 tile at stored row srow0 and column scol0 of
// an array laid out by ldsm_offset (`chunks` a row, `rows` rows), in the
// order of an A operand transposed (kColsFirst) or as stored (kRowsFirst):
// lane `lane`'s row address, or -1 past the rows (the caller points it at
// a zero row).
__host__ __device__ inline int a_tile_offset(int lane, int srow0, int scol0,
                                             bool trans, int chunks,
                                             int rows) {
  const int order = trans ? kColsFirst : kRowsFirst;
  const int k = srow0 + x4_row(lane, order);
  return k < rows ? ldsm_offset(k, scol0 + x4_col(lane, order), chunks) : -1;
}

// The same for a plain [row][col] array of row stride `stride`.
__host__ __device__ inline int x4_offset(int lane, int row0, int col0,
                                         int stride, int order) {
  return (row0 + x4_row(lane, order)) * stride + col0 + x4_col(lane, order);
}

// B-fragment register i of n-tile nt and k-tile k0 from a [n][k] array of
// row stride `stride`.
__host__ __device__ inline int b_offset(int lane, int nt, int k0, int stride,
                                        int i) {
  return (nt * 8 + (lane >> 2)) * stride + k0 + b_col(lane, i);
}

// Where half h of an accumulator tile of units unit0.. and n-tile nt,
// transposed, goes in a [n][m] array of row stride `stride`.
__host__ __device__ inline int t_offset(int lane, int nt, int unit0,
                                        int stride, int h) {
  return (nt * 8 + t_row(lane)) * stride + unit0 + t_col(lane, h);
}

#if defined(__CUDACC__)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b, one bf16 m16n8k16 product summed in float32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (to nearest even) in one instruction, lo in
// the lower half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The two halves of a packed word, widened (exactly).
__device__ __forceinline__ float lo_f(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float hi_f(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

__device__ __forceinline__ uint32_t transpose(uint32_t x) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(r) : "r"(x));
  return r;
}

// Asynchronous 16-byte copy into shared memory; zero-fills when !valid
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// The A operand of a 16 x 16 tile of a weight stored [in][unit]
// (ldsm_offset, `chunks` a row, `rows` rows; the zero row past them) from
// stored row srow0 and column scol0: transposed (the product's rows are
// units, its k inputs: the forward layers) or not (its rows are inputs:
// going back).
__device__ __forceinline__ void a_frag(uint32_t (&af)[4],
                                       const __nv_bfloat16* w, int chunks,
                                       int rows, const __nv_bfloat16* zero,
                                       int srow0, int scol0, bool trans,
                                       int lane) {
  const int at = a_tile_offset(lane, srow0, scol0, trans, chunks, rows);
  const __nv_bfloat16* p = at < 0 ? zero : w + at;
  if (trans)
    ldsm_x4_trans(af, p);
  else
    ldsm_x4(af, p);
}

// The B operand of n-tile nt (rows 8 nt to 8 nt + 7) and k-tile k0 of a
// [row][k] bf16 array of row stride `stride`.
__device__ __forceinline__ void b_frag(const __nv_bfloat16* src, int stride,
                                       int nt, int k0, int lane, uint32_t& b0,
                                       uint32_t& b1) {
  b0 = *reinterpret_cast<const uint32_t*>(src +
                                          b_offset(lane, nt, k0, stride, 0));
  b1 = *reinterpret_cast<const uint32_t*>(src +
                                          b_offset(lane, nt, k0, stride, 1));
}

// An accumulator-shaped tile v (units unit0.. x rows of n-tile nt),
// rounded two at a time into pk, then transposed into the [row][unit]
// array dst (row stride `stride`).
__device__ __forceinline__ void put_tile(__nv_bfloat16* dst, int stride,
                                         int unit0, int nt,
                                         const float (&v)[4],
                                         uint32_t (&pk)[2], int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pk[h] = pack(v[2 * h], v[2 * h + 1]);
    *reinterpret_cast<uint32_t*>(dst + t_offset(lane, nt, unit0, stride, h)) =
        transpose(pk[h]);
  }
}

// acc[i] += a warp's product over the k-tiles k0 < K for its m-tiles i <
// nmt (first rows m0[i]): A from the weight w (transposed, TRANS: the
// forward layers; else as stored, going back), B from the [row][k] bf16
// array src. A k-tile's B fragments serve every m-tile, whose products are
// independent chains.
template <int MPW, int NR, bool TRANS>
__device__ __forceinline__ void warp_mma(float (&acc)[MPW][NR][4],
                                         const __nv_bfloat16* w, int chunks,
                                         int rows, const __nv_bfloat16* zero,
                                         const int (&m0)[MPW], int nmt, int K,
                                         const __nv_bfloat16* src,
                                         int stride, int lane) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[NR][2];
#pragma unroll
    for (int nt = 0; nt < NR; ++nt)
      b_frag(src, stride, nt, k0, lane, b[nt][0], b[nt][1]);
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (i < nmt) {
        uint32_t af[4];
        if (TRANS)
          a_frag(af, w, chunks, rows, zero, k0, m0[i], true, lane);
        else
          a_frag(af, w, chunks, rows, zero, m0[i], k0, false, lane);
#pragma unroll
        for (int nt = 0; nt < NR; ++nt)
          mma(acc[i][nt], af, b[nt][0], b[nt][1]);
      }
    }
  }
}

// Sums v over the four lanes of a quad (q) and adds it to *dst from lane q
// = 0 where `add`.
__device__ __forceinline__ void quad_sum_add(float v, float* dst, bool add,
                                             int lane) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  if (add && (lane & 3) == 0) *dst += v;
}

#endif  // __CUDACC__

}  // namespace tsde_bf16
