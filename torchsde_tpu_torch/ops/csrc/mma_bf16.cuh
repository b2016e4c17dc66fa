// bf16 tensor-core products for the bf16 mixed mode of kernels 2 and 4
// (latent_fused_bwd.cu): mma.sync.m16n8k16 with bf16 operands and float32
// accumulators, which is exactly the JAX package's
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace tsde_bf16 {

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

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

#endif  // __CUDACC__

}  // namespace tsde_bf16
