// Tensor-core and asynchronous-copy building blocks for the bf16 kernels
// (inline PTX, sm_80+ instructions that Hopper keeps): 16-byte `cp.async`
// with zero-fill, `ldmatrix` (plain and transposed) and
// `mma.sync.m16n8k16` with bf16 operands and fp32 accumulation.
//
// Fragment layout of one m16n8k16 product, per warp (g = lane / 4,
// t = lane % 4), the map every caller uses to find the (row, column) of an
// element:
//   A (16 x 16, row-major)  a[0]: (g, 2t..2t+1)    a[1]: (g+8, 2t..2t+1)
//                           a[2]: (g, 2t+8..+9)    a[3]: (g+8, 2t+8..+9)
//   B (16 x 8, "col")       b[0]: (k 2t..2t+1, n g)  b[1]: (k 2t+8..+9, n g)
//   C (16 x 8, fp32)        c[0], c[1]: (g, 2t), (g, 2t+1)
//                           c[2], c[3]: (g+8, 2t), (g+8, 2t+1)
// Each 32-bit register of A or B holds two bf16, the lower column (or k) in
// the low half. So an fp32 accumulator tile C of one product, packed in
// pairs, is the A fragment of the next (the FlashAttention-2 register reuse):
// A over 16 columns = {C0[0,1], C0[2,3], C1[0,1], C1[2,3]} of the two 8-wide
// C tiles.
//
// Shared-memory tiles are bf16 rows of D + 8 elements (LD): the 16-byte pad
// shifts consecutive rows by 4 banks, so the eight 16-byte rows one
// `ldmatrix` 8x8 matrix reads fall in eight distinct bank quads (no
// conflicts) for D = 32, 64, 128 and 256.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gamer {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; !valid writes 16 zero bytes
// (src-size 0) and reads nothing, so rows past S are zeros in shared memory.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lane i gives the row address of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b (m16n8k16, bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane addresses of the x4 loads, for a 16-row x 16-column block at
// (row0, col0) of a tile with row stride LD:
//  A operand (row-major, m16 x k16): matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
//  in the order a[0..3];
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int ld, int row0, int col0,
                                              int lane) {
  return tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}
//  B operand of two n8 tiles from a tile stored [n][k] (plain ldmatrix):
//  r[0], r[1] = b[0], b[1] of n rows 0-7; r[2], r[3] of n rows 8-15;
__device__ __forceinline__ const bf16* bn_addr(const bf16* tile, int ld, int n0, int k0,
                                               int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8;
}
//  B operand of two n8 tiles from a tile stored [k][n] (ldmatrix.trans):
//  r[0], r[1] = b[0], b[1] of n columns 0-7; r[2], r[3] of columns 8-15.
__device__ __forceinline__ const bf16* bk_addr(const bf16* tile, int ld, int k0, int n0,
                                               int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}
//  A operand from a tile stored [k][m] (ldmatrix.trans): the same four
//  matrices as a_addr, each read transposed.
__device__ __forceinline__ const bf16* at_addr(const bf16* tile, int ld, int k0, int m0,
                                               int lane) {
  return tile + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 + ((lane >> 3) & 1) * 8;
}

// Copy a ROWS x COLS block of a bf16 matrix (row stride `stride` elements,
// `g` at the block's first element) into a shared tile of row stride `ld`,
// with 16-byte cp.async by NT threads; rows >= `rows` and columns >= `cols`
// (a multiple of 8) are zero-filled, so a ragged edge adds nothing to a
// product.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_block_async(bf16* tile, int ld, const bf16* g, size_t stride,
                                                 int rows, int cols) {
  constexpr int CPR = COLS / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool in = r < rows && c < cols;
    cp_async_16(tile + r * ld + c, in ? g + static_cast<size_t>(r) * stride + c : g, in);
  }
}

// load_block_async with the block's rows gathered: tile row r is row
// rmap[r] of the matrix at `g`; tile rows >= `rows`, rows whose rmap entry
// is negative and columns >= `cols` are zero-filled.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_rows_async(bf16* tile, int ld, const bf16* g, size_t stride,
                                                const int* rmap, int rows, int cols) {
  constexpr int CPR = COLS / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int src = r < rows ? rmap[r] : -1;
    const bool in = src >= 0 && c < cols;
    cp_async_16(tile + r * ld + c, in ? g + static_cast<size_t>(src) * stride + c : g, in);
  }
}

// Copy rows [r0, r0 + ROWS) of a bf16 matrix (row stride `stride`
// elements, `g` at column 0 of this head) into a [ROWS][D + 8] shared tile;
// rows >= S are zero-filled, and so are columns >= width where the matrix
// is narrower than the tile, so products over all D columns stay exact.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_async(bf16* tile, const bf16* g, size_t stride, int r0,
                                                int S, int width = D) {
  load_block_async<ROWS, D, NT>(tile, D + 8, g + static_cast<size_t>(r0) * stride, stride, S - r0,
                                width);
}

}  // namespace tc
}  // namespace gamer
