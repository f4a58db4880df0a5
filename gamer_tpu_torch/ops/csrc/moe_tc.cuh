// Pieces shared by the bf16 tensor-core MoE kernels, the forward h
// (fused_moe_fwd.cu) and pass 1 of the backward i (fused_moe_bwd.cu).
//
// A gate|up weight tile holds a chunk's gate columns and its up columns side
// by side, [k = d][gate | up], and is read with ldmatrix.trans. The gate
// and up accumulators of n8 tile j then cover the same f columns (mma.cuh:
// element e of tile j is row lane/4 + 8*(e/2), column 8j + 2*(lane%4) +
// e%2), so the thread that holds g of (row, f) also holds u of (row, f) and
// the SwiGLU epilogue needs no exchange between threads.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace gamer {
namespace moe {

using tc::bf16;

// g, u += x . W over one k16 step: xa is the A fragment of the warp's 16
// rows, w a [k][n] tile (row stride ldw) with the gate columns from n 0 and
// the up columns from n up0, NJ n8 tiles (8 * NJ columns) of each.
template <int NJ>
__device__ __forceinline__ void gate_up_step(float (&g)[NJ][4], float (&u)[NJ][4],
                                             const uint32_t (&xa)[4], const bf16* w, int ldw,
                                             int k0, int up0, int lane) {
  static_assert(NJ % 2 == 0, "an ldmatrix x4 reads two n8 tiles");
#pragma unroll
  for (int np = 0; np < NJ / 2; ++np) {
    uint32_t b[4];
    tc::ldsm_x4_trans(b, tc::bk_addr(w, ldw, k0, np * 16, lane));
    tc::mma_bf16(g[2 * np], xa, b[0], b[1]);
    tc::mma_bf16(g[2 * np + 1], xa, b[2], b[3]);
    tc::ldsm_x4_trans(b, tc::bk_addr(w, ldw, k0, up0 + np * 16, lane));
    tc::mma_bf16(u[2 * np], xa, b[0], b[1]);
    tc::mma_bf16(u[2 * np + 1], xa, b[2], b[3]);
  }
}

// The bias row btab[p][id] of a row, or null (the row adds no bias): rows
// past T, bias off, ids outside [0, NB).
__device__ __forceinline__ const bf16* bias_row(const bf16* btp, const int* behp, int t, int T,
                                                int NB, int use_bias, size_t F2) {
  if (!use_bias || t >= T) return nullptr;
  const int id = behp[t];
  return (id >= 0 && id < NB) ? btp + static_cast<size_t>(id) * F2 : nullptr;
}

// Gate and up bias of columns f and f + 1 (f even) of a bias row, zeros for
// a null row.
__device__ __forceinline__ void bias_pair(const bf16* brow, int f, int F, float2& bg, float2& bu) {
  if (brow == nullptr) {
    bg = bu = make_float2(0.f, 0.f);
    return;
  }
  bg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(brow + f));
  bu = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(brow + F + f));
}

// sigmoid in fp32 by the fast exp and divide (exactly 0 and 1 far out)
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

}  // namespace moe
}  // namespace gamer
