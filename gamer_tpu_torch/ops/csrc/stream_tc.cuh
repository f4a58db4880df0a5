// The streamed product of the wide bf16 routes (MoE forward h and CE j/k
// with D > 256), where neither operand of a contraction fits in shared
// memory whole.
//
// stream_mma adds A . B over a depth K to this warp's 16 rows x 8*NJ columns
// of fp32 accumulators (mma.cuh C layout): A is a block of 64 rows (4 warps
// of 16) stored [m][k]; B is stored [n][k] (BT false, one block of 8*NJ
// rows) or [k][n] (BT true, two blocks of 4*NJ columns side by side, at b0
// and b1, as the MoE gate and up columns). K is walked in 64-deep slices
// double-buffered in `buf` by 16-byte cp.async; rows past `ma` or `nb`
// (columns past `nb` in each half when BT) and depths past K are zero-filled,
// so ragged edges add nothing. With AROWS, A's rows are gathered: row r of
// the block is row arows[r] of the matrix at `a` (negative: zeros). K and
// the stored widths must be multiples of 8. The call starts with a __syncthreads (buf is free) and ends with one
// (buf may be reused), and leaves no cp.async group in flight; groups the
// caller committed before the call have landed by its first product.
#pragma once

#include "mma.cuh"

namespace gamer {
namespace tc {

constexpr int STREAM_KS = 64;  // depth of a streamed slice

template <int NJ, bool BT>
struct StreamTiles {
  static constexpr int NC = 8 * NJ;  // columns
  static constexpr int LA = STREAM_KS + 8, A_ELEMS = 64 * LA;
  static constexpr int LB = BT ? NC + 8 : STREAM_KS + 8;
  static constexpr int B_ELEMS = BT ? STREAM_KS * LB : NC * LB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr size_t smem_bytes = sizeof(bf16) * 2 * STAGE;  // two stages
};

template <int NJ, bool BT, int NT, bool AROWS = false>
__device__ __forceinline__ void stream_mma(float (&acc)[NJ][4], bf16* buf, const bf16* a,
                                           size_t lda, int ma, const bf16* b0, const bf16* b1,
                                           size_t ldb, int nb, int K, int warp, int lane,
                                           const int* arows = nullptr) {
  using L = StreamTiles<NJ, BT>;
  static_assert(NJ % 2 == 0, "an ldmatrix x4 reads two n8 tiles");
  const int ns = (K + STREAM_KS - 1) / STREAM_KS;
  auto load = [&](int s) {
    bf16* sa = buf + (s & 1) * L::STAGE;
    bf16* sb = sa + L::A_ELEMS;
    const int k0 = s * STREAM_KS;
    if constexpr (AROWS)
      load_rows_async<64, STREAM_KS, NT>(sa, L::LA, a + k0, lda, arows, ma, K - k0);
    else
      load_block_async<64, STREAM_KS, NT>(sa, L::LA, a + k0, lda, ma, K - k0);
    if constexpr (BT) {
      const size_t off = static_cast<size_t>(k0) * ldb;
      load_block_async<STREAM_KS, L::NC / 2, NT>(sb, L::LB, b0 + off, ldb, K - k0, nb);
      load_block_async<STREAM_KS, L::NC / 2, NT>(sb + L::NC / 2, L::LB, b1 + off, ldb, K - k0, nb);
    } else {
      load_block_async<L::NC, STREAM_KS, NT>(sb, L::LB, b0 + k0, ldb, nb, K - k0);
    }
  };
  __syncthreads();  // buf is free
  load(0);
  cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) load(s + 1);
    cp_async_commit();   // possibly empty: keeps one group per slice
    cp_async_wait<1>();  // slice s (and the caller's earlier groups) have landed
    __syncthreads();
    const bf16* sa = buf + (s & 1) * L::STAGE;
    const bf16* sb = sa + L::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < STREAM_KS; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, a_addr(sa, L::LA, warp * 16, kk, lane));
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t bf[4];
        if constexpr (BT)
          ldsm_x4_trans(bf, bk_addr(sb, L::LB, kk, np * 16, lane));
        else
          ldsm_x4(bf, bn_addr(sb, L::LB, np * 16, kk, lane));
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();  // stage s & 1 is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();
}

}  // namespace tc
}  // namespace gamer
