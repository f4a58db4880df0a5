// Pieces shared by the MoE kernels, the forward h (fused_moe_fwd.cu) and
// the backward i (fused_moe_bwd.cu): the activation of every route, the
// bf16 tensor-core helpers, and the row table of the grouped launch.
//
// A gate|up weight tile holds a chunk's gate columns and its up columns side
// by side, [k = d][gate | up], and is read with ldmatrix.trans. The gate
// and up accumulators of n8 tile j then cover the same f columns (mma.cuh:
// element e of tile j is row lane/4 + 8*(e/2), column 8j + 2*(lane%4) +
// e%2), so the thread that holds g of (row, f) also holds u of (row, f) and
// the SwiGLU epilogue needs no exchange between threads.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace gamer {
namespace moe {

using tc::bf16;

constexpr int kTileRows = 64;  // a row tile of the grouped table (the kernels' TM)

// The row table of a grouped launch (ops/fused_moe.py `level_rows`): the
// rows of every level, each level's run padded to 128 rows (two row tiles,
// so no tile, and no 128-row tile of the dx product, holds two levels).
// A row of level l (0-based) at position p takes expert first + l * P + p
// of the weights, which hold `experts` of them (another rank's otherwise).
struct Groups {
  const int* rows;        // [tiles * 64]: the row t at each place, -1 a pad place
  const int* tile_level;  // [tiles]: each row tile's level, -1 past the runs
  const int* level_tile;  // [levels + 1]: the first tile of each level's run
  int tiles, levels, first, experts, positions;

  // the expert of row tile `tile` at position p, or -1: no level, or an
  // expert held elsewhere
  __device__ __forceinline__ int expert_of_tile(int tile, int p) const {
    const int l = tile_level[tile];
    const int w = first + l * positions + p;
    return (l >= 0 && w >= 0 && w < experts) ? w : -1;
  }
  // expert w's position p and the places [lo, hi) of its level's run;
  // false when w takes no level
  __device__ __forceinline__ bool run_of_expert(int w, int& p, int& lo, int& hi) const {
    const int j = w - first;
    if (j < 0 || j >= levels * positions) return false;
    p = j % positions;
    lo = level_tile[j / positions] * kTileRows;
    hi = level_tile[j / positions + 1] * kTileRows;
    return true;
  }
  // the row of place `i`, with pad places at T (past every row, as the
  // ungrouped kernels see rows past T)
  __device__ __forceinline__ int row(int i, int T) const {
    const int t = rows[i];
    return t < 0 ? T : t;
  }
};

// The places [kb, ke) of range `split` of `nsplit` over [lo, hi), whole
// 32-row slices each: the static split of a level's run of a weight grad.
__device__ __forceinline__ void split_range(int lo, int hi, int split, int nsplit, int& kb,
                                            int& ke) {
  const int kc = ((hi - lo + nsplit - 1) / nsplit + 31) / 32 * 32;
  kb = min(hi, lo + split * kc);
  ke = min(hi, kb + kc);
}

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

// The activation of the SwiGLU, a runtime code uniform over the launch
// (ops/fused_moe.py ACT_CODES): silu; relu; and the tanh approximation of
// gelu, which is jax.nn.gelu's default and so serves both "gelu" and
// "gelu_new" (pallas_moe.py:54-55). FAST picks silu's sigmoid: the bf16
// kernels' fast one or the fp32 kernels' expf; gelu takes tanhf in both, so
// fp32 stays within 1e-4 of the plain version.
enum Act : int { kSilu = 0, kRelu = 1, kGeluTanh = 2 };

template <bool FAST>
__device__ __forceinline__ float silu_sigmoid(float g) {
  return FAST ? sigmoid(g) : 1.f / (1.f + expf(-g));
}

constexpr float kGeluK = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluC = 0.044715f;

// f(std::integral_constant<int, ACT>{}) for the runtime code `act`: one
// uniform branch, inside which the activation is a compile-time constant.
// Epilogues on the accumulator fragments run through it, so that no element
// pays for a test of the code or for the other activations' arithmetic.
template <typename Fn>
__device__ __forceinline__ void with_act(int act, Fn&& f) {
  if (act == kSilu)
    f(std::integral_constant<int, kSilu>{});
  else if (act == kRelu)
    f(std::integral_constant<int, kRelu>{});
  else
    f(std::integral_constant<int, kGeluTanh>{});
}

// a = act(g)
template <bool FAST>
__device__ __forceinline__ float act_value(int act, float g) {
  if (act == kSilu) return g * silu_sigmoid<FAST>(g);
  if (act == kRelu) return fmaxf(g, 0.f);
  const float cdf = 0.5f * (1.f + tanhf(kGeluK * (g + kGeluC * g * g * g)));
  return g * cdf;
}

// a = act(g) and da = act'(g); relu' is 0 at 0, as jax.vjp(jax.nn.relu) gives
template <bool FAST>
__device__ __forceinline__ void act_grad(int act, float g, float& a, float& da) {
  if (act == kSilu) {
    const float s = silu_sigmoid<FAST>(g);
    a = g * s;
    da = s * (1.f + g * (1.f - s));
  } else if (act == kRelu) {
    a = fmaxf(g, 0.f);
    da = g > 0.f ? 1.f : 0.f;
  } else {
    const float t = tanhf(kGeluK * (g + kGeluC * g * g * g));
    const float cdf = 0.5f * (1.f + t);
    a = g * cdf;
    da = cdf + 0.5f * g * (1.f - t * t) * kGeluK * (1.f + 3.f * kGeluC * g * g);
  }
}

}  // namespace moe
}  // namespace gamer
