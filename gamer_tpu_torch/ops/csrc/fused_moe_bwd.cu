// Fused position-routed SwiGLU MoE-FFN backward.
//
// Replaces the TPU kernel gamer_tpu/ops/pallas_moe.py `_bwd_kernel`
// (pallas_call in `_bwd_rule`). Per expert p, with gu = x Wgu + btab[beh],
// a = act(g) (silu, relu or tanh-gelu; moe_tc.cuh), h = a*u, h_drop = keep ? h/keep_frac : 0 and gout = dL/dy:
//     dh   = gout Wd^T,  dh_drop = keep ? dh/keep_frac : 0
//     dg   = dh_drop * u * act'(g),  du = dh_drop * a,  dgu = [dg | du]
//     dx   = dgu Wgu^T
//     dWgu = x^T dgu,  dWd = h_drop^T gout,  dbtab[a] = sum of dgu over rows
//            whose behavior id is a (ids outside [0, NB) receive nothing)
// The TPU kernel sums dWgu, dWd and dbtab in VMEM across its sequential
// row-tile grid. CUDA blocks run in no order, so this library works in two
// passes with a fixed summation order (deterministic, no atomics):
//   pass 1  recomputes gate/up for a tile of rows and a chunk of F, forms dh
//           from gout and Wd, and writes dgu [P, T, 2F] and h_drop [P, T, F]
//           in the operand dtype. At the flagship shape (P 5, T 6464, F 512)
//           that is 66 MB and 33 MB of bf16 written and read back, about
//           0.06 ms of traffic the one-pass TPU kernel avoided; it buys a
//           backward with no cross-block reduction of the activations.
//   pass 2  blocked products: dx = dgu Wgu^T directly into dx; dWgu and dWd
//           split over T into fp32 partial sums so enough CTAs fill the 132
//           SMs, then `gamer::reduce_splits` adds the splits in order and
//           casts to the weights' dtype. dbtab is summed the same way.
// The dropout mask is the forward's hash of (seed, p, t, f), regenerated.
//
// Bound on H100: operations. 2*P*T*(3*D*2F + 2*F*Dout) multiply-adds (gate/up
// recompute, dx, dWgu; dh, dWd), 67.8 GFLOP at the flagship, against x,
// gout, the weights and the gradients moved once.
//
// Dispatch by dtype, in the C entry point before any launch:
//  - bf16, on the tensor cores (mma.sync m16n8k16, fp32 accumulators;
//    mma.cuh, moe_tc.cuh):
//    pass 1 `moe_bwd_act_tc_kernel`, one CTA per (64-row tile, expert,
//      64-column chunk of F), 4 warps of 16 rows. Two products, each streamed
//      over its depth in double-buffered 64-wide slices by 16-byte cp.async:
//      g|u = x . Wgu[:, chunk] (the chunk's gate and up columns side by side,
//      ldmatrix.trans) and dh = gout . Wd[chunk]^T (Wd stored [f][dout], plain
//      ldmatrix). The epilogue on the accumulator fragments adds the bias,
//      forms act and act', the keep mask with 1/keep on h and dh, and dgu in
//      fp32. dbtab's partial sums over the tile's rows are taken from the fp32
//      dgu, as the TPU kernel does (pallas_moe.py:124-130): the fp32 dgu
//      goes to shared memory and each thread sums one column over the 64 rows
//      in order, per behavior id, into a per-row-tile fp32 workspace that
//      `reduce_splits` adds. dgu and h_drop are rounded to bf16
//      (pallas_moe.py:113,121) and stored as bf16 pairs.
//      The grid re-reads x and gout from L2 once per F chunk (8 at F 512)
//      rather than every weight once per row tile: a CTA that walked all of
//      F would hold x and gout (64 KB at 64 rows) beside its weight stages,
//      one CTA an SM, where this one needs 53 KB and runs three an SM. dx is
//      not fused into pass 1: it sums over all of F, which this grid splits.
//    pass 2 `moe_gemm_tc_kernel<AT, BT>`, one templated product: 128 x 128
//      output tiles, 8 warps of 64 x 32, 32-deep k slices in three cp.async
//      stages; plain ldmatrix for an operand stored [m][k] or [n][k],
//      ldmatrix.trans for one stored [k][m] or [k][n]: dx = dgu . Wgu^T
//      (plain, plain; bf16 out), dWgu = x^T . dgu and dWd = h_drop^T . gout
//      (trans, trans; fp32 partials split over T).
//  - fp32, on the CUDA cores (fp32 FMA from shared memory), so fp32 callers
//    get full fp32: pass 1 `moe_bwd_act_kernel` (64 rows x 32 columns of F a
//    CTA), pass 2 `gemm_kernel` (64 x 64 tiles, strided loads for the
//    transposed operands) and `dbtab_kernel` (dbtab from the stored dgu).
//
// Grouped (G, or the products' kRowsM / kRowsK; `gamer_fused_moe_bwd_grouped`,
// MoeAction's launch, ops/fused_moe.py): pass 1 runs over the row tiles of
// the level table (moe_tc.cuh `Groups`), each CTA with its tile's expert (or
// none: it exits), x and gout read and dgu and h_drop written at each row's
// own place. dx (kRowsM) takes the table's 128-row tiles, each within one
// level (the runs are padded to 128), and writes each row's own place; the
// caller zeroes dx for the rows of no level. dWgu and dWd (kRowsK) take one
// CTA per (expert, range, output tile): the range is one of a static number
// of `split_range`s of the expert's level run, read through the table, so
// an expert sums its own rows only; `reduce_splits` adds the ranges, and an
// expert of no level sums nothing and gets zeros. dbtab: bf16 adds pass 1's
// per-tile sums over the expert's tiles (`moe_bwd_dbtab_sum_kernel`), fp32
// sums the stored dgu over the ranges like the products.

#include "common.cuh"
#include "mma.cuh"
#include "moe_tc.cuh"

namespace {

using namespace gamer::tc;
using gamer::from_f;
using gamer::to_f;
using gamer::moe::Groups;

constexpr int TM = 64;   // rows a CTA (pass 1)
static_assert(TM == gamer::moe::kTileRows, "a grouped tile is a pass-1 CTA's rows");
constexpr int FC = 32;   // F columns a CTA (gate and up each)
constexpr int KT = 32;   // depth of a shared-memory slice
constexpr int NT = 256;  // threads: 16 row groups x 16 column lanes

template <typename T, bool G>
__global__ void __launch_bounds__(NT) moe_bwd_act_kernel(
    const T* __restrict__ x, const T* __restrict__ wgu, const T* __restrict__ wd,
    const T* __restrict__ btab, const int* __restrict__ beh, const T* __restrict__ gout,
    T* __restrict__ dgu, T* __restrict__ hdrop, int T_rows, int D, int F, int Dout, int NB,
    int use_bias, int act, gamer::Seed seed_in, uint32_t thresh, float inv_keep, Groups grp) {
  const uint32_t seed = seed_in.get();
  __shared__ float As[TM][KT + 1];       // x or gout slice
  __shared__ float Ws[KT][2 * FC + 1];   // gate | up weight slice
  __shared__ float Wds[KT][FC + 1];      // Wd slice, transposed
  __shared__ int bid[TM];

  const int t0 = blockIdx.x * TM;
  const int p = blockIdx.y;
  const int f0 = blockIdx.z * FC;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int e = p;  // the expert
  if constexpr (G) {
    e = grp.expert_of_tile(blockIdx.x, p);
    if (e < 0) return;
  }
  auto row_of = [&](int r) {  // the row t of the tile's row r (T: none)
    if constexpr (G)
      return grp.row(t0 + r, T_rows);
    else
      return t0 + r;
  };
  const size_t F2 = 2 * static_cast<size_t>(F);
  const T* xp = x + static_cast<size_t>(p) * T_rows * D;
  const T* gp = gout + static_cast<size_t>(p) * T_rows * Dout;
  const T* wgup = wgu + static_cast<size_t>(e) * D * F2;
  const T* wdp = wd + static_cast<size_t>(e) * F * Dout;
  const T* btp = btab + static_cast<size_t>(e) * NB * F2;

  for (int r = tid; r < TM; r += NT) {
    const int t = row_of(r);
    const int id = t < T_rows ? beh[static_cast<size_t>(p) * T_rows + t] : -1;
    bid[r] = (use_bias && id >= 0 && id < NB) ? id : -1;
  }

  // gate / up of this CTA's columns: thread columns f0 + tx + 16*jj
  float g[4][2], u[4][2], dh[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) g[i][jj] = u[i][jj] = dh[i][jj] = 0.f;

  for (int k0 = 0; k0 < D; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < TM * KT; idx += NT) {
      const int r = idx / KT, kk = idx % KT, t = row_of(r);
      As[r][kk] = (t < T_rows && k0 + kk < D) ? to_f(xp[static_cast<size_t>(t) * D + k0 + kk])
                                              : 0.f;
    }
    for (int idx = tid; idx < KT * 2 * FC; idx += NT) {
      const int kk = idx / (2 * FC), c = idx % (2 * FC);
      const int f = f0 + (c < FC ? c : c - FC);
      const size_t col = c < FC ? f : F + f;
      const bool in = (k0 + kk) < D && f < F;
      Ws[kk][c] = in ? to_f(wgup[static_cast<size_t>(k0 + kk) * F2 + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float xa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float wg = Ws[kk][tx + 16 * jj], wu = Ws[kk][FC + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[i][jj] = fmaf(xa[i], wg, g[i][jj]);
          u[i][jj] = fmaf(xa[i], wu, u[i][jj]);
        }
      }
    }
  }

  // dh = gout Wd^T for the same columns
  for (int k0 = 0; k0 < Dout; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < TM * KT; idx += NT) {
      const int r = idx / KT, kk = idx % KT, t = row_of(r);
      As[r][kk] = (t < T_rows && k0 + kk < Dout)
                      ? to_f(gp[static_cast<size_t>(t) * Dout + k0 + kk])
                      : 0.f;
    }
    for (int idx = tid; idx < FC * KT; idx += NT) {
      const int c = idx / KT, kk = idx % KT, f = f0 + c;
      Wds[kk][c] = (f < F && k0 + kk < Dout)
                       ? to_f(wdp[static_cast<size_t>(f) * Dout + k0 + kk])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float ga[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ga[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float w = Wds[kk][tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) dh[i][jj] = fmaf(ga[i], w, dh[i][jj]);
      }
    }
  }

  const bool drop = thresh > 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = row_of(r);
    if (t >= T_rows) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int f = f0 + tx + 16 * jj;
      if (f >= F) continue;
      float gv = g[i][jj], uv = u[i][jj];
      if (bid[r] >= 0) {
        gv += to_f(btp[bid[r] * F2 + f]);
        uv += to_f(btp[bid[r] * F2 + F + f]);
      }
      float a, da;
      gamer::moe::act_grad<false>(act, gv, a, da);
      float hv = a * uv, dhv = dh[i][jj];
      if (drop) {
        const bool keep = gamer::hash_keep(seed, static_cast<uint32_t>(p),
                                           static_cast<uint32_t>(t), static_cast<uint32_t>(f),
                                           thresh);
        hv = keep ? hv * inv_keep : 0.f;
        dhv = keep ? dhv * inv_keep : 0.f;
      }
      const size_t row = static_cast<size_t>(p) * T_rows + t;
      dgu[row * F2 + f] = from_f<T>(dhv * uv * da);
      dgu[row * F2 + F + f] = from_f<T>(dhv * a);
      hdrop[row * F + f] = from_f<T>(hv);
    }
  }
}

// C[split][p] (M x N) = sum over k in the split's range of A(p, m, k) B(p, k, n),
// with element strides for A and B (either operand may be transposed).
struct GemmArgs {
  int M, N, K, P, kchunk;
  long long sa_p, sa_m, sa_k, sb_p, sb_k, sb_n;
};

// The products' modes (the header comment): kNoGroups; kRowsM, the output
// rows are places of the table (dx: grid y its 64- or 128-row tiles, z the
// position; A's rows and C's through the table, B the tile's expert's);
// kRowsK, the depth is places of the table (g.P = the experts, z = expert +
// experts * range; both operands' rows through the table: the range's of
// the expert's level run, at the expert's position).
enum GroupMode : int { kNoGroups = 0, kRowsM = 1, kRowsK = 2 };

// For a product CTA: (p, e) the position of A and C and the expert of B,
// [kb, ke) its depth (table places under kRowsK), `split` its range; false
// when the CTA has nothing to write (kRowsM: a tile of no expert).
template <int MODE>
__device__ __forceinline__ bool gemm_block(int K, int P, int kchunk, int nsplit, int m_tile,
                                           const Groups& grp, int& p, int& e, int& split,
                                           int& kb, int& ke) {
  if constexpr (MODE == kRowsM) {
    p = blockIdx.z, split = 0, kb = 0, ke = K;
    e = grp.expert_of_tile(m_tile, p);
    return e >= 0;
  } else if constexpr (MODE == kRowsK) {
    e = blockIdx.z % P, split = blockIdx.z / P;
    int lo = 0, hi = 0;
    p = 0;
    grp.run_of_expert(e, p, lo, hi);
    gamer::moe::split_range(lo, hi, split, nsplit, kb, ke);
    return true;
  } else {
    p = e = blockIdx.z % P, split = blockIdx.z / P;
    kb = split * kchunk, ke = min(K, kb + kchunk);
    return true;
  }
}

template <typename T, typename OutT, int MODE>
__global__ void __launch_bounds__(NT) gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                                                  OutT* __restrict__ C, GemmArgs g, int nsplit,
                                                  Groups grp) {
  __shared__ float As[KT][64 + 1];
  __shared__ float Bs[KT][64 + 1];
  const int n0 = blockIdx.x * 64;
  const int m0 = blockIdx.y * 64;
  int p, e, split, kb, ke;
  if (!gemm_block<MODE>(g.K, g.P, g.kchunk, nsplit, blockIdx.y, grp, p, e, split, kb, ke))
    return;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* Ap = A + p * g.sa_p;
  const T* Bp = B + (MODE == kRowsM ? e : p) * g.sb_p;
  // a row or depth index through the table (-1: none) or as it is
  auto through = [&](int i, bool mapped) { return mapped ? grp.rows[i] : i; };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < 64 * KT; idx += NT) {
      int mm, kk;
      if (g.sa_m == 1) {
        mm = idx % 64, kk = idx / 64;
      } else {
        kk = idx % KT, mm = idx / KT;
      }
      const int m = m0 + mm, k = k0 + kk;
      const bool in = MODE == kRowsM ? true : m < g.M;
      const int ms = in && k < ke ? through(m, MODE == kRowsM) : -1;
      const int ks = ms >= 0 ? through(k, MODE == kRowsK) : -1;
      As[kk][mm] = ks >= 0 ? to_f(Ap[ms * g.sa_m + ks * g.sa_k]) : 0.f;
    }
    for (int idx = tid; idx < 64 * KT; idx += NT) {
      int nn, kk;
      if (g.sb_n == 1) {
        nn = idx % 64, kk = idx / 64;
      } else {
        kk = idx % KT, nn = idx / KT;
      }
      const int n = n0 + nn, k = k0 + kk;
      const int ks = (n < g.N && k < ke) ? through(k, MODE == kRowsK) : -1;
      Bs[kk][nn] = ks >= 0 ? to_f(Bp[ks * g.sb_k + n * g.sb_n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  OutT* Cp = C + (static_cast<size_t>(split) * g.P + (MODE == kRowsK ? e : p)) * g.M * g.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty + 16 * i;
    if constexpr (MODE == kRowsM) {
      m = grp.rows[m];
      if (m < 0) continue;
    } else if (m >= g.M) {
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < g.N) Cp[static_cast<size_t>(m) * g.N + n] = from_f<OutT>(acc[i][j]);
    }
  }
}

// ws[split][p][a][c] = sum of dgu[p][t][c] over the split's rows t with
// beh[p][t] == a; one thread a column, NB running sums in shared memory.
// Grouped (G): p is an expert (blockIdx.y), its split a `split_range` of its
// level run, read through the table at the expert's position.
template <typename T, bool G>
__global__ void __launch_bounds__(NT) dbtab_kernel(const T* __restrict__ dgu,
                                                   const int* __restrict__ beh,
                                                   float* __restrict__ ws, int T_rows, int F2,
                                                   int NB, int P, int kchunk, Groups grp) {
  extern __shared__ float sums[];  // [NB][NT]
  const int c = blockIdx.x * NT + threadIdx.x;
  const int p = blockIdx.y;
  const int split = blockIdx.z;
  for (int a = 0; a < NB; ++a) sums[a * NT + threadIdx.x] = 0.f;
  int q = p, tb, te;  // the position read, and the rows (places) summed
  if constexpr (G) {
    int lo = 0, hi = 0;
    q = 0;
    grp.run_of_expert(p, q, lo, hi);
    gamer::moe::split_range(lo, hi, split, gridDim.z, tb, te);
  } else {
    tb = split * kchunk, te = min(T_rows, tb + kchunk);
  }
  if (c < F2) {
    for (int i = tb; i < te; ++i) {
      int t = i;
      if constexpr (G) {
        t = grp.rows[i];
        if (t < 0) continue;
      }
      const int a = beh[static_cast<size_t>(q) * T_rows + t];
      if (a >= 0 && a < NB)
        sums[a * NT + threadIdx.x] += to_f(dgu[(static_cast<size_t>(q) * T_rows + t) * F2 + c]);
    }
    for (int a = 0; a < NB; ++a)
      ws[((static_cast<size_t>(split) * P + p) * NB + a) * F2 + c] = sums[a * NT + threadIdx.x];
  }
}

// MODE kRowsM: grid y the table's row tiles (`m_tiles`), z the positions
template <typename T, typename OutT, int MODE = kNoGroups>
cudaError_t gemm(const T* A, const T* B, OutT* C, GemmArgs g, int nsplit, cudaStream_t s,
                 Groups grp = Groups{}) {
  const int m_tiles = MODE == kRowsM ? grp.tiles : (g.M + 63) / 64;
  gemm_kernel<T, OutT, MODE><<<dim3((g.N + 63) / 64, m_tiles, g.P * nsplit), NT, 0, s>>>(
      A, B, C, g, nsplit, grp);
  return cudaGetLastError();
}

#define GAMER_TRY(...)                 \
  do {                                 \
    cudaError_t e_ = (__VA_ARGS__);    \
    if (e_ != cudaSuccess) return e_;  \
  } while (0)

// G: the grouped launch (the weights and their grads hold grp.experts
// experts, E below; otherwise E = P)
template <typename T, bool G>
int run(const T* x, const T* wgu, const T* wd, const T* btab, const int* beh, const T* gout,
        T* dx, T* dwgu, T* dwd, T* dbtab, T* dgu, T* hdrop, float* ws, int P, int T_rows, int D,
        int F, int Dout, int NB, int use_bias, int act, gamer::Seed seed, uint32_t thresh,
        float inv_keep, int n_gu, int kc_gu, int n_d, int kc_d, int n_b, int kc_b, Groups grp,
        cudaStream_t s) {
  const long long F2 = 2LL * F;
  const int E = G ? grp.experts : P;
  constexpr int KMODE = G ? kRowsK : kNoGroups;
  const int tiles = G ? grp.tiles : (T_rows + TM - 1) / TM;
  moe_bwd_act_kernel<T, G><<<dim3(tiles, P, (F + FC - 1) / FC), NT, 0, s>>>(
      x, wgu, wd, btab, beh, gout, dgu, hdrop, T_rows, D, F, Dout, NB, use_bias, act, seed,
      thresh, inv_keep, grp);
  GAMER_TRY(cudaGetLastError());
  // dx [T, D] = dgu [T, 2F] . Wgu[p]^T  (Wgu[p] is [D, 2F])
  GAMER_TRY((gemm<T, T, G ? kRowsM : kNoGroups>(dgu, wgu, dx,
                                          GemmArgs{T_rows, D, static_cast<int>(F2), P,
                                                   static_cast<int>(F2), T_rows * F2, F2, 1,
                                                   D * F2, 1, F2},
                                          1, s, grp)));
  // dWgu [D, 2F] = x^T . dgu, split over T
  GAMER_TRY((gemm<T, float, KMODE>(x, dgu, ws,
                                   GemmArgs{D, static_cast<int>(F2), T_rows, E, kc_gu,
                                            static_cast<long long>(T_rows) * D, 1, D,
                                            T_rows * F2, F2, 1},
                                   n_gu, s, grp)));
  GAMER_TRY(gamer::reduce_splits<T>(ws, dwgu, static_cast<size_t>(E) * D * F2, n_gu, s));
  // dWd [F, Dout] = h_drop^T . gout, split over T
  GAMER_TRY((gemm<T, float, KMODE>(hdrop, gout, ws,
                                   GemmArgs{F, Dout, T_rows, E, kc_d,
                                            static_cast<long long>(T_rows) * F, 1, F,
                                            static_cast<long long>(T_rows) * Dout, Dout, 1},
                                   n_d, s, grp)));
  GAMER_TRY(gamer::reduce_splits<T>(ws, dwd, static_cast<size_t>(E) * F * Dout, n_d, s));
  if (use_bias) {
    const size_t smem = sizeof(float) * NB * NT;
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    dbtab_kernel<T, G><<<dim3((static_cast<int>(F2) + NT - 1) / NT, E, n_b), NT, smem, s>>>(
        dgu, beh, ws, T_rows, static_cast<int>(F2), NB, E, kc_b, grp);
    GAMER_TRY(cudaGetLastError());
    GAMER_TRY(gamer::reduce_splits<T>(ws, dbtab, static_cast<size_t>(E) * NB * F2, n_b, s));
  }
  return cudaSuccess;
}

// ---- bf16 on the tensor cores

constexpr int TC_NT = 128;  // pass 1 threads: 4 warps x 16 rows
constexpr int P1_FC = 64;   // pass 1: F columns a CTA (gate and up each)
constexpr int P1_KT = 64;   // pass 1: depth of a streamed slice
constexpr int P1_LA = P1_KT + 8;      // x or gout slice [TM][P1_LA]
constexpr int P1_LG = 2 * P1_FC + 8;  // gate|up slice of Wgu [P1_KT][P1_LG]
constexpr int P1_LV = P1_KT + 8;      // Wd slice [P1_FC][P1_LV]
constexpr int P1_STAGE =              // bf16 elements a stage
    TM * P1_LA + (P1_KT * P1_LG > P1_FC * P1_LV ? P1_KT * P1_LG : P1_FC * P1_LV);
constexpr int P1_LDG = 2 * P1_FC + 8;  // fp32 dgu tile [TM][P1_LDG] of the dbtab sums
static_assert(TC_NT == 2 * P1_FC, "the dbtab sums take one thread a dgu column");

size_t p1_smem_bytes(int NB) {
  const size_t stages = 2 * sizeof(bf16) * P1_STAGE;
  const size_t sums = sizeof(float) * (TM * P1_LDG + static_cast<size_t>(NB) * 2 * P1_FC) +
                      sizeof(int) * TM;
  return stages > sums ? stages : sums;
}

template <bool G>
__global__ void __launch_bounds__(TC_NT, 3) moe_bwd_act_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wgu, const bf16* __restrict__ wd,
    const bf16* __restrict__ btab, const int* __restrict__ beh, const bf16* __restrict__ gout,
    bf16* __restrict__ dgu, bf16* __restrict__ hdrop, float* __restrict__ wsb, int T_rows, int D,
    int F, int Dout, int NB, int use_bias, int act, gamer::Seed seed_in, uint32_t thresh,
    float inv_keep, Groups grp) {
  const uint32_t seed = seed_in.get();
  constexpr int NJ = P1_FC / 8;  // 8-wide column tiles of g, u and dh
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);  // stage s: x or gout slice, then weights

  const int t0 = blockIdx.x * TM, p = blockIdx.y, f0 = blockIdx.z * P1_FC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int e = p;  // the expert
  if constexpr (G) {
    e = grp.expert_of_tile(blockIdx.x, p);
    if (e < 0) return;
  }
  const size_t F2 = 2 * static_cast<size_t>(F);
  const int fcols = min(P1_FC, F - f0);
  // x's and gout's rows: from t0, or (grouped) through the table from row 0
  const int r0 = G ? 0 : t0;
  const bf16* xp = x + (static_cast<size_t>(p) * T_rows + r0) * D;
  const bf16* gp = gout + (static_cast<size_t>(p) * T_rows + r0) * Dout;
  const bf16* wgup = wgu + static_cast<size_t>(e) * D * F2 + f0;
  const bf16* wdp = wd + (static_cast<size_t>(e) * F + f0) * Dout;
  const int na = (D + P1_KT - 1) / P1_KT;         // slices of g|u = x . Wgu over d
  const int ns = na + (Dout + P1_KT - 1) / P1_KT;  // then of dh = gout . Wd^T over dout

  // the tile's rows of a [T, ld] matrix at g, columns [k0, k0 + P1_KT)
  auto load_a = [&](bf16* a, const bf16* g, int ld, int k0) {
    if constexpr (G)
      load_rows_async<TM, P1_KT, TC_NT>(a, P1_LA, g + k0, ld, grp.rows + t0, TM, ld - k0);
    else
      load_block_async<TM, P1_KT, TC_NT>(a, P1_LA, g + k0, ld, T_rows - t0, ld - k0);
  };
  auto load = [&](int s) {
    bf16* a = stages + (s & 1) * P1_STAGE;
    bf16* b = a + TM * P1_LA;
    if (s < na) {
      const int k0 = s * P1_KT;
      const bf16* w = wgup + static_cast<size_t>(k0) * F2;
      load_a(a, xp, D, k0);
      load_block_async<P1_KT, P1_FC, TC_NT>(b, P1_LG, w, F2, D - k0, fcols);               // gate
      load_block_async<P1_KT, P1_FC, TC_NT>(b + P1_FC, P1_LG, w + F, F2, D - k0, fcols);  // up
    } else {
      const int k0 = (s - na) * P1_KT;
      load_a(a, gp, Dout, k0);
      load_block_async<P1_FC, P1_KT, TC_NT>(b, P1_LV, wdp + k0, Dout, fcols, Dout - k0);
    }
  };
  load(0);
  cp_async_commit();

  float g[NJ][4], u[NJ][4], dh[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) g[j][e] = u[j][e] = dh[j][e] = 0.f;

  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // slice s has landed
    __syncthreads();
    const bf16* a = stages + (s & 1) * P1_STAGE;
    const bf16* b = a + TM * P1_LA;
    if (s < na) {
#pragma unroll
      for (int kk = 0; kk < P1_KT; kk += 16) {
        uint32_t xa[4];
        ldsm_x4(xa, a_addr(a, P1_LA, warp * 16, kk, lane));
        gamer::moe::gate_up_step<NJ>(g, u, xa, b, P1_LG, kk, P1_FC, lane);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < P1_KT; kk += 16) {
        uint32_t ga[4];
        ldsm_x4(ga, a_addr(a, P1_LA, warp * 16, kk, lane));
#pragma unroll
        for (int np = 0; np < NJ / 2; ++np) {
          uint32_t wb[4];
          ldsm_x4(wb, bn_addr(b, P1_LV, np * 16, kk, lane));
          mma_bf16(dh[2 * np], ga, wb[0], wb[1]);
          mma_bf16(dh[2 * np + 1], ga, wb[2], wb[3]);
        }
      }
    }
    __syncthreads();  // stage s & 1 is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();

  // epilogue on the fragments: this thread's rows t0 + warp*16 + lane/4 (+8)
  int row[2];
  const bf16* brow[2];
  uint32_t hrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = t0 + warp * 16 + lane / 4 + 8 * i;
    if constexpr (G) row[i] = grp.row(row[i], T_rows);
    brow[i] = gamer::moe::bias_row(btab + static_cast<size_t>(e) * NB * F2,
                                   beh + static_cast<size_t>(p) * T_rows, row[i], T_rows, NB,
                                   use_bias, F2);
    hrow[i] = gamer::hash_row(seed, static_cast<uint32_t>(p), static_cast<uint32_t>(row[i]));
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int f = f0 + 8 * j + 2 * (lane % 4);  // column of e = 0 and 2; e = 1, 3 at f + 1
    const bool in = 8 * j < fcols;
    float2 bg[2], bu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) gamer::moe::bias_pair(in ? brow[i] : nullptr, f, F, bg[i], bu[i]);
    gamer::moe::with_act(act, [&](auto ac) {
      constexpr int ACT = decltype(ac)::value;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float gv = g[j][e] + ((e & 1) ? bg[i].y : bg[i].x);
        const float uv = u[j][e] + ((e & 1) ? bu[i].y : bu[i].x);
        float a, da;  // act(g) and act'(g), formed in fp32 before dgu is rounded
        gamer::moe::act_grad<true>(ACT, gv, a, da);
        float hv = a * uv, dhv = dh[j][e];
        if (thresh > 0u) {
          const bool keep =
              gamer::hash_keep_at(hrow[i], static_cast<uint32_t>(f + (e & 1)), thresh);
          hv = keep ? hv * inv_keep : 0.f;
          dhv = keep ? dhv * inv_keep : 0.f;
        }
        g[j][e] = dhv * uv * da;  // dg
        u[j][e] = dhv * a;        // du
        dh[j][e] = hv;            // h_drop
      }
    });
  }
  // dgu and h_drop rounded to bf16, stored as pairs
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= T_rows) continue;
    const size_t r = static_cast<size_t>(p) * T_rows + row[i];
    bf16* dgr = dgu + r * F2 + f0 + 2 * (lane % 4);
    bf16* hr = hdrop + r * F + f0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (8 * j >= fcols) continue;
      *reinterpret_cast<__nv_bfloat162*>(dgr + 8 * j) =
          __floats2bfloat162_rn(g[j][2 * i], g[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dgr + F + 8 * j) =
          __floats2bfloat162_rn(u[j][2 * i], u[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(hr + 8 * j) =
          __floats2bfloat162_rn(dh[j][2 * i], dh[j][2 * i + 1]);
    }
  }
  if (!use_bias) return;

  // dbtab partial sums of this row tile from the fp32 dgu: the tile goes to
  // shared memory (over the drained stages), then thread c sums column c
  // (gate columns of the chunk, then up) over the 64 rows in order, per id
  float* Dg = reinterpret_cast<float*>(smem_raw);            // [TM][P1_LDG]
  float* sums = Dg + TM * P1_LDG;                            // [NB][2 * P1_FC]
  int* bid = reinterpret_cast<int*>(sums + NB * 2 * P1_FC);  // [TM]
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* d = Dg + (warp * 16 + lane / 4 + 8 * i) * P1_LDG + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(d) = make_float2(g[j][2 * i], g[j][2 * i + 1]);
      *reinterpret_cast<float2*>(d + P1_FC) = make_float2(u[j][2 * i], u[j][2 * i + 1]);
    }
  const int c = threadIdx.x;
  if (c < TM) {
    int t = t0 + c;
    if constexpr (G) t = grp.row(t, T_rows);
    const int id = t < T_rows ? beh[static_cast<size_t>(p) * T_rows + t] : -1;
    bid[c] = (id >= 0 && id < NB) ? id : -1;
  }
  for (int a = 0; a < NB; ++a) sums[a * 2 * P1_FC + c] = 0.f;
  __syncthreads();
  for (int r = 0; r < TM; ++r) {
    const int b = bid[r];
    if (b >= 0) sums[b * 2 * P1_FC + c] += Dg[r * P1_LDG + c];
  }
  const int fl = c % P1_FC;
  if (fl < fcols) {
    float* out = wsb + (static_cast<size_t>(blockIdx.x) * gridDim.y + p) * NB * F2 +
                 (c < P1_FC ? 0 : F) + f0 + fl;
    for (int a = 0; a < NB; ++a) out[a * F2] = sums[a * 2 * P1_FC + c];
  }
}

// Pass 2: C[split][p] (M x N) = sum over the split's k of A(p) . B(p), bf16
// operands, fp32 sums. AT: A stored [k][m] (ldmatrix.trans), else [m][k];
// BT: B stored [k][n] (ldmatrix.trans), else [n][k]; lda, ldb their row
// strides and sa_p, sb_p the strides of an expert. The dimension stored in
// columns must be a multiple of 8 (16-byte copies).
constexpr int GM = 128, GN = 128, GK = 32;  // output tile, depth of a k slice
constexpr int G_NT = 256;                   // 8 warps: 2 (m) x 4 (n) of 64 x 32
constexpr int G_STAGES = 3;                 // cp.async stages of the k slices
static_assert(GK == KT, "the splits are multiples of KT rows");

struct TcGemmArgs {
  int M, N, K, P, kchunk;
  long long lda, ldb, sa_p, sb_p;
};

template <bool AT, bool BT>
struct GemmTiles {
  static constexpr int LA = (AT ? GM : GK) + 8, A_ELEMS = (AT ? GK : GM) * LA;
  static constexpr int LB = (BT ? GN : GK) + 8, B_ELEMS = (BT ? GK : GN) * LB;
  static constexpr size_t smem_bytes = sizeof(bf16) * G_STAGES * (A_ELEMS + B_ELEMS);
};

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

static_assert(GM == 2 * TM, "a 128-row tile of dx is one padded level run's pair of tiles");

template <bool AT, bool BT, typename OutT, int MODE>
__global__ void __launch_bounds__(G_NT, 2) moe_gemm_tc_kernel(const bf16* __restrict__ A,
                                                              const bf16* __restrict__ B,
                                                              OutT* __restrict__ C, TcGemmArgs g,
                                                              int nsplit, Groups grp) {
  using L = GemmTiles<AT, BT>;
  static_assert(MODE != kRowsM || (!AT && !BT), "kRowsM gathers A's rows, stored [m][k]");
  static_assert(MODE != kRowsK || (AT && BT), "kRowsK gathers both operands' rows, stored [k][.]");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // stage s: A slice
  bf16* Bs = As + G_STAGES * L::A_ELEMS;         // stage s: B slice
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM;
  int p, e, split, kb, ke;
  if (!gemm_block<MODE>(g.K, g.P, g.kchunk, nsplit, 2 * blockIdx.y, grp, p, e, split, kb, ke))
    return;
  const int nk = max(0, (ke - kb + GK - 1) / GK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // the warp's 64 x 32 of the tile
  const bf16* Ap = A + p * g.sa_p;
  const bf16* Bp = B + (MODE == kRowsM ? e : p) * g.sb_p;

  auto load = [&](int s) {
    const int k0 = kb + s * GK;
    bf16* a = As + (s % G_STAGES) * L::A_ELEMS;
    bf16* b = Bs + (s % G_STAGES) * L::B_ELEMS;
    if constexpr (MODE == kRowsK) {  // depth k0.. through the table
      load_rows_async<GK, GM, G_NT>(a, L::LA, Ap + m0, g.lda, grp.rows + k0, ke - k0, g.M - m0);
      load_rows_async<GK, GN, G_NT>(b, L::LB, Bp + n0, g.ldb, grp.rows + k0, ke - k0, g.N - n0);
      return;
    }
    if constexpr (MODE == kRowsM)  // output rows m0.. through the table
      load_rows_async<GM, GK, G_NT>(a, L::LA, Ap + k0, g.lda, grp.rows + m0, GM, ke - k0);
    else if constexpr (AT)
      load_block_async<GK, GM, G_NT>(a, L::LA, Ap + k0 * g.lda + m0, g.lda, ke - k0, g.M - m0);
    else
      load_block_async<GM, GK, G_NT>(a, L::LA, Ap + m0 * g.lda + k0, g.lda, g.M - m0, ke - k0);
    if constexpr (BT)
      load_block_async<GK, GN, G_NT>(b, L::LB, Bp + k0 * g.ldb + n0, g.ldb, ke - k0, g.N - n0);
    else
      load_block_async<GN, GK, G_NT>(b, L::LB, Bp + n0 * g.ldb + k0, g.ldb, g.N - n0, ke - k0);
  };

  float acc[4][4][4];  // [m16 tile][n8 tile][element]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<G_STAGES - 2>();  // slice kt has landed
    __syncthreads();                // and every warp is done with slice kt - 1
    if (kt + G_STAGES - 1 < nk) load(kt + G_STAGES - 1);  // into the stage of slice kt - 1
    cp_async_commit();
    const bf16* a = As + (kt % G_STAGES) * L::A_ELEMS;
    const bf16* b = Bs + (kt % G_STAGES) * L::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      uint32_t bf[2][4];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        if constexpr (BT)
          ldsm_x4_trans(bf[ni], bk_addr(b, L::LB, kk, wn + ni * 16, lane));
        else
          ldsm_x4(bf[ni], bn_addr(b, L::LB, wn + ni * 16, kk, lane));
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t af[4];
        if constexpr (AT)
          ldsm_x4_trans(af, at_addr(a, L::LA, kk, wm + mi * 16, lane));
        else
          ldsm_x4(af, a_addr(a, L::LA, wm + mi * 16, kk, lane));
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          mma_bf16(acc[mi][2 * ni], af, bf[ni][0], bf[ni][1]);
          mma_bf16(acc[mi][2 * ni + 1], af, bf[ni][2], bf[ni][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  OutT* Cp = C + (static_cast<size_t>(split) * g.P + (MODE == kRowsK ? e : p)) * g.M * g.N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int m = m0 + wm + mi * 16 + lane / 4 + 8 * i;
      if constexpr (MODE == kRowsM) {
        m = grp.rows[m];
        if (m < 0) continue;
      } else if (m >= g.M) {
        continue;
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = n0 + wn + nj * 8 + 2 * (lane % 4);
        if (n < g.N)
          store_pair(Cp + static_cast<size_t>(m) * g.N + n, acc[mi][nj][2 * i],
                     acc[mi][nj][2 * i + 1]);
      }
    }
}

template <bool AT, bool BT, typename OutT, int MODE = kNoGroups>
cudaError_t gemm_tc(const bf16* A, const bf16* B, OutT* C, TcGemmArgs g, int nsplit,
                    cudaStream_t s, Groups grp = Groups{}) {
  constexpr size_t smem = GemmTiles<AT, BT>::smem_bytes;
  GAMER_TRY(cudaFuncSetAttribute(moe_gemm_tc_kernel<AT, BT, OutT, MODE>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem)));
  const int m_tiles = MODE == kRowsM ? grp.tiles / 2 : (g.M + GM - 1) / GM;
  moe_gemm_tc_kernel<AT, BT, OutT, MODE>
      <<<dim3((g.N + GN - 1) / GN, m_tiles, g.P * nsplit), G_NT, smem, s>>>(A, B, C, g, nsplit,
                                                                           grp);
  return cudaGetLastError();
}

// Grouped dbtab[w][i] = the sum over the row tiles of expert w's level run
// of pass 1's sums wsb[tile][p][i] at w's position p (i over NB * 2F), in
// order of the tiles; zero for an expert of no level.
__global__ void moe_bwd_dbtab_sum_kernel(const float* __restrict__ wsb, bf16* __restrict__ dbtab,
                                         int n, Groups grp) {
  const int w = blockIdx.y;
  int p = 0, lo = 0, hi = 0;
  grp.run_of_expert(w, p, lo, hi);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int tile = lo / TM; tile < hi / TM; ++tile)
      sum += wsb[(static_cast<size_t>(tile) * grp.positions + p) * n + i];
    dbtab[static_cast<size_t>(w) * n + i] = __float2bfloat16(sum);
  }
}

// n_b / kc_b: the bf16 route sums dbtab per 64-row tile in pass 1, so its
// splits are the row tiles (n_b = ceil(T / 64), or the table's tiles when
// grouped); kc_b is not read. G: the grouped launch (the weights and their
// grads hold grp.experts experts, E below; otherwise E = P).
template <bool G>
int run_bf16(const bf16* x, const bf16* wgu, const bf16* wd, const bf16* btab, const int* beh,
             const bf16* gout, bf16* dx, bf16* dwgu, bf16* dwd, bf16* dbtab, bf16* dgu,
             bf16* hdrop, float* ws, int P, int T_rows, int D, int F, int Dout, int NB,
             int use_bias, int act, gamer::Seed seed, uint32_t thresh, float inv_keep, int n_gu,
             int kc_gu, int n_d, int kc_d, int n_b, int /*kc_b*/, Groups grp, cudaStream_t s) {
  const long long F2 = 2LL * F;
  const int E = G ? grp.experts : P;
  constexpr int KMODE = G ? kRowsK : kNoGroups;
  const size_t smem = p1_smem_bytes(NB);
  GAMER_TRY(cudaFuncSetAttribute(moe_bwd_act_tc_kernel<G>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem)));
  moe_bwd_act_tc_kernel<G><<<dim3(n_b, P, (F + P1_FC - 1) / P1_FC), TC_NT, smem, s>>>(
      x, wgu, wd, btab, beh, gout, dgu, hdrop, ws, T_rows, D, F, Dout, NB, use_bias, act, seed,
      thresh, inv_keep, grp);
  GAMER_TRY(cudaGetLastError());
  if (use_bias) {
    const size_t n = static_cast<size_t>(NB) * F2;
    if constexpr (G) {
      moe_bwd_dbtab_sum_kernel<<<dim3(static_cast<int>((n + 255) / 256), E), 256, 0, s>>>(
          ws, dbtab, static_cast<int>(n), grp);
      GAMER_TRY(cudaGetLastError());
    } else {
      GAMER_TRY(gamer::reduce_splits<bf16>(ws, dbtab, P * n, n_b, s));
    }
  }
  // dx [T, D] = dgu [T, 2F] . Wgu[p]^T  (dgu [m][k], Wgu[p] [n][k])
  GAMER_TRY((gemm_tc<false, false, bf16, G ? kRowsM : kNoGroups>(
      dgu, wgu, dx, TcGemmArgs{T_rows, D, static_cast<int>(F2), P, static_cast<int>(F2), F2, F2,
                               T_rows * F2, D * F2},
      1, s, grp)));
  // dWgu [D, 2F] = x^T . dgu, split over T  (x [k][m], dgu [k][n])
  GAMER_TRY((gemm_tc<true, true, float, KMODE>(
      x, dgu, ws, TcGemmArgs{D, static_cast<int>(F2), T_rows, E, kc_gu, D, F2,
                             static_cast<long long>(T_rows) * D, T_rows * F2},
      n_gu, s, grp)));
  GAMER_TRY(gamer::reduce_splits<bf16>(ws, dwgu, static_cast<size_t>(E) * D * F2, n_gu, s));
  // dWd [F, Dout] = h_drop^T . gout, split over T  (h_drop [k][m], gout [k][n])
  GAMER_TRY((gemm_tc<true, true, float, KMODE>(
      hdrop, gout, ws, TcGemmArgs{F, Dout, T_rows, E, kc_d, F, Dout,
                                  static_cast<long long>(T_rows) * F,
                                  static_cast<long long>(T_rows) * Dout},
      n_d, s, grp)));
  return gamer::reduce_splits<bf16>(ws, dwd, static_cast<size_t>(E) * F * Dout, n_d, s);
}

template <bool G>
int dispatch(const void* x, const void* wgu, const void* wd, const void* btab, const int* beh,
             const void* gout, void* dx, void* dwgu, void* dwd, void* dbtab, void* dgu,
             void* hdrop, float* ws, int P, int T_rows, int D, int F, int Dout, int NB,
             int use_bias, int act, gamer::Seed seed, unsigned int thresh, float inv_keep,
             int n_gu, int kc_gu, int n_d, int kc_d, int n_b, int kc_b, int dtype, Groups grp,
             cudaStream_t s) {
  if (P <= 0 || T_rows <= 0 || D <= 0 || F <= 0 || Dout <= 0 || NB <= 0 || n_gu <= 0 ||
      n_d <= 0 || n_b <= 0 || kc_gu % KT || kc_d % KT || act < 0 || act > 2)
    return cudaErrorInvalidValue;
#define GAMER_RUN(FN, TYPE)                                                                 \
  FN(static_cast<const TYPE*>(x), static_cast<const TYPE*>(wgu),                           \
            static_cast<const TYPE*>(wd), static_cast<const TYPE*>(btab), beh,             \
            static_cast<const TYPE*>(gout), static_cast<TYPE*>(dx), static_cast<TYPE*>(dwgu), \
            static_cast<TYPE*>(dwd), static_cast<TYPE*>(dbtab), static_cast<TYPE*>(dgu),   \
            static_cast<TYPE*>(hdrop), ws, P, T_rows, D, F, Dout, NB, use_bias, act, seed, thresh, \
            inv_keep, n_gu, kc_gu, n_d, kc_d, n_b, kc_b, grp, s)
  if (dtype == gamer::kFloat32) return GAMER_RUN((run<float, G>), float);
  if (dtype == gamer::kBFloat16) {
    const void* ptrs[] = {x, wgu, wd, btab, gout, dx, dwgu, dwd, dbtab, dgu, hdrop};
    uintptr_t addr = 0;
    for (const void* t : ptrs) addr |= reinterpret_cast<uintptr_t>(t);
    const int tiles = G ? grp.tiles : (T_rows + TM - 1) / TM;
    if (D % 16 || F % 16 || Dout % 16 || addr % 16 || n_b != tiles) return cudaErrorInvalidValue;
    return GAMER_RUN(run_bf16<G>, bf16);
  }
#undef GAMER_RUN
  return cudaErrorInvalidValue;
}

}  // namespace

// All tensors contiguous in dtype (gamer::DType: bf16 -> tensor-core
// kernels, fp32 -> CUDA-core kernels) except beh (int32 [P, T]) and ws (fp32
// scratch of at least max(n_gu*P*D*2F, n_d*P*F*Dout, n_b*P*NB*2F) floats).
// dgu [P, T, 2F] and hdrop [P, T, F] are scratch too. n_* / kc_* are the
// number of splits over T and the rows a split covers (a multiple of 32 for
// the products) of dWgu, dWd and dbtab; in bf16 n_b must be ceil(T / 64),
// the row tiles of pass 1. act: gamer::moe::Act. Any D, F and Dout in fp32
// and, in multiples of 16 (the wrapper pads), in bf16: both passes stream
// their products over depth. The bf16 tensors 16-byte aligned. With
// use_bias = 0, dbtab is not written.
// rows = null: the ungrouped launch. Otherwise the grouped one (G), on the
// table of `gamer_fused_moe_fwd`: wgu, wd, btab and their grads hold
// `experts` (E) experts; ws holds at least max(n_gu*E*D*2F, n_d*E*F*Dout)
// floats and, with bias, tiles*P*NB*2F in bf16 (n_b = tiles) or
// n_b*E*NB*2F in fp32; n_gu, n_d and n_b (fp32) are the ranges of a level's
// run; kc_* are not read. dx comes zeroed (rows of no level are not
// written).
extern "C" int gamer_fused_moe_bwd(const void* x, const void* wgu, const void* wd,
                                   const void* btab, const int* beh, const void* gout, void* dx,
                                   void* dwgu, void* dwd, void* dbtab, void* dgu, void* hdrop,
                                   float* ws, int P, int T_rows, int D, int F, int Dout, int NB,
                                   int use_bias, int act, const unsigned int* seed_ptr,
                                   unsigned int seed_add, unsigned int thresh,
                                   float inv_keep, int n_gu, int kc_gu, int n_d, int kc_d,
                                   int n_b, int kc_b, int dtype, const int* rows,
                                   const int* tile_level, const int* level_tile, int tiles,
                                   int levels, int first, int experts, void* stream) {
  const gamer::Seed seed{seed_ptr, seed_add};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == nullptr)
    return dispatch<false>(x, wgu, wd, btab, beh, gout, dx, dwgu, dwd, dbtab, dgu, hdrop, ws, P,
                           T_rows, D, F, Dout, NB, use_bias, act, seed, thresh, inv_keep, n_gu,
                           kc_gu, n_d, kc_d, n_b, kc_b, dtype, Groups{}, s);
  if (tiles <= 0 || tiles % 2 || levels <= 0 || experts <= 0) return cudaErrorInvalidValue;
  return dispatch<true>(x, wgu, wd, btab, beh, gout, dx, dwgu, dwd, dbtab, dgu, hdrop, ws, P,
                        T_rows, D, F, Dout, NB, use_bias, act, seed, thresh, inv_keep, n_gu,
                        kc_gu, n_d, kc_d, n_b, kc_b, dtype,
                        Groups{rows, tile_level, level_tile, tiles, levels, first, experts, P},
                        s);
}
