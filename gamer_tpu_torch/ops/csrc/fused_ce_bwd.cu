// Fused tied-head cross-entropy backward.
//
// Replaces the TPU kernel gamer_tpu/ops/pallas_ce.py `_ce_bwd_kernel`
// (pallas_call in `_ce_bwd_rule`). With the forward's lse (fused_ce_fwd.cu)
// and the incoming gradient g [N] of the per-row nll:
//     p    = exp(logit * inv_t - lse)                 logit = h . E[v]
//     dlog = (p - onehot(target)) * g * inv_t         valid rows, else 0
//     dh   = dlog E          dE = dlog^T h            (fp32 sums)
// The TPU kernel sums dE across its sequential row-tile grid. CUDA blocks run
// in no order, so two kernels each own their outputs:
//   dh kernel, one CTA per 64-row tile, walks the vocabulary in 64-row
//     chunks of E, recomputes that chunk's logits and accumulates dh;
//   dE kernel, one CTA per (64-row vocab tile, chunk of rows), holds its E
//     tile, walks its rows in 64-row tiles recomputing the logits, and writes
//     fp32 partial sums of dE; `gamer::reduce_splits` adds the row chunks in
//     order and casts to the table's dtype. V 1041 gives only 17 vocab
//     tiles, so the rows are split to fill the 132 SMs.
// Neither the [N, V] logits nor dlog reach device memory; the price is that
// both kernels recompute the logits (four N x V x D products where the
// function needs three). A kernel that recomputed them once for both halves
// would need fp32 atomics on dh or a dh workspace per vocab tile. Columns
// >= V are masked, so V needs no padding; a target outside [0, V) matches no
// column; deterministic (no atomics, split partials added in a fixed order).
//
// Bound on H100: operations, 3 * 2*N*V*D multiply-adds of the function
// against h, E, dh and dE moved once.
//
// Dispatch by dtype, in the C entry point before any launch:
//  - bf16: `ce_dh_tc_kernel` and `ce_de_tc_kernel` on the tensor cores
//    (mma.sync m16n8k16, fp32 accumulators; mma.cuh), 4 warps a CTA, the
//    streamed tiles (E chunks, h tiles) double-buffered with 16-byte
//    cp.async. The dh kernel owns 16 rows a warp: logits = h.E^T (E stored
//    [n][k], plain ldmatrix), dlog formed on the accumulator fragments,
//    rounded to bf16 and packed straight into the A fragments of
//    dh += dlog.E (E through ldmatrix.trans). The dE kernel owns 16 vocab
//    rows a warp and computes the transposed logits E_tile.h^T, so dlog^T is
//    already the A operand of dE += dlog^T.h (h through ldmatrix.trans). The
//    bf16 rounding of dlog before both products is the TPU kernel's
//    (pallas_ce.py:77). D is padded to DP (64, 128 or 256) with zero columns
//    in shared memory.
//  - fp32: `ce_dh_kernel` and `ce_de_kernel`, fp32 FMA on the CUDA cores
//    from shared memory, dlog kept in fp32.
//  - D > 256 (both dtypes): `ce_dh_wide*` and `ce_de_wide*`. The h and E
//    tiles no longer fit in shared memory whole, nor a 16 x D accumulator in
//    a warp's registers, so the output columns (dh, dE) are tiled over the
//    grid (128 a CTA in bf16, 256 in fp32) and every CTA streams its logits
//    over D in slices (stream_tc.cuh in bf16, 32-deep fp32 slices), then
//    multiplies dlog by the one column block of E (or h) it owns. The price
//    is that each column block recomputes the logits: D / 128 (D / 256) times
//    the logits work of the narrow kernels.
//
// Where this goes wrong, and what the bf16 kernels do about it:
//  - fragment coordinates: in the dh kernel an accumulator element is (row
//    warp*16 + lane/4 (+8), vocab column 8j + 2*(lane%4) + {0,1}); in the dE
//    kernel (vocab row, h row) the other way round, so the onehot there is
//    "vocab row == target of the column". A wrong map passes any test whose
//    targets fall in one chunk, so the tests put targets in every chunk and
//    in the ragged last one (V - 1);
//  - registers at D 256: a warp's 16 x 256 fp32 dh (or dE) accumulator is
//    128 registers a thread, so each 64-column chunk is multiplied in steps
//    of 32 columns (32 logits a thread, not 64) and h (or E) is read from
//    shared memory per product, not held in registers;
//  - ragged edges: cp.async zero-fills rows past N and V; rows past N and
//    invalid rows have g * inv_t = 0, so their dlog and dh are exactly 0.

#include "common.cuh"
#include "mma.cuh"
#include "stream_tc.cuh"

namespace {

using namespace gamer::tc;

constexpr int TM = 64;      // rows a tile
constexpr int VC = 64;      // vocab rows a tile
constexpr int NT = 256;     // fp32 kernel threads: 16 row groups x 16 column lanes
constexpr int DMAX = 256;   // widest D of the narrow kernels (dh / dE columns a thread: DMAX / 16)
constexpr int DJ = DMAX / 16;
constexpr int TC_NT = 128;  // bf16 kernel threads: 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(TM) * (D + 1) + VC * (D + 1) + TM * (VC + 1) +
                          2 * TM) +
         sizeof(int) * TM;
}

struct Smem {
  float *Hs, *Es, *Ls, *lse_s, *gv_s;
  int* tgt;
  __device__ Smem(float* smem, int D) {
    Hs = smem;                  // [TM][D+1]
    Es = Hs + TM * (D + 1);     // [VC][D+1]
    Ls = Es + VC * (D + 1);     // [TM][VC+1]  dlog
    lse_s = Ls + TM * (VC + 1);  // [TM]
    gv_s = lse_s + TM;          // [TM]  valid ? g * inv_t : 0
    tgt = reinterpret_cast<int*>(gv_s + TM);
  }
};

__device__ void load_rows(const Smem& m, const float* h, const int* targets, const int* valid,
                          const float* lse, const float* g, int n0, int N, int D, float inv_t) {
  for (int idx = threadIdx.x; idx < TM * D; idx += NT) {
    const int r = idx / D, c = idx % D, n = n0 + r;
    m.Hs[r * (D + 1) + c] = n < N ? h[static_cast<size_t>(n) * D + c] : 0.f;
  }
  for (int r = threadIdx.x; r < TM; r += NT) {
    const int n = n0 + r;
    const bool in = n < N;
    m.tgt[r] = in ? targets[n] : -1;
    m.lse_s[r] = in ? lse[n] : 0.f;
    m.gv_s[r] = (in && valid[n] == 1) ? g[n] * inv_t : 0.f;
  }
}

__device__ void load_vocab(const Smem& m, const float* table, int v0, int V, int D) {
  for (int idx = threadIdx.x; idx < VC * D; idx += NT) {
    const int r = idx / D, c = idx % D, v = v0 + r;
    m.Es[r * (D + 1) + c] = v < V ? table[static_cast<size_t>(v) * D + c] : 0.f;
  }
}

// dlog of the loaded (row tile, vocab tile) into Ls; thread (ty, tx) computes
// rows ty + 16i and vocab columns tx + 16j.
__device__ void tile_dlog(const Smem& m, int v0, int V, int D, float inv_t) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < D; ++k) {
    float ha[4], eb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ha[i] = m.Hs[(ty + 16 * i) * (D + 1) + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) eb[j] = m.Es[(tx + 16 * j) * (D + 1) + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ha[i], eb[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int col = v0 + c;
      float d = 0.f;
      if (col < V) {
        const float p = expf(acc[i][j] * inv_t - m.lse_s[r]);
        d = (p - (col == m.tgt[r] ? 1.f : 0.f)) * m.gv_s[r];
      }
      m.Ls[r * (VC + 1) + c] = d;
    }
  }
}

__global__ void __launch_bounds__(NT) ce_dh_kernel(
    const float* __restrict__ h, const float* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, const float* __restrict__ lse, const float* __restrict__ g,
    float* __restrict__ dh, int N, int D, int V, float inv_t) {
  extern __shared__ float smem[];
  const Smem m(smem, D);
  const int n0 = blockIdx.x * TM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows(m, h, targets, valid, lse, g, n0, N, D, inv_t);
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int v0 = 0; v0 < V; v0 += VC) {
    __syncthreads();
    load_vocab(m, table, v0, V, D);
    __syncthreads();
    tile_dlog(m, v0, V, D, inv_t);
    __syncthreads();
    for (int c = 0; c < VC; ++c) {
      float dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dl[i] = m.Ls[(ty + 16 * i) * (VC + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float e = m.Es[c * (D + 1) + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dl[i], e, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dh[static_cast<size_t>(n) * D + d] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(NT) ce_de_kernel(
    const float* __restrict__ h, const float* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, const float* __restrict__ lse, const float* __restrict__ g,
    float* __restrict__ ws, int N, int D, int V, float inv_t, int tiles_per_split) {
  extern __shared__ float smem[];
  const Smem m(smem, D);
  const int v0 = blockIdx.x * VC;
  const int split = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_vocab(m, table, v0, V, D);
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int nb = split * tiles_per_split * TM;
  const int ne = min(N, nb + tiles_per_split * TM);
  for (int n0 = nb; n0 < ne; n0 += TM) {
    __syncthreads();
    load_rows(m, h, targets, valid, lse, g, n0, N, D, inv_t);
    __syncthreads();
    tile_dlog(m, v0, V, D, inv_t);
    __syncthreads();
    for (int r = 0; r < TM; ++r) {
      float dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dl[i] = m.Ls[r * (VC + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float hv = m.Hs[r * (D + 1) + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dl[i], hv, acc[i][j]);
        }
      }
    }
  }

  float* out = ws + static_cast<size_t>(split) * V * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ty + 16 * i;
    if (v >= V) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) out[static_cast<size_t>(v) * D + d] = acc[i][j];
    }
  }
}

// ---- bf16 on the tensor cores

template <int DP>
constexpr size_t dh_tc_smem_bytes() {
  return sizeof(bf16) * (TM + 2 * VC) * (DP + 8);  // h tile, 2 stages of E chunks
}

template <int DP>
constexpr size_t de_tc_smem_bytes() {
  // E tile, 2 stages of h tiles and of their rows' (lse * log2 e, g * inv_t)
  // and targets
  return sizeof(bf16) * (VC + 2 * TM) * (DP + 8) + 2 * TM * (sizeof(float2) + sizeof(int));
}

// The thread's logits in base 2 minus lse, exponentiated, less the onehot,
// times g * inv_t: dlog of one accumulator element.
__device__ __forceinline__ float dlog_of(float s, float sl2, float lse2, bool hit, float gv) {
  return (exp2f(fmaf(s, sl2, -lse2)) - (hit ? 1.f : 0.f)) * gv;
}

template <int DP>
__global__ void __launch_bounds__(TC_NT, 2) ce_dh_tc_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, const float* __restrict__ lse, const float* __restrict__ g,
    bf16* __restrict__ dh, int N, int D, int V, float inv_t) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;              // k16 steps of the logits product
  constexpr int NDT = DP / 8;              // 8-wide dh column tiles
  constexpr int VS = DP > 128 ? 32 : 64;   // vocab columns a step (registers)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Hs = reinterpret_cast<bf16*>(smem_raw);  // [TM][LD]
  bf16* Es = Hs + TM * LD;                       // stage s: [VC][LD]

  const int n0 = blockIdx.x * TM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = (V + VC - 1) / VC;
  const float sl2 = inv_t * LOG2E;

  // this thread's two rows, n0 + warp*16 + lane/4 and + 8: target, lse * log2 e, g * inv_t
  int row[2], tgt[2];
  float lse2[2], gv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = n0 + warp * 16 + lane / 4 + 8 * i;
    const bool in = row[i] < N;
    const int t = in ? targets[row[i]] : -1;
    tgt[i] = (t >= 0 && t < V) ? t : -1;
    lse2[i] = in ? lse[row[i]] * LOG2E : 0.f;
    gv[i] = (in && valid[row[i]] == 1) ? g[row[i]] * inv_t : 0.f;
  }

  load_tile_async<TM, DP, TC_NT>(Hs, h, D, n0, N, D);
  load_tile_async<VC, DP, TC_NT>(Es, table, D, 0, V, D);
  cp_async_commit();

  float acc[NDT][4];
#pragma unroll
  for (int c = 0; c < NDT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int t = 0; t < nv; ++t) {
    if (t + 1 < nv)
      load_tile_async<VC, DP, TC_NT>(Es + ((t + 1) & 1) * VC * LD, table, D, (t + 1) * VC, V,
                                     D);
    cp_async_commit();
    cp_async_wait<1>();  // chunk t (and the h tile) have landed
    __syncthreads();
    const bf16* Et = Es + (t & 1) * VC * LD;
    const int v0 = t * VC;

#pragma unroll
    for (int vs = 0; vs < VC; vs += VS) {
      // logits: 16 rows x VS vocab columns a warp
      float s[VS / 8][4];
#pragma unroll
      for (int j = 0; j < VS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ha[4];
        ldsm_x4(ha, a_addr(Hs, LD, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < VS / 16; ++np) {
          uint32_t eb[4];
          ldsm_x4(eb, bn_addr(Et, LD, vs + np * 16, kk * 16, lane));
          mma_bf16(s[2 * np], ha, eb[0], eb[1]);
          mma_bf16(s[2 * np + 1], ha, eb[2], eb[3]);
        }
      }
      // dlog on the fragments; 0 on columns >= V
#pragma unroll
      for (int j = 0; j < VS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = v0 + vs + 8 * j + 2 * (lane % 4) + (e & 1);
          const int i = e >> 1;
          s[j][e] = c < V ? dlog_of(s[j][e], sl2, lse2[i], c == tgt[i], gv[i]) : 0.f;
        }
      // dh += dlog E: dlog rounded to bf16 as A fragments, E through ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < VS / 16; ++kc) {
        const uint32_t da[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                                pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                                pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                                pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int np = 0; np < NDT / 2; ++np) {
          uint32_t eb[4];
          ldsm_x4_trans(eb, bk_addr(Et, LD, vs + kc * 16, np * 16, lane));
          mma_bf16(acc[2 * np], da, eb[0], eb[1]);
          mma_bf16(acc[2 * np + 1], da, eb[2], eb[3]);
        }
      }
    }
    __syncthreads();  // stage t & 1 is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= N) continue;
    bf16* out = dh + static_cast<size_t>(row[i]) * D + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < NDT; ++c)
      if (8 * c < D)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) =
            __floats2bfloat162_rn(acc[c][2 * i], acc[c][2 * i + 1]);
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_NT, 2) ce_de_tc_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, const float* __restrict__ lse, const float* __restrict__ g,
    float* __restrict__ ws, int N, int D, int V, float inv_t, int tiles_per_split) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;              // k16 steps of the logits product
  constexpr int NDT = DP / 8;              // 8-wide dE column tiles
  constexpr int RS = DP > 128 ? 32 : 64;   // h rows (columns of dlog^T) a step (registers)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Es = reinterpret_cast<bf16*>(smem_raw);                 // [VC][LD]
  bf16* Hs = Es + VC * LD;                                      // stage s: [TM][LD]
  float2* rinf = reinterpret_cast<float2*>(Hs + 2 * TM * LD);   // stage s: [TM]
  int* rtgt = reinterpret_cast<int*>(rinf + 2 * TM);            // stage s: [TM]

  const int v0 = blockIdx.x * VC;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float sl2 = inv_t * LOG2E;
  const int nb = split * tiles_per_split * TM;  // this split's first row
  const int nt = max(0, min(tiles_per_split, (N - nb + TM - 1) / TM));

  // this thread's two vocab rows: v0 + warp*16 + lane/4 and + 8
  int vrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) vrow[i] = v0 + warp * 16 + lane / 4 + 8 * i;

  auto load_h = [&](int it) {
    const int st = it & 1, r0 = nb + it * TM;
    load_tile_async<TM, DP, TC_NT>(Hs + st * TM * LD, h, D, r0, N, D);
    for (int r = threadIdx.x; r < TM; r += TC_NT) {
      const int n = r0 + r;
      const bool in = n < N;
      const int t = in ? targets[n] : -1;
      rinf[st * TM + r] = in ? make_float2(lse[n] * LOG2E, valid[n] == 1 ? g[n] * inv_t : 0.f)
                             : make_float2(0.f, 0.f);
      rtgt[st * TM + r] = (t >= 0 && t < V) ? t : -1;
    }
  };

  load_tile_async<VC, DP, TC_NT>(Es, table, D, v0, V, D);
  if (nt > 0) load_h(0);
  cp_async_commit();

  float acc[NDT][4];
#pragma unroll
  for (int c = 0; c < NDT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int it = 0; it < nt; ++it) {
    if (it + 1 < nt) load_h(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and the E tile) have landed
    __syncthreads();
    const int st = it & 1;
    const bf16* Ht = Hs + st * TM * LD;
    const float2* ri = rinf + st * TM;
    const int* rt = rtgt + st * TM;

#pragma unroll
    for (int rs = 0; rs < TM; rs += RS) {
      // transposed logits: this warp's 16 vocab rows x RS h rows, h stored [n][k]
      float sT[RS / 8][4];
#pragma unroll
      for (int j = 0; j < RS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ea[4];
        ldsm_x4(ea, a_addr(Es, LD, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < RS / 16; ++np) {
          uint32_t hb[4];
          ldsm_x4(hb, bn_addr(Ht, LD, rs + np * 16, kk * 16, lane));
          mma_bf16(sT[2 * np], ea, hb[0], hb[1]);
          mma_bf16(sT[2 * np + 1], ea, hb[2], hb[3]);
        }
      }
      // dlog^T: the onehot is "vocab row == target of the column's h row"
#pragma unroll
      for (int j = 0; j < RS / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = rs + 8 * j + 2 * (lane % 4) + cc;
          const float2 lg = ri[c];
          const int tg = rt[c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + cc;
            sT[j][e] = dlog_of(sT[j][e], sl2, lg.x, vrow[i] == tg, lg.y);
          }
        }
      // dE += dlog^T h: dlog^T rounded to bf16 as A fragments, h through ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < RS / 16; ++kc) {
        const uint32_t da[4] = {pack_bf16(sT[2 * kc][0], sT[2 * kc][1]),
                                pack_bf16(sT[2 * kc][2], sT[2 * kc][3]),
                                pack_bf16(sT[2 * kc + 1][0], sT[2 * kc + 1][1]),
                                pack_bf16(sT[2 * kc + 1][2], sT[2 * kc + 1][3])};
#pragma unroll
        for (int np = 0; np < NDT / 2; ++np) {
          uint32_t hb[4];
          ldsm_x4_trans(hb, bk_addr(Ht, LD, rs + kc * 16, np * 16, lane));
          mma_bf16(acc[2 * np], da, hb[0], hb[1]);
          mma_bf16(acc[2 * np + 1], da, hb[2], hb[3]);
        }
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();

  float* out = ws + static_cast<size_t>(split) * V * D + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (vrow[i] >= V) continue;
#pragma unroll
    for (int c = 0; c < NDT; ++c)
      if (8 * c < D)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(vrow[i]) * D + 8 * c) =
            make_float2(acc[c][2 * i], acc[c][2 * i + 1]);
  }
}

// ---- D > 256: output columns tiled over the grid, logits streamed over D

constexpr int W_KT = 32;    // fp32: depth of a streamed slice
constexpr int W_DT = 256;   // fp32: dh / dE columns a CTA
constexpr int W_DO = 128;   // bf16: dh / dE columns a CTA
constexpr int W_LO = W_DO + 8;

size_t wide_f32_smem_bytes() {
  // A and B slices [64][W_KT+1], dlog [TM][VC+1], the owned column block
  // [64][W_DT+1], then the rows' lse, g * inv_t and targets
  return sizeof(float) * (2 * 64 * (W_KT + 1) + TM * (VC + 1) + 64 * (W_DT + 1) + 2 * TM) +
         sizeof(int) * TM;
}

struct WideSmem {
  float *As, *Bs, *Ls, *Os, *lse_s, *gv_s;
  int* tgt;
  __device__ explicit WideSmem(float* smem) {
    As = smem;                      // [64][W_KT+1]  slice of h rows
    Bs = As + 64 * (W_KT + 1);      // [64][W_KT+1]  slice of E rows
    Ls = Bs + 64 * (W_KT + 1);      // [TM][VC+1]    dlog
    Os = Ls + TM * (VC + 1);        // [64][W_DT+1]  the owned columns of E (dh) or h (dE)
    lse_s = Os + 64 * (W_DT + 1);   // [TM]
    gv_s = lse_s + TM;              // [TM]
    tgt = reinterpret_cast<int*>(gv_s + TM);
  }
};

// dlog of h rows n0.. x vocab rows v0.. into Ls, the logits streamed over D
// in W_KT slices (thread (ty, tx): rows ty + 16i, columns tx + 16j); the
// rows' lse_s, gv_s and tgt must be in shared memory.
__device__ void wide_dlog_f32(const WideSmem& m, const float* h, int n0, int N, const float* table,
                              int v0, int V, int D, float inv_t) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += W_KT) {
    __syncthreads();  // the previous slice's reads are done
    for (int idx = threadIdx.x; idx < 64 * W_KT; idx += NT) {
      const int r = idx / W_KT, kk = idx % W_KT, k = k0 + kk;
      m.As[r * (W_KT + 1) + kk] =
          (n0 + r < N && k < D) ? h[static_cast<size_t>(n0 + r) * D + k] : 0.f;
      m.Bs[r * (W_KT + 1) + kk] =
          (v0 + r < V && k < D) ? table[static_cast<size_t>(v0 + r) * D + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < W_KT; ++kk) {
      float ha[4], eb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ha[i] = m.As[(ty + 16 * i) * (W_KT + 1) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) eb[j] = m.Bs[(tx + 16 * j) * (W_KT + 1) + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ha[i], eb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, col = v0 + c;
      float d = 0.f;
      if (col < V) {
        const float p = expf(acc[i][j] * inv_t - m.lse_s[r]);
        d = (p - (col == m.tgt[r] ? 1.f : 0.f)) * m.gv_s[r];
      }
      m.Ls[r * (VC + 1) + c] = d;
    }
  }
}

__device__ void wide_rows_f32(const WideSmem& m, const int* targets, const int* valid,
                              const float* lse, const float* g, int n0, int N, float inv_t) {
  for (int r = threadIdx.x; r < TM; r += NT) {
    const int n = n0 + r;
    const bool in = n < N;
    m.tgt[r] = in ? targets[n] : -1;
    m.lse_s[r] = in ? lse[n] : 0.f;
    m.gv_s[r] = (in && valid[n] == 1) ? g[n] * inv_t : 0.f;
  }
}

// the [64][W_DT] block of a [rows, D] matrix at (r0, c0) into Os
__device__ void wide_block_f32(const WideSmem& m, const float* a, int r0, int rows, int c0, int D) {
  for (int idx = threadIdx.x; idx < 64 * W_DT; idx += NT) {
    const int r = idx / W_DT, c = idx % W_DT;
    m.Os[r * (W_DT + 1) + c] =
        (r0 + r < rows && c0 + c < D) ? a[static_cast<size_t>(r0 + r) * D + c0 + c] : 0.f;
  }
}

__global__ void __launch_bounds__(NT) ce_dh_wide_kernel(
    const float* __restrict__ h, const float* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, const float* __restrict__ lse, const float* __restrict__ g,
    float* __restrict__ dh, int N, int D, int V, float inv_t) {
  extern __shared__ float smem[];
  const WideSmem m(smem);
  const int n0 = blockIdx.x * TM, c0 = blockIdx.y * W_DT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  wide_rows_f32(m, targets, valid, lse, g, n0, N, inv_t);
  float acc[4][W_DT / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < W_DT / 16; ++j) acc[i][j] = 0.f;
  for (int v0 = 0; v0 < V; v0 += VC) {
    wide_dlog_f32(m, h, n0, N, table, v0, V, D, inv_t);
    wide_block_f32(m, table, v0, V, c0, D);
    __syncthreads();
    for (int c = 0; c < VC; ++c) {
      float dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dl[i] = m.Ls[(ty + 16 * i) * (VC + 1) + c];
#pragma unroll
      for (int j = 0; j < W_DT / 16; ++j) {
        const float e = m.Os[c * (W_DT + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dl[i], e, acc[i][j]);
      }
    }
    __syncthreads();  // Ls and Os are rewritten for the next chunk
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < W_DT / 16; ++j) {
      const int d = c0 + tx + 16 * j;
      if (d < D) dh[static_cast<size_t>(n) * D + d] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(NT) ce_de_wide_kernel(
    const float* __restrict__ h, const float* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, const float* __restrict__ lse, const float* __restrict__ g,
    float* __restrict__ ws, int N, int D, int V, float inv_t, int tiles_per_split) {
  extern __shared__ float smem[];
  const WideSmem m(smem);
  const int v0 = blockIdx.x * VC, split = blockIdx.y, c0 = blockIdx.z * W_DT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][W_DT / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < W_DT / 16; ++j) acc[i][j] = 0.f;
  const int nb = split * tiles_per_split * TM;
  const int ne = min(N, nb + tiles_per_split * TM);
  for (int n0 = nb; n0 < ne; n0 += TM) {
    wide_rows_f32(m, targets, valid, lse, g, n0, N, inv_t);  // read after the next sync
    wide_dlog_f32(m, h, n0, N, table, v0, V, D, inv_t);
    wide_block_f32(m, h, n0, N, c0, D);
    __syncthreads();
    for (int r = 0; r < TM; ++r) {
      float dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dl[i] = m.Ls[r * (VC + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < W_DT / 16; ++j) {
        const float hv = m.Os[r * (W_DT + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dl[i], hv, acc[i][j]);
      }
    }
    __syncthreads();  // Ls, Os and the row values are rewritten for the next tile
  }
  float* out = ws + static_cast<size_t>(split) * V * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ty + 16 * i;
    if (v >= V) continue;
#pragma unroll
    for (int j = 0; j < W_DT / 16; ++j) {
      const int d = c0 + tx + 16 * j;
      if (d < D) out[static_cast<size_t>(v) * D + d] = acc[i][j];
    }
  }
}

constexpr size_t wide_tc_smem_bytes() {
  // the stream's two stages, the owned column block [64][W_LO], then (dE)
  // the h rows' (lse * log2 e, g * inv_t) and targets
  return StreamTiles<8, false>::smem_bytes + sizeof(bf16) * 64 * W_LO +
         TM * (sizeof(float2) + sizeof(int));
}

__global__ void __launch_bounds__(TC_NT, 2) ce_dh_wide_tc_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, const float* __restrict__ lse, const float* __restrict__ g,
    bf16* __restrict__ dh, int N, int D, int V, float inv_t) {
  constexpr int NJO = W_DO / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = buf + 2 * StreamTiles<8, false>::STAGE;  // [VC][W_LO]: E chunk, columns c0..
  const int n0 = blockIdx.x * TM, c0 = blockIdx.y * W_DO;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = (V + VC - 1) / VC;
  const float sl2 = inv_t * LOG2E;
  int row[2], tgt[2];
  float lse2[2], gv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = n0 + warp * 16 + lane / 4 + 8 * i;
    const bool in = row[i] < N;
    const int t = in ? targets[row[i]] : -1;
    tgt[i] = (t >= 0 && t < V) ? t : -1;
    lse2[i] = in ? lse[row[i]] * LOG2E : 0.f;
    gv[i] = (in && valid[row[i]] == 1) ? g[row[i]] * inv_t : 0.f;
  }
  float acc[NJO][4];
#pragma unroll
  for (int c = 0; c < NJO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int t = 0; t < nv; ++t) {
    const int v0 = t * VC;
    // the chunk's E columns loading beside the logits stream (Os is free:
    // the previous chunk ended with a __syncthreads)
    load_block_async<VC, W_DO, TC_NT>(Os, W_LO, table + static_cast<size_t>(v0) * D + c0, D,
                                      V - v0, D - c0);
    cp_async_commit();
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    stream_mma<8, false, TC_NT>(s, buf, h + static_cast<size_t>(n0) * D, D, N - n0,
                                table + static_cast<size_t>(v0) * D, nullptr, D, V - v0, D, warp,
                                lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = v0 + 8 * j + 2 * (lane % 4) + (e & 1);
        const int i = e >> 1;
        s[j][e] = c < V ? dlog_of(s[j][e], sl2, lse2[i], c == tgt[i], gv[i]) : 0.f;
      }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t da[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NJO / 2; ++np) {
        uint32_t eb[4];
        ldsm_x4_trans(eb, bk_addr(Os, W_LO, kc * 16, np * 16, lane));
        mma_bf16(acc[2 * np], da, eb[0], eb[1]);
        mma_bf16(acc[2 * np + 1], da, eb[2], eb[3]);
      }
    }
    __syncthreads();  // Os is refilled by the next chunk
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= N) continue;
    bf16* out = dh + static_cast<size_t>(row[i]) * D + c0 + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < NJO; ++c)
      if (c0 + 8 * c < D)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) =
            __floats2bfloat162_rn(acc[c][2 * i], acc[c][2 * i + 1]);
  }
}

__global__ void __launch_bounds__(TC_NT, 2) ce_de_wide_tc_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, const float* __restrict__ lse, const float* __restrict__ g,
    float* __restrict__ ws, int N, int D, int V, float inv_t, int tiles_per_split) {
  constexpr int NJO = W_DO / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = buf + 2 * StreamTiles<8, false>::STAGE;             // [TM][W_LO]: h rows, columns c0..
  float2* rinf = reinterpret_cast<float2*>(Os + 64 * W_LO);      // [TM]
  int* rtgt = reinterpret_cast<int*>(rinf + TM);                 // [TM]
  const int v0 = blockIdx.x * VC, split = blockIdx.y, c0 = blockIdx.z * W_DO;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float sl2 = inv_t * LOG2E;
  const int nb = split * tiles_per_split * TM;
  const int nt = max(0, min(tiles_per_split, (N - nb + TM - 1) / TM));
  int vrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) vrow[i] = v0 + warp * 16 + lane / 4 + 8 * i;
  float acc[NJO][4];
#pragma unroll
  for (int c = 0; c < NJO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int r0 = nb + it * TM;
    // the tile's h columns load beside the logits stream; Os and the row
    // values are free (the previous tile ended with a __syncthreads) and
    // are read after the stream's first __syncthreads
    load_block_async<TM, W_DO, TC_NT>(Os, W_LO, h + static_cast<size_t>(r0) * D + c0, D, N - r0,
                                      D - c0);
    cp_async_commit();
    for (int r = threadIdx.x; r < TM; r += TC_NT) {
      const int n = r0 + r;
      const bool in = n < N;
      const int t = in ? targets[n] : -1;
      rinf[r] = in ? make_float2(lse[n] * LOG2E, valid[n] == 1 ? g[n] * inv_t : 0.f)
                   : make_float2(0.f, 0.f);
      rtgt[r] = (t >= 0 && t < V) ? t : -1;
    }
    float sT[8][4];  // this warp's 16 vocab rows x the tile's 64 h rows
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = 0.f;
    stream_mma<8, false, TC_NT>(sT, buf, table + static_cast<size_t>(v0) * D, D, V - v0,
                                h + static_cast<size_t>(r0) * D, nullptr, D, N - r0, D, warp,
                                lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = 8 * j + 2 * (lane % 4) + cc;
        const float2 lg = rinf[c];
        const int tg = rtgt[c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + cc;
          sT[j][e] = dlog_of(sT[j][e], sl2, lg.x, vrow[i] == tg, lg.y);
        }
      }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t da[4] = {pack_bf16(sT[2 * kc][0], sT[2 * kc][1]),
                              pack_bf16(sT[2 * kc][2], sT[2 * kc][3]),
                              pack_bf16(sT[2 * kc + 1][0], sT[2 * kc + 1][1]),
                              pack_bf16(sT[2 * kc + 1][2], sT[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NJO / 2; ++np) {
        uint32_t hb[4];
        ldsm_x4_trans(hb, bk_addr(Os, W_LO, kc * 16, np * 16, lane));
        mma_bf16(acc[2 * np], da, hb[0], hb[1]);
        mma_bf16(acc[2 * np + 1], da, hb[2], hb[3]);
      }
    }
    __syncthreads();  // Os and the row values are rewritten for the next tile
  }
  float* out = ws + static_cast<size_t>(split) * V * D + c0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (vrow[i] >= V) continue;
#pragma unroll
    for (int c = 0; c < NJO; ++c)
      if (c0 + 8 * c < D)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(vrow[i]) * D + 8 * c) =
            make_float2(acc[c][2 * i], acc[c][2 * i + 1]);
  }
}

template <typename T, typename DhK, typename DeK>
int run_wide(DhK dh_kernel, DeK de_kernel, int nthreads, size_t smem, int dcols, const void* h,
             const void* table, const int* targets, const int* valid, const float* lse,
             const float* g, void* dh, void* de, float* ws, int N, int D, int V, float inv_t,
             int nsplit, int tiles_per_split, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(de_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const T* ht = static_cast<const T*>(h);
  const T* et = static_cast<const T*>(table);
  const int ncol = (D + dcols - 1) / dcols;
  dh_kernel<<<dim3((N + TM - 1) / TM, ncol), nthreads, smem, s>>>(
      ht, et, targets, valid, lse, g, static_cast<T*>(dh), N, D, V, inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  de_kernel<<<dim3((V + VC - 1) / VC, nsplit, ncol), nthreads, smem, s>>>(
      ht, et, targets, valid, lse, g, ws, N, D, V, inv_t, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gamer::reduce_splits(ws, static_cast<T*>(de), static_cast<size_t>(V) * D, nsplit, s);
}

int run_f32(const void* h, const void* table, const int* targets, const int* valid,
            const float* lse, const float* g, void* dh, void* de, float* ws, int N, int D, int V,
            float inv_t, int nsplit, int tiles_per_split, cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(ce_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_de_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float* ht = static_cast<const float*>(h);
  const float* et = static_cast<const float*>(table);
  ce_dh_kernel<<<(N + TM - 1) / TM, NT, smem, s>>>(ht, et, targets, valid, lse, g,
                                                   static_cast<float*>(dh), N, D, V, inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_de_kernel<<<dim3((V + VC - 1) / VC, nsplit), NT, smem, s>>>(
      ht, et, targets, valid, lse, g, ws, N, D, V, inv_t, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gamer::reduce_splits(ws, static_cast<float*>(de), static_cast<size_t>(V) * D, nsplit, s);
}

template <int DP>
int run_bf16(const void* h, const void* table, const int* targets, const int* valid,
             const float* lse, const float* g, void* dh, void* de, float* ws, int N, int D, int V,
             float inv_t, int nsplit, int tiles_per_split, cudaStream_t s) {
  constexpr size_t smem_dh = dh_tc_smem_bytes<DP>(), smem_de = de_tc_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(ce_dh_tc_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dh));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_de_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_de));
  if (err != cudaSuccess) return err;
  const bf16* ht = static_cast<const bf16*>(h);
  const bf16* et = static_cast<const bf16*>(table);
  ce_dh_tc_kernel<DP><<<(N + TM - 1) / TM, TC_NT, smem_dh, s>>>(
      ht, et, targets, valid, lse, g, static_cast<bf16*>(dh), N, D, V, inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_de_tc_kernel<DP><<<dim3((V + VC - 1) / VC, nsplit), TC_NT, smem_de, s>>>(
      ht, et, targets, valid, lse, g, ws, N, D, V, inv_t, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gamer::reduce_splits(ws, static_cast<bf16*>(de), static_cast<size_t>(V) * D, nsplit, s);
}

}  // namespace

// h [N, D] and table [V, D] in dtype (gamer::DType: bf16 -> tensor-core
// kernels, fp32 -> CUDA-core kernels); targets/valid int32 [N]; lse and g
// fp32 [N]; dh [N, D] and de [V, D] in dtype; ws fp32 scratch of
// nsplit * V * D floats, rows split into nsplit chunks of tiles_per_split
// 64-row tiles. Any D in fp32; bf16: D a multiple of 16 (the wrapper pads), h
// and table 16-byte aligned (16-byte copies). D > 256 takes the wide
// kernels in both dtypes.
extern "C" int gamer_fused_ce_bwd(const void* h, const void* table, const int* targets,
                                  const int* valid, const float* lse, const float* g, void* dh,
                                  void* de, float* ws, int N, int D, int V, float inv_t,
                                  int nsplit, int tiles_per_split, int dtype, void* stream) {
  if (N <= 0 || D <= 0 || V <= 0 || nsplit <= 0 || nsplit > 65535 ||
      tiles_per_split <= 0 || static_cast<long long>(nsplit) * tiles_per_split * TM < N)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GAMER_BWD_ARGS \
  h, table, targets, valid, lse, g, dh, de, ws, N, D, V, inv_t, nsplit, tiles_per_split, s
  if (dtype == gamer::kFloat32) {
    if (D <= DMAX) return run_f32(GAMER_BWD_ARGS);
    return run_wide<float>(ce_dh_wide_kernel, ce_de_wide_kernel, NT, wide_f32_smem_bytes(), W_DT,
                           GAMER_BWD_ARGS);
  }
  if (dtype == gamer::kBFloat16) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(table);
    if (D % 16 != 0 || addr % 16 != 0) return cudaErrorInvalidValue;
    if (D <= 64) return run_bf16<64>(GAMER_BWD_ARGS);
    if (D <= 128) return run_bf16<128>(GAMER_BWD_ARGS);
    if (D <= 256) return run_bf16<256>(GAMER_BWD_ARGS);
    return run_wide<bf16>(ce_dh_wide_tc_kernel, ce_de_wide_tc_kernel, TC_NT, wide_tc_smem_bytes(),
                          W_DO, GAMER_BWD_ARGS);
  }
#undef GAMER_BWD_ARGS
  return cudaErrorInvalidValue;
}
