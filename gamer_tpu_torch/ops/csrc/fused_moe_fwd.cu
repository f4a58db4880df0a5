// Fused position-routed SwiGLU MoE-FFN forward.
//
// Replaces the TPU kernel gamer_tpu/ops/pallas_moe.py `_fwd_kernel`. Per
// (row tile, expert p):
//     gu = x @ Wgu[p] + btab[p, beh]     (gate | up, one product, f32)
//     h  = act(gu[:, :F]) * gu[:, F:]    (silu, relu or tanh-gelu; moe_tc.cuh)
//     h  = keep ? h / keep_frac : 0      (training: hash dropout)
//     y  = h @ Wd[p]
// The [T, 2F] gate/up activations never reach global memory: a CTA walks F
// in chunks, computes that chunk's gate and up columns for its rows, forms h
// and accumulates y = h @ Wd in registers. The dropout mask is the
// stateless hash of (seed, expert p, absolute row t, column f) (common.cuh;
// the seed read on the card from `gamer::Seed`),
// as pallas_moe.py:80-82 keys it; T has no row padding here, so the
// coordinates of real rows are the JAX kernel's.
//
// Layout: x [P, T, D], wgu [P, D, 2F], wd [P, F, Dout], btab [P, NB, 2F],
// beh [P, T] int32 (bias row id; ids outside [0, NB) add nothing, as in the
// JAX kernel's per-id select), out [P, T, Dout].
//
// Bound on H100: operations. 2*P*T*(D*2F + F*Dout) multiply-adds for
// P*T*(D + Dout) activations and the weights moved once; at the flagship
// shape (P 5, T 6464, D 256, F 512, Dout 256) 25.4 GFLOP against 35 MB.
//
// Dispatch by dtype, in the C entry point before any launch:
//  - bf16: `moe_fwd_tc_kernel`, on the tensor cores (mma.sync m16n8k16,
//    fp32 accumulators; mma.cuh, moe_tc.cuh). One CTA per (64-row tile,
//    expert, output-column tile of up to 256), 4 warps of 16 rows. The x
//    tile is loaded once ([64][DP + 8], D padded to DP = 64, 128 or 256 with
//    zeros); F is walked in chunks of 16, the chunk's gate|up columns of Wgu
//    ([DP][16 | 16], ldmatrix.trans) and its 16 rows of Wd ([16][NO + 8],
//    ldmatrix.trans) double-buffered by 16-byte cp.async. Per chunk a warp
//    computes g and u of its 16 rows (16 k16 steps at D 256), adds the bias
//    row, forms h = act(g) * u in fp32, applies the dropout keep and 1/keep,
//    rounds h to bf16 as the TPU kernel does (pallas_moe.py:83), and the
//    packed accumulator fragments are directly the A operand of y += h . Wd
//    over the chunk (one k16 step). y stays in fp32 registers across F and is
//    stored once as bf16.
//  - bf16 with D > 256: `moe_fwd_wide_kernel`, the same function where the
//    x tile and a chunk's Wgu columns no longer fit in shared memory. One CTA
//    per (64-row tile, expert, 128 output columns); F is walked in chunks of
//    64, and each chunk's gate|up product streams x and Wgu over D in 64-deep
//    slices (stream_tc.cuh) while the chunk's Wd rows load beside them. The
//    price is that x is read again for every chunk (F / 64 times, from L2).
//  - fp32: `moe_fwd_kernel`, fp32 FMA on the CUDA cores from shared memory
//    (64 rows x 32 F columns a chunk, h in shared memory), so fp32 callers
//    get full fp32. Up to D 512 the x tile stays in shared memory; wider, it
//    is streamed with each 32-deep weight slice.
//
// Grouped (G = true; `gamer_fused_moe_fwd_grouped`, MoeAction's launch,
// ops/fused_moe.py): the grid's row tiles are those of the level table
// (moe_tc.cuh `Groups`), not of T. A CTA takes its tile's expert at its
// position, or exits (no level, or an expert held elsewhere: the caller
// zeroes the output); it loads its x rows through the table, writes each
// row's y at the row's own place, and hashes the row's own t. Pad places
// take row T, which every kernel already treats as a row past T.
//
// What bounds the bf16 design, and what it does about it:
//  - registers: a warp's 16 x 256 fp32 y is 128 registers a thread, so the
//    chunk is narrow (16 gate + 16 up columns, 16 registers) and x is read
//    from shared memory for every product, not held in registers;
//  - the weight stream: every CTA reads its expert's whole Wgu and Wd (768
//    KB at the flagship) from L2, about 388 MB a call at 64 rows a CTA.
//    Taller row tiles would halve that but leave 255 CTAs for 132 SMs at one
//    CTA an SM; 64 rows give 505 CTAs at two an SM (92 KB of shared memory
//    each);
//  - ragged edges: cp.async zero-fills x rows past T, Wgu rows past D and
//    Wd columns past Dout, so no stale value enters a product; rows past T
//    take no bias and are not stored.

#include "common.cuh"
#include "mma.cuh"
#include "moe_tc.cuh"
#include "stream_tc.cuh"

namespace {

using namespace gamer::tc;
using gamer::from_f;
using gamer::to_f;
using gamer::moe::Groups;

constexpr int TM = 64;   // rows a CTA
constexpr int FC = 32;   // F columns a chunk (gate and up each)
constexpr int KT = 32;   // depth of a gate/up weight slice
constexpr int DT = 256;  // output columns a CTA
constexpr int NT = 256;  // threads: 16 row groups x 16 column lanes
constexpr int TC_NT = 128;  // bf16 kernel threads: 4 warps x 16 rows
constexpr int TC_FC = 16;   // bf16 chunk: F columns (gate and up each), one k16 step of y
static_assert(TM == gamer::moe::kTileRows, "a grouped tile is a CTA's rows");

// XRES: the x tile [TM][D+1] stays in shared memory (D <= 512), else a
// [TM][KT+1] slice of it is loaded with each weight slice
template <bool XRES>
size_t smem_bytes(int D) {
  const size_t xs = static_cast<size_t>(TM) * ((XRES ? D : KT) + 1);
  return sizeof(float) * (xs + KT * (2 * FC + 1) + TM * (FC + 1) + FC * DT) + sizeof(int) * TM;
}

template <typename T, bool XRES, bool G>
__global__ void __launch_bounds__(NT) moe_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ wgu, const T* __restrict__ wd,
    const T* __restrict__ btab, const int* __restrict__ beh, T* __restrict__ out, int T_rows,
    int D, int F, int Dout, int NB, int use_bias, int act, gamer::Seed seed_in, uint32_t thresh,
    float inv_keep, Groups grp) {
  const uint32_t seed = seed_in.get();
  extern __shared__ float smem[];
  const int LX = (XRES ? D : KT) + 1;
  float* Xs = smem;                                  // [TM][LX]
  float* Ws = Xs + TM * LX;                          // [KT][2*FC+1]
  float* Hs = Ws + KT * (2 * FC + 1);                // [TM][FC+1]
  float* Wds = Hs + TM * (FC + 1);                   // [FC][DT]
  int* bid = reinterpret_cast<int*>(Wds + FC * DT);  // [TM]

  const int t0 = blockIdx.x * TM;
  const int p = blockIdx.y;
  const int c0 = blockIdx.z * DT;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
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
  const T* wgup = wgu + static_cast<size_t>(e) * D * F2;
  const T* wdp = wd + static_cast<size_t>(e) * F * Dout;
  const T* btp = btab + static_cast<size_t>(e) * NB * F2;

  if (XRES)
    for (int idx = tid; idx < TM * D; idx += NT) {
      const int r = idx / D, c = idx % D, t = row_of(r);
      Xs[r * LX + c] = t < T_rows ? to_f(xp[static_cast<size_t>(t) * D + c]) : 0.f;
    }
  for (int r = tid; r < TM; r += NT) {
    const int t = row_of(r);
    const int id = t < T_rows ? beh[static_cast<size_t>(p) * T_rows + t] : -1;
    bid[r] = (use_bias && id >= 0 && id < NB) ? id : -1;
  }

  float y[4][DT / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DT / 16; ++j) y[i][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += FC) {
    // gate columns f0 + tx + 16*jj sit at tile columns tx + 16*jj, the matching
    // up columns at FC + tx + 16*jj: each thread holds both halves of its h
    float g[4][2], u[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) g[i][jj] = u[i][jj] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KT) {
      __syncthreads();  // Ws (and, on the first slice, Hs/Wds) reads are done
      for (int idx = tid; idx < KT * 2 * FC; idx += NT) {
        const int kk = idx / (2 * FC), c = idx % (2 * FC);
        const int f = f0 + (c < FC ? c : c - FC);
        const size_t col = c < FC ? f : F + f;
        const bool in = (k0 + kk) < D && f < F;
        Ws[kk * (2 * FC + 1) + c] = in ? to_f(wgup[static_cast<size_t>(k0 + kk) * F2 + col]) : 0.f;
      }
      if (!XRES)
        for (int idx = tid; idx < TM * KT; idx += NT) {
          const int r = idx / KT, kk = idx % KT, t = row_of(r);
          Xs[r * LX + kk] = (t < T_rows && k0 + kk < D)
                                ? to_f(xp[static_cast<size_t>(t) * D + k0 + kk])
                                : 0.f;
        }
      __syncthreads();
      const int kmax = min(KT, D - k0);
      const int xk = XRES ? k0 : 0;
      for (int kk = 0; kk < kmax; ++kk) {
        float xa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[i] = Xs[(ty + 16 * i) * LX + xk + kk];
        const float* wrow = Ws + kk * (2 * FC + 1);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float wg = wrow[tx + 16 * jj], wu = wrow[FC + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            g[i][jj] = fmaf(xa[i], wg, g[i][jj]);
            u[i][jj] = fmaf(xa[i], wu, u[i][jj]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int f = f0 + tx + 16 * jj;
        float gv = g[i][jj], uv = u[i][jj];
        if (bid[r] >= 0 && f < F) {
          gv += to_f(btp[bid[r] * F2 + f]);
          uv += to_f(btp[bid[r] * F2 + F + f]);
        }
        float hv = f < F ? gamer::moe::act_value<false>(act, gv) * uv : 0.f;
        if (thresh > 0u)
          hv = gamer::hash_keep(seed, static_cast<uint32_t>(p), static_cast<uint32_t>(row_of(r)),
                                static_cast<uint32_t>(f), thresh)
                   ? hv * inv_keep
                   : 0.f;
        Hs[r * (FC + 1) + tx + 16 * jj] = hv;
      }
    }
    for (int idx = tid; idx < FC * DT; idx += NT) {
      const int ff = idx / DT, c = idx % DT;
      const bool in = (f0 + ff) < F && (c0 + c) < Dout;
      Wds[ff * DT + c] = in ? to_f(wdp[static_cast<size_t>(f0 + ff) * Dout + c0 + c]) : 0.f;
    }
    __syncthreads();

    for (int ff = 0; ff < FC; ++ff) {
      float ha[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ha[i] = Hs[(ty + 16 * i) * (FC + 1) + ff];
#pragma unroll
      for (int j = 0; j < DT / 16; ++j) {
        const float w = Wds[ff * DT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i][j] = fmaf(ha[i], w, y[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = row_of(ty + 16 * i);
    if (t >= T_rows) continue;
    T* orow = out + (static_cast<size_t>(p) * T_rows + t) * Dout;
#pragma unroll
    for (int j = 0; j < DT / 16; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < Dout) orow[c] = from_f<T>(y[i][j]);
    }
  }
}

// the row tiles of a launch: of T, or of the grouped table
template <bool G>
int row_tiles(int T_rows, const Groups& grp) {
  return G ? grp.tiles : (T_rows + TM - 1) / TM;
}

template <typename T, bool XRES, bool G>
int launch(const void* x, const void* wgu, const void* wd, const void* btab, const int* beh,
           void* out, int P, int T_rows, int D, int F, int Dout, int NB, int use_bias, int act,
           gamer::Seed seed, uint32_t thresh, float inv_keep, Groups grp, cudaStream_t stream) {
  const size_t smem = smem_bytes<XRES>(D);
  cudaError_t err = cudaFuncSetAttribute(moe_fwd_kernel<T, XRES, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(row_tiles<G>(T_rows, grp), P, (Dout + DT - 1) / DT);
  moe_fwd_kernel<T, XRES, G><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wgu), static_cast<const T*>(wd),
      static_cast<const T*>(btab), beh, static_cast<T*>(out), T_rows, D, F, Dout, NB, use_bias,
      act, seed, thresh, inv_keep, grp);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores

template <int DP, int NO>
constexpr size_t tc_smem_bytes() {
  // the x tile, then 2 stages of (gate|up columns of Wgu, rows of Wd)
  return sizeof(bf16) * (TM * (DP + 8) + 2 * (DP * (2 * TC_FC + 8) + TC_FC * (NO + 8)));
}

template <int DP, int NO, bool G>
__global__ void __launch_bounds__(TC_NT, 2) moe_fwd_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wgu, const bf16* __restrict__ wd,
    const bf16* __restrict__ btab, const int* __restrict__ beh, bf16* __restrict__ out,
    int T_rows, int D, int F, int Dout, int NB, int use_bias, int act, gamer::Seed seed_in,
    uint32_t thresh, float inv_keep, Groups grp) {
  const uint32_t seed = seed_in.get();
  constexpr int LX = DP + 8;           // x tile row stride
  constexpr int LW = 2 * TC_FC + 8;    // gate|up tile row stride
  constexpr int LV = NO + 8;           // Wd tile row stride
  constexpr int KS = DP / 16;          // k16 steps of the gate/up product
  constexpr int NJ = NO / 8;           // 8-wide y column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [TM][LX]
  bf16* Ws = Xs + TM * LX;                       // stage s: [DP][LW]
  bf16* Vs = Ws + 2 * DP * LW;                   // stage s: [TC_FC][LV]

  const int t0 = blockIdx.x * TM, p = blockIdx.y, c0 = blockIdx.z * NO;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int e = p;  // the expert
  if constexpr (G) {
    e = grp.expert_of_tile(blockIdx.x, p);
    if (e < 0) return;
  }
  const size_t F2 = 2 * static_cast<size_t>(F);
  const bf16* wgup = wgu + static_cast<size_t>(e) * D * F2;
  const bf16* wdp = wd + static_cast<size_t>(e) * F * Dout + c0;
  const int ncols = min(NO, Dout - c0);
  const int nc = F / TC_FC;

  // this thread's two rows, t0 + warp*16 + lane/4 and + 8 (grouped: their
  // rows t): bias row, hash row part
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

  auto load_chunk = [&](int c) {
    const int st = c & 1, f0 = c * TC_FC;
    bf16* w = Ws + st * DP * LW;
    load_block_async<DP, TC_FC, TC_NT>(w, LW, wgup + f0, F2, D, TC_FC);           // gate
    load_block_async<DP, TC_FC, TC_NT>(w + TC_FC, LW, wgup + F + f0, F2, D, TC_FC);  // up
    load_block_async<TC_FC, NO, TC_NT>(Vs + st * TC_FC * LV, LV,
                                       wdp + static_cast<size_t>(f0) * Dout, Dout, TC_FC, ncols);
  };
  if constexpr (G)
    load_rows_async<TM, DP, TC_NT>(Xs, LX, x + static_cast<size_t>(p) * T_rows * D, D,
                                   grp.rows + t0, TM, D);
  else
    load_block_async<TM, DP, TC_NT>(Xs, LX, x + (static_cast<size_t>(p) * T_rows + t0) * D, D,
                                    T_rows - t0, D);
  load_chunk(0);
  cp_async_commit();

  float y[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) load_chunk(c + 1);
    cp_async_commit();
    const int f0 = c * TC_FC;
    // the chunk's bias, read before the product so that its latency hides
    float2 bg[2][2], bu[2][2];  // [row i][column tile j]: columns f0 + 8j + 2*(lane%4) + {0,1}
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        gamer::moe::bias_pair(brow[i], f0 + 8 * j + 2 * (lane % 4), F, bg[i][j], bu[i][j]);
    cp_async_wait<1>();  // chunk c (and the x tile) have landed
    __syncthreads();
    const bf16* Wt = Ws + (c & 1) * DP * LW;
    const bf16* Vt = Vs + (c & 1) * TC_FC * LV;

    float g[2][4], u[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[j][e] = u[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk * 16 < D) {
        uint32_t xa[4];
        ldsm_x4(xa, a_addr(Xs, LX, warp * 16, kk * 16, lane));
        gamer::moe::gate_up_step<2>(g, u, xa, Wt, LW, kk * 16, TC_FC, lane);
      }
    }

    // h = dropout(act(g + bias) * (u + bias)) in fp32, rounded to bf16 into
    // the A fragment of y += h . Wd[chunk]
    gamer::moe::with_act(act, [&](auto a) {
      constexpr int ACT = decltype(a)::value;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float gv = g[j][e] + ((e & 1) ? bg[i][j].y : bg[i][j].x);
          const float uv = u[j][e] + ((e & 1) ? bu[i][j].y : bu[i][j].x);
          float hv = gamer::moe::act_value<true>(ACT, gv) * uv;
          if (thresh > 0u) {
            const int f = f0 + 8 * j + 2 * (lane % 4) + (e & 1);
            hv = gamer::hash_keep_at(hrow[i], static_cast<uint32_t>(f), thresh) ? hv * inv_keep
                                                                                : 0.f;
          }
          g[j][e] = hv;
        }
    });
    const uint32_t ha[4] = {pack_bf16(g[0][0], g[0][1]), pack_bf16(g[0][2], g[0][3]),
                            pack_bf16(g[1][0], g[1][1]), pack_bf16(g[1][2], g[1][3])};
#pragma unroll
    for (int np = 0; np < NJ / 2; ++np) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, bk_addr(Vt, LV, 0, np * 16, lane));
      mma_bf16(y[2 * np], ha, vb[0], vb[1]);
      mma_bf16(y[2 * np + 1], ha, vb[2], vb[3]);
    }
    __syncthreads();  // stage c & 1 is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= T_rows) continue;
    bf16* orow = out + (static_cast<size_t>(p) * T_rows + row[i]) * Dout + c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (8 * j < ncols)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(y[j][2 * i], y[j][2 * i + 1]);
  }
}

// ---- bf16 with D > 256: the streamed route

constexpr int W_FC = 64;   // F columns a chunk (gate and up each)
constexpr int W_NO = 128;  // output columns a CTA
constexpr int W_LV = W_NO + 8;
using WideGU = StreamTiles<2 * W_FC / 8, true>;  // gate tiles 0..7 | up tiles 8..15

constexpr size_t wide_smem_bytes() {
  return WideGU::smem_bytes + sizeof(bf16) * W_FC * W_LV;  // stream stages, Wd rows
}

template <bool G>
__global__ void __launch_bounds__(TC_NT, 2) moe_fwd_wide_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wgu, const bf16* __restrict__ wd,
    const bf16* __restrict__ btab, const int* __restrict__ beh, bf16* __restrict__ out,
    int T_rows, int D, int F, int Dout, int NB, int use_bias, int act, gamer::Seed seed_in,
    uint32_t thresh, float inv_keep, Groups grp) {
  const uint32_t seed = seed_in.get();
  constexpr int NH = W_FC / 8;   // 8-wide gate (and up) tiles of a chunk
  constexpr int NJO = W_NO / 8;  // 8-wide y column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // the stream's two stages
  bf16* Vs = buf + 2 * WideGU::STAGE;             // [W_FC][W_LV] the chunk's Wd rows

  const int t0 = blockIdx.x * TM, p = blockIdx.y, c0 = blockIdx.z * W_NO;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int e = p;  // the expert
  if constexpr (G) {
    e = grp.expert_of_tile(blockIdx.x, p);
    if (e < 0) return;
  }
  const size_t F2 = 2 * static_cast<size_t>(F);
  // x's rows: from t0, or (grouped) through the table from row 0
  const bf16* xp = x + (static_cast<size_t>(p) * T_rows + (G ? 0 : t0)) * D;
  const bf16* wgup = wgu + static_cast<size_t>(e) * D * F2;
  const bf16* wdp = wd + static_cast<size_t>(e) * F * Dout + c0;
  const int ncols = min(W_NO, Dout - c0);
  const int nc = (F + W_FC - 1) / W_FC;

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

  float y[NJO][4];
#pragma unroll
  for (int j = 0; j < NJO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int f0 = c * W_FC, fcols = min(W_FC, F - f0);
    // the chunk's Wd rows load while gate|up stream in (Vs is free: the
    // previous chunk ended with a __syncthreads)
    load_block_async<W_FC, W_NO, TC_NT>(Vs, W_LV, wdp + static_cast<size_t>(f0) * Dout, Dout,
                                        fcols, ncols);
    cp_async_commit();
    float gu[2 * NH][4];
#pragma unroll
    for (int j = 0; j < 2 * NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gu[j][e] = 0.f;
    stream_mma<2 * NH, true, TC_NT, G>(gu, buf, xp, D, G ? TM : T_rows - t0, wgup + f0,
                                       wgup + F + f0, F2, fcols, D, warp, lane,
                                       G ? grp.rows + t0 : nullptr);

    // h = dropout(act(g + bias) * (u + bias)) in fp32, rounded to bf16 into
    // the A fragments of y += h . Wd[chunk] (tile j is half of k16 step j / 2)
    uint32_t ha[NH / 2][4];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int f = f0 + 8 * j + 2 * (lane % 4);  // column of e = 0 and 2; e = 1, 3 at f + 1
      const bool in = 8 * j < fcols;
      float2 bg[2], bu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) gamer::moe::bias_pair(in ? brow[i] : nullptr, f, F, bg[i], bu[i]);
      float hv[4];
      gamer::moe::with_act(act, [&](auto a) {
        constexpr int ACT = decltype(a)::value;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float gv = gu[j][e] + ((e & 1) ? bg[i].y : bg[i].x);
          const float uv = gu[NH + j][e] + ((e & 1) ? bu[i].y : bu[i].x);
          hv[e] = gamer::moe::act_value<true>(ACT, gv) * uv;
          if (thresh > 0u)
            hv[e] = gamer::hash_keep_at(hrow[i], static_cast<uint32_t>(f + (e & 1)), thresh)
                        ? hv[e] * inv_keep
                        : 0.f;
        }
      });
      ha[j / 2][(j & 1) * 2] = pack_bf16(hv[0], hv[1]);
      ha[j / 2][(j & 1) * 2 + 1] = pack_bf16(hv[2], hv[3]);
    }
#pragma unroll
    for (int kc = 0; kc < NH / 2; ++kc)
#pragma unroll
      for (int np = 0; np < NJO / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, bk_addr(Vs, W_LV, kc * 16, np * 16, lane));
        mma_bf16(y[2 * np], ha[kc], vb[0], vb[1]);
        mma_bf16(y[2 * np + 1], ha[kc], vb[2], vb[3]);
      }
    __syncthreads();  // Vs is refilled by the next chunk
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= T_rows) continue;
    bf16* orow = out + (static_cast<size_t>(p) * T_rows + row[i]) * Dout + c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < NJO; ++j)
      if (8 * j < ncols)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(y[j][2 * i], y[j][2 * i + 1]);
  }
}

template <bool G>
int launch_wide(const void* x, const void* wgu, const void* wd, const void* btab, const int* beh,
                void* out, int P, int T_rows, int D, int F, int Dout, int NB, int use_bias,
                int act, gamer::Seed seed, uint32_t thresh, float inv_keep, Groups grp,
                cudaStream_t stream) {
  constexpr size_t smem = wide_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(moe_fwd_wide_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(row_tiles<G>(T_rows, grp), P, (Dout + W_NO - 1) / W_NO);
  moe_fwd_wide_kernel<G><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wgu), static_cast<const bf16*>(wd),
      static_cast<const bf16*>(btab), beh, static_cast<bf16*>(out), T_rows, D, F, Dout, NB,
      use_bias, act, seed, thresh, inv_keep, grp);
  return cudaGetLastError();
}

template <int DP, int NO, bool G>
int launch_bf16(const void* x, const void* wgu, const void* wd, const void* btab, const int* beh,
                void* out, int P, int T_rows, int D, int F, int Dout, int NB, int use_bias,
                int act, gamer::Seed seed, uint32_t thresh, float inv_keep, Groups grp,
                cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DP, NO>();
  cudaError_t err = cudaFuncSetAttribute(moe_fwd_tc_kernel<DP, NO, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(row_tiles<G>(T_rows, grp), P, (Dout + NO - 1) / NO);
  moe_fwd_tc_kernel<DP, NO, G><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wgu), static_cast<const bf16*>(wd),
      static_cast<const bf16*>(btab), beh, static_cast<bf16*>(out), T_rows, D, F, Dout, NB,
      use_bias, act, seed, thresh, inv_keep, grp);
  return cudaGetLastError();
}

#define GAMER_FWD_ARGS                                                                     \
  x, wgu, wd, btab, beh, out, P, T_rows, D, F, Dout, NB, use_bias, act, seed, thresh, inv_keep, \
      grp, st

// the output-column tile for Dout
template <int DP, bool G>
int launch_bf16_d(const void* x, const void* wgu, const void* wd, const void* btab, const int* beh,
                  void* out, int P, int T_rows, int D, int F, int Dout, int NB, int use_bias,
                  int act, gamer::Seed seed, uint32_t thresh, float inv_keep, Groups grp,
                  cudaStream_t st) {
  if (Dout <= 64) return launch_bf16<DP, 64, G>(GAMER_FWD_ARGS);
  if (Dout <= 128) return launch_bf16<DP, 128, G>(GAMER_FWD_ARGS);
  return launch_bf16<DP, 256, G>(GAMER_FWD_ARGS);
}

// the route by dtype and width (the entry point's comment)
template <bool G>
int dispatch(const void* x, const void* wgu, const void* wd, const void* btab, const int* beh,
             void* out, int P, int T_rows, int D, int F, int Dout, int NB, int use_bias, int act,
             gamer::Seed seed, uint32_t thresh, float inv_keep, int dtype, Groups grp,
             cudaStream_t st) {
  if (P <= 0 || T_rows <= 0 || D <= 0 || F <= 0 || Dout <= 0 || NB <= 0 || act < 0 || act > 2)
    return cudaErrorInvalidValue;
  if (dtype == gamer::kFloat32) {
    if (D <= 512) return launch<float, true, G>(GAMER_FWD_ARGS);
    return launch<float, false, G>(GAMER_FWD_ARGS);
  }
  if (dtype == gamer::kBFloat16) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wgu) |
                           reinterpret_cast<uintptr_t>(wd) | reinterpret_cast<uintptr_t>(btab) |
                           reinterpret_cast<uintptr_t>(out);
    if (D % 16 || F % 16 || Dout % 16 || addr % 16) return cudaErrorInvalidValue;
    if (D <= 64) return launch_bf16_d<64, G>(GAMER_FWD_ARGS);
    if (D <= 128) return launch_bf16_d<128, G>(GAMER_FWD_ARGS);
    if (D <= 256) return launch_bf16_d<256, G>(GAMER_FWD_ARGS);
    return launch_wide<G>(GAMER_FWD_ARGS);
  }
  return cudaErrorInvalidValue;
}
#undef GAMER_FWD_ARGS

}  // namespace

// dtype: gamer::DType shared by x, wgu, wd, btab and out (bf16 ->
// tensor-core kernels, fp32 -> CUDA-core kernel); act: gamer::moe::Act. Any
// D, F and Dout in fp32 (the x tile in shared memory up to D 512, streamed
// beyond). bf16: D, F and Dout multiples of 16 (the wrapper pads), the bf16
// tensors 16-byte aligned (16-byte copies); D <= 256 takes the resident-x
// kernel (any Dout: columns past 256 take more CTAs), wider D the streamed
// one. thresh = 0 turns dropout off; inv_keep = 1 / keep fraction.
// rows = null: the ungrouped launch (P experts, P positions). Otherwise the
// grouped one (G) on the row table `rows` [tiles * 64], `tile_level`
// [tiles], `level_tile` [levels + 1] (moe_tc.cuh `Groups`): wgu, wd and btab
// hold `experts` experts, a row of level l at position p takes expert
// first + l * P + p; rows the table does not hold, and the tiles of experts
// outside [0, experts), are not written, so `out` comes zeroed.
extern "C" int gamer_fused_moe_fwd(const void* x, const void* wgu, const void* wd,
                                   const void* btab, const int* beh, void* out, int P,
                                   int T_rows, int D, int F, int Dout, int NB, int use_bias,
                                   int act, const unsigned int* seed_ptr, unsigned int seed_add,
                                   unsigned int thresh, float inv_keep, int dtype,
                                   const int* rows, const int* tile_level,
                                   const int* level_tile, int tiles, int levels, int first,
                                   int experts, void* stream) {
  const gamer::Seed seed{seed_ptr, seed_add};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == nullptr)
    return dispatch<false>(x, wgu, wd, btab, beh, out, P, T_rows, D, F, Dout, NB, use_bias, act,
                           seed, thresh, inv_keep, dtype, Groups{}, st);
  if (tiles <= 0 || levels <= 0 || experts <= 0) return cudaErrorInvalidValue;
  return dispatch<true>(x, wgu, wd, btab, beh, out, P, T_rows, D, F, Dout, NB, use_bias, act,
                        seed, thresh, inv_keep, dtype,
                        Groups{rows, tile_level, level_tile, tiles, levels, first, experts, P},
                        st);
}
