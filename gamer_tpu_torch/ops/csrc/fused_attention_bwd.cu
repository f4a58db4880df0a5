// Fused masked GQA attention backward with the GAMER mask family.
//
// Replaces the TPU kernels of gamer_tpu/ops/pallas_attention.py that compute
// the gradients: `_bwd_kernel` (S <= 1024, pallas_call in `_bwd_rule`),
// `_stream_dq_kernel` / `_stream_dkv_kernel` (1024 < S <= 4096) and
// `_stream_dq_kernel_xl` (S > 4096). One flash-attention-2 backward serves
// every S: P is recomputed per 64 x 64 tile from the forward's saved
// logsumexp (fused_attention_fwd.cu), P = exp(s*scale - lse) on allowed pairs
// and 0 elsewhere, never exp of an -inf difference.
//
// A TPU grid runs in order and can carry dk/dv across query chunks in VMEM
// scratch; CUDA blocks run in no order. So the work is split in kernels that
// each own their outputs, with no atomics and a fixed summation order
// (deterministic):
//   delta kernel: delta = rowsum(dO * O) per (row, head) in fp32 from the
//               operand-dtype tensors, into a [B, H, S] scratch;
//   dkv kernel: one CTA per (64-key tile, kv head, batch row) loops over the
//               (query head of its GQA group, query tile) pairs, accumulating
//               dK and dV in registers. Where the grid would not fill the card
//               (B 1 x S 2048 gives 96 such CTAs on 132 SMs), the wrapper
//               asks for `nsplit` > 1: each CTA takes a contiguous share of the
//               pairs, writes fp32 partials to a scratch, and
//               `gamer::reduce_splits` adds them in split order;
//   dq kernel:  one CTA per (64-query tile, head, batch row) loops over the
//               key tiles, accumulating dQ in registers.
// Per tile:
//   P_use = keep ? P / keep_frac : 0       (dropout regenerated by the hash)
//   dV   += P_use^T dO
//   dP    = dO V^T
//   dS    = P_use * dP - P * delta        (pallas_attention.py:221)
//   dQ   += dS K * scale,  dK += dS^T Q * scale
// Tiles the causal kinds ("causal", "multi") rule out are skipped: query
// tiles before a key tile in the dkv kernel, key tiles after a query tile in
// the dq kernel; the tiles with the most work launch first (the first key
// tiles, the last query tiles). Rows past S and keys past S or padded are
// masked.
//
// Dispatch by dtype, in the C entry point before any launch:
//  - bf16: `attn_dkv_tc_kernel` and `attn_dq_tc_kernel` on the tensor cores
//    (mma.sync m16n8k16, fp32 accumulators; mma.cuh), 4 warps a CTA. The dkv
//    kernel keeps its K and V tile in shared memory and each warp owns 16
//    keys: S^T = K Q^T and dP^T = V dO^T come out with keys as rows, so
//    P_use^T and dS^T are already A fragments for dV += P_use^T dO and
//    dK += dS^T Q (dO and Q through ldmatrix.trans), with no trip through
//    shared memory. The dq kernel owns 16 query rows a warp and forms
//    dQ += dS K (K through ldmatrix.trans). The Q/dO tiles (dkv) and K/V
//    tiles (dq) are double-buffered with 16-byte cp.async. P_use and dS are
//    rounded to bf16 for their products, as the TPU kernel rounds them
//    (pallas_attention.py:213,221).
//  - fp32: `attn_dkv_kernel` and `attn_dq_kernel`, fp32 FMA on the CUDA
//    cores from shared memory, P and dS kept in fp32.
//
// Bound on H100: about 10*H*D operations per allowed pair (both kernels
// recompute the scores) against q, k, v, dO, dq, dk, dv moved once; bytes
// bound narrowly at the flagship shape, so mma.sync's rate is ample; wgmma
// and TMA are the next step.
//
// Where this goes wrong, and what the bf16 kernels do about it:
//  - fragment coordinates: in the dkv kernel an accumulator element is
//    (key k0 + warp*16 + lane/4 (+8), query q0 + 8j + 2*(lane%4) + {0,1}),
//    in the dq kernel (query row, key column) the other way round; the mask
//    and the dropout hash (keyed on (b*H + h, query, key)) read them, and
//    only rate 0.2 checks with one seed on both sides would show a wrong map;
//  - ragged tiles: cp.async zero-fills rows past S in shared memory, so no
//    stale NaN or Inf meets a zero probability inside an mma;
//  - rows with no allowed key: the forward's lse is +1e30 and P is formed
//    only on allowed pairs, so P = 0 and their dQ is exactly 0;
//  - GQA: dK and dV sum over the group's query heads in a fixed order, in one
//    CTA or, split, in split order;
//  - head dims: the dkv kernel holds dK and dV (D fp32 registers a thread),
//    so it walks a query tile in steps of QC columns (64 at D 32, 32 at D 64,
//    16 at D 128 and 256) to bound the S^T and dP^T registers. At D 256 both
//    bf16 kernels split the output columns over two CTAs (`TcCols`), each
//    recomputing the scores, and the fp32 kernels take 32-row tiles
//    (`F32Tile`) so that four tiles fit in shared memory. Both kernels are
//    capped at 168 registers for D <= 64 (3 CTAs of 128 threads an SM);
//    ptxas reports a 12-byte spill for the dkv kernel at D 64 under that cap
//    and 8 bytes at D 128 (255 registers); without the cap the D 64 kernel
//    needs no spill but fits only 2 CTAs an SM;
//  - head dims over 256 (the wide route; the wrapper pads them to a multiple
//    of 64): every CTA owns WO = 64 columns of dQ (dq kernels) or of dK and
//    dV (dkv kernels) and recomputes the full-D S and dP of each tile pair,
//    walking D in 64-deep slices: the bf16 kernels by `stream_mma`
//    (stream_tc.cuh), reading Q, K, dO and V slice by slice, the fp32
//    kernels (`WIDE`) through the same shared-memory tiles as at D 64. Each
//    output element is still written by one CTA (no split, no atomics), and
//    delta comes from `attn_delta_kernel<T, 0>`, one warp a row.

#include "common.cuh"
#include "mma.cuh"
#include "stream_tc.cuh"

namespace {

using gamer::to_f;
using namespace gamer::tc;

constexpr int BQ = 64;   // query rows a tile
constexpr int BK = 64;   // keys a tile
constexpr int NT = 256;  // fp32 kernel threads: 16 row groups x 16 column lanes
constexpr int TC_NT = 128;  // bf16 kernel threads: 4 warps
constexpr int WO = 64;   // output columns a CTA of the wide route (head dims over 256)
constexpr float LOG2E = 1.4426950408889634f;

struct Streams {
  const int* attn;
  const int* sid;
  const int* act;
  const int* blk;
};

// The fp32 kernels' square tile: R rows (and R columns) a thread of the
// 16 x 16 thread grid, TB = 16 R query rows and keys a tile. Four query and
// key tiles of D floats must fit in shared memory, so D 256 takes 32-row
// tiles (R 2) and the narrower dims 64-row ones.
template <int D>
struct F32Tile {
  static constexpr int R = D > 128 ? 2 : 4;
  static constexpr int TB = 16 * R;
};

template <int D>
constexpr size_t smem_bytes() {
  constexpr int TB = F32Tile<D>::TB;
  return sizeof(float) * (4 * TB * (D + 1) + 2 * TB * (TB + 1) + 2 * TB) + sizeof(int) * 8 * TB;
}

// Shared-memory carve-up common to both kernels.
template <int D>
struct Tiles {
  float *Qs, *dOs, *Ks, *Vs, *Ps, *dSs, *lse_s, *delta_s;
  int *k_ok, *k_sid, *k_act, *k_blk, *q_in, *q_sid, *q_act, *q_blk;
  __device__ explicit Tiles(float* smem) {
    constexpr int TB = F32Tile<D>::TB;
    Qs = smem;                    // [TB][D+1]
    dOs = Qs + TB * (D + 1);      // [TB][D+1]
    Ks = dOs + TB * (D + 1);      // [TB][D+1]
    Vs = Ks + TB * (D + 1);       // [TB][D+1]
    Ps = Vs + TB * (D + 1);       // [TB][TB+1]  P_use
    dSs = Ps + TB * (TB + 1);     // [TB][TB+1]  dS
    lse_s = dSs + TB * (TB + 1);  // [TB]
    delta_s = lse_s + TB;         // [TB]
    k_ok = reinterpret_cast<int*>(delta_s + TB);
    k_sid = k_ok + TB;
    k_act = k_sid + TB;
    k_blk = k_act + TB;
    q_in = k_blk + TB;
    q_sid = q_in + TB;
    q_act = q_sid + TB;
    q_blk = q_act + TB;
  }
};

// Query tile q0 of head h: q, dO rows, lse, delta and the query-side streams.
// The wide route loads columns [c0, c0 + D) of heads `dw` wide.
template <int D>
__device__ void load_q_tile(const Tiles<D>& t, const float* q, const float* dout, const float* lse,
                            const float* delta, const Streams& st, int q0, int h, int b, int S,
                            int H, int dw = D, int c0 = 0) {
  constexpr int TB = F32Tile<D>::TB;
  const size_t qstride = static_cast<size_t>(H) * dw;
  const size_t row0 = static_cast<size_t>(b) * S;
  for (int idx = threadIdx.x; idx < TB * D; idx += NT) {
    const int r = idx / D, c = idx % D, qi = q0 + r;
    const bool in = qi < S;
    const size_t off = (row0 + qi) * qstride + h * dw + c0 + c;
    t.Qs[r * (D + 1) + c] = in ? q[off] : 0.f;
    t.dOs[r * (D + 1) + c] = in ? dout[off] : 0.f;
  }
  for (int r = threadIdx.x; r < TB; r += NT) {
    const int qi = q0 + r;
    const bool in = qi < S;
    const size_t hr = (static_cast<size_t>(b) * H + h) * S + qi;
    t.lse_s[r] = in ? lse[hr] : 0.f;
    t.delta_s[r] = in ? delta[hr] : 0.f;
    t.q_in[r] = in;
    t.q_sid[r] = in ? st.sid[row0 + qi] : 0;
    t.q_act[r] = in ? st.act[row0 + qi] : 0;
    t.q_blk[r] = in ? st.blk[row0 + qi] : -1;
  }
}

// Key tile k0 of kv head hk: k, v rows and the key-side streams (columns
// [c0, c0 + D) of heads `dw` wide in the wide route).
template <int D>
__device__ void load_k_tile(const Tiles<D>& t, const float* k, const float* v, const Streams& st,
                            int k0, int hk, int b, int S, int Hkv, int dw = D, int c0 = 0) {
  constexpr int TB = F32Tile<D>::TB;
  const size_t kstride = static_cast<size_t>(Hkv) * dw;
  const size_t row0 = static_cast<size_t>(b) * S;
  for (int idx = threadIdx.x; idx < TB * D; idx += NT) {
    const int r = idx / D, c = idx % D, ki = k0 + r;
    const bool in = ki < S;
    const size_t off = (row0 + ki) * kstride + hk * dw + c0 + c;
    t.Ks[r * (D + 1) + c] = in ? k[off] : 0.f;
    t.Vs[r * (D + 1) + c] = in ? v[off] : 0.f;
  }
  for (int r = threadIdx.x; r < TB; r += NT) {
    const int ki = k0 + r;
    const bool in = ki < S;
    t.k_ok[r] = in ? (st.attn[row0 + ki] == 1) : 0;
    t.k_sid[r] = in ? st.sid[row0 + ki] : 0;
    t.k_act[r] = in ? st.act[row0 + ki] : 0;
    t.k_blk[r] = in ? st.blk[row0 + ki] : -1;
  }
}

// s += Q K^T and dp += dO V^T over the D loaded columns. Thread (ty, tx)
// computes rows ty + 16i and columns tx + 16j.
template <int D>
__device__ void tile_scores(const Tiles<D>& t, float (&s)[F32Tile<D>::R][F32Tile<D>::R],
                            float (&dp)[F32Tile<D>::R][F32Tile<D>::R]) {
  constexpr int R = F32Tile<D>::R;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[R], oa[R], kb[R], vb[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qa[i] = t.Qs[(ty + 16 * i) * (D + 1) + d];
      oa[i] = t.dOs[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kb[j] = t.Ks[(tx + 16 * j) * (D + 1) + d];
      vb[j] = t.Vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
}

// P_use and dS of the loaded (query tile, key tile) from its scores s and
// dp into Ps / dSs.
template <int D>
__device__ void tile_finish(const Tiles<D>& t, const float (&s)[F32Tile<D>::R][F32Tile<D>::R],
                            const float (&dp)[F32Tile<D>::R][F32Tile<D>::R], int kind, int q0,
                            int k0, float scale, uint32_t bh, uint32_t seed, uint32_t thresh,
                            float inv_keep) {
  constexpr int R = F32Tile<D>::R, TB = F32Tile<D>::TB;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool drop = thresh > 0u;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      const int kpos = k0 + c;
      const bool ok = t.q_in[r] &&
                      gamer::attn_allowed(kind, qpos, kpos, t.q_sid[r], t.k_sid[c], t.q_act[r],
                                          t.k_act[c], t.q_blk[r], t.k_blk[c], t.k_ok[c]);
      const float p = ok ? expf(s[i][j] * scale - t.lse_s[r]) : 0.f;
      float p_use = p;
      if (drop && p != 0.f)
        p_use = gamer::hash_keep(seed, bh, static_cast<uint32_t>(qpos),
                                 static_cast<uint32_t>(kpos), thresh)
                    ? p * inv_keep
                    : 0.f;
      t.Ps[r * (TB + 1) + c] = p_use;
      t.dSs[r * (TB + 1) + c] = p_use * dp[i][j] - p * t.delta_s[r];
    }
  }
}

// P_use and dS of query tile q0 (head h) against key tile k0 (kv head hk)
// into Ps / dSs. Unless WIDE both tiles are loaded whole; WIDE walks the `dw`
// columns of a head in D-wide slices, loading each, and leaves the last
// slice loaded.
template <int D, bool WIDE>
__device__ void tile_grads(const Tiles<D>& t, const float* q, const float* k, const float* v,
                           const float* dout, const float* lse, const float* delta,
                           const Streams& st, int kind, int q0, int h, int k0, int hk, int b,
                           int S, int H, int Hkv, int dw, float scale, uint32_t seed,
                           uint32_t thresh, float inv_keep) {
  constexpr int R = F32Tile<D>::R;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
  if constexpr (WIDE) {
    for (int d0 = 0; d0 < dw; d0 += D) {
      __syncthreads();  // the previous slice's reads are done
      load_q_tile<D>(t, q, dout, lse, delta, st, q0, h, b, S, H, dw, d0);
      load_k_tile<D>(t, k, v, st, k0, hk, b, S, Hkv, dw, d0);
      __syncthreads();
      tile_scores<D>(t, s, dp);
    }
  } else {
    tile_scores<D>(t, s, dp);
  }
  tile_finish<D>(t, s, dp, kind, q0, k0, scale, static_cast<uint32_t>(b * H + h), seed, thresh,
                 inv_keep);
}

// WIDE (head dims over 256): heads are `dw` wide, D is the slice width and
// the block of dK/dV columns this CTA owns (blockIdx.y = kv head * (dw / D)
// + block).
template <int D, bool WIDE = false>
__global__ void __launch_bounds__(NT) attn_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    Streams st, float* __restrict__ dk, float* __restrict__ dv, int S, int H, int Hkv, int kind,
    float scale, gamer::Seed seed_in, uint32_t thresh, float inv_keep, int dw) {
  const uint32_t seed = seed_in.get();
  constexpr int R = F32Tile<D>::R, TB = F32Tile<D>::TB;
  extern __shared__ float smem[];
  const Tiles<D> t(smem);
  const int Dw = WIDE ? dw : D;
  const int ncb = WIDE ? dw / D : 1;
  const int k0 = blockIdx.x * TB;
  const int hk = blockIdx.y / ncb;
  const int dc0 = (blockIdx.y % ncb) * D;  // this CTA's dK/dV columns
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int DC = D / 16;

  if constexpr (!WIDE) load_k_tile<D>(t, k, v, st, k0, hk, b, S, Hkv);
  float dk_acc[R][DC], dv_acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal kinds: query tiles that end before this key tile see none of it
  const int q_begin = (kind == gamer::kCausal || kind == gamer::kMulti) ? k0 : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = q_begin; q0 < S; q0 += TB) {
      __syncthreads();  // previous tile's reads are done
      if constexpr (!WIDE) load_q_tile<D>(t, q, dout, lse, delta, st, q0, h, b, S, H);
      __syncthreads();
      tile_grads<D, WIDE>(t, q, k, v, dout, lse, delta, st, kind, q0, h, k0, hk, b, S, H, Hkv, Dw,
                          scale, seed, thresh, inv_keep);
      __syncthreads();
      if constexpr (WIDE) {  // Q's and dO's columns of this CTA for dK and dV
        load_q_tile<D>(t, q, dout, lse, delta, st, q0, h, b, S, H, dw, dc0);
        __syncthreads();
      }
#pragma unroll 4
      for (int r = 0; r < TB; ++r) {
        float pu[R], ds[R], od[DC], qd[DC];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pu[i] = t.Ps[r * (TB + 1) + ty + 16 * i];
          ds[i] = t.dSs[r * (TB + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          od[j] = t.dOs[r * (D + 1) + tx + 16 * j];
          qd[j] = t.Qs[r * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            dv_acc[i][j] = fmaf(pu[i], od[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds[i], qd[j], dk_acc[i][j]);
          }
      }
    }
  }

  const size_t kstride = static_cast<size_t>(Hkv) * Dw;
  const size_t row0 = static_cast<size_t>(b) * S;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki >= S) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const size_t off = (row0 + ki) * kstride + hk * Dw + dc0 + tx + 16 * j;
      dk[off] = dk_acc[i][j] * scale;
      dv[off] = dv_acc[i][j];
    }
  }
}

// WIDE as the dkv kernel, with blockIdx.y = head * (dw / D) + block of dQ
// columns.
template <int D, bool WIDE = false>
__global__ void __launch_bounds__(NT) attn_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    Streams st, float* __restrict__ dq, int S, int H, int Hkv, int kind, float scale,
    gamer::Seed seed_in, uint32_t thresh, float inv_keep, int dw) {
  const uint32_t seed = seed_in.get();
  constexpr int R = F32Tile<D>::R, TB = F32Tile<D>::TB;
  extern __shared__ float smem[];
  const Tiles<D> t(smem);
  const int Dw = WIDE ? dw : D;
  const int ncb = WIDE ? dw / D : 1;
  const int q0 = blockIdx.x * TB;
  const int h = blockIdx.y / ncb;
  const int dc0 = (blockIdx.y % ncb) * D;  // this CTA's dQ columns
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int DC = D / 16;

  if constexpr (!WIDE) load_q_tile<D>(t, q, dout, lse, delta, st, q0, h, b, S, H);
  float dq_acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dq_acc[i][j] = 0.f;

  const int q_last = min(q0 + TB, S) - 1;
  const int k_end = (kind == gamer::kCausal || kind == gamer::kMulti) ? q_last + 1 : S;
  for (int k0 = 0; k0 < k_end; k0 += TB) {
    __syncthreads();
    if constexpr (!WIDE) load_k_tile<D>(t, k, v, st, k0, hk, b, S, Hkv);
    __syncthreads();
    tile_grads<D, WIDE>(t, q, k, v, dout, lse, delta, st, kind, q0, h, k0, hk, b, S, H, Hkv, Dw,
                        scale, seed, thresh, inv_keep);
    __syncthreads();
    if constexpr (WIDE) {  // K's columns of this CTA for dQ
      load_k_tile<D>(t, k, v, st, k0, hk, b, S, Hkv, dw, dc0);
      __syncthreads();
    }
#pragma unroll 4
    for (int c = 0; c < TB; ++c) {
      float ds[R], kd[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = t.dSs[(ty + 16 * i) * (TB + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) kd[j] = t.Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) dq_acc[i][j] = fmaf(ds[i], kd[j], dq_acc[i][j]);
    }
  }

  const size_t qstride = static_cast<size_t>(H) * Dw;
  const size_t row0 = static_cast<size_t>(b) * S;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq[(row0 + qi) * qstride + h * Dw + dc0 + tx + 16 * j] = dq_acc[i][j] * scale;
  }
}

// delta[b, h, s] = sum_d dO * O in fp32: LPR lanes a (row, head), each
// summing 16-byte chunks of both in order, then shuffles in a fixed order.
// DT is D at compile time (LPR 4 to 32, the same count of chunks for every
// lane), or 0 for the wide route's runtime D `Dw`, a multiple of 64 (LPR 32).
template <typename T, int DT>
__global__ void __launch_bounds__(256) attn_delta_kernel(const T* __restrict__ out,
                                                         const T* __restrict__ dout,
                                                         float* __restrict__ delta, int S, int H,
                                                         int Dw, size_t rows) {
  constexpr int EPV = 16 / sizeof(T);                              // elements a 16-byte load
  constexpr int LPR = DT == 0 || DT / EPV >= 32 ? 32 : DT / EPV;   // lanes a row (4 to 32)
  const int D = DT ? DT : Dw;
  const int VPL = (D / EPV + LPR - 1) / LPR;                       // 16-byte loads a lane
  const size_t gid = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  const size_t row = gid / LPR;  // (b * S + s) * H + h
  float acc = 0.f;
  if (row < rows) {
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const size_t c = ((gid % LPR) + u * LPR) * EPV;
      if (DT == 0 && c >= static_cast<size_t>(D)) break;
      const size_t off = row * D + c;
      const uint4 ov = *reinterpret_cast<const uint4*>(out + off);
      const uint4 gv = *reinterpret_cast<const uint4*>(dout + off);
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
      for (int e = 0; e < EPV; ++e) acc = fmaf(to_f(oe[e]), to_f(ge[e]), acc);
    }
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (row < rows && gid % LPR == 0) {
    const size_t bs = row / H, b = bs / S;
    const int h = static_cast<int>(row % H), s = static_cast<int>(bs % S);
    delta[(b * H + h) * S + s] = acc;
  }
}

// ---- bf16 on the tensor cores

template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  // K, V [BK][D+8]; 2 stages of Q, dO [BQ][D+8], of (lse * log2 e, delta)
  // and of the query streams (in, sid, act, blk)
  return sizeof(bf16) * (2 * BK + 4 * BQ) * (D + 8) + 2 * BQ * (sizeof(float2) + sizeof(int4));
}

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  // Q, dO [BQ][D+8]; 2 stages of K, V [BK][D+8] and of the key streams
  // (ok, sid, act, blk)
  return sizeof(bf16) * (2 * BQ + 4 * BK) * (D + 8) + 2 * BK * sizeof(int4);
}

// Output columns a bf16 CTA owns: all of D up to 128; at D 256 two CTAs
// take 128 columns each of dK/dV (dQ), recomputing the scores, because a
// warp cannot hold 16 x 256 fp32 accumulators of both dK and dV.
template <int D>
struct TcCols {
  static constexpr int DO = D > 128 ? 128 : D;
  static constexpr int NCB = D / DO;  // column blocks
};

template <int D>
__global__ void __launch_bounds__(TC_NT, D > 128 ? 1 : D > 64 ? 2 : 3) attn_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, Streams st, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ ws, int nsplit, int S, int H, int Hkv, int kind, float scale,
    gamer::Seed seed_in, uint32_t thresh, float inv_keep) {
  const uint32_t seed = seed_in.get();
  constexpr int LD = D + 8;
  constexpr int NDT = TcCols<D>::DO / 8;   // 8-wide dK/dV column tiles of this CTA
  constexpr int QC = D > 64 ? 16 : D > 32 ? 32 : 64;  // query columns a step (registers)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);                  // [BK][LD]
  bf16* Vs = Ks + BK * LD;                                       // [BK][LD]
  bf16* QOs = Vs + BK * LD;                                      // stage s: Q, dO [BQ][LD]
  float2* qld = reinterpret_cast<float2*>(QOs + 4 * BQ * LD);    // stage s: [BQ]
  int4* qst = reinterpret_cast<int4*>(qld + 2 * BQ);             // stage s: [BQ]

  const int nq = (S + BQ - 1) / BQ;
  const int kt = blockIdx.z;  // key tile 0 first: it has the most query tiles
  const int k0 = kt * BK;
  const int dc0 = (blockIdx.x % TcCols<D>::NCB) * TcCols<D>::DO;  // this CTA's columns
  const int hs = blockIdx.x / TcCols<D>::NCB;
  const int hk = hs / nsplit, split = hs % nsplit;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(Hkv) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  const bool drop = thresh > 0u;
  const float sl2 = scale * LOG2E;

  // the (query head, query tile) pairs of this CTA: query tiles from the key
  // tile on for the causal kinds (BQ == BK), split into nsplit shares
  const int qt0 = (kind == gamer::kCausal || kind == gamer::kMulti) ? kt : 0;
  const int nqe = nq - qt0;
  const long long pairs = static_cast<long long>(G) * nqe;
  const int i_begin = static_cast<int>(pairs * split / nsplit);
  const int n = static_cast<int>(pairs * (split + 1) / nsplit) - i_begin;

  // this thread's two keys: k0 + warp*16 + lane/4 and + 8
  int kpos[2];
  int4 kinf[2];  // (ok, sid, act, blk)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = k0 + warp * 16 + lane / 4 + 8 * i;
    const size_t r = row0 + kpos[i];
    kinf[i] = kpos[i] < S ? make_int4(st.attn[r] == 1, st.sid[r], st.act[r], st.blk[r])
                          : make_int4(0, 0, 0, -1);
  }

  load_tile_async<BK, D, TC_NT>(Ks, k + row0 * kstride + hk * D, kstride, k0, S);
  load_tile_async<BK, D, TC_NT>(Vs, v + row0 * kstride + hk * D, kstride, k0, S);
  auto load_q = [&](int it) {
    const int idx = i_begin + it, h = hk * G + idx / nqe, q0 = (qt0 + idx % nqe) * BQ;
    const int s = it & 1;
    load_tile_async<BQ, D, TC_NT>(QOs + (2 * s) * BQ * LD, q + row0 * qstride + h * D, qstride,
                                  q0, S);
    load_tile_async<BQ, D, TC_NT>(QOs + (2 * s + 1) * BQ * LD, dout + row0 * qstride + h * D,
                                  qstride, q0, S);
    for (int r = threadIdx.x; r < BQ; r += TC_NT) {
      const int qi = q0 + r;
      const size_t hr = (static_cast<size_t>(b) * H + h) * S + qi;
      const bool in = qi < S;
      qld[s * BQ + r] = in ? make_float2(lse[hr] * LOG2E, delta[hr]) : make_float2(0.f, 0.f);
      qst[s * BQ + r] = in ? make_int4(1, st.sid[row0 + qi], st.act[row0 + qi], st.blk[row0 + qi])
                           : make_int4(0, 0, 0, -1);
    }
  };
  if (n > 0) load_q(0);
  cp_async_commit();

  float dk_acc[NDT][4], dv_acc[NDT][4];
#pragma unroll
  for (int c = 0; c < NDT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // pair it (and K, V) have landed
    __syncthreads();
    const int idx = i_begin + it, h = hk * G + idx / nqe, q0 = (qt0 + idx % nqe) * BQ;
    const uint32_t bh = static_cast<uint32_t>(b * H + h);
    const int s = it & 1;
    const bf16* Qs = QOs + (2 * s) * BQ * LD;
    const bf16* dOs = Qs + BQ * LD;
    const float2* ql = qld + s * BQ;
    const int4* qs = qst + s * BQ;

#pragma unroll
    for (int qc = 0; qc < BQ; qc += QC) {
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x QC queries
      float sT[QC / 8][4], dpT[QC / 8][4];
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, a_addr(Ks, LD, warp * 16, kk, lane));
        ldsm_x4(va, a_addr(Vs, LD, warp * 16, kk, lane));
#pragma unroll
        for (int np = 0; np < QC / 16; ++np) {
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, bn_addr(Qs, LD, qc + np * 16, kk, lane));
          ldsm_x4(ob, bn_addr(dOs, LD, qc + np * 16, kk, lane));
          mma_bf16(sT[2 * np], ka, qb[0], qb[1]);
          mma_bf16(sT[2 * np + 1], ka, qb[2], qb[3]);
          mma_bf16(dpT[2 * np], va, ob[0], ob[1]);
          mma_bf16(dpT[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      // P_use^T into sT, dS^T into dpT (fp32); sT * scale - lse, or -inf
      gamer::mask_tile_krows(kind, sT, kpos, kinf, qs + qc, q0 + qc, sl2, ql + qc, lane);
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = exp2f(sT[j][e]);
      if (drop) {  // branch-free per element: one uniform test a step
#pragma unroll
        for (int j = 0; j < QC / 8; ++j)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int c = qc + 8 * j + 2 * (lane % 4) + cc;  // query q0 + c
            const float dlt = ql[c].y;
            const uint32_t qh = gamer::hash_row(seed, bh, static_cast<uint32_t>(q0 + c));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 2 * i + cc;
              const float p = sT[j][e];
              const float p_use =
                  gamer::hash_keep_at(qh, static_cast<uint32_t>(kpos[i]), thresh) ? p * inv_keep
                                                                                  : 0.f;
              dpT[j][e] = p_use * dpT[j][e] - p * dlt;
              sT[j][e] = p_use;
            }
          }
      } else {
#pragma unroll
        for (int j = 0; j < QC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpT[j][e] = sT[j][e] * (dpT[j][e] - ql[qc + 8 * j + 2 * (lane % 4) + (e & 1)].y);
      }
      // dV += P_use^T dO, dK += dS^T Q over these QC queries
#pragma unroll
      for (int kc = 0; kc < QC / 16; ++kc) {
        const uint32_t pa[4] = {pack_bf16(sT[2 * kc][0], sT[2 * kc][1]),
                                pack_bf16(sT[2 * kc][2], sT[2 * kc][3]),
                                pack_bf16(sT[2 * kc + 1][0], sT[2 * kc + 1][1]),
                                pack_bf16(sT[2 * kc + 1][2], sT[2 * kc + 1][3])};
        const uint32_t da[4] = {pack_bf16(dpT[2 * kc][0], dpT[2 * kc][1]),
                                pack_bf16(dpT[2 * kc][2], dpT[2 * kc][3]),
                                pack_bf16(dpT[2 * kc + 1][0], dpT[2 * kc + 1][1]),
                                pack_bf16(dpT[2 * kc + 1][2], dpT[2 * kc + 1][3])};
#pragma unroll
        for (int np = 0; np < NDT / 2; ++np) {
          uint32_t ob[4], qb[4];
          ldsm_x4_trans(ob, bk_addr(dOs, LD, qc + kc * 16, dc0 + np * 16, lane));
          ldsm_x4_trans(qb, bk_addr(Qs, LD, qc + kc * 16, dc0 + np * 16, lane));
          mma_bf16(dv_acc[2 * np], pa, ob[0], ob[1]);
          mma_bf16(dv_acc[2 * np + 1], pa, ob[2], ob[3]);
          mma_bf16(dk_acc[2 * np], da, qb[0], qb[1]);
          mma_bf16(dk_acc[2 * np + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // stage s is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();

  const size_t count = static_cast<size_t>(gridDim.y) * S * kstride;  // B * S * Hkv * D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= S) continue;
    const size_t off = (row0 + kpos[i]) * kstride + hk * D + dc0 + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < NDT; ++c) {
      const float k0v = dk_acc[c][2 * i] * scale, k1v = dk_acc[c][2 * i + 1] * scale;
      const float v0v = dv_acc[c][2 * i], v1v = dv_acc[c][2 * i + 1];
      if (nsplit == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * c) = __floats2bfloat162_rn(k0v, k1v);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * c) = __floats2bfloat162_rn(v0v, v1v);
      } else {  // fp32 partials: dK at ws[split], dV at ws[nsplit + split]
        *reinterpret_cast<float2*>(ws + split * count + off + 8 * c) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(ws + (nsplit + split) * count + off + 8 * c) =
            make_float2(v0v, v1v);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_NT, D > 128 ? 1 : D > 64 ? 2 : 3) attn_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, Streams st, bf16* __restrict__ dq, int S, int H, int Hkv,
    int kind, float scale, gamer::Seed seed_in, uint32_t thresh, float inv_keep) {
  const uint32_t seed = seed_in.get();
  constexpr int LD = D + 8;
  constexpr int NDT = TcCols<D>::DO / 8;  // 8-wide dQ column tiles of this CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);           // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                               // [BQ][LD]
  bf16* KVs = dOs + BQ * LD;                              // stage s: K, V [BK][LD]
  int4* kst = reinterpret_cast<int4*>(KVs + 4 * BK * LD);  // stage s: [BK]

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * BQ;  // longest rows first
  const int h = blockIdx.x / TcCols<D>::NCB;
  const int dc0 = (blockIdx.x % TcCols<D>::NCB) * TcCols<D>::DO;  // this CTA's columns
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(Hkv) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  const bf16* kg = k + row0 * kstride + hk * D;
  const bf16* vg = v + row0 * kstride + hk * D;
  const bool drop = thresh > 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const float sl2 = scale * LOG2E;

  // this thread's two query rows: warp*16 + lane/4 and + 8, their streams
  // (in, sid, act, blk), lse * log2 e, delta and dropout hash row part
  int qpos[2];
  int4 qinf[2];
  float lse2[2], dlt[2];
  uint32_t qhash[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + warp * 16 + lane / 4 + 8 * i;
    const bool in = qpos[i] < S;
    const size_t r = row0 + qpos[i], hr = (static_cast<size_t>(b) * H + h) * S + qpos[i];
    qinf[i] = in ? make_int4(1, st.sid[r], st.act[r], st.blk[r]) : make_int4(0, 0, 0, -1);
    lse2[i] = in ? lse[hr] * LOG2E : 0.f;
    dlt[i] = in ? delta[hr] : 0.f;
    qhash[i] = gamer::hash_row(seed, bh, static_cast<uint32_t>(qpos[i]));
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = (kind == gamer::kCausal || kind == gamer::kMulti) ? q_last + 1 : S;
  const int ntiles = (k_end + BK - 1) / BK;

  auto load_kv = [&](int t) {
    const int s = t & 1, kb = t * BK;
    load_tile_async<BK, D, TC_NT>(KVs + (2 * s) * BK * LD, kg, kstride, kb, S);
    load_tile_async<BK, D, TC_NT>(KVs + (2 * s + 1) * BK * LD, vg, kstride, kb, S);
    for (int r = threadIdx.x; r < BK; r += TC_NT) {
      const int ki = kb + r;
      kst[s * BK + r] = ki < S ? make_int4(st.attn[row0 + ki] == 1, st.sid[row0 + ki],
                                           st.act[row0 + ki], st.blk[row0 + ki])
                               : make_int4(0, 0, 0, -1);
    }
  };

  load_tile_async<BQ, D, TC_NT>(Qs, q + row0 * qstride + h * D, qstride, q0, S);
  load_tile_async<BQ, D, TC_NT>(dOs, dout + row0 * qstride + h * D, qstride, q0, S);
  load_kv(0);
  cp_async_commit();

  float dq_acc[NDT][4];
#pragma unroll
  for (int c = 0; c < NDT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[c][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q, dO) have landed
    __syncthreads();
    const int s = t & 1, k0 = t * BK;
    const bf16* Ks = KVs + (2 * s) * BK * LD;
    const bf16* Vs = Ks + BK * LD;
    const int4* ks = kst + s * BK;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, a_addr(Qs, LD, warp * 16, kk, lane));
      ldsm_x4(oa, a_addr(dOs, LD, warp * 16, kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, bn_addr(Ks, LD, np * 16, kk, lane));
        ldsm_x4(vb, bn_addr(Vs, LD, np * 16, kk, lane));
        mma_bf16(sc[2 * np], qa, kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * np], oa, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }
    // dS into sc (fp32); sc * scale - lse, or -inf, first
    gamer::mask_tile_qrows(kind, sc, qpos, qinf, ks, k0, sl2, lse2, lane);
    if (drop) {  // branch-free per element: one uniform test a tile
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[j][e]);
          const float p_use =
              gamer::hash_keep_at(qhash[e >> 1],
                                  static_cast<uint32_t>(k0 + 8 * j + 2 * (lane % 4) + (e & 1)),
                                  thresh)
                  ? p * inv_keep
                  : 0.f;
          sc[j][e] = p_use * dp[j][e] - p * dlt[e >> 1];
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = exp2f(sc[j][e]) * (dp[j][e] - dlt[e >> 1]);
    }
    // dQ += dS K: K through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t da[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                              pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NDT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, bk_addr(Ks, LD, kc * 16, dc0 + np * 16, lane));
        mma_bf16(dq_acc[2 * np], da, kb[0], kb[1]);
        mma_bf16(dq_acc[2 * np + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();  // stage s is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= S) continue;
    bf16* row = dq + (row0 + qpos[i]) * qstride + h * D + dc0 + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < NDT; ++c)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * c) =
          __floats2bfloat162_rn(dq_acc[c][0 + 2 * i] * scale, dq_acc[c][1 + 2 * i] * scale);
  }
}

// ---- the wide route in bf16 (head dims over 256)

using WideTiles = StreamTiles<8, false>;

constexpr size_t dq_wide_tc_smem_bytes() {
  // the streamed slices; K's column block [BK][WO+8]; the key streams
  return WideTiles::smem_bytes + sizeof(bf16) * BK * (WO + 8) + sizeof(int4) * BK;
}

constexpr size_t dkv_wide_tc_smem_bytes() {
  // the streamed slices; Q's and dO's column blocks [BQ][WO+8];
  // (lse * log2 e, delta) and the query streams
  return WideTiles::smem_bytes + sizeof(bf16) * 2 * BQ * (WO + 8) +
         BQ * (sizeof(float2) + sizeof(int4));
}

// dQ: blockIdx.x = head * (D / WO) + column block, as attn_dq_tc_kernel
// otherwise; S = Q K^T and dP = dO V^T of each key tile by stream_mma.
__global__ void __launch_bounds__(TC_NT) attn_dq_wide_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, Streams st, bf16* __restrict__ dq, int S, int H, int Hkv,
    int D, int kind, float scale, gamer::Seed seed_in, uint32_t thresh, float inv_keep) {
  const uint32_t seed = seed_in.get();
  constexpr int LK = WO + 8;
  constexpr int NDT = WO / 8;  // 8-wide dQ column tiles of this CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);      // stream_mma's two stages
  bf16* Kb = buf + 2 * WideTiles::STAGE;              // [BK][LK]
  int4* kst = reinterpret_cast<int4*>(Kb + BK * LK);  // (ok, sid, act, blk) [BK]

  const int ncb = D / WO;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * BQ;  // longest rows first
  const int h = blockIdx.x / ncb;
  const int dc0 = (blockIdx.x % ncb) * WO;  // this CTA's columns
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(Hkv) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  const bf16* qg = q + (row0 + q0) * qstride + h * D;
  const bf16* og = dout + (row0 + q0) * qstride + h * D;
  const bf16* kg = k + row0 * kstride + hk * D;
  const bf16* vg = v + row0 * kstride + hk * D;
  const bool drop = thresh > 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const float sl2 = scale * LOG2E;

  int qpos[2];
  int4 qinf[2];
  float lse2[2], dlt[2];
  uint32_t qhash[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + warp * 16 + lane / 4 + 8 * i;
    const bool in = qpos[i] < S;
    const size_t r = row0 + qpos[i], hr = (static_cast<size_t>(b) * H + h) * S + qpos[i];
    qinf[i] = in ? make_int4(1, st.sid[r], st.act[r], st.blk[r]) : make_int4(0, 0, 0, -1);
    lse2[i] = in ? lse[hr] * LOG2E : 0.f;
    dlt[i] = in ? delta[hr] : 0.f;
    qhash[i] = gamer::hash_row(seed, bh, static_cast<uint32_t>(qpos[i]));
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = (kind == gamer::kCausal || kind == gamer::kMulti) ? q_last + 1 : S;
  const int ntiles = (k_end + BK - 1) / BK;

  float dq_acc[NDT][4];
#pragma unroll
  for (int c = 0; c < NDT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[c][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    const size_t koff = static_cast<size_t>(k0) * kstride;
    __syncthreads();  // the previous tile's reads of Kb and kst are done
    load_block_async<BK, WO, TC_NT>(Kb, LK, kg + koff + dc0, kstride, S - k0, WO);
    cp_async_commit();  // lands by stream_mma's first product
    for (int r = threadIdx.x; r < BK; r += TC_NT) {
      const int ki = k0 + r;
      kst[r] = ki < S ? make_int4(st.attn[row0 + ki] == 1, st.sid[row0 + ki], st.act[row0 + ki],
                                  st.blk[row0 + ki])
                      : make_int4(0, 0, 0, -1);
    }
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    stream_mma<8, false, TC_NT>(sc, buf, qg, qstride, S - q0, kg + koff, nullptr, kstride, S - k0,
                                D, warp, lane);
    stream_mma<8, false, TC_NT>(dp, buf, og, qstride, S - q0, vg + koff, nullptr, kstride, S - k0,
                                D, warp, lane);
    gamer::mask_tile_qrows(kind, sc, qpos, qinf, kst, k0, sl2, lse2, lane);
    if (drop) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[j][e]);
          const float p_use =
              gamer::hash_keep_at(qhash[e >> 1],
                                  static_cast<uint32_t>(k0 + 8 * j + 2 * (lane % 4) + (e & 1)),
                                  thresh)
                  ? p * inv_keep
                  : 0.f;
          sc[j][e] = p_use * dp[j][e] - p * dlt[e >> 1];
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = exp2f(sc[j][e]) * (dp[j][e] - dlt[e >> 1]);
    }
    // dQ += dS K over this CTA's columns
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t da[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                              pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NDT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, bk_addr(Kb, LK, kc * 16, np * 16, lane));
        mma_bf16(dq_acc[2 * np], da, kb[0], kb[1]);
        mma_bf16(dq_acc[2 * np + 1], da, kb[2], kb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= S) continue;
    bf16* row = dq + (row0 + qpos[i]) * qstride + h * D + dc0 + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < NDT; ++c)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * c) =
          __floats2bfloat162_rn(dq_acc[c][0 + 2 * i] * scale, dq_acc[c][1 + 2 * i] * scale);
  }
}

// dK, dV: blockIdx.x = kv head * (D / WO) + column block, blockIdx.z the
// key tile; every (query head of the group, query tile) pair in order, as
// attn_dkv_tc_kernel with nsplit 1. S^T = K Q^T and dP^T = V dO^T by
// stream_mma over all of D, the products with Q's and dO's column blocks.
__global__ void __launch_bounds__(TC_NT) attn_dkv_wide_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, Streams st, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int S, int H, int Hkv, int D, int kind, float scale, gamer::Seed seed_in, uint32_t thresh,
    float inv_keep) {
  const uint32_t seed = seed_in.get();
  constexpr int LQ = WO + 8;
  constexpr int NDT = WO / 8;  // 8-wide dK/dV column tiles of this CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);       // stream_mma's two stages
  bf16* Qb = buf + 2 * WideTiles::STAGE;               // [BQ][LQ]
  bf16* dOb = Qb + BQ * LQ;                            // [BQ][LQ]
  float2* qld = reinterpret_cast<float2*>(dOb + BQ * LQ);  // (lse * log2 e, delta) [BQ]
  int4* qst = reinterpret_cast<int4*>(qld + BQ);       // (in, sid, act, blk) [BQ]

  const int ncb = D / WO;
  const int nq = (S + BQ - 1) / BQ;
  const int kt = blockIdx.z;
  const int k0 = kt * BK;
  const int hk = blockIdx.x / ncb;
  const int dc0 = (blockIdx.x % ncb) * WO;  // this CTA's columns
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(Hkv) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  const bf16* kg = k + (row0 + k0) * kstride + hk * D;
  const bf16* vg = v + (row0 + k0) * kstride + hk * D;
  const bool drop = thresh > 0u;
  const float sl2 = scale * LOG2E;

  // query tiles from the key tile on for the causal kinds (BQ == BK)
  const int qt0 = (kind == gamer::kCausal || kind == gamer::kMulti) ? kt : 0;
  const int nqe = nq - qt0;
  const int n = G * nqe;

  int kpos[2];
  int4 kinf[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = k0 + warp * 16 + lane / 4 + 8 * i;
    const size_t r = row0 + kpos[i];
    kinf[i] = kpos[i] < S ? make_int4(st.attn[r] == 1, st.sid[r], st.act[r], st.blk[r])
                          : make_int4(0, 0, 0, -1);
  }

  float dk_acc[NDT][4], dv_acc[NDT][4];
#pragma unroll
  for (int c = 0; c < NDT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int h = hk * G + it / nqe, q0 = (qt0 + it % nqe) * BQ;
    const uint32_t bh = static_cast<uint32_t>(b * H + h);
    const bf16* qg = q + (row0 + q0) * qstride + h * D;
    const bf16* og = dout + (row0 + q0) * qstride + h * D;
    __syncthreads();  // the previous pair's reads of Qb, dOb, qld and qst are done
    load_block_async<BQ, WO, TC_NT>(Qb, LQ, qg + dc0, qstride, S - q0, WO);
    load_block_async<BQ, WO, TC_NT>(dOb, LQ, og + dc0, qstride, S - q0, WO);
    cp_async_commit();  // lands by stream_mma's first product
    for (int r = threadIdx.x; r < BQ; r += TC_NT) {
      const int qi = q0 + r;
      const size_t hr = (static_cast<size_t>(b) * H + h) * S + qi;
      const bool in = qi < S;
      qld[r] = in ? make_float2(lse[hr] * LOG2E, delta[hr]) : make_float2(0.f, 0.f);
      qst[r] = in ? make_int4(1, st.sid[row0 + qi], st.act[row0 + qi], st.blk[row0 + qi])
                  : make_int4(0, 0, 0, -1);
    }
    // S^T and dP^T: this warp's 16 keys x the 64 queries
    float sT[8][4], dpT[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
    stream_mma<8, false, TC_NT>(sT, buf, kg, kstride, S - k0, qg, nullptr, qstride, S - q0, D,
                                warp, lane);
    stream_mma<8, false, TC_NT>(dpT, buf, vg, kstride, S - k0, og, nullptr, qstride, S - q0, D,
                                warp, lane);
    // P_use^T into sT, dS^T into dpT (fp32)
    gamer::mask_tile_krows(kind, sT, kpos, kinf, qst, q0, sl2, qld, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = exp2f(sT[j][e]);
    if (drop) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = 8 * j + 2 * (lane % 4) + cc;  // query q0 + c
          const float dlt = qld[c].y;
          const uint32_t qh = gamer::hash_row(seed, bh, static_cast<uint32_t>(q0 + c));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + cc;
            const float p = sT[j][e];
            const float p_use =
                gamer::hash_keep_at(qh, static_cast<uint32_t>(kpos[i]), thresh) ? p * inv_keep
                                                                                : 0.f;
            dpT[j][e] = p_use * dpT[j][e] - p * dlt;
            sT[j][e] = p_use;
          }
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpT[j][e] = sT[j][e] * (dpT[j][e] - qld[8 * j + 2 * (lane % 4) + (e & 1)].y);
    }
    // dV += P_use^T dO, dK += dS^T Q over this CTA's columns
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pa[4] = {pack_bf16(sT[2 * kc][0], sT[2 * kc][1]),
                              pack_bf16(sT[2 * kc][2], sT[2 * kc][3]),
                              pack_bf16(sT[2 * kc + 1][0], sT[2 * kc + 1][1]),
                              pack_bf16(sT[2 * kc + 1][2], sT[2 * kc + 1][3])};
      const uint32_t da[4] = {pack_bf16(dpT[2 * kc][0], dpT[2 * kc][1]),
                              pack_bf16(dpT[2 * kc][2], dpT[2 * kc][3]),
                              pack_bf16(dpT[2 * kc + 1][0], dpT[2 * kc + 1][1]),
                              pack_bf16(dpT[2 * kc + 1][2], dpT[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NDT / 2; ++np) {
        uint32_t ob[4], qb[4];
        ldsm_x4_trans(ob, bk_addr(dOb, LQ, kc * 16, np * 16, lane));
        ldsm_x4_trans(qb, bk_addr(Qb, LQ, kc * 16, np * 16, lane));
        mma_bf16(dv_acc[2 * np], pa, ob[0], ob[1]);
        mma_bf16(dv_acc[2 * np + 1], pa, ob[2], ob[3]);
        mma_bf16(dk_acc[2 * np], da, qb[0], qb[1]);
        mma_bf16(dk_acc[2 * np + 1], da, qb[2], qb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= S) continue;
    const size_t off = (row0 + kpos[i]) * kstride + hk * D + dc0 + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < NDT; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * c) =
          __floats2bfloat162_rn(dk_acc[c][2 * i] * scale, dk_acc[c][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * c) =
          __floats2bfloat162_rn(dv_acc[c][2 * i], dv_acc[c][2 * i + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_delta(const void* out, const void* dout, float* delta, int B, int S, int H,
                         cudaStream_t stream) {
  constexpr int LPR = D * static_cast<int>(sizeof(T)) / 16 < 32
                          ? D * static_cast<int>(sizeof(T)) / 16
                          : 32;
  const size_t rows = static_cast<size_t>(B) * S * H;
  const size_t blocks = (rows * LPR + 255) / 256;
  attn_delta_kernel<T, D><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, S, H, D, rows);
  return cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, Streams st, void* dq, void* dk, void* dv,
               float* ws, int B, int S, int H, int Hkv, int kind, float scale, gamer::Seed seed,
               uint32_t thresh, float inv_keep, int nsplit, cudaStream_t stream) {
  if (nsplit != 1) return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = launch_delta<float, D>(out, dout, delta, B, S, H, stream);
  if (err != cudaSuccess) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* ot = static_cast<const float*>(dout);
  constexpr int TB = F32Tile<D>::TB;
  attn_dkv_kernel<D><<<dim3((S + TB - 1) / TB, Hkv, B), NT, smem, stream>>>(
      qt, kt, vt, ot, lse, delta, st, static_cast<float*>(dk), static_cast<float*>(dv), S, H,
      Hkv, kind, scale, seed, thresh, inv_keep, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_dq_kernel<D><<<dim3((S + TB - 1) / TB, H, B), NT, smem, stream>>>(
      qt, kt, vt, ot, lse, delta, st, static_cast<float*>(dq), S, H, Hkv, kind, scale, seed,
      thresh, inv_keep, D);
  return cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const float* lse, float* delta, Streams st, void* dq, void* dk, void* dv,
                float* ws, int B, int S, int H, int Hkv, int kind, float scale, gamer::Seed seed,
                uint32_t thresh, float inv_keep, int nsplit, cudaStream_t stream) {
  if (nsplit > 1 && ws == nullptr) return cudaErrorInvalidValue;
  constexpr size_t smem_kv = dkv_tc_smem_bytes<D>(), smem_q = dq_tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_dkv_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  err = launch_delta<bf16, D>(out, dout, delta, B, S, H, stream);
  if (err != cudaSuccess) return err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* ot = static_cast<const bf16*>(dout);
  constexpr int NCB = TcCols<D>::NCB;
  attn_dkv_tc_kernel<D><<<dim3(Hkv * nsplit * NCB, B, (S + BK - 1) / BK), TC_NT, smem_kv,
                          stream>>>(
      qt, kt, vt, ot, lse, delta, st, static_cast<bf16*>(dk), static_cast<bf16*>(dv), ws, nsplit,
      S, H, Hkv, kind, scale, seed, thresh, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nsplit > 1) {
    const size_t count = static_cast<size_t>(B) * S * Hkv * D;
    err = gamer::reduce_splits(ws, static_cast<bf16*>(dk), count, nsplit, stream);
    if (err != cudaSuccess) return err;
    err = gamer::reduce_splits(ws + nsplit * count, static_cast<bf16*>(dv), count, nsplit, stream);
    if (err != cudaSuccess) return err;
  }
  attn_dq_tc_kernel<D><<<dim3(H * NCB, B, (S + BQ - 1) / BQ), TC_NT, smem_q, stream>>>(
      qt, kt, vt, ot, lse, delta, st, static_cast<bf16*>(dq), S, H, Hkv, kind, scale, seed,
      thresh, inv_keep);
  return cudaGetLastError();
}

// The wide route, D > 256 and a multiple of WO: delta, then the dK/dV and
// dQ kernels, each CTA owning WO columns of one head; no split (nsplit 1).
int launch_wide(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const float* lse, float* delta, Streams st, void* dq, void* dk, void* dv, int B,
                int S, int H, int Hkv, int D, int kind, float scale, gamer::Seed seed,
                uint32_t thresh, float inv_keep, int dtype, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(B) * S * H;
  const unsigned delta_blocks = static_cast<unsigned>((rows * 32 + 255) / 256);
  const int ncb = D / WO;
  cudaError_t err;
  if (dtype == gamer::kFloat32) {
    constexpr size_t smem = smem_bytes<WO>();
    constexpr int TB = F32Tile<WO>::TB;
    err = cudaFuncSetAttribute(attn_dkv_kernel<WO, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attn_dq_kernel<WO, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attn_delta_kernel<float, 0><<<delta_blocks, 256, 0, stream>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout), delta, S, H, D, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const float* qt = static_cast<const float*>(q);
    const float* kt = static_cast<const float*>(k);
    const float* vt = static_cast<const float*>(v);
    const float* ot = static_cast<const float*>(dout);
    attn_dkv_kernel<WO, true><<<dim3((S + TB - 1) / TB, Hkv * ncb, B), NT, smem, stream>>>(
        qt, kt, vt, ot, lse, delta, st, static_cast<float*>(dk), static_cast<float*>(dv), S, H,
        Hkv, kind, scale, seed, thresh, inv_keep, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_dq_kernel<WO, true><<<dim3((S + TB - 1) / TB, H * ncb, B), NT, smem, stream>>>(
        qt, kt, vt, ot, lse, delta, st, static_cast<float*>(dq), S, H, Hkv, kind, scale, seed,
        thresh, inv_keep, D);
    return cudaGetLastError();
  }
  constexpr size_t smem_kv = dkv_wide_tc_smem_bytes(), smem_q = dq_wide_tc_smem_bytes();
  err = cudaFuncSetAttribute(attn_dkv_wide_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_dq_wide_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  attn_delta_kernel<bf16, 0><<<delta_blocks, 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta, S, H, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* ot = static_cast<const bf16*>(dout);
  attn_dkv_wide_tc_kernel<<<dim3(Hkv * ncb, B, (S + BK - 1) / BK), TC_NT, smem_kv, stream>>>(
      qt, kt, vt, ot, lse, delta, st, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, Hkv,
      D, kind, scale, seed, thresh, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_dq_wide_tc_kernel<<<dim3(H * ncb, B, (S + BQ - 1) / BQ), TC_NT, smem_q, stream>>>(
      qt, kt, vt, ot, lse, delta, st, static_cast<bf16*>(dq), S, H, Hkv, D, kind, scale, seed,
      thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/out/dout/dq/dk/dv in dtype (gamer::DType: bf16 -> tensor-core
// kernels, fp32 -> CUDA-core kernels), layouts as the forward; out is the
// forward's output, lse its fp32 [B, H, S] logsumexp; delta is an fp32
// [B, H, S] scratch that this call fills with rowsum(dO * O). dropout as the
// forward (thresh = 0: off). nsplit: shares of each dK/dV CTA's pairs (bf16
// only; 1 for fp32); for nsplit > 1, ws is an fp32 scratch of
// 2 * nsplit * B * S * Hkv * D. Head dims 32, 64, 128 and 256 are compiled
// (the wrapper pads others up to 256), and every multiple of 64 over 256 runs
// the wide route (nsplit 1). The pointers of the dtype tensors must be
// 16-byte aligned (16-byte copies).
extern "C" int gamer_fused_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const float* lse,
                                         float* delta, const int* attn, const int* sid,
                                         const int* act, const int* blk, void* dq, void* dk,
                                         void* dv, float* ws, int B, int S, int H, int Hkv, int D,
                                         int kind, float scale, const unsigned int* seed_ptr,
                                         unsigned int seed_add, unsigned int thresh,
                                         float inv_keep, int nsplit,
                                         int dtype, void* stream) {
  const gamer::Seed seed{seed_ptr, seed_add};
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || kind < 0 || kind > 3 ||
      nsplit <= 0 || B > 65535 || (S + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  const Streams st{attn, sid, act, blk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 256) {
    if (D % WO != 0 || nsplit != 1 || (dtype != gamer::kFloat32 && dtype != gamer::kBFloat16))
      return cudaErrorInvalidValue;
    return launch_wide(q, k, v, out, dout, lse, delta, st, dq, dk, dv, B, S, H, Hkv, D, kind, scale,
                       seed, thresh, inv_keep, dtype, s);
  }
#define GAMER_BWD_ARGS                                                                        \
  q, k, v, out, dout, lse, delta, st, dq, dk, dv, ws, B, S, H, Hkv, kind, scale, seed, thresh, \
      inv_keep, nsplit, s
  if (dtype == gamer::kFloat32) {
    switch (D) {
      case 32: return launch_f32<32>(GAMER_BWD_ARGS);
      case 64: return launch_f32<64>(GAMER_BWD_ARGS);
      case 128: return launch_f32<128>(GAMER_BWD_ARGS);
      case 256: return launch_f32<256>(GAMER_BWD_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == gamer::kBFloat16) {
    switch (D) {
      case 32: return launch_bf16<32>(GAMER_BWD_ARGS);
      case 64: return launch_bf16<64>(GAMER_BWD_ARGS);
      case 128: return launch_bf16<128>(GAMER_BWD_ARGS);
      case 256: return launch_bf16<256>(GAMER_BWD_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
#undef GAMER_BWD_ARGS
  return cudaErrorInvalidValue;
}
