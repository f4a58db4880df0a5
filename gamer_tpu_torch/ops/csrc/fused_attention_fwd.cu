// Fused masked GQA attention forward with the GAMER mask family.
//
// Replaces the TPU kernels of gamer_tpu/ops/pallas_attention.py that compute
// the forward: `_fwd_kernel` (the monolithic S <= 1024 generation, pallas_call
// in `_forward`), `_stream_fwd_kernel` (1024 < S <= 4096) and
// `_stream_fwd_kernel_xl` (S > 4096). The TPU needs three generations because
// VMEM caps the score tile; Hopper's 227 KB of shared memory cannot hold an
// S x S tile at all, so this kernel is flash-tiled for every S: one CTA per
// (64-query tile, head, batch row) walks 64-key tiles with an online softmax
// in fp32, and no S x S buffer exists anywhere.
//
// Layout (the projection-native one of the JAX kernel): q [B, S, H*D],
// k/v [B, S, Hkv*D], out [B, S, H*D]; query head h reads kv head h / (H/Hkv);
// scale D^-0.5. The mask is evaluated per tile from the int32 streams
// attention_mask, session_ids, actions, block_ids ([B, S] each). Rows with no
// allowed key output exactly 0: their row sum of exp() is 0, and the epilogue
// writes 0 where it is 0.
//
// Dropout (training): the keep mask is the stateless hash of (seed, b*H + h,
// query row, key column) (common.cuh `hash_keep`), the seed read on the card
// (`gamer::Seed`: a pointer and an add). The row normaliser l sums
// the UNDROPPED exp values; only the P.V accumulation takes the kept ones, and
// the epilogue rescales by 1/keep, so out = sum_j keep*P/keep_frac*V exactly as
// the TPU kernels compute it. `lse` (optional, fp32 [B, H, S]) saves
// m + log(l) per row for the backward (fused_attention_bwd.cu); rows with no
// allowed key get the sentinel +1e30, so exp(s - lse) vanishes for them, as in
// `_stream_fwd_kernel`. Key tiles past the query tile are skipped for the
// causal kinds ("causal", "multi"), and their query tiles launch longest
// first (the last tile sees every key).
//
// Dispatch by dtype, in the C entry point before any launch:
//  - bf16 (training and scoring): `attn_fwd_tc_kernel`, on the tensor cores.
//    4 warps of 16 query rows; K/V tiles double-buffered in shared memory by
//    16-byte cp.async (the next tile in flight while this one is multiplied);
//    S = Q.K^T and O += P.V by mma.sync m16n8k16 (mma.cuh) with fp32
//    accumulators; the softmax in fp32 on the accumulator fragments, in base 2
//    (scale folded with log2 e); each P tile rounded to bf16 and reused from
//    registers as the A operand of P.V, the point where the TPU kernel rounds
//    its probabilities for the MXU (pallas_attention.py:156,166).
//  - fp32: `attn_fwd_kernel`, fp32 FMA on the CUDA cores (4x4 outputs a
//    thread, probabilities kept in fp32), so fp32 callers get full fp32.
//
// Bound on H100: bytes, narrowly. 4*H*D operations per allowed (query, key)
// pair against (B*S*(H+2*Hkv)*D + B*S*H*D) elements moved; at the flagship
// causal shape that is about 170 operations per bf16 byte, below the ~295 at
// which the bf16 tensor cores become the limit, so mma.sync's rate is ample
// and the kernel lives on keeping its loads in flight; wgmma and TMA are the
// next step.
//
// Where this goes wrong, and what the bf16 kernel does about it:
//  - fragment coordinates: the (query row, key column) of every accumulator
//    element comes from the m16n8 C layout (mma.cuh): rows warp*16 + lane/4
//    (+8), columns 8j + 2*(lane%4) + {0,1}. Both the mask and the dropout hash
//    read them; a wrong map passes every dropout-off check, so the tests run
//    rate 0.2 with the same seed on both sides (the mask must match JAX's bit
//    for bit);
//  - ragged tiles (S = 505 = 7*64 + 57): cp.async zero-fills rows past S, so
//    no stale NaN or Inf meets a zero probability inside the mma; such keys
//    are masked and such rows are not written;
//  - rows with no allowed key: disallowed scores are -inf, and the running
//    max is replaced by 0 in exp2(s - m) while it is -inf, so no
//    exp(-inf - -inf) is formed and l stays 0;
//  - GQA: the kv head is h / G for G = H / Hkv, any G;
//  - head dims 32, 64, 128, 256 (the wrapper zero-pads the others up to 256):
//    O takes D/2 fp32 registers a thread (128 at D 256); Q is read from
//    shared memory per product, not held in registers. Register caps of 4, 3
//    and 2 CTAs an SM (D 32, 64, 128) keep those instantiations free of
//    spills; D 256 runs one CTA an SM (171 KB of shared memory in bf16, 211 KB
//    in fp32);
//  - head dims over 256 (the wide route; the wrapper pads them to a multiple
//    of 64): a warp cannot hold a 16 x D fp32 accumulator, so each CTA owns
//    WO = 64 columns of O (blockIdx = head * (D / WO) + column block) and
//    recomputes the full-D scores of its query tile, walking D in 64-deep
//    slices of Q and K: `attn_fwd_wide_tc_kernel` by `stream_mma`
//    (stream_tc.cuh), the fp32 kernel (`WIDE`) through shared memory. Every
//    column block forms the same scores in the same order, so all compute
//    the same softmax statistics; block 0 writes lse.

#include "common.cuh"
#include "mma.cuh"
#include "stream_tc.cuh"

namespace {

using namespace gamer::tc;

constexpr int BQ = 64;   // query rows a CTA
constexpr int BK = 64;   // keys a tile
constexpr int NT = 256;  // fp32 kernel threads: 16 row groups x 16 column lanes
constexpr int TC_NT = 128;  // bf16 kernel threads: 4 warps x 16 query rows
constexpr int WO = 64;   // output columns a CTA of the wide route (head dims over 256)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) +
         sizeof(int) * (4 * BK + 3 * BQ);
}

// WIDE (the route for head dims over 256): the rows of q, k, v and out are
// `dw` wide per head, and D is the width of the slices in which the scores
// walk them and of the block of output columns this CTA owns.
template <int D, bool WIDE = false>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ attn, const int* __restrict__ sid, const int* __restrict__ act,
    const int* __restrict__ blk, float* __restrict__ out, float* __restrict__ lse, int S, int H,
    int Hkv, int kind, float scale, gamer::Seed seed_in, uint32_t thresh, float inv_keep, int dw) {
  const uint32_t seed = seed_in.get();
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);       // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);       // [BK][D+1]
  float* Ps = Vs + BK * (D + 1);       // [BQ][BK+1]
  int* k_ok = reinterpret_cast<int*>(Ps + BQ * (BK + 1));
  int* k_sid = k_ok + BK;
  int* k_act = k_sid + BK;
  int* k_blk = k_act + BK;
  int* q_sid = k_blk + BK;
  int* q_act = q_sid + BQ;
  int* q_blk = q_act + BQ;

  const int Dw = WIDE ? dw : D;   // row width of a head
  const int ncb = WIDE ? dw / D : 1;  // column blocks of a head
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y / ncb;
  const int dc0 = (blockIdx.y % ncb) * D;  // this CTA's output columns
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t qstride = static_cast<size_t>(H) * Dw;
  const size_t kstride = static_cast<size_t>(Hkv) * Dw;
  const size_t row0 = static_cast<size_t>(b) * S;
  const bool drop = thresh > 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);

  auto load_q = [&](int d0) {
    for (int idx = tid; idx < BQ * D; idx += NT) {
      const int r = idx / D, c = idx % D, qi = q0 + r;
      Qs[r * (D + 1) + c] = qi < S ? q[(row0 + qi) * qstride + h * Dw + d0 + c] : 0.f;
    }
  };
  if constexpr (!WIDE) load_q(0);
  for (int r = tid; r < BQ; r += NT) {
    const int qi = q0 + r;
    const bool in = qi < S;
    q_sid[r] = in ? sid[row0 + qi] : 0;
    q_act[r] = in ? act[row0 + qi] : 0;
    q_blk[r] = in ? blk[row0 + qi] : -1;
  }

  constexpr int DC = D / 16;  // output columns a thread
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = (kind == gamer::kCausal || kind == gamer::kMulti) ? q_last + 1 : S;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps reads are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D, ki = k0 + r;
      const bool in = ki < S;
      const size_t off = (row0 + ki) * kstride + hk * Dw + c;
      if constexpr (!WIDE) Ks[r * (D + 1) + c] = in ? k[off] : 0.f;
      Vs[r * (D + 1) + c] = in ? v[off + dc0] : 0.f;
    }
    for (int r = tid; r < BK; r += NT) {
      const int ki = k0 + r;
      const bool in = ki < S;
      k_ok[r] = in ? (attn[row0 + ki] == 1) : 0;
      k_sid[r] = in ? sid[row0 + ki] : 0;
      k_act[r] = in ? act[row0 + ki] : 0;
      k_blk[r] = in ? blk[row0 + ki] : -1;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < Dw; d0 += D) {  // one pass unless WIDE
      if constexpr (WIDE) {
        __syncthreads();  // the previous slice's reads are done
        load_q(d0);
        for (int idx = tid; idx < BK * D; idx += NT) {
          const int r = idx / D, c = idx % D, ki = k0 + r;
          Ks[r * (D + 1) + c] = ki < S ? k[(row0 + ki) * kstride + hk * Dw + d0 + c] : 0.f;
        }
        __syncthreads();
      }
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qa[4], kb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
      bool ok[4];
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ok[j] = gamer::attn_allowed(kind, qpos, k0 + c, q_sid[r], k_sid[c], q_act[r], k_act[c],
                                    q_blk[r], k_blk[c], k_ok[c]);
        s[i][j] *= scale;
        if (ok[j]) tile_max = fmaxf(tile_max, s[i][j]);
      }
      tile_max = gamer::half_warp_max(tile_max);
      const float m_new = fmaxf(m[i], tile_max);
      // m_new == -inf: no allowed key yet in this row; acc and l stay 0, and
      // exp() is never taken of an -inf difference
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;  // the normaliser takes the undropped value
        if (drop && p != 0.f &&
            !gamer::hash_keep(seed, bh, static_cast<uint32_t>(qpos),
                              static_cast<uint32_t>(k0 + c), thresh))
          p = 0.f;
        Ps[r * (BK + 1) + c] = p;
      }
      psum = gamer::half_warp_sum(psum);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vb[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vb[j] = Vs[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p, vb[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float inv = l[i] > 0.f ? (drop ? inv_keep : 1.f) / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      out[(row0 + qi) * qstride + h * Dw + dc0 + tx + 16 * j] = acc[i][j] * inv;
    if (lse != nullptr && tx == 0 && dc0 == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : 1e30f;
  }
}

// ---- bf16 on the tensor cores

template <int D>
constexpr size_t tc_smem_bytes() {
  // Q [BQ][D+8]; 2 stages of K and V [BK][D+8] and of the key streams
  return sizeof(bf16) * (BQ + 4 * BK) * (D + 8) + sizeof(int4) * 2 * BK;
}

template <int D>
__global__ void __launch_bounds__(TC_NT, D > 128 ? 1 : D > 64 ? 2 : D > 32 ? 3 : 4) attn_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ attn, const int* __restrict__ sid, const int* __restrict__ act,
    const int* __restrict__ blk, bf16* __restrict__ out, float* __restrict__ lse, int S, int H,
    int Hkv, int kind, float scale, gamer::Seed seed_in, uint32_t thresh, float inv_keep) {
  const uint32_t seed = seed_in.get();
  constexpr int LD = D + 8;
  constexpr int NDT = D / 8;  // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);          // [BQ][LD]
  bf16* KVs = Qs + BQ * LD;                               // stage s: K, V [BK][LD] each
  int4* kst = reinterpret_cast<int4*>(KVs + 4 * BK * LD);  // stage s: (ok, sid, act, blk) [BK]

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * BQ;  // longest rows first
  const int h = blockIdx.x;
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
  // (in, sid, act, blk) and the row part of their dropout hash
  int qpos[2];
  int4 qinf[2];
  uint32_t qhash[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + warp * 16 + lane / 4 + 8 * i;
    const size_t r = row0 + qpos[i];
    qinf[i] = qpos[i] < S ? make_int4(1, sid[r], act[r], blk[r]) : make_int4(0, 0, 0, -1);
    qhash[i] = gamer::hash_row(seed, bh, static_cast<uint32_t>(qpos[i]));
  }
  const float no_sub[2] = {0.f, 0.f};

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = (kind == gamer::kCausal || kind == gamer::kMulti) ? q_last + 1 : S;
  const int ntiles = (k_end + BK - 1) / BK;

  auto load_kv = [&](int t) {
    const int st = t & 1, k0 = t * BK;
    load_tile_async<BK, D, TC_NT>(KVs + (2 * st) * BK * LD, kg, kstride, k0, S);
    load_tile_async<BK, D, TC_NT>(KVs + (2 * st + 1) * BK * LD, vg, kstride, k0, S);
    int4* ks = kst + st * BK;
    for (int r = threadIdx.x; r < BK; r += TC_NT) {
      const int ki = k0 + r;
      ks[r] = ki < S ? make_int4(attn[row0 + ki] == 1, sid[row0 + ki], act[row0 + ki],
                                 blk[row0 + ki])
                     : make_int4(0, 0, 0, -1);
    }
  };

  load_tile_async<BQ, D, TC_NT>(Qs, q + row0 * qstride + h * D, qstride, q0, S);
  load_kv(0);
  cp_async_commit();

  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of s * scale * log2 e
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1);
    cp_async_commit();  // possibly empty: keeps one group per tile
    cp_async_wait<1>();  // tile t (and Q) have landed
    __syncthreads();
    const int st = t & 1, k0 = t * BK;
    const bf16* Ks = KVs + (2 * st) * BK * LD;
    const bf16* Vs = Ks + BK * LD;
    const int4* ks = kst + st * BK;

    // s = Q K^T: 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_addr(Qs, LD, warp * 16, kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, bn_addr(Ks, LD, np * 16, kk, lane));
        mma_bf16(s[2 * np], a, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // mask (disallowed -> -inf) and the running max, in base 2
    gamer::mask_tile_qrows(kind, s, qpos, qinf, ks, k0, sl2, no_sub, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // no allowed key yet: exp2(-inf - 0) = 0 instead of exp2(-inf - -inf)
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_use[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // p = exp2(s - m): l takes every allowed p, P.V only the kept ones
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_use[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    if (drop) {  // branch-free per element: one uniform test a tile
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
          if (!gamer::hash_keep_at(qhash[e >> 1], static_cast<uint32_t>(c), thresh)) s[j][e] = 0.f;
        }
    }
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += P V: P from the s fragments (bf16), V through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NDT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, bk_addr(Vs, LD, kc * 16, np * 16, lane));
        mma_bf16(o[2 * np], a, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (qpos[i] >= S) continue;
    const float inv = l[i] > 0.f ? (drop ? inv_keep : 1.f) / l[i] : 0.f;
    bf16* orow = out + (row0 + qpos[i]) * qstride + h * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NDT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (lse != nullptr && lane % 4 == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + qpos[i]] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2 : 1e30f;
  }
}

// The wide route in bf16: blockIdx.x = head * (D / WO) + column block. Per
// key tile the scores of the CTA's 64 queries come from `stream_mma` over
// all of D (Q and K in 64-deep slices), the softmax and dropout are those of
// `attn_fwd_tc_kernel`, and O's WO columns accumulate P.V from V's column
// block, which is copied in while the scores stream.
constexpr size_t wide_tc_smem_bytes() {
  // the streamed Q/K slices; V's column block [BK][WO+8]; the key streams
  return StreamTiles<8, false>::smem_bytes + sizeof(bf16) * BK * (WO + 8) + sizeof(int4) * BK;
}

__global__ void __launch_bounds__(TC_NT) attn_fwd_wide_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ attn, const int* __restrict__ sid, const int* __restrict__ act,
    const int* __restrict__ blk, bf16* __restrict__ out, float* __restrict__ lse, int S, int H,
    int Hkv, int D, int kind, float scale, gamer::Seed seed_in, uint32_t thresh, float inv_keep) {
  const uint32_t seed = seed_in.get();
  using L = StreamTiles<8, false>;
  constexpr int LV = WO + 8;
  constexpr int NDT = WO / 8;  // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);      // stream_mma's two stages
  bf16* Vs = buf + 2 * L::STAGE;                      // [BK][LV]
  int4* kst = reinterpret_cast<int4*>(Vs + BK * LV);  // (ok, sid, act, blk) [BK]

  const int ncb = D / WO;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * BQ;  // longest rows first
  const int h = blockIdx.x / ncb;
  const int dc0 = (blockIdx.x % ncb) * WO;  // this CTA's output columns
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(Hkv) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  const bf16* qg = q + (row0 + q0) * qstride + h * D;
  const bf16* kg = k + row0 * kstride + hk * D;
  const bf16* vg = v + row0 * kstride + hk * D + dc0;
  const bool drop = thresh > 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const float sl2 = scale * LOG2E;

  int qpos[2];
  int4 qinf[2];
  uint32_t qhash[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + warp * 16 + lane / 4 + 8 * i;
    const size_t r = row0 + qpos[i];
    qinf[i] = qpos[i] < S ? make_int4(1, sid[r], act[r], blk[r]) : make_int4(0, 0, 0, -1);
    qhash[i] = gamer::hash_row(seed, bh, static_cast<uint32_t>(qpos[i]));
  }
  const float no_sub[2] = {0.f, 0.f};

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = (kind == gamer::kCausal || kind == gamer::kMulti) ? q_last + 1 : S;
  const int ntiles = (k_end + BK - 1) / BK;

  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads of Vs and kst are done
    load_block_async<BK, WO, TC_NT>(Vs, LV, vg + static_cast<size_t>(k0) * kstride, kstride,
                                    S - k0, WO);
    cp_async_commit();  // lands by stream_mma's first product
    for (int r = threadIdx.x; r < BK; r += TC_NT) {
      const int ki = k0 + r;
      kst[r] = ki < S ? make_int4(attn[row0 + ki] == 1, sid[row0 + ki], act[row0 + ki],
                                  blk[row0 + ki])
                      : make_int4(0, 0, 0, -1);
    }
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // s = Q K^T over all of D; ends with a __syncthreads, so kst is visible
    stream_mma<8, false, TC_NT>(s, buf, qg, qstride, S - q0, kg + static_cast<size_t>(k0) * kstride,
                                nullptr, kstride, S - k0, D, warp, lane);

    gamer::mask_tile_qrows(kind, s, qpos, qinf, kst, k0, sl2, no_sub, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_use[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_use[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    if (drop) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
          if (!gamer::hash_keep_at(qhash[e >> 1], static_cast<uint32_t>(c), thresh)) s[j][e] = 0.f;
        }
    }
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // o += P V over this CTA's columns
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NDT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, bk_addr(Vs, LV, kc * 16, np * 16, lane));
        mma_bf16(o[2 * np], a, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], a, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (qpos[i] >= S) continue;
    const float inv = l[i] > 0.f ? (drop ? inv_keep : 1.f) / l[i] : 0.f;
    bf16* orow = out + (row0 + qpos[i]) * qstride + h * D + dc0 + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NDT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (lse != nullptr && dc0 == 0 && lane % 4 == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + qpos[i]] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2 : 1e30f;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const int* attn, const int* sid,
               const int* act, const int* blk, void* out, float* lse, int B, int S, int H, int Hkv,
               int kind, float scale, gamer::Seed seed, uint32_t thresh, float inv_keep,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      attn, sid, act, blk, static_cast<float*>(out), lse, S, H, Hkv, kind, scale, seed, thresh,
      inv_keep, D);
  return cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const int* attn, const int* sid,
                const int* act, const int* blk, void* out, float* lse, int B, int S, int H,
                int Hkv, int kind, float scale, gamer::Seed seed, uint32_t thresh, float inv_keep,
                cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  attn_fwd_tc_kernel<D><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), attn,
      sid, act, blk, static_cast<bf16*>(out), lse, S, H, Hkv, kind, scale, seed, thresh,
      inv_keep);
  return cudaGetLastError();
}

// The wide route, D > 256 and a multiple of WO: each CTA owns WO output
// columns of one head.
int launch_wide(const void* q, const void* k, const void* v, const int* attn, const int* sid,
                const int* act, const int* blk, void* out, float* lse, int B, int S, int H,
                int Hkv, int D, int kind, float scale, gamer::Seed seed, uint32_t thresh,
                float inv_keep, int dtype, cudaStream_t stream) {
  const int nq = (S + BQ - 1) / BQ, ncb = D / WO;
  if (dtype == gamer::kFloat32) {
    constexpr size_t smem = smem_bytes<WO>();
    cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<WO, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attn_fwd_kernel<WO, true><<<dim3(nq, H * ncb, B), NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        attn, sid, act, blk, static_cast<float*>(out), lse, S, H, Hkv, kind, scale, seed, thresh,
        inv_keep, D);
    return cudaGetLastError();
  }
  constexpr size_t smem = wide_tc_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_wide_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attn_fwd_wide_tc_kernel<<<dim3(H * ncb, B, nq), TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), attn,
      sid, act, blk, static_cast<bf16*>(out), lse, S, H, Hkv, D, kind, scale, seed, thresh,
      inv_keep);
  return cudaGetLastError();
}

}  // namespace

// dtype: gamer::DType of q/k/v/out (bf16 -> tensor-core kernel, fp32 ->
// CUDA-core kernel); kind: gamer::AttnKind. Head dims 32, 64, 128 and 256
// are compiled (the wrapper pads others up to 256), and every multiple of 64
// over 256 runs the wide route. lse may be null (no backward follows). thresh = 0 turns dropout
// off; inv_keep = 1 / keep fraction. The bf16 kernel reads q/k/v with 16-byte
// copies: the pointers must be 16-byte aligned.
extern "C" int gamer_fused_attention_fwd(const void* q, const void* k, const void* v,
                                         const int* attn, const int* sid, const int* act,
                                         const int* blk, void* out, float* lse, int B, int S,
                                         int H, int Hkv, int D, int kind, float scale,
                                         const unsigned int* seed_ptr, unsigned int seed_add,
                                         unsigned int thresh, float inv_keep,
                                         int dtype, void* stream) {
  const gamer::Seed seed{seed_ptr, seed_add};
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || kind < 0 || kind > 3 ||
      B > 65535 || (S + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > 256) {
    if (D % WO != 0 || (dtype != gamer::kFloat32 && dtype != gamer::kBFloat16))
      return cudaErrorInvalidValue;
    return launch_wide(q, k, v, attn, sid, act, blk, out, lse, B, S, H, Hkv, D, kind, scale, seed,
                       thresh, inv_keep, dtype, st);
  }
#define GAMER_FWD_ARGS \
  q, k, v, attn, sid, act, blk, out, lse, B, S, H, Hkv, kind, scale, seed, thresh, inv_keep, st
  if (dtype == gamer::kFloat32) {
    switch (D) {
      case 32: return launch_f32<32>(GAMER_FWD_ARGS);
      case 64: return launch_f32<64>(GAMER_FWD_ARGS);
      case 128: return launch_f32<128>(GAMER_FWD_ARGS);
      case 256: return launch_f32<256>(GAMER_FWD_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == gamer::kBFloat16) {
    switch (D) {
      case 32: return launch_bf16<32>(GAMER_FWD_ARGS);
      case 64: return launch_bf16<64>(GAMER_FWD_ARGS);
      case 128: return launch_bf16<128>(GAMER_FWD_ARGS);
      case 256: return launch_bf16<256>(GAMER_FWD_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
#undef GAMER_FWD_ARGS
  return cudaErrorInvalidValue;
}
