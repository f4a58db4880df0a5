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
// scratch; CUDA blocks run in no order. So the work is split in two kernels,
// each owning its outputs, with no atomics and a fixed summation order
// (deterministic):
//   dkv kernel: one CTA per (64-key tile, kv head, batch row) loops over the
//               G query heads of its GQA group and over the query tiles,
//               accumulating dK and dV in registers;
//   dq kernel:  one CTA per (64-query tile, head, batch row) loops over the
//               key tiles, accumulating dQ in registers.
// Per tile (delta = rowsum(dO * O), formed by the caller as in
// `_bwd_streaming`):
//   P_use = keep ? P / keep_frac : 0       (dropout regenerated by the hash)
//   dV   += P_use^T dO
//   dP    = dO V^T
//   dS    = P_use * dP - P * delta        (pallas_attention.py:221)
//   dQ   += dS K * scale,  dK += dS^T Q * scale
// Tiles the causal kinds ("causal", "multi") rule out are skipped: query
// tiles before a key tile in the dkv kernel, key tiles after a query tile in
// the dq kernel. Rows past S and keys past S or padded are masked.
//
// Bound on H100: about 10*H*D operations per allowed pair (both kernels
// recompute the scores) against q, k, v, dO, dq, dk, dv moved once; bytes
// bound narrowly at the flagship shape. This first version computes in fp32
// on the CUDA cores (FMA from shared memory) and keeps P and dS in fp32 where
// the TPU kernel rounds dS to the operand dtype; tensor cores are later work.

#include "common.cuh"

namespace {

using gamer::from_f;
using gamer::to_f;

constexpr int BQ = 64;   // query rows a tile
constexpr int BK = 64;   // keys a tile
constexpr int NT = 256;  // threads: 16 row groups x 16 column lanes

struct Streams {
  const int* attn;
  const int* sid;
  const int* act;
  const int* blk;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ) +
         sizeof(int) * (4 * BK + 4 * BQ);
}

// Shared-memory carve-up common to both kernels.
template <int D>
struct Tiles {
  float *Qs, *dOs, *Ks, *Vs, *Ps, *dSs, *lse_s, *delta_s;
  int *k_ok, *k_sid, *k_act, *k_blk, *q_in, *q_sid, *q_act, *q_blk;
  __device__ explicit Tiles(float* smem) {
    Qs = smem;                    // [BQ][D+1]
    dOs = Qs + BQ * (D + 1);      // [BQ][D+1]
    Ks = dOs + BQ * (D + 1);      // [BK][D+1]
    Vs = Ks + BK * (D + 1);       // [BK][D+1]
    Ps = Vs + BK * (D + 1);       // [BQ][BK+1]  P_use
    dSs = Ps + BQ * (BK + 1);     // [BQ][BK+1]  dS
    lse_s = dSs + BQ * (BK + 1);  // [BQ]
    delta_s = lse_s + BQ;         // [BQ]
    k_ok = reinterpret_cast<int*>(delta_s + BQ);
    k_sid = k_ok + BK;
    k_act = k_sid + BK;
    k_blk = k_act + BK;
    q_in = k_blk + BK;
    q_sid = q_in + BQ;
    q_act = q_sid + BQ;
    q_blk = q_act + BQ;
  }
};

// Query tile q0 of head h: q, dO rows, lse, delta and the query-side streams.
template <typename T, int D>
__device__ void load_q_tile(const Tiles<D>& t, const T* q, const T* dout, const float* lse,
                            const float* delta, const Streams& st, int q0, int h, int b, int S,
                            int H) {
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D, qi = q0 + r;
    const bool in = qi < S;
    const size_t off = (row0 + qi) * qstride + h * D + c;
    t.Qs[r * (D + 1) + c] = in ? to_f(q[off]) : 0.f;
    t.dOs[r * (D + 1) + c] = in ? to_f(dout[off]) : 0.f;
  }
  for (int r = threadIdx.x; r < BQ; r += NT) {
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

// Key tile k0 of kv head hk: k, v rows and the key-side streams.
template <typename T, int D>
__device__ void load_k_tile(const Tiles<D>& t, const T* k, const T* v, const Streams& st, int k0,
                            int hk, int b, int S, int Hkv) {
  const size_t kstride = static_cast<size_t>(Hkv) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  for (int idx = threadIdx.x; idx < BK * D; idx += NT) {
    const int r = idx / D, c = idx % D, ki = k0 + r;
    const bool in = ki < S;
    const size_t off = (row0 + ki) * kstride + hk * D + c;
    t.Ks[r * (D + 1) + c] = in ? to_f(k[off]) : 0.f;
    t.Vs[r * (D + 1) + c] = in ? to_f(v[off]) : 0.f;
  }
  for (int r = threadIdx.x; r < BK; r += NT) {
    const int ki = k0 + r;
    const bool in = ki < S;
    t.k_ok[r] = in ? (st.attn[row0 + ki] == 1) : 0;
    t.k_sid[r] = in ? st.sid[row0 + ki] : 0;
    t.k_act[r] = in ? st.act[row0 + ki] : 0;
    t.k_blk[r] = in ? st.blk[row0 + ki] : -1;
  }
}

// P_use and dS of the loaded (query tile, key tile) into Ps / dSs. Thread
// (ty, tx) computes rows ty + 16i and columns tx + 16j.
template <int D>
__device__ void tile_grads(const Tiles<D>& t, int kind, int q0, int k0, float scale, uint32_t bh,
                           uint32_t seed, uint32_t thresh, float inv_keep) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = t.Qs[(ty + 16 * i) * (D + 1) + d];
      oa[i] = t.dOs[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = t.Ks[(tx + 16 * j) * (D + 1) + d];
      vb[j] = t.Vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
  const bool drop = thresh > 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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
      t.Ps[r * (BK + 1) + c] = p_use;
      t.dSs[r * (BK + 1) + c] = p_use * dp[i][j] - p * t.delta_s[r];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    Streams st, T* __restrict__ dk, T* __restrict__ dv, int S, int H, int Hkv, int kind,
    float scale, uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ float smem[];
  const Tiles<D> t(smem);
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int DC = D / 16;

  load_k_tile<T, D>(t, k, v, st, k0, hk, b, S, Hkv);
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal kinds: query tiles that end before this key tile see none of it
  const int q_begin = (kind == gamer::kCausal || kind == gamer::kMulti) ? (k0 / BQ) * BQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = q_begin; q0 < S; q0 += BQ) {
      __syncthreads();  // previous tile's reads are done
      load_q_tile<T, D>(t, q, dout, lse, delta, st, q0, h, b, S, H);
      __syncthreads();
      tile_grads<D>(t, kind, q0, k0, scale, static_cast<uint32_t>(b * H + h), seed, thresh,
                    inv_keep);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pu[4], ds[4], od[DC], qd[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pu[i] = t.Ps[r * (BK + 1) + ty + 16 * i];
          ds[i] = t.dSs[r * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          od[j] = t.dOs[r * (D + 1) + tx + 16 * j];
          qd[j] = t.Qs[r * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            dv_acc[i][j] = fmaf(pu[i], od[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds[i], qd[j], dk_acc[i][j]);
          }
      }
    }
  }

  const size_t kstride = static_cast<size_t>(Hkv) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki >= S) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const size_t off = (row0 + ki) * kstride + hk * D + tx + 16 * j;
      dk[off] = from_f<T>(dk_acc[i][j] * scale);
      dv[off] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    Streams st, T* __restrict__ dq, int S, int H, int Hkv, int kind, float scale, uint32_t seed,
    uint32_t thresh, float inv_keep) {
  extern __shared__ float smem[];
  const Tiles<D> t(smem);
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int DC = D / 16;

  load_q_tile<T, D>(t, q, dout, lse, delta, st, q0, h, b, S, H);
  float dq_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dq_acc[i][j] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = (kind == gamer::kCausal || kind == gamer::kMulti) ? q_last + 1 : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_k_tile<T, D>(t, k, v, st, k0, hk, b, S, Hkv);
    __syncthreads();
    tile_grads<D>(t, kind, q0, k0, scale, static_cast<uint32_t>(b * H + h), seed, thresh,
                  inv_keep);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4], kd[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = t.dSs[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) kd[j] = t.Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) dq_acc[i][j] = fmaf(ds[i], kd[j], dq_acc[i][j]);
    }
  }

  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq[(row0 + qi) * qstride + h * D + tx + 16 * j] = from_f<T>(dq_acc[i][j] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, Streams st, void* dq, void* dk, void* dv, int B, int S, int H,
           int Hkv, int kind, float scale, uint32_t seed, uint32_t thresh, float inv_keep,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  attn_dkv_kernel<T, D><<<dim3((S + BK - 1) / BK, Hkv, B), NT, smem, stream>>>(
      qt, kt, vt, ot, lse, delta, st, static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, kind,
      scale, seed, thresh, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_dq_kernel<T, D><<<dim3((S + BQ - 1) / BQ, H, B), NT, smem, stream>>>(
      qt, kt, vt, ot, lse, delta, st, static_cast<T*>(dq), S, H, Hkv, kind, scale, seed, thresh,
      inv_keep);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, Streams st, void* dq, void* dk, void* dv,
               int B, int S, int H, int Hkv, int kind, float scale, uint32_t seed,
               uint32_t thresh, float inv_keep, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, st, dq, dk, dv, B, S, H, Hkv, kind,
                                  scale, seed, thresh, inv_keep, stream);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, st, dq, dk, dv, B, S, H, Hkv, kind,
                                  scale, seed, thresh, inv_keep, stream);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, st, dq, dk, dv, B, S, H, Hkv,
                                    kind, scale, seed, thresh, inv_keep, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/dout/dq/dk/dv in dtype (gamer::DType), layouts as the forward; lse
// and delta fp32 [B, H, S]. dropout as the forward (thresh = 0: off).
extern "C" int gamer_fused_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse, const float* delta,
                                         const int* attn, const int* sid, const int* act,
                                         const int* blk, void* dq, void* dk, void* dv, int B,
                                         int S, int H, int Hkv, int D, int kind, float scale,
                                         unsigned int seed, unsigned int thresh, float inv_keep,
                                         int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || kind < 0 || kind > 3)
    return cudaErrorInvalidValue;
  const Streams st{attn, sid, act, blk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gamer::kFloat32)
    return dispatch_d<float>(D, q, k, v, dout, lse, delta, st, dq, dk, dv, B, S, H, Hkv, kind,
                             scale, seed, thresh, inv_keep, s);
  if (dtype == gamer::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, dout, lse, delta, st, dq, dk, dv, B, S, H,
                                     Hkv, kind, scale, seed, thresh, inv_keep, s);
  return cudaErrorInvalidValue;
}
