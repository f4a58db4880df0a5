// Fused masked GQA attention forward with the GAMER mask family.
//
// Replaces the TPU kernels of gamer_tpu/ops/pallas_attention.py that compute
// the forward: `_fwd_kernel` (the monolithic S <= 1024 generation, pallas_call
// in `_forward`), `_stream_fwd_kernel` (1024 < S <= 4096) and
// `_stream_fwd_kernel_xl` (S > 4096). The TPU needs three generations because
// VMEM caps the score tile; Hopper's 227 KB of shared memory cannot hold an
// S x S tile at all, so this one kernel is flash-tiled for every S: one CTA
// per (64-query tile, head, batch row) walks 64-key tiles with an online
// softmax in fp32, and no S x S buffer exists anywhere.
//
// Layout (the projection-native one of the JAX kernel): q [B, S, H*D],
// k/v [B, S, Hkv*D], out [B, S, H*D]; query head h reads kv head h / (H/Hkv);
// scale D^-0.5. The mask is evaluated per tile from the int32 streams
// attention_mask, session_ids, actions, block_ids ([B, S] each). Rows with no
// allowed key output exactly 0: the row sum of exp() is 0 for them, and the
// epilogue writes 0 where it is 0.
//
// Dropout (training): the keep mask is the stateless hash of (seed, b*H + h,
// query row, key column) (common.cuh `hash_keep`). The row normaliser l sums
// the UNDROPPED exp values; only the P.V accumulation takes the kept ones, and
// the epilogue rescales by 1/keep, so out = sum_j keep*P/keep_frac*V exactly as
// the TPU kernels compute it. `lse` (optional, fp32 [B, H, S]) saves
// m + log(l) per row for the backward (fused_attention_bwd.cu); rows with no
// allowed key get the sentinel +1e30, so exp(s - lse) vanishes for them, as in
// `_stream_fwd_kernel`.
//
// Bound on H100: bytes, narrowly. 4*H*D operations per allowed (query, key)
// pair against (B*S*(H+2*Hkv)*D + B*S*H*D) elements moved; at the flagship
// causal shape that is about 170 operations per bf16 byte, below the ~295 at
// which the bf16 tensor cores become the limit. This first version computes in
// fp32 on the CUDA cores (FMA from shared memory, 4x4 outputs a thread), and
// keeps the probabilities in fp32 where the TPU kernel rounds them to the
// operand dtype for its matrix unit; tensor cores (wgmma) and TMA are later
// work. Key tiles past the query tile are skipped for the kinds that are
// causal ("causal", "multi").

#include "common.cuh"

namespace {

using gamer::from_f;
using gamer::to_f;

constexpr int BQ = 64;   // query rows a CTA
constexpr int BK = 64;   // keys a tile
constexpr int NT = 256;  // threads: 16 row groups x 16 column lanes

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) +
         sizeof(int) * (4 * BK + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ attn, const int* __restrict__ sid, const int* __restrict__ act,
    const int* __restrict__ blk, T* __restrict__ out, float* __restrict__ lse, int S, int H,
    int Hkv, int kind, float scale, uint32_t seed, uint32_t thresh, float inv_keep) {
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

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(Hkv) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  const bool drop = thresh > 0u;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D, qi = q0 + r;
    Qs[r * (D + 1) + c] = qi < S ? to_f(q[(row0 + qi) * qstride + h * D + c]) : 0.f;
  }
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
      const size_t off = (row0 + ki) * kstride + hk * D + c;
      Ks[r * (D + 1) + c] = in ? to_f(k[off]) : 0.f;
      Vs[r * (D + 1) + c] = in ? to_f(v[off]) : 0.f;
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
      out[(row0 + qi) * qstride + h * D + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : 1e30f;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* attn, const int* sid,
           const int* act, const int* blk, void* out, float* lse, int B, int S, int H, int Hkv,
           int kind, float scale, uint32_t seed, uint32_t thresh, float inv_keep,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), attn, sid,
      act, blk, static_cast<T*>(out), lse, S, H, Hkv, kind, scale, seed, thresh, inv_keep);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const int* attn,
               const int* sid, const int* act, const int* blk, void* out, float* lse, int B,
               int S, int H, int Hkv, int kind, float scale, uint32_t seed, uint32_t thresh,
               float inv_keep, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, attn, sid, act, blk, out, lse, B, S, H, Hkv, kind,
                                  scale, seed, thresh, inv_keep, stream);
    case 64: return launch<T, 64>(q, k, v, attn, sid, act, blk, out, lse, B, S, H, Hkv, kind,
                                  scale, seed, thresh, inv_keep, stream);
    case 128: return launch<T, 128>(q, k, v, attn, sid, act, blk, out, lse, B, S, H, Hkv, kind,
                                    scale, seed, thresh, inv_keep, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: gamer::DType of q/k/v/out; kind: gamer::AttnKind. Head dims 32, 64
// and 128 are compiled. lse may be null (no backward follows). thresh = 0
// turns dropout off; inv_keep = 1 / keep fraction.
extern "C" int gamer_fused_attention_fwd(const void* q, const void* k, const void* v,
                                         const int* attn, const int* sid, const int* act,
                                         const int* blk, void* out, float* lse, int B, int S,
                                         int H, int Hkv, int D, int kind, float scale,
                                         unsigned int seed, unsigned int thresh, float inv_keep,
                                         int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || kind < 0 || kind > 3)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gamer::kFloat32)
    return dispatch_d<float>(D, q, k, v, attn, sid, act, blk, out, lse, B, S, H, Hkv, kind,
                             scale, seed, thresh, inv_keep, st);
  if (dtype == gamer::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, attn, sid, act, blk, out, lse, B, S, H, Hkv,
                                     kind, scale, seed, thresh, inv_keep, st);
  return cudaErrorInvalidValue;
}
