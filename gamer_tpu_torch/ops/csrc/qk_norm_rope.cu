// The attention prologue's per-head q/k RMSNorm and RoPE: kernel N1 (forward)
// and N2 (backward).
//
// Replaces XLA's fusion of gamer_tpu/modules/layers.py:215-219 (q_norm,
// k_norm, rope_cos_sin, apply_rope) inside the jitted step: the JAX package
// has no pallas_call here. N1 reads the projected, pre-norm q [tokens, Hq, D]
// and k [tokens, Hk, D] once and writes the normed and rotated q and k once,
// plus each (token, head) row's fp32 rstd when a backward will need it. N2
// reads the incoming grads of the rotated q and k, the pre-norm q and k and
// the rstd, and writes the pre-norm grads and, through per-CTA fp32 partials
// and a fixed-order sum (qk_norm_rope_dw_kernel), the two norm weights' grads,
// so two runs give the same bits.
//
// Rounding where the plain version (ops/qk_norm_rope.py) rounds, so that N1
// equals it bit for bit in bf16 and fp32: the sum of squares in fp32 in a
// fixed order (each element with its RoPE partner i + D/2, then a halving
// tree over the D/2 pair sums zero-padded to a power of two); var = sum *
// (1/D); r = rsqrtf(var + eps) (the rstd, fp32) rounded to T; x * r, then
// * weight (rounded to T), each rounded to T; cos and sin of pos * inv_freq[i]
// in fp32 with the full-precision cosf / sinf (the library is built without
// --use_fast_math), rounded to T; y * cos, rot * sin and their sum, each
// rounded to T. Every multiply and add is __fmul_rn / __fadd_rn, never
// contracted into an FMA; in bf16 the elementwise chain runs as packed
// bf16x2 operations that round once, which gives the same bits
// (row_fwd_bf16x2). inv_freq is the caller's [D/2] table, built by the same
// torch ops as rope_cos_sin's, so the angles are the plain version's. N2
// recomputes the normed values from the saved rstd and accumulates in fp32.
//
// Layout: a lane holds V elements of the first half of a row and the V
// elements D/2 further on (its RoPE partners), in NC chunks of 32 lanes, so
// the rotation needs no shuffle; V is the widest vector of at most 16 bytes
// whose element count divides D/2. A row takes `lanes` lanes (the pair sums'
// power-of-two length / V, at most 32), so one warp holds 32 / lanes rows;
// a lane group takes one token at a time and walks its Hq q heads, then its
// Hk k heads, computing the token's cos and sin once for all of them. The
// tree's levels map onto the layout: between chunks in registers, between
// lanes by __shfl_xor_sync, inside a lane. A lane group loads its next row
// while it computes this one, and the grid is as many CTAs as fit on the
// card, trimmed so that every warp walks the same number of token groups
// (balanced_grid). Bound: bytes (each element read and written once).
//
// A row wider than 4 chunks of 32 lanes (an odd D/2 past 128, or past 1024
// elements) takes the wide kernels instead: a CTA of one warp walks tokens,
// and a row's lanes stride over it, holding its pair sums (and in N2 the
// CTA's two weight grads) in shared memory; the halving tree runs there, so
// the sum, and N1's bits, are those of the register kernels' order.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int BYTES> struct VecOf;
template <> struct VecOf<2> { using type = unsigned short; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// V consecutive elements stored as one vector of V * sizeof(T) bytes (aligned:
// every row and chunk starts at a multiple of it)
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  using W = typename VecOf<V * sizeof(T)>::type;
  union { W w; T e[V]; } u;
#pragma unroll
  for (int i = 0; i < V; ++i) u.e[i] = gamer::from_f<T>(v[i]);
  *reinterpret_cast<W*>(p) = u.w;
}

// x rounded to T, as a float
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return gamer::to_f(gamer::from_f<T>(x));
}

// The row's sum of the pair values p, in the plain version's order: the
// halving tree over the pair sums, whose top levels lie between this lane's
// chunks, the next between the row's lanes, the last inside the lane. Every
// lane of the row ends with the whole sum (xor partners add the same two
// values).
template <int V, int NC>
__device__ __forceinline__ float row_sum(float (&p)[NC][V], int lanes) {
#pragma unroll
  for (int n = NC / 2; n >= 1; n /= 2)
#pragma unroll
    for (int c = 0; c < n; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) p[c][i] = __fadd_rn(p[c][i], p[c + n][i]);
  for (int m = lanes / 2; m >= 1; m >>= 1)
#pragma unroll
    for (int i = 0; i < V; ++i)
      p[0][i] = __fadd_rn(p[0][i], __shfl_xor_sync(0xffffffffu, p[0][i], m));
#pragma unroll
  for (int n = V / 2; n >= 1; n /= 2)
#pragma unroll
    for (int i = 0; i < n; ++i) p[0][i] = __fadd_rn(p[0][i], p[0][i + n]);
  return p[0][0];
}

struct Args {
  const void* q;       // pre-norm [tokens, hq, d]
  const void* k;       // pre-norm [tokens, hk, d]
  const void* gq;      // N2: the grad of the rotated q (null in N1)
  const void* gk;
  void* out_q;         // N1: the rotated q; N2: the pre-norm q's grad
  void* out_k;
  const float* wq;     // [d] norm weights (fp32 parameters)
  const float* wk;
  float* rq;           // [tokens, hq] rstd: written by N1 (unless null), read by N2
  float* rk;
  const int* pos;      // [tokens] RoPE positions
  const float* inv_freq;  // [d / 2]
  float* ws;           // N2: per-CTA weight-grad partials [at least gridDim.x, 2, d]
  unsigned int tokens;
  int hq, hk, d, lanes;
  float inv_d, eps;
};

// Per-CTA constants in shared memory: both weights rounded to T, inv_freq.
template <typename T, int MAXD>
__device__ __forceinline__ void load_tables(const Args& a, float (&sw)[2][MAXD],
                                            float (&sf)[MAXD / 2]) {
  for (int e = threadIdx.x; e < a.d; e += kThreads) {
    sw[0][e] = rnd<T>(a.wq[e]);
    sw[1][e] = rnd<T>(a.wk[e]);
  }
  for (int e = threadIdx.x; e < a.d / 2; e += kThreads) sf[e] = a.inv_freq[e];
  __syncthreads();
}

// This lane's cos and sin of the token at position pos, rounded to T
template <typename T, int V, int NC>
__device__ __forceinline__ void rope_angles(float pf, const float* sf, int j, int lanes,
                                            int half, float (&cs)[NC][V], float (&sn)[NC][V]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int e0 = (j + lanes * c) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      cs[c][i] = sn[c][i] = 0.f;
      if (e0 < half) {
        const float ang = __fmul_rn(pf, sf[e0 + i]);
        cs[c][i] = rnd<T>(cosf(ang));
        sn[c][i] = rnd<T>(sinf(ang));
      }
    }
  }
}

// A row's share of one lane, as loaded: the NC chunks of the first half and
// of the second, raw (a 16-byte vector holds 8 bf16 in 4 registers), so the
// next row is in flight while this one is computed.
template <typename T, int V, int NC>
struct Raw {
  using W = typename VecOf<V * sizeof(T)>::type;
  W lo[NC], hi[NC];
};

template <typename T, int V, int NC>
__device__ __forceinline__ void load_raw(const T* x, Raw<T, V, NC>& raw, int j, int lanes,
                                         int half) {
  using W = typename Raw<T, V, NC>::W;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int e0 = (j + lanes * c) * V;
    raw.lo[c] = raw.hi[c] = W{};  // zero bits: 0.0 in either dtype
    if (x != nullptr && e0 < half) {
      raw.lo[c] = *reinterpret_cast<const W*>(x + e0);
      raw.hi[c] = *reinterpret_cast<const W*>(x + half + e0);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const typename VecOf<V * sizeof(T)>::type& w,
                                       float (&v)[V]) {
  union { typename VecOf<V * sizeof(T)>::type w; T e[V]; } u;
  u.w = w;
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = gamer::to_f(u.e[i]);
}

// Where a lane group's walk stands: token group g of the warp's (its first,
// then every `stride` further), row r of the token's hq q rows and hk k rows.
struct Step {
  uint64_t g;
  int r;
};

__device__ __forceinline__ Step next_step(Step s, uint64_t stride, int rows) {
  return ++s.r == rows ? Step{s.g + stride, 0} : s;
}

// The index of row r of token tok in q (r < hq) or in k (and in its rstd)
__device__ __forceinline__ uint64_t row_index(const Args& a, uint64_t tok, int r) {
  return r < a.hq ? tok * a.hq + r : tok * a.hk + (r - a.hq);
}

// N1 on one row (`valid` false for a lane group past the last token, which
// still takes part in the shuffles): writes out and, unless null, rstd.
template <typename T, int V, int NC>
__device__ __forceinline__ void row_fwd(const Raw<T, V, NC>& raw, bool valid, T* out,
                                        float* rstd, const float* w, const float (&cs)[NC][V],
                                        const float (&sn)[NC][V], const Args& a, int j) {
  const int half = a.d / 2;
  float lo[NC][V], hi[NC][V], p[NC][V];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    unpack<T, V>(raw.lo[c], lo[c]);
    unpack<T, V>(raw.hi[c], hi[c]);
#pragma unroll
    for (int i = 0; i < V; ++i)
      p[c][i] = __fadd_rn(__fmul_rn(lo[c][i], lo[c][i]), __fmul_rn(hi[c][i], hi[c][i]));
  }
  const float ss = row_sum<V, NC>(p, a.lanes);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, a.inv_d), a.eps));
  if (!valid) return;
  if (rstd != nullptr && j == 0) *rstd = r;
  const float rt = rnd<T>(r);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int e0 = (j + a.lanes * c) * V;
    if (e0 >= half) continue;
    float olo[V], ohi[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float ylo = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(lo[c][i], rt)), w[e0 + i]));
      const float yhi = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(hi[c][i], rt)), w[half + e0 + i]));
      olo[i] = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(ylo, cs[c][i])),
                                rnd<T>(__fmul_rn(-yhi, sn[c][i]))));
      ohi[i] = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(yhi, cs[c][i])),
                                rnd<T>(__fmul_rn(ylo, sn[c][i]))));
    }
    store_vec<T, V>(out + e0, olo);
    store_vec<T, V>(out + half + e0, ohi);
  }
}

// N1 on one bf16 row with V even, in packed bf16x2 arithmetic: each
// __hmul2_rn / __hadd2 / __hsub2 rounds its exact result once to bf16, which
// is what rounding the fp32 result to bf16 gives (a product of two bf16 is
// exact in fp32; a sum of two is exact there or far from a tie), so the
// result is row_fwd's, without a conversion an element. w2, c2 and s2 hold
// the weights, cos and sin as bf16 pairs.
template <int V, int NC>
__device__ __forceinline__ void row_fwd_bf16x2(const Raw<__nv_bfloat16, V, NC>& raw, bool valid,
                                               __nv_bfloat16* out, float* rstd,
                                               const __nv_bfloat162* w2,
                                               const __nv_bfloat162 (&c2)[NC][V / 2],
                                               const __nv_bfloat162 (&s2)[NC][V / 2],
                                               const Args& a, int j) {
  using W = typename Raw<__nv_bfloat16, V, NC>::W;
  const int half = a.d / 2;
  float p[NC][V];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const __nv_bfloat162* lo = reinterpret_cast<const __nv_bfloat162*>(&raw.lo[c]);
    const __nv_bfloat162* hi = reinterpret_cast<const __nv_bfloat162*>(&raw.hi[c]);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 l = __bfloat1622float2(lo[i]), h = __bfloat1622float2(hi[i]);
      p[c][2 * i] = __fadd_rn(__fmul_rn(l.x, l.x), __fmul_rn(h.x, h.x));
      p[c][2 * i + 1] = __fadd_rn(__fmul_rn(l.y, l.y), __fmul_rn(h.y, h.y));
    }
  }
  const float ss = row_sum<V, NC>(p, a.lanes);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, a.inv_d), a.eps));
  if (!valid) return;
  if (rstd != nullptr && j == 0) *rstd = r;
  const __nv_bfloat162 rt = __float2bfloat162_rn(r);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int e0 = (j + a.lanes * c) * V;
    if (e0 >= half) continue;
    const __nv_bfloat162* lo = reinterpret_cast<const __nv_bfloat162*>(&raw.lo[c]);
    const __nv_bfloat162* hi = reinterpret_cast<const __nv_bfloat162*>(&raw.hi[c]);
    W olo, ohi;
    __nv_bfloat162* ol = reinterpret_cast<__nv_bfloat162*>(&olo);
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&ohi);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const __nv_bfloat162 ylo = __hmul2_rn(__hmul2_rn(lo[i], rt), w2[e0 / 2 + i]);
      const __nv_bfloat162 yhi = __hmul2_rn(__hmul2_rn(hi[i], rt), w2[(half + e0) / 2 + i]);
      ol[i] = __hsub2(__hmul2_rn(ylo, c2[c][i]), __hmul2_rn(yhi, s2[c][i]));
      oh[i] = __hadd2(__hmul2_rn(yhi, c2[c][i]), __hmul2_rn(ylo, s2[c][i]));
    }
    *reinterpret_cast<W*>(out + e0) = olo;
    *reinterpret_cast<W*>(out + half + e0) = ohi;
  }
}

template <typename T, int V, int NC>
__global__ void __launch_bounds__(kThreads) qk_norm_rope_fwd_kernel(const Args a) {
  constexpr int kMaxD = 64 * V * NC;
  __shared__ float sw[2][kMaxD];
  __shared__ float sf[kMaxD / 2];
  constexpr bool kPacked = std::is_same<T, __nv_bfloat16>::value && V % 2 == 0;
  __shared__ __nv_bfloat162 sw2[2][kPacked ? kMaxD / 2 : 1];
  load_tables<T, kMaxD>(a, sw, sf);
  if constexpr (kPacked) {
    for (int e = threadIdx.x; e < a.d / 2; e += kThreads) {
      sw2[0][e] = __floats2bfloat162_rn(sw[0][2 * e], sw[0][2 * e + 1]);
      sw2[1][e] = __floats2bfloat162_rn(sw[1][2 * e], sw[1][2 * e + 1]);
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, tpw = 32 / a.lanes, rows = a.hq + a.hk;
  const int j = lane % a.lanes, slot = lane / a.lanes, half = a.d / 2;
  const uint64_t groups = (static_cast<uint64_t>(a.tokens) + tpw - 1) / tpw;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kWarps;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  T* oq = static_cast<T*>(a.out_q);
  T* ok = static_cast<T*>(a.out_k);
  Step st{static_cast<uint64_t>(blockIdx.x) * kWarps + threadIdx.x / 32, 0};
  if (st.g >= groups) return;  // whole warps: no shuffle waits for them
  auto src = [&](Step s) -> const T* {
    const uint64_t tok = s.g * tpw + slot;
    return tok < a.tokens ? (s.r < a.hq ? q : k) + row_index(a, tok, s.r) * a.d : nullptr;
  };
  Raw<T, V, NC> cur, nxt;
  load_raw<T, V, NC>(src(st), cur, j, a.lanes, half);
  float cs[NC][V], sn[NC][V];
  __nv_bfloat162 c2[NC][kPacked ? V / 2 : 1], s2[NC][kPacked ? V / 2 : 1];
  while (true) {
    const uint64_t tok = st.g * tpw + slot;
    const bool valid = tok < a.tokens;
    if (st.r == 0) {
      rope_angles<T, V, NC>(valid ? __int2float_rn(a.pos[tok]) : 0.f, sf, j, a.lanes, half,
                            cs, sn);
      if constexpr (kPacked) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < V / 2; ++i) {
            c2[c][i] = __floats2bfloat162_rn(cs[c][2 * i], cs[c][2 * i + 1]);
            s2[c][i] = __floats2bfloat162_rn(sn[c][2 * i], sn[c][2 * i + 1]);
          }
      }
    }
    const Step nx = next_step(st, stride, rows);
    const bool more = nx.g < groups;
    if (more) load_raw<T, V, NC>(src(nx), nxt, j, a.lanes, half);
    const bool isq = st.r < a.hq;
    const uint64_t row = row_index(a, tok, st.r);
    float* rstd = isq ? a.rq : a.rk;
    if constexpr (kPacked)
      row_fwd_bf16x2<V, NC>(cur, valid, (isq ? oq : ok) + row * a.d,
                            rstd == nullptr ? nullptr : rstd + row, sw2[isq ? 0 : 1], c2, s2, a,
                            j);
    else
      row_fwd<T, V, NC>(cur, valid, (isq ? oq : ok) + row * a.d,
                        rstd == nullptr ? nullptr : rstd + row, sw[isq ? 0 : 1], cs, sn, a, j);
    if (!more) break;
    cur = nxt;
    st = nx;
  }
}

// N2 on one row: dx into out, and this lane's share of the weight grad
// (sum of dy * the normed value) added to acc.
template <typename T, int V, int NC>
__device__ __forceinline__ void row_bwd(const Raw<T, V, NC>& xr, const Raw<T, V, NC>& gr,
                                        bool valid, T* out, float r, const float* w,
                                        const float (&cs)[NC][V], const float (&sn)[NC][V],
                                        float (&acc)[2][NC][V], const Args& a, int j) {
  const int half = a.d / 2;
  const float rt = rnd<T>(r);
  float xlo[NC][V], xhi[NC][V], dlo[NC][V], dhi[NC][V], p[NC][V];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int e0 = (j + a.lanes * c) * V;
    float glo[V], ghi[V];
    unpack<T, V>(xr.lo[c], xlo[c]);
    unpack<T, V>(xr.hi[c], xhi[c]);
    unpack<T, V>(gr.lo[c], glo);
    unpack<T, V>(gr.hi[c], ghi);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      // out_lo = y_lo c - y_hi s, out_hi = y_hi c + y_lo s
      const float dylo = glo[i] * cs[c][i] + ghi[i] * sn[c][i];
      const float dyhi = ghi[i] * cs[c][i] - glo[i] * sn[c][i];
      const float nlo = rnd<T>(__fmul_rn(xlo[c][i], rt));
      const float nhi = rnd<T>(__fmul_rn(xhi[c][i], rt));
      acc[0][c][i] += dylo * nlo;
      acc[1][c][i] += dyhi * nhi;
      const bool in = e0 < half;
      dlo[c][i] = in ? dylo * w[e0 + i] : 0.f;
      dhi[c][i] = in ? dyhi * w[half + e0 + i] : 0.f;
      p[c][i] = dlo[c][i] * xlo[c][i] + dhi[c][i] * xhi[c][i];
    }
  }
  // d rstd / dx_i = -r^3 x_i / D; the cast of r to T passes the grad through
  const float coef = r * r * r * a.inv_d * row_sum<V, NC>(p, a.lanes);
  if (!valid) return;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int e0 = (j + a.lanes * c) * V;
    if (e0 >= half) continue;
    float olo[V], ohi[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      olo[i] = dlo[c][i] * rt - xlo[c][i] * coef;
      ohi[i] = dhi[c][i] * rt - xhi[c][i] * coef;
    }
    store_vec<T, V>(out + e0, olo);
    store_vec<T, V>(out + half + e0, ohi);
  }
}

// This CTA's weight-grad partial of one norm (acc summed over the warp's row
// slots, then over the warps in order) into ws[blockIdx.x][which]
template <int V, int NC, int MAXD>
__device__ __forceinline__ void cta_partial(float (&acc)[2][NC][V], float (&red)[MAXD],
                                            const Args& a, int which, int j, int slot) {
  for (int m = a.lanes; m < 32; m <<= 1)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc[0][c][i] += __shfl_xor_sync(0xffffffffu, acc[0][c][i], m);
        acc[1][c][i] += __shfl_xor_sync(0xffffffffu, acc[1][c][i], m);
      }
  const int half = a.d / 2, warp = threadIdx.x / 32;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && slot == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int e0 = (j + a.lanes * c) * V;
        if (e0 >= half) continue;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          red[e0 + i] = w == 0 ? acc[0][c][i] : red[e0 + i] + acc[0][c][i];
          red[half + e0 + i] = w == 0 ? acc[1][c][i] : red[half + e0 + i] + acc[1][c][i];
        }
      }
    }
    __syncthreads();
  }
  float* out = a.ws + (static_cast<uint64_t>(blockIdx.x) * 2 + which) * a.d;
  for (int e = threadIdx.x; e < a.d; e += kThreads) out[e] = red[e];
  __syncthreads();
}

template <typename T, int V, int NC>
__global__ void __launch_bounds__(kThreads) qk_norm_rope_bwd_kernel(const Args a) {
  constexpr int kMaxD = 64 * V * NC;
  __shared__ float sw[2][kMaxD];
  __shared__ float sf[kMaxD / 2];
  __shared__ float red[kMaxD];
  load_tables<T, kMaxD>(a, sw, sf);
  const int lane = threadIdx.x & 31, tpw = 32 / a.lanes, rows = a.hq + a.hk;
  const int j = lane % a.lanes, slot = lane / a.lanes, half = a.d / 2;
  const uint64_t groups = (static_cast<uint64_t>(a.tokens) + tpw - 1) / tpw;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kWarps;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* gq = static_cast<const T*>(a.gq);
  const T* gk = static_cast<const T*>(a.gk);
  T* dq = static_cast<T*>(a.out_q);
  T* dk = static_cast<T*>(a.out_k);
  float accq[2][NC][V], acck[2][NC][V];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < V; ++i)
      accq[0][c][i] = accq[1][c][i] = acck[0][c][i] = acck[1][c][i] = 0.f;
  Step st{static_cast<uint64_t>(blockIdx.x) * kWarps + threadIdx.x / 32, 0};
  if (st.g < groups) {  // warps with no token take part in cta_partial only
    auto load = [&](Step s, Raw<T, V, NC>& xr, Raw<T, V, NC>& gr) {
      const uint64_t tok = s.g * tpw + slot;
      const bool in = tok < a.tokens;
      const uint64_t off = in ? row_index(a, tok, s.r) * a.d : 0;
      load_raw<T, V, NC>(in ? (s.r < a.hq ? q : k) + off : nullptr, xr, j, a.lanes, half);
      load_raw<T, V, NC>(in ? (s.r < a.hq ? gq : gk) + off : nullptr, gr, j, a.lanes, half);
    };
    Raw<T, V, NC> xc, gc, xn, gn;
    load(st, xc, gc);
    float cs[NC][V], sn[NC][V];
    while (true) {
      const uint64_t tok = st.g * tpw + slot;
      const bool valid = tok < a.tokens;
      if (st.r == 0)
        rope_angles<T, V, NC>(valid ? __int2float_rn(a.pos[tok]) : 0.f, sf, j, a.lanes, half,
                              cs, sn);
      const Step nx = next_step(st, stride, rows);
      const bool more = nx.g < groups;
      if (more) load(nx, xn, gn);
      const uint64_t row = row_index(a, tok, st.r);
      if (st.r < a.hq)
        row_bwd<T, V, NC>(xc, gc, valid, dq + row * a.d, valid ? a.rq[row] : 0.f, sw[0], cs, sn,
                          accq, a, j);
      else
        row_bwd<T, V, NC>(xc, gc, valid, dk + row * a.d, valid ? a.rk[row] : 0.f, sw[1], cs, sn,
                          acck, a, j);
      if (!more) break;
      xc = xn;
      gc = gn;
      st = nx;
    }
  }
  cta_partial<V, NC, kMaxD>(accq, red, a, 0, j, slot);
  cta_partial<V, NC, kMaxD>(acck, red, a, 1, j, slot);
}

// dw[which][e] = the sum over CTAs b, in order, of ws[b][which][e]
__global__ void qk_norm_rope_dw_kernel(const float* __restrict__ ws, float* __restrict__ dwq,
                                       float* __restrict__ dwk, int d, int ctas) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * d) return;
  const int which = t / d, e = t % d;
  float s = 0.f;
  for (int b = 0; b < ctas; ++b) s += ws[(static_cast<uint64_t>(b) * 2 + which) * d + e];
  (which == 0 ? dwq : dwk)[e] = s;
}

// The halving tree over the row's pair sums s[0, n) (n a power of two, zero
// past the row's D/2), in shared memory; every lane returns the sum.
__device__ __forceinline__ float tree_sum(float* s, int n, int lane) {
  for (int m = n / 2; m >= 1; m /= 2) {
    __syncwarp();
    for (int i = lane; i < m; i += 32) s[i] = __fadd_rn(s[i], s[i + m]);
  }
  __syncwarp();
  const float sum = s[0];
  __syncwarp();  // read by every lane before the next row writes s
  return sum;
}

// D/2 rounded up to a power of two: the length of the pair sums' tree
__host__ __device__ __forceinline__ int padded_half(int half) {
  int n = 1;
  while (n < half) n <<= 1;
  return n;
}

// This lane's cos and sin of element i at position pf, rounded to T
template <typename T>
__device__ __forceinline__ void angle(float pf, const float* inv_freq, int i, float& cs,
                                      float& sn) {
  const float ang = __fmul_rn(pf, inv_freq[i]);
  cs = rnd<T>(cosf(ang));
  sn = rnd<T>(sinf(ang));
}

// N1 on rows too wide for registers: a one-warp CTA a token at a time, the
// row's pair sums in shared memory [padded_half(d / 2)]; each element
// rounded as in row_fwd.
template <typename T>
__global__ void __launch_bounds__(32) qk_norm_rope_fwd_wide_kernel(const Args a) {
  extern __shared__ float s[];
  const int lane = threadIdx.x, half = a.d / 2, n = padded_half(half), rows = a.hq + a.hk;
  for (uint64_t tok = blockIdx.x; tok < a.tokens; tok += gridDim.x) {
    const float pf = __int2float_rn(a.pos[tok]);
    for (int r = 0; r < rows; ++r) {
      const bool isq = r < a.hq;
      const uint64_t row = row_index(a, tok, r);
      const T* x = static_cast<const T*>(isq ? a.q : a.k) + row * a.d;
      T* out = static_cast<T*>(isq ? a.out_q : a.out_k) + row * a.d;
      const float* w = isq ? a.wq : a.wk;
      for (int i = lane; i < n; i += 32) {
        float p = 0.f;
        if (i < half) {
          const float lo = gamer::to_f(x[i]), hi = gamer::to_f(x[half + i]);
          p = __fadd_rn(__fmul_rn(lo, lo), __fmul_rn(hi, hi));
        }
        s[i] = p;
      }
      const float rs = rsqrtf(__fadd_rn(__fmul_rn(tree_sum(s, n, lane), a.inv_d), a.eps));
      float* rstd = isq ? a.rq : a.rk;
      if (rstd != nullptr && lane == 0) rstd[row] = rs;
      const float rt = rnd<T>(rs);
      for (int i = lane; i < half; i += 32) {
        const float lo = gamer::to_f(x[i]), hi = gamer::to_f(x[half + i]);
        float cs, sn;
        angle<T>(pf, a.inv_freq, i, cs, sn);
        const float ylo = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(lo, rt)), rnd<T>(w[i])));
        const float yhi = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(hi, rt)), rnd<T>(w[half + i])));
        out[i] = gamer::from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(ylo, cs)),
                                            rnd<T>(__fmul_rn(-yhi, sn))));
        out[half + i] = gamer::from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(yhi, cs)),
                                                   rnd<T>(__fmul_rn(ylo, sn))));
      }
    }
  }
}

// N2 on rows too wide for registers, as row_bwd computes it: a one-warp CTA
// a token at a time; shared memory holds the CTA's weight grads [2][d] (lane
// j owns the elements i and i + d/2 of every i = j mod 32, so each sums in
// a fixed order) and the row's pair sums. Writes the CTA's partials to
// ws[blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(32) qk_norm_rope_bwd_wide_kernel(const Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x, half = a.d / 2, n = padded_half(half), rows = a.hq + a.hk;
  float* acc = smem;         // [2][d]
  float* s = smem + 2 * a.d;  // [n]
  for (int e = lane; e < 2 * a.d; e += 32) acc[e] = 0.f;
  __syncwarp();
  // elements i and i + d/2 (i < d/2) of a row: x, the grads dy of the
  // normed values (before the weights) and d = dy * weight
  auto grads = [&](const T* x, const T* g, const float* w, float pf, int i, float& xlo,
                   float& xhi, float& dlo, float& dhi, float& dylo, float& dyhi) {
    float cs, sn;
    angle<T>(pf, a.inv_freq, i, cs, sn);
    xlo = gamer::to_f(x[i]);
    xhi = gamer::to_f(x[half + i]);
    const float glo = gamer::to_f(g[i]), ghi = gamer::to_f(g[half + i]);
    dylo = glo * cs + ghi * sn;
    dyhi = ghi * cs - glo * sn;
    dlo = dylo * rnd<T>(w[i]);
    dhi = dyhi * rnd<T>(w[half + i]);
  };
  for (uint64_t tok = blockIdx.x; tok < a.tokens; tok += gridDim.x) {
    const float pf = __int2float_rn(a.pos[tok]);
    for (int r = 0; r < rows; ++r) {
      const bool isq = r < a.hq;
      const uint64_t row = row_index(a, tok, r);
      const T* x = static_cast<const T*>(isq ? a.q : a.k) + row * a.d;
      const T* g = static_cast<const T*>(isq ? a.gq : a.gk) + row * a.d;
      T* out = static_cast<T*>(isq ? a.out_q : a.out_k) + row * a.d;
      const float* w = isq ? a.wq : a.wk;
      float* ac = acc + (isq ? 0 : a.d);
      const float rs = (isq ? a.rq : a.rk)[row], rt = rnd<T>(rs);
      for (int i = lane; i < n; i += 32) {
        float p = 0.f;
        if (i < half) {
          float xlo, xhi, dlo, dhi, dylo, dyhi;
          grads(x, g, w, pf, i, xlo, xhi, dlo, dhi, dylo, dyhi);
          ac[i] += dylo * rnd<T>(__fmul_rn(xlo, rt));
          ac[half + i] += dyhi * rnd<T>(__fmul_rn(xhi, rt));
          p = dlo * xlo + dhi * xhi;
        }
        s[i] = p;
      }
      // d rstd / dx_i = -r^3 x_i / D; the cast of r to T passes the grad through
      const float coef = rs * rs * rs * a.inv_d * tree_sum(s, n, lane);
      for (int i = lane; i < half; i += 32) {
        float xlo, xhi, dlo, dhi, dylo, dyhi;
        grads(x, g, w, pf, i, xlo, xhi, dlo, dhi, dylo, dyhi);
        out[i] = gamer::from_f<T>(dlo * rt - xlo * coef);
        out[half + i] = gamer::from_f<T>(dhi * rt - xhi * coef);
      }
    }
  }
  __syncwarp();
  float* part = a.ws + static_cast<uint64_t>(blockIdx.x) * 2 * a.d;
  for (int e = lane; e < 2 * a.d; e += 32) part[e] = acc[e];
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// CTAs of `kernel` resident on one SM
template <typename K>
int per_sm(K kernel) {
  int n = 1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) != cudaSuccess ||
      n < 1)
    n = 1;
  return n;
}

// CTAs of a grid-stride walk over `groups` warp-sized token groups: as many
// as fit on the card at once (and at most `cap`), then as few as still take
// the same number of rounds, so that every warp walks as many groups as the
// others, give or take one, and none trails the rest by a round.
int balanced_grid(int resident_ctas, uint64_t groups, int cap) {
  const uint64_t resident = static_cast<uint64_t>(resident_ctas) * sm_count() * kWarps;
  const uint64_t most = static_cast<uint64_t>(cap) * kWarps;
  const uint64_t warps = resident < most ? resident : most;
  const uint64_t rounds = (groups + warps - 1) / warps;
  const uint64_t need = (groups + rounds - 1) / rounds;  // warps that take `rounds` each
  return static_cast<int>((need + kWarps - 1) / kWarps);
}

template <typename T, int V, int NC>
cudaError_t launch(const Args& a, float* dwq, float* dwk, int cap, cudaStream_t st) {
  const int tpw = 32 / a.lanes;
  const uint64_t groups = (static_cast<uint64_t>(a.tokens) + tpw - 1) / tpw;
  static const int fwd_per_sm = per_sm(qk_norm_rope_fwd_kernel<T, V, NC>);
  static const int bwd_per_sm = per_sm(qk_norm_rope_bwd_kernel<T, V, NC>);
  if (a.gq == nullptr) {
    const int blocks = balanced_grid(fwd_per_sm, groups, cap);
    qk_norm_rope_fwd_kernel<T, V, NC><<<blocks, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  const int blocks = balanced_grid(bwd_per_sm, groups, cap);
  qk_norm_rope_bwd_kernel<T, V, NC><<<blocks, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qk_norm_rope_dw_kernel<<<(2 * a.d + 255) / 256, 256, 0, st>>>(a.ws, dwq, dwk, a.d, blocks);
  return cudaGetLastError();
}

// The wide kernels: min(tokens, cap) one-warp CTAs, each walking tokens;
// their shared memory opted in past the default 48 KB where the row needs it.
template <typename T>
cudaError_t launch_wide(const Args& a, float* dwq, float* dwk, int cap, cudaStream_t st) {
  const int n = padded_half(a.d / 2);
  const bool bwd = a.gq != nullptr;
  const size_t smem = sizeof(float) * (n + (bwd ? 2 * static_cast<size_t>(a.d) : 0));
  const int blocks = static_cast<int>(a.tokens < static_cast<unsigned>(cap) ? a.tokens : cap);
  const void* kernel = bwd ? reinterpret_cast<const void*>(qk_norm_rope_bwd_wide_kernel<T>)
                           : reinterpret_cast<const void*>(qk_norm_rope_fwd_wide_kernel<T>);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (!bwd) {
    qk_norm_rope_fwd_wide_kernel<T><<<blocks, 32, smem, st>>>(a);
    return cudaGetLastError();
  }
  qk_norm_rope_bwd_wide_kernel<T><<<blocks, 32, smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qk_norm_rope_dw_kernel<<<(2 * a.d + 255) / 256, 256, 0, st>>>(a.ws, dwq, dwk, a.d, blocks);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_v(const Args& a, float* dwq, float* dwk, int chunks, int cap,
                     cudaStream_t st) {
  switch (chunks) {
    case 1: return launch<T, V, 1>(a, dwq, dwk, cap, st);
    case 2: return launch<T, V, 2>(a, dwq, dwk, cap, st);
    case 4: return launch<T, V, 4>(a, dwq, dwk, cap, st);
    default: return chunks > 4 ? launch_wide<T>(a, dwq, dwk, cap, st) : cudaErrorInvalidValue;
  }
}

}  // namespace

// N1 when gq is null, else N2 (which also needs ws [blocks, 2, d] and writes
// dwq, dwk [d]); either launches at most `blocks` CTAs (`balanced_grid`).
// q, k (and gq, gk, out_q, out_k) [tokens, hq or hk, d] of one
// dtype, 16-byte aligned; `vec` elements a lane-chunk (a power of two
// dividing d / 2, at most 16 bytes), `chunks` chunks a lane (1, 2 or 4 in
// registers; more takes the wide kernels), `lanes` lanes a row, as
// ops/qk_norm_rope.py `geometry` gives them.
extern "C" int gamer_qk_norm_rope(const void* q, const void* k, const void* gq, const void* gk,
                                  void* out_q, void* out_k, const float* wq, const float* wk,
                                  float* rq, float* rk, const int* pos, const float* inv_freq,
                                  float* ws, float* dwq, float* dwk, unsigned int tokens, int hq,
                                  int hk, int d, int vec, int chunks, int lanes, int blocks,
                                  float inv_d, float eps, int dtype, void* stream) {
  if (tokens == 0 || d <= 0 || d % 2 != 0 || lanes <= 0 || lanes > 32 || 32 % lanes != 0 ||
      blocks <= 0 || (gq != nullptr && (gk == nullptr || ws == nullptr || rq == nullptr ||
                                        rk == nullptr || dwq == nullptr || dwk == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k, gq, gk, out_q, out_k, wq, wk, rq, rk, pos, inv_freq, ws, tokens, hq, hk, d,
               lanes, inv_d, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gamer::kFloat32) {
    switch (vec) {
      case 1: return launch_v<float, 1>(a, dwq, dwk, chunks, blocks, st);
      case 2: return launch_v<float, 2>(a, dwq, dwk, chunks, blocks, st);
      case 4: return launch_v<float, 4>(a, dwq, dwk, chunks, blocks, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == gamer::kBFloat16) {
    switch (vec) {
      case 1: return launch_v<__nv_bfloat16, 1>(a, dwq, dwk, chunks, blocks, st);
      case 2: return launch_v<__nv_bfloat16, 2>(a, dwq, dwk, chunks, blocks, st);
      case 4: return launch_v<__nv_bfloat16, 4>(a, dwq, dwk, chunks, blocks, st);
      case 8: return launch_v<__nv_bfloat16, 8>(a, dwq, dwk, chunks, blocks, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
