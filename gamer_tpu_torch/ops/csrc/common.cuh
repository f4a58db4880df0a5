// Shared helpers of the port's hand-written kernels.
//
// Every kernel library is one .cu file compiled by nvcc into its own shared
// library with a plain C interface (ops/_build.py), loaded with ctypes. The
// C entry points take raw device pointers and the caller's CUDA stream, launch
// on that stream, never synchronise, allocate nothing, and return the
// cudaError_t of the launch (0 on success); an entry point that launches
// several kernels returns the first error.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gamer {

// dtype codes shared with the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// max / sum over the 16 lanes of a half-warp (lanes that share tid / 16)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stateless dropout hash, bit-exact with gamer_tpu/ops/pallas_attention.py
// `_fmix32` / `dropout_keep_tile`: x = row*M3 + col*M1 + bh*M2 + seed in
// uint32 (wrapping), then xorshift-multiply-xorshift; an element is kept when
// the result is >= thresh = min(round(rate * 2^32), 2^32 - 1). A pure function
// of the coordinates, so the forward and every backward kernel draw the same
// mask whatever their tiling.
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 15;
  return x;
}
__device__ __forceinline__ bool hash_keep(uint32_t seed, uint32_t bh, uint32_t row, uint32_t col,
                                          uint32_t thresh) {
  const uint32_t x = row * 0x9E3779B1u + col * 0x85EBCA6Bu + bh * 0xC2B2AE35u + seed;
  return fmix32(x) >= thresh;
}
// A dropout seed as the C entry points take it: `*ptr + add` (mod 2^32), or
// `add` alone when ptr is null. The eager callers pass null and the seed as
// an int; a captured training step (train/loop.py) passes a pointer into the
// step's seed table in device memory, which the host rewrites before every
// replay, and in `add` the static row and expert offsets of the call site
// (modules/dropout.py `row_seed`), so both give the same masks. Each thread
// reads the word once, at the top of the kernel.
struct Seed {
  const uint32_t* ptr;
  uint32_t add;
  __device__ __forceinline__ uint32_t get() const { return (ptr ? __ldg(ptr) : 0u) + add; }
};

// The same hash split in a per-row part and a per-column step (uint32
// addition wraps, so the sum is the same in any order): a tile computes
// hash_row once a row and hash_keep_at per element.
__device__ __forceinline__ uint32_t hash_row(uint32_t seed, uint32_t bh, uint32_t row) {
  return row * 0x9E3779B1u + bh * 0xC2B2AE35u + seed;
}
__device__ __forceinline__ bool hash_keep_at(uint32_t row_part, uint32_t col, uint32_t thresh) {
  return fmix32(row_part + col * 0x85EBCA6Bu) >= thresh;
}

// The GAMER attention mask kinds (ops/masks.py), as `_mask_tile` of
// gamer_tpu/ops/pallas_attention.py evaluates them from the int streams.
enum AttnKind : int { kCausal = 0, kSession = 1, kMulti = 2, kSessionMulti = 3 };

__device__ __forceinline__ bool attn_allowed(int kind, int qpos, int kpos, int q_sid, int k_sid,
                                             int q_act, int k_act, int q_blk, int k_blk,
                                             int k_ok) {
  const bool causal = qpos >= kpos;
  bool a;
  if (kind == kCausal) {
    a = causal;
  } else if (kind == kSession) {
    a = (q_blk == k_blk && q_blk >= 0 && causal) || (k_sid < q_sid);
  } else if (kind == kMulti) {
    a = causal && (k_act < q_act);
  } else {
    a = (k_sid < q_sid) && (k_act < q_act);
  }
  return a && k_ok;
}

// The mask on one thread's share of an m16n8 accumulator tile of the
// tensor-core attention kernels (C layout in mma.cuh: element e of column
// tile j sits in this thread's row e / 2 and column c = 8j + 2*(lane % 4) +
// e % 2). Streams travel as int4 (valid, sid, act, blk): a query is valid
// when it lies before S, a key when it is also not padded. Each allowed
// element becomes s * mul - sub, the others -inf, so exp2 of the result is
// the probability or exactly 0. KIND is a compile-time kind; the `kind`
// overloads switch once a tile, not once an element.
__device__ __forceinline__ bool allowed4(int kind, int qpos, int kpos, int4 qi, int4 ki) {
  return qi.x && attn_allowed(kind, qpos, kpos, qi.y, ki.y, qi.z, ki.z, qi.w, ki.w, ki.x);
}

// Rows are queries (rpos, rinf: this thread's two), columns keys c0 + c
// (cinf[c]); sub is per row.
template <int KIND, int NJ>
__device__ __forceinline__ void mask_tile_qrows_k(float (&s)[NJ][4], const int (&rpos)[2],
                                                const int4 (&rinf)[2], const int4* cinf, int c0,
                                                float mul, const float (&sub)[2], int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = 8 * j + 2 * (lane % 4) + cc;
      const int4 ci = cinf[c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 2 * i + cc;
        s[j][e] = allowed4(KIND, rpos[i], c0 + c, rinf[i], ci) ? fmaf(s[j][e], mul, -sub[i])
                                                               : -INFINITY;
      }
    }
}
template <int NJ>
__device__ __forceinline__ void mask_tile_qrows(int kind, float (&s)[NJ][4], const int (&rpos)[2],
                                                const int4 (&rinf)[2], const int4* cinf, int c0,
                                                float mul, const float (&sub)[2], int lane) {
  switch (kind) {
    case kCausal: mask_tile_qrows_k<kCausal>(s, rpos, rinf, cinf, c0, mul, sub, lane); break;
    case kSession: mask_tile_qrows_k<kSession>(s, rpos, rinf, cinf, c0, mul, sub, lane); break;
    case kMulti: mask_tile_qrows_k<kMulti>(s, rpos, rinf, cinf, c0, mul, sub, lane); break;
    default: mask_tile_qrows_k<kSessionMulti>(s, rpos, rinf, cinf, c0, mul, sub, lane);
  }
}

// Rows are keys (rpos, rinf), columns queries c0 + c (cinf[c]); sub is per
// column (csub[c].x).
template <int KIND, int NJ>
__device__ __forceinline__ void mask_tile_krows_k(float (&s)[NJ][4], const int (&rpos)[2],
                                                const int4 (&rinf)[2], const int4* cinf, int c0,
                                                float mul, const float2* csub, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = 8 * j + 2 * (lane % 4) + cc;
      const int4 ci = cinf[c];
      const float sub = csub[c].x;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 2 * i + cc;
        s[j][e] = allowed4(KIND, c0 + c, rpos[i], ci, rinf[i]) ? fmaf(s[j][e], mul, -sub)
                                                               : -INFINITY;
      }
    }
}
template <int NJ>
__device__ __forceinline__ void mask_tile_krows(int kind, float (&s)[NJ][4], const int (&rpos)[2],
                                                const int4 (&rinf)[2], const int4* cinf, int c0,
                                                float mul, const float2* csub, int lane) {
  switch (kind) {
    case kCausal: mask_tile_krows_k<kCausal>(s, rpos, rinf, cinf, c0, mul, csub, lane); break;
    case kSession: mask_tile_krows_k<kSession>(s, rpos, rinf, cinf, c0, mul, csub, lane); break;
    case kMulti: mask_tile_krows_k<kMulti>(s, rpos, rinf, cinf, c0, mul, csub, lane); break;
    default: mask_tile_krows_k<kSessionMulti>(s, rpos, rinf, cinf, c0, mul, csub, lane);
  }
}

// The fixed-order second step of a split reduction: out[i] = sum over s of
// ws[s * count + i], in order of s, cast to OutT (deterministic).
template <typename OutT>
__global__ void reduce_splits_kernel(const float* __restrict__ ws, OutT* __restrict__ out,
                                     size_t count, int nsplit) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += ws[k * count + i];
    out[i] = from_f<OutT>(s);
  }
}

template <typename OutT>
cudaError_t reduce_splits(const float* ws, OutT* out, size_t count, int nsplit,
                          cudaStream_t stream) {
  const size_t want = (count + 255) / 256;
  reduce_splits_kernel<OutT><<<static_cast<int>(want < 4096 ? want : 4096), 256, 0, stream>>>(
      ws, out, count, nsplit);
  return cudaGetLastError();
}

}  // namespace gamer

extern "C" const char* gamer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
