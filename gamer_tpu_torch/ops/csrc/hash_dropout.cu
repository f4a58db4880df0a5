// Residual hash dropout, fused with its residual add: out = r + where(keep, y * scale, 0).
//
// Replaces XLA's fusion of gamer_tpu/modules/dropout.py `_hash_keep_mask` /
// `_hash_dropout` (:119-146) into the residual add that consumes it
// (gamer_tpu/models/generative/qwen_family.py:284): the JAX package has no
// pallas_call here, XLA fuses the hash into the add. One kernel serves both
// directions: the forward (K1) with a residual or without one (plain dropout),
// and the backward (K2), dy = where(keep, g * scale, 0), which is K1 without
// a residual (dr = g needs no launch).
//
// The keep mask is fmix32 of the element's logical row-major flat index i,
// in uint32 with native wrap-around (the seed read on the card from
// `gamer::Seed`, common.cuh): x = i * M3 + seed, x ^= x >> 16,
// x *= M1, x ^= x >> 15, kept when x >= thresh. It rounds where the plain
// version (ops/hash_dropout.py) and JAX round: `scale` is 1 / keep_prob
// already rounded to the dtype by the caller, y * scale is rounded to the
// dtype, and only then is r added, in fp32, and rounded to the dtype (y, r
// and out share one dtype, float32 or bfloat16: the port's call sites pass
// no other pair). The multiply and the add are __fmul_rn / __fadd_rn, never
// contracted into an FMA, so the result equals the plain version bit for bit.
//
// Bound: bytes (an elementwise pass: y and r read once, out written once; a
// few integer operations an element). Each thread owns 8 consecutive
// elements a step, moved as 16-byte vectors (one for bf16, two for fp32),
// in a grid-stride loop over a grid of 8 blocks of 256 threads an SM; a
// tensor whose pointers are not all 16-byte aligned, and the last n % 8
// elements, take the scalar route. Each element is written by exactly one
// thread, without atomics, so the result is deterministic.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads an SM
constexpr int kVec = 8;          // elements a thread a step
constexpr uint32_t kM1 = 0x85EBCA6Bu, kM3 = 0x9E3779B1u;

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int k = 0; k < kVec; ++k) h[k] = __float2bfloat16_rn(v[k]);
  *reinterpret_cast<uint4*>(p) = u;
}

// where(keep, y * scale, 0) of element i, y * scale rounded to T
template <typename T>
__device__ __forceinline__ float dropped(float y, uint32_t i, uint32_t seed, uint32_t thresh,
                                         float scale) {
  uint32_t x = i * kM3 + seed;
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  return x >= thresh ? gamer::to_f(gamer::from_f<T>(__fmul_rn(y, scale))) : 0.0f;
}

// r is null when HAS_R is false
template <typename T, bool HAS_R, bool VEC>
__global__ void __launch_bounds__(kThreads)
    hash_dropout_kernel(const T* __restrict__ y, const T* __restrict__ r, T* __restrict__ out,
                        uint32_t n, gamer::Seed seed_in, uint32_t thresh, float scale) {
  const uint32_t seed = seed_in.get();
  const uint64_t groups = (static_cast<uint64_t>(n) + kVec - 1) / kVec;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kThreads;
  for (uint64_t g = blockIdx.x * static_cast<uint64_t>(kThreads) + threadIdx.x; g < groups;
       g += stride) {
    const uint64_t base = g * kVec;
    if (VEC && base + kVec <= n) {
      float v[kVec], o[kVec];
      load8(y + base, v);
      if constexpr (HAS_R) load8(r + base, o);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float d = dropped<T>(v[k], static_cast<uint32_t>(base + k), seed, thresh, scale);
        o[k] = HAS_R ? __fadd_rn(o[k], d) : d;
      }
      store8(out + base, o);
    } else {
      for (uint64_t e = base; e < base + kVec && e < n; ++e) {
        const float d = dropped<T>(gamer::to_f(y[e]), static_cast<uint32_t>(e), seed, thresh,
                                   scale);
        out[e] = gamer::from_f<T>(HAS_R ? __fadd_rn(gamer::to_f(r[e]), d) : d);
      }
    }
  }
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

template <typename T, bool HAS_R>
cudaError_t launch(const void* y, const void* r, void* out, uint32_t n, gamer::Seed seed,
                   uint32_t thresh, float scale, cudaStream_t st) {
  const uint64_t groups = (static_cast<uint64_t>(n) + kVec - 1) / kVec;
  const uint64_t want = (groups + kThreads - 1) / kThreads;
  const uint64_t cap = static_cast<uint64_t>(sm_count()) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(out);
  const T* yp = static_cast<const T*>(y);
  const T* rp = static_cast<const T*>(r);
  T* op = static_cast<T*>(out);
  if (addr % 16 == 0)
    hash_dropout_kernel<T, HAS_R, true><<<blocks, kThreads, 0, st>>>(yp, rp, op, n, seed, thresh,
                                                                      scale);
  else
    hash_dropout_kernel<T, HAS_R, false><<<blocks, kThreads, 0, st>>>(yp, rp, op, n, seed, thresh,
                                                                       scale);
  return cudaGetLastError();
}

}  // namespace

// y, r and out [n] of one dtype; r null for the dropout alone (K1 without a
// residual, and K2). `scale` is 1 / keep_prob rounded to the dtype.
extern "C" int gamer_hash_dropout(const void* y, const void* r, void* out, unsigned int n,
                                  const unsigned int* seed_ptr, unsigned int seed_add,
                                  unsigned int thresh, float scale, int dtype,
                                  void* stream) {
  const gamer::Seed seed{seed_ptr, seed_add};
  if (n == 0 || y == nullptr || out == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool has_r = r != nullptr;
  if (dtype == gamer::kFloat32)
    return (has_r ? launch<float, true> : launch<float, false>)(y, r, out, n, seed, thresh, scale,
                                                                st);
  if (dtype == gamer::kBFloat16)
    return (has_r ? launch<__nv_bfloat16, true> : launch<__nv_bfloat16, false>)(
        y, r, out, n, seed, thresh, scale, st);
  return cudaErrorInvalidValue;
}
