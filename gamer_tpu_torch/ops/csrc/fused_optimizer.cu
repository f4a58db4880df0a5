// The optimizer update over every parameter tensor at once: kernel L.
//
// Replaces XLA's fusion of the optax chain of gamer_tpu/train/state.py:90-95
// (`clip_by_global_norm`, then `adamw` or the coupled-decay families) inside
// the jitted train step (gamer_tpu/train/loop.py:103-116): the JAX package
// has no pallas_call here, XLA fuses the update into a few loops over the
// parameters. L takes the place of that fusion. It reads a device table of
// per-tensor records instead of being launched once per tensor, and it reads
// every value that changes between updates (the learning rate, the bias
// corrections, the global norm) from device memory, so a captured training
// step (train/loop.py) replays it as it is.
//
//   L1 (phase 0): per-chunk sums of g^2 in fp64 (one CTA a chunk of kChunk
//      elements of one tensor, a fixed thread order and a fixed tree, no
//      atomics), then one CTA adds the chunk sums in chunk order into two
//      totals: the replicated tensors' and the tensors split on a model
//      axis, which the caller all-reduces over the model group between L1
//      and L2 (train/state.py).
//   L2 (phase 1): norm = sqrt(total), rounded to fp32; per element the clip
//      select of optax (g when norm < max_norm, else g / norm * max_norm:
//      never a host branch), then the family's rule on p and its moments,
//      updated in place, with lr and the bias corrections 1 - b^t from the
//      fp32 scalar buffer.
//
// Rounding: every step is the plain version's (train/state.py `plain_update`)
// as PyTorch's CUDA kernels compute it: __fdiv_rn / __fsqrt_rn / __fmul_rn /
// __fadd_rn where the plain version rounds each op, __fmaf_rn where its op is
// an `add_(alpha=)` or `addcmul_` that PyTorch's CUDA kernels contract into an
// FMA; rsqrtf as torch.rsqrt. The norm is summed in fp64 here and in fp32 by
// the plain version, so the two agree to the norm's last fp32 bits.
//
// Record table (int64): 8 words a tensor, then one word a chunk (its record):
//   [p, g, m, v, n, flags (1 sharded, 2 decayed), first chunk, 0]
// m and v are null where the family keeps no such moment (v holds nu, or
// adagrad's sum of squares). Every tensor is fp32 and contiguous; the flags
// say whether the tensor is split on a model axis and whether it decays
// (the family's decay rule applies: decoupled for adamw, coupled L2 else).
//
// Bound: bytes. L1 reads g once (4 bytes an element); L2 reads p, g and the
// family's moments and writes p and the moments (adam: 28 bytes an
// element). Loads and stores are 16-byte vectors where a record's pointers
// are 16-byte aligned (chunks start at multiples of kChunk), scalar
// otherwise and for a chunk's last n % 4 elements. Each element is written by
// one thread, so the update is deterministic.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16384;  // elements a CTA: 16 float4 a thread
constexpr int kTotalThreads = 1024;

enum Family : int { kAdamW = 0, kAdam = 1, kSgd = 2, kAdagrad = 3, kRmsprop = 4 };

struct Record {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t n;
  int64_t flags;
  int64_t chunk0;
};

__device__ __forceinline__ Record record(const int64_t* table, int r) {
  const int64_t* w = table + 8 * static_cast<int64_t>(r);
  return Record{reinterpret_cast<float*>(w[0]), reinterpret_cast<const float*>(w[1]),
                reinterpret_cast<float*>(w[2]), reinterpret_cast<float*>(w[3]), w[4], w[5], w[6]};
}

// sum over the CTA in a fixed order: shuffles within each warp, then warp 0
// over the warps' sums
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // a previous call's reads of warp_sums are done
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  const int warps = (blockDim.x + 31) >> 5;
  x = lane < warps ? warp_sums[lane] : 0.0;
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;  // valid in thread 0
}

__device__ __forceinline__ double sq(float x) {
  const double d = x;
  return d * d;
}

// L1a: partials[2 c + sharded] = sum of g^2 over chunk c, the other slot 0
__global__ void __launch_bounds__(kThreads)
    norm_partials_kernel(const int64_t* __restrict__ table, int n_rec,
                         double* __restrict__ partials) {
  const int c = blockIdx.x;
  const Record r = record(table, static_cast<int>(table[8 * static_cast<int64_t>(n_rec) + c]));
  const int64_t start = (c - r.chunk0) * static_cast<int64_t>(kChunk);
  const int64_t end = start + kChunk < r.n ? start + kChunk : r.n;
  double acc = 0.0;
  int64_t tail = start;
  if (reinterpret_cast<uintptr_t>(r.g) % 16 == 0) {
    const int64_t nv = (end - start) / 4;
    const float4* g4 = reinterpret_cast<const float4*>(r.g + start);
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      const float4 g = g4[i];
      acc += sq(g.x) + sq(g.y) + sq(g.z) + sq(g.w);
    }
    tail = start + 4 * nv;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) acc += sq(r.g[i]);
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    const int sharded = static_cast<int>(r.flags & 1);
    partials[2 * c + sharded] = acc;
    partials[2 * c + 1 - sharded] = 0.0;
  }
}

// L1b: totals[0..1] = the chunk sums of each kind, added in chunk order
__global__ void __launch_bounds__(kTotalThreads)
    norm_total_kernel(const double* __restrict__ partials, int n_chunks,
                      double* __restrict__ totals) {
  double a = 0.0, b = 0.0;
  for (int i = threadIdx.x; i < n_chunks; i += kTotalThreads) {
    a += partials[2 * i];
    b += partials[2 * i + 1];
  }
  a = block_sum(a);
  b = block_sum(b);
  if (threadIdx.x == 0) {
    totals[0] = a;
    totals[1] = b;
  }
}

struct Hyper {
  float b1, b2, c1, c2, eps, wd, max_norm;  // c1 = 1 - b1, c2 = 1 - b2 (rounded from double)
  int clip;                                  // 0: no clipping
};

// one element's update; p, m, v in place
template <int F>
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, bool decay,
                                       bool keep, float norm, float lr, float bc1, float bc2,
                                       const Hyper& h) {
  if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), h.max_norm);
  float u;
  if (F == kAdamW || F == kAdam) {
    if (F == kAdam && decay) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    m = __fmaf_rn(g, h.c1, __fmul_rn(m, h.b1));               // mu.mul_(b1).add_(g, alpha=c1)
    v = __fmaf_rn(__fmul_rn(h.c2, g), g, __fmul_rn(v, h.b2));  // nu.mul_(b2).addcmul_(g, g, c2)
    u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps));
    if (F == kAdamW && decay) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  } else {
    if (decay) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    if (F == kSgd) {
      u = g;
    } else if (F == kAdagrad) {
      v = __fmaf_rn(g, g, v);  // sum_sq.addcmul_(g, g)
      u = __fmul_rn(g, v > 0.0f ? rsqrtf(__fadd_rn(v, 1e-7f)) : 0.0f);
    } else {  // rmsprop
      // nu.mul_(0.9).addcmul_(g, g, value=0.1)
      v = __fmaf_rn(__fmul_rn(0.1f, g), g, __fmul_rn(v, 0.9f));
      u = __fmul_rn(g, rsqrtf(__fadd_rn(v, 1e-8f)));
    }
  }
  p = __fsub_rn(p, __fmul_rn(u, lr));  // p.sub_(u * lr)
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    update_kernel(const int64_t* __restrict__ table, int n_rec, const double* __restrict__ totals,
                  const float* __restrict__ scalars, Hyper h) {
  const int c = blockIdx.x;
  const Record r = record(table, static_cast<int>(table[8 * static_cast<int64_t>(n_rec) + c]));
  const int64_t start = (c - r.chunk0) * static_cast<int64_t>(kChunk);
  const int64_t end = start + kChunk < r.n ? start + kChunk : r.n;
  const float norm = static_cast<float>(sqrt(totals[0] + totals[1]));
  const bool keep = !h.clip || norm < h.max_norm;
  const float lr = scalars[0], bc1 = scalars[1], bc2 = scalars[2];
  const bool decay = (r.flags & 2) != 0;
  constexpr bool kM = F == kAdamW || F == kAdam, kV = F != kSgd;
  float dummy = 0.0f;
  int64_t tail = start;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(r.p) | reinterpret_cast<uintptr_t>(r.g) |
                         (kM ? reinterpret_cast<uintptr_t>(r.m) : 0) |
                         (kV ? reinterpret_cast<uintptr_t>(r.v) : 0);
  if (addr % 16 == 0) {
    const int64_t nv = (end - start) / 4;
    float4* p4 = reinterpret_cast<float4*>(r.p + start);
    const float4* g4 = reinterpret_cast<const float4*>(r.g + start);
    float4* m4 = kM ? reinterpret_cast<float4*>(r.m + start) : nullptr;
    float4* v4 = kV ? reinterpret_cast<float4*>(r.v + start) : nullptr;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float4 p = p4[i];
      const float4 g = g4[i];
      float4 m = kM ? m4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 v = kV ? v4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      update<F>(p.x, g.x, m.x, v.x, decay, keep, norm, lr, bc1, bc2, h);
      update<F>(p.y, g.y, m.y, v.y, decay, keep, norm, lr, bc1, bc2, h);
      update<F>(p.z, g.z, m.z, v.z, decay, keep, norm, lr, bc1, bc2, h);
      update<F>(p.w, g.w, m.w, v.w, decay, keep, norm, lr, bc1, bc2, h);
      p4[i] = p;
      if (kM) m4[i] = m;
      if (kV) v4[i] = v;
    }
    tail = start + 4 * nv;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) {
    float& m = kM ? r.m[i] : dummy;
    float& v = kV ? r.v[i] : dummy;
    update<F>(r.p[i], r.g[i], m, v, decay, keep, norm, lr, bc1, bc2, h);
  }
}

}  // namespace

// phase 0 (L1): table [8 n_rec + n_chunks] int64, partials [2 n_chunks] and
// totals [2] fp64 written. phase 1 (L2): reads totals and scalars [lr, 1 -
// b1^t, 1 - b2^t] fp32 and updates each record's p, m and v in place; family
// 0 adamw, 1 adam (also the fallback, with wd 0), 2 sgd, 3 adagrad, 4
// rmsprop; clip 0 turns the clip off.
extern "C" int gamer_fused_optimizer(const void* table, int n_rec, int n_chunks, void* partials,
                                     void* totals, const void* scalars, int family, float b1,
                                     float b2, float c1, float c2, float eps, float wd,
                                     float max_norm, int clip, int phase, void* stream) {
  if (table == nullptr || totals == nullptr || n_rec <= 0 || n_chunks <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* t = static_cast<const int64_t*>(table);
  if (phase == 0) {
    if (partials == nullptr) return cudaErrorInvalidValue;
    norm_partials_kernel<<<n_chunks, kThreads, 0, st>>>(t, n_rec, static_cast<double*>(partials));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    norm_total_kernel<<<1, kTotalThreads, 0, st>>>(static_cast<const double*>(partials), n_chunks,
                                                   static_cast<double*>(totals));
    return cudaGetLastError();
  }
  if (phase != 1 || scalars == nullptr) return cudaErrorInvalidValue;
  const Hyper h{b1, b2, c1, c2, eps, wd, max_norm, clip};
  const double* tot = static_cast<const double*>(totals);
  const float* sc = static_cast<const float*>(scalars);
  void (*kernel)(const int64_t*, int, const double*, const float*, Hyper);
  switch (family) {
    case kAdamW: kernel = update_kernel<kAdamW>; break;
    case kAdam: kernel = update_kernel<kAdam>; break;
    case kSgd: kernel = update_kernel<kSgd>; break;
    case kAdagrad: kernel = update_kernel<kAdagrad>; break;
    case kRmsprop: kernel = update_kernel<kRmsprop>; break;
    default: return cudaErrorInvalidValue;
  }
  kernel<<<n_chunks, kThreads, 0, st>>>(t, n_rec, tot, sc, h);
  return cudaGetLastError();
}
