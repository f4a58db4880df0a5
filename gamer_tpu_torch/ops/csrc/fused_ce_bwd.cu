// Fused tied-head cross-entropy backward.
//
// Replaces the TPU kernel gamer_tpu/ops/pallas_ce.py `_ce_bwd_kernel`
// (pallas_call in `_ce_bwd_rule`). With the forward's lse (fused_ce_fwd.cu)
// and the incoming gradient g [N] of the per-row nll:
//     p    = exp(logit * inv_t - lse)                 logit = h . E[v]
//     dlog = (p - onehot(target)) * g * inv_t         valid rows, else 0
//     dh   = dlog E          dE = dlog^T h            (fp32 sums)
// The TPU kernel sums dE across its sequential row-tile grid. Here:
//   `ce_dh_kernel`, one CTA per 64-row tile, walks the vocabulary in 64-row
//     chunks of E held in shared memory, recomputes that chunk's logits and
//     accumulates dh in registers;
//   `ce_de_kernel`, one CTA per (64-row vocab tile, chunk of rows), holds its
//     E tile, walks its rows in 64-row tiles recomputing the logits, and
//     writes fp32 partial sums of dE; `gamer::reduce_splits` adds the row chunks in
//     order and casts to the table's dtype. V 1041 gives only 17 vocab
//     tiles, so the rows are split to fill the 132 SMs.
// Neither the [N, V] logits nor dlog reach device memory; the price is that
// both kernels recompute the logits (four N x V x D products where the
// function needs three). Columns >= V are masked, so V needs no padding;
// deterministic (no atomics).
//
// Bound on H100: operations, 3 * 2*N*V*D multiply-adds of the function
// against h, E, dh and dE moved once. This first version runs on the CUDA
// cores in fp32 (FMA from shared memory); tensor cores are later work.

#include "common.cuh"

namespace {

using gamer::from_f;
using gamer::to_f;

constexpr int TM = 64;      // rows a tile
constexpr int VC = 64;      // vocab rows a tile
constexpr int NT = 256;     // threads: 16 row groups x 16 column lanes
constexpr int DMAX = 256;   // widest D (dh / dE columns a thread: DMAX / 16)
constexpr int DJ = DMAX / 16;

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

template <typename T>
__device__ void load_rows(const Smem& m, const T* h, const int* targets, const int* valid,
                          const float* lse, const float* g, int n0, int N, int D, float inv_t) {
  for (int idx = threadIdx.x; idx < TM * D; idx += NT) {
    const int r = idx / D, c = idx % D, n = n0 + r;
    m.Hs[r * (D + 1) + c] = n < N ? to_f(h[static_cast<size_t>(n) * D + c]) : 0.f;
  }
  for (int r = threadIdx.x; r < TM; r += NT) {
    const int n = n0 + r;
    const bool in = n < N;
    m.tgt[r] = in ? targets[n] : -1;
    m.lse_s[r] = in ? lse[n] : 0.f;
    m.gv_s[r] = (in && valid[n] == 1) ? g[n] * inv_t : 0.f;
  }
}

template <typename T>
__device__ void load_vocab(const Smem& m, const T* table, int v0, int V, int D) {
  for (int idx = threadIdx.x; idx < VC * D; idx += NT) {
    const int r = idx / D, c = idx % D, v = v0 + r;
    m.Es[r * (D + 1) + c] = v < V ? to_f(table[static_cast<size_t>(v) * D + c]) : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(NT) ce_dh_kernel(
    const T* __restrict__ h, const T* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, const float* __restrict__ lse, const float* __restrict__ g,
    T* __restrict__ dh, int N, int D, int V, float inv_t) {
  extern __shared__ float smem[];
  const Smem m(smem, D);
  const int n0 = blockIdx.x * TM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T>(m, h, targets, valid, lse, g, n0, N, D, inv_t);
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int v0 = 0; v0 < V; v0 += VC) {
    __syncthreads();
    load_vocab<T>(m, table, v0, V, D);
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
      if (d < D) dh[static_cast<size_t>(n) * D + d] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) ce_de_kernel(
    const T* __restrict__ h, const T* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, const float* __restrict__ lse, const float* __restrict__ g,
    float* __restrict__ ws, int N, int D, int V, float inv_t, int tiles_per_split) {
  extern __shared__ float smem[];
  const Smem m(smem, D);
  const int v0 = blockIdx.x * VC;
  const int split = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_vocab<T>(m, table, v0, V, D);
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int nb = split * tiles_per_split * TM;
  const int ne = min(N, nb + tiles_per_split * TM);
  for (int n0 = nb; n0 < ne; n0 += TM) {
    __syncthreads();
    load_rows<T>(m, h, targets, valid, lse, g, n0, N, D, inv_t);
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

template <typename T>
int run(const void* h, const void* table, const int* targets, const int* valid, const float* lse,
        const float* g, void* dh, void* de, float* ws, int N, int D, int V, float inv_t,
        int nsplit, int tiles_per_split, cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(ce_dh_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_de_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const T* ht = static_cast<const T*>(h);
  const T* et = static_cast<const T*>(table);
  ce_dh_kernel<T><<<(N + TM - 1) / TM, NT, smem, s>>>(ht, et, targets, valid, lse, g,
                                                      static_cast<T*>(dh), N, D, V, inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_de_kernel<T><<<dim3((V + VC - 1) / VC, nsplit), NT, smem, s>>>(
      ht, et, targets, valid, lse, g, ws, N, D, V, inv_t, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gamer::reduce_splits<T>(ws, static_cast<T*>(de), static_cast<size_t>(V) * D, nsplit, s);
}

}  // namespace

// h [N, D] and table [V, D] in dtype (gamer::DType); targets/valid int32 [N];
// lse and g fp32 [N]; dh [N, D] and de [V, D] in dtype; ws fp32 scratch of
// nsplit * V * D floats, rows split into nsplit chunks of tiles_per_split
// 64-row tiles. D <= 256.
extern "C" int gamer_fused_ce_bwd(const void* h, const void* table, const int* targets,
                                  const int* valid, const float* lse, const float* g, void* dh,
                                  void* de, float* ws, int N, int D, int V, float inv_t,
                                  int nsplit, int tiles_per_split, int dtype, void* stream) {
  if (N <= 0 || D <= 0 || V <= 0 || D > DMAX || nsplit <= 0 || tiles_per_split <= 0 ||
      static_cast<long long>(nsplit) * tiles_per_split * TM < N)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gamer::kFloat32)
    return run<float>(h, table, targets, valid, lse, g, dh, de, ws, N, D, V, inv_t, nsplit,
                      tiles_per_split, s);
  if (dtype == gamer::kBFloat16)
    return run<__nv_bfloat16>(h, table, targets, valid, lse, g, dh, de, ws, N, D, V, inv_t,
                              nsplit, tiles_per_split, s);
  return cudaErrorInvalidValue;
}
