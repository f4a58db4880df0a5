// Fused tied-head cross-entropy forward.
//
// Replaces the TPU kernel gamer_tpu/ops/pallas_ce.py `_ce_fwd_kernel`. Per
// 64-row tile of the final hidden states h [N, D] and the tied embedding
// table E [V, D]:
//     logits = (h @ E^T) * inv_t      fp32, never stored
//     lse    = logsumexp(logits)      online over 64-column vocab chunks
//     tl     = logits[target]         by a column compare, not a gather
//     nll    = valid ? lse - tl : 0
// Outputs nll [N] and lse [N], both fp32; targets/valid are int32 [N].
// Columns >= V (the ragged last chunk) are masked out of the softmax; a
// target outside [0, V) matches no column (tl = 0).
//
// Bound on H100: operations. 2*N*V*D multiply-adds against N*D + V*D inputs;
// at the flagship shape (N 32,256, V 1041, D 256) hundreds of operations per
// byte. E (533 KB in bf16) is read by every CTA and stays in the 50 MB L2.
//
// Dispatch by dtype, in the C entry point before any launch:
//  - bf16: `ce_fwd_tc_kernel`, on the tensor cores. One CTA per 64 rows, 4
//    warps of 16 rows; the warp's h rows are loaded once into A fragments
//    (registers) and the vocabulary is walked in 64-row chunks of E,
//    double-buffered in shared memory by 16-byte cp.async (the next chunk in
//    flight while this one is multiplied). logits = h.E^T by mma.sync
//    m16n8k16 (mma.cuh) with fp32 accumulators; the online max and sum per
//    row in base 2 (inv_t folded with log2 e), the max reduced over the four
//    lanes that share a row each chunk, the sums once at the end. D is
//    padded to DP (64, 128 or 256) with zero columns in shared memory.
//  - bf16 with D > 256: `ce_fwd_wide_kernel`, the same online softmax with
//    each chunk's logits streamed over D in 64-deep slices of h and E
//    (stream_tc.cuh), since neither the h tile nor an E chunk fits whole:
//    h is read again for every vocab chunk (from L2).
//  - fp32: `ce_fwd_kernel`, fp32 FMA on the CUDA cores from shared memory
//    (4x4 logits a thread), so fp32 callers get full fp32. Up to D 512 the
//    h tile stays in shared memory; wider, it is streamed with each 32-deep
//    table slice.
//
// Where this goes wrong, and what the bf16 kernel does about it:
//  - fragment coordinates: an accumulator element of column tile j is row
//    warp*16 + lane/4 (+8 for e >= 2) and column 8j + 2*(lane%4) + e%2 of
//    the chunk; the target compare and the column mask read them, so the
//    tests put targets in every chunk and in the ragged last one (V - 1);
//  - ragged edges: cp.async zero-fills rows past N and past V, so no stale
//    value enters a product; columns >= V are -inf before the max, and
//    every chunk holds at least one column < V, so the running max stays
//    finite.

#include "common.cuh"
#include "mma.cuh"
#include "stream_tc.cuh"

namespace {

using namespace gamer::tc;

constexpr int TM = 64;      // rows a CTA
constexpr int VC = 64;      // vocab columns a chunk
constexpr int KT = 32;      // depth of a table slice (fp32 kernel)
constexpr int NT = 256;     // fp32 kernel threads: 16 row groups x 16 column lanes
constexpr int TC_NT = 128;  // bf16 kernel threads: 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// HRES: the h tile [TM][D+1] stays in shared memory (D <= 512), else a
// [TM][KT+1] slice of it is loaded with each table slice
template <bool HRES>
size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(TM) * ((HRES ? D : KT) + 1) + KT * (VC + 1)) +
         sizeof(int) * TM;
}

template <bool HRES>
__global__ void __launch_bounds__(NT) ce_fwd_kernel(
    const float* __restrict__ h, const float* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, float* __restrict__ nll, float* __restrict__ lse_out,
    int N, int D, int V, float inv_t) {
  extern __shared__ float smem[];
  const int LH = (HRES ? D : KT) + 1;
  float* Hs = smem;                                 // [TM][LH]
  float* Es = Hs + TM * LH;                         // [KT][VC+1], transposed slice
  int* tgt = reinterpret_cast<int*>(Es + KT * (VC + 1));  // [TM]

  const int n0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  if (HRES)
    for (int idx = tid; idx < TM * D; idx += NT) {
      const int r = idx / D, c = idx % D, n = n0 + r;
      Hs[r * LH + c] = n < N ? h[static_cast<size_t>(n) * D + c] : 0.f;
    }
  for (int r = tid; r < TM; r += NT) {  // a target outside [0, V) matches no column
    const int t = n0 + r < N ? targets[n0 + r] : -1;
    tgt[r] = (t >= 0 && t < V) ? t : -1;
  }

  float m[4], s[4], tl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
    tl[i] = 0.f;
  }

  for (int v0 = 0; v0 < V; v0 += VC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KT) {
      __syncthreads();  // previous slice's Es reads are done
      for (int idx = tid; idx < VC * KT; idx += NT) {
        const int c = idx / KT, kk = idx % KT;
        const bool in = (v0 + c) < V && (k0 + kk) < D;
        Es[kk * (VC + 1) + c] = in ? table[static_cast<size_t>(v0 + c) * D + k0 + kk] : 0.f;
      }
      if (!HRES)
        for (int idx = tid; idx < TM * KT; idx += NT) {
          const int r = idx / KT, kk = idx % KT, n = n0 + r;
          Hs[r * LH + kk] = (n < N && k0 + kk < D) ? h[static_cast<size_t>(n) * D + k0 + kk] : 0.f;
        }
      __syncthreads();
      const int kmax = min(KT, D - k0);
      const int hk = HRES ? k0 : 0;
      for (int kk = 0; kk < kmax; ++kk) {
        float ha[4], eb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ha[i] = Hs[(ty + 16 * i) * LH + hk + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) eb[j] = Es[kk * (VC + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ha[i], eb[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx + 16 * j;
        acc[i][j] = col < V ? acc[i][j] * inv_t : -INFINITY;
        cmax = fmaxf(cmax, acc[i][j]);
        if (col == tgt[r]) tl[i] = acc[i][j];
      }
      cmax = gamer::half_warp_max(cmax);
      // every chunk holds at least one column < V, so m_new is finite
      const float m_new = fmaxf(m[i], cmax);
      float csum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) csum += expf(acc[i][j] - m_new);
      csum = gamer::half_warp_sum(csum);
      s[i] = s[i] * expf(m[i] - m_new) + csum;
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = gamer::half_warp_sum(tl[i]);  // one lane holds the target
    const int n = n0 + ty + 16 * i;
    if (tx == 0 && n < N) {
      const float l = m[i] + logf(s[i]);
      lse_out[n] = l;
      nll[n] = valid[n] == 1 ? l - t : 0.f;
    }
  }
}

// ---- bf16 on the tensor cores

template <int DP>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (TM + 2 * VC) * (DP + 8);  // h tile, 2 stages of E chunks
}

// One 64-column chunk of a warp's logits s (16 rows x 64 columns, mma.cuh C
// layout, unscaled) into the online softmax of its rows: the target logit by
// a column compare, scores in base 2, columns >= V at -inf.
__device__ __forceinline__ void online_chunk(float (&s)[8][4], int v0, int V, const int (&tgt)[2],
                                             float inv_t, float sl2, float (&m)[2], float (&l)[2],
                                             float (&tl)[2], int lane) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = v0 + 8 * j + 2 * (lane % 4) + (e & 1);
      if (c == tgt[e >> 1]) tl[e >> 1] = s[j][e] * inv_t;
      s[j][e] = c < V ? s[j][e] * sl2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // every chunk holds at least one column < V, so m_new is finite
    const float m_new = fmaxf(m[i], mx[i]);
    l[i] *= exp2f(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[j][e] - m[e >> 1]);
}

// The row sums over the four lanes of a row, then lse and nll of the rows.
__device__ __forceinline__ void finish_rows(const int (&row)[2], int N, const int* valid,
                                            const float (&m)[2], float (&l)[2], float (&tl)[2],
                                            float* nll, float* lse_out, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    tl[i] += __shfl_xor_sync(0xffffffffu, tl[i], 1);
    tl[i] += __shfl_xor_sync(0xffffffffu, tl[i], 2);
    if (lane % 4 == 0 && row[i] < N) {
      const float lse = (m[i] + log2f(l[i])) * LN2;
      lse_out[row[i]] = lse;
      nll[row[i]] = valid[row[i]] == 1 ? lse - tl[i] : 0.f;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_NT, 2) ce_fwd_tc_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, float* __restrict__ nll, float* __restrict__ lse_out, int N,
    int D, int V, float inv_t) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;  // k16 steps of a product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Hs = reinterpret_cast<bf16*>(smem_raw);  // [TM][LD]
  bf16* Es = Hs + TM * LD;                       // stage s: [VC][LD]

  const int n0 = blockIdx.x * TM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = (V + VC - 1) / VC;
  const float sl2 = inv_t * LOG2E;

  // this thread's two rows, n0 + warp*16 + lane/4 and + 8, and their targets
  int row[2], tgt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = n0 + warp * 16 + lane / 4 + 8 * i;
    const int t = row[i] < N ? targets[row[i]] : -1;
    tgt[i] = (t >= 0 && t < V) ? t : -1;
  }

  load_tile_async<TM, DP, TC_NT>(Hs, h, D, n0, N, D);
  load_tile_async<VC, DP, TC_NT>(Es, table, D, 0, V, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ha[KS][4];  // the warp's 16 rows of h as A fragments, for every chunk
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(ha[kk], a_addr(Hs, LD, warp * 16, kk * 16, lane));

  float m[2] = {-INFINITY, -INFINITY};  // running max of logit * log2 e
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum
  float tl[2] = {0.f, 0.f};             // the target logit, in the lane that holds it

  for (int t = 0; t < nv; ++t) {
    if (t + 1 < nv)
      load_tile_async<VC, DP, TC_NT>(Es + ((t + 1) & 1) * VC * LD, table, D, (t + 1) * VC, V,
                                     D);
    cp_async_commit();   // possibly empty: keeps one group per chunk
    cp_async_wait<1>();  // chunk t has landed
    __syncthreads();
    const bf16* Et = Es + (t & 1) * VC * LD;
    const int v0 = t * VC;

    // logits: 16 rows x 64 vocab columns a warp, E stored [n][k]
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t eb[4];
        ldsm_x4(eb, bn_addr(Et, LD, np * 16, kk * 16, lane));
        mma_bf16(s[2 * np], ha[kk], eb[0], eb[1]);
        mma_bf16(s[2 * np + 1], ha[kk], eb[2], eb[3]);
      }

    online_chunk(s, v0, V, tgt, inv_t, sl2, m, l, tl, lane);
    __syncthreads();  // stage t & 1 is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();
  finish_rows(row, N, valid, m, l, tl, nll, lse_out, lane);
}

// ---- bf16 with D > 256: the streamed route

__global__ void __launch_bounds__(TC_NT, 2) ce_fwd_wide_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ table, const int* __restrict__ targets,
    const int* __restrict__ valid, float* __restrict__ nll, float* __restrict__ lse_out, int N,
    int D, int V, float inv_t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // the stream's two stages
  const int n0 = blockIdx.x * TM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = (V + VC - 1) / VC;
  const float sl2 = inv_t * LOG2E;
  int row[2], tgt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = n0 + warp * 16 + lane / 4 + 8 * i;
    const int t = row[i] < N ? targets[row[i]] : -1;
    tgt[i] = (t >= 0 && t < V) ? t : -1;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, tl[2] = {0.f, 0.f};
  for (int t = 0; t < nv; ++t) {
    const int v0 = t * VC;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    stream_mma<8, false, TC_NT>(s, buf, h + static_cast<size_t>(n0) * D, D, N - n0,
                                table + static_cast<size_t>(v0) * D, nullptr, D, V - v0, D, warp,
                                lane);
    online_chunk(s, v0, V, tgt, inv_t, sl2, m, l, tl, lane);
  }
  finish_rows(row, N, valid, m, l, tl, nll, lse_out, lane);
}

template <bool HRES>
int launch_f32(const void* h, const void* table, const int* targets, const int* valid, float* nll,
               float* lse, int N, int D, int V, float inv_t, cudaStream_t stream) {
  const size_t smem = smem_bytes<HRES>(D);
  cudaError_t err = cudaFuncSetAttribute(ce_fwd_kernel<HRES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ce_fwd_kernel<HRES><<<(N + TM - 1) / TM, NT, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(table), targets, valid, nll, lse, N,
      D, V, inv_t);
  return cudaGetLastError();
}

template <int DP>
int launch_bf16(const void* h, const void* table, const int* targets, const int* valid,
                float* nll, float* lse, int N, int D, int V, float inv_t, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(ce_fwd_tc_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ce_fwd_tc_kernel<DP><<<(N + TM - 1) / TM, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(table), targets, valid, nll, lse, N,
      D, V, inv_t);
  return cudaGetLastError();
}

int launch_wide(const void* h, const void* table, const int* targets, const int* valid,
                float* nll, float* lse, int N, int D, int V, float inv_t, cudaStream_t stream) {
  constexpr size_t smem = StreamTiles<8, false>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(ce_fwd_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ce_fwd_wide_kernel<<<(N + TM - 1) / TM, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(table), targets, valid, nll, lse, N,
      D, V, inv_t);
  return cudaGetLastError();
}

}  // namespace

// dtype: gamer::DType of h and table (bf16 -> tensor-core kernels, fp32 ->
// CUDA-core kernel). Any D in fp32 (the h tile in shared memory up to D 512,
// streamed beyond). bf16: D a multiple of 16 (the wrapper pads), h and table
// 16-byte aligned (16-byte copies); D up to 256 keeps h in registers, wider
// D streams both operands.
extern "C" int gamer_fused_ce_fwd(const void* h, const void* table, const int* targets,
                                  const int* valid, float* nll, float* lse, int N, int D, int V,
                                  float inv_t, int dtype, void* stream) {
  if (N <= 0 || D <= 0 || V <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gamer::kFloat32) {
    if (D <= 512) return launch_f32<true>(h, table, targets, valid, nll, lse, N, D, V, inv_t, st);
    return launch_f32<false>(h, table, targets, valid, nll, lse, N, D, V, inv_t, st);
  }
  if (dtype == gamer::kBFloat16) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(table);
    if (D % 16 != 0 || addr % 16 != 0) return cudaErrorInvalidValue;
    if (D <= 64) return launch_bf16<64>(h, table, targets, valid, nll, lse, N, D, V, inv_t, st);
    if (D <= 128) return launch_bf16<128>(h, table, targets, valid, nll, lse, N, D, V, inv_t, st);
    if (D <= 256) return launch_bf16<256>(h, table, targets, valid, nll, lse, N, D, V, inv_t, st);
    return launch_wide(h, table, targets, valid, nll, lse, N, D, V, inv_t, st);
  }
  return cudaErrorInvalidValue;
}
