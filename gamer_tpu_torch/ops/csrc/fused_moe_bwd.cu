// Fused position-routed SwiGLU MoE-FFN backward.
//
// Replaces the TPU kernel gamer_tpu/ops/pallas_moe.py `_bwd_kernel`
// (pallas_call in `_bwd_rule`). Per expert p, with gu = x Wgu + btab[beh],
// a = silu(g), h = a*u, h_drop = keep ? h/keep_frac : 0 and gout = dL/dy:
//     dh   = gout Wd^T,  dh_drop = keep ? dh/keep_frac : 0
//     dg   = dh_drop * u * silu'(g),  du = dh_drop * a,  dgu = [dg | du]
//     dx   = dgu Wgu^T
//     dWgu = x^T dgu,  dWd = h_drop^T gout,  dbtab[a] = sum of dgu over rows
//            whose behavior id is a (ids outside [0, NB) receive nothing)
// The TPU kernel sums dWgu, dWd and dbtab in VMEM across its sequential
// row-tile grid. CUDA blocks run in no order, so this library works in two
// passes with a fixed summation order (deterministic, no atomics):
//   pass 1  `moe_bwd_act_kernel`, one CTA per (64-row tile, expert, 32-column
//           chunk of F): recomputes gate/up for its columns, forms dh from
//           gout and Wd, and writes dgu [P, T, 2F] and h_drop [P, T, F] in
//           the operand dtype. At the flagship shape (P 5, T 6464, F 512)
//           that is 66 MB and 33 MB of bf16 written and read back, the
//           traffic the one-pass TPU kernel avoided; it buys a backward with
//           no cross-block reduction of the activations.
//   pass 2  hand-written blocked products (`gemm_kernel`, 64 x 64 output
//           tiles, fp32 sums): dx = dgu Wgu^T directly into dx; dWgu and dWd
//           split over T into fp32 partial sums so enough CTAs fill the 132
//           SMs, then `gamer::reduce_splits` adds the splits in order and casts to
//           the weights' dtype. `dbtab_kernel` sums dgu by behavior id the
//           same way.
// The dropout mask is the forward's hash of (seed, p, t, f), regenerated.
//
// Bound on H100: operations. 2*P*T*(3*D*2F + 2*F*Dout) multiply-adds (gate/up
// recompute, dx, dWgu; dh, dWd) against x, gout, the weights and the
// gradients moved once. This first version runs on the CUDA cores in fp32
// (FMA from shared memory); tensor cores are later work.

#include "common.cuh"

namespace {

using gamer::from_f;
using gamer::to_f;

constexpr int TM = 64;   // rows a CTA (pass 1)
constexpr int FC = 32;   // F columns a CTA (gate and up each)
constexpr int KT = 32;   // depth of a shared-memory slice
constexpr int NT = 256;  // threads: 16 row groups x 16 column lanes

template <typename T>
__global__ void __launch_bounds__(NT) moe_bwd_act_kernel(
    const T* __restrict__ x, const T* __restrict__ wgu, const T* __restrict__ wd,
    const T* __restrict__ btab, const int* __restrict__ beh, const T* __restrict__ gout,
    T* __restrict__ dgu, T* __restrict__ hdrop, int T_rows, int D, int F, int Dout, int NB,
    int use_bias, uint32_t seed, uint32_t thresh, float inv_keep) {
  __shared__ float As[TM][KT + 1];       // x or gout slice
  __shared__ float Ws[KT][2 * FC + 1];   // gate | up weight slice
  __shared__ float Wds[KT][FC + 1];      // Wd slice, transposed
  __shared__ int bid[TM];

  const int t0 = blockIdx.x * TM;
  const int p = blockIdx.y;
  const int f0 = blockIdx.z * FC;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t F2 = 2 * static_cast<size_t>(F);
  const T* xp = x + static_cast<size_t>(p) * T_rows * D;
  const T* gp = gout + static_cast<size_t>(p) * T_rows * Dout;
  const T* wgup = wgu + static_cast<size_t>(p) * D * F2;
  const T* wdp = wd + static_cast<size_t>(p) * F * Dout;
  const T* btp = btab + static_cast<size_t>(p) * NB * F2;

  for (int r = tid; r < TM; r += NT) {
    const int t = t0 + r;
    const int id = t < T_rows ? beh[static_cast<size_t>(p) * T_rows + t] : -1;
    bid[r] = (use_bias && id >= 0 && id < NB) ? id : -1;
  }

  // gate / up of this CTA's columns: thread columns f0 + tx + 16*jj
  float g[4][2], u[4][2], dh[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) g[i][jj] = u[i][jj] = dh[i][jj] = 0.f;

  for (int k0 = 0; k0 < D; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < TM * KT; idx += NT) {
      const int r = idx / KT, kk = idx % KT, t = t0 + r;
      As[r][kk] = (t < T_rows && k0 + kk < D) ? to_f(xp[static_cast<size_t>(t) * D + k0 + kk])
                                              : 0.f;
    }
    for (int idx = tid; idx < KT * 2 * FC; idx += NT) {
      const int kk = idx / (2 * FC), c = idx % (2 * FC);
      const int f = f0 + (c < FC ? c : c - FC);
      const size_t col = c < FC ? f : F + f;
      const bool in = (k0 + kk) < D && f < F;
      Ws[kk][c] = in ? to_f(wgup[static_cast<size_t>(k0 + kk) * F2 + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float xa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float wg = Ws[kk][tx + 16 * jj], wu = Ws[kk][FC + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[i][jj] = fmaf(xa[i], wg, g[i][jj]);
          u[i][jj] = fmaf(xa[i], wu, u[i][jj]);
        }
      }
    }
  }

  // dh = gout Wd^T for the same columns
  for (int k0 = 0; k0 < Dout; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < TM * KT; idx += NT) {
      const int r = idx / KT, kk = idx % KT, t = t0 + r;
      As[r][kk] = (t < T_rows && k0 + kk < Dout)
                      ? to_f(gp[static_cast<size_t>(t) * Dout + k0 + kk])
                      : 0.f;
    }
    for (int idx = tid; idx < FC * KT; idx += NT) {
      const int c = idx / KT, kk = idx % KT, f = f0 + c;
      Wds[kk][c] = (f < F && k0 + kk < Dout)
                       ? to_f(wdp[static_cast<size_t>(f) * Dout + k0 + kk])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float ga[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ga[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float w = Wds[kk][tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) dh[i][jj] = fmaf(ga[i], w, dh[i][jj]);
      }
    }
  }

  const bool drop = thresh > 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = t0 + r;
    if (t >= T_rows) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int f = f0 + tx + 16 * jj;
      if (f >= F) continue;
      float gv = g[i][jj], uv = u[i][jj];
      if (bid[r] >= 0) {
        gv += to_f(btp[bid[r] * F2 + f]);
        uv += to_f(btp[bid[r] * F2 + F + f]);
      }
      const float sig = 1.f / (1.f + expf(-gv));
      const float a = gv * sig;
      float hv = a * uv, dhv = dh[i][jj];
      if (drop) {
        const bool keep = gamer::hash_keep(seed, static_cast<uint32_t>(p),
                                           static_cast<uint32_t>(t), static_cast<uint32_t>(f),
                                           thresh);
        hv = keep ? hv * inv_keep : 0.f;
        dhv = keep ? dhv * inv_keep : 0.f;
      }
      const size_t row = static_cast<size_t>(p) * T_rows + t;
      dgu[row * F2 + f] = from_f<T>(dhv * uv * sig * (1.f + gv * (1.f - sig)));
      dgu[row * F2 + F + f] = from_f<T>(dhv * a);
      hdrop[row * F + f] = from_f<T>(hv);
    }
  }
}

// C[split][p] (M x N) = sum over k in the split's range of A(p, m, k) B(p, k, n),
// with element strides for A and B (either operand may be transposed).
struct GemmArgs {
  int M, N, K, P, kchunk;
  long long sa_p, sa_m, sa_k, sb_p, sb_k, sb_n;
};

template <typename T, typename OutT>
__global__ void __launch_bounds__(NT) gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                                                  OutT* __restrict__ C, GemmArgs g) {
  __shared__ float As[KT][64 + 1];
  __shared__ float Bs[KT][64 + 1];
  const int n0 = blockIdx.x * 64;
  const int m0 = blockIdx.y * 64;
  const int p = blockIdx.z % g.P;
  const int split = blockIdx.z / g.P;
  const int kb = split * g.kchunk;
  const int ke = min(g.K, kb + g.kchunk);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* Ap = A + p * g.sa_p;
  const T* Bp = B + p * g.sb_p;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < 64 * KT; idx += NT) {
      int mm, kk;
      if (g.sa_m == 1) {
        mm = idx % 64, kk = idx / 64;
      } else {
        kk = idx % KT, mm = idx / KT;
      }
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < g.M && k < ke) ? to_f(Ap[m * g.sa_m + k * g.sa_k]) : 0.f;
    }
    for (int idx = tid; idx < 64 * KT; idx += NT) {
      int nn, kk;
      if (g.sb_n == 1) {
        nn = idx % 64, kk = idx / 64;
      } else {
        kk = idx % KT, nn = idx / KT;
      }
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < g.N && k < ke) ? to_f(Bp[k * g.sb_k + n * g.sb_n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  OutT* Cp = C + (static_cast<size_t>(split) * g.P + p) * g.M * g.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < g.N) Cp[static_cast<size_t>(m) * g.N + n] = from_f<OutT>(acc[i][j]);
    }
  }
}

// ws[split][p][a][c] = sum of dgu[p][t][c] over the split's rows t with
// beh[p][t] == a; one thread a column, NB running sums in shared memory.
template <typename T>
__global__ void __launch_bounds__(NT) dbtab_kernel(const T* __restrict__ dgu,
                                                   const int* __restrict__ beh,
                                                   float* __restrict__ ws, int T_rows, int F2,
                                                   int NB, int P, int kchunk) {
  extern __shared__ float sums[];  // [NB][NT]
  const int c = blockIdx.x * NT + threadIdx.x;
  const int p = blockIdx.y;
  const int split = blockIdx.z;
  for (int a = 0; a < NB; ++a) sums[a * NT + threadIdx.x] = 0.f;
  const int tb = split * kchunk, te = min(T_rows, tb + kchunk);
  if (c < F2) {
    for (int t = tb; t < te; ++t) {
      const int a = beh[static_cast<size_t>(p) * T_rows + t];
      if (a >= 0 && a < NB)
        sums[a * NT + threadIdx.x] += to_f(dgu[(static_cast<size_t>(p) * T_rows + t) * F2 + c]);
    }
    for (int a = 0; a < NB; ++a)
      ws[((static_cast<size_t>(split) * P + p) * NB + a) * F2 + c] = sums[a * NT + threadIdx.x];
  }
}

template <typename T, typename OutT>
cudaError_t gemm(const T* A, const T* B, OutT* C, GemmArgs g, int nsplit, cudaStream_t s) {
  gemm_kernel<T, OutT><<<dim3((g.N + 63) / 64, (g.M + 63) / 64, g.P * nsplit), NT, 0, s>>>(
      A, B, C, g);
  return cudaGetLastError();
}

#define GAMER_TRY(...)                 \
  do {                                 \
    cudaError_t e_ = (__VA_ARGS__);    \
    if (e_ != cudaSuccess) return e_;  \
  } while (0)

template <typename T>
int run(const T* x, const T* wgu, const T* wd, const T* btab, const int* beh, const T* gout,
        T* dx, T* dwgu, T* dwd, T* dbtab, T* dgu, T* hdrop, float* ws, int P, int T_rows, int D,
        int F, int Dout, int NB, int use_bias, uint32_t seed, uint32_t thresh, float inv_keep,
        int n_gu, int kc_gu, int n_d, int kc_d, int n_b, int kc_b, cudaStream_t s) {
  const long long F2 = 2LL * F;
  moe_bwd_act_kernel<T><<<dim3((T_rows + TM - 1) / TM, P, (F + FC - 1) / FC), NT, 0, s>>>(
      x, wgu, wd, btab, beh, gout, dgu, hdrop, T_rows, D, F, Dout, NB, use_bias, seed, thresh,
      inv_keep);
  GAMER_TRY(cudaGetLastError());
  // dx [T, D] = dgu [T, 2F] . Wgu[p]^T  (Wgu[p] is [D, 2F])
  GAMER_TRY(gemm<T, T>(dgu, wgu, dx,
                       GemmArgs{T_rows, D, static_cast<int>(F2), P, static_cast<int>(F2),
                                T_rows * F2, F2, 1, D * F2, 1, F2},
                       1, s));
  // dWgu [D, 2F] = x^T . dgu, split over T
  GAMER_TRY(gemm<T, float>(x, dgu, ws,
                           GemmArgs{D, static_cast<int>(F2), T_rows, P, kc_gu,
                                    static_cast<long long>(T_rows) * D, 1, D, T_rows * F2, F2, 1},
                           n_gu, s));
  GAMER_TRY(gamer::reduce_splits<T>(ws, dwgu, static_cast<size_t>(P) * D * F2, n_gu, s));
  // dWd [F, Dout] = h_drop^T . gout, split over T
  GAMER_TRY(gemm<T, float>(hdrop, gout, ws,
                           GemmArgs{F, Dout, T_rows, P, kc_d, static_cast<long long>(T_rows) * F,
                                    1, F, static_cast<long long>(T_rows) * Dout, Dout, 1},
                           n_d, s));
  GAMER_TRY(gamer::reduce_splits<T>(ws, dwd, static_cast<size_t>(P) * F * Dout, n_d, s));
  if (use_bias) {
    const size_t smem = sizeof(float) * NB * NT;
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    dbtab_kernel<T><<<dim3((static_cast<int>(F2) + NT - 1) / NT, P, n_b), NT, smem, s>>>(
        dgu, beh, ws, T_rows, static_cast<int>(F2), NB, P, kc_b);
    GAMER_TRY(cudaGetLastError());
    GAMER_TRY(gamer::reduce_splits<T>(ws, dbtab, static_cast<size_t>(P) * NB * F2, n_b, s));
  }
  return cudaSuccess;
}

}  // namespace

// All tensors contiguous in dtype (gamer::DType) except beh (int32 [P, T])
// and ws (fp32 scratch of at least max(n_gu*P*D*2F, n_d*P*F*Dout,
// n_b*P*NB*2F) floats). dgu [P, T, 2F] and hdrop [P, T, F] are scratch too.
// n_* / kc_* are the number of splits over T and the rows a split covers
// (a multiple of 32 for the products) of dWgu, dWd and dbtab. With
// use_bias = 0, dbtab is not written.
extern "C" int gamer_fused_moe_bwd(const void* x, const void* wgu, const void* wd,
                                   const void* btab, const int* beh, const void* gout, void* dx,
                                   void* dwgu, void* dwd, void* dbtab, void* dgu, void* hdrop,
                                   float* ws, int P, int T_rows, int D, int F, int Dout, int NB,
                                   int use_bias, unsigned int seed, unsigned int thresh,
                                   float inv_keep, int n_gu, int kc_gu, int n_d, int kc_d,
                                   int n_b, int kc_b, int dtype, void* stream) {
  if (P <= 0 || T_rows <= 0 || D <= 0 || F <= 0 || Dout <= 0 || NB <= 0 || n_gu <= 0 ||
      n_d <= 0 || n_b <= 0 || kc_gu % KT || kc_d % KT)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GAMER_RUN(TYPE)                                                                     \
  run<TYPE>(static_cast<const TYPE*>(x), static_cast<const TYPE*>(wgu),                    \
            static_cast<const TYPE*>(wd), static_cast<const TYPE*>(btab), beh,             \
            static_cast<const TYPE*>(gout), static_cast<TYPE*>(dx), static_cast<TYPE*>(dwgu), \
            static_cast<TYPE*>(dwd), static_cast<TYPE*>(dbtab), static_cast<TYPE*>(dgu),   \
            static_cast<TYPE*>(hdrop), ws, P, T_rows, D, F, Dout, NB, use_bias, seed, thresh, \
            inv_keep, n_gu, kc_gu, n_d, kc_d, n_b, kc_b, s)
  if (dtype == gamer::kFloat32) return GAMER_RUN(float);
  if (dtype == gamer::kBFloat16) return GAMER_RUN(__nv_bfloat16);
#undef GAMER_RUN
  return cudaErrorInvalidValue;
}
