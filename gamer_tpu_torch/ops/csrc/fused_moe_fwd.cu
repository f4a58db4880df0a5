// Fused position-routed SwiGLU MoE-FFN forward.
//
// Replaces the TPU kernel gamer_tpu/ops/pallas_moe.py `_fwd_kernel`. Per
// (row tile, expert p):
//     gu = x @ Wgu[p] + btab[p, beh]     (gate | up, one product, f32)
//     h  = silu(gu[:, :F]) * gu[:, F:]
//     h  = keep ? h / keep_frac : 0      (training: hash dropout)
//     y  = h @ Wd[p]
// The [T, 2F] gate/up activations never reach global memory: the kernel walks
// F in chunks of 32, computes that chunk's gate and up columns for its 64
// rows, forms h in shared memory, and accumulates its share of y in
// registers, all in fp32. The dropout mask is the stateless hash of
// (seed, expert p, absolute row t, column f) (common.cuh `hash_keep`), as
// pallas_moe.py:80-82 keys it; T has no row padding here, so the coordinates
// of real rows are the JAX kernel's.
//
// Layout: x [P, T, D], wgu [P, D, 2F], wd [P, F, Dout], btab [P, NB, 2F],
// beh [P, T] int32 (bias row id; ids outside [0, NB) add nothing, as in the
// JAX kernel's per-id select), out [P, T, Dout]. One CTA per (64-row tile,
// expert, 256-column tile of Dout).
//
// Bound on H100: operations. 2*P*T*(D*2F + F*Dout) multiply-adds for
// P*T*(D + Dout) activations and the weights moved once; at the flagship
// shape that is hundreds of operations per byte. This first version uses the
// CUDA cores (fp32 FMA from shared memory); tensor cores (wgmma) come later.

#include "common.cuh"

namespace {

using gamer::from_f;
using gamer::to_f;

constexpr int TM = 64;   // rows a CTA
constexpr int FC = 32;   // F columns a chunk (gate and up each)
constexpr int KT = 32;   // depth of a gate/up weight slice
constexpr int DT = 256;  // output columns a CTA
constexpr int NT = 256;  // threads: 16 row groups x 16 column lanes

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(TM) * (D + 1) + KT * (2 * FC + 1) +
                          TM * (FC + 1) + FC * DT) +
         sizeof(int) * TM;
}

template <typename T>
__global__ void __launch_bounds__(NT) moe_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ wgu, const T* __restrict__ wd,
    const T* __restrict__ btab, const int* __restrict__ beh, T* __restrict__ out, int T_rows,
    int D, int F, int Dout, int NB, int use_bias, uint32_t seed, uint32_t thresh,
    float inv_keep) {
  extern __shared__ float smem[];
  float* Xs = smem;                                  // [TM][D+1]
  float* Ws = Xs + TM * (D + 1);                     // [KT][2*FC+1]
  float* Hs = Ws + KT * (2 * FC + 1);                // [TM][FC+1]
  float* Wds = Hs + TM * (FC + 1);                   // [FC][DT]
  int* bid = reinterpret_cast<int*>(Wds + FC * DT);  // [TM]

  const int t0 = blockIdx.x * TM;
  const int p = blockIdx.y;
  const int c0 = blockIdx.z * DT;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t F2 = 2 * static_cast<size_t>(F);
  const T* xp = x + static_cast<size_t>(p) * T_rows * D;
  const T* wgup = wgu + static_cast<size_t>(p) * D * F2;
  const T* wdp = wd + static_cast<size_t>(p) * F * Dout;
  const T* btp = btab + static_cast<size_t>(p) * NB * F2;

  for (int idx = tid; idx < TM * D; idx += NT) {
    const int r = idx / D, c = idx % D, t = t0 + r;
    Xs[r * (D + 1) + c] = t < T_rows ? to_f(xp[static_cast<size_t>(t) * D + c]) : 0.f;
  }
  for (int r = tid; r < TM; r += NT) {
    const int t = t0 + r;
    const int id = t < T_rows ? beh[static_cast<size_t>(p) * T_rows + t] : -1;
    bid[r] = (use_bias && id >= 0 && id < NB) ? id : -1;
  }

  float y[4][DT / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DT / 16; ++j) y[i][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += FC) {
    // gate columns f0 + tx + 16*jj sit at tile columns tx + 16*jj, the matching
    // up columns at FC + tx + 16*jj: each thread holds both halves of its h
    float g[4][2], u[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) g[i][jj] = u[i][jj] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KT) {
      __syncthreads();  // Ws (and, on the first slice, Hs/Wds) reads are done
      for (int idx = tid; idx < KT * 2 * FC; idx += NT) {
        const int kk = idx / (2 * FC), c = idx % (2 * FC);
        const int f = f0 + (c < FC ? c : c - FC);
        const size_t col = c < FC ? f : F + f;
        const bool in = (k0 + kk) < D && f < F;
        Ws[kk * (2 * FC + 1) + c] = in ? to_f(wgup[static_cast<size_t>(k0 + kk) * F2 + col]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(KT, D - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float xa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[i] = Xs[(ty + 16 * i) * (D + 1) + k0 + kk];
        const float* wrow = Ws + kk * (2 * FC + 1);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float wg = wrow[tx + 16 * jj], wu = wrow[FC + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            g[i][jj] = fmaf(xa[i], wg, g[i][jj]);
            u[i][jj] = fmaf(xa[i], wu, u[i][jj]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int f = f0 + tx + 16 * jj;
        float gv = g[i][jj], uv = u[i][jj];
        if (bid[r] >= 0 && f < F) {
          gv += to_f(btp[bid[r] * F2 + f]);
          uv += to_f(btp[bid[r] * F2 + F + f]);
        }
        const float silu = gv / (1.f + expf(-gv));
        float hv = f < F ? silu * uv : 0.f;
        if (thresh > 0u)
          hv = gamer::hash_keep(seed, static_cast<uint32_t>(p), static_cast<uint32_t>(t0 + r),
                                static_cast<uint32_t>(f), thresh)
                   ? hv * inv_keep
                   : 0.f;
        Hs[r * (FC + 1) + tx + 16 * jj] = hv;
      }
    }
    for (int idx = tid; idx < FC * DT; idx += NT) {
      const int ff = idx / DT, c = idx % DT;
      const bool in = (f0 + ff) < F && (c0 + c) < Dout;
      Wds[ff * DT + c] = in ? to_f(wdp[static_cast<size_t>(f0 + ff) * Dout + c0 + c]) : 0.f;
    }
    __syncthreads();

    for (int ff = 0; ff < FC; ++ff) {
      float ha[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ha[i] = Hs[(ty + 16 * i) * (FC + 1) + ff];
#pragma unroll
      for (int j = 0; j < DT / 16; ++j) {
        const float w = Wds[ff * DT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i][j] = fmaf(ha[i], w, y[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= T_rows) continue;
    T* orow = out + (static_cast<size_t>(p) * T_rows + t) * Dout;
#pragma unroll
    for (int j = 0; j < DT / 16; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < Dout) orow[c] = from_f<T>(y[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wgu, const void* wd, const void* btab, const int* beh,
           void* out, int P, int T_rows, int D, int F, int Dout, int NB, int use_bias,
           uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(moe_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((T_rows + TM - 1) / TM, P, (Dout + DT - 1) / DT);
  moe_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wgu), static_cast<const T*>(wd),
      static_cast<const T*>(btab), beh, static_cast<T*>(out), T_rows, D, F, Dout, NB, use_bias,
      seed, thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// dtype: gamer::DType shared by x, wgu, wd, btab and out. The x tile lives in
// shared memory, which bounds D (D <= 512 fits). thresh = 0 turns dropout
// off; inv_keep = 1 / keep fraction.
extern "C" int gamer_fused_moe_fwd(const void* x, const void* wgu, const void* wd,
                                   const void* btab, const int* beh, void* out, int P,
                                   int T_rows, int D, int F, int Dout, int NB, int use_bias,
                                   unsigned int seed, unsigned int thresh, float inv_keep,
                                   int dtype, void* stream) {
  if (P <= 0 || T_rows <= 0 || D <= 0 || F <= 0 || Dout <= 0 || NB <= 0 || D > 512)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gamer::kFloat32)
    return launch<float>(x, wgu, wd, btab, beh, out, P, T_rows, D, F, Dout, NB, use_bias, seed,
                         thresh, inv_keep, st);
  if (dtype == gamer::kBFloat16)
    return launch<__nv_bfloat16>(x, wgu, wd, btab, beh, out, P, T_rows, D, F, Dout, NB,
                                 use_bias, seed, thresh, inv_keep, st);
  return cudaErrorInvalidValue;
}
