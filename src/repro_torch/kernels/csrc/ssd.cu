// ssd: the Mamba2 SSD (state-space duality) chunked scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py:78 (ssd / _ssd_kernel,
// pallas_call at :97).
//
// What it computes, per (batch * head) row, with dt folded into x and log_a:
//   state_t = exp(la_t) * state_{t-1} + B_t (x) x_t ,   y_t = C_t . state_t
// seeded from initial_state (zeros when it is null); returns y and the
// final state (f32).  In chunked form, over a chunk of Q tokens with
// cum = inclusive cumsum of la inside the chunk and total = cum[Q-1]:
//   y     = (C B^T (.) exp(cum_i - cum_j) [j <= i]) X  +  exp(cum) (.) C state
//   state = exp(total) state + (exp(total - cum) (.) B)^T X
//
// Design.  On the TPU the chunk axis is a sequential grid axis with the
// carry in VMEM scratch; Hopper's blocks run in no order, so one block owns
// one (batch * head) row for the whole sequence and the chunk loop runs
// inside it, the (N x P) state resident in shared memory.  The Pallas body
// holds a 256 x 256 f32 score tile (256 KB, more than a block's 227 KB), so
// the kernel walks Q = 64-token inner chunks with the carry between them:
// the result does not depend on the chunk length except through f32
// rounding (ssd.py's own oracle is the per-step recurrence, ref.py:59).
// Every tile is zero-filled past S, N and P, so a ragged S needs no
// fallback: la = 0 and x = 0 past S give decay 1 and no input, exactly the
// padding of the reference's jnp path (ops.py:517-522).
//
// B and C: with n_groups < n_heads one B/C row serves r consecutive
// (batch * head) rows (mamba2-2.7b: r = 80 heads).  The block reads row
// bh / r in place, so the per-head copies of the reference
// (mamba2.py:120-125, 2 x 21 MB per layer at S = 1024) never exist.
//
// What bounds it on the H100: at mamba2-2.7b width (80 heads, P 64,
// N 128, S 1024) the reference's schedule does ~10.7 GFLOP against ~27 MB
// of operands, so the tensor-core bound is ~11 us (operations) and the
// byte bound ~8 us.  This first version computes in f32 on the CUDA cores
// (register micro-tiles over the shared-memory tiles: 4 x 4 for the
// scores and y, 8 x 4 for the state), one block of 256 threads per row:
// 80 blocks at batch 1 leave 52 of 132 SMs idle.  Tensor cores (mma/wgmma
// on the same tiles) and splitting a row over more blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int Q = 64;        // tokens per inner chunk
constexpr int NM = 128;      // largest d_state
constexpr int PM = 64;       // largest headdim
constexpr int NT = 256;      // threads per block
constexpr int CS = NM + 4;   // row stride (floats) of the B and C tiles
constexpr int XS = PM + 4;   // row stride of the X tile and of the state
constexpr int GS = Q + 4;    // row stride of the score tile
constexpr size_t SMEM_FLOATS = 2 * (size_t)Q * CS + (size_t)Q * XS +
                               (size_t)Q * GS + (size_t)NM * XS + 3 * Q;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Operands; strides in elements, the last axis of x / B / C / y is unit.
struct Args {
  const void* x;       // (BH, S, P)
  const float* la;     // (BH, S)
  const void* B;       // (BH / r, S, N)
  const void* C;       // (BH / r, S, N)
  const float* st0;    // (BH, N, P) contiguous, or null (zeros)
  void* y;             // (BH, S, P)
  float* st;           // (BH, N, P) contiguous: the final state
  long long sxb, sxs, slb, sls, sbb, sbs, scb, scs, syb, sys;
  int S, N, P, r;
};

template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* Cs = sm;               // [Q][CS]  C of the chunk
  float* Bs = Cs + Q * CS;      // [Q][CS]  B of the chunk
  float* Xs = Bs + Q * CS;      // [Q][XS]  x of the chunk
  float* Gs = Xs + Q * XS;      // [Q][GS]  masked, decayed C B^T
  float* St = Gs + Q * GS;      // [NM][XS] the carried state
  float* cum = St + NM * XS;    // [Q] inclusive cumsum of la
  float* ecum = cum + Q;        // [Q] exp(cum)
  float* wdec = ecum + Q;       // [Q] exp(total - cum)

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long grp = bh / a.r;
  const T* x = reinterpret_cast<const T*>(a.x) + bh * a.sxb;
  const float* la = a.la + bh * a.slb;
  const T* Bp = reinterpret_cast<const T*>(a.B) + grp * a.sbb;
  const T* Cp = reinterpret_cast<const T*>(a.C) + grp * a.scb;
  T* y = reinterpret_cast<T*>(a.y) + bh * a.syb;
  const int S = a.S, N = a.N, P = a.P;
  const int n4 = (N + 3) & ~3;  // k-loop bound; the padding holds zeros

  for (int e = tid; e < NM * PM; e += NT) {
    const int k = e / PM, p = e % PM;
    float v = 0.f;
    if (a.st0 != nullptr && k < N && p < P)
      v = a.st0[(bh * N + k) * P + p];
    St[k * XS + p] = v;
  }

  // thread micro-tiles: scores and y rows ti + 16 u; score columns
  // tj + 16 v; y / state columns 4 tj .. 4 tj + 3; state rows 8 ti .. + 7
  const int ti = tid / 16, tj = tid % 16;
  const int nchunks = (S + Q - 1) / Q;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();  // the previous chunk is done with every tile
    for (int e = tid; e < Q * NM; e += NT) {
      const int i = e / NM, k = e % NM, t = t0 + i;
      const bool ok = t < S && k < N;
      Bs[i * CS + k] = ok ? to_f(Bp[t * a.sbs + k]) : 0.f;
      Cs[i * CS + k] = ok ? to_f(Cp[t * a.scs + k]) : 0.f;
    }
    for (int e = tid; e < Q * PM; e += NT) {
      const int i = e / PM, p = e % PM, t = t0 + i;
      Xs[i * XS + p] = (t < S && p < P) ? to_f(x[t * a.sxs + p]) : 0.f;
    }
    if (tid < 32) {
      // inclusive scan of the chunk's log decays, two tokens per lane
      const int t = t0 + 2 * tid;
      const float l0 = t < S ? la[t * a.sls] : 0.f;
      const float l1 = t + 1 < S ? la[(t + 1) * a.sls] : 0.f;
      float s = l0 + l1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += v;
      }
      float ex = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) ex = 0.f;
      const float c0 = ex + l0, c1 = c0 + l1;
      const float total = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * tid] = c0;
      cum[2 * tid + 1] = c1;
      ecum[2 * tid] = expf(c0);
      ecum[2 * tid + 1] = expf(c1);
      wdec[2 * tid] = expf(total - c0);
      wdec[2 * tid + 1] = expf(total - c1);
    }
    __syncthreads();

    // scores: G[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0
    {
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
      for (int k = 0; k < n4; k += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = ld4(Cs + (ti + 16 * u) * CS + k);
#pragma unroll
        for (int v = 0; v < 4; ++v) bv[v] = ld4(Bs + (tj + 16 * v) * CS + k);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            acc[u][v] = fmaf(cv[u].x, bv[v].x, acc[u][v]);
            acc[u][v] = fmaf(cv[u].y, bv[v].y, acc[u][v]);
            acc[u][v] = fmaf(cv[u].z, bv[v].z, acc[u][v]);
            acc[u][v] = fmaf(cv[u].w, bv[v].w, acc[u][v]);
          }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = ti + 16 * u, j = tj + 16 * v;
          Gs[i * GS + j] = j <= i ? acc[u][v] * expf(cum[i] - cum[j]) : 0.f;
        }
    }
    __syncthreads();

    // y = G X + exp(cum) (.) (C state)
    {
      float yi[4][4], yc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) yi[u][w] = yc[u][w] = 0.f;
      for (int j = 0; j < Q; j += 4) {
        float4 gv[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) gv[u] = ld4(Gs + (ti + 16 * u) * GS + j);
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = ld4(Xs + (j + q) * XS + 4 * tj);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float g[4] = {gv[u].x, gv[u].y, gv[u].z, gv[u].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            yi[u][0] = fmaf(g[q], xv[q].x, yi[u][0]);
            yi[u][1] = fmaf(g[q], xv[q].y, yi[u][1]);
            yi[u][2] = fmaf(g[q], xv[q].z, yi[u][2]);
            yi[u][3] = fmaf(g[q], xv[q].w, yi[u][3]);
          }
        }
      }
      for (int k = 0; k < n4; k += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = ld4(Cs + (ti + 16 * u) * CS + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) sv[q] = ld4(St + (k + q) * XS + 4 * tj);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float cc[4] = {cv[u].x, cv[u].y, cv[u].z, cv[u].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            yc[u][0] = fmaf(cc[q], sv[q].x, yc[u][0]);
            yc[u][1] = fmaf(cc[q], sv[q].y, yc[u][1]);
            yc[u][2] = fmaf(cc[q], sv[q].z, yc[u][2]);
            yc[u][3] = fmaf(cc[q], sv[q].w, yc[u][3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = ti + 16 * u, t = t0 + i;
        if (t < S) {
          const float e = ecum[i];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int p = 4 * tj + w;
            if (p < P) y[t * a.sys + p] = from_f<T>(fmaf(e, yc[u][w], yi[u][w]));
          }
        }
      }
    }

    // state = exp(total) state + (exp(total - cum) (.) B)^T X
    {
      float acc[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float wj = wdec[j];
        const float4 b0 = ld4(Bs + j * CS + 8 * ti);
        const float4 b1 = ld4(Bs + j * CS + 8 * ti + 4);
        const float4 xv = ld4(Xs + j * XS + 4 * tj);
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float xw[4] = {xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj};
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(bb[u], xw[w], acc[u][w]);
      }
      const float dec = ecum[Q - 1];
      __syncthreads();  // every thread has read the old state (y above)
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float* s = St + (8 * ti + u) * XS + 4 * tj + w;
          *s = fmaf(dec, *s, acc[u][w]);
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * P; e += NT) {
    const int k = e / P, p = e % P;
    a.st[(bh * N + k) * P + p] = St[k * XS + p];
  }
}

template <typename T>
int ssd_run(const Args& a, int BH, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  ssd_kernel<T><<<BH, NT, SMEM_BYTES, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); la, st0 and st are f32.
// Requires N <= 128, P <= 64, BH % r == 0.  Returns cudaGetLastError()
// after the launch.
extern "C" int ssd_launch(int dtype, const void* x, const float* la,
                          const void* B, const void* C, const float* st0,
                          void* y, float* st, long long sxb, long long sxs,
                          long long slb, long long sls, long long sbb,
                          long long sbs, long long scb, long long scs,
                          long long syb, long long sys, int BH, int S, int N,
                          int P, int r, void* stream) {
  if (N < 1 || N > NM || P < 1 || P > PM || r < 1 || BH % r)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.la = la; a.B = B; a.C = C; a.st0 = st0; a.y = y; a.st = st;
  a.sxb = sxb; a.sxs = sxs; a.slb = slb; a.sls = sls;
  a.sbb = sbb; a.sbs = sbs; a.scb = scb; a.scs = scs;
  a.syb = syb; a.sys = sys;
  a.S = S; a.N = N; a.P = P; a.r = r;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return ssd_run<float>(a, BH, s);
  if (dtype == 1) return ssd_run<__nv_bfloat16>(a, BH, s);
  return (int)cudaErrorInvalidValue;
}
