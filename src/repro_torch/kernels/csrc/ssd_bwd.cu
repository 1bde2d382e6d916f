// ssd_bwd: the backward of the Mamba2 SSD chunked scan (dx, d log_a, dB, dC).
//
// Replaces no Pallas kernel: the reference's training path differentiates
// its jnp scan, jax.vjp of _chunked_ssd_ref (src/repro/kernels/ops.py:511),
// which XLA lowers; this is that VJP written by hand.
//
// Notation of the forward (csrc/ssd.cu): per (batch * head) row and Q-token
// chunk, cum = inclusive cumsum of la in the chunk, total = cum[Q-1], S0 the
// state entering the chunk, S1 the state leaving it, dS = dL/dS1 and dy the
// incoming gradient.  With L_ij = exp(cum_i - cum_j) [j <= i]:
//   G = (C B^T) (.) L,   W = (dy x^T) (.) L,   M = W (.) C B^T
//   dx_j  = sum_i G_ij dy_i           + exp(total - cum_j) B_j dS
//   dC_i  = sum_j W_ij B_j            + exp(cum_i) S0 dy_i
//   dB_j  = sum_i W_ij C_i            + exp(total - cum_j) dS x_j
//   dcum_k = rowsum_k M - colsum_k M + C_k . (exp(cum_k) S0 dy_k)
//                                    - B_k . (exp(total - cum_k) dS x_k)
//   dcum_{Q-1} += dtotal = exp(total) <dS, S0> + sum_j B_j . (exp(total -
//                          cum_j) dS x_j)
//   d la_t = sum_{k >= t} dcum_k (within the chunk)
//   dS_prev = exp(total) dS + sum_i exp(cum_i) C_i dy_i^T
// Tiles are zero past S, N and P (la = 0, x = dy = 0, B = C = 0 there), so a
// ragged S needs nothing else: the reference pads the same way and slices.
// The final state's gradient is zero (the caller refuses any other).
//
// Three kernels, no atomics, every sum in a fixed order (two runs give the
// same bits), all arithmetic in f32 on the CUDA cores (bf16 operands are
// widened as they are loaded, results rounded once):
//   1. ssd_bwd_states: a block per (row, 16 headdim columns) walks the
//      chunks forward and writes each chunk's S0, then backward and writes
//      each chunk's dS.  The states are not kept by the forward (under
//      remat it is run again anyway): at mamba2-2.7b's training shape (160
//      rows, S 2048, N 128, P 64) the two scratch arrays are 2 x 168 MB,
//      written once and read once.
//   2. ssd_bwd_chunk: a block per (chunk, B/C row, slice of that row's
//      heads).  With n_groups < n_heads r heads read one B/C row
//      (mamba2-2.7b: r = 80); the block forms C B^T once for its slice and
//      sums dB and dC over the slice's heads in registers, in head order.
//      dx and d la are per row, written directly.
//   3. ssd_bwd_reduce: dB and dC, the slices' f32 partials summed in slice
//      order (at mamba2-2.7b's shape 5 slices of 16 heads, 2 x 10.5 MB of
//      partials where per-head ones would be 2 x 168 MB).
// What bounds it on the H100 (PERF.md counts it): at mamba2-2.7b's shape the
// operands and results are ~130 MB and the products ~37 GFLOP of f32; the
// scratch adds ~0.7 GB of traffic and the CUDA cores' 67 TFLOP/s make the
// operations, not the bytes, the floor of this design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;        // tokens per chunk (the forward kernel's)
constexpr int NM = 128;      // largest d_state
constexpr int PM = 64;       // largest headdim
constexpr int NT = 256;      // threads per block
constexpr int PB = 16;       // headdim columns of a states block
constexpr int CS = NM + 4;   // row stride (floats) of the B and C tiles
constexpr int XS = PM + 4;   // row stride of the x / dy tiles and the states
constexpr int GS = Q + 4;    // row stride of the Q x Q tiles
constexpr size_t CHUNK_FLOATS = 2 * (size_t)Q * CS + 2 * (size_t)Q * XS +
                                2 * (size_t)NM * XS + 3 * (size_t)Q * GS +
                                5 * Q + NT / 32;
constexpr size_t CHUNK_SMEM = CHUNK_FLOATS * 4;

struct Args {
  const void* x;       // (BH, S, P)
  const float* la;     // (BH, S)
  const void* B;       // (BH / r, S, N)
  const void* C;       // (BH / r, S, N)
  const void* dy;      // (BH, S, P)
  const float* st0;    // (BH, N, P) contiguous, or null (zeros)
  void* dx;            // (BH, S, P) contiguous
  float* dla;          // (BH, S) contiguous
  void* dB;            // (BH / r, S, N) contiguous
  void* dC;            // (BH / r, S, N) contiguous
  float* st;           // (BH, nch, N, P): S0 of each chunk
  float* dst;          // (BH, nch, N, P): dS of each chunk
  float* pB;           // (slices, BH / r, S, N): partial dB
  float* pC;           // (slices, BH / r, S, N): partial dC
  long long sxb, sxs, slb, sls, sbb, sbs, scb, scs, sgb, sgs;
  int S, N, P, r, nb, hs, slices;
};

__device__ __forceinline__ float wide(float v) { return v; }
__device__ __forceinline__ float wide(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Warp-wide: cum, exp(cum) and exp(total - cum) of the chunk at t0, two
// tokens a lane (la = 0 past S), as the forward computes them.
__device__ __forceinline__ void scan_chunk(const float* la, long long sls,
                                           int t0, int S, int lane,
                                           float* cum, float* ecum,
                                           float* wdec) {
  const int t = t0 + 2 * lane;
  const float l0 = t < S ? la[t * sls] : 0.f;
  const float l1 = t + 1 < S ? la[(t + 1) * sls] : 0.f;
  float s = l0 + l1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += v;
  }
  float ex = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) ex = 0.f;
  const float c0 = ex + l0, c1 = c0 + l1;
  const float total = __shfl_sync(0xffffffffu, c1, 31);
  cum[2 * lane] = c0;
  cum[2 * lane + 1] = c1;
  ecum[2 * lane] = expf(c0);
  ecum[2 * lane + 1] = expf(c1);
  wdec[2 * lane] = expf(total - c0);
  wdec[2 * lane + 1] = expf(total - c1);
}

// -- 1. the chunk-boundary states --------------------------------------------
// Thread (nr, pl) holds state rows n = nr + 16 k (k < 8) of column pb * 16 +
// pl.  Forward: S0 of chunk c is written, then S = exp(total) S + (wdec (.)
// B)^T x.  Backward: dS of chunk c is written, then dS = exp(total) dS +
// (ecum (.) C)^T dy.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_states(Args a) {
  __shared__ float Ts[Q][NM];         // B (forward) or C (backward)
  __shared__ float Vs[Q][PB];         // x (forward) or dy (backward)
  __shared__ float cum[Q], ecum[Q], wdec[Q];
  const int tid = threadIdx.x, lane = tid & 31;
  const int pl = tid & 15, nr = tid >> 4;
  const int pb = blockIdx.x;
  const long long bh = blockIdx.y;
  const long long grp = bh / a.r;
  const int S = a.S, N = a.N, P = a.P;
  const int p = pb * PB + pl;
  const int nch = (S + Q - 1) / Q;
  const float* la = a.la + bh * a.slb;
  const long long slab = (long long)N * P;

  auto load = [&](const T* tp, long long sts, const T* vp, long long svs,
                  int t0) {
    for (int e = tid; e < Q * NM; e += NT) {
      const int i = e / NM, k = e % NM, t = t0 + i;
      Ts[i][k] = (t < S && k < N) ? wide(tp[t * sts + k]) : 0.f;
    }
    for (int e = tid; e < Q * PB; e += NT) {
      const int i = e / PB, q = e % PB, t = t0 + i, pp = pb * PB + q;
      Vs[i][q] = (t < S && pp < P) ? wide(vp[t * svs + pp]) : 0.f;
    }
    if (tid < 32) scan_chunk(la, a.sls, t0, S, lane, cum, ecum, wdec);
  };

  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int n = nr + 16 * k;
    s[k] = (a.st0 != nullptr && n < N && p < P)
               ? a.st0[(bh * N + n) * P + p] : 0.f;
  }
  const T* x = reinterpret_cast<const T*>(a.x) + bh * a.sxb;
  const T* Bp = reinterpret_cast<const T*>(a.B) + grp * a.sbb;
  for (int c = 0; c < nch; ++c) {
    __syncthreads();   // the previous chunk is done with the tiles
    load(Bp, a.sbs, x, a.sxs, c * Q);
    __syncthreads();
    float* out = a.st + (bh * nch + c) * slab;
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = nr + 16 * k;
      if (n < N && p < P) out[n * P + p] = s[k];
      acc[k] = 0.f;
    }
    for (int j = 0; j < Q; ++j) {
      const float xw = Vs[j][pl] * wdec[j];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = fmaf(Ts[j][nr + 16 * k], xw, acc[k]);
    }
    const float dec = ecum[Q - 1];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = fmaf(dec, s[k], acc[k]);
  }

  const T* dy = reinterpret_cast<const T*>(a.dy) + bh * a.sgb;
  const T* Cp = reinterpret_cast<const T*>(a.C) + grp * a.scb;
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0.f;   // dS of the last chunk
  for (int c = nch - 1; c >= 0; --c) {
    __syncthreads();
    load(Cp, a.scs, dy, a.sgs, c * Q);
    __syncthreads();
    float* out = a.dst + (bh * nch + c) * slab;
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = nr + 16 * k;
      if (n < N && p < P) out[n * P + p] = s[k];
      acc[k] = 0.f;
    }
    for (int i = 0; i < Q; ++i) {
      const float gw = Vs[i][pl] * ecum[i];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = fmaf(Ts[i][nr + 16 * k], gw, acc[k]);
    }
    const float dec = ecum[Q - 1];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = fmaf(dec, s[k], acc[k]);
  }
}

// -- 2. one chunk of one B/C row's slice of heads ----------------------------
// Thread (ti, tj) = (tid / 16, tid % 16).  Q x Q tiles: rows ti + 16 u,
// columns tj + 16 v.  Q x P results (dx): rows ti + 16 u, columns 4 tj ..
// 4 tj + 3.  Q x N results (dB, dC): rows ti + 16 u, columns tj + 16 w (the
// 16 threads of a row read 16 different state rows: no bank conflicts).
template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_chunk(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* Bs = sm;                 // [Q][CS]  B of the chunk
  float* Cs = Bs + Q * CS;        // [Q][CS]  C of the chunk
  float* Xs = Cs + Q * CS;        // [Q][XS]  x of the head
  float* Ys = Xs + Q * XS;        // [Q][XS]  dy of the head
  float* Ss = Ys + Q * XS;        // [NM][XS] S0
  float* Ds = Ss + NM * XS;       // [NM][XS] dS
  float* CB = Ds + NM * XS;       // [Q][GS]  C B^T, unmasked
  float* Gs = CB + Q * GS;        // [Q][GS]  G
  float* Ws = Gs + Q * GS;        // [Q][GS]  W
  float* cum = Ws + Q * GS;       // [Q]
  float* ecum = cum + Q;          // [Q] exp(cum)
  float* wdec = ecum + Q;         // [Q] exp(total - cum)
  float* dcc = wdec + Q;          // [Q] C_k . dC's carry term
  float* dcb = dcc + Q;           // [Q] B_k . dB's carry term
  float* red = dcb + Q;           // [NT / 32] <dS, S0> by warp

  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int ti = tid >> 4, tj = tid & 15;
  const int c = blockIdx.x, g = blockIdx.y, sl = blockIdx.z;
  const int S = a.S, N = a.N, P = a.P;
  const int t0 = c * Q;
  const int nch = (S + Q - 1) / Q;
  const int n4 = (N + 3) & ~3, p4 = (P + 3) & ~3;
  const int nw = (N + 15) / 16;   // column groups w with live columns
  const int h0 = sl * a.hs;
  const int h1 = min(a.r, h0 + a.hs);
  const long long slab = (long long)N * P;

  {
    const T* Bp = reinterpret_cast<const T*>(a.B) + g * a.sbb;
    const T* Cp = reinterpret_cast<const T*>(a.C) + g * a.scb;
    for (int e = tid; e < Q * NM; e += NT) {
      const int i = e / NM, k = e % NM, t = t0 + i;
      const bool ok = t < S && k < N;
      Bs[i * CS + k] = ok ? wide(Bp[t * a.sbs + k]) : 0.f;
      Cs[i * CS + k] = ok ? wide(Cp[t * a.scs + k]) : 0.f;
    }
  }
  __syncthreads();
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
      for (int v = 0; v < 4; ++v)
        CB[(ti + 16 * u) * GS + tj + 16 * v] = acc[u][v];
  }

  float aB[4][8], aC[4][8];   // the slice's dB and dC, summed in head order
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < 8; ++w) aB[u][w] = aC[u][w] = 0.f;

  for (int h = h0; h < h1; ++h) {
    const long long bh = (long long)g * a.r + h;
    __syncthreads();   // CB is written; the previous head is done
    {
      const T* x = reinterpret_cast<const T*>(a.x) + bh * a.sxb;
      const T* dy = reinterpret_cast<const T*>(a.dy) + bh * a.sgb;
      for (int e = tid; e < Q * PM; e += NT) {
        const int i = e / PM, q = e % PM, t = t0 + i;
        const bool ok = t < S && q < P;
        Xs[i * XS + q] = ok ? wide(x[t * a.sxs + q]) : 0.f;
        Ys[i * XS + q] = ok ? wide(dy[t * a.sgs + q]) : 0.f;
      }
      // rows past N up to 16 nw are read as zeros; rows past that never
      const float* s0 = a.st + (bh * nch + c) * slab;
      const float* d0 = a.dst + (bh * nch + c) * slab;
      for (int e = tid; e < 16 * nw * PM; e += NT) {
        const int n = e / PM, q = e % PM;
        const bool ok = n < N && q < P;
        Ss[n * XS + q] = ok ? s0[n * P + q] : 0.f;
        Ds[n * XS + q] = ok ? d0[n * P + q] : 0.f;
      }
      if (wi == 0)
        scan_chunk(a.la + bh * a.slb, a.sls, t0, S, lane, cum, ecum, wdec);
    }
    __syncthreads();

    // W = (dy x^T) (.) L and G = (C B^T) (.) L
    {
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
      for (int q = 0; q < p4; q += 4) {
        float4 yv[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) yv[u] = ld4(Ys + (ti + 16 * u) * XS + q);
#pragma unroll
        for (int v = 0; v < 4; ++v) xv[v] = ld4(Xs + (tj + 16 * v) * XS + q);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            acc[u][v] = fmaf(yv[u].x, xv[v].x, acc[u][v]);
            acc[u][v] = fmaf(yv[u].y, xv[v].y, acc[u][v]);
            acc[u][v] = fmaf(yv[u].z, xv[v].z, acc[u][v]);
            acc[u][v] = fmaf(yv[u].w, xv[v].w, acc[u][v]);
          }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = ti + 16 * u, j = tj + 16 * v;
          const float l = j <= i ? expf(cum[i] - cum[j]) : 0.f;
          Ws[i * GS + j] = acc[u][v] * l;
          Gs[i * GS + j] = CB[i * GS + j] * l;
        }
    }
    float sdot = 0.f;   // this thread's share of <dS, S0>
    for (int e = tid; e < 16 * nw * PM; e += NT) {
      const int n = e / PM, q = e % PM;
      sdot = fmaf(Ds[n * XS + q], Ss[n * XS + q], sdot);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sdot += __shfl_xor_sync(0xffffffffu, sdot, o);
    if (lane == 0) red[wi] = sdot;
    __syncthreads();

    // dx_j = sum_i G_ij dy_i + wdec_j B_j dS
    {
      float in[4][4], cr[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) in[u][e] = cr[u][e] = 0.f;
      for (int i = 0; i < Q; ++i) {
        const float4 yv = ld4(Ys + i * XS + 4 * tj);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float gv = Gs[i * GS + ti + 16 * u];
          in[u][0] = fmaf(gv, yv.x, in[u][0]);
          in[u][1] = fmaf(gv, yv.y, in[u][1]);
          in[u][2] = fmaf(gv, yv.z, in[u][2]);
          in[u][3] = fmaf(gv, yv.w, in[u][3]);
        }
      }
      for (int k = 0; k < n4; k += 4) {
        float4 bv[4], dv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) bv[u] = ld4(Bs + (ti + 16 * u) * CS + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) dv[q] = ld4(Ds + (k + q) * XS + 4 * tj);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float b[4] = {bv[u].x, bv[u].y, bv[u].z, bv[u].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cr[u][0] = fmaf(b[q], dv[q].x, cr[u][0]);
            cr[u][1] = fmaf(b[q], dv[q].y, cr[u][1]);
            cr[u][2] = fmaf(b[q], dv[q].z, cr[u][2]);
            cr[u][3] = fmaf(b[q], dv[q].w, cr[u][3]);
          }
        }
      }
      T* dx = reinterpret_cast<T*>(a.dx) + bh * (long long)S * P;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = ti + 16 * u, t = t0 + j;
        if (t >= S) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 4 * tj + e;
          if (q < P)
            dx[(long long)t * P + q] = narrow<T>(fmaf(wdec[j], cr[u][e],
                                                      in[u][e]));
        }
      }
    }

    // dC_i = sum_j W_ij B_j + ecum_i S0 dy_i; the carry term's C_i . also
    {
      float cr[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 8; ++w) cr[u][w] = 0.f;
      for (int q = 0; q < p4; q += 4) {
        float4 yv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) yv[u] = ld4(Ys + (ti + 16 * u) * XS + q);
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          if (w >= nw) break;
          const float4 sv = ld4(Ss + (tj + 16 * w) * XS + q);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            cr[u][w] = fmaf(yv[u].x, sv.x, cr[u][w]);
            cr[u][w] = fmaf(yv[u].y, sv.y, cr[u][w]);
            cr[u][w] = fmaf(yv[u].z, sv.z, cr[u][w]);
            cr[u][w] = fmaf(yv[u].w, sv.w, cr[u][w]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = ti + 16 * u;
        float dot = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          cr[u][w] *= ecum[i];
          dot = fmaf(Cs[i * CS + tj + 16 * w], cr[u][w], dot);
          aC[u][w] += cr[u][w];
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (tj == 0) dcc[i] = dot;
      }
      for (int j = 0; j < Q; j += 4) {
        float4 wv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) wv[u] = ld4(Ws + (ti + 16 * u) * GS + j);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int w = 0; w < 8; ++w) {
            if (w >= nw) break;
            const float b = Bs[(j + q) * CS + tj + 16 * w];
            aC[0][w] = fmaf((&wv[0].x)[q], b, aC[0][w]);
            aC[1][w] = fmaf((&wv[1].x)[q], b, aC[1][w]);
            aC[2][w] = fmaf((&wv[2].x)[q], b, aC[2][w]);
            aC[3][w] = fmaf((&wv[3].x)[q], b, aC[3][w]);
          }
        }
      }
    }

    // dB_j = sum_i W_ij C_i + wdec_j dS x_j; the carry term's B_j . also
    {
      float cr[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 8; ++w) cr[u][w] = 0.f;
      for (int q = 0; q < p4; q += 4) {
        float4 xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) xv[u] = ld4(Xs + (ti + 16 * u) * XS + q);
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          if (w >= nw) break;
          const float4 dv = ld4(Ds + (tj + 16 * w) * XS + q);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            cr[u][w] = fmaf(xv[u].x, dv.x, cr[u][w]);
            cr[u][w] = fmaf(xv[u].y, dv.y, cr[u][w]);
            cr[u][w] = fmaf(xv[u].z, dv.z, cr[u][w]);
            cr[u][w] = fmaf(xv[u].w, dv.w, cr[u][w]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = ti + 16 * u;
        float dot = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          cr[u][w] *= wdec[j];
          dot = fmaf(Bs[j * CS + tj + 16 * w], cr[u][w], dot);
          aB[u][w] += cr[u][w];
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (tj == 0) dcb[j] = dot;
      }
      for (int i = 0; i < Q; ++i) {
        float wv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) wv[u] = Ws[i * GS + ti + 16 * u];
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          if (w >= nw) break;
          const float cv = Cs[i * CS + tj + 16 * w];
#pragma unroll
          for (int u = 0; u < 4; ++u) aB[u][w] = fmaf(wv[u], cv, aB[u][w]);
        }
      }
    }
    __syncthreads();   // dcc, dcb and red are written

    // d la: warp 0, tokens k = 2 lane, 2 lane + 1
    if (wi == 0) {
      float d[2], sb = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * lane + e;
        float rs = 0.f, cs = 0.f;
        for (int j = 0; j < Q; ++j) {
          rs = fmaf(Ws[k * GS + j], CB[k * GS + j], rs);
          cs = fmaf(Ws[j * GS + k], CB[j * GS + k], cs);
        }
        d[e] = rs - cs + dcc[k] - dcb[k];
        sb += dcb[k];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sb += __shfl_xor_sync(0xffffffffu, sb, o);
      float sd = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) sd += red[w];
      if (lane == 31) d[1] += ecum[Q - 1] * sd + sb;   // dtotal at k = Q - 1
      // suffix sums over the chunk: d la_t = sum_{k >= t} dcum_k
      float s = d[0] + d[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, s, o);
        if (lane + o < 32) s += v;
      }
      float* dla = a.dla + bh * S;
      const int t = t0 + 2 * lane;
      if (t < S) dla[t] = s;
      if (t + 1 < S) dla[t + 1] = s - d[0];
    }
  }

  const long long plane = (long long)a.nb * S * N;
  float* pB = a.pB + sl * plane + ((long long)g * S) * N;
  float* pC = a.pC + sl * plane + ((long long)g * S) * N;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = t0 + ti + 16 * u;
    if (t >= S) continue;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const int n = tj + 16 * w;
      if (n < N) {
        pB[(long long)t * N + n] = aB[u][w];
        pC[(long long)t * N + n] = aC[u][w];
      }
    }
  }
}

// -- 3. dB and dC: the slices' partials in slice order -----------------------
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_reduce(Args a) {
  const long long plane = (long long)a.nb * a.S * a.N;
  T* dB = reinterpret_cast<T*>(a.dB);
  T* dC = reinterpret_cast<T*>(a.dC);
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < plane;
       e += (long long)gridDim.x * NT) {
    float sb = 0.f, sc = 0.f;
    for (int s = 0; s < a.slices; ++s) {
      sb += a.pB[s * plane + e];
      sc += a.pC[s * plane + e];
    }
    dB[e] = narrow<T>(sb);
    dC[e] = narrow<T>(sc);
  }
}

template <typename T>
int run(const Args& a, int BH, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)CHUNK_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nch = (a.S + Q - 1) / Q;
  ssd_bwd_states<T><<<dim3((a.P + PB - 1) / PB, BH), NT, 0, st>>>(a);
  ssd_bwd_chunk<T><<<dim3(nch, a.nb, a.slices), NT, CHUNK_SMEM, st>>>(a);
  const long long plane = (long long)a.nb * a.S * a.N;
  long long blocks = (plane + NT - 1) / NT;
  if (blocks > 4096) blocks = 4096;
  ssd_bwd_reduce<T><<<(int)blocks, NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C, dy and dx, dB, dC); la, st0, dla
// and the scratch are f32.  dx, dla, dB, dC contiguous; st / dst (BH, nch,
// N, P), pB / pC (slices, BH / r, S, N) f32 scratch.  hs heads a slice,
// slices = ceil(r / hs).  Requires S >= 1, N <= 128, P <= 64, BH % r == 0,
// BH <= 65535, BH / r <= 65535.  Returns cudaGetLastError() after the
// launches.
extern "C" int ssd_bwd_launch(
    int dtype, const void* x, const float* la, const void* B, const void* C,
    const void* dy, const float* st0, void* dx, float* dla, void* dB,
    void* dC, float* st, float* dst, float* pB, float* pC, long long sxb,
    long long sxs, long long slb, long long sls, long long sbb, long long sbs,
    long long scb, long long scs, long long sgb, long long sgs, int BH, int S,
    int N, int P, int r, int hs, int slices, void* stream) {
  if (S < 1 || N < 1 || N > NM || P < 1 || P > PM || r < 1 || BH % r ||
      BH > 65535 || hs < 1 || slices < 1 || slices > 65535 ||
      (long long)(slices - 1) * hs >= r || (long long)slices * hs < r)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.la = la; a.B = B; a.C = C; a.dy = dy; a.st0 = st0;
  a.dx = dx; a.dla = dla; a.dB = dB; a.dC = dC;
  a.st = st; a.dst = dst; a.pB = pB; a.pC = pC;
  a.sxb = sxb; a.sxs = sxs; a.slb = slb; a.sls = sls;
  a.sbb = sbb; a.sbs = sbs; a.scb = scb; a.scs = scs;
  a.sgb = sgb; a.sgs = sgs;
  a.S = S; a.N = N; a.P = P; a.r = r; a.nb = BH / r; a.hs = hs;
  a.slices = slices;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(a, BH, s);
  if (dtype == 1) return run<__nv_bfloat16>(a, BH, s);
  return (int)cudaErrorInvalidValue;
}
