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
// Three kernels a call, no atomics, every sum in a fixed order (two runs
// give the same bits), each result rounded once from an f32 sum:
//   1. the chunk-boundary states: S0 of each chunk (a walk forward from
//      initial_state) and dS of each chunk (a walk backward from zero), into
//      scratch written once and read once: at mamba2-2.7b's training shape
//      (160 rows, S 2048, N 128, P 64) 2 x 168 MB.  The forward does not
//      keep them (under remat it runs again anyway).
//   2. the chunk kernel: a block per (chunk, B/C row, slice of that row's
//      heads).  With n_groups < n_heads r heads read one B/C row
//      (mamba2-2.7b: r = 80); the block forms C B^T once for its slice and
//      sums dB and dC over the slice's heads in registers, in head order.
//      dx and d la are per row, written directly.
//   3. ssd_bwd_reduce: dB and dC, the slices' f32 partials summed in slice
//      order (at mamba2-2.7b's shape 5 slices of 16 heads, 2 x 10.5 MB of
//      partials where per-head ones would be 2 x 168 MB).
//
// What bounds it on the H100, as PERF.md counts it: at mamba2-2.7b's
// training shape the operands and results are 132.64 MB read or written
// once (39.6 us at 3.35 TB/s) and the work's products 35.057 GFLOP (35 us
// of bf16 tensor-core time), so bytes.  This design adds the scratch: 2 x
// 168 MB written once and read once, ~0.8 GB of traffic in all (~0.25 ms),
// and feeds most products two terms (~65-70 GFLOP of tensor-core work).
//
// bfloat16 (ssd_bwd_tc_states, ssd_bwd_tc_chunk), on the tensor cores:
// mma.sync m16n8k16, bf16 operands into f32 accumulators, chosen over wgmma
// for the reason the forward gives (csrc/ssd.cu): the tiles are small (64
// x 64 x 128 a chunk) and most A operands are formed in registers (masked
// and decayed f32 tiles, accumulators turned operands), not read from
// swizzled shared memory.  Operands come from shared memory by ldmatrix,
// rows padded by 16 bytes (no bank conflicts), loaded by cp.async with zero
// fill.
//   * The two-term split.  bf16 x bf16 products are exact in f32: C B^T and
//     dy x^T (and x dy^T) take one term.  Every product with an f32 operand
//     takes two: hi = bf16(v), lo = bf16(v - hi) (~2^-17 relative), one MMA
//     a term into the same accumulator: G^T dy; W B and W^T C; B dS, x dS^T
//     and dy S0^T (the states as written); the walks' (wdec (.) x) and (ecum
//     (.) dy).  The masks, L, the row scalings by wdec / ecum and d log_a's
//     sums stay in f32 registers.  tests/test_torch_ssd_bwd_numerics.py
//     emulates this schedule on the CPU against the plain backward under
//     the card's limit (one ulp of the output + 1e-4 of its rms): two terms
//     read 0.989-0.993 of it (the one-ulp flips of the rounded outputs set
//     that), one term 44-83x over.
//   * The state walk (ssd_bwd_tc_states): a block per (row, direction), 320
//     at mamba2-2.7b's shape, two an SM.  Its 8 warps hold the whole N x P
//     state in accumulators, laid out as the forward's; the chunk's B and x
//     (or C and dy) come through a 3-stage cp.async ring, loads two chunks
//     ahead, so the walk's only dependence is the state itself.  Each
//     chunk's S0 (or dS) is written once from the accumulators as the two
//     bf16 terms the chunk kernel feeds the tensor cores: a hi and a lo
//     plane of [p16][n16] (P and N rounded up to 16), the bytes of an f32
//     state.  The carried state stays f32.
//   * The chunk kernel (ssd_bwd_tc_chunk): one block an SM (208 KB of shared
//     memory).  Warp (w, hf) owns rows 16 w .. 16 w + 15 of the Q x Q
//     products, upper triangle tiles skipped: hf 0 forms W and sums dC,
//     hf 1 forms W^T and sums dB (the accumulators become A operands in
//     registers), each over every d_state column; headdim columns 32 hf ..
//     of dx.  x, dy and dS have two buffers and S0
//     one: the next head's x, dy and dS load while the current head
//     computes, its S0 once the current head's dC carry has read S0.  d
//     log_a's row and column sums come from the W fragments on all warps;
//     warp 0 adds the terms in a fixed order.
//
// float32 (ssd_bwd_states, ssd_bwd_chunk), on the CUDA cores (f32 on the
// tensor cores would be TF32, another function): the states a block per
// (row, 16 headdim columns) into f32 scratch [N][P], the chunk kernel's
// products as fmaf chains.
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
  float* st;           // S0 of each chunk: (BH, nch, N, P) f32, or in bf16
                       // (BH, nch, 2, p16, n16): hi and lo planes
  float* dst;          // dS of each chunk, the same
  float* pB;           // (slices, BH / r, S, N): partial dB
  float* pC;           // (slices, BH / r, S, N): partial dC
  long long sxb, sxs, slb, sls, sbb, sbs, scb, scs, sgb, sgs;
  int S, N, P, r, nb, hs, slices;
};

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

// warp-wide: cum, exp(cum) and exp(total - cum) of a chunk from its log
// decays l0, l1 (tokens 2 lane, 2 lane + 1), as the forward computes them;
// returns exp(total)
__device__ __forceinline__ float scan(float l0, float l1, int lane,
                                      float* cum, float* ecum, float* wdec) {
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
  if (cum != nullptr) {
    cum[2 * lane] = c0;
    cum[2 * lane + 1] = c1;
  }
  if (ecum != nullptr) {
    ecum[2 * lane] = expf(c0);
    ecum[2 * lane + 1] = expf(c1);
  }
  if (wdec != nullptr) {
    wdec[2 * lane] = expf(total - c0);
    wdec[2 * lane + 1] = expf(total - c1);
  }
  return expf(total);
}

// Warp-wide: the scan of the chunk at t0 from la (0 past S), two tokens a
// lane
__device__ __forceinline__ void scan_chunk(const float* la, long long sls,
                                           int t0, int S, int lane,
                                           float* cum, float* ecum,
                                           float* wdec) {
  const int t = t0 + 2 * lane;
  scan(t < S ? la[t * sls] : 0.f, t + 1 < S ? la[(t + 1) * sls] : 0.f, lane,
       cum, ecum, wdec);
}

// -- 1. the chunk-boundary states --------------------------------------------
// Thread (nr, pl) holds state rows n = nr + 16 k (k < 8) of column pb * 16 +
// pl.  Forward: S0 of chunk c is written, then S = exp(total) S + (wdec (.)
// B)^T x.  Backward: dS of chunk c is written, then dS = exp(total) dS +
// (ecum (.) C)^T dy.
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

  auto load = [&](const float* tp, long long sts, const float* vp,
                  long long svs, int t0) {
    for (int e = tid; e < Q * NM; e += NT) {
      const int i = e / NM, k = e % NM, t = t0 + i;
      Ts[i][k] = (t < S && k < N) ? tp[t * sts + k] : 0.f;
    }
    for (int e = tid; e < Q * PB; e += NT) {
      const int i = e / PB, q = e % PB, t = t0 + i, pp = pb * PB + q;
      Vs[i][q] = (t < S && pp < P) ? vp[t * svs + pp] : 0.f;
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
  const float* x = reinterpret_cast<const float*>(a.x) + bh * a.sxb;
  const float* Bp = reinterpret_cast<const float*>(a.B) + grp * a.sbb;
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

  const float* dy = reinterpret_cast<const float*>(a.dy) + bh * a.sgb;
  const float* Cp = reinterpret_cast<const float*>(a.C) + grp * a.scb;
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
    const float* Bp = reinterpret_cast<const float*>(a.B) + g * a.sbb;
    const float* Cp = reinterpret_cast<const float*>(a.C) + g * a.scb;
    for (int e = tid; e < Q * NM; e += NT) {
      const int i = e / NM, k = e % NM, t = t0 + i;
      const bool ok = t < S && k < N;
      Bs[i * CS + k] = ok ? Bp[t * a.sbs + k] : 0.f;
      Cs[i * CS + k] = ok ? Cp[t * a.scs + k] : 0.f;
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
      const float* x = reinterpret_cast<const float*>(a.x) + bh * a.sxb;
      const float* dy = reinterpret_cast<const float*>(a.dy) + bh * a.sgb;
      for (int e = tid; e < Q * PM; e += NT) {
        const int i = e / PM, q = e % PM, t = t0 + i;
        const bool ok = t < S && q < P;
        Xs[i * XS + q] = ok ? x[t * a.sxs + q] : 0.f;
        Ys[i * XS + q] = ok ? dy[t * a.sgs + q] : 0.f;
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
      float* dx = reinterpret_cast<float*>(a.dx) + bh * (long long)S * P;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = ti + 16 * u, t = t0 + j;
        if (t >= S) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 4 * tj + e;
          if (q < P)
            dx[(long long)t * P + q] = fmaf(wdec[j], cr[u][e], in[u][e]);
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
void reduce(const Args& a, cudaStream_t st) {
  const long long plane = (long long)a.nb * a.S * a.N;
  long long blocks = (plane + NT - 1) / NT;
  if (blocks > 4096) blocks = 4096;
  ssd_bwd_reduce<T><<<(int)blocks, NT, 0, st>>>(a);
}

int run_f32(const Args& a, int BH, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)CHUNK_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nch = (a.S + Q - 1) / Q;
  ssd_bwd_states<<<dim3((a.P + PB - 1) / PB, BH), NT, 0, st>>>(a);
  ssd_bwd_chunk<<<dim3(nch, a.nb, a.slices), NT, CHUNK_SMEM, st>>>(a);
  reduce<float>(a, st);
  return (int)cudaGetLastError();
}

// -- bfloat16 on the tensor cores --------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int RS = PM + 8;       // row stride (bf16) of the x and dy tiles
constexpr int BS = NM + 8;       // row stride (bf16) of B, C and the states
constexpr int STAGES = 3;        // the state walk's ring of tiles
// the state walk's shared memory: the ring, then each warp's staging of its
// part of the state (two planes of 16 x 64 bf16, 16-byte chunks swizzled by
// row), then the chunk weights
constexpr int STAGE_BYTES = 2 * 16 * 64 * 2;
constexpr int STATES_SMEM = STAGES * Q * (BS + RS) * 2 +
                            (NT / 32) * STAGE_BYTES + 2 * (Q + 1) * 4;
// the chunk kernel's shared memory (bytes)
constexpr int B_OFF = 0;                          // [Q][BS] B of the chunk
constexpr int C_OFF = B_OFF + Q * BS * 2;         // [Q][BS] C
constexpr int CB_OFF = C_OFF + Q * BS * 2;        // [Q][GS] C B^T, f32
constexpr int L_OFF = CB_OFF + Q * GS * 4;        // [Q][GS] L, f32
constexpr int X_OFF = L_OFF + Q * GS * 4;         // [2][Q][RS] x, two heads
constexpr int Y_OFF = X_OFF + 2 * Q * RS * 2;     // [2][Q][RS] dy
constexpr int S0_OFF = Y_OFF + 2 * Q * RS * 2;    // [2][PM][BS] S0 hi, lo
constexpr int DS_OFF = S0_OFF + 2 * PM * BS * 2;  // [2][2][PM][BS] dS
constexpr int F_OFF = DS_OFF + 4 * PM * BS * 2;   // f32 vectors, below
constexpr int CHUNK_SMEM_TC = F_OFF + (7 * Q + NT / 32) * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d += a b, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// both terms of a product whose A operand is f32 (hi, lo) and whose B
// operand holds two n8 tiles (b[0..1], b[2..3]): d0 += a b0, d1 += a b1
__device__ __forceinline__ void mma2(float (&d0)[4], float (&d1)[4],
                                     const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4],
                                     const uint32_t (&b)[4]) {
  mma(d0, hi, b[0], b[1]);
  mma(d1, hi, b[2], b[3]);
  mma(d0, lo, b[0], b[1]);
  mma(d1, lo, b[2], b[3]);
}
__device__ __forceinline__ uint32_t pack(bf16 lo_col, bf16 hi_col) {
  return (uint32_t)__bfloat16_as_ushort(lo_col) |
         ((uint32_t)__bfloat16_as_ushort(hi_col) << 16);
}
// the pair (u, v) of f32 values as two bf16 terms: hi = bf16(.), lo =
// bf16(. - hi), each packed as one MMA operand register (u in the low half)
__device__ __forceinline__ void split(float u, float v, uint32_t& hi,
                                      uint32_t& lo) {
  const bf16 hu = __float2bfloat16(u), hv = __float2bfloat16(v);
  hi = pack(hu, hv);
  lo = pack(__float2bfloat16(u - __bfloat162float(hu)),
            __float2bfloat16(v - __bfloat162float(hv)));
}
__device__ __forceinline__ float2 unpack(uint32_t r) {
  return make_float2(__bfloat162float(__ushort_as_bfloat16(r & 0xffffu)),
                     __bfloat162float(__ushort_as_bfloat16(r >> 16)));
}
// an accumulator pair of 16 x 8 tiles (columns k0 .. k0 + 15 of rows g,
// g + 8) as the hi and lo A operand of the K block k0 .. k0 + 15
__device__ __forceinline__ void split_acc(const float (&t0)[4],
                                          const float (&t1)[4],
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split(t0[0], t0[1], hi[0], lo[0]);
  split(t0[2], t0[3], hi[1], lo[1]);
  split(t1[0], t1[1], hi[2], lo[2]);
  split(t1[2], t1[3], hi[3], lo[3]);
}

// the 16-byte groups of a row of w16 bf16 columns, rounded up to a power of
// two (which divides NT): each thread then copies one column group
__device__ __forceinline__ int groups_of(int w16) {
  int g = 2;
  while (8 * g < w16) g *= 2;
  return g;
}
// rows t0 .. t0 + Q - 1 of a (S, width) bf16 operand (row stride ld) into
// dst [Q][stride], columns below w16 (width rounded up to 16), zero past S
// and width
__device__ __forceinline__ void load_tile(bf16* dst, int stride,
                                          const bf16* src, long long ld,
                                          int t0, int S, int width, int w16,
                                          int tid) {
  const int groups = groups_of(w16);
  const int col = 8 * (tid & (groups - 1));
  const int cb = col < width ? 2 * min(8, width - col) : 0;
  for (int i = tid / groups; i < Q; i += NT / groups) {
    const int t = t0 + i, nb = t < S ? cb : 0;
    cp16(dst + i * stride + col, nb ? src + t * ld + col : src, nb);
  }
}
// one chunk's state from the scratch (hi plane, lo plane, each [p16][n16])
// into dst [2][PM][BS]
__device__ __forceinline__ void load_state(bf16* dst, const bf16* src,
                                           int p16, int n16, int tid) {
  const int groups = groups_of(n16);
  const int col = 8 * (tid & (groups - 1));
  if (col >= n16) return;
  for (int row = tid / groups; row < 2 * p16; row += NT / groups) {
    const int pl = row >= p16, r = row - pl * p16;
    cp16(dst + (pl * PM + r) * BS + col, src + (long long)row * n16 + col,
         16);
  }
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -- 1. the chunk-boundary states ---------------------------------------------
// A block per (row, direction).  Warp (w, hf) holds the state's transpose
// H^T for headdim rows 16 w .. 16 w + 15 and d_state columns 64 hf .. 64 hf
// + 63 in its accumulators, as the forward's warps hold theirs (fragment t:
// (p0, n), (p0, n + 1), (p0 + 8, n), (p0 + 8, n + 1), p0 = 16 w + g, n =
// 64 hf + 8 t + 2 tq).  Direction 0 walks the chunks forward from
// initial_state: it writes S0 of chunk c, then H^T = exp(total) H^T +
// (wdec (.) x)^T B.  Direction 1 walks them backward from zero: it writes
// dS of chunk c, then dS^T = exp(total) dS^T + (ecum (.) dy)^T C.  The
// tiles come through a ring of STAGES chunks, each chunk's loads issued
// STAGES - 1 chunks ahead; each state is written once, from the
// accumulators, as a hi and a lo bf16 plane of [p16][n16].
__global__ void __launch_bounds__(NT, 2) ssd_bwd_tc_states(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ts = reinterpret_cast<bf16*>(smem);        // [STAGES][Q][BS] B or C
  bf16* Vs = Ts + STAGES * Q * BS;                  // [STAGES][Q][RS] x or dy
  bf16* Hs = Vs + STAGES * Q * RS;                  // [8 warps][2][16][64]
  float* wts = reinterpret_cast<float*>(Hs + (NT / 32) * STAGE_BYTES / 2);

  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int w = wi & 3, hf = wi >> 2, g = lane >> 2, tq = lane & 3;
  const int m = lane >> 3;
  const long long bh = blockIdx.x;
  const bool rev = blockIdx.y != 0;
  const long long grp = bh / a.r;
  const int S = a.S, N = a.N, P = a.P;
  const int n16 = (N + 15) & ~15, p16 = (P + 15) & ~15;
  const int nch = (S + Q - 1) / Q;
  const long long slab = 2LL * p16 * n16;
  const bf16* T = rev ? reinterpret_cast<const bf16*>(a.C) + grp * a.scb
                      : reinterpret_cast<const bf16*>(a.B) + grp * a.sbb;
  const long long ts = rev ? a.scs : a.sbs;
  const bf16* V = rev ? reinterpret_cast<const bf16*>(a.dy) + bh * a.sgb
                      : reinterpret_cast<const bf16*>(a.x) + bh * a.sxb;
  const long long vs = rev ? a.sgs : a.sxs;
  const float* la = a.la + bh * a.slb;
  bf16* out = reinterpret_cast<bf16*>(rev ? a.dst : a.st) + bh * nch * slab;
  const int p0 = 16 * w + g;
  const int n0 = 64 * hf + 2 * tq;

  float h[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + 8 * t + (e & 1), p = p0 + 8 * (e >> 1);
      h[t][e] = (!rev && a.st0 != nullptr && n < N && p < P)
                    ? a.st0[(bh * N + n) * P + p] : 0.f;
    }

  auto chunk_of = [&](int k) { return rev ? nch - 1 - k : k; };
  // step k's tiles (the last step updates nothing and needs none)
  auto issue = [&](int k) {
    if (k < nch - 1) {
      const int slot = k % STAGES, t0 = chunk_of(k) * Q;
      load_tile(Ts + slot * Q * BS, BS, T, ts, t0, S, N, n16, tid);
      load_tile(Vs + slot * Q * RS, RS, V, vs, t0, S, P, p16, tid);
    }
    commit();
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  // warp 0 holds the log decays of the next step's chunk
  float l0 = 0.f, l1 = 0.f;
  auto load_la = [&](int k) {
    const int t = chunk_of(k) * Q + 2 * lane;
    l0 = t < S ? la[t * a.sls] : 0.f;
    l1 = t + 1 < S ? la[(t + 1) * a.sls] : 0.f;
  };
  if (wi == 0) load_la(0);

  // this warp's staging: plane, row rr (p = 16 w + rr), 16-byte chunk cc
  // (n = 64 hf + 8 cc) stored at chunk cc ^ (rr & 7): no bank conflicts
  bf16* hs = Hs + wi * (STAGE_BYTES / 2);
  auto staged = [&](int pl, int rr, int cc) {
    return hs + (pl * 16 + rr) * 64 + 8 * (cc ^ (rr & 7));
  };
  const bool live = 16 * w < p16 && 64 * hf < n16;

  for (int k = 0; k < nch; ++k) {
    // this chunk's state, once, as hi and lo planes, through the staging
    // for 16-byte stores
    if (live) {
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t hi, lo;
          split(h[t][2 * r], h[t][2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(staged(0, g + 8 * r, t) + 2 * tq) = hi;
          *reinterpret_cast<uint32_t*>(staged(1, g + 8 * r, t) + 2 * tq) = lo;
        }
      __syncwarp();
      bf16* o = out + chunk_of(k) * slab;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = 32 * e + lane, pl = idx >> 7, rr = (idx >> 3) & 15;
        const int cc = idx & 7, p = 16 * w + rr, n = 64 * hf + 8 * cc;
        if (p < p16 && n < n16)
          *reinterpret_cast<uint4*>(o + (pl * p16 + p) * n16 + n) =
              *reinterpret_cast<const uint4*>(staged(pl, rr, cc));
      }
    }
    if (k == nch - 1) break;
    float* wt = wts + (k & 1) * (Q + 1);
    if (wi == 0) {
      // the per-token weights of the update: wdec forward, ecum backward
      const float dec = rev ? scan(l0, l1, lane, nullptr, wt, nullptr)
                            : scan(l0, l1, lane, nullptr, nullptr, wt);
      if (lane == 0) wt[Q] = dec;
      load_la(k + 1);
    }
    wait_groups<STAGES - 2>();
    __syncthreads();   // step k's tiles and weights are in; step k - 1's
                       // slot is free
    issue(k + STAGES - 1);
    if (16 * w >= p16) continue;   // rows past P: no state
    const bf16* Tt = Ts + (k % STAGES) * Q * BS;
    const bf16* Vt = Vs + (k % STAGES) * Q * RS;
    const float dec = wt[Q];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[t][e] *= dec;
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      // (weight (.) V)^T: rows p, K = tokens 16 kb .., as hi and lo terms;
      // va holds tokens 16 kb + 2 tq (+1) (regs 0, 1) and + 8 (regs 2, 3)
      uint32_t va[4], ah[4], al[4];
      ldsm4t(va, Vt + (16 * kb + (lane & 7) + 8 * (m >> 1)) * RS + 16 * w +
                     8 * (m & 1));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int tok = 16 * kb + 8 * (r >> 1) + 2 * tq;
        const float2 v = unpack(va[r]);
        split(v.x * wt[tok], v.y * wt[tok + 1], ah[r], al[r]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (64 * hf + 16 * np >= n16) break;
        uint32_t bf[4];
        ldsm4t(bf, Tt + (16 * kb + (lane & 7) + 8 * (m & 1)) * BS + 64 * hf +
                       16 * np + 8 * (m >> 1));
        mma2(h[2 * np], h[2 * np + 1], ah, al, bf);
      }
    }
  }
}

// -- 2. one chunk of one B/C row's slice of heads ----------------------------
// Warp (w, hf) owns tokens 16 w .. 16 w + 15: hf 0 forms W's rows and sums
// dC, hf 1 forms W^T's rows and sums dB, each over every d_state column
// and the slice's heads in its accumulators, in head order (the W and W^T
// accumulators become A operands in registers); dx's headdim columns 32
// hf .. 32 hf + 31.  Warps w and w + 4 share a scheduler, so each holds
// one W and one W^T row block.  Per head:
//   a. the head's x, dy, dS (and S0) are in; the next head's x, dy, dS go
//      into the other buffer, its log decays into warp 0's registers;
//   b. L, <dS, S0>, and the carries: dC's ecum (.) (dy S0^T) (hf 0, S0
//      read), dB's wdec (.) (x dS^T) (hf 1);
//   c. the next head's S0 goes into the freed buffer, while: dx = G^T dy +
//      wdec (.) (B dS); W = (dy x^T) (.) L, its row sums of W (.) C B^T
//      and dC += W B (hf 0); W^T = (x dy^T) (.) L^T, the column sums and
//      dB += W^T C (hf 1);
//   d. warp 0 sums d log_a's terms in a fixed order, then scans the next
//      head's log decays.
__global__ void __launch_bounds__(NT, 1) ssd_bwd_tc_chunk(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem + B_OFF);
  bf16* Cs = reinterpret_cast<bf16*>(smem + C_OFF);
  float* CB = reinterpret_cast<float*>(smem + CB_OFF);
  float* Ls = reinterpret_cast<float*>(smem + L_OFF);
  bf16* Xs = reinterpret_cast<bf16*>(smem + X_OFF);
  bf16* Ys = reinterpret_cast<bf16*>(smem + Y_OFF);
  bf16* S0s = reinterpret_cast<bf16*>(smem + S0_OFF);
  bf16* DSs = reinterpret_cast<bf16*>(smem + DS_OFF);
  float* cum = reinterpret_cast<float*>(smem + F_OFF);
  float* ecum = cum + Q;
  float* wdec = ecum + Q;
  float* rows = wdec + Q;          // [Q] row sums of W (.) C B^T
  float* cols = rows + Q;          // [Q] column sums
  float* dcc = cols + Q;           // [Q] C_k . dC's carry
  float* dcb = dcc + Q;            // [Q] B_k . dB's carry
  float* sdw = dcb + Q;            // [NT / 32] <dS, S0> by warp

  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int w = wi & 3, hf = wi >> 2, g = lane >> 2, tq = lane & 3;
  const int m = lane >> 3;
  const int c = blockIdx.x, gr = blockIdx.y, sl = blockIdx.z;
  const int S = a.S, N = a.N, P = a.P;
  const int n16 = (N + 15) & ~15, p16 = (P + 15) & ~15;
  const int nks = n16 / 16, pks = p16 / 16;
  const int t0 = c * Q;
  const int nch = (S + Q - 1) / Q;
  const int h0 = sl * a.hs;
  const int h1 = min(a.r, h0 + a.hs);
  const long long slab = 2LL * p16 * n16;
  const bf16* st = reinterpret_cast<const bf16*>(a.st);
  const bf16* dst = reinterpret_cast<const bf16*>(a.dst);
  const int i0 = 16 * w + g, i1 = i0 + 8;   // this thread's rows

  auto row_of = [&](int h) { return (long long)gr * a.r + h; };
  auto load_head = [&](int h, int buf) {
    const long long bh = row_of(h);
    load_tile(Xs + buf * Q * RS, RS,
              reinterpret_cast<const bf16*>(a.x) + bh * a.sxb, a.sxs, t0, S,
              P, p16, tid);
    load_tile(Ys + buf * Q * RS, RS,
              reinterpret_cast<const bf16*>(a.dy) + bh * a.sgb, a.sgs, t0, S,
              P, p16, tid);
    load_state(DSs + buf * 2 * PM * BS, dst + (bh * nch + c) * slab, p16, n16,
               tid);
  };
  float l0 = 0.f, l1 = 0.f;   // warp 0: the next head's log decays
  auto load_la = [&](int h) {
    const float* la = a.la + row_of(h) * a.slb;
    const int t = t0 + 2 * lane;
    l0 = t < S ? la[t * a.sls] : 0.f;
    l1 = t + 1 < S ? la[(t + 1) * a.sls] : 0.f;
  };

  load_tile(Bs, BS, reinterpret_cast<const bf16*>(a.B) + gr * a.sbb, a.sbs,
            t0, S, N, n16, tid);
  load_tile(Cs, BS, reinterpret_cast<const bf16*>(a.C) + gr * a.scb, a.scs,
            t0, S, N, n16, tid);
  load_head(h0, 0);
  load_state(S0s, st + (row_of(h0) * nch + c) * slab, p16, n16, tid);
  commit();
  if (wi == 0) {
    load_la(h0);
    scan(l0, l1, lane, cum, ecum, wdec);
  }
  wait_groups<0>();
  __syncthreads();

  // C B^T (unmasked, f32), query rows 16 w .., key tiles jp = hf, hf + 2
  // with jp <= w (those past the diagonal are never read)
  {
    float sc[2][2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[u][v][e] = 0.f;
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t af[4];
      ldsm4(af, Cs + (16 * w + (lane & 15)) * BS + 16 * ks + 8 * (lane >> 4));
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jp = hf + 2 * u;
        if (jp > w) break;
        uint32_t bf[4];
        ldsm4(bf, Bs + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * BS +
                      16 * ks + 8 * ((lane >> 3) & 1));
        mma(sc[u][0], af, bf[0], bf[1]);
        mma(sc[u][1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jp = hf + 2 * u;
      if (jp > w) break;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int j = 16 * jp + 8 * v + 2 * tq;
        *reinterpret_cast<float2*>(CB + i0 * GS + j) =
            make_float2(sc[u][v][0], sc[u][v][1]);
        *reinterpret_cast<float2*>(CB + i1 * GS + j) =
            make_float2(sc[u][v][2], sc[u][v][3]);
      }
    }
  }

  // the slice's dC (hf 0) or dB (hf 1), summed in head order: rows i0, i1,
  // d_state columns 8 t + 2 tq (+1)
  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int h = h0; h < h1; ++h) {
    const int buf = (h - h0) & 1;
    const long long bh = row_of(h);
    if (h > h0) {
      wait_groups<0>();
      __syncthreads();   // a: this head's tiles and log decays are in
    }
    if (h + 1 < h1) load_head(h + 1, buf ^ 1);
    commit();
    if (wi == 0 && h + 1 < h1) load_la(h + 1);
    const bf16* X = Xs + buf * Q * RS;
    const bf16* Y = Ys + buf * Q * RS;
    const bf16* Dh = DSs + buf * 2 * PM * BS;
    const bf16* Dl = Dh + PM * BS;
    const bf16* Sh = S0s;
    const bf16* Sl = S0s + PM * BS;

    // b. L = exp(cum_i - cum_j) [j <= i]
#pragma unroll
    for (int k = 0; k < Q * Q / NT; ++k) {
      const int i = k * (NT / Q) + tid / Q, j = tid % Q;
      Ls[i * GS + j] = j <= i ? expf(cum[i] - cum[j]) : 0.f;
    }
    // <dS, S0> over the state, each as hi + lo: a thread's column pair,
    // its rows in four partial sums (PM rows at most, NT / groups apart)
    {
      float sd[4] = {0.f, 0.f, 0.f, 0.f};
      const int groups = groups_of(n16) * 4;   // column pairs a row, 2^k
      const int n = 2 * (tid & (groups - 1)), step = NT / groups;
#pragma unroll
      for (int k = 0; k < PM / 4; ++k) {
        const int p = tid / groups + k * step;
        if (p >= p16 || n >= n16) break;
        const int o = p * BS + n;
        const float2 dh = unpack(*reinterpret_cast<const uint32_t*>(Dh + o));
        const float2 dl = unpack(*reinterpret_cast<const uint32_t*>(Dl + o));
        const float2 sh = unpack(*reinterpret_cast<const uint32_t*>(Sh + o));
        const float2 sl2 = unpack(*reinterpret_cast<const uint32_t*>(Sl + o));
        sd[k & 3] = fmaf(dh.x + dl.x, sh.x + sl2.x, sd[k & 3]);
        sd[k & 3] = fmaf(dh.y + dl.y, sh.y + sl2.y, sd[k & 3]);
      }
      float t = (sd[0] + sd[1]) + (sd[2] + sd[3]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == 0) sdw[wi] = t;
    }
    // the carry of dC (hf 0: A = dy, K = S0, weight ecum, R = C) or of dB
    // (hf 1: A = x, K = dS, weight wdec, R = B): v = weight_i (A_i K^T),
    // rows i0, i1, in two halves of 64 d_state columns; acc += v and the
    // carry's dot with R_i
    auto carry = [&](const bf16* A, const bf16* Kh, const bf16* Kl,
                     const float* wgt, const bf16* R, float* dot) {
      const float e0 = wgt[i0], e1 = wgt[i1];
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (64 * half >= n16) break;
        float cr[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) cr[t][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < PM / 16; ++ks) {
          if (ks >= pks) break;
          uint32_t af[4];
          ldsm4(af, A + (16 * w + (lane & 15)) * RS + 16 * ks +
                        8 * (lane >> 4));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (64 * half + 16 * np >= n16) break;
            const int o = (16 * ks + (lane & 7) + 8 * (m & 1)) * BS +
                          64 * half + 16 * np + 8 * (m >> 1);
            uint32_t bh_[4], bl_[4];
            ldsm4t(bh_, Kh + o);
            ldsm4t(bl_, Kl + o);
            mma(cr[2 * np], af, bh_[0], bh_[1]);
            mma(cr[2 * np + 1], af, bh_[2], bh_[3]);
            mma(cr[2 * np], af, bl_[0], bl_[1]);
            mma(cr[2 * np + 1], af, bl_[2], bl_[3]);
          }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int n = 64 * half + 8 * t + 2 * tq;
          if (64 * half + 8 * t >= n16) break;
          const float v0 = cr[t][0] * e0, v1 = cr[t][1] * e0;
          const float v2 = cr[t][2] * e1, v3 = cr[t][3] * e1;
          float (&a4)[4] = acc[8 * half + t];
          a4[0] += v0;
          a4[1] += v1;
          a4[2] += v2;
          a4[3] += v3;
          const float2 r0 = unpack(*reinterpret_cast<const uint32_t*>(
              R + i0 * BS + n));
          const float2 r1 = unpack(*reinterpret_cast<const uint32_t*>(
              R + i1 * BS + n));
          d0 = fmaf(r0.x, v0, d0);
          d0 = fmaf(r0.y, v1, d0);
          d1 = fmaf(r1.x, v2, d1);
          d1 = fmaf(r1.y, v3, d1);
        }
      }
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
      if (tq == 0) {
        dot[i0] = d0;
        dot[i1] = d1;
      }
    };
    if (hf == 0)
      carry(Y, Sh, Sl, ecum, Cs, dcc);
    else
      carry(X, Dh, Dl, wdec, Bs, dcb);
    __syncthreads();   // S0's buffer is free; L is written
    if (h + 1 < h1)
      load_state(S0s, st + (row_of(h + 1) * nch + c) * slab, p16, n16, tid);
    commit();

    // c. dx_j = sum_i G_ij dy_i + wdec_j B_j dS, columns 32 hf .. (B dS's
    // hi and lo terms in accumulators of their own: twice the chains)
    {
      float in[4][4], cr[4][4], cl[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) in[u][e] = cr[u][e] = cl[u][e] = 0.f;
      // G^T: rows j, K = i over the blocks ib >= w; A register r holds
      // row 16 w + g + 8 (r & 1), keys i = 16 ib + 2 tq + 8 (r >> 1) (+1)
#pragma unroll 1
      for (int ib = w; ib < 4; ++ib) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 16 * w + g + 8 * (r & 1);
          const int i = 16 * ib + 2 * tq + 8 * (r >> 1);
          split(CB[i * GS + j] * Ls[i * GS + j],
                CB[(i + 1) * GS + j] * Ls[(i + 1) * GS + j], ah[r], al[r]);
        }
#pragma unroll
        for (int pb = 0; pb < 2; ++pb) {
          const int pc = 32 * hf + 16 * pb;
          if (pc >= p16) break;
          uint32_t bf[4];
          ldsm4t(bf, Y + (16 * ib + (lane & 7) + 8 * (m & 1)) * RS + pc +
                         8 * (m >> 1));
          mma2(in[2 * pb], in[2 * pb + 1], ah, al, bf);
        }
      }
#pragma unroll
      for (int ks = 0; ks < NM / 16; ++ks) {
        if (ks >= nks) break;
        uint32_t af[4];
        ldsm4(af, Bs + (16 * w + (lane & 15)) * BS + 16 * ks + 8 * (lane >> 4));
#pragma unroll
        for (int pb = 0; pb < 2; ++pb) {
          const int pc = 32 * hf + 16 * pb;
          if (pc >= p16) break;
          const int o = (pc + (lane & 7) + 8 * (lane >> 4)) * BS + 16 * ks +
                        8 * ((lane >> 3) & 1);
          uint32_t bh_[4], bl_[4];
          ldsm4(bh_, Dh + o);
          ldsm4(bl_, Dl + o);
          mma(cr[2 * pb], af, bh_[0], bh_[1]);
          mma(cr[2 * pb + 1], af, bh_[2], bh_[3]);
          mma(cl[2 * pb], af, bl_[0], bl_[1]);
          mma(cl[2 * pb + 1], af, bl_[2], bl_[3]);
        }
      }
      bf16* dx = reinterpret_cast<bf16*>(a.dx) + bh * (long long)S * P;
      const float w0 = wdec[i0], w1 = wdec[i1];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = 32 * hf + 8 * u + 2 * tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = t0 + i0 + 8 * r;
          const float wj = r ? w1 : w0;
          if (t >= S || p >= P) continue;
          const bf16 v0 = __float2bfloat16(fmaf(
              wj, cr[u][2 * r] + cl[u][2 * r], in[u][2 * r]));
          const bf16 v1 = __float2bfloat16(fmaf(
              wj, cr[u][2 * r + 1] + cl[u][2 * r + 1], in[u][2 * r + 1]));
          bf16* d = dx + (long long)t * P + p;
          if ((P & 1) == 0) {
            *reinterpret_cast<uint32_t*>(d) = pack(v0, v1);
          } else {
            d[0] = v0;
            if (p + 1 < P) d[1] = v1;
          }
        }
      }
    }
    // hf 0: W = (dy x^T) (.) L for rows i0, i1 and key blocks jb <= w, the
    // row sums of W (.) C B^T, dC += W B
    if (hf == 0) {
      float wa[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) wa[t][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < PM / 16; ++ks) {
        if (ks >= pks) break;
        uint32_t af[4];
        ldsm4(af, Y + (16 * w + (lane & 15)) * RS + 16 * ks + 8 * (lane >> 4));
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          if (jb > w) break;
          uint32_t bf[4];
          ldsm4(bf, X + (16 * jb + (lane & 7) + 8 * (lane >> 4)) * RS +
                        16 * ks + 8 * ((lane >> 3) & 1));
          mma(wa[2 * jb], af, bf[0], bf[1]);
          mma(wa[2 * jb + 1], af, bf[2], bf[3]);
        }
      }
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        if (jb > w) break;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int j = 16 * jb + 8 * v + 2 * tq;
          float* t4 = wa[2 * jb + v];
          const float2 l0v = *reinterpret_cast<const float2*>(Ls + i0 * GS + j);
          const float2 l1v = *reinterpret_cast<const float2*>(Ls + i1 * GS + j);
          const float2 c0v = *reinterpret_cast<const float2*>(CB + i0 * GS + j);
          const float2 c1v = *reinterpret_cast<const float2*>(CB + i1 * GS + j);
          t4[0] *= l0v.x;
          t4[1] *= l0v.y;
          t4[2] *= l1v.x;
          t4[3] *= l1v.y;
          rs0 = fmaf(t4[0], c0v.x, rs0);
          rs0 = fmaf(t4[1], c0v.y, rs0);
          rs1 = fmaf(t4[2], c1v.x, rs1);
          rs1 = fmaf(t4[3], c1v.y, rs1);
        }
      }
      rs0 = quad_sum(rs0);
      rs1 = quad_sum(rs1);
      if (tq == 0) {
        rows[i0] = rs0;
        rows[i1] = rs1;
      }
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        if (jb > w) break;
        uint32_t ah[4], al[4];
        split_acc(wa[2 * jb], wa[2 * jb + 1], ah, al);
#pragma unroll
        for (int np = 0; np < NM / 16; ++np) {
          if (16 * np >= n16) break;
          uint32_t bf[4];
          ldsm4t(bf, Bs + (16 * jb + (lane & 7) + 8 * (m & 1)) * BS +
                         16 * np + 8 * (m >> 1));
          mma2(acc[2 * np], acc[2 * np + 1], ah, al, bf);
        }
      }
    } else {
      // hf 1: W^T = (x dy^T) (.) L^T for rows j = i0, i1 and query blocks
      // ib >= w, the column sums of W (.) C B^T, dB += W^T C
      float wt[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) wt[t][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < PM / 16; ++ks) {
        if (ks >= pks) break;
        uint32_t af[4];
        ldsm4(af, X + (16 * w + (lane & 15)) * RS + 16 * ks + 8 * (lane >> 4));
#pragma unroll
        for (int ib = 0; ib < 4; ++ib) {
          if (ib < w) continue;
          uint32_t bf[4];
          ldsm4(bf, Y + (16 * ib + (lane & 7) + 8 * (lane >> 4)) * RS +
                        16 * ks + 8 * ((lane >> 3) & 1));
          mma(wt[2 * ib], af, bf[0], bf[1]);
          mma(wt[2 * ib + 1], af, bf[2], bf[3]);
        }
      }
      float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
      for (int ib = 0; ib < 4; ++ib) {
        if (ib < w) continue;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int i = 16 * ib + 8 * v + 2 * tq;
          float* t4 = wt[2 * ib + v];
          t4[0] *= Ls[i * GS + i0];
          t4[1] *= Ls[(i + 1) * GS + i0];
          t4[2] *= Ls[i * GS + i1];
          t4[3] *= Ls[(i + 1) * GS + i1];
          cs0 = fmaf(t4[0], CB[i * GS + i0], cs0);
          cs0 = fmaf(t4[1], CB[(i + 1) * GS + i0], cs0);
          cs1 = fmaf(t4[2], CB[i * GS + i1], cs1);
          cs1 = fmaf(t4[3], CB[(i + 1) * GS + i1], cs1);
        }
      }
      cs0 = quad_sum(cs0);
      cs1 = quad_sum(cs1);
      if (tq == 0) {
        cols[i0] = cs0;
        cols[i1] = cs1;
      }
#pragma unroll
      for (int ib = 0; ib < 4; ++ib) {
        if (ib < w) continue;
        uint32_t ah[4], al[4];
        split_acc(wt[2 * ib], wt[2 * ib + 1], ah, al);
#pragma unroll
        for (int np = 0; np < NM / 16; ++np) {
          if (16 * np >= n16) break;
          uint32_t bf[4];
          ldsm4t(bf, Cs + (16 * ib + (lane & 7) + 8 * (m & 1)) * BS +
                         16 * np + 8 * (m >> 1));
          mma2(acc[2 * np], acc[2 * np + 1], ah, al, bf);
        }
      }
    }
    __syncthreads();   // the row, column and carry sums are written

    // d. d la: warp 0, tokens k = 2 lane, 2 lane + 1
    if (wi == 0) {
      float d[2], sb = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * lane + e;
        d[e] = rows[k] - cols[k] + dcc[k] - dcb[k];
        sb += dcb[k];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sb += __shfl_xor_sync(0xffffffffu, sb, o);
      float sd = 0.f;
#pragma unroll
      for (int k = 0; k < NT / 32; ++k) sd += sdw[k];
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
      if (h + 1 < h1) scan(l0, l1, lane, cum, ecum, wdec);
    }
  }

  const long long plane = (long long)a.nb * S * N;
  float* part = (hf == 0 ? a.pC : a.pB) + sl * plane +
                ((long long)gr * S) * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + i0 + 8 * r;
    if (t >= S) continue;
#pragma unroll
    for (int tt = 0; tt < 16; ++tt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * tt + 2 * tq + e;
        if (n < N) part[(long long)t * N + n] = acc[tt][2 * r + e];
      }
    }
  }
}

int run(const Args& a, int BH, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_tc_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
      STATES_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_tc_chunk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CHUNK_SMEM_TC);
  if (e != cudaSuccess) return (int)e;
  const int nch = (a.S + Q - 1) / Q;
  ssd_bwd_tc_states<<<dim3(BH, 2), NT, STATES_SMEM, st>>>(a);
  ssd_bwd_tc_chunk<<<dim3(nch, a.nb, a.slices), NT, CHUNK_SMEM_TC, st>>>(a);
  reduce<bf16>(a, st);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C, dy and dx, dB, dC); la, st0, dla
// and pB / pC are f32.  dx, dla, dB, dC contiguous; st / dst scratch of
// (BH, nch, N, P) f32 (float32) or (BH, nch, 2, p16, n16) bf16 (bfloat16:
// p16 / n16 = P / N rounded up to 16), pB / pC (slices, BH / r, S, N) f32.
// bfloat16 also needs 16-byte aligned x / B / C / dy rows (cp.async).  hs
// heads a slice, slices = ceil(r / hs).  Requires S >= 1, N <= 128, P <=
// 64, BH % r == 0, BH <= 65535, BH / r <= 65535.  Returns
// cudaGetLastError() after the launches.
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
  if (dtype == 0) return run_f32(a, BH, s);
  if (dtype == 1) return tc::run(a, BH, s);
  return (int)cudaErrorInvalidValue;
}
