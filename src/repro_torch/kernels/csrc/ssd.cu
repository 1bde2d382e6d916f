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
// Both routines walk Q = 64-token chunks (the Pallas body's 256 x 256 f32
// score tile would not fit a block's 227 KB): the result depends on the
// chunk length only through f32 rounding (ssd.py's own oracle is the
// per-step recurrence, ref.py:59).  Every tile is zero-filled past S, N and
// P, so a ragged S needs no fallback: la = 0 and x = 0 past S give decay 1
// and no input, exactly the reference's padding (ops.py:517-522).  With
// n_groups < n_heads one B/C row serves r consecutive (batch * head) rows
// (mamba2-2.7b: r = 80 heads); a block reads row bh / r in place, so the
// per-head copies of the reference (mamba2.py:120-125) never exist.
//
// What bounds it on the H100, as PERF.md counts it: at mamba2-2.7b width
// (80 heads, P 64, N 128, S 1024, bf16) the operands and results are
// 24.44 MB and the causal half of the 64-token schedule is 3.707 GFLOP, so
// bytes bound it: 7.3 us at 3.35 TB/s (3.7 us of tensor-core time).
//
// bfloat16 (ssd_tc_kernel), on the tensor cores.
//   * Filling the card.  A batch-1 prefill has only 80 rows, so each row's
//     chunks are cut into `pieces` consecutive pieces, as many as two
//     blocks an SM give room for (ssd.py `pieces`: 3 at 80 rows on 132
//     SMs, 240 blocks).  Pass 1 (ssd_tc_kernel<false>, pieces 0 .. G-2)
//     runs each piece's scan from a zero state and writes its local end
//     state and decay product; pass 2 (<true>, every piece) folds the
//     pieces before its own in order, state = dec_g state + local_g from
//     initial_state, and runs its chunks from that carry, writing y (and,
//     in the last piece, the final state).  No atomics, a fixed order: the
//     bits repeat.  The carried states are f32, 32 KB a piece: at 80 rows,
//     S 1024, 80 x 2 x 32 KB = 5.24 MB written once and read by the later
//     pieces of the row (mostly from the 50 MB L2), beside the 24.44 MB of
//     operands; x and B are read twice where a piece runs both passes.
//   * Products: mma.sync m16n8k16 (bf16 in, f32 accumulate), chosen over
//     wgmma because the routine is byte-bound and its tiles are small
//     (64 x 64 x 128 a chunk): the state fragments, the score terms and
//     the decay-weighted x are formed in registers and fed as MMA operands
//     directly, with no swizzled shared-memory layouts.  8 warps: warp
//     (w, hf) holds the state H^T for headdim rows 16 w .. 16 w + 15 and
//     d_state columns 64 hf .. 64 hf + 63 in its accumulators.  Per chunk:
//     S = C B^T (query rows 16 w .., causal key tiles only, split between
//     the two warps of a row block), y^T = exp(cum) (.) H^T C^T + X^T G^T
//     (query tiles split the same way; the whole H^T of the rows is read
//     from a copy the warps publish in shared memory each chunk), and
//     H^T = exp(total) H^T + (w (.) X)^T B for the warp's own columns.
//     Operands come from shared memory by ldmatrix, row strides padded by
//     16 bytes: no bank conflicts.
//   * The f32 operand.  C B^T multiplies bf16 inputs: its products are
//     exact.  G (the decayed scores), H and w (.) X are f32; each is fed as
//     two bf16 terms, hi = bf16(v) and lo = bf16(v - hi) (~2^-17 relative),
//     one MMA per term into the same f32 accumulator.  One term (~2^-9)
//     misses the limit; tests/test_torch_ssd_numerics.py emulates this
//     schedule on the CPU and shows both.
//   * Loads: cp.async of 16-byte groups with zero fill past S / N / P.  A
//     block holds 103 KB of shared memory and 128 registers a thread (no
//     spills), so two blocks (16 warps) share an SM.  Each chunk still
//     waits for its own tiles: with the state copy, a second stage of
//     tiles would not leave room for two blocks an SM.
//
// float32 (ssd_f32_kernel), on the CUDA cores as first written: one block
// per (batch * head) row walks the chunks with the (N x P) state resident
// in shared memory, register micro-tiles over the tiles (4 x 4 for the
// scores and y, 8 x 4 for the state).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;        // tokens per chunk
constexpr int NM = 128;      // largest d_state
constexpr int PM = 64;       // largest headdim
constexpr int NT = 256;      // threads per block (f32)
constexpr int CS = NM + 4;   // row stride (floats) of the B and C tiles
constexpr int XS = PM + 4;   // row stride of the X tile and of the state
constexpr int GS = Q + 4;    // row stride of the score tile
constexpr size_t SMEM_FLOATS = 2 * (size_t)Q * CS + (size_t)Q * XS +
                               (size_t)Q * GS + (size_t)NM * XS + 3 * Q;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * 4;

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
  // the bf16 routine's split of each row into pieces (see the header)
  int pieces, cpp;     // pieces per row, 64-token chunks per piece
  float* part;         // (BH, pieces - 1, 128 threads, 16, 4): local states
  float* dec;          // (BH, pieces - 1): each piece's decay prod exp(total)
  int yvec;            // y's rows allow 16-byte stores
};

__global__ void __launch_bounds__(NT, 1) ssd_f32_kernel(Args a) {
  using T = float;
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
      Bs[i * CS + k] = ok ? Bp[t * a.sbs + k] : 0.f;
      Cs[i * CS + k] = ok ? Cp[t * a.scs + k] : 0.f;
    }
    for (int e = tid; e < Q * PM; e += NT) {
      const int i = e / PM, p = e % PM, t = t0 + i;
      Xs[i * XS + p] = (t < S && p < P) ? x[t * a.sxs + p] : 0.f;
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
            if (p < P) y[t * a.sys + p] = fmaf(e, yc[u][w], yi[u][w]);
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

int ssd_f32_run(const Args& a, int BH, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  ssd_f32_kernel<<<BH, NT, SMEM_BYTES, st>>>(a);
  return (int)cudaGetLastError();
}


// -- bfloat16 on the tensor cores ------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;          // 8 warps: warp (w, hf) = (wi & 3, wi >> 2)
constexpr int RS = PM + 8;       // row stride (bf16) of the X, G and Y tiles
constexpr int BS = NM + 8;       // row stride (bf16) of the B and C tiles
constexpr int X_OFF = 0;                          // [Q][RS] x of the chunk
constexpr int B_OFF = X_OFF + Q * RS * 2;         // [Q][BS] B
constexpr int C_OFF = B_OFF + Q * BS * 2;         // [Q][BS] C
constexpr int GH_OFF = C_OFF + Q * BS * 2;        // [Q][RS] G, hi term
constexpr int GL_OFF = GH_OFF + Q * RS * 2;       // [Q][RS] G, lo term
constexpr int Y_OFF = GL_OFF + Q * RS * 2;        // [Q][RS] y, staged
constexpr int H_OFF = Y_OFF + Q * RS * 2;         // the state, f32, as the
                                                  // warps' fragments
constexpr int F_OFF = H_OFF + PM * NM * 4;        // cum, ecum, wdec [Q] f32
constexpr int SMEM = F_OFF + 3 * Q * 4;
constexpr int NTILE = NM / 16;                    // state fragments a thread
constexpr int PART = NT * NTILE * 4;              // floats of a local state

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
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
// the A operand (rows p, k = 16 d_state columns) of H^T as hi and lo terms,
// from the two state fragments that hold those columns
__device__ __forceinline__ void split_a(const float4& f0, const float4& f1,
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(f0.x, f0.y, hi[0], lo[0]);
  split(f0.z, f0.w, hi[1], lo[1]);
  split(f1.x, f1.y, hi[2], lo[2]);
  split(f1.z, f1.w, hi[3], lo[3]);
}

// Y = false: pass 1, pieces 0 .. pieces-2 from a zero state, writing the
// local end state and decay product.  Y = true: pass 2, every piece from
// its carry-in, writing y and (the last piece) the final state.
//
// Warp (w, hf) holds the state H^T for headdim rows 16 w .. 16 w + 15 and
// d_state columns 64 hf .. 64 hf + 63 (fragment t: (p0, n), (p0, n + 1),
// (p0 + 8, n), (p0 + 8, n + 1), p0 = 16 w + g, n = 64 hf + 8 t + 2 tq),
// and computes y^T for those headdim rows and the query tiles it = hf,
// hf + 2, ..; the scores for query rows 16 w .. against the key pairs jp =
// hf, hf + 2 (jp <= w).  The carry-in product needs the whole H^T of the
// rows: each warp publishes its half in shared memory once a chunk.
template <bool Y>
__global__ void __launch_bounds__(NT, 2) ssd_tc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + X_OFF);
  bf16* Bs = reinterpret_cast<bf16*>(smem + B_OFF);
  bf16* Cs = reinterpret_cast<bf16*>(smem + C_OFF);
  bf16* Gh = reinterpret_cast<bf16*>(smem + GH_OFF);
  bf16* Gl = reinterpret_cast<bf16*>(smem + GL_OFF);
  bf16* Ys = reinterpret_cast<bf16*>(smem + Y_OFF);
  float4* Hx = reinterpret_cast<float4*>(smem + H_OFF);
  float* cum = reinterpret_cast<float*>(smem + F_OFF);
  float* ecum = cum + Q;
  float* wdec = ecum + Q;

  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int w = wi & 3, hf = wi >> 2;
  const int g = lane >> 2, tq = lane & 3;
  const int piece = blockIdx.x;
  const long long bh = blockIdx.y;
  const long long grp = bh / a.r;
  const bf16* x = reinterpret_cast<const bf16*>(a.x) + bh * a.sxb;
  const float* la = a.la + bh * a.slb;
  const bf16* Bp = reinterpret_cast<const bf16*>(a.B) + grp * a.sbb;
  const bf16* Cp = reinterpret_cast<const bf16*>(a.C) + grp * a.scb;
  bf16* y = reinterpret_cast<bf16*>(a.y) + bh * a.syb;
  const int S = a.S, N = a.N, P = a.P;
  const int nks = (N + 15) / 16;          // k-steps over d_state
  const int c_begin = piece * a.cpp;
  const int nch = (S + Q - 1) / Q;
  const int c_end = c_begin + a.cpp < nch ? c_begin + a.cpp : nch;
  const int p0 = 16 * w + g;
  const int n0 = 64 * hf + 2 * tq;        // + 8 t: this thread's columns
  const long long slot = bh * (a.pieces - 1);   // this row's local states

  float h[NTILE][4];
#pragma unroll
  for (int t = 0; t < NTILE; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + 8 * t + (e & 1), p = p0 + 8 * (e >> 1);
      h[t][e] = (Y && a.st0 != nullptr && n < N && p < P)
                    ? a.st0[(bh * N + n) * P + p] : 0.f;
    }
  if (Y) {
    // carry-in: fold the local states of the pieces before this one
    for (int q = 0; q < piece; ++q) {
      const float d = a.dec[slot + q];
      const float4* pt =
          reinterpret_cast<const float4*>(a.part + (slot + q) * PART) + tid;
#pragma unroll
      for (int t = 0; t < NTILE; ++t) {
        const float4 v = pt[t * NT];
        h[t][0] = fmaf(d, h[t][0], v.x);
        h[t][1] = fmaf(d, h[t][1], v.y);
        h[t][2] = fmaf(d, h[t][2], v.z);
        h[t][3] = fmaf(d, h[t][3], v.w);
      }
    }
  }

  // y of the chunk at t0, staged in Ys, to global memory
  auto store_y = [&](int t0) {
    for (int e = tid; e < Q * (PM / 8); e += NT) {
      const int i = e / (PM / 8), c = 8 * (e % (PM / 8)), t = t0 + i;
      if (t >= S || c >= P) continue;
      const bf16* src = Ys + i * RS + c;
      bf16* dst = y + t * a.sys + c;
      if (a.yvec && c + 8 <= P) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < 8 && c + k < P; ++k) dst[k] = src[k];
      }
    }
  };
  // warp 0 holds the log decays of the next chunk, two tokens a lane
  float l0 = 0.f, l1 = 0.f;
  auto load_la = [&](int c) {
    const int t = c * Q + 2 * lane;
    l0 = t < S ? la[t * a.sls] : 0.f;
    l1 = t + 1 < S ? la[(t + 1) * a.sls] : 0.f;
  };
  if (w == 0 && hf == 0 && c_begin < c_end) load_la(c_begin);

  float dprod = 1.f;   // pass 1: the piece's decay, prod of exp(total)
  for (int c = c_begin; c < c_end; ++c) {
    const int t0 = c * Q;
    __syncthreads();   // the previous chunk is done with every tile
    if (Y && c > c_begin) store_y(t0 - Q);
    // x: Q rows x 8 groups of 8; B, C: Q rows x 16 groups
    for (int e = tid; e < Q * (PM / 8); e += NT) {
      const int i = e / (PM / 8), col = 8 * (e % (PM / 8)), t = t0 + i;
      const int nb = (t < S && col < P) ? 2 * min(8, P - col) : 0;
      cp16(Xs + i * RS + col, nb ? x + t * a.sxs + col : x, nb);
    }
    for (int e = tid; e < Q * (NM / 8); e += NT) {
      const int i = e / (NM / 8), col = 8 * (e % (NM / 8)), t = t0 + i;
      const int nb = (t < S && col < N) ? 2 * min(8, N - col) : 0;
      cp16(Bs + i * BS + col, nb ? Bp + t * a.sbs + col : Bp, nb);
      if (Y) cp16(Cs + i * BS + col, nb ? Cp + t * a.scs + col : Cp, nb);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (wi == 0) {
      // inclusive scan of the chunk's log decays
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
      if (c + 1 < c_end) load_la(c + 1);
    }
    if (Y) {
      // publish this warp's half of the state for the carry-in product
#pragma unroll
      for (int t = 0; t < NTILE; ++t)
        Hx[(wi * NTILE + t) * 32 + lane] =
            make_float4(h[t][0], h[t][1], h[t][2], h[t][3]);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // X^T fragments (A operand, rows p, k = tokens 16 kb .. 16 kb + 15)
    auto load_xa = [&](uint32_t (&xa)[4], int kb) {
      const int m = lane >> 3;
      ldsm4t(xa, Xs + (16 * kb + (lane & 7) + 8 * (m >> 1)) * RS + 16 * w +
                     8 * (m & 1));
    };

    if (Y) {
      // scores: query rows i = 16 w .. 16 w + 15 against the key pairs
      // jp = hf, hf + 2 with jp <= w (key tiles j <= i only); G = S
      // exp(cum_i - cum_j), as hi and lo terms
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
          ldsm4(af, Cs + (16 * w + (lane & 15)) * BS + 16 * ks +
                        8 * (lane >> 4));
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
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 16 * w + g + 8 * r;   // query row
              const float v0 = j <= i
                  ? sc[u][v][2 * r] * expf(cum[i] - cum[j]) : 0.f;
              const float v1 = j + 1 <= i
                  ? sc[u][v][2 * r + 1] * expf(cum[i] - cum[j + 1]) : 0.f;
              uint32_t hi, lo;
              split(v0, v1, hi, lo);
              *reinterpret_cast<uint32_t*>(Gh + i * RS + j) = hi;
              *reinterpret_cast<uint32_t*>(Gl + i * RS + j) = lo;
            }
          }
        }
      }
      __syncthreads();

      // y^T (rows p, query columns of the tiles it = 2 u + hf) =
      // exp(cum_i) (H^T C^T) + X^T G^T
      float yv[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) yv[u][e] = 0.f;
      // the carry-in over d_state step ks (columns 16 ks .. 16 ks + 15) from
      // the two state fragments that hold them (of warp (w, ks / 4))
      auto carry = [&](int ks, const float4& f0, const float4& f1) {
        uint32_t ah[4], al[4];
        split_a(f0, f1, ah, al);
#pragma unroll
        for (int u = 0; u < 4; u += 2) {
          const int it = 2 * u + hf;                  // tiles it, it + 2
          uint32_t bf[4];
          ldsm4(bf, Cs + (8 * (it + 2 * (lane >> 4)) + (lane & 7)) * BS +
                        16 * ks + 8 * ((lane >> 3) & 1));
          mma(yv[u], ah, bf[0], bf[1]);
          mma(yv[u + 1], ah, bf[2], bf[3]);
          mma(yv[u], al, bf[0], bf[1]);
          mma(yv[u + 1], al, bf[2], bf[3]);
        }
      };
      // both halves of the rows' state from shared memory (a loop that is
      // not unrolled keeps the registers for the accumulators)
      const float4* hw = Hx + w * NTILE * 32 + lane;
#pragma unroll 1
      for (int ks = 0; ks < nks; ++ks) {
        const int t = (ks / (NTILE / 2)) * 4 * NTILE + 2 * (ks % (NTILE / 2));
        carry(ks, hw[t * 32], hw[(t + 1) * 32]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 8 * (2 * u + hf) + 2 * tq;
        const float e0 = ecum[i], e1 = ecum[i + 1];
        yv[u][0] *= e0;
        yv[u][1] *= e1;
        yv[u][2] *= e0;
        yv[u][3] *= e1;
      }
#pragma unroll 1
      for (int kb = 0; kb < 4; ++kb) {
        uint32_t xa[4];
        load_xa(xa, kb);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int it = 2 * u + hf;
          if (2 * kb > it) continue;   // key tiles past the query tile: 0
          uint32_t bf[4];
          const bf16* gsrc = (lane >> 4) ? Gl : Gh;
          ldsm4(bf, gsrc + (8 * it + (lane & 7)) * RS + 16 * kb +
                        8 * ((lane >> 3) & 1));
          mma(yv[u], xa, bf[0], bf[1]);
          mma(yv[u], xa, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 8 * (2 * u + hf) + 2 * tq;
        Ys[i * RS + p0] = __float2bfloat16(yv[u][0]);
        Ys[(i + 1) * RS + p0] = __float2bfloat16(yv[u][1]);
        Ys[i * RS + p0 + 8] = __float2bfloat16(yv[u][2]);
        Ys[(i + 1) * RS + p0 + 8] = __float2bfloat16(yv[u][3]);
      }
    }

    // state: H^T = exp(total) H^T + (wdec (.) X)^T B, this warp's columns
    const float dec = ecum[Q - 1];
    dprod *= dec;
    if (Y) {
      // back from the copy published above: h is not held in registers
      // through the scores and y
#pragma unroll
      for (int t = 0; t < NTILE; ++t) {
        const float4 v = Hx[(wi * NTILE + t) * 32 + lane];
        h[t][0] = v.x;
        h[t][1] = v.y;
        h[t][2] = v.z;
        h[t][3] = v.w;
      }
    }
#pragma unroll
    for (int t = 0; t < NTILE; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[t][e] *= dec;
#pragma unroll 1
    for (int kb = 0; kb < 4; ++kb) {
      // xa holds tokens 16 kb + 2 tq (+1) (regs 0, 1) and 16 kb + 8 +
      // 2 tq (+1) (regs 2, 3)
      uint32_t xa[4], ah[4], al[4];
      load_xa(xa, kb);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int tok = 16 * kb + 8 * (r >> 1) + 2 * tq;
        const float2 v = unpack(xa[r]);
        split(v.x * wdec[tok], v.y * wdec[tok + 1], ah[r], al[r]);
      }
#pragma unroll
      for (int np = 0; np < NTILE / 2; ++np) {
        if (64 * hf + 16 * np >= N) break;
        uint32_t bf[4];
        const int m = lane >> 3;
        ldsm4t(bf, Bs + (16 * kb + (lane & 7) + 8 * (m & 1)) * BS +
                       64 * hf + 16 * np + 8 * (m >> 1));
        mma(h[2 * np], ah, bf[0], bf[1]);
        mma(h[2 * np + 1], ah, bf[2], bf[3]);
        mma(h[2 * np], al, bf[0], bf[1]);
        mma(h[2 * np + 1], al, bf[2], bf[3]);
      }
    }
  }

  if (Y) {
    __syncthreads();
    if (c_end > c_begin) store_y((c_end - 1) * Q);
    if (piece == a.pieces - 1) {
#pragma unroll
      for (int t = 0; t < NTILE; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + 8 * t + (e & 1), p = p0 + 8 * (e >> 1);
          if (n < N && p < P) a.st[(bh * N + n) * P + p] = h[t][e];
        }
    }
  } else {
    float4* pt = reinterpret_cast<float4*>(a.part + (slot + piece) * PART)
                 + tid;
#pragma unroll
    for (int t = 0; t < NTILE; ++t)
      pt[t * NT] = make_float4(h[t][0], h[t][1], h[t][2], h[t][3]);
    if (tid == 0) a.dec[slot + piece] = dprod;
  }
}

int run(const Args& a, int BH, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_tc_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_tc_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (e != cudaSuccess) return (int)e;
  if (a.pieces > 1)
    ssd_tc_kernel<false><<<dim3(a.pieces - 1, BH), NT, SMEM, st>>>(a);
  ssd_tc_kernel<true><<<dim3(a.pieces, BH), NT, SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); la, st0 and st are f32.
// Requires N <= 128, P <= 64, BH % r == 0, BH <= 65535.  bf16 also takes
// the split of each row (pieces, 64-token chunks per piece), scratch for
// the carried states (part: (BH, pieces - 1, 8192) f32, dec: (BH, pieces -
// 1) f32; null when pieces is 1), 16-byte aligned x / B / C rows, and
// yvec = 1 where y's rows are 16-byte aligned with P % 8 == 0.  Returns
// cudaGetLastError() after the launches.
extern "C" int ssd_launch(int dtype, const void* x, const float* la,
                          const void* B, const void* C, const float* st0,
                          void* y, float* st, long long sxb, long long sxs,
                          long long slb, long long sls, long long sbb,
                          long long sbs, long long scb, long long scs,
                          long long syb, long long sys, int BH, int S, int N,
                          int P, int r, int pieces, int cpp, float* part,
                          float* dec, int yvec, void* stream) {
  if (N < 1 || N > NM || P < 1 || P > PM || r < 1 || BH % r || BH > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.la = la; a.B = B; a.C = C; a.st0 = st0; a.y = y; a.st = st;
  a.sxb = sxb; a.sxs = sxs; a.slb = slb; a.sls = sls;
  a.sbb = sbb; a.sbs = sbs; a.scb = scb; a.scs = scs;
  a.syb = syb; a.sys = sys;
  a.S = S; a.N = N; a.P = P; a.r = r;
  a.pieces = pieces; a.cpp = cpp; a.part = part; a.dec = dec;
  a.yvec = yvec;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return ssd_f32_run(a, BH, s);
  if (dtype == 1) {
    if (pieces < 1 || (pieces > 1 && (part == nullptr || dec == nullptr)))
      return (int)cudaErrorInvalidValue;
    return tc::run(a, BH, s);
  }
  return (int)cudaErrorInvalidValue;
}
