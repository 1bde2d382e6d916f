// flash_attention_bwd: the backward pass of flash_attention (dQ, dK, dV
// from dO, with the forward's O and f32 row log-sum-exp), causal and/or
// sliding-window masks, queries right-aligned to the keys (qpos = i + Sk -
// Sq), GQA read in place (query head h reads KV head h / G).
//
// Counterpart of src/repro/kernels/flash_ref.py:150 (_bwd_vjp, the jnp
// custom VJP of flash_attention_ref that the reference's training path
// differentiates through; jnp, not a Pallas kernel).
//
// The flash rule: P = exp(S scale - LSE) recomputed from the saved LSE,
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - delta) scale,
//   dQ = dS K,    dK = dS^T Q,   delta = rowsum(dO O).
//
// Three launches, no float atomics, every sum in one fixed order, so two
// runs give the same bits:
//   (a) fab_delta: delta (B, H, Sq) f32, one warp a row (lanes over d,
//       then a butterfly);
//   (b) dK/dV: one CTA per (batch, KV head, 64-key block).  It holds the
//       block's K and V, walks the G query heads of its KV head and their
//       64-row query blocks in ascending order (only the blocks the masks
//       leave live), recomputes S, P, dP and dS for each, and sums dV and
//       dK on chip, written once at the end;
//   (c) dQ: one CTA per (batch, head, 64-row query block), walking the
//       live key blocks in ascending order, dQ in registers.
// (b) and (c) both recompute S and dP, where one pass that shared them
// through atomics would not: determinism costs the two extra products.
//
// What bounds it on the H100: operations (5 block products of 64 x 64 x D
// a live (query block, key block) pair: S, dP, dV, dK, dQ).
//
// bf16 (fab_tc_dkdv / fab_tc_dq, one a head dim): Hopper's tensor cores,
// one warpgroup (128 threads) a CTA, the forward's primitives
// (flash_tc.cuh: wgmma, TMA into 128-byte-swizzled 64 x 64 boxes,
// mbarriers).  Every operand tile is a 64-row box set in shared memory;
// head dims below 64 are zero-filled by TMA past D.
//   dK/dV CTA: K and V by TMA once; the G heads' live query blocks in
//     ascending order through a one-stage ring (Q and dO by TMA, the
//     rows' LSE and delta by 4-byte cp.async on the same barrier).  Per
//     block, keys as the MMA's 64 rows:
//       S^T = K Q^T                      wgmma, both operands in shared
//                                        memory, k-steps of 16 over D;
//       P^T = exp(S^T scale - LSE)       f32 in registers, as two bf16
//                                        register-A fragments (the
//                                        accumulator layout of S^T is the
//                                        A layout of the next product);
//       dV += P^T dO                     dO as B with the query rows as the
//                                        depth (MN-major);
//       dP^T = V dO^T, then dS^T = P (dP^T - delta) scale, with P read
//                                        back from its two terms (hi + lo:
//                                        keeping P beside them would cost
//                                        32 registers a thread);
//       dK += dS^T Q                     dS^T as two register-A terms.
//     Each block's dV and dK product (one 64-column box of D at a time)
//     goes into a fresh accumulator and is added to the running sums in
//     f32, round to nearest: dK's in registers, dV's in shared memory (a
//     thread's own slots).  The tensor cores' accumulator does not round
//     to nearest, and a chain over every block of G heads (1400 wgmmas at
//     llava's G = 7, S 1600) drifts past the limit where an element's
//     terms cancel; a chain of one block (8 wgmmas) does not.
//   dQ CTA: Q and dO by TMA once; the live K/V strips in ascending order
//     through a one-stage ring:
//       S = Q K^T, dP = dO V^T           wgmma from shared memory;
//       dQ += dS K                       dS as two register-A terms, K as B
//                                        with the keys as the depth; each
//                                        block's product (a box of D at a
//                                        time) in a fresh accumulator,
//                                        added to the running sum in f32
//                                        as dK's, so no chain grows with
//                                        the sequence.
// P and dS are f32 values; each enters its product as two bf16 terms, hi =
// bf16(x) and lo = bf16(x - hi) (~16 of x's 24 bits; the remainder is
// exact in f32), both multiplied into the same f32 accumulator.  One term
// (x cast to bf16, what SDPA does) errs ~2^-9 relative per element and
// misses the backward's limit (one bf16 ulp of the result plus 1e-4 of
// the gradient's rms) by far; with two the error per term is ~2^-17,
// well under the 1e-4 rms floor, so the rounding of the bf16 result
// dominates (tests/test_torch_tc_numerics.py emulates both).  The forward
// needs three terms only because its limit's floor is 2^-20 absolute.
// So the tensor cores do 1 + 1 + 2 + 2 = 6 products a live pair in dK/dV
// and 1 + 1 + 2 = 4 in dQ: 10 against the work's 5.  exp is one FFMA and
// one MUFU.EX2 (2^(s scale log2 e - LSE log2 e)); a block that every
// row's mask leaves whole skips the mask.  Both grids launch the heaviest
// CTAs first under a causal mask (dK/dV: the lowest key blocks; dQ: the
// latest query blocks), so the light ones fill the last wave.
//
// f32 (fab_dkdv / fab_dq): the CUDA cores (on the tensor cores f32 would be
// TF32, another function): a 256-thread CTA, 64 x 64 blocks, each thread a
// 4 x 4 micro-tile of S and dP (sequential d-chains) and a slice of dK /
// dV or dQ: each block's product a sequential chain over its 64 rows or
// keys of its own, added to the running sum in f32 as the bf16 kernels do
// (a window of 1024 keys and G = 5 heads sums 80 blocks, where one chain
// of 5120 terms would round at the running sum's magnitude every step).
#include "flash_tc.cuh"

namespace fab {

constexpr int NT = 256;           // threads per CTA
constexpr int QB = 64;            // query rows per block
constexpr int KB = 64;            // keys per block
constexpr int DEAD_QPOS = -(1 << 29);   // a padded row: sees no key

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Strides in elements: batch, position, head (head_dim contiguous).
struct Str {
  long long b, s, h;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;     // (B, H, Sq)
  float* delta;         // (B, H, Sq)
  Str sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, KVH, G, Sq, Sk, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  bool ok = kpos < a.Sk;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && kpos > qpos - a.window;
  return ok;
}

// (a) delta = rowsum(dO * O) in f32, one warp a row.
template <typename T, int D>
__global__ void __launch_bounds__(NT) fab_delta(Args a) {
  const int warp = (blockIdx.x * NT + threadIdx.x) / 32, lane = threadIdx.x % 32;
  const int H = a.KVH * a.G;
  if (warp >= a.B * H * a.Sq) return;
  const int i = warp % a.Sq, h = (warp / a.Sq) % H, b = warp / (a.Sq * H);
  const T* o = reinterpret_cast<const T*>(a.o) + b * a.so.b + i * a.so.s
               + h * a.so.h;
  const T* g = reinterpret_cast<const T*>(a.dout) + b * a.sdo.b
               + i * a.sdo.s + h * a.sdo.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = __fmaf_rn(to_f(g[d]), to_f(o[d]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
  if (lane == 0) a.delta[warp] = acc;
}

// Shared-memory tiles (f32, rows padded by one for conflict-free columns).
template <int D>
struct Smem {
  static constexpr int DP = D + 1, SP = KB + 1;
  static constexpr size_t bytes =
      (size_t)4 * (2 * KB * DP + 2 * QB * DP + 2 * QB * SP + 3 * QB);
};

template <int D>
struct Blk {
  static constexpr int DP = D + 1, SP = KB + 1;
  // S / dP micro-tiles: 16 key lanes x 16 row groups, 4 x 4 each
  static constexpr int KL = 16, RG = NT / KL, KPT = KB / KL, RPT = QB / RG;
  // accumulation: DL lanes over d x NT / DL groups over keys (or rows)
  static constexpr int DL = D < 32 ? D : 32, DPT = D / DL, GR = NT / DL;
  static constexpr int PER = KB / GR;      // keys (rows) per thread
  static_assert(QB == KB, "one accumulation mapping serves both");

  float *Ks, *Vs, *Qs, *dOs, *Ps, *dSs, *Ls, *Dl;
  int* qp;
  int tid;

  __device__ void init(char* smem) {
    float* f = reinterpret_cast<float*>(smem);
    Ks = f;  f += KB * DP;
    Vs = f;  f += KB * DP;
    Qs = f;  f += QB * DP;
    dOs = f; f += QB * DP;
    Ps = f;  f += QB * SP;
    dSs = f; f += QB * SP;
    Ls = f;  f += QB;
    Dl = f;  f += QB;
    qp = reinterpret_cast<int*>(f);
    tid = threadIdx.x;
  }

  // rows [r0, r0 + n) of a (position-major) operand into dst, zeros past
  // ``lim``
  __device__ void load_rows(float* dst, const float* base, long long ss, int r0,
                            int lim) {
    for (int e = tid; e < QB * D; e += NT) {
      const int r = e / D, d = e % D, R = r0 + r;
      dst[r * DP + d] = R < lim ? base[R * ss + d] : 0.f;
    }
  }

  // K and V rows [k0, k0 + KB) of (b, kvh)
  __device__ void load_kv(const Args& a, int b, int kvh, int k0) {
    load_rows(Ks, reinterpret_cast<const float*>(a.k) + b * a.sk.b
                  + kvh * a.sk.h, a.sk.s, k0, a.Sk);
    load_rows(Vs, reinterpret_cast<const float*>(a.v) + b * a.sv.b
                  + kvh * a.sv.h, a.sv.s, k0, a.Sk);
  }

  // Q and dO rows [i0, i0 + QB) of (b, h), their LSE, delta and positions
  __device__ void load_q(const Args& a, int b, int h, int i0) {
    load_rows(Qs, reinterpret_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h,
              a.sq.s, i0, a.Sq);
    load_rows(dOs, reinterpret_cast<const float*>(a.dout) + b * a.sdo.b
                   + h * a.sdo.h, a.sdo.s, i0, a.Sq);
    const long long row = ((long long)b * a.KVH * a.G + h) * a.Sq;
    for (int r = tid; r < QB; r += NT) {
      const int i = i0 + r;
      const bool in = i < a.Sq;
      Ls[r] = in ? a.lse[row + i] : 0.f;
      Dl[r] = in ? a.delta[row + i] : 0.f;
      qp[r] = in ? i + a.Sk - a.Sq : DEAD_QPOS;
    }
  }

  // P and dS of the loaded (query block, key block k0) into Ps / dSs.
  __device__ void probs(const Args& a, int k0, bool want_p) {
    const int kl = tid % KL, rg = tid / KL;
    float s[RPT][KPT], dp[RPT][KPT];
#pragma unroll
    for (int v = 0; v < RPT; ++v)
#pragma unroll
      for (int u = 0; u < KPT; ++u) s[v][u] = dp[v][u] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[KPT], vv[KPT];
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        kv[u] = Ks[(kl + KL * u) * DP + d];
        vv[u] = Vs[(kl + KL * u) * DP + d];
      }
#pragma unroll
      for (int v = 0; v < RPT; ++v) {
        const float qv = Qs[(rg + RG * v) * DP + d];
        const float gv = dOs[(rg + RG * v) * DP + d];
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          s[v][u] = __fmaf_rn(qv, kv[u], s[v][u]);
          dp[v][u] = __fmaf_rn(gv, vv[u], dp[v][u]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < RPT; ++v) {
      const int r = rg + RG * v;
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const int j = kl + KL * u;
        const float p = qp[r] != DEAD_QPOS && visible(a, qp[r], k0 + j)
            ? expf(__fsub_rn(__fmul_rn(s[v][u], a.scale), Ls[r])) : 0.f;
        if (want_p) Ps[r * SP + j] = p;
        dSs[r * SP + j] =
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[v][u], Dl[r])), a.scale);
      }
    }
  }
};

// -- f32: the CUDA-core kernels ---------------------------------------------
// (b) dK, dV of one 64-key block of (b, kvh), over the G heads' query
// blocks in ascending order.
template <int D>
__global__ void __launch_bounds__(NT, 1) fab_dkdv(Args a) {
  extern __shared__ __align__(16) char smem[];
  using BB = Blk<D>;
  BB t;
  t.init(smem);
  const int k0 = blockIdx.x * KB, bkv = blockIdx.y;
  const int b = bkv / a.KVH, kvh = bkv % a.KVH;
  const int off = a.Sk - a.Sq, k1 = min(k0 + KB, a.Sk);
  // the query rows that see a key of [k0, k1)
  int i_lo = a.causal ? max(0, k0 - off) : 0;
  int i_hi = a.window > 0 ? min(a.Sq, k1 - 1 - off + a.window) : a.Sq;
  const int dl = t.tid % BB::DL, gr = t.tid / BB::DL;
  float dk[BB::PER][BB::DPT], dv[BB::PER][BB::DPT];
#pragma unroll
  for (int u = 0; u < BB::PER; ++u)
#pragma unroll
    for (int w = 0; w < BB::DPT; ++w) dk[u][w] = dv[u][w] = 0.f;
  t.load_kv(a, b, kvh, k0);
  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    for (int i0 = (i_lo / QB) * QB; i0 < i_hi; i0 += QB) {
      __syncthreads();
      t.load_q(a, b, h, i0);
      __syncthreads();
      t.probs(a, k0, true);
      __syncthreads();
      float bk[BB::PER][BB::DPT], bv[BB::PER][BB::DPT];
#pragma unroll
      for (int u = 0; u < BB::PER; ++u)
#pragma unroll
        for (int w = 0; w < BB::DPT; ++w) bk[u][w] = bv[u][w] = 0.f;
      for (int r = 0; r < QB; ++r) {
        float gv[BB::DPT], qv[BB::DPT];
#pragma unroll
        for (int w = 0; w < BB::DPT; ++w) {
          gv[w] = t.dOs[r * BB::DP + dl + BB::DL * w];
          qv[w] = t.Qs[r * BB::DP + dl + BB::DL * w];
        }
#pragma unroll
        for (int u = 0; u < BB::PER; ++u) {
          const float p = t.Ps[r * BB::SP + gr + BB::GR * u];
          const float ds = t.dSs[r * BB::SP + gr + BB::GR * u];
#pragma unroll
          for (int w = 0; w < BB::DPT; ++w) {
            bv[u][w] = __fmaf_rn(p, gv[w], bv[u][w]);
            bk[u][w] = __fmaf_rn(ds, qv[w], bk[u][w]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < BB::PER; ++u)
#pragma unroll
        for (int w = 0; w < BB::DPT; ++w) {
          dv[u][w] = __fadd_rn(dv[u][w], bv[u][w]);
          dk[u][w] = __fadd_rn(dk[u][w], bk[u][w]);
        }
    }
  }
  float* dkp = reinterpret_cast<float*>(a.dk) + b * a.sdk.b + kvh * a.sdk.h;
  float* dvp = reinterpret_cast<float*>(a.dv) + b * a.sdv.b + kvh * a.sdv.h;
#pragma unroll
  for (int u = 0; u < BB::PER; ++u) {
    const int kpos = k0 + gr + BB::GR * u;
    if (kpos >= a.Sk) continue;
#pragma unroll
    for (int w = 0; w < BB::DPT; ++w) {
      const int d = dl + BB::DL * w;
      dkp[kpos * a.sdk.s + d] = dk[u][w];
      dvp[kpos * a.sdv.s + d] = dv[u][w];
    }
  }
}

// (c) dQ of one 64-row query block of (b, h), over its live key blocks in
// ascending order.
template <int D>
__global__ void __launch_bounds__(NT, 1) fab_dq(Args a) {
  extern __shared__ __align__(16) char smem[];
  using BB = Blk<D>;
  BB t;
  t.init(smem);
  const int i0 = blockIdx.x * QB, bh = blockIdx.y;
  const int H = a.KVH * a.G, b = bh / H, h = bh % H, kvh = h / a.G;
  const int off = a.Sk - a.Sq, i1 = min(i0 + QB, a.Sq);
  int k_hi = a.causal ? min(a.Sk, i1 - 1 + off + 1) : a.Sk;
  int k_lo = a.window > 0 ? max(0, i0 + off - a.window + 1) : 0;
  const int dl = t.tid % BB::DL, gr = t.tid / BB::DL;
  float dq[BB::PER][BB::DPT];
#pragma unroll
  for (int u = 0; u < BB::PER; ++u)
#pragma unroll
    for (int w = 0; w < BB::DPT; ++w) dq[u][w] = 0.f;
  t.load_q(a, b, h, i0);
  for (int k0 = (k_lo / KB) * KB; k0 < k_hi; k0 += KB) {
    __syncthreads();
    t.load_kv(a, b, kvh, k0);
    __syncthreads();
    t.probs(a, k0, false);
    __syncthreads();
    float bq[BB::PER][BB::DPT];
#pragma unroll
    for (int u = 0; u < BB::PER; ++u)
#pragma unroll
      for (int w = 0; w < BB::DPT; ++w) bq[u][w] = 0.f;
    for (int j = 0; j < KB; ++j) {
      float kv[BB::DPT];
#pragma unroll
      for (int w = 0; w < BB::DPT; ++w)
        kv[w] = t.Ks[j * BB::DP + dl + BB::DL * w];
#pragma unroll
      for (int u = 0; u < BB::PER; ++u) {
        const float ds = t.dSs[(gr + BB::GR * u) * BB::SP + j];
#pragma unroll
        for (int w = 0; w < BB::DPT; ++w)
          bq[u][w] = __fmaf_rn(ds, kv[w], bq[u][w]);
      }
    }
#pragma unroll
    for (int u = 0; u < BB::PER; ++u)
#pragma unroll
      for (int w = 0; w < BB::DPT; ++w)
        dq[u][w] = __fadd_rn(dq[u][w], bq[u][w]);
  }
  float* dqp = reinterpret_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int u = 0; u < BB::PER; ++u) {
    const int i = i0 + gr + BB::GR * u;
    if (i >= a.Sq) continue;
#pragma unroll
    for (int w = 0; w < BB::DPT; ++w)
      dqp[i * a.sdq.s + dl + BB::DL * w] = dq[u][w];
  }
}


// -- bf16: the tensor-core kernels -------------------------------------------
namespace tcb {

using fk::tc::BOX;
using fk::tc::BOX_BYTES;
constexpr int TNT = fk::NT;       // one warpgroup a CTA
constexpr int BLK = 64;           // rows of every tile (the MMA's M)
// Ring stages: one.  At D = 128 a second stage (32 KB) costs a CTA an SM
// (two dK/dV CTAs become one, three dQ CTAs two), and the CTAs an SM hide
// each other's loads better than a CTA's own prefetch does.
constexpr int NST = 1;

template <int D>
struct Cfg {
  static constexpr int NB = D <= 64 ? 1 : D / 64;    // boxes a row
  static constexpr int KST = (D + 15) / 16;          // k-steps over D
  static constexpr int TILE = NB * BOX_BYTES;        // one 64-row operand
  // dK/dV: K, V; NST stages of (Q, dO) and of 64 LSE + 64 delta floats
  static constexpr size_t smem_dkdv =
      1024 + 2 * TILE + NST * (2 * TILE + 2 * BLK * 4) + NB * 32 * TNT * 4
      + 8 * (NST + 1);
  // dQ: Q, dO; NST stages of (K, V)
  static constexpr size_t smem_dq =
      1024 + 2 * TILE + NST * 2 * TILE + 8 * (NST + 1);
};

// Batch coordinate multipliers of the four maps (0: a broadcast batch).
struct Mul {
  int q, g, k, v;
};

__device__ __forceinline__ char* align1024(char* p) {
  return reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(p) + 1023)
                                 & ~uintptr_t(1023));
}

// The NB boxes of one 64-row tile (rows from ``row``) of a 4-D map into dst.
template <int NB>
__device__ __forceinline__ void tile_load(char* dst, const CUtensorMap* m,
                                          uint64_t* bar, int row, int head,
                                          int batch) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
    fk::tc::tma_load(dst + j * BOX_BYTES, m, bar, j * BOX, row, head, batch);
}

// x (an m64n64 accumulator, a thread's 32 floats) as two bf16 terms of
// register-A fragments: k-step kk covers accumulator columns [16 kk, 16 kk
// + 16), x[8 kk .. 8 kk + 8); term 1 is bf16(x), term 2 the bf16 rounding
// of the exact remainder.
__device__ __forceinline__ void split2(const float (&x)[32],
                                       uint32_t (&af)[2][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r0 = x[8 * kk + 2 * e], r1 = x[8 * kk + 2 * e + 1];
      const uint32_t hi = fk::tc::pack_bf16(r0, r1);
      af[0][kk][e] = hi;
      af[1][kk][e] = fk::tc::pack_bf16(
          __fsub_rn(r0, __uint_as_float(hi << 16)),
          __fsub_rn(r1, __uint_as_float(hi & 0xffff0000u)));
    }
}

// acc[64 x N] += A[64 x 64] B[64 x N], A as two bf16 terms in registers,
// B a 64-row tile in shared memory whose rows are the depth (MN-major);
// waits for the products, then keeps the fragments live until they have
// been read.
template <int R>
__device__ __forceinline__ void rs_product(float (&acc)[R],
                                           uint32_t (&af)[2][4][4],
                                           const char* b) {
  fk::tc::fence_regs(acc);
  fk::tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = fk::tc::desc_sw128(b + kk * 16 * 128, BOX_BYTES, 1024);
#pragma unroll
    for (int tm = 0; tm < 2; ++tm) fk::tc::wgmma_rs(acc, af[tm][kk], db);
  }
  fk::tc::wg_commit_wait();
  fk::tc::fence_regs(acc);
#pragma unroll
  for (int tm = 0; tm < 2; ++tm)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" : "+r"(af[tm][kk][e])::"memory");
}

// tot[64 x 64] += A[64 x 64] B[64 x 64] as an f32 sum of its own: the
// block's product (8 wgmmas) into a fresh accumulator, then one
// round-to-nearest add an element (see the header: the tensor cores'
// accumulator drifts over long chains).
__device__ __forceinline__ void block_sum(float (&tot)[32], float (&tmp)[32],
                                          uint32_t (&af)[2][4][4],
                                          const char* b) {
#pragma unroll
  for (int x = 0; x < 32; ++x) tmp[x] = 0.f;
  rs_product(tmp, af, b);
#pragma unroll
  for (int x = 0; x < 32; ++x) tot[x] = __fadd_rn(tot[x], tmp[x]);
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x (MUFU.EX2, ~2 ulp; 0 below 2^-126).  P = exp(s scale - LSE) =
// 2^(s scale log2 e - LSE log2 e): one FFMA and one EX2.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Does the 64 x 64 block (queries from i0, keys from j0) see every key of
// every row?  Then its probabilities need no mask.
__device__ __forceinline__ bool all_visible(const Args& a, int i0, int j0) {
  const int off = a.Sk - a.Sq;
  return j0 + BLK <= a.Sk && i0 + BLK <= a.Sq
         && (!a.causal || j0 + BLK - 1 <= i0 + off)
         && (a.window <= 0 || j0 > i0 + BLK - 1 + off - a.window);
}

// P^T of a dK/dV block in place of S^T: element x = 4 c + 2 i + j is key
// j0 + row0 + 8 i, query row i0 + 8 c + cq + j; ``lse`` the block's rows'
// LSE.  FULL: no element is masked.
template <bool FULL>
__device__ __forceinline__ void probs_t(float (&t)[32], const Args& a,
                                        const float* lse, int i0, int j0,
                                        int row0, int cq, float sl2) {
  const int off = a.Sk - a.Sq;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int x = 4 * c + 2 * i + j, col = 8 * c + cq + j;
        const float p = ex2(__fmaf_rn(t[x], sl2, -LOG2E * lse[col]));
        if (FULL)
          t[x] = p;
        else
          t[x] = i0 + col < a.Sq
                 && visible(a, i0 + col + off, j0 + row0 + 8 * i) ? p : 0.f;
      }
}

// dS of a dQ block in place of dP, from S: element x = 4 c + 2 i + j is
// query row row0 + 8 i (position qpos[i], -LSE log2 e nl[i], delta dl[i]),
// key j0 + 8 c + cq + j.
template <bool FULL>
__device__ __forceinline__ void dscores(float (&dp)[32], const float (&s)[32],
                                        const Args& a, const int (&qpos)[2],
                                        const float (&nl)[2],
                                        const float (&dl)[2], int j0, int cq,
                                        float sl2) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int x = 4 * c + 2 * i + j;
        float p = ex2(__fmaf_rn(s[x], sl2, nl[i]));
        if (!FULL && !(qpos[i] != DEAD_QPOS
                       && visible(a, qpos[i], j0 + 8 * c + cq + j)))
          p = 0.f;
        dp[x] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[x], dl[i])), a.scale);
      }
}

// The value the two terms of element x (k-step x / 8, register (x % 8) /
// 2, half x % 2) hold: hi + lo, exact in f32.
__device__ __forceinline__ float terms_value(const uint32_t (&af)[2][4][4],
                                             int x) {
  const int kk = x / 8, e = (x % 8) / 2;
  const uint32_t h = af[0][kk][e], l = af[1][kk][e];
  return x % 2 ? __fadd_rn(__uint_as_float(h & 0xffff0000u),
                           __uint_as_float(l & 0xffff0000u))
               : __fadd_rn(__uint_as_float(h << 16), __uint_as_float(l << 16));
}

// Start s = A B^T over D (k-steps of 16; the first overwrites s), both
// operands 64-row tiles in shared memory with D as their contiguous axis
// (K-major).
template <int D>
__device__ __forceinline__ void ss_start(float (&s)[32], const char* a,
                                         const char* b) {
#pragma unroll
  for (int kk = 0; kk < Cfg<D>::KST; ++kk) {
    const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    fk::tc::wgmma_ss64(s, fk::tc::desc_sw128(a + off, 16, 1024),
                       fk::tc::desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// s = A B^T, waited for.
template <int D>
__device__ __forceinline__ void ss_product(float (&s)[32], const char* a,
                                           const char* b) {
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = 0.f;
  fk::tc::wg_fence();
  ss_start<D>(s, a, b);
  fk::tc::wg_commit_wait();
  fk::tc::fence_regs(s);
}

// s = A B^T and dp = C E^T, started together and waited for.
template <int D>
__device__ __forceinline__ void ss_pair(float (&s)[32], float (&dp)[32],
                                        const char* a, const char* b,
                                        const char* c, const char* e) {
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
  fk::tc::wg_fence();
  ss_start<D>(s, a, b);
  ss_start<D>(dp, c, e);
  fk::tc::wg_commit_wait();
  fk::tc::fence_regs(s);
  fk::tc::fence_regs(dp);
}

// Rows [r0, r0 + 64) x D of an accumulator (rows row0 + 8 i, columns 8 c +
// 2 (lane % 4) + j of the wgmma layout) into dst (row stride ``rs``),
// rounded to bf16 once; rows past ``lim`` are not written.
template <int D, int R>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long rs,
                                           const float (&acc)[R], int r0,
                                           int lim) {
  const int lane = threadIdx.x % 32, cq = 2 * (lane % 4);
  const int row0 = (threadIdx.x / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + row0 + 8 * i;
    if (r >= lim) continue;
#pragma unroll
    for (int c = 0; c < R / 4; ++c) {
      const int col = 8 * c + cq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + r * rs + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
    }
  }
}

// The live query blocks of key block [k0, k0 + 64): [first, first + n).
__device__ __forceinline__ void query_blocks(const Args& a, int k0,
                                             int* first, int* n) {
  const int off = a.Sk - a.Sq, k1 = min(k0 + BLK, a.Sk);
  const int i_lo = a.causal ? max(0, k0 - off) : 0;
  const int i_hi = a.window > 0 ? min(a.Sq, k1 - 1 - off + a.window) : a.Sq;
  *first = i_lo / BLK;
  *n = max(0, (i_hi + BLK - 1) / BLK - *first);
}

// The live key blocks of query block [i0, i0 + 64): [first, first + n).
__device__ __forceinline__ void key_blocks(const Args& a, int i0, int* first,
                                           int* n) {
  const int off = a.Sk - a.Sq, i1 = min(i0 + BLK, a.Sq);
  const int k_hi = a.causal ? min(a.Sk, i1 + off) : a.Sk;
  const int k_lo = a.window > 0 ? max(0, i0 + off - a.window + 1) : 0;
  *first = k_lo / BLK;
  *n = max(0, (k_hi + BLK - 1) / BLK - *first);
}

// (b) dK, dV of one 64-key block of (b, kvh), over the G heads' live query
// blocks in ascending order.  Each block's product goes into a fresh
// accumulator and is added to the running sums in f32 (block_sum), one
// 64-column box of D at a time, so the registers hold the running sums
// (32 floats a thread for each of dK and dV a box), one block's product
// (32) and the fragments.
template <int D>
__global__ void __launch_bounds__(TNT)
fab_tc_dkdv(Args a, const __grid_constant__ CUtensorMap mq,
            const __grid_constant__ CUtensorMap mg,
            const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv, Mul bm) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) char smem_raw[];
  char* k_s = align1024(smem_raw);
  char* v_s = k_s + C::TILE;
  char* ring = v_s + C::TILE;                    // stage: Q tile, dO tile
  float* stats = reinterpret_cast<float*>(ring + NST * 2 * C::TILE);
  // dV's running sums: elements 4 x .. 4 x + 3 of box hf of thread t at
  // float4 [(hf * 8 + x) * 128 + t] (a thread's own, conflict-free)
  float4* dv_s = reinterpret_cast<float4*>(stats + NST * 2 * BLK);
  uint64_t* bar = reinterpret_cast<uint64_t*>(dv_s + C::NB * 8 * TNT);
  const int tid = threadIdx.x, lane = tid % 32, cq = 2 * (lane % 4);
  const int row0 = (tid / 32) * 16 + lane / 4;
  const int H = a.KVH * a.G;
  const int nbkv = a.B * a.KVH, L = blockIdx.x;
  // heavy first: a causal mask leaves the lowest key blocks the most rows
  const int kb = L / nbkv, bkv = L % nbkv;
  const int b = bkv / a.KVH, kvh = bkv % a.KVH, k0 = kb * BLK;
  const float sl2 = a.scale * LOG2E;
  int first, nib;
  query_blocks(a, k0, &first, &nib);
  const int n = a.G * nib;
  if (tid == 0) {
    // a stage: thread 0's expect_tx and every thread's LSE / delta copy
    for (int s = 0; s < NST; ++s) fk::tc::mbar_init(&bar[s], 1 + TNT);
    fk::tc::mbar_init(&bar[NST], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const CUtensorMap *pq = &mq, *pg = &mg;
  // block u: head kvh * G + u / nib, query rows from (first + u % nib) * 64
  auto load = [&](int u, int st) {
    const int h = kvh * a.G + u / nib, i0 = (first + u % nib) * BLK;
    if (tid == 0) {
      char* q = ring + st * 2 * C::TILE;
      fk::tc::mbar_expect_tx(&bar[st], 2 * C::TILE);
      tile_load<C::NB>(q, pq, &bar[st], i0, h, b * bm.q);
      tile_load<C::NB>(q + C::TILE, pg, &bar[st], i0, h, b * bm.g);
    }
    // threads 0..63 a row's LSE, 64..127 its delta (a row past Sq reads
    // row Sq - 1's: it is masked)
    const int i = min(i0 + tid % BLK, a.Sq - 1);
    const float* src = (tid < BLK ? a.lse : a.delta)
                       + ((long long)b * H + h) * a.Sq + i;
    fk::tc::cp_async4_arrive(stats + st * 2 * BLK + tid, src, &bar[st]);
  };
  float dk[C::NB][32], tmp[32];
#pragma unroll
  for (int hf = 0; hf < C::NB; ++hf)
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      dk[hf][x] = 0.f;
      if (x < 8) dv_s[(hf * 8 + x) * TNT + tid] = make_float4(0, 0, 0, 0);
    }
  if (n > 0) {
    if (tid == 0) {
      fk::tc::mbar_expect_tx(&bar[NST], 2 * C::TILE);
      tile_load<C::NB>(k_s, &mk, &bar[NST], k0, kvh, b * bm.k);
      tile_load<C::NB>(v_s, &mv, &bar[NST], k0, kvh, b * bm.v);
    }
    for (int u = 0; u < NST && u < n; ++u) load(u, u);
    fk::tc::mbar_wait(&bar[NST], 0);
  }
  for (int u = 0; u < n; ++u) {
    const int st = u % NST;
    const int i0 = (first + u % nib) * BLK;
    const char* q_t = ring + st * 2 * C::TILE;
    const char* g_t = q_t + C::TILE;
    const float* lse = stats + st * 2 * BLK;
    const float* dl = lse + BLK;
    fk::tc::mbar_wait(&bar[st], (u / NST) & 1);
    // S^T, then P^T (element x = 4 c + 2 i + j: key k0 + row0 + 8 i, query
    // row i0 + 8 c + cq + j), then its two terms
    float t[32];
    ss_product<D>(t, k_s, q_t);
    if (all_visible(a, i0, k0))
      probs_t<true>(t, a, lse, i0, k0, row0, cq, sl2);
    else
      probs_t<false>(t, a, lse, i0, k0, row0, cq, sl2);
    uint32_t af[2][4][4];
    split2(t, af);
#pragma unroll
    for (int hf = 0; hf < C::NB; ++hf) {            // dV += P^T dO
#pragma unroll
      for (int x = 0; x < 32; ++x) tmp[x] = 0.f;
      rs_product(tmp, af, g_t + hf * BOX_BYTES);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        float4* at = dv_s + (hf * 8 + x) * TNT + tid;
        const float4 o = *at;
        *at = make_float4(__fadd_rn(o.x, tmp[4 * x]),
                          __fadd_rn(o.y, tmp[4 * x + 1]),
                          __fadd_rn(o.z, tmp[4 * x + 2]),
                          __fadd_rn(o.w, tmp[4 * x + 3]));
      }
    }
    // dP^T, then dS^T from the terms' P (hi + lo: P is not kept beside
    // them, for the registers), then its two terms
    ss_product<D>(t, v_s, g_t);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int x = 4 * c + 2 * i + j, col = 8 * c + cq + j;
          t[x] = __fmul_rn(__fmul_rn(terms_value(af, x),
                                     __fsub_rn(t[x], dl[col])), a.scale);
        }
    split2(t, af);
#pragma unroll
    for (int hf = 0; hf < C::NB; ++hf)              // dK += dS^T Q
      block_sum(dk[hf], tmp, af, q_t + hf * BOX_BYTES);
    __syncthreads();                                // the stage is read
    if (u + NST < n) load(u + NST, st);
  }
  __nv_bfloat16* dkp = reinterpret_cast<__nv_bfloat16*>(a.dk) + b * a.sdk.b
                       + kvh * a.sdk.h;
  __nv_bfloat16* dvp = reinterpret_cast<__nv_bfloat16*>(a.dv) + b * a.sdv.b
                       + kvh * a.sdv.h;
#pragma unroll
  for (int hf = 0; hf < C::NB; ++hf) {
    store_rows<(D < 64 ? D : 64)>(dkp + hf * BOX, a.sdk.s, dk[hf], k0, a.Sk);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const float4 o = dv_s[(hf * 8 + x) * TNT + tid];
      tmp[4 * x] = o.x;
      tmp[4 * x + 1] = o.y;
      tmp[4 * x + 2] = o.z;
      tmp[4 * x + 3] = o.w;
    }
    store_rows<(D < 64 ? D : 64)>(dvp + hf * BOX, a.sdv.s, tmp, k0, a.Sk);
  }
}

// (c) dQ of one 64-row query block of (b, h), over its live key blocks in
// ascending order.  As in (b), each block's product goes into a fresh
// accumulator and is added to the running sum in f32 (block_sum), one
// 64-column box of D at a time.
template <int D>
__global__ void __launch_bounds__(TNT)
fab_tc_dq(Args a, const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mg,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv, Mul bm) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) char smem_raw[];
  char* q_s = align1024(smem_raw);
  char* g_s = q_s + C::TILE;
  char* ring = g_s + C::TILE;                    // stage: K tile, V tile
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + NST * 2 * C::TILE);
  const int tid = threadIdx.x, lane = tid % 32, cq = 2 * (lane % 4);
  const int row0 = (tid / 32) * 16 + lane / 4;
  const int H = a.KVH * a.G, nqb = (a.Sq + BLK - 1) / BLK;
  const int nbh = a.B * H, L = blockIdx.x;
  // heavy first: a causal mask leaves the latest query blocks the most keys
  const int qb = nqb - 1 - L / nbh, bh = L % nbh;
  const int b = bh / H, h = bh % H, kvh = h / a.G, i0 = qb * BLK;
  const int off = a.Sk - a.Sq;
  int first, n;
  key_blocks(a, i0, &first, &n);
  if (tid == 0) {
    for (int s = 0; s <= NST; ++s) fk::tc::mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const CUtensorMap *pk = &mk, *pv = &mv;
  auto load = [&](int u, int st) {
    char* k = ring + st * 2 * C::TILE;
    const int j0 = (first + u) * BLK;
    fk::tc::mbar_expect_tx(&bar[st], 2 * C::TILE);
    tile_load<C::NB>(k, pk, &bar[st], j0, kvh, b * bm.k);
    tile_load<C::NB>(k + C::TILE, pv, &bar[st], j0, kvh, b * bm.v);
  };
  float dq[C::NB][32], tmp[32];
#pragma unroll
  for (int hf = 0; hf < C::NB; ++hf)
#pragma unroll
    for (int x = 0; x < 32; ++x) dq[hf][x] = 0.f;
  // this thread's rows row0, row0 + 8: position, -LSE log2 e, delta
  int qpos[2];
  float nl[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = i0 + row0 + 8 * i;
    const long long at = ((long long)b * H + h) * a.Sq + min(qi, a.Sq - 1);
    qpos[i] = qi < a.Sq ? qi + off : DEAD_QPOS;
    nl[i] = -LOG2E * a.lse[at];
    dl[i] = a.delta[at];
  }
  const float sl2 = a.scale * LOG2E;
  if (n > 0) {
    if (tid == 0) {
      fk::tc::mbar_expect_tx(&bar[NST], 2 * C::TILE);
      tile_load<C::NB>(q_s, &mq, &bar[NST], i0, h, b * bm.q);
      tile_load<C::NB>(g_s, &mg, &bar[NST], i0, h, b * bm.g);
      for (int u = 0; u < NST && u < n; ++u) load(u, u);
    }
    fk::tc::mbar_wait(&bar[NST], 0);
  }
  for (int u = 0; u < n; ++u) {
    const int st = u % NST, j0 = (first + u) * BLK;
    const char* k_t = ring + st * 2 * C::TILE;
    const char* v_t = k_t + C::TILE;
    fk::tc::mbar_wait(&bar[st], (u / NST) & 1);
    float s[32], dp[32];
    ss_pair<D>(s, dp, q_s, k_t, g_s, v_t);          // S, dP
    if (all_visible(a, i0, j0))
      dscores<true>(dp, s, a, qpos, nl, dl, j0, cq, sl2);
    else
      dscores<false>(dp, s, a, qpos, nl, dl, j0, cq, sl2);
    uint32_t af[2][4][4];
    split2(dp, af);
#pragma unroll
    for (int hf = 0; hf < C::NB; ++hf)              // dQ += dS K
      block_sum(dq[hf], tmp, af, k_t + hf * BOX_BYTES);
    __syncthreads();                                // the stage is read
    if (u + NST < n && tid == 0) load(u + NST, st);
  }
  __nv_bfloat16* dqp = reinterpret_cast<__nv_bfloat16*>(a.dq) + b * a.sdq.b
                       + h * a.sdq.h;
#pragma unroll
  for (int hf = 0; hf < C::NB; ++hf)
    store_rows<(D < 64 ? D : 64)>(dqp + hf * BOX, a.sdq.s, dq[hf], i0, a.Sq);
}

}  // namespace tcb

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
int launch_delta(const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.B * a.KVH * a.G * a.Sq;
  fab_delta<T, D><<<(unsigned)((rows * 32 + NT - 1) / NT), NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// f32: the CUDA-core kernels.
template <int D>
int run_f32(const Args& a, cudaStream_t st) {
  int e = launch_delta<float, D>(a, st);
  if (e) return e;
  const size_t smem = Smem<D>::bytes;
  if ((e = (int)allow_smem(fab_dkdv<D>, smem))) return e;
  if ((e = (int)allow_smem(fab_dq<D>, smem))) return e;
  fab_dkdv<D><<<dim3((a.Sk + KB - 1) / KB, a.B * a.KVH), NT, smem, st>>>(a);
  if ((e = (int)cudaGetLastError())) return e;
  fab_dq<D><<<dim3((a.Sq + QB - 1) / QB, a.B * a.KVH * a.G), NT, smem, st>>>(
      a);
  return (int)cudaGetLastError();
}

// bf16: the delta pass, then the tensor-core kernels over four tensor maps
// (D, position, head, batch) read in place through the operands' strides.
template <int D>
int run_tc(const Args& a, cudaStream_t st) {
  using C = tcb::Cfg<D>;
  const int H = a.KVH * a.G;
  // the delta pass first: its launch binds the device's context to this
  // host thread, which cuTensorMapEncodeTiled needs (an autograd worker
  // thread may reach this launch before any other CUDA call)
  int e = launch_delta<__nv_bfloat16, D>(a, st);
  if (e) return e;
  CUtensorMap mq, mg, mk, mv;
  tcb::Mul bm;
  if ((e = fk::tc::make_kv_map(&mq, a.q, D, a.Sq, H, a.B, a.sq.s, a.sq.h,
                               a.sq.b, &bm.q))
      || (e = fk::tc::make_kv_map(&mg, a.dout, D, a.Sq, H, a.B, a.sdo.s,
                                  a.sdo.h, a.sdo.b, &bm.g))
      || (e = fk::tc::make_kv_map(&mk, a.k, D, a.Sk, a.KVH, a.B, a.sk.s,
                                  a.sk.h, a.sk.b, &bm.k))
      || (e = fk::tc::make_kv_map(&mv, a.v, D, a.Sk, a.KVH, a.B, a.sv.s,
                                  a.sv.h, a.sv.b, &bm.v)))
    return e;
  if ((e = (int)allow_smem(tcb::fab_tc_dkdv<D>, C::smem_dkdv))) return e;
  if ((e = (int)allow_smem(tcb::fab_tc_dq<D>, C::smem_dq))) return e;
  const int nkb = (a.Sk + tcb::BLK - 1) / tcb::BLK;
  const int nqb = (a.Sq + tcb::BLK - 1) / tcb::BLK;
  tcb::fab_tc_dkdv<D><<<nkb * a.B * a.KVH, tcb::TNT, C::smem_dkdv, st>>>(
      a, mq, mg, mk, mv, bm);
  if ((e = (int)cudaGetLastError())) return e;
  tcb::fab_tc_dq<D><<<nqb * a.B * H, tcb::TNT, C::smem_dq, st>>>(
      a, mq, mg, mk, mv, bm);
  return (int)cudaGetLastError();
}

template <int D>
int run(int dtype, const Args& a, cudaStream_t st) {
  if (dtype == 0) return run_f32<D>(a, st);
  if (dtype == 1) return run_tc<D>(a, st);
  return (int)cudaErrorInvalidValue;
}

int run_hd(int dtype, int hd, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 8: return run<8>(dtype, a, st);
    case 16: return run<16>(dtype, a, st);
    case 32: return run<32>(dtype, a, st);
    case 64: return run<64>(dtype, a, st);
    case 128: return run<128>(dtype, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace fab

// q, o, dout, dq (B, H, Sq, D); k, v, dk, dv (B, KVH, Sk, D); each by its
// strides (batch, position, head), head_dim contiguous; lse (B, H, Sq) f32
// from the forward, delta (B, H, Sq) f32 scratch.  dtype 0 float32, 1
// bfloat16 (every tensor operand the one type; dq / dk / dv written in it;
// bf16 needs 16-byte aligned bases and position / head / batch strides, the
// TMA maps').
extern "C" int fab_launch(int dtype, int hd, const void* q, const void* k,
                          const void* v, const void* o, const void* dout,
                          void* dq, void* dk, void* dv, const float* lse,
                          float* delta, const long long* strides, int B,
                          int KVH, int G, int Sq, int Sk, int causal,
                          int window, float scale, void* stream) {
  fab::Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv; a.lse = lse; a.delta = delta;
  fab::Str* s[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo, &a.sdq, &a.sdk,
                    &a.sdv};
  for (int x = 0; x < 8; ++x) {
    s[x]->b = strides[3 * x];
    s[x]->s = strides[3 * x + 1];
    s[x]->h = strides[3 * x + 2];
  }
  a.B = B; a.KVH = KVH; a.G = G; a.Sq = Sq; a.Sk = Sk;
  a.causal = causal; a.window = window; a.scale = scale;
  return fab::run_hd(dtype, hd, a, reinterpret_cast<cudaStream_t>(stream));
}
