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
//   (b) fab_dkdv: one CTA per (batch, KV head, 64-key block).  It holds
//       the block's K and V, walks the G query heads of its KV head and
//       their 64-row query blocks in ascending order (only the blocks the
//       masks leave live), recomputes S, P, dP and dS for each, and sums
//       dV and dK in registers, written once at the end;
//   (c) fab_dq: one CTA per (batch, head, 64-row query block), walking
//       the live key blocks in ascending order, dQ in registers.
// (b) and (c) both recompute S and dP: 7 block products per live pair
// instead of the 5 of a pass that shared them through atomics.
//
// What bounds it on the H100: operations.  This first version runs on the
// CUDA cores in f32 (bf16 operands widened as they are loaded into shared
// memory, results rounded to the operand type once): a 256-thread CTA, 64 x
// 64 blocks, each thread a 4 x 4 micro-tile of S and dP (sequential
// d-chains) and a slice of dK / dV or dQ (sequential chains over the
// block's rows or keys).  Tensor cores (mma.sync / wgmma) are the later
// redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fab {

constexpr int NT = 256;           // threads per CTA
constexpr int QB = 64;            // query rows per block
constexpr int KB = 64;            // keys per block
constexpr int DEAD_QPOS = -(1 << 29);   // a padded row: sees no key

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

template <typename T, int D>
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

  // rows [r0, r0 + n) of a (position-major) operand into dst, widened,
  // zeros past ``lim``
  __device__ void load_rows(float* dst, const T* base, long long ss, int r0,
                            int lim) {
    for (int e = tid; e < QB * D; e += NT) {
      const int r = e / D, d = e % D, R = r0 + r;
      dst[r * DP + d] = R < lim ? to_f(base[R * ss + d]) : 0.f;
    }
  }

  // K and V rows [k0, k0 + KB) of (b, kvh)
  __device__ void load_kv(const Args& a, int b, int kvh, int k0) {
    load_rows(Ks, reinterpret_cast<const T*>(a.k) + b * a.sk.b
                  + kvh * a.sk.h, a.sk.s, k0, a.Sk);
    load_rows(Vs, reinterpret_cast<const T*>(a.v) + b * a.sv.b
                  + kvh * a.sv.h, a.sv.s, k0, a.Sk);
  }

  // Q and dO rows [i0, i0 + QB) of (b, h), their LSE, delta and positions
  __device__ void load_q(const Args& a, int b, int h, int i0) {
    load_rows(Qs, reinterpret_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h,
              a.sq.s, i0, a.Sq);
    load_rows(dOs, reinterpret_cast<const T*>(a.dout) + b * a.sdo.b
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

// (b) dK, dV of one 64-key block of (b, kvh), over the G heads' query
// blocks in ascending order.
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) fab_dkdv(Args a) {
  extern __shared__ __align__(16) char smem[];
  using BB = Blk<T, D>;
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
            dv[u][w] = __fmaf_rn(p, gv[w], dv[u][w]);
            dk[u][w] = __fmaf_rn(ds, qv[w], dk[u][w]);
          }
        }
      }
    }
  }
  T* dkp = reinterpret_cast<T*>(a.dk) + b * a.sdk.b + kvh * a.sdk.h;
  T* dvp = reinterpret_cast<T*>(a.dv) + b * a.sdv.b + kvh * a.sdv.h;
#pragma unroll
  for (int u = 0; u < BB::PER; ++u) {
    const int kpos = k0 + gr + BB::GR * u;
    if (kpos >= a.Sk) continue;
#pragma unroll
    for (int w = 0; w < BB::DPT; ++w) {
      const int d = dl + BB::DL * w;
      dkp[kpos * a.sdk.s + d] = from_f<T>(dk[u][w]);
      dvp[kpos * a.sdv.s + d] = from_f<T>(dv[u][w]);
    }
  }
}

// (c) dQ of one 64-row query block of (b, h), over its live key blocks in
// ascending order.
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) fab_dq(Args a) {
  extern __shared__ __align__(16) char smem[];
  using BB = Blk<T, D>;
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
          dq[u][w] = __fmaf_rn(ds, kv[w], dq[u][w]);
      }
    }
  }
  T* dqp = reinterpret_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int u = 0; u < BB::PER; ++u) {
    const int i = i0 + gr + BB::GR * u;
    if (i >= a.Sq) continue;
#pragma unroll
    for (int w = 0; w < BB::DPT; ++w)
      dqp[i * a.sdq.s + dl + BB::DL * w] = from_f<T>(dq[u][w]);
  }
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
int run(const Args& a, cudaStream_t st) {
  const int H = a.KVH * a.G;
  const long long rows = (long long)a.B * H * a.Sq;
  fab_delta<T, D><<<(unsigned)((rows * 32 + NT - 1) / NT), NT, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = Smem<D>::bytes;
  if ((e = allow_smem(fab_dkdv<T, D>, smem)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(fab_dq<T, D>, smem)) != cudaSuccess) return (int)e;
  fab_dkdv<T, D><<<dim3((a.Sk + KB - 1) / KB, a.B * a.KVH), NT, smem, st>>>(
      a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fab_dq<T, D><<<dim3((a.Sq + QB - 1) / QB, a.B * H), NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run_hd(int hd, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 8: return run<T, 8>(a, st);
    case 16: return run<T, 16>(a, st);
    case 32: return run<T, 32>(a, st);
    case 64: return run<T, 64>(a, st);
    case 128: return run<T, 128>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace fab

// q, o, dout, dq (B, H, Sq, D); k, v, dk, dv (B, KVH, Sk, D); each by its
// strides (batch, position, head), head_dim contiguous; lse (B, H, Sq) f32
// from the forward, delta (B, H, Sq) f32 scratch.  dtype 0 float32, 1
// bfloat16 (every tensor operand the one type; dq / dk / dv written in it).
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
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return fab::run_hd<float>(hd, a, st);
  if (dtype == 1) return fab::run_hd<__nv_bfloat16>(hd, a, st);
  return (int)cudaErrorInvalidValue;
}
