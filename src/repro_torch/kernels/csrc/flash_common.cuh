// Shared tile routine of the three attention kernels (flash_decode,
// flash_prefill_chunk, flash_attention): the float32 path, on the CUDA
// cores.  The bfloat16 path is flash_tc.cuh's tensor-core tile, which keeps
// this file's masking, merge formula and split structure.
//
// All three compute the same thing for one (batch, KV-head) pair: a tile of
// query rows, row r = g * C + i meaning query head kvh * G + g at query
// position i (absolute position qbase + i), attends the KV rows of that KV
// head with an online softmax over BK-key strips.  Decode is C = 1 with
// qbase = length - 1; the prefill chunk is C chunk positions with
// qbase = prefix; full attention is C = Sq with qbase = Sk - Sq.  GQA is
// handled by indexing (no repeat): the G query heads of a KV head share its
// K/V strip in shared memory.
//
// Every kernel reads its operands in place through element strides
// (batch / position / head; the head_dim axis is contiguous) and masks its
// own ragged edge: keys at kpos >= Sk are never read, whatever the query
// position says (a parked decode slot asks for ~2^30 live rows).
//
// Determinism.  Every scalar of the result is reduced in one fixed order,
// independent of the tile size and the thread mapping: a score is a
// sequential fma chain over d, a row's max/sum is a sequential loop over the
// strip's keys, an output element is a sequential fma chain over the strip's
// keys, and splits of SPLIT keys merge in ascending order with one merge
// formula (merge_coeffs).  That is what lets flash_prefill_chunk row j equal
// flash_decode at pos = prefix + j bit for bit: the chunk kernel runs the
// per-split partials and the merge in-CTA, the decode kernel runs them in
// separate CTAs and the last of them merges, and the arithmetic is the same.
// Explicit __f*_rn intrinsics keep nvcc from contracting differently in the
// two kernels.
//
// Donor table (prefix sharing).  flash_decode and flash_prefill_chunk may
// take a per-query-batch donor entry (Problem::share_src / share_len): key
// rows [0, share_len[b]) come from arena row share_src[b], the rest from
// the batch's own row (Rows).  The f32 tile picks the row per key as it
// loads the strip; the tensor-core tile per strip, and by row for the one
// strip that straddles share_len (flash_tc.cuh).  Only addressing
// changes: the strips, the splits and the order of every sum stay, so
// over donor rows equal to the own rows the result is the same bits.
//
// Narrow arenas.  flash_decode and flash_prefill_chunk also read a K/V
// arena narrower than q (the TPU kernels' fused-dequant branch,
// src/repro/kernels/flash_decode.py:39-44,72-75 and
// flash_prefill_chunk.py:38-44,73-76): bf16 under f32 queries, and int8 or
// fp8 e4m3 with one f32 scale per (row, KV head) (Problem::ks / vs, read
// in place through their strides).  The f32 tile widens each K/V element
// as it loads the strip and multiplies it by its row's scale, in the
// reference's order (k.float() * ks, then the products).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fk {

constexpr int NT = 128;          // threads per CTA
constexpr int BK = 64;           // keys per strip
constexpr int SPLIT = 128;       // keys per split (decode CTA, chunk merge)
constexpr float NEG_INF = -1e30f;
constexpr int DEAD_QPOS = -(1 << 29);   // padded rows see no key

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// An arena type with a scale per (row, KV head): int8 and fp8 e4m3.
template <typename KT>
constexpr bool scaled_v = sizeof(KT) == 1;
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One attention problem: strides are in elements.
struct Problem {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sqb, sqs, sqh;   // q: batch, position, head
  long long skb, sks, skh;   // k
  long long svb, svs, svh;   // v
  long long sob, sos, soh;   // o
  int KVH, G, C, Sk;
  const int* qbase;          // (B,) position of query 0, or null -> qbase0
  int qbase0;
  int qbase_add;             // added to qbase[b] (decode: lengths - 1)
  int causal;
  int window;                // <= 0: no sliding window
  float scale;
  int vec;                   // 16-byte K/V loads are legal
  // scaled arenas: (B, Sk, KVH) f32 scales of K and V, element strides
  // batch / position / head shared by both
  const float* ks = nullptr;
  const float* vs = nullptr;
  long long ssb = 0, sss = 0, ssh = 0;
  // slot table (flash_prefill_chunk over the whole arena): query batch b
  // reads arena batch row slots[b] (K, V and their scales); null -> b
  const int* slots = nullptr;
  // donor table (prefix sharing): query batch b reads key rows
  // [0, share_len[b]) from arena batch row share_src[b], the rows after
  // from its own row (K, V and their scales alike); null -> no table
  const int* share_src = nullptr;
  const int* share_len = nullptr;
  // flash_attention only (training): (B, H, C) f32 row log-sum-exp of the
  // scaled scores, m + log(l), row r of (b, kvh) at (b * KVH + kvh) * G * C
  // + r; null on every serving call, and written after O, which it does
  // not change
  float* lse = nullptr;
};

// The row log-sum-exp the backward pass recomputes P from: the split's max
// plus log of its sum (NEG_INF-ish for a row that sees no key, l = 0).
__device__ __forceinline__ float row_lse(float m, float l) {
  return m + logf(l > 0.f ? l : 1.f);
}

// The arena batch row that query batch b reads.
__device__ __forceinline__ int arena_row(const Problem& p, int b) {
  return p.slots ? p.slots[b] : b;
}

// The arena batch rows one query batch reads: key row kpos comes from the
// donor row ``src`` below ``len``, from its own row ``own`` from there on
// (src = own, len = 0 without a donor table).  Reads only: no kernel
// writes the arena.
struct Rows {
  int own, src, len;
  __device__ __forceinline__ int at(int kpos) const {
    return kpos < len ? src : own;
  }
  // Does strip [j0, j0 + BK) take rows from both?
  __device__ __forceinline__ bool straddles(int j0) const {
    return j0 < len && j0 + BK > len;
  }
};

__device__ __forceinline__ Rows rows_of(const Problem& p, int b) {
  Rows r;
  r.own = arena_row(p, b);
  r.src = p.share_src ? p.share_src[b] : r.own;
  r.len = p.share_src ? p.share_len[b] : 0;
  return r;
}

// Does query position qpos see key kpos?  Keys past Sk never: a parked
// decode slot's position (~2^30) walks only [0, Sk).
__device__ __forceinline__ bool visible(const Problem& p, int qpos,
                                        int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// Merge of a split's partial (ms, ls, acc) into the running (M, L, A):
//   M' = max(M, ms);  A' = A e^(M-M') + acc e^(ms-M');  L' likewise.
__device__ __forceinline__ void merge_coeffs(float M, float ms, float* M2,
                                             float* a, float* b) {
  *M2 = fmaxf(M, ms);
  *a = expf(M - *M2);
  *b = expf(ms - *M2);
}
__device__ __forceinline__ float merge_val(float A, float a, float acc,
                                           float b) {
  return __fmaf_rn(A, a, __fmul_rn(acc, b));
}
__device__ __forceinline__ float finish_val(float A, float L) {
  return L > 0.f ? __fdiv_rn(A, L) : A;
}

template <int D, int ROWS>
struct Smem {
  static constexpr int DP = D + 1;   // padded row: conflict-free columns
  static constexpr int SP = BK + 1;
  static constexpr size_t floats =
      (size_t)ROWS * DP + 2 * (size_t)BK * DP + (size_t)ROWS * SP + 5 * ROWS;
  static constexpr size_t bytes = floats * 4 + ROWS * 4 + 2 * 4;
};

// T: the type of q and o; KT: the arena's (T by default).
template <typename T, int D, int ROWS, typename KT = T>
struct Tile {
  using S = Smem<D, ROWS>;
  static constexpr bool SC = scaled_v<KT>;
  static constexpr int DP = S::DP, SP = S::SP;
  // score mapping: 16 key lanes x 8 row groups, each thread a
  // RPT x KPT micro-tile (every score is still one sequential d-chain)
  static constexpr int KL = 16, RGS = NT / KL, KPT = BK / KL;
  static constexpr int RPT = (ROWS + RGS - 1) / RGS;
  // P.V mapping: DL lanes over head_dim x RGV row groups
  static constexpr int DL = D < 32 ? D : 32, RGV = NT / DL, DPT = D / DL;
  static constexpr int RPV = (ROWS + RGV - 1) / RGV;

  float *Qs, *Ks, *Vs, *Ss, *Ms, *Ls, *Al, *GM, *GL;
  int* qp;
  int* qlim;          // [0] = min qpos of the tile's rows, [1] = max
  float acc[RPV][DPT];
  int tid;
  Rows rw;            // the arena rows the tile's query batch reads

  __device__ void init(char* smem) {
    float* f = reinterpret_cast<float*>(smem);
    Qs = f;  f += ROWS * DP;
    Ks = f;  f += BK * DP;
    Vs = f;  f += BK * DP;
    Ss = f;  f += ROWS * SP;
    Ms = f;  f += ROWS;
    Ls = f;  f += ROWS;
    Al = f;  f += ROWS;
    GM = f;  f += ROWS;
    GL = f;  f += ROWS;
    qp = reinterpret_cast<int*>(f);
    qlim = qp + ROWS;
    tid = threadIdx.x;
    reset_acc();
  }

  __device__ __forceinline__ void reset_acc() {
#pragma unroll
    for (int v = 0; v < RPV; ++v)
#pragma unroll
      for (int w = 0; w < DPT; ++w) acc[v][w] = 0.f;
  }

  // Load the tile's query rows [r0, r0 + ROWS) of (b, kvh), pre-scaled, and
  // their absolute positions; reset the per-row softmax state.
  __device__ void load_q(const Problem& p, int b, int kvh, int r0) {
    const T* q = reinterpret_cast<const T*>(p.q);
    const int nrows = p.G * p.C;
    for (int e = tid; e < ROWS * D; e += NT) {
      const int r = e / D, d = e % D, R = r0 + r;
      float x = 0.f;
      if (R < nrows) {
        const int g = R / p.C, i = R % p.C;
        x = to_f(q[b * p.sqb + i * p.sqs + (long long)(kvh * p.G + g) * p.sqh
                   + d]);
      }
      Qs[r * DP + d] = __fmul_rn(x, p.scale);
    }
    rw = rows_of(p, b);
    const int base = (p.qbase ? p.qbase[b] : p.qbase0) + p.qbase_add;
    for (int r = tid; r < ROWS; r += NT) {
      const int R = r0 + r;
      qp[r] = R < nrows ? base + R % p.C : DEAD_QPOS;
      Ms[r] = NEG_INF;
      Ls[r] = 0.f;
      GM[r] = NEG_INF;
      GL[r] = 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      int lo = 0x7fffffff, hi = DEAD_QPOS;
      for (int r = 0; r < ROWS && r0 + r < nrows; ++r) {
        lo = min(lo, qp[r]);
        hi = max(hi, qp[r]);
      }
      qlim[0] = lo;
      qlim[1] = hi;
    }
    __syncthreads();
  }

  // Does strip [j0, j0 + BK) hold a visible key for any row of the tile?
  // CTA-uniform (reads only shared qlim).
  __device__ __forceinline__ bool strip_live(const Problem& p, int j0) const {
    bool live = j0 < p.Sk;
    if (p.causal) live = live && j0 <= qlim[1];
    if (p.window > 0) live = live && j0 + BK - 1 > qlim[0] - p.window;
    return live;
  }

  // K/V rows [j0, j0 + BK) widened to f32 (times their scales for a
  // scaled arena), zeros past Sk; each row from the arena row ``rw``
  // names for it.
  __device__ void load_kv(const Problem& p, int kvh, int j0) {
    const KT* k = reinterpret_cast<const KT*>(p.k);
    const KT* v = reinterpret_cast<const KT*>(p.v);
    constexpr int VEC = 16 / sizeof(KT);
    if (p.vec && D % VEC == 0) {
      constexpr int NV = D / VEC;
      for (int e = tid; e < BK * NV; e += NT) {
        const int j = e / NV, c = e % NV, kpos = j0 + j;
        const long long b = rw.at(kpos);
        const long long kb = b * p.skb + kvh * p.skh;
        const long long vb = b * p.svb + kvh * p.svh;
        const long long sb = b * p.ssb + kvh * p.ssh;
        if (kpos < p.Sk) {
          const uint4 ku = *reinterpret_cast<const uint4*>(
              k + kb + kpos * p.sks + c * VEC);
          const uint4 vu = *reinterpret_cast<const uint4*>(
              v + vb + kpos * p.svs + c * VEC);
          const KT* kt = reinterpret_cast<const KT*>(&ku);
          const KT* vt = reinterpret_cast<const KT*>(&vu);
          float sk = 1.f, sv = 1.f;
          if constexpr (SC) {
            sk = p.ks[sb + kpos * p.sss];
            sv = p.vs[sb + kpos * p.sss];
          }
#pragma unroll
          for (int x = 0; x < VEC; ++x) {
            Ks[j * DP + c * VEC + x] = SC ? __fmul_rn(to_f(kt[x]), sk)
                                          : to_f(kt[x]);
            Vs[j * DP + c * VEC + x] = SC ? __fmul_rn(to_f(vt[x]), sv)
                                          : to_f(vt[x]);
          }
        } else {
#pragma unroll
          for (int x = 0; x < VEC; ++x) {
            Ks[j * DP + c * VEC + x] = 0.f;
            Vs[j * DP + c * VEC + x] = 0.f;
          }
        }
      }
    } else {
      for (int e = tid; e < BK * D; e += NT) {
        const int j = e / D, d = e % D, kpos = j0 + j;
        const long long b = rw.at(kpos);
        const long long kb = b * p.skb + kvh * p.skh;
        const long long vb = b * p.svb + kvh * p.svh;
        const long long sb = b * p.ssb + kvh * p.ssh;
        const bool in = kpos < p.Sk;
        float kx = in ? to_f(k[kb + kpos * p.sks + d]) : 0.f;
        float vx = in ? to_f(v[vb + kpos * p.svs + d]) : 0.f;
        if constexpr (SC) {
          if (in) {
            kx = __fmul_rn(kx, p.ks[sb + kpos * p.sss]);
            vx = __fmul_rn(vx, p.vs[sb + kpos * p.sss]);
          }
        }
        Ks[j * DP + d] = kx;
        Vs[j * DP + d] = vx;
      }
    }
  }

  // One strip whose K/V are in shared memory: scores, online-softmax row
  // update, P.V accumulation into the split-local acc registers.
  __device__ void strip(const Problem& p, int j0) {
    {
      const int kl = tid % KL, rg = tid / KL;
      float s[RPT][KPT];
#pragma unroll
      for (int v = 0; v < RPT; ++v)
#pragma unroll
        for (int u = 0; u < KPT; ++u) s[v][u] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[KPT];
#pragma unroll
        for (int u = 0; u < KPT; ++u) kv[u] = Ks[(kl + KL * u) * DP + d];
#pragma unroll
        for (int v = 0; v < RPT; ++v) {
          const int r = rg + RGS * v;
          if (r < ROWS) {
            const float qv = Qs[r * DP + d];
#pragma unroll
            for (int u = 0; u < KPT; ++u) s[v][u] = __fmaf_rn(qv, kv[u], s[v][u]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < RPT; ++v) {
        const int r = rg + RGS * v;
        if (r < ROWS) {
#pragma unroll
          for (int u = 0; u < KPT; ++u) Ss[r * SP + kl + KL * u] = s[v][u];
        }
      }
    }
    __syncthreads();
    for (int r = tid; r < ROWS; r += NT) {
      const int qpos = qp[r];
      const float m_old = Ms[r];
      float mx = m_old;
      for (int j = 0; j < BK; ++j)
        if (visible(p, qpos, j0 + j)) mx = fmaxf(mx, Ss[r * SP + j]);
      const float alpha = expf(m_old - mx);
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) {
        const float e = visible(p, qpos, j0 + j) ? expf(Ss[r * SP + j] - mx)
                                                 : 0.f;
        Ss[r * SP + j] = e;
        sum = __fadd_rn(sum, e);
      }
      Ls[r] = __fmaf_rn(Ls[r], alpha, sum);
      Ms[r] = mx;
      Al[r] = alpha;
    }
    __syncthreads();
    {
      const int dl = tid % DL, rg = tid / DL;
      float t[RPV][DPT];
#pragma unroll
      for (int v = 0; v < RPV; ++v)
#pragma unroll
        for (int w = 0; w < DPT; ++w) t[v][w] = 0.f;
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        float vv[DPT];
#pragma unroll
        for (int w = 0; w < DPT; ++w) vv[w] = Vs[j * DP + dl + DL * w];
#pragma unroll
        for (int v = 0; v < RPV; ++v) {
          const int r = rg + RGV * v;
          if (r < ROWS) {
            const float pj = Ss[r * SP + j];
#pragma unroll
            for (int w = 0; w < DPT; ++w) t[v][w] = __fmaf_rn(pj, vv[w], t[v][w]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < RPV; ++v) {
        const int r = rg + RGV * v;
        if (r < ROWS) {
          const float al = Al[r];
#pragma unroll
          for (int w = 0; w < DPT; ++w) acc[v][w] = __fmaf_rn(acc[v][w], al, t[v][w]);
        }
      }
    }
    __syncthreads();
  }

  // Run every live strip of keys [k0, k1) into the split-local state.
  __device__ void run_keys(const Problem& p, int kvh, int k0, int k1) {
    for (int j0 = k0; j0 < k1; j0 += BK) {
      if (!strip_live(p, j0)) continue;
      load_kv(p, kvh, j0);
      __syncthreads();
      strip(p, j0);
    }
  }

  // Fold the split-local (Ms, Ls, acc) into the running (GM, GL, A) and
  // reset the split-local state for the next split.
  __device__ void merge_into(float (&A)[RPV][DPT]) {
    const int rg = tid / DL;
#pragma unroll
    for (int v = 0; v < RPV; ++v) {
      const int r = rg + RGV * v;
      if (r < ROWS) {
        float M2, a, bb;
        merge_coeffs(GM[r], Ms[r], &M2, &a, &bb);
#pragma unroll
        for (int w = 0; w < DPT; ++w) {
          A[v][w] = merge_val(A[v][w], a, acc[v][w], bb);
          acc[v][w] = 0.f;
        }
      }
    }
    __syncthreads();
    for (int r = tid; r < ROWS; r += NT) {
      float M2, a, bb;
      merge_coeffs(GM[r], Ms[r], &M2, &a, &bb);
      GL[r] = merge_val(GL[r], a, Ls[r], bb);
      GM[r] = M2;
      Ms[r] = NEG_INF;
      Ls[r] = 0.f;
    }
    __syncthreads();
  }

  // Write rows [r0, r0 + ROWS) of the output: vals[v][w] / L[r].
  __device__ void store(const Problem& p, int b, int kvh, int r0,
                        const float (&vals)[RPV][DPT], const float* L) {
    T* o = reinterpret_cast<T*>(p.o);
    const int nrows = p.G * p.C;
    const int dl = tid % DL, rg = tid / DL;
#pragma unroll
    for (int v = 0; v < RPV; ++v) {
      const int r = rg + RGV * v, R = r0 + r;
      if (r < ROWS && R < nrows) {
        const int g = R / p.C, i = R % p.C;
        T* row = o + b * p.sob + i * p.sos
                 + (long long)(kvh * p.G + g) * p.soh;
#pragma unroll
        for (int w = 0; w < DPT; ++w)
          row[dl + DL * w] = from_f<T>(finish_val(vals[v][w], L[r]));
      }
    }
  }

  // Rows [r0, r0 + ROWS) of Problem::lse from the unmerged (Ms, Ls).
  __device__ void store_lse(const Problem& p, int bkv, int r0) const {
    const int nrows = p.G * p.C;
    for (int r = tid; r < ROWS && r0 + r < nrows; r += NT)
      p.lse[(long long)bkv * nrows + r0 + r] = row_lse(Ms[r], Ls[r]);
  }
};

// Raise the dynamic shared-memory cap of ``kernel`` when it needs > 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace fk

// Dispatch a runtime (dtype, head_dim) pair: dtype 0 = float32 to the
// CUDA-core tile (F32FN<float, D>), 1 = bfloat16 to the tensor-core tile of
// flash_tc.cuh (BF16FN<D>); head_dim in {8, 16, 32, 64, 128}.
#define FK_DISPATCH(DTYPE, HD, F32FN, BF16FN, ...)                           \
  [&]() -> int {                                                             \
    if ((DTYPE) == 0) {                                                      \
      switch (HD) {                                                          \
        case 8: return F32FN<float, 8>(__VA_ARGS__);                         \
        case 16: return F32FN<float, 16>(__VA_ARGS__);                       \
        case 32: return F32FN<float, 32>(__VA_ARGS__);                       \
        case 64: return F32FN<float, 64>(__VA_ARGS__);                       \
        case 128: return F32FN<float, 128>(__VA_ARGS__);                     \
      }                                                                      \
    } else if ((DTYPE) == 1) {                                               \
      switch (HD) {                                                          \
        case 8: return BF16FN<8>(__VA_ARGS__);                               \
        case 16: return BF16FN<16>(__VA_ARGS__);                             \
        case 32: return BF16FN<32>(__VA_ARGS__);                             \
        case 64: return BF16FN<64>(__VA_ARGS__);                             \
        case 128: return BF16FN<128>(__VA_ARGS__);                           \
      }                                                                      \
    }                                                                        \
    return (int)cudaErrorInvalidValue;                                       \
  }()


namespace fk {

// Runtime codes to compile-time parameters, for the arena kernels'
// (q type, arena type, head_dim) dispatch: f(HeadDim<D>{}) for head_dim in
// {8, 16, 32, 64, 128}; f(TypeTag<KT>{}) for the arena code 0 float32, 1
// bfloat16, 2 int8, 3 fp8 e4m3.
template <int D> using HeadDim = std::integral_constant<int, D>;
template <typename T> struct TypeTag { using type = T; };

template <typename F>
inline int with_head_dim(int hd, F f) {
  switch (hd) {
    case 8: return f(HeadDim<8>{});
    case 16: return f(HeadDim<16>{});
    case 32: return f(HeadDim<32>{});
    case 64: return f(HeadDim<64>{});
    case 128: return f(HeadDim<128>{});
  }
  return (int)cudaErrorInvalidValue;
}

template <typename F>
inline int with_kv_type(int code, F f) {
  switch (code) {
    case 0: return f(TypeTag<float>{});
    case 1: return f(TypeTag<__nv_bfloat16>{});
    case 2: return f(TypeTag<int8_t>{});
    case 3: return f(TypeTag<__nv_fp8_e4m3>{});
  }
  return (int)cudaErrorInvalidValue;
}

// Dispatch (q type 0 float32 / 1 bfloat16, arena code, head_dim) to
// f32(TypeTag<KT>, HeadDim<D>) -- the CUDA-core tile, every arena type --
// or tc(TypeTag<KT>, HeadDim<D>) -- the tensor-core tile, whose arena is
// bf16, int8 or fp8 (a float32 arena under bf16 q is refused).
template <typename F32, typename TC>
inline int dispatch_kv(int qtype, int kvtype, int hd, F32 f32, TC tc) {
  return with_head_dim(hd, [&](auto d) {
    return with_kv_type(kvtype, [&](auto kt) -> int {
      using KT = typename decltype(kt)::type;
      if (qtype == 0) return f32(kt, d);
      if constexpr (std::is_same<KT, float>::value) {
        return (int)cudaErrorInvalidValue;
      } else {
        if (qtype == 1) return tc(kt, d);
        return (int)cudaErrorInvalidValue;
      }
    });
  });
}

}  // namespace fk
