// flash_decode: one-token attention over a length-masked KV arena.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:96
// (flash_decode / _fd_kernel, pallas_call at :134).
//
// What bounds it on the H100: bytes.  Each (slot, KV head) row reads its
// live K/V rows once (at full llama3.2-3b width with 4 slots of ~1100 rows,
// about 18 MB per layer call, ~5.4 us at 3.35 TB/s) and does only
// 4 * G * D flops per key row.  The grid is the problem: B * KVH = 32 rows
// against 132 SMs.  So the KV axis is split across CTAs in fixed SPLIT-key
// ranges (the reference's kv_seq lane split, flash_decode.py:21-23): grid =
// (ceil(Sk / SPLIT), B * KVH), and each CTA writes a partial (m, l, acc) to
// a scratch buffer the wrapper allocates.  Splits and strips past a row's
// live length are skipped; the kernel never walks past Sk (a parked slot
// asks for 2^30 + 1 live rows).  Reads the arena in place through strides:
// K/V stay in their (B, S, KVH, D) layout, the G query heads of a KV head
// share its strip.
//
// One launch.  Every split CTA of a row, live or not, arrives on the row's
// arrival counter (an integer atomicAdd after a __threadfence that
// publishes its partial); the CTA that arrives last merges the row's
// partials in ascending split order from (NEG_INF, 0, 0) with
// merge_coeffs / merge_val, and resets the counter to 0.  No float
// atomics: the merge order is fixed, so the result does not depend on
// which CTA arrives last.  The counters live in a per-(device, stream)
// buffer that the wrapper zeroes once, so a call issues no memset.  The
// merge runs once the row's slowest split is done; each thread merges its
// elements in split order, the loads of FOLD splits in flight at a time.
//
// Occupancy.  At hd 128 a bf16 split CTA takes 81 KB of shared memory (a
// 64-row Q box and two 32 KB K/V stages): 2 CTAs an SM, 264 slots for 288
// CTAs at Sk = 1121 with 4 slots x 8 KV heads.  An 8-row Q box for G <= 8
// with a 168-register cap reaches 3 CTAs an SM, but measured no faster
// with the merge in the kernel's tail, so the tile is kept as the prefill
// kernels run it.
//
// bf16 split CTAs run flash_tc.cuh's tensor-core tile, the routine
// flash_prefill_chunk runs: the same wgmma k-order over D, BK-key strips,
// three-term P, softmax order and merge, with the G query rows padded to the
// MMA's 64 by dead rows; that is what keeps chunk row j equal to decode at
// pos = prefix + j bit for bit.  K/V come in by TMA.  f32 split CTAs run
// flash_common.cuh's CUDA-core tile.
//
// Donor table (prefix sharing, the reference's composed share view,
// src/repro/models/transformer.py:495-530): slot b reads its key rows
// [0, share_len[b]) from slot share_src[b] of the same arena, the rest
// from its own (flash_common.cuh's Rows, flash_tc.cuh's issue_rows for the
// strip that straddles share_len).  Writes never go through it; an
// unshared slot passes (b, 0).
//
// Narrow arenas (the TPU kernel's scaled branch, _fd_kernel scaled=True,
// flash_decode.py:39-44,72-75): the arena may be int8 or fp8 e4m3 with
// (B, Sk, KVH) f32 scales read in place, under bf16 or f32 queries, or
// bf16 under f32 queries.  Still one launch a call: the bf16-q split CTA
// brings its narrow strips in by TMA at one byte an element (half a bf16
// strip's bytes, the point of the format: at llama3.2-3b's decode shape
// the arena is 0.52x of bf16's with its scales) and widens them in shared
// memory (flash_tc.cuh); the f32-q CTA widens and scales as it loads.
#include "flash_common.cuh"
#include "flash_tc.cuh"

using namespace fk;

constexpr int FOLD = 8;    // splits whose partials are loaded at once

// Merge the nsplit partials of row bkv in ascending split order from
// (NEG_INF, 0, 0) with merge_coeffs / merge_val -- flash_prefill_chunk's
// in-CTA merge, step for step -- and write the row's output.  FOLD splits'
// loads are in flight at a time; the merges keep their order.  The
// partials are read past L1 (__ldcg): other CTAs wrote them.
template <typename T, int D>
__device__ void combine_row(const Problem& p, const float* part, int nsplit,
                            int bkv) {
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  const int G = p.G;
  const long long stride = (long long)G * (D + 2);
  const float* row = part + (long long)bkv * nsplit * stride;
  T* o = reinterpret_cast<T*>(p.o);
  for (int e = threadIdx.x; e < G * D; e += NT) {
    const int r = e / D, d = e % D;
    float M = NEG_INF, L = 0.f, A = 0.f;
    for (int s0 = 0; s0 < nsplit; s0 += FOLD) {
      float ms[FOLD], ls[FOLD], as[FOLD];
#pragma unroll
      for (int u = 0; u < FOLD; ++u) {
        if (s0 + u < nsplit) {
          const float* base = row + (s0 + u) * stride;
          ms[u] = __ldcg(base + r);
          ls[u] = __ldcg(base + G + r);
          as[u] = __ldcg(base + 2 * G + r * D + d);
        }
      }
#pragma unroll
      for (int u = 0; u < FOLD; ++u) {
        if (s0 + u < nsplit) {
          float M2, a, bb;
          merge_coeffs(M, ms[u], &M2, &a, &bb);
          A = merge_val(A, a, as[u], bb);
          L = merge_val(L, a, ls[u], bb);
          M = M2;
        }
      }
    }
    o[b * p.sob + (long long)(kvh * G + r) * p.soh + d] =
        from_f<T>(finish_val(A, L));
  }
}

// After a split CTA has written its partial: arrive on row bkv's counter;
// the last of the row's nsplit CTAs to arrive resets it and merges the row.
// Thread 0's fences order the whole CTA's partial (made visible to it by
// the barrier) before its arrival, and the other CTAs' partials before
// the merge's reads.
template <typename T, int D>
__device__ __forceinline__ void arrive_and_combine(const Problem& p,
                                                   const float* part,
                                                   int* count, int nsplit,
                                                   int bkv) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&count[bkv], 1) == nsplit - 1;
    if (last) {
      count[bkv] = 0;              // every CTA of the row has arrived
      __threadfence();
    }
  }
  __syncthreads();
  if (last) combine_row<T, D>(p, part, nsplit, bkv);
}

template <typename T, typename KT, int D, int ROWS>
__global__ void __launch_bounds__(NT)
fd_kernel(Problem p, float* part, int* count, int nsplit) {
  extern __shared__ __align__(16) char smem[];
  using TT = Tile<T, D, ROWS, KT>;
  TT t;
  t.init(smem);
  const int split = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  t.load_q(p, b, kvh, 0);
  const int k0 = split * SPLIT;
  t.run_keys(p, kvh, k0, min(k0 + SPLIT, p.Sk));
  const int G = p.G;
  float* base = part + ((long long)bkv * nsplit + split) * G * (D + 2);
  for (int r = threadIdx.x; r < G; r += NT) {
    base[r] = t.Ms[r];
    base[G + r] = t.Ls[r];
  }
  const int dl = threadIdx.x % TT::DL, rg = threadIdx.x / TT::DL;
#pragma unroll
  for (int v = 0; v < TT::RPV; ++v) {
    const int r = rg + TT::RGV * v;
    if (r < G) {
#pragma unroll
      for (int w = 0; w < TT::DPT; ++w)
        base[2 * G + r * D + dl + TT::DL * w] = t.acc[v][w];
    }
  }
  arrive_and_combine<T, D>(p, part, count, nsplit, bkv);
}

template <int D, typename KT>
__global__ void __launch_bounds__(NT)
fd_tc_kernel(Problem p, const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv, int bmul, float* part,
             int* count, int nsplit) {
  extern __shared__ __align__(128) char tc_smem[];
  using TT = tc::TcTile<D, KT>;
  TT t;
  t.init(tc_smem);
  const int split = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  t.load_q(p, b, kvh, 0);
  constexpr int PER = SPLIT / BK;
  t.run(p, &mk, &mv, kvh, bmul, max(t.lim[0], split * PER),
        min(t.lim[1], split * PER + PER - 1), [](int) {});
  const int G = p.G, cq = 2 * (t.lane % 4);
  float* base = part + ((long long)bkv * nsplit + split) * G * (D + 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = t.row0 + 8 * i;
    if (r >= G) continue;
    if (t.lane % 4 == 0) {
      base[r] = t.m[i];
      base[G + r] = t.l[i];
    }
#pragma unroll
    for (int c = 0; c < TT::R / 4; ++c) {
      const int col = 8 * c + cq;
      if (col < D) {
        base[2 * G + r * D + col] = t.o[4 * c + 2 * i];
        base[2 * G + r * D + col + 1] = t.o[4 * c + 2 * i + 1];
      }
    }
  }
  arrive_and_combine<__nv_bfloat16, D>(p, part, count, nsplit, bkv);
}

// The f32 kernel of a group size: G query rows in a tile of 8 or 16.
template <typename T, typename KT, int D, typename F>
static int fd_f32_pick(int G, F f) {
  if (G <= 8) return f(fd_kernel<T, KT, D, 8>, Smem<D, 8>::bytes);
  if (G <= 16) return f(fd_kernel<T, KT, D, 16>, Smem<D, 16>::bytes);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename KT, int D>
static int fd_run(const Problem& p, int B, float* part, int* count,
                  int nsplit, cudaStream_t st) {
  return fd_f32_pick<T, KT, D>(p.G, [&](auto kernel, size_t smem) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(nsplit, B * p.KVH), NT, smem, st>>>(p, part, count,
                                                       nsplit);
    return (int)cudaGetLastError();
  });
}

template <int D, typename KT>
static int fd_tc_run(const Problem& p, int B, float* part, int* count,
                     int nsplit, cudaStream_t st) {
  if (!p.vec || p.G > tc::ROWS) return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  int bmul;
  int e = tc::make_maps(p, B, &mk, &mv, &bmul, D, (int)sizeof(KT));
  if (e) return e;
  const size_t smem = tc::Cfg<D, KT>::smem;
  e = (int)allow_smem(fd_tc_kernel<D, KT>, smem);
  if (e) return e;
  fd_tc_kernel<D, KT><<<dim3(nsplit, B * p.KVH), NT, smem, st>>>(
      p, mk, mv, bmul, part, count, nsplit);
  return (int)cudaGetLastError();
}

// CTAs of the kernel for (q type, arena type, hd, G) that fit on one SM at
// once.
template <typename T, typename KT, int D>
static int fd_occ(const Problem& p, int* blocks) {
  return fd_f32_pick<T, KT, D>(p.G, [&](auto kernel, size_t smem) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, NT,
                                                        smem);
    return (int)e;
  });
}

template <int D, typename KT>
static int fd_tc_occ(const Problem& p, int* blocks) {
  if (p.G > tc::ROWS) return (int)cudaErrorInvalidValue;
  const size_t smem = tc::Cfg<D, KT>::smem;
  cudaError_t e = allow_smem(fd_tc_kernel<D, KT>, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fd_tc_kernel<D, KT>, NT, smem);
  return (int)e;
}

// q (B, H, D), k/v (B, Sk, KVH, D), o (B, H, D) by strides; ks/vs (B, Sk,
// KVH) f32 scales of an int8 / fp8 arena by strides (ssb, sss, ssh; null
// for an unscaled arena); lengths (B,) int32 live rows per slot (null: all
// Sk live); share_src / share_len (B,) int32 the donor table (null: none).
// qtype 0 float32 / 1 bfloat16; kvtype 0 float32, 1 bfloat16,
// 2 int8, 3 fp8 e4m3 (bf16 q: 1-3).  part: scratch of B * KVH * nsplit *
// G * (D + 2) floats, nsplit = ceil(Sk / 128); count: B * KVH int32
// arrival counters, 0 on entry and left 0.  Returns cudaGetLastError()
// after the launch.  bf16 needs vec.
extern "C" int fd_launch(int qtype, int kvtype, int hd, const void* q,
                         const void* k, const void* v, const float* ks,
                         const float* vs, void* o, float* part, int* count,
                         long long sqb, long long sqh,
                         long long skb, long long sks, long long skh,
                         long long svb, long long svs, long long svh,
                         long long ssb, long long sss, long long ssh,
                         long long sob, long long soh,
                         int B, int KVH, int G, int Sk, const int* lengths,
                         const int* share_src, const int* share_len,
                         int window, float scale, int nsplit, int vec,
                         void* stream) {
  Problem p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sqb = sqb; p.sqs = 0; p.sqh = sqh;
  p.skb = skb; p.sks = sks; p.skh = skh;
  p.svb = svb; p.svs = svs; p.svh = svh;
  p.sob = sob; p.sos = 0; p.soh = soh;
  p.ks = ks; p.vs = vs; p.ssb = ssb; p.sss = sss; p.ssh = ssh;
  p.KVH = KVH; p.G = G; p.C = 1; p.Sk = Sk;
  p.qbase = lengths; p.qbase0 = Sk; p.qbase_add = -1;
  p.share_src = share_src; p.share_len = share_len;
  p.causal = 1; p.window = window; p.scale = scale; p.vec = vec;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return dispatch_kv(
      qtype, kvtype, hd,
      [&](auto kt, auto d) {
        using KT = typename decltype(kt)::type;
        return fd_run<float, KT, decltype(d)::value>(p, B, part, count,
                                                     nsplit, st);
      },
      [&](auto kt, auto d) {
        using KT = typename decltype(kt)::type;
        return fd_tc_run<decltype(d)::value, KT>(p, B, part, count, nsplit,
                                                 st);
      });
}

// *blocks = CTAs of the (q type, arena type, hd, G) kernel resident on one
// SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns a
// CUDA error code.
extern "C" int fd_occupancy(int qtype, int kvtype, int hd, int G,
                            int* blocks) {
  Problem p;
  p.G = G;
  return dispatch_kv(
      qtype, kvtype, hd,
      [&](auto kt, auto d) {
        using KT = typename decltype(kt)::type;
        return fd_occ<float, KT, decltype(d)::value>(p, blocks);
      },
      [&](auto kt, auto d) {
        using KT = typename decltype(kt)::type;
        return fd_tc_occ<decltype(d)::value, KT>(p, blocks);
      });
}
