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
// (ceil(Sk / SPLIT), B * KVH), each CTA writes a partial (m, l, acc) to a
// scratch buffer the wrapper allocates, and a combine pass merges the
// partials in split order.  Splits and strips past a row's live length are
// skipped; the kernel never walks past Sk (a parked slot asks for 2^30 + 1
// live rows).  Reads the arena in place through strides: K/V stay in their
// (B, S, KVH, D) layout, the G query heads of a KV head share its strip.
//
// bf16 split CTAs run flash_tc.cuh's tensor-core tile, the routine
// flash_prefill_chunk runs: the same wgmma k-order over D, BK-key strips,
// three-term P, softmax order and merge, with the G query rows padded to the
// MMA's 64 by dead rows; that is what keeps chunk row j equal to decode at
// pos = prefix + j bit for bit.  K/V come in by TMA.  f32 split CTAs run
// flash_common.cuh's CUDA-core tile.
#include "flash_common.cuh"
#include "flash_tc.cuh"

using namespace fk;

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(NT)
fd_split_kernel(Problem p, float* part, int nsplit) {
  extern __shared__ __align__(16) char smem[];
  using TT = Tile<T, D, ROWS>;
  TT t;
  t.init(smem);
  const int split = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  t.load_q(p, b, kvh, 0);
  const int k0 = split * SPLIT;
  t.run_keys(p, b, kvh, k0, min(k0 + SPLIT, p.Sk));
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
}

// Merge the per-split partials of one (slot, KV head) row in split order.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
fd_combine_kernel(Problem p, const float* part, int nsplit) {
  const int bkv = blockIdx.x, b = bkv / p.KVH, kvh = bkv % p.KVH;
  const int G = p.G;
  T* o = reinterpret_cast<T*>(p.o);
  for (int e = threadIdx.x; e < G * D; e += NT) {
    const int r = e / D, d = e % D;
    float M = NEG_INF, L = 0.f, A = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* base = part + ((long long)bkv * nsplit + s) * G * (D + 2);
      float M2, a, bb;
      merge_coeffs(M, base[r], &M2, &a, &bb);
      A = merge_val(A, a, base[2 * G + r * D + d], bb);
      L = merge_val(L, a, base[G + r], bb);
      M = M2;
    }
    o[b * p.sob + (long long)(kvh * G + r) * p.soh + d] =
        from_f<T>(finish_val(A, L));
  }
}

template <typename T, int D, int ROWS>
static int fd_run_rows(const Problem& p, int B, float* part, int nsplit,
                       cudaStream_t st) {
  const size_t smem = Smem<D, ROWS>::bytes;
  cudaError_t e = allow_smem(fd_split_kernel<T, D, ROWS>, smem);
  if (e != cudaSuccess) return (int)e;
  fd_split_kernel<T, D, ROWS>
      <<<dim3(nsplit, B * p.KVH), NT, smem, st>>>(p, part, nsplit);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fd_combine_kernel<T, D><<<B * p.KVH, NT, 0, st>>>(p, part, nsplit);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int fd_run(const Problem& p, int B, float* part, int nsplit,
                  cudaStream_t st) {
  if (p.G <= 8) return fd_run_rows<T, D, 8>(p, B, part, nsplit, st);
  if (p.G <= 16) return fd_run_rows<T, D, 16>(p, B, part, nsplit, st);
  return (int)cudaErrorInvalidValue;
}

template <int D>
__global__ void __launch_bounds__(NT)
fd_tc_split_kernel(Problem p, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, int bmul,
                   float* part, int nsplit) {
  extern __shared__ __align__(128) char tc_smem[];
  using TT = tc::TcTile<D>;
  TT t;
  t.init(tc_smem);
  const int split = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  t.load_q(p, b, kvh, 0);
  constexpr int PER = SPLIT / BK;
  t.run(p, &mk, &mv, kvh, b * bmul, max(t.lim[0], split * PER),
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
}

template <int D>
static int fd_tc_run(const Problem& p, int B, float* part, int nsplit,
                     cudaStream_t st) {
  if (!p.vec || p.G > tc::ROWS) return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  int bmul;
  int e = tc::make_maps(p, B, &mk, &mv, &bmul, D);
  if (e) return e;
  const size_t smem = tc::Cfg<D>::smem;
  e = (int)allow_smem(fd_tc_split_kernel<D>, smem);
  if (e) return e;
  fd_tc_split_kernel<D><<<dim3(nsplit, B * p.KVH), NT, smem, st>>>(
      p, mk, mv, bmul, part, nsplit);
  e = (int)cudaGetLastError();
  if (e) return e;
  fd_combine_kernel<__nv_bfloat16, D><<<B * p.KVH, NT, 0, st>>>(p, part,
                                                                nsplit);
  return (int)cudaGetLastError();
}

// q (B, H, D), k/v (B, Sk, KVH, D), o (B, H, D) by strides; lengths (B,)
// int32 live rows per slot (null: all Sk live).  part: scratch of
// B * KVH * nsplit * G * (D + 2) floats, nsplit = ceil(Sk / 128).
// Returns cudaGetLastError() after the launches.  bf16 needs vec.
extern "C" int fd_launch(int dtype, int hd, const void* q, const void* k,
                         const void* v, void* o, float* part,
                         long long sqb, long long sqh,
                         long long skb, long long sks, long long skh,
                         long long svb, long long svs, long long svh,
                         long long sob, long long soh,
                         int B, int KVH, int G, int Sk, const int* lengths,
                         int window, float scale, int nsplit, int vec,
                         void* stream) {
  Problem p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sqb = sqb; p.sqs = 0; p.sqh = sqh;
  p.skb = skb; p.sks = sks; p.skh = skh;
  p.svb = svb; p.svs = svs; p.svh = svh;
  p.sob = sob; p.sos = 0; p.soh = soh;
  p.KVH = KVH; p.G = G; p.C = 1; p.Sk = Sk;
  p.qbase = lengths; p.qbase0 = Sk; p.qbase_add = -1;
  p.causal = 1; p.window = window; p.scale = scale; p.vec = vec;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return FK_DISPATCH(dtype, hd, fd_run, fd_tc_run, p, B, part, nsplit, st);
}
