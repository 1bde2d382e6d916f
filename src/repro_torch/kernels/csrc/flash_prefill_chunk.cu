// flash_prefill_chunk: C chunk queries x G heads against the KV arena, with
// the chunk's own K/V already written at rows [prefix, prefix + C).
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill_chunk.py:97
// (flash_prefill_chunk / _fpc_kernel, pallas_call at :137).
//
// What bounds it on the H100: operations once C is large (at C = 512 and
// prefix 512, G = 3: ~2.4 GFLOP per layer call against ~2 MB of K/V), bytes
// for small chunks.  bf16 runs on the tensor cores (flash_tc.cuh: one
// warpgroup per 64 folded query rows, row r = g * C + i, wgmma QK^T and
// exact-P PV products (three bf16 terms) over TMA-loaded K/V strips read
// in place from the arena); f32 runs flash_common.cuh's CUDA-core tile
// with 32 rows per CTA.
// `prefix` is runtime data; strips past the tile's last query position
// are skipped.  The bf16 grid is 1-D, heaviest tiles first.
//
// Bit-identity pin: the CTA walks the keys in the same SPLIT-key splits as
// flash_decode, each split from a fresh online-softmax state, and merges
// the splits in order with the same formula as flash_decode's combine
// (flash_common.cuh's merge_coeffs), on the same tile routine per dtype.
// So row j equals flash_decode at pos = prefix + j bit for bit, which
// speculative verify relies on (transformer.py:703-713 in the reference).
//
// Slot table: given the whole arena (slots, Sk, KVH, D) and slots (B,) on
// the device, query batch b reads arena row slots[b] (its K/V through the
// TMA maps' batch coordinate, its scales by stride), so a captured chunk
// step reads its slot as data.  It changes addressing only: the pin holds.
//
// Donor table (prefix sharing): beside the slot table, query batch b reads
// its key rows [0, share_len[b]) from arena row share_src[b] (a fork reads
// its donor's prefix in place), the rest from slots[b] (flash_common.cuh's
// Rows; flash_tc.cuh loads the strip that straddles share_len by rows).
// Addressing again: the pin holds under the table.
//
// Narrow arenas (the TPU kernel's scaled branch, flash_prefill_chunk.py:
// 38-44,73-76): int8 or fp8 e4m3 K/V with (B, Sk, KVH) f32 scales, or bf16
// under f32 queries, read and widened as flash_decode reads them (the same
// tile routines), so the pin holds per format.
#include "flash_common.cuh"
#include "flash_tc.cuh"

using namespace fk;

constexpr int FPC_ROWS = 32;

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(NT) fpc_kernel(Problem p) {
  extern __shared__ __align__(16) char smem[];
  using TT = Tile<T, D, FPC_ROWS, KT>;
  TT t;
  t.init(smem);
  const int r0 = blockIdx.x * FPC_ROWS, bkv = blockIdx.y;
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  t.load_q(p, b, kvh, r0);
  float A[TT::RPV][TT::DPT];
#pragma unroll
  for (int v = 0; v < TT::RPV; ++v)
#pragma unroll
    for (int w = 0; w < TT::DPT; ++w) A[v][w] = 0.f;
  for (int k0 = 0; k0 < p.Sk; k0 += SPLIT) {
    if (k0 > t.qlim[1]) break;      // causal: no row of the tile sees it
    t.run_keys(p, kvh, k0, min(k0 + SPLIT, p.Sk));
    t.merge_into(A);
  }
  t.store(p, b, kvh, r0, A, t.GL);
}

template <typename T, typename KT, int D>
static int fpc_run(const Problem& p, int B, cudaStream_t st) {
  const size_t smem = Smem<D, FPC_ROWS>::bytes;
  cudaError_t e = allow_smem(fpc_kernel<T, KT, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (p.G * p.C + FPC_ROWS - 1) / FPC_ROWS;
  fpc_kernel<T, KT, D><<<dim3(tiles, B * p.KVH), NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D, typename KT>
__global__ void __launch_bounds__(NT)
fpc_tc_kernel(Problem p, const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, int bmul) {
  extern __shared__ __align__(128) char tc_smem[];
  using TT = tc::TcTile<D, KT>;
  TT t;
  t.init(tc_smem);
  int bkv, r0;
  tc::tile_of(p, blockIdx.x, &bkv, &r0);
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  t.load_q(p, b, kvh, r0);
  float A[TT::R], GM[2] = {NEG_INF, NEG_INF}, GL[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < TT::R; ++x) A[x] = 0.f;
  // splits with no live strip are skipped: merging one is bit-neutral
  // (alpha 1, zero partial), as in flash_decode's combine
  constexpr int PER = SPLIT / BK;
  const int last = t.lim[1];
  t.run(p, &mk, &mv, kvh, bmul, t.lim[0], last, [&](int n) {
    if (n == last || (n + 1) % PER == 0) t.merge_into(A, GM, GL);
  });
  t.store(p, b, kvh, r0, A, GL);
}

template <int D, typename KT>
static int fpc_tc_run(const Problem& p, int B, int NA, cudaStream_t st) {
  if (!p.vec) return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  int bmul;
  int e = tc::make_maps(p, NA, &mk, &mv, &bmul, D, (int)sizeof(KT));
  if (e) return e;
  const size_t smem = tc::Cfg<D, KT>::smem;
  e = (int)allow_smem(fpc_tc_kernel<D, KT>, smem);
  if (e) return e;
  const int tiles = (p.G * p.C + tc::ROWS - 1) / tc::ROWS;
  fpc_tc_kernel<D, KT><<<tiles * B * p.KVH, NT, smem, st>>>(p, mk, mv,
                                                            bmul);
  return (int)cudaGetLastError();
}

// q (B, C, H, D), k/v (NA, Sk, KVH, D), o (B, C, H, D) by strides; ks/vs
// (NA, Sk, KVH) f32 scales of an int8 / fp8 arena by strides (null for an
// unscaled arena); prefix (B,) int32 rows live before the chunk; slots (B,)
// int32 arena rows of the query batches (null: NA == B, batch b reads row
// b); share_src / share_len (B,) int32 the donor table (null: none).
// Types as fd_launch's.  bf16 needs vec.
extern "C" int fpc_launch(int qtype, int kvtype, int hd, const void* q,
                          const void* k, const void* v, const float* ks,
                          const float* vs, void* o,
                          long long sqb, long long sqs, long long sqh,
                          long long skb, long long sks, long long skh,
                          long long svb, long long svs, long long svh,
                          long long ssb, long long sss, long long ssh,
                          long long sob, long long sos, long long soh,
                          int B, int NA, int KVH, int G, int C, int Sk,
                          const int* prefix, const int* slots,
                          const int* share_src, const int* share_len,
                          int window, float scale, int vec, void* stream) {
  Problem p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.skb = skb; p.sks = sks; p.skh = skh;
  p.svb = svb; p.svs = svs; p.svh = svh;
  p.sob = sob; p.sos = sos; p.soh = soh;
  p.ks = ks; p.vs = vs; p.ssb = ssb; p.sss = sss; p.ssh = ssh;
  p.KVH = KVH; p.G = G; p.C = C; p.Sk = Sk;
  p.qbase = prefix; p.qbase0 = 0; p.qbase_add = 0; p.slots = slots;
  p.share_src = share_src; p.share_len = share_len;
  p.causal = 1; p.window = window; p.scale = scale; p.vec = vec;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return dispatch_kv(
      qtype, kvtype, hd,
      [&](auto kt, auto d) {
        using KT = typename decltype(kt)::type;
        return fpc_run<float, KT, decltype(d)::value>(p, B, st);
      },
      [&](auto kt, auto d) {
        using KT = typename decltype(kt)::type;
        return fpc_tc_run<decltype(d)::value, KT>(p, B, NA, st);
      });
}
