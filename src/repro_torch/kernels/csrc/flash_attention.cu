// flash_attention: forward attention with causal and/or sliding-window
// masks, queries right-aligned to the keys (qpos = i + Sk - Sq).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:84
// (flash_attention / _fa_kernel, pallas_call at :102).
//
// What bounds it on the H100: operations (causal S = 1024 at llama3.2-3b
// width is ~6.4 GFLOP per layer, ~6.5 us at 989 TFLOP/s bf16).  bf16 runs
// on the tensor cores (flash_tc.cuh: wgmma QK^T and exact-P PV products,
// P in three bf16 terms, over TMA-loaded K/V strips in a 2-stage ring),
// one warpgroup per 64 folded query rows (row r = g * Sq + i); f32 runs
// flash_common.cuh's CUDA-core tile with 32 rows per CTA.  GQA is read in
// place: K/V keep their KVH heads and the G query heads of a KV head index
// it as h // G, so the reference's jnp.repeat (transformer.py:179-180) is
// never materialised.  Strips past the tile's last query position (causal)
// or before its window are skipped, and keys past Sk are masked inside the
// kernel, so neither operand needs padding.  The bf16 grid is 1-D and
// launches the heaviest causal tiles (latest query rows) first, so the
// light ones fill the tail on 132 SMs.
#include "flash_common.cuh"
#include "flash_tc.cuh"

using namespace fk;

constexpr int FA_ROWS = 32;

template <typename T, int D>
__global__ void __launch_bounds__(NT) fa_kernel(Problem p) {
  extern __shared__ __align__(16) char smem[];
  using TT = Tile<T, D, FA_ROWS>;
  TT t;
  t.init(smem);
  const int r0 = blockIdx.x * FA_ROWS, bkv = blockIdx.y;
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  t.load_q(p, b, kvh, r0);
  t.run_keys(p, kvh, 0, p.Sk);
  t.store(p, b, kvh, r0, t.acc, t.Ls);
  if (p.lse) t.store_lse(p, bkv, r0);
}

template <typename T, int D>
static int fa_run(const Problem& p, int B, cudaStream_t st) {
  const size_t smem = Smem<D, FA_ROWS>::bytes;
  cudaError_t e = allow_smem(fa_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (p.G * p.C + FA_ROWS - 1) / FA_ROWS;
  fa_kernel<T, D><<<dim3(tiles, B * p.KVH), NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
__global__ void __launch_bounds__(NT)
fa_tc_kernel(Problem p, const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv, int bmul) {
  extern __shared__ __align__(128) char tc_smem[];
  tc::TcTile<D> t;
  t.init(tc_smem);
  int bkv, r0;
  tc::tile_of(p, blockIdx.x, &bkv, &r0);
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  t.load_q(p, b, kvh, r0);
  t.run(p, &mk, &mv, kvh, bmul, t.lim[0], t.lim[1], [](int) {});
  t.store(p, b, kvh, r0, t.o, t.l);
  if (p.lse) t.store_lse(p, bkv, r0);
}

template <int D>
static int fa_tc_run(const Problem& p, int B, cudaStream_t st) {
  if (!p.vec) return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  int bmul;
  int e = tc::make_maps(p, B, &mk, &mv, &bmul, D);
  if (e) return e;
  const size_t smem = tc::Cfg<D>::smem;
  e = (int)allow_smem(fa_tc_kernel<D>, smem);
  if (e) return e;
  const int tiles = (p.G * p.C + tc::ROWS - 1) / tc::ROWS;
  fa_tc_kernel<D><<<tiles * B * p.KVH, NT, smem, st>>>(p, mk, mv, bmul);
  return (int)cudaGetLastError();
}

// q (B, H, Sq, D), k/v (B, KVH, Sk, D), o (B, H, Sq, D), all by strides
// (batch, position, head); H = KVH * G.  bf16 needs vec (16-byte aligned
// bases and strides: the TMA map and the Q loads).
// lse: null (serving), or a (B, H, Sq) f32 buffer for the row log-sum-exp
// the backward pass reads (training); O's bits do not depend on it.
extern "C" int fa_launch(int dtype, int hd, const void* q, const void* k,
                         const void* v, void* o,
                         long long sqb, long long sqs, long long sqh,
                         long long skb, long long sks, long long skh,
                         long long svb, long long svs, long long svh,
                         long long sob, long long sos, long long soh,
                         int B, int KVH, int G, int Sq, int Sk, int causal,
                         int window, float scale, int vec, float* lse,
                         void* stream) {
  Problem p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.skb = skb; p.sks = sks; p.skh = skh;
  p.svb = svb; p.svs = svs; p.svh = svh;
  p.sob = sob; p.sos = sos; p.soh = soh;
  p.KVH = KVH; p.G = G; p.C = Sq; p.Sk = Sk;
  p.qbase = nullptr; p.qbase0 = Sk - Sq; p.qbase_add = 0;
  p.causal = causal; p.window = window; p.scale = scale; p.vec = vec;
  p.lse = lse;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return FK_DISPATCH(dtype, hd, fa_run, fa_tc_run, p, B, st);
}
