// conv2d: valid 2-D convolution, NHWC x HWIO -> NHWC, float32 accumulator
// (fconv2d, the paper's 7 x 7 x 3 stencil, §VI.A).
//
// Replaces the TPU kernel src/repro/kernels/conv2d.py:46 (conv2d /
// _conv_kernel, pallas_call at :60).
//
// What it computes: y[n, oy, ox, co] = sum over (ky, kx, ci) of
// x[n, oy + ky, ox + kx, ci] * w[ky, kx, ci, co], for oy < H - KH + 1 and
// ox < W - KW + 1; x and w both float32 or both bfloat16 (widened to
// float32 when staged), y in x's dtype, rounded once.
//
// The order.  Each output is one fmaf chain over its KH KW Cin terms, in
// the order (pass, ky, ci, kx): for each pass over CC input channels, for
// each kernel row ky, for each channel ci of the pass, the KW taps left
// to right.  No sum is split and there are no atomics, so
// conv2d.py error_bound() holds (c = KH KW Cin + KH KW + Cin) and the
// same inputs give the same bits on every launch.
//
// What bounds it on the H100: operations.  The card shape (64, 112, 112,
// 3) x (7, 7, 3, 64) is 13.53 GFLOP against 193.76 MB: 0.202 ms at the
// 67 TFLOP/s of the CUDA cores' FFMA pipe, 0.058 ms for the bytes.  Every
// instruction that is not an FFMA takes an issue slot from one that is,
// and every shared-memory read a wavefront: a broadcast LDS.128 costs the
// same 4 wavefronts as one with 32 addresses, so the thread tile is the
// one that needs the fewest bytes of weights and inputs a FMA.
//
// Design.  conv2d.py plan() sizes every launch and passes its counts in;
// the launcher only checks their ranges and the shared-memory layout
// (tools/conv2d_variants.py times the choices below against their
// alternatives).
//  * Work.  The Wo columns of an output row are cut into G = ceil(Wo / R)
//    groups of R = 16; the groups of every (n, oy) row, GT a row within
//    one column tile (one tile of the width unless Wo > 256), form one
//    flat sequence q = (n Ho + oy) GT + g.  A thread computes one group
//    for CG = 4 output channels: 64 float32 accumulators.  A warp's lanes
//    are 32 / CGB groups x CGB channel groups (CGB 8 at Cout >= 32), so
//    the CGB lanes of a group hold the block's COB = 4 CGB channels of the
//    same pixels.  A block's NW warps (12; 4, one a scheduler, when a
//    channel block has fewer tiles of 12 warps than the card has SMs, as
//    at the sweep's Cout = 8) take TP = 32 NW / CGB consecutive groups
//    (a tile); Cout is cut into channel blocks of COB.  Rows are not
//    padded to tiles: only the last group of a row (16 - Wo % 16 of its
//    columns) and the last tile's tail lanes compute outputs that do not
//    exist (5.4% of the FMAs at Wo = 106), and those are not stored.
//  * Persistent blocks.  One block an SM (at most 168 registers a thread
//    at 12 warps, no spill): block b owns channel block b % ncb and walks
//    tiles b / ncb, + nbc, + 2 nbc, ... in that order.  Its weights,
//    [ky][ci][channel group: [kx][CG], an odd number of float4s], are
//    staged once and stay when all Cin channels fit (else CC channels a
//    pass, weights and halo for each (tile, pass) step, two weight
//    buffers).
//  * The halo.  A tile's groups span consecutive (n, oy) rows, maybe
//    across an image boundary; their input rows are the consecutive rows
//    n H + oy ... + KH - 1 of x seen as (N H) rows of W pixels, so the
//    halo of any tile is one run of rows (at most HR).  It is staged
//    channel-planar, [ci][row][col], each 16 columns in 20 floats (phys)
//    and rows HWP floats apart, into one of two buffers by cp.async
//    (LDGSTS, 4 bytes an element) while the block computes the step
//    before; bf16 elements are loaded, widened and stored instead.  One
//    __syncthreads a step.
//  * The register slide.  For each (ky, ci) a thread reads its R + KW - 1
//    inputs once (6 LDS.128 at KW = 7, issued during the (ky, ci) before)
//    and slides them across the KW taps, each tap one LDS.128 of 4
//    weights and 64 FFMA: 448 FFMA for 13 loads.  The 8 lanes of a
//    quarter-warp read one group's inputs (a broadcast) and 8 channel
//    groups' weights from 8 bank quads.  KW (3, 5, 7) and Cin = 3 are
//    template parameters so these loops unroll, as is NW; every other
//    shape takes the generic instantiation, which reads its inputs a tap
//    at a time.
//  * Stores.  At a tile's end each lane parks its 64 outputs in its own
//    64 floats of shared memory and stores them during the next tile's
//    FMAs, a column each (ky, ci): 16 bytes a lane, the CGB lanes of a
//    pixel writing COB contiguous channels (128 bytes at Cout = 64), with
//    streaming stores (__stcs), so the SMs' stores do not all land at
//    once at the tiles' ends.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// conv2d.py's R, CG, WARPS and SMALL_WARPS
constexpr int R = 16;              // output columns a thread
constexpr int CG = 4;              // output channels a thread
constexpr int WARPS = 12;          // warps a block
constexpr int SMALL_WARPS = 4;     // warps a block when WARPS idle SMs
constexpr int MAX_SMEM = 227 * 1024 - 64;   // less the static tinfo

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// a halo row's column c in shared memory: each 16 columns (a thread's
// group) take 20 floats, so lanes of consecutive groups, 20 floats apart,
// read their 16 bytes from different bank quads
__host__ __device__ constexpr int phys(int c) { return c + (c >> 4) * 4; }
// floats a channel group's KW taps take in shared memory: an odd number of
// float4s, so the 8 channel groups a quarter-warp reads lie in 8 bank quads
__host__ __device__ constexpr int wstride(int kw) {
  return (kw + 1 - kw % 2) * 4;
}
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one element into shared memory: float32 by cp.async, bf16 widened
__device__ __forceinline__ void put(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void put(float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* x;     // (N, H, W, Cin) contiguous
  const void* w;     // (KH, KW, Cin, Cout) contiguous
  void* y;           // (N, Ho, Wo, Cout) contiguous
  int N, H, W, Cin, KH, KW, Cout, Ho, Wo;
  int G;             // groups of R columns in an output row
  int GT;            // groups a row of a column tile
  int TP;            // groups a tile: 32 warps / CGB
  int CGB;           // channel groups of CG a block: a power of 2, <= 32
  int ncb;           // channel blocks
  int tiles_ct;      // tiles a column tile
  int tiles;         // tiles in all
  int CC;            // input channels a pass
  int nchunk;        // passes
  int HR;            // halo rows a buffer
  int HWP;           // halo row stride, floats
  int w_floats;      // one weight buffer
  int x_floats;      // one halo buffer
  int vec;           // 1: 4-channel vector stores are legal
};

// where a tile lies: its groups q0 .. q1 of column tile ct, its halo the
// input rows v0 .. v0 + rows - 1 (of the N H) and columns col0 .. + width
struct Tile {
  int ct, q0, q1, v0, rows, col0, width;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int t, int KW) {
  Tile g;
  g.ct = t / a.tiles_ct;
  const int total = a.N * a.Ho * a.GT;
  g.q0 = (t - g.ct * a.tiles_ct) * a.TP;
  g.q1 = min(g.q0 + a.TP, total) - 1;
  const int row0 = g.q0 / a.GT, row1 = g.q1 / a.GT;
  g.v0 = row0 + row0 / a.Ho * (a.KH - 1);
  g.rows = row1 + row1 / a.Ho * (a.KH - 1) + a.KH - g.v0;
  g.col0 = g.ct * a.GT * R;
  g.width = min(a.GT * R + KW - 1, a.W - g.col0);
  return g;
}

// CG = 4 consecutive outputs: one streaming store of 16 (f32) or 8
// (bf16) bytes; the caller guarantees alignment
__device__ __forceinline__ void store4(float* y, const float* v) {
  __stcs(reinterpret_cast<float4*>(y), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* y, const float* v) {
  __align__(8) __nv_bfloat16 h[4] = {
      __float2bfloat16(v[0]), __float2bfloat16(v[1]), __float2bfloat16(v[2]),
      __float2bfloat16(v[3])};
  __stcs(reinterpret_cast<uint2*>(y), *reinterpret_cast<const uint2*>(h));
}

template <typename T, int KW_, int CIN_, int NW_>
__global__ void __launch_bounds__(NW_ * 32, 1) conv2d_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  // threads a block: a constant (blockDim.x in its place costs 4% at the
  // card shape: tools/conv2d_variants.py)
  constexpr int NT = NW_ * 32;
  // each step's tile (q0, q1, v0, ct, col0), written where it is staged
  // and read back after the barrier, so no register holds it through the
  // step's FMAs
  __shared__ int tinfo[2][5];
  const int KW = KW_ > 0 ? KW_ : a.KW;
  const int KH = a.KH;
  const int WST = wstride(KW);                   // floats a group's taps
  const int nwb = a.nchunk > 1 ? 2 : 1;          // weight buffers
  float* const xs_all = sm + nwb * a.w_floats;   // two halo buffers
  // [R][NT][CG]: each lane's outputs of its last tile, stored to y a
  // column at a time during the next tile's FMAs
  float* const slots = xs_all + 2 * a.x_floats + tid * CG;
  const int COB = a.CGB * CG;
  const T* x = reinterpret_cast<const T*>(a.x);
  const T* w = reinterpret_cast<const T*>(a.w);

  // lane = (group in warp) x CGB + channel group: the CGB lanes of a
  // group hold the block's COB channels of the same pixels
  const int lane = tid & 31, warp = tid >> 5;
  const int cgl = lane & (a.CGB - 1);            // channel group in block
  const int gw = warp * (32 / a.CGB) + lane / a.CGB;  // group in tile
  const int cb = blockIdx.x % a.ncb;
  const int nbc = gridDim.x / a.ncb;
  const int t0 = blockIdx.x / a.ncb;
  const int co0 = (cb * a.CGB + cgl) * CG;       // this lane's channels
  const int ntile = t0 < a.tiles ? (a.tiles - 1 - t0) / nbc + 1 : 0;
  const int nsteps = ntile * a.nchunk;
  if (nsteps == 0) return;                       // uniform over the block

  for (int i = tid; i < nwb * a.w_floats + 2 * a.x_floats; i += NT)
    sm[i] = 0.f;
  __syncthreads();

  // stage step s: tile t0 + (s / nchunk) nbc, channels of chunk s % nchunk
  auto stage = [&](int s) {
    const Tile g = tile_of(a, t0 + s / a.nchunk * nbc, KW);
    if (tid == 0) {
      int* ti = tinfo[s & 1];
      ti[0] = g.q0; ti[1] = g.q1; ti[2] = g.v0; ti[3] = g.ct;
      ti[4] = g.col0;
    }
    const int c0 = s % a.nchunk * a.CC;
    const int cc = min(a.CC, a.Cin - c0);
    float* xs = xs_all + (s & 1) * a.x_floats;
    const int plane = a.HR * a.HWP;
    const int npix = g.rows * g.width;
    const int dr = NT / g.width, dc = NT - dr * g.width;
    int r = tid / g.width, cx = tid - r * g.width;
    for (int p = tid; p < npix; p += NT) {
      const T* src =
          x + ((long long)(g.v0 + r) * a.W + g.col0 + cx) * a.Cin + c0;
      float* dst = xs + r * a.HWP + phys(cx);
      for (int ci = 0; ci < cc; ++ci) put(dst + ci * plane, src + ci);
      r += dr;                                   // p + NT, no division
      cx += dc;
      if (cx >= g.width) {
        cx -= g.width;
        ++r;
      }
    }
    if (a.nchunk == 1 && s > 0) return;          // the weights stay
    // [ky][ci][channel group, WST floats: [kx][CG]]
    float* ws = sm + (a.nchunk > 1 ? (s & 1) * a.w_floats : 0);
    const int nwt = KH * cc * a.CGB * KW * CG;
    for (int e = tid; e < nwt; e += NT) {
      int r = e / CG;
      const int kx = r % KW;
      r /= KW;                                   // (ky, ci, group)
      const int co = cb * COB + r % a.CGB * CG + e % CG;
      const int ci = r / a.CGB % cc, ky = r / a.CGB / cc;
      float* dst = ws + r * WST + kx * CG + e % CG;
      if (co < a.Cout)
        put(dst, w + ((long long)(ky * KW + kx) * a.Cin + c0 + ci) *
                         a.Cout + co);
      else
        *dst = 0.f;
    }
  };

  float acc[R][CG];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int o = 0; o < CG; ++o) acc[j][o] = 0.f;

  // the pending tile's outputs: y at this lane's first column and
  // channel, the columns that exist (0: none), the next column to store
  T* pend_y = reinterpret_cast<T*>(a.y);
  int pend_nj = 0, pend_next = R;
  auto store_next = [&]() {
    if (pend_next < pend_nj) {
      const float4 v = ld4(slots + pend_next * NT * CG);
      const float f[CG] = {v.x, v.y, v.z, v.w};
      T* yp = pend_y + (long long)pend_next * a.Cout;
      if (a.vec) {
        store4(yp, f);
      } else {
#pragma unroll
        for (int o = 0; o < CG; ++o)
          if (co0 + o < a.Cout) yp[o] = from_f<T>(f[o]);
      }
    }
    ++pend_next;
  };

  stage(0);
  cp_commit();
  for (int s = 0; s < nsteps; ++s) {
    cp_wait_all();
    __syncthreads();             // step s staged; step s - 1 read by all
    if (s + 1 < nsteps) {
      stage(s + 1);
      cp_commit();
    }
    const int c = s % a.nchunk;
    const int cc = min(a.CC, a.Cin - c * a.CC);
    {
      const int* ti = tinfo[s & 1];
      const int q = min(ti[0] + gw, ti[1]);      // tail lanes: a real row
      const int row = q / a.GT, gl = q - row * a.GT;
      const int hrow = row + row / a.Ho * (KH - 1) - ti[2];
      const float* xp = xs_all + (s & 1) * a.x_floats + hrow * a.HWP +
                        phys(gl * R);
      const float* wp = sm + (a.nchunk > 1 ? (s & 1) * a.w_floats : 0) +
                        cgl * WST;
      const int ccu = CIN_ > 0 ? CIN_ : cc;
      constexpr int NV = (R + (KW_ > 0 ? KW_ : 1) - 1 + 3) / 4;
      // the slide's inputs of the next (ky, ci), read while this one's
      // FMAs run
      float nxt[NV * 4];
      auto load_in = [&](const float* xr) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float4 v = ld4(xr + phys(4 * i));
          nxt[4 * i] = v.x;
          nxt[4 * i + 1] = v.y;
          nxt[4 * i + 2] = v.z;
          nxt[4 * i + 3] = v.w;
        }
      };
      if constexpr (KW_ > 0) load_in(xp);
#pragma unroll 1
      for (int ky = 0; ky < KH; ++ky) {
#pragma unroll (CIN_ > 0 ? CIN_ : 1)
        for (int ci = 0; ci < ccu; ++ci) {
          if (pend_next < R) store_next();        // warp-uniform
          const float* xr = xp + (ci * a.HR + ky) * a.HWP;
          const float* wr = wp + (ky * ccu + ci) * a.CGB * WST;
          if constexpr (KW_ > 0) {
            // the slide: R + KW - 1 inputs read once, 16 bytes at a time
            // (the chunks past the group's 16 columns skip the swizzle gap)
            float in[NV * 4];
#pragma unroll
            for (int i = 0; i < NV * 4; ++i) in[i] = nxt[i];
            if (ci + 1 < ccu)
              load_in(xr + a.HR * a.HWP);
            else if (ky + 1 < KH)
              load_in(xp + (ky + 1) * a.HWP);
#pragma unroll
            for (int kx = 0; kx < KW_; ++kx) {
              const float* wk = wr + kx * CG;
              const float4 w4 = ld4(wk);
              const float wv[CG] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
              for (int j = 0; j < R; ++j)
#pragma unroll
                for (int o = 0; o < CG; ++o)
                  acc[j][o] = fmaf(in[j + kx], wv[o], acc[j][o]);
            }
          } else {
            for (int kx = 0; kx < KW; ++kx) {
              const float4 w4 = ld4(wr + kx * CG);
              const float wv[CG] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
              for (int j = 0; j < R; ++j) {
                const float v = xr[phys(kx + j)];
#pragma unroll
                for (int o = 0; o < CG; ++o)
                  acc[j][o] = fmaf(v, wv[o], acc[j][o]);
              }
            }
          }
        }
      }
    }
    if (c < a.nchunk - 1) continue;
    // the tile's last pass: finish the pending tile's stores, park this
    // tile's outputs in the lane's slots and restart the accumulators
    while (pend_next < R) store_next();
    const int* ti = tinfo[s & 1];
    const int q = ti[0] + gw, q1 = ti[1];
    const int row = min(q, q1) / a.GT, gl = min(q, q1) - row * a.GT;
    const int ox0 = ti[4] + gl * R;
    pend_y = reinterpret_cast<T*>(a.y) +
             ((long long)row * a.Wo + ox0) * a.Cout + co0;
    pend_nj = q <= q1 && ti[3] * a.GT + gl < a.G && co0 < a.Cout
                  ? min(R, a.Wo - ox0) : 0;
    pend_next = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      *reinterpret_cast<float4*>(slots + j * NT * CG) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
#pragma unroll
      for (int o = 0; o < CG; ++o) acc[j][o] = 0.f;
    }
  }
  while (pend_next < R) store_next();            // the last tile's
}

template <typename T, int KW_, int CIN_, int NW_>
int conv2d_run(const Args& a, int grid, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_kernel<T, KW_, CIN_, NW_>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  conv2d_kernel<T, KW_, CIN_, NW_><<<grid, NW_ * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int NW_>
int conv2d_by_kw(const Args& a, int grid, size_t smem, cudaStream_t s) {
  if (a.KW == 7)
    return a.Cin == 3 && a.nchunk == 1
               ? conv2d_run<T, 7, 3, NW_>(a, grid, smem, s)
               : conv2d_run<T, 7, 0, NW_>(a, grid, smem, s);
  if (a.KW == 5) return conv2d_run<T, 5, 0, NW_>(a, grid, smem, s);
  if (a.KW == 3) return conv2d_run<T, 3, 0, NW_>(a, grid, smem, s);
  return conv2d_run<T, 0, 0, NW_>(a, grid, smem, s);
}

template <typename T>
int conv2d_dispatch(const Args& a, int nw, int grid, size_t smem,
                    cudaStream_t s) {
  return nw == WARPS ? conv2d_by_kw<T, WARPS>(a, grid, smem, s)
                     : conv2d_by_kw<T, SMALL_WARPS>(a, grid, smem, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  All tensors contiguous.  GT .. smem:
// conv2d.py plan()'s counts (launch_args()), which size the launch: GT
// groups of R = 16 output columns a column tile, CGB channel groups of CG
// a block, ncb channel blocks, NW warps a block (WARPS or SMALL_WARPS,
// each instantiated), tiles_ct tiles a column tile, tiles in all, CC
// input channels a pass, nchunk passes, HR halo rows of HWP floats,
// w_floats / x_floats floats a weight / halo buffer, grid blocks (a
// multiple of ncb) and smem bytes.  This launcher checks only that they
// are in range and that the kernel's shared-memory layout fills smem
// within the card's budget.  vec: 1 if Cout % 8 == 0 and y is
// 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int conv2d_launch(int dtype, const void* x, const void* w,
                             void* y, int N, int H, int W, int Cin, int KH,
                             int KW, int Cout, int GT, int CGB, int ncb,
                             int NW, int tiles_ct, int tiles, int CC,
                             int nchunk, int HR, int HWP, int w_floats,
                             int x_floats, int grid, long long smem, int vec,
                             void* stream) {
  const int Ho = H - KH + 1, Wo = W - KW + 1;
  const int G = (Wo + R - 1) / R;
  const bool bad_shape = N < 1 || Cin < 1 || Cout < 1 || KH < 1 ||
                         KW < 1 || Ho < 1 || Wo < 1;
  const bool bad_plan =
      GT < 1 || GT > G || CGB < 1 || CGB > 32 || (CGB & (CGB - 1)) ||
      (long long)ncb * CGB * CG < Cout ||
      (NW != WARPS && NW != SMALL_WARPS) ||
      tiles_ct < 1 || tiles < tiles_ct || CC < 1 || CC > Cin ||
      (long long)CC * nchunk < Cin || HR < KH || HWP < GT * R + KW - 1 ||
      HWP % 4 || grid < ncb || grid % ncb;
  if (bad_shape || bad_plan) return (int)cudaErrorInvalidValue;
  // the layout: weight buffers (two with passes), two halo buffers, the
  // lanes' output slots
  const long long wf = (long long)KH * CC * CGB * wstride(KW);
  const long long xf = (long long)CC * HR * HWP;
  const long long bytes = 4 * ((nchunk > 1 ? 2 : 1) * (long long)w_floats +
                               2LL * x_floats + (long long)R * NW * 32 * CG);
  if (w_floats < wf || x_floats < xf || bytes != smem || bytes > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.w = w; a.y = y;
  a.N = N; a.H = H; a.W = W; a.Cin = Cin; a.KH = KH; a.KW = KW;
  a.Cout = Cout; a.Ho = Ho; a.Wo = Wo; a.G = G; a.GT = GT; a.CGB = CGB;
  a.ncb = ncb; a.TP = NW * 32 / CGB; a.tiles_ct = tiles_ct;
  a.tiles = tiles; a.CC = CC; a.nchunk = nchunk; a.HR = HR; a.HWP = HWP;
  a.w_floats = w_floats; a.x_floats = x_floats; a.vec = vec;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return conv2d_dispatch<float>(a, NW, grid, smem, s);
  if (dtype == 1)
    return conv2d_dispatch<__nv_bfloat16>(a, NW, grid, smem, s);
  return (int)cudaErrorInvalidValue;
}
