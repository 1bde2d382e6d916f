// conv2d: valid 2-D convolution, NHWC x HWIO -> NHWC, float32 accumulator
// (fconv2d, the paper's 7 x 7 x 3 stencil, §VI.A).
//
// Replaces the TPU kernel src/repro/kernels/conv2d.py:46 (conv2d /
// _conv_kernel, pallas_call at :60).
//
// What it computes: y[n, oy, ox, co] = sum over (ky, kx, ci) of
// x[n, oy + ky, ox + kx, ci] * w[ky, kx, ci, co], for oy < H - KH + 1 and
// ox < W - KW + 1; x and w both float32 or both bfloat16 (widened to
// float32), y in x's dtype, rounded once.  Each output is one fmaf chain
// over (channel chunk, ky, kx, ci) in that order.
//
// Design.  The TPU kernel stages the whole image of one batch element in
// VMEM (conv2d.py:8-13) and accumulates KH * KW (bh * bw, Cin) x (Cin,
// Cout) products.  A Hopper block has 227 KB of shared memory, less than
// one 112 x 112 x 3 f32 image with room to spare, so each block here
// computes one TH x TW = 8 x 16 tile of output pixels for a block of
// CO = 64 output channels: it stages the (TH + KH - 1) x (TW + KW - 1)
// input halo and the KH x KW x Cin x CO weights in shared memory, CC input
// channels at a time (all of them when they fit: Cin = 3 takes 41 KB at
// 7 x 7), and keeps 4 pixels x 8 channels per thread in float32
// registers.  Pixels of Cin = 3 are 12 bytes, so the halo is staged with
// scalar loads (consecutive threads on consecutive elements of a row).
// Output pixels past Ho / Wo and channels past Cout are masked in the
// kernel; the reference pads the output to whole tiles instead.
//
// What bounds it on the H100: the card shape (64, 112, 112, 3) x (7, 7, 3,
// 64) is 13.53 GFLOP against 193.8 MB, so operations bound it in float32:
// 0.202 ms at the 67 TFLOP/s CUDA-core peak (bytes alone: 0.058 ms).  This
// first version runs on the CUDA cores; an implicit GEMM on the tensor
// cores is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;        // output rows per block
constexpr int TW = 16;       // output columns per block
constexpr int CO = 64;       // output channels per block
constexpr int NT = 256;      // threads: 8 channel groups x 32 pixel groups

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 8 consecutive outputs, one 16-byte store each for f32 (two) and bf16
// (one); the caller guarantees alignment
__device__ __forceinline__ void store8(float* y, const float* v) {
  reinterpret_cast<float4*>(y)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(y)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* y, const float* v) {
  __align__(16) __nv_bfloat16 h[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) h[q] = __float2bfloat16(v[q]);
  *reinterpret_cast<uint4*>(y) = *reinterpret_cast<const uint4*>(h);
}

struct Args {
  const void* x;     // (N, H, W, Cin) contiguous
  const void* w;     // (KH, KW, Cin, Cout) contiguous
  void* y;           // (N, Ho, Wo, Cout) contiguous
  int H, W, Cin, KH, KW, Cout, Ho, Wo;
  int CC;            // input channels staged per pass
  int xs_floats;     // halo floats, rounded up to a multiple of 4
  int vec;           // 1: 8-channel vector stores are legal
};

template <typename T>
__global__ void __launch_bounds__(NT) conv2d_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int HW = TW + a.KW - 1;
  const int HH = TH + a.KH - 1;
  const int CC = a.CC;
  float* xs = sm;                   // [HH][HW][CC] halo
  float* ws = sm + a.xs_floats;     // [KH][KW][CC][CO] weights

  const int tid = threadIdx.x;
  const int tiles_w = (a.Wo + TW - 1) / TW;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * CO;
  const long long nb = blockIdx.z;
  const T* x = reinterpret_cast<const T*>(a.x);
  const T* w = reinterpret_cast<const T*>(a.w);

  // this thread: channels co0 + 8 cg .. + 7 of pixels (prow, pcol .. +3)
  const int cg = tid % 8, pg = tid / 8;
  const int prow = pg / 4, pcol = (pg % 4) * 4;

  float acc[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[j][q] = 0.f;

  for (int c0 = 0; c0 < a.Cin; c0 += CC) {
    const int cc = min(CC, a.Cin - c0);
    const int nx = HH * HW * cc;
    for (int e = tid; e < nx; e += NT) {
      const int ci = e % cc, p = e / cc;
      const int hx = p % HW, hy = p / HW;
      const int iy = oy0 + hy, ix = ox0 + hx;
      float v = 0.f;
      if (iy < a.H && ix < a.W)
        v = to_f(x[((nb * a.H + iy) * a.W + ix) * a.Cin + c0 + ci]);
      xs[(hy * HW + hx) * CC + ci] = v;
    }
    const int nw = a.KH * a.KW * cc * CO;
    for (int e = tid; e < nw; e += NT) {
      const int co = e % CO, r = e / CO;
      const int ci = r % cc, tap = r / cc;
      float v = 0.f;
      if (co0 + co < a.Cout)
        v = to_f(w[((long long)tap * a.Cin + c0 + ci) * a.Cout + co0 + co]);
      ws[(tap * CC + ci) * CO + co] = v;
    }
    __syncthreads();
    for (int ky = 0; ky < a.KH; ++ky) {
      for (int kx = 0; kx < a.KW; ++kx) {
        const float* xp = xs + ((prow + ky) * HW + pcol + kx) * CC;
        const float* wp = ws + (ky * a.KW + kx) * CC * CO + 8 * cg;
        for (int ci = 0; ci < cc; ++ci) {
          const float4 w0 = ld4(wp + ci * CO);
          const float4 w1 = ld4(wp + ci * CO + 4);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                               w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float xv = xp[j * CC + ci];
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[j][q] = fmaf(xv, wv[q], acc[j][q]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + prow;
  if (oy >= a.Ho) return;
  T* y = reinterpret_cast<T*>(a.y);
  const int cb = co0 + 8 * cg;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ox = ox0 + pcol + j;
    if (ox >= a.Wo) continue;
    T* yp = y + ((nb * a.Ho + oy) * a.Wo + ox) * a.Cout + cb;
    if (a.vec && cb + 8 <= a.Cout) {
      store8(yp, acc[j]);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (cb + q < a.Cout) yp[q] = from_f<T>(acc[j][q]);
    }
  }
}

template <typename T>
int conv2d_run(const Args& a, int N, size_t smem, cudaStream_t s) {
  const int tiles = ((a.Ho + TH - 1) / TH) * ((a.Wo + TW - 1) / TW);
  const dim3 grid(tiles, (a.Cout + CO - 1) / CO, N);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  conv2d_kernel<T><<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  All tensors contiguous.  CC: input
// channels staged per pass (1 <= CC <= Cin).  vec: 1 if Cout % 8 == 0 and
// y is 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int conv2d_launch(int dtype, const void* x, const void* w,
                             void* y, int N, int H, int W, int Cin, int KH,
                             int KW, int Cout, int CC, int vec,
                             void* stream) {
  const int Ho = H - KH + 1, Wo = W - KW + 1;
  if (N < 1 || Cin < 1 || Cout < 1 || KH < 1 || KW < 1 || Ho < 1 ||
      Wo < 1 || CC < 1 || CC > Cin)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.w = w; a.y = y;
  a.H = H; a.W = W; a.Cin = Cin; a.KH = KH; a.KW = KW; a.Cout = Cout;
  a.Ho = Ho; a.Wo = Wo; a.CC = CC; a.vec = vec;
  // shared memory: the halo, rounded up to whole float4s, then the
  // weights (conv2d.py smem_floats() is the same count)
  const long long halo = (long long)(TH + KH - 1) * (TW + KW - 1) * CC;
  a.xs_floats = (int)((halo + 3) / 4 * 4);
  const size_t smem =
      ((size_t)a.xs_floats + (size_t)KH * KW * CC * CO) * sizeof(float);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return conv2d_run<float>(a, N, smem, s);
  if (dtype == 1) return conv2d_run<__nv_bfloat16>(a, N, smem, s);
  return (int)cudaErrorInvalidValue;
}
