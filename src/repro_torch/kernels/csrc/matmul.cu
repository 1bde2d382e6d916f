// matmul: C = A @ B with a float32 accumulator, C in A's dtype (fmatmul,
// the paper's Fig. 2 kernel).
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:51 (matmul /
// _matmul_kernel, pallas_call at :62).
//
// What it computes: A (M, K) and B (K, N), both float32 or both bfloat16,
// row-major with a unit last stride; C (M, N) contiguous.  Every element of
// C is one fmaf chain over k = 0 .. K-1 in order, started from 0, and is
// rounded to C's dtype once, at the end.  float32 inputs are multiplied in
// float32 on the CUDA cores (no TF32); bfloat16 inputs are widened to
// float32 in shared memory, so their products are exact.
//
// Design.  On the TPU the contraction is a sequential grid axis with the
// f32 accumulator block resident in VMEM, and ops.matmul zero-pads every
// axis to whole (256, 512, 256) blocks.  Here a 2-D grid of blocks covers
// 128 x 128 tiles of C; each block walks K in 32-deep tiles staged in
// shared memory (the next tile is read into registers while the current
// one is multiplied) and keeps its tile's accumulator in registers, an
// 8 x 8 micro-tile per thread.  Ragged M, N and K are masked inside the
// kernel: loads past an edge read 0 (a padded zero adds an exact zero, so
// this is the reference's padding without the copies) and stores past an
// edge are skipped.
//
// What bounds it on the H100: a 4096^3 product is 137.4 GFLOP against
// 201 MB (f32) or 101 MB (bf16) of operands and result, so operations
// bound it: 2.05 ms at the 67 TFLOP/s float32 CUDA-core peak, 0.139 ms at
// the 989 TFLOP/s bf16 tensor-core peak.  This first version runs both
// dtypes on the CUDA cores; bf16 on the tensor cores (mma / wgmma) is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;      // rows of C per block
constexpr int BN = 128;      // columns of C per block
constexpr int BK = 32;       // depth of one K tile
constexpr int NT = 256;      // threads per block, 16 x 16
constexpr int AS = BM + 4;   // row stride (floats) of the transposed A tile
constexpr int LA = BM * BK / NT;   // A elements each thread stages per tile
constexpr int LB = BK * BN / NT;   // B elements each thread stages per tile

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

template <typename T>
__global__ void __launch_bounds__(NT) matmul_kernel(
    const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
    long long lda, long long ldb, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][AS];   // A tile, transposed: [k][m]
  __shared__ __align__(16) float Bs[BK][BN];   // B tile: [k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;

  // staging: A element e = tid + NT * i is (row e / BK, k e % BK), so a
  // warp reads one row's 32 consecutive k; B element e is (k e / BN,
  // column e % BN), a warp reads 32 consecutive columns
  float ra[LA], rb[LB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + NT * i;
      const long long r = m0 + e / BK;
      const int k = k0 + e % BK;
      ra[i] = (r < M && k < K) ? to_f(A[r * lda + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + NT * i;
      const int k = k0 + e / BN;
      const long long c = n0 + e % BN;
      rb[i] = (k < K && c < N) ? to_f(B[(long long)k * ldb + c]) : 0.f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + NT * i;
      As[e % BK][e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + NT * i;
      Bs[e / BN][e % BN] = rb[i];
    }
  };

  // this thread's rows: 4 ty .. 4 ty + 3 and 64 + (same); columns
  // 4 tx .. 4 tx + 3 and 64 + (same)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) {
    fetch(0);
    stage();
    __syncthreads();
  }
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) fetch((t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = ld4(&As[kk][4 * ty]);
      const float4 a1 = ld4(&As[kk][64 + 4 * ty]);
      const float4 b0 = ld4(&Bs[kk][4 * tx]);
      const float4 b1 = ld4(&Bs[kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (t + 1 < nk) {
      stage();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (c < N) C[r * N + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int matmul_run(const void* a, const void* b, void* c, long long lda,
               long long ldb, int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  matmul_kernel<T><<<grid, NT, 0, s>>>(
      reinterpret_cast<const T*>(a), reinterpret_cast<const T*>(b),
      reinterpret_cast<T*>(c), lda, ldb, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  lda / ldb: row strides (elements) of A
// and B; C is written contiguous.  Returns cudaGetLastError() after the
// launch.
extern "C" int matmul_launch(int dtype, const void* a, const void* b,
                             void* c, long long lda, long long ldb, int M,
                             int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return matmul_run<float>(a, b, c, lda, ldb, M, N, K, s);
  if (dtype == 1)
    return matmul_run<__nv_bfloat16>(a, b, c, lda, ldb, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}
