// matmul: C = A @ B with a float32 accumulator, C in A's dtype (fmatmul,
// the paper's Fig. 2 kernel).
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:51 (matmul /
// _matmul_kernel, pallas_call at :62).
//
// What it computes: A (M, K) and B (K, N), both float32 or both bfloat16,
// row-major with a unit last stride; C (M, N) contiguous.  Every element of
// C is one fmaf chain over k = 0 .. K-1 in order, started from 0, and is
// rounded to C's dtype once, at the end; no split-K, so the bits repeat
// from call to call.  float32 inputs are multiplied in float32 on the CUDA
// cores (no TF32, no split into TF32 terms); bfloat16 inputs are widened to
// float32 in shared memory, so their products are exact.  Ragged M, N and
// K are masked inside the kernel: loads past an edge read 0 (a padded zero
// adds an exact zero, so this is the reference's padding without the
// copies) and stores past an edge are skipped.
//
// What bounds it on the H100: a 4096^3 product is 137.4 GFLOP against
// 201 MB (f32) of operands and result, so operations bound it: 2.05 ms at
// the 67 TFLOP/s float32 CUDA-core peak (0.139 ms for bf16 at the 989
// TFLOP/s tensor-core peak).
//
// float32 design (mm_f32_kernel).  On the TPU the contraction is a
// sequential grid axis with the f32 accumulator block resident in VMEM.
// Here a 2-D grid of 256-thread blocks covers 128 x 128 tiles of C, an
// 8 x 8 register micro-tile per thread, and walks K in 16-deep tiles:
//   * the tiles travel by cp.async (LDGSTS) straight into a ring of four
//     shared-memory stages, three tiles in flight ahead of the one being
//     multiplied, with one __syncthreads per K tile;
//   * __launch_bounds__(256, 2): at most 128 registers a thread (127 used,
//     no spills), so two blocks (16 warps) share an SM; the ring is 66 KB
//     a block;
//   * A is transposed on the copy, one 4-byte LDGSTS per element, into
//     As[k][m] with a row stride of 136 floats; a warp copies 8 rows x 4
//     consecutive k, so its 32 stores land on banks 8 kq + g + 8 i (mod 32):
//     0 conflicts; the float4 fragment reads As[k][4 ty] are broadcasts
//     within each 8-lane phase: 0 conflicts; B goes row-major by 16-byte
//     LDGSTS (4-byte when its rows are not 16-byte aligned), a warp per 128
//     consecutive floats: 0 conflicts on stores and float4 reads.
//
// bfloat16 (mm_bf16_kernel) keeps the first design: 128 x 128 tiles, 32-deep
// K tiles staged through registers, on the CUDA cores.  No path launches it;
// its tensor-core design is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;      // rows of C per block
constexpr int BN = 128;      // columns of C per block
constexpr int NT = 256;      // threads per block, 16 x 16
// -- bfloat16: register staging (the first design) --------------------------
constexpr int BK = 32;       // depth of one bf16 K tile
constexpr int AS = BM + 4;   // row stride (floats) of the transposed A tile
constexpr int LA = BM * BK / NT;   // A elements each thread stages per tile
constexpr int LB = BK * BN / NT;   // B elements each thread stages per tile

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(NT) mm_bf16_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ B,
    bf16* __restrict__ C, long long lda, long long ldb, int M, int N, int K) {
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
      ra[i] = (r < M && k < K) ? __bfloat162float(A[r * lda + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + NT * i;
      const int k = k0 + e / BN;
      const long long c = n0 + e % BN;
      rb[i] = (k < K && c < N) ? __bfloat162float(B[(long long)k * ldb + c]) : 0.f;
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
      if (c < N) C[r * N + c] = __float2bfloat16(acc[i][j]);
    }
  }
}

// -- float32: cp.async ring ------------------------------------------------
constexpr int FK = 16;                   // depth of one K tile
constexpr int STAGES = 4;                // shared-memory ring
constexpr int FAS = BM + 8;              // row stride of As (see the header)
constexpr int A_STAGE = FK * FAS;        // floats of one A stage, [k][m]
constexpr int B_STAGE = FK * BN;         // floats of one B stage, [k][n]
constexpr size_t F_SMEM = (size_t)STAGES * (A_STAGE + B_STAGE) * 4;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// src_bytes < size zero-fills the rest of the destination
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// VB: B's rows are 16-byte aligned (ldb % 4 == 0, aligned base): 16-byte
// copies; else 4-byte copies into the same layout
template <bool VB>
__global__ void __launch_bounds__(NT, 2) mm_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, long long lda, long long ldb, int M, int N,
    int K) {
  extern __shared__ __align__(16) float fsm[];
  float* As = fsm;                       // [STAGES][FK][FAS]: A^T tiles
  float* Bs = fsm + STAGES * A_STAGE;    // [STAGES][FK][BN]

  const int tid = threadIdx.x;
  const int lane = tid % 32, wid = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;

  // A staging, transposed on the copy: copy i takes row 64 (wid & 1) +
  // 8 i + lane / 4 at k = 4 (wid >> 1) + lane % 4 (a warp: 8 rows x 4
  // consecutive k, no bank conflicts).  Rows do not change along K: their
  // mask is set once.
  const int a_row = 64 * (wid & 1) + lane / 4;
  const int a_k = 4 * (wid >> 1) + lane % 4;
  unsigned a_rows = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a_rows |= (unsigned)(m0 + a_row + 8 * i < M) << i;
  const float* a_src = A + (m0 + a_row) * lda + a_k;
  float* a_dst = As + a_k * FAS + a_row;
  // B staging.  VB: copy i takes row tid / 32 + 8 i, 4 columns at
  // 4 (tid % 32); else row tid / 128 + 2 i, column tid % 128
  const int b_k = VB ? tid / (BN / 4) : tid / BN;
  const int b_c = VB ? 4 * (tid % (BN / 4)) : tid % BN;
  const long long b_left = N - (n0 + b_c);
  const int b_bytes = b_left <= 0 ? 0 : 4 * (int)(b_left < 4 ? b_left : 4);
  const float* b_src = B + (long long)b_k * ldb + n0 + b_c;
  float* b_dst = Bs + b_k * BN + b_c;
  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * FK;
    const float* as = a_src + k0;
    float* ad = a_dst + stage * A_STAGE;
    const bool k_ok = k0 + a_k < K;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool ok = k_ok && ((a_rows >> i) & 1u);
      cp_async4(ad + 8 * i, ok ? as + 8 * i * lda : A, ok ? 4 : 0);
    }
    const float* bsrc = b_src + (long long)k0 * ldb;
    float* bd = b_dst + stage * B_STAGE;
    constexpr int NB = VB ? 2 : 8;          // copies a thread, a tile
    constexpr int KSTEP = NT * (VB ? 4 : 1) / BN;   // rows between them
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const bool ok = k0 + b_k + KSTEP * i < K;
      const float* src = bsrc + (long long)KSTEP * i * ldb;
      if (VB)
        cp_async16(bd + KSTEP * i * BN, ok && b_bytes ? src : B,
                   ok ? b_bytes : 0);
      else
        cp_async4(bd + KSTEP * i * BN, ok && b_bytes ? src : B,
                  ok && b_bytes ? 4 : 0);
    }
  };

  // this thread's rows: 4 ty .. 4 ty + 3 and 64 + (same); columns
  // 4 tx .. 4 tx + 3 and 64 + (same)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + FK - 1) / FK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile(s, s);
    cp_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_wait<STAGES - 2>();   // this thread's copies of tile t have landed
    __syncthreads();         // everyone's; and tile t - 1's stage is free
    if (t + STAGES - 1 < nk)
      load_tile((t + STAGES - 1) % STAGES, t + STAGES - 1);
    cp_commit();             // (an empty group past the end keeps the count)
    const float* as = As + (t % STAGES) * A_STAGE;
    const float* bs = Bs + (t % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a0 = ld4(as + kk * FAS + 4 * ty);
      const float4 a1 = ld4(as + kk * FAS + 64 + 4 * ty);
      const float4 b0 = ld4(bs + kk * BN + 4 * tx);
      const float4 b1 = ld4(bs + kk * BN + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_wait<0>();

  const bool vc = (N % 4) == 0;   // C rows 16-byte aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long c = n0 + 64 * h + 4 * tx;
      float* out = C + r * N + c;
      if (vc && c < N) {
        *reinterpret_cast<float4*>(out) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
            acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) out[j] = acc[i][4 * h + j];
      }
    }
  }
}

template <bool VB>
int mm_f32_run(const float* a, const float* b, float* c, long long lda,
               long long ldb, int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaError_t e = cudaFuncSetAttribute(
      mm_f32_kernel<VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)F_SMEM);
  if (e != cudaSuccess) return (int)e;
  mm_f32_kernel<VB><<<grid, NT, F_SMEM, s>>>(a, b, c, lda, ldb, M, N, K);
  return (int)cudaGetLastError();
}

int mm_bf16_run(const void* a, const void* b, void* c, long long lda,
                long long ldb, int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_bf16_kernel<<<grid, NT, 0, s>>>(
      reinterpret_cast<const bf16*>(a), reinterpret_cast<const bf16*>(b),
      reinterpret_cast<bf16*>(c), lda, ldb, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  lda / ldb: row strides (elements) of A
// and B; C is written contiguous.  Returns cudaGetLastError() after the
// launch.
extern "C" int matmul_launch(int dtype, const void* a, const void* b,
                             void* c, long long lda, long long ldb, int M,
                             int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* fa = reinterpret_cast<const float*>(a);
    const float* fb = reinterpret_cast<const float*>(b);
    float* fc = reinterpret_cast<float*>(c);
    if (ldb % 4 == 0 && reinterpret_cast<unsigned long long>(b) % 16 == 0)
      return mm_f32_run<true>(fa, fb, fc, lda, ldb, M, N, K, s);
    return mm_f32_run<false>(fa, fb, fc, lda, ldb, M, N, K, s);
  }
  if (dtype == 1) return mm_bf16_run(a, b, c, lda, ldb, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}
