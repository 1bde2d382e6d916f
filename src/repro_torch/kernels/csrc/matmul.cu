// matmul: C = A @ B with a float32 accumulator, C in A's dtype (fmatmul,
// the paper's Fig. 2 kernel).
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:51 (matmul /
// _matmul_kernel, pallas_call at :62).
//
// What it computes: A (M, K) and B (K, N), both float32 or both bfloat16,
// row-major with a unit last stride; C (M, N) contiguous.  Every element of
// C accumulates k = 0 .. K-1 in ascending order from 0 in float32 and is
// rounded to C's dtype once, at the end; no split-K, so the bits repeat
// from call to call.  float32 inputs are multiplied in float32 on the CUDA
// cores (no TF32, no split into TF32 terms); bfloat16 products are exact in
// the float32 accumulator.
//
// What bounds it on the H100: a 4096^3 product is 137.4 GFLOP against
// 201 MB (f32) of operands and result, so operations bound it: 2.05 ms at
// the 67 TFLOP/s float32 CUDA-core peak, 0.139 ms for bf16 at the 989
// TFLOP/s tensor-core peak.
//
// bfloat16 design (mm_bf16_kernel), on the tensor cores.  Each CTA owns a
// 128 x 256 tile of C and walks K in 64-deep tiles through a ring of four
// shared-memory stages (48 KB each):
//   * one producer thread (warpgroup 2, its registers given up with
//     setmaxnreg) issues the TMA loads of each stage -- A as one 64 x 128
//     box, B as four 64 x 64 boxes, 128-byte swizzled -- against a full
//     mbarrier, once both consumers have released the stage (empty);
//   * two consumer warpgroups (0 and 1) each own 64 rows of the tile and
//     run wgmma.mma_async m64n256k16 from shared memory, four k-steps a
//     tile, 128 f32 accumulators a thread; one wgmma group stays in flight
//     while the stage before it is released;
//   * A is K-major; B is read as stored, (K, N) row-major, which is
//     MN-major for wgmma: the transpose bit, no transposing copy;
//   * ragged M, N and K need no masking in the main loop: TMA fills the
//     parts of a box past an edge with zeros, which add exact zeros; the
//     epilogue skips stores past M and N.  The TMA maps need 16-byte
//     aligned bases and row strides; matmul.launch copies an operand that
//     is not into a zero-padded buffer first (its padding step).
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
//   Ragged M, N and K are masked inside the kernel: loads past an edge read
//   0 and stores past an edge are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tc.cuh"   // the wgmma / mbarrier / TMA wrappers (fk::tc)

namespace {

constexpr int BM = 128;      // rows of C per f32 block
constexpr int BN = 128;      // columns of C per f32 block
constexpr int NT = 256;      // threads per f32 block, 16 x 16

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

using bf16 = __nv_bfloat16;
namespace tc = fk::tc;

// -- bfloat16: wgmma + TMA -------------------------------------------------
constexpr int GM = 128;                   // rows of C per CTA
constexpr int GN = 256;                   // columns of C per CTA
constexpr int GK = 64;                    // K tile: one 128-byte row of bf16
constexpr int GSTAGES = 4;                // shared-memory ring
constexpr int GA_BYTES = GM * GK * 2;     // A: one 64 x 128 box, 16 KB
constexpr int GB_BOX = GK * 64 * 2;       // B: 64 K rows x 64 columns, 8 KB
constexpr int GSTAGE = GA_BYTES + GN / 64 * GB_BOX;   // 48 KB
constexpr int GT = 384;                   // 2 consumer + 1 producer warpgroup
// 1 KB of slack to align the swizzled stages to 1024 bytes, then the
// full and empty barriers
constexpr size_t G_SMEM = 1024 + (size_t)GSTAGES * GSTAGE + 2 * GSTAGES * 8;

// One box of a 2-D tensor map into shared memory; coordinates innermost
// first.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(tc::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(tc::smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(tc::smem_u32(bar)) : "memory");
}

// C[64 x 256] += A[64 x 16] (K-major) * B[16 x 256] (MN-major: transpose
// bit set), both from shared memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, "
        "%128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(GT, 1) mm_bf16_kernel(
    const __grid_constant__ CUtensorMap ma,
    const __grid_constant__ CUtensorMap mb, bf16* __restrict__ C, int M,
    int N, int K) {
  extern __shared__ __align__(1024) char g_smem[];
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(g_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + GSTAGES * GSTAGE);
  uint64_t* empty = full + GSTAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int nk = (K + GK - 1) / GK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 2);     // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: tile kt goes into stage kt % GSTAGES once tile
    // kt - GSTAGES has been released there
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % GSTAGES;
        if (kt >= GSTAGES) tc::mbar_wait(&empty[s], (kt / GSTAGES - 1) & 1);
        char* st = base + s * GSTAGE;
        tc::mbar_expect_tx(&full[s], GSTAGE);
        tma_load_2d(st, &ma, &full[s], kt * GK, m0);
#pragma unroll
        for (int j = 0; j < GN / 64; ++j)
          tma_load_2d(st + GA_BYTES + j * GB_BOX, &mb, &full[s],
                      n0 + 64 * j, kt * GK);
      }
    }
  } else {
    // consumer wg: rows m0 + 64 wg .. + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[128];
#pragma unroll
    for (int x = 0; x < 128; ++x) acc[x] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % GSTAGES;
      tc::mbar_wait(&full[s], (kt / GSTAGES) & 1);
      const char* a_s = base + s * GSTAGE + wg * (64 * 128);
      const char* b_s = base + s * GSTAGE + GA_BYTES;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < GK / 16; ++kk)
        wgmma_256(acc, tc::desc_sw128(a_s + kk * 32, 16, 1024),
                  tc::desc_sw128(b_s + kk * 16 * 128, GB_BOX, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // tile kt - 1's products have read their stage: release it
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && tid == 0) mbar_arrive(&empty[(kt - 1) % GSTAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    tc::fence_regs(acc);

    // acc[4 c + 2 i + j] is row 16 warp + lane / 4 + 8 i, column
    // 8 c + 2 (lane % 4) + j of this warpgroup's 64 x 256 part
    const int lane = tid % 32;
    const int r0 = m0 + wg * 64 + (tid / 32) * 16 + lane / 4;
    const int c0 = n0 + 2 * (lane % 4);
    const bool pairs = N % 2 == 0;     // bf16x2 stores 4-byte aligned
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= M) continue;
      bf16* row = C + (long long)r * N;
#pragma unroll
      for (int c = 0; c < GN / 8; ++c) {
        const int col = c0 + 8 * c;
        const float v0 = acc[4 * c + 2 * i], v1 = acc[4 * c + 2 * i + 1];
        if (pairs && col < N) {
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < N) row[col] = __float2bfloat16(v0);
          if (col + 1 < N) row[col + 1] = __float2bfloat16(v1);
        }
      }
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

// A 2-D map over a bf16 (rows, cols) row-major operand with row stride
// ld (elements): boxes of 64 columns x box_rows rows, 128-byte swizzle,
// zeros past every edge.
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
             long long ld, int box_rows) {
  tc::EncodeFn enc = tc::encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  cuuint32_t es[2] = {1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   const_cast<void*>(ptr), dims, strides, box, es,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The TMA maps need K >= 1, 16-byte aligned bases and row strides of a
// multiple of 8 elements (matmul.launch's padding step sees to it).
int mm_bf16_run(const void* a, const void* b, void* c, long long lda,
                long long ldb, int M, int N, int K, cudaStream_t s) {
  if (K < 1 || lda % 8 || ldb % 8
      || reinterpret_cast<uintptr_t>(a) % 16
      || reinterpret_cast<uintptr_t>(b) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int e = make_map(&ma, a, M, K, lda, GM);
  if (e) return e;
  e = make_map(&mb, b, K, N, ldb, GK);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      mm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G_SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM);
  mm_bf16_kernel<<<grid, GT, G_SMEM, s>>>(ma, mb, reinterpret_cast<bf16*>(c),
                                          M, N, K);
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
