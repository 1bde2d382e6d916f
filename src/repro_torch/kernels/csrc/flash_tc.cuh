// The bf16 tile routine of the three attention kernels, on Hopper's tensor
// cores: warpgroup MMAs (wgmma.mma_async m64nNk16, bf16 in, f32
// accumulate) over K/V strips that TMA brings into a ring of shared-memory
// stages.  The f32 path keeps flash_common.cuh's CUDA-core Tile: on the
// tensor cores f32 would be TF32, another function.
//
// One CTA is one warpgroup (128 threads) and owns a tile of ROWS = 64
// folded query rows (r = g * C + i, as in flash_common.cuh) of one
// (batch, KV head).  Per strip of BK = 64 keys:
//
//   S = Q K^T             wgmma from shared memory, k-steps of 16 over D
//                         in ascending order; the bf16 products are exact
//                         in the f32 accumulator;
//   s = S * scale         in f32 after the product, as the TPU kernel does
//                         (flash_attention.py:64) -- Q is not pre-scaled in
//                         bf16, which would round it;
//   online softmax        per row: max over the visible keys, alpha =
//                         exp(m_old - m), e = exp(s - m), the row sum as a
//                         fixed sequence (each thread's 16 keys in order,
//                         then a butterfly over the row's 4 threads);
//   O = O * alpha + P V   P kept exact: P = P_hi + P_mid + P_lo, three
//                         bf16 terms (each the bf16 rounding of what the
//                         terms before it leave; 3 x 8 bits hold p's 24),
//                         three register-A wgmmas per 16-key k-step into
//                         the same accumulator.  P cast to bf16 alone (what
//                         SDPA does) errs ~2^-9 relative per term, and
//                         hi + lo alone ~2^-18, which a small output (few
//                         keys that cancel, a sliding window) carries past
//                         the limit's floor (1 bf16 ulp + 2^-20):
//                         tests/test_torch_tc_numerics.py measures 74-320x
//                         the limit for one term, up to 1.56x for two.
//
// Bit pin.  flash_decode's split CTA and flash_prefill_chunk's CTA run this
// same routine on the same strips (BK-aligned, SPLIT-aligned splits from
// key 0) and merge the splits with flash_common.cuh's merge_coeffs in the
// same order, so chunk row j equals decode at pos = prefix + j bit for bit.
// Decode pads its G query rows to the MMA's 64 with DEAD_QPOS rows; the
// rows of an MMA are independent, so a row's bits do not depend on its
// neighbours.  A strip that one kernel walks and the other skips is fully
// masked for the row: alpha = 1 and P = 0 add exact zeros.
//
// Layouts.  Q (loaded once per CTA with 16-byte loads, per-row addresses,
// so a tile may cross heads) and each K/V strip sit in shared memory as
// 64-element (128-byte) column boxes, 128-byte swizzled: D = 128 is two
// boxes a row, D < 64 one box zero-padded (Q by the loads, K/V by TMA's
// out-of-bounds fill), so head dims 8 and 16 pad to the MMA's k = 16 with
// zeros.  K is the QK^T product's B operand, K-major; V is the PV
// product's B operand with the key axis as its depth, MN-major (wgmma's
// transpose bit).  K/V are read in place from the arena's strides through
// a 4-D tensor map (D, position, head, batch) built on the host per launch.
//
// Donor table (prefix sharing; flash_common.cuh's Rows).  A strip below
// the donor length comes in by TMA from the donor row (the maps' batch
// coordinate), one at or above it from the own row.  The strip that
// straddles the length (share_len is a multiple of the page size, rarely
// of BK) is loaded by rows: thread 0 arrives on its stage barrier with no
// copy, and every thread issues 16-byte cp.async copies of its rows, each
// from the row ``Rows::at`` names, into the layout TMA would have made
// (bf16: the 128-byte swizzle; narrow: raw rows of ROW_BYTES), zeros
// where TMA fills zeros (past Sk, past D).  They are issued where the
// ring refills the stage, so they fly under the strips before it, and
// waited for and fenced for the async proxy when the ring reaches the
// strip (a first version loaded them synchronously there, which cost the
// CTAs that hold the strip a round trip to memory per load).  The scales follow their rows per key.  The
// products see the same shared memory either way, so the order of every
// sum stays, and over donor rows equal to the own rows the bits do.
//
// Narrow arenas (int8 / fp8 e4m3 with one f32 scale per row and KV head:
// the TPU kernels' fused-dequant branch).  TMA brings each strip in at its
// own byte width (a row of D bytes, no swizzle) into the ring; the scales
// come with it, one 4-byte cp.async a thread that arrives on the same
// stage barrier.  Each strip is then widened into the swizzled bf16 K and V
// boxes that the products read (an int8 or e4m3 value is exact in bf16),
// generic-proxy writes fenced for the async proxy as Q is.  The scales
// never enter the tensor cores: with ks / vs the strip's K / V scales,
//
//   s = (Q K^T) * ks * scale    per key column, before the row max;
//   P' = P * vs                 in f32 after the exp, before the
//                               three-term split, so P' V = P (vs V) with
//                               P' still exact;
//   l sums the unscaled P.
//
// The reference scales K and V first ((k ks) in f32, then the products),
// so the two differ by f32 rounding only; the chunk/decode bit pin holds
// per format, both kernels running this routine.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace fk {
namespace tc {

constexpr int ROWS = 64;        // query rows per CTA (one wgmma M)
constexpr int NST = 2;          // K/V stages in the ring
constexpr int BOX = 64;         // elements per swizzled column box (128 B)
constexpr int BOX_BYTES = 64 * 128;   // one 64-row box

// KT: the arena's type, bf16 or (scaled) int8 / fp8 e4m3.
template <int D, typename KT = __nv_bfloat16>
struct Cfg {
  static constexpr bool NARROW = scaled_v<KT>;
  static constexpr int NB = D <= 64 ? 1 : D / 64;    // boxes per row
  static constexpr int DV = NB * 64;                 // PV product's N
  static constexpr int KST = (D + 15) / 16;          // QK^T k-steps
  static constexpr int R = DV / 2;                   // O floats / thread
  static constexpr int Q_BYTES = NB * BOX_BYTES;
  // a narrow strip's row in the ring: D bytes, at least TMA's 16
  static constexpr int ROW_BYTES = D < 16 ? 16 : D;
  static constexpr int RAW_BYTES = BK * ROW_BYTES;   // one narrow K strip
  // the widened bf16 K and V boxes (narrow only; bf16 strips are read in
  // the ring)
  static constexpr int WIDE_BYTES = NARROW ? 2 * NB * BOX_BYTES : 0;
  static constexpr int STAGE_BYTES = NARROW ? 2 * RAW_BYTES
                                            : 2 * NB * BOX_BYTES;  // K + V
  static constexpr int SCALE_BYTES = NARROW ? 2 * BK * 4 : 0;  // per stage
  // 1 KB of slack to align the swizzled tiles to 1024 bytes
  static constexpr size_t smem = 1024 + Q_BYTES + WIDE_BYTES
                                 + NST * (STAGE_BYTES + SCALE_BYTES)
                                 + 8 * NST + 4 * ROWS + 16;
};

// -- PTX wrappers ---------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor, 128-byte swizzle: start address, leading and
// stride byte offsets (16-byte units), layout type 1 (SW128) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin a register's value to this point of the instruction stream, so the
// compiler moves no read of an accumulator above the wait and no write
// below the next wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait for the phase of ``parity`` to complete.  A copy that never lands
// traps after ~2^26 tries (seconds) instead of hanging the card: the
// launch then fails and the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0, tries = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (++tries > (1u << 26)) __trap();
  }
}
// One 4-byte cp.async into shared memory whose completion arrives on
// ``bar`` (counted in the barrier's arrival count: .noinc).
__device__ __forceinline__ void cp_async4_arrive(void* dst, const void* src,
                                                 uint64_t* bar) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// 16 narrow values as 16 bf16 (two 16-byte chunks), exactly.  int8 x
// without a conversion instruction: the byte x + 128 under the exponent of
// 2^23 is the float 2^23 + 128 + x, exact, and so is subtracting 2^23 +
// 128; every int8 value is exact in bf16.
__device__ __forceinline__ void widen16(const uint4& raw, uint4& lo,
                                        uint4& hi, int8_t) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
  uint32_t* o[2] = {reinterpret_cast<uint32_t*>(&lo),
                    reinterpret_cast<uint32_t*>(&hi)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;       // bytes x + 128
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u,
                                                   0x7440 + b)),
                       8388736.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * h], f[2 * h + 1]);
      o[i / 2][2 * (i % 2) + h] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
}
__device__ __forceinline__ void widen16(const uint4& raw, uint4& lo,
                                        uint4& hi, __nv_fp8_e4m3) {
  const __nv_fp8x2_storage_t* x =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
  uint32_t* o[2] = {reinterpret_cast<uint32_t*>(&lo),
                    reinterpret_cast<uint32_t*>(&hi)};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2(x[i], __NV_E4M3)));
    __nv_bfloat162 v = __floats2bfloat162_rn(f.x, f.y);
    o[i / 4][i % 4] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// One 64 x 64 box of a 4-D tensor map into shared memory; coordinates
// (column, position, head, batch), innermost first.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[64 x 64] (+)= Q[64 x 16] * K[64 x 16]^T, both from shared memory,
// K-major (128-byte swizzle).  ``acc`` = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
}

// O[64 x 64] += P[64 x 16] (registers) * V[16 x 64] (shared memory,
// MN-major: the key axis is the depth, V's rows are 128-byte swizzled).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 128] += P[64 x 16] (registers) * V[16 x 128] (shared memory,
// MN-major: the key axis is the depth, V's rows are 128-byte swizzled).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// -- the tile ---------------------------------------------------------------
// KT: the arena's type (bf16; int8 / fp8 e4m3 with scales).
template <int D, typename KT = __nv_bfloat16>
struct TcTile {
  using CF = Cfg<D, KT>;
  static constexpr bool NARROW = CF::NARROW;
  static constexpr int R = CF::R;
  static_assert(!NARROW || NT == 2 * BK, "one scale a thread per strip");
  char* q_s;            // Q: NB boxes of 64 rows x 128 B
  char* wide_s;         // narrow: the widened K boxes, then the V boxes
  char* kv_s;           // NST stages: NB K boxes, then NB V boxes (bf16);
                        // narrow: the raw K strip, then the raw V strip
  float* sc_s;          // narrow: NST stages of BK K scales, BK V scales
  uint64_t* bar;        // one full barrier per stage
  int* qp;              // absolute query position of each row
  int* lim;             // first and last live strip (CTA-uniform)
  float o[R];           // split-local output accumulator (wgmma layout)
  float m[2], l[2];     // split-local max / sum of this thread's two rows
  int qpos[2];
  int tid, lane, row0;  // this thread's rows: row0 and row0 + 8
  Rows rw;              // the arena rows the tile's query batch reads

  __device__ __forceinline__ void init(char* smem) {
    char* base = reinterpret_cast<char*>(
        (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
    q_s = base;
    wide_s = q_s + CF::Q_BYTES;
    kv_s = wide_s + CF::WIDE_BYTES;
    sc_s = reinterpret_cast<float*>(kv_s + NST * CF::STAGE_BYTES);
    bar = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(sc_s)
                                      + NST * CF::SCALE_BYTES);
    qp = reinterpret_cast<int*>(bar + NST);
    lim = qp + ROWS;
    tid = threadIdx.x;
    lane = tid % 32;
    row0 = (tid / 32) * 16 + lane / 4;
    if (tid == 0) {
      // narrow: thread 0's expect_tx and every thread's scale copy arrive
      for (int s = 0; s < NST; ++s) mbar_init(&bar[s], NARROW ? 1 + NT : 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if constexpr (NARROW) {
      // the V boxes' columns past the strip's rows (D < 64) stay zero
      for (int e = tid; e < CF::WIDE_BYTES / 16; e += NT)
        reinterpret_cast<uint4*>(wide_s)[e] = make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int x = 0; x < R; ++x) o[x] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
    }
  }

  // Load query rows [r0, r0 + ROWS) of (b, kvh) unscaled into the swizzled
  // boxes (zeros past D and for rows past G * C), their positions, and the
  // tile's live strip range [lim[0], lim[1]].
  __device__ __forceinline__ void load_q(const Problem& p, int b, int kvh,
                                         int r0) {
    const __nv_bfloat16* q = reinterpret_cast<const __nv_bfloat16*>(p.q);
    const int nrows = p.G * p.C;
    constexpr int CH = CF::NB * 8;            // 16-byte chunks per row
    for (int e = tid; e < ROWS * CH; e += NT) {
      const int r = e / CH, c = e % CH, R = r0 + r;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (R < nrows && c * 8 < D) {
        const int g = R / p.C, i = R % p.C;
        x = *reinterpret_cast<const uint4*>(
            q + b * p.sqb + i * p.sqs + (long long)(kvh * p.G + g) * p.sqh
            + c * 8);
      }
      *reinterpret_cast<uint4*>(q_s + (c / 8) * BOX_BYTES + r * 128
                                + ((c % 8) ^ (r % 8)) * 16) = x;
    }
    rw = rows_of(p, b);
    const int base = (p.qbase ? p.qbase[b] : p.qbase0) + p.qbase_add;
    for (int r = tid; r < ROWS; r += NT) {
      const int R = r0 + r;
      qp[r] = R < nrows ? base + R % p.C : DEAD_QPOS;
    }
    // Q (and a narrow tile's zeroed boxes) was written through the generic
    // proxy; wgmma reads it through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      int lo = 0x7fffffff, hi = DEAD_QPOS;
      for (int r = 0; r < ROWS && r0 + r < nrows; ++r) {
        lo = min(lo, qp[r]);
        hi = max(hi, qp[r]);
      }
      int kmin = 0, kmax = p.Sk - 1;
      if (p.causal) kmax = min(kmax, hi);
      if (p.window > 0) kmin = max(0, lo - p.window + 1);
      const bool any = r0 < nrows && kmax >= kmin;
      lim[0] = any ? kmin / BK : 0;
      lim[1] = any ? kmax / BK : -1;
    }
    __syncthreads();
    qpos[0] = qp[row0];
    qpos[1] = qp[row0 + 8];
  }

  // Thread 0: strip n's K and V boxes (narrow: its raw K and V rows)
  // into stage st, from the donor row or the own row (bmul 0: a broadcast
  // batch, coordinate 0); a strip that straddles the donor length only
  // arrives (every thread copies its rows: issue_rows).
  __device__ __forceinline__ void load_strip(const CUtensorMap* mk,
                                             const CUtensorMap* mv, int n,
                                             int st, int kvh, int bmul) {
    if (rw.straddles(n * BK)) {
      mbar_arrive(&bar[st]);
      return;
    }
    const int bb = rw.at(n * BK) * bmul;
    char* ks = kv_s + st * CF::STAGE_BYTES;
    mbar_expect_tx(&bar[st], CF::STAGE_BYTES);
    if constexpr (NARROW) {
      tma_load(ks, mk, &bar[st], 0, n * BK, kvh, bb);
      tma_load(ks + CF::RAW_BYTES, mv, &bar[st], 0, n * BK, kvh, bb);
    } else {
      char* vs = ks + CF::NB * BOX_BYTES;
#pragma unroll
      for (int j = 0; j < CF::NB; ++j) {
        tma_load(ks + j * BOX_BYTES, mk, &bar[st], j * BOX, n * BK, kvh, bb);
        tma_load(vs + j * BOX_BYTES, mv, &bar[st], j * BOX, n * BK, kvh, bb);
      }
    }
  }

  // Every thread (narrow only): one scale of strip n into stage st --
  // threads 0..BK-1 K's, BK..2BK-1 V's -- arriving on the stage's barrier.
  // A key past Sk reads row Sk - 1's scale (its key is masked).
  __device__ __forceinline__ void load_scales(const Problem& p, int n,
                                              int st, int kvh) {
    const int j = tid % BK;
    const int kpos = min(n * BK + j, p.Sk - 1);
    const float* src = (tid < BK ? p.ks : p.vs) + rw.at(kpos) * p.ssb
                       + (long long)kpos * p.sss + (long long)kvh * p.ssh;
    cp_async4_arrive(sc_s + st * 2 * BK + tid, src, &bar[st]);
  }

  // Every thread: issue strip n's rows (a strip that straddles the donor
  // length) into stage st as 16-byte cp.async copies, each row from the
  // arena row rw names for it, in the layout load_strip's TMA boxes have
  // (a copy of 0 bytes fills zeros past Sk and past D; 8 bytes and zeros
  // for a narrow row of D = 8).  Issued where the ring refills the stage,
  // so the copies fly under the strips before it; rows_landed waits.
  __device__ __forceinline__ void issue_rows(const Problem& p, int n, int st,
                                             int kvh) {
    char* stage = kv_s + st * CF::STAGE_BYTES;
    const char* base[2] = {reinterpret_cast<const char*>(p.k),
                           reinterpret_cast<const char*>(p.v)};
    const long long sb[2] = {p.skb, p.svb}, ss[2] = {p.sks, p.svs},
                    sh[2] = {p.skh, p.svh};
    constexpr long long ES = sizeof(KT);
    // 16-byte chunks a row: narrow max(D, 16) bytes; bf16 64 columns a box
    constexpr int CH = NARROW ? CF::ROW_BYTES / 16 : CF::NB * 8;
    for (int e = tid; e < 2 * BK * CH; e += NT) {
      const int which = e / (BK * CH), j = (e / CH) % BK, c = e % CH;
      const int kpos = n * BK + j;
      const bool in = kpos < p.Sk && (NARROW || c * 8 < D);
      const char* src = base[which];
      if (in)
        src += ES * (rw.at(kpos) * sb[which] + kpos * ss[which]
                     + kvh * sh[which]) + 16 * c;
      const int bytes = in ? (NARROW && D < 16 ? 8 : 16) : 0;
      char* dst;
      if constexpr (NARROW)
        dst = stage + which * CF::RAW_BYTES + j * CF::ROW_BYTES + c * 16;
      else
        dst = stage + which * CF::NB * BOX_BYTES + (c / 8) * BOX_BYTES
              + j * 128 + ((c % 8) ^ (j % 8)) * 16;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
    }
  }

  // Every thread: wait for its row copies (issue_rows), then fence them
  // for the async proxy (the products, and TMA's next write to the stage)
  // and the CTA.
  __device__ __forceinline__ void rows_landed() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  // Every thread (narrow only): stage st's raw K and V strips widened into
  // the swizzled bf16 boxes the products read, then fenced for them.
  __device__ __forceinline__ void widen(int st) {
    constexpr int CPR = CF::ROW_BYTES / 16;    // 16-byte chunks a row
    const char* raw = kv_s + st * CF::STAGE_BYTES;
    for (int e = tid; e < 2 * BK * CPR; e += NT) {
      const int which = e / (BK * CPR), j = (e / CPR) % BK, u = e % CPR;
      const uint4 x = *reinterpret_cast<const uint4*>(
          raw + which * CF::RAW_BYTES + j * CF::ROW_BYTES + u * 16);
      uint4 lo, hi;
      widen16(x, lo, hi, KT{});
      // columns [16u, 16u + 16): chunks c8, c8 + 1 of box 16u / 64
      char* box = wide_s + which * CF::NB * BOX_BYTES
                  + (u / 4) * BOX_BYTES + j * 128;
      const int c8 = 2 * (u % 4);
      *reinterpret_cast<uint4*>(box + ((c8 ^ (j % 8)) * 16)) = lo;
      *reinterpret_cast<uint4*>(box + (((c8 + 1) ^ (j % 8)) * 16)) = hi;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  // One strip of keys [j0, j0 + BK) in stage st: scores, online-softmax
  // update of this thread's two rows, O = O * alpha + (hi + mid + lo) V
  // (narrow: scores times the K scales, P times the V scales).
  __device__ __forceinline__ void strip(const Problem& p, int j0,
                                        int st) {
    const char* ks = NARROW ? wide_s : kv_s + st * CF::STAGE_BYTES;
    const char* vs = ks + CF::NB * BOX_BYTES;
    const float* sk = sc_s + st * 2 * BK;
    const float* sv = sk + BK;
    float s[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < CF::KST; ++kk) {
      const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss64(s, desc_sw128(q_s + off, 16, 1024),
                 desc_sw128(ks + off, 16, 1024), kk > 0);
    }
    wg_commit_wait();
    fence_regs(s);
    // column of s[4c + 2i + j]: 8c + 2 (lane % 4) + j; row: row0 + 8i
    const int cq = 2 * (lane % 4);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int x = 4 * c + 2 * i + j, col = 8 * c + cq + j;
          float sc = s[x];
          if constexpr (NARROW) sc = __fmul_rn(sc, sk[col]);
          s[x] = visible(p, qpos[i], j0 + col) ? __fmul_rn(sc, p.scale)
                                               : -INFINITY;
          mx = fmaxf(mx, s[x]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int x = 4 * c + 2 * i + j;
          s[x] = expf(s[x] - mx);          // exp(-inf) = 0: masked keys
          sum = __fadd_rn(sum, s[x]);
          if constexpr (NARROW) s[x] = __fmul_rn(s[x], sv[8 * c + cq + j]);
        }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
      l[i] = __fmaf_rn(l[i], alpha[i], sum);
      m[i] = mx;
    }
#pragma unroll
    for (int c = 0; c < R / 4; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          o[4 * c + 2 * i + j] = __fmul_rn(o[4 * c + 2 * i + j], alpha[i]);
    // P = P_hi + P_mid + P_lo as register A fragments, three bf16 terms
    // that hold p's 24 bits exactly (each remainder is exact in f32);
    // k-step kk covers keys [16 kk, 16 kk + 16): s[8 kk .. 8 kk + 8)
    uint32_t af[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float r0 = s[8 * kk + 2 * x], r1 = s[8 * kk + 2 * x + 1];
#pragma unroll
        for (int tm = 0; tm < 3; ++tm) {
          const float h0 = __bfloat162float(__float2bfloat16_rn(r0));
          const float h1 = __bfloat162float(__float2bfloat16_rn(r1));
          af[tm][kk][x] = pack_bf16(h0, h1);
          r0 = __fsub_rn(r0, h0);
          r1 = __fsub_rn(r1, h1);
        }
      }
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_sw128(vs + kk * 16 * 128, BOX_BYTES, 1024);
#pragma unroll
      for (int tm = 0; tm < 3; ++tm) wgmma_rs(o, af[tm][kk], dv);
    }
    wg_commit_wait();
    fence_regs(o);
    // the fragments stay live (unmodified) until the products have read them
#pragma unroll
    for (int tm = 0; tm < 3; ++tm)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          asm volatile("" : "+r"(af[tm][kk][x])::"memory");
  }

  // Every strip n in [n0, n1] through the ring; after(n) once strip n is
  // folded in (every thread is past the stage by then).  ``bmul``: the
  // maps' batch multiplier (make_maps).
  template <typename After>
  __device__ __forceinline__ void run(const Problem& p, const CUtensorMap* mk,
                      const CUtensorMap* mv, int kvh, int bmul, int n0,
                      int n1, After after) {
    if (tid == 0)
      for (int i = 0; i < NST && n0 + i <= n1; ++i)
        load_strip(mk, mv, n0 + i, i, kvh, bmul);
    for (int i = 0; i < NST && n0 + i <= n1; ++i)
      if (rw.straddles((n0 + i) * BK)) issue_rows(p, n0 + i, i, kvh);
    if constexpr (NARROW)
      for (int i = 0; i < NST && n0 + i <= n1; ++i)
        load_scales(p, n0 + i, i, kvh);
    for (int n = n0; n <= n1; ++n) {
      const int u = n - n0, st = u % NST;
      mbar_wait(&bar[st], (u / NST) & 1);
      if (rw.straddles(n * BK)) rows_landed();
      if constexpr (NARROW) widen(st);
      strip(p, n * BK, st);
      __syncthreads();
      if (n + NST <= n1) {
        if (tid == 0) {
          // the stage was last read through the generic proxy (widen)
          if constexpr (NARROW)
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          load_strip(mk, mv, n + NST, st, kvh, bmul);
        }
        if (rw.straddles((n + NST) * BK))
          issue_rows(p, n + NST, st, kvh);
        if constexpr (NARROW) load_scales(p, n + NST, st, kvh);
      }
      after(n);
    }
  }

  // Fold the split-local (m, l, o) into the running (GM, GL, A) with
  // flash_decode's combine formula and reset the split-local state.
  __device__ __forceinline__ void merge_into(float (&A)[R], float (&GM)[2],
                                             float (&GL)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float M2, a, bb;
      merge_coeffs(GM[i], m[i], &M2, &a, &bb);
#pragma unroll
      for (int c = 0; c < R / 4; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int x = 4 * c + 2 * i + j;
          A[x] = merge_val(A[x], a, o[x], bb);
          o[x] = 0.f;
        }
      GL[i] = merge_val(GL[i], a, l[i], bb);
      GM[i] = M2;
      m[i] = NEG_INF;
      l[i] = 0.f;
    }
  }

  // Rows [r0, r0 + ROWS) of the output: vals / L, rounded to bf16 once.
  __device__ __forceinline__ void store(const Problem& p, int b, int kvh,
                                        int r0, const float (&vals)[R],
                                        const float (&L)[2]) const {
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(p.o);
    const int nrows = p.G * p.C, cq = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int R0 = r0 + row0 + 8 * i;
      if (R0 >= nrows) continue;
      const int g = R0 / p.C, ii = R0 % p.C;
      __nv_bfloat16* row = out + b * p.sob + ii * p.sos
                           + (long long)(kvh * p.G + g) * p.soh;
#pragma unroll
      for (int c = 0; c < R / 4; ++c) {
        const int col = 8 * c + cq;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(finish_val(vals[4 * c + 2 * i], L[i]),
                                    finish_val(vals[4 * c + 2 * i + 1],
                                               L[i]));
      }
    }
  }
  // This thread's two rows of Problem::lse from the unmerged (m, l); the
  // four threads of a row hold the same values, the first writes them.
  __device__ __forceinline__ void store_lse(const Problem& p, int bkv,
                                            int r0) const {
    if (lane % 4) return;
    const int nrows = p.G * p.C;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int R0 = r0 + row0 + 8 * i;
      if (R0 < nrows) p.lse[(long long)bkv * nrows + R0] = row_lse(m[i], l[i]);
    }
  }
};

// -- host side ---------------------------------------------------------------
using EncodeFn = PFN_cuTensorMapEncodeTiled_v12000;

inline EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(ptr);
  }
  return fn;
}

// A 4-D map (D, position, head, batch) over a (B, S, KVH, D) operand read
// in place through its element strides, zeros past every edge.  bf16
// (``esize`` 2): 64 x 64 boxes, 128-byte swizzle.  A narrow arena
// (``esize`` 1): boxes of 64 rows of max(D, 16) bytes, no swizzle (the
// strip is widened before the products read it).  A broadcast batch
// (stride 0, as from expand) becomes an extent-1 axis read at coordinate
// 0 (*bmul = 0).
inline int make_kv_map(CUtensorMap* map, const void* ptr, int D, int S,
                       int KVH, int B, long long ss, long long sh,
                       long long sb, int* bmul, int esize = 2) {
  EncodeFn enc = encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  *bmul = sb != 0;
  const long long outer = ss * S > sh * KVH ? ss * S : sh * KVH;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)KVH,
                        (cuuint64_t)(sb ? B : 1)};
  cuuint64_t strides[3] = {(cuuint64_t)ss * esize, (cuuint64_t)sh * esize,
                           (cuuint64_t)(sb ? sb : outer) * esize};
  const bool narrow = esize == 1;
  cuuint32_t box[4] = {narrow ? (cuuint32_t)(D < 16 ? 16 : D)
                              : (cuuint32_t)BOX, BK, 1, 1};
  cuuint32_t es[4] = {1, 1, 1, 1};
  CUresult r = enc(map, narrow ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, es,
                   CU_TENSOR_MAP_INTERLEAVE_NONE,
                   narrow ? CU_TENSOR_MAP_SWIZZLE_NONE
                          : CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Both maps of a problem (``esize``: the arena's bytes an element);
// returns 0 or a CUDA error code.
inline int make_maps(const Problem& p, int B, CUtensorMap* mk,
                     CUtensorMap* mv, int* bmul, int D, int esize = 2) {
  int bk = 0, bv = 0;
  int e = make_kv_map(mk, p.k, D, p.Sk, p.KVH, B, p.sks, p.skh, p.skb, &bk,
                      esize);
  if (e) return e;
  e = make_kv_map(mv, p.v, D, p.Sk, p.KVH, B, p.svs, p.svh, p.svb, &bv,
                  esize);
  if (e) return e;
  if (bk != bv) return (int)cudaErrorInvalidValue;
  *bmul = bk;
  return 0;
}

// Grid order of the prefill kernels: linear block L -> (b * KVH + kvh,
// first row).  The heaviest tiles (latest query positions, most causal
// strips) go first; when C is a multiple of ROWS a tile holds one head's
// rows and tiles are ordered by query block, else by reversed tile index.
__device__ __forceinline__ void tile_of(const Problem& p, int L, int* bkv,
                                        int* r0) {
  const int tiles = (p.G * p.C + ROWS - 1) / ROWS;
  const int bkvs = gridDim.x / tiles, t = L / bkvs;
  *bkv = L % bkvs;
  if (p.C % ROWS == 0) {
    const int nb = p.C / ROWS;
    *r0 = ((t % p.G) * nb + nb - 1 - t / p.G) * ROWS;
  } else {
    *r0 = (tiles - 1 - t) * ROWS;
  }
}

}  // namespace tc
}  // namespace fk
