// dotp: float32 dot product of two vectors (the chained vfmul -> vfredsum
// of the paper's Table II).
//
// Replaces the TPU kernel src/repro/kernels/dotp.py:56 (dotp /
// _dotp_kernel, pallas_call at :65).
//
// What it computes: sum_i a_i * b_i over n elements, a and b both float32
// or both bfloat16 (widened to float32), as a float32 scalar.
//
// Design.  The TPU grid is one sequential axis that adds each strip into a
// single (8, 128) accumulator, which on Hopper would be one block reading
// at a fraction of HBM's rate.  Here n is split into G contiguous ranges
// of L elements (L a multiple of 2048, G <= 1024; both depend on n alone,
// see dotp.py split()).  Pass 1: block g reduces its range into
// partial[g]; pass 2: one block folds the G partials.  There are no float
// atomics, and the order below is fixed, so the same input gives the same
// bits on every run.
//
// The order.  In pass 1, thread t of block g takes the groups of V
// consecutive elements (V = 16 bytes / element size: 4 f32, 8 bf16)
// starting at g L + V (t + 256 j), j = 0, 1, ..., and folds them into one
// float32 accumulator, element by element in index order, with fmaf (the
// product is not rounded apart from the sum).  The 256 accumulators are
// then summed by a butterfly over each warp's 32 lanes (__shfl_xor_sync,
// 5 levels) and over the 8 warp sums (3 levels).  Pass 2: thread t adds
// partial[t], partial[t + 256], ... in order, then the same butterfly.
// Every term therefore passes through at most
//   d = L / 256 + 8 + ceil(G / 256) + 8
// roundings, so |kernel - exact| <= d 2^-24 sum |a_i b_i| (to first
// order).  A ragged tail is masked in the kernel; the reference pads to a
// multiple of 1024 instead.  The partial order of the reference's (8, 128)
// slot layout is not reproduced.
//
// What bounds it on the H100: bytes.  n = 2^26 reads 537 MB in f32 (268 MB
// in bf16): 0.160 ms (0.080 ms) at 3.35 TB/s; its 134 MFLOP take
// microseconds.  Each thread keeps one 16-byte load per operand in flight,
// and 1024 blocks of 256 threads fill every SM's 2048 thread slots.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads per block (both passes)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// butterfly over the block: every lane of warp 0 ends with the same sum
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float ws[NT / 32];
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < NT / 32 ? ws[lane] : 0.f;
#pragma unroll
    for (int o = 4; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NT) dotp_partial_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    float* __restrict__ part, long long n, long long L, int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long start = (long long)blockIdx.x * L;
  const long long end = start + L < n ? start + L : n;
  float acc = 0.f;
  for (long long e = start + (long long)threadIdx.x * V; e < end;
       e += (long long)NT * V) {
    if (vec && e + V <= end) {
      const uint4 va = *reinterpret_cast<const uint4*>(a + e);
      const uint4 vb = *reinterpret_cast<const uint4*>(b + e);
      const T* pa = reinterpret_cast<const T*>(&va);
      const T* pb = reinterpret_cast<const T*>(&vb);
#pragma unroll
      for (int j = 0; j < V; ++j) acc = fmaf(to_f(pa[j]), to_f(pb[j]), acc);
    } else {
      for (int j = 0; j < V && e + j < end; ++j)
        acc = fmaf(to_f(a[e + j]), to_f(b[e + j]), acc);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(NT) dotp_fold_kernel(
    const float* __restrict__ part, float* __restrict__ out, int G) {
  float acc = 0.f;
  for (int g = threadIdx.x; g < G; g += NT) acc += part[g];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

template <typename T>
int dotp_run(const void* a, const void* b, float* part, float* out,
             long long n, long long L, int G, int vec, cudaStream_t s) {
  if (G > 0)
    dotp_partial_kernel<T><<<G, NT, 0, s>>>(
        reinterpret_cast<const T*>(a), reinterpret_cast<const T*>(b), part,
        n, L, vec);
  dotp_fold_kernel<<<1, NT, 0, s>>>(part, out, G);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  a, b: n contiguous elements; part: G
// floats of scratch; out: one float.  L, G: the split (dotp.py split());
// vec: 1 if both bases are 16-byte aligned.  Returns cudaGetLastError()
// after the two launches.
extern "C" int dotp_launch(int dtype, const void* a, const void* b,
                           float* part, float* out, long long n, long long L,
                           int G, int vec, void* stream) {
  if (n < 0 || L < 1 || G < 0 || (long long)G * L < n ||
      L % (NT * 8) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return dotp_run<float>(a, b, part, out, n, L, G, vec, s);
  if (dtype == 1)
    return dotp_run<__nv_bfloat16>(a, b, part, out, n, L, G, vec, s);
  return (int)cudaErrorInvalidValue;
}
