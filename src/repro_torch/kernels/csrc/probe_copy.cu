// The codec calibration's copy probe for Hopper (sm_90a): out = x over a
// (rows, 256) float32 grid, one read and one write per element.
//
// Replaces the TPU kernel `probe_copy_2d` (`_copy_kernel`) of
// benchmarks/kernel_bench.py.
//
// Bound: device memory, 8 bytes per element and no arithmetic.
//
// Design: the calibration divides each codec stage's time by this probe's,
// so the probe has the codec kernels' launch shape (csrc/quantize.cu): 8
// warps a block, one warp per 256-element row, ceil(rows / 8) blocks.  It
// is deliberately not cudaMemcpyAsync, whose copy engine or copy kernel is
// another kind of kernel than the ones it normalises.  Inside that shape a
// lane moves 16-byte words `lane` and `32 + lane` of its row, so each
// warp-wide load and store covers 512 contiguous bytes in whole sectors;
// both loads are issued before either store.  Loads and stores carry an L2
// evict-first policy (`createpolicy`): no element is touched twice, and the
// 4.5 GB of a large bucket would only churn the 50 MB L2.  The words are
// moved as integers, so every bit pattern (NaN payloads, -0.0) comes out as
// it went in.
//
// `benchmarks/torch_kernel_turns.py --probe --variants` times the designs
// tried (benchmarks/torch_probe_variants.cu) in turns at the largest bucket
// (2,211,840 rows) on an H100: a lane's 8 neighbouring floats, words 2*lane
// and 2*lane + 1, touch half of every sector an instruction and read
// 1.519 ms; coalesced 1.490; with the evict-first policy 1.489, beside
// x.clone()'s 1.487; `ld.global.cs` loads (`__ldcs`) cost 0.019 ms more in
// every design that used them.
//
// Beside it, the launch floor: an empty kernel of one block of one thread,
// the least time a launch takes on the card, against which a kernel of
// little work (a decode step) is read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;            // elements per row, as the quantize kernels
constexpr int WARPS_PER_CTA = 8;
constexpr int THREADS = WARPS_PER_CTA * 32;
constexpr int WORDS = BLOCK / 4;      // 16-byte words a row

__device__ __forceinline__ int4 load_evict_first(const int4* p, uint64_t policy) {
  int4 v;
  asm volatile("ld.global.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void store_evict_first(int4* p, int4 v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.s32 [%0], {%1, %2, %3, %4}, %5;"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy) : "memory");
}

__global__ void __launch_bounds__(THREADS)
probe_copy_kernel(const int4* __restrict__ x, int4* __restrict__ out, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (row >= rows) return;
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  const int4* src = x + row * WORDS;
  int4* dst = out + row * WORDS;
  const int4 a = load_evict_first(src + lane, policy), b = load_evict_first(src + 32 + lane, policy);
  store_evict_first(dst + lane, a, policy);
  store_evict_first(dst + 32 + lane, b, policy);
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int repro_probe_copy(const void* x, void* out, long long rows, void* stream) {
  if (rows <= 0) return 0;
  const unsigned int grid = static_cast<unsigned int>((rows + WARPS_PER_CTA - 1) / WARPS_PER_CTA);
  probe_copy_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
