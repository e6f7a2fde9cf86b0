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
// warps a block, one warp per 256-element row, a lane moving 8 neighbouring
// floats as two 16-byte loads and two 16-byte stores.  It is deliberately
// not cudaMemcpyAsync, whose copy engine or copy kernel is another kind of
// kernel than the ones it normalises.
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

__global__ void __launch_bounds__(THREADS)
probe_copy_kernel(const float* __restrict__ x, float* __restrict__ out, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float4* src = reinterpret_cast<const float4*>(x + row * BLOCK + lane * 8);
  float4* dst = reinterpret_cast<float4*>(out + row * BLOCK + lane * 8);
  const float4 a = src[0], b = src[1];
  dst[0] = a;
  dst[1] = b;
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int repro_probe_copy(const void* x, void* out, long long rows, void* stream) {
  if (rows <= 0) return 0;
  const unsigned int grid = static_cast<unsigned int>((rows + WARPS_PER_CTA - 1) / WARPS_PER_CTA);
  probe_copy_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
