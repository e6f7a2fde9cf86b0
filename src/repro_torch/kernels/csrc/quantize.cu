// Row-wise gradient quantizers for Hopper (sm_90a): int8 block quantization
// and deterministic TernGrad ternarization.
//
// Replaces the TPU kernels `quantize_int8_2d` (`_quant_int8_kernel`) and
// `ternarize_2d` (`_ternary_kernel`) of src/repro/kernels/quantize.py.
//
// Bound: device memory.  Each element is read once as 4 bytes and written
// once as 1 byte (plus 4 bytes of scale per 256-element row), and the
// arithmetic per element is a handful of instructions, so the least time
// is bytes / memory rate.
//
// Design: one warp owns one 256-element row (one quantization block).  A
// lane holds 8 neighbouring floats (two 16-byte loads), the row statistic
// (max |x| or sum |x|) is a shuffle reduction, so nothing goes through
// shared memory and no block-level barrier is needed, and the lane's 8
// int8 results leave as one 8-byte store.  Division is IEEE (no fast
// math) and rounding is rintf (round half to even), so the int8 codes
// equal the plain PyTorch version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;            // elements per row = quantization block
constexpr int WARPS_PER_CTA = 8;
constexpr int THREADS = WARPS_PER_CTA * 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load_row8(const float* __restrict__ x, long long row,
                                          int lane, float (&v)[8]) {
  const float4* p = reinterpret_cast<const float4*>(x + row * BLOCK + lane * 8);
  float4 a = p[0], b = p[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store_row8(int8_t* __restrict__ q, long long row,
                                           int lane, const int (&c)[8]) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo |= (static_cast<uint32_t>(c[i]) & 0xffu) << (8 * i);
    hi |= (static_cast<uint32_t>(c[i + 4]) & 0xffu) << (8 * i);
  }
  *reinterpret_cast<uint2*>(q + row * BLOCK + lane * 8) = make_uint2(lo, hi);
}

__global__ void __launch_bounds__(THREADS)
quantize_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (row >= rows) return;                      // whole warp leaves together
  float v[8];
  load_row8(x, row, lane, v);
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  amax = warp_max(amax);
  const float scale = amax > 0.0f ? amax / 127.0f : 1.0f;
  int c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float r = rintf(v[i] / scale);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    c[i] = static_cast<int>(r);
  }
  store_row8(q, row, lane, c);
  if (lane == 0) s[row] = scale;
}

__global__ void __launch_bounds__(THREADS)
ternarize_kernel(const float* __restrict__ x, int8_t* __restrict__ t,
                 float* __restrict__ s, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (row >= rows) return;
  float v[8];
  load_row8(x, row, lane, v);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += fabsf(v[i]);
  sum = warp_sum(sum);                          // xor tree: every lane gets the same bits
  const float scale = sum / static_cast<float>(BLOCK);
  int c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a = fabsf(v[i]);
    c[i] = (a >= scale) ? ((v[i] > 0.0f) - (v[i] < 0.0f)) : 0;
  }
  store_row8(t, row, lane, c);
  if (lane == 0) s[row] = scale;
}

inline unsigned int grid_for(long long rows) {
  return static_cast<unsigned int>((rows + WARPS_PER_CTA - 1) / WARPS_PER_CTA);
}

}  // namespace

extern "C" int repro_quantize_int8(const void* x, void* q, void* s, long long rows,
                                   void* stream) {
  if (rows <= 0) return 0;
  quantize_int8_kernel<<<grid_for(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_ternarize(const void* x, void* t, void* s, long long rows,
                               void* stream) {
  if (rows <= 0) return 0;
  ternarize_kernel<<<grid_for(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(t), static_cast<float*>(s), rows);
  return static_cast<int>(cudaGetLastError());
}
