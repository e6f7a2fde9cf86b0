// Row-wise gradient quantizers for Hopper (sm_90a): int8 block quantization,
// deterministic TernGrad ternarization, and the decode of both.
//
// Replaces the TPU kernels `quantize_int8_2d` (`_quant_int8_kernel`),
// `dequantize_int8_2d` (`_dequant_int8_kernel`) and `ternarize_2d`
// (`_ternary_kernel`) of src/repro/kernels/quantize.py.
//
// Bound: device memory.  An encode reads each element once as 4 bytes and
// writes it once as 1 byte (plus 4 bytes of scale per 256-element row); the
// decode reads 1 byte and writes 4.  The arithmetic per element is a
// handful of instructions, so the least time is bytes / memory rate.
//
// Design: one warp owns one 256-element row (one quantization block).  A
// lane holds 8 neighbouring floats (two 16-byte loads), the row statistic
// (max |x| or sum |x|) is a shuffle reduction, so nothing goes through
// shared memory and no block-level barrier is needed, and the lane's 8
// int8 results leave as one 8-byte store.  Division is IEEE (no fast
// math) and rounding is rintf (round half to even), so the int8 codes
// equal the plain PyTorch version's bit for bit.  The decode has the same
// launch shape (one warp a row); a lane reads the row's scale once and two
// 4-byte words of codes, 4 at lane*4 and 4 at 128 + lane*4, and writes its
// 8 floats as two 16-byte stores, so each warp-wide store is 512
// contiguous bytes (one 8-byte load and two stores at lane*32 bytes, each
// store touching half of every sector, read 1.18 ms against 1.02 ms at the
// largest bucket on an H100, chip_smoke.py).  The product is one rounded
// multiply (__fmul_rn, never contracted), the plain version's
// float32(q) * s bit for bit.  It takes any int8 codes, so the ternary
// codes {-1, 0, 1} decode through it unchanged.
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

__global__ void __launch_bounds__(THREADS)
dequantize_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                       float* __restrict__ out, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (row >= rows) return;
  // codes 4*lane..4*lane+3 and 128+4*lane..: each warp-wide access, the
  // two loads and the two stores, is one contiguous span
  const uint32_t* qr = reinterpret_cast<const uint32_t*>(q + row * BLOCK);
  const uint32_t c0 = qr[lane], c1 = qr[32 + lane];
  const float scale = __ldg(s + row);
  float v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // sign-extend byte i of each word
    v[i] = __fmul_rn(static_cast<float>(static_cast<int8_t>(c0 >> (8 * i))), scale);
    v[i + 4] = __fmul_rn(static_cast<float>(static_cast<int8_t>(c1 >> (8 * i))), scale);
  }
  float4* o = reinterpret_cast<float4*>(out + row * BLOCK);
  o[lane] = make_float4(v[0], v[1], v[2], v[3]);
  o[32 + lane] = make_float4(v[4], v[5], v[6], v[7]);
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

extern "C" int repro_dequantize_int8(const void* q, const void* s, void* out, long long rows,
                                     void* stream) {
  if (rows <= 0) return 0;
  dequantize_int8_kernel<<<grid_for(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s), static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
