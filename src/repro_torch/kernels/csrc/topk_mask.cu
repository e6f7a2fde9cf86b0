// Magnitude-threshold sparsification mask for Hopper (sm_90a), the apply
// half of DGC-style top-k: out[i] = |float(x[i])| >= thr ? x[i] : 0.
//
// Replaces the TPU kernel `topk_mask_2d` (`_topk_mask_kernel`) of
// src/repro/kernels/topk_mask.py.
//
// Bound: device memory.  Each element is read once and written once in its
// own type (4 bytes f32, 2 bytes bf16), against one compare and one select.
//
// Design: a grid-stride loop in which a thread moves 16 bytes at a time (4
// f32 or 8 bf16), so every access is one 16-byte load or store and the grid
// stays a few waves deep whatever the bucket size.  The threshold is read
// from device memory through a pointer, so the caller never copies it to
// the host (no synchronisation per bucket).  A bf16 element is widened by
// shifting its bits (exact) and, when kept, written back as the same 16
// bits, so the output equals the input bit for bit where it is kept and is
// +0 elsewhere, as in the reference; a NaN fails the compare and becomes 0.
// When the pointers are not 16-byte aligned every element takes the scalar
// loop; the ragged tail (n not a multiple of the vector width) always does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks of 256 threads per SM

__device__ __forceinline__ float keep_f32(float x, float thr) {
  return fabsf(x) >= thr ? x : 0.0f;
}

__device__ __forceinline__ uint32_t keep_bf16(uint32_t bits, float thr) {
  return fabsf(__uint_as_float(bits << 16)) >= thr ? bits : 0u;
}

__global__ void __launch_bounds__(THREADS)
topk_mask_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const float* __restrict__ thr_ptr, long long n, int vec) {
  const float thr = __ldg(thr_ptr);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long i0 = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long nv = vec ? n / 4 : 0;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* ov = reinterpret_cast<float4*>(out);
  for (long long i = i0; i < nv; i += stride) {
    float4 a = xv[i];
    a.x = keep_f32(a.x, thr);
    a.y = keep_f32(a.y, thr);
    a.z = keep_f32(a.z, thr);
    a.w = keep_f32(a.w, thr);
    ov[i] = a;
  }
  for (long long i = nv * 4 + i0; i < n; i += stride) out[i] = keep_f32(x[i], thr);
}

__global__ void __launch_bounds__(THREADS)
topk_mask_bf16_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
                      const float* __restrict__ thr_ptr, long long n, int vec) {
  const float thr = __ldg(thr_ptr);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long i0 = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long nv = vec ? n / 8 : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long i = i0; i < nv; i += stride) {
    uint4 a = xv[i];
    uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = keep_bf16(w[j] & 0xffffu, thr);
      const uint32_t hi = keep_bf16(w[j] >> 16, thr);
      w[j] = lo | (hi << 16);
    }
    ov[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (long long i = nv * 8 + i0; i < n; i += stride)
    out[i] = static_cast<uint16_t>(keep_bf16(x[i], thr));
}

inline unsigned int grid_for(long long work) {
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return static_cast<unsigned int>(blocks);
}

inline bool aligned16(const void* a, const void* b) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

extern "C" int repro_topk_mask_f32(const void* x, void* out, const void* thr, long long n,
                                   void* stream) {
  if (n <= 0) return 0;
  const int vec = aligned16(x, out);
  topk_mask_f32_kernel<<<grid_for(vec ? n / 4 : n), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<const float*>(thr),
      n, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_topk_mask_bf16(const void* x, void* out, const void* thr, long long n,
                                    void* stream) {
  if (n <= 0) return 0;
  const int vec = aligned16(x, out);
  topk_mask_bf16_kernel<<<grid_for(vec ? n / 8 : n), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out),
      static_cast<const float*>(thr), n, vec);
  return static_cast<int>(cudaGetLastError());
}
