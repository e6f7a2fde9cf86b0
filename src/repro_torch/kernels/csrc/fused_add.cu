// Fused K-way add for Hopper (sm_90a): out[c] = sum_k float(x[k][c]).
//
// Replaces the TPU kernel `fused_add_2d` (`_fused_add_kernel`) of
// src/repro/kernels/fused_add.py, the reduction stage of the all-reduce.
//
// Bound: device memory.  K rows are read once and one f32 row is written,
// (K * itemsize + 4) * n bytes, against K - 1 additions per column.
//
// Design: a thread owns 16 bytes' worth of neighbouring columns (4 f32 or
// 8 bf16), walks the K rows with one 16-byte load each, accumulates in f32
// registers in row order k = 0..K-1 (so the result is deterministic and
// equals a sequential f32 sum), and writes its columns once.  The ragged
// tail is masked in the kernel, so the caller pads nothing.  When the rows
// are not 16-byte aligned (n not a multiple of the vector width, or a
// misaligned base pointer) the scalar variant, one column a thread, runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void load(const float* p, float (&v)[4]) {
    float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ static __forceinline__ float one(const float* p) { return *p; }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static __forceinline__ float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

// n is a multiple of Pack<T>::N and x is 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_add_vec_kernel(const T* __restrict__ x, float* __restrict__ out, int K, long long n) {
  constexpr int V = Pack<T>::N;
  const long long c0 = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * V;
  if (c0 >= n) return;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  for (int k = 0; k < K; ++k) {
    float v[V];
    Pack<T>::load(x + static_cast<long long>(k) * n + c0, v);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += v[i];
  }
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(out + c0 + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_add_scalar_kernel(const T* __restrict__ x, float* __restrict__ out, int K, long long n) {
  const long long c = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= n) return;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) acc += Pack<T>::one(x + static_cast<long long>(k) * n + c);
  out[c] = acc;
}

template <typename T>
int launch(const void* x, void* out, int K, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  constexpr int V = Pack<T>::N;
  const bool aligned = (n % V == 0) &&
                       (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned) {
    const long long threads = n / V;
    const unsigned int grid = static_cast<unsigned int>((threads + THREADS - 1) / THREADS);
    fused_add_vec_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<float*>(out), K, n);
  } else {
    const unsigned int grid = static_cast<unsigned int>((n + THREADS - 1) / THREADS);
    fused_add_scalar_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<float*>(out), K, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_fused_add_f32(const void* x, void* out, int K, long long n, void* stream) {
  return launch<float>(x, out, K, n, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_fused_add_bf16(const void* x, void* out, int K, long long n, void* stream) {
  return launch<__nv_bfloat16>(x, out, K, n, static_cast<cudaStream_t>(stream));
}
