// Flash attention forward for Hopper (sm_90a): causal or full online-softmax
// attention with grouped-query heads, f32 or bf16 in, f32 accumulation.
//
// Replaces the TPU kernel `flash_attention_pallas` (`_flash_kernel`) of
// src/repro/kernels/flash_attn.py.
//
// Bound: operations.  For S = 4096 and head_dim = 80 the work is about
// 4 * S^2 * hd / 2 flops a head against 4 * S * hd elements moved, far
// above the card's flops-per-byte ridge, so the bound is flops over the
// tensor-core rate of the input type.
//
// Design (a first version that is right; it uses the CUDA cores, not the
// tensor cores, so it sits well below that bound):
//  * one thread block owns one (batch*head, 64-row query tile); the loop
//    over 64-row key/value tiles runs inside the block and takes the place
//    of the TPU kernel's sequential grid axis.  The running max, the
//    denominator and the output accumulator stay in registers in f32 for
//    the whole loop and never touch device memory;
//  * Q (pre-scaled by 1/sqrt(hd)), K and V tiles are converted to f32 into
//    shared memory; rows are padded by 4 floats so the 16-byte reads of 8
//    neighbouring threads fall into different banks;
//  * 256 threads form a 16 x 16 grid; a thread computes a 4 x 4 patch of
//    the score tile (rows ty + 16 i, columns tx + 16 j), reduces row max
//    and row sum over its 16-lane half warp by shuffles, hands the
//    probabilities to the second product through shared memory, and
//    accumulates 4 rows x (hd / 16) columns of the output;
//  * causal: key tiles wholly above the diagonal are never visited, the
//    diagonal tile is masked with -1e30, and heavy (late) query tiles are
//    scheduled first;
//  * grouped-query heads by index arithmetic: query row b reads key/value
//    row (b / Hq) * Hkv + (b % Hq) / g; no repeat is materialised;
//  * head_dim is a runtime value, any multiple of 8 up to 128 (80 for
//    stablelm-3b), so one instantiation per input type serves every model.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                 // query rows per block
constexpr int BN = 64;                 // key/value rows per inner step
constexpr int THREADS = 256;           // 16 x 16
constexpr int PS_LD = BN + 4;          // padded row of the probability tile
constexpr int MAX_DJ = 8;              // output columns per thread: hd <= 16 * 8
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load16(const float* __restrict__ src, float* dst, float scale) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* __restrict__ src, float* dst, float scale) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(f0.x * scale, f0.y * scale, f1.x * scale, f1.y * scale);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f2.x * scale, f2.y * scale, f3.x * scale, f3.y * scale);
}

template <typename T> struct Elems;    // elements in one 16-byte load
template <> struct Elems<float> { static constexpr int N = 4; };
template <> struct Elems<__nv_bfloat16> { static constexpr int N = 8; };

// Copy `rows` contiguous rows of `hd` elements into shared memory rows of
// stride `ld` floats, converting to f32 and multiplying by `scale`.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst, int rows,
                                          int hd, int ld, float scale) {
  constexpr int V = Elems<T>::N;
  const int per_row = hd / V;
  const int total = rows * per_row;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * V;
    load16(src + static_cast<size_t>(r) * hd + c, dst + r * ld + c, scale);
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int BH, int Sq, int Skv, int hd, int n_heads,
                 int n_kv_heads, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + 4;
  float* Qs = smem;
  float* Ks = Qs + BM * ld;
  float* Vs = Ks + BN * ld;
  float* Ps = Vs + BN * ld;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  // tile-major block order; causal runs the longest query tiles first
  const int n_qt = Sq / BM;
  const int t = blockIdx.x / BH;
  const int bh = blockIdx.x - t * BH;
  const int qi = causal ? (n_qt - 1 - t) : t;
  const int g = n_heads / n_kv_heads;
  const int kvh = (bh / n_heads) * n_kv_heads + (bh % n_heads) / g;

  const T* qp = q + (static_cast<size_t>(bh) * Sq + static_cast<size_t>(qi) * BM) * hd;
  const T* kp = k + static_cast<size_t>(kvh) * Skv * hd;
  const T* vp = v + static_cast<size_t>(kvh) * Skv * hd;

  load_tile<T>(qp, Qs, BM, hd, ld, scale);

  float m_i[4], l_i[4], acc[4][MAX_DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < MAX_DJ; ++j) acc[i][j] = 0.0f;
  }

  int n_kv = Skv / BN;
  if (causal) {
    const int last = (qi * BM + BM - 1) / BN + 1;   // tiles that hold a key <= the last query
    n_kv = last < n_kv ? last : n_kv;
  }

  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();                   // the previous step's reads of Ks, Vs, Ps are done
    load_tile<T>(kp + static_cast<size_t>(j) * BN * hd, Ks, BN, hd, ld, 1.0f);
    load_tile<T>(vp + static_cast<size_t>(j) * BN * hd, Vs, BN, hd, ld, 1.0f);
    __syncthreads();

    // scores: s[i][jj] = Q[ty + 16 i] . K[tx + 16 jj]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
    for (int d = 0; d < hd; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        b[jj] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * jj) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(a[i].x, b[jj].x, s[i][jj]);
          s[i][jj] = fmaf(a[i].y, b[jj].y, s[i][jj]);
          s[i][jj] = fmaf(a[i].z, b[jj].z, s[i][jj]);
          s[i][jj] = fmaf(a[i].w, b[jj].w, s[i][jj]);
        }
    }

    if (causal && j * BN + BN - 1 > qi * BM) {   // the tile crosses the diagonal
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q_pos = qi * BM + ty + 16 * i;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int k_pos = j * BN + tx + 16 * jj;
          if (k_pos > q_pos) s[i][jj] = NEG_INF;
        }
      }
    }

    // online softmax, one row at a time; a row lives in one 16-lane half warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * PS_LD + tx + 16 * jj] = p;
      }
      rs = half_warp_sum(rs);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < MAX_DJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();                   // Ps is complete

    // acc[i][jj] += sum_kk P[ty + 16 i][kk] * V[kk][tx + 16 jj]
    for (int kk = 0; kk < BN; kk += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PS_LD + kk);
        pr[i][0] = p4.x; pr[i][1] = p4.y; pr[i][2] = p4.z; pr[i][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int jj = 0; jj < MAX_DJ; ++jj) {
          const int c = tx + 16 * jj;
          if (c < hd) {
            const float vv = Vs[(kk + u) * ld + c];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pr[i][u], vv, acc[i][jj]);
          }
        }
      }
    }
  }

  T* op = o + (static_cast<size_t>(bh) * Sq + static_cast<size_t>(qi) * BM) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.0f / fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < MAX_DJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < hd) store_out(op + static_cast<size_t>(ty + 16 * i) * hd + c, acc[i][jj] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv,
           int hd, int n_heads, int n_kv_heads, int causal, float scale, cudaStream_t stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if (hd % 8 != 0 || hd > 16 * MAX_DJ || Sq % BM != 0 || Skv % BN != 0 || Skv <= 0 ||
      n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || BH % n_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = hd + 4;
  const size_t smem = (static_cast<size_t>(BM + 2 * BN) * ld + static_cast<size_t>(BM) * PS_LD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(BH) * (Sq / BM);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<T><<<static_cast<unsigned int>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), BH, Sq, Skv, hd, n_heads, n_kv_heads, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                                    int BH, int Sq, int Skv, int hd, int n_heads,
                                    int n_kv_heads, int causal, float scale, void* stream) {
  return launch<float>(q, k, v, o, BH, Sq, Skv, hd, n_heads, n_kv_heads, causal, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int repro_flash_attn_bf16(const void* q, const void* k, const void* v, void* o,
                                     int BH, int Sq, int Skv, int hd, int n_heads,
                                     int n_kv_heads, int causal, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, BH, Sq, Skv, hd, n_heads, n_kv_heads, causal, scale,
                               static_cast<cudaStream_t>(stream));
}
