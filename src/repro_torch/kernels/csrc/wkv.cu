// RWKV-6 WKV recurrence for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel `wkv_pallas` (`_wkv_kernel`) of
// src/repro/kernels/wkv.py.  Per (batch, head), with an hd x hd state S
// carried over the sequence:
//
//     y_t[e] = sum_d r_t[d] * (S[d,e] + u[d] * k_t[d] * v_t[e])
//     S[d,e] <- exp(logw_t[d]) * S[d,e] + k_t[d] * v_t[e]
//
// The TPU kernel computes the same function in chunks (an intra-chunk
// decay-weighted attention on the matrix unit plus a carried state).  Here
// it is written as the recurrence itself, so there is no S % chunk
// constraint and no (C, C, hd) pairwise-decay tensor.
//
// Bound: by bytes, r, k, v, logw are read once and y written once (5 x 4 B
// per element); by operations, about 4 hd FLOPs per element on CUDA cores.
// The recurrence is a dependent chain over t, so what limits this first
// version is latency: the parallel work is B * H * hd columns.
//
// Design: one block per (b, h) with 4 threads per state column.  Thread
// (e, p) keeps rows d = p, p + 4, p + 8, ... of column S[:, e] in registers
// (hd / 4 floats) and walks t in order; the four partial sums of y_t[e] meet
// by two xor shuffles (the four threads of a column are neighbouring lanes).
// r, k, v, exp(logw) and u*k of TC = 16 steps are staged in shared memory,
// the four that row d needs packed as one float4; every thread loads the
// next 16 steps into registers before it computes the current ones, so the
// loads overlap the arithmetic.  Threads read the staged rows by broadcast
// (a warp touches four neighbouring float4s at a time: no bank conflicts).  The inputs are addressed through (batch, head, time)
// strides with a unit stride along hd, so the model's (B, S, H, hd) tensors
// are read where they lie; y is written with the same strides.
#include <cuda_runtime.h>

namespace {

constexpr int P = 4;        // threads per state column
constexpr int TC = 16;      // time steps staged per round
constexpr int PER = TC / P; // staged elements per thread and array (TC * hd / (P * hd))

__device__ __forceinline__ void prefetch(const float* __restrict__ r, const float* __restrict__ k,
                                         const float* __restrict__ v, const float* __restrict__ logw,
                                         long long base, long long st, int S, int t, int d,
                                         float (&pr)[PER], float (&pk)[PER], float (&pw)[PER],
                                         float (&pv)[PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j, t += P) {
    if (t < S) {
      const long long off = base + static_cast<long long>(t) * st + d;
      pr[j] = r[off]; pk[j] = k[off]; pw[j] = logw[off]; pv[j] = v[off];
    }
  }
}

// RPT = hd / P state rows per thread, a compile-time constant so that the
// state stays in registers
template <int RPT>
__global__ void __launch_bounds__(128 * P)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ s_out,
           int H, int S, int hd, long long sb, long long sh, long long st) {
  extern __shared__ float4 smem[];
  float4* rkwu_s = smem;                                      // [TC][hd]: r, k, exp(logw), u*k
  float* v_s = reinterpret_cast<float*>(rkwu_s + TC * hd);    // [TC][hd]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int e = tid / P, p = tid % P;      // state column, row phase
  const long long base = static_cast<long long>(b) * sb + static_cast<long long>(h) * sh;

  float state[RPT];
  const float* s0p = s0 + static_cast<long long>(bh) * hd * hd;
#pragma unroll
  for (int i = 0; i < RPT; ++i) state[i] = s0p[(i * P + p) * hd + e];

  // staging: thread tid loads element (t = tid / hd + P * j, d = tid % hd)
  const int ld_d = tid % hd, ld_t = tid / hd;
  const float u_d = u[h * hd + ld_d];
  float pr[PER] = {}, pk[PER] = {}, pw[PER] = {}, pv[PER] = {};   // past S: staged, never read
  prefetch(r, k, v, logw, base, st, S, ld_t, ld_d, pr, pk, pw, pv);
  for (int t0 = 0; t0 < S; t0 += TC) {
    __syncthreads();                       // the previous round is consumed
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = (ld_t + P * j) * hd + ld_d;
      rkwu_s[idx] = make_float4(pr[j], pk[j], expf(pw[j]), u_d * pk[j]);
      v_s[idx] = pv[j];
    }
    __syncthreads();
    if (t0 + TC < S)                       // in flight while this round computes
      prefetch(r, k, v, logw, base, st, S, t0 + TC + ld_t, ld_d, pr, pk, pw, pv);
    const int tc = min(TC, S - t0);
    for (int t = 0; t < tc; ++t) {
      const float4* row = rkwu_s + t * hd;
      const float ve = v_s[t * hd + e];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 q = row[i * P + p];             // one 16-byte load: r, k, w, u*k at d
        const float sd = state[i];
        acc = fmaf(q.x, fmaf(q.w, ve, sd), acc);
        state[i] = fmaf(q.z, sd, q.y * ve);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (p == 0) y[base + static_cast<long long>(t0 + t) * st + e] = acc;
    }
  }

  float* so = s_out + static_cast<long long>(bh) * hd * hd;
#pragma unroll
  for (int i = 0; i < RPT; ++i) so[(i * P + p) * hd + e] = state[i];
}

template <int RPT>
int launch(const float* r, const float* k, const float* v, const float* logw, const float* u,
           const float* s0, float* y, float* s_out, int B, int H, int S, int hd,
           long long sb, long long sh, long long st, cudaStream_t stream) {
  const size_t smem = (sizeof(float4) + sizeof(float)) * TC * hd;
  wkv_kernel<RPT><<<B * H, hd * P, smem, stream>>>(r, k, v, logw, u, s0, y, s_out,
                                                     H, S, hd, sb, sh, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hd must be a multiple of 8 in [8, 128] (so a block is whole warps and a
// column's four threads share a warp); y has the inputs' strides.
extern "C" int repro_wkv_f32(const void* r, const void* k, const void* v, const void* logw,
                             const void* u, const void* s0, void* y, void* s_out,
                             int B, int H, int S, int hd,
                             long long sb, long long sh, long long st, void* stream) {
  if (hd < 8 || hd > 128 || hd % 8 != 0 || B <= 0 || H <= 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const float*>(r);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* wp = static_cast<const float*>(logw);
  const auto* up = static_cast<const float*>(u);
  const auto* sp = static_cast<const float*>(s0);
  auto* yp = static_cast<float*>(y);
  auto* op = static_cast<float*>(s_out);
  auto cs = static_cast<cudaStream_t>(stream);
  switch (hd / P) {
#define REPRO_WKV_CASE(R) \
    case R: return launch<R>(rp, kp, vp, wp, up, sp, yp, op, B, H, S, hd, sb, sh, st, cs);
    REPRO_WKV_CASE(2) REPRO_WKV_CASE(4) REPRO_WKV_CASE(6) REPRO_WKV_CASE(8)
    REPRO_WKV_CASE(10) REPRO_WKV_CASE(12) REPRO_WKV_CASE(14) REPRO_WKV_CASE(16)
    REPRO_WKV_CASE(18) REPRO_WKV_CASE(20) REPRO_WKV_CASE(22) REPRO_WKV_CASE(24)
    REPRO_WKV_CASE(26) REPRO_WKV_CASE(28) REPRO_WKV_CASE(30) REPRO_WKV_CASE(32)
#undef REPRO_WKV_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
