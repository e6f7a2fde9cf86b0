// Mamba selective scan for Hopper (sm_90a), f32 state.
//
// Replaces the TPU kernel `ssm_scan_pallas` (`_ssm_kernel`) of
// src/repro/kernels/ssm_scan.py.  Per (batch b, inner channel d), with a
// state h of d_state = n values carried over the sequence:
//
//     h[k]     <- decay[b,t,k,d] * h[k] + bx[b,t,k,d]
//     y[b,t,d]  = sum_k h[k] * c[b,t,k]
//
// The TPU kernel walks whole chunks of a (B, S, n, d_inner) layout with the
// state in VMEM scratch; it needs S % chunk == 0 and 128-aligned d_inner.
// Here one loop over t runs inside each thread, so any S >= 0 (the S = 1 of a
// decode step too) and any d_inner are taken.
//
// Bound: bytes.  decay and bx are read once and y is written once, (2n + 1)
// values per (b, t, d); the 4 FLOPs per state element are far below the f32
// rate of the CUDA cores.
//
// Design: P = ceil(n / 4), rounded up to a power of two, neighbouring threads
// share one channel d, each holding 4 of its n states in registers; the
// partial sums of y_t meet by xor shuffles and one of the P threads writes y.
// decay and bx are addressed through their (batch, time, state, channel)
// strides.  In the model's layout (B, S, d_inner, n), which the wrapper hands
// over as a transposed view, a thread's 4 states are contiguous: a step is one
// 16-byte load of decay and one of bx (8 bytes each in bf16), and a warp reads
// 8 channels x 64 bytes = 512 contiguous bytes of each.  Other layouts take a
// scalar path with the channel fastest across the warp.  The loads run PF = 4
// steps ahead of the arithmetic in a ring of registers, so that a thread keeps
// 4 x 32 bytes in flight while the dependent chain over t runs.  c[b, t, :] is
// the same for every channel and is read through the read-only cache.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // threads per block
constexpr int NPT = 4;         // states per thread
constexpr int PF = 4;          // time steps in flight

typedef unsigned short bf16_bits;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16_bits x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16_bits* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

struct Step {
  float4 d, b, c;   // decay, bx and c at this thread's 4 states
};

// One step's operands.  off: element offset of (b, t, k0, d) in decay and bx;
// coff: of c[b, t, k0] (c is contiguous (B, S, n)).
template <typename T, bool VEC>
__device__ __forceinline__ void load_step(const T* __restrict__ decay, const T* __restrict__ bx,
                                          const float* __restrict__ c, long long off,
                                          long long sn, long long coff, int k0, int n, bool own,
                                          Step& s) {
  if (VEC) {
    if (own) {
      s.d = load4(decay + off);
      s.b = load4(bx + off);
      s.c = __ldg(reinterpret_cast<const float4*>(c + coff));
    } else {
      s.d = s.b = s.c = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    float dv[NPT], bv[NPT], cv[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const bool ok = own && k0 + j < n;
      dv[j] = ok ? widen(__ldg(decay + off + j * sn)) : 0.f;
      bv[j] = ok ? widen(__ldg(bx + off + j * sn)) : 0.f;
      cv[j] = ok ? __ldg(c + coff + j) : 0.f;
    }
    s.d = make_float4(dv[0], dv[1], dv[2], dv[3]);
    s.b = make_float4(bv[0], bv[1], bv[2], bv[3]);
    s.c = make_float4(cv[0], cv[1], cv[2], cv[3]);
  }
}

// lp2 = log2(P).  VEC: the P threads of a channel are neighbouring lanes and
// read 4 contiguous states (sn == 1); otherwise channels are neighbouring
// lanes and the P threads of one channel lie 32 / P lanes apart.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ decay, const T* __restrict__ bx,
                const float* __restrict__ c, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int S, int n, int di, int lp2,
                long long sb, long long st, long long sn, long long sd,
                long long hb, long long hn, long long hd,
                long long ob, long long on, long long od) {
  const int P = 1 << lp2;
  const int LW = 32 >> lp2;                      // channels per warp
  const int w = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = VEC ? (w & (P - 1)) : (w >> (5 - lp2));
  const int d = blockIdx.x * (THREADS >> lp2) + warp * LW + (VEC ? (w >> lp2) : (w & (LW - 1)));
  const int b = blockIdx.y;
  const int k0 = p * NPT;
  const bool active = d < di;
  const bool own = active && k0 < n;
  const int lane_step = VEC ? 1 : LW;            // xor distance between threads of a channel

  float h[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j)
    h[j] = (own && k0 + j < n)
               ? h0[b * hb + static_cast<long long>(k0 + j) * hn + static_cast<long long>(d) * hd]
               : 0.f;

  const long long base = b * sb + static_cast<long long>(k0) * sn +
                         static_cast<long long>(active ? d : 0) * sd;
  const long long cbase = static_cast<long long>(b) * S * n + k0;
  Step ring[PF];
#pragma unroll
  for (int j = 0; j < PF; ++j)
    load_step<T, VEC>(decay, bx, c, base + j * st, sn, cbase + static_cast<long long>(j) * n, k0,
                      n, own && j < S, ring[j]);

  for (int t0 = 0; t0 < S; t0 += PF) {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int t = t0 + j;
      if (t >= S) break;                         // the same for every thread
      const Step s = ring[j];
      if (t + PF < S)                            // refill the slot, PF steps ahead
        load_step<T, VEC>(decay, bx, c, base + (t + PF) * st, sn,
                          cbase + static_cast<long long>(t + PF) * n, k0, n, own, ring[j]);
      h[0] = fmaf(s.d.x, h[0], s.b.x);
      h[1] = fmaf(s.d.y, h[1], s.b.y);
      h[2] = fmaf(s.d.z, h[2], s.b.z);
      h[3] = fmaf(s.d.w, h[3], s.b.w);
      float acc = h[0] * s.c.x;
      acc = fmaf(h[1], s.c.y, acc);
      acc = fmaf(h[2], s.c.z, acc);
      acc = fmaf(h[3], s.c.w, acc);
      for (int m = 1; m < P; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m * lane_step);
      if (p == 0 && active) y[(static_cast<long long>(b) * S + t) * di + d] = acc;
    }
  }

#pragma unroll
  for (int j = 0; j < NPT; ++j)
    if (own && k0 + j < n)
      h_out[b * ob + static_cast<long long>(k0 + j) * on + static_cast<long long>(d) * od] = h[j];
}

bool aligned(const void* p, uintptr_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

template <typename T>
int launch(const void* decay, const void* bx, const void* c, const void* h0, void* y, void* h_out,
           int B, int S, int n, int di, long long sb, long long st, long long sn, long long sd,
           long long hb, long long hn, long long hd, long long ob, long long on, long long od,
           cudaStream_t stream) {
  int lp2 = 0;
  while ((NPT << lp2) < n) ++lp2;                // P = 1, 2, 4 or 8 threads per channel
  const int channels = THREADS >> lp2;
  const dim3 grid((di + channels - 1) / channels, B);
  const auto* dp = static_cast<const T*>(decay);
  const auto* bp = static_cast<const T*>(bx);
  const auto* cp = static_cast<const float*>(c);
  const auto* hp = static_cast<const float*>(h0);
  auto* yp = static_cast<float*>(y);
  auto* op = static_cast<float*>(h_out);
  const uintptr_t vec_bytes = NPT * sizeof(T);
  const bool vec = sn == 1 && n % NPT == 0 && sb % NPT == 0 && st % NPT == 0 && sd % NPT == 0 &&
                   aligned(decay, vec_bytes) && aligned(bx, vec_bytes) && aligned(c, 16);
  if (vec)
    ssm_scan_kernel<T, true><<<grid, THREADS, 0, stream>>>(dp, bp, cp, hp, yp, op, S, n, di, lp2,
                                                           sb, st, sn, sd, hb, hn, hd, ob, on, od);
  else
    ssm_scan_kernel<T, false><<<grid, THREADS, 0, stream>>>(dp, bp, cp, hp, yp, op, S, n, di, lp2,
                                                            sb, st, sn, sd, hb, hn, hd, ob, on, od);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// decay, bx: (B, S, n, d_inner) of f32 (bf16 = 0) or bf16 (bf16 = 1), through
// the element strides (sb, st, sn, sd), both the same; c: f32 (B, S, n)
// contiguous; h0, h_out: f32 (B, n, d_inner) through (hb, hn, hd) and (ob, on,
// od); y: f32 (B, S, d_inner) contiguous.  1 <= n <= 32.
extern "C" int repro_ssm_scan(const void* decay, const void* bx, const void* c, const void* h0,
                              void* y, void* h_out, int bf16, int B, int S, int n, int di,
                              long long sb, long long st, long long sn, long long sd,
                              long long hb, long long hn, long long hd,
                              long long ob, long long on, long long od, void* stream) {
  if (B <= 0 || B > 65535 || S < 0 || n < 1 || n > NPT * 8 || di <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto cs = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<bf16_bits>(decay, bx, c, h0, y, h_out, B, S, n, di, sb, st, sn, sd, hb, hn, hd,
                             ob, on, od, cs);
  return launch<float>(decay, bx, c, h0, y, h_out, B, S, n, di, sb, st, sn, sd, hb, hn, hd, ob, on,
                       od, cs);
}
