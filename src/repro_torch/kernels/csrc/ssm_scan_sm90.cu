// Fused Mamba selective scan for Hopper (sm_90a): the discretisation of the
// SSM is done inside the scan, so the two (B, S, d_inner, d_state) tensors
// decay = exp(dt * A) and bx = dt * x * B are never written to device memory.
//
// Replaces, on the Mamba mixer's path, the TPU kernel `ssm_scan_pallas`
// (`_ssm_kernel`, src/repro/kernels/ssm_scan.py:65) together with the
// formation in front of it (src/repro/models/mamba.py:205-207).  The kernel
// with the TPU signature stays in ssm_scan.cu (the bf16_stream path).  Per
// batch b, inner channel d and state k, for t = 0 .. S-1:
//
//     decay = exp(dt[b,t,d] * a[d,k])           (rounded product, then expf)
//     bx    = (dt[b,t,d] * x[b,t,d]) * B[b,t,k]  (two rounded products)
//     h[k]  = decay * h[k] + bx                   (one fused multiply-add)
//     y[b,t,d] = sum_k h[k] * C[b,t,k]
//
// decay and bx are formed in registers in the order of operations of
// src/repro_torch/models/mamba.py (`(dt[..., None] * a).exp_()`, `(dt *
// xs.float())[..., None] * b_t`), with `__fmul_rn` so that no product is
// contracted into a neighbouring add: they equal the plain ones bit for bit
// where `expf` agrees with PyTorch's `exp`.
//
// Bound: the larger of (a) the bytes, dt f32 and x (bf16 or f32) read once,
// y f32 written once, B, C, a, h0 and h (1.35 GB at Jamba's serving shape,
// 0.40 ms at 3.35 TB/s), (b) the B*S*d_inner*n `exp`s on the special-function
// units, 16 a clock on each of the 132 SMs (0.51 ms there), and (c) about 6
// f32 operations a state element (0.19 ms at 67 TFLOP/s).  The TPU-signature
// kernel reads the two formed tensors, 17.2 GB at that shape, and the model
// spends about as much again forming them.
//
// No tensor cores: decay is per (channel, state), so no chunk of this
// recurrence is a matrix product.  (Mamba-2's SSD form, with one scalar
// decay per head, is; Mamba-1's is not.)  The work is `expf` and FMAs on the
// CUDA cores and the special-function units.
//
// Design:
//  * a block owns DC channels of one batch row and walks the whole sequence:
//    CW consumer warps and one producer warp.  The producer keeps a ring of
//    STAGES = 2 stages in shared memory filled, T = 32 time steps a stage: per
//    step one `cp.async.bulk` of the DC values of dt and one of x (one lane a
//    step), and one bulk copy each of the stage's (T, n) rows of B and C.
//    Each stage completes on a "full" mbarrier by transaction bytes; the
//    consumers free it on an "empty" mbarrier.  Shapes the bulk copies cannot
//    take (d_inner % 8 != 0, n not a multiple of NPT below, a pointer off 16
//    bytes, fewer than 8 channels a block) are loaded by the producer lanes
//    with plain loads into the same ring, B and C rows padded with zeros to a
//    multiple of NPT (32 arrivals);
//  * a consumer thread owns NPT states of one channel in registers, with a and
//    h0 for them; P = n / NPT neighbouring lanes share a channel and y's
//    partial sums meet by xor shuffles.  A long scan runs NPT = 8: 8
//    independent exps a step hide the latency of each, and y's sum over the
//    states is four interleaved partial sums, then one shuffle at n = 16;
//  * y goes through shared memory: a stage's (T, DC) tile is written there,
//    the consumers meet on a named barrier, and store it as rows of DC
//    contiguous values (two y tiles, so one barrier a stage suffices);
//  * the launch picks NPT and the consumer warps CW from the shape (see
//    `launch`).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 32;                      // time steps a stage: one producer lane a step
constexpr int STAGES = 2;

typedef unsigned short bf16_bits;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_bits v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// a wait of 2^35 cycles (about 17 s) means a lost arrival: trap instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// `bytes` contiguous bytes from device memory into shared memory, completed
// on `bar` by transaction count; both addresses 16-byte aligned, bytes % 16 == 0
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumer_barrier(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// NPT consecutive values of a B or C row (16-byte aligned), or zeros
template <int NPT>
__device__ __forceinline__ void load_states(const float* p, bool own, float (&v)[NPT]) {
  static_assert(NPT % 4 == 0, "a thread holds whole float4s of states");
#pragma unroll
  for (int i = 0; i < NPT / 4; ++i) {
    const float4 q = own ? reinterpret_cast<const float4*>(p)[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
  }
}

// One stage of T steps for one consumer thread.  The stage's inputs and
// its y tile are separate regions of shared memory; saying so (__restrict__)
// lets the compiler hoist the next steps' loads and exps above this step's
// store of y, so that steps overlap instead of waiting on each other.
template <typename XT, int NPT>
__device__ __forceinline__ void scan_stage(const float* __restrict__ s_dt,
                                           const XT* __restrict__ s_x,
                                           const float* __restrict__ s_b,
                                           const float* __restrict__ s_c, float* __restrict__ yb,
                                           int rows, int DC, int ns, int ch, int k0, int P, bool own,
                                           const float (&av)[NPT], float (&h)[NPT]) {
  constexpr int UNROLL = NPT >= 8 ? 2 : 4;
#pragma unroll UNROLL
  for (int tt = 0; tt < rows; ++tt) {
    const float dtv = s_dt[tt * DC + ch];
    const float dtx = __fmul_rn(dtv, widen(s_x[tt * DC + ch]));
    float bv[NPT], cv[NPT];
    load_states<NPT>(s_b + tt * ns + k0, own, bv);
    load_states<NPT>(s_c + tt * ns + k0, own, cv);
    // y's sum over the states in NACC interleaved partial sums, so that its
    // chain of dependent multiply-adds is NPT / NACC deep, not NPT
    constexpr int NACC = NPT >= 8 ? 4 : 1;
    float acc[NACC];
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const float decay = expf(__fmul_rn(dtv, av[j]));
      h[j] = fmaf(decay, h[j], __fmul_rn(dtx, bv[j]));
      acc[j % NACC] = j < NACC ? __fmul_rn(h[j], cv[j]) : fmaf(h[j], cv[j], acc[j % NACC]);
    }
    float y = acc[0];
#pragma unroll
    for (int i = 1; i < NACC; ++i) y += acc[i];
    for (int m = 1; m < P; m <<= 1) y += __shfl_xor_sync(0xffffffffu, y, m);
    if (k0 == 0) yb[tt * DC + ch] = y;
  }
}

struct Args {
  const float* dt;      // (B, S, di) contiguous
  const void* x;        // (B, S, di) contiguous, f32 or bf16
  const float* b;       // (B, S, n) contiguous
  const float* c;       // (B, S, n) contiguous
  const float* a;       // (di, n) contiguous
  const float* h0;      // (B, di, n) through (hb, hd, hn)
  float* y;             // (B, S, di) contiguous
  float* h;             // (B, di, n) contiguous
  int S, n, di;
  int ns;               // row stride of B and C in shared memory: n rounded up
  int lp2;              // log2 of P, the threads a channel
  long long hb, hd, hn;
};

template <typename XT>
__host__ __device__ constexpr int stage_bytes(int dc, int ns) {
  return T * dc * 4 + T * dc * static_cast<int>(sizeof(XT)) + 2 * T * ns * 4;
}

template <typename XT, int NPT, int CW, bool BULK>
__global__ void __launch_bounds__(32 * (CW + 1)) ssm_scan_fused_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CONSUMERS = 32 * CW;
  const int P = 1 << p.lp2;
  const int ldc = 5 + (CW == 4 ? 2 : CW == 2 ? 1 : 0) - p.lp2;
  const int DC = 1 << ldc;                           // channels a block
  const int S = p.S, n = p.n, ns = p.ns, di = p.di;
  const int b = blockIdx.y, d0 = blockIdx.x * DC;
  const int wd = min(DC, di - d0);                   // channels of this block that exist
  const int dt_bytes = T * DC * 4, x_bytes = T * DC * static_cast<int>(sizeof(XT));
  const int sbytes = stage_bytes<XT>(DC, ns);
  float* ybuf = reinterpret_cast<float*>(smem + STAGES * sbytes);
  const uint32_t full = smem_u32(smem + STAGES * sbytes + 2 * T * DC * 4);
  const uint32_t empty = full + 8 * STAGES;
  const int n_iter = (S + T - 1) / T;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, BULK ? 1 : 32);
      mbar_init(empty + 8 * s, CONSUMERS >> 5);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= CONSUMERS) {                    // the producer warp
    const XT* x = static_cast<const XT*>(p.x);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
      const int t0 = it * T, rows = min(T, S - t0);
      const long long row0 = static_cast<long long>(b) * S + t0;   // row of (B * S, .)
      unsigned char* st = smem + s * sbytes;
      float* s_dt = reinterpret_cast<float*>(st);
      XT* s_x = reinterpret_cast<XT*>(st + dt_bytes);
      float* s_b = reinterpret_cast<float*>(st + dt_bytes + x_bytes);
      float* s_c = s_b + T * ns;
      const uint32_t bar = full + 8 * s;
      if (BULK) {
        if (lane == 0)
          mbar_expect_tx(bar, rows * (wd * 4 + wd * static_cast<int>(sizeof(XT)) + 2 * n * 4));
        __syncwarp();
        if (lane < rows) {
          const long long off = (row0 + lane) * di + d0;
          bulk_load(smem_u32(s_dt + lane * DC), p.dt + off, wd * 4, bar);
          bulk_load(smem_u32(s_x + lane * DC), x + off, wd * sizeof(XT), bar);
        }
        if (lane == 0) {
          bulk_load(smem_u32(s_b), p.b + row0 * n, rows * n * 4, bar);
          bulk_load(smem_u32(s_c), p.c + row0 * n, rows * n * 4, bar);
        }
      } else {
        for (int e = lane; e < rows * DC; e += 32) {
          const int tt = e >> ldc, col = e & (DC - 1);
          const long long off = (row0 + tt) * di + d0 + col;
          s_dt[e] = col < wd ? p.dt[off] : 0.f;
          s_x[e] = col < wd ? x[off] : XT(0);
        }
        for (int e = lane; e < rows * ns; e += 32) {
          const int tt = e / ns, k = e - tt * ns;
          const long long off = (row0 + tt) * n + k;
          s_b[e] = k < n ? p.b[off] : 0.f;
          s_c[e] = k < n ? p.c[off] : 0.f;
        }
        mbar_arrive(bar);                            // releases this lane's stores
      }
    }
    return;
  }

  // consumers: P neighbouring lanes share channel ch, lane-in-channel q owns
  // states k0 .. k0 + NPT - 1
  const int warp = threadIdx.x >> 5;
  const int q = lane & (P - 1);
  const int ch = warp * (32 >> p.lp2) + (lane >> p.lp2);
  const int d = d0 + ch;
  const int k0 = q * NPT;
  const bool own = ch < wd && k0 < n;
  float h[NPT], av[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const bool ok = own && k0 + j < n;
    h[j] = ok ? p.h0[b * p.hb + static_cast<long long>(d) * p.hd + (k0 + j) * p.hn] : 0.f;
    av[j] = ok ? p.a[static_cast<long long>(d) * n + k0 + j] : 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    const int t0 = it * T, rows = min(T, S - t0);
    const unsigned char* st = smem + s * sbytes;
    const float* s_dt = reinterpret_cast<const float*>(st);
    const XT* s_x = reinterpret_cast<const XT*>(st + dt_bytes);
    const float* s_b = reinterpret_cast<const float*>(st + dt_bytes + x_bytes);
    const float* s_c = s_b + T * ns;
    float* yb = ybuf + (it & 1) * T * DC;
    scan_stage<XT, NPT>(s_dt, s_x, s_b, s_c, yb, rows, DC, ns, ch, k0, P, own, av, h);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);       // this warp is done with the stage
    consumer_barrier(CONSUMERS);                     // the stage's y tile is whole
    const long long row0 = static_cast<long long>(b) * S + t0;
    if (wd == DC) {                                  // every block but a ragged last one
      for (int e = threadIdx.x; e < rows * DC; e += CONSUMERS)
        p.y[(row0 + (e >> ldc)) * di + d0 + (e & (DC - 1))] = yb[e];
    } else {
      for (int e = threadIdx.x; e < rows * wd; e += CONSUMERS) {
        const int tt = e / wd, col = e - tt * wd;
        p.y[(row0 + tt) * di + d0 + col] = yb[tt * DC + col];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NPT; ++j)
    if (own && k0 + j < n) p.h[(static_cast<long long>(b) * di + d) * n + k0 + j] = h[j];
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

int log2_threads(int npt, int n) {
  int l = 0;
  while ((npt << l) < n) ++l;                        // P = 2^l threads a channel
  return l;
}



template <typename XT, int NPT, int CW, bool BULK>
int launch_kernel(Args args, int B, cudaStream_t stream) {
  args.lp2 = log2_threads(NPT, args.n);
  const int dc = 32 * CW >> args.lp2;
  args.ns = (args.n + NPT - 1) / NPT * NPT;          // B and C rows padded for whole loads
  const size_t smem = static_cast<size_t>(STAGES) * stage_bytes<XT>(dc, args.ns) +
                      2 * T * dc * 4 + 2 * STAGES * 8;    // the ring, two y tiles, the mbarriers
  auto kernel = ssm_scan_fused_kernel<XT, NPT, CW, BULK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((args.di + dc - 1) / dc, B);
  kernel<<<grid, 32 * (CW + 1), smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, int NPT, int CW>
int launch_cw(Args args, int B, cudaStream_t stream) {
  const int dc = 32 * CW >> log2_threads(NPT, args.n);
  const bool bulk = dc >= 8 && args.di % 8 == 0 && args.n % NPT == 0 &&
                    aligned16(args.dt) && aligned16(args.x) && aligned16(args.b) &&
                    aligned16(args.c);
  return bulk ? launch_kernel<XT, NPT, CW, true>(args, B, stream)
              : launch_kernel<XT, NPT, CW, false>(args, B, stream);
}

// The shapes of a launch (benchmarks/torch_ssm_launch_shapes.py times the
// others on the card):
//  * a scan of fewer than 2 T steps (a decode step) moves h0 and h more than
//    anything else: 4 states a thread, many small blocks;
//  * a longer one holds 8 states a thread (4 at n <= 4), two lanes a channel
//    at Jamba's n = 16, 64 channels a block: the fastest long shape at the
//    serving batch and close to the fastest at a batch of 1 (PERF.md has the
//    times).  16 states a thread, with no shuffle, moved most from one build
//    to the next.
template <typename XT>
int launch(const Args& args, int B, cudaStream_t stream) {
  if (args.S < 2 * T || args.n <= 4) return launch_cw<XT, 4, 4>(args, B, stream);
  return launch_cw<XT, 8, 4>(args, B, stream);
}

}  // namespace

// dt: f32 (B, S, di); x: (B, S, di) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1);
// b, c: f32 (B, S, n); a: f32 (di, n); all contiguous.  h0: f32 (B, di, n)
// through the element strides (hb, hd, hn).  Out: y f32 (B, S, di) and h f32
// (B, di, n), contiguous.  S >= 0, 1 <= n <= 32, 1 <= B <= 65535.
extern "C" int repro_ssm_scan_fused(const void* dt, const void* x, const void* b, const void* c,
                                    const void* a, const void* h0, void* y, void* h, int x_bf16,
                                    int B, int S, int n, int di, long long hb, long long hd,
                                    long long hn, void* stream) {
  if (B <= 0 || B > 65535 || S < 0 || n < 1 || n > 32 || di <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.dt = static_cast<const float*>(dt);
  args.x = x;
  args.b = static_cast<const float*>(b);
  args.c = static_cast<const float*>(c);
  args.a = static_cast<const float*>(a);
  args.h0 = static_cast<const float*>(h0);
  args.y = static_cast<float*>(y);
  args.h = static_cast<float*>(h);
  args.S = S;
  args.n = n;
  args.di = di;
  args.ns = 0;
  args.lp2 = 0;
  args.hb = hb;
  args.hd = hd;
  args.hn = hn;
  auto cs = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<bf16_bits>(args, B, cs) : launch<float>(args, B, cs);
}
