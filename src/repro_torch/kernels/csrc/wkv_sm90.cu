// RWKV-6 WKV recurrence in chunked form on Hopper's tensor cores (sm_90a),
// f32 in and out, every product in 3xTF32.
//
// Replaces the TPU kernel `wkv_pallas` (`_wkv_kernel`, src/repro/kernels/
// wkv.py:28) for S >= 64 and head_dim 16 or 64; every other shape, the
// S = 1 decode step among them, keeps the step kernel of wkv.cu.  Per
// (batch, head), with an hd x hd state S carried over the sequence:
//
//     y_t[e] = sum_d r_t[d] * (S[d,e] + u[d] * k_t[d] * v_t[e])
//     S[d,e] <- exp(logw_t[d]) * S[d,e] + k_t[d] * v_t[e]
//
// Bound: bytes.  r, k, v, logw are read once and y written once (5 x 4 B an
// element), 0.202 ms at rwkv6-1.6b's serving prefill (4, 32, 4096, 64); the
// products are about 3 x 400 flops an element of y in 3xTF32, 0.08 ms at
// 495 TFLOP/s.  The step kernel walks 4096 dependent steps per (batch,
// head) and is held at 8.5x the bytes by that chain's latency.  Here the
// chain is 64 chunks long, and what holds a chunk back is latency too: one
// block of 8 warps an SM (its 225 KB of shared memory allow no second), so
// the CUDA-core phases (cumsums, decay factors, the diagonal blocks) and the
// tensor-core ones take turns.
//
// Design (C = 64 steps a chunk, cut into four sub-chunks of 16):
//  * the chunk's r, k, logw and v land by TMA (4-D tensor maps over the
//    (B, S, H, hd) strides, 64 x cols boxes; rows past S arrive as zeros: a
//    zero logw decays by 1 and a zero k adds nothing, so a ragged last chunk
//    needs no case of its own, and only y rows < S are stored).  The next
//    chunk's boxes are requested as soon as this chunk's CUDA-core phases
//    are done with the stage, and land while its products run;
//  * cumsums of logw, in log2 units, local to each sub-chunk (l inclusive,
//    lx exclusive, T the sub-chunk's total), one thread per (sub-chunk,
//    channel): every decay exponent is a sum of at most 16 steps, and every
//    exp is one ex2;
//  * scores A[t, j] = sum_d r[t,d] k[j,d] 2^(Lx[t,d] - L[j,d]), j < t.  For
//    key sub-chunk a below query sub-chunk b the decay factors through the
//    boundary of b: r~[t] = r[t] 2^lx[t] and k~[j] = k[j] 2^(T_a - l[j])
//    times 2^T_c for each sub-chunk a < c < b.  Every exponent is <= 0, so
//    nothing overflows and underflow is the right limit; the six
//    off-diagonal 16 x 16 blocks are mma.sync m16n8k8 products.  The four
//    diagonal blocks are computed on the CUDA cores in 4 x 4 tiles: below
//    the diagonal tiles the decay factors through the tile edge (8
//    exponentials a channel instead of 16), the diagonal tiles take their 6
//    pairs' decay explicitly and the u bonus on the diagonal;
//  * y = A V + (r 2^Lx) S (warpgroup 0) and S <- diag(2^L_last) S + (k
//    2^(L_last - L))^T V (warpgroup 1, which keeps the state in registers)
//    are wgmma m64nEVk8 products, A from registers, v and the state from
//    shared memory as split K-major operands;
//  * 3xTF32: each f32 operand is split into a TF32 high part and a TF32
//    residual (round to nearest on the bits), and lo*hi + hi*lo + hi*hi are
//    summed in f32, the residual products in accumulators of their own.  One
//    TF32 product keeps about three digits; rwkv6's logits amplify them
//    beyond the 1e-4 the kernel is held to;
//  * the state's value columns are independent, so a block owns EV of them
//    (64, 32 or 16; the wrapper picks EV so that about 128 blocks are in
//    flight); the scores are recomputed by every column block;
//  * y is written with the inputs' strides, so the model's (B, S, H, hd)
//    tensors are read and written where they lie.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;        // steps a chunk
constexpr int SUB = 16;      // steps a sub-chunk
constexpr int NSUB = C / SUB;
constexpr int NT = 256;      // threads a block

template <int D, int EV>
struct Layout {
  static constexpr int LDD = D + 4;      // [t][d] rows: conflict-free fragment loads
  static constexpr int LDK4 = D + 8;     // k~ of the state update, read transposed
  static constexpr int LDA = C + 4;      // scores [t][j]
  // the TMA stage, dense rows as the copy engine writes them: r, k, logw, v
  static constexpr int R = 0, K = R + C * D, L = K + C * D, VS = L + C * D;
  // v and the state as wgmma B operands: TF32 high and low parts, K-major
  // 8 x 4 core matrices (see core_index)
  static constexpr int VTH = VS + C * EV, VTL = VTH + C * EV;
  static constexpr int RT = VTL + C * EV;                // r~
  static constexpr int Q = RT + C * LDD;                 // r exp(Lx)
  static constexpr int KV = Q + C * LDD;                 // k~ for query sub-chunks 1..3: 16b rows each
  static constexpr int K4 = KV + 8 * NSUB * (NSUB - 1) * LDD;
  static constexpr int A = K4 + C * LDK4;
  static constexpr int STH = A + C * LDA, STL = STH + D * EV;
  static constexpr int T = STL + D * EV;                 // sub-chunk totals
  static constexpr int ET = T + NSUB * D;                // exp2 of the totals
  static constexpr int U = ET + NSUB * D;
  static constexpr int FLOATS = U + D;
  __host__ __device__ static constexpr int kver(int b) { return KV + 8 * b * (b - 1) * LDD; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
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

// wait for the phase of parity `parity`; 2^35 cycles (about 17 s) means a
// lost arrival, and traps instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// one box of a 4-D tensor map into shared memory, completed on the mbarrier
// at `bar`; coordinates (column, head, time, batch), zeros past the tensor
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int t, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(t), "r"(batch)
      : "memory");
}

// x as a TF32 high part and a TF32 residual, each rounded to nearest (ties
// away from zero, as cvt.rna) by integer operations on the bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// 2^x in one instruction (relative error about 2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// element (k, n) of a K-major wgmma B operand with N = n_cols: 8 x 4 core
// matrices of 128 bytes, N-adjacent ones 128 bytes apart, K-adjacent ones
// n_cols * 16 bytes apart (the descriptor's stride and leading offsets)
__device__ __forceinline__ int core_index(int k, int n, int n_cols) {
  return (k / 4) * (n_cols * 4) + (n / 8) * 32 + (n % 8) * 4 + k % 4;
}

// descriptor of a K-major operand without swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving registers that an asynchronous product reads
// or writes across it
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// D(64 x N, f32) += A(64 x 8, TF32 in registers: the m16n8k8 A fragment of
// each warp's 16 rows) * B(8 x N, TF32, shared memory, K-major)
template <int N>
__device__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// fragments of m16n8k8 (g = lane / 4, c = lane % 4): A 16 x 8 at p
__device__ __forceinline__ void frag_a(float (&a)[4], const float* p, int ld, int g, int c) {
  a[0] = p[g * ld + c]; a[1] = p[(g + 8) * ld + c];
  a[2] = p[g * ld + c + 4]; a[3] = p[(g + 8) * ld + c + 4];
}
// A stored transposed: A[m][k] = p[k * ld + m]
__device__ __forceinline__ void frag_a_t(float (&a)[4], const float* p, int ld, int g, int c) {
  a[0] = p[c * ld + g]; a[1] = p[c * ld + g + 8];
  a[2] = p[(c + 4) * ld + g]; a[3] = p[(c + 4) * ld + g + 8];
}
// B 8 x 8 stored [n][k]
__device__ __forceinline__ void frag_b_nk(float (&b)[2], const float* p, int ld, int g, int c) {
  b[0] = p[g * ld + c]; b[1] = p[g * ld + c + 4];
}

template <int D, int EV>
__global__ void __launch_bounds__(NT, 1)
wkv_chunked_kernel(const __grid_constant__ CUtensorMap tm_r, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_v,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   float* __restrict__ y, float* __restrict__ s_out,
                   int H, int S, long long sb, long long sh, long long st) {
  using Ly = Layout<D, EV>;
  constexpr int LDS = D;                                   // rows of the stage
  constexpr int LDD = Ly::LDD, LDA = Ly::LDA, LDK4 = Ly::LDK4;
  constexpr int KB = 2 * EV * 16;          // bytes of a wgmma B operand per 8 steps along k
  // where the registers allow it (EV <= 32): the two residual products in
  // chains of their own, and y stored through shared memory as whole rows.
  // At EV 64 either spills
  constexpr bool kRoomy = EV <= 32;
  extern __shared__ __align__(16) float smem_raw[];
  // TMA writes to 128-byte aligned shared memory
  float* sm = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* sr = sm + Ly::R;
  float* sk = sm + Ly::K;
  float* sl = sm + Ly::L;
  float* srt = sm + Ly::RT;
  float* sq = sm + Ly::Q;
  float* sk4 = sm + Ly::K4;
  float* sa = sm + Ly::A;
  float* sT = sm + Ly::T;
  float* seT = sm + Ly::ET;
  float* su = sm + Ly::U;
  float* vth = sm + Ly::VTH;
  float* vtl = sm + Ly::VTL;
  float* sth = sm + Ly::STH;
  float* stl = sm + Ly::STL;

  const int bh = blockIdx.x, b = bh / H, h = bh % H, e0 = blockIdx.y * EV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c4 = lane % 4;
  const long long base = static_cast<long long>(b) * sb + static_cast<long long>(h) * sh;
  const int nchunks = (S + C - 1) / C;

  // completes when a chunk's four boxes have landed
  __shared__ __align__(8) uint64_t full_bar;
  const uint32_t full = smem_addr(&full_bar);
  auto load = [&](int ci) {
    mbar_expect_tx(full, static_cast<uint32_t>(C * (3 * D + EV) * 4));
    tma_load(smem_addr(sm + Ly::R), &tm_r, full, 0, h, ci * C, b);
    tma_load(smem_addr(sm + Ly::K), &tm_k, full, 0, h, ci * C, b);
    tma_load(smem_addr(sm + Ly::L), &tm_w, full, 0, h, ci * C, b);
    tma_load(smem_addr(sm + Ly::VS), &tm_v, full, e0, h, ci * C, b);
  };
  if (tid == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load(0);
  }
  __syncthreads();                       // the barrier is initialised before anyone waits
  for (int i = tid; i < C * LDA; i += NT) sa[i] = 0.0f;   // blocks above the diagonal stay 0
  if (tid < D) su[tid] = u[h * D + tid];
  // warpgroup 1 keeps the state's EV columns in the accumulator layout of
  // the state update: rows d0 = 16 w1 + g and d0 + 8 (those below D)
  const int w1 = warp - 4, d0 = 16 * w1 + g;
  const bool state_rows = warp >= 4 && 16 * w1 < D;
  float sst[EV / 2] = {};
  // the state, split for wgmma, into sth / stl (warpgroup 1)
  auto put_state = [&]() {
#pragma unroll
    for (int i = 0; i < EV / 8; ++i)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        uint32_t hi, lo;
        split(sst[4 * i + x], hi, lo);
        const int at = core_index(d0 + (x / 2) * 8, 8 * i + 2 * c4 + (x % 2), EV);
        sth[at] = __uint_as_float(hi);
        stl[at] = __uint_as_float(lo);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  if (state_rows) {
    const float* s0p = s0 + static_cast<long long>(bh) * D * D;
#pragma unroll
    for (int i = 0; i < EV / 8; ++i)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        sst[4 * i + x] = s0p[(d0 + (x / 2) * 8) * D + e0 + 8 * i + 2 * c4 + (x % 2)];
    put_state();
  }

  for (int ci = 0; ci < nchunks; ++ci) {
    mbar_wait(full, ci & 1);
    __syncthreads();

    // one thread a (sub-chunk ca, channel cd): the cumsum of logw in log2
    // units, local to the sub-chunk, kept in registers and in place of logw
    // (for the diagonal tiles); the sub-chunk's total and its exp2
    const bool col = tid < NSUB * D;
    const int ca = tid / D, cd = tid % D;
    float l2[SUB];
    if (col) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        float* p = sl + (ca * SUB + i) * LDS + cd;
        acc = __fadd_rn(acc, __fmul_rn(*p, LOG2E));
        *p = acc;
        l2[i] = acc;
      }
      sT[ca * D + cd] = acc;
      seT[ca * D + cd] = ex2(acc);
    }
    __syncthreads();

    // r~ = r 2^lx, q = r~ times the decay of the sub-chunks before, and k~
    // for each query sub-chunk above its own and for the state update
    // v, split, as the wgmma B operand: element i of the core-matrix layout
    // (a warp writes whole core matrices, one 4-byte word a lane)
    for (int i = tid; i < C * EV; i += NT) {
      const int cm = i / 32, q = i % 32;
      const int j = (cm / (EV / 8)) * 4 + q % 4, e = (cm % (EV / 8)) * 8 + q / 4;
      uint32_t hi, lo;
      split(sm[Ly::VS + j * EV + e], hi, lo);
      vth[i] = __uint_as_float(hi);
      vtl[i] = __uint_as_float(lo);
    }
    if (col) {
      float eT[NSUB];
#pragma unroll
      for (int cc = 0; cc < NSUB; ++cc) eT[cc] = seT[cc * D + cd];
      float ep = 1.0f;
#pragma unroll
      for (int cc = 0; cc < NSUB; ++cc)
        if (cc < ca) ep *= eT[cc];
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const int t = ca * SUB + i;
        const float rt = sr[t * LDS + cd] * ex2(i ? l2[i - 1] : 0.0f);
        srt[t * LDD + cd] = rt;
        sq[t * LDD + cd] = rt * ep;
        float f = sk[t * LDS + cd] * ex2(fminf(l2[SUB - 1] - l2[i], 0.0f));
#pragma unroll
        for (int bb = 1; bb < NSUB; ++bb)
          if (bb > ca) {
            sm[Ly::kver(bb) + t * LDD + cd] = f;
            f *= eT[bb];
          }
        sk4[t * LDK4 + cd] = f;
      }
    }

    // the four diagonal 16 x 16 blocks of the scores, in 4 x 4 tiles.  The
    // 24 tiles below the diagonal tiles (warps 0-5, eight lanes a tile, the
    // channels d = 8 i + lane split among them) factor the decay through
    // the tile edge; the 16 diagonal tiles (warps 6-7, four lanes a tile)
    // take each pair's decay and the u bonus.  The lanes of a tile meet by
    // xor shuffles
    {
      const bool off = warp < 6;
      const int nq = off ? 8 : 4, qq = lane % nq;
      const int tile = off ? tid / 8 : (tid - 192) / 4;
      const int sbk = off ? tile / 6 : tile / 4, o = tile % 6;
      const int ti = off ? (o < 1 ? 1 : o < 3 ? 2 : 3) : tile % 4;
      const int tj = off ? o - ti * (ti - 1) / 2 : ti;
      const int t0 = sbk * SUB + 4 * ti, j0 = sbk * SUB + 4 * tj;
      float acc[4][4] = {};
      if (off) {
#pragma unroll 2
        for (int ii = 0; ii < D / 8; ++ii) {
          const int d = 8 * ((ii + tile) % (D / 8)) + qq;   // tiles of a warp on other banks
          const float ref = sl[(j0 + 3) * LDS + d];
          float rx[4], ky[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            rx[x] = sr[(t0 + x) * LDS + d] * ex2(fminf(sl[(t0 + x - 1) * LDS + d] - ref, 0.0f));
            ky[x] = sk[(j0 + x) * LDS + d] * ex2(fminf(ref - sl[(j0 + x) * LDS + d], 0.0f));
          }
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int yy = 0; yy < 4; ++yy) acc[x][yy] = fmaf(rx[x], ky[yy], acc[x][yy]);
        }
      } else {
#pragma unroll 2
        for (int ii = 0; ii < D / 4; ++ii) {
          const int d = 4 * ((ii + tile) % (D / 4)) + qq;
          float rx[4], kx[4], lx[4], lj[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int t = t0 + x;
            rx[x] = sr[t * LDS + d];
            kx[x] = sk[t * LDS + d];
            lj[x] = sl[t * LDS + d];
            lx[x] = (t % SUB) ? sl[(t - 1) * LDS + d] : 0.0f;
          }
          const float ud = su[d];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
#pragma unroll
            for (int yy = 0; yy < x; ++yy)
              acc[x][yy] = fmaf(rx[x] * kx[yy], ex2(fminf(lx[x] - lj[yy], 0.0f)), acc[x][yy]);
            acc[x][x] = fmaf(rx[x] * ud, kx[x], acc[x][x]);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int yy = 0; yy < 4; ++yy) {
          float a = acc[x][yy];
          a += __shfl_xor_sync(0xffffffffu, a, 1);
          a += __shfl_xor_sync(0xffffffffu, a, 2);
          if (off) a += __shfl_xor_sync(0xffffffffu, a, 4);
          acc[x][yy] = a;
        }
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (x == qq) {
#pragma unroll
          for (int yy = 0; yy < 4; ++yy)
            sa[(t0 + x) * LDA + j0 + yy] = (off || yy <= x) ? acc[x][yy] : 0.0f;
        }
    }
    // the stage's generic reads and writes before the copy engine's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && ci + 1 < nchunks) load(ci + 1);   // lands while this chunk's products run

    // off-diagonal score blocks (b, a < b), one 16 x 16 block a warp:
    // r~_b k~_b^T, k~ stored [j][d] (B as [n][k])
    if (warp < 6) {
      const int qb = warp < 1 ? 1 : warp < 3 ? 2 : 3, ka = warp - qb * (qb - 1) / 2;
      const float* pa = srt + qb * SUB * LDD;
      const float* pb = sm + Ly::kver(qb) + ka * SUB * LDD;
      float hi[2][4] = {}, lo[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        float fa[4];
        frag_a(fa, pa + ks * 8, LDD, g, c4);
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(fa[i], ah[i], al[i]);
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
          float fb[2];
          frag_b_nk(fb, pb + nh * 8 * LDD + ks * 8, LDD, g, c4);
          uint32_t bh2[2], bl2[2];
          split(fb[0], bh2[0], bl2[0]);
          split(fb[1], bh2[1], bl2[1]);
          mma_tf32(lo[nh], al, bh2);
          mma_tf32(lo[nh], ah, bl2);
          mma_tf32(hi[nh], ah, bh2);
        }
      }
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        float* o = sa + (qb * SUB + g) * LDA + ka * SUB + nh * 8 + 2 * c4;
        o[0] = hi[nh][0] + lo[nh][0]; o[1] = hi[nh][1] + lo[nh][1];
        o[8 * LDA] = hi[nh][2] + lo[nh][2]; o[8 * LDA + 1] = hi[nh][3] + lo[nh][3];
      }
    }
    __syncthreads();

    if (warp < 4) {
      // warpgroup 0: y = A V + q S, 64 x EV, on wgmma in 3xTF32: hi += ah
      // bh, lo += al bh + ah bl.  The A fragments (rows 16 warp ..) come from
      // registers in two sets, so that one step's split overlaps the
      // products of the step before
      constexpr int KS = C / 8 + D / 8;
      float hi[EV / 2] = {}, lo[EV / 2] = {}, lo2[EV / 2] = {};
      uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll
      for (int kg = 0; kg < KS / 2; ++kg) {
        const int bf = kg & 1;
        if (kg >= 2) wgmma_wait<1>();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int ks = 2 * kg + kk;
          float fa[4];
          if (ks < C / 8) frag_a(fa, sa + warp * 16 * LDA + ks * 8, LDA, g, c4);
          else frag_a(fa, sq + warp * 16 * LDD + (ks - C / 8) * 8, LDD, g, c4);
#pragma unroll
          for (int x = 0; x < 4; ++x) split(fa[x], ah[bf][kk][x], al[bf][kk][x]);
          pin(ah[bf][kk]);
          pin(al[bf][kk]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int ks = 2 * kg + kk;
          const uint32_t bh_addr = ks < C / 8 ? smem_addr(vth) + ks * KB : smem_addr(sth) + (ks - C / 8) * KB;
          const uint32_t bl_addr = ks < C / 8 ? smem_addr(vtl) + ks * KB : smem_addr(stl) + (ks - C / 8) * KB;
          const uint64_t dh = desc_kmajor(bh_addr, EV * 16, 128), dl = desc_kmajor(bl_addr, EV * 16, 128);
          wgmma_tf32<EV>(hi, ah[bf][kk], dh, 1);
          wgmma_tf32<EV>(lo, al[bf][kk], dh, 1);
          if constexpr (kRoomy) wgmma_tf32<EV>(lo2, ah[bf][kk], dl, 1);
          else wgmma_tf32<EV>(lo, ah[bf][kk], dl, 1);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      pin(hi);
      pin(lo);
      if constexpr (kRoomy) pin(lo2);
      pin(ah[0][0]); pin(ah[0][1]); pin(ah[1][0]); pin(ah[1][1]);
      pin(al[0][0]); pin(al[0][1]); pin(al[1][0]); pin(al[1][1]);
      if constexpr (kRoomy) {
        // y through the warp's own 16 rows of sq (read only by this warp,
        // and rewritten next chunk), then 16-byte stores of whole rows
        float* stage = sq + warp * 16 * LDD;
#pragma unroll
        for (int i = 0; i < EV / 8; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int x = 4 * i + 2 * half;
            *reinterpret_cast<float2*>(stage + (g + 8 * half) * LDD + 8 * i + 2 * c4) =
                make_float2(hi[x] + (lo[x] + lo2[x]), hi[x + 1] + (lo[x + 1] + lo2[x + 1]));
          }
        __syncwarp();
#pragma unroll
        for (int i = lane; i < 16 * EV / 4; i += 32) {
          const int row = i / (EV / 4), col = (i % (EV / 4)) * 4;
          const long long t = static_cast<long long>(ci) * C + warp * 16 + row;
          if (t < S)
            *reinterpret_cast<float4*>(y + base + t * st + e0 + col) =
                *reinterpret_cast<const float4*>(stage + row * LDD + col);
        }
      } else {
        const long long t = static_cast<long long>(ci) * C + warp * 16 + g;
#pragma unroll
        for (int i = 0; i < EV / 8; ++i) {
          float* o = y + base + t * st + e0 + 8 * i + 2 * c4;
          if (t < S) { o[0] = hi[4 * i] + lo[4 * i]; o[1] = hi[4 * i + 1] + lo[4 * i + 1]; }
          if (t + 8 < S) { o[8 * st] = hi[4 * i + 2] + lo[4 * i + 2]; o[8 * st + 1] = hi[4 * i + 3] + lo[4 * i + 3]; }
        }
      }
    } else {
      // warpgroup 1: S <- diag(2^L_last) S + k4^T V, 64 (D) x EV; rows of
      // k4^T past D are zeros (hd 16)
      if (state_rows) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = d0 + half * 8;
          float dec = 1.0f;
#pragma unroll
          for (int cc = 0; cc < NSUB; ++cc) dec *= seT[cc * D + d];
#pragma unroll
          for (int i = 0; i < EV / 8; ++i) {
            sst[4 * i + 2 * half] *= dec;
            sst[4 * i + 2 * half + 1] *= dec;
          }
        }
      }
      float lo[EV / 2] = {}, lo2[EV / 2] = {};
      uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll
      for (int kg = 0; kg < C / 16; ++kg) {
        const int bf = kg & 1;
        if (kg >= 2) wgmma_wait<1>();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int ks = 2 * kg + kk;
          float fa[4] = {};
          if (state_rows) frag_a_t(fa, sk4 + ks * 8 * LDK4 + 16 * w1, LDK4, g, c4);
#pragma unroll
          for (int x = 0; x < 4; ++x) split(fa[x], ah[bf][kk][x], al[bf][kk][x]);
          pin(ah[bf][kk]);
          pin(al[bf][kk]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int ks = 2 * kg + kk;
          const uint64_t dh = desc_kmajor(smem_addr(vth) + ks * KB, EV * 16, 128);
          const uint64_t dl = desc_kmajor(smem_addr(vtl) + ks * KB, EV * 16, 128);
          wgmma_tf32<EV>(sst, ah[bf][kk], dh, 1);
          wgmma_tf32<EV>(lo, al[bf][kk], dh, 1);
          if constexpr (kRoomy) wgmma_tf32<EV>(lo2, ah[bf][kk], dl, 1);
          else wgmma_tf32<EV>(lo, ah[bf][kk], dl, 1);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      pin(sst);
      pin(lo);
      if constexpr (kRoomy) pin(lo2);
      pin(ah[0][0]); pin(ah[0][1]); pin(ah[1][0]); pin(ah[1][1]);
      pin(al[0][0]); pin(al[0][1]); pin(al[1][0]); pin(al[1][1]);
#pragma unroll
      for (int x = 0; x < EV / 2; ++x) sst[x] += lo[x] + lo2[x];
    }
    __syncthreads();                      // every read of the old state is done
    if (state_rows) put_state();
  }

  if (state_rows) {
    float* so = s_out + static_cast<long long>(bh) * D * D;
#pragma unroll
    for (int i = 0; i < EV / 8; ++i)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        so[(d0 + (x / 2) * 8) * D + e0 + 8 * i + 2 * c4 + (x % 2)] = sst[4 * i + x];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point query: no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// (B, H, S, hd) f32 through its strides (in elements; unit stride along hd),
// read in boxes of 64 time steps x `cols` columns of one (batch, head); rows
// past S arrive as zeros
bool make_map(CUtensorMap* map, const void* base, int B, int H, int S, int hd, int cols,
              long long sb, long long sh, long long st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 4, static_cast<cuuint64_t>(st) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, C, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int EV>
int launch(const void* r, const void* k, const void* v, const void* logw, const float* u,
           const float* s0, float* y, float* s_out, int B, int H, int S, long long sb,
           long long sh, long long st, cudaStream_t stream) {
  CUtensorMap mr, mk, mw, mv;
  if (!make_map(&mr, r, B, H, S, D, D, sb, sh, st) || !make_map(&mk, k, B, H, S, D, D, sb, sh, st) ||
      !make_map(&mw, logw, B, H, S, D, D, sb, sh, st) || !make_map(&mv, v, B, H, S, D, EV, sb, sh, st))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Layout<D, EV>::FLOATS * static_cast<int>(sizeof(float)) + 128;
  cudaError_t err = cudaFuncSetAttribute(wkv_chunked_kernel<D, EV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H), D / EV);
  wkv_chunked_kernel<D, EV><<<grid, NT, smem, stream>>>(mr, mk, mw, mv, u, s0, y, s_out, H, S,
                                                        sb, sh, st);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// hd 16 or 64; ev (the value columns a block owns) 16, 32 or 64 and at most
// hd; strides in elements, multiples of 4, and r, k, v, logw 16-byte
// aligned (as TMA needs); y has the inputs' strides.
extern "C" int repro_wkv_chunked_f32(const void* r, const void* k, const void* v,
                                     const void* logw, const void* u, const void* s0, void* y,
                                     void* s_out, int B, int H, int S, int hd, int ev,
                                     long long sb, long long sh, long long st, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || sb % 4 || sh % 4 || st % 4 || !aligned16(r) ||
      !aligned16(k) || !aligned16(v) || !aligned16(logw))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* up = static_cast<const float*>(u);
  const auto* sp = static_cast<const float*>(s0);
  auto* yp = static_cast<float*>(y);
  auto* op = static_cast<float*>(s_out);
  auto cs = static_cast<cudaStream_t>(stream);
  if (hd == 64 && ev == 64) return launch<64, 64>(r, k, v, logw, up, sp, yp, op, B, H, S, sb, sh, st, cs);
  if (hd == 64 && ev == 32) return launch<64, 32>(r, k, v, logw, up, sp, yp, op, B, H, S, sb, sh, st, cs);
  if (hd == 64 && ev == 16) return launch<64, 16>(r, k, v, logw, up, sp, yp, op, B, H, S, sb, sh, st, cs);
  if (hd == 16 && ev == 16) return launch<16, 16>(r, k, v, logw, up, sp, yp, op, B, H, S, sb, sh, st, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}
