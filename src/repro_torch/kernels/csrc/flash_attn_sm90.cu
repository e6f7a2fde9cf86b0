// Flash attention forward, bf16, on Hopper's tensor cores (sm_90a): causal
// or full online-softmax attention with grouped-query heads, bf16 in and
// out, f32 running max, denominator and accumulator.
//
// Replaces the TPU kernel `flash_attention_pallas` (`_flash_kernel`,
// src/repro/kernels/flash_attn.py:84) for bf16 inputs; float32 inputs keep
// the CUDA-core kernel of flash_attn.cu.  On the tensor cores f32 would run
// as TF32 (about three decimal digits), which would void the float32 model
// checks (rel L2 <= 1e-3) that exist to catch a kernel fault under bf16 noise.
//
// Bound: operations.  Causal work is 4 * hd * BH * S (S + 1) / 2 flops (two
// products over the causal triangle) against 4 * BH * S * hd * 2 bytes
// moved; at S = 4096 that is about 1,000 flops a byte, far above the card's
// ridge of 295, so the bound is flops / 989 TFLOP/s (dense bf16).  The kernel
// computes whole 128 x 128 tiles, so the masked half of each diagonal tile
// is work above that count: about 128 / S of it, 3.1 % at S = 4096.
//
// Design:
//  * a block owns 128 query rows of one (batch*head): two consumer
//    warpgroups of 64 rows each, and a producer warpgroup of which one
//    thread loads Q once and then K and V tiles of 128 rows with TMA into a
//    ring of two stages, each completed on an mbarrier, so the next tile's
//    load overlaps this tile's products; consumers release a stage on an
//    "empty" mbarrier.  TMA rather than cp.async: it zero-fills the padded
//    columns and the rows past Sq or Skv for free and costs the consumers no
//    registers.  setmaxnreg gives the producer 40 registers a thread and
//    each consumer 232 (hd 128 spills at the 168 a thread of 384 gets);
//  * S = Q K^T is one `wgmma` m64n128k16 per 16 columns of hd, Q and K both
//    read from shared memory (K-major, 128-byte swizzle).  The scale
//    1/sqrt(hd) is applied to S in f32 after the product (not to Q before
//    rounding it), folded with log2(e) into one FMA before `ex2`;
//  * the online softmax runs on the accumulator fragments: a thread holds
//    two rows, a row lives in four lanes, so row max and row sum are two
//    xor-shuffles.  P is rounded to bf16 in registers and the S fragment of
//    16 keys is exactly the A fragment of the second product, so nothing of
//    S or P goes through shared memory;
//  * O += P V is `wgmma` m64nNVk16 with A from registers and V read from
//    shared memory in its natural (keys, hd) layout through the B-transpose
//    bit (MN-major, 128-byte swizzle);
//  * causal: no key tile wholly above the diagonal is visited, only tiles
//    that cross it (or run past Skv) are masked, and heavy (late) query tiles
//    are scheduled first;
//  * blocks are ordered in groups of 4 heads (each group's query tiles
//    heavy-first over its heads), so the blocks in flight read the K and V
//    of a few heads, which stay in the 50 MB L2.  Ordering all heads of a
//    tile together made the 132 blocks in flight read 128 heads' K and V
//    (168 MB at stablelm-3b's prefill) and re-fetch them for every tile;
//  * grouped-query heads by index arithmetic: query row b reads key/value
//    row (b / Hq) * Hkv + (b % Hq) / g, a TMA coordinate; no repeat;
//  * hd: a 128-byte swizzle atom holds 64 bf16 columns, so Q, K and V are
//    kept as panels of 64 columns and TMA fills the columns past hd with
//    zeros.  NV is hd rounded up to 64, 80, 96 or 128: the first product
//    takes NV / 16 steps of 16 columns, the second has N = NV.  At hd 80 the
//    shared-memory rows are padded to 128 (48 zero columns that TMA writes
//    but never reads from device memory) and both products run at 80, no
//    padded operations (60 % more in the second product at N = 128, which
//    chip_smoke.py [2c] times beside it).  hd 72 runs at 80 (11 % more
//    operations), hd 32 at 64 (2x);
//  * tried and dropped: issuing S of tile j + 1 ahead of P V of tile j, to
//    overlap one warpgroup's softmax with its own second product.  ptxas
//    serialised the products (warning C7514) and it ran slower; the two
//    consumer warpgroups overlap each other's softmax and products instead.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                  // query rows a block: two warpgroups of 64
constexpr int BN = 128;                  // key/value rows a stage
constexpr int STAGES = 2;
constexpr int PANEL = 64;                // bf16 columns in one 128-byte swizzle row
constexpr int HEAD_GROUP = 4;            // heads whose query tiles are scheduled together
constexpr int ROW_BYTES = 128;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128; // and a producer warpgroup (one thread loads)
constexpr int PRODUCER_REGS = 40;        // registers a thread after setmaxnreg:
constexpr int CONSUMER_REGS = 232;       //   128 x 40 + 256 x 232 = 64,512 of 65,536
constexpr float LOG2E = 1.4426950408889634f;

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

// wait for the phase of parity `parity` to complete; a wait of 2^35 cycles
// (about 17 s) means a lost arrival, and traps instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// one box of a 3-D tensor map (columns, rows, heads) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int NV>
__device__ void wgmma_rs(float (&d)[NV / 2], const uint32_t (&a)[4], uint64_t db);

// D(64 x 128, f32) (+)= A(64 x 16, smem) * B(128 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64, f32) += A(64 x 16, registers) * B(16 x 64, smem, MN-major)
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 80, f32) += A(64 x 16, registers) * B(16 x 80, smem, MN-major)
template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 96, f32) += A(64 x 16, registers) * B(16 x 96, smem, MN-major)
template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, f32) += A(64 x 16, registers) * B(16 x 128, smem, MN-major)
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// a thread's place in the accumulator fragments (rows r0 and r0 + 8,
// columns c0, c0 + 1 of every 8) and the running max and partial row sums
// of its two rows
struct Rows {
  int r0, c0;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
};

// S = Q K^T (raw, unscaled), 64 x BN for one warpgroup, over KS steps of 16
// columns; issued and committed
template <int KS>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t qa, uint32_t kb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t off = (kk & 3) * 32;               // 16 columns = 32 bytes into the row
    wgmma_ss_n128(sc, desc_sw128(qa + (kk >> 2) * (BM * ROW_BYTES) + off, 16, 1024),
                  desc_sw128(kb + (kk >> 2) * (BN * ROW_BYTES) + off, 16, 1024), kk);
  }
  wgmma_commit();
}

// O += P V, 16 keys a step; V rows of 128 bytes, panels BN * 128 bytes
// apart; issued and committed
template <int NV>
__device__ __forceinline__ void issue_pv(float (&acc)[NV / 2], const uint32_t (&pf)[BN / 4],
                                         uint32_t vb) {
  wgmma_fence();
  pin(acc);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
    wgmma_rs<NV>(acc, a, desc_sw128(vb + kk * 16 * ROW_BYTES, BN * ROW_BYTES, 1024));
  }
  wgmma_commit();
}

// the online softmax of one key tile starting at key k0, in place: S
// becomes P = exp(scale (S - running max)) in f32; corr0 and corr1 are the
// factors for what the two rows accumulated before (0 at the first tile)
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], Rows& r, bool mask,
                                               int causal, int k0, int Skv, float sl2,
                                               float& corr0, float& corr1) {
  if (mask) {
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * c + r.c0 + (e & 1);
        const int row = r.r0 + 8 * (e >> 1);
        if ((causal && col > row) || col >= Skv) sc[4 * c + e] = -INFINITY;
      }
  }
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float ms0 = mx0 * sl2, ms1 = mx1 * sl2;
  corr0 = ex2(r.m0 * sl2 - ms0);
  corr1 = ex2(r.m1 * sl2 - ms1);
  r.m0 = mx0;
  r.m1 = mx1;
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    sc[4 * c] = ex2(fmaf(sc[4 * c], sl2, -ms0));
    sc[4 * c + 1] = ex2(fmaf(sc[4 * c + 1], sl2, -ms0));
    sc[4 * c + 2] = ex2(fmaf(sc[4 * c + 2], sl2, -ms1));
    sc[4 * c + 3] = ex2(fmaf(sc[4 * c + 3], sl2, -ms1));
    rs0 += sc[4 * c] + sc[4 * c + 1];
    rs1 += sc[4 * c + 2] + sc[4 * c + 3];
  }
  r.l0 = r.l0 * corr0 + rs0;     // partial: the four lanes of a row add up at the end
  r.l1 = r.l1 * corr1 + rs1;
}

template <int NV>
__device__ __forceinline__ void rescale(float (&acc)[NV / 2], float corr0, float corr1) {
#pragma unroll
  for (int c = 0; c < NV / 8; ++c) {
    acc[4 * c] *= corr0;
    acc[4 * c + 1] *= corr0;
    acc[4 * c + 2] *= corr1;
    acc[4 * c + 3] *= corr1;
  }
}

// P rounded to bf16: the S fragment of 16 keys is the A fragment of P V
__device__ __forceinline__ void to_bf16(const float (&p)[BN / 2], uint32_t (&pf)[BN / 4]) {
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) pf[i] = pack_bf16(p[2 * i], p[2 * i + 1]);
}

// NV: N of the second product (hd rounded up); NP: 64-column panels of a row
template <int NV, int NP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int BH,
               int Sq, int Skv, int hd, int n_heads, int n_kv_heads, int causal, float scale) {
  constexpr uint32_t Q_BYTES = NP * BM * ROW_BYTES;
  constexpr uint32_t TILE_BYTES = NP * BN * ROW_BYTES;      // K or V, one stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms: 1024-aligned
  const uint32_t sk = sq + Q_BYTES;
  const uint32_t sv = sk + STAGES * TILE_BYTES;
  const uint32_t bar_q = sv + STAGES * TILE_BYTES;
  const uint32_t bar_k = bar_q + 8;                          // + 8 s: K of stage s landed
  const uint32_t bar_v = bar_k + 8 * STAGES;                 // + 8 s: V of stage s landed
  const uint32_t bar_e = bar_v + 8 * STAGES;                 // + 8 s: stage s released

  // blocks walk groups of HEAD_GROUP heads; inside a group query tiles go
  // tile-major over its heads, the longest first when causal, so the K and V
  // that the blocks in flight read stay in L2
  const int n_qt = (Sq + BM - 1) / BM;
  const int grp = blockIdx.x / (HEAD_GROUP * n_qt);
  const int in_grp = min(HEAD_GROUP, BH - grp * HEAD_GROUP);
  const int rem = blockIdx.x - grp * HEAD_GROUP * n_qt;
  const int t = rem / in_grp;
  const int bh = grp * HEAD_GROUP + (rem - t * in_grp);
  const int q0 = (causal ? n_qt - 1 - t : t) * BM;
  const int g = n_heads / n_kv_heads;
  const int kvh = (bh / n_heads) * n_kv_heads + (bh % n_heads) / g;
  int n_kv = (Skv + BN - 1) / BN;
  if (causal) {                 // tiles that hold a key <= the block's last query
    const int last = min(q0 + BM, Sq) - 1;
    n_kv = min(n_kv, last / BN + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {        // the producer warpgroup; one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(bar_q, Q_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_load(sq + p * BM * ROW_BYTES, &tm_q, bar_q, p * PANEL, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_e + 8 * s, ((j / STAGES) - 1) & 1);
        mbar_expect_tx(bar_k + 8 * s, TILE_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(sk + s * TILE_BYTES + p * BN * ROW_BYTES, &tm_k, bar_k + 8 * s, p * PANEL,
                   j * BN, kvh);
        mbar_expect_tx(bar_v + 8 * s, TILE_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(sv + s * TILE_BYTES + p * BN * ROW_BYTES, &tm_v, bar_v + 8 * s, p * PANEL,
                   j * BN, kvh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; a thread
  // holds rows r0 and r0 + 8 of the accumulator fragments
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  Rows rows;
  rows.r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  rows.c0 = 2 * (lane & 3);
  const int first_row = q0 + wg * 64;
  const float sl2 = scale * LOG2E;
  const uint32_t qa = sq + wg * 64 * ROW_BYTES;

  float acc[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.0f;
  float sc[BN / 2];
  uint32_t pf[BN / 4];
  float corr0, corr1;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    mbar_wait(bar_k + 8 * s, parity);
    issue_qk<NV / 16>(sc, qa, sk + s * TILE_BYTES);
    pin(sc);
    wgmma_wait_all();
    pin(sc);
    // the diagonal tile and a tile running past Skv are masked.  Every tile
    // visited holds key k0 <= q0 <= every row of the block (BN == BM), and
    // tile 0 holds key 0, so a row's running max is finite from j = 0 on
    const int k0 = j * BN;
    const bool mask = (causal && k0 + BN - 1 > first_row) || k0 + BN > Skv;
    online_softmax(sc, rows, mask, causal, k0, Skv, sl2, corr0, corr1);
    rescale<NV>(acc, corr0, corr1);
    to_bf16(sc, pf);
    mbar_wait(bar_v + 8 * s, parity);
    issue_pv<NV>(acc, pf, sv + s * TILE_BYTES);
    pin(acc);
    wgmma_wait_all();
    pin(acc);
    mbar_arrive(bar_e + 8 * s);
  }

  float l0 = rows.l0, l1 = rows.l1;
  const int r0 = rows.r0, c0 = rows.c0;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  __nv_bfloat16* op = o + static_cast<size_t>(bh) * Sq * hd;
#pragma unroll
  for (int c = 0; c < NV / 8; ++c) {
    const int col = 8 * c + c0;
    if (col < hd) {
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(r0) * hd + col) =
            pack_bf16(acc[4 * c] * inv0, acc[4 * c + 1] * inv0);
      if (r0 + 8 < Sq)
        *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(r0 + 8) * hd + col) =
            pack_bf16(acc[4 * c + 2] * inv1, acc[4 * c + 3] * inv1);
    }
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

// (heads, rows, hd) bf16, contiguous, read in boxes of `box_rows` x 64
// columns; columns past hd and rows past `rows` arrive as zeros
bool make_map(CUtensorMap* map, const void* base, int heads, int rows, int hd, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {PANEL, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int NV, int NP>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o, int BH,
           int Sq, int Skv, int hd, int n_heads, int n_kv_heads, int causal, float scale,
           cudaStream_t stream) {
  const int smem = 1024 + NP * BM * ROW_BYTES + 2 * STAGES * NP * BN * ROW_BYTES +
                   8 * (1 + 3 * STAGES);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90<NV, NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(BH) * ((Sq + BM - 1) / BM);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_sm90<NV, NP><<<static_cast<unsigned int>(blocks), THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), BH, Sq, Skv, hd, n_heads, n_kv_heads, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

int flash_bf16(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv,
               int hd, int n_heads, int n_kv_heads, int causal, float scale, int nv,
               cudaStream_t stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if (hd <= 0 || hd % 8 != 0 || hd > 128 || hd > nv || Sq % 64 != 0 || Skv % 64 != 0 ||
      Skv <= 0 || (causal && Sq != Skv) || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      BH % n_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (addr_bits % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);   // TMA
  const int BHkv = BH / n_heads * n_kv_heads;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, BH, Sq, hd, BM) || !make_map(&mk, k, BHkv, Skv, hd, BN) ||
      !make_map(&mv, v, BHkv, Skv, hd, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (nv) {
    case 64:
      return launch<64, 1>(mq, mk, mv, o, BH, Sq, Skv, hd, n_heads, n_kv_heads, causal,
                            scale, stream);
    case 80:
      return launch<80, 2>(mq, mk, mv, o, BH, Sq, Skv, hd, n_heads, n_kv_heads, causal,
                            scale, stream);
    case 96:
      return launch<96, 2>(mq, mk, mv, o, BH, Sq, Skv, hd, n_heads, n_kv_heads, causal,
                            scale, stream);
    case 128:
      return launch<128, 2>(mq, mk, mv, o, BH, Sq, Skv, hd, n_heads, n_kv_heads, causal,
                            scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_flash_attn_bf16(const void* q, const void* k, const void* v, void* o,
                                     int BH, int Sq, int Skv, int hd, int n_heads,
                                     int n_kv_heads, int causal, float scale, void* stream) {
  const int nv = hd <= 64 ? 64 : hd <= 80 ? 80 : hd <= 96 ? 96 : 128;
  return flash_bf16(q, k, v, o, BH, Sq, Skv, hd, n_heads, n_kv_heads, causal, scale, nv,
                    static_cast<cudaStream_t>(stream));
}

// the same with the second product's N chosen by the caller (64, 80, 96 or
// 128, at least hd): for comparing tile choices on the card
extern "C" int repro_flash_attn_bf16_nv(const void* q, const void* k, const void* v, void* o,
                                        int BH, int Sq, int Skv, int hd, int n_heads,
                                        int n_kv_heads, int causal, float scale, int nv,
                                        void* stream) {
  return flash_bf16(q, k, v, o, BH, Sq, Skv, hd, n_heads, n_kv_heads, causal, scale, nv,
                    static_cast<cudaStream_t>(stream));
}
