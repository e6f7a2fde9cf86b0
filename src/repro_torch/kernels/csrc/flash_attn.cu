// Flash attention forward for float32 on Hopper's tensor cores (sm_90a), in
// 3xTF32: causal or full online-softmax attention with grouped-query heads.
// bf16 inputs go to the wgmma kernel of flash_attn_sm90.cu.
//
// Replaces the TPU kernel `flash_attention_pallas` (`_flash_kernel`) of
// src/repro/kernels/flash_attn.py for float32 inputs, which does both
// products in f32 (its lines 40-53).
//
// Bound: operations.  Both products are 4 * hd flops a (query, key) pair
// over the causal triangle against 4 * S * hd elements moved: repro-100m's
// (48, 256, 64) is 0.0060 ms at the f32 rate of the CUDA cores (67 TFLOP/s)
// and 0.0008 ms by its bytes.  That f32 rate is the table's bound; in
// 3xTF32 the floor is 3 x flops / 495 TFLOP/s (0.0024 ms there).  One TF32
// product keeps about three digits, which would void the float32 checks.
//
// Design (64 query rows a block, 8 warps, mma.sync m16n8k8):
//  * 3xTF32: each f32 operand is split into a TF32 high part and a TF32
//    residual (round to nearest on the bits, as csrc/wkv_sm90.cu), and
//    lo*hi + hi*lo + hi*hi are summed in f32, the residual products in
//    accumulators of their own;
//  * warp w owns query rows 16 (w % 4) .. + 15 and half of every key tile
//    (BN = 64 keys, 32 at head dims above 80), with a running max,
//    denominator and output of its own; the two halves of a row group meet
//    once, at the end, through shared memory.  The chain of key tiles a warp
//    walks is half as long, and two warps a scheduler hide each other's
//    latency;
//  * K and V tiles land by cp.async in a two-stage ring, the next tile in
//    flight while this one is computed, one barrier a tile.  Each warp
//    splits the B fragments it reads, in registers: the integer work of the
//    split runs beside the tensor cores, and shared memory, which the
//    products' fragment reads keep busy, moves each element of K and V as
//    4 bytes, not as a high part and a residual of 4 bytes each.  Q (scaled
//    by 1/sqrt(hd) in f32 first), read by every tile, is split once for the
//    block, in place, and its fragments held in registers at hd <= 64;
//  * S = Q K^T stays in registers as the mma accumulators, K's fragments by
//    ldmatrix.  The P V product takes P as its A operand straight from
//    them: the accumulator holds keys 2t and 2t+1 of an 8-key slice where
//    the A fragment wants t and t+4, so the slice's keys are taken in the
//    order (0, 2, 4, 6, 1, 3, 5, 7), reading V's rows 2t and 2t+1;
//  * exp is the accurate expf; rows are padded so that every fragment read
//    of a warp meets distinct banks; the unrolled product loops hold no
//    branch, so the mmas of all 8-key slices interleave;
//  * built for head dims 32, 64, 80 and 128; any other multiple of 8 is
//    padded with zeros up to the next.  Causal: key tiles above the diagonal
//    are never loaded, a warp skips the halves above its own rows, and the
//    longest query tiles run first; GQA by index arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                 // query rows a block
constexpr int WARPS = 8;               // 4 row groups of 16 x 2 halves of each key tile
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;

// HD: the head dim a build of the kernel computes (32, 64, 80 or 128: the
// models' 64, 80 and 128); a smaller hd is padded with zero columns
template <int HD>
struct Cfg {
  static constexpr int BN = HD <= 80 ? 64 : 32;   // keys a tile
  static constexpr int KW = BN / 2;               // keys a warp takes of each tile
  static constexpr int LD = HD + 4;               // a row, floats (4 mod 8: no bank conflicts)
  static constexpr int NK = HD / 8;               // 8-wide slices of the head dim
  static constexpr int NT = KW / 8;               // 8-key slices of a warp's half tile
  static constexpr bool Q_IN_REGS = HD <= 64;     // Q's split fragments held in registers
  static constexpr int TILE = BN * LD;
  // K and V as they land (two stages each), Q's high parts (where it lands)
  // and residuals
  static constexpr int KR = 0, VR = 2 * TILE, QH = 4 * TILE, QL = QH + BM * LD;
  static constexpr int FLOATS = QL + BM * LD;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 4 blocks of 32-bit words, one row address from each lane (lanes
// 8i..8i+7 for block i); lane (g, t) receives word t of row g of each block
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two 8 x 4 blocks of 32-bit words, row addresses from lanes 0-7 and 8-15
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// x as a TF32 high part and a TF32 residual, each rounded to nearest (ties
// away from zero, as cvt.rna) by integer operations on the bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ROWS rows of hd floats into rows of stride LD, by cp.async; a thread's
// share of the (ROWS x HD / 4) 16-byte pieces is unrolled, those past hd skipped
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst, int hd) {
  constexpr int PER_ROW = HD / 4;
  static_assert(ROWS * PER_ROW % THREADS == 0, "a tile is whole rounds of the block");
#pragma unroll
  for (int it = 0; it < ROWS * PER_ROW / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    if (c < hd) cp_async16(dst + r * LD + c, src + static_cast<size_t>(r) * hd + c);
  }
}

// split landed rows of Q in place, all HD columns (those past hd hold
// zeros): x * scale -> high part in `hi`, residual in `lo`
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void split_rows(float* hi, float* lo, float scale) {
  constexpr int PER_ROW = HD / 4;
#pragma unroll
  for (int it = 0; it < ROWS * PER_ROW / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int at = (i / PER_ROW) * LD + (i % PER_ROW) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + at);
    uint4 h, l;
    split(x.x * scale, h.x, l.x);
    split(x.y * scale, h.y, l.y);
    split(x.z * scale, h.z, l.z);
    split(x.w * scale, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int BH, int Sq, int Skv,
                 int hd, int n_heads, int n_kv_heads, int causal, float scale) {
  using C = Cfg<HD>;
  constexpr int BN = C::BN, LD = C::LD, NK = C::NK, NT = C::NT;
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;           // fragment row group, thread in group
  const int rg = warp & 3, half = warp >> 2;       // the warp's 16 query rows, its half of each tile
  const int nk = hd / 8;

  // tile-major block order; causal runs the longest query tiles first
  const int n_qt = Sq / BM;
  const int tile = blockIdx.x / BH;
  const int bh = blockIdx.x - tile * BH;
  const int qi = causal ? (n_qt - 1 - tile) : tile;
  const int gq = n_heads / n_kv_heads;
  const int kvh = (bh / n_heads) * n_kv_heads + (bh % n_heads) / gq;
  const int r0 = qi * BM + rg * 16;                 // this warp's first query row

  const float* qp = q + (static_cast<size_t>(bh) * Sq + static_cast<size_t>(qi) * BM) * hd;
  const float* kp = k + static_cast<size_t>(kvh) * Skv * hd;
  const float* vp = v + static_cast<size_t>(kvh) * Skv * hd;

  int n_kv = Skv / BN;
  if (causal) {
    const int last = (qi * BM + BM - 1) / BN + 1;    // tiles that hold a key <= the last query
    n_kv = last < n_kv ? last : n_kv;
  }

  load_rows<BM, HD, LD>(qp, smem + C::QH, hd);
  cp_async_commit();
  load_rows<BN, HD, LD>(kp, smem + C::KR, hd);
  load_rows<BN, HD, LD>(vp, smem + C::VR, hd);
  cp_async_commit();
  if (hd < HD) {                       // columns no copy writes: zeros, split to zeros
    const int pad = HD - hd;
    for (int i = threadIdx.x; i < 4 * BN * pad; i += THREADS)        // K and V, both stages
      smem[C::KR + (i / pad) * LD + hd + i % pad] = 0.0f;
    for (int i = threadIdx.x; i < BM * pad; i += THREADS)
      smem[C::QH + (i / pad) * LD + hd + i % pad] = 0.0f;
  }

  // Q's A fragments (rows g, g + 8; columns t, t + 4 of each 8-slice): split
  // once, while the first key tile is in flight, and held in registers at hd <= 64;
  // ldmatrix row addresses: lanes 8-15 and 24-31 rows g + 8, lanes 16-31 columns t + 4
  const int q_lane = (rg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4;
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  split_rows<BM, HD, LD>(smem + C::QH, smem + C::QL, scale);
  __syncthreads();
  uint32_t qh[C::Q_IN_REGS ? NK : 1][4], ql[C::Q_IN_REGS ? NK : 1][4];
  if constexpr (C::Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      ldmatrix_x4(qh[kk], smem + C::QH + q_lane + 8 * kk);
      ldmatrix_x4(ql[kk], smem + C::QL + q_lane + 8 * kk);
    }
  }

  // the output as high and residual products, each rescaled with the running max
  float acc[NK][4], acc_lo[NK][4];
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.0f, 0.0f};
#pragma unroll
  for (int d = 0; d < NK; ++d)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[d][x] = acc_lo[d][x] = 0.0f;

  // ldmatrix row addresses of K (lanes 8-15 the columns 4-7 of a slice)
  const int kw0 = half * C::KW;                     // the warp's first key within a tile
  const int k_lane = (kw0 + (lane & 7)) * LD + ((lane >> 3) & 1) * 4;

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait_all();
    __syncthreads();                   // tile j has landed; tile j - 1 is no longer read
    if (j + 1 < n_kv) {
      const int s1 = (j + 1) & 1;
      load_rows<BN, HD, LD>(kp + static_cast<size_t>(j + 1) * BN * hd, smem + C::KR + s1 * C::TILE, hd);
      load_rows<BN, HD, LD>(vp + static_cast<size_t>(j + 1) * BN * hd, smem + C::VR + s1 * C::TILE, hd);
      cp_async_commit();
    }
    const float* Kr = smem + C::KR + (j & 1) * C::TILE;
    const float* Vr = smem + C::VR + (j & 1) * C::TILE;

    const int k0 = j * BN + kw0;                    // the warp's first key
    if (causal && k0 > r0 + 15) continue;           // its half lies above its rows

    // S = (Q / sqrt(hd)) K^T: high and residual products apart
    float sh[NT][4], sl[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) sh[n][x] = sl[n][x] = 0.0f;
    const float* kb = Kr + k_lane;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (C::Q_IN_REGS) {
#pragma unroll
        for (int x = 0; x < 4; ++x) { ah[x] = qh[kk][x]; al[x] = ql[kk][x]; }
      } else {
        ldmatrix_x4(ah, smem + C::QH + q_lane + 8 * kk);
        ldmatrix_x4(al, smem + C::QL + q_lane + 8 * kk);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b[2], bh2[2], bl2[2];              // B(k = d, n = key) = K[key][d]: t, t + 4
        ldmatrix_x2(b, kb + 8 * n * LD + 8 * kk);
        split(__uint_as_float(b[0]), bh2[0], bl2[0]);
        split(__uint_as_float(b[1]), bh2[1], bl2[1]);
        mma_tf32(sl[n], al, bh2);
        mma_tf32(sl[n], ah, bl2);
        mma_tf32(sh[n], ah, bh2);
      }
    }

    // online softmax; a row's 8-key slices are spread over the 4 lanes of its group
    float s[NT][4];
    const bool diag = causal && k0 + C::KW - 1 > r0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        s[n][x] = sh[n][x] + sl[n][x];
        if (diag && k0 + 8 * n + 2 * t + (x & 1) > r0 + g + 8 * (x >> 1)) s[n][x] = NEG_INF;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[h], mx);
      const float corr = expf(m_i[h] - m_new);
      m_i[h] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * h] = expf(s[n][2 * h] - m_new);
        s[n][2 * h + 1] = expf(s[n][2 * h + 1] - m_new);
        rs += s[n][2 * h] + s[n][2 * h + 1];
      }
      l_i[h] = l_i[h] * corr + rs;      // this lane's share; the group's sum is taken at the end
#pragma unroll
      for (int d = 0; d < NK; ++d) {
        acc[d][2 * h] *= corr;
        acc[d][2 * h + 1] *= corr;
        acc_lo[d][2 * h] *= corr;
        acc_lo[d][2 * h + 1] *= corr;
      }
    }

    // O += P V with P as A fragments, keys of slice n in the order (0, 2, 4, 6, 1, 3, 5, 7):
    // B(k = key 2t | 2t + 1, n = column g) = V's rows 2t and 2t + 1
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t ph[4], pl[4];
      split(s[n][0], ph[0], pl[0]);
      split(s[n][2], ph[1], pl[1]);
      split(s[n][1], ph[2], pl[2]);
      split(s[n][3], ph[3], pl[3]);
      const float* vb = Vr + (kw0 + 8 * n + 2 * t) * LD + g;
#pragma unroll
      for (int d = 0; d < NK; ++d) {
        uint32_t bh2[2], bl2[2];
        split(vb[8 * d], bh2[0], bl2[0]);
        split(vb[8 * d + LD], bh2[1], bl2[1]);
        mma_tf32(acc_lo[d], pl, bh2);
        mma_tf32(acc_lo[d], ph, bl2);
        mma_tf32(acc[d], ph, bh2);
      }
    }
  }

  // the two halves of each row group meet: the second hands (m, l, O) to the first
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_i[h] += __shfl_xor_sync(0xffffffffu, l_i[h], 1);
    l_i[h] += __shfl_xor_sync(0xffffffffu, l_i[h], 2);
  }
  __syncthreads();                     // every warp is done with the tiles: reuse their planes
  float* mg = smem + rg * 32 + lane;   // item i of this lane at mg[128 * i]
  if (half == 1) {
    mg[0] = m_i[0]; mg[128] = m_i[1]; mg[256] = l_i[0]; mg[384] = l_i[1];
#pragma unroll
    for (int d = 0; d < NK; ++d)
#pragma unroll
      for (int x = 0; x < 4; ++x) mg[128 * (4 + 4 * d + x)] = acc[d][x] + acc_lo[d][x];
  }
  __syncthreads();
  if (half == 1) return;
  float c0[2], c1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = mg[128 * h];
    const float m = fmaxf(m_i[h], m1);
    c0[h] = expf(m_i[h] - m);
    c1[h] = expf(m1 - m);
    l_i[h] = fmaxf(l_i[h] * c0[h] + mg[128 * (2 + h)] * c1[h], 1e-30f);
  }
  float* op = o + (static_cast<size_t>(bh) * Sq + static_cast<size_t>(r0 + g)) * hd + 2 * t;
#pragma unroll
  for (int d = 0; d < NK; ++d) {
    if (d < nk) {
      float r[4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
        r[x] = ((acc[d][x] + acc_lo[d][x]) * c0[x >> 1] + mg[128 * (4 + 4 * d + x)] * c1[x >> 1]) /
               l_i[x >> 1];
      *reinterpret_cast<float2*>(op + 8 * d) = make_float2(r[0], r[1]);
      *reinterpret_cast<float2*>(op + 8 * hd + 8 * d) = make_float2(r[2], r[3]);
    }
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv,
              int hd, int n_heads, int n_kv_heads, int causal, float scale, cudaStream_t stream) {
  if (Skv % Cfg<HD>::BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(Cfg<HD>::FLOATS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(BH) * (Sq / BM);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<HD><<<static_cast<unsigned int>(blocks), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), BH, Sq, Skv, hd, n_heads, n_kv_heads, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv,
           int hd, int n_heads, int n_kv_heads, int causal, float scale, cudaStream_t stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if (hd <= 0 || hd % 8 != 0 || hd > 128 || Sq % BM != 0 || Skv <= 0 || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0 || BH % n_heads != 0 || (causal && Sq != Skv))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_HD(HD) \
  if (hd <= HD) return launch_hd<HD>(q, k, v, o, BH, Sq, Skv, hd, n_heads, n_kv_heads, causal, scale, stream);
  REPRO_FLASH_HD(32) REPRO_FLASH_HD(64) REPRO_FLASH_HD(80) REPRO_FLASH_HD(128)
#undef REPRO_FLASH_HD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int repro_flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                                    int BH, int Sq, int Skv, int hd, int n_heads,
                                    int n_kv_heads, int causal, float scale, void* stream) {
  return launch(q, k, v, o, BH, Sq, Skv, hd, n_heads, n_kv_heads, causal, scale,
                static_cast<cudaStream_t>(stream));
}
