// Designs of the copy probe (src/repro_torch/kernels/csrc/probe_copy.cu)
// tried against each other on the card by
// `python benchmarks/torch_kernel_turns.py --probe --variants`.
//
// Every variant keeps the probe's launch shape (8 warps a block, one warp a
// 256-element float32 row, ceil(rows / 8) blocks) and moves each element
// once in and once out; they differ in which 16-byte words a lane moves and
// in the cache hints of its loads and stores:
//   0 strided:            a lane's words 2*lane and 2*lane + 1 (8 neighbouring
//                         floats), plain ld / st: each warp-wide access
//                         touches half of every sector of 1 KiB
//   1 coalesced:          words lane and 32 + lane, plain ld / st: 512
//                         contiguous bytes an access
//   2 coalesced, cs:      1 with ld.global.cs / st.global.cs (__ldcs / __stcs)
//   3 coalesced, nc:      1 with ld.global.nc.L1::no_allocate / st.global.cs
//   4 strided, cs:        0 with __ldcs / __stcs (the hints alone)
//   5 coalesced, evict_first: 1 with an L2 evict-first policy
//                         (createpolicy) on loads and stores
//   6 coalesced, nc 256B: 3 with an L2::256B prefetch on the loads
//   7 coalesced, cs loads: 1 with __ldcs loads and plain stores
//   8 coalesced, cs stores: 1 with plain loads and __stcs stores
//
// Built with nvcc into a library of a plain C interface:
//   int probe_variant(int variant, const void* x, void* out, long long rows, void* stream)
// returns cudaGetLastError() of the launch, or -1 for an unknown variant.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS_PER_CTA = 8;
constexpr int THREADS = WARPS_PER_CTA * 32;
constexpr int WORDS = BLOCK / 4;

__device__ __forceinline__ int4 ld_nc(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ int4 ld_nc_256(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ int4 ld_policy(const int4* p, uint64_t pol) {
  int4 v;
  asm volatile("ld.global.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void st_policy(int4* p, int4 v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.s32 [%0], {%1, %2, %3, %4}, %5;"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol) : "memory");
}

template <int V>
__global__ void __launch_bounds__(THREADS)
variant_kernel(const int4* __restrict__ x, int4* __restrict__ out, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int4* src = x + row * WORDS;
  int4* dst = out + row * WORDS;
  const bool strided = V == 0 || V == 4;
  const int i0 = strided ? 2 * lane : lane, i1 = strided ? 2 * lane + 1 : 32 + lane;
  if constexpr (V == 0 || V == 1) {
    const int4 a = src[i0], b = src[i1];
    dst[i0] = a;
    dst[i1] = b;
  } else if constexpr (V == 2 || V == 4) {
    const int4 a = __ldcs(src + i0), b = __ldcs(src + i1);
    __stcs(dst + i0, a);
    __stcs(dst + i1, b);
  } else if constexpr (V == 3) {
    const int4 a = ld_nc(src + i0), b = ld_nc(src + i1);
    __stcs(dst + i0, a);
    __stcs(dst + i1, b);
  } else if constexpr (V == 5) {
    uint64_t pol;
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
    const int4 a = ld_policy(src + i0, pol), b = ld_policy(src + i1, pol);
    st_policy(dst + i0, a, pol);
    st_policy(dst + i1, b, pol);
  } else if constexpr (V == 6) {
    const int4 a = ld_nc_256(src + i0), b = ld_nc_256(src + i1);
    __stcs(dst + i0, a);
    __stcs(dst + i1, b);
  } else if constexpr (V == 7) {
    const int4 a = __ldcs(src + i0), b = __ldcs(src + i1);
    dst[i0] = a;
    dst[i1] = b;
  } else {
    const int4 a = src[i0], b = src[i1];
    __stcs(dst + i0, a);
    __stcs(dst + i1, b);
  }
}

template <int V>
void launch(const void* x, void* out, long long rows, cudaStream_t stream) {
  const unsigned int grid = static_cast<unsigned int>((rows + WARPS_PER_CTA - 1) / WARPS_PER_CTA);
  variant_kernel<V><<<grid, THREADS, 0, stream>>>(static_cast<const int4*>(x),
                                                  static_cast<int4*>(out), rows);
}

}  // namespace

extern "C" int probe_variant(int variant, const void* x, void* out, long long rows, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: launch<0>(x, out, rows, s); break;
    case 1: launch<1>(x, out, rows, s); break;
    case 2: launch<2>(x, out, rows, s); break;
    case 3: launch<3>(x, out, rows, s); break;
    case 4: launch<4>(x, out, rows, s); break;
    case 5: launch<5>(x, out, rows, s); break;
    case 6: launch<6>(x, out, rows, s); break;
    case 7: launch<7>(x, out, rows, s); break;
    case 8: launch<8>(x, out, rows, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
