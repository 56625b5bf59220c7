// Hopper (sm_90a) primitives shared by flash_attention.cu and conv_bn.cu:
// mbarriers, TMA tensor maps, loads and stores, wgmma descriptors and
// products.
// Included by each source; everything here is internal to its unit.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// entry-point codes beside cudaError_t's (see flash_error_string)
constexpr int kErrNoEncode = 10001;
constexpr int kErrEncode = 10002;

constexpr int kWarpgroup = 128;
constexpr int kBlockThreads = 2 * kWarpgroup;  // two warpgroups; warp 0 also loads
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kSlab = 64;                      // bf16 columns per 128-byte row
constexpr int kRowBytes = 128;
constexpr int kGroupBytes = 8 * kRowBytes;     // one 8-row swizzle atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of the given parity.
// A phase that never completes is a bug in the ring: trap after about
// ten seconds rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == 1024) start = clock64();
    if (spins > 1024 && clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: one box of a 4-D map into shared memory at the given (signed)
// coordinates, innermost first, counted on `bar` in bytes. Elements
// outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA store: one box of a 4-D map from shared memory at the given
// coordinates; elements outside the tensor are not written. Before it,
// the threads that wrote the box fence their writes to the async proxy
// (fence_async_smem) and synchronise; after it, the issuing thread
// commits and waits until the box has been read (tma_store_wait) before
// the shared memory is reused or the block exits.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Shared-memory matrix descriptors for 128-byte-swizzled tiles whose
// 8-row atoms are 1024 bytes apart (start address, LBO and SBO in
// 16-byte units, layout type 1 = 128B swizzle). K-major: rows are the
// M/N dimension, the 16-element K step lies inside a row (LBO unused).
// MN-major: rows are the K dimension and each row holds 64 M/N
// elements; SBO is the stride of the 8-row K atoms and LBO that of the
// next 64 M/N columns (`mn_stride` bytes: the slab stride of a tile
// wider than 64, unread at 64 columns).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(kGroupBytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint32_t mn_stride = kGroupBytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(mn_stride >> 4) << 16) |
         (static_cast<uint64_t>(kGroupBytes >> 4) << 32) | (1ull << 62);
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

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// sees the wgmma only where it is issued, so reads of its accumulators
// must not move above the wait, and its A fragments must stay live and
// untouched until then.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void pin(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i]);
}
template <int N, int M>
__device__ __forceinline__ void pin(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define ACC8(d, i)                                                                   \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64x64] (+)= A[64x16] B[16x64], A and B in shared memory: K-major, or
// MN-major where TransA / TransB is 1.
template <int TransA = 0, int TransB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TransA), "n"(TransB));
}

// D[64x128] (+)= A[64x16] B[16x128], as wgmma_ss_n64.
template <int TransA = 0, int TransB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40),
        ACC8(d, 48), ACC8(d, 56)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TransA), "n"(TransB));
}

// D[64x64] += A[64x16] B[16x64], A a bf16 fragment in registers, B
// MN-major in shared memory (transpose flag set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator fragment of wgmma m64nN (f32): thread t of the warpgroup
// holds, for each 8-column chunk j, d[4j + 2i + c] at row
// 16*(t/32) + (t%32)/4 + 8i and column 8j + 2*(t%4) + c. The bf16 A
// fragment of a k16 step kk is the same layout over chunks 2kk and
// 2kk+1: register 2*(j%2) + i holds the pair (c = 0, 1) of chunk j.

// ---------------------------------------------------------------------------
// Host side.

// cuTensorMapEncodeTiled is a driver API; the library links only the
// runtime, so it is looked up once through the runtime's entry point.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(entry);
  }
  return fn;
}

// A 4-D map of a contiguous bf16 tensor whose dims are `dims`, innermost
// first, with a box of 64 innermost elements (one 128-byte row) by
// box[1..3], 128-byte swizzle; elements outside the tensor read as zero.
int make_map_4d(CUtensorMap* map, const void* ptr, const uint64_t (&dims)[4],
                const uint32_t (&box)[3]) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t gdims[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t row = dims[0] * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * dims[1], row * dims[1] * dims[2]};
  const cuuint32_t gbox[4] = {static_cast<cuuint32_t>(kSlab), box[0], box[1], box[2]};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            gdims, strides, gbox, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
