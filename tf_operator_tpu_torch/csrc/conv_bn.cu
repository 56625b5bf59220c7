// 3x3 stride-1 SAME convolution for Hopper (sm_90a): the implicit-GEMM
// forward (K4, also run for dx) and the weight gradient (K5).
//
// Built with nvcc into the same shared library as flash_attention.cu,
// with a plain C interface loaded by ctypes (tf_operator_tpu_torch/ops/
// kernels.py). Every kernel launches on the caller's stream, allocates
// nothing (the wrapper passes the split-K scratch), and each entry
// point returns cudaGetLastError() after its launches.
//
// Layouts (row-major, contiguous; the reference's own, conv_bn.py):
//   x, y       [N, H, W, C] / [N, H, W, Cout] bf16 (NHWC)
//   w          [3, 3, C, Cout] bf16 (HWIO)
//   g          [N, H, W, Cout] bf16, the cotangent of y
//   dw         [3, 3, C, Cout] f32
//   partial    [S, 3, 3, C, Cout] f32 scratch, S = split count
// C and Cout are multiples of 64 (ops/conv_bn.py supports()); N, H, W
// are free: the kernels mask the ragged last tile themselves.
//
// Both are GEMMs with a reduction of at least 576: bf16 products on the
// tensor cores (WMMA 16x16x16, f32 accumulators) fed from shared memory
// that cp.async fills three stages ahead. The products of bf16 inputs
// are exact in f32, so the results differ from an f32 reference only by
// the order of summation.
//
// What bounds them on the H100. Every stride-1 3x3 conv of ResNet-50 at
// batch 256 does 5.92e10 FLOP (59.9 us at 989 TFLOP/s); at stage 0
// (56x56x64) its 2.06e8 bytes of x and y take 61.4 us at 3.35 TB/s, so
// the bound is bytes there and operations at the three deeper stages.
// These first kernels are bounded by neither: WMMA through mma.sync
// reaches a fraction of the wgmma rate, and a 128x64 (K4) or 64x64 (K5)
// tile re-reads its operands from L2 more often than a wgmma kernel
// with 128x256 tiles would. wgmma, TMA and warp specialisation are the
// next step (PERF.md has the times).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kStages = 3;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  // src-size 0 makes the copy write 16 zero bytes: the halo and the
  // ragged tail come out as zeros without a branch on the shared side
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// K4: forward. Replaces tf_operator_tpu/ops/pallas/conv_bn.py _conv_kernel
// (launched by _conv3x3_fwd), and as there serves dx in the backward on
// the cotangent with the flipped, transposed weights (conv_bn.py:212-220).
//
// Implicit GEMM: M = N*H*W output pixels, N_gemm = Cout, K = 9 taps x C.
// A block owns a 128-pixel x 64-channel output tile and walks K in
// 32-channel chunks, tap by tap. For each chunk it copies the 128
// shifted input rows into shared memory, computing the halo's addresses
// itself: a row whose (h+dy-1, w+dx-1) falls outside the image, or past
// the last pixel, is written as zeros. So the reference's jnp.pad copy
// of x (conv_bn.py:113) does not exist here. 8 warps, each a 32x32 piece
// of the tile as 2x2 WMMA accumulators; the f32 tile goes through shared
// memory once more to leave as bf16 in 16-byte stores.
// The linear block index puts the Cout tiles of one pixel tile next to
// each other, so the blocks running together share their input rows in
// L2.
constexpr int kFwdBM = 128, kFwdBN = 64, kFwdBK = 32, kFwdThreads = 256;
constexpr int kFwdAPitch = kFwdBK + 8;  // bf16; 80-byte rows: no bank conflicts
constexpr int kFwdBPitch = kFwdBN + 8;  // bf16; 144-byte rows
constexpr int kFwdCPitch = kFwdBN + 4;  // f32
constexpr int kFwdPipeBytes =
    kStages * (kFwdBM * kFwdAPitch + kFwdBK * kFwdBPitch) * int(sizeof(bf16));
constexpr int kFwdEpiBytes = kFwdBM * kFwdCPitch * int(sizeof(float));
constexpr int kFwdSmemBytes = kFwdPipeBytes > kFwdEpiBytes ? kFwdPipeBytes : kFwdEpiBytes;
static_assert(kFwdSmemBytes <= 48 * 1024, "static shared memory");

__global__ void __launch_bounds__(kFwdThreads)
conv3x3_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   bf16* __restrict__ y, int N, int H, int W, int C, int Cout) {
  __shared__ __align__(128) unsigned char smem[kFwdSmemBytes];
  bf16* a_smem = reinterpret_cast<bf16*>(smem);
  bf16* b_smem = a_smem + kStages * kFwdBM * kFwdAPitch;
  float* c_smem = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1, warp_n = warp & 1;  // 4 x 2 warps
  const int n_tiles = Cout / kFwdBN;
  const int m_tile = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x - m_tile * n_tiles) * kFwdBN;
  const long long M = static_cast<long long>(N) * H * W;
  const long long m0 = static_cast<long long>(m_tile) * kFwdBM;
  const int hw = H * W;

  // A: 128 rows x 4 chunks of 8 channels; this thread copies chunk
  // tid % 4 of rows tid / 4 and tid / 4 + 64, whose pixels it decodes once
  const int a_chunk = tid & 3;
  int a_n[2], a_h[2], a_w[2];
  bool a_in[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + 64 * i;
    a_in[i] = m < M;
    const long long mm = a_in[i] ? m : 0;
    a_n[i] = static_cast<int>(mm / hw);
    const int rem = static_cast<int>(mm - static_cast<long long>(a_n[i]) * hw);
    a_h[i] = rem / W;
    a_w[i] = rem - a_h[i] * W;
  }
  // B: 32 rows x 8 chunks, one chunk per thread
  const int b_row = tid >> 3, b_chunk = tid & 7;

  const int c_chunks = C / kFwdBK;
  const int k_tiles = 9 * c_chunks;

  auto load = [&](int stage, int kt) {
    const int tap = kt / c_chunks;
    const int c0 = (kt - tap * c_chunks) * kFwdBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    bf16* as = a_smem + stage * kFwdBM * kFwdAPitch;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + 64 * i;
      const int hi = a_h[i] + dy, wi = a_w[i] + dx;
      const bool ok = a_in[i] && hi >= 0 && hi < H && wi >= 0 && wi < W;
      const bf16* src =
          ok ? x + ((static_cast<size_t>(a_n[i]) * H + hi) * W + wi) * C + c0 + a_chunk * 8
             : x;
      cp_async16(as + r * kFwdAPitch + a_chunk * 8, src, ok);
    }
    bf16* bs = b_smem + stage * kFwdBK * kFwdBPitch;
    const bf16* src = w + (static_cast<size_t>(tap) * C + c0 + b_row) * Cout + n0 + b_chunk * 8;
    cp_async16(bs + b_row * kFwdBPitch + b_chunk * 8, src, true);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kt has landed; chunk kt-1's stage is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) load(next % kStages, next);
    cp_async_commit();
    const bf16* as = a_smem + (kt % kStages) * kFwdBM * kFwdAPitch;
    const bf16* bs = b_smem + (kt % kStages) * kFwdBK * kFwdBPitch;
#pragma unroll
    for (int kk = 0; kk < kFwdBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (warp_m * 32 + i * 16) * kFwdAPitch + kk,
                               kFwdAPitch);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * kFwdBPitch + warp_n * 32 + j * 16,
                               kFwdBPitch);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's shared memory becomes the f32 tile

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_smem + (warp_m * 32 + i * 16) * kFwdCPitch + warp_n * 32 + j * 16,
                              acc[i][j], kFwdCPitch, wmma::mem_row_major);
  __syncthreads();

  for (int v = tid; v < kFwdBM * (kFwdBN / 8); v += kFwdThreads) {
    const int r = v >> 3, ch = v & 7;
    const long long m = m0 + r;
    if (m >= M) continue;
    const float* src = c_smem + r * kFwdCPitch + ch * 8;
    uint4 packed;
    __nv_bfloat162* out2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int k = 0; k < 4; ++k) out2[k] = __floats2bfloat162_rn(src[2 * k], src[2 * k + 1]);
    *reinterpret_cast<uint4*>(y + m * Cout + n0 + ch * 8) = packed;
  }
}

// ---------------------------------------------------------------------------
// K5: weight gradient. Replaces tf_operator_tpu/ops/pallas/conv_bn.py
// _dw_kernel (launched by _conv3x3_dw):
//   dw[dy, dx, ci, co] = sum over (n, h, w) of
//                        x[n, h+dy-1, w+dx-1, ci] * g[n, h, w, co],
// nine [C, M] x [M, Cout] products with M = N*H*W up to 802,816 and an
// output as small as 9 x 64 x 64. The TPU kernel reduces M along its
// sequential grid axis into one VMEM-resident block; Hopper's blocks run
// in parallel, and one block per output tile would put 9 blocks on 132
// SMs at stage 0. So M is split into S contiguous chunks (the wrapper
// picks S to fill the card): block (tap, 64x64 tile, split) sums its
// chunk on the tensor cores and stores its f32 partial to
// partial[split]; conv3x3_dw_reduce_kernel then adds the S partials in
// split order. No atomics: the result is the same from run to run.
// A block: 4 warps, each 32x32 of the tile as 2x2 WMMA accumulators;
// the x chunk is staged as [pixel][ci] and read as the column-major A =
// x^T, the g chunk as [pixel][co], the row-major B. The linear block
// index runs over taps first, then tiles, then splits, so the blocks
// in flight together read the same chunk of x and g through L2.
constexpr int kDwBM = 64, kDwBN = 64, kDwBK = 32, kDwThreads = 128;
constexpr int kDwPitch = 64 + 8;  // bf16; 144-byte rows
static_assert(kStages * 2 * kDwBK * kDwPitch * int(sizeof(bf16)) <= 48 * 1024,
              "static shared memory");

__global__ void __launch_bounds__(kDwThreads)
conv3x3_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  float* __restrict__ partial, int N, int H, int W, int C, int Cout,
                  int chunk) {
  __shared__ __align__(128) bf16 x_smem[kStages][kDwBK * kDwPitch];
  __shared__ __align__(128) bf16 g_smem[kStages][kDwBK * kDwPitch];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1, warp_n = warp & 1;  // 2 x 2 warps
  const int ci_tiles = C / kDwBM, co_tiles = Cout / kDwBN;
  const int tiles = ci_tiles * co_tiles;
  const int tap = blockIdx.x % 9;
  const int rest = blockIdx.x / 9;
  const int tile = rest % tiles;
  const int split = rest / tiles;
  const int ci0 = (tile / co_tiles) * kDwBM;
  const int co0 = (tile % co_tiles) * kDwBN;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const long long M = static_cast<long long>(N) * H * W;
  const long long mb = static_cast<long long>(split) * chunk;
  const long long me = mb + chunk < M ? mb + chunk : M;
  const int hw = H * W;
  const int k_tiles = static_cast<int>((me - mb + kDwBK - 1) / kDwBK);

  // each operand tile is 32 rows x 8 chunks of 8: two chunks per thread
  auto load = [&](int stage, int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + kDwThreads * i;
      const int r = v >> 3, ch = v & 7;
      const long long m = mb + static_cast<long long>(kt) * kDwBK + r;
      const bool in = m < me;
      const long long mm = in ? m : 0;
      const int n = static_cast<int>(mm / hw);
      const int rem = static_cast<int>(mm - static_cast<long long>(n) * hw);
      const int h = rem / W, wc = rem - (rem / W) * W;
      const int hi = h + dy, wi = wc + dx;
      const bool ok = in && hi >= 0 && hi < H && wi >= 0 && wi < W;
      const bf16* xs =
          ok ? x + ((static_cast<size_t>(n) * H + hi) * W + wi) * C + ci0 + ch * 8 : x;
      cp_async16(&x_smem[stage][r * kDwPitch + ch * 8], xs, ok);
      const bf16* gs = in ? g + static_cast<size_t>(mm) * Cout + co0 + ch * 8 : g;
      cp_async16(&g_smem[stage][r * kDwPitch + ch * 8], gs, in);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles) load(next % kStages, next);
    cp_async_commit();
    const bf16* xs = x_smem[kt % kStages];
    const bf16* gs = g_smem[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kDwBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + kk * kDwPitch + warp_m * 32 + i * 16, kDwPitch);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], gs + kk * kDwPitch + warp_n * 32 + j * 16, kDwPitch);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* out = partial + (static_cast<size_t>(split) * 9 + tap) * C * Cout;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          out + static_cast<size_t>(ci0 + warp_m * 32 + i * 16) * Cout + co0 + warp_n * 32 + j * 16,
          acc[i][j], Cout, wmma::mem_row_major);
}

// The second pass of K5: dw = partial[0] + partial[1] + ... in split
// order, four values a thread.
__global__ void conv3x3_dw_reduce_kernel(const float4* __restrict__ partial,
                                         float4* __restrict__ dw, int splits, int n4) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float4 acc = partial[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v = partial[static_cast<size_t>(s) * n4 + i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    dw[i] = acc;
  }
}

}  // namespace

extern "C" {

int conv3x3_fwd(const void* x, const void* w, void* y, int N, int H, int W, int C, int Cout,
                void* stream) {
  const long long M = static_cast<long long>(N) * H * W;
  const long long blocks = (M + kFwdBM - 1) / kFwdBM * (Cout / kFwdBN);
  conv3x3_fwd_kernel<<<static_cast<unsigned>(blocks), kFwdThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y), N, H, W,
      C, Cout);
  return static_cast<int>(cudaGetLastError());
}

int conv3x3_dw(const void* x, const void* g, void* partial, void* dw, int N, int H, int W,
               int C, int Cout, int splits, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks =
      static_cast<long long>(splits) * 9 * (C / kDwBM) * (Cout / kDwBN);
  conv3x3_dw_kernel<<<static_cast<unsigned>(blocks), kDwThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<float*>(partial), N,
      H, W, C, Cout, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n4 = 9 * C * Cout / 4;
  const int threads = 256;
  const int grid = (n4 + threads - 1) / threads < 1024 ? (n4 + threads - 1) / threads : 1024;
  conv3x3_dw_reduce_kernel<<<grid, threads, 0, s>>>(static_cast<const float4*>(partial),
                                                    static_cast<float4*>(dw), splits, n4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
