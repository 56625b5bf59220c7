// 3x3 stride-1 SAME convolution for Hopper (sm_90a): the implicit-GEMM
// forward (K4, also run for dx) and the weight gradient (K5).
//
// Built with nvcc into the same shared library as flash_attention.cu,
// with a plain C interface loaded by ctypes (tf_operator_tpu_torch/ops/
// kernels.py). Every kernel launches on the caller's stream, allocates
// nothing (the wrapper passes the split-K scratch), and each entry
// point returns cudaGetLastError() after its launches, or one of
// hopper.cuh's kErr codes when K5's TMA tensor maps cannot be made.
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
// Both are GEMMs with a reduction of at least 576 and bf16 products on
// the tensor cores with f32 accumulators: K4 through WMMA 16x16x16 fed
// from shared memory that cp.async fills three stages ahead, K5 through
// wgmma fed by TMA (hopper.cuh has the primitives). The products of
// bf16 inputs are exact in f32, so the results differ from an f32
// reference only by the order of summation.
//
// What bounds them on the H100. Every stride-1 3x3 conv of ResNet-50 at
// batch 256 does 5.92e10 FLOP (59.9 us at 989 TFLOP/s); at stage 0
// (56x56x64) its 2.06e8 bytes of x and y take 61.4 us at 3.35 TB/s, so
// the bound is bytes there and operations at the three deeper stages.
// K4 is bounded by neither: WMMA through mma.sync reaches a fraction of
// the wgmma rate, and its 128x64 tile re-reads its operands from L2 more
// often than a wgmma kernel with 128x256 tiles would (PERF.md has the
// times). K5's design note is at the kernel.

#include <mma.h>

#include "hopper.cuh"

namespace {

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
// in parallel, so M is split into contiguous runs of patches (the
// wrapper picks the split count to fill the card in whole waves): block
// (slot pair, Cout tile, split) sums its run on the tensor cores and
// stores its f32 partial to partial[split]; conv3x3_dw_reduce_kernel
// then adds the partials in split order. No atomics: the result is the
// same from run to run.
//
// The reduction runs over patches of kDwPatch = 112 pixels: a box of
// wb x hb pixels in each of nb images (56x2x1, 28x4x1, 14x2x4 and
// 7x1x16 at ResNet-50's four stages, each an exact cover; the wrapper's
// plan covers any N, H, W, zero-filling what lies outside). One TMA box
// of x per slot, at the tap's shifted coordinates, and one of g at the
// patch's own: TMA's zero fill of coordinates outside the tensor is the
// SAME halo, so there is no padded copy of x and no per-row address
// arithmetic, and x and g pixels pair up by their place in the box.
// Both land as [pixel][64 channels] rows of 128 bytes (128-byte
// swizzle), which wgmma reads MN-major (transpose flags set): A = x^T
// (M = 64 input channels), B = g (N = 64 or 128 output channels), K =
// the patch's pixels in 7 steps of 16.
// A slot is one (tap, 64 input channels) of the 9 * C/64; a block's two
// warpgroups take a pair of consecutive slots (at C = 64, two taps of
// one g patch; at C >= 128, two channel slabs of one tap) and share the
// g box. Each warpgroup accumulates a 64 x BN tile in registers (BN =
// 128 where Cout allows, else 64). Warp 0 keeps a ring of 3 (BN = 128)
// or 4 (BN = 64) stages full as in K1-K3. The linear block index runs
// over slot pairs first, then Cout tiles, then splits, so the blocks in
// flight together read the same patches of x and g through L2.
// What bounds it: at stage 0 (C = 64) bytes and operations about
// equally (PERF.md), deeper operations. The design reads each x pixel
// once per tap and each g pixel once per slot pair, from L2 after the
// first block; a 64 x 128 tile on SS wgmma keeps shared-memory operand
// traffic under the tensor cores' rate.
constexpr int kDwPatch = 112;                          // pixels per stage
constexpr int kDwSteps = kDwPatch / 16;                // wgmma k16 steps per stage
constexpr int kDwSlabBytes = kDwPatch * kRowBytes;     // one 64-channel slab

struct DwPlan {
  int wb, hb, nb;       // the patch box: wb x hb pixels in each of nb images
  int n_w, n_h;         // patches across W and H; then across N
  int patches;          // in all
  int per_split;        // patches per split (the last may have fewer)
};

template <int BN>
struct DwSmem {
  static constexpr int kStages = BN == 64 ? 4 : 3;
  static constexpr int kStage = (2 + BN / 64) * kDwSlabBytes;  // x of two slots, then g
  static constexpr int bars = kStages * kStage;
  static constexpr int bytes = bars + 2 * kStages * 8 + 1024;
};

template <int BN>
__global__ void __launch_bounds__(kBlockThreads, 1)
conv3x3_dw_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_g,
                  float* __restrict__ out, int C, int Cout, DwPlan plan) {
  using L = DwSmem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_full = base + L::bars;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * L::kStages;   // + 8 * stage

  const int slabs = C / 64;
  const int slots = 9 * slabs;                    // slot = tap * slabs + input slab
  const int pairs = (slots + 1) / 2;
  const int pair = blockIdx.x % pairs;
  const int rest = blockIdx.x / pairs;
  const int co0 = (rest % (Cout / BN)) * BN;
  const int split = rest / (Cout / BN);
  const int p0 = split * plan.per_split;
  const int n_iter = min(plan.patches - p0, plan.per_split);
  const int n_x = 2 * pair + 1 < slots ? 2 : 1;  // x boxes per stage

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kBlockWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Run by warp 0: patch it into its stage once both warpgroups have
  // released the patch before it there; lane 0 issues the copies.
  auto load_patch = [&](int it) {
    const int s = it % L::kStages;
    if (it >= L::kStages) mbar_wait(bar_empty + 8 * s, ((it / L::kStages) - 1) & 1);
    if (lane == 0) {
      const int p = p0 + it;
      const int w0 = (p % plan.n_w) * plan.wb;
      const int h0 = (p / plan.n_w % plan.n_h) * plan.hb;
      const int n0 = p / (plan.n_w * plan.n_h) * plan.nb;
      const uint32_t stage = base + s * L::kStage;
      const uint32_t bar = bar_full + 8 * s;
      mbar_arrive_expect_tx(bar, (n_x + BN / 64) * kDwSlabBytes);
      for (int k = 0; k < n_x; ++k) {
        const int slot = 2 * pair + k;
        const int tap = slot / slabs;
        tma_load(stage + k * kDwSlabBytes, &tm_x, bar, (slot % slabs) * 64,
                 w0 + tap % 3 - 1, h0 + tap / 3 - 1, n0);
      }
      for (int j = 0; j < BN / 64; ++j)
        tma_load(stage + (2 + j) * kDwSlabBytes, &tm_g, bar, co0 + 64 * j, w0, h0, n0);
    }
    __syncwarp();
  };
  if (warp == 0)
    for (int it = 0; it < min(L::kStages, n_iter); ++it) load_patch(it);

  // warpgroup wg: slot 2 * pair + wg. Where the pair has one slot,
  // warpgroup 1 repeats slot 0's products and stores nothing.
  const int wg = threadIdx.x / kWarpgroup;
  const int x_box = n_x == 2 ? wg : 0;
  float acc[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % L::kStages;
    mbar_wait(bar_full + 8 * s, (it / L::kStages) & 1);
    const uint32_t x_tile = base + s * L::kStage + x_box * kDwSlabBytes;
    const uint32_t g_tile = base + s * L::kStage + 2 * kDwSlabBytes;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDwSteps; ++kk) {
      // k step kk: 16 pixel rows = two 8-row atoms
      const uint64_t a = desc_mnmajor(x_tile + kk * 2 * kGroupBytes);
      const uint64_t b = desc_mnmajor(g_tile + kk * 2 * kGroupBytes, kDwSlabBytes);
      if constexpr (BN == 128)
        wgmma_ss_n128<1, 1>(acc, a, b, 1);
      else
        wgmma_ss_n64<1, 1>(acc, a, b, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    // refill the stage of the patch before this one, which the other
    // warpgroup has most likely released by now
    if (warp == 0 && it >= 1 && it - 1 + L::kStages < n_iter) load_patch(it - 1 + L::kStages);
  }

  if (wg >= n_x) return;
  const int slot = 2 * pair + wg;
  const int tap = slot / slabs, ci0 = (slot % slabs) * 64;
  float* dst = out + (static_cast<size_t>(split) * 9 + tap) * C * Cout;
  const int row = ci0 + 16 * (warp % 4) + lane / 4;  // and row + 8
  const int col0 = co0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(row + 8 * i) * Cout + col0 + 8 * j) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
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

template <int BN>
int launch_dw(const void* x, const void* g, float* partial, float* dw, int N, int H, int W,
              int C, int Cout, int splits, const DwPlan& plan, cudaStream_t stream) {
  CUtensorMap tx, tg;
  const uint32_t box[3] = {static_cast<uint32_t>(plan.wb), static_cast<uint32_t>(plan.hb),
                           static_cast<uint32_t>(plan.nb)};
  const uint64_t x_dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                              static_cast<uint64_t>(H), static_cast<uint64_t>(N)};
  const uint64_t g_dims[4] = {static_cast<uint64_t>(Cout), static_cast<uint64_t>(W),
                              static_cast<uint64_t>(H), static_cast<uint64_t>(N)};
  int rc = make_map_4d(&tx, x, x_dims, box);
  if (rc == 0) rc = make_map_4d(&tg, g, g_dims, box);
  if (rc != 0) return rc;
  const size_t smem = DwSmem<BN>::bytes;
  cudaError_t err = prepare(conv3x3_dw_kernel<BN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((9 * (C / 64) + 1) / 2) * (Cout / BN) * splits;
  conv3x3_dw_kernel<BN><<<static_cast<unsigned>(blocks), kBlockThreads, smem, stream>>>(
      tx, tg, partial, C, Cout, plan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n4 = 9 * C * Cout / 4;
  const int threads = 256;
  const int grid = (n4 + threads - 1) / threads < 1024 ? (n4 + threads - 1) / threads : 1024;
  conv3x3_dw_reduce_kernel<<<grid, threads, 0, stream>>>(reinterpret_cast<const float4*>(partial),
                                                         reinterpret_cast<float4*>(dw), splits, n4);
  return static_cast<int>(cudaGetLastError());
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

// The patch box (wb, hb, nb) must hold kDwPatch pixels, and `splits`
// runs of `per_split` patches must cover the ceil(W/wb) * ceil(H/hb) *
// ceil(N/nb) patches with no run empty (ops/kernels.py dw_plan); else
// cudaErrorInvalidValue without launching. partial holds splits * 9 * C
// * Cout f32.
int conv3x3_dw(const void* x, const void* g, void* partial, void* dw, int N, int H, int W,
               int C, int Cout, int wb, int hb, int nb, int splits, int per_split,
               void* stream) {
  DwPlan plan{wb, hb, nb, (W + wb - 1) / wb, (H + hb - 1) / hb, 0, per_split};
  plan.patches = plan.n_w * plan.n_h * ((N + nb - 1) / nb);
  if (wb * hb * nb != kDwPatch || wb > 256 || hb > 256 || nb > 256 || splits < 1 ||
      per_split < 1 || static_cast<long long>(splits) * per_split < plan.patches ||
      static_cast<long long>(splits - 1) * per_split >= plan.patches)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(dw);
  if (Cout % 128 == 0) return launch_dw<128>(x, g, part, out, N, H, W, C, Cout, splits, plan, s);
  return launch_dw<64>(x, g, part, out, N, H, W, C, Cout, splits, plan, s);
}

}  // extern "C"
