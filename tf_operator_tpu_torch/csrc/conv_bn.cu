// 3x3 stride-1 SAME convolution for Hopper (sm_90a): the implicit-GEMM
// forward (K4, also run for dx) and the weight gradient (K5).
//
// Built with nvcc into the same shared library as flash_attention.cu,
// with a plain C interface loaded by ctypes (tf_operator_tpu_torch/ops/
// kernels.py). Every kernel launches on the caller's stream, allocates
// nothing (the wrapper passes the split-K scratch), and each entry
// point returns cudaGetLastError() after its launches,
// cudaErrorInvalidValue without launching when the wrapper's plan is
// wrong, or one of hopper.cuh's kErr codes when a TMA tensor map cannot
// be made.
//
// Layouts (row-major, contiguous; the reference's own, conv_bn.py):
//   x, y       [N, H, W, C] / [N, H, W, Cout] bf16 (NHWC)
//   w          [3, 3, C, Cout] bf16 (HWIO)
//   g          [N, H, W, Cout] bf16, the cotangent of y
//   dw         [3, 3, C, Cout] f32
//   partial    [S, 3, 3, C, Cout] f32 scratch, S = split count
// C and Cout are multiples of 64 (ops/conv_bn.py supports()); N, H, W
// are free: both kernels walk the pixels in boxes of wb x hb pixels in
// each of nb images, read through 4-D TMA maps (C, W, H, N) whose zero
// fill is the SAME halo and the ragged edge alike.
//
// Both are GEMMs with a reduction of at least 576, run as bf16 wgmma
// (m64nNk16, f32 accumulators) on operands that TMA brings into a ring
// of shared-memory stages (hopper.cuh has the primitives). The products
// of bf16 inputs are exact in f32, so the results differ from an f32
// reference only by the order of summation; neither uses atomics, so
// each result is the same from run to run.
//
// What bounds them on the H100. Every stride-1 3x3 conv of ResNet-50 at
// batch 256 does 5.92e10 FLOP (59.9 us at 989 TFLOP/s); at stage 0
// (56x56x64) its 2.06e8 bytes of x and y take 61.4 us at 3.35 TB/s, so
// the bound is bytes there and operations at the three deeper stages.
// Each kernel's note says what its design does about it.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// K4: forward. Replaces tf_operator_tpu/ops/pallas/conv_bn.py _conv_kernel
// (launched by _conv3x3_fwd), and as there serves dx in the backward on
// the cotangent with the flipped, transposed weights (conv_bn.py:212-220):
//   y[n, h, w, co] = sum over (dy, dx, ci) of
//                    x[n, h+dy-1, w+dx-1, ci] * w[dy, dx, ci, co].
// Implicit GEMM: M = N*H*W output pixels, N_gemm = Cout, K = 9 taps x C,
// walked as 9 * C/64 steps of one (tap, 64 input channels). No split-K.
//
// A block owns a box of 128 output pixels (wb x hb pixels in each of nb
// images: 8x8x2, 4x4x8, 2x2x32 and 1x1x128 at ResNet-50's four stages,
// each an exact cover; the wrapper's plan covers any N, H, W) and BN =
// 128 output channels where Cout allows, else 64; its two warpgroups
// take 64 pixels each.
// For each step, warp 0's lane 0 loads one TMA box of x at the tap's
// shifted coordinates (c0, w0+dx-1, h0+dy-1, n0), whose zero fill is the
// halo (no padded copy of x, no per-pixel address arithmetic, no
// division), and BN/64 slabs of w [64 ci][64 co] through a map of w seen
// as (Cout, C, 9, 1). x lands as 128 pixel rows of 128 bytes, the A
// operand K-major; w lands MN-major (Cout contiguous) and is read with
// the transpose flag, its slabs 8 KB apart by the descriptor's LBO, as
// K5 reads g. A ring of 4 stages (BN = 64) or 3 (BN = 128), so that two
// blocks share an SM, is refilled by warp 0 once both warpgroups have
// released a stage; each warpgroup waits for its wgmmas within the
// stage, so no group is in flight across the back edge or an mbarrier
// spin. The epilogue rounds the f32 tile to bf16 into the freed ring
// (128-byte swizzle, no bank conflicts) and TMA stores it through a map
// of y with the unshifted box, which drops the pixels of a ragged box
// that lie outside the tensor. The linear block index keeps the Cout
// tiles of one pixel box adjacent, so the blocks in flight together
// read each x box through L2.
// A 128 x 256 tile (one block to an SM, 128 accumulators a thread) was
// slower than two 128 x 128 blocks at every stage where Cout allows it
// (PERF.md), so BN stops at 128.
// What bounds it: operations at stages 1-3, bytes at stage 0 (file
// note). Neither is reached: each block requests (128 + BN) x 64 bf16
// per step by TMA for 2 x 128 x BN x 64 FLOP, 64 FLOP a byte at BN =
// 128 and 43 at BN = 64, so the tensor cores' peak would need 15-23
// TB/s of requests served from L2, above the rate that K4's measured
// times imply for its modelled requests (chip_smoke.py's conv_times;
// PERF.md). At stage 0 every x pixel is requested nine times (once per
// tap) and each block requests all nine weight slabs: 1.39 GB of
// requests against the 206 MB of HBM traffic the bound counts. That L2,
// not HBM, limits stage 0 is a hypothesis: no counter of L2 or HBM
// traffic was read, so it is not measured.
constexpr int kFwdPixels = 128;                        // output pixels per block
constexpr int kFwdXBytes = kFwdPixels * kRowBytes;     // one x box: [128 pixels][64 ci]
constexpr int kFwdWSlabBytes = kSlab * kRowBytes;      // one w slab: [64 ci][64 co]

struct FwdPlan {
  int wb, hb, nb;  // the pixel box: wb x hb pixels in each of nb images
  int n_w, n_h;    // boxes across W and H; then across N
};

template <int BN>
struct FwdSmem {
  // two blocks to an SM: 2 x (4 x 24 KB) at BN = 64, 2 x (3 x 32 KB) at 128
  static constexpr int kStages = BN == 64 ? 4 : 3;
  static constexpr int kStage = kFwdXBytes + (BN / 64) * kFwdWSlabBytes;  // x box, then w
  static constexpr int bars = kStages * kStage;
  static constexpr int bytes = bars + 2 * kStages * 8 + 1024;
  // the epilogue's bf16 tile, BN/64 slabs of [128 pixels][64 co], reuses the ring
  static_assert((BN / 64) * kFwdXBytes <= bars, "epilogue tile fits in the ring");
};

template <int BN>
__global__ void __launch_bounds__(kBlockThreads, 2)
conv3x3_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_y, int C, int Cout, FwdPlan plan) {
  using L = FwdSmem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_full = base + L::bars;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * L::kStages;   // + 8 * stage

  const int co_tiles = Cout / BN;
  const int box = blockIdx.x / co_tiles;
  const int co0 = (blockIdx.x - box * co_tiles) * BN;
  const int w0 = (box % plan.n_w) * plan.wb;
  const int h0 = (box / plan.n_w % plan.n_h) * plan.hb;
  const int n0 = box / (plan.n_w * plan.n_h) * plan.nb;
  const int slabs = C / 64;
  const int steps = 9 * slabs;                    // step = tap * slabs + input slab

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

  // Run by warp 0: step it into its stage once both warpgroups have
  // released the step before it there; lane 0 issues the copies.
  auto load_step = [&](int it) {
    const int s = it % L::kStages;
    if (it >= L::kStages) mbar_wait(bar_empty + 8 * s, ((it / L::kStages) - 1) & 1);
    if (lane == 0) {
      const int tap = it / slabs;
      const int c0 = (it - tap * slabs) * 64;
      const uint32_t stage = base + s * L::kStage;
      const uint32_t bar = bar_full + 8 * s;
      mbar_arrive_expect_tx(bar, L::kStage);
      tma_load(stage, &tm_x, bar, c0, w0 + tap % 3 - 1, h0 + tap / 3 - 1, n0);
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_load(stage + kFwdXBytes + j * kFwdWSlabBytes, &tm_w, bar, co0 + 64 * j, c0, tap, 0);
    }
    __syncwarp();
  };
  if (warp == 0)
    for (int it = 0; it < min(L::kStages, steps); ++it) load_step(it);

  // warpgroup wg: pixel rows 64 * wg + [0, 64) of the box
  const int wg = threadIdx.x / kWarpgroup;
  float acc[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int s = it % L::kStages;
    mbar_wait(bar_full + 8 * s, (it / L::kStages) & 1);
    const uint32_t x_rows = base + s * L::kStage + wg * 64 * kRowBytes;
    const uint32_t w_tile = base + s * L::kStage + kFwdXBytes;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // k step kk: 16 input channels, 32 bytes into each x row; rows
      // 16 kk .. 16 kk + 15 (two 8-row atoms) of the w slabs
      const uint64_t a = desc_kmajor(x_rows + kk * 32);
      const uint64_t b = desc_mnmajor(w_tile + kk * 2 * kGroupBytes, kFwdWSlabBytes);
      if constexpr (BN == 128)
        wgmma_ss_n128<0, 1>(acc, a, b, 1);
      else
        wgmma_ss_n64<0, 1>(acc, a, b, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    // refill the stage of the step before this one, which the other
    // warpgroup has most likely released by now
    if (warp == 0 && it >= 1 && it - 1 + L::kStages < steps) load_step(it - 1 + L::kStages);
  }

  // Epilogue: every wgmma of both warpgroups has read its last stage, so
  // the ring takes the bf16 tile as BN/64 slabs of [128 pixels][64 co],
  // 16-byte chunk c of row r at chunk c ^ (r % 8) (the 128-byte swizzle
  // that the y map's store reads).
  __syncthreads();
  const int row = 64 * wg + 16 * (warp % 4) + lane / 4;  // and row + 8; row % 8 == lane / 4
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      const int off = (j / 8) * kFwdXBytes + r * kRowBytes + (((j % 8) ^ (lane / 4)) * 16) +
                      (lane % 4) * 4;
      *reinterpret_cast<uint32_t*>(smem + off) =
          pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_store(&tm_y, base + j * kFwdXBytes, co0 + 64 * j, w0, h0, n0);
    tma_store_wait();
  }
}

template <int BN>
int launch_fwd(const void* x, const void* w, void* y, int N, int H, int W, int C, int Cout,
               const FwdPlan& plan, long long boxes, cudaStream_t stream) {
  CUtensorMap tx, tw, ty;
  const uint32_t box[3] = {static_cast<uint32_t>(plan.wb), static_cast<uint32_t>(plan.hb),
                           static_cast<uint32_t>(plan.nb)};
  const uint32_t w_box[3] = {static_cast<uint32_t>(kSlab), 1, 1};
  const uint64_t x_dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                              static_cast<uint64_t>(H), static_cast<uint64_t>(N)};
  const uint64_t w_dims[4] = {static_cast<uint64_t>(Cout), static_cast<uint64_t>(C), 9, 1};
  const uint64_t y_dims[4] = {static_cast<uint64_t>(Cout), static_cast<uint64_t>(W),
                              static_cast<uint64_t>(H), static_cast<uint64_t>(N)};
  int rc = make_map_4d(&tx, x, x_dims, box);
  if (rc == 0) rc = make_map_4d(&tw, w, w_dims, w_box);
  if (rc == 0) rc = make_map_4d(&ty, y, y_dims, box);
  if (rc != 0) return rc;
  const size_t smem = FwdSmem<BN>::bytes;
  const cudaError_t err = prepare(conv3x3_fwd_kernel<BN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_fwd_kernel<BN><<<static_cast<unsigned>(boxes * (Cout / BN)), kBlockThreads, smem,
                           stream>>>(tx, tw, ty, C, Cout, plan);
  return static_cast<int>(cudaGetLastError());
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

// The pixel box (wb, hb, nb) must hold kFwdPixels pixels, each side at
// most 256 (a TMA box's limit), and bn, the output channels per block,
// must be 64 or 128 and divide Cout (ops/kernels.py fwd_plan); else
// cudaErrorInvalidValue without launching.
int conv3x3_fwd(const void* x, const void* w, void* y, int N, int H, int W, int C, int Cout,
                int wb, int hb, int nb, int bn, void* stream) {
  if (wb < 1 || hb < 1 || nb < 1 || wb * hb * nb != kFwdPixels || wb > 256 || hb > 256 ||
      nb > 256 || (bn != 64 && bn != 128) || Cout % bn != 0 ||
      C < 64 || C % 64 != 0 || N < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdPlan plan{wb, hb, nb, (W + wb - 1) / wb, (H + hb - 1) / hb};
  const long long boxes = static_cast<long long>(plan.n_w) * plan.n_h * ((N + nb - 1) / nb);
  if (boxes * (Cout / bn) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128) return launch_fwd<128>(x, w, y, N, H, W, C, Cout, plan, boxes, s);
  return launch_fwd<64>(x, w, y, N, H, W, C, Cout, plan, boxes, s);
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
