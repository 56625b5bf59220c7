// Flash attention for Hopper (sm_90a): forward (K1), dK/dV (K2), dQ (K3).
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (tf_operator_tpu_torch/ops/kernels.py). Every
// kernel launches on the caller's stream, allocates nothing, and each
// entry point returns cudaGetLastError() after its launch, or one of
// hopper.cuh's kErr codes when a TMA tensor map cannot be made
// (flash_error_string below names both kinds).
//
// Layouts (all row-major, contiguous):
//   q, out, dout, dq   [B, Sq, H, D] bf16 (the model's [b, s, h, d]; read
//   k, v, dk, dv       [B, Sk, H, D] bf16  in place, no transpose-and-fold)
//   out_f32            [B, Sq, H, D] f32: K1's output before rounding to
//                      bf16, for delta = rowsum(dO * O)
//   lse, delta         [B*H, Sq] f32
//   kv_mask            [B, Sk] f32 (1 = attend, 0 = padding), or null;
//                      shared by the H heads of one batch row
// D is 64 (BERT-base) or 128 (BERT_BASE_WIDE, GPT). Other dtypes and
// head dims are routed to plain attention before they get here
// (ops/flash_attention.py).
//
// What all three keep from the TPU kernels (tf_operator_tpu/ops/pallas/
// flash_attention.py), on purpose:
// - Masked scores are -1e30, not -inf (:68): causal first, then padding.
//   A row whose keys are all padded gets uniform weights and a finite
//   lse, exactly like the reference; -inf would give NaN. l is clamped
//   at 1e-30 (:168). Keys past the end of the sequence (the ragged last
//   tile) are not masked but absent: their probability is exactly 0.
// - Causal: key tiles past the diagonal are skipped (:158-164,
//   :311-316, :379-382); within a tile the test is q_pos >= k_pos on
//   absolute positions.
// - The key-padding mask is [b, sk] f32, read at batch row bh / H
//   (:203-211); "attend" is mask > 0.
// - One loop inside the block takes the place of the TPU grid's
//   sequential ("arbitrary") axis: Hopper's blocks run in parallel and
//   in no order. Each block writes only its own rows, with no atomics,
//   so every result is the same from run to run.
// TPU artifacts not carried over: the 128-lane head padding for d=64
// (:630-637), the [*, seq, 1] row-statistic layout (:103-108), and the
// 512/1024 VMEM blocks with _pick_block's multiple-of-128 rule
// (:542-569): the kernels mask the ragged edge themselves and take any
// sequence length.
//
// ---------------------------------------------------------------------
// Design of K1-K3: tensor cores fed by TMA (hopper.cuh has the
// primitives).
// - A block is two warpgroups (256 threads), each owning 64 rows of the
//   block's tile: 128 query rows in K1 and K3, 128 key rows in K2. The
//   rows the block owns stay resident in shared memory (K1: Q; K2: K and
//   V; K3: Q and dO); the other operands stream through a 3-stage ring
//   of shared-memory tiles (K1 and K3: 128 K and V rows at d=64, 64 at
//   d=128; K2: 64 Q and dO rows), each stage with a "full" and an
//   "empty" mbarrier.
// - Warp 0 loads: it fills the ring at the start, then refills a stage
//   one iteration after both warpgroups have released it (one lane of
//   each warp arrives on "empty" once its wgmmas have read the stage).
//   Its lane 0 issues the TMA copies and arrives on "full" with their
//   byte count; all 32 lanes write the stage's per-row side data (K1 and
//   K3: key validity; K2: lse and delta) and arrive. There is no separate
//   producer warp: a block of more than 256 threads is compiled for at
//   most 168 registers a thread (65,536 / 384), and setmaxnreg did not
//   raise what ptxas allots the consumers, so they spilled and their
//   wgmmas were serialized. At 256 threads the cap is 255.
// - The tensor maps are 4-D, (D, H, S, B) with box (64, 1, rows, 1): one
//   head's rows sit H*D elements apart in [B, S, H, D], and a ragged last
//   tile is zero-filled inside its own batch row. Each box row is 64
//   bf16 = 128 bytes, loaded with the 128-byte swizzle; d=128 is two
//   such 64-column slabs.
// - Products are wgmma m64nNk16 bf16 with f32 accumulators: q.k and dO.v
//   read both operands K-major from shared memory (N = 128 or 64); the
//   second product of each pair takes its probability matrix as the
//   register A operand and its B (v, dO, q or k) MN-major with the
//   transpose flag, 64 columns per instruction.
// - No wgmma group stays in flight across a loop's back edge, a spin on
//   an mbarrier or a warp-divergent path: ptxas serializes wgmmas around
//   those (C7520). K1 therefore issues P.V of tile t and S of tile t+1
//   together and waits for both within one iteration; K2 and K3 wait
//   within each tile.
// - Registers a thread (ptxas, sm_90a): K1 188 (d=64) / 155 (d=128),
//   holding S (64 / 32 f32), O (32 / 64) and P as bf16 hi and lo
//   fragments (32 + 32 / 16 + 16); K2 173 / 239, holding dK and dV
//   (32 + 32 / 64 + 64), one 64x64 score tile (32) and its bf16 fragment
//   (16); K3 229 / 158, holding dQ (32 / 64), S and dP (64 + 64 / 32 + 32)
//   and dS as bf16 fragments (32 / 16). No spills.
//
// The kernels' two departures from the reference's arithmetic:
// - q.k and dO.v take bf16 operands with f32 sums on the tensor cores:
//   the reference's f32 upcast products (:125-132, :152-156, :276-285)
//   up to the order of summation. The scale multiplies the f32 scores
//   rather than q in f32 (:125): exact for d=64 (1/8), one f32 rounding
//   apart for d=128.
// - The second products take their probability operand in bf16. K2
//   rounds P (for dV) and dS (for dK) to bf16, and K3 rounds dS (for dQ),
//   as FA2/FA3 do: on the inputs that stress it most (a large part common
//   to all values) dQ, dK and dV stay well within 1% of f32, and dQ stays
//   within one bf16 rounding of the f32-dS result elsewhere. K1 must not
//   round P so: delta = rowsum(dO * O) from an O built on rounded weights
//   no longer equals sum_k p dp as K2/K3 compute it from exact p, the
//   rows of dS stop summing to zero, and on those inputs dQ moves past 1%
//   from f32. So K1 splits P into hi = bf16(p) and lo = bf16(p - hi) and
//   runs P.V twice, keeping 16 bits of each weight: one more product,
//   and dQ, dK and dV within 1% (tests/test_torch_flash_attention.py
//   emulates all three on the CPU; chip_smoke.py's common-part check
//   measures the kernels).
//
// One deliberate departure shared by the port: the reference takes
// delta = rowsum(dO * O) from O rounded to the input dtype (:399-402).
// In bf16 that delta no longer equals sum_k p dp as K2/K3 compute it in
// f32, the rows of ds stop summing to zero, and the error lands on dQ
// and dK along the mean key/query: in BERT-base's last layers it took
// the query/key gradients far further from an f32 step than the plain
// bf16 path's (PERF.md). K1 therefore also writes O in f32 (out_f32) and
// the wrapper takes delta from that.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 3;  // TMA ring depth

__device__ __forceinline__ size_t elem(int b, int s, int h, int S, int H, int D) {
  return ((static_cast<size_t>(b) * S + s) * H + h) * static_cast<size_t>(D);
}

// `rows` rows of head (b, h) from row s0 of a (D, H, S, B) map, as D/64
// slabs of [rows][64].
template <int D>
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int h, int s0, int b, int rows) {
#pragma unroll
  for (int slab = 0; slab < D / kSlab; ++slab)
    tma_load(dst + slab * rows * kRowBytes, map, bar, slab * kSlab, h, s0, b);
}

// ---------------------------------------------------------------------------
// K1: forward. Replaces tf_operator_tpu/ops/pallas/flash_attention.py
// _fwd_kernel (launched by _flash_forward). Grid (ceil(Sq/128), B*H).
// out = softmax(q k^T * scale + mask) v with the online softmax (running
// max m, sum l, f32 accumulator); lse = m + log(max(l, 1e-30)).
// A block owns 128 query rows (64 per warpgroup), Q resident in shared
// memory; K/V tiles (128 keys at d=64, 64 at d=128) stream through the
// TMA ring. Per tile: S = Q K^T (SS wgmma), masking and the online
// softmax in registers with exp2, P split into bf16 hi and lo
// fragments, then O += P_hi V + P_lo V (RS wgmma, V MN-major), issued
// beside S of the next tile.
// Bound at the main-path shape: bytes (q, k, v in; out and lse out), a
// little above its 2 products at the bf16 peak. The f32 copy of out is
// this port's extra traffic, not part of that bound. S and P never
// leave registers; each K/V tile is read once per 128 query rows.
constexpr int kFwdRowsQ = 128;

template <int D>
struct FwdSmem {
  // key rows per tile: 128 at d=64; 64 at d=128, so that three stages fit
  static constexpr int kRowsK = D == 64 ? 128 : 64;
  static constexpr int kQ = kFwdRowsQ * D * 2;
  static constexpr int kKV = kRowsK * D * 2;
  static constexpr int q = 0;
  static constexpr int k = q + kQ;                  // + stage * kKV
  static constexpr int v = k + kStages * kKV;       // + stage * kKV
  static constexpr int valid = v + kStages * kKV;   // f32 [kStages][kRowsK]
  static constexpr int bars = valid + kStages * kRowsK * 4;
  static constexpr int bytes = bars + (1 + 2 * kStages) * 8 + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ kv_mask,
                 bf16* __restrict__ out, float* __restrict__ out_f32,
                 float* __restrict__ lse, int H, int Sq, int Sk, int causal,
                 float scale) {
  using L = FwdSmem<D>;
  constexpr int kN = L::kRowsK;
  constexpr int kSlabs = D / kSlab;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* valid_s = reinterpret_cast<float*>(smem + L::valid);
  const uint32_t bar_q = base + L::bars;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kFwdRowsQ;
  int n_tiles = (Sk + kN - 1) / kN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kFwdRowsQ, Sq) - 1) / kN + 1);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);
      mbar_init(bar_empty + 8 * s, kBlockWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Run by warp 0: K/V tile t into its stage once both warpgroups have
  // released the tile before it there, with its key validity (1 attend,
  // 0 padding, -1 past Sk) written by the warp's lanes.
  auto load_tile_kv = [&](int t) {
    const int s = t % kStages;
    if (t >= kStages) mbar_wait(bar_empty + 8 * s, ((t / kStages) - 1) & 1);
    const int k0 = t * kN;
    for (int c = lane; c < kN; c += 32) {
      const int kc = k0 + c;
      float state = -1.f;
      if (kc < Sk)
        state = (kv_mask == nullptr || kv_mask[static_cast<size_t>(b) * Sk + kc] > 0.f) ? 1.f : 0.f;
      valid_s[s * kN + c] = state;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kKV);
      tma_load_rows<D>(base + L::k + s * L::kKV, &tm_k, bar_full + 8 * s, h, k0, b, kN);
      tma_load_rows<D>(base + L::v + s * L::kKV, &tm_v, bar_full + 8 * s, h, k0, b, kN);
    } else {
      mbar_arrive(bar_full + 8 * s);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, L::kQ);
      tma_load_rows<D>(base + L::q, &tm_q, bar_q, h, q0, b, kFwdRowsQ);
    }
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_tile_kv(t);
  }

  // warpgroup wg: query rows q0 + 64*wg + [0, 64)
  const int wg = threadIdx.x / kWarpgroup;
  const int row = 64 * wg + 16 * (warp % 4) + lane / 4;  // and row + 8
  const int col0 = 2 * (lane % 4);
  const int qr0 = q0 + row;
  const uint32_t q_rows = base + L::q + 64 * wg * kRowBytes;

  float o[kSlabs][32];
#pragma unroll
  for (int ns = 0; ns < kSlabs; ++ns)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[ns][r] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kN / 2];
  uint32_t p_hi[kN / 16][4], p_lo[kN / 16][4];

  // S = Q K^T of tile t into acc; its stage has landed
  auto issue_scores = [&](int t) {
    const uint32_t k_tile = base + L::k + (t % kStages) * L::kKV;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // k step kk: slab kk / 4, 32 bytes per step inside the 128-byte row
      const uint64_t qa = desc_kmajor(q_rows + (kk / 4) * kFwdRowsQ * kRowBytes + (kk % 4) * 32);
      const uint64_t kb = desc_kmajor(k_tile + (kk / 4) * kN * kRowBytes + (kk % 4) * 32);
      if constexpr (kN == 128)
        wgmma_ss_n128(acc, qa, kb, kk > 0);
      else
        wgmma_ss_n64(acc, qa, kb, kk > 0);
    }
    wgmma_commit();
  };

  // O += P_hi V + P_lo V of tile t
  auto issue_pv = [&](int t) {
    const uint32_t v_tile = base + L::v + (t % kStages) * L::kKV;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int ns = 0; ns < kSlabs; ++ns) {
        const uint64_t vb = desc_mnmajor(v_tile + ns * kN * kRowBytes + kk * 2 * kGroupBytes);
        wgmma_rs_n64(o[ns], p_hi[kk], vb);
        wgmma_rs_n64(o[ns], p_lo[kk], vb);
      }
    wgmma_commit();
  };

  // The online softmax of tile t, S(t) being in acc: rescales l and O by
  // the new running max and leaves P(t) in p_hi and p_lo. A tile with
  // nothing to mask takes the short way.
  auto softmax = [&](int t) {
    const int k0 = t * kN;
    const bool plain = kv_mask == nullptr && k0 + kN <= Sk &&
                       !(causal && k0 + kN - 1 > q0 + 64 * wg);
    float mx[2];
    if (plain) {
      float raw[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < kN / 2; ++r) raw[(r / 2) % 2] = fmaxf(raw[(r / 2) % 2], acc[r]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        raw[i] = fmaxf(raw[i], __shfl_xor_sync(0xffffffffu, raw[i], 1));
        raw[i] = fmaxf(raw[i], __shfl_xor_sync(0xffffffffu, raw[i], 2));
        mx[i] = fmaxf(m[i], raw[i] * scale);
      }
      // acc becomes each p's exp2 argument
      const float neg[2] = {-mx[0] * kLog2e, -mx[1] * kLog2e};
#pragma unroll
      for (int r = 0; r < kN / 2; ++r) acc[r] = fmaf(acc[r], scale * kLog2e, neg[(r / 2) % 2]);
    } else {
      // causal, then padding: -1e30; keys past Sk: absent (p = 0). The
      // exp2 argument is (x - m) * log2e, not an fma: with x = m = -1e30
      // (a row with every key masked) the fma's rounding would not cancel.
      const float* valid = valid_s + (t % kStages) * kN;
      mx[0] = m[0];
      mx[1] = m[1];
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + col0 + c;
          const float state = valid[col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float x = acc[4 * j + 2 * i + c] * scale;
            if ((causal && qr0 + 8 * i < k0 + col) || state == 0.f) x = kNegInf;
            if (state < 0.f) x = -INFINITY;
            acc[4 * j + 2 * i + c] = x;
            mx[i] = fmaxf(mx[i], x);
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      }
#pragma unroll
      for (int r = 0; r < kN / 2; ++r) acc[r] = (acc[r] - mx[(r / 2) % 2]) * kLog2e;
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = exp2f((m[i] - mx[i]) * kLog2e);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
    // P as bf16 hi + lo fragments; l sums the f32 p
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f(acc[4 * j + 2 * i]);
        const float p1 = exp2f(acc[4 * j + 2 * i + 1]);
        l[i] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[j / 2][2 * (j % 2) + i] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[j / 2][2 * (j % 2) + i] = pack_bf16(p0 - hf.x, p1 - hf.y);
      }
#pragma unroll
    for (int ns = 0; ns < kSlabs; ++ns)
#pragma unroll
      for (int r = 0; r < 32; ++r) o[ns][r] *= alpha[(r / 2) % 2];
  };

  mbar_wait(bar_q, 0);
  mbar_wait(bar_full, 0);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait_all();
  pin(acc);
  softmax(0);
  // Iteration t runs P.V of tile t beside S of tile t + 1 and waits for
  // both inside the iteration: no wgmma is in flight across the loop's
  // back edge, nor across a spin loop or a warp-divergent path, around
  // which ptxas would serialize them.
  for (int t = 0; t + 1 < n_tiles; ++t) {
    // refill the stage released in the previous iteration; wait for tile t + 1
    if (warp == 0 && t >= 1 && t - 1 + kStages < n_tiles) load_tile_kv(t - 1 + kStages);
    mbar_wait(bar_full + 8 * ((t + 1) % kStages), ((t + 1) / kStages) & 1);
    pin(o);
    wgmma_fence();
    issue_pv(t);
    issue_scores(t + 1);
    wgmma_wait_all();
    pin(acc);
    pin(o);
    pin(p_hi);
    pin(p_lo);
    if (lane == 0) mbar_arrive(bar_empty + 8 * (t % kStages));
    softmax(t + 1);
  }
  pin(o);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_wait_all();
  pin(o);
  pin(p_hi);
  pin(p_lo);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = qr0 + 8 * i;
    if (qr >= Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const size_t at = elem(b, qr, h, Sq, H, D);
#pragma unroll
    for (int ns = 0; ns < kSlabs; ++ns)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kSlab * ns + 8 * j + col0;
        const float o0 = o[ns][4 * j + 2 * i] / l_safe;
        const float o1 = o[ns][4 * j + 2 * i + 1] / l_safe;
        *reinterpret_cast<__nv_bfloat162*>(out + at + col) = __floats2bfloat162_rn(o0, o1);
        *reinterpret_cast<float2*>(out_f32 + at + col) = make_float2(o0, o1);
      }
    if (lane % 4 == 0) lse[static_cast<size_t>(bh) * Sq + qr] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// K2: dK and dV. Replaces flash_attention.py _bwd_dkv_kernel (first call
// in _flash_backward). Grid (ceil(Sk/128), B*H): each block owns 128 key
// rows (64 per warpgroup), K and V resident in shared memory, and
// streams 64-row Q and dO tiles with their lse and delta through the
// TMA ring:
//   S^T = K Q^T, P^T = exp(S^T * scale - lse), dV += P^T dO,
//   dP^T = V dO^T, dS^T = P^T * (dP^T - delta), dK += dS^T Q * scale.
// S^T and dP^T are SS wgmma (n64, all operands K-major); dV and dK are
// RS wgmma with P^T and dS^T as bf16 register fragments and dO and Q
// MN-major. P and dS never touch shared memory; dK is scaled once at
// the end. dV's product runs while dP^T is computed.
// Bound at the main-path shape: operations (4 products per tile pair,
// twice K1's). The design rebuilds P from lse instead of storing it,
// reads each Q/dO tile once per 128 keys, and a causal block starts at
// its diagonal.
constexpr int kDkvRowsK = 128;
constexpr int kDkvRowsQ = 64;

template <int D>
struct DkvSmem {
  static constexpr int kKV = kDkvRowsK * D * 2;
  static constexpr int kQ = kDkvRowsQ * D * 2;
  static constexpr int k = 0;
  static constexpr int v = k + kKV;
  static constexpr int q = v + kKV;                    // + stage * kQ
  static constexpr int dout = q + kStages * kQ;        // + stage * kQ
  static constexpr int lse = dout + kStages * kQ;      // f32 [kStages][kDkvRowsQ]
  static constexpr int delta = lse + kStages * kDkvRowsQ * 4;
  static constexpr int bars = delta + kStages * kDkvRowsQ * 4;
  static constexpr int bytes = bars + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ kv_mask, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Sq, int Sk, int causal,
                     float scale) {
  using L = DkvSmem<D>;
  constexpr int kSlabs = D / kSlab;
  constexpr int kSteps = kDkvRowsQ / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);
  const uint32_t bar_kv = base + L::bars;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kDkvRowsK;
  const int n_q = (Sq + kDkvRowsQ - 1) / kDkvRowsQ;
  // causal: query tiles that end at or before this block's first key see none of it
  const int first_q = causal ? min(k0 / kDkvRowsQ, n_q) : 0;
  const int n_tiles = n_q - first_q;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);
      mbar_init(bar_empty + 8 * s, kBlockWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Run by warp 0: Q/dO tile t into its stage once both warpgroups have
  // released the tile before it there, with lse and delta written by the
  // warp's lanes (+inf and 0 past Sq, so that p = 0 there).
  auto load_tile_q = [&](int t) {
    const int s = t % kStages;
    if (t >= kStages) mbar_wait(bar_empty + 8 * s, ((t / kStages) - 1) & 1);
    const int q0 = (first_q + t) * kDkvRowsQ;
    for (int c = lane; c < kDkvRowsQ; c += 32) {
      const int qc = q0 + c;
      const size_t at = static_cast<size_t>(bh) * Sq + qc;
      lse_s[s * kDkvRowsQ + c] = qc < Sq ? lse[at] : INFINITY;
      delta_s[s * kDkvRowsQ + c] = qc < Sq ? delta[at] : 0.f;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kQ);
      tma_load_rows<D>(base + L::q + s * L::kQ, &tm_q, bar_full + 8 * s, h, q0, b, kDkvRowsQ);
      tma_load_rows<D>(base + L::dout + s * L::kQ, &tm_do, bar_full + 8 * s, h, q0, b,
                       kDkvRowsQ);
    } else {
      mbar_arrive(bar_full + 8 * s);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * L::kKV);
      tma_load_rows<D>(base + L::k, &tm_k, bar_kv, h, k0, b, kDkvRowsK);
      tma_load_rows<D>(base + L::v, &tm_v, bar_kv, h, k0, b, kDkvRowsK);
    }
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_tile_q(t);
  }

  // warpgroup wg: key rows k0 + 64*wg + [0, 64)
  const int wg = threadIdx.x / kWarpgroup;
  const int row = 64 * wg + 16 * (warp % 4) + lane / 4;  // and row + 8
  const int col0 = 2 * (lane % 4);
  const int kr0 = k0 + row;
  const uint32_t k_rows = base + L::k + 64 * wg * kRowBytes;
  const uint32_t v_rows = base + L::v + 64 * wg * kRowBytes;

  bool key_in[2], key_valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = kr0 + 8 * i;
    key_in[i] = kr < Sk;
    key_valid[i] = key_in[i] &&
                   (kv_mask == nullptr || kv_mask[static_cast<size_t>(b) * Sk + kr] > 0.f);
  }

  float dk_acc[kSlabs][32], dv_acc[kSlabs][32];
#pragma unroll
  for (int ns = 0; ns < kSlabs; ++ns)
#pragma unroll
    for (int r = 0; r < 32; ++r) dk_acc[ns][r] = dv_acc[ns][r] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int q0 = (first_q + t) * kDkvRowsQ;
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
    const uint32_t q_tile = base + L::q + s * L::kQ;
    const uint32_t do_tile = base + L::dout + s * L::kQ;
    const float* lse_t = lse_s + s * kDkvRowsQ;
    const float* delta_t = delta_s + s * kDkvRowsQ;

    // S^T = K Q^T: [64 keys x 64 queries]
    float sacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * kDkvRowsK * kRowBytes + (kk % 4) * 32;
      const int qoff = (kk / 4) * kDkvRowsQ * kRowBytes + (kk % 4) * 32;
      wgmma_ss_n64(sacc, desc_kmajor(k_rows + off), desc_kmajor(q_tile + qoff), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sacc);

    // P^T = exp(masked(S^T * scale) - lse), f32 in sacc, bf16 in p_frag
    uint32_t p_frag[kSteps][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + col0 + c;
          float x = sacc[4 * j + 2 * i + c] * scale;
          if ((causal && q0 + col < kr0 + 8 * i) || !key_valid[i]) x = kNegInf;
          const float p = exp2f((x - lse_t[col]) * kLog2e);
          sacc[4 * j + 2 * i + c] = key_in[i] ? p : 0.f;
        }
        p_frag[j / 2][2 * (j % 2) + i] = pack_bf16(sacc[4 * j + 2 * i], sacc[4 * j + 2 * i + 1]);
      }

    // dV += P^T dO, and meanwhile dP^T = V dO^T
    float dpacc[32];
    pin(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int ns = 0; ns < kSlabs; ++ns)
        wgmma_rs_n64(dv_acc[ns], p_frag[kk],
                     desc_mnmajor(do_tile + ns * kDkvRowsQ * kRowBytes + kk * 2 * kGroupBytes));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * kDkvRowsK * kRowBytes + (kk % 4) * 32;
      const int qoff = (kk / 4) * kDkvRowsQ * kRowBytes + (kk % 4) * 32;
      wgmma_ss_n64(dpacc, desc_kmajor(v_rows + off), desc_kmajor(do_tile + qoff), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(dv_acc);
    pin(dpacc);
    pin(p_frag);

    // dS^T = P^T * (dP^T - delta) as bf16 fragments
    uint32_t ds_frag[kSteps][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = 8 * j + col0;
        const float ds0 = sacc[4 * j + 2 * i] * (dpacc[4 * j + 2 * i] - delta_t[col]);
        const float ds1 = sacc[4 * j + 2 * i + 1] * (dpacc[4 * j + 2 * i + 1] - delta_t[col + 1]);
        ds_frag[j / 2][2 * (j % 2) + i] = pack_bf16(ds0, ds1);
      }

    // dK += dS^T Q
    pin(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int ns = 0; ns < kSlabs; ++ns)
        wgmma_rs_n64(dk_acc[ns], ds_frag[kk],
                     desc_mnmajor(q_tile + ns * kDkvRowsQ * kRowBytes + kk * 2 * kGroupBytes));
    wgmma_commit();
    wgmma_wait_all();
    pin(dk_acc);
    pin(ds_frag);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    // refill the stage of the tile before this one, which the other
    // warpgroup has most likely released by now
    if (warp == 0 && t >= 1 && t - 1 + kStages < n_tiles) load_tile_q(t - 1 + kStages);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = kr0 + 8 * i;
    if (kr >= Sk) continue;
    const size_t at = elem(b, kr, h, Sk, H, D);
#pragma unroll
    for (int ns = 0; ns < kSlabs; ++ns)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kSlab * ns + 8 * j + col0;
        *reinterpret_cast<__nv_bfloat162*>(dk + at + col) = __floats2bfloat162_rn(
            dk_acc[ns][4 * j + 2 * i] * scale, dk_acc[ns][4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
            __floats2bfloat162_rn(dv_acc[ns][4 * j + 2 * i], dv_acc[ns][4 * j + 2 * i + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// K3: dQ. Replaces flash_attention.py _bwd_dq_kernel (second call in
// _flash_backward). Grid (ceil(Sq/128), B*H): each block owns 128 query
// rows (64 per warpgroup), Q and dO resident in shared memory with lse
// and delta of each thread's two rows in registers, and streams the K/V
// tiles (128 keys at d=64, 64 at d=128, as K1) through the TMA ring:
//   S = Q K^T, P = exp(S * scale - lse), dP = dO V^T,
//   dS = P (dP - delta), dQ += dS K.
// S and dP are SS wgmma issued together (all operands K-major); dS
// becomes bf16 register fragments, the A operand of dQ += dS K, an RS
// wgmma with K MN-major (K2's dV += P^T dO with queries and keys
// swapped). dQ is scaled once at the end. No atomics: each block writes
// only its own rows.
// Bound at the main-path shape: operations (3 products per tile pair:
// S and dP are rebuilt, then dQ). P and dS never leave registers; each
// K/V tile is read once per 128 query rows; a causal block stops at its
// diagonal.
constexpr int kDqRowsQ = 128;

template <int D>
struct DqSmem {
  static constexpr int kRowsK = FwdSmem<D>::kRowsK;
  static constexpr int kQ = kDqRowsQ * D * 2;
  static constexpr int kKV = kRowsK * D * 2;
  static constexpr int q = 0;
  static constexpr int dout = q + kQ;
  static constexpr int k = dout + kQ;               // + stage * kKV
  static constexpr int v = k + kStages * kKV;       // + stage * kKV
  static constexpr int valid = v + kStages * kKV;   // f32 [kStages][kRowsK]
  static constexpr int bars = valid + kStages * kRowsK * 4;
  static constexpr int bytes = bars + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ kv_mask, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Sq,
                    int Sk, int causal, float scale) {
  using L = DqSmem<D>;
  constexpr int kN = L::kRowsK;
  constexpr int kSlabs = D / kSlab;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* valid_s = reinterpret_cast<float*>(smem + L::valid);
  const uint32_t bar_q = base + L::bars;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kDqRowsQ;
  int n_tiles = (Sk + kN - 1) / kN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kDqRowsQ, Sq) - 1) / kN + 1);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);
      mbar_init(bar_empty + 8 * s, kBlockWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Run by warp 0: K/V tile t into its stage once both warpgroups have
  // released the tile before it there, with its key validity (1 attend,
  // 0 padding, -1 past Sk) written by the warp's lanes, as in K1.
  auto load_tile_kv = [&](int t) {
    const int s = t % kStages;
    if (t >= kStages) mbar_wait(bar_empty + 8 * s, ((t / kStages) - 1) & 1);
    const int k0 = t * kN;
    for (int c = lane; c < kN; c += 32) {
      const int kc = k0 + c;
      float state = -1.f;
      if (kc < Sk)
        state = (kv_mask == nullptr || kv_mask[static_cast<size_t>(b) * Sk + kc] > 0.f) ? 1.f : 0.f;
      valid_s[s * kN + c] = state;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kKV);
      tma_load_rows<D>(base + L::k + s * L::kKV, &tm_k, bar_full + 8 * s, h, k0, b, kN);
      tma_load_rows<D>(base + L::v + s * L::kKV, &tm_v, bar_full + 8 * s, h, k0, b, kN);
    } else {
      mbar_arrive(bar_full + 8 * s);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * L::kQ);
      tma_load_rows<D>(base + L::q, &tm_q, bar_q, h, q0, b, kDqRowsQ);
      tma_load_rows<D>(base + L::dout, &tm_do, bar_q, h, q0, b, kDqRowsQ);
    }
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_tile_kv(t);
  }

  // warpgroup wg: query rows q0 + 64*wg + [0, 64)
  const int wg = threadIdx.x / kWarpgroup;
  const int row = 64 * wg + 16 * (warp % 4) + lane / 4;  // and row + 8
  const int col0 = 2 * (lane % 4);
  const int qr0 = q0 + row;
  const uint32_t q_rows = base + L::q + 64 * wg * kRowBytes;
  const uint32_t do_rows = base + L::dout + 64 * wg * kRowBytes;

  // lse and delta of this thread's rows: +inf and 0 past Sq, so that p = 0
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = qr0 + 8 * i;
    const size_t at = static_cast<size_t>(bh) * Sq + qr;
    row_lse[i] = qr < Sq ? lse[at] : INFINITY;
    row_delta[i] = qr < Sq ? delta[at] : 0.f;
  }

  float dq_acc[kSlabs][32];
#pragma unroll
  for (int ns = 0; ns < kSlabs; ++ns)
#pragma unroll
    for (int r = 0; r < 32; ++r) dq_acc[ns][r] = 0.f;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kN;
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
    const uint32_t k_tile = base + L::k + s * L::kKV;
    const uint32_t v_tile = base + L::v + s * L::kKV;

    // S = Q K^T and dP = dO V^T: [64 queries x kN keys] each
    float sacc[kN / 2], dpacc[kN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // k step kk: slab kk / 4, 32 bytes per step inside the 128-byte row
      const int qoff = (kk / 4) * kDqRowsQ * kRowBytes + (kk % 4) * 32;
      const int koff = (kk / 4) * kN * kRowBytes + (kk % 4) * 32;
      if constexpr (kN == 128)
        wgmma_ss_n128(sacc, desc_kmajor(q_rows + qoff), desc_kmajor(k_tile + koff), kk > 0);
      else
        wgmma_ss_n64(sacc, desc_kmajor(q_rows + qoff), desc_kmajor(k_tile + koff), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int qoff = (kk / 4) * kDqRowsQ * kRowBytes + (kk % 4) * 32;
      const int koff = (kk / 4) * kN * kRowBytes + (kk % 4) * 32;
      if constexpr (kN == 128)
        wgmma_ss_n128(dpacc, desc_kmajor(do_rows + qoff), desc_kmajor(v_tile + koff), kk > 0);
      else
        wgmma_ss_n64(dpacc, desc_kmajor(do_rows + qoff), desc_kmajor(v_tile + koff), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sacc);
    pin(dpacc);

    // dS = P (dP - delta) as bf16 fragments, P = exp(masked(S * scale) -
    // lse) in exp2, as K2: causal, then padding, -1e30; keys past Sk
    // absent (p = 0). A tile with nothing to mask skips the tests.
    const float* valid = valid_s + s * kN;
    const bool plain = kv_mask == nullptr && k0 + kN <= Sk &&
                       !(causal && k0 + kN - 1 > q0 + 64 * wg);
    uint32_t ds_frag[kN / 16][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + col0 + c;
          float x = sacc[4 * j + 2 * i + c] * scale;
          if (!plain) {
            const float state = valid[col];
            if ((causal && qr0 + 8 * i < k0 + col) || state == 0.f) x = kNegInf;
            if (state < 0.f) x = -INFINITY;
          }
          const float p = exp2f((x - row_lse[i]) * kLog2e);
          ds[c] = p * (dpacc[4 * j + 2 * i + c] - row_delta[i]);
        }
        ds_frag[j / 2][2 * (j % 2) + i] = pack_bf16(ds[0], ds[1]);
      }

    // dQ += dS K
    pin(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int ns = 0; ns < kSlabs; ++ns)
        wgmma_rs_n64(dq_acc[ns], ds_frag[kk],
                     desc_mnmajor(k_tile + ns * kN * kRowBytes + kk * 2 * kGroupBytes));
    wgmma_commit();
    wgmma_wait_all();
    pin(dq_acc);
    pin(ds_frag);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    // refill the stage of the tile before this one, which the other
    // warpgroup has most likely released by now
    if (warp == 0 && t >= 1 && t - 1 + kStages < n_tiles) load_tile_kv(t - 1 + kStages);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = qr0 + 8 * i;
    if (qr >= Sq) continue;
    const size_t at = elem(b, qr, h, Sq, H, D);
#pragma unroll
    for (int ns = 0; ns < kSlabs; ++ns)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kSlab * ns + 8 * j + col0;
        *reinterpret_cast<__nv_bfloat162*>(dq + at + col) = __floats2bfloat162_rn(
            dq_acc[ns][4 * j + 2 * i] * scale, dq_acc[ns][4 * j + 2 * i + 1] * scale);
      }
  }
}

// ---------------------------------------------------------------------------
// Host side.

// The 4-D map (D, H, S, B) of a [B, S, H, D] bf16 tensor, box (64, 1,
// rows, 1), 128-byte swizzle, rows past S zero-filled.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint32_t box[3] = {1, static_cast<uint32_t>(rows), 1};
  return make_map_4d(map, ptr, dims, box);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const float* mask,
               void* out, float* out_f32, float* lse, int B, int H, int Sq,
               int Sk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, B, Sq, H, D, kFwdRowsQ);
  if (rc == 0) rc = make_map(&tk, k, B, Sk, H, D, FwdSmem<D>::kRowsK);
  if (rc == 0) rc = make_map(&tv, v, B, Sk, H, D, FwdSmem<D>::kRowsK);
  if (rc != 0) return rc;
  const size_t smem = FwdSmem<D>::bytes;
  cudaError_t err = prepare(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kFwdRowsQ - 1) / kFwdRowsQ, B * H);
  flash_fwd_kernel<D><<<grid, kBlockThreads, smem, stream>>>(
      tq, tk, tv, mask, static_cast<bf16*>(out), out_f32, lse, H, Sq, Sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const float* mask,
               const void* dout, const float* lse, const float* delta, void* dk,
               void* dv, int B, int H, int Sq, int Sk, int causal, float scale,
               cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, q, B, Sq, H, D, kDkvRowsQ);
  if (rc == 0) rc = make_map(&tdo, dout, B, Sq, H, D, kDkvRowsQ);
  if (rc == 0) rc = make_map(&tk, k, B, Sk, H, D, kDkvRowsK);
  if (rc == 0) rc = make_map(&tv, v, B, Sk, H, D, kDkvRowsK);
  if (rc != 0) return rc;
  const size_t smem = DkvSmem<D>::bytes;
  cudaError_t err = prepare(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + kDkvRowsK - 1) / kDkvRowsK, B * H);
  flash_bwd_dkv_kernel<D><<<grid, kBlockThreads, smem, stream>>>(
      tq, tk, tv, tdo, mask, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq,
      Sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const float* mask,
              const void* dout, const float* lse, const float* delta, void* dq,
              int B, int H, int Sq, int Sk, int causal, float scale,
              cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, q, B, Sq, H, D, kDqRowsQ);
  if (rc == 0) rc = make_map(&tdo, dout, B, Sq, H, D, kDqRowsQ);
  if (rc == 0) rc = make_map(&tk, k, B, Sk, H, D, DqSmem<D>::kRowsK);
  if (rc == 0) rc = make_map(&tv, v, B, Sk, H, D, DqSmem<D>::kRowsK);
  if (rc != 0) return rc;
  const size_t smem = DqSmem<D>::bytes;
  cudaError_t err = prepare(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kDqRowsQ - 1) / kDqRowsQ, B * H);
  flash_bwd_dq_kernel<D><<<grid, kBlockThreads, smem, stream>>>(
      tq, tk, tv, tdo, mask, lse, delta, static_cast<bf16*>(dq), H, Sq, Sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// head_dim: 64 or 128. Any other value returns cudaErrorInvalidValue
// without launching.
#define FLASH_DISPATCH(LAUNCH, ...)                                  \
  do {                                                               \
    if (head_dim == 64) return LAUNCH<64>(__VA_ARGS__);              \
    if (head_dim == 128) return LAUNCH<128>(__VA_ARGS__);            \
    return static_cast<int>(cudaErrorInvalidValue);                  \
  } while (0)

extern "C" {

int flash_fwd(int head_dim, const void* q, const void* k, const void* v,
              const void* kv_mask, void* out, void* out_f32, void* lse, int B,
              int H, int Sq, int Sk, int causal, float scale, void* stream) {
  FLASH_DISPATCH(launch_fwd, q, k, v, static_cast<const float*>(kv_mask), out,
                 static_cast<float*>(out_f32), static_cast<float*>(lse), B, H,
                 Sq, Sk, causal, scale, static_cast<cudaStream_t>(stream));
}

int flash_bwd_dkv(int head_dim, const void* q, const void* k, const void* v,
                  const void* kv_mask, const void* dout, const void* lse,
                  const void* delta, void* dk, void* dv, int B, int H, int Sq,
                  int Sk, int causal, float scale, void* stream) {
  FLASH_DISPATCH(launch_dkv, q, k, v, static_cast<const float*>(kv_mask), dout,
                 static_cast<const float*>(lse), static_cast<const float*>(delta),
                 dk, dv, B, H, Sq, Sk, causal, scale, static_cast<cudaStream_t>(stream));
}

int flash_bwd_dq(int head_dim, const void* q, const void* k, const void* v,
                 const void* kv_mask, const void* dout, const void* lse,
                 const void* delta, void* dq, int B, int H, int Sq, int Sk,
                 int causal, float scale, void* stream) {
  FLASH_DISPATCH(launch_dq, q, k, v, static_cast<const float*>(kv_mask), dout,
                 static_cast<const float*>(lse), static_cast<const float*>(delta),
                 dq, B, H, Sq, Sk, causal, scale, static_cast<cudaStream_t>(stream));
}

const char* flash_error_string(int code) {
  if (code == kErrNoEncode) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (pointer not 16-byte aligned, or a "
           "shape out of range)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
