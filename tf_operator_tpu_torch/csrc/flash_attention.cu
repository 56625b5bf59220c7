// Flash attention for Hopper (sm_90a): forward (K1), dK/dV (K2), dQ (K3).
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (tf_operator_tpu_torch/ops/kernels.py). Every
// kernel launches on the caller's stream, allocates nothing, and each
// entry point returns cudaGetLastError() after its launch.
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
// Design shared by the three kernels. One thread block of 256 threads
// owns one 64-row tile of the (b*h) slice it works on and loops over
// the other operand's 64-row tiles inside the block: the loop takes the
// place of the TPU grid's sequential ("arbitrary") axis, since Hopper's
// blocks run in parallel and in no order. Tiles are staged in shared
// memory as f32 with a row pitch of D+1 so that the 16 threads reading
// 16 different rows at one column hit 16 different banks. Each thread
// holds a 4x4 piece of the 64x64 score tile (rows 4*tr+i, columns
// tc+16*j) and 4 x D/16 accumulators; the 16 threads of a row group sit
// in one half-warp, so row reductions are 4 xor-shuffles.
//
// What bounds them on the H100, and what the design does about it.
// The work is 2 (K1), 4 (K2) or 3 (K3) products of 64-wide tiles per
// tile pair. At the main-path shape (b=32, s=512, h=12, d=64, bf16) the
// card's least time is set by bytes for K1 (its inputs and outputs at
// 3.35 TB/s take about as long as its 2.6e10 FLOP at 989 TFLOP/s) and
// by operations for K2 and K3. These first kernels run the products on
// the CUDA cores in f32, as the TPU kernels do, each FMA fed from
// shared memory: that operand traffic, not device memory, is what
// bounds them as written, and they do not touch the tensor cores, so
// they sit far above the bound (PERF.md). The design keeps what flash
// attention exists for: no [s, s] matrix in device memory, each tile
// pair read once per block, the softmax statistics in registers.
// bf16 wgmma from shared memory, TMA loads and warp specialisation are
// the next step.
//
// Traps carried over from the TPU kernels (tf_operator_tpu/ops/pallas/
// flash_attention.py) on purpose:
// - Both products run in f32 on f32 copies of q, k, v (the reference
//   upcasts at :125-132, :152-156, :276-285); p stays f32 in p.v.
// - K1 applies the scale to q in f32 before the product (:125); K2 and
//   K3 apply it to the scores (:285, :357).
// - Masked scores are -1e30, not -inf (:68). A row whose keys are all
//   padded then gets uniform weights and a finite lse, exactly like the
//   reference; -inf would give NaN. l is clamped at 1e-30 (:168).
//   Keys past the end of the sequence (the ragged last tile) are not
//   masked but absent: their probability is exactly 0.
// - Causal: key tiles past the diagonal are skipped (:158-164,
//   :311-316, :379-382); within a tile the test is q_pos >= k_pos on
//   absolute positions.
// - The key-padding mask is [b, sk] f32, read at batch row bh / H
//   (:203-211); "attend" is mask > 0.
// One deliberate departure: the reference takes delta = rowsum(dO * O)
// from O rounded to the input dtype (:399-402). In bf16 that delta no
// longer equals sum_k p dp as K2/K3 compute it in f32, the rows of ds
// stop summing to zero, and the error lands on dQ and dK along the
// mean key/query: in BERT-base's last layers it took the query/key
// gradients far further from an f32 step than the plain bf16 path's
// (PERF.md). K1 therefore also writes O in f32 (out_f32) and the
// wrapper takes delta from that.
// TPU artifacts not carried over: the 128-lane head padding for d=64
// (:630-637), the [*, seq, 1] row-statistic layout (:103-108), and the
// 512/1024 VMEM blocks with _pick_block's multiple-of-128 rule
// (:542-569): the kernels mask the ragged edge themselves and take any
// sequence length.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of Q and of K/V per tile
constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kScorePitch = kTile + 1;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ size_t elem(int b, int s, int h, int S, int H, int D) {
  return ((static_cast<size_t>(b) * S + s) * H + h) * static_cast<size_t>(D);
}

// Stage rows r0..r0+63 of one (b, h) slice into shared memory as f32,
// times `mul`; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const bf16* __restrict__ src,
                                          int b, int h, int r0, int S, int H,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = r0 + r;
    float x = 0.f;
    if (s < S) x = __bfloat162float(src[elem(b, s, h, S, H, D) + d]) * mul;
    dst[r * (D + 1) + d] = x;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Score of (query row qr, key column kc) after causal and padding
// masking, the reference's order: causal, then padding, both -1e30.
__device__ __forceinline__ float masked(float s, int qr, int kc, bool causal,
                                       float key_valid) {
  if (causal && qr < kc) s = kNegInf;
  if (!(key_valid > 0.f)) s = kNegInf;
  return s;
}

// ---------------------------------------------------------------------------
// K1: forward. Replaces tf_operator_tpu/ops/pallas/flash_attention.py
// _fwd_kernel (launched by _flash_forward). Grid (q tiles, B*H).
// out = softmax(q k^T * scale + mask) v with the online softmax (running
// max m, sum l, f32 accumulator); lse = m + log(max(l, 1e-30)).
// Bound at the main-path shape: bytes (q, k, v in; out and lse out), a
// little above its 2 products at the bf16 peak. The f32 copy of out
// (see "One deliberate departure" above) is this port's extra traffic,
// not part of that bound. The design reads each K/V tile once per
// 64-row Q tile and keeps S and P in shared memory and registers,
// never in device memory.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ kv_mask,
                 bf16* __restrict__ out, float* __restrict__ out_f32,
                 float* __restrict__ lse, int H, int Sq, int Sk, int causal,
                 float scale) {
  constexpr int P = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * P;
  float* Vs = Ks + kTile * P;
  float* Ps = Vs + kTile * P;  // [64][kScorePitch]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kTile;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  load_tile<D>(Qs, q, b, h, q0, Sq, H, scale);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Sk + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kTile, Sq) - 1) / kTile + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<D>(Ks, k, b, h, k0, Sk, H, 1.f);
    load_tile<D>(Vs, v, b, h, k0, Sk, H, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(tr * 4 + i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tc + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = k0 + tc + 16 * j;
      const bool present = kc < Sk;
      const float valid = (kv_mask != nullptr && present) ? kv_mask[b * Sk + kc] : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = present ? masked(s[i][j], q0 + tr * 4 + i, kc, causal, valid) : -INFINITY;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(tr * 4 + i) * kScorePitch + tc + 16 * j] = p;
        rs += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pa[4], vb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(tr * 4 + i) * kScorePitch + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vb[c] = Vs[kk * P + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + tr * 4 + i;
    if (qr >= Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const size_t base = elem(b, qr, h, Sq, H, D);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float o = acc[i][c] / l_safe;
      out[base + tc + 16 * c] = __float2bfloat16(o);
      out_f32[base + tc + 16 * c] = o;
    }
    if (tc == 0) lse[static_cast<size_t>(bh) * Sq + qr] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// K2: dK and dV. Replaces flash_attention.py _bwd_dkv_kernel (first call
// in _flash_backward). Grid (kv tiles, B*H): each block owns one K/V
// tile and streams the Q, dO, lse, delta tiles:
//   p = exp(q k^T * scale - lse), dV += p^T dO,
//   ds = p * (dO v^T - delta),    dK += ds^T q * scale.
// Each block writes only its own rows of dK and dV: no atomics, so the
// gradients are the same from run to run.
// Bound at the main-path shape: operations (4 products per tile pair,
// twice K1's). The design rebuilds P from lse instead of storing it and
// streams Q/dO tiles past a resident K/V tile; a causal block starts at
// its diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ kv_mask,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Sq, int Sk, int causal,
                     float scale) {
  constexpr int P = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * P;
  float* Qs = Vs + kTile * P;
  float* dOs = Qs + kTile * P;
  float* Pt = dOs + kTile * P;          // [key][query], kScorePitch
  float* dSt = Pt + kTile * kScorePitch;
  float* lse_s = dSt + kTile * kScorePitch;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kTile;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  load_tile<D>(Ks, k, b, h, k0, Sk, H, 1.f);
  load_tile<D>(Vs, v, b, h, k0, Sk, H, 1.f);

  // this thread's key rows: validity from the padding mask
  float key_valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kc = k0 + tr * 4 + i;
    key_valid[i] = (kv_mask != nullptr && kc < Sk) ? kv_mask[b * Sk + kc] : 1.f;
  }

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (Sq + kTile - 1) / kTile;
  // causal: query tiles that end at or before this key tile's start see none of it
  const int first_q = causal ? k0 / kTile : 0;

  for (int t = first_q; t < n_q; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    load_tile<D>(Qs, q, b, h, q0, Sq, H, 1.f);
    load_tile<D>(dOs, dout, b, h, q0, Sq, H, 1.f);
    if (threadIdx.x < kTile) {
      const int qr = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qr < Sq ? lse[static_cast<size_t>(bh) * Sq + qr] : 0.f;
      delta_s[threadIdx.x] = qr < Sq ? delta[static_cast<size_t>(bh) * Sq + qr] : 0.f;
    }
    __syncthreads();

    // [key row][query column] pieces of s and dp = dO v^T
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qb[4], ob[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = Ks[(tr * 4 + i) * P + d];
        va[i] = Vs[(tr * 4 + i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qb[j] = Qs[(tc + 16 * j) * P + d];
        ob[j] = dOs[(tc + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
          dp[i][j] = fmaf(va[i], ob[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = k0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = tc + 16 * j, qr = q0 + ql;
        float p = 0.f;
        if (qr < Sq && kc < Sk)
          p = expf(masked(s[i][j] * scale, qr, kc, causal, key_valid[i]) - lse_s[ql]);
        Pt[(tr * 4 + i) * kScorePitch + ql] = p;
        dSt[(tr * 4 + i) * kScorePitch + ql] = p * (dp[i][j] - delta_s[ql]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pa[4], da[4], ob[DC], qb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = Pt[(tr * 4 + i) * kScorePitch + qq];
        da[i] = dSt[(tr * 4 + i) * kScorePitch + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        ob[c] = dOs[qq * P + tc + 16 * c];
        qb[c] = Qs[qq * P + tc + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(pa[i], ob[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(da[i], qb[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kc = k0 + tr * 4 + i;
    if (kc >= Sk) continue;
    const size_t base = elem(b, kc, h, Sk, H, D);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[base + tc + 16 * c] = __float2bfloat16(dk_acc[i][c] * scale);
      dv[base + tc + 16 * c] = __float2bfloat16(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dQ. Replaces flash_attention.py _bwd_dq_kernel (second call in
// _flash_backward). Grid (q tiles, B*H): each block owns one Q/dO tile
// and streams the K/V tiles: dQ += ds k * scale. No atomics.
// Bound at the main-path shape: operations (3 products per tile pair:
// S and dP are rebuilt, then dQ). The design keeps lse and delta of its
// rows in registers and stops a causal block at its diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ kv_mask,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int H,
                    int Sq, int Sk, int causal, float scale) {
  constexpr int P = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * P;
  float* Ks = dOs + kTile * P;
  float* Vs = Ks + kTile * P;
  float* dS = Vs + kTile * P;  // [query][key], kScorePitch

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kTile;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  load_tile<D>(Qs, q, b, h, q0, Sq, H, 1.f);
  load_tile<D>(dOs, dout, b, h, q0, Sq, H, 1.f);

  float row_lse[4], row_delta[4], dq_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + tr * 4 + i;
    row_lse[i] = qr < Sq ? lse[static_cast<size_t>(bh) * Sq + qr] : 0.f;
    row_delta[i] = qr < Sq ? delta[static_cast<size_t>(bh) * Sq + qr] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[i][c] = 0.f;
  }

  int n_tiles = (Sk + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kTile, Sq) - 1) / kTile + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<D>(Ks, k, b, h, k0, Sk, H, 1.f);
    load_tile<D>(Vs, v, b, h, k0, Sk, H, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(tr * 4 + i) * P + d];
        oa[i] = dOs[(tr * 4 + i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Ks[(tc + 16 * j) * P + d];
        vb[j] = Vs[(tc + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = k0 + tc + 16 * j;
      const bool present = kc < Sk;
      const float valid = (kv_mask != nullptr && present) ? kv_mask[b * Sk + kc] : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = q0 + tr * 4 + i;
        float p = 0.f;
        if (present && qr < Sq)
          p = expf(masked(s[i][j] * scale, qr, kc, causal, valid) - row_lse[i]);
        dS[(tr * 4 + i) * kScorePitch + tc + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float da[4], kb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = dS[(tr * 4 + i) * kScorePitch + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kb[c] = Ks[kk * P + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq_acc[i][c] = fmaf(da[i], kb[c], dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + tr * 4 + i;
    if (qr >= Sq) continue;
    const size_t base = elem(b, qr, h, Sq, H, D);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[base + tc + 16 * c] = __float2bfloat16(dq_acc[i][c] * scale);
  }
}

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kScorePitch);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kScorePitch + 2 * kTile);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kScorePitch);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const float* mask,
               void* out, float* out_f32, float* lse, int B, int H, int Sq,
               int Sk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = prepare(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v),
      mask, static_cast<bf16*>(out), out_f32, lse, H, Sq, Sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const float* mask,
               const void* dout, const float* lse, const float* delta, void* dk,
               void* dv, int B, int H, int Sq, int Sk, int causal, float scale,
               cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  cudaError_t err = prepare(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + kTile - 1) / kTile, B * H);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v),
      mask, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Sq, Sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const float* mask,
              const void* dout, const float* lse, const float* delta, void* dq,
              int B, int H, int Sq, int Sk, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  cudaError_t err = prepare(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v),
      mask, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), H, Sq,
      Sk, causal, scale);
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
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
