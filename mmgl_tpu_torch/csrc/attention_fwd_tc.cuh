// The mma.sync tensor-core forward body of K2 (attention_fwd.cu). K1, K4
// and K7 and the stats passes of K3, K5 and K8/K9 moved to the wgmma/TMA
// forward of allheads_wgmma.cuh; this body, with its bias form, stays the
// "before" reading of sweep_attention (csrc/sweep/k4_k7_shapes.cu).
//
// Computes what attention_fwd.cu's scalar body computes (xla_attention's
// math, mmgl_tpu/ops/attention.py:190-224):
//   out = softmax(q k^T * scale, masked logits = -1e30) v
// with causal masking aligned at the ends (key j visible to query i iff
// i + (sk - sq) >= j) and columns at or beyond sk weighted 0. A masked key is
// never skipped, so a fully masked row returns the mean of v over the sk
// keys. Rounding follows the Pallas _fwd_kernel (flash_attention.py:123-126):
// logits and softmax in fp32, p rounded to the input type for the PV
// product, which accumulates in fp32.
//
// The element type T is bf16 or fp16 (the m16n8k16 product has both forms;
// the fragments, the ldmatrix reads and the cp.async ring are the same).
// Every masked or hidden logit lives in fp32 registers only (-1e30, and -inf
// past sk): no tile in shared memory holds one, so fp16's range (65504) never
// meets them. P lies in [0, 1] (times the keep factor 1 / (1 - p) under
// dropout) before it is rounded to T; the output is rounded once at the end.
//
// What bounds it on this card: 4 D FLOPs per (query, key) pair over a few MB,
// so the tensor cores (989 TFLOP/s bf16) and, at these head dims, the fp32
// softmax between the two products; HBM (3.35 TB/s) is far off. The head
// dim D is a template: 64, 80 and 128 (the sweep's K4 before-readings),
// 64 in the bias form. D = 80 is five k16 steps: the last of S = Q K^T reads
// its K fragments with ldmatrix .x2. The design,
// FlashAttention-2's shape on mma.sync:
//   * one block of 4 warps per (64 query rows, head, batch), 16 rows a warp
//     (the shape is a template: launch_fwd_tc at the end names the one in
//     use); the Q tile is loaded once and kept as A fragments in registers;
//   * K and V tiles of 64 keys stream through a cp.async ring of shared
//     memory, read strided in place from the (B, S, H*D) layout, rows padded
//     to D + 8 so ldmatrix is conflict-free; the next tile's copy is in
//     flight while this one is computed, and one barrier a tile frees a
//     stage for the copy;
//   * S = Q K^T on mma.sync in fp32; the scale and masks are applied on each
//     accumulator element's own (row, column), the masks only on a tile with
//     a masked key (a bit a key in shared memory), on the causal diagonal or
//     past sk; the online softmax keeps each row's max (reduced over the
//     row's four lanes by two shuffles per tile) and a per-lane partial sum,
//     reduced once at the end, in log2 units (the scale and log2(e) in one
//     multiply) on the card's ex2 (a few ulp, far inside T's rounding),
//     and rescales O only where a row max moved;
//   * P, rounded to T in registers, is the A operand of P V as it stands:
//     it never touches shared memory;
//   * causal tiles past the diagonal end the loop once every row of the
//     block has seen a real logit (a block-wide vote), where they add exactly
//     0, and a warp skips such a tile on the same rule for its own rows;
//     blocks are issued longest first (most causal tiles).
// The stats-only form drops V, P V and the output, and writes the rows' max
// and sum: the same instructions for m and l as the full form.
//
// The bias form (kBias, kDropout; K7's before its wgmma body) computes
// xla_attention's math with the batch-shared (H, Sq, Sk) bias and
// attention-prob dropout:
//   out = (softmax(q k^T * scale + bias[h], masked = -1e30) * keep) v
// It is the same body with two additions, compiled out of K2:
//   * each (kRows x 64) tile of the bias (T or fp32) comes into the
//     cp.async ring beside K and V, and each S element takes its own
//     (row, key): in log2 units the logit is s (scale log2 e) + bias log2 e,
//     one FMA; the bias is added on every tile, the masks still only on
//     masked, diagonal and ragged tiles;
//   * dropout on the P fragment: the online softmax sums exp(logit - m)
//     without the keep factor, and P V takes P * factor rounded to T
//     (the Pallas order, flash_attention.py:618-621). The factors are
//     philox.cuh's bits: the four words of one Philox call fall on lanes c4
//     and c4 ^ 2 of a quad, so each lane makes one call per (row, 16-key
//     group) and the two swap words by one shuffle (philox_pair); each call
//     is made once per pass, ten rounds of integer work per four
//     probabilities, which at T5's shapes costs more than the products.
// The same instructions compute m and l in the full and the stats-only
// form.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace mmgl {

// kWarps warps of 16 query rows a block, kStages tiles of K and V (and
// the bias) in the ring; kMinBlocks blocks an SM, for the register budget;
// kBias, kDropout and the bias type TB select the bias form; T is the
// element type of q, k, v and out (bf16 or fp16)
template <int D, bool kStatsOnly, int kWarps, int kStages, int kMinBlocks,
          bool kBias = false, bool kDropout = false,
          typename TB = __nv_bfloat16, typename T = __nv_bfloat16>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
attention_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_mask, T* __restrict__ out,
                        float* __restrict__ row_max,
                        float* __restrict__ row_sum, int sq, int sk,
                        int heads, float scale, int causal,
                        BiasArgs<TB> ba) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kRows = 16 * kWarps;     // query rows a block
  constexpr int S = TcTile<D>::kStride;
  constexpr int kElems = TcTile<D>::kElems;
  constexpr int kKSteps = D / 16;        // k16 blocks of the head dim
  constexpr int kDBlocks = D / 8;        // n8 blocks of the head dim
  constexpr int kKeyBlocks = kTcTile / 8;  // n8 blocks of a key tile
  constexpr int kBS = bias_stride<kTcTile>();
  constexpr int kBiasElems = kRows * kBS;  // TB a bias tile
  constexpr bool kDrop = kDropout && !kStatsOnly;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // kRows rows
  T* k_s = q_s + kRows * S;              // [kStages][kElems]
  T* v_s = k_s + kStages * kElems;       // [kStages][kElems]
  // [kStages][kBiasElems], after V (or after K in the stats-only form)
  TB* b_s = reinterpret_cast<TB*>(kStatsOnly ? v_s : v_s + kStages * kElems);
  __shared__ uint32_t mask_s[kStages][2];  // a tile's key mask, a bit a key

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows g, g + 8
  const int c4 = lane & 3;  // accumulator columns 2 c4, 2 c4 + 1
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long rs = static_cast<long>(heads) * D;
  const T* q_rows = q + static_cast<long>(b) * sq * rs + h * D;
  const T* k_rows = k + static_cast<long>(b) * sk * rs + h * D;
  const T* v_rows = v + static_cast<long>(b) * sk * rs + h * D;
  const int* mask_row = kv_mask + static_cast<long>(b) * sk;

  const int shift = sk - sq;  // causal: query i sees key j iff i + shift >= j
  const int q_last = min(q0 + kRows, sq) - 1;
  const int n_tiles = (sk + kTcTile - 1) / kTcTile;
  // tiles from n_vis on are causally hidden from every row of the block
  const int n_vis =
      causal ? min(n_tiles, (q_last + shift) / kTcTile + 1) : n_tiles;
  const int row_first = q0 + 16 * warp;  // the warp's rows
  const int row0 = row_first + g;        // this lane's rows row0, row0 + 8
  // the bias rows of head h
  const TB* bias_rows =
      kBias ? ba.bias + static_cast<long>(h) * sq * ba.ld : nullptr;
  DropoutKey drop{};
  if constexpr (kDrop) drop = load_dropout_key(ba.seed, ba.threshold,
                                               ba.keep_inv);

  auto issue = [&](int t) {  // tile t's K and V (and bias) into its stage
    const int st = t % kStages;
    tile_async<D, kTcTile, kThreads>(k_s + st * kElems, k_rows, rs,
                                     t * kTcTile, sk, tid);
    if (!kStatsOnly) {
      tile_async<D, kTcTile, kThreads>(v_s + st * kElems, v_rows, rs,
                                       t * kTcTile, sk, tid);
    }
    if constexpr (kBias) {
      bias_tile_async<TB, kRows, kTcTile, kThreads>(
          b_s + st * kBiasElems, bias_rows, ba.ld, q0, sq, t * kTcTile, tid);
    }
  };
  auto key_ok = [&](int t) {  // thread tid < 64's key of tile t
    const int j = t * kTcTile + tid;
    return j < sk && mask_row[j] != 0;
  };

  tile_async<D, kRows, kThreads>(q_s, q_rows, rs, q0, sq, tid);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      issue(t);
      if (tid < kTcTile) store_mask_bits(mask_s[t], key_ok(t));
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // Q and tile 0
  __syncthreads();

  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    ldmatrix_x4(qf[kk], q_s + (16 * warp + (lane & 15)) * S + 16 * kk +
                            8 * (lane >> 4));
  }

  const float scale2 = scale * kLog2e;
  float o[kDBlocks][4];
#pragma unroll
  for (int i = 0; i < kDBlocks; ++i) {
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};  // the rows' running max, log2
  float l_run[2] = {0.f, 0.f};  // this lane's share of sum exp(logit - m)

  for (int t = 0; t < n_tiles; ++t) {
    // rows that have seen a real logit (or lie past sq)
    const bool rows_done = (row0 >= sq || m_run[0] > kNegInf) &&
                           (row0 + 8 >= sq || m_run[1] > kNegInf);
    if (t >= n_vis) {
      // Every key from here on is causally hidden from every row of the
      // block. Its logit is -1e30, which adds exactly 0 to a row that has
      // seen a real logit; a row whose visible keys are all masked still
      // needs it (its softmax is uniform over all sk keys).
      if (__syncthreads_and(rows_done)) break;
    }
    const int st = t % kStages;
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();  // and every warp is done with tile t - 1
    const int tp = t + kStages - 1;  // into tile t - 1's stage
    bool key_next = false;
    if (tp < n_tiles) {
      issue(tp);
      if (tid < kTcTile) key_next = key_ok(tp);
    }
    cp_async_commit();

    const int k0 = t * kTcTile;
    // the same rule for a warp: a tile hidden from all its rows adds
    // exactly 0 once each of them has seen a real logit
    const bool all_done = __all_sync(0xffffffffu, rows_done);
    if (!(causal && k0 > row_first + 15 + shift && all_done)) {
      // S = Q K^T: 16 rows x 64 keys a warp
      const T* ks = k_s + st * kElems;
      float s[kKeyBlocks][4];
#pragma unroll
      for (int nb = 0; nb < kKeyBlocks; ++nb) {
        s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKSteps; kk += 2) {
          const T* row = ks + (8 * nb + (lane & 7)) * S + 16 * kk;
          if (kk + 1 < kKSteps) {
            uint32_t kb[4];
            ldmatrix_x4(kb, row + 8 * (lane >> 3));
            mma_tc<T>(s[nb], qf[kk], kb[0], kb[1]);
            mma_tc<T>(s[nb], qf[kk + 1], kb[2], kb[3]);
          } else {  // the odd last k16 step (D = 80)
            uint32_t kb[2];
            ldmatrix_x2(kb, row + 8 * ((lane >> 3) & 1));
            mma_tc<T>(s[nb], qf[kk], kb[0], kb[1]);
          }
        }
      }

      // scale (and bias) and masks on each element's own (row, key), in
      // log2 units: x = logit log2(e), so exp(logit - m) = 2^(x - m2); a
      // masked logit is -1e30 here too; only a tile with a masked key, on
      // the warp's causal diagonal or past sk needs masks
      if constexpr (kBias) {
        // the bias of the lane's (row0 + 8 r, 8 nb + 2 c4 + e) at
        // s[nb][2 r + e], as x = s (scale log2 e) + bias log2 e
        const TB* bs = b_s + st * kBiasElems + (16 * warp + g) * kBS + 2 * c4;
#pragma unroll
        for (int nb = 0; nb < kKeyBlocks; ++nb) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 b2 = load2(bs + 8 * r * kBS + 8 * nb);
            s[nb][2 * r] =
                fmaf(s[nb][2 * r], scale2, __fmul_rn(b2.x, kLog2e));
            s[nb][2 * r + 1] =
                fmaf(s[nb][2 * r + 1], scale2, __fmul_rn(b2.y, kLog2e));
          }
        }
      }
      const uint32_t bits[2] = {mask_s[st][0], mask_s[st][1]};
      const bool edge = (bits[0] & bits[1]) != 0xffffffffu ||
                        k0 + kTcTile > sk ||
                        (causal && k0 + kTcTile - 1 > row_first + shift);
      float tile_max[2] = {-INFINITY, -INFINITY};
      if (edge) {
#pragma unroll
        for (int nb = 0; nb < kKeyBlocks; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * nb + 2 * c4 + e;
            const int j = k0 + col;
            const bool ok = (bits[nb >> 2] >> (col & 31)) & 1u;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float x = kBias ? s[nb][2 * r + e]
                              : __fmul_rn(s[nb][2 * r + e], scale2);
              if (!ok || (causal && row0 + 8 * r + shift < j)) x = kNegInf;
              if (j >= sk) x = -INFINITY;  // past sk: weight 0
              s[nb][2 * r + e] = x;
              tile_max[r] = fmaxf(tile_max[r], x);
            }
          }
        }
      } else {
#pragma unroll
        for (int nb = 0; nb < kKeyBlocks; ++nb) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (!kBias) s[nb][i] = __fmul_rn(s[nb][i], scale2);
            tile_max[i >> 1] = fmaxf(tile_max[i >> 1], s[nb][i]);
          }
        }
      }

      // online softmax: key k0 < sk, so tile_max and the new max are
      // finite; 2^-inf = 0 past sk, 2^(-1e30 - m2) = 0 at a masked key of a
      // row with a real logit, 2^0 = 1 at every key of a fully masked row
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_max[r] =
            fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
        tile_max[r] =
            fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
        const float m_new = fmaxf(m_run[r], tile_max[r]);
        alpha[r] = ex2(__fsub_rn(m_run[r], m_new));
        m_run[r] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < kKeyBlocks; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ex2(__fsub_rn(s[nb][i], m_run[i >> 1]));
          s[nb][i] = p;
          psum[i >> 1] = __fadd_rn(psum[i >> 1], p);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], alpha[r], psum[r]);

      if (!kStatsOnly) {
        // O = alpha O + P V, P rounded to T straight from the
        // accumulators; alpha = 1 where no row max of the warp moved
        const T* vs = v_s + st * kElems;
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < kDBlocks; ++i) {
            o[i][0] *= alpha[0];
            o[i][1] *= alpha[0];
            o[i][2] *= alpha[1];
            o[i][3] *= alpha[1];
          }
        }
#pragma unroll
        for (int kk = 0; kk < kTcTile / 16; ++kk) {
          if constexpr (kDrop) {
            // keys k0 + 16 kk + u: the lane holds u = 2 c4 + e (n8 block
            // 2 kk) and 8 + 2 c4 + e (2 kk + 1), the words hi and hi + 2 of
            // the calls with counter low bits 2 (c4 & 1) + e; its own call
            // is e = hi's, its quad partner c4 ^ 2 makes e = 1 - hi's
            const int hi = c4 >> 1;
            const unsigned int c0 =
                (static_cast<unsigned int>((k0 >> 4) + kk) << 2) |
                static_cast<unsigned int>(2 * (c4 & 1) + hi);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              unsigned int own[2], other[2];
              philox_pair(drop, c0, row0 + 8 * r, h, b, hi, 2, own, other);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const bool mine = e == hi;
                s[2 * kk][2 * r + e] *=
                    keep_factor(drop, mine ? own[0] : other[0]);
                s[2 * kk + 1][2 * r + e] *=
                    keep_factor(drop, mine ? own[1] : other[1]);
              }
            }
          }
          uint32_t pa[4];
          acc_to_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
          for (int db = 0; db < kDBlocks; db += 2) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 15)) * S + 8 * db +
                                      8 * (lane >> 4));
            mma_tc<T>(o[db], pa, vb[0], vb[1]);
            mma_tc<T>(o[db + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }

    if (tp < n_tiles && tid < kTcTile) {
      store_mask_bits(mask_s[tp % kStages], key_next);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 2));
    const int i = row0 + 8 * r;
    if (i >= sq) continue;
    if (row_max != nullptr && c4 == 0) {
      // kept apart, not one logsumexp: for a fully masked row m = -1e30 and
      // l = sk, and -1e30 + log(sk) would round back to -1e30; the max back
      // in the logits' units, -1e30 kept exact
      const long idx = (static_cast<long>(b) * heads + h) * sq + i;
      row_max[idx] = m_run[r] == kNegInf ? kNegInf : __fmul_rn(m_run[r], kLn2);
      row_sum[idx] = l;
    }
    if (!kStatsOnly) {
      const float inv = 1.f / l;
      T* dst = out + (static_cast<long>(b) * sq + i) * rs + h * D;
#pragma unroll
      for (int db = 0; db < kDBlocks; ++db) {
        store2(dst + 8 * db + 2 * c4, o[db][2 * r] * inv,
               o[db][2 * r + 1] * inv);
      }
    }
  }
}

// One launch of the body in a given shape over (B, Sq, H*D) tensors of T
// (bf16 or fp16). kStatsOnly: v and out are not read or written; row_max
// and row_sum must not be null. The bias form reads ba (BiasArgs).
template <int D, bool kStatsOnly, int kWarps, int kStages, int kMinBlocks,
          bool kBias = false, bool kDropout = false,
          typename TB = __nv_bfloat16, typename T = __nv_bfloat16>
cudaError_t launch_fwd_tc_as(const void* q, const void* k, const void* v,
                             const int* kv_mask, void* out, float* row_max,
                             float* row_sum, int batch, int sq, int sk,
                             int heads, float scale, int causal,
                             cudaStream_t stream,
                             BiasArgs<TB> ba = BiasArgs<TB>{}) {
  constexpr int kRows = 16 * kWarps;
  const size_t bytes =
      (kRows + (kStatsOnly ? 1 : 2) * kStages * kTcTile) *
          TcTile<D>::kStride * sizeof(T) +
      (kBias ? kStages * kRows * bias_stride<kTcTile>() * sizeof(TB) : 0);
  auto kernel = attention_fwd_tc_kernel<D, kStatsOnly, kWarps, kStages,
                                        kMinBlocks, kBias, kDropout, TB, T>;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kRows - 1) / kRows, heads, batch);
  kernel<<<grid, 32 * kWarps, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_mask, static_cast<T*>(out), row_max,
      row_sum, sq, sk, heads, scale, causal, ba);
  return cudaGetLastError();
}

// the body's blocks an SM for the register budget, by head dim: at 64 the
// fastest of the shapes timed at OPT-350M's (4, 2048, 16, 64) causal, K1's
// and K2's shapes on an H100 (PERF.md §6) is 4 warps, a 2-stage ring, 3
// blocks an SM (at most 170 registers a thread); 80 keeps it (the O
// accumulators grow from 32 to 40 registers); at 128 they take 64 and the
// Q fragments 32, so 2 blocks (255 registers), which the ring's 87,040
// bytes of shared memory allow too. The bias form (64 only) takes the same
// shape, also the fastest at T5-base's shapes (sweep/bias_shapes.cu); fp16
// takes the bf16 shape (the same instructions, another type).
template <int D>
constexpr int fwd_min_blocks() {
  return D <= 80 ? 3 : 2;
}

template <int D, bool kStatsOnly, bool kBias = false, bool kDropout = false,
          typename TB = __nv_bfloat16, typename T = __nv_bfloat16>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          const int* kv_mask, void* out, float* row_max,
                          float* row_sum, int batch, int sq, int sk,
                          int heads, float scale, int causal,
                          cudaStream_t stream,
                          BiasArgs<TB> ba = BiasArgs<TB>{}) {
  return launch_fwd_tc_as<D, kStatsOnly, 4, 2, fwd_min_blocks<D>(), kBias,
                          kDropout, TB, T>(
      q, k, v, kv_mask, out, row_max, row_sum, batch, sq, sk, heads, scale,
      causal, stream, ba);
}

}  // namespace mmgl
