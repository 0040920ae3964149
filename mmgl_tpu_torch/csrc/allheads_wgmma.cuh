// K1, K4 and K7's forward and K3's dK/dV and dQ passes on Hopper's warpgroup
// products (wgmma) and TMA: the forward of OPT's all-heads attention, of the
// per-head attention at any sq and sk, and of T5's bias and dropout
// attention, and K1's backward from the forward's row statistics
// (allheads_wgmma.cu, attention_fwd.cu, attention_bias_fwd.cu hold the
// entries; the forward's stats-only form is the stats pass of K3, K5 and
// K8/K9, in allheads_wgmma.cu, attention_bwd.cu and attention_bias_bwd.cu).
//
// Replaces _allheads_kernel_fwd (mmgl_tpu/ops/flash_attention.py:1283, via
// _allheads_fwd :1359), _allheads_kernel_bwd (:1307, via _allheads_vjp_bwd
// :1392), _fwd_kernel and _fwd_kernel_causal_stream (:92, :129, via _fwd
// :179) and _fwd_bias_kernel(_batched) (:594, :624, via _fwd_bias :768).
// The math is xla_attention's, as in the mma.sync bodies these replace
// (attention_fwd_tc.cuh, attention_bwd_tiles.cuh, which still serve K2, K5,
// K6 and K8/K9's tiles): masked logits -1e30, causal aligned at the ends, a
// fully masked row averaging V over the sk keys, and jax.grad's zero dS at
// masked logits. Every element's arithmetic is theirs too (logits in log2
// units on ex2, the online softmax's order within a tile, P and dS rounded
// to the element type before their products): only the tile widths and the
// products' engine change, so the tests' emulation of them
// (tests/test_torch_tc_numerics.py) takes the tile widths as parameters.
//
// The bias form (kBias, kDropout; K7) adds, as the mma.sync body's does: the
// batch-shared (H, Sq, Sk) bias (T or fp32, rows ld >= Sk elements apart, ld
// a multiple of 8) on each logit in log2 units with the scale,
// s (scale log2 e) + bias log2 e in one FMA; and attention-prob dropout on
// P after the softmax sums, P times the keep factor rounded to T for P V
// (the Pallas order, flash_attention.py:618-621). The producer brings each
// tile's bias (the block's rows x the tile's keys) into the ring beside K
// and V by TMA through a 3-D map over (Sk, Sq, H), 128-byte swizzled, so it
// arrives stages ahead; each consumer lane reads its accumulator elements'
// pairs from it, the swizzle spreading a warp's eight rows over distinct
// banks. (Read straight from device memory into the registers instead, the
// bias's latency stood in every tile's path: 2.3x the mma.sync body's time
// at T5's encoder, PERF.md §6.) Each warp's accumulator layout is
// mma.sync's, so philox.cuh's counter layout and its philox_pair exchange
// carry over: the same keep bits as the mma.sync body, as K8/K9 and
// ops/attention.py's dropout_bits regenerate them; the keep decisions are
// kept as a bit each, made after S = Q K^T lands (made while it was in
// flight instead, they gained nothing: PERF.md §6).
//
// What bounds them on this card: 4 D FLOPs a (query, key) pair forward and
// 10 D backward on the tensor cores (989 TFLOP/s bf16, reached only through
// wgmma), and the fp32 softmax between the products; with dropout, Philox's
// ten rounds of integer multiplies per four probabilities; HBM is far off.
// The design, FlashAttention-3's shape without its intra-warpgroup overlap:
//   * a block is kNC consumer warpgroups of 64 rows (queries forward and in
//     dQ, keys in dK/dV) and one producer warp. The producer warp is a lone
//     warp, not a warpgroup, so the consumers' register cap at one block an
//     SM is 65536 / (128 kNC + 32) (224 at kNC = 2) without setmaxnreg;
//   * the producer TMA-loads the block's own tile once (Q; K and V in
//     dK/dV; Q and dO in dQ) and streams the others through a kStages-deep
//     ring of shared memory with a full and an empty mbarrier a stage. It
//     decides which tiles the block visits (the skip rules below) and
//     writes each stage's tile index, key-mask bits (a bit a key) or query
//     statistics beside it; an index of -1 ends the consumers' loop;
//   * TMA reads every tile through a 4-D tensor map over (D, H, S, B) of the
//     (B, S, H * D) tensors, boxes of 64 x 1 x 64 x 1 swizzled by 128 bytes:
//     rows past S, in each batch entry, arrive as zeros, so any length
//     needs no bounds check in the products. D = 80 takes D = 128's two
//     boxes, the second half zeros: its products over the head dim (Q K^T,
//     V dO^T) run 5 k16 slices, not 8, but those with the head dim as their
//     N (P V, P^T dO, dS^T Q, dS K) run at N = 128, 1.6x the work of 80;
//   * S = Q K^T (and dP) with both operands from shared memory, K-major; the
//     elementwise work on the accumulators, whose per-warp layout is
//     mma.sync's (each warp 16 rows); P (or dS) rounded to T in registers is
//     the register A operand of the next product, whose B (V, dO, Q or K)
//     is read MN-major from the same tiles: no transpose pass;
//   * each warpgroup waits for its products before the elementwise work;
//     the library's shapes (FwdShape, DkdvShape, DqShape at the end)
//     take one or two warpgroups a block and let the SM's other blocks
//     fill the gaps;
//   * no atomics: each block owns its outputs, so K3 is the same from run to
//     run.
// The skip rules are the mma.sync bodies', at the warpgroup's rows: the
// forward ends past the causal diagonal once every row of the block has seen
// a real logit (its first valid key at or before the block's first row's
// diagonal), and a warpgroup skips a tile hidden from all its rows once
// they have; dQ skips a tile whose keys are all masked, or hidden from all
// the warpgroup's rows; dK/dV visits a query tile wholly before its keys, or
// any tile where its keys are all masked, only if a row of it is fully
// masked (m = -1e30: such a row feeds dV from every key).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace mmgl {
namespace wg {

using hopper::desc_k;
using hopper::desc_mn;
using hopper::fence_operands;
using hopper::mbar_arrive;
using hopper::mbar_arrive_tx;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::n_boxes;
using hopper::tile_bytes;
using hopper::tma_tile;
using hopper::Wgmma;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait_all;

// a body's shape: consumer warpgroups, the streamed tile's rows (keys, or
// queries in dK/dV), ring stages and blocks an SM for the register budget
template <int kNC_, int kTile_, int kStages_, int kMinBlocks_>
struct Shape {
  static constexpr int kNC = kNC_;
  static constexpr int kTile = kTile_;
  static constexpr int kStages = kStages_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kThreads = 128 * kNC_ + 32;
};

// the dynamic shared memory's start rounded up to 1024 bytes (the
// swizzle's period); the launches ask for 1024 bytes more than the tiles
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t off = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return raw + off;
}

// the A fragments (one k16 slice each) of a product's operand from an
// accumulator of n8 blocks, rounded to T: slice kk from blocks 2 kk and
// 2 kk + 1 (acc_to_a's order)
template <typename T, int N>
__device__ __forceinline__ void acc_to_frags(uint32_t (&a)[N / 16][4],
                                             const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[kk][i] = Tc<T>::pack(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// the key-mask bits of keys j0 .. j0 + 32 W - 1 (a ballot each 32; a key
// at or past sk is masked; a null mask masks none), by one warp
template <int W>
__device__ __forceinline__ void key_bits(uint32_t (&words)[W],
                                         const int* mask_row, int j0, int sk,
                                         int lane) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j = j0 + 32 * w + lane;
    const bool ok = j < sk && (mask_row == nullptr || mask_row[j] != 0);
    words[w] = __ballot_sync(0xffffffffu, ok);
  }
}

// the bias form: bias log2(e) at this lane's accumulator elements of a
// tile, element 4 nb + 2 r + e at row 16 (warp & 3) + g + 8 r of the
// warpgroup's rows and key 8 nb + 2 c4 + e of the tile, from the tile's
// bias in shared memory (tile: the warpgroup's first box), as TMA wrote
// it: boxes of 64 rows x 128 bytes, the 16-byte chunk c of row x at chunk
// c ^ (x % 8), one box a 128 bytes of keys. x % 8 = g, so a warp's eight
// rows read eight distinct chunks
template <int KT, typename TB>
__device__ __forceinline__ void bias_log2(float (&bl)[KT / 2],
                                          const unsigned char* tile,
                                          int warp4, int g, int c4) {
  constexpr int kPerBox = 128 / static_cast<int>(sizeof(TB));  // keys
#pragma unroll
  for (int nb = 0; nb < KT / 8; ++nb) {
    const int col = 8 * nb + 2 * c4;             // the pair's first key
    const int box = col / kPerBox;
    const int byte = (col % kPerBox) * static_cast<int>(sizeof(TB));
    const int off = box * hopper::kBoxBytes + (((byte >> 4) ^ g) << 4) +
                    (byte & 15);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp4 + g + 8 * r;
      const float2 v =
          load2(reinterpret_cast<const TB*>(tile + row * 128 + off));
      bl[4 * nb + 2 * r] = __fmul_rn(v.x, kLog2e);
      bl[4 * nb + 2 * r + 1] = __fmul_rn(v.y, kLog2e);
    }
  }
}

// the bias form: this lane's keep decisions of a tile from key k0, element
// i2 = 4 nb + 2 r + e at bit i2 % 32 of word i2 / 32. The elements of keys
// k0 + 16 kk + u are the mma.sync body's (attention_fwd_tc.cuh): the lane
// holds u = 2 c4 + e (n8 block 2 kk) and 8 + 2 c4 + e (2 kk + 1), the words
// hi and hi + 2 of the calls with counter low bits 2 (c4 & 1) + e; its own
// call is e = hi's, its quad partner c4 ^ 2 makes e = 1 - hi's. Called by
// the whole warp
template <int KT>
__device__ __forceinline__ void keep_bits(uint32_t (&keep)[KT / 64],
                                          const DropoutKey& drop, int k0,
                                          int row0, int h, int b, int c4) {
  const int hi = c4 >> 1;
#pragma unroll
  for (int w = 0; w < KT / 64; ++w) keep[w] = 0u;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
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
        const int i0 = 8 * kk + 2 * r + e;      // n8 block 2 kk
        const int i1 = 8 * kk + 4 + 2 * r + e;  // n8 block 2 kk + 1
        keep[i0 >> 5] |=
            static_cast<uint32_t>((mine ? own[0] : other[0]) <
                                  drop.threshold) << (i0 & 31);
        keep[i1 >> 5] |=
            static_cast<uint32_t>((mine ? own[1] : other[1]) <
                                  drop.threshold) << (i1 & 31);
      }
    }
  }
}

// ---- the forward (K1, K4, K7; in stats-only form the stats pass of K3, K5
// and K8/K9) ----------------------------------------------------------------

// the bias form's tile a stage (the block's rows x the tile's keys): boxes
// of 64 rows x 128 bytes, kNC x (KT bytes of keys / 128) of them
template <typename S, bool kBias, typename TB>
__host__ __device__ constexpr uint32_t bias_tile_bytes() {
  return kBias ? 64 * S::kNC * S::kTile * static_cast<uint32_t>(sizeof(TB))
               : 0;
}

template <int D, typename S, bool kBias = false, typename TB = float>
__host__ __device__ constexpr size_t fwd_smem(bool stats_only) {
  return 1024 + tile_bytes<D, 64 * S::kNC>() +
         S::kStages * ((stats_only ? 1 : 2) * tile_bytes<D, S::kTile>() +
                       bias_tile_bytes<S, kBias, TB>());
}

// out = softmax(q k^T scale (+ bias[h]), masked) (* keep) v over
// (B, S, H * D) tensors of T (bf16 or fp16); row_max and row_sum, (B, H, Sq)
// fp32, receive the rows' max (natural units) and sum where not null.
// kStatsOnly: no V, no out, no dropout. The bias form reads the (H, Sq, Sk)
// bias of TB through bias_map (hopper::make_bias_map) and the dropout key
// from ba (BiasArgs; its bias and ld unread).
template <int D, bool kStatsOnly, typename S, typename T, bool kBias = false,
          bool kDropout = false, typename TB = T>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
allheads_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap bias_map,
                    const int* __restrict__ kv_mask, T* __restrict__ out,
                    float* __restrict__ row_max, float* __restrict__ row_sum,
                    int sq, int sk, int heads, float scale, int causal,
                    BiasArgs<TB> ba) {
  constexpr int kNC = S::kNC;
  constexpr int KT = S::kTile;
  constexpr int ST = S::kStages;
  constexpr int DP = 64 * n_boxes(D);  // the head dim as the tiles hold it
  constexpr int kRows = 64 * kNC;      // query rows a block
  constexpr int kWords = KT / 32;
  constexpr bool kDrop = kDropout && !kStatsOnly;
  constexpr uint32_t kQBytes = tile_bytes<D, kRows>();
  constexpr uint32_t kKBytes = tile_bytes<D, KT>();
  constexpr uint32_t kBBytes = bias_tile_bytes<S, kBias, TB>();
  // the bias tile's boxes along the keys, and keys a box
  constexpr int kBiasBoxes = KT * static_cast<int>(sizeof(TB)) / 128;
  constexpr int kBiasBoxKeys = 128 / static_cast<int>(sizeof(TB));
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[ST], empty[ST];
  __shared__ uint32_t mask_s[ST][kWords];
  __shared__ int tile_s[ST];
  __shared__ int first_key_s;
  unsigned char* q_s = aligned_smem(smem_raw);
  unsigned char* k_s = q_s + kQBytes;       // [ST][kKBytes]
  unsigned char* v_s = k_s + ST * kKBytes;  // [ST][kKBytes]
  // [ST][kBBytes], after V (after K in the stats-only form)
  unsigned char* b_s = kStatsOnly ? v_s : v_s + ST * kKBytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int shift = sk - sq;  // causal: query i sees key j iff i + shift >= j
  const int q_last = min(q0 + kRows, sq) - 1;
  const int n_tiles = (sk + KT - 1) / KT;
  // tiles from n_vis on are causally hidden from every row of the block
  const int n_vis = causal ? min(n_tiles, (q_last + shift) / KT + 1)
                           : n_tiles;
  const int* mask_row =
      kv_mask != nullptr ? kv_mask + static_cast<long>(b) * sk : nullptr;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kNC);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();  // the barriers are initialised

  if (warp == 4 * kNC) {
    // ---- producer ----
    // tile i's copies into stage s, each on the stage's full barrier; the
    // producer arrives on it once it has written the tile's index and mask
    // bits, which it reads while the copies are in flight
    auto issue = [&](int i, int s) {
      if (lane != 0) return;
      mbar_expect_tx(&full[s], (kStatsOnly ? 1 : 2) * kKBytes + kBBytes);
      tma_tile<D, KT>(k_s + s * kKBytes, &k_map, &full[s], h, i * KT, b);
      if (!kStatsOnly) {
        tma_tile<D, KT>(v_s + s * kKBytes, &v_map, &full[s], h, i * KT, b);
      }
      if constexpr (kBias) {
        // box (w, x): rows q0 + 64 w.., keys i KT + x kBiasBoxKeys..
#pragma unroll
        for (int w = 0; w < kNC; ++w) {
#pragma unroll
          for (int x = 0; x < kBiasBoxes; ++x) {
            hopper::tma_load_3d(
                b_s + s * kBBytes + (w * kBiasBoxes + x) * hopper::kBoxBytes,
                &bias_map, &full[s], i * KT + x * kBiasBoxKeys, q0 + 64 * w,
                h);
          }
        }
      }
    };
    if (lane == 0) {
      mbar_arrive_tx(&q_full, kQBytes);
      tma_tile<D, kRows>(q_s, &q_map, &q_full, h, q0, b);
    }
    issue(0, 0);  // every block runs tile 0
    // the batch entry's first valid key (sk if none): where every row of
    // the block (or of a warpgroup) has seen a real logit; read while Q and
    // tile 0 are in flight, handed to the consumers with tile 0
    int first = sk;
    if (causal) {
      for (int j0 = 0; j0 < sk; j0 += 32) {
        uint32_t w[1];
        key_bits<1>(w, mask_row, j0, sk, lane);
        if (w[0] != 0u) {
          first = j0 + __ffs(w[0]) - 1;
          break;
        }
      }
    }
    if (lane == 0) first_key_s = first;
    // a hidden tile adds exactly 0 to a row that has seen a real logit; a
    // row whose visible keys are all masked still needs every tile (its
    // softmax is uniform over all sk keys)
    const int n_run = (!causal || first <= q0 + shift) ? n_vis : n_tiles;
    for (int i = 0; i <= n_run; ++i) {
      const int s = i % ST;
      if (i >= ST) mbar_wait(&empty[s], ((i / ST) - 1) & 1);
      if (i < n_run) {
        if (i > 0) issue(i, s);
        uint32_t words[kWords];
        key_bits<kWords>(words, mask_row, i * KT, sk, lane);
        if (lane == 0) {
#pragma unroll
          for (int w = 0; w < kWords; ++w) mask_s[s][w] = words[w];
          tile_s[s] = i;
          mbar_arrive(&full[s]);
        }
      } else if (lane == 0) {
        tile_s[s] = -1;
        mbar_arrive(&full[s]);
      }
      __syncwarp();
    }
    return;
  }

  // ---- consumers: warpgroup wgi, rows wg_first .. wg_first + 63 ----
  const int wgi = warp >> 2;
  const int g = lane >> 2;  // accumulator rows g, g + 8 of the warp's 16
  const int c4 = lane & 3;  // accumulator columns 2 c4, 2 c4 + 1 of an n8
  const int wg_first = q0 + 64 * wgi;
  const int wg_last = min(wg_first + 63, sq - 1);
  // every row of the warpgroup sees a real logit among its visible keys
  // (known from tile 0 on)
  bool wg_done = false;
  const int row_first = wg_first + 16 * (warp & 3);  // the warp's rows
  const int row0 = row_first + g;  // this lane's rows row0, row0 + 8
  const unsigned char* q_wg = q_s + 64 * wgi * 128;
  const float scale2 = scale * kLog2e;

  float o[kStatsOnly ? 1 : DP / 2];
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY};  // the rows' running max, log2
  float l_run[2] = {0.f, 0.f};  // this lane's share of sum exp(logit - m)
  DropoutKey drop{};
  if constexpr (kDrop) {
    drop = load_dropout_key(ba.seed, ba.threshold, ba.keep_inv);
  }
  mbar_wait(&q_full, 0);

  for (int i = 0;; ++i) {
    const int s = i % ST;
    mbar_wait(&full[s], (i / ST) & 1);
    const int t = tile_s[s];
    if (t < 0) break;
    if (i == 0) wg_done = first_key_s <= wg_first + shift;
    const int k0 = t * KT;
    const bool skip = wg_first >= sq ||
                      (causal && k0 > wg_last + shift && wg_done);
    if (!skip) {
      // S = Q K^T: 64 rows x KT keys a warpgroup, 16 rows a warp
      float sc[KT / 2];
      zero(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<KT, T>::template ss<0>(sc, desc_k<kRows>(q_wg, kk),
                                     desc_k<KT>(k_s + s * kKBytes, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(sc);
      uint32_t keep[kDrop ? KT / 64 : 1];
      if constexpr (kDrop) keep_bits<KT>(keep, drop, k0, row0, h, b, c4);
      if constexpr (kBias) {
        // x = s (scale log2 e) + bias log2 e, the bias from the stage
        float bl[KT / 2];
        bias_log2<KT, TB>(bl, b_s + s * kBBytes +
                                  wgi * kBiasBoxes * hopper::kBoxBytes,
                          warp & 3, g, c4);
#pragma unroll
        for (int i2 = 0; i2 < KT / 2; ++i2) {
          sc[i2] = fmaf(sc[i2], scale2, bl[i2]);
        }
      }

      // scale and masks on each element's own (row, key), in log2 units:
      // x = logit log2(e), so exp(logit - m) = 2^(x - m2); a masked logit
      // is -1e30 here too; only a tile with a masked key, on the warp's
      // causal diagonal or past sk needs masks
      uint32_t bits[kWords];
      uint32_t all = 0xffffffffu;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        bits[w] = mask_s[s][w];
        all &= bits[w];
      }
      const bool edge = all != 0xffffffffu || k0 + KT > sk ||
                        (causal && k0 + KT - 1 > row_first + shift);
      float tile_max[2] = {-INFINITY, -INFINITY};
      if (edge) {
#pragma unroll
        for (int nb = 0; nb < KT / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * nb + 2 * c4 + e;
            const int j = k0 + col;
            const bool ok = (bits[nb >> 2] >> (col & 31)) & 1u;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float x = kBias ? sc[4 * nb + 2 * r + e]
                              : __fmul_rn(sc[4 * nb + 2 * r + e], scale2);
              if (!ok || (causal && row0 + 8 * r + shift < j)) x = kNegInf;
              if (j >= sk) x = -INFINITY;  // past sk: weight 0
              sc[4 * nb + 2 * r + e] = x;
              tile_max[r] = fmaxf(tile_max[r], x);
            }
          }
        }
      } else {
#pragma unroll
        for (int i2 = 0; i2 < KT / 2; ++i2) {
          if (!kBias) sc[i2] = __fmul_rn(sc[i2], scale2);
          tile_max[(i2 >> 1) & 1] = fmaxf(tile_max[(i2 >> 1) & 1], sc[i2]);
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
      for (int i2 = 0; i2 < KT / 2; ++i2) {
        const int r = (i2 >> 1) & 1;
        const float p = ex2(__fsub_rn(sc[i2], m_run[r]));
        sc[i2] = p;
        psum[r] = __fadd_rn(psum[r], p);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], alpha[r], psum[r]);

      if constexpr (!kStatsOnly) {
        // O = alpha O + P V, P (times the keep factor) rounded to T straight
        // from the accumulators
#pragma unroll
        for (int i2 = 0; i2 < DP / 2; ++i2) o[i2] *= alpha[(i2 >> 1) & 1];
        if constexpr (kDrop) {
#pragma unroll
          for (int i2 = 0; i2 < KT / 2; ++i2) {
            sc[i2] *= (keep[i2 >> 5] >> (i2 & 31)) & 1u ? drop.keep_inv : 0.f;
          }
        }
        uint32_t pa[KT / 16][4];
        acc_to_frags<T, KT>(pa, sc);
        const unsigned char* vs = v_s + s * kKBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          Wgmma<DP, T>::template rs<1>(o, pa[kk], desc_mn<KT>(vs, kk));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(o);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const long rs = static_cast<long>(heads) * D;
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
      row_max[idx] =
          m_run[r] == kNegInf ? kNegInf : __fmul_rn(m_run[r], kLn2);
      row_sum[idx] = l;
    }
    if constexpr (!kStatsOnly) {
      const float inv = 1.f / l;
      T* dst = out + (static_cast<long>(b) * sq + i) * rs + h * D;
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        store2(dst + 8 * db + 2 * c4, o[4 * db + 2 * r] * inv,
               o[4 * db + 2 * r + 1] * inv);
      }
    }
  }
}

// ---- dK/dV (K3) --------------------------------------------------------

template <int D, typename S>
__host__ __device__ constexpr size_t dkdv_smem() {
  return 1024 + 2 * tile_bytes<D, 64 * S::kNC>() +
         2 * S::kStages * tile_bytes<D, S::kTile>();
}

// dK, dV for 64 kNC keys, over the query tiles of S::kTile rows that the
// producer visits: S^T = K Q^T and dP^T = V dO^T put the keys in the
// accumulators' rows, so P^T and dS^T are register A operands of
// dV += P^T dO and dK += dS^T Q
template <int D, typename S, typename T>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
allheads_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const int* __restrict__ kv_mask,
                     const float* __restrict__ row_max,
                     const float* __restrict__ row_sum,
                     const float* __restrict__ row_delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int heads,
                     float scale, int causal) {
  constexpr int kNC = S::kNC;
  constexpr int QT = S::kTile;
  constexpr int ST = S::kStages;
  constexpr int DP = 64 * n_boxes(D);
  constexpr int kRows = 64 * kNC;  // keys a block
  constexpr uint32_t kKvBytes = tile_bytes<D, kRows>();
  constexpr uint32_t kQBytes = tile_bytes<D, QT>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[ST], empty[ST];
  __shared__ __align__(8) float m_s[ST][QT];  // m log2(e)
  __shared__ __align__(8) float il_s[ST][QT];  // 1 / l
  __shared__ __align__(8) float dl_s[ST][QT];  // delta
  __shared__ int tile_s[ST], full_s[ST];
  __shared__ uint32_t kbits_s[2 * kNC];  // the block's key-mask bits
  unsigned char* k_s = aligned_smem(smem_raw);
  unsigned char* v_s = k_s + kKvBytes;
  unsigned char* q_s = v_s + kKvBytes;      // [ST][kQBytes]
  unsigned char* do_s = q_s + ST * kQBytes;  // [ST][kQBytes]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int shift = sk - sq;
  const int n_q = (sq + QT - 1) / QT;
  const long stat0 = (static_cast<long>(b) * heads + h) * sq;
  const int* mask_row =
      kv_mask != nullptr ? kv_mask + static_cast<long>(b) * sk : nullptr;

  if (tid == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4 * kNC);
    }
    hopper::fence_barrier_init();
  }
  if (warp < 2 * kNC) {
    uint32_t w[1];
    key_bits<1>(w, mask_row, k0 + 32 * warp, sk, lane);
    if (lane == 0) kbits_s[warp] = w[0];
  }
  __syncthreads();
  bool block_keys = false;
#pragma unroll
  for (int w = 0; w < 2 * kNC; ++w) block_keys |= kbits_s[w] != 0u;

  if (warp == 4 * kNC) {
    // ---- producer ----
    if (lane == 0) {
      mbar_arrive_tx(&kv_full, 2 * kKvBytes);
      tma_tile<D, kRows>(k_s, &k_map, &kv_full, h, k0, b);
      tma_tile<D, kRows>(v_s, &v_map, &kv_full, h, k0, b);
    }
    // query tiles before t_first lie wholly before the block's keys
    const int t_first =
        !block_keys ? n_q : causal ? max(0, k0 - shift) / QT : 0;
    int i = 0;
    for (int t = 0; t <= n_q; ++t) {
      bool full_tile = false;
      if (t < n_q) {
        // the tile holds a fully masked row (m = -1e30)
        bool any = false;
        for (int r = lane; r < QT; r += 32) {
          const int row = t * QT + r;
          any |= row < sq && row_max[stat0 + row] == kNegInf;
        }
        full_tile = __any_sync(0xffffffffu, any);
        if (!full_tile && t < t_first) continue;
      }
      const int s = i % ST;
      if (i >= ST) mbar_wait(&empty[s], ((i / ST) - 1) & 1);
      if (t < n_q) {
        // the rows' statistics, m in log2 units; rows past sq get
        // m = 1 / l = 0 (their q and dO are zeros, so their p and dS are
        // exactly 0)
        for (int r = lane; r < QT; r += 32) {
          const int row = t * QT + r;
          float m2 = 0.f, il = 0.f, dl = 0.f;
          if (row < sq) {
            m2 = __fmul_rn(row_max[stat0 + row], kLog2e);
            il = 1.f / row_sum[stat0 + row];
            dl = row_delta[stat0 + row];
          }
          m_s[s][r] = m2;
          il_s[s][r] = il;
          dl_s[s][r] = dl;
        }
        if (lane == 0) {
          tile_s[s] = t;
          full_s[s] = full_tile;
          mbar_arrive_tx(&full[s], 2 * kQBytes);
          tma_tile<D, QT>(q_s + s * kQBytes, &q_map, &full[s], h, t * QT, b);
          tma_tile<D, QT>(do_s + s * kQBytes, &do_map, &full[s], h, t * QT,
                          b);
        } else {
          mbar_arrive(&full[s]);
        }
      } else {
        if (lane == 0) tile_s[s] = -1;
        mbar_arrive(&full[s]);
      }
      ++i;
    }
    return;
  }

  // ---- consumers: warpgroup wgi, keys wg_first .. wg_first + 63 ----
  const int wgi = warp >> 2;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int wg_first = k0 + 64 * wgi;
  const bool wg_keys = (kbits_s[2 * wgi] | kbits_s[2 * wgi + 1]) != 0u;
  const int key_first = wg_first + 16 * (warp & 3);  // the warp's keys
  const int key0 = key_first + g;  // this lane's keys key0, key0 + 8
  bool key_valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int u = 16 * (warp & 3) + g + 8 * r;  // within the warpgroup
    key_valid[r] = (kbits_s[2 * wgi + (u >> 5)] >> (u & 31)) & 1u;
  }
  const unsigned char* k_wg = k_s + 64 * wgi * 128;
  const unsigned char* v_wg = v_s + 64 * wgi * 128;
  const float scale2 = scale * kLog2e;
  const float neg2 = __fmul_rn(kNegInf, kLog2e);

  float dk_acc[DP / 2], dv_acc[DP / 2];
  zero(dk_acc);
  zero(dv_acc);
  mbar_wait(&kv_full, 0);

  for (int i = 0;; ++i) {
    const int s = i % ST;
    mbar_wait(&full[s], (i / ST) & 1);
    const int t = tile_s[s];
    if (t < 0) break;
    const int q0 = t * QT;
    if (full_s[s] ||
        (wg_keys && !(causal && q0 + QT - 1 + shift < wg_first))) {
      const unsigned char* qs = q_s + s * kQBytes;
      const unsigned char* dos = do_s + s * kQBytes;
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x QT queries a warpgroup
      float st[QT / 2], dpt[QT / 2];
      zero(st);
      zero(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<QT, T>::template ss<0>(st, desc_k<kRows>(k_wg, kk),
                                     desc_k<QT>(qs, kk), 1);
        Wgmma<QT, T>::template ss<0>(dpt, desc_k<kRows>(v_wg, kk),
                                     desc_k<QT>(dos, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(st);
      fence_operands(dpt);

      // P^T and dS^T on each element's own (key, query): p = 2^(logit
      // log2(e) - m log2(e)) / l; a masked logit is -1e30, so a fully
      // masked row (m = -1e30) gets 1 / l there
      const bool diag = causal && q0 + shift < key_first + 15;
      const float* ms = m_s[s];
      const float* ls = il_s[s];
      const float* dls = dl_s[s];
#pragma unroll
      for (int n = 0; n < QT / 8; ++n) {
        const int col = 8 * n + 2 * c4;
        const float2 m2 = *reinterpret_cast<const float2*>(ms + col);
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + col);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j >> 1;
          const int e = j & 1;
          const bool allowed =
              key_valid[r] && !(diag && q0 + col + e + shift < key0 + 8 * r);
          const float m2e = e ? m2.y : m2.x;
          const float x = allowed ? fmaf(st[4 * n + j], scale2, -m2e)
                                  : __fsub_rn(neg2, m2e);
          const float p = ex2(x) * (e ? l2.y : l2.x);
          st[4 * n + j] = p;
          dpt[4 * n + j] =
              allowed ? p * (dpt[4 * n + j] - (e ? d2.y : d2.x)) * scale
                      : 0.f;
        }
      }

      // dV += P^T dO, dK += dS^T Q: the k16 slices are query slices
      uint32_t pa[QT / 16][4], da[QT / 16][4];
      acc_to_frags<T, QT>(pa, st);
      acc_to_frags<T, QT>(da, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        Wgmma<DP, T>::template rs<1>(dv_acc, pa[kk], desc_mn<QT>(dos, kk));
        Wgmma<DP, T>::template rs<1>(dk_acc, da[kk], desc_mn<QT>(qs, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(dv_acc);
      fence_operands(dk_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const long rs = static_cast<long>(heads) * D;
  const long k_off = static_cast<long>(b) * sk * rs + h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key0 + 8 * r;
    if (kj >= sk) continue;
    const long row = k_off + static_cast<long>(kj) * rs;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      const int c = 8 * db + 2 * c4;
      store2(dk + row + c, dk_acc[4 * db + 2 * r], dk_acc[4 * db + 2 * r + 1]);
      store2(dv + row + c, dv_acc[4 * db + 2 * r], dv_acc[4 * db + 2 * r + 1]);
    }
  }
}

// ---- dQ (K3) -----------------------------------------------------------

template <int D, typename S>
__host__ __device__ constexpr size_t dq_smem() {
  return 1024 + 2 * tile_bytes<D, 64 * S::kNC>() +
         2 * S::kStages * tile_bytes<D, S::kTile>();
}

// dQ for 64 kNC query rows, over the key tiles of S::kTile up to the
// block's causal limit that hold a valid key: S = Q K^T, dP = dO V^T, dS
// in registers as the A operand of dQ += dS K
template <int D, typename S, typename T>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
allheads_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const int* __restrict__ kv_mask,
                   const float* __restrict__ row_max,
                   const float* __restrict__ row_sum,
                   const T* __restrict__ out, const T* __restrict__ dout,
                   float* __restrict__ row_delta, T* __restrict__ dq,
                   int sq, int sk, int heads, float scale, int causal) {
  constexpr int kNC = S::kNC;
  constexpr int KT = S::kTile;
  constexpr int ST = S::kStages;
  constexpr int DP = 64 * n_boxes(D);
  constexpr int kRows = 64 * kNC;  // query rows a block
  constexpr int kWords = KT / 32;
  constexpr uint32_t kQBytes = tile_bytes<D, kRows>();
  constexpr uint32_t kKBytes = tile_bytes<D, KT>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qd_full, full[ST], empty[ST];
  __shared__ uint32_t mask_s[ST][kWords];
  __shared__ int tile_s[ST];
  unsigned char* q_s = aligned_smem(smem_raw);
  unsigned char* do_s = q_s + kQBytes;
  unsigned char* k_s = do_s + kQBytes;      // [ST][kKBytes]
  unsigned char* v_s = k_s + ST * kKBytes;  // [ST][kKBytes]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int shift = sk - sq;
  const int q_last = min(q0 + kRows, sq) - 1;
  const int n_k = (sk + KT - 1) / KT;
  // dS = 0 past the diagonal for every row of the block
  const int n_tiles = causal ? min(n_k, (q_last + shift) / KT + 1) : n_k;
  const int* mask_row =
      kv_mask != nullptr ? kv_mask + static_cast<long>(b) * sk : nullptr;

  if (tid == 0) {
    mbar_init(&qd_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kNC);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kNC) {
    // ---- producer ----
    if (lane == 0) {
      mbar_arrive_tx(&qd_full, 2 * kQBytes);
      tma_tile<D, kRows>(q_s, &q_map, &qd_full, h, q0, b);
      tma_tile<D, kRows>(do_s, &do_map, &qd_full, h, q0, b);
    }
    int i = 0;
    for (int t = 0; t <= n_tiles; ++t) {
      uint32_t words[kWords];
      if (t < n_tiles) {
        key_bits<kWords>(words, mask_row, t * KT, sk, lane);
        uint32_t any = 0u;
#pragma unroll
        for (int w = 0; w < kWords; ++w) any |= words[w];
        if (any == 0u) continue;  // every key masked: dS = 0
      }
      const int s = i % ST;
      if (i >= ST) mbar_wait(&empty[s], ((i / ST) - 1) & 1);
      if (lane == 0) {
        if (t < n_tiles) {
#pragma unroll
          for (int w = 0; w < kWords; ++w) mask_s[s][w] = words[w];
          tile_s[s] = t;
          mbar_arrive_tx(&full[s], 2 * kKBytes);
          tma_tile<D, KT>(k_s + s * kKBytes, &k_map, &full[s], h, t * KT, b);
          tma_tile<D, KT>(v_s + s * kKBytes, &v_map, &full[s], h, t * KT, b);
        } else {
          tile_s[s] = -1;
          mbar_arrive(&full[s]);
        }
      }
      __syncwarp();
      ++i;
    }
    return;
  }

  // ---- consumers: warpgroup wgi, rows wg_first .. wg_first + 63 ----
  const int wgi = warp >> 2;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int wg_first = q0 + 64 * wgi;
  const int wg_last = min(wg_first + 63, sq - 1);
  const int row_first = wg_first + 16 * (warp & 3);
  const int row0 = row_first + g;
  const float scale2 = scale * kLog2e;
  // this lane's rows' statistics, m in log2 units; a row past sq gets
  // dS = 0 (inv_l = 0) and is not written. delta = rowsum(dO * o) in the
  // delta pass's order (attention_delta_kernel: lane c4 of a row's quad
  // sums the D / 4 dims from c4 D / 4 on, then two shuffles), written out
  // for the dK/dV pass, which runs after this one
  const long rs = static_cast<long>(heads) * D;
  float m_i[2], inv_l[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    m_i[r] = inv_l[r] = 0.f;
    float part = 0.f;
    if (i < sq) {
      const long idx = (static_cast<long>(b) * heads + h) * sq + i;
      m_i[r] = __fmul_rn(row_max[idx], kLog2e);
      inv_l[r] = 1.f / row_sum[idx];
      const long off = (static_cast<long>(b) * sq + i) * rs + h * D +
                       (D / 4) * c4;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        part = dot4(load4(dout + off + 4 * c), load4(out + off + 4 * c),
                    part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    delta[r] = i < sq ? part : 0.f;
    if (i < sq && c4 == 0) {
      row_delta[(static_cast<long>(b) * heads + h) * sq + i] = part;
    }
  }
  const unsigned char* q_wg = q_s + 64 * wgi * 128;
  const unsigned char* do_wg = do_s + 64 * wgi * 128;
  float dq_acc[DP / 2];
  zero(dq_acc);
  mbar_wait(&qd_full, 0);

  for (int i = 0;; ++i) {
    const int s = i % ST;
    mbar_wait(&full[s], (i / ST) & 1);
    const int t = tile_s[s];
    if (t < 0) break;
    const int k0 = t * KT;
    if (wg_first < sq && !(causal && k0 > wg_last + shift)) {
      const unsigned char* ks = k_s + s * kKBytes;
      const unsigned char* vs = v_s + s * kKBytes;
      // S = Q K^T and dP = dO V^T: 64 rows x KT keys a warpgroup
      float sc[KT / 2], dp[KT / 2];
      zero(sc);
      zero(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<KT, T>::template ss<0>(sc, desc_k<kRows>(q_wg, kk),
                                     desc_k<KT>(ks, kk), 1);
        Wgmma<KT, T>::template ss<0>(dp, desc_k<kRows>(do_wg, kk),
                                     desc_k<KT>(vs, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(sc);
      fence_operands(dp);

      uint32_t bits[kWords];
      uint32_t all = 0xffffffffu;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        bits[w] = mask_s[s][w];
        all &= bits[w];
      }
      // a masked key (or one past sk), or a key causally hidden from a row
      // of the warp, somewhere in the tile
      const bool edge = all != 0xffffffffu ||
                        (causal && k0 + KT - 1 > row_first + shift);
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j >> 1;
          const int col = 8 * n + 2 * c4 + (j & 1);
          const float ds = ex2(fmaf(sc[4 * n + j], scale2, -m_i[r])) *
                           inv_l[r] * (dp[4 * n + j] - delta[r]) * scale;
          dp[4 * n + j] =
              (!edge || (((bits[col >> 5] >> (col & 31)) & 1u) &&
                         !(causal && row0 + 8 * r + shift < k0 + col)))
                  ? ds
                  : 0.f;
        }
      }

      // dQ += dS K: the k16 slices are key slices
      uint32_t da[KT / 16][4];
      acc_to_frags<T, KT>(da, dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        Wgmma<DP, T>::template rs<1>(dq_acc, da[kk], desc_mn<KT>(ks, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(dq_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i >= sq) continue;
    T* dst = dq + (static_cast<long>(b) * sq + i) * rs + h * D;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      store2(dst + 8 * db + 2 * c4, dq_acc[4 * db + 2 * r],
             dq_acc[4 * db + 2 * r + 1]);
    }
  }
}

// ---- launches ----------------------------------------------------------

namespace {

// The shared-memory attributes of kernel kKernel, set once a device. The
// flag is a static of a function with internal linkage, so each library
// built from this header keeps its own: a function-local static of a
// template with external linkage is one object in the whole process (the
// dynamic linker unifies such "unique" symbols across libraries), and a
// second library (the sweep's) would skip setting its own kernels'.
template <auto kKernel>
cudaError_t smem_once(size_t bytes) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0ull && (done.load(std::memory_order_relaxed) & bit) != 0ull) {
    return cudaSuccess;
  }
  err = set_smem(kKernel, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace

// the tensor maps of one call: q, k, v, dO (dO unused by the forward), and
// the bias form's bias
struct Maps {
  CUtensorMap q, k, v, dout, bias;
};

// q and k as tensor maps, and v and dO where not null (dtype a
// mmgl::DType code: bf16 or fp16), each (batch, seq, heads * d)
inline cudaError_t make_maps(Maps* m, const void* q, const void* k,
                             const void* v, const void* dout, int dtype,
                             int batch, int sq, int sk, int heads, int d) {
  using hopper::make_map;
  cudaError_t err = make_map(&m->q, q, dtype, batch, sq, heads, d);
  if (err == cudaSuccess) err = make_map(&m->k, k, dtype, batch, sk, heads, d);
  if (err == cudaSuccess && v != nullptr) {
    err = make_map(&m->v, v, dtype, batch, sk, heads, d);
  }
  if (err == cudaSuccess && dout != nullptr) {
    err = make_map(&m->dout, dout, dtype, batch, sq, heads, d);
  }
  return err;
}

// the bias form reads m.bias (make_bias_map) and ba's dropout key
template <int D, bool kStatsOnly, typename S, typename T, bool kBias = false,
          bool kDropout = false, typename TB = T>
cudaError_t launch_fwd(const Maps& m, const int* kv_mask, void* out,
                       float* row_max, float* row_sum, int batch, int sq,
                       int sk, int heads, float scale, int causal,
                       cudaStream_t stream, BiasArgs<TB> ba = BiasArgs<TB>{}) {
  constexpr size_t bytes = fwd_smem<D, S, kBias, TB>(kStatsOnly);
  auto kernel = allheads_fwd_kernel<D, kStatsOnly, S, T, kBias, kDropout, TB>;
  const cudaError_t err = smem_once<
      allheads_fwd_kernel<D, kStatsOnly, S, T, kBias, kDropout, TB>>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + 64 * S::kNC - 1) / (64 * S::kNC), heads, batch);
  kernel<<<grid, S::kThreads, bytes, stream>>>(
      m.q, m.k, m.v, kBias ? m.bias : m.q, kv_mask, static_cast<T*>(out),
      row_max, row_sum, sq, sk, heads, scale, causal, ba);
  return cudaGetLastError();
}

template <int D, typename S, typename T>
cudaError_t launch_dkdv(const Maps& m, const int* kv_mask,
                        const float* row_max, const float* row_sum,
                        const float* row_delta, void* dk, void* dv, int batch,
                        int sq, int sk, int heads, float scale, int causal,
                        cudaStream_t stream) {
  constexpr size_t bytes = dkdv_smem<D, S>();
  auto kernel = allheads_dkdv_kernel<D, S, T>;
  const cudaError_t err = smem_once<allheads_dkdv_kernel<D, S, T>>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + 64 * S::kNC - 1) / (64 * S::kNC), heads, batch);
  kernel<<<grid, S::kThreads, bytes, stream>>>(
      m.q, m.k, m.v, m.dout, kv_mask, row_max, row_sum, row_delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, heads, scale, causal);
  return cudaGetLastError();
}

template <int D, typename S, typename T>
cudaError_t launch_dq(const Maps& m, const int* kv_mask, const float* row_max,
                      const float* row_sum, const void* out,
                      const void* dout, float* row_delta, void* dq,
                      int batch, int sq, int sk, int heads, float scale,
                      int causal, cudaStream_t stream) {
  constexpr size_t bytes = dq_smem<D, S>();
  auto kernel = allheads_dq_kernel<D, S, T>;
  const cudaError_t err = smem_once<allheads_dq_kernel<D, S, T>>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + 64 * S::kNC - 1) / (64 * S::kNC), heads, batch);
  kernel<<<grid, S::kThreads, bytes, stream>>>(
      m.q, m.k, m.v, m.dout, kv_mask, row_max, row_sum,
      static_cast<const T*>(out), static_cast<const T*>(dout), row_delta,
      static_cast<T*>(dq), sq, sk, heads, scale, causal);
  return cudaGetLastError();
}

// dQ (which also writes delta, row_delta's batch * heads * sq floats),
// then dK/dV from that delta, on the caller's stream
template <int D, typename KvS, typename QS, typename T>
cudaError_t launch_bwd(const Maps& m, const int* kv_mask,
                       const float* row_max, const float* row_sum,
                       const void* out, const void* dout, float* row_delta,
                       void* dq, void* dk, void* dv, int batch, int sq,
                       int sk, int heads, float scale, int causal,
                       cudaStream_t stream) {
  const cudaError_t err =
      launch_dq<D, QS, T>(m, kv_mask, row_max, row_sum, out, dout, row_delta,
                          dq, batch, sq, sk, heads, scale, causal, stream);
  if (err != cudaSuccess) return err;
  return launch_dkdv<D, KvS, T>(m, kv_mask, row_max, row_sum, row_delta, dk,
                                dv, batch, sq, sk, heads, scale, causal,
                                stream);
}

// the shapes the library launches, by head dim: the fastest of
// mmgl_tpu_torch/sweep_attention.py --allheads at K1's and K3's shapes and
// of --k4-k7 at K4's and K7's on an H100 (PERF.md §6); fp16 takes bf16's.
// One consumer warpgroup of 64 rows and tiles of 64 throughout; at 64 two
// dK/dV and three dQ blocks an SM, past 64 the dK and dV accumulators (64
// registers each) leave room for one dK/dV block. FwdShape serves every
// forward (K1, K4, K7) and the stats passes of K3, K5 and K8/K9: a
// forward and the stats pass that stands in for it must share one shape,
// so that the row stats they write are the same bits
template <int D>
using FwdShape = Shape<1, 64, 2, 2>;
template <int D>
using DkdvShape = Shape<1, 64, 2, D == 64 ? 2 : 1>;
template <int D>
using DqShape = Shape<1, 64, 2, D == 64 ? 3 : 2>;

}  // namespace wg
}  // namespace mmgl
