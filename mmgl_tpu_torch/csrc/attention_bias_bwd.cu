// Backward of the bias/dropout attention (K7) for Hopper (sm_90a): the port
// of the two Pallas kernels that compute it, with one schedule.
//
// Replaces
//   mmgl_bias_bwd -> _bwd_bias_kernel_batched (mmgl_tpu/ops/flash_attention.py:843,
//                    pallas_call in _bwd_bias_batched :942, :955): K8, the
//                    T5 decoder shapes in training (self 128x128 causal with
//                    bias, cross 128x512 without);
//                    _bwd_bias_kernel (:689, pallas_call in _bwd_bias :984,
//                    :1010): K9, the encoder's 512x512 with bias.
// The two compute one function; the TPU chose between them by VMEM size and
// grid order (:921-940), neither of which exists here.
//
// Given q, k, v, the key mask, the bias, the dropout seed, the forward
// output o and its gradient dO, with m the keep factor (1/keep or 0, the
// forward's, regenerated from the seed by philox.cuh):
//   P       = softmax(q k^T * scale + bias, masked logits = -1e30)  (fp32)
//   dV      = (P m)^T dO
//   delta   = rowsum(dO * o)          (= sum_j P m dP, o includes the dropout)
//   dlogits = P * (m * (dO v^T) - delta), and 0 wherever the logit was masked
//   dQ      = dlogits k * scale,  dK = dlogits^T q * scale
//   dbias[h] = sum_b dlogits[b, h]    (only when a bias was given)
// The zero at masked logits follows jax.grad of xla_attention (the JAX
// package's reference): its jnp.where passes no gradient to a masked logit,
// nor to the bias there. The Pallas kernels keep one; it differs only for a
// fully masked row, whose P is uniform over all sk keys: such a row feeds
// dV and gives no dQ, dK or dbias (K3's rule, attention_bwd.cu).
//
// Two bodies, chosen by the input dtype as K1-K6's are, each on the
// caller's stream with no atomics:
//   * bf16, fp16 (mmgl_bias_bwd_tc): K3's wgmma/TMA bodies
//     (allheads_wgmma.cuh) in their bias form (kBias, kDropout), in
//     DkdvShape and BiasDqShape (two dQ blocks an SM, not three: below
//     ptxas's spills), from K7's saved row max and sum or, where none are
//     given, from K7's wgmma forward in its stats-only form (the same
//     instructions for m and l, so the gradients are the same bits either
//     way). The tensor maps of q, k, v, dO and the bias are encoded once
//     for every launch. Then the two bodies, in one grid
//     (allheads_dq_dkdv_kernel) where their blocks fill at most two waves
//     of the SMs' slots (T5's decoder shapes, whose launches alone would
//     half-fill the card), else in two launches, dQ then dK/dV (T5's
//     encoders, where one grid ran slower: sweep_attention --k8-k9):
//       * dQ: one block per (64 query rows, head, batch), looping over
//         the key tiles up to the block's causal limit that hold a valid
//         key; it computes delta = rowsum(dO * o) in its prologue, and
//         writes its fp32 dlogits into the partial (zeros on every tile it
//         skips);
//       * dK/dV: one block per (64 keys, head, batch), looping over the
//         query tiles that can see its keys, plus earlier tiles that hold
//         a fully masked row; in one grid its producer makes each tile's
//         delta in dQ's order (the same bits), so no block waits on dQ,
//         else it reads dQ's; keys are its accumulator rows, so a Philox
//         call's words fall on lanes lane and lane ^ 16.
//     Each streamed tile brings its bias tile into the TMA ring (dQ: the
//     block's rows x the tile's keys; dK/dV: the tile's rows x the
//     block's keys, read transposed); P times the keep factor and dS are
//     rounded to the input type for their products, where the Pallas
//     kernels round them, and dbias comes from the fp32 dlogits; then the
//     reduction (4 below). With no bias and no dropout it runs K3's own
//     two launches (dQ in DqShape), so K8/K9 then equals K3 given the same
//     stats bit for bit.
//   * fp32 (mmgl_bias_bwd): K3's three scalar launches plus the reduction:
//     1. stats: per query row the softmax max m and sum l, and delta.
//     2. dK/dV: one block per (64 keys, head, batch), looping over query
//        tiles. A key's four threads draw the keep factors of four query
//        rows with one Philox call each and pass them round by shuffles.
//     3. dQ: one block per (64 query rows, head, batch), looping over key
//        tiles; it also writes dlogits into the fp32 partial. A row's four
//        threads each make the Philox call of one key group of a 16-key
//        block and pass the words round by shuffles.
//   4. dbias[h, i, j] = sum over b of the partials, in the order
//      b = 0..B-1, so the result is the same from run to run. The partial
//      (B, H, Sq, Sk) is the scratch: B * H * Sq * Sk * 4 bytes, 50,331,648
//      at the encoder shape (4, 12, 512, 512); the tensor-core dQ body
//      writes all of it, the scalar one skips the causally hidden tiles,
//      so the wrapper zeroes it there. Without a bias no dbias is written.
// Layout and dtypes as in attention_bwd.cu: BSHD strided in place, outputs
// in the input dtype, dbias in the bias dtype, every sum in fp32.
//
// What bounds it on this card: 10 D FLOPs per (query, key) pair (14 D as
// computed: dQ recomputes S and dP) on the tensor cores, 12.6 GFLOP at
// the encoder shape, 13 us at 989 TFLOP/s; the partial's 4 bytes a pair,
// written once and read once by the reduction (~100 MB at the encoder
// shape, ~30 us of HBM at 3.35 TB/s), which a block per (query tile, head)
// looping over the batch would remove at the cost of 96 blocks for 132 SMs;
// and with dropout two regenerations of the keep factors, one in each body,
// each call made once a pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "allheads_wgmma.cuh"
#include "common.cuh"
#include "philox.cuh"

namespace {

// the head dim the bias kernels take: T5's d_kv at every size the two
// packages know (K1-K6 also take 80 and 128)
constexpr int kD = 64;

using mmgl::axpy4;
using mmgl::dot4;
using mmgl::kNegInf;
using mmgl::load1;
using mmgl::load4;
using mmgl::store1;
using mmgl::store4;

constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kThreads = 256;      // four threads per row
constexpr int kKStride = kD + 4;   // padded K row of the stats pass
constexpr int kChunks = kD / 16;   // float4 chunks a thread owns (4)

// 1. per query row: max m, sum l of exp(logit - m), delta = rowsum(dO * o)
template <typename T, typename TB>
__global__ void __launch_bounds__(kThreads)
bias_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const int* __restrict__ kv_mask,
                      const TB* __restrict__ bias, const T* __restrict__ out,
                      const T* __restrict__ dout, float* __restrict__ row_max,
                      float* __restrict__ row_sum,
                      float* __restrict__ row_delta, int sq, int sk,
                      int heads, float scale, int causal) {
  __shared__ __align__(16) float k_tile[kTile][kKStride];
  __shared__ int mask_tile[kTile];

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int q0 = blockIdx.x * kTile;
  const int qi = q0 + row;
  const bool row_ok = qi < sq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long rs = static_cast<long>(heads) * kD;
  const T* q_rows = q + static_cast<long>(b) * sq * rs + h * kD;
  const T* k_rows = k + static_cast<long>(b) * sk * rs + h * kD;
  const T* o_rows = out + static_cast<long>(b) * sq * rs + h * kD;
  const T* do_rows = dout + static_cast<long>(b) * sq * rs + h * kD;
  const int* mask_row = kv_mask + static_cast<long>(b) * sk;
  const TB* bias_row =
      (bias != nullptr && row_ok)
          ? bias + (static_cast<long>(h) * sq + qi) * sk
          : nullptr;

  float qr[kD];
#pragma unroll
  for (int c = 0; c < kD / 4; ++c) {
    const float4 x = row_ok ? load4(q_rows + qi * rs + 4 * c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * c + 0] = x.x;
    qr[4 * c + 1] = x.y;
    qr[4 * c + 2] = x.z;
    qr[4 * c + 3] = x.w;
  }

  float m_run = -INFINITY;
  float l_run = 0.f;
  const int shift = sk - sq;
  const int q_last = min(q0 + kTile, sq) - 1;

  for (int k0 = 0; k0 < sk; k0 += kTile) {
    if (causal && k0 > q_last + shift) {
      if (__syncthreads_and(!row_ok || m_run > kNegInf)) break;
    }
    __syncthreads();
    for (int e = tid; e < kTile * (kD / 4); e += kThreads) {
      const int r = e >> 4;
      const int c = e & 15;
      const int j = k0 + r;
      const float4 kx = (j < sk) ? load4(k_rows + j * rs + 4 * c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      store4(&k_tile[r][4 * c], kx);
    }
    if (tid < kTile) {
      mask_tile[tid] = (k0 + tid < sk) ? mask_row[k0 + tid] : 0;
    }
    __syncthreads();

    float s[16];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = sub + 4 * i;
      const int j = k0 + r;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kD / 4; ++c) {
        const float4 kx = *reinterpret_cast<const float4*>(&k_tile[r][4 * c]);
        dot = fmaf(qr[4 * c + 0], kx.x, dot);
        dot = fmaf(qr[4 * c + 1], kx.y, dot);
        dot = fmaf(qr[4 * c + 2], kx.z, dot);
        dot = fmaf(qr[4 * c + 3], kx.w, dot);
      }
      float logit = dot * scale;
      if (bias_row != nullptr && j < sk) logit += load1(bias_row + j);
      if (mask_tile[r] == 0 || (causal && qi + shift < j)) logit = kNegInf;
      s[i] = (j < sk) ? logit : -INFINITY;
      tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_run, tile_max);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      psum += (s[i] == -INFINITY) ? 0.f : expf(s[i] - m_new);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * expf(m_run - m_new) + psum;
    m_run = m_new;
  }

  float delta = 0.f;
  if (row_ok) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long off = qi * rs + 16 * sub + 4 * c;
      delta = dot4(load4(do_rows + off), load4(o_rows + off), delta);
    }
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta += __shfl_xor_sync(0xffffffffu, delta, 2);
  if (row_ok && sub == 0) {
    const long idx = (static_cast<long>(b) * heads + h) * sq + qi;
    row_max[idx] = m_run;
    row_sum[idx] = l_run;
    row_delta[idx] = delta;
  }
}

// 2. dK, dV for 64 keys, looping over the query tiles
template <typename T, typename TB>
__global__ void __launch_bounds__(kThreads)
bias_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ kv_mask,
                     const TB* __restrict__ bias,
                     const long long* __restrict__ seed,
                     const T* __restrict__ dout,
                     const float* __restrict__ row_max,
                     const float* __restrict__ row_sum,
                     const float* __restrict__ row_delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int heads,
                     float scale, int causal, unsigned int threshold,
                     float keep_inv) {
  __shared__ __align__(16) float q_tile[kTile][kD];
  __shared__ __align__(16) float do_tile[kTile][kD];
  __shared__ float m_tile[kTile];
  __shared__ float inv_l_tile[kTile];
  __shared__ float delta_tile[kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int k0 = blockIdx.x * kTile;
  const int kj = k0 + row;
  const bool key_ok = kj < sk;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long rs = static_cast<long>(heads) * kD;
  const T* q_rows = q + static_cast<long>(b) * sq * rs + h * kD;
  const T* do_rows = dout + static_cast<long>(b) * sq * rs + h * kD;
  const long k_off = static_cast<long>(b) * sk * rs + h * kD;
  const long stat0 = (static_cast<long>(b) * heads + h) * sq;
  // this key's bias column, bias[h, i, kj] at bias_col[i * sk]
  const TB* bias_col =
      (bias != nullptr && key_ok)
          ? bias + static_cast<long>(h) * sq * sk + kj
          : nullptr;
  const mmgl::DropoutKey drop = mmgl::load_dropout_key(seed, threshold,
                                                       keep_inv);

  float4 kr[kChunks], vr[kChunks], dk_acc[kChunks], dv_acc[kChunks];
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = sub + 4 * t;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    kr[t] = key_ok ? load4(k + k_off + kj * rs + 4 * c) : zero;
    vr[t] = key_ok ? load4(v + k_off + kj * rs + 4 * c) : zero;
    dk_acc[t] = zero;
    dv_acc[t] = zero;
  }
  const bool key_valid = key_ok && kv_mask[static_cast<long>(b) * sk + kj];
  const int shift = sk - sq;

  for (int q0 = 0; q0 < sq; q0 += kTile) {
    const int n_rows = min(kTile, sq - q0);
    if (causal && q0 + n_rows - 1 + shift < k0) {
      // every pair of the tile is causally hidden: only a fully masked
      // query row contributes (to dV, with P = 1/sk)
      const int full = (tid < n_rows) && row_max[stat0 + q0 + tid] == kNegInf;
      if (!__syncthreads_or(full)) continue;
    }
    __syncthreads();  // the previous query tile is consumed
    for (int e = tid; e < kTile * (kD / 4); e += kThreads) {
      const int r = e >> 4;
      const int c = e & 15;
      const int i = q0 + r;
      float4 qx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 dx = qx;
      if (r < n_rows) {
        qx = load4(q_rows + i * rs + 4 * c);
        dx = load4(do_rows + i * rs + 4 * c);
      }
      store4(&q_tile[r][4 * c], qx);
      store4(&do_tile[r][4 * c], dx);
    }
    if (tid < n_rows) {
      m_tile[tid] = row_max[stat0 + q0 + tid];
      inv_l_tile[tid] = 1.f / row_sum[stat0 + q0 + tid];
      delta_tile[tid] = row_delta[stat0 + q0 + tid];
    }
    __syncthreads();

    for (int r0 = 0; r0 < n_rows; r0 += 4) {
      // thread sub draws the keep factor of row r0 + sub for this key
      float mine = 1.f;
      if (drop.on) {
        const mmgl::Philox4 rnd =
            mmgl::dropout_group(drop, b, h, q0 + r0 + sub, kj);
        mine = mmgl::dropout_factor(drop, rnd, kj);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float mf = __shfl_sync(0xffffffffu, mine, (lane & ~3) | u);
        const int r = r0 + u;
        if (r >= n_rows) break;  // uniform across the block
        float4 qx[kChunks], dx[kChunks];
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int t = 0; t < kChunks; ++t) {
          const int c = sub + 4 * t;
          qx[t] = *reinterpret_cast<const float4*>(&q_tile[r][4 * c]);
          dx[t] = *reinterpret_cast<const float4*>(&do_tile[r][4 * c]);
          s = dot4(qx[t], kr[t], s);
          dp = dot4(dx[t], vr[t], dp);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 2);

        const int i = q0 + r;
        const bool allowed = key_valid && !(causal && i + shift < kj);
        float logit = kNegInf;
        if (allowed) {
          logit = s * scale;
          if (bias_col != nullptr) {
            logit += load1(bias_col + static_cast<long>(i) * sk);
          }
        }
        const float p = expf(logit - m_tile[r]) * inv_l_tile[r];
        const float dl = allowed ? p * (mf * dp - delta_tile[r]) : 0.f;
#pragma unroll
        for (int t = 0; t < kChunks; ++t) {
          axpy4(p * mf, dx[t], dv_acc[t]);
          axpy4(dl * scale, qx[t], dk_acc[t]);
        }
      }
    }
  }

  if (key_ok) {
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
      const int c = sub + 4 * t;
      store4(dk + k_off + kj * rs + 4 * c, dk_acc[t]);
      store4(dv + k_off + kj * rs + 4 * c, dv_acc[t]);
    }
  }
}

// 3. dQ for 64 query rows, looping over the key tiles; dlogits into the
// (B, H, Sq, Sk) fp32 partial when there is a bias
template <typename T, typename TB>
__global__ void __launch_bounds__(kThreads)
bias_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ kv_mask,
                   const TB* __restrict__ bias,
                   const long long* __restrict__ seed,
                   const T* __restrict__ dout,
                   const float* __restrict__ row_max,
                   const float* __restrict__ row_sum,
                   const float* __restrict__ row_delta, T* __restrict__ dq,
                   float* __restrict__ partial, int sq, int sk, int heads,
                   float scale, int causal, unsigned int threshold,
                   float keep_inv) {
  __shared__ __align__(16) float k_tile[kTile][kD];
  __shared__ __align__(16) float v_tile[kTile][kD];
  __shared__ int mask_tile[kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int q0 = blockIdx.x * kTile;
  const int qi = q0 + row;
  const bool row_ok = qi < sq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long rs = static_cast<long>(heads) * kD;
  const long q_off = static_cast<long>(b) * sq * rs + h * kD;
  const T* k_rows = k + static_cast<long>(b) * sk * rs + h * kD;
  const T* v_rows = v + static_cast<long>(b) * sk * rs + h * kD;
  const int* mask_row = kv_mask + static_cast<long>(b) * sk;
  const TB* bias_row =
      (bias != nullptr && row_ok)
          ? bias + (static_cast<long>(h) * sq + qi) * sk
          : nullptr;
  float* part_row =
      (partial != nullptr && row_ok)
          ? partial + ((static_cast<long>(b) * heads + h) * sq + qi) * sk
          : nullptr;
  const mmgl::DropoutKey drop = mmgl::load_dropout_key(seed, threshold,
                                                       keep_inv);

  float4 qr[kChunks], dr[kChunks], dq_acc[kChunks];
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = sub + 4 * t;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[t] = row_ok ? load4(q + q_off + qi * rs + 4 * c) : zero;
    dr[t] = row_ok ? load4(dout + q_off + qi * rs + 4 * c) : zero;
    dq_acc[t] = zero;
  }
  float m_i = 0.f, inv_l = 0.f, delta = 0.f;  // past sq: dlogits = 0
  if (row_ok) {
    const long idx = (static_cast<long>(b) * heads + h) * sq + qi;
    m_i = row_max[idx];
    inv_l = 1.f / row_sum[idx];
    delta = row_delta[idx];
  }
  const int shift = sk - sq;
  const int q_last = min(q0 + kTile, sq) - 1;

  for (int k0 = 0; k0 < sk; k0 += kTile) {
    if (causal && k0 > q_last + shift) break;  // dlogits = 0 past the diagonal
    __syncthreads();
    for (int e = tid; e < kTile * (kD / 4); e += kThreads) {
      const int r = e >> 4;
      const int c = e & 15;
      const int j = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (j < sk) {
        kx = load4(k_rows + j * rs + 4 * c);
        vx = load4(v_rows + j * rs + 4 * c);
      }
      store4(&k_tile[r][4 * c], kx);
      store4(&v_tile[r][4 * c], vx);
    }
    if (tid < kTile) {
      mask_tile[tid] = (k0 + tid < sk) ? mask_row[k0 + tid] : 0;
    }
    __syncthreads();

    const int n_keys = min(kTile, sk - k0);
    mmgl::Philox4 rnd{0u, 0u, 0u, 0u};
    for (int r = 0; r < n_keys; ++r) {
      const int j = k0 + r;
      float mf = 1.f;
      if (drop.on) {
        // thread sub makes the call of key group (j & 3) == sub of this
        // 16-key block; key j's word comes from thread j & 3
        if ((r & 15) == 0) rnd = mmgl::dropout_group(drop, b, h, qi, j + sub);
        const int w = (r >> 2) & 3;
        const float f = mmgl::philox_word(rnd, w) < drop.threshold
                            ? drop.keep_inv : 0.f;
        mf = __shfl_sync(0xffffffffu, f, (lane & ~3) | (r & 3));
      }
      float4 kx[kChunks];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        const int c = sub + 4 * t;
        kx[t] = *reinterpret_cast<const float4*>(&k_tile[r][4 * c]);
        const float4 vx = *reinterpret_cast<const float4*>(&v_tile[r][4 * c]);
        s = dot4(qr[t], kx[t], s);
        dp = dot4(dr[t], vx, dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);

      const bool allowed = mask_tile[r] != 0 && !(causal && qi + shift < j);
      float dl = 0.f;
      if (allowed) {
        float logit = s * scale;
        if (bias_row != nullptr) logit += load1(bias_row + j);
        dl = expf(logit - m_i) * inv_l * (mf * dp - delta);
      }
      if (part_row != nullptr && sub == (r & 3)) part_row[j] = dl;
#pragma unroll
      for (int t = 0; t < kChunks; ++t) axpy4(dl * scale, kx[t], dq_acc[t]);
    }
  }

  if (row_ok) {
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
      store4(dq + q_off + qi * rs + 4 * (sub + 4 * t), dq_acc[t]);
    }
  }
}

// 4. dbias[h, i, j] = sum_b partial[b, h, i, j], b in order
template <typename TB>
__global__ void bias_bwd_reduce_kernel(const float* __restrict__ partial,
                                       TB* __restrict__ dbias, int batch,
                                       long n) {
  for (long e = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < batch; ++b) acc += partial[b * n + e];
    store1(dbias + e, acc);
  }
}

template <typename T, typename TB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_mask, const void* bias,
                   const long long* seed, const void* out, const void* dout,
                   void* dq, void* dk, void* dv, void* dbias, float* stats,
                   float* partial, int batch, int sq, int sk, int heads,
                   int head_dim, float scale, int causal,
                   unsigned int threshold, float keep_inv,
                   cudaStream_t stream) {
  if (head_dim != kD || batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 ||
      (causal && sq > sk) || batch > 65535 || heads > 65535 ||
      (bias != nullptr && (dbias == nullptr || partial == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(out);
  const T* do_ = static_cast<const T*>(dout);
  const TB* bias_ = static_cast<const TB*>(bias);
  const long n = static_cast<long>(batch) * heads * sq;
  float* row_max = stats;
  float* row_sum = stats + n;
  float* row_delta = stats + 2 * n;

  const dim3 q_grid((sq + kTile - 1) / kTile, heads, batch);
  const dim3 k_grid((sk + kTile - 1) / kTile, heads, batch);
  bias_bwd_stats_kernel<T, TB><<<q_grid, kThreads, 0, stream>>>(
      q_, k_, kv_mask, bias_, o_, do_, row_max, row_sum, row_delta, sq, sk,
      heads, scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bias_bwd_dkdv_kernel<T, TB><<<k_grid, kThreads, 0, stream>>>(
      q_, k_, v_, kv_mask, bias_, seed, do_, row_max, row_sum, row_delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, heads, scale, causal,
      threshold, keep_inv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* part = bias != nullptr ? partial : nullptr;
  bias_bwd_dq_kernel<T, TB><<<q_grid, kThreads, 0, stream>>>(
      q_, k_, v_, kv_mask, bias_, seed, do_, row_max, row_sum, row_delta,
      static_cast<T*>(dq), part, sq, sk, heads, scale, causal, threshold,
      keep_inv);
  err = cudaGetLastError();
  if (err != cudaSuccess || bias == nullptr) return err;
  const long n_bias = static_cast<long>(heads) * sq * sk;
  const long want = (n_bias + 255) / 256;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  bias_bwd_reduce_kernel<TB><<<blocks, 256, 0, stream>>>(
      partial, static_cast<TB*>(dbias), batch, n_bias);
  return cudaGetLastError();
}

// the tensor-core bodies in one (bias, dropout) form over T (bf16, fp16):
// the stats-only forward where no row stats are given; K3's wgmma/TMA dQ
// (delta and the dlogits into the partial) and dK/dV bodies in their bias
// form (wg::launch_bwd_layout), or, with neither flag, K3's two launches;
// then the batch-order reduction into dbias. scratch: delta's n floats,
// then, for the stats-only forward, its row max and sum (n each)
template <bool kBias, bool kDropout, typename TB, typename T>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* kv_mask, const void* bias, int bias_ld,
                      const long long* seed, const void* out,
                      const void* dout, void* dq, void* dk, void* dv,
                      void* dbias, float* scratch, const float* row_max_in,
                      const float* row_sum_in, float* partial, int batch,
                      int sq, int sk, int heads, float scale, int causal,
                      unsigned int threshold, float keep_inv,
                      cudaStream_t stream) {
  namespace wg = mmgl::wg;
  const long n = static_cast<long>(batch) * heads * sq;
  const mmgl::BiasArgs<TB> ba{static_cast<const TB*>(bias), bias_ld, seed,
                              threshold, keep_inv};
  // the maps of both bodies (and of the stats-only forward), encoded once
  wg::Maps m{};
  cudaError_t err = wg::make_maps(&m, q, k, v, dout, mmgl::tc_code<T>(),
                                  batch, sq, sk, heads, kD);
  if (err == cudaSuccess && kBias) {
    err = mmgl::hopper::make_bias_map(
        &m.bias, bias,
        std::is_same<TB, float>::value ? mmgl::kF32 : mmgl::tc_code<T>(),
        heads, sq, sk, bias_ld);
  }
  if (err != cudaSuccess) return err;
  const float* row_max = row_max_in;
  const float* row_sum = row_sum_in;
  if (row_max == nullptr) {
    // the stats-only form: K7's instructions for m and l (its dropout key
    // unread)
    err = wg::launch_fwd<kD, true, wg::FwdShape<kD>, T, kBias, false, TB>(
        m, kv_mask, nullptr, scratch + n, scratch + 2 * n, batch, sq, sk,
        heads, scale, causal, stream, ba);
    if (err != cudaSuccess) return err;
    row_max = scratch + n;
    row_sum = scratch + 2 * n;
  }
  if constexpr (kBias || kDropout) {
    // dQ and dK/dV, in one grid or two launches by the grid's size
    err = wg::launch_bwd_layout<kD, wg::DkdvShape<kD>, wg::BiasDqShape<kD>, T,
                                kBias, kDropout, TB>(
        m, kv_mask, row_max, row_sum, out, dout, scratch, dq, dk, dv,
        kBias ? partial : nullptr, batch, sq, sk, heads, scale, causal,
        stream, ba);
  } else {
    // neither: K3's own launches, so that K8/K9 then equals K3 bit for bit
    err = wg::launch_bwd<kD, wg::DkdvShape<kD>, wg::DqShape<kD>, T>(
        m, kv_mask, row_max, row_sum, out, dout, scratch, dq, dk, dv, batch,
        sq, sk, heads, scale, causal, stream);
  }
  if (err != cudaSuccess || !kBias) return err;
  const long n_bias = static_cast<long>(heads) * sq * sk;
  const long want = (n_bias + 255) / 256;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  bias_bwd_reduce_kernel<TB><<<blocks, 256, 0, stream>>>(
      partial, static_cast<TB*>(dbias), batch, n_bias);
  return cudaGetLastError();
}

}  // namespace

// K8/K9 on the scalar bodies, fp32 inputs (dtype must be kF32: bf16 and
// fp16 take mmgl_bias_bwd_tc). bias/dbias: (heads, sq, sk) in the bias
// dtype (bias_dtype kF32 or kBF16), or
// both null; seed, threshold, keep_inv: the forward's. stats: fp32 scratch
// of 3 * batch * heads * sq floats; partial: zeroed fp32 scratch of
// batch * heads * sq * sk floats when there is a bias, else null.
extern "C" int mmgl_bias_bwd(const void* q, const void* k, const void* v,
                             const int* kv_mask, const void* bias,
                             const long long* seed, const void* out,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* dbias, float* stats, float* partial,
                             int batch, int sq, int sk, int heads,
                             int head_dim, float scale, int causal,
                             unsigned int threshold, float keep_inv,
                             int dtype, int bias_dtype,
                             cudaStream_t stream) {
#define MMGL_BIAS_BWD(T, TB)                                                 \
  launch<T, TB>(q, k, v, kv_mask, bias, seed, out, dout, dq, dk, dv, dbias, \
                stats, partial, batch, sq, sk, heads, head_dim, scale,      \
                causal, threshold, keep_inv, stream)
  if (dtype != mmgl::kF32) return cudaErrorInvalidValue;
  if (bias == nullptr || bias_dtype == mmgl::kF32) {
    return MMGL_BIAS_BWD(float, float);
  }
  if (bias_dtype == mmgl::kBF16) return MMGL_BIAS_BWD(float, __nv_bfloat16);
  return cudaErrorInvalidValue;
#undef MMGL_BIAS_BWD
}

// K8/K9 on K3's wgmma/TMA bodies in their bias form (dtype kBF16 or kF16;
// the bias and dbias in fp32 or in the same dtype): the arguments of
// mmgl_bias_bwd, plus row_max and row_sum, K7's saved row stats
// (mmgl_bias_fwd_tc), or both null for the stats-only pass, and bias_ld,
// the bias's row stride (sk rounded up to a multiple of 8, the bias padded
// to it). kv_mask may be null (every key valid). stats: fp32 scratch,
// delta's batch * heads * sq floats, and twice that more (the stats-only
// pass's max and sum) where row_max is null. partial (batch * heads * sq *
// sk fp32 when there is a bias) needs no zeroing: the dQ body writes every
// element.
extern "C" int mmgl_bias_bwd_tc(const void* q, const void* k, const void* v,
                                const int* kv_mask, const void* bias,
                                const long long* seed, const void* out,
                                const void* dout, void* dq, void* dk,
                                void* dv, void* dbias, float* stats,
                                float* partial, const float* row_max,
                                const float* row_sum, int batch, int sq,
                                int sk, int heads, int head_dim, float scale,
                                int causal, unsigned int threshold,
                                float keep_inv, int dtype, int bias_dtype,
                                int bias_ld, cudaStream_t stream) {
  if (head_dim != kD || batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 ||
      (causal && sq > sk) || batch > 65535 || heads > 65535 ||
      (row_max == nullptr) != (row_sum == nullptr) ||
      (bias != nullptr &&
       (dbias == nullptr || partial == nullptr || bias_ld < sk ||
        bias_ld % 8 != 0 ||
        (bias_dtype != mmgl::kF32 && bias_dtype != dtype)))) {
    return cudaErrorInvalidValue;
  }
  const bool drop = seed != nullptr;
  return mmgl::with_tc_type(dtype, [&](auto tag) {
    using T = decltype(tag);
#define MMGL_BIAS_BWD_TC(B, DROP, TB)                                        \
  launch_tc<B, DROP, TB, T>(q, k, v, kv_mask, bias, bias_ld, seed, out,      \
                            dout, dq, dk, dv, dbias, stats, row_max,         \
                            row_sum, partial, batch, sq, sk, heads, scale,   \
                            causal, threshold, keep_inv, stream)
    if (bias == nullptr) {
      return drop ? MMGL_BIAS_BWD_TC(false, true, T)
                  : MMGL_BIAS_BWD_TC(false, false, T);
    }
    if (bias_dtype == dtype) {
      return drop ? MMGL_BIAS_BWD_TC(true, true, T)
                  : MMGL_BIAS_BWD_TC(true, false, T);
    }
    return drop ? MMGL_BIAS_BWD_TC(true, true, float)
                : MMGL_BIAS_BWD_TC(true, false, float);
#undef MMGL_BIAS_BWD_TC
  });
}
