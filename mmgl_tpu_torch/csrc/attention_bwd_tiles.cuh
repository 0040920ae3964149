// The dK/dV and dQ passes of the dense attention backward, shared by K3/K5
// (attention_bwd.cu, after their stats pass) and K6 (attention_blocked_bwd.cu,
// from the forward's saved statistics). Given q, k, v, the key mask, dO and
// per query row the softmax max m, sum l and delta = rowsum(dO * o):
//   P  = exp(q k^T * scale - m) / l   (masked logits -1e30, so a fully
//                                      masked row, m = -1e30 and l = sk,
//                                      gets P = 1/sk at every key)
//   dV = P^T dO,  dS = P * (dO v^T - delta) * scale, 0 at masked logits,
//   dQ = dS k,    dK = dS^T q
// Layout: (B, S, H*D) row-major, read and written strided in place; outputs
// in the input dtype, every sum fp32; the statistics (B, H, Sq) fp32.
//
// Four threads share a row (a key in dK/dV, a query in dQ); each owns the D/4
// head dims 4c..4c+3 for c = sub + 4t, t < D/16, so the four 16-byte chunks
// a warp reads from one shared-memory row fall in distinct banks and every
// other row of the warp reads the same addresses (a broadcast). A dot
// product is four partial sums joined by two warp shuffles. The head dim D
// is a template (64, 80, 128); the streamed tiles, 2 x 64 x D fp32 (64 KB
// at 128, past the 48 KB of static shared memory), are dynamic shared
// memory (scalar_tiles_smem).
// Causal tiles: dQ stops at its tile's causal limit (dS is 0 past it for
// every row). dK/dV skips a query tile whose rows all lie before its keys
// only when no row of it is fully masked, since such a row feeds dV from
// every key.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace mmgl {

constexpr int kBwdTile = 64;         // query rows and keys per tile
constexpr int kBwdThreads = 256;     // four threads per row

// the dynamic shared memory of the scalar dK/dV and dQ kernels: two fp32
// tiles of 64 rows of D
template <int D>
constexpr size_t scalar_tiles_smem() {
  return 2 * kBwdTile * D * sizeof(float);
}

// dK, dV for 64 keys, looping over the query tiles
template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ kv_mask,
                          const T* __restrict__ dout,
                          const float* __restrict__ row_max,
                          const float* __restrict__ row_sum,
                          const float* __restrict__ row_delta,
                          T* __restrict__ dk, T* __restrict__ dv, int sq,
                          int sk, int heads, float scale, int causal) {
  constexpr int kChunks = D / 16;  // float4 chunks a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  float (*q_tile)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*do_tile)[D] = q_tile + kBwdTile;
  __shared__ float m_tile[kBwdTile];
  __shared__ float inv_l_tile[kBwdTile];
  __shared__ float delta_tile[kBwdTile];

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int k0 = blockIdx.x * kBwdTile;
  const int kj = k0 + row;
  const bool key_ok = kj < sk;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long rs = static_cast<long>(heads) * D;
  const T* q_rows = q + static_cast<long>(b) * sq * rs + h * D;
  const T* do_rows = dout + static_cast<long>(b) * sq * rs + h * D;
  const long k_off = static_cast<long>(b) * sk * rs + h * D;
  const long stat0 = (static_cast<long>(b) * heads + h) * sq;

  float4 kr[kChunks], vr[kChunks];
  float4 dk_acc[kChunks], dv_acc[kChunks];
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

  for (int q0 = 0; q0 < sq; q0 += kBwdTile) {
    const int n_rows = min(kBwdTile, sq - q0);
    if (causal && q0 + n_rows - 1 + shift < k0) {
      // every (query, key) pair of the tile is causally hidden: only a fully
      // masked query row contributes (to dV, with P = 1/sk)
      const int full = (tid < n_rows) && row_max[stat0 + q0 + tid] == kNegInf;
      if (!__syncthreads_or(full)) continue;
    }
    __syncthreads();  // the previous query tile is consumed
    for (int e = tid; e < kBwdTile * (D / 4); e += kBwdThreads) {
      const int r = e / (D / 4);
      const int c = e % (D / 4);
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

    for (int r = 0; r < n_rows; ++r) {
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

      const bool allowed = key_valid && !(causal && q0 + r + shift < kj);
      const float logit = allowed ? s * scale : kNegInf;
      const float p = expf(logit - m_tile[r]) * inv_l_tile[r];
      const float ds = allowed ? p * (dp - delta_tile[r]) * scale : 0.f;
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        axpy4(p, dx[t], dv_acc[t]);
        axpy4(ds, qx[t], dk_acc[t]);
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

// dQ for 64 query rows, looping over the key tiles
template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_mask,
                        const T* __restrict__ dout,
                        const float* __restrict__ row_max,
                        const float* __restrict__ row_sum,
                        const float* __restrict__ row_delta,
                        T* __restrict__ dq, int sq, int sk, int heads,
                        float scale, int causal) {
  constexpr int kChunks = D / 16;  // float4 chunks a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  float (*k_tile)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*v_tile)[D] = k_tile + kBwdTile;
  __shared__ int mask_tile[kBwdTile];

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int q0 = blockIdx.x * kBwdTile;
  const int qi = q0 + row;
  const bool row_ok = qi < sq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long rs = static_cast<long>(heads) * D;
  const long q_off = static_cast<long>(b) * sq * rs + h * D;
  const T* k_rows = k + static_cast<long>(b) * sk * rs + h * D;
  const T* v_rows = v + static_cast<long>(b) * sk * rs + h * D;
  const int* mask_row = kv_mask + static_cast<long>(b) * sk;

  float4 qr[kChunks], dr[kChunks], dq_acc[kChunks];
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = sub + 4 * t;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[t] = row_ok ? load4(q + q_off + qi * rs + 4 * c) : zero;
    dr[t] = row_ok ? load4(dout + q_off + qi * rs + 4 * c) : zero;
    dq_acc[t] = zero;
  }
  // a row past sq gets dS = 0 (inv_l = 0) and is not written
  float m_i = 0.f, inv_l = 0.f, delta = 0.f;
  if (row_ok) {
    const long idx = (static_cast<long>(b) * heads + h) * sq + qi;
    m_i = row_max[idx];
    inv_l = 1.f / row_sum[idx];
    delta = row_delta[idx];
  }
  const int shift = sk - sq;
  const int q_last = min(q0 + kBwdTile, sq) - 1;

  for (int k0 = 0; k0 < sk; k0 += kBwdTile) {
    if (causal && k0 > q_last + shift) break;  // dS = 0 past the diagonal
    __syncthreads();
    for (int e = tid; e < kBwdTile * (D / 4); e += kBwdThreads) {
      const int r = e / (D / 4);
      const int c = e % (D / 4);
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
    if (tid < kBwdTile) {
      mask_tile[tid] = (k0 + tid < sk) ? mask_row[k0 + tid] : 0;
    }
    __syncthreads();

    const int n_keys = min(kBwdTile, sk - k0);
    for (int r = 0; r < n_keys; ++r) {
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

      const bool allowed = mask_tile[r] != 0 && !(causal && qi + shift < k0 + r);
      const float ds =
          allowed ? expf(s * scale - m_i) * inv_l * (dp - delta) * scale : 0.f;
#pragma unroll
      for (int t = 0; t < kChunks; ++t) axpy4(ds, kx[t], dq_acc[t]);
    }
  }

  if (row_ok) {
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
      store4(dq + q_off + qi * rs + 4 * (sub + 4 * t), dq_acc[t]);
    }
  }
}

// delta = rowsum(dO * o) per query row, in (B, H, Sq) order: K6's first
// launch, and K3/K5's after their tensor-core stats pass (JAX computes it outside
// Pallas, mmgl_tpu/ops/flash_attention.py:345-347). Thread sub of a row sums
// the D/4 dims from sub D/4 on, in the order of K3/K5's scalar stats pass
// (attention_bwd.cu), so that K5 and K6 agree bit for bit in fp32 too.
template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads)
attention_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ row_delta, int sq, int heads) {
  const int tid = threadIdx.x;
  const int sub = tid & 3;
  const int qi = blockIdx.x * kBwdTile + (tid >> 2);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool row_ok = qi < sq;

  const long rs = static_cast<long>(heads) * D;
  const long off = (static_cast<long>(b) * sq + qi) * rs + h * D +
                   (D / 4) * sub;
  float delta = 0.f;
  if (row_ok) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      delta = dot4(load4(dout + off + 4 * c), load4(out + off + 4 * c), delta);
    }
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta += __shfl_xor_sync(0xffffffffu, delta, 2);
  if (row_ok && sub == 0) {
    row_delta[(static_cast<long>(b) * heads + h) * sq + qi] = delta;
  }
}

// ---- the tensor-core bodies (bf16, fp16) -----------------------------------
//
// The same gradients, tiles and skip rules as the scalar kernels above, for
// bf16 or fp16 inputs (the element type T), on mma.sync (common.cuh). Per
// allowed element the arithmetic
// is the scalar kernels' (p = exp(logit - m) * (1 / l), dS = p (dP - delta)
// scale, 0 where masked), exp taken as 2^(logit log2(e) - m log2(e)) on the
// card's ex2 (a few ulp), the logit's scale and log2(e) in one FMA; P
// and dS are rounded to T before their products, where the Pallas K6
// rounds them to the input dtype (flash_attention.py:317, :324). Masked
// logits (-1e30) stay in fp32 registers; dS is 0 there, and in fp16 a dS
// below 2^-24 rounds to 0 and one past 65504 to inf, as the Pallas kernels'
// own cast does. A block holds kWarps warps of
// 16 rows (keys in dK/dV, queries in dQ); a streamed tile of 64 rows in
// shared memory serves all of them. The streamed tiles pass
// through a kStages-deep cp.async ring with rows padded to D + 8, one
// barrier a tile. A warp takes its 64 columns in two halves of 32, one after
// the other, so the two products of a half (S and dP) and the accumulators
// fit in registers. A warp skips a tile whose pairs are all causally hidden
// from it or whose keys are all masked, where dS = 0 for every row and P = 0
// for every row with a real logit (so dK/dV keeps such a tile where a row of
// it is fully masked; the forward never skips a masked key); the causal test
// runs only on tiles that straddle the diagonal, dQ's key mask only on tiles
// with a masked key (a bit a key). No atomics: each block owns its outputs,
// so the results are the same from run to run.
//
// What bounds them on this card: 14 D FLOPs per (query, key) pair computed
// (dK/dV: K Q^T, V dO^T, P^T dO, dS^T Q; dQ: Q K^T, dO V^T, dS K) on the
// tensor cores, the fp32 elementwise work between the products, and the
// streamed tiles' L2 traffic.
//
// The bias form (kBias, kDropout; K8/K9, attention_bias_bwd.cu) is K7's
// backward (bias_attention_bwd_reference's math), from K7's row max and sum
// or its stats-only pass, with m the keep factor:
//   P = exp(logit - m) / l with logit = q k^T scale + bias[h];
//   dV = (P m)^T dO, P m rounded to T (flash_attention.py:726-728);
//   dlogits = P (m dP - delta) in fp32, 0 at masked logits;
//   dS = dlogits scale, rounded to T for dQ and dK (:748-754);
//   dbias = sum_b dlogits, from the fp32 values before any rounding
//   (:736-746): the dQ body stores its fragments of dlogits, zeros for the
//   tiles it skips, into a (B, H, Sq, Sk) fp32 partial that a reduction
//   sums over b in order, so dbias is the same from run to run.
// Each streamed tile brings its bias tile into the ring beside it. The
// keep factors are philox.cuh's bits: in dQ, as in the forward, the four
// words of a call fall on lanes c4 and c4 ^ 2; in dK/dV keys are the
// accumulator rows, so they fall on rows r, r + 4, r + 8, r + 12, lanes
// lane and lane ^ 16; either way each lane makes one call and swaps two
// words with its partner, and each call is made once per pass.

// the shared memory of the dK/dV body: K, V, kStages stages of Q and dO
// (and of the bias, query rows by the block's keys) and of the queries' m,
// 1 / l and delta, and a bit per query tile that holds a fully masked row
template <int D, int kRows, int kStages, bool kBias = false,
          typename TB = __nv_bfloat16>
constexpr size_t dkdv_tc_smem(int n_q_tiles) {
  return (2 * kRows + 2 * kStages * kTcTile) * TcTile<D>::kStride *
             2 /* bytes of T */ +
         (kBias ? kStages * kTcTile * bias_stride<kRows>() * sizeof(TB)
                : 0) +
         3 * kStages * kTcTile * sizeof(float) +
         ((n_q_tiles + 31) / 32) * sizeof(uint32_t);
}

// dK, dV for a block of kWarps warps of 16 keys: S^T = K Q^T and
// dP^T = V dO^T put the keys in the accumulators' rows, so P^T and dS^T are
// A fragments for dV += P^T dO and dK += dS^T Q without a transpose
template <int D, int kWarps, int kStages, int kMinBlocks, bool kBias = false,
          bool kDropout = false, typename TB = __nv_bfloat16,
          typename T = __nv_bfloat16>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
attention_bwd_dkdv_tc_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const int* __restrict__ kv_mask,
                             const T* __restrict__ dout,
                             const float* __restrict__ row_max,
                             const float* __restrict__ row_sum,
                             const float* __restrict__ row_delta,
                             T* __restrict__ dk, T* __restrict__ dv, int sq,
                             int sk,
                             int heads, float scale, int causal,
                             BiasArgs<TB> ba) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kRows = 16 * kWarps;  // keys a block
  constexpr int S = TcTile<D>::kStride;
  constexpr int kElems = TcTile<D>::kElems;
  constexpr int kKSteps = D / 16;
  constexpr int kDBlocks = D / 8;
  constexpr int kBS = bias_stride<kRows>();
  constexpr int kBiasElems = kTcTile * kBS;  // TB a bias tile (queries)
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);  // kRows rows
  T* v_s = k_s + kRows * S;              // kRows rows
  T* q_s = v_s + kRows * S;              // [kStages][kElems]
  T* do_s = q_s + kStages * kElems;      // [kStages][kElems]
  // [kStages][kBiasElems] in the bias form
  TB* b_s = reinterpret_cast<TB*>(do_s + kStages * kElems);
  float* m_s = reinterpret_cast<float*>(b_s + (kBias ? kStages * kBiasElems
                                                     : 0));
  float* inv_l_s = m_s + kStages * kTcTile;       // [kStages][64] each
  float* delta_s = inv_l_s + kStages * kTcTile;
  uint32_t* full_bits =
      reinterpret_cast<uint32_t*>(delta_s + kStages * kTcTile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long rs = static_cast<long>(heads) * D;
  const T* q_rows = q + static_cast<long>(b) * sq * rs + h * D;
  const T* do_rows = dout + static_cast<long>(b) * sq * rs + h * D;
  const long k_off = static_cast<long>(b) * sk * rs + h * D;
  const long stat0 = (static_cast<long>(b) * heads + h) * sq;
  const int shift = sk - sq;
  const int n_q = (sq + kTcTile - 1) / kTcTile;
  const TB* bias_rows =
      kBias ? ba.bias + static_cast<long>(h) * sq * ba.ld : nullptr;
  DropoutKey drop{};
  if constexpr (kDropout) drop = load_dropout_key(ba.seed, ba.threshold,
                                                  ba.keep_inv);

  tile_async<D, kRows, kThreads>(k_s, k + k_off, rs, k0, sk, tid);
  tile_async<D, kRows, kThreads>(v_s, v + k_off, rs, k0, sk, tid);

  const int key_first = k0 + 16 * warp;  // the warp's keys
  const int key0 = key_first + g;        // this lane's keys key0, key0 + 8
  bool key_valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key0 + 8 * r;
    key_valid[r] = kj < sk && kv_mask[static_cast<long>(b) * sk + kj] != 0;
  }
  const bool warp_keys =
      __any_sync(0xffffffffu, key_valid[0] || key_valid[1]);

  // A bit per query tile holding a fully masked row (m = -1e30): such a row
  // feeds dV from every key, causally hidden and masked ones too; every
  // other row gets P = 0 and dS = 0 at those. So a block visits a query
  // tile that lies wholly before its keys (before t_first), or any tile if
  // all its keys are masked, only if the tile's bit is set, and a warp skips
  // a tile hidden from its keys, or any tile if all its keys are masked,
  // only if the bit is clear.
  for (int w = tid; w < (n_q + 31) / 32; w += kThreads) full_bits[w] = 0;
  const bool block_keys = __syncthreads_or(warp_keys);
  const int t_first =
      !block_keys ? n_q : causal ? max(0, k0 - shift) / kTcTile : 0;
  for (int i = tid; i < sq; i += kThreads) {
    if (row_max[stat0 + i] == kNegInf) {
      const int t = i / kTcTile;
      atomicOr(&full_bits[t >> 5], 1u << (t & 31));
    }
  }
  __syncthreads();
  auto full = [&](int t) { return (full_bits[t >> 5] >> (t & 31)) & 1u; };
  auto next_tile = [&](int t) {
    while (t < t_first && !full(t)) ++t;
    return t;
  };

  auto issue = [&](int t, int st) {  // query tile t's Q and dO (and bias)
    tile_async<D, kTcTile, kThreads>(q_s + st * kElems, q_rows, rs,
                                     t * kTcTile, sq, tid);
    tile_async<D, kTcTile, kThreads>(do_s + st * kElems, do_rows, rs,
                                     t * kTcTile, sq, tid);
    if constexpr (kBias) {
      bias_tile_async<TB, kTcTile, kRows, kThreads>(
          b_s + st * kBiasElems, bias_rows, ba.ld, t * kTcTile, sq, k0, tid);
    }
  };
  // query i's statistics, for a stage, the max as m log2(e); rows past sq
  // get m = 1 / l = 0 (their q and dO are zero-filled, so their p and dS are
  // exactly 0)
  float m_next = 0.f, inv_l_next = 0.f, delta_next = 0.f;
  auto fetch_stats = [&](int t) {
    const int i = t * kTcTile + tid;
    m_next = inv_l_next = delta_next = 0.f;
    if (tid < kTcTile && i < sq) {
      m_next = __fmul_rn(row_max[stat0 + i], kLog2e);
      inv_l_next = 1.f / row_sum[stat0 + i];
      delta_next = row_delta[stat0 + i];
    }
  };
  auto store_stats = [&](int st) {
    if (tid < kTcTile) {
      m_s[st * kTcTile + tid] = m_next;
      inv_l_s[st * kTcTile + tid] = inv_l_next;
      delta_s[st * kTcTile + tid] = delta_next;
    }
  };

  // the visited tiles v_0, v_1, ...: v_i in stage i % kStages, v_{i +
  // kStages - 1} in flight while v_i is computed
  int t_pf = next_tile(0);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t_pf < n_q) {
      issue(t_pf, i);
      fetch_stats(t_pf);
      store_stats(i);
      t_pf = next_tile(t_pf + 1);
    }
    cp_async_commit();
  }

  float dk_acc[kDBlocks][4], dv_acc[kDBlocks][4];
#pragma unroll
  for (int i = 0; i < kDBlocks; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  }
  const T* k_warp = k_s + (16 * warp + (lane & 15)) * S + 8 * (lane >> 4);
  const T* v_warp = v_s + (16 * warp + (lane & 15)) * S + 8 * (lane >> 4);

  for (int t = next_tile(0), i = 0; t < n_q; t = next_tile(t + 1), ++i) {
    const int st = i % kStages;
    cp_async_wait<kStages - 2>();  // tile t (and K, V) have landed
    __syncthreads();  // and every warp is done with the tile before
    const int sp = (i + kStages - 1) % kStages;  // that tile's stage
    const bool prefetch = t_pf < n_q;
    if (prefetch) {
      issue(t_pf, sp);
      fetch_stats(t_pf);
    }
    cp_async_commit();

    const int q0 = t * kTcTile;
    if (full(t) ||
        (warp_keys && !(causal && q0 + kTcTile - 1 + shift < key_first))) {
      const T* qs = q_s + st * kElems;
      const T* dos = do_s + st * kElems;
      const float* ms = m_s + st * kTcTile;
      const float* ls = inv_l_s + st * kTcTile;
      const float* dls = delta_s + st * kTcTile;
      // some (query, key) of the warp's tile is causally hidden
      const bool diag = causal && q0 + shift < key_first + 15;
      // p = 2^(logit log2(e) - m log2(e)); a masked logit is -1e30, so a
      // fully masked row (m = -1e30) gets 2^0 = 1 there
      const float scale2 = scale * kLog2e;
      const float neg2 = __fmul_rn(kNegInf, kLog2e);
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
        float s[4][4], dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kKSteps; kk += 2) {
          uint32_t ka[2][4], va[2][4];
          ldmatrix_x4(ka[0], k_warp + 16 * kk);
          ldmatrix_x4(va[0], v_warp + 16 * kk);
          if (kk + 1 < kKSteps) {
            ldmatrix_x4(ka[1], k_warp + 16 * (kk + 1));
            ldmatrix_x4(va[1], v_warp + 16 * (kk + 1));
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              uint32_t qb[4], db[4];
              const int off = (32 * half + 8 * n + (lane & 7)) * S +
                              16 * kk + 8 * (lane >> 3);
              ldmatrix_x4(qb, qs + off);
              ldmatrix_x4(db, dos + off);
              mma_tc<T>(s[n], ka[0], qb[0], qb[1]);
              mma_tc<T>(s[n], ka[1], qb[2], qb[3]);
              mma_tc<T>(dp[n], va[0], db[0], db[1]);
              mma_tc<T>(dp[n], va[1], db[2], db[3]);
            }
          } else {  // the odd last k16 step (D = 80)
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              uint32_t qb[2], db[2];
              const int off = (32 * half + 8 * n + (lane & 7)) * S +
                              16 * kk + 8 * ((lane >> 3) & 1);
              ldmatrix_x2(qb, qs + off);
              ldmatrix_x2(db, dos + off);
              mma_tc<T>(s[n], ka[0], qb[0], qb[1]);
              mma_tc<T>(dp[n], va[0], db[0], db[1]);
            }
          }
        }

        // P^T and dS^T on each element's own (key, query)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = 32 * half + 8 * n + 2 * c4;
          const float2 m2 = *reinterpret_cast<const float2*>(ms + col);
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          const float2 d2 = *reinterpret_cast<const float2*>(dls + col);
          // the keep factors of keys key0 + 8 r at queries q0 + col + e:
          // words hi + 2 r of the call of query col + hi, which this lane
          // makes, and of query col + 1 - hi, which lane ^ 16 makes
          unsigned int own[2] = {0u, 0u}, other[2] = {0u, 0u};
          const int hi = g >> 2;
          if constexpr (kDropout) {
            philox_pair(drop,
                        (static_cast<unsigned int>(key_first >> 4) << 2) |
                            static_cast<unsigned int>(g & 3),
                        q0 + col + hi, h, b, hi, 16, own, other);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = j >> 1;
            const int e = j & 1;
            const bool allowed =
                key_valid[r] && !(diag && q0 + col + e + shift < key0 + 8 * r);
            const float m2e = e ? m2.y : m2.x;
            float x;
            if constexpr (kBias) {
              const float bv = load1(b_s + st * kBiasElems +
                                     (col + e) * kBS + 16 * warp + g + 8 * r);
              x = allowed ? __fsub_rn(fmaf(s[n][j], scale2,
                                           __fmul_rn(bv, kLog2e)),
                                      m2e)
                          : __fsub_rn(neg2, m2e);
            } else {
              x = allowed ? fmaf(s[n][j], scale2, -m2e)
                          : __fsub_rn(neg2, m2e);
            }
            const float p = ex2(x) * (e ? l2.y : l2.x);
            if constexpr (kDropout) {
              const float f = keep_factor(drop, e == hi ? own[r] : other[r]);
              s[n][j] = p * f;
              dp[n][j] = allowed
                             ? p * (f * dp[n][j] - (e ? d2.y : d2.x)) * scale
                             : 0.f;
            } else {
              s[n][j] = p;
              dp[n][j] =
                  allowed ? p * (dp[n][j] - (e ? d2.y : d2.x)) * scale : 0.f;
            }
          }
        }

        // dV += P^T dO, dK += dS^T Q: the k16 blocks are query blocks
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t pa[4], dsa[4];
          acc_to_a<T>(pa, s[2 * j], s[2 * j + 1]);
          acc_to_a<T>(dsa, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
          for (int db = 0; db < kDBlocks; db += 2) {
            uint32_t ob[4], qb[4];
            const int off = (32 * half + 16 * j + (lane & 15)) * S + 8 * db +
                            8 * (lane >> 4);
            ldmatrix_x4_trans(ob, dos + off);
            ldmatrix_x4_trans(qb, qs + off);
            mma_tc<T>(dv_acc[db], pa, ob[0], ob[1]);
            mma_tc<T>(dv_acc[db + 1], pa, ob[2], ob[3]);
            mma_tc<T>(dk_acc[db], dsa, qb[0], qb[1]);
            mma_tc<T>(dk_acc[db + 1], dsa, qb[2], qb[3]);
          }
        }
      }
    }

    if (prefetch) {
      store_stats(sp);
      t_pf = next_tile(t_pf + 1);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key0 + 8 * r;
    if (kj >= sk) continue;
    const long row = k_off + static_cast<long>(kj) * rs;
#pragma unroll
    for (int db = 0; db < kDBlocks; ++db) {
      const int c = 8 * db + 2 * c4;
      store2(dk + row + c, dk_acc[db][2 * r], dk_acc[db][2 * r + 1]);
      store2(dv + row + c, dv_acc[db][2 * r], dv_acc[db][2 * r + 1]);
    }
  }
}

// the shared memory of the dQ body: Q, dO, kStages stages of K and V (and
// of the bias)
template <int D, int kRows, int kStages, bool kBias = false,
          typename TB = __nv_bfloat16>
constexpr size_t dq_tc_smem() {
  return (2 * kRows + 2 * kStages * kTcTile) * TcTile<D>::kStride *
             2 /* bytes of T */ +
         (kBias ? kStages * kRows * bias_stride<kTcTile>() * sizeof(TB) : 0);
}

// dQ for a block of kWarps warps of 16 query rows, looping over the key
// tiles up to the causal limit; the bias form also writes the rows'
// dlogits into partial (B, H, Sq, Sk), zeros where it skips
template <int D, int kWarps, int kStages, int kMinBlocks, bool kBias = false,
          bool kDropout = false, typename TB = __nv_bfloat16,
          typename T = __nv_bfloat16>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
attention_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ kv_mask,
                           const T* __restrict__ dout,
                           const float* __restrict__ row_max,
                           const float* __restrict__ row_sum,
                           const float* __restrict__ row_delta,
                           T* __restrict__ dq, int sq, int sk,
                           int heads, float scale, int causal,
                           BiasArgs<TB> ba, float* __restrict__ partial) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kRows = 16 * kWarps;  // query rows a block
  constexpr int S = TcTile<D>::kStride;
  constexpr int kElems = TcTile<D>::kElems;
  constexpr int kKSteps = D / 16;
  constexpr int kDBlocks = D / 8;
  constexpr int kBS = bias_stride<kTcTile>();
  constexpr int kBiasElems = kRows * kBS;  // TB a bias tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // kRows rows
  T* do_s = q_s + kRows * S;             // kRows rows
  T* k_s = do_s + kRows * S;             // [kStages][kElems]
  T* v_s = k_s + kStages * kElems;       // [kStages][kElems]
  TB* b_s = reinterpret_cast<TB*>(v_s + kStages * kElems);  // bias form
  __shared__ uint32_t mask_s[kStages][2];  // a tile's key mask, a bit a key

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long rs = static_cast<long>(heads) * D;
  const long q_off = static_cast<long>(b) * sq * rs + h * D;
  const T* k_rows = k + static_cast<long>(b) * sk * rs + h * D;
  const T* v_rows = v + static_cast<long>(b) * sk * rs + h * D;
  const int* mask_row = kv_mask + static_cast<long>(b) * sk;
  const int shift = sk - sq;
  const int q_last = min(q0 + kRows, sq) - 1;
  const int n_k = (sk + kTcTile - 1) / kTcTile;
  // dS = 0 past the diagonal for every row of the block
  const int n_tiles = causal ? min(n_k, (q_last + shift) / kTcTile + 1) : n_k;
  const TB* bias_rows =
      kBias ? ba.bias + static_cast<long>(h) * sq * ba.ld : nullptr;
  DropoutKey drop{};
  if constexpr (kDropout) drop = load_dropout_key(ba.seed, ba.threshold,
                                                  ba.keep_inv);

  auto issue = [&](int t) {  // key tile t's K and V (and bias) into its stage
    const int st = t % kStages;
    tile_async<D, kTcTile, kThreads>(k_s + st * kElems, k_rows, rs,
                                     t * kTcTile, sk, tid);
    tile_async<D, kTcTile, kThreads>(v_s + st * kElems, v_rows, rs,
                                     t * kTcTile, sk, tid);
    if constexpr (kBias) {
      bias_tile_async<TB, kRows, kTcTile, kThreads>(
          b_s + st * kBiasElems, bias_rows, ba.ld, q0, sq, t * kTcTile, tid);
    }
  };
  auto key_ok = [&](int t) {  // thread tid < 64's key of tile t
    const int j = t * kTcTile + tid;
    return j < sk && mask_row[j] != 0;
  };

  tile_async<D, kRows, kThreads>(q_s, q + q_off, rs, q0, sq, tid);
  tile_async<D, kRows, kThreads>(do_s, dout + q_off, rs, q0, sq, tid);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      issue(t);
      if (tid < kTcTile) store_mask_bits(mask_s[t], key_ok(t));
    }
    cp_async_commit();
  }

  // this lane's rows row0, row0 + 8, m in log2 units; a row past sq gets
  // dS = 0 (inv_l = 0) and is not written
  const int row_first = q0 + 16 * warp;
  const int row0 = row_first + g;
  const float scale2 = scale * kLog2e;
  float m_i[2], inv_l[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    m_i[r] = inv_l[r] = delta[r] = 0.f;
    if (i < sq) {
      const long idx = (static_cast<long>(b) * heads + h) * sq + i;
      m_i[r] = __fmul_rn(row_max[idx], kLog2e);
      inv_l[r] = 1.f / row_sum[idx];
      delta[r] = row_delta[idx];
    }
  }
  float dq_acc[kDBlocks][4];
#pragma unroll
  for (int i = 0; i < kDBlocks; ++i) {
    dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;
  }
  const T* q_warp = q_s + (16 * warp + (lane & 15)) * S + 8 * (lane >> 4);
  const T* do_warp = do_s + (16 * warp + (lane & 15)) * S + 8 * (lane >> 4);
  // the bias form: dlogits of (row0 + 8 r, j) and (row0 + 8 r, j + 1) into
  // the partial, j = a tile's key 8 n + 2 c4 (even)
  float* part_rows =
      kBias ? partial + (static_cast<long>(b) * heads + h) * sq * sk
            : nullptr;
  auto store_dl = [&](int r, int j, float lo, float hi) {
    const int i = row0 + 8 * r;
    if (i >= sq || j >= sk) return;
    float* dst = part_rows + static_cast<long>(i) * sk + j;
    if ((sk & 1) == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
    } else {
      dst[0] = lo;
      if (j + 1 < sk) dst[1] = hi;
    }
  };
  auto zero_tile = [&](int k0) {  // a skipped tile's dlogits
#pragma unroll
    for (int c = 0; c < kTcTile; c += 8) {
      store_dl(0, k0 + c + 2 * c4, 0.f, 0.f);
      store_dl(1, k0 + c + 2 * c4, 0.f, 0.f);
    }
  };

  for (int t = 0; t < n_tiles; ++t) {
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
    const uint32_t bits[2] = {mask_s[st][0], mask_s[st][1]};
    // a tile hidden from all the warp's rows, or whose keys are all masked,
    // gives them dS = 0
    if ((bits[0] | bits[1]) != 0 &&
        !(causal && k0 > row_first + 15 + shift)) {
      const T* ks = k_s + st * kElems;
      const T* vs = v_s + st * kElems;
      // a masked key (or one past sk), or a key causally hidden from a row
      // of the warp, somewhere in the tile
      const bool edge = (bits[0] & bits[1]) != 0xffffffffu ||
                        (causal && k0 + kTcTile - 1 > row_first + shift);
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const uint32_t half_bits = half ? bits[1] : bits[0];
        // S = Q K^T and dP = dO V^T: 16 rows x 32 keys a warp
        float s[4][4], dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kKSteps; kk += 2) {
          uint32_t qa[2][4], oa[2][4];
          ldmatrix_x4(qa[0], q_warp + 16 * kk);
          ldmatrix_x4(oa[0], do_warp + 16 * kk);
          if (kk + 1 < kKSteps) {
            ldmatrix_x4(qa[1], q_warp + 16 * (kk + 1));
            ldmatrix_x4(oa[1], do_warp + 16 * (kk + 1));
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              uint32_t kb[4], vb[4];
              const int off = (32 * half + 8 * n + (lane & 7)) * S +
                              16 * kk + 8 * (lane >> 3);
              ldmatrix_x4(kb, ks + off);
              ldmatrix_x4(vb, vs + off);
              mma_tc<T>(s[n], qa[0], kb[0], kb[1]);
              mma_tc<T>(s[n], qa[1], kb[2], kb[3]);
              mma_tc<T>(dp[n], oa[0], vb[0], vb[1]);
              mma_tc<T>(dp[n], oa[1], vb[2], vb[3]);
            }
          } else {  // the odd last k16 step (D = 80)
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              uint32_t kb[2], vb[2];
              const int off = (32 * half + 8 * n + (lane & 7)) * S +
                              16 * kk + 8 * ((lane >> 3) & 1);
              ldmatrix_x2(kb, ks + off);
              ldmatrix_x2(vb, vs + off);
              mma_tc<T>(s[n], qa[0], kb[0], kb[1]);
              mma_tc<T>(dp[n], oa[0], vb[0], vb[1]);
            }
          }
        }

        if constexpr (kBias || kDropout) {
          // dlogits = P (m dP - delta), 0 at masked logits; dS = dlogits
          // scale; the bias of the lane's (row0 + 8 r, col) from the tile
          const TB* bs = b_s + st * kBiasElems + (16 * warp + g) * kBS +
                         32 * half + 2 * c4;
          const int hi = c4 >> 1;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            // the keys of n8 blocks 2 jj and 2 jj + 1: one 16-key group,
            // its calls shared by lanes c4 and c4 ^ 2 as in the forward
            unsigned int own[2][2] = {{0u, 0u}, {0u, 0u}};
            unsigned int other[2][2] = {{0u, 0u}, {0u, 0u}};
            if constexpr (kDropout) {
              const unsigned int c0 =
                  (static_cast<unsigned int>((k0 >> 4) + 2 * half + jj)
                   << 2) |
                  static_cast<unsigned int>(2 * (c4 & 1) + hi);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                philox_pair(drop, c0, row0 + 8 * r, h, b, hi, 2, own[r],
                            other[r]);
              }
            }
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
              const int n = 2 * jj + nn;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                float2 b2 = make_float2(0.f, 0.f);
                if constexpr (kBias) b2 = load2(bs + 8 * r * kBS + 8 * n);
                float dl[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int j = 2 * r + e;
                  const int col = 32 * half + 8 * n + 2 * c4 + e;
                  float x = s[n][j];
                  if constexpr (kBias) {
                    x = __fsub_rn(fmaf(x, scale2,
                                       __fmul_rn(e ? b2.y : b2.x, kLog2e)),
                                  m_i[r]);
                  } else {
                    x = fmaf(x, scale2, -m_i[r]);
                  }
                  float f = 1.f;
                  if constexpr (kDropout) {
                    f = keep_factor(drop, e == hi ? own[r][nn] : other[r][nn]);
                  }
                  const bool ok =
                      !edge || (((half_bits >> (col & 31)) & 1u) &&
                                !(causal && row0 + 8 * r + shift < k0 + col));
                  dl[e] = ok ? ex2(x) * inv_l[r] * (f * dp[n][j] - delta[r])
                             : 0.f;
                  dp[n][j] = dl[e] * scale;
                }
                if constexpr (kBias) {
                  store_dl(r, k0 + 32 * half + 8 * n + 2 * c4, dl[0], dl[1]);
                }
              }
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int r = j >> 1;
              const int col = 32 * half + 8 * n + 2 * c4 + (j & 1);
              const float ds = ex2(fmaf(s[n][j], scale2, -m_i[r])) *
                               inv_l[r] * (dp[n][j] - delta[r]) * scale;
              dp[n][j] =
                  (!edge || (((half_bits >> (col & 31)) & 1u) &&
                             !(causal && row0 + 8 * r + shift < k0 + col)))
                      ? ds
                      : 0.f;
            }
          }
        }

        // dQ += dS K: the k16 blocks are key blocks
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t dsa[4];
          acc_to_a<T>(dsa, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
          for (int db = 0; db < kDBlocks; db += 2) {
            uint32_t kb[4];
            ldmatrix_x4_trans(kb, ks + (32 * half + 16 * j + (lane & 15)) * S +
                                      8 * db + 8 * (lane >> 4));
            mma_tc<T>(dq_acc[db], dsa, kb[0], kb[1]);
            mma_tc<T>(dq_acc[db + 1], dsa, kb[2], kb[3]);
          }
        }
      }
    } else if (kBias) {
      zero_tile(k0);
    }

    if (tp < n_tiles && tid < kTcTile) {
      store_mask_bits(mask_s[tp % kStages], key_next);
    }
  }
  cp_async_wait<0>();
  if constexpr (kBias) {
    // past the block's causal limit
    for (int t = n_tiles; t < n_k; ++t) zero_tile(t * kTcTile);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i >= sq) continue;
    T* dst = dq + q_off + static_cast<long>(i) * rs;
#pragma unroll
    for (int db = 0; db < kDBlocks; ++db) {
      store2(dst + 8 * db + 2 * c4, dq_acc[db][2 * r], dq_acc[db][2 * r + 1]);
    }
  }
}

// a backward body's shape: warps a block, stages of the ring, blocks an SM
// for the register budget
template <int kWarps_, int kStages_, int kMinBlocks_>
struct TcShape {
  static constexpr int kWarps = kWarps_;
  static constexpr int kStages = kStages_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kRows = 16 * kWarps_;
};

// the dK/dV and dQ launches in given shapes on the caller's stream, over
// tensors of T (bf16 or fp16); the bias form reads ba and writes dlogits
// into partial
template <int D, typename KvShape, typename QShape, bool kBias = false,
          bool kDropout = false, typename TB = __nv_bfloat16,
          typename T = __nv_bfloat16>
cudaError_t launch_bwd_tiles_tc_as(const void* q, const void* k,
                                   const void* v, const int* kv_mask,
                                   const void* dout, const float* row_max,
                                   const float* row_sum,
                                   const float* row_delta, void* dq, void* dk,
                                   void* dv, int batch, int sq, int sk,
                                   int heads, float scale, int causal,
                                   cudaStream_t stream,
                                   BiasArgs<TB> ba = BiasArgs<TB>{},
                                   float* partial = nullptr) {
  const int n_q = (sq + kTcTile - 1) / kTcTile;
  const size_t dkdv_bytes =
      dkdv_tc_smem<D, KvShape::kRows, KvShape::kStages, kBias, TB>(n_q);
  const size_t dq_bytes =
      dq_tc_smem<D, QShape::kRows, QShape::kStages, kBias, TB>();
  auto dkdv_kernel =
      attention_bwd_dkdv_tc_kernel<D, KvShape::kWarps, KvShape::kStages,
                                   KvShape::kMinBlocks, kBias, kDropout, TB,
                                   T>;
  auto dq_kernel =
      attention_bwd_dq_tc_kernel<D, QShape::kWarps, QShape::kStages,
                                 QShape::kMinBlocks, kBias, kDropout, TB, T>;
  cudaError_t err = set_smem(dkdv_kernel, dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = set_smem(dq_kernel, dq_bytes);
  if (err != cudaSuccess) return err;
  const auto* q_ = static_cast<const T*>(q);
  const auto* k_ = static_cast<const T*>(k);
  const auto* v_ = static_cast<const T*>(v);
  const auto* do_ = static_cast<const T*>(dout);
  const dim3 k_grid((sk + KvShape::kRows - 1) / KvShape::kRows, heads, batch);
  const dim3 q_grid((sq + QShape::kRows - 1) / QShape::kRows, heads, batch);
  dkdv_kernel<<<k_grid, 32 * KvShape::kWarps, dkdv_bytes, stream>>>(
      q_, k_, v_, kv_mask, do_, row_max, row_sum, row_delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, heads, scale, causal,
      ba);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<<<q_grid, 32 * QShape::kWarps, dq_bytes, stream>>>(
      q_, k_, v_, kv_mask, do_, row_max, row_sum, row_delta,
      static_cast<T*>(dq), sq, sk, heads, scale, causal, ba, partial);
  return cudaGetLastError();
}

// the bodies' shapes on this card. At D = 64 the fastest of those timed at
// OPT-350M's (4, 2048, 16, 64) causal on an H100 (PERF.md §6): 4 warps, a
// 2-stage ring, 3 dK/dV and 4 dQ blocks an SM (more warps, a second
// 16-row slab a warp, or deeper rings spilled registers or lost
// occupancy). The dK and dV accumulators are D / 2 fp32 registers each
// (32 at 64, 40 at 80, 64 at 128), dQ's D / 2: past 64 dK/dV takes 2
// blocks an SM (255 registers a thread), dQ 3 at 80 (170) and 2 at 128.
// fp16 takes the bf16 shapes.
template <int D>
using BwdKvShape = TcShape<4, 2, D == 64 ? 3 : 2>;
template <int D>
using BwdQShape = TcShape<4, 2, D == 64 ? 4 : D == 80 ? 3 : 2>;

template <int D, typename T = __nv_bfloat16>
cudaError_t launch_bwd_tiles_tc(const void* q, const void* k, const void* v,
                                const int* kv_mask, const void* dout,
                                const float* row_max, const float* row_sum,
                                const float* row_delta, void* dq, void* dk,
                                void* dv, int batch, int sq, int sk,
                                int heads, float scale, int causal,
                                cudaStream_t stream) {
  return launch_bwd_tiles_tc_as<D, BwdKvShape<D>, BwdQShape<D>, false,
                                false, T, T>(
      q, k, v, kv_mask, dout, row_max, row_sum, row_delta, dq, dk, dv, batch,
      sq, sk, heads, scale, causal, stream);
}

// the scalar dK/dV and dQ launches (fp32) on the caller's stream
template <int D, typename T>
cudaError_t launch_bwd_tiles(const void* q, const void* k, const void* v,
                             const int* kv_mask, const void* dout,
                             const float* row_max, const float* row_sum,
                             const float* row_delta, void* dq, void* dk,
                             void* dv, int batch, int sq, int sk, int heads,
                             float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = scalar_tiles_smem<D>();
  auto dkdv_kernel = attention_bwd_dkdv_kernel<D, T>;
  auto dq_kernel = attention_bwd_dq_kernel<D, T>;
  cudaError_t err = set_smem(dkdv_kernel, bytes);
  if (err != cudaSuccess) return err;
  err = set_smem(dq_kernel, bytes);
  if (err != cudaSuccess) return err;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const dim3 q_grid((sq + kBwdTile - 1) / kBwdTile, heads, batch);
  const dim3 k_grid((sk + kBwdTile - 1) / kBwdTile, heads, batch);
  dkdv_kernel<<<k_grid, kBwdThreads, bytes, stream>>>(
      q_, k_, v_, kv_mask, do_, row_max, row_sum, row_delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, heads, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<<<q_grid, kBwdThreads, bytes, stream>>>(
      q_, k_, v_, kv_mask, do_, row_max, row_sum, row_delta,
      static_cast<T*>(dq), sq, sk, heads, scale, causal);
  return cudaGetLastError();
}

// delta of (B, Sq, H*D) out and dO in (B, H, Sq) order, on the caller's stream
template <int D, typename T>
cudaError_t launch_delta(const void* out, const void* dout, float* row_delta,
                         int batch, int sq, int heads, cudaStream_t stream) {
  const dim3 grid((sq + kBwdTile - 1) / kBwdTile, heads, batch);
  attention_delta_kernel<D, T><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), row_delta, sq,
      heads);
  return cudaGetLastError();
}

}  // namespace mmgl
