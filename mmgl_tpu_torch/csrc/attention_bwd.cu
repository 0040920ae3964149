// Backward of the allheads attention for Hopper (sm_90a): the port of the
// Pallas kernel that OPT training runs for its causal self-attention.
//
// Replaces
//   mmgl_allheads_bwd -> _allheads_kernel_bwd (mmgl_tpu/ops/flash_attention.py:1307),
//                        reached through _allheads_vjp_bwd (:1392, pallas_call :1399).
//                        OPT causal self-attention: (4, 640, 12, 64), bf16.
// Given q, k, v, the key mask, the forward output o and its gradient dO:
//   P     = softmax(q k^T * scale, masked logits = -1e30)   (recomputed, fp32)
//   dV    = P^T dO
//   delta = rowsum(dO * o)                                  (fp32, from the stored o)
//   dS    = P * (dO v^T - delta) * scale, and 0 wherever the logit was masked
//   dQ    = dS k,  dK = dS^T q
// The zero dS at masked logits follows jax.grad of xla_attention (the JAX
// package's reference), whose jnp.where passes no gradient there. The Pallas
// kernel does not zero them, which only differs for a fully masked row: its
// P is uniform, 1/sk over every key, causally hidden ones included. Such a
// row still feeds dV with that uniform P, and gives no dQ and no dK.
//
// Layout: q/k/v/o/dO and dq/dk/dv are (B, S, H*D) row-major, read and written
// strided in place (row stride H*D), as the forward does: no transposes, no
// padding. Outputs are in the input dtype (fp32 or bf16); every sum is fp32.
//
// Schedule: three launches on the caller's stream, no atomics.
//   1. stats: per query row the softmax max m and sum l (kept apart: for a
//      fully masked row m = -1e30 and l = sk, and a single logsumexp
//      -1e30 + log(sk) would round back to -1e30 in fp32), and delta.
//      One block per (64 query rows, head, batch), the forward's score loop.
//   2. dK/dV: one block per (64 keys, head, batch), looping over query tiles
//      of 64 held in shared memory.
//   3. dQ: one block per (64 query rows, head, batch), looping over key tiles.
// In 2 and 3 four threads share a row (a key in 2, a query in 3); each owns
// the 16 head dims 4c..4c+3 for c = sub + 4t, t = 0..3, so the four 16-byte
// chunks a warp reads from one shared-memory row fall in distinct banks and
// every other row of the warp reads the same addresses (a broadcast). A dot
// product is four partial sums joined by two warp shuffles.
// Causal tiles: dQ skips key tiles past the diagonal (dS is 0 there for every
// row). dK/dV skips a query tile whose rows all lie before its keys only when
// no row of it is fully masked, since such a row feeds dV from every key.
//
// What bounds it on this card: as in the forward, these are a few GFLOP of
// scalar fp32 FMAs over a few MB, so the limit is the throughput of FMAs and
// shared-memory loads, not HBM (3.35 TB/s) or the tensor cores. Five
// products per (query, key) pair against the forward's two, plus the stats
// pass that recomputes the scores once more. mma.sync / wgmma and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using mmgl::axpy4;
using mmgl::dot4;
using mmgl::kD;
using mmgl::kNegInf;
using mmgl::load4;
using mmgl::store4;

constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kThreads = 256;      // four threads per row
constexpr int kKStride = kD + 4;   // padded K row of the stats pass
constexpr int kChunks = kD / 16;   // float4 chunks a thread owns (4)

// 1. per query row: max m, sum l of exp(logit - m), delta = rowsum(dO * o)
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const int* __restrict__ kv_mask,
                           const T* __restrict__ out,
                           const T* __restrict__ dout,
                           float* __restrict__ row_max,
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
  const int shift = sk - sq;  // causal: query i sees key j iff i + shift >= j
  const int q_last = min(q0 + kTile, sq) - 1;

  for (int k0 = 0; k0 < sk; k0 += kTile) {
    if (causal && k0 > q_last + shift) {
      // hidden tiles add exactly 0 to a row that has seen a real logit; a
      // fully masked row counts every key (the forward's rule)
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

  // delta over this thread's 16 dims, then across the row's four threads
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ kv_mask,
                          const T* __restrict__ dout,
                          const float* __restrict__ row_max,
                          const float* __restrict__ row_sum,
                          const float* __restrict__ row_delta,
                          T* __restrict__ dk, T* __restrict__ dv, int sq,
                          int sk, int heads, float scale, int causal) {
  __shared__ __align__(16) float q_tile[kTile][kD];
  __shared__ __align__(16) float do_tile[kTile][kD];
  __shared__ float m_tile[kTile];
  __shared__ float inv_l_tile[kTile];
  __shared__ float delta_tile[kTile];

  const int tid = threadIdx.x;
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
      // every (query, key) pair of the tile is causally hidden: only a fully
      // masked query row contributes (to dV, with P = 1/sk)
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

// 3. dQ for 64 query rows, looping over the key tiles
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_mask,
                        const T* __restrict__ dout,
                        const float* __restrict__ row_max,
                        const float* __restrict__ row_sum,
                        const float* __restrict__ row_delta,
                        T* __restrict__ dq, int sq, int sk, int heads,
                        float scale, int causal) {
  __shared__ __align__(16) float k_tile[kTile][kD];
  __shared__ __align__(16) float v_tile[kTile][kD];
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
  const long q_off = static_cast<long>(b) * sq * rs + h * kD;
  const T* k_rows = k + static_cast<long>(b) * sk * rs + h * kD;
  const T* v_rows = v + static_cast<long>(b) * sk * rs + h * kD;
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
  const int q_last = min(q0 + kTile, sq) - 1;

  for (int k0 = 0; k0 < sk; k0 += kTile) {
    if (causal && k0 > q_last + shift) break;  // dS = 0 past the diagonal
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_mask, const void* out, const void* dout,
                   void* dq, void* dk, void* dv, float* stats, int batch,
                   int sq, int sk, int heads, int head_dim, float scale,
                   int causal, cudaStream_t stream) {
  if (head_dim != kD || batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 ||
      sq > sk || batch > 65535 || heads > 65535) {
    return cudaErrorInvalidValue;
  }
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(out);
  const T* do_ = static_cast<const T*>(dout);
  const long n = static_cast<long>(batch) * heads * sq;
  float* row_max = stats;
  float* row_sum = stats + n;
  float* row_delta = stats + 2 * n;

  const dim3 q_grid((sq + kTile - 1) / kTile, heads, batch);
  const dim3 k_grid((sk + kTile - 1) / kTile, heads, batch);
  attention_bwd_stats_kernel<T><<<q_grid, kThreads, 0, stream>>>(
      q_, k_, kv_mask, o_, do_, row_max, row_sum, row_delta, sq, sk, heads,
      scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<T><<<k_grid, kThreads, 0, stream>>>(
      q_, k_, v_, kv_mask, do_, row_max, row_sum, row_delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, heads, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<T><<<q_grid, kThreads, 0, stream>>>(
      q_, k_, v_, kv_mask, do_, row_max, row_sum, row_delta,
      static_cast<T*>(dq), sq, sk, heads, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// K3: backward of K1 (OPT's aligned causal self-attention), sq <= sk.
// stats: fp32 scratch of 3 * batch * heads * sq floats.
extern "C" int mmgl_allheads_bwd(const void* q, const void* k, const void* v,
                                 const int* kv_mask, const void* out,
                                 const void* dout, void* dq, void* dk,
                                 void* dv, float* stats, int batch, int sq,
                                 int sk, int heads, int head_dim, float scale,
                                 int causal, int is_bf16,
                                 cudaStream_t stream) {
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, kv_mask, out, dout, dq, dk, dv,
                                 stats, batch, sq, sk, heads, head_dim, scale,
                                 causal, stream);
  }
  return launch<float>(q, k, v, kv_mask, out, dout, dq, dk, dv, stats, batch,
                       sq, sk, heads, head_dim, scale, causal, stream);
}
