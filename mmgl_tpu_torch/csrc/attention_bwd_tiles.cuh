// The scalar dK/dV and dQ passes of the dense attention backward (fp32):
// K3's and K5's (attention_bwd.cu, after its stats pass) and K6's
// (attention_blocked_bwd.cu, from the forward's saved statistics), and
// the delta pass K6's fp32 body runs first. (Their bf16/fp16 bodies are
// K3's wgmma ones, allheads_wgmma.cuh; the mma.sync tiles those replaced
// are csrc/sweep/mma_sync_tiles.cuh, outside the library.) Given q, k, v,
// the key mask, dO and per query row the softmax max m, sum l and
// delta = rowsum(dO * o):
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
// launch in fp32, and the sweep's mma.sync "before" readings' (JAX
// computes it outside Pallas, mmgl_tpu/ops/flash_attention.py:345-347). Thread sub
// of a row sums the D/4 dims from sub D/4 on, in the order of K3/K5's
// scalar stats pass (attention_bwd.cu), so that K5 and K6 agree bit for
// bit in fp32.
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
