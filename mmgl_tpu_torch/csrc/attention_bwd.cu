// Backward attention without bias or dropout for Hopper (sm_90a): the port of
// the two dense Pallas backward kernels.
//
// Replaces
//   mmgl_allheads_bwd -> _allheads_kernel_bwd (mmgl_tpu/ops/flash_attention.py:1307),
//                        reached through _allheads_vjp_bwd (:1392, pallas_call :1399).
//                        OPT causal self-attention: (4, 640, 12, 64), fp32
//                        (bf16 and fp16 take allheads_wgmma.cu).
//   mmgl_flash_bwd    -> _bwd_kernel (mmgl_tpu/ops/flash_attention.py:414),
//                        pallas_call in _bwd (:457, :472): the backward of K4.
//                        T5's cross-attention, q (B, 128, 12, 64) against
//                        k/v (B, 512, 12, 64), when dropout is off. Under MQA
//                        the wrapper sums dK/dV over the broadcast heads.
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
// padding. Outputs are in the input dtype (fp32, bf16 or fp16); every sum is
// fp32. Head dims 64, 80 (OPT and MPT at 2.7B) and 128 (6.7B): every pass
// is instantiated at each (mmgl::with_head_dim).
//
// Schedule: three launches on the caller's stream, no atomics.
//   1. stats: per query row the softmax max m and sum l (kept apart: for a
//      fully masked row m = -1e30 and l = sk, and a single logsumexp
//      -1e30 + log(sk) would round back to -1e30 in fp32), and delta.
//      One block per (64 query rows, head, batch), the forward's score loop.
//   2. dK/dV: one block per (64 keys, head, batch), looping over query tiles
//      of 64 held in shared memory.
//   3. dQ: one block per (64 query rows, head, batch), looping over key tiles.
// 2 and 3 live in attention_bwd_tiles.cuh, shared with K6, which takes m and
// l from the forward instead of pass 1; the header describes their thread
// layout and which causal tiles they skip.
//
// Two bodies, chosen by the input dtype. fp32 inputs take the scalar passes
// above (on the tensor cores fp32 would run as TF32). bf16 and fp16 inputs
// take the tensor-core bodies, four launches (K5's entry below): K4's
// wgmma/TMA forward body (allheads_wgmma.cuh, in K4's shape) in its
// stats-only form (m and l from the same instructions, in the same order,
// as K4 writes them for K6, so K5 and K6 agree bit for bit), the delta pass,
// then the mma.sync dK/dV and dQ bodies of attention_bwd_tiles.cuh.
//
// What bounds the scalar passes on this card: a few GFLOP of scalar fp32
// FMAs over a few MB, so the throughput of FMAs and shared-memory loads, not
// HBM (3.35 TB/s). Five products per (query, key) pair against the
// forward's two, plus the stats pass that recomputes the scores once more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "allheads_wgmma.cuh"
#include "attention_bwd_tiles.cuh"
#include "common.cuh"

namespace {

using mmgl::dot4;
using mmgl::kNegInf;
using mmgl::load4;
using mmgl::store4;

constexpr int kTile = mmgl::kBwdTile;        // query rows and keys per tile
constexpr int kThreads = mmgl::kBwdThreads;  // four threads per row

// 1. per query row: max m, sum l of exp(logit - m), delta = rowsum(dO * o);
// K rows padded to D + 4 floats as in the forward's scalar body (33.8 KB
// of static shared memory at D = 128)
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const int* __restrict__ kv_mask,
                           const T* __restrict__ out,
                           const T* __restrict__ dout,
                           float* __restrict__ row_max,
                           float* __restrict__ row_sum,
                           float* __restrict__ row_delta, int sq, int sk,
                           int heads, float scale, int causal) {
  __shared__ __align__(16) float k_tile[kTile][D + 4];
  __shared__ int mask_tile[kTile];

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int q0 = blockIdx.x * kTile;
  const int qi = q0 + row;
  const bool row_ok = qi < sq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long rs = static_cast<long>(heads) * D;
  const T* q_rows = q + static_cast<long>(b) * sq * rs + h * D;
  const T* k_rows = k + static_cast<long>(b) * sk * rs + h * D;
  const T* o_rows = out + static_cast<long>(b) * sq * rs + h * D;
  const T* do_rows = dout + static_cast<long>(b) * sq * rs + h * D;
  const int* mask_row = kv_mask + static_cast<long>(b) * sk;

  float qr[D];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
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
    for (int e = tid; e < kTile * (D / 4); e += kThreads) {
      const int r = e / (D / 4);
      const int c = e % (D / 4);
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
      for (int c = 0; c < D / 4; ++c) {
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

  // delta over this thread's D/4 dims, then across the row's four threads
  // (the order of the delta pass, mmgl::attention_delta_kernel)
  float delta = 0.f;
  if (row_ok) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const long off = qi * rs + (D / 4) * sub + 4 * c;
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

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_mask, const void* out, const void* dout,
                   void* dq, void* dk, void* dv, float* stats, int batch,
                   int sq, int sk, int heads, float scale, int causal,
                   cudaStream_t stream) {
  const long n = static_cast<long>(batch) * heads * sq;
  float* row_max = stats;
  float* row_sum = stats + n;
  float* row_delta = stats + 2 * n;

  const dim3 q_grid((sq + kTile - 1) / kTile, heads, batch);
  attention_bwd_stats_kernel<D, T><<<q_grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), kv_mask,
      static_cast<const T*>(out), static_cast<const T*>(dout), row_max,
      row_sum, row_delta, sq, sk, heads, scale, causal);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return mmgl::launch_bwd_tiles<D, T>(q, k, v, kv_mask, dout, row_max,
                                      row_sum, row_delta, dq, dk, dv, batch,
                                      sq, sk, heads, scale, causal, stream);
}

// the scalar passes (fp32): stats, dK/dV, dQ
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* kv_mask, const void* out, const void* dout,
                       void* dq, void* dk, void* dv, float* stats, int batch,
                       int sq, int sk, int heads, int head_dim, float scale,
                       int causal, int dtype, cudaStream_t stream) {
  // bf16, fp16: launch_tc
  if (dtype != mmgl::kF32 ||
      !mmgl::valid_shape(batch, sq, sk, heads, causal)) {
    return cudaErrorInvalidValue;
  }
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    return launch<decltype(d)::value, float>(
        q, k, v, kv_mask, out, dout, dq, dk, dv, stats, batch, sq, sk, heads,
        scale, causal, stream);
  });
}

// the tensor-core bodies (bf16, fp16): stats, delta, dK/dV, dQ
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* kv_mask, const void* out, const void* dout,
                      void* dq, void* dk, void* dv, float* stats, int batch,
                      int sq, int sk, int heads, int head_dim, float scale,
                      int causal, int dtype, cudaStream_t stream) {
  if (!mmgl::valid_shape(batch, sq, sk, heads, causal)) {
    return cudaErrorInvalidValue;
  }
  const long n = static_cast<long>(batch) * heads * sq;
  float* row_max = stats;
  float* row_sum = stats + n;
  float* row_delta = stats + 2 * n;
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return mmgl::with_tc_type(dtype, [&](auto tag) {
      using T = decltype(tag);
      mmgl::wg::Maps m{};
      cudaError_t err = mmgl::wg::make_maps(&m, q, k, nullptr, nullptr,
                                            dtype, batch, sq, sk, heads, D);
      if (err != cudaSuccess) return err;
      err = mmgl::wg::launch_fwd<D, true, mmgl::wg::FwdShape<D>, T>(
          m, kv_mask, nullptr, row_max, row_sum, batch, sq, sk, heads, scale,
          causal, stream);
      if (err != cudaSuccess) return err;
      err = mmgl::launch_delta<D, T>(out, dout, row_delta, batch, sq, heads,
                                     stream);
      if (err != cudaSuccess) return err;
      return mmgl::launch_bwd_tiles_tc<D, T>(
          q, k, v, kv_mask, dout, row_max, row_sum, row_delta, dq, dk, dv,
          batch, sq, sk, heads, scale, causal, stream);
    });
  });
}

}  // namespace

// K3: backward of K1 (OPT's aligned causal self-attention), sq <= sk.
// stats: fp32 scratch of 3 * batch * heads * sq floats.
extern "C" int mmgl_allheads_bwd(const void* q, const void* k, const void* v,
                                 const int* kv_mask, const void* out,
                                 const void* dout, void* dq, void* dk,
                                 void* dv, float* stats, int batch, int sq,
                                 int sk, int heads, int head_dim, float scale,
                                 int causal, int dtype,
                                 cudaStream_t stream) {
  // bf16, fp16: mmgl_allheads_bwd_tc
  return launch_f32(q, k, v, kv_mask, out, dout, dq, dk, dv, stats, batch,
                    sq, sk, heads, head_dim, scale, causal, dtype, stream);
}

// K5: backward of K4 (sq != sk, T5's cross-attention without dropout).
extern "C" int mmgl_flash_bwd(const void* q, const void* k, const void* v,
                              const int* kv_mask, const void* out,
                              const void* dout, void* dq, void* dk, void* dv,
                              float* stats, int batch, int sq, int sk,
                              int heads, int head_dim, float scale,
                              int causal, int dtype, cudaStream_t stream) {
  return mmgl_allheads_bwd(q, k, v, kv_mask, out, dout, dq, dk, dv, stats,
                           batch, sq, sk, heads, head_dim, scale, causal,
                           dtype, stream);
}

// K5 on the tensor-core bodies (dtype bf16 or fp16, mmgl::DType). K3's
// bf16 and fp16 entry, mmgl_allheads_bwd_tc, is in allheads_wgmma.cu.
extern "C" int mmgl_flash_bwd_tc(const void* q, const void* k, const void* v,
                                 const int* kv_mask, const void* out,
                                 const void* dout, void* dq, void* dk,
                                 void* dv, float* stats, int batch, int sq,
                                 int sk, int heads, int head_dim,
                                 float scale, int causal, int dtype,
                                 cudaStream_t stream) {
  return launch_tc(q, k, v, kv_mask, out, dout, dq, dk, dv, stats, batch, sq,
                   sk, heads, head_dim, scale, causal, dtype, stream);
}
