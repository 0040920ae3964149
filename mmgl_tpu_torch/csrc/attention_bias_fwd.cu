// Forward attention with an additive bias and attention-prob dropout for
// Hopper (sm_90a): the port of the Pallas kernel T5 runs for every attention
// that has a relative-position bias or trains with dropout.
//
// Replaces
//   mmgl_bias_fwd -> _fwd_bias_kernel_batched (mmgl_tpu/ops/flash_attention.py:624,
//                    pallas_call :779) and _fwd_bias_kernel (:594, pallas_call
//                    :810), both in _fwd_bias (:768), reached through
//                    flash_attention_bias (:1069). T5-base shapes:
//                      encoder self  (4, 512, 12, 64), bias (12, 512, 512);
//                      decoder self  (4, 128, 12, 64) causal, bias (12, 128, 128);
//                      cross (training) q (4, 128, 12, 64), k/v (4, 512, 12, 64),
//                      no bias, dropout 0.1; scale 1.0 (T5 is unscaled).
// It computes xla_attention's math (mmgl_tpu/ops/attention.py:190-224):
//   logits = q k^T * scale + bias[h]          (fp32; bias bf16 or fp32)
//   logits = -1e30 at masked keys and causally hidden ones (ends aligned)
//   p      = softmax(logits)
//   p      = p * keep_factor                  (dropout: 1/keep or 0)
//   out    = p v
// The dropout comes after the normalisation, so the online softmax sums
// exp(logit - m) without the factor and only the PV product takes it. The
// factor is a pure function of (seed, b, h, i, j) (philox.cuh), so the
// backward (attention_bias_bwd.cu) regenerates the same mask and the plain
// torch version drops the same elements. The TPU drew its bits from the
// hardware PRNG per (program, block), which nothing here reproduces.
//
// The TPU split this kernel into a batched and a serial schedule over VMEM
// size and grid order. Here one schedule serves all shapes, with two bodies
// chosen by the input dtype, as K1-K6's are:
//   * bf16 (mmgl_bias_fwd_tc): the tensor-core forward body of
//     attention_fwd_tc.cuh in its bias form (kBias, kDropout): one block of
//     4 warps per (64 query rows, head, batch), S and P V on mma.sync, each
//     64 x 64 tile of the bias brought into the cp.async ring beside K and
//     V and added in log2 units with the scale (one FMA an element), the
//     keep factors applied to the P fragment before it is rounded to bf16
//     (one Philox call a lane per row and 16 keys, two words swapped with
//     the quad partner by a shuffle); where a gradient follows it also
//     writes the rows' max and sum, from which K8/K9 starts;
//   * fp32 (mmgl_bias_fwd): the scalar body below (on the tensor cores
//     fp32 would run as TF32): one block of 256 threads per (64 query rows,
//     head, batch), K/V streamed through shared memory in tiles of 64 keys,
//     four threads a row, the bias row read from device memory by each
//     thread for its 16 keys of a tile, and one Philox call per thread for
//     its keys sub + 16t' + 4u, u = 0..3.
// BSHD is read strided in place. With no bias (the training
// cross-attention) no bias pointer is passed and nothing is read.
//
// What bounds it on this card: 4 D FLOPs per (query, key) pair on the
// tensor cores (3.2 GFLOP at the encoder shape, 3.3 us at 989 TFLOP/s);
// the bias, 2 bytes a pair from L2 (25 MB at the encoder shape, 6.3 MB of
// it unique, read once per batch element); with dropout, Philox's integer
// work, ten rounds of multiplies per four probabilities, B H Sq Sk / 4
// calls a pass (3.1 M at the encoder shape), more than the products: the
// design makes each call once. At T5's decoder shapes the grid has 96
// blocks of 64 rows for 132 SMs, and the wrapper's host time per call is
// of the kernel's order (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_fwd_tc.cuh"
#include "common.cuh"
#include "philox.cuh"

namespace {

using mmgl::kD;
using mmgl::kNegInf;
using mmgl::load1;
using mmgl::load4;
using mmgl::store4;

constexpr int kTileQ = 64;         // query rows per block
constexpr int kTileK = 64;         // keys per shared-memory tile
constexpr int kThreads = 256;      // four threads per query row
constexpr int kKStride = kD + 4;   // padded K row: 16-byte aligned, conflict-free

template <typename T, typename TB>
__global__ void __launch_bounds__(kThreads)
attention_bias_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ kv_mask,
                          const TB* __restrict__ bias,
                          const long long* __restrict__ seed,
                          T* __restrict__ out, int sq, int sk, int heads,
                          float scale, int causal, unsigned int threshold,
                          float keep_inv) {
  __shared__ __align__(16) float k_tile[kTileK][kKStride];
  __shared__ __align__(16) float v_tile[kTileK][kD];
  __shared__ int mask_tile[kTileK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int q0 = blockIdx.x * kTileQ;
  const int qi = q0 + row;
  const bool row_ok = qi < sq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long row_stride = static_cast<long>(heads) * kD;
  const T* q_rows = q + static_cast<long>(b) * sq * row_stride + h * kD;
  const T* k_rows = k + static_cast<long>(b) * sk * row_stride + h * kD;
  const T* v_rows = v + static_cast<long>(b) * sk * row_stride + h * kD;
  T* out_rows = out + static_cast<long>(b) * sq * row_stride + h * kD;
  const int* mask_row = kv_mask + static_cast<long>(b) * sk;
  // this row's bias, (H, Sq, Sk) batch-shared; null without a bias
  const TB* bias_row =
      (bias != nullptr && row_ok)
          ? bias + (static_cast<long>(h) * sq + qi) * sk
          : nullptr;
  const mmgl::DropoutKey drop = mmgl::load_dropout_key(seed, threshold,
                                                       keep_inv);

  float qr[kD];
#pragma unroll
  for (int c = 0; c < kD / 4; ++c) {
    const float4 x = row_ok ? load4(q_rows + qi * row_stride + 4 * c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * c + 0] = x.x;
    qr[4 * c + 1] = x.y;
    qr[4 * c + 2] = x.z;
    qr[4 * c + 3] = x.w;
  }

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;  // running max of the row's logits
  float l_run = 0.f;        // running sum of exp(logit - m_run), undropped

  const int shift = sk - sq;  // causal: query i sees key j iff i + shift >= j
  const int q_last = min(q0 + kTileQ, sq) - 1;

  for (int k0 = 0; k0 < sk; k0 += kTileK) {
    if (causal && k0 > q_last + shift) {
      // hidden tiles add exactly 0 to a row that has seen a real logit; a
      // fully masked row still needs them (uniform over all sk keys)
      if (__syncthreads_and(!row_ok || m_run > kNegInf)) break;
    }
    __syncthreads();  // the previous tile is consumed

    for (int e = tid; e < kTileK * (kD / 4); e += kThreads) {
      const int r = e >> 4;
      const int c = e & 15;
      const int j = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (j < sk) {
        kx = load4(k_rows + j * row_stride + 4 * c);
        vx = load4(v_rows + j * row_stride + 4 * c);
      }
      store4(&k_tile[r][4 * c], kx);
      store4(&v_tile[r][4 * c], vx);
    }
    if (tid < kTileK) {
      mask_tile[tid] = (k0 + tid < sk) ? mask_row[k0 + tid] : 0;
    }
    __syncthreads();

    // scores of keys sub + 4i, i = 0..15
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
      s[i] = (j < sk) ? logit : -INFINITY;  // past sk: weight 0
      tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));

    const float m_new = fmaxf(m_run, tile_max);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      s[i] = (s[i] == -INFINITY) ? 0.f : expf(s[i] - m_new);
      psum += s[i];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;

    if (drop.on) {
      // keys sub + 16t + 4u share the Philox call of their 16-key group
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j0 = k0 + sub + 16 * t;
        const mmgl::Philox4 rnd = mmgl::dropout_group(drop, b, h, qi, j0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[4 * t + u] *= mmgl::dropout_factor(drop, rnd, j0 + 4 * u);
        }
      }
    }

    // acc[4t..4t+3] += sum_j p_j v[j, 4(sub + 4t) .. +3]
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[i], (lane & ~3) | src);
        const int r = src + 4 * i;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 vx =
              *reinterpret_cast<const float4*>(&v_tile[r][4 * (sub + 4 * t)]);
          acc[4 * t + 0] = fmaf(p, vx.x, acc[4 * t + 0]);
          acc[4 * t + 1] = fmaf(p, vx.y, acc[4 * t + 1]);
          acc[4 * t + 2] = fmaf(p, vx.z, acc[4 * t + 2]);
          acc[4 * t + 3] = fmaf(p, vx.w, acc[4 * t + 3]);
        }
      }
    }
  }

  if (row_ok) {
    const float inv = 1.f / l_run;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      store4(out_rows + qi * row_stride + 4 * (sub + 4 * t),
             make_float4(acc[4 * t + 0] * inv, acc[4 * t + 1] * inv,
                         acc[4 * t + 2] * inv, acc[4 * t + 3] * inv));
    }
  }
}

template <typename T, typename TB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_mask, const void* bias,
                   const long long* seed, void* out, int batch, int sq,
                   int sk, int heads, int head_dim, float scale, int causal,
                   unsigned int threshold, float keep_inv,
                   cudaStream_t stream) {
  if (head_dim != kD || batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 ||
      (causal && sq > sk) || batch > 65535 || heads > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((sq + kTileQ - 1) / kTileQ, heads, batch);
  attention_bias_fwd_kernel<T, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_mask, static_cast<const TB*>(bias), seed,
      static_cast<T*>(out), sq, sk, heads, scale, causal, threshold,
      keep_inv);
  return cudaGetLastError();
}

// the tensor-core body in one (bias, dropout) form
template <bool kBias, bool kDropout, typename TB>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* kv_mask, const void* bias, int bias_ld,
                      const long long* seed, void* out, float* row_max,
                      float* row_sum, int batch, int sq, int sk, int heads,
                      float scale, int causal, unsigned int threshold,
                      float keep_inv, cudaStream_t stream) {
  const mmgl::BiasArgs<TB> ba{static_cast<const TB*>(bias), bias_ld, seed,
                              threshold, keep_inv};
  return mmgl::launch_fwd_tc<kD, false, kBias, kDropout, TB>(
      q, k, v, kv_mask, out, row_max, row_sum, batch, sq, sk, heads, scale,
      causal, stream, ba);
}

}  // namespace

// K7 on the scalar body, fp32 inputs (is_bf16 must be 0: bf16 takes
// mmgl_bias_fwd_tc). bias: (heads, sq, sk) contiguous, or null; bias_bf16
// gives its dtype. seed: two int64 words on the device, or null for no
// dropout; an element is kept iff its Philox word < threshold, and then
// scaled by keep_inv.
extern "C" int mmgl_bias_fwd(const void* q, const void* k, const void* v,
                             const int* kv_mask, const void* bias,
                             const long long* seed, void* out, int batch,
                             int sq, int sk, int heads, int head_dim,
                             float scale, int causal, unsigned int threshold,
                             float keep_inv, int is_bf16, int bias_bf16,
                             cudaStream_t stream) {
  if (is_bf16) return cudaErrorInvalidValue;
  if (bias_bf16) {
    return launch<float, __nv_bfloat16>(
        q, k, v, kv_mask, bias, seed, out, batch, sq, sk, heads, head_dim,
        scale, causal, threshold, keep_inv, stream);
  }
  return launch<float, float>(q, k, v, kv_mask, bias, seed, out, batch, sq,
                              sk, heads, head_dim, scale, causal, threshold,
                              keep_inv, stream);
}

// K7 on the bf16 tensor-core body (is_bf16 must be 1): the arguments of
// mmgl_bias_fwd, plus row_max and row_sum, each batch * heads * sq fp32 in
// (B, H, Sq) order, which receive the rows' softmax max and sum when not
// null (for K8/K9), and bias_ld, the bias's row stride: sk rounded up to a
// multiple of 8, the bias padded to it.
extern "C" int mmgl_bias_fwd_tc(const void* q, const void* k, const void* v,
                                const int* kv_mask, const void* bias,
                                const long long* seed, void* out,
                                float* row_max, float* row_sum, int batch,
                                int sq, int sk, int heads, int head_dim,
                                float scale, int causal,
                                unsigned int threshold, float keep_inv,
                                int is_bf16, int bias_bf16, int bias_ld,
                                cudaStream_t stream) {
  if (!is_bf16 || head_dim != kD || batch <= 0 || sq <= 0 || sk <= 0 ||
      heads <= 0 || (causal && sq > sk) || batch > 65535 || heads > 65535 ||
      (bias != nullptr && (bias_ld < sk || bias_ld % 8 != 0))) {
    return cudaErrorInvalidValue;
  }
#define MMGL_BIAS_FWD_TC(B, DROP, TB)                                        \
  launch_tc<B, DROP, TB>(q, k, v, kv_mask, bias, bias_ld, seed, out,         \
                         row_max, row_sum, batch, sq, sk, heads, scale,      \
                         causal, threshold, keep_inv, stream)
  const bool drop = seed != nullptr;
  if (bias == nullptr) {
    return drop ? MMGL_BIAS_FWD_TC(false, true, __nv_bfloat16)
                : MMGL_BIAS_FWD_TC(false, false, __nv_bfloat16);
  }
  if (bias_bf16) {
    return drop ? MMGL_BIAS_FWD_TC(true, true, __nv_bfloat16)
                : MMGL_BIAS_FWD_TC(true, false, __nv_bfloat16);
  }
  return drop ? MMGL_BIAS_FWD_TC(true, true, float)
              : MMGL_BIAS_FWD_TC(true, false, float);
#undef MMGL_BIAS_FWD_TC
}
