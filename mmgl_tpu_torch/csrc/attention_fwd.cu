// Forward attention for Hopper (sm_90a): the port of the three Pallas kernels
// without bias or dropout (OPT, CLIP, and T5's cross-attention in eval).
//
// Replaces
//   mmgl_allheads_fwd    -> _allheads_kernel_fwd (mmgl_tpu/ops/flash_attention.py:1283),
//                           reached through flash_attention_allheads (:1422).
//                           OPT causal self-attention: (4, 640|512, 12, 64),
//                           fp32 (bf16 and fp16 take allheads_wgmma.cu).
//   mmgl_fused_heads_fwd -> _fused_heads_kernel (mmgl_tpu/ops/flash_attention.py:1152),
//                           reached through fused_heads_attention (:1244).
//                           CLIP vision self-attention: (24, 197, 12, 64).
//   mmgl_flash_fwd       -> _fwd_kernel (mmgl_tpu/ops/flash_attention.py:87),
//                           pallas_call in _fwd (:179, :209), reached through
//                           flash_attention (:1447). T5's eval cross-attention:
//                           q (4, 128, 12, 64), k/v (4, 512, 12, 64); OPT-350M's
//                           causal self-attention at 2048 tokens, past K1's
//                           envelope: (4, 2048, 16, 64). Its online softmax
//                           with causal tile skipping stands for both
//                           _fwd_kernel and _fwd_kernel_causal_stream (:129),
//                           and it writes the rows' max and sum for the
//                           blocked backward (K6) when asked, as _fwd's
//                           with_lse output does.
// All three compute xla_attention's math (mmgl_tpu/ops/attention.py:190-224):
//   out = softmax(q k^T * scale, masked logits = -1e30) v
// with causal masking aligned at the ends (key j visible to query i iff
// i + (sk - sq) >= j) and columns at or beyond sk weighted 0. A masked key is
// never skipped, so a fully masked row returns the mean of v over the sk keys.
//
// Why one kernel for all three: the TPU split them over 128-lane alignment (S % 128)
// and VMEM residency of whole sequences, and ran the per-(b*h) kernel on a
// (B*H, S, D) transpose. None of that exists here: a block reads any sequence
// length through its own bounds checks, streams K/V through shared memory
// instead of holding the sequence, and reads the heads strided in place. A
// broadcast (MQA) K/V head is expanded by the wrapper, as flash_attention
// broadcasts it outside its kernel (:1462).
//
// Layout: q/k/v/out are (B, S, H*D) row-major, the layout the QKV projections
// produce. Each block reads its head's columns strided straight from it (row
// stride H*D), so nothing is transposed, which is the point of the allheads
// kernel (flash_attention.py:1268-1277).
//
// Two bodies, chosen by the input dtype. bf16 and fp16 inputs take the
// wgmma/TMA forward of allheads_wgmma.cuh (entries *_tc below for K2 and
// K4, allheads_wgmma.cu for K1): K1's body at any sq and sk, with its row
// stats where asked; one producer warp streams K and V through an mbarrier
// ring, the consumer warpgroups run S = Q K^T and P V on wgmma; a null
// key mask means every key is valid. fp32 inputs take the scalar body
// here: on the tensor cores fp32 would run as TF32, about three decimal
// digits, and the fp32 checks hold the kernels to 2e-5.
//
// What bounds the scalar body on this card: scalar fp32 FMAs, so the
// shared-memory load rate feeding them (one 16-byte load per four FMAs). The
// design keeps that rate down: four threads share a query row, so a K/V tile
// read from shared memory is broadcast to the eight rows of a warp; K rows
// are padded to 68 floats and V columns interleaved so that 16-byte loads hit
// distinct banks; probabilities move between the four threads of a row by
// warp shuffles, not through shared memory. Causal tiles past the diagonal
// are skipped only once every row of the block has seen a real logit, where
// they add exactly zero.
//
// Scalar schedule: one block of 256 threads per (query tile of 64, head,
// batch).
// Thread t owns query row t/4 and, of each 64-key tile, keys (t%4) + 4i for
// the scores and output columns 4((t%4) + 4i) .. +3, i < D/16, for the PV
// product. Softmax is online in fp32 registers; PV accumulates in fp32; the
// output is written in fp32.
//
// Head dims: 64, 80 and 128 (OPT and MPT at 2.7B take 80, at 6.7B 128),
// each body instantiated at each (mmgl::with_head_dim); the K and V tiles,
// 66.5 KB at 128, are dynamic shared memory. K2 takes 64 only (its
// wrapper refuses the rest: no model sends it another).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "allheads_wgmma.cuh"
#include "common.cuh"

namespace {

using mmgl::kNegInf;
using mmgl::load4;
using mmgl::store4;

constexpr int kTileQ = 64;         // query rows per block
constexpr int kTileK = 64;         // keys per shared-memory tile
constexpr int kThreads = 256;      // four threads per query row

// a K row padded to D + 4 floats: 16-byte aligned, and the four rows a
// warp's 16-byte loads read at once (sub + 4i) fall in distinct banks
// (stride D + 4 is 4 words modulo 32 at 64 and 128, 20 at 80)
template <int D>
__host__ __device__ constexpr int k_stride() {
  return D + 4;
}

// the dynamic shared memory of the scalar body: the K and V tiles
template <int D>
constexpr size_t fwd_smem() {
  return kTileK * (k_stride<D>() + D) * sizeof(float);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ kv_mask,
                     T* __restrict__ out, float* __restrict__ row_max,
                     float* __restrict__ row_sum, int sq, int sk, int heads,
                     float scale, int causal) {
  constexpr int kKStride = k_stride<D>();
  constexpr int kChunks = D / 16;  // float4 output chunks a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  float (*k_tile)[kKStride] = reinterpret_cast<float (*)[kKStride]>(smem);
  float (*v_tile)[D] =
      reinterpret_cast<float (*)[D]>(smem + kTileK * kKStride * sizeof(float));
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

  const long row_stride = static_cast<long>(heads) * D;
  const T* q_rows = q + static_cast<long>(b) * sq * row_stride + h * D;
  const T* k_rows = k + static_cast<long>(b) * sk * row_stride + h * D;
  const T* v_rows = v + static_cast<long>(b) * sk * row_stride + h * D;
  T* out_rows = out + static_cast<long>(b) * sq * row_stride + h * D;
  const int* mask_row = kv_mask + static_cast<long>(b) * sk;

  // the query row, whole, in registers (each of its four threads holds it)
  float qr[D];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 x = row_ok ? load4(q_rows + qi * row_stride + 4 * c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * c + 0] = x.x;
    qr[4 * c + 1] = x.y;
    qr[4 * c + 2] = x.z;
    qr[4 * c + 3] = x.w;
  }

  float acc[4 * kChunks];
#pragma unroll
  for (int i = 0; i < 4 * kChunks; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;  // running max of the row's logits
  float l_run = 0.f;        // running sum of exp(logit - m_run)

  const int shift = sk - sq;  // causal: query i sees key j iff i + shift >= j
  const int q_last = min(q0 + kTileQ, sq) - 1;

  for (int k0 = 0; k0 < sk; k0 += kTileK) {
    if (causal && k0 > q_last + shift) {
      // Every key from here on is causally hidden from every row of this
      // block. Its logit is -1e30, which adds exactly 0 to a row that has
      // seen a real logit; a row whose visible keys are all masked still
      // needs it (its softmax is uniform over all sk keys).
      if (__syncthreads_and(!row_ok || m_run > kNegInf)) break;
    }
    __syncthreads();  // the previous tile is consumed

    for (int e = tid; e < kTileK * (D / 4); e += kThreads) {
      const int r = e / (D / 4);
      const int c = e % (D / 4);
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
      for (int c = 0; c < D / 4; ++c) {
        const float4 kx = *reinterpret_cast<const float4*>(&k_tile[r][4 * c]);
        dot = fmaf(qr[4 * c + 0], kx.x, dot);
        dot = fmaf(qr[4 * c + 1], kx.y, dot);
        dot = fmaf(qr[4 * c + 2], kx.z, dot);
        dot = fmaf(qr[4 * c + 3], kx.w, dot);
      }
      float logit = dot * scale;
      if (mask_tile[r] == 0 || (causal && qi + shift < j)) logit = kNegInf;
      s[i] = (j < sk) ? logit : -INFINITY;  // past sk: weight 0
      tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));

    // key k0 < sk, so tile_max and m_new are finite
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
    for (int i = 0; i < 4 * kChunks; ++i) acc[i] *= alpha;

    // acc[4t..4t+3] += sum_j p_j v[j, 4(sub + 4t) .. +3]
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[i], (lane & ~3) | src);
        const int r = src + 4 * i;
#pragma unroll
        for (int t = 0; t < kChunks; ++t) {
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

  if (row_max != nullptr && row_ok && sub == 0) {
    // K4's row statistics for the blocked backward (K6), kept apart as K3's
    // stats pass keeps them: for a fully masked row m = -1e30 and l = sk,
    // where one logsumexp -1e30 + log(sk) would round back to -1e30
    const long idx = (static_cast<long>(b) * heads + h) * sq + qi;
    row_max[idx] = m_run;
    row_sum[idx] = l_run;
  }
  if (row_ok) {
    const float inv = 1.f / l_run;
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
      store4(out_rows + qi * row_stride + 4 * (sub + 4 * t),
             make_float4(acc[4 * t + 0] * inv, acc[4 * t + 1] * inv,
                         acc[4 * t + 2] * inv, acc[4 * t + 3] * inv));
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_mask, void* out, float* row_max,
                   float* row_sum, int batch, int sq, int sk, int heads,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = fwd_smem<D>();
  auto kernel = attention_fwd_kernel<D, T>;
  const cudaError_t err = mmgl::set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kTileQ - 1) / kTileQ, heads, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_mask, static_cast<T*>(out), row_max,
      row_sum, sq, sk, heads, scale, causal);
  return cudaGetLastError();
}

// the scalar body: fp32 only (bf16 and fp16 take dispatch_flash_tc)
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* kv_mask, void* out, float* row_max,
                     float* row_sum, int batch, int sq, int sk, int heads,
                     int head_dim, float scale, int causal, int dtype,
                     cudaStream_t stream) {
  if (dtype != mmgl::kF32 ||
      !mmgl::valid_shape(batch, sq, sk, heads, causal)) {
    return cudaErrorInvalidValue;
  }
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    return launch<decltype(d)::value, float>(q, k, v, kv_mask, out, row_max,
                                             row_sum, batch, sq, sk, heads,
                                             scale, causal, stream);
  });
}

// K2's and K4's tensor-core body (wgmma, TMA): bf16 and fp16; a null
// kv_mask means every key is valid
cudaError_t dispatch_flash_tc(const void* q, const void* k, const void* v,
                              const int* kv_mask, void* out, float* row_max,
                              float* row_sum, int batch, int sq, int sk,
                              int heads, int head_dim, float scale,
                              int causal, int dtype, cudaStream_t stream) {
  if (!mmgl::valid_shape(batch, sq, sk, heads, causal)) {
    return cudaErrorInvalidValue;
  }
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return mmgl::with_tc_type(dtype, [&](auto tag) {
      using T = decltype(tag);
      mmgl::wg::Maps m;
      const cudaError_t err = mmgl::wg::make_maps(&m, q, k, v, nullptr,
                                                  dtype, batch, sq, sk,
                                                  heads, D);
      if (err != cudaSuccess) return err;
      return mmgl::wg::launch_fwd<D, false, mmgl::wg::FwdShape<D>, T>(
          m, kv_mask, out, row_max, row_sum, batch, sq, sk, heads, scale,
          causal, stream);
    });
  });
}

}  // namespace

// K1: OPT's aligned self-attention (eval 640, prefill 512), sq <= sk.
extern "C" int mmgl_allheads_fwd(const void* q, const void* k, const void* v,
                                 const int* kv_mask, void* out, int batch,
                                 int sq, int sk, int heads, int head_dim,
                                 float scale, int causal, int dtype,
                                 cudaStream_t stream) {
  return dispatch(q, k, v, kv_mask, out, nullptr, nullptr, batch, sq, sk,
                  heads, head_dim, scale, causal, dtype, stream);
}

// K2: CLIP's lane-misaligned self-attention (197 patches), sq == sk.
extern "C" int mmgl_fused_heads_fwd(const void* q, const void* k,
                                    const void* v, const int* kv_mask,
                                    void* out, int batch, int seq, int heads,
                                    int head_dim, float scale, int causal,
                                    int dtype, cudaStream_t stream) {
  return dispatch(q, k, v, kv_mask, out, nullptr, nullptr, batch, seq, seq,
                  heads, head_dim, scale, causal, dtype, stream);
}

// K4: T5's cross-attention in eval (sq != sk), aligned self-attention past
// K1's envelope (OPT at 2048 tokens), and any call without bias or dropout
// that K1 and K2 do not serve. row_max and row_sum, each batch * heads * sq
// fp32 in (B, H, Sq) order, receive the rows' softmax max and sum when not
// null (the blocked backward's residuals, the Pallas with_lse output at
// mmgl_tpu/ops/flash_attention.py:118-121).
extern "C" int mmgl_flash_fwd(const void* q, const void* k, const void* v,
                              const int* kv_mask, void* out, float* row_max,
                              float* row_sum, int batch, int sq, int sk,
                              int heads, int head_dim, float scale,
                              int causal, int dtype, cudaStream_t stream) {
  return dispatch(q, k, v, kv_mask, out, row_max, row_sum, batch, sq, sk,
                  heads, head_dim, scale, causal, dtype, stream);
}

// K2 and K4 on the wgmma/TMA body (dtype bf16 or fp16; the entries above
// take fp32 only). dtype: mmgl::DType (common.cuh). kv_mask may be null
// (every key valid). K2 is K1's forward at sq == sk without its row stats:
// CLIP's (24, 197, 12, 64), whose 197 rows TMA's zero fill and the key
// bits cut, and its text tower's (44, 77, 8, 64) causal. K1's bf16 and
// fp16 entry, mmgl_allheads_fwd_tc, is in allheads_wgmma.cu.
extern "C" int mmgl_fused_heads_fwd_tc(const void* q, const void* k,
                                       const void* v, const int* kv_mask,
                                       void* out, int batch, int seq,
                                       int heads, int head_dim, float scale,
                                       int causal, int dtype,
                                       cudaStream_t stream) {
  return dispatch_flash_tc(q, k, v, kv_mask, out, nullptr, nullptr, batch,
                           seq, seq, heads, head_dim, scale, causal, dtype,
                           stream);
}

extern "C" int mmgl_flash_fwd_tc(const void* q, const void* k, const void* v,
                                 const int* kv_mask, void* out,
                                 float* row_max, float* row_sum, int batch,
                                 int sq, int sk, int heads, int head_dim,
                                 float scale, int causal, int dtype,
                                 cudaStream_t stream) {
  return dispatch_flash_tc(q, k, v, kv_mask, out, row_max, row_sum, batch,
                           sq, sk, heads, head_dim, scale, causal, dtype,
                           stream);
}

extern "C" const char* mmgl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
