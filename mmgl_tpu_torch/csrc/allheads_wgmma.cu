// The entries of K1 and K3 on their wgmma/TMA bodies (allheads_wgmma.cuh),
// bf16 and fp16 at head dims 64, 80 and 128; fp32 keeps the scalar bodies
// of attention_fwd.cu (mmgl_allheads_fwd) and attention_bwd.cu
// (mmgl_allheads_bwd).
//
//   mmgl_allheads_fwd_tc -> _allheads_kernel_fwd
//                           (mmgl_tpu/ops/flash_attention.py:1283, via
//                           _allheads_fwd :1359): OPT's self-attention,
//                           (4, 640, 12, 64) causal on the main path.
//   mmgl_allheads_bwd_tc -> _allheads_kernel_bwd (:1307, via
//                           _allheads_vjp_bwd :1392): its dQ, dK, dV.
//
// Each entry encodes its tensor maps on the host (one a tensor, a few
// hundred nanoseconds each), passes them to the kernels as __grid_constant__
// parameters, and launches on the caller's stream. A null kv_mask means
// every key is valid (no mask tensor to build). The forward writes the rows'
// max and sum where row_max is not null (a gradient follows); the backward
// starts from them where given, and otherwise runs the forward body in its
// stats-only form first, so that both agree bit for bit. Then the dQ body,
// which also writes delta = rowsum(dO * o) in the order of the delta pass
// (attention_bwd_tiles.cuh) it replaces, and the dK/dV body: two or three
// launches, no atomics.

#include <cuda.h>
#include <cuda_runtime.h>

#include "allheads_wgmma.cuh"
#include "common.cuh"
#include "hopper.cuh"

// K1 on the wgmma/TMA body (dtype bf16 or fp16, mmgl::DType). row_max and
// row_sum: null, or batch * heads * sq fp32 each in (B, H, Sq) order for
// the rows' softmax max and sum (kept apart: a fully masked row has
// m = -1e30 and l = sk).
extern "C" int mmgl_allheads_fwd_tc(const void* q, const void* k,
                                    const void* v, const int* kv_mask,
                                    void* out, float* row_max,
                                    float* row_sum, int batch, int sq, int sk,
                                    int heads, int head_dim, float scale,
                                    int causal, int dtype,
                                    cudaStream_t stream) {
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

// K3 on the wgmma/TMA bodies (dtype bf16 or fp16). row_max and row_sum:
// K1's for the same inputs, or null; scratch: batch * heads * sq fp32 for
// delta, and twice that more where row_max is null (the stats pass's
// output).
extern "C" int mmgl_allheads_bwd_tc(const void* q, const void* k,
                                    const void* v, const int* kv_mask,
                                    const void* out, const void* dout,
                                    void* dq, void* dk, void* dv,
                                    float* scratch, const float* row_max,
                                    const float* row_sum, int batch, int sq,
                                    int sk, int heads, int head_dim,
                                    float scale, int causal, int dtype,
                                    cudaStream_t stream) {
  if (!mmgl::valid_shape(batch, sq, sk, heads, causal) ||
      (row_max == nullptr) != (row_sum == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const long n = static_cast<long>(batch) * heads * sq;
  float* row_delta = scratch;
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return mmgl::with_tc_type(dtype, [&](auto tag) {
      using T = decltype(tag);
      mmgl::wg::Maps m;
      cudaError_t err = mmgl::wg::make_maps(&m, q, k, v, dout, dtype, batch,
                                            sq, sk, heads, D);
      if (err != cudaSuccess) return err;
      const float* m_in = row_max;
      const float* l_in = row_sum;
      if (m_in == nullptr) {
        float* m_out = scratch + n;
        float* l_out = scratch + 2 * n;
        err = mmgl::wg::launch_fwd<D, true, mmgl::wg::FwdShape<D>, T>(
            m, kv_mask, nullptr, m_out, l_out, batch, sq, sk, heads, scale,
            causal, stream);
        if (err != cudaSuccess) return err;
        m_in = m_out;
        l_in = l_out;
      }
      return mmgl::wg::launch_bwd<D, mmgl::wg::DkdvShape<D>,
                                  mmgl::wg::DqShape<D>, T>(
          m, kv_mask, m_in, l_in, out, dout, row_delta, dq, dk, dv, batch,
          sq, sk, heads, scale, causal, stream);
    });
  });
}
