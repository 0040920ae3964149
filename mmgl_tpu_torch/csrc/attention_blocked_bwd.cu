// Blocked causal attention backward for Hopper (sm_90a): K6, the backward of
// K4 from the forward's saved row statistics.
//
// Replaces
//   mmgl_blocked_bwd -> _bwd_causal_blocked (mmgl_tpu/ops/flash_attention.py:336):
//                       _bwd_dq_kernel (:246, pallas_call :369) and
//                       _bwd_dkv_kernel (:289, pallas_call :391), selected by
//                       MMGL_BLOCKED_BWD=1 for causal attention (:514-522).
//                       OPT-350M's self-attention at 2048 tokens, past K1's
//                       envelope: (4, 2048, 16, 64), bf16 or fp16.
// Given q, k, v, the key mask, the forward output o, its gradient dO and
// K4's per-row softmax max m and sum l (kept apart, not one logsumexp: for a
// fully masked row m = -1e30 and l = sk, and -1e30 + log(sk) rounds back to
// -1e30 in fp32):
//   delta = rowsum(dO * o)                       (fp32, from the stored o)
//   P     = exp(q k^T * scale - m) / l           (never a full-row softmax)
//   dV    = P^T dO,  dS = P * (dO v^T - delta) * scale, 0 at masked logits
//   dQ    = dS k,    dK = dS^T q
//
// Fully masked rows follow jax.grad of xla_attention, the JAX package's
// reference, as K3, K5 and K8/K9 do: such a row's P is 1/sk over every key,
// causally hidden ones included, so it feeds dV from every key and gives no
// dQ or dK. The Pallas kernels drop the row instead (P = 0 where the logit
// is masked, :276 and :316). So the dK/dV pass may skip a query tile that
// lies wholly before its keys only when every row of that tile has a real
// logit, which the statistics tell (m > -1e30).
//
// Two bodies, chosen by the input dtype, each two or three launches on the
// caller's stream, no atomics, the same results from run to run:
//   * bf16 and fp16 (entry mmgl_blocked_bwd_tc): K3's wgmma/TMA bodies of
//     allheads_wgmma.cuh, started from K4's statistics as K3's start from
//     K1's (K4 writes them with K1's forward body, so K6 from K4's stats is
//     K3 from the same stats, bit for bit). Two launches:
//       1. dQ: one block per (64 query rows, head, batch), looping over the
//          key tiles up to the block's causal limit (:262-263) that hold a
//          valid key; its prologue computes delta = rowsum(dO * o) (JAX
//          computes it outside Pallas, :345-347) and writes it for
//          2. dK/dV: one block per (64 keys, head, batch), looping over the
//          query tiles that can see its keys (:299-300), plus earlier
//          tiles that hold a fully masked row;
//     or, where both grids' blocks fill at most two waves of the SMs'
//     slots, the two bodies in one grid, dK/dV making its own delta (the
//     same bits): wg::launch_bwd_layout, which lays out K5's bodies too.
//     The end-aligned sq < sk is the bodies' shift = sk - sq.
//   * fp32 (entry mmgl_blocked_bwd): three launches, a delta pass (four
//     threads a row) and then the scalar dK/dV and dQ tile kernels of
//     attention_bwd_tiles.cuh, shared with K3's and K5's fp32 bodies (on
//     the tensor cores fp32 would run as TF32).
//
// What bounds it on this card: 14 * D FLOPs per (query, key) pair computed
// (dQ: q k^T, dO v^T, dS k; dK/dV: q k^T, dO v^T, P^T dO, dS^T q; 10 * D
// is the gradient's own, the rest recomputes S and dP in the second pass)
// against a few tens of MB of inputs:
// the tensor cores (989 TFLOP/s bf16, reached only through wgmma) and the
// fp32 elementwise work between the products in bf16 or fp16, scalar FMAs
// and shared-memory loads in fp32; not HBM (3.35 TB/s). Against K5 at the
// same shape it saves the stats pass. Head dims 64, 80 and 128, as K3/K5
// (mmgl::with_head_dim).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "allheads_wgmma.cuh"
#include "attention_bwd_tiles.cuh"
#include "common.cuh"

// K6 in fp32: the blocked backward of K4 from its saved row max and sum
// (each batch * heads * sq fp32 in (B, H, Sq) order); row_delta: fp32
// scratch of the same size. sq <= sk when causal (the ends are aligned).
extern "C" int mmgl_blocked_bwd(const void* q, const void* k, const void* v,
                                const int* kv_mask, const void* out,
                                const void* dout, const float* row_max,
                                const float* row_sum, void* dq, void* dk,
                                void* dv, float* row_delta, int batch, int sq,
                                int sk, int heads, int head_dim, float scale,
                                int causal, int dtype,
                                cudaStream_t stream) {
  // bf16, fp16: mmgl_blocked_bwd_tc
  if (dtype != mmgl::kF32 ||
      !mmgl::valid_shape(batch, sq, sk, heads, causal)) {
    return cudaErrorInvalidValue;
  }
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const cudaError_t err = mmgl::launch_delta<D, float>(
        out, dout, row_delta, batch, sq, heads, stream);
    if (err != cudaSuccess) return err;
    return mmgl::launch_bwd_tiles<D, float>(
        q, k, v, kv_mask, dout, row_max, row_sum, row_delta, dq, dk, dv,
        batch, sq, sk, heads, scale, causal, stream);
  });
}

// K6 on K3's wgmma/TMA bodies (dtype bf16 or fp16): dQ, which also writes
// delta into row_delta, and dK/dV, from K4's row max and sum, in two
// launches or one grid as K5's. kv_mask may be null (every key valid).
extern "C" int mmgl_blocked_bwd_tc(const void* q, const void* k, const void* v,
                                   const int* kv_mask, const void* out,
                                   const void* dout, const float* row_max,
                                   const float* row_sum, void* dq, void* dk,
                                   void* dv, float* row_delta, int batch,
                                   int sq, int sk, int heads, int head_dim,
                                   float scale, int causal, int dtype,
                                   cudaStream_t stream) {
  if (!mmgl::valid_shape(batch, sq, sk, heads, causal)) {
    return cudaErrorInvalidValue;
  }
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return mmgl::with_tc_type(dtype, [&](auto tag) {
      namespace wg = mmgl::wg;
      using T = decltype(tag);
      wg::Maps m;
      const cudaError_t err = wg::make_maps(&m, q, k, v, dout, dtype, batch,
                                            sq, sk, heads, D);
      if (err != cudaSuccess) return err;
      return wg::launch_bwd_layout<D, wg::DkdvShape<D>, wg::DqShape<D>, T>(
          m, kv_mask, row_max, row_sum, out, dout, row_delta, dq, dk, dv,
          nullptr, batch, sq, sk, heads, scale, causal, stream);
    });
  });
}
