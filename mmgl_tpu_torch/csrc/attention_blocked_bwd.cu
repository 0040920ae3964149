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
// Schedule: three launches on the caller's stream, no atomics, the same
// results from run to run.
//   1. delta: one block per (64 query rows, head, batch), four threads a row
//      (JAX computes it outside Pallas, :345-347).
//   2. dK/dV: one block per (64 keys, head, batch), looping over the query
//      tiles that can see its keys (:299-300), plus earlier tiles that hold a
//      fully masked row.
//   3. dQ: one block per (64 query rows, head, batch), looping over the key
//      tiles up to the tile's causal limit (j + 1) * 64 + (sk - sq)
//      (:262-263).
// 2 and 3 are the tile kernels of attention_bwd_tiles.cuh, shared with K3/K5,
// which run them after a pass that recomputes m and l; K6 takes them from K4.
//
// Two bodies, chosen by the input dtype: bf16 and fp16 inputs take the
// tensor-core
// dK/dV and dQ bodies of attention_bwd_tiles.cuh (mma.sync; entry
// mmgl_blocked_bwd_tc), fp32 inputs the scalar ones (on the tensor cores
// fp32 would run as TF32). The delta pass is the same for both.
//
// What bounds it on this card: 14 * D FLOPs per (query, key) pair computed
// (dQ: q k^T, dO v^T, dS k; dK/dV: q k^T, dO v^T, P^T dO, dS^T q) against a
// few tens of MB of inputs: the tensor cores and the fp32 elementwise work
// between the products in bf16 or fp16, scalar FMAs and shared-memory loads
// in fp32;
// not HBM (3.35 TB/s). Against K5 at the same shape it saves the stats pass.
// Head dims 64, 80 and 128, as K3/K5 (mmgl::with_head_dim).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_bwd_tiles.cuh"
#include "common.cuh"

// K6: the blocked backward of K4 from its saved row max and sum (each
// batch * heads * sq fp32 in (B, H, Sq) order); row_delta: fp32 scratch of
// the same size. sq <= sk when causal (the ends are aligned).
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

// K6 on the tensor-core bodies (dtype bf16 or fp16): the same delta pass,
// then the tensor-core dK/dV and dQ launches.
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
      using T = decltype(tag);
      const cudaError_t err = mmgl::launch_delta<D, T>(
          out, dout, row_delta, batch, sq, heads, stream);
      if (err != cudaSuccess) return err;
      return mmgl::launch_bwd_tiles_tc<D, T>(
          q, k, v, kv_mask, dout, row_max, row_sum, row_delta, dq, dk, dv,
          batch, sq, sk, heads, scale, causal, stream);
    });
  });
}
