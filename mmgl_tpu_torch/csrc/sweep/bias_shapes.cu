// Shapes of the bias form of the bf16 tensor-core attention bodies (K7's
// forward, K8/K9's dK/dV and dQ), for mmgl_tpu_torch/sweep_attention.py:
// each (warps of 16 rows, ring stages, blocks an SM) shape in the three
// forms T5 runs, all with its bf16 bias: the bias without dropout (eval),
// the bias with dropout (training self-attention), dropout without a bias
// (training cross-attention). Built apart from the kernel library, like
// attention_shapes.cu; the library launched one shape of each, the one
// this sweep found fastest (attention_bias_fwd.cu, attention_bias_bwd.cu),
// until the wgmma bodies replaced them.
// The bias's row stride is sk: the sweep's lengths are multiples of 8.

#include "mma_sync_tiles.cuh"
#include "../attention_fwd_tc.cuh"

namespace {

constexpr int kD = 64;  // T5's head dim, the only one the bias form takes

using Bf16 = __nv_bfloat16;
using mmgl::BiasArgs;
using mmgl::TcShape;

// (warps, stages, blocks an SM); the first is the library's
#define BIAS_FWD_SHAPES(X) X(4, 2, 3) X(4, 3, 3) X(2, 2, 6) X(8, 2, 2)
// dK/dV's shape, then dQ's; the first is the library's
#define BIAS_BWD_SHAPES(X)                                              \
  X(4, 2, 3, 4, 2, 3) X(4, 2, 3, 4, 2, 4) X(4, 3, 3, 4, 3, 3)             \
  X(2, 2, 6, 2, 2, 6)

#define COUNT(...) +1
constexpr int kFwdShapes = 0 BIAS_FWD_SHAPES(COUNT);
constexpr int kBwdShapes = 0 BIAS_BWD_SHAPES(COUNT);

// the form of (bias, seed): K7's three; neither is K4's, not swept here
#define BIAS_FORM(CALL)                                                      \
  if (ba.bias == nullptr && ba.seed == nullptr) return cudaErrorInvalidValue; \
  if (ba.bias == nullptr) return CALL(false, true);                          \
  return ba.seed == nullptr ? CALL(true, false) : CALL(true, true);

template <int W, int ST, int MB>
cudaError_t fwd(const void* q, const void* k, const void* v, const int* mask,
                void* out, float* row_max, float* row_sum, int batch, int sq,
                int sk, int heads, float scale, int causal,
                BiasArgs<Bf16> ba, cudaStream_t stream) {
#define CALL(B, DROP)                                                         \
  mmgl::launch_fwd_tc_as<kD, false, W, ST, MB, B, DROP, Bf16>(                \
      q, k, v, mask, out, row_max, row_sum, batch, sq, sk, heads, scale,      \
      causal, stream, ba)
  BIAS_FORM(CALL)
#undef CALL
}

template <int W, int ST, int MB, int QW, int QST, int QMB>
cudaError_t bwd(const void* q, const void* k, const void* v, const int* mask,
                const void* dout, const float* row_max, const float* row_sum,
                const float* row_delta, void* dq, void* dk, void* dv,
                float* partial, int batch, int sq, int sk, int heads,
                float scale, int causal, BiasArgs<Bf16> ba,
                cudaStream_t stream) {
#define CALL(B, DROP)                                                         \
  mmgl::launch_bwd_tiles_tc_as<kD, TcShape<W, ST, MB>,                        \
                               TcShape<QW, QST, QMB>, B, DROP, Bf16>(         \
      q, k, v, mask, dout, row_max, row_sum, row_delta, dq, dk, dv, batch,    \
      sq, sk, heads, scale, causal, stream, ba, B ? partial : nullptr)
  BIAS_FORM(CALL)
#undef CALL
}

}  // namespace

extern "C" int sweep_bias_fwd_shapes() { return kFwdShapes; }
extern "C" int sweep_bias_bwd_shapes() { return kBwdShapes; }

// K7 with its row stats in shape i; bias (heads, sq, sk) bf16 or null,
// seed the dropout key or null
extern "C" int sweep_bias_fwd(int i, const void* q, const void* k,
                              const void* v, const int* mask,
                              const void* bias, const long long* seed,
                              void* out, float* row_max, float* row_sum,
                              int batch, int sq, int sk, int heads,
                              float scale, int causal, unsigned int threshold,
                              float keep_inv, cudaStream_t stream) {
  const BiasArgs<Bf16> ba{static_cast<const Bf16*>(bias), sk, seed,
                          threshold, keep_inv};
  int n = 0;
#define SHAPE(W, ST, MB)                                                     \
  if (i == n++) {                                                            \
    return fwd<W, ST, MB>(q, k, v, mask, out, row_max, row_sum, batch, sq,   \
                          sk, heads, scale, causal, ba, stream);             \
  }
  BIAS_FWD_SHAPES(SHAPE)
#undef SHAPE
  return cudaErrorInvalidValue;
}

// K8/K9's dK/dV and dQ launches in shape pair i from the given row stats
// and delta; dlogits into partial (B, H, Sq, Sk) where there is a bias
extern "C" int sweep_bias_bwd(int i, const void* q, const void* k,
                              const void* v, const int* mask,
                              const void* bias, const long long* seed,
                              const void* dout, const float* row_max,
                              const float* row_sum, const float* row_delta,
                              void* dq, void* dk, void* dv, float* partial,
                              int batch, int sq, int sk, int heads,
                              float scale, int causal, unsigned int threshold,
                              float keep_inv, cudaStream_t stream) {
  const BiasArgs<Bf16> ba{static_cast<const Bf16*>(bias), sk, seed,
                          threshold, keep_inv};
  int n = 0;
#define SHAPE(W, ST, MB, QW, QST, QMB)                                       \
  if (i == n++) {                                                            \
    return bwd<W, ST, MB, QW, QST, QMB>(q, k, v, mask, dout, row_max,        \
                                        row_sum, row_delta, dq, dk, dv,      \
                                        partial, batch, sq, sk, heads,       \
                                        scale, causal, ba, stream);          \
  }
  BIAS_BWD_SHAPES(SHAPE)
#undef SHAPE
  return cudaErrorInvalidValue;
}
