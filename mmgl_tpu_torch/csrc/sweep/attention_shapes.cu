// Shapes of the bf16 tensor-core attention bodies, for
// mmgl_tpu_torch/sweep_attention.py: the forward body of attention_fwd_tc.cuh
// and the dK/dV and dQ bodies of attention_bwd_tiles.cuh, each instantiated
// in several (warps of 16 rows, ring stages, blocks an SM) shapes at each
// head dim the library takes (64, 80, 128), behind one entry that takes the
// shape's index and the head dim. Built apart from the kernel library (this
// folder is not part of it); the library launches one shape of each at each
// head dim (mmgl::fwd_min_blocks, mmgl::BwdKvShape and mmgl::BwdQShape).

#include "../attention_bwd_tiles.cuh"
#include "../attention_fwd_tc.cuh"

namespace {

using mmgl::TcShape;

// (warps, stages, blocks an SM): the library's at 64 and 80, then at 128
#define FWD_SHAPES(X) X(4, 2, 3) X(4, 2, 2) X(4, 3, 3) X(4, 2, 4) X(8, 2, 2)
// dK/dV's shape, then dQ's: the library's at 64, at 80, at 128
#define BWD_SHAPES(X)                                                   \
  X(4, 2, 3, 4, 2, 4) X(4, 2, 2, 4, 2, 3) X(4, 2, 2, 4, 2, 2)             \
  X(4, 3, 3, 4, 3, 3) X(4, 2, 3, 4, 2, 3) X(8, 2, 2, 8, 2, 2)

#define COUNT(...) +1
constexpr int kFwdShapes = 0 FWD_SHAPES(COUNT);
constexpr int kBwdShapes = 0 BWD_SHAPES(COUNT);

}  // namespace

extern "C" int sweep_fwd_shapes() { return kFwdShapes; }
extern "C" int sweep_bwd_shapes() { return kBwdShapes; }

// K4 with its row stats in shape i at head dim head_dim
extern "C" int sweep_fwd(int i, int head_dim, const void* q, const void* k,
                         const void* v, const int* mask, void* out,
                         float* row_max, float* row_sum, int batch, int sq,
                         int sk, int heads, float scale, int causal,
                         cudaStream_t stream) {
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    int n = 0;
#define CALL(W, ST, MB)                                                      \
  if (i == n++) {                                                            \
    return mmgl::launch_fwd_tc_as<D, false, W, ST, MB>(                      \
        q, k, v, mask, out, row_max, row_sum, batch, sq, sk, heads, scale,   \
        causal, stream);                                                     \
  }
    FWD_SHAPES(CALL)
#undef CALL
    return cudaErrorInvalidValue;
  });
}

// K6's dK/dV and dQ launches in shape pair i at head dim head_dim (delta
// given)
extern "C" int sweep_bwd(int i, int head_dim, const void* q, const void* k,
                         const void* v, const int* mask, const void* dout,
                         const float* row_max, const float* row_sum,
                         const float* row_delta, void* dq, void* dk, void* dv,
                         int batch, int sq, int sk, int heads, float scale,
                         int causal, cudaStream_t stream) {
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    int n = 0;
#define CALL(W, ST, MB, QW, QST, QMB)                                        \
  if (i == n++) {                                                            \
    return mmgl::launch_bwd_tiles_tc_as<D, TcShape<W, ST, MB>,               \
                                        TcShape<QW, QST, QMB>>(              \
        q, k, v, mask, dout, row_max, row_sum, row_delta, dq, dk, dv, batch, \
        sq, sk, heads, scale, causal, stream);                               \
  }
    BWD_SHAPES(CALL)
#undef CALL
    return cudaErrorInvalidValue;
  });
}
