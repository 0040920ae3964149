// Shapes of K1's and K3's wgmma/TMA bodies (allheads_wgmma.cuh), and the
// mma.sync bodies they replaced, for mmgl_tpu_torch/sweep_attention.py
// --allheads: the forward, dK/dV and dQ bodies each in several (consumer
// warpgroups, streamed tile rows, ring stages, blocks an SM) shapes at each
// head dim the library takes (64, 80, 128), bf16. Shape -1 is the mma.sync
// body that K1 and K3 launched before (attention_fwd_tc.cuh's forward;
// its stats-only form, the delta pass and attention_bwd_tiles.cuh's dK/dV
// and dQ): the "before" reading, reachable only here. Built apart from the
// kernel library (this folder is not part of it); the library launches one
// shape of each (mmgl::wg::FwdShape, DkdvShape, DqShape).

#include "../allheads_wgmma.cuh"
#include "../attention_bwd_tiles.cuh"
#include "../attention_fwd_tc.cuh"

namespace {

using mmgl::wg::Shape;
using T = __nv_bfloat16;

// (warpgroups, tile rows, stages, blocks an SM); the first of each list is
// the library's at head dim 64, dK/dV's and dQ's second their shapes past
// 64
#define FWD_SHAPES(X)                                                     \
  X(1, 64, 2, 2) X(1, 64, 2, 3) X(1, 64, 3, 2) X(1, 64, 4, 2)             \
  X(1, 128, 2, 2) X(2, 64, 2, 1) X(2, 64, 3, 1) X(2, 128, 2, 1)
#define DKDV_SHAPES(X)                                                    \
  X(1, 64, 2, 2) X(1, 64, 2, 1) X(2, 64, 2, 1) X(2, 64, 3, 1)             \
  X(1, 64, 3, 1) X(1, 128, 2, 1)
#define DQ_SHAPES(X)                                                      \
  X(1, 64, 2, 3) X(1, 64, 2, 2) X(1, 64, 3, 2) X(2, 64, 2, 1)             \
  X(1, 128, 2, 1)

#define COUNT(...) +1
constexpr int kFwd = 0 FWD_SHAPES(COUNT);
constexpr int kDkdv = 0 DKDV_SHAPES(COUNT);
constexpr int kDq = 0 DQ_SHAPES(COUNT);

cudaError_t maps(mmgl::wg::Maps* m, const void* q, const void* k,
                 const void* v, const void* dout, int batch, int sq, int sk,
                 int heads, int d) {
  using mmgl::hopper::make_map;
  cudaError_t err = make_map(&m->q, q, mmgl::kBF16, batch, sq, heads, d);
  if (err == cudaSuccess) {
    err = make_map(&m->k, k, mmgl::kBF16, batch, sk, heads, d);
  }
  if (err == cudaSuccess) {
    err = make_map(&m->v, v, mmgl::kBF16, batch, sk, heads, d);
  }
  if (err == cudaSuccess && dout != nullptr) {
    err = make_map(&m->dout, dout, mmgl::kBF16, batch, sq, heads, d);
  }
  return err;
}

}  // namespace

extern "C" int sweep_k1_shapes() { return kFwd; }
extern "C" int sweep_dkdv_shapes() { return kDkdv; }
extern "C" int sweep_dq_shapes() { return kDq; }

// K1 in forward shape i (-1: the mma.sync body) at head dim head_dim, bf16;
// row_max and row_sum written where not null
extern "C" int sweep_k1(int i, int head_dim, const void* q, const void* k,
                        const void* v, const int* mask, void* out,
                        float* row_max, float* row_sum, int batch, int sq,
                        int sk, int heads, float scale, int causal,
                        cudaStream_t stream) {
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (i < 0) {
      return mmgl::launch_fwd_tc<D, false>(q, k, v, mask, out, row_max,
                                           row_sum, batch, sq, sk, heads,
                                           scale, causal, stream);
    }
    mmgl::wg::Maps m;
    const cudaError_t err = maps(&m, q, k, v, nullptr, batch, sq, sk, heads,
                                 D);
    if (err != cudaSuccess) return err;
    int n = 0;
#define CALL(NC, KT, ST, MB)                                                \
  if (i == n++) {                                                           \
    return mmgl::wg::launch_fwd<D, false, Shape<NC, KT, ST, MB>, T>(        \
        m, mask, out, row_max, row_sum, batch, sq, sk, heads, scale, causal, \
        stream);                                                            \
  }
    FWD_SHAPES(CALL)
#undef CALL
    return cudaErrorInvalidValue;
  });
}

// K3's dK/dV pass in shape i (-1: the mma.sync dK/dV and dQ bodies, one
// launch each) from the row stats and delta given
extern "C" int sweep_dkdv(int i, int head_dim, const void* q, const void* k,
                          const void* v, const int* mask, const void* dout,
                          const float* row_max, const float* row_sum,
                          const float* row_delta, void* dq, void* dk,
                          void* dv, int batch, int sq, int sk, int heads,
                          float scale, int causal, cudaStream_t stream) {
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (i < 0) {
      return mmgl::launch_bwd_tiles_tc<D>(q, k, v, mask, dout, row_max,
                                          row_sum, row_delta, dq, dk, dv,
                                          batch, sq, sk, heads, scale,
                                          causal, stream);
    }
    mmgl::wg::Maps m;
    const cudaError_t err = maps(&m, q, k, v, dout, batch, sq, sk, heads, D);
    if (err != cudaSuccess) return err;
    int n = 0;
#define CALL(NC, QT, ST, MB)                                                \
  if (i == n++) {                                                           \
    return mmgl::wg::launch_dkdv<D, Shape<NC, QT, ST, MB>, T>(              \
        m, mask, row_max, row_sum, row_delta, dk, dv, batch, sq, sk, heads, \
        scale, causal, stream);                                             \
  }
    DKDV_SHAPES(CALL)
#undef CALL
    return cudaErrorInvalidValue;
  });
}

// K3's dQ pass in shape i from the row stats given; it writes delta
extern "C" int sweep_dq(int i, int head_dim, const void* q, const void* k,
                        const void* v, const int* mask, const void* out,
                        const void* dout, const float* row_max,
                        const float* row_sum, float* row_delta, void* dq,
                        int batch, int sq, int sk, int heads, float scale,
                        int causal, cudaStream_t stream) {
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    mmgl::wg::Maps m;
    const cudaError_t err = maps(&m, q, k, v, dout, batch, sq, sk, heads, D);
    if (err != cudaSuccess) return err;
    int n = 0;
#define CALL(NC, KT, ST, MB)                                                \
  if (i == n++) {                                                           \
    return mmgl::wg::launch_dq<D, Shape<NC, KT, ST, MB>, T>(                \
        m, mask, row_max, row_sum, out, dout, row_delta, dq, batch, sq, sk, \
        heads, scale, causal, stream);                                      \
  }
    DQ_SHAPES(CALL)
#undef CALL
    return cudaErrorInvalidValue;
  });
}

// K3 as it ran before on the mma.sync bodies (four launches): the forward
// body's stats-only form, the delta pass, dK/dV and dQ; scratch: 3 * batch *
// heads * sq fp32
extern "C" int sweep_k3_before(int head_dim, const void* q, const void* k,
                               const void* v, const int* mask,
                               const void* out, const void* dout, void* dq,
                               void* dk, void* dv, float* scratch, int batch,
                               int sq, int sk, int heads, float scale,
                               int causal, cudaStream_t stream) {
  const long n = static_cast<long>(batch) * heads * sq;
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    cudaError_t err = mmgl::launch_fwd_tc<D, true>(
        q, k, nullptr, mask, nullptr, scratch, scratch + n, batch, sq, sk,
        heads, scale, causal, stream);
    if (err != cudaSuccess) return err;
    err = mmgl::launch_delta<D, T>(out, dout, scratch + 2 * n, batch, sq,
                                   heads, stream);
    if (err != cudaSuccess) return err;
    return mmgl::launch_bwd_tiles_tc<D>(q, k, v, mask, dout, scratch,
                                        scratch + n, scratch + 2 * n, dq, dk,
                                        dv, batch, sq, sk, heads, scale,
                                        causal, stream);
  });
}
