// Layouts of K5's tensor-core backward, for mmgl_tpu_torch/sweep_attention.py
// --k5: K4's wgmma forward in its stats-only form (FwdShape), then K3's
// wgmma/TMA dQ (delta fused) and dK/dV bodies of allheads_wgmma.cuh laid
// out in several ways, at each head dim the library takes (64, 80, 128),
// bf16:
//   0  the library's (wg::launch_bwd_layout: one grid or two launches by
//      the grid's size), as mmgl_flash_bwd_tc runs it;
//   1  two launches, dQ in DqShape, then dK/dV in DkdvShape;
//   2  two launches, dQ at dK/dV's blocks an SM (the one grid's dQ shape);
//   3  one grid of both bodies (dK/dV making its own delta).
// Shape -1 is the mma.sync body K5 launched before (the same stats pass,
// the delta pass, then mma_sync_tiles.cuh's dK/dV and dQ tiles in the
// shapes K5 ran them in): the "before" reading. Built apart from the
// kernel library (this folder is not part of it).

#include "../allheads_wgmma.cuh"
#include "mma_sync_tiles.cuh"

namespace {

namespace wg = mmgl::wg;
using T = __nv_bfloat16;

// 0 library, 1 two launches, 2 two launches with the one grid's dQ
// shape, 3 one grid
constexpr int kLayouts = 4;

template <int D, int kLayout>
cudaError_t layout_call(const wg::Maps& m, const int* mask, const void* out,
                        const void* dout, float* stats, void* dq, void* dk,
                        void* dv, int batch, int sq, int sk, int heads,
                        float scale, int causal, cudaStream_t stream) {
  using KvS = wg::DkdvShape<D>;
  using QS = wg::DqShape<D>;
  const long n = static_cast<long>(batch) * heads * sq;
  float* m_ = stats;
  float* l_ = stats + n;
  float* delta = stats + 2 * n;
  if constexpr (kLayout == 0) {
    return wg::launch_bwd_layout<D, KvS, QS, T>(
        m, mask, m_, l_, out, dout, delta, dq, dk, dv, nullptr, batch, sq,
        sk, heads, scale, causal, stream);
  } else if constexpr (kLayout == 1 || kLayout == 3) {
    return wg::launch_bwd_layout<D, KvS, QS, T>(
        m, mask, m_, l_, out, dout, delta, dq, dk, dv, nullptr, batch, sq,
        sk, heads, scale, causal, stream, mmgl::BiasArgs<T>{},
        kLayout == 1 ? wg::BwdGrid::kTwo : wg::BwdGrid::kOne);
  } else {
    return wg::launch_bwd<D, KvS, wg::OneGridDq<KvS, QS>, T>(
        m, mask, m_, l_, out, dout, delta, dq, dk, dv, batch, sq, sk, heads,
        scale, causal, stream);
  }
}

}  // namespace

extern "C" int sweep_k5_layouts() { return kLayouts; }

// K5 in layout i (-1: the mma.sync body before) at head dim head_dim, bf16:
// the stats pass, then the backward. stats: 3 batch heads sq fp32 (m, l,
// delta); mask: an int32 (batch, sk) key mask or null (the mma.sync tiles
// read one)
extern "C" int sweep_k5(int i, int head_dim, const void* q, const void* k,
                        const void* v, const int* mask, const void* out,
                        const void* dout, float* stats, void* dq, void* dk,
                        void* dv, int batch, int sq, int sk, int heads,
                        float scale, int causal, cudaStream_t stream) {
  return mmgl::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const long n = static_cast<long>(batch) * heads * sq;
    wg::Maps m{};
    cudaError_t err = wg::make_maps(&m, q, k, v, dout, mmgl::kBF16, batch,
                                    sq, sk, heads, D);
    if (err != cudaSuccess) return err;
    err = wg::launch_fwd<D, true, wg::FwdShape<D>, T>(
        m, mask, nullptr, stats, stats + n, batch, sq, sk, heads, scale,
        causal, stream);
    if (err != cudaSuccess) return err;
    if (i < 0) {
      err = mmgl::launch_delta<D, T>(out, dout, stats + 2 * n, batch, sq,
                                     heads, stream);
      if (err != cudaSuccess) return err;
      return mmgl::launch_bwd_tiles_tc<D, T>(
          q, k, v, mask, dout, stats, stats + n, stats + 2 * n, dq, dk, dv,
          batch, sq, sk, heads, scale, causal, stream);
    }
    switch (i) {
#define LAYOUT(L)                                                           \
  case L:                                                                   \
    return layout_call<D, L>(m, mask, out, dout, stats, dq, dk, dv, batch,  \
                             sq, sk, heads, scale, causal, stream);
      LAYOUT(0) LAYOUT(1) LAYOUT(2) LAYOUT(3)
#undef LAYOUT
      default:
        return cudaErrorInvalidValue;
    }
  });
}
