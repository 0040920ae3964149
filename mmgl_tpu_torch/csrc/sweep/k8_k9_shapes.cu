// Shapes of K8/K9's tensor-core backward, for mmgl_tpu_torch/sweep_attention.py
// --k8-k9: K3's wgmma/TMA dQ (delta fused, dlogits into the partial) and
// dK/dV bodies of allheads_wgmma.cuh in their bias form, in one grid
// (allheads_dq_dkdv_kernel), in two launches (dK/dV reading dQ's delta)
// or as the library chooses between them, each pair of
// (consumer warpgroups, tile rows, ring stages, blocks an SM) shapes in
// T5's three forms (a bf16 bias without dropout, with dropout, dropout
// without a bias), and, as shape -1, the mma.sync bodies of
// mma_sync_tiles.cuh in their bias form that K8/K9 launched before
// (the delta pass, then its dK/dV and dQ tiles in their library shapes):
// the "before" reading, reachable only here. Every shape ends with the
// library's batch-order reduction of the partial into dbias where there is
// a bias, which sweep_k8k9_reduce also runs alone. Built apart from the
// kernel library; the library launches the first (mmgl::wg::DkdvShape and
// BiasDqShape at head dim 64). The bias is (heads, sq, sk) bf16 in rows ld
// elements apart, ld a multiple of 8.

#include "../allheads_wgmma.cuh"
#include "mma_sync_tiles.cuh"

namespace {

constexpr int kD = 64;  // T5's head dim, the only one the bias form takes

using Bf16 = __nv_bfloat16;
using mmgl::BiasArgs;
using mmgl::wg::Shape;

// (0: two launches, dK/dV reading dQ's delta; 1: one grid; 2: the
// library's choice by the grid's size; then dK/dV's warpgroups, tile rows,
// stages, blocks an SM, then dQ's); the first is the library's, the last
// takes K3's DqShape (three dQ blocks an SM)
#define K8K9_SHAPES(X)                                                  \
  X(2, 1, 64, 2, 2, 1, 64, 2, 2) X(0, 1, 64, 2, 2, 1, 64, 2, 2)           \
  X(1, 1, 64, 2, 2, 1, 64, 2, 2) X(0, 1, 64, 2, 2, 1, 64, 2, 3)

#define COUNT(...) +1
constexpr int kShapes = 0 K8K9_SHAPES(COUNT);

// the form of (bias, seed): T5's three
#define BIAS_FORM(CALL)                                                      \
  if (ba.bias == nullptr && ba.seed == nullptr) return cudaErrorInvalidValue; \
  if (ba.bias == nullptr) return CALL(false, true);                          \
  return ba.seed == nullptr ? CALL(true, false) : CALL(true, true);

// dbias[h, i, j] = sum_b partial[b, h, i, j], b in order: the library's
// reduction (attention_bias_bwd.cu)
__global__ void reduce_kernel(const float* __restrict__ partial,
                              Bf16* __restrict__ dbias, int batch, long n) {
  for (long e = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < batch; ++b) acc += partial[b * n + e];
    mmgl::store1(dbias + e, acc);
  }
}

cudaError_t reduce(const float* partial, void* dbias, int batch, int sq,
                   int sk, int heads, cudaStream_t stream) {
  const long n = static_cast<long>(heads) * sq * sk;
  const long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  reduce_kernel<<<blocks, 256, 0, stream>>>(
      partial, static_cast<Bf16*>(dbias), batch, n);
  return cudaGetLastError();
}

template <int kGrid, int NC, int QT, int ST, int MB, int QNC, int KT,
          int QST, int QMB>
cudaError_t wgmma_pair(const void* q, const void* k, const void* v,
                       const int* mask, const void* out, const void* dout,
                       const float* row_max, const float* row_sum,
                       float* row_delta, void* dq, void* dk, void* dv,
                       float* partial, int batch, int sq, int sk, int heads,
                       float scale, int causal, BiasArgs<Bf16> ba,
                       cudaStream_t stream) {
  mmgl::wg::Maps m{};
  cudaError_t err = mmgl::wg::make_maps(&m, q, k, v, dout, mmgl::kBF16,
                                        batch, sq, sk, heads, kD);
  if (err == cudaSuccess && ba.bias != nullptr) {
    err = mmgl::hopper::make_bias_map(&m.bias, ba.bias, mmgl::kBF16, heads,
                                      sq, sk, ba.ld);
  }
  if (err != cudaSuccess) return err;
  using KvS = Shape<NC, QT, ST, MB>;
  using QS = Shape<QNC, KT, QST, QMB>;
  if constexpr (kGrid == 0) {
#define CALL(B, DROP)                                                        \
  mmgl::wg::launch_bwd<kD, KvS, QS, Bf16, B, DROP, Bf16>(                    \
      m, mask, row_max, row_sum, out, dout, row_delta, dq, dk, dv, batch,    \
      sq, sk, heads, scale, causal, stream, ba, B ? partial : nullptr)
    BIAS_FORM(CALL)
#undef CALL
  } else {
    constexpr auto layout = kGrid == 1 ? mmgl::wg::BwdGrid::kOne
                                       : mmgl::wg::BwdGrid::kAuto;
#define CALL(B, DROP)                                                        \
  mmgl::wg::launch_bwd_layout<kD, KvS, QS, Bf16, B, DROP, Bf16>(             \
      m, mask, row_max, row_sum, out, dout, row_delta, dq, dk, dv,           \
      B ? partial : nullptr, batch, sq, sk, heads, scale, causal, stream,    \
      ba, layout)
    BIAS_FORM(CALL)
#undef CALL
  }
}

// the mma.sync bodies as K8/K9 ran them: the delta pass, then the bias form
// of mma_sync_tiles.cuh's dK/dV and dQ in the shapes K8/K9 ran
cudaError_t mma_sync_before(const void* q, const void* k, const void* v,
                            const int* mask, const void* out,
                            const void* dout, const float* row_max,
                            const float* row_sum, float* row_delta, void* dq,
                            void* dk, void* dv, float* partial, int batch,
                            int sq, int sk, int heads, float scale,
                            int causal, BiasArgs<Bf16> ba,
                            cudaStream_t stream) {
  using Tiles = mmgl::TcShape<4, 2, 3>;
  const cudaError_t err = mmgl::launch_delta<kD, Bf16>(
      out, dout, row_delta, batch, sq, heads, stream);
  if (err != cudaSuccess) return err;
#define CALL(B, DROP)                                                        \
  mmgl::launch_bwd_tiles_tc_as<kD, Tiles, Tiles, B, DROP, Bf16, Bf16>(       \
      q, k, v, mask, dout, row_max, row_sum, row_delta, dq, dk, dv, batch,   \
      sq, sk, heads, scale, causal, stream, ba, B ? partial : nullptr)
  BIAS_FORM(CALL)
#undef CALL
}

}  // namespace

extern "C" int sweep_k8k9_shapes() { return kShapes; }

// K8/K9 in shape pair i (-1: the mma.sync bodies before) from K7's row
// stats: dq, dk, dv and, with a bias, dbias (heads, sq, sk) bf16 through
// partial (batch * heads * sq * sk fp32); row_delta: batch * heads * sq
// fp32 scratch; mask an int32 (batch, sk) key mask (the mma.sync tiles
// read one); bias null or bf16 rows ld apart; seed null or the dropout key
extern "C" int sweep_k8k9(int i, const void* q, const void* k, const void* v,
                          const int* mask, const void* bias, int ld,
                          const long long* seed, const void* out,
                          const void* dout, const float* row_max,
                          const float* row_sum, float* row_delta, void* dq,
                          void* dk, void* dv, float* partial, void* dbias,
                          int batch, int sq, int sk, int heads, float scale,
                          int causal, unsigned int threshold, float keep_inv,
                          cudaStream_t stream) {
  const BiasArgs<Bf16> ba{static_cast<const Bf16*>(bias), ld, seed,
                          threshold, keep_inv};
  cudaError_t err = cudaErrorInvalidValue;
  if (i < 0) {
    err = mma_sync_before(q, k, v, mask, out, dout, row_max, row_sum,
                          row_delta, dq, dk, dv, partial, batch, sq, sk,
                          heads, scale, causal, ba, stream);
  }
  int n = 0;
#define SHAPE(G, NC, QT, ST, MB, QNC, KT, QST, QMB)                           \
  if (i == n++) {                                                             \
    err = wgmma_pair<G, NC, QT, ST, MB, QNC, KT, QST, QMB>(                   \
        q, k, v, mask, out, dout, row_max, row_sum, row_delta, dq, dk, dv,    \
        partial, batch, sq, sk, heads, scale, causal, ba, stream);            \
  }
  K8K9_SHAPES(SHAPE)
#undef SHAPE
  if (err != cudaSuccess || bias == nullptr) return err;
  return reduce(partial, dbias, batch, sq, sk, heads, stream);
}

// the reduction alone, as every shape above ends
extern "C" int sweep_k8k9_reduce(const float* partial, void* dbias, int batch,
                                 int sq, int sk, int heads,
                                 cudaStream_t stream) {
  return reduce(partial, dbias, batch, sq, sk, heads, stream);
}
