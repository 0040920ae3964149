// Shapes of K4's and K7's wgmma/TMA forward (allheads_wgmma.cuh, the bias
// form for K7), and the mma.sync bodies they replaced, for
// mmgl_tpu_torch/sweep_attention.py --no-allheads: each body in several
// (consumer warpgroups, key tile rows, ring stages, blocks an SM) shapes,
// bf16. Shape -1 is the mma.sync body the library launched before
// (attention_fwd_tc.cuh's forward, in its bias form for K7): the "before"
// reading, reachable only here. Built apart from the
// kernel library (this folder is not part of it); the library launches one
// shape of both (mmgl::wg::FwdShape).

#include "../allheads_wgmma.cuh"
#include "../attention_fwd_tc.cuh"

namespace {

using mmgl::wg::Shape;
using T = __nv_bfloat16;

// (warpgroups, key tile rows, stages, blocks an SM); the first is the
// library's
#define K4_SHAPES(X)                                                      \
  X(1, 64, 2, 2) X(1, 64, 2, 3) X(1, 64, 3, 2) X(2, 64, 2, 1)             \
  X(1, 128, 2, 2) X(2, 128, 2, 1)
// the same for K7; the first is the library's
#define K7_SHAPES(X)                                                      \
  X(1, 64, 2, 2) X(1, 64, 2, 3) X(1, 64, 3, 2) X(2, 64, 2, 1)             \
  X(1, 128, 2, 2)

#define COUNT(...) +1
constexpr int kK4 = 0 K4_SHAPES(COUNT);
constexpr int kK7 = 0 K7_SHAPES(COUNT);

// one K7 launch in shape i (-1: the mma.sync body), in the (bias, dropout)
// form go's template arguments give
struct K7Call {
  int i;
  const mmgl::wg::Maps* m;
  const void *q, *k, *v;
  const int* mask;
  const void* bias;
  int ld;
  const long long* seed;
  void* out;
  float *row_max, *row_sum;
  int batch, sq, sk, heads;
  float scale;
  int causal;
  unsigned int threshold;
  float keep_inv;
  cudaStream_t stream;

  template <bool B, bool DROP, typename TB>
  cudaError_t go() const {
    const mmgl::BiasArgs<TB> ba{static_cast<const TB*>(bias), ld, seed,
                                threshold, keep_inv};
    if (i < 0) {
      return mmgl::launch_fwd_tc<64, false, B, DROP, TB, T>(
          q, k, v, mask, out, row_max, row_sum, batch, sq, sk, heads, scale,
          causal, stream, ba);
    }
    int n = 0;
#define CALL(NC, KT, ST, MB)                                                  \
  if (i == n++) {                                                             \
    return mmgl::wg::launch_fwd<64, false, Shape<NC, KT, ST, MB>, T, B, DROP, \
                                TB>(*m, mask, out, row_max, row_sum, batch,   \
                                    sq, sk, heads, scale, causal, stream,     \
                                    ba);                                      \
  }
    K7_SHAPES(CALL)
#undef CALL
    return cudaErrorInvalidValue;
  }

  // the form from the pointers, the bias of TB
  template <typename TB>
  cudaError_t form() const {
    if (bias == nullptr) {
      return seed == nullptr ? go<false, false, TB>() : go<false, true, TB>();
    }
    return seed == nullptr ? go<true, false, TB>() : go<true, true, TB>();
  }
};

}  // namespace

extern "C" int sweep_k4_shapes() { return kK4; }
extern "C" int sweep_k7_shapes() { return kK7; }

// K4 in shape i (-1: the mma.sync body) at head dim head_dim, bf16; row_max
// and row_sum written where not null; mask may be null but for shape -1
extern "C" int sweep_k4(int i, int head_dim, const void* q, const void* k,
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
    mmgl::wg::Maps m{};
    const cudaError_t err = mmgl::wg::make_maps(
        &m, q, k, v, nullptr, mmgl::kBF16, batch, sq, sk, heads, D);
    if (err != cudaSuccess) return err;
    int n = 0;
#define CALL(NC, KT, ST, MB)                                                \
  if (i == n++) {                                                           \
    return mmgl::wg::launch_fwd<D, false, Shape<NC, KT, ST, MB>, T>(        \
        m, mask, out, row_max, row_sum, batch, sq, sk, heads, scale, causal, \
        stream);                                                            \
  }
    K4_SHAPES(CALL)
#undef CALL
    return cudaErrorInvalidValue;
  });
}

// K7 in shape i (-1: the mma.sync body's bias form) at head dim 64, bf16:
// bias (heads, sq, sk) with row stride bias_ld (a multiple of 8) in bf16
// (bias_f32 0) or fp32 (1), or null; seed the dropout key or null; row_max
// and row_sum written where not null
extern "C" int sweep_k7(int i, const void* q, const void* k, const void* v,
                        const int* mask, const void* bias, int bias_ld,
                        int bias_f32, const long long* seed, void* out,
                        float* row_max, float* row_sum, int batch, int sq,
                        int sk, int heads, float scale, int causal,
                        unsigned int threshold, float keep_inv,
                        cudaStream_t stream) {
  mmgl::wg::Maps m{};
  if (i >= 0) {
    cudaError_t err = mmgl::wg::make_maps(&m, q, k, v, nullptr, mmgl::kBF16,
                                          batch, sq, sk, heads, 64);
    if (err == cudaSuccess && bias != nullptr) {
      err = mmgl::hopper::make_bias_map(&m.bias, bias,
                                        bias_f32 ? mmgl::kF32 : mmgl::kBF16,
                                        heads, sq, sk, bias_ld);
    }
    if (err != cudaSuccess) return err;
  }
  const K7Call call{i,     &m,       q,       k,       v,      mask,
                    bias,  bias_ld,  seed,    out,     row_max, row_sum,
                    batch, sq,       sk,      heads,   scale,  causal,
                    threshold, keep_inv, stream};
  return bias_f32 ? call.form<float>() : call.form<T>();
}
