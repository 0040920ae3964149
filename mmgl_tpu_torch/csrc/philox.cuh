// Counter-based random bits for the in-kernel attention-prob dropout
// (attention_bias_fwd.cu, attention_bias_bwd.cu and the bias form of the
// mma.sync bodies in attention_fwd_tc.cuh and sweep/mma_sync_tiles.cuh),
// the Hopper counterpart of the TPU hardware PRNG that _gen_keep_factor
// (mmgl_tpu/ops/flash_attention.py:570) reseeds per block.
//
// Philox-4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011; the Random123 constants): a 2-word key, a 4-word counter,
// ten rounds, four 32-bit words out. A pure function, so the backward
// regenerates the forward's mask element for element.
//
// The element (b, h, i, j) of the (B, H, Sq, Sk) probabilities takes
//   counter = (((j >> 4) << 2) | (j & 3), i, h, b),  word (j >> 2) & 3
// so one Philox call serves the four keys j, j + 4, j + 8, j + 12 of a
// 16-key group: the keys one thread of the forward owns in a 64-key tile
// (key = sub + 4 t), and no call is made twice. It is kept where the word is
// below thr = round(keep * 2^32), and then scaled by 1 / keep.
// mmgl_tpu_torch/ops/attention.py (dropout_bits) computes the same bits
// with torch int64 arithmetic; the two are compared bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace mmgl {

struct Philox4 {
  unsigned int x, y, z, w;
};

__device__ __forceinline__ Philox4 philox4x32_10(unsigned int c0,
                                                 unsigned int c1,
                                                 unsigned int c2,
                                                 unsigned int c3,
                                                 unsigned int k0,
                                                 unsigned int k1) {
  constexpr unsigned int kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr unsigned int kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned int hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const unsigned int hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return {c0, c1, c2, c3};
}

__device__ __forceinline__ unsigned int philox_word(const Philox4& r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// The dropout key of one call: two words drawn by the wrapper from the
// step's torch.Generator into a device tensor (int64, low 32 bits each).
struct DropoutKey {
  unsigned int k0, k1;
  unsigned int threshold;  // keep iff bits < threshold
  float keep_inv;          // 1 / keep
  bool on;
};

__device__ __forceinline__ DropoutKey load_dropout_key(
    const long long* seed, unsigned int threshold, float keep_inv) {
  DropoutKey key{0u, 0u, threshold, keep_inv, seed != nullptr};
  if (key.on) {
    key.k0 = static_cast<unsigned int>(seed[0]);
    key.k1 = static_cast<unsigned int>(seed[1]);
  }
  return key;
}

// The Philox call of key group g = ((j >> 4) << 2) | (j & 3) of row (b, h, i).
__device__ __forceinline__ Philox4 dropout_group(const DropoutKey& key,
                                                 int b, int h, int i, int j) {
  const unsigned int g = (static_cast<unsigned int>(j >> 4) << 2) |
                         static_cast<unsigned int>(j & 3);
  return philox4x32_10(g, static_cast<unsigned int>(i),
                       static_cast<unsigned int>(h),
                       static_cast<unsigned int>(b), key.k0, key.k1);
}

// keep_inv where a word keeps, else 0
__device__ __forceinline__ float keep_factor(const DropoutKey& key,
                                             unsigned int word) {
  return word < key.threshold ? key.keep_inv : 0.f;
}

// the keep factor of key j from its group call r
__device__ __forceinline__ float dropout_factor(const DropoutKey& key,
                                                const Philox4& r, int j) {
  return keep_factor(key, philox_word(r, (j >> 2) & 3));
}

// The tensor-core bodies' share of the calls. In an mma.sync accumulator
// the four words of one call fall on two lanes, lane and lane ^ xor_mask,
// each needing words hi and hi + 2 of two calls (hi = 0 on one lane, 1 on
// the other): so each lane makes one call, the one with counter
// (c0, i, h, b), keeps its words hi and hi + 2 in own, and sends its words
// 1 - hi and 3 - hi to the other lane, receiving that lane's call's words
// hi and hi + 2 in other. Each call is made once per pass. Called by the
// whole warp.
__device__ __forceinline__ void philox_pair(const DropoutKey& key,
                                            unsigned int c0, int i, int h,
                                            int b, int hi, int xor_mask,
                                            unsigned int (&own)[2],
                                            unsigned int (&other)[2]) {
  const Philox4 r =
      philox4x32_10(c0, static_cast<unsigned int>(i),
                    static_cast<unsigned int>(h),
                    static_cast<unsigned int>(b), key.k0, key.k1);
  own[0] = philox_word(r, hi);
  own[1] = philox_word(r, hi + 2);
  other[0] = __shfl_xor_sync(0xffffffffu, philox_word(r, 1 - hi), xor_mask);
  other[1] = __shfl_xor_sync(0xffffffffu, philox_word(r, 3 - hi), xor_mask);
}

}  // namespace mmgl
