// Helpers shared by the attention kernels (attention_fwd.cu, attention_bwd.cu,
// attention_blocked_bwd.cu, attention_bias_fwd.cu, attention_bias_bwd.cu):
// scalar fp32 loads and FMAs, the inline PTX of the tensor-core bodies
// (mma.sync in bf16 and fp16, ldmatrix, cp.async), and the bias tiles of
// their bias form.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mmgl {

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX package, not -inf

// The element type the C entries take (their dtype and bias_dtype
// arguments): fp32 runs the scalar bodies, bf16 and fp16 the tensor-core
// ones. Masked logits are -1e30 only in fp32 registers: neither 2-byte
// type holds it (fp16's largest is 65504).
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// f(T{}) for the tensor-core element type of a dtype code; a code that has
// no tensor-core body is refused
template <typename F>
cudaError_t with_tc_type(int dtype, F&& f) {
  if (dtype == kBF16) return f(__nv_bfloat16{});
  if (dtype == kF16) return f(__half{});
  return cudaErrorInvalidValue;
}

// the code of a tensor-core element type (with_tc_type's inverse)
template <typename T>
constexpr int tc_code() {
  return std::is_same<T, __half>::value ? kF16 : kBF16;
}

// f(std::integral_constant<int, D>{}) for a head dim the K1-K6 bodies are
// instantiated at: 64 (OPT-125M to 1.3B, T5, the towers), 80 (OPT and MPT
// at 2.7B) and 128 (6.7B); any other is refused. K7-K9 take 64 only (T5's
// d_kv at every size).
template <typename F>
cudaError_t with_head_dim(int head_dim, F&& f) {
  if (head_dim == 64) return f(std::integral_constant<int, 64>{});
  if (head_dim == 80) return f(std::integral_constant<int, 80>{});
  if (head_dim == 128) return f(std::integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
}

// the launch shapes the K1-K6 entries take: positive sizes within the grid's
// 65535 on y and z, and sq <= sk when causal (the ends are aligned)
inline bool valid_shape(int batch, int sq, int sk, int heads, int causal) {
  return batch > 0 && sq > 0 && sk > 0 && heads > 0 && !(causal && sq > sk)
         && batch <= 65535 && heads <= 65535;
}

// one element as fp32, and back
__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float load1(const __half* p) {
  return __half2float(*p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store1(__half* p, float x) {
  *p = __float2half_rn(x);
}

// four consecutive elements as fp32 (16 bytes of fp32, 8 of bf16 or fp16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(pair[0]);
  const float2 hi = __bfloat1622float2(pair[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float4 load4(const __half* p) {
  const __half2* pair = reinterpret_cast<const __half2*>(p);
  const float2 lo = __half22float2(pair[0]);
  const float2 hi = __half22float2(pair[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(p);
  pair[0] = __floats2bfloat162_rn(x.x, x.y);
  pair[1] = __floats2bfloat162_rn(x.z, x.w);
}

__device__ __forceinline__ void store4(__half* p, float4 x) {
  __half2* pair = reinterpret_cast<__half2*>(p);
  pair[0] = __floats2half2_rn(x.x, x.y);
  pair[1] = __floats2half2_rn(x.z, x.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float s, float4 x, float4& acc) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

// ---- the tensor-core bodies' building blocks (bf16, fp16; sm_80 and later) -
//
// mma.sync m16n8k16 fragments, for a warp's lane = 4 g + c:
//   A (16 x 16, row-major): a0 = A[g][2c, 2c+1], a1 = A[g+8][2c, 2c+1],
//                           a2 = A[g][2c+8, +9], a3 = A[g+8][2c+8, +9]
//   B (16 x 8, "col": column n holds k contiguous): b0 = B[2c, 2c+1][g],
//                           b1 = B[2c+8, +9][g]
//   C/D (16 x 8, fp32):     c0, c1 = C[g][2c, 2c+1], c2, c3 = C[g+8][2c, 2c+1]
// Two n8 blocks of a C fragment are, rounded to the element type and packed
// in pairs, the A fragment of one k16 block: a product's output feeds the
// next product from registers. bf16 and fp16 fragments have the same layout
// (2 bytes an element), so ldmatrix and cp.async serve both.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until cp_async_wait; with full false
// nothing is read and the 16 bytes are zero-filled (rows past the edge)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i (16 bytes each), register i receives matrix i in the fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem))
      : "memory");
}

// two 8 x 8 b16 matrices: lanes 0-7 and 8-15 give the row addresses of
// matrices 0 and 1 (the other lanes' are not read); the odd last k16 step
// of a head dim that is not a multiple of 32 (D = 80: five k16 steps)
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(smem))
      : "memory");
}

// the same, each matrix transposed: a row-major (k x n) tile in shared
// memory read as B fragments
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem))
      : "memory");
}

// d += a b, bf16 or fp16 inputs (Tc<T>::mma), fp32 accumulators
template <typename T>
struct Tc;

template <>
struct Tc<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two fp32 rounded to bf16, lo in the low half (the lower column)
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Tc<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two fp32 rounded to fp16 (to nearest; past 65504 to inf, below 2^-24 to
  // 0), lo in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <typename T>
__device__ __forceinline__ void mma_tc(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  Tc<T>::mma(d, a, b0, b1);
}

// two fp32 as a pair of T at p (4-byte aligned)
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = Tc<T>::pack(lo, hi);
}

// 2^x on the card's MUFU.EX2 (a few ulp; 2^-inf = 0, 2^0 = 1 exactly)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the A fragment of k16 block kk from an accumulator of n8 blocks
// (2 kk, 2 kk + 1), rounded to T
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = Tc<T>::pack(lo[0], lo[1]);
  a[1] = Tc<T>::pack(lo[2], lo[3]);
  a[2] = Tc<T>::pack(hi[0], hi[1]);
  a[3] = Tc<T>::pack(hi[2], hi[3]);
}

// the tensor-core bodies' tiles: 64 rows of a head in shared memory, bf16 or
// fp16, rows padded to D + 8 values (16 bytes), so the eight 16-byte row
// reads of an ldmatrix fall in distinct banks: a row is (D + 8) / 2 words,
// 36 at D = 64, 44 at 80, 68 at 128, and eight rows start at word offsets
// that are distinct multiples of 4 modulo 32 (0, 4, ..., 28 at 64 and
// 128; 0, 12, 24, 4, 16, 28, 8, 20 at 80)
constexpr int kTcTile = 64;  // the rows of a streamed tile (keys or queries)

template <int D>
struct TcTile {
  static constexpr int kStride = D + 8;            // elements a smem row
  static constexpr int kElems = kTcTile * kStride;  // elements a tile
};

// a tile's 64 key-mask flags as two words of bits, key i at bit i % 32 of
// word i / 32: called by the 64 threads of warps 0 and 1, thread i with key
// i's flag
__device__ __forceinline__ void store_mask_bits(uint32_t* words, bool ok) {
  const uint32_t bits = __ballot_sync(0xffffffffu, ok);
  if ((threadIdx.x & 31) == 0) words[threadIdx.x >> 5] = bits;
}

// kRows rows row0 .. of one head of a (rows, H * D) bf16 or fp16 matrix
// into a padded tile, kThreads threads, 16 bytes a copy in flight; rows at
// or past n_rows zero-filled
template <int D, int kRows, int kThreads, typename T>
__device__ __forceinline__ void tile_async(T* dst, const T* src,
                                           long row_stride, int row0,
                                           int n_rows, int tid) {
  constexpr int kChunks = D / 8;
  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * TcTile<D>::kStride + 8 * c,
               src + static_cast<long>(ok ? row0 + r : 0) * row_stride + 8 * c,
               ok);
  }
}

// ---- the bias form of the tensor-core bodies (K7, K8/K9) -------------------

// What the bias form adds to a body's arguments: the batch-shared
// (H, Sq, Sk) bias (unread without kBias) with its row stride ld, a
// multiple of 8 elements (the wrapper pads a ragged Sk with zeros), and
// the dropout key (unread without kDropout): element (b, h, i, j) is kept
// iff its Philox word (philox.cuh) is below threshold, and then scaled by
// keep_inv.
template <typename TB>
struct BiasArgs {
  const TB* bias;
  int ld;
  const long long* seed;
  unsigned int threshold;
  float keep_inv;
};

// a bias tile's row stride in shared memory: kCols + 8 elements, so that a
// row starts on 16 bytes and the fragment reads of a warp fall in distinct
// banks (bf16 or fp16, and fp32 along a row)
template <int kCols>
__host__ __device__ constexpr int bias_stride() {
  return kCols + 8;
}

// kRows x kCols of a (rows, ld) bias from (row0, col0) into a padded tile,
// 16 bytes a copy in flight; chunks at or past n_rows or ld zero-filled
template <typename TB, int kRows, int kCols, int kThreads>
__device__ __forceinline__ void bias_tile_async(TB* dst, const TB* src,
                                                int ld, int row0, int n_rows,
                                                int col0, int tid) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(TB));
  constexpr int kChunks = kCols / kPer;
  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = kPer * (e % kChunks);
    const bool ok = row0 + r < n_rows && col0 + c < ld;
    cp_async16(dst + r * bias_stride<kCols>() + c,
               src + (ok ? static_cast<long>(row0 + r) * ld + col0 + c : 0),
               ok);
  }
}

// two consecutive elements as fp32 (8 bytes of fp32, 4 of bf16 or fp16)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// a kernel's dynamic shared memory limit, and the largest carveout of the
// SM's 256 KB for shared memory, so that several blocks fit on an SM
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace mmgl
