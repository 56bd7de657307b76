// Shared pieces of the flash-attention kernels for Hopper (sm_90a).
//
// Layout contract with ops/flash.py: q, o, dq, do are [B, L, H, D]; k, v,
// dk, dv are [B, L, Hkv, D]; lse and delta are [B, H, L] float32.  All are
// contiguous, D is a multiple of 16 up to 128, and the element type is
// float, __half or __nv_bfloat16.  Tiles in shared memory are DP = 64 or
// 128 columns wide; a head dim D < DP is padded there with zero columns,
// which are never stored.
//
// The pieces below serve the float kernels: 128 threads (4 warps) a block,
// products as float FMA loops over tiles staged in shared memory with
// padded rows, each warp computing whole 16x16 output tiles.  The 16-bit
// kernels, forward and backward, run on wgmma (flash_sm90.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace kft {

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

enum DType { kFloat32 = 0, kFloat16 = 1, kBFloat16 = 2 };

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Whether query position qp may attend key position kp (seq_len L): the
// padded tail, the causal diagonal and the sliding window, as the TPU
// kernels mask their boundary blocks.
__device__ __forceinline__ bool attend(int qp, int kp, int L, int causal, int window) {
  bool ok = kp < L;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp < window);
  return ok;
}

// Copy rows [r0, r0 + R) of a [nrows, D] matrix (row i at g + i * stride)
// into DP columns of shared memory with leading dimension ld, 16 bytes per
// thread and step; rows past nrows and columns past D are zero-filled, so
// neither the ragged tail nor a narrow head needs a padded copy in device
// memory.
template <typename T, int R, int DP>
__device__ __forceinline__ void load_rows(T* s, int ld, const T* g, int64_t stride, int r0,
                                          int nrows, int D) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DP / kVec;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows && c < D)
      val = *reinterpret_cast<const uint4*>(g + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(s + r * ld + c) = val;
  }
}

// Load `n` floats of a row vector (lse or delta) from g[r0 ...], zero past nrows.
__device__ __forceinline__ void load_vec(float* s, const float* g, int r0, int n, int nrows) {
  for (int i = threadIdx.x; i < n; i += kThreads) s[i] = (r0 + i < nrows) ? g[r0 + i] : 0.f;
}

// Write rows [r0, r0 + R) x columns [0, D) of a float accumulator
// (leading dim lda, DP columns) times `mul` into a [nrows, D] matrix of T;
// rows past nrows and the padded columns are dropped.
template <typename T, int R, int DP>
__device__ __forceinline__ void store_rows(T* g, int64_t stride, int r0, int nrows, int D,
                                           const float* acc, int lda, float mul) {
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i % DP;
    if (r0 + r < nrows && c < D) g[(r0 + r) * stride + c] = from_f<T>(acc[r * lda + c] * mul);
  }
}

// One warp: C[16x16] (float, shared, ldc) = (or +=) A[16xK] * B[Kx16], as
// float FMAs (TF32 would miss the f32 limit of 1e-5 in utils/compare.py).
//   A_ROW: A(m, k) = a[m * lda + k], else A(m, k) = a[k * lda + m]
//   B_ROW: B(k, n) = b[k * ldb + n], else B(k, n) = b[n * ldb + k]
// `a` points at A(0, 0) and `b` at B(0, 0) of this tile.  The caller
// synchronises before other warps read C.
template <bool A_ROW, bool B_ROW, int K>
__device__ __forceinline__ void warp_mma(float* c, int ldc, const float* a, int lda,
                                         const float* b, int ldb, bool accumulate) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = lane + 32 * j;
    const int m = e >> 4;
    const int n = e & 15;
    float acc = accumulate ? c[m * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float av = A_ROW ? a[m * lda + k] : a[k * lda + m];
      const float bv = B_ROW ? b[k * ldb + n] : b[n * ldb + k];
      acc = fmaf(av, bv, acc);
    }
    c[m * ldc + n] = acc;
  }
}

// Padded leading dimensions (elements).  Operand rows are padded by 8
// elements and float rows by 4, so that rows do not all start in the same
// shared-memory bank.
template <int D>
struct Ld {
  static constexpr int op = D + 8;   // [rows, D] operand tiles
  static constexpr int acc = D + 4;  // [rows, D] float accumulators
};
constexpr int kLdScore = 64 + 4;     // [rows, 64] float scores
constexpr int kLdProb = 64 + 8;      // [rows, 64] probabilities in the operand type

}  // namespace kft
