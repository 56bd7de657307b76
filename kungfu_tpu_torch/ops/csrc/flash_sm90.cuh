// Hopper (sm_90a) building blocks of the 16-bit flash kernels, forward
// and backward: warpgroup matrix products (wgmma.mma_async) with float
// accumulators in registers, their shared-memory matrix descriptors, and
// the copies into the 128-byte-swizzled layout the descriptors read:
// asynchronous 16-byte copies (cp.async, the backward) and TMA tile copies
// completing on shared-memory barriers (the forward).  A TMA box 128 bytes
// wide with the 128-byte swizzle lands in exactly that layout.
//
// Shared-memory tiles.  A tile of R rows by DP columns (DP = 64 or 128
// 16-bit values) is stored as DP / 64 panels of R rows x 128 bytes; panel p
// holds columns 64p..64p+63.  The 16-byte chunk c (columns 8c..8c+7) of row
// r sits at chunk c ^ (r % 8) of its row: the 128-byte swizzle, whose
// 1024-byte atoms (8 rows) must start 1024-byte aligned.  One such tile
// serves two ways:
//  - K-major: rows are M (or N) and columns the reduction dimension K, as
//    for Q or K in S = Q K^T.  A k-step of 16 columns starts 32 bytes
//    further along the row (the hardware applies the swizzle to the full
//    address); 8-row groups are 1024 bytes apart (SBO).
//  - MN-major (transposed B): rows are the reduction dimension K and
//    columns N, as for V in O = P V or K in dQ = dS K.  A k-step of 16 rows
//    starts 2048 bytes further; each product reads one 64-column panel
//    (N = 64), whose 8-row groups are 1024 bytes apart.
//
// Register fragments (per warpgroup, 64 rows; warp w owns rows 16w..16w+15,
// lane l has g = l / 4 and t = l % 4).  An m64nN float accumulator d[N / 2]
// holds d[4j + e] at row g + 8 * (e / 2), column 8j + 2t + e % 2.  The
// 16-bit A operand of one k-step (16 columns) is 4 registers of 2 values:
// (g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..).  So the
// accumulator columns 16kk..16kk+15 become A fragment kk by packing pairs
// in order: the probabilities never leave the registers.  A row's values
// sit in the four lanes of one quad (same g), so a row reduction takes two
// shuffles.
#pragma once

#include "flash_common.cuh"

namespace kft {
namespace sm90 {

constexpr int kWgThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (relative error below 2^-22).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes (stores and completed cp.async)
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tell the compiler the registers change here, so that it neither reads
// an accumulator before the wgmma that writes it has been waited for nor
// reuses an operand register while a wgmma may still read it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Matrix descriptor of a 128-byte-swizzled operand at shared address addr.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: rows row0.. of a tile of R rows (panel stride R * 128),
// k-step ks (16 columns).
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int ks) {
  return make_desc(tile + (ks >> 2) * (R * 128) + row0 * 128 + (ks & 3) * 32, 16, 1024);
}

// MN-major operand: panel n (columns 64n..64n+63) of a tile of R rows,
// k-step ks (rows 16ks..16ks+15).  Both strides are the 8-row group's
// 1024 bytes: one panel spans the whole N of a product.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int n, int ks) {
  return make_desc(tile + n * (R * 128) + ks * 2048, 1024, 1024);
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Start the copy of rows [r0, r0 + R) x columns [0, D) of a row-major
// matrix (row i at g + i * stride) into the swizzled tile at shared
// address `tile`; rows past nrows are zero-filled.  Columns D..DP-1 are
// left alone (zero them once with zero_pad).  Thread tid copies chunk
// tid % (DP / 8) of rows tid / (DP / 8) + k * kStep: a fixed count of
// copies whose addresses step by constants (the swizzle repeats every 8
// rows), so each costs a few instructions.
template <int R, int DP, int NT, typename T>
__device__ __forceinline__ void load_tile(uint32_t tile, const T* g, int64_t stride, int r0,
                                          int nrows, int D, int tid) {
  constexpr int kChunks = DP / 8;        // 16-byte chunks a row
  constexpr int kStep = NT / kChunks;    // rows one pass of the threads covers
  static_assert(R % kStep == 0 && kStep % 8 == 0, "whole passes of whole swizzle atoms");
  const int c = tid % kChunks;
  const int r = tid / kChunks;
  if (c >= D / 8) return;
  const uint32_t dst = tile + swz<R>(r, c);
  const T* src = g + (int64_t)(r0 + r) * stride + c * 8;
#pragma unroll
  for (int k = 0; k < R / kStep; ++k) {
    const bool ok = r0 + r + k * kStep < nrows;
    cp_async16(dst + k * kStep * 128, ok ? src + k * kStep * stride : g, ok);
  }
}

// ---- TMA tile copies completing on shared-memory barriers (mbarrier) ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Make initialized barriers visible to the copy engine and the other threads
// (the caller synchronises the block after it).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrive on the barrier and expect `bytes` more of copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Wait until the barrier's phase of this parity has completed.  A wait
// that does not end (a fault: copies that never arrive) traps, failing the
// launch, instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n > (1u << 24)) __trap();
}

// Copy box (c0, c1, c2, c3) of the 4-d tensor `map` into shared memory at
// dst; the barrier counts its bytes.  Elements outside the tensor read as 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const void* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Zero columns D..DP-1 of a swizzled tile (16-bit values).
template <int R, int DP, int NT>
__device__ __forceinline__ void zero_pad(unsigned char* tile, int D, int tid) {
  constexpr int kChunks = DP / 8;
  const int chunks = D / 8;
  for (int i = tid; i < R * kChunks; i += NT) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    if (c >= chunks) *reinterpret_cast<uint4*>(tile + swz<R>(r, c)) = make_uint4(0, 0, 0, 0);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator columns 16kk..16kk+15 as the A fragment of k-step kk, for
// KS = 4 or 8 k-steps (an m64n64 or m64n128 accumulator).
template <typename T, int KS>
__device__ __forceinline__ void to_frag(uint32_t (&a)[KS][4], const float (&d)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack2<T>(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
  }
}

#define KFT_D32                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define KFT_D64                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "     \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "      \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "      \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define KFT_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define KFT_F8(d, i) KFT_F4(d, i), KFT_F4(d, i + 4)
#define KFT_D32_OUT(d) KFT_F8(d, 0), KFT_F8(d, 8), KFT_F8(d, 16), KFT_F8(d, 24)
#define KFT_D64_OUT(d) KFT_D32_OUT(d), KFT_F8(d, 32), KFT_F8(d, 40), KFT_F8(d, 48), KFT_F8(d, 56)

// d[64xN] (+)= A[64x16] B[16xN], both from shared memory, both K-major;
// N = 64 (d[32]) or 128 (d[64]).
template <typename T, int R>
__device__ __forceinline__ void mma_ss(float (&d)[R], uint64_t da, uint64_t db, int acc) {
  static_assert(R == 32 || R == 64, "m64n64 or m64n128");
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (R == 32 && kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KFT_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : KFT_D32_OUT(d)
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (R == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " KFT_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : KFT_D32_OUT(d)
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KFT_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : KFT_D64_OUT(d)
        : "l"(da), "l"(db), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " KFT_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : KFT_D64_OUT(d)
        : "l"(da), "l"(db), "r"(acc));
  }
}

// d[64x64] (+)= A[64x16] (registers) B[16x64] (shared memory, MN-major).
template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KFT_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : KFT_D32_OUT(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " KFT_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : KFT_D32_OUT(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
}

#undef KFT_D32
#undef KFT_D64
#undef KFT_F4
#undef KFT_F8
#undef KFT_D32_OUT
#undef KFT_D64_OUT

// Dynamic shared memory, aligned up to the 1024-byte swizzle atom (a
// kernel asks for 1024 bytes more than its tiles).
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Store the accumulator acc[DP / 64][32] (this thread's rows row_lo and
// row_lo + 8, 64-column panels) times mul into rows < L and columns < D
// of a [*, D] matrix with row stride `stride`.
template <typename T, int DP>
__device__ __forceinline__ void store_acc(T* g, int64_t stride, int row_lo, int L, int D,
                                          const float (&acc)[DP / 64][32], float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < DP / 64; ++n) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = row_lo + 8 * ((i >> 1) & 1);
      const int col = 64 * n + 8 * (i >> 2) + 2 * t;
      if (row < L && col < D)
        *reinterpret_cast<uint32_t*>(g + row * stride + col) =
            pack2<T>(acc[n][i] * mul, acc[n][i + 1] * mul);
    }
  }
}

template <int DP>
__device__ __forceinline__ void fence_acc(float (&acc)[DP / 64][32]) {
#pragma unroll
  for (int n = 0; n < DP / 64; ++n) reg_fence(acc[n]);
}

template <int K>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) reg_fence(a[kk]);
}

}  // namespace sm90
}  // namespace kft
