// Hopper (sm_90a) building blocks of the 16-bit flash backward kernels:
// warpgroup matrix products (wgmma.mma_async) with float accumulators in
// registers, their shared-memory matrix descriptors, and asynchronous
// 16-byte copies (cp.async) into the 128-byte-swizzled layout the
// descriptors read.
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
//    columns N, as for K in dQ = dS K.  A k-step of 16 rows starts 2048
//    bytes further; each product reads one 64-column panel (N = 64), whose
//    8-row groups are 1024 bytes apart.
//
// Register fragments (per warpgroup, 64 rows; warp w owns rows 16w..16w+15,
// lane l has g = l / 4 and t = l % 4).  An m64n64 float accumulator d[32]
// holds d[4j + e] at row g + 8 * (e / 2), column 8j + 2t + e % 2.  The
// 16-bit A operand of one k-step (16 columns) is 4 registers of 2 values:
// (g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..).  So the
// accumulator columns 16kk..16kk+15 become A fragment kk by packing pairs
// in order: the probabilities never leave the registers.
#pragma once

#include "flash_common.cuh"

namespace kft {
namespace sm90 {

constexpr int kWgThreads = 128;  // one warpgroup

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
// left alone (zero them once with zero_pad).
template <int R, int DP, int NT, typename T>
__device__ __forceinline__ void load_tile(uint32_t tile, const T* g, int64_t stride, int r0,
                                          int nrows, int D, int tid) {
  constexpr int kChunks = DP / 8;
  const int chunks = D / 8;
#pragma unroll
  for (int i = tid; i < R * kChunks; i += NT) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    if (c < chunks) {
      const bool ok = r0 + r < nrows;
      cp_async16(tile + swz<R>(r, c), g + (int64_t)(ok ? r0 + r : 0) * stride + c * 8, ok);
    }
  }
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

// Accumulator columns 16kk..16kk+15 as the A fragment of k-step kk.
template <typename T>
__device__ __forceinline__ void to_frag(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack2<T>(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
  }
}

#define KFT_D32                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define KFT_D32_OUT(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64x64] (+)= A[64x16] B[16x64], both from shared memory, both K-major.
template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KFT_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : KFT_D32_OUT(d)
        : "l"(da), "l"(db), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " KFT_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : KFT_D32_OUT(d)
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
#undef KFT_D32_OUT

}  // namespace sm90
}  // namespace kft
