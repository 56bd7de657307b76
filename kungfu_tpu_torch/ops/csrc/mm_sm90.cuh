// The Hopper (sm_90a) matrix-product body of the fused computation-
// collective kernels (fused_matmul.cu: B9 all-gather-matmul, B10
// matmul-reduce-scatter) and of the product-only entry kft_mm_product:
// bf16 operands, f32 accumulators in registers.
//
// A block is 320 threads.  Warps 0-7 are two consumer warpgroups that run
// wgmma.mma_async on tiles in shared memory.  Warp 8, the producer, keeps
// a ring of stages filled by TMA (cp.async.bulk.tensor): a stage completes
// on its own mbarrier ("full", the copies' bytes) and is handed back on
// another ("empty", one arrival per consumer warpgroup once its products
// have read it).  Warp 9, the peer warp, takes the kernels' ring work (B9
// forwards shards, B10 prefetches the received partial).  The ring runs on
// across hop and tile boundaries without draining, so the next tile's
// first stages load while this one's epilogue runs.  The schedule is
// static and persistent: one block an SM, block b takes tiles b, b + G,
// b + 2G, ... of a grid of G, the same on every rank.
//
// Two tilings, three stages of 48 KB each:
//   kAg (B9)  128 x 256 output tiles.  A stage is 64 deep in K: A [128 rows
//             x 64] and B [64 x 256].  Warpgroup w multiplies A's rows
//             64w..64w+63 by all of B (m64n256k16) over all of K: 128 f32
//             accumulators a thread.  A bf16 tile leaves through shared
//             memory by TMA stores, which run on while the next tile's
//             products do (from registers, 4-byte stores to 8 rows at a
//             time wrote B9's output at under 1 TB/s).
//   kRs (B10) 64 x 128 output tiles (128 of them at [256, 4096]).  A stage
//             is 128 deep in K, two halves of 64, each A [64 x 64] and B
//             [64 x 128].  Warpgroup w takes half w (m64n128k16), so the
//             two split K; their sums meet in shared memory in a fixed
//             order at the tile's end (no atomics: every run adds alike).
//             At 64 rows a tile the loads bound it: L2 serves each block
//             1.5 MB a hop.  Clusters of 2 and 4 blocks sharing B by TMA
//             multicast ran slower on an H100 (their blocks wait for each
//             other at every stage of a 3-stage ring).
// A (row-major x) is K-major: one 128-byte-swizzled panel of 64 columns,
// 8-row groups 1024 bytes apart.  B (row-major w) is MN-major: BN / 64
// panels of [64 k-rows x 128 bytes], each one TMA box, 8 KB apart; the
// descriptor's leading byte offset steps from panel to panel across the
// product's N, its stride byte offset over 8-row groups of K.  Ragged
// edges (rows past M, columns past N, K past the operand) arrive from the
// copy engine as zeros; the epilogues mask their stores (TMA stores drop
// what lies past the tensor).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "flash_sm90.cuh"
#include "ring_common.cuh"

// Ablations for measurement (set in a copy of the source, as
// tools/fused_ab.py --ablate does): 1 takes the loads out (the producer
// arrives without copying), 2 the products, 4 the sends to the peer (B9's
// forwarded shards, B10's partials).  The results are then wrong; the
// kernels' timings say what bounds them.
#ifndef KFT_MM_ABLATE
#define KFT_MM_ABLATE 0
#endif

namespace kft_mm {

using kft_ring::u64;
using namespace kft::sm90;

constexpr int kThreads = 320;      // two consumer warpgroups, the producer, the peer warp
constexpr int kConsumers = 256;
constexpr int kProducerWarp = 8;
constexpr int kPeerWarp = 9;
constexpr int kConsumerBar = 1;    // named barrier of the two consumer warpgroups

enum TilingKind { kAg = 0, kRs = 1 };

template <int kKind>
struct Tiling {
  static constexpr bool kSplit = kKind == kRs;  // the warpgroups split K
  static constexpr int BM = kSplit ? 64 : 128;
  static constexpr int BN = kSplit ? 128 : 256;
  static constexpr int KB = kSplit ? 128 : 64;  // K depth of a stage
  static constexpr int kStages = 3;
  static constexpr int kABytes = BM * KB * 2;
  static constexpr int kBBytes = KB * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kAcc = BN / 2;  // f32 accumulators a thread: m64 x BN over 128 threads
  static constexpr int kRing = kStages * kStageBytes;
  // kRs: the second warpgroup's sum (padded rows) and the received partial;
  // kAg: the bf16 output tile on its way out by TMA
  static constexpr int kRedLd = BN + 8;
  static constexpr int kRed = kSplit ? BM * kRedLd * 4 : BM * BN * 2;
  static constexpr int kRcv = kSplit ? BM * BN * 4 : 0;
  static constexpr int kBarOff = kRing + kRed + kRcv;
  static constexpr int kBars = 2 * kStages + 2;  // full, empty; kRs: received full, empty
  static constexpr int kBytes = kBarOff + 8 * kBars + 1024;  // + aligning to the swizzle atom
  static_assert(kABytes == 16384 && kBBytes == 32768, "48 KB stages");
  static_assert(kStageBytes % 1024 == 0 && kRed % 1024 == 0, "tiles start on swizzle atoms");
  static_assert(kBytes <= 232448, "one block an SM");
};

// ------------------------------------------------------------ wgmma ----

#define KFT_MM_D64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                  \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"        \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"        \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define KFT_MM_D128                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                  \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"        \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"        \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"        \
  " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"        \
  " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"        \
  " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"  \
  " %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"    \
  " %125, %126, %127}"
#define KFT_MM_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define KFT_MM_F16(d, i) \
  KFT_MM_F4(d, i), KFT_MM_F4(d, i + 4), KFT_MM_F4(d, i + 8), KFT_MM_F4(d, i + 12)
#define KFT_MM_OUT64(d) KFT_MM_F16(d, 0), KFT_MM_F16(d, 16), KFT_MM_F16(d, 32), KFT_MM_F16(d, 48)
#define KFT_MM_OUT128(d) KFT_MM_OUT64(d), KFT_MM_F16(d, 64), KFT_MM_F16(d, 80), KFT_MM_F16(d, 96), \
                         KFT_MM_F16(d, 112)

// d[64 x N] (+)= A[64 x 16] B[16 x N], bf16 from shared memory: A K-major,
// B MN-major (transposed); N = 128 (d[64]) or 256 (d[128]).  acc = 0
// overwrites d.
template <int R>
__device__ __forceinline__ void mma_bt(float (&d)[R], uint64_t da, uint64_t db, int acc) {
  static_assert(R == 64 || R == 128, "m64n128 or m64n256");
  if constexpr (R == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KFT_MM_D64
        ", %64, %65, p, 1, 1, 0, 1;\n}\n"
        : KFT_MM_OUT64(d)
        : "l"(da), "l"(db), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " KFT_MM_D128
        ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : KFT_MM_OUT128(d)
        : "l"(da), "l"(db), "r"(acc));
  }
}

#undef KFT_MM_D64
#undef KFT_MM_D128
#undef KFT_MM_F4
#undef KFT_MM_F16
#undef KFT_MM_OUT64
#undef KFT_MM_OUT128

// Shared addresses of stage st's tiles.  kAg: A [128 x 64] at 0 (warpgroup
// w's rows at 8 KB w), B's 4 panels at 16 KB.  kRs: A of half h at 8 KB h,
// B of half h at 16 KB + 16 KB h (2 panels).
template <int kKind>
__device__ __forceinline__ uint32_t stage_a(uint32_t ring, int st, int h) {
  return ring + st * Tiling<kKind>::kStageBytes + h * 8192;
}
template <int kKind>
__device__ __forceinline__ uint32_t stage_b(uint32_t ring, int st, int h) {
  return ring + st * Tiling<kKind>::kStageBytes + Tiling<kKind>::kABytes + h * 16384;
}

// Warpgroup wg's products of stage st: four k-steps of 16.
template <int kKind>
__device__ __forceinline__ void mma_stage(float (&acc)[Tiling<kKind>::kAcc], uint32_t ring,
                                          int st, int wg, bool accumulate) {
  const uint32_t a = stage_a<kKind>(ring, st, wg);
  const uint32_t b = stage_b<kKind>(ring, st, Tiling<kKind>::kSplit ? wg : 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (!(KFT_MM_ABLATE & 2))
      mma_bt(acc, make_desc(a + kk * 32, 16, 1024), make_desc(b + kk * 2048, 8192, 1024),
             accumulate || kk > 0);
  }
}

// ------------------------------------------------------- the pipeline ----

// A wait on a barrier of this block.  The producer and the peer warp wait
// for peers with the ring's bounded waits, so nothing here should wait
// longer than a few of those; a wait that does not end (a fault) traps,
// failing the launch, instead of holding the card.
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar, int parity, u64 limit_ns) {
  if (mbar_try_wait(bar, parity)) return;
  const u64 deadline = kft_ring::globaltimer() + limit_ns;
  while (!mbar_try_wait(bar, parity))
    if (kft_ring::globaltimer() > deadline) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}


// Generic-proxy writes acquired from a peer (NVLink stores, then a flag)
// become visible to this thread's later copy-engine reads.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The two consumer warpgroups meet (the other warps run on).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBar), "n"(kConsumers) : "memory");
}

// The block's pipeline state: barrier addresses and the ring position
// (`it` counts stages over the whole kernel, the same in every role).
template <int kKind>
struct Pipe {
  using Tl = Tiling<kKind>;
  uint32_t ring, bars;
  u64 limit_ns;
  int it = 0;

  __device__ uint32_t full(int st) const { return bars + 8 * st; }
  __device__ uint32_t empty(int st) const { return bars + 8 * (Tl::kStages + st); }
  __device__ uint32_t rcv_full() const { return bars + 8 * (2 * Tl::kStages); }
  __device__ uint32_t rcv_empty() const { return bars + 8 * (2 * Tl::kStages + 1); }

  // Producer (one lane): claim the next stage, expecting its bytes; returns
  // the stage.  The copies into it are issued by the caller.
  __device__ int claim() {
    const int st = it % Tl::kStages;
    if (it >= Tl::kStages) mbar_wait_bounded(empty(st), (it / Tl::kStages - 1) & 1, limit_ns);
    if constexpr (KFT_MM_ABLATE & 1)
      mbar_arrive(full(st));
    else
      mbar_expect_tx(full(st), Tl::kStageBytes);
    ++it;
    return st;
  }

  // Producer (one lane), at the end: every copy it issued has landed, so
  // the block may exit.
  __device__ void drain() const {
    for (int i = it - Tl::kStages < 0 ? 0 : it - Tl::kStages; i < it; ++i)
      mbar_wait_bounded(full(i % Tl::kStages), (i / Tl::kStages) & 1, limit_ns);
  }

  // Consumers: one output tile of `steps` stages into acc (warpgroup wg).
  // One wgmma group stays in flight: a stage is handed back once the next
  // stage's products are issued and its own have retired.
  __device__ void consume(float (&acc)[Tl::kAcc], int steps, int wg) {
    const bool signals = (threadIdx.x & 127) == 0;
    int prev = -1;
    for (int i = 0; i < steps; ++i, ++it) {
      const int st = it % Tl::kStages;
      mbar_wait_bounded(full(st), (it / Tl::kStages) & 1, limit_ns);
      wg_fence();
      mma_stage<kKind>(acc, ring, st, wg, i > 0);
      wg_commit();
      wg_wait<1>();
      reg_fence(acc);
      if (prev >= 0 && signals) mbar_arrive(empty(prev));
      prev = st;
    }
    wg_wait<0>();
    reg_fence(acc);
    if (prev >= 0 && signals) mbar_arrive(empty(prev));
  }
};

template <int kKind>
__device__ __forceinline__ Pipe<kKind> make_pipe(unsigned char* smem, u64 limit_ns) {
  Pipe<kKind> p;
  p.ring = smem_u32(smem);
  p.bars = p.ring + Tiling<kKind>::kBarOff;
  p.limit_ns = limit_ns;
  if (threadIdx.x == 0) {
    for (int i = 0; i < Tiling<kKind>::kStages; ++i) {
      mbar_init(p.full(i), 1);
      mbar_init(p.empty(i), 2);  // one arrival per consumer warpgroup
    }
    mbar_init(p.rcv_full(), 1);
    mbar_init(p.rcv_empty(), 1);
    mbar_init_fence();
  }
  __syncthreads();
  return p;
}

// The warp index, as a value the compiler knows is the same across the
// warp (so the role branches do not serialize wgmma).
__device__ __forceinline__ int warp_id() { return __shfl_sync(0xffffffffu, threadIdx.x / 32, 0); }

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------ epilogues --

// Warpgroup wg's m64 x BN accumulator, cast to OutT, into rows < M and
// columns < N of out (row stride N, N even) at the tile's (m0, n0).  d[4j +
// e] holds row g + 8 (e / 2), column 8j + 2t + e % 2 of the warpgroup's 64
// rows (g = lane / 4, t = lane % 4, 16 rows a warp).
template <typename OutT, int R>
__device__ __forceinline__ void store_acc_rows(OutT* out, int M, int N, int m0, int n0,
                                               const float (&d)[R]) {
  const int lane = threadIdx.x & 31;
  const int row = m0 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = col0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r < M && col < N) {
        const float lo = d[4 * j + 2 * h], hi = d[4 * j + 2 * h + 1];
        OutT* p = out + (int64_t)r * N + col;
        if constexpr (std::is_same<OutT, float>::value)
          *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
        else
          *reinterpret_cast<uint32_t*>(p) = pack2<__nv_bfloat16>(lo, hi);
      }
    }
  }
}

// TMA stores from shared memory: box (c0, c1, c2, c3) of `map` from src.
__device__ __forceinline__ void tma_store(const void* map, uint32_t src, int c0, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's committed stores have read their shared memory (kRead) or
// are complete.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The 128 threads of warpgroup wg meet (named barriers 2 and 3).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// kAg, bf16 out: warpgroup wg's m64 x 256 accumulator through its 32 KB of
// `tile` (4 panels of [64 rows x 128 bytes], 128-byte swizzled) to rows
// m0.. and columns n0.. of `map` by four TMA stores; the copy engine drops
// what lies past the tensor.  The stores run on while the next tile
// computes: the next call first waits until they have read the panels.
__device__ __forceinline__ void store_acc_tma(const void* map, uint32_t tile, int m0, int n0,
                                              const float (&d)[128], int wg, bool first) {
  const bool leader = (threadIdx.x & 127) == 0;
  const uint32_t base = tile + wg * 32768;
  if (!first) {
    if (leader) bulk_wait<true>();
    warpgroup_sync(wg);
  }
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const uint32_t at = base + (j >> 3) * 8192 + r * 128 + (((j & 7) ^ (r & 7)) << 4) +
                          4 * (lane & 3);
      const uint32_t v = pack2<__nv_bfloat16>(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
    }
  }
  fence_async_smem();  // the stores above, before the copy engine reads them
  warpgroup_sync(wg);
  if (leader) {
#pragma unroll
    for (int p = 0; p < 4; ++p) tma_store(map, base + p * 8192, n0 + 64 * p, m0, 0, 0);
    bulk_commit();
  }
}

// kRs: the two warpgroups' sums of one tile into red [64][kRedLd] f32:
// warpgroup 1 stores its own, then warpgroup 0 adds its to it (acc0 +
// acc1, the same order every run).
__device__ __forceinline__ void meet_halves(float* red, const float (&d)[64], int wg) {
  constexpr int LD = Tiling<kRs>::kRedLd;
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(red + (row + 8 * h) * LD + col0 + 8 * j) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
  consumers_sync();
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* p = reinterpret_cast<float2*>(red + (row + 8 * h) * LD + col0 + 8 * j);
        const float2 o = *p;
        *p = make_float2(d[4 * j + 2 * h] + o.x, d[4 * j + 2 * h + 1] + o.y);
      }
  }
  consumers_sync();
}

// ------------------------------------------------------------- launch ----

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled from the driver, found at run time (no link to libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d view (dims[0] innermost; strides in bytes of dims 1..3, each a
// multiple of 16) with boxes `box`: bf16 boxes 64 wide with the 128-byte
// swizzle, f32 boxes unswizzled.  Elements outside the view read as zeros.
inline bool encode4(CUtensorMap* map, bool bf16, const void* base, const uint64_t (&dims)[4],
                    const uint64_t (&strides)[3], const uint32_t (&box)[4]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  cuuint64_t s[3] = {strides[0], strides[1], strides[2]};
  cuuint32_t b[4] = {box[0], box[1], box[2], box[3]};
  cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(base), d, s, b, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace kft_mm
