// All-gather-matmul and matmul-reduce-scatter for Hopper (sm_90a): the
// fused computation-collective kernels of the fused benchmark.
//
// Replace the TPU kernels kungfu_tpu/ops/ring_kernels.py
// `make_ag_matmul_kernel` (launched by fused_matmul.all_gather_matmul) and
// `make_matmul_rs_kernel` (by fused_matmul.matmul_reduce_scatter), on the
// peer workspace protocol of the ring kernels (ring_common.cuh: a slot per
// hop in the neighbour's workspace, a flag per (hop, block), bounded waits,
// an acknowledgement counter per kind).
//
//   all-gather-matmul      y = x @ concat_rows(W_0 .. W_{n-1}), x [M, K],
//                          w_shard [Ks, N] (K = n Ks).  At hop s rank d
//                          forwards shard c = (d - s) mod n (its own at
//                          s = 0) into slot c of its right neighbour, each
//                          block its share of the bytes, and raises that
//                          block's flag there.  Every slot is written once
//                          per call, so forwarding in place is race-free
//                          (the make_ag_kernel argument).  Then each output
//                          tile sums x[:, c Ks:(c+1) Ks] @ W_c over
//                          s = 0 .. n-1 in one f32 accumulator, waiting
//                          (bounded) for every block's flag of hop s - 1
//                          before it first reads shard c.  The gathered W
//                          never exists as one tensor; slot d stays unused
//                          (the own shard is read where it lies).
//   matmul-reduce-scatter  rank d returns rows [d Mc, (d+1) Mc) of
//                          sum_r x_r @ w_r, x [n Mc, K], w [K, N].  At hop s
//                          it computes the f32 product of row chunk
//                          c = (d - s - 1) mod n tile by tile, adds the
//                          partial its left neighbour stored in its receive
//                          slot s - 1 (s > 0), and stores the sum into its
//                          right neighbour's receive slot s.  At the end
//                          the own chunk's product plus slot n - 2 is the
//                          output.  Each element's sum is therefore
//                          P_c(d) + (P_c(d-1) + (... + P_c(d+1))), the
//                          Pallas kernel's association, every partial in
//                          f32; only the products' own order of additions
//                          differs.  The TPU kernel's two staging slots hold
//                          a DMA's source in VMEM; here the sum goes from
//                          shared memory straight into the peer's slot, so
//                          there are none.
//
// Products: 128 x 128 output tiles over a persistent grid of at most one
// block per SM (a block spins on its neighbour's blocks, so all must be
// resident), 256 threads, K in steps of 32 staged through shared memory
// with the ragged edges zero-filled there (nothing is padded in device
// memory).  bf16 runs on tensor cores through WMMA 16x16x16 tiles (f32
// accumulators, each warp 32 x 64 of the tile); f32 runs as f32 FMA on the
// CUDA cores (each thread 8 x 8 outputs), since the tensor cores' TF32
// would drop 13 bits of every operand.  The tile is stored through shared
// memory for the epilogue (cast, or add and send).
//
// What bounds them: operations.  At the flagship FSDP step's MLP shapes
// (B9: x [4096, 1024] @ W_in [1024, 4096], a shard [256, 4096] a rank; B10:
// activations^T [1024, 4096] @ dy [4096, 4096], out [256, 4096] a rank; bf16,
// 4 ranks) each is 34.4 GFLOP a rank: 0.0347 ms at 989 TFLOP/s, against
// 0.014 ms (B9: 6.3 MB of shards sent a rank) and 0.028 ms (B10: 12.6 MB of
// f32 partials) over 450 GB/s of NVLink; four ranks on one card, 0.139 ms.
// This first version hides little of it: no cp.async or TMA, no wgmma, one
// 128-row tile per block at a time, and B9 forwards every shard before its
// products start (the own shard's products do not wait).  The later work
// is a wgmma pipeline fed by TMA and the sends overlapped with products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "ring_common.cuh"

namespace kft_ring {

constexpr int kMmThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLdC = kBN + 4;  // f32 tile in shared memory for the epilogue
constexpr int kMmSmem = kBM * kLdC * 4;  // 67,584 bytes; the operand tiles fit inside

enum MmDType { kMmFloat32 = 0, kMmBFloat16 = 2 };

// Padded shared-memory rows: multiples WMMA accepts that keep rows off the
// same banks.
template <typename T>
struct MmLd {
  static constexpr int a = kBK + (sizeof(T) == 2 ? 8 : 4);  // [kBM, kBK] tile of A
  static constexpr int b = kBN + (sizeof(T) == 2 ? 8 : 4);  // [kBK, kBN] tile of B
};
static_assert(kBM * MmLd<float>::a * 4 + kBK * MmLd<float>::b * 4 <= kMmSmem, "f32 tiles");
static_assert(kBM * MmLd<__nv_bfloat16>::a * 2 + kBK * MmLd<__nv_bfloat16>::b * 2 <= kMmSmem,
              "bf16 tiles");

template <typename T>
__device__ __forceinline__ T mm_from_f(float x);
template <>
__device__ __forceinline__ float mm_from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 mm_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One element through L2 (a slot a peer stored into) or as usual.
template <typename T, bool kCg>
__device__ __forceinline__ T ld_elem(const T* p) {
  if constexpr (!kCg) {
    return *p;
  } else if constexpr (sizeof(T) == 4) {
    return __uint_as_float(__ldcg(reinterpret_cast<const unsigned*>(p)));
  } else {
    const unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
    return *reinterpret_cast<const T*>(&bits);
  }
}

template <bool kCg>
__device__ __forceinline__ uint4 ld_vec(const void* p) {
  if constexpr (kCg) return __ldcg(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const uint4*>(p);
}

// Rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major matrix g (row
// stride ld, `rows` x `cols` valid) into shared s (row stride lds), zero
// outside; 16 bytes at a time where a vector lies whole inside and aligned.
template <typename T, int R, int C, bool kCg>
__device__ __forceinline__ void load_tile(T* s, int lds, const T* g, long long ld, int r0,
                                          int c0, int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kPerRow = C / V;
  for (int i = threadIdx.x; i < R * kPerRow; i += kMmThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * V;
    const int gr = r0 + r, gc = c0 + c;
    T* dst = s + r * lds + c;
    const T* src = g + (long long)gr * ld + gc;
    if (gr < rows && gc + V <= cols && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = ld_vec<kCg>(src);  // lds keeps rows 16-byte aligned
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        dst[k] = (gr < rows && gc + k < cols) ? ld_elem<T, kCg>(src + k) : mm_from_f<T>(0.f);
    }
  }
}

// A thread's share of the f32 accumulator of one 128 x 128 tile.
template <typename T>
struct Acc {
  float v[8][8];  // f32: rows ty + 16 i, columns tx + 16 j
};
template <>
struct Acc<__nv_bfloat16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[2][4];
};

template <typename T>
__device__ __forceinline__ void acc_zero(Acc<T>& acc) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.v[i][j] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc.f[i][j], 0.f);
  }
}

// acc += A[m0 : m0+128, 0 : k] @ B[0 : k, n0 : n0+128], A row-major [rows, >= k]
// with row stride lda, B row-major [k, cols] with row stride ldb.
// kCgB: B lies in a slot a peer stored into.
template <typename T, bool kCgB>
__device__ void acc_product(Acc<T>& acc, unsigned char* smem, const T* a, long long lda,
                            int rows, const T* b, long long ldb, int cols, int k, int m0,
                            int n0) {
  constexpr int LA = MmLd<T>::a, LB = MmLd<T>::b;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kBM * LA;
  const int warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // the previous step is done with As / Bs
    load_tile<T, kBM, kBK, false>(As, LA, a + k0, lda, m0, 0, rows, k - k0);
    load_tile<T, kBK, kBN, kCgB>(Bs, LB, b + (long long)k0 * ldb, ldb, 0, n0, k - k0, cols);
    __syncthreads();
    if constexpr (std::is_same<T, float>::value) {
      const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[(ty + 16 * i) * LA + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bs[kk * LB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc.v[i][j] = fmaf(av[i], bv[j], acc.v[i][j]);
      }
    } else {
      using namespace nvcuda;
      const int wr = warp >> 1, wc = warp & 1;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[4];
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wr * 32 + 16 * i) * LA + kk, LA);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * LB + wc * 64 + 16 * j, LB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc.f[i][j], fa[i], fb[j], acc.f[i][j]);
      }
    }
  }
}

// The tile's accumulator into shared C [128, kLdC] f32 (over the operand
// tiles, so it waits for every warp's last product first).
template <typename T>
__device__ __forceinline__ void acc_store(const Acc<T>& acc, float* C) {
  __syncthreads();
  if constexpr (std::is_same<T, float>::value) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) C[(ty + 16 * i) * kLdC + tx + 16 * j] = acc.v[i][j];
  } else {
    const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        nvcuda::wmma::store_matrix_sync(C + (wr * 32 + 16 * i) * kLdC + wc * 64 + 16 * j,
                                        acc.f[i][j], kLdC, nvcuda::wmma::mem_row_major);
  }
  __syncthreads();
}

// Block b's share of `bytes` bytes from `from` to `to` (16-byte aligned),
// 16-byte vectors and then the tail; `kCg`: `from` is a slot a peer stored.
template <bool kCg>
__device__ void copy_share(const char* from, char* to, long long bytes) {
  const long long nvec = bytes / 16;
  long long v0, v1;
  block_range(nvec, &v0, &v1);
  const uint4* src = reinterpret_cast<const uint4*>(from);
  uint4* dst = reinterpret_cast<uint4*>(to);
  for (long long v = v0 + threadIdx.x; v < v1; v += kMmThreads) dst[v] = ld_vec<kCg>(src + v);
  const long long tail = bytes - nvec * 16;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    const long long i = nvec * 16 + threadIdx.x;
    to[i] = kCg ? (char)__ldcg(reinterpret_cast<const unsigned char*>(from) + i) : from[i];
  }
}

__device__ __forceinline__ int ring_mod(int a, int n) { return ((a % n) + n) % n; }

// x [M, n ks], w [ks, N] (this rank's shard), out [M, N].
template <typename T>
__global__ void __launch_bounds__(kMmThreads, 1)
    ag_matmul_kernel(Call c, const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int M, int N, int ks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks, b = blockIdx.x;
  const Layout own = layout(c.ws, c.ws.own, kAgMm), right = layout(c.ws, c.ws.right, kAgMm);
  const long long K = (long long)n * ks;
  const long long shard_bytes = (long long)ks * N * sizeof(T);
  // the right neighbour has read what the earlier calls stored into its slots
  if (!block_wait(c, right.ack, c.ack_want, own.claim, err_ack(kAgMm), 0)) return;
  for (int s = 0; s < n - 1; ++s) {
    const int ci = ring_mod(d - s, n);
    if (s == 0) {
      copy_share<false>(reinterpret_cast<const char*>(w), slot(right, ci), shard_bytes);
    } else {
      // this block's share of shard ci arrived at hop s - 1
      if (!block_wait(c, own.flags + (long long)(s - 1) * mb + b, c.seq, own.claim,
                      err_data(kAgMm), s - 1))
        return;
      copy_share<true>(slot(own, ci), slot(right, ci), shard_bytes);
    }
    block_signal(right.flags + (long long)s * mb + b, c.seq);
  }
  float* C = reinterpret_cast<float*>(smem);
  const int tiles_n = (N + kBN - 1) / kBN, tiles = ((M + kBM - 1) / kBM) * tiles_n;
  int ready = 1;  // hops whose shard has arrived whole (the own shard needs none)
  for (int t = b; t < tiles; t += gridDim.x) {
    const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * kBN;
    Acc<T> acc;
    acc_zero(acc);
    for (int s = 0; s < n; ++s) {
      const int ci = ring_mod(d - s, n);
      if (s >= ready) {  // every block's share of shard ci, from hop s - 1
        for (int j = 0; j < gridDim.x; ++j)
          if (!block_wait(c, own.flags + (long long)(s - 1) * mb + j, c.seq, own.claim,
                          err_data(kAgMm), s - 1))
            return;
        ready = s + 1;
      }
      if (ci == d)
        acc_product<T, false>(acc, smem, x + (long long)ci * ks, K, M, w, N, N, ks, m0, n0);
      else
        acc_product<T, true>(acc, smem, x + (long long)ci * ks, K, M,
                             reinterpret_cast<const T*>(slot(own, ci)), N, N, ks, m0, n0);
    }
    acc_store(acc, C);
    for (int i = threadIdx.x; i < kBM * kBN; i += kMmThreads) {
      const int r = i / kBN, col = i % kBN;
      if (m0 + r < M && n0 + col < N)
        out[(long long)(m0 + r) * N + n0 + col] = mm_from_f<T>(C[r * kLdC + col]);
    }
  }
  block_ack(own.ack);  // slots read: the left may refill them
}

// x [n mc, K], w [K, N], out [mc, N] (this rank's rows of the sum).
template <typename T>
__global__ void __launch_bounds__(kMmThreads, 1)
    matmul_rs_kernel(Call c, const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int mc, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks, b = blockIdx.x;
  const Layout own = layout(c.ws, c.ws.own, kMmRs), right = layout(c.ws, c.ws.right, kMmRs);
  float* C = reinterpret_cast<float*>(smem);
  const int tiles_n = (N + kBN - 1) / kBN, tiles = ((mc + kBM - 1) / kBM) * tiles_n;
  if (!block_wait(c, right.ack, c.ack_want, own.claim, err_ack(kMmRs), 0)) return;
  for (int s = 0; s < n; ++s) {
    const bool last = s == n - 1;
    const int ci = last ? d : ring_mod(d - s - 1, n);
    const float* recv = s > 0 ? reinterpret_cast<const float*>(slot(own, s - 1)) : nullptr;
    float* send = last ? nullptr : reinterpret_cast<float*>(slot(right, s));
    bool waited = s == 0;
    for (int t = b; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * kBN;
      Acc<T> acc;
      acc_zero(acc);
      acc_product<T, false>(acc, smem, x + (long long)ci * mc * K, K, mc, w, N, N, K, m0, n0);
      acc_store(acc, C);
      // this block's tiles of the partial from hop s - 1 (its first product
      // ran while they travelled)
      if (!waited) {
        if (!block_wait(c, own.flags + (long long)(s - 1) * mb + b, c.seq, own.claim,
                        err_data(kMmRs), s - 1))
          return;
        waited = true;
      }
      for (int i = threadIdx.x; i < kBM * kBN; i += kMmThreads) {
        const int r = i / kBN, col = i % kBN;
        if (m0 + r < mc && n0 + col < N) {
          const long long e = (long long)(m0 + r) * N + n0 + col;
          float v = C[r * kLdC + col];
          if (recv) v = v + __ldcg(recv + e);  // own partial + received, as the TPU kernel
          if (last)
            out[e] = mm_from_f<T>(v);
          else
            send[e] = v;
        }
      }
      __syncthreads();  // the next tile's operands overwrite C
    }
    if (!waited && !block_wait(c, own.flags + (long long)(s - 1) * mb + b, c.seq, own.claim,
                               err_data(kMmRs), s - 1))
      return;
    if (!last) block_signal(right.flags + (long long)s * mb + b, c.seq);
  }
  block_ack(own.ack);  // slots read: the left may refill them
}

template <typename T>
int launch_ag_matmul(const Args& a, const void* x, const void* w, void* out, int M, int N,
                     int ks, cudaStream_t stream) {
  const long long shard = (long long)ks * N * sizeof(T);
  if (!args_ok(a) || M < 1 || N < 1 || ks < 1 || a.chunk != (long long)ks * N ||
      shard > a.slot_bytes || (reinterpret_cast<uintptr_t>(w) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ag_matmul_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMmSmem);
  if (e != cudaSuccess) return (int)e;
  ag_matmul_kernel<T><<<a.blocks, kMmThreads, kMmSmem, stream>>>(
      make_call(a), static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      M, N, ks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_matmul_rs(const Args& a, const void* x, const void* w, void* out, int mc, int N,
                     int K, cudaStream_t stream) {
  if (!args_ok(a) || mc < 1 || N < 1 || K < 1 || a.chunk != (long long)mc * N ||
      a.chunk * 4 > a.slot_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(matmul_rs_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMmSmem);
  if (e != cudaSuccess) return (int)e;
  matmul_rs_kernel<T><<<a.blocks, kMmThreads, kMmSmem, stream>>>(
      make_call(a), static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      mc, N, K);
  return (int)cudaGetLastError();
}

}  // namespace kft_ring

// Every function returns a CUDA error code (0 = success).  dtype 0 is f32,
// 2 bf16; x, w and out share it.

// All-gather-matmul: out [M, N] = x [M, n ks] @ the ranks' shards [ks, N]
// stacked by rank; `chunk` = ks * N, whose bytes fit a slot; w is
// 16-byte aligned.
extern "C" int kft_ag_matmul(const void* x, const void* w, void* out, int M, int N, int ks,
                             int dtype, KFT_RING_PARAMS) {
  kft_ring::Args a = KFT_RING_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kft_ring::kMmFloat32)
    return kft_ring::launch_ag_matmul<float>(a, x, w, out, M, N, ks, s);
  if (dtype == kft_ring::kMmBFloat16)
    return kft_ring::launch_ag_matmul<__nv_bfloat16>(a, x, w, out, M, N, ks, s);
  return (int)cudaErrorInvalidValue;
}

// Matmul-reduce-scatter: out [mc, N] = rows [rank mc, (rank+1) mc) of the
// ranks' sum of x [n mc, K] @ w [K, N]; `chunk` = mc * N, whose f32 bytes
// fit a slot.
extern "C" int kft_matmul_rs(const void* x, const void* w, void* out, int mc, int N, int K,
                             int dtype, KFT_RING_PARAMS) {
  kft_ring::Args a = KFT_RING_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kft_ring::kMmFloat32)
    return kft_ring::launch_matmul_rs<float>(a, x, w, out, mc, N, K, s);
  if (dtype == kft_ring::kMmBFloat16)
    return kft_ring::launch_matmul_rs<__nv_bfloat16>(a, x, w, out, mc, N, K, s);
  return (int)cudaErrorInvalidValue;
}
