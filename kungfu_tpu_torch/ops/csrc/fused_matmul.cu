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
//                          (the make_ag_kernel argument).  Each output
//                          tile sums x[:, c Ks:(c+1) Ks] @ W_c over
//                          s = 0 .. n-1 in one f32 accumulator.  The
//                          gathered W never exists as one tensor; slot d
//                          stays unused (the own shard is read where it
//                          lies).
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
// What bounds them: operations.  At the flagship FSDP step's MLP shapes
// (B9: x [4096, 1024] @ W_in [1024, 4096], a shard [256, 4096] a rank; B10:
// activations^T [1024, 4096] @ dy [4096, 4096], out [256, 4096] a rank; bf16,
// 4 ranks) each is 34.4 GFLOP a rank: 0.0347 ms at 989 TFLOP/s, against
// 0.014 ms (B9: 6.3 MB of shards sent a rank) and 0.028 ms (B10: 12.6 MB of
// f32 partials) over 450 GB/s of NVLink; four ranks on one card, 0.139 ms.
//
// bf16 runs on mm_sm90.cuh's product body: wgmma with f32 accumulators in
// registers, fed by TMA through a ring of 48 KB stages on mbarriers from a
// producer warp, one block an SM over a static persistent schedule (block
// b owns the same tiles on every rank, as the per-(hop, block) flags need).
//  - B9: 128 x 256 tiles.  The peer warp forwards the block's share of each
//    shard while the consumers multiply; the own shard's products start at
//    once; a tile's products of hop s wait only for the flags of the blocks
//    whose shares hold the rows of shard c that the copy engine reads (the
//    producer's lanes poll them in parallel, then fence the async proxy
//    before the copy), and only the block's first tile waits at all.
//  - B10: 64 x 128 tiles, 128 of them at [256, 4096] (128 x 128 tiles left
//    half the SMs idle); the two consumer warpgroups split each tile's K and
//    meet in shared memory.  The hop-s product never waits; the peer warp
//    waits for the left's flag of hop s - 1 and prefetches the received
//    partial tile by TMA while the product runs; the epilogue adds own +
//    received in f32 and sends the sum to the right in 16-byte vectors.
// The product alone (kft_mm_product: the same kernels without peers) is
// checked and timed against torch.matmul by tools/fused_time.py.  On an
// H100 80GB HBM3 at 700 W its device time at B9's per-rank shape is 1.1x
// cuBLAS's, at B10's per-hop shape 1.1-1.3x; without its loads B10's hop runs
// 1.8x faster: L2 bandwidth bounds the 64-row tiles.  Still open: the
// first tiles of B9 wait for hops the ring has not brought yet (one
// accumulator a tile, so no tile runs ahead on the own shard), and B10's
// loads (clusters sharing B by multicast lost to their per-stage waits on
// a 3-stage ring; bigger tiles would leave SMs idle at [256, 4096]).
//
// f32 keeps the first version's body: 128 x 128 output tiles, 256 threads,
// K in steps of 32 staged through shared memory with ragged edges zero-
// filled there, f32 FMA on the CUDA cores (each thread 8 x 8 outputs), since
// the tensor cores' TF32 would drop 13 bits of every operand; B9 forwards
// every shard before its products (the own shard's do not wait).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mm_sm90.cuh"
#include "ring_common.cuh"

namespace kft_ring {

__device__ __forceinline__ int ring_mod(int a, int n) { return ((a % n) + n) % n; }

// ------------------------------------------------------------- float ----

constexpr int kMmThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLdA = kBK + 4;  // [kBM, kBK] tile of A, padded rows
constexpr int kLdB = kBN + 4;  // [kBK, kBN] tile of B
constexpr int kLdC = kBN + 4;  // f32 tile in shared memory for the epilogue
constexpr int kMmSmem = kBM * kLdC * 4;  // 67,584 bytes; the operand tiles fit inside
static_assert(kBM * kLdA * 4 + kBK * kLdB * 4 <= kMmSmem, "f32 tiles");

enum MmDType { kMmFloat32 = 0, kMmBFloat16 = 2 };

// One f32 through L2 (a slot a peer stored into) or as usual.
template <bool kCg>
__device__ __forceinline__ float ld_elem(const float* p) {
  if constexpr (!kCg) return *p;
  return __uint_as_float(__ldcg(reinterpret_cast<const unsigned*>(p)));
}

template <bool kCg>
__device__ __forceinline__ uint4 ld_vec(const void* p) {
  if constexpr (kCg) return __ldcg(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const uint4*>(p);
}

// Rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major matrix g (row
// stride ld, `rows` x `cols` valid) into shared s (row stride lds), zero
// outside; 16 bytes at a time where a vector lies whole inside and aligned.
template <int R, int C, bool kCg>
__device__ __forceinline__ void load_tile(float* s, int lds, const float* g, long long ld,
                                          int r0, int c0, int rows, int cols) {
  constexpr int kPerRow = C / 4;
  for (int i = threadIdx.x; i < R * kPerRow; i += kMmThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const int gr = r0 + r, gc = c0 + c;
    float* dst = s + r * lds + c;
    const float* src = g + (long long)gr * ld + gc;
    if (gr < rows && gc + 4 <= cols && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = ld_vec<kCg>(src);  // lds keeps rows 16-byte aligned
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst[k] = (gr < rows && gc + k < cols) ? ld_elem<kCg>(src + k) : 0.f;
    }
  }
}

// A thread's share of the f32 accumulator of one 128 x 128 tile: rows
// ty + 16 i, columns tx + 16 j.
struct Acc {
  float v[8][8];
};

__device__ __forceinline__ void acc_zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc.v[i][j] = 0.f;
}

// acc += A[m0 : m0+128, 0 : k] @ B[0 : k, n0 : n0+128], A row-major [rows, >= k]
// with row stride lda, B row-major [k, cols] with row stride ldb.
// kCgB: B lies in a slot a peer stored into.
template <bool kCgB>
__device__ void acc_product(Acc& acc, unsigned char* smem, const float* a, long long lda,
                            int rows, const float* b, long long ldb, int cols, int k, int m0,
                            int n0) {
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + kBM * kLdA;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // the previous step is done with As / Bs
    load_tile<kBM, kBK, false>(As, kLdA, a + k0, lda, m0, 0, rows, k - k0);
    load_tile<kBK, kBN, kCgB>(Bs, kLdB, b + (long long)k0 * ldb, ldb, 0, n0, k - k0, cols);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[(ty + 16 * i) * kLdA + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[kk * kLdB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc.v[i][j] = fmaf(av[i], bv[j], acc.v[i][j]);
    }
  }
}

// The tile's accumulator into shared C [128, kLdC] f32 (over the operand
// tiles, so it waits for every warp's last product first).
__device__ __forceinline__ void acc_store(const Acc& acc, float* C) {
  __syncthreads();
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) C[(ty + 16 * i) * kLdC + tx + 16 * j] = acc.v[i][j];
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

// x [M, n ks], w [ks, N] (this rank's shard), out [M, N].
__global__ void __launch_bounds__(kMmThreads, 1)
    ag_matmul_f32(Call c, const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int M, int N, int ks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks, b = blockIdx.x;
  const Layout own = layout(c.ws, c.ws.own, kAgMm), right = layout(c.ws, c.ws.right, kAgMm);
  const long long K = (long long)n * ks;
  const long long shard_bytes = (long long)ks * N * sizeof(float);
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
    Acc acc;
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
        acc_product<false>(acc, smem, x + (long long)ci * ks, K, M, w, N, N, ks, m0, n0);
      else
        acc_product<true>(acc, smem, x + (long long)ci * ks, K, M,
                          reinterpret_cast<const float*>(slot(own, ci)), N, N, ks, m0, n0);
    }
    acc_store(acc, C);
    for (int i = threadIdx.x; i < kBM * kBN; i += kMmThreads) {
      const int r = i / kBN, col = i % kBN;
      if (m0 + r < M && n0 + col < N) out[(long long)(m0 + r) * N + n0 + col] = C[r * kLdC + col];
    }
  }
  block_ack(own.ack);  // slots read: the left may refill them
}

// x [n mc, K], w [K, N], out [mc, N] (this rank's rows of the sum).
__global__ void __launch_bounds__(kMmThreads, 1)
    matmul_rs_f32(Call c, const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int mc, int N, int K) {
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
      Acc acc;
      acc_zero(acc);
      acc_product<false>(acc, smem, x + (long long)ci * mc * K, K, mc, w, N, N, K, m0, n0);
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
            out[e] = v;
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

int launch_ag_matmul_f32(const Args& a, const void* x, const void* w, void* out, int M, int N,
                         int ks, cudaStream_t stream) {
  const long long shard = (long long)ks * N * 4;
  if (!args_ok(a) || M < 1 || N < 1 || ks < 1 || a.chunk != (long long)ks * N ||
      shard > a.slot_bytes || (reinterpret_cast<uintptr_t>(w) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ag_matmul_f32,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMmSmem);
  if (e != cudaSuccess) return (int)e;
  ag_matmul_f32<<<a.blocks, kMmThreads, kMmSmem, stream>>>(
      make_call(a), static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), M, N, ks);
  return (int)cudaGetLastError();
}

int launch_matmul_rs_f32(const Args& a, const void* x, const void* w, void* out, int mc, int N,
                         int K, cudaStream_t stream) {
  if (!args_ok(a) || mc < 1 || N < 1 || K < 1 || a.chunk != (long long)mc * N ||
      a.chunk * 4 > a.slot_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(matmul_rs_f32,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMmSmem);
  if (e != cudaSuccess) return (int)e;
  matmul_rs_f32<<<a.blocks, kMmThreads, kMmSmem, stream>>>(
      make_call(a), static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), mc, N, K);
  return (int)cudaGetLastError();
}

}  // namespace kft_ring

// ------------------------------------------------------------- bf16 ----

namespace kft_mm {

using kft_ring::allow_smem;
using kft_ring::Call;
using kft_ring::Layout;
using kft_ring::ring_mod;

// The TMA views of B9: x [M, n ks] as {ks, n, M} (shard c's columns of 128
// rows are one box), the own shard w [ks, N] as {N, ks}, the slots as {N,
// ks, slot}, a bf16 out [M, N] as {N, M}.
struct AgMaps {
  CUtensorMap x, w, slots, out;
};

// The TMA views of B10: x [n mc, K] as {K, mc, chunk}, w [K, N] as {N, K},
// the received f32 partials as {N, mc, slot}.
struct RsMaps {
  CUtensorMap x, w, rcv;
};

// One warp copies 16-byte vectors [v0, v1) from `from` to `to`, eight in
// flight a lane; `kCg`: `from` is a slot a peer stored into (read via L2).
template <bool kCg>
__device__ __forceinline__ void copy_warp(const uint4* from, uint4* to, long long v0,
                                          long long v1) {
  const int lane = threadIdx.x & 31;
  constexpr int kU = 8;
  for (long long v = v0 + lane; v < v1; v += 32 * kU) {
    uint4 r[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (v + 32 * u < v1) r[u] = kft_ring::ld_vec<kCg>(from + v + 32 * u);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (v + 32 * u < v1) to[v + 32 * u] = r[u];
  }
}

// B9 in bf16: x [M, n ks], w [ks, N] (this rank's shard), out [M, N]; N and
// ks multiples of 8.  With n == 1 (c.ws.n) the plain product x @ w, no peers.
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    ag_matmul_sm90(Call c, const __grid_constant__ AgMaps maps, const __nv_bfloat16* w,
                   OutT* __restrict__ out, int M, int N, int ks) {
  using Tl = Tiling<kAg>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  __shared__ int failed_word;  // a wait on a peer gave up: no more flags, no acknowledgement
  volatile int* failed = &failed_word;
  if (threadIdx.x == 0) *failed = 0;
  Pipe<kAg> pipe = make_pipe<kAg>(smem, 4 * c.timeout_ns + 1000000000ull);
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks, b = blockIdx.x, G = gridDim.x;
  const bool ring = n > 1;
  Layout own{}, right{};
  if (ring) {
    own = kft_ring::layout(c.ws, c.ws.own, kft_ring::kAgMm);
    right = kft_ring::layout(c.ws, c.ws.right, kft_ring::kAgMm);
  }
  const int warp = warp_id(), lane = threadIdx.x & 31;
  const int tiles_n = cdiv(N, Tl::BN), tiles = cdiv(M, Tl::BM) * tiles_n;
  const int steps = cdiv(ks, Tl::KB);                 // stages a hop
  const long long nvec = (long long)ks * N / 8;       // 16-byte vectors of a shard
  const long long per = (nvec + G - 1) / G;           // a block's share (block_range)

  if (warp == kProducerWarp) {
    for (int t = b; t < tiles; t += G) {
      const int m0 = (t / tiles_n) * Tl::BM, n0 = (t % tiles_n) * Tl::BN;
      for (int s = 0; s < n; ++s) {
        const int ci = ring_mod(d - s, n);
        for (int kb = 0; kb < steps; ++kb) {
          const int k0 = kb * Tl::KB;
          if (s > 0 && t == b) {
            // the first tile reads rows [k0, k0 + 64) of shard ci once the
            // blocks whose shares hold them have raised their hop s - 1 flags
            const long long v0 = (long long)k0 * N / 8;
            const long long v1 = (long long)min(ks, k0 + Tl::KB) * N / 8;
            const int j1 = (int)min((long long)G - 1, (v1 - 1) / per);
            bool ok = !*failed;
            for (int j = (int)(v0 / per) + lane; ok && j <= j1; j += 32)
              ok = kft_ring::thread_wait(c, own.flags + (long long)(s - 1) * mb + j, c.seq,
                                         own.claim, kft_ring::err_data(kft_ring::kAgMm), s - 1);
            if (!__all_sync(0xffffffffu, ok) && lane == 0) *failed = 1;
            fence_proxy_async_global();  // after the warp's acquires, before its copies
          }
          if (lane == 0) {
            const int st = pipe.claim();
            if constexpr (!(KFT_MM_ABLATE & 1)) {
              tma_load(stage_a<kAg>(pipe.ring, st, 0), &maps.x, pipe.full(st), k0, ci, m0, 0);
#pragma unroll
              for (int p = 0; p < Tl::BN / 64; ++p) {
                const uint32_t dst = stage_b<kAg>(pipe.ring, st, 0) + p * 8192;
                if (ci == d)
                  tma_load(dst, &maps.w, pipe.full(st), n0 + 64 * p, k0, 0, 0);
                else
                  tma_load(dst, &maps.slots, pipe.full(st), n0 + 64 * p, k0, ci, 0);
              }
            }
          }
        }
      }
    }
    if (lane == 0) pipe.drain();
  } else if (warp == kPeerWarp) {
    if (ring) {
      // forward the block's share of each shard: the own at hop 0, then the
      // one that arrived at hop s - 1, while the consumers multiply
      long long v0, v1;
      kft_ring::block_range(nvec, &v0, &v1);
      // the right neighbour has read what the earlier calls stored into its slots
      bool ok = lane != 0 || kft_ring::thread_wait(c, right.ack, c.ack_want, own.claim,
                                                   kft_ring::err_ack(kft_ring::kAgMm), 0);
      ok = __shfl_sync(0xffffffffu, ok, 0);
      for (int s = 0; ok && s < n - 1; ++s) {
        const int ci = ring_mod(d - s, n);
        uint4* to = reinterpret_cast<uint4*>(kft_ring::slot(right, ci));
        if (s == 0) {
          if constexpr (!(KFT_MM_ABLATE & 4))
            copy_warp<false>(reinterpret_cast<const uint4*>(w), to, v0, v1);
        } else {
          ok = lane != 0 || kft_ring::thread_wait(c, own.flags + (long long)(s - 1) * mb + b,
                                                  c.seq, own.claim,
                                                  kft_ring::err_data(kft_ring::kAgMm), s - 1);
          ok = __shfl_sync(0xffffffffu, ok, 0);
          if (!ok) break;
          if constexpr (!(KFT_MM_ABLATE & 4))
            copy_warp<true>(reinterpret_cast<const uint4*>(kft_ring::slot(own, ci)), to, v0, v1);
        }
        __syncwarp();
        if (lane == 0) {
          __threadfence_system();
          kft_ring::st_release(right.flags + (long long)s * mb + b, c.seq);
        }
      }
      if (!ok && lane == 0) *failed = 1;
    }
  } else {
    const int wg = warp / 4;
    float acc[Tl::kAcc];
    for (int t = b; t < tiles; t += G) {
      const int m0 = (t / tiles_n) * Tl::BM, n0 = (t % tiles_n) * Tl::BN;
      pipe.consume(acc, n * steps, wg);  // hop by hop, from the own shard down the ring
      if constexpr (std::is_same<OutT, float>::value)
        store_acc_rows<OutT>(out, M, N, m0 + 64 * wg, n0, acc);
      else
        store_acc_tma(&maps.out, pipe.ring + Tl::kRing, m0 + 64 * wg, n0, acc, wg, t == b);
    }
    if ((threadIdx.x & 127) == 0) bulk_wait<false>();  // the last tile's stores are done
  }
  __syncthreads();
  if (ring && threadIdx.x == 0 && !*failed) {  // slots read: the left may refill them
    __threadfence_system();
    atomicAdd_system(own.ack, 1ULL);
  }
}

// B10 in bf16: x [n mc, K], w [K, N], out [mc, N] (this rank's rows of the
// sum); N and K multiples of 8.  With n == 1 the plain product x @ w.
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    matmul_rs_sm90(Call c, const __grid_constant__ RsMaps maps, OutT* __restrict__ out, int mc,
                   int N, int K) {
  using Tl = Tiling<kRs>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  __shared__ int failed_word;
  volatile int* failed = &failed_word;
  if (threadIdx.x == 0) *failed = 0;
  const u64 limit = 4 * c.timeout_ns + 1000000000ull;
  Pipe<kRs> pipe = make_pipe<kRs>(smem, limit);
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks, b = blockIdx.x, G = gridDim.x;
  const bool ring = n > 1;
  Layout own{}, right{};
  if (ring) {
    own = kft_ring::layout(c.ws, c.ws.own, kft_ring::kMmRs);
    right = kft_ring::layout(c.ws, c.ws.right, kft_ring::kMmRs);
  }
  const int warp = warp_id(), lane = threadIdx.x & 31;
  const int tiles_n = cdiv(N, Tl::BN), tiles = cdiv(mc, Tl::BM) * tiles_n;
  const int steps = cdiv(K, Tl::KB);
  float* red = reinterpret_cast<float*>(smem + Tl::kRing);
  const float* rcv = reinterpret_cast<const float*>(smem + Tl::kRing + Tl::kRed);

  if (warp == kProducerWarp) {
    if (lane == 0) {
      for (int s = 0; s < n; ++s) {
        const int ci = s == n - 1 ? d : ring_mod(d - s - 1, n);
        for (int t = b; t < tiles; t += G) {
          const int m0 = (t / tiles_n) * Tl::BM, n0 = (t % tiles_n) * Tl::BN;
          for (int kb = 0; kb < steps; ++kb) {
            const int st = pipe.claim();
            if constexpr (!(KFT_MM_ABLATE & 1)) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int k0 = kb * Tl::KB + 64 * h;
                tma_load(stage_a<kRs>(pipe.ring, st, h), &maps.x, pipe.full(st), k0, m0, ci, 0);
#pragma unroll
                for (int p = 0; p < Tl::BN / 64; ++p)
                  tma_load(stage_b<kRs>(pipe.ring, st, h) + p * 8192, &maps.w, pipe.full(st),
                           n0 + 64 * p, k0, 0, 0);
              }
            }
          }
        }
      }
      pipe.drain();
    }
  } else if (warp == kPeerWarp) {
    if (lane == 0) {
      // the right neighbour has read what the earlier calls stored into its
      // slots (the consumers' first send waits for this warp's first arrival)
      bool ok = !ring || kft_ring::thread_wait(c, right.ack, c.ack_want, own.claim,
                                               kft_ring::err_ack(kft_ring::kMmRs), 0);
      if (!ok) *failed = 1;  // the consumers send nothing
      int e = 0;  // the block's tile epilogues so far
      for (int s = 0; s < n; ++s) {
        for (int t = b; t < tiles; t += G, ++e) {
          if (e > 0) mbar_wait_bounded(pipe.rcv_empty(), (e - 1) & 1, limit);
          if (s > 0 && ok && t == b)  // the left's partial of hop s - 1, this block's tiles
            ok = kft_ring::thread_wait(c, own.flags + (long long)(s - 1) * mb + b, c.seq,
                                       own.claim, kft_ring::err_data(kft_ring::kMmRs), s - 1);
          if (!ok) *failed = 1;  // the consumers send nothing more
          if (s > 0 && ok) {
            fence_proxy_async_global();
            mbar_expect_tx(pipe.rcv_full(), Tl::kRcv);
            tma_load(smem_u32(rcv), &maps.rcv, pipe.rcv_full(), (t % tiles_n) * Tl::BN,
                     (t / tiles_n) * Tl::BM, s - 1, 0);
          } else {
            mbar_arrive(pipe.rcv_full());
          }
        }
      }
      if (e > 0) mbar_wait_bounded(pipe.rcv_full(), (e - 1) & 1, limit);  // the last copy landed
    }
  } else {
    const int wg = warp / 4;
    float acc[Tl::kAcc];
    int e = 0;
    for (int s = 0; s < n; ++s) {
      const bool last = s == n - 1;
      float* send = last ? nullptr : reinterpret_cast<float*>(kft_ring::slot(right, s));
      for (int t = b; t < tiles; t += G, ++e) {
        const int m0 = (t / tiles_n) * Tl::BM, n0 = (t % tiles_n) * Tl::BN;
        pipe.consume(acc, steps, wg);  // never waits for the received partial
        meet_halves(red, acc, wg);
        mbar_wait_bounded(pipe.rcv_full(), e & 1, limit);
        const bool sends = !last && !*failed;
        // own + received in f32, 4 columns a thread at a time
        for (int i = threadIdx.x; i < Tl::BM * Tl::BN / 4; i += kConsumers) {
          const int r = i / (Tl::BN / 4), col = (i % (Tl::BN / 4)) * 4;
          const int gr = m0 + r, gc = n0 + col;
          if (gr >= mc || gc >= N) continue;
          float4 v = *reinterpret_cast<const float4*>(red + r * Tl::kRedLd + col);
          if (s > 0) {
            const float4 q = *reinterpret_cast<const float4*>(rcv + r * Tl::BN + col);
            v = make_float4(v.x + q.x, v.y + q.y, v.z + q.z, v.w + q.w);
          }
          const int64_t at = (int64_t)gr * N + gc;
          if (last) {
            if constexpr (std::is_same<OutT, float>::value)
              *reinterpret_cast<float4*>(out + at) = v;
            else
              *reinterpret_cast<uint2*>(out + at) =
                  make_uint2(pack2<__nv_bfloat16>(v.x, v.y), pack2<__nv_bfloat16>(v.z, v.w));
          } else if (sends && !(KFT_MM_ABLATE & 4)) {
            *reinterpret_cast<float4*>(send + at) = v;
          }
        }
        consumers_sync();  // red and rcv read, every store of the tile issued
        if (threadIdx.x == 0) mbar_arrive(pipe.rcv_empty());
      }
      if (!last && threadIdx.x == 0 && !*failed) {
        __threadfence_system();  // the consumers' stores of this hop, then the flag
        kft_ring::st_release(right.flags + (long long)s * mb + b, c.seq);
      }
    }
  }
  __syncthreads();
  if (ring && threadIdx.x == 0 && !*failed) {  // slots read: the left may refill them
    __threadfence_system();
    atomicAdd_system(own.ack, 1ULL);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// B9's views and launch; `own_slots` is the first slot of this rank's
// workspace (unused when c.ws.n == 1).
template <typename OutT>
int launch_ag(const Call& c, int blocks, const void* x, const void* w, void* out, int M, int N,
              int ks, const char* own_slots, cudaStream_t stream) {
  const int n = c.ws.n;
  if (M < 1 || N < 1 || ks < 1 || N % 8 || ks % 8 || !aligned16(x) || !aligned16(w) ||
      !aligned16(out) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const uint64_t K = (uint64_t)n * ks;
  AgMaps maps;
  if (!encode4(&maps.x, true, x, {(uint64_t)ks, (uint64_t)n, (uint64_t)M, 1},
               {(uint64_t)ks * 2, K * 2, K * 2 * M}, {64, 1, Tiling<kAg>::BM, 1}) ||
      !encode4(&maps.w, true, w, {(uint64_t)N, (uint64_t)ks, 1, 1},
               {(uint64_t)N * 2, (uint64_t)N * 2 * ks, (uint64_t)N * 2 * ks}, {64, 64, 1, 1}))
    return (int)cudaErrorInvalidValue;
  if (n > 1) {
    const uint64_t sb = (uint64_t)c.ws.slot_bytes;
    if (!encode4(&maps.slots, true, own_slots, {(uint64_t)N, (uint64_t)ks, (uint64_t)n, 1},
                 {(uint64_t)N * 2, sb, sb * n}, {64, 64, 1, 1}))
      return (int)cudaErrorInvalidValue;
  } else {
    maps.slots = maps.w;
  }
  if (!encode4(&maps.out, true, out, {(uint64_t)N, (uint64_t)M, 1, 1},
               {(uint64_t)N * 2, (uint64_t)N * 2 * M, (uint64_t)N * 2 * M}, {64, 64, 1, 1}))
    return (int)cudaErrorInvalidValue;  // (f32 out: a view the kernel does not use)
  auto kern = ag_matmul_sm90<OutT>;
  static int smem_on = -1;
  const cudaError_t e = allow_smem(kern, Tiling<kAg>::kBytes, &smem_on);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, kThreads, Tiling<kAg>::kBytes, stream>>>(
      c, maps, static_cast<const __nv_bfloat16*>(w), static_cast<OutT*>(out), M, N, ks);
  return (int)cudaGetLastError();
}

// B10's views and launch; `own_slots` as for B9.
template <typename OutT>
int launch_rs(const Call& c, int blocks, const void* x, const void* w, void* out, int mc, int N,
              int K, const char* own_slots, cudaStream_t stream) {
  const int n = c.ws.n;
  if (mc < 1 || N < 1 || K < 1 || N % 8 || K % 8 || !aligned16(x) || !aligned16(w) ||
      !aligned16(out) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  RsMaps maps;
  const uint64_t row = (uint64_t)K * 2;
  if (!encode4(&maps.x, true, x, {(uint64_t)K, (uint64_t)mc, (uint64_t)n, 1},
               {row, row * mc, row * mc * n}, {64, Tiling<kRs>::BM, 1, 1}) ||
      !encode4(&maps.w, true, w, {(uint64_t)N, (uint64_t)K, 1, 1},
               {(uint64_t)N * 2, (uint64_t)N * 2 * K, (uint64_t)N * 2 * K}, {64, 64, 1, 1}))
    return (int)cudaErrorInvalidValue;
  if (n > 1) {
    const uint64_t sb = (uint64_t)c.ws.slot_bytes;
    if (!encode4(&maps.rcv, false, own_slots, {(uint64_t)N, (uint64_t)mc, (uint64_t)n - 1, 1},
                 {(uint64_t)N * 4, sb, sb * (n - 1)},
                 {Tiling<kRs>::BN, Tiling<kRs>::BM, 1, 1}))
      return (int)cudaErrorInvalidValue;
  } else {
    maps.rcv = maps.w;
  }
  auto kern = matmul_rs_sm90<OutT>;
  static int smem_on = -1;
  const cudaError_t e = allow_smem(kern, Tiling<kRs>::kBytes, &smem_on);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, kThreads, Tiling<kRs>::kBytes, stream>>>(c, maps, static_cast<OutT*>(out), mc,
                                                          N, K);
  return (int)cudaGetLastError();
}

}  // namespace kft_mm

// Every function returns a CUDA error code (0 = success).  dtype 0 is f32,
// 2 bf16; x, w and out share it.

// All-gather-matmul: out [M, N] = x [M, n ks] @ the ranks' shards [ks, N]
// stacked by rank; `chunk` = ks * N, whose bytes fit a slot.  f32: w is
// 16-byte aligned.  bf16: x, w and out 16-byte aligned, N and ks multiples
// of 8 (the wrapper pads other shapes).
extern "C" int kft_ag_matmul(const void* x, const void* w, void* out, int M, int N, int ks,
                             int dtype, KFT_RING_PARAMS) {
  kft_ring::Args a = KFT_RING_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kft_ring::kMmFloat32)
    return kft_ring::launch_ag_matmul_f32(a, x, w, out, M, N, ks, s);
  if (dtype != kft_ring::kMmBFloat16 || !kft_ring::args_ok(a) || a.chunk != (long long)ks * N ||
      a.chunk * 2 > a.slot_bytes)
    return (int)cudaErrorInvalidValue;
  const kft_ring::Call c = kft_ring::make_call(a);
  return kft_mm::launch_ag<__nv_bfloat16>(c, a.blocks, x, w, out, M, N, ks,
                                          static_cast<const char*>(a.own) + a.slots, s);
}

// Matmul-reduce-scatter: out [mc, N] = rows [rank mc, (rank+1) mc) of the
// ranks' sum of x [n mc, K] @ w [K, N]; `chunk` = mc * N, whose f32 bytes
// fit a slot.  bf16: x, w and out 16-byte aligned, N and K multiples of 8.
extern "C" int kft_matmul_rs(const void* x, const void* w, void* out, int mc, int N, int K,
                             int dtype, KFT_RING_PARAMS) {
  kft_ring::Args a = KFT_RING_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kft_ring::kMmFloat32)
    return kft_ring::launch_matmul_rs_f32(a, x, w, out, mc, N, K, s);
  if (dtype != kft_ring::kMmBFloat16 || !kft_ring::args_ok(a) || a.chunk != (long long)mc * N ||
      a.chunk * 4 > a.slot_bytes)
    return (int)cudaErrorInvalidValue;
  const kft_ring::Call c = kft_ring::make_call(a);
  return kft_mm::launch_rs<__nv_bfloat16>(c, a.blocks, x, w, out, mc, N, K,
                                          static_cast<const char*>(a.own) + a.slots, s);
}

// The product body alone, no peers: out [M, N] = x [M, K] @ w [K, N], bf16
// operands, f32 (out_dtype 0) or bf16 (2) out, on B9's tiling (0: 128 x 256
// tiles) or B10's (1: 64 x 128, K split between the warpgroups), `blocks`
// blocks.  Aligned as the fused kernels.
extern "C" int kft_mm_product(const void* x, const void* w, void* out, int M, int N, int K,
                              int tiling, int out_dtype, int blocks, void* stream) {
  kft_ring::Call c{};
  c.ws.n = 1;
  c.timeout_ns = 30000000000ull;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = out_dtype == kft_ring::kMmFloat32;
  if (!f32 && out_dtype != kft_ring::kMmBFloat16) return (int)cudaErrorInvalidValue;
  if (tiling == kft_mm::kAg)
    return f32 ? kft_mm::launch_ag<float>(c, blocks, x, w, out, M, N, K, nullptr, s)
               : kft_mm::launch_ag<__nv_bfloat16>(c, blocks, x, w, out, M, N, K, nullptr, s);
  if (tiling == kft_mm::kRs)
    return f32 ? kft_mm::launch_rs<float>(c, blocks, x, w, out, M, N, K, nullptr, s)
               : kft_mm::launch_rs<__nv_bfloat16>(c, blocks, x, w, out, M, N, K, nullptr, s);
  return (int)cudaErrorInvalidValue;
}
