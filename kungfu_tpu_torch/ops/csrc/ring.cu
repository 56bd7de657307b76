// Ring reduce-scatter and all-gather for Hopper (sm_90a), plain and with a
// fused int8/fp8 codec, the one-hop ring shift of ring attention, the CUDA
// IPC calls behind their peer workspace, and the error-feedback residual of
// compressed S-SGD on the same codec.
//
// Replace the TPU kernels kungfu_tpu/ops/ring_kernels.py `make_rs_kernel`
// (launched by pallas_collectives._rs_call), `make_ag_kernel` (by
// _ag_call), `make_fused_rs_kernel` and `make_fused_ag_kernel` (both by
// pallas_collectives.fused_ring_all_reduce), and `make_shift_kernel` (by
// fused_matmul.ring_shift, the K/V rotation of ring attention).  The
// schedule is theirs, hop for hop:
//
//   reduce-scatter  at hop s rank d stores the partial of chunk (d-s-1) mod n
//                   into its right neighbour's receive slot s; for s > 0 that
//                   partial is x[chunk] + the slot s-1 its left neighbour
//                   filled.  After n-1 hops out = x[d] + slot n-2.  Every
//                   element's sum is therefore ((x_{c+1} + x_{c+2}) + ...) +
//                   x_c, the Pallas kernel's association, and each add is one
//                   float add (bf16: of two bf16 values, rounded to nearest
//                   even), so the result is bit-equal to the TPU kernel's.
//   all-gather      at hop s rank d forwards chunk (d-s) mod n, its own first,
//                   into the right neighbour's landing slot s, and copies
//                   every chunk it receives into its output.
//   shift           rank d stores its payload into the slot of rank
//                   (d + shift) mod n and copies what rank (d - shift) mod n
//                   stored into its own slot to its output (`ppermute`).
//
// Remote copies: where the Pallas kernel starts a DMA to device `right`, a
// block here stores the payload through a pointer into the right
// neighbour's workspace (cudaIpcOpenMemHandle; NVLink between cards, plain
// device memory when the ranks share a card), then raises a flag there.
// Flags replace the DMA semaphores: one 64-bit word per (hop, block) holding
// the call's sequence number.  Block b waits only on block b of its left
// neighbour (the same element range), so no grid-wide barrier is needed.
// Order: data stores, __threadfence_system(), a release store of the flag;
// the reader polls with an acquire load and reads the slot through L2.  The
// workspace layout, flags, waits and acknowledgements are in
// ring_common.cuh, which fused_matmul.cu (B9, B10) shares.
//
// Slot reuse across calls: each slot carries one hop of one call, as in the
// Pallas kernel.  Every block that has read its share of its slots adds one
// to the rank's acknowledgement counter of that kind.  Before a block first
// stores into its right neighbour's slots it waits until that counter holds
// every block of the earlier calls of the same kind (`ack_want`, counted by
// the wrapper), so no store lands on bytes the neighbour has not read yet,
// however the grid and the chunk changed from call to call.  Inside
// ring_all_reduce this wait never spins (the neighbour finished its
// reduce-scatter before this rank could finish the all-gather that precedes
// the next reduce-scatter); it is what keeps back-to-back standalone calls
// safe.
//
// Every wait is bounded by %globaltimer.  On expiry the block records the
// kind, hop, block and sequence number in host-mapped memory and exits; the
// other blocks and every later launch see the claim word and exit too, and
// the Python wrapper raises.  A stuck peer is an error, not a hang.
//
// Residency: a block spins on its left neighbour's block, so the grid is at
// most one block per SM of the card (`max_blocks`), each block striding over
// its share of the chunk.  On one shared card the ranks' kernels run in turn
// (time-slicing); progress needs no two of them resident together.
//
// The fused-codec kernels keep that schedule and change the payload: one
// hop carries int8 (or fp8 e4m3) codes plus one f32 scale per block of
// `block` values (256 by default), in slots of their own.
//
//   fused reduce-scatter  hop 0 sends quantize(x[chunk]); hop s > 0 sends
//                   quantize(x[chunk] + codes * scales of slot s-1); the
//                   result is x[d] + codes * scales of slot n-2, in f32.
//   fused all-gather      quantizes this rank's reduced chunk once, forwards
//                   codes and scales unchanged hop by hop, and decodes every
//                   chunk into the f32 output.
//
// Both run their hops as a wavefront of stages, each stage's codes and
// scales one record in a slot, with a flag that counts the stages landed
// (their sections below): the fused reduce-scatter sends a record by one
// bulk copy, the fused all-gather by its threads' stores.
//
// One warp quantizes 256 values at a time (8 a lane, 8 bytes of codes a
// lane), the absmax of a block taken with __shfl_xor_sync across its lanes;
// a CUDA block owns whole quantization blocks, so its flag covers whole
// scales.  The arithmetic is the reference's as XLA compiles it, which the
// plain version (ops/collective.py) repeats bit for bit: scale = absmax *
// (1/codemax rounded to f32), or 1 for an all-zero block; int8 codes are
// rintf(v / scale) (IEEE division, round half to even) clamped to +-127;
// fp8 codes are v / scale clamped to +-448 and converted with round to
// nearest even; x + code * scale is one fused multiply-add (__fmaf_rn; XLA
// contracts the reference's multiply and add the same way), and no other
// product or sum is left for the compiler to contract.
//
// What bounds them: bytes.  Between cards each rank sends (n-1) chunks per
// kernel over NVLink (450 GB/s each way), a quarter of them (plus scales)
// for the fused kernels; on one card all ranks' reads and writes share its
// 3.35 TB/s.  The kernels move 16 bytes per thread per access (8 bytes of
// codes) and keep four accesses in flight in the plain kernels.  At the
// data-parallel step's payload (a 367.6M-value f32 bucket on 4 cards) B5
// and B6 run at 73% of their NVLink bound, level with NCCL.  Still open:
// a hop's stores do not overlap the next hop's wait, and a block waits on
// its left neighbour's block of the same hop, so one slow rank holds the
// ring.
//
// Segment tables (B5, B6).  Under FSDP every parameter was its own call:
// 195 launches of each kernel a step for the flagship, at chunks of 1 KB
// to 32.8 MB a rank, about 12.6 us of bound apiece, and each paid the
// same fixed costs: the host's issue (autograd, the wrapper, a ctypes
// call), the skew until the left neighbour's host issued the same call
// (the first flag wait), and a chain of n-1 dependent hops, each a remote
// store, a system fence and a flag round trip.  So a launch now carries a
// table of up to kMaxSegs segments, passed by value as a kernel parameter
// (no copy to the card, no sync): each names its input and output tensors
// in place and its row, and is carried as whole 16-byte vectors at its
// offset in one concatenated chunk.  The ring, its slots, flags,
// acknowledgements and bounded waits see only that chunk: `block_range`
// cuts it across the grid as before, and a block walks the segments that
// meet its range (an outer loop over segments, not a search per vector).
// A single tensor is a table of one.  Every element's sums are still
// taken in the ring's order for its chunk, one f32 or bf16 add each, so a
// grouped call is bit-equal to a call per tensor; FSDPTrainer makes one
// launch per bucket of consecutive parameters that fits a slot.
//
// The shift moves its payload as bytes (16-byte vectors, then a scalar
// tail), so any dtype and any size goes through it: the Pallas kernel's
// fallback to `ppermute` (past the VMEM budget, other dtypes) has no
// counterpart.  One call carries K and V of a ring-attention hop back to
// back in the shift's slot, so a hop is one launch, and the two tensors
// cannot be exchanged by two ranks issuing them in different orders.  It is
// bound by bytes: between cards the payload crosses NVLink once (450 GB/s
// each way), on one card every rank reads and writes it twice (its slot in
// between).  Ring attention runs it on a side stream under its flash
// blocks, so it moves its bytes with the copy engine from a small grid, in
// stages whose copy-out overlaps the incoming stores (the shift section).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ring_common.cuh"

namespace kft_ring {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kSeg = 256;  // values a warp quantizes at a time: 32 lanes x 8
constexpr int kMaxSegs = 32;  // segments in one launch of B5/B6 (ops/ring_collectives.py)
constexpr int kSegWords = 5;  // a segment's entry on the host: x, x_size, out, out_size, row
enum DType { kFloat32 = 0, kBFloat16 = 2 };
enum Scheme { kInt8 = 0, kFp8 = 1 };

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static constexpr int kVec = 4;
  __device__ static uint4 add(uint4 a, uint4 b) {
    uint4 r;
    r.x = __float_as_uint(__uint_as_float(a.x) + __uint_as_float(b.x));
    r.y = __float_as_uint(__uint_as_float(a.y) + __uint_as_float(b.y));
    r.z = __float_as_uint(__uint_as_float(a.z) + __uint_as_float(b.z));
    r.w = __float_as_uint(__uint_as_float(a.w) + __uint_as_float(b.w));
    return r;
  }
};

template <>
struct Ops<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static unsigned add2(unsigned a, unsigned b) {
    __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
    __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
    float2 fx = __bfloat1622float2(x), fy = __bfloat1622float2(y);
    __nv_bfloat162 r = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);
    return *reinterpret_cast<unsigned*>(&r);
  }
  __device__ static uint4 add(uint4 a, uint4 b) {
    return make_uint4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z), add2(a.w, b.w));
  }
};

// A view of n chunks of `row` values: element j of chunk c lives at
// base[c * row + j] when j < row and c * row + j < size; elsewhere it reads
// as zero and is not written.  `vec_ok`: row and base allow 16-byte
// accesses.
template <typename T>
struct View {
  T* base;
  long long row, size;
  int vec_ok;

  __device__ uint4 load(int c, long long v) const {
    constexpr int V = Ops<T>::kVec;
    long long j = v * V, i = (long long)c * row + j;
    if (vec_ok && j + V <= row && i + V <= size)
      return *reinterpret_cast<const uint4*>(base + i);
    uint4 r = make_uint4(0, 0, 0, 0);
    T* e = reinterpret_cast<T*>(&r);
    for (int k = 0; k < V; ++k)
      if (j + k < row && i + k < size) e[k] = base[i + k];
    return r;
  }

  __device__ void store(int c, long long v, uint4 val) const {
    constexpr int V = Ops<T>::kVec;
    long long j = v * V, i = (long long)c * row + j;
    if (vec_ok && j + V <= row && i + V <= size) {
      *reinterpret_cast<uint4*>(base + i) = val;
      return;
    }
    const T* e = reinterpret_cast<const T*>(&val);
    for (int k = 0; k < V; ++k)
      if (j + k < row && i + k < size) base[i + k] = e[k];
  }
};

// One segment of a call: a tensor's `row` values a chunk, read through x
// and written through out, carried as vectors [vec0, vec1) of the call's
// concatenated chunk (every segment starts on a whole 16-byte vector).
template <typename T>
struct Seg {
  View<T> x, out;
  long long vec0, vec1;
};

// The segment table of one launch, passed by value (3 KB of the kernel's
// 4 KB of parameters at kMaxSegs = 32).
template <typename T>
struct Table {
  Seg<T> seg[kMaxSegs];
  int count;
};
static_assert(sizeof(Call) + sizeof(Table<float>) <= 4096,
              "a launch's parameters must fit 4 KB");

// The ring over a table: block b owns vectors [v0, v1) of the
// concatenated chunk (`block_range`), and at every hop walks the segments
// that intersect them, calling f(segment, global vector w, its vector in
// the segment) for each of its vectors, kUnroll loads in flight a thread.
template <typename T, typename F>
__device__ __forceinline__ void for_each_vec(const Table<T>& t, long long v0, long long v1,
                                             F f) {
  for (int i = 0; i < t.count; ++i) {
    const Seg<T>& g = t.seg[i];
    const long long lo = max(v0, g.vec0), hi = min(v1, g.vec1);
    for (long long v = lo + threadIdx.x; v < hi; v += kUnroll * kThreads) f(g, v, hi);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_rs_kernel(Call c, const __grid_constant__ Table<T> t) {
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks, b = blockIdx.x;
  const Layout own = layout(c.ws, c.ws.own, kRs), right = layout(c.ws, c.ws.right, kRs);
  long long v0, v1;
  block_range(t.seg[t.count - 1].vec1, &v0, &v1);
  // the right neighbour has read what the earlier calls sent it
  if (!block_wait(c, right.ack, c.ack_want, own.claim, err_ack(kRs), 0)) return;
  for (int s = 0; s < n - 1; ++s) {
    const int chunk = ((d - s - 1) % n + n) % n;
    const uint4* recv = s > 0 ? reinterpret_cast<const uint4*>(slot(own, s - 1)) : nullptr;
    if (s > 0 && !block_wait(c, own.flags + (long long)(s - 1) * mb + b, c.seq, own.claim,
                             err_data(kRs), s - 1))
      return;
    uint4* send = reinterpret_cast<uint4*>(slot(right, s));
    for_each_vec(t, v0, v1, [&](const Seg<T>& g, long long v, long long hi) {
      uint4 a[kUnroll], r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        long long w = v + u * kThreads;
        if (w < hi) {
          a[u] = g.x.load(chunk, w - g.vec0);
          if (recv) r[u] = __ldcg(recv + w);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        long long w = v + u * kThreads;
        if (w < hi) send[w] = recv ? Ops<T>::add(a[u], r[u]) : a[u];
      }
    });
    block_signal(right.flags + (long long)s * mb + b, c.seq);
  }
  if (!block_wait(c, own.flags + (long long)(n - 2) * mb + b, c.seq, own.claim, err_data(kRs),
                  n - 2))
    return;
  const uint4* recv = reinterpret_cast<const uint4*>(slot(own, n - 2));
  for_each_vec(t, v0, v1, [&](const Seg<T>& g, long long v, long long hi) {
    uint4 a[kUnroll], r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long w = v + u * kThreads;
      if (w < hi) {
        a[u] = g.x.load(d, w - g.vec0);
        r[u] = __ldcg(recv + w);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long w = v + u * kThreads;
      if (w < hi) g.out.store(0, w - g.vec0, Ops<T>::add(a[u], r[u]));
    }
  });
  block_ack(own.ack);  // slots read: the left may refill them
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_ag_kernel(Call c, const __grid_constant__ Table<T> t) {
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks, b = blockIdx.x;
  const Layout own = layout(c.ws, c.ws.own, kAg), right = layout(c.ws, c.ws.right, kAg);
  long long v0, v1;
  block_range(t.seg[t.count - 1].vec1, &v0, &v1);
  if (!block_wait(c, right.ack, c.ack_want, own.claim, err_ack(kAg), 0)) return;
  // hop 0: this rank's chunk, to its own output and to the right
  uint4* send = reinterpret_cast<uint4*>(slot(right, 0));
  for_each_vec(t, v0, v1, [&](const Seg<T>& g, long long v, long long hi) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long w = v + u * kThreads;
      if (w < hi) {
        uint4 a = g.x.load(0, w - g.vec0);
        g.out.store(d, w - g.vec0, a);
        send[w] = a;
      }
    }
  });
  block_signal(right.flags + b, c.seq);
  // hop s: chunk (d-s) mod n arrived in slot s-1; keep it, forward it
  for (int s = 1; s < n; ++s) {
    const int chunk = ((d - s) % n + n) % n;
    if (!block_wait(c, own.flags + (long long)(s - 1) * mb + b, c.seq, own.claim,
                    err_data(kAg), s - 1))
      return;
    const uint4* recv = reinterpret_cast<const uint4*>(slot(own, s - 1));
    uint4* fwd = s < n - 1 ? reinterpret_cast<uint4*>(slot(right, s)) : nullptr;
    for_each_vec(t, v0, v1, [&](const Seg<T>& g, long long v, long long hi) {
      uint4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        long long w = v + u * kThreads;
        if (w < hi) r[u] = __ldcg(recv + w);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        long long w = v + u * kThreads;
        if (w < hi) {
          g.out.store(chunk, w - g.vec0, r[u]);
          if (fwd) fwd[w] = r[u];
        }
      }
    });
    if (fwd) block_signal(right.flags + (long long)s * mb + b, c.seq);
  }
  block_ack(own.ack);
}

// ------------------------------------------------------ bulk copies ----
// The copy engine's asynchronous bulk copies (cp.async.bulk) between global
// and shared memory, completing on shared-memory barriers (mbarrier) or as
// bulk groups of the issuing thread: the shift (B11) and the fused
// reduce-scatter (B7) move their bytes with them.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
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

// A local copy completes within microseconds; one that does not (a fault)
// traps, failing the launch, instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity, u64 limit_ns) {
  if (mbar_try_wait(bar, parity)) return;
  const u64 deadline = globaltimer() + limit_ns;
  while (!mbar_try_wait(bar, parity))
    if (globaltimer() > deadline) __trap();
}

// `bytes` (a multiple of 16) from global `src` into shared `dst`,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` from shared `src` to global `dst` (a peer's slot or an output),
// as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// At most N of this thread's bulk groups still pending: complete, or
// (kRead) done reading shared memory.
template <int N, bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Between the copy engine's accesses and this thread's ordinary ones
// (both directions, global memory).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The stores of this block's stages so far are complete in the peer's
// slot (wait_group): count them.  The proxy fence orders the copy engine's
// writes before this thread's release of the flag.
__device__ __forceinline__ void count_stages(u64* flag, u64 value) {
  fence_proxy_async();
  st_release(flag, value);
}

// A flag that counts stages holds (call << kStageBits) + the stages that
// landed (the shift's and the fused reduce-scatter's).
constexpr int kStageBits = 20;

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// ------------------------------------------------------- fused codec ----

struct Codec {
  int scheme;   // kInt8 or kFp8
  int block;    // values per scale: a multiple of 8 that divides 256
  float recip;  // 1 / codemax rounded to f32 (127 or 448)
};

__device__ __forceinline__ float decode(unsigned code, int scheme) {
  if (scheme == kInt8) return (float)(signed char)(code & 0xffu);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)code, __NV_E4M3)));
}

__device__ __forceinline__ unsigned encode(float y, int scheme) {
  if (scheme == kInt8) return (unsigned)(unsigned char)(signed char)fminf(fmaxf(rintf(y), -127.f), 127.f);
  return (unsigned)__nv_cvt_float_to_fp8(fminf(fmaxf(y, -448.f), 448.f), __NV_SATFINITE, __NV_E4M3);
}

// One lane's 8 values of a warp's 256 (lane l holds values 8l..8l+7).
// Quantize them: the block's absmax over its block/8 lanes, its scale,
// 8 codes packed little-endian into a uint2.
__device__ __forceinline__ uint2 quantize8(const Codec& q, const float v[8], float* scale) {
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(v[k]));
  for (int o = q.block / 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float s = m > 0.f ? __fmul_rn(m, q.recip) : 1.f;
  unsigned w[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k / 4] |= encode(__fdiv_rn(v[k], s), q.scheme) << (8 * (k % 4));
  *scale = s;
  return make_uint2(w[0], w[1]);
}

// v[k] += code[k] * scale, each one fused multiply-add.
__device__ __forceinline__ void add_decoded(const Codec& q, uint2 codes, float scale,
                                            float v[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned word = k < 4 ? codes.x : codes.y;
    v[k] = __fmaf_rn(decode(word >> (8 * (k % 4)), q.scheme), scale, v[k]);
  }
}

// v[k] -= code[k] * scale, each one fused multiply-add.
__device__ __forceinline__ void sub_decoded(const Codec& q, uint2 codes, float scale,
                                            float v[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned word = k < 4 ? codes.x : codes.y;
    v[k] = __fmaf_rn(-decode(word >> (8 * (k % 4)), q.scheme), scale, v[k]);
  }
}

// f32 values at base[i ... i+8), those at or past `size` reading as zero.
__device__ __forceinline__ void load8(const float* base, long long i, long long size,
                                      float v[8]) {
  if (i + 8 <= size && (reinterpret_cast<uintptr_t>(base + i) & 15) == 0) {
    const float4 a = *reinterpret_cast<const float4*>(base + i);
    const float4 b = *reinterpret_cast<const float4*>(base + i + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
    v[7] = b.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = i + k < size ? base[i + k] : 0.f;
}

__device__ __forceinline__ void store8(float* base, long long i, long long size,
                                       const float v[8]) {
  if (i + 8 <= size && (reinterpret_cast<uintptr_t>(base + i) & 15) == 0) {
    *reinterpret_cast<float4*>(base + i) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(base + i + 4) = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (i + k < size) base[i + k] = v[k];
}

// ------------------------------------------- fused reduce-scatter (B7) ----
// A stage-pipelined ring.  The chunk is cut into stages of kFStageVals
// values (32 segments of 256); block b owns a range of whole stages
// (`block_range`), and its peer's block b the same range.  Stage t of a
// hop travels as one record at t * (kFStageVals + its scales' bytes) in
// the hop's slot: the stage's codes, then its scales, so one bulk copy
// carries both (the last stage's record is shorter; a slot is still codes
// plus scales of the chunk, as the workspace reserves it).
//
// A block runs n steps a stage in turn, hop 0 over all its stages, then
// hop 1, ..., then the final pass, with one producer lane and 16 consumer
// warps:
//
//   producer   warp 16, lane 0: from hop 1 on, the record of hop s - 1 out
//              of this rank's slot into a ring of kFInBufs buffers by one
//              bulk copy, once the left neighbour's flag counts that stage
//   consumers  warps 0-15: x's stage (chunk ci of the payload) into a ring
//              of kFXBufs buffers by their own 16-byte cp.async, two stages
//              ahead; then a warp a segment at a time: x + the decoded
//              record (one FMA a value), quantized into a record in one of
//              kFOutBufs shared buffers; thread 0 sends the record to the
//              right neighbour's slot as one bulk copy and, every kFCount
//              stages (with kFCountLag stores still in flight) and at the
//              end of the hop, once those stores are complete, a proxy
//              fence and a release raise the block's flag of the hop to
//              count them: (call << kStageBits) + stages landed
//   final      x's own chunk + the decoded record of hop n - 2, in f32,
//              stored to the output by the consumers
//
// So the right rank's hop s + 1 on stage k starts as soon as stage k of
// hop s has landed, a hop's loads and codec overlap the previous stages'
// transfers, and the final pass overlaps the stores still crossing: the
// hops become a wavefront instead of n - 1 walls.  Slots stay one per hop,
// so no stage waits for a reader (no back-pressure), which keeps ranks that
// time-slice one card progressing.  The arithmetic of every value is the
// old kernel's: x + code * scale as one __fmaf_rn, the absmax over its
// block by shuffles, the scale as absmax * recip, the code as
// rintf(__fdiv_rn(v, s)) clamped; only the schedule changed, so the result
// is bit-equal to the plain version.
//
// What bounds it: bytes.  Between cards a rank sends (n - 1) chunks of
// codes and scales over NVLink and reads its payload's n chunks and the
// n - 1 received slots from device memory; the old kernel ran the hops and
// the final pass strictly one after another (a flag per (hop, block)),
// each lane storing 8 bytes to the peer with one load in flight.  x, four
// bytes a value, comes by the threads' cp.async and not by bulk copies:
// with x as a 32 KB bulk copy a stage as well (4 x H100 80GB HBM3 at
// 700 W) a block moved about 14 GB/s of bulk copies, 3.5 us a stage
// whatever the grid and however many stores were in flight (1.29 ms at 132
// blocks and 9.05 ms at 16 for the 342.4M-value payload), about the rate
// B11's blocks reach.
//
// Acknowledgements: thread 0 waits for the right neighbour's (every block
// of the earlier calls) before its first store into that neighbour's
// slots, so a call never overwrites a slot the neighbour's previous call
// still reads, whatever the sizes and grids of the two calls.
//
// Failure: every flag wait is the producer's and the acknowledgement wait
// thread 0's, bounded as every ring wait.  A producer that gives up raises
// `failed` in shared memory; the consumers leave together at the next step
// (a barrier that reduces their view of it and of thread 0's wait), and
// raise `failed` themselves, which stops the producer at its next wait for
// a free buffer.  The producer drains its loads, thread 0 its stores and
// every consumer its cp.async copies before the block ends.
constexpr int kFStageVals = 8192;  // values of a stage: 32 segments
constexpr int kFConsumers = 512;   // 16 warps
constexpr int kFThreads = kFConsumers + 32;  // and the producer's warp
constexpr int kFXBufs = 3;         // x stages in shared memory: two loading, one read
constexpr int kFInBufs = 3;        // received records
constexpr int kFOutBufs = 7;       // records on their way out: up to 6 stores in flight
constexpr int kFCount = 8;         // stages a count of the flag covers (64 KB of codes)
constexpr int kFCountLag = 5;      // stores left in flight while a count is raised
constexpr int kFRecMax = kFStageVals + kFStageVals / 8 * 4;  // a record at block 8
constexpr int kFSmem = kFXBufs * kFStageVals * 4 + (kFInBufs + kFOutBufs) * kFRecMax;
constexpr int kFXCopies = kFStageVals / 4 / kFConsumers;  // 16-byte copies a thread a stage
static_assert(kFStageVals % 1024 == 0, "stages of whole 1024-value tiles");
static_assert(kFStageVals % (4 * kFConsumers) == 0, "whole copies a thread");
static_assert(kFCountLag < kFOutBufs, "a count waits for stores older than the pending reads");
static_assert(kFSmem <= 232448 - 1024, "shared memory of one block, its barriers beside it");

// The consumers' barrier (named barrier 1), and its form that returns
// whether any of them passed `p`.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kFConsumers) : "memory");
}

__device__ __forceinline__ bool consumers_any(bool p) {
  int r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.s32 p, %1, 0;\nbar.red.or.pred q, 1, %2, p;\n"
      "selp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((int)p), "n"(kFConsumers)
      : "memory");
  return r != 0;
}

// 16 bytes from global `src` to shared `dst`, of which the first `bytes`
// (0 to 16) are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// At most N of this thread's cp.async groups still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A consumer's wait for a record: true when it landed, false once the
// producer has given up (it issues nothing more).
__device__ __forceinline__ bool wait_load(uint32_t bar, int parity, volatile int* failed) {
  while (!mbar_try_wait(bar, parity))
    if (*failed) return false;
  return true;
}

// A block's steps in order, hop s (s = n - 1: the final pass) and local
// stage k, without a division a step.
struct FCursor {
  int s = 0, k = 0;
  __device__ void next(int T) {
    if (++k == T) k = 0, ++s;
  }
};

// Stage t of a fused chunk (B7 and B8): its values, and its record (the
// stage's codes, then its scales) in a slot.
struct FStage {
  long long v0;    // first value of the stage in the chunk
  int nv;          // values of the stage (a multiple of 1024)
  long long rec;   // byte offset of the stage's record in a slot
  int rec_bytes;   // bytes of its record
};

__device__ __forceinline__ FStage fstage(long long t, long long chunk, int block) {
  FStage f;
  f.v0 = t * kFStageVals;
  f.nv = (int)min((long long)kFStageVals, chunk - f.v0);
  f.rec = t * (kFStageVals + kFStageVals / block * 4);
  f.rec_bytes = f.nv + f.nv / block * 4;
  return f;
}

// Step (s, k) of a B7 block whose first stage is t0: where its stage lies.
struct FStep : FStage {
  long long xoff;  // the stage's first value in x
  int valid;       // values of the stage below x_size
};

__device__ __forceinline__ FStep fstep(int s, int k, long long t0, int n, int d, long long chunk,
                                       long long x_size, int block) {
  FStep f;
  static_cast<FStage&>(f) = fstage(t0 + k, chunk, block);
  const int ci = s < n - 1 ? (d - s - 1 + n) % n : d;
  f.xoff = (long long)ci * chunk + f.v0;
  f.valid = (int)max(0LL, min((long long)f.nv, x_size - f.xoff));
  return f;
}

// Warp 16, lane 0: the block's record loads, hop by hop.  Returns false
// when a wait gave up or the consumers left; then no load of it is left in
// flight.
__device__ bool frs_produce(const Call& c, int block, long long chunk, int T, long long t0,
                            const Layout& own, uint32_t inbufs, uint32_t bars,
                            volatile int* failed) {
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks;
  const uint32_t in_full = bars, in_empty = bars + 8 * kFInBufs;
  const u64 base = c.seq << kStageBits;
  int j = 0;  // record loads issued
  bool ok = true;
  for (int s = 1; ok && s < n; ++s) {
    const u64* flag = own.flags + (long long)(s - 1) * mb + blockIdx.x;
    u64 landed = 0;  // stages of hop s - 1 the flag has counted
    for (int k = 0; k < T; ++k, ++j) {
      if (landed < (u64)k + 1) {
        u64 v = ld_acquire(flag);
        if (v < base + k + 1) {
          if (!thread_wait(c, flag, base + k + 1, own.claim, err_data(kFusedRs), s - 1)) {
            ok = false;
            break;
          }
          v = ld_acquire(flag);
        }
        landed = v - base;
        fence_proxy_async();  // the left's stores, acquired, before the copy engine reads them
      }
      // the consumers are done with the buffer's last record (or have left)
      if (j >= kFInBufs && !wait_load(in_empty + 8 * (j % kFInBufs), (j / kFInBufs - 1) & 1,
                                      failed)) {
        ok = false;
        break;
      }
      const FStep f = fstep(s, k, t0, n, d, chunk, 0, block);
      bulk_load(inbufs + (j % kFInBufs) * kFRecMax, slot(own, s - 1) + f.rec, f.rec_bytes,
                in_full + 8 * (j % kFInBufs));
    }
  }
  // drain (a no-op when the consumers read every record): the last load
  // issued into each buffer lands
  for (int m = max(0, j - kFInBufs); m < j; ++m)
    mbar_wait(in_full + 8 * (m % kFInBufs), (m / kFInBufs) & 1, c.timeout_ns);
  return ok;
}

// A consumer's share of step (s, k)'s x stage into shared buffer `buf`,
// zero past x_size, as one cp.async group.
__device__ __forceinline__ void frs_load_x(const FStep& f, const float* x, uint32_t buf) {
#pragma unroll
  for (int u = 0; u < kFXCopies; ++u) {
    const int e = 4 * (threadIdx.x + u * kFConsumers);  // the copy's first value
    if (e < f.nv) {
      const int bytes = 4 * max(0, min(4, f.valid - e));
      cp_async16(buf + 4 * e, bytes ? x + f.xoff + e : x, bytes);
    }
  }
  cp_async_commit();
}

// Warps 0-15: x's loads and every step's codec, thread 0 sending the
// records and counting them in the right neighbour's flag of the hop.
__device__ void frs_consume(const Call& c, const Codec& q, const float* x, long long x_size,
                            float* out, long long chunk, int T, long long t0,
                            const Layout& own, const Layout& right, unsigned char* smem,
                            uint32_t bars, volatile int* failed) {
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t in_full = bars, in_empty = bars + 8 * kFInBufs;
  const unsigned char* xbufs = smem;
  const unsigned char* inbufs = smem + kFXBufs * kFStageVals * 4;
  unsigned char* outbufs = smem + kFXBufs * kFStageVals * 4 + kFInBufs * kFRecMax;
  const uint32_t xaddr = smem_addr(xbufs);
  const u64 base = c.seq << kStageBits;
  const int steps = n * T;
  FCursor cur, ahead;  // this step, and the step whose x loads next
  for (int m = 0; m < kFXBufs - 1; ++m, ahead.next(T)) {
    if (m < steps)
      frs_load_x(fstep(ahead.s, ahead.k, t0, n, d, chunk, x_size, q.block), x,
                 xaddr + m * kFStageVals * 4);
    else
      cp_async_commit();
  }
  // thread 0 stores into the right neighbour's slots only once it has read
  // what the earlier calls sent it (every block of them acknowledged)
  bool acked = threadIdx.x != 0 || steps == 0 ||
               thread_wait(c, right.ack, c.ack_want, own.claim, err_ack(kFusedRs), 0);
  if (threadIdx.x == 0 && acked) fence_proxy_async();  // before the copy engine's stores
  for (int i = 0; i < steps; ++i, cur.next(T), ahead.next(T)) {
    // x of step i + 2 into the buffer step i - 1 read (every consumer passed
    // that step's last barrier)
    const int ia = i + kFXBufs - 1;
    if (ia < steps)
      frs_load_x(fstep(ahead.s, ahead.k, t0, n, d, chunk, x_size, q.block), x,
                 xaddr + (ia % kFXBufs) * kFStageVals * 4);
    else
      cp_async_commit();
    cp_async_wait<kFXBufs - 1>();  // this thread's share of step i's x landed
    const FStep f = fstep(cur.s, cur.k, t0, n, d, chunk, x_size, q.block);
    const int j = i - T;  // its record load, from hop 1 on
    const bool send = cur.s < n - 1;
    const bool ok = cur.s == 0 || wait_load(in_full + 8 * (j % kFInBufs), (j / kFInBufs) & 1,
                                            failed);
    if (threadIdx.x == 0 && send) bulk_wait<kFOutBufs - 1, true>();  // its out buffer is free
    if (consumers_any(!ok || !acked)) {  // also: every consumer's share of x landed
      if (threadIdx.x == 0) *failed = 1;  // the producer stops too
      break;
    }
    const float* xs = reinterpret_cast<const float*>(xbufs + (i % kFXBufs) * kFStageVals * 4);
    const unsigned char* in = inbufs + (j >= 0 ? j % kFInBufs : 0) * kFRecMax;
    unsigned char* rec = outbufs + (i % kFOutBufs) * kFRecMax;
    for (int g = warp; g < f.nv / kSeg; g += kFConsumers / 32) {
      const int e = g * kSeg + lane * 8;  // this lane's first value in the stage
      const float4 a = *reinterpret_cast<const float4*>(xs + e);
      const float4 b = *reinterpret_cast<const float4*>(xs + e + 4);
      float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      if (cur.s > 0)
        add_decoded(q, *reinterpret_cast<const uint2*>(in + e),
                    *reinterpret_cast<const float*>(in + f.nv + e / q.block * 4), v);
      if (send) {
        float scale;
        *reinterpret_cast<uint2*>(rec + e) = quantize8(q, v, &scale);
        if (lane % (q.block / 8) == 0) *reinterpret_cast<float*>(rec + f.nv + e / q.block * 4) = scale;
      } else {
        store8(out, f.v0 + e, chunk, v);
      }
    }
    if (send) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();  // x and the record read, the out record written
    if (threadIdx.x == 0) {
      if (cur.s > 0) mbar_arrive(in_empty + 8 * (j % kFInBufs));
      if (send) {
        bulk_store(slot(right, cur.s) + f.rec, smem_addr(rec), f.rec_bytes);
        u64* flag = right.flags + (long long)cur.s * mb + blockIdx.x;
        const int lag = cur.k - kFCountLag;  // complete once kFCountLag newer are pending
        if (cur.k == T - 1) {
          bulk_wait<0, false>();
          count_stages(flag, base + (u64)T);
        } else if (lag >= 0 && (lag + 1) % kFCount == 0) {
          bulk_wait<kFCountLag, false>();
          count_stages(flag, base + (u64)(lag + 1));
        }
      }
    }
  }
  cp_async_wait<0>();  // a block that gave up drains its copies
  if (threadIdx.x == 0) bulk_wait<0, false>();
}

// x: the f32 flat payload, chunk c at x[c * chunk + j], zero past x_size
// (16-byte aligned); out: this rank's reduced chunk, `chunk` f32 values.
__global__ void __launch_bounds__(kFThreads, 1)
    ring_fused_rs_kernel(Call c, Codec q, const float* __restrict__ x, long long x_size,
                         float* __restrict__ out, long long chunk) {
  extern __shared__ __align__(128) unsigned char frs_smem[];
  __shared__ __align__(8) u64 bars[2 * kFInBufs];
  __shared__ int failed;
  const Layout own = layout(c.ws, c.ws.own, kFusedRs);
  const Layout right = layout(c.ws, c.ws.right, kFusedRs);
  long long t0, t1;
  block_range((chunk + kFStageVals - 1) / kFStageVals, &t0, &t1);  // this block's stages
  const int T = (int)(t1 - t0);
  const uint32_t bar0 = smem_addr(bars);
  if (threadIdx.x == 0) {
    failed = 0;
    for (int i = 0; i < 2 * kFInBufs; ++i) mbar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < kFConsumers) {
    frs_consume(c, q, x, x_size, out, chunk, T, t0, own, right, frs_smem, bar0, &failed);
  } else if (threadIdx.x == kFConsumers) {
    if (!frs_produce(c, q.block, chunk, T, t0, own,
                     smem_addr(frs_smem) + kFXBufs * kFStageVals * 4, bar0, &failed))
      failed = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0 && !failed) {  // slots read: the left may refill them
    fence_proxy_async();
    __threadfence_system();
    atomicAdd_system(own.ack, 1ULL);
  }
}

// ---------------------------------------------- fused all-gather (B8) ----
// A stage wavefront like B7's, each received record decoded and forwarded
// by the threads that read it.  The chunk is cut into stages of
// kFStageVals values, block b owns a range of whole stages (`block_range`)
// and its peer's block b the same range, and stage t of a hop travels as
// one record at t * (kFStageVals + its scales' bytes) in the hop's slot:
// the stage's codes, then its scales (`fstage`, as B7 lays them out).  The
// flag of (hop s, block b) counts the stages of the block that landed:
// (call << kStageBits) + count.  A block runs its steps in order, hop 0
// over its stages, then hop 1, ..., on 16 worker warps and a signal warp:
//
//   hop 0      this rank's chunk x comes by the workers' own 16-byte
//              cp.async, two stages ahead, into a ring of kAgXBufs shared
//              buffers, each thread copying just the values it reads (no
//              barrier); a warp quantizes a 256-value segment at a time
//              (quantize8: lane l holds values 8l..8l+7), stores the codes
//              and scales into the right neighbour's slot 0, and the
//              decoded values into its own chunk of the output as two
//              stores of 512 contiguous bytes (codes and scales exchanged
//              by shuffles)
//   hop s > 0  once the left neighbour's count covers a group of kAgCount
//              stages (lane 0 of each warp polls it; no barrier), each
//              thread loads its 16 values of every stage of the group:
//              warp w takes values [512w, 512w + 512) of a stage, lane l
//              the 4 at 512w + 128m + 4l (m < 4), one 4-byte load of codes
//              and one of their scale each, so every access of the warp
//              covers contiguous bytes and 32 loads are in flight a
//              thread; it stores the same registers on into the right
//              neighbour's slot s (s < n - 1) and decodes them into output
//              chunk (d - s) mod n, a 16-byte store each
//   signal     warp 16: after every group of kAgCount stages of a hop that
//              sends, a barrier with the workers (named barrier 1), then a
//              system fence and a release of the count into the right
//              neighbour's flag of the hop; the workers go on meanwhile
//
// So the right rank's hop s + 1 on a group starts as soon as that group of
// hop s has landed: the hops become a wavefront, not n - 1 walls.  Records
// are read with __ldcg (through L2, not L1) within microseconds of their
// landing, and the f32 output is written with streaming stores, so it does
// not push the slots out of the 50 MB L2 before they are read.  Slots stay
// one per hop (no back-pressure), which keeps ranks that time-slice one
// card progressing.
//
// What bounds it: bytes.  Between cards each rank sends (n - 1) chunks of
// codes and scales over NVLink (450 GB/s each way); its card writes the n
// f32 chunks of the output and reads its own chunk once, and the records
// land in its memory and are read back.  Hence the counted flags (a flag a
// (hop, block) that only says "done" would start block b's hop only once
// the left rank's block b finished its whole share of the hop before: n - 1
// walls), many loads in flight a thread, and output stores that each cover
// a warp's 512 contiguous bytes: the f32 output is four fifths of the
// bytes, and a lane storing its 16 values in turn (16 bytes in every 64 a
// store) made the kernel 16-18% slower on 4 x H100 80GB HBM3 (PERF.md).
//
// The arithmetic: the absmax of a block by shuffles, scale = absmax *
// recip, the code rintf(__fdiv_rn(v, s)) clamped, the decoded value one
// __fmul_rn; so the result is bit-equal to the plain version.
//
// Acknowledgements: every thread passes the block's wait for the right
// neighbour's acknowledgement (every block of the earlier calls) before
// its first store into that neighbour's slots.  A count covers only
// retired stores: its barrier follows every worker's stores of the group,
// and the signal warp's system fence orders them before the release.
//
// Failure: every flag wait is bounded.  A warp that gave up raises
// `failed` in shared memory and skips its loads and stores from then on,
// but meets every barrier; the signal warp raises no count once `failed`
// is up, and the block does not acknowledge its slots.
constexpr int kAgWorkers = 512;              // 16 warps: the codec and every store
constexpr int kAgThreads = kAgWorkers + 32;  // and the signal warp
constexpr int kAgXBufs = 3;                  // x stages in shared memory: two loading, one read
constexpr int kAgCount = 4;                  // stages a count covers (32 KB of codes)
constexpr int kAgWarps = kAgWorkers / 32;
constexpr int kAgSmem = kAgXBufs * kFStageVals * 4;
static_assert(kFStageVals == 16 * kAgWorkers, "hops s > 0: 16 values a thread a stage");
static_assert(kFStageVals == 2 * kSeg * kAgWarps, "hop 0: two segments a warp a stage");
static_assert(kAgSmem <= 232448, "shared memory of one block");

// The workers and the signal warp at the end of a group (named barrier 1).
__device__ __forceinline__ void ag_count_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kAgThreads) : "memory");
}

// Lane 0 of a warp waits until `*flag` holds `want` (`*seen`: the last
// value it read there); the warp returns whether it arrived.  The warp's
// barrier orders every lane's later reads of the slot after lane 0's
// acquire.
__device__ __forceinline__ bool warp_wait(const Call& c, const u64* flag, u64 want, u64* claim,
                                          int hop, u64* seen) {
  int ok = 1;
  if ((threadIdx.x & 31) == 0 && *seen < want) {
    u64 v = ld_acquire(flag);
    if (v < want) {
      ok = thread_wait(c, flag, want, claim, err_data(kFusedAg), hop);
      if (ok) v = ld_acquire(flag);
    }
    *seen = v;
  }
  ok = __shfl_sync(0xffffffffu, ok, 0);
  __syncwarp();
  return ok != 0;
}

// The 4 codes of `word` (little-endian) times `scale`, each one
// __fmul_rn (the reference's dequantization as XLA compiles it).
__device__ __forceinline__ float4 decode4(const Codec& q, unsigned word, float scale) {
  return make_float4(__fmul_rn(decode(word, q.scheme), scale),
                     __fmul_rn(decode(word >> 8, q.scheme), scale),
                     __fmul_rn(decode(word >> 16, q.scheme), scale),
                     __fmul_rn(decode(word >> 24, q.scheme), scale));
}

// v to base[i ... i+4), values at or past `size` not written, by a
// streaming store (evict first): an output no kernel of the call reads.
__device__ __forceinline__ void store4cs(float* base, long long i, long long size, float4 v) {
  if (i + 4 <= size && (reinterpret_cast<uintptr_t>(base + i) & 15) == 0) {
    __stcs(reinterpret_cast<float4*>(base + i), v);
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < size) base[i + k] = e[k];
}

// Warps 0-15: every load, the codec and every store of the block.
__device__ void fag_work(const Call& c, const Codec& q, const float* x, float* out,
                         long long out_size, long long chunk, int T, long long t0,
                         const Layout& own, const Layout& right, const float* xbufs,
                         volatile int* failed) {
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const u64 base = c.seq << kStageBits;
  const uint32_t xaddr = smem_addr(xbufs);
  // hop 0: stage k's values that this thread reads (16-byte pieces of its
  // warp's two segments) into x buffer k % kAgXBufs, one cp.async group
  auto load_x = [&](int k) {
    if (k < T) {
      const FStage f = fstage(t0 + k, chunk, q.block);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = (warp + h * kAgWarps) * kSeg + lane * 8;
        if (e < f.nv) {
          const uint32_t dst = xaddr + ((k % kAgXBufs) * kFStageVals + e) * 4;
          cp_async16(dst, x + f.v0 + e, 16);
          cp_async16(dst + 16, x + f.v0 + e + 4, 16);
        }
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < kAgXBufs - 1; ++k) load_x(k);
  char* const send = slot(right, 0);
  for (int k = 0; k < T; ++k) {
    load_x(k + kAgXBufs - 1);  // into the buffer stage k - 1 read
    cp_async_wait<kAgXBufs - 1>();  // this thread's values of stage k landed
    const FStage f = fstage(t0 + k, chunk, q.block);
    const float* xs = xbufs + (k % kAgXBufs) * kFStageVals;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = (warp + h * kAgWarps) * kSeg + lane * 8;
      if (e < f.nv) {  // a whole segment: all lanes of the warp
        const float4 a = *reinterpret_cast<const float4*>(xs + e);
        const float4 b = *reinterpret_cast<const float4*>(xs + e + 4);
        float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        float scale;
        const uint2 codes = quantize8(q, v, &scale);
        *reinterpret_cast<uint2*>(send + f.rec + e) = codes;
        if (lane % (q.block / 8) == 0)
          *reinterpret_cast<float*>(send + f.rec + f.nv + e / q.block * 4) = scale;
        // the decoded segment to the output, each store 512 contiguous bytes
        // of the warp: lane l takes values 4l.. of half i from lane 16i + l/2
        const long long o = (long long)d * chunk + f.v0 + e - lane * 8;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int src = 16 * i + (lane >> 1);
          const unsigned lo = __shfl_sync(0xffffffffu, codes.x, src);
          const unsigned hi = __shfl_sync(0xffffffffu, codes.y, src);
          const float s = __shfl_sync(0xffffffffu, scale, src);
          store4cs(out, o + 128 * i + 4 * lane, out_size, decode4(q, lane & 1 ? hi : lo, s));
        }
      }
    }
    if ((k + 1) % kAgCount == 0 || k + 1 == T) ag_count_sync();  // the signal warp counts them
  }
  // hops 1 .. n - 1: a group of stages of chunk (d - s) mod n at a time;
  // in a stage warp w takes values [512w, 512w + 512), lane l the 4 values
  // at 512w + 128m + 4l (m < 4), so each load and store of the warp covers
  // contiguous bytes
  const int e0 = warp * 512 + lane * 4;  // this thread's first value of a stage
  bool live = true;  // no wait of this warp gave up
  for (int s = 1; s < n; ++s) {
    const int ci = (d - s + n) % n;
    const char* recv = slot(own, s - 1);
    char* const fwd = s < n - 1 ? slot(right, s) : nullptr;
    const u64* flag = own.flags + (long long)(s - 1) * mb + blockIdx.x;
    u64 seen = 0;
    for (int k0 = 0; k0 < T; k0 += kAgCount) {
      const int k1 = min(T, k0 + kAgCount);
      if (live && !warp_wait(c, flag, base + (u64)k1, own.claim, s - 1, &seen)) {
        live = false;
        if (lane == 0) *failed = 1;
      }
      if (live) {
        unsigned codes[kAgCount][4];
        float scales[kAgCount][4];
#pragma unroll
        for (int u = 0; u < kAgCount; ++u) {
          const FStage f = fstage(t0 + k0 + u, chunk, q.block);
          if (k0 + u < k1 && e0 < f.nv) {  // a whole warp's 512 values
            const float* sp = reinterpret_cast<const float*>(recv + f.rec + f.nv);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int e = e0 + 128 * m;
              codes[u][m] = __ldcg(reinterpret_cast<const unsigned*>(recv + f.rec + e));
              scales[u][m] = __ldcg(sp + e / q.block);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kAgCount; ++u) {
          const FStage f = fstage(t0 + k0 + u, chunk, q.block);
          if (k0 + u < k1 && e0 < f.nv) {
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int e = e0 + 128 * m;
              if (fwd) {
                *reinterpret_cast<unsigned*>(fwd + f.rec + e) = codes[u][m];
                if (e % q.block == 0)
                  reinterpret_cast<float*>(fwd + f.rec + f.nv)[e / q.block] = scales[u][m];
              }
              store4cs(out, (long long)ci * chunk + f.v0 + e, out_size,
                       decode4(q, codes[u][m], scales[u][m]));
            }
          }
        }
      }
      if (fwd) ag_count_sync();
    }
  }
}

// Warp 16: the counts of every hop that sends, in the workers' order.
__device__ void fag_signal(const Call& c, int T, const Layout& right, volatile int* failed) {
  const int n = c.ws.n, mb = c.ws.max_blocks;
  const u64 base = c.seq << kStageBits;
  for (int s = 0; s < n - 1; ++s) {
    u64* flag = right.flags + (long long)s * mb + blockIdx.x;
    for (int k1 = 0; k1 < T;) {
      k1 = min(T, k1 + kAgCount);
      ag_count_sync();  // the workers' stores of stages [.., k1) were issued
      if ((threadIdx.x & 31) == 0 && !*failed) {
        __threadfence_system();
        st_release(flag, base + (u64)k1);
      }
    }
  }
}

// x: this rank's reduced chunk (`chunk` f32 values, 16-byte aligned);
// chunk c of the result lands at out[c * chunk + j] for flat indices below
// out_size.
__global__ void __launch_bounds__(kAgThreads, 1)
    ring_fused_ag_kernel(Call c, Codec q, const float* __restrict__ x,
                         float* __restrict__ out, long long out_size, long long chunk) {
  extern __shared__ __align__(128) unsigned char fag_smem[];
  __shared__ int failed;
  const Layout own = layout(c.ws, c.ws.own, kFusedAg);
  const Layout right = layout(c.ws, c.ws.right, kFusedAg);
  long long t0, t1;
  block_range((chunk + kFStageVals - 1) / kFStageVals, &t0, &t1);  // this block's stages
  const int T = (int)(t1 - t0);
  if (threadIdx.x == 0) failed = 0;
  // no thread stores into the right neighbour's slots before it has read
  // what the earlier calls sent it (every block of them acknowledged)
  if (!block_wait(c, right.ack, c.ack_want, own.claim, err_ack(kFusedAg), 0)) return;
  if (threadIdx.x < kAgWorkers)
    fag_work(c, q, x, out, out_size, chunk, T, t0, own, right,
             reinterpret_cast<const float*>(fag_smem), &failed);
  else
    fag_signal(c, T, right, &failed);
  __syncthreads();
  if (threadIdx.x == 0 && !failed) {  // slots read: the left may refill them
    __threadfence_system();
    atomicAdd_system(own.ack, 1ULL);
  }
}

// ------------------------------------------------------------- shift ----
// B11 runs on a side stream under ring attention's flash blocks
// (parallel/ring_attention.py), so it is built to share the card: a small
// grid of 64-thread blocks, one lane of warp 0 sending and one lane of
// warp 1 receiving, both moving their bytes with the copy engine (bulk
// asynchronous copies through shared memory), not with the threads.
//
//   send     source -> shared memory (cp.async.bulk, completing on an
//            mbarrier) -> the peer's slot (cp.async.bulk...bulk_group),
//            kStage bytes a stage, kSendBufs stages in shared memory;
//            every kChunk stages, once those stores are complete
//            (wait_group, with the newest kSignalLag still in flight), a
//            proxy fence and a release store raise the block's flag to
//            count them
//   receive  waits for each stage's count in its own flag, then slot ->
//            shared memory -> the output, by bulk copies too, loads up to
//            kRecvBufs - 1 stages ahead, so the copy-out of a chunk
//            overlaps the stores of the next ones
//
// What it costs (4 x H100 80GB HBM3 at 700 W, the 16.8 MB pair, 32 blocks,
// a call with its host issue): raising the flag after every 8 KB stage (a
// wait for the store's completion and a system release each) took
// 0.43-0.46 ms, one count at the end 0.18 ms with the copy-out after it,
// a count a chunk 0.15-0.16 ms; so a count covers kChunk stages, and the
// copy-out keeps several loads in flight.
//
// The flag of block b holds (call << kStageBits) + the stages that landed,
// so a flag per stage costs one word per block.  Block b owns a range of
// the pair's 16-byte vectors (K's, then V's) and its peer's block b the
// same range, so only block b of the two ranks meet.  The last block also
// carries the byte tails (sizes that are not a multiple of 16) with plain
// stores, as one more stage.  A block that gives up waiting drains the
// copies it issued before it leaves.
constexpr int kShiftThreads = 64;  // warp 0 sends, warp 1 receives
constexpr int kStage = 16384;      // bytes of one bulk copy
constexpr int kSendBufs = 4;       // the sender's stages in shared memory
constexpr int kRecvBufs = 4;       // the receiver's
constexpr int kChunk = 8;          // stages a count of the flag covers (128 KB)
constexpr int kSignalLag = 2;      // stores left in flight while a count is raised
constexpr int kShiftSmem = (kSendBufs + kRecvBufs) * kStage;

// One payload of a shift: `bytes` bytes from src to dst, at `offset` bytes
// (a multiple of 16) into the slot.
struct Part {
  const char* src;
  char* dst;
  long long bytes, offset;
};

// Block b's share of a shift: its range of the pair's 16-byte vectors (K's
// then V's, `block_range`), as up to two pieces, cut into stages.
struct Share {
  const char* src[2];
  char* dst[2];
  long long slot[2], len[2];
  int stages[2];

  __device__ int count() const { return stages[0] + stages[1]; }
  // stage i: its piece and its first byte in that piece
  __device__ int piece(int i) const { return i < stages[0] ? 0 : 1; }
  __device__ long long at(int i) const {
    return (long long)(i < stages[0] ? i : i - stages[0]) * kStage;
  }
  __device__ int bytes(int i) const {
    const int k = piece(i);
    return (int)min((long long)kStage, len[k] - at(i));
  }
};

__device__ __forceinline__ Share share_of(const Part& p0, const Part& p1) {
  const long long n0 = p0.bytes / 16, n1 = p1.bytes / 16;
  long long v0, v1;
  block_range(n0 + n1, &v0, &v1);
  const long long a0 = min(v0, n0), a1 = min(v1, n0);
  const long long b0 = max(v0, n0) - n0, b1 = max(v1, n0) - n0;
  Share s;
  s.src[0] = p0.src + a0 * 16, s.dst[0] = p0.dst + a0 * 16, s.slot[0] = p0.offset + a0 * 16;
  s.src[1] = p1.src + b0 * 16, s.dst[1] = p1.dst + b0 * 16, s.slot[1] = p1.offset + b0 * 16;
  s.len[0] = (a1 - a0) * 16, s.len[1] = (b1 - b0) * 16;
  for (int k = 0; k < 2; ++k) s.stages[k] = (int)((s.len[k] + kStage - 1) / kStage);
  return s;
}

// The byte tails (bytes % 16 of each payload) go with the last block.
__device__ __forceinline__ bool has_tail(const Part& p0, const Part& p1) {
  return blockIdx.x == gridDim.x - 1 && ((p0.bytes | p1.bytes) & 15);
}

template <bool kFromSlot>
__device__ __forceinline__ void copy_tail(const Part& p, const char* from, char* to) {
  for (long long i = p.bytes / 16 * 16; i < p.bytes; ++i)
    to[i] = kFromSlot ? (char)__ldcg(reinterpret_cast<const unsigned char*>(from) + i) : from[i];
}

// Until at most n (0 to kRecvBufs - 1) of this thread's bulk groups are
// still reading shared memory.
__device__ __forceinline__ void bulk_wait_read(int n) {
  switch (n) {
    case 0: bulk_wait<0, true>(); break;
    case 1: bulk_wait<1, true>(); break;
    case 2: bulk_wait<2, true>(); break;
    default: bulk_wait<3, true>(); break;
  }
}
static_assert(kRecvBufs == 4, "bulk_wait_read covers n up to kRecvBufs - 1");

// Warp 0, lane 0: this block's share into the peer's slot, stage by stage.
__device__ bool send_share(const Call& c, const Share& s, const Part& p0, const Part& p1,
                           const Layout& own, const Layout& peer, uint32_t bufs,
                           uint32_t bars, int shift) {
  const int S = s.count();
  const bool tail = has_tail(p0, p1);
  if (S == 0 && !tail) return true;
  // the peer has read what the earlier shifts stored into its slot
  if (!thread_wait(c, peer.ack, c.ack_want, own.claim, err_ack(kShift), shift)) return false;
  char* send = slot(peer, 0);
  u64* flag = peer.flags + blockIdx.x;
  const u64 base = c.seq << kStageBits;
  auto load = [&](int i) {
    const int k = s.piece(i);
    bulk_load(bufs + (i % kSendBufs) * kStage, s.src[k] + s.at(i), s.bytes(i),
              bars + 8 * (i % kSendBufs));
  };
  for (int i = 0; i < S && i < kSendBufs; ++i) load(i);
  for (int i = 0; i < S; ++i) {
    const int k = s.piece(i);
    mbar_wait(bars + 8 * (i % kSendBufs), (i / kSendBufs) & 1, c.timeout_ns);
    bulk_store(send + s.slot[k] + s.at(i), bufs + (i % kSendBufs) * kStage, s.bytes(i));
    if (i >= 1 && i - 1 + kSendBufs < S) {  // stage i - 1's buffer is read: refill it
      bulk_wait<1, true>();
      load(i - 1 + kSendBufs);
    }
    // every kChunk stages, count those complete but the newest kSignalLag
    const int j = i - kSignalLag;
    if (j >= 0 && (j + 1) % kChunk == 0 && j + 1 < S) {
      bulk_wait<kSignalLag, false>();
      count_stages(flag, base + (u64)(j + 1));
    }
  }
  bulk_wait<0, false>();
  if (tail) {
    copy_tail<false>(p0, p0.src, send + p0.offset);
    copy_tail<false>(p1, p1.src, send + p1.offset);
    __threadfence_system();
  }
  count_stages(flag, base + (u64)S + tail);
  return true;
}

// Warp 1, lane 0: this block's share out of its own slot as it lands,
// stage j's load issued up to kRecvBufs - 1 stages ahead of its store.
__device__ bool receive_share(const Call& c, const Share& s, const Part& p0, const Part& p1,
                              const Layout& own, uint32_t bufs, uint32_t bars, int shift) {
  const int S = s.count();
  const bool tail = has_tail(p0, p1);
  const char* recv = slot(own, 0);
  const u64* flag = own.flags + blockIdx.x;
  const u64 base = c.seq << kStageBits;
  u64 landed = 0;
  auto poll = [&]() {  // the stages landed so far, without waiting
    const u64 v = ld_acquire(flag);
    if (v > base + landed) {
      landed = v - base;
      fence_proxy_async();  // the peer's stores, acquired, before the copy engine reads them
    }
  };
  auto arrived = [&](u64 want) {
    if (landed >= want) return true;
    if (!thread_wait(c, flag, base + want, own.claim, err_data(kShift), shift)) return false;
    poll();
    return true;
  };
  int issued = 0;  // loads issued: stages [0, issued)
  for (int j = 0; j < S; ++j) {  // stage j's store
    while (issued < S && issued < j + kRecvBufs) {
      if (landed < (u64)issued + 1) poll();
      if (landed < (u64)issued + 1) {
        if (issued > j) break;  // stage j's load is in flight: store it first
        if (!arrived((u64)issued + 1)) {
          bulk_wait<0, false>();  // no load is in flight; the stores issued end
          return false;
        }
      }
      // the buffer's last stage, issued - kRecvBufs, has been read by its store
      bulk_wait_read(j - 1 - issued + kRecvBufs);
      const int k = s.piece(issued);
      bulk_load(bufs + (issued % kRecvBufs) * kStage, recv + s.slot[k] + s.at(issued),
                s.bytes(issued), bars + 8 * (issued % kRecvBufs));
      ++issued;
    }
    const int k = s.piece(j);
    mbar_wait(bars + 8 * (j % kRecvBufs), (j / kRecvBufs) & 1, c.timeout_ns);
    bulk_store(s.dst[k] + s.at(j), bufs + (j % kRecvBufs) * kStage, s.bytes(j));
  }
  bulk_wait<0, false>();
  if (tail) {
    if (!arrived((u64)S + 1)) return false;
    copy_tail<true>(p0, recv + p0.offset, p0.dst);
    copy_tail<true>(p1, recv + p1.offset, p1.dst);
  }
  return true;
}

// The shift of up to two payloads (K and V of one hop) as one call: block
// b's sender stores its share of both into the peer's slot (c.ws.right is
// rank + shift), its receiver copies the same share of its own slot
// (stored by rank - shift) out as it lands.  `shift` is only recorded with
// an error, to name the two peers.
__global__ void __launch_bounds__(kShiftThreads)
    ring_shift_kernel(Call c, Part p0, Part p1, int shift) {
  extern __shared__ __align__(128) unsigned char shift_smem[];
  __shared__ __align__(8) u64 bars[kSendBufs + kRecvBufs];
  __shared__ int failed;
  const Layout own = layout(c.ws, c.ws.own, kShift), peer = layout(c.ws, c.ws.right, kShift);
  const uint32_t bufs = smem_addr(shift_smem), bar0 = smem_addr(bars);
  if (threadIdx.x == 0) {
    failed = 0;
    for (int i = 0; i < kSendBufs + kRecvBufs; ++i) mbar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    const Share s = share_of(p0, p1);
    const bool ok =
        threadIdx.x == 0
            ? send_share(c, s, p0, p1, own, peer, bufs, bar0, shift)
            : receive_share(c, s, p0, p1, own, bufs + kSendBufs * kStage,
                            bar0 + 8 * kSendBufs, shift);
    if (!ok) failed = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0 && !failed) {  // slot read: rank - shift of a later call may refill it
    fence_proxy_async();
    __threadfence_system();
    atomicAdd_system(own.ack, 1ULL);
  }
}

// ------------------------------------------------ error feedback ----
// The error-feedback residual of a list of gradients, in place, in one
// launch: each tensor x (the corrected gradient c, f32) becomes c - code *
// scale, c quantized in blocks from its first value (the last block padded
// with zeros), each element one fused multiply-add.  That is the
// reference's c - roundtrip(c) as XLA compiles it, and the plain version
// (compression/quant.py `residual`) computes the same bits.  The tensors
// come as a table passed by value (no copy to the card): entry i names a
// tensor and its first 256-value segment in one flat index over the
// launch, and one warp takes a segment at a time (as in the fused ring
// kernels), finding its tensor by a binary search over the table.  A
// segment never spans two tensors, so a grouped launch computes the bits of
// a launch per tensor.  Bound by bytes: each value read and written once.
constexpr int kEfMax = 250;  // tensors in one launch (compression/error_feedback.py)

struct EfEntry {
  float* x;
  unsigned size;  // values
  unsigned seg0;  // its first segment in the launch's flat index
};

struct EfTable {
  EfEntry e[kEfMax];
  int count;
  unsigned segs;  // segments of the launch
};
static_assert(sizeof(EfEntry) == 16, "a table entry is 16 bytes");
static_assert(sizeof(Codec) + sizeof(EfTable) <= 4096, "a launch's parameters must fit 4 KB");

__global__ void __launch_bounds__(kThreads)
    ef_residual_kernel(Codec q, const __grid_constant__ EfTable t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long g = (long long)blockIdx.x * kWarps + warp; g < t.segs;
       g += (long long)gridDim.x * kWarps) {
    int lo = 0, hi = t.count - 1;  // the last entry whose first segment is at or before g
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.e[mid].seg0 <= g)
        lo = mid;
      else
        hi = mid - 1;
    }
    const EfEntry& e = t.e[lo];
    const long long j = (g - e.seg0) * kSeg + lane * 8;
    float v[8];
    load8(e.x, j, e.size, v);
    float scale;
    const uint2 codes = quantize8(q, v, &scale);
    sub_decoded(q, codes, scale, v);
    store8(e.x, j, e.size, v);
  }
}

// ------------------------------------------------------------ launch ----

bool plain_ok(const Args& a, int elem) {
  return args_ok(a) && a.chunk % (16 / elem) == 0 && a.chunk * elem <= a.slot_bytes;
}

// A fused chunk holds whole 256-value segments; its codes and scales fit a slot.
bool fused_ok(const Args& a, const Codec& q) {
  return args_ok(a) && (q.scheme == kInt8 || q.scheme == kFp8) && q.block >= 8 &&
         q.block <= kSeg && kSeg % q.block == 0 && a.chunk % 1024 == 0 &&
         a.chunk + a.chunk / q.block * 4 <= a.slot_bytes;
}

template <typename T>
View<T> make_view(long long p, long long row, long long size) {
  View<T> v;
  v.base = reinterpret_cast<T*>(p);
  v.row = row;
  v.size = size;
  v.vec_ok = (row % Ops<T>::kVec == 0) && (p % 16 == 0);
  return v;
}

// The table of `count` host entries (kSegWords each), each segment's
// vectors following the last one's; false unless its vectors make up the
// call's chunk exactly and it fits a slot.
template <typename T>
bool make_table(const Args& a, const long long* desc, int count, Table<T>* t) {
  if (count < 1 || count > kMaxSegs || !plain_ok(a, sizeof(T))) return false;
  memset(t, 0, sizeof(*t));
  long long vec = 0;
  for (int i = 0; i < count; ++i) {
    const long long* e = desc + (long long)kSegWords * i;
    const long long row = e[4];
    if (row < 0 || e[1] < 0 || e[3] < 0) return false;
    Seg<T>& g = t->seg[i];
    g.x = make_view<T>(e[0], row, e[1]);
    g.out = make_view<T>(e[2], row, e[3]);
    g.vec0 = vec;
    vec += (row + Ops<T>::kVec - 1) / Ops<T>::kVec;
    g.vec1 = vec;
  }
  t->count = count;
  return vec * Ops<T>::kVec == a.chunk;
}

template <typename T>
int launch_rs(const Args& a, const long long* desc, int count, cudaStream_t stream) {
  Table<T> t;
  if (!make_table(a, desc, count, &t)) return (int)cudaErrorInvalidValue;
  ring_rs_kernel<T><<<a.blocks, kThreads, 0, stream>>>(make_call(a), t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ag(const Args& a, const long long* desc, int count, cudaStream_t stream) {
  Table<T> t;
  if (!make_table(a, desc, count, &t)) return (int)cudaErrorInvalidValue;
  ring_ag_kernel<T><<<a.blocks, kThreads, 0, stream>>>(make_call(a), t);
  return (int)cudaGetLastError();
}

}  // namespace kft_ring

using kft_ring::Args;
using kft_ring::Codec;

// Every function returns a CUDA error code (0 = success).

// Reduce-scatter of `count` segments (at most kMaxSegs) in one launch.
// Entry i of `segs` is kSegWords values: x, x_size, out, out_size, row.
// x holds n chunks of `row` values, chunk c at x[c * row + j] (zero past
// x_size); out[j] = the ring sum of chunk `rank` for j < row (and below
// out_size).  `chunk` is the sum of the rows, each rounded up to whole
// 16-byte vectors.
extern "C" int kft_ring_rs(const long long* segs, int count, int dtype, KFT_RING_PARAMS) {
  Args a = KFT_RING_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kft_ring::kFloat32) return kft_ring::launch_rs<float>(a, segs, count, s);
  if (dtype == kft_ring::kBFloat16)
    return kft_ring::launch_rs<__nv_bfloat16>(a, segs, count, s);
  return (int)cudaErrorInvalidValue;
}

// All-gather of `count` segments in one launch, entries as for
// kft_ring_rs: x[j] for j < row is this rank's chunk; chunk c lands at
// out[c * row + j] for j < row and a flat index below out_size.
extern "C" int kft_ring_ag(const long long* segs, int count, int dtype, KFT_RING_PARAMS) {
  Args a = KFT_RING_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kft_ring::kFloat32) return kft_ring::launch_ag<float>(a, segs, count, s);
  if (dtype == kft_ring::kBFloat16)
    return kft_ring::launch_ag<__nv_bfloat16>(a, segs, count, s);
  return (int)cudaErrorInvalidValue;
}

// Fused-codec reduce-scatter: x is the f32 payload (x_size values, n
// chunks of `chunk`, zero past the end, 16-byte aligned); out (chunk f32
// values) = this rank's chunk reduced through int8 (scheme 0) or fp8 (1)
// codes with one scale per `block` values; `recip` = 1 / codemax rounded to
// f32.  `blocks` at most the stages of the chunk (kFStageVals values each).
extern "C" int kft_ring_frs(void* x, long long x_size, void* out, int scheme, int block,
                            float recip, KFT_RING_PARAMS) {
  using namespace kft_ring;
  Args a = KFT_RING_ARGS;
  Codec q{scheme, block, recip};
  const long long stages = (chunk + kFStageVals - 1) / kFStageVals;
  if (!fused_ok(a, q) || (reinterpret_cast<uintptr_t>(x) & 15) || x_size < 0 ||
      seq >= (1ULL << (64 - kStageBits)) ||
      (stages + blocks - 1) / blocks >= (1LL << kStageBits) - 1)
    return (int)cudaErrorInvalidValue;
  static int smem_on = -1;  // above 48 KB needs the attribute, once a device
  const cudaError_t e = allow_smem(ring_fused_rs_kernel, kFSmem, &smem_on);
  if (e != cudaSuccess) return (int)e;
  ring_fused_rs_kernel<<<blocks, kFThreads, kFSmem, static_cast<cudaStream_t>(stream)>>>(
      make_call(a), q, static_cast<const float*>(x), x_size, static_cast<float*>(out), chunk);
  return (int)cudaGetLastError();
}

// Fused-codec all-gather: x (chunk f32 values, 16-byte aligned) is this
// rank's reduced chunk; every rank's chunk c, quantized once by its owner,
// is decoded into out[c * chunk + j] for flat indices below out_size.
// `blocks` at most the stages of the chunk (kFStageVals values each).
extern "C" int kft_ring_fag(void* x, void* out, long long out_size, int scheme, int block,
                            float recip, KFT_RING_PARAMS) {
  using namespace kft_ring;
  Args a = KFT_RING_ARGS;
  Codec q{scheme, block, recip};
  const long long stages = (chunk + kFStageVals - 1) / kFStageVals;
  if (!fused_ok(a, q) || (reinterpret_cast<uintptr_t>(x) & 15) || out_size < 0 ||
      seq >= (1ULL << (64 - kStageBits)) ||
      (stages + blocks - 1) / blocks >= (1LL << kStageBits) - 1)
    return (int)cudaErrorInvalidValue;
  static int smem_on = -1;  // above 48 KB needs the attribute, once a device
  const cudaError_t e = allow_smem(ring_fused_ag_kernel, kAgSmem, &smem_on);
  if (e != cudaSuccess) return (int)e;
  ring_fused_ag_kernel<<<blocks, kAgThreads, kAgSmem, static_cast<cudaStream_t>(stream)>>>(
      make_call(a), q, static_cast<const float*>(x), static_cast<float*>(out), out_size, chunk);
  return (int)cudaGetLastError();
}

// Ring shift of up to two payloads (bytes1 may be 0): rank `rank` stores
// src0 and src1 into the slot of the peer mapped at `right` (rank + shift),
// and copies what rank - shift stored into its own slot to dst0 and dst1.
// The slot holds payload 0, then payload 1 from the next multiple of 16
// bytes; `chunk` is that total, at most `slot_bytes`.  Every pointer is 16-byte
// aligned.
extern "C" int kft_ring_shift(void* src0, void* dst0, long long bytes0, void* src1, void* dst1,
                              long long bytes1, int shift, KFT_RING_PARAMS) {
  Args a = KFT_RING_ARGS;
  const long long off1 = (bytes0 + 15) / 16 * 16;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(src0) | reinterpret_cast<uintptr_t>(dst0) |
                         reinterpret_cast<uintptr_t>(src1) | reinterpret_cast<uintptr_t>(dst1);
  if (!kft_ring::args_ok(a) || bytes0 < 0 || bytes1 < 0 || (ptrs & 15) ||
      chunk != off1 + bytes1 || chunk > slot_bytes ||
      seq >= (1ULL << (64 - kft_ring::kStageBits)) ||
      (bytes0 + bytes1) / 16 / blocks / kft_ring::kStage >= (1LL << kft_ring::kStageBits) - 1)
    return (int)cudaErrorInvalidValue;
  static int smem_on = -1;  // above 48 KB needs the attribute, once a device
  const cudaError_t e =
      kft_ring::allow_smem(kft_ring::ring_shift_kernel, kft_ring::kShiftSmem, &smem_on);
  if (e != cudaSuccess) return (int)e;
  const kft_ring::Part p0{static_cast<const char*>(src0), static_cast<char*>(dst0), bytes0, 0};
  const kft_ring::Part p1{static_cast<const char*>(src1), static_cast<char*>(dst1), bytes1, off1};
  kft_ring::ring_shift_kernel<<<blocks, kft_ring::kShiftThreads, kft_ring::kShiftSmem,
                                static_cast<cudaStream_t>(stream)>>>(kft_ring::make_call(a), p0,
                                                                     p1, shift);
  return (int)cudaGetLastError();
}

// Error-feedback residual in place on `count` tensors (at most kEfMax) in
// one launch: entry i of `entries` is two values, a tensor's address and
// its size (1 to 2^31 f32 values); each becomes x - code * scale under
// int8 (scheme 0) or fp8 (1) codes, one scale per `block` values counted
// from its first value; `recip` = 1 / codemax rounded to f32.
extern "C" int kft_ef_residual(const long long* entries, int count, int scheme, int block,
                               float recip, void* stream) {
  using namespace kft_ring;
  const Codec q{scheme, block, recip};
  if (count < 1 || count > kEfMax || (scheme != kInt8 && scheme != kFp8) || block < 8 ||
      block > kSeg || kSeg % block)
    return (int)cudaErrorInvalidValue;
  EfTable t;
  memset(&t, 0, sizeof(t));
  unsigned long long segs = 0;
  for (int i = 0; i < count; ++i) {
    const long long x = entries[2 * i], size = entries[2 * i + 1];
    if (size < 1 || size > (1LL << 31) || (x & 3)) return (int)cudaErrorInvalidValue;
    t.e[i] = EfEntry{reinterpret_cast<float*>(x), (unsigned)size, (unsigned)segs};
    segs += (unsigned long long)(size + kSeg - 1) / kSeg;
    if (segs >= (1ULL << 32)) return (int)cudaErrorInvalidValue;
  }
  t.count = count;
  t.segs = (unsigned)segs;
  const unsigned long long blocks = (segs + kWarps - 1) / kWarps;
  ef_residual_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(q, t);
  return (int)cudaGetLastError();
}

// Bytes of the workspace header (flags, acks, claim word) for n ranks.
extern "C" long long kft_ring_header_bytes(int n, int max_blocks) {
  return kft_ring::header_bytes(n, max_blocks);
}

// The workspace: cudaMalloc'ed (an IPC handle names a whole allocation),
// zeroed, and its 64-byte IPC handle written to `handle`.
extern "C" int kft_ws_alloc(int device, long long bytes, void** ptr, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, (size_t)bytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return (int)e;
}

extern "C" int kft_ws_open(int device, const void* handle, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int kft_ws_close(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  return (int)(e == cudaSuccess ? cudaIpcCloseMemHandle(ptr) : e);
}

extern "C" int kft_ws_free(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  return (int)(e == cudaSuccess ? cudaFree(ptr) : e);
}

// Host memory the kernels write their error record into, zeroed; with
// unified addressing its host pointer is valid on the card too.
extern "C" int kft_host_alloc(long long bytes, void** ptr) {
  cudaError_t e = cudaHostAlloc(ptr, (size_t)bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (e == cudaSuccess) memset(*ptr, 0, (size_t)bytes);
  return (int)e;
}

extern "C" int kft_host_free(void* ptr) { return (int)cudaFreeHost(ptr); }
