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
// between).  Its first version stores into the peer and copies out in two
// passes; the copy-out could land in place of the slot in a later one.
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

__device__ __forceinline__ void decode8(const Codec& q, uint2 codes, float scale, float v[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned word = k < 4 ? codes.x : codes.y;
    v[k] = __fmul_rn(decode(word >> (8 * (k % 4)), q.scheme), scale);
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

// A fused slot: `chunk` bytes of codes, then the chunk's scales.
struct Payload {
  char* codes;
  float* scales;
};

__device__ __forceinline__ Payload payload(const Layout& l, int s, long long chunk) {
  char* base = slot(l, s);
  return Payload{base, reinterpret_cast<float*>(base + chunk)};
}

// One warp's payload step at value j of the chunk (lane's first value).
__device__ __forceinline__ void store_payload(const Codec& q, const Payload& p, long long j,
                                              uint2 codes, float scale) {
  *reinterpret_cast<uint2*>(p.codes + j) = codes;
  if ((threadIdx.x & 31) % (q.block / 8) == 0) p.scales[j / q.block] = scale;
}

__device__ __forceinline__ void load_payload(const Codec& q, const Payload& p, long long j,
                                             uint2* codes, float* scale) {
  *codes = __ldcg(reinterpret_cast<const uint2*>(p.codes + j));
  *scale = __ldcg(p.scales + j / q.block);
}

// x: the f32 flat payload, chunk c at x[c * chunk + j], zero past x_size;
// out: this rank's reduced chunk, `chunk` f32 values.
__global__ void __launch_bounds__(kThreads)
    ring_fused_rs_kernel(Call c, Codec q, const float* __restrict__ x, long long x_size,
                         float* __restrict__ out, long long chunk) {
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks, b = blockIdx.x;
  const Layout own = layout(c.ws, c.ws.own, kFusedRs);
  const Layout right = layout(c.ws, c.ws.right, kFusedRs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long g0, g1;
  block_range(chunk / kSeg, &g0, &g1);  // this block's 256-value segments
  if (!block_wait(c, right.ack, c.ack_want, own.claim, err_ack(kFusedRs), 0)) return;
  for (int s = 0; s < n - 1; ++s) {
    const int ci = ((d - s - 1) % n + n) % n;
    if (s > 0 && !block_wait(c, own.flags + (long long)(s - 1) * mb + b, c.seq, own.claim,
                             err_data(kFusedRs), s - 1))
      return;
    const Payload recv = payload(own, s > 0 ? s - 1 : 0, chunk);
    const Payload send = payload(right, s, chunk);
    for (long long g = g0 + warp; g < g1; g += kWarps) {
      const long long j = g * kSeg + lane * 8;
      float v[8];
      load8(x, (long long)ci * chunk + j, x_size, v);
      if (s > 0) {
        uint2 codes;
        float scale;
        load_payload(q, recv, j, &codes, &scale);
        add_decoded(q, codes, scale, v);
      }
      float scale;
      const uint2 codes = quantize8(q, v, &scale);
      store_payload(q, send, j, codes, scale);
    }
    block_signal(right.flags + (long long)s * mb + b, c.seq);
  }
  if (!block_wait(c, own.flags + (long long)(n - 2) * mb + b, c.seq, own.claim,
                  err_data(kFusedRs), n - 2))
    return;
  const Payload recv = payload(own, n - 2, chunk);
  for (long long g = g0 + warp; g < g1; g += kWarps) {
    const long long j = g * kSeg + lane * 8;
    float v[8];
    load8(x, (long long)d * chunk + j, x_size, v);
    uint2 codes;
    float scale;
    load_payload(q, recv, j, &codes, &scale);
    add_decoded(q, codes, scale, v);
    store8(out, j, chunk, v);
  }
  block_ack(own.ack);  // slots read: the left may refill them
}

// x: this rank's reduced chunk (`chunk` f32 values); chunk c of the result
// lands at out[c * chunk + j] for flat indices below out_size.
__global__ void __launch_bounds__(kThreads)
    ring_fused_ag_kernel(Call c, Codec q, const float* __restrict__ x,
                         float* __restrict__ out, long long out_size, long long chunk) {
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks, b = blockIdx.x;
  const Layout own = layout(c.ws, c.ws.own, kFusedAg);
  const Layout right = layout(c.ws, c.ws.right, kFusedAg);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long g0, g1;
  block_range(chunk / kSeg, &g0, &g1);  // this block's 256-value segments
  if (!block_wait(c, right.ack, c.ack_want, own.claim, err_ack(kFusedAg), 0)) return;
  // hop 0: quantize this rank's chunk once, decode it into the output,
  // send its codes and scales to the right
  const Payload send = payload(right, 0, chunk);
  for (long long g = g0 + warp; g < g1; g += kWarps) {
    const long long j = g * kSeg + lane * 8;
    float v[8];
    load8(x, j, chunk, v);
    float scale;
    const uint2 codes = quantize8(q, v, &scale);
    store_payload(q, send, j, codes, scale);
    decode8(q, codes, scale, v);
    store8(out, (long long)d * chunk + j, out_size, v);
  }
  block_signal(right.flags + b, c.seq);
  // hop s: the codes of chunk (d-s) mod n arrived in slot s-1; decode them,
  // forward them unchanged
  for (int s = 1; s < n; ++s) {
    const int ci = ((d - s) % n + n) % n;
    if (!block_wait(c, own.flags + (long long)(s - 1) * mb + b, c.seq, own.claim,
                    err_data(kFusedAg), s - 1))
      return;
    const Payload recv = payload(own, s - 1, chunk);
    const Payload fwd = payload(right, s < n - 1 ? s : 0, chunk);
    for (long long g = g0 + warp; g < g1; g += kWarps) {
      const long long j = g * kSeg + lane * 8;
      uint2 codes;
      float scale, v[8];
      load_payload(q, recv, j, &codes, &scale);
      if (s < n - 1) store_payload(q, fwd, j, codes, scale);
      decode8(q, codes, scale, v);
      store8(out, (long long)ci * chunk + j, out_size, v);
    }
    if (s < n - 1) block_signal(right.flags + (long long)s * mb + b, c.seq);
  }
  block_ack(own.ack);
}

// ------------------------------------------------------------- shift ----
// One payload of a shift: `bytes` bytes from src to dst, at `offset` bytes
// (a multiple of 16) into the slot.
struct Part {
  const char* src;
  char* dst;
  long long bytes, offset;
};

// Block b's share of `bytes` bytes from `from` to `to` (both 16-byte
// aligned): its range of 16-byte vectors, and for the last block the tail
// of bytes % 16 single bytes.  `kFromSlot`: `from` is this rank's slot,
// stored by a peer, read through L2.
template <bool kFromSlot>
__device__ __forceinline__ void copy_share(const char* from, char* to, long long bytes) {
  const long long nvec = bytes / 16;
  long long v0, v1;
  block_range(nvec, &v0, &v1);
  const uint4* src = reinterpret_cast<const uint4*>(from);
  uint4* dst = reinterpret_cast<uint4*>(to);
  for (long long v = v0 + threadIdx.x; v < v1; v += kUnroll * kThreads) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long w = v + u * kThreads;
      if (w < v1) r[u] = kFromSlot ? __ldcg(src + w) : src[w];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long w = v + u * kThreads;
      if (w < v1) dst[w] = r[u];
    }
  }
  const long long tail = bytes - nvec * 16;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    const long long i = nvec * 16 + threadIdx.x;
    const unsigned char* f = reinterpret_cast<const unsigned char*>(from);
    to[i] = (char)(kFromSlot ? __ldcg(f + i) : f[i]);
  }
}

// The shift of up to two payloads (K and V of one hop) as one call: every
// block stores its share of both into the peer's slot (c.ws.right is rank
// + shift), raises its flag there, waits for the flag of the same block in
// its own slot (stored by rank - shift) and copies its share out.  `shift`
// is only recorded with an error, to name the two peers.
__global__ void __launch_bounds__(kThreads)
    ring_shift_kernel(Call c, Part p0, Part p1, int shift) {
  const int b = blockIdx.x;
  const Layout own = layout(c.ws, c.ws.own, kShift), peer = layout(c.ws, c.ws.right, kShift);
  // the peer has read what the earlier shifts stored into its slot
  if (!block_wait(c, peer.ack, c.ack_want, own.claim, err_ack(kShift), shift)) return;
  char* send = slot(peer, 0);
  copy_share<false>(p0.src, send + p0.offset, p0.bytes);
  copy_share<false>(p1.src, send + p1.offset, p1.bytes);
  block_signal(peer.flags + b, c.seq);
  if (!block_wait(c, own.flags + b, c.seq, own.claim, err_data(kShift), shift)) return;
  const char* recv = slot(own, 0);
  copy_share<true>(recv + p0.offset, p0.dst, p0.bytes);
  copy_share<true>(recv + p1.offset, p1.dst, p1.bytes);
  block_ack(own.ack);  // slot read: rank - shift of a later call may refill it
}

// ------------------------------------------------ error feedback ----
// The error-feedback residual of one gradient, in place: x holds the
// corrected gradient c (`size` f32 values) and becomes c - code * scale,
// c quantized in blocks from its first value (the last block padded with
// zeros), each element one fused multiply-add.  That is the reference's
// c - roundtrip(c) as XLA compiles it, and the plain version
// (compression/quant.py `residual`) computes the same bits.  One warp per
// 256 values, as in the fused ring kernels; no peer, no workspace.
__global__ void __launch_bounds__(kThreads)
    ef_residual_kernel(Codec q, float* __restrict__ x, long long size) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long segs = (size + kSeg - 1) / kSeg;
  for (long long g = (long long)blockIdx.x * kWarps + warp; g < segs;
       g += (long long)gridDim.x * kWarps) {
    const long long j = g * kSeg + lane * 8;
    float v[8];
    load8(x, j, size, v);
    float scale;
    const uint2 codes = quantize8(q, v, &scale);
    sub_decoded(q, codes, scale, v);
    store8(x, j, size, v);
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
// chunks of `chunk`, zero past the end); out (chunk f32 values) = this
// rank's chunk reduced through int8 (scheme 0) or fp8 (1) codes with one
// scale per `block` values; `recip` = 1 / codemax rounded to f32.
extern "C" int kft_ring_frs(void* x, long long x_size, void* out, int scheme, int block,
                            float recip, KFT_RING_PARAMS) {
  Args a = KFT_RING_ARGS;
  Codec q{scheme, block, recip};
  if (!kft_ring::fused_ok(a, q)) return (int)cudaErrorInvalidValue;
  kft_ring::ring_fused_rs_kernel<<<blocks, kft_ring::kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      kft_ring::make_call(a), q, static_cast<const float*>(x), x_size,
      static_cast<float*>(out), chunk);
  return (int)cudaGetLastError();
}

// Fused-codec all-gather: x (chunk f32 values) is this rank's reduced
// chunk; every rank's chunk c, quantized once by its owner, is decoded into
// out[c * chunk + j] for flat indices below out_size.
extern "C" int kft_ring_fag(void* x, void* out, long long out_size, int scheme, int block,
                            float recip, KFT_RING_PARAMS) {
  Args a = KFT_RING_ARGS;
  Codec q{scheme, block, recip};
  if (!kft_ring::fused_ok(a, q)) return (int)cudaErrorInvalidValue;
  kft_ring::ring_fused_ag_kernel<<<blocks, kft_ring::kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      kft_ring::make_call(a), q, static_cast<const float*>(x), static_cast<float*>(out),
      out_size, chunk);
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
      chunk != off1 + bytes1 || chunk > slot_bytes)
    return (int)cudaErrorInvalidValue;
  const kft_ring::Part p0{static_cast<const char*>(src0), static_cast<char*>(dst0), bytes0, 0};
  const kft_ring::Part p1{static_cast<const char*>(src1), static_cast<char*>(dst1), bytes1, off1};
  kft_ring::ring_shift_kernel<<<blocks, kft_ring::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(kft_ring::make_call(a), p0,
                                                                     p1, shift);
  return (int)cudaGetLastError();
}

// Error-feedback residual in place on x (`size` f32 values): x - code *
// scale under int8 (scheme 0) or fp8 (1) codes, one scale per `block`
// values counted from x[0]; `recip` = 1 / codemax rounded to f32.
extern "C" int kft_ef_residual(void* x, long long size, int scheme, int block, float recip,
                               void* stream) {
  using namespace kft_ring;
  const Codec q{scheme, block, recip};
  if (size < 1 || (scheme != kInt8 && scheme != kFp8) || block < 8 || block > kSeg ||
      kSeg % block)
    return (int)cudaErrorInvalidValue;
  const long long segs = (size + kSeg - 1) / kSeg;
  const long long blocks = (segs + kWarps - 1) / kWarps;
  ef_residual_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(q, static_cast<float*>(x), size);
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
