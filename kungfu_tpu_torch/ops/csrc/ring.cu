// Ring reduce-scatter and all-gather for Hopper (sm_90a), and the CUDA IPC
// calls behind their peer workspace.
//
// Replace the TPU kernels kungfu_tpu/ops/ring_kernels.py `make_rs_kernel`
// (launched by pallas_collectives._rs_call) and `make_ag_kernel` (by
// _ag_call).  The schedule is theirs, hop for hop:
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
//
// Remote copies: where the Pallas kernel starts a DMA to device `right`, a
// block here stores the payload through a pointer into the right
// neighbour's workspace (cudaIpcOpenMemHandle; NVLink between cards, plain
// device memory when the ranks share a card), then raises a flag there.
// Flags replace the DMA semaphores: one 64-bit word per (hop, block) holding
// the call's sequence number.  Block b waits only on block b of its left
// neighbour (the same element range), so no grid-wide barrier is needed.
// Order: data stores, __threadfence_system(), a release store of the flag;
// the reader polls with an acquire load and reads the slot through L2.
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
// What bounds it: bytes.  Between cards each rank sends (n-1) chunks per
// kernel over NVLink (450 GB/s each way); on one card all ranks' reads and
// writes share its 3.35 TB/s.  This first version moves 16 bytes per thread
// per access and keeps four accesses in flight; it does not overlap one
// hop's stores with the next hop's wait.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace kft_ring {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
enum DType { kFloat32 = 0, kBFloat16 = 2 };
// error kinds recorded in err[0]
enum ErrKind { kRsData = 1, kRsAck = 2, kAgData = 3, kAgAck = 4 };

// Workspace layout, the same on every rank (ops/peer_memory.py builds it):
//   u64 flags_rs[n-1][max_blocks], flags_ag[n-1][max_blocks],
//   u64 ack_rs, ack_ag (blocks that read their slots, all calls), claim
//   (header padded to 4096 bytes), then n-1 receive slots for the
//   reduce-scatter and n-1 landing slots for the all-gather, `cap` bytes each.
struct Workspace {
  char* own;
  char* right;
  int n, rank, max_blocks;
  long long cap;  // bytes per slot
};

__host__ __device__ inline long long header_bytes(int n, int max_blocks) {
  long long words = 2LL * (n - 1) * max_blocks + 3;
  return (words * 8 + 4095) / 4096 * 4096;
}

struct Layout {
  u64 *flags_rs, *flags_ag, *ack_rs, *ack_ag, *claim;
  char *slots_rs, *slots_ag;
};

__device__ inline Layout layout(char* base, int n, int mb, long long cap) {
  Layout l;
  u64* w = reinterpret_cast<u64*>(base);
  l.flags_rs = w;
  l.flags_ag = w + (long long)(n - 1) * mb;
  l.ack_rs = w + 2LL * (n - 1) * mb;
  l.ack_ag = l.ack_rs + 1;
  l.claim = l.ack_ag + 1;
  l.slots_rs = base + header_bytes(n, mb);
  l.slots_ag = l.slots_rs + (long long)(n - 1) * cap;
  return l;
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 globaltimer() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Call {
  Workspace ws;
  u64 seq;
  u64 ack_want;  // blocks of the earlier calls of this kind
  u64 timeout_ns;
  volatile u64* err;  // host-mapped: kind, hop, block, seq
};

// Thread 0 polls `*p >= want`; the whole block returns whether it arrived.
// On expiry the first failing block on this rank records where it waited.
__device__ bool block_wait(const Call& c, const u64* p, u64 want, u64* claim, int kind,
                           int hop) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    // a claimed error (an earlier call, or another block) ends the kernel
    int good = *reinterpret_cast<volatile u64*>(claim) == 0;
    u64 deadline = globaltimer() + c.timeout_ns;
    while (good && ld_acquire(p) < want) {
      if (*reinterpret_cast<volatile u64*>(claim) != 0) {  // another block gave up
        good = 0;
        break;
      }
      if (globaltimer() > deadline) {
        good = 0;
        if (atomicCAS(claim, 0ULL, 1ULL) == 0ULL) {
          c.err[1] = (u64)hop;
          c.err[2] = (u64)blockIdx.x;
          c.err[3] = c.seq;
          __threadfence_system();
          c.err[0] = (u64)kind;
          __threadfence_system();
        }
        break;
      }
      __nanosleep(128);
    }
    ok = good;
  }
  __syncthreads();
  return ok != 0;
}

// All threads' stores, then one release of the flag by thread 0.
__device__ __forceinline__ void block_signal(u64* flag, u64 seq) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release(flag, seq);
  }
}

// All threads' reads of this block's slots are done: count the block.
__device__ __forceinline__ void block_ack(u64* ack) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    atomicAdd_system(ack, 1ULL);
  }
}

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

// A strided view of n chunks: element j of chunk c lives at
// base[c * stride + j] when j < row and c * stride + j < size; elsewhere
// it reads as zero and is not written.  `vec_ok`: stride and base allow
// 16-byte accesses.
template <typename T>
struct View {
  T* base;
  long long stride, row, size;
  int vec_ok;

  __device__ uint4 load(int c, long long v) const {
    constexpr int V = Ops<T>::kVec;
    long long j = v * V, i = (long long)c * stride + j;
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
    long long j = v * V, i = (long long)c * stride + j;
    if (vec_ok && j + V <= row && i + V <= size) {
      *reinterpret_cast<uint4*>(base + i) = val;
      return;
    }
    const T* e = reinterpret_cast<const T*>(&val);
    for (int k = 0; k < V; ++k)
      if (j + k < row && i + k < size) base[i + k] = e[k];
  }
};

__device__ __forceinline__ uint4* slot(char* slots, long long cap, int s) {
  return reinterpret_cast<uint4*>(slots + (long long)s * cap);
}

// Block b's share of the chunk, in 16-byte vectors: [v0, v1).
__device__ __forceinline__ void block_range(long long nvec, long long* v0, long long* v1) {
  long long per = (nvec + gridDim.x - 1) / gridDim.x;
  *v0 = min(nvec, (long long)blockIdx.x * per);
  *v1 = min(nvec, *v0 + per);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_rs_kernel(Call c, View<T> x, View<T> out, long long nvec) {
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks, b = blockIdx.x;
  Layout own = layout(c.ws.own, n, mb, c.ws.cap);
  Layout right = layout(c.ws.right, n, mb, c.ws.cap);
  long long v0, v1;
  block_range(nvec, &v0, &v1);
  // the right neighbour has read what the earlier calls sent it
  if (!block_wait(c, right.ack_rs, c.ack_want, own.claim, kRsAck, 0)) return;
  for (int s = 0; s < n - 1; ++s) {
    const int chunk = ((d - s - 1) % n + n) % n;
    const uint4* recv = s > 0 ? slot(own.slots_rs, c.ws.cap, s - 1) : nullptr;
    if (s > 0 && !block_wait(c, own.flags_rs + (long long)(s - 1) * mb + b, c.seq, own.claim,
                             kRsData, s - 1))
      return;
    uint4* send = slot(right.slots_rs, c.ws.cap, s);
    for (long long v = v0 + threadIdx.x; v < v1; v += kUnroll * kThreads) {
      uint4 a[kUnroll], r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        long long w = v + u * kThreads;
        if (w < v1) {
          a[u] = x.load(chunk, w);
          if (recv) r[u] = __ldcg(recv + w);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        long long w = v + u * kThreads;
        if (w < v1) send[w] = recv ? Ops<T>::add(a[u], r[u]) : a[u];
      }
    }
    block_signal(right.flags_rs + (long long)s * mb + b, c.seq);
  }
  if (!block_wait(c, own.flags_rs + (long long)(n - 2) * mb + b, c.seq, own.claim, kRsData,
                  n - 2))
    return;
  const uint4* recv = slot(own.slots_rs, c.ws.cap, n - 2);
  for (long long v = v0 + threadIdx.x; v < v1; v += kUnroll * kThreads) {
    uint4 a[kUnroll], r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long w = v + u * kThreads;
      if (w < v1) {
        a[u] = x.load(d, w);
        r[u] = __ldcg(recv + w);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long w = v + u * kThreads;
      if (w < v1) out.store(0, w, Ops<T>::add(a[u], r[u]));
    }
  }
  block_ack(own.ack_rs);  // slots read: the left may refill them
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_ag_kernel(Call c, View<T> x, View<T> out, long long nvec) {
  const int n = c.ws.n, d = c.ws.rank, mb = c.ws.max_blocks, b = blockIdx.x;
  Layout own = layout(c.ws.own, n, mb, c.ws.cap);
  Layout right = layout(c.ws.right, n, mb, c.ws.cap);
  long long v0, v1;
  block_range(nvec, &v0, &v1);
  if (!block_wait(c, right.ack_ag, c.ack_want, own.claim, kAgAck, 0)) return;
  // hop 0: this rank's chunk, to its own output and to the right
  uint4* send = slot(right.slots_ag, c.ws.cap, 0);
  for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
    uint4 a = x.load(0, v);
    out.store(d, v, a);
    send[v] = a;
  }
  block_signal(right.flags_ag + b, c.seq);
  // hop s: chunk (d-s) mod n arrived in slot s-1; keep it, forward it
  for (int s = 1; s < n; ++s) {
    const int chunk = ((d - s) % n + n) % n;
    if (!block_wait(c, own.flags_ag + (long long)(s - 1) * mb + b, c.seq, own.claim, kAgData,
                    s - 1))
      return;
    const uint4* recv = slot(own.slots_ag, c.ws.cap, s - 1);
    uint4* fwd = s < n - 1 ? slot(right.slots_ag, c.ws.cap, s) : nullptr;
    for (long long v = v0 + threadIdx.x; v < v1; v += kUnroll * kThreads) {
      uint4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        long long w = v + u * kThreads;
        if (w < v1) r[u] = __ldcg(recv + w);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        long long w = v + u * kThreads;
        if (w < v1) {
          out.store(chunk, w, r[u]);
          if (fwd) fwd[w] = r[u];
        }
      }
    }
    if (fwd) block_signal(right.flags_ag + (long long)s * mb + b, c.seq);
  }
  block_ack(own.ack_ag);
}

struct Args {
  void *own, *right, *err;
  int n, rank, max_blocks, blocks;
  long long cap, chunk;
  u64 seq, ack_want, timeout_ns;
};

template <typename T>
View<T> make_view(void* p, long long stride, long long row, long long size) {
  View<T> v;
  v.base = static_cast<T*>(p);
  v.stride = stride;
  v.row = row;
  v.size = size;
  v.vec_ok = (stride % Ops<T>::kVec == 0) && (reinterpret_cast<uintptr_t>(p) % 16 == 0);
  return v;
}

Call make_call(const Args& a) {
  Call c;
  c.ws.own = static_cast<char*>(a.own);
  c.ws.right = static_cast<char*>(a.right);
  c.ws.n = a.n;
  c.ws.rank = a.rank;
  c.ws.max_blocks = a.max_blocks;
  c.ws.cap = a.cap;
  c.seq = a.seq;
  c.ack_want = a.ack_want;
  c.timeout_ns = a.timeout_ns;
  c.err = static_cast<volatile u64*>(a.err);
  return c;
}

bool args_ok(const Args& a, int elem) {
  return a.n >= 2 && a.rank >= 0 && a.rank < a.n && a.blocks >= 1 &&
         a.blocks <= a.max_blocks && a.chunk % (16 / elem) == 0 && a.chunk * elem <= a.cap;
}

template <typename T>
int launch_rs(const Args& a, void* x, long long x_stride, long long x_row, long long x_size,
              void* out, long long out_len, cudaStream_t stream) {
  if (!args_ok(a, sizeof(T))) return (int)cudaErrorInvalidValue;
  long long nvec = a.chunk / Ops<T>::kVec;
  ring_rs_kernel<T><<<a.blocks, kThreads, 0, stream>>>(
      make_call(a), make_view<T>(x, x_stride, x_row, x_size),
      make_view<T>(out, out_len, out_len, out_len), nvec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ag(const Args& a, void* x, long long x_len, void* out, long long out_stride,
              long long out_row, long long out_size, cudaStream_t stream) {
  if (!args_ok(a, sizeof(T))) return (int)cudaErrorInvalidValue;
  long long nvec = a.chunk / Ops<T>::kVec;
  ring_ag_kernel<T><<<a.blocks, kThreads, 0, stream>>>(
      make_call(a), make_view<T>(x, x_len, x_len, x_len),
      make_view<T>(out, out_stride, out_row, out_size), nvec);
  return (int)cudaGetLastError();
}

}  // namespace kft_ring

using kft_ring::Args;

// Every function returns a CUDA error code (0 = success).

// Reduce-scatter: x holds n chunks at x[c * x_stride + j] (j < x_row, the
// flat index < x_size, zero elsewhere); out[j] = the ring sum of chunk
// `rank` for j < out_len.
extern "C" int kft_ring_rs(void* x, long long x_stride, long long x_row, long long x_size,
                           void* out, long long out_len, int dtype, void* own, void* right,
                           int n, int rank, int max_blocks, long long cap, long long chunk,
                           int blocks, unsigned long long seq, unsigned long long ack_want,
                           unsigned long long timeout_ns, void* err, void* stream) {
  Args a{own, right, err, n, rank, max_blocks, blocks, cap, chunk, seq, ack_want, timeout_ns};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kft_ring::kFloat32)
    return kft_ring::launch_rs<float>(a, x, x_stride, x_row, x_size, out, out_len, s);
  if (dtype == kft_ring::kBFloat16)
    return kft_ring::launch_rs<__nv_bfloat16>(a, x, x_stride, x_row, x_size, out, out_len, s);
  return (int)cudaErrorInvalidValue;
}

// All-gather: x[j] for j < x_len is this rank's chunk; chunk c lands at
// out[c * out_stride + j] for j < out_row and a flat index < out_size.
extern "C" int kft_ring_ag(void* x, long long x_len, void* out, long long out_stride,
                           long long out_row, long long out_size, int dtype, void* own,
                           void* right, int n, int rank, int max_blocks, long long cap,
                           long long chunk, int blocks, unsigned long long seq,
                           unsigned long long ack_want, unsigned long long timeout_ns, void* err,
                           void* stream) {
  Args a{own, right, err, n, rank, max_blocks, blocks, cap, chunk, seq, ack_want, timeout_ns};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kft_ring::kFloat32)
    return kft_ring::launch_ag<float>(a, x, x_len, out, out_stride, out_row, out_size, s);
  if (dtype == kft_ring::kBFloat16)
    return kft_ring::launch_ag<__nv_bfloat16>(a, x, x_len, out, out_stride, out_row, out_size,
                                              s);
  return (int)cudaErrorInvalidValue;
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
