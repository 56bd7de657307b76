// The peer workspace protocol every ring kernel of the package shares
// (ring.cu: B5-B8, B11; fused_matmul.cu: B9, B10): the workspace layout,
// the flags that replace the TPU kernels' DMA semaphores, bounded waits,
// and the acknowledgement counters that make a slot reusable.
//
// A kernel stores a hop into its peer's slot through a pointer into the
// peer's workspace (cudaIpcOpenMemHandle; NVLink between cards, plain
// device memory when the ranks share a card), then raises a flag there:
// one 64-bit word per (hop, block) holding the call's sequence number.
// Order: data stores, __threadfence_system(), a release store of the flag;
// the reader polls with an acquire load and reads the slot through L2.
// Every wait is bounded by %globaltimer; on expiry the block records the
// kind, hop, block and sequence number in host-mapped memory and exits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kft_ring {

typedef unsigned long long u64;

// The seven kinds of call, each with its own flags, acknowledgement counter
// and slots, so calls of different kinds can interleave in any order
// (ops/peer_memory.py KINDS, in this order).
enum Kind {
  kRs = 0,
  kAg = 1,
  kFusedRs = 2,
  kFusedAg = 3,
  kShift = 4,
  kAgMm = 5,
  kMmRs = 6,
  kKinds = 7
};
// error kinds recorded in err[0]: 1 + 2 * kind for a data wait, 2 + 2 *
// kind for an acknowledgement wait
__host__ __device__ constexpr int err_data(int kind) { return 1 + 2 * kind; }
__host__ __device__ constexpr int err_ack(int kind) { return 2 + 2 * kind; }

// Workspace layout, the same on every rank (ops/peer_memory.py builds it):
//   u64 flags[kKinds][n-1][max_blocks], u64 ack[kKinds] (blocks that read
//   their slots, all calls of that kind), u64 claim (header padded to 4096
//   bytes), then each kind's slots.  Where a kind's slots start and how
//   large one is are peer_memory's business: a call receives only its own
//   kind's (`slots`, the byte offset from the workspace's base, and
//   `slot_bytes`), the same on every rank.
struct Workspace {
  char* own;
  char* right;  // the peer a kernel stores into: rank + 1, or rank + shift
  int n, rank, max_blocks;
  long long slots;       // byte offset of this call's kind's first slot
  long long slot_bytes;  // bytes of one of its slots
};

__host__ __device__ inline long long header_bytes(int n, int max_blocks) {
  long long words = (long long)kKinds * (n - 1) * max_blocks + kKinds + 1;
  return (words * 8 + 4095) / 4096 * 4096;
}

struct Layout {
  u64* flags;  // of this kind: flags[hop * max_blocks + block]
  u64* ack;    // of this kind
  u64* claim;
  char* slots;  // slot s at slots + s * slot_bytes
  long long slot_bytes;
};

__device__ inline Layout layout(const Workspace& ws, char* base, int kind) {
  const int n = ws.n, mb = ws.max_blocks;
  u64* w = reinterpret_cast<u64*>(base);
  Layout l;
  l.flags = w + (long long)kind * (n - 1) * mb;
  l.ack = w + (long long)kKinds * (n - 1) * mb + kind;
  l.claim = w + (long long)kKinds * (n - 1) * mb + kKinds;
  l.slots = base + ws.slots;
  l.slot_bytes = ws.slot_bytes;
  return l;
}

__device__ __forceinline__ char* slot(const Layout& l, int s) {
  return l.slots + (long long)s * l.slot_bytes;
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

// Block b's share of `count` items: [v0, v1).
__device__ __forceinline__ void block_range(long long count, long long* v0, long long* v1) {
  long long per = (count + gridDim.x - 1) / gridDim.x;
  *v0 = min(count, (long long)blockIdx.x * per);
  *v1 = min(count, *v0 + per);
}

// ------------------------------------------------------------ launch ----

struct Args {
  void *own, *right, *err;
  int n, rank, max_blocks, blocks;
  long long slots, slot_bytes, chunk;
  u64 seq, ack_want, timeout_ns;
};

inline Call make_call(const Args& a) {
  Call c;
  c.ws.own = static_cast<char*>(a.own);
  c.ws.right = static_cast<char*>(a.right);
  c.ws.n = a.n;
  c.ws.rank = a.rank;
  c.ws.max_blocks = a.max_blocks;
  c.ws.slots = a.slots;
  c.ws.slot_bytes = a.slot_bytes;
  c.seq = a.seq;
  c.ack_want = a.ack_want;
  c.timeout_ns = a.timeout_ns;
  c.err = static_cast<volatile u64*>(a.err);
  return c;
}

inline bool args_ok(const Args& a) {
  return a.n >= 2 && a.rank >= 0 && a.rank < a.n && a.blocks >= 1 &&
         a.blocks <= a.max_blocks && a.slots >= header_bytes(a.n, a.max_blocks) &&
         a.slots % 16 == 0 && a.slot_bytes % 16 == 0;
}

}  // namespace kft_ring

// The arguments every ring entry point ends with, in this order
// (ops/_build.py `_RING`).
#define KFT_RING_PARAMS                                                                      \
  void *own, void *right, int n, int rank, int max_blocks, long long slots,                  \
      long long slot_bytes, long long chunk, int blocks, unsigned long long seq,             \
      unsigned long long ack_want, unsigned long long timeout_ns, void *err, void *stream
#define KFT_RING_ARGS                                                                        \
  kft_ring::Args {                                                                           \
    own, right, err, n, rank, max_blocks, blocks, slots, slot_bytes, chunk, seq, ack_want,   \
        timeout_ns                                                                           \
  }
