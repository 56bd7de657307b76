// Flash attention for head dims over 128 on Hopper (sm_90a): the forward
// (O and lse), dq, and dk/dv (MHA, and GQA with Hkv < H kv heads).
//
// Replace the TPU kernels kungfu_tpu/ops/flash.py `_fwd_kernel`,
// `_bwd_dq_kernel`, `_bwd_dkv_kernel` and `_bwd_dkv_gqa_kernel` (body
// `_dkv_accum`) at the head dims their Hopper counterparts in flash_fwd.cu
// and flash_bwd.cu do not take: those keep a whole row of the output (O,
// dQ, or dK and dV) in one warpgroup's registers, which past 128 columns
// does not fit (dK and dV at D = 256 would take 256 registers a thread).
// The Pallas kernels take the whole head dim as one block.  The arithmetic
// is theirs and the other kernels': float statistics, the scale applied to
// the float scores, P and dS rounded to the operand type before they
// enter a product, every accumulator float; lse = m + log(l);
// dS = P * (dP - delta) with P in float, delta = rowsum(dO * O) - g_lse
// from outside.  No atomics on an output: results are the same run to run.
//
// Two bodies; one shape goes to exactly one of them (`mma_dim`):
//
// The backward in bf16 and fp16 at head dims 136-256 (namespace `mma`,
// wgmma; pieces from flash_sm90.cuh).  Tiles are padded to DP = 192 or 256
// columns with zeros in shared memory, never in device memory, and the
// padded columns are not stored.
//  - A block is two consumer warpgroups (256 threads) owning 64 output
//    rows: query rows for dq, key rows for dk/dv.  Warpgroup w keeps its
//    128-column slab (64-column panels 2w, 2w + 1) of the output
//    accumulators in registers for the whole block and stores it once:
//    dq 64 floats a thread, dk/dv 64 + 64.
//  - S and dP once a tile, over the whole head dim (m64n64k16, 12 or 16
//    k-steps in order): warpgroup 0 computes S (dk/dv: S^T = K Q^T),
//    warpgroup 1 dP (dP^T = V dO^T).  Warpgroup 0 forms P and shares it as
//    float (16 KB), warpgroup 1 forms dS and shares it as packed A
//    fragments in the operand type (8 KB), both slot by slot in the
//    accumulator's register layout, so no layout changes hands.  Then each
//    warpgroup runs its slab's products with register A operands
//    (dQ += dS K; dV += P^T dO, dK += dS^T Q), the B operand the same
//    shared tile read MN-major.  At DP = 192 warpgroup 1 has one panel and
//    repeats it into an accumulator that is never stored (no branch
//    around a wgmma).
//  - Shared memory at DP = 256: the resident tiles (Q and dO for dq, K and
//    V for dk/dv) 64 KB, a ring of two 64 KB stages of the streamed side
//    (K and V; Q, dO, lse and delta), filled by cp.async one tile ahead,
//    and the 24 KB exchange: 217-218 KB of the 227 KB a block may take.
//  - Balance for a small group count: the query-head group of each key
//    tile is split over `parts` blocks (chosen by ops/flash.py
//    `wide_dkv_parts`).  Each part stores its f32 partial dK and dV to
//    scratch the wrapper allocates; the last block of a key tile to finish
//    (a per-tile counter the wrapper zeroes) sums the parts in their fixed
//    order and stores dK and dV, so the sum is the same run to run.
//  - The heaviest blocks start first: high query blocks for dq, low key
//    blocks for dk/dv.
//
// The slab body, the first design (namespace `wide`): the forward at every head dim over
// 128, and the backward in f32 and at head dims over 256 (at D > 256 even
// the resident 64-row tiles with one stage of the streamed side pass the
// 227 KB of shared memory).  128 threads, 64-row blocks, an output slab of
// 128 columns a block on a grid axis of ceil(D / 128) slabs, S and dP
// recomputed a slab and summed over 64-column chunks through shared
// memory; WMMA 16x16x16 in bf16 and fp16 with float accumulators in
// shared memory, float FMA loops in f32 (TF32 would miss the f32 limit of
// 1e-5 in utils/compare.py).  Rows past L and columns past D read as zeros
// and are not stored.  Causal and windowed masks skip whole tiles.
//
// What bounds it on the card: at the Gemma-2B attention shape (B = 1,
// H = 8, Hkv = 1, L = 8192, D = 256, causal) the forward does ~275 GFLOP,
// dq ~412 and dk/dv ~550 against 67-134 MB of operands, so the tensor
// cores bound all three (0.28, 0.42, 0.56 ms at 989 TFLOP/s).  PERF.md has
// both bodies' times.
#include <mma.h>

#include "flash_sm90.cuh"

namespace kft {
namespace wide {

constexpr int kRows = 64;   // output rows of a block
constexpr int kKeys = 64;   // key rows a step (forward, dq)
constexpr int kChunk = 64;  // head-dim columns of one S / dP chunk
constexpr int kSlab = 128;  // output columns of a block
constexpr int kLdC = Ld<kChunk>::op;  // [rows, 64] operand chunks
constexpr int kLdS = Ld<kSlab>::op;   // [rows, 128] operand slabs
constexpr int kLdA = Ld<kSlab>::acc;  // [rows, 128] float accumulators

// query rows a dk/dv step: f32 tiles would not fit shared memory at 64
template <typename T>
struct DkvRows {
  static constexpr int value = std::is_same<T, float>::value ? 32 : 64;
};

// One warp: C[16x16] (float, shared, ldc) = (or +=) A[16xK] * B[Kx16],
// layouts as kft::warp_mma; WMMA for 16-bit operands, FMA loops for float.
template <typename T, bool A_ROW, bool B_ROW, int K>
__device__ __forceinline__ void tile_mma(float* c, int ldc, const T* a, int lda, const T* b,
                                         int ldb, bool accumulate) {
  if constexpr (std::is_same<T, float>::value) {
    warp_mma<A_ROW, B_ROW, K>(c, ldc, a, lda, b, ldb, accumulate);
  } else {
    using namespace nvcuda;
    using LA = typename std::conditional<A_ROW, wmma::row_major, wmma::col_major>::type;
    using LB = typename std::conditional<B_ROW, wmma::row_major, wmma::col_major>::type;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> fb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
    if (accumulate) {
      wmma::load_matrix_sync(fc, c, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(fc, 0.f);
    }
#pragma unroll
    for (int k = 0; k < K; k += 16) {
      wmma::load_matrix_sync(fa, A_ROW ? a + k : a + k * lda, lda);
      wmma::load_matrix_sync(fb, B_ROW ? b + k * ldb : b + k, ldb);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(c, fc, ldc, wmma::mem_row_major);
  }
}

// ----------------------------------------------------------- forward ----
// Grid (ceil(L / 64), B * H, slabs).  Warp w owns rows 16w..16w+15.

template <typename T>
constexpr size_t fwd_smem_bytes() {
  return (2 * kRows * kLdC + kKeys * kLdS + kRows * kLdProb) * sizeof(T) +
         (kRows * kLdScore + kRows * kLdA) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int L, int D,
               float scale, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qc = reinterpret_cast<T*>(smem);
  T* Kc = Qc + kRows * kLdC;
  T* Vs = Kc + kKeys * kLdC;
  T* Ps = Vs + kKeys * kLdS;
  float* S = reinterpret_cast<float*>(Ps + kRows * kLdProb);
  float* Oacc = S + kRows * kLdScore;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int c0 = blockIdx.z * kSlab;  // the slab's first output column
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const T* qb = q + ((int64_t)b * L * H + h) * D;
  const T* kb = k + ((int64_t)b * L * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * L * Hkv + hk) * D;

  for (int i = threadIdx.x; i < kRows * kLdA; i += kThreads) Oacc[i] = 0.f;
  float m_i[16], l_i[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
  }

  // key tiles [lo, hi): causal stops after the diagonal, the window starts
  // at the first tile any row of this query block still sees
  const int nk = (L + kKeys - 1) / kKeys;
  const int hi = causal ? min(nk, (q0 + kRows + kKeys - 1) / kKeys) : nk;
  const int lo = (causal && window > 0) ? max(0, (q0 - window + 1) / kKeys) : 0;

  const int row0 = warp * 16;
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kKeys;
    // S[rows, 64] = Q K^T, summed over the head dim a 64-column chunk at a time
    for (int c = 0; c < D; c += kChunk) {
      __syncthreads();  // every warp is done with the tiles
      load_rows<T, kRows, kChunk>(Qc, kLdC, qb + c, q_stride, q0, L, D - c);
      load_rows<T, kKeys, kChunk>(Kc, kLdC, kb + c, kv_stride, k0, L, D - c);
      if (c == 0) load_rows<T, kKeys, kSlab>(Vs, kLdS, vb + c0, kv_stride, k0, L, D - c0);
      __syncthreads();
#pragma unroll
      for (int tn = 0; tn < kKeys / 16; ++tn)
        tile_mma<T, true, false, kChunk>(S + row0 * kLdScore + tn * 16, kLdScore,
                                         Qc + row0 * kLdC, kLdC, Kc + tn * 16 * kLdC, kLdC,
                                         c > 0);
    }
    __syncwarp();

    // online softmax over the warp's rows; each lane holds two columns
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const int qp = q0 + r;
      float s0 = S[r * kLdScore + lane] * scale;
      float s1 = S[r * kLdScore + lane + 32] * scale;
      if (!attend(qp, k0 + lane, L, causal, window)) s0 = kNegInf;
      if (!attend(qp, k0 + lane + 32, L, causal, window)) s1 = kNegInf;
      const float m_new = fmaxf(m_i[rr], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float corr = expf(m_i[rr] - m_new);
      l_i[rr] = l_i[rr] * corr + warp_sum(p0 + p1);
      m_i[rr] = m_new;
      Ps[r * kLdProb + lane] = from_f<T>(p0);
      Ps[r * kLdProb + lane + 32] = from_f<T>(p1);
      for (int cc = lane; cc < kSlab; cc += 32) Oacc[r * kLdA + cc] *= corr;
    }
    __syncwarp();

    // Oacc[rows, slab] += P[rows, 64] V[64, slab]
#pragma unroll
    for (int tn = 0; tn < kSlab / 16; ++tn)
      tile_mma<T, true, true, kKeys>(Oacc + row0 * kLdA + tn * 16, kLdA, Ps + row0 * kLdProb,
                                     kLdProb, Vs + tn * 16, kLdS, true);
  }
  __syncwarp();

  T* ob = o + ((int64_t)b * L * H + h) * D + c0;
  float* lb = lse + (int64_t)bh * L;
  const int width = min(kSlab, D - c0);
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int qp = q0 + row0 + rr;
    if (qp >= L) continue;
    const float l_safe = l_i[rr] == 0.f ? 1.f : l_i[rr];
    for (int cc = lane; cc < width; cc += 32)
      ob[qp * q_stride + cc] = from_f<T>(Oacc[(row0 + rr) * kLdA + cc] / l_safe);
    if (blockIdx.z == 0 && lane == 0) lb[qp] = m_i[rr] + logf(l_safe);
  }
}

// ---------------------------------------------------------------- dq ----
// Grid (ceil(L / 64), B * H, slabs).  Warp w owns query rows 16w..16w+15.

template <typename T>
constexpr size_t dq_smem_bytes() {
  return (4 * kRows * kLdC + kKeys * kLdS + kRows * kLdProb) * sizeof(T) +
         (2 * kRows * kLdScore + kRows * kLdA) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int H, int Hkv, int L, int D,
              float scale, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qc = reinterpret_cast<T*>(smem);
  T* dOc = Qc + kRows * kLdC;
  T* Kc = dOc + kRows * kLdC;
  T* Vc = Kc + kKeys * kLdC;
  T* Ks = Vc + kKeys * kLdC;
  T* dSs = Ks + kKeys * kLdS;
  float* S = reinterpret_cast<float*>(dSs + kRows * kLdProb);
  float* dP = S + kRows * kLdScore;
  float* dQacc = dP + kRows * kLdScore;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int c0 = blockIdx.z * kSlab;
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t q_off = ((int64_t)b * L * H + h) * D;
  const T* kb = k + ((int64_t)b * L * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * L * Hkv + hk) * D;

  for (int i = threadIdx.x; i < kRows * kLdA; i += kThreads) dQacc[i] = 0.f;
  const int row0 = warp * 16;
  float lse_i[16], dl_i[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int qp = q0 + row0 + rr;
    lse_i[rr] = qp < L ? lse[(int64_t)bh * L + qp] : 0.f;
    dl_i[rr] = qp < L ? delta[(int64_t)bh * L + qp] : 0.f;
  }

  const int nk = (L + kKeys - 1) / kKeys;
  const int hi = causal ? min(nk, (q0 + kRows + kKeys - 1) / kKeys) : nk;
  const int lo = (causal && window > 0) ? max(0, (q0 - window + 1) / kKeys) : 0;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kKeys;
    // S = Q K^T and dP = dO V^T, [rows, 64] each, over 64-column chunks
    for (int c = 0; c < D; c += kChunk) {
      __syncthreads();
      load_rows<T, kRows, kChunk>(Qc, kLdC, q + q_off + c, q_stride, q0, L, D - c);
      load_rows<T, kRows, kChunk>(dOc, kLdC, dout + q_off + c, q_stride, q0, L, D - c);
      load_rows<T, kKeys, kChunk>(Kc, kLdC, kb + c, kv_stride, k0, L, D - c);
      load_rows<T, kKeys, kChunk>(Vc, kLdC, vb + c, kv_stride, k0, L, D - c);
      if (c == 0) load_rows<T, kKeys, kSlab>(Ks, kLdS, kb + c0, kv_stride, k0, L, D - c0);
      __syncthreads();
#pragma unroll
      for (int tn = 0; tn < kKeys / 16; ++tn) {
        tile_mma<T, true, false, kChunk>(S + row0 * kLdScore + tn * 16, kLdScore,
                                         Qc + row0 * kLdC, kLdC, Kc + tn * 16 * kLdC, kLdC,
                                         c > 0);
        tile_mma<T, true, false, kChunk>(dP + row0 * kLdScore + tn * 16, kLdScore,
                                         dOc + row0 * kLdC, kLdC, Vc + tn * 16 * kLdC, kLdC,
                                         c > 0);
      }
    }
    __syncwarp();

#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const int qp = q0 + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cc = lane + 32 * half;
        const float p = attend(qp, k0 + cc, L, causal, window)
                            ? expf(S[r * kLdScore + cc] * scale - lse_i[rr])
                            : 0.f;
        dSs[r * kLdProb + cc] = from_f<T>(p * (dP[r * kLdScore + cc] - dl_i[rr]));
      }
    }
    __syncwarp();

    // dQacc[rows, slab] += dS[rows, 64] K[64, slab]
#pragma unroll
    for (int tn = 0; tn < kSlab / 16; ++tn)
      tile_mma<T, true, true, kKeys>(dQacc + row0 * kLdA + tn * 16, kLdA, dSs + row0 * kLdProb,
                                     kLdProb, Ks + tn * 16, kLdS, true);
  }
  __syncthreads();
  store_rows<T, kRows, kSlab>(dq + q_off + c0, q_stride, q0, L, D - c0, dQacc, kLdA, scale);
}

// ------------------------------------------------------------- dk/dv ----
// Grid (ceil(L / 64), B * Hkv, slabs).  A block owns 64 key rows of one
// (batch, kv head) and walks the query rows that see them, BQ at a time,
// for each query head of the kv head's group in turn (one for MHA).  Warp
// w owns key rows 16w..16w+15 of dK and dV.

template <typename T>
constexpr size_t dkv_smem_bytes() {
  constexpr int BQ = DkvRows<T>::value;
  return (2 * kRows * kLdC + 2 * BQ * kLdC + 2 * BQ * kLdS + 2 * BQ * kLdProb) * sizeof(T) +
         (2 * BQ * kLdScore + 2 * kRows * kLdA + 2 * BQ) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
               int Hkv, int L, int D, float scale, int causal, int window) {
  constexpr int BQ = DkvRows<T>::value;
  constexpr int kTilesQK = (BQ / 16) * (kRows / 16);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Kc = reinterpret_cast<T*>(smem);
  T* Vc = Kc + kRows * kLdC;
  T* Qc = Vc + kRows * kLdC;
  T* dOc = Qc + BQ * kLdC;
  T* Qs = dOc + BQ * kLdC;
  T* dOs = Qs + BQ * kLdS;
  T* Ps = dOs + BQ * kLdS;
  T* dSs = Ps + BQ * kLdProb;
  float* S = reinterpret_cast<float*>(dSs + BQ * kLdProb);
  float* dP = S + BQ * kLdScore;
  float* dKacc = dP + BQ * kLdScore;
  float* dVacc = dKacc + kRows * kLdA;
  float* lse_s = dVacc + kRows * kLdA;
  float* dl_s = lse_s + BQ;

  const int warp = threadIdx.x >> 5;
  const int row0 = warp * 16;
  const int k0 = blockIdx.x * kRows;
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int c0 = blockIdx.z * kSlab;
  const int group = H / Hkv;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t kv_off = ((int64_t)b * L * Hkv + hk) * D;
  const int64_t stride = (int64_t)H * D;

  for (int i = threadIdx.x; i < kRows * kLdA; i += kThreads) {
    dKacc[i] = 0.f;
    dVacc[i] = 0.f;
  }
  // queries that see keys [k0, k0 + 64): causal from the block's first
  // key; window up to window-1 rows past its last key
  const int q_start = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(L, k0 + kRows - 1 + window) : L;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t bh = (int64_t)b * H + h;
    const int64_t off = ((int64_t)b * L * H + h) * D;
    for (int i0 = (q_start / BQ) * BQ; i0 < q_end; i0 += BQ) {
      // S = Q K^T and dP = dO V^T, [BQ, 64] each, over 64-column chunks,
      // tiles dealt round the warps
      for (int c = 0; c < D; c += kChunk) {
        __syncthreads();
        load_rows<T, BQ, kChunk>(Qc, kLdC, q + off + c, stride, i0, L, D - c);
        load_rows<T, BQ, kChunk>(dOc, kLdC, dout + off + c, stride, i0, L, D - c);
        load_rows<T, kRows, kChunk>(Kc, kLdC, k + kv_off + c, kv_stride, k0, L, D - c);
        load_rows<T, kRows, kChunk>(Vc, kLdC, v + kv_off + c, kv_stride, k0, L, D - c);
        if (c == 0) {
          load_rows<T, BQ, kSlab>(Qs, kLdS, q + off + c0, stride, i0, L, D - c0);
          load_rows<T, BQ, kSlab>(dOs, kLdS, dout + off + c0, stride, i0, L, D - c0);
          load_vec(lse_s, lse + bh * L, i0, BQ, L);
          load_vec(dl_s, delta + bh * L, i0, BQ, L);
        }
        __syncthreads();
        for (int e = warp; e < 2 * kTilesQK; e += kWarps) {
          const bool is_s = e < kTilesQK;
          const int idx = is_s ? e : e - kTilesQK;
          const int tm = idx / (kRows / 16);
          const int tn = idx % (kRows / 16);
          tile_mma<T, true, false, kChunk>((is_s ? S : dP) + tm * 16 * kLdScore + tn * 16,
                                           kLdScore, (is_s ? Qc : dOc) + tm * 16 * kLdC, kLdC,
                                           (is_s ? Kc : Vc) + tn * 16 * kLdC, kLdC, c > 0);
        }
      }
      __syncthreads();

      for (int e = threadIdx.x; e < BQ * kRows; e += kThreads) {
        const int r = e / kRows;
        const int cc = e % kRows;
        const int qp = i0 + r;
        // padded query rows carry no lse; mask them by position
        const float p = (qp < L && attend(qp, k0 + cc, L, causal, window))
                            ? expf(S[r * kLdScore + cc] * scale - lse_s[r])
                            : 0.f;
        Ps[r * kLdProb + cc] = from_f<T>(p);
        dSs[r * kLdProb + cc] = from_f<T>(p * (dP[r * kLdScore + cc] - dl_s[r]));
      }
      __syncthreads();

      // dV[rows, slab] += P^T dO and dK[rows, slab] += dS^T Q for this warp's key rows
#pragma unroll
      for (int tn = 0; tn < kSlab / 16; ++tn) {
        tile_mma<T, false, true, BQ>(dVacc + row0 * kLdA + tn * 16, kLdA, Ps + row0, kLdProb,
                                     dOs + tn * 16, kLdS, true);
        tile_mma<T, false, true, BQ>(dKacc + row0 * kLdA + tn * 16, kLdA, dSs + row0, kLdProb,
                                     Qs + tn * 16, kLdS, true);
      }
    }
  }
  __syncthreads();
  store_rows<T, kRows, kSlab>(dk + kv_off + c0, kv_stride, k0, L, D - c0, dKacc, kLdA, scale);
  store_rows<T, kRows, kSlab>(dv + kv_off + c0, kv_stride, k0, L, D - c0, dVacc, kLdA, 1.f);
}


// ------------------------------------------------------ wgmma body ----
// bf16 and fp16, kernel head dims 136-256 (DP = 192 or 256).

namespace mma {

using namespace kft::sm90;

constexpr int kThreads = 2 * kWgThreads;  // two consumer warpgroups
constexpr int kRows = 64;                 // output rows of a block
constexpr int kTile = 64;                 // rows of a streamed tile
constexpr int kStages = 2;                // the streamed ring: one tile in flight
constexpr int kSlots = 32;                // floats of an m64n64 accumulator a thread
constexpr int kAccSlots = 4 * kSlots;     // dK and dV slabs: the partial of a thread
constexpr int kXP = kSlots * kWgThreads * 4;  // P, float, slot-major: 16 KB
constexpr int kXdS = 16 * kWgThreads * 4;     // dS A fragments, 4 k-steps x 4: 8 KB

// Shared memory, bytes (+1024 to align the tiles to the swizzle atom).
template <int DP>
struct DqSmem {
  static constexpr int kTileB = 64 * DP * 2;
  static constexpr int kStage = 2 * kTileB;  // after Q, dO; stage s: K at +2s kTileB, V after
  static constexpr int kXPOff = kStage + kStages * 2 * kTileB;
  static constexpr int kXdSOff = kXPOff + kXP;
  static constexpr int kBytes = kXdSOff + kXdS + 1024;
  static_assert(kTileB % 1024 == 0, "tiles start on swizzle atoms");
  static_assert(kBytes <= 232448, "one block's shared memory");
};
template <int DP>
struct DkvSmem {
  static constexpr int kTileB = 64 * DP * 2;
  static constexpr int kStage = 2 * kTileB;  // after K, V; stage s: Q at +2s kTileB, dO after
  static constexpr int kVecOff = kStage + kStages * 2 * kTileB;  // stage s: lse, delta
  static constexpr int kVec = 2 * kTile * 4;
  static constexpr int kXPOff = kVecOff + kStages * kVec;
  static constexpr int kXdSOff = kXPOff + kXP;
  static constexpr int kFlagOff = kXdSOff + kXdS;
  static constexpr int kBytes = kFlagOff + 16 + 1024;
  static_assert(kTileB % 1024 == 0, "tiles start on swizzle atoms");
  static_assert(kBytes <= 232448, "one block's shared memory");
};

// The warpgroup of this thread, as a value the compiler knows is uniform
// over the warp (so a wgmma after it is not serialized).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
}

// Start the copy of rows [r0, r0 + R) x columns [0, D) into a swizzled
// tile of DP / 64 panels, a panel at a time (256 threads, 8 16-byte chunks
// a panel row).
template <int R, int DP, typename T>
__device__ __forceinline__ void load_panels(uint32_t tile, const T* g, int64_t stride, int r0,
                                            int nrows, int D, int tid) {
#pragma unroll
  for (int p = 0; p < DP / 64; ++p)
    load_tile<R, 64, kThreads>(tile + p * (R * 128), g + 64 * p, stride, r0, nrows, D - 64 * p,
                               tid);
}

// Store warpgroup slab acc[2][32] (columns col0 .. col0 + 127; this
// thread's rows row_lo and row_lo + 8) times mul into rows < L and
// columns < D of a [*, D] matrix with row stride `stride`.
template <typename T>
__device__ __forceinline__ void store_slab(T* g, int64_t stride, int row_lo, int L, int D,
                                           int col0, const float (&acc)[2][kSlots], float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int i = 0; i < kSlots; i += 2) {
      const int row = row_lo + 8 * ((i >> 1) & 1);
      const int col = col0 + 64 * n + 8 * (i >> 2) + 2 * t;
      if (row < L && col < D)
        *reinterpret_cast<uint32_t*>(g + row * stride + col) =
            pack2<T>(acc[n][i] * mul, acc[n][i + 1] * mul);
    }
  }
}

__device__ __forceinline__ void fence_slab(float (&acc)[2][kSlots]) {
  reg_fence(acc[0]);
  reg_fence(acc[1]);
}

// dq: grid (B * H, ceil(L / 64)).  A block owns query rows q0 .. q0 + 63
// of one (batch, head) and walks the key tiles that can see them.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int H, int Hkv, int L, int D,
              float scale, int causal, int window) {
  using S = DqSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sdO = sQ + S::kTileB;
  float* xp = reinterpret_cast<float*>(smem + S::kXPOff);
  uint32_t* xds = reinterpret_cast<uint32_t*>(smem + S::kXdSOff);

  const int tid = threadIdx.x;
  const int wg = warpgroup();
  const int wt = tid % kWgThreads;  // thread of the warpgroup
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // the latest (heaviest) first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t q_off = ((int64_t)b * L * H + h) * D;
  const T* kb = k + ((int64_t)b * L * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * L * Hkv + hk) * D;

  if (D < DP) {
    zero_pad<kRows, DP, kThreads>(smem, D, tid);
    zero_pad<kRows, DP, kThreads>(smem + S::kTileB, D, tid);
    for (int s = 0; s < 2 * kStages; ++s)
      zero_pad<kTile, DP, kThreads>(smem + S::kStage + s * S::kTileB, D, tid);
  }

  // key tiles [lo, hi): causal stops after the block's last row, the
  // window starts at the first key its first row still sees
  const int nk = (L + kTile - 1) / kTile;
  const int hi = causal ? min(nk, (q0 + kRows + kTile - 1) / kTile) : nk;
  const int lo = (causal && window > 0) ? max(0, (q0 - window + 1) / kTile) : 0;

  auto stage = [&](int j) { return sQ + S::kStage + ((j - lo) % kStages) * 2 * S::kTileB; };
  auto load_kv = [&](int j) {
    load_panels<kTile, DP>(stage(j), kb, kv_stride, j * kTile, L, D, tid);
    load_panels<kTile, DP>(stage(j) + S::kTileB, vb, kv_stride, j * kTile, L, D, tid);
  };
  load_panels<kRows, DP>(sQ, q + q_off, q_stride, q0, L, D, tid);
  load_panels<kRows, DP>(sdO, dout + q_off, q_stride, q0, L, D, tid);
  if (lo < hi) load_kv(lo);
  cp_async_commit();

  const int row_lo = q0 + (wt >> 5) * 16 + ((wt & 31) >> 2);  // and row_lo + 8
  const int t = wt & 3;
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row_lo + 8 * e;
    lse2[e] = row < L ? lse[(int64_t)bh * L + row] * kLog2e : 0.f;
    dl[e] = row < L ? delta[(int64_t)bh * L + row] : 0.f;
  }

  float acc[2][kSlots];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < kSlots; ++i) acc[n][i] = 0.f;
  uint32_t a[4][4];
  // warpgroup 0: S = Q K^T; warpgroup 1: dP = dO V^T
  const uint32_t sA = wg == 0 ? sQ : sdO;
  // the slab's panels (at DP = 192 warpgroup 1 repeats its one panel)
  const int pn0 = min(2 * wg, DP / 64 - 1);
  const int pn1 = min(2 * wg + 1, DP / 64 - 1);

  for (int j = lo; j < hi; ++j) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // tile j is in, and every read of tile j - 1 is done
    if (j + 1 < hi) load_kv(j + 1);
    cp_async_commit();
    const int k0 = j * kTile;
    // whether any (row, key) pair of the block and this tile is attended
    const bool act =
        q0 < L && (!causal || k0 <= q0 + 63) && (window <= 0 || k0 + 63 > q0 - window);
    if (!act) continue;
    const uint32_t sK = stage(j);
    const uint32_t sB = wg == 0 ? sK : sK + S::kTileB;
    float sc[kSlots];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      mma_ss<T>(sc, desc_k<kRows>(sA, 0, ks), desc_k<kTile>(sB, 0, ks), ks > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);

    if (wg == 0) {  // P = exp(scale s - lse), shared as float
      const bool mask = (causal && k0 + 63 > q0) || (window > 0 && q0 + 63 - k0 >= window) ||
                        k0 + kTile > L;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int e = (i >> 1) & 1;
        float p = fast_exp2(sc[i] * scale_log2 - lse2[e]);
        if (mask &&
            !attend(row_lo + 8 * e, k0 + 8 * (i >> 2) + 2 * t + (i & 1), L, causal, window))
          p = 0.f;
        xp[i * kWgThreads + wt] = p;
      }
    }
    __syncthreads();
    if (wg == 1) {  // dS = P (dP - delta), shared as the A fragments of dQ += dS K
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;  // row row_lo + 8 (e & 1)
          const float d0 = xp[i * kWgThreads + wt] * (sc[i] - dl[e & 1]);
          const float d1 = xp[(i + 1) * kWgThreads + wt] * (sc[i + 1] - dl[e & 1]);
          a[kk][e] = pack2<T>(d0, d1);
          xds[(4 * kk + e) * kWgThreads + wt] = a[kk][e];
        }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[kk][e] = xds[(4 * kk + e) * kWgThreads + wt];
    }
    // dQ[:, slab] += dS K[:, slab]: K read transposed from the same tile
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs<T>(acc[0], a[kk], desc_mn<kTile>(sK, pn0, kk), 1);
      mma_rs<T>(acc[1], a[kk], desc_mn<kTile>(sK, pn1, kk), 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_slab(acc);
    fence_frag(a);
  }
  cp_async_wait<0>();
  if (q0 < L) store_slab<T>(dq + q_off, q_stride, row_lo, L, D, 128 * wg, acc, scale);
}

// dk/dv: grid (B * Hkv * parts, ceil(L / 64)).  A block owns key rows
// k0 .. k0 + 63 of kv head hk and walks the query tiles that see them, for
// each query head of its part of the group (G = H / Hkv query heads, G /
// parts a part; MHA is one head, fixed at compile time).  With parts > 1
// each block stores its f32 partial, slot-major ([tiles, parts, 128 slots,
// 256 threads]: this thread's dK then dV slab in register order) to
// `partial`, and the last of a key tile's blocks (counter `done`, zeroed
// by the wrapper) sums the parts in order 0 .. parts - 1 and stores dK and
// dV.
template <typename T, int DP, bool kGqa>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ partial, int* __restrict__ done, int parts, int H, int Hkv,
               int L, int D, float scale, int causal, int window) {
  using S = DkvSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + S::kTileB;
  float* xp = reinterpret_cast<float*>(smem + S::kXPOff);
  uint32_t* xds = reinterpret_cast<uint32_t*>(smem + S::kXdSOff);

  const int tid = threadIdx.x;
  const int wg = warpgroup();
  const int wt = tid % kWgThreads;
  const int k0 = blockIdx.y * kRows;  // the earliest keys (the most queries) first
  const int part = blockIdx.x % parts;
  const int bhk = blockIdx.x / parts;
  const int b = bhk / Hkv;
  const int hk = bhk % Hkv;
  const int group = kGqa ? H / Hkv : 1;
  const int heads = group / parts;  // query heads of this block
  const int h0 = hk * group + part * heads;
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t kv_off = ((int64_t)b * L * Hkv + hk) * D;

  if (D < DP) {
    zero_pad<kRows, DP, kThreads>(smem, D, tid);
    zero_pad<kRows, DP, kThreads>(smem + S::kTileB, D, tid);
    for (int s = 0; s < 2 * kStages; ++s)
      zero_pad<kTile, DP, kThreads>(smem + S::kStage + s * S::kTileB, D, tid);
  }

  // query tiles: causal from the block's first key, the window up to
  // window-1 rows past its last key; then the same for each head of the part
  const int q_begin = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(L, k0 + kRows - 1 + window) : L;
  const int nt = (q_end - q_begin + kTile - 1) / kTile;
  const int total = heads * nt;

  auto stage = [&](int it) { return sK + S::kStage + (it % kStages) * 2 * S::kTileB; };
  auto load_q = [&](int it) {
    const int hq = h0 + it / nt;
    const int i0 = q_begin + (it % nt) * kTile;
    const int64_t off = ((int64_t)b * L * H + hq) * D;
    load_panels<kTile, DP>(stage(it), q + off, q_stride, i0, L, D, tid);
    load_panels<kTile, DP>(stage(it) + S::kTileB, dout + off, q_stride, i0, L, D, tid);
    if (tid < 2 * kTile) {  // threads 0-63 copy lse, 64-127 delta
      const int r = tid % kTile;
      const float* src = (tid < kTile ? lse : delta) + ((int64_t)b * H + hq) * L;
      const bool ok = i0 + r < L;
      cp_async4(sK + S::kVecOff + (it % kStages) * S::kVec + tid * 4, src + (ok ? i0 + r : 0),
                ok);
    }
  };
  load_panels<kRows, DP>(sK, k + kv_off, kv_stride, k0, L, D, tid);
  load_panels<kRows, DP>(sV, v + kv_off, kv_stride, k0, L, D, tid);
  if (total > 0) load_q(0);
  cp_async_commit();

  const int row_lo = k0 + (wt >> 5) * 16 + ((wt & 31) >> 2);  // and row_lo + 8
  const int t = wt & 3;
  const float scale_log2 = scale * kLog2e;

  float dk_acc[2][kSlots], dv_acc[2][kSlots];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      dk_acc[n][i] = 0.f;
      dv_acc[n][i] = 0.f;
    }
  uint32_t pa[4][4], da[4][4];
  // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T
  const uint32_t sA = wg == 0 ? sK : sV;
  const int pn0 = min(2 * wg, DP / 64 - 1);
  const int pn1 = min(2 * wg + 1, DP / 64 - 1);

  for (int it = 0; it < total; ++it) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // query tile it is in, and every read of tile it - 1 is done
    if (it + 1 < total) load_q(it + 1);
    cp_async_commit();
    const int i0 = q_begin + (it % nt) * kTile;
    // whether any (query, key) pair of this tile and the block is attended
    const bool act =
        k0 < L && (!causal || i0 + 63 >= k0) && (window <= 0 || i0 - (k0 + 63) < window);
    if (!act) continue;
    const uint32_t sQ = stage(it);
    const uint32_t sdO = sQ + S::kTileB;
    const uint32_t sB = wg == 0 ? sQ : sdO;
    float sc[kSlots];  // S^T or dP^T: rows are keys, columns queries
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      mma_ss<T>(sc, desc_k<kRows>(sA, 0, ks), desc_k<kTile>(sB, 0, ks), ks > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);

    const float* lse_s =
        reinterpret_cast<const float*>(smem + S::kVecOff + (it % kStages) * S::kVec);
    const float* dl_s = lse_s + kTile;
    if (wg == 0) {  // P^T, shared as float; its own A fragments of dV += P^T dO
      const bool mask = (causal && i0 < k0 + 63) || (window > 0 && i0 + 63 - k0 >= window) ||
                        i0 + kTile > L || k0 + kRows > L;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int c = 8 * (i >> 2) + 2 * t + (i & 1);  // query column in the tile
        float p = fast_exp2(sc[i] * scale_log2 - lse_s[c] * kLog2e);
        if (mask &&
            !(i0 + c < L && attend(i0 + c, row_lo + 8 * ((i >> 1) & 1), L, causal, window)))
          p = 0.f;
        sc[i] = p;
        xp[i * kWgThreads + wt] = p;
      }
      to_frag<T>(pa, sc);
    }
    __syncthreads();
    if (wg == 1) {  // dS^T = P^T (dP^T - delta), shared as A fragments; P^T's fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;
          const int c = 8 * (i >> 2) + 2 * t;  // query columns c, c + 1
          const float p0 = xp[i * kWgThreads + wt];
          const float p1 = xp[(i + 1) * kWgThreads + wt];
          pa[kk][e] = pack2<T>(p0, p1);
          da[kk][e] = pack2<T>(p0 * (sc[i] - dl_s[c]), p1 * (sc[i + 1] - dl_s[c + 1]));
          xds[(4 * kk + e) * kWgThreads + wt] = da[kk][e];
        }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) da[kk][e] = xds[(4 * kk + e) * kWgThreads + wt];
    }
    // dV[:, slab] += P^T dO[:, slab] and dK[:, slab] += dS^T Q[:, slab]:
    // dO and Q read transposed
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs<T>(dv_acc[0], pa[kk], desc_mn<kTile>(sdO, pn0, kk), 1);
      mma_rs<T>(dv_acc[1], pa[kk], desc_mn<kTile>(sdO, pn1, kk), 1);
      mma_rs<T>(dk_acc[0], da[kk], desc_mn<kTile>(sQ, pn0, kk), 1);
      mma_rs<T>(dk_acc[1], da[kk], desc_mn<kTile>(sQ, pn1, kk), 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_slab(dk_acc);
    fence_slab(dv_acc);
    fence_frag(pa);
    fence_frag(da);
  }
  cp_async_wait<0>();
  if (parts > 1) {
    const int64_t tile = (int64_t)bhk * gridDim.y + blockIdx.y;
    float* mine = partial + (tile * parts + part) * kAccSlots * kThreads + tid;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        mine[(n * kSlots + i) * kThreads] = dk_acc[n][i];
        mine[(2 * kSlots + n * kSlots + i) * kThreads] = dv_acc[n][i];
      }
    __threadfence();
    __syncthreads();
    int* last = reinterpret_cast<int*>(smem + S::kFlagOff);
    if (tid == 0) *last = atomicAdd(done + tile, 1) == parts - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    // the last block: the parts' sum in their fixed order
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        dk_acc[n][i] = 0.f;
        dv_acc[n][i] = 0.f;
      }
    for (int p = 0; p < parts; ++p) {
      const float* src = partial + (tile * parts + p) * kAccSlots * kThreads + tid;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          dk_acc[n][i] += __ldcg(src + (n * kSlots + i) * kThreads);
          dv_acc[n][i] += __ldcg(src + (2 * kSlots + n * kSlots + i) * kThreads);
        }
    }
  }
  store_slab<T>(dk + kv_off, kv_stride, row_lo, L, D, 128 * wg, dk_acc, scale);
  store_slab<T>(dv + kv_off, kv_stride, row_lo, L, D, 128 * wg, dv_acc, 1.f);
}

}  // namespace mma

// ------------------------------------------------------------ launch ----

inline bool valid(int B, int H, int Hkv, int L, int D) {
  return B > 0 && L > 0 && D >= 8 && D % 8 == 0 && Hkv >= 1 && H % Hkv == 0;
}

// The wgmma body's padded width for a head dim in bf16 or fp16: 192 or
// 256, or 0 where the slab body runs it (D <= 128 or D > 256).
inline int mma_dim(int D) {
  if (D <= 128 || D > 256) return 0;
  return D <= 192 ? 192 : 256;
}

inline dim3 grid(int L, int heads, int D) {
  return dim3((L + kRows - 1) / kRows, heads, (D + kSlab - 1) / kSlab);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int Hkv, int L, int D, float scale, int causal, int window, cudaStream_t s) {
  const size_t smem = fwd_smem_bytes<T>();
  auto kern = fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid(L, B * H, D), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Hkv, L, D, scale, causal, window);
  return (int)cudaGetLastError();
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  float* partial;
  int* done;
  int parts, B, H, Hkv, L, D;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int DP>
int launch_dq_mma(const BwdArgs& a) {
  const int smem = mma::DqSmem<DP>::kBytes;
  auto kern = mma::dq_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 g(a.B * a.H, (a.L + mma::kRows - 1) / mma::kRows);
  kern<<<g, mma::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.Hkv, a.L, a.D,
      a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const BwdArgs& a) {
  if constexpr (!std::is_same<T, float>::value) {
    if (mma_dim(a.D) == 192) return launch_dq_mma<T, 192>(a);
    if (mma_dim(a.D) == 256) return launch_dq_mma<T, 256>(a);
  }
  const size_t smem = dq_smem_bytes<T>();
  auto kern = dq_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid(a.L, a.B * a.H, a.D), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.Hkv, a.L, a.D,
      a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dkv_mma(const BwdArgs& a) {
  using S = mma::DkvSmem<DP>;
  const bool gqa = a.Hkv < a.H;
  auto kern = gqa ? mma::dkv_kernel<T, DP, true> : mma::dkv_kernel<T, DP, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 g(a.B * a.Hkv * a.parts, (a.L + mma::kRows - 1) / mma::kRows);
  kern<<<g, mma::kThreads, S::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.partial, a.done, a.parts, a.H, a.Hkv, a.L, a.D, a.scale, a.causal,
      a.window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const BwdArgs& a) {
  const int DP = std::is_same<T, float>::value ? 0 : mma_dim(a.D);
  const int group = a.H / a.Hkv;
  // parts > 1 only on the wgmma body, dividing the group, with scratch
  if (a.parts < 1 || group % a.parts ||
      (a.parts > 1 && (DP == 0 || a.partial == nullptr || a.done == nullptr)))
    return (int)cudaErrorInvalidValue;
  if constexpr (!std::is_same<T, float>::value) {
    if (DP == 192) return launch_dkv_mma<T, 192>(a);
    if (DP == 256) return launch_dkv_mma<T, 256>(a);
  }
  const size_t smem = dkv_smem_bytes<T>();
  auto kern = dkv_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid(a.L, a.B * a.Hkv, a.D), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.Hkv, a.L, a.D, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename F>
int by_dtype(int dtype, F&& f) {
  switch (dtype) {
    case kFloat32:
      return f(float{});
    case kFloat16:
      return f(__half{});
    case kBFloat16:
      return f(__nv_bfloat16{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace wide
}  // namespace kft

// Each returns the CUDA error code of the launch (0 = launched).
extern "C" int kft_flash_wide_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int dtype, int B, int H, int Hkv, int L, int D,
                                  float scale, int causal, int window, void* stream) {
  using namespace kft;
  using namespace kft::wide;
  if (!valid(B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return by_dtype(dtype, [&](auto x) {
    return launch_fwd<decltype(x)>(q, k, v, o, l, B, H, Hkv, L, D, scale, causal, window, s);
  });
}

extern "C" int kft_flash_wide_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int dtype, int B,
                                 int H, int Hkv, int L, int D, float scale, int causal,
                                 int window, void* stream) {
  using namespace kft::wide;
  if (!valid(B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
            dq, nullptr, nullptr, nullptr, nullptr, 1, B, H, Hkv, L, D, scale, causal, window,
            static_cast<cudaStream_t>(stream)};
  return by_dtype(dtype, [&](auto x) { return launch_dq<decltype(x)>(a); });
}

// dk/dv (B3 when Hkv == H, B4 when Hkv < H).  parts > 1 (wgmma body only)
// splits each kv head's query-head group over that many blocks: `partial`
// holds [B * Hkv * ceil(L / 64), parts, 128, 256] floats and `done`
// B * Hkv * ceil(L / 64) counters, zeroed.
extern "C" int kft_flash_wide_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  void* partial, void* done, int parts, int dtype, int B, int H,
                                  int Hkv, int L, int D, float scale, int causal, int window,
                                  void* stream) {
  using namespace kft::wide;
  if (!valid(B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
            nullptr, dk, dv, static_cast<float*>(partial), static_cast<int*>(done), parts, B, H,
            Hkv, L, D, scale, causal, window, static_cast<cudaStream_t>(stream)};
  return by_dtype(dtype, [&](auto x) { return launch_dkv<decltype(x)>(a); });
}
