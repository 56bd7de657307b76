// Flash attention for head dims over 128 on Hopper (sm_90a): the forward
// (O and lse), dq, and dk/dv (MHA, and GQA with Hkv < H kv heads).
//
// Replace the TPU kernels kungfu_tpu/ops/flash.py `_fwd_kernel`,
// `_bwd_dq_kernel`, `_bwd_dkv_kernel` and `_bwd_dkv_gqa_kernel` at the head
// dims their Hopper counterparts in flash_fwd.cu and flash_bwd.cu do not
// take: those keep a whole row of the output (O, dQ, or dK and dV) in one
// warpgroup's registers, which past 128 columns does not fit (the
// backward's dK and dV at D = 256 would take 256 registers a thread).  The
// Pallas kernels take the whole head dim as one block.  The arithmetic is
// theirs and the other kernels': float statistics, the scale applied to
// the float scores, P and dS rounded to the operand type before they
// enter a product, every accumulator float; lse = m + log(l);
// dS = P * (dP - delta), delta = rowsum(dO * O) - g_lse from outside.
//
// One rule for every head dim D (a multiple of 8; ops/flash.py pads any
// other):
//  - Output slabs.  The grid has an axis of ceil(D / 128) slabs, and a
//    block accumulates only its slab of <= 128 output columns (O; dQ; dK
//    and dV), so its accumulators are what the D = 128 plan holds.
//  - Full-width sums, streamed.  S = Q K^T and dP = dO V^T sum over the
//    whole head dim in chunks of 64 columns: each chunk of Q, K (and dO,
//    V) passes through shared memory, so shared memory does not grow with
//    D.  A block recomputes S (and dP) for its slab: ceil(D / 128) times
//    in all, twice at D = 256.  Slab 0 writes lse.
//  - Tiles as in the first version of flash_fwd.cu / flash_bwd.cu: 128
//    threads, 64-row blocks, 64-key steps (dk/dv: 64 query rows a step, 32
//    in f32), products through shared memory, each warp owning whole
//    16 x 16 output tiles: WMMA 16x16x16 in bf16 and fp16 with float
//    accumulators, float FMA loops in f32 (TF32 would miss the f32 limit of
//    1e-5 in utils/compare.py).  Rows past L and columns past D read as
//    zeros and are not stored.  Causal and windowed masks skip whole
//    tiles.  Every block owns its output rows and columns: no atomics, and
//    the results are the same run to run.
//
// What bounds it on the card: at the Gemma-2B attention shape (B = 1,
// H = 8, Hkv = 1, L = 8192, D = 256, causal) the forward does ~275 GFLOP,
// dq ~412 and dk/dv ~550 against 67-134 MB of operands, so the tensor
// cores bound all three (0.28, 0.42, 0.56 ms at 989 TFLOP/s).  This is the
// simple, correct design; its products make a shared-memory round trip
// each, one 4-warp block fits an SM, and S is recomputed a slab, so it
// runs far from that bound (PERF.md has its times).  A wgmma design with
// two consumer warpgroups a slab is later work.
#include <mma.h>

#include "flash_common.cuh"

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

// ------------------------------------------------------------ launch ----

inline bool valid(int B, int H, int Hkv, int L, int D) {
  return B > 0 && L > 0 && D >= 8 && D % 8 == 0 && Hkv >= 1 && H % Hkv == 0;
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

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int H, int Hkv, int L, int D, float scale,
              int causal, int window, cudaStream_t s) {
  const size_t smem = dq_smem_bytes<T>();
  auto kern = dq_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid(L, B * H, D), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, Hkv, L, D, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int Hkv, int L, int D,
               float scale, int causal, int window, cudaStream_t s) {
  const size_t smem = dkv_smem_bytes<T>();
  auto kern = dkv_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid(L, B * Hkv, D), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv,
      L, D, scale, causal, window);
  return (int)cudaGetLastError();
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
  switch (dtype) {
    case kFloat32:
      return launch_fwd<float>(q, k, v, o, l, B, H, Hkv, L, D, scale, causal, window, s);
    case kFloat16:
      return launch_fwd<__half>(q, k, v, o, l, B, H, Hkv, L, D, scale, causal, window, s);
    case kBFloat16:
      return launch_fwd<__nv_bfloat16>(q, k, v, o, l, B, H, Hkv, L, D, scale, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int kft_flash_wide_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int dtype, int B,
                                 int H, int Hkv, int L, int D, float scale, int causal,
                                 int window, void* stream) {
  using namespace kft;
  using namespace kft::wide;
  if (!valid(B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case kFloat32:
      return launch_dq<float>(q, k, v, dout, l, dl, dq, B, H, Hkv, L, D, scale, causal, window,
                              s);
    case kFloat16:
      return launch_dq<__half>(q, k, v, dout, l, dl, dq, B, H, Hkv, L, D, scale, causal, window,
                               s);
    case kBFloat16:
      return launch_dq<__nv_bfloat16>(q, k, v, dout, l, dl, dq, B, H, Hkv, L, D, scale, causal,
                                      window, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int kft_flash_wide_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  int dtype, int B, int H, int Hkv, int L, int D, float scale,
                                  int causal, int window, void* stream) {
  using namespace kft;
  using namespace kft::wide;
  if (!valid(B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case kFloat32:
      return launch_dkv<float>(q, k, v, dout, l, dl, dk, dv, B, H, Hkv, L, D, scale, causal,
                               window, s);
    case kFloat16:
      return launch_dkv<__half>(q, k, v, dout, l, dl, dk, dv, B, H, Hkv, L, D, scale, causal,
                                window, s);
    case kBFloat16:
      return launch_dkv<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, B, H, Hkv, L, D, scale,
                                       causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
