// Flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel (MHA, and GQA with Hkv < H kv heads).
//
// Replace the TPU kernels kungfu_tpu/ops/flash.py `_bwd_dq_kernel`,
// `_bwd_dkv_kernel` and `_bwd_dkv_gqa_kernel` (body `_dkv_accum`), all
// launched by `_bwd_pallas`.
// P is rematerialized from the forward's lse as exp(scale * q.k - lse);
// delta = rowsum(dO * O) - g_lse comes from outside, as on the TPU.
// dS = P * (dP - delta) with dP = dO V^T.  P and dS are rounded to the
// operand type before they enter a product, as the TPU kernels do, and
// every accumulator is float.  dq = scale * dS K, dk = scale * dS^T Q,
// dv = P^T dO.  Head dims: any multiple of 16 up to 128.  Tiles are padded
// to 64 or 128 columns with zeros in shared memory (never in device
// memory), and the padded columns are not stored.
//
// What bounds them on the card: at the flagship shape (B=8, H=16, L=2048,
// D=64, causal) dq does ~103 GFLOP and dk/dv ~137 GFLOP against ~50 MB of
// operands each, so the tensor cores bound both (0.10 and 0.14 ms at 989
// TFLOP/s).  The first version (WMMA 16x16x16 through shared memory) ran
// at 3-6% of that: its accumulators made a shared-memory round trip at
// every product, S and dP went through shared memory as float, loads were
// synchronous, and one or two 4-warp blocks fitted an SM.
//
// The 16-bit design (bf16, fp16; flash_sm90.cuh has the pieces):
//  - wgmma.mma_async: a warpgroup computes 64-row tiles.  S = Q K^T and
//    dP = dO V^T (dk/dv: S^T = K Q^T and dP^T = V dO^T) accumulate in
//    registers; P and dS are formed there, rounded, and fed back as the
//    register A operand of the next product (dQ += dS K; dV += P^T dO,
//    dK += dS^T Q), its B operand the same shared-memory tile read
//    transposed (MN-major).  The output accumulators stay in registers for
//    the whole block and are written once.
//  - A block is one warpgroup owning 64 output rows (query rows for dq,
//    key rows for dk/dv) of one (batch, head); it streams 64-row tiles of
//    the other side (K/V for dq; Q, dO, lse, delta for dk/dv) through a
//    ring of three shared-memory stages filled by cp.async, two tiles in
//    flight while one computes.  A tile's output products run on the
//    tensor cores while the next tile's S and dP are issued: one wait
//    retires both.  Two or three blocks share an SM, so one block's
//    products overlap another's arithmetic (on the card this beat two
//    warpgroups a block, and issuing the next tile's S before this tile's
//    arithmetic: PERF.md).
//  - Causal and windowed masks skip whole tiles and mask elements only on
//    boundary tiles.  The heaviest blocks start first (high query blocks
//    for dq, low key blocks for dk/dv).
//  - No atomics: every block owns its output rows, so dq stays its own
//    kernel and results are deterministic run to run.  GQA (B4) sums the
//    kv head's query-head group into the same registers: the tile stream
//    walks head after head (MHA is a group of one, fixed at compile time).
//
// float inputs keep the first version's FMA loops (WMMA has no float
// type, and TF32 would miss the f32 limit of 1e-5 in utils/compare.py);
// only the f32 checks use them.
#include "flash_sm90.cuh"

namespace kft {

// ------------------------------------------------------------- float ----
// The first version's FMA body: 128 threads, tiles staged in shared memory
// with padded rows, template DP (64 or 128 columns), head dim D <= DP.

constexpr int kBlock = 64;  // output rows per block, and key rows per dq step
constexpr int kBqF32 = 32;  // query rows per dk/dv step

template <int DP>
constexpr size_t dq_f32_smem_bytes() {
  return (4 * kBlock * Ld<DP>::op + kBlock * kLdProb) * sizeof(float) +
         (2 * kBlock * kLdScore + kBlock * Ld<DP>::acc) * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int H, int Hkv, int L, int D, float scale,
                            int causal, int window) {
  using T = float;
  constexpr int LDT = Ld<DP>::op;
  constexpr int LDA = Ld<DP>::acc;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBlock * LDT;
  T* Ks = dOs + kBlock * LDT;
  T* Vs = Ks + kBlock * LDT;
  T* dSs = Vs + kBlock * LDT;
  float* S = dSs + kBlock * kLdProb;
  float* dP = S + kBlock * kLdScore;
  float* dQacc = dP + kBlock * kLdScore;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t q_off = ((int64_t)b * L * H + h) * D;
  const T* kb = k + ((int64_t)b * L * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * L * Hkv + hk) * D;

  load_rows<T, kBlock, DP>(Qs, LDT, q + q_off, q_stride, q0, L, D);
  load_rows<T, kBlock, DP>(dOs, LDT, dout + q_off, q_stride, q0, L, D);
  for (int i = threadIdx.x; i < kBlock * LDA; i += kThreads) dQacc[i] = 0.f;

  const int row0 = warp * 16;
  float lse_i[16], dl_i[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int qp = q0 + row0 + rr;
    lse_i[rr] = qp < L ? lse[(int64_t)bh * L + qp] : 0.f;
    dl_i[rr] = qp < L ? delta[(int64_t)bh * L + qp] : 0.f;
  }

  const int nk = (L + kBlock - 1) / kBlock;
  const int hi = causal ? min(nk, (q0 + 2 * kBlock - 1) / kBlock) : nk;
  const int lo = (causal && window > 0) ? max(0, (q0 - window + 1) / kBlock) : 0;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();
    load_rows<T, kBlock, DP>(Ks, LDT, kb, kv_stride, k0, L, D);
    load_rows<T, kBlock, DP>(Vs, LDT, vb, kv_stride, k0, L, D);
    __syncthreads();

#pragma unroll
    for (int tn = 0; tn < kBlock / 16; ++tn) {
      warp_mma<true, false, DP>(S + row0 * kLdScore + tn * 16, kLdScore, Qs + row0 * LDT, LDT,
                                   Ks + tn * 16 * LDT, LDT, false);
      warp_mma<true, false, DP>(dP + row0 * kLdScore + tn * 16, kLdScore, dOs + row0 * LDT,
                                   LDT, Vs + tn * 16 * LDT, LDT, false);
    }
    __syncwarp();

#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const int qp = q0 + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const float p = attend(qp, k0 + c, L, causal, window)
                            ? expf(S[r * kLdScore + c] * scale - lse_i[rr])
                            : 0.f;
        dSs[r * kLdProb + c] = p * (dP[r * kLdScore + c] - dl_i[rr]);
      }
    }
    __syncwarp();

    // dQacc[rows, DP] += dS[rows, 64] K[64, DP]
#pragma unroll
    for (int tn = 0; tn < DP / 16; ++tn) {
      warp_mma<true, true, kBlock>(dQacc + row0 * LDA + tn * 16, LDA, dSs + row0 * kLdProb,
                                      kLdProb, Ks + tn * 16, LDT, true);
    }
  }
  __syncthreads();
  store_rows<T, kBlock, DP>(dq + q_off, q_stride, q0, L, D, dQacc, LDA, scale);
}

// A block owns 64 key rows of one (batch, kv head) and walks the query
// rows that can see them in steps of 32: those of the one query head
// (MHA), or of each query head of the kv head's group in turn (GQA).

template <int DP>
constexpr size_t dkv_f32_smem_bytes() {
  constexpr int BQ = kBqF32;
  return (2 * kBlock * Ld<DP>::op + 2 * BQ * Ld<DP>::op + 2 * BQ * kLdProb) * sizeof(float) +
         (2 * BQ * kLdScore + 2 * kBlock * Ld<DP>::acc + 2 * BQ) * sizeof(float);
}

template <int DP, bool kGqa>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv,
                             int L, int D, float scale, int causal, int window) {
  using T = float;
  constexpr int BQ = kBqF32;
  constexpr int LDT = Ld<DP>::op;
  constexpr int LDA = Ld<DP>::acc;
  constexpr int kTilesQK = (BQ / 16) * (kBlock / 16);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBlock * LDT;
  T* Qs = Vs + kBlock * LDT;
  T* dOs = Qs + BQ * LDT;
  T* Ps = dOs + BQ * LDT;
  T* dSs = Ps + BQ * kLdProb;
  float* S = dSs + BQ * kLdProb;
  float* dP = S + BQ * kLdScore;
  float* dKacc = dP + BQ * kLdScore;
  float* dVacc = dKacc + kBlock * LDA;
  float* lse_s = dVacc + kBlock * LDA;
  float* dl_s = lse_s + BQ;

  const int warp = threadIdx.x >> 5;
  const int row0 = warp * 16;
  const int k0 = blockIdx.x * kBlock;
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int group = kGqa ? H / Hkv : 1;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t kv_off = ((int64_t)b * L * Hkv + hk) * D;
  const int64_t stride = (int64_t)H * D;
  load_rows<T, kBlock, DP>(Ks, LDT, k + kv_off, kv_stride, k0, L, D);
  load_rows<T, kBlock, DP>(Vs, LDT, v + kv_off, kv_stride, k0, L, D);
  for (int i = threadIdx.x; i < kBlock * LDA; i += kThreads) {
    dKacc[i] = 0.f;
    dVacc[i] = 0.f;
  }
  // queries that see keys [k0, k0 + 64): causal from the block's first
  // key; window up to window-1 rows past its last key
  const int q_start = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(L, k0 + kBlock - 1 + window) : L;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t bh = (int64_t)b * H + h;
    const int64_t off = ((int64_t)b * L * H + h) * D;
    for (int i0 = (q_start / BQ) * BQ; i0 < q_end; i0 += BQ) {
      __syncthreads();
      load_rows<T, BQ, DP>(Qs, LDT, q + off, stride, i0, L, D);
      load_rows<T, BQ, DP>(dOs, LDT, dout + off, stride, i0, L, D);
      load_vec(lse_s, lse + bh * L, i0, BQ, L);
      load_vec(dl_s, delta + bh * L, i0, BQ, L);
      __syncthreads();

      // S = Q K^T and dP = dO V^T, [BQ, 64] each, tiles dealt round the warps
      for (int e = warp; e < 2 * kTilesQK; e += kWarps) {
        const bool is_s = e < kTilesQK;
        const int idx = is_s ? e : e - kTilesQK;
        const int tm = idx / (kBlock / 16);
        const int tn = idx % (kBlock / 16);
        warp_mma<true, false, DP>((is_s ? S : dP) + tm * 16 * kLdScore + tn * 16, kLdScore,
                                     (is_s ? Qs : dOs) + tm * 16 * LDT, LDT,
                                     (is_s ? Ks : Vs) + tn * 16 * LDT, LDT, false);
      }
      __syncthreads();

      for (int e = threadIdx.x; e < BQ * kBlock; e += kThreads) {
        const int r = e / kBlock;
        const int c = e % kBlock;
        const int qp = i0 + r;
        // padded query rows carry no lse; mask them by position
        const float p = (qp < L && attend(qp, k0 + c, L, causal, window))
                            ? expf(S[r * kLdScore + c] * scale - lse_s[r])
                            : 0.f;
        Ps[r * kLdProb + c] = p;
        dSs[r * kLdProb + c] = p * (dP[r * kLdScore + c] - dl_s[r]);
      }
      __syncthreads();

      // dV[rows, DP] += P^T dO and dK[rows, DP] += dS^T Q for this warp's key rows
#pragma unroll
      for (int tn = 0; tn < DP / 16; ++tn) {
        warp_mma<false, true, BQ>(dVacc + row0 * LDA + tn * 16, LDA, Ps + row0, kLdProb,
                                     dOs + tn * 16, LDT, true);
        warp_mma<false, true, BQ>(dKacc + row0 * LDA + tn * 16, LDA, dSs + row0, kLdProb,
                                     Qs + tn * 16, LDT, true);
      }
    }
  }
  __syncthreads();
  store_rows<T, kBlock, DP>(dk + kv_off, kv_stride, k0, L, D, dKacc, LDA, scale);
  store_rows<T, kBlock, DP>(dv + kv_off, kv_stride, k0, L, D, dVacc, LDA, 1.f);
}

// --------------------------------------------------------- bf16, fp16 ---

namespace sm90 {

// One warpgroup a block owns 64 output rows, and several blocks share an
// SM (at DP = 64: dq three at about 150 registers a thread, dk/dv two at
// about 200; capping dk/dv at 168 for a third spills), so one block's
// products run while another's arithmetic does.
constexpr int kThreads = kWgThreads;
constexpr int kRows = 64;   // output rows of a block
constexpr int kTile = 64;   // rows of a streamed tile
constexpr int kStages = 3;  // shared-memory ring: two tiles in flight

// Shared memory, bytes (+1024 to align the tiles to the swizzle atom).
template <int DP>
struct DqSmem {
  static constexpr int kQ = kRows * DP * 2;   // Q, dO: one tile each
  static constexpr int kKV = kTile * DP * 2;  // K, V: one tile each a stage
  static constexpr int kBytes = 2 * kQ + kStages * 2 * kKV + 1024;
  static_assert(kQ % 1024 == 0 && kKV % 1024 == 0, "tiles start on swizzle atoms");
};
template <int DP>
struct DkvSmem {
  static constexpr int kKV = kRows * DP * 2;  // K, V: one tile each
  static constexpr int kQ = kTile * DP * 2;   // Q, dO: one tile each a stage
  static constexpr int kVec = 2 * kTile * 4;  // lse, delta a stage, after the tiles
  static constexpr int kVecs = 2 * kKV + kStages * 2 * kQ;
  static constexpr int kBytes = kVecs + kStages * kVec + 1024;
  static_assert(kQ % 1024 == 0 && kKV % 1024 == 0, "tiles start on swizzle atoms");
};

// dq: grid (B * H, ceil(L / 64)).  A block owns query rows q0 .. q0 + 63 of
// one (batch, head) and walks the key tiles that can see them.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int H, int Hkv, int L, int D, float scale,
                        int causal, int window) {
  using S = DqSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sdO = sQ + S::kQ;
  const uint32_t sKV = sdO + S::kQ;  // stage s: K at sKV + 2s kKV, V after it

  const int tid = threadIdx.x;
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
    zero_pad<kRows, DP, kThreads>(smem + S::kQ, D, tid);
    for (int s = 0; s < 2 * kStages; ++s)
      zero_pad<kTile, DP, kThreads>(smem + 2 * S::kQ + s * S::kKV, D, tid);
  }

  // key tiles [lo, hi): causal stops after the block's last row, the
  // window starts at the first key its first row still sees
  const int nk = (L + kTile - 1) / kTile;
  const int hi = causal ? min(nk, (q0 + kRows + kTile - 1) / kTile) : nk;
  const int lo = (causal && window > 0) ? max(0, (q0 - window + 1) / kTile) : 0;

  auto stage = [&](int j) { return sKV + ((j - lo) % kStages) * 2 * S::kKV; };
  auto load_kv = [&](int j) {
    load_tile<kTile, DP, kThreads>(stage(j), kb, kv_stride, j * kTile, L, D, tid);
    load_tile<kTile, DP, kThreads>(stage(j) + S::kKV, vb, kv_stride, j * kTile, L, D, tid);
  };
  load_tile<kRows, DP, kThreads>(sQ, q + q_off, q_stride, q0, L, D, tid);
  load_tile<kRows, DP, kThreads>(sdO, dout + q_off, q_stride, q0, L, D, tid);
  if (lo < hi) load_kv(lo);
  cp_async_commit();
  if (lo + 1 < hi) load_kv(lo + 1);
  cp_async_commit();

  const int row_lo = q0 + (tid >> 5) * 16 + ((tid & 31) >> 2);  // and row_lo + 8
  const int t = tid & 3;
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row_lo + 8 * e;
    lse2[e] = row < L ? lse[(int64_t)bh * L + row] * kLog2e : 0.f;
    dl[e] = row < L ? delta[(int64_t)bh * L + row] : 0.f;
  }

  float acc[DP / 64][32];
#pragma unroll
  for (int n = 0; n < DP / 64; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  uint32_t a[4][4];

  for (int j = lo; j < hi; ++j) {
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();  // tile j is in
    const int k0 = j * kTile;
    // whether any (row, key) pair of the block and this tile is attended
    const bool act =
        q0 < L && (!causal || k0 <= q0 + 63) && (window <= 0 || k0 + 63 > q0 - window);
    const uint32_t sK = stage(j);
    float s[32], dp[32];
    if (act) {  // S = Q K^T and dP = dO V^T, [64 x 64] each, in registers
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        mma_ss<T>(s, desc_k<kRows>(sQ, 0, ks), desc_k<kTile>(sK, 0, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        mma_ss<T>(dp, desc_k<kRows>(sdO, 0, ks), desc_k<kTile>(sK + S::kKV, 0, ks), ks > 0);
      wg_commit();
    }
    // wait for S and dP, and for the previous tile's dQ product, which
    // ran meanwhile: then every read of tile j - 1 is done, and tile j + 2
    // loads into its stage
    wg_wait<0>();
    fence_acc<DP>(acc);
    fence_frag(a);
    if (j + 2 < hi) load_kv(j + 2);
    cp_async_commit();
    if (!act) continue;
    reg_fence(s);
    reg_fence(dp);

    const bool mask = (causal && k0 + 63 > q0) || (window > 0 && q0 + 63 - k0 >= window) ||
                      k0 + kTile > L;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      float p = fast_exp2(s[i] * scale_log2 - lse2[e]);
      if (mask &&
          !attend(row_lo + 8 * e, k0 + 8 * (i >> 2) + 2 * t + (i & 1), L, causal, window))
        p = 0.f;
      s[i] = p * (dp[i] - dl[e]);  // dS
    }
    to_frag<T>(a, s);
    // dQ += dS K: K read transposed from the same tile
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < DP / 64; ++n) mma_rs<T>(acc[n], a[kk], desc_mn<kTile>(sK, n, kk), 1);
    wg_commit();  // waited for with the next tile's S and dP
  }
  wg_wait<0>();
  fence_acc<DP>(acc);
  cp_async_wait<0>();
  if (q0 < L) store_acc<T, DP>(dq + q_off, q_stride, row_lo, L, D, acc, scale);
}

// dk/dv: grid (B * Hkv, ceil(L / 64)).  A block owns key rows k0 .. k0 + 63
// of kv head hk and walks the query tiles that see them, for each query
// head hk * G .. hk * G + G - 1 of its group (G = H / Hkv; 1 for MHA).
template <typename T, int DP, bool kGqa>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int L, int D,
                         float scale, int causal, int window) {
  using S = DkvSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + S::kKV;
  const uint32_t sStage = sV + S::kKV;  // stage s: Q, dO at sStage + 2s kQ
  const uint32_t sVec = sK + S::kVecs;   // stage s: lse, delta at sVec + s kVec

  const int tid = threadIdx.x;
  const int k0 = blockIdx.y * kRows;  // the earliest keys (the most queries) first
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = kGqa ? H / Hkv : 1;
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t kv_off = ((int64_t)b * L * Hkv + hk) * D;

  if (D < DP) {
    zero_pad<kRows, DP, kThreads>(smem, D, tid);
    zero_pad<kRows, DP, kThreads>(smem + S::kKV, D, tid);
    for (int s = 0; s < 2 * kStages; ++s)
      zero_pad<kTile, DP, kThreads>(smem + 2 * S::kKV + s * S::kQ, D, tid);
  }

  // query tiles: causal from the block's first key, the window up to
  // window-1 rows past its last key; then the same for each head of the group
  const int q_begin = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(L, k0 + kRows - 1 + window) : L;
  const int nt = (q_end - q_begin + kTile - 1) / kTile;
  const int total = group * nt;

  auto stage = [&](int it) { return sStage + (it % kStages) * 2 * S::kQ; };
  auto load_q = [&](int it) {
    const int hq = hk * group + it / nt;
    const int i0 = q_begin + (it % nt) * kTile;
    const int64_t off = ((int64_t)b * L * H + hq) * D;
    load_tile<kTile, DP, kThreads>(stage(it), q + off, q_stride, i0, L, D, tid);
    load_tile<kTile, DP, kThreads>(stage(it) + S::kQ, dout + off, q_stride, i0, L, D, tid);
    const int r = tid % kTile;  // threads 0-63 copy lse, 64-127 delta
    const float* src = (tid < kTile ? lse : delta) + ((int64_t)b * H + hq) * L;
    const bool ok = i0 + r < L;
    cp_async4(sVec + (it % kStages) * S::kVec + tid * 4, src + (ok ? i0 + r : 0), ok);
  };
  load_tile<kRows, DP, kThreads>(sK, k + kv_off, kv_stride, k0, L, D, tid);
  load_tile<kRows, DP, kThreads>(sV, v + kv_off, kv_stride, k0, L, D, tid);
  if (total > 0) load_q(0);
  cp_async_commit();
  if (total > 1) load_q(1);
  cp_async_commit();

  const int row_lo = k0 + (tid >> 5) * 16 + ((tid & 31) >> 2);  // and row_lo + 8
  const int t = tid & 3;
  const float scale_log2 = scale * kLog2e;

  float dk_acc[DP / 64][32], dv_acc[DP / 64][32];
#pragma unroll
  for (int n = 0; n < DP / 64; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dk_acc[n][i] = 0.f;
      dv_acc[n][i] = 0.f;
    }
  uint32_t pa[4][4], da[4][4];

  for (int it = 0; it < total; ++it) {
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();  // query tile it is in
    const int i0 = q_begin + (it % nt) * kTile;
    // whether any (query, key) pair of this tile and the block is attended
    const bool act =
        k0 < L && (!causal || i0 + 63 >= k0) && (window <= 0 || i0 - (k0 + 63) < window);
    const uint32_t sQ = stage(it);
    const uint32_t sdO = sQ + S::kQ;
    float st[32], dpt[32];  // S^T and dP^T: rows are keys, columns queries
    if (act) {  // S^T = K Q^T and dP^T = V dO^T
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        mma_ss<T>(st, desc_k<kRows>(sK, 0, ks), desc_k<kTile>(sQ, 0, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        mma_ss<T>(dpt, desc_k<kRows>(sV, 0, ks), desc_k<kTile>(sdO, 0, ks), ks > 0);
      wg_commit();
    }
    // wait for S^T and dP^T, and for the previous tile's dK and dV
    // products, which ran meanwhile: then every read of tile it - 1 is
    // done, and tile it + 2 loads into its stage
    wg_wait<0>();
    fence_acc<DP>(dk_acc);
    fence_acc<DP>(dv_acc);
    fence_frag(pa);
    fence_frag(da);
    if (it + 2 < total) load_q(it + 2);
    cp_async_commit();
    if (!act) continue;
    reg_fence(st);
    reg_fence(dpt);

    const bool mask = (causal && i0 < k0 + 63) || (window > 0 && i0 + 63 - k0 >= window) ||
                      i0 + kTile > L || k0 + kRows > L;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + S::kVecs + (it % kStages) * S::kVec);
    const float* dl_s = lse_s + kTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * t + (i & 1);  // query column in the tile
      float p = fast_exp2(st[i] * scale_log2 - lse_s[c] * kLog2e);
      if (mask &&
          !(i0 + c < L && attend(i0 + c, row_lo + 8 * ((i >> 1) & 1), L, causal, window)))
        p = 0.f;
      dpt[i] = p * (dpt[i] - dl_s[c]);  // dS^T
      st[i] = p;                         // P^T
    }
    to_frag<T>(pa, st);
    to_frag<T>(da, dpt);
    // dV += P^T dO and dK += dS^T Q: dO and Q read transposed
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < DP / 64; ++n) {
        mma_rs<T>(dv_acc[n], pa[kk], desc_mn<kTile>(sdO, n, kk), 1);
        mma_rs<T>(dk_acc[n], da[kk], desc_mn<kTile>(sQ, n, kk), 1);
      }
    wg_commit();  // waited for with the next tile's S^T and dP^T
  }
  wg_wait<0>();
  fence_acc<DP>(dk_acc);
  fence_acc<DP>(dv_acc);
  cp_async_wait<0>();
  if (k0 < L) {
    store_acc<T, DP>(dk + kv_off, kv_stride, row_lo, L, D, dk_acc, scale);
    store_acc<T, DP>(dv + kv_off, kv_stride, row_lo, L, D, dv_acc, 1.f);
  }
}

}  // namespace sm90

// ------------------------------------------------------------ launch ----

// Padded width of a head dim: 64 or 128, or 0 if the kernels do not take it.
inline int padded_dim(int D) {
  if (D < 16 || D > 128 || D % 16) return 0;
  return D <= 64 ? 64 : 128;
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Hkv, L, D;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int DP>
int launch_dq(const BwdArgs& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.dq);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = dq_f32_smem_bytes<DP>();
    auto kern = flash_bwd_dq_f32_kernel<DP>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.L + kBlock - 1) / kBlock, a.B * a.H);
    kern<<<grid, kThreads, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta, dq, a.H, a.Hkv, a.L,
                                             a.D, a.scale, a.causal, a.window);
  } else {
    const size_t smem = sm90::DqSmem<DP>::kBytes;
    auto kern = sm90::flash_bwd_dq_kernel<T, DP>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.B * a.H, (a.L + sm90::kRows - 1) / sm90::kRows);
    kern<<<grid, sm90::kThreads, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta, dq, a.H, a.Hkv,
                                                   a.L, a.D, a.scale, a.causal, a.window);
  }
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dkv(const BwdArgs& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  const bool gqa = a.Hkv < a.H;
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = dkv_f32_smem_bytes<DP>();
    auto kern = gqa ? flash_bwd_dkv_f32_kernel<DP, true> : flash_bwd_dkv_f32_kernel<DP, false>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.L + kBlock - 1) / kBlock, a.B * a.Hkv);
    kern<<<grid, kThreads, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta, dk, dv, a.H, a.Hkv,
                                             a.L, a.D, a.scale, a.causal, a.window);
  } else {
    const size_t smem = sm90::DkvSmem<DP>::kBytes;
    auto kern = gqa ? sm90::flash_bwd_dkv_kernel<T, DP, true>
                    : sm90::flash_bwd_dkv_kernel<T, DP, false>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.B * a.Hkv, (a.L + sm90::kRows - 1) / sm90::kRows);
    kern<<<grid, sm90::kThreads, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta, dk, dv, a.H,
                                                   a.Hkv, a.L, a.D, a.scale, a.causal, a.window);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(bool dkv, const BwdArgs& a) {
  switch (padded_dim(a.D)) {
    case 64:
      return dkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128:
      return dkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
  }
  return (int)cudaErrorInvalidValue;
}

int run(int dtype, bool dkv, const BwdArgs& a) {
  if (a.Hkv < 1 || a.H % a.Hkv) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(dkv, a);
    case kFloat16:
      return dispatch<__half>(dkv, a);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(dkv, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace kft

// Each returns the CUDA error code of the launch (0 = launched).
extern "C" int kft_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int dtype, int B,
                                int H, int Hkv, int L, int D, float scale, int causal,
                                int window, void* stream) {
  kft::BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                 dq, nullptr, nullptr, B, H, Hkv, L, D, scale, causal, window,
                 static_cast<cudaStream_t>(stream)};
  return kft::run(dtype, false, a);
}

// MHA dk/dv (B3): k, v, dk, dv carry H heads.
extern "C" int kft_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int dtype, int B, int H, int L, int D, float scale, int causal,
                                 int window, void* stream) {
  kft::BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                 nullptr, dk, dv, B, H, H, L, D, scale, causal, window,
                 static_cast<cudaStream_t>(stream)};
  return kft::run(dtype, true, a);
}

// GQA dk/dv (B4): k, v, dk, dv carry Hkv < H heads, H a multiple of Hkv.
extern "C" int kft_flash_bwd_dkv_gqa(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int dtype, int B, int H, int Hkv, int L,
                                     int D, float scale, int causal, int window, void* stream) {
  if (Hkv >= H) return (int)cudaErrorInvalidValue;
  kft::BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                 nullptr, dk, dv, B, H, Hkv, L, D, scale, causal, window,
                 static_cast<cudaStream_t>(stream)};
  return kft::run(dtype, true, a);
}
