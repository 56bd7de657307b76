// Flash-attention forward for Hopper (sm_90a): O and the row log-sum-exp.
//
// Replaces the TPU kernel kungfu_tpu/ops/flash.py `_fwd_kernel` (launched
// by `_flash_fwd`): causal, optionally windowed online-softmax attention
// with float statistics, the scale applied to the float scores, and P
// rounded to the operand type before the PV product.  GQA maps each query
// head to its kv head (`_kv_row`) instead of repeating k/v.  lse is the
// natural log, m + log(l).  Head dims: any multiple of 16 up to 128, in
// tiles of 64 or 128 columns (DP) whose padded columns read as zeros and
// are not stored.  Rows past L are not stored.  A block owns its query
// rows, so there are no atomics and the output is deterministic.
//
// What bounds it on the card: at the flagship shape (B=8, H=16, L=2048,
// D=64, causal) the work is ~69 GFLOP against ~34 MB of q/k/v/o, so the
// tensor cores bound it (0.07 ms at 989 TFLOP/s), with the exp of every
// score on the special-function units close behind (a 64 x 64 tile's 4096
// exps take an SM's 16 units 256 cycles, as long as its two products take
// the tensor cores at their peak).  The first version (WMMA 16x16x16 tiles
// through shared memory, S and P and the O accumulator staged there as
// float, synchronous loads) ran at 5% of the bound.
//
// The 16-bit design (bf16, fp16; the pieces in flash_sm90.cuh):
//  - wgmma.mma_async: one warpgroup (128 threads) a block owns 64 query
//    rows.  S = Q K^T accumulates in registers (m64n128 at DP = 64, m64n64
//    at DP = 128), both operands K-major in shared memory; the online
//    softmax runs on those registers, a row's max and sum reduced over the
//    four lanes of a quad, with exp2 and (for scale > 0) scale * log2(e)
//    folded into one multiply-add; P is packed into the register A operand of O += P V,
//    whose B operand is the same V tile read transposed (MN-major).  O
//    stays in registers for the whole block and is written once.
//  - K and V arrive by TMA (cp.async.bulk.tensor) in 128-byte-swizzled
//    tiles, issued by one thread and completing on a shared-memory barrier
//    per stage: two stages, the next tile in flight while one computes, no
//    block barrier in the loop and no address arithmetic in the other
//    threads.  Rows past L and the padded columns of a narrow head are
//    filled with zeros by the copy engine.  A tile's PV product runs on the
//    tensor cores while the next tile's S is issued; one wait retires both.
//  - Causal and windowed masks skip whole tiles and mask elements only on
//    the diagonal, window-edge and ragged-tail tiles.  Blocks run a few
//    heads at a time, so that their K and V stay in L2, the latest
//    (heaviest) query blocks first.
// On the card (tools/flash_time.py, PERF.md) this beat two warpgroups a
// block sharing each tile, issuing the next tile's S before this tile's
// softmax, three or four stages, cp.async loads, a cap for five blocks an
// SM (it spills), and at DP = 64 64-key tiles (at DP = 128, 128-key tiles
// leave one block an SM and lose).  What bounds it now (64-key tiles,
// D = 64): with the loads removed it runs 2% faster, without the exp 4%,
// without either product 16%: the products and their waits.
//
// float inputs keep the first version's FMA loops (TF32 would miss the f32
// limit of 1e-5 in utils/compare.py).
#include <cuda.h>
#include <cudaTypedefs.h>

#include <algorithm>

#include "flash_sm90.cuh"

namespace kft {

// ------------------------------------------------------------- float ----
// The first version's FMA body: 128 threads, tiles staged in shared memory
// with padded rows, template DP (64 or 128 columns), head dim D <= DP.
// Grid (ceil(L / 64), B * H); warp w owns rows 16w..16w+15 end to end.

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per inner step

template <int DP>
constexpr size_t fwd_f32_smem_bytes() {
  return (3 * 64 * Ld<DP>::op + 64 * kLdProb + 64 * kLdScore + 64 * Ld<DP>::acc) *
         sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int H, int Hkv, int L, int D, float scale,
                         int causal, int window) {
  using T = float;
  constexpr int LDT = Ld<DP>::op;
  constexpr int LDO = Ld<DP>::acc;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * LDT;
  T* Vs = Ks + kBK * LDT;
  T* Ps = Vs + kBK * LDT;
  float* S = Ps + kBQ * kLdProb;
  float* Oacc = S + kBQ * kLdScore;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const T* qb = q + ((int64_t)b * L * H + h) * D;
  const T* kb = k + ((int64_t)b * L * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * L * Hkv + hk) * D;

  load_rows<T, kBQ, DP>(Qs, LDT, qb, q_stride, q0, L, D);
  for (int i = threadIdx.x; i < kBQ * LDO; i += kThreads) Oacc[i] = 0.f;

  float m_i[16], l_i[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
  }

  // key-block range: causal stops after the diagonal, the window starts
  // at the first block any row of this query block still sees
  const int nk = (L + kBK - 1) / kBK;
  const int hi = causal ? min(nk, (q0 + kBQ + kBK - 1) / kBK) : nk;
  const int lo = (causal && window > 0) ? max(0, (q0 - window + 1) / kBK) : 0;

  const int row0 = warp * 16;  // this warp's first row in the block
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous step is done with Ks / Vs
    load_rows<T, kBK, DP>(Ks, LDT, kb, kv_stride, k0, L, D);
    load_rows<T, kBK, DP>(Vs, LDT, vb, kv_stride, k0, L, D);
    __syncthreads();

    // S[rows, 64] = Q K^T for this warp's 16 rows
#pragma unroll
    for (int tn = 0; tn < kBK / 16; ++tn) {
      warp_mma<true, false, DP>(S + row0 * kLdScore + tn * 16, kLdScore, Qs + row0 * LDT, LDT,
                                Ks + tn * 16 * LDT, LDT, false);
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
      Ps[r * kLdProb + lane] = p0;
      Ps[r * kLdProb + lane + 32] = p1;
      for (int c = lane; c < DP; c += 32) Oacc[r * LDO + c] *= corr;
    }
    __syncwarp();

    // Oacc[rows, DP] += P[rows, 64] V[64, DP]
#pragma unroll
    for (int tn = 0; tn < DP / 16; ++tn) {
      warp_mma<true, true, kBK>(Oacc + row0 * LDO + tn * 16, LDO, Ps + row0 * kLdProb, kLdProb,
                                Vs + tn * 16, LDT, true);
    }
  }
  __syncthreads();

  T* ob = o + ((int64_t)b * L * H + h) * D;
  float* lb = lse + (int64_t)bh * L;
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int qp = q0 + row0 + rr;
    if (qp >= L) continue;
    const float l_safe = l_i[rr] == 0.f ? 1.f : l_i[rr];
    for (int c = lane; c < D; c += 32)
      ob[qp * q_stride + c] = Oacc[(row0 + rr) * LDO + c] / l_safe;
    if (lane == 0) lb[qp] = m_i[rr] + logf(l_safe);
  }
}

// --------------------------------------------------------- bf16, fp16 ---

namespace sm90 {

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kFwdStages = 2;  // K/V stages: one tile in flight while one computes

// Shared memory of a block, bytes: the Q tile, the K and V tiles of each
// stage, then one barrier a stage and one for Q (+1024 to align the tiles
// to the swizzle atom).
template <int DP>
struct FwdSmem {
  static constexpr int kKeys = DP == 64 ? 128 : 64;  // key rows a step
  static constexpr int kQ = 64 * DP * 2;
  static constexpr int kKV = kKeys * DP * 2;
  static constexpr int kTiles = kQ + kFwdStages * 2 * kKV;
  static constexpr int kBytes = kTiles + 8 * (kFwdStages + 1) + 1024;
  static_assert(kQ % 1024 == 0 && kKV % 1024 == 0, "tiles start on swizzle atoms");
};

// The TMA views of q, k, v: [B, L, heads, D] as 4-d tensors, boxes of 64
// columns (one 128-byte swizzled panel) by a tile's rows.
struct FwdMaps {
  CUtensorMap q, k, v;
};

// grid (ceil(L / 64) * B * H).  A block owns query rows q0 .. q0 + 63 of
// one (batch, head) and walks the key tiles that can see them.  Blocks run
// in groups of `group` heads, each group's query blocks the latest
// (heaviest) first: the blocks in flight then read the K and V of a few
// heads, which stay in L2, where (batch, head) fastest would stream every
// head's K and V at once through device memory.
template <typename T, int DP>
__global__ void __launch_bounds__(kWgThreads)
    flash_fwd_kernel(float* __restrict__ lse, T* __restrict__ o, int H, int Hkv, int L, int D,
                     float scale, int causal, int window, int group,
                     const __grid_constant__ FwdMaps maps) {
  using S = FwdSmem<DP>;
  constexpr int BK = S::kKeys;
  constexpr int ST = kFwdStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sKV = sQ + S::kQ;       // stage s: K at sKV + 2s kKV, V after it
  const uint32_t sBar = sQ + S::kTiles;  // stage s: sBar + 8s; Q: sBar + 8 ST

  const int tid = threadIdx.x;
  const int nq = (L + 63) / 64;
  const int g0 = blockIdx.x / (group * nq) * group;  // the group's first (batch, head)
  const int heads = min(group, (int)gridDim.x / nq - g0);
  const int r = blockIdx.x - g0 * nq;
  const int q0 = (nq - 1 - r / heads) * 64;
  const int bh = g0 + r % heads;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);

  if (tid == 0) {
    for (int i = 0; i <= ST; ++i) mbar_init(sBar + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // key tiles [lo, hi): causal stops after the block's last row, the
  // window starts at the first key its first row still sees
  const int nk = (L + BK - 1) / BK;
  const int hi = causal ? min(nk, (q0 + 64 + BK - 1) / BK) : nk;
  const int lo = (causal && window > 0) ? max(0, (q0 - window + 1) / BK) : 0;

  // tile j lives in stage (j - lo) % ST; its barrier completes phase
  // (j - lo) / ST when both copies are in
  auto stage = [&](int j) { return sKV + ((j - lo) % ST) * 2 * S::kKV; };
  auto bar = [&](int j) { return sBar + 8 * ((j - lo) % ST); };
  auto load_kv = [&](int j) {
    if (j < hi && tid == 0) {
      mbar_expect_tx(bar(j), 2 * S::kKV);
#pragma unroll
      for (int p = 0; p < DP / 64; ++p) {
        tma_load(stage(j) + p * BK * 128, &maps.k, bar(j), 64 * p, hk, j * BK, b);
        tma_load(stage(j) + S::kKV + p * BK * 128, &maps.v, bar(j), 64 * p, hk, j * BK, b);
      }
    }
  };
  if (tid == 0) {
    mbar_expect_tx(sBar + 8 * ST, S::kQ);
#pragma unroll
    for (int p = 0; p < DP / 64; ++p)
      tma_load(sQ + p * 64 * 128, &maps.q, sBar + 8 * ST, 64 * p, h, q0, b);
  }
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) load_kv(lo + i);
  mbar_wait(sBar + 8 * ST, 0);  // Q is in

  const int row_lo = q0 + (tid >> 5) * 16 + ((tid & 31) >> 2);  // and row_lo + 8
  const int t = tid & 3;
  const float scale_log2 = scale * kLog2e;

  float acc[DP / 64][32];
#pragma unroll
  for (int n = 0; n < DP / 64; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running row max of scale * log2(e) * S
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum
  uint32_t a[BK / 16][4];
  float s[BK / 2];

  // P = exp2(x - m) of tile j on s in registers, x = scale * log2(e) * S,
  // -inf where masked; the row max moves, l is rescaled and takes P's row
  // sums, and corr is what acc must be rescaled by.  For scale > 0 the max
  // is taken over S and the scale folded into the exp's multiply-add.
  auto softmax = [&](int j, float(&corr)[2]) {
    const int k0 = j * BK;
    const bool mask = (causal && k0 + BK - 1 > q0) || (window > 0 && q0 + 63 - k0 >= window) ||
                      k0 + BK > L;
    auto dropped = [&](int i) {
      return mask && !attend(row_lo + 8 * ((i >> 1) & 1), k0 + 8 * (i >> 2) + 2 * t + (i & 1), L,
                             causal, window);
    };
    const float kInf = __int_as_float(0x7f800000);
    float mx[2] = {-kInf, -kInf};
    float mul = scale_log2;  // x = mul * s
    if (scale_log2 > 0.f) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (dropped(i)) s[i] = -kInf;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = dropped(i) ? -kInf : s[i] * scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      mul = 1.f;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float m_new = fmaxf(m[e], mx[e] * mul);
      corr[e] = fast_exp2(m[e] - m_new);
      m[e] = m_new;
      l[e] *= corr[e];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int e = (i >> 1) & 1;
      s[i] = fast_exp2(fmaf(s[i], mul, -m[e]));
      l[e] += s[i];
    }
  };
  auto rescale = [&](const float(&c)[2]) {
#pragma unroll
    for (int n = 0; n < DP / 64; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] *= c[(i >> 1) & 1];
  };

  for (int j = lo; j < hi; ++j) {
    mbar_wait(bar(j), ((j - lo) / ST) & 1);  // tile j is in
    // whether any (row, key) pair of the block and this tile is attended
    const bool act =
        q0 < L && (!causal || j * BK <= q0 + 63) && (window <= 0 || j * BK + BK - 1 > q0 - window);
    if (act) {  // S = Q K^T, [64 x BK]
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        mma_ss<T>(s, desc_k<64>(sQ, 0, ks), desc_k<BK>(stage(j), 0, ks), ks > 0);
    }
    wg_commit();
    // wait for S, and for the previous tile's PV product, which ran
    // meanwhile: then every read of tile j - 1 is done, and tile j + 1
    // loads into its stage
    wg_wait<0>();
    fence_acc<DP>(acc);
    fence_frag(a);
    load_kv(j + ST - 1);
    if (!act) continue;
    reg_fence(s);
    float corr[2];
    softmax(j, corr);
    rescale(corr);
    to_frag<T>(a, s);
    // O += P V: V read transposed from the same tile
    const uint32_t sV = stage(j) + S::kKV;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < DP / 64; ++n) mma_rs<T>(acc[n], a[kk], desc_mn<BK>(sV, n, kk), 1);
    wg_commit();  // waited for with the next tile's S
  }
  wg_wait<0>();
  fence_acc<DP>(acc);

  // the row sums over the quad, then O / l and lse = (m + log2 l) ln 2
  float inv[2], lse_row[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const float l_safe = l[e] == 0.f ? 1.f : l[e];
    inv[e] = 1.f / l_safe;
    lse_row[e] = m[e] * kLn2 + logf(l_safe);
  }
  rescale(inv);
  if (q0 < L) {
    store_acc<T, DP>(o + ((int64_t)b * L * H + h) * D, (int64_t)H * D, row_lo, L, D, acc, 1.f);
    if (t == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (row_lo + 8 * e < L) lse[(int64_t)bh * L + row_lo + 8 * e] = lse_row[e];
    }
  }
}

}  // namespace sm90

// ------------------------------------------------------------ launch ----

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled from the driver, found at run time (no link to libcuda).
EncodeTiled encode_tiled() {
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

// A [B, L, heads, D] tensor of 16-bit values as a TMA view with boxes of 64
// columns x `rows` rows of one (batch, head), 128-byte swizzled; columns
// past D and rows past L read as zeros.
template <typename T>
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B, int L, int heads,
                int D, int rows) {
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                           (cuuint64_t)L * heads * D * 2};  // bytes, dims 1..3
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int Hkv, int L, int D, float scale, int causal, int window, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = fwd_f32_smem_bytes<DP>();
    auto kern = flash_fwd_f32_kernel<DP>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((L + kBQ - 1) / kBQ, B * H);
    kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), lse, H,
                                           Hkv, L, D, scale, causal, window);
  } else {
    using S = sm90::FwdSmem<DP>;
    // the tensor maps, encoded on the host for every call (they hold the
    // operands' addresses)
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    sm90::FwdMaps maps;
    if (!encode_map<T>(encode, &maps.q, q, B, L, H, D, 64) ||
        !encode_map<T>(encode, &maps.k, k, B, L, Hkv, D, S::kKeys) ||
        !encode_map<T>(encode, &maps.v, v, B, L, Hkv, D, S::kKeys))
      return (int)cudaErrorInvalidValue;
    auto kern = sm90::flash_fwd_kernel<T, DP>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (err != cudaSuccess) return (int)err;
    // heads a group: their K and V take at most 8 MB of the 50 MB L2
    const int64_t kv_head = (int64_t)L * DP * 2 * 2;
    const int group = (int)std::max<int64_t>(1, std::min<int64_t>(B * H, (8 << 20) / kv_head));
    kern<<<(L + 63) / 64 * B * H, sm90::kWgThreads, S::kBytes, stream>>>(
        lse, static_cast<T*>(o), H, Hkv, L, D, scale, causal, window, group, maps);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int H, int Hkv, int L, float scale, int causal, int window,
                 cudaStream_t stream) {
  if (D < 16 || D > 128 || D % 16 || Hkv < 1 || H % Hkv) return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_fwd<T, 64>(q, k, v, o, lse, B, H, Hkv, L, D, scale, causal, window, stream);
  return launch_fwd<T, 128>(q, k, v, o, lse, B, H, Hkv, L, D, scale, causal, window, stream);
}

}  // namespace kft

// Returns the CUDA error code of the launch (0 = launched).
extern "C" int kft_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int dtype, int B, int H, int Hkv, int L, int D, float scale,
                             int causal, int window, void* stream) {
  using namespace kft;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case kFloat32:
      return dispatch_fwd<float>(D, q, k, v, o, l, B, H, Hkv, L, scale, causal, window, s);
    case kFloat16:
      return dispatch_fwd<__half>(D, q, k, v, o, l, B, H, Hkv, L, scale, causal, window, s);
    case kBFloat16:
      return dispatch_fwd<__nv_bfloat16>(D, q, k, v, o, l, B, H, Hkv, L, scale, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
