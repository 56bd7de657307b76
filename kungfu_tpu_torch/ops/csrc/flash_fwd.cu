// Flash-attention forward for Hopper (sm_90a): O and the row log-sum-exp.
//
// Replaces the TPU kernel kungfu_tpu/ops/flash.py `_fwd_kernel` (launched
// by `_flash_fwd`): causal, optionally windowed online-softmax attention
// with float statistics, the scale applied to the float scores, and P
// rounded to the operand type before the PV product.  GQA maps each query
// head to its kv head (`_kv_row`) instead of repeating k/v.
//
// What bounds it on the card: at the flagship shape (B=8, H=16, L=2048,
// D=64, causal) the work is ~69 GFLOP against ~34 MB of q/k/v/o, so the
// tensor cores bound it, not memory.  The design keeps every score and
// probability on chip (no [L, L] matrix in device memory) and skips whole
// key blocks past the diagonal and before the window, as `_kloop_ranges`
// does.  It is the simple first version: WMMA tiles staged through shared
// memory, no asynchronous copies, no wgmma/TMA; those are later work.
//
// Head dims: any multiple of 16 up to 128; tiles are 64 or 128 columns
// wide (DP), a narrower head padded with zero columns in shared memory,
// which are not stored.
//
// Grid: (ceil(L / 64), B * H); one block owns 64 query rows and writes
// them alone, so no atomics.  Warp w owns rows 16w..16w+15 end to end
// (scores, softmax, PV), so only the K/V tile loads need the whole block.
#include "flash_common.cuh"

namespace kft {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per inner step

template <typename T, int DP>
constexpr size_t fwd_smem_bytes() {
  return (3 * 64 * Ld<DP>::op + 64 * kLdProb) * sizeof(T) +
         (64 * kLdScore + 64 * Ld<DP>::acc) * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int L, int D,
                     float scale, int causal, int window) {
  constexpr int LDT = Ld<DP>::op;
  constexpr int LDO = Ld<DP>::acc;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * LDT;
  T* Vs = Ks + kBK * LDT;
  T* Ps = Vs + kBK * LDT;
  float* S = reinterpret_cast<float*>(Ps + kBQ * kLdProb);
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
      warp_mma<T, true, false, DP>(S + row0 * kLdScore + tn * 16, kLdScore, Qs + row0 * LDT,
                                   LDT, Ks + tn * 16 * LDT, LDT, false);
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
      for (int c = lane; c < DP; c += 32) Oacc[r * LDO + c] *= corr;
    }
    __syncwarp();

    // Oacc[rows, DP] += P[rows, 64] V[64, DP]
#pragma unroll
    for (int tn = 0; tn < DP / 16; ++tn) {
      warp_mma<T, true, true, kBK>(Oacc + row0 * LDO + tn * 16, LDO, Ps + row0 * kLdProb,
                                   kLdProb, Vs + tn * 16, LDT, true);
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
    for (int c = lane; c < D; c += 32) {
      ob[qp * q_stride + c] = from_f<T>(Oacc[(row0 + rr) * LDO + c] / l_safe);
    }
    if (lane == 0) lb[qp] = m_i[rr] + logf(l_safe);
  }
}

template <typename T, int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int Hkv, int L, int D, float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T, DP>();
  auto kern = flash_fwd_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), lse, H,
                                         Hkv, L, D, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int H, int Hkv, int L, float scale, int causal, int window,
                 cudaStream_t stream) {
  if (D < 16 || D > 128 || D % 16) return (int)cudaErrorInvalidValue;
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
