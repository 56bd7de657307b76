// Flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel (MHA).
//
// Replace the TPU kernels kungfu_tpu/ops/flash.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (body `_dkv_accum`), both launched by `_bwd_pallas`.
// P is rematerialized from the forward's lse as exp(scale * q.k - lse);
// delta = rowsum(dO * O) - g_lse comes from outside, as on the TPU.
// dS = P * (dP - delta) with dP = dO V^T.  P and dS are rounded to the
// operand type before they enter a product, as the TPU kernels do, and
// every accumulator is float.
//
// What bounds them on the card: at the flagship shape (B=8, H=16, L=2048,
// D=64, causal) dq does ~103 GFLOP and dk/dv ~137 GFLOP against ~50 MB of
// operands each, so the tensor cores bound both.  The design keeps the
// [L, L] probabilities on chip, skips key (dq) or query (dk/dv) blocks
// outside the causal triangle and the window, and gives every block sole
// ownership of its output rows, so no atomics and no second pass.  It is
// the simple first version: WMMA tiles staged through shared memory; no
// asynchronous copies, no wgmma/TMA.
#include "flash_common.cuh"

namespace kft {

constexpr int kBlock = 64;  // output rows per block, and key rows per dq step

// ---------------------------------------------------------------- dq ----
// Grid (ceil(L / 64), B * H).  Warp w owns query rows 16w..16w+15.

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  return (4 * kBlock * Ld<D>::op + kBlock * kLdProb) * sizeof(T) +
         (2 * kBlock * kLdScore + kBlock * Ld<D>::acc) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int H, int Hkv, int L, float scale, int causal,
                        int window) {
  constexpr int LDT = Ld<D>::op;
  constexpr int LDA = Ld<D>::acc;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBlock * LDT;
  T* Ks = dOs + kBlock * LDT;
  T* Vs = Ks + kBlock * LDT;
  T* dSs = Vs + kBlock * LDT;
  float* S = reinterpret_cast<float*>(dSs + kBlock * kLdProb);
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

  load_rows<T, kBlock, D>(Qs, LDT, q + q_off, q_stride, q0, L);
  load_rows<T, kBlock, D>(dOs, LDT, dout + q_off, q_stride, q0, L);
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
    load_rows<T, kBlock, D>(Ks, LDT, kb, kv_stride, k0, L);
    load_rows<T, kBlock, D>(Vs, LDT, vb, kv_stride, k0, L);
    __syncthreads();

#pragma unroll
    for (int tn = 0; tn < kBlock / 16; ++tn) {
      warp_mma<T, true, false, D>(S + row0 * kLdScore + tn * 16, kLdScore, Qs + row0 * LDT, LDT,
                                  Ks + tn * 16 * LDT, LDT, false);
      warp_mma<T, true, false, D>(dP + row0 * kLdScore + tn * 16, kLdScore, dOs + row0 * LDT,
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
        dSs[r * kLdProb + c] = from_f<T>(p * (dP[r * kLdScore + c] - dl_i[rr]));
      }
    }
    __syncwarp();

    // dQacc[rows, D] += dS[rows, 64] K[64, D]
#pragma unroll
    for (int tn = 0; tn < D / 16; ++tn) {
      warp_mma<T, true, true, kBlock>(dQacc + row0 * LDA + tn * 16, LDA, dSs + row0 * kLdProb,
                                      kLdProb, Ks + tn * 16, LDT, true);
    }
  }
  __syncthreads();
  store_rows<T, kBlock, D>(dq + q_off, q_stride, q0, L, dQacc, LDA, scale);
}

// -------------------------------------------------------------- dk/dv ---
// Grid (ceil(L / 64), B * H), MHA.  A block owns 64 key rows and walks the
// query rows that can see them in steps of BQ (64; 32 for float inputs,
// whose tiles would not fit shared memory at 64).

template <typename T>
struct DkvBq {
  static constexpr int value = std::is_same<T, float>::value ? 32 : 64;
};

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int BQ = DkvBq<T>::value;
  return (2 * kBlock * Ld<D>::op + 2 * BQ * Ld<D>::op + 2 * BQ * kLdProb) * sizeof(T) +
         (2 * BQ * kLdScore + 2 * kBlock * Ld<D>::acc + 2 * BQ) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H, int L, float scale,
                         int causal, int window) {
  constexpr int BQ = DkvBq<T>::value;
  constexpr int LDT = Ld<D>::op;
  constexpr int LDA = Ld<D>::acc;
  constexpr int kTilesQK = (BQ / 16) * (kBlock / 16);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBlock * LDT;
  T* Qs = Vs + kBlock * LDT;
  T* dOs = Qs + BQ * LDT;
  T* Ps = dOs + BQ * LDT;
  T* dSs = Ps + BQ * kLdProb;
  float* S = reinterpret_cast<float*>(dSs + BQ * kLdProb);
  float* dP = S + BQ * kLdScore;
  float* dKacc = dP + BQ * kLdScore;
  float* dVacc = dKacc + kBlock * LDA;
  float* lse_s = dVacc + kBlock * LDA;
  float* dl_s = lse_s + BQ;

  const int warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int64_t stride = (int64_t)H * D;
  const int64_t off = ((int64_t)b * L * H + h) * D;

  load_rows<T, kBlock, D>(Ks, LDT, k + off, stride, k0, L);
  load_rows<T, kBlock, D>(Vs, LDT, v + off, stride, k0, L);
  for (int i = threadIdx.x; i < kBlock * LDA; i += kThreads) {
    dKacc[i] = 0.f;
    dVacc[i] = 0.f;
  }

  // query rows that see any of keys [k0, k0 + 64): causal starts at the
  // block's first key, the window ends window-1 rows past its last key
  const int q_start = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(L, k0 + kBlock - 1 + window) : L;
  const int row0 = warp * 16;

  for (int i0 = (q_start / BQ) * BQ; i0 < q_end; i0 += BQ) {
    __syncthreads();
    load_rows<T, BQ, D>(Qs, LDT, q + off, stride, i0, L);
    load_rows<T, BQ, D>(dOs, LDT, dout + off, stride, i0, L);
    load_vec(lse_s, lse + (int64_t)bh * L, i0, BQ, L);
    load_vec(dl_s, delta + (int64_t)bh * L, i0, BQ, L);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, [BQ, 64] each, tiles dealt round the warps
    for (int t = warp; t < 2 * kTilesQK; t += kWarps) {
      const bool is_s = t < kTilesQK;
      const int idx = is_s ? t : t - kTilesQK;
      const int tm = idx / (kBlock / 16);
      const int tn = idx % (kBlock / 16);
      warp_mma<T, true, false, D>((is_s ? S : dP) + tm * 16 * kLdScore + tn * 16, kLdScore,
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
      Ps[r * kLdProb + c] = from_f<T>(p);
      dSs[r * kLdProb + c] = from_f<T>(p * (dP[r * kLdScore + c] - dl_s[r]));
    }
    __syncthreads();

    // dV[rows, D] += P^T dO and dK[rows, D] += dS^T Q for this warp's key rows
#pragma unroll
    for (int tn = 0; tn < D / 16; ++tn) {
      warp_mma<T, false, true, BQ>(dVacc + row0 * LDA + tn * 16, LDA, Ps + row0, kLdProb,
                                   dOs + tn * 16, LDT, true);
      warp_mma<T, false, true, BQ>(dKacc + row0 * LDA + tn * 16, LDA, dSs + row0, kLdProb,
                                   Qs + tn * 16, LDT, true);
    }
  }
  __syncthreads();
  store_rows<T, kBlock, D>(dk + off, stride, k0, L, dKacc, LDA, scale);
  store_rows<T, kBlock, D>(dv + off, stride, k0, L, dVacc, LDA, 1.f);
}

// ------------------------------------------------------------ launch ----

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int H, int Hkv, int L, float scale,
              int causal, int window, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<T, D>();
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kBlock - 1) / kBlock, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, Hkv, L, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int L, float scale,
               int causal, int window, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<T, D>();
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kBlock - 1) / kBlock, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, L,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(int D, const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, int B, int H, int Hkv, int L,
                float scale, int causal, int window, cudaStream_t s) {
  if (D == 64)
    return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, L, scale, causal, window, s);
  if (D == 128)
    return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, L, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_dkv(int D, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dk, void* dv, int B, int H, int L,
                 float scale, int causal, int window, cudaStream_t s) {
  if (D == 64)
    return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, L, scale, causal, window, s);
  if (D == 128)
    return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, L, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace kft

// Both return the CUDA error code of the launch (0 = launched).
extern "C" int kft_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int dtype, int B,
                                int H, int Hkv, int L, int D, float scale, int causal,
                                int window, void* stream) {
  using namespace kft;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case kFloat32:
      return dispatch_dq<float>(D, q, k, v, dout, l, dl, dq, B, H, Hkv, L, scale, causal, window, s);
    case kFloat16:
      return dispatch_dq<__half>(D, q, k, v, dout, l, dl, dq, B, H, Hkv, L, scale, causal, window, s);
    case kBFloat16:
      return dispatch_dq<__nv_bfloat16>(D, q, k, v, dout, l, dl, dq, B, H, Hkv, L, scale, causal,
                                        window, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int kft_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int dtype, int B, int H, int L, int D, float scale, int causal,
                                 int window, void* stream) {
  using namespace kft;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case kFloat32:
      return dispatch_dkv<float>(D, q, k, v, dout, l, dl, dk, dv, B, H, L, scale, causal, window, s);
    case kFloat16:
      return dispatch_dkv<__half>(D, q, k, v, dout, l, dl, dk, dv, B, H, L, scale, causal, window, s);
    case kBFloat16:
      return dispatch_dkv<__nv_bfloat16>(D, q, k, v, dout, l, dl, dk, dv, B, H, L, scale, causal,
                                         window, s);
  }
  return (int)cudaErrorInvalidValue;
}
