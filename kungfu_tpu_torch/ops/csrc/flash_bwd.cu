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
// every accumulator is float.
//
// What bounds them on the card: at the flagship shape (B=8, H=16, L=2048,
// D=64, causal) dq does ~103 GFLOP and dk/dv ~137 GFLOP against ~50 MB of
// operands each, so the tensor cores bound both.  The design keeps the
// [L, L] probabilities on chip, skips key (dq) or query (dk/dv) blocks
// outside the causal triangle and the window, and gives every block sole
// ownership of its output rows, so no atomics and no second pass.  For GQA
// the TPU kernel sums a kv head's query-head group over its sequential grid
// into f32 outputs; here one block owns 64 key rows of one (batch, kv
// head) and loops over the group's query heads inside the block, into the
// same f32 accumulators, then writes once (MHA is a group of one, fixed at
// compile time).  It is
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
// A block owns 64 key rows of one (batch, kv head) and walks the query
// rows that can see them in steps of BQ (64; 32 for float inputs, whose
// tiles would not fit shared memory at 64): for MHA those of the one query
// head, for GQA those of each query head of the kv head's group in turn.

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

// The block's shared-memory tiles (carved from the dynamic shared memory).
template <typename T, int D>
struct DkvTiles {
  T *Ks, *Vs, *Qs, *dOs, *Ps, *dSs;
  float *S, *dP, *dKacc, *dVacc, *lse_s, *dl_s;

  __device__ explicit DkvTiles(unsigned char* smem) {
    constexpr int BQ = DkvBq<T>::value;
    Ks = reinterpret_cast<T*>(smem);
    Vs = Ks + kBlock * Ld<D>::op;
    Qs = Vs + kBlock * Ld<D>::op;
    dOs = Qs + BQ * Ld<D>::op;
    Ps = dOs + BQ * Ld<D>::op;
    dSs = Ps + BQ * kLdProb;
    S = reinterpret_cast<float*>(dSs + BQ * kLdProb);
    dP = S + BQ * kLdScore;
    dKacc = dP + BQ * kLdScore;
    dVacc = dKacc + kBlock * Ld<D>::acc;
    lse_s = dVacc + kBlock * Ld<D>::acc;
    dl_s = lse_s + BQ;
  }
};

// Load the block's keys and values (64 rows of one kv head) and zero the
// f32 accumulators.
template <typename T, int D>
__device__ __forceinline__ void dkv_begin(const DkvTiles<T, D>& t, const T* k, const T* v,
                                          int64_t kv_off, int64_t kv_stride, int k0, int L) {
  load_rows<T, kBlock, D>(t.Ks, Ld<D>::op, k + kv_off, kv_stride, k0, L);
  load_rows<T, kBlock, D>(t.Vs, Ld<D>::op, v + kv_off, kv_stride, k0, L);
  for (int i = threadIdx.x; i < kBlock * Ld<D>::acc; i += kThreads) {
    t.dKacc[i] = 0.f;
    t.dVacc[i] = 0.f;
  }
}

// Add query head h's share to the block's dK and dV accumulators:
// dV += P^T dO and dK += dS^T Q over the query rows that see keys
// [k0, k0 + 64) (causal: from the block's first key; window: up to
// window-1 rows past its last key).
template <typename T, int D>
__device__ __forceinline__ void dkv_accumulate(const DkvTiles<T, D>& t, const T* __restrict__ q,
                               const T* __restrict__ dout, const float* __restrict__ lse,
                               const float* __restrict__ delta, int b, int h, int H, int L,
                               int k0, float scale, int causal, int window) {
  constexpr int BQ = DkvBq<T>::value;
  constexpr int LDT = Ld<D>::op;
  constexpr int LDA = Ld<D>::acc;
  constexpr int kTilesQK = (BQ / 16) * (kBlock / 16);
  const int warp = threadIdx.x >> 5;
  const int64_t bh = (int64_t)b * H + h;
  const int64_t stride = (int64_t)H * D;
  const int64_t off = ((int64_t)b * L * H + h) * D;
  const int q_start = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(L, k0 + kBlock - 1 + window) : L;
  const int row0 = warp * 16;

  for (int i0 = (q_start / BQ) * BQ; i0 < q_end; i0 += BQ) {
    __syncthreads();
    load_rows<T, BQ, D>(t.Qs, LDT, q + off, stride, i0, L);
    load_rows<T, BQ, D>(t.dOs, LDT, dout + off, stride, i0, L);
    load_vec(t.lse_s, lse + bh * L, i0, BQ, L);
    load_vec(t.dl_s, delta + bh * L, i0, BQ, L);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, [BQ, 64] each, tiles dealt round the warps
    for (int e = warp; e < 2 * kTilesQK; e += kWarps) {
      const bool is_s = e < kTilesQK;
      const int idx = is_s ? e : e - kTilesQK;
      const int tm = idx / (kBlock / 16);
      const int tn = idx % (kBlock / 16);
      warp_mma<T, true, false, D>((is_s ? t.S : t.dP) + tm * 16 * kLdScore + tn * 16, kLdScore,
                                  (is_s ? t.Qs : t.dOs) + tm * 16 * LDT, LDT,
                                  (is_s ? t.Ks : t.Vs) + tn * 16 * LDT, LDT, false);
    }
    __syncthreads();

    for (int e = threadIdx.x; e < BQ * kBlock; e += kThreads) {
      const int r = e / kBlock;
      const int c = e % kBlock;
      const int qp = i0 + r;
      // padded query rows carry no lse; mask them by position
      const float p = (qp < L && attend(qp, k0 + c, L, causal, window))
                          ? expf(t.S[r * kLdScore + c] * scale - t.lse_s[r])
                          : 0.f;
      t.Ps[r * kLdProb + c] = from_f<T>(p);
      t.dSs[r * kLdProb + c] = from_f<T>(p * (t.dP[r * kLdScore + c] - t.dl_s[r]));
    }
    __syncthreads();

    // dV[rows, D] += P^T dO and dK[rows, D] += dS^T Q for this warp's key rows
#pragma unroll
    for (int tn = 0; tn < D / 16; ++tn) {
      warp_mma<T, false, true, BQ>(t.dVacc + row0 * LDA + tn * 16, LDA, t.Ps + row0, kLdProb,
                                   t.dOs + tn * 16, LDT, true);
      warp_mma<T, false, true, BQ>(t.dKacc + row0 * LDA + tn * 16, LDA, t.dSs + row0, kLdProb,
                                   t.Qs + tn * 16, LDT, true);
    }
  }
}

// Write the accumulators once: dk = scale * dK, dv = dV, in T.
template <typename T, int D>
__device__ __forceinline__ void dkv_end(const DkvTiles<T, D>& t, T* dk, T* dv, int64_t kv_off,
                                        int64_t kv_stride, int k0, int L, float scale) {
  __syncthreads();
  store_rows<T, kBlock, D>(dk + kv_off, kv_stride, k0, L, t.dKacc, Ld<D>::acc, scale);
  store_rows<T, kBlock, D>(dv + kv_off, kv_stride, k0, L, t.dVacc, Ld<D>::acc, 1.f);
}

// Grid (ceil(L / 64), B * Hkv); query heads hk*G .. hk*G+G-1 share kv head
// hk (G = H / Hkv), as the forward and dq kernels map them.  The MHA
// instantiation (kGqa false) fixes G = 1 at compile time, so its block
// body is the one query head's walk with no group loop around it.
template <typename T, int D, bool kGqa>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int L,
                         float scale, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvTiles<T, D> t(smem);
  const int k0 = blockIdx.x * kBlock;
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int group = kGqa ? H / Hkv : 1;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t kv_off = ((int64_t)b * L * Hkv + hk) * D;
  dkv_begin<T, D>(t, k, v, kv_off, kv_stride, k0, L);
  for (int g = 0; g < group; ++g)
    dkv_accumulate<T, D>(t, q, dout, lse, delta, b, hk * group + g, H, L, k0, scale, causal,
                         window);
  dkv_end<T, D>(t, dk, dv, kv_off, kv_stride, k0, L, scale);
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
               const float* delta, void* dk, void* dv, int B, int H, int Hkv, int L,
               float scale, int causal, int window, cudaStream_t stream) {
  if (Hkv < 1 || H % Hkv) return (int)cudaErrorInvalidValue;
  const size_t smem = dkv_smem_bytes<T, D>();
  auto kern = Hkv < H ? flash_bwd_dkv_kernel<T, D, true> : flash_bwd_dkv_kernel<T, D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kBlock - 1) / kBlock, B * Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv,
      L, scale, causal, window);
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
                 const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                 int Hkv, int L, float scale, int causal, int window, cudaStream_t s) {
  if (D == 64)
    return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, L, scale, causal,
                             window, s);
  if (D == 128)
    return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, L, scale, causal,
                              window, s);
  return (int)cudaErrorInvalidValue;
}

int dkv(int dtype, int D, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Hkv, int L,
        float scale, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case kFloat32:
      return dispatch_dkv<float>(D, q, k, v, dout, l, dl, dk, dv, B, H, Hkv, L, scale, causal,
                                 window, s);
    case kFloat16:
      return dispatch_dkv<__half>(D, q, k, v, dout, l, dl, dk, dv, B, H, Hkv, L, scale, causal,
                                  window, s);
    case kBFloat16:
      return dispatch_dkv<__nv_bfloat16>(D, q, k, v, dout, l, dl, dk, dv, B, H, Hkv, L, scale,
                                         causal, window, s);
  }
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

// MHA dk/dv (B3): k, v, dk, dv carry H heads.
extern "C" int kft_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int dtype, int B, int H, int L, int D, float scale, int causal,
                                 int window, void* stream) {
  return kft::dkv(dtype, D, q, k, v, dout, lse, delta, dk, dv, B, H, H, L, scale, causal,
                  window, stream);
}

// GQA dk/dv (B4): k, v, dk, dv carry Hkv < H heads, H a multiple of Hkv.
extern "C" int kft_flash_bwd_dkv_gqa(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int dtype, int B, int H, int Hkv, int L,
                                     int D, float scale, int causal, int window, void* stream) {
  if (Hkv >= H) return (int)cudaErrorInvalidValue;
  return kft::dkv(dtype, D, q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, L, scale, causal,
                  window, stream);
}
