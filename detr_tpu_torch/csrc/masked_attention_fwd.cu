// Padding-masked attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel detr_tpu/ops/pallas_attention.py::_fwd_kernel
// (launched from _flash_forward).  Per (batch, head) it computes
// s = q.k^T / sqrt(D) with fp32 accumulation, fills padded keys with
// finfo(float32).min, takes an fp32 softmax over the key row, drops
// probabilities by the counter hash of _dropout_keep (kept ones scaled by a
// multiply with 1/(1-rate)), casts them to V's dtype, accumulates P.V in
// fp32, and writes out (B, L, H, D) in the input dtype and the pre-dropout
// lse = m + log(sum) (B, H, L) fp32.
//
// What bounds it on an H100 (DETR-R50, B = 8, H = 8, D = 32, bf16):
//   * encoder self-attention, L = S = 1050: 9.0 GFLOP against 17.5 MB, so the
//     tensor cores bound it (9.1 us at 989 TFLOP/s);
//   * decoder cross (L = 100, S = 1050) and self (L = S = 100) attention do
//     little arithmetic per byte: bytes bound them (2.8 us and 0.5 us at
//     3.35 TB/s).
// What the design does about it: no score block ever reaches device memory.
// One thread block per (b, h, 64-row query tile); each thread owns one query
// row, its 32-wide accumulator and its running max and sum in registers.  K
// and V stream through shared memory in tiles of 64 keys, so each (b, h)
// reads K and V once per query tile (twice for the decoder's 100 queries)
// and the output is written once.  The products are scalar fp32 FMAs: simple
// and exact to the JAX kernel's arithmetic, but bounded by the FMA pipe
// (67 TFLOP/s), not the tensor cores.  Moving the two products to
// mma/wgmma is the way to the encoder's compute bound.
//
// Two kinds of excluded key: a padded key gets finfo(float32).min and still
// counts, so a fully masked row gives the uniform mean of V and lse saturates
// to finfo(float32).min, as in JAX; a column past S is not a key and gets
// -inf, contributing nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kD = 32;       // head size of every DETR configuration
constexpr int kBlockQ = 64;  // query rows per block, one per thread
constexpr int kBlockK = 64;  // keys staged in shared memory per tile
constexpr int kChunk = 16;   // keys scored per online-softmax update
constexpr float kMaskFill = -3.40282346638528859812e+38f;  // finfo(float32).min

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kBlockQ)
masked_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const uint8_t* __restrict__ mask,
                            T* __restrict__ out, float* __restrict__ lse, int H, int Lq,
                            int S, long long q_sb, long long q_sl, long long q_sh,
                            long long k_sb, long long k_sl, long long k_sh,
                            long long v_sb, long long v_sl, long long v_sh, float scale,
                            uint32_t seed, uint32_t thresh, float inv_keep, int dropout) {
  __shared__ float4 ks[kBlockK][kD / 4];
  __shared__ float4 vs[kBlockK][kD / 4];
  __shared__ uint8_t padded[kBlockK];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < Lq;  // ragged query edge

  float qr[kD];
  const T* qp = q + b * q_sb + (long long)(active ? row : 0) * q_sl + h * q_sh;
#pragma unroll
  for (int d = 0; d < kD; ++d) qr[d] = active ? to_float(qp[d]) : 0.f;

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (long long)b * S;
  const uint32_t row_hash = dropout_row_hash(seed, b * H + h, row);
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);

  for (int kv0 = 0; kv0 < S; kv0 += kBlockK) {
    const int n = min(kBlockK, S - kv0);  // keys in this tile, >= 1
    __syncthreads();                      // the previous tile is consumed
    for (int i = threadIdx.x; i < kBlockK * kD; i += kBlockQ) {
      const int j = i / kD;
      const int d = i % kD;
      float kx = 0.f, vx = 0.f;
      if (j < n) {
        kx = to_float(kb[(long long)(kv0 + j) * k_sl + d]);
        vx = to_float(vb[(long long)(kv0 + j) * v_sl + d]);
      }
      ksf[i] = kx;
      vsf[i] = vx;
    }
    padded[threadIdx.x] = (mb != nullptr && threadIdx.x < n) ? mb[kv0 + threadIdx.x] : 0;
    __syncthreads();

    for (int c = 0; c < n; c += kChunk) {  // key c is in range: m_new is finite
      float s[kChunk];
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 kk = ks[c + j][d4];
          dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        float sc = dot * scale;
        if (c + j >= n) {
          sc = -CUDART_INF_F;  // past S: not a key
        } else if (padded[c + j]) {
          sc = kMaskFill;  // padded key: still counts, as in JAX
        }
        s[j] = sc;
        cmax = fmaxf(cmax, sc);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);  // 0 on the first chunk (m = -inf)
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
        float pd = p;
        if (dropout) {
          pd = dropout_keep(row_hash, kv0 + c + j, thresh) ? p * inv_keep : 0.f;
        }
        const float pv = to_float(from_float<T>(pd));  // P in V's dtype
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 vv = vs[c + j][d4];
          acc[4 * d4 + 0] = fmaf(pv, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(pv, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(pv, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(pv, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (active) {
    T* op = out + (((long long)b * Lq + row) * H + h) * kD;
#pragma unroll
    for (int d = 0; d < kD; ++d) op[d] = from_float<T>(acc[d] / l);
    lse[((long long)b * H + h) * Lq + row] = m + logf(l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* lse, int B, int H, int Lq, int S, long long q_sb, long long q_sl,
                   long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                   long long v_sb, long long v_sl, long long v_sh, float scale,
                   uint32_t seed, uint32_t thresh, float inv_keep, int dropout,
                   cudaStream_t stream) {
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, H, B);
  masked_attention_fwd_kernel<T><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), static_cast<float*>(lse), H,
      Lq, S, q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, seed, thresh,
      inv_keep, dropout);
  return cudaGetLastError();
}

}  // namespace

// q (B, Lq, H, D), k and v (B, S, H, D), read through the given element
// strides of their first three dims (the last dim is contiguous); mask (B, S)
// uint8, 1 = padded key, or null; out (B, Lq, H, D) and lse (B, H, Lq)
// contiguous.  Dropout (if `dropout`): keep where the hash of (seed, b*H+h,
// row, col) >= thresh, scale kept probabilities by inv_keep.  dtype:
// 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* lse, int B, int H,
                                    int Lq, int S, int D, long long q_sb, long long q_sl,
                                    long long q_sh, long long k_sb, long long k_sl,
                                    long long k_sh, long long v_sb, long long v_sl,
                                    long long v_sh, float scale, unsigned seed,
                                    unsigned thresh, float inv_keep, int dropout, int dtype,
                                    void* stream) {
  if (D != kD || S < 1 || B < 1 || H < 1 || Lq < 1 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(q, k, v, mask, out, lse, B, H, Lq, S, q_sb, q_sl,
                                           q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale,
                                           seed, thresh, inv_keep, dropout, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, mask, out, lse, B, H, Lq, S, q_sb,
                                                   q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl,
                                                   v_sh, scale, seed, thresh, inv_keep, dropout,
                                                   st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
