// Padding-masked attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels of detr_tpu/ops/pallas_attention.py:
// _bwd_kernel (the single-kernel backward for S <= 2048, launched from
// _flash_backward) and _bwd_dkv_kernel / _bwd_dq_kernel (the S-blocked
// backward for larger S, launched from _flash_backward_blocked).  One
// FlashAttention-2-style design serves every S:
//   * delta = rowsum(g * out) in fp32 comes in from the caller;
//   * masked_attention_bwd_dkv: one block per (b, h, 64-key tile), one thread
//     per key, looping over the query rows in tiles of 64;
//   * masked_attention_bwd_dq: one block per (b, h, 64-query tile), one
//     thread per query row, looping over the keys in tiles of 64.
// Both rebuild P = exp(s - lse) from the forward's saved lse and regenerate
// the dropout keep-mask from the seed (dropout_hash.cuh), then
//   dV = P_d^T g,  dP_d = keep * (g V^T) / (1-rate),  dS = P (dP_d - delta),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// with fp32 accumulation, dS cast to the input dtype before the dQ and dK
// products (as the Pallas kernels cast it), and gradients written in the
// input dtype.  Each output element is summed by one thread in a fixed order:
// no atomics, so two runs give the same bits.
//
// A fully masked row (every key of the image padded) has lse saturated to
// exactly finfo(float32).min; there P is the uniform 1/S the forward used
// (what the single-kernel Pallas backward recomputes), not exp(0) = 1.
// Query rows past L and keys past S take no part.
//
// What bounds it on an H100 (DETR-R50 training, B = 5, H = 8, D = 32, bf16):
// the five products are 10*B*H*L*S*D operations.  The encoder self-attention
// (L = S = 1092, 15.3 GFLOP against 22.4 MB) is bound by operations (15.4 us
// at 989 TFLOP/s); the decoder's cross (L = 100, S = 1092) and self
// (L = S = 100) attention by bytes (3.6 us and 0.6 us at 3.35 TB/s).  This
// first design keeps every score out of device memory and each thread's
// 32-wide rows and accumulators in registers, but does the products with
// scalar fp32 FMAs on the FMA pipe (67 TFLOP/s), recomputing s and dP in
// both kernels; mma/wgmma tiles are the way to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kD = 32;      // head size of every DETR configuration
constexpr int kBlock = 64;  // rows (keys or queries) owned per block, one per thread
constexpr int kTile = 64;   // rows of the other side staged in shared memory per tile
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

// P of one (row, key) pair from its score and the row's saved lse.
__device__ __forceinline__ float probability(float s, float lse, float inv_s) {
  return lse == kMaskFill ? inv_s : expf(s - lse);
}

// Load one 32-wide row of a (B, N, H, D) tensor into registers as fp32.
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, bool active, float* r) {
#pragma unroll
  for (int d = 0; d < kD; ++d) r[d] = active ? to_float(p[d]) : 0.f;
}

// Stage rows [r0, r0 + n) of two (B, N, H, D) tensors (at head offset) into
// shared memory as fp32, zero past n.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ a, const T* __restrict__ b,
                                           long long row_stride, int r0, int n, float* as,
                                           float* bs) {
  for (int i = threadIdx.x; i < kTile * kD; i += kBlock) {
    const int j = i / kD;
    const int d = i % kD;
    float ax = 0.f, bx = 0.f;
    if (j < n) {
      ax = to_float(a[(long long)(r0 + j) * row_stride + d]);
      bx = to_float(b[(long long)(r0 + j) * row_stride + d]);
    }
    as[i] = ax;
    bs[i] = bx;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const uint8_t* __restrict__ mask, const T* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int L, int S, float scale,
               uint32_t seed, uint32_t thresh, float inv_keep, int dropout) {
  __shared__ float4 qs[kTile][kD / 4];
  __shared__ float4 gs[kTile][kD / 4];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int j = blockIdx.x * kBlock + threadIdx.x;  // this thread's key
  const bool active = j < S;
  const long long row_stride = (long long)H * kD;
  const long long key_off = ((long long)b * S + (active ? j : 0)) * row_stride + h * kD;

  float kr[kD], vr[kD], dkr[kD], dvr[kD];
  load_row(k + key_off, active, kr);
  load_row(v + key_off, active, vr);
#pragma unroll
  for (int d = 0; d < kD; ++d) dkr[d] = dvr[d] = 0.f;
  const bool padded = active && mask != nullptr && mask[(long long)b * S + j];
  const float inv_s = 1.f / (float)S;
  const uint32_t bh = (uint32_t)(b * H + h);

  const long long q_off = (long long)b * L * row_stride + h * kD;
  const float* lb = lse + ((long long)b * H + h) * L;
  const float* db = delta + ((long long)b * H + h) * L;
  float* qsf = reinterpret_cast<float*>(qs);
  float* gsf = reinterpret_cast<float*>(gs);

  for (int i0 = 0; i0 < L; i0 += kTile) {
    const int n = min(kTile, L - i0);  // query rows in this tile
    __syncthreads();                   // the previous tile is consumed
    stage_tile(q + q_off, g + q_off, row_stride, i0, n, qsf, gsf);
    if (threadIdx.x < n) {
      lse_s[threadIdx.x] = lb[i0 + threadIdx.x];
      delta_s[threadIdx.x] = db[i0 + threadIdx.x];
    }
    __syncthreads();

    for (int i = 0; i < n; ++i) {
      float dot = 0.f, dpv = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kD / 4; ++d4) {
        const float4 qq = qs[i][d4];
        const float4 gg = gs[i][d4];
        dot = fmaf(qq.x, kr[4 * d4 + 0], dot);
        dot = fmaf(qq.y, kr[4 * d4 + 1], dot);
        dot = fmaf(qq.z, kr[4 * d4 + 2], dot);
        dot = fmaf(qq.w, kr[4 * d4 + 3], dot);
        dpv = fmaf(gg.x, vr[4 * d4 + 0], dpv);
        dpv = fmaf(gg.y, vr[4 * d4 + 1], dpv);
        dpv = fmaf(gg.z, vr[4 * d4 + 2], dpv);
        dpv = fmaf(gg.w, vr[4 * d4 + 3], dpv);
      }
      const float s = padded ? kMaskFill : dot * scale;
      const float p = probability(s, lse_s[i], inv_s);
      float pd = p, dpd = dpv;
      if (dropout) {
        const bool keep = dropout_keep(dropout_row_hash(seed, bh, i0 + i), j, thresh);
        pd = keep ? p * inv_keep : 0.f;
        dpd = keep ? dpv * inv_keep : 0.f;
      }
      const float ds = to_float(from_float<T>(p * (dpd - delta_s[i])));  // dS in Q's dtype
#pragma unroll
      for (int d4 = 0; d4 < kD / 4; ++d4) {
        const float4 qq = qs[i][d4];
        const float4 gg = gs[i][d4];
        dvr[4 * d4 + 0] = fmaf(pd, gg.x, dvr[4 * d4 + 0]);
        dvr[4 * d4 + 1] = fmaf(pd, gg.y, dvr[4 * d4 + 1]);
        dvr[4 * d4 + 2] = fmaf(pd, gg.z, dvr[4 * d4 + 2]);
        dvr[4 * d4 + 3] = fmaf(pd, gg.w, dvr[4 * d4 + 3]);
        dkr[4 * d4 + 0] = fmaf(ds, qq.x, dkr[4 * d4 + 0]);
        dkr[4 * d4 + 1] = fmaf(ds, qq.y, dkr[4 * d4 + 1]);
        dkr[4 * d4 + 2] = fmaf(ds, qq.z, dkr[4 * d4 + 2]);
        dkr[4 * d4 + 3] = fmaf(ds, qq.w, dkr[4 * d4 + 3]);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      dk[key_off + d] = from_float<T>(dkr[d] * scale);
      dv[key_off + d] = from_float<T>(dvr[d]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const uint8_t* __restrict__ mask, const T* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int L, int S, float scale, uint32_t seed,
              uint32_t thresh, float inv_keep, int dropout) {
  __shared__ float4 ks[kTile][kD / 4];
  __shared__ float4 vs[kTile][kD / 4];
  __shared__ uint8_t padded[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int i = blockIdx.x * kBlock + threadIdx.x;  // this thread's query row
  const bool active = i < L;
  const long long row_stride = (long long)H * kD;
  const long long q_off = ((long long)b * L + (active ? i : 0)) * row_stride + h * kD;

  float qr[kD], gr[kD], dqr[kD];
  load_row(q + q_off, active, qr);
  load_row(g + q_off, active, gr);
#pragma unroll
  for (int d = 0; d < kD; ++d) dqr[d] = 0.f;
  const long long stat = ((long long)b * H + h) * L + (active ? i : 0);
  const float lse_i = active ? lse[stat] : 0.f;
  const float delta_i = active ? delta[stat] : 0.f;
  const float inv_s = 1.f / (float)S;
  const uint32_t row_hash = dropout_row_hash(seed, (uint32_t)(b * H + h), (uint32_t)i);

  const long long kv_off = (long long)b * S * row_stride + h * kD;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (long long)b * S;
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);

  for (int kv0 = 0; kv0 < S; kv0 += kTile) {
    const int n = min(kTile, S - kv0);  // keys in this tile
    __syncthreads();                    // the previous tile is consumed
    stage_tile(k + kv_off, v + kv_off, row_stride, kv0, n, ksf, vsf);
    padded[threadIdx.x] = (mb != nullptr && threadIdx.x < n) ? mb[kv0 + threadIdx.x] : 0;
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      float dot = 0.f, dpv = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kD / 4; ++d4) {
        const float4 kk = ks[j][d4];
        const float4 vv = vs[j][d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        dpv = fmaf(gr[4 * d4 + 0], vv.x, dpv);
        dpv = fmaf(gr[4 * d4 + 1], vv.y, dpv);
        dpv = fmaf(gr[4 * d4 + 2], vv.z, dpv);
        dpv = fmaf(gr[4 * d4 + 3], vv.w, dpv);
      }
      const float s = padded[j] ? kMaskFill : dot * scale;
      const float p = probability(s, lse_i, inv_s);
      float dpd = dpv;
      if (dropout) {
        dpd = dropout_keep(row_hash, kv0 + j, thresh) ? dpv * inv_keep : 0.f;
      }
      const float ds = to_float(from_float<T>(p * (dpd - delta_i)));  // dS in K's dtype
#pragma unroll
      for (int d4 = 0; d4 < kD / 4; ++d4) {
        const float4 kk = ks[j][d4];
        dqr[4 * d4 + 0] = fmaf(ds, kk.x, dqr[4 * d4 + 0]);
        dqr[4 * d4 + 1] = fmaf(ds, kk.y, dqr[4 * d4 + 1]);
        dqr[4 * d4 + 2] = fmaf(ds, kk.z, dqr[4 * d4 + 2]);
        dqr[4 * d4 + 3] = fmaf(ds, kk.w, dqr[4 * d4 + 3]);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < kD; ++d) dq[q_off + d] = from_float<T>(dqr[d] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *mask, *g, *lse, *delta;
  void *out0, *out1;
  int B, H, L, S;
  float scale;
  uint32_t seed, thresh;
  float inv_keep;
  int dropout;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_dkv(const Args& a) {
  const dim3 grid((a.S + kBlock - 1) / kBlock, a.H, a.B);
  bwd_dkv_kernel<T><<<grid, kBlock, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.g),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H, a.L, a.S, a.scale, a.seed,
      a.thresh, a.inv_keep, a.dropout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const Args& a) {
  const dim3 grid((a.L + kBlock - 1) / kBlock, a.H, a.B);
  bwd_dq_kernel<T><<<grid, kBlock, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.g),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.H, a.L, a.S, a.scale, a.seed, a.thresh, a.inv_keep,
      a.dropout);
  return cudaGetLastError();
}

int dispatch(bool dkv, int D, int dtype, const Args& a) {
  if (D != kD || a.S < 1 || a.L < 1 || a.B < 1 || a.H < 1 || a.B > 65535 || a.H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return static_cast<int>(dkv ? launch_dkv<float>(a) : launch_dq<float>(a));
  if (dtype == 1) {
    return static_cast<int>(dkv ? launch_dkv<__nv_bfloat16>(a) : launch_dq<__nv_bfloat16>(a));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, g (B, L, H, D) and k, v (B, S, H, D) contiguous in the input dtype;
// mask (B, S) uint8, 1 = padded key, or null; lse and delta (B, H, L) fp32.
// masked_attention_bwd_dkv writes dk, dv (B, S, H, D); masked_attention_bwd_dq
// writes dq (B, L, H, D) into its first output and ignores the second.
// Dropout (if `dropout`): keep where the hash of (seed, b*H+h, row, col) >=
// thresh, scale by inv_keep.  dtype: 0 = float32, 1 = bfloat16.  Each returns
// its launch's cudaError_t.
extern "C" int masked_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* mask, const void* g, const void* lse,
                                        const void* delta, void* dk, void* dv, int B, int H,
                                        int L, int S, int D, float scale, unsigned seed,
                                        unsigned thresh, float inv_keep, int dropout,
                                        int dtype, void* stream) {
  const Args a{q, k, v, mask, g, lse, delta, dk, dv, B, H, L, S, scale, seed, thresh,
               inv_keep, dropout, static_cast<cudaStream_t>(stream)};
  return dispatch(true, D, dtype, a);
}

extern "C" int masked_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* mask, const void* g, const void* lse,
                                       const void* delta, void* dq, void* unused, int B, int H,
                                       int L, int S, int D, float scale, unsigned seed,
                                       unsigned thresh, float inv_keep, int dropout, int dtype,
                                       void* stream) {
  const Args a{q, k, v, mask, g, lse, delta, dq, unused, B, H, L, S, scale, seed, thresh,
               inv_keep, dropout, static_cast<cudaStream_t>(stream)};
  return dispatch(false, D, dtype, a);
}
