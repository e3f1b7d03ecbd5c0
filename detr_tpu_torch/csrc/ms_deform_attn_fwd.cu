// Multi-scale deformable attention, forward, for Hopper (sm_90a), CUDA C++.
//
// Replaces no kernel of the JAX package: neither package had Deformable DETR
// (arXiv:2010.04159).  Its core (the published MSDeformAttnFunction) is a
// bilinear gather: for each query q and head h, L levels x P points, each a
// learned location (x, y) in [0, 1] of its level's map and a softmaxed weight
//
//   out[b, q, h, :] = sum_{l, p} a[b, q, h, l, p] * bilinear(value_l[b, :, :, h, :], x, y)
//
// with grid_sample's align_corners=False pixels (px = x * W_l - 0.5,
// py = y * H_l - 0.5) and zero padding: a corner outside the map adds zero.
// The plain version is ops/ms_deform_attn.py::ms_deform_attn_reference
// (grid_sample per level), which the CPU runs and this kernel is held to.
//
// Layouts: value (B, S, H, D) in the compute dtype (bf16 or fp32), S the
// levels' H_l * W_l cells flattened h-major one level after another (level l
// starts at row start_l); locations (B, Lq, H, L, P, 2) and weights
// (B, Lq, H, L, P) fp32; out (B, Lq, H, D) in value's dtype.
//
// What bounds it: bytes.  A sample reads four corners of D values and the
// work per byte is a multiply-add, far below the card's ~20 FLOP/byte fp32
// balance; at the cell's encoder shapes (B 4, Lq = S = 23,205, H 8, D 32,
// 16 samples) the locations and weights alone are 143 MB of the ~240 MB a
// call must move.  The gathers are random within a level, so they hit L2
// when the level's value slice is resident (the stride-8 level, 21 MB in
// bf16, is the largest) and are latency-bound otherwise.
//
// Design: one warp per (b, q, h), one lane per channel (D <= 32; D = 32 in
// every DETR width), so each corner is one coalesced read of D values (64
// bytes in bf16).  The warp's 16 samples' locations and weights are 48
// contiguous floats: lane i loads sample i's and the warp broadcasts them by
// shuffle, so each location is read from memory once.  Eight warps a block
// cover the 8 heads of one query, whose locations are contiguous.  fp32
// accumulation; out is written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
               const float* __restrict__ attn, T* __restrict__ out, int B, int S, int Lq,
               int H, int D, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * Lq * H) return;
  const int h = (int)(warp % H);
  const long long bq = warp / H;
  const int b = (int)(bq / Lq);
  const int n = lv.n * P;  // samples of this (b, q, h)
  const float* wloc = loc + warp * n * 2;
  const float* wattn = attn + warp * n;
  const long long row = (long long)H * D;  // elements between two cells of value
  const T* vb = value + (long long)b * S * row + (long long)h * D + lane;
  const bool active = lane < D;
  float acc = 0.f;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int mine = c0 + lane;
    float lx = 0.f, ly = 0.f, la = 0.f;
    if (mine < n) {
      lx = wloc[2 * mine];
      ly = wloc[2 * mine + 1];
      la = wattn[mine];
    }
    const int m = min(32, n - c0);
    for (int j = 0; j < m; ++j) {
      const float x = __shfl_sync(0xffffffffu, lx, j);
      const float y = __shfl_sync(0xffffffffu, ly, j);
      const float a = __shfl_sync(0xffffffffu, la, j);
      const int l = (c0 + j) / P;
      const int Hl = lv.h[l], Wl = lv.w[l];
      const float py = y * (float)Hl - 0.5f;
      const float px = x * (float)Wl - 0.5f;
      // every corner outside the map (or a NaN location): nothing to add
      if (!(py >= -1.f && px >= -1.f && py < (float)Hl && px < (float)Wl)) continue;
      const int y0 = (int)floorf(py), x0 = (int)floorf(px);
      const float ly1 = py - (float)y0, lx1 = px - (float)x0;
      const float ly0 = 1.f - ly1, lx0 = 1.f - lx1;
      const T* vl = vb + (long long)lv.start[l] * row;
      float v = 0.f;
      if (active) {
        if (y0 >= 0 && x0 >= 0) v += ly0 * lx0 * to_f(vl[((long long)y0 * Wl + x0) * row]);
        if (y0 >= 0 && x0 + 1 < Wl) v += ly0 * lx1 * to_f(vl[((long long)y0 * Wl + x0 + 1) * row]);
        if (y0 + 1 < Hl && x0 >= 0) v += ly1 * lx0 * to_f(vl[((long long)(y0 + 1) * Wl + x0) * row]);
        if (y0 + 1 < Hl && x0 + 1 < Wl)
          v += ly1 * lx1 * to_f(vl[((long long)(y0 + 1) * Wl + x0 + 1) * row]);
      }
      acc += a * v;
    }
  }
  if (active) store(out + warp * D + lane, acc);
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn, void* out, int B,
                   int S, int Lq, int H, int D, int P, const Levels& lv, cudaStream_t stream) {
  const long long warps = (long long)B * Lq * H;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  fwd_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<T*>(out), B, S, Lq, H, D, P, lv);
  return cudaGetLastError();
}

}  // namespace

// levels: L triples (H_l, W_l, start_l) in host memory.  dtype 0: fp32
// value and out, 1: bf16.  Returns a cudaError_t (0: launched).
extern "C" int ms_deform_attn_fwd(const void* value, const void* loc, const void* attn,
                                  void* out, int B, int S, int Lq, int H, int D, int L, int P,
                                  const int* levels, int dtype, void* stream) {
  if (B < 1 || S < 1 || Lq < 1 || H < 1 || D < 1 || D > 32 || L < 1 || L > kMaxLevels ||
      P < 1 || (long long)B * Lq * H > 2147483647LL * kWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv{};
  lv.n = L;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = levels[3 * l];
    lv.w[l] = levels[3 * l + 1];
    lv.start[l] = levels[3 * l + 2];
    if (lv.h[l] < 1 || lv.w[l] < 1 || lv.start[l] < 0 ||
        (long long)lv.start[l] + (long long)lv.h[l] * lv.w[l] > S) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(value, loc, attn, out, B, S, Lq, H, D, P, lv, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(value, loc, attn, out, B, S, Lq, H, D, P, lv, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
