// Multi-scale deformable attention, backward, for Hopper (sm_90a), CUDA C++.
//
// The gradients of csrc/ms_deform_attn_fwd.cu's function (replaces no kernel
// of the JAX package; see there for the function, the layouts and the
// sampling rule).  Given g = dLoss/dout (B, Lq, H, D) in value's dtype:
//
//   d value  : every corner a sample read gets a * w_corner * g, added into an
//              fp32 buffer (B, S, H, D) that the wrapper zeroes: a scatter,
//              since any query may sample any cell;
//   d weight : a[b, q, h, l, p] gets <g, bilinear sample>;
//   d loc    : (x, y) gets a * <g, d sample / d px> * W_l and
//              a * <g, d sample / d py> * H_l, the bilinear interpolant's
//              derivative inside the cell the sample falls in (grid_sample's).
//
// What bounds it: bytes and the scatter.  Per sample it reads four corners
// of D values and adds four rows of D fp32 into the buffer, beside the
// locations, weights and g; the adds are red.global.add.f32 (atomicAdd
// without a return), which L2 executes, one 128-byte row of D = 32 fp32 per
// warp instruction.
//
// The order of the adds into a cell of d value is the order in which the
// warps that sampled it reach L2, which changes from run to run: the sums
// are not bitwise repeatable.  Each is an fp32 sum of at most a few hundred
// terms (the queries that sampled that cell), whose rounding error is of the
// order of the number of terms times 2^-24 of their absolute sum, well below
// the bf16 value the buffer is cast to.  The weight's and the location's
// gradients are warp reductions in a fixed order, so they repeat bit for bit
// given the same inputs.
//
// Design: the forward's, one warp per (b, q, h), one lane per channel; a
// lane keeps g for its channel in a register for all the samples; the three
// per-sample sums over channels are butterfly reductions, whose result lane
// 0 writes.  A sample whose corners all lie outside its map writes zeros.

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
               const float* __restrict__ attn, const T* __restrict__ grad_out,
               float* __restrict__ grad_value, float* __restrict__ grad_loc,
               float* __restrict__ grad_attn, int B, int S, int Lq, int H, int D, int P,
               Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * Lq * H) return;
  const int h = (int)(warp % H);
  const long long bq = warp / H;
  const int b = (int)(bq / Lq);
  const int n = lv.n * P;
  const float* wloc = loc + warp * n * 2;
  const float* wattn = attn + warp * n;
  const long long row = (long long)H * D;
  const long long vbase = (long long)b * S * row + (long long)h * D + lane;
  const bool active = lane < D;
  const float g = active ? to_f(grad_out[warp * D + lane]) : 0.f;
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
      const int s = c0 + j;
      const int l = s / P;
      const int Hl = lv.h[l], Wl = lv.w[l];
      const float py = y * (float)Hl - 0.5f;
      const float px = x * (float)Wl - 0.5f;
      float d_attn = 0.f, d_px = 0.f, d_py = 0.f;
      if (py >= -1.f && px >= -1.f && py < (float)Hl && px < (float)Wl) {
        const int y0 = (int)floorf(py), x0 = (int)floorf(px);
        const float ly1 = py - (float)y0, lx1 = px - (float)x0;
        const float ly0 = 1.f - ly1, lx0 = 1.f - lx1;
        const long long base = vbase + (long long)lv.start[l] * row;
        const float top = a * g;
        float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
        if (active) {
          if (y0 >= 0 && x0 >= 0) {
            const long long o = base + ((long long)y0 * Wl + x0) * row;
            v00 = to_f(value[o]);
            atomicAdd(grad_value + o, ly0 * lx0 * top);
          }
          if (y0 >= 0 && x0 + 1 < Wl) {
            const long long o = base + ((long long)y0 * Wl + x0 + 1) * row;
            v01 = to_f(value[o]);
            atomicAdd(grad_value + o, ly0 * lx1 * top);
          }
          if (y0 + 1 < Hl && x0 >= 0) {
            const long long o = base + ((long long)(y0 + 1) * Wl + x0) * row;
            v10 = to_f(value[o]);
            atomicAdd(grad_value + o, ly1 * lx0 * top);
          }
          if (y0 + 1 < Hl && x0 + 1 < Wl) {
            const long long o = base + ((long long)(y0 + 1) * Wl + x0 + 1) * row;
            v11 = to_f(value[o]);
            atomicAdd(grad_value + o, ly1 * lx1 * top);
          }
        }
        const float sample = ly0 * lx0 * v00 + ly0 * lx1 * v01 + ly1 * lx0 * v10 + ly1 * lx1 * v11;
        d_attn = warp_sum(g * sample);
        // d sample / d px and / d py inside the cell
        const float dx = ly0 * (v01 - v00) + ly1 * (v11 - v10);
        const float dy = lx0 * (v10 - v00) + lx1 * (v11 - v01);
        d_px = warp_sum(top * dx) * (float)Wl;
        d_py = warp_sum(top * dy) * (float)Hl;
      }
      if (lane == 0) {
        grad_attn[warp * n + s] = d_attn;
        grad_loc[(warp * n + s) * 2] = d_px;
        grad_loc[(warp * n + s) * 2 + 1] = d_py;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn, const void* grad_out,
                   void* grad_value, void* grad_loc, void* grad_attn, int B, int S, int Lq,
                   int H, int D, int P, const Levels& lv, cudaStream_t stream) {
  const long long warps = (long long)B * Lq * H;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  bwd_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const T*>(grad_out),
      static_cast<float*>(grad_value), static_cast<float*>(grad_loc),
      static_cast<float*>(grad_attn), B, S, Lq, H, D, P, lv);
  return cudaGetLastError();
}

}  // namespace

// grad_value (B, S, H, D) fp32, zeroed by the caller; grad_loc and grad_attn
// fp32, every element written.  levels and dtype as the forward's.
extern "C" int ms_deform_attn_bwd(const void* value, const void* loc, const void* attn,
                                  const void* grad_out, void* grad_value, void* grad_loc,
                                  void* grad_attn, int B, int S, int Lq, int H, int D, int L,
                                  int P, const int* levels, int dtype, void* stream) {
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
  if (dtype == 0)
    return static_cast<int>(launch<float>(value, loc, attn, grad_out, grad_value, grad_loc,
                                          grad_attn, B, S, Lq, H, D, P, lv, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(value, loc, attn, grad_out, grad_value,
                                                  grad_loc, grad_attn, B, S, Lq, H, D, P, lv, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
