// Padding-masked attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels of detr_tpu/ops/pallas_attention.py:
// _bwd_kernel (the single-kernel backward for S <= 2048, launched from
// _flash_backward) and _bwd_dkv_kernel / _bwd_dq_kernel (the S-blocked
// backward for larger S, launched from _flash_backward_blocked).  One
// FlashAttention-2-style split serves every S: masked_attention_bwd_dkv owns
// a tile of keys and loops over the query rows; masked_attention_bwd_dq owns
// a tile of query rows and loops over the keys.  Both rebuild
// P = exp(s - lse), s = q.k^T / sqrt(D) in fp32, from the forward's saved lse
// and regenerate the dropout keep-mask from the seed (dropout_hash.cuh, at
// absolute (row, col), so it equals the forward's under any tiling), then
//   dV = P_d^T g,  dP_d = keep * (g V^T) / (1-rate),  dS = P (dP_d - delta),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// with delta = rowsum(g * out) in fp32 from the caller, fp32 accumulation,
// dS cast to the input dtype before the dQ and dK products (as the Pallas
// kernels cast it), P_d fp32-accurate in dV (the Pallas kernels keep it fp32
// there), and gradients written in the input dtype.  A padded key has
// s = finfo(float32).min and still counts; keys past S and query rows past L
// take no part.  A fully masked row (every key of the image padded) has lse
// saturated to exactly finfo(float32).min; there P is the uniform 1/S the
// forward used (what the single-kernel Pallas backward recomputes).  Each
// output element is summed by one thread in a fixed order: no atomics, so
// two runs give the same bits.
//
// bf16 (the training path): tensor-core kernels.  A block of 4 warps owns 64
// rows, 16 per warp, whose 16x32 operands stay in registers as mma.sync A
// fragments.  The other side streams through shared memory in tiles of 64
// rows: cp.async copies 16-byte chunks into a double-buffered ring of bf16
// tiles (4 KB each, the chunk index XORed with bits 1-2 of the row so that
// ldmatrix on the 64-byte rows is free of bank conflicts) while the warps
// work on the previous tile.  For every 16 rows of the tile a warp computes
// s and dP with mma.sync.m16n8k16 (bf16 in, fp32 accumulate), applies mask,
// exp, keep-hash and dS to the accumulator fragments in registers, and feeds
// the results straight back as A fragments (the m16n8 C layout of two
// n-tiles is the m16n8k16 A layout) of dV += P_d^T g and dK += dS^T Q, or of
// dQ += dS K, with B from ldmatrix.trans on the staged tile.  P_d enters dV
// as two bf16 terms, hi = bf16(P_d) and lo = bf16(P_d - hi): about 16
// significant bits, where one bf16 value would move each term by ~1e-3.
// The gradient sums of each tile start from zero and are added to the
// running fp32 sums after it: the tensor cores do not round their fp32
// accumulation to nearest, and a chain of hundreds of mma.sync (DC5's
// S = 4200) drifts enough to flip the bf16 rounding of many more gradient
// elements than a chain of one tile.  The exp runs outside any branch (a fully masked row
// multiplies it by 1/S instead of replacing it) and dropout is a template
// argument, so the compiler can interleave the elementwise work of many
// pairs (behind a branch, each exp ran as its own short serial block).
//
// fp32 (the card-vs-CPU path): the scalar FMA kernels, one thread per key or
// query row.  Tensor cores would mean TF32, which the fp32 check refuses.
//
// What bounds the bf16 kernels on an H100 (DETR-R50 training, B = 5, H = 8,
// D = 32): the products are 8 (dK/dV) and 6 (dQ) * B*H*L*S*D operations,
// 12 and 9 us at 989 TFLOP/s for the encoder (L = S = 1092); the byte bounds
// are smaller.  But every (query, key) pair also costs an exp, the murmur3
// keep-hash, the mask select, the dS arithmetic and the bf16 packing,
// several dozen instructions as compiled on the SM's 128 lanes, which take
// longer than the ~25 us of mma.sync work at that shape.  The instruction
// rate of that elementwise work sets the pace, so wgmma and TMA, which
// speed the tensor pipe and the copies, wait until a trace shows the tensor
// pipe as the limit.  Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr float kMaskFill = -3.40282346638528859812e+38f;  // finfo(float32).min

// P of one (row, key) pair from its score and the row's saved lse.
__device__ __forceinline__ float probability(float s, float lse, float inv_s) {
  return lse == kMaskFill ? inv_s : expf(s - lse);
}

// The same without a branch, as exp(s - lse) times the row's factor: 1, or
// 1/S on a fully masked row, whose s and lse are both finfo(float32).min
// (exp(0) = 1).  Keeps the exp out of a branch, so the compiler can
// interleave the exps of many pairs.
__device__ __forceinline__ float row_factor(float lse, float inv_s) {
  return lse == kMaskFill ? inv_s : 1.f;
}

// ---------------------------------------------------------------------------
// fp32: one thread per key (dK/dV) or query row (dQ), scalar FMAs.

constexpr int kBlock = 64;  // rows (keys or queries) owned per block, one per thread

__device__ __forceinline__ void load_row(const float* __restrict__ p, bool active, float* r) {
#pragma unroll
  for (int d = 0; d < kD; ++d) r[d] = active ? p[d] : 0.f;
}

// Stage rows [r0, r0 + n) of two (B, N, H, D) tensors (at head offset) into
// shared memory, zero past n.
__device__ __forceinline__ void stage_tile(const float* __restrict__ a, const float* __restrict__ b,
                                           long long row_stride, int r0, int n, float* as,
                                           float* bs) {
  for (int i = threadIdx.x; i < kTile * kD; i += kBlock) {
    const int j = i / kD;
    const int d = i % kD;
    float ax = 0.f, bx = 0.f;
    if (j < n) {
      ax = a[(long long)(r0 + j) * row_stride + d];
      bx = b[(long long)(r0 + j) * row_stride + d];
    }
    as[i] = ax;
    bs[i] = bx;
  }
}

__global__ void __launch_bounds__(kBlock)
bwd_dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const uint8_t* __restrict__ mask,
                    const float* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int L, int S, float scale, uint32_t seed,
                    uint32_t hash_base, uint32_t hash_heads, uint32_t thresh, float inv_keep,
                    int dropout) {
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
  const uint32_t bh = dropout_head(hash_base, hash_heads, b, h);

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
      const float ds = p * (dpd - delta_s[i]);
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
      dk[key_off + d] = dkr[d] * scale;
      dv[key_off + d] = dvr[d];
    }
  }
}

__global__ void __launch_bounds__(kBlock)
bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const uint8_t* __restrict__ mask,
                   const float* __restrict__ g, const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq, int H, int L, int S,
                   float scale, uint32_t seed, uint32_t hash_base, uint32_t hash_heads,
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
  const uint32_t row_hash =
      dropout_row_hash(seed, dropout_head(hash_base, hash_heads, b, h), (uint32_t)i);

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
      const float ds = p * (dpd - delta_i);
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
    for (int d = 0; d < kD; ++d) dq[q_off + d] = dqr[d] * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tiles, cp.async double buffering.

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows owned per block, 16 per warp
constexpr float kInf = __builtin_inff();

template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                    const bf16* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int H, int L, int S, float scale, uint32_t seed,
                    uint32_t hash_base, uint32_t hash_heads, uint32_t thresh, float inv_keep,
                    int /* dropout: kDropout */) {
  __shared__ __align__(128) uint8_t qs[2][kTileBytes];
  __shared__ __align__(128) uint8_t gs[2][kTileBytes];
  __shared__ float lse_s[2][kTile];
  __shared__ float delta_s[2][kTile];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const long long row_stride = (long long)H * kD;
  const uint32_t bh = (uint32_t)(b * H + h);
  const uint32_t hash_bh = dropout_head(hash_base, hash_heads, b, h);
  const int key0 = blockIdx.x * kRows + 16 * warp;  // this warp's 16 keys
  const bf16* kb = k + (long long)b * S * row_stride + h * kD;
  const bf16* vb = v + (long long)b * S * row_stride + h * kD;
  const bf16* qb = q + (long long)b * L * row_stride + h * kD;
  const bf16* gb = g + (long long)b * L * row_stride + h * kD;
  const float* lb = lse + (long long)bh * L;
  const float* db = delta + (long long)bh * L;

  uint32_t ka[2][4], va[2][4];
  load_a(kb, row_stride, key0, S, ka);
  load_a(vb, row_stride, key0, S, va);
  int keys[2];  // this thread's rows of the fragments: key0 + lane/4, and 8 further
  bool padded[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    keys[r] = key0 + (lane >> 2) + 8 * r;
    padded[r] = mask != nullptr && keys[r] < S && mask[(long long)b * S + keys[r]];
  }
  const float inv_s = 1.f / (float)S;
  float dka[4][4] = {}, dva[4][4] = {};  // 16 keys x D, n-tiles of 8 columns

  auto stage = [&](int buf, int i0) {
    stage_rows<kThreads>(smem_addr(qs[buf]), qb, row_stride, i0, L);
    stage_rows<kThreads>(smem_addr(gs[buf]), gb, row_stride, i0, L);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      if (i < L) {
        cp_async4(smem_addr(&lse_s[buf][threadIdx.x]), lb + i);
        cp_async4(smem_addr(&delta_s[buf][threadIdx.x]), db + i);
      } else {  // a row past L: P = exp(s - inf) = 0, so dS = 0
        lse_s[buf][threadIdx.x] = kInf;
        delta_s[buf][threadIdx.x] = 0.f;
      }
    }
    cp_async_commit();
  };

  const int n_tiles = (L + kTile - 1) / kTile;
  stage(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage(buf ^ 1, (it + 1) * kTile);
    } else {
      cp_async_commit();  // an empty group, so that the wait below is for this tile
    }
    cp_async_wait_1();
    __syncthreads();
    const uint32_t qt = smem_addr(qs[buf]), gt = smem_addr(gs[buf]);
    const int i0 = it * kTile;
    float dkt[4][4] = {}, dvt[4][4] = {};  // this tile's sums (module note)
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {  // 16 query rows at a time
      float sa[2][4] = {}, pa[2][4] = {};   // S^T, dP^T: 16 keys x 2 n-tiles of 8 rows
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t qf[4], gf[4];
        ldmatrix_rows(qf, qt, 16 * c + 8 * j);
        ldmatrix_rows(gf, gt, 16 * c + 8 * j);
        mma(sa[j], ka[0], qf[0], qf[1]);
        mma(sa[j], ka[1], qf[2], qf[3]);
        mma(pa[j], va[0], gf[0], gf[1]);
        mma(pa[j], va[1], gf[2], gf[3]);
      }
      // P_d^T (hi and lo) and dS^T as A fragments: 16 keys x these 16 rows.
      uint32_t p_hi[4], p_lo[4], ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float pd[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int li = 16 * c + 8 * j + 2 * t + e;  // query row in the tile
            const float lse_i = lse_s[buf][li];
            const float s = padded[r] ? kMaskFill : sa[j][2 * r + e] * scale;
            const float p = expf(s - lse_i) * row_factor(lse_i, inv_s);
            float dpd = pa[j][2 * r + e];
            pd[e] = p;
            if (kDropout) {
              const bool keep = dropout_keep(dropout_row_hash(seed, hash_bh, i0 + li), keys[r], thresh);
              pd[e] = keep ? p * inv_keep : 0.f;
              dpd = keep ? dpd * inv_keep : 0.f;
            }
            dsv[e] = p * (dpd - delta_s[buf][li]);
          }
          const uint32_t hi = pack_bf16(pd[0], pd[1]);
          p_hi[2 * j + r] = hi;
          p_lo[2 * j + r] = pack_bf16(pd[0] - low_bf16(hi), pd[1] - high_bf16(hi));
          ds[2 * j + r] = pack_bf16(dsv[0], dsv[1]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {  // D columns 16cc .. 16cc+15
        uint32_t gf[4], qf[4];
        ldmatrix_cols(gf, gt, 16 * c, 2 * cc);
        ldmatrix_cols(qf, qt, 16 * c, 2 * cc);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma(dvt[2 * cc + n], p_hi, gf[2 * n], gf[2 * n + 1]);
          mma(dvt[2 * cc + n], p_lo, gf[2 * n], gf[2 * n + 1]);
          mma(dkt[2 * cc + n], ds, qf[2 * n], qf[2 * n + 1]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dka[n][i] += dkt[n][i];
        dva[n][i] += dvt[n][i];
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= S) continue;
    const long long off = ((long long)b * S + keys[r]) * row_stride + h * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
          pack_bf16(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) = pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                   const bf16* __restrict__ g, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq, int H, int L, int S,
                   float scale, uint32_t seed, uint32_t hash_base, uint32_t hash_heads,
                   uint32_t thresh, float inv_keep, int /* dropout: kDropout */) {
  __shared__ __align__(128) uint8_t ks[2][kTileBytes];
  __shared__ __align__(128) uint8_t vs[2][kTileBytes];
  __shared__ uint8_t excluded[2][kTile];  // per key: 0 counts, 1 padded (counts as finfo.min), 2 past S

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const long long row_stride = (long long)H * kD;
  const uint32_t bh = (uint32_t)(b * H + h);
  const uint32_t hash_bh = dropout_head(hash_base, hash_heads, b, h);
  const int row0 = blockIdx.x * kRows + 16 * warp;  // this warp's 16 query rows
  const bf16* qb = q + (long long)b * L * row_stride + h * kD;
  const bf16* gb = g + (long long)b * L * row_stride + h * kD;
  const bf16* kb = k + (long long)b * S * row_stride + h * kD;
  const bf16* vb = v + (long long)b * S * row_stride + h * kD;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (long long)b * S;

  uint32_t qa[2][4], ga[2][4];
  load_a(qb, row_stride, row0, L, qa);
  load_a(gb, row_stride, row0, L, ga);
  int rows[2];  // this thread's rows of the fragments: row0 + lane/4, and 8 further
  float lse_r[2], delta_r[2], row_scale[2];
  uint32_t row_hash[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = row0 + (lane >> 2) + 8 * r;
    const bool active = rows[r] < L;
    lse_r[r] = active ? lse[(long long)bh * L + rows[r]] : 0.f;
    delta_r[r] = active ? delta[(long long)bh * L + rows[r]] : 0.f;
    row_scale[r] = row_factor(lse_r[r], 1.f / (float)S);
    row_hash[r] = dropout_row_hash(seed, hash_bh, (uint32_t)rows[r]);
  }
  float dqa[4][4] = {};  // 16 rows x D, n-tiles of 8 columns

  auto stage = [&](int buf, int j0) {
    stage_rows<kThreads>(smem_addr(ks[buf]), kb, row_stride, j0, S);
    stage_rows<kThreads>(smem_addr(vs[buf]), vb, row_stride, j0, S);
    cp_async_commit();
  };
  auto exclusion = [&](int j) -> uint8_t {  // of key j
    return j >= S ? 2 : (mb != nullptr && mb[j]) ? 1 : 0;
  };

  const int n_tiles = (S + kTile - 1) / kTile;
  stage(0, 0);
  if (threadIdx.x < kTile) excluded[0][threadIdx.x] = exclusion(threadIdx.x);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < n_tiles;
    uint8_t next = 0;  // the next tile's exclusion, loaded now, stored after this tile's work
    if (more) {
      stage(buf ^ 1, (it + 1) * kTile);
      if (threadIdx.x < kTile) next = exclusion((it + 1) * kTile + threadIdx.x);
    } else {
      cp_async_commit();  // an empty group, so that the wait below is for this tile
    }
    cp_async_wait_1();
    __syncthreads();
    const uint32_t kt = smem_addr(ks[buf]), vt = smem_addr(vs[buf]);
    const int j0 = it * kTile;
    float dqt[4][4] = {};  // this tile's sums (module note)
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {  // 16 keys at a time
      float sa[2][4] = {}, pa[2][4] = {};   // S, dP: 16 rows x 2 n-tiles of 8 keys
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t kf[4], vf[4];
        ldmatrix_rows(kf, kt, 16 * c + 8 * j);
        ldmatrix_rows(vf, vt, 16 * c + 8 * j);
        mma(sa[j], qa[0], kf[0], kf[1]);
        mma(sa[j], qa[1], kf[2], kf[3]);
        mma(pa[j], ga[0], vf[0], vf[1]);
        mma(pa[j], ga[1], vf[2], vf[3]);
      }
      uint32_t ds[4];  // dS as an A fragment: 16 rows x these 16 keys
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int lj = 16 * c + 8 * j + 2 * t + e;  // key in the tile
            // a key past S scores -inf: P = 0 on every row
            const uint8_t x = excluded[buf][lj];
            const float fill = x == 2 ? -kInf : kMaskFill;
            const float s = x ? fill : sa[j][2 * r + e] * scale;
            const float p = expf(s - lse_r[r]) * row_scale[r];
            float dpd = pa[j][2 * r + e];
            if (kDropout) dpd = dropout_keep(row_hash[r], j0 + lj, thresh) ? dpd * inv_keep : 0.f;
            dsv[e] = p * (dpd - delta_r[r]);
          }
          ds[2 * j + r] = pack_bf16(dsv[0], dsv[1]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {  // D columns 16cc .. 16cc+15
        uint32_t kf[4];
        ldmatrix_cols(kf, kt, 16 * c, 2 * cc);
        mma(dqt[2 * cc], ds, kf[0], kf[1]);
        mma(dqt[2 * cc + 1], ds, kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dqa[n][i] += dqt[n][i];
    }
    if (more && threadIdx.x < kTile) excluded[buf ^ 1][threadIdx.x] = next;
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    const long long off = ((long long)b * L + rows[r]) * row_stride + h * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<uint32_t*>(dq + off + 8 * n) =
          pack_bf16(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *mask, *g, *lse, *delta;
  void *out0, *out1;
  int B, H, L, S;
  float scale;
  uint32_t seed, hash_base, hash_heads, thresh;
  float inv_keep;
  int dropout;
  cudaStream_t stream;
};

template <typename T, typename Kernel>
cudaError_t launch_dkv(Kernel kernel, int rows_per_block, int threads, const Args& a) {
  const dim3 grid((a.S + rows_per_block - 1) / rows_per_block, a.H, a.B);
  kernel<<<grid, threads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.g),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H, a.L, a.S, a.scale, a.seed,
      a.hash_base, a.hash_heads, a.thresh, a.inv_keep, a.dropout);
  return cudaGetLastError();
}

template <typename T, typename Kernel>
cudaError_t launch_dq(Kernel kernel, int rows_per_block, int threads, const Args& a) {
  const dim3 grid((a.L + rows_per_block - 1) / rows_per_block, a.H, a.B);
  kernel<<<grid, threads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.g),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.H, a.L, a.S, a.scale, a.seed, a.hash_base, a.hash_heads,
      a.thresh, a.inv_keep, a.dropout);
  return cudaGetLastError();
}

int dispatch(bool dkv, int D, int dtype, const Args& a) {
  if (D != kD || a.S < 1 || a.L < 1 || a.B < 1 || a.H < 1 || a.B > 65535 || a.H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return static_cast<int>(dkv ? launch_dkv<float>(bwd_dkv_fp32_kernel, kBlock, kBlock, a)
                                : launch_dq<float>(bwd_dq_fp32_kernel, kBlock, kBlock, a));
  }
  if (dtype == 1) {
    // cp.async copies 16-byte chunks of q, k, v and g; the outputs take 4-byte stores.
    const uintptr_t bits = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                           reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.g);
    if (bits % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
    if (dkv) {
      return static_cast<int>(launch_dkv<bf16>(
          a.dropout ? bwd_dkv_bf16_kernel<true> : bwd_dkv_bf16_kernel<false>, kRows, kThreads, a));
    }
    return static_cast<int>(launch_dq<bf16>(
        a.dropout ? bwd_dq_bf16_kernel<true> : bwd_dq_bf16_kernel<false>, kRows, kThreads, a));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

uint32_t hash_base(int b_off, int h_off, int h_total) {
  return (uint32_t)b_off * (uint32_t)h_total + (uint32_t)h_off;
}

bool hash_in_range(int B, int H, int b_off, int h_off, int h_total) {
  return B >= 1 && H >= 1 && b_off >= 0 && h_off >= 0 && h_off + H <= h_total;
}

}  // namespace

// q, g (B, L, H, D) and k, v (B, S, H, D) contiguous in the input dtype (bf16:
// 16-byte aligned); mask (B, S) uint8, 1 = padded key, or null; lse and delta
// (B, H, L) fp32.  masked_attention_bwd_dkv writes dk, dv (B, S, H, D);
// masked_attention_bwd_dq writes dq (B, L, H, D) into its first output and
// ignores the second.  Dropout (if `dropout`): keep where the hash of
// (seed, (b_off + b) * h_total + h_off + h, row, col) >= thresh, scale by
// inv_keep (the forward's hash base).  dtype: 0 = float32, 1 = bfloat16.
// Each returns its launch's cudaError_t.
extern "C" int masked_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* mask, const void* g, const void* lse,
                                        const void* delta, void* dk, void* dv, int B, int H,
                                        int L, int S, int D, float scale, unsigned seed,
                                        unsigned thresh, float inv_keep, int dropout,
                                        int b_off, int h_off, int h_total, int dtype,
                                        void* stream) {
  const Args a{q, k, v, mask, g, lse, delta, dk, dv, B, H, L, S, scale, seed,
               hash_base(b_off, h_off, h_total), (uint32_t)h_total, thresh, inv_keep, dropout,
               static_cast<cudaStream_t>(stream)};
  return hash_in_range(B, H, b_off, h_off, h_total) ? dispatch(true, D, dtype, a)
                                                    : static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int masked_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* mask, const void* g, const void* lse,
                                       const void* delta, void* dq, void* unused, int B, int H,
                                       int L, int S, int D, float scale, unsigned seed,
                                       unsigned thresh, float inv_keep, int dropout, int b_off,
                                       int h_off, int h_total, int dtype, void* stream) {
  const Args a{q, k, v, mask, g, lse, delta, dq, unused, B, H, L, S, scale, seed,
               hash_base(b_off, h_off, h_total), (uint32_t)h_total, thresh, inv_keep, dropout,
               static_cast<cudaStream_t>(stream)};
  return hash_in_range(B, H, b_off, h_off, h_total) ? dispatch(false, D, dtype, a)
                                                    : static_cast<int>(cudaErrorInvalidValue);
}
