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
// Two kinds of excluded key: a padded key gets finfo(float32).min and still
// counts, so a fully masked row gives the uniform mean of V and lse saturates
// to finfo(float32).min, as in JAX; a column past S is not a key and gets
// -inf, contributing nothing.
//
// bf16 (serving and training): a two-pass tensor-core kernel.  The Pallas
// kernel normalises P before it casts P to bf16; a one-pass (online-softmax)
// kernel casts the unnormalised exp(s - m_running) instead, a different bf16
// rounding that flips about half of the bf16 outputs by an ulp
// (tests/test_torch_port_attention_fwd.py).  So pass 1 computes each row's
// statistics, lse = m + log(l), from a running fp32 max and sum over the key
// tiles, and pass 2 recomputes s and forms the normalised
// P = exp(s - lse) (times 1/S on a fully masked row, whose s and lse are both
// finfo(float32).min), drops it, rounds it to bf16 and accumulates P.V.
// Each warp keeps 16 query rows in registers as mma.sync A fragments; K (and,
// in pass 2, V) streams through the double-buffered cp.async ring of
// mma_tiles.cuh in tiles of 64 keys.  s comes from mma.sync.m16n8k16 on the
// staged K tile; mask, exp, keep-hash and the bf16 cast run on the
// accumulator fragments in registers, which feed O += P_d.V as A fragments,
// with B from ldmatrix.trans on the staged V tile.  Each tile's O starts from
// zero and is added to the running fp32 sum after it (the tensor cores do not
// round their fp32 accumulation to nearest; a long chain drifts).  The exps
// run outside any branch and dropout is a template argument.
//
// Filling the card: a block of 4 warps owns 64 query rows when L is long
// (the encoder: 18 row blocks per head).  At the decoder's L = 100 that gives
// 2 blocks per (batch, head), 80 for B = 5, H = 8, on 132 SMs; there the 4
// warps of a block share 32 or 16 query rows and split each key tile between
// them (warp p of a row group takes the 16-key chunks p, p + split, ...).
// They combine their row statistics after pass 1, and their partial outputs
// after pass 2, through shared memory in a fixed warp order: no atomics, so
// two launches give the same bits.
//
// fp32 (the card-vs-CPU path): the scalar one-pass kernel, one thread per
// query row.  Casting P to fp32 is the identity, so one pass computes the
// same function up to fp32 rounding; tensor cores would mean TF32, which the
// fp32 check refuses.
//
// What bounds it on an H100 (DETR-R50, B = 5..8, H = 8, D = 32, bf16): the
// function's own products are 4 * B*H*L*S*D operations (9.1 us at 989
// TFLOP/s for the encoder, L = S = 1050-1092); the two passes do 6.  The
// decoder's shapes are bound by bytes (a few us).  As in the backward
// kernels, the elementwise work per (query, key) pair (two exps, the
// keep-hash, the selects, the bf16 packing) takes longer than the mma.sync
// work at the encoder's shapes, so the instruction rate of that work sets
// the pace; at the decoder's, each block walks 2 * S/64 tile steps in
// series and each step waits on its copy.  Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr float kMaskFill = -3.40282346638528859812e+38f;  // finfo(float32).min
constexpr float kInf = __builtin_inff();

// ---------------------------------------------------------------------------
// fp32: one thread per query row, scalar FMAs, one pass.

constexpr int kBlockQ = 64;  // query rows per block, one per thread
constexpr int kChunk = 16;   // keys scored per online-softmax update

__global__ void __launch_bounds__(kBlockQ)
fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                float* __restrict__ out, float* __restrict__ lse, int H, int Lq, int S,
                long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                long long k_sh, long long v_sb, long long v_sl, long long v_sh, float scale,
                uint32_t seed, uint32_t hash_base, uint32_t hash_heads, uint32_t thresh,
                float inv_keep, int dropout) {
  __shared__ float4 ks[kTile][kD / 4];
  __shared__ float4 vs[kTile][kD / 4];
  __shared__ uint8_t padded[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < Lq;  // ragged query edge

  float qr[kD];
  const float* qp = q + b * q_sb + (long long)(active ? row : 0) * q_sl + h * q_sh;
#pragma unroll
  for (int d = 0; d < kD; ++d) qr[d] = active ? qp[d] : 0.f;

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (long long)b * S;
  const uint32_t row_hash =
      dropout_row_hash(seed, dropout_head(hash_base, hash_heads, b, h), row);
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);

  for (int kv0 = 0; kv0 < S; kv0 += kTile) {
    const int n = min(kTile, S - kv0);  // keys in this tile, >= 1
    __syncthreads();                    // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * kD; i += kBlockQ) {
      const int j = i / kD;
      const int d = i % kD;
      float kx = 0.f, vx = 0.f;
      if (j < n) {
        kx = kb[(long long)(kv0 + j) * k_sl + d];
        vx = vb[(long long)(kv0 + j) * v_sl + d];
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
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 vv = vs[c + j][d4];
          acc[4 * d4 + 0] = fmaf(pd, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(pd, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(pd, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(pd, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (active) {
    float* op = out + (((long long)b * Lq + row) * H + h) * kD;
#pragma unroll
    for (int d = 0; d < kD; ++d) op[d] = acc[d] / l;
    lse[((long long)b * H + h) * Lq + row] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// bf16: two passes on mma.sync tiles, cp.async double buffering.

// 1, or 1/S on a fully masked row (lse exactly finfo(float32).min), where
// exp(s - lse) = exp(0) = 1 for every padded key: P is the uniform 1/S.
__device__ __forceinline__ float row_factor(float lse, float inv_s) {
  return lse == kMaskFill ? inv_s : 1.f;
}

// 4 warps per block; the warps of one row group (kSplit of them) share 16
// query rows and split each key tile into 16-key chunks between them.
constexpr int kWarps = 4;

template <int kSplit, bool kDropout>
__global__ void __launch_bounds__(32 * kWarps)
fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                bf16* __restrict__ out, float* __restrict__ lse, int H, int L, int S,
                long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                long long k_sh, long long v_sb, long long v_sl, long long v_sh, float scale,
                uint32_t seed, uint32_t hash_base, uint32_t hash_heads, uint32_t thresh,
                float inv_keep) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kRows = 16 * (kWarps / kSplit);     // query rows per block
  constexpr int kChunks = kTile / 16 / kSplit;      // 16-key chunks per warp and tile
  constexpr int kExcl = (kTile + kThreads - 1) / kThreads;  // exclusion bytes per thread
  __shared__ __align__(128) uint8_t ks[2][kTileBytes];
  __shared__ __align__(128) uint8_t vs[2][kTileBytes];
  __shared__ uint8_t excluded[2][kTile];  // per key: 0 counts, 1 padded (counts as finfo.min), 2 past S
  __shared__ float part_stats[kSplit > 1 ? kWarps : 1][16][2];      // (m, l) of a warp's keys
  __shared__ float part_out[kSplit > 1 ? kWarps : 1][16][kD + 4];  // a warp's share of O

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const int group = warp / kSplit, part = warp % kSplit;
  const uint32_t bh = (uint32_t)(b * H + h);
  const uint32_t hash_bh = dropout_head(hash_base, hash_heads, b, h);
  const int row0 = blockIdx.x * kRows + 16 * group;  // this warp's 16 query rows
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (long long)b * S;

  uint32_t qa[2][4];
  load_a(q + b * q_sb + h * q_sh, q_sl, row0, L, qa);
  int rows[2];  // this thread's rows of the fragments: row0 + lane/4, and 8 further
  uint32_t row_hash[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = row0 + g + 8 * r;
    row_hash[r] = dropout_row_hash(seed, hash_bh, (uint32_t)rows[r]);
  }
  // Pass 1: the running max of each row (equal on the 4 lanes of a row; it
  // starts at finfo.min, which every key in range reaches) and this lane's
  // share of the running sum of exp(s - max).
  float m[2] = {kMaskFill, kMaskFill}, l[2] = {0.f, 0.f};
  float lse_r[2] = {0.f, 0.f}, row_scale[2] = {1.f, 1.f};  // pass 2
  float oa[4][4] = {};  // 16 rows x D, n-tiles of 8 columns

  const int n_tiles = (S + kTile - 1) / kTile;
  const int n_steps = 2 * n_tiles;  // pass 1 over every tile, then pass 2
  auto key0 = [&](int step) { return (step < n_tiles ? step : step - n_tiles) * kTile; };
  auto stage = [&](int buf, int step) {
    stage_rows<kThreads>(smem_addr(ks[buf]), kb, k_sl, key0(step), S);
    if (step >= n_tiles) stage_rows<kThreads>(smem_addr(vs[buf]), vb, v_sl, key0(step), S);
    cp_async_commit();
  };
  auto exclusion = [&](int j) -> uint8_t {  // of key j
    return j >= S ? 2 : (mb != nullptr && mb[j]) ? 1 : 0;
  };
  // s of this warp's 16 rows and the 16 keys of chunk c of the staged tile,
  // excluded keys filled: C fragments of two n-tiles of 8 keys.
  auto scores = [&](uint32_t kt, int buf, int c, float (&sa)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t kf[4];
      ldmatrix_rows(kf, kt, 16 * c + 8 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[j][i] = 0.f;
      mma(sa[j], qa[0], kf[0], kf[1]);
      mma(sa[j], qa[1], kf[2], kf[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t x = excluded[buf][16 * c + 8 * j + 2 * t + (i & 1)];
        const float fill = x == 2 ? -kInf : kMaskFill;
        sa[j][i] = x ? fill : sa[j][i] * scale;
      }
    }
  };

  stage(0, 0);
  for (int i = threadIdx.x; i < kTile; i += kThreads) excluded[0][i] = exclusion(i);
  for (int it = 0; it < n_steps; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < n_steps;
    uint8_t next[kExcl];  // the next tile's exclusion, loaded now, stored after this tile's work
    if (more) {
      stage(buf ^ 1, it + 1);
#pragma unroll
      for (int e = 0; e < kExcl; ++e) {
        const int i = threadIdx.x + e * kThreads;
        next[e] = i < kTile ? exclusion(key0(it + 1) + i) : 0;
      }
    } else {
      cp_async_commit();  // an empty group, so that the wait below is for this tile
    }
    cp_async_wait_1();
    __syncthreads();
    const uint32_t kt = smem_addr(ks[buf]);

    if (it < n_tiles) {  // pass 1: the row statistics
      float sc[kChunks][2][4];
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc) scores(kt, buf, part + kSplit * cc, sc[cc]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int cc = 0; cc < kChunks; ++cc) {
#pragma unroll
          for (int j = 0; j < 2; ++j) mx = fmaxf(mx, fmaxf(sc[cc][j][2 * r], sc[cc][j][2 * r + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float sum = 0.f;
#pragma unroll
        for (int cc = 0; cc < kChunks; ++cc) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            sum += expf(sc[cc][j][2 * r] - mx);
            sum += expf(sc[cc][j][2 * r + 1] - mx);
          }
        }
        l[r] = l[r] * expf(m[r] - mx) + sum;
        m[r] = mx;
      }
      if (it == n_tiles - 1) {  // the row's sum over its 4 lanes, then over the warps
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          if (kSplit > 1 && t == 0) {
            part_stats[warp][g + 8 * r][0] = m[r];
            part_stats[warp][g + 8 * r][1] = l[r];
          }
        }
      }
    } else {  // pass 2: O += P_d V
      if (it == n_tiles) {  // part_stats were written before the last barrier
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r], sum = l[r];
          if (kSplit > 1) {
            mx = kMaskFill;
#pragma unroll
            for (int w = 0; w < kSplit; ++w) mx = fmaxf(mx, part_stats[group * kSplit + w][g + 8 * r][0]);
            sum = 0.f;
#pragma unroll
            for (int w = 0; w < kSplit; ++w) {
              const float* st = part_stats[group * kSplit + w][g + 8 * r];
              sum += st[1] * expf(st[0] - mx);
            }
          }
          lse_r[r] = mx + logf(sum);  // finfo.min exactly on a fully masked row
          row_scale[r] = row_factor(lse_r[r], 1.f / (float)S);
        }
      }
      const uint32_t vt = smem_addr(vs[buf]);
      const int j0 = key0(it);
      float ot[4][4] = {};  // this tile's sums (module note)
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc) {
        const int c = part + kSplit * cc;
        float sa[2][4];
        scores(kt, buf, c, sa);
        uint32_t pa[4];  // P_d as an A fragment: 16 rows x these 16 keys
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float pd[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float p = expf(sa[j][2 * r + e] - lse_r[r]) * row_scale[r];
              if (kDropout) {
                p = dropout_keep(row_hash[r], j0 + 16 * c + 8 * j + 2 * t + e, thresh) ? p * inv_keep
                                                                                       : 0.f;
              }
              pd[e] = p;
            }
            pa[2 * j + r] = pack_bf16(pd[0], pd[1]);
          }
        }
#pragma unroll
        for (int cv = 0; cv < 2; ++cv) {  // D columns 16cv .. 16cv+15
          uint32_t vf[4];
          ldmatrix_cols(vf, vt, 16 * c, 2 * cv);
          mma(ot[2 * cv], pa, vf[0], vf[1]);
          mma(ot[2 * cv + 1], pa, vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) oa[n][i] += ot[n][i];
      }
    }
    if (more) {
#pragma unroll
      for (int e = 0; e < kExcl; ++e) {
        const int i = threadIdx.x + e * kThreads;
        if (i < kTile) excluded[buf ^ 1][i] = next[e];
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  if (kSplit > 1) {  // the row group's partial outputs, added in warp order
    if (part > 0) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part_out[warp][g + 8 * (i >> 1)][8 * n + 2 * t + (i & 1)] = oa[n][i];
      }
    }
    __syncthreads();
    if (part > 0) return;
#pragma unroll
    for (int w = 1; w < kSplit; ++w) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) oa[n][i] += part_out[warp + w][g + 8 * (i >> 1)][8 * n + 2 * t + (i & 1)];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    const long long off = (((long long)b * L + rows[r]) * H + h) * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<uint32_t*>(out + off + 8 * n) = pack_bf16(oa[n][2 * r], oa[n][2 * r + 1]);
    }
    if (t == 0) lse[(long long)bh * L + rows[r]] = lse_r[r];
  }
}

struct Args {
  const void *q, *k, *v, *mask;
  void *out, *lse;
  int B, H, L, S;
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
  float scale;
  uint32_t seed, hash_base, hash_heads, thresh;
  float inv_keep;
  int dropout;
  cudaStream_t stream;
};

cudaError_t launch_fp32(const Args& a) {
  const dim3 grid((a.L + kBlockQ - 1) / kBlockQ, a.H, a.B);
  fwd_fp32_kernel<<<grid, kBlockQ, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<float*>(a.out), static_cast<float*>(a.lse), a.H, a.L, a.S, a.q_sb, a.q_sl,
      a.q_sh, a.k_sb, a.k_sl, a.k_sh, a.v_sb, a.v_sl, a.v_sh, a.scale, a.seed,
      a.hash_base, a.hash_heads, a.thresh,
      a.inv_keep, a.dropout);
  return cudaGetLastError();
}

template <int kSplit>
cudaError_t launch_bf16(const Args& a) {
  constexpr int kRows = 16 * (kWarps / kSplit);
  const dim3 grid((a.L + kRows - 1) / kRows, a.H, a.B);
  auto kernel = a.dropout ? fwd_bf16_kernel<kSplit, true> : fwd_bf16_kernel<kSplit, false>;
  kernel<<<grid, 32 * kWarps, 0, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<bf16*>(a.out), static_cast<float*>(a.lse), a.H, a.L, a.S, a.q_sb, a.q_sl,
      a.q_sh, a.k_sb, a.k_sl, a.k_sh, a.v_sb, a.v_sl, a.v_sh, a.scale, a.seed,
      a.hash_base, a.hash_heads, a.thresh,
      a.inv_keep);
  return cudaGetLastError();
}

// The key split of the bf16 kernel's 4-warp blocks: 1 (64 rows per block)
// unless that gives fewer than two blocks per SM, then 2 (32 rows), then 4
// (16 rows).  The SM count is read once, from the first device launched on.
int key_split(const Args& a) {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
  }();
  const long long heads = (long long)a.B * a.H;
  for (int split = 1; split < 4; split *= 2) {
    const int rows = 64 / split;
    if ((a.L + rows - 1) / rows * heads >= 2LL * sms) return split;
  }
  return 4;
}

cudaError_t launch_bf16_chosen(const Args& a) {
  switch (key_split(a)) {
    case 1:
      return launch_bf16<1>(a);
    case 2:
      return launch_bf16<2>(a);
    default:
      return launch_bf16<4>(a);
  }
}

}  // namespace

// q (B, Lq, H, D), k and v (B, S, H, D), read through the given element
// strides of their first three dims (the last dim is contiguous; bf16: every
// row starts on 16 bytes, so the strides are multiples of 8); mask (B, S)
// uint8, 1 = padded key, or null; out (B, Lq, H, D) and lse (B, H, Lq)
// contiguous.  Dropout (if `dropout`): keep where the hash of (seed,
// (b_off + b) * h_total + h_off + h, row, col) >= thresh, scale kept
// probabilities by inv_keep; b_off, h_off and h_total place this launch's
// heads in the global batch and head count (0, 0, H on one process).  dtype:
// 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* lse, int B, int H,
                                    int Lq, int S, int D, long long q_sb, long long q_sl,
                                    long long q_sh, long long k_sb, long long k_sl,
                                    long long k_sh, long long v_sb, long long v_sl,
                                    long long v_sh, float scale, unsigned seed,
                                    unsigned thresh, float inv_keep, int dropout, int b_off,
                                    int h_off, int h_total, int dtype, void* stream) {
  if (D != kD || S < 1 || B < 1 || H < 1 || Lq < 1 || B > 65535 || H > 65535 || b_off < 0 ||
      h_off < 0 || h_off + H > h_total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t hash_base = (uint32_t)b_off * (uint32_t)h_total + (uint32_t)h_off;
  const Args a{q,    k,    v,    mask, out,  lse,   B,    H,      Lq,       S,
               q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,  v_sb, v_sl,   v_sh,     scale,
               seed, hash_base, (uint32_t)h_total, thresh, inv_keep, dropout,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return static_cast<int>(launch_fp32(a));
  if (dtype == 1) {
    // cp.async copies 16-byte chunks of k and v; q is read 4 bytes at a time.
    const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v);
    const long long strides = q_sb | q_sl | q_sh | k_sb | k_sl | k_sh | v_sb | v_sl | v_sh;
    if (bits % 16 != 0 || strides % 8 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    return static_cast<int>(launch_bf16_chosen(a));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
