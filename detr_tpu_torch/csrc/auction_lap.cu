// Batched rectangular auction assignment for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel detr_tpu/matcher/pallas_auction.py::
// _auction_kernel (launched from pallas_auction_lap) and folds in the
// _greedy_complete fallback of detr_tpu/matcher/auction.py, so one launch
// computes what pallas_auction_lap returns: for each of N problems, the query
// assigned to every valid GT column of a (Q, G) cost matrix, minimising the
// total cost to within 2 * eps_min per valid GT.
//
// One thread block per problem.  The benefit matrix (G persons x Q queries,
// benefit = -cost on valid columns, 0 on padding; 40 KB at 100 x 100), the
// prices, the owners and every per-round scratch array live in shared memory
// for the whole solve, so a round reads no device memory.  The algorithm is
// the Pallas kernel's, round for round:
//   * epsilon-scaling over a static number of phases (eps0 = max|benefit| *
//     eps_start_scale, then * eps_decay down to eps_min), prices carried over;
//   * Jacobi forward rounds while more than 3 persons are unassigned: every
//     unassigned person (one warp each) bids for a hashed pick among its
//     eps-near-optimal queries; then one thread per query takes the highest
//     bid, ties to the first person, with no atomics;
//   * Gauss-Seidel rounds (one warp, one bidder at a time) until everyone is
//     assigned;
//   * in the last phase, reverse rounds until every unowned query has price 0;
//   * caps: max_iters rounds for the Jacobi stage, 8x for the tail, 16x for
//     the reverse rounds; then the greedy completion (one thread).
// The one difference from the Pallas kernel: there the round counter and the
// loop conditions span a chunk of problems; here each problem has its own, so
// the result of a problem does not depend on its neighbours.  The plain
// PyTorch version (matcher/auction.py) runs the same per-problem loops and
// the same fp32 operations in the same order (no FMA contraction is possible
// in them), so the two agree exactly.
//
// The tie-break hash (p * 1000003 + q * 7919 + it + 1) * -1640531527 overflows
// int32 in the Pallas kernel; it is computed here in uint32, where wrapping is
// defined, and masked to 30 bits.
//
// What bounds it on an H100: the solve reads N*Q*G*4 bytes of cost once
// (1.2 MB at N = 30, Q = G = 100: 0.36 us at 3.35 TB/s) and then runs a
// data-dependent number of rounds, each a few passes over the benefit matrix
// in shared memory, with block-wide barriers between the passes.  The rounds,
// serialised within a block, and the 30 blocks on 132 SMs bound it, not the
// bytes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTailK = 3;  // Gauss-Seidel rounds once at most this many persons are unassigned
constexpr float kNegLarge = -1e30f;
constexpr float kBigProfit = 1e30f;
constexpr float kBigCost = 3.4e38f;

struct Smem {
  float* benefit;  // [P][Q]
  float* prices;   // [Q]
  int* owner;      // [Q] person owning each query, -1 none
  float* newp;     // [Q] reverse round: offered price
  int* istar;      // [Q] reverse round: best person
  int* offering;   // [Q] reverse round flag; the greedy completion's owned flags
  int* obj;        // [P] query of each person, -1 unassigned, Q padding
  int* valid;      // [P]
  float* bid;      // [P]
  int* target;     // [P] Jacobi bid target, -1 not bidding; the final assignment
  float* pi;       // [P] reverse round: person profit
  int* jstar;      // [P]
  int* accept;     // [P]
  int* old_obj;    // [P]
  float* red;      // [kWarps] block reduction scratch
  int* it_share;   // [1]
};

__device__ __forceinline__ int tie_hash(int p, int q, int it) {
  const uint32_t h = ((uint32_t)p * 1000003u + (uint32_t)q * 7919u + (uint32_t)it + 1u) *
                     2654435769u;  // == -1640531527 mod 2^32
  return (int)(h & 0x3FFFFFFFu);
}

// (value, index) pairs: keep the larger value, on ties the smaller index.
__device__ __forceinline__ void warp_first_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ void warp_first_argmax(int& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One person's bid, computed by one warp: the best value w1 and its first
// index, the best other value w2, the hashed pick among the queries within
// eps of w1, and the bid price for it.  Returns the pick; *bid_out its price.
__device__ __forceinline__ int person_bid(const Smem& s, int Q, int p, float eps, int it,
                                          float* bid_out) {
  const int lane = threadIdx.x & 31;
  const float* row = s.benefit + p * Q;
  float w1 = -CUDART_INF_F;
  int best = 1 << 30;
  for (int q = lane; q < Q; q += 32) {
    const float x = row[q] - s.prices[q];
    if (x > w1) {
      w1 = x;
      best = q;
    }
  }
  warp_first_argmax(w1, best);
  const float thr = w1 - eps;
  float w2 = kNegLarge;
  int prio = -2, pick = 1 << 30;
  for (int q = lane; q < Q; q += 32) {
    const float x = row[q] - s.prices[q];
    if (q != best) w2 = fmaxf(w2, x);
    const int pr = x >= thr ? tie_hash(p, q, it) : -1;
    if (pr > prio) {
      prio = pr;
      pick = q;
    }
  }
  w2 = warp_max(w2);
  warp_first_argmax(prio, pick);
  const float w_ex = pick == best ? w2 : w1;
  const float mu = fminf(w_ex, w1 - eps);
  *bid_out = (row[pick] - mu) + eps;
  return pick;
}

// Valid persons still unassigned, counted by the whole block (a barrier).
__device__ __forceinline__ int block_unassigned(const Smem& s, int P) {
  int n = 0;
  for (int base = 0; base < P; base += kThreads) {
    const int p = base + threadIdx.x;
    n += __syncthreads_count(p < P && s.obj[p] < 0);
  }
  return n;
}

__device__ void jacobi_round(const Smem& s, int P, int Q, float eps, int it) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int p = warp; p < P; p += kWarps) {
    if (s.obj[p] >= 0) {  // assigned, or padding
      if (lane == 0) s.target[p] = -1;
      continue;
    }
    float bid;
    const int t = person_bid(s, Q, p, eps, it, &bid);
    if (lane == 0) {
      s.target[p] = t;
      s.bid[p] = bid;
    }
  }
  __syncthreads();
  // Each query takes its highest bid, ties to the first person.  Evicted
  // owners and winners are distinct persons (owners were not bidding), and
  // each person won at most one query, so the writes below never collide.
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    float top = kNegLarge;
    int win = -1;
    for (int p = 0; p < P; ++p) {
      if (s.target[p] == q && s.bid[p] > top) {
        top = s.bid[p];
        win = p;
      }
    }
    if (win >= 0) {
      const int old = s.owner[q];
      s.prices[q] = top;
      s.owner[q] = win;
      if (old >= 0 && old != win) s.obj[old] = -1;
      s.obj[win] = q;
    }
  }
  __syncthreads();
}

// Gauss-Seidel round, run by warp 0 alone: the first unassigned person bids.
__device__ void tail_round(const Smem& s, int P, int Q, float eps, int it) {
  const int lane = threadIdx.x & 31;
  int ps = 1 << 30;
  for (int p = lane; p < P; p += 32) {
    if (s.obj[p] < 0) {
      ps = p;
      break;
    }
  }
  ps = warp_min(ps);
  if (ps == 1 << 30) return;
  float bid;
  const int qs = person_bid(s, Q, ps, eps, it, &bid);
  if (lane == 0) {
    const int old = s.owner[qs];
    s.prices[qs] = bid;
    s.owner[qs] = ps;
    if (old >= 0 && old != ps) s.obj[old] = -1;
    s.obj[ps] = qs;
  }
  __syncwarp();
}

// Reverse round: unowned queries with a positive price drop it to 0 if no
// person is worth eps to them, or else offer themselves to their best person
// at the second-best interest minus eps.
__device__ void reverse_round(const Smem& s, int P, int Q, float eps) {
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int o = s.obj[p];
    float v = 0.f;
    if (o >= 0 && o < Q) v = s.benefit[p * Q + o] - s.prices[o];
    s.pi[p] = s.valid[p] ? v : kBigProfit;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    int off = 0;
    if (s.owner[q] < 0 && s.prices[q] > 0.f) {
      float b1 = -CUDART_INF_F;
      int is = 0;
      for (int p = 0; p < P; ++p) {
        const float x = s.benefit[p * Q + q] - s.pi[p];
        if (x > b1) {
          b1 = x;
          is = p;
        }
      }
      float b2 = kNegLarge;
      for (int p = 0; p < P; ++p) {
        if (p != is) b2 = fmaxf(b2, s.benefit[p * Q + q] - s.pi[p]);
      }
      if (b1 < eps) {
        s.prices[q] = 0.f;
      } else {
        off = 1;
        s.newp[q] = fmaxf(0.f, b2 - eps);
        s.istar[q] = is;
      }
    }
    s.offering[q] = off;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += kThreads) {
    float bg = kNegLarge;
    int js = 0;
    for (int q = 0; q < Q; ++q) {
      if (s.offering[q] && s.istar[q] == p) {
        const float gain = s.benefit[p * Q + q] - s.newp[q];
        if (gain > bg) {
          bg = gain;
          js = q;
        }
      }
    }
    const int acc = s.valid[p] && bg > kNegLarge / 2;
    s.old_obj[p] = s.obj[p];
    s.accept[p] = acc;
    s.jstar[p] = js;
    if (acc) s.obj[p] = js;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += kThreads) {  // vacated queries lose their owner
    const int o = s.old_obj[p];
    if (s.accept[p] && o >= 0 && o < Q) s.owner[o] = -1;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += kThreads) {  // won queries take the new owner
    if (s.accept[p]) {
      const int q = s.jstar[p];
      s.owner[q] = p;
      s.prices[q] = s.newp[q];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ gt_valid,
               int* __restrict__ query_of_gt, int* __restrict__ rounds, int Q, int G,
               float eps_start_scale, float eps_decay, float eps_min, int max_iters,
               int num_phases, int unroll) {
  extern __shared__ float smem[];
  const int P = G;
  Smem s;
  s.benefit = smem;
  s.prices = s.benefit + P * Q;
  s.owner = reinterpret_cast<int*>(s.prices + Q);
  s.newp = reinterpret_cast<float*>(s.owner + Q);
  s.istar = reinterpret_cast<int*>(s.newp + Q);
  s.offering = s.istar + Q;
  s.obj = s.offering + Q;
  s.valid = s.obj + P;
  s.bid = reinterpret_cast<float*>(s.valid + P);
  s.target = reinterpret_cast<int*>(s.bid + P);
  s.pi = reinterpret_cast<float*>(s.target + P);
  s.jstar = reinterpret_cast<int*>(s.pi + P);
  s.accept = s.jstar + P;
  s.old_obj = s.accept + P;
  s.red = reinterpret_cast<float*>(s.old_obj + P);
  s.it_share = reinterpret_cast<int*>(s.red + kWarps);

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const float* c = cost + (long long)n * Q * G;
  const uint8_t* vrow = gt_valid + (long long)n * G;

  for (int p = tid; p < P; p += kThreads) {
    s.valid[p] = vrow[p] != 0;
    s.obj[p] = s.valid[p] ? -1 : Q;  // padding persons never bid
  }
  __syncthreads();
  float local = 0.f;
  for (int i = tid; i < Q * G; i += kThreads) {  // cost[q][g] -> benefit[g][q]
    const int q = i / G;
    const int g = i % G;
    const float b = s.valid[g] ? -c[i] : 0.f;
    s.benefit[g * Q + q] = b;
    local = fmaxf(local, fabsf(b));
  }
  for (int q = tid; q < Q; q += kThreads) {
    s.prices[q] = 0.f;
    s.owner[q] = -1;
  }
  local = warp_max(local);
  if ((tid & 31) == 0) s.red[tid >> 5] = local;
  __syncthreads();
  float range = s.red[0];
  for (int w = 1; w < kWarps; ++w) range = fmaxf(range, s.red[w]);
  const float eps0 = fmaxf(fmaxf(range, 1e-6f) * eps_start_scale, eps_min);

  float eps = eps0;
  int it = 0;
  for (int ph = 0; ph < num_phases; ++ph) {
    const int before = it;
    if (eps > eps_min || ph == 0) {  // a new phase: shrink eps, drop the assignment
      eps = ph == 0 ? eps0 : fmaxf(eps * eps_decay, eps_min);
      for (int q = tid; q < Q; q += kThreads) s.owner[q] = -1;
      for (int p = tid; p < P; p += kThreads) {
        if (s.valid[p]) s.obj[p] = -1;
      }
    }
    __syncthreads();
    while (block_unassigned(s, P) > kTailK && it < max_iters) {
      for (int r = 0; r < unroll; ++r) jacobi_round(s, P, Q, eps, it++);
    }
    if (tid < 32) {
      while (true) {
        int un = 0;
        for (int p = tid; p < P; p += 32) un += s.obj[p] < 0;
        if (!(warp_sum(un) > 0 && it < 8 * max_iters)) break;
        for (int r = 0; r < 2 * unroll; ++r) tail_round(s, P, Q, eps, it++);
      }
      if (tid == 0) *s.it_share = it;
    }
    __syncthreads();
    it = *s.it_share;
    if (ph == num_phases - 1) {
      while (true) {
        int dirty = 0;
        for (int q = tid; q < Q; q += kThreads) dirty |= s.owner[q] < 0 && s.prices[q] > 0.f;
        if (!(__syncthreads_or(dirty) && it < 16 * max_iters)) break;
        for (int r = 0; r < unroll; ++r, ++it) reverse_round(s, P, Q, eps);
      }
    }
    if (tid == 0) rounds[n * num_phases + ph] = it - before;
    __syncthreads();
  }

  // The assignment of valid persons, then the greedy completion of any one
  // left unassigned at a cap: its cheapest free query, in GT order.
  if (tid == 0) {
    for (int q = 0; q < Q; ++q) s.offering[q] = 0;
    for (int g = 0; g < G; ++g) {
      const int o = s.valid[g] ? s.obj[g] : -1;
      s.target[g] = o;
      if (o >= 0) s.offering[o] = 1;
    }
    for (int g = 0; g < G; ++g) {
      if (!s.valid[g] || s.target[g] >= 0) continue;
      float best = CUDART_INF_F;
      int bq = 0;
      for (int q = 0; q < Q; ++q) {
        const float x = s.offering[q] ? kBigCost : c[q * G + g];
        if (x < best) {
          best = x;
          bq = q;
        }
      }
      s.target[g] = bq;
      s.offering[bq] = 1;
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) query_of_gt[(long long)n * G + g] = s.target[g];
}

size_t smem_bytes(int Q, int G) {
  return sizeof(float) * ((size_t)G * Q + 5 * (size_t)Q + 8 * (size_t)G + kWarps + 1);
}

}  // namespace

// cost (N, Q, G) fp32 contiguous, rows queries and columns GT, G <= Q;
// gt_valid (N, G) uint8.  Writes query_of_gt (N, G) int32 (-1 on padding) and
// rounds (N, num_phases) int32, the rounds each problem ran per phase.
// Returns the launch's cudaError_t.
extern "C" int auction_lap(const void* cost, const void* gt_valid, void* query_of_gt,
                           void* rounds, int N, int Q, int G, float eps_start_scale,
                           float eps_decay, float eps_min, int max_iters, int num_phases,
                           int unroll, void* stream) {
  if (N < 1 || G < 1 || Q < G || N > 2147483647 / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = smem_bytes(Q, G);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  auction_kernel<<<N, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(gt_valid),
      static_cast<int*>(query_of_gt), static_cast<int*>(rounds), Q, G, eps_start_scale,
      eps_decay, eps_min, max_iters, num_phases, unroll);
  return static_cast<int>(cudaGetLastError());
}
