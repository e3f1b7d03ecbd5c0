// Batched rectangular auction assignment for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel detr_tpu/matcher/pallas_auction.py::
// _auction_kernel (launched from pallas_auction_lap) and folds in the
// _greedy_complete fallback of detr_tpu/matcher/auction.py, so one launch
// computes what pallas_auction_lap returns: for each of N problems, the query
// assigned to every valid GT column of a (Q, G) cost matrix, minimising the
// total cost to within 2 * eps_min per valid GT.
//
// The algorithm is the Pallas kernel's, round for round:
//   * epsilon-scaling over a static number of phases (eps0 = max|benefit| *
//     eps_start_scale, then * eps_decay down to eps_min), prices carried over;
//   * Jacobi forward rounds while more than 3 persons are unassigned: every
//     unassigned person bids for a hashed pick among its eps-near-optimal
//     queries, and each query takes its highest bid, ties to the first person;
//   * Gauss-Seidel rounds (the first unassigned person bids alone) until
//     everyone is assigned;
//   * in the last phase, reverse rounds until every unowned query has price 0;
//   * caps: max_iters rounds for the Jacobi stage, 8x for the tail, 16x for
//     the reverse rounds; then the greedy completion.
// The one difference from the Pallas kernel: there the round counter and the
// loop conditions span a chunk of problems; here each problem has its own, so
// the result of a problem does not depend on its neighbours (with one problem
// per chunk the two agree exactly).  The plain PyTorch version
// (matcher/auction.py) runs the same per-problem loops and the same fp32
// operations (no multiply feeds an add, so nothing can be contracted into an
// FMA), so the kernel and it agree bit for bit.
//
// Only the valid GT ("persons") take part.  A padding person never bids (its
// obj is Q), never accepts an offer, and in a reverse round its value
// 0 - 1e30 never beats a valid person's and never exceeds the -1e30 start of
// the second best; the range max|benefit| gains only its zeros.  So the block
// compacts the valid persons, in GT order, and every per-person loop runs over
// them alone; the tie-break hash and "ties to the first person" keep the
// original GT index, so the function is the same.
//
// One thread block per problem, kWarps warps.  The valid persons' benefit rows (row stride
// Q | 1 words, odd, so a group walking persons down a column and the
// transposing stores hit 32 banks), prices, owners and the per-round scratch
// live in shared memory for the whole solve.  A lane keeps up to kItems
// values in registers: kItems = 4 for Q <= 128, 32 for Q <= 1024.  A larger
// Q, or a problem whose candidate lists do not fit in shared memory beside
// the rest, takes the chunked build (kItems = 8): a bid walks the queries in
// chunks of 256, each lane carrying its running best, first index, second
// best and pick from chunk to chunk (in query order, so ties still go to the
// first query), and reads each value again in its second pass instead of
// keeping it in a register; the reverse round lists candidates chunk by
// chunk, into global memory that the wrapper allocates.  The chunked build
// computes the same function; only a problem whose shared state does not fit
// 227 KB is refused.
//   * A bid is one warp's: each lane holds its queries' values, and the warp
//     reduces their order-preserving bits with redux.sync.
//   * Jacobi round: every warp finds the bidders by ballots over obj and
//     takes every kWarps-th; each bid goes into a 64-bit shared
//     atomicMax per query (bid's order-preserving bits high, ~person low: the
//     highest bid, ties to the first person; max is order-independent, so
//     the bits repeat); then one thread per person sees whether it won and
//     moves the query.  Two barriers.
//   * Reverse round: every warp lists the candidate queries; lanes in groups
//     of a power of two (at most 4 persons each) reduce a candidate each over
//     the persons by shuffles (best, first index, second best); an offer's
//     gain goes into a 32-bit atomicMax per person, then the offers that
//     equal it into an atomicMin of the query (ties to the smallest), then
//     one thread per person accepts.  The 32-bit atomics are native; a 64-bit
//     atomicMax is a compare-and-swap loop, which the many offers to one
//     person made contend.  Three barriers.  A query vacated and one won in
//     a round are never the same (the won one was unowned); each person's
//     profit is carried and updated on accept.
//   * Gauss-Seidel rounds and the greedy completion run in warp 0.
//
// The tie-break hash (p * 1000003 + q * 7919 + it + 1) * -1640531527 overflows
// int32 in the Pallas kernel; it is computed here in uint32, where wrapping is
// defined, and masked to 30 bits.
//
// What bounds it on an H100: the solve reads the valid columns of the cost
// once (at most N*Q*G*4 bytes, 1.2 MB at N = 30, Q = G = 100: 0.36 us at 3.35
// TB/s) and then runs a serial, data-dependent chain of rounds: each a few
// hundred dependent instructions (shared-memory loads, warp reductions,
// selects) between two or three block barriers, about 1.3 us.  The chain, not
// the bytes, bounds it: the launch lasts as long as its problem with the
// most rounds, and 30 blocks leave most of the 132 SMs idle.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // the fastest of 4, 8 and 16 on the training step's matching
constexpr int kThreads = kWarps * 32;
constexpr int kTailK = 3;  // Gauss-Seidel rounds once at most this many persons are unassigned
constexpr float kNegLarge = -1e30f;
constexpr float kBigCost = 3.4e38f;
constexpr int kBig = 1 << 30;

struct Smem {
  unsigned long long* qkey;  // [Q] Jacobi: best (bid, ~person) per query, 0 none
  float* benefit;            // [nv][QS] valid persons' benefit rows
  float* prices;             // [Q]
  int* owner;                // [Q] person (compacted) owning each query, -1 none
  float* newp;               // [Q] reverse round: offered price, -1 to drop to 0
  int* istar;                // [Q] reverse round: the person offered to
  uint32_t* gain;            // [Q] reverse round: the offer's gain, order-preserving bits
  uint32_t* pbest;           // [G] reverse round: each person's best gain (bits), 0 none
  int* pwin;                 // [G] reverse round: the query it takes, kBig none
  int* taken;                // [Q] greedy completion: query taken
  int* obj;                  // [G] query of each person (compacted), -1 unassigned
  int* target;               // [G] Jacobi bid target, -1 not bidding
  float* bid;                // [G]
  float* pi;                 // [G] reverse rounds: person profit
  int* gt;                   // [G] original GT index of each valid person
  int* rank;                 // [G] compacted index of each GT slot, -1 padding
  int* cand;                 // [kWarps][Q] reverse round: each warp's candidate queries
                             // (global memory in the chunked build)
  float* red;                // [kWarps]
  int* misc;                 // [2] number of valid persons, round counter
};

__device__ __forceinline__ int tie_hash(int p, int q, int it) {
  const uint32_t h = ((uint32_t)p * 1000003u + (uint32_t)q * 7919u + (uint32_t)it + 1u) *
                     2654435769u;  // == -1640531527 mod 2^32
  return (int)(h & 0x3FFFFFFFu);
}

// Float bits in an order that unsigned compare preserves; -0 and +0 are one key.
__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ int key_index(unsigned long long key) { return (int)~(uint32_t)key; }

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float from_order_bits(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// One person's bid, computed by one warp: the best value w1 and its first
// index, the best other value w2, the hashed pick among the queries within
// eps of w1, and the bid price for it.  Each lane keeps its kItems values
// (queries lane, lane + 32, ...) in registers; the warp reduces the
// order-preserving bits with redux.sync.  A zero's sign may differ from a
// serial max's (both zeros share a key), which changes no result: w1 enters
// only as w1 - eps or as min(w1, w1 - eps), and w2 only as mu in
// (row - mu) + eps.  Returns the pick; *bid_out its price.
template <int kItems>
__device__ __forceinline__ int person_bid(const Smem& s, int Q, int QS, int k, float eps, int it,
                                          float* bid_out) {
  const int lane = threadIdx.x & 31;
  const float* row = s.benefit + k * QS;
  float x[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int q = lane + 32 * j;
    x[j] = q < Q ? row[q] - s.prices[q] : 0.f;
  }
  uint32_t k1 = 0;
  int i1 = kBig;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t kx = order_bits(x[j]);
    if (lane + 32 * j < Q && kx > k1) {
      k1 = kx;
      i1 = lane + 32 * j;
    }
  }
  const uint32_t top1 = __reduce_max_sync(0xffffffffu, k1);
  const int best = __reduce_min_sync(0xffffffffu, k1 == top1 ? i1 : kBig);
  const float w1 = from_order_bits(top1);
  const float thr = w1 - eps;
  const int p = s.gt[k];
  uint32_t k2 = order_bits(kNegLarge);
  int prio = -2, pick = kBig;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int q = lane + 32 * j;
    if (q >= Q) break;
    if (q != best) k2 = max(k2, order_bits(x[j]));
    const int pr = x[j] >= thr ? tie_hash(p, q, it) : -1;
    if (pr > prio) {
      prio = pr;
      pick = q;
    }
  }
  const float w2 = from_order_bits(__reduce_max_sync(0xffffffffu, k2));
  const int top = __reduce_max_sync(0xffffffffu, prio);
  pick = __reduce_min_sync(0xffffffffu, prio == top ? pick : kBig);
  const float w_ex = pick == best ? w2 : w1;
  const float mu = fminf(w_ex, w1 - eps);
  *bid_out = (row[pick] - mu) + eps;
  return pick;
}

// person_bid for any Q (the chunked build): the queries in chunks of 32 *
// kItems (nv <= 32 * kItems too), the same maxima, first indices and pick, carried per lane from
// chunk to chunk in query order; each value is computed again in the second
// pass by the same fp32 subtraction.
template <int kItems>
__device__ __forceinline__ int person_bid_chunked(const Smem& s, int Q, int QS, int k, float eps,
                                                  int it, float* bid_out) {
  const int lane = threadIdx.x & 31;
  const float* row = s.benefit + k * QS;
  uint32_t k1 = 0;
  int i1 = kBig;
  for (int q0 = 0; q0 < Q; q0 += 32 * kItems) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int q = q0 + lane + 32 * j;
      if (q >= Q) break;
      const uint32_t kx = order_bits(row[q] - s.prices[q]);
      if (kx > k1) {
        k1 = kx;
        i1 = q;
      }
    }
  }
  const uint32_t top1 = __reduce_max_sync(0xffffffffu, k1);
  const int best = __reduce_min_sync(0xffffffffu, k1 == top1 ? i1 : kBig);
  const float w1 = from_order_bits(top1);
  const float thr = w1 - eps;
  const int p = s.gt[k];
  uint32_t k2 = order_bits(kNegLarge);
  int prio = -2, pick = kBig;
  for (int q0 = 0; q0 < Q; q0 += 32 * kItems) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int q = q0 + lane + 32 * j;
      if (q >= Q) break;
      const float x = row[q] - s.prices[q];
      if (q != best) k2 = max(k2, order_bits(x));
      const int pr = x >= thr ? tie_hash(p, q, it) : -1;
      if (pr > prio) {
        prio = pr;
        pick = q;
      }
    }
  }
  const float w2 = from_order_bits(__reduce_max_sync(0xffffffffu, k2));
  const int top = __reduce_max_sync(0xffffffffu, prio);
  pick = __reduce_min_sync(0xffffffffu, prio == top ? pick : kBig);
  const float w_ex = pick == best ? w2 : w1;
  const float mu = fminf(w_ex, w1 - eps);
  *bid_out = (row[pick] - mu) + eps;
  return pick;
}

template <int kItems, bool kChunked>
__device__ __forceinline__ int bid_of(const Smem& s, int Q, int QS, int k, float eps, int it,
                                      float* bid_out) {
  if constexpr (kChunked) {
    return person_bid_chunked<kItems>(s, Q, QS, k, eps, it, bid_out);
  } else {
    return person_bid<kItems>(s, Q, QS, k, eps, it, bid_out);
  }
}

// Persons still unassigned, counted by the whole block (a barrier).
__device__ __forceinline__ int block_unassigned(const Smem& s, int nv) {
  int n = 0;
  for (int base = 0; base < nv; base += kThreads) {
    const int k = base + threadIdx.x;
    n += __syncthreads_count(k < nv && s.obj[k] < 0);
  }
  return n;
}

// Ballots of persons k = 32 * j + lane (j < kItems, k < nv) still unassigned.
template <int kItems>
__device__ __forceinline__ void unassigned_ballots(const Smem& s, int nv, unsigned (&m)[kItems]) {
  const int lane = threadIdx.x & 31;
  bool un[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) un[j] = lane + 32 * j < nv && s.obj[lane + 32 * j] < 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) m[j] = __ballot_sync(0xffffffffu, un[j]);
}

// Person k wins query t at its bid; t's owner, if any, is evicted.
__device__ __forceinline__ void move_query(const Smem& s, int t, int k) {
  const int old = s.owner[t];
  s.prices[t] = s.bid[k];
  s.owner[t] = k;
  if (old >= 0) s.obj[old] = -1;
  s.obj[k] = t;
}

// Person k accepts query q's offer, vacating the query it held.
__device__ __forceinline__ void move_person(const Smem& s, int QS, int Q, int k, int q) {
  const int old = s.obj[k];
  if (old >= 0 && old < Q) s.owner[old] = -1;
  s.obj[k] = q;
  s.owner[q] = k;
  s.prices[q] = s.newp[q];
  s.pi[k] = s.benefit[k * QS + q] - s.newp[q];
}

template <int kItems, bool kChunked>
__device__ __forceinline__ void jacobi_round(const Smem& s, int nv, int Q, int QS, float eps,
                                             int it) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // The bidders in person order; this warp takes the warp-th, then every
  // kWarps-th after it.
  unsigned m[kItems];
  unassigned_ballots<kItems>(s, nv, m);
  int seen = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int r = seen + __popc(m[j] & ((1u << lane) - 1u));
    unsigned mine = __ballot_sync(0xffffffffu, ((m[j] >> lane) & 1u) && r % kWarps == warp);
    seen += __popc(m[j]);
    while (mine) {
      const int kb = 32 * j + __ffs(mine) - 1;
      mine &= mine - 1;
      float bid;
      const int t = bid_of<kItems, kChunked>(s, Q, QS, kb, eps, it, &bid);
      if (lane == 0) {
        s.target[kb] = t;
        s.bid[kb] = bid;
        if (bid > kNegLarge / 2) {
          atomicMax(&s.qkey[t], ((unsigned long long)order_bits(bid) << 32) | (uint32_t)~kb);
        }
      }
    }
  }
  __syncthreads();
  // The winner of each query moves it.  Evicted owners and winners are
  // distinct persons (owners were not bidding), and each person bid for one
  // query, so the writes never collide.  A loser that reads the key after
  // its winner cleared it still sees that it lost.
  for (int k = threadIdx.x; k < nv; k += kThreads) {
    const int t = s.target[k];
    if (t < 0) continue;
    s.target[k] = -1;
    if (key_index(s.qkey[t]) != k) continue;
    s.qkey[t] = 0ull;
    move_query(s, t, k);
  }
  __syncthreads();
}

// Gauss-Seidel round, run by warp 0 alone: the first unassigned person bids.
template <int kItems, bool kChunked>
__device__ __forceinline__ void tail_round(const Smem& s, int nv, int Q, int QS, float eps,
                                           int it) {
  const int lane = threadIdx.x & 31;
  unsigned m[kItems];
  unassigned_ballots<kItems>(s, nv, m);
  int ks = -1;
#pragma unroll
  for (int j = kItems - 1; j >= 0; --j) {
    if (m[j]) ks = 32 * j + __ffs(m[j]) - 1;
  }
  if (ks < 0) return;
  float bid;
  const int qs = bid_of<kItems, kChunked>(s, Q, QS, ks, eps, it, &bid);
  if (lane == 0) {
    s.bid[ks] = bid;
    move_query(s, qs, ks);  // ks was unassigned, so never qs's owner
  }
  __syncwarp();
}

// Each person's profit from the query it holds (0 if none).
__device__ __forceinline__ void person_profits(const Smem& s, int nv, int Q, int QS) {
  for (int k = threadIdx.x; k < nv; k += kThreads) {
    const int o = s.obj[k];
    s.pi[k] = o >= 0 && o < Q ? s.benefit[k * QS + o] - s.prices[o] : 0.f;
  }
}

// Candidate query q's outcome from its best value b1 (person is) and second
// best b2: drop the price to 0 (after the barrier), or offer q to person is
// at max(0, b2 - eps), its gain into the person's best.  A zero's sign in b1
// or b2 changes neither.
__device__ __forceinline__ void offer(const Smem& s, int QS, int q, float b1, float b2, int is,
                                      float eps) {
  if (b1 < eps) {
    s.newp[q] = -1.f;
    return;
  }
  const float np = fmaxf(0.f, b2 - eps);
  const float gain = s.benefit[is * QS + q] - np;
  s.newp[q] = np;
  s.istar[q] = is;
  s.gain[q] = gain > kNegLarge / 2 ? order_bits(gain) : 0u;
  atomicMax(&s.pbest[is], s.gain[q]);
}

// Reverse round: unowned queries with a positive price drop it to 0 if no
// person is worth eps to them, or else offer themselves to their best person
// at the second-best interest minus eps.  Every warp lists the candidate
// queries itself (a price dropped to 0 is written only after the barrier, so
// all warps list the same ones); `lanes` lanes (a power of two, at most 32,
// each with at most kItems persons) share a candidate.
template <int kItems, bool kChunked>
__device__ __forceinline__ void reverse_round(const Smem& s, int nv, int Q, int QS, float eps,
                                              int lanes) {
  const int lane = threadIdx.x & 31;
  int* cand = s.cand + (threadIdx.x >> 5) * Q;
  int ncand = 0;
  if constexpr (kChunked) {  // the queries in chunks of 32 * kItems, in order
    for (int q0 = 0; q0 < Q; q0 += 32 * kItems) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int q = q0 + lane + 32 * j;
        const bool c = q < Q && s.owner[q] < 0 && s.prices[q] > 0.f;
        const unsigned m = __ballot_sync(0xffffffffu, c);
        if (c) cand[ncand + __popc(m & ((1u << lane) - 1u))] = q;
        ncand += __popc(m);
      }
    }
  } else {
    bool c[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int q = lane + 32 * j;
      c[j] = q < Q && s.owner[q] < 0 && s.prices[q] > 0.f;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned m = __ballot_sync(0xffffffffu, c[j]);
      if (c[j]) cand[ncand + __popc(m & ((1u << lane) - 1u))] = lane + 32 * j;
      ncand += __popc(m);
    }
  }
  __syncwarp();
  const int sub = threadIdx.x & (lanes - 1);
  const int shift = __ffs(lanes) - 1;
  for (int j0 = 0; j0 < ncand; j0 += kThreads >> shift) {  // the same trip count in every lane
    const int jc = j0 + (threadIdx.x >> shift);
    const int q = jc < ncand ? cand[jc] : -1;
    float x[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int k = sub + lanes * j;
      x[j] = q >= 0 && k < nv ? s.benefit[k * QS + q] - s.pi[k] : -CUDART_INF_F;
    }
    float b1 = -CUDART_INF_F, b2 = kNegLarge;
    int is = kBig;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {  // persons in order: ties stay with the first
      if (x[j] > b1) {
        b2 = fmaxf(b2, b1);
        b1 = x[j];
        is = sub + lanes * j;
      } else {
        b2 = fmaxf(b2, x[j]);
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, b1, off);
      const float o2 = __shfl_xor_sync(0xffffffffu, b2, off);
      const int oi = __shfl_xor_sync(0xffffffffu, is, off);
      const bool take = o1 > b1 || (o1 == b1 && oi < is);
      b2 = fmaxf(fmaxf(b2, o2), take ? b1 : o1);
      if (take) {
        b1 = o1;
        is = oi;
      }
    }
    if (q >= 0 && sub == 0) offer(s, QS, q, b1, b2, is, eps);
  }
  __syncthreads();
  // Each person takes its best offer, ties to the smallest query: the
  // offers equal to its best gain bid their query down.  Prices dropped to 0
  // here; the dropped, the vacated and the won queries are three disjoint
  // sets (the won ones were unowned, the vacated ones owned), so no write
  // below collides.
  for (int j = threadIdx.x; j < ncand; j += kThreads) {
    const int q = s.cand[j];  // warp 0's list, the same as every warp's
    if (s.newp[q] < 0.f) {
      s.prices[q] = 0.f;
    } else if (s.gain[q] && s.gain[q] == s.pbest[s.istar[q]]) {
      atomicMin(&s.pwin[s.istar[q]], q);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nv; k += kThreads) {
    const int q = s.pwin[k];
    if (q == kBig) continue;
    s.pwin[k] = kBig;
    s.pbest[k] = 0u;
    move_person(s, QS, Q, k, q);
  }
  __syncthreads();
}

// Q <= 32 * kItems, or any Q when kChunked (cand_lists then holds
// kWarps * Q ints per problem).
template <int kItems, bool kChunked>
__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ gt_valid,
               int* __restrict__ query_of_gt, int* __restrict__ rounds, int* cand_lists, int Q,
               int G, float eps_start_scale, float eps_decay, float eps_min, int max_iters,
               int num_phases, int unroll) {
  extern __shared__ unsigned long long smem[];
  const int QS = Q | 1;
  Smem s;
  s.qkey = smem;
  s.benefit = reinterpret_cast<float*>(s.qkey + Q);
  s.prices = s.benefit + G * QS;
  s.owner = reinterpret_cast<int*>(s.prices + Q);
  s.newp = reinterpret_cast<float*>(s.owner + Q);
  s.istar = reinterpret_cast<int*>(s.newp + Q);
  s.gain = reinterpret_cast<uint32_t*>(s.istar + Q);
  s.taken = reinterpret_cast<int*>(s.gain + Q);
  s.obj = s.taken + Q;
  s.target = s.obj + G;
  s.bid = reinterpret_cast<float*>(s.target + G);
  s.pi = s.bid + G;
  s.gt = reinterpret_cast<int*>(s.pi + G);
  s.rank = s.gt + G;
  s.pbest = reinterpret_cast<uint32_t*>(s.rank + G);
  s.pwin = reinterpret_cast<int*>(s.pbest + G);
  if constexpr (kChunked) {
    s.cand = cand_lists + (long long)blockIdx.x * kWarps * Q;
    s.red = reinterpret_cast<float*>(s.pwin + G);
  } else {
    s.cand = s.pwin + G;
    s.red = reinterpret_cast<float*>(s.cand + kWarps * Q);
  }
  s.misc = reinterpret_cast<int*>(s.red + kWarps);

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* c = cost + (long long)n * Q * G;
  const uint8_t* vrow = gt_valid + (long long)n * G;

  if (warp == 0) {  // compact the valid persons, in GT order
    int nv = 0;
    for (int base = 0; base < G; base += 32) {
      const int g = base + lane;
      const bool v = g < G && vrow[g] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, v);
      const int r = nv + __popc(m & ((1u << lane) - 1u));
      if (v) s.gt[r] = g;
      if (g < G) s.rank[g] = v ? r : -1;
      nv += __popc(m);
    }
    if (lane == 0) s.misc[0] = nv;
  }
  for (int q = tid; q < Q; q += kThreads) {
    s.prices[q] = 0.f;
    s.owner[q] = -1;
    s.newp[q] = 0.f;
    s.qkey[q] = 0ull;
  }
  for (int k = tid; k < G; k += kThreads) {
    s.pbest[k] = 0u;
    s.pwin[k] = kBig;
    s.target[k] = -1;
  }
  __syncthreads();
  const int nv = s.misc[0];
  // cost[q][gt[k]] -> benefit[k][q]: each warp reads one query's row of cost
  // (lanes on neighbouring GT columns) and stores down a column of benefit.
  float local = 0.f;
#pragma unroll 4
  for (int q = warp; q < Q; q += kWarps) {
    for (int k = lane; k < nv; k += 32) {
      const float b = -__ldg(c + q * G + s.gt[k]);
      s.benefit[k * QS + q] = b;
      local = fmaxf(local, fabsf(b));
    }
  }
  local = warp_max(local);
  if (lane == 0) s.red[warp] = local;
  __syncthreads();
  float range = s.red[0];
  for (int w = 1; w < kWarps; ++w) range = fmaxf(range, s.red[w]);
  const float eps0 = fmaxf(__fmul_rn(fmaxf(range, 1e-6f), eps_start_scale), eps_min);
  int lanes = 1;  // reverse rounds: lanes per candidate, each taking at most 4 persons
  while (lanes < 32 && lanes * 4 < nv) lanes <<= 1;

  float eps = eps0;
  int it = 0;
  for (int ph = 0; ph < num_phases; ++ph) {
    const int before = it;
    if (eps > eps_min || ph == 0) {  // a new phase: shrink eps, drop the assignment
      eps = ph == 0 ? eps0 : fmaxf(__fmul_rn(eps, eps_decay), eps_min);
      for (int q = tid; q < Q; q += kThreads) s.owner[q] = -1;
      for (int k = tid; k < nv; k += kThreads) s.obj[k] = -1;
    }
    __syncthreads();
    while (block_unassigned(s, nv) > kTailK && it < max_iters) {
      for (int r = 0; r < unroll; ++r) jacobi_round<kItems, kChunked>(s, nv, Q, QS, eps, it++);
    }
    if (warp == 0) {
      while (true) {
        unsigned m[kItems], un = 0;
        unassigned_ballots<kItems>(s, nv, m);
#pragma unroll
        for (int j = 0; j < kItems; ++j) un |= m[j];
        if (!(un && it < 8 * max_iters)) break;
        for (int r = 0; r < 2 * unroll; ++r) {
          tail_round<kItems, kChunked>(s, nv, Q, QS, eps, it++);
        }
      }
      if (lane == 0) s.misc[1] = it;
    }
    __syncthreads();
    it = s.misc[1];
    if (ph == num_phases - 1) {
      person_profits(s, nv, Q, QS);
      while (true) {
        int dirty = 0;
        for (int q = tid; q < Q; q += kThreads) dirty |= s.owner[q] < 0 && s.prices[q] > 0.f;
        if (!(__syncthreads_or(dirty) && it < 16 * max_iters)) break;
        for (int r = 0; r < unroll; ++r, ++it) {
          reverse_round<kItems, kChunked>(s, nv, Q, QS, eps, lanes);
        }
      }
    }
    if (tid == 0) rounds[n * num_phases + ph] = it - before;
    __syncthreads();
  }

  // The greedy completion of any person left unassigned at a cap, in GT
  // order: its cheapest free query, ties to the first.
  if (warp == 0) {
    for (int q = lane; q < Q; q += 32) s.taken[q] = 0;
    __syncwarp();
    for (int k = lane; k < nv; k += 32) {
      if (s.obj[k] >= 0) s.taken[s.obj[k]] = 1;
    }
    __syncwarp();
    for (int k = 0; k < nv; ++k) {
      if (s.obj[k] >= 0) continue;
      const int g = s.gt[k];
      float best = -CUDART_INF_F;  // the largest -cost, first index
      int bq = kBig;
      for (int q = lane; q < Q; q += 32) {
        const float x = -(s.taken[q] ? kBigCost : c[q * G + g]);
        if (x > best) {
          best = x;
          bq = q;
        }
      }
      warp_first_argmax(best, bq);
      if (lane == 0) {
        s.obj[k] = bq;
        s.taken[bq] = 1;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    const int k = s.rank[g];
    query_of_gt[(long long)n * G + g] = k < 0 ? -1 : s.obj[k];
  }
}

constexpr size_t kSmemLimit = 227 * 1024;  // dynamic shared memory a block can have

size_t smem_bytes(int Q, int G, bool cand_in_smem) {
  return sizeof(unsigned long long) * (size_t)Q +
         sizeof(float) * ((size_t)G * (Q | 1) + (6 + (cand_in_smem ? kWarps : 0)) * (size_t)Q +
                          8 * (size_t)G + kWarps + 2);
}

// The chunked build's kItems: chunks of 256 queries, and ballots and
// reverse-round registers for up to 256 persons, more than any problem whose
// benefit rows fit holds (G <= Q and G * (Q | 1) * 4 <= 227 KB give G <= 241).
constexpr int kChunkItems = 8;

// The build a shape takes: kItems 4 or 32 with the candidate lists in shared
// memory while they fit, else the chunked build with them in global memory.
struct Plan {
  int items;
  bool chunked;
  size_t smem;
  size_t scratch;  // bytes of global memory per problem
};

Plan plan_of(int Q, int G) {
  const size_t with_cand = smem_bytes(Q, G, true);
  if (Q <= 128 && with_cand <= kSmemLimit) return {4, false, with_cand, 0};
  if (Q <= 1024 && with_cand <= kSmemLimit) return {32, false, with_cand, 0};
  return {kChunkItems, true, smem_bytes(Q, G, false), sizeof(int) * kWarps * (size_t)Q};
}

template <int kItems, bool kChunked>
int launch_auction(const float* cost, const uint8_t* gt_valid, int* query_of_gt, int* rounds,
                   int* cand_lists, int N, int Q, int G, float eps_start_scale, float eps_decay,
                   float eps_min, int max_iters, int num_phases, int unroll, size_t bytes,
                   cudaStream_t stream) {
  // The shared-memory limit is raised once per device, to the largest size asked.
  static size_t raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || bytes > raised[dev]) {
    err = cudaFuncSetAttribute(auction_kernel<kItems, kChunked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = bytes;
  }
  auction_kernel<kItems, kChunked><<<N, kThreads, bytes, stream>>>(
      cost, gt_valid, query_of_gt, rounds, cand_lists, Q, G, eps_start_scale, eps_decay,
      eps_min, max_iters, num_phases, unroll);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What a (Q, G) problem needs: *smem_bytes of shared memory per block and
// *scratch_bytes of global memory per problem (0 unless the chunked build
// runs).  Returns 1 if the kernel can hold it, 0 if its shared memory
// exceeds the 227 KB a block can have.
extern "C" int auction_lap_plan(int Q, int G, long long* smem_bytes_out,
                                long long* scratch_bytes_out) {
  const Plan p = plan_of(Q, G);
  *smem_bytes_out = static_cast<long long>(p.smem);
  *scratch_bytes_out = static_cast<long long>(p.scratch);
  return p.smem <= kSmemLimit ? 1 : 0;
}

// cost (N, Q, G) fp32 contiguous, rows queries and columns GT, G <= Q;
// gt_valid (N, G) uint8; scratch: N * auction_lap_plan's scratch bytes of
// global memory (null when those are 0).  Writes query_of_gt (N, G) int32
// (-1 on padding) and rounds (N, num_phases) int32, the rounds each problem
// ran per phase.  Returns the launch's cudaError_t.
extern "C" int auction_lap(const void* cost, const void* gt_valid, void* query_of_gt,
                           void* rounds, void* scratch, int N, int Q, int G,
                           float eps_start_scale, float eps_decay, float eps_min, int max_iters,
                           int num_phases, int unroll, void* stream) {
  if (N < 1 || G < 1 || Q < G || N > 2147483647 / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan_of(Q, G);
  if (p.smem > kSmemLimit || (p.scratch && !scratch) || (p.chunked && G > 32 * kChunkItems)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto launch = !p.chunked ? (p.items == 4 ? &launch_auction<4, false>
                                                 : &launch_auction<32, false>)
                                 : &launch_auction<kChunkItems, true>;
  return launch(static_cast<const float*>(cost), static_cast<const uint8_t*>(gt_valid),
                static_cast<int*>(query_of_gt), static_cast<int*>(rounds),
                static_cast<int*>(scratch), N, Q, G, eps_start_scale, eps_decay, eps_min,
                max_iters, num_phases, unroll, p.smem, static_cast<cudaStream_t>(stream));
}
