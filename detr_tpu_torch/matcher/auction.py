"""Batched rectangular auction assignment: the CUDA kernel and its plain
version (counterpart of ``detr_tpu/matcher/pallas_auction.py::pallas_auction_lap``
and ``detr_tpu/matcher/auction.py``).

Every (image, decoder layer) matching problem is a rectangular assignment of
its G valid ground-truth boxes ("persons") to Q queries ("objects") that
minimises the summed cost.  The algorithm is the Pallas ``_auction_kernel``'s:
epsilon-scaling over a static number of phases; Jacobi forward rounds with a
hashed pick among the eps-near-optimal queries (ties to the first index);
Gauss-Seidel rounds once at most 3 persons are unassigned; reverse
(query-side) rounds in the last phase so that every unowned query ends at
price 0; the caps ``max_iters``, 8x for the tail and 16x for the reverse
rounds; and ``_greedy_complete`` for any person still unassigned at a cap.
The total cost is within 2 * eps_min per valid GT of the optimum.

One difference from the Pallas kernel, by design: there the round counter
and the loop conditions span a whole chunk of problems, so its permutations
on near-ties depend on how problems are chunked.  Here every problem runs its
own loops and counter (the CUDA kernel runs one thread block per problem):
with one problem per Pallas call the two agree exactly, assignments and
round counts (``tests/test_torch_port_matcher.py``), and the kernel agrees
with the plain version bit for bit.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel
``csrc/auction_lap.cu`` or raises.  The kernel takes any Q whose problem's
shared state (the valid GT's benefit rows, prices and owners, about
4 * G * Q + 32 * Q bytes) fits the 227 KB of shared memory a block can have:
Q = 2048 at G = 20, for one.  Beyond 1024 queries, or where the reverse
rounds' candidate lists do not fit beside the rest, its chunked build runs,
with those lists in global memory that the wrapper allocates.  The plain
version takes any (Q, G).  The repo's configurations match 100 or 300
queries.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from detr_tpu_torch.ops._build import kernel, launch

_NEG_LARGE = -1e30
_BIG_PROFIT = 1e30
_TAIL_K = 3  # Gauss-Seidel rounds once at most this many persons are unassigned
_PRIO_MASK = 0x3FFFFFFF
EPS_START_SCALE = 0.25  # eps0 as a fraction of the largest |benefit|
EPS_DECAY = 0.15  # eps shrinks by this per phase
UNROLL = 4  # rounds per loop body between the loop-condition checks

launches = 0  # kernel launches since the last reset, for checking the main path


# Static phase count (pallas_auction.py:428): enough to bring the largest
# plausible eps0 (a 1e6 dynamic range) down to eps_min.
NUM_PHASES = 1 + max(1, int(math.ceil(math.log(1e-6) / math.log(EPS_DECAY))))


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first maximum along ``dim``."""
    m = x.amax(dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    idx = torch.arange(x.shape[dim], device=x.device).view(shape)
    return torch.where(x >= m, idx, x.shape[dim]).amin(dim)


def _tie_hash(p, q: torch.Tensor, it: int) -> torch.Tensor:
    """(p * 1000003 + q * 7919 + it + 1) * -1640531527, low 30 bits (int64)."""
    return ((p * 1000003 + q * 7919 + it + 1) * -1640531527) & _PRIO_MASK


class _Problem:
    """One problem's state and rounds, as one thread block of the kernel
    runs them.  ``eps`` is held as np.float32 so that its arithmetic is fp32."""

    def __init__(self, benefit: torch.Tensor, valid: torch.Tensor, eps0: np.float32):
        self.benefit, self.valid = benefit, valid
        P, Q = benefit.shape
        dev = benefit.device
        self.P, self.Q = P, Q
        self.q_idx = torch.arange(Q, device=dev)
        self.p_idx = torch.arange(P, device=dev)
        self.prices = torch.zeros(Q, dtype=torch.float32, device=dev)
        self.owner = torch.full((Q,), -1, dtype=torch.int64, device=dev)
        self.obj = torch.where(valid, -1, Q).to(torch.int64)  # padding: assigned to nothing
        self.eps = eps0
        self.it = 0

    def n_unassigned(self) -> int:
        return int((self.obj < 0).sum())

    def dirty(self) -> bool:
        return bool(((self.owner < 0) & (self.prices > 0)).any())

    def _pick(self, values, p):
        """Best value, its first index, the best other value, and the hashed
        pick among the eps-near-optimal queries, per row of ``values``."""
        w1 = values.amax(-1)
        best = _first_argmax(values, -1)
        w2 = values.masked_fill(self.q_idx == best[..., None], _NEG_LARGE).amax(-1)
        thr = w1 - self.eps
        prio = torch.where(values >= thr[..., None], _tie_hash(p, self.q_idx, self.it), -1)
        return w1, best, w2, _first_argmax(prio, -1)

    def jacobi_round(self):
        values = self.benefit - self.prices
        w1, best, w2, target = self._pick(values, self.p_idx[:, None])
        bt = self.benefit.gather(1, target[:, None])[:, 0]
        mu = torch.minimum(torch.where(target == best, w2, w1), w1 - self.eps)
        bid = (bt - mu) + self.eps
        bids = torch.where((self.obj < 0)[:, None] & (self.q_idx == target[:, None]),
                           bid[:, None], _NEG_LARGE)  # (P, Q)
        top = bids.amax(0)
        winner = _first_argmax(bids, 0)
        got = top > _NEG_LARGE / 2
        old = self.owner
        self.prices = torch.where(got, top, self.prices)
        self.owner = torch.where(got, winner, old)
        evict = got & (old >= 0) & (old != winner)
        obj = self.obj.clone()
        obj[old[evict]] = -1
        obj[winner[got]] = self.q_idx[got]
        self.obj = obj
        self.it += 1

    def tail_round(self):
        unassigned = (self.obj < 0).nonzero()
        if len(unassigned):
            ps = int(unassigned[0, 0])
            row = self.benefit[ps]
            w1, best, w2, qs = self._pick(row - self.prices, ps)
            mu = torch.minimum(torch.where(qs == best, w2, w1), w1 - self.eps)
            bid = (row[qs] - mu) + self.eps
            qs = int(qs)
            old = int(self.owner[qs])
            self.prices[qs] = bid
            self.owner[qs] = ps
            if old >= 0 and old != ps:
                self.obj[old] = -1
            self.obj[ps] = qs
        self.it += 1

    def reverse_round(self):
        Q = self.Q
        own = (self.obj >= 0) & (self.obj < Q)
        o = self.obj.clamp(0, Q - 1)
        pi = torch.where(own, self.benefit.gather(1, o[:, None])[:, 0] - self.prices[o], 0.0)
        pi = torch.where(self.valid, pi, _BIG_PROFIT)
        vrev = self.benefit - pi[:, None]  # (P, Q): query q's value of person p
        cand = (self.owner < 0) & (self.prices > 0.0)
        beta1 = vrev.amax(0)
        istar = _first_argmax(vrev, 0)
        beta2 = vrev.masked_fill(self.p_idx[:, None] == istar, _NEG_LARGE).amax(0)
        no_attract = beta1 < self.eps
        self.prices = torch.where(cand & no_attract, 0.0, self.prices)
        offering = cand & ~no_attract
        newp = torch.clamp_min(beta2 - self.eps, 0.0)
        offers = (self.p_idx[:, None] == istar) & offering  # (P, Q)
        gain = torch.where(offers, self.benefit - newp, _NEG_LARGE)
        best_gain = gain.amax(1)
        jstar = _first_argmax(gain, 1)
        accept = self.valid & (best_gain > _NEG_LARGE / 2)
        old_obj = self.obj
        self.obj = torch.where(accept, jstar, old_obj)
        vac = old_obj[accept & (old_obj >= 0) & (old_obj < Q)]
        owner = self.owner.clone()
        owner[vac] = -1
        won = jstar[accept]
        owner[won] = self.p_idx[accept]
        self.owner = owner
        prices = self.prices.clone()
        prices[won] = newp[won]
        self.prices = prices
        self.it += 1


def _solve(benefit, valid, cost, eps_min, max_iters):
    """One problem: benefit (G, Q), valid (G,), cost (Q, G) ->
    (query_of_gt (G,), rounds per phase)."""
    f32 = np.float32
    eps_min = f32(eps_min)
    rng = f32(benefit.abs().max().item())
    eps0 = max(max(rng, f32(1e-6)) * f32(EPS_START_SCALE), eps_min)
    st = _Problem(benefit, valid, eps0)
    rounds = []
    for ph in range(NUM_PHASES):
        before = st.it
        if st.eps > eps_min or ph == 0:
            st.eps = eps0 if ph == 0 else max(st.eps * f32(EPS_DECAY), eps_min)
            st.owner.fill_(-1)
            st.obj = torch.where(valid, -1, st.obj)
        while st.n_unassigned() > _TAIL_K and st.it < max_iters:
            for _ in range(UNROLL):
                st.jacobi_round()
        while st.n_unassigned() > 0 and st.it < 8 * max_iters:
            for _ in range(2 * UNROLL):
                st.tail_round()
        if ph == NUM_PHASES - 1:
            while st.dirty() and st.it < 16 * max_iters:
                for _ in range(UNROLL):
                    st.reverse_round()
        rounds.append(st.it - before)
    qog = torch.where(valid, st.obj, -1)
    return _greedy_complete(cost, qog, valid), rounds


def _greedy_complete(cost, qog, valid):
    """Assign any still-unassigned valid GT to its cheapest free query
    (``detr_tpu/matcher/auction.py::_greedy_complete``)."""
    Q, G = cost.shape
    owned = torch.zeros(Q, dtype=torch.bool, device=cost.device)
    owned[qog[qog >= 0]] = True
    for g in range(G):
        if bool(valid[g]) and int(qog[g]) < 0:
            col = torch.where(owned, 3.4e38, cost[:, g])
            q = int(_first_argmax(-col, 0))
            qog[g] = q
            owned[q] = True
    return qog


def auction_lap_reference(
    cost: torch.Tensor, gt_valid: torch.Tensor, eps_min: float = 1e-4, max_iters: int = 4000
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``auction_lap``: one problem at a time."""
    cost, gt_valid = _check(cost, gt_valid)
    benefit = torch.where(gt_valid[:, :, None], -cost.transpose(1, 2), 0.0)  # (N, G, Q)
    qogs, rounds = [], []
    for n in range(cost.shape[0]):
        q, r = _solve(benefit[n], gt_valid[n], cost[n], eps_min, max_iters)
        qogs.append(q)
        rounds.append(r)
    N, dev = cost.shape[0], cost.device
    if N == 0:
        qog = torch.empty((0, cost.shape[2]), dtype=torch.int32, device=dev)
    else:
        qog = torch.stack(qogs).to(torch.int32)
    rounds = torch.tensor(rounds, dtype=torch.int32, device=dev)
    return qog, rounds.reshape(N, NUM_PHASES)


def _check(cost, gt_valid):
    if cost.dim() != 3 or gt_valid.shape != (cost.shape[0], cost.shape[2]):
        raise ValueError(f"cost (N, Q, G) and gt_valid (N, G), got {tuple(cost.shape)} "
                         f"and {tuple(gt_valid.shape)}")
    if cost.shape[2] > cost.shape[1]:
        raise ValueError(f"need G <= Q, got Q={cost.shape[1]}, G={cost.shape[2]}")
    return cost.float(), gt_valid.to(cost.device, torch.bool)


def _auction_cuda(cost, gt_valid, eps_min, max_iters):
    global launches
    N, Q, G = cost.shape
    plan = kernel("auction_lap", "auction_lap_plan",
                  [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_longlong)] * 2)
    smem, scratch_bytes = ctypes.c_longlong(), ctypes.c_longlong()
    if not plan(Q, G, ctypes.byref(smem), ctypes.byref(scratch_bytes)):
        raise ValueError(
            f"the auction kernel cannot hold Q={Q}, G={G}: a problem needs {smem.value} bytes "
            f"of shared memory, more than the {227 * 1024} a thread block can have")
    cost = cost.contiguous()
    valid = gt_valid.to(torch.uint8).contiguous()
    qog = torch.empty((N, G), dtype=torch.int32, device=cost.device)
    rounds = torch.empty((N, NUM_PHASES), dtype=torch.int32, device=cost.device)
    # the chunked build's candidate lists, kWarps * Q ints per problem
    scratch = (torch.empty(N * scratch_bytes.value // 4, dtype=torch.int32, device=cost.device)
               if scratch_bytes.value else None)
    fn = kernel("auction_lap", "auction_lap",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    launch(fn, cost.device, cost.data_ptr(), valid.data_ptr(), qog.data_ptr(), rounds.data_ptr(),
           None if scratch is None else scratch.data_ptr(),
           N, Q, G, EPS_START_SCALE, EPS_DECAY, eps_min, max_iters, NUM_PHASES, UNROLL)
    launches += 1
    return qog, rounds


def auction_lap(
    cost: torch.Tensor, gt_valid: torch.Tensor, eps_min: float = 1e-4, max_iters: int = 4000
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched LAP: cost (N, Q, G) fp32 (rows queries, columns GT), G <= Q;
    gt_valid (N, G) bool -> (query_of_gt (N, G) int32 with -1 on padding,
    rounds (N, NUM_PHASES) int32: the auction rounds each problem ran per
    phase).  The total cost is within 2 * eps_min per valid GT of optimal;
    ``max_iters`` caps the rounds (8x for the tail, 16x for the reverse)."""
    cost, gt_valid = _check(cost, gt_valid)
    if cost.device.type == "cpu":
        return auction_lap_reference(cost, gt_valid, eps_min, max_iters)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    return _auction_cuda(cost, gt_valid, eps_min, max_iters)


def assignment_total_cost(
    cost: torch.Tensor, query_of_gt: torch.Tensor, gt_valid: torch.Tensor
) -> torch.Tensor:
    """Sum of cost over the assignment per problem, (N, Q, G) -> (N,);
    padding columns contribute 0."""
    q = query_of_gt.long().clamp(min=0)
    picked = cost.gather(1, q[:, None, :])[:, 0, :]
    return torch.where(gt_valid & (query_of_gt >= 0), picked, 0.0).sum(-1)
