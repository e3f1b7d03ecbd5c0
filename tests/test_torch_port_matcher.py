"""The port's matcher and set criterion against the JAX package's.

The port's auction runs its plain PyTorch version on the CPU (the version
its CUDA kernel is held against on the card, exactly).  JAX's Pallas auction
runs in interpret mode.  Solved one problem per call, the two agree exactly:
the same assignment and the same number of rounds.  Across a chunk of
problems they may solve near-ties differently (the Pallas kernel shares its
round counter and loop conditions across the chunk), so batched results are
held to the optimality bound against scipy: an injective assignment whose
total cost is within 2 * n_valid * eps_min of scipy's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from detr_tpu.losses.criterion import SetCriterion as JaxCriterion
from detr_tpu.losses.criterion import total_loss as jax_total_loss
from detr_tpu.matcher.auction import assignment_total_cost as jax_total_cost
from detr_tpu.matcher.hungarian import compute_cost_matrix as jax_cost_matrix
from detr_tpu.matcher.pallas_auction import pallas_auction_lap
from detr_tpu_torch.losses import SetCriterion, total_loss
from detr_tpu_torch.matcher import (
    HungarianMatcher,
    assignment_total_cost,
    auction_lap,
    compute_cost_matrix,
    match_batch,
    scipy_match_batch,
)
from detr_tpu_torch.matcher.auction import NUM_PHASES, auction_lap_reference
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)


def _assert_near_optimal(cost, valid, qog, eps_min):
    for n in range(len(cost)):
        vc = np.flatnonzero(valid[n])
        assert (qog[n][~valid[n]] == -1).all()
        if len(vc) == 0:
            continue
        assert len(np.unique(qog[n, vc])) == len(vc) and (qog[n, vc] >= 0).all()
        rows, cols = linear_sum_assignment(cost[n][:, vc])
        gap = cost[n][qog[n, vc], vc].sum() - cost[n][rows, vc[cols]].sum()
        assert gap <= 2 * len(vc) * eps_min + 1e-5, (n, gap)


def _case(kind, rng):
    """The cases of tests/test_pallas_kernels.py."""
    if kind in ("random", "contentious"):
        N, Q, G = 4, 32, 16
        if kind == "random":
            cost = rng.normal(size=(N, Q, G)).astype(np.float32) * 3
        else:  # near-identical rows: the early-training worst case
            cost = (rng.normal(size=(N, 1, G)) * 3 + rng.normal(size=(N, Q, G)) * 0.01).astype(
                np.float32)
        valid = np.ones((N, G), bool)
        valid[1, 5:] = False
        valid[2, :] = False
    elif kind == "flagship":  # Q=100, G_max=25, ragged validity
        cost = rng.normal(size=(4, 100, 25)).astype(np.float32) * 3
        valid = rng.random((4, 25)) < 0.7
    else:  # "train": batch 5 x 6 layers at G_max = Q = 100
        cost = rng.normal(size=(30, 100, 100)).astype(np.float32) * 3
        valid = np.arange(100)[None, :] < rng.integers(0, 12, size=30)[:, None]
    return cost, valid


@pytest.mark.parametrize("kind", ["random", "contentious", "flagship", "train"])
def test_auction_within_bound_of_scipy_and_pallas(kind):
    rng = np.random.default_rng(0)
    cost, valid = _case(kind, rng)
    eps_min = 1e-4
    qog, rounds = auction_lap(torch.from_numpy(cost), torch.from_numpy(valid), eps_min=eps_min)
    assert qog.dtype == torch.int32 and rounds.shape == (len(cost), NUM_PHASES)
    _assert_near_optimal(cost, valid, qog.numpy(), eps_min)
    jax_qog, _ = pallas_auction_lap(jnp.asarray(cost), jnp.asarray(valid), eps_min=eps_min,
                                    interpret=True)
    _assert_near_optimal(cost, valid, np.asarray(jax_qog), eps_min)
    # the two totals agree within the bound of each other
    ours = assignment_total_cost(torch.from_numpy(cost), qog, torch.from_numpy(valid)).numpy()
    theirs = np.array([float(jax_total_cost(jnp.asarray(cost[n]), jax_qog[n], jnp.asarray(valid[n])))
                       for n in range(len(cost))])
    assert (np.abs(ours - theirs) <= 2 * valid.sum(1) * eps_min + 1e-5).all()


def _dense_case(kind, rng):
    """Q = G = 100 with the first n_valid GT slots valid; "contentious_40"
    has near-identical rows."""
    Q = G = 100
    if kind == "contentious_40":
        cost = rng.normal(size=(1, 1, G)) * 3 + rng.normal(size=(1, Q, G)) * 0.01
        n_valid = 40
    else:
        cost = rng.normal(size=(1, Q, G)) * 3
        n_valid = int(kind.split("_")[1])
    return cost.astype(np.float32), np.arange(G)[None, :] < n_valid


@pytest.mark.parametrize("kind", ["random", "contentious", "flagship", "dense_0", "dense_7",
                                  "dense_33", "dense_100", "contentious_40"])
def test_auction_plain_version_equals_pallas_per_problem(kind):
    """One problem per Pallas call, so its round counter is per problem as
    the port's is: the same query_of_gt, and the port's rounds summed over
    the phases equal the Pallas kernel's count, exactly."""
    rng = np.random.default_rng(0)
    cost, valid = _case(kind, rng) if kind in ("random", "contentious", "flagship") else (
        _dense_case(kind, rng))
    eps_min = 1e-3
    qog, rounds = auction_lap_reference(torch.from_numpy(cost), torch.from_numpy(valid),
                                        eps_min=eps_min)
    for n in range(len(cost)):
        want, iters = pallas_auction_lap(jnp.asarray(cost[n:n + 1]), jnp.asarray(valid[n:n + 1]),
                                         eps_min=eps_min, interpret=True)
        np.testing.assert_array_equal(qog[n].numpy(), np.asarray(want)[0], err_msg=f"problem {n}")
        assert int(rounds[n].sum()) == int(iters), (n, rounds[n].tolist(), int(iters))


def test_auction_greedy_completion_at_the_cap():
    """With the round caps hit at once, the greedy completion still gives an
    injective assignment of every valid GT."""
    rng = np.random.default_rng(1)
    cost = rng.normal(size=(3, 20, 12)).astype(np.float32)
    valid = rng.random((3, 12)) < 0.8
    qog, _ = auction_lap_reference(torch.from_numpy(cost), torch.from_numpy(valid), max_iters=1)
    qog = qog.numpy()
    for n in range(3):
        vc = np.flatnonzero(valid[n])
        assert len(np.unique(qog[n, vc])) == len(vc) and (qog[n, vc] >= 0).all()


def test_cost_matrix_matches_jax():
    """fp32, atol 1e-5 (softmax, L1 and GIoU terms)."""
    rng = np.random.default_rng(2)
    B, Q, G, C1 = 3, 10, 6, 8
    logits = rng.normal(size=(B, Q, C1)).astype(np.float32)
    pboxes = (1 / (1 + np.exp(-rng.normal(size=(B, Q, 4))))).astype(np.float32)
    labels = rng.integers(0, C1 - 1, size=(B, G))
    lo = rng.uniform(0, 0.6, size=(B, G, 2))
    gboxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, size=(B, G, 2))], -1).astype(np.float32)
    valid = rng.random((B, G)) < 0.7
    for b in range(B):
        want = jax_cost_matrix(*map(jnp.asarray, (logits[b], pboxes[b], labels[b], gboxes[b],
                                                  valid[b])))
        got = compute_cost_matrix(*map(torch.from_numpy, (logits[b], pboxes[b], labels[b],
                                                          gboxes[b], valid[b])))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # batched, and through the matcher: within the bound of scipy's exact match
    matcher = HungarianMatcher(eps_min=1e-4)
    qog = matcher(*map(torch.from_numpy, (logits, pboxes, labels, gboxes, valid))).numpy()
    exact = scipy_match_batch(logits, pboxes, labels, gboxes, valid)
    costs = compute_cost_matrix(*map(torch.from_numpy, (logits, pboxes, labels, gboxes,
                                                        valid))).numpy()
    _assert_near_optimal(costs, valid, qog, 1e-4)
    for b in range(B):
        vc = np.flatnonzero(valid[b])
        assert costs[b][exact[b, vc], vc].sum() <= costs[b][qog[b, vc], vc].sum() + 1e-5
    assert match_batch(*map(torch.from_numpy, (logits, pboxes, labels, gboxes, valid))).shape == (B, G)


def _criterion_problem(seed, B=3, L=3, Q=8, G=5, C=6):
    rng = np.random.default_rng(seed)
    outputs = {
        "pred_logits": rng.normal(size=(B, L, Q, C + 1)).astype(np.float32),
        "pred_boxes": (1 / (1 + np.exp(-rng.normal(size=(B, L, Q, 4))))).astype(np.float32),
    }
    lo = rng.uniform(0, 0.6, size=(B, G, 2))
    valid = rng.random((B, G)) < 0.7
    valid[0, :2] = True
    targets = {
        "class_idx": rng.integers(0, C, size=(B, G)).astype(np.int32),
        "boxes_normalized": np.concatenate(
            [lo, lo + rng.uniform(0.05, 0.4, size=(B, G, 2))], -1).astype(np.float32),
        "gt_valid": valid,
        "image_valid": np.array([True] * (B - 1) + [False]),  # one loader-padding row
    }
    qog = np.stack([np.stack([rng.permutation(Q)[:G] for _ in range(L)]) for _ in range(B)])
    qog = np.where(valid[:, None, :], qog, -1).astype(np.int32)
    return outputs, targets, qog, C


@pytest.mark.parametrize("seed", [0, 1])
def test_criterion_matches_jax_on_every_key(seed):
    """Same injected assignment on both sides; every key at atol 1e-5."""
    outputs, targets, qog, C = _criterion_problem(seed)
    jc = JaxCriterion(num_classes=C, matcher=lambda *a: jnp.asarray(qog))
    want = jc({k: jnp.asarray(v) for k, v in outputs.items()},
              {k: jnp.asarray(v) for k, v in targets.items()})
    pc = SetCriterion(num_classes=C, matcher=lambda *a: torch.from_numpy(qog))
    got = pc({k: torch.from_numpy(v) for k, v in outputs.items()},
             {k: torch.from_numpy(v) for k, v in targets.items()})
    assert set(got) == set(want) and len(got) == 4 * 3 + 1 + 4
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), abs=1e-5), key
    assert float(total_loss(got)) == pytest.approx(float(jax_total_loss(want)), abs=1e-4)


def test_criterion_gradient_reaches_outputs_only():
    outputs, targets, qog, C = _criterion_problem(3)
    logits = torch.from_numpy(outputs["pred_logits"]).requires_grad_()
    boxes = torch.from_numpy(outputs["pred_boxes"]).requires_grad_()
    crit = SetCriterion(num_classes=C, matcher=HungarianMatcher())
    losses = crit({"pred_logits": logits, "pred_boxes": boxes},
                  {k: torch.from_numpy(v) for k, v in targets.items()})
    total_loss(losses).backward()
    assert torch.isfinite(logits.grad).all() and logits.grad.abs().max() > 0
    assert boxes.grad.abs().max() > 0
    # the padded image takes no part
    assert float(logits.grad[-1].abs().max()) == 0.0
    crit = dataclasses.replace(crit, matcher=lambda *a: torch.from_numpy(qog))
    assert set(crit({"pred_logits": logits, "pred_boxes": boxes},
                    {k: torch.from_numpy(v) for k, v in targets.items()})) == set(losses)
