"""Deformable DETR's set criterion with an exact assignment, in fp32.

Per decoder layer and image, the valid ground-truth boxes are assigned to
queries by the Hungarian algorithm (scipy's ``linear_sum_assignment``,
``assign``), over

    cost = 5 * L1(pred cxcywh, gt cxcywh) + 2 * focal(gt class) - 2 * GIoU(pred, gt),
    focal(c) = alpha (1 - p_c)^2 (-log(p_c + 1e-8)) - (1 - alpha) p_c^2 (-log(1 - p_c + 1e-8)),

p_c the sigmoid of the query's logit of class c, the coefficients the
configuration states (the reference code's ``HungarianMatcher`` with its
focal class cost).  The loss of each layer is

- 2 * the sigmoid focal loss (alpha 0.25, gamma 2) of every query and
  class against the one-hot target of the matched queries' classes (zeros
  elsewhere), summed, divided by the batch's GT count (at least 1): the
  reference code's ``sigmoid_focal_loss(...) * num_queries``;
- 5 * the L1 and 2 * (1 - GIoU) of the matched boxes, each summed and
  divided by that count;

and the total is the sum over all layers.  ``sums`` returns the
numerators, so that a batch split into blocks of rows adds its blocks'
numerators and divides by the whole batch's count.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from benchmark.reference.criterion import (
    cxcywh_to_xyxy,
    giou_aligned,
    giou_pairwise,
    xyxy_to_cxcywh,
)

GAMMA = 2.0


def class_cost(logits: torch.Tensor, alpha: float) -> torch.Tensor:
    """(Q, C) logits -> (Q, C) focal class cost."""
    p = torch.sigmoid(logits.float())
    pos = alpha * (1 - p) ** GAMMA * (-(p + 1e-8).log())
    neg = (1 - alpha) * p ** GAMMA * (-(1 - p + 1e-8).log())
    return pos - neg


@torch.no_grad()
def cost_matrix(logits, boxes, gt_class, gt_boxes, costs: dict, alpha: float) -> np.ndarray:
    """One (image, layer)'s (Q, G) float64 matching cost: logits (Q, C),
    boxes (Q, 4) cxcywh, the G valid GT classes and XYXY boxes."""
    gb = gt_boxes.float()
    pb = boxes.float()
    c_bbox = torch.cdist(pb, xyxy_to_cxcywh(gb), p=1)
    c_class = class_cost(logits, alpha)[:, gt_class.long()]
    c_giou = -giou_pairwise(cxcywh_to_xyxy(pb), gb)
    cost = costs["bbox"] * c_bbox + costs["class"] * c_class + costs["giou"] * c_giou
    return cost.double().cpu().numpy()


@torch.no_grad()
def assign(logits, boxes, gt_class, gt_boxes, gt_valid, costs: dict, alpha: float) -> list:
    """The exact assignment per (image, layer): logits (B, L, Q, C), boxes
    (B, L, Q, 4); gt (B, G, ...) -> list over images of lists over layers of
    (query indices, gt indices)."""
    B, L = logits.shape[:2]
    out = []
    for b in range(B):
        cols = torch.nonzero(gt_valid[b]).flatten()
        per_layer = []
        for layer in range(L):
            if len(cols) == 0:
                per_layer.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
                continue
            cost = cost_matrix(logits[b, layer], boxes[b, layer], gt_class[b, cols],
                               gt_boxes[b, cols], costs, alpha)
            rows, cc = linear_sum_assignment(cost)
            per_layer.append((rows, cols.cpu().numpy()[cc]))
        out.append(per_layer)
    return out


def sigmoid_focal(logits: torch.Tensor, targets: torch.Tensor, alpha: float) -> torch.Tensor:
    """The reference code's ``sigmoid_focal_loss`` per element (no reduction)."""
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** GAMMA
    return (alpha * targets + (1 - alpha) * (1 - targets)) * loss


def sums(logits, boxes, gt_class, gt_boxes, gt_valid, matches, alpha: float) -> dict:
    """Per-layer (L,) numerators of the three loss terms over this block of
    images."""
    B, L, Q, C = logits.shape
    dev = logits.device
    focal, l1, giou = [], [], []
    for layer in range(L):
        onehot = torch.zeros(B, Q, C, device=dev)
        src_b, src_q, dst = [], [], []
        for b in range(B):
            rows, cols = matches[b][layer]
            rows_t = torch.as_tensor(rows, dtype=torch.long, device=dev)
            cls = gt_class[b, torch.as_tensor(cols, dtype=torch.long, device=dev)].long()
            onehot[b, rows_t, cls] = 1.0
            src_b += [b] * len(rows)
            src_q += list(rows)
            dst += list(cols)
        focal.append(sigmoid_focal(logits[:, layer], onehot, alpha).sum())
        bi = torch.as_tensor(src_b, dtype=torch.long, device=dev)
        qi = torch.as_tensor(np.asarray(src_q, np.int64), device=dev)
        gi = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
        pb = boxes[bi, layer, qi]
        gb = gt_boxes[bi, gi].float()
        l1.append((pb - xyxy_to_cxcywh(gb)).abs().sum())
        giou.append((1.0 - giou_aligned(cxcywh_to_xyxy(pb), gb)).sum())
    return {"focal": torch.stack(focal), "l1": torch.stack(l1), "giou": torch.stack(giou)}


def loss(s: dict, num_boxes: torch.Tensor, coefs: dict) -> torch.Tensor:
    """Total loss from numerators ``s`` and the whole batch's GT count."""
    nb = num_boxes.clamp(min=1.0)
    per_layer = (coefs["ce"] * s["focal"] + coefs["bbox"] * s["l1"]
                 + coefs["giou"] * s["giou"]) / nb
    return per_layer.sum()
