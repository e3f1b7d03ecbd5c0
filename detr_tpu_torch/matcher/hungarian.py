"""Batched Hungarian matcher (counterpart of ``detr_tpu/matcher/hungarian.py``).

The matching cost is the reference DETR's, in fp32:
  cost = cost_bbox * cdist_L1(pred_cxcywh, gt_cxcywh)
       + cost_class * (-softmax(logits)[:, gt_class])
       + cost_giou * (-GIoU(pred_xyxy, gt_xyxy)),
with invalid GT columns zeroed.  With ``focal_alpha`` (Deformable DETR's
sigmoid class head, C columns, no no-object) the class cost is the focal
one of the reference code: with p = sigmoid(logit) of the GT class,
alpha (1 - p)^2 (-log(p + 1e-8)) - (1 - alpha) p^2 (-log(1 - p + 1e-8)).
All B x decoder-layer problems are solved by one ``auction_lap`` call (the
CUDA auction kernel on the card).  The output is the dense ``query_of_gt``
(…, G) int32, -1 on padding, carrying no gradient.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from detr_tpu_torch.matcher.auction import auction_lap
from detr_tpu_torch.ops.boxes import (
    box_cxcywh_to_xyxy,
    box_xyxy_to_cxcywh,
    generalized_box_iou,
)


def compute_cost_matrix(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    cost_class: float = 1.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    focal_alpha: Optional[float] = None,
) -> torch.Tensor:
    """Matching cost over leading batch dims: pred_logits (…, Q, C+1) (or
    (…, Q, C) with ``focal_alpha``), pred boxes (…, Q, 4) cxcywh, gt_labels
    (…, G), gt_boxes (…, G, 4) normalized XYXY, gt_valid (…, G) bool ->
    (…, Q, G) fp32, invalid columns zeroed."""
    pred_boxes, gt_boxes = pred_boxes.float(), gt_boxes.float()
    safe_labels = torch.where(gt_valid, gt_labels, 0).long()
    index = safe_labels[..., None, :].expand(*pred_logits.shape[:-1], -1)
    if focal_alpha is None:
        c_class = -torch.softmax(pred_logits.float(), dim=-1).gather(-1, index)
    else:
        p = torch.sigmoid(pred_logits.float())
        pos = focal_alpha * (1 - p) ** 2 * (-(p + 1e-8).log())
        neg = (1 - focal_alpha) * p ** 2 * (-(1 - p + 1e-8).log())
        c_class = (pos - neg).gather(-1, index)
    gt_cxcywh = box_xyxy_to_cxcywh(gt_boxes)
    c_bbox = (pred_boxes[..., :, None, :] - gt_cxcywh[..., None, :, :]).abs().sum(-1)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes), gt_boxes)
    cost = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
    return torch.where(gt_valid[..., None, :], cost, 0.0)


@torch.no_grad()
def match_batch(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    cost_class: float = 1.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    eps_min: float = 1e-4,
    focal_alpha: Optional[float] = None,
) -> torch.Tensor:
    """Cost and solve over arbitrary leading batch dims (all arguments share
    them) -> query_of_gt (…, G) int32."""
    batch_shape = pred_logits.shape[:-2]
    Q, C1 = pred_logits.shape[-2:]
    G = gt_labels.shape[-1]
    costs = compute_cost_matrix(
        pred_logits.reshape(-1, Q, C1), pred_boxes.reshape(-1, Q, 4),
        gt_labels.reshape(-1, G), gt_boxes.reshape(-1, G, 4), gt_valid.reshape(-1, G),
        cost_class, cost_bbox, cost_giou, focal_alpha,
    )
    qog, _ = auction_lap(costs, gt_valid.reshape(-1, G), eps_min=eps_min)
    return qog.reshape(*batch_shape, G)


@dataclass(frozen=True)
class HungarianMatcher:
    """Configured matcher.  ``eps_min`` is the auction's final epsilon: the
    total cost is within 2 * eps_min per GT of the optimum; ``focal_alpha``
    selects the focal class cost (sigmoid logits)."""

    cost_class: float = 1.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    eps_min: float = 1e-4
    focal_alpha: Optional[float] = None

    def __post_init__(self):
        if self.cost_class == 0 and self.cost_bbox == 0 and self.cost_giou == 0:
            raise ValueError("all costs can't be 0")

    def __call__(self, pred_logits, pred_boxes, gt_labels, gt_boxes, gt_valid):
        return match_batch(
            pred_logits, pred_boxes, gt_labels, gt_boxes, gt_valid,
            cost_class=self.cost_class, cost_bbox=self.cost_bbox,
            cost_giou=self.cost_giou, eps_min=self.eps_min, focal_alpha=self.focal_alpha,
        )


def scipy_match_batch(
    pred_logits,
    pred_boxes,
    gt_labels,
    gt_boxes,
    gt_valid,
    cost_class: float = 1.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    focal_alpha: Optional[float] = None,
) -> np.ndarray:
    """Host-side exact solver (scipy's Jonker-Volgenant), the same dense
    output as :func:`match_batch`.  For tests and debugging, never on the
    train path."""
    from scipy.optimize import linear_sum_assignment

    def t(x):
        return torch.as_tensor(np.asarray(x))

    pl, pb, gl, gb, gv = (t(x) for x in (pred_logits, pred_boxes, gt_labels, gt_boxes, gt_valid))
    batch_shape = tuple(pl.shape[:-2])
    Q, C1 = pl.shape[-2:]
    G = gl.shape[-1]
    gv = gv.reshape(-1, G).bool()
    costs = compute_cost_matrix(
        pl.reshape(-1, Q, C1), pb.reshape(-1, Q, 4), gl.reshape(-1, G),
        gb.reshape(-1, G, 4), gv, cost_class, cost_bbox, cost_giou, focal_alpha,
    ).numpy()
    gv = gv.numpy()
    out = np.full((len(costs), G), -1, np.int32)
    for i in range(len(costs)):
        valid_cols = np.flatnonzero(gv[i])
        if len(valid_cols) == 0:
            continue
        rows, cols = linear_sum_assignment(costs[i][:, valid_cols])
        out[i, valid_cols[cols]] = rows
    return out.reshape(batch_shape + (G,))
