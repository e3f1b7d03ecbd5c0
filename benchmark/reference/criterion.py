"""DETR's set criterion with an exact assignment, in fp32.

Per decoder layer and image, the valid ground-truth boxes are assigned to
queries by the Hungarian algorithm (scipy's ``linear_sum_assignment``) over

    cost = 5 * L1(pred cxcywh, gt cxcywh) - 1 * p(gt class) - 2 * GIoU(pred, gt),

the coefficients the configuration states.  The loss of each layer is

- the class cross-entropy over C+1 classes, unmatched queries targeting the
  no-object class, each term weighted by its target's class weight (1, and
  ``eos_coef`` for no-object) and divided by the sum of those weights;
- 5 * the L1 of the matched boxes (cxcywh) and 2 * (1 - GIoU) of the
  matched boxes (xyxy), each summed and divided by the batch's GT count
  (at least 1);

and the total is the sum over all layers.  ``sums`` returns the
numerators, so that a batch split into blocks of rows adds its blocks'
numerators and divides by the whole batch's ``denominators``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment


def cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def xyxy_to_cxcywh(b):
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([0.5 * (x0 + x1), 0.5 * (y0 + y1), x1 - x0, y1 - y0], -1)


def giou_pairwise(a, b):
    """(N, 4) and (M, 4) xyxy -> (N, M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    iou = inter / union.clamp(min=1e-9)
    lt = torch.minimum(a[:, None, :2], b[None, :, :2])
    rb = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp(min=1e-9)


def giou_aligned(a, b):
    """(N, 4) and (N, 4) xyxy -> (N,)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, :2], b[:, :2])
    rb = torch.minimum(a[:, 2:], b[:, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[:, 0] * wh[:, 1]
    union = area_a + area_b - inter
    iou = inter / union.clamp(min=1e-9)
    lt = torch.minimum(a[:, :2], b[:, :2])
    rb = torch.maximum(a[:, 2:], b[:, 2:])
    wh = (rb - lt).clamp(min=0)
    hull = wh[:, 0] * wh[:, 1]
    return iou - (hull - union) / hull.clamp(min=1e-9)


@torch.no_grad()
def assign(logits, boxes, gt_class, gt_boxes, gt_valid, costs: dict) -> list:
    """Per (image, layer): (query indices, gt indices) of the exact assignment.
    logits (B, L, Q, C+1), boxes (B, L, Q, 4); gt (B, G, ...).  -> list over
    images of lists over layers."""
    B, L = logits.shape[:2]
    probs = torch.softmax(logits.float(), -1)
    out = []
    for b in range(B):
        cols = torch.nonzero(gt_valid[b]).flatten()
        per_layer = []
        for layer in range(L):
            if len(cols) == 0:
                per_layer.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
                continue
            gb = gt_boxes[b, cols].float()
            pb = boxes[b, layer].float()
            c_bbox = torch.cdist(pb, xyxy_to_cxcywh(gb), p=1)
            c_class = -probs[b, layer][:, gt_class[b, cols].long()]
            c_giou = -giou_pairwise(cxcywh_to_xyxy(pb), gb)
            cost = costs["bbox"] * c_bbox + costs["class"] * c_class + costs["giou"] * c_giou
            rows, cc = linear_sum_assignment(cost.double().cpu().numpy())
            per_layer.append((rows, cols.cpu().numpy()[cc]))
        out.append(per_layer)
    return out


def sums(logits, boxes, gt_class, gt_boxes, gt_valid, matches, num_classes: int,
         eos_coef: float) -> dict:
    """Per-layer (L,) numerators of the three loss terms over this block of
    images."""
    B, L, Q, C1 = logits.shape
    dev = logits.device
    ce_num, l1, giou = [], [], []
    weight = torch.ones(C1, device=dev)
    weight[num_classes] = eos_coef
    for layer in range(L):
        target = torch.full((B, Q), num_classes, dtype=torch.long, device=dev)
        src_b, src_q, dst = [], [], []
        for b in range(B):
            rows, cols = matches[b][layer]
            target[b, torch.as_tensor(rows, device=dev)] = gt_class[b, torch.as_tensor(
                cols, device=dev)].long()
            src_b += [b] * len(rows)
            src_q += list(rows)
            dst += list(cols)
        lg = logits[:, layer]
        nll = -F.log_softmax(lg, -1).gather(-1, target[..., None])[..., 0]
        ce_num.append((weight[target] * nll).sum())
        bi = torch.as_tensor(src_b, dtype=torch.long, device=dev)
        qi = torch.as_tensor(np.asarray(src_q, np.int64), device=dev)
        gi = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
        pb = boxes[bi, layer, qi]
        gb = gt_boxes[bi, gi].float()
        l1.append((pb - xyxy_to_cxcywh(gb)).abs().sum())
        giou.append((1.0 - giou_aligned(cxcywh_to_xyxy(pb), gb)).sum())
    return {"ce_num": torch.stack(ce_num), "l1": torch.stack(l1), "giou": torch.stack(giou)}


def denominators(gt_valid: torch.Tensor, queries: int, eos_coef: float) -> dict:
    """The whole batch's denominators, known before any forward: every valid
    GT box takes one query (weight 1), the other queries target no-object
    (weight ``eos_coef``)."""
    n = gt_valid.float().sum(-1)
    return {"ce_den": (n + eos_coef * (queries - n)).sum(), "num_boxes": n.sum()}


def loss(s: dict, den: dict, coefs: dict) -> torch.Tensor:
    """Total loss from numerators ``s`` and whole-batch denominators ``den``."""
    nb = den["num_boxes"].clamp(min=1.0)
    per_layer = (coefs["ce"] * s["ce_num"] / den["ce_den"].clamp(min=1e-6)
                 + coefs["bbox"] * s["l1"] / nb + coefs["giou"] * s["giou"] / nb)
    return per_layer.sum()
