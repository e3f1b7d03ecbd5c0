"""DETR set criterion (counterpart of ``detr_tpu/losses/criterion.py``).

For every decoder layer: match predictions to ground truth, then
  * cross-entropy over C+1 classes with no-object weight ``eos_coef``
    (the mean weighted by each target's class weight); unmatched queries
    target the no-object class C;
  * L1 on cxcywh boxes and GIoU loss on xyxy boxes, summed over matched
    pairs and divided by the number of GT boxes (at least 1);
  * the cardinality error, |#non-no-object argmaxes - #GT| averaged over
    images (a diagnostic);
and for the last layer ``class_error`` (100 - top-1 accuracy over matched
queries) and four ``diag_*`` curves.  Keys: ``loss_label_ce{,_i}``,
``loss_l1_bbox{,_i}``, ``loss_giou{,_i}``, ``cardinality_error{,_i}`` with
suffix ``_i`` for layers i < L-1.  GT comes padded to G with a validity mask;
``image_valid`` False rows (loader padding) take no part in any term.  The
matcher is a field, so a caller can inject a fixed assignment.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from detr_tpu_torch.ops.boxes import (
    box_cxcywh_to_xyxy,
    box_xyxy_to_cxcywh,
    elementwise_generalized_box_iou,
)


def total_loss(loss_dict: dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of every entry whose key starts with "loss"."""
    return sum(v for k, v in loss_dict.items() if k.startswith("loss"))


def _target_classes(qog, class_idx, gt_valid, Q, no_object):
    """(B, Q) target class of every query: its matched GT's class, else
    no-object.  qog (…, B, G) may carry a leading layer dim."""
    B, G = class_idx.shape
    lead = qog.shape[:-2]
    target = torch.full((*lead, B, Q + 1), no_object, dtype=torch.long, device=qog.device)
    scatter_q = torch.where(gt_valid & (qog >= 0), qog.long(), Q)  # unmatched -> dropped column
    target.scatter_(-1, scatter_q, class_idx.long().expand(*lead, B, G))
    return target[..., :Q]


def _gather_boxes(boxes, qog):
    """boxes (…, B, Q, 4), qog (…, B, G) -> matched boxes (…, B, G, 4)."""
    idx = qog.long().clamp(min=0)[..., None].expand(*qog.shape, 4)
    return boxes.gather(-2, idx)


@dataclass(frozen=True)
class SetCriterion:
    num_classes: int
    matcher: Callable
    weight_label_ce: float = 1.0
    weight_bbox_l1: float = 5.0
    weight_bbox_giou: float = 2.0
    eos_coef: float = 0.1

    def __call__(
        self, outputs: dict[str, torch.Tensor], targets: dict[str, torch.Tensor]
    ) -> dict[str, torch.Tensor]:
        """outputs: pred_logits (B, L, Q, C+1), pred_boxes (B, L, Q, 4);
        targets: class_idx (B, G), boxes_normalized (B, G, 4) XYXY,
        gt_valid (B, G) bool, optional image_valid (B,) bool.
        Returns a dict of fp32 scalars."""
        logits = outputs["pred_logits"].float()
        boxes = outputs["pred_boxes"].float()
        B, L, Q, _ = logits.shape
        class_idx = targets["class_idx"].long()
        gt_boxes = targets["boxes_normalized"].float()
        image_valid = targets.get("image_valid")
        if image_valid is None:
            image_valid = torch.ones(B, dtype=torch.bool, device=logits.device)
        image_valid = image_valid.bool()
        gt_valid = targets["gt_valid"].bool() & image_valid[:, None]
        G = class_idx.shape[-1]

        # One matcher call for all layers: (B, L, G).
        qog = self.matcher(
            logits.detach(), boxes.detach(),
            class_idx[:, None].expand(B, L, G),
            gt_boxes[:, None].expand(B, L, G, 4),
            gt_valid[:, None].expand(B, L, G),
        ).to(logits.device)
        num_boxes = gt_valid.float().sum().clamp(min=1.0)

        # Layers lead: (L, B, …).
        lg, bx, qg = logits.transpose(0, 1), boxes.transpose(0, 1), qog.transpose(0, 1)
        per_layer = self._layer_losses(lg, bx, qg, class_idx, gt_boxes, gt_valid, num_boxes,
                                       image_valid)
        losses: dict[str, torch.Tensor] = {}
        for i in range(L):
            sfx = f"_{i}" if i < L - 1 else ""
            losses[f"loss_label_ce{sfx}"] = per_layer["label_ce"][i]
            losses[f"cardinality_error{sfx}"] = per_layer["cardinality"][i]
            losses[f"loss_l1_bbox{sfx}"] = per_layer["l1_bbox"][i]
            losses[f"loss_giou{sfx}"] = per_layer["giou"][i]
        losses["class_error"] = self._class_error(lg[-1], qg[-1], class_idx, gt_valid)
        losses.update(self._liftoff_diagnostics(
            lg[-1], bx[-1], qg[-1], class_idx, gt_boxes, gt_valid, image_valid))
        return losses

    def _layer_losses(self, logits, boxes, qog, class_idx, gt_boxes, gt_valid, num_boxes,
                      image_valid):
        """Every layer at once: logits (L, B, Q, C+1), boxes (L, B, Q, 4),
        qog (L, B, G) -> dict of (L,) tensors."""
        Q, C1 = logits.shape[-2:]
        no_object = self.num_classes
        target = _target_classes(qog, class_idx, gt_valid, Q, no_object)  # (L, B, Q)
        class_weight = torch.ones(C1, device=logits.device)
        # A fill, not ``class_weight[no_object] = eos_coef``: that copies the
        # scalar from the host and makes the host wait for the card.
        class_weight.narrow(0, no_object, 1).fill_(self.eos_coef)
        nll = -F.log_softmax(logits, dim=-1).gather(-1, target[..., None])[..., 0]
        w = class_weight[target] * image_valid[:, None].float()
        loss_ce = self.weight_label_ce * (w * nll).sum((1, 2)) / w.sum((1, 2)).clamp(min=1e-6)

        card_pred = (logits.argmax(-1) != no_object).float().sum(-1)  # (L, B)
        n_gt = gt_valid.float().sum(-1)
        img_w = image_valid.float()
        cardinality = (img_w * (card_pred - n_gt).abs()).sum(-1) / img_w.sum().clamp(min=1.0)

        pair_valid = gt_valid & (qog >= 0)  # (L, B, G)
        src = _gather_boxes(boxes, qog)
        l1 = torch.where(pair_valid[..., None], (src - box_xyxy_to_cxcywh(gt_boxes)).abs(), 0.0)
        giou = elementwise_generalized_box_iou(box_cxcywh_to_xyxy(src), gt_boxes)
        return {
            "label_ce": loss_ce,
            "cardinality": cardinality,
            "l1_bbox": self.weight_bbox_l1 * l1.sum((1, 2, 3)) / num_boxes,
            "giou": self.weight_bbox_giou
            * torch.where(pair_valid, 1.0 - giou, 0.0).sum((1, 2)) / num_boxes,
        }

    def _class_error(self, logits, qog, class_idx, gt_valid):
        """100 - top-1 accuracy over the last layer's matched queries; 100
        when there is no GT at all."""
        pair_valid = gt_valid & (qog >= 0)
        idx = qog.long().clamp(min=0)[..., None].expand(*qog.shape, logits.shape[-1])
        pred = logits.gather(1, idx).argmax(-1)
        correct = torch.where(pair_valid, (pred == class_idx).float(), 0.0).sum()
        return 100.0 - 100.0 * correct / pair_valid.float().sum().clamp(min=1.0)

    def _liftoff_diagnostics(self, logits, boxes, qog, class_idx, gt_boxes, gt_valid,
                             image_valid):
        """Last-layer ``diag_*`` values, not summed into the loss: mean NLL
        over matched and over no-object queries, the fraction of queries
        whose argmax is a real class, and the mean GIoU of matched pairs."""
        B, Q, _ = logits.shape
        no_object = self.num_classes
        target = _target_classes(qog, class_idx, gt_valid, Q, no_object)
        nll = -F.log_softmax(logits, dim=-1).gather(-1, target[..., None])[..., 0]
        img_w = image_valid[:, None].float()
        matched = (target != no_object).float() * img_w
        noobj = (target == no_object).float() * img_w
        nonbg = (logits.argmax(-1) != no_object).float()
        pair_valid = gt_valid & (qog >= 0)
        giou = elementwise_generalized_box_iou(
            box_cxcywh_to_xyxy(_gather_boxes(boxes, qog)), gt_boxes)
        return {
            "diag_matched_ce": (matched * nll).sum() / matched.sum().clamp(min=1.0),
            "diag_noobj_ce": (noobj * nll).sum() / noobj.sum().clamp(min=1.0),
            "diag_nonbg_frac": (nonbg * img_w).sum() / img_w.expand(B, Q).sum().clamp(min=1.0),
            "diag_matched_giou": torch.where(pair_valid, giou, 0.0).sum()
            / pair_valid.float().sum().clamp(min=1.0),
        }
