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
queries) and four ``diag_*`` curves.  The class terms are the ``head``'s
(``models.class_head``): the softmax ones above by default; with a
``FocalClassHead`` (Deformable DETR's sigmoid head over C classes, no
no-object class) the reference code's sigmoid focal loss divided by the GT
count, a cardinality of the queries whose largest logit is above 0, and
binary ``diag_*`` cross-entropies.
Keys: ``loss_label_ce{,_i}``, ``loss_l1_bbox{,_i}``, ``loss_giou{,_i}``,
``cardinality_error{,_i}`` with suffix ``_i`` for layers i < L-1.  GT comes
padded to G with a validity mask; ``image_valid`` False rows (loader
padding) take no part in any term.  The matcher is a field, so a caller can
inject a fixed assignment.

With a ``group`` (a data-parallel process group, in place of JAX's
``axis_name``) each rank holds a row block of the global batch, and every
sum above that spans images (the GT count, the weighted cross-entropy's
numerator and denominator, the cardinality's, the L1 and GIoU sums, the
class error's and the diagnostics') is summed over the group in one
all-reduce whose backward is the identity
(``parallel.tp.reduce_from_group``): every rank gets the global losses, and
its gradients are its share of the global gradient, so their sum over the
group is the gradient of the global batch.  The matching stays per image.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from detr_tpu_torch.models.class_head import ClassHead, SoftmaxClassHead
from detr_tpu_torch.ops.boxes import (
    box_cxcywh_to_xyxy,
    box_xyxy_to_cxcywh,
    elementwise_generalized_box_iou,
)
from detr_tpu_torch.parallel.tp import reduce_from_group
from detr_tpu_torch.utils.profiling import span


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


def _group_sum(sums: dict[str, torch.Tensor], group: Optional[Any]) -> dict[str, torch.Tensor]:
    """Each entry summed over ``group`` in one all-reduce (identity
    backward); the entries as they are without a group."""
    if group is None:
        return sums
    flat = reduce_from_group(torch.cat([v.reshape(-1) for v in sums.values()]), group)
    out, i = {}, 0
    for k, v in sums.items():
        out[k] = flat[i:i + v.numel()].view(v.shape)
        i += v.numel()
    return out


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
    head: ClassHead = SoftmaxClassHead()

    def __call__(
        self, outputs: dict[str, torch.Tensor], targets: dict[str, torch.Tensor],
        group: Optional[Any] = None,
    ) -> dict[str, torch.Tensor]:
        """outputs: pred_logits (B, L, Q, C+1), pred_boxes (B, L, Q, 4);
        targets: class_idx (B, G), boxes_normalized (B, G, 4) XYXY,
        gt_valid (B, G) bool, optional image_valid (B,) bool; ``group``: the
        data-parallel group whose ranks hold the global batch's row blocks.
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
        with span("train.match"):
            qog = self.matcher(
                logits.detach(), boxes.detach(),
                class_idx[:, None].expand(B, L, G),
                gt_boxes[:, None].expand(B, L, G, 4),
                gt_valid[:, None].expand(B, L, G),
            ).to(logits.device)

        # Layers lead: (L, B, …).
        lg, bx, qg = logits.transpose(0, 1), boxes.transpose(0, 1), qog.transpose(0, 1)
        sums = {"num_boxes": gt_valid.float().sum()}
        sums.update(self._layer_sums(lg, bx, qg, class_idx, gt_boxes, gt_valid, image_valid))
        sums.update(self._class_error_sums(lg[-1], qg[-1], class_idx, gt_valid))
        sums.update(self._diagnostic_sums(
            lg[-1], bx[-1], qg[-1], class_idx, gt_boxes, gt_valid, image_valid))
        s = _group_sum(sums, group)
        num_boxes = s["num_boxes"].clamp(min=1.0)
        ce_den = self.head.loss_denominator(s["ce_den"], num_boxes)
        per_layer = {
            "label_ce": self.weight_label_ce * s["ce_num"] / ce_den,
            "cardinality": s["card_num"] / s["card_den"].clamp(min=1.0),
            "l1_bbox": self.weight_bbox_l1 * s["l1"] / num_boxes,
            "giou": self.weight_bbox_giou * s["giou"] / num_boxes,
        }
        losses: dict[str, torch.Tensor] = {}
        for i in range(L):
            sfx = f"_{i}" if i < L - 1 else ""
            losses[f"loss_label_ce{sfx}"] = per_layer["label_ce"][i]
            losses[f"cardinality_error{sfx}"] = per_layer["cardinality"][i]
            losses[f"loss_l1_bbox{sfx}"] = per_layer["l1_bbox"][i]
            losses[f"loss_giou{sfx}"] = per_layer["giou"][i]
        losses["class_error"] = 100.0 - 100.0 * s["correct"] / s["matched_pairs"].clamp(min=1.0)
        losses.update({
            "diag_matched_ce": s["matched_nll"] / s["matched"].clamp(min=1.0),
            "diag_noobj_ce": s["noobj_nll"] / s["noobj"].clamp(min=1.0),
            "diag_nonbg_frac": s["nonbg"] / s["queries"].clamp(min=1.0),
            "diag_matched_giou": s["giou_sum"] / s["giou_pairs"].clamp(min=1.0),
        })
        return losses

    def _layer_sums(self, logits, boxes, qog, class_idx, gt_boxes, gt_valid, image_valid):
        """Every layer at once: logits (L, B, Q, C+1), boxes (L, B, Q, 4),
        qog (L, B, G) -> the (L,) numerators and denominators of the four
        per-layer terms, summed over this batch's images."""
        Q = logits.shape[-2]
        no_object = self.num_classes
        target = _target_classes(qog, class_idx, gt_valid, Q, no_object)  # (L, B, Q)
        ce_num, ce_den = self.head.loss_sums(logits, target, image_valid, no_object,
                                             self.eos_coef)

        card_pred = self.head.foreground(logits, no_object).float().sum(-1)  # (L, B)
        n_gt = gt_valid.float().sum(-1)
        img_w = image_valid.float()

        pair_valid = gt_valid & (qog >= 0)  # (L, B, G)
        src = _gather_boxes(boxes, qog)
        l1 = torch.where(pair_valid[..., None], (src - box_xyxy_to_cxcywh(gt_boxes)).abs(), 0.0)
        giou = elementwise_generalized_box_iou(box_cxcywh_to_xyxy(src), gt_boxes)
        return {
            "ce_num": ce_num,
            "ce_den": ce_den,
            "card_num": (img_w * (card_pred - n_gt).abs()).sum(-1),
            "card_den": img_w.sum(),
            "l1": l1.sum((1, 2, 3)),
            "giou": torch.where(pair_valid, 1.0 - giou, 0.0).sum((1, 2)),
        }

    def _class_error_sums(self, logits, qog, class_idx, gt_valid):
        """The last layer's matched queries whose top-1 class is right, and
        the matched queries (class error: 100 - 100 * their ratio; 100 when
        there is no GT at all)."""
        pair_valid = gt_valid & (qog >= 0)
        idx = qog.long().clamp(min=0)[..., None].expand(*qog.shape, logits.shape[-1])
        pred = logits.gather(1, idx).argmax(-1)
        return {"correct": torch.where(pair_valid, (pred == class_idx).float(), 0.0).sum(),
                "matched_pairs": pair_valid.float().sum()}

    def _diagnostic_sums(self, logits, boxes, qog, class_idx, gt_boxes, gt_valid, image_valid):
        """Sums of the last-layer ``diag_*`` values, not summed into the
        loss: mean NLL over matched and over no-object queries, the fraction
        of queries predicting an object, and the mean GIoU of matched
        pairs."""
        B, Q, _ = logits.shape
        no_object = self.num_classes
        target = _target_classes(qog, class_idx, gt_valid, Q, no_object)
        nll = self.head.query_nll(logits, target, no_object)
        img_w = image_valid[:, None].float()
        matched = (target != no_object).float() * img_w
        noobj = (target == no_object).float() * img_w
        nonbg = self.head.foreground(logits, no_object).float()
        pair_valid = gt_valid & (qog >= 0)
        giou = elementwise_generalized_box_iou(
            box_cxcywh_to_xyxy(_gather_boxes(boxes, qog)), gt_boxes)
        return {
            "matched_nll": (matched * nll).sum(), "matched": matched.sum(),
            "noobj_nll": (noobj * nll).sum(), "noobj": noobj.sum(),
            "nonbg": (nonbg * img_w).sum(), "queries": img_w.expand(B, Q).sum(),
            "giou_sum": torch.where(pair_valid, giou, 0.0).sum(),
            "giou_pairs": pair_valid.float().sum(),
        }
