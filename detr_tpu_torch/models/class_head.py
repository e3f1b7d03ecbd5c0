"""How the class logits (C' columns) are read: DETR's softmax head or
Deformable DETR's sigmoid focal head.  ``models.class_head(config)`` picks
one, and a run's matcher and criterion share it.  Each head gives
``cost(logits (…, Q, C'), index (…, Q, G)) -> (…, Q, G)``, the matching
cost's class term (``matcher.hungarian``); for ``losses.criterion``,
``loss_sums(logits (L, B, Q, C'), target (L, B, Q), image_valid, no_object,
eos_coef)``, each layer's class-loss numerator and denominator, then
``loss_denominator(summed den, GT count)``, what divides the summed
numerator, and ``foreground`` (the queries predicting an object) and
``query_nll`` (each query's NLL) for the cardinality and ``diag_*``; and
``detections(logits (B, Q, C'), boxes (B, Q, 4)) -> (scores, labels,
boxes)`` for ``eval.postprocess``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch
import torch.nn.functional as F


def sigmoid_focal(logits: torch.Tensor, target: torch.Tensor, alpha: float,
                  gamma: float = 2.0) -> torch.Tensor:
    """The reference code's ``sigmoid_focal_loss`` per query, summed over
    its C classes: logits (..., C), target (...) a class index or C (no
    object: every class's target 0) -> (...)."""
    C = logits.shape[-1]
    classes = torch.arange(C, device=logits.device)
    onehot = (target[..., None] == classes).to(logits.dtype)  # no-object: all zeros
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, onehot, reduction="none")
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    return (alpha_t * ce * (1 - p_t) ** gamma).sum(-1)


@dataclass(frozen=True)
class SoftmaxClassHead:
    """DETR's head: C+1 softmax columns, the last "no object".  The cost is
    -softmax of the GT class; the loss a cross-entropy weighted ``eos_coef``
    on no-object targets over the weights' sum; an object is a real class's
    argmax; one detection per query, its best real class."""

    def cost(self, logits, index):
        return -torch.softmax(logits.float(), dim=-1).gather(-1, index)

    def loss_sums(self, logits, target, image_valid, no_object, eos_coef):
        class_weight = torch.ones(logits.shape[-1], device=logits.device)
        # A fill, not ``class_weight[no_object] = eos_coef``: that copies the
        # scalar from the host and makes the host wait for the card.
        class_weight.narrow(0, no_object, 1).fill_(eos_coef)
        nll = self.query_nll(logits, target, no_object)
        w = class_weight[target] * image_valid[:, None].float()
        return (w * nll).sum((1, 2)), w.sum((1, 2))

    def loss_denominator(self, den, num_boxes):
        return den.clamp(min=1e-6)

    def foreground(self, logits, no_object):
        return logits.argmax(-1) != no_object

    def query_nll(self, logits, target, no_object):
        return -F.log_softmax(logits, dim=-1).gather(-1, target[..., None])[..., 0]

    def detections(self, logits, boxes):
        probs = torch.softmax(logits.float(), dim=-1)
        scores, labels = probs[..., :-1].max(dim=-1)
        return scores, labels, boxes


@dataclass(frozen=True)
class FocalClassHead:
    """Deformable DETR's head: C sigmoid columns, no no-object.  With p the
    sigmoid of the GT class's logit, the cost is alpha (1 - p)^2
    (-log(p + 1e-8)) - (1 - alpha) p^2 (-log(1 - p + 1e-8)); the loss is
    ``sigmoid_focal`` (gamma 2) against the matched queries' one-hot targets
    (all zeros for the others) over the GT count, ``eos_coef`` unused; an
    object is a largest logit above 0; the NLL is the binary one; the
    ``top_k`` best (query, class) pairs by sigmoid, scores descending, are
    an image's detections (the reference code's 100)."""

    alpha: float
    top_k: int = 100

    @classmethod
    def of(cls, config) -> "FocalClassHead":
        """The head of a ``DeformableDETRConfig``: its ``focal_alpha``."""
        return cls(config.focal_alpha)

    def cost(self, logits, index):
        p = torch.sigmoid(logits.float())
        pos = self.alpha * (1 - p) ** 2 * (-(p + 1e-8).log())
        neg = (1 - self.alpha) * p ** 2 * (-(1 - p + 1e-8).log())
        return (pos - neg).gather(-1, index)

    def loss_sums(self, logits, target, image_valid, no_object, eos_coef):
        focal = sigmoid_focal(logits, target, self.alpha)  # (L, B, Q)
        num = (focal * image_valid[:, None].float()).sum((1, 2))
        return num, torch.zeros_like(num)  # the GT count divides it

    def loss_denominator(self, den, num_boxes):
        return num_boxes

    def foreground(self, logits, no_object):
        return logits.amax(-1) > 0

    def query_nll(self, logits, target, no_object):
        # the target class's -log sigmoid, or every class's mean -log(1 - sigmoid)
        pos = F.softplus(-logits.gather(-1, target.clamp(max=no_object - 1)[..., None])[..., 0])
        return torch.where(target != no_object, pos, F.softplus(logits).mean(-1))

    def detections(self, logits, boxes):
        B, Q, C = logits.shape
        scores, pair = torch.sigmoid(logits.float()).reshape(B, Q * C).topk(
            min(self.top_k, Q * C), dim=1)
        return scores, pair % C, boxes.gather(1, (pair // C)[..., None].expand(-1, -1, 4))


ClassHead = Union[SoftmaxClassHead, FocalClassHead]
