"""Model-output -> detection post-processing (counterpart of
``detr_tpu/eval/postprocess.py``).

Softmax over class logits, drop the no-object column, per-query best class
and score, cxcywh -> xyxy, scale to the image's pixel size; the host stage
applies the score threshold and emits one dict per image.  A sigmoid head
(``sigmoid_top_k`` k > 0, the model's: Deformable DETR's 100) takes the top
k of the sigmoid scores of all Q x C (query, class) pairs instead, each
with its query's box, so a query can give several detections.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from detr_tpu_torch.ops.boxes import box_cxcywh_to_xyxy

def postprocess_predictions(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    image_heights: torch.Tensor,
    image_widths: torch.Tensor,
    sigmoid_top_k: int = 0,
) -> dict[str, torch.Tensor]:
    """pred_logits (B, Q, C+1), pred_boxes (B, Q, 4) normalized cxcywh,
    (B,) pixel extents -> {scores (B, Q), labels (B, Q) int32,
    boxes (B, Q, 4) XYXY pixels}.  With ``sigmoid_top_k`` k > 0: logits
    (B, Q, C) of a sigmoid head -> the k best (query, class) pairs, scores
    descending, (B, k) each and boxes (B, k, 4)."""
    boxes = box_cxcywh_to_xyxy(pred_boxes.float())
    if sigmoid_top_k > 0:
        B, Q, C = pred_logits.shape
        scores, pair = torch.sigmoid(pred_logits.float()).reshape(B, Q * C).topk(
            min(sigmoid_top_k, Q * C), dim=1)
        labels = pair % C
        boxes = boxes.gather(1, (pair // C)[..., None].expand(-1, -1, 4))
    else:
        probs = torch.softmax(pred_logits.float(), dim=-1)
        scores, labels = probs[..., :-1].max(dim=-1)
    scale = torch.stack([image_widths, image_heights, image_widths, image_heights], dim=-1)
    boxes = boxes * scale.float()[:, None, :]
    return {"scores": scores, "labels": labels.to(torch.int32), "boxes": boxes}


class PostProcess:
    """Host-side wrapper: per-image {scores, labels, boxes[, class_names]};
    ``sigmoid_top_k`` as ``postprocess_predictions``'."""

    def __init__(self, class_names: Optional[Sequence[str]] = None, sigmoid_top_k: int = 0):
        self.class_names = list(class_names) if class_names is not None else None
        self.sigmoid_top_k = sigmoid_top_k

    def __call__(
        self,
        pred_logits,
        pred_boxes,
        image_heights,
        image_widths,
        score_threshold: float = 0.0,
    ) -> list[dict]:
        out = postprocess_predictions(
            torch.as_tensor(pred_logits),
            torch.as_tensor(pred_boxes),
            torch.as_tensor(image_heights),
            torch.as_tensor(image_widths),
            self.sigmoid_top_k,
        )
        scores, labels, boxes = (out[k].cpu().numpy() for k in ("scores", "labels", "boxes"))
        results = []
        for s, lab, b in zip(scores, labels, boxes):
            keep = s >= score_threshold
            item = {"scores": s[keep], "labels": lab[keep], "boxes": b[keep]}
            if self.class_names is not None:
                item["class_names"] = [self.class_names[i] for i in lab[keep]]
            results.append(item)
        return results
