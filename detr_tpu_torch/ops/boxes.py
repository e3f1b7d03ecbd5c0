"""Box geometry in fp32 (counterpart of ``detr_tpu/ops/boxes.py``): format
converters, areas, pairwise and elementwise (G)IoU, top-1 accuracy and
clamping.  Degenerate boxes are handled by safe division, not asserts."""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(…, 4) [cx, cy, w, h] -> [x0, y0, x1, y1]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(…, 4) [x0, y0, x1, y1] -> [cx, cy, w, h]."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([0.5 * (x0 + x1), 0.5 * (y0 + y1), x1 - x0, y1 - y0], dim=-1)


_EPS = 1e-9


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(…, 4) XYXY -> (…,) area."""
    boxes = boxes.float()
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU of (…, N, 4) and (…, M, 4) XYXY boxes -> (iou, union),
    each (…, N, M) fp32."""
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=_EPS), union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of XYXY boxes -> (…, N, M) fp32; degenerate boxes give
    finite values the caller masks out."""
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp(min=_EPS)


def elementwise_box_iou(
    boxes1: torch.Tensor, boxes2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """IoU of aligned box pairs: both (…, 4) -> ((…,), (…,))."""
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union.clamp(min=_EPS), union


def elementwise_generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned box pairs (the GIoU loss is 1 - this)."""
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    iou, union = elementwise_box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp(min=_EPS)


def top1_accuracy(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked top-1 accuracy in percent over valid rows (0 when none)."""
    correct = torch.where(valid, (logits.argmax(-1) == targets).float(), 0.0)
    return 100.0 * correct.sum() / valid.float().sum().clamp(min=1.0)


def clamp_boxes(boxes: torch.Tensor, height: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """Clamp XYXY boxes into [0, w] x [0, h]."""
    boxes = boxes.float()
    h = torch.as_tensor(height, dtype=torch.float32, device=boxes.device)[..., None]
    w = torch.as_tensor(width, dtype=torch.float32, device=boxes.device)[..., None]
    zero = torch.zeros((), device=boxes.device)
    x0 = torch.minimum(torch.maximum(boxes[..., 0:1], zero), w)
    y0 = torch.minimum(torch.maximum(boxes[..., 1:2], zero), h)
    x1 = torch.minimum(torch.maximum(boxes[..., 2:3], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 3:4], zero), h)
    return torch.cat([x0, y0, x1, y1], dim=-1)
