"""The input path, redone: normalising uint8 pixels, the serving resize and
buckets, padding, and the detections a served request returns.

- normalise: ``(x / 255 - mean) / std`` with ImageNet's mean and std, in
  fp32, every pixel outside the image's valid extent exactly 0;
- the serving resize: the short side to 800 without the long side passing
  1333, sizes rounded to the nearest pixel, a separable triangle (bilinear)
  filter whose support widens by the scale when it shrinks, each output
  rounded half up to uint8 (PIL's ``BILINEAR``);
- buckets: the fitting (H, W) canvas of least padding, ties to the first;
- detections: softmax over the last decoder layer's classes, the best real
  class and its probability per query, its box in XYXY pixels of the
  original image.
"""

from __future__ import annotations

import numpy as np
import torch

MEAN = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float64)
STD = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float64)
SERVE_BUCKETS = ((800, 1344), (1344, 800))


def normalize(images: torch.Tensor, heights: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> fp32 normalised, 0 outside each (height, width)."""
    dev = images.device
    x = (images.double() / 255.0 - MEAN.to(dev)) / STD.to(dev)
    _, H, W, _ = images.shape
    rows = torch.arange(H, device=dev)[None, :, None] < heights[:, None, None]
    cols = torch.arange(W, device=dev)[None, None, :] < widths[:, None, None]
    return torch.where((rows & cols)[..., None], x, 0.0).float()


def serve_size(h: int, w: int, min_size: int = 800, max_size: int = 1333) -> tuple[int, int]:
    r = min(min_size / min(h, w), max_size / max(h, w))
    return int(round(h * r)), int(round(w * r))


def _filter_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) float64 weights of the triangle filter."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    for o in range(n_out):
        center = (o + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        xs = torch.arange(lo, hi, dtype=torch.float64)
        wts = (1.0 - ((xs - center + 0.5) / support).abs()).clamp(min=0.0)
        m[o, lo:hi] = wts / wts.sum()
    return m


def resize_uint8(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(h, w, 3) uint8 -> (nh, nw, 3) uint8, columns first, then rows."""
    h, w, _ = img.shape
    dev = img.device
    mx = _filter_matrix(w, nw).to(dev)
    my = _filter_matrix(h, nh).to(dev)
    x = torch.einsum("ow,hwc->hoc", mx, img.double())
    x = torch.einsum("oh,hwc->owc", my, x)
    return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)


def pick_bucket(h: int, w: int, buckets=SERVE_BUCKETS) -> int:
    best, waste = -1, None
    for i, (bh, bw) in enumerate(buckets):
        if h <= bh and w <= bw and (waste is None or bh * bw - h * w < waste):
            best, waste = i, bh * bw - h * w
    if best < 0:
        raise ValueError(f"no bucket holds {h}x{w}")
    return best


def serve_input(img: np.ndarray, device, min_size: int = 800, max_size: int = 1333,
                buckets=SERVE_BUCKETS) -> tuple[torch.Tensor, int, int]:
    """A request's uint8 (h, w, 3) image -> its (1, H, W, 3) normalised
    canvas, and the resized extent."""
    t = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    th, tw = serve_size(*img.shape[:2], min_size, max_size)
    r = resize_uint8(t, th, tw)
    bh, bw = buckets[pick_bucket(th, tw, buckets)]
    canvas = torch.zeros(1, bh, bw, 3, dtype=torch.uint8, device=device)
    canvas[0, :th, :tw] = r
    ext_h = torch.tensor([th], device=device)
    ext_w = torch.tensor([tw], device=device)
    return normalize(canvas, ext_h, ext_w), th, tw


def detections(logits: torch.Tensor, boxes: torch.Tensor, orig_h: int, orig_w: int) -> dict:
    """Last layer's (Q, C+1) logits and (Q, 4) cxcywh boxes -> per-query
    probabilities (Q, C), scores, labels and XYXY pixel boxes."""
    probs = torch.softmax(logits.double(), -1)[:, :-1]
    scores, labels = probs.max(-1)
    cx, cy, w, h = boxes.double().unbind(-1)
    xyxy = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)
    xyxy = xyxy * torch.tensor([orig_w, orig_h, orig_w, orig_h], dtype=torch.float64,
                               device=xyxy.device)
    return {"probs": probs, "scores": scores, "labels": labels, "boxes": xyxy}
