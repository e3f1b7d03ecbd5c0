"""Inputs made from the seed: images, boxes, a COCO-format dataset on disk,
the resident training batches and the serving pool.

Every seed gets the same set of sizes and of box counts, in another order:
the sizes cycle through the traffic's list, and the box counts are the
quantiles of a Poisson law at the traffic's mean (``counts``), permuted by
the seed.  So two seeds ask the same work of the program; the pixels, box
positions and classes differ.  Pixels are smooth noise (a coarse random
field upsampled bilinearly, plus fine noise), made on the device.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

# COCO 2017's 80 category ids (the detection split's, in order).
COCO_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
            25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 46, 47, 48, 49,
            50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74,
            75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0xFFFFFFFFFFFF)
    return g


def counts(n: int, mean: float, cap: int, seed: int) -> list[int]:
    """n box counts: the Poisson(mean) quantiles at (i + 0.5) / n, capped,
    in an order drawn from the seed."""
    cdf, k, pk, out = 0.0, 0, math.exp(-mean), []
    for i in range(n):
        q = (i + 0.5) / n
        while cdf + pk < q:
            cdf += pk
            k += 1
            pk *= mean / k
        out.append(min(k, cap))
    order = torch.randperm(n, generator=torch.Generator().manual_seed(seed & 0xFFFFFFFFFFFF))
    return [out[i] for i in order.tolist()]


def images(n: int, h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, h, w, 3) uint8 smooth noise."""
    coarse = torch.randn(n, 3, max(2, h // 32), max(2, w // 32), generator=gen, device=device)
    x = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    x = 128.0 + 45.0 * x + 12.0 * torch.randn(n, 3, h, w, generator=gen, device=device)
    return x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def boxes(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, 4) normalised XYXY boxes, sides 5-60 % of the image."""
    u = torch.rand(n, 4, generator=gen, device=device)
    bw, bh = 0.05 + 0.55 * u[:, 0], 0.05 + 0.55 * u[:, 1]
    x0, y0 = u[:, 2] * (1 - bw), u[:, 3] * (1 - bh)
    return torch.stack([x0, y0, x0 + bw, y0 + bh], -1)


def write_coco(root: str, traffic: dict, seed: int, device) -> None:
    """``traffic["images"]`` JPEGs under ``root/train/data`` and a
    ``labels.json`` of ``traffic["labels"]`` entries cycling over them."""
    from PIL import Image

    gen = generator(seed, device)
    n = traffic["images"]
    sizes = [tuple(traffic["source_sizes"][i % len(traffic["source_sizes"])]) for i in range(n)]
    per_image = counts(n, traffic["boxes_per_image_mean"], traffic["max_boxes"], seed)
    data = os.path.join(root, "train", "data")
    os.makedirs(data, exist_ok=True)
    anns_of = []
    for size in sorted(set(sizes)):
        idx = [i for i, s in enumerate(sizes) if s == size]
        pix = images(len(idx), size[0], size[1], gen, device).cpu().numpy()
        for j, i in enumerate(idx):
            Image.fromarray(pix[j]).save(os.path.join(data, f"{i:06d}.jpg"), quality=90)
    for i, (h, w) in enumerate(sizes):
        b = boxes(per_image[i], gen, device).cpu().double().numpy() * [w, h, w, h]
        cls = torch.randint(0, len(COCO_IDS), (per_image[i],), generator=gen,
                            device=device).tolist()
        anns_of.append([(float(x0), float(y0), float(x1 - x0), float(y1 - y0), COCO_IDS[c])
                        for (x0, y0, x1, y1), c in zip(b.tolist(), cls)])
    entries, anns = [], []
    for e in range(traffic["labels"]):
        i = e % n
        h, w = sizes[i]
        entries.append({"id": e + 1, "file_name": f"{i:06d}.jpg", "height": h, "width": w})
        for x, y, bw, bh, c in anns_of[i]:
            anns.append({"id": len(anns) + 1, "image_id": e + 1, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "category_id": c, "iscrowd": 0})
    cats = [{"id": c, "name": f"class_{c}", "supercategory": "none"} for c in COCO_IDS]
    with open(os.path.join(root, "train", "labels.json"), "w") as f:
        json.dump({"images": entries, "annotations": anns, "categories": cats}, f)


def resident_batches(traffic: dict, num_classes: int, seed: int, device) -> list[dict]:
    """``traffic["batches"]`` batches of ``micro_batch`` uint8 images in the
    ``canvas``, each image's valid extent a fixed share of it (the same
    shares for every seed), Poisson box counts, on ``device``."""
    gen = generator(seed, device)
    B, n_batch, G = traffic["micro_batch"], traffic["batches"], traffic["max_gt"]
    H, W = traffic["canvas"]
    n = B * n_batch
    lo = traffic["min_extent_share"]
    shares = [lo + (1 - lo) * i / max(n - 1, 1) for i in range(n)]
    order_h = torch.randperm(n, generator=torch.Generator().manual_seed(seed & 0xFFFFFFFF))
    order_w = torch.randperm(n, generator=torch.Generator().manual_seed((seed + 1) & 0xFFFFFFFF))
    hs = [int(H * shares[i]) // 2 * 2 for i in order_h.tolist()]
    ws = [int(W * shares[i]) // 2 * 2 for i in order_w.tolist()]
    per_image = counts(n, traffic["boxes_per_image_mean"], G, seed)
    out = []
    for bi in range(n_batch):
        img = images(B, H, W, gen, device)
        rows = range(bi * B, (bi + 1) * B)
        height = torch.tensor([hs[r] for r in rows], dtype=torch.int32, device=device)
        width = torch.tensor([ws[r] for r in rows], dtype=torch.int32, device=device)
        inside = ((torch.arange(H, device=device)[None, :, None] < height[:, None, None])
                  & (torch.arange(W, device=device)[None, None, :] < width[:, None, None]))
        img = torch.where(inside[..., None], img, torch.zeros((), dtype=torch.uint8,
                                                              device=device))
        cls = torch.zeros(B, G, dtype=torch.int32, device=device)
        bxs = torch.zeros(B, G, 4, dtype=torch.float32, device=device)
        valid = torch.zeros(B, G, dtype=torch.bool, device=device)
        for b, r in enumerate(rows):
            k = per_image[r]
            bxs[b, :k] = boxes(k, gen, device)
            cls[b, :k] = torch.randint(0, num_classes, (k,), generator=gen, device=device,
                                       dtype=torch.int32)
            valid[b, :k] = True
        out.append({"image": img, "height": height, "width": width, "class_idx": cls,
                    "boxes_normalized": bxs, "gt_valid": valid,
                    "image_valid": torch.ones(B, dtype=torch.bool, device=device)})
    return out


def serve_pool(traffic: dict, seed: int, device) -> list[np.ndarray]:
    """``traffic["pool"]`` uint8 images at the traffic's source sizes."""
    gen = generator(seed, device)
    sizes = [tuple(traffic["source_sizes"][i % len(traffic["source_sizes"])])
             for i in range(traffic["pool"])]
    pool: list = [None] * len(sizes)
    for size in sorted(set(sizes)):
        idx = [i for i, s in enumerate(sizes) if s == size]
        pix = images(len(idx), size[0], size[1], gen, device).cpu().numpy()
        for j, i in enumerate(idx):
            pool[i] = pix[j]
    return pool
