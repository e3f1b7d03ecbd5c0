"""COCO-format dataset: JSON parsing and image loading on the host
(counterpart of ``detr_tpu/data/coco.py``).

The layout is ``<root>/<split>/data/*.jpg`` and ``<root>/<split>/labels.json``
(images, annotations, categories).  Class ids map to contiguous indices in
the categories' order.  ``__getitem__`` returns ``(PIL.Image, target)``,
target holding numpy arrays: boxes (N, 4) XYXY float32, class_idx (N,)
int64, class_id (N,) int64, iscrowd (N,) bool, and image_id; the transforms
(``data.transforms``) take and update them.  An image without annotations
gives empty arrays.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
from PIL import Image


class CocoDataset:
    def __init__(
        self,
        dataset_root: str,
        split: str = "train",
        transform: Optional[Callable] = None,
    ):
        if split not in ("train", "validation"):
            raise ValueError(f"split must be 'train' or 'validation', got {split!r}")
        self.root = os.path.join(dataset_root, split, "data")
        with open(os.path.join(dataset_root, split, "labels.json")) as f:
            coco = json.load(f)

        self.transform = transform

        cats = {c["id"]: c for c in coco.get("categories", [])}
        self.class_id2name = {cid: c["name"] for cid, c in cats.items()}
        self.class_id2idx = {cid: idx for idx, cid in enumerate(cats.keys())}
        self.class_idx2id = {idx: cid for cid, idx in self.class_id2idx.items()}
        self.class_names = [c["name"] for c in cats.values()]

        self.images = sorted(coco.get("images", []), key=lambda im: im["id"])
        self._by_image: dict[int, list] = {im["id"]: [] for im in self.images}
        for ann in coco.get("annotations", []):
            if ann["image_id"] in self._by_image:
                self._by_image[ann["image_id"]].append(ann)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def set_worker_seed(self, worker_seed: int) -> None:
        """Give the transform a generator of its own in a loader worker:
        every worker unpickles the same transform, and would otherwise
        replay the same augmentation."""
        t = self.transform
        if t is not None and hasattr(t, "rng"):
            t.rng = np.random.default_rng([worker_seed & 0x7FFFFFFF, 0xDE7])

    def __len__(self) -> int:
        return len(self.images)

    def load_image(self, idx: int) -> Image.Image:
        info = self.images[idx]
        return Image.open(os.path.join(self.root, info["file_name"])).convert("RGB")

    def raw_target(self, idx: int) -> dict:
        info = self.images[idx]
        anns = self._by_image[info["id"]]
        n = len(anns)
        boxes = np.zeros((n, 4), np.float32)
        class_id = np.zeros((n,), np.int64)
        iscrowd = np.zeros((n,), bool)
        for i, a in enumerate(anns):
            x, y, w, h = a["bbox"]  # COCO XYWH -> XYXY
            boxes[i] = (x, y, x + w, y + h)
            class_id[i] = a["category_id"]
            iscrowd[i] = bool(a.get("iscrowd", 0))
        class_idx = np.array([self.class_id2idx[c] for c in class_id], np.int64).reshape(n)
        return {
            "image_id": int(info["id"]),
            "boxes": boxes,
            "class_idx": class_idx,
            "class_id": class_id,
            "iscrowd": iscrowd,
        }

    def __getitem__(self, idx: int):
        img = self.load_image(idx)
        target = self.raw_target(idx)
        if self.transform is not None:
            img, target = self.transform(img, target)
        return img, target
