"""DetectionMetrics: per-image predictions and a batch's ground truth into
the COCO AP family (counterpart of ``detr_tpu/eval/metrics.py``).

``update(preds, batch)`` / ``compute()`` / ``reset()``; the keys AP, AP50,
AP75, AP-large, AP-medium, AP-small and "AP-per-class/<name>", as the
reference's torchmetrics wrapper gives them.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from detr_tpu_torch.eval.coco_eval import CocoEvaluator


class DetectionMetrics:
    def __init__(self, class_names: Sequence[str]):
        self.class_names = list(class_names)
        self.evaluator = CocoEvaluator(len(self.class_names), self.class_names)
        self._n_auto = 0

    def update(self, preds: List[dict], batch: dict) -> None:
        """preds: per-image dicts {boxes XYXY, scores, labels} (``PostProcess``
        output); batch: the loader's host arrays boxes / class_idx / iscrowd /
        gt_valid / image_id.  The last ``pad_count`` items are the loader's
        padding and are skipped."""
        B = len(preds)
        pad = int(batch.get("pad_count", 0))
        for i in range(B - pad):
            valid = np.asarray(batch["gt_valid"][i])
            image_id = int(np.asarray(batch["image_id"][i]))
            if image_id < 0:
                # -1: the item carried no dataset id.  Such images get ids of
                # their own below -1, where no dataset id can be.
                self._n_auto += 1
                image_id = -self._n_auto - 1
            self.evaluator.add_image(
                image_id=image_id,
                det_boxes=np.asarray(preds[i]["boxes"]),
                det_scores=np.asarray(preds[i]["scores"]),
                det_labels=np.asarray(preds[i]["labels"]),
                gt_boxes=np.asarray(batch["boxes"][i])[valid],
                gt_labels=np.asarray(batch["class_idx"][i])[valid],
                gt_iscrowd=np.asarray(batch["iscrowd"][i])[valid],
            )

    def compute(self) -> dict:
        out = self.evaluator.compute()
        metrics = {k: out[k] for k in ("AP", "AP50", "AP75", "AP-large", "AP-medium", "AP-small")}
        for name, ap in zip(self.class_names, out["per_class"]):
            # a class never seen gets 0, as the reference's zero-filled tensor
            metrics[f"AP-per-class/{name}"] = float(ap) if ap > -1 else 0.0
        return metrics

    def reset(self) -> None:
        self.evaluator.reset()
        self._n_auto = 0
