"""Inference engine: images in, detections out (counterpart of
``detr_tpu/serve/engine.py``).

Incoming images are val-transformed (shortest side 800 / longest 1333),
grouped into the aspect-ratio buckets, and run in static batches of
``batch_size``: a short batch is padded with its last image and the padded
rows are dropped on return.  Only the last decoder layer is decoded.  The
forward runs on the card, every attention through the hand-written kernel;
``device="cpu"`` runs the plain PyTorch path instead.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.data.bucketing import EVAL_BUCKETS, fit_to_bucket, pick_bucket
from detr_tpu_torch.data.transforms import ValTransform
from detr_tpu_torch.eval.postprocess import postprocess_predictions
from detr_tpu_torch.models.convert import state_dict_from_jax
from detr_tpu_torch.models.detr import DETR


class InferenceEngine:
    """Single-device DETR serving executor.

    Args:
      config: model hyperparameters (must match the weights).
      variables: the JAX package's ``{"params", "frozen"}`` trees as numpy;
        omit both this and ``checkpoint_dir`` to random-init from seed 0 by
        the JAX init rules (testing).
      checkpoint_dir: a trainer's output dir: the parameters and frozen
        statistics of its newest checkpoint (``train.checkpoint``); raises
        ``FileNotFoundError`` when it holds none.  Not with ``variables``.
      class_names: index -> label strings for the response dicts.
      batch_size: device batch per bucket (requests are padded up to this).
      buckets: (H, W) batch shapes; defaults to the eval buckets.
      score_threshold: detections below this confidence are dropped.
      device: torch device; None means the CUDA card, and raises without one.
    """

    def __init__(
        self,
        config: DETRConfig,
        variables: Optional[dict] = None,
        checkpoint_dir: Optional[str] = None,
        class_names: Optional[Sequence[str]] = None,
        batch_size: int = 8,
        buckets: Sequence[tuple[int, int]] = EVAL_BUCKETS,
        score_threshold: float = 0.0,
        min_size: int = 800,
        max_size: int = 1333,
        device: Optional[str] = None,
    ):
        if variables is not None and checkpoint_dir is not None:
            raise ValueError("pass either variables or checkpoint_dir, not both")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "InferenceEngine needs a CUDA device; pass device='cpu' for the "
                    "plain PyTorch path"
                )
            device = "cuda"
        self.device = torch.device(device)
        self.config = config
        self.batch_size = int(batch_size)
        self.buckets = tuple(tuple(b) for b in buckets)
        self.score_threshold = float(score_threshold)
        self.class_names = list(class_names) if class_names is not None else None
        self.transform = ValTransform(min_size=min_size, max_size=max_size)

        self.model = DETR(config)
        if checkpoint_dir is not None:
            from detr_tpu_torch.train.checkpoint import CheckpointManager, load_model_payload

            load_model_payload(self.model, CheckpointManager(checkpoint_dir).restore_payload())
        elif variables is None:
            self.model.reset_parameters(torch.Generator().manual_seed(0))
        else:
            sd = state_dict_from_jax(variables["params"], variables["frozen"], config)
            self.model.load_state_dict(sd, strict=True)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def _predict(self, images, heights, widths, orig_h, orig_w) -> dict[str, np.ndarray]:
        dev = self.device
        out = self.model(
            torch.from_numpy(images).to(dev),
            torch.from_numpy(heights).to(dev),
            torch.from_numpy(widths).to(dev),
        )
        det = postprocess_predictions(  # last decoder layer only
            out["pred_logits"][:, -1],
            out["pred_boxes"][:, -1],
            torch.from_numpy(orig_h).to(dev),
            torch.from_numpy(orig_w).to(dev),
        )
        return {k: v.cpu().numpy() for k, v in det.items()}

    def warmup(self) -> None:
        """Run every (bucket x batch) shape once ahead of traffic (builds the
        kernels and fills the allocator's cache)."""
        for h, w in self.buckets:
            imgs = np.zeros((self.batch_size, h, w, 3), np.float32)
            ext = np.full((self.batch_size,), h, np.int32)
            wid = np.full((self.batch_size,), w, np.int32)
            self._predict(imgs, ext, wid, ext, wid)

    def predict(self, images: Sequence) -> list[dict]:
        """Detect objects in each image (ndarray HWC uint8/float or PIL).

        Returns one dict per input, in input order: {scores (N,), labels (N,),
        boxes (N, 4) XYXY in ORIGINAL pixel coords, class_names (N,) when the
        engine has labels}.
        """
        prepped = []  # (orig_idx, bucket_id, img, oh, ow)
        for idx, img in enumerate(images):
            arr = np.asarray(img)
            if arr.dtype.kind == "f" and arr.size:
                # Normalize assumes the 0-255 scale: a [0, 1] float image would
                # come out near -2 everywhere and give confident nonsense.  An
                # all-zero frame is the same on both scales, and a dark 0-255
                # frame (max in (1, 255]) is a legitimate request.
                mx = float(arr.max())
                if 0.0 < mx <= 1.0:
                    raise ValueError(
                        "float images must be on the 0-255 scale (got max "
                        f"{mx:.3f}); multiply by 255 or pass uint8"
                    )
            oh, ow = arr.shape[:2]
            timg, _ = self.transform(arr, _empty_target())
            bucket_id = pick_bucket(timg.shape[0], timg.shape[1], self.buckets)
            timg, _ = fit_to_bucket(timg, _empty_target(), self.buckets[bucket_id])
            prepped.append((idx, bucket_id, timg, oh, ow))

        results: list[Optional[dict]] = [None] * len(images)
        by_bucket: dict[int, list] = {}
        for item in prepped:
            by_bucket.setdefault(item[1], []).append(item)

        for bucket_id, items in by_bucket.items():
            bh, bw = self.buckets[bucket_id]
            for start in range(0, len(items), self.batch_size):
                chunk = items[start : start + self.batch_size]
                n = len(chunk)
                chunk = chunk + [chunk[-1]] * (self.batch_size - n)
                imgs = np.zeros((self.batch_size, bh, bw, 3), np.float32)
                hs = np.zeros((self.batch_size,), np.int32)
                ws = np.zeros((self.batch_size,), np.int32)
                ohs = np.zeros((self.batch_size,), np.int32)
                ows = np.zeros((self.batch_size,), np.int32)
                for b, (_, _, timg, oh, ow) in enumerate(chunk):
                    th, tw = timg.shape[:2]
                    imgs[b, :th, :tw] = timg
                    hs[b], ws[b] = th, tw
                    ohs[b], ows[b] = oh, ow
                out = self._predict(imgs, hs, ws, ohs, ows)
                scores, labels, boxes = (out[k][:n] for k in ("scores", "labels", "boxes"))
                for b, (idx, _, _, _, _) in enumerate(chunk[:n]):
                    keep = scores[b] >= self.score_threshold
                    det = {
                        "scores": scores[b][keep],
                        "labels": labels[b][keep],
                        "boxes": boxes[b][keep],
                    }
                    if self.class_names is not None:
                        det["class_names"] = [self.class_names[i] for i in det["labels"]]
                    results[idx] = det
        return results  # type: ignore[return-value]


def _empty_target() -> dict:
    return {
        "boxes": np.zeros((0, 4), np.float32),
        "class_idx": np.zeros((0,), np.int32),
        "class_id": np.zeros((0,), np.int32),
        "iscrowd": np.zeros((0,), bool),
    }
