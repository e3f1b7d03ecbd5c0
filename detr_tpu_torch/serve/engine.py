"""Inference engine: images in, detections out (counterpart of
``detr_tpu/serve/engine.py``).

Incoming images are sized by the val transform (shortest side 800 / longest
1333), grouped into the aspect-ratio buckets, and run in static batches of
``batch_size``: a short batch is padded with its last image and the padded
rows are dropped on return.  Only the last decoder layer is decoded, by the
model's class head (``models.class_head``): DETR's one detection per query,
or Deformable DETR's top-k (query, class) pairs.  The forward runs on the
card, every attention through the hand-written kernel; ``device="cpu"``
runs the plain PyTorch path instead.

Requests reach the card on one of two wires, never mixed in one batch:

  * the source wire, for every uint8 HWC3 request (a PIL RGB image through
    ``np.asarray`` is one).  The host computes only the target size and the
    bucket, and pads the batch's sources, untouched, into one uint8 canvas
    (each side of the largest rounded up to /32).  On the card
    ``resample_sources`` resizes each to its target size, rounds to uint8
    levels as the host's resize does, and normalises into the bucket canvas;
  * the host wire, for any other request (float pixels on the 0-255
    scale): the val transform resizes and normalises on the host into a
    float32 bucket canvas.

Spans (``utils.profiling``): ``serve.predict`` per call, within it
``serve.transform`` per image (the target size and the bucket; on the host
wire also the resize and normalisation) and ``serve.assemble`` per device
batch (the canvas and the copies into it), and in ``_predict`` ``serve.h2d``
(the copies to the card), ``serve.resize`` (the source wire's resample and
normalisation), ``serve.forward`` and ``serve.readback`` (postprocess and the
copy back).  Counters: ``serve.images``, ``serve.padded_rows``,
``serve.batches`` and ``serve.device_resized`` (the images of source-wire
batches) per device batch of ``predict``, ``serve.h2d_bytes`` per
``_predict``.

Left open: pinned staging buffers for the copies, a CUDA graph per bucket
for the forward's dispatch, and resampling one image at a time for sources
far larger than COCO's (the batched resample's transient memory grows with
the largest source).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.data.bucketing import (EVAL_BUCKETS, fit_to_bucket, fit_to_bucket_source,
                                           pick_bucket)
from detr_tpu_torch.data.transforms import ValTransform
from detr_tpu_torch.eval.postprocess import postprocess_predictions
from detr_tpu_torch.models import DETR, build_detector, class_head
from detr_tpu_torch.models.convert import state_dict_from_jax
from detr_tpu_torch.ops.device_resize import resize_on_device
from detr_tpu_torch.ops.image_norm import device_normalize_image
from detr_tpu_torch.utils import profiling

_SOURCE_ALIGN = 32  # the source canvas's sides are rounded up to this


class InferenceEngine:
    """Single-device serving executor of the model ``build_detector(config)``
    builds: DETR, or Deformable DETR for a ``DeformableDETRConfig``.

    Args:
      config: model hyperparameters (must match the weights).
      variables: the JAX package's ``{"params", "frozen"}`` trees as numpy
        (DETR only: the JAX package has no Deformable DETR); omit both this
        and ``checkpoint_dir`` to random-init from seed 0 by the model's
        init rules (testing).
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
        # the source wire's: the same target size, and the pixels untouched
        self.source_transform = ValTransform(min_size=min_size, max_size=max_size,
                                             emit_source=True)

        self.model = build_detector(config)
        self.head = class_head(config)
        if checkpoint_dir is not None:
            from detr_tpu_torch.train.checkpoint import CheckpointManager, load_model_payload

            load_model_payload(self.model, CheckpointManager(checkpoint_dir).restore_payload())
        elif variables is None:
            self.model.reset_parameters(torch.Generator().manual_seed(0))
        elif not isinstance(self.model, DETR):
            raise ValueError("variables are the JAX package's DETR weights; it has no "
                             f"{type(self.model).__name__}")
        else:
            sd = state_dict_from_jax(variables["params"], variables["frozen"], config)
            self.model.load_state_dict(sd, strict=True)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def _predict(self, images, heights, widths, orig_h, orig_w,
                 canvas: Optional[tuple[int, int]] = None) -> dict[str, np.ndarray]:
        """One device batch: the extents are the target (heights, widths) and
        the original (orig_h, orig_w) sizes.  Without ``canvas``, ``images``
        is the normalised float32 bucket canvas; with it, the uint8 source
        canvas, each image at its original size, resampled on the card into
        a ``canvas``-sized batch (``resample_sources``)."""
        dev = self.device
        arrays = (images, heights, widths, orig_h, orig_w)
        profiling.count("serve.h2d_bytes", sum(a.nbytes for a in arrays))
        with profiling.span("serve.h2d"):
            x, h, w, oh, ow = (torch.from_numpy(a).to(dev) for a in arrays)
        if canvas is not None:
            with profiling.span("serve.resize"):
                x = resample_sources(x, oh, ow, h, w, canvas)  # frees the source
        with profiling.span("serve.forward"):
            out = self.model(x, h, w)
        with profiling.span("serve.readback"):
            det = postprocess_predictions(  # last decoder layer only
                out["pred_logits"][:, -1], out["pred_boxes"][:, -1], oh, ow, self.head)
            return {k: v.cpu().numpy() for k, v in det.items()}

    def warmup(self) -> None:
        """Run every (bucket x batch) shape once ahead of traffic, on the
        source wire: the resample's fp32 products and the forward (builds
        the kernels and fills the allocator's cache).  The host wire runs
        the same forwards."""
        for h, w in self.buckets:
            src = np.zeros((self.batch_size, h, w, 3), np.uint8)
            ext = np.full((self.batch_size,), h, np.int32)
            wid = np.full((self.batch_size,), w, np.int32)
            self._predict(src, ext, wid, ext, wid, (h, w))

    def predict(self, images: Sequence) -> list[dict]:
        """Detect objects in each image (ndarray HWC uint8/float or PIL).

        Returns one dict per input, in input order: {scores (N,), labels (N,),
        boxes (N, 4) XYXY in ORIGINAL pixel coords, class_names (N,) when the
        engine has labels}.
        """
        with profiling.span("serve.predict"):
            return self._predict_images(images)

    def _predict_images(self, images: Sequence) -> list[dict]:
        prepped = []  # (orig_idx, (bucket_id, source wire), pixels, target size, orig size)
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
            source = arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3
            with profiling.span("serve.transform"):
                if source:
                    _, t = self.source_transform(arr, _empty_target())
                    bucket_id = pick_bucket(*t["resize_to"], self.buckets)
                    # the source is its own canvas: only the target size shrinks
                    _, t = fit_to_bucket_source(arr, t, self.buckets[bucket_id], (oh, ow))
                    size = t["resize_to"]
                else:
                    arr, _ = self.transform(arr, _empty_target())
                    bucket_id = pick_bucket(arr.shape[0], arr.shape[1], self.buckets)
                    arr, _ = fit_to_bucket(arr, _empty_target(), self.buckets[bucket_id])
                    size = arr.shape[:2]
            prepped.append((idx, (bucket_id, source), arr, size, (oh, ow)))

        results: list[Optional[dict]] = [None] * len(images)
        groups: dict[tuple[int, bool], list] = {}
        for item in prepped:
            groups.setdefault(item[1], []).append(item)

        for (bucket_id, source), items in groups.items():
            bucket = self.buckets[bucket_id]
            for start in range(0, len(items), self.batch_size):
                chunk = items[start : start + self.batch_size]
                n = len(chunk)
                chunk = chunk + [chunk[-1]] * (self.batch_size - n)
                _, _, pixels, sizes, origs = zip(*chunk)
                with profiling.span("serve.assemble"):
                    if source:
                        batch = _assemble(pixels, sizes, origs, _source_canvas(pixels), np.uint8)
                    else:
                        batch = _assemble(pixels, sizes, origs, bucket, np.float32)
                profiling.count("serve.images", n)
                profiling.count("serve.padded_rows", self.batch_size - n)
                profiling.count("serve.batches")
                if source:
                    profiling.count("serve.device_resized", n)
                    out = self._predict(*batch, bucket)
                else:
                    out = self._predict(*batch)
                scores, labels, boxes = (out[k][:n] for k in ("scores", "labels", "boxes"))
                for b, (idx, *_) in enumerate(chunk[:n]):
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


def resample_sources(sources: torch.Tensor, src_h: torch.Tensor, src_w: torch.Tensor,
                     dst_h: torch.Tensor, dst_w: torch.Tensor,
                     canvas: tuple[int, int]) -> torch.Tensor:
    """The source wire's model input: (B, SH, SW, 3) uint8 sources, each
    resampled from its (src_h, src_w) extent to its (dst_h, dst_w) extent in
    a (B, *canvas, 3) batch (``ops.device_resize``: true fp32, antialiased,
    PIL's pixel centres), rounded half up to uint8 levels as the host's
    resize rounds (``floor(x + 0.5)`` in [0, 255]), then normalised with the
    host's folded constants, exactly 0.0 outside each image
    (``ops.image_norm``).  Of the resample's tensors only the returned fp32
    canvas outlives the call."""
    x = resize_on_device(sources, src_h, src_w, dst_h, dst_w, canvas)
    levels = x.add_(0.5).floor_().clamp_(0.0, 255.0).to(
        torch.uint8, memory_format=torch.contiguous_format)
    del x
    return device_normalize_image(levels, dst_h, dst_w)


def _source_canvas(sources: Sequence[np.ndarray]) -> tuple[int, int]:
    """The uint8 canvas of one source-wire batch: it holds the largest
    source whole, each side rounded up to /32."""
    return tuple(-(-max(s.shape[i] for s in sources) // _SOURCE_ALIGN) * _SOURCE_ALIGN
                 for i in (0, 1))


def _assemble(pixels, sizes, origs, canvas: tuple[int, int], dtype):
    """One device batch: ``pixels`` padded with zeros into a (B, *canvas, 3)
    array of ``dtype``, and the target and original (height, width) as
    int32 arrays."""
    images = np.zeros((len(pixels), *canvas, 3), dtype)
    for b, p in enumerate(pixels):
        images[b, : p.shape[0], : p.shape[1]] = p
    hs, ws, ohs, ows = (np.array(v, np.int32) for v in (*zip(*sizes), *zip(*origs)))
    return images, hs, ws, ohs, ows


def _empty_target() -> dict:
    return {
        "boxes": np.zeros((0, 4), np.float32),
        "class_idx": np.zeros((0,), np.int32),
        "class_id": np.zeros((0,), np.int32),
        "iscrowd": np.zeros((0,), bool),
    }
