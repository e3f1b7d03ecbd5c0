"""COCO mAP evaluator (counterpart of ``detr_tpu/eval/coco_eval.py``).

The COCOeval protocol, as the JAX package re-implements it:

  * 10 IoU thresholds 0.50:0.05:0.95; AP50/AP75 slices;
  * 101-point interpolated precision sampled at recall 0:0.01:1;
  * area ranges all / small(<32^2) / medium(32^2..96^2) / large(>96^2),
    from box area;
  * maxDets=100 per image per class, score-descending;
  * crowd GTs are ignore-GTs whose IoU divides by the detection's own area;
    a detection may match one without counting as TP or FP;
  * greedy per-detection matching in score order: the best IoU >= t among
    unmatched GTs, real GTs before ignored ones;
  * unmatched detections outside the area range are ignored, not FPs;
  * classes with zero GT are left out of the mean (precision = -1).

``compute`` takes the batched native path where ``_native``
(``native/cocoeval.cc``, built on first use) loads: per class, one
``iou_blocks`` and one ``evaluate_blocks`` call cover every image, IoU
threshold and area range, over a label-major layout of all detections and
GTs (``_prepare_batched``).  A class with an image of 4096 or more GTs, or a
host without a C++ toolchain, takes the per-(image, class, area range) path,
whose greedy matching runs in the native ``match_detections`` or, without
it, in the Python loop.  Every path gives the same numbers.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from detr_tpu_torch.eval import _native

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05).round(2)  # 10 values
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = 100


def _box_area(boxes: np.ndarray) -> np.ndarray:
    return np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(
        boxes[:, 3] - boxes[:, 1], 0, None
    )


def _iou_matrix(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU; crowd GT columns use the detection's area as the
    denominator."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), np.float64)
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = _box_area(dets)[:, None]
    area_g = _box_area(gts)[None, :]
    union = np.where(iscrowd[None, :], area_d, area_d + area_g - inter)
    return inter / np.maximum(union, 1e-12)


@dataclass
class _ImageEval:
    """Per-(image, class) match bookkeeping across IoU thresholds."""

    det_scores: np.ndarray  # (D,)
    det_matched_ignore: np.ndarray  # (T, D) bool: matched to an ignored GT
    det_matched: np.ndarray  # (T, D) bool
    det_ignore_area: np.ndarray  # (D,) bool: outside the area range
    num_gt: int  # non-ignored GT count


class CocoEvaluator:
    """Accumulates detections and ground truth; computes the COCO AP family."""

    def __init__(self, num_classes: int, class_names=None):
        self.num_classes = num_classes
        self.class_names = class_names
        self.reset()

    def reset(self):
        self._dets = defaultdict(list)  # image_id -> (boxes, scores, labels)
        self._gts = defaultdict(list)  # image_id -> (boxes, labels, iscrowd)
        self._image_ids = []
        self._group_cache: dict = {}  # image_id -> {cls: (db, ds, gb, gc)}

    def add_image(
        self,
        image_id: int,
        det_boxes: np.ndarray,
        det_scores: np.ndarray,
        det_labels: np.ndarray,
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        gt_iscrowd: np.ndarray | None = None,
    ):
        """All boxes XYXY in pixels."""
        if gt_iscrowd is None:
            gt_iscrowd = np.zeros(len(gt_boxes), bool)
        self._image_ids.append(image_id)
        self._dets[image_id] = (
            np.asarray(det_boxes, np.float64).reshape(-1, 4),
            np.asarray(det_scores, np.float64).reshape(-1),
            np.asarray(det_labels, np.int64).reshape(-1),
        )
        self._gts[image_id] = (
            np.asarray(gt_boxes, np.float64).reshape(-1, 4),
            np.asarray(gt_labels, np.int64).reshape(-1),
            np.asarray(gt_iscrowd, bool).reshape(-1),
        )
        self._group_cache.pop(image_id, None)

    # ------------------------------------------------------------- matching

    def _grouped(self, image_id) -> dict:
        """{cls: (det_boxes, det_scores, gt_boxes, gt_iscrowd)}, built once
        per image: ``compute`` visits every class of every image."""
        cache = self._group_cache.get(image_id)
        if cache is None:
            db, ds, dl = self._dets[image_id]
            gb, gl, gc = self._gts[image_id]
            cache = {}
            present = np.unique(np.concatenate([dl, gl])) if (
                len(dl) or len(gl)
            ) else ()
            for cls in present:
                dsel = dl == cls
                gsel = gl == cls
                cache[int(cls)] = (db[dsel], ds[dsel], gb[gsel], gc[gsel])
            self._group_cache[image_id] = cache
        return cache

    def _image_class_data(self, image_id, cls) -> dict | None:
        """The work that does not depend on the area range, once per (image,
        class): the score sort and maxDets cap, areas, and the IoU matrix in
        the GTs' own order (each range permutes its columns)."""
        entry = self._grouped(image_id).get(cls)
        if entry is None:
            return None
        db, ds, gb, gc = entry

        order = np.argsort(-ds, kind="mergesort")[:MAX_DETS]
        db, ds = db[order], ds[order]
        return {
            "ds": ds,
            "gc": gc,
            "ious": _iou_matrix(db, gb, gc),
            "d_area": _box_area(db),
            "g_area": _box_area(gb),
        }

    def _evaluate_image(self, data: dict, area_range) -> _ImageEval:
        """Matching at one area range on top of the (image, class) data."""
        ds, gc = data["ds"], data["gc"]
        lo, hi = area_range
        g_ignore = gc | (data["g_area"] < lo) | (data["g_area"] > hi)

        # real GTs first (pycocotools' gtind order); the IoU columns follow
        g_order = np.argsort(g_ignore, kind="mergesort")
        gc, g_ignore = gc[g_order], g_ignore[g_order]
        ious = data["ious"][:, g_order]
        T = len(IOU_THRESHOLDS)
        D, G = ious.shape

        det_matched = np.zeros((T, D), bool)
        det_matched_ignore = np.zeros((T, D), bool)
        native = _native.match_detections(ious, gc, g_ignore, IOU_THRESHOLDS) if D and G else None
        if native is not None:
            det_matched, det_matched_ignore = native
        elif D and G:
            for ti, t in enumerate(IOU_THRESHOLDS):
                gt_taken = np.zeros(G, bool)
                for d in range(D):
                    best_iou = min(t, 1 - 1e-10)
                    best_g = -1
                    for g in range(G):
                        if gt_taken[g] and not gc[g]:
                            continue  # a taken non-crowd GT cannot match again
                        # holding a real GT and the rest are ignored: stop
                        if best_g > -1 and not g_ignore[best_g] and g_ignore[g]:
                            break
                        if ious[d, g] < best_iou:
                            continue
                        best_iou = ious[d, g]
                        best_g = g
                    if best_g == -1:
                        continue
                    det_matched[ti, d] = True
                    det_matched_ignore[ti, d] = g_ignore[best_g]
                    gt_taken[best_g] = True

        d_area = data["d_area"]
        det_ignore_area = (d_area < lo) | (d_area > hi)
        return _ImageEval(
            det_scores=ds,
            det_matched_ignore=det_matched_ignore,
            det_matched=det_matched,
            det_ignore_area=det_ignore_area,
            num_gt=int((~g_ignore).sum()),
        )

    # ----------------------------------------------------------- accumulate

    @staticmethod
    def _interp_precision(
        matched: np.ndarray,
        matched_ign: np.ndarray,
        ign_area: np.ndarray,
        num_gt: int,
    ) -> np.ndarray:
        """(T, R) interpolated precision from match flags in global
        score-descending order: ``matched``/``matched_ign`` (T, D) bool,
        ``ign_area`` (D,) bool, ``num_gt`` > 0."""
        T, R = len(IOU_THRESHOLDS), len(RECALL_THRESHOLDS)
        precision = -np.ones((T, R))
        # ignored: matched to an ignored GT, or unmatched and out of range
        ignored = matched_ign | (~matched & ign_area[None, :])
        tp = matched & ~ignored
        fp = ~matched & ~ignored

        tp_cum = np.cumsum(tp, axis=1).astype(np.float64)
        fp_cum = np.cumsum(fp, axis=1).astype(np.float64)
        for ti in range(T):
            rc = tp_cum[ti] / num_gt
            pr = tp_cum[ti] / np.maximum(tp_cum[ti] + fp_cum[ti], 1e-12)
            # monotone non-increasing from the right: pycocotools' backward loop
            pr = np.maximum.accumulate(pr[::-1])[::-1]
            # sample at the 101 recall points (first index where rc >= r)
            idx = np.searchsorted(rc, RECALL_THRESHOLDS, side="left")
            prec = np.zeros(R)
            valid = idx < len(pr)
            prec[valid] = pr[idx[valid]]
            precision[ti] = prec
        return precision

    def _precision_for(self, class_data: list, area_range) -> np.ndarray:
        """(T, R) interpolated precision, or -1 where the class has no GT."""
        evals = [self._evaluate_image(d, area_range) for d in class_data]
        T, R = len(IOU_THRESHOLDS), len(RECALL_THRESHOLDS)
        precision = -np.ones((T, R))
        if not evals:
            return precision
        num_gt = sum(e.num_gt for e in evals)
        if num_gt == 0:
            return precision

        scores = np.concatenate([e.det_scores for e in evals])
        order = np.argsort(-scores, kind="mergesort")
        matched = np.concatenate([e.det_matched for e in evals], axis=1)[:, order]
        matched_ign = np.concatenate(
            [e.det_matched_ignore for e in evals], axis=1
        )[:, order]
        ign_area = np.concatenate([e.det_ignore_area for e in evals])[order]
        return self._interp_precision(matched, matched_ign, ign_area, num_gt)

    # ------------------------------------------------- batched native path

    def _prepare_batched(self) -> dict:
        """The label-major layout of the batched kernel: every detection and
        GT row of every image, sorted stably by (label, image, -score) and
        (label, image).  Each class is then one contiguous slice, made of
        per-image blocks with the detections in score order, as
        ``evaluate_blocks`` reads them."""
        db_l, ds_l, dl_l, di_l = [], [], [], []
        gb_l, gl_l, gc_l, gi_l = [], [], [], []
        for i, img in enumerate(self._image_ids):
            db, ds, dl = self._dets[img]
            gb, gl, gc = self._gts[img]
            if len(ds):
                db_l.append(db); ds_l.append(ds); dl_l.append(dl)
                di_l.append(np.full(len(ds), i, np.int64))
            if len(gl):
                gb_l.append(gb); gl_l.append(gl); gc_l.append(gc)
                gi_l.append(np.full(len(gl), i, np.int64))

        def cat(parts, dtype, width=None):
            if not parts:
                return np.zeros((0, width) if width else (0,), dtype)
            return np.concatenate(parts).astype(dtype, copy=False)

        db, ds, dl, di = (cat(db_l, np.float64, 4), cat(ds_l, np.float64),
                          cat(dl_l, np.int64), cat(di_l, np.int64))
        gb, gl, gc, gi = (cat(gb_l, np.float64, 4), cat(gl_l, np.int64), cat(gc_l, bool),
                          cat(gi_l, np.int64))
        # lexsort's last key is the primary one.  Stable: ties in score keep
        # the order of insertion, as the per-image argsort(-ds, mergesort).
        dorder = np.lexsort((-ds, di, dl))
        gorder = np.lexsort((gi, gl))
        return {
            "db": db[dorder], "ds": ds[dorder], "dl": dl[dorder], "di": di[dorder],
            "gb": gb[gorder], "gl": gl[gorder], "gc": gc[gorder], "gi": gi[gorder],
        }

    def _class_precisions_batched(self, prep: dict, cls: int) -> dict | None:
        """{range name: (T, R) precision} of one class through the batched
        kernel, or None for the per-image path (an image of 4096 or more GTs)."""
        d_lo, d_hi = np.searchsorted(prep["dl"], [cls, cls + 1])
        g_lo, g_hi = np.searchsorted(prep["gl"], [cls, cls + 1])
        db, ds, di = prep["db"][d_lo:d_hi], prep["ds"][d_lo:d_hi], prep["di"][d_lo:d_hi]
        gb, gc, gi = prep["gb"][g_lo:g_hi], prep["gc"][g_lo:g_hi], prep["gi"][g_lo:g_hi]

        T, R = len(IOU_THRESHOLDS), len(RECALL_THRESHOLDS)
        neg = -np.ones((T, R))
        if len(gb) == 0:  # no GT of the class anywhere: every range is left out
            return {name: neg for name in AREA_RANGES}

        # One block per image that holds the class, detections or GTs (both
        # slices are sorted by image, so the blocks are contiguous).
        present = np.union1d(np.unique(di), np.unique(gi))
        d_off = np.append(np.searchsorted(di, present, side="left"), len(di)).astype(np.int64)
        g_off = np.append(np.searchsorted(gi, present, side="left"), len(gi)).astype(np.int64)
        d_sizes = np.diff(d_off)

        # maxDets per (image, class); each block is already in score order
        if len(d_sizes) and d_sizes.max() > MAX_DETS:
            rank = np.arange(len(di)) - np.repeat(d_off[:-1], d_sizes)
            keep = rank < MAX_DETS
            db, ds, di = db[keep], ds[keep], di[keep]
            d_sizes = np.minimum(d_sizes, MAX_DETS)
            d_off = np.concatenate([[0], np.cumsum(d_sizes)]).astype(np.int64)

        g_sizes = np.diff(g_off)
        ious = _native.iou_blocks(db, gb, gc, d_off, g_off)
        if ious is None:
            return None
        iou_off = np.concatenate([[0], np.cumsum(d_sizes * g_sizes)]).astype(np.int64)
        lo = np.array([r[0] for r in AREA_RANGES.values()], np.float64)
        hi = np.array([r[1] for r in AREA_RANGES.values()], np.float64)
        res = _native.evaluate_blocks(ious, iou_off, d_off, g_off, gc, _box_area(gb),
                                      _box_area(db), IOU_THRESHOLDS, lo, hi)
        if res is None:
            return None
        matched, matched_ign, ignore_area, num_gt = res

        order = np.argsort(-ds, kind="mergesort")
        out = {}
        for r, name in enumerate(AREA_RANGES):
            if num_gt[r] == 0:
                out[name] = neg
                continue
            out[name] = self._interp_precision(matched[r][:, order], matched_ign[r][:, order],
                                               ignore_area[r][order], int(num_gt[r]))
        return out

    # -------------------------------------------------------------- compute

    def compute(self) -> dict[str, float]:
        per_class_all = np.full(self.num_classes, -1.0)
        stats = {k: [] for k in AREA_RANGES}
        ap50, ap75 = [], []
        prep = self._prepare_batched() if _native.load() is not None else None
        for cls in range(self.num_classes):
            precisions = None if prep is None else self._class_precisions_batched(prep, cls)
            if precisions is None:  # no toolchain, or an image of >= 4096 GTs
                class_data = [
                    d
                    for img in self._image_ids
                    if (d := self._image_class_data(img, cls)) is not None
                ]
                precisions = {name: self._precision_for(class_data, rng)
                              for name, rng in AREA_RANGES.items()}
            for range_name in AREA_RANGES:
                p = precisions[range_name]
                valid = p > -1
                ap = p[valid].mean() if valid.any() else -1.0
                if range_name == "all":
                    per_class_all[cls] = ap
                    if valid.any():
                        ap50.append(p[0][p[0] > -1].mean())
                        ap75.append(p[5][p[5] > -1].mean())
                if ap > -1:
                    stats[range_name].append(ap)

        def mean_or_neg(vals):
            return float(np.mean(vals)) if len(vals) else -1.0

        return {
            "AP": mean_or_neg(stats["all"]),
            "AP50": mean_or_neg(ap50),
            "AP75": mean_or_neg(ap75),
            "AP-small": mean_or_neg(stats["small"]),
            "AP-medium": mean_or_neg(stats["medium"]),
            "AP-large": mean_or_neg(stats["large"]),
            "per_class": per_class_all,
        }
