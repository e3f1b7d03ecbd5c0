"""ctypes loader of the COCO-eval kernels (``detr_tpu_torch/native/cocoeval.cc``;
counterpart of ``detr_tpu/eval/_native.py``).

The build, its cache and its concurrency live in
``detr_tpu_torch.utils.native_build``.  ``load()`` is None when no C++
toolchain builds the source, and every wrapper then returns None: the
evaluator takes its numpy path.  ``load()`` keeps its result in the module
globals ``_lib`` and ``_tried``, so a test selects the numpy path by setting
``_tried = True`` and ``_lib = None``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from detr_tpu_torch.utils.native_build import NativeLib

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
                    "cocoeval.cc")


def _bind(lib: ctypes.CDLL) -> None:
    c_d = ctypes.POINTER(ctypes.c_double)
    c_u8 = ctypes.POINTER(ctypes.c_uint8)
    c_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.iou_matrix.argtypes = [c_d, ctypes.c_int, c_d, ctypes.c_int, c_u8, c_d]
    lib.iou_matrix.restype = None
    lib.match_detections.argtypes = [
        c_d, ctypes.c_int, ctypes.c_int, c_u8, c_u8, c_d, ctypes.c_int, c_u8, c_u8,
    ]
    lib.match_detections.restype = None
    lib.iou_blocks.argtypes = [
        c_d, c_d, c_u8, c_i64, c_i64, ctypes.c_int, c_d,
    ]
    lib.iou_blocks.restype = None
    lib.evaluate_blocks.argtypes = [
        c_d, c_i64, c_i64, c_i64, ctypes.c_int,
        c_u8, c_d, c_d, c_d, ctypes.c_int,
        c_d, c_d, ctypes.c_int,
        c_u8, c_u8, c_u8, c_i64,
    ]
    lib.evaluate_blocks.restype = ctypes.c_int


_native_lib = NativeLib(_SRC, ([],), _bind)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib  # module global: tests monkeypatch it to force fallbacks
    _tried = True
    _lib = _native_lib.load()
    return _lib


def built_flags() -> Optional[str]:
    """The compiler and flags the loaded library was built with."""
    return _native_lib.built_flags


def _ptr_d(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ptr_u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def iou_matrix(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    dets = np.ascontiguousarray(dets, np.float64)
    gts = np.ascontiguousarray(gts, np.float64)
    crowd = np.ascontiguousarray(iscrowd, np.uint8)
    out = np.zeros((len(dets), len(gts)), np.float64)
    lib.iou_matrix(_ptr_d(dets), len(dets), _ptr_d(gts), len(gts), _ptr_u8(crowd), _ptr_d(out))
    return out


def _ptr_i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def iou_blocks(
    dets: np.ndarray,
    gts: np.ndarray,
    iscrowd: np.ndarray,
    d_off: np.ndarray,
    g_off: np.ndarray,
) -> Optional[np.ndarray]:
    """Per-image IoU blocks, back to back (image-major).  ``d_off``/``g_off``
    are (n_img+1,) int64 prefix offsets into the concatenated det/GT rows."""
    lib = load()
    if lib is None:
        return None
    dets = np.ascontiguousarray(dets, np.float64)
    gts = np.ascontiguousarray(gts, np.float64)
    crowd = np.ascontiguousarray(iscrowd, np.uint8)
    d_off = np.ascontiguousarray(d_off, np.int64)
    g_off = np.ascontiguousarray(g_off, np.int64)
    n_img = len(d_off) - 1
    d_sizes = np.diff(d_off)
    g_sizes = np.diff(g_off)
    out = np.zeros(int((d_sizes * g_sizes).sum()), np.float64)
    lib.iou_blocks(
        _ptr_d(dets), _ptr_d(gts), _ptr_u8(crowd),
        _ptr_i64(d_off), _ptr_i64(g_off), n_img, _ptr_d(out),
    )
    return out


def evaluate_blocks(
    ious: np.ndarray,
    iou_off: np.ndarray,
    d_off: np.ndarray,
    g_off: np.ndarray,
    gt_iscrowd: np.ndarray,
    g_area: np.ndarray,
    d_area: np.ndarray,
    thresholds: np.ndarray,
    area_lo: np.ndarray,
    area_hi: np.ndarray,
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Batched per-class COCO matching over every image, IoU threshold,
    and area range in one native call.  Returns
    (det_matched (R,T,sum_D) bool, det_matched_ignore (R,T,sum_D) bool,
    det_ignore_area (R,sum_D) bool, num_gt (R,) int64), or None when the
    kernel is unavailable or an image exceeds the 4096-GT scratch cap."""
    lib = load()
    if lib is None:
        return None
    g_sizes = np.diff(g_off)
    if len(g_sizes) and g_sizes.max() >= 4096:
        return None
    ious = np.ascontiguousarray(ious, np.float64)
    iou_off = np.ascontiguousarray(iou_off, np.int64)
    d_off = np.ascontiguousarray(d_off, np.int64)
    g_off = np.ascontiguousarray(g_off, np.int64)
    crowd = np.ascontiguousarray(gt_iscrowd, np.uint8)
    g_area = np.ascontiguousarray(g_area, np.float64)
    d_area = np.ascontiguousarray(d_area, np.float64)
    thr = np.ascontiguousarray(thresholds, np.float64)
    lo = np.ascontiguousarray(area_lo, np.float64)
    hi = np.ascontiguousarray(area_hi, np.float64)
    n_img = len(d_off) - 1
    n_thr, n_ranges = len(thr), len(lo)
    sum_d = int(d_off[-1])
    matched = np.zeros((n_ranges, n_thr, sum_d), np.uint8)
    matched_ign = np.zeros((n_ranges, n_thr, sum_d), np.uint8)
    ignore_area = np.zeros((n_ranges, sum_d), np.uint8)
    num_gt = np.zeros(n_ranges, np.int64)
    rc = lib.evaluate_blocks(
        _ptr_d(ious), _ptr_i64(iou_off), _ptr_i64(d_off), _ptr_i64(g_off),
        n_img, _ptr_u8(crowd), _ptr_d(g_area), _ptr_d(d_area),
        _ptr_d(thr), n_thr, _ptr_d(lo), _ptr_d(hi), n_ranges,
        _ptr_u8(matched), _ptr_u8(matched_ign), _ptr_u8(ignore_area),
        _ptr_i64(num_gt),
    )
    if rc != 0:
        return None
    return (
        matched.astype(bool),
        matched_ign.astype(bool),
        ignore_area.astype(bool),
        num_gt,
    )


def match_detections(
    ious: np.ndarray,
    gt_iscrowd: np.ndarray,
    gt_ignore: np.ndarray,
    thresholds: np.ndarray,
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    lib = load()
    if lib is None or ious.shape[1] >= 4096:
        return None
    n_det, n_gt = ious.shape
    n_thr = len(thresholds)
    ious = np.ascontiguousarray(ious, np.float64)
    crowd = np.ascontiguousarray(gt_iscrowd, np.uint8)
    ignore = np.ascontiguousarray(gt_ignore, np.uint8)
    thr = np.ascontiguousarray(thresholds, np.float64)
    matched = np.zeros((n_thr, n_det), np.uint8)
    matched_ign = np.zeros((n_thr, n_det), np.uint8)
    lib.match_detections(
        _ptr_d(ious), n_det, n_gt, _ptr_u8(crowd), _ptr_u8(ignore),
        _ptr_d(thr), n_thr, _ptr_u8(matched), _ptr_u8(matched_ign),
    )
    return matched.astype(bool), matched_ign.astype(bool)
