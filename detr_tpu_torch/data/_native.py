"""ctypes loader of the host image kernels (``detr_tpu_torch/native/image_ops.cc``;
counterpart of ``detr_tpu/data/_native.py``).

The build, its cache and its concurrency live in
``detr_tpu_torch.utils.native_build``.  ``load()`` is None when no C++
toolchain builds the source, and every wrapper then returns None: the
transforms take their numpy/PIL paths.  ``load()`` keeps its result in the
module globals ``_lib`` and ``_tried``, so a test selects the numpy path by
setting ``_tried = True`` and ``_lib = None``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from detr_tpu_torch.utils.native_build import NativeLib

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
                    "image_ops.cc")


def _bind(lib: ctypes.CDLL) -> None:
    lib.hue_rotate_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.c_float,
    ]
    lib.normalize_u8_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.resize_bilinear_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.affine_gray_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
    ]
    lib.gray_mean_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
    ]
    lib.gray_mean_f32.restype = ctypes.c_double
    for void in (lib.hue_rotate_f32, lib.normalize_u8_f32, lib.resize_bilinear_u8,
                 lib.affine_gray_f32):
        void.restype = None


# -march=native matters: these kernels are memory and SIMD bound and
# vectorise (AVX2, AVX-512) only when the ISA is enabled; the portable sets
# follow for toolchains without the flags.  The ISA-keyed library name
# (native_build._host_tag) makes the native flag safe to cache.
_native_lib = NativeLib(
    _SRC,
    (
        ["-fopenmp", "-march=native"],
        ["-fopenmp"],
        ["-march=native"],
        [],
    ),
    _bind,
)

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


def hue_rotate(img_f: np.ndarray, delta: float) -> Optional[np.ndarray]:
    """In-place-capable native hue rotate; None if the kernel is unavailable.

    ``img_f`` must be contiguous float32 (..., 3) in [0, 255]; a copy is
    rotated and returned.
    """
    lib = load()
    if lib is None:
        return None
    out = np.ascontiguousarray(img_f, np.float32).copy()
    n_px = out.size // 3
    lib.hue_rotate_f32(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(n_px),
        ctypes.c_float(float(delta)),
    )
    return out


def resize_bilinear(img: np.ndarray, nh: int, nw: int) -> Optional[np.ndarray]:
    """Antialiased bilinear resize of a uint8 HWC3 image (the PIL BILINEAR /
    torchvision antialias=True algorithm in float32); None when the kernel
    is unavailable or the input isn't uint8 HWC3."""
    lib = load()
    if (
        lib is None
        or img.dtype != np.uint8
        or img.ndim != 3
        or img.shape[2] != 3
        or nh <= 0
        or nw <= 0
    ):
        return None
    src = np.ascontiguousarray(img)
    out = np.empty((nh, nw, 3), np.uint8)
    lib.resize_bilinear_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(src.shape[0]),
        ctypes.c_int(src.shape[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(nh),
        ctypes.c_int(nw),
    )
    return out


def affine_gray(
    img_f: np.ndarray, alpha: float, beta: float, gamma: float
) -> Optional[np.ndarray]:
    """clip(alpha*img + beta*gray(img) + gamma, 0, 255) in one pass on
    float32 (..., 3); None when the kernel is unavailable."""
    lib = load()
    if lib is None or img_f.dtype != np.float32 or img_f.shape[-1] != 3:
        return None
    src = np.ascontiguousarray(img_f)
    out = np.empty(src.shape, np.float32)
    lib.affine_gray_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(src.size // 3),
        ctypes.c_float(float(alpha)),
        ctypes.c_float(float(beta)),
        ctypes.c_float(float(gamma)),
    )
    return out


def gray_mean(img_f: np.ndarray) -> Optional[float]:
    """Mean ITU-R 601 gray of float32 (..., 3); None when unavailable."""
    lib = load()
    if lib is None or img_f.dtype != np.float32 or img_f.shape[-1] != 3:
        return None
    src = np.ascontiguousarray(img_f)
    return float(
        lib.gray_mean_f32(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_long(src.size // 3),
        )
    )


def normalize_u8(img: np.ndarray, scale: np.ndarray, bias: np.ndarray) -> Optional[np.ndarray]:
    """img(u8, (...,3)) * scale - bias as float32; None when unavailable."""
    lib = load()
    if lib is None or img.dtype != np.uint8:
        return None
    src = np.ascontiguousarray(img)
    out = np.empty(src.shape, np.float32)
    lib.normalize_u8_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(src.size // 3),
        np.ascontiguousarray(scale, np.float32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)
        ),
        np.ascontiguousarray(bias, np.float32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)
        ),
    )
    return out
