"""Host-side augmentation, numpy + PIL (counterpart of
``detr_tpu/data/transforms.py``).

train: hflip(0.5) -> photometric distort(0.5) -> RandomChoice[
           RandomShortestSize(480:800:32, max 1333)
         | RandomShortestSize([400, 500, 600]) -> RandomSizeCrop(384, 600)
           -> RandomShortestSize(480:800:32, max 1333) ]
       -> clamp boxes -> drop boxes under 1 px -> ImageNet normalize
val:   shortest side ``min_size`` / longest at most ``max_size`` -> clamp ->
       drop boxes under 1 px -> ImageNet normalize

Every random value is drawn from the transform's own ``np.random.Generator``
in the JAX package's order, so one seed gives the same augmentation in both
packages.  The pixel work runs in the host C++ kernels of ``_native``
(``native/image_ops.cc``, built on first use) where they build, exactly
where the JAX package calls its own: the uint8 resize (the antialiased
bilinear filter of PIL, at most 1 uint8 level from it), brightness, contrast
with its gray mean, saturation, the hue rotation and the uint8 ImageNet
normalisation.  Without a C++ toolchain (``_native.load()`` is None) the
same operations run in numpy and PIL: uint8 images resize with PIL's
bilinear filter, float images per channel in PIL mode "F", and the colour
operations in float32 numpy.

``emit_source=True`` is the device-resize wire's half on the host: the same
draws in the same order choose the same geometry, but the last resample is
left to the card (``ops.device_resize``).  The image comes back at its
source resolution (cropped, when the crop branch was drawn, in source
pixels) with ``target["resize_to"] = (th, tw)``, the size the host chain
would have produced; boxes stay in source pixels, and the drop of boxes
under 1 px applies at the final scale, 1 / scale source pixels.  Against
the host chain, two differences, both of augmentation only: the crop's
offsets round to source pixels (the host crops the resized image), and the
crop branch resamples once instead of resize -> crop -> resize.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from detr_tpu_torch.data import _native

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

TRAIN_SCALES = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)
MAX_SIZE = 1333

_NORM_SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
_NORM_BIAS = (IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)


def _to_numpy(img) -> np.ndarray:
    if isinstance(img, np.ndarray):
        return img
    return np.asarray(img)  # PIL -> HWC uint8


def _to_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    return np.clip(img, 0, 255).astype(np.uint8)


# ----------------------------------------------------------------- geometry


def hflip(img: np.ndarray, target: dict) -> tuple[np.ndarray, dict]:
    w = img.shape[1]
    img = img[:, ::-1]
    boxes = target["boxes"].copy()
    if len(boxes):
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return img, dict(target, boxes=boxes)


def resize(img: np.ndarray, target: dict, new_h: int, new_w: int):
    h, w = img.shape[:2]
    if img.dtype == np.uint8:
        native = _native.resize_bilinear(img, new_h, new_w)
        if native is not None:
            img = native
        else:
            img = np.asarray(Image.fromarray(img).resize((new_w, new_h), Image.BILINEAR))
    else:
        chans = [
            np.asarray(
                Image.fromarray(np.ascontiguousarray(img[..., c]), mode="F").resize(
                    (new_w, new_h), Image.BILINEAR
                )
            )
            for c in range(img.shape[2])
        ]
        img = np.stack(chans, axis=-1).astype(img.dtype)
    boxes = target["boxes"].copy()
    if len(boxes):
        boxes[:, [0, 2]] *= new_w / w
        boxes[:, [1, 3]] *= new_h / h
    return img, dict(target, boxes=boxes)


def _shortest_size_ratio(h: int, w: int, rng: np.random.Generator, min_sizes,
                         max_size: int) -> float:
    """Draw a min_size; the scale that takes the short side to it without
    the long side passing max_size (torchvision ``RandomShortestSize``)."""
    min_size = int(rng.choice(np.atleast_1d(min_sizes)))
    return min(min_size / min(h, w), max_size / max(h, w))


def random_shortest_size(
    img: np.ndarray, target: dict, rng: np.random.Generator, min_sizes, max_size: int
):
    h, w = img.shape[:2]
    ratio = _shortest_size_ratio(h, w, rng, min_sizes, max_size)
    return resize(img, target, int(round(h * ratio)), int(round(w * ratio)))


def crop(img: np.ndarray, target: dict, top: int, left: int, ch: int, cw: int):
    img = img[top : top + ch, left : left + cw]
    boxes = target["boxes"].copy()
    if len(boxes):
        boxes[:, [0, 2]] -= left
        boxes[:, [1, 3]] -= top
    return img, dict(target, boxes=boxes)


def random_size_crop(
    img: np.ndarray,
    target: dict,
    rng: np.random.Generator,
    min_size: int = 384,
    max_size: int = 600,
):
    """Crop width and height drawn from [min_size, min(side, max_size)), at a
    random top-left inside the image; an image too small is kept whole."""
    h, w = img.shape[:2]
    hi_w, hi_h = min(w, max_size), min(h, max_size)
    if hi_w <= min_size or hi_h <= min_size:
        return img, target
    cw = int(rng.integers(min_size, hi_w))
    ch = int(rng.integers(min_size, hi_h))
    top = int(rng.integers(0, h - ch + 1))
    left = int(rng.integers(0, w - cw + 1))
    return crop(img, target, top, left, ch, cw)


def clamp_and_sanitize(img: np.ndarray, target: dict, min_w: float = 1.0, min_h: float = 1.0):
    """Clamp boxes into the image, then drop those narrower than ``min_w``
    or shorter than ``min_h`` pixels, keeping the per-box fields aligned."""
    h, w = img.shape[:2]
    boxes = target["boxes"].copy()
    if len(boxes):
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
        keep = ((boxes[:, 2] - boxes[:, 0]) >= min_w) & ((boxes[:, 3] - boxes[:, 1]) >= min_h)
    else:
        keep = np.zeros((0,), bool)
    return img, dict(
        target,
        boxes=boxes[keep],
        class_idx=target["class_idx"][keep],
        class_id=target["class_id"][keep],
        iscrowd=target["iscrowd"][keep],
    )


# ------------------------------------------------------- photometric distort
# torchvision's RandomPhotometricDistort in float32: contrast through the
# gray mean, saturation through a gray blend, hue through HSV.


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(b + factor * (a - b), 0.0, 255.0)


def _grayscale(img_f: np.ndarray) -> np.ndarray:
    g = img_f @ np.array([0.299, 0.587, 0.114], np.float32)
    return g[..., None]


def adjust_brightness(img_f, factor):
    out = _native.affine_gray(img_f, factor, 0.0, 0.0)
    if out is not None:
        return out
    return np.clip(img_f * factor, 0, 255)


def adjust_contrast(img_f, factor):
    mean = _native.gray_mean(img_f)
    if mean is None:
        mean = float(_grayscale(img_f).mean())
    out = _native.affine_gray(img_f, factor, 0.0, (1.0 - factor) * mean)
    if out is not None:
        return out
    return _blend(img_f, np.float32(mean), factor)


def adjust_saturation(img_f, factor):
    out = _native.affine_gray(img_f, factor, 1.0 - factor, 0.0)
    if out is not None:
        return out
    return _blend(img_f, _grayscale(img_f), factor)


def adjust_hue(img_f, delta):
    """Rotate the hue by ``delta`` (a fraction of the circle) through HSV:
    the native one-pass kernel, or numpy gathering each channel's sextant
    with ``np.choose``."""
    native = _native.hue_rotate(img_f, delta)
    if native is not None:
        return native
    x = img_f * np.float32(1.0 / 255.0)
    mx = x.max(-1)
    mn = x.min(-1)
    diff = mx - mn + np.float32(1e-12)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.where(
        mx == r,
        ((g - b) / diff) % 6.0,
        np.where(mx == g, (b - r) / diff + 2.0, (r - g) / diff + 4.0),
    ) / 6.0
    s = np.where(mx > 0, diff / (mx + np.float32(1e-12)), 0.0)
    v = mx
    h = (h + delta) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(np.int32) % 6
    out = np.empty(img_f.shape, np.float32)
    np.choose(i, (v, q, p, p, t, v), out=out[..., 0])
    np.choose(i, (t, v, v, q, p, p), out=out[..., 1])
    np.choose(i, (p, p, t, v, v, q), out=out[..., 2])
    return np.clip(out * 255.0, 0, 255)


def photometric_distort(
    img: np.ndarray,
    rng: np.random.Generator,
    brightness=(0.875, 1.125),
    contrast=(0.7, 1.3),
    saturation=(0.8, 1.2),
    hue=(-0.05, 0.05),
    p: float = 0.5,
) -> np.ndarray:
    """Brightness, contrast (before or after the saturation and hue pair),
    saturation, hue and a channel permutation, each with probability p."""
    x = img.astype(np.float32)
    if rng.random() < p:
        x = adjust_brightness(x, rng.uniform(*brightness))
    contrast_before = rng.random() < 0.5
    if contrast_before and rng.random() < p:
        x = adjust_contrast(x, rng.uniform(*contrast))
    if rng.random() < p:
        x = adjust_saturation(x, rng.uniform(*saturation))
    if rng.random() < p:
        x = adjust_hue(x, rng.uniform(*hue))
    if not contrast_before and rng.random() < p:
        x = adjust_contrast(x, rng.uniform(*contrast))
    if rng.random() < p:
        x = x[..., rng.permutation(3)]
    return x.astype(np.uint8)


def normalize(img: np.ndarray) -> np.ndarray:
    """(x / 255 - mean) / std, folded to x * scale - bias, fp32: one native
    pass over uint8, or two numpy passes."""
    if img.dtype == np.uint8:
        native = _native.normalize_u8(img, _NORM_SCALE, _NORM_BIAS)
        if native is not None:
            return native
    x = np.multiply(img, _NORM_SCALE, dtype=np.float32)
    x -= _NORM_BIAS
    return x


# ---------------------------------------------------------------- pipelines


class TrainTransform:
    """The training augmentation.  ``normalize=False`` returns uint8 pixels:
    the loader's workers then ship a quarter of the bytes, and the card
    normalises (``ops.image_norm``).  ``emit_source=True`` returns uint8
    source pixels and the target size (module docstring).
    ``photometric=False`` drops the distort stage and keeps the geometry: on
    the synthetic colour-coded dataset (``make_synthetic_coco``) the channel
    permutation and the hue rotation turn a box into another class's
    colour."""

    def __init__(
        self,
        seed: int = 0,
        scales=TRAIN_SCALES,
        max_size: int = MAX_SIZE,
        normalize: bool = True,
        emit_source: bool = False,
        photometric: bool = True,
    ):
        self.rng = np.random.default_rng(seed)
        self.scales = scales
        self.max_size = max_size
        self.normalize = normalize
        self.emit_source = emit_source
        self.photometric = photometric

    def __call__(self, img, target):
        if self.emit_source:
            return self._call_source(img, target)
        rng = self.rng
        img = _to_numpy(img)
        if rng.random() < 0.5:
            img, target = hflip(img, target)
        if self.photometric:
            img = photometric_distort(img, rng)
        if rng.random() < 0.5:
            img, target = random_shortest_size(img, target, rng, self.scales, self.max_size)
        else:
            img, target = random_shortest_size(img, target, rng, (400, 500, 600), 10_000)
            img, target = random_size_crop(img, target, rng)
            img, target = random_shortest_size(img, target, rng, self.scales, self.max_size)
        img, target = clamp_and_sanitize(img, target)
        if not self.normalize:
            return _to_uint8(img), target
        return normalize(img), target

    def _call_source(self, img, target):
        rng = self.rng
        img = _to_numpy(img)
        if rng.random() < 0.5:
            img, target = hflip(img, target)
        if self.photometric:
            img = photometric_distort(img, rng)
        h, w = img.shape[:2]
        if rng.random() < 0.5:
            ratio = _shortest_size_ratio(h, w, rng, self.scales, self.max_size)
            th, tw = int(round(h * ratio)), int(round(w * ratio))
        else:
            # The crop branch's geometry drawn in the first resize's space,
            # as the host chain draws it (s1, cw, ch, top, left, s2), then
            # mapped back to source pixels: one crop here, one resample on
            # the card.
            ratio1 = _shortest_size_ratio(h, w, rng, (400, 500, 600), 10_000)
            h1, w1 = int(round(h * ratio1)), int(round(w * ratio1))
            ch, cw = h1, w1
            hi_w, hi_h = min(w1, 600), min(h1, 600)
            if hi_w > 384 and hi_h > 384:  # random_size_crop's guard
                cw = int(rng.integers(384, hi_w))
                ch = int(rng.integers(384, hi_h))
                top = int(rng.integers(0, h1 - ch + 1))
                left = int(rng.integers(0, w1 - cw + 1))
                t0 = min(int(round(top / ratio1)), h - 1)
                l0 = min(int(round(left / ratio1)), w - 1)
                ch0 = min(max(1, int(round(ch / ratio1))), h - t0)
                cw0 = min(max(1, int(round(cw / ratio1))), w - l0)
                img, target = crop(img, target, t0, l0, ch0, cw0)
            ratio2 = _shortest_size_ratio(ch, cw, rng, self.scales, self.max_size)
            th, tw = int(round(ch * ratio2)), int(round(cw * ratio2))
        sh, sw = img.shape[:2]
        # boxes under 1 px at the final scale: 1 / scale source pixels
        img, target = clamp_and_sanitize(img, target, min_w=sw / max(tw, 1),
                                         min_h=sh / max(th, 1))
        return _to_uint8(img), dict(target, resize_to=(th, tw))


class ValTransform:
    """Validation transform; ``normalize=False`` returns uint8 pixels,
    ``emit_source=True`` uint8 source pixels and the target size."""

    def __init__(self, min_size: int = 800, max_size: int = MAX_SIZE, normalize: bool = True,
                 emit_source: bool = False):
        self.min_size = min_size
        self.max_size = max_size
        self.rng = np.random.default_rng(0)
        self.normalize = normalize
        self.emit_source = emit_source

    def __call__(self, img, target):
        img = _to_numpy(img)
        if self.emit_source:
            h, w = img.shape[:2]
            ratio = min(self.min_size / min(h, w), self.max_size / max(h, w))
            th, tw = int(round(h * ratio)), int(round(w * ratio))
            img, target = clamp_and_sanitize(img, target, min_w=w / max(tw, 1),
                                             min_h=h / max(th, 1))
            return _to_uint8(img), dict(target, resize_to=(th, tw))
        img, target = random_shortest_size(
            img, target, self.rng, (self.min_size,), self.max_size
        )
        img, target = clamp_and_sanitize(img, target)
        if not self.normalize:
            return _to_uint8(img), target
        return normalize(img), target


def get_train_transforms(
    seed: int = 0,
    normalize: bool = True,
    emit_source: bool = False,
    photometric: bool = True,
) -> TrainTransform:
    return TrainTransform(seed=seed, normalize=normalize, emit_source=emit_source,
                          photometric=photometric)


def get_val_transforms(
    normalize: bool = True,
    emit_source: bool = False,
    min_size: int = 800,
    max_size: int = MAX_SIZE,
) -> ValTransform:
    return ValTransform(min_size=min_size, max_size=max_size, normalize=normalize,
                        emit_source=emit_source)
