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
packages.  Only the numpy/PIL path is ported: uint8 images resize with PIL's
bilinear filter, float images per channel in PIL mode "F", and the colour
operations run in float32 numpy (the JAX package's optional C++ kernels are
not ported).  ``emit_source=True`` (the device-resize wire) is a later slice.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

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


def _no_source_wire(emit_source: bool) -> None:
    if emit_source:
        raise NotImplementedError(
            "emit_source (the device-resize wire) is not ported yet: a later slice "
            "(ROADMAP.md section 1)")


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
    return np.clip(img_f * factor, 0, 255)


def adjust_contrast(img_f, factor):
    mean = float(_grayscale(img_f).mean())
    return _blend(img_f, np.float32(mean), factor)


def adjust_saturation(img_f, factor):
    return _blend(img_f, _grayscale(img_f), factor)


def adjust_hue(img_f, delta):
    """Rotate the hue by ``delta`` (a fraction of the circle) through HSV."""
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
    """(x / 255 - mean) / std, folded to x * scale - bias, fp32."""
    x = np.multiply(img, _NORM_SCALE, dtype=np.float32)
    x -= _NORM_BIAS
    return x


# ---------------------------------------------------------------- pipelines


class TrainTransform:
    """The training augmentation.  ``normalize=False`` returns uint8 pixels:
    the loader's workers then ship a quarter of the bytes, and the card
    normalises (``ops.image_norm``).  ``photometric=False`` drops the
    distort stage and keeps the geometry: on the synthetic colour-coded
    dataset (``make_synthetic_coco``) the channel permutation and the hue
    rotation turn a box into another class's colour."""

    def __init__(
        self,
        seed: int = 0,
        scales=TRAIN_SCALES,
        max_size: int = MAX_SIZE,
        normalize: bool = True,
        emit_source: bool = False,
        photometric: bool = True,
    ):
        _no_source_wire(emit_source)
        self.rng = np.random.default_rng(seed)
        self.scales = scales
        self.max_size = max_size
        self.normalize = normalize
        self.photometric = photometric

    def __call__(self, img, target):
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


class ValTransform:
    """Validation transform; ``normalize=False`` returns uint8 pixels."""

    def __init__(self, min_size: int = 800, max_size: int = MAX_SIZE, normalize: bool = True,
                 emit_source: bool = False):
        _no_source_wire(emit_source)
        self.min_size = min_size
        self.max_size = max_size
        self.rng = np.random.default_rng(0)
        self.normalize = normalize

    def __call__(self, img, target):
        img = _to_numpy(img)
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
