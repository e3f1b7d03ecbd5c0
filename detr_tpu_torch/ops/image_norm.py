"""Normalising uint8 images on the card (counterpart of
``detr_tpu/ops/image_norm.py``).

The loader can ship augmented images as uint8, a quarter of the fp32 bytes
over the host-to-card copy; the train and eval steps then normalise them
here.  The arithmetic is the host path's: fp32 ``x * scale - bias`` with the
folded constants of ``data.transforms.normalize``, and every pixel outside an
image's valid (height, width) exactly 0.0, as the host pads after
normalising.  Plain PyTorch on the card: the JAX package does this in XLA,
outside any Pallas kernel.  ``prepare_batch_image`` also takes the
device-resize wire's batches: source-resolution uint8 resampled on the card
(``ops.device_resize``), then normalised the same way.
"""

from __future__ import annotations

import functools

import torch

# The folded constants are imported from the host path, not derived again,
# so that the two wire formats cannot drift apart.
from detr_tpu_torch.data.transforms import _NORM_BIAS, _NORM_SCALE


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """scale and bias on ``device``, copied there once."""
    return torch.from_numpy(_NORM_SCALE).to(device), torch.from_numpy(_NORM_BIAS).to(device)


def _mask_outside(x: torch.Tensor, height: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """x with every pixel outside each image's (height, width) set to 0.0."""
    _, H, W, _ = x.shape
    dev = x.device
    rows = torch.arange(H, device=dev)[None, :, None] < height[:, None, None]
    cols = torch.arange(W, device=dev)[None, None, :] < width[:, None, None]
    return torch.where((rows & cols)[..., None], x, 0.0)


def device_normalize_image(image: torch.Tensor, height: torch.Tensor,
                           width: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 and per-image valid extents -> (B, H, W, 3) fp32
    normalised, 0.0 outside each image."""
    scale, bias = _constants(image.device)
    return _mask_outside(image.float() * scale - bias, height, width)


def prepare_image(image: torch.Tensor, height: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """A batch image in either wire format -> normalised fp32: uint8 is
    normalised here, fp32 (normalised on the host) passes through."""
    if image.dtype == torch.uint8:
        return device_normalize_image(image, height, width)
    return image


def prepare_batch_image(
    batch: dict[str, torch.Tensor],
    canvas_map: "dict[tuple[int, int], tuple[int, int]] | None" = None,
) -> torch.Tensor:
    """A batch's image in any wire format -> normalised fp32: fp32 passes
    through, uint8 is normalised, and a device-resize batch (``src_height``
    and ``src_width`` present) is resampled from each image's source extent
    to its ``height`` x ``width`` into the target canvas that ``canvas_map``
    gives for its source canvas, then normalised, 0.0 outside each image.
    A device-resize batch without a ``canvas_map`` raises."""
    image = batch["image"]
    if "src_height" not in batch:
        return prepare_image(image, batch["height"], batch["width"])
    if canvas_map is None:
        raise ValueError("device-resize wire batch but the step was built without a "
                         "canvas_map (pass TrainingConfig.device_resize through)")
    from detr_tpu_torch.ops.device_resize import resize_on_device

    canvas = canvas_map[(int(image.shape[1]), int(image.shape[2]))]
    x = resize_on_device(image, batch["src_height"], batch["src_width"], batch["height"],
                         batch["width"], canvas)
    scale, bias = _constants(x.device)
    # x is zero outside each extent already, but normalising maps 0 to -bias
    return _mask_outside(x * scale - bias, batch["height"], batch["width"])
