"""Normalising uint8 images on the card (counterpart of
``detr_tpu/ops/image_norm.py``, without the device-resize wire).

The loader can ship augmented images as uint8, a quarter of the fp32 bytes
over the host-to-card copy; the train and eval steps then normalise them
here.  The arithmetic is the host path's: fp32 ``x * scale - bias`` with the
folded constants of ``data.transforms.normalize``, and every pixel outside an
image's valid (height, width) exactly 0.0, as the host pads after
normalising.  Plain PyTorch on the card: the JAX package does this in XLA,
outside any Pallas kernel.
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


def device_normalize_image(image: torch.Tensor, height: torch.Tensor,
                           width: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 and per-image valid extents -> (B, H, W, 3) fp32
    normalised, 0.0 outside each image."""
    _, H, W, _ = image.shape
    dev = image.device
    scale, bias = _constants(dev)
    x = image.float() * scale - bias
    rows = torch.arange(H, device=dev)[None, :, None] < height[:, None, None]
    cols = torch.arange(W, device=dev)[None, None, :] < width[:, None, None]
    return torch.where((rows & cols)[..., None], x, 0.0)


def prepare_image(image: torch.Tensor, height: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """A batch image in either wire format -> normalised fp32: uint8 is
    normalised here, fp32 (normalised on the host) passes through."""
    if image.dtype == torch.uint8:
        return device_normalize_image(image, height, width)
    return image
