"""The port's models and ``build_detector``, the one factory that builds
DETR or Deformable DETR from the configuration's type."""

from typing import Optional

from torch import nn

from detr_tpu_torch.config import DeformableDETRConfig, DETRConfig
from detr_tpu_torch.models.convert import state_dict_from_jax
from detr_tpu_torch.models.deformable_detr import DeformableDETR
from detr_tpu_torch.models.detr import DETR, make_image_padding_mask
from detr_tpu_torch.models.resnet import ResNetBackbone, calibrate_frozen_bn
from detr_tpu_torch.models.transformer import (
    FFN,
    MLP,
    Decoder,
    Encoder,
    MultiHeadAttention,
)


def build_detector(config: DETRConfig, tp: Optional[object] = None) -> nn.Module:
    """``DeformableDETR`` for a ``DeformableDETRConfig``, ``DETR`` for any
    other ``DETRConfig``; ``tp`` as their constructors take it (Deformable
    DETR raises on one)."""
    if isinstance(config, DeformableDETRConfig):
        return DeformableDETR(config, tp)
    return DETR(config, tp)


__all__ = [
    "DETR",
    "DeformableDETR",
    "build_detector",
    "make_image_padding_mask",
    "state_dict_from_jax",
    "ResNetBackbone",
    "calibrate_frozen_bn",
    "Encoder",
    "Decoder",
    "FFN",
    "MLP",
    "MultiHeadAttention",
]
