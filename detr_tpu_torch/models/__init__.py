"""The port's models, and the two factories that read the configuration's
type: ``build_detector`` builds DETR or Deformable DETR, ``class_head`` the
way their class logits are read (``models/class_head.py``)."""

from typing import Optional

from torch import nn

from detr_tpu_torch.config import DeformableDETRConfig, DETRConfig
from detr_tpu_torch.models.class_head import ClassHead, FocalClassHead, SoftmaxClassHead
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


# Shadows the submodule of the same name as an attribute of this package:
# import the heads themselves with ``from detr_tpu_torch.models.class_head import ...``.
def class_head(config: DETRConfig) -> ClassHead:
    """The class head of ``build_detector(config)``'s model: the focal head
    at the configuration's alpha for a ``DeformableDETRConfig``, else the
    softmax head."""
    if isinstance(config, DeformableDETRConfig):
        return FocalClassHead.of(config)
    return SoftmaxClassHead()


__all__ = [
    "DETR",
    "DeformableDETR",
    "build_detector",
    "class_head",
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
