from detr_tpu_torch.models.convert import state_dict_from_jax
from detr_tpu_torch.models.detr import DETR, make_image_padding_mask
from detr_tpu_torch.models.resnet import ResNetBackbone, calibrate_frozen_bn
from detr_tpu_torch.models.transformer import (
    FFN,
    MLP,
    Decoder,
    Encoder,
    MultiHeadAttention,
)

__all__ = [
    "DETR",
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
