"""DETR top module (counterpart of ``detr_tpu/models/detr.py``).

Frozen-BN ResNet backbone -> 1x1 projection 2048->256 -> sine position
embedding + padding mask -> flatten HW (h-major) -> pre-LN encoder -> decoder
over learned object queries -> class head (Linear -> C+1) and box head
(3-layer MLP -> 4, sigmoid) on every stacked decoder layer.

Public layouts are the JAX package's: images NHWC (B, H, W, 3) fp32,
normalized; heights/widths (B,) int; outputs
``pred_logits (B, num_decoder_layers, Q, C+1)`` and
``pred_boxes (B, num_decoder_layers, Q, 4)``, both fp32.  Module names follow
the reference ``state_dict`` (``backbone.backbone.*``, ``input_proj``,
``object_query_embedding``, ``class_embedding``, ``bbox_embedding.net``).

``DETR(config, tp)`` builds this rank's share of the transformer under a
tensor-parallel group (``parallel.tp``: the parameter names stay, the split
ones hold their slices); ``forward``'s ``batch_offset`` places the batch in
the global one for the dropout masks (``models.transformer``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.models.resnet import Conv, ResNetBackbone
from detr_tpu_torch.models.transformer import MLP, Decoder, Dense, Encoder
from detr_tpu_torch.ops.position_encoding import (
    batch_positional_encoding,
    scaled_valid_extent,
)
from detr_tpu_torch.parallel.tp import TensorParallel
from detr_tpu_torch.utils.profiling import span


def make_image_padding_mask(
    feat_height: int,
    feat_width: int,
    image_heights: torch.Tensor,
    image_widths: torch.Tensor,
    stride: int = 32,
    mode: str = "full",
) -> torch.Tensor:
    """(B, feat_height, feat_width) bool, True on padded cells.  ``"full"``
    masks rows >= ceil(h/s) OR cols >= ceil(w/s); ``"corner"`` masks rows
    >= ceil(h/s) AND cols >= ceil(w/s), as the original reference did."""
    device = image_heights.device
    sh = scaled_valid_extent(image_heights, stride)
    sw = scaled_valid_extent(image_widths, stride)
    rows = torch.arange(feat_height, device=device)[None, :, None] >= sh[:, None, None]
    cols = torch.arange(feat_width, device=device)[None, None, :] >= sw[:, None, None]
    if mode == "full":
        return rows | cols
    if mode == "corner":
        return rows & cols
    raise ValueError(f"unknown padding_mask_mode: {mode!r}")


class Backbone(nn.Module):
    """Holds the trunk as ``backbone`` so its keys read ``backbone.backbone.*``,
    as in the reference ``state_dict``."""

    def __init__(self, config: DETRConfig):
        super().__init__()
        self.backbone = ResNetBackbone(
            config.backbone, config.dilation, getattr(torch, config.dtype)
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images -> NHWC features (B, H/s, W/s, 2048)."""
        (feats,) = self.backbone(images.permute(0, 3, 1, 2))
        return feats.permute(0, 2, 3, 1)


class DETR(nn.Module):
    linear_proj_names: tuple[str, ...] = ()  # no third learning-rate group
    sigmoid_top_k = 0  # a softmax head: one detection per query

    def __init__(self, config: DETRConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.config = config
        self.tp = tp
        d = config.hidden_size
        self.backbone = Backbone(config)
        self.input_proj = nn.Conv2d(config.backbone_channels, d, 1)
        self.object_query_embedding = nn.Embedding(config.num_object_queries, d)
        self.encoder = Encoder(config, tp)
        self.decoder = Decoder(config, tp)
        # Both heads run in fp32 on fp32 input.
        self.class_embedding = Dense(d, config.num_classes + 1, torch.float32)
        self.bbox_embedding = MLP(d, 4, config.box_embedding_mlp_num_layers)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init by the JAX package's rules: he_normal (truncated)
        convolutions, normal(initializer_range) Dense kernels and object
        queries, xavier_uniform input projection and class head, zero
        biases, unit LayerNorms, identity frozen-BN statistics."""
        std = self.config.initializer_range
        for m in self.modules():
            if isinstance(m, Conv):
                fan_in = m.weight[0].numel()
                s = math.sqrt(2.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)
            elif isinstance(m, Dense):
                nn.init.normal_(m.weight, 0.0, std, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for head in (self.input_proj, self.class_embedding):
            nn.init.xavier_uniform_(head.weight, generator=generator)
            nn.init.zeros_(head.bias)
        nn.init.normal_(self.object_query_embedding.weight, 0.0, std, generator=generator)

    def forward(
        self,
        images: torch.Tensor,
        heights: torch.Tensor,
        widths: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        batch_offset: int = 0,
    ) -> dict[str, torch.Tensor]:
        """images (B, H, W, 3) normalized and zero-padded to the bucket;
        heights / widths (B,) valid pixel extents; ``generator`` (CPU) draws
        the dropout seeds in train mode; ``batch_offset``: the batch's first
        row in the global batch of a multi-rank step."""
        with span("model.backbone"):
            feats = self.backbone(images)
        return self.from_features(feats, heights, widths, generator, batch_offset)

    def from_features(
        self,
        feats: torch.Tensor,
        heights: torch.Tensor,
        widths: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        batch_offset: int = 0,
    ) -> dict[str, torch.Tensor]:
        """Post-backbone pipeline from NHWC features (B, fh, fw, 2048)."""
        cfg = self.config
        dt = getattr(torch, cfg.dtype)
        stride = cfg.backbone_stride
        B, fh, fw, _ = feats.shape

        proj = self.input_proj
        x = F.linear(feats.to(dt), proj.weight.flatten(1).to(dt), proj.bias.to(dt))

        pos = batch_positional_encoding(  # fp32 island
            fh,
            fw,
            scaled_valid_extent(heights, stride),
            scaled_valid_extent(widths, stride),
            num_pos_feats=cfg.hidden_size // 2,
            temperature=cfg.temperature,
        )
        mask = make_image_padding_mask(fh, fw, heights, widths, stride, cfg.padding_mask_mode)

        tokens = x.reshape(B, fh * fw, cfg.hidden_size)  # h-major, as pos and mask
        pos = pos.reshape(B, fh * fw, cfg.hidden_size).to(dt)
        key_padding_mask = mask.reshape(B, fh * fw)
        query_embed = self.object_query_embedding.weight[None].expand(B, -1, -1).to(dt)

        with span("model.transformer"):
            encoded = self.encoder(tokens, pos, key_padding_mask, generator, batch_offset)
            decoded = self.decoder(encoded, pos, query_embed, key_padding_mask, generator,
                                   batch_offset).float()
        return {
            "pred_logits": self.class_embedding(decoded),
            "pred_boxes": torch.sigmoid(self.bbox_embedding(decoded)),
        }
