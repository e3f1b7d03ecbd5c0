"""Deformable DETR (arXiv:2010.04159), the base multi-scale model: no
iterative box refinement, no two-stage variant.

Frozen-BN ResNet trunk returning C3, C4 and C5 (strides 8, 16, 32) -> one
input projection per level (a 1x1 convolution and GroupNorm(32, d); a fourth
level from a 3x3 stride-2 convolution of C5 and GroupNorm, stride 64) ->
per level the padding mask, sine positions plus a learned ``level_embed``,
flattened h-major and concatenated -> a post-norm encoder whose
self-attention is multi-scale deformable attention (MSDA, ``ops.ms_deform_
attn``) from every cell's centre -> a post-norm decoder over 300 queries
(dense self-attention through ``ops.masked_attention``, MSDA
cross-attention from reference points ``sigmoid(Linear(query_pos))``) ->
one sigmoid class head over C classes (no no-object class) and one 3-layer
ReLU box MLP, both shared across the decoder layers, the box MLP's centre
offset from the reference point's logit.

Semantics where the port's differ from the published code (each listed as a
departure in ``benchmark/configs/deformable_detr_r50.json``): the padding
mask of each level covers the cells past ``ceil(extent / stride)`` on
either axis (``"full"``; the published code interpolates the pixel mask),
so a level's valid ratio is that count over the level's size; positions are
``ops.position_encoding.batch_positional_encoding`` over each level's valid
cells (``linspace(0, 1, n)``; the published code normalises a cumulative
sum); dropout is the port's hash dropout (``HashDropout``, the attention
probabilities' inside ``masked_attention``).

Layers and names: ``MSDeformAttention`` (``sampling_offsets`` Linear(d,
H*L*P*2), ``attention_weights`` Linear(d, H*L*P) softmaxed over each head's
L*P samples, ``value_proj`` and ``output_proj`` Linear(d, d)); the padded
value rows are zeroed before sampling; every encoder query is computed.
Encoder layer: ``x = norm1(x + drop(msda(x + pos)))``, ``x = norm2(x +
ffn(x))``.  Decoder layer: ``t = norm1(t + self_attention(t + q_pos, t +
q_pos, t))``, ``t = norm2(t + drop(msda(t + q_pos)))``, ``t = norm3(t +
ffn(t))``; no final norm.  FFN d -> 4d ReLU -> d, with the port's two hash
dropouts.  Dense layers compute in ``config.dtype`` (the sampling offsets
and attention weights too, then fp32 for the softmax and the locations),
norms in fp32, the heads in fp32.  Dropout seeds are drawn per site in the
order the layers run: per encoder layer the MSDA residual's, then the
FFN's two; per decoder layer the self-attention's probabilities' and
residual's, the MSDA residual's, then the FFN's two.

Spans (``utils.profiling``): ``model.backbone``, ``model.input_proj``,
``model.encoder``, ``model.decoder``; each MSDA call is spanned ``msda`` by
the op.  Tensor parallelism is not supported: ``DeformableDETR(config, tp)``
raises.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from detr_tpu_torch.config import DeformableDETRConfig
from detr_tpu_torch.models.resnet import Conv, ResNetBackbone
from detr_tpu_torch.models.transformer import (
    FFN,
    MLP,
    Dense,
    HashDropout,
    LayerNorm32,
    MultiHeadAttention,
    _layer_call,
)
from detr_tpu_torch.models.detr import make_image_padding_mask
from detr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from detr_tpu_torch.ops.position_encoding import batch_positional_encoding, scaled_valid_extent
from detr_tpu_torch.parallel.tp import TensorParallel
from detr_tpu_torch.utils.profiling import span

TRUNK_STAGES = (2, 3, 4)  # C3, C4, C5
TRUNK_CHANNELS = (512, 1024, 2048)


def level_strides(config: DeformableDETRConfig) -> list[int]:
    """Each level's stride: C3 8, C4 16, C5 32 (16 with DC5), then each extra
    level twice the one before."""
    strides = [8, 16, 16 if config.dilation else 32]
    while len(strides) < config.num_feature_levels:
        strides.append(2 * strides[-1])
    return strides[:config.num_feature_levels]


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The published ``inverse_sigmoid``: log(x / (1 - x)), each clamped at eps."""
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


@functools.lru_cache(maxsize=64)
def _inverse_sizes(shapes: tuple, device: torch.device) -> torch.Tensor:
    """(L, 2) fp32 (1 / W_l, 1 / H_l) on ``device``: made once per canvas
    (a copy from the host waits for the card, so not once per call)."""
    return torch.tensor([[1.0 / w, 1.0 / h] for h, w in shapes], dtype=torch.float32,
                        device=device)


class MSDeformAttention(nn.Module):
    """Multi-scale deformable attention around ``ops.ms_deform_attn``."""

    def __init__(self, config: DeformableDETRConfig, n_points: int):
        super().__init__()
        d, H, L = config.hidden_size, config.num_attention_heads, config.num_feature_levels
        dt = getattr(torch, config.dtype)
        self.heads, self.levels, self.points = H, L, n_points
        self.head_size = config.head_size
        self.sampling_offsets = Dense(d, H * L * n_points * 2, dt)
        self.attention_weights = Dense(d, H * L * n_points, dt)
        self.value_proj = Dense(d, d, dt)
        self.output_proj = Dense(d, d, dt)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                value: torch.Tensor, spatial_shapes: tuple,
                padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """query (B, Lq, d), reference points (B, Lq, L, 2) fp32 (x, y) in
        [0, 1] of each level's map, value (B, S, d), the levels' (H_l, W_l),
        padding mask (B, S) bool -> (B, Lq, d)."""
        B, Lq, d = query.shape
        S = value.shape[1]
        H, L, P = self.heads, self.levels, self.points
        v = self.value_proj(value)
        if padding_mask is not None:
            v = v.masked_fill(padding_mask[..., None], 0.0)
        v = v.reshape(B, S, H, self.head_size)
        offsets = self.sampling_offsets(query).float().view(B, Lq, H, L, P, 2)
        weights = self.attention_weights(query).float().view(B, Lq, H, L * P)
        weights = weights.softmax(-1).view(B, Lq, H, L, P)
        inv = _inverse_sizes(spatial_shapes, query.device)
        loc = reference_points[:, :, None, :, None, :] + offsets * inv[None, None, None, :, None, :]
        out = ms_deform_attn(v, spatial_shapes, loc, weights)
        return self.output_proj(out.reshape(B, Lq, d))


class DeformableEncoderLayer(nn.Module):
    def __init__(self, config: DeformableDETRConfig):
        super().__init__()
        eps = config.layer_norm_eps
        self.dtype = getattr(torch, config.dtype)
        self.self_attention = MSDeformAttention(config, config.enc_n_points)
        self.dropout = HashDropout(config.hidden_dropout_prob)
        self.norm1 = LayerNorm32(config.hidden_size, eps=eps)
        self.ffn = FFN(config, activation=nn.ReLU)
        self.norm2 = LayerNorm32(config.hidden_size, eps=eps)

    def forward(self, x, pos, reference_points, spatial_shapes, padding_mask,
                generator: Optional[torch.Generator] = None, batch_offset: int = 0):
        dt = self.dtype
        att = self.self_attention(x + pos, reference_points, x, spatial_shapes, padding_mask)
        x = self.norm1(x + self.dropout(att, generator, batch_offset)).to(dt)
        return self.norm2(x + self.ffn(x, generator, batch_offset)).to(dt)


class DeformableDecoderLayer(nn.Module):
    def __init__(self, config: DeformableDETRConfig):
        super().__init__()
        eps = config.layer_norm_eps
        self.dtype = getattr(torch, config.dtype)
        self.self_attention = MultiHeadAttention(config)
        self.norm1 = LayerNorm32(config.hidden_size, eps=eps)
        self.cross_attention = MSDeformAttention(config, config.dec_n_points)
        self.dropout = HashDropout(config.hidden_dropout_prob)
        self.norm2 = LayerNorm32(config.hidden_size, eps=eps)
        self.ffn = FFN(config, activation=nn.ReLU)
        self.norm3 = LayerNorm32(config.hidden_size, eps=eps)

    def forward(self, t, query_pos, reference_points, memory, spatial_shapes, padding_mask,
                generator: Optional[torch.Generator] = None, batch_offset: int = 0):
        dt = self.dtype
        q = t + query_pos
        t = self.norm1(t + self.self_attention(q, q, t, None, generator, batch_offset)).to(dt)
        att = self.cross_attention(t + query_pos, reference_points, memory, spatial_shapes,
                                   padding_mask)
        t = self.norm2(t + self.dropout(att, generator, batch_offset)).to(dt)
        return self.norm3(t + self.ffn(t, generator, batch_offset)).to(dt)


class LevelProjection(nn.Sequential):
    """A level's input projection: a convolution with bias, computed in the
    compute dtype, then GroupNorm in fp32 (names ``0.weight``, ``0.bias``,
    ``1.weight``, ``1.bias`` as the published ``nn.Sequential``).  The
    published 32 groups, or fewer where d does not divide by 32 (the CPU
    tests' small widths)."""

    def __init__(self, cin: int, d: int, kernel: int, stride: int, dtype: torch.dtype):
        super().__init__(nn.Conv2d(cin, d, kernel, stride=stride, padding=kernel // 2),
                         nn.GroupNorm(math.gcd(32, d), d))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, norm = self[0], self[1]
        w = conv.weight.to(dtype=self.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.to(self.dtype), w, conv.bias.to(self.dtype), conv.stride, conv.padding)
        return F.group_norm(y.float(), norm.num_groups, norm.weight, norm.bias,
                            norm.eps).to(self.dtype)


class DeformableBackbone(nn.Module):
    """Holds the trunk as ``backbone`` (keys ``backbone.backbone.*``, as
    DETR's), asked for C3, C4 and C5."""

    def __init__(self, config: DeformableDETRConfig):
        super().__init__()
        self.backbone = ResNetBackbone(config.backbone, config.dilation,
                                       getattr(torch, config.dtype), stages=TRUNK_STAGES)

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """NHWC images -> (C3, C4, C5), NCHW channels_last."""
        return self.backbone(images.permute(0, 3, 1, 2))


class DeformableDETR(nn.Module):
    # The sampling offsets and reference points: the third learning-rate
    # group (``train.optimizer``; the published ``lr_linear_proj_names``).
    linear_proj_names = ("sampling_offsets", "reference_points")
    # The sigmoid head's detections per image (``eval.postprocess``; the
    # reference code's top 100 (query, class) pairs).
    sigmoid_top_k = 100

    def __init__(self, config: DeformableDETRConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        if tp is not None:
            raise ValueError("Deformable DETR has no tensor-parallel split; run it with "
                             "--model-parallel 1")
        if config.num_feature_levels < len(TRUNK_STAGES):
            raise ValueError(f"Deformable DETR takes at least {len(TRUNK_STAGES)} levels")
        self.config = config
        self.tp = None
        d, L = config.hidden_size, config.num_feature_levels
        dt = getattr(torch, config.dtype)
        self.backbone = DeformableBackbone(config)
        self.input_proj = nn.ModuleList(
            [LevelProjection(c, d, 1, 1, dt) for c in TRUNK_CHANNELS]
            + [LevelProjection(TRUNK_CHANNELS[-1] if i == 0 else d, d, 3, 2, dt)
               for i in range(L - len(TRUNK_STAGES))])
        self.level_embed = nn.Parameter(torch.zeros(L, d))
        self.query_embedding = nn.Embedding(config.num_object_queries, 2 * d)
        self.reference_points = Dense(d, 2, torch.float32)
        self.encoder = nn.ModuleList(
            DeformableEncoderLayer(config) for _ in range(config.num_encoder_layers))
        self.decoder = nn.ModuleList(
            DeformableDecoderLayer(config) for _ in range(config.num_decoder_layers))
        self.class_embedding = Dense(d, config.num_classes, torch.float32)
        self.bbox_embedding = MLP(d, 4, config.box_embedding_mlp_num_layers, nn.ReLU)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The published initialisation's rules (the reference code's
        ``_reset_parameters``): he_normal (truncated) trunk convolutions as
        DETR's, Xavier-uniform Dense and projection weights, zero biases;
        ``sampling_offsets``' weight zero and its bias ``offset_grid``;
        ``attention_weights``' weight zero; the class bias at the prior 0.01
        (-log 99); the box MLP's last layer zero; level embeddings and
        queries normal(0, 1)."""
        for m in self.modules():
            if isinstance(m, Conv):
                fan_in = m.weight[0].numel()
                s = math.sqrt(2.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)
            elif isinstance(m, (Dense, nn.Conv2d)):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for m in self.modules():
            if isinstance(m, MSDeformAttention):
                nn.init.zeros_(m.sampling_offsets.weight)
                nn.init.zeros_(m.attention_weights.weight)
                m.sampling_offsets.bias.copy_(offset_grid(m.heads, m.levels, m.points).flatten())
        nn.init.normal_(self.level_embed, generator=generator)
        nn.init.normal_(self.query_embedding.weight, generator=generator)
        nn.init.constant_(self.class_embedding.bias, -math.log((1 - 0.01) / 0.01))
        last = self.bbox_embedding.net[-1]
        nn.init.zeros_(last.weight)
        nn.init.zeros_(last.bias)

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
        row in the global batch of a multi-rank step.  -> ``pred_logits``
        (B, num_decoder_layers, Q, C) and ``pred_boxes`` (..., 4) cxcywh,
        both fp32."""
        cfg = self.config
        dt = getattr(torch, cfg.dtype)
        d = cfg.hidden_size
        with span("model.backbone"):
            feats = self.backbone(images)
        with span("model.input_proj"):
            src, pos, masks, shapes, ratios = self._levels(feats, heights, widths)
        B = src.shape[0]
        with span("model.encoder"):
            ref = encoder_reference_points(shapes, ratios)
            memory = src
            for layer in self.encoder:
                memory = _layer_call(layer, cfg.remat, (memory, pos, ref, shapes, masks),
                                     generator, batch_offset)
        with span("model.decoder"):
            query_pos, tgt = self.query_embedding.weight.split(d, dim=-1)
            reference = torch.sigmoid(self.reference_points(query_pos))  # (Q, 2) fp32
            ref_dec = reference[None, :, None, :] * ratios[:, None]  # (B, Q, L, 2)
            query_pos = query_pos[None].expand(B, -1, -1).to(dt)
            t = tgt[None].expand(B, -1, -1).to(dt)
            outputs = []
            for layer in self.decoder:
                t = _layer_call(layer, cfg.remat, (t, query_pos, ref_dec, memory, shapes, masks),
                                generator, batch_offset)
                outputs.append(t)
            hs = torch.stack(outputs, dim=1).float()  # (B, L_dec, Q, d)
        boxes = self.bbox_embedding(hs) + F.pad(inverse_sigmoid(reference), (0, 2))
        return {"pred_logits": self.class_embedding(hs), "pred_boxes": torch.sigmoid(boxes)}

    def _levels(self, feats, heights, widths):
        """The levels' flattened tokens (B, S, d), positions plus level
        embeddings (B, S, d) in the compute dtype, padding mask (B, S), the
        (H_l, W_l) shapes and the valid ratios (B, L, 2) fp32 (x, y)."""
        cfg = self.config
        dt = getattr(torch, cfg.dtype)
        d = cfg.hidden_size
        strides = level_strides(cfg)
        maps = []
        for i, proj in enumerate(self.input_proj):
            # C3-C5, then C5 again, then the level before
            maps.append(proj(feats[min(i, len(feats) - 1)] if i <= len(feats) else maps[-1]))
        src, pos, masks, shapes, ratios = [], [], [], [], []
        for lvl, (m, stride) in enumerate(zip(maps, strides)):
            B, _, fh, fw = m.shape
            vh = torch.clamp(scaled_valid_extent(heights, stride), max=fh)
            vw = torch.clamp(scaled_valid_extent(widths, stride), max=fw)
            p = batch_positional_encoding(fh, fw, vh, vw, num_pos_feats=d // 2,
                                          temperature=cfg.temperature)
            pos.append((p.reshape(B, fh * fw, d) + self.level_embed[lvl]).to(dt))
            src.append(m.permute(0, 2, 3, 1).reshape(B, fh * fw, d))
            masks.append(make_image_padding_mask(fh, fw, heights, widths, stride,
                                                 cfg.padding_mask_mode).reshape(B, fh * fw))
            shapes.append((fh, fw))
            ratios.append(torch.stack([vw.float() / fw, vh.float() / fh], -1))
        return (torch.cat(src, 1), torch.cat(pos, 1), torch.cat(masks, 1), tuple(shapes),
                torch.stack(ratios, 1))


def offset_grid(heads: int, levels: int, points: int) -> torch.Tensor:
    """The published bias of ``sampling_offsets``: (H, L, P, 2), head h's
    direction (cos, sin)(2 pi h / H) over its largest component, the p-th
    point at p + 1 times it, the same on every level."""
    thetas = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True)[0]
    grid = grid.view(heads, 1, 1, 2).repeat(1, levels, points, 1)
    return grid * torch.arange(1, points + 1, dtype=torch.float32).view(1, 1, points, 1)


def encoder_reference_points(shapes: tuple, ratios: torch.Tensor) -> torch.Tensor:
    """Every encoder query's reference point on every level, (B, S, L, 2)
    fp32 (x, y): the centre of its cell over its own level's valid extent,
    ((j + 0.5) / valid_W_l, (i + 0.5) / valid_H_l), times each level's valid
    ratio (the published ``get_reference_points``)."""
    refs = []
    for lvl, (h, w) in enumerate(shapes):
        ys = torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=ratios.device)
        xs = torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=ratios.device)
        ry, rx = torch.meshgrid(ys, xs, indexing="ij")
        ry = ry.reshape(-1)[None] / (ratios[:, None, lvl, 1] * h)
        rx = rx.reshape(-1)[None] / (ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([rx, ry], -1))
    return torch.cat(refs, 1)[:, :, None] * ratios[:, None]
