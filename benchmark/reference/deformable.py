"""Deformable DETR's forward in plain fp32 PyTorch, over a flat state dict,
and its AdamW with the third learning-rate group.

The base multi-scale model of arXiv:2010.04159 (no box refinement, no two
stage) at the configuration's widths, with the port's stated departures
(listed in ``configs/deformable_detr_r50.json``):

- the ResNet trunk of ``model`` (frozen BN; DC5 as there), returning C3, C4
  and C5 (strides 8, 16, 32);
- per level a 1x1 convolution with bias and GroupNorm(32, d), and a fourth
  level from a 3x3 stride-2 convolution of C5 and GroupNorm (stride 64);
- per level the padding mask past ``ceil(extent / stride)`` cells on either
  axis and ``model.positions_and_mask``'s sine positions, plus the level's
  row of ``level_embed``; the valid ratio of a level is its valid cells
  over its size, (x, y);
- multi-scale deformable attention: the value projection, zeroed on padded
  cells, split into H heads; per query, head, level and point a location
  ``reference + offset / (W_l, H_l)`` and a weight (a softmax over the
  head's L * P samples); each sample bilinear with ``align_corners=False``
  pixels (``px = x * W_l - 0.5``) and zero outside the map, by explicit
  indexing of the four corners here; the weighted sum, then the output
  projection;
- encoder reference points: each cell's centre over its level's valid
  extent, times every level's valid ratio; decoder reference points
  ``sigmoid(Linear(query_pos))`` times the valid ratios;
- post-norm layers with ReLU FFNs (d -> 4d -> d); the decoder's
  self-attention is ``model``'s multi-head attention (dropout on the
  probabilities and the residual), its cross-attention deformable;
- no final decoder norm; a sigmoid class head over C classes and a 3-layer
  ReLU box MLP shared by all decoder layers, the box centre's logit offset
  by the reference point's.

Dropout in train mode draws one seed per site in the order the layers run:
per encoder layer the deformable attention's residual, then the FFN's
hidden and output slots; per decoder layer the self-attention's
probabilities and residual, the deformable attention's residual, then the
FFN's two.  ``Precision`` rounds the operands of every product the
configuration computes in its low precision (``model``'s rule), the
sampled value map included.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from benchmark.reference import model as rm
from benchmark.reference import optim as ro

TRUNK_STAGES = (2, 3, 4)
LINEAR_PROJ_NAMES = ("sampling_offsets", "reference_points")


def seeds_per_forward(cfg: dict) -> int:
    """Dropout sites of one forward: 3 per encoder layer, 5 per decoder layer."""
    return 3 * cfg["num_encoder_layers"] + 5 * cfg["num_decoder_layers"]


def level_strides(cfg: dict) -> list[int]:
    strides = [8, 16, 16 if cfg["dilation"] else 32]
    while len(strides) < cfg["num_feature_levels"]:
        strides.append(2 * strides[-1])
    return strides


def trunk_stages(c: rm.Ctx, x: torch.Tensor) -> list[torch.Tensor]:
    """(B, 3, H, W) normalised -> [C3, C4, C5] NCHW."""
    p = "backbone.backbone."
    x = F.relu(rm._bn(c, rm._conv(c, x, p + "conv1.weight", stride=2), p + "bn1"))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    dc5 = c.cfg["dilation"]
    out = []
    for stage, n in enumerate(rm.STAGES[c.cfg["backbone"]], start=1):
        for b in range(n):
            q = f"{p}layer{stage}.{b}."
            stride = 1 if (b > 0 or stage == 1 or (dc5 and stage == 4)) else 2
            dil = 2 if (dc5 and stage == 4 and b > 0) else 1
            y = F.relu(rm._bn(c, rm._conv(c, x, q + "conv1.weight"), q + "bn1"))
            y = F.relu(rm._bn(c, rm._conv(c, y, q + "conv2.weight", stride, dil), q + "bn2"))
            y = rm._bn(c, rm._conv(c, y, q + "conv3.weight"), q + "bn3")
            if b == 0:
                x = rm._bn(c, rm._conv(c, x, q + "downsample.0.weight", stride),
                           q + "downsample.1")
            x = F.relu(y + x)
        if stage in TRUNK_STAGES:
            out.append(x)
    return out


def _projection(c: rm.Ctx, x: torch.Tensor, name: str, stride: int) -> torch.Tensor:
    w, b = c.sd[name + ".0.weight"], c.sd[name + ".0.bias"]
    k = w.shape[-1]
    y = F.conv2d(c.P(x), c.P(w), b, stride, k // 2)
    d = y.shape[1]
    return F.group_norm(y, math.gcd(32, d), c.sd[name + ".1.weight"], c.sd[name + ".1.bias"],
                        1e-5)


def bilinear(value: torch.Tensor, h: int, w: int, loc: torch.Tensor) -> torch.Tensor:
    """value (B, h*w, H, D) one level's map, loc (B, Lq, H, P, 2) (x, y) ->
    (B, Lq, H, P, D): each sample the weighted sum of its four corners, a
    corner outside the map adding zero."""
    B, _, H, D = value.shape
    _, Lq, _, P, _ = loc.shape
    px = loc[..., 0] * w - 0.5
    py = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()
    heads = torch.arange(H, device=value.device).view(1, 1, H, 1)
    rows = torch.arange(B, device=value.device).view(B, 1, 1, 1)
    out = torch.zeros(B, Lq, H, P, D, dtype=value.dtype, device=value.device)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            cell = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))
            corner = value[rows, cell, heads]  # (B, Lq, H, P, D)
            out = out + torch.where(inside, wy * wx, 0.0)[..., None] * corner
    return out


def deformable_attention(c: rm.Ctx, query, reference, value_in, shapes, mask, name,
                         points: int):
    """query (B, Lq, d), reference (B, Lq, L, 2), value_in (B, S, d)."""
    cfg = c.cfg
    B, Lq, d = query.shape
    H, L = cfg["num_attention_heads"], cfg["num_feature_levels"]
    D = d // H
    v = rm._linear(c, value_in, name + ".value_proj")
    v = torch.where(mask[..., None], 0.0, v).reshape(B, -1, H, D)
    off = rm._linear(c, query, name + ".sampling_offsets").view(B, Lq, H, L, points, 2)
    a = rm._linear(c, query, name + ".attention_weights").view(B, Lq, H, L * points)
    a = torch.softmax(a, -1).view(B, Lq, H, L, points)
    v = c.P(v)
    out = torch.zeros(B, Lq, H, D, dtype=v.dtype, device=v.device)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        loc = reference[:, :, None, lvl, None, :] + off[:, :, :, lvl] / torch.tensor(
            [w, h], dtype=torch.float32, device=v.device)
        sampled = bilinear(v[:, start:start + h * w], h, w, loc)  # (B, Lq, H, P, D)
        out = out + (a[:, :, :, lvl, :, None] * sampled).sum(3)
        start += h * w
    return rm._linear(c, out.reshape(B, Lq, d), name + ".output_proj")


def _ffn(c: rm.Ctx, x, name):
    rate = c.cfg["hidden_dropout_prob"]
    h = c.drop(F.relu(rm._linear(c, x, name + ".layers.0")), rate)
    return c.drop(rm._linear(c, h, name + ".layers.3"), rate)


def levels(c: rm.Ctx, feats, heights, widths):
    """-> tokens (B, S, d), positions + level embeddings (B, S, d), mask
    (B, S), the levels' (h, w), valid ratios (B, L, 2) (x, y)."""
    cfg = c.cfg
    d = cfg["hidden_size"]
    maps = []
    for lvl in range(cfg["num_feature_levels"]):
        if lvl < len(feats):
            maps.append(_projection(c, feats[lvl], f"input_proj.{lvl}", 1))
        else:
            src = feats[-1] if lvl == len(feats) else maps[-1]
            maps.append(_projection(c, src, f"input_proj.{lvl}", 2))
    toks, poss, masks, shapes, ratios = [], [], [], [], []
    for lvl, (m, stride) in enumerate(zip(maps, level_strides(cfg))):
        B, _, fh, fw = m.shape
        pos, mask = rm.positions_and_mask(fh, fw, heights, widths, stride, d, cfg["temperature"])
        toks.append(m.permute(0, 2, 3, 1).reshape(B, fh * fw, d))
        poss.append(pos + c.sd["level_embed"][lvl])
        masks.append(mask)
        shapes.append((fh, fw))
        vh = rm.valid_cells(heights, stride).clamp(max=fh).float() / fh
        vw = rm.valid_cells(widths, stride).clamp(max=fw).float() / fw
        ratios.append(torch.stack([vw, vh], -1))
    return (torch.cat(toks, 1), torch.cat(poss, 1), torch.cat(masks, 1), shapes,
            torch.stack(ratios, 1))


def encoder_reference(shapes, ratios):
    refs = []
    for lvl, (h, w) in enumerate(shapes):
        ys = (torch.arange(h, dtype=torch.float32, device=ratios.device) + 0.5)
        xs = (torch.arange(w, dtype=torch.float32, device=ratios.device) + 0.5)
        ry = ys[:, None].expand(h, w).reshape(-1)[None] / (ratios[:, None, lvl, 1] * h)
        rx = xs[None, :].expand(h, w).reshape(-1)[None] / (ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([rx, ry], -1))
    return torch.cat(refs, 1)[:, :, None] * ratios[:, None]


def forward(sd: dict, cfg: dict, images: torch.Tensor, heights: torch.Tensor,
            widths: torch.Tensor, P: rm.Precision = rm.FP32, seeds: Optional[rm.Seeds] = None,
            row_offset: int = 0) -> dict[str, torch.Tensor]:
    """images (B, H, W, 3) fp32 normalised, zero outside each image; heights
    and widths (B,) the valid pixel extents; ``seeds`` turns on train-mode
    dropout; ``row_offset`` is the block's first row in its batch.
    -> pred_logits (B, L, Q, C), pred_boxes (B, L, Q, 4) cxcywh."""
    c = rm.Ctx(sd, cfg, P, None if seeds is None else seeds.stream(), row_offset)
    rate = cfg["hidden_dropout_prob"]
    d = cfg["hidden_size"]
    feats = trunk_stages(c, images.permute(0, 3, 1, 2))
    x, pos, mask, shapes, ratios = levels(c, feats, heights, widths)
    ref = encoder_reference(shapes, ratios)
    for i in range(cfg["num_encoder_layers"]):
        p = f"encoder.{i}."
        att = deformable_attention(c, x + pos, ref, x, shapes, mask, p + "self_attention",
                                   cfg["enc_n_points"])
        x = rm._norm(c, x + c.drop(att, rate), p + "norm1")
        x = rm._norm(c, x + _ffn(c, x, p + "ffn"), p + "norm2")
    memory = x
    B = memory.shape[0]
    query_pos, tgt = sd["query_embedding.weight"].split(d, dim=-1)
    reference = torch.sigmoid(F.linear(query_pos, sd["reference_points.weight"],
                                       sd["reference_points.bias"]))  # (Q, 2)
    ref_dec = reference[None, :, None, :] * ratios[:, None]
    query_pos = query_pos[None].expand(B, -1, -1)
    t = tgt[None].expand(B, -1, -1)
    outs = []
    for i in range(cfg["num_decoder_layers"]):
        p = f"decoder.{i}."
        q = t + query_pos
        t = rm._norm(c, t + rm._attention(c, q, q, t, None, p + "self_attention"), p + "norm1")
        att = deformable_attention(c, t + query_pos, ref_dec, memory, shapes, mask,
                                   p + "cross_attention", cfg["dec_n_points"])
        t = rm._norm(c, t + c.drop(att, rate), p + "norm2")
        t = rm._norm(c, t + _ffn(c, t, p + "ffn"), p + "norm3")
        outs.append(t)
    hs = torch.stack(outs, dim=1)  # (B, L, Q, d)
    logits = rm._linear(c, hs, "class_embedding", low=False)
    h = hs
    n = cfg["box_embedding_mlp_num_layers"]
    for i in range(n):
        h = rm._linear(c, h, f"bbox_embedding.net.{2 * i}", low=False)
        if i < n - 1:
            h = F.relu(h)
    r = reference.clamp(0, 1)
    inv = torch.log(r.clamp(min=1e-5) / (1 - r).clamp(min=1e-5))
    h = h + F.pad(inv, (0, 2))
    return {"pred_logits": logits, "pred_boxes": torch.sigmoid(h)}


class AdamW(ro.AdamW):
    """``optim.AdamW`` with a third group: the parameters whose names hold a
    component among ``LINEAR_PROJ_NAMES`` at ``lr * lr_linear_proj_mult``."""

    def __init__(self, params: dict, lr: float, lr_backbone: float, weight_decay: float,
                 max_norm: float, every: int, lr_linear_proj_mult: float):
        super().__init__(params, lr, lr_backbone, weight_decay, max_norm, every)
        for n in params:
            if not n.startswith("backbone.") and set(n.split(".")) & set(LINEAR_PROJ_NAMES):
                self.lr[n] = lr * lr_linear_proj_mult
