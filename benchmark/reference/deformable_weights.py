"""Deformable DETR's benchmark weights, made from a seed on the device.

Every tensor of the port's Deformable DETR state dict (the names
``models.deformable_detr`` gives them) is drawn from one
``torch.Generator`` on the device, in one normal draw for all random
tensors at once, sliced and scaled per tensor, as ``weights`` does for
DETR:

- the trunk as DETR's (He normal convolutions, frozen BN identity except
  ``bn3``'s weight 0.2, ``weights.RESIDUAL_BN_WEIGHT``);
- the input projections: Xavier normal convolutions, zero biases,
  GroupNorm weight 1 and bias 0;
- ``level_embed`` and the query embedding normal(0, 1) (``nn.init.normal_``
  and ``nn.Embedding``'s published initialisation); ``reference_points``
  Xavier normal (published: Xavier uniform), bias 0;
- every Dense layer of the encoder and the decoder normal with std
  ``initializer_range`` (0.02), biases 0, except two published biases:
  ``sampling_offsets``' is the published grid (head h's points along
  (cos, sin)(2 pi h / H) over its largest component, the p-th at p + 1 times
  it); the class head's is -log((1 - 0.01) / 0.01), the prior 0.01.  The
  paper zero-initialises the weights of ``sampling_offsets`` and
  ``attention_weights``: here they are normal(0.02) too, so that the
  sampling locations and weights differ from query to query and the
  locations' gradient is exercised;
- the class head Xavier normal; the box MLP normal(0.02);
- LayerNorms weight 1, bias 0.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.model import STAGES
from benchmark.reference.weights import RESIDUAL_BN_WEIGHT, _bn, _conv, _dense, _ln

TRUNK_CHANNELS = (512, 1024, 2048)


def offset_grid(heads: int, levels: int, points: int) -> torch.Tensor:
    """The published ``sampling_offsets`` bias as (H, L, P, 2)."""
    out = torch.zeros(heads, levels, points, 2, dtype=torch.float64)
    for h in range(heads):
        theta = 2.0 * math.pi * h / heads
        c, s = math.cos(theta), math.sin(theta)
        m = max(abs(c), abs(s))
        for p in range(points):
            out[h, :, p, 0] = (p + 1) * c / m
            out[h, :, p, 1] = (p + 1) * s / m
    return out.float()


def layout(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(name, shape, (rule, value)) of every tensor, in a fixed order;
    rules ``normal`` (std), ``const`` (value) and ``tensor`` (the values)."""
    out: list = []
    p = "backbone.backbone."
    _conv(p + "conv1.weight", 64, 3, 7, out)
    _bn(p + "bn1", 64, out)
    cin = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), STAGES[cfg["backbone"]]), 1):
        for b in range(n):
            q = f"{p}layer{stage}.{b}."
            _conv(q + "conv1.weight", planes, cin, 1, out)
            _bn(q + "bn1", planes, out)
            _conv(q + "conv2.weight", planes, planes, 3, out)
            _bn(q + "bn2", planes, out)
            _conv(q + "conv3.weight", planes * 4, planes, 1, out)
            _bn(q + "bn3", planes * 4, out, RESIDUAL_BN_WEIGHT)
            if b == 0:
                _conv(q + "downsample.0.weight", planes * 4, cin, 1, out)
                _bn(q + "downsample.1", planes * 4, out)
            cin = planes * 4
    d = cfg["hidden_size"]
    H, L = cfg["num_attention_heads"], cfg["num_feature_levels"]
    std = cfg["initializer_range"]
    ffn = d * cfg["ffn_scale_factor"]
    out.append(("level_embed", (L, d), ("normal", 1.0)))
    for lvl in range(L):
        cin, k = (TRUNK_CHANNELS[lvl], 1) if lvl < 3 else (TRUNK_CHANNELS[-1] if lvl == 3 else d, 3)
        out += [(f"input_proj.{lvl}.0.weight", (d, cin, k, k),
                 ("normal", math.sqrt(2.0 / (cin * k * k + d * k * k)))),
                (f"input_proj.{lvl}.0.bias", (d,), ("const", 0.0)),
                (f"input_proj.{lvl}.1.weight", (d,), ("const", 1.0)),
                (f"input_proj.{lvl}.1.bias", (d,), ("const", 0.0))]
    out += [("query_embedding.weight", (cfg["num_object_queries"], 2 * d), ("normal", 1.0)),
            ("reference_points.weight", (2, d), ("normal", math.sqrt(2.0 / (d + 2)))),
            ("reference_points.bias", (2,), ("const", 0.0))]

    def msda(name, points):
        out.append((f"{name}.sampling_offsets.weight", (H * L * points * 2, d), ("normal", std)))
        out.append((f"{name}.sampling_offsets.bias", (H * L * points * 2,),
                    ("tensor", offset_grid(H, L, points).flatten())))
        _dense(f"{name}.attention_weights", H * L * points, d, std, out)
        _dense(f"{name}.value_proj", d, d, std, out)
        _dense(f"{name}.output_proj", d, d, std, out)

    def ffn_layers(name):
        _dense(f"{name}.layers.0", ffn, d, std, out)
        _dense(f"{name}.layers.3", d, ffn, std, out)

    for i in range(cfg["num_encoder_layers"]):
        q = f"encoder.{i}."
        msda(q + "self_attention", cfg["enc_n_points"])
        _ln(q + "norm1", d, out)
        ffn_layers(q + "ffn")
        _ln(q + "norm2", d, out)
    for i in range(cfg["num_decoder_layers"]):
        q = f"decoder.{i}."
        for proj in ("query_proj", "key_proj", "value_proj", "output_proj"):
            _dense(f"{q}self_attention.{proj}", d, d, std, out)
        _ln(q + "norm1", d, out)
        msda(q + "cross_attention", cfg["dec_n_points"])
        _ln(q + "norm2", d, out)
        ffn_layers(q + "ffn")
        _ln(q + "norm3", d, out)
    C = cfg["num_classes"]
    out += [("class_embedding.weight", (C, d), ("normal", math.sqrt(2.0 / (d + C)))),
            ("class_embedding.bias", (C,), ("const", -math.log((1 - 0.01) / 0.01)))]
    n = cfg["box_embedding_mlp_num_layers"]
    for i in range(n):
        _dense(f"bbox_embedding.net.{2 * i}", 4 if i == n - 1 else d, d, std, out)
    return out


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """name -> fp32 tensor on ``device``, from ``seed``."""
    spec = layout(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0xFFFFFFFFFFFF)
    n_random = sum(math.prod(shape) for _, shape, (rule, _) in spec if rule == "normal")
    flat = torch.randn(n_random, generator=gen, device=device, dtype=torch.float32)
    out, i = {}, 0
    for name, shape, (rule, value) in spec:
        n = math.prod(shape)
        if rule == "normal":
            out[name] = flat[i:i + n].view(shape) * value
            i += n
        elif rule == "tensor":
            out[name] = value.to(device=device, dtype=torch.float32).view(shape).clone()
        else:
            out[name] = torch.full(shape, value, dtype=torch.float32, device=device)
    return out
