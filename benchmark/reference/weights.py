"""The benchmark's weights, made from a seed on the device.

Every tensor of DETR's state dict (named as the served and trained model
names them) is drawn from one ``torch.Generator`` on the device, in one
normal draw for all parameters at once, sliced and scaled per tensor:

- convolutions: He normal, std sqrt(2 / fan_in);
- the transformer's Dense layers, the box MLP and the object queries: normal
  with std ``initializer_range`` (0.02); the input projection and the class
  head: Xavier normal, std sqrt(2 / (fan_in + fan_out)); biases 0;
- LayerNorms: weight 1, bias 0;
- frozen BatchNorm: mean 0, variance 1, bias 0, weight 1, except the last
  BatchNorm of each residual branch (``bn3``), whose weight is 0.2.  A
  random trunk with unit weights everywhere grows its activations by about
  a factor of two per block (about 1e4 at the last stage); the small
  residual weight keeps them near unit scale without statistics calibrated
  on data, so both sides start from the same numbers.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.model import STAGES

RESIDUAL_BN_WEIGHT = 0.2


def _bn(name: str, n: int, out: list, weight: float = 1.0) -> None:
    out += [(f"{name}.weight", (n,), ("const", weight)), (f"{name}.bias", (n,), ("const", 0.0)),
            (f"{name}.running_mean", (n,), ("const", 0.0)),
            (f"{name}.running_var", (n,), ("const", 1.0))]


def _conv(name: str, cout: int, cin: int, k: int, out: list) -> None:
    out.append((name, (cout, cin, k, k), ("normal", math.sqrt(2.0 / (cin * k * k)))))


def _dense(name: str, n_out: int, n_in: int, std: float, out: list) -> None:
    out += [(f"{name}.weight", (n_out, n_in), ("normal", std)),
            (f"{name}.bias", (n_out,), ("const", 0.0))]


def _ln(name: str, n: int, out: list) -> None:
    out += [(f"{name}.weight", (n,), ("const", 1.0)), (f"{name}.bias", (n,), ("const", 0.0))]


def layout(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(name, shape, (rule, value)) of every tensor, in a fixed order."""
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
    std = cfg["initializer_range"]
    ffn = d * cfg["ffn_scale_factor"]
    out += [("input_proj.weight", (d, 2048, 1, 1), ("normal", math.sqrt(2.0 / (2048 + d)))),
            ("input_proj.bias", (d,), ("const", 0.0)),
            ("object_query_embedding.weight", (cfg["num_object_queries"], d), ("normal", std))]

    def attention(name):
        for proj in ("query_proj", "key_proj", "value_proj", "output_proj"):
            _dense(f"{name}.{proj}", d, d, std, out)

    for i in range(cfg["num_encoder_layers"]):
        q = f"encoder.layers.{i}."
        _ln(q + "norm1", d, out)
        attention(q + "self_attention")
        _ln(q + "norm2", d, out)
        _dense(q + "ffn.layers.0", ffn, d, std, out)
        _dense(q + "ffn.layers.3", d, ffn, std, out)
    _ln("encoder.norm", d, out)
    for i in range(cfg["num_decoder_layers"]):
        q = f"decoder.layers.{i}."
        _ln(q + "norm1", d, out)
        attention(q + "self_attention")
        _ln(q + "norm2", d, out)
        attention(q + "cross_attention")
        _ln(q + "norm3", d, out)
        _dense(q + "ffn.layers.0", ffn, d, std, out)
        _dense(q + "ffn.layers.3", d, ffn, std, out)
    _ln("decoder.norm", d, out)
    c1 = cfg["num_classes"] + 1
    _dense("class_embedding", c1, d, math.sqrt(2.0 / (d + c1)), out)
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
        else:
            out[name] = torch.full(shape, value, dtype=torch.float32, device=device)
    return out
