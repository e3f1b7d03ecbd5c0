"""DETR's forward in plain fp32 PyTorch, over a flat state dict.

The architecture as the configuration states it (arXiv:2005.12872 with the
port's stated departures, listed in each configuration file):

- ResNet-50 trunk with frozen BatchNorm, NCHW; DC5 (``dilation``) trades the
  last stage's stride for dilation 2, its first block keeping dilation 1;
- a 1x1 projection to ``hidden_size``;
- sine positions over each image's valid feature cells: per axis
  ``linspace(0, 1, n)`` over the n valid cells (zero outside), times 2*pi,
  frequencies ``temperature ** (2i / (d/2))``, sin and cos interleaved, the y
  features before the x features; the padding mask covers every cell past
  ``ceil(extent / stride)`` on either axis;
- a pre-LayerNorm encoder and decoder (GELU(tanh) FFN, final LayerNorm each;
  the decoder starts from zeros and its final norm is applied to every
  layer's output);
- a linear class head over C+1 classes and a 3-layer GELU MLP box head with
  a sigmoid, on every decoder layer.

Dropout in train mode draws one seed per site from a CPU generator, in the
order the layers run: per attention block the probabilities' seed, then the
residual's; per FFN the hidden slot's, then the output slot's.

``Precision`` rounds the operands of every product the configuration
computes in its low precision (convolutions, the transformer's Dense layers,
attention's q.k and P.v); ``FP32`` leaves them as they are, ``FP8`` rounds
each to float8 e4m3 with a per-tensor scale, forward and backward: the
control of the correctness check.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import dropout as hd

F32_MIN = torch.finfo(torch.float32).min
STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


class Precision:
    """Identity: every product in fp32."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Float8(Precision):
    """Operands rounded to float8 e4m3 (per-tensor scale), gradients too."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundFP8.apply(x)


FP32 = Precision()
FP8 = Float8()


class Seeds:
    """The dropout seeds of one forward, drawn once and replayed for every
    block of rows (a block passes its first row as ``row_offset``)."""

    def __init__(self, seeds: list[int]):
        self.seeds = seeds

    @classmethod
    def draw(cls, generator: torch.Generator, count: int) -> "Seeds":
        return cls([hd.draw_seed(generator) for _ in range(count)])

    def stream(self) -> Iterator[int]:
        return iter(self.seeds)


def seeds_per_forward(cfg: dict) -> int:
    """Dropout sites of one forward: 4 per encoder layer, 6 per decoder layer."""
    return 4 * cfg["num_encoder_layers"] + 6 * cfg["num_decoder_layers"]


class Ctx:
    """What one forward threads through its layers."""

    def __init__(self, sd: dict, cfg: dict, P: Precision, seeds: Optional[Iterator[int]],
                 row_offset: int):
        self.sd, self.cfg, self.P = sd, cfg, P
        self.seeds, self.row_offset = seeds, row_offset
        self.train = seeds is not None

    def drop(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if not self.train or rate == 0.0:
            return x
        keep = hd.element_keep(next(self.seeds), x.shape, rate, x.device, self.row_offset)
        return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0)


# ------------------------------------------------------------------- trunk


def _conv(c: Ctx, x, name, stride=1, dilation=1):
    w = c.sd[name]
    k = w.shape[-1]
    pad = dilation * (k - 1) // 2
    return F.conv2d(c.P(x), c.P(w), None, stride, pad, dilation)


def _bn(c: Ctx, x, name, eps=1e-5):
    sd = c.sd
    scale = sd[name + ".weight"] * torch.rsqrt(sd[name + ".running_var"] + eps)
    bias = sd[name + ".bias"] - sd[name + ".running_mean"] * scale
    return x * scale[None, :, None, None] + bias[None, :, None, None]


def trunk(c: Ctx, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) normalised -> (B, 2048, H/32, W/32), or H/16 for DC5."""
    p = "backbone.backbone."
    x = F.relu(_bn(c, _conv(c, x, p + "conv1.weight", stride=2), p + "bn1"))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    dc5 = c.cfg["dilation"]
    for stage, n in enumerate(STAGES[c.cfg["backbone"]], start=1):
        for b in range(n):
            q = f"{p}layer{stage}.{b}."
            stride = 1 if (b > 0 or stage == 1 or (dc5 and stage == 4)) else 2
            dil = 2 if (dc5 and stage == 4 and b > 0) else 1
            y = F.relu(_bn(c, _conv(c, x, q + "conv1.weight"), q + "bn1"))
            y = F.relu(_bn(c, _conv(c, y, q + "conv2.weight", stride, dil), q + "bn2"))
            y = _bn(c, _conv(c, y, q + "conv3.weight"), q + "bn3")
            if b == 0:
                x = _bn(c, _conv(c, x, q + "downsample.0.weight", stride), q + "downsample.1")
            x = F.relu(y + x)
    return x


# ------------------------------------------------------------- positions


def valid_cells(extent: torch.Tensor, stride: int) -> torch.Tensor:
    return torch.ceil(extent.double() / stride).long()


def _axis(n_valid: torch.Tensor, size: int) -> torch.Tensor:
    idx = torch.arange(size, dtype=torch.float32, device=n_valid.device)[None, :]
    n = n_valid.float()[:, None]
    return torch.where(idx < n, idx / torch.clamp(n - 1.0, min=1.0), 0.0)


def _sincos(coord: torch.Tensor, feats: int, temperature: float) -> torch.Tensor:
    exps = torch.arange(0, feats, 2, dtype=torch.float32, device=coord.device) / feats
    freq = torch.pow(torch.tensor(float(temperature), device=coord.device), exps)
    phase = (coord * (2.0 * math.pi))[..., None] / freq
    return torch.stack([torch.sin(phase), torch.cos(phase)], -1).flatten(-2)


def positions_and_mask(fh: int, fw: int, heights, widths, stride: int, d: int,
                       temperature: float):
    """(B, fh*fw, d) fp32 positions and (B, fh*fw) bool padding mask."""
    vh, vw = valid_cells(heights, stride), valid_cells(widths, stride)
    dev = heights.device
    rows = torch.arange(fh, device=dev)[None, :] < vh[:, None]
    cols = torch.arange(fw, device=dev)[None, :] < vw[:, None]
    inside = rows[:, :, None] & cols[:, None, :]
    gx = torch.where(inside, _axis(vw, fw)[:, None, :], 0.0)
    gy = torch.where(inside, _axis(vh, fh)[:, :, None], 0.0)
    pos = torch.cat([_sincos(gy, d // 2, temperature), _sincos(gx, d // 2, temperature)], -1)
    B = heights.shape[0]
    return pos.reshape(B, fh * fw, d), (~inside).reshape(B, fh * fw)


# ------------------------------------------------------------ transformer


def _linear(c: Ctx, x, name, low=True):
    w, b = c.sd[name + ".weight"], c.sd[name + ".bias"]
    if low:
        return F.linear(c.P(x), c.P(w), b)
    return F.linear(x, w, b)


def _norm(c: Ctx, x, name):
    return F.layer_norm(x, (x.shape[-1],), c.sd[name + ".weight"], c.sd[name + ".bias"],
                        c.cfg["layer_norm_eps"])


def _attention(c: Ctx, query, key, value, mask, name):
    cfg = c.cfg
    B, L, d = query.shape
    S = key.shape[1]
    H = cfg["num_attention_heads"]
    D = d // H
    q = _linear(c, query, name + ".query_proj").reshape(B, L, H, D)
    k = _linear(c, key, name + ".key_proj").reshape(B, S, H, D)
    v = _linear(c, value, name + ".value_proj").reshape(B, S, H, D)
    scores = torch.einsum("blhd,bshd->bhls", c.P(q), c.P(k)) / math.sqrt(D)
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, None, :], F32_MIN)
    probs = torch.softmax(scores, dim=-1)
    rate = cfg["attention_probs_dropout_prob"]
    if c.train and rate > 0.0:
        keep = hd.attention_keep(next(c.seeds), B, H, L, S, rate, query.device, c.row_offset)
        probs = torch.where(keep, probs * (1.0 / (1.0 - rate)), 0.0)
    out = torch.einsum("bhls,bshd->blhd", c.P(probs), c.P(v)).reshape(B, L, d)
    out = _linear(c, out, name + ".output_proj")
    return c.drop(out, cfg["hidden_dropout_prob"])


def _ffn(c: Ctx, x, name):
    rate = c.cfg["hidden_dropout_prob"]
    h = c.drop(F.gelu(_linear(c, x, name + ".layers.0"), approximate="tanh"), rate)
    return c.drop(_linear(c, h, name + ".layers.3"), rate)


def encoder(c: Ctx, x, pos, mask):
    for i in range(c.cfg["num_encoder_layers"]):
        p = f"encoder.layers.{i}."
        xa = _norm(c, x, p + "norm1")
        qk = xa + pos
        x = x + _attention(c, qk, qk, xa, mask, p + "self_attention")
        x = x + _ffn(c, _norm(c, x, p + "norm2"), p + "ffn")
    return _norm(c, x, "encoder.norm")


def decoder(c: Ctx, memory, pos, mask):
    qe = c.sd["object_query_embedding.weight"][None].expand(memory.shape[0], -1, -1)
    x = torch.zeros_like(qe)
    outs = []
    for i in range(c.cfg["num_decoder_layers"]):
        p = f"decoder.layers.{i}."
        xa = _norm(c, x, p + "norm1")
        qk = xa + qe
        x = x + _attention(c, qk, qk, xa, None, p + "self_attention")
        q = _norm(c, x, p + "norm2") + qe
        x = x + _attention(c, q, memory + pos, memory, mask, p + "cross_attention")
        x = x + _ffn(c, _norm(c, x, p + "norm3"), p + "ffn")
        outs.append(_norm(c, x, "decoder.norm"))
    return torch.stack(outs, dim=1)  # (B, L, Q, d)


def forward(sd: dict, cfg: dict, images: torch.Tensor, heights: torch.Tensor,
            widths: torch.Tensor, P: Precision = FP32, seeds: Optional[Seeds] = None,
            row_offset: int = 0) -> dict[str, torch.Tensor]:
    """images (B, H, W, 3) fp32 normalised, zero outside each image; heights
    and widths (B,) the valid pixel extents.  ``seeds`` turns on train-mode
    dropout; ``row_offset`` is the block's first row in its batch.
    -> pred_logits (B, L, Q, C+1), pred_boxes (B, L, Q, 4) cxcywh."""
    c = Ctx(sd, cfg, P, None if seeds is None else seeds.stream(), row_offset)
    feats = trunk(c, images.permute(0, 3, 1, 2))
    B, _, fh, fw = feats.shape
    w = sd["input_proj.weight"].flatten(1)
    x = F.linear(P(feats.permute(0, 2, 3, 1)), P(w), sd["input_proj.bias"])
    x = x.reshape(B, fh * fw, -1)
    stride = 16 if cfg["dilation"] else 32
    pos, mask = positions_and_mask(fh, fw, heights, widths, stride, cfg["hidden_size"],
                                   cfg["temperature"])
    memory = encoder(c, x, pos, mask)
    hs = decoder(c, memory, pos, mask)
    logits = _linear(c, hs, "class_embedding", low=False)
    h = hs
    n = cfg["box_embedding_mlp_num_layers"]
    for i in range(n):
        h = _linear(c, h, f"bbox_embedding.net.{2 * i}", low=False)
        if i < n - 1:
            h = F.gelu(h, approximate="tanh")
    return {"pred_logits": logits, "pred_boxes": torch.sigmoid(h)}


def no_tf32() -> Callable[[], None]:
    """Turn TF32 off for matmuls and convolutions; returns the undo."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    def undo():
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])

    return undo
