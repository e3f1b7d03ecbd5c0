"""Frozen-BatchNorm ResNet-50/101 backbone (counterpart of
``detr_tpu/models/resnet.py``).

torchvision module naming (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0``), so the reference ``state_dict`` loads as it is.
The trunk runs NCHW in ``channels_last`` memory, which is the JAX package's
NHWC layout under another name.  Parameters are fp32; convolutions compute in
the configured dtype; frozen BatchNorm folds its statistics into a scale and
bias in fp32 and applies them in the compute dtype.  The JAX package's
TPU-only variants (space-to-depth stem, parity-split dilated conv) have no
counterpart: they compute the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine parameters:
    y = x * scale + bias, scale = weight / sqrt(var + eps),
    bias = bias - mean * scale.  With ``calibrate`` set, the forward first
    overwrites mean and var with the statistics of its input (see
    ``calibrate_frozen_bn``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.calibrate = False
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.calibrate:
            x32 = x.float()
            self.running_mean.copy_(x32.mean(dim=(0, 2, 3)))
            self.running_var.copy_(x32.var(dim=(0, 2, 3), unbiased=False))
        rs = torch.rsqrt(self.running_var + self.eps)
        scale = (self.weight * rs).to(x.dtype)
        bias = (self.bias - self.running_mean * self.weight * rs).to(x.dtype)
        return x * scale[None, :, None, None] + bias[None, :, None, None]


class Conv(nn.Conv2d):
    """Bias-free convolution with an fp32 weight, computed in the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1):
        pad = dilation * (kernel - 1) // 2
        super().__init__(
            cin, cout, kernel, stride=stride, padding=pad, dilation=dilation, bias=False
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=x.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, None, self.stride, self.padding, self.dilation)


class Bottleneck(nn.Module):
    """torchvision bottleneck: 1x1 -> 3x3 (stride/dilation) -> 1x1 (4x)."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = Conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv(planes, out_ch, 1)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = (
            nn.Sequential(Conv(cin, out_ch, 1, stride), FrozenBatchNorm(out_ch))
            if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNetBackbone(nn.Module):
    """ResNet-50/101 trunk: (B, 3, H, W) -> (B, 2048, H/32, W/32), or H/16
    with ``dilation=True`` (DC5: the last stage trades its stride for
    dilation 2, torchvision's ``replace_stride_with_dilation=[F, F, T]``)."""

    def __init__(self, backbone: str = "resnet50", dilation: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if backbone not in _STAGES:
            raise ValueError("Only resnet50 and resnet101 backbones are supported")
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, stride=2)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for stage, (planes, stride, n) in enumerate(
            zip((64, 128, 256, 512), (1, 2, 2, 2), _STAGES[backbone]), start=1
        ):
            dilate_stage = dilation and stage == 4
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(
                    cin,
                    planes,
                    stride=(1 if dilate_stage else stride) if b == 0 else 1,
                    # the first block keeps the previous dilation
                    dilation=2 if (dilate_stage and b > 0) else 1,
                    downsample=(b == 0),
                ))
                cin = planes * 4
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return x


@torch.no_grad()
def calibrate_frozen_bn(backbone: ResNetBackbone, images: torch.Tensor) -> None:
    """One-shot frozen-BN calibration for a randomly initialised trunk
    (counterpart of ``detr_tpu/models/resnet.py::calibrate_frozen_bn``).

    Runs the trunk once on ``images`` (B, H, W, 3), normalized and
    zero-padded, with every FrozenBatchNorm overwriting its mean and var with
    the fp32 statistics of its input over (batch, height, width), in order,
    so each layer sees its upstream already calibrated.  Without it the
    identity statistics let a random trunk's activations explode (~1e4 at
    layer4).  Updates the buffers in place."""
    norms = [m for m in backbone.modules() if isinstance(m, FrozenBatchNorm)]
    for m in norms:
        m.calibrate = True
    try:
        backbone(images.permute(0, 3, 1, 2))
    finally:
        for m in norms:
            m.calibrate = False
