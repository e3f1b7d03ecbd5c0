"""Resampling images on the card (counterpart of
``detr_tpu/ops/device_resize.py``): the device-resize wire's other half.

The loader ships each image at its SOURCE resolution (uint8, padded into a
per-bucket source canvas) with the size the augmentation chose for it, and
the train and eval steps resample it here: 2.5-3.3x fewer bytes to copy to
the card than the augmented canvas, and no resample on the host.

  * separable resampling as two batched fp32 products per image,
    ``out = Wh @ img @ Ww^T``, rows first as the JAX package computes them;
  * each image's (dst, src) weight matrix is built from its true source and
    target extents: a triangle (bilinear) filter whose support is stretched
    by the downscale factor (antialias), PIL's pixel centres
    (``(i + 0.5) / scale``), normalised over the taps inside the true source
    extent, so the source canvas's zero padding has no effect;
  * rows and columns beyond the target extent come out exactly zero;
  * src == dst gives a permutation matrix, so such an image passes through
    bit for bit.

These are plain large products that the JAX package computes outside any
Pallas kernel, on cuBLAS here.  They run in true fp32, whatever the process
sets for TF32 or autocast: TF32 would move the result by 0.1-0.25 uint8
levels, fp32 keeps it within ~1e-4 of the CPU's.
"""

from __future__ import annotations

import contextlib

import torch


def _axis_weights(dst_size: int, src_size: int, dst_true: torch.Tensor,
                  src_true: torch.Tensor) -> torch.Tensor:
    """(B, dst_size, src_size) fp32 resampling matrices for one axis: row d
    of image b holds the weights that map its true ``src_true[b]`` extent
    onto its true ``dst_true[b]`` extent; zero outside either extent."""
    dev = dst_true.device
    src_f = src_true.to(torch.float32)[:, None, None]
    dst_f = dst_true.to(torch.float32)[:, None, None]
    scale = dst_f / torch.clamp(src_f, min=1.0)
    # PIL's antialias: the filter's support (1 for bilinear) times the
    # downscale factor.
    support = torch.clamp(1.0 / torch.clamp(scale, min=1e-6), min=1.0)
    d = torch.arange(dst_size, dtype=torch.float32, device=dev)[None, :, None]
    s = torch.arange(src_size, dtype=torch.float32, device=dev)[None, None, :]
    center = (d + 0.5) / scale  # in source coordinates
    w = torch.clamp(1.0 - torch.abs(s + 0.5 - center) / support, min=0.0)
    w = torch.where((s < src_f) & (d < dst_f), w, 0.0)
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)


@contextlib.contextmanager
def _true_fp32(device: torch.device):
    """fp32 products at full precision (no TF32, no autocast), the
    process's setting restored after."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.autocast(device.type, enabled=False):
            yield
    finally:
        torch.set_float32_matmul_precision(previous)


def resize_on_device(
    images: torch.Tensor,  # (B, SH, SW, C) uint8 or float: the padded source canvas
    src_h: torch.Tensor,  # (B,) true source extents
    src_w: torch.Tensor,
    dst_h: torch.Tensor,  # (B,) true target extents (the augmented sizes)
    dst_w: torch.Tensor,
    canvas: tuple[int, int],  # (CH, CW) output canvas
) -> torch.Tensor:
    """Each image resampled from (src_h, src_w) to (dst_h, dst_w) into a
    (B, CH, CW, C) fp32 canvas, zero outside each image's target extent.

    At B=5 from a 512x672 source canvas onto 832x1344 this is ~31 GFLOP of
    fp32 products (~37 from 672x672 onto 1056x1056), and the intermediate
    (B, CH, SW, C) is ~34 MB."""
    ch, cw = canvas
    _, sh, sw, _ = images.shape
    with _true_fp32(images.device):
        x = images.to(torch.float32)
        wh = _axis_weights(ch, sh, dst_h, src_h)
        ww = _axis_weights(cw, sw, dst_w, src_w)
        tmp = torch.einsum("bds,bswc->bdwc", wh, x)
        return torch.einsum("bdwc,bew->bdec", tmp, ww)
