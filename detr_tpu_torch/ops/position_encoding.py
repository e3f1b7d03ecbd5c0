"""2D sine/cosine positional embeddings, fp32, channels-last.

Counterpart of ``detr_tpu/ops/position_encoding.py``: per-image x/y grids are
``linspace(0, 1, n)`` over the valid region and zero outside it, scaled by
2*pi, with frequencies ``temperature ** (2i / num_pos_feats)``; sin and cos
interleave, and the y features come before the x features.
"""

from __future__ import annotations

import math

import torch


def _interleaved_sincos(
    coords: torch.Tensor, num_pos_feats: int, temperature: float
) -> torch.Tensor:
    """coords (…,) in [0,1] -> (…, num_pos_feats) interleaved sin/cos."""
    coords = coords.float() * (2.0 * math.pi)
    exponents = (
        torch.arange(0, num_pos_feats, 2, dtype=torch.float32, device=coords.device)
        / num_pos_feats
    )
    # A fill on the device (torch.tensor would copy from the host and wait).
    dim_t = torch.pow(torch.full((), float(temperature), device=coords.device), exponents)
    phase = coords[..., None] / dim_t
    both = torch.stack([torch.sin(phase), torch.cos(phase)], dim=-1)
    return both.reshape(*phase.shape[:-1], num_pos_feats)


def _valid_linspace_grid(n_valid: torch.Tensor, size: int) -> torch.Tensor:
    """(B,) valid extents -> (B, size) fp32 ``linspace(0, 1, n)`` zero-padded."""
    idx = torch.arange(size, dtype=torch.float32, device=n_valid.device)[None, :]
    n = n_valid.float()[:, None]
    denom = torch.clamp(n - 1.0, min=1.0)
    return torch.where(idx < n, idx / denom, torch.zeros((), device=n_valid.device))


def batch_positional_encoding(
    feat_height: int,
    feat_width: int,
    valid_heights: torch.Tensor,
    valid_widths: torch.Tensor,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
) -> torch.Tensor:
    """(B,) valid extents in feature cells ->
    (B, feat_height, feat_width, 2 * num_pos_feats) fp32."""
    device = valid_heights.device
    gx = _valid_linspace_grid(valid_widths, feat_width)  # (B, W)
    gy = _valid_linspace_grid(valid_heights, feat_height)  # (B, H)
    row_valid = torch.arange(feat_height, device=device)[None, :] < valid_heights[:, None]
    col_valid = torch.arange(feat_width, device=device)[None, :] < valid_widths[:, None]
    inside = row_valid[:, :, None] & col_valid[:, None, :]  # (B, H, W)
    zero = torch.zeros((), device=device)
    grid_x = torch.where(inside, gx[:, None, :], zero)
    grid_y = torch.where(inside, gy[:, :, None], zero)
    pos_x = _interleaved_sincos(grid_x, num_pos_feats, temperature)
    pos_y = _interleaved_sincos(grid_y, num_pos_feats, temperature)
    return torch.cat([pos_y, pos_x], dim=-1)


def scaled_valid_extent(image_extent: torch.Tensor, stride: int) -> torch.Tensor:
    """``ceil(extent / stride)`` as int32."""
    return torch.ceil(image_extent.float() / float(stride)).to(torch.int32)


def sine_position_embedding(
    feat_height: int,
    feat_width: int,
    image_heights: torch.Tensor,
    image_widths: torch.Tensor,
    stride: int = 32,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
) -> torch.Tensor:
    """Pixel extents -> (B, feat_height, feat_width, 2 * num_pos_feats) fp32."""
    return batch_positional_encoding(
        feat_height,
        feat_width,
        scaled_valid_extent(image_heights, stride),
        scaled_valid_extent(image_widths, stride),
        num_pos_feats,
        temperature,
    )
