"""Multi-scale deformable attention (Deformable DETR, arXiv:2010.04159): the
CUDA kernels, their plain version, and the autograd Function that joins
forward and backward.

For each query and head, L levels x P points: a learned location (x, y) in
[0, 1] of the level's map and a weight (softmaxed over the L * P samples by
the caller); the output is the weighted sum of the value map sampled
bilinearly at each location, grid_sample's ``align_corners=False`` pixels
(px = x * W_l - 0.5) with zero padding (a corner outside the map adds
zero).

The plain version, ``ms_deform_attn_reference``, is the published
``ms_deform_attn_core_pytorch``: ``grid_sample`` per level, in fp32.  A CPU
tensor runs it (autograd differentiates it); a CUDA tensor goes to the
kernels (``csrc/ms_deform_attn_{fwd,bwd}.cu``, one warp per query and head,
one lane per channel, the backward scattering the value's gradient into an
fp32 buffer with atomic adds) or raises.  The kernels take head size up to
32 and up to 8 levels.

Layouts: value (B, S, H, D) in the compute dtype, S the levels' cells
flattened h-major one level after another; ``spatial_shapes`` the levels'
(H_l, W_l) as Python ints; sampling locations (B, Lq, H, L, P, 2) (x, y)
and attention weights (B, Lq, H, L, P) in fp32; out (B, Lq, H, D) in
value's dtype.  The Function's backward node is ``MSDeformAttnBackward``
in a profile.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from detr_tpu_torch.ops._build import load
from detr_tpu_torch.utils.profiling import count, span

MAX_HEAD_SIZE = 32
MAX_LEVELS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the process started, for checking the main path
# (``utils.profiling.counters()`` reads them as ``msda.*``).
launches = 0  # forward
launches_bwd = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_FWD_TYPES = [_PTR] * 4 + [_INT] * 7 + [_PTR, _INT, _PTR]
_BWD_TYPES = [_PTR] * 7 + [_INT] * 7 + [_PTR, _INT, _PTR]


def level_starts(spatial_shapes: Sequence[tuple[int, int]]) -> list[int]:
    """The first row of each level in the flattened value."""
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    return starts


def ms_deform_attn_reference(value, spatial_shapes, sampling_locations, attention_weights):
    """The plain version in fp32 (grid_sample per level) -> out in value's
    dtype; differentiable in all three tensors."""
    B, S, H, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    v = value.float()
    grids = 2.0 * sampling_locations.float() - 1.0
    sampled = []
    for lvl, ((h, w), start) in enumerate(zip(spatial_shapes, level_starts(spatial_shapes))):
        # (B, h*w, H, D) -> (B*H, D, h, w)
        v_l = v[:, start:start + h * w].permute(0, 2, 3, 1).reshape(B * H, D, h, w)
        # (B, Lq, H, P, 2) -> (B*H, Lq, P, 2)
        g_l = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v_l, g_l, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))  # (B*H, D, Lq, P)
    a = attention_weights.float().transpose(1, 2).reshape(B * H, 1, Lq, L * P)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * a).sum(-1)  # (B*H, D, Lq)
    return out.view(B, H, D, Lq).permute(0, 3, 1, 2).to(value.dtype)


def _fn(stem: str, argtypes: list) -> ctypes._CFuncPtr:
    fn = getattr(load(stem), stem)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _levels_arg(spatial_shapes):
    """(H_l, W_l, start_l) of every level as a C int array (the kernels
    check that they fit the value's rows)."""
    flat = []
    for (h, w), start in zip(spatial_shapes, level_starts(spatial_shapes)):
        flat += [int(h), int(w), int(start)]
    return (ctypes.c_int * len(flat))(*flat)


def _check_card(value, loc, attn):
    if value.device.type != "cuda":
        raise ValueError(f"unsupported device {value.device}")
    if value.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16 values, got {value.dtype}")
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise ValueError("sampling locations and attention weights must be float32")
    if loc.device != value.device or attn.device != value.device:
        raise ValueError("value, locations and weights must be on one device")
    if value.shape[-1] > MAX_HEAD_SIZE or loc.shape[3] > MAX_LEVELS:
        raise ValueError(f"the kernel takes head size <= {MAX_HEAD_SIZE} and <= {MAX_LEVELS} "
                         f"levels, got {value.shape[-1]} and {loc.shape[3]}")


def forward_cuda(value, spatial_shapes, loc, attn):
    """The forward kernel -> out (B, Lq, H, D) in value's dtype."""
    global launches
    _check_card(value, loc, attn)
    value, loc, attn = value.contiguous(), loc.contiguous(), attn.contiguous()
    B, S, H, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    out = torch.empty((B, Lq, H, D), dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        err = _fn("ms_deform_attn_fwd", _FWD_TYPES)(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
            B, S, Lq, H, D, L, P, _levels_arg(spatial_shapes), _DTYPES[value.dtype],
            torch.cuda.current_stream(value.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn_fwd launch failed: cudaError {err}")
    launches += 1
    return out


def backward_cuda(value, spatial_shapes, loc, attn, grad_out):
    """The backward kernel -> (d value in value's dtype, d locations, d
    weights in fp32)."""
    global launches_bwd
    _check_card(value, loc, attn)
    value, loc, attn = value.contiguous(), loc.contiguous(), attn.contiguous()
    grad_out = grad_out.to(value.dtype).contiguous()
    B, S, H, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    grad_value = torch.zeros((B, S, H, D), dtype=torch.float32, device=value.device)
    grad_loc = torch.empty_like(loc)
    grad_attn = torch.empty_like(attn)
    with torch.cuda.device(value.device):
        err = _fn("ms_deform_attn_bwd", _BWD_TYPES)(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), grad_out.data_ptr(),
            grad_value.data_ptr(), grad_loc.data_ptr(), grad_attn.data_ptr(),
            B, S, Lq, H, D, L, P, _levels_arg(spatial_shapes), _DTYPES[value.dtype],
            torch.cuda.current_stream(value.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn_bwd launch failed: cudaError {err}")
    launches_bwd += 1
    return grad_value.to(value.dtype), grad_loc, grad_attn


class MSDeformAttn(torch.autograd.Function):
    """out = msda(value, locations, weights) on the card; its backward is
    the backward kernel."""

    @staticmethod
    def forward(ctx, value, loc, attn, spatial_shapes):
        ctx.save_for_backward(value, loc, attn)
        ctx.spatial_shapes = spatial_shapes
        return forward_cuda(value, spatial_shapes, loc, attn)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        return (*backward_cuda(value, ctx.spatial_shapes, loc, attn, grad_out), None)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """value (B, S, H, D), the levels' (H_l, W_l), sampling locations
    (B, Lq, H, L, P, 2) and weights (B, Lq, H, L, P) in fp32 -> (B, Lq, H,
    D) in value's dtype.  Differentiable in all three tensors.  Spans
    ``msda``; counts ``msda.calls`` and ``msda.samples`` (B * Lq * H * L * P)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    B, S, H, D = value.shape
    if sampling_locations.dim() != 6 or sampling_locations.shape[-1] != 2:
        raise ValueError(f"sampling locations must be (B, Lq, H, L, P, 2), got "
                         f"{tuple(sampling_locations.shape)}")
    _, Lq, _, L, P, _ = sampling_locations.shape
    if sampling_locations.shape[:3] != (B, Lq, H) or len(spatial_shapes) != L:
        raise ValueError(f"value {tuple(value.shape)}, locations "
                         f"{tuple(sampling_locations.shape)}, {len(spatial_shapes)} levels")
    if attention_weights.shape != (B, Lq, H, L, P):
        raise ValueError(f"attention weights {tuple(attention_weights.shape)}, want "
                         f"{(B, Lq, H, L, P)}")
    if sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"the levels {list(spatial_shapes)} do not hold the value's {S} rows")
    count("msda.calls")
    count("msda.samples", B * Lq * H * L * P)
    with span("msda"):
        if value.device.type == "cpu":
            return ms_deform_attn_reference(value, spatial_shapes, sampling_locations,
                                            attention_weights)
        return MSDeformAttn.apply(value, sampling_locations, attention_weights, spatial_shapes)
