"""Padding-masked attention with hash dropout: the CUDA kernels, their plain
versions, and the autograd Function that joins forward and backward.

Counterpart of ``detr_tpu/ops/pallas_attention.py::pallas_masked_attention``:
the forward replaces the Pallas ``_fwd_kernel`` (``csrc/masked_attention_fwd.cu``:
in bf16 a two-pass kernel on tensor cores, in fp32 scalar FMAs),
the backward replaces ``_bwd_kernel``, ``_bwd_dkv_kernel`` and
``_bwd_dq_kernel`` with one design for every S (``csrc/masked_attention_bwd.cu``:
a dK/dV kernel and a dQ kernel; in bf16 on tensor cores, in fp32 with scalar
FMAs).  A CPU tensor goes to the plain PyTorch versions in ``ops.attention``;
a CUDA tensor goes to the kernels or raises.

The kernels are built for head size 32 (256 / 8 in DETR-R50 and its
variants); the Pallas kernel takes any D.  A smaller D (``--tiny``'s 8,
say) is zero-padded to 32 before the launch, with the true scale 1/√D
passed in, and the outputs and gradients are sliced back: zero columns add
nothing to q·kᵀ, zero columns of V give zero outputs, and the gradients of
the padding are dropped, so the function is unchanged.  D = 32 launches on
the inputs as they are.

``hash_base = (b_off, h_off, H_total)`` places a call's heads in a larger
array for the dropout hash: local head (b, h) draws the mask of global head
``(b_off + b) * H_total + h_off + h``, so a rank that holds a block of the
batch (data parallelism) or of the heads (tensor parallelism) drops exactly
what one process would on the whole array.  None is (0, 0, H).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from detr_tpu_torch.ops._build import kernel, launch
from detr_tpu_torch.ops.attention import (
    scaled_dot_product_attention,
    scaled_dot_product_attention_backward,
)
from detr_tpu_torch.ops.dropout import keep_threshold
from detr_tpu_torch.utils.profiling import span

# The plain versions: fp32 arithmetic, what the CPU path runs and the kernels
# are held against.
masked_attention_reference = scaled_dot_product_attention
masked_attention_backward_reference = scaled_dot_product_attention_backward

HEAD_SIZE = 32  # the kernels' D; a smaller D is zero-padded to it
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset, for checking the main path
# (``utils.profiling.counters()`` reads them as ``attention.*``).
launches = 0  # forward
launches_bwd_dkv = 0
launches_bwd_dq = 0

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _U = ctypes.c_float, ctypes.c_uint


def _dropout_args(seed: int, dropout_rate: float) -> tuple[int, int, float, int]:
    if dropout_rate <= 0.0:
        return 0, 0, 1.0, 0
    return seed & 0xFFFFFFFF, keep_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate), 1


def _hash_args(hash_base: Optional[tuple[int, int, int]], H: int) -> tuple[int, int, int]:
    """(b_off, h_off, H_total) for the C entry points; None is one process's."""
    if hash_base is None:
        return 0, 0, H
    b_off, h_off, h_total = (int(x) for x in hash_base)
    if b_off < 0 or h_off < 0 or h_off + H > h_total:
        raise ValueError(f"hash base {hash_base} does not hold {H} heads")
    return b_off, h_off, h_total


def _check_card(q, k, v, D):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D > HEAD_SIZE:
        raise ValueError(f"the kernel takes head size at most {HEAD_SIZE}, got {D}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")


def _pad_head(x):
    """(B, L, H, D) -> (B, L, H, HEAD_SIZE), zeros past D (a new, aligned
    tensor)."""
    return torch.nn.functional.pad(x, (0, HEAD_SIZE - x.shape[-1]))


def _aligned(x):
    """x contiguous, its data 16-byte aligned: the bf16 kernels copy 16-byte
    chunks of each row."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _rows_aligned(x):
    """Whether every (b, l, h) row of bf16 x starts on 16 bytes."""
    return x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:3])


def forward_cuda(q, k, v, mask, seed, dropout_rate, hash_base=None):
    """The forward kernel -> (out, lse), for any head size up to 32."""
    D = q.shape[-1]
    _check_card(q, k, v, D)
    if min(q.stride(-1), k.stride(-1), v.stride(-1)) != 1:
        raise ValueError("the last dim of q, k and v must be contiguous")
    if D < HEAD_SIZE:
        out, lse = _forward_launch(*(_pad_head(x) for x in (q, k, v)), mask, seed,
                                   dropout_rate, 1.0 / D**0.5, hash_base)
        return out[..., :D].contiguous(), lse
    if q.dtype == torch.bfloat16:
        q, k, v = (x if _rows_aligned(x) else _aligned(x) for x in (q, k, v))
    return _forward_launch(q, k, v, mask, seed, dropout_rate, 1.0 / D**0.5, hash_base)


def _forward_launch(q, k, v, mask, seed, dropout_rate, scale, hash_base=None):
    global launches
    B, Lq, H, D = q.shape
    S = k.shape[1]
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    fn = kernel("masked_attention_fwd", "masked_attention_fwd",
                [_PTR] * 6 + [_INT] * 5 + [_LL] * 9 + [_F, _U, _U, _F] + [_INT] * 5 + [_PTR])
    launch(
        fn, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        B, H, Lq, S, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        scale, *_dropout_args(seed, dropout_rate), *_hash_args(hash_base, H), _DTYPES[q.dtype],
    )
    launches += 1
    return out, lse


def backward_inputs(q, k, v, g, out):
    """The backward kernels' inputs: q, k, v and g contiguous and 16-byte
    aligned in q's dtype, zero-padded to head size 32, and δ = rowsum(g∘out)
    (B, H, L) in fp32, computed here as JAX computes it outside its kernels
    (the padding adds nothing to it).  Pass the kernels the scale of the
    unpadded D."""
    _check_card(q, k, v, q.shape[-1])
    g = g.to(q.dtype)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    fit = _aligned if q.shape[-1] == HEAD_SIZE else _pad_head
    q, k, v, g = (fit(x) for x in (q, k, v, g))
    return q, k, v, g, delta


_BWD_TYPES = [_PTR] * 9 + [_INT] * 5 + [_F, _U, _U, _F] + [_INT] * 5 + [_PTR]


def _bwd_launch(name, q, k, v, mask, g, lse, delta, out0, out1, seed, dropout_rate, scale,
                hash_base):
    B, Lq, H, D = q.shape
    scale = 1.0 / D**0.5 if scale is None else scale
    launch(
        kernel("masked_attention_bwd", name, _BWD_TYPES), q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), out0, out1,
        B, H, Lq, k.shape[1], D, scale, *_dropout_args(seed, dropout_rate),
        *_hash_args(hash_base, H), _DTYPES[q.dtype],
    )


def bwd_dkv_cuda(q, k, v, mask, g, lse, delta, seed, dropout_rate, scale=None, hash_base=None):
    """The dK/dV kernel on ``backward_inputs``' tensors -> (dk, dv); ``scale``
    is the forward's, 1/√D of q's D by default, and ``hash_base`` too."""
    global launches_bwd_dkv
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("masked_attention_bwd_dkv", q, k, v, mask, g, lse, delta,
                dk.data_ptr(), dv.data_ptr(), seed, dropout_rate, scale, hash_base)
    launches_bwd_dkv += 1
    return dk, dv


def bwd_dq_cuda(q, k, v, mask, g, lse, delta, seed, dropout_rate, scale=None, hash_base=None):
    """The dQ kernel on ``backward_inputs``' tensors -> dq."""
    global launches_bwd_dq
    dq = torch.empty_like(q)
    _bwd_launch("masked_attention_bwd_dq", q, k, v, mask, g, lse, delta,
                dq.data_ptr(), None, seed, dropout_rate, scale, hash_base)
    launches_bwd_dq += 1
    return dq


def backward_cuda(q, k, v, mask, g, out, lse, seed, dropout_rate, hash_base=None):
    """Both backward kernels -> (dq, dk, dv), for any head size up to 32."""
    D = q.shape[-1]
    q, k, v, g, delta = backward_inputs(q, k, v, g, out)
    scale = 1.0 / D**0.5
    dk, dv = bwd_dkv_cuda(q, k, v, mask, g, lse, delta, seed, dropout_rate, scale, hash_base)
    dq = bwd_dq_cuda(q, k, v, mask, g, lse, delta, seed, dropout_rate, scale, hash_base)
    if D < HEAD_SIZE:
        return tuple(x[..., :D].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


class MaskedAttention(torch.autograd.Function):
    """out, lse = attention(q, k, v); the backward regenerates the dropout
    mask from the seed and rebuilds P from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, dropout_rate, hash_base):
        if q.device.type == "cpu":
            out, lse = masked_attention_reference(q, k, v, mask, seed, dropout_rate,
                                                  hash_base=hash_base)
        else:
            out, lse = forward_cuda(q, k, v, mask, seed, dropout_rate, hash_base)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.seed, ctx.dropout_rate, ctx.hash_base = seed, dropout_rate, hash_base
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = masked_attention_backward_reference(
                q, k, v, mask, g, out, lse, ctx.seed, ctx.dropout_rate, hash_base=ctx.hash_base)
        else:
            grads = backward_cuda(q, k, v, mask, g, out, lse, ctx.seed, ctx.dropout_rate,
                                  ctx.hash_base)
        return (*grads, None, None, None, None)


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    hash_base: Optional[tuple[int, int, int]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, L, H, D) queries, (B, S, H, D) keys/values, optional (B, S) bool
    mask (True = padded key), attention-probability dropout at
    ``dropout_rate`` seeded by ``seed`` (a uint32), its heads placed by
    ``hash_base`` (module docstring) -> (out (B, L, H, D) in q's dtype,
    lse (B, H, L) fp32, pre-dropout).  Differentiable in q, k, v."""
    B, Lq, H, D = q.shape
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if S < 1 or Lq < 1:
        raise ValueError("empty query or key sequence")
    if key_padding_mask is not None:
        if key_padding_mask.shape != (B, S) or key_padding_mask.dtype != torch.bool:
            raise ValueError("key_padding_mask must be (B, S) bool")
        key_padding_mask = key_padding_mask.to(q.device).contiguous()
    if dropout_rate > 0.0 and seed is None:
        # a constant seed would reuse one mask every step (JAX's contract)
        raise ValueError("dropout_rate > 0 requires a seed")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    _hash_args(hash_base, H)  # raises on a base that cannot hold these heads
    with span("attention"):
        return MaskedAttention.apply(q, k, v, key_padding_mask, seed or 0, float(dropout_rate),
                                     None if hash_base is None else tuple(hash_base))
