"""Plain padding-masked attention in PyTorch, forward and backward
(counterparts of ``detr_tpu/ops/attention.py:scaled_dot_product_attention``
and of the Pallas kernels' arithmetic in ``detr_tpu/ops/pallas_attention.py``).

Written in fp32 whatever the input dtype: scores q·kᵀ/√D, padded keys filled
with ``finfo(float32).min`` (not -inf, so a fully masked row comes out as the
uniform mean of V, as in JAX), an fp32 softmax, optional hash dropout on the
probabilities (``ops.dropout.attention_keep``, scaled by a multiply with
1/(1-rate)), the probabilities cast to V's dtype before P·V as the Pallas
kernel does, and the pre-dropout row log-sum-exp.  These are the CPU path of
``ops.masked_attention`` and the versions its CUDA kernels are held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from detr_tpu_torch.ops.dropout import attention_keep

F32_MIN = torch.finfo(torch.float32).min


def _scores(q, k, key_padding_mask, scale):
    scores = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], F32_MIN)
    return scores


def _scale(q, scale):
    return 1.0 / q.shape[-1] ** 0.5 if scale is None else scale


def _keep(q, k, seed, dropout_rate, hash_base):
    B, L, H, _ = q.shape
    b_off, h_off, h_total = (0, 0, H) if hash_base is None else hash_base
    return attention_keep(seed, B, H, L, k.shape[1], dropout_rate, q.device,
                          b_off=b_off, h_off=h_off, h_total=h_total)


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    seed: int = 0,
    dropout_rate: float = 0.0,
    scale: Optional[float] = None,
    hash_base: Optional[tuple[int, int, int]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, L, H, D) queries, (B, S, H, D) keys/values, optional (B, S) bool
    mask (True = padded key) -> (out (B, L, H, D) in q's dtype,
    lse (B, H, L) fp32).  ``scale`` multiplies q·kᵀ, 1/√D by default;
    ``hash_base`` (b_off, h_off, H_total) places the heads in the dropout
    hash (``ops.dropout.attention_keep``), None being (0, 0, H)."""
    scores = _scores(q, k, key_padding_mask, _scale(q, scale))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    denom = e.sum(dim=-1, keepdim=True)
    probs = e / denom
    if dropout_rate > 0.0:
        keep = _keep(q, k, seed, dropout_rate, hash_base)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_rate)), 0.0)
    out = torch.einsum("bhls,bshd->blhd", probs.to(v.dtype).float(), v.float())
    lse = (m + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def scaled_dot_product_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],
    g: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    seed: int = 0,
    dropout_rate: float = 0.0,
    scale: Optional[float] = None,
    hash_base: Optional[tuple[int, int, int]] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) in the inputs' dtypes for the output gradient
    g (B, L, H, D), from the forward's out and lse.

    P is rebuilt from the saved lse as exp(s - lse), except on a fully
    masked row, whose lse saturates to exactly finfo(float32).min: there P is
    the uniform 1/S the forward used (the single-kernel Pallas backward's
    answer; an lse rebuild alone would give 1 per key).  The dropout mask is
    regenerated from the seed; δ = rowsum(g∘out) in fp32; dS = P∘(dP_d − δ)
    is cast to the input dtype before the dQ and dK products; all sums fp32.
    ``scale`` and ``hash_base`` are the forward's."""
    S = k.shape[1]
    scale = _scale(q, scale)
    scores = _scores(q, k, key_padding_mask, scale)
    lse4 = lse[..., None]
    p = torch.where(lse4 == F32_MIN, 1.0 / S, torch.exp(scores - lse4))
    gf = g.float()
    dp = torch.einsum("blhd,bshd->bhls", gf, v.float())
    p_d = p
    if dropout_rate > 0.0:
        keep = _keep(q, k, seed, dropout_rate, hash_base)
        inv = 1.0 / (1.0 - dropout_rate)
        p_d = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = torch.einsum("bhls,blhd->bshd", p_d, gf)
    delta = (gf * out.float()).sum(-1).transpose(1, 2)[..., None]  # (B, H, L, 1)
    ds = p * (dp - delta)
    dq = torch.einsum("bhls,bshd->blhd", ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.einsum("bhls,blhd->bshd", ds.to(q.dtype).float(), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# A bf16 result agrees with its plain version when no element is more than
# one bf16 ulp away (see bf16_agreement) and at most 1 % of the elements
# differ at all.
BF16_MAX_ULPS = 1.0
BF16_MAX_SHARE = 0.01


def bf16_agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(largest |got - want| in bf16 ulps, share of elements that differ) for
    two bf16 tensors of one shape.  An element's ulp is that of its plain
    value ``want``, or of a quarter of the largest |want| where the element
    is smaller than that.

    Kernels that sum the same fp32 terms in another order (tensor cores, for
    one) move each sum by ~1e-7 of its terms, and now and then a bf16 dS term
    rounds to its other neighbour, which moves the sums it enters by one bf16
    ulp of that term.  That flips the final bf16 rounding of well under 1 %
    of the elements, by one ulp of a large element; a small element whose
    sum cancelled is moved by the same absolute amount, which can be many of
    its own ulps, hence the floor (the H100 runs of ``chip_smoke.py`` are in
    ``PERF.md``).  A fault in the bf16 arithmetic (dS left in fp32, P_d
    rounded to one bf16 value) moves every term by ~1e-3 of itself and flips
    26-43 % of the elements (``tests/test_torch_port_attention_bwd.py``)."""
    got, want = got.detach().float(), want.detach().float()  # bf16 is exact in fp32
    ref = torch.maximum(want.abs(), want.abs().max() / 4)
    _, exp = torch.frexp(ref)  # ref in [2^(exp-1), 2^exp): ulp 2^(exp-8)
    ulp = torch.exp2((exp - 8).clamp(min=-133).float())
    ulp = torch.where(ref == 0, 2.0**-133, ulp)  # an all-zero gradient: the subnormal spacing
    ulps = (got - want).abs() / ulp
    return float(ulps.max()), float((got != want).float().mean())
