"""The bf16 agreement check that holds the attention-backward kernels to
their plain version (``ops.attention.bf16_agreement``), on the CPU.

The bf16 kernels of ``csrc/masked_attention_bwd.cu`` do their products on
tensor cores: they sum the same fp32 terms in another order than the plain
backward, and feed P_d into dV as two bf16 terms (hi + lo).  Their bf16
gradients may then differ from the plain version's by one ulp on a few
elements.  The check (at most 1 ulp on any element, at most 1 % of elements
differing) must pass that and fail a real fault in the bf16 arithmetic.
Here the kernels' order is emulated in PyTorch: s and dP summed over the
head dim in two halves of 16, dq over key tiles of 64, dk and dv over query
tiles of 64, one tile after the other.

Measured (B=2, H=2, D=32, keys partly padded, dropout 0.1; L, S = 256, 256;
100, 1092; 128, 4200), as largest ulps / share of elements differing:
- the kernels' order with hi/lo P_d: at most 0.5 ulp; dq 0.006-0.039 %,
  dk 0.001-0.007 %, dv 0.12-0.16 % of the elements;
- dS left in fp32 before the dq and dk products: dq 42-43 %, dk 26.5-27.1 %
  (1-2 ulps);
- P_d rounded to one bf16 value in dV: dv 26.1-26.9 % (1 ulp).
The share separates them; the ulp bound catches a fault confined to a few
elements.  On the H100 the kernels themselves give 0.007-0.22 % (``PERF.md``).
"""

import numpy as np
import pytest
import torch

from detr_tpu_torch.ops.attention import (
    BF16_MAX_SHARE,
    BF16_MAX_ULPS,
    F32_MIN,
    bf16_agreement,
    scaled_dot_product_attention,
    scaled_dot_product_attention_backward,
)
from detr_tpu_torch.ops.dropout import attention_keep
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

B, H, D = 2, 2, 32
RATE, SEED, TILE = 0.1, 321, 64
SIZES = [(256, 256), (100, 1092), (128, 4200)]  # (L, S): the test's, decoder cross, DC5


def _inputs(L, S):
    rng = np.random.default_rng(8)
    q, g = (torch.from_numpy(rng.normal(size=(B, L, H, D)).astype(np.float32)).bfloat16()
            for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32)).bfloat16()
            for _ in range(2))
    mask = torch.from_numpy(np.arange(S)[None, :] >= np.array([[S * 4 // 5], [S // 2 + 3]]))
    out, lse = scaled_dot_product_attention(q, k, v, mask, SEED, RATE)
    return q, k, v, mask, g, out, lse


def _bf16(x):
    return x.bfloat16().float()


def _kernel_order_backward(q, k, v, mask, g, out, lse, cast_ds=True, split_pd=True):
    """The bf16 kernels' arithmetic in their summation order (module note),
    or with one of two faults: dS not cast to bf16 (``cast_ds=False``), P_d
    rounded to one bf16 value in dV (``split_pd=False``)."""
    L, S = q.shape[1], k.shape[1]
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    scale = 1.0 / D**0.5

    def halves(eq, a, b):  # a product over d, summed in two k-steps of 16
        return torch.einsum(eq, a[..., :16], b[..., :16]) + torch.einsum(eq, a[..., 16:], b[..., 16:])

    s = halves("blhd,bshd->bhls", qf, kf) * scale
    s = s.masked_fill(mask[:, None, None, :], F32_MIN)
    lse4 = lse[..., None]
    p = torch.where(lse4 == F32_MIN, 1.0 / S, torch.exp(s - lse4))
    dp = halves("blhd,bshd->bhls", gf, vf)
    keep = attention_keep(SEED, B, H, L, S, RATE, "cpu")
    inv = 1.0 / (1.0 - RATE)
    p_d = torch.where(keep, p * inv, 0.0)
    dp = torch.where(keep, dp * inv, 0.0)
    delta = (gf * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta)
    if cast_ds:
        ds = _bf16(ds)
    hi = _bf16(p_d)
    terms = (hi, _bf16(p_d - hi)) if split_pd else (hi,)

    dq = torch.zeros(B, L, H, D)
    for j in range(0, S, TILE):
        dq += torch.einsum("bhls,bshd->blhd", ds[..., j:j + TILE], kf[:, j:j + TILE])
    dk, dv = torch.zeros(B, S, H, D), torch.zeros(B, S, H, D)
    for i in range(0, L, TILE):
        for t in terms:
            dv += torch.einsum("bhls,blhd->bshd", t[:, :, i:i + TILE], gf[:, i:i + TILE])
        dk += torch.einsum("bhls,blhd->bshd", ds[:, :, i:i + TILE], qf[:, i:i + TILE])
    return (dq * scale).bfloat16(), (dk * scale).bfloat16(), dv.bfloat16()


@pytest.fixture(scope="module", params=SIZES, ids=lambda ls: f"L{ls[0]}-S{ls[1]}")
def plain_and_inputs(request):
    x = _inputs(*request.param)
    return scaled_dot_product_attention_backward(*x, SEED, RATE), x


def test_bf16_agreement_counts_ulps():
    want = torch.tensor([1.0, -3.0, 0.0, 2.0**-10, 2.0**-130] * 40).bfloat16()
    assert bf16_agreement(want, want) == (0.0, 0.0)
    got = want.clone()
    got[0] = 1.0 + 2.0**-7  # the next bf16 value above 1
    got[1] = -3.0 - 2 * 2.0**-6  # two ulps of 3 (ulp 2^-6 on [2, 4))
    assert bf16_agreement(got, want) == (2.0, pytest.approx(2 / 200))
    # below a quarter of the largest |want| (3/4, in [2^-1, 1)): ulps of 2^-8
    got = want.clone()
    got[2] = 2.0**-8
    got[3] = 2.0**-10 + 2.0**-7
    assert bf16_agreement(got, want) == (2.0, pytest.approx(2 / 200))
    got[3] = float("nan")
    max_ulps, share = bf16_agreement(got, want)
    assert np.isnan(max_ulps) and share == pytest.approx(2 / 200)
    zeros = torch.zeros(8, dtype=torch.bfloat16)
    assert bf16_agreement(zeros + 2.0**-133, zeros) == (1.0, 1.0)


def test_check_passes_the_kernels_summation_order(plain_and_inputs):
    want, x = plain_and_inputs
    got = _kernel_order_backward(*x)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        max_ulps, share = bf16_agreement(a, b)
        assert max_ulps <= BF16_MAX_ULPS and share <= BF16_MAX_SHARE, (name, max_ulps, share)
        assert share > 0, name  # the emulated order does move a few roundings


@pytest.mark.parametrize("fault", ["uncast_ds", "single_bf16_pd"])
def test_check_fails_a_bf16_fault(plain_and_inputs, fault):
    want, x = plain_and_inputs
    if fault == "uncast_ds":
        got, hit = _kernel_order_backward(*x, cast_ds=False), ("dq", "dk")
    else:
        got, hit = _kernel_order_backward(*x, split_pd=False), ("dv",)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        max_ulps, share = bf16_agreement(a, b)
        if name in hit:
            assert share > 20 * BF16_MAX_SHARE, (name, max_ulps, share)
        else:
            assert max_ulps <= BF16_MAX_ULPS and share <= BF16_MAX_SHARE, (name, max_ulps, share)
