"""The bf16 attention forward: where P is rounded to bf16, and the agreement
check (``ops.attention.bf16_agreement``) that holds the forward kernel to
its plain version, on the CPU.

The Pallas ``_fwd_kernel`` normalises first (P = e / rowsum e), applies
dropout, casts P to V's dtype and only then forms P·V.  The port's plain
forward does the same.  A one-pass (online-softmax, FlashAttention-2) kernel
instead rounds the unnormalised exp(s - m_running) to bf16 and divides by
the row sum at the end: the two bf16 roundings of P differ, and the
difference reaches the bf16 output.  The bf16 kernel of
``csrc/masked_attention_fwd.cu`` is therefore two-pass: pass 1 gives
lse = m + log(l); pass 2 forms the normalised P = exp(s - lse), drops it,
casts it to bf16 and accumulates P·V tile by tile.  Here both orders are
emulated in PyTorch (s summed over the head dim in two halves of 16, tiles
of 64 keys, each tile's P·V summed alone and added to the running fp32 sum).

Measured here (B=2, H=2, D=32, keys partly padded, dropout 0 and 0.1), as
the share of output elements that differ (largest difference in ulps):
- against the Pallas ``_flash_forward`` in interpret mode on bf16 inputs,
  (L, S) = (37, 45) and (100, 300): the port's plain forward 0-0.063 %
  (1 ulp), the two-pass order 0-0.094 % (1 ulp), the one-pass order
  44-50 % (2 ulps);
- against the plain forward, (L, S) = (256, 256), (100, 1092), (128, 4200):
  the two-pass order 0.055-0.60 % (1 ulp), the one-pass order 49-53 %
  (2 ulps);
- the two-pass order with the decoder's key split (2 or 4 warps share 16
  rows and split each tile of keys), against the plain forward at
  (100, 1092): 0.16-0.30 % (1 ulp).
The one-pass order fails the check (at most 1 % may differ) by far; the
two-pass order and the plain forward pass it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tpu.ops.pallas_attention import _flash_forward
from detr_tpu_torch.ops.attention import (
    BF16_MAX_SHARE,
    BF16_MAX_ULPS,
    F32_MIN,
    bf16_agreement,
    scaled_dot_product_attention,
)
from detr_tpu_torch.ops.dropout import attention_keep
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

B, H, D = 2, 2, 32
SEED, TILE = 77, 64
RATES = [0.0, 0.1]


def _inputs(L, S, rate):
    rng = np.random.default_rng(L + S)
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(2))
    mask = np.arange(S)[None, :] >= np.array([[S * 4 // 5], [S // 2 + 3]])
    q, k, v = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    return q, k, v, torch.from_numpy(mask), rate


def _scores(q, k, mask):
    """s = q.k^T / sqrt(D) in fp32, summed over D in two k-steps of 16 as
    the tensor cores take it; padded keys finfo(float32).min."""
    qf, kf = q.float(), k.float()
    s = (torch.einsum("blhd,bshd->bhls", qf[..., :16], kf[..., :16])
         + torch.einsum("blhd,bshd->bhls", qf[..., 16:], kf[..., 16:])) * (1.0 / D**0.5)
    return s.masked_fill(mask[:, None, None, :], F32_MIN)


def _dropped(p, L, S, rate):
    if rate == 0.0:
        return p
    keep = attention_keep(SEED, B, H, L, S, rate, "cpu")
    return torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)


def _two_pass(q, k, v, mask, rate):
    """The bf16 kernel's order: lse from a running max and sum over tiles of
    64 keys; then P = exp(s - lse) (1/S on a fully masked row), dropout, P
    cast to bf16, O summed tile by tile."""
    L, S = q.shape[1], k.shape[1]
    s = _scores(q, k, mask)
    m = torch.full((B, H, L, 1), F32_MIN)
    l = torch.zeros(B, H, L, 1)
    for j in range(0, S, TILE):
        st = s[..., j:j + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(st - m_new).sum(-1, keepdim=True)
        m = m_new
    lse = m + torch.log(l)
    p = torch.exp(s - lse) * torch.where(lse == F32_MIN, 1.0 / S, 1.0)
    p = _dropped(p, L, S, rate).bfloat16().float()
    out = torch.zeros(B, L, H, D)
    for j in range(0, S, TILE):
        out += torch.einsum("bhls,bshd->blhd", p[..., j:j + TILE], v[:, j:j + TILE].float())
    return out.bfloat16()


def _two_pass_split(q, k, v, mask, rate, split):
    """The two-pass order with the key split of the decoder's blocks:
    ``split`` warps share 16 query rows, warp w takes the 16-key chunks w,
    w + split, ... of every tile, keeps its own running max (from
    finfo(float32).min) and sum, and the warps combine their statistics, then
    their partial outputs, in warp order."""
    L, S = q.shape[1], k.shape[1]
    s = _scores(q, k, mask)
    owner = torch.arange(S) % TILE // 16 % split
    ms, ls = [], []
    for w in range(split):
        sw = s.masked_fill(owner != w, -float("inf"))
        m = torch.full((B, H, L, 1), F32_MIN)
        l = torch.zeros(B, H, L, 1)
        for j in range(0, S, TILE):
            st = sw[..., j:j + TILE]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(st - m_new).sum(-1, keepdim=True)
            m = m_new
        ms.append(m)
        ls.append(l)
    mx = torch.stack(ms).amax(0)
    l = sum(lw * torch.exp(mw - mx) for mw, lw in zip(ms, ls))
    lse = mx + torch.log(l)
    p = torch.exp(s - lse) * torch.where(lse == F32_MIN, 1.0 / S, 1.0)
    p = _dropped(p, L, S, rate).bfloat16().float()
    out = torch.zeros(B, L, H, D)
    for w in range(split):
        pw = p.masked_fill(owner != w, 0.0)
        ow = torch.zeros(B, L, H, D)
        for j in range(0, S, TILE):
            ow += torch.einsum("bhls,bshd->blhd", pw[..., j:j + TILE], v[:, j:j + TILE].float())
        out = out + ow
    return out.bfloat16()


def _one_pass(q, k, v, mask, rate):
    """The one-pass order (the scalar kernel before, FlashAttention-2): the
    unnormalised exp(s - m_running) is dropped and cast to bf16, O and the
    row sum are rescaled as the running max grows, O / l at the end."""
    L, S = q.shape[1], k.shape[1]
    s = _scores(q, k, mask)
    keep_scale = _dropped(torch.ones(B, H, L, S), L, S, rate)
    m = torch.full((B, H, L, 1), -float("inf"))
    l = torch.zeros(B, H, L, 1)
    acc = torch.zeros(B, H, L, D)
    for j in range(0, S, TILE):
        st = s[..., j:j + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(st - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        pd = (e * keep_scale[..., j:j + TILE]).bfloat16().float()
        acc = acc * alpha + torch.einsum("bhls,bshd->bhld", pd, v[:, j:j + TILE].float())
        m = m_new
    return (acc / l).transpose(1, 2).bfloat16()


def _agree(got, want):
    max_ulps, share = bf16_agreement(got, want)
    return max_ulps <= BF16_MAX_ULPS and share <= BF16_MAX_SHARE, (max_ulps, share)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("L,S", [(37, 45), (100, 300)])
def test_plain_bf16_forward_matches_pallas(L, S, rate):
    q, k, v, mask, rate = _inputs(L, S, rate)
    want, want_lse = _flash_forward(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(mask.numpy()), jnp.array([SEED], jnp.int32), rate, 16)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    got, lse = scaled_dot_product_attention(q, k, v, mask, SEED, rate)
    assert got.dtype == torch.bfloat16 and got.shape == (B, L, H, D)
    ok, numbers = _agree(got, want)
    assert ok, numbers
    want_lse = np.asarray(want_lse)[:, :L, 0].reshape(B, H, L)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-4, rtol=0)


@pytest.fixture(scope="module", params=[(256, 256), (100, 1092), (128, 4200)],
                ids=lambda ls: f"L{ls[0]}-S{ls[1]}")
def sizes(request):
    return request.param


@pytest.mark.parametrize("rate", RATES)
def test_two_pass_order_passes_the_check(sizes, rate):
    x = _inputs(*sizes, rate)
    want, _ = scaled_dot_product_attention(*x[:4], SEED, rate)
    ok, numbers = _agree(_two_pass(*x), want)
    assert ok, numbers


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("split", [2, 4])
def test_split_two_pass_order_passes_the_check(split, rate):
    x = _inputs(100, 1092, rate)
    want, _ = scaled_dot_product_attention(*x[:4], SEED, rate)
    ok, numbers = _agree(_two_pass_split(*x, split), want)
    assert ok, numbers


@pytest.mark.parametrize("rate", RATES)
def test_one_pass_order_fails_the_check(sizes, rate):
    x = _inputs(*sizes, rate)
    want, _ = scaled_dot_product_attention(*x[:4], SEED, rate)
    max_ulps, share = bf16_agreement(_one_pass(*x), want)
    assert share > 20 * BF16_MAX_SHARE, (max_ulps, share)
