"""The port's masked attention against the JAX Pallas forward.

``detr_tpu_torch.ops.masked_attention`` on CPU tensors runs its plain
PyTorch version; ``detr_tpu.ops.pallas_attention._flash_forward`` runs the
Pallas ``_fwd_kernel`` in interpret mode on the CPU.  Same numpy inputs,
fp32, tolerances of tests/test_pallas_kernels.py: out at atol 2e-5, lse at
atol 1e-5, and lse exactly finfo(float32).min on fully masked rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tpu.ops.pallas_attention import _flash_forward
from detr_tpu_torch.ops import masked_attention as port_attention
from detr_tpu_torch.ops.masked_attention import masked_attention
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

F32_MIN = np.finfo(np.float32).min


def _inputs(seed, B, L, S, H, D, mask_kind):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, H, D)).astype(np.float32)
    v = rng.normal(size=(B, S, H, D)).astype(np.float32)
    mask = None
    if mask_kind != "none":
        # ragged key padding: each image keeps a different prefix
        valid = rng.integers(1, S, size=B)
        mask = np.arange(S)[None, :] >= valid[:, None]
        if mask_kind == "fully_masked":
            mask[1] = True
    return q, k, v, mask


def _jax_forward(q, k, v, mask, block_q):
    B, L, H, _ = q.shape
    out, lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask),
        jnp.zeros((1,), jnp.int32), 0.0, block_q,
    )
    lse = np.asarray(lse)[:, :L, 0].reshape(B, H, L)
    return np.asarray(out), lse


@pytest.mark.parametrize("D", [8, 32])
@pytest.mark.parametrize("mask_kind", ["ragged", "fully_masked", "none"])
def test_masked_attention_matches_pallas_forward(D, mask_kind):
    # L = 37 is ragged against both the JAX block (16) and the kernel tile (64).
    q, k, v, mask = _inputs(D, B=3, L=37, S=45, H=2, D=D, mask_kind=mask_kind)
    ref_out, ref_lse = _jax_forward(q, k, v, mask, block_q=16)
    out, lse = masked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask),
    )
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (3, 2, 37)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5, rtol=0)
    if mask_kind == "fully_masked":
        assert (lse[1].numpy() == F32_MIN).all()
        assert (ref_lse[1] == F32_MIN).all()
        # a fully masked row is the uniform mean of V
        np.testing.assert_allclose(
            out[1].numpy(), np.broadcast_to(v[1].mean(0), out[1].shape), atol=1e-5
        )


def test_masked_attention_cpu_path_counts_no_launch():
    q, k, v, mask = _inputs(0, B=2, L=5, S=7, H=2, D=32, mask_kind="ragged")
    before = port_attention.launches
    masked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     torch.from_numpy(mask))
    assert port_attention.launches == before


def test_masked_attention_rejects_what_it_does_not_compute():
    q = torch.zeros(1, 4, 2, 32)
    # dropout needs a seed: a constant one would reuse one mask every step
    with pytest.raises(ValueError, match="seed"):
        masked_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="shapes"):
        masked_attention(q, torch.zeros(1, 4, 2, 16), q)
    with pytest.raises(ValueError, match="key_padding_mask"):
        masked_attention(q, q, q, torch.zeros(1, 4, dtype=torch.int32))


def _padded(x):
    return torch.nn.functional.pad(x, (0, port_attention.HEAD_SIZE - x.shape[-1]))


@pytest.mark.parametrize("D", [8, 16])
def test_head_padding_to_32_with_the_true_scale_is_the_same_function(D):
    """What the card path does for D < 32, on the plain versions: q, k, v
    and the output gradient zero-padded to 32 along D, with scale 1/sqrt(D),
    give the unpadded function's out, lse and gradients (sliced back; the
    padding's out and gradients are exactly 0).  Dropout 0.1, a ragged and a
    fully masked image.  Sums over D gain only zero terms, in another order
    of blocks: within 1e-6 of each tensor's largest value."""
    q, k, v, mask = (None if x is None else torch.from_numpy(x)
                     for x in _inputs(D, B=3, L=37, S=45, H=2, D=D, mask_kind="fully_masked"))
    g = torch.from_numpy(np.random.default_rng(D + 1).normal(size=q.shape).astype(np.float32))
    out, lse = port_attention.masked_attention_reference(q, k, v, mask, 3, 0.1)
    grads = port_attention.masked_attention_backward_reference(q, k, v, mask, g, out, lse, 3, 0.1)
    pq, pk, pv, pg = (_padded(x) for x in (q, k, v, g))
    pout, plse = port_attention.masked_attention_reference(pq, pk, pv, mask, 3, 0.1,
                                                           scale=1.0 / D**0.5)
    pgrads = port_attention.masked_attention_backward_reference(
        pq, pk, pv, mask, pg, pout, plse, 3, 0.1, scale=1.0 / D**0.5)
    for got, want in zip((pout, plse, *pgrads), (out, lse, *grads)):
        if got.dim() == 4:
            assert not got[..., D:].any()
            got = got[..., :D]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("D", [8, 16])
def test_card_wrapper_pads_and_slices_back(D, monkeypatch):
    """``forward_cuda`` and ``backward_cuda`` for D < 32 with the launches
    emulated by the plain versions (the card is needed for the real ones):
    the launches see head size 32 and the true scale, and the results equal
    the unpadded plain function's, as in the case above."""
    q, k, v, mask = (None if x is None else torch.from_numpy(x)
                     for x in _inputs(D, B=2, L=9, S=11, H=2, D=D, mask_kind="ragged"))
    g = torch.from_numpy(np.random.default_rng(D).normal(size=q.shape).astype(np.float32))
    seen = []

    def fwd(q, k, v, mask, seed, rate, scale, hash_base=None):
        seen.append((q.shape[-1], scale))
        return port_attention.masked_attention_reference(q, k, v, mask, seed, rate, scale,
                                                         hash_base)

    def bwd(which):
        def launch(q, k, v, mask, g, lse, delta, seed, rate, scale=None, hash_base=None):
            seen.append((q.shape[-1], scale))
            out, _ = port_attention.masked_attention_reference(q, k, v, mask, seed, rate, scale)
            torch.testing.assert_close(delta, (g * out).sum(-1).transpose(1, 2))
            dq, dk, dv = port_attention.masked_attention_backward_reference(
                q, k, v, mask, g, out, lse, seed, rate, scale)
            return (dk, dv) if which == "dkv" else dq
        return launch

    monkeypatch.setattr(port_attention, "_check_card", lambda *a: None)
    monkeypatch.setattr(port_attention, "_forward_launch", fwd)
    monkeypatch.setattr(port_attention, "bwd_dkv_cuda", bwd("dkv"))
    monkeypatch.setattr(port_attention, "bwd_dq_cuda", bwd("dq"))
    out, lse = port_attention.forward_cuda(q, k, v, mask, 5, 0.1)
    grads = port_attention.backward_cuda(q, k, v, mask, g, out, lse, 5, 0.1)
    assert seen == [(32, 1.0 / D**0.5)] * 3
    want_out, want_lse = port_attention.masked_attention_reference(q, k, v, mask, 5, 0.1)
    want = port_attention.masked_attention_backward_reference(
        q, k, v, mask, g, want_out, want_lse, 5, 0.1)
    for got, ref in zip((out, lse, *grads), (want_out, want_lse, *want)):
        assert got.shape == ref.shape and got.is_contiguous()
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))
