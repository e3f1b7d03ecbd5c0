"""The port's training ops against the JAX package's: hash dropout, the
attention keep-mask, the attention forward with dropout and its backward,
the box geometry and the learning-rate schedule.

JAX's attention runs the Pallas kernels in interpret mode on the CPU; the
port's runs its plain PyTorch versions (what its CUDA kernels are held
against on the card).  Inputs are seeded numpy, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import detr_tpu.ops.pallas_attention as pa
from detr_tpu.ops import boxes as jboxes
from detr_tpu.ops.dropout import hash_dropout as jax_hash_dropout
from detr_tpu.ops.pallas_attention import _dropout_keep, pallas_masked_attention
from detr_tpu.train.schedule import make_epoch_lr_schedule as jax_epoch_schedule
from detr_tpu.train.schedule import make_lr_schedule as jax_step_schedule
from detr_tpu_torch.ops import boxes
from detr_tpu_torch.ops.attention import (
    scaled_dot_product_attention,
    scaled_dot_product_attention_backward,
)
from detr_tpu_torch.ops.dropout import attention_keep, hash_dropout
from detr_tpu_torch.ops.masked_attention import masked_attention
from detr_tpu_torch.train.schedule import make_epoch_lr_schedule, make_lr_schedule
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)


def _jax_seed(key) -> int:
    """The uint32 seed JAX's hash_dropout derives from its flax key."""
    return int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max, jnp.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("shape", [(3, 37, 50), (2, 5, 7, 64)])
def test_hash_dropout_bit_exact(dtype, rate, shape):
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(int(rate * 10))
    want = np.asarray(jax_hash_dropout(jnp.asarray(x, dtype), rate, key, False).astype(jnp.float32))
    got = hash_dropout(torch.from_numpy(x).to(getattr(torch, dtype)), rate, _jax_seed(key), False)
    np.testing.assert_array_equal(got.float().numpy(), want)  # bit for bit
    assert abs((want == 0).mean() - rate) < 0.05


def test_hash_dropout_identity_when_off():
    x = torch.randn(4, 5)
    assert hash_dropout(x, 0.1, 3, deterministic=True) is x
    assert hash_dropout(x, 0.0, None, deterministic=False) is x
    with pytest.raises(ValueError, match="seed"):
        hash_dropout(x, 0.1, None, deterministic=False)


@pytest.mark.parametrize("seed", [0, 1234, 2**31 - 2])
def test_attention_keep_mask_bit_exact(seed):
    """The (seed, head, absolute row, absolute col) hash of the Pallas
    kernels, over two query blocks of 16 rows."""
    B, H, L, S, rate = 2, 3, 32, 45, 0.1
    got = attention_keep(seed, B, H, L, S, rate, "cpu").numpy().reshape(B * H, L, S)
    for bh in range(B * H):
        for qi in range(2):
            want = _dropout_keep((16, S), rate, jnp.int32(seed), jnp.int32(bh), jnp.int32(qi), 16)
            np.testing.assert_array_equal(got[bh, qi * 16:(qi + 1) * 16], np.asarray(want))


def _inputs(seed, B=2, L=37, S=45, H=2, D=32, fully_masked=True):
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, L, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(2))
    mask = np.arange(S)[None, :] >= rng.integers(1, S, size=B)[:, None]
    if fully_masked:
        mask[-1] = True
    return q, k, v, g, mask


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_forward_with_dropout_matches_pallas(rate):
    """out at atol 2e-5 (fp32 softmax on both sides), lse at 1e-5."""
    q, k, v, _, mask = _inputs(3)
    seed = 77
    out, lse = pa._flash_forward(*map(jnp.asarray, (q, k, v, mask)), jnp.array([seed], jnp.int32),
                                 rate, 16)
    got, got_lse = masked_attention(*map(torch.from_numpy, (q, k, v, mask)), rate, seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=2e-5, rtol=0)
    B, L, H, _ = q.shape
    want_lse = np.asarray(lse)[:, :L, 0].reshape(B, H, L)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=0)


def _port_grads(q, k, v, g, mask, rate, seed):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, _ = masked_attention(tq, tk, tv, torch.from_numpy(mask), rate, seed)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_matches_single_kernel_route(rate):
    """The port's backward (through its autograd Function) against
    ``_flash_backward`` (the ``_bwd_kernel`` route JAX takes for S <= 2048),
    a fully masked image included: atol 5e-5."""
    q, k, v, g, mask = _inputs(4)
    seed = 1234
    want = pa._flash_backward(*map(jnp.asarray, (q, k, v, mask)), jnp.array([seed], jnp.int32),
                              jnp.asarray(g), rate, 16)
    for got, ref in zip(_port_grads(q, k, v, g, mask, rate, seed), want):
        np.testing.assert_allclose(got, np.asarray(ref), atol=5e-5, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_matches_blocked_route(rate, monkeypatch):
    """Against ``_flash_backward_blocked`` (``_bwd_dkv_kernel`` and
    ``_bwd_dq_kernel``), forced by shrinking its thresholds as
    tests/test_pallas_kernels.py::test_blocked_backward_dispatch does: atol
    2e-4 on images with a valid key.  On a fully masked image that route
    rebuilds P = exp(0) = 1 per key from the saturated lse (its documented
    caveat); the port gives the single-kernel route's uniform 1/S there."""
    monkeypatch.setattr(pa, "_BWD_SINGLE_MAX_S", 32)
    monkeypatch.setattr(pa, "_DEF_BS", 24)
    calls = []
    blocked = pa._flash_backward_blocked
    monkeypatch.setattr(pa, "_flash_backward_blocked",
                        lambda *a, **kw: calls.append(1) or blocked(*a, **kw))
    q, k, v, g, mask = _inputs(5, B=3, S=48)
    seed = 99
    jseed = jnp.array([seed], jnp.int32)
    _, vjp = jax.vjp(lambda q, k, v: pallas_masked_attention(
        q, k, v, jnp.asarray(mask), jseed, rate, 8), *map(jnp.asarray, (q, k, v)))
    want_blocked = vjp(jnp.asarray(g))
    assert calls == [1]
    want_single = pa._flash_backward(*map(jnp.asarray, (q, k, v, mask)), jseed, jnp.asarray(g),
                                     rate, 8)
    got = _port_grads(q, k, v, g, mask, rate, seed)
    for a, b, c in zip(got, want_blocked, want_single):
        np.testing.assert_allclose(a[:-1], np.asarray(b)[:-1], atol=2e-4, rtol=0)
        np.testing.assert_allclose(a[-1], np.asarray(c)[-1], atol=5e-5, rtol=0)


def test_backward_is_the_gradient_of_the_forward():
    """The plain backward against autograd through the plain forward, with
    dropout: atol 1e-5.  (On a fully masked image the Pallas single-kernel
    backward, which the port follows, also sends the uniform P's dS into dq
    and dk, where autograd through the masked fill gives 0.)"""
    q, k, v, g, mask = _inputs(6, fully_masked=False)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = scaled_dot_product_attention(tq, tk, tv, torch.from_numpy(mask), 5, 0.2)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    got = scaled_dot_product_attention_backward(
        tq.detach(), tk.detach(), tv.detach(), torch.from_numpy(mask), torch.from_numpy(g),
        out.detach(), lse, 5, 0.2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_gradients_flow_to_the_inputs():
    q, k, v, g, mask = _inputs(7, fully_masked=False)
    grads = _port_grads(q, k, v, g, mask, 0.1, 3)
    assert all(np.isfinite(x).all() and np.abs(x).max() > 0 for x in grads)


def _box_pairs(seed, n=6, m=5):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 0.6, size=(2, n + m, 2))
    hi = lo + rng.uniform(0.0, 0.4, size=(2, n + m, 2))
    b = np.concatenate([lo, hi], -1).astype(np.float32)
    b[0, 0] = [0.3, 0.3, 0.3, 0.3]  # degenerate
    return b[:, :n], b[:, n:]


@pytest.mark.parametrize("name", ["box_area", "box_iou", "generalized_box_iou",
                                  "elementwise_box_iou", "elementwise_generalized_box_iou"])
def test_box_functions_match_jax(name):
    """fp32 at atol 1e-6."""
    a, b = _box_pairs(8)
    if name == "box_area":
        args = (a,)
    elif name.startswith("elementwise"):
        args = (a, b[:, :a.shape[1]] if b.shape[1] >= a.shape[1] else a[:, ::-1])
    else:
        args = (a, b)
    want = getattr(jboxes, name)(*map(jnp.asarray, args))
    got = getattr(boxes, name)(*map(torch.from_numpy, [np.ascontiguousarray(x) for x in args]))
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_top1_accuracy_and_clamp_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(7, 5)).astype(np.float32)
    targets = rng.integers(0, 5, size=7)
    valid = rng.random(7) < 0.6
    want = jboxes.top1_accuracy(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(valid))
    got = boxes.top1_accuracy(*map(torch.from_numpy, (logits, targets, valid)))
    assert float(got) == pytest.approx(float(want), abs=1e-5)
    bx = rng.uniform(-20, 120, size=(3, 4, 4)).astype(np.float32)
    h, w = np.array([50, 80, 100], np.float32), np.array([90, 60, 100], np.float32)
    want = jboxes.clamp_boxes(jnp.asarray(bx), jnp.asarray(h)[:, None], jnp.asarray(w)[:, None])
    got = boxes.clamp_boxes(torch.from_numpy(bx), torch.from_numpy(h)[:, None],
                            torch.from_numpy(w)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("base_lr,epochs,warmup,hold", [
    (3e-4, 100, 5, 35), (3e-5, 100, 5, 35), (1e-3, 12, 2, 3), (2e-4, 4, 0, 1),
])
def test_schedule_matches_jax(base_lr, epochs, warmup, hold):
    """Epoch- and step-indexed schedules, fp32 on both sides: rtol 1e-6."""
    kw = dict(epochs=epochs, warmup_epochs=warmup, warmup_decay=0.01, hold_epochs=hold,
              lr_min=3e-6)
    ours, ref = make_epoch_lr_schedule(base_lr, **kw), jax_epoch_schedule(base_lr, **kw)
    for e in range(epochs + 2):
        assert ours(e) == pytest.approx(float(ref(e)), rel=1e-6)
    ours, ref = make_lr_schedule(base_lr, steps_per_epoch=7, **kw), jax_step_schedule(
        base_lr, steps_per_epoch=7, **kw)
    for s in range(0, 7 * epochs, 5):
        assert ours(s) == pytest.approx(float(ref(s)), rel=1e-6)


def test_train_forward_builds_no_tensor_from_a_python_scalar(monkeypatch):
    """The step's constants (the dropout scale, the position encoding's
    temperature) are fills on the tensors' device: ``torch.tensor`` of a
    Python scalar copies from the host, which on the card makes the host
    wait.  With it made to raise, a train-mode forward (bf16, dropout 0.1,
    the tiny model) and its backward still run."""
    from detr_tpu_torch.config import DETRConfig
    from detr_tpu_torch.models import DETR

    cfg = DETRConfig(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2,
                     num_attention_heads=2, hidden_size=16, ffn_scale_factor=2, num_classes=3)
    model = DETR(cfg).train()
    model.reset_parameters(torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32))
    hs, ws = torch.tensor([64, 40]), torch.tensor([64, 64])

    def refuse(*args, **kwargs):
        raise AssertionError("torch.tensor on the step's path")

    monkeypatch.setattr(torch, "tensor", refuse)
    out = model(images, hs, ws, torch.Generator().manual_seed(1))
    (out["pred_logits"].sum() + out["pred_boxes"].sum()).backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
