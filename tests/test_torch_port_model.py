"""The port's DETR against the JAX package's, on weights carried over by
``state_dict_from_jax``.

The JAX side runs with ``use_pallas_attention=True``, so its attentions go
through the Pallas kernel in interpret mode.  fp32 throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tpu.config import DETRConfig as JaxConfig
from detr_tpu.models import DETR as JaxDETR
from detr_tpu.models import calibrate_frozen_bn
from detr_tpu.models.convert import export_detr_state_dict
from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.models import DETR, state_dict_from_jax
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

TINY = DETRConfig(
    num_object_queries=8,
    num_encoder_layers=1,
    num_decoder_layers=2,
    num_attention_heads=2,
    hidden_size=16,
    ffn_scale_factor=2,
    num_classes=3,
    dtype="float32",
)
JAX_TINY = JaxConfig(
    **{f.name: getattr(TINY, f.name) for f in dataclasses.fields(TINY)},
    use_pallas_attention=True,
)
H, W = 64, 96
HEIGHTS = np.array([64, 50], np.int32)
WIDTHS = np.array([96, 70], np.int32)


def _images(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    for b in range(2):
        imgs[b, HEIGHTS[b]:] = 0.0
        imgs[b, :, WIDTHS[b]:] = 0.0
    return imgs


@pytest.fixture(scope="module")
def jax_model():
    """JAX DETR (ResNet-50 trunk, tiny transformer) with frozen-BN stats
    calibrated on the test images, so activations stay O(1)."""
    model = JaxDETR(JAX_TINY)
    # init runs the forward: jit it, on the XLA attention path (same tree)
    variables = jax.jit(JaxDETR(JAX_TINY.replace(use_pallas_attention=False)).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)), jnp.array([H]), jnp.array([W])
    )
    variables = calibrate_frozen_bn(JAX_TINY, variables, jnp.asarray(_images(0)))
    variables = jax.tree.map(np.asarray, variables)
    return model, variables


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, variables = jax_model
    model = DETR(TINY).eval()
    model.load_state_dict(
        state_dict_from_jax(variables["params"], variables["frozen"], TINY), strict=True
    )
    return model


def test_state_dict_matches_export(jax_model):
    _, variables = jax_model
    ref = export_detr_state_dict(variables["params"], variables["frozen"], JAX_TINY)
    ours = state_dict_from_jax(variables["params"], variables["frozen"], TINY)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        assert ours[key].dtype == torch.float32, key
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    assert sorted(DETR(TINY).state_dict()) == sorted(ref)


def _compare(ours, ref, atol):
    for key in ("pred_logits", "pred_boxes"):
        assert ours[key].dtype == torch.float32
        assert ours[key].shape == ref[key].shape == (2, 2, 8, 4 if key == "pred_boxes" else 4)
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=atol, rtol=0)


def test_from_features_matches(jax_model, port_model):
    model, variables = jax_model
    feats = np.random.default_rng(2).normal(size=(2, 2, 3, 2048)).astype(np.float32)
    ref = model.apply(
        variables, jnp.asarray(feats), jnp.asarray(HEIGHTS), jnp.asarray(WIDTHS),
        method="from_features",
    )
    with torch.inference_mode():
        ours = port_model.from_features(
            torch.from_numpy(feats), torch.from_numpy(HEIGHTS), torch.from_numpy(WIDTHS)
        )
    _compare(ours, ref, atol=1e-4)


def test_full_forward_matches(jax_model, port_model):
    """ResNet-50 included, fp32 at 64x96.  atol 2e-3: the trunk's 53
    convolutions sum in another order than XLA's, and with stats calibrated
    on these very images each frozen BN rescales the drift; it grows
    steadily block by block to ~2e-4 of the largest feature (measured), and
    the logits then differ by ~4e-4."""
    model, variables = jax_model
    imgs = _images(0)
    ref = model.apply(variables, jnp.asarray(imgs), jnp.asarray(HEIGHTS), jnp.asarray(WIDTHS))
    with torch.inference_mode():
        ours = port_model(
            torch.from_numpy(imgs), torch.from_numpy(HEIGHTS), torch.from_numpy(WIDTHS)
        )
    _compare(ours, ref, atol=2e-3)


@pytest.mark.parametrize("dilation", [False, True])
def test_backbone_matches(jax_model, port_model, dilation):
    """The trunk alone, NHWC features out (channels_last inside), and its
    DC5 variant (stride 16, dilated last stage) on the same weights.  atol
    1e-3 of the largest feature: the drift test_full_forward_matches
    describes, measured at ~2e-4 of it."""
    from detr_tpu.models import ResNetBackbone

    _, variables = jax_model
    imgs = _images(1)
    ref = ResNetBackbone(dilation=dilation, dtype="float32").apply(
        {"params": variables["params"]["backbone"], "frozen": variables["frozen"]["backbone"]},
        jnp.asarray(imgs),
    )
    model = port_model
    if dilation:
        model = DETR(TINY.replace(dilation=True)).eval()
        model.load_state_dict(port_model.state_dict(), strict=True)
    with torch.inference_mode():
        ours = model.backbone(torch.from_numpy(imgs))
    stride = 16 if dilation else 32
    assert ours.shape == ref.shape == (2, H // stride, W // stride, 2048)
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3 * scale, rtol=0)


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_full_width_parameter_count_matches(backbone):
    full = JaxConfig(backbone=backbone)
    shapes = jax.eval_shape(
        lambda: JaxDETR(full).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.array([64]), jnp.array([64])
        )
    )
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    n_frozen = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["frozen"]))
    model = DETR(DETRConfig(backbone=backbone))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert sum(b.numel() for b in model.buffers()) == n_frozen


def test_random_init_follows_jax_rules():
    """Seeded init: same seed, same weights; the JAX package's init scales."""
    a, b = DETR(TINY), DETR(TINY)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    w = a.encoder.layers[0].ffn.layers[0].weight.detach()
    assert abs(float(w.std()) - TINY.initializer_range) < 0.005
    assert float(a.encoder.layers[0].ffn.layers[0].bias.detach().abs().max()) == 0.0
    conv = a.backbone.backbone.layer1[0].conv2.weight.detach()  # he_normal, fan_in 64*9
    assert abs(float(conv.std()) - (2.0 / 576) ** 0.5) < 0.01
    assert float(conv.abs().max()) <= 2.0 * (2.0 / 576) ** 0.5 / 0.8796 + 1e-6


def test_training_mode_refuses_dropout():
    """Training mode applies dropout (it no longer refuses it): seeded by the
    generator it is given, and off in eval mode."""
    model = DETR(TINY.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1))
    feats = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 2, 3, 2048)).astype(np.float32))
    args = (feats, torch.tensor([64]), torch.tensor([96]))
    with torch.no_grad():  # nn.Module starts in training mode
        a = model.from_features(*args, torch.Generator().manual_seed(1))["pred_logits"]
        b = model.from_features(*args, torch.Generator().manual_seed(1))["pred_logits"]
        c = model.from_features(*args, torch.Generator().manual_seed(2))["pred_logits"]
        model.eval()
        d = model.from_features(*args)["pred_logits"]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


@pytest.mark.parametrize("dilation", [False, True])
def test_multi_stage_trunk_strides(dilation):
    """C3, C4 and C5 from one trunk: strides 8, 16, 32, and under DC5's
    dilation C4 keeps stride 16 and C5 stays at 16; C5 alone (DETR's
    default) is the same tensor as the multi-stage trunk's last."""
    from detr_tpu_torch.models.resnet import ResNetBackbone

    multi = ResNetBackbone(dilation=dilation, dtype=torch.float32, stages=(2, 3, 4)).eval()
    single = ResNetBackbone(dilation=dilation, dtype=torch.float32).eval()
    single.load_state_dict(multi.state_dict())
    x = torch.randn(1, 3, 128, 192)
    with torch.no_grad():
        c3, c4, c5 = multi(x)
        (alone,) = single(x)
    s5 = 16 if dilation else 32
    assert c3.shape == (1, 512, 16, 24) and c4.shape == (1, 1024, 8, 12)
    assert c5.shape == (1, 2048, 128 // s5, 192 // s5)
    assert torch.equal(c5, alone)
    # only DETR's and Deformable DETR's stage lists are taken
    for stages in ((4, 2), (2,), (1, 2, 3, 4)):
        with pytest.raises(ValueError):
            ResNetBackbone(stages=stages)
