"""The port's small ops and host data path against the JAX package.

Position encoding, padding masks and box converters are fp32 functions of
the same inputs: atol 1e-6 (sin/cos of the same fp32 phases).  The val
transform may resize through the JAX package's native bilinear filter,
which is <= 1 uint8 level from PIL's (tests/test_resize_numerics.py): uint8
outputs are compared at atol 1 level, normalized ones at 1 level times the
largest normalize scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tpu.data import bucketing as jax_bucketing
from detr_tpu.data import transforms as jax_transforms
from detr_tpu.models.detr import make_image_padding_mask as jax_padding_mask
from detr_tpu.ops import boxes as jax_boxes
from detr_tpu.ops import position_encoding as jax_pe
from detr_tpu_torch.data import bucketing, transforms
from detr_tpu_torch.models.detr import make_image_padding_mask
from detr_tpu_torch.ops import boxes, position_encoding
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

# Ragged extents: exact multiples of the stride, one past, and tiny.
HEIGHTS = np.array([64, 65, 33, 1, 96], np.int32)
WIDTHS = np.array([96, 31, 64, 96, 1], np.int32)


@pytest.mark.parametrize("stride", [32, 16])
def test_sine_position_embedding_matches(stride):
    fh, fw = -(-96 // stride), -(-96 // stride)
    ref = jax_pe.sine_position_embedding(
        fh, fw, jnp.asarray(HEIGHTS), jnp.asarray(WIDTHS), stride, 64, 10000.0
    )
    ours = position_encoding.sine_position_embedding(
        fh, fw, torch.from_numpy(HEIGHTS), torch.from_numpy(WIDTHS), stride, 64, 10000.0
    )
    assert ours.dtype == torch.float32 and ours.shape == (5, fh, fw, 128)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_scaled_valid_extent_matches():
    ext = np.array([0, 1, 31, 32, 33, 800, 1067], np.int32)
    ref = jax_pe.scaled_valid_extent(jnp.asarray(ext), 32)
    ours = position_encoding.scaled_valid_extent(torch.from_numpy(ext), 32)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["full", "corner"])
def test_padding_mask_matches(mode):
    ref = jax_padding_mask(3, 3, jnp.asarray(HEIGHTS), jnp.asarray(WIDTHS), 32, mode)
    ours = make_image_padding_mask(
        3, 3, torch.from_numpy(HEIGHTS), torch.from_numpy(WIDTHS), 32, mode
    )
    assert ours.dtype == torch.bool
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_padding_mask_rejects_unknown_mode():
    with pytest.raises(ValueError, match="padding_mask_mode"):
        make_image_padding_mask(2, 2, torch.tensor([32]), torch.tensor([32]), 32, "l")


@pytest.mark.parametrize(
    "name", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh"]
)
def test_box_converters_match(name):
    b = np.random.default_rng(0).random((2, 7, 4)).astype(np.float32)
    ref = getattr(jax_boxes, name)(jnp.asarray(b))
    ours = getattr(boxes, name)(torch.from_numpy(b))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def _target(rng, h, w, n=4):
    x0 = rng.uniform(-10, w, n)
    y0 = rng.uniform(-10, h, n)
    bx = np.stack([x0, y0, x0 + rng.uniform(0, 60, n), y0 + rng.uniform(0, 60, n)], -1)
    return {
        "boxes": bx.astype(np.float32),
        "class_idx": np.arange(n, dtype=np.int32),
        "class_id": np.arange(n, dtype=np.int32) + 1,
        "iscrowd": np.zeros(n, bool),
    }


@pytest.mark.parametrize("shape", [(100, 150), (150, 100), (30, 45), (64, 96)])
@pytest.mark.parametrize("normalize", [True, False])
def test_val_transform_matches(shape, normalize):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    target = _target(rng, *shape)
    ref_img, ref_t = jax_transforms.ValTransform(64, 96, normalize=normalize)(img, target)
    ours_img, ours_t = transforms.ValTransform(64, 96, normalize=normalize)(img, target)
    assert ours_img.shape == ref_img.shape and ours_img.dtype == ref_img.dtype
    level = 1.0 if not normalize else float(transforms._NORM_SCALE.max()) + 1e-6
    np.testing.assert_allclose(
        ours_img.astype(np.float32), ref_img.astype(np.float32), atol=level, rtol=0
    )
    for key in ("boxes", "class_idx", "class_id", "iscrowd"):
        np.testing.assert_allclose(ours_t[key], ref_t[key], atol=1e-4)


def test_normalize_matches():
    img = np.random.default_rng(3).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    np.testing.assert_allclose(
        transforms.normalize(img), jax_transforms.normalize(img), atol=1e-6, rtol=0
    )


def test_float_resize_matches():
    img = (np.random.default_rng(4).random((40, 60, 3)) * 255).astype(np.float32)
    t = _target(np.random.default_rng(5), 40, 60)
    ref, ref_t = jax_transforms.resize(img, t, 64, 96)
    ours, ours_t = transforms.resize(img, t, 64, 96)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours_t["boxes"], ref_t["boxes"])


@pytest.mark.parametrize(
    "hw", [(800, 1067), (1067, 800), (800, 800), (800, 1333), (1400, 1400), (10, 10)]
)
def test_pick_bucket_matches(hw):
    buckets = jax_bucketing.EVAL_BUCKETS
    assert bucketing.EVAL_BUCKETS == buckets
    assert bucketing.pick_bucket(*hw, buckets) == jax_bucketing.pick_bucket(*hw, buckets)


def test_fit_to_bucket_matches():
    img = np.random.default_rng(6).integers(0, 256, (120, 100, 3), dtype=np.uint8)
    t = _target(np.random.default_rng(7), 120, 100)
    ref, ref_t = jax_bucketing.fit_to_bucket(img, t, (64, 96))
    ours, ours_t = bucketing.fit_to_bucket(img, t, (64, 96))
    assert ours.shape == ref.shape == (64, 53, 3)
    np.testing.assert_allclose(ours.astype(int), ref.astype(int), atol=1, rtol=0)
    np.testing.assert_allclose(ours_t["boxes"], ref_t["boxes"], atol=1e-5)
    same, _ = bucketing.fit_to_bucket(img[:60, :90], t, (64, 96))
    assert same.shape == (60, 90, 3)


def _head_outputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(3, 7, 5)) * 3).astype(np.float32)
    pred_boxes = rng.random((3, 7, 4)).astype(np.float32)
    return logits, pred_boxes, np.array([64, 50, 96], np.int32), np.array([96, 70, 64], np.int32)


def test_postprocess_predictions_matches():
    from detr_tpu.eval.postprocess import postprocess_predictions as jax_post
    from detr_tpu_torch.eval.postprocess import postprocess_predictions

    logits, pred_boxes, hs, ws = _head_outputs(8)
    ref = jax_post(*(jnp.asarray(x) for x in (logits, pred_boxes, hs, ws)))
    ours = postprocess_predictions(*(torch.from_numpy(x) for x in (logits, pred_boxes, hs, ws)))
    np.testing.assert_allclose(ours["scores"].numpy(), np.asarray(ref["scores"]), atol=1e-6)
    np.testing.assert_array_equal(ours["labels"].numpy(), np.asarray(ref["labels"]))
    assert ours["labels"].dtype == torch.int32
    np.testing.assert_allclose(ours["boxes"].numpy(), np.asarray(ref["boxes"]), atol=1e-4)


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_postprocess_class_matches(threshold):
    from detr_tpu.eval.postprocess import PostProcess as JaxPostProcess
    from detr_tpu_torch.eval.postprocess import PostProcess

    names = ["a", "b", "c", "d"]
    args = _head_outputs(9)
    ref = JaxPostProcess(names)(*args, score_threshold=threshold)
    ours = PostProcess(names)(*args, score_threshold=threshold)
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o["scores"], r["scores"], atol=1e-6)
        np.testing.assert_array_equal(o["labels"], r["labels"])
        np.testing.assert_allclose(o["boxes"], r["boxes"], atol=1e-4)
        assert o["class_names"] == r["class_names"]
