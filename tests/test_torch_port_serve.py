"""The port's InferenceEngine: against the JAX engine on the same weights and
images, the behaviour cases of tests/test_serve.py, and the source wire's
canvas (uint8 requests resampled and normalised in ``_predict``) against the
host wire's.

Parity images are sized so the val resize (shortest side 64, longest 96) is
the identity, so only the model and the postprocess are compared.  The JAX
engine runs its Pallas attention in interpret mode.  Tolerances: scores
atol 1e-3 and boxes atol 0.05 px (fp32; the ResNet-50 trunk's summation
order drifts ~2e-4 relative, see tests/test_torch_port_model.py); labels
equal wherever the top-2 class-probability margin exceeds 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tpu.config import DETRConfig as JaxConfig
from detr_tpu.data.transforms import normalize as jax_normalize
from detr_tpu.models import DETR as JaxDETR
from detr_tpu.models import calibrate_frozen_bn
from detr_tpu.serve import InferenceEngine as JaxEngine
from detr_tpu_torch.config import DeformableDETRConfig, DETRConfig
from detr_tpu_torch.data.bucketing import fit_to_bucket, pick_bucket
from detr_tpu_torch.data.transforms import _NORM_BIAS, _NORM_SCALE
from detr_tpu_torch.models import DeformableDETR
from detr_tpu_torch.serve import InferenceEngine
from detr_tpu_torch.serve.engine import _empty_target
from detr_tpu_torch.utils import profiling
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
BUCKETS = ((64, 96), (96, 64))
KW = dict(batch_size=2, buckets=BUCKETS, min_size=64, max_size=96)


def _img(rng, h, w):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def parity_images():
    rng = np.random.default_rng(11)
    # identity val resize: short side 64 or long side 96 already
    return [_img(rng, 64, 96), _img(rng, 96, 64), _img(rng, 64, 80), _img(rng, 80, 64),
            _img(rng, 64, 70)]


@pytest.fixture(scope="module")
def variables(parity_images):
    model = JaxDETR(JAX_TINY.replace(use_pallas_attention=False))  # same tree, faster init
    v = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.zeros((1, 64, 96, 3)), jnp.array([64]),
                   jnp.array([96]))
    calib = np.stack([jax_normalize(parity_images[0]), jax_normalize(parity_images[0][::-1])])
    v = calibrate_frozen_bn(JAX_TINY, v, jnp.asarray(calib))
    return jax.tree.map(np.asarray, v)


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(TINY, class_names=["a", "b", "c"], device="cpu", **KW)


def test_engine_matches_jax_engine(variables, parity_images):
    ours = InferenceEngine(TINY, variables=variables, device="cpu", **KW)
    ref = JaxEngine(JAX_TINY, variables=jax.tree.map(jnp.asarray, variables), **KW)
    got, want = ours.predict(parity_images), ref.predict(parity_images)

    # top-2 class-probability margins from the port's own forward
    for img, g, w in zip(parity_images, got, want):
        h, wd = img.shape[:2]
        batch = np.zeros((1, *BUCKETS[0 if wd >= h else 1], 3), np.float32)
        batch[0, :h, :wd] = jax_normalize(img)
        with torch.inference_mode():
            out = ours.model(torch.from_numpy(batch), torch.tensor([h]), torch.tensor([wd]))
        probs = torch.softmax(out["pred_logits"][0, -1], -1)[:, :-1]
        top2 = probs.topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1] > 1e-4).numpy()

        assert g["scores"].shape == w["scores"].shape == (TINY.num_object_queries,)
        np.testing.assert_allclose(g["scores"], np.asarray(w["scores"]), atol=1e-3, rtol=0)
        np.testing.assert_allclose(g["boxes"], np.asarray(w["boxes"]), atol=0.05, rtol=0)
        np.testing.assert_array_equal(g["labels"][decisive], np.asarray(w["labels"])[decisive])


def test_predict_shapes_and_order(engine):
    rng = np.random.default_rng(0)
    images = [_img(rng, 100, 150), _img(rng, 150, 100), _img(rng, 30, 45),
              _img(rng, 200, 300), _img(rng, 64, 96)]
    results = engine.predict(images)
    assert len(results) == len(images)
    Q = TINY.num_object_queries
    for img, det in zip(images, results):
        assert set(det) >= {"scores", "labels", "boxes", "class_names"}
        n = len(det["scores"])
        assert n <= Q and det["boxes"].shape == (n, 4)
        assert all(name in ("a", "b", "c") for name in det["class_names"])
        oh, ow = img.shape[:2]  # boxes come back in ORIGINAL pixel coordinates
        assert (det["boxes"][:, [0, 2]] <= ow + 1e-3).all()
        assert (det["boxes"][:, [1, 3]] <= oh + 1e-3).all()
        assert (det["boxes"] >= -1e-3).all()


def test_batching_equivalence(engine):
    """A batched call returns exactly the per-image results (padded rows
    must not leak into real outputs)."""
    rng = np.random.default_rng(1)
    images = [_img(rng, 80, 120), _img(rng, 90, 60), _img(rng, 120, 80)]
    batched = engine.predict(images)
    for img, det in zip(images, batched):
        single = engine.predict([img])[0]
        np.testing.assert_allclose(single["scores"], det["scores"], rtol=1e-5)
        np.testing.assert_array_equal(single["labels"], det["labels"])
        np.testing.assert_allclose(single["boxes"], det["boxes"], rtol=1e-4, atol=1e-3)


def test_score_threshold():
    eng = InferenceEngine(
        TINY, batch_size=1, buckets=BUCKETS, min_size=64, max_size=96,
        score_threshold=1.1, device="cpu",  # impossible: softmax scores < 1
    )
    det = eng.predict([np.zeros((70, 70, 3), np.uint8)])[0]
    assert len(det["scores"]) == 0 and det["boxes"].shape == (0, 4)


def test_unit_scale_float_rejected(engine):
    rng = np.random.default_rng(1)
    img01 = rng.random((64, 96, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="0-255"):
        engine.predict([img01])
    assert len(engine.predict([img01 * 255.0])) == 1


def test_dark_float_images_accepted(engine):
    black = np.zeros((64, 96, 3), np.float32)
    dark = np.full((64, 96, 3), 2.0, np.float32)
    results = engine.predict([black, dark])
    assert len(results) == 2
    assert all("scores" in r for r in results)


def test_warmup_runs_every_bucket(engine):
    engine.warmup()
    det = engine.predict([np.zeros((64, 96, 3), np.uint8)])[0]
    assert np.isfinite(det["scores"]).all() and np.isfinite(det["boxes"]).all()


def _model_inputs(engine, images):
    """The canvases the engine's forwards receive while it serves ``images``."""
    seen = []
    hook = engine.model.register_forward_pre_hook(lambda _m, args: seen.append(args[0].clone()))
    try:
        engine.predict(images)
    finally:
        hook.remove()
    return seen


def _levels(canvas: np.ndarray) -> np.ndarray:
    """The uint8 levels a normalised canvas holds, checked to lie on the
    normalisation's grid (the host's C++ normalise fuses its multiply-add,
    torch does not: one fp32 rounding apart)."""
    levels = np.rint((canvas + _NORM_BIAS) / _NORM_SCALE)
    np.testing.assert_allclose(levels * _NORM_SCALE - _NORM_BIAS, canvas, rtol=0, atol=1e-5)
    return levels.astype(int)


@pytest.mark.parametrize("size", [(30, 45), (45, 30), (200, 300), (300, 200), (64, 96), (96, 64)],
                         ids=["up", "up-portrait", "down", "down-portrait", "same", "same-portrait"])
def test_source_wire_canvas_matches_host_canvas(engine, size):
    """A uint8 request's card-side canvas (the source canvas resampled,
    rounded and normalised by ``resample_sources``) against the host wire's
    (``ValTransform``, ``fit_to_bucket``, the float32 canvas): within one
    uint8 level everywhere, a level apart on at most 5 % of the pixels (the
    two sum in fp32 in different orders, so a value near .5 rounds either
    way), the very source where the size is kept, and exactly 0.0 outside
    the image."""
    img = _img(np.random.default_rng(sum(size)), *size)
    (got,) = _model_inputs(engine, [img])
    assert got.dtype == torch.float32 and got.is_contiguous()
    timg, _ = engine.transform(img, _empty_target())
    bucket = BUCKETS[pick_bucket(timg.shape[0], timg.shape[1], BUCKETS)]
    timg, _ = fit_to_bucket(timg, _empty_target(), bucket)
    th, tw = timg.shape[:2]
    host = np.zeros((*bucket, 3), np.float32)
    host[:th, :tw] = timg

    mine = got[0].numpy()
    assert mine.shape == host.shape
    assert not mine[th:].any() and not mine[:, tw:].any()
    diff = np.abs(_levels(mine[:th, :tw]) - _levels(host[:th, :tw]))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.05
    if (th, tw) == size:
        np.testing.assert_array_equal(_levels(mine[:th, :tw]), img)


def test_mixed_wires_return_what_each_returns_alone(engine):
    """uint8 and float requests in one call go in batches of their own wire,
    and each comes back in input order as it does alone."""
    rng = np.random.default_rng(4)
    images = [_img(rng, 80, 120), _img(rng, 90, 60).astype(np.float32), _img(rng, 70, 100),
              _img(rng, 60, 90).astype(np.float32), _img(rng, 120, 80)]
    mixed = engine.predict(images)
    for img, det in zip(images, mixed):
        alone = engine.predict([img])[0]
        np.testing.assert_allclose(alone["scores"], det["scores"], rtol=1e-5)
        np.testing.assert_array_equal(alone["labels"], det["labels"])
        np.testing.assert_allclose(alone["boxes"], det["boxes"], rtol=1e-4, atol=1e-3)


def test_device_resized_counts_only_uint8_images(engine):
    rng = np.random.default_rng(5)
    images = [_img(rng, 64, 96), _img(rng, 64, 96).astype(np.float32), _img(rng, 96, 64),
              _img(rng, 50, 70)]
    before = profiling.counters()
    inputs = _model_inputs(engine, images)
    after = profiling.counters()
    delta = {k: after[k] - before.get(k, 0) for k in after}
    assert delta["serve.images"] == 4 and delta["serve.device_resized"] == 3
    # landscape uint8 (2 images), landscape float, portrait uint8
    assert delta["serve.batches"] == len(inputs) == 3


def test_deformable_config_serves_deformable_detr_by_its_top_k():
    """A ``DeformableDETRConfig`` serves Deformable DETR, read by its focal
    head: the top k (query, class) pairs of each image, more than its Q
    queries here, scores descending; the JAX package's DETR weights are
    refused for it."""
    config = DeformableDETRConfig(**dataclasses.asdict(TINY))
    eng = InferenceEngine(config, device="cpu", **KW)
    assert isinstance(eng.model, DeformableDETR)
    rng = np.random.default_rng(6)
    results = eng.predict([_img(rng, 64, 96), _img(rng, 96, 64), _img(rng, 64, 80)])
    k = min(eng.head.top_k, config.num_object_queries * config.num_classes)
    assert k > config.num_object_queries
    for det in results:
        assert len(det["scores"]) == k and det["boxes"].shape == (k, 4)
        assert (np.diff(det["scores"]) <= 0).all()
        assert ((det["labels"] >= 0) & (det["labels"] < config.num_classes)).all()
    with pytest.raises(ValueError, match="DeformableDETR"):
        InferenceEngine(config, variables={}, device="cpu", **KW)
