"""The port's InferenceEngine: against the JAX engine on the same weights and
images, and the behaviour cases of tests/test_serve.py.

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
from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.serve import InferenceEngine
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
