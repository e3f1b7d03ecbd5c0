"""The port's detection images (``detr_tpu_torch.viz``) and the validation
image grids against the JAX package's, on the CPU.

``plot``, ``plot_grid`` and ``render_bounding_boxes`` give the JAX
package's bytes on the same inputs: normalised float and uint8 images,
boxes, names, scores, the default colour cycle.  ``run_validation``
with ``log_images`` hands a stub tracker the same two grids as the JAX
``run_validation`` on the same host batches and the same model outputs (a
stub eval step on each side), on the target wire and on the device-resize
wire, where the boxes are scaled back to the source pixels.
"""

import itertools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from detr_tpu.train.trainer import run_validation as jax_run_validation
from detr_tpu.viz import plot as jax_plot
from detr_tpu.viz import plot_grid as jax_plot_grid
from detr_tpu.viz import render_bounding_boxes as jax_render
from detr_tpu_torch.data import CocoDataset, get_val_transforms, make_eval_loader
from detr_tpu_torch.data.make_synthetic_coco import generate_split
from detr_tpu_torch.data.prefetch import DevicePlacement
from detr_tpu_torch.train.trainer import BATCH_KEYS, run_validation
from detr_tpu_torch.viz import plot, plot_grid, render_bounding_boxes
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

NUM_CLASSES = 80
Q = 12


def _items(rng, n, normalised):
    items = []
    for i in range(n):
        h, w = int(rng.integers(30, 70)), int(rng.integers(30, 70))
        if normalised:
            image = rng.normal(size=(h, w, 3)).astype(np.float32)
        else:
            image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        k = int(rng.integers(0, 4))
        xy = rng.uniform(0, min(h, w) / 2, (k, 2))
        item = {"image": image, "boxes": np.concatenate([xy, xy + rng.uniform(2, 30, (k, 2))], 1)}
        if i % 2:
            item["class_names"] = [f"c{j}" for j in range(k)]
        if i % 3:
            item["scores"] = rng.random(k)
        items.append(item)
    return items


@pytest.mark.parametrize("normalised", [False, True])
def test_plot_and_plot_grid_equal_jax(normalised):
    rng = np.random.default_rng(int(normalised))
    items = _items(rng, 7, normalised)
    for it in items:
        np.testing.assert_array_equal(
            plot(it["image"], it["boxes"], it.get("class_names"), it.get("scores"),
                 box_color="blue"),
            jax_plot(it["image"], it["boxes"], it.get("class_names"), it.get("scores"),
                     box_color="blue"))
    for kw in ({}, {"num_cols": 3, "box_color": "red"}, {"max_images": 4}):
        got, want = plot_grid(items, **kw), jax_plot_grid(items, **kw)
        assert got.dtype == np.uint8 and got.ndim == 3
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plot_grid([]), jax_plot_grid([]))


@pytest.mark.parametrize("color", ["red", None])
def test_render_bounding_boxes_equals_jax(color):
    rng = np.random.default_rng(2)
    image = Image.fromarray(rng.integers(0, 256, (80, 120, 3), dtype=np.uint8))
    anns = [{"bbox": [float(x), float(y), 20.0, 15.0], "category_id": c}
            for x, y, c in zip(rng.uniform(0, 90, 10), rng.uniform(0, 60, 10), range(10))]
    names = {c: f"name{c}" for c in range(0, 10, 2)}
    for kw in ({"color": color}, {"color": color, "class_id2name": names, "width": 3}):
        got = render_bounding_boxes(image, anns, **kw)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(jax_render(image, anns, **kw)))
    assert np.asarray(image).sum() != np.asarray(got).sum()  # drawn on a copy


class _Tracker:
    """A MetricLogger stand-in that keeps the images it is given."""

    def __init__(self):
        self.images = {}

    def log_scalars(self, scalars, step):
        pass

    def log_loss_dict(self, loss_dict, step, split="train"):
        pass

    def log_image(self, tag, image, step):
        self.images[tag] = (np.array(image), step)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("coco"))
    generate_split(path, "validation", 8, seed=6)
    return path


def _outputs(rng, batch_size):
    """Model outputs of one batch: (B, 1, Q, C+1) logits, some queries
    scoring over 0.5, and (B, 1, Q, 4) cxcywh boxes inside the image."""
    logits = rng.normal(size=(batch_size, 1, Q, NUM_CLASSES + 1)).astype(np.float32)
    hot = rng.random((batch_size, 1, Q)) < 0.4
    logits[..., 3] += np.where(hot, 12.0, 0.0)
    c = rng.uniform(0.3, 0.7, (batch_size, 1, Q, 2))
    wh = rng.uniform(0.05, 0.4, (batch_size, 1, Q, 2))
    return logits, np.concatenate([c, wh], -1).astype(np.float32)


@pytest.mark.parametrize("wire", ["target", "source"])
def test_run_validation_logs_the_jax_packages_grids(root, wire):
    ds = CocoDataset(root, "validation",
                     get_val_transforms(normalize=False, emit_source=wire == "source",
                                        min_size=64, max_size=107))
    batches = list(make_eval_loader(ds, 5, max_gt=8, num_workers=0, shape=(64, 96),
                                    image_dtype="uint8", wire=wire))
    assert ("src_height" in batches[0]) == (wire == "source")
    rng = np.random.default_rng(7)
    outputs = [_outputs(rng, len(b["image"])) for b in batches]

    jax_calls = itertools.count()

    def jax_step(params, frozen, batch):
        logits, boxes = outputs[next(jax_calls)]
        return {"pred_logits": jnp.asarray(logits), "pred_boxes": jnp.asarray(boxes)}, {}

    port_calls = itertools.count()

    def port_step(batch):
        logits, boxes = outputs[next(port_calls)]
        return {"pred_logits": torch.from_numpy(logits), "pred_boxes": torch.from_numpy(boxes)}, {}

    want, got = _Tracker(), _Tracker()
    jax_run_validation((jax_step, SimpleNamespace(params=None, frozen=None)), batches,
                       ds.class_names, tracker=want, global_step=9, log_images=True)
    run_validation(port_step, batches, ds.class_names, DevicePlacement("cpu", BATCH_KEYS),
                   tracker=got, global_step=9, log_images=True)
    assert sorted(got.images) == sorted(want.images) == ["val-ground-truth", "val-predictions"]
    for tag, (image, step) in want.images.items():
        assert got.images[tag][1] == step == 9
        assert got.images[tag][0].dtype == np.uint8 and got.images[tag][0].shape == image.shape
        np.testing.assert_array_equal(got.images[tag][0], image, err_msg=tag)
    # red prediction boxes were drawn: some query scored 0.5 or more
    preds = got.images["val-predictions"][0]
    assert ((preds[..., 0] == 255) & (preds[..., 1] == 0) & (preds[..., 2] == 0)).any()

    silent = _Tracker()
    port_calls = itertools.count()
    run_validation(port_step, batches, ds.class_names, DevicePlacement("cpu", BATCH_KEYS),
                   tracker=silent, log_images=False)
    assert not silent.images
