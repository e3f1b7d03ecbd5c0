"""The port's torchvision trunk conversion and its dev harnesses
(``detr_tpu_torch.models.convert``, ``detr_tpu_torch.examples.dev_data``,
``dev_model``, ``visualize_results``) against the JAX package's, on the CPU.

The conversion takes a ``state_dict`` with torchvision's names and shapes
(``tests/test_convert.py::fake_torchvision_state_dict``; no torchvision
here).  ``dev_data --synthetic`` writes the JAX script's PNGs byte for
byte, both packages on their numpy/PIL image ops.  ``dev_model`` and
``visualize_results`` run once each at full width with random weights.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from detr_tpu.config import DETRConfig as JaxConfig
from detr_tpu.data import _native as jax_native
from detr_tpu.models import DETR as JaxDETR
from detr_tpu.models.convert import apply_backbone_weights as jax_apply_backbone_weights
from detr_tpu.models.convert import load_backbone_npz as jax_load_backbone_npz
from detr_tpu.models.convert import save_backbone_npz as jax_save_backbone_npz
from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.data import _native as port_native
from detr_tpu_torch.examples import dev_data, dev_model, visualize_results
from detr_tpu_torch.models import DETR, state_dict_from_jax
from detr_tpu_torch.models.convert import (
    apply_backbone_weights,
    convert_torch_state_dict,
    load_backbone_npz,
    save_backbone_npz,
)
from detr_tpu_torch.viz import plot_grid
from test_convert import fake_torchvision_state_dict
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

# A small transformer: the trunk is what the conversion fills.
HEAD = dict(num_object_queries=4, num_encoder_layers=1, num_decoder_layers=1,
            num_attention_heads=2, hidden_size=16, ffn_scale_factor=2, num_classes=3,
            dtype="float32")


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_save_backbone_npz_equals_the_jax_packages(backbone, tmp_path):
    """The same keys, dtypes and arrays, bit for bit (not the same file
    bytes: ``np.savez`` stamps the time into the zip); the trees of
    ``convert_torch_state_dict`` too, also from CPU tensors."""
    sd = fake_torchvision_state_dict(backbone)
    sd["fc.weight"] = np.zeros((1000, 2048), np.float32)  # torchvision's head: not read
    sd["bn1.num_batches_tracked"] = np.zeros((), np.int64)
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    save_backbone_npz(str(ours), sd, backbone)
    jax_save_backbone_npz(str(theirs), sd, backbone)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        assert sum(k.startswith("params:") for k in a.files) == (
            1 + 3 * sum((3, 4, 6 if backbone == "resnet50" else 23, 3)) + 4)
        for key in b.files:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            assert a[key].tobytes() == b[key].tobytes(), key
    from_tensors = convert_torch_state_dict({k: torch.from_numpy(np.asarray(v))
                                             for k, v in sd.items()}, backbone)
    jax_trees = jax_load_backbone_npz(str(theirs))
    flat = jax.tree_util.tree_leaves_with_path
    for got, want in zip(from_tensors, jax_trees):
        got_l, want_l = flat(got), flat(want)
        assert [p for p, _ in got_l] == [p for p, _ in want_l]
        for (path, g), (_, w) in zip(got_l, want_l):
            assert g.dtype == np.float32 and np.array_equal(g, w), path


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_apply_backbone_weights_equals_the_jax_graft(backbone, tmp_path):
    """The port's ``apply_backbone_weights`` of the port's .npz gives the
    trunk that ``state_dict_from_jax`` makes of the JAX
    ``apply_backbone_weights`` of it, bit for bit (the JAX variables'
    shapes from ``eval_shape``, no init)."""
    sd = fake_torchvision_state_dict(backbone)
    path = str(tmp_path / "trunk.npz")
    save_backbone_npz(path, sd, backbone)
    jcfg = JaxConfig(backbone=backbone, **HEAD)
    image = jnp.zeros((1, 64, 64, 3), jnp.float32)
    extent = jnp.full((1,), 64, jnp.int32)
    shapes = jax.eval_shape(JaxDETR(jcfg).init, jax.random.PRNGKey(0), image, extent, extent)
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    grafted = jax_apply_backbone_weights(variables, *jax_load_backbone_npz(path))
    cfg = DETRConfig(backbone=backbone, **HEAD)
    want = state_dict_from_jax(grafted["params"], grafted["frozen"], cfg)

    model = DETR(cfg)
    apply_backbone_weights(model, *load_backbone_npz(path))
    got = model.backbone.backbone.state_dict()
    assert len(got) == len([k for k in want if k.startswith("backbone.backbone.")])
    for name, value in got.items():
        assert torch.equal(value, want[f"backbone.backbone.{name}"]), name


@pytest.fixture
def numpy_image_ops(monkeypatch):
    """Both packages' augmentation on their numpy/PIL image ops."""
    for mod in (jax_native, port_native):
        monkeypatch.setattr(mod, "_tried", True)
        monkeypatch.setattr(mod, "_lib", None)


def test_dev_data_writes_the_jax_scripts_pngs(tmp_path, monkeypatch, capsys, numpy_image_ops):
    """``dev_data --synthetic``: the same four PNGs byte for byte, and the
    same printed shapes (the last line names each run's own directory)."""
    from examples import dev_data as jax_dev_data

    monkeypatch.setattr(sys, "argv", ["dev_data", "--synthetic", "--out", str(tmp_path / "jax")])
    jax_dev_data.main()
    want = capsys.readouterr().out.splitlines()
    assert dev_data.main(["--synthetic", "--out", str(tmp_path / "port")]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[:-1] == want[:-1] and len(got) == 4 + 3 + 1
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == [f"augmented_{i}.png" for i in range(4)]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_dev_model_writes_its_grid(tmp_path, capsys):
    """``dev_model --cpu``: DETR-R50 with random weights on two 640x640
    synthetic images, the loss dict, AP, and ``predictions.png`` of the size
    ``plot_grid`` gives two such images."""
    assert dev_model.main(["--cpu", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "pred_logits: (2, 6, 100, 81)" in out and "AP:" in out and "loss_giou" in out
    want = plot_grid([{"image": np.zeros((640, 640, 3), np.float32)}] * 2).shape
    size = Image.open(tmp_path / "predictions.png").size
    assert (size[1], size[0], 3) == want


def test_visualize_results_writes_its_grid(tmp_path, capsys):
    """``visualize_results --cpu --images``: the serving engine on two
    images, one line per image, and ``detections.png`` of the size
    ``plot_grid`` gives them."""
    rng = np.random.default_rng(1)
    paths = []
    for i, (h, w) in enumerate([(48, 64), (60, 80)]):
        paths.append(str(tmp_path / f"in{i}.png"))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(paths[-1])
    assert visualize_results.main(["--cpu", "--images", *paths, "--score-threshold", "0.0",
                                   "--out", str(tmp_path / "out")]) == 0
    out = capsys.readouterr().out
    assert "64x48: 100 detections >= 0.0" in out and "80x60: 100 detections" in out
    want = plot_grid([{"image": np.zeros((48, 64, 3), np.uint8)},
                      {"image": np.zeros((60, 80, 3), np.uint8)}]).shape
    size = Image.open(tmp_path / "out" / "detections.png").size
    assert (size[1], size[0], 3) == want


def test_the_examples_need_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (dev_model.main, visualize_results.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--out", str(tmp_path)])
