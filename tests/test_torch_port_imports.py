"""Import hygiene of the port: ``detr_tpu_torch`` and ``chip_smoke.py`` use
neither JAX (nor flax, optax, orbax) nor the JAX package ``detr_tpu``, nor
the ``safetensors`` and ``tensorboardX`` packages the JAX package writes its
files with.  The child process imports every module of the package, serves
one image, takes one train step on the CPU, saves and restores it as a
checkpoint, exports its weights, writes and reads a ``model.safetensors``,
logs scalars and an image grid, scores detections (the evaluator's C++ path
where it builds), and loads one COCO batch through a worker process (the
training augmentation's C++ image ops where they build), with those imports
refused in it and in the worker (a spawned worker runs the child's script
again, refusal included)."""

import ast
import os
import textwrap
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "safetensors", "tensorboardX", "detr_tpu")

_CHILD = r"""
import importlib, importlib.abc, os, pkgutil, sys

FORBIDDEN = %r

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ModuleNotFoundError(f"import of {name} refused")
        return None

sys.meta_path.insert(0, Refuse())

from detr_tpu_torch.data.coco import CocoDataset


class WorkerChecked(CocoDataset):
    # Loads only in another process, and only with nothing of JAX loaded.
    parent = None

    def __getitem__(self, idx):
        if os.getpid() == self.parent:
            raise RuntimeError("loaded in the parent, not in a worker process")
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
        if loaded:
            raise RuntimeError(f"the worker imported {loaded}")
        return super().__getitem__(idx)
"""

# The parent's part of the child, under the __main__ guard (a spawned worker
# runs the script as __mp_main__).
_CHILD_MAIN = r"""
import numpy as np
import detr_tpu_torch
for mod in pkgutil.walk_packages(detr_tpu_torch.__path__, "detr_tpu_torch."):
    importlib.import_module(mod.name)

from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.serve import InferenceEngine

tiny = DETRConfig(num_object_queries=4, num_encoder_layers=1, num_decoder_layers=1,
                  num_attention_heads=2, hidden_size=16, ffn_scale_factor=2,
                  num_classes=3, dtype="float32")
engine = InferenceEngine(tiny, batch_size=1, buckets=((64, 96), (96, 64)), min_size=64,
                         max_size=96, device="cpu")
det = engine.predict([np.zeros((64, 96, 3), np.uint8)])[0]
assert det["scores"].shape == (4,), det

import torch
from detr_tpu_torch.config import TrainingConfig
from detr_tpu_torch.data import synthetic_batch
from detr_tpu_torch.models import DETR
from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step
from detr_tpu_torch.train.trainer import to_device

tiny = tiny.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
tc = TrainingConfig(train_batch_size=1, cumulative_train_batch_size=1, max_gt_boxes=3)
model = DETR(tiny)
model.reset_parameters(torch.Generator().manual_seed(0))
opt, _ = build_optimizer(model, tc)
batch = synthetic_batch(np.random.default_rng(0), 1, 64, 64, max_gt=3, num_classes=3)
_, metrics = make_train_step(model, build_criterion(tc, tiny))(
    TrainState(model, opt, torch.Generator().manual_seed(0)), to_device(batch, torch.device("cpu")))
assert np.isfinite(float(metrics["loss"])) and opt.updates == 1, metrics

import tempfile
from detr_tpu_torch.eval import CocoEvaluator
from detr_tpu_torch.models.convert import load_reference_checkpoint, save_reference_checkpoint
from detr_tpu_torch.train.checkpoint import CheckpointManager
from detr_tpu_torch.utils.logging import MetricLogger

with tempfile.TemporaryDirectory() as out:
    state = TrainState(model, opt, torch.Generator().manual_seed(0))
    CheckpointManager(out).save(0, state, extra={"epoch": 0})
    fresh = DETR(tiny)
    opt2, _ = build_optimizer(fresh, tc)
    _, extra = CheckpointManager(out).restore(TrainState(fresh, opt2, torch.Generator()))
    assert extra == {"epoch": 0} and torch.equal(fresh.class_embedding.weight,
                                                 model.class_embedding.weight)
    save_reference_checkpoint(out + "/model.safetensors", model)
    sd = load_reference_checkpoint(out + "/model.safetensors", tiny)
    assert torch.equal(sd["class_embedding.weight"], model.class_embedding.weight)
    logger = MetricLogger(out + "/logs")
    logger.log_scalars({"a": 1.0}, 0)
    from detr_tpu_torch.viz import plot_grid
    logger.log_image("grid", plot_grid([{"image": np.zeros((8, 8, 3), np.uint8),
                                         "boxes": np.array([[1.0, 1.0, 5.0, 5.0]])}]), 0)
    logger.close()
    from detr_tpu_torch.train.export import export_weights
    assert export_weights(out, out + "/artifact") == (0, 0)
ev = CocoEvaluator(1)
ev.add_image(0, np.array([[0.0, 0, 9, 9]]), np.array([0.9]), np.array([0]),
             np.array([[0.0, 0, 9, 9]]), np.array([0]))
assert ev.compute()["AP"] == 1.0

import tempfile
from detr_tpu_torch.data import BucketedLoader, get_train_transforms
from detr_tpu_torch.data.make_synthetic_coco import generate_split

with tempfile.TemporaryDirectory() as root:
    generate_split(root, "train", 2)
    WorkerChecked.parent = os.getpid()
    ds = WorkerChecked(root, "train", get_train_transforms(normalize=False))
    loader = BucketedLoader(ds, 1, buckets=((64, 64),), num_workers=1, worker_mode="process",
                            image_dtype="uint8")
    try:
        batch = next(iter(loader))
        assert loader._pool is not None and batch["image"].shape == (1, 64, 64, 3), batch
    finally:
        loader.close()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not loaded, loaded
print("OK")
"""


def test_package_imports_and_serves_without_jax(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(_CHILD % (FORBIDDEN,) + "\n\ndef main():\n"
                     + textwrap.indent(_CHILD_MAIN, "    ")
                     + "\n\nif __name__ == '__main__':\n    main()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, str(child)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-3000:]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    [ROOT / "chip_smoke.py", *sorted((ROOT / "detr_tpu_torch").rglob("*.py"))],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_imports_nothing_of_jax(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_engine_without_device_needs_cuda(monkeypatch):
    from detr_tpu_torch.config import DETRConfig
    from detr_tpu_torch.serve import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(DETRConfig())
