"""The port's host C++ layer against the JAX package's, on the CPU.

* Image ops (``detr_tpu_torch.data._native``, ``native/image_ops.cc``): the
  port's library gives the JAX package's bytes exactly (the same source
  built with the same flags on the same host), and the port's numpy/PIL
  path within ``tests/test_data.py``'s tolerances: 5e-3 for the float ops,
  1e-5 for the normalisation, one uint8 level from PIL for the resize.
* ``utils.native_build``: the four cases of ``tests/test_native_build.py``
  (build and call, a fresh library after a source edit within the process,
  no toolchain gives None, no temporary file left by a failed compile).
* The loaders build from the port's own sources into ``build/native/``.
* ``BucketedLoader``'s spawned workers start with one OpenMP thread each,
  unless the caller's environment says otherwise.
* The evaluator (``eval._native``, ``native/cocoeval.cc``): the port's
  batched ``compute()`` equals the JAX package's batched ``compute()`` and
  the port's numpy path exactly, on ``tests/test_coco_eval.py``'s content
  (crowds, area edges, empty images, a same-class overflow past 100
  detections), and an image of 4096 GTs takes the per-image path.

Each test skips without a C++ toolchain, as the JAX package's own do.
"""

import ctypes
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from detr_tpu.data import _native as jax_native
from detr_tpu.eval import _native as jax_eval_native
from detr_tpu.eval.coco_eval import CocoEvaluator as JaxCocoEvaluator
from detr_tpu_torch.data import BucketedLoader, _native
from detr_tpu_torch.data import loader as loader_module
from detr_tpu_torch.data import transforms as T
from detr_tpu_torch.eval import _native as eval_native
from detr_tpu_torch.eval.coco_eval import CocoEvaluator
from detr_tpu_torch.utils import native_build
from detr_tpu_torch.utils.native_build import NativeLib

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def libs():
    if not (jax_native.load() and _native.load() and jax_eval_native.load()
            and eval_native.load()):
        pytest.skip("no C++ toolchain")


@pytest.fixture
def numpy_path(monkeypatch):
    """Call to take the port's numpy/PIL path for the rest of the test."""
    def switch():
        monkeypatch.setattr(_native, "_tried", True)
        monkeypatch.setattr(_native, "_lib", None)
    return switch


def _image(seed, shape=(120, 90, 3)):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


FLOAT_OPS = {
    "hue+0.04": (lambda m, x: m.hue_rotate(x, 0.04), lambda x: T.adjust_hue(x, 0.04)),
    "hue-0.03": (lambda m, x: m.hue_rotate(x, -0.03), lambda x: T.adjust_hue(x, -0.03)),
    "hue+0.5": (lambda m, x: m.hue_rotate(x, 0.5), lambda x: T.adjust_hue(x, 0.5)),
    "brightness1.11": (lambda m, x: m.affine_gray(x, 1.11, 0.0, 0.0),
                       lambda x: T.adjust_brightness(x, 1.11)),
    "brightness0.9": (lambda m, x: m.affine_gray(x, 0.9, 0.0, 0.0),
                      lambda x: T.adjust_brightness(x, 0.9)),
    "contrast0.75": (lambda m, x: m.affine_gray(x, 0.75, 0.0, 0.25 * m.gray_mean(x)),
                     lambda x: T.adjust_contrast(x, 0.75)),
    "saturation1.18": (lambda m, x: m.affine_gray(x, 1.18, 1.0 - 1.18, 0.0),
                       lambda x: T.adjust_saturation(x, 1.18)),
}


@pytest.mark.parametrize("op", sorted(FLOAT_OPS))
def test_float_op_equals_jax_native_and_numpy(op, libs, numpy_path):
    native_op, transform = FLOAT_OPS[op]
    img = _image(1)
    ours = native_op(_native, img)
    assert ours.dtype == np.float32 and ours.shape == img.shape
    np.testing.assert_array_equal(ours, native_op(jax_native, img))
    assert np.array_equal(transform(img), ours)  # the transform takes the library
    numpy_path()
    np.testing.assert_allclose(ours, transform(img), atol=5e-3, rtol=0)


def test_gray_mean_equals_jax_native_and_numpy(libs):
    img = _image(2, (333, 517, 3))
    ours = _native.gray_mean(img)
    assert ours == jax_native.gray_mean(img)
    assert ours == pytest.approx(float(T._grayscale(img).mean()), rel=1e-6)


def test_normalize_equals_jax_native_and_numpy(libs, numpy_path):
    u8 = _image(3).astype(np.uint8)
    ours = T.normalize(u8)
    np.testing.assert_array_equal(ours, jax_native.normalize_u8(u8, T._NORM_SCALE, T._NORM_BIAS))
    want = (u8.astype(np.float32) / 255.0 - T.IMAGENET_MEAN) / T.IMAGENET_STD
    np.testing.assert_allclose(ours, want, atol=1e-5, rtol=0)
    numpy_path()
    np.testing.assert_allclose(T.normalize(u8), ours, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [(61, 108), (246, 434), (100, 300), (123, 217)])
def test_resize_equals_jax_native_and_pil(size, libs, numpy_path):
    """Down, up, mixed and the identity: the JAX package's bytes, and at
    most one level from PIL's bilinear filter (the port's numpy path)."""
    nh, nw = size
    u8 = _image(4, (123, 217, 3)).astype(np.uint8)
    target = {"boxes": np.zeros((0, 4), np.float32)}
    ours, _ = T.resize(u8, target, nh, nw)
    assert ours.shape == (nh, nw, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, jax_native.resize_bilinear(u8, nh, nw))
    numpy_path()
    pil, _ = T.resize(u8, target, nh, nw)
    np.testing.assert_array_equal(pil, np.asarray(Image.fromarray(u8).resize((nw, nh),
                                                                              Image.BILINEAR)))
    assert np.abs(ours.astype(np.int16) - pil.astype(np.int16)).max() <= 1


def test_photometric_distort_equals_jax_native(libs):
    """The whole distort chain, ten draws: the JAX package's bytes."""
    from detr_tpu.data import transforms as jax_transforms

    img = _image(5, (97, 131, 3)).astype(np.uint8)
    for seed in range(10):
        ours = T.photometric_distort(img, np.random.default_rng(seed))
        want = jax_transforms.photometric_distort(img, np.random.default_rng(seed))
        np.testing.assert_array_equal(ours, want)


def test_loaders_build_the_ports_sources_into_build_native(libs):
    for loader, name in ((_native, "image_ops"), (eval_native, "cocoeval")):
        src = Path(loader._SRC)
        assert src == ROOT / "detr_tpu_torch" / "native" / f"{name}.cc" and src.is_file()
        assert Path(loader._native_lib._build_dir) == ROOT / "build" / "native"
        path = Path(loader._native_lib._lib_path())
        assert path.is_file() and path.parent == native_build.BUILD_DIR
        assert loader.built_flags().startswith(native_build.COMPILERS)
    assert "-fopenmp" in _native.built_flags()
    assert not list((ROOT / "detr_tpu_torch" / "native").glob("*.so"))


# ------------------------------------------------------------ native_build

SRC = """
#include <cstdint>
extern "C" {
int the_answer(void) { return 42; }
%s
}
"""


@pytest.fixture
def cxx():
    if not any(shutil.which(c) for c in native_build.COMPILERS):
        pytest.skip("no C++ toolchain")


def _bind(lib):
    lib.the_answer.restype = ctypes.c_int
    lib.second_symbol.restype = ctypes.c_int  # raises on a stale library


def test_native_build_builds_loads_and_calls(tmp_path, cxx):
    src = tmp_path / "mini.cc"
    src.write_text(SRC % "int second_symbol(void) { return 7; }")
    out = tmp_path / "out"
    lib = NativeLib(str(src), ([],), _bind, build_dir=str(out)).load()
    assert lib is not None and lib.the_answer() == 42 and lib.second_symbol() == 7
    assert [p.suffix for p in sorted(out.iterdir())] == [".flags", ".so"]
    again = NativeLib(str(src), ([],), _bind, build_dir=str(out))
    assert again.load() is not None and again.built_flags.endswith("-fPIC")
    assert not list(tmp_path.glob("*.so"))  # nothing beside the source


def test_native_build_source_edit_gets_a_fresh_library(tmp_path, cxx):
    """The library's name is keyed on the source's content: after an edit
    that adds a symbol, a new loader sees it although the old library is
    still loaded in this process; the old one is removed."""
    src = tmp_path / "mini.cc"
    src.write_text(SRC % "")
    old = NativeLib(str(src), ([],), lambda lib: None, build_dir=str(tmp_path)).load()
    assert old is not None and old.the_answer() == 42
    src.write_text(SRC % "int second_symbol(void) { return 7; }")
    new = NativeLib(str(src), ([],), _bind, build_dir=str(tmp_path)).load()
    assert new is not None and new.second_symbol() == 7
    assert len(list(tmp_path.glob("*.so"))) == 1 and len(list(tmp_path.glob("*.flags"))) == 1


def test_native_build_without_a_toolchain_is_none(tmp_path, monkeypatch, cxx):
    src = tmp_path / "mini.cc"
    src.write_text(SRC % "int second_symbol(void) { return 7; }")
    monkeypatch.setenv("PATH", str(tmp_path))  # no compiler reachable
    assert NativeLib(str(src), ([],), _bind, build_dir=str(tmp_path)).load() is None


def test_native_build_failed_compile_leaves_no_temporary(tmp_path, cxx):
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++")
    lib = NativeLib(str(src), (["-fopenmp"], []), _bind, build_dir=str(tmp_path / "out"))
    assert lib.load() is None
    assert not [p for p in os.listdir(tmp_path / "out") if p.endswith(".tmp")]


# ---------------------------------------------------------------- evaluator


def _boxes(rng, n, scale=300.0):
    b = np.sort(rng.uniform(0, scale, (n, 2, 2)), axis=1)
    return b.reshape(n, 4)[:, [0, 2, 1, 3]].astype(np.float64)


def _fill(evaluators, seed, n_images=40, num_classes=7):
    """``tests/test_coco_eval.py``'s batched-path content: 0-9 GTs (a quarter
    crowds) and 0-13 detections per image, scores on a 0.1 grid (ties),
    image 3 with 130 detections of one class."""
    rng = np.random.default_rng(seed)
    for i in range(n_images):
        ng, nd = int(rng.integers(0, 10)), int(rng.integers(0, 14))
        if i == 3:
            nd = 130
            dl = np.zeros(nd, np.int64)
        else:
            dl = rng.integers(0, num_classes, nd)
        row = (i, _boxes(rng, nd), np.round(rng.random(nd), 1), dl, _boxes(rng, ng),
               rng.integers(0, num_classes, ng), rng.random(ng) < 0.25)
        for ev in evaluators:
            ev.add_image(*row)


def _assert_same_dict(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_evaluator_equals_jax_and_the_numpy_path(seed, libs, monkeypatch):
    ours, ref = CocoEvaluator(7), JaxCocoEvaluator(7)
    _fill((ours, ref), seed)
    calls = []
    batched = CocoEvaluator._class_precisions_batched
    monkeypatch.setattr(CocoEvaluator, "_class_precisions_batched",
                        lambda self, p, c: calls.append(c) or batched(self, p, c))
    got = ours.compute()
    assert calls == list(range(7))  # the batched path, every class
    _assert_same_dict(got, ref.compute())
    monkeypatch.setattr(eval_native, "_tried", True)
    monkeypatch.setattr(eval_native, "_lib", None)
    calls.clear()
    numpy_ev = CocoEvaluator(7)
    _fill((numpy_ev,), seed)
    _assert_same_dict(numpy_ev.compute(), got)
    assert not calls  # no library: the numpy path


def test_an_image_of_4096_gts_takes_the_per_image_path(libs, monkeypatch):
    """``evaluate_blocks`` refuses an image of 4096 or more GTs; that class
    falls back to the per-image path and gives the numpy path's numbers."""
    rng = np.random.default_rng(0)
    gts = _boxes(rng, 4096, 1000.0)
    dets = gts[:3] + rng.normal(0, 2, (3, 4))
    row = (0, dets, rng.random(3), np.zeros(3, np.int64), gts, np.zeros(4096, np.int64),
           np.zeros(4096, bool))
    ours = CocoEvaluator(1)
    ours.add_image(*row)
    prep = ours._prepare_batched()
    assert ours._class_precisions_batched(prep, 0) is None
    got = ours.compute()
    monkeypatch.setattr(eval_native, "_tried", True)
    monkeypatch.setattr(eval_native, "_lib", None)
    numpy_ev = CocoEvaluator(1)
    numpy_ev.add_image(*row)
    _assert_same_dict(got, numpy_ev.compute())


def test_loader_workers_take_one_openmp_thread(monkeypatch):
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    loader = BucketedLoader(list(range(8)), 1, num_workers=2, worker_mode="process")
    try:
        assert loader._start_pool()
        got = loader._pool.map(os.getenv, ["OMP_NUM_THREADS"] * 2, chunksize=1)
    finally:
        loader.close()
    assert got == ["1", "1"]
    assert "OMP_NUM_THREADS" not in os.environ  # the caller's environment, restored


def test_loader_workers_keep_the_callers_openmp_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    with loader_module._worker_openmp_env():
        assert os.environ["OMP_NUM_THREADS"] == "3"
    assert os.environ["OMP_NUM_THREADS"] == "3"
