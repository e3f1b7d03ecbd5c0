"""The port's COCO input path against the JAX package's, on the CPU.

Data comes from each package's ``make_synthetic_coco.generate_split`` in
``tmp_path``.  Both packages' C++ image kernels are switched off
(``detr_tpu.data._native`` and ``detr_tpu_torch.data._native``, as
``tests/test_data.py`` switches the JAX one), so both sides run the
numpy/PIL path; the tests that run pixel operations are repeated with both
sides on their C++ kernels (``test_native_image_ops_leg``, and the
``native`` cases of the worker tests: the same source built with the same
flags).  Either way the same seeds must give the same numbers:
bytes, images and batches exactly, boxes within 1e-6 (the same float32
arithmetic), the card-side normalisation within 1e-6.  A spawned loader
worker does not see a switch set in the test process: it takes the C++
kernels, so a test that spawns workers compares them with the native leg.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tpu.data import _native
from detr_tpu_torch.data import _native as port_native
from detr_tpu.data import bucketing as jax_bucketing
from detr_tpu.data import coco as jax_coco
from detr_tpu.data import loader as jax_loader
from detr_tpu.data import make_synthetic_coco as jax_synth
from detr_tpu.data import transforms as jax_transforms
from detr_tpu.ops.image_norm import device_normalize_image as jax_device_normalize
from detr_tpu_torch.data import bucketing, coco, loader, make_synthetic_coco, transforms
from detr_tpu_torch.data.prefetch import DevicePlacement, prefetch_to_device
from detr_tpu_torch.ops.image_norm import device_normalize_image, prepare_image
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

N_TRAIN = 14


@pytest.fixture(autouse=True)
def image_ops(request, monkeypatch):
    """Both packages on their numpy/PIL image ops, or (param "native") both
    on their C++ kernels."""
    mode = getattr(request, "param", "numpy")
    if mode == "numpy":
        for mod in (_native, port_native):
            monkeypatch.setattr(mod, "_tried", True)
            monkeypatch.setattr(mod, "_lib", None)
    elif _native.load() is None or port_native.load() is None:
        pytest.skip("no C++ toolchain")
    return mode



@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A small synthetic COCO tree, written by the port's generator."""
    path = tmp_path_factory.mktemp("coco")
    make_synthetic_coco.generate_split(str(path), "train", N_TRAIN, seed=0)
    make_synthetic_coco.generate_split(str(path), "validation", 7, seed=1)
    return str(path)


def _assert_batches_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key == "boxes" or key == "boxes_normalized":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def _assert_targets_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "boxes":
            np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("kw", [{}, {"boxes_per_image": (8, 16), "max_overlap": 0.3,
                                     "num_classes": 7, "seed": 3}])
def test_generator_writes_the_jax_packages_bytes(tmp_path, kw):
    make_synthetic_coco.generate_split(str(tmp_path / "port"), "train", 5, **kw)
    jax_synth.generate_split(str(tmp_path / "jax"), "train", 5, **kw)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 6  # five JPEGs and labels.json
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_raw_target_and_class_maps_equal_jax(root):
    ours, ref = coco.CocoDataset(root, "train"), jax_coco.CocoDataset(root, "train")
    assert len(ours) == len(ref) == N_TRAIN
    assert ours.class_names == ref.class_names and ours.num_classes == ref.num_classes == 80
    assert ours.class_id2idx == ref.class_id2idx and ours.class_idx2id == ref.class_idx2id
    for i in range(len(ref)):
        _assert_targets_equal(ours.raw_target(i), ref.raw_target(i))
        np.testing.assert_array_equal(np.asarray(ours.load_image(i)),
                                      np.asarray(ref.load_image(i)))
    ours.transform = transforms.TrainTransform(seed=0)
    ref.transform = jax_transforms.TrainTransform(seed=0)
    ours.set_worker_seed(41)
    ref.set_worker_seed(41)
    assert ours.transform.rng.bit_generator.state == ref.transform.rng.bit_generator.state


@pytest.mark.parametrize("photometric", [True, False])
def test_train_transform_equals_jax(root, photometric):
    """Four seeds over four images each: the uint8 image exactly, the boxes
    within 1e-6, every other target field exactly; once normalised too."""
    ds = coco.CocoDataset(root, "train")
    for seed in range(4):
        ours = transforms.get_train_transforms(seed=seed, normalize=False,
                                               photometric=photometric)
        ref = jax_transforms.get_train_transforms(seed=seed, normalize=False,
                                                  photometric=photometric)
        for i in range(4):
            img, target = ds.load_image(i), ds.raw_target(i)
            got, want = ours(img, target), ref(img, target)
            assert got[0].dtype == np.uint8
            np.testing.assert_array_equal(got[0], want[0])
            _assert_targets_equal(got[1], want[1])
    got = transforms.TrainTransform(seed=9)(ds.load_image(5), ds.raw_target(5))
    want = jax_transforms.TrainTransform(seed=9)(ds.load_image(5), ds.raw_target(5))
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("photometric", [True, False])
def test_train_transform_source_wire_equals_jax(root, photometric):
    """``emit_source=True``: four seeds over six images each give the JAX
    package's source pixels, ``resize_to`` and boxes (1e-6)."""
    ds = coco.CocoDataset(root, "train")
    for seed in range(4):
        ours = transforms.get_train_transforms(seed=seed, normalize=False, emit_source=True,
                                               photometric=photometric)
        ref = jax_transforms.get_train_transforms(seed=seed, normalize=False, emit_source=True,
                                                  photometric=photometric)
        for i in range(6):
            img, target = ds.load_image(i), ds.raw_target(i)
            got, want = ours(img, target), ref(img, target)
            assert got[0].dtype == np.uint8
            np.testing.assert_array_equal(got[0], want[0])
            assert tuple(got[1]["resize_to"]) == tuple(want[1]["resize_to"])
            _assert_targets_equal(got[1], want[1])


def test_val_transform_source_wire_equals_jax(root):
    ds = coco.CocoDataset(root, "validation")
    for min_size, max_size in ((800, 1333), (640, 1066)):
        ours = transforms.get_val_transforms(normalize=False, emit_source=True,
                                             min_size=min_size, max_size=max_size)
        ref = jax_transforms.get_val_transforms(normalize=False, emit_source=True,
                                                min_size=min_size, max_size=max_size)
        for i in range(len(ds)):
            img, target = ds.load_image(i), ds.raw_target(i)
            got, want = ours(img, target), ref(img, target)
            np.testing.assert_array_equal(got[0], want[0])
            _assert_targets_equal(got[1], want[1])


def test_source_wire_geometry_equals_the_host_chain(root):
    """``tests/test_source_wire.py``'s geometry property on the port: for
    one seed the source wire's ``resize_to`` is the host chain's output
    shape, its box count the host chain's (the drop threshold scaled to the
    source), and the normalised boxes agree within the crop's rounding."""
    ds = coco.CocoDataset(root, "train")
    for seed in (11, 12):
        host = transforms.TrainTransform(seed=seed, normalize=False)
        src = transforms.TrainTransform(seed=seed, normalize=False, emit_source=True)
        for i in range(len(ds)):
            img, tgt = ds.load_image(i), ds.raw_target(i)
            h_img, h_tgt = host(img, dict(tgt))
            s_img, s_tgt = src(img, dict(tgt))
            assert tuple(s_tgt["resize_to"]) == h_img.shape[:2]
            assert len(s_tgt["boxes"]) == len(h_tgt["boxes"])
            if len(h_tgt["boxes"]):
                sh, sw = s_img.shape[:2]
                hh, hw = h_img.shape[:2]
                a = s_tgt["boxes"] / np.array([sw, sh, sw, sh], np.float32)
                b = h_tgt["boxes"] / np.array([hw, hh, hw, hh], np.float32)
                np.testing.assert_allclose(a, b, atol=2.5 / min(sh, sw))


@pytest.mark.parametrize("buckets", [
    bucketing.DEFAULT_BUCKETS, bucketing.EVAL_BUCKETS, ((640, 1088), (1088, 640)),
    ((256, 256),), ((832, 1344), (1344, 832)), ((704, 704), (800, 800))])
def test_derive_source_buckets_equals_jax(buckets):
    """The same canvases, or the same collision raised (832x1344 and
    1344x832 both cap to 672x672)."""
    try:
        want = jax_bucketing.derive_source_buckets(buckets)
    except ValueError as e:
        with pytest.raises(ValueError, match="collide"):
            bucketing.derive_source_buckets(buckets)
        assert "collide" in str(e)
        return
    assert bucketing.derive_source_buckets(buckets) == want


def test_fit_to_bucket_source_equals_jax(root):
    """The target shrunk into the bucket, and the source downscaled on the
    host only where it exceeds its canvas (the fallback)."""
    ds = coco.CocoDataset(root, "train", transforms.get_train_transforms(
        seed=2, normalize=False, emit_source=True))
    fell_back = 0
    for i in range(6):
        img, target = ds[i]
        for bucket, canvas in (((832, 1344), (512, 672)), ((256, 320), (96, 128))):
            got = bucketing.fit_to_bucket_source(img, dict(target), bucket, canvas)
            want = jax_bucketing.fit_to_bucket_source(img, dict(target), bucket, canvas)
            np.testing.assert_array_equal(got[0], want[0])
            _assert_targets_equal(got[1], want[1])
            fell_back += got[0].shape != img.shape
    assert fell_back >= 6


def test_assemble_batch_source_equals_jax(root):
    ds = coco.CocoDataset(root, "train", transforms.get_train_transforms(
        seed=4, normalize=False, emit_source=True))
    canvas = (672, 672)
    items = [bucketing.fit_to_bucket_source(*ds[i], (1056, 1056), canvas) for i in (0, 1, 2)]
    got = bucketing.assemble_batch_source(items, canvas, max_gt=6)
    want = jax_bucketing.assemble_batch_source(items, canvas, max_gt=6)
    _assert_batches_equal(got, want)
    assert got["image"].dtype == np.uint8 and got["src_height"].any()


def test_source_wire_loader_epochs_equal_jax(root):
    """Two epochs of ``wire="source"`` at num_workers=0, batch by batch:
    the batches bucket by the target size, and their images are source
    canvases."""
    ours, ref = _loaders(root, "train", dict(seed=1, normalize=False, emit_source=True),
                         batch_size=2, num_workers=0, seed=3, max_gt=12, wire="source")
    assert ours.source_buckets == ref.source_buckets == bucketing.DEFAULT_SOURCE_BUCKETS
    for epoch in (0, 2):
        ours.epoch = ref.epoch = epoch
        got, want = list(ours), list(ref)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
            assert g["image"].shape[1:3] in bucketing.DEFAULT_SOURCE_BUCKETS


@pytest.mark.parametrize("workers,image_ops", [(0, "numpy"), (0, "native"), (2, "native")],
                         ids=["0", "0-native", "2"], indirect=["image_ops"])
def test_source_wire_eval_loader_equals_jax(root, workers, image_ops):
    """The eval loader on the source wire, in order with the last batch
    padded, equals the JAX package's (sync); with two spawned workers too,
    which must receive the source canvases (and take the C++ kernels, so
    the JAX side takes its own)."""
    transform_args = dict(normalize=False, emit_source=True, min_size=640, max_size=1066)
    ours, ref = _loaders(root, "validation", transform_args, make="eval", batch_size=3,
                         num_workers=0, shape=(640, 1088), wire="source")
    if workers:
        ours = loader.make_eval_loader(ours.dataset, 3, num_workers=workers,
                                       shape=(640, 1088), wire="source")
    try:
        got, want = list(ours), list(ref)
        assert (ours._pool is not None) == bool(workers)
    finally:
        ours.close()
    assert ours.source_buckets == ((640, 672), (672, 640))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    assert sum(int(b["image_valid"].sum()) for b in got) == 7


@pytest.mark.parametrize("image_dtype", ["uint8", "float32"])
def test_assemble_batch_equals_jax(root, image_dtype):
    ds = coco.CocoDataset(root, "train", transforms.get_val_transforms(normalize=False))
    items = [ds[i] for i in (0, 1, 2)]
    bucket = (1344, 1344)
    got = bucketing.assemble_batch(items, bucket, max_gt=6, image_dtype=image_dtype)
    want = jax_bucketing.assemble_batch(items, bucket, max_gt=6, image_dtype=image_dtype)
    _assert_batches_equal(got, want)
    assert got["image"].dtype == np.dtype(image_dtype)


def _loaders(root, split, transform_args, **kw):
    make = kw.pop("make", None)
    pair = []
    for pkg_coco, pkg_t, pkg_loader in ((coco, transforms, loader),
                                        (jax_coco, jax_transforms, jax_loader)):
        get = pkg_t.get_train_transforms if split == "train" else pkg_t.get_val_transforms
        ds = pkg_coco.CocoDataset(root, split, get(**transform_args))
        if make == "eval":
            pair.append(pkg_loader.make_eval_loader(ds, **kw))
        else:
            pair.append(pkg_loader.BucketedLoader(ds, **kw))
    return pair


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_loader_epochs_equal_jax(root, shard):
    """Two epochs at num_workers=0 (the reproducible mode), batch by batch and
    key by key: the shuffle pinned to the epoch, per-bucket batches, uint8
    images; sharded, the half of each epoch the second of two processes
    keeps, cut to the same quota."""
    ours, ref = _loaders(root, "train", dict(seed=1, normalize=False), batch_size=2,
                         num_workers=0, seed=3, shard=shard, image_dtype="uint8", max_gt=12)
    for epoch in (0, 4):
        ours.epoch = ref.epoch = epoch
        got, want = list(ours), list(ref)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
    if shard[1] > 1:
        assert len(got) == ours._batch_quota()


def test_eval_loader_pads_like_jax(root):
    """In order, nothing dropped: the last short batch of each bucket
    repeats its last image, counted in pad_count and image_valid."""
    ours, ref = _loaders(root, "validation", dict(normalize=False), make="eval", batch_size=3,
                         num_workers=0, shape=(800, 1344), image_dtype="uint8")
    got, want = list(ours), list(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    assert sum(int(b["pad_count"]) for b in got) > 0
    assert sum(int(b["image_valid"].sum()) for b in got) == 7


def test_trainer_loaders_equal_jax(root):
    """The trainer's loaders from one configuration's fields in both
    packages (uint8, num_workers=0): the training loader's first epoch and
    the validation loader (val sizes, eval shape, val batch size), batch
    by batch."""
    from detr_tpu.config import TrainingConfig as JaxTrainingConfig
    from detr_tpu.train.trainer import _make_loaders as jax_make_loaders
    from detr_tpu_torch.config import TrainingConfig
    from detr_tpu_torch.train import trainer

    kw = dict(coco_dataset_root=root, num_workers=0, train_batch_size=2, val_batch_size=3,
              max_gt_boxes=12, val_min_size=400, val_max_size=667, eval_shape=(416, 672),
              photometric_distort=False, seed=5)
    ours_train, ours_val, num_classes, names = trainer._make_loaders(TrainingConfig(**kw),
                                                                     synthetic=False)
    ref_train, ref_val, ref_classes, ref_names = jax_make_loaders(JaxTrainingConfig(**kw), False)
    assert (num_classes, names) == (ref_classes, ref_names)
    for ours, ref in ((ours_train, ref_train), (ours_val, ref_val)):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
    assert got[0]["image"].shape[1:3] in ((416, 672), (672, 416))


def _image_multiset(batches):
    return sorted((int(i), b["image"][k].tobytes()) for b in batches
                  for k, i in enumerate(b["image_id"]))


@pytest.mark.parametrize("mode,image_ops", [("thread", "numpy"), ("thread", "native"),
                                            ("process", "native")],
                         ids=["thread", "thread-native", "process"], indirect=["image_ops"])
def test_workers_give_the_images_of_sync_mode(root, mode, image_ops):
    """Threads (and, once, spawned processes: slow to start) load the same
    images as the loader's own thread, with the deterministic val transform:
    the same multiset of (image_id, pixels).  Spawned workers take the C++
    kernels, so the loader's own thread does too."""
    ds = coco.CocoDataset(root, "validation", transforms.get_val_transforms(normalize=False))
    kw = dict(batch_size=2, shuffle=False, drop_last=False, image_dtype="uint8",
              buckets=bucketing.EVAL_BUCKETS)
    sync = list(loader.BucketedLoader(ds, num_workers=0, **kw))
    workers = loader.BucketedLoader(ds, num_workers=2, worker_mode=mode, **kw)
    try:
        got = list(workers)
        assert (workers._pool is not None) == (mode == "process")
    finally:
        workers.close()
    assert _image_multiset(got) == _image_multiset(sync)


def test_unpicklable_dataset_loads_with_threads_and_says_so(root, caplog):
    """Process mode with a dataset that cannot be shipped to a worker (a
    lambda transform): one warning, then threads load the same images."""
    val = transforms.get_val_transforms(normalize=False)
    ds = coco.CocoDataset(root, "validation", lambda img, t: val(img, t))
    kw = dict(batch_size=2, shuffle=False, drop_last=False, image_dtype="uint8",
              buckets=bucketing.EVAL_BUCKETS)
    workers = loader.BucketedLoader(ds, num_workers=2, worker_mode="process", **kw)
    with caplog.at_level("WARNING", logger="detr_tpu_torch.data.loader"):
        got = list(workers)
    assert workers._pool is None
    assert [r.message for r in caplog.records if "threads" in r.message]
    sync = list(loader.BucketedLoader(ds, num_workers=0, **kw))
    assert _image_multiset(got) == _image_multiset(sync)


def test_loader_refuses_a_shard_without_a_batch(root):
    ds = coco.CocoDataset(root, "train")
    with pytest.raises(ValueError, match="full batch"):
        loader.BucketedLoader(ds, batch_size=5, shard=(0, 4), num_workers=0)


def test_device_normalize_image_equals_jax():
    """uint8 -> fp32 x * scale - bias, within 1e-6 of the JAX function, and
    exactly 0.0 outside each image; fp32 passes prepare_image unchanged."""
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8)
    h, w = np.array([40, 17, 1], np.int32), np.array([56, 30, 56], np.int32)
    got = device_normalize_image(*(torch.from_numpy(x) for x in (image, h, w)))
    want = np.asarray(jax_device_normalize(jnp.asarray(image), jnp.asarray(h), jnp.asarray(w)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert not got[1, 17:].any() and not got[1, :, 30:].any() and not got[2, 1:].any()
    host = transforms.normalize(image[0])
    np.testing.assert_allclose(got[0].numpy(), host, atol=1e-6, rtol=0)
    fp32 = torch.from_numpy(host[None])
    assert prepare_image(fp32, torch.tensor([40]), torch.tensor([56])) is fp32


# The C++ leg of the tests above that run pixel operations.
NATIVE_LEGS = {
    "train_transform-photometric": lambda root: test_train_transform_equals_jax(root, True),
    "train_transform-plain": lambda root: test_train_transform_equals_jax(root, False),
    "train_transform_source-photometric":
        lambda root: test_train_transform_source_wire_equals_jax(root, True),
    "train_transform_source-plain":
        lambda root: test_train_transform_source_wire_equals_jax(root, False),
    "fit_to_bucket_source": test_fit_to_bucket_source_equals_jax,
    "assemble_batch_source": test_assemble_batch_source_equals_jax,
    "source_wire_loader_epochs": test_source_wire_loader_epochs_equal_jax,
    "assemble_batch-uint8": lambda root: test_assemble_batch_equals_jax(root, "uint8"),
    "assemble_batch-float32": lambda root: test_assemble_batch_equals_jax(root, "float32"),
    "loader_epochs-whole": lambda root: test_loader_epochs_equal_jax(root, (0, 1)),
    "loader_epochs-shard": lambda root: test_loader_epochs_equal_jax(root, (1, 2)),
    "eval_loader_pads": test_eval_loader_pads_like_jax,
    "trainer_loaders": test_trainer_loaders_equal_jax,
}


@pytest.mark.parametrize("image_ops", ["native"], indirect=True)
@pytest.mark.parametrize("leg", sorted(NATIVE_LEGS))
def test_native_image_ops_leg(root, leg, image_ops):
    """The test named by ``leg`` with both packages on their C++ kernels:
    the same bytes, images and batches as each other."""
    NATIVE_LEGS[leg](root)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "device-prefetch" and t.is_alive()]


def test_prefetch_keeps_order_and_applies_place_and_take():
    placed = []

    def place(b):
        placed.append(b)
        return b * 10

    out = list(prefetch_to_device(range(7), place, depth=2, take=lambda x: x + 1))
    assert out == [10 * i + 1 for i in range(7)] and placed == list(range(7))
    assert not _prefetch_threads()


def test_prefetch_reraises_at_next():
    def batches():
        yield 1
        raise RuntimeError("loader died")

    it = prefetch_to_device(batches(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="loader died"):
        next(it)


def test_prefetch_close_ends_the_thread():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    before = len(_prefetch_threads())
    it = prefetch_to_device(endless(), depth=2)
    assert next(it) == 0
    assert len(_prefetch_threads()) == before + 1
    it.close()
    assert len(_prefetch_threads()) == before


def test_device_placement_on_the_cpu_keeps_the_keys_asked_for():
    batch = {"image": np.ones((2, 4, 4, 3), np.uint8), "height": np.array([4, 3], np.int32),
             "pad_count": np.int32(0), "gt_valid": np.zeros((2, 5), bool)}
    placement = DevicePlacement("cpu", ("image", "height", "gt_valid"))
    assert placement.stream is None
    out = placement(batch)
    assert sorted(out) == ["gt_valid", "height", "image"]
    for key, t in out.items():
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), batch[key])
