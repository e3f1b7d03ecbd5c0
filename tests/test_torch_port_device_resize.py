"""The port's device resize (``ops.device_resize``) and the device-resize
wire's ``prepare_batch_image`` against the JAX package's, on the CPU.

The same uint8 sources, made from a seed with numpy, go through both
packages' functions; results agree within 2e-3 on the 0-255 scale (both are
fp32 products; JAX's at ``Precision.HIGHEST``).  Identity is exact, the
source canvas's padding changes nothing, and the target canvas's padding is
exactly 0, as ``tests/test_device_resize.py`` holds the JAX function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tpu.ops.device_resize import resize_on_device as jax_resize
from detr_tpu.ops.image_norm import prepare_batch_image as jax_prepare
from detr_tpu_torch.data.transforms import _NORM_SCALE
from detr_tpu_torch.ops.device_resize import resize_on_device
from detr_tpu_torch.ops.image_norm import prepare_batch_image
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

TOL = 2e-3  # on the 0-255 scale


def _case(seed, sources, targets, src_canvas, canvas):
    """uint8 sources padded into one source canvas, and the per-image
    extents, as numpy."""
    rng = np.random.default_rng(seed)
    sh, sw = src_canvas
    images = np.zeros((len(sources), sh, sw, 3), np.uint8)
    for b, (h, w) in enumerate(sources):
        images[b, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    ext = [np.array(v, np.int32) for v in ([s[0] for s in sources], [s[1] for s in sources],
                                           [t[0] for t in targets], [t[1] for t in targets])]
    return images, ext, canvas


def _both(images, ext, canvas):
    got = resize_on_device(torch.from_numpy(images), *(torch.from_numpy(e) for e in ext), canvas)
    want = jax_resize(jnp.asarray(images), *(jnp.asarray(e) for e in ext), canvas)
    return got.numpy(), np.asarray(want)


CASES = {
    "upscale": ([(40, 56)], [(100, 120)], (40, 56), (100, 128)),
    "downscale": ([(96, 128)], [(33, 47)], (96, 128), (40, 48)),
    "identity": ([(37, 53)], [(37, 53)], (37, 53), (37, 53)),
    "mixed_batch": ([(50, 70), (64, 32), (20, 20)], [(75, 105), (40, 20), (64, 64)],
                    (64, 80), (80, 112)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_resize_equals_jax(name):
    images, ext, canvas = _case(1, *CASES[name])
    got, want = _both(images, ext, canvas)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(images), *canvas, 3)
    assert np.abs(got - want).max() <= TOL


def test_identity_is_exact():
    images, ext, canvas = _case(2, *CASES["identity"])
    got, _ = _both(images, ext, canvas)
    np.testing.assert_array_equal(got, images.astype(np.float32))


def test_source_padding_has_no_effect():
    tight, ext, canvas = _case(3, [(30, 45)], [(52, 70)], (30, 45), (56, 72))
    padded = np.zeros((1, 64, 64, 3), np.uint8)
    padded[:, :30, :45] = tight
    a, _ = _both(tight, ext, canvas)
    b, _ = _both(padded, ext, canvas)
    assert np.abs(a - b).max() <= TOL


def test_canvas_padding_is_zero():
    images, ext, canvas = _case(4, [(32, 32), (24, 40)], [(48, 40), (30, 50)], (32, 40),
                                (64, 64))
    got, _ = _both(images, ext, canvas)
    assert not got[0, 48:].any() and not got[0, :, 40:].any()
    assert not got[1, 30:].any() and not got[1, :, 50:].any()
    assert got[0, :48, :40].mean() > 1.0


def _source_batch(seed):
    images, (sh, sw, th, tw), _ = _case(seed, [(40, 56), (56, 30)], [(70, 98), (50, 27)],
                                        (56, 64), (80, 112))
    return {"image": images, "src_height": sh, "src_width": sw, "height": th, "width": tw}


def test_prepare_batch_image_equals_jax():
    """Resampled into the canvas that canvas_map gives, normalised with the
    folded constants, exactly 0 outside each image; within 2e-3 of the JAX
    function on the 0-255 scale."""
    batch = _source_batch(5)
    canvas_map = {(56, 64): (80, 112), (64, 56): (112, 80)}
    got = prepare_batch_image({k: torch.from_numpy(v) for k, v in batch.items()},
                              canvas_map).numpy()
    want = np.asarray(jax_prepare({k: jnp.asarray(v) for k, v in batch.items()}, canvas_map))
    assert got.shape == want.shape == (2, 80, 112, 3)
    assert (np.abs(got - want) / _NORM_SCALE).max() <= TOL
    for b in range(2):
        h, w = int(batch["height"][b]), int(batch["width"][b])
        assert not got[b, h:].any() and not got[b, :, w:].any()
        assert np.abs(got[b, :h, :w]).mean() > 0.1


def test_a_source_batch_without_a_canvas_map_raises_as_in_jax():
    batch = _source_batch(6)
    with pytest.raises(ValueError, match="canvas_map"):
        prepare_batch_image({k: torch.from_numpy(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match="canvas_map"):
        jax_prepare({k: jnp.asarray(v) for k, v in batch.items()})
