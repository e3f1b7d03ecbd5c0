"""The hash dropout's autograd Function (``ops/dropout.py::hash_dropout``)
on the CPU: its plain path against the plain composition
``hash_dropout_reference`` (``where(keep, x * scale, 0)`` differentiated by
autograd), bit for bit both ways; no tensor saved for the backward; its
counters; the kernel wrapper's refusals.  The kernel itself is held to the
same composition on the card (``tests/test_torch_port_gpu.py``)."""

import pytest
import torch

from detr_tpu_torch.ops import dropout
from detr_tpu_torch.ops.dropout import hash_dropout, hash_dropout_reference
from detr_tpu_torch.utils import profiling
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}

# (shape, batch_offset, col_offset, total_cols): one process's array, a data
# parallel rank's block of batch rows, a tensor parallel rank's block of FFN
# columns, and both
OFFSETS = [((3, 37, 48), 0, 0, None), ((2, 11, 24), 3, 0, None),
           ((2, 11, 24), 0, 24, 96), ((3, 5, 40), 2, 40, 80)]


def _inputs(shape, dtype, seed):
    """x and an incoming gradient with a NaN, an inf or a -inf at every
    seventh element, so that some of them are dropped."""
    gen = torch.Generator().manual_seed(seed)
    x, dy = (torch.randn(shape, generator=gen).to(dtype) for _ in range(2))
    for t in (x, dy):
        flat = t.view(-1)
        flat[0::21], flat[7::21], flat[14::21] = float("nan"), float("inf"), float("-inf")
    return x, dy


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(_BITS[a.dtype]), b.view(_BITS[b.dtype]))


@pytest.mark.parametrize("case", range(len(OFFSETS)))
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_matches_the_plain_composition_bit_for_bit(dtype, rate, case):
    shape, b0, c0, width = OFFSETS[case]
    x, dy = _inputs(shape, dtype, seed=case)
    leaf = x.clone().requires_grad_(True)
    got = hash_dropout(leaf, rate, 1234, False, b0, c0, width)
    (got_dx,) = torch.autograd.grad(got, leaf, dy)
    ref_leaf = x.clone().requires_grad_(True)
    want = hash_dropout_reference(ref_leaf, rate, 1234, b0, c0, width)
    (want_dx,) = torch.autograd.grad(want, ref_leaf, dy)
    assert _same_bits(got, want) and _same_bits(got_dx, want_dx)
    # dropped NaN and inf inputs become +0, as torch.where gives
    dropped = (got == 0) & ~torch.isfinite(x)
    assert dropped.any() and (got[dropped].view(_BITS[dtype]) == 0).all()
    assert ((got_dx == 0) & ~torch.isfinite(dy)).any()


def test_backward_saves_no_tensor():
    """The Function's graph holds no tensor from the forward (the plain
    composition keeps its keep-mask alive)."""
    def saved_by(fn) -> int:
        saved = []
        x = torch.randn(4, 9, 16, requires_grad=True)
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            y = fn(x)
        y.sum().backward()
        assert x.grad is not None
        return len(saved)

    assert saved_by(lambda x: hash_dropout(x, 0.1, 5, False)) == 0
    assert saved_by(lambda x: hash_dropout_reference(x, 0.1, 5)) > 0


def test_counters_count_elements_and_no_launch_on_the_cpu():
    before = profiling.counters()
    x = torch.randn(2, 3, 8, requires_grad=True)
    hash_dropout(x, 0.1, 9, False).sum().backward()
    hash_dropout(x, 0.1, 9, True)  # eval: no work
    after = profiling.counters()
    assert after["dropout.elements"] - before.get("dropout.elements", 0) == 48
    assert after["dropout.launches"] == before["dropout.launches"] == dropout.launches
    assert after["dropout.launches_bwd"] == before["dropout.launches_bwd"]


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """Anything but a CPU tensor goes to the kernel's wrapper, which raises
    on a dtype other than fp32 and bf16 and on a device other than CUDA
    (checked before any build)."""
    with pytest.raises(ValueError, match="unsupported device"):
        hash_dropout(torch.empty(4, 8, device="meta"), 0.1, 3, False)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        hash_dropout(torch.empty(4, 8, dtype=torch.float16, device="meta"), 0.1, 3, False)


def test_empty_tensor_on_the_kernel_path_counts_no_launch():
    """A zero-size tensor off the CPU goes to the kernel's wrapper, which
    launches nothing for it and so counts nothing, either way; nor does a
    refused call."""
    before = (dropout.launches, dropout.launches_bwd)
    x = torch.empty(0, 8, device="meta", requires_grad=True)
    y = hash_dropout(x, 0.1, 3, False)
    (dx,) = torch.autograd.grad(y, x, torch.empty_like(y))
    assert y.shape == dx.shape == (0, 8) and y.device.type == dx.device.type == "meta"
    for bad in (torch.empty(4, 8, device="meta"),
                torch.empty(0, 8, dtype=torch.float16, device="meta")):
        with pytest.raises(ValueError):
            hash_dropout(bad, 0.1, 3, False)
    assert (dropout.launches, dropout.launches_bwd) == before


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_host_scale_is_the_plain_versions_scale(rate):
    """The kernel's scale argument is the plain version's fill, in each dtype."""
    for dtype in (torch.float32, torch.bfloat16):
        want = torch.full((), 1.0 / (1.0 - rate), dtype=dtype)
        assert torch.tensor(dropout._host_scale(rate, dtype), dtype=dtype) == want
        assert float(torch.tensor(dropout._host_scale(rate, dtype), dtype=torch.float32)) == \
            dropout._host_scale(rate, dtype)


@pytest.mark.parametrize("case", range(len(OFFSETS)))
def test_index_args_give_the_global_index(case):
    """The kernel's (cols, row_off, width, col_off) give each element of the
    block the plain version's global index, stepping along a row and
    wrapping to the next as the kernel does."""
    shape, b0, c0, width = OFFSETS[case]
    cols, row_off, w, col_off, plain = dropout._index_args(shape, b0, c0, width)
    want = dropout._global_index(shape, "cpu", b0, c0, width)
    e = torch.arange(want.numel())
    got = ((e // cols + row_off) * w + e % cols + col_off) & dropout._M32
    assert torch.equal(got, want) and plain == (case == 0)
