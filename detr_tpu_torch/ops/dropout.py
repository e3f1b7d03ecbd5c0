"""Counter-hash dropout (counterpart of ``detr_tpu/ops/dropout.py``).

The keep-mask is a murmur3 finalizer over the flat C-order element index,
seeded by one 32-bit integer per call site, compared against
``int(rate * 2**32)``: bit for bit the JAX package's mask for the same seed.
``attention_keep`` is the same construction over (seed, head, absolute query
row, absolute key column), the mask the Pallas attention kernels draw
(``detr_tpu/ops/pallas_attention.py::_dropout_keep``) and the port's CUDA
attention kernels regenerate.

Both take the place of a local block in the global array, so that a rank
holding part of it draws that part of the global mask: a block of batch rows
(``batch_offset``, data parallelism), of FFN hidden columns (``col_offset``
and ``total_cols``) or of heads (``h_off`` and ``h_total``, tensor
parallelism).  The defaults are one process's array, whose bits are
unchanged.

``hash_dropout`` is an autograd Function whose backward draws the mask again
from (seed, rate, shape, offsets), kept as Python ints: it saves no tensor.
A CUDA tensor takes one launch of ``csrc/hash_dropout.cu`` each way (bf16
or fp32, else it raises); a CPU tensor takes the plain version,
``hash_dropout_reference``, each way: ``where(keep, dy * scale, 0)`` is the
gradient autograd gives ``where(keep, x * scale, 0)``, bit for bit.  In JAX
this is XLA elementwise code, not a Pallas kernel.

The plain version's uint32 arithmetic runs in int64 and is masked back to 32
bits after each step (PyTorch's uint32 ops are incomplete on the CPU); a
product is split at 16 bits so that no intermediate leaves int64's range.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from detr_tpu_torch.ops._build import kernel, launch
from detr_tpu_torch.utils.profiling import count

_M32 = 0xFFFFFFFF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the process started, for checking the main path
# (``utils.profiling.counters()`` reads them as ``dropout.*``).
launches = 0  # forward
launches_bwd = 0

_PTR, _U32, _LL, _INT = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_PTR, _PTR, _LL, _INT, _U32, _U32, ctypes.c_float, _LL, _U32, _U32, _U32, _PTR]


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for h in [0, 2**32) and a 32-bit constant c."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _murmur_mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def keep_threshold(rate: float) -> int:
    """The uint32 threshold a hash must reach to keep its element."""
    return int(rate * 4294967296.0) & _M32


def _seed_base(seed: int) -> int:
    return (seed & _M32) * 0x9E3779B9 & _M32


def _index_args(shape, batch_offset: int, col_offset: int,
                total_cols: Optional[int]) -> tuple[int, int, int, int, bool]:
    """(cols, row_off, width, col_off, plain) of a block of ``shape`` that
    starts at batch row ``batch_offset`` and column ``col_offset`` of a
    global array ``total_cols`` wide in its last dim: the block's element
    (row, col), from its local flat index, has the global flat index
    (row + row_off) * width + col + col_off; ``plain``: the local index."""
    numel = 1
    for n in shape:
        numel *= n
    cols = shape[-1]
    width = cols if total_cols is None else total_cols
    rows_per_item = numel // (shape[0] * cols) if numel else 0
    plain = batch_offset == 0 and col_offset == 0 and width == cols
    return cols, batch_offset * rows_per_item, width, col_offset, plain


def _global_index(shape, device, batch_offset: int, col_offset: int,
                  total_cols: Optional[int]) -> torch.Tensor:
    """(numel,) flat C-order indices in the global array of a block's
    elements (``_index_args``)."""
    cols, row_off, width, col_off, plain = _index_args(shape, batch_offset, col_offset,
                                                       total_cols)
    numel = 1
    for n in shape:
        numel *= n
    if plain:
        return torch.arange(numel, dtype=torch.int64, device=device)
    row = torch.arange(numel // cols, dtype=torch.int64, device=device) + row_off
    col = torch.arange(cols, dtype=torch.int64, device=device) + col_off
    return ((row[:, None] * width + col[None, :]) & _M32).reshape(-1)


def _element_hash(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """uint32 hashes (held in int64) of flat element indices."""
    return _murmur_mix((_seed_base(seed) + _mul32(idx, 0x27D4EB2F)) & _M32)


def hash_dropout_reference(
    x: torch.Tensor,
    rate: float,
    seed: int,
    batch_offset: int = 0,
    col_offset: int = 0,
    total_cols: Optional[int] = None,
) -> torch.Tensor:
    """The plain version, ``where(keep, x * scale, 0)`` with the mask drawn
    by int64 PyTorch ops: what the CPU runs each way and the kernel is held
    to.  Differentiable by autograd, which then keeps the mask alive for the
    backward."""
    idx = _global_index(x.shape, x.device, batch_offset, col_offset, total_cols)
    keep = _element_hash(seed, idx) >= keep_threshold(rate)
    # The scale in x's dtype, as JAX's weakly typed constant is: in bf16 the
    # kept values are x * bf16(1 / (1 - rate)).  A fill on x's device, not
    # torch.tensor: that copies from the host and makes the host wait.
    scale = torch.full((), 1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep.view(x.shape), x * scale, torch.zeros_like(scale))


@functools.lru_cache(maxsize=None)
def _host_scale(rate: float, dtype: torch.dtype) -> float:
    """1 / (1 - rate) rounded to ``dtype`` as the plain version's fill
    rounds it, as a Python float (exact in fp32)."""
    return float(torch.full((), 1.0 / (1.0 - rate), dtype=dtype))


def _kernel(x: torch.Tensor, rate: float, seed: int, batch_offset: int, col_offset: int,
            total_cols: Optional[int], backward: bool = False) -> torch.Tensor:
    """One launch of ``csrc/hash_dropout.cu`` over x, either way, counted in
    ``launches`` (``launches_bwd`` when ``backward``) once it is made; an
    empty x launches and counts nothing."""
    global launches, launches_bwd
    if x.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        return torch.empty_like(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    cols, row_off, width, col_off, _ = _index_args(x.shape, batch_offset, col_offset,
                                                   total_cols)
    launch(kernel("hash_dropout", "hash_dropout", _ARGTYPES), x.device,
           x.data_ptr(), out.data_ptr(), x.numel(), _DTYPES[x.dtype], _seed_base(seed),
           keep_threshold(rate), _host_scale(rate, x.dtype), cols, row_off & _M32,
           width & _M32, col_off & _M32)
    if backward:
        launches_bwd += 1
    else:
        launches += 1
    return out


def _either_way(x: torch.Tensor, args: tuple, backward: bool) -> torch.Tensor:
    """keep ? x * scale : +0 over x (the forward's input or the backward's
    incoming gradient): the plain version on the CPU, else the kernel."""
    if x.device.type == "cpu":
        return hash_dropout_reference(x, *args)
    return _kernel(x, *args, backward=backward)


class HashDropoutFunction(torch.autograd.Function):
    """The forward and its backward, each one pass of the same map; the
    mask's arguments ride in ``ctx`` as Python ints."""

    @staticmethod
    def forward(ctx, x, rate, seed, batch_offset, col_offset, total_cols):
        ctx.args = (rate, seed, batch_offset, col_offset, total_cols)
        return _either_way(x, ctx.args, backward=False)

    @staticmethod
    def backward(ctx, dy):
        return _either_way(dy, ctx.args, backward=True), None, None, None, None, None


def hash_dropout(
    x: torch.Tensor,
    rate: float,
    seed: Optional[int],
    deterministic: bool,
    batch_offset: int = 0,
    col_offset: int = 0,
    total_cols: Optional[int] = None,
) -> torch.Tensor:
    """Dropout with a hash-derived keep mask: keep with probability
    1 - rate and scale kept elements by 1 / (1 - rate) in x's dtype.

    ``seed`` is the site's uint32 seed (one draw per call site and step);
    unused when ``deterministic`` or ``rate == 0``.  x may be a block of a
    global array (B_total, ..., total_cols): it starts at batch row
    ``batch_offset`` and last-dim column ``col_offset``, and each element
    draws the mask bit of its global flat index.  Counts
    ``dropout.elements``."""
    if deterministic or rate == 0.0:
        return x
    if seed is None:
        raise ValueError("hash_dropout needs a seed in train mode")
    count("dropout.elements", x.numel())
    return HashDropoutFunction.apply(x, rate, seed, batch_offset, col_offset, total_cols)


def attention_keep(
    seed: int, B: int, H: int, L: int, S: int, rate: float, device,
    b_off: int = 0, h_off: int = 0, h_total: Optional[int] = None,
) -> torch.Tensor:
    """(B, H, L, S) bool keep-mask of attention-probability dropout: a pure
    function of (seed, global head, absolute row, absolute column), the
    global head of local (b, h) being (b_off + b) * h_total + h_off + h
    (b * H + h on one process)."""
    h_total = H if h_total is None else h_total
    b = torch.arange(B, dtype=torch.int64, device=device) + b_off
    h = torch.arange(H, dtype=torch.int64, device=device) + h_off
    bh = ((b[:, None] * h_total + h[None, :]) & _M32).view(B, H, 1, 1)
    row = torch.arange(L, dtype=torch.int64, device=device).view(1, 1, L, 1)
    col = torch.arange(S, dtype=torch.int64, device=device).view(1, 1, 1, S)
    h = (_seed_base(seed) + _mul32(bh, 0x85EBCA6B) + _mul32(row, 0x27D4EB2F)) & _M32
    h = h ^ _mul32(col, 0x165667B1)
    return _murmur_mix(h) >= keep_threshold(rate)
