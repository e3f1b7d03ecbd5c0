"""Counter-hash dropout (counterpart of ``detr_tpu/ops/dropout.py``).

The keep-mask is a murmur3 finalizer over the flat C-order element index,
seeded by one 32-bit integer per call site, compared against
``int(rate * 2**32)``: bit for bit the JAX package's mask for the same seed.
``attention_keep`` is the same construction over (seed, head, absolute query
row, absolute key column), the mask the Pallas attention kernels draw
(``detr_tpu/ops/pallas_attention.py::_dropout_keep``) and the port's CUDA
attention kernels regenerate.

The uint32 arithmetic runs in int64 and is masked back to 32 bits after each
step (PyTorch's uint32 ops are incomplete on the CPU); a product is split at
16 bits so that no intermediate leaves int64's range.  Plain PyTorch on every
device: in JAX this is XLA elementwise code, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF


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


def _element_hash(seed: int, numel: int, device) -> torch.Tensor:
    """(numel,) uint32 hashes (held in int64) of the flat element indices."""
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    base = (seed & _M32) * 0x9E3779B9 & _M32
    return _murmur_mix((base + _mul32(idx, 0x27D4EB2F)) & _M32)


def hash_dropout(
    x: torch.Tensor, rate: float, seed: Optional[int], deterministic: bool
) -> torch.Tensor:
    """Dropout with a hash-derived keep mask: keep with probability
    1 - rate and scale kept elements by 1 / (1 - rate) in x's dtype.

    ``seed`` is the site's uint32 seed (one draw per call site and step);
    unused when ``deterministic`` or ``rate == 0``."""
    if deterministic or rate == 0.0:
        return x
    if seed is None:
        raise ValueError("hash_dropout needs a seed in train mode")
    keep = _element_hash(seed, x.numel(), x.device) >= keep_threshold(rate)
    # The scale in x's dtype, as JAX's weakly typed constant is: in bf16 the
    # kept values are x * bf16(1 / (1 - rate)).  A fill on x's device, not
    # torch.tensor: that copies from the host and makes the host wait.
    scale = torch.full((), 1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep.view(x.shape), x * scale, torch.zeros_like(scale))


def attention_keep(
    seed: int, B: int, H: int, L: int, S: int, rate: float, device
) -> torch.Tensor:
    """(B, H, L, S) bool keep-mask of attention-probability dropout: a pure
    function of (seed, b * H + h, absolute row, absolute column)."""
    bh = torch.arange(B * H, dtype=torch.int64, device=device).view(B, H, 1, 1)
    row = torch.arange(L, dtype=torch.int64, device=device).view(1, 1, L, 1)
    col = torch.arange(S, dtype=torch.int64, device=device).view(1, 1, 1, S)
    base = (seed & _M32) * 0x9E3779B9 & _M32
    h = (base + _mul32(bh, 0x85EBCA6B) + _mul32(row, 0x27D4EB2F)) & _M32
    h = h ^ _mul32(col, 0x165667B1)
    return _murmur_mix(h) >= keep_threshold(rate)
