"""Counter-hash dropout masks, as the configuration states them.

The keep bit of an element is a murmur3 finalizer over its flat C-order
index in the global array, seeded by one 32-bit integer per dropout site and
step, compared against ``int(rate * 2**32)``; an attention probability's bit
is the same construction over (seed, global head, query row, key column).
A frozen plain copy of the construction: uint32 arithmetic held in int64 and
masked to 32 bits after each step.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def threshold(rate: float) -> int:
    return int(rate * 4294967296.0) & _M32


def draw_seed(generator: torch.Generator) -> int:
    """One site's seed in [0, 2**31 - 1), drawn on the CPU."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator))


def element_keep(seed: int, shape, rate: float, device, row_offset: int = 0) -> torch.Tensor:
    """Keep mask of ``shape`` whose first dim starts at global row
    ``row_offset`` of the array (the rest of the array as ``shape``)."""
    per_row = 1
    for n in shape[1:]:
        per_row *= n
    idx = torch.arange(shape[0] * per_row, dtype=torch.int64, device=device) + row_offset * per_row
    base = (seed & _M32) * 0x9E3779B9 & _M32
    h = _mix((base + _mul32(idx & _M32, 0x27D4EB2F)) & _M32)
    return (h >= threshold(rate)).view(shape)


def attention_keep(seed: int, B: int, H: int, L: int, S: int, rate: float, device,
                   row_offset: int = 0) -> torch.Tensor:
    """(B, H, L, S) keep mask; batch row b is global row ``row_offset + b``."""
    b = torch.arange(B, dtype=torch.int64, device=device) + row_offset
    h = torch.arange(H, dtype=torch.int64, device=device)
    bh = ((b[:, None] * H + h[None, :]) & _M32).view(B, H, 1, 1)
    row = torch.arange(L, dtype=torch.int64, device=device).view(1, 1, L, 1)
    col = torch.arange(S, dtype=torch.int64, device=device).view(1, 1, 1, S)
    base = (seed & _M32) * 0x9E3779B9 & _M32
    x = (base + _mul32(bh, 0x85EBCA6B) + _mul32(row, 0x27D4EB2F)) & _M32
    x = x ^ _mul32(col, 0x165667B1)
    return _mix(x) >= threshold(rate)
