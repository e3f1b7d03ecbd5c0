"""Walks over nested dicts, lists and tuples of tensors and plain values:
the checkpoint's copy to the CPU, and the bit-for-bit comparison that a
restored state is held to."""

from __future__ import annotations

from typing import Any, Callable

import torch

_INT_OF = {torch.float64: torch.int64, torch.float32: torch.int32, torch.bfloat16: torch.int16,
           torch.float16: torch.int16}


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` of every tensor in nested dicts/lists/tuples; other leaves as
    they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers (NaN payloads and the sign of 0
    count); other dtypes as they are."""
    return t.view(_INT_OF[t.dtype]) if t.dtype in _INT_OF else t


def assert_same_bits(a: Any, b: Any, path: str = "") -> None:
    """Nested tensors and values equal, bit for bit: the same keys, lengths,
    dtypes and shapes; ``b``'s tensors are compared on ``a``'s device."""
    if isinstance(a, torch.Tensor):
        if not (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(_bits(a), _bits(b).to(a.device))):
            raise AssertionError(f"{path} differs")
    elif isinstance(a, dict):
        if not isinstance(b, dict) or sorted(a) != sorted(b):
            raise AssertionError(f"{path}: keys differ")
        for k in a:
            assert_same_bits(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_bits(x, y, f"{path}/{i}")
    elif a != b:
        raise AssertionError(f"{path}: {a} != {b}")
