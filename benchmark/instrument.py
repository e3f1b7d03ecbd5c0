"""The benchmark's spans around the calls into the program's layers, and
what the device reports.

The program gets no spans of its own: in a traced run the harness wraps
the transformer's attention entry (``models.transformer.masked_attention``)
in a ``bench.attention`` range that also records each call's shapes, and
its own loop in ``bench.*`` ranges (``span``).  The attention backward is
autograd's ``MaskedAttentionBackward`` node, which the profiler names.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from benchmark import trace as trace_mod


class AttentionCalls:
    """Wraps the program's attention entry in traced runs; ``calls`` holds
    (B, L, S, H, D, masked, dtype) of each call while ``recording``."""

    def __init__(self):
        self.calls: list[tuple] = []
        self.recording = False
        self._undo = None

    def install(self) -> None:
        from detr_tpu_torch.models import transformer

        inner = transformer.masked_attention

        def traced(q, k, v, key_padding_mask=None, *args, **kwargs):
            if self.recording:
                B, L, H, D = q.shape
                self.calls.append((B, L, k.shape[1], H, D, key_padding_mask is not None,
                                   str(q.dtype).replace("torch.", "")))
            with torch.profiler.record_function(trace_mod.ATTENTION):
                return inner(q, k, v, key_padding_mask, *args, **kwargs)

        transformer.masked_attention = traced
        self._undo = lambda: setattr(transformer, "masked_attention", inner)

    def remove(self) -> None:
        if self._undo is not None:
            self._undo()
            self._undo = None


def span(name: str, on: bool):
    """A ``bench.<name>`` profiler range when ``on``, else nothing."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"bench.{name}")


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def device_info(device: torch.device, peak: int, traced: Optional[dict] = None) -> dict:
    info = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if traced is not None:
        info["busy_s"] = traced["busy_s"]
        info["window_s"] = traced["window_s"]
    return info


def breakdown(traced: Optional[dict]) -> Optional[dict]:
    if traced is None:
        return None
    return {"device_ops": [[n, s] for n, s in traced["device_ops"]],
            "idle_gaps": [[n, s] for n, s in traced["idle_gaps"]]}
