"""Tracing, step timing and debug switches (counterpart of
``detr_tpu/utils/profiling.py``).

  * ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is
    one, the CUDA card, for everything inside the context; the Chrome trace
    lands in ``logdir/trace.json`` (chrome://tracing, Perfetto) and the
    context yields the profiler, so the caller can read ``key_averages()``;
  * ``StepTimer``: per-step wall clock with EMA smoothing and images/s, the
    ``perf/*`` scalars of the metric logger;
  * ``enable_debug()``: autograd's anomaly detection, which names the
    forward op whose backward made a NaN (JAX's ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the context into ``logdir/trace.json``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def enable_debug(nan_checks: bool = True) -> None:
    """Debug configuration: fail fast where a backward makes a NaN."""
    if nan_checks:
        torch.autograd.set_detect_anomaly(True)


class StepTimer:
    """Wall-clock per-step timing with EMA smoothing and images/sec."""

    def __init__(self, batch_size: int, ema: float = 0.9):
        self.batch_size = batch_size
        self.ema = ema
        self._last: Optional[float] = None
        self.step_time: Optional[float] = None

    def tick(self) -> dict[str, float]:
        now = time.perf_counter()
        out: dict[str, float] = {}
        if self._last is not None:
            dt = now - self._last
            self.step_time = (
                dt
                if self.step_time is None
                else self.ema * self.step_time + (1 - self.ema) * dt
            )
            out = {
                "perf/step_time_s": self.step_time,
                "perf/images_per_sec": self.batch_size / max(self.step_time, 1e-9),
            }
        self._last = now
        return out
