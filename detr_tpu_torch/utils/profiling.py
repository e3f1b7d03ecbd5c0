"""Tracing, spans and counters, step timing and debug switches (counterpart
of ``detr_tpu/utils/profiling.py``).

  * ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is
    one, the CUDA card, for everything inside the context; the Chrome trace
    lands in ``logdir/trace.json`` (chrome://tracing, Perfetto) and the
    program's spans in ``logdir/spans.json``; the context yields the
    profiler, so the caller can read ``key_averages()``;
  * ``span(name)``: the program's spans at its layer boundaries, kept in
    memory while a profiler records (any ``torch.profiler.profile``, not
    only ``trace``), ``take_spans()`` to drain them;
  * ``count(name, n)`` and ``counters()``: the program's counters;
  * ``StepTimer``: per-step wall clock with EMA smoothing and images/s, the
    ``perf/*`` scalars of the metric logger;
  * ``enable_debug()``: autograd's anomaly detection, which names the
    forward op whose backward made a NaN (JAX's ``jax_debug_nans``).

Spans.  The profiler follows only the threads it was started on and
autograd's, so a span on the prefetch thread or in a loader worker would be
lost to it: the program keeps its spans itself.  A span is
``(name, t0_ns, t1_ns, pid, tid, parent)``: stamped with ``time.time_ns()``,
the clock of the profiler's host events (Unix-epoch nanoseconds), in any
thread or process; ``tid`` is the thread's native id and ``parent`` the
index, in the same drained list, of the innermost span open on that thread
when it began (-1: none, or drained earlier).  Names are
``<layer>.<part>`` (``data.wait``, ``train.forward``, ``serve.h2d``, ...).
The switch is whether a profiler is recording: off, ``span`` is one flag
check and returns a shared null context; on, it also enters a profiler
range ``detr.<name>``, so the Chrome trace shows the span on the threads
the profiler follows.  The range is torch's ``_RecordFunctionFast``, which
keeps the interpreter lock: ``torch.profiler.record_function`` enters and
leaves through an operator call that releases it, and with another Python
thread busy (the prefetch thread assembling a batch) each span then waits
out the lock's 5 ms switch interval twice.  The buffer holds
at most ``MAX_SPANS``; spans past it are dropped and counted in
``spans.dropped``.  Spans timed in another process (the loader's workers
stamp every item) enter the buffer through ``add_spans``.

Counters are integers added to with ``count``; ``counters()`` snapshots
them with the attention, auction and deformable attention kernels' launch
counters (``attention.launches``, ``attention.launches_bwd_dkv``,
``attention.launches_bwd_dq``, ``auction.launches``, ``msda.launches``,
``msda.launches_bwd``), and
``counters(traced=True)`` the part of each ``count`` counter added while a
profiler recorded.  Each counter is added to from one thread
(``spans.dropped`` under the buffer's lock).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, Optional, Sequence

import torch
import torch.autograd.profiler as _profiler

try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # a torch without it
    _Range = torch.profiler.record_function

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
SPAN_FIELDS = ("name", "t0_ns", "t1_ns", "pid", "tid", "parent")
MAX_SPANS = 200_000

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()  # .stack: the thread's open span entries
_buffer: list = []  # entries [name, t0, t1, pid, tid, parent entry or None]
_counts: dict[str, int] = {}
_traced: dict[str, int] = {}


class _Span:
    __slots__ = ("name", "entry", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.range = _Range("detr." + self.name)
        self.range.__enter__()
        entry = [self.name, 0, None, os.getpid(), threading.get_native_id(),
                 stack[-1] if stack else None]
        with _lock:
            if len(_buffer) < MAX_SPANS:
                _buffer.append(entry)
                self.entry = entry
            else:
                count("spans.dropped")
                self.entry = None
        if self.entry is not None:
            stack.append(entry)
        entry[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.entry is not None:
            self.entry[2] = t1
            _local.stack.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A span of the program named ``name`` around the block (module
    docstring); with no profiler recording, a shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def add_spans(spans: Sequence[tuple]) -> None:
    """Buffer spans timed elsewhere, ``(name, t0_ns, t1_ns, pid, tid,
    parent)`` with ``parent`` an index into ``spans`` (-1: none); nothing
    while no profiler records."""
    if not _profiler._is_profiler_enabled or not spans:
        return
    entries: list = []
    for name, t0, t1, pid, tid, parent in spans:
        entries.append([name, t0, t1, pid, tid, entries[parent] if parent >= 0 else None])
    with _lock:
        room = max(0, MAX_SPANS - len(_buffer))
        _buffer.extend(entries[:room])
        if room < len(entries):
            count("spans.dropped", len(entries) - room)


def take_spans() -> list[tuple]:
    """The buffered spans that have ended, as ``SPAN_FIELDS`` tuples in the
    order they entered the buffer (when they began, or when ``add_spans``
    added them); the buffer keeps only the spans still open."""
    global _buffer
    with _lock:
        taken, _buffer = _buffer, [e for e in _buffer if e[2] is None]
    done = [e for e in taken if e[2] is not None]
    pos = {id(e): i for i, e in enumerate(done)}
    return [(n, t0, t1, pid, tid, -1 if p is None else pos.get(id(p), -1))
            for n, t0, t1, pid, tid, p in done]


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and to its traced part while a
    profiler records)."""
    _counts[name] = _counts.get(name, 0) + n
    if _profiler._is_profiler_enabled:
        _traced[name] = _traced.get(name, 0) + n


def counters(traced: bool = False) -> dict[str, int]:
    """A snapshot of every program counter; ``traced``: of the part of each
    ``count`` counter added while a profiler recorded."""
    if traced:
        return dict(_traced)
    from detr_tpu_torch.matcher import auction
    from detr_tpu_torch.ops import masked_attention as ma
    from detr_tpu_torch.ops import ms_deform_attn as msda

    out = dict(_counts)
    out.update({"attention.launches": ma.launches,
                "attention.launches_bwd_dkv": ma.launches_bwd_dkv,
                "attention.launches_bwd_dq": ma.launches_bwd_dq,
                "auction.launches": auction.launches,
                "msda.launches": msda.launches, "msda.launches_bwd": msda.launches_bwd})
    return out


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the context into ``logdir/trace.json``, and
    the program's spans in it into ``logdir/spans.json``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    take_spans()  # spans of an earlier profiler are not this trace's
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    with open(os.path.join(logdir, SPANS_FILE), "w") as f:
        json.dump({"fields": SPAN_FIELDS, "spans": take_spans(), "counters": counters()}, f)


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
