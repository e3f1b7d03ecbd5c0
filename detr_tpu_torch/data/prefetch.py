"""Host-to-card prefetch: make and copy the next batches while the card runs
the current step (counterpart of ``detr_tpu/data/prefetch.py``).

``prefetch_to_device`` runs the loader and a placement function on a daemon
thread, ``depth`` batches ahead.  ``DevicePlacement`` is the placement the
trainer passes, the counterpart of JAX's ``device_put``: on the prefetch
thread it copies each host array into pinned memory and sends it to the card
with ``non_blocking=True`` on a side stream, and records an event there; on
the consumer's thread, ``take`` makes the current stream wait for that event
(so no kernel reads a batch before its copy has landed) and marks every
tensor as used by the current stream (``record_stream``), so that the
caching allocator does not hand its memory to the side stream's next copy
while the step still reads it.  On the CPU it only wraps the arrays: there
is nothing to pin and no stream.

Spans (``utils.profiling``): ``data.place`` around each placement on the
producer thread, ``data.wait`` around the consumer's wait for a batch and
its ``take``; counters ``data.batches`` (batches the producer handed on),
and from ``DevicePlacement.place`` ``data.h2d_bytes`` and ``data.images``
(the bytes of the arrays it sends, and the images among them).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from detr_tpu_torch.utils import profiling

_SENTINEL = object()


class DevicePlacement:
    """Host batch (dict of numpy arrays) -> dict of tensors on ``device``,
    split in two: ``place`` on the producer's thread, ``take`` on the
    consumer's.  ``keys`` keeps only those entries (None: all)."""

    def __init__(self, device, keys: Optional[Iterable[str]] = None):
        self.device = torch.device(device)
        self.keys = None if keys is None else frozenset(keys)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _arrays(self, batch: dict) -> dict[str, np.ndarray]:
        return {k: np.ascontiguousarray(v) for k, v in batch.items()
                if self.keys is None or k in self.keys}

    def place(self, batch: dict) -> tuple[dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
        """Start the batch's copy; returns its tensors and the copy's event."""
        arrays = self._arrays(batch)
        profiling.count("data.h2d_bytes", sum(a.nbytes for a in arrays.values()))
        if "image" in arrays:
            profiling.count("data.images", len(arrays["image"]))
        if self.stream is None:
            return {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}, None
        with torch.cuda.stream(self.stream):
            tensors = {k: torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True)
                       for k, v in arrays.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return tensors, event

    def take(self, placed) -> dict[str, torch.Tensor]:
        """The placed batch, ready for work on the current stream."""
        tensors, event = placed
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in tensors.values():
                t.record_stream(current)
        return tensors

    def __call__(self, batch: dict) -> dict[str, torch.Tensor]:
        """place and take at once, for a batch not prefetched."""
        return self.take(self.place(batch))


def prefetch_to_device(
    batches: Iterable[Any],
    place: Optional[Callable[[Any], Any]] = None,
    depth: int = 2,
    take: Optional[Callable[[Any], Any]] = None,
) -> Iterator[Any]:
    """Yields ``take(place(batch))`` for each host batch; ``place`` runs on a
    daemon thread ``depth`` batches ahead, ``take`` on the consumer's thread
    at each ``next()``.  Either may be None: pass through.

    An exception from the loader or ``place`` is re-raised at the consumer's
    ``next()``.  The thread ends with the epoch, or when the generator is
    closed: ``close()`` sets the stop flag, empties the queue and joins it."""
    place = place or (lambda b: b)
    take = take or (lambda b: b)
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(item) -> bool:
        # bounded, so that the thread sees a stop while the queue is full
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for b in batches:
                with profiling.span("data.place"):
                    placed = place(b)
                profiling.count("data.batches")
                if not put(placed):
                    return
            put(_SENTINEL)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    t = threading.Thread(target=producer, daemon=True, name="device-prefetch")
    t.start()
    try:
        while True:
            with profiling.span("data.wait"):
                item = q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch = take(item)
            yield batch
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5)
