"""Sharing one card between a training run and a benchmark (counterpart of
``detr_tpu/utils/chip_pause.py``).

A benchmark that runs while a trainer keeps launching steps on the same card
measures the two interleaved.  The handshake is a flag file, no signals and
no daemon:

  * the benchmark writes its pid into ``PAUSE_FILE`` on entry and removes the
    file on exit (``request_chip_pause``, a context manager);
  * the trainer looks for the file before each micro-step (one ``stat``);
    when it is there and fresh, the trainer reads its pending loss, which
    waits for the card to drain, then idles, beating its watchdog, until the
    file is gone (``wait_while_paused``).

Ranks decide together: given a ``group`` (a process group that takes CPU
tensors), every look is one all-reduce of the ranks' answers, and all of
them see a pause when any one does.  A rank that paused alone would idle
while the others block in the step's collectives, whose waits beat no
watchdog.

A file older than ``FRESH_SECS`` is ignored, so a benchmark that died holding
it does not stall training for good; a file holding this process's own pid
is ignored too (a benchmark that runs the trainer's validation inside its
own pause would wait for itself).

``PAUSE_FILE`` is ``$DETR_CHIP_PAUSE_FILE`` where set (every process that
shares the card must see the same path), else ``detr_chip_pause`` in the
temporary directory (``tempfile.gettempdir()``, which follows ``TMPDIR``).
"""

from __future__ import annotations

import contextlib
import os
import signal
import tempfile
import threading
import time
from typing import Iterator, Optional

PAUSE_FILE = os.environ.get("DETR_CHIP_PAUSE_FILE",
                            os.path.join(tempfile.gettempdir(), "detr_chip_pause"))

#: A pause file older than this is ignored (its benchmark died).
FRESH_SECS = 3600.0


def _file_says_pause(path: str) -> bool:
    try:
        with open(path) as f:
            holder = f.read().strip()
        age = time.time() - os.stat(path).st_mtime
    except OSError:
        return False
    if holder == str(os.getpid()):
        return False  # our own pause: honouring it would wait forever
    return age <= FRESH_SECS  # a future mtime (negative age) is honoured too


def pause_requested(path: Optional[str] = None, group=None) -> bool:
    """True when a fresh pause file exists that another process holds; with
    ``group``, when any of its ranks finds one (every rank must call)."""
    paused = _file_says_pause(path or PAUSE_FILE)
    if group is None:
        return paused
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(paused)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


def wait_while_paused(watchdog=None, poll_secs: float = 2.0,
                      path: Optional[str] = None, group=None) -> float:
    """Block while a fresh pause file exists (for ``group``, while any rank
    finds one: all ranks wait and leave together), calling
    ``watchdog.beat()`` every poll so the wait never trips it; returns the
    seconds waited."""
    t0 = time.monotonic()
    while pause_requested(path, group):
        if watchdog is not None:
            watchdog.beat()
        time.sleep(poll_secs)
    return time.monotonic() - t0


@contextlib.contextmanager
def request_chip_pause(path: Optional[str] = None) -> Iterator[None]:
    """Hold the pause file for the block (the benchmark's side).

    A supervisor's ``timeout`` sends SIGTERM, whose default action ends the
    process without running ``finally``: the file would outlive the
    benchmark and idle a trainer for up to ``FRESH_SECS``.  While the file is
    held (and on the main thread, where handlers can be set), a SIGTERM
    handler removes it and exits with 143.
    """
    path = path or PAUSE_FILE
    try:
        with open(path, "w") as f:
            f.write(str(os.getpid()))
    except OSError:
        pass  # an unwritable path: no arbitration

    def _on_term(signum, frame):
        try:
            os.unlink(path)
        except OSError:
            pass
        os._exit(143)

    previous, installed = None, False
    if threading.current_thread() is threading.main_thread():
        try:
            previous = signal.signal(signal.SIGTERM, _on_term)
            installed = True
        except (ValueError, OSError):
            pass
    try:
        yield
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
        if installed:
            try:
                signal.signal(signal.SIGTERM, previous)
            except (ValueError, OSError, TypeError):
                pass
