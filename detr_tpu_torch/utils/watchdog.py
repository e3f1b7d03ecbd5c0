"""Fail-fast watchdog for a training process that stops making progress
(counterpart of ``detr_tpu/utils/watchdog.py``).

A CUDA call that never returns (a hung kernel, a wedged driver, a collective
waiting for a peer) blocks the training thread for ever, and a Python thread
cannot interrupt it.  So recovery is per process: when ``beat()`` has not
been called for ``timeout_secs``, the watchdog thread writes every thread's
traceback to stderr and exits the process with ``WEDGED_EXIT_CODE``.  The
trainer's checkpoint auto-restore turns a relaunch into a resume; pair it
with a retry loop::

    until python -m detr_tpu_torch.train.trainer ...; do
      test $? -eq 42 || break   # only the watchdog's code relaunches
      sleep 30
    done

``heartbeat_path``: a file the thread rewrites every poll, paused or not.
A native call that blocks while holding the interpreter lock freezes every
Python thread, this one too, so the in-process timeout cannot fire; the
file's modification time going stale is then the sign an outside
supervisor can read.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
import threading
import time

logger = logging.getLogger(__name__)

#: Exit code that tells a retry wrapper "stopped making progress, relaunch me".
WEDGED_EXIT_CODE = 42


class Watchdog:
    """Exits the process when no ``beat()`` arrives for ``timeout_secs``.

    ``timeout_secs <= 0`` turns the timeout off (the thread still runs when
    ``heartbeat_path`` is set; with neither there is no thread).  ``beat()``
    is one clock read and a store under a lock.  ``pause()``/``resume()``
    bracket phases that may rightly run long without a beat (loader set-up,
    the evaluator's host work); ``resume()`` restarts the clock.
    """

    def __init__(self, timeout_secs: float, poll_secs: float = 10.0,
                 heartbeat_path: str | None = None):
        self.timeout_secs = float(timeout_secs)
        self.heartbeat_path = heartbeat_path
        self._last = time.monotonic()
        self._paused = False
        self._stopped = False
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        if heartbeat_path:
            self._touch()
        if self.timeout_secs > 0 or heartbeat_path:
            self._thread = threading.Thread(target=self._run, args=(float(poll_secs),),
                                            daemon=True, name="progress-watchdog")
            self._thread.start()

    def _touch(self) -> None:
        try:
            with open(self.heartbeat_path, "w") as f:
                f.write(str(time.time()))
        except OSError:
            pass

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()

    def pause(self) -> None:
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._paused = False

    def stop(self) -> None:
        """End the thread at its next poll; no exit after this."""
        with self._lock:
            self._stopped = True

    def _run(self, poll_secs: float) -> None:
        while True:
            time.sleep(poll_secs)
            if self.heartbeat_path:
                self._touch()
            with self._lock:
                if self._stopped:
                    return
                if self._paused or self.timeout_secs <= 0:
                    continue
                silent = time.monotonic() - self._last
            if silent > self.timeout_secs:
                logger.critical(
                    "watchdog: no heartbeat for %.0fs (limit %.0fs), no progress; dumping "
                    "tracebacks and exiting %d for the retry wrapper", silent,
                    self.timeout_secs, WEDGED_EXIT_CODE)
                try:
                    faulthandler.dump_traceback(file=sys.stderr)
                    sys.stderr.flush()
                except (OSError, ValueError):  # stderr closed or not a file
                    pass
                os._exit(WEDGED_EXIT_CODE)
