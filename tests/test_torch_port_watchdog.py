"""The port's watchdog (``detr_tpu_torch.utils.watchdog``): the cases of
``tests/test_watchdog.py``.  The exit path calls ``os._exit``, so it runs
in a subprocess."""

import os
import subprocess
import sys
import time

from detr_tpu_torch.utils.watchdog import WEDGED_EXIT_CODE, Watchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(body: str) -> subprocess.CompletedProcess:
    prog = "import time, sys\nfrom detr_tpu_torch.utils.watchdog import Watchdog\n" + body
    return subprocess.run([sys.executable, "-c", prog], capture_output=True, timeout=60,
                          cwd=ROOT)


def test_disabled_watchdog_has_no_thread():
    w = Watchdog(0)
    assert w._thread is None
    w.beat()
    w.stop()


def test_a_wedge_exits_42_with_every_threads_traceback():
    r = _run("import threading\n"
             "threading.Thread(target=time.sleep, args=(30,), name='other', daemon=True).start()\n"
             "w = Watchdog(0.5, poll_secs=0.1)\n"
             "time.sleep(30)\n"  # never beats: the watchdog ends the process first
             "sys.exit(0)\n")
    assert r.returncode == WEDGED_EXIT_CODE == 42
    assert b"no heartbeat" in r.stderr
    assert r.stderr.count(b"hread 0x") == 3  # main, the other one, the watchdog's


def test_beats_keep_the_process_alive():
    r = _run("w = Watchdog(0.6, poll_secs=0.1)\n"
             "for _ in range(20):\n"
             "    time.sleep(0.1); w.beat()\n"
             "w.stop(); sys.exit(0)\n")
    assert r.returncode == 0, r.stderr


def test_a_pause_exempts_a_long_phase():
    r = _run("w = Watchdog(0.5, poll_secs=0.1)\n"
             "w.beat(); w.pause()\n"
             "time.sleep(1.5)\n"  # longer than the timeout, but paused
             "w.resume(); w.stop(); sys.exit(0)\n")
    assert r.returncode == 0, r.stderr


def test_the_heartbeat_file_is_touched_over_time(tmp_path):
    """Every poll, paused or not, and with the timeout off."""
    hb = str(tmp_path / "hb")
    w = Watchdog(0, poll_secs=0.05, heartbeat_path=hb)
    assert w._thread is not None and os.path.exists(hb)
    m0 = os.stat(hb).st_mtime_ns
    w.pause()
    deadline = time.time() + 5.0
    while os.stat(hb).st_mtime_ns == m0 and time.time() < deadline:
        time.sleep(0.05)
    assert os.stat(hb).st_mtime_ns > m0
    w.stop()
    w._thread.join(timeout=5)
    assert not w._thread.is_alive()
