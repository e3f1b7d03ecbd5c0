"""The host process's resident set size (counterpart of
``detr_tpu/utils/host.py``).

The trainer logs it every log step as ``perf/host_rss_gb`` and exits with
the watchdog's code 42 past ``TrainingConfig.host_rss_limit_gb``, so that a
retry wrapper relaunches a fresh process that auto-restores the checkpoint,
instead of growing until the kernel kills it (exit 137, no relaunch).
"""

from __future__ import annotations


def host_rss_gb() -> float:
    """Resident set size of this process in GB (0.0 where /proc is not
    readable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / (1024.0 * 1024.0)
    except OSError:
        pass
    return 0.0
