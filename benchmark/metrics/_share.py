"""Arithmetic the readers share."""

from __future__ import annotations


def idle_share(record: dict):
    """100 * (1 - device busy / traced window), or None without a trace."""
    t = record.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(record: dict):
    """100 * counted FLOPs of the unprofiled window / its length / the peak."""
    if not record.get("flops") or not record.get("window_s"):
        return None
    return 100.0 * record["flops"] / record["window_s"] / record["peak_flops"]


def attention_roofline(record: dict):
    """100 * the attention calls' least time / their kernels' device time."""
    t = record.get("trace")
    if not t or not t["attention_device_s"] or not record.get("attention_bound_s"):
        return None
    return 100.0 * record["attention_bound_s"] / t["attention_device_s"]
