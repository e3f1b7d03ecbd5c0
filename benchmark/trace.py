"""What a ``torch.profiler`` trace of the run's traced window holds, reduced
to the numbers the per-layer readers take.

The harness marks its own spans with ``record_function`` ranges named
``bench.*`` (the window, the waits, each call into a layer); autograd's node
for the attention backward appears as a host op whose name holds
``MaskedAttentionBackward``.  Device work (kernels, copies, fills) is tied
to the host span it was launched from through its runtime launch event's
correlation id.

- busy: the union of the device intervals inside ``bench.window``; the
  idle share is 1 - busy / window (the arithmetic of the port's phase 9b
  trace reader, ``_union_us``);
- kernels: the count of kernel launches inside the window;
- attention: the summed device time of the kernels launched from inside a
  ``bench.attention`` span or an attention backward node;
- top ops: device time by kernel name; idle gaps: the longest gaps between
  device work, each named by the innermost ``bench.*`` span the window's
  thread was in at the gap's middle.
"""

from __future__ import annotations

from typing import Optional

WINDOW = "bench.window"
ATTENTION = "bench.attention"
BACKWARD_NODE = "MaskedAttentionBackward"
_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync",
           "cudaMemsetAsync", "cudaMemcpy", "cudaMemset", "cuLaunchKernelEx",
           "cudaLaunchCooperativeKernel")


def union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _start(ev) -> int:
    return ev.start_ns() if hasattr(ev, "start_ns") else int(ev.start_us() * 1000)


def _dur(ev) -> int:
    return ev.duration_ns() if hasattr(ev, "duration_ns") else int(ev.duration_us() * 1000)


def _tid(ev) -> int:
    return ev.start_thread_id() if hasattr(ev, "start_thread_id") else 0


def _host(ev) -> bool:
    return str(ev.device_type()).endswith("CPU")


def _kind(ev) -> Optional[str]:
    """'kernel', 'memcpy', 'memset' for device work, else None."""
    if _host(ev):
        return None
    name = ev.name()
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    annotation = getattr(ev, "is_user_annotation", None)
    if (annotation is not None and annotation()) or name.startswith("bench."):
        return None
    return "kernel"


def reduce_profile(prof) -> Optional[dict]:
    """The traced window's numbers (seconds), or None when the trace holds
    no window or no device work."""
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if _host(e)]
    windows = [e for e in host if e.name() == WINDOW]
    if len(windows) != 1:
        return None
    w0 = _start(windows[0])
    w1 = w0 + _dur(windows[0])
    main_tid = _tid(windows[0])
    device = []
    for e in events:
        kind = _kind(e)
        if kind is not None and w0 <= _start(e) < w1:
            device.append((e, kind))
    if not device:
        return None
    launches = {}
    for e in host:
        if e.name().startswith(_LAUNCH):
            launches[e.correlation_id()] = (_start(e), _tid(e))
    spans = [(e.name(), _start(e), _start(e) + _dur(e), _tid(e))
             for e in host if e.name().startswith("bench.") or BACKWARD_NODE in e.name()]
    attention_spans = [(a, b, t) for n, a, b, t in spans
                       if n == ATTENTION or BACKWARD_NODE in n]

    def launched_in(ev, ranges) -> bool:
        for cid in (ev.correlation_id(), getattr(ev, "linked_correlation_id", lambda: -1)()):
            if cid in launches:
                t, tid = launches[cid]
                return any(a <= t < b and tid == st for a, b, st in ranges)
        return False

    kernels = [e for e, k in device if k == "kernel"]
    attention_ns = sum(_dur(e) for e in kernels if launched_in(e, attention_spans))
    busy = sorted((_start(e), _start(e) + _dur(e)) for e, _ in device)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name()] = by_name.get(e.name(), 0.0) + _dur(e) / 1e9
    gaps = []
    end = w0
    for a, b in busy + [(w1, w1)]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    main_spans = sorted(((a, b, n) for n, a, b, t in spans
                         if t == main_tid and n.startswith("bench.") and n != WINDOW),
                        key=lambda s: s[0] - s[1])

    def label(a, b) -> str:
        mid = (a + b) / 2
        inside = [s for s in main_spans if s[0] <= mid < s[1]]
        return min(inside, key=lambda s: s[1] - s[0])[2] if inside else "bench.window"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": union_s(busy) / 1e9,
        "kernels": len(kernels),
        "attention_device_s": attention_ns / 1e9,
        "attention_kernels": sum(1 for e in kernels if launched_in(e, attention_spans)),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [(label(a, b), (b - a) / 1e9) for a, b in gaps[:10]],
    }
