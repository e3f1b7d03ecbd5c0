"""The program's own spans and counters in a traced run
(``detr_tpu_torch.utils.profiling``), reduced to what the per-layer readers
take, and the traced window's device-idle time put down to them.

The port keeps a span buffer while a profiler records, so the traced
window's spans are in it when the run ends; ``program(record)`` drains it
once, on the thread that ran the window, into the run's record:
``record["spans"]`` (the span tuples) and ``record["counters"]`` (the part
of each program counter added while the profiler recorded), with
``record["span_pid"]`` and ``record["span_tid"]``.  A program without
spans (older than them) leaves both None, and every reader of them then
returns None.

The window: ``window(record)`` starts at the first program span of the
window's thread (the loop's first wait or call, microseconds after the
harness's ``bench.window`` range opens) and lasts the traced window's
length from the device trace; ``from_profile`` reads the window itself and
the device's busy intervals from the profile, for ``idle_by_span``.

    python3 -m benchmark.spans --workload <cell> --seed <n> [--seconds <s>]

runs the cell traced as ``benchmark.run --trace 1`` does, prints its result
line, then one JSON line of the spans: per name its count, total and self
time in the window, the window's device-idle time by innermost program
span of the window's thread, the program against the harness's own spans,
and the clock check (how far the profiler's ``detr.*`` ranges start from
the buffered spans).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from typing import Optional

from benchmark import trace as trace_mod

OUTSIDE = "(outside any program span)"


def program(record: dict) -> Optional[list]:
    """The run's program spans, drained into ``record`` on first use; None
    when the program keeps none."""
    if "spans" not in record:
        try:
            from detr_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        take = getattr(profiling, "take_spans", None)
        if take is None:
            record["spans"] = record["counters"] = None
        else:
            record["spans"] = [tuple(s) for s in take()]
            record["counters"] = profiling.counters(traced=True)
            record["span_pid"] = os.getpid()
            record["span_tid"] = threading.get_native_id()
    return record["spans"] or None


def counter(record: dict, name: str) -> Optional[int]:
    program(record)
    return (record.get("counters") or {}).get(name)


def main_thread(record: dict) -> list:
    """The spans of the thread that ran the window."""
    spans = program(record) or []
    key = (record.get("span_pid"), record.get("span_tid"))
    return [s for s in spans if (s[3], s[4]) == key]


def window(record: dict) -> Optional[tuple[int, int]]:
    """(start, end) of the traced window in ns (module docstring), or None."""
    mine = main_thread(record)
    t = record.get("trace")
    if not mine or not t or t.get("window_s", 0) <= 0:
        return None
    w0 = min(s[1] for s in mine)
    return w0, w0 + int(t["window_s"] * 1e9)


def clip(a: int, b: int, w: tuple[int, int]) -> int:
    return max(0, min(b, w[1]) - max(a, w[0]))


def stats(spans: list, w: tuple[int, int]) -> dict:
    """Per span name: count (spans that overlap the window), total and self
    time (its duration less the union of its children's) in s, both clipped
    to the window."""
    children: dict[int, list] = {}
    for s in spans:
        if s[5] >= 0:
            children.setdefault(s[5], []).append(s)
    out: dict[str, dict] = {}
    for i, (name, a, b, _, _, _) in enumerate(spans):
        own = clip(a, b, w)
        if own <= 0:
            continue
        lo, hi = max(a, w[0]), min(b, w[1])
        kids = [(max(c[1], lo), min(c[2], hi)) for c in children.get(i, ())]
        inner = trace_mod.union_s([k for k in kids if k[1] > k[0]])
        e = out.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        e["count"] += 1
        e["total_s"] += own / 1e9
        e["self_s"] += (own - inner) / 1e9
    return out


def total_s(record: dict, name: str, thread: bool = True) -> tuple[float, int]:
    """(total s in the window, count) of the spans ``name``, of the window's
    thread only when ``thread``; (0, 0) without a window."""
    w = window(record)
    if w is None:
        return 0.0, 0
    spans = main_thread(record) if thread else program(record)
    got = [clip(s[1], s[2], w) for s in spans if s[0] == name]
    got = [g for g in got if g > 0]
    return sum(got) / 1e9, len(got)


def per_step_ms(record: dict, name: str) -> Optional[float]:
    """The spans ``name`` of the window's thread, their total per
    ``train.step`` span in the window, in ms."""
    took, _ = total_s(record, name)
    _, steps = total_s(record, "train.step")
    return 1e3 * took / steps if steps else None


def idle_by_span(spans: list, key: tuple[int, int], w: tuple[int, int],
                 busy: list) -> dict:
    """The window's device-idle time (s), by the innermost span of the
    thread ``key`` (pid, tid) open at each instant; ``OUTSIDE`` for idle
    time in none.  ``busy``: the device's (start, end) intervals in ns."""
    mine = sorted(((max(s[1], w[0]), min(s[2], w[1]), s[0]) for s in spans
                   if (s[3], s[4]) == key and clip(s[1], s[2], w) > 0),
                  key=lambda s: (s[0], -s[1]))
    idle, end = [], w[0]
    for a, b in sorted(busy) + [(w[1], w[1])]:
        a, b = max(a, w[0]), min(b, w[1])
        if a > end:
            idle.append((end, a))
        end = max(end, b)
    # a sweep: opens after closes at one instant, idle edges last
    events = [(a, 1, i) for i, (a, _, _) in enumerate(mine)]
    events += [(b, 0, i) for i, (_, b, _) in enumerate(mine)]
    events += [(a, 3, -1) for a, _ in idle] + [(b, 2, -1) for _, b in idle]
    events.sort()
    out: dict[str, float] = {}
    stack: list[int] = []
    idle_on, prev = False, w[0]
    for t, kind, i in events:
        if idle_on and t > prev:
            name = mine[stack[-1]][2] if stack else OUTSIDE
            out[name] = out.get(name, 0.0) + (t - prev) / 1e9
        prev = t
        if kind == 0:
            stack.remove(i)
        elif kind == 1:
            stack.append(i)
        else:
            idle_on = kind == 3
    return out


def from_profile(prof) -> Optional[tuple[tuple[int, int], list]]:
    """((start, end) of ``bench.window`` in ns, the device's busy intervals
    in it) of a profile, with ``benchmark.trace``'s reading of events."""
    t = trace_mod
    events = list(prof.profiler.kineto_results.events())
    windows = [e for e in events if t._host(e) and e.name() == t.WINDOW]
    if len(windows) != 1:
        return None
    w0 = t._start(windows[0])
    w1 = w0 + t._dur(windows[0])
    busy = [(t._start(e), t._start(e) + t._dur(e)) for e in events
            if t._kind(e) is not None and w0 <= t._start(e) < w1]
    return (w0, w1), busy


def _host_ranges(prof, prefix: str) -> dict[str, list]:
    t = trace_mod
    out: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if t._host(e) and e.name().startswith(prefix):
            out.setdefault(e.name()[len(prefix):], []).append((t._start(e), t._dur(e)))
    return out


def report(record: dict, prof) -> dict:
    """The spans' numbers of a traced run (module docstring)."""
    spans = program(record)
    got = from_profile(prof)
    if not spans or got is None:
        return {"spans": None}
    w, busy = got
    key = (record["span_pid"], record["span_tid"])
    mine = [s for s in spans if (s[3], s[4]) == key]
    bench = _host_ranges(prof, "bench.")
    detr = _host_ranges(prof, "detr.")
    offsets = []
    for name in sorted({s[0] for s in mine}):
        buffered = sorted(s[1] for s in mine if s[0] == name)
        traced = sorted(a for a, _ in detr.get(name, []))
        if len(traced) == len(buffered):
            offsets += [b - a for a, b in zip(traced, buffered)]
    steps = [i for i, s in enumerate(spans) if s[0] == "train.step" and (s[3], s[4]) == key
             and clip(s[1], s[2], w) > 0]
    covered = []
    for i in steps:
        step = spans[i]
        kids = sum(clip(c[1], c[2], (step[1], step[2])) for c in spans if c[5] == i)
        covered.append(kids / max(1, step[2] - step[1]))
    idle = idle_by_span(spans, key, w, busy)
    total_idle = sum(idle.values())
    return {
        "window_s": (w[1] - w[0]) / 1e9,
        "idle_s": total_idle,
        "idle_in_spans_share": 1 - idle.get(OUTSIDE, 0.0) / total_idle if total_idle else None,
        "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "spans": stats(spans, w),
        "bench_s": {n: sum(d for _, d in r) / 1e9 for n, r in bench.items()},
        "step_children_cover": covered,
        "counters": record.get("counters"),
        "clock_offset_ms": ([min(offsets) / 1e6, max(offsets) / 1e6] if offsets else None),
    }


def main(argv=None) -> int:
    import benchmark.run  # noqa: F401  (the environment of a run)
    from benchmark import harness, instrument

    t_start = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    import torch

    manifest = harness.load_manifest()
    workload, config, traffic = harness.cell(manifest, args.workload)
    if not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA card", file=sys.stderr)
        return 3
    profiles = []
    make = instrument.profiler

    def kept(device):
        prof = make(device)
        profiles.append(prof)
        return prof

    instrument.profiler = kept
    run = harness.Run(workload, config, traffic, args.seed, args.seconds, True, t_start,
                      harness.limits(args.workload))
    harness.driver(traffic["kind"]).run(run, torch.device("cuda"))
    line = harness.result_line(run, manifest)
    print(json.dumps(line), flush=True)
    rec = run.record
    out = report(rec, profiles[-1]) if profiles else {"spans": None}
    out.update(workload=args.workload, seed=args.seed,
               untraced_rate=_rate(rec, traffic, untraced=True),
               traced_rate=_rate(rec, traffic, untraced=False))
    print(json.dumps(out), flush=True)
    return 0


def _rate(record: dict, traffic: dict, untraced: bool) -> Optional[float]:
    """Images per second of the unprofiled window, or of the profiled one."""
    t = record.get("trace")
    if record.get("kind") == "train":
        b = traffic["micro_batch"]
        if untraced:
            return record["micro_steps"] * b / record["window_s"]
        return record["profiled_micro_steps"] * b / t["window_s"] if t else None
    if untraced:
        return record["images"] / record["window_s"] if record.get("images") else None
    calls = traffic.get("trace_calls")  # a backlog's; an open loop has none
    return calls * traffic["batch_size"] / t["window_s"] if t and calls else None


if __name__ == "__main__":
    sys.exit(main())
