"""What every cell's run shares: the manifest and the cell's files, the
clock from process start, the device, the per-layer readers, the checks of
correctness, and the result line.

A run is ``Run``: the driver of its traffic's kind (``benchmark/drivers/
<kind>.py``) fills ``metrics`` (end to end, ``--trace 0``), ``record`` (what
the per-layer readers take, ``--trace 1``), ``checks`` and the counts; the
harness adds the device, reads the per-layer metrics, and prints.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "detr_tpu")


def process_start() -> float:
    """``time.perf_counter()`` at the moment this process started (Linux:
    its start time in clock ticks since boot, against the uptime)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic file) of a cell."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return w, load_json(conf["file"]), load_json(f"benchmark/traffic/{w['traffic']}.json")


def limits(name: str) -> dict:
    """The cell's limits: number -> {"limit": x, ...}."""
    return load_json(f"benchmark/limits/{name}.json")["limits"]


def reports(metric: dict, workload: str, manifest: dict) -> bool:
    """Whether the cell reports the metric."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" not in metric:  # an end-to-end metric of every cell
        return True
    moved = {m["name"]: m for m in manifest["end_to_end"]}.get(metric.get("moves"))
    return moved is not None and reports(moved, workload, manifest)


def reader(name: str):
    """The per-layer metric's reader, ``benchmark/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def quantile(values: list[float], q: float) -> float:
    """The q-quantile of values, linear between order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclass
class Run:
    """One run of one cell."""

    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    limits: dict = field(default_factory=dict)  # number -> {"limit": x, ...}
    metrics: dict = field(default_factory=dict)  # name -> (value, unit)
    record: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    attempted: int = 0
    failed: int = 0
    device: dict = field(default_factory=dict)
    breakdown: Optional[dict] = None

    @property
    def name(self) -> str:
        return self.workload["name"]

    def setup_done(self) -> None:
        """The first timed step starts now: ``setup_s`` ends here."""
        self.metrics["setup_s"] = (time.perf_counter() - self.t_start, "s")
        self.log("set-up done, window starts")

    def log(self, what: str) -> None:
        """One progress line on standard error, with the seconds since the
        process started."""
        print(f"benchmark: {what} at {time.perf_counter() - self.t_start:.1f} s",
              file=sys.stderr, flush=True)

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = (float(value), float(limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v == v and v <= lim for v, lim in self.checks.values())


def per_layer(run: Run, manifest: dict) -> dict:
    out = {}
    for m in manifest["per_layer"]:
        if not reports(m, run.name, manifest):
            continue
        value = reader(m["name"])(run.record)
        if value is not None:
            out[m["name"]] = (float(value), m["unit"])
    return out


def result_line(run: Run, manifest: dict) -> dict:
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"]}
    if run.trace:
        metrics = per_layer(run, manifest)
    else:
        metrics = {k: v for k, v in run.metrics.items() if k in units}
    line: dict[str, Any] = {
        "correct": run.correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
        "device": run.device,
    }
    if run.trace and run.breakdown is not None:
        line["breakdown"] = run.breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return line
