"""``BENCHMARK.json`` and the files it names: imports, names, units, files,
and which cells report which metrics.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "detr_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> set[str]:
    """Top-level names of every module the file imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


PY_FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not (_imports(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "detr_tpu_torch" not in _imports(path)


def test_names_and_units():
    names = [c["name"] for c in MANIFEST["configs"]]
    names += [w["name"] for w in MANIFEST["workloads"]]
    names += [w[k] for w in MANIFEST["workloads"] for k in ("config", "traffic")]
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names += [m["name"] for m in metrics]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in (MANIFEST["configs"], MANIFEST["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(
        MANIFEST["workloads"])


def test_every_file_exists():
    for c in MANIFEST["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in MANIFEST["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['kind']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def _reported(metric: dict, cell: str) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:  # an end-to-end metric of every cell
        return True
    moved = {m["name"]: m for m in MANIFEST["end_to_end"]}[metric["moves"]]
    return _reported(moved, cell)


def test_moves_is_reported_where_its_metric_is():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for cell in cells:
            if _reported(m, cell):
                assert _reported(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MANIFEST["workloads"]:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if _reported(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reported(m, w["name"]) for m in MANIFEST["per_layer"])


def test_limits_name_the_numbers_the_drivers_compare():
    compared = {"train": {"loss_gap", "grad_gap", "change_gap"},
                "serve": {"score_gap", "box_gap"}}
    for w in MANIFEST["workloads"]:
        kind = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())["kind"]
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())["limits"]
        assert limits and set(limits) <= compared[kind]
        assert all(0 < v["limit"] < 1 for v in limits.values()), w["name"]
