"""The benchmark's files, found by name.

`BENCHMARK.json` at the checkout's root names the cells (`workloads`), the
configurations and the metrics. Each configuration is `configs/<name>.json`,
each cell `workloads/<name>.json` (its configuration, its kind and its
traffic), each kind of cell `kinds/<kind>.py` and each per-layer metric
`metrics/<name>.py`. A later change adds a configuration, a cell or a metric
by adding files and entries; nothing here lists them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class SpecError(ValueError):
    """A file of the benchmark is missing or breaks a rule of its format."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{what} {name!r}: a name is 1-64 of A-Z a-z 0-9 _ . - "
                        "and starts with a letter, a digit or _")
    return name


def check_unit(unit: str, what: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise SpecError(f"{what}: unit {unit!r} is 1-16 of A-Z a-z 0-9 _ / % . -")
    return unit


def _read_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing file: {path.relative_to(ROOT)}") from None


def benchmark(root: Path = ROOT) -> dict:
    """`BENCHMARK.json`, with every name and unit checked."""
    bench = _read_json(root / "BENCHMARK.json")
    for c in bench["configs"]:
        check_name(c["name"], "configuration")
        for key in c["reduced"]:
            check_name(key, f"configuration {c['name']}: reduced key")
    for w in bench["workloads"]:
        check_name(w["name"], "workload")
        check_name(w["config"], f"workload {w['name']}: config")
        check_name(w["traffic"], f"workload {w['name']}: traffic")
    for m in bench["end_to_end"] + bench["per_layer"]:
        check_name(m["name"], "metric")
        check_unit(m["unit"], f"metric {m['name']}")
    return bench


def workload_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    check_name(name, "configuration")
    return _read_json(BENCH_DIR / "configs" / f"{name}.json")


def workload(name: str) -> dict:
    """The cell's own file: its configuration, kind, traffic and limits."""
    check_name(name, "workload")
    return _read_json(BENCH_DIR / "workloads" / f"{name}.json")


def _module(path: Path, modname: str) -> ModuleType:
    if not path.exists():
        raise SpecError(f"missing file: {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str) -> ModuleType:
    """`kinds/<name>.py`: `run(ctx)` drives one cell of that kind."""
    check_name(name, "kind")
    if not (BENCH_DIR / "kinds" / f"{name}.py").exists():
        raise SpecError(f"missing file: avbench/kinds/{name}.py")
    return importlib.import_module(f"avbench.kinds.{name}")


def metric(name: str) -> ModuleType:
    """`metrics/<name>.py`: LAYER, MOVES, SOURCE and `read(ctx)`."""
    check_name(name, "metric")
    mod = _module(BENCH_DIR / "metrics" / f"{name}.py",
                  "avbench_metric_" + name.replace(".", "_").replace("-", "_"))
    for attr in ("LAYER", "MOVES", "SOURCE", "read"):
        if not hasattr(mod, attr):
            raise SpecError(f"metrics/{name}.py has no {attr}")
    return mod


def metrics_of(bench: dict, cell: str, section: str) -> List[dict]:
    """The entries of `section` ('end_to_end' or 'per_layer') that the cell
    reports: those whose `workloads` name it, or that have none."""
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]
