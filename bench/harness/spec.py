"""What one run measures, read from ``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix; each is a JSON file found by
its name (``configs/<config>.json``, ``traffic/<traffic>.json``), the number
limits of the cell's check are ``limits/<cell>.json``, and each per-layer
metric has a reader ``metrics/<metric>.py``. Adding a cell, a mix or a metric
adds files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Metric:
    name: str
    unit: str


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _metrics(entries, cell: str) -> List[Metric]:
    out = []
    for e in entries:
        wl = e.get("workloads")
        if wl is not None and cell not in wl:
            continue
        out.append(Metric(e["name"], e["unit"]))
    return out


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH / "limits" / f"{name}.json"
    limits = _read_json(limits_path) if limits_path.is_file() else {}
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config,
                traffic, limits, _metrics(bench["end_to_end"], name),
                _metrics(bench["per_layer"], name))


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` imported as the module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod             # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable[[Any], Any]:
    """``read(run)`` of ``metrics/<name>.py``: the metric's value from a
    finished traced run, or None where the run holds nothing to read."""
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_")).read
