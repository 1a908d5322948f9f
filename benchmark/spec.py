"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell's configuration, its traffic mix and its metrics;
each of those sits in a file of its own here:

* ``configs/<config>.json`` (the file ``BENCHMARK.json`` gives for it),
* ``traffic/<traffic>.json``,
* ``metrics/<metric>.py`` for each per-layer metric,
* ``limits/<cell>.json``: the limit of each number that decides ``correct``.

Adding a cell, a configuration, a traffic mix or a per-layer metric adds
files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    config: Dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _reports(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``cell`` reports the per-layer ``metric``: the cells it lists,
    else every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def cell(name: str, bench: Dict = None) -> Cell:
    """The cell ``name`` of ``bench``, by default the checkout's
    ``BENCHMARK.json``."""
    bench = bench or benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(name, config, traffic, w["chips"], e2e, per_layer, limits)


def metric_module(name: str) -> ModuleType:
    """``metrics/<name>.py``, loaded by its path (a metric's name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
