"""A cell's files, found by the names that ``BENCHMARK.json`` gives.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own:

* ``configs/<config>.json`` — the configuration's sizes, as run;
* ``traffic/<traffic>.json`` — the mix's parameters, read by
  ``generator.py``;
* ``metrics/<metric>.py`` — one reader per per-layer metric;
* ``limits/<cell>.json`` — the limits that decide ``correct`` in the cell.

A later cell, mix or metric is added as new files and entries; no file
here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(entry: dict, cell: str, e2e_names: Optional[set] = None) -> bool:
    """Whether a metric is reported in ``cell``: listed there, or (with no
    ``workloads`` key) reported wherever its end-to-end metric is."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    if e2e_names is None:
        return True
    return entry["moves"] in e2e_names


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; raises
    ``KeyError`` for a name it does not hold."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it holds "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [e for e in bench["end_to_end"] if _applies(e, name)]
    names = {e["name"] for e in e2e}
    per_layer = [p for p in bench["per_layer"] if _applies(p, name, names)]
    limits = load_json(HERE / "limits" / f"{name}.json")
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                limits)


HOSTPACED = ".hostpaced"


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``: it takes a ``Readings`` and
    returns a number, or None when it finds nothing to read.  A name
    ``<base>.hostpaced`` without a file of its own reads as ``<base>``: the
    same number, reported in a host-paced cell (the host-paced rule,
    ``PERF.md``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and name.endswith(HOSTPACED):
        return metric_reader(name[:-len(HOSTPACED)])
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
