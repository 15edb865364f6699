"""Everything of one cell, found by name: ``BENCHMARK.json``'s entries,
the configuration's file, the traffic mix ``traffic/<mix>.json``, the
output check's limits ``limits/<cell>.json`` and the readers
``metrics/<metric>.py`` of the per-layer metrics that the cell reports.
A later cell, mix or metric is files and entries of its own; nothing here
names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration's file
    traffic: dict       # traffic/<mix>.json
    limits: dict        # limits/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the cells are "
                       f"{', '.join(sorted(cells))}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = os.path.join(root, os.path.basename(HERE))
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(root, cfg["file"])),
        traffic=_json(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        limits=_json(os.path.join(here, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, root: str = ROOT):
    """The module ``metrics/<metric>.py``: its ``read(slice)`` gives the
    metric's value, or None where the slice holds nothing to read."""
    path = os.path.join(root, os.path.basename(HERE), "metrics",
                        f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
