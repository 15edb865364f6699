"""Every cell of ``BENCHMARK.json`` loads by name with its configuration,
traffic mix, limits and per-layer readers, and the file keeps to the
contract's shape."""
import json
import os
import re

import pytest

from benchmark import cells

ROOT = cells.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(name):
    cell = cells.load(name)
    assert cell.chips == 1
    assert cell.config["name"] in name
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    lim = cell.limits
    assert lim["check_frames"] >= 1
    assert {"pos_apart", "vel_apart", "order_breaks",
            "start_rows_apart"} <= set(lim["limits"])
    assert ("px_apart" in lim["limits"]) == bool(cell.traffic["export"])
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]).read)


def test_unknown_cell_names_the_cells():
    with pytest.raises(KeyError, match="default_131k.sim16"):
        cells.load("no_such.cell")


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "traffic", f"{w['traffic']}.json"))
