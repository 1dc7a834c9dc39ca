"""Every cell names a configuration, a driver and metric readers that
exist, and BENCHMARK.json agrees with the cell files."""

import json
import os
import re

import pytest

from port_bench.lib import common

BENCH = common.read_json(os.path.join(common.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_exist_and_agree(name):
    cell = common.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell["config"] == entry["config"]
    assert cell["traffic"]["name"] == entry["traffic"]
    assert cell["chips"] == entry["chips"] and cell["why"] == entry["why"]
    assert os.path.exists(os.path.join(common.HERE, "drivers",
                                       cell["driver"] + ".py"))
    assert cell["limits"], "a cell compares at least one number"


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_exist(name):
    reader = common.metric_reader(name)
    assert callable(reader.read)


def test_configs_and_names():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(common.ROOT, c["file"]))
        data = json.load(open(os.path.join(common.ROOT, c["file"])))
        assert data["name"] == c["name"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[key]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    assert "setup_s" in e2e
    for w in CELLS:
        reported = [m for m in BENCH["end_to_end"]
                    if "workloads" not in m or w in m["workloads"]]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", CELLS) for m in BENCH["per_layer"])


@pytest.mark.parametrize("name", CELLS)
def test_a_run_reports_each_end_to_end_metric_of_its_cell(name):
    """A tiny run on the CPU (a data-parallel cell on gloo ranks) gives a
    value above 0 for every end-to-end metric BENCHMARK.json lists for
    its cell, a name split by cell included."""
    import pb_tiny
    line = common.result_line(pb_tiny.tiny_run(name), BENCH)
    for m in common.cell_metrics(BENCH, name, "end_to_end"):
        assert line["metrics"][m["name"]]["value"] > 0, m["name"]
