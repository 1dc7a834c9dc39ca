"""The control of each cell comes out not correct: the plain reference
in fp8, put in the program's place, fails one of the cell's limits.

At a tiny size on the CPU here; at the cell's own size on the card by
the test marked ``cuda`` (``python -m pytest -q -m cuda
port_bench/tests/test_pb_control.py`` on a machine with an H100; it
skips without one)."""

import os
import time

import pytest
import torch

import pb_tiny
from port_bench.lib import common

CELLS = ["mt-train-b72", "mt-train-dp4", "mt-serve-continue",
         "prnn-serve-backlog"]


def _fails(run, reading) -> bool:
    limits = run.cell["limits"]
    return any(reading[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_tiny_size(cell):
    for seed in (1, 2, 3):
        run = pb_tiny.tiny_run(cell, seed=seed, controls=("fp8",))
        assert all(c["value"] <= c["limit"] for c in run.checks)
        assert _fails(run, run.counters["control.fp8"]), (
            seed, run.counters["control.fp8"], run.cell["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell):
    chips = common.load_cell(cell)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} NVIDIA H100 card(s): the cell's own "
                    "size runs on the card")
    # the benchmark's own window: a run's longest requests and as many
    # served tokens as a run compares
    seconds = common.read_json(os.path.join(common.ROOT, "BENCHMARK.json"))[
        "run_seconds"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        run = common.execute(common.Run(
            cell=common.load_cell(cell), seed=seed, seconds=seconds,
            trace=False, device=torch.device("cuda", 0),
            t0=time.perf_counter(), options={"controls": ("fp8",)}))
        assert all(c["value"] <= c["limit"] for c in run.checks)
        assert _fails(run, run.counters["control.fp8"])
