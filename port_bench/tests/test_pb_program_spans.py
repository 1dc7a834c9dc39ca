"""The program-span readers (``metrics/_program_spans.py`` and the five
metrics that use it): the known answer on a synthetic trace and span
list, and None where nothing was traced."""

import types

import numpy as np
import pytest

import pb_tiny
from musicgeneration_tpu_torch.utils import profiling
from port_bench.lib import common
from port_bench.lib.trace import Spans, TraceSummary
from port_bench.metrics import _program_spans as ps

MS = 1_000_000
MAIN, OTHER = 1, 2
READERS = ("idle_sync_ms.train", "idle_dispatch_ms.train",
           "idle_data_ms.train", "data_wait_ms.train",
           "batch_build_ms.train")


def _span(name, a, b, thread=MAIN, parent=None, key=None):
    return profiling.Span(name, a * MS, b * MS, parent, thread, key)


# the window is [0, 100) ms; the device is busy in [-5, 5], [10, 20],
# [30, 60] and [90, 130], so idle in [5, 10), [20, 30) and [60, 90)
BUSY = [(-5, 5), (10, 20), (30, 60), (90, 130)]
SPANS = [
    _span("trainer.step", -10, 1),                      # starts before
    _span("trainer.step", 2, 70),
    _span("trainer.forward", 4, 12, parent="trainer.step"),    # idle 5
    _span("trainer.backward", 12, 25, parent="trainer.step"),  # idle 5
    _span("trainer.sync", 25, 50, parent="trainer.step"),      # idle 5
    _span("trainer.optimizer", 50, 65, parent="trainer.step"),  # idle 5
    # the step's own time [65, 70): idle 5
    _span("prefetch.wait", 70, 85, key=1),                      # idle 15
    # outside every span [85, 90): idle 5
    _span("trainer.step", 95, 130),                     # ends after
    # another thread's spans are left out of the split
    _span("trainer.sync", 60, 90, thread=OTHER),
    _span("prefetch.produce", 0, 90, thread=OTHER, key=1),
    _span("prefetch.produce", 91, 99, thread=OTHER, key=2),
    _span("prefetch.produce", 100, 120, thread=OTHER, key=3),  # after
]
EXPECTED = {"idle_sync_ms.train": 5.0, "idle_dispatch_ms.train": 5.0,
            "idle_data_ms.train": 7.5, "data_wait_ms.train": 15.0,
            "batch_build_ms.train": 49.0}


def _synthetic_run(monkeypatch, spans=SPANS):
    taken = []

    def take_spans():
        taken.append(1)
        return list(spans)

    monkeypatch.setattr(profiling, "take_spans", take_spans)
    start = np.asarray([a * MS for a, _ in BUSY], np.int64)
    end = np.asarray([b * MS for _, b in BUSY], np.int64)
    summary = TraceSummary(["k"] * len(BUSY), start, end, 0, 100 * MS,
                           Spans())
    run = types.SimpleNamespace(trace_summary=summary, window_lo_ns=0,
                                window_hi_ns=100 * MS)
    return run, taken


def test_known_answer(monkeypatch):
    run, taken = _synthetic_run(monkeypatch)
    for name in READERS:
        assert common.metric_reader(name).read(run) == pytest.approx(
            EXPECTED[name]), name
    assert len(taken) == 1  # one take a run, kept for every reader


def test_idle_split_adds_up(monkeypatch):
    run, _ = _synthetic_run(monkeypatch)
    by_name, steps = ps.idle_by_span(run)
    assert steps == 2
    assert {k: v / MS for k, v in by_name.items()} == {
        "trainer.forward": 5, "trainer.backward": 5, "trainer.sync": 5,
        "trainer.optimizer": 5, "trainer.step": 5, "prefetch.wait": 15,
        ps.OUTSIDE: 5}
    idle_s = run.trace_summary.window_s - run.trace_summary.busy_s()
    assert sum(by_name.values()) / 1e9 == pytest.approx(idle_s)


def test_label_segments_innermost():
    items = [("a", 0, 10), ("b", 2, 5), ("c", 3, 4), ("d", 6, 8)]
    assert ps.label_segments(items, -1, 12) == [
        (-1, 0, ps.OUTSIDE), (0, 2, "a"), (2, 3, "b"), (3, 4, "c"),
        (4, 5, "b"), (5, 6, "a"), (6, 8, "d"), (8, 10, "a"),
        (10, 12, ps.OUTSIDE)]
    # spans cut at the window's edges
    assert ps.label_segments(items, 3, 7) == [
        (3, 4, "c"), (4, 5, "b"), (5, 6, "a"), (6, 7, "d")]


def test_none_without_spans_or_trace(monkeypatch):
    run, _ = _synthetic_run(monkeypatch, spans=[])
    for name in READERS:
        assert common.metric_reader(name).read(run) is None, name
    run, _ = _synthetic_run(monkeypatch)
    run.trace_summary = None
    for name in READERS:
        assert common.metric_reader(name).read(run) is None, name


def test_none_on_a_program_without_the_span_store(monkeypatch):
    run, _ = _synthetic_run(monkeypatch)
    monkeypatch.delattr(profiling, "take_spans")
    for name in READERS:
        assert common.metric_reader(name).read(run) is None, name


def test_none_on_a_tiny_cpu_run():
    run = pb_tiny.tiny_run("mt-train-b72", trace=True)
    assert run.trace_summary is None  # nothing is traced on the CPU
    for name in READERS:
        assert common.metric_reader(name).read(run) is None, name
