"""The generator: deterministic per seed, the same work for every seed."""

import numpy as np

from port_bench.lib import common, traffic


def _mix(cell):
    return common.load_cell(cell)["traffic"]


def test_open_loop_deterministic_per_seed():
    t = _mix("mt-serve-continue")
    a = traffic.open_loop(t, 2**31 + 12345, 20.0, 50.0)
    b = traffic.open_loop(t, 2**31 + 12345, 20.0, 50.0)
    assert a == b
    assert a != traffic.open_loop(t, 2**31 + 12346, 20.0, 50.0)


def test_open_loop_same_work_every_seed():
    t = _mix("mt-serve-continue")
    runs = [traffic.open_loop(t, s, 20.0, 50.0) for s in (1, 99, 2**32 + 5)]
    for key in ("prompt_len", "max_new"):
        sets = [sorted(r[key] for r in reqs) for reqs in runs]
        assert sets[0] == sets[1] == sets[2]
    # the gaps between arrivals: the stratified exponential quantiles of
    # mean 1 / rate (all but the one before the first request)
    quant = set(traffic.quantiles({"dist": "exponential", "mean": 0.02},
                                  1000).tolist())
    for reqs in runs:
        gaps = np.diff([r["due"] for r in reqs])
        assert len(gaps) == 999
        assert all(min(abs(g - q) for q in quant) < 1e-9 for g in gaps[:50])
    # every request due inside the window, in order
    due = [r["due"] for r in runs[0]]
    assert due == sorted(due) and 0.0 <= due[0] and due[-1] < 20.0
    assert sum(r["greedy"] for r in runs[0]) == 125


def test_ranges_and_distributions():
    t = _mix("mt-serve-continue")
    reqs = traffic.open_loop(t, 7, 100.0, 50.0)
    p = np.array([r["prompt_len"] for r in reqs])
    m = np.array([r["max_new"] for r in reqs])
    assert p.min() >= 256 and p.max() <= 1408
    assert m.min() >= 64 and m.max() <= 512
    # log-uniform: the median near sqrt(64 * 512)
    assert abs(np.median(m) - 181) < 5


def test_backlog_blocks_repeat_the_multiset():
    t = _mix("prnn-serve-backlog")
    it = traffic.backlog(t, 11)
    first = [next(it) for _ in range(t["block"])]
    second = [next(it) for _ in range(t["block"])]
    assert sorted(r["max_new"] for r in first) == sorted(
        r["max_new"] for r in second)
    assert [r["max_new"] for r in first] != [r["max_new"] for r in second]
    again = traffic.backlog(t, 11)
    assert [next(again) for _ in range(t["block"])] == first
