"""The port's program spans (``utils/profiling.py``) on the CPU.

A span records while a ``torch.profiler`` session is open in the
process and does nothing otherwise; the train step's spans nest under
``trainer.step`` in the order the step runs them; the prefetcher's wait
and production of one batch share its key; the loop's profile window
writes the window's spans beside its trace; no span becomes a profiler
event."""

import collections
import json
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from musicgeneration_tpu_torch.data.prefetch import prefetch_to_device
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.train import loop as tloop
from musicgeneration_tpu_torch.train import trainer as ttr
from musicgeneration_tpu_torch.utils import profiling

V, SEQ, B = 32, 16, 2
PHASES = ["trainer.forward", "trainer.backward", "trainer.sync",
          "trainer.optimizer"]


def _state(seed=0):
    torch.manual_seed(seed)
    model = MusicTransformer(vocab_size=V, num_layers=1, d_model=32,
                             head_dim=16, max_seq=SEQ, dropout_rate=0.1,
                             pad_in_input=False, device="cpu")
    cfg = ttr.TrainerConfig(vocab_size=V, pad_id=V - 1, d_model=32,
                            warmup_steps=10)
    tx = ttr.make_optimizer(cfg)
    return (ttr.create_train_state(model, tx, dropout_seed=1),
            ttr.make_train_step(tx, cfg))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, V - 1, (B, SEQ)))
                 for _ in range(2))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_records_only_under_a_profiler():
    profiling.take_spans()
    with profiling.span("outer"):
        pass
    assert profiling.take_spans() == []
    with _cpu_profile():
        with profiling.span("outer", key=7):
            with profiling.span("inner", key=7):
                pass
    got = profiling.take_spans()
    assert [(s.name, s.parent, s.key) for s in got] == [
        ("inner", "outer", 7), ("outer", None, 7)]
    inner, outer = got
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert {s.thread for s in got} == {threading.get_ident()}
    assert profiling.take_spans() == []


def test_store_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(profiling, "_store", collections.deque(maxlen=3))
    with _cpu_profile():
        for i in range(5):
            with profiling.span("s", key=i):
                pass
    assert [s.key for s in profiling.take_spans()] == [2, 3, 4]
    assert profiling.take_spans() == []


def test_write_spans_is_trace_event_json(tmp_path):
    s = profiling.Span("trainer.step", 2_000, 5_500, None, 11, 3)
    path = tmp_path / "spans.json"
    profiling.write_spans(str(path), [s])
    (ev,) = json.loads(path.read_text())["traceEvents"]
    assert ev["name"] == "trainer.step" and ev["ph"] == "X"
    assert ev["ts"] == 2.0 and ev["dur"] == 3.5 and ev["tid"] == 11
    assert ev["args"] == {"parent": None, "key": 3}


def test_train_step_span_tree():
    state, step = _state()
    x, y = _batch()
    profiling.take_spans()
    with _cpu_profile():
        t0 = time.perf_counter_ns()
        step(state, x, y)
        t1 = time.perf_counter_ns()
    got = profiling.take_spans()
    (root,) = [s for s in got if s.name == "trainer.step"]
    assert root.parent is None
    children = sorted((s for s in got if s.parent == "trainer.step"),
                      key=lambda s: s.start_ns)
    assert [s.name for s in children] == PHASES
    assert len(got) == 1 + len(PHASES)
    for s in children:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns
    for s in got:
        assert t0 <= s.start_ns <= s.end_ns <= t1, s


def test_no_profiler_records_nothing_and_changes_nothing():
    x, y = _batch(1)
    plain, step = _state(3)
    profiling.take_spans()
    plain, m_plain = step(plain, x, y)
    assert profiling.take_spans() == []
    traced, step = _state(3)
    with _cpu_profile():
        traced, m_traced = step(traced, x, y)
    assert profiling.take_spans()
    assert m_plain == m_traced
    for a, b in zip(plain.model.parameters(), traced.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(plain.opt_state.mu + plain.opt_state.nu,
                    traced.opt_state.mu + traced.opt_state.nu):
        assert torch.equal(a, b)


def test_prefetch_wait_and_produce_share_keys():
    batches = [np.full((2, 3), i) for i in range(5)]
    profiling.take_spans()
    with _cpu_profile():
        got = [t.tolist() for t in prefetch_to_device(iter(batches),
                                                      device="cpu")]
    assert got == [b.tolist() for b in batches]
    spans = profiling.take_spans()
    waits = {s.key: s for s in spans if s.name == "prefetch.wait"}
    produced = {s.key: s for s in spans if s.name == "prefetch.produce"}
    assert set(range(5)) <= set(waits) and set(range(5)) <= set(produced)
    me = threading.get_ident()
    for k in range(5):
        assert waits[k].thread == me
        assert produced[k].thread != me
        # a batch is produced before the wait for it ends
        assert produced[k].end_ns <= waits[k].end_ns


def test_profile_window_writes_spans(tmp_path):
    state, step = _state()
    batch = _batch()
    cfg = tloop.LoopConfig(total_steps=11, profile_dir=str(tmp_path),
                           profile_steps=1, log_every=100)
    profiling.take_spans()
    tloop.run_loop(state, step, [batch], cfg)
    assert (tmp_path / "trace.json").exists()
    events = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    names = [e["name"] for e in events]
    assert names.count("trainer.step") == 1
    assert set(PHASES) <= set(names)


def test_profile_window_leaves_out_earlier_spans(tmp_path):
    profiling.take_spans()
    with _cpu_profile():
        with profiling.span("stale"):
            pass
    with profiling.profile_trace(str(tmp_path)):
        with profiling.span("fresh"):
            pass
    events = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    assert [e["name"] for e in events] == ["fresh"]
    assert profiling.take_spans() == []


def test_no_profiler_event_bears_a_span_name():
    state, step = _state()
    x, y = _batch()
    with _cpu_profile() as prof:
        step(state, x, y)
        for _ in prefetch_to_device(iter([np.zeros(2)] * 2), device="cpu"):
            pass
    profiling.take_spans()
    names = {e.name for e in prof.events()}
    assert names  # the profiler saw the step's operations
    assert not [n for n in names
                if n.startswith(("trainer.", "prefetch."))]
