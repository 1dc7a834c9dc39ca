"""Profiling hooks.

The port of ``musicgeneration_tpu/utils/profiling.py``:

- ``profile_trace(dir)``: ``torch.profiler`` over the enclosed block (the
  CPU, and the card when there is one), written to ``dir`` as a Chrome /
  Perfetto trace (``trace.json``) beside the program's spans of the
  block (``spans.json``); the profiler object is yielded for
  ``key_averages()``.
- ``span(name, key=None)``: a host interval of the program, kept in
  memory while a ``torch.profiler`` session is open in the process;
  ``take_spans()`` hands them over. The store keeps the newest
  ``STORE_SPANS`` spans, so a session that nobody drains (a user's own
  long ``torch.profiler`` run) holds a bounded amount of memory.
- ``debug_nans(enable)``: ``jax_debug_nans``'s counterpart, torch's
  anomaly mode (a backward that produces NaN raises, naming the forward
  operation).
- ``annotate(name)``: a named region in the profiler's trace
  (``torch.profiler.record_function``).

A span reads ``time.perf_counter_ns()``, the host clock the benchmark
maps the device's events onto, so spans and device intervals compare
directly. It never synchronises the card, reads no tensor and emits no
profiler event (a ``record_function`` would also appear on the device's
track as a user annotation). With no profiler session open it costs one
flag check: ``torch.profiler`` sets ``torch.autograd.profiler``'s
process-wide ``_is_profiler_enabled`` (``torch._C._autograd.
_profiler_enabled()`` is per thread, and False on a thread the session
did not start on, such as the prefetch thread).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Deque, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]   # the enclosing span on the same thread
    thread: int             # threading.get_ident()
    key: Optional[int]      # ties the spans of one item together


# ~10 spans a training step: the newest ~25k steps of an undrained session
STORE_SPANS = 1 << 18
_store: Deque[Span] = collections.deque(maxlen=STORE_SPANS)
_local = threading.local()


class _Recording:
    __slots__ = ("name", "key", "parent", "t0")

    def __init__(self, name: str, key: Optional[int]):
        self.name, self.key = name, key

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        _store.append(Span(self.name, self.t0, t1, self.parent,
                           threading.get_ident(), self.key))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, key: Optional[int] = None):
    """A context manager that records the block as a ``Span`` while a
    profiler session is open in the process, and does nothing else."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, key)


def take_spans() -> List[Span]:
    """The spans recorded so far (the newest ``STORE_SPANS``), in the
    order they ended; the store is emptied of them."""
    out = []
    for _ in range(len(_store)):  # spans that end meanwhile stay
        try:
            out.append(_store.popleft())
        except IndexError:  # a full store dropped its oldest meanwhile
            break
    return out


def write_spans(path: str, spans: List[Span]) -> None:
    """``spans`` as trace-event JSON (complete events, host clock in
    microseconds), with each span's parent and key under ``args``."""
    pid = os.getpid()
    events = [{"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid,
               "tid": s.thread, "args": {"parent": s.parent, "key": s.key}}
              for s in spans]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Trace the enclosed block into log_dir/trace.json, and the program's
    spans that start in it into log_dir/spans.json. Spans left in the
    store by an earlier session are dropped on entry."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    take_spans()
    t0 = time.perf_counter_ns()
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    write_spans(os.path.join(log_dir, "spans.json"),
                [s for s in take_spans() if s.start_ns >= t0])


def debug_nans(enable: bool = True) -> None:
    """Turn torch's anomaly mode on or off for the process: a backward
    that produces NaN raises, with the forward operation's trace."""
    torch.autograd.set_detect_anomaly(enable)


def annotate(name: str) -> "torch.profiler.record_function":
    """Named region visible in profiler traces (a context manager)."""
    return torch.profiler.record_function(name)
