"""The program's own spans read against the device trace of the window.

The program (``musicgeneration_tpu_torch.utils.profiling``) keeps its
spans in memory while a profiler session is open, which in a traced run
is the window. ``program_spans`` takes them once a run (a second
``take_spans`` would find the store empty) and keeps them on the run for
every reader. ``idle_by_span`` splits each stretch of the window in
which the device ran nothing by the innermost span, of the thread that
ran the step, covering each instant (``OUTSIDE`` where none does).
Every reader gives None where the run has no trace or the program no
spans (a program without the span store, or a run on the CPU).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

STEP = "trainer.step"
OUTSIDE = "outside any span"


def program_spans(run) -> Optional[list]:
    """The program's spans of the run (``profiling.Span``: name,
    start_ns, end_ns, parent, thread, key), or None."""
    if run.trace_summary is None:
        return None
    if not hasattr(run, "_program_spans"):
        try:
            from musicgeneration_tpu_torch.utils.profiling import take_spans
        except ImportError:
            run._program_spans = []
        else:
            run._program_spans = take_spans()
    return run._program_spans or None


def in_window(run, name: str) -> List[tuple]:
    """The spans named ``name`` that start in the window."""
    spans = program_spans(run) or []
    return [s for s in spans if s.name == name
            and run.window_lo_ns <= s.start_ns < run.window_hi_ns]


def step_thread(run) -> Optional[int]:
    """The thread that ran the window's steps."""
    steps = in_window(run, STEP)
    return steps[0].thread if steps else None


def mean_ms(spans: List[tuple]) -> Optional[float]:
    return (sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6
            if spans else None)


def label_segments(items, lo: int, hi: int) -> List[Tuple[int, int, str]]:
    """Disjoint (a, b, name) covering [lo, hi), each part named by the
    innermost of the nested spans (name, start_ns, end_ns) that covers
    it."""
    items = sorted(((max(a, lo), min(b, hi), n) for n, a, b in items
                    if min(b, hi) > max(a, lo)),
                   key=lambda s: (s[0], -s[1]))
    cuts = sorted({lo, hi, *(x for a, b, _ in items for x in (a, b))})
    out, stack, i = [], [], 0
    for t0, t1 in zip(cuts, cuts[1:]):
        while i < len(items) and items[i][0] <= t0:
            stack.append(items[i])
            i += 1
        while stack and stack[-1][1] <= t0:
            stack.pop()
        out.append((t0, t1, stack[-1][2] if stack else OUTSIDE))
    return out


def idle_stretches(union, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The parts of [lo, hi) outside the merged busy intervals."""
    out, t = [], lo
    for a, b in union:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def split_idle(idle, segments) -> Dict[str, int]:
    """Nanoseconds of ``idle`` under each segment's name (both lists
    sorted and disjoint)."""
    tot: Dict[str, int] = collections.defaultdict(int)
    j = 0
    for a, b in idle:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s0, s1, name = segments[k]
            tot[name] += min(b, s1) - max(a, s0)
            k += 1
    return dict(tot)


def idle_by_span(run) -> Optional[Tuple[Dict[str, int], int]]:
    """(device-idle ns of the window by innermost program span of the
    step's thread, the window's steps), or None."""
    if not hasattr(run, "_idle_by_span"):
        run._idle_by_span = None
        thread = step_thread(run)
        if thread is not None:
            lo, hi = run.window_lo_ns, run.window_hi_ns
            mine = [(s.name, s.start_ns, s.end_ns)
                    for s in program_spans(run) if s.thread == thread]
            idle = idle_stretches(run.trace_summary.union(), lo, hi)
            run._idle_by_span = (split_idle(idle,
                                            label_segments(mine, lo, hi)),
                                 len(in_window(run, STEP)))
    return run._idle_by_span


def idle_ms_per_step(run, names) -> Optional[float]:
    """Device-idle ms a step inside the spans ``names``."""
    got = idle_by_span(run)
    if got is None:
        return None
    by_name, steps = got
    return sum(by_name.get(n, 0) for n in names) / steps / 1e6
