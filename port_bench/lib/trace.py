"""Host spans and the device trace of a measured window.

``Spans`` records the benchmark's own spans around its calls into each
layer of the program (host ``perf_counter_ns``). ``DeviceTrace`` runs
``torch.profiler`` over the window with device activity only and reads
the events in memory, writing nothing to disk; ``TraceSummary`` holds
what the per-layer readers need: the device intervals (kernels, copies
and sets), their union, device time by kernel name, and the idle gaps
named by the host span they fall in.

The device events carry the profiler's clock. ``DeviceTrace.start``
synchronises the card, reads the host clock and launches one marker
operation, the first device event of the trace: the offset between the
two clocks is taken from it (the launch's own latency, some
microseconds, is left in).
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


class Spans:
    """Named host intervals ``(label, start_ns, end_ns)``, in memory."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    def add(self, label: str, t0_ns: int, t1_ns: int) -> None:
        self.items.append((label, t0_ns, t1_ns))

    def total_s(self, label: str, lo_ns: int, hi_ns: int) -> Tuple[float, int]:
        """Seconds and count of the spans named ``label`` that start in
        [lo_ns, hi_ns)."""
        sel = [(b - a) for n, a, b in self.items
               if n == label and lo_ns <= a < hi_ns]
        return sum(sel) / 1e9, len(sel)


class SpanIndex:
    """The innermost (latest started) span covering a host time."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda s: s[1])
        self.starts = [s[1] for s in self.items]

    def at(self, t_ns: int) -> str:
        i = bisect.bisect_right(self.starts, t_ns) - 1
        for j in range(i, max(-1, i - 64), -1):
            label, a, b = self.items[j]
            if a <= t_ns < b:
                return label
        return "outside any span"


def short_name(name: str) -> str:
    """A kernel name without its template arguments and parameter list,
    at most 80 characters."""
    name = name.replace("(anonymous namespace)", "anon").replace("->", "to")
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)" and depth:
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:80] or name[:80]


class TraceSummary:
    """The device intervals of one traced window, host window in ns."""

    def __init__(self, names: List[str], start: np.ndarray, end: np.ndarray,
                 win_lo_ns: int, win_hi_ns: int, spans: Spans):
        keep = (end > win_lo_ns) & (start < win_hi_ns)
        self.names = [n for n, k in zip(names, keep) if k]
        self.start = np.clip(start[keep], win_lo_ns, win_hi_ns)
        self.end = np.clip(end[keep], win_lo_ns, win_hi_ns)
        self.win_lo, self.win_hi = win_lo_ns, win_hi_ns
        self.spans = spans
        self._union = None

    @property
    def window_s(self) -> float:
        return (self.win_hi - self.win_lo) / 1e9

    def union(self) -> List[Tuple[int, int]]:
        """The merged device-busy intervals (host clock, ns)."""
        if self._union is None:
            order = np.argsort(self.start, kind="stable")
            merged: List[List[int]] = []
            for a, b in zip(self.start[order].tolist(),
                            self.end[order].tolist()):
                if merged and a <= merged[-1][1]:
                    if b > merged[-1][1]:
                        merged[-1][1] = b
                else:
                    merged.append([a, b])
            self._union = [(a, b) for a, b in merged]
        return self._union

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.union()) / 1e9

    def kernel_time(self, pattern: str) -> Tuple[float, int]:
        """Device seconds (summed) and launches of the events whose name
        matches the regular expression ``pattern``."""
        rx = re.compile(pattern)
        dur = self.end - self.start
        sel = [i for i, n in enumerate(self.names) if rx.search(n)]
        return float(dur[sel].sum()) / 1e9 if sel else 0.0, len(sel)

    def device_ops(self, top: int = 10) -> List[list]:
        """[name, seconds] of the ``top`` names that took most device
        time."""
        tot: Dict[str, float] = {}
        for n, a, b in zip(self.names, self.start.tolist(),
                           self.end.tolist()):
            k = short_name(n)
            tot[k] = tot.get(k, 0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """[host span, seconds] of the ``top`` longest stretches in which
        no device activity ran, each named by the host span at its
        midpoint."""
        u = self.union()
        edges = [self.win_lo] + [x for ab in u for x in ab] + [self.win_hi]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        idx = SpanIndex(self.spans.items)
        return [[idx.at(a + g // 2), g / 1e9] for g, a in gaps[:top]]


class DeviceTrace:
    """``torch.profiler`` over a window, CUDA activity only; nothing is
    written to disk. On a device that is not CUDA it records nothing."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self.device = device
        self.prof = None

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self._h0 = time.perf_counter_ns()
        torch.ones(1, device=self.device).add_(1)  # the marker
        torch.cuda.synchronize()

    def stop(self) -> None:
        if self.prof is not None:
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)

    def summary(self, win_lo_ns: int, win_hi_ns: int,
                spans: Spans) -> Optional[TraceSummary]:
        """The window's device events in host-clock ns; None when nothing
        was traced."""
        if self.prof is None:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        names, start, dur = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            names.append(e.name())
            start.append(e.start_ns())
            dur.append(e.duration_ns())
        self.prof = None
        if not names:
            return None
        start = np.asarray(start, np.int64)
        dur = np.asarray(dur, np.int64)
        offset = int(start.min()) - self._h0
        start = start - offset
        return TraceSummary(names, start, start + dur, win_lo_ns, win_hi_ns,
                            spans)
