"""Tick <-> seconds conversion via the tempo map.

Vectorised over numpy so converting thousands of notes is a couple of
searchsorted + gather ops rather than a Python loop (the per-note loop in
pretty_midi is one of the host-side costs the rebuild removes).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

DEFAULT_US_PER_QN = 500000  # 120 BPM


class TempoMap:
    """Piecewise-linear tick->seconds map built from set_tempo meta events.

    `changes` is a list of (tick, us_per_quarter_note), sorted by tick.
    """

    def __init__(self, changes: Sequence[Tuple[int, int]], ticks_per_beat: int):
        self.ticks_per_beat = int(ticks_per_beat)
        if not changes or changes[0][0] != 0:
            changes = [(0, DEFAULT_US_PER_QN)] + list(changes or [])
        # Deduplicate: keep the last tempo at any given tick.
        dedup = {}
        for tick, us in changes:
            dedup[int(tick)] = int(us)
        ticks = np.array(sorted(dedup), dtype=np.int64)
        us = np.array([dedup[t] for t in sorted(dedup)], dtype=np.float64)
        self._ticks = ticks
        self._us = us
        # Cumulative seconds at each tempo-change boundary.
        spans = np.diff(ticks)  # ticks between consecutive changes
        sec_per_tick = us[:-1] / 1e6 / self.ticks_per_beat
        self._cumsec = np.concatenate([[0.0], np.cumsum(spans * sec_per_tick)])
        self._sec_per_tick = us / 1e6 / self.ticks_per_beat

    def tick_to_time(self, ticks) -> np.ndarray:
        """Vectorised conversion; accepts scalar or array of ticks."""
        t = np.asarray(ticks, dtype=np.float64)
        idx = np.searchsorted(self._ticks, t, side="right") - 1
        idx = np.clip(idx, 0, len(self._ticks) - 1)
        base_tick = self._ticks[idx]
        return self._cumsec[idx] + (t - base_tick) * self._sec_per_tick[idx]
