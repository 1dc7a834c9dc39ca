"""95th percentile (nearest rank) over the window's admitted requests of
the time from a request's due moment to its admission by the scheduler
(``SlotScheduler.times[rid]["admit"]``), in ms."""

from port_bench.lib.compare import p95


def read(run):
    w = run.counters.get("queue_wait_ms")
    return p95(w) if w else None
