"""95th percentile (nearest rank) of how late the load generator
submitted each request after its due moment, in ms."""

from port_bench.lib.compare import p95


def read(run):
    lag = run.counters.get("lag_ms")
    return p95(lag) if lag else None
