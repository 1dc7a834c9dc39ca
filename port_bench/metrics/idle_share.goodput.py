"""The device's idle share of the traced window (%): 1 - the union of
device activity over the window."""

from port_bench.metrics._idle import idle_share


def read(run):
    return idle_share(run)
