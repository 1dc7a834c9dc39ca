"""Each card's share of its dense bf16 peak (989 TFLOP/s) in the
data-parallel step, in percent: ``train_mfu``'s count over rank 0's
rows and steps (every rank runs the same steps on as many rows)."""

from port_bench.metrics.train_mfu import read  # noqa: F401
