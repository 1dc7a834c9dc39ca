"""The benchmark's CPU tests import the harness as ``port_bench`` (the
checkout's root on the path) and the tiny cells (``pb_tiny``)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

# one intra-op thread a test process: under pytest-xdist, workers that each
# spin a thread a core starve one another, and a tiny serving cell's
# wall-clock window then finishes too few requests to compare
torch.set_num_threads(1)
