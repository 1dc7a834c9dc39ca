"""Profiling hooks.

The port of ``musicgeneration_tpu/utils/profiling.py``:

- ``profile_trace(dir)``: ``torch.profiler`` over the enclosed block (the
  CPU, and the card when there is one), written to ``dir`` as a Chrome /
  Perfetto trace; the profiler object is yielded for ``key_averages()``.
- ``timed_block(name)``: wall clock of a block that ends in a device
  synchronise when there is a card, so it covers the device's work and
  not only its dispatch.
- ``debug_nans(enable)``: ``jax_debug_nans``'s counterpart, torch's
  anomaly mode (a backward that produces NaN raises, naming the forward
  operation).
- ``annotate(name)``: a named region in the profiler's trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Trace the enclosed block into log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed_block(name: str, sink: Optional[Dict[str, float]] = None
                ) -> Iterator[Dict[str, float]]:
    """Measure the wall clock of a block, synchronising the card (if
    any) at its end."""
    out: Dict[str, float] = {}
    t0 = time.perf_counter()
    yield out
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out[name] = time.perf_counter() - t0
    if sink is not None:
        sink[name] = out[name]


def debug_nans(enable: bool = True) -> None:
    """Turn torch's anomaly mode on or off for the process: a backward
    that produces NaN raises, with the forward operation's trace."""
    torch.autograd.set_detect_anomaly(enable)


def annotate(name: str) -> "torch.profiler.record_function":
    """Named region visible in profiler traces (a context manager)."""
    return torch.profiler.record_function(name)
