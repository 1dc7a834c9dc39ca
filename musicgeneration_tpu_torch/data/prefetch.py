"""Host -> device prefetch.

The port of ``musicgeneration_tpu/data/prefetch.py``: a background thread
runs the host batch pipeline (crops in numpy) while the device computes,
and stages each batch to the device ahead of use. For a CUDA device the
arrays go through pinned host memory and ``non_blocking`` copies, so the
transfers overlap the running step; on the CPU they are wrapped as they
are. ``sliding_prefetch`` is the synchronous variant, without a thread.

Under a profiler session the thread's work on each batch is the span
``prefetch.produce`` (the crops and the start of the copy) and the
consumer's wait for it ``prefetch.wait``, both keyed by the batch's
position in the stream (``utils.profiling.span``).
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from ..utils.profiling import span


def to_device(batch: Any, device: torch.device) -> Any:
    """A (nested tuple / list / dict of) numpy array(s) as tensors on
    ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(v, device) for v in batch)
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device="cuda") -> Iterator:
    """Yield device-resident batches, keeping ``size`` in flight. An error
    in the pipeline is re-raised in the consumer; closing the consumer
    stops the thread."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    stop = threading.Event()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            it = iter(iterator)
            for key in itertools.count():
                with span("prefetch.produce", key):
                    batch = next(it, done)
                    if batch is not done:
                        batch = to_device(batch, device)
                if batch is done:
                    break
                if not offer(batch):
                    return
            offer(done)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            offer(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        for key in itertools.count():
            with span("prefetch.wait", key):
                item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item  # the pipeline's real error, not a silent end
            yield item
    finally:
        stop.set()
        thread.join(timeout=5.0)


def sliding_prefetch(iterator: Iterable, size: int = 2,
                     device="cuda") -> Iterator:
    """Synchronous variant (no thread): keep ``size`` batches staged on
    ``device`` ahead of the one yielded, relying on the copies'
    asynchrony only (``non_blocking`` from pinned memory on CUDA) —
    deterministic, test-friendly."""
    device = torch.device(device)
    it = iter(iterator)
    buf = collections.deque(to_device(b, device)
                            for b in itertools.islice(it, size))
    while buf:
        out = buf.popleft()
        buf.extend(to_device(b, device) for b in itertools.islice(it, 1))
        yield out
