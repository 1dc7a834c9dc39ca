"""Structured JSONL metrics logging.

The port of ``musicgeneration_tpu/utils/metrics_log.py``: one JSON line
per logged step with loss / accuracy / grad_norm, steps/s and tokens/s
(wall clock), to stdout and/or a file. A tensor metric is read to the
host only on the steps that are logged.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, IO, Optional

import numpy as np
import torch


def _scalar(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return float(v)
    if isinstance(v, np.ndarray):
        return float(v)
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


class MetricsLogger:
    """Per-step metric emitter with derived throughput.

    >>> log = MetricsLogger(path="metrics.jsonl", every=10)
    >>> for step ...:
    ...     log.write(step, metrics, tokens=batch*seq_len)
    """

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 every: int = 1, prefix: str = "train"):
        self.every = max(1, every)
        self.prefix = prefix
        self._fh = open(path, "a") if path else None
        self._stream = stream if stream is not None else sys.stdout
        self._last_t: Optional[float] = None
        self._last_step: Optional[int] = None
        self._tokens_since = 0

    def write(self, step: int, metrics: Dict[str, Any],
              tokens: int = 0, **extra: Any) -> Optional[Dict[str, Any]]:
        self._tokens_since += tokens
        if step % self.every:
            return None
        now = time.time()
        record: Dict[str, Any] = {"kind": self.prefix, "step": int(step),
                                  "time": now}
        record.update({k: _scalar(v) for k, v in metrics.items()})
        record.update({k: _scalar(v) for k, v in extra.items()})
        if self._last_t is not None and now > self._last_t:
            dt = now - self._last_t
            record["steps_per_sec"] = (step - self._last_step) / dt
            if self._tokens_since:
                record["tokens_per_sec"] = self._tokens_since / dt
        self._last_t, self._last_step = now, step
        self._tokens_since = 0
        line = json.dumps(record)
        if self._stream is not None:
            print(line, file=self._stream, flush=True)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        return record

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
