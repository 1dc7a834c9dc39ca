"""The training loop.

The port of ``musicgeneration_tpu/train/loop.py``: the train step
composed with auto-resume checkpointing, JSONL metrics, a profiler window
and the reference's failure handling:

- non-finite loss: the update is skipped (parameters and optimizer state,
  so the schedule's count, stay as they were) while the step counter
  moves on, and the step logs ``skipped=1``;
- KeyboardInterrupt -> a final checkpoint labelled with the last step
  that completed. The step updates parameters in place, so a SIGINT that
  arrives during a step is held until the step has finished;
- periodic eval on a held-out batch stream.

In a sequence-parallel run (``rank`` set) every rank resumes from the
checkpoint directory and prints its step lines, which carry its rank;
rank 0 alone writes checkpoints, ``meta.json``, the metrics file and the
profile.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import signal
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

from ..utils.checkpoint import Checkpointer
from ..utils.metrics_log import MetricsLogger
from .trainer import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 10000
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1000
    log_every: int = 10
    eval_every: int = 500
    metrics_path: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_steps: int = 0  # trace steps [10, 10+profile_steps)
    rank: int = 0  # sequence-parallel rank; only rank 0 writes files
    # written to meta.json alongside every checkpoint, with the data
    # cursor (= next step; the cli streams are counter-indexed so the
    # cursor IS the step number) — lets a resume detect a seed change
    stream_meta: Optional[Dict[str, Any]] = None


def _guarded(train_step: Callable) -> Callable:
    """The train step with a non-finite loss skipping the update (the
    JAX loop rolls the state back; here the update is never applied)."""
    return functools.partial(train_step, guard=True)


@contextlib.contextmanager
def _interrupt_after():
    """Hold SIGINT until the block has run (main thread only), then raise
    KeyboardInterrupt."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    hit = []
    old = signal.signal(signal.SIGINT, lambda *_: hit.append(True))
    try:
        yield
    finally:
        signal.signal(signal.SIGINT,
                      old if old is not None else signal.default_int_handler)
    if hit:
        raise KeyboardInterrupt


def run_loop(
    state: TrainState,
    train_step: Callable,
    batches: Iterable,
    cfg: LoopConfig,
    eval_step: Optional[Callable] = None,
    eval_batches: Optional[Callable[[], Iterator]] = None,
    tokens_per_batch: int = 0,
    config_dict: Optional[Dict[str, Any]] = None,
) -> TrainState:
    """Drive training to cfg.total_steps; resumable and preemption-safe.

    ``batches`` yields (x, y) tuples of device tensors. ``eval_batches``
    is a zero-arg callable returning a fresh iterator of eval batches.
    ``eval_step(model, x, y)`` returns a dict of scalars."""
    step_fn = _guarded(train_step)
    ckpt = (Checkpointer(cfg.ckpt_dir, every=cfg.ckpt_every,
                         config=config_dict)
            if cfg.ckpt_dir else None)
    start = 0
    if ckpt is not None:
        state, start = ckpt.restore_or(state)
        if cfg.rank:
            ckpt = None  # restored; rank 0 writes
    path = cfg.metrics_path if not cfg.rank else None
    extra = {"rank": cfg.rank} if cfg.rank else {}
    log = MetricsLogger(path=path, every=cfg.log_every)
    eval_log = MetricsLogger(path=path, every=1, prefix="eval")
    it = iter(batches)
    profiler = None

    # `completed` tracks the last step whose step_fn actually finished: a
    # KeyboardInterrupt between fetching a batch and step_fn returning
    # leaves `state` at the previous step, so labelling it with the
    # in-flight loop index would skip one schedule step on resume.
    completed = start - 1
    try:
        for step in range(start, cfg.total_steps):
            if cfg.profile_dir and cfg.profile_steps and not cfg.rank:
                if step == 10 and profiler is None:
                    from ..utils.profiling import profile_trace
                    profiler = profile_trace(cfg.profile_dir)
                    profiler.__enter__()
                elif profiler is not None and step == 10 + cfg.profile_steps:
                    profiler.__exit__(None, None, None)
                    profiler = None
            try:
                batch = next(it)
            except StopIteration:
                it = iter(batches)
                batch = next(it)
            with _interrupt_after():
                state, metrics = step_fn(state, *batch)
                completed = step
            log.write(step, metrics, tokens=tokens_per_batch, **extra)
            if ckpt is not None and ckpt.maybe_save(step, state):
                ckpt.write_meta(data_cursor=step + 1,
                                **(cfg.stream_meta or {}))
            if (eval_step is not None and eval_batches is not None
                    and cfg.eval_every and (step + 1) % cfg.eval_every == 0):
                agg: Dict[str, float] = {}
                n = 0
                for eb in eval_batches():
                    for k, v in eval_step(state.model, *eb).items():
                        agg[k] = agg.get(k, 0.0) + float(v)
                    n += 1
                if n:
                    eval_log.write(step, {k: v / n for k, v in agg.items()},
                                   **extra)
    except KeyboardInterrupt:
        pass
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
        # only save if a step actually completed — a no-op resume must not
        # advance the checkpoint label, and an interrupt mid-step must
        # label the (previous-step) state with the previous step's index
        if ckpt is not None and completed >= start:
            ckpt.maybe_save(completed, state, force=True)
            ckpt.write_meta(data_cursor=completed + 1,
                            **(cfg.stream_meta or {}))
        log.close()
        eval_log.close()
    return state
