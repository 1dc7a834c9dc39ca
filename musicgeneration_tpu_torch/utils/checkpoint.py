"""Atomic, preemption-safe training checkpoints with auto-resume.

The port of ``musicgeneration_tpu/utils/checkpoint.py`` in its own
format, since flax msgpack cannot be read without flax. ``step-<N>.pt``
(``torch.save``) holds the whole state of a training run:

    {"step": N,
     "model": the model's state_dict under the reference names
              (``Decoder.embedding.weight``, ..., ``fc.weight``; the names
              ``convert.py`` maps flax trees to),
     "opt": {"count": optax's update count,
             "mu": {name: first moment}, "nu": {name: second moment}},
     "dropout_seed": int,
     "config": the CLI config dict}

Writes go to ``<name>.tmp``, are fsynced and ``os.replace``d, so a crash
mid-save never corrupts the newest good checkpoint; ``keep`` bounds how
many stay on disk. ``meta.json`` beside them carries the data cursor.
``convert.load_checkpoint`` reads the model out of these files.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

_CKPT_RE = re.compile(r"^step-(\d+)\.pt$")


def _payload(step: int, state: Any, config: Optional[Dict[str, Any]]):
    names = [n for n, _ in state.model.named_parameters()]
    opt = state.opt_state
    return {
        "step": int(step),
        "model": {k: v.detach().cpu()
                  for k, v in state.model.state_dict().items()},
        "opt": {"count": int(opt.count),
                "mu": {n: t.detach().cpu() for n, t in zip(names, opt.mu)},
                "nu": {n: t.detach().cpu() for n, t in zip(names, opt.nu)}},
        "dropout_seed": int(state.dropout_seed),
        "config": config or {},
    }


def save_checkpoint(directory: str, step: int, state: Any,
                    config: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    """Write ``state`` (a ``train.trainer.TrainState``) atomically to
    directory/step-N.pt and drop all but the newest ``keep``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step-{int(step)}.pt")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(_payload(step, state, config), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _gc(directory, keep)
    return path


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[str]:
    ckpts = list_checkpoints(directory)
    return ckpts[-1][1] if ckpts else None


def restore_checkpoint(path_or_dir: str) -> Dict[str, Any]:
    """The payload of a checkpoint file, or of the newest one in a
    directory (tensors on the CPU)."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = latest_checkpoint(path_or_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {path_or_dir}")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state(state: Any, payload: Dict[str, Any]) -> Any:
    """Copy a payload into ``state`` in place (parameters, Adam moments
    and count, dropout seed, step) and return it."""
    state.model.load_state_dict(payload["model"], strict=True)
    names = [n for n, _ in state.model.named_parameters()]
    opt = payload["opt"]
    with torch.no_grad():
        for n, mu, nu in zip(names, state.opt_state.mu, state.opt_state.nu):
            mu.copy_(opt["mu"][n])
            nu.copy_(opt["nu"][n])
    state.opt_state.count = int(opt["count"])
    state.dropout_seed = int(payload["dropout_seed"])
    state.step = int(payload["step"]) + 1
    return state


def _gc(directory: str, keep: int) -> None:
    ckpts = list_checkpoints(directory)
    for _, path in ckpts[:-keep] if keep > 0 else []:
        try:
            os.remove(path)
        except OSError:
            pass


class Checkpointer:
    """Every-N-steps checkpoint policy + auto-restore, one object.

    >>> ckpt = Checkpointer(dir, every=1000)
    >>> state, start_step = ckpt.restore_or(state)   # auto-resume
    >>> for step in range(start_step, total):
    ...     state, metrics = train_step(state, batch)
    ...     ckpt.maybe_save(step, state)
    """

    def __init__(self, directory: str, every: int = 1000, keep: int = 3,
                 config: Optional[Dict[str, Any]] = None):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.config = config or {}

    def restore_or(self, init_state: Any) -> Tuple[Any, int]:
        latest = latest_checkpoint(self.directory)
        if latest is None:
            return init_state, 0
        payload = restore_checkpoint(latest)
        return load_state(init_state, payload), int(payload["step"]) + 1

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        if force or (self.every and (step + 1) % self.every == 0):
            save_checkpoint(self.directory, step, state,
                            config=self.config, keep=self.keep)
            return True
        return False

    def write_meta(self, **meta: Any) -> None:
        """Side-channel JSON (dataset cursor, data seed, ...)."""
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, "meta.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)

    def read_meta(self) -> Dict[str, Any]:
        path = os.path.join(self.directory, "meta.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)
