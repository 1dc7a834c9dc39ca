"""Losses and metrics.

The port of ``musicgeneration_tpu/train/objective.py`` (reference parity:
SmoothCrossEntropyLoss, MusicTransformer/criterion.py:28-67;
CategoricalAccuracy and MetricsSet, metrics.py:40-75). Computation is f32
whatever the model's compute dtype. ``popmag_masked_loss`` is not ported
yet (PoPMAG is not).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def smooth_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         vocab_size: int, label_smoothing: float = 0.1,
                         ignore_index: Optional[int] = None,
                         denom: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Label-smoothed CE, mean over non-ignored targets (with ``denom``:
    their sum over ``denom``, e.g. a shard's sum over the global count).

    logits: [..., V]; targets: [...] int. q' = (1-eps) * onehot + eps/V,
    in the gather form: the [N, V] one-hot is never built. A target
    outside [0, vocab_size) contributes no one-hot term (one_hot's
    all-zero row); ignored targets are dropped from both terms and from
    the count."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    tgt = targets.clamp(0, vocab_size - 1).long()[..., None]
    tgt_lp = torch.gather(log_probs, -1, tgt)[..., 0]
    in_range = ((targets >= 0) & (targets < vocab_size)).float()
    ce = -((1.0 - label_smoothing) * tgt_lp * in_range
           + (label_smoothing / vocab_size) * log_probs.sum(-1))
    if ignore_index is not None:
        keep = (targets != ignore_index).float()
        ce = ce * keep
        if denom is None:
            denom = keep.sum().clamp_min(1.0)
    elif denom is None:
        denom = float(targets.numel())
    return ce.sum() / denom


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                   ignore_index: Optional[int] = None,
                   denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Argmax accuracy over non-ignored tokens (metrics.py:40-52); with
    ``denom`` the hits are summed and divided by it."""
    hit = (logits.argmax(-1) == targets).float()
    if ignore_index is not None:
        keep = (targets != ignore_index).float()
        hit = hit * keep
        if denom is None:
            denom = keep.sum().clamp_min(1.0)
    elif denom is None:
        return hit.mean()
    return hit.sum() / denom


def CategoricalAccuracy(ignore_index: Optional[int] = None):
    return lambda logits, targets: token_accuracy(logits, targets,
                                                  ignore_index)


class MetricsSet:
    """Compose named metric fns: apply them all to (logits, targets)
    (reference metrics.py:63-75)."""

    def __init__(self, metrics: Dict[str, Callable]):
        self.metrics = dict(metrics)

    def __call__(self, logits, targets) -> Dict[str, torch.Tensor]:
        return {name: fn(logits, targets)
                for name, fn in self.metrics.items()}


def logits_bucketting(logits: torch.Tensor) -> torch.Tensor:
    """Flat argmax token ids for histogram/diversity inspection
    (reference metrics.py:55-60 LogitsBucketting)."""
    return logits.argmax(-1).reshape(-1).to(torch.int32)
