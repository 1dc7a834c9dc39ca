"""Sampling transforms: temperature / top-k / top-p / greedy.

The port of ``musicgeneration_tpu/decode/sampling.py``'s ``sample_logits``
with the same set semantics: top-k keeps every id whose logit is not
below the k-th largest (ties kept), top-p runs after top-k and keeps the
smallest sorted prefix whose cumulative probability reaches p, the
temperature is floored at 1e-6. The categorical draw takes an explicit
``torch.Generator`` (a different stream than ``jax.random``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0        # 0 = off
    top_p: float = 1.0    # 1.0 = off
    greedy: bool = False


def filter_logits(logits: torch.Tensor,
                  params: SamplingParams) -> torch.Tensor:
    """Temperature-scaled logits with the ids top-k / top-p drop set to
    -inf. logits: [B, V] f32."""
    logits = logits / max(params.temperature, 1e-6)
    if params.top_k and params.top_k > 0:
        k = min(params.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = (cum < params.top_p).sum(-1, keepdim=True).clamp_max(
            logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_logits(logits: torch.Tensor, params: SamplingParams,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """logits: [B, V] f32 -> [B] int64 token ids. ``generator`` (on the
    logits' device) drives the draw; greedy ignores it."""
    if params.greedy:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, params), dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)
