"""Sampling transforms: temperature / top-k / top-p / greedy.

The port of ``musicgeneration_tpu/decode/sampling.py`` with the same set
semantics: top-k keeps every id whose logit is not below the k-th
largest (ties kept), top-p runs after top-k and keeps the smallest
sorted prefix whose cumulative probability reaches p, the temperature is
floored at 1e-6. ``sample_logits`` takes one ``SamplingParams`` for the
batch; ``sample_logits_batched`` takes per-row params (the serving
engine's per-request sampling) as device tensors. The categorical draw
takes an explicit ``torch.Generator`` (a different stream than
``jax.random``); every op stays on the logits' device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
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


def pack_sampling(params: SamplingParams) -> tuple:
    """(temp_bits, top_k, top_p_bits, greedy) as int32 values, the floats
    bitcast, so one int32 row carries a request's params."""
    return (int(np.float32(params.temperature).view(np.int32)),
            int(params.top_k),
            int(np.float32(params.top_p).view(np.int32)),
            int(params.greedy))


def unpack_sampling(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inverse of ``pack_sampling`` on the device: [B, 4] int32 rows ->
    the per-row params ``sample_logits_batched`` takes."""
    return {"temperature": packed[:, 0].contiguous().view(torch.float32),
            "top_k": packed[:, 1].long(),
            "top_p": packed[:, 2].contiguous().view(torch.float32),
            "greedy": packed[:, 3] != 0}


def filter_logits_batched(logits: torch.Tensor,
                          samp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-row ``filter_logits``: each row under its own temperature,
    top-k (<= 0 off) and top-p (1.0 off). One descending sort serves
    both filters: top-k thresholds at the row's k-th value, and top-p
    runs on the sorted copy masked by that same threshold (the mask is
    by value, so the order holds), i.e. after top-k as in
    ``filter_logits``."""
    logits = logits / samp["temperature"].clamp_min(1e-6)[:, None]
    v = logits.shape[-1]
    srt = torch.sort(logits, dim=-1, descending=True).values
    k = samp["top_k"].clamp(0, v)
    kth = torch.gather(srt, -1, (k - 1).clamp_min(0)[:, None])
    on_k = (k > 0)[:, None]
    logits = logits.masked_fill(on_k & (logits < kth), float("-inf"))
    srt = srt.masked_fill(on_k & (srt < kth), float("-inf"))
    cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
    top_p = samp["top_p"][:, None]
    cutoff_idx = (cum < top_p).sum(-1, keepdim=True).clamp_max(v - 1)
    cutoff = torch.gather(srt, -1, cutoff_idx)
    return logits.masked_fill((top_p < 1.0) & (logits < cutoff),
                              float("-inf"))


def sample_logits_batched(logits: torch.Tensor,
                          samp: Dict[str, torch.Tensor],
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Per-row sampling: logits [B, V] f32 and ``unpack_sampling`` params
    -> [B] int64 ids. Greedy rows take the argmax of the raw logits; the
    others draw from their filtered distribution with ``generator``.
    A pool whose rows share one params set keeps ``sample_logits``'s
    sets and, from the same generator state, its draws."""
    probs = torch.softmax(filter_logits_batched(logits, samp), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator).squeeze(-1)
    return torch.where(samp["greedy"], torch.argmax(logits, dim=-1), sampled)
