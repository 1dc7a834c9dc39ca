"""The comparisons of served tokens that decide a serving cell's
``correct``, and the statistics of its end-to-end metrics."""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np
import torch

from . import traffic


def p95(values: Sequence[float]) -> float:
    """The nearest-rank 95th percentile (a failed request counts as
    infinitely late)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def sample_with_longest(keys: List, size: Callable, k: int, seed: int
                        ) -> List:
    """k of ``keys`` drawn from the seed, the one of largest ``size``
    first among them."""
    if not keys:
        return []
    keys = sorted(keys)
    longest = max(keys, key=size)
    rest = [x for x in keys if x != longest]
    pick = traffic.rng_for(seed, 8).permutation(len(rest))[:max(0, k - 1)]
    return [longest] + [rest[j] for j in pick]


def served_gap(ref_logits: List[torch.Tensor], seqs, plens,
               pick_from: List[torch.Tensor] = None) -> float:
    """The widest gap, over the served positions, between the
    reference's best logit and the reference logit of the token taken
    there: the served token, or the argmax of ``pick_from`` (the
    control's logits at the same positions). ``ref_logits[j]`` row i
    follows token i of ``seqs[j]``; the served tokens start at
    ``plens[j]``."""
    worst = 0.0
    for j, (lg, s, p) in enumerate(zip(ref_logits, seqs, plens)):
        rows = lg[p - 1:]
        if pick_from is None:
            taken = torch.as_tensor(np.asarray(s[p:]), device=rows.device)
        else:
            taken = pick_from[j][p - 1:].argmax(-1)
        best = rows.max(-1).values
        gap = best - rows.gather(-1, taken[:, None].long())[:, 0]
        worst = max(worst, float(gap.max()))
    return worst
