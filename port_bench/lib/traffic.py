"""The one traffic generator: every cell's mix is data (its workload
file's ``traffic``), read here.

Sizes are stratified: n values at the quantiles (i + 0.5) / n of the
named distribution, put in an order drawn from the seed. So every seed
gives the same multiset of prompt lengths, ``max_new`` and arrival gaps,
and the work of a run does not change with its seed; the seed changes
the order, the token ids, which requests are greedy, and the controls.

Distributions: ``{"dist": "uniform", "lo": a, "hi": b}`` (integers a..b),
``{"dist": "loguniform", "lo": a, "hi": b}`` and ``{"dist":
"exponential", "mean": m}``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List

import numpy as np


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator that is a pure function of (seed, tags)."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & ((1 << 64) - 1)] + [int(t) for t in tags]))


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """The n stratified values of ``dist``, in quantile order."""
    q = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = int(dist["lo"]), int(dist["hi"])
        return np.floor(lo + q * (hi - lo + 1)).astype(np.int64)
    if kind == "loguniform":
        lo, hi = float(dist["lo"]), float(dist["hi"])
        v = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
        return np.clip(np.rint(v), lo, hi).astype(np.int64)
    if kind == "exponential":
        return -np.log1p(-q) * float(dist["mean"])
    raise ValueError(f"unknown distribution {kind!r}")


def stratified(dist: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``quantiles(dist, n)`` in an order drawn from ``rng``."""
    return quantiles(dist, n)[rng.permutation(n)]


def request_block(traffic: Dict, n: int, rng: np.random.Generator
                  ) -> List[Dict]:
    """n requests of the mix: prompt length, ``max_new`` and whether the
    request is greedy (exactly round(n * greedy_share) of them are)."""
    plen = stratified(traffic["prompt_len"], n, rng)
    new = stratified(traffic["max_new"], n, rng)
    greedy = np.zeros(n, bool)
    greedy[rng.permutation(n)[:int(round(n * traffic.get("greedy_share",
                                                          0.0)))]] = True
    return [{"prompt_len": int(p), "max_new": int(m), "greedy": bool(g)}
            for p, m, g in zip(plen, new, greedy)]


def open_loop(traffic: Dict, seed: int, seconds: float,
              rate: float = None) -> List[Dict]:
    """The requests due in a window of ``seconds`` at ``rate`` requests/s
    (default: the mix's ``rate_per_s``), each with its ``due`` offset in
    seconds from the window's start: round(rate * seconds) requests
    whose gaps are the stratified exponential quantiles of mean 1 /
    rate."""
    rate = float(rate if rate is not None else traffic["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    rng = rng_for(seed, 1)
    gaps = stratified({"dist": "exponential", "mean": 1.0 / rate}, n, rng)
    due = np.cumsum(gaps) - gaps[0]
    reqs = request_block(traffic, n, rng)
    for r, d in zip(reqs, due):
        r["due"] = float(d)
    return reqs


def backlog(traffic: Dict, seed: int) -> Iterator[Dict]:
    """An endless stream of requests, in blocks of ``block`` (each block
    the same stratified multiset, in its own order)."""
    block = int(traffic.get("block", 1024))
    for b in range(1 << 30):
        yield from request_block(traffic, block, rng_for(seed, 2, b))


def tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """n token ids uniform in [0, vocab)."""
    return rng.integers(0, vocab, n).astype(np.int64)
