"""Continuous-batching serving engine (iteration-level scheduling).

The port of ``musicgeneration_tpu/decode/serving.py``:

* A fixed pool of B **slots** shares one KV cache ``[L, B, S, d]`` and
  one clock ``t`` (the next cache row every slot writes). Requests are
  admitted into free slots, decode together and retire independently.
* Slots are **right-aligned**: a request of p prompt tokens admitted at
  clock ``t`` has its prompt K/V in rows ``[t-p+1, t]`` and attends only
  rows ``s >= start[b]``: kernel B's ragged mode. The relative bias
  depends only on ``t - s`` and the positional row is gathered per row
  at ``t - start[b]``, so every slot runs the program a dedicated
  single-request decode runs.
* Decode runs in **segments** of ``seg_len`` steps between host reads:
  a Python loop of ``decode_step`` + sampling whose tokens stay on the
  device. ``t`` and the live-window floor ``start_min = min(start)`` are
  host ints from the scheduler's exact mirror of ``start`` (kernel B's
  grid depends on them), so no step reads the device.
* **Roll-compaction** keeps the clock inside the cache: when
  ``t + seg_len`` would overrun it, every row window shifts left by
  ``min(start)`` (one roll of the cache) and the clock drops by the same
  amount; shifting every row by one amount changes neither distances
  nor ``t - start``.

Admission is one grouped prefill through kernel A per prompt bucket,
scattered into each slot's row window. Prompts longer than the clock
wait; an idle pool jumps the clock to fit the longest queued prompt.
Sliding-window requests re-prime their slot from their last ``window``
tokens, ``generate_sliding``'s context evolution inside the pool.
Host-side scheduling lives in ``SlotScheduler`` (decode/scheduling.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .engine import align_cache_len
from .sampling import (SamplingParams, sample_logits, sample_logits_batched,
                       unpack_sampling)
from .scheduling import _BLOCKED, SlotScheduler, to_device

__all__ = ["ContinuousBatcher"]


class ContinuousBatcher(SlotScheduler):
    """Continuous-batching decode over a fixed slot pool.

    >>> cb = ContinuousBatcher(model, slots=8)
    >>> rid = cb.submit(prompt_ids, max_new=256)
    >>> outs = cb.run()          # {rid: np.ndarray of generated ids}

    ``submit`` may be called at any time (between ``step`` calls too);
    ``run`` drains the queue. Greedy serving gives each request the
    tokens of its dedicated ``generate`` run (up to floating-point ties:
    the pool's batch width differs).

    With ``per_row_sampling=True`` each ``submit`` may carry its own
    ``SamplingParams``; ``sampling`` stays the default. ``generator``: a
    ``torch.Generator`` on the model's device for the draws (greedy
    ignores it). ``boost`` > 1 fuses up to that many segments into one
    dispatch while no admission or eos retirement could be delayed.
    """

    def __init__(self, model, *, slots: int = 8,
                 sampling: SamplingParams = SamplingParams(),
                 seg_len: int = 32, cache_len: Optional[int] = None,
                 prompt_bucket: int = 64, depth: int = 4,
                 min_slots: int = 8, per_row_sampling: bool = False,
                 boost: int = 1, on_finalize: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            slots=slots, sampling=sampling, seg_len=seg_len,
            prompt_bucket=prompt_bucket, depth=depth, min_slots=min_slots,
            per_row_sampling=per_row_sampling, on_finalize=on_finalize,
            generator=generator, pad_id=getattr(model, "pad_id", 0),
            boost=boost)
        self.model = model
        self.device = model.device
        self._next_seg = seg_len
        self.cache_len = align_cache_len(
            model, min(cache_len or model.max_seq, model.max_seq))
        if self.cache_len <= seg_len:
            raise ValueError(f"cache_len {self.cache_len} must exceed "
                             f"seg_len {seg_len}")
        if boost > 1 and boost * seg_len >= self.cache_len:
            raise ValueError(
                f"boost*seg_len ({boost * seg_len}) must fit under "
                f"cache_len ({self.cache_len}) or boost can never "
                "engage — lower boost/seg_len or raise cache_len")
        self.cache = model.init_cache(slots, self.cache_len)
        self.stacked = model.decode_weights()   # once per engine
        self.t = 0                      # the clock (host int)
        # exact host mirror of `start`: admissions, compactions, parking
        # and resizes are all host-decided, and every segment ships it
        # whole, so scheduling never reads the device
        self._start_host = np.zeros((slots,), np.int64)
        self.tok = torch.zeros(slots, dtype=torch.long, device=self.device)
        self._n_compactions = 0
        # sliding-window requests: rid -> admitted context prompt (the
        # re-prime rebuilds each window from prompt + emitted tokens)
        self._sliding_prompts: Dict[int, np.ndarray] = {}
        self._n_reprimes = 0

    def stats(self) -> Dict[str, float]:
        st = super().stats()
        st["compactions"] = self._n_compactions
        st["reprimes"] = self._n_reprimes
        return st

    # --------------------------------------------------- scheduler hooks

    def _validate_request(self, prompt, max_new, eos_id, kw) -> dict:
        window = kw.pop("window", None)
        if kw:
            raise TypeError(f"unexpected submit() arguments: {sorted(kw)}")
        limit = min(self.cache_len, self.model.max_seq)
        if window is not None:
            # sliding request: unbounded max_new. The context re-primes
            # from the last `window` tokens whenever it would exceed
            # 2*window, and the prompt is trimmed to its last `window`
            # tokens, generate_sliding's seed context.
            window = int(window)
            if window < self.seg_len:
                raise ValueError(
                    f"window ({window}) must be >= seg_len "
                    f"({self.seg_len}) — a re-prime must free at least "
                    "one segment of room")
            if 2 * window + self.seg_len > limit:
                raise ValueError(
                    f"2 * window ({window}) + seg_len ({self.seg_len}) "
                    f"exceeds the serve window ({limit}); shrink the "
                    "window or raise cache_len")
            return {"window": window, "_prompt": prompt[-window:]}
        # span a slot occupies before reuse: count-retired requests free
        # their slot at dispatch, past max_new by less than a segment;
        # eos requests stay until the pipelined host sees the tokens, up
        # to depth+1 segments later
        lag = 1 if eos_id is None else self.depth + 1
        cap = prompt.shape[0] + max_new + lag * self.seg_len
        if cap > limit:
            raise ValueError(
                f"prompt ({prompt.shape[0]}) + max_new ({max_new}) + "
                f"{lag} * seg_len ({self.seg_len}) exceeds the serve "
                f"window ({limit}); shorten the request, raise cache_len, "
                "or pass window= for sliding-context decoding")
        return {}

    def _bucket(self, p: int) -> int:
        # admission writes rows [t-p+1, t-p+1+Pb): a bucket wider than
        # the cache could never be placed
        return min(super()._bucket(p), self.cache_len)

    def _park_slot(self, i: int) -> None:
        # a free slot attends only [t, t]: parked at the clock, it never
        # drags the live-window floor min(start) down
        self._start_host[i] = self.t

    def _gather_state(self, idx) -> None:
        dev_idx = to_device(np.asarray(idx, np.int64), self.device)
        self.cache = {k: v.index_select(1, dev_idx)
                      for k, v in self.cache.items()}
        self.tok = self.tok.index_select(0, dev_idx)
        self._start_host = self._start_host[idx].copy()

    def _pre_segment(self):
        if self._maybe_reprime() is _BLOCKED:
            return _BLOCKED
        seg = self._boosted_seg()
        if seg > self.seg_len and any(
                s.active and s.window for s in self.slots):
            seg = self.seg_len   # re-prime points are planned per segment
        self._maybe_compact(seg)
        if self.t + seg > self.cache_len and seg > self.seg_len:
            seg = self.seg_len   # no room for the boosted dispatch
        if self.t + seg > self.cache_len:
            return _BLOCKED
        self._next_seg = seg
        return None

    def _finalize(self, rid: int):
        self._sliding_prompts.pop(rid, None)
        super()._finalize(rid)

    # ------------------------------------------------------- internals

    def _maybe_reprime(self):
        """Sliding-window re-prime: an active slot whose context would
        exceed ``2 * window`` after the next segment has its window
        rebuilt — the last ``window`` tokens of (prompt + emitted) are
        admitted again into the same slot, start jumps to
        ``t - window + 1``, and decoding goes on: ``generate_sliding``'s
        context evolution (seed prompt[-w:], re-prime at 2w with the last
        w), so greedy tokens match the dedicated sliding run when the
        re-prime points fall on segment boundaries.

        Returns _BLOCKED when a re-prime is due but the slot's tokens are
        still in flight (the run loop collects a segment and retries)."""
        need = [(i, s) for i, s in enumerate(self.slots)
                if s.active and s.window
                and (self.t - self._start_host[i] + 1 + self.seg_len
                     > 2 * s.window)]
        if not need:
            return None
        for _, s in need:
            if len(self._emitted[s.rid]) < s.scheduled:
                return _BLOCKED      # window text still in flight
        if self.t + 1 > self.cache_len:
            # the re-prime writes row t itself; a sliding slot never pins
            # min(start) below seg_len + 1 (2w + seg <= cache_len), so
            # compaction always frees room
            self._maybe_compact(1)
            if self.t + 1 > self.cache_len:
                return _BLOCKED
        groups: Dict[int, list] = {}          # window -> [(ctx, slot)]
        for i, s in need:
            w = s.window
            prompt = self._sliding_prompts[s.rid]
            em = np.asarray(self._emitted[s.rid], np.int32)
            ctx = np.concatenate([prompt, em])[-w:]
            self._start_host[i] = self.t - (w - 1)
            groups.setdefault(w, []).append((ctx, i))
        for w, grp in groups.items():
            self._admit_group(w, [c for c, _ in grp], [w] * len(grp),
                              [i for _, i in grp])
            self._n_reprimes += len(grp)
        return None

    def _maybe_compact(self, need_rows: int,
                       extra_starts: Optional[List[int]] = None):
        """Keep the next ``need_rows`` clock ticks inside the cache.

        ``extra_starts``: starts of requests grouped for admission in the
        current ``_try_admit`` pass but not yet active; they cap the
        shift like active slots (a compaction triggered by a later
        pending request must not drop the clock below an earlier-grouped
        request's start). Shifted in place to track the clock."""
        if self.t + need_rows <= self.cache_len:
            return
        act = [int(self._start_host[i]) for i, s in
               enumerate(self.slots) if s.active]
        act += list(extra_starts or ())
        shift = min(act) if act else self.t
        if act and shift > 0:
            # rows wrapped to the end are past the new clock for every
            # slot and are overwritten before anything attends them
            self.cache = {k: torch.roll(v, -shift, dims=2)
                          for k, v in self.cache.items()}
            self._start_host -= shift
            self._n_compactions += 1
            if extra_starts:
                for k in range(len(extra_starts)):
                    extra_starts[k] -= shift
        self.t -= shift
        # free slots park at the new clock: a slot parked before a
        # sliding re-prime moved an active start past it would otherwise
        # shift below row 0
        self._start_host[self._free_slots()] = self.t

    def _segment(self) -> torch.Tensor:
        """Launch one segment (``_pre_segment``'s step count, consumed
        here) and advance the clock. Returns its [seg, B] tokens on the
        device."""
        seg = self._next_seg
        self._next_seg = self.seg_len
        self._last_seg = seg
        start = to_device(self._start_host.astype(np.int32), self.device)
        smin = int(self._start_host.min())
        samp = (unpack_sampling(to_device(self._samp_host, self.device))
                if self.per_row else None)
        toks = torch.empty(seg, self.b, dtype=torch.long, device=self.device)
        tok = self.tok
        for i in range(seg):
            logits, self.cache = self.model.decode_step(
                tok, self.cache, self.t + i, self.stacked, start=start,
                start_min=smin)
            tok = (sample_logits_batched(logits, samp, self.generator)
                   if self.per_row
                   else sample_logits(logits, self.sp, self.generator))
            toks[i] = tok
        self.tok = tok
        self.t += seg
        return toks

    def _try_admit(self):
        """Move pending requests into free slots (FIFO, skipping those
        whose prompt does not fit under the clock yet). One grouped
        admission per prompt bucket present."""
        free = self._free_slots()
        if not free or not self.pending:
            return
        if len(free) == self.b:
            # idle pool: jump the clock to fit the longest queued prompt
            need = max(q.prompt.shape[0] - 1 for q in self.pending)
            self.t = max(self.t, need)
            self._start_host[:] = self.t
        groups: Dict[int, list] = {}          # pb -> [(q, slot)]
        remaining = []
        grouped_starts: list = []   # caps _maybe_compact's shift so a
        for q in self.pending:      # later compaction cannot orphan an
            p = q.prompt.shape[0]   # earlier-grouped request
            if not free:
                remaining.append(q)
                continue
            # rows the admission touches: [t-p+1, t-p+1+Pb)
            self._maybe_compact(max(self.seg_len, q.pb - p + 1),
                                grouped_starts)
            if p - 1 > self.t or self.t - (p - 1) + q.pb > self.cache_len:
                remaining.append(q)   # wait for the clock to advance
                continue
            groups.setdefault(q.pb, []).append((q, free.pop(0)))
            grouped_starts.append(self.t - (p - 1))
        if groups:
            # every still-free slot parks at the clock, so min(start)
            # tracks the true live window
            self._start_host[free] = self.t
            for grp in groups.values():
                for q, slot in grp:
                    self._start_host[slot] = self.t - (q.prompt.shape[0] - 1)
                    self._admit_bookkeeping(q, slot)
                    w = (q.extra or {}).get("window", 0)
                    self.slots[slot].window = w
                    if w:
                        self._sliding_prompts[q.rid] = q.prompt
        for pb, grp in groups.items():
            self._admit_group(pb, [q.padded for q, _ in grp],
                              [q.prompt.shape[0] for q, _ in grp],
                              [slot for _, slot in grp])
            self._n_admitted += len(grp)
        self.pending = remaining

    def _admit_group(self, pb: int, rows, ps, slots_idx):
        """One prefill over the group's [G, Pb] prompts (kernel A), its
        K/V scattered into rows [t-p+1, t-p+1+Pb) of each slot: the
        prompt's last token lands at row t, and the rows past it hold
        pad keys that decode steps overwrite before anything attends
        them. The prompt's last token becomes the slot's next input
        (decoded at row t)."""
        prompts = to_device(np.asarray(rows, np.int64), self.device)
        _, pre = self.model.prefill(prompts, pb)
        for j, (p, slot) in enumerate(zip(ps, slots_idx)):
            r0 = self.t - (p - 1)
            for key in ("k", "v"):
                self.cache[key][:, slot, r0:r0 + pb] = pre[key][:, j]
        last = np.asarray([row[p - 1] for row, p in zip(rows, ps)], np.int64)
        idx = to_device(np.asarray(slots_idx, np.int64), self.device)
        self.tok.index_copy_(0, idx, to_device(last, self.device))
        self._n_admit_calls += 1
