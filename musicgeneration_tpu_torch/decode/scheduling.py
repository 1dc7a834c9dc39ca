"""Slot-pool scheduler of the continuous-batching engine.

The port of ``musicgeneration_tpu/decode/scheduling.py``: a fixed pool
of B slots, FIFO admission into free slots, decode in segments,
retirement by count at dispatch for requests without eos and by
inspecting tokens for eos requests, pipelined dispatch, drain-tail pool
shrinking, cancellation, streaming delivery through ``on_finalize``, and
per-request latency accounting. This base class owns all of that; the
engine (``decode/serving.py``) owns the device state and the programs
that touch it (admission, segment, resize-gather).

Host and device meet twice per segment. Dispatch ships the small
per-segment vectors to the device with non-blocking copies from pinned
memory; each segment's ``[seg, B]`` tokens come back by a non-blocking
copy into pinned memory behind a CUDA event that ``_collect`` waits on,
so the host never waits on the device per step.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .sampling import SamplingParams, pack_sampling

# _dispatch result: device state full until an in-flight retirement
# lands (the cache clock would overrun)
_BLOCKED = object()


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host sync: a non-blocking copy
    from pinned memory (the pinned block is not reused before the copy
    ran) for CUDA, a copy for the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


class _Fetch:
    """A dispatched segment's tokens on their way to the host: a
    non-blocking copy into pinned memory and a CUDA event behind it (on
    the CPU, the tensor itself)."""

    def __init__(self, toks: torch.Tensor):
        self._event = None
        if toks.device.type == "cuda":
            self._host = torch.empty(toks.shape, dtype=toks.dtype,
                                     pin_memory=True)
            self._host.copy_(toks, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = toks

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass
class _Slot:
    rid: int = -1
    active: bool = False
    max_new: int = 0
    eos_id: Optional[int] = None
    scheduled: int = 0            # slot-steps dispatched for this rid
    window: int = 0               # sliding context width (0 = bounded)


@dataclasses.dataclass
class _Pending:
    rid: int
    prompt: np.ndarray
    max_new: int
    eos_id: Optional[int]
    padded: np.ndarray = None     # [Pb] host copy at the bucket width
    pb: int = 0                   # its bucket width
    samp: tuple = None            # pack_sampling() ints (per-row mode)
    extra: dict = None            # engine-specific payload (window)


class SlotScheduler:
    """Host-side continuous-batching scheduler over a fixed slot pool.

    The engine implements ``_try_admit()`` (move pending requests into
    free slots, calling ``_admit_bookkeeping``), ``_segment()`` (launch
    one segment of decode steps, return its ``[seg, B]`` device tokens)
    and ``_gather_state(idx)`` (re-pool device state to slot order
    ``idx``), and may override ``_pre_segment`` (room check before a
    dispatch; ``_BLOCKED`` defers), ``_park_slot(i)`` (a slot freed by
    retirement or cancel, or a duplicate row created by pool growth) and
    ``_validate_request``.
    """

    def __init__(self, *, slots: int, sampling: SamplingParams,
                 seg_len: int, prompt_bucket: int, depth: int,
                 min_slots: int, per_row_sampling: bool,
                 on_finalize: Optional[Callable],
                 generator: Optional[torch.Generator], pad_id: int,
                 boost: int = 1):
        if boost < 1:
            raise ValueError(f"boost must be >= 1, got {boost}")
        self.b = slots
        # drain-tail pool shrinking: with the queue empty the pool halves
        # (down to min_slots) once the active requests fit — the step's
        # cost grows with B. min_slots >= slots disables resizing.
        self._full_b = slots
        self._min_b = min(min_slots, slots)
        self.sp = sampling
        self.seg_len = seg_len
        self._last_seg = seg_len      # steps of the segment in flight
        self.boost = boost            # segments fused into one dispatch
        self.prompt_bucket = prompt_bucket
        # segments in flight before the host waits for tokens. Count-
        # retired requests (no eos) schedule without reading the device;
        # depth bounds run-ahead and, for eos requests only, the
        # retirement lag (up to depth*seg_len idle steps past the eos).
        # depth=1 is synchronous.
        self.depth = depth
        self.generator = generator
        # per-row sampling: each slot decodes under its own request's
        # params (packed int32 rows, floats bitcast), chosen once at
        # construction
        self.per_row = per_row_sampling
        self._samp_host = np.tile(
            np.asarray(pack_sampling(sampling), np.int32), (slots, 1))
        self.slots = [_Slot() for _ in range(slots)]
        self.pending: List[_Pending] = []
        self.done: Dict[int, np.ndarray] = {}
        self._emitted: Dict[int, List[int]] = {}   # rid -> tokens so far
        self._req: Dict[int, tuple] = {}           # rid -> (max_new, eos)
        # streaming delivery: called (rid, tokens) the moment a request
        # finalizes, on the scheduling thread between dispatches (the
        # warm() probe's finalize is suppressed)
        self.on_finalize = on_finalize
        self._warming = False
        # per-request wall clock: rid -> {submit, admit, done} seconds
        # (perf_counter); done - submit is the e2e latency a client
        # sees, admit - submit the queue wait. Samples and per-rid
        # entries are bounded for a long-running server.
        self.times: Dict[int, Dict[str, float]] = {}
        self._lat = deque(maxlen=4096)     # (e2e, wait|None) samples
        self._n_finalized = 0              # lifetime finalize counter
        self._fin_rids = deque()           # finalized rids, prune order
        self._times_cap = 8192
        self._next_rid = 0
        self._pad_id = pad_id
        # cumulative scheduler counters (stats())
        self._n_segments = 0
        self._n_steps = 0
        self._n_slot_steps = 0
        self._n_active_slot_steps = 0
        self._n_admit_calls = 0
        self._n_admitted = 0
        self._n_committed = 0

    # ------------------------------------------------------------ hooks

    def _canon_prompt(self, prompt) -> np.ndarray:
        """The prompt as the engine takes it, axis 0 the step axis: flat
        int32 ids (the CP engine takes [P, 8] rows)."""
        return np.asarray(prompt, np.int32).reshape(-1)

    def _warm_prompt(self, n: int) -> np.ndarray:
        """The ``warm()`` probe's prompt of n steps."""
        return np.ones(n, np.int32)

    def _empty_result(self) -> np.ndarray:
        """A result of no steps in the engine's shape (the CP engine's is
        [0, 8])."""
        return np.zeros((0,), np.int32)

    def _eos_index(self, toks, eos_id) -> Optional[int]:
        """Index of the first eos in emitted steps, or None (the CP
        engine matches the FAMILY column of its rows)."""
        for j, x in enumerate(toks):
            if x == eos_id:
                return j
        return None

    def _validate_request(self, prompt: np.ndarray, max_new: int,
                          eos_id: Optional[int], kw: dict) -> dict:
        """Engine-specific submit validation. Returns the extra payload
        stored on the pending entry; must consume or reject every kwarg."""
        if kw:
            raise TypeError(f"unexpected submit() arguments: {sorted(kw)}")
        return {}

    def _park_slot(self, i: int) -> None:
        """Slot i became free (retirement, cancel, or a duplicate row
        created by pool growth)."""

    def _pre_segment(self):
        """Room check before a dispatch. Return ``_BLOCKED`` to defer
        until an in-flight segment is collected."""
        return None

    def _boosted_seg(self) -> int:
        """The step count to dispatch: ``boost*seg_len`` when the queue
        is empty and every active slot is eos-free with at least that
        many steps left (a longer dispatch must never delay admission or
        eos retirement), else ``seg_len``."""
        if self.boost <= 1 or self.pending:
            return self.seg_len
        big = self.boost * self.seg_len
        any_active = False
        for s in self.slots:
            if s.active:
                any_active = True
                if s.eos_id is not None or s.max_new - s.scheduled < big:
                    return self.seg_len
        return big if any_active else self.seg_len

    def _try_admit(self) -> None:
        raise NotImplementedError

    def _segment(self) -> torch.Tensor:
        raise NotImplementedError

    def _gather_state(self, idx: List[int]) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------ stats

    def stats(self) -> Dict[str, float]:
        """Cumulative counters: segments and decode steps dispatched,
        slot-step occupancy (active slot-steps / dispatched slot-steps),
        committed tokens (delivered, post-trim), admission calls and
        requests. Never reset; diff across calls for rates."""
        dispatched = self._n_slot_steps
        return {
            "segments": self._n_segments,
            "steps": self._n_steps,
            "slot_steps": dispatched,
            "active_slot_steps": self._n_active_slot_steps,
            "occupancy": (self._n_active_slot_steps / dispatched
                          if dispatched else 0.0),
            "committed_tokens": self._n_committed,
            "admit_calls": self._n_admit_calls,
            "admitted": self._n_admitted,
        }

    def latency_summary(self) -> Dict[str, float]:
        """e2e (submit -> host commit) and queue wait (submit -> prefill
        dispatch) p50/p95 in seconds over the latest finalized requests
        (a 4096-sample window). e2e includes the pipeline lag: it is what
        a caller observes, not device decode time."""
        e2e = sorted(s[0] for s in self._lat)
        wait = sorted(s[1] for s in self._lat if s[1] is not None)
        if not e2e:
            return {"n": 0, "n_finalized": self._n_finalized}

        def q(xs, f):
            return xs[min(len(xs) - 1, int(f * len(xs)))]

        # wait is empty when every request was cancelled while queued
        return {"n": len(e2e), "n_finalized": self._n_finalized,
                "e2e_p50": q(e2e, 0.5), "e2e_p95": q(e2e, 0.95),
                "wait_p50": q(wait, 0.5) if wait else 0.0,
                "wait_p95": q(wait, 0.95) if wait else 0.0}

    # ------------------------------------------------------------ warm

    def warm(self, prompt_len: int = 1, max_new: Optional[int] = None):
        """Run one throwaway request (one admission, one segment) before
        real traffic, so the kernels are built and loaded and the
        allocator holds its blocks before the first request's clock
        starts. Nothing here compiles per width or per shape, so one
        probe covers every later width."""
        if self.pending or any(s.active for s in self.slots):
            raise RuntimeError(
                "warm() must run before real traffic: the pool has "
                "pending or active requests whose results the warm "
                "drain would discard")
        self._warming = True
        rid = None
        try:
            rid = self.submit(self._warm_prompt(max(1, prompt_len)),
                              max_new or self.seg_len)
            self.run()
        finally:
            self._warming = False
            self.times.pop(rid, None)

    # ---------------------------------------------------------- submit

    def submit(self, prompt, max_new: int,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None, **kw) -> int:
        prompt = self._canon_prompt(prompt)
        if prompt.shape[0] == 0:
            raise ValueError("empty prompt")
        if sampling is not None and not self.per_row:
            raise ValueError(
                "per-request sampling needs per_row_sampling=True — the "
                "flag picks the per-row segment program at construction")
        extra = self._validate_request(prompt, max_new, eos_id, kw)
        # the engine may substitute the admitted context (the sliding
        # window keeps the last `window` tokens)
        prompt = extra.pop("_prompt", prompt)
        rid = self._next_rid
        self._next_rid += 1
        pb = self._bucket(prompt.shape[0])
        pad = np.full((pb,) + prompt.shape[1:], self._pad_id, np.int32)
        pad[:prompt.shape[0]] = prompt
        self.pending.append(_Pending(
            rid, prompt, max_new, eos_id, padded=pad, pb=pb,
            samp=pack_sampling(sampling or self.sp), extra=extra))
        self.times[rid] = {"submit": time.perf_counter()}
        return rid

    # ---------------------------------------------------------- cancel

    def cancel(self, rid: int) -> bool:
        """Cancel a request. A queued one is dropped (empty result); an
        active one frees its slot at once and delivers the tokens
        collected so far through ``done`` (trimmed as a normal
        finalize). Returns False for unknown or finished rids. Pure host
        bookkeeping: no extra dispatch."""
        for q in self.pending:
            if q.rid == rid:
                self.pending.remove(q)
                self.done[rid] = self._empty_result()
                self.times[rid]["done"] = time.perf_counter()
                self._record_latency(rid)
                if self.on_finalize is not None and not self._warming:
                    self.on_finalize(rid, self.done[rid])
                return True
        for i, s in enumerate(self.slots):
            if s.active and s.rid == rid:
                s.rid, s.active = -1, False
                self._park_slot(i)
                # in-flight segments may still hold its tokens; _collect
                # skips rids no longer in _req
                self._finalize(rid)
                return True
        return False

    # ------------------------------------------------------- internals

    def _record_latency(self, rid: int) -> None:
        """Push the finalized request's latency sample and prune the
        oldest per-rid entries past the cap (warm probes excluded)."""
        if self._warming:
            return
        t = self.times.get(rid)
        if t is None or "done" not in t:
            return
        self._n_finalized += 1
        wait = (t["admit"] - t["submit"]) if "admit" in t else None
        self._lat.append((t["done"] - t["submit"], wait))
        self._fin_rids.append(rid)
        while len(self._fin_rids) > self._times_cap:
            self.times.pop(self._fin_rids.popleft(), None)

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    def _bucket(self, p: int) -> int:
        b = self.prompt_bucket
        return max(b, -(-p // b) * b)

    def _admit_bookkeeping(self, q: _Pending, slot: int) -> None:
        """Per-request host bookkeeping at admission."""
        self._samp_host[slot] = q.samp
        s = self.slots[slot]
        s.rid, s.active, s.max_new = q.rid, True, q.max_new
        s.eos_id, s.scheduled = q.eos_id, 0
        self._emitted[q.rid] = []
        self._req[q.rid] = (q.max_new, q.eos_id)
        self.times[q.rid]["admit"] = time.perf_counter()

    def _resize(self, width: int):
        """Re-pool to ``width`` slots: one gather along the batch axis
        (active slots first; growth pads by duplicating row 0, and the
        duplicates become free slots)."""
        order = [i for i, s in enumerate(self.slots) if s.active]
        order += [i for i, s in enumerate(self.slots) if not s.active]
        idx = order[:width]
        idx = idx + [order[0]] * max(0, width - len(idx))
        self._gather_state(idx)
        self._samp_host = self._samp_host[idx].copy()
        new_slots, seen = [], set()
        for pos, i in enumerate(idx):
            s = self.slots[i]
            if i in seen or not s.active:
                new_slots.append(_Slot())
                if i in seen:                 # growth duplicate: park
                    self._park_slot(pos)
            else:
                new_slots.append(s)
                seen.add(i)
        self.slots = new_slots
        self.b = width

    def _maybe_resize(self):
        """Shrink in the drain tail (no pending, actives fit in half the
        pool); grow back to full width as soon as work queues."""
        if self.pending:
            if self.b < self._full_b:
                self._resize(self._full_b)
            return
        n_act = sum(s.active for s in self.slots)
        if n_act == 0:
            return
        width = self.b
        while width // 2 >= self._min_b and n_act <= width // 2:
            width //= 2
        if width < self.b:
            self._resize(width)

    def _assemble_result(self, toks: List, max_new: int,
                         eos_id) -> np.ndarray:
        """Emitted tokens -> the request's result: trimmed to max_new and
        cut at the first eos."""
        toks = toks[:max_new]
        if eos_id is not None:
            cut = self._eos_index(toks, eos_id)
            if cut is not None:
                toks = toks[:cut]
        return (np.asarray(toks, np.int32) if toks
                else self._empty_result())

    def _finalize(self, rid: int):
        max_new, eos_id = self._req.pop(rid)
        self.done[rid] = self._assemble_result(
            self._emitted.pop(rid), max_new, eos_id)
        self._n_committed += len(self.done[rid])
        self.times[rid]["done"] = time.perf_counter()
        self._record_latency(rid)
        if self.on_finalize is not None and not self._warming:
            self.on_finalize(rid, self.done[rid])

    # ------------------------------------------------------------ step

    def _dispatch(self):
        """Admit pending requests, then launch one segment WITHOUT
        waiting for its tokens. Returns (token fetch, occupancy [(slot,
        rid)]), None if nothing is active, or _BLOCKED if the engine has
        no room for another segment until an in-flight retirement is
        collected.

        Requests without an eos_id retire BY COUNT here, at dispatch: the
        host knows a slot has covered max_new after ceil(max_new/seg_len)
        segments without reading a token, so the slot frees for the next
        admission at once. Only eos requests wait for _collect."""
        self._maybe_resize()
        self._try_admit()
        if not any(s.active for s in self.slots):
            return None
        if self._pre_segment() is _BLOCKED:
            return _BLOCKED
        # the token copy to the host starts now, behind the segment
        toks = _Fetch(self._segment())
        occ = [(i, s.rid) for i, s in enumerate(self.slots) if s.active]
        seg = self._last_seg   # _segment() records its step count
        self._last_seg = self.seg_len
        self._n_segments += 1
        self._n_steps += seg
        self._n_slot_steps += self.b * seg
        self._n_active_slot_steps += len(occ) * seg
        for i, s in enumerate(self.slots):
            if s.active:
                s.scheduled += seg
                if s.eos_id is None and s.scheduled >= s.max_new:
                    s.rid, s.active = -1, False   # count retirement
                    self._park_slot(i)
        return toks, occ

    def _collect(self, item):
        """Wait for a dispatched segment's tokens; attribute, finalize.
        Count-retired slots were freed at dispatch already; this delivers
        their tokens and drives eos retirement."""
        fetch, occ = item
        toks = fetch.numpy()             # [seg, B] — the one host wait
        for i, rid in occ:
            if rid not in self._req:
                continue                 # finalized mid-pipeline
            em = self._emitted[rid]
            em.extend(toks[:, i].tolist())   # ids, or CP rows
            max_new, eos_id = self._req[rid]
            if eos_id is None:
                if len(em) >= max_new:
                    self._finalize(rid)
                continue
            if (len(em) >= max_new
                    or self._eos_index(em[:max_new], eos_id) is not None):
                # by rid, not the segment's slot index: a resize may
                # have moved the slot since dispatch
                for k, s in enumerate(self.slots):
                    if s.active and s.rid == rid:
                        s.rid, s.active = -1, False
                        self._park_slot(k)
                        break
                self._finalize(rid)

    def step(self) -> bool:
        """Admit, run one segment synchronously, collect. Returns True
        while any work remains."""
        item = self._dispatch()
        if item is not None and item is not _BLOCKED:
            self._collect(item)
        return bool(self.pending) or any(s.active for s in self.slots)

    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {rid: generated ids [<= max_new]}.

        Keeps up to ``depth`` segments in flight: dispatch (with count
        retirement and re-admission) runs ahead of the token fetches, so
        the device decodes back to back while the host trails collecting
        copies that have landed."""
        inflight: deque = deque()
        stalled = 0
        while True:
            while len(inflight) < self.depth:
                item = self._dispatch()
                if item is None or item is _BLOCKED:
                    # _BLOCKED: collecting an in-flight segment frees
                    # room (it surfaces retirements for compaction)
                    break
                inflight.append(item)
            if not inflight:
                if self.pending:     # nothing active, nothing in flight
                    stalled += 1     # -> the idle-pool clock jump admits
                    if stalled > 2:  # cannot happen for valid submits
                        raise RuntimeError(
                            f"{len(self.pending)} pending requests "
                            "cannot be admitted (prompt exceeds the "
                            "serve window?)")
                    continue
                break
            stalled = 0
            self._collect(inflight.popleft())
        out, self.done = self.done, {}
        return out
