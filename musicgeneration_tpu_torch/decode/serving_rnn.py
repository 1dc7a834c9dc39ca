"""Continuous-batching serving for the RNN families.

The port of ``musicgeneration_tpu/decode/serving_rnn.py`` for
EventMelodyRNN, PerformanceRNN and MelodyRNN, on the port's
``SlotScheduler`` (``decode/scheduling.py``: FIFO admission, count and
eos retirement,
pipelined dispatch with pinned non-blocking token copies, drain-tail
resizing, cancellation, per-row sampling, boost):

* a slot's state is its column of the ``[L, B, H]`` hidden stack
  (MelodyRNN: h and c, and its attention window ``[W, B, H]`` with a
  per-row count ``attn_n``, so a slot admitted mid-flight masks its own
  unfilled window): no KV cache, no clock, no compaction, and any
  (prompt, max_new) fits,
* admission is one masked prefill per prompt bucket: the group runs
  ``decode_step`` over its prompts from a fresh state (latent-seeded
  through ``init_to_hidden`` where the family has one; a request
  without a latent gets a zero one, as in the JAX engine), each row
  frozen with ``torch.where`` once past its own p - 1 tokens, then the
  rows are scattered into the pool.
  The prompt's last token becomes the slot's pending input,
* PerformanceRNN conditioning is per row: each slot owns a control
  window ``[W, C]`` and a cursor ``n`` (its global step); a step reads
  row ``min(n, W - 1)``, and a per-row ``control_default`` mask lets
  conditioned and unconditioned requests share the pool. A request's
  window is pre-expanded on the host (a sequence's last row repeated),
  so the clamped cursor gives ``expand_controls``'s rows exactly,
* decode runs in segments of ``decode_step`` + sampling whose tokens
  stay on the device; for the GRU families kernel D runs once per step
  for the whole pool (MelodyRNN's LSTM step is plain torch).

Cache-leaf batch axis: 1-D leaves (``attn_n``) carry the batch at axis
0, all others at axis 1 (``[L, B, H]``, ``[W, B, H]``), the JAX module's
rule (serving_rnn.py:37-41).

The JAX engine pads every admission group to the pool width and scans
the whole bucket, for one compiled program; here the group runs at its
own width for max(p) - 1 steps, which gives the same state. The JAX
``_warm_after_drain`` compiles the boosted segment; nothing compiles
here, so ``warm`` keeps the base class's one probe request.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .sampling import (SamplingParams, sample_logits, sample_logits_batched,
                       unpack_sampling)
from .scheduling import SlotScheduler, to_device

__all__ = ["RNNContinuousBatcher"]


def _batch_axis(leaf: torch.Tensor) -> int:
    return 0 if leaf.dim() == 1 else 1


class RNNContinuousBatcher(SlotScheduler):
    """Continuous-batching decode over a pool of RNN state slots.

    >>> cb = RNNContinuousBatcher(model, slots=8)
    >>> rid = cb.submit(prompt_ids, max_new=256, init=latent)
    >>> outs = cb.run()          # {rid: np.ndarray of generated ids}

    ``submit`` extras beyond the base scheduler: ``init``, a latent
    ``[init_dim]`` seeding the hidden state (zeros by default), and for
    PerformanceRNN ``control``, ``[C]`` (repeats every step) or
    ``[S, C]`` (one row per global step, the last row held; S <=
    ``ctrl_window``). Prompts include the family's priming token where
    the caller wants one, as for ``engine.generate``.
    """

    def __init__(self, model, *, slots: int = 8,
                 sampling: SamplingParams = SamplingParams(),
                 seg_len: int = 32, prompt_bucket: int = 32,
                 depth: int = 4, min_slots: int = 8,
                 per_row_sampling: bool = False, ctrl_window: int = 256,
                 boost: int = 1, on_finalize: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            slots=slots, sampling=sampling, seg_len=seg_len,
            prompt_bucket=prompt_bucket, depth=depth, min_slots=min_slots,
            per_row_sampling=per_row_sampling, on_finalize=on_finalize,
            generator=generator, pad_id=0, boost=boost)
        self.model = model
        self.device = model.device
        self.init_dim = getattr(model, "init_dim", None)
        self.ctrl_dim = getattr(model, "control_dim", None)
        self.ctrl_window = ctrl_window
        self.cache = model.init_cache(slots)
        self.tok = torch.zeros(slots, dtype=torch.long, device=self.device)
        self.n = torch.zeros(slots, dtype=torch.long, device=self.device)
        self.ctrl_buf = self.dflt = None
        if self.ctrl_dim is not None:
            self.ctrl_buf = torch.zeros(slots, ctrl_window, self.ctrl_dim,
                                        device=self.device)
            self.dflt = torch.ones(slots, dtype=torch.bool,
                                   device=self.device)
        self._n_prefill_steps = 0

    def stats(self) -> Dict[str, float]:
        """The base counters, plus ``prefill_steps``: the decode steps
        the admissions ran (one ``decode_step`` of a group per step)."""
        st = super().stats()
        st["prefill_steps"] = self._n_prefill_steps
        return st

    # --------------------------------------------------- scheduler hooks

    def _validate_request(self, prompt, max_new, eos_id, kw) -> dict:
        init = kw.pop("init", None)
        control = kw.pop("control", None)
        if kw:
            raise TypeError(f"unexpected submit() arguments: {sorted(kw)}")
        if init is not None:
            if self.init_dim is None:
                raise ValueError(f"{type(self.model).__name__} has no init "
                                 "latent")
            init = np.asarray(init, np.float32).reshape(-1)
            if init.shape != (self.init_dim,):
                raise ValueError(f"init must be [{self.init_dim}], got "
                                 f"{init.shape}")
        if control is not None:
            if self.ctrl_dim is None:
                raise ValueError(f"{type(self.model).__name__} takes no "
                                 "control conditioning")
            control = np.asarray(control, np.float32)
            if control.ndim == 1:
                control = control[None]
            if control.ndim != 2 or control.shape[1] != self.ctrl_dim:
                raise ValueError(f"control must be [C] or [S, C] with "
                                 f"C={self.ctrl_dim}, got {control.shape}")
            if control.shape[0] > self.ctrl_window:
                raise ValueError(
                    f"control sequence ({control.shape[0]} steps) exceeds "
                    f"ctrl_window ({self.ctrl_window}); raise ctrl_window "
                    "at construction")
        return {"init": init, "control": control}

    def _gather_state(self, idx) -> None:
        dev_idx = to_device(np.asarray(idx, np.int64), self.device)
        self.cache = {k: v.index_select(_batch_axis(v), dev_idx)
                      for k, v in self.cache.items()}
        self.tok = self.tok.index_select(0, dev_idx)
        self.n = self.n.index_select(0, dev_idx)
        if self.ctrl_buf is not None:
            self.ctrl_buf = self.ctrl_buf.index_select(0, dev_idx)
            self.dflt = self.dflt.index_select(0, dev_idx)

    def _step(self, tok, cache, n, ctrl_buf, dflt):
        """One decode_step of the pool (or an admission group)."""
        if ctrl_buf is None:
            return self.model.decode_step(tok, cache)
        rows = torch.arange(tok.shape[0], device=tok.device)
        c = ctrl_buf[rows, n.clamp(0, ctrl_buf.shape[1] - 1)]
        return self.model.decode_step(tok, cache, c, dflt)

    def _segment(self) -> torch.Tensor:
        """Launch one segment (``_boosted_seg()`` steps). Returns its
        [seg, B] tokens on the device."""
        seg = self._boosted_seg()
        self._last_seg = seg
        samp = (unpack_sampling(to_device(self._samp_host, self.device))
                if self.per_row else None)
        toks = torch.empty(seg, self.b, dtype=torch.long, device=self.device)
        tok, n, cache = self.tok, self.n, self.cache
        for i in range(seg):
            logits, cache = self._step(tok, cache, n, self.ctrl_buf,
                                       self.dflt)
            tok = (sample_logits_batched(logits, samp, self.generator)
                   if self.per_row
                   else sample_logits(logits, self.sp, self.generator))
            toks[i] = tok
            n = n + 1
        self.tok, self.n, self.cache = tok, n, cache
        return toks

    def _try_admit(self):
        """Move pending requests into free slots (FIFO): any free slot
        takes any request. One admission per prompt bucket present."""
        free = self._free_slots()
        if not free or not self.pending:
            return
        groups: Dict[int, list] = {}          # pb -> [(q, slot)]
        remaining = []
        for q in self.pending:
            if not free:
                remaining.append(q)
                continue
            groups.setdefault(q.pb, []).append((q, free.pop(0)))
        for grp in groups.values():
            for q, slot in grp:
                self._admit_bookkeeping(q, slot)
            self._admit_group(grp)
            self._n_admitted += len(grp)
        self.pending = remaining

    def _admit_group(self, grp) -> None:
        """One masked prefill over the group's prompts, then one scatter
        of each state tensor into the pool."""
        g = len(grp)
        ps = np.asarray([q.prompt.shape[0] for q, _ in grp], np.int64)
        steps = int(ps.max()) - 1
        rows = np.stack([q.padded for q, _ in grp]).astype(np.int64)
        slots_idx = to_device(np.asarray([s for _, s in grp], np.int64),
                              self.device)
        extras = [q.extra for q, _ in grp]
        init = None
        if self.init_dim is not None:
            # a zero latent where a request has none (the JAX engine's
            # rule): tanh(inithid_fc(0)), the zero state for a zero bias
            init = np.zeros((g, self.init_dim), np.float32)
            for j, e in enumerate(extras):
                if e["init"] is not None:
                    init[j] = e["init"]
            init = to_device(init, self.device)
        gc = self.model.init_cache(g, init=init)
        ctrls = dflt = None
        if self.ctrl_dim is not None:
            host = np.zeros((g, self.ctrl_window, self.ctrl_dim), np.float32)
            for j, e in enumerate(extras):
                c = e["control"]
                if c is not None:
                    host[j, :c.shape[0]] = c
                    host[j, c.shape[0]:] = c[-1]
            ctrls = to_device(host, self.device)
            dflt = to_device(np.asarray([e["control"] is None
                                         for e in extras]), self.device)
        if steps > 0:
            prompts = to_device(rows[:, :steps], self.device)
            # live[i, j]: step i still inside row j's first p_j - 1 tokens
            live = to_device(np.arange(steps)[:, None] < ps[None, :] - 1,
                             self.device)
            cursor = torch.zeros(g, dtype=torch.long, device=self.device)
            for i in range(steps):
                _, gc2 = self._step(prompts[:, i], gc, cursor + i, ctrls,
                                    dflt)
                gc = {k: torch.where(
                    live[i].view([-1 if a == _batch_axis(v) else 1
                                  for a in range(v.dim())]), gc2[k], v)
                    for k, v in gc.items()}
            self._n_prefill_steps += steps
        for k, v in self.cache.items():
            v.index_copy_(_batch_axis(v), slots_idx, gc[k].to(v.dtype))
        last = to_device(rows[np.arange(g), ps - 1], self.device)
        self.tok.index_copy_(0, slots_idx, last)
        self.n.index_copy_(0, slots_idx, to_device(ps - 1, self.device))
        if self.ctrl_buf is not None:
            self.ctrl_buf.index_copy_(0, slots_idx, ctrls)
            self.dflt.index_copy_(0, slots_idx, dflt)
        self._n_admit_calls += 1
