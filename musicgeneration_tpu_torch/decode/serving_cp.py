"""Continuous-batching serving for the Compound Word transformer.

The port of ``musicgeneration_tpu/decode/serving_cp.py``. A CP row
occupies exactly one cache position, so everything cache-side is the
flat transformer engine's (``decode/serving.py``): the slot pool, the
shared clock, right-aligned ragged slots (``CPTransformer.decode_step``
takes the same ``start``/``start_min`` bounds: kernel B's ragged mode),
one group prefill per prompt bucket (kernel A) scattered into the slots'
row windows, roll-compaction and the live-window floor. What changes:

* the pending input is a row ``[B, 8]``; prompts are ``[P, 8]`` and a
  result is ``[n, 8]``, also when empty (a queued cancel, an eos on the
  first row);
* a bucket's rows past a prompt's end are zero rows (the JAX engine's
  pad id 0 for a model without one); causality keeps them from every
  earlier row, and decode steps overwrite their cache rows before any
  row attends them;
* sampling is ``cp_generate``'s type-first masked row draw, greedy or at
  one temperature: top-k/top-p and per-request sampling are not defined
  for compound rows and are refused;
* ``eos_id`` is matched against the FAMILY column (``cp.FAMILY_EOS``
  cuts a request at its end-of-piece row).

Greedy serving gives each request the rows of its dedicated
``generate_cp`` run (up to floating-point ties: the pool's batch width
differs). Sliding-window requests (``window=``) are not ported for CP.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..tokenizers import cp
from .cp_generate import sample_row
from .sampling import SamplingParams
from .scheduling import to_device
from .serving import ContinuousBatcher

__all__ = ["CPContinuousBatcher"]


class CPContinuousBatcher(ContinuousBatcher):
    """Continuous-batching row decode over a ``CPTransformer``.

    >>> cb = CPContinuousBatcher(model, slots=8)
    >>> rid = cb.submit(prompt_rows, max_new=256)   # [P, 8] int rows
    >>> outs = cb.run()          # {rid: np.ndarray [n, 8]}
    """

    def __init__(self, model, *, slots: int = 8,
                 sampling: SamplingParams = SamplingParams(),
                 seg_len: int = 32, cache_len: Optional[int] = None,
                 prompt_bucket: int = 64, depth: int = 4,
                 min_slots: int = 8, on_finalize: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        if sampling.top_k or sampling.top_p < 1.0:
            raise ValueError(
                "top-k/top-p are not defined for compound-word rows "
                "(type-first masked sampling draws each field "
                "categorically — decode/cp_generate.py)")
        super().__init__(
            model, slots=slots, sampling=sampling, seg_len=seg_len,
            cache_len=cache_len, prompt_bucket=prompt_bucket, depth=depth,
            min_slots=min_slots, per_row_sampling=False,
            on_finalize=on_finalize, generator=generator)
        self.tok = torch.zeros(slots, cp.WIDTH, dtype=torch.long,
                               device=self.device)

    # --------------------------------------------------- scheduler hooks

    def _canon_prompt(self, prompt) -> np.ndarray:
        rows = np.asarray(prompt, np.int32)
        if rows.ndim != 2 or rows.shape[1] != cp.WIDTH:
            raise ValueError(f"CP prompts are [P, {cp.WIDTH}] compound rows, "
                             f"got {rows.shape}")
        return rows

    def _warm_prompt(self, n: int) -> np.ndarray:
        return np.zeros((n, cp.WIDTH), np.int32)

    def _empty_result(self) -> np.ndarray:
        return np.zeros((0, cp.WIDTH), np.int32)

    def _eos_index(self, toks, eos_id) -> Optional[int]:
        for j, row in enumerate(toks):
            if row[0] == eos_id:
                return j
        return None

    def _validate_request(self, prompt, max_new, eos_id, kw) -> dict:
        if "window" in kw:
            raise ValueError("window= (sliding-context serving) is not "
                             "ported for compound-word rows")
        return super()._validate_request(prompt, max_new, eos_id, kw)

    def _segment(self) -> torch.Tensor:
        """One segment of row decode steps; returns its [seg, B, 8] rows
        on the device."""
        seg = self._next_seg
        self._next_seg = self.seg_len
        self._last_seg = seg
        start = to_device(self._start_host.astype(np.int32), self.device)
        smin = int(self._start_host.min())
        rows = torch.empty(seg, self.b, cp.WIDTH, dtype=torch.long,
                           device=self.device)
        tok = self.tok
        for i in range(seg):
            logits, self.cache = self.model.decode_step(
                tok, self.cache, self.t + i, self.stacked, start=start,
                start_min=smin)
            tok = sample_row(logits, self.sp.temperature, self.sp.greedy,
                             self.generator)
            rows[i] = tok
        self.tok = tok
        self.t += seg
        return rows
