"""Continuous-batching serving for PoPMAG melody -> arrangement.

The port of ``musicgeneration_tpu/decode/serving_popmag.py`` on the port's
``SlotScheduler`` (``decode/scheduling.py``). PoPMAG is a seq2seq over
BARS (reference PoPMAG_RNN/network.py:366-417), so the serving unit is a
bar, not a token:

* a slot's state is its column of the carried hidden ``[L, B, H]`` plus
  its OWN melody: compound rows ``[B, max_bars, max_bar_len, 7]``,
  per-bar lengths ``[B, max_bars]`` and a bar cursor ``k``, so requests
  at different bars share every segment,
* ``submit(melody, n_bars, init=..., src_len=...)`` takes the packed
  melody ``[bars, S, 7]`` (``data/mumidi_packing.py``'s layout, as
  ``generate_arrangement``'s ``src``); ``max_new`` counts target BARS and
  retirement is by count (no eos),
* a segment decodes ``seg_len`` bars (``boost`` x that when the queue is
  empty and every active slot has that many left, ``_boosted_seg``) for
  every slot: gather each row's bar ``k``, embed and encode it against
  the row's hidden (``encode_bar``), run ``popmag_generate``'s typed bar
  loop with per-row bar-position ids, carry ``hidden = enc_h + dec_h``
  and ``k += 1``. A bar is ``max_steps`` decoder steps, each one kernel-D
  launch a GRU layer, for the whole pool,
* admission installs state per bar bucket: the group's melodies and
  lengths scattered into its slots' buffers, the bars past the bucket
  zeroed (an evicted request's melody must not leak into a shorter one),
  the latents through ``init_to_hidden`` (zeros where a request has
  none), the cursors at 0; the group is duplicate-padded to the pool
  width, as the JAX engine's ``_try_admit`` does (the scatter is
  idempotent),
* results are ``popmag_generate.flatten_arrangement``'s flat token
  streams: each bar opens with BAR_TOKEN, then the valid (etype[, pitch,
  duration]) entries in step order.

Greedy serving gives each request the tokens of ``generate_arrangement``
+ ``flatten_arrangement`` at the same pool width. Top-k and top-p are not
defined for the typed heads and are refused; sampling is greedy or one
temperature. The JAX ``_warm_after_drain`` compiles the boosted segment;
nothing compiles here.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..data import mumidi_packing as mp
from .popmag_generate import decode_bar_steps
from .sampling import SamplingParams
from .scheduling import SlotScheduler, to_device

__all__ = ["PopMAGContinuousBatcher"]


class PopMAGContinuousBatcher(SlotScheduler):
    """Continuous-batching bar decode over a PoPMAG slot pool.

    >>> cb = PopMAGContinuousBatcher(model, slots=8)
    >>> rid = cb.submit(melody, n_bars)        # melody [bars, S, 7]
    >>> outs = cb.run()    # {rid: flat arrangement token stream}

    ``submit`` extras: ``init``, the request's latent ``[init_dim]``
    (zeros by default); ``src_len``, per-bar true lengths ``[bars]``
    (default: the rows with any nonzero id, as mumidi_packing pads).
    """

    def __init__(self, model, *, slots: int = 8,
                 sampling: SamplingParams = SamplingParams(),
                 seg_len: int = 2, max_bars: int = 32,
                 max_bar_len: int = 96, max_steps: int = 200,
                 prompt_bucket: int = 8, depth: int = 4,
                 min_slots: int = 8, boost: int = 4,
                 on_finalize: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        if sampling.top_k or sampling.top_p < 1.0:
            raise ValueError(
                "top-k/top-p are not defined for PoPMAG's typed heads "
                "(greedy or temperature only — decode/popmag_generate)")
        if max_bars % prompt_bucket:
            raise ValueError(
                f"max_bars ({max_bars}) must be a multiple of "
                f"prompt_bucket ({prompt_bucket}) so bucketed melodies "
                "fit the per-slot bar buffers")
        super().__init__(
            slots=slots, sampling=sampling, seg_len=seg_len,
            prompt_bucket=prompt_bucket, depth=depth, min_slots=min_slots,
            per_row_sampling=False, on_finalize=on_finalize,
            generator=generator, pad_id=0, boost=boost)
        self.model = model
        self.device = model.device
        self.max_bars = max_bars
        self.max_bar_len = max_bar_len
        self.max_steps = max_steps
        dev = self.device
        self.hidden = torch.zeros(model.num_layers, slots, model.hidden_dim,
                                  dtype=model.dtype, device=dev)
        self.src = torch.zeros(slots, max_bars, max_bar_len, 7,
                               dtype=torch.long, device=dev)
        self.src_len = torch.zeros(slots, max_bars, dtype=torch.long,
                                   device=dev)
        self.k = torch.zeros(slots, dtype=torch.long, device=dev)

    # --------------------------------------------------- scheduler hooks

    def _canon_prompt(self, prompt) -> np.ndarray:
        m = np.asarray(prompt, np.int32)
        if m.ndim != 3 or m.shape[2] != 7:
            raise ValueError(
                f"PoPMAG prompts are [bars, S, 7] compound melodies "
                f"(data/mumidi_packing.py), got {m.shape}")
        if m.shape[0] > self.max_bars:
            raise ValueError(
                f"melody has {m.shape[0]} bars > max_bars="
                f"{self.max_bars}; raise max_bars at construction")
        if m.shape[1] > self.max_bar_len:
            raise ValueError(
                f"melody bar length {m.shape[1]} > max_bar_len="
                f"{self.max_bar_len}; raise max_bar_len at construction")
        if m.shape[1] < self.max_bar_len:    # the slot buffers' width
            m = np.pad(m, ((0, 0), (0, self.max_bar_len - m.shape[1]),
                           (0, 0)))
        return m

    def _warm_prompt(self, n: int) -> np.ndarray:
        return np.zeros((min(n, self.max_bars), self.max_bar_len, 7),
                        np.int32)

    def _empty_result(self) -> np.ndarray:
        return np.zeros((0,), np.int64)

    def _validate_request(self, prompt, max_new, eos_id, kw) -> dict:
        init = kw.pop("init", None)
        src_len = kw.pop("src_len", None)
        if kw:
            raise TypeError(f"unexpected submit() arguments: {sorted(kw)}")
        if eos_id is not None:
            raise ValueError(
                "PoPMAG requests retire by bar count (max_new = target "
                "bars); eos_id is not defined")
        if init is not None:
            init = np.asarray(init, np.float32).reshape(-1)
            if init.shape != (self.model.init_dim,):
                raise ValueError(f"init must be [{self.model.init_dim}], "
                                 f"got {init.shape}")
        if src_len is not None:
            src_len = np.asarray(src_len, np.int64).reshape(-1)
            if src_len.shape[0] != prompt.shape[0]:
                raise ValueError(
                    f"src_len has {src_len.shape[0]} entries for "
                    f"{prompt.shape[0]} melody bars")
        else:
            src_len = (prompt != 0).any(-1).sum(-1).astype(np.int64)
        return {"init": init, "src_len": src_len}

    def _assemble_result(self, toks: List, max_new: int,
                         eos_id) -> np.ndarray:
        """Per-bar [max_steps, 3, 2] blocks -> the flat token stream of
        ``flatten_arrangement``: BAR_TOKEN, then the valid (etype[,
        pitch, duration]) entries in step order."""
        seq: List[int] = []
        for blk in toks[:max_new]:
            blk = np.asarray(blk)
            seq.append(mp.BAR_TOKEN)
            seq.extend(int(x) for x in blk[..., 0][blk[..., 1] != 0])
        return np.asarray(seq, np.int64)

    def _gather_state(self, idx) -> None:
        dev_idx = to_device(np.asarray(idx, np.int64), self.device)
        self.hidden = self.hidden.index_select(1, dev_idx)
        self.src = self.src.index_select(0, dev_idx)
        self.src_len = self.src_len.index_select(0, dev_idx)
        self.k = self.k.index_select(0, dev_idx)

    @torch.no_grad()
    def _segment(self) -> torch.Tensor:
        """``_boosted_seg()`` bars for every slot; returns [seg, B,
        max_steps, 3, 2] int32 (tokens beside their valid flags) on the
        device."""
        seg = self._boosted_seg()
        self._last_seg = seg
        model = self.model
        rows = torch.arange(self.b, device=self.device)
        out = torch.empty(seg, self.b, self.max_steps, 3, 2,
                          dtype=torch.int32, device=self.device)
        hidden, k = self.hidden, self.k
        for i in range(seg):
            kk = k.clamp(0, self.max_bars - 1)
            enc_h = model.encode_bar(model.compression(self.src[rows, kk]),
                                     hidden, self.src_len[rows, kk])
            bar_embed = k.clamp_max(model.bar_dim - 1) + mp.EVENT_DIM
            tokens, valid, dec_h = decode_bar_steps(
                model, enc_h, bar_embed, max_steps=self.max_steps,
                greedy=self.sp.greedy, temperature=self.sp.temperature,
                generator=self.generator)
            out[i, ..., 0] = tokens
            out[i, ..., 1] = valid
            hidden = enc_h + dec_h                     # network.py:414
            k = k + 1
        self.hidden, self.k = hidden, k
        return out

    def _try_admit(self):
        """Move pending requests into free slots (FIFO), one admission a
        bar bucket present."""
        free = self._free_slots()
        if not free or not self.pending:
            return
        groups = {}
        remaining = []
        for q in self.pending:
            if not free:
                remaining.append(q)
                continue
            groups.setdefault(q.pb, []).append((q, free.pop(0)))
        for pb, grp in groups.items():
            for q, slot in grp:
                self._admit_bookkeeping(q, slot)
            mel = [q.padded for q, _ in grp]
            lens = [np.pad(q.extra["src_len"],
                           (0, pb - q.extra["src_len"].shape[0]))
                    for q, _ in grp]
            slots_idx = [slot for _, slot in grp]
            inits = [q.extra["init"] if q.extra["init"] is not None
                     else np.zeros(self.model.init_dim, np.float32)
                     for q, _ in grp]
            while len(mel) < self.b:          # duplicate-pad: idempotent
                mel.append(mel[0])
                lens.append(lens[0])
                slots_idx.append(slots_idx[0])
                inits.append(inits[0])
            self._admit(np.stack(mel), np.stack(lens),
                        np.asarray(slots_idx, np.int64), np.stack(inits))
            self._n_admit_calls += 1
            self._n_admitted += len(grp)
        self.pending = remaining

    @torch.no_grad()
    def _admit(self, melodies, lens, slots_idx, inits) -> None:
        """Install a group: melodies [G, pb, bar_len, 7] and per-bar lens
        [G, pb] into the target slots' buffers, the bars past pb zeroed;
        the latents through ``init_to_hidden``; the cursors at 0."""
        dev = self.device
        idx = to_device(slots_idx, dev)
        g, pb = melodies.shape[:2]
        src = np.zeros((g, self.max_bars) + melodies.shape[2:], np.int64)
        src[:, :pb] = melodies
        src_len = np.zeros((g, self.max_bars), np.int64)
        src_len[:, :pb] = lens
        h0 = self.model.init_to_hidden(to_device(inits, dev))
        self.hidden[:, idx] = h0.to(self.hidden.dtype)
        self.src[idx] = to_device(src, dev)
        self.src_len[idx] = to_device(src_len, dev)
        self.k[idx] = 0
