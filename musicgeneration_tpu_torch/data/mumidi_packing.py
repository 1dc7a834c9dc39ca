"""MuMIDI compound packing for PoPMAG: token streams -> 7-slot compound-id
tensors + 3-head labels.

A copy of ``musicgeneration_tpu/data/mumidi_packing.py`` (numpy only) over
the port's MuMIDI spec.

Faithful to the reference collate path (mg/model/utils/data.py:218-469):

* compound row = (bar_id, pos_id, tempo_cls, tempo_val, token1, token2,
  token3); empty slots hold id 0 — which IS the MuMIDI 'empty' token and
  gets embedded and summed like everything else (a reference quirk kept
  for parity),
* bar ids live ABOVE the event vocab: event_dim + n_bar, clamped to the
  last bar embedding (data.py:190-195),
* a bar token inside the stream is encoded with the ALREADY-INCREMENTED
  bar counter (data.py:227-247: `bar_embed = bar_id(n_bar); n_bar += 1`
  ... `bar_id(n_bar)` inside the loop) — kept,
* tempo (class,value) pairs expand to TWO rows (data.py:256-262),
* notes are the triple (velocity, pitch, duration) collapsed into ONE row
  (data.py:263-271),
* labels: 3 heads with per-head id shifts — head 0 (event type) covers
  everything except note_on/note_duration, shifted by
  1+|note_on|+|note_duration| = 289; head 1 = note_on shifted by 1;
  head 2 = note_duration shifted by 257 (data.py:323-324); the leading
  bar token of each bar is skipped (label loop starts at i=1,
  data.py:337-340),
* FastBatchify: arrangement bars get a trailing bar token appended, the
  decoder input drops its last row (delta=-1), so tar[t] predicts
  label[t] (data.py:442-463).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .. import vocab

SPEC = vocab.MUMIDI
_R = SPEC.feat_ranges()
_D = SPEC.feat_dims()

EVENT_DIM = SPEC.dim()          # 485
DEFAULT_BAR_DIM = 188           # PoPMAG_RNN/config.py:8-26
BAR_TOKEN = _R["bar"].start     # 321
POS0 = _R["position"].start

# per-head id shifts (data.py:323-324, network.py:49-53)
SHIFT = (1 + _D["note_on"] + _D["note_duration"], 1, 1 + _D["note_on"])
OUT_LEN = (EVENT_DIM - 1 - _D["note_on"] - _D["note_duration"],
           _D["note_on"], _D["note_duration"])
MX_DIM = max(OUT_LEN)


def _in(feat: str, idx: int) -> bool:
    r = _R[feat]
    return r.start <= idx < r.stop


def bar_id(n_bar: int, bar_dim: int = DEFAULT_BAR_DIM) -> int:
    return EVENT_DIM + min(n_bar, bar_dim - 1)


def compound_vocab_size(bar_dim: int = DEFAULT_BAR_DIM) -> int:
    return EVENT_DIM + bar_dim


def pack_compound(bars: Sequence[np.ndarray], delta: int = 0,
                  bar_dim: int = DEFAULT_BAR_DIM
                  ) -> Tuple[List[np.ndarray], List[int]]:
    """One sequence of per-bar token arrays -> list of [len_i, 7] compound
    rows (+ row counts). delta=-1 drops each bar's last row (decoder
    input shift, data.py:291-292)."""
    out, lens = [], []
    n_bar = 0
    for bar_items in bars:
        bar_embed = bar_id(n_bar, bar_dim)
        n_bar += 1
        i = 0
        pos = 0
        tempo_cls = 0
        tempo_val = 0
        rows = []
        items = np.asarray(bar_items, np.int64)
        n = len(items)
        while i < n:
            tok = int(items[i])
            if _in("bar", tok):
                rows.append((bar_id(n_bar, bar_dim), POS0, 0, 0,
                             BAR_TOKEN, 0, 0))
                i += 1
            elif _in("position", tok):
                pos = tok
                rows.append((bar_embed, pos, 0, 0, 0, 0, 0))
                i += 1
            elif (i + 1 < n and _in("tempo_class", tok)
                  and _in("tempo_value", int(items[i + 1]))):
                tempo_cls, tempo_val = tok, int(items[i + 1])
                rows.append((bar_embed, pos, tempo_cls, 0, 0, 0, 0))
                rows.append((bar_embed, pos, 0, tempo_val, 0, 0, 0))
                i += 2
            elif (i + 2 < n and _in("note_velocity", tok)
                  and _in("note_on", int(items[i + 1]))
                  and _in("note_duration", int(items[i + 2]))):
                vel, pitch, dur = tok, int(items[i + 1]), int(items[i + 2])
                rows.append((bar_embed, pos, tempo_cls, tempo_val,
                             pitch, dur, vel))
                i += 3
            else:  # track / chord / stray token
                rows.append((bar_embed, pos, tempo_cls, tempo_val,
                             tok, 0, 0))
                i += 1
        if delta != 0 and rows:
            rows.pop(-1)
        arr = np.asarray(rows, np.int32).reshape(-1, 7)
        out.append(arr)
        lens.append(len(arr))
    return out, lens


def pack_labels(bars: Sequence[np.ndarray]
                ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """One sequence of per-bar token arrays -> per-bar ([len_i, 3] labels,
    [len_i, 3] masks). Skips each bar's first token (data.py:337)."""
    labels_out, masks_out = [], []
    for bar_items in bars:
        items = np.asarray(bar_items, np.int64)
        n = len(items)
        i = 1
        labels, masks = [], []
        while i < n:
            tok = int(items[i])
            if _in("bar", tok):
                labels.append((BAR_TOKEN - SHIFT[0], 0, 0))
                masks.append((1, 0, 0))
                i += 1
            elif _in("position", tok):
                labels.append((tok - SHIFT[0], 0, 0))
                masks.append((1, 0, 0))
                i += 1
            elif (i + 1 < n and _in("tempo_class", tok)
                  and _in("tempo_value", int(items[i + 1]))):
                labels.append((tok - SHIFT[0], 0, 0))
                masks.append((1, 0, 0))
                labels.append((int(items[i + 1]) - SHIFT[0], 0, 0))
                masks.append((1, 0, 0))
                i += 2
            elif (i + 2 < n and _in("note_velocity", tok)
                  and _in("note_on", int(items[i + 1]))
                  and _in("note_duration", int(items[i + 2]))):
                labels.append((tok - SHIFT[0],
                               int(items[i + 1]) - SHIFT[1],
                               int(items[i + 2]) - SHIFT[2]))
                masks.append((1, 1, 1))
                i += 3
            else:
                labels.append((tok - SHIFT[0], 0, 0))
                masks.append((1, 0, 0))
                i += 1
        labels_out.append(np.asarray(labels, np.int32).reshape(-1, 3))
        masks_out.append(np.asarray(masks, np.int32).reshape(-1, 3))
    return labels_out, masks_out


@dataclasses.dataclass
class MuMIDIBatch:
    src: np.ndarray        # [B, S_bars, S_len, 7] int32
    src_len: np.ndarray    # [B, S_bars] int32 (>=1; pad bars are len 1)
    tar: np.ndarray        # [B, T_bars, T_len, 7]
    tar_len: np.ndarray    # [B, T_bars]
    labels: np.ndarray     # [B, T_bars, T_len, 3]
    label_mask: np.ndarray  # [B, T_bars, T_len, 3]


def _pad_stack(per_seq: List[List[np.ndarray]], width: int,
               n_bars: int, bar_len: int) -> np.ndarray:
    b = len(per_seq)
    out = np.zeros((b, n_bars, bar_len, width), np.int32)
    for bi, bars in enumerate(per_seq):
        for gi, arr in enumerate(bars):
            out[bi, gi, :len(arr)] = arr
    return out


def pack_batch(pairs: Sequence[Tuple[Sequence[np.ndarray],
                                     Sequence[np.ndarray]]],
               bar_dim: int = DEFAULT_BAR_DIM,
               pad_bars_to: int | None = None,
               pad_len_to: int | None = None) -> MuMIDIBatch:
    """FastBatchify parity (data.py:442-463).

    pairs: list of (melody_bars, arrangement_bars), each a list of per-bar
    token arrays (from MuMIDI_EventSeq.segmentation). Arrangement bars get
    a trailing bar token; decoder input = delta=-1 compound; labels skip
    the leading bar token. Optional pad_bars_to / pad_len_to give fixed
    shapes across batches (the training CLI's bucketing).
    """
    srcs, tars, labels, masks = [], [], [], []
    src_lens, tar_lens = [], []
    for melody_bars, arrange_bars in pairs:
        arrange_bars = [np.append(np.asarray(b, np.int64), BAR_TOKEN)
                        for b in arrange_bars]
        s, sl = pack_compound(melody_bars, 0, bar_dim)
        t, tl = pack_compound(arrange_bars, -1, bar_dim)
        lab, msk = pack_labels(arrange_bars)
        srcs.append(s)
        tars.append(t)
        labels.append(lab)
        masks.append(msk)
        src_lens.append(sl)
        tar_lens.append(tl)

    s_bars = pad_bars_to or max(len(s) for s in srcs)
    t_bars = pad_bars_to or max(len(t) for t in tars)
    s_len = pad_len_to or max((len(a) for s in srcs for a in s), default=1)
    t_len = pad_len_to or max((len(a) for t in tars for a in t), default=1)
    t_len = max(t_len,
                max((len(a) for ls in labels for a in ls), default=1))

    b = len(pairs)
    src_len = np.ones((b, s_bars), np.int32)
    tar_len = np.ones((b, t_bars), np.int32)
    for bi in range(b):
        src_len[bi, :len(src_lens[bi])] = np.maximum(src_lens[bi], 1)
        tar_len[bi, :len(tar_lens[bi])] = np.maximum(tar_lens[bi], 1)

    return MuMIDIBatch(
        src=_pad_stack(srcs, 7, s_bars, s_len),
        src_len=src_len,
        tar=_pad_stack(tars, 7, t_bars, t_len),
        tar_len=tar_len,
        labels=_pad_stack(labels, 3, t_bars, t_len),
        label_mask=_pad_stack(masks, 3, t_bars, t_len),
    )
