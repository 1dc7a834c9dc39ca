"""Rule-based chord inference (reference: mg/model/utils/chord_inference.py).

A copy of ``musicgeneration_tpu/tokenizers/chords.py`` (the torch port
imports nothing of the JAX package): REMI and CP read their chord items
from ``MIDIChord``.

Same algorithm, vectorised front-end:

* template scoring over 5 qualities (maj/min/dim/aug/dom) with insider /
  outsider bonuses (chord_inference.py:9-31, 49-87),
* candidate windows of 4 then 2 beats at every beat boundary
  (chord_inference.py:165-183),
* greedy non-overlapping segmentation preferring (score, end_tick)
  (chord_inference.py:125-155).

Instead of materialising a [max_tick, 128] pianoroll and slicing it per
window (the reference's tokenizer bottleneck — SURVEY.md hard-part #4), we
reduce notes to a [n_beats, 128] presence matrix once, then every window
reduction is a couple of numpy ops.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

PITCH_CLASSES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]

CHORD_MAPS = {
    "maj": [0, 4],
    "min": [0, 3],
    "dim": [0, 3, 6],
    "aug": [0, 4, 8],
    "dom": [0, 4, 7, 10],
}
CHORD_INSIDERS = {
    "maj": [7],
    "min": [7],
    "dim": [9],
    "aug": [],
    "dom": [],
}
CHORD_OUTSIDERS_1 = {
    "maj": [2, 5, 9],
    "min": [2, 5, 8],
    "dim": [2, 5, 10],
    "aug": [2, 5, 9],
    "dom": [2, 5, 9],
}
CHORD_OUTSIDERS_2 = {
    "maj": [1, 3, 6, 8, 10],
    "min": [1, 4, 6, 9, 11],
    "dim": [1, 4, 7, 8, 11],
    "aug": [1, 3, 6, 7, 10],
    "dom": [1, 3, 6, 8, 11],
}

TICKS_PER_BEAT = 480


def _beat_presence(notes, max_tick: int) -> np.ndarray:
    """[n_beats, 128] bool: pitch sounding at any tick within the beat."""
    n_beats = int(np.ceil(max_tick / TICKS_PER_BEAT))
    presence = np.zeros((max(n_beats, 1), 128), dtype=bool)
    for note in notes:
        start = int(note.start)
        end = int(note.end)
        if end <= start:
            continue
        b0 = start // TICKS_PER_BEAT
        b1 = (min(end, max_tick) - 1) // TICKS_PER_BEAT
        presence[b0:b1 + 1, int(note.pitch) & 127] = True
    return presence


def _find_chord(window: np.ndarray) -> Tuple[str, str, str, int]:
    """Score one window's presence rows (reference: find_chord,
    chord_inference.py:89-123)."""
    pitches = np.flatnonzero(window.any(axis=0))
    if pitches.size == 0:
        return "N", "N", "N", 0
    chroma = np.zeros(12, dtype=bool)
    chroma[pitches % 12] = True
    bass_note = int(pitches[0] % 12)

    scores: Dict[int, int] = {}
    qualities: Dict[int, str] = {}
    candidates: Dict[int, List[int]] = {}
    for root in range(12):
        if not chroma[root]:
            continue
        rel = np.flatnonzero(np.roll(chroma, -root))
        seq = set(rel.tolist())
        candidates[root] = sorted(seq)
        if (3 in seq) == (4 in seq):  # neither or both thirds -> invalid
            scores[root] = -100
            qualities[root] = "None"
            continue
        if 3 in seq:
            quality = "dim" if 6 in seq else "min"
        else:
            if 8 in seq:
                quality = "aug"
            elif 7 in seq and 10 in seq:
                quality = "dom"
            else:
                quality = "maj"
        score = 0
        maps = CHORD_MAPS[quality]
        for n in seq:
            if n in maps:
                continue
            if n in CHORD_OUTSIDERS_1[quality]:
                score -= 1
            elif n in CHORD_OUTSIDERS_2[quality]:
                score -= 2
            elif n in CHORD_INSIDERS[quality]:
                score += 1
        scores[root] = score
        qualities[root] = quality

    best = max(scores.values())
    tied = [r for r, s in scores.items() if s == best]
    if len(tied) == 1:
        root = tied[0]
    else:
        root = tied[0]
        # reference walks pitches low->high and picks the first tied root
        for p in pitches:
            if int(p % 12) in tied:
                root = int(p % 12)
                break
    return (PITCH_CLASSES[root], qualities[root],
            PITCH_CLASSES[bass_note], scores[root])


# quality order for the vectorized scorer
_QUALITIES = ["maj", "min", "dim", "aug", "dom"]
_WEIGHTS = np.zeros((5, 12), np.int32)
for _qi, _q in enumerate(_QUALITIES):
    for _n in range(12):
        if _n in CHORD_MAPS[_q]:
            continue
        if _n in CHORD_OUTSIDERS_1[_q]:
            _WEIGHTS[_qi, _n] = -1
        elif _n in CHORD_OUTSIDERS_2[_q]:
            _WEIGHTS[_qi, _n] = -2
        elif _n in CHORD_INSIDERS[_q]:
            _WEIGHTS[_qi, _n] = 1


def _score_all_windows(win_presence: np.ndarray):
    """Vectorized _find_chord over many windows at once.

    win_presence: [n_w, 128] bool (pitch sounds anywhere in window).
    Returns per-window (root_idx, quality_str, bass_idx, score) with
    root/bass == -1 for empty windows — identical decisions to
    _find_chord (checked by tests against the per-window oracle).
    """
    n_w = win_presence.shape[0]
    pitch_ids = np.arange(128)
    # lowest sounding pitch per window -> bass class; 999 = none
    masked = np.where(win_presence, pitch_ids[None, :], 999)
    low_pitch = masked.min(axis=1)                       # [n_w]
    empty = low_pitch == 999
    # lowest pitch per pitch-class (for the reference's ascending-pitch
    # tie-break): [n_w, 12]
    cls = pitch_ids % 12
    low_by_class = np.full((n_w, 12), 999)
    for c in range(12):
        low_by_class[:, c] = masked[:, cls == c].min(axis=1)
    chroma = low_by_class < 999                          # [n_w, 12]

    idx = (np.arange(12)[:, None] + np.arange(12)[None, :]) % 12
    rel = chroma[:, idx]                                 # [n_w, root, i]
    h = lambda i: rel[:, :, i]
    has3, has4, has6, has7, has8, has10 = (h(3), h(4), h(6), h(7), h(8),
                                           h(10))
    invalid = has3 == has4                               # both or neither
    qid = np.select(
        [has3 & has6, has3, has8, has7 & has10],
        [2, 1, 3, 4], default=0)                         # dim/min/aug/dom/maj
    scores = (rel * _WEIGHTS[qid]).sum(-1)               # [n_w, 12]
    scores = np.where(invalid, -100, scores)
    scores = np.where(chroma, scores, -(10 ** 6))        # absent roots

    best = scores.max(axis=1)                            # [n_w]
    tied = scores == best[:, None]
    # reference tie-break: first window pitch (ascending) whose class is
    # tied == tied class with the minimal lowest-pitch
    tie_key = np.where(tied, low_by_class, 1000)
    root = tie_key.argmin(axis=1)
    quality = np.where(
        invalid[np.arange(n_w), root], -1,
        qid[np.arange(n_w), root])                       # -1 = "None"
    return (np.where(empty, -1, root), quality,
            np.where(empty, -1, low_pitch % 12),
            np.where(empty, 0, scores[np.arange(n_w), root]))


def _window_any(presence: np.ndarray, interval: int) -> np.ndarray:
    """[n_beats, 128] -> [n_beats, 128]: any() over beats [b, b+interval)
    clipped at the end (cum-or difference would need ints; interval is
    tiny so a shifted-or is cheapest)."""
    out = presence.copy()
    for d in range(1, interval):
        out[:-d] |= presence[d:]
    return out


class MIDIChord:
    """Public API kept name-compatible with the reference class."""

    def extract(self, notes: Sequence) -> List[List]:
        """notes: objects with .start/.end (ticks) and .pitch.
        Returns [[start_tick, end_tick, 'Root:quality(/Bass)'], ...]."""
        max_tick = max(int(n.end) for n in notes)
        presence = _beat_presence(notes, max_tick)
        n_beats = presence.shape[0]

        candidates: Dict[int, Dict[int, Tuple[str, str, str, int]]] = {}
        for interval in (4, 2):
            wins = _window_any(presence, interval)
            roots, quals, basses, scores = _score_all_windows(wins)
            for beat in range(n_beats):
                start_tick = beat * TICKS_PER_BEAT
                if start_tick >= max_tick:
                    break
                end_tick = min(start_tick + interval * TICKS_PER_BEAT,
                               max_tick)
                if roots[beat] < 0:
                    result = ("N", "N", "N", 0)
                else:
                    q = ("None" if quals[beat] < 0
                         else _QUALITIES[quals[beat]])
                    result = (PITCH_CLASSES[roots[beat]], q,
                              PITCH_CLASSES[basses[beat]],
                              int(scores[beat]))
                slot = candidates.setdefault(start_tick, {})
                if end_tick not in slot:
                    slot[end_tick] = result

        return self._greedy(candidates, max_tick)

    @staticmethod
    def _greedy(candidates, max_tick: int) -> List[List]:
        chords: List[List] = []
        start_tick = 0
        while start_tick < max_tick:
            opts = sorted(candidates[start_tick].items(),
                          key=lambda x: (x[1][-1], x[0]))
            end_tick, (root, quality, bass, _) = opts[-1]
            if root == bass:
                chord = f"{root}:{quality}"
            else:
                chord = f"{root}:{quality}/{bass}"
            chords.append([start_tick, end_tick, chord])
            start_tick = end_tick
        # strip / merge ':None' segments (chord_inference.py:141-155)
        temp = chords
        while temp and ":None" in temp[0][-1]:
            if len(temp) == 1:
                return []
            temp[1][0] = temp[0][0]
            del temp[0]
        out: List[List] = []
        for chord in temp:
            if ":None" not in chord[-1]:
                out.append(chord)
            else:
                out[-1][1] = chord[1]
        return out
