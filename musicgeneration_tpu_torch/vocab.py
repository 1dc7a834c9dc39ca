"""Vocabulary specs — the token id layouts the port reads and generates.

Copies of parts of ``musicgeneration_tpu/vocab.py``: the MIDI-like
layout (reference: mg/model/utils/sequence.py:14-36, 204-228): note_on 88
| note_off 88 | velocity 32 | time_shift 100 = 308 ids; the
PerformanceRNN control spec (``vocab.py:210-214``): pitch_histogram 12 |
note_density 12 = 24; and the REMI constants, chord map and layout
(``vocab.py:48-54``, ``:74-81``; reference REMI.py:9-37, 449-458):
note_on 127 | note_duration 64 | note_velocity 4 | bar 1 | position 16 |
tempo_class 3 | tempo_value 60 | chord 61 = 336, which the REMI and CP
codecs read; and the MuMIDI constants and layout (``vocab.py:57-70``,
``_mumidi_spec`` :195; reference MuMIDI.py:9-55, 352-384): empty 1 |
note_on 256 (128 pitch + 128 drum) | note_duration 32 | note_velocity 32
| bar 1 | position 33 | track 6 | tempo_class 3 | tempo_value 60 | chord
61 = 485, which the MuMIDI codec and PoPMAG read.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np

MIDILIKE_PITCH_RANGE = range(21, 109)
MIDILIKE_VELOCITY_RANGE = range(21, 109)
MIDILIKE_VELOCITY_STEPS = 32
MIDILIKE_TIME_SHIFT_BINS = 0.01 * np.arange(1, 101)
DEFAULT_TEMPO = 120
BEAT_LENGTH = 60 / DEFAULT_TEMPO
DEFAULT_NOTE_LENGTH = BEAT_LENGTH * 2
MIN_NOTE_LENGTH = BEAT_LENGTH / 2
DEFAULT_VELOCITY = 64
# PerformanceRNN controls (musicgeneration_tpu/vocab.py:44-45)
CONTROL_WINDOW_SIZE = BEAT_LENGTH * 4
NOTE_DENSITY_BINS = np.arange(12) * 3 + 1

# REMI scheme (reference: REMI.py:9-35), read by the REMI and CP codecs
REMI_FRACTION = 16
REMI_DURATION_BINS = np.arange(60, 3841, 60, dtype=int)  # 64 bins
REMI_TEMPO_INTERVALS = [range(30, 90), range(90, 150), range(150, 210)]
REMI_PITCH_RANGE = range(0, 127)
REMI_VELOCITY_STEPS = 4
REMI_VELOCITY_BINS = np.arange(4, 128, 4)  # 31 edges; index via searchsorted-1
REMI_RESOLUTION = 480

# MuMIDI scheme (reference: MuMIDI.py:9-55), read by the MuMIDI codec
MUMIDI_FRACTION = 32
MUMIDI_DURATION_BINS = np.arange(60, 1921, 60, dtype=int)  # 32 bins
MUMIDI_PITCH_RANGE = range(1, 129)
MUMIDI_DRUM_TYPE = range(1, 129)
MUMIDI_VELOCITY_BINS = np.arange(4, 129, 4)  # 32 edges
MUMIDI_TRACKS = ["melody", "piano", "bass", "guitar", "string", "drum"]
MUMIDI_TRACK_IDX = {name: i for i, name in enumerate(MUMIDI_TRACKS)}
MUMIDI_INSTRUMENT_NUMBERS = {
    "melody": [73],
    "piano": [1, 2, 3, 4, 5, 6, 7, 8],
    "bass": [33, 34, 35, 36, 37, 38, 39, 40],
    "guitar": [25, 26, 27, 28, 29, 30, 31, 32],
    "drum": [114, 115, 116, 117, 118, 119],
    "string": [66],
}

# Chord vocabulary of REMI, CP and MuMIDI (reference: REMI.py:27-37)
CHORD_QUALITY = ["maj", "min", "dim", "aug", "dom"]
CHORD_ROOT = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
CHORD_MAP: Dict[str, int] = {}
for _q in CHORD_QUALITY:
    for _r in CHORD_ROOT:
        CHORD_MAP[f"{_r}:{_q}"] = len(CHORD_MAP)
CHORD_MAP["N:N"] = len(CHORD_MAP)
INV_CHORD_MAP = {v: k for k, v in CHORD_MAP.items()}


def midilike_velocity_bins() -> np.ndarray:
    """Reference: sequence.py:223-228 — arange with fractional step."""
    lo, hi = MIDILIKE_VELOCITY_RANGE.start, MIDILIKE_VELOCITY_RANGE.stop
    return np.arange(lo, hi, (hi - lo) / (MIDILIKE_VELOCITY_STEPS - 1))


class VocabSpec:
    """Ordered feature layout with O(1) vectorised id<->feature mapping."""

    def __init__(self, feat_dims: "collections.OrderedDict[str, int]"):
        self._feat_dims = collections.OrderedDict(feat_dims)
        self._feat_ranges = collections.OrderedDict()
        offset = 0
        for name, d in self._feat_dims.items():
            self._feat_ranges[name] = range(offset, offset + d)
            offset += d
        self._dim = offset
        self._names: List[str] = list(self._feat_dims)
        self._id_to_feat = np.empty(self._dim, dtype=np.int32)
        self._id_to_value = np.empty(self._dim, dtype=np.int32)
        for fi, rng in enumerate(self._feat_ranges.values()):
            self._id_to_feat[rng.start:rng.stop] = fi
            self._id_to_value[rng.start:rng.stop] = np.arange(len(rng))

    def dim(self) -> int:
        return self._dim

    def feat_dims(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(self._feat_dims)

    def feat_ranges(self) -> "collections.OrderedDict[str, range]":
        return collections.OrderedDict(self._feat_ranges)

    def dims_feat(self) -> "collections.OrderedDict[int, Tuple[str, int]]":
        """id -> (feature name, value). Reference: REMI.py:461-471."""
        out = collections.OrderedDict()
        for name, rng in self._feat_ranges.items():
            for i, idx in enumerate(rng):
                out[idx] = (name, i)
        return out

    @property
    def names(self) -> List[str]:
        return self._names

    def decode_ids(self, ids) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorised: token ids -> (feature index array, value array)."""
        ids = np.asarray(ids, dtype=np.int64)
        return self._id_to_feat[ids], self._id_to_value[ids]

    def array_dtype(self):
        """Reference packs to uint8 when dim<=256 else uint16
        (sequence.py:286)."""
        return np.uint8 if self._dim <= 256 else np.uint16


def _midilike_spec() -> VocabSpec:
    d = collections.OrderedDict()
    d["note_on"] = len(MIDILIKE_PITCH_RANGE)
    d["note_off"] = len(MIDILIKE_PITCH_RANGE)
    d["velocity"] = MIDILIKE_VELOCITY_STEPS
    d["time_shift"] = len(MIDILIKE_TIME_SHIFT_BINS)
    return VocabSpec(d)


def _remi_spec() -> VocabSpec:
    d = collections.OrderedDict()
    d["note_on"] = len(REMI_PITCH_RANGE)
    d["note_duration"] = len(REMI_DURATION_BINS)
    d["note_velocity"] = REMI_VELOCITY_STEPS
    d["bar"] = 1
    d["position"] = REMI_FRACTION
    d["tempo_class"] = len(REMI_TEMPO_INTERVALS)
    d["tempo_value"] = len(REMI_TEMPO_INTERVALS[0])
    d["chord"] = len(CHORD_MAP)
    return VocabSpec(d)


def _mumidi_spec() -> VocabSpec:
    d = collections.OrderedDict()
    d["empty"] = 1
    d["note_on"] = len(MUMIDI_PITCH_RANGE) + len(MUMIDI_DRUM_TYPE)
    d["note_duration"] = len(MUMIDI_DURATION_BINS)
    d["note_velocity"] = len(MUMIDI_VELOCITY_BINS)
    d["bar"] = 1
    d["position"] = MUMIDI_FRACTION + 1
    d["track"] = len(MUMIDI_TRACKS)
    d["tempo_class"] = len(REMI_TEMPO_INTERVALS)
    d["tempo_value"] = len(REMI_TEMPO_INTERVALS[0])
    d["chord"] = len(CHORD_MAP)
    return VocabSpec(d)


def _control_spec() -> VocabSpec:
    d = collections.OrderedDict()
    d["pitch_histogram"] = 12
    d["note_density"] = len(NOTE_DENSITY_BINS)
    return VocabSpec(d)


MIDILIKE = _midilike_spec()
REMI = _remi_spec()
MUMIDI = _mumidi_spec()
CONTROL = _control_spec()
