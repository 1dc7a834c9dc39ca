"""The MIDI-like vocabulary spec — the token id layout the port generates.

A copy of the MIDI-like part of ``musicgeneration_tpu/vocab.py``
(reference: mg/model/utils/sequence.py:14-36, 204-228): note_on 88 |
note_off 88 | velocity 32 | time_shift 100 = 308 ids, and the
PerformanceRNN control spec (``vocab.py:210-214``): pitch_histogram 12 |
note_density 12 = 24. The other schemes (REMI, MuMIDI) come with the
families that use them.
"""

from __future__ import annotations

import collections
from typing import List, Tuple

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


def _control_spec() -> VocabSpec:
    d = collections.OrderedDict()
    d["pitch_histogram"] = 12
    d["note_density"] = len(NOTE_DENSITY_BINS)
    return VocabSpec(d)


MIDILIKE = _midilike_spec()
CONTROL = _control_spec()
