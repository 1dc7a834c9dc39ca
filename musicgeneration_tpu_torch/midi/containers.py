"""In-memory MIDI object model.

This is the framework's own MIDI object layer — the environment has no
pretty_midi / miditoolkit, so the whole MIDI I/O stack is first-party.

Design notes
------------
The reference consumed two different MIDI libraries with two different time
domains:

* pretty_midi (seconds)  — used by the MIDI-like/Performance tokenizer
  (reference: mg/model/utils/sequence.py:5).
* miditoolkit (ticks)    — used by REMI / MuMIDI tokenizers
  (reference: mg/model/utils/REMI.py:3, MuMIDI.py:3).

We store ticks as the canonical, lossless unit and derive the seconds view
through the tempo map (`timing.TempoMap`), so a single parse serves both
tokenizer families.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Note:
    """A single note. `start`/`end` are in ticks for tick-domain objects and
    float seconds for seconds-domain views."""

    velocity: int
    pitch: int
    start: float
    end: Optional[float] = None

    def __repr__(self) -> str:
        return (
            f"Note(start={self.start}, end={self.end}, "
            f"pitch={self.pitch}, velocity={self.velocity})"
        )


@dataclasses.dataclass
class TempoChange:
    """Tempo in BPM starting at `time` (ticks)."""

    tempo: float
    time: int

    def __repr__(self) -> str:
        return f"TempoChange(tempo={self.tempo}, time={self.time})"


@dataclasses.dataclass
class TimeSignature:
    numerator: int
    denominator: int
    time: int


@dataclasses.dataclass
class ControlChange:
    number: int
    value: int
    time: float


@dataclasses.dataclass
class Marker:
    text: str
    time: int


class Instrument:
    """One instrument track: program, drum flag, name, notes and CCs."""

    def __init__(self, program: int = 0, is_drum: bool = False, name: str = ""):
        self.program = int(program)
        self.is_drum = bool(is_drum)
        self.name = name
        self.notes: List[Note] = []
        self.control_changes: List[ControlChange] = []

    def __repr__(self) -> str:
        return (
            f"Instrument(program={self.program}, is_drum={self.is_drum}, "
            f"name={self.name!r}, notes={len(self.notes)})"
        )
