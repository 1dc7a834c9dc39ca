"""First-party MIDI I/O, copied from ``musicgeneration_tpu.midi``.

Public surface:
    MidiFile      — parse / write Standard MIDI Files (ticks canonical)
    Note, Instrument, TempoChange, TimeSignature, ControlChange, Marker
    TempoMap      — vectorised tick<->seconds conversion
"""

from .containers import (
    ControlChange,
    Instrument,
    Marker,
    Note,
    TempoChange,
    TimeSignature,
)
from .smf import MidiFile
from .timing import TempoMap

__all__ = [
    "MidiFile",
    "Note",
    "Instrument",
    "TempoChange",
    "TimeSignature",
    "ControlChange",
    "Marker",
    "TempoMap",
]
