"""Token codecs of the torch port: MIDI-like, REMI and CP (with the chord
inference they share), and MuMIDI (PoPMAG's multi-track codec)."""

from . import cp, midilike, mumidi, remi
from .midilike import EventSeq, NoteSeq
from .mumidi import MuMIDI_EventSeq
from .remi import REMI_EventSeq

__all__ = ["cp", "midilike", "mumidi", "remi", "EventSeq", "MuMIDI_EventSeq",
           "NoteSeq", "REMI_EventSeq"]
