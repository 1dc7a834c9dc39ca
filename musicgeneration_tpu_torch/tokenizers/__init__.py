"""Token codecs of the torch port: MIDI-like, REMI and CP (with the chord
inference they share), MuMIDI (PoPMAG's multi-track codec) and the
melody note arrays (MelodyRNN's)."""

from . import cp, melody, midilike, mumidi, remi
from .midilike import EventSeq, NoteSeq
from .mumidi import MuMIDI_EventSeq
from .remi import REMI_EventSeq

__all__ = ["cp", "melody", "midilike", "mumidi", "remi", "EventSeq",
           "MuMIDI_EventSeq", "NoteSeq", "REMI_EventSeq"]
