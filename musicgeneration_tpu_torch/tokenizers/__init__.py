"""Token codecs of the torch port: MIDI-like, and REMI and CP (with the
chord inference they share)."""

from . import cp, midilike, remi
from .midilike import EventSeq, NoteSeq
from .remi import REMI_EventSeq

__all__ = ["cp", "midilike", "remi", "EventSeq", "NoteSeq", "REMI_EventSeq"]
