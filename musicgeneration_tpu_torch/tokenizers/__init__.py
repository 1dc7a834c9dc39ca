"""Token codecs of the torch port (MIDI-like only, for now)."""

from . import midilike
from .midilike import EventSeq, NoteSeq

__all__ = ["midilike", "EventSeq", "NoteSeq"]
