"""Monophonic melody note-array codec and melody extraction.

A copy of ``musicgeneration_tpu/tokenizers/melody.py``'s Python path (its
native parse branch is left out), on the port's own ``midi/``. The
note-array codec (Magenta Melody-RNN format; reference
mg/utils/midi2note.py:6-11) holds one int per sixteenth note:

    0..127  note-on at that MIDI pitch
    128     note-off (stop the previous note)
    129     no event (sustain whatever is sounding)

The encoder (midi2note.py:13-42) flattens every non-drum part, snaps note
offsets and durations to the semiquaver grid with round(), keeps only the
highest pitch per grid slot, and writes a note-off at pos + dur that a
later onset may overwrite. The decoder (midi2note.py:44-71) lets the
element at grid index i last until the next index that is not a
no-event.

Melody extraction (reference mg/utils/music_extraction.py):

    skyline(midi)  the highest-pitch note per onset group, truncated at
                   the next onset (music_extraction.py:12-46);
    top(midi)      accepts notes in descending pitch order while their
                   overlap ratio with the accepted ones stays <= the
                   threshold (music_extraction.py:49-79).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ..midi import Instrument, MidiFile, Note, TempoChange

MELODY_NOTE_OFF = 128
MELODY_NO_EVENT = 129
MELODY_VOCAB = 130  # reference train_basic_rnn.py:30


def midi_to_note_array(midi: Union[str, MidiFile],
                       instr_idx: Optional[int] = None) -> np.ndarray:
    """MIDI -> Melody-RNN int16 array, one slot per sixteenth note.

    ``instr_idx=None`` flattens every non-drum instrument (music21
    ``stream.flat``); an int takes that instrument only."""
    if isinstance(midi, str):
        midi = MidiFile(midi)
    sq = midi.ticks_per_beat / 4.0  # ticks per semiquaver

    insts = (midi.instruments if instr_idx is None
             else [midi.instruments[instr_idx]])
    notes = [n for inst in insts if not inst.is_drum for n in inst.notes]
    if not notes:
        return np.full(2, MELODY_NO_EVENT, dtype=np.int16)

    pos = np.array([int(round(n.start / sq)) for n in notes])
    dur = np.array([int(round((n.end - n.start) / sq)) for n in notes])
    pitch = np.array([n.pitch for n in notes])
    total = int(round(max(n.end for n in notes) / sq))
    return _note_array_from_columns(pos, dur, pitch, total)


def _note_array_from_columns(pos, dur, pitch, total) -> np.ndarray:
    # the highest pitch per grid slot (the reference sorts (pos asc,
    # pitch desc), then drop_duplicates(pos): midi2note.py:30-31)
    order = np.lexsort((-pitch, pos))
    pos, dur, pitch = pos[order], dur[order], pitch[order]
    first = np.concatenate([[True], pos[1:] != pos[:-1]])
    pos, dur, pitch = pos[first], dur[first], pitch[first]

    out = np.full(total + 2, MELODY_NO_EVENT, dtype=np.int16)
    # writes in ascending pos: the note-off at pos + dur; a later onset on
    # the same slot overwrites the off, and a zero-duration note clobbers
    # its own onset (midi2note.py:36-40)
    off_slots = np.minimum(pos + dur, total + 1)
    for p, o, pt in zip(pos, off_slots, pitch):
        if p < total:
            out[p] = pt
            out[o] = MELODY_NOTE_OFF
    return out


def note_array_to_midi(arr, path: Optional[str] = None,
                       tempo: float = 120.0, resolution: int = 480,
                       program: int = 0) -> MidiFile:
    """Melody-RNN int array -> MIDI (written to ``path`` if given).

    The element at grid index i sounds until the next index that is not
    a no-event (midi2note.py:52: durations are the differences of the
    surviving indices; the last element gets one semiquaver)."""
    arr = np.asarray(arr)
    sq = resolution // 4
    idx = np.nonzero(arr != MELODY_NO_EVENT)[0]
    midi = MidiFile(ticks_per_beat=resolution)
    midi.tempo_changes = [TempoChange(tempo=tempo, time=0)]
    midi._tempo_raw = [(0, int(round(60e6 / tempo)))]
    inst = Instrument(program, False, "melody")
    if idx.size:
        ends = np.concatenate([idx[1:], [idx[-1] + 1]])
        for i, e in zip(idx, ends):
            code = int(arr[i])
            if 0 <= code < MELODY_NOTE_OFF:
                inst.notes.append(Note(velocity=100, pitch=code,
                                       start=int(i) * sq, end=int(e) * sq))
    midi.instruments.append(inst)
    if path is not None:
        midi.dump(path)
    return midi


def skyline(midi: Union[str, MidiFile], instr_idx: int = 0) -> MidiFile:
    """Skyline melody extraction: per onset, keep the highest pitch and
    truncate it at the next onset (music_extraction.py:12-46)."""
    if isinstance(midi, str):
        midi = MidiFile(midi)
    notes = sorted(midi.instruments[instr_idx].notes,
                   key=lambda n: (n.start, -n.pitch))
    out_notes: List[Note] = []
    starts: List[float] = []
    for n in notes:
        if starts and n.start == starts[-1]:
            continue  # a lower pitch at the same onset
        starts.append(n.start)
        out_notes.append(Note(n.velocity, n.pitch, n.start, n.end))
    for i in range(len(out_notes) - 1):
        out_notes[i].end = min(out_notes[i].end, out_notes[i + 1].start)
    return _single_track(midi, out_notes)


def top(midi: Union[str, MidiFile], instr_idx: int = 0,
        top_thres: float = 0.5) -> MidiFile:
    """Time-overlap (TOP) melody extraction (music_extraction.py:49-79)."""
    if isinstance(midi, str):
        midi = MidiFile(midi)
    notes = sorted(midi.instruments[instr_idx].notes,
                   key=lambda n: n.pitch, reverse=True)
    accepted: List[Note] = []
    for n in notes:
        overlap = sum(max(0.0, min(n.end, a.end) - max(n.start, a.start))
                      for a in accepted)
        if n.end > n.start and overlap / (n.end - n.start) <= top_thres:
            accepted.append(Note(n.velocity, n.pitch, n.start, n.end))
    accepted.sort(key=lambda n: n.start)
    return _single_track(midi, accepted)


def _single_track(src: MidiFile, notes: List[Note]) -> MidiFile:
    out = MidiFile(ticks_per_beat=src.ticks_per_beat)
    out.tempo_changes = list(src.tempo_changes)
    out._tempo_raw = list(getattr(src, "_tempo_raw", []))
    out.markers = list(getattr(src, "markers", []))
    track = Instrument(0, False, "piano")
    track.notes = notes
    out.instruments = [track]
    return out
