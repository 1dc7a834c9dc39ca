"""Sustain-pedal-aware MIDI-like codec (vocab 388) — the port's copy.

A copy of ``musicgeneration_tpu/tokenizers/pedal_midilike.py``'s Python
path on the port's own ``midi/`` (the native branch of
``encode_array`` is not ported).

The reference carries a second, independent MIDI-like encoder used only by
the MusicTransformer lineage: `mg/model/MusicTransformer/processor.py`.
Its vocabulary differs from `EventSeq` (tokenizers/midilike.py, dim 308):

    note_on     0..127   (full 128-pitch range, processor.py:4,9-14)
    note_off  128..255
    time_shift 256..355  (100 bins of 10 ms, value v = (v+1)*10ms)
    velocity  356..387   (32 bins, vel // 4, processor.py:128)

and it models **sustain pedal (CC64)**: while the pedal is down, note ends
are extended to the next onset of the same pitch, or to the pedal release
(processor.py:23-39 SustainDownManager.transposition_notes, applied in
reverse note order).  This explains the reference MusicTransformer's
default `vocab_size = 388 + 2` (pad + eos, MusicTransformer/network.py:15).

Faithfulness notes (reference quirks, SURVEY.md §7 hard-part #1):

* The reference compares the **raw previous velocity** against the
  quantized current one when deciding to emit a velocity event
  (`cur_vel = snote.velocity` at processor.py:228 vs `prev_vel !=
  snote.velocity // 4` at processor.py:128-129) — so a velocity token is
  emitted before nearly every note_on.  Replicated (it defines token
  parity).
* `_note_preprocess` (processor.py:181-199) **drops every note** of an
  instrument that has no sustain CCs, drops notes after the last pedal
  release, and duplicates notes when a sustain window covers the tail of
  the note list.  These are data-loss bugs; the default here keeps all
  notes (pass `faithful=True` to replicate the reference's exact
  behavior for parity experiments).
* Decode keeps the last note_on per pitch alive after an off, so repeated
  offs re-close against the same on (processor.py:104-122).  Replicated.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..midi import ControlChange, Instrument, MidiFile, Note, TempoChange

RANGE_NOTE_ON = 128
RANGE_NOTE_OFF = 128
RANGE_TIME_SHIFT = 100
RANGE_VEL = 32

START_NOTE_ON = 0
START_NOTE_OFF = RANGE_NOTE_ON
START_TIME_SHIFT = RANGE_NOTE_ON + RANGE_NOTE_OFF
START_VELOCITY = START_TIME_SHIFT + RANGE_TIME_SHIFT

VOCAB_SIZE = START_VELOCITY + RANGE_VEL  # 388
PAD_ID = VOCAB_SIZE          # reference MusicTransformer pads at 388
EOS_ID = VOCAB_SIZE + 1      # vocab_size = 388 + 2 (network.py:15)


class _Sustain:
    """One pedal-down window [start, end) with the notes it governs."""

    def __init__(self, start: float, end: Optional[float]):
        self.start = start
        self.end = end
        self.managed: List[Note] = []

    def extend_notes(self) -> None:
        # reverse order: each note's end becomes the next onset of the
        # same pitch (or the pedal release, if that is later than the
        # written end) — processor.py:33-39
        next_start_by_pitch = {}
        for note in reversed(self.managed):
            if note.pitch in next_start_by_pitch:
                note.end = next_start_by_pitch[note.pitch]
            else:
                note.end = max(self.end, note.end)
            next_start_by_pitch[note.pitch] = note.start


def _pair_sustains(ccs: Sequence[ControlChange]) -> List[_Sustain]:
    """Pair CC64 down(>=64)/up(<64) transitions — processor.py:163-178."""
    sustains: List[_Sustain] = []
    current: Optional[_Sustain] = None
    for cc in ccs:
        if cc.value >= 64 and current is None:
            current = _Sustain(cc.time, None)
        elif cc.value < 64 and current is not None:
            current.end = cc.time
            sustains.append(current)
            current = None
        elif cc.value < 64 and sustains:
            sustains[-1].end = cc.time
    return sustains


def _apply_sustains(sustains: List[_Sustain], notes: List[Note],
                    faithful: bool) -> List[Note]:
    """Extend pedal-governed note ends; route other notes through.

    `faithful=True` transliterates processor.py:181-199 including its
    note-dropping/duplication; the default keeps every note exactly once.
    """
    if faithful:
        stream: List[Note] = []
        remaining = notes
        for sustain in sustains:
            for idx, note in enumerate(remaining):
                if note.start < sustain.start:
                    stream.append(note)
                elif note.start > sustain.end:
                    remaining = remaining[idx:]
                    sustain.extend_notes()
                    break
                else:
                    sustain.managed.append(note)
        for sustain in sustains:
            stream += sustain.managed
        stream.sort(key=lambda n: n.start)
        return stream

    if not sustains:
        return sorted(notes, key=lambda n: n.start)
    stream = []
    si = 0
    for note in sorted(notes, key=lambda n: n.start):
        while si < len(sustains) and note.start > sustains[si].end:
            si += 1
        if si < len(sustains) and sustains[si].start <= note.start:
            sustains[si].managed.append(note)
        else:
            stream.append(note)
    for sustain in sustains:
        sustain.extend_notes()
        stream += sustain.managed
    stream.sort(key=lambda n: n.start)
    return stream


def _time_shift_tokens(prev: float, post: float) -> List[int]:
    """10 ms-grid time shift run — processor.py:151-160."""
    interval = int(round((post - prev) * 100))
    out = []
    while interval >= RANGE_TIME_SHIFT:
        out.append(START_TIME_SHIFT + RANGE_TIME_SHIFT - 1)
        interval -= RANGE_TIME_SHIFT
    if interval > 0:
        out.append(START_TIME_SHIFT + interval - 1)
    return out


def encode_array(path: str, faithful: bool = False) -> np.ndarray:
    """`np.asarray(encode_midi(path))` as uint16: the corpus pipeline's
    entry. The Python path only (the JAX package's native C++ branch is
    not ported; its tokens equal this path's)."""
    return np.asarray(encode_midi(path, faithful=faithful), np.uint16)


def encode_midi(path_or_midi, faithful: bool = False) -> List[int]:
    """MIDI file -> token ids (reference processor.py:202-230)."""
    midi = path_or_midi
    if isinstance(path_or_midi, str):
        midi = MidiFile(path_or_midi).to_seconds()
    notes: List[Note] = []
    for inst in midi.instruments:
        pedal = [c for c in inst.control_changes if c.number == 64]
        sustains = _pair_sustains(pedal)
        inst_notes = [Note(n.velocity, n.pitch, n.start, n.end)
                      for n in sorted(inst.notes, key=lambda n: n.start)]
        notes += _apply_sustains(sustains, inst_notes, faithful)

    # split into on/off point events, stable-sorted by time
    points = []  # (time, is_off, pitch, velocity)
    for note in sorted(notes, key=lambda n: n.start):
        points.append((note.start, 0, note.pitch, note.velocity))
        points.append((note.end, 1, note.pitch, None))
    points.sort(key=lambda p: p[0])

    tokens: List[int] = []
    cur_time = 0.0
    cur_vel: Optional[int] = 0  # raw-velocity state, processor.py:221,228
    for time, is_off, pitch, vel in points:
        tokens += _time_shift_tokens(cur_time, time)
        if vel is not None:
            qvel = vel // 4
            if cur_vel != qvel:
                tokens.append(START_VELOCITY + qvel)
        tokens.append((START_NOTE_OFF if is_off else START_NOTE_ON) + pitch)
        cur_time = time
        cur_vel = vel
    return tokens


def decode_midi(ids: Sequence[int], path: Optional[str] = None,
                program: int = 1, resolution: int = 480,
                tempo: int = 120, faithful: bool = False) -> MidiFile:
    """Token ids -> MIDI (reference processor.py:233-248).

    Vectorized: the timeline is a cumsum over per-token time deltas, the
    velocity state a forward-fill — no Python-per-token state machine.

    DOCUMENTED DEVIATION: ids outside [0, VOCAB_SIZE) are dropped here,
    whereas the reference's Event.from_int (processor.py) funnels ANY id
    >= 356 into the velocity branch (so pad=388 decodes as velocity 128).
    Treating pad/eos sampled mid-sequence as phantom velocity events is a
    bug, not a musical quirk; sanitizing is deliberate and noted per the
    repo's "never fix a quirk silently" rule. Pass faithful=True to keep
    the reference behavior.
    """
    arr = np.asarray(ids, dtype=np.int64)
    if faithful:
        # reference from_int (processor.py:72-89): the else-branch maps
        # ANY id >= 356 to velocity value (id - 356), so pad=388 decodes
        # as velocity (388-356)*4 = 128. Keep them as velocity tokens.
        arr = arr[arr >= 0]
    else:
        arr = arr[(arr >= 0) & (arr < VOCAB_SIZE)]

    is_shift = (arr >= START_TIME_SHIFT) & (arr < START_VELOCITY)
    is_vel = arr >= START_VELOCITY
    is_on = arr < START_NOTE_OFF
    is_off = (arr >= START_NOTE_OFF) & (arr < START_TIME_SHIFT)

    deltas = np.where(is_shift, (arr - START_TIME_SHIFT + 1) / 100.0, 0.0)
    # a note token contributes zero delta, so the inclusive cumsum at a
    # note position equals the sum of all shifts before it
    timeline = np.cumsum(deltas)

    vel_vals = np.where(is_vel, (arr - START_VELOCITY) * 4, -1)
    # forward-fill the velocity state (0 before the first velocity token)
    idx = np.where(vel_vals >= 0, np.arange(len(arr)), -1)
    np.maximum.accumulate(idx, out=idx)
    velocity = np.where(idx >= 0, vel_vals[np.maximum(idx, 0)], 0)

    notes: List[Note] = []
    open_by_pitch = {}  # pitch -> (time, velocity); kept after close
    for i in np.nonzero(is_on | is_off)[0]:
        tok = int(arr[i])
        t = float(timeline[i])
        if tok < START_NOTE_OFF:
            open_by_pitch[tok] = (t, int(velocity[i]))
        else:
            pitch = tok - START_NOTE_OFF
            if pitch in open_by_pitch:
                on_t, on_v = open_by_pitch[pitch]
                if t > on_t:
                    notes.append(Note(on_v, pitch, on_t, t))
            # reference keeps the dict entry (processor.py:111-119)

    notes.sort(key=lambda n: n.start)
    midi = MidiFile(ticks_per_beat=resolution)
    midi.tempo_changes = [TempoChange(tempo=tempo, time=0)]
    midi._tempo_raw = [(0, int(round(60e6 / tempo)))]
    inst = Instrument(program, False, "pedal_midilike")
    tick_per_sec = resolution * tempo / 60.0
    inst.notes = [Note(velocity=n.velocity, pitch=n.pitch,
                       start=int(round(n.start * tick_per_sec)),
                       end=int(round(n.end * tick_per_sec)))
                  for n in notes]
    midi.instruments.append(inst)
    if path is not None:
        midi.dump(path)
    return midi


def to_array(ids: Sequence[int]) -> np.ndarray:
    return np.asarray(ids, dtype=np.uint16)


def from_array(arr) -> List[int]:
    return [int(x) for x in np.asarray(arr)]


def token_type(token_id: int) -> str:
    if token_id < START_NOTE_OFF:
        return "note_on"
    if token_id < START_TIME_SHIFT:
        return "note_off"
    if token_id < START_VELOCITY:
        return "time_shift"
    if token_id < VOCAB_SIZE:
        return "velocity"
    return "special"
