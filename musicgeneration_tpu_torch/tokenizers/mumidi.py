"""MuMIDI (PopMAG) multi-track tokenizer (reference: mg/model/utils/MuMIDI.py).

A copy of the Python path of ``musicgeneration_tpu/tokenizers/mumidi.py``
(the port has no native scanner: ``encode_split_arrays`` is
``to_array(extract_split_events(path))`` here). It builds on the port's
REMI item stages (``Event``, ``Item``, ``_tempo_events``) and chord
inference.

Six track roles (melody/piano/bass/guitar/string/drum — MuMIDI.py:32),
position granularity 32 (+1, 1-based), track token per note, tempo/chord as
in REMI. Vocab dim 485 (MuMIDI.py:353-384):

  empty 1 | note_on 256 (128 pitch + 128 drum) | note_duration 32 |
  note_velocity 32 | bar 1 | position 33 | track 6 | tempo_class 3 |
  tempo_value 60 | chord 61

Parity quirks preserved:
* velocity binning uses searchsorted(side='right') WITHOUT the -1 used by
  REMI (MuMIDI.py:265-268),
* position is emitted only when it changes within a bar (MuMIDI.py:243-251),
* `dims_feat` aliases track token ids to their track *names* — that is what
  `filter_melody` keys on (MuMIDI.py:396-397, 484-492),
* write_midi's tempo branch overwrites the running `position` with the
  tempo-class value (MuMIDI.py:620-624) — faithful reproduction,
* decode scans only len(events)-3 tokens (MuMIDI.py:584).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import vocab
from ..midi import Instrument, Marker, MidiFile, Note, TempoChange
from .chords import MIDIChord
from .remi import Event, Item, _tempo_events

SPEC = vocab.MUMIDI

DEFAULT_FRACTION = vocab.MUMIDI_FRACTION
DEFAULT_DURATION_BINS = vocab.MUMIDI_DURATION_BINS
DEFAULT_VELOCITY_BINS = vocab.MUMIDI_VELOCITY_BINS
DEFAULT_PITCH_RANGE = vocab.MUMIDI_PITCH_RANGE
DEFAULT_DRUM_TYPE = vocab.MUMIDI_DRUM_TYPE
DEFAULT_TRACKS = vocab.MUMIDI_TRACKS
TRACKS_IDX = vocab.MUMIDI_TRACK_IDX
INSTRUMENT_NUMBERS = vocab.MUMIDI_INSTRUMENT_NUMBERS
DEFAULT_RESOLUTION = vocab.REMI_RESOLUTION
TICKS_PER_BAR = DEFAULT_RESOLUTION * 4


# ---------------------------------------------------------------------------
# Item extraction (MuMIDI.py:86-207)
# ---------------------------------------------------------------------------

def read_items(file_path: str,
               con_instr: Sequence[str] = DEFAULT_TRACKS
               ) -> Tuple[List[Item], List[Item]]:
    """Multi-track read filtered by instrument *name* (MuMIDI.py:94-96)."""
    midi = MidiFile(file_path)
    note_items: List[Item] = []
    for inst in midi.instruments:
        if inst.name not in con_instr:
            continue
        notes = sorted(inst.notes, key=lambda x: (x.start, x.pitch))
        for n in notes:
            note_items.append(Item("note", int(n.start), int(n.end),
                                   n.velocity, n.pitch, track=inst.name))
    note_items.sort(key=lambda x: x.start)

    tempo_events = sorted(midi.tempo_changes, key=lambda t: t.time)
    existing = {int(t.time): int(t.tempo) for t in tempo_events}
    max_tick = int(tempo_events[-1].time) if tempo_events else 0
    tempo_items: List[Item] = []
    last = None
    for tick in range(0, max_tick + 1, DEFAULT_RESOLUTION):
        last = existing.get(tick, last if last is not None
                            else int(tempo_events[0].tempo))
        tempo_items.append(Item("tempo", tick, pitch=last))
    if not tempo_items:
        tempo_items.append(Item("tempo", 0, pitch=120))
    return note_items, tempo_items


def quantize_items(items: List[Item], ticks: int = 120) -> List[Item]:
    if not items:
        return items
    grid_stop = max(items[-1].start, 1)
    grids = np.arange(0, grid_stop, ticks, dtype=int)
    starts = np.array([it.start for it in items])
    idx = np.argmin(np.abs(grids[None, :] - starts[:, None]), axis=1)
    shifts = grids[idx] - starts
    for item, shift in zip(items, shifts):
        item.start += int(shift)
        item.end += int(shift)
    return items


def extract_chords(items: Sequence[Item]) -> List[Item]:
    chords = MIDIChord().extract(notes=items)
    return [Item("chord", c[0], c[1], pitch=c[2].split("/")[0])
            for c in chords]


def group_items(items: List[Item], max_time: int,
                ticks_per_bar: int = TICKS_PER_BAR) -> List[list]:
    """Same sliding-pointer bar grouping as REMI, but items tie-sorted by
    (start, track) (MuMIDI.py:182)."""
    items.sort(key=lambda x: (x.start, x.track))
    downbeats = np.arange(0, max_time + ticks_per_bar, ticks_per_bar)
    groups = []
    l = r = 0
    mx = len(items)
    for db1, db2 in zip(downbeats[:-1], downbeats[1:]):
        while l < mx and items[l].start < db1:
            l += 1
        while r < mx and items[r].start <= db2:
            r += 1
        insiders = items[l:r] if l < r else []
        groups.append([db1] + insiders + [db2])
    return groups


def item2event(groups: List[list], strict: bool = False) -> List[Event]:
    events: List[Event] = []
    n_downbeat = 0
    for group in groups:
        if "note" not in [item.name for item in group[1:-1]]:
            continue
        bar_st, bar_et = group[0], group[-1]
        n_downbeat += 1
        events.append(Event("bar", None, 0, text=str(n_downbeat)))
        last_position = -1
        flags = np.linspace(bar_st, bar_et, DEFAULT_FRACTION, endpoint=False)
        for item in group[1:-1]:
            index = int(np.argmin(np.abs(flags - item.start))) + 1
            if index != last_position:
                last_position = index
                events.append(Event("position", item.start, index,
                                    text=str(item.start)))
            if item.name == "note":
                events.append(Event(f"track_{item.track}", item.start,
                                    TRACKS_IDX[item.track]))
                velocity_index = int(np.searchsorted(
                    DEFAULT_VELOCITY_BINS, item.velocity, side="right"))
                events.append(Event("note_velocity", item.start,
                                    velocity_index))
                if item.track == "drum":
                    value = (item.pitch - DEFAULT_DRUM_TYPE.start
                             + len(DEFAULT_PITCH_RANGE))
                else:
                    value = item.pitch - DEFAULT_PITCH_RANGE.start
                events.append(Event("note_on", item.start, value))
                duration = item.end - item.start
                dur_index = int(np.argmin(
                    np.abs(DEFAULT_DURATION_BINS - duration)))
                events.append(Event("note_duration", item.start, dur_index))
            elif item.name == "chord":
                events.append(Event("chord", item.start, item.pitch))
            elif item.name == "tempo":
                style, value = _tempo_events(item.start, item.pitch, strict)
                events.append(style)
                events.append(value)
    return events


# ---------------------------------------------------------------------------
# MuMIDI_EventSeq
# ---------------------------------------------------------------------------

class MuMIDI_EventSeq:
    pitch_range = DEFAULT_PITCH_RANGE
    duration_bins = DEFAULT_DURATION_BINS

    # -- vocab ----------------------------------------------------------------

    @staticmethod
    def dim() -> int:
        return SPEC.dim()

    @staticmethod
    def feat_dims():
        return SPEC.feat_dims()

    @staticmethod
    def feat_ranges():
        return SPEC.feat_ranges()

    _dims_feat_cache: Optional[Dict[int, Tuple[str, int]]] = None

    @staticmethod
    def dims_feat():
        """id -> (name, value); track ids map to their track *names*
        (MuMIDI.py:396-397)."""
        if MuMIDI_EventSeq._dims_feat_cache is not None:
            return MuMIDI_EventSeq._dims_feat_cache
        out = collections.OrderedDict()
        for name, rng in SPEC.feat_ranges().items():
            for i, idx in enumerate(rng):
                out[idx] = (DEFAULT_TRACKS[i], i) if name == "track" \
                    else (name, i)
        MuMIDI_EventSeq._dims_feat_cache = out
        return out

    @staticmethod
    def check(feat_name: str, idx) -> bool:
        return int(idx) in SPEC.feat_ranges()[feat_name]

    @staticmethod
    def get_track_id(track_name: str) -> int:
        return SPEC.feat_ranges()["track"].start + TRACKS_IDX[track_name]

    # -- encode ---------------------------------------------------------------

    @staticmethod
    def extract_events(input_path: str, strict: bool = False) -> List[Event]:
        note_items, tempo_items = read_items(input_path)
        note_items = quantize_items(note_items)
        if not note_items:
            return []
        max_time = note_items[-1].end
        chord_items = extract_chords(note_items)
        items = chord_items + tempo_items + note_items
        groups = group_items(items, max_time)
        return item2event(groups, strict=strict)

    @staticmethod
    def extract_split_events(input_path: str, strict: bool = False):
        """(melody_events, arrangement_events) or (None, None)
        (MuMIDI.py:448-475)."""
        def _one(con_instr):
            note_items, tempo_items = read_items(input_path, con_instr)
            if not note_items:
                return None
            note_items2 = quantize_items(note_items)
            max_time = note_items2[-1].end
            chord_items = extract_chords(note_items2)
            items = chord_items + tempo_items + note_items2
            groups = group_items(items, max_time)
            return item2event(groups, strict=strict)

        melody = _one(["melody"])
        if melody is None:
            return None, None
        arrange = _one(["piano", "bass", "guitar", "string", "drum"])
        if arrange is None:
            return None, None
        return melody, arrange

    @staticmethod
    def encode_split_arrays(input_path: str):
        """(melody_tokens, arrangement_tokens) as arrays, or (None, None)
        — ``to_array(extract_split_events(path))``, the corpus
        pipeline's per-file work."""
        melody, arrange = MuMIDI_EventSeq.extract_split_events(input_path)
        if melody is None:
            return None, None
        return (MuMIDI_EventSeq.to_array(melody),
                MuMIDI_EventSeq.to_array(arrange))

    @staticmethod
    def to_array(events: List[Event]) -> np.ndarray:
        ranges = SPEC.feat_ranges()
        idxs = []
        for ev in events:
            if ev.name == "chord":
                idxs.append(ranges["chord"].start + vocab.CHORD_MAP[ev.value])
            elif ev.name.startswith("track"):
                idxs.append(ranges["track"].start + int(ev.value))
            else:
                idxs.append(ranges[ev.name].start + int(ev.value))
        return np.array(idxs, dtype=SPEC.array_dtype())

    # -- decode ---------------------------------------------------------------

    @staticmethod
    def to_event(words) -> List[Event]:
        dims = MuMIDI_EventSeq.dims_feat()
        events = []
        for word in np.asarray(words, dtype=np.int64):
            name, value = dims[int(word)]
            out_value: object = value
            if name == "chord":
                out_value = vocab.INV_CHORD_MAP[value]
            if name in TRACKS_IDX:  # track token aliased to its name
                name = "track_" + DEFAULT_TRACKS[value]
            events.append(Event(name, None, out_value))
        return events

    @staticmethod
    def from_array(words) -> List[Event]:
        return MuMIDI_EventSeq.to_event(words)

    # -- sequence helpers (MuMIDI.py:484-541) ----------------------------------

    @staticmethod
    def filter_melody(arr) -> bool:
        dims = MuMIDI_EventSeq.dims_feat()
        return any(dims[int(item)][0] == "melody" for item in arr)

    @staticmethod
    def filter_event(events: List[Event], keys: Sequence[str]) -> List[Event]:
        return [ev for ev in events
                if not any(key in ev.name for key in keys)]

    @staticmethod
    def get_event(events: List[Event], keys: Sequence[str]) -> List[Event]:
        return [ev for ev in events if any(key in ev.name for key in keys)]

    @staticmethod
    def count_bar(seq) -> int:
        bar_idx = SPEC.feat_ranges()["bar"].start
        return int(np.sum(np.asarray(seq) == bar_idx))

    @staticmethod
    def segmentation(seq) -> List[np.ndarray]:
        """Split a token array into per-bar chunks starting at bar tokens;
        tokens before the first bar are dropped (MuMIDI.py:531-541)."""
        bar_idx = SPEC.feat_ranges()["bar"].start
        seq = np.asarray(seq)
        idxs = np.where(seq == bar_idx)[0]
        idxs = np.append(idxs, len(seq) + 1)
        return [seq[s:e] for s, e in zip(idxs[:-1], idxs[1:])]

    # -- decode to MIDI --------------------------------------------------------

    @staticmethod
    def write_midi(events: List[Event], output_path: str) -> MidiFile:
        temp_notes: List = []
        temp_chords: List = []
        temp_tempos: List = []
        position = -1
        track = ""
        for i in range(len(events) - 3):
            if events[i].name == "bar" and i > 0:
                temp_notes.append("bar")
                temp_chords.append("bar")
                temp_tempos.append("bar")
                track = ""
            else:
                if events[i].name == "position":
                    position = int(events[i].value) - 1
                elif events[i].name.startswith("track"):
                    track = events[i].name.split("_")[-1]
                elif (events[i].name == "note_velocity"
                      and events[i + 1].name == "note_on"
                      and events[i + 2].name == "note_duration"):
                    vel_index = min(int(events[i].value),
                                    len(DEFAULT_VELOCITY_BINS) - 1)
                    velocity = int(DEFAULT_VELOCITY_BINS[vel_index])
                    value = int(events[i + 1].value)
                    if track == "drum":
                        if value < len(DEFAULT_PITCH_RANGE):
                            value += len(DEFAULT_PITCH_RANGE)
                        pitch = (value + DEFAULT_DRUM_TYPE.start
                                 - len(DEFAULT_PITCH_RANGE))
                    else:
                        if value >= len(DEFAULT_PITCH_RANGE):
                            value -= len(DEFAULT_PITCH_RANGE)
                        pitch = value + DEFAULT_PITCH_RANGE.start
                    duration = int(
                        DEFAULT_DURATION_BINS[int(events[i + 2].value)])
                    temp_notes.append([position, velocity, pitch, duration,
                                       track])
                elif events[i].name == "chord":
                    temp_chords.append([position, events[i].value])
                elif (events[i].name == "tempo_class"
                      and events[i + 1].name == "tempo_value"):
                    # reference overwrites `position` with the class value
                    position = int(events[i].value)
                    tempo = (vocab.REMI_TEMPO_INTERVALS[
                        int(events[i].value)].start
                        + int(events[i + 1].value))
                    temp_tempos.append([position, tempo])

        def bar_flags(current_bar: int) -> np.ndarray:
            st = current_bar * TICKS_PER_BAR
            et = (current_bar + 1) * TICKS_PER_BAR
            return np.linspace(st, et, DEFAULT_FRACTION, endpoint=False,
                               dtype=int)

        notes: Dict[str, List[Note]] = collections.defaultdict(list)
        current_bar = 0
        for note in temp_notes:
            if note == "bar":
                current_bar += 1
            else:
                pos, velocity, pitch, duration, trk = note
                st = int(bar_flags(current_bar)[pos])
                notes[trk].append(Note(velocity=velocity, pitch=pitch,
                                       start=st, end=st + duration))
        chords: List = []
        current_bar = 0
        for chord in temp_chords:
            if chord == "bar":
                current_bar += 1
            else:
                pos, value = chord
                st = int(bar_flags(current_bar)[pos])
                chords.append([st, value])
        tempos: List = []
        current_bar = 0
        for tempo in temp_tempos:
            if tempo == "bar":
                current_bar += 1
            else:
                pos, value = tempo
                st = int(bar_flags(current_bar)[pos])
                tempos.append([st, value])

        midi = MidiFile(ticks_per_beat=DEFAULT_RESOLUTION)
        for trk in DEFAULT_TRACKS:
            if not notes[trk]:
                continue
            inst = Instrument(program=INSTRUMENT_NUMBERS[trk][0],
                              is_drum=(trk == "drum"), name=trk)
            inst.notes = notes[trk]
            midi.instruments.append(inst)
        midi.tempo_changes = [TempoChange(tempo=bpm, time=st)
                              for st, bpm in tempos]
        if temp_chords:
            for st, value in chords:
                midi.markers.append(Marker(text=value, time=st))
        midi.dump(output_path)
        return midi
