"""REMI tokenizer (reference: mg/model/utils/REMI.py).

A copy of ``musicgeneration_tpu/tokenizers/remi.py``: the item stages,
``item2event``, ``encode_array`` (the port's C++ pipeline,
``native/smf_scan.cc`` mg_encode_remi), ``encode_array_py`` (its
vectorised Python oracle) and ``REMI_EventSeq``. The CP and MuMIDI
codecs build on the item stages and the native tables.

Pipeline parity: read_items -> quantize_items (120-tick grid snap) ->
extract_chords -> group_items (bar windows with the reference's inclusive
boundary quirk) -> item2event; decode via write_midi reconstructing
notes/chords/tempi bar-by-bar at 480 ticks/beat assuming 4/4
(REMI.py:64-257, 539-674).

Vocab (dim 336): note_on 127 | note_duration 64 | note_velocity 4 | bar 1 |
position 16 | tempo_class 3 | tempo_value 60 | chord 61 (REMI.py:449-458).

Known reference quirks handled behind `strict=False` (default clamps instead
of crashing):
* velocity bins have 31 edges but the vocab reserves only 4 slots
  (REMI.py:19-22 vs :452) — indices >=4 would IndexError in the reference's
  `to_array`; we clamp to 3.
* pitch 127 is outside `range(0,127)` (REMI.py:17) — clamped to 126.
* tempo exactly 210 falls through every interval branch (REMI.py:237-254) —
  we treat it as fast/59.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native, vocab
from ..midi import Instrument, Marker, MidiFile, Note, TempoChange
from .chords import MIDIChord

SPEC = vocab.REMI

DEFAULT_FRACTION = vocab.REMI_FRACTION
DEFAULT_DURATION_BINS = vocab.REMI_DURATION_BINS
DEFAULT_TEMPO_INTERVALS = vocab.REMI_TEMPO_INTERVALS
DEFAULT_VELOCITY_BINS = vocab.REMI_VELOCITY_BINS
DEFAULT_RESOLUTION = vocab.REMI_RESOLUTION
TICKS_PER_BAR = DEFAULT_RESOLUTION * 4  # assume 4/4


class Item:
    """General storage for note/tempo/chord items (ticks domain)."""

    __slots__ = ("name", "start", "end", "velocity", "pitch", "track")

    def __init__(self, name, start, end=None, velocity=None, pitch=None,
                 track=""):
        self.name = name
        self.start = start
        self.end = end
        self.velocity = velocity
        self.pitch = pitch
        self.track = track

    def __repr__(self):
        return (f"Item(name={self.name}, start={self.start}, end={self.end}, "
                f"velocity={self.velocity}, pitch={self.pitch})")


@dataclasses.dataclass
class Event:
    name: str
    time: Optional[int]
    value: object
    text: Optional[str] = None

    def __repr__(self):
        return (f"Event(name={self.name}, time={self.time}, "
                f"value={self.value}, text={self.text})")


# ---------------------------------------------------------------------------
# Item extraction stages (REMI.py:64-165)
# ---------------------------------------------------------------------------

def read_items(file_path: str) -> Tuple[List[Item], List[Item]]:
    """Notes of track 0 + per-beat-expanded tempo items."""
    midi = MidiFile(file_path)
    note_items: List[Item] = []
    if midi.instruments:
        notes = sorted(midi.instruments[0].notes,
                       key=lambda x: (x.start, x.pitch))
        for n in notes:
            note_items.append(Item("note", int(n.start), int(n.end),
                                   n.velocity, n.pitch))
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
    """Snap starts to the grid, preserving duration (REMI.py:113-122).

    The reference takes argmin over an explicit grid; with uniform
    spacing that is pure arithmetic (ties snap DOWN, matching argmin's
    first-minimum rule), clipped to the last grid point < max start."""
    if not items:
        return items
    grid_stop = max(items[-1].start, 1)
    n_grids = -(-grid_stop // ticks)  # == len(arange(0, grid_stop, ticks))
    starts = np.asarray([it.start for it in items], np.int64)
    q, rem = np.divmod(starts, ticks)
    idx = np.minimum(q + (rem > ticks // 2), n_grids - 1)
    shifts = idx * ticks - starts
    for item, shift in zip(items, shifts):
        item.start += int(shift)
        item.end += int(shift)
    return items


def extract_chords(items: Sequence[Item]) -> List[Item]:
    chords = MIDIChord().extract(notes=items)
    return [Item("chord", chord[0], chord[1],
                 pitch=chord[2].split("/")[0]) for chord in chords]


def group_items(items: List[Item], max_time: int,
                ticks_per_bar: int = TICKS_PER_BAR) -> List[list]:
    """Bar grouping with the reference's sliding l/r pointers — items that
    land exactly on a downbeat appear in BOTH adjacent bars (REMI.py:139-165).
    """
    items.sort(key=lambda x: x.start)
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


def _tempo_events(start: int, tempo: int, strict: bool) -> Tuple[Event, Event]:
    iv = DEFAULT_TEMPO_INTERVALS
    if tempo in iv[0]:
        return (Event("tempo_class", start, 0),
                Event("tempo_value", start, tempo - iv[0].start))
    if tempo in iv[1]:
        return (Event("tempo_class", start, 1),
                Event("tempo_value", start, tempo - iv[1].start))
    if tempo in iv[2]:
        return (Event("tempo_class", start, 2),
                Event("tempo_value", start, tempo - iv[2].start))
    if tempo < iv[0].start:
        return (Event("tempo_class", start, 0), Event("tempo_value", start, 0))
    # reference only handles tempo > iv[2].stop; ==210 falls through
    if strict and tempo == iv[2].stop:
        raise ValueError(f"tempo {tempo} unhandled by reference intervals")
    return (Event("tempo_class", start, 2), Event("tempo_value", start, 59))


def item2event(groups: List[list], strict: bool = False) -> List[Event]:
    events: List[Event] = []
    n_downbeat = 0
    for group in groups:
        insiders = group[1:-1]
        if not any(item.name == "note" for item in insiders):
            continue
        bar_st, bar_et = group[0], group[-1]
        n_downbeat += 1
        events.append(Event("bar", None, 0, text=str(n_downbeat)))
        flags = np.linspace(bar_st, bar_et, DEFAULT_FRACTION, endpoint=False)
        # vectorize the per-item argmin/searchsorted over the whole bar
        # (identical tie semantics: argmin picks the first minimum)
        starts = np.array([it.start for it in insiders])
        pos_idx = np.argmin(np.abs(flags[None, :] - starts[:, None]),
                            axis=1)
        note_rows = [i for i, it in enumerate(insiders)
                     if it.name == "note"]
        if note_rows:
            vels = np.array([insiders[i].velocity for i in note_rows])
            durs = np.array([insiders[i].end - insiders[i].start
                             for i in note_rows])
            vel_idx = DEFAULT_VELOCITY_BINS.searchsorted(vels, "right") - 1
            dur_idx = np.argmin(
                np.abs(DEFAULT_DURATION_BINS[None, :] - durs[:, None]),
                axis=1)
            note_q = {i: (int(v), int(d)) for i, v, d
                      in zip(note_rows, vel_idx, dur_idx)}
        for i, item in enumerate(insiders):
            events.append(Event("position", item.start, int(pos_idx[i]),
                                text=str(item.start)))
            if item.name == "note":
                velocity_index, dur_index = note_q[i]
                events.append(Event("note_velocity", item.start,
                                    velocity_index))
                events.append(Event("note_on", item.start, item.pitch))
                events.append(Event("note_duration", item.start, dur_index))
            elif item.name == "chord":
                events.append(Event("chord", item.start, item.pitch))
            elif item.name == "tempo":
                style, value = _tempo_events(item.start, item.pitch, strict)
                events.append(style)
                events.append(value)
    return events


# the native emitters' tables: the tempo interval edges (30, 90, 150,
# 210) and the chord ids, chord_ids[quality * 12 + root] then N:N
TEMPO_BOUNDS = (DEFAULT_TEMPO_INTERVALS[0].start,
                DEFAULT_TEMPO_INTERVALS[1].start,
                DEFAULT_TEMPO_INTERVALS[2].start,
                DEFAULT_TEMPO_INTERVALS[2].stop)
CHORD_IDS = np.array([vocab.CHORD_MAP[f"{r}:{q}"]
                      for q in vocab.CHORD_QUALITY
                      for r in vocab.CHORD_ROOT]
                     + [vocab.CHORD_MAP["N:N"]], np.int64)


def encode_array(path: str) -> np.ndarray:
    """`to_array(extract_events(path))` — the corpus-pipeline hot path.

    The full C++ pipeline (``native_array``), and the vectorized Python
    path below, the semantics oracle, under MG_NATIVE=0 or where the C++
    reports an error for the file."""
    if os.environ.get("MG_NATIVE", "1") != "0":
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            data = None
        if data is not None:
            toks = native_array(data)
            if toks is not None:
                return toks
    return encode_array_py(path)


def native_array(data: bytes) -> Optional[np.ndarray]:
    """The REMI ids of one SMF buffer through the C++ pipeline
    (native/smf_scan.cc mg_encode_remi: parse -> quantize -> chord
    inference -> bar grouping -> tokens), or None where it reports a
    parse or tempo error."""
    ranges = SPEC.feat_ranges()
    toks = native.encode_remi(
        data, DEFAULT_DURATION_BINS, DEFAULT_VELOCITY_BINS,
        DEFAULT_RESOLUTION, vocab.REMI_FRACTION,
        vocab.REMI_VELOCITY_STEPS, len(vocab.REMI_PITCH_RANGE) - 1,
        TEMPO_BOUNDS, CHORD_IDS,
        (ranges["note_on"].start, ranges["note_duration"].start,
         ranges["note_velocity"].start, ranges["bar"].start,
         ranges["position"].start, ranges["tempo_class"].start,
         ranges["tempo_value"].start, ranges["chord"].start))
    return None if toks is None else toks.astype(SPEC.array_dtype())


def encode_array_py(path: str) -> np.ndarray:
    """`to_array(extract_events(path))` without Event objects — fully
    vectorized after chord inference; the native path's oracle.

    Replicates group_items + item2event + to_array semantics exactly
    (downbeat double-count, argmin position ties snapping down, the
    velocity<4 -> last-slot quirk, pitch/velocity clamps of the default
    non-strict mode).
    """
    note_items, tempo_items = read_items(path)
    note_items = quantize_items(note_items)
    if not note_items:
        return np.zeros(0, SPEC.array_dtype())
    max_time = note_items[-1].end
    chord_items = extract_chords(note_items)
    items = chord_items + tempo_items + note_items
    items.sort(key=lambda x: x.start)  # stable, like group_items

    n = len(items)
    kind = np.empty(n, np.int8)  # 0 chord, 1 tempo, 2 note
    start = np.empty(n, np.int64)
    payload = np.zeros((n, 3), np.int64)  # per-kind token ids (post-pos)
    ranges = SPEC.feat_ranges()
    on0 = ranges["note_on"].start
    dur0 = ranges["note_duration"].start
    vel0 = ranges["note_velocity"].start
    bar_id = ranges["bar"].start
    pos0 = ranges["position"].start
    tc0 = ranges["tempo_class"].start
    tv0 = ranges["tempo_value"].start
    ch0 = ranges["chord"].start
    iv = DEFAULT_TEMPO_INTERVALS
    for i, it in enumerate(items):
        start[i] = it.start
        if it.name == "note":
            kind[i] = 2
        elif it.name == "tempo":
            kind[i] = 1
            t = it.pitch
            if t in iv[0]:
                payload[i, :2] = (tc0, tv0 + t - iv[0].start)
            elif t in iv[1]:
                payload[i, :2] = (tc0 + 1, tv0 + t - iv[1].start)
            elif t in iv[2]:
                payload[i, :2] = (tc0 + 2, tv0 + t - iv[2].start)
            elif t < iv[0].start:
                payload[i, :2] = (tc0, tv0)
            else:  # >= 210 (the ==210 reference fall-through, non-strict)
                payload[i, :2] = (tc0 + 2, tv0 + 59)
        else:
            kind[i] = 0
            payload[i, 0] = ch0 + vocab.CHORD_MAP[it.pitch]
    note_mask = kind == 2
    if note_mask.any():
        vels = np.array([it.velocity for it, m in zip(items, note_mask)
                         if m], np.int64)
        durs = np.array([it.end - it.start
                         for it, m in zip(items, note_mask) if m],
                        np.int64)
        pitches = np.minimum(
            np.array([it.pitch for it, m in zip(items, note_mask) if m],
                     np.int64), len(vocab.REMI_PITCH_RANGE) - 1)
        vi = DEFAULT_VELOCITY_BINS.searchsorted(vels, "right") - 1
        vi = np.where((vi >= 0) & (vi < vocab.REMI_VELOCITY_STEPS), vi,
                      vocab.REMI_VELOCITY_STEPS - 1)
        di = np.argmin(np.abs(DEFAULT_DURATION_BINS[None, :]
                              - durs[:, None]), axis=1)
        payload[note_mask, 0] = vel0 + vi
        payload[note_mask, 1] = on0 + pitches
        payload[note_mask, 2] = dur0 + di

    # bar assignment with the downbeat double-count: an item at exactly a
    # downbeat belongs to the bar it ENDS (as its last item) and the bar
    # it starts (group_items' l/r pointer semantics, REMI.py:139-165)
    bar = start // TICKS_PER_BAR
    dup = (start % TICKS_PER_BAR == 0) & (start > 0)
    idx_all = np.concatenate([np.arange(n), np.nonzero(dup)[0]])
    bar_all = np.concatenate([bar, bar[dup] - 1])
    # order: (bar, start, original concat position) — matches per-bar
    # slices of the stable start-sorted list
    order = np.lexsort((idx_all, start[idx_all], bar_all))
    idx_all, bar_all = idx_all[order], bar_all[order]

    # keep only bars containing at least one note
    note_bars = np.unique(bar_all[kind[idx_all] == 2])
    keep = np.isin(bar_all, note_bars)
    idx_all, bar_all = idx_all[keep], bar_all[keep]
    if not len(idx_all):
        return np.zeros(0, SPEC.array_dtype())

    k = kind[idx_all]
    n_tok = np.where(k == 2, 4, np.where(k == 1, 3, 2))
    is_bar_start = np.empty(len(idx_all), bool)
    is_bar_start[0] = True
    is_bar_start[1:] = bar_all[1:] != bar_all[:-1]
    offs = np.cumsum(n_tok + is_bar_start) - n_tok  # first POS slot
    total = int(offs[-1] + n_tok[-1])
    out = np.zeros(total, np.int64)
    out[offs[is_bar_start] - 1] = bar_id
    # position tokens (argmin over the 120-tick flags; exact-half ties
    # snap DOWN like argmin's first-minimum; start==next downbeat -> 15)
    step = TICKS_PER_BAR // vocab.REMI_FRACTION
    rel = start[idx_all] - bar_all * TICKS_PER_BAR
    q, r = np.divmod(rel, step)
    pos_idx = np.minimum(q + (r > step // 2), vocab.REMI_FRACTION - 1)
    out[offs] = pos0 + pos_idx
    for count, width in ((2, 1), (3, 2), (4, 3)):
        rows = n_tok == count
        for j in range(width):
            out[offs[rows] + 1 + j] = payload[idx_all[rows], j]
    return out.astype(SPEC.array_dtype())


# ---------------------------------------------------------------------------
# REMI_EventSeq
# ---------------------------------------------------------------------------

class REMI_EventSeq:
    pitch_range = vocab.REMI_PITCH_RANGE
    velocity_steps = vocab.REMI_VELOCITY_STEPS
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

    @staticmethod
    def dims_feat():
        return SPEC.dims_feat()

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
    def to_array(events: List[Event], strict: bool = False) -> np.ndarray:
        ranges = SPEC.feat_ranges()
        idxs = []
        for ev in events:
            if ev.name == "chord":
                idxs.append(ranges["chord"].start + vocab.CHORD_MAP[ev.value])
            else:
                rng = ranges[ev.name]
                value = int(ev.value)
                if value >= len(rng):
                    if strict:
                        raise IndexError(
                            f"{ev.name} value {value} out of vocab range")
                    value = len(rng) - 1
                elif value < 0:
                    # reference indexes a range object, so value=-1 (the
                    # velocity<4 searchsorted quirk, REMI.py:206-209) maps
                    # to the feature's LAST slot (range(a,b)[-1] == b-1)
                    value = max(len(rng) + value, 0)
                idxs.append(rng.start + value)
        return np.array(idxs, dtype=SPEC.array_dtype())

    # -- decode ---------------------------------------------------------------

    @staticmethod
    def to_event(words) -> List[Event]:
        feat_idx, values = SPEC.decode_ids(np.asarray(words, dtype=np.int64))
        names = SPEC.names
        events = []
        for f, v in zip(feat_idx, values):
            name = names[f]
            value: object = int(v)
            if name == "chord":
                value = vocab.INV_CHORD_MAP[int(v)]
            events.append(Event(name, None, value))
        return events

    @staticmethod
    def from_array(words) -> List[Event]:
        return REMI_EventSeq.to_event(words)

    @staticmethod
    def write_midi(events: List[Event], output_path: str,
                   prompt_path: Optional[str] = None) -> MidiFile:
        """Reconstruct a MIDI file (REMI.py:539-674). NOTE: the reference
        scans only len(events)-3 entries, silently dropping trailing tokens —
        kept for parity."""
        temp_notes: List = []
        temp_chords: List = []
        temp_tempos: List = []
        for i in range(len(events) - 3):
            if events[i].name == "bar" and i > 0:
                temp_notes.append("bar")
                temp_chords.append("bar")
                temp_tempos.append("bar")
            elif (events[i].name == "position"
                  and events[i + 1].name == "note_velocity"
                  and events[i + 2].name == "note_on"
                  and events[i + 3].name == "note_duration"):
                position = int(events[i].value)
                velocity = int(DEFAULT_VELOCITY_BINS[int(events[i + 1].value)])
                pitch = int(events[i + 2].value)
                duration = int(DEFAULT_DURATION_BINS[int(events[i + 3].value)])
                temp_notes.append([position, velocity, pitch, duration])
            elif (events[i].name == "position"
                  and events[i + 1].name == "chord"):
                temp_chords.append([int(events[i].value), events[i + 1].value])
            elif (events[i].name == "position"
                  and events[i + 1].name == "tempo_class"
                  and events[i + 2].name == "tempo_value"):
                position = int(events[i].value)
                tempo = (DEFAULT_TEMPO_INTERVALS[int(events[i + 1].value)].start
                         + int(events[i + 2].value))
                temp_tempos.append([position, tempo])

        def bar_flags(current_bar: int) -> np.ndarray:
            st = current_bar * TICKS_PER_BAR
            et = (current_bar + 1) * TICKS_PER_BAR
            return np.linspace(st, et, DEFAULT_FRACTION, endpoint=False,
                               dtype=int)

        notes: List[Note] = []
        current_bar = 0
        for note in temp_notes:
            if note == "bar":
                current_bar += 1
            else:
                position, velocity, pitch, duration = note
                st = int(bar_flags(current_bar)[position])
                notes.append(Note(velocity=velocity, pitch=pitch,
                                  start=st, end=st + duration))
        chords: List = []
        current_bar = 0
        for chord in temp_chords:
            if chord == "bar":
                current_bar += 1
            else:
                position, value = chord
                st = int(bar_flags(current_bar)[position])
                chords.append([st, value])
        tempos: List = []
        current_bar = 0
        for tempo in temp_tempos:
            if tempo == "bar":
                current_bar += 1
            else:
                position, value = tempo
                st = int(bar_flags(current_bar)[position])
                tempos.append([st, value])

        if prompt_path:
            midi = MidiFile(prompt_path)
            last_time = DEFAULT_RESOLUTION * 4 * 4
            for note in notes:
                note.start += last_time
                note.end += last_time
            midi.instruments[0].notes.extend(notes)
            kept = [t for t in midi.tempo_changes if t.time < last_time]
            for st, bpm in tempos:
                kept.append(TempoChange(tempo=bpm, time=st + last_time))
            midi.tempo_changes = kept
            if temp_chords:
                for st, value in chords:
                    midi.markers.append(Marker(text=value,
                                               time=st + last_time))
        else:
            midi = MidiFile(ticks_per_beat=DEFAULT_RESOLUTION)
            inst = Instrument(0, is_drum=False)
            inst.notes = notes
            midi.instruments.append(inst)
            midi.tempo_changes = [TempoChange(tempo=bpm, time=st)
                                  for st, bpm in tempos]
            if temp_chords:
                for st, value in chords:
                    midi.markers.append(Marker(text=value, time=st))
        midi.dump(output_path)
        return midi
