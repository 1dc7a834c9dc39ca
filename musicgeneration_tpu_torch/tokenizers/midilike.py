"""MIDI-like (Performance-RNN style) tokenizer — the port's codec.

A copy of the parts of ``musicgeneration_tpu/tokenizers/midilike.py``
that generation needs (``NoteSeq``, ``EventSeq``, ``extract_events``,
``from_array``, ``write_midi``), with the same token semantics as the
reference (mg/model/utils/sequence.py):

* vocab: note_on(88) | note_off(88) | velocity(32) | time_shift(100x10ms),
  dim 308 (sequence.py:204-212),
* greedy time-shift emission with searchsorted(side='right')-1 binning
  (sequence.py:174-181),
* decode replays events, clamping note length to MIN_NOTE_LENGTH
  (sequence.py:243-281).

and PerformanceRNN's conditioning controls (``Control``, ``ControlSeq``,
midilike.py:259-406 there): a 4-beat sliding window's pitch-class
histogram and note density per event, 24 values per control.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .. import vocab
from ..midi import Instrument, MidiFile, Note, TempoChange

SPEC = vocab.MIDILIKE
CONTROL_SPEC = vocab.CONTROL

DEFAULT_SAVING_PROGRAM = 1
DEFAULT_LOADING_PROGRAMS = range(128)
DEFAULT_RESOLUTION = 220


@dataclasses.dataclass
class Event:
    type: str
    time: float
    value: int

    def __repr__(self) -> str:
        return f"Event(type={self.type}, time={self.time}, value={self.value})"


class NoteSeq:
    """Flat list of seconds-domain notes (reference: sequence.py:43-119)."""

    def __init__(self, notes: Optional[List[Note]] = None):
        self.notes: List[Note] = []
        if notes:
            self.add_notes([n for n in notes if n.end >= n.start])

    @staticmethod
    def from_midi(midi: MidiFile,
                  programs=DEFAULT_LOADING_PROGRAMS) -> "NoteSeq":
        notes = [
            n
            for inst in midi.instruments
            if inst.program in programs and not inst.is_drum
            for n in inst.notes
        ]
        return NoteSeq(list(notes))

    @staticmethod
    def from_midi_file(path: str, *args, **kwargs) -> "NoteSeq":
        midi = MidiFile(path).to_seconds()
        return NoteSeq.from_midi(midi, *args, **kwargs)

    def add_notes(self, notes: List[Note]) -> None:
        self.notes += notes
        self.notes.sort(key=lambda n: n.start)

    def adjust_time(self, offset: float) -> None:
        for n in self.notes:
            n.start += offset
            n.end += offset

    def to_midi(self, program: int = DEFAULT_SAVING_PROGRAM,
                resolution: int = DEFAULT_RESOLUTION,
                tempo: int = vocab.DEFAULT_TEMPO) -> MidiFile:
        midi = MidiFile(ticks_per_beat=resolution)
        midi.tempo_changes = [TempoChange(tempo=tempo, time=0)]
        midi._tempo_raw = [(0, int(round(60e6 / tempo)))]
        inst = Instrument(program, False, "NoteSeq")
        tick_per_sec = resolution * tempo / 60.0
        inst.notes = [
            Note(velocity=int(n.velocity), pitch=int(n.pitch),
                 start=int(round(n.start * tick_per_sec)),
                 end=int(round(n.end * tick_per_sec)))
            for n in self.notes
        ]
        midi.instruments.append(inst)
        return midi

    def to_midi_file(self, path: str, *args, **kwargs) -> None:
        self.to_midi(*args, **kwargs).dump(path)


class EventSeq:
    pitch_range = vocab.MIDILIKE_PITCH_RANGE
    velocity_range = vocab.MIDILIKE_VELOCITY_RANGE
    time_shift_bins = vocab.MIDILIKE_TIME_SHIFT_BINS

    def __init__(self, events: Optional[List[Event]] = None):
        self.events = list(events or [])
        # recompute event times from time_shift chain (sequence.py:236-241)
        time = 0.0
        for ev in self.events:
            ev.time = time
            if ev.type == "time_shift":
                time += EventSeq.time_shift_bins[ev.value]

    @staticmethod
    def from_note_seq(note_seq: NoteSeq) -> "EventSeq":
        note_events: List[Event] = []
        velocity_bins = EventSeq.get_velocity_bins()
        lo, hi = EventSeq.velocity_range.start, EventSeq.velocity_range.stop

        kept = [n for n in note_seq.notes
                if n.pitch in EventSeq.pitch_range]
        if kept:
            vels = np.clip([n.velocity for n in kept], lo, hi - 1)
            vidx = velocity_bins.searchsorted(vels)
            base = EventSeq.pitch_range.start
            for note, vi in zip(kept, vidx):
                note_events.append(Event("velocity", note.start, int(vi)))
                note_events.append(Event("note_on", note.start,
                                         note.pitch - base))
                note_events.append(Event("note_off", note.end,
                                         note.pitch - base))

        note_events.sort(key=lambda ev: ev.time)  # stable
        events: List[Event] = []
        bins = EventSeq.time_shift_bins
        bin0 = float(bins[0])
        ss = bins.searchsorted
        for i, event in enumerate(note_events):
            events.append(event)
            if i == len(note_events) - 1:
                break
            interval = note_events[i + 1].time - event.time
            shift = 0.0
            # greedy largest-bin-first emission (sequence.py:177-181)
            while interval - shift >= bin0:
                index = int(ss(interval - shift, "right")) - 1
                events.append(Event("time_shift", event.time + shift, index))
                shift += float(bins[index])
        return EventSeq(events)

    @staticmethod
    def from_array(event_indeces) -> "EventSeq":
        ids = np.asarray(event_indeces, dtype=np.int64)
        feat_idx, values = SPEC.decode_ids(ids)
        names = SPEC.names
        events = [Event(names[f], 0.0, int(v))
                  for f, v in zip(feat_idx, values)]
        return EventSeq(events)

    @staticmethod
    def dim() -> int:
        return SPEC.dim()

    @staticmethod
    def get_velocity_bins() -> np.ndarray:
        return vocab.midilike_velocity_bins()

    def to_note_seq(self) -> NoteSeq:
        time = 0.0
        notes: List[Note] = []
        velocity = vocab.DEFAULT_VELOCITY
        velocity_bins = EventSeq.get_velocity_bins()
        last_notes = {}

        for event in self.events:
            if event.type == "note_on":
                pitch = event.value + EventSeq.pitch_range.start
                note = Note(velocity=velocity, pitch=pitch, start=time,
                            end=None)
                notes.append(note)
                last_notes[pitch] = note
            elif event.type == "note_off":
                pitch = event.value + EventSeq.pitch_range.start
                if pitch in last_notes:
                    note = last_notes[pitch]
                    note.end = max(time, note.start + vocab.MIN_NOTE_LENGTH)
                    del last_notes[pitch]
            elif event.type == "velocity":
                index = min(event.value, velocity_bins.size - 1)
                velocity = velocity_bins[index]
            elif event.type == "time_shift":
                time += EventSeq.time_shift_bins[event.value]

        for note in notes:
            if note.end is None:
                note.end = note.start + vocab.DEFAULT_NOTE_LENGTH
            note.velocity = int(note.velocity)
        return NoteSeq(notes)

    def to_array(self) -> np.ndarray:
        ranges = SPEC.feat_ranges()
        idxs = [ranges[ev.type].start + ev.value for ev in self.events]
        return np.array(idxs, dtype=SPEC.array_dtype())


# ---------------------------------------------------------------------------
# ControlSeq
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Control:
    pitch_histogram: List[float]
    note_density: int

    def to_array(self) -> np.ndarray:
        dens_dim = CONTROL_SPEC.feat_dims()["note_density"]
        ndens = np.zeros(dens_dim)
        ndens[self.note_density] = 1.0
        return np.concatenate([ndens, np.array(self.pitch_histogram)], 0)


class ControlSeq:
    note_density_bins = vocab.NOTE_DENSITY_BINS
    window_size = vocab.CONTROL_WINDOW_SIZE

    def __init__(self, controls: List[Control]):
        self.controls = list(controls)

    @staticmethod
    def from_event_seq(event_seq: EventSeq) -> "ControlSeq":
        """Sliding 4-beat window pitch histogram + density
        (reference: sequence.py:317-362)."""
        events = event_seq.events
        start, end = 0, 0
        pitch_count = np.zeros(12)
        note_count = 0.0
        controls: List[Control] = []
        base = EventSeq.pitch_range.start

        for i, event in enumerate(events):
            while start < i:
                if events[start].type == "note_on":
                    pitch_count[(events[start].value + base - 24) % 12] -= 1.0
                    note_count -= 1.0
                start += 1
            while end < len(events):
                if events[end].time - event.time > ControlSeq.window_size:
                    break
                if events[end].type == "note_on":
                    pitch_count[(events[end].value + base - 24) % 12] += 1.0
                    note_count += 1.0
                end += 1
            if note_count:
                hist = (pitch_count / note_count).tolist()
            else:
                hist = (np.ones(12) / 12).tolist()
            density = max(
                int(np.searchsorted(ControlSeq.note_density_bins,
                                    note_count, side="right")) - 1, 0)
            controls.append(Control(hist, density))
        return ControlSeq(controls)

    @staticmethod
    def compressed_from_ids(ids) -> np.ndarray:
        """Vectorized `from_event_seq(EventSeq.from_array(ids))
        .to_compressed_array()` — the corpus-pipeline hot path.

        Event times are BY CONSTRUCTION the cumulative time_shift chain
        (EventSeq.__init__, reference sequence.py:236-241), so controls
        are a pure function of the token ids: prefix-sum the shift bins
        for times (np.cumsum accumulates left-to-right, bit-identical to
        the loop), prefix-sum one-hot pitch classes for the window
        histograms, searchsorted + an exact diff-form fix-up for the
        window ends. Byte-equal to the object path (tested)."""
        ids = np.asarray(ids, dtype=np.int64)
        n = len(ids)
        if n == 0:
            return np.zeros((0, 13), np.uint8)
        ranges = SPEC.feat_ranges()
        ts = ranges["time_shift"]
        on = ranges["note_on"]
        bins = EventSeq.time_shift_bins
        shift = np.where((ids >= ts.start) & (ids < ts.stop),
                         bins[np.clip(ids - ts.start, 0, len(bins) - 1)],
                         0.0)
        acc = np.cumsum(shift)
        times = np.concatenate([[0.0], acc[:-1]])  # time BEFORE event i

        window = float(ControlSeq.window_size)
        end = np.searchsorted(times, times + window, side="right")
        # exact loop semantics: first j with times[j] - times[i] > window
        # (searchsorted compares times[j] > times[i]+window, which can
        # differ by 1 ulp — fix up with the diff form, iterated to a
        # FIXED POINT: each pass moves an end by at most one slot, and a
        # long cumsum chain of tiny shifts can drift more than that)
        for _ in range(64):
            over = (end > np.arange(n)) & (times[np.minimum(end, n) - 1]
                                           - times > window)
            end = np.where(over, end - 1, end)
            under = (end < n) & (times[np.minimum(end, n - 1)]
                                 - times <= window)
            under &= end < n
            end = np.where(under, end + 1, end)
            if not (over.any() or under.any()):
                break
        else:
            # non-converged repair: fall back to the object-path oracle
            # instead of emitting silently-diverged window ends
            return ControlSeq.from_event_seq(
                EventSeq.from_array(np.asarray(ids))
            ).to_compressed_array()

        on_mask = (ids >= on.start) & (ids < on.stop)
        base = EventSeq.pitch_range.start
        cls = (ids - on.start + base - 24) % 12
        onehot = np.zeros((n, 12), np.int64)
        onehot[np.nonzero(on_mask)[0], cls[on_mask]] = 1
        cum = np.zeros((n + 1, 12), np.int64)
        np.cumsum(onehot, axis=0, out=cum[1:])
        idx = np.arange(n)
        counts = cum[end] - cum[idx]          # [n, 12]
        note_count = counts.sum(axis=1)
        dens = np.searchsorted(ControlSeq.note_density_bins, note_count,
                               side="right") - 1
        dens = np.maximum(dens, 0).astype(np.uint8).reshape(-1, 1)
        with np.errstate(invalid="ignore", divide="ignore"):
            hist = counts / note_count[:, None].astype(np.float64)
        hist[note_count == 0] = 1.0 / 12
        return np.concatenate([dens, (hist * 255).astype(np.uint8)], 1)

    @staticmethod
    def dim() -> int:
        return CONTROL_SPEC.dim()

    @staticmethod
    def feat_dims():
        return CONTROL_SPEC.feat_dims()

    @staticmethod
    def feat_ranges():
        return CONTROL_SPEC.feat_ranges()

    def to_compressed_array(self) -> np.ndarray:
        ndens = np.array([c.note_density for c in self.controls],
                         dtype=np.uint8).reshape(-1, 1)
        phist = (np.array([c.pitch_histogram for c in self.controls]) * 255
                 ).astype(np.uint8)
        return np.concatenate([ndens, phist], 1)

    @staticmethod
    def recover_compressed_array(array: np.ndarray) -> np.ndarray:
        dims = CONTROL_SPEC.feat_dims()
        assert array.shape[1] == 1 + dims["pitch_histogram"]
        ndens = np.zeros([array.shape[0], dims["note_density"]])
        ndens[np.arange(array.shape[0]), array[:, 0]] = 1.0
        phist = array[:, 1:].astype(np.float64) / 255
        return np.concatenate([ndens, phist], 1)


def extract_events(path: str) -> EventSeq:
    ns = NoteSeq.from_midi_file(path)
    if ns.notes:
        ns.adjust_time(-ns.notes[0].start)
    return EventSeq.from_note_seq(ns)


def from_array(arr) -> EventSeq:
    return EventSeq.from_array(arr)


def write_midi(event_seq: EventSeq, path: str) -> None:
    event_seq.to_note_seq().to_midi_file(path)
