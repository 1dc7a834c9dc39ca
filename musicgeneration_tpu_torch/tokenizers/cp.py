"""CP (Compound Word) tokenizer — the reference README's declared but
never-implemented fourth scheme ("CP(to do)").

A copy of ``musicgeneration_tpu/tokenizers/cp.py``: ``encode_rows`` runs
the port's C++ pipeline (``native/smf_scan.cc`` mg_encode_cp), and
``extract_events`` is its Python oracle.

Design follows the Compound Word Transformer (Hsiao et al., AAAI 2021):
the token stream is a sequence of COMPOUND rows, each grouping the
fields of one musical event, instead of REMI's one-token-per-field
stream. A row has 8 typed fields:

    idx  field        values                         used by
    0    family       0=metric 1=note 2=EOS          all
    1    position     0=bar marker, 1..16=beat pos   metric
    2    tempo_class  0..2 (REMI intervals)          metric
    3    tempo_value  0..59                          metric
    4    chord        0..60 (REMI chord map)         metric
    5    pitch        0..126                         note
    6    duration     0..63 (REMI duration bins)     note
    7    velocity     0..3  (REMI velocity bins)     note

Fields a row does not use hold the per-field IGNORE id (= the field's
vocab size); the per-field vocab INCLUDING ignore is `field_dims()`.
Compounding shortens sequences ~3-4x vs REMI (one row carries what REMI
spells as position+tempo_class+tempo_value or
position+velocity+pitch+duration) — more music per fixed context window.

The musical semantics reuse the REMI item pipeline verbatim (read_items
-> quantize_items -> extract_chords -> group_items, tokenizers/remi.py =
reference REMI.py:64-165), so CP rows bin pitch/duration/velocity/tempo
/chord exactly like REMI tokens do. Arrays are [T, 8] uint16; shards
store them flattened with width 8 (data/pipeline.py `cp` scheme).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .. import native, vocab
from ..midi import Instrument, Marker, MidiFile, Note, TempoChange
from . import remi

WIDTH = 8
FAMILY_METRIC, FAMILY_NOTE, FAMILY_EOS = 0, 1, 2

_FIELDS = ("family", "position", "tempo_class", "tempo_value", "chord",
           "pitch", "duration", "velocity")
# usable values per field (ignore id == this count; +1 slot in the vocab)
_SIZES = (3, 1 + vocab.REMI_FRACTION, 3, 60, len(vocab.CHORD_MAP),
          127, len(vocab.REMI_DURATION_BINS), vocab.REMI_VELOCITY_STEPS)


def field_names():
    return _FIELDS


def field_dims() -> List[int]:
    """Per-field vocab sizes INCLUDING the trailing ignore id."""
    return [s + 1 for s in _SIZES]


def ignore_ids() -> List[int]:
    return list(_SIZES)


def dim() -> int:
    return sum(field_dims())


def _row(family: int, **kw) -> List[int]:
    row = list(_SIZES)  # all-ignore
    row[0] = family
    for k, v in kw.items():
        row[_FIELDS.index(k)] = int(v)
    return row


def encode_rows(input_path: str) -> np.ndarray:
    """MIDI -> CP rows [T, 8] (uint16) — the corpus-pipeline hot path.

    The full C++ pipeline (``native_rows``), and `extract_events` below,
    the semantics oracle, under MG_NATIVE=0 or where the C++ reports an
    error for the file."""
    if os.environ.get("MG_NATIVE", "1") != "0":
        try:
            with open(input_path, "rb") as f:
                data = f.read()
        except OSError:
            data = None
        if data is not None:
            rows = native_rows(data)
            if rows is not None:
                return rows
    return extract_events(input_path)


def native_rows(data: bytes) -> Optional[np.ndarray]:
    """The CP rows [T, 8] (uint16) of one SMF buffer through the C++
    pipeline (native/smf_scan.cc mg_encode_cp), or None where it reports
    an error."""
    return native.encode_cp(
        data, vocab.REMI_DURATION_BINS, vocab.REMI_VELOCITY_BINS,
        vocab.REMI_RESOLUTION, vocab.REMI_FRACTION,
        vocab.REMI_VELOCITY_STEPS, len(vocab.REMI_PITCH_RANGE) - 1,
        remi.TEMPO_BOUNDS, remi.CHORD_IDS, np.array(ignore_ids(), np.int64))


def extract_events(input_path: str) -> np.ndarray:
    """MIDI -> CP rows [T, 8] (uint16).

    Row order inside a bar: bar-marker row, then per occupied position a
    metric row (tempo and/or chord compounded together), then one note
    row per note at that position — mirroring the CP paper's
    metric-then-note grouping over the same items REMI sees."""
    note_items, tempo_items = remi.read_items(input_path)
    note_items = remi.quantize_items(note_items)
    if not note_items:
        return np.zeros((0, WIDTH), np.uint16)
    max_time = note_items[-1].end
    chord_items = remi.extract_chords(note_items)
    items = chord_items + tempo_items + note_items
    groups = remi.group_items(items, max_time)

    rows: List[List[int]] = []
    for group in groups:
        insiders = group[1:-1]
        if not any(it.name == "note" for it in insiders):
            continue
        bar_st, bar_et = group[0], group[-1]
        rows.append(_row(FAMILY_METRIC, position=0))  # bar marker
        flags = np.linspace(bar_st, bar_et, vocab.REMI_FRACTION,
                            endpoint=False)
        # bucket items by position index (argmin grid, REMI semantics)
        by_pos = {}
        for it in insiders:
            idx = int(np.argmin(np.abs(flags - it.start))) + 1
            by_pos.setdefault(idx, []).append(it)
        for idx in sorted(by_pos):
            metric_kw = {}
            notes = []
            for it in by_pos[idx]:
                if it.name == "tempo":
                    style, value = remi._tempo_events(it.start, it.pitch,
                                                      strict=False)
                    metric_kw["tempo_class"] = style.value
                    metric_kw["tempo_value"] = value.value
                elif it.name == "chord":
                    metric_kw["chord"] = vocab.CHORD_MAP[it.pitch]
                else:
                    notes.append(it)
            if metric_kw:
                rows.append(_row(FAMILY_METRIC, position=idx, **metric_kw))
            elif notes:
                # notes need their position anchored even without
                # tempo/chord at this grid point
                rows.append(_row(FAMILY_METRIC, position=idx))
            for it in notes:
                vel_idx = int(np.searchsorted(vocab.REMI_VELOCITY_BINS,
                                              it.velocity, "right")) - 1
                vel_idx = max(min(vel_idx,
                                  vocab.REMI_VELOCITY_STEPS - 1), 0)
                dur = it.end - it.start
                dur_idx = int(np.argmin(
                    np.abs(vocab.REMI_DURATION_BINS - dur)))
                rows.append(_row(
                    FAMILY_NOTE, pitch=min(int(it.pitch), 126),
                    duration=dur_idx, velocity=vel_idx))
    return np.asarray(rows, np.uint16).reshape(-1, WIDTH)


def to_array(rows: np.ndarray) -> np.ndarray:
    return np.asarray(rows, np.uint16).reshape(-1, WIDTH)


def from_array(arr) -> np.ndarray:
    a = np.asarray(arr, np.int64)
    if a.ndim == 1:
        a = a.reshape(-1, WIDTH)
    return a


def write_midi(rows, output_path: Optional[str] = None) -> MidiFile:
    """CP rows -> MIDI (480 ticks/beat, 4/4 — REMI write_midi
    conventions, reference REMI.py:539-674). Malformed rows (out-of-
    range field values from a sampling model) are skipped."""
    rows = from_array(rows)
    tpb = vocab.REMI_RESOLUTION
    ticks_per_bar = tpb * 4
    flags_step = ticks_per_bar // vocab.REMI_FRACTION
    ign = ignore_ids()

    notes: List[Note] = []
    tempos: List[TempoChange] = []
    markers: List[Marker] = []
    current_bar = -1
    current_pos = 1
    for row in rows:
        fam = int(row[0])
        if fam == FAMILY_EOS:
            break
        if fam == FAMILY_METRIC:
            pos = int(row[1])
            if pos == 0:
                current_bar += 1
                current_pos = 1
                continue
            if pos > vocab.REMI_FRACTION:
                continue
            current_pos = pos
            tick = (max(current_bar, 0) * ticks_per_bar
                    + (pos - 1) * flags_step)
            tc, tv = int(row[2]), int(row[3])
            if tc < ign[2] and tv < ign[3]:
                bpm = vocab.REMI_TEMPO_INTERVALS[tc].start + tv
                tempos.append(TempoChange(tempo=bpm, time=tick))
            ch = int(row[4])
            if ch < ign[4]:
                markers.append(Marker(text=vocab.INV_CHORD_MAP[ch],
                                      time=tick))
        elif fam == FAMILY_NOTE:
            pitch, dur_i, vel_i = int(row[5]), int(row[6]), int(row[7])
            if pitch >= ign[5] or dur_i >= ign[6] or vel_i >= ign[7]:
                continue
            tick = (max(current_bar, 0) * ticks_per_bar
                    + (current_pos - 1) * flags_step)
            dur = int(vocab.REMI_DURATION_BINS[dur_i])
            vel = int(vocab.REMI_VELOCITY_BINS[vel_i])
            notes.append(Note(velocity=vel, pitch=pitch, start=tick,
                              end=tick + dur))

    midi = MidiFile(ticks_per_beat=tpb)
    if not tempos:
        tempos = [TempoChange(tempo=120, time=0)]
    midi.tempo_changes = tempos
    midi._tempo_raw = [(t.time, int(round(60e6 / t.tempo)))
                       for t in tempos]
    midi.markers = markers
    inst = Instrument(0, False, "cp")
    inst.notes = notes
    midi.instruments.append(inst)
    if output_path:
        midi.dump(output_path)
    return midi
