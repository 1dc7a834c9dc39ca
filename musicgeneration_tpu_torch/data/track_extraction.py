"""Lakh-MIDI multi-track cleanup for MuMIDI (reference extract_tracks.py).

The port's copy of ``musicgeneration_tpu/data/track_extraction.py``, on
the port's ``midi/`` and ``data/pipeline.find_midi_files``: the same
roles, merges and output bytes.

Pipeline per file (reference mg/model/utils/extract_tracks.py):

1. drop near-empty tracks: fewer than 20 active pianoroll timesteps
   (:52-53 — the reference counts timesteps where ANY pitch sounds on a
   24-steps-per-beat grid, not note count),
2. classify every remaining track into the six MuMIDI roles
   melody/piano/bass/guitar/drum/string by GM program ranges + track-name
   matching (:17-22, :62-73, :123-149; 'flute' counts as melody :66-67,
   unmatched tracks fall through to 'string' :147-149),
3. require >= 3 distinct roles, or 2 when one is the melody (:152-154),
4. merge same-role tracks — the reference ORs the pianorolls (:84-90),
   which fuses overlapping/adjacent same-pitch notes; here the
   equivalent interval-union per pitch on the note list,
5. write one merged MIDI with canonical per-role programs (:161-172).

The reference's program ranges are 1-based GM numbers applied to
pypianoroll's 0-based `track.program` — an off-by-one that excludes
Acoustic Grand (program 0) from 'piano' and shifts every range. Kept
under `one_based_quirk=True` (default) for parity; pass False for
correct 0-based GM ranges.
"""

from __future__ import annotations

import hashlib
import os
from collections import defaultdict
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence

from ..midi import Instrument, MidiFile, Note

TRACK_ROLES = ["melody", "piano", "bass", "guitar", "drum", "string"]

# reference extract_tracks.py:19-22 (1-based GM numbers, see module doc)
ROLE_PROGRAMS_1BASED: Dict[str, Sequence[int]] = {
    "piano": range(1, 9),
    "bass": range(33, 41),
    "guitar": range(25, 33),
    "drum": range(114, 120),
}
ROLE_PROGRAMS_0BASED: Dict[str, Sequence[int]] = {
    "piano": range(0, 8),
    "bass": range(32, 40),
    "guitar": range(24, 32),
    "drum": range(113, 119),
}

# canonical program for merged role tracks (extract_tracks.py:166-169)
ROLE_WRITE_PROGRAM = {"piano": 1, "bass": 33, "guitar": 25, "drum": 114}


def _name_matches(name: str, role: str) -> bool:
    """Word-level track-name match; 'flute' counts as melody
    (extract_tracks.py:62-73)."""
    words = [w.lower() for w in name.split()]
    if role in words:
        return True
    return role == "melody" and "flute" in words


def _active_steps(notes: Sequence[Note], ticks_per_beat: int,
                  resolution: int = 24) -> int:
    """Number of pianoroll timesteps (24/beat) where any pitch sounds."""
    if not notes:
        return 0
    scale = resolution / ticks_per_beat
    steps = set()
    for n in notes:
        lo = int(n.start * scale)
        hi = max(lo + 1, int(n.end * scale))
        steps.update(range(lo, hi))
    return len(steps)


def classify_role(inst: Instrument, one_based_quirk: bool = True) -> str:
    """Map one instrument track to a MuMIDI role (extract_tracks.py:123-149,
    same precedence order: melody > drum > piano > bass > guitar > string)."""
    ranges = (ROLE_PROGRAMS_1BASED if one_based_quirk
              else ROLE_PROGRAMS_0BASED)
    if _name_matches(inst.name, "melody"):
        return "melody"
    if (inst.is_drum or inst.program in ranges["drum"]
            or _name_matches(inst.name, "drum")):
        return "drum"
    if inst.program in ranges["piano"] or _name_matches(inst.name, "piano"):
        return "piano"
    if inst.program in ranges["bass"] or _name_matches(inst.name, "bass"):
        return "bass"
    if inst.program in ranges["guitar"] or _name_matches(inst.name,
                                                         "guitar"):
        return "guitar"
    return "string"


def merge_notes(tracks: Sequence[Instrument]) -> List[Note]:
    """Union same-role tracks. Equivalent to the reference's pianoroll OR
    (extract_tracks.py:84-90): overlapping or touching same-pitch
    intervals fuse into one note (velocity = max of the merged)."""
    by_pitch: Dict[int, List[Note]] = defaultdict(list)
    for tr in tracks:
        for n in tr.notes:
            by_pitch[n.pitch].append(n)
    merged: List[Note] = []
    for pitch, notes in by_pitch.items():
        notes.sort(key=lambda n: n.start)
        cur: Optional[Note] = None
        for n in notes:
            if cur is not None and n.start <= cur.end:
                cur.end = max(cur.end, n.end)
                cur.velocity = max(cur.velocity, n.velocity)
            else:
                if cur is not None:
                    merged.append(cur)
                cur = Note(n.velocity, pitch, n.start, n.end)
        if cur is not None:
            merged.append(cur)
    merged.sort(key=lambda n: (n.start, n.pitch))
    return merged


def extract_merge(midi_or_path, min_active_steps: int = 20,
                  one_based_quirk: bool = True) -> Optional[MidiFile]:
    """Full per-file pipeline; None = rejected (too few roles,
    extract_tracks.py:152-154)."""
    midi = (MidiFile(midi_or_path) if isinstance(midi_or_path, str)
            else midi_or_path)
    kept = [inst for inst in midi.instruments
            if _active_steps(inst.notes, midi.ticks_per_beat)
            >= min_active_steps]
    roles: Dict[str, List[Instrument]] = defaultdict(list)
    for inst in kept:
        roles[classify_role(inst, one_based_quirk)].append(inst)

    n_roles = sum(1 for r in TRACK_ROLES if roles.get(r))
    if n_roles < 3 and not (n_roles == 2 and roles.get("melody")):
        return None

    out = MidiFile(ticks_per_beat=midi.ticks_per_beat)
    out.tempo_changes = list(midi.tempo_changes)
    out._tempo_raw = list(getattr(midi, "_tempo_raw", []))
    for role in TRACK_ROLES:
        tracks = roles.get(role)
        if not tracks:
            continue
        program = ROLE_WRITE_PROGRAM.get(role, tracks[0].program)
        inst = Instrument(program=program, is_drum=(role == "drum"),
                          name=role)
        inst.notes = merge_notes(tracks)
        out.instruments.append(inst)
    return out


def _worker(path: str, output_dir: str, min_active_steps: int,
            one_based_quirk: bool) -> Optional[str]:
    merged = extract_merge(path, min_active_steps, one_based_quirk)
    if merged is None:
        return None
    code = hashlib.md5(path.encode()).hexdigest()
    save_path = os.path.join(
        output_dir, f"{code}_{os.path.basename(path)}")
    merged.dump(save_path)
    return save_path


def extract_tracks_under(input_dir: str, output_dir: str,
                         num_workers: int = 8,
                         min_active_steps: int = 20,
                         one_based_quirk: bool = True) -> Dict[str, int]:
    """Corpus driver (extract_tracks.py:194-226) with a result summary
    instead of fire-and-forget submits."""
    from .pipeline import find_midi_files

    paths = find_midi_files(input_dir)
    os.makedirs(output_dir, exist_ok=True)
    ok = rejected = failed = 0
    if num_workers <= 1:
        for p in paths:
            try:
                ok_path = _worker(p, output_dir, min_active_steps,
                                  one_based_quirk)
                ok, rejected = (ok + 1, rejected) if ok_path else \
                    (ok, rejected + 1)
            except Exception:  # noqa: BLE001
                failed += 1
    else:
        import multiprocessing as mp
        with ProcessPoolExecutor(
                num_workers, mp_context=mp.get_context("spawn")) as pool:
            futures = [pool.submit(_worker, p, output_dir,
                                   min_active_steps, one_based_quirk)
                       for p in paths]
            for fut in futures:
                try:
                    ok, rejected = (ok + 1, rejected) if fut.result() \
                        else (ok, rejected + 1)
                except Exception:  # noqa: BLE001
                    failed += 1
    return {"ok": ok, "rejected": rejected, "failed": failed,
            "total": len(paths)}
