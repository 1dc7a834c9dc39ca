"""The port's track extraction (``data/track_extraction.py``) and
``cli.extract_tracks`` against the JAX package: the same roles (both GM
numberings), merges and rejections, and merged MIDI files byte-equal to
the JAX ones on multi-track fixtures (tracks of one role to merge, a
near-empty track, a file with too few roles)."""

import os

import numpy as np
import pytest

from musicgeneration_tpu.data import track_extraction as jte
from musicgeneration_tpu.midi import Instrument as JInst
from musicgeneration_tpu.midi import Note as JNote
from musicgeneration_tpu_torch.cli import extract_tracks as tcli
from musicgeneration_tpu_torch.data import track_extraction as tte
from musicgeneration_tpu_torch.midi import (Instrument, MidiFile, Note,
                                            TempoChange)

from .fixtures import multitrack_midi, simple_piano_midi


def _track(mods, name, program, pitches, is_drum=False, tpb=480, n=30,
           offset=0):
    inst_cls, note_cls = mods
    inst = inst_cls(program=program, is_drum=is_drum, name=name)
    for k in range(n):
        s = offset + k * tpb // 2
        inst.notes.append(note_cls(80, pitches[k % len(pitches)], s,
                                   s + tpb // 4))
    return inst


T, J = (Instrument, Note), (JInst, JNote)
ROLE_CASES = [("Lead Melody", 50, [70], False), ("flute solo", 73, [70], False),
              ("x", 2, [60], False), ("x", 0, [60], False),
              ("x", 34, [40], False), ("x", 32, [40], False),
              ("x", 27, [50], False), ("x", 24, [50], False),
              ("x", 115, [40], False), ("x", 113, [40], False),
              ("x", 50, [60], False), ("x", 2, [40], True),
              ("my Piano", 90, [60], False), ("Bass line", 90, [40], False),
              ("GUITAR", 90, [50], False), ("drum kit", 5, [36], False)]


@pytest.mark.parametrize("quirk", [True, False])
def test_classify_role_equals_jax(quirk):
    """JAX tests/test_pipeline.py:102-117's cases and the 0-based GM
    boundaries: the same role in both packages, in both numberings."""
    for name, program, pitches, drum in ROLE_CASES:
        got = tte.classify_role(_track(T, name, program, pitches, drum),
                                one_based_quirk=quirk)
        want = jte.classify_role(_track(J, name, program, pitches, drum),
                                 one_based_quirk=quirk)
        assert got == want, (name, program)
    assert tte.classify_role(_track(T, "Lead Melody", 50, [70])) == "melody"
    assert tte.classify_role(_track(T, "x", 2, [60])) == "piano"
    assert tte.classify_role(_track(T, "x", 0, [60])) == "string"
    assert tte.classify_role(_track(T, "x", 0, [60]),
                             one_based_quirk=False) == "piano"
    assert tte.classify_role(_track(T, "x", 2, [40], True)) == "drum"


def test_merge_notes_equals_jax():
    tracks = {}
    for mods, key in ((T, "t"), (J, "j")):
        r = np.random.default_rng(0)
        tracks[key] = [_track(mods, "x", 1, list(r.integers(50, 56, 4)),
                              offset=int(r.integers(0, 300)))
                       for _ in range(3)]
    got = tte.merge_notes(tracks["t"])
    want = jte.merge_notes(tracks["j"])
    assert [(n.velocity, n.pitch, n.start, n.end) for n in got] == [
        (n.velocity, n.pitch, n.start, n.end) for n in want]
    assert len(got) < sum(len(t.notes) for t in tracks["t"])


def crowded_midi(path: str) -> None:
    """Seven tracks: two pianos and two strings to merge (overlapping
    same-pitch notes), a near-empty guitar that is dropped, a melody and
    a drum part."""
    midi = MidiFile(ticks_per_beat=480)
    midi.tempo_changes = [TempoChange(tempo=100.0, time=0)]
    midi._tempo_raw = [(0, int(round(60e6 / 100.0)))]
    midi.instruments = [
        _track(T, "melody", 72, [72, 74, 76], n=40),
        _track(T, "piano a", 1, [60, 64], n=40),
        _track(T, "piano b", 3, [60, 67], n=40, offset=100),
        _track(T, "x", 49, [55, 59], n=32),
        _track(T, "y", 50, [55, 62], n=32, offset=60),
        _track(T, "guitar", 25, [50], n=2),
        _track(T, "kit", 0, [36, 38], is_drum=True, n=48),
    ]
    midi.dump(path)


def two_roles_midi(path: str) -> None:
    """Piano and bass only: rejected (fewer than 3 roles, no melody)."""
    midi = MidiFile(ticks_per_beat=480)
    midi.tempo_changes = [TempoChange(tempo=120.0, time=0)]
    midi._tempo_raw = [(0, 500000)]
    midi.instruments = [_track(T, "x", 2, [60]), _track(T, "x", 34, [40])]
    midi.dump(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracks_in")
    multitrack_midi(str(d / "mt.mid"))
    multitrack_midi(str(d / "mt2.mid"), seed=7, n_bars=6, tempo=90.0)
    crowded_midi(str(d / "crowded.mid"))
    two_roles_midi(str(d / "two.mid"))
    simple_piano_midi(str(d / "piano.mid"))
    return d


@pytest.mark.parametrize("quirk", [True, False])
def test_extract_merge_bytes_equal_jax(corpus, tmp_path, quirk):
    kept = 0
    for name in sorted(os.listdir(corpus)):
        path = str(corpus / name)
        got = tte.extract_merge(path, one_based_quirk=quirk)
        want = jte.extract_merge(path, one_based_quirk=quirk)
        assert (got is None) == (want is None), name
        if got is None:
            continue
        kept += 1
        got.dump(str(tmp_path / f"t_{name}"))
        want.dump(str(tmp_path / f"j_{name}"))
        assert (tmp_path / f"t_{name}").read_bytes() == (
            tmp_path / f"j_{name}").read_bytes(), name
    assert kept == 3


def test_extract_tracks_under_and_cli_equal_jax(corpus, tmp_path, capsys):
    t_out, j_out = tmp_path / "t", tmp_path / "j"
    got = tte.extract_tracks_under(str(corpus), str(t_out), num_workers=1)
    want = jte.extract_tracks_under(str(corpus), str(j_out), num_workers=1)
    assert got == want == {"ok": 3, "rejected": 2, "failed": 0, "total": 5}
    names = sorted(os.listdir(t_out))
    assert names == sorted(os.listdir(j_out)) and len(names) == 3
    for n in names:
        assert (t_out / n).read_bytes() == (j_out / n).read_bytes(), n
    merged = MidiFile(str(t_out / next(n for n in names
                                       if n.endswith("crowded.mid"))))
    assert [i.name for i in merged.instruments] == [
        "melody", "piano", "drum", "string"]

    c_out = tmp_path / "cli"
    assert tcli.main([str(corpus), str(c_out), "--workers", "1"]) == 0
    assert "merged 3/5 files (2 rejected, 0 failed)" in capsys.readouterr().out
    assert sorted(os.listdir(c_out)) == names
    for n in names:
        assert (c_out / n).read_bytes() == (t_out / n).read_bytes(), n
    assert tcli.main([str(corpus), str(tmp_path / "cli0"), "--workers", "1",
                      "--gm-zero-based"]) == 0
