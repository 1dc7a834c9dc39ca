"""The port's sustain-pedal MIDI-like codec, its ``pedal`` and ``remi``
shard writers and ``cli.tokenize --scheme remi|pedal`` against the JAX
package: identical tokens (both ``faithful`` modes, sustain windows and
repeated pitches under the pedal included), MIDI bytes, the golden
``pedal`` hashes, and shards whose arrays are byte-equal to the JAX
writers' at their default (``MG_NATIVE`` unset: the native scanner where
it is built)."""

import hashlib
import json
import os

import numpy as np
import pytest

from musicgeneration_tpu.data.pipeline import tokenize_corpus as jtokenize
from musicgeneration_tpu.midi import ControlChange as JCC
from musicgeneration_tpu.midi import Instrument as JInst
from musicgeneration_tpu.midi import MidiFile as JMidi
from musicgeneration_tpu.midi import Note as JNote
from musicgeneration_tpu.midi import TempoChange as JTempo
from musicgeneration_tpu.tokenizers import pedal_midilike as jpm
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.data.pipeline import (SCHEMES, TokenCorpus,
                                                     tokenize_corpus)
from musicgeneration_tpu_torch.midi import ControlChange, Instrument, MidiFile
from musicgeneration_tpu_torch.midi import Note, TempoChange
from musicgeneration_tpu_torch.tokenizers import pedal_midilike as tpm

from .fixtures import (multitrack_midi, polyphonic_midi, simple_piano_midi,
                       tempo_change_midi)


def pedal_midi(path: str, seed: int = 0, n_notes: int = 80,
               tempo: float = 110.0) -> None:
    """A piano part under a sustain pedal (CC64 down/up windows, a
    repeated up, pitches repeated inside a window) and a second part
    without CC, written with the port's MIDI writer."""
    rng = np.random.default_rng(seed)
    tpb = 480
    midi = MidiFile(ticks_per_beat=tpb)
    midi.tempo_changes = [TempoChange(tempo=tempo, time=0)]
    midi._tempo_raw = [(0, int(round(60e6 / tempo)))]
    piano = Instrument(0, False, "piano")
    t = 37
    for _ in range(n_notes):
        pitch = int(rng.choice([60, 62, 64, 65, 67, 60, 64]))
        dur = int(rng.integers(60, 400))
        piano.notes.append(Note(int(rng.integers(20, 120)), pitch, t, t + dur))
        t += int(rng.integers(40, 300))
    ccs, c = [], 200
    while c < t:
        ccs.append(ControlChange(64, int(rng.integers(64, 128)), c))
        c += int(rng.integers(300, 1500))
        ccs.append(ControlChange(64, int(rng.integers(0, 64)), c))
        if rng.random() < 0.3:      # a second release while up
            c += 50
            ccs.append(ControlChange(64, 0, c))
        c += int(rng.integers(200, 900))
    piano.control_changes = ccs
    other = Instrument(33, False, "bass")
    for k in range(20):
        s = 120 + k * 700
        other.notes.append(Note(90, 40 + k % 5, s, s + 500))
    midi.instruments = [piano, other]
    midi.dump(path)


MAKERS = {
    "pedal_a": lambda p: pedal_midi(p, seed=0),
    "pedal_b": lambda p: pedal_midi(p, seed=3, n_notes=120, tempo=84.0),
    "simple": lambda p: simple_piano_midi(p, seed=1, n_notes=60),
    "poly": lambda p: polyphonic_midi(p),
    "multi": lambda p: multitrack_midi(p),
    "tempo": lambda p: tempo_change_midi(p),
}


@pytest.fixture(scope="module", params=sorted(MAKERS))
def midi(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pedal") / f"{request.param}.mid")
    MAKERS[request.param](path)
    return path


def test_constants_copied():
    for name in ("RANGE_NOTE_ON", "RANGE_NOTE_OFF", "RANGE_TIME_SHIFT",
                 "RANGE_VEL", "START_NOTE_OFF", "START_TIME_SHIFT",
                 "START_VELOCITY", "VOCAB_SIZE", "PAD_ID", "EOS_ID"):
        assert getattr(tpm, name) == getattr(jpm, name), name
    for tok in (0, 127, 128, 255, 256, 355, 356, 387, 388, 389):
        assert tpm.token_type(tok) == jpm.token_type(tok)


@pytest.mark.parametrize("faithful", [False, True])
def test_encode_equals_jax(midi, faithful):
    got = tpm.encode_midi(midi, faithful=faithful)
    want = jpm.encode_midi(midi, faithful=faithful)
    assert got == want
    # the faithful mode drops every note of a part without sustain CCs
    assert len(got) > 10 or (faithful
                             and not os.path.basename(midi).startswith("pedal"))
    arr = tpm.encode_array(midi, faithful=faithful)
    assert arr.dtype == np.uint16 and arr.tolist() == want


def test_fixture_has_sustain_windows(tmp_path):
    """The pedal fixture exercises the sustain path: its tokens differ
    from those of the same file with the pedal stripped."""
    path = str(tmp_path / "p.mid")
    pedal_midi(path)
    midi = MidiFile(path).to_seconds()
    assert any(c.number == 64 for c in midi.instruments[0].control_changes)
    stripped = MidiFile(path).to_seconds()
    stripped.instruments[0].control_changes = []
    assert tpm.encode_midi(midi) != tpm.encode_midi(stripped)


def _in_memory(mods, notes, ccs):
    midi_cls, inst_cls, note_cls, cc_cls, tempo_cls = mods
    midi = midi_cls(ticks_per_beat=480)
    midi.tempo_changes = [tempo_cls(tempo=120, time=0)]
    midi._tempo_raw = [(0, 500000)]
    inst = inst_cls(0, False, "t")
    inst.notes = [note_cls(v, p, s, e) for (v, p, s, e) in notes]
    inst.control_changes = [cc_cls(64, v, t) for (v, t) in ccs]
    midi.instruments.append(inst)
    return midi


CASES = {
    # sustain extends note ends to the release
    "extend": ([(80, 60, 0.0, 0.2), (80, 64, 0.1, 0.3)],
               [(127, 0.05), (0, 1.0)]),
    # a repeated pitch under the pedal ends at the next onset
    "repeat": ([(80, 60, 0.0, 0.1), (70, 60, 0.5, 0.6), (90, 62, 0.7, 0.8)],
               [(100, 0.0), (10, 2.0)]),
    # notes before, inside and after two windows; a release while up
    "windows": ([(40, 50, 0.0, 0.3), (41, 51, 0.4, 0.5), (42, 52, 1.2, 1.3),
                 (43, 53, 2.1, 2.4), (44, 50, 2.5, 2.6)],
                [(64, 0.35), (0, 0.9), (0, 1.0), (90, 2.0), (20, 2.45)]),
    # no pedal at all (the faithful mode drops every note)
    "no_pedal": ([(80, 60, 0.0, 0.5), (81, 61, 0.25, 0.75)], []),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("faithful", [False, True])
def test_sustain_cases_equal_jax(case, faithful):
    notes, ccs = CASES[case]
    t = _in_memory((MidiFile, Instrument, Note, ControlChange, TempoChange),
                   notes, ccs)
    j = _in_memory((JMidi, JInst, JNote, JCC, JTempo), notes, ccs)
    assert tpm.encode_midi(t, faithful=faithful) == jpm.encode_midi(
        j, faithful=faithful)


@pytest.mark.parametrize("faithful", [False, True])
def test_decode_bytes_equal_jax(midi, tmp_path, faithful):
    """decode_midi writes the JAX bytes, on a file's tokens and on random
    ids with out-of-vocabulary ones (pad, eos) mixed in; the last
    note_on per pitch stays open after an off, as the reference has it."""
    ids = jpm.encode_midi(midi)
    rnd = np.random.default_rng(5).integers(0, 390, 400).tolist()
    for name, seq in (("file", ids), ("random", rnd)):
        a, b = tmp_path / f"t_{name}.mid", tmp_path / f"j_{name}.mid"
        tpm.decode_midi(seq, str(a), faithful=faithful)
        jpm.decode_midi(seq, str(b), faithful=faithful)
        assert a.read_bytes() == b.read_bytes(), name
    assert tpm.from_array(tpm.to_array(ids)) == ids


GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__),
                                     "golden_tokens.json")))
GOLDEN_BUILDERS = {"simple": simple_piano_midi, "poly": polyphonic_midi,
                   "multi": multitrack_midi, "tempo": tempo_change_midi}


@pytest.mark.parametrize("name", sorted(GOLDEN_BUILDERS))
def test_golden_pedal_hash(name, tmp_path):
    path = str(tmp_path / f"{name}.mid")
    GOLDEN_BUILDERS[name](path)
    arr = np.ascontiguousarray(np.asarray(tpm.encode_midi(path), np.uint16))
    got = [int(len(arr)), hashlib.sha256(arr.tobytes()).hexdigest()[:16]]
    assert got == GOLDEN[name]["pedal"]


@pytest.mark.parametrize("scheme", ["pedal", "remi"])
def test_shards_byte_equal_jax(scheme, tmp_path, monkeypatch):
    monkeypatch.delenv("MG_NATIVE", raising=False)
    src = tmp_path / "midis"
    src.mkdir()
    for name, make in MAKERS.items():
        make(str(src / f"{name}.mid"))
    assert scheme in SCHEMES
    t_stats = tokenize_corpus(str(src), str(tmp_path / "t"), scheme,
                              num_workers=1)
    j_stats = jtokenize(str(src), str(tmp_path / "j"), scheme,
                        num_workers=1)
    assert (t_stats.n_ok, t_stats.n_failed, t_stats.n_tokens) == (
        j_stats.n_ok, j_stats.n_failed, j_stats.n_tokens) == (
            len(MAKERS), 0, t_stats.n_tokens)
    with np.load(t_stats.shards[0]) as t, np.load(j_stats.shards[0]) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            assert t[k].dtype == j[k].dtype, k
            assert t[k].shape == j[k].shape, k
            assert t[k].tobytes() == j[k].tobytes(), k
        assert t["tokens_data"].dtype == np.uint16
    with open(tmp_path / "t" / "manifest.json") as f:
        assert json.load(f)["scheme"] == scheme


def test_cli_tokenize_pedal_and_remi(tmp_path):
    src = tmp_path / "midis"
    src.mkdir()
    pedal_midi(str(src / "a.mid"))
    simple_piano_midi(str(src / "b.mid"), seed=2)
    for scheme, dim in (("pedal", 388), ("remi", 336)):
        assert ttok.main([str(src), str(tmp_path / scheme), "--scheme",
                          scheme, "--workers", "1"]) == 0
        corpus = TokenCorpus(str(tmp_path / scheme))
        assert len(corpus) == 2
        assert all(int(corpus[i].max()) < dim for i in range(2))
    with pytest.raises(SystemExit):
        ttok.main([str(src), str(tmp_path / "x"), "--scheme", "nope"])
