"""The port's native MIDI scanner and codecs (``musicgeneration_tpu_torch/
native/``) against the JAX package's, on the CPU.

* Every entry point (parse, MIDI-like, REMI, sustain pedal in both
  modes, CP, MuMIDI, melody) on the ``tests/fixtures.py`` pieces and
  eight seeded random pieces (several tracks, tempo changes, sustain
  pedal, drums; written with the port's MIDI writer): the port's native
  output is byte-equal to the JAX package's native output and to the JAX
  package's Python path, and the port's direct native calls return a
  result on every piece (no silent fallback).
* ``cli.tokenize`` shards of all seven schemes: the JAX CLI's arrays,
  and the port's own under ``MG_NATIVE=0``.
* Truncated and mutated files (``tests/test_native_robustness.py``'s
  fuzz): no crash, and the JAX entry point's result or error.
* A build that fails raises ``NativeLibraryError``, also through the codecs
  and ``tokenize_corpus``; ``MG_NATIVE=0`` builds nothing.
* The public functions the port copies beside them (``sliding_prefetch``,
  ``TempoMap.time_to_tick``/``tempi``, ``NoteSeq``'s adjusters,
  ``VocabSpec``'s helpers and ``PERFORMANCE``, ``add_noise``,
  ``debug_nans``, ``annotate``) against their JAX counterparts.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu import native as jnative
from musicgeneration_tpu import vocab as jvocab
from musicgeneration_tpu.cli import tokenize as jtok_cli
from musicgeneration_tpu.data import batching as jbatching
from musicgeneration_tpu.data import prefetch as jprefetch
from musicgeneration_tpu.midi import MidiFile as JMidiFile
from musicgeneration_tpu.midi.timing import TempoMap as JTempoMap
from musicgeneration_tpu.tokenizers import cp as jcp
from musicgeneration_tpu.tokenizers import melody as jmelody
from musicgeneration_tpu.tokenizers import midilike as jmidilike
from musicgeneration_tpu.tokenizers import pedal_midilike as jpedal
from musicgeneration_tpu.tokenizers import remi as jremi
from musicgeneration_tpu.tokenizers.mumidi import MuMIDI_EventSeq as JMuMIDI
from musicgeneration_tpu.utils import profiling as jprof
from musicgeneration_tpu_torch import native, vocab
from musicgeneration_tpu_torch.cli import tokenize as tok_cli
from musicgeneration_tpu_torch.data import batching, pipeline, prefetch
from musicgeneration_tpu_torch.midi import (ControlChange, Instrument,
                                            MidiFile, Note, TempoChange)
from musicgeneration_tpu_torch.midi.timing import TempoMap
from musicgeneration_tpu_torch.tokenizers import (cp, melody, midilike,
                                                  pedal_midilike, remi)
from musicgeneration_tpu_torch.tokenizers.mumidi import MuMIDI_EventSeq
from musicgeneration_tpu_torch.utils import profiling

from .fixtures import (motif_piano_midi, multitrack_midi, polyphonic_midi,
                       simple_piano_midi, tempo_change_midi)

SCHEMES = ("midilike", "midilike_control", "remi", "pedal", "melody", "cp",
           "mumidi")
# the MuMIDI roles (track names) and their GM programs (0-indexed in the
# file)
ROLES = ("melody", "piano", "bass", "guitar", "string")
ROLE_PROGRAMS = (72, 0, 32, 24, 65)


def random_piece(path: str, seed: int) -> str:
    """A seeded piece: 1-5 tracks of random notes (MuMIDI roles, a drum
    track in some), 1-3 tempi, a sustain pedal on the first
    track in most, at one of four resolutions."""
    rng = np.random.default_rng(seed)
    tpb = int(rng.choice([96, 220, 384, 480]))
    span = 24 * tpb
    midi = MidiFile(ticks_per_beat=tpb)
    times = [0] + sorted(int(t) for t in rng.integers(1, span,
                                                      rng.integers(0, 3)))
    midi.tempo_changes = [TempoChange(tempo=float(rng.uniform(40, 200)),
                                      time=t) for t in times]
    midi._tempo_raw = [(tc.time, int(round(60e6 / tc.tempo)))
                       for tc in midi.tempo_changes]
    for k in range(int(rng.integers(1, 6))):
        drum = k == 4 and seed % 2 == 0
        inst = Instrument(program=ROLE_PROGRAMS[k], is_drum=drum,
                          name="drum" if drum else ROLES[k])
        n = int(rng.integers(30, 160))
        starts = np.sort(rng.integers(0, span, n))
        if k == 0:  # some onsets on beats, some on bar downbeats
            starts[::7] = starts[::7] // tpb * tpb
        ends = starts + rng.integers(1, 2 * tpb, n)
        pitches = rng.integers(35 if drum else 21, 60 if drum else 109, n)
        vels = rng.integers(1, 128, n)
        inst.notes = [Note(velocity=int(v), pitch=int(p), start=int(s),
                           end=int(e))
                      for v, p, s, e in zip(vels, pitches, starts, ends)]
        if k == 0 and seed % 4 != 3:
            c, ccs = int(rng.integers(0, tpb)), []
            while c < span:
                ccs.append(ControlChange(64, int(rng.integers(64, 128)), c))
                c += int(rng.integers(tpb // 2, 4 * tpb))
                ccs.append(ControlChange(64, int(rng.integers(0, 64)), c))
                c += int(rng.integers(tpb // 4, 2 * tpb))
            inst.control_changes = ccs
        midi.instruments.append(inst)
    midi.dump(path)
    return path


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_pieces")
    paths = [simple_piano_midi(str(d / "simple.mid")),
             polyphonic_midi(str(d / "poly.mid")),
             multitrack_midi(str(d / "multi.mid")),
             tempo_change_midi(str(d / "tempo.mid")),
             motif_piano_midi(str(d / "motif.mid"), n_bars=12)]
    paths += [random_piece(str(d / f"rand{s}.mid"), s) for s in range(8)]
    return d, paths


def same(a, b) -> bool:
    """Equal values, array dtypes and bytes, through dicts and tuples."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(
            same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


def snapshot(m):
    """A MidiFile's content, for either package's class."""
    return {
        "tpb": m.ticks_per_beat, "max_tick": m.max_tick,
        "tempo": [(t.tempo, t.time) for t in m.tempo_changes],
        "tempo_raw": list(getattr(m, "_tempo_raw", [])),
        "insts": [(i.program, i.is_drum, i.name,
                   [(n.pitch, n.velocity, n.start, n.end) for n in i.notes],
                   [(c.number, c.value, c.time) for c in i.control_changes])
                  for i in m.instruments],
        "markers": [(mk.text, mk.time) for mk in m.markers],
        "timesigs": [(t.numerator, t.denominator, t.time)
                     for t in m.time_signature_changes]}


# (the port's native-first entry, the JAX package's): each takes a path
ENTRIES = {
    "parse": (lambda p: snapshot(MidiFile(p)),
              lambda p: snapshot(JMidiFile(p))),
    "midilike": (midilike.encode_array, jmidilike.encode_array),
    "remi": (remi.encode_array, jremi.encode_array),
    "pedal": (pedal_midilike.encode_array, jpedal.encode_array),
    "pedal_faithful": (lambda p: pedal_midilike.encode_array(p, True),
                       lambda p: jpedal.encode_array(p, True)),
    "cp": (cp.encode_rows, jcp.encode_rows),
    "mumidi": (MuMIDI_EventSeq.encode_split_arrays,
               JMuMIDI.encode_split_arrays),
    "melody": (melody.midi_to_note_array, jmelody.midi_to_note_array),
}


# the port's Python path each native-first entry falls back to: the tests
# replace it by one that fails, so the port's output is the native one
ORACLES = {"midilike": (midilike, "extract_events"),
           "remi": (remi, "encode_array_py"),
           "pedal": (pedal_midilike, "encode_midi"),
           "pedal_faithful": (pedal_midilike, "encode_midi"),
           "cp": (cp, "extract_events"),
           "mumidi": (MuMIDI_EventSeq, "extract_split_events")}


def _no_fallback(*args, **kw):
    raise AssertionError("the native path fell back to Python")


def jax_python(name, path, monkeypatch):
    """The JAX package's Python path (its semantics oracle)."""
    with monkeypatch.context() as m:
        m.setenv("MG_NATIVE", "0")
        if name == "midilike":
            return jmidilike.extract_events(path).to_array()
        if name == "remi":
            return jremi.encode_array_py(path)
        if name.startswith("pedal"):
            return np.asarray(jpedal.encode_midi(
                path, faithful=name == "pedal_faithful"), np.uint16)
        if name == "cp":
            return jcp.extract_events(path)
        return ENTRIES[name][1](path)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_native_entry_points_byte_equal_jax(name, pieces, monkeypatch):
    monkeypatch.delenv("MG_NATIVE", raising=False)
    assert native.available() and jnative.available()
    port, jax_native = ENTRIES[name]
    for path in pieces[1]:
        # parse and melody read the parse rows: the scanner must answer
        assert native.parse_midi_bytes(
            pathlib.Path(path).read_bytes()) is not None, path
        with monkeypatch.context() as m:
            if name in ORACLES:
                m.setattr(*ORACLES[name], _no_fallback)
            got = port(path)
        assert same(got, jax_native(path)), (name, path)
        want = jax_python(name, path, monkeypatch)
        if name == "parse":  # the JAX package's own paths differ here
            assert got["max_tick"] >= want["max_tick"]
            got, want = dict(got, max_tick=0), dict(want, max_tick=0)
        assert same(got, want), (name, path)


def _shards(out_dir):
    arrays = {}
    for f in sorted(pathlib.Path(out_dir).glob("*.npz")):
        with np.load(f) as z:
            arrays[f.name] = {k: z[k] for k in z.files}
    with open(pathlib.Path(out_dir) / "manifest.json") as f:
        return arrays, json.load(f)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_cli_tokenize_shards_equal_jax_and_python_path(scheme, pieces,
                                                       monkeypatch):
    d, _ = pieces
    out = d.parent / f"shards_{d.name}_{scheme}"
    argv = ["--scheme", scheme, "--workers", "1", "--shard-size", "8"]
    monkeypatch.delenv("MG_NATIVE", raising=False)
    assert tok_cli.main([str(d), str(out / "port"), *argv]) == 0
    assert jtok_cli.main([str(d), str(out / "jax"), *argv]) == 0
    monkeypatch.setenv("MG_NATIVE", "0")
    assert tok_cli.main([str(d), str(out / "py"), *argv]) == 0
    port = _shards(out / "port")
    assert port[1]["n_ok"] >= 5 and len(port[0]) >= 1
    assert same(port, _shards(out / "jax"))
    assert same(port, _shards(out / "py"))


def _outcome(fn, path):
    try:
        return ("ok", fn(path))
    except Exception as e:  # noqa: BLE001 — the error is the result
        return ("err", type(e).__name__)


@pytest.mark.parametrize("kind", ["truncated", "mutated"])
def test_fuzzed_bytes_match_jax(kind, tmp_path, monkeypatch):
    """Truncations of the six-role piece and byte mutations of a piano
    piece (as tests/test_native_robustness.py): every entry point
    survives and gives the JAX package's result or error type."""
    monkeypatch.delenv("MG_NATIVE", raising=False)
    src = str(tmp_path / "base.mid")
    if kind == "truncated":
        multitrack_midi(src)
        data = open(src, "rb").read()
        variants = [data[:n] for n in range(0, len(data) + 1,
                                            max(1, len(data) // 40))]
    else:
        simple_piano_midi(src, seed=4, n_notes=120)
        data = bytearray(open(src, "rb").read())
        rng = np.random.RandomState(0)
        variants = []
        for _ in range(40):
            m = bytearray(data)
            for _ in range(rng.randint(1, 6)):
                m[rng.randint(0, len(m))] = rng.randint(0, 256)
            variants.append(bytes(m))
    p = str(tmp_path / "f.mid")
    for i, blob in enumerate(variants):
        with open(p, "wb") as f:
            f.write(blob)
        assert same(native.parse_midi_bytes(blob),
                    jnative.parse_midi_bytes(blob)), i
        for name, (port, jax_fn) in ENTRIES.items():
            assert same(_outcome(port, p), _outcome(jax_fn, p)), (i, name)


def test_failed_build_raises(pieces, monkeypatch, tmp_path):
    """A compiler that is missing or fails raises NativeLibraryError with
    its output, through the entry points, the codecs and
    tokenize_corpus (before any file is quarantined); MG_NATIVE=0 builds
    nothing and takes the Python paths."""
    d, paths = pieces
    monkeypatch.delenv("MG_NATIVE", raising=False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(native.NativeLibraryError, match="not found"):
        native.available()
    with pytest.raises(native.NativeLibraryError):
        remi.encode_array(paths[0])
    with pytest.raises(native.NativeLibraryError):
        MidiFile(paths[0])
    with pytest.raises(native.NativeLibraryError):
        pipeline.tokenize_corpus(str(d), str(tmp_path / "out"), "midilike",
                                 1)
    assert not (tmp_path / "out" / "quarantine.jsonl").exists()
    script = tmp_path / "cxx.sh"
    script.write_text("#!/bin/sh\necho 'cc1plus: fatal: out of luck' >&2\n"
                      "exit 3\n")
    script.chmod(0o755)
    monkeypatch.setenv("CXX", str(script))
    with pytest.raises(native.NativeLibraryError,
                       match="failed \\(3\\):\n.*out of luck"):
        native.encode_pedal(pathlib.Path(paths[0]).read_bytes())
    assert not native.lib_path().exists()
    monkeypatch.setenv("MG_NATIVE", "0")
    assert native.available() is False
    assert same(remi.encode_array(paths[0]), jremi.encode_array(paths[0]))


# --------------------------------------------------------------------------
# the public functions beside the codecs
# --------------------------------------------------------------------------

def _prefetch_case():
    def run(fn, **kw):
        pulled = []

        def batches():
            for i in range(5):
                pulled.append(i)
                yield {"x": np.full((2, 3), i, np.int32)}
        out, seen = [], []
        for b in fn(batches(), size=2, **kw):
            seen.append(len(pulled))
            out.append(np.asarray(b["x"]))
        return out, seen
    got, gseen = run(prefetch.sliding_prefetch, device="cpu")
    want, wseen = run(jprefetch.sliding_prefetch)
    assert gseen == wseen
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


def _tempo_case():
    changes = [(0, 500000), (960, 400000), (960, 300000), (4000, 800000)]
    got, want = TempoMap(changes, 480), JTempoMap(changes, 480)
    t = np.linspace(0.0, 9.0, 97)
    np.testing.assert_array_equal(got.time_to_tick(t), want.time_to_tick(t))
    np.testing.assert_array_equal(
        got.time_to_tick(got.tick_to_time(np.arange(0, 6000, 7))),
        want.time_to_tick(want.tick_to_time(np.arange(0, 6000, 7))))
    assert got.tempi() == want.tempi()


def _noteseq_case():
    from musicgeneration_tpu.midi import Note as JNote
    rng = np.random.default_rng(3)
    rows = [(int(v), int(p), float(s), float(s + d)) for v, p, s, d in zip(
        rng.integers(1, 128, 60), rng.integers(55, 70, 60),
        np.round(rng.uniform(0, 8, 60), 2), rng.uniform(0.05, 1.5, 60))]
    ours = midilike.NoteSeq([Note(*r) for r in rows])
    theirs = jmidilike.NoteSeq([JNote(*r) for r in rows])
    for seq in (ours, theirs):
        seq.adjust_pitches(50)
        seq.adjust_velocities(-30)
        seq.trim_overlapped_notes(0.3)
    assert [(n.velocity, n.pitch, n.start, n.end) for n in ours.notes] == \
        [(n.velocity, n.pitch, n.start, n.end) for n in theirs.notes]


def _vocab_case():
    ids = np.arange(0, 500)
    for name in ("MIDILIKE", "REMI", "MUMIDI", "CONTROL", "PERFORMANCE"):
        got, want = getattr(vocab, name), getattr(jvocab, name)
        assert got.dim() == want.dim() and got.names == want.names, name
        for i, feat in enumerate(want.names):
            assert got.start(feat) == want.start(feat)
            assert got.encode(feat, 1) == want.encode(feat, 1)
            assert got.feature_index(feat) == want.feature_index(feat) == i
            np.testing.assert_array_equal(got.is_feat(feat, ids),
                                          want.is_feat(feat, ids))


def _noise_case():
    x = np.random.default_rng(0).integers(0, 300, (3, 4, 250))
    np.testing.assert_array_equal(
        batching.add_noise(x, 307, 0.05, np.random.RandomState(9)),
        jbatching.add_noise(x, 307, 0.05, np.random.RandomState(9)))
    assert batching.add_noise(x, 307, 0.001) is not x


def _debug_nans_case():
    """Both turn a NaN into an error: JAX in the forward, torch's anomaly
    mode in the backward that produces it."""
    try:
        jprof.debug_nans(True)
        with pytest.raises(FloatingPointError):
            jax.grad(lambda v: (v - v) / (v - v))(jnp.float32(1.0))
    finally:
        jprof.debug_nans(False)
    try:
        profiling.debug_nans(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor(1.0, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            ((x - x) / (x - x)).backward()
    finally:
        profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()


def _annotate_case():
    with jprof.annotate("region"):
        pass
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("mg_region"):
            torch.ones(4).sum()
    assert "mg_region" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("case", [
    _prefetch_case, _tempo_case, _noteseq_case, _vocab_case, _noise_case,
    _debug_nans_case, _annotate_case],
    ids=["sliding_prefetch", "time_to_tick-tempi", "noteseq-adjust",
         "vocabspec-performance", "add_noise", "debug_nans", "annotate"])
def test_public_functions_match_jax(case):
    case()
