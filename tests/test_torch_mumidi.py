"""The port's MuMIDI codec, compound packing and ``mumidi`` shard writer
against the JAX package's Python path (``MG_NATIVE=0``: the port has no
native scanner), on the ``tests/fixtures.py`` MIDIs: identical events,
token arrays, bar segments, packed compound rows, labels and batches,
MIDI bytes, and shards."""

import os

import numpy as np
import pytest

from musicgeneration_tpu import vocab as jvocab
from musicgeneration_tpu.data import mumidi_packing as jmp
from musicgeneration_tpu.data.pipeline import tokenize_corpus as jtokenize
from musicgeneration_tpu.tokenizers.mumidi import MuMIDI_EventSeq as JMu
from musicgeneration_tpu_torch import vocab as tvocab
from musicgeneration_tpu_torch.data import mumidi_packing as tmp_
from musicgeneration_tpu_torch.data.pipeline import (TokenCorpus,
                                                     tokenize_corpus)
from musicgeneration_tpu_torch.midi import MidiFile
from musicgeneration_tpu_torch.tokenizers.mumidi import MuMIDI_EventSeq as TMu

from .fixtures import multitrack_midi, simple_piano_midi

MAKERS = {
    "multitrack": lambda p: multitrack_midi(p),
    "multitrack_slow": lambda p: multitrack_midi(p, seed=5, n_bars=6,
                                                 tempo=95.0),
    "piano": lambda p: simple_piano_midi(p, seed=1, n_notes=60),
}


@pytest.fixture(autouse=True)
def _python_path(monkeypatch):
    """The JAX codec's Python path, the semantics the port copies."""
    monkeypatch.setenv("MG_NATIVE", "0")


@pytest.fixture(scope="module", params=sorted(MAKERS))
def midi(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mumidi") / f"{request.param}.mid")
    MAKERS[request.param](path)
    return path


@pytest.fixture(scope="module", params=["multitrack", "multitrack_slow"])
def multi(request, tmp_path_factory):
    """The fixtures with a melody and arrangement roles."""
    path = str(tmp_path_factory.mktemp("mumidi_m") / f"{request.param}.mid")
    MAKERS[request.param](path)
    return path


def _ev(events):
    return [(e.name, e.time, e.value, e.text) for e in events]


def test_vocab_spec_and_constants_copied():
    assert tvocab.MUMIDI.feat_dims() == jvocab.MUMIDI.feat_dims()
    assert tvocab.MUMIDI.dims_feat() == jvocab.MUMIDI.dims_feat()
    for name in ("MUMIDI_FRACTION", "MUMIDI_PITCH_RANGE", "MUMIDI_DRUM_TYPE",
                 "MUMIDI_TRACKS", "MUMIDI_TRACK_IDX",
                 "MUMIDI_INSTRUMENT_NUMBERS"):
        assert getattr(tvocab, name) == getattr(jvocab, name), name
    for name in ("MUMIDI_DURATION_BINS", "MUMIDI_VELOCITY_BINS"):
        np.testing.assert_array_equal(getattr(tvocab, name),
                                      getattr(jvocab, name))
    assert TMu.dims_feat() == JMu.dims_feat()
    assert (tmp_.SHIFT, tmp_.OUT_LEN, tmp_.MX_DIM, tmp_.BAR_TOKEN,
            tmp_.POS0, tmp_.EVENT_DIM) == (jmp.SHIFT, jmp.OUT_LEN,
                                           jmp.MX_DIM, jmp.BAR_TOKEN,
                                           jmp.POS0, jmp.EVENT_DIM)


def test_events_and_arrays_equal_jax(midi):
    assert _ev(TMu.extract_events(midi)) == _ev(JMu.extract_events(midi))
    t_mel, t_arr = TMu.extract_split_events(midi)
    j_mel, j_arr = JMu.extract_split_events(midi)
    assert (t_mel is None) == (j_mel is None)
    t_a, t_b = TMu.encode_split_arrays(midi)
    j_a, j_b = JMu.encode_split_arrays(midi)
    if j_mel is None:         # no melody track: both skip the file
        assert t_mel is t_arr is t_a is t_b is j_b is None
        return
    assert _ev(t_mel) == _ev(j_mel) and _ev(t_arr) == _ev(j_arr)
    for t, j in ((t_a, j_a), (t_b, j_b)):
        assert t.dtype == j.dtype == np.uint16
        np.testing.assert_array_equal(t, j)
    # id <-> event round trip, names and values
    for arr in (t_a, t_b):
        assert _ev(TMu.from_array(arr)) == _ev(JMu.from_array(arr))
        np.testing.assert_array_equal(TMu.to_array(TMu.from_array(arr)),
                                      arr)
    assert TMu.filter_melody(t_a) == JMu.filter_melody(t_a)
    assert TMu.count_bar(t_b) == JMu.count_bar(t_b)


def test_segmentation_and_packing_equal_jax(multi):
    t_a, t_b = TMu.encode_split_arrays(multi)
    mel, arr = TMu.segmentation(t_a), TMu.segmentation(t_b)
    j_mel, j_arr = JMu.segmentation(t_a), JMu.segmentation(t_b)
    assert len(mel) == len(j_mel) and len(arr) == len(j_arr)
    for x, y in zip(mel + arr, j_mel + j_arr):
        np.testing.assert_array_equal(x, y)
    for delta in (0, -1):
        got, lens = tmp_.pack_compound(arr, delta)
        ref, j_lens = jmp.pack_compound(arr, delta)
        assert lens == j_lens
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(x, y)
    bars = [np.append(b, jmp.BAR_TOKEN) for b in arr]
    for x, y in zip(tmp_.pack_labels(bars), jmp.pack_labels(bars)):
        for a, b in zip(x, y):
            np.testing.assert_array_equal(a, b)
    pairs = [(mel, arr), (mel[:2], arr[:2]), (mel[1:], arr[1:])]
    for kw in ({}, {"pad_bars_to": 8, "pad_len_to": 256}):
        got, ref = tmp_.pack_batch(pairs, **kw), jmp.pack_batch(pairs, **kw)
        for field in ("src", "src_len", "tar", "tar_len", "labels",
                      "label_mask"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(ref, field))
    assert tmp_.bar_id(500) == jmp.bar_id(500)
    assert tmp_.compound_vocab_size() == jmp.compound_vocab_size()


def test_write_midi_bytes_and_read_back(multi, tmp_path):
    t_a, t_b = TMu.encode_split_arrays(multi)
    stream = np.concatenate([t_a, t_b])
    t_path, j_path = str(tmp_path / "t.mid"), str(tmp_path / "j.mid")
    TMu.write_midi(TMu.from_array(stream), t_path)
    JMu.write_midi(JMu.from_array(stream), j_path)
    with open(t_path, "rb") as f, open(j_path, "rb") as g:
        assert f.read() == g.read()
    back = MidiFile(t_path)
    names = sorted(i.name for i in back.instruments)
    assert "melody" in names and len(names) > 1
    assert sum(len(i.notes) for i in back.instruments) > 0


def test_mumidi_shards_equal_jax(tmp_path):
    src = tmp_path / "midis"
    src.mkdir()
    for name, make in MAKERS.items():
        make(str(src / f"{name}.mid"))
    t_stats = tokenize_corpus(str(src), str(tmp_path / "t"), "mumidi",
                              num_workers=1)
    j_stats = jtokenize(str(src), str(tmp_path / "j"), "mumidi",
                        num_workers=1)
    assert (t_stats.n_ok, t_stats.n_failed) == (j_stats.n_ok,
                                                 j_stats.n_failed) == (2, 1)
    with np.load(t_stats.shards[0]) as t, np.load(j_stats.shards[0]) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            np.testing.assert_array_equal(t[k], j[k])
    corpus = TokenCorpus(str(tmp_path / "t"), key="melody")
    assert len(corpus) == 2
    assert corpus.pair(0, "arrangement").dtype == np.uint16
    assert os.path.exists(tmp_path / "t" / "quarantine.jsonl")
