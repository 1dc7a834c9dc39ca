"""The port's chord, REMI and CP codecs against the JAX package's, on the
``tests/fixtures.py`` MIDIs: identical items, tokens, rows and MIDI bytes;
and the port's model registry.

Fixture notes avoid exact bar downbeats where a test compares note
counts (REMI's ``group_items`` counts a downbeat item in both bars); the
token and row comparisons below hold either way, since both sides keep
that quirk."""

import numpy as np
import pytest

from musicgeneration_tpu.tokenizers import chords as jchords
from musicgeneration_tpu.tokenizers import cp as jcp
from musicgeneration_tpu.tokenizers import remi as jremi
from musicgeneration_tpu_torch import vocab as tvocab
from musicgeneration_tpu_torch.models import (CPTransformer, MusicTransformer,
                                              cp_transformer_defaults,
                                              get_model)
from musicgeneration_tpu_torch.tokenizers import chords as tchords
from musicgeneration_tpu_torch.tokenizers import cp as tcp
from musicgeneration_tpu_torch.tokenizers import remi as tremi

from .fixtures import (motif_piano_midi, multitrack_midi, polyphonic_midi,
                       simple_piano_midi, tempo_change_midi)

MAKERS = {
    "simple": lambda p: simple_piano_midi(p, seed=1, n_notes=60),
    "motif": lambda p: motif_piano_midi(p, seed=3, n_bars=12),
    "polyphonic": lambda p: polyphonic_midi(p),
    "multitrack": lambda p: multitrack_midi(p),
    "tempo_change": lambda p: tempo_change_midi(p),
}


@pytest.fixture(scope="module", params=sorted(MAKERS))
def midi(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cpc") / f"{request.param}.mid")
    MAKERS[request.param](path)
    return path


def _items(mod, path):
    notes, tempos = mod.read_items(path)
    notes = mod.quantize_items(notes)
    return notes, tempos, mod.extract_chords(notes)


def _key(it):
    return (it.name, it.start, it.end, it.velocity, it.pitch)


def test_vocab_constants_copied():
    from musicgeneration_tpu import vocab as jvocab
    for name in ("REMI_FRACTION", "REMI_VELOCITY_STEPS", "REMI_RESOLUTION",
                 "CHORD_QUALITY", "CHORD_ROOT", "CHORD_MAP", "INV_CHORD_MAP",
                 "REMI_PITCH_RANGE", "REMI_TEMPO_INTERVALS"):
        assert getattr(tvocab, name) == getattr(jvocab, name), name
    for name in ("REMI_DURATION_BINS", "REMI_VELOCITY_BINS"):
        np.testing.assert_array_equal(getattr(tvocab, name),
                                      getattr(jvocab, name))
    assert tvocab.REMI.feat_dims() == jvocab.REMI.feat_dims()
    assert tvocab.REMI.dims_feat() == jvocab.REMI.dims_feat()


def test_chord_items(midi):
    jn, jt, jc = _items(jremi, midi)
    tn, tt, tc = _items(tremi, midi)
    assert [_key(i) for i in tn] == [_key(i) for i in jn]
    assert [_key(i) for i in tt] == [_key(i) for i in jt]
    assert [_key(i) for i in tc] == [_key(i) for i in jc]
    assert (tchords.MIDIChord().extract(tn)
            == jchords.MIDIChord().extract(jn))


def test_remi_tokens(midi):
    ref = jremi.encode_array_py(midi)
    got = tremi.encode_array_py(midi)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tremi.encode_array(midi), ref)
    tev = tremi.REMI_EventSeq.extract_events(midi)
    jev = jremi.REMI_EventSeq.extract_events(midi)
    assert [(e.name, e.time, e.value) for e in tev] == \
        [(e.name, e.time, e.value) for e in jev]
    np.testing.assert_array_equal(tremi.REMI_EventSeq.to_array(tev), ref)


def test_cp_rows(midi):
    ref = jcp.extract_events(midi)
    got = tcp.extract_events(midi)
    assert got.dtype == ref.dtype == np.uint16
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tcp.encode_rows(midi), ref)
    flat = tcp.to_array(got).reshape(-1)
    np.testing.assert_array_equal(tcp.from_array(flat),
                                  jcp.from_array(flat))
    np.testing.assert_array_equal(tcp.to_array(got), jcp.to_array(ref))


def test_cp_write_midi_bytes(midi, tmp_path):
    rows = jcp.extract_events(midi)
    jcp.write_midi(rows, str(tmp_path / "j.mid"))
    tcp.write_midi(rows, str(tmp_path / "t.mid"))
    assert (tmp_path / "t.mid").read_bytes() == \
        (tmp_path / "j.mid").read_bytes()
    np.testing.assert_array_equal(tcp.extract_events(str(tmp_path / "t.mid")),
                                  jcp.extract_events(str(tmp_path / "j.mid")))


def test_remi_write_midi_bytes(midi, tmp_path):
    ev = jremi.REMI_EventSeq.extract_events(midi)
    arr = jremi.REMI_EventSeq.to_array(ev)
    jremi.REMI_EventSeq.write_midi(jremi.REMI_EventSeq.from_array(arr),
                                   str(tmp_path / "j.mid"))
    tremi.REMI_EventSeq.write_midi(tremi.REMI_EventSeq.from_array(arr),
                                   str(tmp_path / "t.mid"))
    assert (tmp_path / "t.mid").read_bytes() == \
        (tmp_path / "j.mid").read_bytes()


def test_cp_write_midi_sampled_rows_bytes(tmp_path):
    """Random in-range rows (what a sampling model writes: malformed
    combinations, EOS, out-of-grid positions) decode to the same bytes."""
    rng = np.random.default_rng(5)
    rows = np.stack([rng.integers(0, fd, 300) for fd in jcp.field_dims()],
                    -1)
    rows[:, 0] = rng.choice([0, 0, 1, 1, 1, 3], 300)
    rows[250, 0] = jcp.FAMILY_EOS
    jcp.write_midi(rows, str(tmp_path / "j.mid"))
    tcp.write_midi(rows, str(tmp_path / "t.mid"))
    assert (tmp_path / "t.mid").read_bytes() == \
        (tmp_path / "j.mid").read_bytes()


def test_cp_spec_copied():
    assert tcp.field_names() == jcp.field_names()
    assert tcp.field_dims() == jcp.field_dims() == \
        [4, 18, 4, 61, 62, 128, 65, 5]
    assert tcp.ignore_ids() == jcp.ignore_ids()
    assert tcp.dim() == 347
    assert tcp._row(tcp.FAMILY_NOTE, pitch=60) == \
        jcp._row(jcp.FAMILY_NOTE, pitch=60)


def test_registry_lookup():
    cls, defaults = get_model("cp_transformer")
    assert cls is CPTransformer
    assert defaults() == cp_transformer_defaults() == dict(
        num_layers=4, d_model=256, max_seq=1024, dropout_rate=0.1)
    assert defaults(max_seq=512)["max_seq"] == 512
    cls, defaults = get_model("music_transformer")
    assert cls is MusicTransformer and defaults()["max_seq"] == 2048


def test_registry_unknown_name_lists_the_registered():
    with pytest.raises(KeyError) as e:
        get_model("popmag")
    assert ("unknown model 'popmag'; registered: ['cp_transformer', "
            "'event_rnn', 'music_transformer', 'performance_rnn']") \
        in str(e.value)
