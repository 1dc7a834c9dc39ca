"""The port's MIDI I/O and MIDI-like codec against the JAX package's:
the same token array writes byte-identical .mid files, and
``extract_events(...).to_array()`` of the fixture MIDIs is equal."""

import numpy as np
import pytest

from musicgeneration_tpu import vocab as jvocab
from musicgeneration_tpu.tokenizers import midilike as jmidilike
from musicgeneration_tpu_torch import vocab as tvocab
from musicgeneration_tpu_torch.tokenizers import midilike as tmidilike
from tests.fixtures import (
    multitrack_midi,
    polyphonic_midi,
    simple_piano_midi,
    tempo_change_midi,
)

FIXTURES = {
    "simple_piano": simple_piano_midi,
    "polyphonic": polyphonic_midi,
    "multitrack": multitrack_midi,
    "tempo_change": tempo_change_midi,
}


def test_vocab_layout_matches():
    assert tvocab.MIDILIKE.dim() == jvocab.MIDILIKE.dim() == 308
    assert tvocab.MIDILIKE.feat_ranges() == jvocab.MIDILIKE.feat_ranges()
    np.testing.assert_array_equal(tvocab.midilike_velocity_bins(),
                                  jvocab.midilike_velocity_bins())
    assert tvocab.MIDILIKE.array_dtype() == jvocab.MIDILIKE.array_dtype()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_extract_events_matches(name, tmp_path):
    path = str(tmp_path / f"{name}.mid")
    FIXTURES[name](path)
    a = tmidilike.extract_events(path).to_array()
    b = jmidilike.extract_events(path).to_array()
    assert a.dtype == b.dtype and len(a) > 0
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_midi_byte_identical(seed, tmp_path):
    """Random token streams (unbalanced note on/off, long shifts) and a
    fixture's own tokens."""
    if seed == 2:
        simple_piano_midi(str(tmp_path / "src.mid"))
        tokens = jmidilike.extract_events(str(tmp_path / "src.mid")).to_array()
    else:
        tokens = np.random.default_rng(seed).integers(0, 308, 600)
    pt, pj = tmp_path / "port.mid", tmp_path / "jax.mid"
    tmidilike.write_midi(tmidilike.EventSeq.from_array(tokens), str(pt))
    jmidilike.write_midi(jmidilike.EventSeq.from_array(tokens), str(pj))
    assert pt.read_bytes() == pj.read_bytes()
    assert len(pt.read_bytes()) > 22  # header + conductor track at least
