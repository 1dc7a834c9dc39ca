"""The port's ``cli.split``, ``cli.corpus_stats`` and ``cli.check_install``
on the CPU.

``split`` and ``corpus_stats`` are held line for line and file for file
against the JAX CLIs on the same inputs (a MIDI directory written by the
port's MIDI writer, a MAESTRO-style CSV with one missing file, a corpus
tokenized by the port); ``TokenCorpus.lengths``/``count`` against the JAX
``TokenCorpus``. ``check_install`` must exit 1 here (torch is built for
the CPU, there is no CUDA device and no ``nvcc``) and name each."""

import os

import numpy as np
import pytest

from musicgeneration_tpu.cli import corpus_stats as jstats
from musicgeneration_tpu.cli import split as jsplit
from musicgeneration_tpu.data.pipeline import TokenCorpus as JTokenCorpus
from musicgeneration_tpu_torch.cli import check_install as tcheck
from musicgeneration_tpu_torch.cli import corpus_stats as tstats
from musicgeneration_tpu_torch.cli import split as tsplit
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.data.pipeline import TokenCorpus
from musicgeneration_tpu_torch.tokenizers import midilike


@pytest.fixture(scope="module")
def midis(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    os.makedirs(root / "midis" / "sub")
    for i in range(11):
        toks = np.random.default_rng(i).integers(0, 308, 40 + 70 * i)
        sub = "sub" if i % 4 == 0 else ""
        midilike.write_midi(midilike.EventSeq.from_array(toks),
                            str(root / "midis" / sub / f"f{i:02d}.mid"))
    return root


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _both(capsys, port_main, jax_main, argv_of):
    """Run the port's CLI and the JAX one with argv_of('port'|'jax'):
    (their exit codes, their printed lines)."""
    rc_t = port_main(argv_of("port"))
    out_t = capsys.readouterr().out
    rc_j = jax_main(argv_of("jax"))
    out_j = capsys.readouterr().out
    return (rc_t, rc_j), (out_t.splitlines(), out_j.splitlines())


@pytest.mark.parametrize("ratios", [None, "0.6,0.2,0.2"])
def test_split_ratio_matches_jax(midis, tmp_path, capsys, ratios):
    extra = [] if ratios is None else ["--ratios", ratios]
    rcs, (lines_t, lines_j) = _both(
        capsys, tsplit.main, jsplit.main,
        lambda side: ["ratio", str(midis / "midis"), str(tmp_path / side)]
        + extra)
    assert rcs == (0, 0)
    assert lines_t == lines_j and lines_t[0].startswith("train: ")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    # a second run keeps what is there
    assert tsplit.main(["ratio", str(midis / "midis"),
                        str(tmp_path / "port")] + extra) == 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_split_maestro_matches_jax(midis, tmp_path, capsys):
    names = sorted(n for n in os.listdir(midis / "midis") if n.endswith(".mid"))
    rows = ["canonical_composer,split,midi_filename"]
    for i, name in enumerate(names + ["missing.mid"]):
        split = ["train", "validation", "test", "extra"][i % 4]
        rows.append(f"x,{split},{name}")
    csv_path = tmp_path / "maestro.csv"
    csv_path.write_text("\n".join(rows) + "\n")
    rcs, (lines_t, lines_j) = _both(
        capsys, tsplit.main, jsplit.main,
        lambda side: ["maestro", str(csv_path), str(midis / "midis"),
                      str(tmp_path / side)])
    assert rcs == (0, 0)
    assert lines_t == lines_j
    assert "extra: 2 files" in lines_t
    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "jax")
    assert len(tree) == len(names)  # the missing file is listed, not linked


@pytest.fixture(scope="module")
def corpus(midis):
    out = str(midis / "tok")
    assert ttok.main([str(midis / "midis"), out, "--workers", "1"]) == 0
    return out


@pytest.mark.parametrize("below", [None, ["--below", "100", "400", "5000"]],
                         ids=["defaults", "below"])
def test_corpus_stats_matches_jax(corpus, capsys, below):
    rcs, (lines_t, lines_j) = _both(
        capsys, tstats.main, jstats.main,
        lambda side: [corpus] + (below or []))
    assert rcs == (0, 0)
    assert lines_t == lines_j
    assert lines_t[0] == "sequences: 11"


def test_corpus_lengths_and_count_match_jax(corpus):
    for limlen in (0, 300):
        t, j = TokenCorpus(corpus, limlen=limlen), JTokenCorpus(corpus,
                                                                limlen=limlen)
        np.testing.assert_array_equal(t.lengths(), j.lengths())
        for v in (1, 100, 400, 10000):
            assert t.count(v) == j.count(v)


def test_corpus_stats_empty(corpus, capsys):
    assert tstats.main([corpus, "--key", "tokens"]) == 0
    capsys.readouterr()
    empty = os.path.join(os.path.dirname(corpus), "empty")
    os.makedirs(empty, exist_ok=True)
    assert tstats.main([empty]) == 1
    assert capsys.readouterr().out.strip() == "empty corpus"


def test_check_install_names_what_is_missing(capsys):
    assert tcheck.main([]) == 1
    out = capsys.readouterr().out
    assert "[ ] no CUDA device visible" in out
    assert "[ ] nvcc not found" in out
    assert "[ ] torch is built without CUDA" in out
    assert "[x] registered models: cp_transformer, event_rnn" in out
    assert out.strip().splitlines()[-1] == "PROBLEMS FOUND"
