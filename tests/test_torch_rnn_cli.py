"""The port's CLIs on the RNN families, on ``--device cpu``:
``cli.tokenize --scheme midilike_control|melody`` (shards equal to the
JAX package's array for array, its codecs on their Python path,
``MG_NATIVE=0``); ``cli.train`` of each family and mode for a few steps,
interrupted after step 0 and resumed to the uninterrupted losses; the
JAX CLI's mode refusals; ``cli.generate`` and ``cli.serve`` from the
step files (greedy output equal to the engine's, written through the
recorded scheme's codec); ``--control <corpus dir>`` picking the JAX
CLI's sequence. Widths: hidden 16, 2 layers, init_dim 4."""

import json
import os

import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli.generate import _parse_control as j_parse_control
from musicgeneration_tpu.data.pipeline import (
    tokenize_corpus as j_tokenize_corpus)
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import serve as tserve
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate)
from musicgeneration_tpu_torch.models import (EventMelodyRNN, MelodyRNN,
                                              PerformanceRNN)
from musicgeneration_tpu_torch.tokenizers import melody, midilike
from musicgeneration_tpu_torch.utils.checkpoint import restore_checkpoint

from .fixtures import motif_piano_midi, multitrack_midi

SMALL = ["model.hidden_dim=16", "model.num_layers=2"]
GRU = SMALL + ["model.init_dim=4"]
RUNS = {
    "event_crop": ("midilike", ["model=event_rnn", "seq_len=32"] + GRU),
    "event_segment": ("midilike", ["model=event_rnn", "train_mode=segment",
                                   "seq_len=32"] + GRU),
    "event_window_scheduled": ("midilike", [
        "model=event_rnn", "train_mode=window", "window_size=24",
        "stride_size=12", "teacher_forcing_ratio=0.5"] + GRU),
    "event_sequence": ("midilike", ["model=event_rnn",
                                    "train_mode=sequence"] + GRU),
    "performance_control": ("midilike_control", [
        "model=performance_rnn", "seq_len=32"] + GRU),
    "performance_window": ("midilike", [
        "model=performance_rnn", "train_mode=window", "window_size=24",
        "stride_size=12"] + GRU),
    "melody_basic": ("melody", ["model=melody_rnn", "seq_len=24"] + SMALL),
    "melody_attn": ("melody", ["model=melody_rnn", "seq_len=24",
                               "model.attn_length=8"] + SMALL),
}


@pytest.fixture(autouse=True)
def _python_codecs(monkeypatch):
    monkeypatch.setenv("MG_NATIVE", "0")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """Six piano MIDIs and two multi-track ones, tokenized by the port in
    all three schemes."""
    tmp = tmp_path_factory.mktemp("rnn_cli")
    os.makedirs(tmp / "midis")
    for i in range(6):
        motif_piano_midi(str(tmp / "midis" / f"p{i}.mid"), seed=i,
                         n_bars=8 + 2 * i)
    for i in range(2):
        multitrack_midi(str(tmp / "midis" / f"m{i}.mid"), seed=i)
    for scheme in ("midilike", "midilike_control", "melody"):
        assert ttok.main([str(tmp / "midis"), str(tmp / scheme), "--scheme",
                          scheme, "--workers", "1"]) == 0
    return tmp


def _train(base, scheme, run, steps, extra):
    return tcli.main([str(base / scheme), f"steps={steps}", "batch_size=2",
                      f"ckpt_dir={base / run}", "ckpt_every=1", "log_every=1",
                      f"metrics_path={base / (run + '.jsonl')}", *extra,
                      "--device", "cpu"])


def _losses(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if r["kind"] == "train"}


@pytest.fixture(scope="module")
def runs(base):
    """Each family and mode: a 3-step run and the same run cut after step
    0 and resumed."""
    for name, (scheme, extra) in RUNS.items():
        assert _train(base, scheme, name, 3, extra) == 0
        assert _train(base, scheme, name + "_cut", 1, extra) == 0
        assert _train(base, scheme, name + "_cut", 3, extra) == 0
    return base


@pytest.mark.parametrize("scheme", ["midilike_control", "melody"])
def test_shards_equal_jax(base, tmp_path, scheme):
    j_tokenize_corpus(str(base / "midis"), str(tmp_path / "j"), scheme=scheme,
                      num_workers=1)
    for name in json.load(open(tmp_path / "j" / "manifest.json"))["shards"]:
        with np.load(base / scheme / name) as ours, \
                np.load(tmp_path / "j" / name) as theirs:
            assert sorted(ours.files) == sorted(theirs.files)
            for key in theirs.files:
                assert ours[key].dtype == theirs[key].dtype, key
                np.testing.assert_array_equal(ours[key], theirs[key])
    ours = json.load(open(base / scheme / "manifest.json"))
    theirs = json.load(open(tmp_path / "j" / "manifest.json"))
    assert ours == theirs and ours["n_ok"] == 8


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cli_train_resumes_to_equal_losses(runs, name):
    full = _losses(runs / f"{name}.jsonl")
    cut = _losses(runs / f"{name}_cut.jsonl")
    assert sorted(full) == sorted(cut) == [0, 1, 2]
    assert all(np.isfinite(list(full.values())))
    for step in full:
        np.testing.assert_allclose(cut[step], full[step], rtol=1e-5)
    ck = restore_checkpoint(str(runs / name))
    scheme, extra = RUNS[name]
    assert ck["step"] == 2 and ck["config"]["scheme"] == scheme
    model, config = convert.load_checkpoint(str(runs / name), device="cpu",
                                            with_config=True)
    family = ck["config"]["cli"]["model"]
    assert model.family == family and model.hidden_dim == 16
    assert isinstance(model, {"event_rnn": EventMelodyRNN,
                              "performance_rnn": PerformanceRNN,
                              "melody_rnn": MelodyRNN}[family])
    if name == "melody_attn":
        assert model.attn_length == 8 == config["model_kwargs"]["attn_length"]


@pytest.mark.parametrize("model,scheme,extra,match", [
    ("melody_rnn", "melody", ["train_mode=window"], "plain RNN families"),
    ("music_transformer", "midilike", ["train_mode=window"],
     "plain RNN families"),
    ("performance_rnn", "midilike", ["train_mode=sequence"],
     "model=event_rnn"),
    ("performance_rnn", "midilike_control", ["train_mode=window"],
     "unconditioned"),
    ("event_rnn", "midilike", ["train_mode=bogus"], "unknown train_mode"),
    ("melody_rnn", "midilike", [], "'melody' corpus"),
    ("event_rnn", "melody", ["model.attn_length=4"],
     "unknown model overrides"),
])
def test_mode_and_scheme_refusals(base, model, scheme, extra, match):
    with pytest.raises(SystemExit, match=match):
        _train(base, scheme, "refused", 1, [f"model={model}", *extra])


def test_cli_generate_from_step_files(runs, tmp_path):
    """Greedy MelodyRNN generation from its step file, primed through
    ``midi_to_note_array``, writes the engine's tokens through
    ``note_array_to_midi``; the GRU step files generate sampled batches
    and a beam; MelodyRNN refuses a beam."""
    prime = str(runs / "midis" / "p0.mid")
    for name in ("melody_basic", "melody_attn"):
        out = tmp_path / f"{name}.mid"
        assert tgen.main([str(runs / name), str(out), "--prime", prime,
                          "--prime-len", "40", "--steps", "32",
                          "--temperature", "0", "--device", "cpu"]) == 0
        model = convert.load_checkpoint(str(runs / name), device="cpu")
        toks = melody.midi_to_note_array(prime)[:40].astype(np.int64)
        ref = generate(model, torch.from_numpy(toks)[None], None,
                       DecodeParams(max_len=72, steps=32,
                                    sampling=SamplingParams(greedy=True)))
        ref_path = tmp_path / f"{name}-ref.mid"
        melody.note_array_to_midi(ref[0].numpy(), str(ref_path))
        assert out.read_bytes() == ref_path.read_bytes()
    for name in ("event_window_scheduled", "performance_control"):
        out = tmp_path / f"{name}.mid"
        assert tgen.main([str(runs / name), str(out), "--prime", prime,
                          "--prime-len", "16", "--steps", "24", "--batch",
                          "2", "--device", "cpu"]) == 0
        assert len(midilike.extract_events(
            str(tmp_path / f"{name}-001.mid")).events) >= 0
    assert tgen.main([str(runs / "event_crop"), str(tmp_path / "b.mid"),
                      "--steps", "16", "--beam", "3", "--device",
                      "cpu"]) == 0
    with pytest.raises(SystemExit, match="GRU families"):
        tgen.main([str(runs / "melody_basic"), str(tmp_path / "x.mid"),
                   "--steps", "8", "--beam", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="decode_quant"):
        tgen.main([str(runs / "melody_basic"), str(tmp_path / "x.mid"),
                   "--steps", "8", "--quant", "int8", "--device", "cpu"])


@pytest.mark.parametrize("seed,index", [(0, None), (1, None), (5, None),
                                        (0, 3)])
def test_control_corpus_dir_picks_the_jax_sequence(base, seed, index):
    got = tgen.parse_control(str(base / "midilike_control"), index, seed)
    ref = j_parse_control(str(base / "midilike_control"), index, seed)
    assert got.shape[1] == 24
    np.testing.assert_array_equal(got, ref)


def test_control_corpus_dir_drives_generation(runs, tmp_path, capsys):
    """``--steps 0`` generates the picked sequence's length; a corpus of
    another scheme exits."""
    out = tmp_path / "c.mid"
    assert tgen.main([str(runs / "performance_control"), str(out),
                      "--steps", "0", "--control",
                      str(runs / "midilike_control"), "--seed", "1",
                      "--device", "cpu"]) == 0
    n = len(tgen.parse_control(str(runs / "midilike_control"), None, 1))
    assert f"({n} tokens)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not a midilike_control corpus"):
        tgen.main([str(runs / "performance_control"), str(out), "--steps",
                   "8", "--control", str(runs / "midilike"), "--device",
                   "cpu"])


def test_cli_serve_from_step_files(runs, tmp_path, capsys):
    """cli.serve on the MelodyRNN and EventMelodyRNN step files: greedy
    results equal ``generate`` written through the recorded scheme's
    codec; a MelodyRNN request with a latent is refused."""
    prime = str(runs / "midis" / "p1.mid")
    reqs = [{"id": "a", "max_new": 20},
            {"id": "b", "prime": prime, "prime_len": 30, "max_new": 28}]
    path = tmp_path / "reqs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    for name, scheme in (("melody_attn", "melody"), ("event_crop",
                                                     "midilike")):
        outdir = tmp_path / name
        assert tserve.main([str(runs / name), str(path), str(outdir),
                            "--greedy", "--slots", "2", "--seg-len", "8",
                            "--device", "cpu"]) == 0
        assert f"scheme {scheme}" in capsys.readouterr().out
        model = convert.load_checkpoint(str(runs / name), device="cpu")
        for r in reqs:
            toks = tgen.prime_tokens(r.get("prime"), r.get("prime_len", 500),
                                     scheme)
            ref = generate(model, torch.tensor([toks]), None, DecodeParams(
                max_len=len(toks) + r["max_new"], steps=r["max_new"],
                sampling=SamplingParams(greedy=True)))
            ref_path = tmp_path / f"{name}-{r['id']}.mid"
            tgen.write_midi(ref[0].numpy(), str(ref_path), scheme)
            assert (outdir / f"{r['id']}.mid").read_bytes() == \
                ref_path.read_bytes()
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"max_new": 4, "init_seed": 1}) + "\n")
    with pytest.raises(SystemExit, match="no init latent"):
        tserve.main([str(runs / "melody_basic"), str(bad),
                     str(tmp_path / "o"), "--device", "cpu"])


def test_rnn_clis_default_to_cuda(runs, monkeypatch, tmp_path):
    """cli.train, cli.generate and cli.serve of the RNN families run on
    cuda unless --device cpu is passed, and raise without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main([str(runs / "melody"), "model=melody_rnn", "steps=1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.main([str(runs / "melody_basic"), str(tmp_path / "x.mid"),
                   "--steps", "4"])
    req = tmp_path / "r.jsonl"
    req.write_text('{"max_new": 4}\n')
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main([str(runs / "event_crop"), str(req), str(tmp_path / "o")])
