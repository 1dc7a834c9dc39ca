"""The port's CLIs on PoPMAG, on ``--device cpu``: ``cli.tokenize --scheme
mumidi``, ``cli.train model=popmag`` (its batch stream equal to the JAX
CLI's; resumed losses equal to the uninterrupted run's), ``cli.generate``
(greedy output equal to ``generate_arrangement`` written through the
MuMIDI codec; ``--batch``) and ``cli.serve`` in file mode (greedy streams
equal to the port's serving engine; ``melody`` rows and ``prime`` MIDIs),
a ``.pth`` written by the JAX ``export_popmag`` loaded with
``strict=True``, and the refusals. Widths: embed and hidden 32, 2 layers;
the fixture's arrangement bars hold up to ~200 tokens, so the runs take
``max_bar_len=256`` and ``max_bars=4``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli import train as jcli
from musicgeneration_tpu.cli.export_checkpoint import export_popmag
from musicgeneration_tpu.cli.generate import (
    _melody_compound_from_midi as j_melody_compound)
from musicgeneration_tpu.data.pipeline import TokenCorpus as JTokenCorpus
from musicgeneration_tpu.models.popmag import PoPMAGRNN as JPoPMAG
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import serve as tserve
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.data.pipeline import TokenCorpus
from musicgeneration_tpu_torch.decode import SamplingParams
from musicgeneration_tpu_torch.decode.popmag_generate import (
    flatten_arrangement, generate_arrangement)
from musicgeneration_tpu_torch.decode.serving_popmag import (
    PopMAGContinuousBatcher)
from musicgeneration_tpu_torch.models import PoPMAGRNN
from musicgeneration_tpu_torch.tokenizers.mumidi import MuMIDI_EventSeq
from musicgeneration_tpu_torch.utils.checkpoint import restore_checkpoint

from .fixtures import multitrack_midi

BARS, BAR_LEN = 4, 256


def _train_args(tmp, run, steps, *extra):
    return [str(tmp / "tok"), "model=popmag", f"steps={steps}",
            "batch_size=2", "model.embed_dim=32", "model.hidden_dim=32",
            f"max_bars={BARS}", f"max_bar_len={BAR_LEN}",
            f"ckpt_dir={tmp / run}", "ckpt_every=1", "log_every=1",
            f"metrics_path={tmp / (run + '.jsonl')}", *extra,
            "--device", "cpu"]


def _losses(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if r["kind"] == "train"}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tokenized mumidi corpus, a 3-step run, and the same run cut after
    step 0 and resumed (step 2's loss then follows an update made with the
    restored Adam state)."""
    tmp = tmp_path_factory.mktemp("popmagcli")
    os.makedirs(tmp / "midis")
    for i in range(3):
        multitrack_midi(str(tmp / "midis" / f"m{i}.mid"), seed=i, n_bars=5)
    assert ttok.main([str(tmp / "midis"), str(tmp / "tok"), "--scheme",
                      "mumidi", "--workers", "1"]) == 0
    assert tcli.main(_train_args(tmp, "run", 3)) == 0
    assert tcli.main(_train_args(tmp, "cut", 1)) == 0
    assert tcli.main(_train_args(tmp, "cut", 3)) == 0
    return tmp


def test_tokenize_mumidi_shards(run_dir):
    with open(run_dir / "tok" / "manifest.json") as f:
        assert json.load(f)["scheme"] == "mumidi"
    ours = TokenCorpus(str(run_dir / "tok"), key="melody")
    theirs = JTokenCorpus(str(run_dir / "tok"), key="melody")
    assert len(ours) == 3
    for i in range(3):
        for key in ("melody", "arrangement"):
            np.testing.assert_array_equal(ours.pair(i, key),
                                          theirs.pair(i, key))


def test_popmag_batch_stream_equals_jax(run_dir):
    kw = dict(model="popmag", batch_size=2, seed=3, max_bars=BARS,
              max_bar_len=BAR_LEN)
    corpus = TokenCorpus(str(run_dir / "tok"), key="melody")
    ours = tcli._popmag_batch_fn(corpus, tcli.TrainCLIConfig(**kw))
    theirs = jcli._popmag_batch_fn(corpus, jcli.TrainCLIConfig(**kw))
    for idx in (0, 1, 5):
        x, y = ours(idx)
        ref = theirs(idx)
        assert x["src"].shape == (2, BARS, BAR_LEN, 7) and y.shape == (2,)
        for field in x:
            np.testing.assert_array_equal(x[field], getattr(ref, field))


def test_cli_train_popmag_records_and_resumes(run_dir):
    full = _losses(run_dir / "run.jsonl")
    cut = _losses(run_dir / "cut.jsonl")
    assert sorted(full) == [0, 1, 2] and all(np.isfinite(list(full.values())))
    # the resumed run starts at step 1 and repeats the uninterrupted losses
    assert sorted(cut) == [0, 1, 2]
    for step in full:
        np.testing.assert_allclose(cut[step], full[step], rtol=1e-5)
    ck = restore_checkpoint(str(run_dir / "run"))
    assert ck["step"] == 2 and ck["config"]["cli"]["model"] == "popmag"
    assert ck["config"]["cli"]["max_bars"] == BARS
    assert ck["config"]["scheme"] == "mumidi"
    model, config = convert.load_checkpoint(str(run_dir / "run"),
                                            device="cpu", with_config=True)
    assert isinstance(model, PoPMAGRNN) and model.family == "popmag"
    assert (model.embed_dim, model.hidden_dim, model.num_layers) == (32, 32,
                                                                     2)
    assert tgen.popmag_limits(config) == (BARS, BAR_LEN)
    assert tgen.popmag_limits({}) == (16, 96)       # an exported .pth


def test_melody_compound_equals_jax(run_dir):
    prime = str(run_dir / "midis" / "m1.mid")
    for bars, bar_len in ((BARS, BAR_LEN), (16, 96), (2, 30)):
        got = tgen.melody_compound_from_midi(prime, bars, bar_len)
        ref = j_melody_compound(prime, bars, bar_len)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no usable bars"):
        tgen.melody_compound_from_midi(prime, 16, 3)


def test_cli_generate_greedy_equals_generate_arrangement(run_dir, tmp_path):
    prime = str(run_dir / "midis" / "m2.mid")
    out = tmp_path / "arr.mid"
    assert tgen.main([str(run_dir / "run"), str(out), "--prime", prime,
                      "--temperature", "0", "--seed", "4", "--device",
                      "cpu"]) == 0
    model = convert.load_checkpoint(str(run_dir / "run"), device="cpu")
    src, src_len = tgen.melody_compound_from_midi(prime, BARS, BAR_LEN)
    init = torch.randn(1, 32, generator=torch.Generator().manual_seed(4))
    flat = flatten_arrangement(*generate_arrangement(
        model, init, src[None], src_len[None], src.shape[0], greedy=True))[0]
    ref = tmp_path / "ref.mid"
    MuMIDI_EventSeq.write_midi(MuMIDI_EventSeq.from_array(flat), str(ref))
    assert out.read_bytes() == ref.read_bytes()
    assert tgen.main([str(run_dir / "run"), str(tmp_path / "b.mid"),
                      "--prime", prime, "--batch", "2", "--device",
                      "cpu"]) == 0
    assert (tmp_path / "b-000.mid").exists()
    assert (tmp_path / "b-001.mid").exists()


def test_cli_serve_file_mode_equals_engine(run_dir, tmp_path, capsys):
    primes = [str(run_dir / "midis" / f"m{i}.mid") for i in range(3)]
    src, src_len = tgen.melody_compound_from_midi(primes[0], BARS, BAR_LEN)
    reqs = [{"id": "a", "prime": primes[1]},
            {"id": "b", "prime": primes[2], "max_new": 2, "init_seed": 3},
            {"id": "c", "melody": src.tolist(), "src_len": src_len.tolist(),
             "max_new": 3}]
    path = tmp_path / "reqs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    outdir = tmp_path / "served"
    assert tserve.main([str(run_dir / "run"), str(path), str(outdir),
                        "--greedy", "--slots", "2", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "bars/s" in text and "tok/s goodput" in text
    model = convert.load_checkpoint(str(run_dir / "run"), device="cpu")
    cb = PopMAGContinuousBatcher(
        model, slots=2, sampling=SamplingParams(greedy=True), max_bars=BARS,
        max_bar_len=BAR_LEN, prompt_bucket=4)
    cb.warm()
    rids = {}
    for r in reqs:
        if "melody" in r:
            s, sl = np.asarray(r["melody"]), np.asarray(r["src_len"])
        else:
            s, sl = tgen.melody_compound_from_midi(r["prime"], BARS, BAR_LEN)
        kw = {}
        if "init_seed" in r:
            kw["init"] = np.random.RandomState(r["init_seed"]).randn(32)
        rids[r["id"]] = cb.submit(s, r.get("max_new", s.shape[0]),
                                  src_len=sl, **kw)
    outs = cb.run()
    for name, rid in rids.items():
        ref = tmp_path / f"ref-{name}.mid"
        MuMIDI_EventSeq.write_midi(MuMIDI_EventSeq.from_array(outs[rid]),
                                   str(ref))
        assert (outdir / f"{name}.mid").read_bytes() == ref.read_bytes()
        assert int((outs[rid] == 321).sum()) >= 2


def test_reference_pth_loads_strict_and_generates(run_dir, tmp_path):
    """A bare state dict as ``export_popmag`` writes it (the reference
    PoPMAG_RNN's names) loads with ``strict=True`` and drives cli.generate
    and cli.serve."""
    jm = JPoPMAG(embed_dim=16, hidden_dim=24, num_layers=2)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32)),
                     jnp.zeros((1, 2, 3, 7), jnp.int32),
                     jnp.ones((1, 2), jnp.int32),
                     jnp.zeros((1, 2, 3, 7), jnp.int32),
                     jnp.ones((1, 2), jnp.int32))["params"]
    pth = tmp_path / "popmag.pth"
    torch.save(export_popmag(params, {}, 0), pth)
    model = convert.load_checkpoint(str(pth), device="cpu")
    assert isinstance(model, PoPMAGRNN)
    assert (model.embed_dim, model.hidden_dim, model.event_dim,
            model.bar_dim) == (16, 24, 485, 188)
    prime = str(run_dir / "midis" / "m0.mid")
    # a .pth records no run: the CLI's defaults, 16 bars of <= 96 tokens
    assert tgen.main([str(pth), str(tmp_path / "x.mid"), "--prime", prime,
                      "--device", "cpu"]) == 0
    src, _ = tgen.melody_compound_from_midi(prime, 16, 96)
    back = MuMIDI_EventSeq.extract_split_events(str(tmp_path / "x.mid"))
    assert src.shape[0] == 5 and back is not None
    req = tmp_path / "r.jsonl"
    req.write_text(json.dumps({"id": "p", "prime": prime, "max_new": 2})
                   + "\n")
    assert tserve.main([str(pth), str(req), str(tmp_path / "o"),
                        "--device", "cpu", "--greedy"]) == 0
    assert (tmp_path / "o" / "p.mid").exists()


def test_refusals(run_dir, tmp_path):
    prime = str(run_dir / "midis" / "m0.mid")
    with pytest.raises(SystemExit, match="needs --prime"):
        tgen.main([str(run_dir / "run"), str(tmp_path / "x.mid"),
                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="do not apply to PoPMAG"):
        tgen.main([str(run_dir / "run"), str(tmp_path / "x.mid"), "--prime",
                   prime, "--topk", "5", "--device", "cpu"])
    with pytest.raises(SystemExit, match="decode_quant"):
        tgen.main([str(run_dir / "run"), str(tmp_path / "x.mid"), "--prime",
                   prime, "--quant", "int8", "--device", "cpu"])
    req = tmp_path / "r.jsonl"
    req.write_text(json.dumps({"prime": prime, "eos": 321}) + "\n")
    with pytest.raises(SystemExit, match="retire by bar count"):
        tserve.main([str(run_dir / "run"), str(req), str(tmp_path / "o"),
                     "--device", "cpu"])
    with pytest.raises(SystemExit, match="typed heads"):
        tserve.main([str(run_dir / "run"), str(req), str(tmp_path / "o"),
                     "--topp", "0.9", "--device", "cpu"])
    os.makedirs(tmp_path / "midis")
    multitrack_midi(str(tmp_path / "midis" / "a.mid"))
    assert ttok.main([str(tmp_path / "midis"), str(tmp_path / "tok"),
                      "--workers", "1"]) == 0
    with pytest.raises(SystemExit, match="'mumidi' corpus"):
        tcli.main([str(tmp_path / "tok"), "model=popmag", "steps=1",
                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown model overrides"):
        tcli.main(_train_args(run_dir, "x", 1, "model.d_model=8"))
