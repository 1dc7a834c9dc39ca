"""The GRU families (EventMelodyRNN, PerformanceRNN) on the ``remi`` and
``pedal`` schemes, on ``--device cpu``, against the JAX package:

* the widths the port's ``cli.train`` builds (event_dim 336 and 389, the
  scheme's vocabulary less its pad id) equal the JAX CLI's
  ``build_session``: a JAX init of each loads into the port's model with
  ``strict=True``; the refusals the JAX CLI keeps (``train_mode=sequence``
  for PerformanceRNN) and the port's own (MelodyRNN's 130-row embedding
  on another scheme);
* ``cli.train`` in crop mode for each family and scheme, and in segment,
  window (scheduled sampling) and sequence mode, cut after step 0 and
  resumed to the uninterrupted losses;
* ``cli.generate`` from those step files, sampled, greedy, ``--beam``
  (and ``--stochastic-beam``), ``--prime --include-prime``, ``--batch``
  and ``--dp 2``, written through the recorded scheme's codec;
  ``cli.serve`` in file, stdin and HTTP mode;
* a JAX ``cli.train`` run of 1 step on each scheme, its weights carried
  into a port step file through ``convert``: greedy ``cli.generate``
  from the same prime gives the JAX CLI's tokens and MIDI bytes.

Widths: hidden 16, 2 layers, init_dim 4. The codecs run their Python
paths (``MG_NATIVE=0``)."""

import json
import os
import socket
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli import generate as jgen
from musicgeneration_tpu.cli import train as jcli
from musicgeneration_tpu.utils import checkpoint as jck
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import serve as tserve
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.data.pipeline import TokenCorpus
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate)
from musicgeneration_tpu_torch.midi import MidiFile

from .fixtures import motif_piano_midi
from .test_torch_pedal import pedal_midi

SCHEMES = ("remi", "pedal")
EVENT_DIM = {"remi": 336, "pedal": 389}
FAMILIES = ("event_rnn", "performance_rnn")
GRU_KW = {"hidden_dim": 16, "num_layers": 2, "init_dim": 4}
GRU = [f"model.{k}={v}" for k, v in GRU_KW.items()]
TO_SD = {"event_rnn": convert.event_rnn_state_dict_from_jax,
         "performance_rnn": convert.performance_rnn_state_dict_from_jax}
WINDOW = ["train_mode=window", "window_size=24", "stride_size=12"]
RUNS = {  # run -> (scheme, cli.train overrides)
    **{f"{f}_crop_{s}": (s, [f"model={f}", "seq_len=32"])
       for f in FAMILIES for s in SCHEMES},
    "event_rnn_segment_remi": ("remi", ["model=event_rnn",
                                        "train_mode=segment", "seq_len=32"]),
    "performance_rnn_window_pedal": ("pedal", ["model=performance_rnn",
                                               *WINDOW,
                                               "teacher_forcing_ratio=0.5"]),
    "event_rnn_sequence_pedal": ("pedal", ["model=event_rnn",
                                           "train_mode=sequence"]),
}
PRIME_LEN, STEPS = 24, 20


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """Three pedalled pieces and three motif loops, tokenized by the
    port's cli.tokenize as ``remi`` and ``pedal``."""
    tmp = tmp_path_factory.mktemp("rnn_schemes")
    os.makedirs(tmp / "midis")
    for i in range(3):
        pedal_midi(str(tmp / "midis" / f"s{i}.mid"), seed=i,
                   n_notes=60 + 20 * i)
        motif_piano_midi(str(tmp / "midis" / f"m{i}.mid"), seed=i,
                         n_bars=8 + 2 * i)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MG_NATIVE", "0")
        for scheme in SCHEMES:
            assert ttok.main([str(tmp / "midis"), str(tmp / scheme),
                              "--scheme", scheme, "--workers", "1"]) == 0
    return tmp


def _train(base, scheme, run, steps, extra):
    return tcli.main([str(base / scheme), f"steps={steps}", "batch_size=2",
                      f"ckpt_dir={base / run}", "ckpt_every=1", "log_every=1",
                      f"metrics_path={base / (run + '.jsonl')}", *extra,
                      *GRU, "--device", "cpu"])


def _losses(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if r["kind"] == "train"}


@pytest.fixture(scope="module")
def runs(base):
    """Each run of RUNS for 3 steps, and the same run cut after step 0
    and resumed."""
    for name, (scheme, extra) in RUNS.items():
        assert _train(base, scheme, name, 3, extra) == 0
        assert _train(base, scheme, name + "_cut", 1, extra) == 0
        assert _train(base, scheme, name + "_cut", 3, extra) == 0
    return base


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_widths_equal_jax(base, family, scheme):
    """event_dim, the trainer's vocabulary and every parameter's shape of
    the model cli.train builds equal the JAX CLI's on the scheme."""
    kw = dict(model=family, seq_len=16, batch_size=2, seed=3)
    jcfg = jcli.TrainCLIConfig(**kw)
    jm, jtcfg, _, _, adapter = jcli.build_session(jcfg, scheme,
                                                  dict(GRU_KW))
    tcfg = tcli.TrainCLIConfig(**kw)
    tm, ttcfg, _ = tcli.build_model(tcfg, scheme, dict(GRU_KW), "cpu")
    assert tm.event_dim == jm.event_dim == EVENT_DIM[scheme]
    assert tm.primary_event == jm.primary_event == EVENT_DIM[scheme] - 1
    assert ttcfg.vocab_size == jtcfg.vocab_size == EVENT_DIM[scheme]
    assert tcli._default_vocab(scheme, family) == jcli._default_vocab(scheme)
    corpus = TokenCorpus(str(base / scheme), limlen=tcli._limlen(tcfg))
    batch = tcli._batch_fn(corpus, tcfg, scheme)(0)
    state = jcli._init_state(jm, jtcfg, jax.random.PRNGKey(0),
                             adapter(batch), jcfg)
    sd = TO_SD[family](jax.tree.map(np.asarray, state.params))
    tm.load_state_dict(sd, strict=True)
    model = convert.model_from_state_dict(sd, device="cpu")
    assert (model.family, model.event_dim) == (family, EVENT_DIM[scheme])


@pytest.mark.parametrize("model,scheme,extra,match", [
    ("performance_rnn", "remi", ["train_mode=sequence"], "model=event_rnn"),
    ("melody_rnn", "remi", [], "'melody' corpus"),
    ("melody_rnn", "pedal", [], "'melody' corpus"),
])
def test_refusals_kept(base, model, scheme, extra, match):
    with pytest.raises(SystemExit, match=match):
        tcli.main([str(base / scheme), f"model={model}", "steps=1",
                   *extra, "--device", "cpu"])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cli_train_resumes_to_equal_losses(runs, name):
    full = _losses(runs / f"{name}.jsonl")
    cut = _losses(runs / f"{name}_cut.jsonl")
    assert sorted(full) == sorted(cut) == [0, 1, 2]
    assert all(np.isfinite(list(full.values())))
    for step in full:
        np.testing.assert_allclose(cut[step], full[step], rtol=1e-3)
    scheme = RUNS[name][0]
    model, config = convert.load_checkpoint(str(runs / name), device="cpu",
                                            with_config=True)
    assert config["scheme"] == scheme
    assert model.family == name.split("_")[0] + "_rnn"
    assert (model.event_dim, model.hidden_dim) == (EVENT_DIM[scheme], 16)


def _greedy_ref(model, scheme, prime, n):
    toks = tgen.rnn_prime(model, prime, PRIME_LEN, scheme)
    kw = {}
    if model.family == "performance_rnn":
        kw["cache0"] = model.init_cache(1, init=torch.zeros(1,
                                                            model.init_dim))
    out = generate(model, torch.tensor([toks]), None, DecodeParams(
        max_len=len(toks) + n, steps=n,
        sampling=SamplingParams(greedy=True)), **kw)[0].numpy()
    return toks, out


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_cli_generate_every_mode(runs, tmp_path, capsys, family, scheme):
    """From the crop run's step file: greedy output (with the prime kept)
    is the engine's, written through the scheme's codec; a sampled batch
    of 2, --dp 2 (greedy: --dp 1's files), a beam and a stochastic beam
    each write MIDI that reads back."""
    run = str(runs / f"{family}_crop_{scheme}")
    prime = str(runs / "midis" / "s0.mid")
    zero = ["--init-zero"] if family == "performance_rnn" else []
    common = ["--prime", prime, "--prime-len", str(PRIME_LEN), "--steps",
              str(STEPS), "--device", "cpu", *zero]
    out = tmp_path / "greedy.mid"
    assert tgen.main([run, str(out), "--temperature", "0", "--include-prime",
                      *common]) == 0
    model = convert.load_checkpoint(run, device="cpu")
    toks, ref = _greedy_ref(model, scheme, prime, STEPS)
    assert len(toks) == PRIME_LEN + (family == "performance_rnn")
    want = tmp_path / "want.mid"
    tgen.write_midi(np.concatenate([toks, ref]), str(want), scheme)
    assert out.read_bytes() == want.read_bytes()
    for tag, extra in (("dp1", ["--batch", "2", "--temperature", "0"]),
                       ("dp2", ["--batch", "2", "--temperature", "0",
                                "--dp", "2"]),
                       ("sampled", ["--batch", "2", "--seed", "3"]),
                       ("beam", ["--beam", "3"]),
                       ("sbeam", ["--beam", "3", "--stochastic-beam"])):
        capsys.readouterr()
        assert tgen.main([run, str(tmp_path / f"{tag}.mid"), *extra,
                          *common]) == 0
        assert f"({STEPS} tokens)" in capsys.readouterr().out
    for i in range(2):
        a = (tmp_path / f"dp1-{i:03d}.mid").read_bytes()
        assert a == (tmp_path / f"dp2-{i:03d}.mid").read_bytes()
        MidiFile(str(tmp_path / f"sampled-{i:03d}.mid"))
    for tag in ("beam", "sbeam"):
        MidiFile(str(tmp_path / f"{tag}.mid"))


def _serve_reqs(prime):
    return [{"id": "a", "max_new": 12},
            {"id": "b", "prime": prime, "prime_len": PRIME_LEN,
             "max_new": 16}]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_cli_serve_file_and_stdin_mode(runs, tmp_path, capsys, monkeypatch,
                                       request, scheme):
    """cli.serve on the EventMelodyRNN crop run, greedy, from a request
    file and from stdin: each result is the engine's greedy continuation
    of the prime tokenized by the recorded scheme, written through it."""
    run = str(runs / f"event_rnn_crop_{scheme}")
    prime = str(runs / "midis" / "s1.mid")
    reqs = _serve_reqs(prime)
    path = tmp_path / "reqs.jsonl"
    text = "".join(json.dumps(r) + "\n" for r in reqs)
    path.write_text(text)
    model = convert.load_checkpoint(run, device="cpu")
    for mode in ("file", "stdin"):
        outdir = tmp_path / mode
        if mode == "stdin":   # a file with a descriptor, as a pipe has
            fh = open(path)
            request.addfinalizer(fh.close)
            monkeypatch.setattr("sys.stdin", fh)
        assert tserve.main([run, "-" if mode == "stdin" else str(path),
                            str(outdir), "--greedy", "--slots", "2",
                            "--seg-len", "8", "--device", "cpu"]) == 0
        assert f"scheme {scheme}" in capsys.readouterr().out
        for r in reqs:
            toks = tgen.prime_tokens(r.get("prime"), PRIME_LEN, scheme)
            ref = generate(model, torch.tensor([toks]), None, DecodeParams(
                max_len=len(toks) + r["max_new"], steps=r["max_new"],
                sampling=SamplingParams(greedy=True)))[0].numpy()
            want = tmp_path / f"{mode}-{r['id']}.mid"
            tgen.write_midi(ref, str(want), scheme)
            assert (outdir / f"{r['id']}.mid").read_bytes() == \
                want.read_bytes()


def test_cli_serve_http_pedal(runs, tmp_path):
    """--http on the PerformanceRNN pedal crop run: /generate with a
    prime returns the engine's greedy tokens after the primary event and
    the prime through the pedal codec (a zero latent)."""
    run = str(runs / "performance_rnn_crop_pedal")
    prime = str(runs / "midis" / "s2.mid")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    rc = {}
    th = threading.Thread(target=lambda: rc.update(code=tserve.main(
        [run, "-", str(tmp_path / "h"), "--slots", "2", "--seg-len", "8",
         "--greedy", "--http", str(port), "--device", "cpu"])), daemon=True)
    th.start()
    url = f"http://127.0.0.1:{port}"

    def req(path, data=None):
        body = None if data is None else json.dumps(data).encode()
        with urllib.request.urlopen(url + path, data=body, timeout=120) as r:
            return json.loads(r.read())

    deadline = time.time() + 120
    while True:
        try:
            if req("/healthz")["ready"]:
                break
        except OSError:
            assert time.time() < deadline, "server never became ready"
            time.sleep(0.2)
    got = req("/generate", {"id": "p", "prime": prime,
                            "prime_len": PRIME_LEN, "max_new": STEPS})
    assert req("/shutdown", {}) == {"ok": True}
    th.join(timeout=120)
    assert not th.is_alive() and rc["code"] == 0
    model = convert.load_checkpoint(run, device="cpu")
    _, ref = _greedy_ref(model, "pedal", prime, STEPS)
    np.testing.assert_array_equal(got["tokens"], ref)


@pytest.fixture(scope="module")
def jax_runs(base):
    """A JAX cli.train run of 1 step on each scheme (EventMelodyRNN on
    remi, PerformanceRNN on pedal), and the port's step file of its
    weights (``convert``), recording the same scheme."""
    out = {}
    for scheme, family in (("remi", "event_rnn"), ("pedal",
                                                   "performance_rnn")):
        jrun = base / f"jax_{scheme}"
        assert jcli.main([str(base / scheme), f"model={family}", "steps=1",
                          "batch_size=2", "seq_len=32", f"ckpt_dir={jrun}",
                          "ckpt_every=1", "log_every=1", *GRU]) == 0
        params = jck.restore_checkpoint(str(jrun))["state"]["params"]
        prun = base / f"port_{scheme}"
        os.makedirs(prun)
        cfg = tcli.TrainCLIConfig(model=family, seq_len=32)
        torch.save({"model": TO_SD[family](params), "step": 0,
                    "config": {"cli": cfg.to_dict(), "scheme": scheme,
                               "model_kwargs": dict(GRU_KW)}},
                   str(prun / "step-0.pt"))
        out[scheme] = (family, str(jrun), str(prun))
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_transplanted_jax_run_generates_jax_tokens(jax_runs, base, tmp_path,
                                                   monkeypatch, scheme):
    """Greedy cli.generate, the same prime, on the JAX run and on the
    port's step file of its weights: the tokens handed to the writer
    (prime kept) and the MIDI bytes are equal."""
    family, jrun, prun = jax_runs[scheme]
    prime = str(base / "midis" / "m1.mid")
    args = ["--prime", prime, "--prime-len", str(PRIME_LEN), "--steps",
            str(STEPS), "--temperature", "0", "--include-prime",
            *(["--init-zero"] if family == "performance_rnn" else [])]
    seen = {}
    j_write, t_write = jgen._write_midi, tgen.write_midi
    monkeypatch.setattr(jgen, "_write_midi", lambda s, t, p: (
        seen.__setitem__("jax", (s, np.asarray(t))), j_write(s, t, p)))
    monkeypatch.setattr(tgen, "write_midi", lambda t, p, s: (
        seen.__setitem__("port", (s, np.asarray(t))), t_write(t, p, s)))
    assert jgen.main([jrun, str(tmp_path / "j.mid"), *args]) == 0
    assert tgen.main([prun, str(tmp_path / "t.mid"), *args,
                      "--device", "cpu"]) == 0
    assert seen["jax"][0] == seen["port"][0] == scheme
    assert len(seen["port"][1]) == (PRIME_LEN + STEPS
                                    + (family == "performance_rnn"))
    np.testing.assert_array_equal(seen["port"][1], seen["jax"][1])
    assert (tmp_path / "t.mid").read_bytes() == \
        (tmp_path / "j.mid").read_bytes()
