"""The port's CLIs on the Compound Word transformer, on ``--device cpu``:
``cli.tokenize --scheme cp`` (shards equal to the JAX package's),
``cli.train model=cp_transformer`` (its crop stream equal to the JAX
CLI's), ``cli.generate`` (greedy output equal to ``generate_cp`` written
through the CP codec; ``--quant int8``, ``--batch``, ``--include-prime``)
and ``cli.serve`` in file and HTTP modes (greedy results equal to
``cli.generate``'s), with the refusals of what does not apply to
compound rows and the CUDA default."""

import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli import train as jcli
from musicgeneration_tpu.data.pipeline import TokenCorpus as JTokenCorpus
from musicgeneration_tpu.data.pipeline import tokenize_corpus as jtokenize
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import serve as tserve
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.data.pipeline import TokenCorpus
from musicgeneration_tpu_torch.decode.cp_generate import generate_cp
from musicgeneration_tpu_torch.models import CPTransformer
from musicgeneration_tpu_torch.tokenizers import cp
from musicgeneration_tpu_torch.utils.checkpoint import restore_checkpoint

from .fixtures import motif_piano_midi

SEQ = 32


def _train_args(tmp, run, steps=3, *extra):
    return [str(tmp / "tok"), "model=cp_transformer", f"steps={steps}",
            "batch_size=2", f"seq_len={SEQ}", "model.num_layers=2",
            "model.d_model=64", f"ckpt_dir={tmp / run}", "ckpt_every=1",
            "log_every=1", f"metrics_path={tmp / (run + '.jsonl')}",
            "warmup_steps=10", "cp_head_weights=(2,1,1,1,1,1,1,1)", *extra,
            "--device", "cpu"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """Tokenized cp corpus and a 3-step cli.train run."""
    tmp = tmp_path_factory.mktemp("cpcli")
    os.makedirs(tmp / "midis")
    for i in range(3):
        motif_piano_midi(str(tmp / "midis" / f"m{i}.mid"), seed=i, n_bars=12)
    assert ttok.main([str(tmp / "midis"), str(tmp / "tok"), "--scheme", "cp",
                      "--workers", "1"]) == 0
    assert tcli.main(_train_args(tmp, "run")) == 0
    return tmp


def test_tokenize_cp_shards_equal_jax(run_dir, tmp_path):
    jtokenize(str(run_dir / "midis"), str(tmp_path / "jtok"), scheme="cp",
              num_workers=1)
    with open(run_dir / "tok" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["scheme"] == "cp" and manifest["n_ok"] == 3
    ours, theirs = TokenCorpus(str(run_dir / "tok")), \
        JTokenCorpus(str(tmp_path / "jtok"))
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        np.testing.assert_array_equal(ours[i], theirs[i])
        assert ours[i].size % 8 == 0 and ours[i].size > 8 * (SEQ + 1)


def test_cp_batch_stream_equals_jax(run_dir):
    kw = dict(model="cp_transformer", batch_size=2, seq_len=SEQ, seed=3)
    corpus = TokenCorpus(str(run_dir / "tok"), limlen=(SEQ + 1) * 8)
    ours = tcli._cp_batch_fn(corpus, tcli.TrainCLIConfig(**kw))
    theirs = jcli._cp_batch_fn(corpus, jcli.TrainCLIConfig(**kw))
    for idx in (0, 1, 7):
        for a, b in zip(ours(idx), theirs(idx)):
            assert a.shape == (2, SEQ, 8)
            np.testing.assert_array_equal(a, b)


def test_cli_train_cp_records_and_resumes(run_dir):
    with open(run_dir / "run.jsonl") as f:
        losses = [r["loss"] for r in map(json.loads, f)
                  if r["kind"] == "train"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    ck = restore_checkpoint(str(run_dir / "run"))
    assert ck["step"] == 2
    assert ck["config"]["cli"]["model"] == "cp_transformer"
    assert ck["config"]["scheme"] == "cp"
    model = convert.load_checkpoint(str(run_dir / "run"), device="cpu")
    assert isinstance(model, CPTransformer)
    assert (model.num_layers, model.d_model, model.max_seq) == (2, 64, SEQ)
    # a second call resumes at the checkpoint and runs to steps=4
    assert tcli.main(_train_args(run_dir, "run", 4)) == 0
    assert restore_checkpoint(str(run_dir / "run"))["step"] == 3


def test_cli_train_refusals(run_dir, tmp_path):
    with pytest.raises(SystemExit, match="unknown model overrides"):
        tcli.main(_train_args(run_dir, "x", 1, "model.vocab_size=9"))
    with pytest.raises(SystemExit, match="unknown model 'popmag'"):
        tcli.main([str(run_dir / "tok"), "model=popmag", "--device", "cpu"])
    with pytest.raises(SystemExit, match="'midilike' corpus"):
        tcli.main([str(run_dir / "tok"), "steps=1", "batch_size=2",
                   f"seq_len={SEQ}", "--device", "cpu"])


def _prime_rows(path, n):
    return np.asarray(cp.extract_events(path)[:n], np.int64)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cli_generate_greedy_equals_generate_cp(run_dir, tmp_path, quant):
    run, prime = str(run_dir / "run"), str(run_dir / "midis" / "m0.mid")
    out = tmp_path / "g.mid"
    argv = [run, str(out), "--prime", prime, "--prime-len", "5", "--steps",
            "8", "--temperature", "0", "--device", "cpu"]
    if quant == "int8":
        argv += ["--quant", "int8"]
    assert tgen.main(argv) == 0
    model = convert.load_checkpoint(run, device="cpu", decode_quant=quant)
    rows = _prime_rows(prime, 5)
    # the prime is cut to max_seq - steps rows
    rows = rows[:SEQ - 8]
    want = generate_cp(model, rows[None], 8, greedy=True)[0].numpy()
    cp.write_midi(want, str(tmp_path / "want.mid"))
    assert out.read_bytes() == (tmp_path / "want.mid").read_bytes()
    assert cp.extract_events(str(out)).shape[1] == 8


def test_cli_generate_batch_include_prime_sampled(run_dir, tmp_path):
    run = str(run_dir / "run")
    out = tmp_path / "b.mid"
    assert tgen.main([run, str(out), "--steps", "10", "--batch", "2",
                      "--include-prime", "--seed", "3", "--device",
                      "cpu"]) == 0
    model = convert.load_checkpoint(run, device="cpu")
    bar = np.asarray([cp._row(cp.FAMILY_METRIC, position=0)], np.int64)
    want = generate_cp(model, np.tile(bar[None], (2, 1, 1)), 10,
                       generator=torch.Generator().manual_seed(3)).numpy()
    for i in range(2):
        path = tmp_path / f"b-{i:03d}.mid"
        cp.write_midi(np.concatenate([bar, want[i]]),
                      str(tmp_path / "w.mid"))
        assert path.read_bytes() == (tmp_path / "w.mid").read_bytes()


def test_cli_generate_cp_refusals(run_dir, tmp_path, monkeypatch):
    run, out = str(run_dir / "run"), str(tmp_path / "r.mid")
    for extra in (["--topk", "5"], ["--topp", "0.9"], ["--spec", "lookup"],
                  ["--beam", "3"]):
        with pytest.raises(SystemExit, match="compound-word rows"):
            tgen.main([run, out, "--steps", "4", "--device", "cpu", *extra])
    with pytest.raises(SystemExit, match="max_seq"):
        tgen.main([run, out, "--steps", str(SEQ), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.main([run, out, "--steps", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CPTransformer(num_layers=1, d_model=64, max_seq=SEQ)


def _greedy_ref(run_dir, tmp_path, steps, prime=None, prime_len=None):
    ref = tmp_path / f"ref{steps}.mid"
    argv = [str(run_dir / "run"), str(ref), "--steps", str(steps),
            "--temperature", "0", "--device", "cpu"]
    if prime is not None:
        argv += ["--prime", prime, "--prime-len", str(prime_len)]
    assert tgen.main(argv) == 0
    return ref.read_bytes()


def test_cli_serve_file_mode(run_dir, tmp_path, capsys):
    """Three requests (a bare bar-marker row, a MIDI prime, raw rows with
    an eos family): greedy results equal cli.generate's; every MIDI
    re-reads as CP rows."""
    prime = str(run_dir / "midis" / "m1.mid")
    rows = _prime_rows(prime, 4)
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps(r) for r in (
        {"id": "a", "max_new": 8},
        {"id": "b", "prime": prime, "prime_len": 6, "max_new": 10},
        {"id": "c", "tokens": rows.tolist(), "max_new": 9,
         "eos": cp.FAMILY_EOS})) + "\n")
    outdir = tmp_path / "served"
    capsys.readouterr()
    assert tserve.main([str(run_dir / "run"), str(reqs), str(outdir),
                        "--slots", "2", "--seg-len", "4", "--greedy",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "loaded CPTransformer (2 layers" in out
    assert "generated" in out
    assert (outdir / "a.mid").read_bytes() == _greedy_ref(run_dir, tmp_path,
                                                          8)
    assert (outdir / "b.mid").read_bytes() == _greedy_ref(
        run_dir, tmp_path, 10, prime, 6)
    for name in "abc":
        assert cp.extract_events(str(outdir / f"{name}.mid")).shape[1] == 8


def test_cli_serve_cp_refusals(run_dir, tmp_path):
    reqs = tmp_path / "r.jsonl"
    reqs.write_text('{"max_new": 4}\n')
    with pytest.raises(SystemExit, match="compound-word rows"):
        tserve.main([str(run_dir / "run"), str(reqs), str(tmp_path / "o"),
                     "--topk", "5", "--device", "cpu"])
    for bad in ('{"max_new": 4, "temperature": 0.5}',
                '{"max_new": 4, "window": 8}'):
        reqs.write_text(bad + "\n")
        with pytest.raises(SystemExit, match="request line 0"):
            tserve.main([str(run_dir / "run"), str(reqs),
                         str(tmp_path / "o"), "--device", "cpu"])


def test_cli_serve_cp_http(run_dir, tmp_path):
    """--http: /generate returns [n, 8] rows equal to the file mode's
    greedy continuation of a bare bar-marker row."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    rc = {}
    th = threading.Thread(target=lambda: rc.update(code=tserve.main(
        [str(run_dir / "run"), "-", str(tmp_path / "h"), "--slots", "2",
         "--seg-len", "4", "--greedy", "--http", str(port), "--device",
         "cpu"])), daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"

    def req(path, data=None):
        body = None if data is None else json.dumps(data).encode()
        with urllib.request.urlopen(base + path, data=body, timeout=120) as r:
            return json.loads(r.read())

    deadline = time.time() + 120
    while True:
        try:
            if req("/healthz")["ready"]:
                break
        except OSError:
            assert time.time() < deadline, "server never became ready"
            time.sleep(0.2)
    a = req("/generate", {"id": "a", "max_new": 8})
    assert a["n_tokens"] == 8 and np.asarray(a["tokens"]).shape == (8, 8)
    assert req("/shutdown", {}) == {"ok": True}
    th.join(timeout=120)
    assert not th.is_alive() and rc["code"] == 0
    model = convert.load_checkpoint(str(run_dir / "run"), device="cpu")
    bar = np.asarray([[cp._row(cp.FAMILY_METRIC, position=0)]], np.int64)
    np.testing.assert_array_equal(
        a["tokens"], generate_cp(model, bar, 8, greedy=True)[0].numpy())
