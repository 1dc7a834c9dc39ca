"""The port's ``cli.generate`` and ``cli.serve`` (file, follow and HTTP
modes) on an exported ``.pth``, and the port's isolation: it imports
nothing of JAX or of the JAX package, and a CUDA request without a GPU
raises instead of running on the CPU."""

import ast
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli.export_checkpoint import export_music_transformer
from musicgeneration_tpu.cli.generate import _prime_tokens, _write_midi
from musicgeneration_tpu.decode import DecodeParams as JDecodeParams
from musicgeneration_tpu.decode import generate as jgenerate
from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
import musicgeneration_tpu_torch
from musicgeneration_tpu_torch.cli import generate as tcli
from musicgeneration_tpu_torch.cli import serve as tserve
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.tokenizers import midilike
from tests.fixtures import simple_piano_midi

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "musicgeneration_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "musicgeneration_tpu")
NO_GPU = dict(os.environ, CUDA_VISIBLE_DEVICES="")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    jm = JMusicTransformer(vocab_size=309, num_layers=2, d_model=128,
                           max_seq=256, decode_impl="fused",
                           attention_impl="pallas", dropout_rate=0.0)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)
    pth = tmp / "mt.pth"
    torch.save(export_music_transformer(params, {}, 1), pth)
    prime = tmp / "prime.mid"
    simple_piano_midi(str(prime))
    return jm, params, str(pth), str(prime), tmp


def test_cli_greedy_writes_jax_identical_midi(exported):
    """Greedy output of the port's CLI is byte-identical to the JAX
    package's generate + MIDI writer on the same bucketed prime."""
    jm, params, pth, prime, tmp = exported
    out = tmp / "port.mid"
    assert tcli.main([pth, str(out), "--prime", prime, "--prime-len", "40",
                      "--steps", "16", "--temperature", "0",
                      "--device", "cpu"]) == 0
    toks = _prime_tokens("midilike", prime, 40)
    assert len(toks) == 40
    padded = np.pad(np.asarray([toks], np.int32), ((0, 0), (0, 24)),
                    constant_values=jm.pad_id)  # bucket 64
    ref = jgenerate(jm, params, jnp.asarray(padded), jax.random.PRNGKey(0),
                    JDecodeParams(max_len=80, steps=16,
                                  sampling=JSampling(greedy=True)),
                    None, None, jnp.int32(40))
    ref_path = tmp / "jax.mid"
    _write_midi("midilike", np.asarray(ref[0]), str(ref_path))
    assert out.read_bytes() == ref_path.read_bytes()


def test_cli_batch_bf16_include_prime(exported):
    _, _, pth, prime, tmp = exported
    out = tmp / "batch.mid"
    assert tcli.main([pth, str(out), "--prime", prime, "--prime-len", "20",
                      "--steps", "8", "--batch", "2", "--topk", "5",
                      "--seed", "3", "--include-prime", "--dtype",
                      "bfloat16", "--device", "cpu"]) == 0
    for i in range(2):
        assert (tmp / f"batch-{i:03d}.mid").stat().st_size > 22


def test_cli_refuses_past_max_seq(exported):
    """Past max_seq (256) only batch 1 without --spec continues (by the
    sliding window), as in the JAX CLI."""
    _, _, pth, _, tmp = exported
    for extra in (["--batch", "2"], ["--spec", "lookup"]):
        with pytest.raises(SystemExit, match="sliding window"):
            tcli.main([pth, str(tmp / "x.mid"), "--steps", "300",
                       "--device", "cpu"] + extra)


def test_cli_sliding_past_max_seq_matches_jax(exported):
    """A continuation past max_seq re-primes a window of max_seq // 2
    (128): the greedy tokens of the JAX CLI's path (its engine's
    generate_sliding, XLA decode) written as the same MIDI."""
    from musicgeneration_tpu.decode.engine import (
        generate_sliding as jgenerate_sliding)
    _, params, pth, _, tmp = exported
    out = tmp / "sliding.mid"
    assert tcli.main([pth, str(out), "--steps", "300", "--temperature", "0",
                      "--device", "cpu"]) == 0
    jm = JMusicTransformer(vocab_size=309, num_layers=2, d_model=128,
                           max_seq=256, dropout_rate=0.0)
    ref = jgenerate_sliding(jm, params, jnp.asarray([[24, 28, 31]]),
                            jax.random.PRNGKey(0), 300, window=128,
                            sampling=JSampling(greedy=True))
    assert ref.shape == (1, 300)
    ref_path = tmp / "sliding_jax.mid"
    _write_midi("midilike", np.asarray(ref[0]), str(ref_path))
    assert out.read_bytes() == ref_path.read_bytes()


def _save_mt(path, **kw):
    """A seeded random port MusicTransformer saved as an exported .pth."""
    m = MusicTransformer(device="cpu",
                         generator=torch.Generator().manual_seed(5), **kw)
    torch.save({"net": m.state_dict(), "optimizer": {}, "epoch": 0}, path)
    return str(path)


def test_cli_spec_lookup_and_draft(exported, capsys):
    """--spec lookup and --spec <draft.pth> (a 1-layer d_model 64 draft)
    write the greedy MIDI of plain decoding and print the acceptance
    line; sampled --batch 2 writes both files."""
    from musicgeneration_tpu_torch.convert import load_checkpoint
    from musicgeneration_tpu_torch.decode import (DecodeParams,
                                                  SamplingParams, generate)
    _, _, pth, prime, tmp = exported
    draft = _save_mt(tmp / "draft.pth", vocab_size=309, num_layers=1,
                     d_model=64, max_seq=256)
    base = [pth, "--prime", prime, "--prime-len", "40", "--steps", "24",
            "--temperature", "0", "--spec-chunk", "5", "--device", "cpu"]
    model = load_checkpoint(pth, device="cpu")
    toks = tcli.prime_tokens(prime, 40)
    want = generate(model, torch.tensor([toks]), None,
                    DecodeParams(max_len=64, steps=24,
                                 sampling=SamplingParams(greedy=True)))
    ref = tmp / "spec_ref.mid"
    tcli.write_midi(want[0].numpy(), str(ref))
    for spec in ("lookup", draft):
        out = tmp / f"spec_{len(spec)}.mid"
        assert tcli.main([base[0], str(out), "--spec", spec] + base[1:]) == 0
        assert out.read_bytes() == ref.read_bytes()
        line = [x for x in capsys.readouterr().out.splitlines()
                if x.startswith("speculative:")]
        assert len(line) == 1 and "for 24 tokens (mean accepted" in line[0]
        assert line[0].endswith("/4)")
    out = tmp / "spec_batch.mid"
    assert tcli.main([pth, str(out), "--spec", "lookup", "--batch", "2",
                      "--steps", "16", "--topk", "8", "--seed", "1",
                      "--dtype", "bfloat16", "--device", "cpu"]) == 0
    for i in range(2):
        assert (tmp / f"spec_batch-{i:03d}.mid").stat().st_size > 22


def test_cli_spec_refusals(exported, rnn_exported):
    """--spec with --beam, on a GRU target, and with a draft of another
    family or vocabulary exits."""
    _, _, pth, _, tmp = exported
    _, _, ev, _, _, _ = rnn_exported
    small_vocab = _save_mt(tmp / "draft48.pth", vocab_size=48, num_layers=1,
                           d_model=64, max_seq=256)
    for ckpt, extra, match in (
            (pth, ["--spec", "lookup", "--beam", "2"], "mutually exclusive"),
            (ev, ["--spec", "lookup"], "music_transformer target"),
            (pth, ["--spec", ev], "must be a music_transformer"),
            (pth, ["--spec", small_vocab], "vocab")):
        with pytest.raises(SystemExit, match=match):
            tcli.main([ckpt, str(tmp / "r.mid"), "--steps", "4",
                       "--device", "cpu"] + extra)


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_jax(path):
    bad = {n for n in _imports(path)
           if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_isolation_covers_the_copied_codecs_and_clis():
    """The port's own copies of pure-Python modules of the JAX package
    (the pedal codec, track extraction) and the CLIs beside them are
    among the sources checked above, and import nothing of JAX or of the
    JAX package."""
    copies = {"tokenizers/pedal_midilike.py", "data/track_extraction.py",
              "cli/eval.py", "cli/extract_tracks.py",
              "cli/export_checkpoint.py", "cli/import_checkpoint.py",
              "cli/check_install.py", "cli/split.py", "cli/corpus_stats.py",
              "data/pipeline.py"}
    assert copies <= {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for rel in sorted(copies):
        assert not {n for n in _imports(PORT / rel)
                    if n.split(".")[0] in FORBIDDEN}, rel


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import musicgeneration_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(sorted(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=NO_GPU,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_cuda_request_without_gpu_raises(monkeypatch, exported):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        musicgeneration_tpu_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        MusicTransformer(vocab_size=16, num_layers=1, d_model=64,
                         max_seq=32)
    _, _, pth, _, tmp = exported
    with pytest.raises(RuntimeError):
        tcli.main([pth, str(tmp / "y.mid"), "--steps", "4"])
    assert musicgeneration_tpu_torch.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(alone, tmp_path):
    """No CUDA device, or a directory with chip_smoke.py and nothing
    else of the repo: a non-zero exit and no result line."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(NO_GPU, PYTHONPATH="")
    res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_serve_file_mode_matches_cli_generate(exported):
    """cli.serve drains a mixed JSONL queue (greedy, per-row sampled, a
    sliding window request past the serve window, a prime MIDI); the
    greedy request's MIDI is byte-identical to cli.generate's on the
    same default prime, and every file reads back as MIDI."""
    _, _, pth, prime, tmp = exported
    reqs = tmp / "reqs.jsonl"
    lines = [{"id": "a", "tokens": [24, 28, 31], "max_new": 24},
             {"id": "b", "tokens": [10, 20, 30, 40, 50], "max_new": 40},
             {"id": "c", "tokens": [5, 15, 25], "max_new": 16,
              "temperature": 0.9, "top_k": 12, "greedy": False},
             {"id": "d", "tokens": [7, 9, 11], "max_new": 300,
              "window": 16},
             {"id": "e", "prime": prime, "prime_len": 20, "max_new": 16}]
    reqs.write_text("".join(json.dumps(r) + "\n" for r in lines))
    outdir = tmp / "served"
    assert tserve.main([pth, str(reqs), str(outdir), "--slots", "2",
                        "--seg-len", "8", "--greedy", "--device",
                        "cpu"]) == 0
    ref = tmp / "ref_a.mid"
    assert tcli.main([pth, str(ref), "--steps", "24", "--temperature", "0",
                      "--device", "cpu"]) == 0
    assert (outdir / "a.mid").read_bytes() == ref.read_bytes()
    for name in "bcde":
        midilike.extract_events(str(outdir / f"{name}.mid"))


def test_serve_follow_mode_streams_results(exported):
    """`-` reads JSONL from stdin; a ready line, then one JSON line per
    completion (a malformed line errors alone)."""
    _, _, pth, _, tmp = exported
    lines = (json.dumps({"id": "x", "tokens": [24, 28, 31], "max_new": 12})
             + "\nnot json\n"
             + json.dumps({"id": "y", "tokens": [3, 4], "max_new": 9,
                           "temperature": 0.7}) + "\n")
    res = subprocess.run(
        [sys.executable, "-m", "musicgeneration_tpu_torch.cli.serve", pth,
         "-", str(tmp / "follow"), "--slots", "2", "--seg-len", "8",
         "--device", "cpu"], input=lines, cwd=REPO, env=NO_GPU,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = [json.loads(x) for x in res.stdout.splitlines()
           if x.startswith("{")]
    assert out[0] == {"ready": True, "slots": 2}
    done = {r["id"]: r for r in out[1:] if "file" in r}
    assert done["x"]["tokens"] == 12 and done["y"]["tokens"] == 9
    assert any("error" in r for r in out[1:])
    for r in done.values():
        assert os.path.exists(r["file"])


def test_serve_http(exported):
    """--http: /generate, /stream (the chunks concatenate to /generate's
    tokens), /submit + /result (consumed on read), /cancel, /healthz,
    /stats and /shutdown; the greedy response is the cli.generate
    continuation."""
    _, _, pth, _, tmp = exported
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    outdir = tmp / "served_http"
    rc = {}
    th = threading.Thread(target=lambda: rc.update(code=tserve.main(
        [pth, "-", str(outdir), "--slots", "2", "--seg-len", "8",
         "--greedy", "--http", str(port), "--device", "cpu"])), daemon=True)
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

    a = req("/generate", {"id": "a", "tokens": [24, 28, 31], "max_new": 24})
    assert a["n_tokens"] == 24 and os.path.exists(a["file"])

    sse = urllib.request.urlopen(base + "/stream", data=json.dumps(
        {"id": "st", "tokens": [24, 28, 31], "max_new": 24}).encode(),
        timeout=120)
    assert sse.headers["Content-Type"] == "text/event-stream"
    streamed, chunks, event, done = [], 0, None, None
    for raw in sse:
        line = raw.decode().rstrip("\n")
        if line.startswith("event: "):
            event = line[7:]
        elif line.startswith("data: "):
            payload = json.loads(line[6:])
            if event == "done":
                done = payload
                break
            streamed.extend(payload["tokens"])
            chunks += 1
            event = None
    assert chunks >= 2 and done["n_tokens"] == 24
    assert streamed == a["tokens"]

    assert req("/submit", {"id": "as", "tokens": [24, 28, 31],
                           "max_new": 24}) == {"id": "as",
                                               "status": "queued"}
    assert req("/submit", {"id": "cx", "tokens": [24, 28, 31],
                           "max_new": 200})["status"] == "queued"
    assert req("/cancel", {"id": "cx"})["status"] == "cancel_requested"

    def poll(name):
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                res = req(f"/result/{name}")
            except urllib.error.HTTPError as e:
                assert e.code == 404     # not drained by the engine yet
                time.sleep(0.05)
                continue
            if res.get("status") != "pending":
                return res
            time.sleep(0.05)
        raise AssertionError(f"result {name} never finalized")

    assert poll("as")["tokens"] == a["tokens"]
    with pytest.raises(urllib.error.HTTPError):
        req("/result/as")                # consumed on the first read
    cx = poll("cx")
    assert cx["status"] == "cancelled" and cx["n_tokens"] < 200
    st = req("/stats")
    assert st["stats"]["committed_tokens"] >= 72
    assert st["latency"]["n"] >= 3
    assert req("/shutdown", {}) == {"ok": True}
    th.join(timeout=120)
    assert not th.is_alive() and rc["code"] == 0

    ref = tmp / "ref_http.mid"
    assert tcli.main([pth, str(ref), "--steps", "24", "--temperature", "0",
                      "--device", "cpu"]) == 0
    assert (outdir / "a.mid").read_bytes() == ref.read_bytes()


def test_serve_refuses_another_family(tmp_path):
    """A state dict of no family the port runs exits and says so; it does
    not fall back."""
    pth = tmp_path / "rnn.pth"
    torch.save({"net": {"gru.weight_ih_l0": torch.zeros(3, 2)},
                "optimizer": {}, "epoch": 0}, pth)
    reqs = tmp_path / "r.jsonl"
    reqs.write_text('{"tokens": [1], "max_new": 4}\n')
    with pytest.raises(SystemExit, match="not a checkpoint of a family"):
        tserve.main([str(pth), str(reqs), str(tmp_path / "o"), "--device",
                     "cpu"])


def test_serve_cuda_request_without_gpu_raises(monkeypatch, exported):
    """cli.serve defaults to the GPU; without one it raises rather than
    serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, pth, _, tmp = exported
    reqs = tmp / "one.jsonl"
    reqs.write_text('{"tokens": [1, 2], "max_new": 4}\n')
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main([pth, str(reqs), str(tmp / "nogpu")])


@pytest.fixture(scope="module")
def bf16_run(exported):
    """A cli.train checkpoint directory (written by the trainer's own
    ``save_checkpoint``) that records ``model.dtype=bfloat16``."""
    from types import SimpleNamespace

    from musicgeneration_tpu_torch import convert
    from musicgeneration_tpu_torch.utils.checkpoint import save_checkpoint
    _, _, pth, _, tmp = exported
    model = convert.load_checkpoint(pth, device="cpu")
    zeros = [torch.zeros_like(p) for p in model.parameters()]
    state = SimpleNamespace(model=model, dropout_seed=0, opt_state=(
        SimpleNamespace(count=1, mu=zeros, nu=zeros)))
    run = tmp / "bf16_run"
    save_checkpoint(str(run), 1, state, config={
        "cli": {}, "scheme": "midilike",
        "model_kwargs": {"dtype": "bfloat16", "num_layers": 2}})
    return str(run)


@pytest.mark.parametrize("cli,source,flag,want", [
    ("generate", "run", None, torch.bfloat16),
    ("generate", "run", "float32", torch.float32),
    ("generate", "pth", None, torch.float32),
    ("generate", "pth", "bfloat16", torch.bfloat16),
    ("serve", "run", None, torch.bfloat16),
    ("serve", "run", "float32", torch.float32),
    ("serve", "pth", None, torch.float32)])
def test_cli_dtype_defaults_to_the_recorded_one(monkeypatch, exported,
                                                bf16_run, cli, source, flag,
                                                want):
    """cli.generate and cli.serve load a cli.train run in the dtype it
    recorded (as the JAX CLI rebuilds the model from model_kwargs); an
    exported .pth records none and loads in float32; --dtype wins."""
    from musicgeneration_tpu_torch import convert
    _, _, pth, _, tmp = exported
    seen = []
    real = convert.load_checkpoint

    def spy(*args, **kw):
        out = real(*args, **kw)
        model = out[0] if kw.get("with_config") else out
        seen.append(model.dtype)
        return out

    monkeypatch.setattr(convert, "load_checkpoint", spy)
    ckpt = bf16_run if source == "run" else pth
    extra = [] if flag is None else ["--dtype", flag]
    name = f"dtype_{cli}_{source}_{flag}"
    if cli == "generate":
        assert tcli.main([ckpt, str(tmp / f"{name}.mid"), "--steps", "4",
                          "--temperature", "0", "--device", "cpu",
                          *extra]) == 0
    else:
        reqs = tmp / f"{name}.jsonl"
        reqs.write_text('{"id": "a", "tokens": [24, 28], "max_new": 4}\n')
        assert tserve.main([ckpt, str(reqs), str(tmp / name), "--slots", "1",
                            "--seg-len", "4", "--device", "cpu",
                            *extra]) == 0
    assert seen == [want]


def test_recorded_dtype_reads_model_kwargs(exported, bf16_run):
    """load_checkpoint exposes a step file's config (an exported .pth has
    none) and, with dtype=None, builds the model in the recorded dtype."""
    from musicgeneration_tpu_torch import convert
    model, config = convert.load_checkpoint(bf16_run, device="cpu",
                                            dtype=None, with_config=True)
    assert config["model_kwargs"]["dtype"] == "bfloat16"
    assert model.dtype == torch.bfloat16
    model, config = convert.load_checkpoint(exported[2], device="cpu",
                                            dtype=None, with_config=True)
    assert config == {} and model.dtype == torch.float32
    assert convert.recorded_dtype({}) == torch.float32
    assert convert.recorded_dtype(
        {"model_kwargs": {"dtype": "bfloat16"}}) == torch.bfloat16
    with pytest.raises(ValueError):
        convert.recorded_dtype({"model_kwargs": {"dtype": "float16"}})


# ---------------------------------------------------------------- GRU families

@pytest.fixture(scope="module")
def rnn_exported(tmp_path_factory):
    """A JAX EventMelodyRNN exported as a bare state dict and a JAX
    PerformanceRNN exported as a session dict, both at event_dim 308 (the
    MIDI-like codec), hidden 32, 2 layers."""
    from musicgeneration_tpu.cli.export_checkpoint import (
        export_event_rnn, export_performance_rnn)
    from musicgeneration_tpu.models import EventMelodyRNN as JE
    from musicgeneration_tpu.models import PerformanceRNN as JP
    tmp = tmp_path_factory.mktemp("rnn_cli")
    je = JE(event_dim=308, init_dim=8, hidden_dim=32, num_layers=2)
    ep = jax.tree.map(np.asarray, je.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8)),
        jnp.zeros((4, 1), jnp.int32))["params"])
    jp = JP(event_dim=308, control_dim=24, init_dim=8, hidden_dim=32,
            num_layers=2)
    pp = jax.tree.map(np.asarray, jp.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8)),
        jnp.zeros((4, 1), jnp.int32))["params"])
    ev, pf = tmp / "event.pth", tmp / "perf.pth"
    torch.save(export_event_rnn(ep, {}, 1), ev)
    torch.save(export_performance_rnn(pp, {}, 1), pf)
    prime = tmp / "prime.mid"
    simple_piano_midi(str(prime))
    return je, ep, str(ev), str(pf), str(prime), tmp


def _events(path):
    """The MIDI file reads back (an untrained model's short continuation
    may hold no note, so the event count may be 0)."""
    assert os.path.getsize(path) > 22, path     # more than the headers
    return len(midilike.extract_events(str(path)).events)


def test_cli_event_rnn_greedy_matches_jax(rnn_exported):
    """Greedy EventMelodyRNN generation from a prime MIDI writes the MIDI
    the JAX engine's tokens give (its CLI pads the prime to a bucket of
    64 with id 0 and masks the padded steps)."""
    je, ep, ev, _, prime, tmp = rnn_exported
    out = tmp / "ev_greedy.mid"
    assert tcli.main([ev, str(out), "--prime", prime, "--prime-len", "40",
                      "--steps", "24", "--temperature", "0",
                      "--device", "cpu"]) == 0
    toks = _prime_tokens("midilike", prime, 40)
    padded = np.pad(np.asarray([toks], np.int32), ((0, 0), (0, 24)))
    ref = jgenerate(je, ep, jnp.asarray(padded), jax.random.PRNGKey(0),
                    JDecodeParams(max_len=64 + 24, steps=24,
                                  sampling=JSampling(greedy=True)),
                    None, None, jnp.int32(40))
    ref_path = tmp / "ev_jax.mid"
    _write_midi("midilike", np.asarray(ref[0]), str(ref_path))
    assert out.read_bytes() == ref_path.read_bytes()


@pytest.mark.parametrize("extra", [["--beam", "3"],
                                   ["--beam", "3", "--stochastic-beam"],
                                   ["--batch", "2", "--topk", "8",
                                    "--dtype", "bfloat16"]])
def test_cli_event_rnn_beam_and_batch(rnn_exported, extra):
    _, _, ev, _, prime, tmp = rnn_exported
    out = tmp / f"ev_{len(extra)}_{extra[-1].strip('-')}.mid"
    assert tcli.main([ev, str(out), "--prime", prime, "--prime-len", "16",
                      "--steps", "20", "--seed", "2", "--device", "cpu"]
                     + extra) == 0
    if "--batch" in extra:
        for i in range(2):
            _events(out.with_name(f"{out.stem}-{i:03d}.mid"))
    else:
        _events(out)


def _control_shard(path):
    """A midilike_control shard as data/pipeline.py::_write_shard writes
    it: two sequences of compressed [S, 13] controls, flat."""
    from musicgeneration_tpu.tokenizers.midilike import ControlSeq
    rng = np.random.RandomState(0)
    seqs = [ControlSeq.compressed_from_ids(rng.randint(0, 308, n))
            for n in (40, 30)]
    offs = np.zeros(3, np.int64)
    np.cumsum([s.size for s in seqs], out=offs[1:])
    np.savez(path, controls_data=np.concatenate([s.reshape(-1)
                                                 for s in seqs]),
             controls_offsets=offs)
    return seqs


def test_cli_performance_rnn_controls(rnn_exported):
    """--control as a spec, as the uniform shorthand with a zero latent,
    and as a .npz shard (``--steps 0`` takes the sequence's length);
    beam search under a control; the JAX CLI's error cases."""
    _, _, _, pf, _, tmp = rnn_exported
    out = tmp / "perf.mid"
    base = [pf, str(out), "--device", "cpu"]
    assert tcli.main(base + ["--steps", "24", "--control",
                             "1,0,1,0,1,1,0,1,0,1,0,1;3"]) == 0
    _events(out)
    assert tcli.main(base + ["--steps", "24", "--control", ";3",
                             "--init-zero", "--batch", "2"]) == 0
    _events(tmp / "perf-001.mid")
    shard = tmp / "ctl.npz"
    seqs = _control_shard(shard)
    assert tcli.main(base + ["--steps", "0", "--control", str(shard),
                             "--control-index", "1"]) == 0
    _events(out)
    assert tcli.main(base + ["--steps", "16", "--beam", "3", "--control",
                             ";3"]) == 0
    _events(out)
    assert seqs[1].shape == (30, 13)
    for bad in (["--steps", "8", "--control", "1,2;3"],
                ["--steps", "8", "--control", ";99"],
                ["--steps", "40", "--control", str(shard),
                 "--control-index", "1"],        # 30 rows < 40 steps
                ["--steps", "8", "--control", str(tmp)]):   # corpus dir
        with pytest.raises(SystemExit):
            tcli.main(base + bad)


def test_cli_control_and_beam_refused_where_they_do_not_apply(
        rnn_exported, exported):
    _, _, ev, _, _, tmp = rnn_exported
    with pytest.raises(SystemExit, match="PerformanceRNN"):
        tcli.main([ev, str(tmp / "x.mid"), "--steps", "4", "--control",
                   ";3", "--device", "cpu"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        tcli.main([ev, str(tmp / "x.mid"), "--steps", "4", "--beam", "2",
                   "--batch", "2", "--device", "cpu"])
    _, _, pth, _, _ = exported
    with pytest.raises(SystemExit, match="GRU families"):
        tcli.main([pth, str(tmp / "x.mid"), "--steps", "4", "--beam", "2",
                   "--device", "cpu"])


def test_serve_event_rnn_file_mode(rnn_exported):
    """cli.serve on an EventMelodyRNN: latents from init_seed, per-row
    sampling, a prime MIDI; the greedy request without a latent writes
    cli.generate's MIDI; every file reads back; window= is refused."""
    _, _, ev, _, prime, tmp = rnn_exported
    reqs = tmp / "ev_reqs.jsonl"
    lines = [{"id": "a", "tokens": [24, 28, 31], "max_new": 24},
             {"id": "b", "tokens": [10, 20, 30], "max_new": 40,
              "init_seed": 3},
             {"id": "c", "tokens": [5, 15], "max_new": 16, "init_seed": 4,
              "temperature": 0.9, "top_k": 12, "greedy": False},
             {"id": "d", "prime": prime, "prime_len": 20, "max_new": 16,
              "eos": 307}]
    reqs.write_text("".join(json.dumps(r) + "\n" for r in lines))
    outdir = tmp / "ev_served"
    assert tserve.main([ev, str(reqs), str(outdir), "--slots", "2",
                        "--seg-len", "8", "--greedy", "--device",
                        "cpu"]) == 0
    ref = tmp / "ev_ref_a.mid"
    assert tcli.main([ev, str(ref), "--steps", "24", "--temperature", "0",
                      "--device", "cpu"]) == 0
    assert (outdir / "a.mid").read_bytes() == ref.read_bytes()
    for name in "abc":
        _events(outdir / f"{name}.mid")
    assert (outdir / "d.mid").exists()
    bad = tmp / "ev_bad.jsonl"
    bad.write_text(json.dumps({"tokens": [1], "max_new": 4,
                               "window": 16}) + "\n")
    with pytest.raises(SystemExit, match="window"):
        tserve.main([ev, str(bad), str(tmp / "o"), "--device", "cpu"])


def test_serve_performance_rnn_control_rows(rnn_exported):
    """cli.serve on a PerformanceRNN: a repeated control, a per-step
    control sequence, none; each greedy result equals ``generate`` from
    the primary-event prompt with the request's latent and controls."""
    from musicgeneration_tpu_torch.convert import load_checkpoint
    from musicgeneration_tpu_torch.decode import (DecodeParams,
                                                  SamplingParams, generate)
    _, _, _, pf, _, tmp = rnn_exported
    rng = np.random.RandomState(1)
    ctrl_seq = rng.rand(20, 24).round(3).tolist()
    lines = [{"id": "r", "max_new": 24, "init_seed": 1,
              "control": rng.rand(24).round(3).tolist()},
             {"id": "s", "max_new": 30, "init_seed": 2, "control": ctrl_seq},
             {"id": "n", "max_new": 12}]
    reqs = tmp / "pf_reqs.jsonl"
    reqs.write_text("".join(json.dumps(r) + "\n" for r in lines))
    outdir = tmp / "pf_served"
    assert tserve.main([pf, str(reqs), str(outdir), "--slots", "2",
                        "--seg-len", "8", "--greedy", "--ctrl-window", "32",
                        "--device", "cpu"]) == 0
    model = load_checkpoint(pf, device="cpu")
    for r in lines:
        init = (np.random.RandomState(r["init_seed"]).randn(8).astype(
            np.float32) if "init_seed" in r else np.zeros(8, np.float32))
        ctrl = None
        if "control" in r:
            c = np.asarray(r["control"], np.float32)
            ctrl = torch.from_numpy(c[None] if c.ndim == 1 else c)[:, None]
        toks = generate(model, torch.tensor([[model.primary_event]]), None,
                        DecodeParams(max_len=1 + r["max_new"],
                                     steps=r["max_new"],
                                     sampling=SamplingParams(greedy=True)),
                        controls=ctrl, cache0=model.init_cache(
                            1, init=torch.from_numpy(init)[None]))
        ref = tmp / f"pf_ref_{r['id']}.mid"
        tcli.write_midi(toks[0].numpy(), str(ref))
        assert (outdir / f"{r['id']}.mid").read_bytes() == ref.read_bytes()


def test_import_check_covers_the_gru_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"ops/gru.py", "ops/fused_gru_decode.py", "decode/beam.py",
            "decode/serving_rnn.py", "models/event_rnn.py",
            "models/performance_rnn.py"} <= scanned


def test_import_check_covers_the_decode_loop_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"ops/decode_loop.py", "decode/engine.py",
            "models/music_transformer.py"} <= scanned


def test_import_check_covers_the_speculative_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"decode/speculative.py", "ops/fused_decode.py",
            "ops/relative_attention.py", "cli/generate.py"} <= scanned
