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
    _, _, pth, _, tmp = exported
    with pytest.raises(SystemExit):
        tcli.main([pth, str(tmp / "x.mid"), "--steps", "300",
                   "--device", "cpu"])


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
    """A checkpoint that is not a MusicTransformer's exits and names the
    later slice; it does not fall back."""
    pth = tmp_path / "rnn.pth"
    torch.save({"net": {"gru.weight_ih_l0": torch.zeros(3, 2)},
                "optimizer": {}, "epoch": 0}, pth)
    reqs = tmp_path / "r.jsonl"
    reqs.write_text('{"tokens": [1], "max_new": 4}\n')
    with pytest.raises(SystemExit, match="later slice"):
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
