"""The port's ``cli.generate`` on an exported ``.pth``, and the port's
isolation: it imports nothing of JAX or of the JAX package, and a CUDA
request without a GPU raises instead of running on the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

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
from musicgeneration_tpu_torch.models import MusicTransformer
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
