"""Sequence-parallel training in the port: one train step of the ring
model on a virtual mesh against the JAX package's ``make_train_step``
with its ring model, and real process groups on the CPU (gloo, started by
``subprocess`` on a free port, as tests/test_multihost.py does): the ring
and its rotation's backward across ranks, and ``cli.train sp=2`` against
the single-process run."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.parallel.mesh import make_mesh as jmake_mesh
from musicgeneration_tpu.train import trainer as jtr
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.parallel import make_mesh
from musicgeneration_tpu_torch.tokenizers import midilike
from musicgeneration_tpu_torch.train import trainer as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ring_gloo_worker.py")
TIMEOUT = 240
V, D, SEQ = 64, 128, 128


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _run_ranks(world, argv_of, env_of=lambda r: {}):
    """Start one process per rank, wait for all (each with a timeout) and
    return their outputs; every one must exit 0."""
    procs = [subprocess.Popen(argv_of(r), env=_env(**env_of(r)), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return outs


def test_ring_train_step_matches_jax():
    """One full step (forward, backward, clip, Adam, Noam) of the ring
    model on a virtual mesh of 2 shards against the JAX step with
    seq-sharded inputs: loss and accuracy within 1e-5 relative."""
    kw = dict(vocab_size=V, num_layers=2, d_model=D, max_seq=SEQ,
              dropout_rate=0.0)
    jmesh = jmake_mesh(sp=2, devices=jax.devices()[:2])
    jm = JMusicTransformer(attention_impl="ring", mesh=jmesh, **kw)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 60, (4, SEQ)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    jcfg = jtr.TrainerConfig(vocab_size=V, d_model=D, pad_id=V - 1,
                             accum_steps=1)
    jstate, jtx = jtr.create_train_state(jm, jcfg, jax.random.PRNGKey(0),
                                         jnp.asarray(x))
    sh = NamedSharding(jmesh, P("data", "seq"))
    _, jmet = jax.jit(jtr.make_train_step(jm, jtx, jcfg))(
        jstate, jax.device_put(jnp.asarray(x), sh),
        jax.device_put(jnp.asarray(y), sh))

    tm = MusicTransformer(attention_impl="ring",
                          mesh=make_mesh(sp=2, devices=["cpu"] * 2),
                          device="cpu", **kw)
    tm.load_state_dict(convert.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params)))
    tcfg = ttr.TrainerConfig(vocab_size=V, d_model=D, pad_id=V - 1,
                             accum_steps=1)
    ttx = ttr.make_optimizer(tcfg)
    state = ttr.create_train_state(tm, ttx, dropout_seed=0)
    _, tmet = ttr.make_train_step(ttx, tcfg)(state, torch.from_numpy(x),
                                             torch.from_numpy(y))
    for key in ("loss", "accuracy"):
        assert tmet[key] == pytest.approx(float(jmet[key]), rel=1e-5), key
    assert tmet["grad_norm"] == pytest.approx(float(jmet["grad_norm"]),
                                              rel=1e-4)


def test_gloo_ring_and_rotation_backward():
    """Four gloo ranks: the plain ring and the kernel-G ring (its plain
    tile) over the process group, forward and backward, equal the
    virtual mesh; the double buffer receives only into the slot the
    previous round's tile read; the rotation's backward goes back one
    rank."""
    port = _free_port()
    outs = _run_ranks(4, lambda r: [sys.executable, WORKER, str(r), "4",
                                    str(port)])
    for r, out in enumerate(outs):
        assert f"RINGOK rank={r}" in out, out[-4000:]


# --------------------------------------------------------------------------
# cli.train sp=2 on two gloo processes
# --------------------------------------------------------------------------

# records which rank saves each checkpoint, then runs cli.train
_CLI = """
import os, sys
from musicgeneration_tpu_torch.utils import checkpoint as ck
real = ck.save_checkpoint
def save(*a, **k):
    with open(os.environ["SAVE_LOG"], "a") as f:
        f.write(os.environ["RANK"] + "\\n")
    return real(*a, **k)
ck.save_checkpoint = save
from musicgeneration_tpu_torch.cli.train import main
sys.exit(main(sys.argv[1:]))
"""
CLI_SEQ = 32


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_corpus")
    os.makedirs(tmp / "midis")
    for i in range(3):
        toks = np.random.default_rng(i).integers(0, 308, 300)
        midilike.write_midi(midilike.EventSeq.from_array(toks),
                            str(tmp / "midis" / f"f{i}.mid"))
    assert ttok.main([str(tmp / "midis"), str(tmp / "tok"), "--workers",
                      "1"]) == 0
    return tmp


def _args(tmp, run, steps, *extra):
    return [str(tmp / "tok"), f"steps={steps}", "batch_size=2",
            f"seq_len={CLI_SEQ}", "model.num_layers=1", "model.d_model=64",
            "model.dropout_rate=0.0", f"ckpt_dir={tmp / run}",
            "ckpt_every=2", "log_every=1",
            f"metrics_path={tmp / (run + '.jsonl')}", *extra,
            "--device", "cpu"]


def _losses(lines):
    return {r["step"]: r["loss"] for r in lines if r.get("kind") == "train"}


def _json_lines(text):
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


def _sp2(tmp, run, steps):
    port = _free_port()
    return _run_ranks(
        2, lambda r: [sys.executable, "-c", _CLI, *_args(tmp, run, steps,
                                                          "sp=2")],
        lambda r: dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       SAVE_LOG=str(tmp / f"{run}.saves")))


def test_cli_train_sp2_gloo(corpus):
    tmp = corpus
    assert tcli.main(_args(tmp, "single", 5)) == 0
    with open(tmp / "single.jsonl") as f:
        single = _losses(map(json.loads, f))

    outs = _sp2(tmp, "sp", 3)
    per_rank = [_losses(_json_lines(o)) for o in outs]
    assert sorted(per_rank[0]) == [0, 1, 2]
    assert per_rank[0] == per_rank[1]  # every rank logs the global loss
    assert all(r.get("rank") == 1 for r in _json_lines(outs[1])
               if r.get("kind") == "train")
    for s, loss in per_rank[0].items():
        assert loss == pytest.approx(single[s], rel=1e-5), s
    # rank 0 alone writes the metrics file and the checkpoints
    with open(tmp / "sp.jsonl") as f:
        assert sorted(_losses(map(json.loads, f))) == [0, 1, 2]
    with open(tmp / "sp.saves") as f:
        assert set(f.read().split()) == {"0"}

    # every rank resumes from the directory and continues the run
    outs = _sp2(tmp, "sp", 5)
    for o in outs:
        resumed = _losses(_json_lines(o))
        assert sorted(resumed) == [3, 4]
        for s, loss in resumed.items():
            assert loss == pytest.approx(single[s], rel=1e-5), s

    out = tmp / "gen.mid"
    assert tgen.main([str(tmp / "sp"), str(out), "--steps", "8",
                      "--temperature", "0", "--device", "cpu"]) == 0
    assert out.exists()
    model = convert.load_checkpoint(str(tmp / "sp"), device="cpu")
    assert model.attention_impl == "auto"


def test_cli_train_sp_needs_matching_world_size(corpus, monkeypatch,
                                                capsys):
    tmp = corpus
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="WORLD_SIZE is 1"):
        tcli.main(_args(tmp, "bad", 1, "sp=2"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="WORLD_SIZE is 2"):
        tcli.main(_args(tmp, "bad", 1, "sp=2", "dp=2"))  # 4 shards
    with pytest.raises(SystemExit, match="dp=0 x sp=2 x tp=2 runs one "
                                         "process per shard.*WORLD_SIZE is 2"):
        tcli.main(_args(tmp, "bad", 1, "sp=2", "tp=2"))  # 4 shards
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match="not divisible by sp=3"):
        tcli.main(_args(tmp, "bad", 1, "sp=3"))
