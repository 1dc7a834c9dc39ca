"""Data-parallel and FSDP training over real process groups on the CPU
(gloo, one subprocess a rank on a free port, as
tests/test_torch_ring_train.py starts them).

* ``tests/torch_dp_gloo_worker.py`` on a dp 2 mesh (2 ranks) and a dp 2 x
  sp 2 mesh (4 ranks): one train step of plain data parallelism and one
  of FSDP2, the data shards holding different numbers of pad targets,
  against the JAX ``make_train_step`` on the global batch under its (data,
  seq) mesh; the FSDP checkpoint gathered whole and scattered back; on dp
  2 a distillation step against the port's one-process distillation
  step. Tolerances (f32): loss and accuracy 1e-5 relative, grad norm 1e-4
  relative, parameters 2 * lr + 1e-6 absolute, Adam moments 1e-4 of each
  tensor's largest entry plus 1e-6 of the largest over all tensors
  (tests/test_torch_train.py gives the reasons).
* ``cli.train dp=2``, ``dp=2 sp=2`` and ``dp=2 fsdp=true`` against the
  one-process run's losses (1e-5 relative), rank 0 alone writing
  checkpoints, and a dp run's step file resumed in one process (and an
  fsdp one under fsdp); the refusals of the JAX CLI's mesh training.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.tokenizers import midilike
from musicgeneration_tpu_torch.train import trainer as ttr
from musicgeneration_tpu_torch.utils.checkpoint import restore_checkpoint
from tests.test_torch_dp import (  # noqa: F401 (one_thread: a fixture)
    ACCUM, D, SEQ, V, check_step, jax_step, one_thread)
from tests.test_torch_ring_train import (_args, _free_port, _json_lines,
                                         _losses, _run_ranks)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_gloo_worker.py")
# records which rank writes each checkpoint (under fsdp every rank joins
# the gathers: ``write=False``), then runs cli.train
_CLI = """
import os, sys
from musicgeneration_tpu_torch.utils import checkpoint as ck
real = ck.save_checkpoint
def save(*a, **k):
    if k.get("write", True):
        with open(os.environ["SAVE_LOG"], "a") as f:
            f.write(os.environ["RANK"] + "\\n")
    return real(*a, **k)
ck.save_checkpoint = save
from musicgeneration_tpu_torch.cli.train import main
sys.exit(main(sys.argv[1:]))
"""


def _close_moments(got, jax_tree, what):
    ref = convert.state_dict_from_jax(jax.tree.map(np.asarray, jax_tree))
    floor = 1e-6 * max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(got[name].numpy(), r, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(r).max()) + floor,
                                   err_msg=f"{what} {name}")


def _teacher_sd():
    m = MusicTransformer(vocab_size=V, num_layers=2, d_model=D, max_seq=SEQ,
                         dropout_rate=0.0, pad_in_input=False, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    return m.state_dict()


def _distill_reference(sd, teacher_sd, x, y):
    """The port's one-process distillation step on the global batch."""
    def build(weights):
        m = MusicTransformer(vocab_size=V, num_layers=2, d_model=D,
                             max_seq=SEQ, dropout_rate=0.0,
                             pad_in_input=False, device="cpu")
        m.load_state_dict(weights)
        return m

    cfg = ttr.TrainerConfig(vocab_size=V, pad_id=V - 1, d_model=D,
                            warmup_steps=10, accum_steps=ACCUM)
    tx = ttr.make_optimizer(cfg)
    teacher = build(teacher_sd).requires_grad_(False)
    step = ttr.make_train_step(
        tx, cfg, loss_fn=tcli.distill_loss_fn(cfg, teacher, 0.5, 2.0))
    _, met = step(ttr.create_train_state(build(sd), tx, 1),
                  torch.from_numpy(x).long(), torch.from_numpy(y).long())
    return met


@pytest.mark.parametrize("dp,sp", [(2, 1), (2, 2)], ids=["dp2", "dp2xsp2"])
def test_gloo_dp_and_fsdp_steps_match_jax(tmp_path, dp, sp):
    params, x, y, jnew, jmet = jax_step(dp, sp)
    sd = convert.state_dict_from_jax(params)
    teacher = _teacher_sd()
    inp = tmp_path / "inputs.npz"
    np.savez(inp, x=x, y=y, V=V, D=D, SEQ=SEQ, ACCUM=ACCUM,
             **{f"sd.{k}": v.numpy() for k, v in sd.items()},
             **{f"te.{k}": v.numpy() for k, v in teacher.items()})
    port = _free_port()
    world = dp * sp
    outs = _run_ranks(world, lambda r: [
        sys.executable, WORKER, str(r), str(world), str(port), str(dp),
        str(sp), str(inp), str(tmp_path)])
    for r, out in enumerate(outs):
        assert f"DPOK rank={r}" in out, out[-4000:]
    with open(tmp_path / "metrics.json") as f:
        metrics = json.load(f)
    lr = ttr.make_optimizer(ttr.TrainerConfig(
        vocab_size=V, d_model=D, warmup_steps=10)).lr(0)
    adam = jnew.opt_state[1][0]
    for name in ("dp", "fsdp"):
        payload = restore_checkpoint(str(tmp_path / name))
        check_step(metrics[name], payload["model"], lr, jnew, jmet, name)
        assert payload["opt"]["count"] == 1
        _close_moments(payload["opt"]["mu"], adam.mu, f"{name} mu")
        _close_moments(payload["opt"]["nu"], adam.nu, f"{name} nu")
    if sp == 1:
        ref = _distill_reference(sd, teacher, x, y)
        for k in ("loss", "accuracy"):
            assert metrics["distill"][k] == pytest.approx(ref[k], rel=1e-5)
        assert metrics["distill"]["grad_norm"] == pytest.approx(
            ref["grad_norm"], rel=1e-4)


# --------------------------------------------------------------------------
# cli.train dp=2, dp=2 sp=2, dp=2 fsdp=true
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_corpus")
    os.makedirs(tmp / "midis")
    for i in range(3):
        toks = np.random.default_rng(i).integers(0, 308, 300)
        midilike.write_midi(midilike.EventSeq.from_array(toks),
                            str(tmp / "midis" / f"f{i}.mid"))
    assert ttok.main([str(tmp / "midis"), str(tmp / "tok"), "--workers",
                      "1"]) == 0
    assert tcli.main(_args(tmp, "single", 5, "accum_steps=2")) == 0
    with open(tmp / "single.jsonl") as f:
        single = _losses(map(json.loads, f))
    return tmp, single


def _mesh_run(tmp, run, steps, world, *extra):
    port = _free_port()
    return _run_ranks(
        world, lambda r: [sys.executable, "-c", _CLI,
                          *_args(tmp, run, steps, "accum_steps=2", *extra)],
        lambda r: dict(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       SAVE_LOG=str(tmp / f"{run}.saves")))


def _check_losses(outs, single, steps):
    per_rank = [_losses(_json_lines(o)) for o in outs]
    assert sorted(per_rank[0]) == steps
    for losses in per_rank[1:]:
        assert losses == per_rank[0]  # every rank logs the global loss
    for s, loss in per_rank[0].items():
        assert loss == pytest.approx(single[s], rel=1e-5), s


@pytest.mark.parametrize("run,world,extra", [
    ("dp", 2, ("dp=2",)), ("dpsp", 4, ("dp=2", "sp=2")),
    ("fsdp", 2, ("fsdp=true",))], ids=["dp2", "dp2xsp2", "fsdp"])
def test_cli_train_mesh_matches_one_process(corpus, run, world, extra):
    tmp, single = corpus
    _check_losses(_mesh_run(tmp, run, 3, world, *extra), single, [0, 1, 2])
    with open(tmp / f"{run}.saves") as f:
        assert set(f.read().split()) == {"0"}  # rank 0 alone writes
    # the step files hold the one-device layout: resume in one process
    # (an fsdp run under fsdp, which scatters it back into shards)
    if run == "fsdp":
        _check_losses(_mesh_run(tmp, run, 5, world, *extra), single, [3, 4])
    else:
        out = tmp / f"{run}.resume.jsonl"
        assert tcli.main(_args(tmp, run, 5, "accum_steps=2",
                               f"metrics_path={out}")) == 0
        with open(out) as f:
            resumed = _losses(map(json.loads, f))
        assert sorted(resumed) == [3, 4]
        for s, loss in resumed.items():
            assert loss == pytest.approx(single[s], rel=1e-5), s


def test_gloo_dp_uneven_accumulation_matches_jax(tmp_path):
    """batch_size 3, accum_steps 2, dp 2 (JAX's rule: batch_size *
    accum_steps divisible by dp): each rank takes an even share of the 6
    accumulated rows, each row's loss over the global kept count of its
    own micro-batch; the JAX step on the global batch, within PR 2's
    tolerances (plain dp and FSDP2)."""
    from tests.test_torch_tp import check_worker, run_worker
    jnew, jmet, metrics = run_worker(tmp_path, 2, 1, 1, 1, b=3)
    check_worker(tmp_path, jnew, jmet, metrics, ("dp", "fsdp"))


def test_micro_runs_share_the_accumulated_rows():
    """Where dp divides the micro-batch each rank holds rows of every
    micro-batch; else its contiguous share, cut where a micro-batch ends
    (batch 3, accum 4, dp 6: two rows a rank)."""
    from musicgeneration_tpu_torch.parallel.mesh import Mesh
    assert ttr.micro_runs(8, 2) == [(0, slice(0, 4)), (1, slice(4, 8))]
    runs = [ttr.micro_runs(2, 4, Mesh(size=1, device=torch.device("cpu"),
                                      data=6, data_rank=r))
            for r in range(6)]
    assert runs[0] == [(0, slice(0, 2))]
    assert runs[1] == [(0, slice(0, 1)), (1, slice(1, 2))]
    assert runs[5] == [(3, slice(0, 2))]


def test_cli_train_one_process_fsdp_shards_nothing(monkeypatch):
    """Started without torchrun's variables, fsdp=true and dp=1 form no
    group: one process trains unsharded, as JAX does on one device."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for extra in (dict(fsdp=True), dict(dp=1), dict(dp=1, fsdp=True)):
        assert tcli.init_mesh(tcli.TrainCLIConfig(**extra), "cpu") is None
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("env,extra,match", [
    ({}, ("model=event_rnn", "dp=2"), "wired for model=music_transformer"),
    ({}, ("pp=2", "sp=2"), "pp composes with dp only"),
    ({}, ("pp=2", "tp=2"), "pp composes with dp only"),
    ({"WORLD_SIZE": "2"}, ("dp=3",), "WORLD_SIZE is 2"),
    ({"WORLD_SIZE": "3"}, ("dp=3",), "batch_size\\*accum_steps must divide"),
    ({"WORLD_SIZE": "2"}, ("dp=2",), "needs MASTER_ADDR and MASTER_PORT"),
], ids=["family", "pp_sp", "tp", "world", "batch", "port"])
def test_cli_train_mesh_refusals(corpus, monkeypatch, env, extra, match):
    tmp, _ = corpus
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=match):
        tcli.main(_args(tmp, "bad", 1, *extra))
