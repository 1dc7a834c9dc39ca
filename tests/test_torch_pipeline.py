"""Pipeline parallelism in the port, on the CPU, against the JAX package.

* The pipelined forward (``make_pipeline_apply``) against JAX's on the
  same weights (stacked by ``stack_layer_params`` for JAX): pp 2 and 4,
  one and two layers a stage, dp 2 x pp 2; logits within 1e-4 (f32).
* One pipelined train step against the plain JAX ``make_train_step`` on
  the unpipelined model (PR 2's tolerances), and one over two gloo ranks
  (``tests/torch_dp_gloo_worker.py`` with pp 2), its checkpoint gathered
  whole and scattered back.
* Dropout draws a stream for each (data shard, tick, stage, layer); the
  geometry errors are JAX's.
* ``cli.train pp=2`` over two gloo ranks equals the one-process run,
  resumes in one process and ``cli.generate`` reads its directory.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.models.music_transformer import stack_layer_params
from musicgeneration_tpu.parallel import make_mesh as jmake_mesh
from musicgeneration_tpu.parallel import (
    make_pipeline_apply as jmake_pipeline_apply)
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.parallel import (make_mesh,
                                                make_pipeline_apply,
                                                pipeline_param_shardings)
from musicgeneration_tpu_torch.train import trainer as ttr
from tests.test_torch_dp import (  # noqa: F401 (one_thread: a fixture)
    ACCUM, SEQ, V, check_step, jax_step, one_thread)
from tests.test_torch_dp_train import corpus  # noqa: F401 (a fixture)
from tests.test_torch_ring_train import (_args, _free_port, _json_lines,
                                         _losses, _run_ranks)
from tests.test_torch_tp import check_worker, run_worker

VOCAB, L, D = 37, 16, 64


def _pair(num_layers, seed=0):
    jm = JMusicTransformer(vocab_size=VOCAB, num_layers=num_layers,
                           d_model=D, max_seq=L, dropout_rate=0.0)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((2, L), jnp.int32))["params"]
    tm = MusicTransformer(vocab_size=VOCAB, num_layers=num_layers, d_model=D,
                          max_seq=L, dropout_rate=0.0, device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _tokens(seed, batch):
    return np.random.default_rng(seed).integers(0, VOCAB - 1, (batch, L))


def cpu_mesh(dp=1, pp=1):
    return make_mesh(dp=dp, pp=pp, devices=["cpu"] * (dp * pp))


@pytest.mark.parametrize("num_layers,dp,pp,n_micro", [
    (2, 1, 2, 4), (4, 1, 2, 2), (4, 1, 4, 4), (2, 2, 2, 2)],
    ids=["pp2-lp1", "pp2-lp2", "pp4-lp1", "dp2xpp2"])
def test_pipeline_forward_matches_jax(num_layers, dp, pp, n_micro):
    jm, params, tm = _pair(num_layers)
    x = _tokens(num_layers + pp, 8)
    jmesh = jmake_mesh(dp=dp, pp=pp, devices=jax.devices()[:dp * pp])
    ref = np.asarray(jmake_pipeline_apply(jm, jmesh, n_micro)(
        stack_layer_params(params, num_layers), jnp.asarray(x)))
    with torch.no_grad():
        got = make_pipeline_apply(tm, cpu_mesh(dp, pp), n_micro)(
            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    # and the unpipelined port model, exactly: each row's math is the same
    with torch.no_grad():
        torch.testing.assert_close(got, tm(torch.from_numpy(x)), rtol=0,
                                   atol=0)


def test_pipeline_step_matches_plain_jax_step():
    """dp 2 x pp 2, two micro-batches: the plain JAX step on the global
    batch (the JAX pipelined step equals it, tests/test_pipeline_parallel.py)
    within PR 2's tolerances."""
    params, x, y, jnew, jmet = jax_step(2, 1)
    mesh = cpu_mesh(2, 2)
    tm = MusicTransformer(vocab_size=V, num_layers=2, d_model=128,
                          max_seq=SEQ, dropout_rate=0.0, pad_in_input=False,
                          device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(params))
    cfg = ttr.TrainerConfig(vocab_size=V, pad_id=V - 1, d_model=128,
                            warmup_steps=10, accum_steps=ACCUM)
    tx = ttr.make_optimizer(cfg)
    state = ttr.create_train_state(tm, tx, 1, mesh=mesh)
    state, met = ttr.make_train_step(
        tx, cfg, tcli.pipeline_loss_fn(cfg, make_pipeline_apply(tm, mesh, 2)),
        mesh=mesh)(state, torch.from_numpy(x), torch.from_numpy(y))
    check_step(met, {n: p.detach() for n, p in tm.named_parameters()},
               tx.lr(0), jnew, jmet, "dp2 x pp2")


def test_gloo_pp2_step_matches_jax(tmp_path):
    """Two gloo ranks, one stage each (its layer's parameters; the
    other's empty), activations and gradients by send/recv."""
    jnew, jmet, metrics = run_worker(tmp_path, 1, 1, 1, 2)
    check_worker(tmp_path, jnew, jmet, metrics, ("dp",))


def test_pipeline_param_shardings_stages():
    _, _, tm = _pair(4)
    stages = pipeline_param_shardings(cpu_mesh(1, 2), tm)
    assert stages["Decoder.enc_layers.1.rga.Wq.weight"] == 0
    assert stages["Decoder.enc_layers.2.FFN_pre.bias"] == 1
    assert stages["Decoder.embedding.weight"] is None
    assert stages["fc.weight"] is None
    _, _, t3 = _pair(3)
    assert all(s is None for s in pipeline_param_shardings(
        cpu_mesh(1, 2), t3).values())


def test_dropout_decorrelated_across_data_shards():
    """Two data shards given the same rows draw different masks (JAX folds
    the data index into its key); a draw is a pure function of the
    generator."""
    jm = MusicTransformer(vocab_size=VOCAB, num_layers=2, d_model=D,
                          max_seq=L, dropout_rate=0.5, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    apply = make_pipeline_apply(jm, cpu_mesh(2, 2), n_micro=1)
    x = torch.from_numpy(np.tile(_tokens(3, 1), (2, 1)))

    def run(seed):
        with torch.no_grad():
            return apply(x, deterministic=False,
                         generator=torch.Generator().manual_seed(seed))

    out = run(1)
    assert torch.isfinite(out).all()
    assert not torch.allclose(out[0], out[1])
    assert torch.equal(out, run(1)) and not torch.equal(out, run(2))


def test_geometry_errors():
    _, _, tm = _pair(4)
    with pytest.raises(ValueError, match="num_layers=3 not divisible by "
                                         "pipe=2"):
        make_pipeline_apply(_pair(3)[2], cpu_mesh(1, 2), n_micro=2)
    with pytest.raises(ValueError, match="batch 8 not divisible by "
                                         "n_micro=3"):
        make_pipeline_apply(tm, cpu_mesh(1, 2), 3)(
            torch.from_numpy(_tokens(5, 8)))
    with pytest.raises(ValueError, match="microbatch 2 not divisible by "
                                         "data=4"):
        make_pipeline_apply(tm, cpu_mesh(4, 2), 4)(
            torch.from_numpy(_tokens(5, 8)))
    with pytest.raises(ValueError, match="pp composes with dp only"):
        make_pipeline_apply(tm, make_mesh(tp=2, pp=2, devices=["cpu"] * 4),
                            2)


def test_cli_train_pp2_gloo_resumes_and_generates(corpus):  # noqa: F811
    tmp, single = corpus
    port = _free_port()
    outs = _run_ranks(
        2, lambda r: [sys.executable, "-m",
                      "musicgeneration_tpu_torch.cli.train",
                      *_args(tmp, "pp", 3, "accum_steps=2", "pp=2",
                             "model.num_layers=2")],
        lambda r: dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port)))
    per_rank = [_losses(_json_lines(o)) for o in outs]
    assert sorted(per_rank[0]) == [0, 1, 2] and per_rank[1] == per_rank[0]
    one = tmp / "pp_one.jsonl"
    ref = tmp / "pp_ref.jsonl"
    assert tcli.main(_args(tmp, "pp_ref", 5, "accum_steps=2",
                           "model.num_layers=2", f"metrics_path={ref}")) == 0
    with open(ref) as f:
        want = _losses(map(json.loads, f))
    for s, loss in per_rank[0].items():
        assert loss == pytest.approx(want[s], rel=1e-5), s
    # the step files are the one-device layout: one process resumes them
    assert tcli.main(_args(tmp, "pp", 5, "accum_steps=2",
                           "model.num_layers=2", f"metrics_path={one}")) == 0
    with open(one) as f:
        resumed = _losses(map(json.loads, f))
    assert sorted(resumed) == [3, 4]
    for s, loss in resumed.items():
        assert loss == pytest.approx(want[s], rel=1e-5), s
    assert tgen.main([str(tmp / "pp"), str(tmp / "pp.mid"), "--steps", "8",
                      "--device", "cpu"]) == 0


@pytest.mark.parametrize("extra,world,match", [
    (("pp=2", "batch_size=3"), 2, "batch_size=3 must divide by "
                                  "pp_microbatches=2"),
    (("pp=2", "pp_microbatches=2", "dp=2", "batch_size=2"), 4,
     "microbatch 1 not divisible by data=2"),
], ids=["n_micro", "microbatch"])
def test_cli_train_pp_refusals(corpus, monkeypatch, extra, world, match):  # noqa: F811
    tmp, _ = corpus
    for k in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(SystemExit, match=match):
        tcli.main(_args(tmp, "bad", 1, *extra))
