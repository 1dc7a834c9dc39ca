"""Tensor parallelism in the port, on the CPU, against the JAX package.

* ``param_placements`` against JAX ``param_shardings`` on the same
  MusicTransformer and CP transformer, mapped through ``convert.py``'s
  names (flax [in, out] kernels are torch's [out, in]): the dimension
  split over ``model``, the guard (a dimension the axis does not divide is
  replicated) and whether ``fsdp`` adds a data dimension.
* One train step on a virtual dp 2 x tp 2 and a tp 2 x sp 2 (the ring on
  each head shard) mesh against the JAX ``make_train_step`` under
  ``param_shardings``, and over gloo process groups (tp 2; dp 2 x tp 2,
  with and without FSDP2; ``tests/torch_dp_gloo_worker.py``), the
  checkpoint gathered whole and scattered back. Tolerances (f32): loss
  and accuracy 1e-5 relative, grad norm 1e-4 relative, parameters 2 * lr
  + 1e-6 (tests/test_torch_train.py gives the reasons; a bias of K has a
  zero gradient in exact arithmetic, so Adam's first step moves it by
  +-lr on rounding noise).
* ``generate_tp``: greedy tokens against the JAX ``generate_tp`` (tp 2,
  dp 4 x tp 2), sampled tokens against the port's ``generate`` with the
  same generator, its refusals; ``cli.generate --tp 2`` writes the bytes
  of ``--tp 1``; ``cli.train tp=2`` over two gloo ranks equals the
  one-process run, resumes across tp 2 -> 1 -> 2 and ``cli.generate``
  reads its directory.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.decode import DecodeParams as JDecodeParams
from musicgeneration_tpu.decode.engine import generate_tp as jgenerate_tp
from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.models import CPTransformer as JCPTransformer
from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.parallel.mesh import make_mesh as jmake_mesh
from musicgeneration_tpu.parallel.mesh import param_shardings
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate, generate_tp)
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.models.cp_transformer import CPTransformer
from musicgeneration_tpu_torch.parallel import make_mesh, param_placements
from musicgeneration_tpu_torch.train import trainer as ttr
from tests.test_torch_dp import (  # noqa: F401 (one_thread: a fixture)
    ACCUM, D, SEQ, V, check_step, jax_step, one_thread)
from tests.test_torch_dp_train import WORKER, _close_moments, corpus  # noqa
from tests.test_torch_ring_train import (_args, _free_port, _json_lines,
                                         _losses, _run_ranks)


def cpu_mesh(dp=1, tp=1, sp=1):
    return make_mesh(dp=dp, tp=tp, sp=sp, devices=["cpu"] * (dp * tp * sp))


# --------------------------------------------------------------------------
# placements
# --------------------------------------------------------------------------

def _spec_dims(jtree, jmesh, convert_fn, fsdp):
    """{port name: (model dim in torch's layout, whether 'data' is set)}
    from JAX's param_shardings, matched to the port's names by the values
    convert_fn carries across."""
    flat, treedef = jax.tree_util.tree_flatten(jtree)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(a), float(i), np.float32)
                  for i, a in enumerate(flat)])
    specs = jax.tree_util.tree_leaves(
        param_shardings(jmesh, jtree, fsdp=fsdp),
        is_leaf=lambda s: hasattr(s, "spec"))
    out = {}
    for name, t in convert_fn(tagged).items():
        i = int(t.reshape(-1)[0])
        spec = list(specs[i].spec) + [None] * (np.ndim(flat[i])
                                               - len(specs[i].spec))
        dim = spec.index("model") if "model" in spec else None
        if dim is not None and name.endswith(".weight") \
                and "embed" not in name:
            dim = 1 - dim  # a flax kernel [in, out]: torch's [out, in]
        out[name] = (dim, "data" in spec)
    return out


@pytest.mark.parametrize("tp,fsdp", [(2, False), (2, True), (3, False)],
                         ids=["tp2", "tp2-fsdp", "guard-tp3"])
def test_param_placements_match_jax_param_shardings(tp, fsdp):
    jmesh = jmake_mesh(dp=6 // tp if tp == 3 else 2, tp=tp,
                       devices=jax.devices()[:6 if tp == 3 else 2 * tp])
    cases = [
        (JMusicTransformer(vocab_size=V, num_layers=2, d_model=D,
                           max_seq=SEQ), jnp.zeros((1, 8), jnp.int32),
         convert.state_dict_from_jax,
         MusicTransformer(vocab_size=V, num_layers=2, d_model=D,
                          max_seq=SEQ, device="cpu")),
        (JCPTransformer(num_layers=1, d_model=D, max_seq=16),
         jnp.zeros((1, 4, 8), jnp.int32),
         convert.cp_transformer_state_dict_from_jax,
         CPTransformer(num_layers=1, d_model=D, max_seq=16, device="cpu"))]
    mesh = cpu_mesh(dp=2, tp=tp)
    for jm, x, conv, tm in cases:
        params = jax.tree.map(np.asarray,
                              jm.init(jax.random.PRNGKey(0), x)["params"])
        want = _spec_dims(params, jmesh, conv, fsdp)
        got = param_placements(mesh, tm, fsdp=fsdp)
        assert set(got) == set(want)
        for name, (dim, data) in want.items():
            assert got[name].model == dim, name
            if data:  # FSDP2 shards every tensor of the local shard
                assert got[name].data is not None, name
            assert (got[name].data is not None) == fsdp, name
    if tp == 2:  # the split heads, FFN, embedding and head
        p = param_placements(mesh, cases[0][3])
        assert p["Decoder.enc_layers.0.rga.Wq.weight"].model == 0
        assert p["Decoder.enc_layers.0.rga.fc.weight"].model == 1
        assert p["Decoder.enc_layers.0.FFN_suf.weight"].model == 1
        assert p["Decoder.embedding.weight"].model == 1
        assert p["fc.weight"].model == 1
        assert p["Decoder.enc_layers.0.rga.E"].model is None
    else:  # d 128, FFN 64: no dimension of the flagship divides by 3
        assert all(v.model is None for v in
                   param_placements(mesh, cases[0][3]).values())


def test_make_mesh_model_and_pipe_axes():
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    assert (mesh.data, mesh.model, mesh.size, mesh.pipe) == (2, 2, 1, 1)
    assert mesh.model_devices == ((torch.device("cpu"),) * 2,) * 2
    mesh = make_mesh(tp=2, devices=["cpu", "meta", "cpu", "meta"])
    assert mesh.data == 2 and mesh.model_devices[1] == (
        torch.device("cpu"), torch.device("meta"))
    assert make_mesh(pp=2, devices=["cpu"] * 4).pipe == 2
    with pytest.raises(ValueError, match="one device"):
        make_mesh(sp=2, tp=2, devices=["cpu", "meta", "cpu", "cpu"])
    with pytest.raises(ValueError, match="dp\\*sp\\*tp\\*pp = 1\\*1\\*3\\*1"
                                         " != 4"):
        make_mesh(dp=1, tp=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="num_heads=2 not divisible by the "
                                         "model axis \\(4\\)"):
        MusicTransformer(d_model=128, device="cpu", mesh=cpu_mesh(tp=4))


# --------------------------------------------------------------------------
# one train step on a virtual mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp,sp", [(2, 2, 1), (1, 2, 2)],
                         ids=["dp2xtp2", "tp2xsp2"])
def test_virtual_tp_train_step_matches_jax(dp, tp, sp):
    params, x, y, jnew, jmet = jax_step(dp, sp, tp=tp)
    mesh = cpu_mesh(dp, tp, sp)
    ring = dict(attention_impl="ring") if sp > 1 else {}
    tm = MusicTransformer(vocab_size=V, num_layers=2, d_model=D, max_seq=SEQ,
                          dropout_rate=0.0, pad_in_input=False, device="cpu",
                          mesh=mesh, **ring)
    tm.load_state_dict(convert.state_dict_from_jax(params))
    cfg = ttr.TrainerConfig(vocab_size=V, pad_id=V - 1, d_model=D,
                            warmup_steps=10, accum_steps=ACCUM)
    tx = ttr.make_optimizer(cfg)
    state = ttr.create_train_state(tm, tx, 1, mesh=mesh)
    lr = tx.lr(0)
    state, met = ttr.make_train_step(tx, cfg, mesh=mesh)(
        state, torch.from_numpy(x), torch.from_numpy(y))
    check_step(met, {n: p.detach() for n, p in tm.named_parameters()}, lr,
               jnew, jmet, f"dp{dp} tp{tp} sp{sp}")


# --------------------------------------------------------------------------
# gloo process groups
# --------------------------------------------------------------------------

def run_worker(tmp_path, dp, sp, tp, pp, b=4, teacher=False):
    """tests/torch_dp_gloo_worker.py on dp * sp * tp * pp ranks; returns
    the JAX reference (jax_step) and the worker's metrics."""
    params, x, y, jnew, jmet = jax_step(dp, sp, tp=tp, b=b) if pp == 1 \
        else jax_step(dp, sp, b=b)
    sd = convert.state_dict_from_jax(params)
    inp = tmp_path / "inputs.npz"
    np.savez(inp, x=x, y=y, V=V, D=D, SEQ=SEQ, ACCUM=ACCUM,
             **{f"sd.{k}": v.numpy() for k, v in sd.items()})
    port, world = _free_port(), dp * sp * tp * pp
    outs = _run_ranks(world, lambda r: [
        sys.executable, WORKER, str(r), str(world), str(port), str(dp),
        str(sp), str(inp), str(tmp_path), str(tp), str(pp)])
    for r, out in enumerate(outs):
        assert f"DPOK rank={r}" in out, out[-4000:]
    with open(tmp_path / "metrics.json") as f:
        return jnew, jmet, json.load(f)


def check_worker(tmp_path, jnew, jmet, metrics, names):
    from musicgeneration_tpu_torch.utils.checkpoint import restore_checkpoint
    lr = ttr.make_optimizer(ttr.TrainerConfig(
        vocab_size=V, d_model=D, warmup_steps=10)).lr(0)
    adam = jnew.opt_state[1][0]
    for name in names:
        payload = restore_checkpoint(str(tmp_path / name))
        check_step(metrics[name], payload["model"], lr, jnew, jmet, name)
        assert payload["opt"]["count"] == 1
        _close_moments(payload["opt"]["mu"], adam.mu, f"{name} mu")
        _close_moments(payload["opt"]["nu"], adam.nu, f"{name} nu")


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)], ids=["tp2", "dp2xtp2"])
def test_gloo_tp_steps_match_jax(tmp_path, dp, tp):
    """Each rank holds its head shard (its Wq/Wk/Wv rows, fc and FFN_suf
    columns, embedding and head columns) and Adam moments of that
    layout; with and without FSDP2 over the data group."""
    jnew, jmet, metrics = run_worker(tmp_path, dp, 1, tp, 1)
    check_worker(tmp_path, jnew, jmet, metrics, ("dp", "fsdp"))


# --------------------------------------------------------------------------
# generate_tp
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mt():
    """The JAX test's MusicTransformer (vocab 64, 2 layers, d 128, max_seq
    64) with its XLA decode path, and the port's on the same weights."""
    jm = JMusicTransformer(vocab_size=V, num_layers=2, d_model=D,
                           max_seq=64, dropout_rate=0.0, decode_impl="xla")
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((2, 16), jnp.int32))["params"]
    tm = MusicTransformer(vocab_size=V, num_layers=2, d_model=D, max_seq=64,
                          dropout_rate=0.0, device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _prompt(b, p, seed):
    return np.random.default_rng(seed).integers(0, 60, (b, p)).astype(
        np.int32)


@pytest.mark.parametrize("b,dp,tp", [(4, 1, 2), (8, 4, 2)],
                         ids=["tp2", "dp4xtp2"])
def test_generate_tp_greedy_matches_jax(mt, b, dp, tp):
    jm, params, tm = mt
    prompt = _prompt(b, 8, b + dp)
    jmesh = jmake_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    jdp = JDecodeParams(max_len=32, steps=12,
                        sampling=JSampling(greedy=True))
    ref = np.asarray(jgenerate_tp(jm, params, jnp.asarray(prompt),
                                  jax.random.PRNGKey(2), jdp, jmesh))
    dpar = DecodeParams(max_len=32, steps=12,
                        sampling=SamplingParams(greedy=True))
    got = generate_tp(tm, prompt, 0, dpar, cpu_mesh(dp, tp)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_generate_tp_sampled_equals_generate(mt):
    """One sampler over the summed logits: dp 2 x tp 2 draws what
    ``generate`` draws with the same generator, bucketed prompt too."""
    _, _, tm = mt
    prompt = np.full((4, 12), V - 1, np.int64)
    prompt[:, :9] = _prompt(4, 9, 3)
    dpar = DecodeParams(max_len=40, steps=16,
                        sampling=SamplingParams(temperature=1.0, top_k=8))
    ref = generate(tm, torch.from_numpy(prompt),
                   torch.Generator().manual_seed(5), dpar, prompt_len=9)
    got = generate_tp(tm, prompt, 5, dpar, cpu_mesh(2, 2), prompt_len=9)
    assert torch.equal(got, ref)
    again = generate_tp(tm, prompt, torch.Generator().manual_seed(5), dpar,
                        cpu_mesh(1, 2), prompt_len=9)
    assert torch.equal(again, ref)


def test_generate_tp_refusals(mt):
    _, _, tm = mt
    dpar = DecodeParams(max_len=32, steps=4,
                        sampling=SamplingParams(greedy=True))
    x = np.zeros((2, 8), np.int32)
    with pytest.raises(ValueError, match="num_heads=2 not divisible by the "
                                         "model axis \\(4\\)"):
        generate_tp(tm, x, 0, dpar, cpu_mesh(1, 4))
    with pytest.raises(ValueError, match="batch 2 not divisible by the data "
                                         "axis \\(4\\)"):
        generate_tp(tm, x, 0, dpar, cpu_mesh(4, 2))
    with pytest.raises(ValueError, match="sp=2"):
        generate_tp(tm, x, 0, dpar, cpu_mesh(1, 2, 2))
    with pytest.raises(ValueError, match="fused kernels"):
        generate_tp(tm, x, 0, DecodeParams(max_len=32, steps=4,
                                           use_loop_kernel=True),
                    cpu_mesh(1, 2))
    q8 = MusicTransformer(vocab_size=V, num_layers=1, d_model=D, max_seq=64,
                          decode_quant="int8", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        generate_tp(q8, x, 0, dpar, cpu_mesh(1, 2))
    sharded = MusicTransformer(vocab_size=V, num_layers=1, d_model=D,
                               max_seq=64, device="cpu", mesh=cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="generate_tp"):
        generate(sharded, torch.zeros(2, 8, dtype=torch.long), None, dpar)


def test_cp_transformer_on_head_shards_matches_unsharded():
    """The CP trunk, summed field embeddings (d-split) and 8 heads (split
    where the field's size divides) under a virtual dp 2 x tp 2 mesh:
    the unsharded logits and gradients."""
    kw = dict(num_layers=1, d_model=D, max_seq=16, dropout_rate=0.0,
              device="cpu")
    ref = CPTransformer(generator=torch.Generator().manual_seed(0), **kw)
    got = CPTransformer(mesh=cpu_mesh(2, 2), **kw)
    got.load_state_dict(ref.state_dict())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.stack([rng.integers(0, fd, (2, 16))
                                   for fd in ref.field_dims], -1))
    a, b = ref(x), got(x)
    for la, lb in zip(a, b):
        torch.testing.assert_close(lb, la, rtol=1e-5, atol=1e-5)
    sum(lb.sum() for lb in b).backward()
    sum(la.sum() for la in a).backward()
    for (n, p), q in zip(ref.named_parameters(), got.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-4, atol=1e-4,
                                   msg=n)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A flagship-vocabulary MusicTransformer with two heads as a .pth."""
    tmp = tmp_path_factory.mktemp("tp_cli")
    m = MusicTransformer(vocab_size=309, num_layers=1, d_model=128,
                         max_seq=128, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    pth = str(tmp / "mt.pth")
    torch.save({"net": m.state_dict(), "optimizer": {}, "epoch": 0}, pth)
    return tmp, pth


@pytest.mark.parametrize("extra", [["--temperature", "0"],
                                   ["--seed", "7", "--topk", "8"]],
                         ids=["greedy", "sampled"])
def test_cli_generate_tp_equals_tp1(exported, extra):
    tmp, pth = exported
    base = ["--steps", "12", "--batch", "4", "--device", "cpu", *extra]
    tag = extra[1]
    assert tgen.main([pth, str(tmp / f"a{tag}.mid"), *base]) == 0
    assert tgen.main([pth, str(tmp / f"b{tag}.mid"), *base, "--tp", "2",
                      "--dp", "2"]) == 0
    for i in range(4):
        assert (tmp / f"a{tag}-{i:03d}.mid").read_bytes() == (
            tmp / f"b{tag}-{i:03d}.mid").read_bytes(), i


@pytest.mark.parametrize("extra,match", [
    (["--tp", "2", "--quant", "int8"], "--quant rides the fused kernels"),
    (["--tp", "2", "--spec", "lookup"], "--spec with --tp is not supported"),
    (["--tp", "2", "--steps", "200"], "--batch/--dp/--tp/--spec with a "
                                      "continuation beyond max_seq"),
    (["--tp", "4"], "num_heads=2 not divisible by the model axis \\(4\\)"),
], ids=["quant", "spec", "sliding", "heads"])
def test_cli_generate_tp_refusals(exported, extra, match):
    tmp, pth = exported
    argv = [pth, str(tmp / "r.mid"), "--steps", "8", "--device", "cpu"]
    with pytest.raises((SystemExit, ValueError), match=match):
        tgen.main(argv + extra)


def test_cli_generate_tp_needs_devices_and_the_flagship_family(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match="--dp 2 x --tp 2 needs 4 devices, "
                                         "have 2"):
        tgen.dp_mesh(2, 4, "cuda", tp=2)
    from musicgeneration_tpu_torch.models.event_rnn import EventMelodyRNN
    pth = str(tmp_path / "ev.pth")
    torch.save(EventMelodyRNN(event_dim=308, hidden_dim=16, num_layers=1,
                              device="cpu").state_dict(), pth)
    with pytest.raises(SystemExit, match="--tp applies to "
                                         "model=music_transformer"):
        tgen.main([pth, str(tmp_path / "e.mid"), "--steps", "4", "--tp",
                   "2", "--device", "cpu"])


def _tp_run(tmp, run, steps, *extra):
    port = _free_port()
    return _run_ranks(
        2, lambda r: [sys.executable, "-m",
                      "musicgeneration_tpu_torch.cli.train",
                      *_args(tmp, run, steps, *TP_ARGS, *extra)],
        lambda r: dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port)))


TP_ARGS = ("model.d_model=128", "accum_steps=2")


def test_cli_train_tp2_gloo_resumes_across_layouts(corpus):
    """cli.train tp=2 on two gloo ranks: the one-process losses; its step
    files resume in one process (tp 1) and again under tp=2; cli.generate
    reads the directory, with and without --tp."""
    tmp, _ = corpus
    assert tcli.main(_args(tmp, "tp_single", 5, *TP_ARGS)) == 0
    with open(tmp / "tp_single.jsonl") as f:
        single = _losses(map(json.loads, f))

    def check(outs, steps):
        per_rank = [_losses(_json_lines(o)) for o in outs]
        assert sorted(per_rank[0]) == steps and per_rank[1] == per_rank[0]
        for s, loss in per_rank[0].items():
            assert loss == pytest.approx(single[s], rel=1e-5), s

    check(_tp_run(tmp, "tp", 2, "tp=2"), [0, 1])
    out = tmp / "tp.one.jsonl"
    assert tcli.main(_args(tmp, "tp", 4, *TP_ARGS,
                           f"metrics_path={out}")) == 0
    with open(out) as f:
        resumed = _losses(map(json.loads, f))
    assert sorted(resumed) == [2, 3]
    for s, loss in resumed.items():
        assert loss == pytest.approx(single[s], rel=1e-5), s
    check(_tp_run(tmp, "tp", 5, "tp=2"), [4])
    for extra in ([], ["--tp", "2"]):
        mid = tmp / f"tp{len(extra)}.mid"
        assert tgen.main([str(tmp / "tp"), str(mid), "--steps", "8",
                          "--temperature", "0", "--device", "cpu",
                          *extra]) == 0
    assert (tmp / "tp0.mid").read_bytes() == (tmp / "tp2.mid").read_bytes()
