"""The port's training slice on the CPU against the JAX package.

Objective and schedule values against ``musicgeneration_tpu.train``; one
train step (and one ``accum_steps=2`` step) of the port's plain path
against the JAX ``make_train_step`` on the same weights (carried across
by ``convert.state_dict_from_jax``, which also maps optax's Adam moment
trees), at dropout 0; the non-finite-loss skip; dropout statistics; and
the port's ``cli.train`` -> interrupt -> resume -> ``cli.generate`` on
``--device cpu``.

Tolerances (f32): loss, accuracy and grad norm 1e-5 relative; Adam
moments 1e-4 of each tensor's largest entry plus 1e-6 of the largest
over all tensors (the K-projection bias has a zero gradient in exact
arithmetic, since softmax ignores a per-row constant, so both sides hold
only rounding noise there); parameters 2 * lr + 1e-6 absolute, since with
eps 1e-9 an element whose gradient is near zero moves by about +-lr
whatever its size."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.train import objective as jobj
from musicgeneration_tpu.train import schedule as jsched
from musicgeneration_tpu.train import trainer as jtr
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.models.music_transformer import dropout
from musicgeneration_tpu_torch.tokenizers import midilike
from musicgeneration_tpu_torch.train import loop as tloop
from musicgeneration_tpu_torch.train import objective as tobj
from musicgeneration_tpu_torch.train import schedule as tsched
from musicgeneration_tpu_torch.train import trainer as ttr
from musicgeneration_tpu_torch.utils.checkpoint import (
    Checkpointer, list_checkpoints, restore_checkpoint)

V, SEQ, D = 64, 32, 128


@pytest.mark.parametrize("ignore", [None, V - 1])
def test_smooth_cross_entropy_and_accuracy(ignore):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 7, V))).astype(np.float32)
    targets = rng.integers(0, V, (3, 7)).astype(np.int32)
    targets[0, :3] = V - 1          # pad targets
    targets[1, 2] = V + 3           # out of range: no one-hot term
    targets[2, 4] = -1
    targets[2, 5] = int(logits[2, 5].argmax())  # at least one hit
    for ls in (0.0, 0.1):
        ref = jobj.smooth_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(targets), V, ls, ignore)
        got = tobj.smooth_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(targets), V, ls,
                                        ignore)
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    acc_ref = jobj.token_accuracy(jnp.asarray(logits), jnp.asarray(targets),
                                  ignore)
    acc = tobj.CategoricalAccuracy(ignore)(torch.from_numpy(logits),
                                           torch.from_numpy(targets))
    assert acc.item() == pytest.approx(float(acc_ref), rel=1e-6)
    ms = tobj.MetricsSet({"acc": tobj.CategoricalAccuracy(ignore)})
    assert ms(torch.from_numpy(logits), torch.from_numpy(targets))["acc"] \
        == acc
    np.testing.assert_array_equal(
        tobj.logits_bucketting(torch.from_numpy(logits)).numpy(),
        np.asarray(jobj.logits_bucketting(jnp.asarray(logits))))


@pytest.mark.parametrize("d_model,warmup", [(256, 4000), (128, 10)])
def test_noam_schedule(d_model, warmup):
    steps = np.array([0, 1, 2, 9, 10, 11, 100, 3999, 4000, 100000])
    ref = np.asarray(jsched.noam_schedule(d_model, warmup)(
        jnp.asarray(steps)))
    got = tsched.noam_schedule(d_model, warmup)(steps)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _pair(accum, seed=0):
    """The JAX train state and step, and the port's, on the same
    weights; dropout 0, crops without pad (pad_in_input=False)."""
    jm = JMusicTransformer(vocab_size=V, num_layers=2, d_model=D,
                           max_seq=SEQ, dropout_rate=0.0, pad_in_input=False)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)
    kw = dict(vocab_size=V, pad_id=V - 1, d_model=D, warmup_steps=10,
              accum_steps=accum)
    jcfg = jtr.TrainerConfig(**kw)
    jtx = jtr.make_optimizer(jcfg)
    jstate = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=jtx.init(params),
                            dropout_rng=jax.random.PRNGKey(1))
    jstep = jax.jit(jtr.make_train_step(jm, jtx, jcfg))

    tm = MusicTransformer(vocab_size=V, num_layers=2, d_model=D, max_seq=SEQ,
                          dropout_rate=0.0, pad_in_input=False, device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(params))
    tcfg = ttr.TrainerConfig(**kw)
    ttx = ttr.make_optimizer(tcfg)
    tstate = ttr.create_train_state(tm, ttx, dropout_seed=1)
    tstep = ttr.make_train_step(ttx, tcfg)
    return (jstate, jstep), (tstate, tstep, ttx)


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V - 1, (b, SEQ)).astype(np.int32)
    y = rng.integers(0, V - 1, (b, SEQ)).astype(np.int32)
    y[0, -2:] = V - 1  # ignored targets
    return x, y


def _close_tree(port_list, jax_tree, names, what):
    ref = convert.state_dict_from_jax(jax.tree.map(np.asarray, jax_tree))
    floor = 1e-6 * max(float(r.abs().max()) for r in ref.values())
    for name, t in zip(names, port_list):
        r = ref[name].numpy()
        atol = 1e-4 * float(np.abs(r).max()) + floor
        np.testing.assert_allclose(t.detach().numpy(), r, rtol=1e-4,
                                   atol=atol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("accum,steps", [(1, 2), (2, 1)])
def test_train_step_matches_jax(accum, steps):
    (jstate, jstep), (tstate, tstep, ttx) = _pair(accum)
    names = [n for n, _ in tstate.model.named_parameters()]
    for s in range(steps):
        x, y = _batch(4, seed=10 + s)
        lr = ttx.lr(tstate.opt_state.count)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tm = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        for k in ("loss", "accuracy", "grad_norm"):
            assert tm[k] == pytest.approx(float(jm[k]), rel=1e-5), k
        adam = jstate.opt_state[1][0]
        assert tstate.opt_state.count == int(adam.count) == s + 1
        assert tstate.step == int(jstate.step) == s + 1
        _close_tree(tstate.opt_state.mu, adam.mu, names, "mu")
        _close_tree(tstate.opt_state.nu, adam.nu, names, "nu")
        ref = convert.state_dict_from_jax(
            jax.tree.map(np.asarray, jstate.params))
        for name, p in tstate.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       rtol=0, atol=2 * lr + 1e-6,
                                       err_msg=name)
        # the next step starts from the same parameters again (the +-lr
        # sign noise above would otherwise move its gradients)
        tstate.model.load_state_dict(ref)
    assert tm["grad_norm"] > 1.0  # the clip was active


def test_nonfinite_loss_skips_update_and_schedule():
    _, (state, _, tx) = _pair(1)
    poisoned = [True]

    def loss_fn(model, x, y, gen):
        logits = model(x, deterministic=False, generator=gen)
        loss = tobj.smooth_cross_entropy(logits, y, V, 0.1, V - 1)
        if poisoned[0]:
            loss = loss * float("nan")
        return loss, tobj.token_accuracy(logits, y, V - 1)

    step = tloop._guarded(ttr.make_train_step(tx, tx.cfg, loss_fn))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    x, y = (torch.from_numpy(a) for a in _batch(4, seed=3))
    state, m = step(state, x, y)
    assert m["skipped"] == 1 and not np.isfinite(m["loss"])
    assert state.step == 1 and state.opt_state.count == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(not t.any() for t in state.opt_state.mu + state.opt_state.nu)
    poisoned[0] = False
    state, m = step(state, x, y)
    assert m["skipped"] == 0 and np.isfinite(m["loss"])
    assert state.step == 2 and state.opt_state.count == 1
    moved = [not torch.equal(v, before[k])
             for k, v in state.model.state_dict().items()]
    assert all(moved)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keep_rate(dtype):
    n, rate = 200_000, 0.1
    x = torch.ones(n, dtype=dtype)
    y = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = (y != 0)
    frac = kept.float().mean().item()
    assert abs(frac - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / n)
    assert y.dtype == dtype
    assert torch.all(y[kept] == (torch.ones(1, dtype=dtype) / (1 - rate)))
    y2 = dropout(x, rate, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)


def test_model_dropout_and_remat():
    """Dropout draws from the generator only in training mode; remat
    (torch.utils.checkpoint per layer) recomputes with the same masks."""
    def build(**kw):  # one set of weights for every model
        return MusicTransformer(vocab_size=V, num_layers=2, d_model=D,
                                max_seq=SEQ, device="cpu",
                                generator=torch.Generator().manual_seed(4),
                                **kw)

    m = build(dropout_rate=0.1)
    mr = build(dropout_rate=0.1, remat=True)
    x = torch.from_numpy(_batch(2, seed=5)[0])
    det = m(x)
    assert torch.equal(det, build(dropout_rate=0.0)(
        x, deterministic=False, generator=torch.Generator()))
    a = m(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    b = m(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    c = m(x, deterministic=False, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, det)
    grads = []
    for model in (m, mr):
        out = model(x, deterministic=False,
                    generator=torch.Generator().manual_seed(7))
        grads.append(torch.autograd.grad(out.square().mean(),
                                         list(model.parameters())))
    for g, gr in zip(*grads):
        torch.testing.assert_close(gr, g, rtol=1e-5, atol=1e-6)


def test_checkpointer_keep_and_meta(tmp_path):
    _, (state, _, _) = _pair(1)
    ck = Checkpointer(str(tmp_path), every=2, keep=2, config={"a": 1})
    for step in range(6):
        ck.maybe_save(step, state)
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [3, 5]
    ck.write_meta(data_cursor=6, data_seed=3)
    assert ck.read_meta() == {"data_cursor": 6, "data_seed": 3}
    payload = restore_checkpoint(str(tmp_path))
    assert payload["step"] == 5 and payload["config"] == {"a": 1}
    assert set(payload["opt"]["mu"]) == set(payload["model"])
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpus")
    os.makedirs(tmp / "midis")
    for i in range(3):
        toks = np.random.default_rng(i).integers(0, 308, 600)
        midilike.write_midi(midilike.EventSeq.from_array(toks),
                            str(tmp / "midis" / f"f{i}.mid"))
    assert ttok.main([str(tmp / "midis"), str(tmp / "tok"), "--workers",
                      "1"]) == 0
    return tmp


def _train(tmp, run, steps=6, extra=()):
    return tcli.main([str(tmp / "tok"), f"steps={steps}", "batch_size=2",
                      f"seq_len={SEQ}", "model.num_layers=1",
                      "model.d_model=64", f"ckpt_dir={tmp / run}",
                      "ckpt_every=2", "log_every=1",
                      f"metrics_path={tmp / (run + '.jsonl')}", *extra,
                      "--device", "cpu"])


def _losses(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if r["kind"] == "train"}


def test_cli_train_interrupt_resume_generate(corpus_dir, monkeypatch,
                                             capsys):
    tmp = corpus_dir
    assert _train(tmp, "full") == 0
    full = _losses(tmp / "full.jsonl")
    assert sorted(full) == list(range(6))
    assert all(np.isfinite(v) for v in full.values())

    requested = []
    real_fn = tcli._lm_batch_fn

    def recording(interrupt_at):
        def fn(corpus, cfg):
            batch_at = real_fn(corpus, cfg)

            def at(idx):
                requested.append(idx)
                if idx == interrupt_at:
                    raise KeyboardInterrupt
                return batch_at(idx)
            return at
        return fn

    monkeypatch.setattr(tcli, "_lm_batch_fn", recording(3))
    assert _train(tmp, "cut") == 0
    assert [s for s, _ in list_checkpoints(str(tmp / "cut"))] == [1, 2]
    with open(tmp / "cut" / "meta.json") as f:
        assert json.load(f)["data_cursor"] == 3
    requested.clear()
    monkeypatch.setattr(tcli, "_lm_batch_fn", recording(-1))
    assert _train(tmp, "cut") == 0
    assert min(requested) == 3  # the resumed stream starts at the cursor
    cut = _losses(tmp / "cut.jsonl")
    assert sorted(cut) == list(range(6))
    assert cut == full  # same batches, dropout masks and updates
    a = restore_checkpoint(str(tmp / "full"))
    b = restore_checkpoint(str(tmp / "cut"))
    assert a["step"] == b["step"] == 5
    assert a["opt"]["count"] == b["opt"]["count"] == 6
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k

    capsys.readouterr()
    assert _train(tmp, "cut", extra=("seed=7",)) == 0
    assert "WARNING: resuming with seed=7" in capsys.readouterr().out

    out = tmp / "gen.mid"
    assert tgen.main([str(tmp / "cut"), str(out), "--steps", "8",
                      "--temperature", "0", "--device", "cpu"]) == 0
    assert out.exists()
    model = convert.load_checkpoint(str(tmp / "cut"), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, b["model"][k]), k
