"""The RNN families' training in the port (cli/train.py, models/,
train/) against the JAX package on the CPU.

* The batch streams (segment, window, sequence, control, and melody's
  crops) equal the JAX CLI's ``_*_batch_fn`` bit for bit, at batch
  indices 0-5 and past epoch boundaries.
* Loss and every gradient against ``jax.value_and_grad`` of the JAX
  CLI's objective (its ``build_session`` at dropout 0; the latent the JAX
  step draws from its key passed to the port): EventMelodyRNN crop and
  sequence, PerformanceRNN with controls, MelodyRNN at ``attn_length`` 0
  and 40, and window-mode scheduled sampling. f32; loss 1e-5 relative,
  each gradient 1e-4 of its largest entry. The CLI's ``loss_fn`` equals
  the objective at the latent (and draws) its generator gives first.
* ``scheduled_sampling_logits`` with fixed draws against JAX's (1e-5);
  with every draw set it is the teacher-forced forward.
* One Adam step of each family against the JAX train step: loss, grad
  norm and accuracy 1e-5 relative, first moments as test_torch_train.py,
  parameters 2 * lr + 1e-6 absolute (with eps 1e-9 an element whose
  gradient is near zero moves by about +-lr)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli import train as jcli
from musicgeneration_tpu.models.event_rnn import (
    scheduled_sampling_logits as j_scheduled)
from musicgeneration_tpu.train import objective as jobj
from musicgeneration_tpu.train import trainer as jtr
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.data.pipeline import TokenCorpus
from musicgeneration_tpu_torch.models.event_rnn import (
    scheduled_sampling_logits)
from musicgeneration_tpu_torch.tokenizers import midilike
from musicgeneration_tpu_torch.train import trainer as ttr

SMALL = {"hidden_dim": 16, "num_layers": 2, "dropout_rate": 0.0}
GRU_SMALL = {**SMALL, "init_dim": 4}
TO_SD = {"event_rnn": convert.event_rnn_state_dict_from_jax,
         "performance_rnn": convert.performance_rnn_state_dict_from_jax,
         "melody_rnn": convert.melody_rnn_state_dict_from_jax}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Eight synthetic MIDI files of 160-440 MIDI-like events, tokenized
    as ``midilike``, ``midilike_control`` and ``melody``."""
    tmp = tmp_path_factory.mktemp("rnn_train")
    os.makedirs(tmp / "midis")
    rng = np.random.default_rng(0)
    for i in range(8):
        midilike.write_midi(midilike.EventSeq.from_array(
            rng.integers(0, 308, 160 + 40 * i)), str(tmp / "midis" /
                                                     f"f{i}.mid"))
    out = {}
    for scheme in ("midilike", "midilike_control", "melody"):
        assert ttok.main([str(tmp / "midis"), str(tmp / scheme), "--scheme",
                          scheme, "--workers", "1"]) == 0
        out[scheme] = TokenCorpus(str(tmp / scheme))
    return out


def _same(got, ref):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _same(got[k], ref[k])
    elif isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for a, b in zip(got, ref):
            _same(a, b)
    else:
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


STREAMS = {
    "segment": ("_segment_batch_fn", "midilike",
                dict(model="event_rnn", train_mode="segment", seq_len=64,
                     batch_size=3)),
    "window": ("_window_batch_fn", "midilike",
               dict(model="event_rnn", train_mode="window", window_size=40,
                    stride_size=20, batch_size=3)),
    "sequence": ("_sequence_batch_fn", "midilike",
                 dict(model="event_rnn", train_mode="sequence", batch_size=3,
                      seq_pad_to=600)),
    "control": ("_control_batch_fn", "midilike_control",
                dict(model="performance_rnn", seq_len=48, batch_size=2)),
    "melody_crop": ("_lm_batch_fn", "melody",
                    dict(model="melody_rnn", seq_len=16, batch_size=4)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_batch_stream_equals_jax(corpora, name):
    fn, scheme, kw = STREAMS[name]
    kw = dict(kw, seed=7)
    ours = getattr(tcli, fn)(corpora[scheme], tcli.TrainCLIConfig(**kw))
    theirs = getattr(jcli, fn)(corpora[scheme], jcli.TrainCLIConfig(**kw))
    # 0-5, then past the epoch boundaries of every epoch-indexed stream
    # (sequence: 2 batches an epoch; segment and window: under 40)
    for idx in list(range(6)) + [39, 40, 41, 97]:
        got, ref = ours(idx), theirs(idx)
        if name == "control":    # the port hands the trainer a dict
            x, y = got
            _same((x["tokens"], x["controls"]), ref)
            _same(y, ref[0])
        else:
            _same(got, ref)


def _sessions(family, scheme, kw, corpora, jax_extra=None):
    """The JAX CLI's session and the port's ``build_model`` on the same
    weights (JAX's ``_init_state``, every leaf perturbed), and one
    batch of the port's stream."""
    kw = dict(kw, seed=3)
    mk = {**(GRU_SMALL if family != "melody_rnn" else SMALL),
          **(jax_extra or {})}
    jcfg = jcli.TrainCLIConfig(model=family, **kw)
    jm, jtcfg, apply_fn, loss_fn, adapter = jcli.build_session(
        jcfg, scheme, mk)
    tcfg_cli = tcli.TrainCLIConfig(model=family, **kw)
    batch = tcli._batch_fn(corpora[scheme], tcfg_cli, scheme)(0)
    # the JAX control stream hands (tokens, controls) to its adapter
    jbatch = (jcli._control_batch_fn(corpora[scheme], jcfg)(0)
              if scheme == "midilike_control" else batch)
    jx, jy = adapter(jbatch)
    state = jcli._init_state(jm, jtcfg, jax.random.PRNGKey(jcfg.seed),
                             (jx, jy), jcfg)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), state.params)
    state = state.replace(params=params)
    tm, ttcfg, t_loss = tcli.build_model(tcfg_cli, scheme, mk, "cpu")
    tm.load_state_dict(TO_SD[family](params))
    return dict(jm=jm, jtcfg=jtcfg, apply_fn=apply_fn, loss_fn=loss_fn,
                jx=jx, jy=jy, state=state, tm=tm, ttcfg=ttcfg,
                t_loss=t_loss, batch=batch)


def _j_objective(s):
    """The JAX train step's loss (its ``make_train_step`` default, or the
    session's own ``loss_fn``)."""
    if s["loss_fn"] is not None:
        return s["loss_fn"]
    cfg = s["jtcfg"]

    def loss(params, x, y, rng):
        logits = s["apply_fn"](params, x, rng)
        return (jobj.smooth_cross_entropy(logits, y, cfg.vocab_size,
                                          cfg.label_smoothing, cfg.pad_id),
                jobj.token_accuracy(logits, y, cfg.pad_id))
    return loss


def _step_key(s):
    """The key the JAX step hands its loss at step 0: the folded key
    expanded to the trainer's ``dropout_rng_impl`` (trainer.py:119-128)."""
    data = jax.random.fold_in(s["state"].dropout_rng, 0)
    impl = s["jtcfg"].dropout_rng_impl
    if impl in ("threefry2x32", None):
        return data
    return jax.random.wrap_key_data(jnp.concatenate([data, data]),
                                    impl=impl)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_draws(family, mode, s, key):
    """(objective closure on fixed random inputs, latent, draws): the
    latent and draws the JAX loss takes from ``key``."""
    from musicgeneration_tpu_torch.cli.train import (
        gru_objective, scheduled_objective, sequence_objective)
    tm = s["tm"]
    if family == "melody_rnn":
        return (lambda: s["t_loss"](tm, _t(s["jx"]), _t(s["jy"]), None),
                None, None)
    if mode == "window":
        init_rng, tf_rng, _ = jax.random.split(key, 3)
        draws = np.asarray(jax.random.bernoulli(
            tf_rng, 0.5, (s["jx"].shape[1] - 1,)))
    else:
        init_rng, _ = jax.random.split(key)
        draws = None
    b = (s["jx"]["tokens"] if isinstance(s["jx"], dict) else s["jx"]).shape[0]
    init = _t(jax.random.normal(init_rng, (b, tm.init_dim)))
    if mode == "window":
        return (lambda: scheduled_objective(tm, _t(s["jx"]), init,
                                            _t(draws)), init, draws)
    if mode == "sequence":
        return (lambda: sequence_objective(
            tm, _t(s["jx"]["tokens"]), _t(s["jx"]["lengths"]), init),
            init, None)
    if isinstance(s["jx"], dict):
        return (lambda: gru_objective(tm, _t(s["jx"]["tokens"]), init,
                                      _t(s["jx"]["controls"])), init, None)
    return lambda: gru_objective(tm, _t(s["jx"]), init), init, None


CASES = {
    "event_crop": ("event_rnn", "midilike", dict(seq_len=24, batch_size=3),
                   None),
    "event_sequence": ("event_rnn", "midilike",
                       dict(train_mode="sequence", batch_size=3), None),
    "event_window_scheduled": ("event_rnn", "midilike",
                               dict(train_mode="window", window_size=20,
                                    stride_size=10, batch_size=3,
                                    teacher_forcing_ratio=0.5), None),
    "performance_control": ("performance_rnn", "midilike_control",
                            dict(seq_len=20, batch_size=2), None),
    "melody_basic": ("melody_rnn", "melody", dict(seq_len=24, batch_size=3),
                     {"attn_length": 0}),
    "melody_attn40": ("melody_rnn", "melody", dict(seq_len=48, batch_size=3),
                      {"attn_length": 40}),
}


def _grads_close(tm, j_grads, family):
    ref = TO_SD[family](jax.tree.map(np.asarray, j_grads))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        scale = float(r.abs().max())
        err = float((got[k] - r).abs().max())
        assert err <= 1e-4 * max(scale, 1e-6), (k, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(corpora, case):
    family, scheme, kw, extra = CASES[case]
    s = _sessions(family, scheme, kw, corpora, extra)
    key = _step_key(s)
    (j_loss, j_acc), j_grads = jax.value_and_grad(
        _j_objective(s), has_aux=True)(s["state"].params, s["jx"], s["jy"],
                                       key)
    run, init, draws = _port_draws(family, kw.get("train_mode"), s, key)
    tm = s["tm"]
    tm.zero_grad()
    loss, acc = run()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    assert float(acc) == pytest.approx(float(j_acc), rel=1e-5, abs=1e-7)
    _grads_close(tm, j_grads, family)
    # the trainer config the JAX session builds
    jt, tt = s["jtcfg"], s["ttcfg"]
    assert (tt.vocab_size, tt.pad_id, tt.label_smoothing, tt.peak_lr) == (
        jt.vocab_size, jt.pad_id, jt.label_smoothing, jt.peak_lr)
    # the CLI's loss_fn draws the latent first, then the step draws
    if init is not None:
        gen = torch.Generator().manual_seed(9)
        with torch.no_grad():
            cli_loss, _ = s["t_loss"](tm, *_t_batch(s["batch"]), gen)
            g2 = torch.Generator().manual_seed(9)
            init2 = torch.randn(init.shape, generator=g2)
            x = _t_batch(s["batch"])[0]
            if draws is not None:
                d2 = torch.rand(len(draws), generator=g2) < 0.5
                ref = tcli.scheduled_objective(tm, x, init2, d2)[0]
            elif isinstance(x, dict) and "lengths" in x:
                ref = tcli.sequence_objective(tm, x["tokens"], x["lengths"],
                                              init2)[0]
            elif isinstance(x, dict):
                ref = tcli.gru_objective(tm, x["tokens"], init2,
                                         x["controls"])[0]
            else:
                ref = tcli.gru_objective(tm, x, init2)[0]
        assert float(cli_loss) == float(ref)


def _t_batch(batch):
    x, y = batch
    conv = (lambda v: {k: _t(a) for k, a in v.items()}
            if isinstance(v, dict) else _t(v))
    return conv(x), conv(y)


@pytest.mark.parametrize("family", ["event_rnn", "performance_rnn"])
def test_scheduled_sampling_logits_match_jax(family, corpora):
    s = _sessions(family, "midilike",
                  dict(train_mode="window", window_size=20, stride_size=10,
                       batch_size=3), corpora)
    x = s["batch"][0]
    rng = np.random.default_rng(4)
    draws = rng.random(x.shape[1] - 1) < 0.5
    init = rng.standard_normal((3, 4)).astype(np.float32)
    ref = j_scheduled(s["jm"], s["state"].params, jnp.asarray(init),
                      jnp.asarray(x.T), jnp.asarray(draws))
    with torch.no_grad():
        got = scheduled_sampling_logits(s["tm"], _t(init), _t(x.T),
                                        _t(draws))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)
        # every draw set: the teacher-forced forward
        full = scheduled_sampling_logits(s["tm"], _t(init), _t(x.T),
                                         np.ones(x.shape[1] - 1, bool))
        tf = s["tm"](_t(init), _t(x.T))
        if family == "event_rnn":
            tf = tf[:-1]
        np.testing.assert_allclose(full.numpy(), tf.numpy(), atol=1e-6,
                                   rtol=0)
        # no draw set: greedy feedback, which differs
        none = scheduled_sampling_logits(s["tm"], _t(init), _t(x.T),
                                         np.zeros(x.shape[1] - 1, bool))
        assert not torch.allclose(none, full)


@pytest.mark.parametrize("case", ["event_crop", "performance_control",
                                  "melody_attn40"])
def test_one_adam_step_matches_jax(corpora, case):
    family, scheme, kw, extra = CASES[case]
    s = _sessions(family, scheme, kw, corpora, extra)
    jtx = jtr.make_optimizer(s["jtcfg"])
    jstate = s["state"].replace(opt_state=jtx.init(s["state"].params))
    jstep = jtr.make_train_step(s["jm"], jtx, s["jtcfg"],
                                apply_fn=s["apply_fn"],
                                loss_fn=s["loss_fn"])
    jstate, jmet = jstep(jstate, s["jx"], s["jy"])
    run, _, _ = _port_draws(family, kw.get("train_mode"), s,
                            _step_key(s))
    ttx = ttr.make_optimizer(s["ttcfg"])
    tstate = ttr.create_train_state(s["tm"].requires_grad_(True), ttx,
                                    dropout_seed=0)
    tstep = ttr.make_train_step(ttx, s["ttcfg"],
                                loss_fn=lambda model, x, y, gen: run())
    x, y = _t_batch(s["batch"])
    lr = ttx.lr(0)
    assert lr == pytest.approx(1e-3)
    tstate, tmet = tstep(tstate, x, y)
    for k in ("loss", "accuracy", "grad_norm"):
        assert tmet[k] == pytest.approx(float(jmet[k]), rel=1e-5,
                                        abs=1e-7), k
    names = [n for n, _ in tstate.model.named_parameters()]
    mu = TO_SD[family](jax.tree.map(np.asarray, jstate.opt_state[1][0].mu))
    floor = 1e-6 * max(float(r.abs().max()) for r in mu.values())
    for name, m in zip(names, tstate.opt_state.mu):
        r = mu[name].numpy()
        np.testing.assert_allclose(m.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(r).max()) + floor,
                                   err_msg=name)
    ref = TO_SD[family](jax.tree.map(np.asarray, jstate.params))
    for name, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=2 * lr + 1e-6, err_msg=name)
