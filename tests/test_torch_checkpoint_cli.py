"""The port's ``cli.export_checkpoint`` and ``cli.import_checkpoint``,
round-tripped against the JAX CLIs on the CPU (the seed's own tests of
these CLIs hold them against the reference implementation, which is not
in this repository).

For each family the JAX package exports (MusicTransformer,
EventMelodyRNN, PerformanceRNN, PoPMAG):

* JAX -> port: a JAX run (the step file and config the JAX
  ``cli.import_checkpoint`` writes, on seeded perturbed weights) exported
  by the JAX ``cli.export_checkpoint`` and imported by the port's: the
  config equals the one the JAX import infers from the same ``.pth``; the
  port's forward logits equal the JAX forward's on the JAX run's
  weights (1e-5 absolute and relative, f32); greedy ``cli.generate``
  writes the same MIDI bytes as the JAX ``cli.generate`` on the JAX run
  (PerformanceRNN with ``--init-zero``; PoPMAG draws its latent from
  each framework's own generator, so its imported run is held against the
  exported ``.pth`` it came from in the port's CLI);
* port -> JAX: a port ``cli.train``-format step file exported by the
  port and imported by the JAX CLI: the JAX forward's logits equal the
  port's (same tolerance), and the JAX CLI exports the imported run to a
  ``.pth`` whose tensors and wrapping equal the port's export.

Then the formats and families detected, the hyperparameters inferred,
``--scheme`` required where the vocabulary is ambiguous, the export
refusals, and neither ``cli.train`` resuming from an imported run."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli import export_checkpoint as jexport
from musicgeneration_tpu.cli import generate as jgen
from musicgeneration_tpu.cli import import_checkpoint as jimport
from musicgeneration_tpu.cli.train import TrainCLIConfig as JTrainCLIConfig
from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.models.event_rnn import EventMelodyRNN as JEventRNN
from musicgeneration_tpu.models.performance_rnn import (
    PerformanceRNN as JPerformanceRNN)
from musicgeneration_tpu.models.popmag import PoPMAGRNN as JPoPMAG
from musicgeneration_tpu.train import trainer as jtr
from musicgeneration_tpu.utils import checkpoint as jck
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import export_checkpoint as texport
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import import_checkpoint as timport
from musicgeneration_tpu_torch.cli.train import TrainCLIConfig
from musicgeneration_tpu_torch.models import (CPTransformer, EventMelodyRNN,
                                              MelodyRNN, MusicTransformer,
                                              PerformanceRNN, PoPMAGRNN)
from musicgeneration_tpu_torch.train import trainer as ttr
from musicgeneration_tpu_torch.utils import checkpoint as tck
from tests import fixtures

TOL = 1e-5
FAMILIES = ("music_transformer", "event_rnn", "performance_rnn", "popmag")
B, T, BARS, S = 2, 12, 2, 6
SCHEMES = {"music_transformer": "midilike", "event_rnn": "midilike",
           "performance_rnn": "midilike_control", "popmag": "mumidi"}


def _inputs(family, seed=0):
    """Seeded inputs of each family's training forward."""
    rng = np.random.default_rng(seed)
    if family == "music_transformer":
        return (rng.integers(0, 308, (B, T)).astype(np.int32),)
    init = rng.standard_normal((B, 8)).astype(np.float32)
    if family == "popmag":
        src = rng.integers(0, 485, (B, BARS, S, 7)).astype(np.int32)
        tar = rng.integers(0, 485, (B, BARS, S, 7)).astype(np.int32)
        lens = rng.integers(1, S + 1, (2, B, BARS)).astype(np.int32)
        init = rng.standard_normal((B, 32)).astype(np.float32)
        return init, src, lens[0], tar, lens[1]
    events = rng.integers(0, 308, (T, B)).astype(np.int32)
    if family == "performance_rnn":
        return init, events, rng.uniform(size=(T, B, 24)).astype(np.float32)
    return init, events


def _jax_model(family, kwargs):
    cls = {"music_transformer": JMusicTransformer, "event_rnn": JEventRNN,
           "performance_rnn": JPerformanceRNN, "popmag": JPoPMAG}[family]
    return cls(dropout_rate=0.0, **kwargs)


JAX_KWARGS = {
    "music_transformer": dict(vocab_size=309, num_layers=1, d_model=64,
                              max_seq=128),
    "event_rnn": dict(event_dim=308, init_dim=8, hidden_dim=32,
                      num_layers=2),
    "performance_rnn": dict(event_dim=308, control_dim=24, init_dim=8,
                            hidden_dim=32, num_layers=2),
    "popmag": dict(event_dim=485, bar_dim=188, init_dim=32, embed_dim=32,
                   hidden_dim=32, num_layers=2),
}


def _jax_logits(family, kwargs, params):
    jm = _jax_model(family, kwargs)
    return np.asarray(jm.apply({"params": params},
                               *map(jnp.asarray, _inputs(family))))


def _port_logits(model):
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in _inputs(
            model.family))).numpy()


@pytest.fixture(scope="module", params=FAMILIES)
def jax_run(request, tmp_path_factory):
    """A JAX run of ``family``: seeded perturbed weights in the step file
    and config the JAX ``cli.import_checkpoint`` writes."""
    family = request.param
    tmp = tmp_path_factory.mktemp(family)
    kwargs = JAX_KWARGS[family]
    jm = _jax_model(family, kwargs)
    params = jm.init(jax.random.PRNGKey(0),
                     *map(jnp.asarray, _inputs(family)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)
    cli = JTrainCLIConfig(model=family)
    if family == "music_transformer":
        cli.seq_len = kwargs["max_seq"]
    config = {"cli": cli.to_dict(), "scheme": SCHEMES[family],
              "model_kwargs": kwargs}
    jck.save_checkpoint(str(tmp / "jax_run"), 7, {"params": params},
                        config=config)
    return family, tmp, kwargs, params


def test_jax_export_port_import(jax_run, capsys):
    family, tmp, kwargs, params = jax_run
    pth = str(tmp / "jax.pth")
    jexport.export_torch_checkpoint(str(tmp / "jax_run"), pth)
    assert timport.main([pth, str(tmp / "port_run")]) == 0
    assert f"imported {family} ({SCHEMES[family]})" in capsys.readouterr().out
    payload = tck.restore_checkpoint(str(tmp / "port_run"))
    step = 7 if family == "music_transformer" else 0  # only 'net' has epoch
    assert payload["step"] == step and "opt" not in payload
    ref = jimport.import_torch_checkpoint(pth, str(tmp / "jax_reimport"))
    cfg = payload["config"]
    assert cfg["scheme"] == ref["scheme"]
    assert cfg["model_kwargs"] == ref["model_kwargs"]
    assert cfg["imported_from"] == pth
    for key in ("model", "seq_len"):
        assert cfg["cli"][key] == ref["cli"][key], key

    model, rec = convert.load_checkpoint(str(tmp / "port_run"),
                                         device="cpu", with_config=True)
    assert model.family == family and rec["scheme"] == SCHEMES[family]
    np.testing.assert_allclose(_port_logits(model),
                               _jax_logits(family, kwargs, params),
                               rtol=TOL, atol=TOL)

    out_t, out_j = str(tmp / "port.mid"), str(tmp / "jax.mid")
    argv = ["--steps", "16", "--temperature", "0"]
    if family == "performance_rnn":
        argv.append("--init-zero")
    if family == "popmag":
        prime = str(tmp / "melody.mid")
        fixtures.multitrack_midi(prime, n_bars=2)
        argv = ["--prime", prime, "--temperature", "0"]
        assert tgen.main([pth, out_j, *argv, "--device", "cpu"]) == 0
    else:
        assert jgen.main([str(tmp / "jax_run"), out_j, *argv]) == 0
    assert tgen.main([str(tmp / "port_run"), out_t, *argv,
                      "--device", "cpu"]) == 0
    with open(out_t, "rb") as f, open(out_j, "rb") as g:
        assert f.read() == g.read()


def _port_run(family, tmp, seed=3):
    """A port ``cli.train``-format run of ``family`` on seeded random
    weights (the step file a cli.train run writes, Adam state included)."""
    gen = torch.Generator().manual_seed(seed)
    kwargs = dict(JAX_KWARGS[family])
    if family == "music_transformer":
        model = MusicTransformer(device="cpu", generator=gen, **kwargs)
    else:
        cls = {"event_rnn": EventMelodyRNN, "performance_rnn": PerformanceRNN,
               "popmag": PoPMAGRNN}[family]
        model = cls(device="cpu", generator=gen, **kwargs)
    with torch.no_grad():  # move the zero biases off zero
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    tx = ttr.make_optimizer(ttr.TrainerConfig(vocab_size=0))
    state = ttr.create_train_state(model, tx, dropout_seed=0)
    config = {"cli": TrainCLIConfig(model=family).to_dict(),
              "scheme": SCHEMES[family],
              "model_kwargs": dict(kwargs, dropout_rate=0.2)}
    tck.save_checkpoint(str(tmp / "port_run"), 11, state, config=config)
    return model


@pytest.mark.parametrize("family", FAMILIES)
def test_port_export_jax_import(family, tmp_path, capsys):
    model = _port_run(family, tmp_path)
    pth = str(tmp_path / "port.pth")
    assert texport.main([str(tmp_path / "port_run"), pth]) == 0
    assert f"exported {family} step 11 -> {pth}" in capsys.readouterr().out
    obj = torch.load(pth, weights_only=True)
    if family == "music_transformer":
        assert set(obj) == {"net", "optimizer", "epoch"}
        assert obj["optimizer"] == {} and obj["epoch"] == 11
    elif family == "performance_rnn":
        assert obj["model_config"] == {
            "init_dim": 8, "event_dim": 308, "control_dim": 24,
            "hidden_dim": 32, "gru_layers": 2, "gru_dropout": 0.2}
        assert obj["model_optimizer_state"] == {}

    config = jimport.import_torch_checkpoint(pth, str(tmp_path / "jax_run"))
    jparams = jck.restore_checkpoint(str(tmp_path / "jax_run"))[
        "state"]["params"]
    np.testing.assert_allclose(
        _jax_logits(family, config["model_kwargs"], jparams),
        _port_logits(model.eval()), rtol=TOL, atol=TOL)
    # the JAX CLI exports the imported run as the port did
    again = str(tmp_path / "again.pth")
    jexport.export_torch_checkpoint(str(tmp_path / "jax_run"), again)
    ref = torch.load(again, weights_only=True)
    sd = obj.get("net", obj.get("model_state", obj))
    ref_sd = ref.get("net", ref.get("model_state", ref))
    assert sorted(sd) == sorted(ref_sd)
    for k, t in sd.items():
        assert t.dtype == torch.float32 and torch.equal(t, ref_sd[k]), k


def test_detect_format_and_family(tmp_path):
    sd = {"rnn.weight_ih_l0": torch.zeros(3, 2)}
    assert timport.detect_format({"net": sd, "epoch": 4}) == (sd, 4)
    assert timport.detect_format({"model_state": sd}) == (sd, 0)
    assert timport.detect_format(sd) == (sd, 0)
    with pytest.raises(SystemExit, match="unrecognized checkpoint layout"):
        timport.detect_format({"model": 3})
    assert timport.detect_family(sd) == "event_rnn"
    with pytest.raises(SystemExit, match="pass --model"):
        timport.detect_family({"lstm.weight_ih_l0": torch.zeros(1)})
    # the port's own families without a reference format are not detected
    mel = MelodyRNN(vocab_size=130, embed_size=8, hidden_dim=8, num_layers=1,
                    device="cpu").state_dict()
    with pytest.raises(SystemExit, match="cannot identify"):
        timport.detect_family(mel)


def test_import_infers_and_needs_scheme(tmp_path, capsys):
    m = MusicTransformer(vocab_size=64, num_layers=2, d_model=128,
                         max_seq=32, device="cpu")
    pth = str(tmp_path / "v64.pth")
    torch.save({"net": m.state_dict(), "optimizer": {}, "epoch": 2}, pth)
    with pytest.raises(SystemExit, match="vocab 64; pass --scheme"):
        timport.main([pth, str(tmp_path / "a")])
    assert timport.main([pth, str(tmp_path / "b"), "--scheme", "remi",
                         "--step", "9"]) == 0
    payload = tck.restore_checkpoint(str(tmp_path / "b" / "step-9.pt"))
    assert payload["config"]["model_kwargs"] == {
        "vocab_size": 64, "num_layers": 2, "d_model": 128, "max_seq": 32}
    assert payload["config"]["cli"]["seq_len"] == 32
    ref = jimport.import_torch_checkpoint(pth, str(tmp_path / "j"),
                                          scheme="remi", step=9)
    assert payload["config"]["model_kwargs"] == ref["model_kwargs"]
    with pytest.raises(SystemExit, match="unknown --model 'cp'"):
        timport.main([pth, str(tmp_path / "c"), "--model", "cp"])


def test_export_refusals(tmp_path):
    for family, model in (
            ("melody_rnn", MelodyRNN(vocab_size=130, embed_size=8,
                                     hidden_dim=8, num_layers=1,
                                     device="cpu")),
            ("cp_transformer", CPTransformer(num_layers=1, d_model=64,
                                             max_seq=16, device="cpu"))):
        state = ttr.create_train_state(
            model, ttr.make_optimizer(ttr.TrainerConfig(vocab_size=0)), 0)
        run = str(tmp_path / family)
        tck.save_checkpoint(run, 0, state, config={
            "cli": TrainCLIConfig(model=family).to_dict()})
        with pytest.raises(SystemExit, match=f"model '{family}' has no "
                           "reference torch format"):
            texport.main([run, str(tmp_path / "x.pth")])
    m = MusicTransformer(vocab_size=64, num_layers=1, d_model=64, max_seq=16,
                         head_dim=32, device="cpu")
    state = ttr.create_train_state(
        m, ttr.make_optimizer(ttr.TrainerConfig(vocab_size=64)), 0)
    tck.save_checkpoint(str(tmp_path / "h32"), 0, state, config={
        "cli": TrainCLIConfig().to_dict()})
    with pytest.raises(ValueError, match="head_dim=32 has no reference"):
        texport.main([str(tmp_path / "h32"), str(tmp_path / "h.pth")])
    tck.save_checkpoint(str(tmp_path / "bare"), 0, state)
    with pytest.raises(SystemExit, match="no CLI config"):
        texport.main([str(tmp_path / "bare"), str(tmp_path / "b.pth")])


def test_train_does_not_resume_an_imported_run(tmp_path):
    """Both packages refuse to resume training from an imported run (it
    holds parameters only): the port's restore and the JAX CLI's raise
    ValueError."""
    m = MusicTransformer(vocab_size=309, num_layers=1, d_model=64,
                         max_seq=32, device="cpu")
    pth = str(tmp_path / "mt.pth")
    torch.save({"net": m.state_dict(), "optimizer": {}, "epoch": 0}, pth)
    timport.main([pth, str(tmp_path / "port")])
    jimport.main([pth, str(tmp_path / "jax")])
    state = ttr.create_train_state(
        m, ttr.make_optimizer(ttr.TrainerConfig(vocab_size=309)), 0)
    with pytest.raises(ValueError, match="model parameters only"):
        tck.Checkpointer(str(tmp_path / "port")).restore_or(state)

    jm = JMusicTransformer(vocab_size=309, num_layers=1, d_model=64,
                           max_seq=32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    jtx = jtr.make_optimizer(jtr.TrainerConfig(vocab_size=309))
    jstate = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=jtx.init(params),
                            dropout_rng=jax.random.PRNGKey(1))
    with pytest.raises(ValueError):
        jck.Checkpointer(str(tmp_path / "jax")).restore_or(jstate)
    assert os.listdir(tmp_path / "port") == ["step-0.pt"]
