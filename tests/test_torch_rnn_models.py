"""The port's EventMelodyRNN and PerformanceRNN (models/event_rnn.py,
models/performance_rnn.py), their checkpoint conversion and loading
(convert.py) and stepwise generation (decode/engine.py) against the JAX
package on the same weights: JAX params go through the port's
``*_state_dict_from_jax``, which must equal the JAX exporters'
output key for key. Logits in f32 within 1e-5; greedy tokens equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli.export_checkpoint import (
    export_event_rnn, export_performance_rnn)
from musicgeneration_tpu.decode import DecodeParams as JDecodeParams
from musicgeneration_tpu.decode import expand_controls as jexpand_controls
from musicgeneration_tpu.decode import generate as jgenerate
from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.models import EventMelodyRNN as JEventMelodyRNN
from musicgeneration_tpu.models import PerformanceRNN as JPerformanceRNN
from musicgeneration_tpu_torch.convert import (
    event_rnn_state_dict_from_jax, load_checkpoint, model_from_state_dict,
    performance_rnn_state_dict_from_jax)
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              expand_controls, generate)
from musicgeneration_tpu_torch.models import EventMelodyRNN, PerformanceRNN

GREEDY = SamplingParams(greedy=True)


def _randomize(params, seed):
    """Perturb every leaf (non-zero biases too) so the comparisons see
    every parameter."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def event():
    jm = JEventMelodyRNN(event_dim=32, init_dim=8, hidden_dim=32,
                         num_layers=2)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)),
                                jnp.zeros((4, 1), jnp.int32))["params"], 0)
    tm = model_from_state_dict(event_rnn_state_dict_from_jax(params),
                               device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def perf():
    jm = JPerformanceRNN(event_dim=32, control_dim=4, init_dim=8,
                         hidden_dim=32, num_layers=2)
    params = _randomize(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8)),
                                jnp.zeros((4, 1), jnp.int32))["params"], 1)
    tm = model_from_state_dict(performance_rnn_state_dict_from_jax(params),
                               device="cpu")
    return jm, params, tm


def _same_state_dict(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k


def test_conversion_equals_the_jax_exporters(event, perf):
    _, params, tm = event
    _same_state_dict(event_rnn_state_dict_from_jax(params),
                     export_event_rnn(params, {}, 0))
    assert isinstance(tm, EventMelodyRNN) and tm.family == "event_rnn"
    _, pparams, pm = perf
    _same_state_dict(performance_rnn_state_dict_from_jax(pparams),
                     export_performance_rnn(pparams, {}, 0)["model_state"])
    assert isinstance(pm, PerformanceRNN) and pm.control_dim == 4


def test_load_checkpoint_reads_both_reference_formats(event, perf, tmp_path):
    """The exporters' files: EventMelodyRNN's bare state dict and
    PerformanceRNN's session dict, loaded with strict=True into models of
    the inferred shape; an unknown format raises and says what it holds."""
    _, params, tm = event
    path = tmp_path / "ev.pth"
    torch.save(export_event_rnn(params, {}, 3), path)
    got = load_checkpoint(str(path), device="cpu")
    assert isinstance(got, EventMelodyRNN)
    assert (got.event_dim, got.init_dim, got.hidden_dim, got.num_layers) == \
        (32, 8, 32, 2)
    _same_state_dict(got.state_dict(), tm.state_dict())
    _, pparams, pm = perf
    path = tmp_path / "perf.pth"
    torch.save(export_performance_rnn(pparams, {"dropout_rate": 0.3}, 3), path)
    got = load_checkpoint(str(path), device="cpu", dtype=torch.bfloat16)
    assert isinstance(got, PerformanceRNN) and got.dtype == torch.bfloat16
    assert (got.control_dim, got.num_layers) == (4, 2)
    _same_state_dict(got.state_dict(), pm.state_dict())
    path = tmp_path / "other.pth"
    torch.save({"net": {"encoder.weight_ih_l0": torch.zeros(3, 2)}}, path)
    with pytest.raises(ValueError, match="encoder.weight_ih_l0"):
        load_checkpoint(str(path), device="cpu")


@pytest.mark.parametrize("with_lengths", [False, True])
def test_event_rnn_logits_and_init_to_hidden(event, with_lengths):
    jm, params, tm = event
    rng = np.random.RandomState(2)
    init = rng.randn(3, 8).astype(np.float32)
    events = rng.randint(0, 31, (6, 3))
    lengths = np.asarray([6, 2, 4], np.int32) if with_lengths else None
    ref = jm.apply({"params": params}, jnp.asarray(init), jnp.asarray(events),
                   lengths=None if lengths is None else jnp.asarray(lengths))
    got = tm(torch.from_numpy(init), torch.from_numpy(events),
             lengths=None if lengths is None else torch.from_numpy(lengths))
    assert tuple(got.shape) == (7, 3, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    ref_h = jm.apply({"params": params}, jnp.asarray(init),
                     method=jm.init_to_hidden)
    np.testing.assert_allclose(tm.init_to_hidden(torch.from_numpy(init)
                                                 ).numpy(),
                               np.asarray(ref_h), atol=1e-5)


def test_event_rnn_decode_step_matches_jax(event):
    jm, params, tm = event
    rng = np.random.RandomState(3)
    init = rng.randn(2, 8).astype(np.float32)
    jc = jm.apply({"params": params}, 2, 0, jnp.asarray(init),
                  method=jm.init_cache)
    tc = tm.init_cache(2, init=torch.from_numpy(init))
    for tok in rng.randint(0, 31, (4, 2)):
        jl, jc = jm.apply({"params": params}, jnp.asarray(tok), jc,
                          method=jm.decode_step)
        tl, tc = tm.decode_step(torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
        np.testing.assert_allclose(tc["h"].numpy(), np.asarray(jc["h"]),
                                   atol=1e-5)
    zeros = tm.init_cache(3)["h"]
    assert tuple(zeros.shape) == (2, 3, 32) and zeros.abs().max() == 0


@pytest.mark.parametrize("with_controls", [False, True])
def test_performance_rnn_logits_match_jax(perf, with_controls):
    jm, params, tm = perf
    rng = np.random.RandomState(4)
    init = rng.randn(3, 8).astype(np.float32)
    events = rng.randint(0, 31, (5, 3))
    ctrl = rng.rand(5, 3, 4).astype(np.float32) if with_controls else None
    ref = jm.apply({"params": params}, jnp.asarray(init), jnp.asarray(events),
                   None if ctrl is None else jnp.asarray(ctrl))
    got = tm(torch.from_numpy(init), torch.from_numpy(events),
             None if ctrl is None else torch.from_numpy(ctrl))
    assert tuple(got.shape) == (5, 3, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    ref_h = jm.apply({"params": params}, jnp.asarray(init),
                     method=jm.init_to_hidden)
    np.testing.assert_allclose(tm.init_to_hidden(torch.from_numpy(init)
                                                 ).numpy(),
                               np.asarray(ref_h), atol=1e-5)


@pytest.mark.parametrize("mode", ["none", "control", "mixed_default"])
def test_performance_rnn_decode_step_matches_jax(perf, mode):
    """decode_step without a control, with one, and with a per-row
    ``control_default`` mask mixing both."""
    jm, params, tm = perf
    rng = np.random.RandomState(5)
    init = rng.randn(4, 8).astype(np.float32)
    jc = jm.apply({"params": params}, 4, 0, jnp.asarray(init),
                  method=jm.init_cache)
    tc = tm.init_cache(4, init=torch.from_numpy(init))
    dflt = np.asarray([True, False, False, True])
    for _ in range(3):
        tok = rng.randint(0, 31, 4)
        c = rng.rand(4, 4).astype(np.float32)
        jargs = {"none": (), "control": (None, jnp.asarray(c)),
                 "mixed_default": (None, jnp.asarray(c), jnp.asarray(dflt))
                 }[mode]
        targs = {"none": (), "control": (torch.from_numpy(c),),
                 "mixed_default": (torch.from_numpy(c),
                                   torch.from_numpy(dflt))}[mode]
        jl, jc = jm.apply({"params": params}, jnp.asarray(tok), jc, *jargs,
                          method=jm.decode_step)
        tl, tc = tm.decode_step(torch.from_numpy(tok), tc, *targs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
        np.testing.assert_allclose(tc["h"].numpy(), np.asarray(jc["h"]),
                                   atol=1e-5)


def test_expand_controls_matches_jax():
    c1 = np.arange(24, dtype=np.float32).reshape(1, 1, 24)
    c4 = np.arange(4 * 24, dtype=np.float32).reshape(4, 1, 24)
    for c, steps in ((c1, 5), (c4, 3), (c4, 6)):
        np.testing.assert_array_equal(
            expand_controls(torch.from_numpy(c), steps).numpy(),
            np.asarray(jexpand_controls(jnp.asarray(c), steps)))


def test_event_rnn_greedy_generate_matches_jax_bucketed(event):
    """Greedy tokens equal the JAX engine's, which pads the prompt to a
    bucket of 16 and masks the padded steps (its CLI's path); the port
    runs the true prompt only."""
    jm, params, tm = event
    rng = np.random.RandomState(6)
    prompt = rng.randint(0, 31, (3, 5)).astype(np.int32)
    padded = np.pad(prompt, ((0, 0), (0, 11)))
    ref = jgenerate(jm, params, jnp.asarray(padded), jax.random.PRNGKey(0),
                    JDecodeParams(max_len=16 + 24, steps=24,
                                  sampling=JSampling(greedy=True)),
                    None, None, jnp.int32(5))
    got = generate(tm, torch.from_numpy(prompt), None,
                   DecodeParams(max_len=5 + 24, steps=24, sampling=GREEDY))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the port's own padded-prompt form gives the same tokens
    pad = generate(tm, torch.from_numpy(padded), None,
                   DecodeParams(max_len=16 + 24, steps=24, sampling=GREEDY),
                   prompt_len=5)
    assert torch.equal(pad, got)


@pytest.mark.parametrize("ctrl_len", [1, 13, 30])
def test_performance_rnn_greedy_generate_with_cache0_and_controls(ctrl_len):
    """tests/test_control_generation.py's shapes: event_dim 64, 24
    controls, 1 layer of 16; a latent-seeded cache0 and a control that
    repeats (1 row), is one row short of p + steps (13) or longer (30)."""
    jm = JPerformanceRNN(event_dim=64, control_dim=24, init_dim=8,
                         hidden_dim=16, num_layers=1, dropout_rate=0.0)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)),
                                jnp.zeros((3, 1), jnp.int32))["params"], 7)
    tm = model_from_state_dict(performance_rnn_state_dict_from_jax(params),
                               device="cpu")
    steps, p = 12, 2
    rng = np.random.RandomState(8)
    z = (3.0 * rng.randn(2, 8)).astype(np.float32)
    ctrl = rng.rand(ctrl_len, 2, 24).astype(np.float32)
    prompt = np.asarray([[jm.primary_event, 5]] * 2, np.int32)
    jc0 = jm.apply({"params": params}, 2, 0, jnp.asarray(z),
                   method=jm.init_cache)
    ref = jgenerate(jm, params, jnp.asarray(prompt), jax.random.PRNGKey(1),
                    JDecodeParams(max_len=p + steps, steps=steps,
                                  sampling=JSampling(greedy=True)),
                    jnp.asarray(ctrl), jc0)
    got = generate(tm, torch.from_numpy(prompt), None,
                   DecodeParams(max_len=p + steps, steps=steps,
                                sampling=GREEDY),
                   controls=torch.from_numpy(ctrl),
                   cache0=tm.init_cache(2, init=torch.from_numpy(z)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_generate_refuses_mixed_arguments(event):
    _, _, tm = event
    dp = DecodeParams(max_len=8, steps=4, sampling=GREEDY)
    with pytest.raises(ValueError, match="max_len"):
        generate(tm, torch.zeros(1, 5, dtype=torch.long), None, dp)
    with pytest.raises(ValueError, match="prompt_len"):
        generate(tm, torch.zeros(1, 3, dtype=torch.long), None, dp,
                 prompt_len=4)
