"""The port's beam search (decode/beam.py): tests/test_rnn_models.py's
toy-chain cases, and the JAX ``beam_search`` on the same GRU weights —
deterministic, stochastic with the same pre-drawn Gumbel noise, with
every beam live, and with per-step control inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.decode.beam import beam_search as jbeam_search
from musicgeneration_tpu.decode.beam import (
    replicate_for_beams as jreplicate_for_beams)
from musicgeneration_tpu.models import EventMelodyRNN as JEventMelodyRNN
from musicgeneration_tpu.models import PerformanceRNN as JPerformanceRNN
from musicgeneration_tpu_torch.convert import (
    event_rnn_state_dict_from_jax, model_from_state_dict,
    performance_rnn_state_dict_from_jax)
from musicgeneration_tpu_torch.decode import beam_search, replicate_for_beams


def _one_hot(idx, v):
    return torch.nn.functional.one_hot(idx, v).float()


def test_beam_finds_highest_prob_path_in_toy_chain():
    """token t+1 = (token_t + 1) % V has the highest logit; the beam
    follows the chain."""
    v = 6

    def step_fn(tokens, state):
        return _one_hot((tokens + 1) % v, v) * 5.0, state

    out = beam_search(step_fn, {}, torch.tensor([0, 3]), steps=4,
                      beam_size=3, vocab_size=v, normalize=True)
    assert out.tolist() == [[1, 2, 3, 4], [4, 5, 0, 1]]


def test_beam_state_tracks_parent():
    """The state is re-gathered to the winning beam's lineage."""
    v = 4

    def step_fn(tokens, state):
        even = (state["cnt"] % 2 == 0)[:, None]
        logits = torch.where(even, _one_hot(torch.full_like(tokens, 2), v),
                             _one_hot(torch.full_like(tokens, 1), v)) * 3.0
        return logits, {"cnt": state["cnt"] + 1}

    out = beam_search(step_fn, {"cnt": torch.zeros(3, dtype=torch.long)},
                      torch.zeros(1, dtype=torch.long), steps=3, beam_size=3,
                      vocab_size=v, normalize=True)
    assert out.tolist() == [[2, 1, 2]]


def test_stochastic_beam_varies_with_the_generator():
    v = 8

    def step_fn(tokens, state):
        return torch.zeros(tokens.shape[0], v), state   # uniform

    outs = set()
    for seed in range(4):
        out = beam_search(step_fn, {}, torch.zeros(1, dtype=torch.long),
                          steps=4, beam_size=2, vocab_size=v,
                          generator=torch.Generator().manual_seed(seed),
                          stochastic=True)
        outs.add(tuple(out[0].tolist()))
    assert len(outs) > 1


def test_ties_break_to_the_lower_index():
    """Equal expanded scores select the lower flat index first, as
    jax.lax.top_k does."""
    v = 5

    def step_fn(tokens, state):
        return torch.zeros(tokens.shape[0], v), state

    out = beam_search(step_fn, {}, torch.zeros(2, dtype=torch.long), steps=3,
                      beam_size=3, vocab_size=v, all_beams_live=True)
    jout = jbeam_search(lambda t, s: (jnp.zeros((t.shape[0], v)), s), {},
                        jnp.zeros(2, jnp.int32), steps=3, beam_size=3,
                        vocab_size=v, all_beams_live=True)
    assert out.tolist() == np.asarray(jout).tolist() == [[0, 0, 0]] * 2


@pytest.fixture(scope="module")
def event():
    jm = JEventMelodyRNN(event_dim=20, init_dim=4, hidden_dim=16,
                         num_layers=2)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((2, 4)),
                     jnp.zeros((3, 2), jnp.int32))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.3 * rng.standard_normal(
        a.shape)).astype(np.float32), params)
    tm = model_from_state_dict(event_rnn_state_dict_from_jax(params),
                               device="cpu")
    return jm, params, tm


@pytest.mark.parametrize("stochastic,normalize,all_live,temp", [
    (False, False, False, 1.0),
    (False, True, False, 0.7),
    (True, False, False, 1.0),
    (True, False, True, 1.3),
])
def test_rnn_beam_matches_jax(event, stochastic, normalize, all_live, temp):
    """EventMelodyRNN beam search from latent-seeded states, batch 2,
    beam 4: the port's sequences equal the JAX search's (stochastic runs
    take the same pre-drawn Gumbel noise)."""
    jm, params, tm = event
    batch, beam, steps, v = 2, 4, 8, 20
    init = np.random.RandomState(0).randn(batch, 4).astype(np.float32)
    noise = np.random.default_rng(2).gumbel(size=(steps, batch, beam * v)
                                            ).astype(np.float32)
    first = np.full((batch,), jm.primary_event, np.int32)
    jc = jreplicate_for_beams(jm.apply({"params": params}, batch, 0,
                                       jnp.asarray(init),
                                       method=jm.init_cache),
                              beam, batch_axis=1)
    ref = jbeam_search(
        lambda t, c: jm.apply({"params": params}, t, c,
                              method=jm.decode_step),
        jc, jnp.asarray(first), steps=steps, beam_size=beam, vocab_size=v,
        temperature=temp, stochastic=stochastic, normalize=normalize,
        state_batch_axis=1, all_beams_live=all_live,
        gumbel_noise=jnp.asarray(noise) if stochastic else None)
    tc = replicate_for_beams(tm.init_cache(batch, init=torch.from_numpy(init)),
                             beam, batch_axis=1)
    got = beam_search(tm.decode_step, tc, torch.from_numpy(first),
                      steps=steps, beam_size=beam, vocab_size=v,
                      temperature=temp, stochastic=stochastic,
                      normalize=normalize, state_batch_axis=1,
                      all_beams_live=all_live,
                      gumbel_noise=torch.from_numpy(noise) if stochastic
                      else None)
    assert got.shape == (batch, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_rnn_beam_with_per_step_controls_matches_jax():
    """PerformanceRNN beam search with one control row per step (the
    JAX CLI's ``_beam_decode`` with a control sequence)."""
    jm = JPerformanceRNN(event_dim=24, control_dim=4, init_dim=4,
                         hidden_dim=16, num_layers=2)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 4)),
                     jnp.zeros((3, 1), jnp.int32))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.3 * rng.standard_normal(
        a.shape)).astype(np.float32), params)
    tm = model_from_state_dict(performance_rnn_state_dict_from_jax(params),
                               device="cpu")
    beam, steps = 3, 7
    ctrl = np.random.RandomState(4).rand(steps, 4).astype(np.float32)
    init = np.random.RandomState(5).randn(1, 4).astype(np.float32)
    noise = np.random.default_rng(6).gumbel(size=(steps, 1, beam * 24)
                                            ).astype(np.float32)
    first = np.asarray([jm.primary_event], np.int32)
    jc = jreplicate_for_beams(jm.apply({"params": params}, 1, 0,
                                       jnp.asarray(init),
                                       method=jm.init_cache),
                              beam, batch_axis=1)

    def jstep(t, c, x):
        return jm.apply({"params": params}, t, c, None,
                        jnp.broadcast_to(x, (t.shape[0], 4)),
                        method=jm.decode_step)

    def tstep(t, c, x):
        return tm.decode_step(t, c, x.expand(t.shape[0], -1))

    for stochastic in (False, True):
        ref = jbeam_search(jstep, jc, jnp.asarray(first), steps=steps,
                           beam_size=beam, vocab_size=24,
                           stochastic=stochastic, state_batch_axis=1,
                           per_step_inputs=jnp.asarray(ctrl),
                           gumbel_noise=jnp.asarray(noise) if stochastic
                           else None)
        tc = replicate_for_beams(tm.init_cache(1, init=torch.from_numpy(init)),
                                 beam, batch_axis=1)
        got = beam_search(tstep, tc, torch.from_numpy(first), steps=steps,
                          beam_size=beam, vocab_size=24,
                          stochastic=stochastic, state_batch_axis=1,
                          per_step_inputs=torch.from_numpy(ctrl),
                          gumbel_noise=torch.from_numpy(noise) if stochastic
                          else None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
