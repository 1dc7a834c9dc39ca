"""The port's PoPMAG arrangement generation (``decode/popmag_generate.py``,
kernel D's plain version on the CPU, f32) against the JAX package's
``generate_arrangement``, on the same weights.

Greedy tokens, valid flags and flattened streams are compared exactly
(B 3, 3 bars, max_steps 24), with the bar token's bias raised in one case
so that some rows end their bars at once and freeze their hidden while
others run on. Sampled draws come from other random streams in the two
packages, so they are held to the typed rules both must keep and, for the
first step's event type, to the softmax by a chi-square (df ~20, the
repo's 52 bound, tests/test_tpu_sampling.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.data import mumidi_packing as jmp
from musicgeneration_tpu.decode import popmag_generate as jpg
from musicgeneration_tpu.models.popmag import PoPMAGRNN as JPoPMAG
from musicgeneration_tpu.tokenizers.mumidi import MuMIDI_EventSeq as JMu
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.data import mumidi_packing as mp
from musicgeneration_tpu_torch.decode.popmag_generate import (
    decode_bar_steps, flatten_arrangement, generate_arrangement)
from tests import fixtures

BAR_HEAD = jmp.BAR_TOKEN - jmp.SHIFT[0]   # the bar token's head-0 index
R = mp.SPEC.feat_ranges()


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("popmag_gen") / "m.mid")
    fixtures.multitrack_midi(path, n_bars=4)
    mel, arr = JMu.extract_split_events(path)
    mb = JMu.segmentation(JMu.to_array(mel))
    ab = JMu.segmentation(JMu.to_array(arr))
    batch = jmp.pack_batch([(mb, ab), (mb[:3], ab[:3]), (mb[1:], ab[1:])])
    jm = JPoPMAG(embed_dim=32, hidden_dim=32, num_layers=2,
                 dropout_rate=0.0)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((3, jm.init_dim)),
                     *(jnp.asarray(a) for a in (
                         batch.src, batch.src_len, batch.tar,
                         batch.tar_len)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)
    init = np.random.default_rng(5).standard_normal(
        (3, jm.init_dim)).astype(np.float32)
    return jm, params, batch, init


def _pair(base, bar_bias=0.0):
    jm, params, batch, init = base
    params = jax.tree.map(np.array, params)
    params["head_type"]["bias"][BAR_HEAD] += bar_bias
    tm = convert.model_from_state_dict(
        convert.popmag_state_dict_from_jax(params), device="cpu")
    return jm, params, tm, batch, init


@pytest.mark.parametrize("bar_bias", [0.0, 0.35])
def test_greedy_generation_matches_jax(base, bar_bias):
    jm, params, tm, batch, init = _pair(base, bar_bias)
    jt, jv = jpg.generate_arrangement(
        jm, params, jnp.asarray(init), jnp.asarray(batch.src),
        jnp.asarray(batch.src_len), jax.random.PRNGKey(0), n_target_bar=3,
        max_steps=24, greedy=True)
    tt, tv = generate_arrangement(tm, init, batch.src, batch.src_len, 3,
                                  max_steps=24, greedy=True)
    assert tt.shape == (3, 3, 24, 3) and tv.dtype == torch.bool
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for got, ref in zip(flatten_arrangement(tt, tv),
                        jpg.flatten_arrangement(jt, jv)):
        np.testing.assert_array_equal(got, ref)
    if bar_bias:   # some bars end at their first step, others run on
        ended = tv[..., 0].sum(-1) == 0
        assert ended.any() and not ended.all()


def test_done_rows_freeze_their_hidden(base):
    """A row whose bar has ended keeps its bar-end hidden: its dec_h is
    the hidden the bar-token step gave, does not depend on max_steps, and
    equals JAX's."""
    jm, params, tm, batch, init = _pair(base, 0.35)
    with torch.no_grad():
        h0 = tm.init_to_hidden(torch.from_numpy(init))
        enc = tm.encode_bar(tm.compression(torch.from_numpy(batch.src[:, 0])),
                            h0, torch.from_numpy(batch.src_len[:, 0]))
        first = torch.tensor([[mp.EVENT_DIM, mp.POS0, 0, 0, mp.BAR_TOKEN,
                               0, 0]] * 3)
        _, h_bar = tm.decode_compound_step(first, enc)
    bar = torch.full((3,), mp.EVENT_DIM)
    t24, v24, h24 = decode_bar_steps(tm, enc, bar, max_steps=24, greedy=True,
                                     temperature=1.0)
    t40, v40, h40 = decode_bar_steps(tm, enc, bar, max_steps=40, greedy=True,
                                     temperature=1.0)
    done = ~v24[:, :, 0].any(-1)                   # rows that ended at once
    assert done.any() and not done.all()
    assert torch.equal(t40[:, :24], t24) and torch.equal(v40[:, :24], v24)
    assert torch.equal(h24[:, done], h_bar[:, done])
    assert torch.equal(h24[:, done], h40[:, done])
    _, _, j_h = jpg.decode_bar_steps(
        jm, params, jnp.asarray(enc.numpy()),
        jnp.full((3,), mp.EVENT_DIM, jnp.int32), jax.random.PRNGKey(0),
        max_steps=24, greedy=True, temperature=1.0)
    np.testing.assert_allclose(h24.numpy(), np.asarray(j_h), atol=1e-5)


def _typed_rules(tokens, valid):
    """The sets a sampled arrangement must keep: event types in head 0's
    range, durations in note_duration, pitches in note_on (+128 on the
    drum track); a pitch and a duration exactly with a note velocity;
    nothing after the bar token."""
    tokens, valid = np.asarray(tokens), np.asarray(valid)
    et, pi, du = tokens[..., 0], tokens[..., 1], tokens[..., 2]
    assert et.min() >= jmp.SHIFT[0] and et.max() < mp.EVENT_DIM
    assert du.min() >= R["note_duration"].start
    assert du.max() < R["note_duration"].stop
    assert pi.min() >= R["note_on"].start
    assert pi.max() < R["note_on"].stop + 128
    is_vel = (et >= R["note_velocity"].start) & (et < R["note_velocity"].stop)
    np.testing.assert_array_equal(valid[..., 1], valid[..., 0] & is_vel)
    np.testing.assert_array_equal(valid[..., 2], valid[..., 1])
    is_bar = et == jmp.BAR_TOKEN
    ended = np.cumsum(is_bar, axis=-1) > 0     # at or after the bar token
    assert not (valid[..., 0] & ended).any()
    np.testing.assert_array_equal(valid[..., 0], ~ended)


def test_sampled_draws_keep_the_typed_sets(base):
    jm, params, tm, batch, init = _pair(base, 0.3)
    src = np.tile(batch.src, (8, 1, 1, 1))
    src_len = np.tile(batch.src_len, (8, 1))
    inits = np.random.default_rng(2).standard_normal((24, 32)).astype(
        np.float32)
    jt, jv = jpg.generate_arrangement(
        jm, params, jnp.asarray(inits), jnp.asarray(src),
        jnp.asarray(src_len), jax.random.PRNGKey(1), n_target_bar=2,
        max_steps=24, greedy=False, temperature=1.0)
    gen = torch.Generator().manual_seed(1)
    tt, tv = generate_arrangement(tm, inits, src, src_len, 2, max_steps=24,
                                  greedy=False, temperature=1.0,
                                  generator=gen)
    for t, v in ((np.asarray(jt), np.asarray(jv)), (tt.numpy(),
                                                     tv.numpy())):
        _typed_rules(t, v)
        assert (~v[..., 0]).any() and v[..., 0].any()
    # one generator seed gives one arrangement
    again = generate_arrangement(tm, inits, src, src_len, 2, max_steps=24,
                                 greedy=False, temperature=1.0,
                                 generator=torch.Generator().manual_seed(1))
    assert torch.equal(again[0], tt) and torch.equal(again[1], tv)


def _chi2(draws, probs, n_bins=20):
    n = len(draws)
    top = np.argsort(probs)[::-1][:n_bins]
    counts = np.array([(draws == t).sum() for t in top], np.float64)
    expect = probs[top] * n
    tail_c, tail_e = n - counts.sum(), max(n - expect.sum(), 1e-9)
    keep = expect > 5
    chi2 = (((counts[keep] - expect[keep]) ** 2) / expect[keep]).sum()
    if tail_e > 5:
        chi2 += (tail_c - tail_e) ** 2 / tail_e
    assert (probs[draws] > 0).all()
    return chi2


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_first_type_draw_follows_the_softmax(base, temperature):
    """4096 first-step event-type draws of one melody and latent, in each
    package, against the softmax of the model's first-step logits."""
    jm, params, tm, batch, init = _pair(base)
    n = 4096
    src = np.repeat(batch.src[:1], n, axis=0)
    src_len = np.repeat(batch.src_len[:1], n, axis=0)
    inits = np.repeat(init[:1], n, axis=0)
    with torch.no_grad():
        enc = tm.encode_bar(tm.compression(torch.from_numpy(src[:1, 0])),
                            tm.init_to_hidden(torch.from_numpy(inits[:1])),
                            torch.from_numpy(src_len[:1, 0]))
        start = torch.tensor([[mp.EVENT_DIM, mp.POS0, 0, 0, mp.BAR_TOKEN,
                               0, 0]])
        logits, _ = tm.decode_compound_step(start, enc)
    probs = torch.softmax(logits[0, 0].double() / temperature, -1).numpy()
    tt, _ = generate_arrangement(tm, inits, src, src_len, 1, max_steps=1,
                                 greedy=False, temperature=temperature,
                                 generator=torch.Generator().manual_seed(4))
    jt, _ = jpg.generate_arrangement(
        jm, params, jnp.asarray(inits), jnp.asarray(src),
        jnp.asarray(src_len), jax.random.PRNGKey(4), n_target_bar=1,
        max_steps=1, greedy=False, temperature=temperature)
    for draws in (tt[:, 0, 0, 0].numpy(), np.asarray(jt)[:, 0, 0, 0]):
        assert _chi2(draws - jmp.SHIFT[0], probs) < 52.0


def test_flatten_matches_jax_on_random_blocks():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 485, (4, 3, 10, 3))
    valid = rng.random((4, 3, 10, 3)) < 0.5
    for got, ref in zip(flatten_arrangement(torch.from_numpy(tokens),
                                            torch.from_numpy(valid)),
                        jpg.flatten_arrangement(tokens, valid)):
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, ref)
