"""The port's speculative decoding (decode/speculative.py, CPU, f32)
against the JAX package's and against the port's own ``generate``.

The JAX side runs as tests/test_speculative.py runs it (the XLA decode
path off-TPU). Both models hold the same seeded weights (2 layers,
d_model 128, vocab 48, max_seq 128), carried across by
``convert.state_dict_from_jax``. Greedy runs must give identical tokens
and the same number of verify forwards; lookup proposals must be equal
on the same context."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.decode import DecodeParams as JDecodeParams
from musicgeneration_tpu.decode import SpecParams as JSpecParams
from musicgeneration_tpu.decode import (
    generate_speculative as jgenerate_speculative)
from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.decode.speculative import (
    _lookup_propose as j_lookup_propose)
from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.decode import (
    DecodeParams, SamplingParams, SpecParams, generate, generate_speculative)
from musicgeneration_tpu_torch.decode.speculative import _lookup_propose
from musicgeneration_tpu_torch.models import EventMelodyRNN

VOCAB = 48


@functools.lru_cache(maxsize=None)
def _pair(num_layers=2, d_model=128, seed=0):
    """(JAX model, its params, the port model on the same weights)."""
    jm = JMusicTransformer(vocab_size=VOCAB, num_layers=num_layers,
                           d_model=d_model, max_seq=128, dropout_rate=0.0)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)
    tm = convert.model_from_state_dict(convert.state_dict_from_jax(params),
                                       device="cpu")
    return jm, params, tm


def _greedy(steps, max_len=96):
    return (DecodeParams(max_len=max_len, steps=steps,
                         sampling=SamplingParams(greedy=True)),
            JDecodeParams(max_len=max_len, steps=steps,
                          sampling=JSampling(greedy=True)))


@pytest.mark.parametrize("kind,n_tot,g,n_prop", [
    ("random", 23, 3, 7), ("repetitive", 23, 3, 7), ("repetitive", 30, 2, 4),
    ("repetitive", 2, 3, 5),      # gram start clamped at 0
    ("repetitive", 40, 2, 5),     # proposals clamped at the buffer's end
])
def test_lookup_propose_matches_jax(kind, n_tot, g, n_prop):
    rng = np.random.default_rng(n_tot)
    if kind == "random":
        ctx = rng.integers(0, VOCAB, (3, 40))
    else:
        ctx = np.stack([np.tile(rng.integers(0, 6, 5), 8) for _ in range(3)])
    got = _lookup_propose(torch.from_numpy(ctx), n_tot, g, n_prop)
    want = j_lookup_propose(jnp.asarray(ctx, jnp.int32), jnp.int32(n_tot), g,
                            n_prop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batch", [1, 3])
def test_lookup_greedy_matches_generate_and_jax(batch):
    """Lookup proposals, greedy: the tokens of the port's generate and of
    the JAX speculative run, and the JAX run's statistics."""
    jm, params, tm = _pair()
    base = np.tile(np.array([3, 7, 11, 7]), 6)
    prompt = np.stack([base + i for i in range(batch)])
    dp, jdp = _greedy(40)
    want = generate(tm, torch.from_numpy(prompt), None, dp)
    got, stats = generate_speculative(tm, torch.from_numpy(prompt), None, dp,
                                      spec=SpecParams(chunk=4, ngram=2),
                                      with_stats=True)
    jgot, jstats = jgenerate_speculative(
        jm, params, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(2),
        jdp, spec=JSpecParams(chunk=4, ngram=2), with_stats=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert stats == jstats
    assert stats["emitted"] >= 40 and stats["iterations"] >= 1


@pytest.mark.parametrize("draft", ["self", "small"])
def test_draft_greedy_matches_generate_and_jax(draft):
    """A draft model: the target itself (every proposal accepted,
    mean_accepted == chunk - 1) or a smaller, independently seeded one
    (1 layer, d_model 64); the tokens never depend on the draft."""
    jm, params, tm = _pair()
    if draft == "self":
        jd, dparams, td = jm, params, tm
        prompt = np.random.RandomState(3).randint(0, VOCAB - 1, (1, 12))
        chunk, steps = 6, 33
    else:
        jd, dparams, td = _pair(num_layers=1, d_model=64, seed=9)
        prompt = np.random.RandomState(5).randint(0, VOCAB - 1, (2, 10))
        chunk, steps = 4, 25
    dp, jdp = _greedy(steps)
    want = generate(tm, torch.from_numpy(prompt), None, dp)
    got, stats = generate_speculative(
        tm, torch.from_numpy(prompt), None, dp, draft_model=td,
        spec=SpecParams(chunk=chunk), with_stats=True)
    jgot, jstats = jgenerate_speculative(
        jm, params, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(2),
        jdp, draft_model=jd, draft_params=dparams,
        spec=JSpecParams(chunk=chunk), with_stats=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert stats == jstats
    if draft == "self":
        assert stats["mean_accepted"] == chunk - 1


@pytest.mark.parametrize("draft", [False, True])
def test_sampled_speculation_valid_and_plumbed(draft):
    """Sampled speculation: tokens in range, the stats identity
    (emitted = 1 + iterations + accepted), and the same tokens again from
    a generator with the same seed."""
    _, _, tm = _pair()
    prompt = torch.from_numpy(
        np.random.RandomState(7).randint(0, VOCAB - 1, (2, 8)))
    dp = DecodeParams(max_len=96, steps=30,
                      sampling=SamplingParams(temperature=0.9, top_k=12))
    kw = dict(spec=SpecParams(chunk=4, ngram=2), with_stats=True,
              draft_model=tm if draft else None)
    toks, stats = generate_speculative(
        tm, prompt, torch.Generator().manual_seed(4), dp, **kw)
    again, _ = generate_speculative(
        tm, prompt, torch.Generator().manual_seed(4), dp, **kw)
    arr = toks.numpy()
    assert arr.shape == (2, 30) and arr.dtype == np.int64
    assert arr.min() >= 0 and arr.max() < VOCAB
    acc = stats["emitted"] - 1 - stats["iterations"]
    assert 0 <= acc <= stats["iterations"] * 3
    assert stats["emitted"] >= 30
    assert stats["mean_accepted"] == pytest.approx(acc / stats["iterations"])
    assert torch.equal(toks, again)


@pytest.mark.parametrize("bad,match", [
    ("chunk", "chunk"), ("overflow", "max_seq"),
    ("draft_max_seq", "draft max_seq"), ("rnn_draft", "recurrent"),
    ("rnn_target", "decode_chunk")])
def test_speculative_validation_errors(bad, match):
    _, _, tm = _pair()
    rnn = EventMelodyRNN(event_dim=VOCAB, init_dim=4, hidden_dim=16,
                         num_layers=1, device="cpu")
    prompt = torch.zeros(1, 8, dtype=torch.long)
    dp, spec, model, draft = DecodeParams(max_len=64, steps=8), \
        SpecParams(), tm, None
    if bad == "chunk":
        spec = SpecParams(chunk=1)
    elif bad == "overflow":
        dp = DecodeParams(max_len=128, steps=118)
    elif bad == "draft_max_seq":
        draft = convert.model_from_state_dict(tm.state_dict(), device="cpu")
        draft.max_seq = 16
    elif bad == "rnn_draft":
        draft = rnn
    else:
        model = rnn
    with pytest.raises(ValueError, match=match):
        generate_speculative(model, prompt, None, dp, draft_model=draft,
                             spec=spec)
