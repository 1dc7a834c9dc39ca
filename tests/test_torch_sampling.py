"""The port's sampling against ``musicgeneration_tpu/decode/sampling.py``:
the ids top-k / top-p keep are the same set for the same logits (the JAX
side's masked logits are read off its categorical call), greedy is the
argmax, and a draw from a seeded ``torch.Generator`` is reproducible."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.decode import sampling as jsampling
from musicgeneration_tpu_torch.decode import sampling as tsampling

CASES = [
    dict(top_k=5),
    dict(top_k=1),
    dict(top_k=400),              # k past the vocab
    dict(top_p=0.9),
    dict(top_p=0.3, temperature=0.5),
    dict(top_k=20, top_p=0.8),    # top-p after top-k
    dict(top_k=7, temperature=2.0),
    dict(temperature=1.0),
]


def _logits(seed, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 309)).astype(np.float32) * 3
    if ties:  # repeated values straddle the k-th place
        x[:, 10:20] = x[:, :1]
    return x


def _jax_kept(logits, params, monkeypatch):
    seen = {}

    def capture(key, masked, axis=-1):
        seen["logits"] = np.asarray(masked)
        return jnp.argmax(masked, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jsampling.sample_logits(jax.random.PRNGKey(0), jnp.asarray(logits),
                            params)
    return np.isfinite(seen["logits"])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("ties", [False, True])
def test_kept_sets_match_jax(case, ties, monkeypatch):
    x = _logits(len(str(case)), ties)
    kept_j = _jax_kept(x, jsampling.SamplingParams(**case), monkeypatch)
    masked = tsampling.filter_logits(torch.from_numpy(x),
                                     tsampling.SamplingParams(**case))
    np.testing.assert_array_equal(torch.isfinite(masked).numpy(), kept_j)


def test_greedy_is_argmax():
    x = _logits(1)
    tok = tsampling.sample_logits(torch.from_numpy(x),
                                  tsampling.SamplingParams(greedy=True))
    np.testing.assert_array_equal(tok.numpy(), x.argmax(-1))
    ref = jsampling.sample_logits(jax.random.PRNGKey(0), jnp.asarray(x),
                                  jsampling.SamplingParams(greedy=True))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref))


def test_seeded_draw_reproducible_and_inside_kept_set():
    x = torch.from_numpy(_logits(2))
    params = tsampling.SamplingParams(top_k=12, top_p=0.9)
    draws = [tsampling.sample_logits(x, params,
                                     torch.Generator().manual_seed(9))
             for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    kept = torch.isfinite(tsampling.filter_logits(x, params))
    gen = torch.Generator().manual_seed(10)
    for _ in range(20):
        tok = tsampling.sample_logits(x, params, gen)
        assert kept[torch.arange(4), tok].all()


# per-row params of a mixed pool: (temperature, top_k, top_p, greedy)
ROWS = [(1.0, 0, 1.0, True), (0.8, 20, 0.95, False), (1.0, 5, 1.0, False),
        (0.5, 0, 0.3, False), (2.0, 400, 0.8, False), (1.0, 1, 1.0, False),
        (1.3, 7, 0.6, False), (1.0, 0, 1.0, False)]


def _packed(rows):
    return np.asarray([jsampling.pack_sampling(jsampling.SamplingParams(
        temperature=t, top_k=k, top_p=p, greedy=g)) for t, k, p, g in rows],
        np.int32)


def test_pack_sampling_matches_jax():
    for t, k, p, g in ROWS:
        assert (tsampling.pack_sampling(tsampling.SamplingParams(t, k, p, g))
                == jsampling.pack_sampling(
                    jsampling.SamplingParams(t, k, p, g)))
    samp = tsampling.unpack_sampling(torch.from_numpy(_packed(ROWS)))
    np.testing.assert_array_equal(samp["temperature"].numpy(),
                                  np.float32([r[0] for r in ROWS]))
    np.testing.assert_array_equal(samp["top_p"].numpy(),
                                  np.float32([r[2] for r in ROWS]))
    assert samp["top_k"].tolist() == [r[1] for r in ROWS]
    assert samp["greedy"].tolist() == [r[3] for r in ROWS]


@pytest.mark.parametrize("ties", [False, True])
def test_batched_kept_sets_match_jax(ties, monkeypatch):
    """Mixed per-row params: each row keeps the ids JAX's
    sample_logits_batched keeps (read off its categorical call)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((len(ROWS), 309)).astype(np.float32) * 3
    if ties:
        x[:, 10:20] = x[:, :1]
    packed = _packed(ROWS)
    seen = {}

    def capture(key, masked, axis=-1):
        seen["logits"] = np.asarray(masked)
        return jnp.argmax(masked, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jsampling.sample_logits_batched(
        jax.random.PRNGKey(0), jnp.asarray(x), jsampling.unpack_sampling(
            *(jnp.asarray(packed[:, i]) for i in range(4))))
    masked = tsampling.filter_logits_batched(
        torch.from_numpy(x), tsampling.unpack_sampling(
            torch.from_numpy(packed)))
    np.testing.assert_array_equal(torch.isfinite(masked).numpy(),
                                  np.isfinite(seen["logits"]))


def test_batched_greedy_rows_take_the_argmax():
    x = torch.from_numpy(_logits(4)[:, :64].repeat(2, 0))   # 8 rows
    samp = tsampling.unpack_sampling(torch.from_numpy(_packed(ROWS)))
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        tok = tsampling.sample_logits_batched(x, samp, gen)
        assert tok[0] == x[0].argmax()
        kept = torch.isfinite(tsampling.filter_logits_batched(x, samp))
        assert kept[torch.arange(8), tok].all()


@pytest.mark.parametrize("case", CASES)
def test_batched_uniform_pool_equals_sample_logits(case):
    """A pool whose rows share one params set keeps sample_logits's
    sets and, from the same generator state, draws its tokens."""
    x = torch.from_numpy(_logits(len(str(case)) + 7))
    params = tsampling.SamplingParams(**case)
    samp = tsampling.unpack_sampling(torch.from_numpy(np.tile(
        np.asarray(tsampling.pack_sampling(params), np.int32), (4, 1))))
    np.testing.assert_array_equal(
        torch.isfinite(tsampling.filter_logits_batched(x, samp)).numpy(),
        torch.isfinite(tsampling.filter_logits(x, params)).numpy())
    a = tsampling.sample_logits_batched(x, samp,
                                        torch.Generator().manual_seed(3))
    b = tsampling.sample_logits(x, params, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
