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
