"""MelodyRNN in the port's continuous-batching engine
(decode/serving_rnn.py), the port's counterpart of
tests/test_serving_rnn.py::test_melody_rnn_slot_reuse_matches_generate:
at ``attn_length`` 0 and 5 (a window shorter than the requests, so its
per-row count ``attn_n`` matters) and 40, staggered requests and slot
reuse give each request's dedicated greedy ``generate`` tokens, and the
JAX ``RNNContinuousBatcher``'s on the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.decode.serving_rnn import (
    RNNContinuousBatcher as JRNNContinuousBatcher)
from musicgeneration_tpu.models import MelodyRNN as JMelodyRNN
from musicgeneration_tpu_torch.convert import (melody_rnn_state_dict_from_jax,
                                               model_from_state_dict)
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate)
from musicgeneration_tpu_torch.decode.serving_rnn import RNNContinuousBatcher

GREEDY = SamplingParams(greedy=True)


@pytest.fixture(scope="module", params=[0, 5, 40],
                ids=["basic", "attn5", "attn40"])
def melody(request):
    w = request.param
    jm = JMelodyRNN(vocab_size=130, embed_size=16, hidden_dim=32,
                    num_layers=2, attn_length=w)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(3 + w), jnp.zeros((4, 1), jnp.int32))["params"])
    return jm, params, model_from_state_dict(
        melody_rnn_state_dict_from_jax(params), device="cpu", attn_length=w)


def _reference(m, prompt, max_new):
    dp = DecodeParams(max_len=prompt.size + max_new, steps=max_new,
                      sampling=GREEDY)
    return generate(m, torch.from_numpy(prompt.astype(np.int64))[None], None,
                    dp)[0].numpy()


def _requests(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 129, size=rng.randint(1, 10)).astype(np.int32),
             int(rng.randint(8, 60))) for _ in range(n)]


def test_staggered_requests_match_generate_and_jax(melody):
    """Three requests, one segment, then three more into a 3-slot pool:
    every greedy stream equals its dedicated run and the JAX engine's."""
    jm, params, m = melody
    reqs = _requests(5, 6)
    cb = RNNContinuousBatcher(m, slots=3, seg_len=8, prompt_bucket=8,
                              sampling=GREEDY)
    rids = [cb.submit(p, mn) for p, mn in reqs[:3]]
    cb.step()                       # mid-flight arrivals
    rids += [cb.submit(p, mn) for p, mn in reqs[3:]]
    outs = cb.run()
    jcb = JRNNContinuousBatcher(jm, params, slots=3, seg_len=8,
                                prompt_bucket=8,
                                sampling=JSampling(greedy=True))
    jrids = [jcb.submit(p, mn) for p, mn in reqs[:3]]
    jcb.step()
    jrids += [jcb.submit(p, mn) for p, mn in reqs[3:]]
    jouts = jcb.run()
    for (p, mn), rid, jrid in zip(reqs, rids, jrids):
        assert outs[rid].shape == (mn,)
        np.testing.assert_array_equal(outs[rid], _reference(m, p, mn))
        np.testing.assert_array_equal(outs[rid], jouts[jrid])


def test_slot_reuse_matches_generate(melody):
    """Five requests through two slots: each retirement hands its slot
    to the next request, whose attention window starts empty again."""
    _, _, m = melody
    reqs = _requests(11, 5)
    cb = RNNContinuousBatcher(m, slots=2, seg_len=8, prompt_bucket=8,
                              sampling=GREEDY)
    rids = [cb.submit(p, mn) for p, mn in reqs]
    outs = cb.run()
    for (p, mn), rid in zip(reqs, rids):
        np.testing.assert_array_equal(outs[rid], _reference(m, p, mn))
    assert cb.stats()["admitted"] == 5
    if m.attn_length:
        assert cb.cache["attn_n"].dtype == torch.long


def test_melody_requests_refuse_a_latent(melody):
    _, _, m = melody
    cb = RNNContinuousBatcher(m, slots=1, sampling=GREEDY)
    with pytest.raises(ValueError, match="no init latent"):
        cb.submit(np.array([60], np.int32), 4, init=np.zeros(8))
