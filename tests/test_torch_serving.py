"""The port's continuous-batching engine (``decode/serving.py``) against
the port's dedicated ``generate`` / ``generate_sliding`` runs and the JAX
``ContinuousBatcher`` on the same weights (JAX params carried over with
``convert.state_dict_from_jax``; the JAX side decodes through its Pallas
kernel in interpret mode, as tests/test_serving.py runs it).

Greedy serving runs at another batch width than a dedicated run, so f32
reassociation may flip a near-tied argmax: a mismatch is accepted only
where the prefix agrees and the first divergent step's top-2 gap is
below 1e-3 relative (the rule of tests/test_serving.py:52-77). The
model's head never emits the pad id: serving re-decodes a context's
last token at row t while ``generate`` takes it from the prefill, and a
pad token inside the context is masked by the prefill only (in both
packages), so a pad in a re-primed window would part them by design.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.decode.serving import (
    ContinuousBatcher as JContinuousBatcher)
from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu_torch.convert import (model_from_state_dict,
                                               state_dict_from_jax)
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate, generate_sliding)
from musicgeneration_tpu_torch.decode.serving import ContinuousBatcher

VOCAB = 64
GREEDY = SamplingParams(greedy=True)


@pytest.fixture(scope="module")
def models():
    jm = JMusicTransformer(decode_impl="fused", vocab_size=VOCAB,
                           num_layers=2, d_model=128, max_seq=256)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    params["fc"]["bias"] = params["fc"]["bias"].copy()
    params["fc"]["bias"][jm.pad_id] = -30.0     # never emit the pad id
    tm = model_from_state_dict(state_dict_from_jax(params), device="cpu")
    return jm, params, tm


def _requests(seed, n, max_p=30, max_new=80):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, VOCAB - 1,
                         size=rng.randint(1, max_p)).astype(np.int32),
             int(rng.randint(10, max_new)))
            for _ in range(n)]


def _reference(tm, prompt, max_new):
    dp = DecodeParams(max_len=prompt.size + max_new, steps=max_new,
                      sampling=GREEDY)
    return generate(tm, torch.from_numpy(prompt)[None], None, dp)[0].numpy()


def _assert_greedy_match(tm, prompt, got, ref):
    """Token equality, tolerating a flip at a near-tie only."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if np.array_equal(got, ref):
        return
    d = int(np.argmax(got != ref))
    full = np.concatenate([prompt, ref]).astype(np.int64)
    with torch.no_grad():
        logits = tm(torch.from_numpy(full)[None])[0, prompt.size - 1 + d]
    lg = np.sort(logits.numpy())[::-1]
    gap = float(lg[0] - lg[1]) / max(abs(float(lg[0])), 1e-6)
    assert gap < 1e-3, (
        f"diverged at step {d} with a decisive top-2 gap ({gap:.5f} "
        "relative): a real mismatch, not a floating-point tie")


def _jax_serve(jm, params, reqs, staggered=None, **kw):
    cb = JContinuousBatcher(jm, params, sampling=JSampling(greedy=True),
                            **kw)
    first = reqs if staggered is None else reqs[:staggered]
    rids = [cb.submit(p, mn) for p, mn in first]
    if staggered is not None:
        cb.step()
        rids += [cb.submit(p, mn) for p, mn in reqs[staggered:]]
    outs = cb.run()
    return [outs[r] for r in rids]


def test_serving_staggered_matches_generate_and_jax(models):
    """Staggered admissions into a 3-slot pool: every request's greedy
    tokens equal its dedicated generate run and the JAX engine's."""
    jm, params, tm = models
    reqs = _requests(7, 7, max_p=40, max_new=50)
    cb = ContinuousBatcher(tm, slots=3, seg_len=16, sampling=GREEDY)
    rids = [cb.submit(p, mn) for p, mn in reqs[:4]]
    cb.step()                       # mid-flight arrivals
    rids += [cb.submit(p, mn) for p, mn in reqs[4:]]
    outs = cb.run()
    jouts = _jax_serve(jm, params, reqs, staggered=4, slots=3, seg_len=16)
    for (p, mn), rid, jo in zip(reqs, rids, jouts):
        assert outs[rid].shape == (mn,)
        _assert_greedy_match(tm, p, outs[rid], _reference(tm, p, mn))
        _assert_greedy_match(tm, p, outs[rid], jo)


def test_serving_compaction_matches_generate_and_jax(models):
    """A cache half the request volume forces roll-compactions (the
    clock wraps); tokens are unchanged and the clock never passes the
    cache end."""
    jm, params, tm = models
    reqs = _requests(3, 7, max_p=20, max_new=70)
    kw = dict(slots=2, seg_len=8, cache_len=128, prompt_bucket=32, depth=3)
    cb = ContinuousBatcher(tm, sampling=GREEDY, **kw)
    rids = [cb.submit(p, mn) for p, mn in reqs]
    outs = cb.run()
    assert sum(mn + p.size for p, mn in reqs) > 2 * cb.cache_len
    assert cb.stats()["compactions"] > 0 and cb.t <= cb.cache_len
    jouts = _jax_serve(jm, params, reqs, **kw)
    for (p, mn), rid, jo in zip(reqs, rids, jouts):
        _assert_greedy_match(tm, p, outs[rid], _reference(tm, p, mn))
        _assert_greedy_match(tm, p, outs[rid], jo)


def test_serving_boost_matches_generate(models):
    """boost=4 fuses up to four segments into one dispatch once the
    queue is empty and every request has that much left; tokens are
    unchanged, and fewer segments are dispatched than steps / seg_len."""
    _, _, tm = models
    reqs = [(p, mn + 60) for p, mn in _requests(11, 3, max_p=20,
                                                   max_new=60)]
    cb = ContinuousBatcher(tm, slots=3, seg_len=8, boost=4,
                           sampling=GREEDY)
    rids = [cb.submit(p, mn) for p, mn in reqs]
    outs = cb.run()
    st = cb.stats()
    assert st["segments"] < st["steps"] // 8
    for (p, mn), rid in zip(reqs, rids):
        _assert_greedy_match(tm, p, outs[rid], _reference(tm, p, mn))


def test_serving_eos_truncation(models):
    """eos_id cuts the stream at its first occurrence and frees the slot
    for the next pending request."""
    _, _, tm = models
    prompt = np.arange(1, 9, dtype=np.int32)
    ref = _reference(tm, prompt, 40)
    eos = int(ref[13])
    first = int(np.argmax(ref == eos))
    cb = ContinuousBatcher(tm, slots=1, seg_len=8, sampling=GREEDY)
    rid = cb.submit(prompt, 40, eos_id=eos)
    rid2 = cb.submit(prompt[:4], 12)
    outs = cb.run()
    np.testing.assert_array_equal(outs[rid], ref[:first])
    _assert_greedy_match(tm, prompt[:4], outs[rid2],
                         _reference(tm, prompt[:4], 12))


def test_serving_drain_tail_shrink_and_grow_back(models):
    """A wide pool over few long requests shrinks in the drain tail
    (4 slots -> 1) and grows back when work queues; outputs still equal
    the dedicated runs and the counters add up."""
    _, _, tm = models
    cb = ContinuousBatcher(tm, slots=4, seg_len=8, min_slots=1,
                           sampling=GREEDY)
    long = np.arange(1, 10, dtype=np.int32)
    short = np.arange(1, 5, dtype=np.int32)
    rid_a = cb.submit(long, 100)
    rid_b = cb.submit(short, 16)
    outs = cb.run()
    assert cb.b < 4
    rid_c = cb.submit(short, 24)
    cb.step()                             # pending: grows back first
    assert cb.b == 4
    outs2 = cb.run()
    _assert_greedy_match(tm, long, outs[rid_a], _reference(tm, long, 100))
    _assert_greedy_match(tm, short, outs[rid_b], _reference(tm, short, 16))
    _assert_greedy_match(tm, short, outs2[rid_c], _reference(tm, short, 24))
    st = cb.stats()
    assert st["committed_tokens"] == 140 and st["admitted"] == 3
    assert 0 < st["active_slot_steps"] <= st["slot_steps"]


def test_serving_cancel(models):
    """A queued cancel delivers an empty result; an active cancel frees
    the slot and delivers a prefix of the dedicated run; a cancel of an
    unknown id is refused."""
    _, _, tm = models
    delivered = {}
    cb = ContinuousBatcher(tm, slots=1, seg_len=8, sampling=GREEDY,
                           on_finalize=lambda r, t: delivered.update({r: t}))
    prompt = np.arange(3, 9, dtype=np.int32)
    rid = cb.submit(prompt, 120)
    queued = cb.submit(prompt[:2], 16)
    assert cb.cancel(queued) and delivered[queued].shape == (0,)
    cb.step()
    cb.step()
    assert cb.cancel(rid)
    assert not cb.cancel(rid) and not cb.cancel(999)
    assert 0 < len(delivered[rid]) < 120
    ref = _reference(tm, prompt, 120)
    np.testing.assert_array_equal(delivered[rid], ref[:len(delivered[rid])])
    assert not any(s.active for s in cb.slots)


def test_serving_sliding_window_matches_generate_sliding(models):
    """A window request (segment-aligned: seg 8, window 16, prompt 8, so
    generate_sliding's chunks are 24 then 16 tokens) re-primes its slot
    many times beside a bounded neighbour; both equal their dedicated
    runs, and the sliding one equals the JAX engine's."""
    jm, params, tm = models
    prompt = np.arange(1, 9, dtype=np.int32)
    short = np.arange(2, 6, dtype=np.int32)
    cb = ContinuousBatcher(tm, slots=2, seg_len=8, cache_len=128,
                           sampling=GREEDY)
    rid = cb.submit(prompt, 200, window=16)
    rid2 = cb.submit(short, 40)
    outs = cb.run()
    st = cb.stats()
    assert st["reprimes"] >= 10 and st["compactions"] >= 1
    ref = generate_sliding(tm, prompt[None], None, 200, window=16,
                           sampling=GREEDY)[0]
    np.testing.assert_array_equal(outs[rid], ref)
    _assert_greedy_match(tm, short, outs[rid2], _reference(tm, short, 40))
    jcb = JContinuousBatcher(jm, params, slots=2, seg_len=8, cache_len=128,
                             sampling=JSampling(greedy=True))
    jrid = jcb.submit(prompt, 200, window=16)
    np.testing.assert_array_equal(jcb.run()[jrid], outs[rid])


def test_serving_per_row_sampling(models):
    """Per-row mode: a greedy row shares the pool with sampled rows and
    still equals its dedicated run; sampled rows have their length and
    ids in the vocabulary; a seeded generator reproduces them."""
    _, _, tm = models
    prompt = np.arange(1, 7, dtype=np.int32)
    results = []
    for _ in range(2):
        cb = ContinuousBatcher(tm, slots=3, seg_len=8, per_row_sampling=True,
                               generator=torch.Generator().manual_seed(5))
        rids = [cb.submit(prompt, 30, sampling=GREEDY),
                cb.submit(prompt, 20, sampling=SamplingParams(
                    temperature=0.9, top_k=12)),
                cb.submit(prompt[:3], 25, sampling=SamplingParams(
                    top_p=0.8))]
        outs = cb.run()
        results.append([outs[r] for r in rids])
    _assert_greedy_match(tm, prompt, results[0][0],
                         _reference(tm, prompt, 30))
    assert [len(r) for r in results[0]] == [30, 20, 25]
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)
    assert all(0 <= r.min() and r.max() < VOCAB for r in results[0])


def test_serving_rejects_bad_requests(models):
    _, _, tm = models
    cb = ContinuousBatcher(tm, slots=2, seg_len=16)
    with pytest.raises(ValueError, match="serve window"):
        cb.submit(np.zeros(100, np.int32), 300)
    with pytest.raises(ValueError, match="empty"):
        cb.submit(np.zeros(0, np.int32), 8)
    with pytest.raises(ValueError, match="seg_len"):
        cb.submit(np.ones(4, np.int32), 64, window=8)
    with pytest.raises(ValueError, match="per_row_sampling"):
        cb.submit(np.ones(4, np.int32), 8, sampling=GREEDY)
    with pytest.raises(TypeError):
        cb.submit(np.ones(4, np.int32), 8, control=[1.0])
