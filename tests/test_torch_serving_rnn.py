"""The port's GRU continuous-batching engine (decode/serving_rnn.py):
tests/test_serving_rnn.py's EventMelodyRNN and PerformanceRNN cases at
their sizes (event_dim 32, hidden 32, 2 layers), each request's greedy
tokens held against its dedicated ``generate`` run, and the JAX
``RNNContinuousBatcher`` on the same weights, token for token.

As in the JAX tests, serving runs at another batch width than a
dedicated B=1 run; the seeds keep the untrained models' greedy argmax
clear of near-ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.decode.serving_rnn import (
    RNNContinuousBatcher as JRNNContinuousBatcher)
from musicgeneration_tpu.models import EventMelodyRNN as JEventMelodyRNN
from musicgeneration_tpu.models import PerformanceRNN as JPerformanceRNN
from musicgeneration_tpu_torch.convert import (
    event_rnn_state_dict_from_jax, model_from_state_dict,
    performance_rnn_state_dict_from_jax)
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate)
from musicgeneration_tpu_torch.decode.serving_rnn import RNNContinuousBatcher

GREEDY = SamplingParams(greedy=True)
EDIM = 32


@pytest.fixture(scope="module")
def event():
    jm = JEventMelodyRNN(event_dim=EDIM, init_dim=8, hidden_dim=32,
                         num_layers=2)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8)),
        jnp.zeros((4, 1), jnp.int32))["params"])
    return jm, params, model_from_state_dict(
        event_rnn_state_dict_from_jax(params), device="cpu")


@pytest.fixture(scope="module")
def perf():
    jm = JPerformanceRNN(event_dim=EDIM, control_dim=4, init_dim=8,
                         hidden_dim=32, num_layers=2)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8)),
        jnp.zeros((4, 1), jnp.int32))["params"])
    return jm, params, model_from_state_dict(
        performance_rnn_state_dict_from_jax(params), device="cpu")


def _reference(m, prompt, max_new, init=None, control=None):
    """The dedicated B=1 ``generate`` run every greedy serving output
    must equal."""
    cache0 = (None if init is None else
              m.init_cache(1, init=torch.from_numpy(
                  np.asarray(init, np.float32))[None]))
    controls = None
    if control is not None:
        c = np.asarray(control, np.float32)
        controls = torch.from_numpy(c[None] if c.ndim == 1 else c)[:, None]
    dp = DecodeParams(max_len=prompt.size + max_new, steps=max_new,
                      sampling=GREEDY)
    return generate(m, torch.from_numpy(prompt.astype(np.int64))[None], None,
                    dp, controls=controls, cache0=cache0)[0].numpy()


def _requests(seed, n, max_p=12, max_new=40, init_dim=None):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p = rng.randint(0, EDIM - 1, size=rng.randint(1, max_p)).astype(
            np.int32)
        init = rng.randn(init_dim).astype(np.float32) if init_dim else None
        out.append((p, int(rng.randint(8, max_new)), init))
    return out


def test_event_rnn_staggered_matches_generate_and_jax(event):
    """Latent-seeded requests staggered into a 3-slot pool: every greedy
    output equals its dedicated generate run and the JAX engine's."""
    jm, params, m = event
    reqs = _requests(7, 6, init_dim=8)
    cb = RNNContinuousBatcher(m, slots=3, seg_len=8, prompt_bucket=8,
                              sampling=GREEDY)
    rids = [cb.submit(p, mn, init=z) for p, mn, z in reqs[:3]]
    cb.step()                       # mid-flight arrivals
    rids += [cb.submit(p, mn, init=z) for p, mn, z in reqs[3:]]
    outs = cb.run()
    jcb = JRNNContinuousBatcher(jm, params, slots=3, seg_len=8,
                                prompt_bucket=8,
                                sampling=JSampling(greedy=True))
    jrids = [jcb.submit(p, mn, init=z) for p, mn, z in reqs[:3]]
    jcb.step()
    jrids += [jcb.submit(p, mn, init=z) for p, mn, z in reqs[3:]]
    jouts = jcb.run()
    for (p, mn, z), rid, jrid in zip(reqs, rids, jrids):
        assert outs[rid].shape == (mn,)
        np.testing.assert_array_equal(outs[rid], _reference(m, p, mn, init=z))
        np.testing.assert_array_equal(outs[rid], jouts[jrid])


def _mixed_control_requests(m):
    rng = np.random.RandomState(11)
    reqs = []
    for j in range(5):
        p = rng.randint(0, EDIM - 1, size=rng.randint(1, 10)).astype(np.int32)
        mn = int(rng.randint(8, 30))
        z = rng.randn(m.init_dim).astype(np.float32)
        if j % 3 == 0:
            ctrl = None
        elif j % 3 == 1:
            ctrl = rng.rand(m.control_dim).astype(np.float32)   # repeats
        else:
            # shorter than p + steps: the cursor clamp must hold it
            ctrl = rng.rand(p.size + mn // 2,
                            m.control_dim).astype(np.float32)
        reqs.append((p, mn, z, ctrl))
    return reqs


def test_performance_rnn_mixed_control_pool(perf):
    """Conditioned and unconditioned requests share one pool (the per-row
    control_default mask); each equals its dedicated run and the JAX
    engine's."""
    jm, params, m = perf
    reqs = _mixed_control_requests(m)
    cb = RNNContinuousBatcher(m, slots=2, seg_len=8, prompt_bucket=8,
                              ctrl_window=64, sampling=GREEDY)
    rids = [cb.submit(p, mn, init=z, control=c) for p, mn, z, c in reqs]
    outs = cb.run()
    jcb = JRNNContinuousBatcher(jm, params, slots=2, seg_len=8,
                                prompt_bucket=8, ctrl_window=64,
                                sampling=JSampling(greedy=True))
    jrids = [jcb.submit(p, mn, init=z, control=c) for p, mn, z, c in reqs]
    jouts = jcb.run()
    for (p, mn, z, c), rid, jrid in zip(reqs, rids, jrids):
        ref = _reference(m, p, mn, init=z, control=c)
        np.testing.assert_array_equal(outs[rid], ref)
        np.testing.assert_array_equal(outs[rid], jouts[jrid])


def test_rnn_serving_eos_and_stats(event):
    """eos_id truncates at its first occurrence and frees the slot; the
    counters add up (prefill steps: max(p) - 1 per admission group)."""
    _, _, m = event
    prompt = np.arange(1, 7, dtype=np.int32)
    z = np.ones((m.init_dim,), np.float32)
    ref = _reference(m, prompt, 40, init=z)
    eos = int(ref[11])
    first = int(np.argmax(ref == eos))
    cb = RNNContinuousBatcher(m, slots=1, seg_len=8, prompt_bucket=8,
                              sampling=GREEDY)
    rid = cb.submit(prompt, 40, eos_id=eos, init=z)
    rid2 = cb.submit(prompt[:3], 12, init=z)
    outs = cb.run()
    np.testing.assert_array_equal(outs[rid], ref[:first])
    assert outs[rid2].shape == (12,)
    st = cb.stats()
    assert st["committed_tokens"] == first + 12
    assert st["admitted"] == 2 and st["admit_calls"] == 2
    assert st["prefill_steps"] == (6 - 1) + (3 - 1)
    assert 0 < st["occupancy"] <= 1
    assert "compactions" not in st          # GRU slots never compact


def test_rnn_serving_drain_tail_shrink_exact(perf):
    """Drain-tail shrinking (the resize gathers hidden stacks, cursors
    and control windows): outputs unchanged, the pool ends narrow, and
    growing back admits new work."""
    _, _, m = perf
    rng = np.random.RandomState(9)
    z = rng.randn(m.init_dim).astype(np.float32)
    ctrl = rng.rand(m.control_dim).astype(np.float32)
    long = np.arange(1, 8, dtype=np.int32)
    short = np.arange(1, 4, dtype=np.int32)
    cb = RNNContinuousBatcher(m, slots=4, seg_len=8, prompt_bucket=8,
                              min_slots=1, sampling=GREEDY)
    rid_a = cb.submit(long, 80, init=z, control=ctrl)
    rid_b = cb.submit(short, 12, init=z)
    outs = cb.run()
    assert cb.b < 4
    rid_c = cb.submit(short, 16, init=z, control=ctrl)
    outs2 = cb.run()
    np.testing.assert_array_equal(
        outs[rid_a], _reference(m, long, 80, init=z, control=ctrl))
    np.testing.assert_array_equal(outs[rid_b],
                                  _reference(m, short, 12, init=z))
    np.testing.assert_array_equal(
        outs2[rid_c], _reference(m, short, 16, init=z, control=ctrl))


def test_rnn_serving_per_row_mixed_sampling(event):
    """A per-row pool mixing greedy, top-k 1 (its kept set is the argmax
    alone) and sampled requests: greedy and top-k 1 rows equal their
    dedicated greedy runs while sharing segments with sampled rows, which
    stay in range."""
    _, _, m = event
    cb = RNNContinuousBatcher(
        m, slots=3, seg_len=8, prompt_bucket=8, min_slots=1,
        per_row_sampling=True,
        sampling=SamplingParams(temperature=0.9, top_k=10),
        generator=torch.Generator().manual_seed(3))
    reqs = _requests(13, 6, init_dim=8)
    rids, exact = [], set()
    for j, (p, mn, z) in enumerate(reqs):
        if j % 3 == 0:
            rid = cb.submit(p, mn, init=z, sampling=GREEDY)
            exact.add(rid)
        elif j % 3 == 1:
            rid = cb.submit(p, mn, init=z,
                            sampling=SamplingParams(temperature=1.5, top_k=1))
            exact.add(rid)
        else:
            rid = cb.submit(p, mn, init=z)
        rids.append(rid)
    outs = cb.run()
    for (p, mn, z), rid in zip(reqs, rids):
        assert outs[rid].shape == (mn,)
        if rid in exact:
            np.testing.assert_array_equal(outs[rid],
                                          _reference(m, p, mn, init=z))
        else:
            assert outs[rid].min() >= 0 and outs[rid].max() < EDIM


def test_rnn_serving_warm_and_streaming(event):
    """warm() leaves no request behind; on_finalize streams results
    mid-drain; the latency summary covers the finalized requests."""
    _, _, m = event
    got = {}
    cb = RNNContinuousBatcher(
        m, slots=2, seg_len=8, prompt_bucket=8, min_slots=1, sampling=GREEDY,
        on_finalize=lambda rid, toks: got.__setitem__(rid, toks.copy()))
    cb.warm()
    assert not got and cb.b == 2
    reqs = _requests(17, 3, init_dim=8)
    rids = [cb.submit(p, mn, init=z) for p, mn, z in reqs]
    outs = cb.run()
    assert set(got) == set(rids)
    for rid in rids:
        np.testing.assert_array_equal(got[rid], outs[rid])
    lat = cb.latency_summary()
    assert lat["n"] == 3 and lat["e2e_p50"] <= lat["e2e_p95"]


def test_rnn_serving_cancel(event):
    """A queued request drops with an empty result; an active one
    delivers its prefix; survivors are unaffected."""
    _, _, m = event
    reqs = _requests(21, 2, max_new=60, init_dim=8)
    cb = RNNContinuousBatcher(m, slots=2, seg_len=8, prompt_bucket=8,
                              depth=1, sampling=GREEDY)
    rids = [cb.submit(p, mn, init=z) for p, mn, z in reqs]
    rid_q = cb.submit(np.asarray([3, 5], np.int32), 16)
    assert cb.cancel(rid_q) is True
    assert cb.cancel(rid_q) is False
    for _ in range(2):
        cb.step()
    assert cb.cancel(rids[0]) is True
    outs = cb.run()
    assert outs[rid_q].size == 0
    ref0 = _reference(m, reqs[0][0], reqs[0][1], init=reqs[0][2])
    got0 = outs[rids[0]]
    assert 0 < got0.size <= reqs[0][1]
    np.testing.assert_array_equal(got0, ref0[:got0.size])
    np.testing.assert_array_equal(
        outs[rids[1]], _reference(m, reqs[1][0], reqs[1][1],
                                  init=reqs[1][2]))


def test_rnn_serving_validation(event, perf):
    _, _, m = event
    cb = RNNContinuousBatcher(m, slots=2, prompt_bucket=8)
    with pytest.raises(ValueError, match="no control"):
        cb.submit(np.asarray([1], np.int32), 8, control=np.ones(4))
    with pytest.raises(ValueError, match="init must be"):
        cb.submit(np.asarray([1], np.int32), 8, init=np.ones(3))
    with pytest.raises(ValueError, match="empty"):
        cb.submit(np.zeros(0, np.int32), 8)
    with pytest.raises(TypeError, match="unexpected"):
        cb.submit(np.asarray([1], np.int32), 8, bogus=1)
    with pytest.raises(ValueError, match="per_row_sampling"):
        cb.submit(np.asarray([1], np.int32), 8, sampling=GREEDY)
    _, _, mp = perf
    cbp = RNNContinuousBatcher(mp, slots=2, prompt_bucket=8, ctrl_window=16)
    with pytest.raises(ValueError, match="ctrl_window"):
        cbp.submit(np.asarray([1], np.int32), 8,
                   control=np.ones((32, mp.control_dim)))
    with pytest.raises(ValueError, match="control must be"):
        cbp.submit(np.asarray([1], np.int32), 8, control=np.ones(5))


def test_rnn_serving_boost_greedy_parity(event):
    """boost=4: long eos-free requests decode through fused
    4*seg_len-step dispatches once the queue drains; greedy outputs equal
    the boost=1 pool's and the dedicated runs'."""
    _, _, m = event
    reqs = _requests(21, 4, max_p=10, max_new=90, init_dim=8)
    outs, segs = {}, {}
    for boost in (1, 4):
        cb = RNNContinuousBatcher(m, slots=2, seg_len=8, prompt_bucket=8,
                                  min_slots=2, boost=boost, sampling=GREEDY)
        cb.warm()
        rids = [cb.submit(p, mn, init=z) for p, mn, z in reqs]
        res = cb.run()
        outs[boost] = [res[rid] for rid in rids]
        segs[boost] = cb.stats()["segments"]
    assert segs[4] < segs[1]
    for i, (p, mn, z) in enumerate(reqs):
        np.testing.assert_array_equal(outs[1][i], outs[4][i])
        np.testing.assert_array_equal(outs[4][i], _reference(m, p, mn, init=z))


def test_rnn_serving_boost_defers_to_eos_and_queue(event):
    """An eos-bearing or queued request pins dispatches to seg_len."""
    _, _, m = event
    cb = RNNContinuousBatcher(m, slots=1, seg_len=8, prompt_bucket=8,
                              min_slots=1, boost=4, sampling=GREEDY)
    cb.submit(np.asarray([3, 5, 7], np.int32), 64, eos_id=EDIM + 5)
    cb.run()
    assert cb.stats()["slot_steps"] == cb.stats()["segments"] * 8
    cb = RNNContinuousBatcher(m, slots=2, seg_len=8, prompt_bucket=8,
                              min_slots=2, boost=4, sampling=GREEDY)
    assert cb._boosted_seg() == 8            # all free
    cb.submit(np.asarray([3, 5], np.int32), 100)
    assert cb._boosted_seg() == 8            # queued, not yet admitted
    cb._try_admit()
    assert cb._boosted_seg() == 32           # active, 100 >= 32 left
    cb.submit(np.asarray([4], np.int32), 8)
    assert cb._boosted_seg() == 8            # queue non-empty again
    cb.run()
