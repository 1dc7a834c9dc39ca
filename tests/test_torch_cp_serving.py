"""The port's CP continuous-batching engine (decode/serving_cp.py, plain
versions of kernels A and B on the CPU, f32) against its own dedicated
``generate_cp`` runs (themselves held row for row against the JAX
package's in test_torch_cp_model.py) and, where an admission's bucket
reaches the cache's last row, against the JAX ``CPContinuousBatcher``
(Pallas kernels in interpret mode). Mirrors tests/test_serving_cp.py:
greedy serving is row-identical to dedicated runs across staggered
admissions, compaction and drain-tail shrinking."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.decode.serving_cp import (
    CPContinuousBatcher as JCPContinuousBatcher)
from musicgeneration_tpu.models import CPTransformer as JCPTransformer
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.decode import SamplingParams
from musicgeneration_tpu_torch.decode.cp_generate import generate_cp
from musicgeneration_tpu_torch.decode.serving_cp import CPContinuousBatcher
from musicgeneration_tpu_torch.tokenizers import cp

GREEDY = SamplingParams(greedy=True)


@functools.lru_cache(maxsize=None)
def _pair():
    # max_seq 64: a 64-row cache stays 64 rows (align_cache_len rounds to
    # 16 where 128 would pass max_seq)
    jm = JCPTransformer(num_layers=2, d_model=128, max_seq=64,
                        dropout_rate=0.0, attention_impl="pallas",
                        decode_impl="fused")
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)
    tm = convert.model_from_state_dict(
        convert.cp_transformer_state_dict_from_jax(params), device="cpu")
    return jm, params, tm


def _model():
    return _pair()[2]


def _rows(rng, p):
    return np.stack([rng.randint(0, fd, (p,)) for fd in cp.field_dims()],
                    axis=-1).astype(np.int32)


def _reference(m, rows, steps):
    return generate_cp(m, rows[None], steps, max_len=rows.shape[0] + steps,
                       greedy=True)[0].numpy()


def test_cp_serving_staggered_matches_generate():
    """Staggered admissions into a 2-slot pool: every request's greedy
    rows equal its dedicated generate_cp run."""
    m = _model()
    rng = np.random.RandomState(3)
    reqs = [(_rows(rng, rng.randint(1, 12)), int(rng.randint(8, 40)))
            for _ in range(5)]
    cb = CPContinuousBatcher(m, slots=2, seg_len=8, prompt_bucket=16,
                             sampling=GREEDY)
    rids = [cb.submit(r, mn) for r, mn in reqs[:2]]
    cb.step()
    rids += [cb.submit(r, mn) for r, mn in reqs[2:]]
    outs = cb.run()
    for (r, mn), rid in zip(reqs, rids):
        assert outs[rid].shape == (mn, 8)
        np.testing.assert_array_equal(outs[rid], _reference(m, r, mn))


def test_cp_serving_compaction_exact():
    """A cache half the request volume forces roll-compactions; rows stay
    identical (the ragged start bound rides the shared shift)."""
    m = _model()
    rng = np.random.RandomState(7)
    reqs = [(_rows(rng, rng.randint(1, 10)), int(rng.randint(20, 40)))
            for _ in range(6)]
    cb = CPContinuousBatcher(m, slots=2, seg_len=8, cache_len=64,
                             prompt_bucket=16, sampling=GREEDY, depth=3)
    rids = [cb.submit(r, mn) for r, mn in reqs]
    outs = cb.run()
    assert cb.cache_len == 64 and cb.t <= cb.cache_len
    assert cb.stats()["compactions"] >= 1
    for (r, mn), rid in zip(reqs, rids):
        np.testing.assert_array_equal(outs[rid], _reference(m, r, mn))


def test_cp_serving_eos_family_row():
    """eos_id matches the FAMILY column: the emitted rows cut at the
    first row whose family equals it."""
    m = _model()
    rng = np.random.RandomState(11)
    r = _rows(rng, 6)
    ref = _reference(m, r, 40)
    fam = int(ref[9, 0])
    first = int(np.argmax(ref[:, 0] == fam))
    cb = CPContinuousBatcher(m, slots=1, seg_len=8, prompt_bucket=16,
                             sampling=GREEDY, depth=1)
    rid = cb.submit(r, 40, eos_id=fam)
    outs = cb.run()
    np.testing.assert_array_equal(outs[rid], ref[:first])
    assert outs[rid].shape == (first, 8)


def test_cp_serving_shrink_and_warm():
    """warm() over [B, 8] rows, then drain-tail shrinking; outputs
    unchanged and the pool ends narrow."""
    m = _model()
    rng = np.random.RandomState(13)
    cb = CPContinuousBatcher(m, slots=4, seg_len=8, prompt_bucket=16,
                             min_slots=1, sampling=GREEDY)
    cb.warm()
    assert cb.b == 4
    long_r, short_r = _rows(rng, 8), _rows(rng, 3)
    rid_a = cb.submit(long_r, 40)
    rid_b = cb.submit(short_r, 12)
    outs = cb.run()
    assert cb.b < 4
    np.testing.assert_array_equal(outs[rid_a], _reference(m, long_r, 40))
    np.testing.assert_array_equal(outs[rid_b], _reference(m, short_r, 12))


def test_cp_serving_sampled_rows_masked():
    """Sampled serving: every row respects the type-first family masking;
    one generator seed gives the same rows twice."""
    m = _model()
    outs = []
    for _ in range(2):
        rng = np.random.RandomState(17)
        cb = CPContinuousBatcher(
            m, slots=2, seg_len=8, prompt_bucket=16,
            sampling=SamplingParams(temperature=0.9),
            generator=torch.Generator().manual_seed(5))
        rids = [cb.submit(_rows(rng, 4), 24) for _ in range(3)]
        done = cb.run()
        outs.append([done[r] for r in rids])
    ign = cp.ignore_ids()
    for rows, again in zip(*outs):
        np.testing.assert_array_equal(rows, again)
        assert rows.shape == (24, 8)
        note = rows[:, 0] == cp.FAMILY_NOTE
        for f in (1, 2, 3, 4):       # metric fields ignored on notes
            assert (rows[note, f] == ign[f]).all()
        for f in (5, 6, 7):          # note fields ignored elsewhere
            assert (rows[~note, f] == ign[f]).all()


def test_cp_serving_validation():
    m = _model()
    with pytest.raises(ValueError, match="top-k/top-p"):
        CPContinuousBatcher(m, sampling=SamplingParams(top_k=8))
    with pytest.raises(ValueError, match="top-k/top-p"):
        CPContinuousBatcher(m, sampling=SamplingParams(top_p=0.9))
    cb = CPContinuousBatcher(m, slots=2, prompt_bucket=16)
    with pytest.raises(ValueError, match="compound rows"):
        cb.submit(np.ones(5, np.int32), 8)
    with pytest.raises(ValueError, match="per-request sampling"):
        cb.submit(np.zeros((2, 8), np.int32), 8, sampling=GREEDY)
    with pytest.raises(ValueError, match="window"):
        cb.submit(np.zeros((2, 8), np.int32), 8, window=32)


def test_cp_queued_cancel_keeps_row_shape():
    """Empty CP results (a queued cancel) keep the [n, 8] row contract."""
    m = _model()
    rng = np.random.RandomState(11)
    cb = CPContinuousBatcher(m, slots=2, seg_len=8, prompt_bucket=16,
                             sampling=GREEDY)
    rid = cb.submit(_rows(rng, 4), 16)
    assert cb.cancel(rid) is True
    assert cb.done[rid].shape == (0, 8)


def test_cp_admission_at_the_cache_end_matches_jax():
    """One slot, a 64-row cache, segments of 8: request A (1 row, 48 new)
    brings the clock to 48, and B's 16-row bucket is admitted into rows
    [48, 64), the cache's last row included, then compacted. Both
    requests' greedy rows equal the JAX engine's on the same schedule,
    and B's bucket tail (zero rows past its one-row prompt) changes
    nothing: B's rows equal its dedicated run."""
    jm, params, m = _pair()
    rng = np.random.RandomState(19)
    a, b = _rows(rng, 1), _rows(rng, 1)
    windows = []
    cb = CPContinuousBatcher(m, slots=1, seg_len=8, cache_len=64,
                             prompt_bucket=16, sampling=GREEDY)
    admit = cb._admit_group

    def recording(pb, rows, ps, slots_idx):
        windows.extend((cb.t - (p - 1), cb.t - (p - 1) + pb) for p in ps)
        return admit(pb, rows, ps, slots_idx)

    cb._admit_group = recording
    rids = [cb.submit(a, 48), cb.submit(b, 24)]
    outs = cb.run()
    assert windows == [(0, 16), (48, 64)]
    assert cb.stats()["compactions"] >= 1

    jcb = JCPContinuousBatcher(jm, params, slots=1, seg_len=8, cache_len=64,
                               prompt_bucket=16,
                               sampling=JSampling(greedy=True))
    jrids = [jcb.submit(a, 48), jcb.submit(b, 24)]
    jouts = jcb.run()
    for rid, jrid in zip(rids, jrids):
        np.testing.assert_array_equal(outs[rid], np.asarray(jouts[jrid]))
    np.testing.assert_array_equal(outs[rids[1]], _reference(m, b, 24))
