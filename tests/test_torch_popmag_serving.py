"""The port's PoPMAG continuous batching (``decode/serving_popmag.py``,
kernel D's plain version on the CPU, f32) against the port's
``generate_arrangement`` + ``flatten_arrangement`` and the JAX package's
``PopMAGContinuousBatcher``, on the same weights (the JAX serving tests'
widths and pool, tests/test_serving_popmag.py:37): greedy flat token
streams are compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicgeneration_tpu.data import mumidi_packing as jmp
from musicgeneration_tpu.decode.sampling import (
    SamplingParams as JSamplingParams)
from musicgeneration_tpu.decode.serving_popmag import (
    PopMAGContinuousBatcher as JBatcher)
from musicgeneration_tpu.models.popmag import PoPMAGRNN as JPoPMAG
from musicgeneration_tpu.tokenizers.mumidi import MuMIDI_EventSeq as JMu
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.data import mumidi_packing as mp
from musicgeneration_tpu_torch.decode import SamplingParams
from musicgeneration_tpu_torch.decode.popmag_generate import (
    flatten_arrangement, generate_arrangement)
from musicgeneration_tpu_torch.decode.serving_popmag import (
    PopMAGContinuousBatcher)
from tests import fixtures

GREEDY = SamplingParams(greedy=True)
STEPS = 24


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("popmag_serve") / "m.mid")
    fixtures.multitrack_midi(path, n_bars=4)
    mel, arr = JMu.extract_split_events(path)
    mb = JMu.segmentation(JMu.to_array(mel))
    ab = JMu.segmentation(JMu.to_array(arr))
    batch = jmp.pack_batch([(mb, ab), (mb[:2], ab[:2])])
    jm = JPoPMAG(embed_dim=32, hidden_dim=32, num_layers=2,
                 dropout_rate=0.0)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, jm.init_dim)),
                     *(jnp.asarray(a) for a in (
                         batch.src, batch.src_len, batch.tar,
                         batch.tar_len)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)
    # bars that end at once beside bars that run on (the frozen rows)
    params["head_type"]["bias"][jmp.BAR_TOKEN - jmp.SHIFT[0]] += 0.3
    tm = convert.model_from_state_dict(
        convert.popmag_state_dict_from_jax(params), device="cpu")
    return jm, params, tm, batch


def _reference(tm, batch, n_bars, rows=(0, 1), inits=None, src=None,
               src_len=None):
    if src is None:
        src, src_len = batch.src[list(rows)], batch.src_len[list(rows)]
    init = (np.zeros((len(rows), tm.init_dim), np.float32) if inits is None
            else inits)
    return flatten_arrangement(*generate_arrangement(
        tm, init, src, src_len, n_bars, max_steps=STEPS, greedy=True))


def _cb(tm, batch, slots, **kw):
    kw.setdefault("seg_len", 1)
    return PopMAGContinuousBatcher(
        tm, slots=slots, sampling=GREEDY, max_steps=STEPS,
        max_bars=max(8, batch.src.shape[1]), max_bar_len=batch.src.shape[2],
        prompt_bucket=4, min_slots=slots, **kw)


def test_greedy_full_pool_equals_generation_and_jax_serving(setup):
    """Both requests admitted into a pool of 2: each stream equals the
    dedicated width-2 ``generate_arrangement`` and the JAX engine's."""
    jm, params, tm, batch = setup
    n_bars = batch.src.shape[1]
    cb = _cb(tm, batch, 2)
    rids = [cb.submit(batch.src[i], n_bars, src_len=batch.src_len[i])
            for i in range(2)]
    outs = cb.run()
    jcb = JBatcher(jm, params, slots=2, sampling=JSamplingParams(
        greedy=True), max_steps=STEPS, seg_len=1, max_bars=8,
        max_bar_len=batch.src.shape[2], prompt_bucket=4, min_slots=2)
    jrids = [jcb.submit(batch.src[i], n_bars, src_len=batch.src_len[i])
             for i in range(2)]
    jouts = jcb.run()
    for rid, jrid, ref in zip(rids, jrids, _reference(tm, batch, n_bars)):
        np.testing.assert_array_equal(outs[rid], ref)
        np.testing.assert_array_equal(outs[rid], jouts[jrid])
        assert outs[rid][0] == mp.BAR_TOKEN
        assert int((outs[rid] == mp.BAR_TOKEN).sum()) >= n_bars
    st = cb.stats()
    assert st["admitted"] == 2 and st["steps"] >= n_bars


def test_seg_len_two_trims_to_max_new_bars(setup):
    _, _, tm, batch = setup
    cb = _cb(tm, batch, 2, seg_len=2)
    rid = cb.submit(batch.src[0], 3, src_len=batch.src_len[0])
    out = cb.run()[rid]
    np.testing.assert_array_equal(out, _reference(tm, batch, 3,
                                                  rows=(0, 0))[0])


def test_staggered_admission_with_latents(setup):
    """A second request admits while the first is mid-flight (per-row
    bar cursors); per-request latents go through init_to_hidden; a
    2-bar melody asked for 3 bars after a 4-bar one reads zero rows of
    length 0 past its bars, not the evicted melody's. Each stream equals
    its own run, in the port and in the JAX engine."""
    jm, params, tm, batch = setup
    inits = np.random.RandomState(3).normal(
        size=(2, tm.init_dim)).astype(np.float32)
    outs = {}
    for name, cls in (("port", None), ("jax", JBatcher)):
        if cls is None:
            cb = _cb(tm, batch, 1)
        else:
            cb = cls(jm, params, slots=1, sampling=JSamplingParams(
                greedy=True), max_steps=STEPS, seg_len=1, max_bars=8,
                max_bar_len=batch.src.shape[2], prompt_bucket=4,
                min_slots=1)
        r0 = cb.submit(batch.src[0], 2, src_len=batch.src_len[0],
                       init=inits[0])
        cb.step()
        cb.step()
        r1 = cb.submit(batch.src[1, :2], 3, src_len=batch.src_len[1, :2],
                       init=inits[1])
        done = cb.run()
        outs[name] = (done[r0], done[r1])
    ref0 = _reference(tm, batch, 2, rows=(0,), inits=inits[:1])[0]
    # the 2-bar melody as the slot holds it: bars 2-3 zero, length 0
    src1 = np.zeros_like(batch.src[1:2])
    src1[0, :2] = batch.src[1, :2]
    len1 = np.zeros_like(batch.src_len[1:2])
    len1[0, :2] = batch.src_len[1, :2]
    ref1 = _reference(tm, batch, 3, inits=inits[1:], src=src1,
                      src_len=len1)[0]
    leak = _reference(tm, batch, 3, inits=inits[1:], src=np.concatenate(
        [src1[:, :2], batch.src[:1, 2:]], axis=1), src_len=np.concatenate(
        [len1[:, :2], batch.src_len[:1, 2:]], axis=1))[0]
    assert not np.array_equal(ref1, leak)
    for got in outs.values():
        np.testing.assert_array_equal(got[0], ref0)
        np.testing.assert_array_equal(got[1], ref1)


def test_validation(setup):
    _, _, tm, batch = setup
    cb = _cb(tm, batch, 2)
    with pytest.raises(ValueError, match="compound melodies"):
        cb.submit(np.zeros((4, 8), np.int32), 2)
    with pytest.raises(ValueError, match="max_bars"):
        cb.submit(np.zeros((64, 4, 7), np.int32), 2)
    with pytest.raises(ValueError, match="max_bar_len"):
        cb.submit(np.zeros((2, batch.src.shape[2] + 1, 7), np.int32), 2)
    with pytest.raises(ValueError, match="eos_id"):
        cb.submit(batch.src[0], 2, eos_id=3)
    with pytest.raises(ValueError, match="src_len"):
        cb.submit(batch.src[0], 2, src_len=np.ones(2, np.int32))
    with pytest.raises(ValueError, match="init must be"):
        cb.submit(batch.src[0], 2, init=np.zeros(3))
    with pytest.raises(TypeError):
        cb.submit(batch.src[0], 2, bogus=1)
    with pytest.raises(ValueError, match="top-k"):
        PopMAGContinuousBatcher(tm, sampling=SamplingParams(top_k=4))
    with pytest.raises(ValueError, match="prompt_bucket"):
        PopMAGContinuousBatcher(tm, max_bars=12, prompt_bucket=8)


def test_warm_and_cancel(setup):
    _, _, tm, batch = setup
    cb = _cb(tm, batch, 2)
    cb.warm()
    assert not cb.pending and not any(s.active for s in cb.slots)
    warm_admitted = cb.stats()["admitted"]
    rid = cb.submit(batch.src[0], 12, src_len=batch.src_len[0])
    queued = cb.submit(batch.src[1], 2, src_len=batch.src_len[1])
    assert cb.cancel(queued)
    cb.step()
    assert cb.cancel(rid)
    assert not cb.cancel(rid)
    outs = cb.run()
    assert outs == {} or all(v.ndim == 1 for v in outs.values())
    # only the active one was admitted; the queued one never was
    assert cb.stats()["admitted"] == warm_admitted + 1


def test_default_src_len_counts_nonzero_rows(setup):
    _, _, tm, batch = setup
    cb = _cb(tm, batch, 2)
    rid = cb.submit(batch.src[0], 2)
    out = cb.run()[rid]
    src_len = (batch.src[0] != 0).any(-1).sum(-1)
    np.testing.assert_array_equal(out, flatten_arrangement(
        *generate_arrangement(tm, np.zeros((2, 32), np.float32),
                              batch.src[[0, 0]], np.stack([src_len] * 2), 2,
                              max_steps=STEPS, greedy=True))[0])
