"""The port's data path on the CPU against the JAX package: the batching
functions and the counter-indexed crop stream (byte-equal for one seed),
the shard format (each package's ``TokenCorpus`` reads the other's shards
identically), the copied config overrides, and the prefetch thread."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli import train as jcli
from musicgeneration_tpu.data import batching as jbat
from musicgeneration_tpu.data import pipeline as jpipe
from musicgeneration_tpu.utils import config as jconfig
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.data import batching as tbat
from musicgeneration_tpu_torch.data import pipeline as tpipe
from musicgeneration_tpu_torch.data.prefetch import prefetch_to_device
from musicgeneration_tpu_torch.utils import config as tconfig
from tests.fixtures import polyphonic_midi, simple_piano_midi


def _seqs(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 308, int(rng.integers(20, 200))).astype(np.uint16)
            for _ in range(n)]


@pytest.mark.parametrize("seed,batch,seq_len,accum", [(42, 8, 64, 1),
                                                      (7, 3, 100, 2)])
def test_crop_stream_byte_equal_to_jax(seed, batch, seq_len, accum):
    """Step s consumes batch s: the same (x, y) bytes as the JAX CLI's
    stream, including the eligibility filter (files <= seq_len tokens
    never picked)."""
    seqs = _seqs()
    jcfg = jcli.TrainCLIConfig(seed=seed, batch_size=batch, seq_len=seq_len,
                               accum_steps=accum)
    tcfg = tcli.TrainCLIConfig(seed=seed, batch_size=batch, seq_len=seq_len,
                               accum_steps=accum)
    jat, tat = jcli._lm_batch_fn(seqs, jcfg), tcli._lm_batch_fn(seqs, tcfg)
    for idx in (0, 1, 5, 1234):
        (jx, jy), (tx, ty) = jat(idx), tat(idx)
        assert tx.dtype == jx.dtype == np.int32
        assert tx.shape == (batch * accum, seq_len)
        assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()
    stream = tcli._indexed_stream(tat, start=5)
    assert next(stream)[0].tobytes() == jat(5)[0].tobytes()


def test_batching_functions_match_jax():
    seqs = _seqs(1)
    lens = [len(s) for s in seqs]
    np.testing.assert_array_equal(tbat.window_indices(lens, 50, 7),
                                  jbat.window_indices(lens, 50, 7))
    idx = jbat.window_indices(lens, 50, 7)[:5]
    for tm in (True, False):
        np.testing.assert_array_equal(
            tbat.gather_windows(seqs, idx, 50, time_major=tm),
            jbat.gather_windows(seqs, idx, 50, time_major=tm))
    t, j = (m.pad_and_batch_sequences(seqs[:4], pad_to=256)
            for m in (tbat, jbat))
    for f in dataclasses.fields(j):
        np.testing.assert_array_equal(getattr(t, f.name), getattr(j, f.name))
    with pytest.raises(ValueError):
        tbat.slide_seq2seq_batch(seqs, 2, 500, np.random.RandomState(0))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shards")
    midis = tmp / "midis"
    os.makedirs(midis / "sub")
    simple_piano_midi(str(midis / "a.mid"), seed=0, n_notes=200)
    simple_piano_midi(str(midis / "sub" / "b.mid"), seed=1)
    polyphonic_midi(str(midis / "c.mid"))
    (midis / "broken.mid").write_bytes(b"not a midi file")
    stats = {}
    for name, mod in (("jax", jpipe), ("port", tpipe)):
        stats[name] = mod.tokenize_corpus(str(midis), str(tmp / name),
                                          num_workers=1, shard_size=2)
    return tmp, stats


def test_tokenize_corpus_matches_jax(shards):
    tmp, stats = shards
    j, t = stats["jax"], stats["port"]
    assert (t.n_files, t.n_ok, t.n_failed, t.n_tokens) == \
        (j.n_files, j.n_ok, j.n_failed, j.n_tokens) == (4, 3, 1, j.n_tokens)
    assert [os.path.basename(p) for p in t.shards] == \
        [os.path.basename(p) for p in j.shards]
    assert os.path.exists(tmp / "port" / "quarantine.jsonl")


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("limlen", [0, 400])
def test_each_package_reads_the_others_shards(shards, writer, limlen):
    tmp, _ = shards
    jc = jpipe.TokenCorpus(str(tmp / writer), limlen=limlen)
    tc = tpipe.TokenCorpus(str(tmp / writer), limlen=limlen)
    assert len(tc) == len(jc) > 0
    for i in range(len(jc)):
        assert tc.name(i) == jc.name(i)
        assert tc[i].dtype == jc[i].dtype == np.uint16
        np.testing.assert_array_equal(tc[i], jc[i])
    np.testing.assert_array_equal(tc.lengths(), jc.lengths())
    assert tc.count(500) == jc.count(500)
    other = "port" if writer == "jax" else "jax"
    oc = tpipe.TokenCorpus(str(tmp / other), limlen=limlen)
    for i in range(len(jc)):  # both codecs give the same tokens
        np.testing.assert_array_equal(oc[i], jc[i])


def test_config_overrides_match_jax():
    @dataclasses.dataclass
    class J(jconfig.Config):
        a: int = 1
        b: float = 0.5
        c: str = "x"
        d: bool = False

    @dataclasses.dataclass
    class T(tconfig.Config):
        a: int = 1
        b: float = 0.5
        c: str = "x"
        d: bool = False

    ov = ["a=3", "b=1e-3", "c=hello", "d=true"]
    assert tconfig.apply_overrides(T(), ov).to_dict() == \
        jconfig.apply_overrides(J(), ov).to_dict()
    with pytest.raises(KeyError):
        tconfig.apply_overrides(T(), ["zz=1"])
    cfg = tconfig.apply_overrides(tcli.TrainCLIConfig(),
                                  ["steps=30", "ckpt_dir=runs/x"])
    assert tcli.TrainCLIConfig.from_dict(cfg.to_dict()) == cfg


def test_prefetch_yields_in_order_and_reraises():
    batches = [(np.full((2, 3), i, np.int32), np.full((2, 3), -i, np.int32))
               for i in range(5)]
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(got) == 5
    for (x, y), (bx, by) in zip(got, batches):
        assert isinstance(x, torch.Tensor) and x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), bx)
        np.testing.assert_array_equal(y.numpy(), by)

    def failing():
        yield batches[0]
        raise RuntimeError("pipeline broke")

    it = prefetch_to_device(failing(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="pipeline broke"):
        next(it)

    endless = prefetch_to_device((b for _ in iter(int, 1) for b in batches),
                                 size=2, device="cpu")
    next(endless)
    endless.close()  # stops the producer thread
