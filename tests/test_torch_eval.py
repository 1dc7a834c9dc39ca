"""The port's ``cli.eval`` against the JAX package's evaluation: over the
same ``slide_seq2seq_batch`` windows of ``RandomState(--seed)`` and the
same weights, its JSON line's loss and accuracy equal JAX's
``make_eval_step`` (1e-5) and its ``--bucket`` ids equal JAX's
``logits_bucketting`` of the same forward; and the refusals. The run is a
pedal MusicTransformer (vocabulary 390, 2 layers, d_model 64) on a
tokenized pedal corpus, in f32 on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli import train as jcli
from musicgeneration_tpu.data.batching import slide_seq2seq_batch
from musicgeneration_tpu.train.objective import logits_bucketting
from musicgeneration_tpu.train.trainer import make_eval_step
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import eval as teval
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.data.pipeline import TokenCorpus

from .fixtures import simple_piano_midi
from .test_torch_pedal import pedal_midi

KW = {"num_layers": 2, "d_model": 64, "dropout_rate": 0.0}
SEQ = 48


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    (tmp / "midis").mkdir()
    for i in range(3):
        pedal_midi(str(tmp / "midis" / f"p{i}.mid"), seed=10 + i,
                   n_notes=120)
    assert ttok.main([str(tmp / "midis"), str(tmp / "tok"), "--scheme",
                      "pedal", "--workers", "1"]) == 0
    cfg = jcli.TrainCLIConfig(seq_len=SEQ, label_smoothing=0.1)
    jm, jtcfg, *_ = jcli.build_session(cfg, "pedal", dict(KW))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32),
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    (tmp / "run").mkdir()
    torch.save({"model": convert.state_dict_from_jax(params), "step": 7,
                "config": {"cli": tcli.TrainCLIConfig(
                    seq_len=SEQ, label_smoothing=0.1).to_dict(),
                    "scheme": "pedal", "model_kwargs": dict(KW)}},
               tmp / "run" / "step-7.pt")
    return tmp, jm, jtcfg, params


def _jax_eval(jm, jtcfg, params, seqs, batches, bsz, seq_len, seed):
    step = jax.jit(make_eval_step(jm, jtcfg))
    rng = np.random.RandomState(seed)
    losses, accs, bucket = [], [], np.zeros(jm.vocab_size, np.int64)
    for _ in range(batches):
        x, y = slide_seq2seq_batch(seqs, bsz, seq_len, rng)
        m = step(params, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
        ids = np.asarray(logits_bucketting(jm.apply({"params": params},
                                                    jnp.asarray(x))))
        bucket += np.bincount(ids, minlength=jm.vocab_size)
    return float(np.mean(losses)), float(np.mean(accs)), bucket


@pytest.mark.parametrize("seq_len", [0, 20])
def test_cli_eval_matches_jax(run, capsys, seq_len):
    tmp, jm, jtcfg, params = run
    capsys.readouterr()
    args = [str(tmp / "run"), str(tmp / "tok"), "--batches", "3",
            "--batch-size", "2", "--seed", "5", "--bucket",
            "--device", "cpu"]
    if seq_len:
        args += ["--seq-len", str(seq_len)]
    assert teval.main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    length = min(seq_len or SEQ, SEQ - 1)   # capped at max_seq - 1
    corpus = TokenCorpus(str(tmp / "tok"), limlen=length + 1)
    seqs = [np.asarray(corpus[i]) for i in range(len(corpus))]
    loss, acc, bucket = _jax_eval(jm, jtcfg, params, seqs, 3, 2, length, 5)
    assert out["checkpoint_step"] == 7 and out["scheme"] == "pedal"
    assert out["batches"] == 3 and out["tokens"] == 3 * 2 * length
    assert out["loss"] == pytest.approx(loss, rel=1e-5)
    assert out["accuracy"] == pytest.approx(acc, rel=1e-5, abs=1e-7)
    nz = np.nonzero(bucket)[0]
    assert out["bucket"]["unique_predicted_ids"] == len(nz)
    assert out["bucket"]["vocab"] == 390
    top = out["bucket"]["top10"]
    assert all(bucket[int(i)] == n for i, n in top.items())
    assert sorted(top.values(), reverse=True) == sorted(bucket[nz],
                                                        reverse=True)[:10]


def test_cli_eval_refusals(run, tmp_path):
    tmp, _, _, _ = run
    bare = tmp_path / "bare"
    bare.mkdir()
    payload = torch.load(tmp / "run" / "step-7.pt", weights_only=True)
    torch.save({"model": payload["model"], "step": 1, "config": {}},
               bare / "step-1.pt")
    with pytest.raises(SystemExit, match="no CLI config"):
        teval.main([str(bare), str(tmp / "tok"), "--device", "cpu"])
    other = tmp_path / "rnn"
    other.mkdir()
    torch.save({"model": payload["model"], "step": 1,
                "config": {"cli": tcli.TrainCLIConfig(
                    model="event_rnn").to_dict(), "scheme": "midilike"}},
               other / "step-1.pt")
    with pytest.raises(SystemExit, match="music_transformer"):
        teval.main([str(other), str(tmp / "tok"), "--device", "cpu"])
    (tmp_path / "short").mkdir()
    simple_piano_midi(str(tmp_path / "short" / "s.mid"), n_notes=3)
    assert ttok.main([str(tmp_path / "short"), str(tmp_path / "stok"),
                      "--scheme", "pedal", "--workers", "1"]) == 0
    with pytest.raises(SystemExit, match="no sequences of length"):
        teval.main([str(tmp / "run"), str(tmp_path / "stok"),
                    "--device", "cpu"])
