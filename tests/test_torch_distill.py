"""Draft distillation (``cli.train distill_from=``) against the JAX
package, on the CPU in f32: the port's distillation loss and its
gradient equal JAX's ``_make_distill_loss`` on one teacher's and one
student's weights and one batch (alpha 0.5, T 1 and 2; 1e-5); the loss
vanishes when the student is the teacher (alpha 1); a teacher run, a
distilled draft and ``cli.generate --spec <draft>`` end to end (greedy
equal to plain decoding); the refusals (seq_len, vocabulary, a teacher
of another family, a checkpoint without the run's config, sp > 1); and
an interrupted distillation run resumed to the uninterrupted losses.

Teacher 2 layers, student 1 layer, d_model 64, the pedal vocabulary
(390; the loss ignores id 389)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli import train as jcli
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.utils.checkpoint import list_checkpoints

from .test_torch_pedal import pedal_midi

T_KW = {"num_layers": 2, "d_model": 64, "dropout_rate": 0.0}
S_KW = {"num_layers": 1, "d_model": 64, "dropout_rate": 0.0}
SEQ = 32


def _params(jm, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32),
        jm.init(jax.random.PRNGKey(seed),
                jnp.zeros((1, 8), jnp.int32))["params"])


def _models(t_kw, s_kw, scheme="pedal"):
    """(JAX teacher, its params, JAX student, its params, JAX trainer
    config, port teacher, port student, port trainer config)."""
    jt, jtcfg, *_ = jcli.build_session(jcli.TrainCLIConfig(seq_len=SEQ),
                                       scheme, dict(t_kw))
    js, jscfg, *_ = jcli.build_session(jcli.TrainCLIConfig(seq_len=SEQ),
                                       scheme, dict(s_kw))
    tp, sp = _params(jt, 0), _params(js, 1)
    tt, _, _ = tcli.build_model(tcli.TrainCLIConfig(seq_len=SEQ), scheme,
                                dict(t_kw), "cpu")
    ts, tcfg, _ = tcli.build_model(tcli.TrainCLIConfig(seq_len=SEQ), scheme,
                                   dict(s_kw), "cpu")
    tt.load_state_dict(convert.state_dict_from_jax(tp))
    ts.load_state_dict(convert.state_dict_from_jax(sp))
    return jt, tp, js, sp, jscfg, tt.requires_grad_(False).eval(), ts, tcfg


def _batch(v, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, v - 1, (3, SEQ)).astype(np.int32)
    y = rng.integers(0, v - 1, (3, SEQ)).astype(np.int32)
    y[0, -5:] = v - 1        # labels the loss and the KL ignore
    return x, y


@pytest.mark.parametrize("temp", [1.0, 2.0])
def test_distill_loss_and_grad_match_jax(temp):
    jt, tp, js, sp, jcfg, tt, ts, tcfg = _models(T_KW, S_KW)
    assert jcfg.pad_id == tcfg.pad_id == 389
    x, y = _batch(390)
    jloss = jcli._make_distill_loss(js, jcfg, jt, tp, alpha=0.5, temp=temp)
    (lj, aj), gj = jax.value_and_grad(jloss, has_aux=True)(
        sp, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    loss_fn = tcli.distill_loss_fn(tcfg, tt, 0.5, temp)
    lt, at = loss_fn(ts, torch.from_numpy(x), torch.from_numpy(y), None)
    lt.backward()
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)
    assert float(at) == pytest.approx(float(aj), rel=1e-5, abs=1e-7)
    ref = convert.state_dict_from_jax(jax.tree.map(np.asarray, gj))
    norm_t = torch.sqrt(sum((p.grad ** 2).sum() for p in ts.parameters()))
    norm_j = np.sqrt(sum(float((r ** 2).sum()) for r in ref.values()))
    assert float(norm_t) == pytest.approx(norm_j, rel=1e-5)
    # a floor of 1e-6 of the largest gradient: the key bias's gradient
    # is zero up to rounding (softmax ignores a shift shared by all keys)
    floor = 1e-6 * max(float(r.abs().max()) for r in ref.values())
    for name, p in ts.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(r).max()) + floor,
                                   err_msg=name)
    assert all(p.grad is None for p in tt.parameters())


def test_distill_loss_zero_when_student_is_teacher():
    """alpha 1, T 1: KL(teacher || student) vanishes when the student is
    the teacher (JAX tests/test_train_modes.py's fixed point), in both
    packages, and so does its gradient."""
    jt, tp, _, _, jcfg, tt, _, tcfg = _models(T_KW, S_KW)
    x, _ = _batch(390)
    jloss = jcli._make_distill_loss(jt, jcfg, jt, tp, alpha=1.0, temp=1.0)
    lj, _ = jloss(tp, jnp.asarray(x), jnp.asarray(x), jax.random.PRNGKey(1))
    student, _, _ = tcli.build_model(tcli.TrainCLIConfig(seq_len=SEQ),
                                     "pedal", dict(T_KW), "cpu")
    student.load_state_dict(tt.state_dict())
    lt, _ = tcli.distill_loss_fn(tcfg, tt, 1.0, 1.0)(
        student, torch.from_numpy(x), torch.from_numpy(x), None)
    assert abs(float(lj)) < 1e-5 and abs(float(lt.detach())) < 1e-5
    lt.backward()
    assert max(float(p.grad.abs().max()) for p in student.parameters()) < 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distill")
    (tmp / "midis").mkdir()
    for i in range(3):
        pedal_midi(str(tmp / "midis" / f"p{i}.mid"), seed=20 + i,
                   n_notes=150)
    assert ttok.main([str(tmp / "midis"), str(tmp / "tok"), "--scheme",
                      "pedal", "--workers", "1"]) == 0
    assert ttok.main([str(tmp / "midis"), str(tmp / "remi"), "--scheme",
                      "remi", "--workers", "1"]) == 0
    teacher = tmp / "teacher"
    assert tcli.main([str(tmp / "tok"), "steps=2", "batch_size=2",
                      f"seq_len={SEQ}", "model.num_layers=2",
                      "model.d_model=64", f"ckpt_dir={teacher}",
                      "--device", "cpu"]) == 0
    return tmp


def _distill(tmp, run, steps=4, extra=()):
    return tcli.main([str(tmp / "tok"), f"steps={steps}", "batch_size=2",
                      f"seq_len={SEQ}", "model.num_layers=1",
                      "model.d_model=64", f"distill_from={tmp / 'teacher'}",
                      "distill_temp=2.0", f"ckpt_dir={tmp / run}",
                      "ckpt_every=1", "log_every=1",
                      f"metrics_path={tmp / (run + '.jsonl')}", *extra,
                      "--device", "cpu"])


def _losses(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if r["kind"] == "train"}


def test_teacher_draft_spec_end_to_end(corpus):
    """A pedal teacher run -> a distilled 1-layer draft -> cli.generate
    --spec <draft> from the teacher: greedy output equal to plain greedy
    decoding, the acceptance line printed."""
    tmp = corpus
    assert _distill(tmp, "draft", steps=2) == 0
    losses = _losses(tmp / "draft.jsonl")
    assert sorted(losses) == [0, 1] and all(np.isfinite(list(losses.values())))
    draft = convert.load_checkpoint(str(tmp / "draft"), device="cpu")
    assert draft.num_layers == 1 and draft.vocab_size == 390
    prime = str(tmp / "midis" / "p0.mid")
    outs = {}
    for name, extra in (("plain", []), ("spec", ["--spec", str(tmp / "draft"),
                                                 "--spec-chunk", "4"])):
        out = tmp / f"{name}.mid"
        assert tgen.main([str(tmp / "teacher"), str(out), "--prime", prime,
                          "--prime-len", "12", "--steps", "16",
                          "--temperature", "0", "--device", "cpu"]
                         + extra) == 0
        outs[name] = out.read_bytes()
    assert outs["spec"] == outs["plain"]


def test_distill_resume_replays_losses(corpus, monkeypatch):
    tmp = corpus
    assert _distill(tmp, "full") == 0
    full = _losses(tmp / "full.jsonl")
    real_fn = tcli._lm_batch_fn

    def cut_at(n):
        def fn(corpus_, cfg):
            at = real_fn(corpus_, cfg)

            def batch_at(idx):
                if idx == n:
                    raise KeyboardInterrupt
                return at(idx)
            return batch_at
        return fn

    monkeypatch.setattr(tcli, "_lm_batch_fn", cut_at(2))
    assert _distill(tmp, "cut") == 0
    assert [s for s, _ in list_checkpoints(str(tmp / "cut"))][-1] == 1
    monkeypatch.setattr(tcli, "_lm_batch_fn", real_fn)
    assert _distill(tmp, "cut") == 0
    assert _losses(tmp / "cut.jsonl") == full
    assert sorted(full) == [0, 1, 2, 3]


def test_distill_refusals(corpus, tmp_path):
    tmp = corpus
    base = ["steps=1", "batch_size=2", "model.num_layers=1",
            "model.d_model=64", "--device", "cpu"]
    teacher = f"distill_from={tmp / 'teacher'}"
    with pytest.raises(SystemExit, match="seq_len"):
        tcli.main([str(tmp / "tok"), "seq_len=16", teacher] + base)
    with pytest.raises(SystemExit, match=r"teacher vocab \(390\) != "
                                         r"student vocab \(337\)"):
        tcli.main([str(tmp / "remi"), f"seq_len={SEQ}", teacher] + base)
    gru = tmp_path / "gru"
    gru.mkdir()
    torch.save({"model": {}, "step": 0, "config": {
        "cli": tcli.TrainCLIConfig(model="event_rnn",
                                   seq_len=SEQ).to_dict(),
        "scheme": "midilike"}}, gru / "step-0.pt")
    with pytest.raises(SystemExit, match="must be a music_transformer"):
        tcli.main([str(tmp / "tok"), f"seq_len={SEQ}",
                   f"distill_from={gru}"] + base)
    bare = tmp_path / "bare"
    bare.mkdir()
    torch.save({"model": {}, "step": 0, "config": {}}, bare / "step-0.pt")
    with pytest.raises(SystemExit, match="no CLI config"):
        tcli.main([str(tmp / "tok"), f"seq_len={SEQ}",
                   f"distill_from={bare}"] + base)
    with pytest.raises(SystemExit, match="composes with dp/fsdp"):
        tcli.main([str(tmp / "tok"), f"seq_len={SEQ}", "sp=2", teacher]
                  + base)
    # a rebuilt run ignores a recorded teacher path (train time only)
    model, _, loss_fn = tcli.build_model(
        tcli.TrainCLIConfig(seq_len=SEQ, distill_from=str(bare)), "pedal",
        {"num_layers": 1, "d_model": 64}, "cpu")
    assert loss_fn is None and model.vocab_size == 390
